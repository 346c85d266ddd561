"""The adversarial steps on int8 frozen weights in the port against `pcm_tpu`
(CPU, fp32, TINY sizes): the DDIM family's (TINY SDXL, whose teacher stops
after the mid block) and the flow family's (TINY SD3) G step, D step and
fused pair, with the teacher's taps, forward and backward, on int8 products.

Both packages quantize the same numpy-drawn backbone (``min_size=0``); the
JAX steps' draws are reproduced from their keys and fed to the port
(`tests/test_torch_adv.py`, `tests/test_torch_sd3_adv.py`). Under ``fused``
the JAX side runs its Pallas int8 kernel in interpret mode; under ``scoped``
both sides set `DistillConfig.int8_no_grad_fwd`.

Bounds. Each int8 product is bit-exact across the packages on the same
input (`tests/test_torch_int8.py`), but over a whole step an fp32 round-off
between them (an op done in another order) can flip an activation code, a
step of amax / 127 in one product, and a hinge loss passes such a step on
as a jump of a head's gradient. So each reading is held to the larger of
the float steps' bound (`tests/test_torch_adv.py`: losses rtol 1e-5, grad
norms rtol 1e-3, grads rel-max 1e-3 leaf by leaf, params atol 1e-5 with
Adam's eps 1e-2) and four
times the port's own spread under the same kind of round-off: its step
rerun on the latents nudged by -2, -1, +1 and +2 fp32 ulps. A leaf whose
reference gradient is below 1e-6 of its tree's largest is round-off, as
there. The discriminator heads stay fp32 and unquantized, and under
``fused`` the taps' forward and backward go through the int8 Function.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.core.schedule import make_flow_schedule as jax_make_flow_schedule
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.train import adv as jadv
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu.utils import quant as jquant
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from pcm_tpu_torch.utils import quant
from test_torch_adv import _batch as _ddim_batch
from test_torch_adv import _cond, _jax_draws, _tiny_bundles
from test_torch_sd3_adv import _batch as _flow_batch
from test_torch_sd3_adv import _jax_flow_draws
from torch_port_helpers import random_params, rel_max

RANK = 4
GROUPS = 8  # see tests/test_torch_adv.py
LR, EPS = 1e-3, 1e-2
STEPS, PHASES = 10, 2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _heads(jdisc, feats, seed):
    return random_params(jdisc.init, feats, seed=seed)["params"]


@pytest.fixture(scope="module")
def ddim():
    """TINY SDXL on both sides, the UNet quantized by each package, the
    TINY heads drawn with numpy."""
    m = _tiny_bundles("sdxl", GROUPS)
    jfrozen = _np_tree(jquant.quantize_frozen(m["jfrozen"], min_size=0))
    quant.quantize_frozen({"unet": m["pfrozen"]["unet"]}, min_size=0)
    dcfg = families.disc_config("sdxl", tiny=True)
    jdisc = jadv.Discriminator(jadv.DiscriminatorConfig(dcfg.taps, dcfg.num_h_per_head,
                                                        dcfg.kernel))
    batch = _ddim_batch("sdxl", 2, 90)
    jc, _ = _cond(m, "sdxl", batch)
    feats = jax.eval_shape(lambda x: m["jbundle"].teacher_features(
        m["jfrozen"], x, jnp.zeros((2,)), jc), jnp.zeros((2, 8, 8, 4)))
    disc, _ = adv.init_discriminator(dcfg, m["pbundle"].unet_cfg.tap_channels(),
                                     torch.Generator().manual_seed(0), CPU)
    return dict(jb=m["jbundle"], jfrozen=jfrozen, jlora=m["jlora"], pb=m["pbundle"],
                pfrozen=m["pfrozen"], jdisc=jdisc, disc=disc, batch=batch,
                jd_params=_heads(jdisc, feats, 91), jsched=jax_schedule(),
                psched=make_ddpm_schedule(), cfg_kw=dict(w_min=4.0, w_max=5.0),
                jbuild=(jadv.build_ddim_adv_steps, jadv.build_ddim_adv_fused_pair),
                pbuild=(adv.build_ddim_adv_steps, adv.build_ddim_adv_fused_pair),
                draws=_jax_draws)


@pytest.fixture(scope="module")
def flow():
    """TINY SD3 on both sides on the adversarial LoRA list, the MMDiT
    quantized by each package (``pos_embed.proj`` included), the 2-tap TINY
    heads drawn with numpy."""
    jb = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True, adv_targets=True)
    with jax_reference_ops():
        jfrozen, jlora = random_params(lambda r: jb.init(r), seed=92)
    jmmdit = _np_tree(jfrozen["mmdit"])
    pb = families.sd3_bundle(RANK, dtype=torch.float32, tiny=True, adv_targets=True)
    pfrozen = pb.from_states({"mmdit": convert.mmdit_state_from_jax(jmmdit)}, CPU)
    quant.quantize_frozen(pfrozen, min_size=0)
    dcfg = families.disc_config("sd3", tiny=True)
    jdisc = jadv.Discriminator(jadv.DiscriminatorConfig(dcfg.taps, dcfg.num_h_per_head,
                                                        dcfg.kernel))
    batch = _flow_batch(2, 93)
    cond = {"prompt_embeds": jnp.asarray(batch["prompt_embeds"]),
            "pooled": jnp.asarray(batch["pooled_embeds"])}
    with jax_reference_ops():
        feats = jax.eval_shape(lambda x: jb.teacher_features({"mmdit": jmmdit}, x,
                                                             jnp.zeros((2,)), cond),
                               jnp.zeros((2, 8, 8, 4)))
    disc, _ = adv.init_discriminator(dcfg, pb.tap_channels(), torch.Generator().manual_seed(0),
                                     CPU)
    return dict(jb=jb, jfrozen=_np_tree(jquant.quantize_frozen({"mmdit": jmmdit}, min_size=0)),
                jlora=jlora, pb=pb, pfrozen=pfrozen, jdisc=jdisc, disc=disc, batch=batch,
                jd_params=_heads(jdisc, feats, 94), jsched=jax_make_flow_schedule(shift=3.0),
                psched=make_flow_schedule(shift=3.0), cfg_kw=dict(fixed_w=3.0),
                jbuild=(jadv.build_flow_adv_steps, jadv.build_flow_adv_fused_pair),
                pbuild=(adv.build_flow_adv_steps, adv.build_flow_adv_fused_pair),
                draws=_jax_flow_draws)


def _step(builders, bundle, advmod, kind, sched, cfg, disc, tx_g, tx_d):
    """The ``kind`` step ("g", "d" or "pair") of one package's builders."""
    steps, pair = builders
    args = (bundle, sched, cfg, advmod.AdvConfig(0.1), disc, tx_g, tx_d)
    return pair(*args) if kind == "pair" else dict(zip("gd", steps(*args)))[kind]


CASES = [("ddim", "fused", "pair"), ("flow", "fused", "pair"), ("flow", "scoped", "g"),
         ("flow", "dense", "d")]
NUDGES = (-2 ** -22, -2 ** -23, 2 ** -23, 2 ** -22)


def _readings(new, kind):
    """A step's metrics and, per player it updates, Adam's first moment and
    the params, flat: {(which, name): tensor}."""
    out = {("metric", k): torch.as_tensor(float(v)) for k, v in new[-1].items()}
    for i, which in {"g": [(0, "g")], "d": [(0, "d")], "pair": [(0, "g"), (1, "d")]}[kind]:
        out.update({(which + ".mu", k): v for k, v in new[i].opt_state["mu"].items()})
        out.update({(which + ".params", k): v for k, v in new[i].params.items()})
    return out


def _diff(a, b, rel):
    return float((a - b).abs().max()) / (float(b.abs().max()) if rel else 1.0)


@pytest.mark.parametrize("family,mode,kind", CASES, ids=["-".join(c) for c in CASES])
def test_adv_step_on_int8_matches_jax(request, family, mode, kind, monkeypatch):
    """One G step, D step or fused pair on int8 frozen weights on both sides
    from the same states and draws: the losses, the grad norms, the grads
    (Adam's first moment) of the LoRA and of the heads leaf by leaf, and the
    params after the update, each within the module docstring's bound."""
    m = request.getfixturevalue(family)
    kw = dict(num_solver_steps=STEPS, multiphase=PHASES, int8_no_grad_fwd=mode == "scoped",
              **m["cfg_kw"])
    jcfg, pcfg = jdistill.DistillConfig(**kw), distill.DistillConfig(**kw)
    run_mode = None if mode == "scoped" else mode
    jtx_g, jtx_d = jax_make_optimizer(LR, eps=EPS), jax_make_optimizer(LR, b1=0.0, eps=EPS)
    jg, jd = JTrainState.create(m["jlora"], jtx_g), JTrainState.create(m["jd_params"], jtx_d)
    jbatch = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    key = jax.random.PRNGKey(95)
    jstep = _step(m["jbuild"], m["jb"], jadv, kind, m["jsched"], jcfg, m["jdisc"], jtx_g, jtx_d)
    with jax_reference_ops(), (jquant.int8_matmul(which=run_mode) if run_mode
                               else contextlib.nullcontext()):
        jnew = jax.jit(jstep)(jg, jd, m["jfrozen"], jbatch, key)
    step_key = jax.random.fold_in(key, 0)
    if kind == "d":
        step_key = jax.random.fold_in(step_key, 7)
    draws = m["draws"](step_key, jbatch, jcfg)

    tx_g, tx_d = make_optimizer(LR, eps=EPS), make_optimizer(LR, b1=0.0, eps=EPS)
    g = convert.train_state_from_jax(jg)
    d = convert.train_state_from_jax(jd, convert.disc_state_from_jax)
    g0, d0 = TrainState(0, g.params, tx_g.init(g.params)), TrainState(0, d.params,
                                                                     tx_d.init(d.params))
    pstep = _step(m["pbuild"], m["pb"], adv, kind, m["psched"], pcfg, m["disc"], tx_g, tx_d)
    fn_calls = []
    real_fwd = quant.Int8MatmulFn.forward
    monkeypatch.setattr(quant.Int8MatmulFn, "forward", staticmethod(
        lambda ctx, x, *a: fn_calls.append(x.requires_grad) or real_fwd(ctx, x, *a)))

    def port(nudge=0.0):
        batch = {k: t(v) for k, v in m["batch"].items()}
        batch["latents"] = batch["latents"] * (1 + nudge)
        with quant.int8_matmul(run_mode) if run_mode else contextlib.nullcontext():
            return _readings(pstep(g0, d0, m["pfrozen"], batch, draws), kind)

    ours = port()
    calls = list(fn_calls)
    spread = [port(n) for n in NUDGES]
    ref = {("metric", k): torch.as_tensor(float(v)) for k, v in jnew[-1].items()}
    for i, which in {"g": [(0, "g")], "d": [(0, "d")], "pair": [(0, "g"), (1, "d")]}[kind]:
        conv = convert.lora_state_from_jax if which == "g" else convert.disc_state_from_jax
        ref.update({(which + ".mu", k): v for k, v in conv(
            _np_tree(convert._find_adam(jnew[i].opt_state).mu)).items()})
        ref.update({(which + ".params", k): v for k, v in conv(_np_tree(jnew[i].params)).items()})
    assert set(ours) == set(ref)
    tops = {w: max(float(v.abs().max()) for (w_, _), v in ref.items() if w_ == w)
            for w, _ in ref if w.endswith(".mu")}
    for (which, k), r in ref.items():
        if which.endswith(".mu") and float(r.abs().max()) < 1e-6 * tops[which]:
            continue  # round-off
        rel = not which.endswith(".params")
        floor = 1e-3 if which.endswith(".mu") or k.endswith("grad_norm") else 1e-5
        noise = max(_diff(s[which, k], ours[which, k], rel) for s in spread)
        err = _diff(ours[which, k], r, rel)
        assert err <= max(floor, 4 * noise), (which, k, err, noise)
    before = {"g": g0.params, "d": d0.params}
    for which in {"g": "g", "d": "d", "pair": "gd"}[kind]:
        assert max(float((ours[which + ".params", k] - v).abs().max())
                   for k, v in before[which].items()) > 1e-6
    for p in m["disc"].parameters():  # the heads' module is never quantized
        assert p.is_floating_point()
    # the int8 products (their inputs' requires_grad): under fused every
    # Linear of every forward, the student's and the taps' with grad (G)
    # included; under scoped none with grad, and none in the taps (the
    # teacher and target forwards alone, `fam.prepare`)
    if mode != "scoped":
        assert any(calls) == (kind != "d") and not all(calls)
    if mode == "scoped":
        assert calls and not any(calls)
