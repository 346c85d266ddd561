"""SD3 on int8 frozen weights in the port against `pcm_tpu` (CPU, fp32, TINY
sizes): `quantize_frozen` on the whole SD3 bundle, `DequantLinear` and the
three text towers on int8 weights, the MMDiT forward and the flow
consistency step under each ``--int8-matmul`` mode. The SD3 entry points on
int8 weights are tested beside the others: `tests/test_torch_sd3_adv.py`
(training), `tests/test_torch_sd3.py` and `tests/test_torch_serving.py`
(serving), `tests/test_torch_generate.py` (generate).

Weights and inputs are drawn with numpy and cross through
`pcm_tpu_torch.models.convert`; the JAX side runs its plain ops
(`pcm_tpu.ops.common.reference_ops`) and, under ``fused``, its Pallas int8
kernel in interpret mode. Both sides quantize every weight (``min_size=0``).
Bounds: the codes and scales bit for bit; a `DequantLinear` against
``nn.Dense`` on a `QTensor` 1e-6; the prompt encoding on int8 towers rel-max
1e-4 (the float towers' bound in `tests/test_torch_sd3.py`); the MMDiT
forward 1e-4. Through a whole step on int8 products an fp32 round-off
between the packages (they add a Linear's bias and its LoRA term in another
order) can flip an activation code, a step of amax / 127 in one product: a
nudge of the latents by one fp32 ulp moves the port's own flow target by
4.8e-4 (rel-max) under ``dense`` on these inputs. So the flow step on int8
is held to: target rel-max 1e-3 (`tests/test_torch_int8.py`'s bound for
whole models on int8 paths), loss rtol 1e-4, LoRA grads rel-max 1e-2 (each
leaf, to its largest entry), params atol 1e-5 with Adam's eps 1e-2 (the
float step's bound).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core.schedule import make_flow_schedule as jax_make_flow_schedule
from pcm_tpu.core.solver import PhasedEulerSolver as JEulerSolver
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu.utils import quant as jquant
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core import losses
from pcm_tpu_torch.core.schedule import make_flow_schedule
from pcm_tpu_torch.core.solver import PhasedEulerSolver
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.state import make_optimizer
from pcm_tpu_torch.utils import quant
from torch_port_helpers import random_params, rel_max

CPU = torch.device("cpu")
RANK = 4
TOKS = ("input_ids", "input_ids_2", "input_ids_3")


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


def _states(pb, jfrozen):
    """The port's state dicts of a JAX SD3 frozen tree (float or int8)."""
    return {"mmdit": convert.mmdit_state_from_jax(jfrozen["mmdit"]),
            "vae": convert.vae_state_from_jax(jfrozen["vae"]),
            "text": convert.clip_state_from_jax(jfrozen["text"], pb.text_cfg),
            "text2": convert.clip_state_from_jax(jfrozen["text2"], pb.text2_cfg),
            "t5": convert.t5_state_from_jax(jfrozen["t5"], pb.t5_cfg)}


@pytest.fixture(scope="module")
def sd3():
    """The TINY SD3 bundles of both packages with numpy-drawn weights (every
    module) and a LoRA with non-zero ``b``, each quantized by its own
    package's `quantize_frozen` at ``min_size=0``."""
    jb = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True)
    with jax_reference_ops():
        jfrozen, jlora = random_params(lambda r: jb.init(r), seed=80)
    jfrozen = _np_tree(jfrozen)
    pb = families.sd3_bundle(RANK, dtype=torch.float32, tiny=True)
    float_states = _states(pb, jfrozen)
    pfrozen = quant.quantize_frozen(pb.from_states(float_states, CPU), min_size=0)
    jq = _np_tree(jquant.quantize_frozen(jfrozen, min_size=0))
    return dict(jb=jb, jq=jq, jlora=jlora, pb=pb, pfrozen=pfrozen, float_states=float_states)


def test_quantize_frozen_sd3_matches_jax_bit_for_bit(sd3):
    """`quantize_frozen` on the TINY SD3 bundle: the MMDiT (its
    ``pos_embed.proj`` conv included), CLIP-L, CLIP-bigG and T5 hold the
    JAX package's int8 codes and scales leaf for leaf; the VAE, the
    embeddings and the MMDiT's position table stay as they were; the bytes
    saved agree."""
    pb, pfrozen = sd3["pb"], sd3["pfrozen"]
    theirs = _states(pb, sd3["jq"])
    n_int8 = {}
    for name, module in pfrozen.items():
        ours = module.state_dict()
        assert set(ours) == set(theirs[name]), name
        for k, v in ours.items():
            ref = theirs[name][k]
            assert ref.dtype == v.dtype and ref.shape == v.shape, (name, k)
            assert torch.equal(ref, v), (name, k)
            if not (v.dtype == torch.int8 or k.endswith("weight_scale")):  # untouched
                assert torch.equal(v, sd3["float_states"][name][k].to(v.dtype)), (name, k)
        n_int8[name] = sum(v.dtype == torch.int8 for v in ours.values())
    assert n_int8["vae"] == 0 and all(n_int8[k] > 10 for k in ("mmdit", "text", "text2", "t5"))
    assert pfrozen["mmdit"].pos_embed.proj.weight_values.shape == (32, 4, 2, 2)
    for emb in (pfrozen["t5"].shared, pfrozen["text"].text_model.embeddings.token_embedding):
        assert emb.weight.is_floating_point()
    assert quant.quantized_bytes_saved(pfrozen) == jquant.quantized_bytes_saved(sd3["jq"])


class _Dense(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.features, name="layer")(x)


def test_dequant_linear_matches_flax_dense_on_qtensor():
    """An int8 `DequantLinear` (64 -> 48) at fp32 against flax's stock
    ``nn.Dense`` on `quantize_tree`'s QTensor: JAX reads the QTensor through
    ``__jax_array__``, which rounds the dequantized weight to bf16 before the
    fp32 product; dequantizing straight to fp32 is 1.2e-3 away here."""
    rng = np.random.default_rng(81)
    x = rng.standard_normal((5, 64), dtype=np.float32)
    m = _Dense(48)
    params = random_params(m.init, jnp.asarray(x), seed=82)["params"]
    qparams = jquant.quantize_tree(params, min_size=0)
    ref = m.apply({"params": qparams}, jnp.asarray(x))
    layer = quant.DequantLinear(64, 48)
    layer.load_state_dict({"weight": t(np.asarray(params["layer"]["kernel"]).T),
                           "bias": t(params["layer"]["bias"])})
    quant.quantize_module(layer, min_size=0)
    assert layer.weight is None
    with torch.no_grad():
        assert rel_max(layer(t(x)), ref) <= 1e-6


def test_encode_prompts_on_int8_towers_matches_jax(sd3):
    """CLIP-L, CLIP-bigG and T5 on int8 weights (`DequantLinear` throughout)
    through `encode_prompts`, against the JAX towers on the quantized tree
    (2.3e-3 away with the weights dequantized straight to fp32)."""
    ids = {k: HashTokenizer()(["a red square", "a blue circle on grass", ""]) for k in TOKS}
    with jax_reference_ops():
        ref = jax.jit(sd3["jb"].encode_prompts)(sd3["jq"], *(jnp.asarray(ids[k]) for k in TOKS))
    with torch.no_grad():
        ours = sd3["pb"].encode_prompts(sd3["pfrozen"], *(t(ids[k]).long() for k in TOKS))
    assert rel_max(ours["prompt_embeds"], ref["prompt_embeds"]) < 1e-4
    assert rel_max(ours["pooled"], ref["pooled"]) < 1e-4


def _mmdit_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ts = np.array([999.0, 261.5], np.float32)
    cond = {"prompt_embeds": rng.standard_normal((2, 14, 32), dtype=np.float32),
            "pooled": rng.standard_normal((2, 32), dtype=np.float32)}
    return x, ts, cond


def _jax_mode(mode):
    return jquant.int8_matmul(which=mode) if mode else _null()


def _port_mode(mode):
    return quant.int8_matmul(mode) if mode else _null()


def _null():
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.parametrize("mode", [None, "dense", "fused"], ids=["dequant", "dense", "fused"])
def test_mmdit_forward_on_int8_matches_jax(sd3, mode):
    """The TINY MMDiT's teacher forward on int8 weights, dequantized or on
    an int8 path, against the JAX model under the same mode."""
    x, ts, cond = _mmdit_inputs(83)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    with jax_reference_ops(), _jax_mode(mode):
        ref = jax.jit(lambda x_, t_: sd3["jb"].teacher(sd3["jq"], x_, t_, jcond))(
            jnp.asarray(x), jnp.asarray(ts))
    with torch.no_grad(), _port_mode(mode):
        ours = sd3["pb"].teacher(sd3["pfrozen"], t(x), t(ts), {k: t(v) for k, v in cond.items()})
    assert ours.shape == (2, 8, 8, 4)
    assert rel_max(ours, ref) < 1e-4


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32),
            "pooled_embeds": rng.standard_normal((n, 32), dtype=np.float32),
            "uncond_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32) * 0.1,
            "uncond_pooled": rng.standard_normal((n, 32), dtype=np.float32) * 0.1}


@pytest.mark.parametrize("mode", ["scoped", "dense", "fused"])
def test_flow_distill_step_on_int8_matches_jax(sd3, mode):
    """One `build_flow_distill_step` (fixed w = 3, 10 solver steps, 2
    phases) on int8 frozen weights on JAX's draws: ``scoped`` runs the
    teacher and target forwards under ``dense`` and the student on the
    dequantized weights (`DistillConfig.int8_no_grad_fwd` on both sides),
    ``dense`` / ``fused`` every forward and backward in the mode. The target,
    the loss, the LoRA gradients and the LoRA after the AdamW update."""
    lr, eps = 1e-3, 1e-2  # see tests/test_torch_train.py: Adam's eps on round-off
    kw = dict(num_solver_steps=10, multiphase=2, fixed_w=3.0, int8_no_grad_fwd=mode == "scoped")
    jcfg, pcfg = jdistill.DistillConfig(**kw), distill.DistillConfig(**kw)
    run_mode = None if mode == "scoped" else mode
    jb, jfrozen = sd3["jb"], {"mmdit": sd3["jq"]["mmdit"]}
    jsched = jax_make_flow_schedule(shift=3.0)
    jsol = JEulerSolver.create(jsched, 10)
    jtx = jax_make_optimizer(lr, eps=eps)
    batch = _batch(2, 84)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jgrad(lora, key):
        parts = jdistill.flow_prepare(jb, jsched, jsol, jcfg, jfrozen, lora, jbatch, key)

        def loss_fn(lora_):
            pred = jdistill.flow_model_pred(jb, jsched, jsol, jcfg, jfrozen, lora_, parts)
            return jlosses.consistency_loss(pred, parts["target"], jcfg.loss_type, jcfg.huber_c)

        return parts["target"], {k: parts[k] for k in ("noise", "index", "w")}, \
            jax.value_and_grad(loss_fn)(lora)

    with jax_reference_ops(), _jax_mode(run_mode):
        jstate = JTrainState.create(sd3["jlora"], jtx)
        target, jdraws, (jloss, jgrads) = jax.jit(jgrad)(jstate.params, jax.random.PRNGKey(85))
        jnew = jax.jit(lambda s, g: jdistill._apply_updates(s, g, jtx))(jstate, jgrads)

    pb, frozen = sd3["pb"], {"mmdit": sd3["pfrozen"]["mmdit"]}
    psched = make_flow_schedule(shift=3.0)
    psol = PhasedEulerSolver.create(psched, 10)
    ptx = make_optimizer(lr, eps=eps)
    pstate = convert.train_state_from_jax(jstate)
    tbatch = {k: t(v) for k, v in batch.items()}
    draws = {k: t(v) for k, v in jdraws.items()}
    with _port_mode(run_mode):
        parts = distill.flow_prepare(pb, psched, psol, pcfg, frozen, pstate.params, tbatch, draws)
        lora = {k: p.detach().requires_grad_(True) for k, p in pstate.params.items()}
        pred = distill.flow_model_pred(pb, psched, psol, pcfg, frozen, lora, parts)
        grads = torch.autograd.grad(losses.consistency_loss(pred, parts["target"]),
                                    list(lora.values()))
        new, pm = distill.build_flow_distill_step(pb, psched, pcfg, ptx)(
            pstate, frozen, tbatch, [draws])
    assert rel_max(parts["target"], target) < 1e-3
    ref = convert.lora_state_from_jax(jgrads)
    for k, g in zip(lora, grads):
        assert rel_max(g, ref[k]) < 1e-2, k
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-4)
    ref_params = convert.lora_state_from_jax(jnew.params)
    for k, p in new.params.items():
        np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)
    assert max(float((new.params[k] - pstate.params[k]).abs().max()) for k in ref_params) > 1e-6


def test_flow_step_scoped_takes_int8_only_in_teacher_and_target(sd3, monkeypatch):
    """Under ``scoped`` the int8 products are those of the teacher and target
    forwards (no grad), as `pcm_tpu/train/distill.py:62-69` scopes them: the
    differentiated student forward takes none."""
    calls = []
    real = quant.quantized_dot

    def spy(x, qt):
        calls.append(torch.is_grad_enabled())
        return real(x, qt)

    monkeypatch.setattr("pcm_tpu_torch.lora.layers.quantized_dot", spy)
    cfg = distill.DistillConfig(num_solver_steps=10, multiphase=2, fixed_w=3.0,
                                int8_no_grad_fwd=True)
    pb, frozen = sd3["pb"], {"mmdit": sd3["pfrozen"]["mmdit"]}
    lora = convert.lora_state_from_jax(_np_tree(sd3["jlora"]))
    tbatch = {k: t(v) for k, v in _batch(2, 86).items()}
    draws = distill.sample_draws(cfg, torch.Generator().manual_seed(0), tbatch["latents"])
    from pcm_tpu_torch.train.state import TrainState

    tx = make_optimizer(1e-3)
    distill.build_flow_distill_step(pb, make_flow_schedule(shift=3.0), cfg, tx)(
        TrainState.create(lora, tx), frozen, tbatch, [draws])
    assert calls and not any(calls)
    n_forward = len(calls)
    calls.clear()
    with quant.int8_matmul("dense"):
        distill.build_flow_distill_step(pb, make_flow_schedule(shift=3.0), cfg, tx)(
            TrainState.create(lora, tx), frozen, tbatch, [draws])
    assert any(calls) and len(calls) > n_forward
