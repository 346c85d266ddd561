"""The port's remat policies and granularity (`pcm_tpu_torch/ops/common.py:
resolve_remat_policy`, `models/unet.py`, `models/mmdit.py`) against
`pcm_tpu` on the CPU, TINY sizes, fp32.

- The names: the port accepts and refuses what `pcm_tpu.ops.common.
  resolve_remat_policy` does.
- The decisions: on a table of products (batched or not, at a cap and one
  element over it, bf16, fp32 and int8) the port's policy keeps the aten
  product iff JAX's policy keeps the ``dot_general`` of the same shapes.
- A TINY ``BasicTransformerBlock`` with LoRA under ``dots`` and
  ``nothing``: the products the port keeps are the ``dot_general``
  residuals JAX keeps (`saved_residuals`), shape for shape, plus the
  block's last two products (``ff.net_2``'s base and LoRA up), whose
  outputs feed only the residual sum: no backward op reads them, so XLA's
  partial evaluation drops them, while a selective checkpoint keeps what
  its policy names.
- The TINY SD1.5, SDXL (remat on the attention level only) and SD3
  consistency steps and the SDXL adversarial fused pair: loss and LoRA
  gradients (and the heads' for the pair) bit for bit equal under every
  policy and both granularities to ``full`` at ``module`` and to no remat.
- One case a family against the JAX step under ``dots8m+fa`` (``block``
  for the UNets), JAX's draws fed to the port: loss rtol 1e-5, each LoRA
  gradient rel-max 1e-3 (tests/test_torch_train.py's bounds). The JAX side
  runs its plain XLA ops (`reference_ops`), where flash attention is plain
  attention: ``+fa`` names no residual there.
- K1's forward counted: the recompute calls it once an attention in a
  region under ``full`` and ``dots``, never under ``+fa``.
- The regions: one a resnet and a BasicTransformerBlock under ``block``,
  one a resnet and a Transformer2D under ``module``, levels masked by
  ``remat_levels``, none keeping the RNG state (the blocks draw none).
- ``python -m pcm_tpu_torch.train --remat dots8m+fa`` runs two steps, the
  granularity is ``block`` by default, other names are refused by name.
"""

import collections
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as tuc
from jax import lax
from jax._src.ad_checkpoint import saved_residuals

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import make_ddpm_schedule as jax_ddpm_schedule
from pcm_tpu.core.schedule import make_flow_schedule as jax_flow_schedule
from pcm_tpu.core import solver as jsolver
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.attention import BasicTransformerBlock as JBlock
from pcm_tpu.models.mmdit import SD3_LORA_TARGETS
from pcm_tpu.models.mmdit import MMDiT as JMMDiT
from pcm_tpu.models.mmdit import TINY_MMDIT_CONFIG as J_TINY_MMDIT
from pcm_tpu.models.unet import TINY_SDXL_CONFIG as J_TINY_SDXL
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.ops import common as jcommon
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu_torch.configs.families import disc_config, sd3_bundle, sd15_bundle, sdxl_bundle
from pcm_tpu_torch.core.losses import consistency_loss
from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
from pcm_tpu_torch.core.solver import PhasedDDIMSolver, PhasedEulerSolver, phase_boundaries
from pcm_tpu_torch.lora.layers import LoRASpec, attach_lora
from pcm_tpu_torch.models import convert, unet
from pcm_tpu_torch.models.attention import BasicTransformerBlock
from pcm_tpu_torch.ops import common
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from pcm_tpu_torch.utils import quant
from torch_port_helpers import random_params, rel_max

fa = importlib.import_module("pcm_tpu_torch.ops.flash_attention")

CPU = torch.device("cpu")
RANK = 4
GROUPS = 8  # see tests/test_torch_train.py: 32 one-channel groups zero a LoRA grad
SOLVER_STEPS, PHASES = 10, 2
POLICIES = (None, "nothing", "dots", "dots_small", "dots8m", "nothing+fa", "dots+fa",
            "dots_small+fa", "dots8m+fa")
SDXL_LEVELS = (False, True)  # TINY SDXL's attention level only


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# names and decisions
# ---------------------------------------------------------------------------

NAMES = ("nothing", "dots", "dots_small", "dots0m", "dots8m", "dots1024m", "dots007m",
         "nothing+fa", "dots+fa", "dots_small+fa", "dots8m+fa", "nothing+fa+fa",
         "full", "none", "bogus", "+fa", "fa", "dots8", "dotsm", "dots-1m", "dots1.5m",
         "Dots", "dots8M", "dots8m+FA", "dots8m +fa", "")


@pytest.mark.parametrize("name", NAMES)
def test_policy_names_match_jax(name):
    def accepts(resolve):
        try:
            resolve(name)
        except (KeyError, ValueError):
            return False
        return True

    assert accepts(common.resolve_remat_policy) == accepts(jcommon.resolve_remat_policy)
    assert common.resolve_remat_policy(None) is None and jcommon.resolve_remat_policy(None) is None


# (lhs shape, rhs shape, dtype, batched): a JAX dot_general contracting the
# lhs's last axis with the rhs's first (and, batched, sharing the leading axis)
PRODUCTS = [
    ((512, 256), (256, 512), "float32", False),   # 1 MiB out: at the cap
    ((512, 256), (256, 513), "float32", False),   # one column over
    ((512, 64), (64, 1024), "bfloat16", False),   # 1 MiB bf16
    ((513, 64), (64, 1024), "bfloat16", False),   # one row over
    ((2, 128, 64), (64, 1024), "bfloat16", False),  # a Dense on (b, s, k): at the cap
    ((2, 129, 64), (64, 1024), "bfloat16", False),
    ((4, 64, 32), (4, 32, 64), "float32", True),  # a batched product: never kept
    ((1, 8, 8), (1, 8, 8), "float32", True),
    ((256, 128), (128, 1024), "int8", False),     # int8 x int8 -> int32: 1 MiB
    ((257, 128), (128, 1024), "int8", False),
    ((3, 5), (5, 7), "float32", False),
]


def _jax_keeps(policy, lhs, rhs, dtype, batched):
    a = jax.ShapeDtypeStruct(lhs, jnp.dtype(dtype))
    b = jax.ShapeDtypeStruct(rhs, jnp.dtype(dtype))
    if batched:
        dims = (((2,), (1,)), ((0,), (0,)))
    else:
        dims = (((len(lhs) - 1,), (0,)), ((), ()))
    pref = jnp.int32 if dtype == "int8" else None
    eqn = jax.make_jaxpr(lambda x, y: lax.dot_general(x, y, dims, preferred_element_type=pref))(
        a, b).eqns[0]
    return bool(policy(eqn.primitive, *(v.aval for v in eqn.invars), **eqn.params))


def _torch_call(lhs, rhs, dtype, batched, bias: bool):
    """The aten op and arguments the port's products dispatch for these
    shapes: ``mm`` / ``addmm`` on the folded rows, ``_int_mm`` for int8,
    ``bmm`` for a batched product and for a broadcast weight."""
    dt = getattr(torch, dtype)
    a, b = torch.empty(lhs, dtype=dt, device="meta"), torch.empty(rhs, dtype=dt, device="meta")
    if batched:
        return torch.ops.aten.bmm.default, (a, b)
    if dtype == "int8":
        return torch.ops.aten._int_mm.default, (a.reshape(-1, lhs[-1]), b)
    if len(lhs) == 3 and bias:  # a non-contiguous input: matmul's broadcast bmm
        return torch.ops.aten.bmm.default, (a, b.expand(lhs[0], *rhs))
    if bias:
        return torch.ops.aten.addmm.default, (torch.empty(rhs[-1], dtype=dt, device="meta"),
                                              a.reshape(-1, lhs[-1]), b)
    return torch.ops.aten.mm.default, (a.reshape(-1, lhs[-1]), b)


@pytest.mark.parametrize("bias", [False, True], ids=["mm", "addmm_or_broadcast_bmm"])
@pytest.mark.parametrize("name", ["dots", "dots1m", "dots_small", "nothing", "dots1m+fa"])
def test_policy_decisions_match_jax(name, bias):
    """Each product of `PRODUCTS` is kept by the port iff JAX's policy keeps
    its ``dot_general``; ``+fa`` adds K1's op and nothing else; a gather's
    collective, its copies and a convolution are never kept."""
    jpol, ppol = jcommon.resolve_remat_policy(name), common.resolve_remat_policy(name)
    for lhs, rhs, dtype, batched in PRODUCTS:
        if dtype == "int8" and name.startswith("dots_small"):
            continue
        func, args = _torch_call(lhs, rhs, dtype, batched, bias)
        assert ppol.saves(func, *args) == _jax_keeps(jpol, lhs, rhs, dtype, batched), (
            lhs, rhs, dtype, batched)
    x = torch.empty((2, 8, 4, 16), device="meta")
    assert ppol.saves(torch.ops.pcm_tpu_torch.flash_fwd.default, x, x, x, 0.25) == \
        name.endswith("+fa")
    flat = torch.empty(64, dtype=torch.uint8, device="meta")
    for func, args in ((torch.ops.aten.copy_.default, (flat, flat)),
                       (torch.ops.aten.empty_strided.default, ((8,), (1,))),
                       (torch.ops.aten.convolution.default,
                        (torch.empty(1, 4, 8, 8, device="meta"),
                         torch.empty(4, 4, 1, 1, device="meta")))):
        assert not ppol.saves(func, *args)
    assert hasattr(torch.ops, "c10d") and not ppol.saves(
        torch.ops.c10d._allgather_base_.default, flat, flat)
    from torch.utils.checkpoint import CheckpointPolicy
    assert ppol(None, torch.ops.aten.mm.default, torch.empty((2, 2), device="meta"),
                torch.empty((2, 2), device="meta")) == (
        CheckpointPolicy.PREFER_RECOMPUTE if name == "nothing" else CheckpointPolicy.MUST_SAVE)


# ---------------------------------------------------------------------------
# what a block keeps, against JAX's residuals
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    """Record ``(op, output shape)`` of each op a policy keeps in a forward."""
    kept = []
    real = tuc.create_selective_checkpoint_contexts

    def spy(policy, **kw):
        def recording(ctx, func, *args, **kwargs):
            out = policy(ctx, func, *args, **kwargs)
            if not ctx.is_recompute and out == tuc.CheckpointPolicy.MUST_SAVE:
                kept.append((str(func), tuple(ctx.op_output.shape)))
            return out
        return real(recording, **kw)

    monkeypatch.setattr(tuc, "create_selective_checkpoint_contexts", spy)
    return kept


@pytest.mark.parametrize("name", ["dots", "nothing"])
def test_block_keeps_jax_residuals(monkeypatch, name):
    spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 32), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 24), dtype=np.float32)
    v = random_params(JBlock(32, 2, 16, 24, lora=spec).init, jnp.asarray(x), jnp.asarray(ctx),
                      seed=3)
    remat = jax.checkpoint(lambda lora, x_: JBlock(32, 2, 16, 24, lora=spec).apply(
        {"params": v["params"], "lora": lora}, x_, jnp.asarray(ctx)),
        policy=jcommon.resolve_remat_policy(name))
    with jcommon.reference_ops():
        res = saved_residuals(lambda lora, x_: remat(lora, x_).sum(), v["lora"], jnp.asarray(x))
    jax_kept = collections.Counter(
        (int(np.prod(a.shape[:-1])), a.shape[-1]) for a, desc in res
        if "argument" not in desc and "constant" not in desc)

    blk = BasicTransformerBlock(32, 2, 16, 24)
    blk.load_state_dict(convert.unet_state_from_jax(v["params"]))
    attach_lora(blk, LoRASpec(RANK, 8.0, SD_UNET_LORA_TARGETS))
    blk.requires_grad_(False)
    lora = {k: p.requires_grad_(True) for k, p in convert.lora_state_from_jax(v["lora"]).items()}
    kept = _spy(monkeypatch)
    y = unet.checkpoint(blk, t(x), t(ctx), lora, policy=name)
    torch.autograd.grad(y.sum(), list(lora.values()))
    assert all(op in ("aten.mm.default", "aten.addmm.default") for op, _ in kept)
    port_kept = collections.Counter(shape for _, shape in kept)
    if name == "nothing":
        assert not jax_kept and not port_kept
        return
    assert sum(jax_kept.values()) == 28
    assert port_kept == jax_kept + collections.Counter({(32, 32): 2})


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _set_remat(module, setting: str, levels=None) -> None:
    """``setting``: ``none``, or ``<full | policy>/<module | block>``."""
    name, _, gran = setting.partition("/")
    module.remat = name != "none"
    module.remat_policy = None if name in ("full", "none") else name
    if hasattr(module, "remat_granularity"):
        module.remat_granularity, module.remat_levels = gran or "module", levels


@pytest.fixture(scope="module")
def tiny():
    """Per family: the JAX frozen tree and LoRA (numpy-drawn), the port's
    bundle on the converted weights and a cached batch."""
    out = {}
    spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    rng = np.random.default_rng(5)
    for fam, jcfg, pmake in (("sd15", J_TINY_UNET, sd15_bundle),
                             ("sdxl", J_TINY_SDXL, sdxl_bundle)):
        jcfg = dataclasses.replace(jcfg, norm_groups=GROUPS)
        added = ({"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
                 if fam == "sdxl" else None)
        v = random_params(JUNet(jcfg, lora=spec).init, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                          jnp.zeros((1, 7, 32)), added, seed=6)
        pb = pmake(RANK, dtype=torch.float32, tiny=True)
        pb = dataclasses.replace(pb, unet_cfg=dataclasses.replace(pb.unet_cfg, norm_groups=GROUPS))
        batch = {"latents": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
                 "prompt_embeds": rng.standard_normal((2, 7, 32), dtype=np.float32)}
        if fam == "sd15":
            batch["uncond_embeds"] = 0.1 * rng.standard_normal((2, 7, 32), dtype=np.float32)
        else:
            batch.update(pooled_embeds=rng.standard_normal((2, 32), dtype=np.float32),
                         time_ids=np.tile(np.array([32, 32, 0, 0, 32, 32], np.float32), (2, 1)))
        frozen = pb.build(CPU)
        frozen["unet"].load_state_dict(convert.unet_state_from_jax(v["params"]))
        out[fam] = dict(jcfg=jcfg, jparams=v["params"], jlora=v["lora"], pb=pb, batch=batch,
                        frozen=frozen, key="unet", levels=SDXL_LEVELS if fam == "sdxl" else None)
    sd3_spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD3_LORA_TARGETS)
    v = random_params(JMMDiT(J_TINY_MMDIT, lora=sd3_spec).init, jnp.zeros((1, 8, 8, 4)),
                      jnp.zeros((1,)), jnp.zeros((1, 14, 32)), jnp.zeros((1, 32)), seed=7)
    pb = sd3_bundle(RANK, dtype=torch.float32, tiny=True)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
             "prompt_embeds": rng.standard_normal((2, 14, 32), dtype=np.float32),
             "pooled_embeds": rng.standard_normal((2, 32), dtype=np.float32),
             "uncond_embeds": 0.1 * rng.standard_normal((2, 14, 32), dtype=np.float32),
             "uncond_pooled": 0.1 * rng.standard_normal((2, 32), dtype=np.float32)}
    out["sd3"] = dict(jparams=v["params"], jlora=v["lora"], pb=pb, batch=batch,
                      frozen=pb.from_states({"mmdit": convert.mmdit_state_from_jax(v["params"])},
                                            CPU),
                      key="mmdit", levels=None)
    return out


def _distill_cfg(fam):
    kw = dict(num_solver_steps=SOLVER_STEPS, multiphase=PHASES)
    return kw | (dict(fixed_w=3.0) if fam == "sd3" else dict(w_min=4.0, w_max=5.0))


def _consistency(m, fam, setting, draws=None):
    """Loss and LoRA gradients of one consistency microbatch (the body of
    the distill step's grad_fn) under ``setting``, on ``draws`` (default:
    the port's own from seed 3)."""
    pb, frozen = m["pb"], m["frozen"]
    _set_remat(frozen[m["key"]], setting, m["levels"])
    cfg = distill.DistillConfig(**_distill_cfg(fam))
    batch = {k: t(v) for k, v in m["batch"].items()}
    if draws is None:
        draws = distill.sample_draws(cfg, torch.Generator().manual_seed(3), batch["latents"])
    lora = {k: p.detach().clone().requires_grad_(True)
            for k, p in convert.lora_state_from_jax(m["jlora"]).items()}
    if fam == "sd3":
        sched = make_flow_schedule(shift=3.0)
        sol = PhasedEulerSolver.create(sched, SOLVER_STEPS)
        with torch.no_grad():
            parts = distill.flow_prepare(pb, sched, sol, cfg, frozen, lora, batch, draws)
        pred = distill.flow_model_pred(pb, sched, sol, cfg, frozen, lora, parts)
    else:
        sched = make_ddpm_schedule()
        sol = PhasedDDIMSolver.create(sched, SOLVER_STEPS)
        bounds = t(phase_boundaries(SOLVER_STEPS, PHASES))
        with torch.no_grad():
            parts = distill.ddim_prepare(pb, sched, sol, bounds, cfg, frozen, lora, batch, draws)
        pred = distill.ddim_model_pred(pb, sched, sol, cfg, frozen, lora, parts)
    loss = consistency_loss(pred, parts["target"])
    grads = torch.autograd.grad(loss, list(lora.values()))
    return [loss.detach(), *grads], dict(zip(lora, grads))


def _fused_pair(m, setting, monkeypatch):
    """The SDXL adversarial fused pair's metrics and the G and D gradients
    (caught on their way to the optimizer) under ``setting``."""
    pb, frozen = m["pb"], m["frozen"]
    _set_remat(frozen["unet"], setting, m["levels"])
    cfg = distill.DistillConfig(**_distill_cfg("sdxl"))
    disc, d_params = adv.init_discriminator(disc_config("sdxl", tiny=True),
                                            pb.unet_cfg.tap_channels(),
                                            torch.Generator().manual_seed(4), CPU)
    tx_g, tx_d = make_optimizer(1e-3, eps=1e-2), make_optimizer(1e-3, b1=0.0, eps=1e-2)
    caught = []
    real = adv.apply_updates
    monkeypatch.setattr(adv, "apply_updates",
                        lambda state, grads, tx: caught.append(grads) or real(state, grads, tx))
    pair = adv.build_ddim_adv_fused_pair(pb, make_ddpm_schedule(), cfg, adv.AdvConfig(0.1), disc,
                                         tx_g, tx_d)
    batch = {k: t(v) for k, v in m["batch"].items()}
    span = adv.adv_offset_span(make_ddpm_schedule(), cfg)
    draws = [distill.sample_draws(cfg, torch.Generator().manual_seed(3), batch["latents"], span)]
    lora = convert.lora_state_from_jax(m["jlora"])
    _, _, metrics = pair(TrainState.create(lora, tx_g), TrainState.create(d_params, tx_d),
                         frozen, batch, draws)
    assert len(caught) == 2
    return ([metrics[k] for k in sorted(metrics)]
            + [g for grads in caught for _, g in sorted(grads.items())])


SETTINGS = ["none"] + [f"{p or 'full'}/{g}" for p in POLICIES for g in ("module", "block")]


@pytest.mark.parametrize("case", ["sd15", "sdxl", "sd3", "sdxl_fused_pair"])
def test_steps_bit_equal_under_every_setting(tiny, monkeypatch, case):
    fam = case.split("_")[0]
    m = tiny[fam]
    settings = [s for s in SETTINGS if not (fam == "sd3" and s.endswith("/block"))]

    def readings(setting):
        if case == "sdxl_fused_pair":
            return _fused_pair(m, setting, monkeypatch)
        return _consistency(m, fam, setting)[0]

    ref = readings("full/module")
    assert all(torch.isfinite(r).all() for r in ref)
    assert any(float(r.abs().max()) > 0 for r in ref[1:])
    for setting in settings:
        got = readings(setting)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), setting


@pytest.mark.parametrize("mode", ["dense", "fused", "conv", "both"])
def test_int8_modes_bit_equal_under_policies(tiny, mode):
    """On int8 frozen weights (every TINY SDXL weight quantized) under each
    int8 mode, whose products run inside the regions (`Int8MatmulFn` with
    K6's plain version or the whole-row ``_int_mm`` stand-in, `QConvFn`):
    the student's loss and LoRA gradients under the policies equal those
    without remat bit for bit, the backward's recompute run outside the
    mode's context."""
    m = tiny["sdxl"]
    frozen = m["pb"].build(CPU, modules=("unet",))
    frozen["unet"].load_state_dict(m["frozen"]["unet"].state_dict())
    quant.quantize_frozen(frozen, min_size=0)
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    cond = m["pb"].encode(m["frozen"], {k: t(v) for k, v in m["batch"].items()})[1]

    def readings(setting):
        _set_remat(frozen["unet"], setting, m["levels"])
        lora = {k: p.requires_grad_(True)
                for k, p in convert.lora_state_from_jax(m["jlora"]).items()}
        with quant.mode_context(mode):  # `int8_matmul` without its bisection warning
            loss = m["pb"].student(frozen, lora, x, torch.tensor([900.0, 200.0]), cond)
            loss = loss.square().mean()
        return [loss.detach(), *torch.autograd.grad(loss, list(lora.values()))]

    ref = readings("none")
    for setting in ("full/block", "dots/block", "dots8m+fa/module", "nothing+fa/block"):
        assert all(torch.equal(a, b) for a, b in zip(readings(setting), ref)), setting


def _jax_consistency(m, fam, policy):
    """JAX's loss, LoRA gradients and draws of one consistency microbatch,
    its bundle at ``remat=True`` under ``policy`` (``block`` granularity
    for the UNets)."""
    cfg = jdistill.DistillConfig(**_distill_cfg(fam))
    jb = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    if fam == "sd3":
        bundle = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=True, remat_policy=policy,
                                      tiny=True)
        sched = jax_flow_schedule(shift=3.0)
        sol = jsolver.PhasedEulerSolver.create(sched, SOLVER_STEPS)
        frozen = {"mmdit": m["jparams"]}

        def prepare(lora, key):
            return jdistill.flow_prepare(bundle, sched, sol, cfg, frozen, lora, jb, key)

        def pred(lora, parts):
            return jdistill.flow_model_pred(bundle, sched, sol, cfg, frozen, lora, parts)
    else:
        make = jfamilies.sd15_bundle if fam == "sd15" else jfamilies.sdxl_bundle
        bundle = dataclasses.replace(
            make(RANK, dtype=jnp.float32, remat=True, remat_policy=policy,
                 remat_levels=m["levels"], remat_granularity="block", tiny=True),
            unet_cfg=m["jcfg"])
        sched = jax_ddpm_schedule()
        sol = jsolver.PhasedDDIMSolver.create(sched, SOLVER_STEPS)
        bounds = jnp.asarray(jsolver.phase_boundaries(SOLVER_STEPS, PHASES))
        frozen = {"unet": m["jparams"]}

        def prepare(lora, key):
            return jdistill.ddim_prepare(bundle, sched, sol, bounds, cfg, frozen, lora, jb, key)

        def pred(lora, parts):
            return jdistill.ddim_model_pred(bundle, sched, sol, cfg, frozen, lora, parts)

    def fn(lora, key):
        parts = prepare(lora, key)

        def loss_fn(lora_):
            return jlosses.consistency_loss(pred(lora_, parts), parts["target"], cfg.loss_type,
                                            cfg.huber_c)

        return {k: parts[k] for k in ("noise", "index", "w")}, jax.value_and_grad(loss_fn)(lora)

    with jcommon.reference_ops():
        return jax.jit(fn)(m["jlora"], jax.random.PRNGKey(17))


@pytest.mark.parametrize("fam", ["sd15", "sdxl", "sd3"])
def test_step_matches_jax_under_policy(tiny, fam):
    m = tiny[fam]
    draws, (jloss, jgrads) = _jax_consistency(m, fam, "dots8m+fa")
    setting = "dots8m+fa" + ("" if fam == "sd3" else "/block")
    (loss, *_), grads = _consistency(m, fam, setting, {k: t(v) for k, v in draws.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = convert.lora_state_from_jax(jgrads)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        assert rel_max(g, ref[k]) < 1e-3, k


# ---------------------------------------------------------------------------
# K1's forward in the recompute, and the regions
# ---------------------------------------------------------------------------


def _count_k1(monkeypatch):
    calls = [0]
    real = fa.flash_attention_fwd

    def counted(*args):
        calls[0] += 1
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    return calls


@pytest.mark.parametrize("fam", ["sd15", "sdxl", "sd3"])
def test_recompute_skips_k1_under_fa(tiny, monkeypatch, fam):
    """The student's forward calls K1 once an attention; the backward's
    recompute calls it once more an attention under ``full`` and ``dots``
    (every attention of these TINY models lies in a region), never under
    ``+fa`` or without remat."""
    m = tiny[fam]
    module = m["frozen"][m["key"]]
    attentions = sum(type(x).__name__ in ("Attention", "JointTransformerBlock")
                     for x in module.modules())
    calls = _count_k1(monkeypatch)
    lora = {k: p.requires_grad_(True) for k, p in convert.lora_state_from_jax(m["jlora"]).items()}
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    tsteps = torch.tensor([900.0, 200.0])
    cond = m["pb"].encode(m["frozen"], {k: t(v) for k, v in m["batch"].items()})[1]
    for setting, again in (("none", 0), ("full/module", 1), ("full/block", 1), ("dots/block", 1),
                           ("nothing+fa/block", 0), ("dots8m+fa/module", 0),
                           ("dots8m+fa/block", 0)):
        if fam == "sd3" and setting.endswith("/block"):
            setting = setting[: -len("/block")]
        _set_remat(module, setting, m["levels"])
        calls[0] = 0
        out = m["pb"].student(m["frozen"], lora, x, tsteps, cond)
        assert calls[0] == attentions, setting
        torch.autograd.grad(out.square().sum(), list(lora.values()))
        assert calls[0] == attentions * (1 + again), setting


def _expected_regions(unet_module, granularity):
    cfg, out = unet_module.cfg, collections.Counter()
    levels = unet_module.remat_levels or (True,) * len(cfg.block_out_channels)
    blocks = [(i, b) for i, b in enumerate(unet_module.down_blocks)]
    blocks += [(len(levels) - 1, unet_module.mid_block)]
    blocks += [(len(levels) - 1 - i, b) for i, b in enumerate(unet_module.up_blocks)]
    for level, blk in blocks:
        if levels[level]:
            out["ResnetBlock2D"] += len(blk.resnets)
            if granularity == "block":
                out["BasicTransformerBlock"] += sum(len(a.transformer_blocks)
                                                    for a in blk.attentions)
            else:
                out["Transformer2D"] += len(blk.attentions)
    return out


@pytest.mark.parametrize("granularity", ["module", "block"])
@pytest.mark.parametrize("fam", ["sd15", "sdxl", "sd3"])
def test_one_region_per_block(tiny, monkeypatch, fam, granularity):
    m = tiny[fam]
    module = m["frozen"][m["key"]]
    _set_remat(module, f"dots/{granularity}", m["levels"])
    seen = collections.Counter()
    real = tuc.checkpoint

    def counting(fn, *args, **kwargs):
        seen[type(fn).__name__] += 1
        assert kwargs["preserve_rng_state"] is False  # no RNG state kept a LoRA tensor
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(tuc, "checkpoint", counting)
    lora = {k: p.requires_grad_(True) for k, p in convert.lora_state_from_jax(m["jlora"]).items()}
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    cond = m["pb"].encode(m["frozen"], {k: t(v) for k, v in m["batch"].items()})[1]
    out = m["pb"].student(m["frozen"], lora, x, torch.tensor([900.0, 200.0]), cond)
    if fam == "sd3":
        assert seen == {"JointTransformerBlock": module.cfg.num_layers}
    else:
        assert seen == _expected_regions(module, granularity)
        assert seen["BasicTransformerBlock" if granularity == "block" else "Transformer2D"] > 0
    torch.autograd.grad(out.sum(), list(lora.values()))


def test_bundles_pass_the_settings():
    b = sdxl_bundle(RANK, dtype=torch.float32, tiny=True, remat=True, remat_policy="dots8m+fa",
                    remat_levels=SDXL_LEVELS, remat_granularity="block")
    u = b.build(torch.device("meta"), modules=("unet",))["unet"]
    assert (u.remat, u.remat_policy, u.remat_levels, u.remat_granularity) == (
        True, "dots8m+fa", SDXL_LEVELS, "block")
    assert sd15_bundle(tiny=True).remat_granularity == "module"  # JAX's bundle default
    m = sd3_bundle(tiny=True, remat=True, remat_policy="dots").build(
        torch.device("meta"), modules=("mmdit",))["mmdit"]
    assert (m.remat, m.remat_policy) == (True, "dots")
    with pytest.raises(ValueError, match="unknown remat policy"):
        sd15_bundle(tiny=True, remat_policy="dots8").build(torch.device("meta"))
    with pytest.raises(ValueError, match="granularity"):
        sd15_bundle(tiny=True, remat_granularity="layer").build(torch.device("meta"))
    with pytest.raises(ValueError, match="remat_levels"):
        sd15_bundle(tiny=True, remat_levels=(True,)).build(torch.device("meta"))


# ---------------------------------------------------------------------------
# the trainer's flags
# ---------------------------------------------------------------------------


def _train(tmp_path, *extra):
    from pcm_tpu_torch.train.__main__ import main

    cache = tmp_path / "cache"
    if not cache.exists():
        cache.mkdir()
        rng = np.random.default_rng(4)
        np.savez(cache / "shard_00000.npz",
                 latents=rng.standard_normal((4, 8, 8, 4)).astype(np.float16),
                 prompt_embeds=rng.standard_normal((4, 77, 32)).astype(np.float16))
    return main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--cached-latents-dir",
                 str(cache), "--output-dir", str(tmp_path / "run"), "--batch-size", "2",
                 "--log-every", "1", "--no-resume", *extra])


def test_train_cli_runs_a_policy(tmp_path, capsys):
    trainer = _train(tmp_path, "--max-train-steps", "2", "--remat", "dots8m+fa")
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and "step 2:" in printed and "nan" not in printed
    assert "remat dots8m+fa / block" in printed  # the default granularity
    unet_module = trainer.frozen["unet"]
    assert (unet_module.remat, unet_module.remat_policy, unet_module.remat_granularity) == (
        True, "dots8m+fa", "block")
    row = json.loads((tmp_path / "run" / "launches.jsonl").read_text().splitlines()[-1])
    assert row["remat"] == "dots8m+fa" and row["remat_granularity"] == "block"


@pytest.mark.parametrize("name", ["bogus", "dots8", "+fa", "full+fa", "none+fa"])
def test_train_cli_refuses_other_names(tmp_path, capsys, name):
    with pytest.raises(SystemExit) as exc:
        _train(tmp_path, "--remat", name)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert f"unknown remat policy {name!r}" in err and "not yet ported" not in err
