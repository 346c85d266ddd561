"""The port's distillation step and its parts against `pcm_tpu` (fp32, CPU).

Inputs are drawn with numpy; the JAX draws of a step (noise, solver index,
guidance w) are reproduced from its key and fed to the port, so both
packages run the same step. JAX's attention / GroupNorm / GEGLU take their
XLA oracles on the CPU (as `pcm_tpu`'s own step tests do); the kernels'
plain versions stand in for them here. Bounds: solver/schedule/losses 1e-6
(the same fp32 formulas); one TINY distill step: target 1e-4, loss 1e-5,
LoRA grads rel-max 1e-3 (three UNet passes and a backward in another order
of summation), params after the update 1e-5 (Adam's eps raised to 1e-2 for
this, see the test).
"""

import collections
import copy
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs.families import RECIPES as JAX_RECIPES
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import solver as jsolver
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD15Bundle as JSD15Bundle
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs.families import RECIPES, sd15_bundle
from pcm_tpu_torch.core import losses, solver
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.optim8bit import BLOCK, adam8bit_moments
from pcm_tpu_torch.train.state import (TrainState, apply_updates, bias_corrections,
                                       make_optimizer)
from torch_port_helpers import random_params, rel_max


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# schedule, solver, losses
# ---------------------------------------------------------------------------


def test_schedule_solver_losses_match_jax():
    rng = np.random.default_rng(0)
    js, ps = jax_schedule(), make_ddpm_schedule()
    x0, noise, out = (rng.standard_normal((5, 4, 4, 3), dtype=np.float32) for _ in range(3))
    ts = np.array([0, 19, 500, 981, 999])
    tt = np.array([19, 499, 999, 999, 999])
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=1e-6, atol=1e-6)
    J = jnp.asarray
    close(ps.add_noise(t(x0), t(noise), t(ts)), js.add_noise(J(x0), J(noise), J(ts)))
    close(ps.velocity(t(x0), t(noise), t(ts)), js.velocity(J(x0), J(noise), J(ts)))
    close(ps.noise_travel(t(x0), t(noise), t(ts), t(tt)),
          js.noise_travel(J(x0), J(noise), J(ts), J(tt)))
    for pt in ("epsilon", "v_prediction"):
        close(ps.predicted_origin(t(out), t(ts), t(x0), pt),
              js.predicted_origin(J(out), J(ts), J(x0), pt))

    for steps, phases in ((50, 4), (10, 2), (100, 1), (40, 4)):
        np.testing.assert_array_equal(solver.solver_grid(1000, steps),
                                      jsolver.solver_grid(1000, steps))
        np.testing.assert_array_equal(solver.phase_boundaries(steps, phases),
                                      jsolver.phase_boundaries(steps, phases))
        jsol = jsolver.PhasedDDIMSolver.create(js, steps)
        psol = solver.PhasedDDIMSolver.create(ps, steps)
        np.testing.assert_array_equal(psol.timesteps, np.asarray(jsol.timesteps))
        np.testing.assert_array_equal(psol.timesteps_prev, np.asarray(jsol.timesteps_prev))
        close(psol.alpha_cumprods_prev, jsol.alpha_cumprods_prev)
        idx = np.arange(steps)
        bounds = solver.phase_boundaries(steps, phases)
        np.testing.assert_array_equal(
            solver.last_boundary_at_or_below(t(idx), t(bounds)),
            jsolver.last_boundary_at_or_below(J(idx), J(bounds)))
        for a, b in zip(solver.boundary_scalings(t(idx), t(bounds), 4),
                        jsolver.boundary_scalings(J(idx), J(bounds), 4)):
            close(a, b)
        xs, ns = (rng.standard_normal((steps, 2, 2, 1), dtype=np.float32) for _ in range(2))
        close(psol.ddim_step(t(xs), t(ns), t(idx)), jsol.ddim_step(J(xs), J(ns), J(idx)))
        (px, pt_), (jx, jt) = (psol.multiphase_pred(t(xs), t(ns), t(idx), phases),
                               jsol.multiphase_pred(J(xs), J(ns), J(idx), phases))
        close(px, jx)
        np.testing.assert_array_equal(pt_, np.asarray(jt))

    p, q = (rng.standard_normal((3, 8, 8, 4), dtype=np.float32) for _ in range(2))
    w = np.array([4.0, 4.5, 7.5], np.float32)
    close(losses.huber_loss(t(p), t(q), 0.001), jlosses.huber_loss(J(p), J(q), 0.001))
    close(losses.l2_loss(t(p), t(q)), jlosses.l2_loss(J(p), J(q)))
    close(losses.consistency_loss(t(p), t(q), "huber", 0.01),
          jlosses.consistency_loss(J(p), J(q), "huber", 0.01))
    close(losses.cfg_combine(t(p), t(q), t(w)), jlosses.cfg_combine(J(p), J(q), J(w)))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_params(rng):
    # leaves of several sizes: one under a block, one over two blocks
    return {"a": rng.standard_normal((37, 5), dtype=np.float32),
            "b": rng.standard_normal((3000,), dtype=np.float32) * 0.1,
            "c": rng.standard_normal((4, 8, 3, 3), dtype=np.float32)}


def _lora_params(rng, pairs=150, rank=4):
    """300 LoRA-shaped leaves, ``(r, in)`` and ``(out, r)``, of widths 320
    and 250 (a leaf a multiple of 64 elements, or not), the first a 3x3
    conv's factor ``(r, in, 3, 3)``."""
    params = {}
    for i in range(pairs):
        width = 320 if i % 2 else 250
        a = (rank, 32, 3, 3) if i == 0 else (rank, width)
        params[f"m{i:03d}.lora_a"] = rng.standard_normal(a, dtype=np.float32) * 0.1
        params[f"m{i:03d}.lora_b"] = rng.standard_normal((width, rank), dtype=np.float32) * 0.1
    return params


def _torch_grads(grads):
    """The grads as torch tensors; of a conv factor channels-last, and of
    the second ``(r, in)`` leaf a transposed view, as autograd may give them."""
    out = {k: t(g) for k, g in grads.items()}
    a = [k for k, g in grads.items() if k.endswith("lora_a")]
    if len(a) > 1:
        out[a[0]] = out[a[0]].contiguous(memory_format=torch.channels_last)
        out[a[1]] = torch.from_numpy(np.ascontiguousarray(grads[a[1]].T)).T
        assert not out[a[0]].is_contiguous() and not out[a[1]].is_contiguous()
    return out


def _adam_state(node):
    """The (count, mu, nu) node of an optax chain state."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    for child in node if isinstance(node, tuple) else ():
        found = _adam_state(child)
        if found is not None:
            return found
    return None


OPT_KW = {"constant": dict(), "warmup_decay": dict(warmup_steps=2, weight_decay=0.01),
          "cosine": dict(warmup_steps=1, schedule="cosine", total_steps=6)}


@pytest.mark.parametrize("kw,use_8bit,leaves", [
    pytest.param(kw, use_8bit, _opt_params, id=f"{name}-adamw{'8bit' * use_8bit}")
    for name, kw in OPT_KW.items() for use_8bit in (False, True)] + [
    pytest.param(kw, False, _lora_params, id=f"{name}-lora300-adamw")
    for name, kw in OPT_KW.items()])
def test_optimizer_matches_optax(use_8bit, kw, leaves):
    """Five updates on the same gradients, clipping active on some of them:
    params to 1e-6, and the 8-bit moments' int8 codes equal in >= 99.9 %.
    Three leaves of odd sizes, or 300 LoRA factors with a channels-last and
    a transposed grad among them (fp32 moments: over 300 leaves a rare
    flipped 8-bit code moves an entry by up to 0.2 lr against optax's, with
    the moments leaf by leaf as before the flat vector too)."""
    rng = np.random.default_rng(1)
    params = leaves(rng)
    jtx = jax_make_optimizer(1e-2, use_8bit=use_8bit, **kw)
    ptx = make_optimizer(1e-2, use_8bit=use_8bit, **kw)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    pstate = TrainState.create({k: t(v) for k, v in params.items()}, ptx)
    for i in range(5):
        scale = 3.0 if i % 2 else 0.01  # global norm above / below max_grad_norm = 1
        if leaves is _lora_params:
            scale /= 20  # as many leaves: the same norms
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32) * scale
                 for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = {k: jparams[k] + upd[k] for k in jparams}
        pstate = apply_updates(pstate, _torch_grads(grads), ptx)
    assert pstate.step == 5 and pstate.opt_state["count"] == 5
    for k in params:
        ours, ref = pstate.params[k].numpy(), np.asarray(jparams[k])
        if use_8bit:
            # log2/exp2 of XLA and of torch differ in the last bit, which
            # rounds a rare ν code (<= 0.1 %) to its neighbour; the entries
            # updated from such a code differ by a fraction of one update (lr)
            close = np.isclose(ours, ref, rtol=1e-6, atol=1e-6)
            assert close.mean() >= 0.999 and np.abs(ours - ref).max() < 1e-3, k
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    adam = _adam_state(jstate)
    for moment in ("mu", "nu"):
        for k in params:
            ours, ref = pstate.opt_state[moment][k], getattr(adam, moment)[k]
            if use_8bit:
                codes, ref_codes = ours[0].numpy(), np.asarray(ref.values)
                assert codes.shape == ref_codes.shape and codes.size % BLOCK == 0
                assert np.mean(codes == ref_codes) >= 0.999, (moment, k)
            else:
                np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-9)


def test_clip_scales_only_above_max_norm():
    tx = make_optimizer(1.0)
    small = {"a": torch.full((4,), 0.1)}
    assert torch.equal(tx.clip(small)["a"], small["a"])  # no 1e-6 epsilon below the bound
    big = {"a": torch.full((4,), 2.0)}  # norm 4
    np.testing.assert_allclose(tx.clip(big)["a"].numpy(), np.full(4, 0.5), rtol=1e-7)


def test_warmup_first_update_uses_zero_lr():
    tx = make_optimizer(1e-3, warmup_steps=3)
    state = TrainState.create({"a": torch.ones(3)}, tx)
    state = apply_updates(state, {"a": torch.ones(3)}, tx)
    assert torch.equal(state.params["a"], torch.ones(3))
    state = apply_updates(state, {"a": torch.ones(3)}, tx)
    assert not torch.equal(state.params["a"], torch.ones(3))


def _per_leaf(tx, grads, state):
    """AdamW leaf by leaf, as optax's formulas (no clip): the new params and
    moments."""
    count = state.opt_state["count"] + 1
    c1, c2 = bias_corrections(tx.b1, tx.b2, count)
    if tx.use_8bit:
        steps, mu, nu = adam8bit_moments(grads, state.opt_state["mu"], state.opt_state["nu"],
                                         c1, c2, tx.b1, tx.b2, tx.eps)
    else:
        steps, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - tx.b1) * g + tx.b1 * state.opt_state["mu"][k]
            nu[k] = (1 - tx.b2) * (g * g) + tx.b2 * state.opt_state["nu"][k]
            steps[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + tx.eps)
    lr = -tx.lr(state.opt_state["count"])
    params = {k: p + (steps[k] + tx.weight_decay * p) * lr for k, p in state.params.items()}
    return params, mu, nu


@pytest.mark.parametrize("use_8bit", [False, True], ids=["adamw", "adamw8bit"])
def test_update_is_functional_and_keeps_the_layout(use_8bit):
    """Two updates over 300 LoRA leaves (a channels-last and a transposed
    grad among them), from a state of separate tensors, then from the views
    the first returned: the grads and the old state are left as they were;
    params, mu and nu keep their keys in order and each leaf its shape, in
    fp32; each leaf equals AdamW's formulas leaf by leaf bit for bit (the
    clip not acting), and ``grad_norm`` is the grads' global norm."""
    rng = np.random.default_rng(3)
    params = {k: t(v) for k, v in _lora_params(rng).items()}
    tx = make_optimizer(1e-2, weight_decay=0.01, use_8bit=use_8bit)
    state = TrainState.create(params, tx)
    for _ in range(2):
        grads = _torch_grads({k: rng.standard_normal(v.shape, dtype=np.float32) * 1e-3
                              for k, v in params.items()})
        before = copy.deepcopy((grads, state.params, state.opt_state))
        new = apply_updates(state, grads, tx)
        torch.testing.assert_close((grads, state.params, state.opt_state), before,
                                   rtol=0, atol=0)
        norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())))
        assert 0.1 < norm < tx.max_grad_norm
        assert abs(float(new.grad_norm) - norm) <= 1e-6 * norm
        assert new.step == state.step + 1 and new.opt_state["count"] == state.opt_state["count"] + 1
        want, want_mu, want_nu = _per_leaf(tx, grads, state)
        trees = [new.params] if use_8bit else [new.params, new.opt_state["mu"], new.opt_state["nu"]]
        for tree in trees:
            assert list(tree) == list(params)
            for k, p in params.items():
                assert tree[k].shape == p.shape and tree[k].dtype == torch.float32, k
        for k in params:
            assert torch.equal(new.params[k], want[k]), k
            for got, ref in ((new.opt_state["mu"][k], want_mu[k]),
                             (new.opt_state["nu"][k], want_nu[k])):
                for a, b in zip(got if use_8bit else (got,), ref if use_8bit else (ref,)):
                    assert torch.equal(a, b), k
        state = new


@pytest.mark.parametrize("use_8bit", [False, True], ids=["adamw", "adamw8bit"])
def test_update_launches_the_same_ops_at_any_leaf_count(use_8bit):
    """The aten ops of one `apply_updates` (clip acting, weight decay on),
    views left out (they launch nothing): the same count at 3 leaves and at
    300, at most 40 with fp32 moments (the 8-bit moments stay per leaf, so
    there only the clip and the update are held to the flat vector's count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops[func.__name__] += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for n in (3, 300):
        rng = np.random.default_rng(n)
        params = {f"m{i:03d}": t(rng.standard_normal((4, 320 if i % 2 else 250),
                                                     dtype=np.float32)) for i in range(n)}
        tx = make_optimizer(1e-2, weight_decay=0.01, use_8bit=use_8bit)
        state = TrainState.create(params, tx)
        grads = {k: 10 * t(rng.standard_normal(v.shape, dtype=np.float32))
                 for k, v in params.items()}
        with Ops() as ops:
            apply_updates(state, grads, tx)
        if use_8bit:  # less the moments' per-leaf ops
            with Ops() as moments:
                adam8bit_moments(grads, state.opt_state["mu"], state.opt_state["nu"],
                                 *bias_corrections(tx.b1, tx.b2, 1), tx.b1, tx.b2, tx.eps)
            ops.ops.subtract(moments.ops)
        counts[n] = sum(ops.ops.values())
    assert counts[3] == counts[300], counts
    assert use_8bit or counts[300] <= 40, counts


# ---------------------------------------------------------------------------
# recipes and the cached-latents reader
# ---------------------------------------------------------------------------


def test_recipes_match_jax_field_for_field():
    assert list(RECIPES) == list(JAX_RECIPES)
    for name, r in RECIPES.items():
        ours, ref = dataclasses.asdict(r), dataclasses.asdict(JAX_RECIPES[name])
        assert ours == ref, name


def test_cached_reader_matches_jax(tmp_path):
    from pcm_tpu.data.dataset import CachedLatentsDataset as JDataset
    from pcm_tpu.data.dataset import cached_collate as jcollate
    from pcm_tpu_torch.data.cached import CachedLatentsDataset, batches, cached_collate

    rng = np.random.default_rng(2)
    for si, n in enumerate((3, 2, 4)):
        np.savez(tmp_path / f"shard_{si:05d}.npz",
                 latents=rng.standard_normal((n, 4, 4, 4)).astype(np.float16),
                 prompt_embeds=rng.standard_normal((n, 7, 8)).astype(np.float32))
    ours, ref = CachedLatentsDataset(str(tmp_path)), JDataset(str(tmp_path))
    assert len(ours) == len(ref) == 9
    for i in range(9):
        a, b = ours.get(i), ref.get(i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = cached_collate([ours.get(i) for i in (8, 0, 4)])
    want = jcollate([ref.get(i) for i in (8, 0, 4)])
    assert got["latents"].dtype == np.float32  # fp16 promoted, as scripts/train.py does
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
    it = batches(ours, 4, seed=3)
    assert [next(it)["latents"].shape for _ in range(3)] == [(4, 4, 4, 4)] * 3


# ---------------------------------------------------------------------------
# one distillation step
# ---------------------------------------------------------------------------

LORA_RANK = 4
# TINY_UNET_CONFIG with 8 GroupNorm groups: with its 32 groups of one channel
# each, the norm after the time embedding removes its per-channel shift, so
# the time_emb_proj LoRA has an exactly zero gradient, made of round-off the
# two packages cannot match.
GROUPS = 8
LR, EPS = 1e-3, 1e-2  # eps raised from 1e-8: see test_distill_step_matches_jax


@pytest.fixture(scope="module")
def tiny_models():
    """Both bundles on the same numpy-drawn UNet, and a cache of jitted JAX
    microbatch gradient functions (one XLA compile per CFG branch)."""
    spec = JLoRASpec(rank=LORA_RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    junet = dataclasses.replace(J_TINY_UNET, norm_groups=GROUPS)
    v = random_params(JUNet(junet, lora=spec).init, jnp.zeros((1, 8, 8, 4)),
                      jnp.zeros((1,)), jnp.zeros((1, 7, 32)), seed=11)
    text_cfg = JCLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    jbundle = JSD15Bundle(junet, J_TINY_VAE, text_cfg, spec, dtype=jnp.float32)
    jfrozen = {"unet": v["params"]}
    tiny = sd15_bundle(LORA_RANK, dtype=torch.float32, tiny=True)
    pbundle = dataclasses.replace(
        tiny, unet_cfg=dataclasses.replace(tiny.unet_cfg, norm_groups=GROUPS))
    frozen, _ = pbundle.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    frozen["unet"].load_state_dict(convert.unet_state_from_jax(v["params"]))

    jsched = jax_schedule()
    jsol = jsolver.PhasedDDIMSolver.create(jsched, 10)
    bounds = jnp.asarray(jsolver.phase_boundaries(10, 2))
    grad_fns = {}

    def jgrad(cfg):
        """The body of `build_ddim_distill_step`'s grad_fn, returning the
        prepared draws and target beside (loss, grads)."""
        if cfg not in grad_fns:
            def fn(lora, mb, key):
                parts = jdistill.ddim_prepare(jbundle, jsched, jsol, bounds, cfg, jfrozen, lora,
                                              mb, key)

                def loss_fn(lora_):
                    pred = jdistill.ddim_model_pred(jbundle, jsched, jsol, cfg, jfrozen, lora_,
                                                    parts)
                    return jlosses.consistency_loss(pred, parts["target"], cfg.loss_type,
                                                    cfg.huber_c)

                draws = {k: parts[k] for k in ("noise", "index", "w")}
                return parts["target"], draws, jax.value_and_grad(loss_fn)(lora)

            grad_fns[cfg] = jax.jit(fn)
        return grad_fns[cfg]

    return dict(jbundle=jbundle, jfrozen=jfrozen, jlora=v["lora"], jgrad=jgrad,
                pbundle=pbundle, pfrozen=frozen)


def _batch(bsz, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((bsz, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((bsz, 7, 32), dtype=np.float32),
            "uncond_embeds": rng.standard_normal((bsz, 7, 32), dtype=np.float32) * 0.1}


@pytest.mark.parametrize("not_cfg,accum,use_8bit", [(False, 1, False), (True, 1, True),
                                                    (False, 2, False)],
                         ids=["cfg_adamw", "nocfg_adamw8bit", "cfg_accum2"])
def test_distill_step_matches_jax(tiny_models, not_cfg, accum, use_8bit):
    """One step of `build_ddim_distill_step` on both sides, with the draws of
    JAX's `ddim_prepare` fed to the port (its grad_fn per interleaved
    microbatch, with the keys of `accumulate_grads`). Without accumulation
    the JAX step's tail (`_grad_norm`, `_apply_updates`) runs on that
    grad_fn's output, whose raw grads the port is also held to; with it, the
    jitted `build_ddim_distill_step` itself runs. Adam's eps is 1e-2 here: its first step lr * g / (|g| + eps) would
    otherwise turn round-off of grads near the default eps of 1e-8 into up
    to lr; with it, the params' error is at most lr / eps times the grads'
    (1e-3 of the largest grad, ~5e-2), hence 1e-5."""
    m = tiny_models
    cfg_kw = dict(num_solver_steps=10, multiphase=2, w_min=4.0, w_max=5.0,
                  not_apply_cfg_solver=not_cfg)
    jcfg, pcfg = jdistill.DistillConfig(**cfg_kw), distill.DistillConfig(**cfg_kw)
    batch = _batch(2 * accum, 12)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(5), 0)  # the step folds in state.step = 0
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    jtx = jax_make_optimizer(LR, eps=EPS, use_8bit=use_8bit)
    jstate = JTrainState.create(m["jlora"], jtx)

    micro = [m["jgrad"](jcfg)(m["jlora"], {k: v[a::accum] for k, v in jbatch.items()}, keys[a])
             for a in range(accum)]
    if accum == 1:  # the step's tail on the grad_fn's output: one small XLA program
        @jax.jit
        def finish(state, out):
            loss, grads = out
            return loss, grads, jdistill._grad_norm(grads), jdistill._apply_updates(state,
                                                                                   grads, jtx)

        jloss, jgrads, jgrad_norm, jstate2 = finish(jstate, micro[0][2])
    else:  # the jitted JAX step itself: its draws are the grad_fn's under the split keys
        jstate2, rm = jax.jit(jdistill.build_ddim_distill_step(
            m["jbundle"], jax_schedule(), jcfg, jtx, grad_accum_steps=accum))(
            jstate, m["jfrozen"], jbatch, jax.random.PRNGKey(5))
        jloss, jgrad_norm = rm["loss"], rm["grad_norm"]

    # the port, on the same draws
    tbatch = {k: t(v) for k, v in batch.items()}
    tdraws = [{k: t(v) for k, v in o[1].items()} for o in micro]
    psched = make_ddpm_schedule()
    psol = solver.PhasedDDIMSolver.create(psched, 10)
    ptx = make_optimizer(LR, eps=EPS, use_8bit=use_8bit)
    if use_8bit:  # the 8-bit moments start from the port's own (zero) init
        params = convert.lora_state_from_jax(m["jlora"])
        pstate = TrainState(0, params, ptx.init(params))
    else:
        pstate = convert.train_state_from_jax(jstate)
    parts = distill.ddim_prepare(m["pbundle"], psched, psol, t(solver.phase_boundaries(10, 2)),
                                 pcfg, m["pfrozen"], pstate.params,
                                 {k: v[::accum] for k, v in tbatch.items()}, tdraws[0])
    assert rel_max(parts["target"], micro[0][0]) < 1e-4
    step = distill.build_ddim_distill_step(m["pbundle"], psched, pcfg, ptx,
                                           grad_accum_steps=accum)
    pstate2, pm = step(pstate, m["pfrozen"], tbatch, tdraws)

    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jgrad_norm), rtol=1e-3)
    if accum == 1:  # the raw grads, recomputed on the port's side through the same pieces
        lora = {k: p.detach().requires_grad_(True) for k, p in pstate.params.items()}
        pred = distill.ddim_model_pred(m["pbundle"], psched, psol, pcfg, m["pfrozen"], lora,
                                       parts)
        grads = torch.autograd.grad(losses.consistency_loss(pred, parts["target"]),
                                    list(lora.values()))
        ref = convert.lora_state_from_jax(jgrads)
        for k, g in zip(lora, grads):
            assert rel_max(g, ref[k]) < 1e-3, k
    assert pstate2.step == 1
    ref_params = convert.lora_state_from_jax(jstate2.params)
    for k, p in pstate2.params.items():
        np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)
    moved = max(float((pstate2.params[k] - pstate.params[k]).abs().max()) for k in ref_params)
    assert moved > 1e-6


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _write_cache(path, n=4):
    rng = np.random.default_rng(4)
    path.mkdir()
    np.savez(path / "shard_00000.npz",
             latents=rng.standard_normal((n, 8, 8, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((n, 77, 32)).astype(np.float16))


def _train(*argv):
    from pcm_tpu_torch.train.__main__ import main

    return main(list(argv))


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    cache, out = tmp_path / "cache", tmp_path / "run"
    _write_cache(cache)
    common = ["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--cached-latents-dir",
              str(cache), "--output-dir", str(out), "--batch-size", "2", "--log-every", "1"]
    trainer = _train(*common, "--max-train-steps", "2")
    assert trainer.global_step == 2 and trainer.resumed_from is None
    assert (out / "checkpoints" / "step_0000002.pt").exists()
    capsys.readouterr()
    trainer = _train(*common, "--max-train-steps", "3")
    printed = capsys.readouterr().out
    assert trainer.resumed_from == 2 and "resumed at step 2" in printed
    assert "step 3:" in printed and "step 1:" not in printed
    ck = torch.load(out / "checkpoints" / "step_0000003.pt", weights_only=True)
    assert ck["step"] == 3 and ck["opt_state"]["count"] == 3
    assert max(float(v.abs().max()) for k, v in ck["lora"].items() if k.endswith("lora_b")) > 0
    with pytest.raises(ValueError, match="does not match"):  # another optimizer's state
        _train(*common, "--max-train-steps", "4", "--use-8bit-adam")


@pytest.mark.parametrize("recipe,cache", [("sd15_2phase_adv", "sd15"), ("sd3_2phase_adv", "sd3")],
                         ids=["adversarial", "sd3"])
def test_train_cli_int8_every_recipe(tmp_path, capsys, recipe, cache):
    """int8 frozen weights with an adversarial recipe and with an SD3 recipe
    (both refused before), the frozen weights quantized before the heads
    are drawn: two global steps of the fused pair under ``--int8-matmul
    fused``, finite losses, a moving LoRA."""
    rng = np.random.default_rng(12)
    (tmp_path / "cache").mkdir()
    seq, width = (154, 32) if cache == "sd3" else (77, 32)
    arrays = {"latents": rng.standard_normal((4, 8, 8, 4)).astype(np.float16),
              "prompt_embeds": rng.standard_normal((4, seq, width)).astype(np.float16)}
    if cache == "sd3":
        arrays["pooled_embeds"] = rng.standard_normal((4, 32)).astype(np.float16)
    np.savez(tmp_path / "cache" / "shard_00000.npz", **arrays)
    trainer = _train("--recipe", recipe, "--tiny", "--device", "cpu", "--output-dir",
                     str(tmp_path / "o"),
                     "--cached-latents-dir", str(tmp_path / "cache"), "--batch-size", "2",
                     "--max-train-steps", "2", "--log-every", "1", "--adv-pairing", "fused",
                     "--frozen-weights", "int8", "--int8-matmul", "fused")
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and "step 2:" in printed and "nan" not in printed
    assert max(float(v.abs().max()) for k, v in trainer.state.params.items()
               if k.endswith("lora_b")) > 0


@pytest.mark.parametrize("extra,msg", [
    # Prodigy is ported; it takes no schedule (`pcm_tpu/train/state.py:50-58`)
    (["--recipe", "sd15_4phase", "--optimizer", "prodigy", "--lr-warmup-steps", "10"],
     "takes no learning-rate schedule"),
    # int8 products are ported; they need int8 weights (scripts/train.py:199-203)
    (["--recipe", "sd15_4phase", "--int8-matmul", "dense"], "requires --frozen-weights int8")],
    ids=["prodigy", "int8_matmul"])
def test_train_cli_refuses_unported(tmp_path, capsys, extra, msg):
    with pytest.raises(SystemExit) as exc:
        _train(*extra, "--tiny", "--device", "cpu", "--output-dir", str(tmp_path / "o"),
               "--cached-latents-dir", str(tmp_path))
    assert exc.value.code != 0
    assert msg in capsys.readouterr().err


def test_train_entry_point_runs_without_jax(tmp_path):
    """``python -m pcm_tpu_torch.train`` as a program, with jax made
    unimportable: one tiny step on the CPU, a checkpoint, no `pcm_tpu` module."""
    cache = tmp_path / "cache"
    _write_cache(cache)
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['pcm_tpu_torch.train'] + sys.argv[1:]\n"
            "runpy.run_module('pcm_tpu_torch.train', run_name='__main__', alter_sys=True)\n"
            "bad = [k for k in sys.modules if k.startswith('pcm_tpu.')]\n"
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code, "--recipe", "sd15_4phase", "--tiny",
                          "--device", "cpu", "--cached-latents-dir", str(cache), "--output-dir",
                          str(tmp_path / "run"), "--batch-size", "2", "--max-train-steps", "1"],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp_path / "run" / "checkpoints" / "step_0000001.pt").exists()
