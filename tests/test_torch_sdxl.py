"""The port's SDXL family against `pcm_tpu` (fp32, CPU, TINY sizes): the
UNet with its addition embedding and linear projections, the cached-latents
bundle, and one distillation step on int8 frozen weights through K6's plain
version (the JAX side runs the Pallas kernel in interpret mode).

Inputs and weights are drawn with numpy and cross through
`pcm_tpu_torch.models.convert`. Bounds: the UNet on float weights rel-max
5e-4 (as tests/test_torch_models.py). On int8 weights under ``fused`` an
fp32 round-off between the packages flips an activation code now and then,
and the flip moves later activations by more than round-off, so whole
passes agree to the int8 noise only: each K6 call is held to JAX alone
(1e-6), the UNet output at 5e-2. One TINY step under ``fused``: loss rtol
1e-4, grad norm rtol 2e-3, the updated LoRA atol 5e-5 (Adam's eps is 1e-2,
as tests/test_torch_train.py explains: a param moves by at most a tenth of
its grad's error).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs.families import sdxl_bundle as jax_sdxl_bundle
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import solver as jsolver
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.unet import SDXL_CONFIG as J_SDXL
from pcm_tpu.models.unet import TINY_SDXL_CONFIG as J_TINY_SDXL
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu.utils import quant as jquant
from pcm_tpu_torch.configs.families import sdxl_bundle
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.lora.layers import LoRASpec, attach_lora, lora_shapes
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.unet import SDXL_CONFIG, TINY_SDXL_CONFIG, UNet2DCondition
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.state import make_optimizer
from pcm_tpu_torch.utils import quant
from torch_port_helpers import random_params, rel_max

RANK = 4
GROUPS = 8  # see tests/test_torch_train.py: 32 one-channel groups zero a LoRA grad


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def _time_ids(n):
    """(orig h, orig w, crop top, crop left, target h, target w) per sample."""
    return np.tile(np.array([1024, 1024, 0, 0, 1024, 1024], np.float32), (n, 1))


@pytest.fixture(scope="module")
def tiny():
    spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    cfg = dataclasses.replace(J_TINY_SDXL, norm_groups=GROUPS)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    v = random_params(JUNet(cfg, lora=spec).init, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                      jnp.zeros((1, 7, 32)), added, seed=21)
    pcfg = dataclasses.replace(TINY_SDXL_CONFIG, norm_groups=GROUPS)
    return dict(spec=spec, cfg=cfg, pcfg=pcfg, params=v["params"], lora=v["lora"])


def _port_unet(m):
    port = UNet2DCondition(m["pcfg"])
    port.load_state_dict(convert.unet_state_from_jax(m["params"]))
    attach_lora(port, LoRASpec(RANK, 8.0, SD_UNET_LORA_TARGETS))
    return port.eval().requires_grad_(False)


def _unet_inputs():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ts = np.array([999.0, 261.0], np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    added = {"text_embeds": rng.standard_normal((2, 32), dtype=np.float32),
             "time_ids": _time_ids(2)}
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
             {k: jnp.asarray(a) for k, a in added.items()})
    targs = (t(x).permute(0, 3, 1, 2), t(ts), t(ctx))
    return jargs, targs, {k: t(a) for k, a in added.items()}


def test_tiny_sdxl_unet_matches_flax(tiny):
    """Student (adapter) and teacher passes of TINY_SDXL on float weights,
    with the addition embedding over (text_embeds, sinusoid(time_ids)) and
    linear projections."""
    m = tiny
    jargs, targs, tadded = _unet_inputs()
    ref_s = jax.jit(JUNet(m["cfg"], lora=m["spec"]).apply)(
        {"params": m["params"], "lora": m["lora"]}, *jargs)
    ref_t = jax.jit(JUNet(m["cfg"]).apply)({"params": m["params"]}, *jargs)
    port = _port_unet(m)
    with torch.no_grad():
        out_s = port(*targs, convert.lora_state_from_jax(m["lora"]), tadded)
        out_t = port(*targs, None, tadded)
    assert rel_max(out_s.permute(0, 2, 3, 1), ref_s) < 5e-4
    assert rel_max(out_t.permute(0, 2, 3, 1), ref_t) < 5e-4


def test_tiny_sdxl_unet_int8_fused_matches_flax(tiny, monkeypatch):
    """Student pass of TINY_SDXL on int8 weights (every kernel quantized,
    min_size 0 on both sides) under ``fused``. An fp32 round-off between the
    packages (~1e-7) flips an activation code now and then, and the flip's
    step of amax/127 flips more codes downstream: whole outputs agree only
    to the int8 noise (bound 5e-2; int8 against float weights is ~2e-2). So
    each K6 call is held to JAX one by one: the same layers take K6 in the
    same order with the same (M, K, N), and each call's output equals
    `fused_quantized_dot` (interpret mode) on the port's input to 1e-6."""
    from pcm_tpu.ops import int8_matmul as jax_k6
    from pcm_tpu_torch.ops import int8_matmul as port_k6

    m = tiny
    jargs, targs, tadded = _unet_inputs()
    params = jquant.quantize_tree(m["params"], min_size=0)
    jcalls, pcalls = [], []
    jfused = jax_k6.fused_quantized_dot

    def jrecord(x, values, scale, **kw):
        jcalls.append((int(np.prod(x.shape[:-1])),) + tuple(values.shape))
        return jfused(x, values, scale, **kw)

    def precord(x, values, scale):
        out = port_k6_reference(x, values, scale)
        pcalls.append((x.detach().reshape(-1, x.shape[-1]).clone(), values, scale, out))
        return out

    port_k6_reference = port_k6.fused_quantized_dot_reference
    monkeypatch.setattr(jax_k6, "fused_quantized_dot", jrecord)
    monkeypatch.setattr(port_k6, "fused_quantized_dot_reference", precord)
    with jquant.int8_matmul(which="fused"):
        ref = jax.jit(JUNet(m["cfg"], lora=m["spec"]).apply)(
            {"params": params, "lora": m["lora"]}, *jargs)
    port = _port_unet(m)
    quant.quantize_frozen({"unet": port}, min_size=0)
    with torch.no_grad(), quant.int8_matmul("fused"):
        out = port(*targs, convert.lora_state_from_jax(m["lora"]), tadded).permute(0, 2, 3, 1)
    monkeypatch.undo()

    assert [(x.shape[0], x.shape[1], v.shape[0]) for x, v, _, _ in pcalls] == jcalls
    assert len(jcalls) >= 20 and (2, 224, 128) in jcalls  # add_embedding at M = batch
    for x, values, scale, got in pcalls:
        want = jax_k6.fused_quantized_dot(jnp.asarray(x.numpy()), jnp.asarray(values.numpy().T),
                                          jnp.asarray(scale.numpy().reshape(1, -1)),
                                          out_dtype=jnp.float32)
        assert rel_max(got.reshape(want.shape), want) <= 1e-6
    assert rel_max(out, ref) < 5e-2


def test_sdxl_unet_needs_added_cond(tiny):
    port = _port_unet(tiny)
    with pytest.raises(ValueError, match="added_cond"):
        port(torch.zeros(1, 4, 16, 16), torch.zeros(1), torch.zeros(1, 7, 32))


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((n, 7, 32), dtype=np.float32),
            "pooled_embeds": rng.standard_normal((n, 32), dtype=np.float32),
            "time_ids": _time_ids(n)}


def test_sdxl_encode_matches_jax(tiny):
    """The cached path: cond from the shard's keys, uncond zero embeds and
    zero pooled embeds with the same time_ids; `_merge_cond` batches the
    nested ``added_cond``; a batch without embeddings needs caption ids."""
    jb = jax_sdxl_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True)
    pb = sdxl_bundle(RANK, dtype=torch.float32, tiny=True)
    batch = _batch(3, 23)
    jl, jc, ju = jb.encode({}, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    pl, pc, pu = pb.encode({}, {k: t(v) for k, v in batch.items()})
    for ours, ref in ((pl, jl), (pc, jc), (pu, ju)):
        flat, jflat = jax.tree.leaves(jax.tree.map(np.asarray, ref)), []
        jax.tree.map(lambda a: jflat.append(a.numpy()), ours)
        assert len(flat) == len(jflat)
        for a, b in zip(jflat, flat):
            np.testing.assert_array_equal(a, b)
    merged = distill._merge_cond(pc, pu)
    ref = jdistill._merge_cond(jc, ju)
    np.testing.assert_array_equal(merged["added_cond"]["text_embeds"].numpy(),
                                  np.asarray(ref["added_cond"]["text_embeds"]))
    assert merged["added_cond"]["time_ids"].shape == (6, 6)
    with pytest.raises(KeyError, match="input_ids"):  # neither embeddings nor caption ids
        pb.encode({}, {"latents": t(batch["latents"]), "time_ids": t(batch["time_ids"])})


def test_cached_reader_reads_sdxl_keys(tmp_path):
    """``pooled_embeds`` and ``time_ids``, as `scripts/cache_latents.py`
    writes them for SDXL, come out of the port's reader as from JAX's."""
    from pcm_tpu.data.dataset import CachedLatentsDataset as JDataset
    from pcm_tpu_torch.data.cached import CachedLatentsDataset, batches

    rng = np.random.default_rng(24)
    for si in range(2):
        np.savez(tmp_path / f"shard_{si:05d}.npz",
                 latents=rng.standard_normal((3, 8, 8, 4)).astype(np.float16),
                 prompt_embeds=rng.standard_normal((3, 77, 16)).astype(np.float16),
                 pooled_embeds=rng.standard_normal((3, 12)).astype(np.float16),
                 time_ids=_time_ids(3))
    ours, ref = CachedLatentsDataset(str(tmp_path)), JDataset(str(tmp_path))
    for i in range(6):
        a, b = ours.get(i), ref.get(i)
        assert set(a) == set(b) == {"latents", "prompt_embeds", "pooled_embeds", "time_ids"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = next(batches(ours, 4, seed=0))
    assert got["pooled_embeds"].dtype == np.float32 and got["time_ids"].shape == (4, 6)


def test_sdxl_distill_step_int8_fused_matches_jax(tiny):
    """One TINY_SDXL step on int8 frozen weights (every kernel quantized,
    min_size 0 on both sides) inside ``int8_matmul("fused")``, the JAX
    draws of `ddim_prepare` fed to the port: loss, grad norm, updated LoRA."""
    m = tiny
    lr, eps = 1e-3, 1e-2
    kw = dict(num_solver_steps=8, multiphase=2, w_min=6.0, w_max=7.0)
    jcfg, pcfg = jdistill.DistillConfig(**kw), distill.DistillConfig(**kw)
    jbundle = dataclasses.replace(jax_sdxl_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True),
                                  unet_cfg=m["cfg"])
    jfrozen = {"unet": jquant.quantize_tree(m["params"], min_size=0)}
    jsched = jax_schedule()
    jsol = jsolver.PhasedDDIMSolver.create(jsched, 8)
    bounds = jnp.asarray(jsolver.phase_boundaries(8, 2))
    jtx = jax_make_optimizer(lr, eps=eps)
    jstate = JTrainState.create(m["lora"], jtx)
    batch = _batch(2, 25)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0)

    def step(state, mb, key_):
        parts = jdistill.ddim_prepare(jbundle, jsched, jsol, bounds, jcfg, jfrozen, state.params,
                                      mb, key_)

        def loss_fn(lora_):
            pred = jdistill.ddim_model_pred(jbundle, jsched, jsol, jcfg, jfrozen, lora_, parts)
            return jlosses.consistency_loss(pred, parts["target"], jcfg.loss_type, jcfg.huber_c)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        draws = {k: parts[k] for k in ("noise", "index", "w")}
        return (loss, jdistill._grad_norm(grads), jdistill._apply_updates(state, grads, jtx),
                draws)

    with jquant.int8_matmul(which="fused"):
        jloss, jnorm, jstate2, jdraws = jax.jit(step)(jstate, jbatch, key)

    pbundle = dataclasses.replace(sdxl_bundle(RANK, dtype=torch.float32, tiny=True),
                                  unet_cfg=m["pcfg"])
    frozen = pbundle.from_states({"unet": convert.unet_state_from_jax(m["params"])},
                                 torch.device("cpu"))
    quant.quantize_frozen(frozen, min_size=0)
    pstate = convert.train_state_from_jax(jstate)
    ptx = make_optimizer(lr, eps=eps)
    pstep = distill.build_ddim_distill_step(pbundle, make_ddpm_schedule(), pcfg, ptx)
    draws = [{k: t(v) for k, v in jdraws.items()}]
    with quant.int8_matmul("fused"):
        pstate2, pm = pstep(pstate, frozen, {k: t(v) for k, v in batch.items()}, draws)

    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jnorm), rtol=2e-3)
    ref = convert.lora_state_from_jax(jstate2.params)
    for k, p in pstate2.params.items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), rtol=0, atol=5e-5)
    assert max(float((pstate2.params[k] - pstate.params[k]).abs().max()) for k in ref) > 1e-6


def test_full_width_sdxl_structure_matches_jax():
    """Every full-width SDXL UNet parameter (``add_embedding``, linear
    ``proj_in``/``proj_out``, ``transformer_blocks.0..9``): the converted
    `jax.eval_shape` tree gives the port's keys and shapes (meta device), and
    the same LoRA factors."""
    spec = JLoRASpec(rank=64, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    added = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, 6))}
    shapes = jax.eval_shape(JUNet(J_SDXL, lora=spec).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 2048)),
                            added)
    port = sdxl_bundle().build(torch.device("meta"))["unet"]
    ours = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert convert.state_shapes_from_jax(shapes["params"]) == ours
    assert convert.state_shapes_from_jax(shapes["lora"]) == lora_shapes(port, 64)
    assert "mid_block.attentions.0.transformer_blocks.9.ff.net.2.weight" in ours
    assert ours["down_blocks.1.attentions.0.proj_in.weight"] == (640, 640)
    assert ours["add_embedding.linear_1.weight"] == (1280, 2816)
    assert port.cfg == SDXL_CONFIG
