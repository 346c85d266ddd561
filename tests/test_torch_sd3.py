"""The port's SD3 slice against `pcm_tpu` (CPU, fp32, TINY sizes): the flow
schedule, the phased Euler solver and the PCM-FM samplers; the MMDiT (with
and without RMS q/k norm, LoRA acting), T5 and its position buckets, the
16-channel VAE's decoder; `SD3Bundle.encode_prompts`; the flow consistency
step; the pipeline, the engine and ``python -m pcm_tpu_torch.serving
--family sd3``; kohya files under ``lora_transformer``.

Weights are drawn with numpy over the JAX modules' shapes and cross through
`pcm_tpu_torch.models.convert`; the JAX side runs its plain ops
(`pcm_tpu.ops.common.reference_ops`). The MMDiT's latent grids give joint
sequences that are not multiples of 64 (36 + 14 and 16 + 14 tokens).
Bounds: schedule, solver and sigmas within 1 fp32 ulp; a sampler step 1e-6;
the MMDiT and the prompt encoding rel-max 1e-4, T5 1e-5 (its buckets equal
as integers); the flow step as `tests/test_torch_train.py` holds the DDIM
step (target 1e-4, loss 1e-5, LoRA grads 1e-3, params 1e-5 with Adam's eps
1e-2); the pipeline's images 1e-3; the engine's images per seed bit for bit.
"""

import base64
import dataclasses
import io
import os
import re
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core.schedule import make_flow_schedule as jax_make_flow_schedule
from pcm_tpu.core.solver import PhasedEulerSolver as JEulerSolver
from pcm_tpu.lora import kohya as jkohya
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models import mmdit as jmmdit
from pcm_tpu.models import t5 as jt5
from pcm_tpu.models.vae import SD3_VAE_CONFIG as J_SD3_VAE
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.models.vae import AutoencoderKL as JVAE
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.sampling import TextToImagePipeline as JPipeline
from pcm_tpu.sampling.pcm_fm import PCMFMSampler as JPCMFMSampler
from pcm_tpu.sampling.pcm_fm import pcm_fm_sigmas as jax_pcm_fm_sigmas
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core import losses
from pcm_tpu_torch.core.schedule import make_flow_schedule
from pcm_tpu_torch.core.solver import PhasedEulerSolver
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.lora import kohya
from pcm_tpu_torch.lora.layers import LoRASpec, attach_lora, lora_shapes
from pcm_tpu_torch.models import convert, mmdit, t5
from pcm_tpu_torch.models.vae import SD3_VAE_CONFIG, AutoencoderKL
from pcm_tpu_torch.sampling.pcm_fm import PCMFMSampler, pcm_fm_sigmas
from pcm_tpu_torch.sampling.pipeline import TextToImagePipeline
from pcm_tpu_torch.serving import EngineConfig, InferenceEngine
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.bundles import adapter_like
from pcm_tpu_torch.train.state import make_optimizer
from torch_port_helpers import random_params, rel_max

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = 4
ALPHA = 8.0
TOKS = ("input_ids", "input_ids_2", "input_ids_3")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def _ulp(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_array_max_ulp(ours.astype(np.float32), np.asarray(ref, np.float32), maxulp=1)


def _ids(prompts):
    return {k: HashTokenizer()(prompts) for k in TOKS}


# ---------------------------------------------------------------------------
# schedule, solver, samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_target", [False, True])
def test_flow_schedule_and_euler_solver_match_jax(is_target):
    js, ps = jax_make_flow_schedule(shift=3.0), make_flow_schedule(shift=3.0)
    _ulp(ps.sigmas, js.sigmas)
    jsol, psol = JEulerSolver.create(js, 100), PhasedEulerSolver.create(ps, 100)
    for name in ("timesteps", "timesteps_prev"):
        np.testing.assert_array_equal(getattr(psol, name), np.asarray(getattr(jsol, name)))
    for name in ("sigmas", "sigmas_prev"):
        _ulp(getattr(psol, name), getattr(jsol, name))
    rng = np.random.default_rng(0)
    x0, noise, v = (rng.standard_normal((5, 4, 4, 3), dtype=np.float32) for _ in range(3))
    index = np.array([0, 24, 25, 73, 99])
    J = jnp.asarray
    _ulp(ps.add_noise(t(x0), t(noise), t(psol.sigmas[index])),
         js.add_noise(J(x0), J(noise), jsol.sigmas[J(index)]))
    _ulp(psol.euler_step(t(x0), t(v), t(index)), jsol.euler_step(J(x0), J(v), J(index)))
    for phases in (1, 2, 4):
        ours, b = psol.multiphase_pred(t(x0), t(v), t(index), phases, is_target=is_target)
        ref, jb = jsol.multiphase_pred(J(x0), J(v), J(index), phases, is_target=is_target)
        _ulp(ours, ref)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("pcm_timesteps", [50, 100])
@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_pcm_fm_sigmas_match_jax(steps, pcm_timesteps):
    ours = pcm_fm_sigmas(make_flow_schedule(shift=3.0), pcm_timesteps, steps)
    ref = jax_pcm_fm_sigmas(jax_make_flow_schedule(shift=3.0), pcm_timesteps, steps)
    assert ours.shape == (steps + 1,) and ours[-1] == 0
    _ulp(ours, ref)
    sampler = PCMFMSampler.create(make_flow_schedule(shift=3.0), steps, pcm_timesteps)
    jsampler = JPCMFMSampler.create(jax_make_flow_schedule(shift=3.0), steps, pcm_timesteps)
    _ulp(np.array(sampler.timesteps), jsampler.timesteps)


def test_pcm_fm_grid_of_serving():
    """A 4-phase student trained on 100 solver steps meets its boundaries
    [1, 0.9, 0.75, 0.5] on the 100-point grid the SD3 server samples on; the
    sampler's default grid of 50 misses them."""
    sched = make_flow_schedule(shift=3.0)
    np.testing.assert_allclose(pcm_fm_sigmas(sched, 100, 4)[:4], [1.0, 0.9, 0.75, 0.5],
                               atol=1e-6)
    assert abs(pcm_fm_sigmas(sched, 50, 4)[1] - 0.9) > 1e-3


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_pcm_fm_step_matches_jax(stochastic):
    """Every step of a 4-step sampler on the 100-point grid; the stochastic
    step fed JAX's renoise (the normal draw of the step's key)."""
    ps = PCMFMSampler.create(make_flow_schedule(shift=3.0), 4, 100, stochastic)
    js = JPCMFMSampler.create(jax_make_flow_schedule(shift=3.0), 4, 100, stochastic)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 4), dtype=np.float32)
    for i in range(ps.num_steps):
        v = rng.standard_normal(x.shape, dtype=np.float32)
        key = jax.random.PRNGKey(i)
        ref = np.asarray(js.step(jnp.asarray(v), i, jnp.asarray(x), key))
        renoise = t(jax.random.normal(key, x.shape, jnp.float32)) if stochastic else None
        ours = ps.step(t(v), i, t(x), renoise)
        assert rel_max(ours, ref) <= 1e-6, i
        x = ref
    if stochastic:
        with pytest.raises(ValueError, match="renoise"):
            ps.step(t(v), 0, t(x))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _mmdit_inputs(hw=12, ctx=14):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, hw, hw, 4), dtype=np.float32)
    ts = np.array([999.0, 261.5], np.float32)
    c = rng.standard_normal((2, ctx, 32), dtype=np.float32)
    pooled = rng.standard_normal((2, 32), dtype=np.float32)
    return x, ts, c, pooled


@pytest.mark.parametrize("qk_norm", [None, "rms"])
def test_mmdit_matches_flax(qk_norm):
    """Student (LoRA with non-zero b on SD3_LORA_TARGETS) and teacher at
    12 x 12 latents: 36 image + 14 context tokens, a joint length of 50."""
    jcfg = dataclasses.replace(jmmdit.TINY_MMDIT_CONFIG, qk_norm=qk_norm)
    spec = JLoRASpec(rank=RANK, alpha=ALPHA, targets=jmmdit.SD3_LORA_TARGETS)
    x, ts, c, pooled = _mmdit_inputs()
    args = tuple(jnp.asarray(a) for a in (x, ts, c, pooled))
    with jax_reference_ops():
        v = random_params(jmmdit.MMDiT(jcfg, lora=spec).init, *args, seed=3)
        ref_s = jax.jit(jmmdit.MMDiT(jcfg, lora=spec).apply)(v, *args)
        ref_t = jax.jit(jmmdit.MMDiT(jcfg).apply)({"params": v["params"]}, *args)
    pcfg = dataclasses.replace(mmdit.TINY_MMDIT_CONFIG, qk_norm=qk_norm)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    port = mmdit.MMDiT(pcfg)
    port.load_state_dict(convert.mmdit_state_from_jax(v["params"]), strict=True)
    attach_lora(port, LoRASpec(RANK, ALPHA, mmdit.SD3_LORA_TARGETS))
    ad = convert.lora_state_from_jax(v["lora"])
    assert set(ad) == set(lora_shapes(port, RANK))
    assert "proj_out.lora_a" in ad and "transformer_blocks.1.ff.net.0.proj.lora_b" in ad
    with torch.no_grad():
        out_s = port.eval()(t(x), t(ts), t(c), t(pooled), ad)
        out_t = port(t(x), t(ts), t(c), t(pooled))
    assert out_s.shape == x.shape
    assert rel_max(out_s, ref_s) < 1e-4
    assert rel_max(out_t, ref_t) < 1e-4
    assert rel_max(out_s, ref_t) > 1e-3  # the adapter acts


@pytest.mark.parametrize("targets", ["SD3_LORA_TARGETS", "SD3_ADV_LORA_TARGETS",
                                     "SD3_ADV_STOCHASTIC_LORA_TARGETS"])
def test_mmdit_lora_targets_match_jax(targets):
    """Each target list marks the same layers with the same factor shapes
    (the adversarial lists reach ``timestep_embedder.linear_1`` and the like)."""
    assert getattr(mmdit, targets) == getattr(jmmdit, targets)
    spec = JLoRASpec(rank=RANK, alpha=ALPHA, targets=getattr(jmmdit, targets))
    x, ts, c, pooled = _mmdit_inputs(8)
    with jax_reference_ops():
        shapes = jax.eval_shape(jmmdit.MMDiT(jmmdit.TINY_MMDIT_CONFIG, lora=spec).init,
                                jax.random.PRNGKey(0),
                                *(jnp.asarray(a) for a in (x, ts, c, pooled)))
    with torch.device("meta"):
        port = mmdit.MMDiT(mmdit.TINY_MMDIT_CONFIG)
    attach_lora(port, LoRASpec(RANK, ALPHA, getattr(mmdit, targets)))
    assert convert.state_shapes_from_jax(shapes["lora"]) == lora_shapes(port, RANK)
    assert convert.state_shapes_from_jax(shapes["params"]) == {
        k: tuple(p.shape) for k, p in port.state_dict().items()}


def test_full_width_sd3_structure_matches_jax():
    """SD3-medium's MMDiT at full width: the converted `jax.eval_shape` tree
    gives the port's keys and shapes (meta device) and the same rank-32
    LoRA; the configs of the bundle are the JAX package's; T5-XXL has the
    JAX model's parameter count."""
    jb, pb = jfamilies.sd3_bundle(), families.sd3_bundle()
    for f in ("mmdit_cfg", "vae_cfg", "text_cfg", "text2_cfg", "t5_cfg", "lora"):
        assert dataclasses.asdict(getattr(pb, f)) == dataclasses.asdict(getattr(jb, f)), f
    assert pb.text_cfg.projection_dim == 768 and dataclasses.asdict(SD3_VAE_CONFIG) == \
        dataclasses.asdict(J_SD3_VAE)
    spec = JLoRASpec(rank=32, alpha=ALPHA, targets=jmmdit.SD3_LORA_TARGETS)
    with jax_reference_ops():
        shapes = jax.eval_shape(jmmdit.MMDiT(jmmdit.SD3_MEDIUM_CONFIG, lora=spec).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16)),
                                jnp.zeros((1,)), jnp.zeros((1, 154, 4096)), jnp.zeros((1, 2048)))
        t5_shapes = jax.eval_shape(jt5.T5Encoder(jt5.T5_XXL_CONFIG).init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 77), jnp.int32))
    port = pb.build(torch.device("meta"), ("mmdit", "t5"))
    ours = {k: tuple(v.shape) for k, v in port["mmdit"].state_dict().items()}
    assert convert.state_shapes_from_jax(shapes["params"]) == ours
    assert convert.state_shapes_from_jax(shapes["lora"]) == lora_shapes(port["mmdit"], 32)
    assert ours["pos_embed.pos_embed"] == (1, 192, 192, 1536)
    assert "transformer_blocks.22.to_add_out.weight" in ours
    assert "transformer_blocks.23.to_add_out.weight" not in ours  # context_pre_only
    n_mmdit = sum(p.numel() for p in port["mmdit"].parameters())
    n_t5 = sum(p.numel() for p in port["t5"].parameters())
    assert n_t5 == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(t5_shapes))
    assert 2.0e9 < n_mmdit < 2.1e9 and 4.7e9 < n_t5 < 4.8e9


def test_relative_position_bucket_matches_jax():
    pos = np.arange(154)
    rel = pos[None, :] - pos[:, None]
    ours = t5.relative_position_bucket(torch.from_numpy(rel))
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert len(np.unique(ref)) == 31  # every bucket but 16 (a positive offset of 0)


def test_t5_matches_flax():
    cfg = jt5.TINY_T5_CONFIG
    assert dataclasses.asdict(t5.TINY_T5_CONFIG) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(t5.T5_XXL_CONFIG) == dataclasses.asdict(jt5.T5_XXL_CONFIG)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    with jax_reference_ops():
        v = random_params(jt5.T5Encoder(cfg).init, jnp.asarray(ids), seed=5)
        ref = jax.jit(jt5.T5Encoder(cfg).apply)(v, jnp.asarray(ids))
    port = t5.T5Encoder(t5.TINY_T5_CONFIG)
    port.load_state_dict(convert.t5_state_from_jax(v["params"], cfg), strict=True)
    with torch.no_grad():
        out = port.eval()(t(ids).long())
    assert out.shape == (2, 77, cfg.d_model)
    assert rel_max(out, ref) < 1e-5


def test_sd3_vae_decoder_matches_flax():
    """The 16-channel decoder without quant convs, under SD3's shifted
    scaling (TINY widths)."""
    sd3 = dict(latent_channels=16, use_quant_conv=False, scaling_factor=1.5305,
               shift_factor=0.0609)
    jcfg = dataclasses.replace(J_TINY_VAE, **sd3)
    v = random_params(JVAE(jcfg).init, jnp.zeros((1, 16, 16, 3)), seed=6)
    z = np.random.default_rng(7).standard_normal((2, 8, 8, 16), dtype=np.float32)
    with jax_reference_ops():
        ref = jax.jit(lambda v_, z_: JVAE(jcfg).apply(v_, z_, method=JVAE.decode))(
            v, jnp.asarray(z))
    port = AutoencoderKL(dataclasses.replace(families.TINY_VAE_CONFIG, **sd3))
    port.load_state_dict(convert.vae_state_from_jax(v["params"]), strict=True)
    assert not hasattr(port, "post_quant_conv") and port.decoder.conv_in.in_channels == 16
    with torch.no_grad():
        out = port.eval().decode(t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < 5e-4


# ---------------------------------------------------------------------------
# the bundle, the step, the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd3():
    """The JAX TINY SD3 bundle with numpy-drawn weights (every module) and a
    LoRA with non-zero ``b``; the port's bundle on the converted weights."""
    jb = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True)
    with jax_reference_ops():
        jfrozen, jlora = random_params(lambda r: jb.init(r), seed=8)
    pb = families.sd3_bundle(RANK, dtype=torch.float32, tiny=True)
    states = {"mmdit": convert.mmdit_state_from_jax(jfrozen["mmdit"]),
              "vae": convert.vae_state_from_jax(jfrozen["vae"]),
              "text": convert.clip_state_from_jax(jfrozen["text"], pb.text_cfg),
              "text2": convert.clip_state_from_jax(jfrozen["text2"], pb.text2_cfg),
              "t5": convert.t5_state_from_jax(jfrozen["t5"], pb.t5_cfg)}
    return dict(jb=jb, jfrozen=jfrozen, jlora=jlora, pb=pb, pfrozen=pb.from_states(states, CPU),
                plora=convert.lora_state_from_jax(jlora))


def test_sd3_bundle_init_and_encode_prompts(sd3):
    """`encode_prompts` (CLIP-L and bigG penultimate states concatenated,
    zero-padded to the joint width, then T5 along the sequence; the pooled
    outputs concatenated) against JAX's `_encode_prompt`; a seeded init of
    any subset of modules draws the weights the whole bundle draws."""
    ids = _ids(["a red square", "a much longer caption of a blue circle", ""])
    with jax_reference_ops():
        ref = jax.jit(sd3["jb"].encode_prompts)(sd3["jfrozen"],
                                                *(jnp.asarray(ids[k]) for k in TOKS))
    with torch.no_grad():
        ours = sd3["pb"].encode_prompts(sd3["pfrozen"], *(t(ids[k]).long() for k in TOKS))
    assert ours["prompt_embeds"].shape == (3, 154, 32) and ours["pooled"].shape == (3, 32)
    assert rel_max(ours["prompt_embeds"], ref["prompt_embeds"]) < 1e-4
    assert rel_max(ours["pooled"], ref["pooled"]) < 1e-4

    pb = sd3["pb"]
    whole, template = pb.init(torch.Generator().manual_seed(9), CPU)
    part, template2 = pb.init(torch.Generator().manual_seed(9), CPU, modules=("t5", "vae"))
    assert sorted(part) == ["t5", "vae"] and template2 == {}
    for k in part:
        for a, b in zip(whole[k].state_dict().values(), part[k].state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(template) == set(sd3["plora"]) and pb.latent_channels == 4 and pb.vae_scale == 2
    assert pb.KOHYA_PREFIX == "lora_transformer"


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32),
            "pooled_embeds": rng.standard_normal((n, 32), dtype=np.float32),
            "uncond_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32) * 0.1,
            "uncond_pooled": rng.standard_normal((n, 32), dtype=np.float32) * 0.1}


def test_flow_distill_step_matches_jax(sd3):
    """Two steps of `build_flow_distill_step` (fixed w = 3, 10 solver steps,
    2 phases) on JAX's draws of `flow_prepare`: the target, the loss and the
    LoRA gradients of the first, the loss and the LoRA after each AdamW update.
    The uncond of the batch goes through the CFG merge with ``pooled``."""
    lr, eps = 1e-3, 1e-2  # see tests/test_torch_train.py: Adam's eps on round-off
    kw = dict(num_solver_steps=10, multiphase=2, fixed_w=3.0)
    jcfg, pcfg = jdistill.DistillConfig(**kw), distill.DistillConfig(**kw)
    jb, jfrozen = sd3["jb"], {"mmdit": sd3["jfrozen"]["mmdit"]}
    jsched = jax_make_flow_schedule(shift=3.0)
    jsol = JEulerSolver.create(jsched, 10)
    jtx = jax_make_optimizer(lr, eps=eps)
    batch = _batch(2, 10)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jgrad(lora, key):
        parts = jdistill.flow_prepare(jb, jsched, jsol, jcfg, jfrozen, lora, jbatch, key)

        def loss_fn(lora_):
            pred = jdistill.flow_model_pred(jb, jsched, jsol, jcfg, jfrozen, lora_, parts)
            return jlosses.consistency_loss(pred, parts["target"], jcfg.loss_type, jcfg.huber_c)

        return parts["target"], {k: parts[k] for k in ("noise", "index", "w")}, \
            jax.value_and_grad(loss_fn)(lora)

    with jax_reference_ops():
        jgrad = jax.jit(jgrad)
        finish = jax.jit(lambda s, g: jdistill._apply_updates(s, g, jtx))
        jstate = JTrainState.create(sd3["jlora"], jtx)
        jsteps = []
        for i in range(2):
            target, draws, (loss, grads) = jgrad(jstate.params, jax.random.PRNGKey(11 + i))
            jstate = finish(jstate, grads)
            jsteps.append((target, draws, loss, grads, jstate.params))

    pb = sd3["pb"]
    frozen = {"mmdit": sd3["pfrozen"]["mmdit"]}
    psched = make_flow_schedule(shift=3.0)
    psol = PhasedEulerSolver.create(psched, 10)
    ptx = make_optimizer(lr, eps=eps)
    pstate = convert.train_state_from_jax(JTrainState.create(sd3["jlora"], jtx))
    tbatch = {k: t(v) for k, v in batch.items()}
    step = distill.build_flow_distill_step(pb, psched, pcfg, ptx)
    for i, (target, jdraws, jloss, jgrads, jparams) in enumerate(jsteps):
        draws = {k: t(v) for k, v in jdraws.items()}
        assert float(draws["w"][0]) == 3.0
        if i == 0:
            parts = distill.flow_prepare(pb, psched, psol, pcfg, frozen, pstate.params, tbatch,
                                         draws)
            assert rel_max(parts["target"], target) < 1e-4
            lora = {k: p.detach().requires_grad_(True) for k, p in pstate.params.items()}
            pred = distill.flow_model_pred(pb, psched, psol, pcfg, frozen, lora, parts)
            grads = torch.autograd.grad(losses.consistency_loss(pred, parts["target"]),
                                        list(lora.values()))
            ref = convert.lora_state_from_jax(jgrads)
            for k, g in zip(lora, grads):
                assert rel_max(g, ref[k]) < 1e-3, k
        before = pstate
        pstate, pm = step(pstate, frozen, tbatch, [draws])
        np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
        ref_params = convert.lora_state_from_jax(jparams)
        for k, p in pstate.params.items():
            np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)
        assert max(float((pstate.params[k] - before.params[k]).abs().max())
                   for k in ref_params) > 1e-6
    assert pstate.step == 2


def test_sd3_encode_takes_cached_latents_only(sd3):
    batch = {k: t(v) for k, v in _batch(2, 12).items()}
    latents, cond, uncond = sd3["pb"].encode({}, batch)
    assert latents is batch["latents"] and cond["pooled"] is batch["pooled_embeds"]
    assert uncond["pooled"] is batch["uncond_pooled"]
    with pytest.raises(NotImplementedError, match="from pixels"):
        sd3["pb"].encode({}, {"pixel_values": torch.zeros(2, 16, 16, 3)})


@pytest.mark.parametrize("with_lora", [True, False], ids=["student", "teacher"])
@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_sd3_pipeline_matches_jax(sd3, with_lora, guidance):
    """2 PCM-FM steps on the 100-point grid from the same starting noise; at
    guidance 3 the CFG batch carries ``prompt_embeds`` and ``pooled`` of the
    empty prompt's encoding."""
    ids, empty = _ids(["a red square", "a blue circle"]), _ids(["", ""])
    init = np.random.default_rng(13).standard_normal((2, 8, 8, 4), dtype=np.float32)
    jb, jfrozen = sd3["jb"], sd3["jfrozen"]
    jpipe = JPipeline(jb, JPCMFMSampler.create(jax_make_flow_schedule(shift=3.0), 2, 100))

    def jenc(d):
        return jb.encode_prompts(jfrozen, *(jnp.asarray(d[k]) for k in TOKS))

    with jax_reference_ops():
        gen = jax.jit(lambda fr, lo, c, u, i: jpipe.generate(
            fr, lo, c, u, jax.random.PRNGKey(0), 8, guidance, init_latents=i))
        ref = gen(jfrozen, sd3["jlora"] if with_lora else None, jenc(ids), jenc(empty),
                  jnp.asarray(init))
    pb, frozen = sd3["pb"], sd3["pfrozen"]

    def enc(d):
        return pb.encode_prompts(frozen, *(t(d[k]).long() for k in TOKS))

    pipe = TextToImagePipeline(pb, PCMFMSampler.create(make_flow_schedule(shift=3.0), 2, 100))
    out = pipe.generate(frozen, sd3["plora"] if with_lora else None, enc(ids), enc(empty),
                        t(init), guidance, decode_chunk=1)
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < 1e-3


def _engine(sd3, stochastic, guidance=3.0, batch=3, lora=None):
    sampler = PCMFMSampler.create(make_flow_schedule(shift=3.0), 2, 100, stochastic)
    return InferenceEngine(sd3["pb"], sampler, sd3["pfrozen"], lora or sd3["plora"],
                           {k: HashTokenizer() for k in TOKS},
                           EngineConfig(batch_size=batch, latent_hw=8, resolution=16,
                                        guidance_scale=guidance), CPU)


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_sd3_engine_same_image_in_any_batch(sd3, stochastic):
    """A request's image is the same in a partial and in a full batch at
    another position: its starting noise and, stochastic, each step's fresh
    noise come from a generator seeded with its own seed."""
    eng = _engine(sd3, stochastic)
    solo = eng.generate_batch(["a red square"], [7])
    full = eng.generate_batch(["a blue circle", "a red square", "x"], [8, 7, 9])
    np.testing.assert_array_equal(solo[0], full[1])
    assert np.any(full[0] != full[1])
    if stochastic:
        det = _engine(sd3, False).generate_batch(["a red square"], [7])
        assert np.any(det[0] != solo[0])


def test_sd3_kohya_round_trip(sd3, tmp_path):
    """The adapter exported under ``lora_transformer`` equals the JAX
    package's export key for key and value for value, reads back as it was,
    and loads into the SD3 engine; a file under ``lora_unet`` does not."""
    jlora = jax.tree.map(np.asarray, sd3["jlora"])
    ours = kohya.to_kohya_state_dict(sd3["plora"], ALPHA, prefix="lora_transformer")
    ref = jkohya.to_kohya_state_dict(jlora, ALPHA, prefix="lora_transformer")
    assert sorted(ours) == sorted(ref)
    assert "lora_transformer_transformer_blocks_0_to_out_0.lora_down.weight" in ours
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    path = str(tmp_path / "pcm_sd3.safetensors")
    kohya.save_kohya_safetensors(path, sd3["plora"], ALPHA, dtype=np.float32,
                                 prefix="lora_transformer")
    back, alpha = kohya.load_kohya_safetensors(path, sd3["plora"], RANK, "lora_transformer")
    assert alpha == ALPHA
    for k, v in sd3["plora"].items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    eng = _engine(sd3, False, guidance=1.0, batch=1,
                  lora={k: torch.zeros_like(v) for k, v in sd3["plora"].items()})
    eng.load_lora(path)
    img = eng.generate_batch(["a red square"], [7])
    np.testing.assert_array_equal(img, _engine(sd3, False, 1.0, 1).generate_batch(
        ["a red square"], [7]))
    unet = str(tmp_path / "unet.safetensors")
    kohya.save_kohya_safetensors(unet, sd3["plora"], ALPHA)
    with pytest.raises(ValueError, match="lacks"):
        eng.load_lora(unet)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=__import__("json").dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return __import__("json").loads(r.read())


def test_serve_sd3_entry_point_tiny_cpu(tmp_path):
    """``python -m pcm_tpu_torch.serving --family sd3 --stochastic --tiny
    --device cpu --lora <lora_transformer file>`` answers a request."""
    pb = families.sd3_bundle(dtype=torch.float32, tiny=True)
    _, template = pb.init(torch.Generator().manual_seed(0), CPU)
    path = str(tmp_path / "pcm_sd3.safetensors")
    kohya.save_kohya_safetensors(path, adapter_like(template, torch.Generator().manual_seed(1)),
                                 ALPHA, prefix="lora_transformer")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pcm_tpu_torch.serving", "--family", "sd3", "--tiny",
         "--device", "cpu", "--stochastic", "--lora", path, "--cfg", "3.0", "--batch-size", "2",
         "--resolution", "16", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        port, deadline, lines = None, time.time() + 240, []
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "server never came up: " + "".join(lines[-20:])
        out = _post(f"http://127.0.0.1:{port}/generate", {"prompt": "cli smoke", "seed": 3})
        img = Image.open(io.BytesIO(base64.b64decode(out["image_b64"])))
        assert img.size == (16, 16)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_build_engine_stochastic_flag_tiny_cpu(tmp_path):
    """``--stochastic`` reaches the engine the CLI builds: its sampler is the
    stochastic one, and one request's image is not the deterministic
    engine's on the same ``--seed`` weights and adapter."""
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser

    pb = families.sd3_bundle(dtype=torch.float32, tiny=True)
    _, template = pb.init(torch.Generator().manual_seed(0), CPU)
    path = str(tmp_path / "pcm_sd3.safetensors")
    kohya.save_kohya_safetensors(path, adapter_like(template, torch.Generator().manual_seed(1)),
                                 ALPHA, prefix="lora_transformer")
    argv = ["--family", "sd3", "--tiny", "--device", "cpu", "--lora", path, "--batch-size", "1",
            "--resolution", "16", "--steps", "2"]
    engines = [build_engine(build_parser().parse_args(argv + flag))
               for flag in ([], ["--stochastic"])]
    assert [e.pipe.sampler.stochastic for e in engines] == [False, True]
    det, sto = (e.generate_batch(["a red square"], [7]) for e in engines)
    assert det.shape == sto.shape == (1, 16, 16, 3)
    assert (det != sto).any()


@pytest.mark.parametrize("argv,msg", [
    (["--family", "sd3", "--weights", "int8"], "--weights int8 with --family sd3"),
    (["--stochastic"], "--stochastic is SD3's sampler"),
], ids=["sd3_int8", "stochastic_sd15"])
def test_serve_sd3_refusals(argv, msg, capsys):
    from pcm_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code != 0 and msg in capsys.readouterr().err


def test_train_refuses_sd3_recipes_naming_4b(tmp_path, capsys):
    from pcm_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--recipe", "sd3_4phase_adv", "--tiny", "--device", "cpu", "--output-dir",
              str(tmp_path / "o"), "--cached-latents-dir", str(tmp_path)])
    err = capsys.readouterr().err
    assert e.value.code != 0 and "not yet ported" in err and "slice 4b" in err
