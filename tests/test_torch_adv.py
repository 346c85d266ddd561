"""The port's adversarial distillation against `pcm_tpu` (fp32, CPU, TINY sizes):
hinge and feature-matching losses, the UNet's feature taps, the
discriminator heads, K4 on fp32, the paired feature forward, one G step,
one D step and one fused pair, and the training CLI.

Inputs, weights and heads are drawn with numpy and cross through
`pcm_tpu_torch.models.convert`; the JAX steps' draws (noise, solver index,
w, the renoising offset and noises) are reproduced from their keys and fed
to the port. Bounds: losses rtol 1e-6 (the same fp32 formulas); taps rel
1e-4 (whole TINY UNet passes); heads rel 1e-5 (two convs and two
GroupNorms); K4's plain version against the Pallas kernel in interpret mode
rel 1e-5; the paired 2B forward against two B passes 1e-5 (the convs'
summation order may depend on the batch); one step: losses rtol 1e-5, grads
(Adam's first moment after the update) rel 1e-3, params atol 1e-5 with
Adam's eps 1e-2 (as in tests/test_torch_train.py); the fused pair's grads
against the unfused steps' on the same draws 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs.families import sdxl_bundle as jax_sdxl_bundle
from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from pcm_tpu.models.unet import TINY_SDXL_CONFIG as J_TINY_SDXL
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.ops.groupnorm import group_norm_silu as jax_group_norm_silu
from pcm_tpu.train import adv as jadv
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD15Bundle as JSD15Bundle
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs.families import disc_config, sd15_bundle, sdxl_bundle
from pcm_tpu_torch.core import losses
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.ops.groupnorm import (gn_lanes, gn_partition, group_norm_silu_fwd,
                                         group_norm_stats_chunked)
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from torch_port_helpers import random_params, rel_max

RANK = 4
GROUPS = 8  # the UNet's; see tests/test_torch_train.py (32 one-channel groups zero a LoRA grad)
LR, EPS = 1e-3, 1e-2  # Adam's eps raised as in tests/test_torch_train.py
STEPS, PHASES = 10, 2


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_adv_losses_match_jax():
    """hinge D / G and feature matching over three heads of different sizes,
    and the discriminator's feature-match loss over a dict of taps."""
    rng = np.random.default_rng(0)
    shapes = [(2, 4, 4, 1), (2, 8, 8, 1), (2, 2, 2, 1)]
    fake = [rng.standard_normal(s, dtype=np.float32) * 2 for s in shapes]
    real = [rng.standard_normal(s, dtype=np.float32) * 2 for s in shapes]
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.float32(a), np.float32(b), rtol=1e-6, atol=0)
    J = jnp.asarray
    close(losses.hinge_d_loss([t(a) for a in fake], [t(a) for a in real]),
          jlosses.hinge_d_loss([J(a) for a in fake], [J(a) for a in real]))
    close(losses.hinge_d_loss([t(a) for a in fake], [t(a) for a in real], 0.5),
          jlosses.hinge_d_loss([J(a) for a in fake], [J(a) for a in real], 0.5))
    close(losses.hinge_g_loss([t(a) for a in fake]), jlosses.hinge_g_loss([J(a) for a in fake]))
    close(losses.feature_matching_loss([t(a) for a in fake], [t(a) for a in real]),
          jlosses.feature_matching_loss([J(a) for a in fake], [J(a) for a in real]))
    taps = {f"down_{i}": (fake[i], real[i]) for i in range(3)}
    close(adv.feature_match_loss({k: t(f) for k, (f, _) in taps.items()},
                                 {k: t(r) for k, (_, r) in taps.items()}),
          jadv.feature_match_loss({k: J(f) for k, (f, _) in taps.items()},
                                  {k: J(r) for k, (_, r) in taps.items()}))


# ---------------------------------------------------------------------------
# feature taps
# ---------------------------------------------------------------------------


def _time_ids(n):
    return np.tile(np.array([1024, 1024, 0, 0, 1024, 1024], np.float32), (n, 1))


def _tiny_bundles(family, groups=32):
    """The JAX and port bundles of a TINY family on the same numpy-drawn
    UNet (``groups`` GroupNorm groups), fp32, and the JAX frozen tree."""
    spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    if family == "sd15":
        jcfg = dataclasses.replace(J_TINY_UNET, norm_groups=groups)
        added = None
        text_cfg = JCLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2,
                                   intermediate_size=64)
        jbundle = JSD15Bundle(jcfg, J_TINY_VAE, text_cfg, spec, dtype=jnp.float32)
        pbundle = sd15_bundle(RANK, dtype=torch.float32, tiny=True)
    else:
        jcfg = dataclasses.replace(J_TINY_SDXL, norm_groups=groups)
        added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
        jbundle = dataclasses.replace(jax_sdxl_bundle(RANK, dtype=jnp.float32, remat=False,
                                                      tiny=True), unet_cfg=jcfg)
        pbundle = sdxl_bundle(RANK, dtype=torch.float32, tiny=True)
    v = random_params(JUNet(jcfg, lora=spec).init, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                      jnp.zeros((1, 7, 32)), added, seed=31)
    pbundle = dataclasses.replace(
        pbundle, unet_cfg=dataclasses.replace(pbundle.unet_cfg, norm_groups=groups))
    frozen = pbundle.build(torch.device("cpu"))
    frozen["unet"].load_state_dict(convert.unet_state_from_jax(v["params"]))
    return dict(jbundle=jbundle, jfrozen={"unet": v["params"]}, jlora=v["lora"],
                pbundle=pbundle, pfrozen=frozen)


def _batch(family, n, seed):
    rng = np.random.default_rng(seed)
    b = {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
         "prompt_embeds": rng.standard_normal((n, 7, 32), dtype=np.float32)}
    if family == "sd15":
        b["uncond_embeds"] = rng.standard_normal((n, 7, 32), dtype=np.float32) * 0.1
    else:
        b.update(pooled_embeds=rng.standard_normal((n, 32), dtype=np.float32),
                 time_ids=_time_ids(n))
    return b


def _cond(m, family, batch):
    """(JAX cond, port cond) of a batch through each bundle's encode."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jc, _ = m["jbundle"].encode(m["jfrozen"], jb, jax.random.PRNGKey(0))
    _, pc, _ = m["pbundle"].encode(m["pfrozen"], {k: t(v) for k, v in batch.items()})
    return jc, pc


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("stop_after_mid", [False, True], ids=["all", "stop_after_mid"])
def test_teacher_features_match_jax(family, stop_after_mid):
    """Every tap of the TINY teacher (``down_*`` after the level's
    downsampler, ``mid``, ``up_*`` after the upsampler) in the JAX layout;
    with ``stop_after_mid`` the down and mid taps only."""
    m = _tiny_bundles(family)
    batch = _batch(family, 2, 32)
    jc, pc = _cond(m, family, batch)
    x = np.random.default_rng(33).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ts = np.array([999.0, 261.0], np.float32)
    ref = jax.jit(lambda x_, t_, c_: m["jbundle"].teacher_features(m["jfrozen"], x_, t_, c_))(
        jnp.asarray(x), jnp.asarray(ts), jc)
    with torch.no_grad():
        got = m["pbundle"].teacher_features(m["pfrozen"], t(x), t(ts), pc, stop_after_mid)
    want = {"down_0", "down_1", "mid"} | (set() if stop_after_mid else {"up_0", "up_1"})
    assert set(got) == want and want <= set(ref)
    for k, f in got.items():
        assert tuple(f.shape) == ref[k].shape, k
        assert rel_max(f, ref[k]) < 1e-4, k


# ---------------------------------------------------------------------------
# discriminator heads and K4 on fp32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_discriminator_matches_jax(name):
    """The heads of the full SD1.5 and SDXL configs (nine taps of four 3x3
    heads; four taps of one 1x1 head) on numpy features at small spatial
    sizes and widths, one of them a seq tap (B, S, C) turned into a grid."""
    cfg = disc_config(name)
    jcfg = {"sd15": jadv.SD15_DISC_CONFIG, "sdxl": jadv.SDXL_DISC_CONFIG}[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(34)
    chans = {tap: (32, 64)[i % 2] for i, tap in enumerate(cfg.taps)}
    feats = {tap: rng.standard_normal((2, 4 + 2 * (i % 2), 4 + 2 * (i % 2), chans[tap]),
                                      dtype=np.float32) for i, tap in enumerate(cfg.taps)}
    feats["mid"] = feats["mid"].reshape(2, -1, chans["mid"])  # a seq tap
    jdisc = jadv.Discriminator(jcfg)
    jparams = random_params(jdisc.init, {k: jnp.asarray(v) for k, v in feats.items()},
                            seed=35)["params"]
    ref = jax.jit(jdisc.apply)({"params": jparams}, {k: jnp.asarray(v) for k, v in feats.items()})
    disc, params = adv.init_discriminator(cfg, chans, torch.Generator().manual_seed(0),
                                          torch.device("cpu"))
    ported = convert.disc_state_from_jax(_np_tree(jparams))
    assert {k: tuple(v.shape) for k, v in ported.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    got = disc.logits(ported, {k: t(v) for k, v in feats.items()})
    assert len(got) == len(ref) == len(cfg.taps) * cfg.num_h_per_head
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        assert rel_max(a, b) < 1e-5


def test_init_discriminator_is_flax_init():
    """Lecun-normal conv kernels (a normal truncated at 2 standard
    deviations, variance 1 / fan_in), zero biases, GroupNorm scale one."""
    cfg = adv.DiscriminatorConfig(taps=("down_0",), num_h_per_head=1, kernel=3)
    _, p = adv.init_discriminator(cfg, {"down_0": 256}, torch.Generator().manual_seed(1),
                                  torch.device("cpu"))
    w = p["head_0_0.conv1.weight"]
    std = (1 / (256 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.01
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert torch.equal(p["head_0_0.norm1.weight"], torch.ones(256))
    assert not p["head_0_0.conv1.bias"].any() and not p["head_0_0.conv_out.bias"].any()


@pytest.mark.parametrize("shape", [(2, 5, 7, 32), (2, 4, 4, 64), (1, 77, 64)])
def test_group_norm_fp32_matches_pallas(shape):
    """K4's plain version on fp32 input, act=None (the heads' GroupNorm),
    against the Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(36)
    c = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32) * 3 + 0.5
    g = rng.standard_normal(c, dtype=np.float32)
    b = rng.standard_normal(c, dtype=np.float32)
    ref = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 32, 1e-5, None,
                              interpret=True)
    got = group_norm_silu_fwd(t(x), t(g), t(b), 32, 1e-5, None)
    assert got.dtype == torch.float32
    assert rel_max(got, ref) < 1e-5


def test_function_backwards_skip_frozen_weights():
    """The GroupNorm and GEGLU Functions' backwards (autograd of the plain
    versions) through frozen weights, as the G loss crosses the teacher: the
    input's gradient equals the one taken with every input differentiated,
    and no weight gradient is made."""
    from pcm_tpu_torch.ops.geglu import geglu, geglu_reference
    from pcm_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference

    rng = np.random.default_rng(38)
    cases = [(lambda x, w, b: group_norm_silu(x, w, b, 32, 1e-5, "silu"),
              lambda x, w, b: group_norm_silu_reference(x, w, b, 32, 1e-5, "silu"),
              (2, 5, 5, 64), (64,)),
             (geglu, geglu_reference, (7, 32), (48, 32))]
    for fn, ref_fn, xs, ws in cases:
        x, w = t(rng.standard_normal(xs, dtype=np.float32)), t(rng.standard_normal(ws, dtype=np.float32))
        b = t(rng.standard_normal(ws[:1], dtype=np.float32))
        g = t(rng.standard_normal(fn(x, w, b).shape, dtype=np.float32))
        xg = x.clone().requires_grad_(True)
        fn(xg, w, b).backward(g)
        full = [a.clone().requires_grad_(True) for a in (x, w, b)]
        ref_fn(*full).backward(g)
        assert w.grad is None and b.grad is None
        assert torch.equal(xg.grad, full[0].grad)


@pytest.mark.parametrize("n,s,c,part", [
    (4, 4096, 320, (3, 63, 66, 4, 8)),     # SDXL's 64x64 tap at batch 2B: 240 threads
    (4, 1024, 1280, (1, 16, 64, 8, 8)),    # SDXL's mid tap: 320 threads, one row phase
    (4, 64, 1280, (1, 8, 8, 8, 4)),        # SD1.5's 8x8 taps: one unrolled sweep a chunk
    (4, 4096, 640, (1, 63, 66, 4, 4)),     # SD1.5's up_2 tap
    (2, 4096, 1536, (1, 32, 128, 8, 8)),   # SD3's 64x64 taps at B: 384 threads, 12 warps
    (4, 4096, 1536, (1, 63, 66, 8, 8)),    # and at the D step's 2B
])
def test_gn_partition_fp32(n, s, c, part):
    """K4's grid on fp32 input: a 16-byte vector holds 4 channels, so a row
    takes C/4 threads and the row phases shrink to fit 256 threads."""
    got = gn_partition(n, s, c, 32, elem_size=4)
    assert got == part
    assert gn_lanes(c, 4) == c // 4 and got.rs * gn_lanes(c, 4) <= 512
    assert got.rows_per_chunk % got.rs == 0
    assert (got.nchunk - 1) * got.rows_per_chunk < s <= got.nchunk * got.rows_per_chunk


@pytest.mark.parametrize("shape", [(2, 7, 11, 320), (1, 4000, 640), (4, 8, 8, 1280),
                                   (2, 4096, 1536), (4, 4096, 1536)])
def test_group_norm_chunked_stats_fp32(shape):
    """The kernel's merge order on fp32 input (its partition) against float64:
    the mean within 2.5e-7 of max |x|, rstd within 1e-5 relative."""
    rng = np.random.default_rng(37)
    x = rng.standard_normal(shape, dtype=np.float32) + np.float32(3.0)
    mean, rstd = group_norm_stats_chunked(torch.from_numpy(x), 32, 1e-5, elem_size=4)
    xg = x.astype(np.float64).reshape(shape[0], -1, 32, shape[-1] // 32)
    assert np.abs(mean.numpy() - xg.mean(axis=(1, 3))).max() <= 2.5e-7 * np.abs(x).max()
    exact = 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5)
    assert np.abs(rstd.numpy() / exact - 1).max() <= 1e-5


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_adv():
    """TINY SD1.5 on both sides (8 UNet GroupNorm groups), the TINY
    discriminator's heads drawn with numpy, and the JAX steps."""
    m = _tiny_bundles("sd15", GROUPS)
    cfg_kw = dict(num_solver_steps=STEPS, multiphase=PHASES, w_min=4.0, w_max=5.0)
    jcfg, pcfg = jdistill.DistillConfig(**cfg_kw), distill.DistillConfig(**cfg_kw)
    dcfg = disc_config("sd15", tiny=True)
    jdcfg = jadv.DiscriminatorConfig(dcfg.taps, dcfg.num_h_per_head, dcfg.kernel)
    jdisc = jadv.Discriminator(jdcfg)
    batch = _batch("sd15", 2, 40)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jc, _ = _cond(m, "sd15", batch)
    feats = jax.eval_shape(lambda x: m["jbundle"].teacher_features(
        m["jfrozen"], x, jnp.zeros((2,)), jc), jnp.zeros((2, 8, 8, 4)))
    jd_params = random_params(jdisc.init, feats, seed=41)["params"]
    jtx_g = jax_make_optimizer(LR, eps=EPS)
    jtx_d = jax_make_optimizer(LR, b1=0.0, eps=EPS)
    jg = JTrainState.create(m["jlora"], jtx_g)
    jd = JTrainState.create(jd_params, jtx_d)
    g_step, d_step = jadv.build_ddim_adv_steps(m["jbundle"], jax_schedule(), jcfg,
                                               jadv.AdvConfig(0.1), jdisc, jtx_g, jtx_d)
    pair = jadv.build_ddim_adv_fused_pair(m["jbundle"], jax_schedule(), jcfg,
                                          jadv.AdvConfig(0.1), jdisc, jtx_g, jtx_d)
    disc, _ = adv.init_discriminator(dcfg, m["pbundle"].unet_cfg.tap_channels(),
                                     torch.Generator().manual_seed(0), torch.device("cpu"))
    return dict(m, jcfg=jcfg, pcfg=pcfg, jdisc=jdisc, disc=disc, batch=batch, jb=jb,
                jg=jg, jd=jd, jsteps={"g": g_step, "d": d_step, "pair": pair})


def _jax_draws(key, batch, cfg):
    """The draws of one microbatch of the JAX adversarial steps from the key
    their grad_fn gets: ``ddim_prepare``'s (`pcm_tpu/train/distill.py:143-152`)
    from the first half of a split, the offset and the two renoising noises
    from the second (`pcm_tpu/train/adv.py:179-183,212-221`)."""
    r, r_adv = jax.random.split(key)
    _, r_noise, r_idx, r_w = jax.random.split(r, 4)
    lat = batch["latents"]
    bsz = lat.shape[0]
    r_t, r_fake, r_real = jax.random.split(r_adv, 3)
    draws = {"noise": jax.random.normal(r_noise, lat.shape, lat.dtype),
             "index": jax.random.randint(r_idx, (bsz,), 0, cfg.num_solver_steps),
             "w": jdistill._sample_w(cfg, r_w, bsz, jnp.float32),
             "adv_offset": jax.random.randint(r_t, (bsz,), 0, 1000 // cfg.multiphase),
             "eps_fake": jax.random.normal(r_fake, lat.shape, lat.dtype),
             "eps_real": jax.random.normal(r_real, lat.shape, lat.dtype)}
    return [{k: t(v) for k, v in draws.items()}]


def _port_steps(m, tx_g, tx_d):
    sched = make_ddpm_schedule()
    a = adv.AdvConfig(0.1)
    g_step, d_step = adv.build_ddim_adv_steps(m["pbundle"], sched, m["pcfg"], a, m["disc"],
                                              tx_g, tx_d)
    pair = adv.build_ddim_adv_fused_pair(m["pbundle"], sched, m["pcfg"], a, m["disc"], tx_g,
                                         tx_d)
    return {"g": g_step, "d": d_step, "pair": pair}


def _states(m, tx_g, tx_d):
    g = convert.train_state_from_jax(m["jg"])
    d = convert.train_state_from_jax(m["jd"], convert.disc_state_from_jax)
    return (TrainState(0, g.params, tx_g.init(g.params)),
            TrainState(0, d.params, tx_d.init(d.params)))


@pytest.mark.parametrize("kind", ["g", "d", "pair"], ids=["g_step", "d_step", "fused_pair"])
def test_adv_step_matches_jax(sd15_adv, kind):
    """One G step, one D step or one fused pair on both sides from the same
    states, the JAX draws fed to the port (the D step's key folds in the
    heads' step and 7): the losses, the grad norms, Adam's first moment (the
    grads: (1 - b1) g for the LoRA, the clipped g for the heads, b1 = 0)
    rel-max leaf by leaf, and the params after the update. A leaf whose
    reference gradient is below 1e-6 of its tree's largest is round-off and
    has no relative error to hold: a conv bias ahead of a GroupNorm of one
    channel a group (the 32-wide taps), and a head's output bias while every
    logit lies inside the hinge, where the fake and real terms cancel. No
    LoRA leaf is below it (the UNet has 8 groups)."""
    m = sd15_adv
    key = jax.random.PRNGKey(5)
    jnew = jax.jit(m["jsteps"][kind])(m["jg"], m["jd"], m["jfrozen"], m["jb"], key)
    step_key = jax.random.fold_in(key, 0)
    if kind == "d":
        step_key = jax.random.fold_in(step_key, 7)
    draws = _jax_draws(step_key, m["jb"], m["jcfg"])

    tx_g, tx_d = make_optimizer(LR, eps=EPS), make_optimizer(LR, b1=0.0, eps=EPS)
    g0, d0 = _states(m, tx_g, tx_d)
    pnew = _port_steps(m, tx_g, tx_d)[kind](g0, d0, m["pfrozen"],
                                            {k: t(v) for k, v in m["batch"].items()}, draws)
    jmetrics, pmetrics = jnew[-1], pnew[-1]
    assert set(pmetrics) == set(jmetrics)
    for k in pmetrics:
        rtol = 1e-3 if k.endswith("grad_norm") else 1e-5
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=rtol)
    pairs = {"g": [("g", 0, convert.lora_state_from_jax)],
             "d": [("d", 0, convert.disc_state_from_jax)],
             "pair": [("g", 0, convert.lora_state_from_jax),
                      ("d", 1, convert.disc_state_from_jax)]}[kind]
    for which, i, conv in pairs:
        ps, js = pnew[i], jnew[i]
        assert ps.step == 1
        mu = convert._find_adam(js.opt_state).mu
        ref_mu, ref_params = conv(_np_tree(mu)), conv(_np_tree(js.params))
        top = max(float(ref_mu[k].abs().max()) for k in ps.params)
        roundoff = [k for k in ps.params if float(ref_mu[k].abs().max()) < 1e-6 * top]
        assert which == "d" or not roundoff, roundoff
        for k in ps.params:
            if k not in roundoff:
                assert rel_max(ps.opt_state["mu"][k], ref_mu[k]) < 1e-3, (which, k)
        for k, p in ps.params.items():
            np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)
        before = (g0 if which == "g" else d0).params
        assert max(float((ps.params[k] - before[k]).abs().max()) for k in before) > 1e-6


class _Grads:
    """An optimizer that keeps the grads it is given and moves nothing."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        self.grads = grads
        return dict(params), state, torch.zeros(())


def test_fused_pair_grads_equal_unfused_steps(sd15_adv):
    """On the same draws and states, the fused pair's LoRA grads are the G
    step's and its heads' grads the D step's: no gradient crosses between
    the players."""
    m = sd15_adv
    draws = _jax_draws(jax.random.PRNGKey(6), m["jb"], m["jcfg"])
    batch = {k: t(v) for k, v in m["batch"].items()}
    grads = {}
    for kind in ("g", "d", "pair"):
        tx_g, tx_d = _Grads(), _Grads()
        g0, d0 = _states(m, tx_g, tx_d)
        _port_steps(m, tx_g, tx_d)[kind](g0, d0, m["pfrozen"], batch, draws)
        grads[kind] = (getattr(tx_g, "grads", None), getattr(tx_d, "grads", None))
    assert grads["g"][1] is None and grads["d"][0] is None
    for i, unfused in ((0, grads["g"][0]), (1, grads["d"][1])):
        for k, g in grads["pair"][i].items():
            assert float(g.abs().max()) > 0, k
            assert rel_max(g, unfused[k]) <= 1e-6, k


def test_pair_features_equal_two_passes(sd15_adv):
    m = sd15_adv
    rng = np.random.default_rng(42)
    fake, real = (t(rng.standard_normal((2, 8, 8, 4), dtype=np.float32)) for _ in range(2))
    adv_t = torch.tensor([700, 300])
    _, cond = _cond(m, "sd15", m["batch"])
    with torch.no_grad():
        ff, rf = adv.pair_features(m["pbundle"], m["pfrozen"], fake, real, adv_t, cond)
        for x, paired in ((fake, ff), (real, rf)):
            alone = m["pbundle"].teacher_features(m["pfrozen"], x, adv_t, cond)
            assert set(paired) == set(alone)
            for k in alone:
                assert rel_max(paired[k], alone[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _write_cache(path, family, n=4):
    rng = np.random.default_rng(43)
    path.mkdir()
    arrays = {"latents": rng.standard_normal((n, 8, 8, 4)).astype(np.float16),
              "prompt_embeds": rng.standard_normal((n, 77, 32)).astype(np.float16)}
    if family == "sdxl":
        arrays.update(pooled_embeds=rng.standard_normal((n, 32)).astype(np.float16),
                      time_ids=_time_ids(n))
    np.savez(path / "shard_00000.npz", **arrays)


def _train(*argv):
    from pcm_tpu_torch.train.__main__ import main

    return main(list(argv))


def _cli(tmp_path, recipe, family, pairing, cache="cache"):
    _write_cache(tmp_path / cache, family)
    return ["--recipe", recipe, "--tiny", "--device", "cpu", "--cached-latents-dir",
            str(tmp_path / cache), "--output-dir", str(tmp_path / "run"), "--batch-size", "2",
            "--log-every", "1", "--adv-pairing", pairing]


def _rows(tmp_path):
    import json

    with open(tmp_path / "run" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("recipe,family,pairing", [
    ("sd15_2phase_adv", "sd15", "fresh"), ("sd15_2phase_adv", "sd15", "fused"),
    ("sdxl_4phase_adv", "sdxl", "fresh")], ids=["sd15-fresh", "sd15-fused", "sdxl-fresh"])
def test_train_cli_adversarial(tmp_path, recipe, family, pairing):
    """Four global steps: fresh alternates D (odd rows: steps 1, 3) and G,
    fused logs both players every pair (steps 2, 4); LoRA and heads move."""
    common = _cli(tmp_path, recipe, family, pairing)
    trainer = _train(*common, "--max-train-steps", "4")
    assert trainer.global_step == 4
    rows = _rows(tmp_path)
    if pairing == "fresh":
        assert [r["step"] for r in rows] == [1, 2, 3, 4]
        assert all("d_loss" in r and "loss" not in r for r in rows[0::2])
        assert all({"loss", "loss_cm", "g_loss", "grad_norm"} <= set(r) for r in rows[1::2])
        assert trainer.state.step == 2 and trainer.d_state.step == 2
    else:
        assert [r["step"] for r in rows] == [2, 4]
        assert all({"loss", "d_loss", "grad_norm", "d_grad_norm"} <= set(r) for r in rows)
        assert trainer.state.step == 2 and trainer.d_state.step == 2
    assert all(np.isfinite(r.get("loss", 0.0)) and np.isfinite(r.get("d_loss", 0.0))
               for r in rows)
    assert max(float(v.abs().max()) for k, v in trainer.state.params.items()
               if k.endswith("lora_b")) > 0
    ck = torch.load(tmp_path / "run" / "checkpoints" / "step_0000004.pt", weights_only=True)
    assert ck["d_step"] == 2 and ck["d_opt_state"]["count"] == 2
    unet_cfg = (sd15_bundle if family == "sd15" else sdxl_bundle)(tiny=True).unet_cfg
    _, init = adv.init_discriminator(disc_config(family, tiny=True), unet_cfg.tap_channels(),
                                     torch.Generator().manual_seed(42 + 1), torch.device("cpu"))
    assert set(ck["d_params"]) == set(init)
    assert max(float((ck["d_params"][k] - v).abs().max()) for k, v in init.items()) > 0


def test_train_cli_adversarial_resumes_heads(tmp_path, capsys):
    """A resumed fresh run restores the heads, their optimizer and the global
    step counter, and goes on with a D update (logged as step 3: the global
    step before it was 2, even) then a G update."""
    common = _cli(tmp_path, "sd15_2phase_adv", "sd15", "fresh")
    first = _train(*common, "--max-train-steps", "2")
    heads = {k: v.clone() for k, v in first.d_state.params.items()}
    capsys.readouterr()
    trainer = _train(*common, "--max-train-steps", "4")
    assert trainer.resumed_from == 2 and "resumed at step 2" in capsys.readouterr().out
    rows = _rows(tmp_path)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert "d_loss" in rows[2] and "loss" in rows[3]
    assert trainer.global_step == 4 and trainer.state.step == 2 and trainer.d_state.step == 2
    ck = torch.load(tmp_path / "run" / "checkpoints" / "step_0000002.pt", weights_only=True)
    for k, v in ck["d_params"].items():
        assert torch.equal(v, heads[k]), k
    with pytest.raises(ValueError, match="does not match"):  # another recipe's heads
        _train(*_cli(tmp_path, "sdxl_4phase_adv", "sdxl", "fresh", cache="xl_cache"),
               "--max-train-steps", "6")


def test_train_cli_adversarial_int8(tmp_path, capsys):
    """``--recipe sdxl_4phase_adv --frozen-weights int8 --int8-matmul fused``
    (refused before int8 weights reached the adversarial recipes): two
    global steps of the fused pair on int8 UNet weights, finite losses, the
    LoRA and the heads moved, the heads fp32."""
    trainer = _train(*_cli(tmp_path, "sdxl_4phase_adv", "sdxl", "fused"), "--max-train-steps",
                     "2", "--frozen-weights", "int8", "--int8-matmul", "fused")
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and "int8 frozen weights" in printed
    assert "int8 matmul fused" in printed and "nan" not in printed
    rows = _rows(tmp_path)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["d_loss"]) for r in rows)
    assert trainer.frozen["unet"].conv_in.weight_values.dtype == torch.int8
    assert max(float(v.abs().max()) for k, v in trainer.state.params.items()
               if k.endswith("lora_b")) > 0
    assert trainer.d_state.step == 1
    assert all(v.dtype == torch.float32 for v in trainer.d_state.params.values())


@pytest.mark.parametrize("extra,msg", [
    (["--recipe", "sd15_2phase_adv", "--split-d"], "not yet ported")], ids=["split_d"])
def test_train_cli_refuses_unported_adversarial(tmp_path, capsys, extra, msg):
    with pytest.raises(SystemExit) as exc:
        _train(*extra, "--tiny", "--device", "cpu", "--output-dir", str(tmp_path / "o"),
               "--cached-latents-dir", str(tmp_path))
    assert exc.value.code != 0
    assert msg in capsys.readouterr().err
