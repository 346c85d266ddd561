"""SD3 adversarial distillation in the port against `pcm_tpu` (CPU, fp32,
TINY sizes): the MMDiT's feature taps, the 2-tap TINY discriminator, the
flow G step, D step and fused pair, the renoising offset's range, the SD3
latent cache, ``python -m pcm_tpu_torch.train`` on the four SD3 recipes'
path from caches and from PNGs, kohya files under ``lora_transformer`` that
hold the adversarial target lists, and serving them layer for layer.

Weights, heads and inputs are drawn with numpy and cross through
`pcm_tpu_torch.models.convert`; the JAX side runs its plain ops
(`pcm_tpu.ops.common.reference_ops`), and the JAX steps' draws (noise, grid
index, w, the renoising offset and noises) are reproduced from their keys
and fed to the port. Bounds: taps rel-max 1e-4 (whole TINY MMDiT passes);
heads 1e-5; one step as `tests/test_torch_adv.py` holds the DDIM steps
(losses rtol 1e-5, grad norms 1e-3, Adam's first moment rel 1e-3 leaf by
leaf, params atol 1e-5 with Adam's eps 1e-2); the fused pair's grads against
the unfused steps' 1e-6; the remat taps and their input gradient 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core.schedule import make_flow_schedule as jax_make_flow_schedule
from pcm_tpu.data.dataset import CachedLatentsDataset as JCached
from pcm_tpu.lora import kohya as jkohya
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.train import adv as jadv
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
from pcm_tpu_torch.core.solver import PhasedEulerSolver
from pcm_tpu_torch.data import cache_latents
from pcm_tpu_torch.lora import kohya
from pcm_tpu_torch.models import convert, mmdit
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.__main__ import main as train_main
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from torch_port_helpers import random_params, rel_max

CPU = torch.device("cpu")
RANK = 4
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


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32),
            "pooled_embeds": rng.standard_normal((n, 32), dtype=np.float32),
            "uncond_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32) * 0.1,
            "uncond_pooled": rng.standard_normal((n, 32), dtype=np.float32) * 0.1}


@pytest.fixture(scope="module")
def sd3():
    """The TINY SD3 bundles of both packages on the adversarial LoRA list,
    the MMDiT drawn with numpy (LoRA ``b`` non-zero), the TINY
    discriminator's heads drawn with numpy, and the JAX flow steps."""
    jb = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True, adv_targets=True)
    with jax_reference_ops():
        jfrozen, jlora = random_params(lambda r: jb.init(r), seed=60)
    jfrozen = {"mmdit": jfrozen["mmdit"]}
    pb = families.sd3_bundle(RANK, dtype=torch.float32, tiny=True, adv_targets=True)
    pfrozen = pb.from_states({"mmdit": convert.mmdit_state_from_jax(jfrozen["mmdit"])}, CPU)
    dcfg = families.disc_config("sd3", tiny=True)
    jdisc = jadv.Discriminator(jadv.DiscriminatorConfig(dcfg.taps, dcfg.num_h_per_head,
                                                        dcfg.kernel))
    batch = _batch(2, 61)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cond = {"prompt_embeds": jbatch["prompt_embeds"], "pooled": jbatch["pooled_embeds"]}
    with jax_reference_ops():
        feats = jax.eval_shape(lambda x: jb.teacher_features(jfrozen, x, jnp.zeros((2,)), cond),
                               jnp.zeros((2, 8, 8, 4)))
    jd_params = random_params(jdisc.init, feats, seed=62)["params"]
    kw = dict(num_solver_steps=STEPS, multiphase=PHASES, fixed_w=3.0)
    jcfg, pcfg = jdistill.DistillConfig(**kw), distill.DistillConfig(**kw)
    jtx_g, jtx_d = jax_make_optimizer(LR, eps=EPS), jax_make_optimizer(LR, b1=0.0, eps=EPS)
    parts = (jb, jax_make_flow_schedule(shift=3.0), jcfg, jadv.AdvConfig(0.1), jdisc, jtx_g,
             jtx_d)
    g_step, d_step = jadv.build_flow_adv_steps(*parts)
    disc, _ = adv.init_discriminator(dcfg, pb.tap_channels(), torch.Generator().manual_seed(0),
                                     CPU)
    return dict(jb=jb, jfrozen=jfrozen, jlora=jlora, pb=pb, pfrozen=pfrozen, jdisc=jdisc,
                disc=disc, batch=batch, jbatch=jbatch, jcfg=jcfg, pcfg=pcfg,
                jg=JTrainState.create(jlora, jtx_g), jd=JTrainState.create(jd_params, jtx_d),
                jsteps={"g": g_step, "d": d_step,
                        "pair": jadv.build_flow_adv_fused_pair(*parts)})


# ---------------------------------------------------------------------------
# the taps and the heads
# ---------------------------------------------------------------------------


def _tap_inputs(sd3):
    x = np.random.default_rng(63).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ts = np.array([999.0, 261.5], np.float32)
    b = sd3["batch"]
    return x, ts, {"prompt_embeds": b["prompt_embeds"], "pooled": b["pooled_embeds"]}


@pytest.mark.parametrize("stop_after_mid", [False, True], ids=["all", "stop_after_mid"])
def test_sd3_teacher_features_match_jax_sow(sd3, stop_after_mid):
    """`SD3Bundle.teacher_features` (through `MMDiT.features`) against the
    JAX model's sown ``block_{i}``: the image stream (B, S, C) after each
    joint block; ``stop_after_mid`` is taken and ignored, as JAX does."""
    x, ts, cond = _tap_inputs(sd3)
    with jax_reference_ops():
        ref = jax.jit(lambda x_, t_, c_: sd3["jb"].teacher_features(sd3["jfrozen"], x_, t_, c_))(
            jnp.asarray(x), jnp.asarray(ts), {k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        got = sd3["pb"].teacher_features(sd3["pfrozen"], t(x), t(ts),
                                         {k: t(v) for k, v in cond.items()}, stop_after_mid)
    assert set(got) == set(ref) == {"block_0", "block_1"}
    assert {k: f.shape[-1] for k, f in got.items()} == sd3["pb"].tap_channels()
    for k, f in got.items():
        assert tuple(f.shape) == ref[k].shape == (2, 16, 32), k
        assert rel_max(f, ref[k]) < 1e-4, k


def test_mmdit_features_under_remat(sd3):
    """With ``remat`` the taps run through the checkpointed blocks: the same
    taps and the same gradient in the latents as without; the full-width
    config taps 24 blocks of 1536 channels."""
    x, ts, cond = _tap_inputs(sd3)
    model = sd3["pfrozen"]["mmdit"]
    args = (t(ts), t(cond["prompt_embeds"]), t(cond["pooled"]))
    runs = []
    for remat in (False, True):
        model.remat = remat
        xg = t(x).requires_grad_(True)
        taps = model.features(xg, *args)
        (grad,) = torch.autograd.grad(sum(f.square().sum() for f in taps.values()), [xg])
        runs.append((taps, grad))
    model.remat = False
    (plain, g0), (remat, g1) = runs
    for k in plain:
        assert rel_max(remat[k].detach(), plain[k].detach()) <= 1e-6, k
    assert float(g0.abs().max()) > 0 and rel_max(g1, g0) <= 1e-6
    assert mmdit.SD3_MEDIUM_CONFIG.tap_channels() == {f"block_{i}": 1536 for i in range(24)}


def test_sd3_discriminator_matches_jax(sd3):
    """The 2-tap TINY heads (seq taps (B, 16, 32) as 4x4 grids) against flax;
    the full config is JAX's `SD3_DISC_CONFIG` (24 taps, one 1x1 head each)."""
    assert dataclasses.asdict(families.disc_config("sd3")) == \
        dataclasses.asdict(jadv.SD3_DISC_CONFIG)
    rng = np.random.default_rng(64)
    feats = {f"block_{i}": rng.standard_normal((2, 16, 32), dtype=np.float32) for i in range(2)}
    jparams = sd3["jd"].params
    ref = jax.jit(sd3["jdisc"].apply)({"params": jparams},
                                      {k: jnp.asarray(v) for k, v in feats.items()})
    got = sd3["disc"].logits(convert.disc_state_from_jax(_np_tree(jparams)),
                             {k: t(v) for k, v in feats.items()})
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape == (2, 4, 4, 1)
        assert rel_max(a, b) < 1e-5


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _jax_flow_draws(key, batch, cfg):
    """The draws of one microbatch of the JAX flow adversarial steps from the
    key their grad_fn gets: ``flow_prepare``'s (`pcm_tpu/train/distill.py:233-243`)
    from the first half of a split, the offset on the grid and the two
    renoising noises from the second (`pcm_tpu/train/adv.py:469-477`)."""
    r, r_adv = jax.random.split(key)
    _, r_noise, r_idx, r_w = jax.random.split(r, 4)
    lat = batch["latents"]
    bsz = lat.shape[0]
    r_t, r_fake, r_real = jax.random.split(r_adv, 3)
    draws = {"noise": jax.random.normal(r_noise, lat.shape, lat.dtype),
             "index": jax.random.randint(r_idx, (bsz,), 0, cfg.num_solver_steps),
             "w": jdistill._sample_w(cfg, r_w, bsz, jnp.float32),
             "adv_offset": jax.random.randint(r_t, (bsz,), 0,
                                              cfg.num_solver_steps // cfg.multiphase),
             "eps_fake": jax.random.normal(r_fake, lat.shape, lat.dtype),
             "eps_real": jax.random.normal(r_real, lat.shape, lat.dtype)}
    return [{k: t(v) for k, v in draws.items()}]


def _port_steps(m, tx_g, tx_d):
    parts = (m["pb"], make_flow_schedule(shift=3.0), m["pcfg"], adv.AdvConfig(0.1), m["disc"],
             tx_g, tx_d)
    g_step, d_step = adv.build_flow_adv_steps(*parts)
    return {"g": g_step, "d": d_step, "pair": adv.build_flow_adv_fused_pair(*parts)}


def _states(m, tx_g, tx_d):
    g = convert.train_state_from_jax(m["jg"])
    d = convert.train_state_from_jax(m["jd"], convert.disc_state_from_jax)
    return (TrainState(0, g.params, tx_g.init(g.params)),
            TrainState(0, d.params, tx_d.init(d.params)))


@pytest.mark.parametrize("kind", ["g", "d", "pair"], ids=["g_step", "d_step", "fused_pair"])
def test_flow_adv_step_matches_jax(sd3, kind):
    """One flow G step, D step or fused pair on both sides from the same
    states, the JAX draws fed to the port (the D step's key folds in the
    heads' step and 7): the losses, the grad norms, Adam's first moment
    rel-max leaf by leaf (a head leaf whose reference gradient is below 1e-6
    of its tree's largest is round-off, as in `tests/test_torch_adv.py`: a
    conv bias ahead of a GroupNorm of one channel a group) and the params
    after the update. The LoRA on the last block's context queries has no
    gradient in either package: that block returns no context, so its
    context queries reach no tap and no velocity."""
    m = sd3
    key = jax.random.PRNGKey(65)
    with jax_reference_ops():
        jnew = jax.jit(m["jsteps"][kind])(m["jg"], m["jd"], m["jfrozen"], m["jbatch"], key)
    step_key = jax.random.fold_in(key, 0)
    if kind == "d":
        step_key = jax.random.fold_in(step_key, 7)
    draws = _jax_flow_draws(step_key, m["jbatch"], m["jcfg"])

    tx_g, tx_d = make_optimizer(LR, eps=EPS), make_optimizer(LR, b1=0.0, eps=EPS)
    g0, d0 = _states(m, tx_g, tx_d)
    pnew = _port_steps(m, tx_g, tx_d)[kind](g0, d0, m["pfrozen"],
                                            {k: t(v) for k, v in m["batch"].items()}, draws)
    jmetrics, pmetrics = jnew[-1], pnew[-1]
    assert set(pmetrics) == set(jmetrics)
    for k in pmetrics:
        rtol = 1e-3 if k.endswith("grad_norm") else 1e-5
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=rtol, err_msg=k)
    pairs = {"g": [("g", 0, convert.lora_state_from_jax)],
             "d": [("d", 0, convert.disc_state_from_jax)],
             "pair": [("g", 0, convert.lora_state_from_jax),
                      ("d", 1, convert.disc_state_from_jax)]}[kind]
    for which, i, conv in pairs:
        ps, js = pnew[i], jnew[i]
        assert ps.step == 1
        ref_mu = conv(_np_tree(convert._find_adam(js.opt_state).mu))
        ref_params = conv(_np_tree(js.params))
        top = max(float(ref_mu[k].abs().max()) for k in ps.params)
        roundoff = [k for k in ps.params if float(ref_mu[k].abs().max()) < 1e-6 * top]
        assert which == "d" or set(roundoff) == CONTEXT_QUERY_OF_LAST_BLOCK, roundoff
        for k in CONTEXT_QUERY_OF_LAST_BLOCK & set(roundoff):
            assert float(ps.opt_state["mu"][k].abs().max()) < 1e-6 * top, k
        for k in ps.params:
            if k not in roundoff:
                assert rel_max(ps.opt_state["mu"][k], ref_mu[k]) < 1e-3, (which, k)
        for k, p in ps.params.items():
            np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)
        before = (g0 if which == "g" else d0).params
        assert max(float((ps.params[k] - before[k]).abs().max()) for k in before) > 1e-6
    if which == "g" or kind == "pair":
        assert "pos_embed.proj.lora_a" in pnew[0].params  # the adversarial LoRA list


CONTEXT_QUERY_OF_LAST_BLOCK = {"transformer_blocks.1.add_q_proj.lora_a",
                               "transformer_blocks.1.add_q_proj.lora_b"}


class _Grads:
    """An optimizer that keeps the grads it is given and moves nothing."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        self.grads = grads
        return dict(params), state, torch.zeros(())


def test_flow_fused_pair_grads_equal_unfused_steps(sd3):
    """On the same draws and states, the flow fused pair's LoRA grads are the
    G step's and its heads' grads the D step's."""
    m = sd3
    draws = _jax_flow_draws(jax.random.PRNGKey(66), m["jbatch"], m["jcfg"])
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
            assert rel_max(g, unfused[k]) <= 1e-6, k


@pytest.mark.parametrize("recipe", ["sd3_1phase_adv", "sd3_2phase_adv", "sd3_4phase_adv",
                                    "sd3_adv_stochastic"])
def test_sample_draws_flow_span(recipe):
    """The flow steps' offset counts grid points: over [0, num_solver_steps
    // multiphase), so every ``end_index + offset`` lies on the 100-point
    grid, and the span is reached; DDIM's span stays T // multiphase."""
    cfg = families.RECIPES[recipe].distill
    sched = make_flow_schedule(shift=3.0)
    span = adv.adv_offset_span(sched, cfg)
    assert span == 100 // cfg.multiphase
    solver = PhasedEulerSolver.create(sched, cfg.num_solver_steps)
    dr = distill.sample_draws(cfg, torch.Generator().manual_seed(67), torch.zeros(4096, 1, 1, 1),
                              span)
    x = torch.zeros(4096, 1, 1, 1)
    _, end_index = solver.multiphase_pred(x, x, dr["index"], cfg.multiphase, is_target=True)
    adv_index = end_index + dr["adv_offset"]
    assert int(adv_index.min()) >= 0 and int(adv_index.max()) < solver.num_steps == 100
    assert int(dr["adv_offset"].max()) == span - 1
    assert adv.adv_offset_span(make_ddpm_schedule(), cfg) == 1000 // cfg.multiphase


# ---------------------------------------------------------------------------
# the cache, the training entry point, kohya files and serving them
# ---------------------------------------------------------------------------


def _png_folder(root, n=4):
    from pcm_tpu_torch.serving.server import png_bytes

    root.mkdir()
    rng = np.random.default_rng(68)
    for i in range(n):
        h, w = (16, 16) if i % 2 else (20, 24)
        (root / f"im{i}.png").write_bytes(png_bytes(rng.integers(0, 256, (h, w, 3), np.uint8)))
        (root / f"im{i}.txt").write_text(f"caption {i}")
    return str(root)


def _write_cache(path, n=4):
    rng = np.random.default_rng(69)
    path.mkdir()
    np.savez(path / "shard_00000.npz",
             latents=rng.standard_normal((n, 8, 8, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((n, 154, 32)).astype(np.float16),
             pooled_embeds=rng.standard_normal((n, 32)).astype(np.float16))
    return str(path)


def _train(tmp_path, recipe, pairing, source, steps=4, *extra):
    flag = "--cached-latents-dir" if source.endswith("cache") else "--train-data-dir"
    return train_main(["--recipe", recipe, "--tiny", "--device", "cpu", flag, source,
                       "--resolution", "16", "--output-dir", str(tmp_path / "run"),
                       "--batch-size", "2", "--max-train-steps", str(steps), "--log-every", "1",
                       "--checkpointing-steps", "2", "--adv-pairing", pairing,
                       "--dataloader-workers", "1", *extra])


def _adv_layers(stochastic=False):
    """The kohya layer keys of the TINY MMDiT's adversarial LoRA list."""
    pb = families.sd3_bundle(RANK, tiny=True, adv_targets=True, stochastic=stochastic)
    _, template = pb.init(torch.Generator().manual_seed(0), CPU, modules=("mmdit",))
    return {kohya.kohya_key(k[:-len(".lora_a")], "lora_transformer") for k in template
            if k.endswith(".lora_a")}


def test_sd3_cache_feeds_both_readers(tmp_path):
    """``python -m pcm_tpu_torch.data.cache_latents --family sd3`` (tiny,
    CPU, center crop): ``latents``, ``prompt_embeds`` (154 tokens of the
    joint width) and ``pooled_embeds``, read alike by both packages' readers."""
    imgs = _png_folder(tmp_path / "imgs")
    argv = ["--family", "sd3", "--tiny", "--device", "cpu", "--train-data-dir", imgs,
            "--resolution", "16", "--batch", "2", "--seed", "3", "--output-dir",
            str(tmp_path / "cache")]
    assert cache_latents.main(argv) == 0
    from pcm_tpu_torch.data.cached import CachedLatentsDataset

    ours, ref = CachedLatentsDataset(str(tmp_path / "cache")), JCached(str(tmp_path / "cache"))
    assert len(ours) == len(ref) == 4
    for i in range(4):
        a, b = ours.get(i), ref.get(i)
        assert {k: v.shape for k, v in a.items()} == {
            "latents": (8, 8, 4), "prompt_embeds": (154, 32), "pooled_embeds": (32,)}
        for k in a:
            assert np.isfinite(a[k]).all()
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pairing", ["fused", "fresh"])
@pytest.mark.parametrize("source", ["cache", "pixels"])
def test_train_cli_sd3_adv(tmp_path, pairing, source):
    """``sd3_4phase_adv`` through the CLI's ``main`` for 4 global steps on a
    cache (the towers freed after the uncond encode) or 2 from PNGs (every
    module kept): finite ``loss`` and ``d_loss``, the LoRA and the heads
    moved, and kohya files under ``lora_transformer`` at each save that hold
    the adversarial list's layers, ``pos_embed.proj`` included."""
    data = (_write_cache(tmp_path / "cache") if source == "cache"
            else _png_folder(tmp_path / "imgs"))
    steps = 4 if source == "cache" else 2
    trainer = _train(tmp_path, "sd3_4phase_adv", pairing, data, steps)
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    losses = [r[k] for r in rows for k in ("loss", "d_loss") if k in r]
    assert trainer.global_step == steps and rows[-1]["step"] == steps
    assert {"loss", "d_loss"} <= {k for r in rows for k in r} and all(np.isfinite(losses))
    assert (trainer.state.step, trainer.d_state.step) == (steps // 2, steps // 2)
    assert sorted(trainer.frozen) == (["mmdit"] if source == "cache"
                                      else ["mmdit", "t5", "text", "text2", "vae"])
    assert max(float(v.abs().max()) for k, v in trainer.state.params.items()
               if k.endswith("lora_b")) > 0
    _, init = adv.init_discriminator(families.disc_config("sd3", True),
                                     mmdit.TINY_MMDIT_CONFIG.tap_channels(),
                                     torch.Generator().manual_seed(43), CPU)
    assert max(float((trainer.d_state.params[k] - v).abs().max()) for k, v in init.items()) > 0
    for s in range(2, steps + 1, 2):
        path = str(tmp_path / "run" / f"pcm_lora_{s:07d}.safetensors")
        from pcm_tpu_torch.utils.safetensors import read_header

        assert set(kohya.kohya_layers(read_header(path))) == _adv_layers()
        assert "lora_transformer_pos_embed_proj" in _adv_layers()


def test_train_cli_sd3_adv_stochastic_serves_without_pos_embed(tmp_path):
    """``sd3_adv_stochastic`` trains on the stochastic-adversarial list: its
    file lacks ``pos_embed.proj``, and ``--family sd3 --lora`` serves it on
    that list, every layer of it."""
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, sd3_lora_targets

    _train(tmp_path, "sd3_adv_stochastic", "fused", _write_cache(tmp_path / "cache"), 2)
    path = str(tmp_path / "run" / "pcm_lora_0000002.safetensors")
    layers = _adv_layers(stochastic=True)
    assert "lora_transformer_pos_embed_proj" not in layers
    assert sd3_lora_targets(path, tiny=True) == {"adv_targets": True, "stochastic": True}
    engine = build_engine(build_parser().parse_args(
        ["--family", "sd3", "--tiny", "--device", "cpu", "--lora", path, "--batch-size", "1",
         "--resolution", "16"]))
    assert {kohya.kohya_key(k[:-len(".lora_a")], "lora_transformer") for k in engine.lora
            if k.endswith(".lora_a")} == layers


def test_train_cli_sd3_adv_resumes_heads(tmp_path, capsys):
    """A resumed fresh run restores the heads, their optimizer and the global
    step, and goes on with a D update then a G update."""
    cache = _write_cache(tmp_path / "cache")
    first = _train(tmp_path, "sd3_4phase_adv", "fresh", cache, 2)
    heads = {k: v.clone() for k, v in first.d_state.params.items()}
    capsys.readouterr()
    trainer = _train(tmp_path, "sd3_4phase_adv", "fresh", cache, 4)
    assert trainer.resumed_from == 2 and "resumed at step 2" in capsys.readouterr().out
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert "d_loss" in rows[2] and "loss" in rows[3]
    assert (trainer.state.step, trainer.d_state.step) == (2, 2)
    ck = torch.load(tmp_path / "run" / "checkpoints" / "step_0000002.pt", weights_only=True)
    for k, v in ck["d_params"].items():
        assert torch.equal(v, heads[k]), k


@pytest.mark.parametrize("mode", ["scoped", "dense", "fused"])
def test_train_cli_int8_with_sd3(tmp_path, capsys, mode):
    """``--recipe sd3_4phase_adv --frozen-weights int8 --int8-matmul <mode>``
    (refused before): two global steps of the fused pair, finite losses, the
    MMDiT on int8 weights (``pos_embed.proj`` too), the LoRA and the heads
    moved."""
    trainer = _train(tmp_path, "sd3_4phase_adv", "fused", _write_cache(tmp_path / "cache"), 2,
                     "--frozen-weights", "int8", "--int8-matmul", mode)
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and f"int8 matmul {mode}" in printed
    assert "step 2:" in printed and "nan" not in printed
    mm = trainer.frozen["mmdit"]
    assert mm.pos_embed.proj.weight_values.dtype == torch.int8
    assert mm.transformer_blocks[0].to_q.weight is None
    assert trainer.distill_cfg.int8_no_grad_fwd == (mode == "scoped")
    assert max(float(p.abs().max()) for k, p in trainer.state.params.items()
               if k.endswith("lora_b")) > 0
    assert trainer.d_state.step == 1


def test_serve_sd3_adversarial_file_tiny_cpu(tmp_path, capsys):
    """``--family sd3 --lora <adversarial file>`` serves every layer of the
    file (its factors as written, fp16); the image differs from the one of
    the file's base-list subset; a base-list engine refuses the whole file,
    naming layers outside its adapter; a file of no target list is refused.
    The run trains at lr 1e-2: the recipe's 5e-6 moves a fresh adapter too
    little in one update to change a served image."""
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, main
    from pcm_tpu_torch.utils import safetensors

    _train(tmp_path, "sd3_4phase_adv", "fused", _write_cache(tmp_path / "cache"), 2,
           "--learning-rate", "1e-2")
    path = str(tmp_path / "run" / "pcm_lora_0000002.safetensors")
    state = safetensors.load_file(path)
    base = {k: v for k, v in state.items()
            if not any(s in k for s in ("add_", "ff_context", "norm1", "embedder", "pos_embed"))}
    base_path, odd_path = str(tmp_path / "base.safetensors"), str(tmp_path / "odd.safetensors")
    safetensors.save_file(base, base_path)
    safetensors.save_file({k: v for k, v in state.items() if "pos_embed" not in k
                           and "transformer_blocks_0_to_q" not in k}, odd_path)

    def engine(lora):
        return build_engine(build_parser().parse_args(
            ["--family", "sd3", "--tiny", "--device", "cpu", "--lora", lora, "--batch-size", "1",
             "--resolution", "16"]))

    adv_engine, base_engine = engine(path), engine(base_path)
    got = {k: v for k, v in adv_engine.lora.items()}
    assert {kohya.kohya_key(k[:-len(".lora_a")], "lora_transformer") for k in got
            if k.endswith(".lora_a")} == _adv_layers()
    ref, _ = kohya.from_kohya_state_dict({k: v.astype(np.float32) for k, v in state.items()},
                                         got, RANK, "lora_transformer")
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    img, base_img = (e.generate_batch(["a red square"], [7]) for e in (adv_engine, base_engine))
    assert (img != base_img).any()
    with pytest.raises(ValueError, match="outside the adapter's template"):
        base_engine.load_lora(path)
    with pytest.raises(SystemExit) as e:
        main(["--family", "sd3", "--tiny", "--device", "cpu", "--lora", odd_path])
    assert e.value.code != 0 and "none of the SD3 target lists" in capsys.readouterr().err


def test_kohya_import_refuses_layers_outside_the_template(sd3, tmp_path):
    """A JAX-made file of the base list loads into the port's base template;
    one of the adversarial list is refused there, up to three of its extra
    layers named, and loads into the adversarial template."""
    jbase = jfamilies.sd3_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True)
    with jax_reference_ops():
        _, jlora_base = random_params(lambda r: jbase.init(r), seed=70)
    base_tmpl = convert.lora_state_from_jax(_np_tree(jlora_base))
    adv_tmpl = convert.lora_state_from_jax(_np_tree(sd3["jlora"]))
    paths = {}
    for name, tree in (("base", jlora_base), ("adv", sd3["jlora"])):
        paths[name] = str(tmp_path / f"{name}.safetensors")
        jkohya.save_kohya_safetensors(paths[name], _np_tree(tree), 8.0, prefix="lora_transformer")
    tree, alpha = kohya.load_kohya_safetensors(paths["base"], base_tmpl, RANK, "lora_transformer")
    assert alpha == 8.0 and tree.keys() == base_tmpl.keys()
    with pytest.raises(ValueError, match=r"holds \d+ layers outside") as e:
        kohya.load_kohya_safetensors(paths["adv"], base_tmpl, RANK, "lora_transformer")
    assert str(e.value).count("lora_transformer_") == 3
    tree, _ = kohya.load_kohya_safetensors(paths["adv"], adv_tmpl, RANK, "lora_transformer")
    assert tree.keys() == adv_tmpl.keys()
