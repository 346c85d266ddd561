"""The port's inference additions against `pcm_tpu` (CPU, fp32, TINY sizes):
the TCD sampler and a TCD pipeline, hub weights through ``python -m
pcm_tpu_torch.port_weights``, the trainer's image grids, and ``python -m
pcm_tpu_torch.generate`` for each family and scheduler.

Bounds: TCD's timesteps and alpha tables equal, a step 1e-6; the TINY
SD1.5 TCD pipeline's images 1e-3 (as `tests/test_torch_serving.py` holds
the DDIM pipeline), JAX's key splits replayed and its draws fed in.
`port_weights`: every tensor it writes equal to what the JAX converters
read from the same files, and the modules loaded from its file against the
JAX modules (plain ops) loaded from the converted trees, forward rel-max
1e-5. The grid PNG equal to the JAX logger's pixel for pixel.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcm_tpu.configs import families as jfamilies
from pcm_tpu.core import make_ddpm_schedule as jax_make_ddpm_schedule
from pcm_tpu.models.clip import convert_clip_torch_state
from pcm_tpu.models.convert import (convert_mmdit_torch_state, convert_unet_torch_state,
                                    convert_vae_torch_state)
from pcm_tpu.models.t5 import convert_t5_torch_state
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.sampling import TCDSampler as JTCDSampler
from pcm_tpu.sampling import TextToImagePipeline as JPipeline
from pcm_tpu.utils.logging import MetricsLogger as JMetricsLogger
from pcm_tpu_torch import generate, port_weights
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.lora.kohya import save_kohya_safetensors
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.sampling.ddim import DDIMSampler, TCDSampler
from pcm_tpu_torch.sampling.pipeline import TextToImagePipeline
from pcm_tpu_torch.train.bundles import adapter_like
from pcm_tpu_torch.utils import safetensors
from pcm_tpu_torch.utils.logging import MetricsLogger
from torch_port_helpers import random_params, rel_max

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# TCD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [0.0, 0.3])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_tcd_tables_match_jax(steps, gamma):
    js = JTCDSampler.create(jax_make_ddpm_schedule(), steps, gamma)
    ps = TCDSampler.create(make_ddpm_schedule(), steps, gamma)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    for name in ("alphas", "alphas_prev", "alphas_s"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      np.float32(getattr(ps, name)))
    assert ps.num_steps == steps and ps.gamma == gamma


@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_tcd_step_matches_jax(gamma, prediction, steps):
    """Every step of the sampler fed JAX's renoise (the normal draw of the
    step's key); gamma 0 and the final step return x_s and draw nothing."""
    js = JTCDSampler.create(jax_make_ddpm_schedule(prediction_type=prediction), steps, gamma)
    ps = TCDSampler.create(make_ddpm_schedule(prediction_type=prediction), steps, gamma)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(5)
    for i in range(steps):
        x, out = (rng.standard_normal((2, 4, 4, 4), dtype=np.float32) for _ in range(2))
        key, k = jax.random.split(key)
        ref = js.step(jnp.asarray(out), i, jnp.asarray(x), k)
        drawn = i < steps - 1 and gamma > 0
        renoise = t(jax.random.normal(k, x.shape, jnp.float32)) if drawn else None
        ours = ps.step(t(out), i, t(x), renoise)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
        if drawn:
            with pytest.raises(ValueError, match="renoise"):
                ps.step(t(out), i, t(x))


@pytest.fixture(scope="module")
def sd15():
    jb = jfamilies.sd15_bundle(lora_rank=RANK, dtype=jnp.float32, remat=False, tiny=True)
    jfrozen, jlora = random_params(lambda r: jb.init(r), seed=11)
    pb = families.sd15_bundle(lora_rank=RANK, dtype=torch.float32, tiny=True)
    states = {"unet": convert.unet_state_from_jax(jfrozen["unet"]),
              "vae": convert.vae_state_from_jax(jfrozen["vae"]),
              "text": convert.clip_state_from_jax(jfrozen["text"], pb.text_cfg)}
    return dict(jb=jb, jfrozen=jfrozen, jlora=jlora, pb=pb, pfrozen=pb.from_states(states, CPU),
                plora=convert.lora_state_from_jax(jlora))


class _Fed:
    """A port sampler fed, at each step, the draw JAX's pipeline makes there."""

    def __init__(self, sampler, draws):
        self.sampler, self.draws = sampler, draws
        self.timesteps = sampler.timesteps

    def step(self, model_output, i, sample, rng=None):
        return self.sampler.step(model_output, i, sample, self.draws[i])


@pytest.mark.parametrize("with_lora,guidance", [(True, 1.0), (False, 7.5)],
                         ids=["student", "teacher_cfg"])
def test_tcd_pipeline_matches_jax(sd15, with_lora, guidance):
    """`pcm_tpu/sampling/pipeline.py:generate` with TCD at 3 steps: its
    key splits (`:73`, `:104`) replayed and each step's normal draw fed to
    the port's sampler."""
    steps = 3
    ids, empty = HashTokenizer()(["a red square", "a blue circle"]), HashTokenizer()(["", ""])
    init = np.random.default_rng(12).standard_normal((2, 8, 8, 4), dtype=np.float32)
    jb, jfrozen = sd15["jb"], sd15["jfrozen"]
    jpipe = JPipeline(jb, JTCDSampler.create(jax_make_ddpm_schedule(), steps))
    key = jax.random.PRNGKey(21)
    with jax_reference_ops():
        gen = jax.jit(lambda fr, lo, c, u, i: jpipe.generate(fr, lo, c, u, key, 8, guidance,
                                                             init_latents=i))
        ref = gen(jfrozen, sd15["jlora"] if with_lora else None,
                  jb.encode_prompts(jfrozen, jnp.asarray(ids)),
                  jb.encode_prompts(jfrozen, jnp.asarray(empty)), jnp.asarray(init))
    _, r_loop = jax.random.split(key)
    draws = []
    for _ in range(steps):
        r_loop, r_step = jax.random.split(r_loop)
        draws.append(t(jax.random.normal(r_step, init.shape, jnp.float32)))

    pb, frozen = sd15["pb"], sd15["pfrozen"]
    pipe = TextToImagePipeline(pb, _Fed(TCDSampler.create(make_ddpm_schedule(), steps), draws))
    with torch.no_grad():
        cond = pb.encode_prompts(frozen, t(ids).long())
        uncond = pb.encode_prompts(frozen, t(empty).long())
    out = pipe.generate(frozen, sd15["plora"] if with_lora else None, cond, uncond, t(init),
                        guidance)
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < 1e-3
    ddim = TextToImagePipeline(pb, DDIMSampler.create(make_ddpm_schedule(), steps)).generate(
        frozen, sd15["plora"] if with_lora else None, cond, uncond, t(init), guidance)
    assert rel_max(out, ddim) > 1e-2  # the renoise acts


# ---------------------------------------------------------------------------
# port_weights
# ---------------------------------------------------------------------------

# each module's file dtype; T5 in two shards
STORED = {"unet": "F32", "mmdit": "F16", "vae": "F16", "text": "BF16", "text2": "F32",
          "t5": "BF16"}
TORCH_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
FORWARD_TOL = 1e-5  # rel-max, fp32
JAX_CONVERTERS = {"unet": lambda sd, jb: convert_unet_torch_state(sd, jb.unet_cfg),
                  "mmdit": lambda sd, jb: convert_mmdit_torch_state(sd, jb.mmdit_cfg),
                  "vae": lambda sd, jb: convert_vae_torch_state(sd, jb.vae_cfg),
                  "text": lambda sd, jb: convert_clip_torch_state(sd, jb.text_cfg),
                  "text2": lambda sd, jb: convert_clip_torch_state(sd, jb.text2_cfg),
                  "t5": lambda sd, jb: convert_t5_torch_state(sd, jb.t5_cfg)}
JAX_BUNDLES = {"sd15": jfamilies.sd15_bundle, "sdxl": jfamilies.sdxl_bundle,
               "sd3": jfamilies.sd3_bundle}
PORT_BUNDLES = {"sd15": families.sd15_bundle, "sdxl": families.sdxl_bundle,
                "sd3": families.sd3_bundle}


def _port_state(module, tree, pb):
    """A JAX module tree as the port's state dict (`models/convert.py`)."""
    if module in ("text", "text2"):
        return convert.clip_state_from_jax(tree, getattr(pb, module + "_cfg"))
    if module == "t5":
        return convert.t5_state_from_jax(tree, pb.t5_cfg)
    return {"unet": convert.unet_state_from_jax, "vae": convert.vae_state_from_jax,
            "mmdit": convert.mmdit_state_from_jax}[module](tree)


def _hub_state(module, tree, pb):
    """The module's tensors under the hub's names, fp32 numpy: the port's
    state dict with the MMDiT's names and position table as diffusers keeps
    them."""
    out = {}
    for k, v in _port_state(module, tree, pb).items():
        v = v.numpy()
        if module == "mmdit" and k == "pos_embed.pos_embed":
            v = v.reshape(1, -1, v.shape[-1])
        out[port_weights.file_key(module, k)] = v
    return out


def _bf16_bits(a):
    """fp32 -> bf16 bit patterns, rounded to nearest even."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _write_hub(folder, module, sd, shards=1):
    """``sd`` as ``folder/<module>/model-<i>.safetensors`` in the module's
    `STORED` dtype (CLIP files with an int64 ``position_ids``); returns the
    fp32 values the files hold."""
    os.makedirs(os.path.join(folder, module), exist_ok=True)
    held, stored = {}, {}
    for k, v in sd.items():
        if STORED[module] == "F16":
            stored[k] = v.astype(np.float16)
            held[k] = stored[k].astype(np.float32)
        elif STORED[module] == "BF16":
            stored[k] = _bf16_bits(v)
            held[k] = safetensors.bf16_to_f32(stored[k])
        else:
            stored[k] = held[k] = v.astype(np.float32)
    names = sorted(stored)
    for i in range(shards):
        part = {k: stored[k] for k in names[i::shards]}
        bf16 = tuple(part) if STORED[module] == "BF16" else ()
        if module in ("text", "text2") and i == 0:
            part["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        safetensors.save_file(part, os.path.join(folder, module, f"model-{i:05d}.safetensors"),
                              bf16=bf16)
    return held


@pytest.fixture(scope="module", params=["sd15", "sdxl", "sd3"])
def ported(request, tmp_path_factory):
    """One family: numpy-drawn JAX weights written as a seeded hub folder,
    the JAX converters' trees of its files, and the port_weights file."""
    family = request.param
    folder = str(tmp_path_factory.mktemp(family))
    jb = JAX_BUNDLES[family](RANK, dtype=jnp.float32, remat=False, tiny=True)
    pb = PORT_BUNDLES[family](RANK, dtype=torch.float32, tiny=True)
    with jax_reference_ops():
        jfrozen, _ = random_params(lambda r: jb.init(r), seed=31)
    modules = port_weights.FAMILY_MODULES[family]
    converted, argv = {}, ["--family", family, "--tiny"]
    for module, flag in modules:
        held = _write_hub(folder, module, _hub_state(module, jfrozen[module], pb),
                          shards=2 if module == "t5" else 1)
        converted[module] = JAX_CONVERTERS[module](held, jb)
        argv += [f"--{flag}", os.path.join(folder, module, "*.safetensors")]
    out = os.path.join(folder, "teacher.pt")
    port_weights.main(argv + ["--output", out])
    return dict(family=family, folder=folder, jb=jb, pb=pb, converted=converted, out=out,
                argv=argv)


def test_port_weights_reads_what_jax_reads(ported):
    """Every tensor of the written file keeps its hub file's dtype and
    equals the JAX converter's tree of the same files (carried to the port's
    layout), bit for bit, and a T5 split into two shards merges whole."""
    states = torch.load(ported["out"], weights_only=True)
    assert sorted(states) == sorted(m for m, _ in port_weights.FAMILY_MODULES[ported["family"]])
    for module, tree in ported["converted"].items():
        ref = _port_state(module, jax.tree.map(np.asarray, tree), ported["pb"])
        assert sorted(states[module]) == sorted(ref), module
        for k, v in ref.items():
            assert states[module][k].dtype == TORCH_DTYPES[STORED[module]], k
            torch.testing.assert_close(states[module][k].float(), v, rtol=0, atol=0, msg=k)
    assert len(glob.glob(os.path.join(ported["folder"], "t5", "*"))) == (
        2 if ported["family"] == "sd3" else 0)


def test_port_weights_modules_match_jax(ported):
    """The port's bundle loaded from the file (``from_states``, as
    ``--teacher-checkpoint`` loads it) against the JAX bundle on the
    converted trees: the prompt encoding (every tower; SD3's T5 also
    alone), a teacher forward (UNet or MMDiT) on it and a decode."""
    jb, pb, family = ported["jb"], ported["pb"], ported["family"]
    jfrozen = ported["converted"]
    frozen = pb.from_states(torch.load(ported["out"], weights_only=True), CPU)
    prompts = ["a red square", "a much longer caption of a blue circle"]
    ids = [HashTokenizer()(prompts)] * {"sd15": 1, "sdxl": 2, "sd3": 3}[family]
    extra = [np.tile(np.array([16, 16, 0, 0, 16, 16], np.float32), (2, 1))] if family == "sdxl" \
        else []
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, pb.latent_channels), dtype=np.float32)
    ts = np.array([999.0, 421.0], np.float32)
    with jax_reference_ops():
        jcond = jb.encode_prompts(jfrozen, *map(jnp.asarray, ids + extra))
        jout = jb.teacher(jfrozen, jnp.asarray(x), jnp.asarray(ts), jcond)
        jdec = jb.decode_latents(jfrozen, jnp.asarray(x))
    with torch.no_grad():
        cond = pb.encode_prompts(frozen, *[t(i).long() for i in ids], *map(t, extra))
        out = pb.teacher(frozen, t(x), t(ts), cond)
        dec = pb.decode_latents(frozen, t(x))
    assert rel_max(cond["prompt_embeds"], jcond["prompt_embeds"]) < FORWARD_TOL
    assert rel_max(out, jout) < FORWARD_TOL
    assert rel_max(dec, jdec) < FORWARD_TOL
    if family == "sd3":
        from pcm_tpu.models.t5 import T5Encoder as JT5

        with jax_reference_ops():
            jt5 = JT5(jb.t5_cfg).apply({"params": jfrozen["t5"]}, jnp.asarray(ids[2]))
        with torch.no_grad():
            pt5 = frozen["t5"](t(ids[2]).long())
        assert rel_max(pt5, jt5) < FORWARD_TOL


@pytest.mark.parametrize("fault", ["missing", "shape", "extra"])
def test_port_weights_refuses_a_file_that_does_not_fit(tmp_path, capsys, fault):
    """A key the file lacks prints ``MISSING:`` naming it, one in the wrong
    shape ``SHAPE:``, an optional layer the module lacks ``EXTRA:``; each
    exits 1 and writes nothing."""
    pb = families.sd15_bundle(RANK, dtype=torch.float32, tiny=True)
    frozen, _ = pb.init(torch.Generator().manual_seed(0), CPU)
    argv = ["--family", "sd15", "--tiny", "--output", str(tmp_path / "t.pt")]
    for module in ("unet", "vae", "text"):
        sd = {k: v.numpy() for k, v in frozen[module].state_dict().items()}
        if module == "unet":
            key = "mid_block.resnets.0.conv1.weight"
            if fault == "missing":
                del sd[key]
            elif fault == "shape":
                sd[key] = sd[key][:, :-1]
            else:
                key = "mid_block.resnets.0.conv_shortcut.weight"
                sd[key] = np.zeros((1, 1, 1, 1), np.float32)
        os.makedirs(tmp_path / module)
        safetensors.save_file(sd, str(tmp_path / module / "m.safetensors"))
        argv += [f"--{module}", str(tmp_path / module / "*.safetensors")]
    with pytest.raises(SystemExit) as exc:
        port_weights.main(argv)
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert {"missing": "MISSING:", "shape": "SHAPE:", "extra": "EXTRA:"}[fault] in err
    assert key in err and not (tmp_path / "t.pt").exists()


def test_load_torch_casts_and_merges_in_sorted_order(tmp_path):
    """F32, F16, BF16 and int64 each in its file's dtype; a later file
    (sorted) overrides an earlier one's key."""
    a = np.array([1.5, -2.25], np.float32)
    safetensors.save_file({"x": a, "y": a.astype(np.float16), "ids": np.arange(3)},
                          str(tmp_path / "b.safetensors"))
    safetensors.save_file({"x": np.zeros(2, np.float32), "z": _bf16_bits(a)},
                          str(tmp_path / "a.safetensors"), bf16=("z",))
    got = safetensors.load_torch([str(tmp_path / "*.safetensors")])
    assert [got[k].dtype for k in ("x", "y", "z", "ids")] == [
        torch.float32, torch.float16, torch.bfloat16, torch.int64]
    assert got["x"].tolist() == got["y"].tolist() == got["z"].tolist() == [1.5, -2.25]
    assert got["ids"].tolist() == [0, 1, 2]
    with pytest.raises(FileNotFoundError):
        safetensors.load_torch([str(tmp_path / "none*.safetensors")])


# ---------------------------------------------------------------------------
# image grids
# ---------------------------------------------------------------------------


def test_log_images_matches_jax(tmp_path):
    """Six images (a partial second row) under a nested tag: the same PNG
    pixels as the JAX logger writes."""
    images = np.random.default_rng(2).uniform(-1.2, 1.2, (6, 8, 10, 3)).astype(np.float32)
    ours = MetricsLogger(str(tmp_path / "port")).log_images(12, "validation/cfg7.5", images)
    JMetricsLogger(str(tmp_path / "jax"), use_tensorboard=False).log_images(
        12, "validation/cfg7.5", images)
    assert ours == str(tmp_path / "port" / "images" / "validation" / "cfg7.5_0000012.png")
    ref = np.asarray(Image.open(tmp_path / "jax" / "images" / "validation" /
                                "cfg7.5_0000012.png"))
    got = np.asarray(Image.open(ours))
    assert got.shape == (16, 40, 3)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# python -m pcm_tpu_torch.generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """A seeded TINY teacher file and kohya LoRA of each family."""
    d = tmp_path_factory.mktemp("teachers")
    out = {}
    for family, make in PORT_BUNDLES.items():
        pb = make(dtype=torch.float32, tiny=True)
        gen = torch.Generator().manual_seed(3)
        frozen, template = pb.init(gen, CPU)
        torch.save({k: m.state_dict() for k, m in frozen.items()}, d / f"{family}.pt")
        save_kohya_safetensors(str(d / f"{family}_lora.safetensors"),
                               adapter_like(template, gen), pb.lora.alpha,
                               prefix=pb.KOHYA_PREFIX)
        out[family] = (str(d / f"{family}.pt"), str(d / f"{family}_lora.safetensors"))
    return out


@pytest.mark.parametrize("family,scheduler", [
    ("sd15", "ddim"), ("sd15", "tcd"), ("sdxl", "ddim"), ("sdxl", "tcd"), ("sd3", "fm_det"),
    ("sd3", "fm_stoch")])
def test_generate_cli_tiny(teachers, tmp_path, capsys, family, scheduler):
    """Two prompts with the kohya LoRA at guidance 2 (the negative prompt as
    uncond): two PNGs of the resolution; a rerun writes the same bytes,
    another seed other images."""
    ckpt, lora = teachers[family]
    argv = ["--family", family, "--teacher-checkpoint", ckpt, "--lora", lora, "--steps", "2",
            "--cfg", "2.0", "--scheduler", scheduler, "--tiny", "--device", "cpu",
            "--resolution", "16", "--negative-prompt", "blurry"]

    def run(out, *prompts, seed=0):
        generate.main(argv + ["--prompt", *prompts, "--seed", str(seed), "--out", str(out)])
        return sorted(glob.glob(str(out).replace(".png", "*.png")))

    paths = run(tmp_path / "a.png", "a red square", "a blue circle")
    assert [os.path.basename(p) for p in paths] == ["a_0.png", "a_1.png"]
    assert "wrote" in capsys.readouterr().out
    imgs = [np.asarray(Image.open(p)) for p in paths]
    assert imgs[0].shape == (16, 16, 3)
    again = run(tmp_path / "b.png", "a red square", "a blue circle")
    assert [open(p, "rb").read() for p in again] == [open(p, "rb").read() for p in paths]
    other = run(tmp_path / "c.png", "a red square", "a blue circle", seed=1)
    assert np.any(np.asarray(Image.open(other[0])) != imgs[0])


def test_generate_sd3_int8_tiny_cpu(tmp_path, capsys):
    """``generate --family sd3 --weights int8`` (refused before) on a TINY
    teacher file: PNGs, the same bytes on a rerun."""
    pb = families.sd3_bundle(dtype=torch.float32, tiny=True)
    frozen, _ = pb.init(torch.Generator().manual_seed(5), CPU)
    ckpt = str(tmp_path / "teacher.pt")
    torch.save({k: m.state_dict() for k, m in frozen.items()}, ckpt)
    argv = ["--family", "sd3", "--teacher-checkpoint", ckpt, "--steps", "2", "--tiny",
            "--device", "cpu", "--resolution", "16", "--weights", "int8", "--prompt",
            "a red square", "a blue circle"]
    runs = []
    for out in ("a.png", "b.png"):
        generate.main(argv + ["--out", str(tmp_path / out)])
        runs.append(sorted(glob.glob(str(tmp_path / out).replace(".png", "*.png"))))
    assert [os.path.basename(p) for p in runs[0]] == ["a_0.png", "a_1.png"]
    assert "wrote" in capsys.readouterr().out
    assert [open(p, "rb").read() for p in runs[0]] == [open(p, "rb").read() for p in runs[1]]


@pytest.mark.parametrize("extra,msg", [
    (["--family", "sd15", "--scheduler", "fm_stoch"], "is not one of"),
], ids=["scheduler_of_another_family"])
def test_generate_cli_refuses(tmp_path, capsys, extra, msg):
    with pytest.raises(SystemExit) as exc:
        generate.main([*extra, "--teacher-checkpoint", str(tmp_path / "x.pt"), "--prompt", "p",
                       "--tiny", "--device", "cpu"])
    assert exc.value.code != 0 and msg in capsys.readouterr().err


def test_port_weights_and_generate_run_without_jax(tmp_path):
    """``python -m pcm_tpu_torch.port_weights`` then ``python -m
    pcm_tpu_torch.generate`` on its file, as programs with jax made
    unimportable: a PNG, and no `pcm_tpu` module loaded."""
    pb = families.sd15_bundle(dtype=torch.float32, tiny=True)
    frozen, _ = pb.init(torch.Generator().manual_seed(1), CPU)
    flags = []
    for module in ("unet", "vae", "text"):
        os.makedirs(tmp_path / module)
        safetensors.save_file({k: v.numpy() for k, v in frozen[module].state_dict().items()},
                              str(tmp_path / module / "diffusion_model.safetensors"))
        flags += [f"--{module}", str(tmp_path / module / "*.safetensors")]
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "mod, sys.argv = sys.argv[1], sys.argv[1:]\n"
            "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
            "bad = [k for k in sys.modules if k.startswith('pcm_tpu.')]\n"
            "sys.exit(1 if bad else 0)")
    teacher = str(tmp_path / "teacher.pt")
    for argv in (["pcm_tpu_torch.port_weights", "--family", "sd15", "--tiny", "--output",
                  teacher, *flags],
                 ["pcm_tpu_torch.generate", "--family", "sd15", "--teacher-checkpoint", teacher,
                  "--prompt", "a cat", "--tiny", "--device", "cpu", "--resolution", "16",
                  "--scheduler", "tcd", "--out", str(tmp_path / "cat.png")]):
        res = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                             timeout=240, cwd=REPO)
        assert res.returncode == 0, res.stderr[-2000:]
    assert np.asarray(Image.open(tmp_path / "cat.png")).shape == (16, 16, 3)
