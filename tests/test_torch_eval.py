"""Evaluation and the demo in the port against `pcm_tpu` (CPU, fp32, TINY
sizes): the CLIP vision tower, its preprocessing and file loading, the text
features, FID, CLIP score, the safety checker, the two eval CLIs against the
JAX scripts, the demo's CLI loop against ``generate``, the UNet's
``time_cond_proj_dim`` and `StepTimer`.

Bounds: the vision tower, its file-loaded features and the text features
rtol 2e-4 / atol 3e-5 (`tests/test_clip_vision.py`'s); the resize of
`preprocess_images` 1e-5 absolute; the numpy statistics, FID and CLIP score
on the same features 1e-9 relative; the eval CLIs on features equal as
printed, on images (PNG, JPEG, BMP) through the port's decoders against PIL
within `IMAGE_FID_REL` / `IMAGE_SCORE_ABS` (pixels within the 3 LSB that
Lanczos keeps against PIL's two-rounding resize); the UNet 5e-4 relative
(`tests/test_torch_models.py`'s ``TOL``).
"""

import dataclasses
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from make_torch_image_fixtures import smooth
from pcm_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from pcm_tpu.models import clip_vision as jcv
from pcm_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from pcm_tpu.models.clip import CLIPTextModel as JCLIP
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.utils import clip_score as jcs
from pcm_tpu.utils import fid as jfid
from pcm_tpu.utils import profiling as jprofiling
from pcm_tpu.utils import safety as jsafety
from pcm_tpu_torch import demo, eval_clip_score, eval_fid, generate
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.lora.kohya import save_kohya_safetensors
from pcm_tpu_torch.models import clip_vision as cv
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.clip import CLIPTextConfig
from pcm_tpu_torch.models.unet import TINY_UNET_CONFIG, UNet2DCondition
from pcm_tpu_torch.utils import clip_score as cs
from pcm_tpu_torch.utils import fid, profiling, safety
from pcm_tpu_torch.utils.png import to_uint8
from pcm_tpu_torch.utils.safetensors import save_file
from torch_port_helpers import random_params, rel_max

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOWER = {"rtol": 2e-4, "atol": 3e-5}
# the eval CLIs on image folders, the port's decoders and Lanczos against
# PIL's: FID relative, CLIP score absolute (points of 100); 5x the largest
# reading here (FID 1.2e-4 with the pixel extractor, 9.6e-4 with the TINY
# tower; CLIP score 0.019)
IMAGE_FID_REL = 5e-3
IMAGE_SCORE_ABS = 0.1
# a 49408-token tower (the hashed ids' range) 32 wide, projecting to the TINY
# vision tower's 48: the eval CLIs' text tower in these tests
TINY_TEXT = dict(vocab_size=49408, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, projection_dim=48)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vision():
    """JAX TINY vision params and the port's state dict of them."""
    params = random_params(jcv.CLIPVisionModel(jcv.TINY_CLIP_VISION_CONFIG).init,
                           jnp.zeros((1, 32, 32, 3)), seed=21)["params"]
    return params, convert.clip_vision_state_from_jax(params, cv.TINY_CLIP_VISION_CONFIG)


@pytest.fixture(scope="module")
def text():
    """JAX params of the tiny projected text tower and the port's state dict."""
    jcfg = JCLIPTextConfig(**TINY_TEXT)
    params = random_params(JCLIP(jcfg).init, jnp.zeros((1, 77), jnp.int32), seed=22)["params"]
    return params, convert.clip_state_from_jax(params, CLIPTextConfig(**TINY_TEXT))


def _images(n, hw, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the tower, its preprocessing, files and features
# ---------------------------------------------------------------------------


def test_vision_tower_matches_jax(vision):
    params, state = vision
    port = cv.CLIPVisionModel(cv.TINY_CLIP_VISION_CONFIG)
    port.load_hf_state(state)
    pix = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    last, pooled = jcv.CLIPVisionModel(jcv.TINY_CLIP_VISION_CONFIG).apply(
        {"params": params}, jnp.asarray(pix))
    with torch.no_grad():
        ours_last, ours_pooled = port(torch.from_numpy(pix).permute(0, 3, 1, 2))
    assert ours_pooled.shape == (2, 48)
    np.testing.assert_allclose(ours_last.numpy(), np.asarray(last), **TOWER)
    np.testing.assert_allclose(ours_pooled.numpy(), np.asarray(pooled), **TOWER)


@pytest.mark.parametrize("hw,size", [(512, 224), (32, 16), (20, 32)],
                         ids=["512_to_224", "32_to_16", "20_to_32"])
def test_preprocess_matches_jax(hw, size):
    """Shrinking (``jax.image.resize`` antialiases: a plain bilinear resize
    would miss by far more) and enlarging, values outside [-1, 1] clipped."""
    x = np.random.default_rng(hw).uniform(-1.2, 1.2, (2, hw, hw, 3)).astype(np.float32)
    ref = jcv.preprocess_images(x, size)
    ours = cv.preprocess_images(x, size).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (2, size, size, 3)
    assert np.abs(ours - ref).max() <= 1e-5
    if hw > size:  # the antialiasing matters
        plain = torch.nn.functional.interpolate(
            torch.from_numpy((np.clip(x, -1, 1) + 1) / 2).permute(0, 3, 1, 2), size=(size, size),
            mode="bilinear", align_corners=False)
        plain = ((plain.permute(0, 2, 3, 1).numpy() - cv.CLIP_IMAGE_MEAN) / cv.CLIP_IMAGE_STD)
        assert np.abs(plain - ref).max() > 1e-2


def test_clip_features_from_file_match_jax(vision, tmp_path, capsys):
    """`CLIPFeatures.from_torch_file` on one ``.safetensors`` file against the
    JAX package's, images that need a resize; a ``.bin`` of the same state
    gives the same features; without weights, the seeded tower warns."""
    _, state = vision
    path = str(tmp_path / "vision.safetensors")
    save_file({k: v.numpy() for k, v in state.items()}, path)
    torch.save(state, str(tmp_path / "vision.bin"))
    imgs = _images(3, 40, 1)
    ref = jfid.CLIPFeatures.from_torch_file(path, cfg=jcv.TINY_CLIP_VISION_CONFIG, batch=2)(imgs)
    ours = fid.CLIPFeatures.from_torch_file(path, cfg=cv.TINY_CLIP_VISION_CONFIG, batch=2,
                                            device="cpu")(imgs)
    assert ours.shape == (3, 48) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(ref), **TOWER)
    from_bin = fid.CLIPFeatures.from_torch_file(str(tmp_path / "vision.bin"), batch=2,
                                                cfg=cv.TINY_CLIP_VISION_CONFIG, device="cpu")
    np.testing.assert_array_equal(from_bin(imgs), ours)
    capsys.readouterr()
    seeded = fid.CLIPFeatures(cfg=cv.TINY_CLIP_VISION_CONFIG, device="cpu", seed=3)
    assert "random weights" in capsys.readouterr().err
    again = fid.CLIPFeatures(cfg=cv.TINY_CLIP_VISION_CONFIG, device="cpu", seed=3)
    np.testing.assert_array_equal(seeded(imgs), again(imgs))


def test_text_features_match_jax(text):
    params, state = text
    prompts = ["a photo of a cat", "an astronaut riding a horse", "a bowl of soup"]
    ref = jcs.CLIPTextFeatures(JHashTokenizer(quiet=True), weights=params,
                               cfg=JCLIPTextConfig(**TINY_TEXT), batch=2)(prompts)
    ours = cs.CLIPTextFeatures(HashTokenizer(), weights=state, cfg=CLIPTextConfig(**TINY_TEXT),
                               batch=2, device="cpu")(prompts)
    assert ours.shape == (3, 48)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOWER)


def test_fid_and_clip_score_math_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((20, 8)), rng.standard_normal((15, 8)) * 1.5 + 0.3
    for ours, ref in zip(fid.activation_statistics(a), jfid.activation_statistics(a)):
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
    assert fid.fid_from_features(a, b) == pytest.approx(jfid.fid_from_features(a, b), rel=1e-9)
    assert abs(fid.fid_from_features(a, a)) < 1e-6
    batches = [a[:7], a[7:]], [b[:10], b[10:]]
    assert fid.fid_from_generator(*batches, lambda x: x * 2) == pytest.approx(
        jfid.fid_from_generator(*batches, lambda x: x * 2), rel=1e-9)
    img, txt = rng.standard_normal((6, 8)), rng.standard_normal((6, 8))
    assert cs.clip_score_from_features(img, txt) == pytest.approx(
        jcs.clip_score_from_features(img, txt), rel=1e-9)
    assert cs.clip_score_from_features(np.eye(4), np.eye(4)) == 100.0
    assert cs.clip_score_from_features(np.eye(4), np.roll(np.eye(4), 1, axis=0)) == 0.0


def test_clip_score_end_to_end_matches_jax(vision, text):
    (vparams, vstate), (tparams, tstate) = vision, text
    imgs, prompts = _images(3, 32, 5), ["a red apple", "a lighthouse at dusk", "a cat"]
    jimg = jfid.CLIPFeatures(weights=vparams, cfg=jcv.TINY_CLIP_VISION_CONFIG)
    jtxt = jcs.CLIPTextFeatures(JHashTokenizer(quiet=True), weights=tparams,
                                cfg=JCLIPTextConfig(**TINY_TEXT))
    oimg = fid.CLIPFeatures(weights=vstate, cfg=cv.TINY_CLIP_VISION_CONFIG, device="cpu")
    otxt = cs.CLIPTextFeatures(HashTokenizer(), weights=tstate, cfg=CLIPTextConfig(**TINY_TEXT),
                               device="cpu")
    ref = jcs.clip_score(imgs, prompts, jimg, jtxt)
    assert cs.clip_score(imgs, prompts, oimg, otxt) == pytest.approx(ref, abs=1e-4)


@pytest.fixture()
def concepts_npz(tmp_path):
    """`tests/test_safety_fid.py`'s concepts: 3 concept and 2 special unit rows, thresholds 0.5."""
    rng = np.random.RandomState(0)
    concept = rng.randn(3, 8).astype(np.float32)
    concept /= np.linalg.norm(concept, axis=-1, keepdims=True)
    special = rng.randn(2, 8).astype(np.float32)
    special /= np.linalg.norm(special, axis=-1, keepdims=True)
    path = tmp_path / "concepts.npz"
    np.savez(path, concept_embeds=concept,
             concept_embeds_weights=np.full((3,), 0.5, np.float32),
             special_care_embeds=special,
             special_care_embeds_weights=np.full((2,), 0.5, np.float32))
    return str(path), concept, special


@pytest.mark.parametrize("adjust", [0.0, 0.05])
def test_safety_checker_matches_jax(concepts_npz, adjust):
    """Each concept flagged, a vector orthogonal to all passed, and 300
    random features (some past a special concept, whose 0.01 adjustment
    then applies) judged as the JAX checker judges them."""
    path, concept, special = concepts_npz
    ours, ref = safety.SafetyChecker(path, adjust), jsafety.SafetyChecker(path, adjust)
    img = np.zeros((8, 8, 3), np.uint8)
    feats = list(concept) + list(np.random.default_rng(1).standard_normal((300, 8)))
    verdicts = [ours.is_unsafe(img, f) for f in feats]
    assert verdicts == [ref.is_unsafe(img, f) for f in feats]
    assert all(verdicts[:3]) and 0 < sum(verdicts) < len(verdicts)
    q, _ = np.linalg.qr(np.concatenate([concept, special]).T)
    v = np.random.RandomState(1).randn(8).astype(np.float32)
    assert not ours.is_unsafe(img, v - q @ (q.T @ v))
    assert not safety.SafetyChecker().is_unsafe(img, concept[0])
    assert not ours.is_unsafe(img, None) and not safety.SafetyChecker().active


# ---------------------------------------------------------------------------
# the eval CLIs against the JAX scripts
# ---------------------------------------------------------------------------


def _run_jax_script(script, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.fixture()
def folders(tmp_path):
    """Two folders of a PNG, a baseline JPEG and a BMP each, with captions."""
    out = []
    for k, name in enumerate(("a", "b")):
        d = tmp_path / name
        d.mkdir()
        for i, ext in enumerate(("png", "jpg", "bmp")):
            smooth((56, 48), 10 * k + i).save(d / f"{i}.{ext}")
            (d / f"{i}.txt").write_text(f"image {i} of folder {name}")
        out.append(str(d))
    return out


@pytest.fixture()
def tiny_configs(monkeypatch):
    """The TINY vision tower and the tiny text tower in place of ViT-L/14 in both packages."""
    monkeypatch.setattr(jcv, "CLIP_VIT_L14_CONFIG", jcv.TINY_CLIP_VISION_CONFIG)
    monkeypatch.setattr(cv, "CLIP_VIT_L14_CONFIG", cv.TINY_CLIP_VISION_CONFIG)
    monkeypatch.setattr(jcs, "CLIP_VIT_L14_TEXT_CONFIG", JCLIPTextConfig(**TINY_TEXT))
    monkeypatch.setattr(cs, "CLIP_VIT_L14_TEXT_CONFIG", CLIPTextConfig(**TINY_TEXT))


def test_eval_fid_features_mode_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(6)
    np.save(tmp_path / "a.npy", rng.standard_normal((30, 16)))
    np.save(tmp_path / "b.npy", rng.standard_normal((25, 16)) + 0.2)
    argv = ["--features-a", str(tmp_path / "a.npy"), "--features-b", str(tmp_path / "b.npy")]
    ref = _run_jax_script("eval_fid.py", argv, monkeypatch, capsys)
    res = eval_fid.main(argv)
    assert capsys.readouterr().out.strip() == ref and ref.startswith("FID: ")
    assert res["fid"] > 0


@pytest.mark.parametrize("extractor", ["pixels", "clip"])
def test_eval_fid_images_mode_matches_jax(folders, vision, tiny_configs, tmp_path, monkeypatch,
                                          capsys, extractor):
    """A PNG + JPEG + BMP folder against another, 40 px square: the pixel
    fallback, or the TINY tower from a ``.safetensors`` file (``--clip-weights``)."""
    argv = ["--image-dir-a", folders[0], "--image-dir-b", folders[1], "--resolution", "40",
            "--batch", "2"]
    if extractor == "clip":
        path = str(tmp_path / "vision.safetensors")
        save_file({k: v.numpy() for k, v in vision[1].items()}, path)
        argv += ["--clip-weights", path]
    ref = float(_run_jax_script("eval_fid.py", argv, monkeypatch, capsys).split()[-1])
    res = eval_fid.main(argv + ["--device", "cpu"])
    assert res["features"][0].shape[0] == 3 and ref > 0
    assert res["fid"] == pytest.approx(ref, rel=IMAGE_FID_REL)
    same = eval_fid.main(["--image-dir-a", folders[0], "--image-dir-b", folders[0],
                          "--resolution", "40"] + argv[6:] + ["--device", "cpu"])
    assert abs(same["fid"]) <= 1e-5 * np.trace(np.cov(same["features"][0], rowvar=False))


def test_eval_clip_score_matches_jax(folders, vision, text, tiny_configs, tmp_path, monkeypatch,
                                     capsys):
    """Sidecar captions, then a prompts file; both towers from ``.safetensors`` files."""
    vpath, tpath = str(tmp_path / "vision.safetensors"), str(tmp_path / "text.safetensors")
    save_file({k: v.numpy() for k, v in vision[1].items()}, vpath)
    save_file({k: v.numpy() for k, v in text[1].items()}, tpath)
    (tmp_path / "prompts.txt").write_text("a red square\na blue circle\na green field\n")
    for extra in ([], ["--prompts-file", str(tmp_path / "prompts.txt")]):
        argv = ["--image-dir", folders[0], "--vision-weights", vpath, "--text-weights", tpath,
                "--batch", "2", *extra]
        ref = float(_run_jax_script("eval_clip_score.py", argv, monkeypatch, capsys).split()[-1])
        ours = eval_clip_score.main(argv + ["--device", "cpu"])
        assert "CLIP-score: " in capsys.readouterr().out
        assert ours == pytest.approx(ref, abs=IMAGE_SCORE_ABS)


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_files(tmp_path_factory):
    """A TINY SD1.5 teacher, its 2-Step LoRA under the registry's name, and a
    seeded TINY vision tower file."""
    d = tmp_path_factory.mktemp("demo")
    pb = families.sd15_bundle(dtype=torch.float32, tiny=True)
    gen = torch.Generator().manual_seed(3)
    frozen, template = pb.init(gen, CPU)
    torch.save({k: m.state_dict() for k, m in frozen.items()}, d / "teacher.pt")
    (d / "loras").mkdir()
    lora = d / "loras" / demo.CHECKPOINT_REGISTRY["2-Step"][0].format(family="sd15")
    save_kohya_safetensors(str(lora), {k: 0.1 * torch.randn(v.shape, generator=gen)
                                       for k, v in template.items()}, pb.lora.alpha,
                           prefix=pb.KOHYA_PREFIX)
    tower = fid.CLIPFeatures(cfg=cv.TINY_CLIP_VISION_CONFIG, device="cpu", seed=4)
    save_file({k: v.numpy() for k, v in tower.model.state_dict().items()},
              str(d / "vision.safetensors"))
    return {"teacher": str(d / "teacher.pt"), "loras": str(d / "loras"), "lora": str(lora),
            "vision": str(d / "vision.safetensors")}


def _demo(argv, prompt, tmp_path, monkeypatch, name):
    out = tmp_path / name
    out.mkdir()
    monkeypatch.chdir(out)
    monkeypatch.setattr(sys, "stdin", io.StringIO(prompt + "\n"))
    demo.main(argv)
    return (out / "demo_out.png").read_bytes()


def test_demo_cli_loop_equals_generate_and_checks_safety(demo_files, tmp_path, monkeypatch,
                                                         capsys):
    """The demo's "2-Step" image is ``generate``'s (the LoRA, 2 DDIM steps,
    guidance 1, seed 0) byte for byte; an npz whose concept is that image's
    own feature blacks it out, one whose concept is its opposite passes it;
    concepts without the tower's weights exit."""
    f = demo_files
    base = ["--family", "sd15", "--teacher-checkpoint", f["teacher"], "--lora-dir", f["loras"],
            "--tiny", "--device", "cpu"]
    prompt = "a red square"
    plain = _demo(base, prompt, tmp_path, monkeypatch, "plain")
    assert "safety checker disabled" in capsys.readouterr().out
    r = generate.main(["--family", "sd15", "--teacher-checkpoint", f["teacher"], "--lora",
                       f["lora"], "--prompt", prompt, "--steps", "2", "--scheduler", "ddim",
                       "--cfg", "1.0", "--seed", "0", "--tiny", "--device", "cpu",
                       "--resolution", "32", "--out", str(tmp_path / "gen.png")])
    assert plain == (tmp_path / "gen.png").read_bytes()
    img = generate.generate(r["built"], r["args"]).float().numpy()
    feat = fid.CLIPFeatures.from_torch_file(f["vision"], cfg=cv.TINY_CLIP_VISION_CONFIG,
                                            device="cpu")(img[:1])[0]
    unit = feat / np.linalg.norm(feat)
    for name, sign in (("flag", 1.0), ("pass", -1.0)):
        np.savez(tmp_path / f"{name}.npz", concept_embeds=sign * unit[None],
                 concept_embeds_weights=np.full((1,), 0.5, np.float32),
                 special_care_embeds=-unit[None],
                 special_care_embeds_weights=np.full((1,), 0.5, np.float32))
    checked = base + ["--safety-clip-weights", f["vision"], "--safety-concepts"]
    flagged = _demo(checked + [str(tmp_path / "flag.npz")], prompt, tmp_path, monkeypatch, "f")
    passed = _demo(checked + [str(tmp_path / "pass.npz")], prompt, tmp_path, monkeypatch, "p")
    assert "safety checker ACTIVE" in capsys.readouterr().out
    assert passed == plain
    black = np.asarray(Image.open(io.BytesIO(flagged)))
    assert black.shape == (32, 32, 3) and not black.any() and to_uint8(img)[0].any()
    with pytest.raises(SystemExit, match="requires --safety-clip-weights"):
        demo.main(base + ["--safety-concepts", str(tmp_path / "flag.npz")])


# ---------------------------------------------------------------------------
# the UNet's guidance embedding; StepTimer
# ---------------------------------------------------------------------------


def test_time_cond_proj_matches_jax():
    """A TINY UNet with ``time_cond_proj_dim`` = 16: with ``timestep_cond``
    its output is JAX's within ``TOL`` and moves; without it, the UNet
    without the projection."""
    jcfg = dataclasses.replace(J_TINY_UNET, time_cond_proj_dim=16)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.array([999.0, 499.0], np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    cond = 10 * rng.standard_normal((2, 16), dtype=np.float32)
    v = random_params(lambda key, *a: JUNet(jcfg).init(key, *a[:3], timestep_cond=a[3]),
                      jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), jnp.zeros((1, 7, 32)),
                      jnp.zeros((1, 16)), seed=8)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = jax.jit(lambda p, c: JUNet(jcfg).apply(p, *jargs, timestep_cond=c))(v, jnp.asarray(cond))
    ref_none = jax.jit(lambda p: JUNet(jcfg).apply(p, *jargs))(v)
    port = UNet2DCondition(dataclasses.replace(TINY_UNET_CONFIG, time_cond_proj_dim=16))
    state = convert.unet_state_from_jax(v["params"])
    assert state["time_embedding_cond_proj.weight"].shape == (32, 16)
    port.load_state_dict(state, strict=True)
    targs = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        out = port(*targs, timestep_cond=torch.from_numpy(cond)).permute(0, 2, 3, 1)
        out_none = port(*targs).permute(0, 2, 3, 1)
    err = rel_max(out, ref)
    assert err < 5e-4 and rel_max(out_none, ref_none) < 5e-4
    assert rel_max(out_none, ref) > 20 * err  # the guidance embedding acts


def test_step_timer_matches_jax(monkeypatch):
    """Window 3 over ticks at 0, 0.1, 0.3, 0.6, 1.0 s: the same readings as the JAX class."""
    readings = []
    for mod in (profiling, jprofiling):
        clock = iter([0.0, 0.1, 0.3, 0.6, 1.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=3)
        readings.append([timer.tick() for _ in range(5)])
    assert readings[0] == readings[1]
    assert readings[0][0] == {} and readings[0][1] == pytest.approx(
        {"step_time_ms": 100.0, "steps_per_sec": 10.0})
    assert readings[0][4]["step_time_ms"] == pytest.approx(350.0)  # (1.0 - 0.3) / 2
