"""Training from pixels in the port against `pcm_tpu` (CPU, fp32, TINY sizes):
the VAE encoder, one `sd15_4phase` step on a batch of pixels, the image
dataset and loader, the numpy PNG decoder and Lanczos resize, the latent-
cache writer, and the trainer's feeder thread, SIGTERM save and resume.

Bounds: the encoder rel-max 5e-4 (`tests/test_torch_models.py`'s ``TOL``);
the step as `tests/test_torch_train.py::test_distill_step_matches_jax`
holds it (target 1e-4, loss 1e-5, grad norm and LoRA grads 1e-3, params
1e-5 with Adam's eps raised to 1e-2); the loaders' pixels equal with the same
decoder; the numpy decoder + resize within 3 LSB of PIL (max) and 1 LSB
(mean), as `tests/test_native_image.py` holds the native one.
"""

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import multiprocessing
import struct
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.core import solver as jsolver
from pcm_tpu.data import dataset as jdataset
from pcm_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from pcm_tpu.models.clip import CLIPTextModel as JCLIP
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.models.vae import AutoencoderKL as JVAE
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD15Bundle as JSD15Bundle
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs.families import sd15_bundle
from pcm_tpu_torch.core import losses
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.core.solver import PhasedDDIMSolver, phase_boundaries
from pcm_tpu_torch.data import dataset, native_image
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.vae import TINY_VAE_CONFIG, AutoencoderKL
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.loop import LoopConfig, Trainer
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from torch_port_helpers import random_params, rel_max

TOL = 5e-4
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_COUNTERS = ("host_data_s", "host_dispatch_s", "fence_s", "feed_iter_s", "feed_put_s")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the VAE encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae():
    v = random_params(JVAE(J_TINY_VAE).init, jnp.zeros((1, 16, 16, 3)), seed=15)
    port = AutoencoderKL(TINY_VAE_CONFIG)
    port.load_state_dict(convert.vae_state_from_jax(v["params"]), strict=True)
    return v, port.eval()


def test_vae_encoder_matches_flax(tiny_vae):
    """`encode_moments`, the posterior mean and `encode(x, noise)` with the
    noise `jax.random.normal(r_vae, ...)` that the JAX step draws."""
    v, port = tiny_vae
    x = np.random.default_rng(16).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    r_vae = jax.random.split(jax.random.PRNGKey(3), 4)[0]
    mean_ref, logvar_ref = JVAE(J_TINY_VAE).apply(v, jnp.asarray(x), method=JVAE.encode_moments)
    noise = jax.random.normal(r_vae, mean_ref.shape, mean_ref.dtype)
    z_mean_ref = JVAE(J_TINY_VAE).apply(v, jnp.asarray(x), method=JVAE.encode)
    z_ref = JVAE(J_TINY_VAE).apply(v, jnp.asarray(x), r_vae, method=JVAE.encode)
    with torch.no_grad():
        mean, logvar = port.encode_moments(nchw(x))
        z_mean = port.encode(nchw(x))
        z = port.encode(nchw(x), nchw(noise))
    assert mean.shape == (2, 4, 8, 8)
    assert rel_max(nhwc(mean), mean_ref) < TOL
    assert rel_max(nhwc(logvar), logvar_ref) < TOL
    assert rel_max(nhwc(z_mean), z_mean_ref) < TOL
    assert rel_max(nhwc(z), z_ref) < TOL
    assert rel_max(z, z_mean) > 1e-3  # the sample is not the mean


def test_logvar_clip_and_chunked_encode(tiny_vae):
    """logvar is clipped to [-30, 20]; an encode in chunks of one sample
    gives the batch's latents, each row with its own noise row."""
    _, port = tiny_vae
    bundle = sd15_bundle(4, dtype=torch.float32, tiny=True)
    frozen = {"vae": port}
    rng = np.random.default_rng(17)
    px = torch.from_numpy(rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((3, 8, 8, 4)).astype(np.float32))
    whole = bundle.encode_pixels(frozen, px, noise)
    chunked = dataclasses.replace(bundle, vae_encode_chunk=1).encode_pixels(frozen, px, noise)
    assert whole.shape == (3, 8, 8, 4)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)
    assert bundle.latents_like({"pixel_values": px}).shape == (3, 8, 8, 4)
    with torch.no_grad():
        port.quant_conv.bias.add_(100.0)
        try:
            _, logvar = port.encode_moments(nchw(px.numpy()))
        finally:
            port.quant_conv.bias.sub_(100.0)
    assert float(logvar.max()) == 20.0


def test_encoder_draws_leave_the_other_weights():
    """`SD15Bundle.init` draws the encoder from a stream of its own: every
    other weight, the adapter template and the generator's next draws are
    those drawn before the encoder was ported (md5 of their bytes then)."""
    gen = torch.Generator().manual_seed(3)
    frozen, template = sd15_bundle(4, dtype=torch.float32, tiny=True).init(gen, CPU)
    h = hashlib.md5()
    for k in ("unet", "vae", "text"):
        for n, v in sorted(frozen[k].state_dict().items()):
            if not n.startswith(("encoder.", "quant_conv.")):
                h.update(n.encode())
                h.update(v.numpy().tobytes())
    for n, v in sorted(template.items()):
        h.update(n.encode())
        h.update(v.numpy().tobytes())
    h.update(torch.randn(8, generator=gen).numpy().tobytes())
    assert h.hexdigest() == "1f50522d921e9b88695404ed75f7b41a"
    enc = frozen["vae"].encoder.conv_in.weight
    again, _ = sd15_bundle(4, dtype=torch.float32, tiny=True).init(
        torch.Generator().manual_seed(3), CPU)
    assert torch.equal(again["vae"].encoder.conv_in.weight, enc) and enc.std() > 0
    other, _ = sd15_bundle(4, dtype=torch.float32, tiny=True).init(
        torch.Generator().manual_seed(4), CPU)
    assert not torch.equal(other["vae"].encoder.conv_in.weight, enc)


# ---------------------------------------------------------------------------
# one distillation step on pixels
# ---------------------------------------------------------------------------

LORA_RANK, GROUPS = 4, 8  # as tests/test_torch_train.py (see GROUPS there)
LR, EPS = 1e-3, 1e-2


def test_pixel_distill_step_matches_jax(tiny_vae):
    """One `sd15_4phase`-style step (10 solver steps, 2 phases, CFG) on a
    batch of pixels and caption ids: JAX's `ddim_prepare` encodes them with
    `r_vae`; the port gets JAX's draws, the posterior noise among them."""
    spec = JLoRASpec(rank=LORA_RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    junet = dataclasses.replace(J_TINY_UNET, norm_groups=GROUPS)
    u = random_params(JUNet(junet, lora=spec).init, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                      jnp.zeros((1, 7, 32)), seed=11)
    text_cfg = JCLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    text = random_params(JCLIP(text_cfg).init, jnp.zeros((1, 77), jnp.int32), seed=18)["params"]
    vae = tiny_vae[0]["params"]
    jbundle = JSD15Bundle(junet, J_TINY_VAE, text_cfg, spec, dtype=jnp.float32)
    jfrozen = jax.tree.map(jnp.asarray, {"unet": u["params"], "vae": vae, "text": text})
    tiny = sd15_bundle(LORA_RANK, dtype=torch.float32, tiny=True)
    pbundle = dataclasses.replace(tiny, unet_cfg=dataclasses.replace(tiny.unet_cfg,
                                                                     norm_groups=GROUPS))
    pfrozen = pbundle.from_states({"unet": convert.unet_state_from_jax(u["params"]),
                                   "vae": convert.vae_state_from_jax(vae),
                                   "text": convert.clip_state_from_jax(text, pbundle.text_cfg)},
                                  CPU)

    rng = np.random.default_rng(19)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             "input_ids": HashTokenizer()(["a red square", "a blue circle"]),
             "uncond_embeds": rng.standard_normal((2, 77, 32)).astype(np.float32) * 0.1}
    cfg_kw = dict(num_solver_steps=10, multiphase=2, w_min=4.0, w_max=5.0)
    jcfg, pcfg = jdistill.DistillConfig(**cfg_kw), distill.DistillConfig(**cfg_kw)
    jsched = jax_schedule()
    jsol = jsolver.PhasedDDIMSolver.create(jsched, 10)
    bounds = jnp.asarray(jsolver.phase_boundaries(10, 2))
    key = jax.random.PRNGKey(7)

    @jax.jit
    def jgrad(lora, mb):
        parts = jdistill.ddim_prepare(jbundle, jsched, jsol, bounds, jcfg, jfrozen, lora, mb, key)

        def loss_fn(lora_):
            pred = jdistill.ddim_model_pred(jbundle, jsched, jsol, jcfg, jfrozen, lora_, parts)
            return jlosses.consistency_loss(pred, parts["target"], jcfg.loss_type, jcfg.huber_c)

        return parts, jax.value_and_grad(loss_fn)(lora)

    jtx = jax_make_optimizer(LR, eps=EPS)
    jstate = JTrainState.create(u["lora"], jtx)
    parts, (jloss, jgrads) = jgrad(u["lora"], {k: jnp.asarray(v) for k, v in batch.items()})
    jstate2 = jax.jit(lambda s, g: jdistill._apply_updates(s, g, jtx))(jstate, jgrads)
    r_vae = jax.random.split(key, 4)[0]  # ddim_prepare's split: r_vae, r_noise, r_idx, r_w
    draws = {k: torch.from_numpy(np.array(parts[k])) for k in ("noise", "index", "w")}
    draws["vae_noise"] = torch.from_numpy(np.array(
        jax.random.normal(r_vae, parts["latents"].shape, jnp.float32)))

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()
    psched = make_ddpm_schedule()
    psol = PhasedDDIMSolver.create(psched, 10)
    ptx = make_optimizer(LR, eps=EPS)
    pstate = convert.train_state_from_jax(jstate)
    pparts = distill.ddim_prepare(pbundle, psched, psol, torch.from_numpy(phase_boundaries(10, 2)),
                                  pcfg, pfrozen, pstate.params, tbatch, draws)
    assert rel_max(pparts["latents"], parts["latents"]) < TOL
    assert rel_max(pparts["target"], parts["target"]) < 1e-4
    lora = {k: p.detach().requires_grad_(True) for k, p in pstate.params.items()}
    pred = distill.ddim_model_pred(pbundle, psched, psol, pcfg, pfrozen, lora, pparts)
    grads = torch.autograd.grad(losses.consistency_loss(pred, pparts["target"]),
                                list(lora.values()))
    ref = convert.lora_state_from_jax(jgrads)
    for k, g in zip(lora, grads):
        assert rel_max(g, ref[k]) < 1e-3, k

    pstate2, pm = distill.build_ddim_distill_step(pbundle, psched, pcfg, ptx)(
        pstate, pfrozen, tbatch, [draws])
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jdistill._grad_norm(jgrads)),
                               rtol=1e-3)
    ref_params = convert.lora_state_from_jax(jstate2.params)
    for k, p in pstate2.params.items():
        np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), rtol=0, atol=1e-5)


def test_sample_draws_posterior_keeps_the_cached_stream():
    """``vae_noise`` is drawn last: the other draws of a pixel batch are those
    a cached batch of the same latents' shape gets."""
    cfg = distill.DistillConfig()
    like = torch.empty((2, 8, 8, 4))
    a = distill.sample_draws(cfg, torch.Generator().manual_seed(1), like)
    b = distill.sample_draws(cfg, torch.Generator().manual_seed(1), like, posterior=True)
    assert set(b) == set(a) | {"vae_noise"} and b["vae_noise"].shape == like.shape
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# images: decoders, dataset, loader
# ---------------------------------------------------------------------------


def _smooth(size, seed, mode="RGB"):
    """A smooth image (16x16 noise resized bicubically), as test_native_image makes them."""
    rng = np.random.default_rng(seed)
    shape = (16, 16, 3) if mode == "RGB" else (16, 16)
    return Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).resize(size,
                                                                               Image.BICUBIC)


def _pil_resized(path, res):
    img = Image.open(path).convert("RGB")
    w, h = img.size
    s = res / min(w, h)
    img = img.resize((max(res, round(w * s)), max(res, round(h * s))), Image.LANCZOS)
    return np.asarray(img, np.uint8)


@pytest.mark.parametrize("mode,size,res", [
    ("RGB", (300, 200), 128), ("RGB", (40, 64), 64), ("RGB", (64, 96), 64),
    ("L", (120, 90), 48), ("RGBA", (90, 70), 32), ("LA", (50, 60), 40), ("P", (80, 50), 32)],
    ids=["rgb_down", "rgb_up", "rgb_exact", "gray", "rgba", "gray_alpha", "palette"])
def test_numpy_decoder_matches_pil(tmp_path, mode, size, res):
    """The numpy PNG decoder is exact (PIL writes its rows with adaptive
    filters), and decode + Lanczos-3 stays within 3 LSB of PIL's resize on
    the images `tests/test_native_image.py` holds the native pipeline to
    (its `_make`: seed 0), and within 1 LSB of what the native pipeline
    gives (it composites alpha onto black, so those PNGs skip it). (Both
    float pipelines round once where PIL rounds between its passes: on
    another seed's upscale, 40x64 -> 64, both are 4 LSB from PIL.)"""
    p = str(tmp_path / "x.png")
    img = _smooth(size, 0, "RGB" if mode in ("RGB", "RGBA", "P") else "L")
    if mode == "RGBA":
        img = img.convert("RGBA")
        img.putalpha(128)
    elif mode == "LA":
        img = img.convert("LA")
    elif mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=64)
    img.save(p)
    with open(p, "rb") as f:
        decoded = native_image.decode_png(f.read())
    np.testing.assert_array_equal(decoded, np.asarray(Image.open(p).convert("RGB")))
    noise = np.random.default_rng(2).integers(0, 256, (23, 37, 3), np.uint8)
    Image.fromarray(noise).save(str(tmp_path / "noise.png"))
    with open(str(tmp_path / "noise.png"), "rb") as f:
        np.testing.assert_array_equal(native_image.decode_png(f.read()), noise)
    ours, ref = native_image.load_resized_numpy(p, res), _pil_resized(p, res)
    assert ours.shape == ref.shape and min(ours.shape[:2]) == res
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 3 and diff.mean() < 1.0
    if native_image.available():
        nat = native_image.load_resized(p, res, use_native=True)  # alpha PNGs: numpy
        assert np.abs(ours.astype(np.int32) - nat.astype(np.int32)).max() <= 1


def _png(px, kinds):
    """(H, W, C) uint8 as an 8-bit PNG (C = 1, 2, 3, 4: gray, gray + alpha,
    RGB, RGBA) with row y filtered by ``kinds[y]`` (0-4: None, Sub, Up,
    Average, Paeth)."""
    h, w, ch = px.shape
    x = px.reshape(h, w * ch).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, ch:], b[1:], c[1:, ch:] = x[:, :-ch], x[:-1], x[:-1, :-ch]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[kinds, np.arange(h)]
    rows = np.concatenate([kinds[:, None], (x - pred) & 255], 1).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (native_image.PNG_MAGIC + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("band_elems", [1 << 23, 200], ids=["one_band", "bands"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_numpy_decoder_undoes_every_filter(monkeypatch, channels, band_elems):
    """Rows filtered None, Sub, Up, Average and Paeth in turn, Paeth and
    Average in turn, then Up and Sub alone (a band the row loop takes),
    decode exactly, in one wavefront band or in bands of a few rows
    (``_BAND_ELEMS`` cut). The bytes take a few values near 0, 128 and 255,
    so that Paeth's ties, sums above 255 and the wrap of the filtered bytes
    all occur."""
    monkeypatch.setattr(native_image, "_BAND_ELEMS", band_elems)
    values = np.r_[0:8, 128, 248:256].astype(np.uint8)
    px = np.random.default_rng(channels).choice(values, (39, 23, channels))
    kinds = np.concatenate([np.arange(15) % 5, [4, 3] * 5, [2, 1] * 7]).astype(np.uint8)
    want = np.repeat(px[..., :1], 3, axis=2) if channels <= 2 else px[..., :3]
    np.testing.assert_array_equal(native_image.decode_png(_png(px, kinds)), want)


def _rle_bmp(path):
    """The headers of an 8-bit RLE8-compressed BMP (compression 1)."""
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + 1024, 0, 0, 54 + 1024)
                + struct.pack("<IiiHHIIiiII", 40, 4, 4, 1, 8, 1, 0, 2835, 2835, 0, 0)
                + bytes(1024))


def test_numpy_path_refuses_other_formats(tmp_path):
    """WebP and progressive JPEGs are refused by name (baseline JPEG, PNG
    and BMP decode: `tests/test_torch_jpeg.py`), as are 16-bit PNGs and RLE
    BMPs."""
    p = str(tmp_path / "x.webp")
    _smooth((40, 30), 3).save(p, "WEBP")
    with pytest.raises(ValueError, match="WebP"):
        native_image.load_resized(p, 16, use_native=False)
    p = str(tmp_path / "x.jpg")
    _smooth((40, 30), 3).save(p, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        native_image.load_resized(p, 16, use_native=False)
    _rle_bmp(str(tmp_path / "r.bmp"))
    with pytest.raises(ValueError, match="RLE8"):
        native_image.load_resized(str(tmp_path / "r.bmp"), 16, use_native=False)
    with pytest.raises(ValueError, match="8-bit"):
        Image.fromarray(np.zeros((4, 4), np.uint16), "I;16").save(str(tmp_path / "d.png"))
        with open(str(tmp_path / "d.png"), "rb") as f:
            native_image.decode_png(f.read())


@pytest.fixture
def image_root(tmp_path):
    """A folder of PNGs: one at the resolution (32), one larger and not
    square, one gray, one without a caption, and a JPEG."""
    root = tmp_path / "imgs"
    root.mkdir()
    for name, size, mode, caption in (("a.png", (32, 32), "RGB", "a red square"),
                                      ("b.png", (56, 40), "RGB", "a wide image"),
                                      ("c.png", (36, 44), "L", "a gray one"),
                                      ("d.png", (48, 48), "RGB", None),
                                      ("e.jpg", (40, 40), "RGB", "a jpeg")):
        img = _smooth(size, len(name) + ord(name[0]), mode)
        img.save(str(root / name), "JPEG" if name.endswith("jpg") else "PNG")
        if caption is not None:
            (root / (name[:-4] + ".txt")).write_text(caption + "\n")
    return str(root)


def test_dataset_matches_jax(image_root):
    """Dropout 0, center crop, the native decoder on both sides: the same
    files in the same order, the same captions, equal pixels; the loaders'
    batches of two epochs equal."""
    if not native_image.available():
        pytest.skip("native image pipeline unavailable")
    ours = dataset.ImageFolderDataset(image_root, resolution=32, use_native=True)
    ref = jdataset.ImageFolderDataset(image_root, resolution=32, use_native=True)
    assert ours.files == ref.files and ours.decoder == "native" and len(ours) == 5
    for i in range(len(ours)):
        a, b = ours.get(i), ref.get(i)
        assert a["caption"] == b["caption"]
        assert a["pixel_values"].shape == (32, 32, 3)
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
    assert [ours.get(i)["caption"] for i in range(5)] == [
        "a red square", "a wide image", "a gray one", "", "a jpeg"]
    pl = dataset.DataLoader(ours, 2, dataset.make_collate({"input_ids": HashTokenizer()}),
                            num_workers=2, seed=7)
    jl = jdataset.DataLoader(ref, 2, jdataset.make_collate({"input_ids": JHashTokenizer()}, 32),
                             num_workers=2, seed=7)
    pit, jit_ = iter(pl), iter(jl)
    try:
        for _ in range(4):  # two epochs of two batches (the fifth image is the ragged tail)
            a, b = next(pit), next(jit_)
            assert a.keys() == b.keys() == {"pixel_values", "input_ids"}
            np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    finally:
        pit.close()
        jit_.close()


@pytest.fixture
def png_root(image_root):
    """`image_root` without its JPEG, a folder the numpy decoder reads."""
    os.remove(os.path.join(image_root, "e.jpg"))
    return image_root


@pytest.mark.parametrize("use_native,name", [(False, "e2.jpg"), (True, "f.bmp"),
                                             (False, "e2.webp")],
                         ids=["numpy_jpeg", "native_bmp", "numpy_webp"])
def test_dataset_refuses_what_its_decoder_cannot_read(image_root, use_native, name):
    """A progressive JPEG or a WebP under the numpy decoder, an RLE BMP under
    the native one (BMPs take the numpy decoder there): the dataset is
    refused when made, with the count, the decoder and the reason named, not
    trained on its other files or ended by the bad-sample retry. (The
    folder's baseline JPEG, ``e.jpg``, is read by either.)"""
    if use_native and not native_image.available():
        pytest.skip("native image pipeline unavailable")
    path = os.path.join(image_root, name)
    if name.endswith(".bmp"):
        _rle_bmp(path)
    else:
        _smooth((20, 20), 4).save(path, progressive=True)
    why = {"jpg": "progressive", "bmp": "RLE8", "webp": "WebP"}[name.rsplit(".", 1)[1]]
    decoder = "native" if use_native else "numpy"
    with pytest.raises(ValueError, match=rf"1 of the 6 images .* {decoder} decoder .*{why}") as e:
        dataset.ImageFolderDataset(image_root, resolution=32, use_native=use_native)
    if not use_native:
        assert "native image library" in str(e.value)


def test_numpy_dataset_matches_jax_pil(image_root):
    """The numpy decoders' dataset (PNGs, a baseline JPEG) against the JAX
    dataset at ``use_native=False`` (PIL): the same files in the same order,
    the same captions, and pixels within the 3 LSB that the numpy PNG path
    keeps against PIL's Lanczos (the JPEG decodes to PIL's pixels exactly,
    `tests/test_torch_jpeg.py`)."""
    ours = dataset.ImageFolderDataset(image_root, resolution=32, use_native=False)
    ref = jdataset.ImageFolderDataset(image_root, resolution=32, use_native=False)
    assert ours.files == ref.files and ours.decoder == "numpy" and len(ours) == 5
    assert ours.files[-1].endswith("e.jpg")
    for i in range(len(ours)):
        a, b = ours.get(i), ref.get(i)
        assert a["caption"] == b["caption"]
        assert a["pixel_values"].shape == b["pixel_values"].shape == (32, 32, 3)
        d = np.abs(a["pixel_values"] - b["pixel_values"]) * 127.5
        assert d.max() <= 3.01 and d.mean() < 1.0, ours.files[i]


def test_numpy_and_native_decoders_agree(png_root):
    """The two decoders on the dataset's PNGs: within the 3-LSB bound each
    keeps against PIL, so 6 LSB apart at most."""
    if not native_image.available():
        pytest.skip("native image pipeline unavailable")
    nat = dataset.ImageFolderDataset(png_root, resolution=32, use_native=True)
    npy = dataset.ImageFolderDataset(png_root, resolution=32, use_native=False)
    assert npy.decoder == "numpy"
    for i, f in enumerate(nat.files):
        if f.endswith(".png"):
            d = np.abs(nat.get(i)["pixel_values"] - npy.get(i)["pixel_values"]) * 127.5
            assert d.max() <= 6.01 and d.mean() < 1.0, f


def test_seeded_dropout_reproduces(png_root):
    """Dropout 0.5: two loaders of one seed give the same batches, on any
    thread timing; another seed gives other ones; a bad file is skipped."""
    with open(os.path.join(png_root, "zz_bad.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really")

    def batches(seed):
        ds = dataset.ImageFolderDataset(png_root, resolution=32, proportion_empty_prompts=0.5,
                                        seed=seed, use_native=False)
        loader = dataset.DataLoader(ds, 3, dataset.make_collate({"input_ids": HashTokenizer()}),
                                    num_workers=3, seed=seed)
        it = iter(loader)
        try:
            return [next(it) for _ in range(4)]
        finally:
            it.close()

    a, b, c = batches(5), batches(5), batches(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["pixel_values"], y["pixel_values"])
        np.testing.assert_array_equal(x["input_ids"], y["input_ids"])
    empty = HashTokenizer()([""])[0]
    assert any((row == empty).all() for x in a for row in x["input_ids"])  # some dropped
    assert any(not np.array_equal(x["input_ids"], y["input_ids"]) or
               not np.array_equal(x["pixel_values"], y["pixel_values"]) for x, y in zip(a, c))


def test_loader_error_raises_from_the_iterator(png_root):
    ds = dataset.ImageFolderDataset(png_root, resolution=32, use_native=False)

    def collate(samples):
        raise RuntimeError("collate failed")

    it = iter(dataset.DataLoader(ds, 2, collate, num_workers=2))
    with pytest.raises(RuntimeError, match="collate failed"):
        next(it)


def _trainer(tmp_path, max_steps):
    def step(state, d_state, frozen, batch, draws, global_step):
        assert threading.current_thread() is threading.main_thread()
        return state, d_state, {"loss": batch["latents"].sum()}, 1

    tx = make_optimizer(1e-3)
    return Trainer(LoopConfig(str(tmp_path), max_steps, log_every=1, checkpointing_steps=0,
                              resume=False),
                   None, TrainState.create({"x.lora_a": torch.zeros(2, 3),
                                            "x.lora_b": torch.zeros(4, 2)}, tx),
                   step, distill.DistillConfig(), lambda batch: batch["latents"], CPU)


def test_trainer_feeder_errors_and_exhaustion(tmp_path):
    """A loader error is raised on the step thread after the steps before
    it; a loader that ends early raises the JAX message; host counters are
    logged; a stop request ends the run with a checkpoint and a kohya file."""
    def failing():
        yield {"latents": np.ones((1, 2, 2, 4), np.float32)}
        raise OSError("disk gone")

    trainer = _trainer(tmp_path / "a", 5)
    with pytest.raises(OSError, match="disk gone"):
        trainer.run(failing())
    assert trainer.global_step == 1
    trainer = _trainer(tmp_path / "b", 5)
    with pytest.raises(StopIteration, match="exhausted before max_train_steps"):
        trainer.run(iter([{"latents": np.ones((1, 2, 2, 4), np.float32)}] * 2))
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2] and all(k in rows[0] for k in HOST_COUNTERS)

    trainer = _trainer(tmp_path / "c", 50)

    def endless():  # the feeder runs ahead of the steps: it may never see step 3 itself
        while True:
            if trainer.global_step >= 3:
                trainer.request_stop()
            yield {"latents": np.ones((1, 2, 2, 4), np.float32)}

    trainer.run(endless())
    with open(tmp_path / "c" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    stop = trainer.global_step
    assert 3 <= stop < 50 and rows[-1] == {**rows[-1], "step": stop, "preempted": 1}
    assert os.path.exists(tmp_path / "c" / "checkpoints" / f"step_{stop:07d}.pt")
    assert os.path.exists(tmp_path / "c" / f"pcm_lora_{stop:07d}.safetensors")


def test_trainer_leaves_no_loader_running(png_root, tmp_path):
    """A run fed by the loader (the numpy decoder's load processes) returns
    with no feeder or loader thread alive, and its load processes end."""
    ds = dataset.ImageFolderDataset(png_root, resolution=32, use_native=False)
    loader = dataset.DataLoader(
        ds, 2, lambda samples: {"latents": np.stack([x["pixel_values"] for x in samples])},
        num_workers=2)
    trainer = _trainer(tmp_path, 3)
    trainer.run(loader)
    assert trainer.global_step == 3
    assert not [t.name for t in threading.enumerate() if t.name.startswith("pcm-")]
    deadline = time.monotonic() + 30
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not multiprocessing.active_children()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _png_folder(root, n=6):
    from pcm_tpu_torch.serving.server import png_bytes

    root.mkdir()
    rng = np.random.default_rng(9)
    for i in range(n):
        h, w = (16, 16) if i % 2 else (20, 24)
        (root / f"im{i}.png").write_bytes(png_bytes(rng.integers(0, 256, (h, w, 3), np.uint8)))
        if i != 3:
            (root / f"im{i}.txt").write_text(f"caption {i}")
    return str(root)


def _cli(*argv, stop_after=0):
    """``python -m pcm_tpu_torch.train`` in a child process; SIGTERM once its
    ``step <stop_after>:`` row is printed."""
    proc = subprocess.Popen([sys.executable, "-u", "-m", "pcm_tpu_torch.train", *argv],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})
    timer = threading.Timer(240, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if stop_after and line.startswith(f"step {stop_after}:"):
                proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=60), "".join(lines)
    finally:
        timer.cancel()


def test_train_cli_pixels_sigterm_and_resume(tmp_path):
    """A tiny run from a folder of PNGs: SIGTERM after the first row exits 0
    with a checkpoint, a kohya file and a ``preempted`` row at the step it
    stopped; the rerun resumes there and ends at the last step; every row
    holds the five host counters."""
    imgs, out = _png_folder(tmp_path / "imgs"), tmp_path / "run"
    argv = ["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--train-data-dir", imgs,
            "--resolution", "16", "--output-dir", str(out), "--batch-size", "2",
            "--max-train-steps", "6", "--log-every", "1", "--checkpointing-steps", "4",
            "--dataloader-workers", "2"]
    rc, printed = _cli(*argv, stop_after=1)
    assert rc == 0, printed[-3000:]
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    stops = [r["step"] for r in rows if r.get("preempted")]
    assert len(stops) == 1 and 1 <= stops[0] < 6, printed[-3000:]
    stop = stops[0]
    assert (out / "checkpoints" / f"step_{stop:07d}.pt").exists()
    assert (out / f"pcm_lora_{stop:07d}.safetensors").exists()
    assert "decoder" in printed and f"preempted at step {stop}" in printed
    rc, printed = _cli(*argv)
    assert rc == 0 and f"resumed at step {stop}" in printed, printed[-3000:]
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == list(range(1, 7))
    assert all(all(k in r for k in HOST_COUNTERS) for r in steps)
    assert (out / "checkpoints" / "step_0000006.pt").exists()
    assert (out / "pcm_lora_0000006.safetensors").exists()
    runs = [json.loads(line) for line in open(out / "launches.jsonl")]
    assert [(r["from_step"], r["to_step"]) for r in runs] == [(0, stop), (stop, 6)]


@pytest.mark.parametrize("recipe", ["sd3_2phase_adv", "sd15_2phase_adv"],
                         ids=["sd3", "adversarial_int8"])
def test_train_cli_pixels_int8(tmp_path, capsys, recipe):
    """An SD3 recipe and an adversarial one on int8 frozen weights from a
    folder of PNGs (both refused before): two global steps of the fused pair
    under ``--int8-matmul fused``, the towers quantized as well as the
    backbone, finite losses."""
    from pcm_tpu_torch.train.__main__ import main
    from pcm_tpu_torch.utils.quant import quantized_bytes_saved

    trainer = main(["--recipe", recipe, "--tiny", "--device", "cpu", "--train-data-dir",
                    _png_folder(tmp_path / "imgs", 4), "--output-dir", str(tmp_path / "run"),
                    "--resolution", "16", "--batch-size", "2", "--max-train-steps", "2",
                    "--log-every", "1", "--adv-pairing", "fused", "--dataloader-workers", "1",
                    "--frozen-weights", "int8", "--int8-matmul", "fused"])
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and "step 2:" in printed and "nan" not in printed
    text = trainer.frozen["text"].text_model.encoder.layers[0].mlp.fc1
    assert text.weight is None and text.weight_values.dtype == torch.int8
    assert quantized_bytes_saved(trainer.frozen) > 0


@pytest.mark.parametrize("extra,msg", [
    (["--recipe", "sd15_4phase", "--cached-latents-dir", "x"], "one of"),
    (["--recipe", "sd15_4phase", "--no-tiny-tokenizer"], "no tokenizer"),
    (["--recipe", "sd15_4phase", "--with-bmp"], "1 of the 1 images")],
    ids=["both_sources", "no_tokenizer", "unreadable_image"])
def test_train_cli_refuses_pixels(tmp_path, capsys, extra, msg):
    from pcm_tpu_torch.train.__main__ import main

    tiny = [] if "--no-tiny-tokenizer" in extra else ["--tiny"]
    if "--with-bmp" in extra:  # a file neither decoder reads: BMPs take the numpy one
        _rle_bmp(str(tmp_path / "a.bmp"))
    extra = [a for a in extra if a not in ("--no-tiny-tokenizer", "--with-bmp")]
    with pytest.raises(SystemExit) as exc:
        main([*extra, *tiny, "--device", "cpu", "--output-dir", str(tmp_path / "o"),
              "--train-data-dir", str(tmp_path)])
    assert exc.value.code != 0
    assert msg in capsys.readouterr().err


def test_cache_writer_feeds_both_readers(tmp_path):
    """``python -m pcm_tpu_torch.data.cache_latents --family sd15`` (tiny, CPU):
    shards both packages' readers take, the same on a rerun of the seed,
    and the port's trainer trains on them."""
    from pcm_tpu.data.dataset import CachedLatentsDataset as JCached
    from pcm_tpu_torch.data import cache_latents
    from pcm_tpu_torch.data.cached import CachedLatentsDataset
    from pcm_tpu_torch.train.__main__ import main as train_main

    imgs = _png_folder(tmp_path / "imgs")
    argv = ["--family", "sd15", "--tiny", "--device", "cpu", "--train-data-dir", imgs,
            "--resolution", "16", "--batch", "2", "--shard-size", "4"]
    assert cache_latents.main(argv + ["--output-dir", str(tmp_path / "c1")]) == 0
    assert cache_latents.main(argv + ["--output-dir", str(tmp_path / "c2")]) == 0
    assert sorted(os.listdir(tmp_path / "c1")) == ["shard_00000.npz", "shard_00001.npz"]
    ours, ref = CachedLatentsDataset(str(tmp_path / "c1")), JCached(str(tmp_path / "c1"))
    assert len(ours) == len(ref) == 6
    for i in range(6):
        a, b, again = ours.get(i), ref.get(i), CachedLatentsDataset(str(tmp_path / "c2")).get(i)
        assert a["latents"].shape == (8, 8, 4) and a["prompt_embeds"].shape == (77, 32)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], again[k])
    trainer = train_main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu",
                          "--cached-latents-dir", str(tmp_path / "c1"), "--output-dir",
                          str(tmp_path / "run"), "--batch-size", "2", "--max-train-steps", "1"])
    assert trainer.global_step == 1
    with pytest.raises(SystemExit, match="no CUDA device"):  # these tests run without a card
        cache_latents.main(["--family", "sd15", "--device", "cuda", "--train-data-dir", imgs,
                            "--output-dir", str(tmp_path / "c3")])
