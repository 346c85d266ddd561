"""SDXL from text and from pixels in the port against `pcm_tpu` (CPU, fp32,
TINY sizes): CLIP-bigG, `SDXLBundle.encode_prompts` and its pixel `encode`,
the chunked decode, the random crop and its ``time_ids``, the text-to-image
pipeline and the engine, the SDXL latent cache, and adversarial training
from pixels through ``python -m pcm_tpu_torch.train``'s ``main``.

Weights are drawn with numpy over the JAX modules' shapes and cross through
`pcm_tpu_torch.models.convert`. Bounds: the towers and the encode rel-max
5e-4 (`tests/test_torch_models.py`'s ``TOL``); the pipeline's images 1e-3
(`tests/test_torch_serving.py::test_pipeline_matches_jax`); a fused
adversarial pair from pixels against the same pair on the latents its
posterior noise encodes to 1e-6; the crop's pixels and ``time_ids`` exact.
"""

import base64
import dataclasses
import hashlib
import io
import json
import os
import random
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
from pcm_tpu.core import make_ddpm_schedule as jax_make_ddpm_schedule
from pcm_tpu.data import dataset as jdataset
from pcm_tpu.data.dataset import CachedLatentsDataset as JCached
from pcm_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from pcm_tpu.models.clip import CLIP_BIG_G_CONFIG as J_BIG_G
from pcm_tpu.models.clip import CLIPTextModel as JCLIP
from pcm_tpu.sampling import DDIMSampler as JDDIMSampler
from pcm_tpu.sampling import TextToImagePipeline as JPipeline
from pcm_tpu_torch.configs import families
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.data import cache_latents, dataset
from pcm_tpu_torch.data.cached import CachedLatentsDataset
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.clip import CLIP_BIG_G_CONFIG, CLIPTextModel
from pcm_tpu_torch.sampling.ddim import DDIMSampler
from pcm_tpu_torch.sampling.pipeline import TextToImagePipeline
from pcm_tpu_torch.serving import EngineConfig, InferenceEngine
from pcm_tpu_torch.train import adv, distill
from pcm_tpu_torch.train.__main__ import main as train_main
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from torch_port_helpers import random_params, rel_max

TOL = 5e-4
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


def _time_ids(n, res=16):
    return np.tile(np.array([res, res, 0, 0, res, res], np.float32), (n, 1))


def _ids(prompts):
    return {"input_ids": HashTokenizer()(prompts), "input_ids_2": HashTokenizer()(prompts)}


# ---------------------------------------------------------------------------
# the text towers and the bundle
# ---------------------------------------------------------------------------


def test_big_g_matches_flax():
    """TINY bigG (gelu, bias-free projection): every hidden state, the
    final-LN output and the projected pooled output at the end-of-text
    token; the full-width config is the JAX package's."""
    cfg = families._TINY_CLIP_XL2
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfamilies._TINY_CLIP_XL2)
    assert dataclasses.asdict(families._TINY_CLIP_XL1) == dataclasses.asdict(
        jfamilies._TINY_CLIP_XL1)
    assert dataclasses.asdict(CLIP_BIG_G_CONFIG) == dataclasses.asdict(J_BIG_G)
    params = random_params(JCLIP(jfamilies._TINY_CLIP_XL2).init,
                           jnp.zeros((1, 77), jnp.int32), seed=41)["params"]
    ids = HashTokenizer()(["a red square", "a much longer caption of a blue circle", ""])
    hidden_ref, last_ref, pooled_ref = JCLIP(jfamilies._TINY_CLIP_XL2).apply(
        {"params": params}, jnp.asarray(ids))
    port = CLIPTextModel(cfg)
    port.load_state_dict(convert.clip_state_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        hidden, last, pooled = port.eval()(t(ids).long())
    assert len(hidden) == len(hidden_ref) == 3 and pooled.shape == (3, 32)
    for ours, ref in zip(hidden, hidden_ref):
        assert rel_max(ours, ref) < TOL
    assert rel_max(last, last_ref) < TOL
    assert rel_max(pooled, pooled_ref) < TOL


@pytest.fixture(scope="module")
def xl():
    """The JAX TINY SDXL bundle with numpy-drawn weights (every module) and
    a LoRA with non-zero ``b``; the port's bundle on the converted weights."""
    jb = jfamilies.sdxl_bundle(RANK, dtype=jnp.float32, remat=False, tiny=True)
    jfrozen, jlora = random_params(lambda r: jb.init(r), seed=42)
    pb = families.sdxl_bundle(RANK, dtype=torch.float32, tiny=True)
    states = {"unet": convert.unet_state_from_jax(jfrozen["unet"]),
              "vae": convert.vae_state_from_jax(jfrozen["vae"]),
              "text": convert.clip_state_from_jax(jfrozen["text"], pb.text_cfg),
              "text2": convert.clip_state_from_jax(jfrozen["text2"], pb.text2_cfg)}
    return dict(jb=jb, jfrozen=jfrozen, jlora=jlora, pb=pb, pfrozen=pb.from_states(states, CPU),
                plora=convert.lora_state_from_jax(jlora))


def _assert_trees_close(ours, ref, tol):
    flat = jax.tree.leaves(jax.tree.map(np.asarray, ref))
    mine = []
    jax.tree.map(lambda a: mine.append(a.detach().numpy()), ours)
    assert len(mine) == len(flat)
    for a, b in zip(mine, flat):
        assert a.shape == b.shape and rel_max(a, b) < tol


def test_encode_prompts_matches_jax(xl):
    """CLIP-L's and bigG's penultimate hidden states concatenated (N, 77,
    16 + 16), bigG's projected pooled output as ``text_embeds`` (N, 32)."""
    ids = _ids(["a red square", "a blue circle", ""])
    time_ids = _time_ids(3)
    ref = xl["jb"].encode_prompts(xl["jfrozen"], jnp.asarray(ids["input_ids"]),
                                  jnp.asarray(ids["input_ids_2"]), jnp.asarray(time_ids))
    with torch.no_grad():
        ours = xl["pb"].encode_prompts(xl["pfrozen"], t(ids["input_ids"]).long(),
                                       t(ids["input_ids_2"]).long(), t(time_ids))
    assert ours["prompt_embeds"].shape == (3, 77, 32)
    assert ours["added_cond"]["text_embeds"].shape == (3, 32)
    _assert_trees_close(ours, ref, TOL)


def test_pixel_encode_matches_jax(xl):
    """`SDXLBundle.encode` of pixels and caption ids: latents with the
    posterior noise JAX draws from its key fed to the port, the cond tree
    and the zero uncond with the batch's own ``time_ids``."""
    rng = np.random.default_rng(43)
    time_ids = np.array([[16, 19, 0, 2, 16, 16], [21, 16, 3, 0, 16, 16]], np.float32)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             **_ids(["a red square", "a blue circle"]), "time_ids": time_ids}
    key = jax.random.PRNGKey(5)
    jl, jc, ju = xl["jb"].encode(xl["jfrozen"], {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)
    noise = t(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    tb = {k: t(v) for k, v in batch.items()}
    pl, pc, pu = xl["pb"].encode(xl["pfrozen"], tb, noise)
    assert pl.shape == (2, 8, 8, 4)
    assert rel_max(pl, jl) < TOL
    _assert_trees_close(pc, jc, TOL)
    _assert_trees_close(pu, ju, TOL)
    assert not pu["prompt_embeds"].any() and torch.equal(pu["added_cond"]["time_ids"],
                                                         tb["time_ids"])
    mean, _, _ = xl["pb"].encode(xl["pfrozen"], tb)
    assert rel_max(pl, mean) > 1e-3  # the posterior sample is not the mean


def test_decode_chunks_equal_the_whole_decode(xl):
    """Chunks of 1 and 2 samples give the whole decode up to the CPU's
    batch-dependent fp32 round-off (rel-max 1e-5)."""
    lat = torch.from_numpy(np.random.default_rng(44).standard_normal((4, 8, 8, 4),
                                                                      dtype=np.float32))
    pb, frozen = xl["pb"], xl["pfrozen"]
    with torch.no_grad():
        whole = pb.decode_latents(frozen, lat)
        for chunk in (1, 2):
            assert rel_max(pb.decode_latents(frozen, lat, chunk), whole) < 1e-5
        with pytest.raises(ValueError, match="not divisible"):
            pb.decode_latents(frozen, lat, 3)
    assert whole.shape == (4, 16, 16, 3)


def test_seeded_draws_leave_the_unet_and_template():
    """`SDXLBundle.init` draws the UNet and the adapter template as it did
    when the bundle held the UNet alone (md5 of their bytes and of the
    generator's next draws, taken then); the VAE and each tower come from
    streams of their own, so a subset of the modules gets the same weights
    as the whole bundle, and another seed other ones."""
    bundle = families.sdxl_bundle(RANK, dtype=torch.float32, tiny=True)
    gen = torch.Generator().manual_seed(3)
    frozen, template = bundle.init(gen, CPU)
    h = hashlib.md5()
    for n, v in sorted(frozen["unet"].state_dict().items()):
        h.update(n.encode())
        h.update(v.numpy().tobytes())
    for n, v in sorted(template.items()):
        h.update(n.encode())
        h.update(v.numpy().tobytes())
    h.update(torch.randn(8, generator=gen).numpy().tobytes())
    assert h.hexdigest() == "a0e7d3784945ebd119ae8395a32f0bde"
    assert sorted(frozen) == ["text", "text2", "unet", "vae"]
    part, none = bundle.init(torch.Generator().manual_seed(3), CPU, modules=("vae", "text2"))
    assert sorted(part) == ["text2", "vae"] and none == {}
    for k in part:
        for (n, a), b in zip(frozen[k].state_dict().items(), part[k].state_dict().values()):
            assert torch.equal(a, b), (k, n)
    other, _ = bundle.init(torch.Generator().manual_seed(4), CPU, modules=("vae", "text", "text2"))
    for k, name in (("vae", "encoder.conv_in.weight"), ("text", "text_model.embeddings."
                    "token_embedding.weight"), ("text2", "text_projection.weight")):
        mine = frozen[k].state_dict()[name]
        assert mine.std() > 0 and not torch.equal(other[k].state_dict()[name], mine), k
    assert not torch.equal(frozen["text"].text_model.encoder.layers[0].mlp.fc1.weight[:16, :16],
                           frozen["text2"].text_model.encoder.layers[0].mlp.fc1.weight[:16, :16])


# ---------------------------------------------------------------------------
# the random crop and time_ids
# ---------------------------------------------------------------------------


@pytest.fixture
def image_root(tmp_path):
    """PNGs at and above the resolution (32), not square, with captions."""
    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(45)
    for i, (w, h) in enumerate([(32, 32), (56, 40), (36, 44), (48, 48), (40, 90)]):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).resize(
            (w, h), Image.BICUBIC).save(str(root / f"im{i}.png"))
        (root / f"im{i}.txt").write_text(f"caption {i}")
    return str(root)


def test_random_crop_and_time_ids_match_jax(image_root):
    """The same `random.Random` handed to both packages' datasets (native
    decoder, random crop, dropout 0.5) draws the same crop and the same
    dropout: equal pixels, sizes, crop corners and captions; both SDXL
    collates give the same ``time_ids`` [orig_h, orig_w, top, left, 32, 32]."""
    from pcm_tpu_torch.data import native_image

    if not native_image.available():
        pytest.skip("native image pipeline unavailable")
    kw = dict(resolution=32, crop="random", proportion_empty_prompts=0.5, use_native=True)
    ours, ref = dataset.ImageFolderDataset(image_root, **kw), jdataset.ImageFolderDataset(
        image_root, **kw)
    mine, theirs = [], []
    for i in range(len(ours)):
        for draw in range(3):
            ref.rng = random.Random(100 * i + draw)
            a, b = ours.get(i, random.Random(100 * i + draw)), ref.get(i)
            assert a.keys() == b.keys() == {"pixel_values", "caption", "original_size",
                                            "crop_coords"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            mine.append(a)
            theirs.append(b)
    coords = {tuple(s["crop_coords"]) for s in mine}
    assert len(coords) > 2 and any(s["caption"] == "" for s in mine)
    assert {tuple(s["original_size"]) for s in mine} == {(32, 32), (32, 45), (39, 32), (72, 32)}
    toks = {"input_ids": HashTokenizer(), "input_ids_2": HashTokenizer()}
    jtoks = {"input_ids": JHashTokenizer(), "input_ids_2": JHashTokenizer()}
    a = dataset.make_collate(toks, 32, sdxl=True)(mine)
    b = jdataset.make_collate(jtoks, 32, sdxl=True)(theirs)
    assert a.keys() == b.keys() == {"pixel_values", "input_ids", "input_ids_2", "time_ids"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["time_ids"].dtype == np.float32 and (a["time_ids"][:, 4:] == 32).all()
    np.testing.assert_array_equal(a["time_ids"][:, :4], np.concatenate(
        [np.stack([s["original_size"] for s in mine]),
         np.stack([s["crop_coords"] for s in mine])], 1))
    centre = dataset.ImageFolderDataset(image_root, resolution=32, use_native=True).get(1)
    assert set(centre) == {"pixel_values", "caption"}  # SD1.5's path: no time_ids
    with pytest.raises(ValueError, match="resolution"):
        dataset.make_collate(toks, sdxl=True)


# ---------------------------------------------------------------------------
# the pipeline and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_lora", [True, False], ids=["student", "teacher"])
@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_sdxl_pipeline_matches_jax(xl, with_lora, guidance):
    """At guidance 7.5 the CFG batch carries every leaf of cond and uncond
    (``added_cond`` too): the uncond is the encoding of the empty prompt."""
    ids, empty = _ids(["a red square", "a blue circle"]), _ids(["", ""])
    time_ids = _time_ids(2)
    init = np.random.default_rng(46).standard_normal((2, 8, 8, 4), dtype=np.float32)
    jb, jfrozen = xl["jb"], xl["jfrozen"]
    jpipe = JPipeline(jb, JDDIMSampler.create(jax_make_ddpm_schedule(), 2))

    def jenc(d):
        return jb.encode_prompts(jfrozen, jnp.asarray(d["input_ids"]),
                                 jnp.asarray(d["input_ids_2"]), jnp.asarray(time_ids))

    gen = jax.jit(lambda fr, lo, c, u, i: jpipe.generate(
        fr, lo, c, u, jax.random.PRNGKey(0), 8, guidance, init_latents=i))
    ref = gen(jfrozen, xl["jlora"] if with_lora else None, jenc(ids), jenc(empty),
              jnp.asarray(init))

    pb, frozen = xl["pb"], xl["pfrozen"]

    def enc(d):
        return pb.encode_prompts(frozen, t(d["input_ids"]).long(), t(d["input_ids_2"]).long(),
                                 t(time_ids))

    pipe = TextToImagePipeline(pb, DDIMSampler.create(make_ddpm_schedule(), 2))
    out = pipe.generate(frozen, xl["plora"] if with_lora else None, enc(ids), enc(empty),
                        t(init), guidance, decode_chunk=1)
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < 1e-3


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_sdxl_engine_same_image_in_any_batch(xl, guidance):
    """The SDXL engine (time_ids from the resolution, the uncond the
    encoding of ""): a request's image is the same in a full and in a
    partial batch, decoded whole or in chunks."""
    pb, frozen = xl["pb"], xl["pfrozen"]
    toks = {"input_ids": HashTokenizer(), "input_ids_2": HashTokenizer()}

    def engine(chunk):
        return InferenceEngine(pb, DDIMSampler.create(make_ddpm_schedule(), 2), frozen,
                               xl["plora"], toks,
                               EngineConfig(batch_size=3, latent_hw=8, resolution=16,
                                            guidance_scale=guidance, decode_chunk=chunk), CPU)

    eng = engine(None)
    solo = eng.generate_batch(["a red square"], [7])
    full = engine(1).generate_batch(["a blue circle", "a red square", "x"], [8, 7, 9])
    assert solo.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(solo[0], full[1])
    assert np.any(full[0] != full[1])
    if guidance > 1:
        ref = eng._encode([""] * 3)
        assert ref["added_cond"]["time_ids"].tolist() == [[16.0, 16.0, 0, 0, 16.0, 16.0]] * 3
        assert eng._uncond["prompt_embeds"].abs().max() > 0  # not zeros


# ---------------------------------------------------------------------------
# the cache writer and training from pixels
# ---------------------------------------------------------------------------


def _png_folder(root, n=6):
    from pcm_tpu_torch.serving.server import png_bytes

    root.mkdir()
    rng = np.random.default_rng(47)
    for i in range(n):
        h, w = (16, 16) if i % 2 else (20, 24)
        (root / f"im{i}.png").write_bytes(png_bytes(rng.integers(0, 256, (h, w, 3), np.uint8)))
        if i != 3:
            (root / f"im{i}.txt").write_text(f"caption {i}")
    return str(root)


def test_sdxl_cache_feeds_both_readers(tmp_path):
    """``python -m pcm_tpu_torch.data.cache_latents --family sdxl`` (tiny,
    CPU): the four arrays of each sample, the same on a rerun of the seed,
    read alike by both packages' readers; ``time_ids`` are the random crops'
    of the dataset; the port's trainer trains ``sdxl_4phase_adv`` on them."""
    imgs = _png_folder(tmp_path / "imgs")
    argv = ["--family", "sdxl", "--tiny", "--device", "cpu", "--train-data-dir", imgs,
            "--resolution", "16", "--batch", "2", "--shard-size", "4", "--seed", "3"]
    assert cache_latents.main(argv + ["--output-dir", str(tmp_path / "c1")]) == 0
    assert cache_latents.main(argv + ["--output-dir", str(tmp_path / "c2")]) == 0
    ours, ref = CachedLatentsDataset(str(tmp_path / "c1")), JCached(str(tmp_path / "c1"))
    again = CachedLatentsDataset(str(tmp_path / "c2"))
    images = dataset.ImageFolderDataset(imgs, resolution=16, seed=3, crop="random")
    assert len(ours) == len(ref) == 6
    for i in range(6):
        a, b, c = ours.get(i), ref.get(i), again.get(i)
        assert {k: v.shape for k, v in a.items()} == {
            "latents": (8, 8, 4), "prompt_embeds": (77, 32), "pooled_embeds": (32,),
            "time_ids": (6,)}
        assert a["time_ids"].dtype == np.float32
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
        s = images.get(i)
        np.testing.assert_array_equal(a["time_ids"], np.r_[s["original_size"],
                                                           s["crop_coords"], 16, 16])
    assert any(ours.get(i)["time_ids"][1] != 16 for i in range(6))  # a wide image's size
    trainer = train_main(["--recipe", "sdxl_4phase_adv", "--tiny", "--device", "cpu",
                          "--cached-latents-dir", str(tmp_path / "c1"), "--output-dir",
                          str(tmp_path / "run"), "--batch-size", "2", "--max-train-steps", "2",
                          "--adv-pairing", "fused"])
    assert trainer.global_step == 2 and sorted(trainer.frozen) == ["unet"]


def test_fused_pair_from_pixels_equals_the_pair_on_its_latents():
    """One `sdxl_4phase_adv` fused pair (TINY) on a batch of pixels and
    caption ids, against the same pair on the cached batch that the draws'
    ``vae_noise`` and the towers encode it to: the LoRA, the heads and every
    metric within 1e-6."""
    bundle = families.sdxl_bundle(RANK, dtype=torch.float32, tiny=True)
    gen = torch.Generator().manual_seed(48)
    frozen, template = bundle.init(gen, CPU)
    lora = {k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in template.items()}
    cfg = families.RECIPES["sdxl_4phase_adv"].distill
    schedule = make_ddpm_schedule()
    disc, heads = adv.init_discriminator(families.disc_config("sdxl", True),
                                         bundle.unet_cfg.tap_channels(), gen, CPU)
    tx, tx_d = make_optimizer(1e-3), make_optimizer(1e-3, b1=0.0, max_grad_norm=1.0)
    pair = adv.build_ddim_adv_fused_pair(bundle, schedule, cfg, adv.AdvConfig(0.1), disc, tx, tx_d)
    rng = np.random.default_rng(49)
    pixels = {"pixel_values": t(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)),
              **{k: t(v) for k, v in _ids(["a red square", "a blue circle"]).items()},
              "time_ids": t(np.array([[16, 19, 0, 3, 16, 16], [16, 16, 0, 0, 16, 16]],
                                     np.float32))}
    draws = distill.sample_draws(cfg, gen, bundle.latents_like(pixels),
                                 adv.adv_offset_span(schedule, cfg), posterior=True)
    with torch.no_grad():
        latents = bundle.encode_pixels(frozen, pixels["pixel_values"], draws["vae_noise"])
        c = bundle.encode_prompts(frozen, pixels["input_ids"], pixels["input_ids_2"],
                                  pixels["time_ids"])
    cached = {"latents": latents, "prompt_embeds": c["prompt_embeds"],
              "pooled_embeds": c["added_cond"]["text_embeds"], "time_ids": pixels["time_ids"]}
    runs = [pair(TrainState.create(lora, tx), TrainState.create(heads, tx_d), frozen, batch,
                 [draws]) for batch in (pixels, cached)]
    (g1, d1, m1), (g2, d2, m2) = runs
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-6, err_msg=k)
    for a, b in ((g1.params, g2.params), (d1.params, d2.params)):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert max(float((g1.params[k] - lora[k]).abs().max()) for k in lora) > 1e-6
    assert max(float((d1.params[k] - heads[k]).abs().max()) for k in heads) > 1e-6


@pytest.mark.parametrize("recipe,pairing", [("sdxl_4phase_adv", "fused"),
                                            ("sd15_2phase_adv", "fresh")])
def test_adversarial_cli_from_pixels(tmp_path, recipe, pairing):
    """``python -m pcm_tpu_torch.train``'s ``main`` (``--tiny --device cpu``)
    for 2 global steps of each adversarial recipe from a folder of PNGs:
    finite ``loss`` and ``d_loss``, a kohya file, the heads and the LoRA
    updated; SDXL reads ``input_ids_2`` and crops at random."""
    imgs, out = _png_folder(tmp_path / "imgs"), tmp_path / "run"
    trainer = train_main(["--recipe", recipe, "--tiny", "--device", "cpu", "--train-data-dir",
                          imgs, "--resolution", "16", "--output-dir", str(out), "--batch-size",
                          "2", "--max-train-steps", "2", "--log-every", "1", "--adv-pairing",
                          pairing, "--dataloader-workers", "2"])
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    losses = [r[k] for r in rows for k in ("loss", "d_loss") if k in r]
    assert trainer.global_step == 2 and rows[-1]["step"] == 2
    assert {"loss", "d_loss"} <= {k for r in rows for k in r}
    assert all(np.isfinite(losses))
    assert (trainer.state.step, trainer.d_state.step) == (1, 1)
    assert (out / "pcm_lora_0000002.safetensors").exists()
    assert sorted(trainer.frozen) == (["text", "text2", "unet", "vae"] if recipe.startswith("sdxl")
                                      else ["text", "unet", "vae"])


def test_vae_encode_chunk_follows_the_reference(tmp_path, monkeypatch):
    """``--vae-encode-chunk`` defaults to 1 at >= 1024 px with a batch above
    1 (`scripts/train.py:215-217`), else to the batch up to 32."""
    from pcm_tpu_torch.train import loop

    seen = []
    monkeypatch.setattr(loop.Trainer, "run", lambda self, data, extra=None: seen.append(
        self.latents_like.__self__.vae_encode_chunk))
    imgs = _png_folder(tmp_path / "imgs")
    for res, batch in (("1024", "2"), ("1024", "1"), ("16", "2")):
        train_main(["--recipe", "sdxl_4phase_adv", "--tiny", "--device", "cpu",
                    "--train-data-dir", imgs, "--resolution", res, "--output-dir",
                    str(tmp_path / f"o{res}_{batch}"), "--batch-size", batch,
                    "--max-train-steps", "2", "--dataloader-workers", "1"])
    assert seen == [1, 32, 32]
    assert os.path.isdir(tmp_path / "o16_2")


def test_serve_entry_point_sdxl_tiny_cpu():
    """``python -m pcm_tpu_torch.serving --family sdxl --tiny --device cpu
    --cfg 7.5`` answers a request (the CFG batch with SDXL's ``added_cond``)."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pcm_tpu_torch.serving", "--family", "sdxl", "--tiny",
         "--device", "cpu", "--batch-size", "2", "--resolution", "16", "--port", "0",
         "--enable-lora-swap", "--cfg", "7.5"],
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
        assert port, "server never came up:\n" + "".join(lines)
        assert "warming up sdxl" in "".join(lines)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps({"prompt": "cli smoke", "seed": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        assert Image.open(io.BytesIO(base64.b64decode(out["image_b64"]))).size == (16, 16)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
