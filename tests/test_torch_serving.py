"""The serving slice of the port on the CPU: the pipeline against the JAX
pipeline, the engine's padding and per-request seeds, adapters, the HTTP
server and the ``python -m pcm_tpu_torch.serving`` entry point.

TINY SD1.5 bundle, fp32, 2-step trailing DDIM. Both pipelines get the same
numpy starting latents and the same converted weights; bound rel-max 1e-3 on
the images (fp32; two UNet forwards and a decode compound the order-of-
summation differences bounded by 5e-4 per backbone in test_torch_models.py).
"""

import base64
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcm_tpu.configs.families import sd15_bundle as jax_sd15_bundle
from pcm_tpu.core import make_ddpm_schedule as jax_make_ddpm_schedule
from pcm_tpu.sampling import DDIMSampler as JDDIMSampler
from pcm_tpu.sampling import TextToImagePipeline as JPipeline
from pcm_tpu_torch.configs.families import sd15_bundle
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.sampling.ddim import DDIMSampler, trailing_timesteps
from pcm_tpu_torch.sampling.pipeline import TextToImagePipeline
from pcm_tpu_torch.serving import BatchingServer, EngineConfig, InferenceEngine
from pcm_tpu_torch.serving.server import png_bytes
from pcm_tpu_torch.train.bundles import adapter_like
from torch_port_helpers import random_params, rel_max

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX TINY bundle, numpy-drawn weights and a LoRA tree with non-zero ``b``."""
    jb = jax_sd15_bundle(lora_rank=4, dtype=jnp.float32, remat=False, tiny=True)
    frozen, lora = random_params(lambda r: jb.init(r), seed=7)
    return jb, frozen, lora


@pytest.fixture(scope="module")
def port_slice(jax_slice):
    jb, frozen, lora = jax_slice
    bundle = sd15_bundle(lora_rank=4, dtype=torch.float32, tiny=True)
    states = {"unet": convert.unet_state_from_jax(frozen["unet"]),
              "vae": convert.vae_state_from_jax(frozen["vae"]),
              "text": convert.clip_state_from_jax(frozen["text"], bundle.text_cfg)}
    return bundle, bundle.from_states(states, CPU), convert.lora_state_from_jax(lora)


@pytest.mark.parametrize("with_lora", [True, False], ids=["student", "teacher"])
@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_pipeline_matches_jax(jax_slice, port_slice, with_lora, guidance):
    jb, jfrozen, jlora = jax_slice
    bundle, frozen, lora = port_slice
    ids = HashTokenizer()(["a red square", "a blue circle"])
    empty = HashTokenizer()(["", ""])
    init = np.random.default_rng(8).standard_normal((2, 8, 8, 4), dtype=np.float32)

    jpipe = JPipeline(jb, JDDIMSampler.create(jax_make_ddpm_schedule(), 2))
    jcond = jb.encode_prompts(jfrozen, jnp.asarray(ids))
    juncond = jb.encode_prompts(jfrozen, jnp.asarray(empty))
    gen = jax.jit(lambda fr, lo, c, u, i: jpipe.generate(
        fr, lo, c, u, jax.random.PRNGKey(0), 8, guidance, init_latents=i))
    ref = gen(jfrozen, jlora if with_lora else None, jcond, juncond, jnp.asarray(init))

    pipe = TextToImagePipeline(bundle, DDIMSampler.create(make_ddpm_schedule(), 2))
    cond = bundle.encode_prompts(frozen, torch.from_numpy(ids).long())
    uncond = bundle.encode_prompts(frozen, torch.from_numpy(empty).long())
    out = pipe.generate(frozen, lora if with_lora else None, cond, uncond,
                        torch.from_numpy(init), guidance)
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < 1e-3


def test_ddim_tables_match_jax():
    js = JDDIMSampler.create(jax_make_ddpm_schedule(), 4)
    ps = DDIMSampler.create(make_ddpm_schedule(), 4)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    np.testing.assert_array_equal(np.asarray(js.alphas), np.float32(ps.alphas))
    np.testing.assert_array_equal(np.asarray(js.alphas_prev), np.float32(ps.alphas_prev))
    assert list(trailing_timesteps(1000, 2)) == [999, 499]


def _engine(port_slice, batch_size=2, guidance=1.0, with_template=False):
    bundle, frozen, lora = port_slice
    template = {k: torch.zeros_like(v) for k, v in lora.items()} if with_template else None
    return InferenceEngine(
        bundle, DDIMSampler.create(make_ddpm_schedule(), 2), frozen, template,
        {"input_ids": HashTokenizer()},
        EngineConfig(batch_size=batch_size, latent_hw=8, guidance_scale=guidance),
        CPU)


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_engine_padding_and_seed_reproducibility(port_slice, guidance):
    """A request's image depends on its prompt and seed only, not on the
    batch it rode in; partial batches are padded to the fixed size."""
    engine = _engine(port_slice, batch_size=3, guidance=guidance)
    solo = engine.generate_batch(["a red square"], [7])
    assert solo.shape == (1, 16, 16, 3) and solo.dtype == np.uint8
    full = engine.generate_batch(["a blue circle", "a red square", "x"], [8, 7, 9])
    np.testing.assert_array_equal(solo[0], full[1])
    assert np.any(full[0] != full[1])
    assert engine.stats == {"requests": 4, "batches": 2, "pad_rows": 2, "lora_swaps": 0}
    with pytest.raises(ValueError):
        engine.generate_batch(["a"] * 4, [0] * 4)


def test_engine_adapters(port_slice):
    engine = _engine(port_slice, with_template=True)
    base = engine.generate_batch(["adapter test"], [5])
    trained = port_slice[2]
    engine.register_adapter("style", trained)
    assert engine.adapter_names == ["style"]
    via_name = engine.generate_batch(["adapter test"], [5], adapter="style")
    assert np.any(via_name != base)
    engine.load_lora(trained)
    assert engine.stats["lora_swaps"] == 1
    np.testing.assert_array_equal(engine.generate_batch(["adapter test"], [5]), via_name)
    with pytest.raises(KeyError, match="unknown adapter"):
        engine.generate_batch(["x"], [0], adapter="nope")
    with pytest.raises(ValueError, match="shape|dtype"):
        engine.load_lora({k: v.double() for k, v in trained.items()})
    with pytest.raises(ValueError, match="structure"):
        engine.load_lora(dict(list(trained.items())[:-2]))
    with pytest.raises(FileNotFoundError):  # a kohya path that is not there
        engine.load_lora("adapter.safetensors")
    engine.unregister_adapter("style")
    with pytest.raises(ValueError, match="without a LoRA tree"):
        _engine(port_slice).load_lora(trained)


def test_bundle_init_is_seeded():
    bundle = sd15_bundle(lora_rank=4, dtype=torch.float32, tiny=True)
    a, ta = bundle.init(torch.Generator(CPU).manual_seed(3), CPU)
    b, _ = bundle.init(torch.Generator(CPU).manual_seed(3), CPU)
    for k in a:
        for (n, x), y in zip(a[k].state_dict().items(), b[k].state_dict().values()):
            assert torch.equal(x, y), n
    assert all(not v.any() for k, v in ta.items() if k.endswith("lora_b"))
    ad = adapter_like(ta, torch.Generator(CPU).manual_seed(1))
    assert ad.keys() == ta.keys() and all(v.any() for v in ad.values())


def test_png_writer_round_trips():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_bytes(img)))), img)


def _post(url, payload, out=None, key=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        res = json.loads(r.read())
    if out is not None:
        out[key] = res
    return res


def test_http_server_batches_concurrent_requests(port_slice):
    engine = _engine(port_slice, batch_size=2)
    server = BatchingServer(engine, port=0, max_wait_ms=3000.0)
    server.start()
    url = "http://%s:%d" % server.address
    try:
        results = {}
        threads = [threading.Thread(target=_post, args=(url + "/generate",
                                                        {"prompt": f"image {i}", "seed": i},
                                                        results, i)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url + "/generate", {"seed": 1})
        with pytest.raises(urllib.error.HTTPError) as lora:
            _post(url + "/lora", {"path": "a.safetensors"})
    finally:
        server.stop()
    assert bad.value.code == 400 and lora.value.code == 400  # no such kohya file
    assert health["ok"] and health["stats"]["requests"] == 2
    assert stats["window"] == 2 and stats["errors"] == 0
    assert stats["batch_occupancy"] == 1.0  # both requests rode one full batch
    assert {r["batch_size"] for r in results.values()} == {2}
    solo = engine.generate_batch(["image 1"], [1])[0]
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(results[1]["image_b64"]))))
    np.testing.assert_array_equal(img, solo)


def test_serve_entry_point_tiny_cpu():
    """``python -m pcm_tpu_torch.serving --tiny --device cpu`` answers a request."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pcm_tpu_torch.serving", "--tiny", "--device", "cpu",
         "--batch-size", "2", "--resolution", "16", "--port", "0", "--enable-lora-swap"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        port, deadline = None, time.time() + 240
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "server never came up"
        out = _post(f"http://127.0.0.1:{port}/generate", {"prompt": "cli smoke", "seed": 3})
        img = Image.open(io.BytesIO(base64.b64decode(out["image_b64"])))
        assert img.size == (16, 16)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_entry_point_takes_sd3_int8():
    """``--family sd3 --weights int8`` (refused before) passes the CLI's
    checks and builds a TINY engine whose MMDiT holds int8 codes."""
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, check_args

    ap = build_parser()
    args = ap.parse_args(["--family", "sd3", "--weights", "int8", "--tiny", "--device", "cpu",
                          "--resolution", "16", "--batch-size", "1"])
    check_args(ap, args)
    engine = build_engine(args)
    assert engine.frozen["mmdit"].proj_out.weight_values.dtype == torch.int8
    assert engine.generate_batch(["a cat"], [1]).shape == (1, 16, 16, 3)


@pytest.mark.parametrize("argv,msg", [
    # `scripts/serve.py`'s refusal of a batch that does not split over the cards
    (["--batch-size", "3", "--data-parallel", "2"], "divisible by --data-parallel"),
    (["--lora", "x.safetensors"], "no such file"),  # --lora is ported: tests/test_torch_kohya.py
])
def test_serve_entry_point_rejects_unported(argv, msg, capsys):
    from pcm_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code != 0 and msg in capsys.readouterr().err


def test_port_tokenizers_match_jax_package(tmp_path):
    """`resolve_tokenizers` of the port (its own ctypes binding of the native
    CLIP BPE) gives the JAX package's ids on a toy vocab, tower directories
    included; without a directory it falls back to hash tokenizers."""
    from pcm_tpu.data.tokenizer import resolve_tokenizers as jax_resolve
    from pcm_tpu_torch.data.tokenizer import NativeCLIPTokenizer, resolve_tokenizers

    d = tmp_path / "tokenizer"
    d.mkdir()
    vocab = {}
    for ch in "abcdehlortw12!,":
        vocab[ch], vocab[ch + "</w>"] = len(vocab), len(vocab) + 1
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("c", "a"), ("ca", "t</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    texts = ["hello world", "Hello, Cat!", "a cat 12", ""]
    ours = resolve_tokenizers(str(tmp_path), ["input_ids"], max_length=16)["input_ids"]
    ref = jax_resolve(str(tmp_path), ["input_ids"], max_length=16)["input_ids"]
    assert isinstance(ours, NativeCLIPTokenizer)
    np.testing.assert_array_equal(ours(texts), ref(texts))
    hashed = resolve_tokenizers(None, ["input_ids"])["input_ids"]
    np.testing.assert_array_equal(hashed(texts), HashTokenizer()(texts))
