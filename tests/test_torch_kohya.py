"""The port's safetensors and kohya interop against `safetensors.numpy` and
`pcm_tpu.lora.kohya`, and kohya files in the port's serving (CPU).

The adapter is a JAX LoRA tree of the TINY UNet, numpy-drawn, carried into
the port by `convert.lora_state_from_jax`. Exports must match the JAX
package's key for key and value for value (exactly: both are transposes and
dtype casts of the same numbers); files written by either package load in
the other. Serving runs the TINY SD1.5 engine (fp32).
"""

import json
import os
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as stn
import torch

from pcm_tpu.lora import kohya as jkohya
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu_torch.lora import kohya
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.serving import BatchingServer
from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, check_args
from pcm_tpu_torch.utils import safetensors
from torch_port_helpers import random_params

ALPHA = 8.0


@pytest.fixture(scope="module")
def jax_lora():
    spec = JLoRASpec(rank=4, alpha=ALPHA, targets=SD_UNET_LORA_TARGETS)
    v = random_params(JUNet(J_TINY_UNET, lora=spec).init, jnp.zeros((1, 16, 16, 4)),
                      jnp.zeros((1,)), jnp.zeros((1, 7, 32)), seed=21)
    return jax.tree.map(np.asarray, v["lora"])


def test_export_matches_jax(jax_lora):
    ours = kohya.to_kohya_state_dict(convert.lora_state_from_jax(jax_lora), ALPHA)
    ref = jkohya.to_kohya_state_dict(jax_lora, ALPHA)
    assert sorted(ours) == sorted(ref)
    assert any(k.startswith("lora_unet_mid_block_attentions_0_transformer_blocks_0_attn1_to_out_0")
               for k in ours)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_import_matches_jax(jax_lora):
    """The JAX package's export read back into the port's adapter layout: the
    converted JAX tree, and the file's alpha; a missing layer raises."""
    state = jkohya.to_kohya_state_dict(jax_lora, 12.0)
    template = convert.lora_state_from_jax(jax_lora)
    tree, alpha = kohya.from_kohya_state_dict(state, template, rank=4)
    assert alpha == 12.0 and tree.keys() == template.keys()
    for k, v in template.items():
        assert torch.equal(tree[k], v), k
    dropped = {k: v for k, v in state.items() if "mid_block" not in k}
    with pytest.raises(KeyError):
        kohya.from_kohya_state_dict(dropped, template, rank=4)
    assert kohya.from_kohya_state_dict({k: v for k, v in state.items()
                                        if not k.endswith(".alpha")}, template, 4)[1] == 4.0


def test_release_conventions_match_jax(jax_lora):
    state = jkohya.to_kohya_state_dict(jax_lora, ALPHA)
    for ours, ref in ((kohya.halve_fp16(state), jkohya.halve_fp16(state)),
                      (kohya.rescale_sqrt_alpha(state, 9.0),
                       jkohya.rescale_sqrt_alpha(state, 9.0))):
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def _tensors(rng):
    return {"f16": rng.standard_normal((3, 5)).astype(np.float16),
            "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "f64": rng.standard_normal((4,)),
            "i8": rng.integers(-128, 127, (7,), dtype=np.int8),
            "u8": rng.integers(0, 255, (2, 2), dtype=np.uint8),
            "i32": rng.integers(-5, 5, (3,), dtype=np.int32),
            "i64": rng.integers(-5, 5, (1, 3), dtype=np.int64),
            "scalar": np.asarray(8.0, np.float32),
            "empty": np.zeros((0, 4), np.float32)}


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_safetensors_cross_both_ways(tmp_path, writer):
    """F16, BF16, F32 (and F64, I8, U8, I32, I64, a scalar, an empty tensor)
    written by one implementation and read by the other, bit for bit."""
    rng = np.random.default_rng(3)
    plain = _tensors(rng)
    bf16 = rng.standard_normal((4, 6)).astype(np.float32).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "x.safetensors")
    if writer == "port":
        safetensors.save_file({**plain, "bf16": bf16.view(np.uint16)}, path, bf16=("bf16",))
        back = stn.load_file(path)
        assert back["bf16"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(back["bf16"].view(np.uint16), bf16.view(np.uint16))
    else:
        stn.save_file({**plain, "bf16": bf16}, path, metadata={"format": "np"})
        back = safetensors.load_file(path)
        assert back["bf16"].dtype == np.uint16
        np.testing.assert_array_equal(back["bf16"], bf16.view(np.uint16))
        as_f32 = safetensors.load_file(path, bf16_as_f32=True)["bf16"]
        np.testing.assert_array_equal(as_f32, bf16.astype(np.float32))
    for k, v in plain.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    if writer == "safetensors":  # the reader skips the header's metadata
        assert safetensors.read_header(path)["__metadata__"] == {"format": "np"}


def test_bf16_widening_and_bad_files(tmp_path):
    x = np.array([1.0, 1 + 2 ** -7, -2.5e-3, np.inf, np.nan, 3e38], np.float32)
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(safetensors.bf16_to_f32(bits),
                                  x.astype(ml_dtypes.bfloat16).astype(np.float32))
    junk = tmp_path / "junk.safetensors"
    junk.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00not json at all!")
    with pytest.raises(ValueError):
        safetensors.load_file(str(junk))
    short = tmp_path / "short.safetensors"
    safetensors.save_file({"a": np.ones((4, 4), np.float32)}, str(short))
    short.write_bytes(short.read_bytes()[:-8])  # the data cut short
    with pytest.raises(ValueError, match="spans bytes"):
        safetensors.load_file(str(short))


def test_kohya_files_cross_both_packages(tmp_path, jax_lora):
    """The port's fp16 export loads with the JAX package's loader, value for
    value. The JAX package's export (through `safetensors.numpy`) loads with
    the port's reader, which reads every tensor as `safetensors.numpy` does;
    its values are not compared with the tree, because that writer stores
    the transposed factors in their memory order (ROADMAP.md Queue 3)."""
    template = convert.lora_state_from_jax(jax_lora)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    kohya.save_kohya_safetensors(ours, template, ALPHA)
    jkohya.save_kohya_safetensors(theirs, jax_lora, ALPHA)
    assert safetensors.read_header(ours).keys() == safetensors.read_header(theirs).keys()
    jtree, jalpha = jkohya.load_kohya_safetensors(ours, jax_lora, 4)
    assert jalpha == ALPHA
    for k, v in convert.lora_state_from_jax(jax.tree.map(np.asarray, jtree)).items():
        assert torch.equal(v, template[k].half().float()), k
    raw, ref = safetensors.load_file(theirs), stn.load_file(theirs)
    assert raw.keys() == ref.keys()
    for k, v in ref.items():
        assert raw[k].dtype == v.dtype == np.float16 and raw[k].shape == v.shape, k
        np.testing.assert_array_equal(raw[k], v)
    ptree, palpha = kohya.load_kohya_safetensors(theirs, template, 4)
    assert palpha == ALPHA and ptree.keys() == template.keys()
    for k, v in ptree.items():
        kind = "lora_down" if k.endswith(".lora_a") else "lora_up"
        key = kohya.kohya_key(k.rsplit(".", 1)[0]) + f".{kind}.weight"
        assert torch.equal(v, torch.from_numpy(ref[key].astype(np.float32))), k


# ---------------------------------------------------------------------------
# kohya files in serving
# ---------------------------------------------------------------------------


def _args(*extra):
    return build_parser().parse_args(["--tiny", "--device", "cpu", "--batch-size", "2",
                                      "--resolution", "16", *extra])


@pytest.fixture(scope="module")
def kohya_files(tmp_path_factory):
    """Two adapters shaped like the tiny engine's template (rank 64), saved
    as kohya files: the default alpha (8) and alpha 16."""
    torch.set_num_threads(2)
    engine = build_engine(_args("--enable-lora-swap"))
    d = tmp_path_factory.mktemp("kohya")
    gen = torch.Generator().manual_seed(5)
    trees, paths = {}, {}
    for name, alpha in (("a", 8.0), ("b", 8.0), ("other_alpha", 16.0)):
        trees[name] = {k: torch.randn(v.shape, generator=gen) * 0.2 for k, v in engine.lora.items()}
        paths[name] = str(d / f"{name}.safetensors")
        kohya.save_kohya_safetensors(paths[name], trees[name], alpha)
    return trees, paths


def test_serve_lora_flag_serves_the_file(kohya_files):
    """``--lora`` starts the engine with the file as its default adapter (no
    swap counted): the same images as the engine fed its fp16-rounded dict."""
    trees, paths = kohya_files
    engine = build_engine(_args("--lora", paths["a"]))
    assert engine.lora_source == paths["a"] and engine.stats["lora_swaps"] == 0
    got = engine.generate_batch(["served"], [3])
    engine.load_lora({k: v.half().float() for k, v in trees["a"].items()})
    np.testing.assert_array_equal(got, engine.generate_batch(["served"], [3]))
    plain = build_engine(_args())
    assert plain.lora is None
    assert np.any(got != plain.generate_batch(["served"], [3]))
    ap = build_parser()
    with pytest.raises(SystemExit):
        check_args(ap, ap.parse_args(["--lora", paths["a"] + ".missing"]))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_post_lora_swaps_and_registers(kohya_files, tmp_path):
    trees, paths = kohya_files
    engine = build_engine(_args("--lora", paths["a"]))
    server = BatchingServer(engine, port=0, max_wait_ms=10.0)
    server.start()
    url = "http://%s:%d" % server.address
    try:
        first = _post(url + "/generate", {"prompt": "p", "seed": 1})
        swap = _post(url + "/lora", {"path": paths["b"]})
        second = _post(url + "/generate", {"prompt": "p", "seed": 1})
        named = _post(url + "/lora", {"path": paths["a"], "name": "style_a"})
        via_name = _post(url + "/generate", {"prompt": "p", "seed": 1, "adapter": "style_a"})
        codes = {}
        bad_file = tmp_path / "bad.safetensors"
        bad_file.write_bytes(b"\x00" * 16)
        wrong = tmp_path / "wrong.safetensors"
        kohya.save_kohya_safetensors(str(wrong), dict(list(trees["a"].items())[:-2]), 8.0)
        for label, payload in (("missing", {"path": str(tmp_path / "nope.safetensors")}),
                               ("not_safetensors", {"path": str(bad_file)}),
                               ("layers_missing", {"path": str(wrong)}),
                               ("no_path", {"name": "x"})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/lora", payload)
            codes[label] = e.value.code
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.stop()
    assert swap["ok"] and swap["swaps"] == 1 and swap["lora"] == paths["b"]
    assert first["image_b64"] != second["image_b64"]
    assert via_name["image_b64"] == first["image_b64"]
    assert named["adapters"] == ["style_a"] and named["swaps"] == 1
    assert codes == {"missing": 400, "not_safetensors": 400, "layers_missing": 400,
                     "no_path": 400}
    assert stats["swaps"] == 1 and stats["lora"] == paths["b"]  # the bad posts changed nothing
    ref = {k: v.half().float() for k, v in trees["b"].items()}
    assert all(torch.equal(engine.lora[k], v) for k, v in ref.items())


def test_alpha_mismatch_warns(kohya_files):
    trees, paths = kohya_files
    engine = build_engine(_args("--enable-lora-swap"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine.load_lora(paths["a"])
    assert not [w for w in caught if "alpha" in str(w.message)]
    with pytest.warns(UserWarning, match="alpha=16.0"):
        engine.load_lora(paths["other_alpha"])
    assert engine.stats["lora_swaps"] == 2 and engine.lora_source == paths["other_alpha"]


def test_trainer_file_serves(tmp_path):
    """A kohya file the trainer wrote (tiny CPU run from cached latents)
    loads into the tiny engine and changes its images."""
    from pcm_tpu_torch.train.__main__ import main as train_main

    rng = np.random.default_rng(4)
    (tmp_path / "cache").mkdir()
    np.savez(tmp_path / "cache" / "shard_00000.npz",
             latents=rng.standard_normal((4, 8, 8, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((4, 77, 32)).astype(np.float16))
    out = tmp_path / "run"
    train_main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--cached-latents-dir",
                str(tmp_path / "cache"), "--output-dir", str(out), "--batch-size", "2",
                "--max-train-steps", "2", "--checkpointing-steps", "1", "--learning-rate", "0.05"])
    files = sorted(os.listdir(out))
    assert "pcm_lora_0000001.safetensors" in files and "pcm_lora_0000002.safetensors" in files
    header = safetensors.read_header(str(out / "pcm_lora_0000002.safetensors"))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"F16"}
    engine = build_engine(_args("--enable-lora-swap"))
    before = engine.generate_batch(["trained"], [2])
    engine.load_lora(str(out / "pcm_lora_0000002.safetensors"))
    ck = torch.load(out / "checkpoints" / "step_0000002.pt", weights_only=True)
    for k, v in ck["lora"].items():
        assert torch.equal(engine.lora[k], v.half().float()), k
    assert np.any(engine.generate_batch(["trained"], [2]) != before)


def test_jax_written_file_loads_into_the_engine(tmp_path):
    """A kohya file of the JAX package (its TINY UNet's rank-64 LoRA, the
    shape of the tiny engine's template) swaps into the port's engine: each
    factor is what `safetensors.numpy` reads from the file, in fp32."""
    spec = JLoRASpec(rank=64, alpha=ALPHA, targets=SD_UNET_LORA_TARGETS)
    v = random_params(JUNet(J_TINY_UNET, lora=spec).init, jnp.zeros((1, 16, 16, 4)),
                      jnp.zeros((1,)), jnp.zeros((1, 7, 32)), seed=22)
    path = str(tmp_path / "jax.safetensors")
    jkohya.save_kohya_safetensors(path, jax.tree.map(np.asarray, v["lora"]), ALPHA)
    engine = build_engine(_args("--enable-lora-swap"))
    engine.load_lora(path)
    ref = stn.load_file(path)
    assert engine.lora_source == path and engine.stats["lora_swaps"] == 1
    for k, t in engine.lora.items():
        kind = "lora_down" if k.endswith(".lora_a") else "lora_up"
        key = kohya.kohya_key(k.rsplit(".", 1)[0]) + f".{kind}.weight"
        assert t.dtype == torch.float32
        assert torch.equal(t, torch.from_numpy(ref[key].astype(np.float32))), k
    assert engine.generate_batch(["jax file"], [1]).shape == (1, 16, 16, 3)
