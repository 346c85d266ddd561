"""The rest of the port's trainer on the CPU: Prodigy against
`pcm_tpu/train/prodigy.py`, validation grids, the non-finite-loss abort,
asynchronous checkpoint saves, ``--optimizer prodigy``, ``--validation-steps``
and ``--offload-encoders`` through ``python -m pcm_tpu_torch.train``, and the
image loader's native library built by two processes at once.

Bounds: Prodigy's parameters rel-max 1e-5 of each tensor's largest value
over 5 steps, ``prodigy_d`` rtol 1e-6 (the sums over the tree run in
another order than XLA's); a resumed Prodigy state equal, bit for bit, to
the one saved.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from pcm_tpu.train.prodigy import prodigy_d as jax_prodigy_d
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.data import native_image
from pcm_tpu_torch.train import distill, loop
from pcm_tpu_torch.train.__main__ import main as train_main
from pcm_tpu_torch.train.loop import LoopConfig, Trainer
from pcm_tpu_torch.train.prodigy import prodigy_d
from pcm_tpu_torch.train.state import TrainState, apply_updates, make_optimizer

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Prodigy
# ---------------------------------------------------------------------------


def _lora_tree(rng):
    """LoRA factors of a Linear and a 3x3 conv, keys sorted (JAX's leaf order)."""
    return {"conv.lora_a": 0.1 * rng.standard_normal((4, 8, 3, 3)).astype(np.float32),
            "conv.lora_b": np.zeros((8, 4, 1, 1), np.float32),
            "proj.lora_a": 0.1 * rng.standard_normal((4, 16)).astype(np.float32),
            "proj.lora_b": np.zeros((12, 4), np.float32)}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_prodigy_matches_jax(weight_decay):
    """5 updates through both packages' ``make_optimizer(optimizer="prodigy")``
    (global-norm clipping at 1, then Prodigy at lr 1) on gradients that pull
    toward a target, so ``d`` grows and the clip acts."""
    rng = np.random.default_rng(0)
    params = _lora_tree(rng)
    target = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    jtx = jax_make_optimizer(1.0, weight_decay=weight_decay, optimizer="prodigy")
    tx = make_optimizer(1.0, weight_decay=weight_decay, optimizer="prodigy")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    state = TrainState.create({k: torch.from_numpy(v.copy()) for k, v in params.items()}, tx)
    ds = []
    for _ in range(5):
        g = {k: np.asarray(jp[k]) - target[k] + 0.1 * rng.standard_normal(v.shape)
             for k, v in params.items()}
        g = {k: v.astype(np.float32) for k, v in g.items()}
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        state = apply_updates(state, {k: torch.from_numpy(v) for k, v in g.items()}, tx)
        for k in params:
            ref = np.asarray(jp[k])
            err = np.abs(state.params[k].numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-5, (k, err)
        d, jd = float(prodigy_d(state.opt_state)), float(jax_prodigy_d(jstate))
        np.testing.assert_allclose(d, jd, rtol=1e-6)
        ds.append(d)
    assert ds[-1] > 10 * ds[0] and state.opt_state["count"] == 5
    assert prodigy_d(make_optimizer(1e-3).init(state.params)) is None  # AdamW's


def _write_cache(path, n=4, sdxl=False):
    rng = np.random.default_rng(4)
    path.mkdir()
    arrays = {"latents": rng.standard_normal((n, 8, 8, 4)).astype(np.float16),
              "prompt_embeds": rng.standard_normal((n, 77, 32)).astype(np.float16)}
    if sdxl:
        arrays.update(pooled_embeds=rng.standard_normal((n, 32)).astype(np.float16),
                      time_ids=np.tile(np.array([16, 16, 0, 0, 16, 16], np.float32), (n, 1)))
    np.savez(path / "shard_00000.npz", **arrays)


def _tiny(cache, out, *extra):
    return ["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--cached-latents-dir",
            str(cache), "--output-dir", str(out), "--batch-size", "2", "--log-every", "1",
            "--validation-steps", "0", *extra]


def test_prodigy_state_saves_and_resumes(tmp_path):
    """A Prodigy run's checkpoint holds its whole state, and a rerun resumes
    it bit for bit (``d``, ``d_numerator``, ``p0``, both moments, ``s``, the
    count), then steps on; AdamW refuses it."""
    cache = tmp_path / "cache"
    _write_cache(cache)
    prodigy = ["--optimizer", "prodigy", "--learning-rate", "1.0"]
    first = train_main(_tiny(cache, tmp_path / "run", *prodigy, "--max-train-steps", "2"))
    ck = torch.load(tmp_path / "run" / "checkpoints" / "step_0000002.pt", weights_only=True)
    assert sorted(ck["opt_state"]) == ["count", "d", "d_numerator", "exp_avg", "exp_avg_sq",
                                       "p0", "s"]
    torch.testing.assert_close(ck["opt_state"], first.state.opt_state, rtol=0, atol=0)
    resumed = train_main(_tiny(cache, tmp_path / "run", *prodigy, "--max-train-steps", "2"))
    assert resumed.resumed_from == 2 and resumed.global_step == 2
    torch.testing.assert_close(resumed.state.opt_state, ck["opt_state"], rtol=0, atol=0)
    torch.testing.assert_close(resumed.state.params, ck["lora"], rtol=0, atol=0)
    on = train_main(_tiny(cache, tmp_path / "run", *prodigy, "--max-train-steps", "3"))
    assert on.state.opt_state["count"] == 3 and torch.isfinite(on.state.opt_state["d"])
    torch.testing.assert_close(on.state.opt_state["p0"], ck["opt_state"]["p0"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not match"):  # AdamW on a Prodigy checkpoint
        train_main(_tiny(cache, tmp_path / "run", "--max-train-steps", "4"))


@pytest.mark.parametrize("extra", [[], ["--use-8bit-adam"]], ids=["adamw", "adamw8bit"])
def test_adamw_resume_continues_bit_equal(tmp_path, extra):
    """Three AdamW steps in one run, and two then a resumed third: the same
    loss, LoRA and optimizer state, bit for bit. The resumed update starts
    from the checkpoint's separate tensors, the other from the views of the
    flat vectors the update before returned. The cache holds one sample
    twice, so every batch is the same (a resumed run starts the data order
    anew, as the JAX loader does); the draws resume with the generator."""
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(4)
    np.savez(cache / "shard_00000.npz",
             latents=np.repeat(rng.standard_normal((1, 8, 8, 4)).astype(np.float16), 2, 0),
             prompt_embeds=np.repeat(rng.standard_normal((1, 77, 32)).astype(np.float16), 2, 0))
    whole = train_main(_tiny(cache, tmp_path / "whole", *extra, "--max-train-steps", "3"))
    train_main(_tiny(cache, tmp_path / "parts", *extra, "--max-train-steps", "2"))
    resumed = train_main(_tiny(cache, tmp_path / "parts", *extra, "--max-train-steps", "3"))
    assert resumed.resumed_from == 2 and resumed.state.opt_state["count"] == 3
    torch.testing.assert_close(resumed.state.params, whole.state.params, rtol=0, atol=0)
    torch.testing.assert_close(resumed.state.opt_state, whole.state.opt_state, rtol=0, atol=0)
    assert _rows(tmp_path / "parts")[-1]["loss"] == _rows(tmp_path / "whole")[-1]["loss"]


# ---------------------------------------------------------------------------
# the loop: validation, the abort, asynchronous saves
# ---------------------------------------------------------------------------


def _trainer(out, max_steps, losses=None, on_step=None, **cfg):
    """A Trainer over a stub step that adds 1 to every factor and reports
    ``losses[global step]`` (1.0 by default)."""
    def step(state, d_state, frozen, batch, draws, global_step):
        if on_step is not None:
            on_step(global_step + 1)
        params = {k: v + 1 for k, v in state.params.items()}
        loss = (losses or {}).get(global_step + 1, 1.0)
        metrics = {"loss": torch.tensor(loss), "grad_norm": torch.tensor(0.5)}
        return TrainState(state.step + 1, params, state.opt_state), d_state, metrics, 1

    cfg = {"log_every": 1, "checkpointing_steps": 0, "resume": False, **cfg}
    tx = make_optimizer(1e-3)
    return Trainer(LoopConfig(str(out), max_steps, **cfg), None,
                   TrainState.create({"x.lora_a": torch.zeros(2, 3),
                                      "x.lora_b": torch.zeros(4, 2)}, tx),
                   step, distill.DistillConfig(), lambda batch: batch["latents"], CPU)


def _data(n=10):
    return iter([{"latents": np.ones((1, 2, 2, 4), np.float32)}] * n)


def _rows(out):
    import json

    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_validation_cadence_and_files(tmp_path):
    """``validation_fn`` runs every ``validation_steps`` global steps with the
    step's frozen modules and LoRA; each tag's grid lands under
    ``images/validation/`` and a ``validation_s`` row is logged."""
    calls = []

    def validation_fn(frozen, lora, step):
        calls.append((step, float(lora["x.lora_a"][0, 0])))
        imgs = np.linspace(-1, 1, 5 * 4 * 6 * 3, dtype=np.float32).reshape(5, 4, 6, 3)
        return {"cfg1": imgs, "cfg7.5": torch.from_numpy(-imgs)}

    tr = _trainer(tmp_path, 5, validation_steps=2)
    tr.validation_fn = validation_fn
    tr.run(_data())
    assert calls == [(2, 2.0), (4, 4.0)]
    for step in (2, 4):
        for tag in ("cfg1", "cfg7.5"):
            grid = np.asarray(Image.open(tmp_path / "images" / "validation" /
                                         f"{tag}_{step:07d}.png"))
            assert grid.shape == (8, 24, 3)  # 5 images: 2 rows of 4 columns
    assert [r["step"] for r in _rows(tmp_path) if "validation_s" in r] == [2, 4]


@pytest.mark.parametrize("key", ["loss", "d_loss", "g_loss"])
def test_non_finite_loss_raises(tmp_path, key):
    """A non-finite loss at a log boundary raises FloatingPointError naming
    the step and the last checkpoint; that step is not saved."""
    def step(state, d_state, frozen, batch, draws, global_step):
        metrics = {"loss": torch.tensor(1.0), key: torch.tensor(
            float("nan") if global_step + 1 == 3 else 1.0)}
        return TrainState(state.step + 1, state.params, state.opt_state), d_state, metrics, 1

    tr = _trainer(tmp_path, 5, checkpointing_steps=2)
    tr.step = step
    with pytest.raises(FloatingPointError, match=r"at step 3: \{'%s'.*last checkpoint: step 2"
                       % key):
        tr.run(_data())
    assert [os.path.basename(p) for p in tr.checkpoints()] == ["step_0000002.pt"]


def test_async_save_is_complete_and_resumable(tmp_path):
    """Saves every 2 steps written off the step thread; a new Trainer resumes
    the newest: its step, LoRA, optimizer count and generator state."""
    tr = _trainer(tmp_path, 5, checkpointing_steps=2)
    tr.run(_data())
    names = [os.path.basename(p) for p in tr.checkpoints()]
    assert names == ["step_0000002.pt", "step_0000004.pt", "step_0000005.pt"]
    assert not [f for f in os.listdir(tmp_path / "checkpoints") if f.endswith(".tmp")]
    assert os.path.exists(tmp_path / "pcm_lora_0000004.safetensors")
    assert max(r["save_s"] for r in _rows(tmp_path) if "save_s" in r) > 0
    again = _trainer(tmp_path, 6, checkpointing_steps=2, resume=True)
    assert again.resumed_from == 5 and again.last_saved == 5
    torch.testing.assert_close(again.state.params["x.lora_b"], torch.full((4, 2), 5.0))
    torch.testing.assert_close(again.generator.get_state(), tr.generator.get_state())


def test_async_save_rotation_keeps_the_limit(tmp_path):
    tr = _trainer(tmp_path, 6, checkpointing_steps=1, checkpoints_total_limit=2)
    tr.run(_data())
    assert [os.path.basename(p) for p in tr.checkpoints()] == ["step_0000005.pt",
                                                              "step_0000006.pt"]
    assert len([f for f in os.listdir(tmp_path) if f.startswith("pcm_lora_")]) == 6


def test_failed_write_raises_at_the_next_wait(tmp_path):
    """A write that fails (its directory replaced by a file) raises on the
    step thread at the next save's wait, not silently."""
    def break_dir(step):
        if step == 3:
            trainers[0].writer.wait()  # the step-2 file is written
            os.rename(tmp_path / "checkpoints", tmp_path / "moved")
            (tmp_path / "checkpoints").write_text("not a directory")

    trainers = [_trainer(tmp_path, 8, on_step=break_dir, checkpointing_steps=2)]
    tr = trainers[0]
    with pytest.raises((OSError, RuntimeError), match="checkpoints"):
        tr.run(_data())
    assert tr.global_step == 6  # the step-4 write failed; the step-6 save waited for it
    assert not any(t.name == "pcm-checkpoint-writer" for t in threading.enumerate())


def test_sigterm_waits_for_the_writer(tmp_path, monkeypatch):
    """SIGTERM during a run whose writes are slow: the run ends after the
    step in flight, and returns only once its last checkpoint is on disk,
    complete, with no writer thread left."""
    real_save = torch.save

    def slow_save(obj, path):
        time.sleep(0.5)
        real_save(obj, path)

    monkeypatch.setattr(loop.torch, "save", slow_save)

    def term(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    tr = _trainer(tmp_path, 10, on_step=term, checkpointing_steps=2)
    before = signal.getsignal(signal.SIGTERM)
    tr.run(_data())
    assert tr.global_step == 3 and tr.last_saved == 3
    ck = torch.load(tmp_path / "checkpoints" / "step_0000003.pt", weights_only=True)
    assert ck["step"] == 3 and float(ck["lora"]["x.lora_a"][0, 0]) == 3.0
    assert any(r.get("preempted") for r in _rows(tmp_path))
    assert not any(t.name == "pcm-checkpoint-writer" for t in threading.enumerate())
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_prodigy_with_validation(tmp_path, capsys):
    """``--optimizer prodigy --validation-steps 2`` with two prompts for 4
    steps: the warning of an lr far from 1, ``prodigy_d`` in every log row,
    grids at steps 2 and 4 of 8 images (2 prompts x 4) at cfg 1 and 7.5."""
    cache = tmp_path / "cache"
    _write_cache(cache)
    out = tmp_path / "run"
    train_main(_tiny(cache, out, "--optimizer", "prodigy", "--learning-rate", "0.05",
                     "--max-train-steps", "4", "--validation-steps", "2",
                     "--validation-prompts", "a red square", "a blue circle",
                     "--checkpointing-steps", "2"))
    err = capsys.readouterr().err
    assert "learning rate around 1.0" in err
    rows = _rows(out)
    assert all(np.isfinite(r["prodigy_d"]) for r in rows if "loss" in r)
    files = sorted(os.listdir(out / "images" / "validation"))
    assert files == ["cfg1_0000002.png", "cfg1_0000004.png", "cfg7.5_0000002.png",
                     "cfg7.5_0000004.png"]
    grid = np.asarray(Image.open(out / "images" / "validation" / "cfg1_0000004.png"))
    assert grid.shape == (2 * 16, 4 * 16, 3)  # the cache's 8x8 latents, 16 px


def test_train_cli_offload_encoders_sdxl(tmp_path):
    """SDXL on caches with validation builds the towers and the VAE, encodes
    the prompts and frees the towers; ``--offload-encoders`` keeps the UNet
    alone on the device and a host VAE that each validation call uses."""
    cache = tmp_path / "cache"
    _write_cache(cache, sdxl=True)
    argv = ["--recipe", "sdxl_4phase_adv", "--tiny", "--device", "cpu", "--cached-latents-dir",
            str(cache), "--batch-size", "2", "--log-every", "2", "--max-train-steps", "2",
            "--adv-pairing", "fused", "--validation-steps", "2", "--validation-prompts", "a cat"]
    kept = train_main(argv + ["--output-dir", str(tmp_path / "a")])
    assert sorted(kept.frozen) == ["unet", "vae"]
    off = train_main(argv + ["--output-dir", str(tmp_path / "b"), "--offload-encoders"])
    assert sorted(off.frozen) == ["unet"]
    for d in ("a", "b"):
        assert os.path.exists(tmp_path / d / "images" / "validation" / "cfg7.5_0000002.png")
    a, b = (np.asarray(Image.open(tmp_path / d / "images" / "validation" / "cfg1_0000002.png"))
            for d in ("a", "b"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra,msg", [
    (["--optimizer", "prodigy", "--lr-scheduler", "cosine"], "takes no learning-rate schedule"),
    (["--offload-encoders", "--train-data-dir", "imgs"], "requires --cached-latents-dir"),
], ids=["prodigy_schedule", "offload_pixels"])
def test_train_cli_refuses(tmp_path, capsys, extra, msg):
    argv = ["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--output-dir",
            str(tmp_path / "o"), *extra]
    if "--train-data-dir" not in extra:
        argv += ["--cached-latents-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as exc:
        train_main(argv)
    assert exc.value.code != 0 and msg in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the image loader's native library
# ---------------------------------------------------------------------------


def test_native_library_builds_from_two_processes(tmp_path):
    """Two processes build the library to one path at once: each loads a
    whole library (the build is locked and renamed into place), and no
    temporary file is left."""
    if not native_image.available():
        pytest.skip(f"the native image library does not build here: {native_image.native_error()}")
    path = str(tmp_path / "lib" / "libimage_pipe.so")
    code = ("import sys, ctypes\n"
            "from pcm_tpu_torch.data import native_image as n\n"
            "n.build_native(sys.argv[1])\n"
            "lib = n._load(sys.argv[1])\n"
            "print(bool(lib.ip_load_resized))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, path], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-1000:] for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["True", "True"]
    assert sorted(os.listdir(tmp_path / "lib")) == ["libimage_pipe.so", "lock"]


def test_tokenizer_library_builds_from_two_processes(tmp_path):
    """The CLIP BPE library goes through the same locked build: two processes
    build it to one path at once and each loads a whole library; the
    tokenizer's own build lands under ``build/``, and nothing is written
    under ``native/``."""
    native_dir = os.path.join(REPO, "native")
    before = sorted(os.listdir(native_dir))
    path = str(tmp_path / "lib" / "libclip_bpe.so")
    code = ("import sys\n"
            "from pcm_tpu_torch.data import native_image as n\n"
            "n.build_native(sys.argv[1], 'clip_bpe.cpp', ())\n"
            "import ctypes\n"
            "print(bool(ctypes.CDLL(sys.argv[1]).clip_bpe_new))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, path], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-1000:] for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["True", "True"]
    assert sorted(os.listdir(tmp_path / "lib")) == ["libclip_bpe.so", "lock"]
    from pcm_tpu_torch.data.tokenizer import NativeCLIPTokenizer

    vocab, merges = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vocab.write_text('{"a</w>": 0, "b</w>": 1}')
    merges.write_text("#version: 0.2\n")
    tok = NativeCLIPTokenizer(str(vocab), str(merges), max_length=4)
    assert tok(["a b"]).tolist() == [[49406, 0, 1, 49407]]
    assert os.path.exists(native_image.native_library("clip_bpe.cpp", ()))
    assert sorted(os.listdir(native_dir)) == before
