"""Data parallelism of the port (`pcm_tpu_torch/parallel/`) on the CPU.

Ranks are gloo processes spawned here (`tests/torch_parallel_worker.py`, or
``python -m torch.distributed.run`` for the trainer's CLI) on a free port
the OS gives; every spawn has its own timeout and shows its stderr on
failure. TINY sizes, fp32. The rule held: N ranks at a batch of B compute
what one process computes on the global batch of N x B rows (the ranks'
batches in rank order), with the draws of each global microbatch split
over the ranks.

Bounds: the DDIM step against the JAX package's on the global batch, those
of `tests/test_torch_train.py` (loss rtol 1e-5, grad norm rtol 1e-3, LoRA
atol 1e-5 with Adam's eps 1e-2); the SD3 flow step and the adversarial
fused pair against the port's one-process step, atol 1e-5 (rtol 1e-5 for
the losses); the trainer's CLI against a one-process run at the global
batch, loss rtol 1e-5, Adam's first moment (linear in the gradients) within
1e-3 of its largest (the gradients' bound of `tests/test_torch_train.py`)
and the LoRA atol 1e-5 at a learning rate of 1e-5: the
CLI keeps Adam's eps at 1e-8, which turns a gradient's round-off near zero
into up to lr per element (a test that sets the optimizer raises eps
instead); a wrong gradient moves an element by up to 2 lr a step, and its
first moment by far more; the sharded engine against one-device engines,
byte for byte.
"""

import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.core import losses as jlosses
from pcm_tpu.core import make_ddpm_schedule as jax_schedule
from pcm_tpu.core import solver as jsolver
from pcm_tpu.data.dataset import shard_for_process as jax_shard_for_process
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.train import distill as jdistill
from pcm_tpu.train.bundles import SD15Bundle as JSD15Bundle
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.train.state import TrainState as JTrainState
from pcm_tpu.train.state import make_optimizer as jax_make_optimizer
from pcm_tpu_torch.configs.families import RECIPES
from pcm_tpu_torch.core.schedule import make_ddpm_schedule
from pcm_tpu_torch.data import cached
from pcm_tpu_torch.data.dataset import shard_for_process
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.parallel import mesh
from pcm_tpu_torch.train import adv, distill
from chip_smoke import write_ddp_caches
from torch_parallel_worker import EPS, GROUPS, LR, RANK, run_job
from torch_port_helpers import random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT = 120  # seconds, each spawn
WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="2", **extra)
    return env


def _wait(procs, timeout=TIMEOUT):
    """Each process's (returncode, stdout, stderr); all are killed past
    ``timeout``, and a failure shows the stderr."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [rc for rc, _, _ in outs] == [0] * len(procs), \
        "\n---\n".join(err[-3000:] for _, _, err in outs)
    return outs


# ---------------------------------------------------------------------------
# (1) the file shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,world", [(5, 2), (7, 3), (4, 4), (3, 1)])
def test_shard_for_process_matches_jax(n, world):
    files = [f"shard_{i:05d}.npz" for i in range(n)]
    for index in range(world):
        assert shard_for_process(files, index, world) == jax_shard_for_process(files, index,
                                                                                world)


def test_cached_dataset_shards_and_refuses_a_rank_without_a_file(tmp_path):
    for i in range(3):
        np.savez(tmp_path / f"shard_{i:05d}.npz", latents=np.full((2, 1), i, np.float16))
    ds = cached.CachedLatentsDataset(str(tmp_path), process_index=1, process_count=2)
    assert [os.path.basename(f) for f in ds.files] == ["shard_00001.npz"]
    assert len(ds) == 2 and float(ds.get(1)["latents"][0]) == 1.0
    with pytest.raises(ValueError, match="3 shard files .* for 4 ranks"):
        cached.CachedLatentsDataset(str(tmp_path), process_index=0, process_count=4)


# ---------------------------------------------------------------------------
# (2) and (3): the steps on 2 ranks
# ---------------------------------------------------------------------------

DDIM_CASES = {"cfg_adamw": (False, 1, False), "nocfg_adamw8bit": (True, 1, True),
              "cfg_accum2": (False, 2, False)}


def _global_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "prompt_embeds": rng.standard_normal((n, 7, 32), dtype=np.float32),
            "uncond_embeds": rng.standard_normal((n, 7, 32), dtype=np.float32) * 0.1}


def _ddim_jobs():
    """The three DDIM cases' jobs and the JAX package's step on each global
    batch (microbatches of 2 a rank, so global microbatches of 4): its grad_fn body (`ddim_prepare`, `ddim_model_pred`, the
    consistency loss) per interleaved microbatch under the keys of
    `accumulate_grads`, the mean over the microbatches, then the step's tail
    (`_grad_norm`, `_apply_updates`); the draws of each microbatch are fed
    to the port, as `tests/test_torch_train.py` feeds them."""
    spec = JLoRASpec(rank=RANK, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    junet = dataclasses.replace(J_TINY_UNET, norm_groups=GROUPS)
    v = random_params(JUNet(junet, lora=spec).init, jnp.zeros((1, 8, 8, 4)),
                      jnp.zeros((1,)), jnp.zeros((1, 7, 32)), seed=11)
    text_cfg = JCLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    jbundle = JSD15Bundle(junet, J_TINY_VAE, text_cfg, spec, dtype=jnp.float32)
    jfrozen = {"unet": v["params"]}
    jsched = jax_schedule()
    jsol = jsolver.PhasedDDIMSolver.create(jsched, 10)
    bounds = jnp.asarray(jsolver.phase_boundaries(10, 2))
    unet_state = convert.unet_state_from_jax(v["params"])

    @functools.lru_cache(maxsize=None)  # one XLA compile per CFG branch
    def jitted(jcfg):
        def grad_fn(lora, mb, key):
            parts = jdistill.ddim_prepare(jbundle, jsched, jsol, bounds, jcfg, jfrozen, lora, mb,
                                          key)

            def loss_fn(lora_):
                pred = jdistill.ddim_model_pred(jbundle, jsched, jsol, jcfg, jfrozen, lora_,
                                                parts)
                return jlosses.consistency_loss(pred, parts["target"], jcfg.loss_type,
                                                jcfg.huber_c)

            return {k: parts[k] for k in ("noise", "index", "w")}, \
                jax.value_and_grad(loss_fn)(lora)

        return jax.jit(grad_fn)

    jobs, refs = {}, {}
    for name, (not_cfg, accum, use_8bit) in DDIM_CASES.items():
        cfg_kw = dict(num_solver_steps=10, multiphase=2, w_min=4.0, w_max=5.0,
                      not_apply_cfg_solver=not_cfg)
        jcfg = jdistill.DistillConfig(**cfg_kw)
        grad_fn = jitted(jcfg)

        batch = _global_batch(2 * WORLD * accum, 12)
        key = jax.random.fold_in(jax.random.PRNGKey(5), 0)
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        jtx = jax_make_optimizer(LR, eps=EPS, use_8bit=use_8bit)
        jstate = JTrainState.create(v["lora"], jtx)
        micro = [grad_fn(v["lora"], {k: jnp.asarray(x[a::accum]) for k, x in batch.items()},
                         keys[a]) for a in range(accum)]
        loss = sum(m[1][0] for m in micro) / accum
        grads = jax.tree.map(lambda *g: sum(g) / accum, *(m[1][1] for m in micro))
        jstate2 = jax.jit(lambda s, g: jdistill._apply_updates(s, g, jtx))(jstate, grads)
        refs[name] = {"loss": float(loss), "grad_norm": float(jdistill._grad_norm(grads)),
                      "params": convert.lora_state_from_jax(jstate2.params)}
        # the 8-bit moments start from the port's own (zero) init
        opt_state = None if use_8bit else convert.train_state_from_jax(jstate).opt_state
        jobs[name] = {"kind": "ddim", "unet": unet_state, "cfg": cfg_kw, "accum": accum,
                      "use_8bit": use_8bit, "params": convert.lora_state_from_jax(v["lora"]),
                      "opt_state": opt_state, "batch": batch,
                      "draws": [{k: np.asarray(x) for k, x in m[0].items()} for m in micro]}
    return jobs, refs


def _port_jobs():
    """The SD3 flow step (fixed w = 3) and the ``sd15_2phase_adv`` fused
    pair on global batches of 4, their draws from a seeded generator."""
    rng = np.random.default_rng(20)
    n = 2 * WORLD
    sd3_batch = {"latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
                 "prompt_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32),
                 "pooled_embeds": rng.standard_normal((n, 32), dtype=np.float32),
                 "uncond_embeds": rng.standard_normal((n, 14, 32), dtype=np.float32) * 0.1,
                 "uncond_pooled": rng.standard_normal((n, 32), dtype=np.float32) * 0.1}
    flow_kw = dict(num_solver_steps=10, multiphase=2, fixed_w=3.0)
    gen = torch.Generator().manual_seed(21)
    flow_draws = distill.sample_draws(distill.DistillConfig(**flow_kw), gen,
                                      torch.from_numpy(sd3_batch["latents"]))
    adv_batch = _global_batch(n, 22)
    adv_cfg = RECIPES["sd15_2phase_adv"].distill
    adv_draws = distill.sample_draws(adv_cfg, gen, torch.from_numpy(adv_batch["latents"]),
                                     adv.adv_offset_span(make_ddpm_schedule(), adv_cfg))
    return {"flow": {"kind": "flow", "cfg": flow_kw, "batch": sd3_batch,
                     "draws": [{k: x.numpy() for k, x in flow_draws.items()}]},
            "adv_fused": {"kind": "adv", "distill": adv_cfg, "batch": adv_batch,
                          "draws": [{k: x.numpy() for k, x in adv_draws.items()}]}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every job of (2) and (3) on 2 gloo ranks in one spawn, and the
    references: the JAX package's DDIM steps and the port's one-process
    flow step and fused pair, each on the global batch."""
    out_dir = tmp_path_factory.mktemp("ranks")
    ddim_jobs, refs = _ddim_jobs()
    jobs = dict(ddim_jobs, **_port_jobs())
    path = str(out_dir / "jobs.pt")
    torch.save(jobs, path)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(port), path,
                               str(out_dir)], cwd=REPO, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(WORLD)]
    _wait(procs)
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for name in ("flow", "adv_fused"):
            refs[name] = run_job(jobs[name], 0, 1)
    finally:
        torch.set_num_threads(prev)
    return ranks, refs


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_two_rank_ddim_step_matches_jax_global_batch(two_ranks, case):
    """A TINY ``sd15_4phase``-style step, batch 2 a rank (accum 2: two
    microbatches of 2 a rank, as ``--batch-size 2 --gradient-accumulation-steps
    2``), against the JAX step on the global batch of 4-row microbatches; both
    ranks end with the same LoRA, bit for bit (the all-reduced gradients)."""
    ranks, refs = two_ranks
    ref = refs[case]
    for out in ranks:
        np.testing.assert_allclose(float(out[case]["metrics"]["loss"]), ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(out[case]["metrics"]["grad_norm"]), ref["grad_norm"],
                                   rtol=1e-3)
        for k, p in out[case]["params"].items():
            np.testing.assert_allclose(p.numpy(), ref["params"][k].numpy(), rtol=0, atol=1e-5)
    a, b = (out[case]["params"] for out in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["flow", "adv_fused"])
def test_two_rank_flow_step_and_fused_pair_match_one_process(two_ranks, case):
    """The SD3 flow step and the ``sd15_2phase_adv`` fused pair on 2 ranks
    against the port's one-process step on the global batch; after the pair
    the discriminator heads are the same on both ranks."""
    ranks, refs = two_ranks
    ref = refs[case]
    for out in ranks:
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(float(out[case]["metrics"][k]), float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for tree in ("params", "d_params") if case == "adv_fused" else ("params",):
            moved = max(float((out[case][tree][k] - v).abs().max()) for k, v in ref[tree].items())
            assert moved <= 1e-5, (tree, moved)
    if case == "adv_fused":
        assert ranks[0][case]["counted"] == 2
        a, b = (out[case]["d_params"] for out in ranks)
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# (4) the trainer's CLI on 2 ranks
# ---------------------------------------------------------------------------

STEPS, PER_RANK, SEED = 2, 2, 42


def _write_caches(root):
    """A 2-shard TINY cache (shard r for rank r) and a one-shard cache whose
    first batches of 4 are the 2-rank run's global batches, rank 0's rows
    first (`chip_smoke.write_ddp_caches`, as the smoke's phase ``ddp``
    writes them from its cache)."""
    rng = np.random.default_rng(31)
    (root / "cache").mkdir()
    np.savez(root / "cache" / "shard_00000.npz",
             latents=rng.standard_normal((8, 8, 8, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((8, 77, 32)).astype(np.float16))
    write_ddp_caches(str(root / "cache"), str(root), SEED, WORLD, PER_RANK)


def _cli(cache, out, batch, steps, *extra):
    return ["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--cached-latents-dir",
            str(cache), "--output-dir", str(out), "--batch-size", str(batch), "--log-every", "1",
            "--max-train-steps", str(steps), "--checkpointing-steps", "1",
            "--learning-rate", "1e-5", "--seed", str(SEED), *extra]


def _rows(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _torchrun(argv):
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(WORLD), "-m", "pcm_tpu_torch.train",
                             *argv], cwd=REPO, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return _wait([proc])[0][1]


def test_two_rank_train_cli_writes_once_matches_one_process_and_resumes(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    pcm_tpu_torch.train`` on a 2-shard cache: one checkpoint and one kohya
    file a save, one ``metrics.jsonl`` row a log step, one ``launches.jsonl``
    row a run; its losses and LoRA are a one-process run's at the global
    batch (its cache ordered so that its batches are the 2-rank run's
    global batches); a second call resumes on 2 ranks."""
    _write_caches(tmp_path)
    two, one = tmp_path / "two", tmp_path / "one_run"
    printed = _torchrun(_cli(tmp_path / "ranks", two, PER_RANK, STEPS))
    assert "rank 0 of 2 (gloo), global batch 4" in printed
    assert printed.count("step 1:") == 1 and printed.count("step 2:") == 1
    proc = subprocess.Popen([sys.executable, "-m", "pcm_tpu_torch.train",
                             *_cli(tmp_path / "one", one, PER_RANK * WORLD, STEPS)],
                            cwd=REPO, env=_env(), text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    _wait([proc])

    rows = _rows(two)
    assert [r["step"] for r in rows] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in rows], [r["loss"] for r in _rows(one)],
                               rtol=1e-5)
    assert sorted(os.listdir(two / "checkpoints")) == ["step_0000001.pt", "step_0000002.pt"]
    assert sorted(f for f in os.listdir(two) if f.startswith("pcm_lora_")) == [
        "pcm_lora_0000001.safetensors", "pcm_lora_0000002.safetensors"]
    assert len((two / "launches.jsonl").read_text().splitlines()) == 1
    ours, ref = (torch.load(run / "checkpoints" / "step_0000002.pt", weights_only=True)
                 for run in (two, one))
    for k, v in ref["lora"].items():
        np.testing.assert_allclose(ours["lora"][k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    mu, ref_mu = ours["opt_state"]["mu"], ref["opt_state"]["mu"]
    top = max(float(v.abs().max()) for v in ref_mu.values())
    assert max(float((mu[k] - v).abs().max()) for k, v in ref_mu.items()) < 1e-3 * top
    assert max(float(v.abs().max()) for k, v in ours["lora"].items()
               if k.endswith("lora_b")) > 1e-6

    printed = _torchrun(_cli(tmp_path / "ranks", two, PER_RANK, STEPS + 1))
    assert "resumed at step 2" in printed and printed.count("step 3:") == 1
    assert [r["step"] for r in _rows(two)] == [1, 2, 3]
    assert (two / "checkpoints" / "step_0000003.pt").exists()


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    """Two ranks started with the launcher's environment by hand; a SIGTERM
    to rank 1 alone stops both after the same step, rank 0 writing the
    ``preempted`` row and a checkpoint of that step."""
    _write_caches(tmp_path)
    out = tmp_path / "run"
    code = ("import sys\n"
            "from pcm_tpu_torch.train.__main__ import main\n"
            "trainer = main(sys.argv[1:])\n"
            "print('STOPPED', trainer.global_step, flush=True)\n")
    port = free_port()
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               *_cli(tmp_path / "ranks", out, PER_RANK, 1000)],
                              cwd=REPO, text=True, stdout=logs[r], stderr=subprocess.PIPE,
                              env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                                       LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                                       MASTER_PORT=str(port)))
             for r in range(WORLD)]
    try:
        deadline = time.monotonic() + TIMEOUT
        while not ((out / "metrics.jsonl").exists() and _rows(out)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), \
                "no step logged"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        _wait(procs, max(1.0, deadline - time.monotonic()))
    finally:
        for log in logs:
            log.close()
    stopped = [[line.split()[1] for line in (tmp_path / f"rank{r}.log").read_text().splitlines()
                if line.startswith("STOPPED")] for r in range(WORLD)]
    assert stopped[0] == stopped[1] and len(stopped[0]) == 1
    step = int(stopped[0][0])
    assert 1 <= step < 1000
    rows = _rows(out)
    assert rows[-1]["step"] == step and rows[-1]["preempted"] == 1
    assert [r["step"] for r in rows[:-1]] == list(range(1, step + 1))
    assert (out / "checkpoints" / f"step_{step:07d}.pt").exists()


# ---------------------------------------------------------------------------
# (5) the data-parallel engine
# ---------------------------------------------------------------------------


def test_engine_on_two_devices_is_two_one_device_engines():
    """An engine on ``[cpu, cpu]`` at batch 4 (a chunk of 2 a device) gives,
    byte for byte, what one-device engines give
    the two halves at batch 2: the default adapter, a swapped one, a
    registered one and a partial batch, at guidance 2 (the uncond per
    replica)."""
    from pcm_tpu_torch.configs.families import sd15_bundle
    from pcm_tpu_torch.data.tokenizer import HashTokenizer
    from pcm_tpu_torch.sampling.ddim import DDIMSampler
    from pcm_tpu_torch.serving import EngineConfig, InferenceEngine

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        bundle = sd15_bundle(RANK, dtype=torch.float32, tiny=True)
        cpu = torch.device("cpu")
        frozen, template = bundle.init(torch.Generator().manual_seed(3), cpu)
        g = torch.Generator().manual_seed(4)
        adapters = [{k: torch.randn(v.shape, generator=g) * 0.05 for k, v in template.items()}
                    for _ in range(3)]

        def engine(batch, devices):
            eng = InferenceEngine(bundle, DDIMSampler.create(make_ddpm_schedule(), 2), frozen,
                                  template, {"input_ids": HashTokenizer()},
                                  EngineConfig(batch_size=batch, latent_hw=8,
                                               guidance_scale=2.0), devices)
            eng.load_lora(adapters[0], swap=False)
            eng.register_adapter("x", adapters[1])
            return eng

        sharded, single = engine(4, [cpu, cpu]), engine(2, cpu)
        prompts, seeds = ["a red square", "a cat", "a blue circle", "x y"], [7, 8, 9, 10]

        def both(adapter=None, n=4):
            out = sharded.generate_batch(prompts[:n], seeds[:n], adapter)
            halves = [single.generate_batch(prompts[i:min(i + 2, n)], seeds[i:min(i + 2, n)],
                                            adapter) for i in range(0, n, 2)]
            return out, np.concatenate(halves)

        for out, ref in (both(), both("x"), both(n=3)):
            assert out.shape == ref.shape and out.dtype == np.uint8
            np.testing.assert_array_equal(out, ref)
        sharded.load_lora(adapters[2])
        single.load_lora(adapters[2])
        out, ref = both()
        np.testing.assert_array_equal(out, ref)
        assert not np.array_equal(out, both("x")[0])
        assert sharded.stats["lora_swaps"] == 1 and len(sharded.devices) == 2
    finally:
        torch.set_num_threads(prev)


def test_local_rows_and_no_group():
    """Without a process group the collectives are the identity."""
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": (torch.ones(4),)}
    assert not mesh.active() and mesh.world() == 1 and mesh.is_main()
    assert mesh.all_reduce_mean(tree) is tree and mesh.replicate(tree) is tree
    assert not mesh.any_rank(False) and mesh.any_rank(True)
    rows = mesh.local_rows(tree, 1, 2)
    assert rows["a"].tolist() == [[4.0, 5.0], [6.0, 7.0]] and rows["b"][0].shape == (2,)
    with pytest.raises(ValueError, match="do not split"):
        mesh.local_rows(tree, 0, 3)
