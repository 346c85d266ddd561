"""The port's counterparts of `__graft_entry__.py`: `entry`, the flagship
SDXL UNet forward, and `dryrun_multichip`, the training steps over a
``data x fsdp`` layout of ranks at TINY sizes.

    python -m pcm_tpu_torch.dryrun [--ranks 8] [--device cuda|cpu]
    python -m torch.distributed.run --standalone --nproc-per-node N -m pcm_tpu_torch.dryrun

The first form starts the ranks itself (`dryrun_multichip`); under the
launcher each process is one rank. On the CPU the ranks are gloo processes;
on cards a rank takes ``cuda:LOCAL_RANK`` and NCCL when there is a card for
each, else ranks share the cards over gloo (`parallel/mesh.py:init_distributed`).
Rank 0 prints JAX's four lines; a failed step or a non-finite loss exits
non-zero.

`step_runner` with `family_bundle`, `sharded_frozen` and `Sizes` runs these
steps on a layout, the one place that does: the dry run calls it at TINY
sizes, the CPU tests' gloo ranks too, and ``scripts/bench_fsdp_torch.py``
at published widths on cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import socket
import subprocess
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .configs.families import (RECIPES, SD3_CACHED_STEP, disc_config, sd3_bundle, sd15_bundle,
                               sdxl_bundle)
from .core.schedule import make_ddpm_schedule, make_flow_schedule
from .parallel import mesh
from .parallel.fsdp import held_bytes, shard_fsdp
from .train import adv
from .train.distill import build_ddim_distill_step, build_flow_distill_step, sample_draws
from .train.state import TrainState, make_optimizer
from .utils.quant import int8_matmul, quantize_frozen

DRYRUN_TIMEOUT = 600  # seconds the ranks of `dryrun_multichip` may take


def entry(tiny: bool = False, device: str = "cuda") -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: one SDXL UNet forward at batch 1 on 512-px
    latents (64 x 64 x 4), bf16 weights drawn from seed 0 and a rank-64 LoRA
    on `SD_UNET_LORA_TARGETS` (``b = 0``), as `__graft_entry__.py:entry`.
    The weights live in the module, so ``fn(lora, x, t, ctx, added)`` takes
    the adapter and the inputs: latents ``(1, 64, 64, 4)`` NHWC, timesteps
    ``(1,)`` fp32, context ``(1, 77, 2048)``, ``added`` with ``text_embeds``
    ``(1, 1280)`` and ``time_ids`` ``(1, 6)`` fp32; it returns NHWC. With
    ``tiny`` the TINY SDXL UNet at 8 x 8 latents (the CPU's)."""
    dev = torch.device(device)
    bundle = sdxl_bundle(64, dtype=torch.bfloat16, tiny=tiny)
    frozen, lora = bundle.init(torch.Generator(dev).manual_seed(0), dev, modules=("unet",))
    unet, cfg = frozen["unet"], bundle.unet_cfg
    hw = 8 if tiny else 64
    pooled = cfg.addition_in_dim - 6 * cfg.addition_embed_dim
    x = torch.zeros((1, hw, hw, cfg.in_channels), dtype=torch.bfloat16, device=dev)
    t = torch.zeros((1,), device=dev)
    ctx = torch.zeros((1, 77, cfg.cross_attention_dim), dtype=torch.bfloat16, device=dev)
    added = {"text_embeds": torch.zeros((1, pooled), dtype=torch.bfloat16, device=dev),
             "time_ids": torch.zeros((1, 6), device=dev)}

    def fn(lora, x, t, ctx, added):
        return unet(x.permute(0, 3, 1, 2), t, ctx, lora, added).permute(0, 2, 3, 1)

    return fn, (lora, x, t, ctx, added)


# The step kinds of `step_runner`, in JAX's order, by family: the DDIM
# consistency step, the adversarial G step then D step, the fused pair, the
# SD3 flow step, and the consistency step on int8 frozen weights (``fused``).
FAMILY_STEPS = {"sd15": ("ddim", "adv_g_d", "adv_fused", "ddim_int8"), "sd3": ("flow",)}
# Adam's rate and epsilon in `step_runner`'s steps: with an epsilon near the
# gradients' size the first update scales with each gradient, not only with
# its sign, so new LoRAs that agree bit for bit mean gradients that agree.
LR, EPS = 1e-3, 1e-2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """`step_runner`'s modules: TINY (the CPU's; rank-4 LoRA) or at published
    widths (the recipes' LoRA ranks), in ``dtype``, with or without remat
    (under ``remat_policy``, at ``remat_granularity``: the UNet's);
    `shard_fsdp`'s ``min_size`` and `quantize_frozen`'s; SD3's depth cut to
    ``mmdit_layers`` joint blocks and ``t5_layers`` T5 layers when set."""

    tiny: bool = True
    dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: Optional[str] = None
    remat_granularity: str = "module"
    min_size: int = 2 ** 10
    int8_min_size: int = 0
    mmdit_layers: Optional[int] = None
    t5_layers: Optional[int] = None


def family_bundle(family: str, sizes: Sizes):
    """The SD1.5 bundle, or SD3's on `SD3_ADV_LORA_TARGETS`."""
    kw = dict(dtype=sizes.dtype, tiny=sizes.tiny, remat=sizes.remat,
              remat_policy=sizes.remat_policy, **({"lora_rank": 4} if sizes.tiny else {}))
    if family == "sd15":
        return sd15_bundle(remat_granularity=sizes.remat_granularity, **kw)
    bundle = sd3_bundle(adv_targets=True, **kw)
    cut = {"mmdit_cfg": sizes.mmdit_layers, "t5_cfg": sizes.t5_layers}
    return dataclasses.replace(bundle, **{f: dataclasses.replace(getattr(bundle, f), num_layers=k)
                                          for f, k in cut.items() if k})


def sharded_frozen(bundle, sizes: Sizes, layout: mesh.Layout, dev: torch.device, seed: int,
                   int8: bool = False) -> Tuple[dict, dict, int]:
    """``(frozen, lora, whole)``: the bundle's modules from ``seed`` (int8
    ones with ``int8``) sharded over the layout's fsdp axis, the LoRA they
    came with, and the bytes the modules held before the split."""
    frozen, lora = bundle.init(torch.Generator(dev).manual_seed(seed), dev)
    if int8:
        quantize_frozen(frozen, min_size=sizes.int8_min_size)
    whole = held_bytes(frozen)
    shard_fsdp(frozen, layout, sizes.min_size)
    return frozen, lora, whole


def tiny_batch(family: str, n: int, seed: int, dtype: torch.dtype = torch.float32) -> dict:
    """A TINY global batch of ``n`` rows from ``seed``: 16-px pixels and
    token ids (so the VAE encoder and the text towers run on sharded weights
    too) and a small uncond branch."""
    rng = np.random.default_rng(seed)
    b = {"pixel_values": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
         "input_ids": rng.integers(1, 999, (n, 8))}
    if family == "sd3":
        b.update(input_ids_2=rng.integers(1, 999, (n, 8)), input_ids_3=rng.integers(0, 999, (n, 8)),
                 uncond_embeds=0.1 * rng.standard_normal((n, 16, 32), dtype=np.float32),
                 uncond_pooled=0.1 * rng.standard_normal((n, 32), dtype=np.float32))
    else:
        b["uncond_embeds"] = 0.1 * rng.standard_normal((n, 8, 32), dtype=np.float32)
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in b.items()}


def step_runner(job: str, bundle, layout: mesh.Layout, glob: dict, lora: dict, seed: int,
                tiny: bool) -> Callable:
    """``run(frozen) -> (metrics, g_state, d_state or None)``: one step of
    kind ``job`` (`FAMILY_STEPS`) on this rank's rows of the global batch
    ``glob`` (on the rank's device) and of the global draws, from the same
    states at every call. The recipes' configs (``sd15_4phase``,
    ``sd15_2phase_adv``, `SD3_CACHED_STEP`); the LoRA is ``lora`` moved off
    zero and the SD1.5 heads (TINY ones with ``tiny``) are drawn from
    ``seed``, both replicated."""
    dev = next(iter(glob.values())).device
    if job == "flow":
        cfg, schedule = SD3_CACHED_STEP.distill, make_flow_schedule(shift=3.0)
    else:
        cfg = RECIPES["sd15_2phase_adv" if job.startswith("adv") else "sd15_4phase"].distill
        schedule = make_ddpm_schedule()
    span = adv.adv_offset_span(schedule, cfg) if job.startswith("adv") else None
    draws = [layout.local_rows(sample_draws(
        cfg, torch.Generator(dev).manual_seed(seed + 2), bundle.latents_like(glob), span,
        posterior="pixel_values" in glob))]
    batch = layout.local_rows(glob)
    tx = make_optimizer(LR, eps=EPS)
    lora = mesh.replicate({k: v + 0.01 for k, v in lora.items()})  # b factors off zero
    if job == "flow":
        step = build_flow_distill_step(bundle, schedule, cfg, tx)
    elif job.startswith("ddim"):
        step = build_ddim_distill_step(bundle, schedule, cfg, tx)
    else:
        disc, d_params = adv.init_discriminator(
            disc_config("sd15", tiny=tiny),
            bundle.unet_cfg.tap_channels(), torch.Generator(dev).manual_seed(seed + 1), dev)
        d_params = mesh.replicate(d_params)
        tx_d = make_optimizer(LR, b1=0.0, eps=EPS)
        adv_cfg = adv.AdvConfig(0.1)
        if job == "adv_fused":
            pair = adv.build_ddim_adv_fused_pair(bundle, schedule, cfg, adv_cfg, disc, tx, tx_d)
        else:
            g_step, d_step = adv.build_ddim_adv_steps(bundle, schedule, cfg, adv_cfg, disc, tx,
                                                      tx_d)

    def run(frozen):
        state = TrainState.create(lora, tx)
        if job.startswith("adv"):
            d_state = TrainState.create(d_params, tx_d)
            if job == "adv_fused":
                g, d, metrics = pair(state, d_state, frozen, batch, draws)
                return metrics, g, d
            g, gm = g_step(state, d_state, frozen, batch, draws)  # G, then D on the same rows
            d, dm = d_step(state, d_state, frozen, batch, draws)
            return {**gm, **dm}, g, d
        with int8_matmul("fused", enable=job == "ddim_int8"):
            new, metrics = step(state, frozen, batch, draws)
        return metrics, new, None

    return run


def _same_on_every_rank(tree: dict, what: str) -> None:
    """The trained state must stay replicated: rank 0's, bit for bit."""
    ref = mesh.replicate(tree)
    if not all(torch.equal(ref[k], v) for k, v in tree.items()):
        raise AssertionError(f"{what} differs from rank 0's")


def _finite(*xs: float) -> None:
    if not all(math.isfinite(x) for x in xs):
        raise AssertionError(f"non-finite loss: {xs}")


def run_rank(n_devices: int, device: str = "cuda") -> List[str]:
    """One rank of `dryrun_multichip`: the process group of ``n_devices``
    ranks (from the launcher's environment), then JAX's steps in JAX's
    order (`step_runner`, TINY sizes); returns the lines rank 0 prints."""
    dev = mesh.init_distributed(device=device)
    n = mesh.world()
    if n != n_devices:
        raise RuntimeError(f"{n} ranks in the process group, {n_devices} asked for")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    fsdp = 2 if n % 2 == 0 and n >= 4 else 1
    layout = mesh.make_mesh(n // fsdp, fsdp)
    sizes = Sizes(dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    lines = []
    texts = {"ddim": lambda m: f"mesh={{'data': {layout.data}, 'fsdp': {layout.fsdp}}} "
                               f"ddim loss={m['loss']:.4f}",
             "adv_g_d": lambda m: f"adv g_loss={m['g_loss']:.4f} D d_loss={m['d_loss']:.4f}",
             "adv_fused": lambda m: f"fused pair loss={m['loss']:.4f} d_loss={m['d_loss']:.4f}",
             "flow": lambda m: f"flow loss={m['loss']:.4f}"}
    for family in ("sd15", "sd3"):
        bundle = family_bundle(family, sizes)
        frozen, lora, _ = sharded_frozen(bundle, sizes, layout, dev, seed=0)
        glob = {k: v.to(dev) for k, v in tiny_batch(family, 2 * layout.data, 0, sizes.dtype).items()}
        for job in FAMILY_STEPS[family]:
            if job not in texts:
                continue
            metrics, g, d = step_runner(job, bundle, layout, glob, lora, 0, tiny=True)(frozen)
            metrics = {k: float(v) for k, v in metrics.items()}
            _finite(*metrics.values())
            if g.step != 1 or (d is not None and d.step != 1):
                raise AssertionError(f"{job}: steps {g.step}, {d and d.step} after one update")
            _same_on_every_rank({**g.params, **(d.params if d is not None else {})},
                                f"the trained state after {job}")
            lines.append(f"dryrun_multichip({n}): {texts[job](metrics)} OK")
            if mesh.is_main():
                print(lines[-1], flush=True)
        del frozen
    mesh.barrier("dryrun done")
    torch.distributed.destroy_process_group()
    return lines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> List[str]:
    """The training steps over ``n_devices`` ranks, as
    `__graft_entry__.py:dryrun_multichip`: batch over ``data``, frozen
    weights sharded over ``fsdp`` (2 when ``n_devices`` is even and at least
    4, else 1), the LoRA, the heads and the optimizer states replicated; at
    TINY sizes, the global batch 2 x data. Starts the ranks as processes of
    ``python -m pcm_tpu_torch.dryrun`` on a free local port, prints rank 0's
    lines and returns them; a rank that fails raises with its stderr."""
    if os.environ.get("RANK") is not None:  # a rank under the launcher
        return run_rank(n_devices, device)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n_devices), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               LOCAL_WORLD_SIZE=str(n_devices), OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-m", "pcm_tpu_torch.dryrun", "--ranks",
                               str(n_devices), "--device", device],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRYRUN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, p.returncode, err) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode]
    if failed:
        raise RuntimeError("dryrun ranks failed:\n" + "\n---\n".join(
            f"rank {r} rc {rc}\n{err[-3000:]}" for r, rc, err in failed))
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("dryrun_multichip(")]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8, help="ranks to start (launched: the world)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    launched = os.environ.get("RANK") is not None
    lines = dryrun_multichip(int(os.environ["WORLD_SIZE"]) if launched else args.ranks,
                             args.device)
    return 0 if len(lines) == 4 else 1


if __name__ == "__main__":
    sys.exit(main())
