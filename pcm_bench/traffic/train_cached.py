"""Distillation on cached latents: the trainer of ``python -m
pcm_tpu_torch.train`` (`train/loop.py:Trainer.run` over
`data/cached.py:batches`, a consistency step of `train/distill.py`, AdamW of
`train/state.py`) at the cell's batch, one loss readback a step.

Set-up draws the frozen backbone and a LoRA adapter (``b != 0``) on the card
from the seed, writes a seeded cache of ``cache_rows`` samples as two
``shard_*.npz`` files, builds one Trainer and drives it through
``check_steps`` steps, which the reference follows; after the last of them
the window opens, on the same Trainer, feed and call. A step's end is its
loss readback; the window holds every step begun before ``--seconds`` ran
out. With ``--trace 1`` the profiler then traces steps for
``trace_seconds`` more. The trainer's closing checkpoint (2.4 GB for SDXL)
is not written: the benchmark stops the run after its last row.

Workload keys: ``batch``, ``cache_rows``, ``latent_hw``, ``prompt_len``,
``prompt_dim``, ``pooled_dim``, ``time_ids`` (SDXL), ``distill`` (the
step's `DistillConfig` fields and ``schedule``: ddpm | flow), ``lr``,
``remat`` (``full``, ``none`` or a policy name of
`pcm_tpu_torch.ops.common.resolve_remat_policy`, as ``train --remat``
takes them) and ``remat_granularity`` (UNet families), ``frozen_dtype``
(``bfloat16``, the default, or ``int8``: the program's int8 frozen weights)
and ``int8_matmul`` (with int8: the program's int8 product path, e.g.
``fused``), ``adapter_b_std``, ``check_steps``, ``reference_rows`` (rows a
reference block), ``trace_seconds`` and ``limits`` (each compared number's
limit). The configuration's ``family`` picks a row of `FAMILIES`; any value
this driver does not know is refused, never run as something else.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from .. import compare, harness, weights
from ..reference import distill as ref_distill
from ..reference import layers as ref_layers
from ..reference.mmdit import MMDiT as RefMMDiT
from ..reference.unet import UNet2DCondition as RefUNet
from ..trace import Tracer


@dataclasses.dataclass(frozen=True)
class Family:
    """What differs between the families this driver runs: the backbone (the
    bundle's module, and the configuration's group of widths), the program's
    bundle builder and config class, the reference backbone, whether the
    builder takes a remat granularity, whether the loop hands the step zero
    uncond embeddings, and the reference's conditioning and forward."""

    backbone: str
    bundle: str
    widths: str
    bundle_field: str
    reference: type
    granularity: bool
    zero_uncond: bool
    cond: Callable
    forward: Callable


def _sdxl_cond(b):
    cond = {"prompt_embeds": b["prompt_embeds"], "text_embeds": b["pooled_embeds"],
            "time_ids": b["time_ids"]}
    uncond = dict(cond, prompt_embeds=torch.zeros_like(b["prompt_embeds"]),
                  text_embeds=torch.zeros_like(b["pooled_embeds"]))
    return b["latents"], cond, uncond


def _sdxl_forward(model):
    def fwd(x, t, c, lora):
        added = {"text_embeds": c["text_embeds"], "time_ids": c["time_ids"]}
        return model(x.permute(0, 3, 1, 2), t, c["prompt_embeds"], lora,
                     added).permute(0, 2, 3, 1)
    return fwd


def _sd3_cond(b):  # zero uncond embeddings
    cond = {"prompt_embeds": b["prompt_embeds"], "pooled": b["pooled_embeds"]}
    return b["latents"], cond, {k: torch.zeros_like(v) for k, v in cond.items()}


def _sd3_forward(model):
    def fwd(x, t, c, lora):
        return model(x, t, c["prompt_embeds"], c["pooled"], lora)
    return fwd


FAMILIES = {
    "sdxl": Family("unet", "sdxl_bundle", "pcm_tpu_torch.models.unet:UNetConfig", "unet_cfg",
                   RefUNet, True, False, _sdxl_cond, _sdxl_forward),
    "sd3": Family("mmdit", "sd3_bundle", "pcm_tpu_torch.models.mmdit:MMDiTConfig", "mmdit_cfg",
                  RefMMDiT, False, True, _sd3_cond, _sd3_forward),
}
FROZEN_DTYPES = ("bfloat16", "int8")


def family(cfg) -> Family:
    """The row of `FAMILIES` of the configuration's ``family``; raises on any other."""
    try:
        return FAMILIES[cfg["family"]]
    except KeyError:
        raise ValueError(f"family {cfg['family']!r} is not one this driver runs "
                         f"({sorted(FAMILIES)})") from None


def _remat(spec, fam: Family) -> dict:
    """The bundle's remat arguments of the workload's ``remat`` (and
    ``remat_granularity``), as ``train --remat`` reads them; refuses the rest."""
    from pcm_tpu_torch.ops.common import resolve_remat_policy

    name = spec["remat"]
    policy = None if name in ("full", "none") else name
    resolve_remat_policy(policy)  # raises on a name the program does not take
    kw = {"remat": name != "none", "remat_policy": policy}
    if "remat_granularity" in spec:
        if not fam.granularity:
            raise ValueError(f"{fam.bundle} takes no remat_granularity")
        kw["remat_granularity"] = spec["remat_granularity"]
    return kw


def _bundle(cfg, spec, dtype):
    """The program's bundle of the configuration's family at its widths."""
    from pcm_tpu_torch.configs import families
    from pcm_tpu_torch.lora.layers import LoRASpec

    fam = family(cfg)
    lora = cfg["lora"]
    spec_lora = LoRASpec(rank=lora["rank"], alpha=lora["alpha"], targets=tuple(lora["targets"]))
    module, cls = fam.widths.split(":")
    widths = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg[fam.backbone].items()}
    bundle = getattr(families, fam.bundle)(lora["rank"], dtype=dtype, **_remat(spec, fam))
    return dataclasses.replace(bundle, lora=spec_lora, **{
        fam.bundle_field: getattr(importlib.import_module(module), cls)(**widths)})


def _frozen(spec):
    """``(frozen_dtype, int8_matmul)`` of the workload; refuses unknown values."""
    dtype, path = spec.get("frozen_dtype", "bfloat16"), spec.get("int8_matmul")
    if dtype not in FROZEN_DTYPES:
        raise ValueError(f"frozen_dtype {dtype!r} (one of {FROZEN_DTYPES})")
    if path is not None and dtype != "int8":
        raise ValueError("int8_matmul needs frozen_dtype int8")
    return dtype, path


def reference_model(cfg, device):
    """The reference backbone with LoRA marked, uninitialized, fp32 on ``device``."""
    with torch.device("meta"):
        fam = family(cfg)
        model = fam.reference(cfg[fam.backbone])
    lora = cfg["lora"]
    ref_layers.attach_lora(model, lora["targets"], lora["rank"], lora["alpha"])
    if torch.device(device).type == "meta":
        return model
    return model.to_empty(device=device).float().eval().requires_grad_(False)


def write_cache(spec, cfg, seed, device, path) -> None:
    """``cache_rows`` seeded samples in two ``shard_*.npz`` files (fp16, as
    the latent cache stores them; SDXL's ``time_ids`` fp32)."""
    gen = weights.generator(seed, weights.DATA, device)
    n, hw = spec["cache_rows"], spec["latent_hw"]
    chans = cfg[family(cfg).backbone]["in_channels"]

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).half().cpu().numpy()

    rows = {"latents": draw(n, hw, hw, chans),
            "prompt_embeds": draw(n, spec["prompt_len"], spec["prompt_dim"]),
            "pooled_embeds": draw(n, spec["pooled_dim"])}
    if "time_ids" in spec:
        rows["time_ids"] = np.tile(np.asarray(spec["time_ids"], np.float32), (n, 1))
    os.makedirs(path)
    half = n // 2
    for i, sl in enumerate((slice(0, half), slice(half, n))):
        np.savez(os.path.join(path, f"shard_{i:03d}.npz"), **{k: v[sl] for k, v in rows.items()})


class _Recorder:
    """Stands in for the Trainer's metrics logger: keeps each row with its
    time, snapshots what the comparison needs, opens and closes the window
    and the traced steps, and asks the Trainer to stop."""

    def __init__(self, ctx, trainer, check_steps):
        self.ctx, self.trainer, self.check = ctx, trainer, check_steps
        self.rows = []
        self.phase = "setup"
        self.mu1 = self.params = None
        self.t_start = self.t_end = None
        self.peak = 0
        self.tracer = Tracer(torch.device(ctx.device)) if ctx.trace else None
        self.trace = None
        self.cuda = torch.device(ctx.device).type == "cuda"

    def log_images(self, *a, **kw):
        pass

    def log(self, step, row):
        now = time.perf_counter()
        if "loss" not in row:  # the Trainer's "preempted" row after a stop request
            return
        self.rows.append((now, step, dict(row)))
        trainer = self.trainer
        if step == 1:
            self.mu1 = {k: v.detach().to("cpu", copy=True)
                        for k, v in trainer.state.opt_state["mu"].items()}
        if step == self.check:
            self.params = {k: v.detach().to("cpu", copy=True)
                           for k, v in trainer.state.params.items()}
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            self.phase, self.t_start = "window", time.perf_counter()
        elif self.phase == "window" and now >= self.t_start + self.ctx.seconds:
            self.phase, self.t_end, self.last_step = "done", now, step
            if self.cuda:
                self.peak = torch.cuda.max_memory_allocated()
            if self.tracer is not None:
                self.phase, self.trace_from = "trace", step
                self.tracer.start(time.perf_counter)
            else:
                trainer.request_stop()
        elif self.phase == "trace" and now - self.tracer.t0 >= self.ctx.spec["trace_seconds"]:
            self.trace = self.tracer.stop(time.perf_counter)
            self.trace["steps"] = step - self.trace_from
            self.phase = "done"
            trainer.request_stop()


def run(ctx: harness.Context) -> harness.Run:
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
    from pcm_tpu_torch.data.cached import CachedLatentsDataset, batches
    from pcm_tpu_torch.lora.layers import lora_shapes
    from pcm_tpu_torch.train.distill import (DistillConfig, build_ddim_distill_step,
                                             build_flow_distill_step)
    from pcm_tpu_torch.train.loop import LoopConfig, Trainer
    from pcm_tpu_torch.train.state import TrainState, make_optimizer
    from pcm_tpu_torch.utils.quant import int8_matmul, quantize_frozen

    spec, cfg = ctx.spec, ctx.spec["config_spec"]
    dev = torch.device(ctx.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    fam, bsz, check = family(cfg), spec["batch"], spec["check_steps"]
    backbone = fam.backbone
    loop_seed = weights.sub_seed(ctx.seed, weights.LOOP)
    frozen_dtype, int8_path = _frozen(spec)

    bundle = _bundle(cfg, spec, dtype)
    frozen = bundle.build(dev, modules=(backbone,))
    weights.fill_frozen(frozen[backbone].named_parameters(), ctx.seed, dev, served=dtype)
    shapes = lora_shapes(frozen[backbone], cfg["lora"]["rank"])
    ref_shapes = ref_layers.lora_shapes(reference_model(cfg, "meta"), cfg["lora"]["rank"])
    if shapes != ref_shapes:
        raise RuntimeError("the program and the reference put LoRA on different layers: "
                           f"{sorted(set(shapes) ^ set(ref_shapes))[:8]}")
    lora0 = weights.draw_adapter(shapes, cfg["lora"]["rank"], spec["adapter_b_std"], ctx.seed,
                                 dev)
    if frozen_dtype == "int8":  # the program's int8 frozen weights
        quantize_frozen(frozen, min_size=0 if dev.type == "cpu" else 65536)
    cache = os.path.join(ctx.tmp, "cache")
    write_cache(spec, cfg, ctx.seed, dev, cache)

    d = spec["distill"]
    dcfg = DistillConfig(num_solver_steps=d["num_solver_steps"], multiphase=d["multiphase"],
                         w_min=d.get("w_min", 4.0), w_max=d.get("w_max", 5.0),
                         fixed_w=d.get("fixed_w"), huber_c=d.get("huber_c", 0.001))
    tx = make_optimizer(spec["lr"], max_grad_norm=1.0)
    if d["schedule"] == "flow":
        distill_step = build_flow_distill_step(bundle, make_flow_schedule(shift=d["shift"]),
                                               dcfg, tx)
    else:
        distill_step = build_ddim_distill_step(bundle, make_ddpm_schedule(), dcfg, tx)
    fault = ctx.options.get("fault")

    def step(state, d_state, frozen_, batch, draws, global_step):
        if fault == "half_batch":  # the mean taken over half of the rows
            half = bsz // 2
            batch = {k: v[:half] for k, v in batch.items()}
            draws = [{k: v[:half] for k, v in dr.items()} for dr in draws]
        new, metrics = distill_step(state, frozen_, batch, draws)
        if fault == "unchanged":
            new = state
        return new, d_state, metrics, 1

    extra = {}
    if fam.zero_uncond:
        extra = {"uncond_embeds": torch.zeros((bsz, spec["prompt_len"], spec["prompt_dim"]),
                                              dtype=dtype, device=dev),
                 "uncond_pooled": torch.zeros((bsz, spec["pooled_dim"]), dtype=dtype,
                                              device=dev)}
    loop = LoopConfig(output_dir=os.path.join(ctx.tmp, "run"), max_train_steps=10 ** 9,
                      checkpointing_steps=0, log_every=1, seed=loop_seed, resume=False,
                      lora_alpha=cfg["lora"]["alpha"], kohya_prefix=bundle.KOHYA_PREFIX)
    state = TrainState.create({k: v.clone() for k, v in lora0.items()}, tx)
    trainer = Trainer(loop, frozen, state, step, dcfg, bundle.latents_like, dev)
    rec = _Recorder(ctx, trainer, check)
    trainer.logger = rec
    trainer.save = lambda: None  # no closing checkpoint: the run ends after its last row
    with int8_matmul(int8_path) if int8_path else contextlib.nullcontext():
        trainer.run(batches(CachedLatentsDataset(cache), bsz, loop_seed), extra)

    window = [(t, s, r) for t, s, r in rec.rows if check < s <= rec.last_step]
    window_s = rec.t_end - rec.t_start
    steps = len(window)
    losses_p = [r["loss"] for _, s, r in rec.rows if s <= check]
    mu1, params_p = rec.mu1, rec.params
    rec.trainer = None
    del trainer, state, frozen, bundle, distill_step, extra, lora0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = follow(ctx, cache, loop_seed)
    gaps = compare.training_gaps(losses_p, mu1, params_p, ref["lora0"], ref)
    print(f"# {spec['name']}: {steps} steps in a {window_s:.3f} s window after "
          f"{rec.t_start - ctx.t0:.3f} s of set-up; reference {time.perf_counter() - t_ref:.3f} s; "
          f"losses {losses_p} against {ref['losses']}; gaps {gaps}", file=sys.stderr, flush=True)
    limits = spec["limits"]
    checks = {k: (v, limits[k]) for k, v in gaps.items() if limits.get(k) is not None}

    samples = steps * bsz
    record = {"kind": "train", "batch": bsz, "window_s": window_s, "steps": steps,
              "samples": samples, "rows": [r for _, _, r in window], "config": cfg,
              "spec": spec, "trace": rec.trace, "gaps": gaps}
    e2e = {"train_samples_per_s": samples / window_s,
           "peak_gib": rec.peak / 2 ** 30,
           "setup_s": rec.t_start - ctx.t0}
    return harness.Run(end_to_end=e2e, record=record, checks=checks, attempted=steps, failed=0,
                       memory_peak_bytes=rec.peak, trace=rec.trace)


def follow(ctx, cache, loop_seed):
    """The reference over the first ``check_steps`` steps, from the inputs
    alone, in fp32 with TF32 off; returns `reference.distill.train`'s dict
    (on the CPU) with the adapter both sides started from as ``lora0``."""
    spec, cfg = ctx.spec, ctx.spec["config_spec"]
    dev = torch.device(ctx.device)
    served = torch.bfloat16 if dev.type == "cuda" else torch.float32
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = reference_model(cfg, dev)
        weights.fill_frozen(model.named_parameters(), ctx.seed, dev, served=served)
        lora0 = weights.draw_adapter(ref_layers.lora_shapes(model, cfg["lora"]["rank"]),
                                     cfg["lora"]["rank"], spec["adapter_b_std"], ctx.seed, dev)
        rows = ref_distill.read_cache(cache)
        n, bsz, steps = len(rows["latents"]), spec["batch"], spec["check_steps"]
        order = ref_distill.batch_rows(n, bsz, loop_seed, steps)
        data = [{k: torch.from_numpy(v[idx].astype(np.float32)).to(dev)
                 for k, v in rows.items()} for idx in order]
        d = spec["distill"]
        gen = torch.Generator(dev).manual_seed(loop_seed)
        draws = [ref_distill.draws(gen, tuple(b["latents"].shape), d["num_solver_steps"],
                                   (d.get("w_min", 4.0), d.get("w_max", 5.0)),
                                   d.get("fixed_w"), dev) for b in data]
        fam = family(cfg)
        out = ref_distill.train(ref_distill.Distill(fam.forward(model), d, dev), lora0, data,
                                draws, fam.cond, spec["lr"], spec["reference_rows"])
        cpu = {"losses": out["losses"],
               "first_grad": {k: v.cpu() for k, v in out["first_grad"].items()},
               "params": {k: v.cpu() for k, v in out["params"].items()},
               "lora0": {k: v.cpu() for k, v in lora0.items()}}
        del model, out, data, draws
        return cpu
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
