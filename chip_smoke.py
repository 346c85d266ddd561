#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100): the SD1.5 serving
path, the SD1.5 distillation step (bf16 and int8 frozen weights), the
SDXL-1024 cached distillation step on int8 frozen weights, adversarial
distillation of SD1.5 and SDXL-1024 on cached latents, SD1.5 training
from images through to serving the kohya LoRA it writes, and SDXL-1024 from
text and from pixels: its VAE and text towers, its latent cache, adversarial
training from images and SDXL serving of the LoRA that training writes; and
SD3 at 1024 px: the MMDiT, T5-XXL and the two CLIP towers, the 16-channel
VAE, the flow consistency step on cached latents, SD3 adversarial
distillation (the teacher's taps, ``sd3_4phase_adv`` on caches and from
pixels, ``cache_latents --family sd3``) and ``--family sd3`` serving of the
LoRA it trains, deterministic and stochastic; and SD1.5 teacher weights from
a hub folder, Prodigy training with validation grids and asynchronous saves,
and ``python -m pcm_tpu_torch.generate`` with TCD and DDIM; and int8
frozen weights on every family and recipe: the int8-against-bf16 loss
trajectory of an adversarial recipe, SDXL and SD3 adversarial training,
SD3 serving on int8 weights, and the int8 ``conv`` / ``both`` modes; and
data parallelism: the trainer under ``python -m torch.distributed.run`` (one
NCCL rank, two gloo ranks sharing the card) and, with several cards, the
SDXL step and the sharded serving engine on all of them; and the frozen
weights sharded over ranks (FSDP): two gloo ranks sharing the card against
one process, and, with four cards, data x FSDP against data parallelism
alone; and evaluation:
the numpy JPEG and BMP decoders, training from a JPEG folder, the CLIP
ViT-L/14 tower, the CLIP-FID and CLIP score CLIs and the demo with its
safety checker; and the remat policies and granularities on the SDXL-1024
and SD3 steps.

    python3 chip_smoke.py [--seed 0]

Phases, one printed line each (``t=`` the seconds since the start):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the port's CUDA kernels (pcm_tpu_torch/csrc) into one library;
  3. kernels: each kernel against its plain PyTorch version at the SD1.5 shapes
     of the serving path and the SDXL-1024 shapes of the SDXL step, bf16 on the
     card, with errors, CUDA-event times and bit-identical reruns (K1, K5 at
     every shape), and at a second, SDXL headline (``sdxl_*`` fields) for K1,
     K5 and K6 as for K2 / K3, and K1's VAE head (``vae_*``); beside K5 the
     bare cuBLAS product ``F.linear(x, w)`` (``product_ms``), the yardstick of
     its tensor-core part; beside K4 at its act=None shapes ``F.group_norm``
     on the NCHW channels-last view (``act_none_library``);
     the flash-attention backward (K2 dK/dV, K3 dQ) through its autograd
     Function against autograd of the plain attention at the training shapes,
     and twice bit-identical, with the SDPA backward and the bounds at the
     SD1.5 and SDXL headline shapes; the GroupNorm Function's gradients; the fused
     int8 matmul (K6) at the SD1.5 and SDXL shapes of the int8 paths; K4 on
     fp32 at the discriminator heads' shapes (``fp32_*`` fields, beside
     ``F.group_norm`` on the same tensor, bit-identical reruns; the SD3
     heads' (2 / 4, 4096, 1536) as rows of ``fp32_sd3``); K1 at SD3's
     joint sequence (b, 4250, 4250, 24, 64), ragged in q and k, at the served
     student's b = 4 (``sd3_*`` fields) and the CFG teacher's 8 (rows of
     ``sd3_4250``), and K2 / K3 at the cached step's (2, 4250, 4250, 24, 64)
     (``sd3_*`` fields); beside
     each kernel the least time the card could take (``bound_ms``) and the
     one PyTorch call that computes the same function, where there is one;
  4. unet: one full-width SD1.5 UNet forward at batch 4, kernels against the
     plain versions (``reference_ops``);
  5. slice: the full-width SD1.5 bundle with random weights from ``--seed``,
     served through InferenceEngine + BatchingServer (student with a seeded
     adapter, 6 HTTP requests: a full batch of 4 and a partial one) and a
     teacher engine at guidance 7.5; checks images, seed reproducibility
     across batches and that every kernel of the path was launched;
  6. unet-grad: one full-width student forward + backward at batch 2, the
     LoRA gradients of the kernels against those of the plain versions, and
     against K2 alone and K3 alone plain;
  7. train: ``python -m pcm_tpu_torch.train``'s ``main`` for 3 full-width
     ``sd15_4phase`` steps at batch 4 on a seeded cached-latents shard
     (written under build/), then a resume for one more step; checks the
     loss, that the LoRA moved and that K1-K5 were all launched;
  8. train-int8: the same entry point with ``--frozen-weights int8
     --int8-matmul fused`` for 3 steps; checks that K1-K6 were all launched;
  9. sdxl-unet: the full-width SDXL UNet, one forward at 1024 px, on bf16
     weights and on int8 weights under ``fused``: kernels against all plain
     versions and against K1, K4, K5 each plain alone, beside a yardstick of
     bf16 round-off (a half-step nudge of the input, all plain); on int8, the
     output with K6's plain version alone equal bit for bit;
 9a. adv-grad: on the bf16 SDXL weights at batch 2, the teacher's down and
     mid taps of a latent that requires grad, the SDXL discriminator heads
     and the hinge G loss; the gradients to the latent and to the heads with
     the kernels against all plain versions; K1-K5, K4 on fp32 and K5's
     backward (autograd of its plain version) all ran;
 remat. the remat settings (`remat_runs`, `remat_check`; after 9a on its bf16
     SDXL weights and after 20 on SD3's): the SDXL-1024 cached step at batch 4
     under `REMAT_SDXL` (``full`` at ``block`` and ``module``, ``dots8m``,
     ``dots``, ``dots8m+fa``, ``nothing+fa``, ``none``) and SD3's at batch 2
     under ``full`` and ``dots8m+fa``, one batch, one set of draws and one
     state for all, each run twice: the loss and every LoRA gradient equal to
     the reference's (the first setting's first run) bit for bit, or
     within twice its own run-to-run spread where the card gives one; under
     ``+fa`` K1 launched once an attention fewer a step than under ``full``
     (the recompute takes K1's output and lse from the forward), as often as
     without remat; step ms, peak and K1 launches of each;
 10. sdxl-step: the SDXL-1024 cached consistency step (`sdxl_bundle` +
     `build_ddim_distill_step`, 40 solver steps, 4 phases, w in [6, 7), remat
     full at the bundle's ``module`` granularity) on int8 frozen weights under
     ``fused``, batch 4, 3 steps: finite losses, peak memory, K1-K6 all
     launched;
 11. train-adv: ``python -m pcm_tpu_torch.train``'s ``main`` on seeded caches
     under build/: ``sdxl_4phase_adv`` at full width, batch 2 (128x128x4
     latents), ``--adv-pairing fused`` for 4 global steps, ``fresh`` for 4
     and a resume of ``fresh`` for 2 more; ``sd15_2phase_adv``, batch 4,
     ``fresh``, 4 steps. Checks finite ``loss`` and ``d_loss``, that the
     LoRA and the heads moved, that the resume restored the heads' state and
     the step counter, and that K1-K5 and K4 on fp32 were launched;
 12. encoder: the full-width SD1.5 VAE encoder, batch 4, 512 px, seeded
     pixels: the posterior mean with the kernels against all plain versions
     within phase 9's rule, max(2e-2, 2 x the input-nudge yardstick), K1
     (d = 512) and K4 launched, CUDA-event ms and peak memory of an encode;
 13. pixels: 12 seeded PNGs with captions under build/ (two larger and not
     square, so the resize and the crop run; their rows cycle through the
     Sub, Up, Average and Paeth filters), each decoded back exactly and its
     decode + resize timed, then ``python -m
     pcm_tpu_torch.train --recipe sd15_4phase --train-data-dir`` as a child
     process at full width, batch 4, 6 steps, checkpoints every 2: SIGTERM
     after its step-3 row (exit 0, a checkpoint, a kohya file and a
     ``preempted`` row at the step it stopped), then a rerun that resumes
     there and ends at 6; K1-K5 launched by the two processes; step ms, peak
     memory, the host counters and the image decoder it used;
 14. serve-lora: the engine of ``python -m pcm_tpu_torch.serving --lora
     <step-6 file>`` behind the HTTP server: a request, ``POST /lora`` of the
     step-4 file, the same request; the two images differ and each equals,
     bit for bit, the engine fed that step's adapter rounded to fp16 as a
     dict; ``/stats`` counts one swap.
 15. sdxl-vae: the full-width SDXL VAE at 1024 px: an encode at batch 1 (the
     posterior mean) and a decode at batch 4 on seeded pixels and latents,
     kernels against all plain versions within phase 12's rule, CUDA-event ms,
     peak memory and the K1 / K4 launches of each; whether the decoder gives a
     sample the same bits at another batch position, decoded as a batch and
     one sample a call (chunk 1, as ``--family sdxl`` serving decodes), and
     the chunk-1 decode's ms; the encode's peak at batch 4 in chunks of 1 and
     of 4;
 16. sdxl-towers: CLIP-L + CLIP-bigG ``encode_prompts`` at batch 4, full
     width: (4, 77, 2048) and (4, 1280), finite, ms;
 17. sdxl-pixels: 8 seeded captioned PNGs under build/ (two larger than
     1024 px and not square, so the resize and the random crop run), ``python
     -m pcm_tpu_torch.data.cache_latents --family sdxl``'s ``main`` over them
     (the four arrays' shapes, crops in ``time_ids``), then ``python -m
     pcm_tpu_torch.train --recipe sdxl_4phase_adv --train-data-dir`` as a child
     process at full width, batch 2, ``--adv-pairing fused``, 4 global steps,
     a checkpoint at 4: finite ``loss`` and ``d_loss``, the LoRA and the
     heads moved, the kohya file at 4, K1-K5 and K4 on fp32 launched, and
     the loader's ``time_ids`` (the same sample streams) not all the
     uncropped [1024, 1024, 0, 0, 1024, 1024]; step ms, peak, host counters;
 18. sdxl-serve: the engine of ``python -m pcm_tpu_torch.serving --family sdxl
     --lora <step-4 file>`` behind the HTTP server, 2 steps, batch 4, 1024 px:
     a full batch of 4 and a partial one, the shared request's image equal bit
     for bit; a teacher engine on the same weights at guidance 7.5 (K5); the
     steady batch latency and peak of each; the UNet's batch-4 forward with
     cuDNN on and off.
 19. sd3-mmdit: the full-width SD3 MMDiT (2085.0 M params, remat full: a
     region a joint block) at
     batch 2, 128x128x16 latents and (154, 4096) context: one teacher forward
     with K1 against every plain version within max(2e-2, 2 x the input-nudge
     yardstick), its ms and 24 K1 launches; then the LoRA gradients of a
     student forward + backward (rank 32, seeded b != 0) against the plain
     versions and against K2 alone and K3 alone plain (as phase 6);
 20. sd3-step: the SD3 cached consistency step (`sd3_bundle` +
     `build_flow_distill_step` on `SD3_CACHED_STEP`: 100 Euler solver steps,
     4 phases, fixed w = 3, lr 5e-6) at batch 2 for 3 steps, zero uncond:
     finite losses, step ms, peak memory, K1-K3 launched;
 20a. sd3-adv-grad: the same MMDiT on the adversarial LoRA list (rank 32,
     seeded b != 0), the SD3 heads from ``--seed + 1``: the teacher's 24 taps
     of a renoised latent at batch 2, kernels against all plain versions
     within phase 9's rule; the G loss's LoRA gradients (the student, its
     Euler jump, the flow renoising, the taps, the heads, the hinge loss)
     against all plain versions and against K2 alone and K3 alone plain (cos
     >= 0.99, norm <= 5e-2); K1-K3 and K4 on fp32 launched;
 21. sd3-towers: CLIP-L (768 projection), CLIP-bigG and T5-XXL
     ``encode_prompts`` at batch 4: (4, 154, 4096) and (4, 2048), finite,
     ms, T5's range;
 22. sd3-vae: the SD3 VAE decoding one 1024-px sample (as serving decodes),
     kernels against plain within phase 15's rule, ms, K4 / K1 launches;
 22a. train-sd3-adv: ``python -m pcm_tpu_torch.train --recipe sd3_4phase_adv``
     as child processes at full width, batch 2, on a seeded SD3 cache under
     build/ (128x128x16 latents, (154, 4096) embeds, 2048 pooled): ``fused``
     for 4 global steps, a checkpoint at 4 (lr 1e-2, so that phase 23's
     image moves), and ``fresh`` for 4; finite ``loss`` and ``d_loss``, the
     LoRA and the heads moved, kohya files under ``lora_transformer`` holding
     the adversarial list's layers, K1-K3 and K4 on fp32 launched; step ms,
     peak, host counters;
 22b. sd3-pixels: ``python -m pcm_tpu_torch.data.cache_latents --family sd3``'s
     ``main`` over phase 17's 1024-px PNGs (the three arrays' shapes), then
     ``sd3_4phase_adv --train-data-dir`` as a child process, ``fused``, batch
     2, 2 global steps (the VAE encode and the three towers each step), as
     phase 22a checks it and K4 in bf16 launched;
 23. sd3-serve: the engine of ``python -m pcm_tpu_torch.serving --family sd3
     --lora <phase 22a's fused step-4 file>`` behind the HTTP server (the
     adversarial template that the file selects), 2 PCM-FM steps on the
     100-point grid, batch 4, 1024 px: a full batch and a partial one, the
     shared request's image equal bit for bit and unlike the image of the
     file's base-list subset; a teacher engine at guidance 3.0 (the MMDiT at
     batch 8); a ``--stochastic`` engine whose request image is also equal in
     a full and a partial batch and differs from the deterministic one; batch
     latencies and peaks.
 24. port-weights: the seeded full-width SD1.5 bundle written as a BF16
     diffusers folder (CLIP's int64 ``position_ids`` beside), ``python -m
     pcm_tpu_torch.port_weights --family sd15`` as a child process, its file
     loaded as ``--teacher-checkpoint`` loads it: every state equal and a
     UNet forward on the card bit-identical to the seeded bundle's;
 25. train-prodigy: ``python -m pcm_tpu_torch.train --recipe sd15_4phase`` on
     phase 24's teacher and phase 7's cache as a child process, batch 4,
     ``--optimizer prodigy --learning-rate 1.0``, validation grids (two
     prompts) and a checkpoint every 2 steps, 4 steps, then a rerun that
     resumes at 4 and is SIGTERM'd; grids' shapes, a finite ``prodigy_d``,
     the resumed Prodigy state, the step after each save beside the steady
     step, the validation calls' seconds and the peak;
 25b. save-order: a trainer holding phase 25's step-4 LoRA and Prodigy
     state on the card saves with the card busy, so that the save's pinned
     copies queue behind the work, and three Prodigy updates enqueued right
     behind them; then one holding two 256-MiB tensors saves twice so, the
     second while the first file is being written; each checkpoint must
     equal, bit for bit, the state it was saved from;
 26. generate: ``python -m pcm_tpu_torch.generate``'s ``main`` on phase 24's
     teacher, batch 4, 4 steps: phase 25's step-4 LoRA with ``--scheduler
     tcd`` (twice: the same PNG bytes) and ``ddim``, and the teacher at
     ``--cfg 7.5`` (K5); batch latencies, and the final latents with the
     kernels against all plain versions within max(2e-2, 2 x the
     input-nudge yardstick).
 27. int8-adv: ``sd15_2phase_adv`` on phase 7's cache, batch 4, ``fresh``
     pairing, one seed, 12 global steps on int8 frozen weights under
     ``--int8-matmul fused`` and on bf16 weights; the gate is
     ``scripts/compare_runs.py`` on their metrics (its default 5 %
     final-window threshold), and the per-point max / mean of ``loss`` and
     ``d_loss`` are printed; then 2 steps under ``scoped`` and ``dense``.
     Every run as phase 11 checks its runs; K6 launched under ``fused``
     alone. (Each run's checkpoints are deleted after it, as phase 11's are
     once phase 11 has ended: the card's machine bounds the disk writes.)
 28. sdxl-adv-int8: ``sdxl_4phase_adv`` on phase 11's cache, batch 2,
     ``fused`` pairing, 4 global steps on int8 weights under ``fused``;
     checked as phase 11's runs and K6 launched; pair ms and peak beside
     phase 11's bf16 pair.
 29. sd3-int8: ``serving --family sd3 --weights int8 --lora <phase 22a's
     fused file>`` (a full batch and a partial one, the shared request's
     image equal bit for bit, batch ms and peak beside phase 23's bf16) and
     the bytes its int8 weights save (MMDiT, CLIP-L, CLIP-bigG, T5-XXL; the
     VAE stays bf16); its MMDiT at batch 2 under ``fused``: with K6's plain
     version alone equal bit for bit, against every plain version within
     phase 19's rule; ``sd3_4phase_adv --frozen-weights int8 --int8-matmul
     fused`` as a child process on phase 22a's cache, ``fused`` pairing, 2
     global steps: finite losses, the LoRA and the heads moved, K6 launched.
     (``generate --family sd3 --weights int8`` is not driven here: it takes a
     teacher file, 15.4 GB for SD3 in bf16, past the smoke's disk bound.)
 30. int8-conv: the full-width SD1.5 UNet on int8 weights at batch 4 under
     ``both``, ``conv`` and ``fused`` against the dequantized forward
     (finite; errors printed) and CUDA-event ms of each; at every int8 conv,
     `QConvFn`'s ``dx`` against autograd of the dequantized conv within two
     bf16 ulps; the input gradient of the whole UNet under ``both`` against
     ``dense``'s, beside the input-nudge yardstick, printed.
eval. evaluation, the demo and image formats (`eval_phases`, run after phase
     26): (a) the committed JPEG and BMP fixtures (`tests/fixtures/torch_images/`,
     made with PIL by `tests/make_torch_image_fixtures.py`; the card's machine
     has no PIL) through the numpy decoders against their PIL goldens, max <= 3
     and mean < 0.5 LSB, and the 512-px JPEG's decode ms; (b) ``python -m
     pcm_tpu_torch.train --recipe sd15_4phase --train-data-dir`` on a folder of
     those JPEGs and a BMP as a child process, batch 4, 2 steps: finite losses,
     the kohya file's up factors moved, K1-K5 launched; (c) a ViT-L/14 vision
     tower drawn from ``--seed`` and written in transformers' naming, read by
     `CLIPFeatures.from_torch_file` on the card and on the CPU (fp32, TF32
     off): the card's features of phase 26's TCD images within `VISION_BOUND`
     of the CPU's, the ms of a batch of 32 and the peak; (d) ``eval_fid``'s
     ``main`` with ``--clip-weights`` between phase 13's PNGs and (b)'s folder,
     and the PNGs against themselves (0 within 1e-5 x the trace of their
     covariance), ``eval_clip_score``'s on phase 26's images and prompts; (e)
     ``python -m pcm_tpu_torch.demo``'s ``main`` on phase 24's teacher with
     phase 25's step-4 LoRA under the 2-Step name, one prompt on stdin: the
     image equal bit for bit to ``generate``'s (2 DDIM steps, seed 0), K1 and
     K4 launched; again with ``--safety-concepts`` on an npz whose concept is
     that image's CLIP feature (the image black) and on one whose concept is
     its opposite (the image unchanged);
ddp. data parallelism (`ddp_runs` on the lane, checked by `ddp_phase`), four
     trainer runs as child processes, concurrently, ``sd15_4phase`` at full width for 3 steps on phase 7's
     cache rearranged (`write_ddp_caches`): (a) ``python -m
     torch.distributed.run --nproc-per-node 1`` (one NCCL rank) at batch 4
     against the same run with no process group, bit for bit in the losses
     of ``metrics.jsonl`` and in the saved LoRA, K1-K5 launched; (b) two gloo
     ranks on the card at batch 2 each, against one process at batch 4 on
     the same global batches, losses and LoRA within max(2e-2, 2 x the
     yardstick), the yardstick the one process against itself at batch 2 x
     ``--gradient-accumulation-steps 2`` (the same rows and draws, sums in
     another order); (c) with more than one card visible
     (`ddp_cards`, ``scripts/bench_ddp_torch.py``): the SDXL cached step at
     batch 4 a card on N NCCL ranks against one, each rank's step ms, the
     bytes and ms of the step's all-reduce, the peak, and ``serving --family
     sdxl --data-parallel N`` at batch 4 x N against one card at 4; with one
     card it prints ``cards=1``.
fsdp. the frozen weights sharded over ranks (`fsdp_runs` on the lane beside
     phases 24-26 and eval, checked by `fsdp_phase`; needs phase 7's cache), ``scripts/bench_fsdp_torch.py`` at full
     published width, bs 2 a rank, remat on, each step once: (a) SD1.5 at
     512 px on phase 7's cache: the ``sd15_4phase`` consistency step, the
     ``sd15_2phase_adv`` G step then D step on the SD1.5 heads, the fused
     pair and the consistency step on int8 frozen weights under ``fused``,
     as two gloo ranks sharing the card at ``data 1 x fsdp 2`` (a child
     process under the launcher) against one process with no process group
     (a child process run before the ranks start): each rank's
     losses, new LoRA and new heads equal the one process's bit for bit, and
     each rank holds at most 0.51 of the frozen bytes at rest; per rank the
     bytes at rest beside the unsharded total, the peak, the step ms, the
     all-gathers a step, the bytes they rebuilt, the most of those alive and
     the TMA maps the kernels encoded; K1-K6 launched; (b) SD3's flow step
     (``SD3_CACHED_STEP``) from 1024-px pixels, so the VAE encoder, CLIP-L,
     CLIP-bigG, T5-XXL and the MMDiT all run on sharded weights, in the same
     runs and checked as (a), at published widths and `FSDP_SD3_DEPTH`'s
     depth (2 of 24 joint blocks, 2 of 24 T5 layers: gloo's gathers through
     host memory take 55 s a full-depth step); (c) with four cards or more
     (`fsdp_cards`): SD1.5 (a seeded cached batch) and SD3 at published depth
     on four NCCL ranks at ``data 2 x fsdp 2`` against two at ``data 2 x
     fsdp 1`` (data parallelism alone), one after the other, the consistency
     steps twice (timed warm), bit for bit; with fewer it prints ``cards=N``.
Each main path runs with the launch counts set to 0 just before it and read
just after. Some child-process runs go on one thread beside the main one
(`Lane`), so that the card works on two phases at once: the ``ddp`` runs,
phase 13's training from pixels, phase 22a's SD3 runs, the ``fsdp`` runs
(once the main thread has reached phases light on the card's memory), the
training from JPEGs and phase 29's SD3 run on int8 weights; each is checked
where the main thread takes its result. The kernel phase (3) runs before
any of them starts, so the JSON line's times are taken on a card the
script has to itself; the phases' step ms and wall seconds from then on are
taken beside the lane's runs. A run's checkpoints are deleted once they are
read (the machine of the card bounds a call's disk writes, deleted files
included, at 45 GiB). Then a JSON line of the kernels, the nvidia-smi line, and a last
JSON line ``{"ok": true, ...}``.
Any failed check raises: the script then exits non-zero and prints no result.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch


_T0 = time.perf_counter()


def log(phase: str, **kw) -> None:
    """One line: the phase, the seconds since the script started, the fields
    (one write, so that the lane's lines do not cut into the main thread's)."""
    sys.stdout.write(f"[{phase}] t={time.perf_counter() - _T0:.0f}s "
                     + " ".join(f"{k}={v}" for k, v in kw.items()) + "\n")
    sys.stdout.flush()


_CHILDREN: set = set()  # every child process started (`_popen`)
_CHILDREN_LOCK = threading.Lock()
_STOPPING = False


def _popen(argv, **kw) -> subprocess.Popen:
    """A child process in a session of its own (a launcher's ranks join
    it), kept so that `_stop_children` can end it; none starts once the
    script is stopping."""
    with _CHILDREN_LOCK:
        if _STOPPING:
            raise RuntimeError(f"the smoke is stopping: {argv[:4]} not started")
        proc = subprocess.Popen(argv, start_new_session=True, **kw)
        _CHILDREN.add(proc)
    return proc


def _stop_children() -> None:
    """Kill the session of every child of `_popen` that is still running,
    and start no more."""
    import signal

    global _STOPPING
    with _CHILDREN_LOCK:
        _STOPPING = True
        procs = list(_CHILDREN)
    for proc in procs:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


class Lane:
    """Child-process runs on one thread beside the main one, each started
    when the one before it has ended, in the order they were added. The
    card's memory is shared: a run added with ``after`` waits until the main
    thread sets that event (it has reached phases light enough to run
    beside). A run does host work only (its children, their files), so the
    main thread's launch counts and peaks stay its own. `result` waits for a
    run and raises its error; once a run has failed, the later ones do not
    start."""

    def __init__(self):
        import queue

        self._queue = queue.Queue()
        self._runs = {}
        threading.Thread(target=self._loop, name="lane", daemon=True).start()

    def add(self, name: str, fn, *args, after: threading.Event = None) -> None:
        self._runs[name] = {"done": threading.Event(), "value": None, "error": None}
        self._queue.put((name, fn, args, after))

    def _loop(self) -> None:
        failed = None
        while True:
            name, fn, args, after = self._queue.get()
            run = self._runs[name]
            try:
                if after is not None:
                    after.wait()
                if failed:
                    raise RuntimeError(f"not started: lane run {failed!r} failed")
                free, total = torch.cuda.mem_get_info()
                log("lane", run=name, card_free_gib=f"{free / 2**30:.1f}/{total / 2**30:.1f}")
                t0 = time.perf_counter()
                run["value"] = fn(*args)
                log("lane", run=name, seconds=f"{time.perf_counter() - t0:.1f}")
            except BaseException as e:  # handed to the main thread by `result`
                run["error"] = e
                failed = failed or name
            finally:
                run["done"].set()

    def result(self, name: str):
        run = self._runs[name]
        run["done"].wait()
        if run["error"] is not None:
            raise AssertionError(f"lane run {name}: {run['error']!r}") from run["error"]
        return run["value"]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_max(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-6))


def abs_max(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max())


def bf16_randn(shape, gen, scale=1.0, offset=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale + offset).bfloat16()


# published H100 SXM peaks (dense): bytes/s of HBM3, operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time of a function on the card: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its operations over the peak rate of their type."""
    t_ops, t_bytes = ops / PEAK_OPS_S[kind] * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attn_bound(shape, products: int, outputs: int) -> dict:
    """Attention forward / backward: ``products`` matmuls of 2·sq·sk·d per
    (b, h); q, k, v (+ dO) in bf16 and the fp32 row statistics read,
    ``outputs`` bf16 tensors shaped like q or k written."""
    b, sq, sk, h, d = shape
    ops = 2.0 * products * b * h * sq * sk * d
    ins = 2.0 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4.0 * 2 * b * h * sq
    outs = 2.0 * outputs * b * max(sq, sk) * h * d
    return bound(ops, "bf16", ins + outs)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (b, sq, sk, h, d) of the SDXL VAE's mid-block head at 1024 px: an encode at
# batch 1, a decode at batch 4 (each a row of K1's ``vae_1024`` field)
VAE_XL_ATTN = [(1, 16384, 16384, 1, 512), (4, 16384, 16384, 1, 512)]
# (b, sq, sk, h, d) of SD3's joint attention at 1024 px, 4096 image + 154 text
# tokens (66 x 64 + 26: ragged in q and k): the served student at batch 4,
# the teacher under CFG at 8 (each a row of K1's ``sd3_4250`` field; the
# first also its ``sd3_`` headline)
SD3_ATTN = [(4, 4250, 4250, 24, 64), (8, 4250, 4250, 24, 64)]
# (b, sq, sk, h, d): SD1.5 at 512 px, batch 4 (UNet self/cross, mid, VAE mid);
# then the SDXL UNet at 1024 px, batch 4 (self/cross at 64x64 and 32x32);
# ``VAE_XL_ATTN``; last ``SD3_ATTN``
ATTN_SHAPES = [
    (4, 4096, 4096, 8, 40), (4, 4096, 77, 8, 40), (4, 1024, 1024, 8, 80),
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (4, 256, 77, 8, 160),
    (4, 64, 64, 8, 160), (4, 4096, 4096, 1, 512),
    (4, 4096, 4096, 10, 64), (4, 4096, 77, 10, 64), (4, 1024, 1024, 20, 64),
    (4, 1024, 77, 20, 64), *VAE_XL_ATTN, *SD3_ATTN,
]
# (shape NHWC, eps, act) of the SDXL VAE at 1024 px: the encoder's top level at
# batch 1, the decoder's levels at batch 4 and its attention's norm (each a row
# of K4's ``gn_1024`` field)
VAE_XL_GN = [((1, 1024, 1024, 128), 1e-6, "silu"), ((4, 1024, 1024, 128), 1e-6, "silu"),
             ((4, 1024, 1024, 256), 1e-6, "silu"), ((4, 512, 512, 512), 1e-6, "silu"),
             ((4, 256, 256, 512), 1e-6, "silu"), ((4, 128, 128, 512), 1e-6, None)]
# (shape NHWC, eps, act): UNet resnets / transformer norms, VAE decoder, the
# VAE encoder's levels below 512 px (training from pixels); then
# SDXL at 1024 px, batch 4 (resnets of each level, an up-path concat, a
# transformer norm); last ``VAE_XL_GN``
GN_SHAPES = [
    ((4, 64, 64, 320), 1e-5, "silu"), ((4, 64, 64, 960), 1e-5, "silu"),
    ((4, 32, 32, 1920), 1e-5, "silu"), ((4, 16, 16, 2560), 1e-5, "silu"),
    ((4, 8, 8, 1280), 1e-5, "silu"), ((4, 64, 64, 320), 1e-6, None),
    ((4, 64, 64, 512), 1e-6, None), ((4, 512, 512, 128), 1e-6, "silu"),
    ((4, 512, 512, 256), 1e-6, "silu"),
    ((4, 256, 256, 128), 1e-6, "silu"), ((4, 256, 256, 256), 1e-6, "silu"),
    ((4, 128, 128, 256), 1e-6, "silu"), ((4, 128, 128, 512), 1e-6, "silu"),
    ((4, 64, 64, 512), 1e-6, "silu"),
    ((4, 128, 128, 320), 1e-5, "silu"), ((4, 64, 64, 640), 1e-5, "silu"),
    ((4, 32, 32, 2560), 1e-5, "silu"), ((4, 128, 128, 960), 1e-5, "silu"),
    ((4, 32, 32, 1280), 1e-6, None),
    *VAE_XL_GN,
]
# (N, S, C) of the SD3 heads' fp32 GroupNorm: a 64x64 grid of 1536 channels
# (48 a group) at the G step's B = 2 and the D step's 2B = 4 (each a row of
# K4's ``fp32_sd3`` field)
GN_FP32_SD3 = [(2, 4096, 1536), (4, 4096, 1536)]
# (N, S, C) of the discriminator heads' fp32 GroupNorm at the D step's 2B = 4:
# SDXL's 64x64 tap (also SD1.5's up_3) and its 32x32 taps at 1280, SD1.5's
# up_2; the first is the fp32 headline; then ``GN_FP32_SD3``
GN_FP32_SHAPES = [(4, 4096, 320), (4, 1024, 1280), (4, 4096, 640), *GN_FP32_SD3]
# (M = b*s, K, F): the SD1.5 feed-forward in-projections (teacher; CFG doubles
# M), then SDXL's at batch 4 under CFG
GEGLU_SHAPES = [(16384, 320, 1280), (32768, 320, 1280), (4096, 640, 2560),
                (1024, 1280, 5120), (256, 1280, 5120), (32768, 640, 2560), (8192, 1280, 5120)]
# the shape whose times go into the kernels JSON line
HEADLINE = {"flash_attention_fwd": (4, 4096, 4096, 8, 40),
            "group_norm_silu": ((4, 512, 512, 256), 1e-6, "silu"),
            "geglu": (16384, 320, 1280)}
# second headlines at SDXL-1024 widths, into ``sdxl_*`` fields: self-attention
# at 64x64 and the feed-forward at 32x32 under CFG
SDXL_HEADLINE = {"flash_attention_fwd": (4, 4096, 4096, 10, 64), "geglu": (8192, 1280, 5120)}
# a third, into ``vae_*`` fields: K1's 512-wide instance, the VAE mid-block's
# single head (SD1.5 decode at batch 4)
VAE_HEADLINE = {"flash_attention_fwd": (4, 4096, 4096, 1, 512)}
# a fourth, into ``sd3_*`` fields: SD3's joint attention of the served student
SD3_HEADLINE = {"flash_attention_fwd": SD3_ATTN[0]}


def headline_prefix(name, key):
    """The field prefix of a headline shape ("", "sdxl_", "vae_", "sd3_"), or None."""
    for prefix, table in (("", HEADLINE), ("sdxl_", SDXL_HEADLINE), ("vae_", VAE_HEADLINE),
                          ("sd3_", SD3_HEADLINE)):
        if key == table.get(name):
            return prefix
    return None


def check_kernels(gen) -> dict:
    from pcm_tpu_torch.ops.flash_attention import (attention_lse_reference, attention_reference,
                                                   flash_attention_fwd)
    from pcm_tpu_torch.ops.geglu import geglu, geglu_reference
    from pcm_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference

    results = {k: {"max_abs_err": 0.0, "library_ms": None} for k in HEADLINE}
    # K4's headline has a SiLU, which F.group_norm lacks: its yardstick is
    # taken at the act=None shapes instead, [shape, ms, F.group_norm ms] each
    results["group_norm_silu"]["act_none_library"] = []

    def record(name, key, err_abs, ms, plain_ms):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err_abs)
        prefix = headline_prefix(name, key)
        if prefix is not None:
            r[prefix + "ms"], r[prefix + "plain_ms"] = ms, plain_ms

    def headline(name, key, **fields):
        """Bound and yardsticks of a headline shape: plain fields at the
        SD1.5 headline, ``sdxl_``- or ``vae_``-prefixed at the others."""
        prefix = headline_prefix(name, key)
        results[name].update({prefix + f: v for f, v in fields.items()
                              if not (prefix and f == "bound_by")})
        log("kernel", name=name, shape=key, **{f: f"{v:.4f}" if isinstance(v, float) else v
                                               for f, v in fields.items()})

    for shp in ATTN_SHAPES:
        b, sq, sk, h, d = shp
        q = bf16_randn((b, sq, h, d), gen)
        k = bf16_randn((b, sk, h, d), gen)
        v = bf16_randn((b, sk, h, d), gen)
        o, lse = flash_attention_fwd(q, k, v)
        again = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        ref = attention_reference(q.float(), k.float(), v.float())
        lse_ref = attention_lse_reference(q.float(), k.float())
        err, err_lse = rel_max(o, ref), abs_max(lse, lse_ref)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v))
        plain = cuda_ms(lambda: attention_reference(q, k, v))
        log("kernel", name="flash_attention_fwd", shape=shp, rel_max=f"{err:.3e}",
            lse_abs=f"{err_lse:.3e}", deterministic=same, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
        if not (err <= 2e-2 and err_lse <= 5e-3 and same):
            raise AssertionError(f"flash attention {shp}: rel {err:.3e}, lse {err_lse:.3e}, "
                                 f"bit-identical rerun {same}")
        record("flash_attention_fwd", shp, abs_max(o, ref), ms, plain)
        rows = "vae_1024" if shp in VAE_XL_ATTN else "sd3_4250" if shp in SD3_ATTN else None
        if headline_prefix("flash_attention_fwd", shp) is not None or rows:
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))  # (b, h, s, d)
            lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
            if rows:
                row = {"shape": shp, "rel_max": err, "ms": ms, "plain_ms": plain,
                       "bound_ms": attn_bound(shp, 2, 1)["bound_ms"], "library_ms": lib}
                results["flash_attention_fwd"].setdefault(rows, []).append(row)
                log("kernel", name="flash_attention_fwd", **{k: f"{v:.4f}" if isinstance(
                    v, float) else v for k, v in row.items()})
            if rows != "vae_1024" and headline_prefix("flash_attention_fwd", shp) is not None:
                headline("flash_attention_fwd", shp, library_ms=lib, **attn_bound(shp, 2, 1))
            del qt, kt, vt
        del q, k, v, o, ref, again

    for key in GN_SHAPES:
        shp, eps, act = key
        c = shp[-1]
        x = bf16_randn(shp, gen)
        gamma, beta = bf16_randn((c,), gen, 0.5, 1.0), bf16_randn((c,), gen, 0.5)
        out = group_norm_silu(x, gamma, beta, 32, eps, act)
        torch.cuda.synchronize()
        ref = group_norm_silu_reference(x.float(), gamma.float(), beta.float(), 32, eps, act)
        err = rel_max(out, ref)
        ms = cuda_ms(lambda: group_norm_silu(x, gamma, beta, 32, eps, act))
        plain = cuda_ms(lambda: group_norm_silu_reference(x, gamma, beta, 32, eps, act))
        lib = None
        if act is None:  # one PyTorch call of K4's function: on the NCHW channels-last view
            xv = x.permute(0, 3, 1, 2)
            lib = cuda_ms(lambda: torch.nn.functional.group_norm(xv, 32, gamma, beta, eps))
            results["group_norm_silu"]["act_none_library"].append([shp, ms, lib])
        log("kernel", name="group_norm_silu", shape=shp, eps=eps, act=act, rel_max=f"{err:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}", library_ms=lib and f"{lib:.4f}")
        if not err <= 1e-2:
            raise AssertionError(f"group norm {key}: rel {err:.3e}")
        record("group_norm_silu", key, abs_max(out, ref), ms, plain)
        b = bound(8.0 * x.numel(), "fp32", 4.0 * x.numel())  # read x, write y (bf16); ~8 ops
        if key == HEADLINE["group_norm_silu"]:
            results["group_norm_silu"].update(b)
        if key in VAE_XL_GN:
            results["group_norm_silu"].setdefault("gn_1024", []).append(
                {"shape": shp, "act": act, "rel_max": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b["bound_ms"], "library_ms": lib})
        del x, out, ref

    # stability on a large mean (the Pallas one-pass variance cancels here)
    x = bf16_randn((4, 64, 64, 320), gen, 1.0, 100.0)
    one, zero = torch.ones(320, device="cuda").bfloat16(), torch.zeros(320, device="cuda").bfloat16()
    err = rel_max(group_norm_silu(x, one, zero, 32, 1e-5, None),
                  group_norm_silu_reference(x.double(), one.double(), zero.double(), 32, 1e-5, None))
    log("kernel", name="group_norm_silu", shape="(4,64,64,320)+100", rel_max=f"{err:.3e}")
    if not err <= 1e-2:
        raise AssertionError(f"group norm on a +100 offset: rel {err:.3e}")

    for shp in GN_FP32_SHAPES:  # K4 on fp32 (act=None), against F.group_norm too
        c = shp[-1]
        x = torch.randn(shp, generator=gen, device="cuda") * 2 + 0.5
        gamma = torch.randn((c,), generator=gen, device="cuda") * 0.5 + 1.0
        beta = torch.randn((c,), generator=gen, device="cuda") * 0.5
        out = group_norm_silu(x, gamma, beta, 32, 1e-5, None)
        same = torch.equal(out, group_norm_silu(x, gamma, beta, 32, 1e-5, None))
        torch.cuda.synchronize()
        ref = group_norm_silu_reference(x.double(), gamma.double(), beta.double(), 32, 1e-5, None)
        err = rel_max(out, ref)
        ms = cuda_ms(lambda: group_norm_silu(x, gamma, beta, 32, 1e-5, None))
        plain = cuda_ms(lambda: group_norm_silu_reference(x, gamma, beta, 32, 1e-5, None))
        side = math.isqrt(shp[1])  # the NCHW channels-last view of the (N, h, w, C) tap
        xv = x.reshape(shp[0], side, side, c).permute(0, 3, 1, 2)
        lib = cuda_ms(lambda: torch.nn.functional.group_norm(xv, 32, gamma, beta, 1e-5))
        b = bound(8.0 * x.numel(), "fp32", 8.0 * x.numel())  # read x, write y (fp32)
        log("kernel", name="group_norm_silu_fp32", shape=shp, rel_max=f"{err:.3e}",
            deterministic=same, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            library_ms=f"{lib:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
        if not (err <= 1e-5 and same):
            raise AssertionError(f"group norm fp32 {shp}: rel {err:.3e}, bit-identical rerun {same}")
        r = results["group_norm_silu"]
        r["fp32_max_abs_err"] = max(r.get("fp32_max_abs_err", 0.0), abs_max(out, ref))
        if shp == GN_FP32_SHAPES[0]:
            r.update(fp32_shape=shp, fp32_ms=ms, fp32_plain_ms=plain, fp32_library_ms=lib,
                     fp32_bound_ms=b["bound_ms"])
        if shp in GN_FP32_SD3:
            r.setdefault("fp32_sd3", []).append(
                {"shape": shp, "rel_max": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": lib})
        del x, out, ref

    for shp in GEGLU_SHAPES:
        m, kk, f = shp
        x = bf16_randn((m, kk), gen)
        w = bf16_randn((2 * f, kk), gen, kk ** -0.5)
        bias = bf16_randn((2 * f,), gen, 0.1)
        out = geglu(x, w, bias)
        same = torch.equal(out, geglu(x, w, bias))
        torch.cuda.synchronize()
        ref = geglu_reference(x.float(), w.float(), bias.float())
        err = rel_max(out, ref)
        ms = cuda_ms(lambda: geglu(x, w, bias))
        plain = cuda_ms(lambda: geglu_reference(x, w, bias))
        log("kernel", name="geglu", shape=shp, rel_max=f"{err:.3e}", deterministic=same,
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
        if not (err <= 2e-2 and same):
            raise AssertionError(f"geglu {shp}: rel {err:.3e}, bit-identical rerun {same}")
        record("geglu", shp, abs_max(out, ref), ms, plain)
        if shp in (HEADLINE["geglu"], SDXL_HEADLINE["geglu"]):
            # product_ms: the bare product x [Wa; Wb]^T by cuBLAS, no bias or
            # gate; the yardstick of the tensor-core part, not a GEGLU call
            prod = cuda_ms(lambda: torch.nn.functional.linear(x, w))
            headline("geglu", shp, product_ms=prod,
                     **bound(2.0 * m * kk * 2 * f, "bf16",
                             2.0 * (m * kk + 2 * f * kk + 2 * f + m * f)))
        del x, w, bias, out, ref
    return results


# (b, sq, sk, h, d): the SD1.5 UNet's attentions at 512 px, training batch 4,
# then SDXL's at 1024 px, then SD3's joint attention of the cached step's
# student (batch 2, 4250 tokens: ragged in q and k)
BWD_SHAPES = [
    (4, 4096, 4096, 8, 40), (4, 4096, 77, 8, 40), (4, 1024, 1024, 8, 80),
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (4, 256, 77, 8, 160),
    (4, 64, 64, 8, 160), (4, 64, 77, 8, 160),
    (4, 4096, 4096, 10, 64), (4, 4096, 77, 10, 64), (4, 1024, 1024, 20, 64),
    (4, 1024, 77, 20, 64), (2, 4250, 4250, 24, 64),
]
BWD_HEADLINE = (4, 4096, 4096, 8, 40)
# the field prefix of each headline: SD1.5 (plain fields), SDXL-1024
# self-attention, SD3's joint attention
BWD_HEADLINES = {BWD_HEADLINE: "", (4, 4096, 4096, 10, 64): "sdxl_",
                 (2, 4250, 4250, 24, 64): "sd3_"}


def _autograd(fn, inputs, grad_out):
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*xs).backward(grad_out)
    return [x.grad for x in xs]


def sdpa_backward_ms(q, k, v, do) -> float:
    """CUDA-event time of the backward of `scaled_dot_product_attention`
    (dQ, dK and dV in one call) on (b, h, s, d) copies of the inputs."""
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))


def check_backward(gen) -> dict:
    """K2/K3 through FlashAttentionFn against autograd of the fp32 plain
    attention on the same bf16 inputs; each kernel timed alone against its
    plain version (from the same saved o / lse / delta). At the SD1.5 and the
    SDXL and SD3 headline shapes also the SDPA backward (dQ, dK, dV in one
    call) and the bounds; the SDXL and SD3 readings go into ``sdxl_*`` and
    ``sd3_*`` fields."""
    from pcm_tpu_torch.ops.flash_attention import (attention_bwd_dkv_reference,
                                                   attention_bwd_dq_reference, attention_delta,
                                                   attention_reference, flash_attention,
                                                   flash_attention_bwd, flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq, flash_attention_fwd)
    from pcm_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference

    results = {k: {"max_abs_err": 0.0} for k in ("flash_attention_bwd_dkv",
                                                 "flash_attention_bwd_dq")}
    for shp in BWD_SHAPES:
        b, sq, sk, h, d = shp
        scale = d ** -0.5
        q, k, v = bf16_randn((b, sq, h, d), gen), bf16_randn((b, sk, h, d), gen), \
            bf16_randn((b, sk, h, d), gen)
        do = bf16_randn((b, sq, h, d), gen)
        grads = _autograd(flash_attention, (q, k, v), do)
        torch.cuda.synchronize()
        refs = _autograd(attention_reference, [t.float() for t in (q, k, v)], do.float())
        errs = [rel_max(g, r) for g, r in zip(grads, refs)]
        o, lse = flash_attention_fwd(q, k, v)
        first = flash_attention_bwd(q, k, v, o, lse, do, scale)
        second = flash_attention_bwd(q, k, v, o, lse, do, scale)
        same = all(torch.equal(a, c) for a, c in zip(first, second))
        delta = attention_delta(o, do)
        ms_dkv = cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))
        ms_dq = cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, scale))
        plain_dkv = cuda_ms(lambda: attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale))
        plain_dq = cuda_ms(lambda: attention_bwd_dq_reference(q, k, v, do, lse, delta, scale))
        log("kernel", name="flash_attention_bwd", shape=shp,
            rel_max_dq_dk_dv="/".join(f"{e:.3e}" for e in errs), deterministic=same,
            dkv_ms=f"{ms_dkv:.4f}", dkv_plain_ms=f"{plain_dkv:.4f}",
            dq_ms=f"{ms_dq:.4f}", dq_plain_ms=f"{plain_dq:.4f}")
        if not (max(errs) <= 2e-2 and same):
            raise AssertionError(f"flash attention backward {shp}: rel {errs}, "
                                 f"bit-identical reruns {same}")
        for name, err, ms, plain in (
                ("flash_attention_bwd_dkv", max(abs_max(grads[1], refs[1]), abs_max(grads[2], refs[2])),
                 ms_dkv, plain_dkv),
                ("flash_attention_bwd_dq", abs_max(grads[0], refs[0]), ms_dq, plain_dq)):
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if shp in BWD_HEADLINES:
                prefix = BWD_HEADLINES[shp]
                r[prefix + "ms"], r[prefix + "plain_ms"] = ms, plain
        if shp in BWD_HEADLINES:  # the library call: one backward gives dQ, dK and dV
            prefix = BWD_HEADLINES[shp]
            lib = sdpa_backward_ms(q, k, v, do)
            bounds = {"flash_attention_bwd_dkv": attn_bound(shp, 4, 2),  # S, dV, dP, dK
                      "flash_attention_bwd_dq": attn_bound(shp, 3, 1)}  # S, dP, dQ
            for name in results:
                if not prefix:
                    results[name].update(library_ms=lib, **bounds[name])
                else:
                    results[name].update({prefix + "library_ms": lib,
                                          prefix + "bound_ms": bounds[name]["bound_ms"]})
            log("kernel", name="flash_attention_bwd", shape=shp, library_ms=f"{lib:.4f}",
                dkv_bound_ms=f"{bounds['flash_attention_bwd_dkv']['bound_ms']:.4f}",
                dq_bound_ms=f"{bounds['flash_attention_bwd_dq']['bound_ms']:.4f}",
                pair_ms=f"{ms_dkv + ms_dq:.4f}", note="sdpa backward: dq+dk+dv in one call")
        del q, k, v, do, grads, refs, o, lse, first, second

    # the GroupNorm Function: kernel forward, autograd-of-plain backward
    x = bf16_randn((4, 64, 64, 320), gen)
    gamma, beta = bf16_randn((320,), gen, 0.5, 1.0), bf16_randn((320,), gen, 0.5)
    g = bf16_randn((4, 64, 64, 320), gen)
    got = _autograd(lambda *a: group_norm_silu(*a, 32, 1e-5, "silu"), (x, gamma, beta), g)
    ref = _autograd(lambda *a: group_norm_silu_reference(*a, 32, 1e-5, "silu"),
                    [t.float() for t in (x, gamma, beta)], g.float())
    errs = [rel_max(a, r) for a, r in zip(got, ref)]
    log("kernel", name="group_norm_silu_grad", shape=(4, 64, 64, 320),
        rel_max_x_gamma_beta="/".join(f"{e:.3e}" for e in errs))
    if not max(errs) <= 2e-2:
        raise AssertionError(f"group norm gradients: rel {errs}")
    return results


# (M, K, N) of the int8 products: SD1.5 1x1 convs over 64x64 latents at batch 4,
# SDXL-1024 at batch 4 (proj at 64x64, attention/FF at 32x32, cross-attention
# K/V over 4 x 77 tokens of 2048)
K6_SHAPES = [(16384, 320, 320), (16384, 1280, 320), (16384, 640, 640), (4096, 1280, 1280),
             (4096, 5120, 1280), (4096, 1280, 10240), (308, 2048, 1280)]
K6_HEADLINE = (16384, 320, 320)
K6_SDXL = (4096, 1280, 10240)  # second headline: SDXL's feed-forward out of 1280
# SD3-1024's int8 products at batch 2 (the MMDiT's every LoRALinear under
# fused): the image stream's q/k/v/out and FF in/out, proj_out, the context
# stream over 2 x 154 tokens and context_embedder out of 4096, the adaLN
# linears (M = batch), the timestep (K = 256) and pooled-text embedders
K6_SD3_SHAPES = [(8192, 1536, 1536), (8192, 1536, 6144), (8192, 6144, 1536), (8192, 1536, 64),
                 (308, 1536, 1536), (308, 4096, 1536), (2, 1536, 9216), (2, 256, 1536),
                 (2, 2048, 1536)]
K6_SD3 = (8192, 1536, 6144)  # third headline: the image stream's FF in


def check_int8(gen) -> dict:
    """K6 against its plain version on the same bf16 activations and int8
    weights (per-channel codes of a seeded weight): both do the same fp32
    operations in the same order, so every output must be equal bit for bit,
    and the all-zero row x[1] must give a zero row."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference)
    from pcm_tpu_torch.utils.quant import quantize

    result = {"max_abs_err": 0.0, "library_ms": None, "sd3_rows": []}
    for shp in K6_SHAPES + K6_SD3_SHAPES:
        m, k, n = shp
        x = bf16_randn((m, k), gen)
        x[1] = 0  # an all-zero row: scale 1, codes 0
        qt = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
        values, scale = qt.values, qt.scale.reshape(-1)
        out = fused_quantized_dot_fwd(x, values, scale)
        torch.cuda.synchronize()
        ref = fused_quantized_dot_reference(x, values, scale)
        err, n_diff = rel_max(out, ref), int((out != ref).sum())
        zero_row = not bool(out[1].any())
        ms = cuda_ms(lambda: fused_quantized_dot_fwd(x, values, scale))
        plain = cuda_ms(lambda: fused_quantized_dot_reference(x, values, scale), iters=5)
        b = bound(2.0 * m * k * n, "int8", 2.0 * m * k + n * k + 4.0 * n + 2.0 * m * n)
        log("kernel", name="int8_matmul", shape=shp, rel_max=f"{err:.3e}",
            entries_differing=n_diff, zero_row=zero_row, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
        if n_diff or not (torch.equal(out, ref) and zero_row):
            raise AssertionError(f"int8 matmul {shp}: {n_diff} entries differ from the plain "
                                 f"version (rel {err:.3e}), zero row kept zero: {zero_row}")
        result["max_abs_err"] = max(result["max_abs_err"], abs_max(out, ref))
        if shp == K6_HEADLINE:
            result.update(ms=ms, plain_ms=plain, **b)
        if shp == K6_SDXL:
            result.update(sdxl_ms=ms, sdxl_plain_ms=plain, sdxl_bound_ms=b["bound_ms"])
        if shp == K6_SD3:
            result.update(sd3_ms=ms, sd3_plain_ms=plain, sd3_bound_ms=b["bound_ms"])
        if shp in K6_SD3_SHAPES:  # [shape, ms, plain ms, bound ms, bound by]
            result["sd3_rows"].append([shp, ms, plain, b["bound_ms"], b["bound_by"]])
        del x, out, ref, qt, values, scale
    return result


# ---------------------------------------------------------------------------
# phase 4: full-width UNet, kernels against plain versions
# ---------------------------------------------------------------------------


def unet_vs_reference(bundle, frozen, gen) -> float:
    from pcm_tpu_torch.ops import reference_ops

    x = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((4,), 999.0, device="cuda")
    cond = {"prompt_embeds": bf16_randn((4, 77, 768), gen)}
    with torch.inference_mode():
        out = bundle.teacher(frozen, x, t, cond)
        with reference_ops():
            ref = bundle.teacher(frozen, x, t, cond)
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite UNet output")
    return rel_max(out, ref)


# ---------------------------------------------------------------------------
# phase 5: the serving slice
# ---------------------------------------------------------------------------


def _post(url, payload, out, key):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        out[key] = json.loads(r.read())


def _concurrent(url, payloads, out):
    threads = [threading.Thread(target=_post, args=(url, p, out, p["key"])) for p in payloads]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP request did not finish")


def _png_header(png: bytes):
    """(width, height, bit depth, colour type) from a PNG's IHDR chunk."""
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise AssertionError("not a PNG")
    return (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big"), png[24], png[25])


def serve_slice(bundle, frozen, template, gen) -> dict:
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.data.tokenizer import HashTokenizer
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.sampling.ddim import DDIMSampler
    from pcm_tpu_torch.serving import BatchingServer, EngineConfig, InferenceEngine
    from pcm_tpu_torch.train.bundles import adapter_like

    device = torch.device("cuda")
    sampler = DDIMSampler.create(make_ddpm_schedule(), 2)
    toks = {"input_ids": HashTokenizer()}
    adapter = adapter_like(template, gen)  # seeded, b != 0
    eng_s = InferenceEngine(bundle, sampler, frozen, adapter, toks,
                            EngineConfig(batch_size=4, guidance_scale=1.0), device)
    eng_t = InferenceEngine(bundle, sampler, frozen, None, toks,
                            EngineConfig(batch_size=4, guidance_scale=7.5), device)
    server = BatchingServer(eng_s, "127.0.0.1", 0, max_wait_ms=1000.0)
    server.start()
    url = "http://127.0.0.1:%d/generate" % server.address[1]
    full = [{"key": f"f{i}", "prompt": f"a photo of subject {i}", "seed": 100 + i} for i in range(4)]
    partial = [{"key": "p0", "prompt": full[2]["prompt"], "seed": full[2]["seed"]},
               {"key": "p1", "prompt": "a partial batch", "seed": 7}]
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        _concurrent(url, full, res)
        _concurrent(url, partial, res)
        s_wall = time.perf_counter() - t0
        s_lat = []  # steady state: full batches called directly after the HTTP phase
        for _ in range(2):
            t1 = time.perf_counter()
            eng_s.generate_batch([p["prompt"] for p in full], [p["seed"] for p in full])
            s_lat.append((time.perf_counter() - t1) * 1000)
        after_s = launch_counts()
        t_lat = []
        for _ in range(3):
            t1 = time.perf_counter()
            imgs_t = eng_t.generate_batch([f"teacher prompt {j}" for j in range(4)],
                                          [200 + j for j in range(4)])
            t_lat.append((time.perf_counter() - t1) * 1000)
        counts = launch_counts()
        stats = server.stats()
    finally:
        server.stop()
    peak = torch.cuda.max_memory_allocated()

    sizes = {k: r["batch_size"] for k, r in res.items()}
    if sizes != {"f0": 4, "f1": 4, "f2": 4, "f3": 4, "p0": 2, "p1": 2}:
        raise AssertionError(f"unexpected batching {sizes}")
    pngs = {k: base64.b64decode(r["image_b64"]) for k, r in res.items()}
    for k, png in pngs.items():  # 512 x 512, 8-bit RGB
        if _png_header(png) != (512, 512, 8, 2):
            raise AssertionError(f"image {k}: PNG header {_png_header(png)}")
    if imgs_t.shape != (4, 512, 512, 3) or imgs_t.dtype.name != "uint8":
        raise AssertionError(f"teacher images {imgs_t.shape} {imgs_t.dtype}")
    same_seed = pngs["f2"] == pngs["p0"]
    if not same_seed:
        raise AssertionError("same prompt and seed gave different images in a full and a partial batch")
    if pngs["f0"] == pngs["f1"]:
        raise AssertionError("different seeds gave the same image")
    delta_t = {k: counts[k] - after_s[k] for k in counts}
    for name in ("flash_attention_fwd", "group_norm_silu"):
        if after_s[name] == 0 or delta_t[name] == 0:
            raise AssertionError(f"{name} was not launched on the served path")
    if after_s["geglu"] != 0 or delta_t["geglu"] == 0:
        raise AssertionError(f"geglu launches: student {after_s['geglu']}, teacher {delta_t['geglu']}")
    return {"counts": counts, "student_counts": after_s, "teacher_counts": delta_t,
            "student_latency_ms": {k: r["latency_ms"] for k, r in res.items()},
            "student_wall_s": s_wall, "student_batch_ms": s_lat, "teacher_batch_ms": t_lat,
            "server_stats": stats,
            "peak_bytes": peak, "same_seed_identical": same_seed}


# ---------------------------------------------------------------------------
# phase 6: full-width student gradients, kernels against plain versions
# ---------------------------------------------------------------------------


# the backward kernels, each swapped alone to its plain version in phase 6
BWD_SWAPS = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def unet_grad_vs_reference(bundle, frozen, template, gen) -> dict:
    """The LoRA gradients of one SD1.5 student forward + backward at batch 2
    (`lora_grad_readings`)."""
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    cond = {"prompt_embeds": bf16_randn((2, 77, 768), gen)}
    return lora_grad_readings(bundle, frozen, template, gen, x, cond)


def lora_grad_readings(bundle, frozen, template, gen, x, cond) -> dict:
    """The LoRA gradients of one student forward + backward at latents ``x``
    (timesteps 999 and 421) with every kernel, against every plain version
    (``all``) and against K2 alone and K3 alone plain: (cosine, relative
    norm error) each."""
    from pcm_tpu_torch.ops import reference_ops
    from pcm_tpu_torch.train.bundles import adapter_like

    adapter = adapter_like(template, gen)  # b != 0: every factor gets a gradient
    t = torch.tensor([999, 421], device="cuda")

    def lora_grads():
        lora = {k: v.clone().requires_grad_(True) for k, v in adapter.items()}
        loss = bundle.student(frozen, lora, x, t, cond).float().square().mean()
        return torch.autograd.grad(loss, list(lora.values()))

    def compare(ref):
        flat_ref = torch.cat([g.flatten() for g in ref])
        return (float(torch.nn.functional.cosine_similarity(flat, flat_ref, dim=0)),
                float((flat.norm() - flat_ref.norm()).abs() / flat_ref.norm()))

    got = lora_grads()
    bad = [k for k, g in zip(adapter, got) if g is None or not torch.isfinite(g).all()]
    flat = torch.cat([g.flatten() for g in got])
    readings = {}
    for label, names in (("all", ()), *((n, (n,)) for n in BWD_SWAPS)):
        with reference_ops(*names):
            readings[label] = compare(lora_grads())
    return {"factors": len(adapter), "bad": bad, "readings": readings}


# ---------------------------------------------------------------------------
# phase 7: the training entry point
# ---------------------------------------------------------------------------

CACHE_SAMPLES = 24  # enough for the recipe's batch of 20 as well


def write_cache(bundle, frozen, out_dir: str, seed: int) -> str:
    """One shard of seeded 64x64x4 latents and prompt embeds of the port's
    CLIP-L on hash-tokenized prompts, in the cache format (fp16)."""
    import numpy as np

    from pcm_tpu_torch.data.tokenizer import HashTokenizer

    os.makedirs(out_dir, exist_ok=True)
    prompts = [f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light"
               for i in range(CACHE_SAMPLES)]
    ids = torch.from_numpy(HashTokenizer()(prompts)).long().cuda()
    with torch.no_grad():
        embeds = bundle.encode_prompts(frozen, ids)["prompt_embeds"]
    latents = np.random.default_rng(seed).standard_normal((CACHE_SAMPLES, 64, 64, 4))
    np.savez(os.path.join(out_dir, "shard_00000.npz"), latents=latents.astype(np.float16),
             prompt_embeds=embeds.float().cpu().numpy().astype(np.float16))
    return out_dir


def train_slice(cache_dir: str, out_dir: str, seed: int, extra=(), resume: bool = True) -> dict:
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.train.__main__ import main as train_main

    argv = ["--recipe", "sd15_4phase", "--cached-latents-dir", cache_dir, "--output-dir", out_dir,
            "--batch-size", "4", "--seed", str(seed), "--log-every", "1",
            "--checkpointing-steps", "3", *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer = train_main(argv + ["--max-train-steps", "3", "--no-resume"])
    counts = launch_counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    lora_b = max(float(v.abs().max()) for k, v in trainer.state.params.items()
                 if k.endswith("lora_b"))
    out = {"counts": counts, "rows": rows, "lora_b_max": lora_b, "trainer": trainer}
    if resume:
        resumed = train_main(argv + ["--max-train-steps", "4"])
        out.update(resumed_from=resumed.resumed_from, resumed_step=resumed.global_step)
    return out


def check_train(tag: str, tr: dict, kernels) -> None:
    steps = [r for r in tr["rows"] if r["step"] <= 3]
    log(tag, losses=json.dumps([round(r["loss"], 6) for r in steps]),
        grad_norms=json.dumps([round(r["grad_norm"], 6) for r in steps]),
        step_ms=json.dumps([round(r["step_ms"], 1) for r in steps]),
        peak_gib=f"{max(r['peak_gib'] for r in steps):.3f}", lora_b_max=f"{tr['lora_b_max']:.3e}",
        counts=json.dumps(tr["counts"]))
    if not (len(steps) == 3 and all(math.isfinite(r["loss"]) for r in steps)
            and tr["lora_b_max"] > 0):
        raise AssertionError(f"{tag}: {steps}, lora_b max {tr['lora_b_max']}")
    missing = [k for k in kernels if tr["counts"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {tag} path: {missing}")


# ---------------------------------------------------------------------------
# phase ddp: data parallelism
# ---------------------------------------------------------------------------

DDP_STEPS = 3
DDP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
               "group_norm_silu", "geglu")


def _index_stream(n: int, batch: int, seed: int, steps: int) -> list:
    """The cached loader's first ``steps`` batches of indices over ``n``
    samples (`data/cached.py:batches`)."""
    from pcm_tpu_torch.data.cached import batches

    class Indices:
        def __len__(self):
            return n

        def get(self, j):
            import numpy as np

            return {"i": np.array(j)}

    it = batches(Indices(), batch, seed)
    return [next(it)["i"] for _ in range(steps)]


def write_ddp_caches(cache_dir: str, out_dir: str, seed: int, world: int = 2,
                     per_rank: int = 2) -> tuple:
    """Phase 7's shard split into ``world`` shards under ``<out>/ranks``
    (rank r reads shard r) and one shard under ``<out>/one`` whose first
    `DDP_STEPS` batches of ``world x per_rank`` are the ``world``-rank run's
    global batches, rank 0's rows first."""
    import numpy as np

    with np.load(os.path.join(cache_dir, "shard_00000.npz")) as z:
        data = {k: z[k] for k in z.files}
    n = len(data["latents"]) // world
    shards = [{k: v[r * n:(r + 1) * n] for k, v in data.items()} for r in range(world)]
    ranks, one = os.path.join(out_dir, "ranks"), os.path.join(out_dir, "one")
    for d in (ranks, one):
        os.makedirs(d, exist_ok=True)
    for r, shard in enumerate(shards):
        np.savez(os.path.join(ranks, f"shard_{r:05d}.npz"), **shard)
    rank_idx = [_index_stream(n, per_rank, seed, DDP_STEPS) for _ in range(world)]
    seq = [(r, i) for s in range(DDP_STEPS) for r in range(world) for i in rank_idx[r][s]]
    order = np.concatenate(_index_stream(len(seq), per_rank * world, seed, DDP_STEPS))
    rows = {k: np.empty((len(seq), *v.shape[1:]), v.dtype) for k, v in data.items()}
    for pos, (r, i) in zip(order, seq):
        for k in rows:
            rows[k][pos] = shards[r][k][i]
    np.savez(os.path.join(one, "shard_00000.npz"), **rows)
    return ranks, one


def _ddp_run(out_dir: str, cache: str, batch: int, seed: int, ranks: int = 0,
             accum: int = 1):
    """``python -m pcm_tpu_torch.train --recipe sd15_4phase`` as a child
    process (under ``python -m torch.distributed.run`` with ``ranks``),
    `DDP_STEPS` steps, a checkpoint at the last; returns the process and its
    log file."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    launcher = (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks)]
                if ranks else [])
    argv = [sys.executable, "-u", *launcher, "-m", "pcm_tpu_torch.train", "--recipe",
            "sd15_4phase", "--cached-latents-dir", cache, "--output-dir", out_dir,
            "--batch-size", str(batch), "--gradient-accumulation-steps", str(accum), "--seed",
            str(seed), "--log-every", "1", "--max-train-steps", str(DDP_STEPS),
            "--checkpointing-steps", str(DDP_STEPS), "--no-resume"]
    log_file = open(os.path.join(out_dir, "stdout.log"), "w")
    return _popen(argv, stdout=log_file, stderr=subprocess.STDOUT, text=True,
                  cwd=os.path.dirname(os.path.abspath(__file__))), log_file


def _ddp_result(out_dir: str) -> dict:
    """A finished run's losses, saved LoRA, launches and printed lines."""
    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = f.read().splitlines()
    rows = [r for r in _rows_of(out_dir) if "loss" in r]
    with open(os.path.join(out_dir, "launches.jsonl")) as f:
        counts = json.loads(f.read().splitlines()[-1])["launches"]
    ck = torch.load(os.path.join(out_dir, "checkpoints", f"step_{DDP_STEPS:07d}.pt"),
                    map_location="cpu", weights_only=True)
    return {"losses": [r["loss"] for r in rows], "step_ms": [r["step_ms"] for r in rows],
            "peak_gib": max(r["peak_gib"] for r in rows), "lora": ck["lora"], "counts": counts,
            "banner": next((ln for ln in lines if ln.startswith("# sd15_4phase")), "")}


def _ddp_diff(run: dict, ref: dict) -> tuple:
    """(the losses' largest relative difference, the LoRA's rel-max: its
    largest difference over its largest entry)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    top = max(float(v.abs().max()) for v in ref["lora"].values())
    lora = max(float((run["lora"][k] - v).abs().max()) for k, v in ref["lora"].items()) / top
    return loss, lora


# run -> (cache: "one" or "ranks", batch a rank, ranks under the launcher, accumulation)
DDP_SPECS = {"plain": ("one", 4, 0, 1), "nccl1": ("one", 4, 1, 1),
             "gloo2": ("ranks", 2, 2, 1), "accum2": ("one", 2, 0, 2)}


def ddp_runs(cache_dir: str, seed: int) -> dict:
    """Phase ddp (a) and (b)'s four child runs at once (the card holds
    them), each of which must exit 0; a lane run (host work only)."""
    root = "build/chip_smoke/ddp"
    caches = dict(zip(("ranks", "one"), write_ddp_caches(cache_dir, root, seed)))
    t0 = time.perf_counter()
    procs = {tag: _ddp_run(os.path.join(root, tag), caches[cache], batch, seed, ranks, accum)
             for tag, (cache, batch, ranks, accum) in DDP_SPECS.items()}
    rcs = {}
    for tag, (proc, log_file) in procs.items():
        try:
            rcs[tag] = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    if any(rcs.values()):
        tails = {tag: open(os.path.join(root, tag, "stdout.log")).read()[-2000:]
                 for tag, rc in rcs.items() if rc}
        raise AssertionError(f"ddp runs failed: {rcs} {tails}")
    return {"root": root, "wall": time.perf_counter() - t0}


def ddp_phase(started: dict) -> list:
    """Phase ddp (a) and (b)'s checks on the runs of `ddp_runs`; (c) is
    `ddp_cards`. Returns the runs with their launches."""
    runs = {tag: _ddp_result(os.path.join(started["root"], tag)) for tag in DDP_SPECS}
    for tag in DDP_SPECS:
        _drop_checkpoints(os.path.join(started["root"], tag))
    wall = started["wall"]
    plain, nccl1, gloo2, accum2 = (runs[k] for k in DDP_SPECS)
    identical = (nccl1["losses"] == plain["losses"]
                 and all(torch.equal(nccl1["lora"][k], v) for k, v in plain["lora"].items()))
    yard = _ddp_diff(accum2, plain)
    got = _ddp_diff(gloo2, plain)
    caps = [max(2e-2, 2 * y) for y in yard]
    log("ddp", runs_wall_s=f"{wall:.1f}", nccl1_identical=identical,
        nccl1_banner=repr(nccl1["banner"]), gloo2_banner=repr(gloo2["banner"]),
        losses=json.dumps({k: [round(x, 6) for x in r["losses"]] for k, r in runs.items()}),
        gloo2_vs_plain="%.3e/%.3e" % got, yardstick="%.3e/%.3e" % yard,
        bounds="%.3e/%.3e" % tuple(caps),
        step_ms=json.dumps({k: [round(x, 1) for x in r["step_ms"]] for k, r in runs.items()}),
        peak_gib=json.dumps({k: round(r["peak_gib"], 3) for k, r in runs.items()}),
        nccl1_counts=json.dumps(nccl1["counts"]))
    missing = [k for k in DDP_KERNELS if nccl1["counts"][k] == 0]
    if not (identical and "rank 0 of 1 (nccl)" in nccl1["banner"]
            and "rank 0 of 2 (gloo), global batch 4" in gloo2["banner"] and not missing
            and all(math.isfinite(x) for r in runs.values() for x in r["losses"])
            and all(g <= c for g, c in zip(got, caps))):
        raise AssertionError(f"data parallelism: one NCCL rank identical {identical}, two gloo "
                             f"ranks {got} against bounds {caps}, kernels not launched "
                             f"{missing}, banners {nccl1['banner']!r} {gloo2['banner']!r}")
    for r in runs.values():
        del r["lora"]
    return list(runs.values())


def ddp_cards(seed: int) -> list:
    """Phase ddp (c): with N > 1 cards, ``scripts/bench_ddp_torch.py``'s SDXL
    step on N NCCL ranks and on one, and its serving engine with
    ``--data-parallel N`` against one card; with one card, ``cards=1``."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log("ddp-cards", cards=cards)
        return []
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "bench_ddp_torch.py")

    def run(*argv):
        out = subprocess.run([sys.executable, *argv], capture_output=True, text=True, cwd=here,
                             timeout=1200)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            raise AssertionError(f"{argv}: rc {out.returncode}\n{out.stderr[-3000:]}")
        return json.loads(lines[-1])

    gc.collect()
    torch.cuda.empty_cache()
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node"]
    one = run(*launcher, "1", script, "step", "--seed", str(seed))
    many = run(*launcher, str(cards), script, "step", "--seed", str(seed))
    serve = run(script, "serve", "--cards", str(cards), "--seed", str(seed))
    log("ddp-cards", cards=cards, backend=many["backend"], batch_per_card=many["batch_per_card"],
        one_card_step_ms=f"{one['ranks'][0]['median_ms']:.1f}",
        step_ms_per_rank=json.dumps([round(r["median_ms"], 1) for r in many["ranks"]]),
        step_ms_all=json.dumps([[round(x, 1) for x in r["step_ms"]] for r in many["ranks"]]),
        one_card_step_ms_all=json.dumps([round(x, 1) for x in one["ranks"][0]["step_ms"]]),
        allreduce_bytes=many["allreduce_bytes"],
        allreduce_mean_ms=f"{many['allreduce_mean_ms']:.3f}",
        allreduce_bare_ms=f"{many['allreduce_bare_ms']:.3f}",
        one_card_allreduce_mean_ms=f"{one['allreduce_mean_ms']:.3f}",
        peak_gib=json.dumps([round(r["peak_gib"], 3) for r in many["ranks"]]),
        one_card_peak_gib=f"{one['ranks'][0]['peak_gib']:.3f}",
        serve_one_card_ms=json.dumps([round(x, 1) for x in serve["dp1"]["batch_ms"]]),
        serve_dp_ms=json.dumps([round(x, 1) for x in serve[f"dp{cards}"]["batch_ms"]]),
        serve_dp_batch=serve[f"dp{cards}"]["batch"],
        serve_dp_same_as_one_card=serve[f"dp{cards}"]["same_as_one_card"])
    losses = [x for r in many["ranks"] + one["ranks"] for x in r["losses"]]
    if not (all(math.isfinite(x) for x in losses) and many["backend"] == "nccl"
            and len(set(json.dumps(r["losses"]) for r in many["ranks"])) == 1
            and serve[f"dp{cards}"]["same_as_one_card"]):
        raise AssertionError(f"{cards}-card SDXL step: {many}; serving: {serve}")
    return [{"counts": many["launches"]}, {"counts": serve[f"dp{cards}"]["launches"]}]


# ---------------------------------------------------------------------------
# phase fsdp: the frozen weights sharded over ranks
# ---------------------------------------------------------------------------

FSDP_SD15_JOBS = ("ddim", "adv_g_d", "adv_fused", "ddim_int8")
FSDP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                "group_norm_silu", "geglu", "int8_matmul")
# SD3's depth in (b) on one card (joint blocks, T5 layers; published 24 and 24):
# two gloo ranks move the gathers through host memory at ~0.6 GB/s, 55 s a
# full-depth step; (c) runs the published depth on four cards
FSDP_SD3_DEPTH = (2, 2)
FSDP_AT_REST = 0.51  # of the unsharded frozen bytes a rank may hold at fsdp 2


def _fsdp_start(tag: str, family: str, ranks: int, n_fsdp: int, seed: int, *extra: str) -> dict:
    """``scripts/bench_fsdp_torch.py`` started as a child process: one
    process with no process group (``ranks`` 0) or ``ranks`` under ``python
    -m torch.distributed.run``; `_fsdp_wait` collects it."""
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke", "fsdp", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    launcher = (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks)]
                if ranks else [])
    argv = [sys.executable, "-u", *launcher, os.path.join(here, "scripts", "bench_fsdp_torch.py"),
            "--family", family, "--fsdp", str(n_fsdp), "--out", out_dir, "--seed", str(seed),
            *extra]
    log_file = open(os.path.join(out_dir, "stdout.log"), "w")
    return {"tag": tag, "ranks": max(ranks, 1), "out": out_dir, "t0": time.perf_counter(),
            "log": log_file, "proc": _popen(argv, stdout=log_file, stderr=subprocess.STDOUT,
                                            cwd=here)}


def _fsdp_results(out_dir: str, ranks: int, t0: float) -> list:
    runs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(ranks)]
    runs[0]["wall_s"] = time.perf_counter() - t0
    return runs


def _fsdp_wait(run: dict, timeout: float = 900) -> list:
    """Each rank's results of a `_fsdp_start` run (it must exit 0)."""
    try:
        rc = run["proc"].wait(timeout=timeout)
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()
        run["log"].close()
    if rc:
        with open(os.path.join(run["out"], "stdout.log")) as f:
            raise AssertionError(f"fsdp run {run['tag']}: rc {rc}\n{f.read()[-5000:]}")
    return _fsdp_results(run["out"], run["ranks"], run["t0"])


def _fsdp_run(tag: str, family: str, ranks: int, n_fsdp: int, seed: int, *extra: str) -> list:
    return _fsdp_wait(_fsdp_start(tag, family, ranks, n_fsdp, seed, *extra))


def _fsdp_same(a: dict, b: dict) -> bool:
    """Losses equal bit for bit, and the new LoRA's and heads' digests."""
    return (a["metrics"].keys() == b["metrics"].keys()
            and all(torch.equal(a["metrics"][k], v) for k, v in b["metrics"].items())
            and a["params"] == b["params"] and a["d_params"] == b["d_params"])


def _fsdp_readings(runs: list, jobs) -> dict:
    """Per rank: at-rest GiB (held / unsharded), and per job of ``jobs`` the
    step ms, peak GiB, gathers, gathered GiB, most gathered GiB alive and
    TMA maps encoded, each a list over the runs of the job."""
    gib = 2 ** 30
    out = {}
    for run in runs:
        r = f"r{run['layout'][2]}{run['layout'][3]}"
        out[r] = {"at_rest_gib": {k: [round(h / gib, 3), round(t / gib, 3)]
                                  for k, (h, t) in run["held_bytes"].items()}}
        for job in jobs:
            rec = run["jobs"][job]
            out[r][job] = {"ms": [round(x, 1) for x in rec["ms"]],
                           "peak_gib": [round(x / gib, 3) for x in rec["peak_bytes"]],
                           "gathers": rec["gathers"],
                           "gathered_gib": [round(x / gib, 3) for x in rec["gathered_bytes"]],
                           "gathered_peak_gib": [round(x / gib, 3)
                                                 for x in rec["peak_gathered_bytes"]],
                           "tma_encodes": rec["tma_encodes"]}
    return out


def _fsdp_check(what: str, runs: list, refs: list, backend: str, sharded: bool) -> None:
    """Each rank of ``runs`` equals, bit for bit and job by job, the ``refs``
    rank of its data index; it ran on ``backend``; sharded, it holds at
    most `FSDP_AT_REST` of the frozen bytes and gathered."""
    bad = []
    for run in runs:
        ref = refs[run["layout"][2] if len(refs) > 1 else 0]
        for job, rec in run["jobs"].items():
            finite = all(math.isfinite(x) for x in rec["losses"].values())
            if not (finite and _fsdp_same(rec, ref["jobs"][job])):
                bad.append((run["layout"], job, rec["losses"], ref["jobs"][job]["losses"]))
            if sharded and not min(rec["gathers"]) > 0:
                bad.append((run["layout"], job, "no gathers"))
        if run["backend"] != backend:
            bad.append((run["layout"], run["backend"]))
        if sharded and not all(h <= FSDP_AT_REST * t for h, t in run["held_bytes"].values()):
            bad.append((run["layout"], run["held_bytes"]))
    if bad:
        raise AssertionError(f"{what}: {bad}")


def _fsdp_log(tag: str, runs: list, refs: list, **kw) -> None:
    for family, jobs in (("sd15", FSDP_SD15_JOBS), ("sd3", ("flow",))):
        log(tag, family=family, **kw, wall_s=f"{refs[0]['wall_s']:.1f}/{runs[0]['wall_s']:.1f}",
            losses=json.dumps({j: runs[0]["jobs"][j]["losses"] for j in jobs}),
            reference=json.dumps(_fsdp_readings(refs, jobs)),
            ranks=json.dumps(_fsdp_readings(runs, jobs)))


def fsdp_runs(cache_dir: str, seed: int) -> tuple:
    """Phase fsdp (a) and (b)'s runs (each both families): one process with
    no process group first, then two gloo ranks sharing the card at ``data
    1 x fsdp 2``, each a child process that must exit 0; a lane run (host
    work only)."""
    extra = ("--cache", cache_dir, "--repeats", "1", "--mmdit-layers", str(FSDP_SD3_DEPTH[0]),
             "--t5-layers", str(FSDP_SD3_DEPTH[1]))
    one = _fsdp_run("one", "sd15,sd3", 0, 1, seed, *extra)
    return one, _fsdp_run("d1f2", "sd15,sd3", 2, 2, seed, *extra)


def fsdp_phase(started: tuple) -> list:
    """Phase fsdp (a) and (b)'s checks on the runs of `fsdp_runs`; (c) is
    `fsdp_cards`. Returns the runs with their launches."""
    one, two = started
    _fsdp_log("fsdp", two, one, layout="data1xfsdp2", backend=two[0]["backend"],
              sd3_depth=repr(FSDP_SD3_DEPTH), gloo_cuda_gather=repr(two[0]["gloo_cuda_gather"]))
    _fsdp_check("fsdp (a), (b): two gloo ranks at data 1 x fsdp 2 against one process", two, one,
                "gloo", True)
    missing = [k for k in FSDP_KERNELS if two[0]["launches"][k] == 0]
    if missing:
        raise AssertionError(f"fsdp (a), (b): kernels not launched: {missing}")
    return [{"counts": one[0]["launches"]}, {"counts": two[0]["launches"]}]


def fsdp_cards(seed: int) -> list:
    """Phase fsdp (c): with four cards or more, SD1.5 (a seeded cached
    batch) and SD3 at published depth on four NCCL ranks at ``data 2 x fsdp
    2`` against two at ``data 2 x fsdp 1`` (data parallelism alone), bit for
    bit; with fewer, ``cards=N``."""
    cards = torch.cuda.device_count()
    if cards < 4:
        log("fsdp-cards", cards=cards)
        return []
    gc.collect()
    torch.cuda.empty_cache()
    ddp = _fsdp_run("d2f1", "sd15,sd3", 2, 1, seed)
    both = _fsdp_run("d2f2", "sd15,sd3", 4, 2, seed)
    _fsdp_log("fsdp-cards", both, ddp, cards=cards, layout="data2xfsdp2", against="data2xfsdp1",
              backend=both[0]["backend"])
    _fsdp_check("fsdp (c): data 2 x fsdp 2 against data 2 x fsdp 1", both, ddp, "nccl", True)
    _fsdp_check("fsdp (c): the data 2 x fsdp 1 ranks", ddp, ddp[:1] * 2, "nccl", False)
    return [{"counts": ddp[0]["launches"]}, {"counts": both[0]["launches"]}]


# ---------------------------------------------------------------------------
# phases 9 and 10: SDXL-1024 on int8 frozen weights
# ---------------------------------------------------------------------------

def sdxl_batch(n: int, gen) -> dict:
    """A cached SDXL batch drawn on the card: 128x128x4 latents, (77, 2048)
    prompt embeds, 1280 pooled embeds, 1024-px time_ids."""
    from pcm_tpu_torch.configs.families import SDXL_CACHED_STEP

    return {"latents": torch.randn((n, 128, 128, 4), generator=gen, device="cuda"),
            "prompt_embeds": bf16_randn((n, 77, 2048), gen),
            "pooled_embeds": bf16_randn((n, 1280), gen),
            "time_ids": torch.tensor([SDXL_CACHED_STEP.time_ids] * n, device="cuda")}


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).norm() / ref.norm().clamp_min(1e-12))


# the kernels of the SDXL teacher forward besides K6, each swapped alone
SDXL_SWAPS = ("flash_attention_fwd", "group_norm_silu", "geglu")


def sdxl_unet_vs_reference(bundle, frozen, gen, int8: bool) -> dict:
    """One full-width SDXL teacher forward at batch 2 with every kernel
    (under ``fused`` when ``int8``), against: every plain version (``all``);
    each of K1, K4, K5 plain alone, the other kernels launched; and, as the
    yardstick of bf16 round-off, the all-plain forward on latents scaled by
    1 + 2**-8 (half a bf16 step) against the all-plain forward (``noise``).
    Each reading is (max |diff| / max |ref|, ||diff|| / ||ref||). On int8
    weights also whether the output with K6's plain version alone is equal
    bit for bit."""
    from pcm_tpu_torch.ops import reference_ops
    from pcm_tpu_torch.utils.quant import int8_matmul

    batch = sdxl_batch(2, gen)
    _, cond, _ = bundle.encode(frozen, batch)
    x, t = batch["latents"], torch.tensor([999, 421], device="cuda")

    def run(lat):
        return bundle.teacher(frozen, lat, t, cond)

    res = {}
    with torch.inference_mode(), int8_matmul("fused") if int8 else contextlib.nullcontext():
        out = run(x)
        with reference_ops():
            ref = run(x)
            nudged = run(x * (1 + 2 ** -8))
        res["all"] = (rel_max(out, ref), rel_l2(out, ref))
        res["noise"] = (rel_max(nudged, ref), rel_l2(nudged, ref))
        for name in SDXL_SWAPS:
            with reference_ops(name):
                one = run(x)
            res[name] = (rel_max(out, one), rel_l2(out, one))
        if int8:
            with reference_ops("int8_matmul"):
                res["k6_plain_identical"] = torch.equal(out, run(x))
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite SDXL UNet output")
    return res


def check_sdxl_unet(weights: str, r: dict) -> None:
    """Each kernel-against-plain reading (``all`` and every swap), max-wise
    and norm-wise, within 2e-2 or twice the yardstick's, whichever is
    larger (the random-weight SDXL UNet moves ~2e-2 on a half-step nudge of
    its input); on bf16 weights also ``all`` within 5e-2 max-wise."""
    readings = {k: r[k] for k in ("all", "noise", *SDXL_SWAPS)}
    log("sdxl-unet", weights=weights, **{k: "%.3e/%.3e" % v for k, v in readings.items()},
        **({"k6_plain_bit_identical": r["k6_plain_identical"]} if "k6_plain_identical" in r else {}),
        bounds="max(2e-2,2*noise)")
    caps = [max(2e-2, 2 * n) for n in r["noise"]]
    bad = {k: v for k, v in readings.items()
           if k != "noise" and not all(e <= c for e, c in zip(v, caps))}
    if weights == "bf16" and not r["all"][0] <= 5e-2:
        bad["all"] = r["all"]
    if bad or r.get("k6_plain_identical") is False:
        raise AssertionError(f"full-width SDXL UNet, {weights} weights, kernels vs plain: {r}")


def sdxl_step(bundle, frozen, template, gen, batch_size: int = 4, steps: int = 3) -> dict:
    from pcm_tpu_torch.configs.families import SDXL_CACHED_STEP
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.train.distill import build_ddim_distill_step, sample_draws
    from pcm_tpu_torch.train.state import TrainState, make_optimizer
    from pcm_tpu_torch.utils.quant import int8_matmul

    cfg = SDXL_CACHED_STEP.distill
    tx = make_optimizer(SDXL_CACHED_STEP.lr)
    step = build_ddim_distill_step(bundle, make_ddpm_schedule(), cfg, tx)
    state = TrainState.create(template, tx)
    batch = sdxl_batch(batch_size, gen)
    losses, norms, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with int8_matmul("fused"):
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, frozen, batch, [sample_draws(cfg, gen, batch["latents"])])
            losses.append(float(metrics["loss"]))  # a readback: the step has run
            times.append((time.perf_counter() - t0) * 1000)
            norms.append(float(metrics["grad_norm"]))
    counts = launch_counts()
    lora_b = max(float(v.abs().max()) for k, v in state.params.items() if k.endswith("lora_b"))
    return {"losses": losses, "grad_norms": norms, "step_ms": times, "counts": counts,
            "peak_bytes": torch.cuda.max_memory_allocated(), "lora_b_max": lora_b}


# ---------------------------------------------------------------------------
# phase remat: the remat policies and granularities on one batch
# ---------------------------------------------------------------------------

# ``<full | policy>/<granularity>`` or ``none``; the first is the reference,
# whose two runs give the card's run-to-run spread; SD3's MMDiT has no granularity
REMAT_SDXL = ("full/block", "full/module", "dots8m/block", "dots/block", "dots8m+fa/block",
              "nothing+fa/block", "none")
REMAT_SD3 = ("full", "dots8m+fa")


def set_remat(module, setting: str) -> None:
    """Put a UNet or MMDiT under ``setting`` (see `REMAT_SDXL`)."""
    name, _, gran = setting.partition("/")
    module.remat = name != "none"
    module.remat_policy = None if name in ("full", "none") else name
    if gran:
        module.remat_granularity = gran


def _max_diffs(got: dict, ref: dict) -> dict:
    return {k: float((got[k].float() - v.float()).abs().max()) for k, v in ref.items()}


def remat_runs(bundle, frozen, template, gen, settings, runs: int = 2) -> dict:
    """Phase remat: the SDXL-1024 cached step (`SDXL_CACHED_STEP`, batch 4)
    or SD3's (`SD3_CACHED_STEP`, batch 2) on one batch, one set of draws and
    one state (the LoRA's factors moved off zero, so that every factor has a
    gradient) under each setting, ``runs`` times each: the step ms, peak and
    K1 forward launches of the last run, and the largest difference of the
    loss and of each LoRA gradient (caught on its way to the optimizer) from
    the first setting's first run. The module's settings are put back."""
    from pcm_tpu_torch.configs.families import SD3_CACHED_STEP, SDXL_CACHED_STEP
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.train import distill
    from pcm_tpu_torch.train.state import TrainState, make_optimizer

    sd3 = "mmdit" in frozen
    module = frozen["mmdit" if sd3 else "unet"]
    kept = {k: getattr(module, k) for k in ("remat", "remat_policy", "remat_granularity")
            if hasattr(module, k)}
    recipe = SD3_CACHED_STEP if sd3 else SDXL_CACHED_STEP
    cfg, tx = recipe.distill, make_optimizer(recipe.lr)
    step = (distill.build_flow_distill_step(bundle, make_flow_schedule(), cfg, tx) if sd3
            else distill.build_ddim_distill_step(bundle, make_ddpm_schedule(), cfg, tx))
    batch = sd3_batch(2, gen) if sd3 else sdxl_batch(4, gen)
    draws = [distill.sample_draws(cfg, gen, batch["latents"])]
    state = TrainState.create({k: v + 0.01 for k, v in template.items()}, tx)
    caught, counts, rows, ref = [], {}, [], None
    real = distill.apply_updates
    distill.apply_updates = lambda s, g, t: caught.append(g) or real(s, g, t)
    try:
        for setting in settings:
            set_remat(module, setting)
            for _ in range(runs):
                caught.clear()
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                _, metrics = step(state, frozen, batch, draws)
                got = {"loss": metrics["loss"].detach().clone(), **caught[0]}
                float(got["loss"])  # a readback: the step has run
                ms = (time.perf_counter() - t0) * 1000
                launched = launch_counts()
                for k, v in launched.items():
                    counts[k] = counts.get(k, 0) + v
                if ref is None:
                    ref = got
                rows.append({"setting": setting, "step_ms": ms,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                             "k1": launched["flash_attention_fwd"],
                             "diff": _max_diffs(got, ref),
                             "finite": bool(torch.isfinite(got["loss"]))})
    finally:
        distill.apply_updates = real
        for k, v in kept.items():
            setattr(module, k, v)
    return {"rows": rows, "counts": counts, "factors": len(template)}


def attentions(module) -> int:
    """K1 launches of one forward: a UNet's Attention modules, an MMDiT's
    joint blocks."""
    return sum(type(m).__name__ in ("Attention", "JointTransformerBlock") for m in module.modules())


def remat_check(family: str, r: dict, n_attn: int) -> None:
    """Log each setting's last run; every reading must equal the reference's
    bit for bit, or, where the reference's two runs differ on the card,
    stay within twice their difference; under ``+fa`` a step launches K1
    ``n_attn`` times fewer (the student's attentions, all in regions)
    than under ``full``, and as often as without remat."""
    rows = r["rows"]
    spread = rows[1]["diff"]  # the reference's second run against its first
    last = {row["setting"]: row for row in rows}
    for setting, row in last.items():
        log("remat", family=family, setting=setting, step_ms=f"{row['step_ms']:.1f}",
            peak_gib=f"{row['peak_gib']:.3f}", k1_launches=row["k1"],
            max_diff=f"{max(row['diff'].values()):.3e}",
            nonzero_spread=sum(v > 0 for v in spread.values()))
    bad = [(row["setting"], k) for row in rows for k, d in row["diff"].items()
           if not (row["finite"] and d <= 2 * spread[k])]
    full = last[rows[0]["setting"]]["k1"]
    fa = {s: row["k1"] for s, row in last.items() if "+fa" in s}
    none = last.get("none", {"k1": full - n_attn})["k1"]
    if bad or not fa or any(k != full - n_attn or k != none for k in fa.values()):
        raise AssertionError(f"remat {family}: readings beyond the reference's spread {bad[:8]}, "
                             f"K1 launches {fa} against full {full} - {n_attn}, none {none}")


# ---------------------------------------------------------------------------
# phases 9a and 11: adversarial distillation
# ---------------------------------------------------------------------------

# the kernels (launch counters) every adversarial path must launch
ADV_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
               "group_norm_silu", "geglu", "group_norm_silu_fp32")
# SD3's: the MMDiT has no GroupNorm and no GEGLU (bf16 K4 runs in its VAE, from pixels)
SD3_ADV_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                   "group_norm_silu_fp32")


@contextlib.contextmanager
def geglu_backward_calls():
    """Counts the calls of K5's autograd backward (autograd of its plain
    version) within the context, in the returned one-element list."""
    from pcm_tpu_torch.ops.geglu import GEGLUFn

    calls, orig = [0], GEGLUFn.backward

    def counted(ctx, g):
        calls[0] += 1
        return orig(ctx, g)

    GEGLUFn.backward = staticmethod(counted)
    try:
        yield calls
    finally:
        GEGLUFn.backward = staticmethod(orig)


def adv_grad_vs_reference(bundle, frozen, gen) -> dict:
    """The G loss's gradients through the frozen SDXL teacher at full width,
    batch 2, 1024 px: the down and mid taps of a latent that requires grad,
    the SDXL heads (drawn from ``gen``), `hinge_g_loss`; the
    gradients to the latent and to the heads with every kernel against every
    plain version, (cosine, relative norm error) each, and the launches of
    the kernel run."""
    from pcm_tpu_torch.configs.families import disc_config
    from pcm_tpu_torch.core.losses import hinge_g_loss
    from pcm_tpu_torch.models.attention import FeedForward
    from pcm_tpu_torch.ops import launch_counts, reference_ops, reset_launch_counts
    from pcm_tpu_torch.train.adv import heads_precision, init_discriminator

    heads_precision()  # as the training CLI's steps set it (the only fp32 convs from here on)
    disc, heads = init_discriminator(disc_config("sdxl"), bundle.unet_cfg.tap_channels(), gen,
                                     torch.device("cuda"))
    batch = sdxl_batch(2, gen)
    _, cond, _ = bundle.encode(frozen, batch)
    t = torch.tensor([871, 512], device="cuda")

    def grads():
        x = batch["latents"].clone().requires_grad_(True)
        dp = {k: v.clone().requires_grad_(True) for k, v in heads.items()}
        feats = bundle.teacher_features(frozen, x, t, cond, stop_after_mid=disc.stop_after_mid)
        loss = hinge_g_loss(disc.logits(dp, feats))
        gx, *gd = torch.autograd.grad(loss, [x, *dp.values()])
        return gx.flatten(), torch.cat([g.flatten() for g in gd]), float(loss.detach())

    def compare(a, b):
        return (float(torch.nn.functional.cosine_similarity(a, b, dim=0)),
                float((a.norm() - b.norm()).abs() / b.norm()))

    unet = frozen["unet"]
    tapped_ff = sum(isinstance(m, FeedForward) for blk in (*unet.down_blocks, unet.mid_block)
                    for m in blk.modules())
    torch.cuda.synchronize()
    reset_launch_counts()
    with geglu_backward_calls() as calls:
        gx, gd, loss = grads()
        counts, backward_calls = launch_counts(), calls[0]
    with reference_ops():
        rx, rd, ref_loss = grads()
    finite = bool(torch.isfinite(gx).all() and torch.isfinite(gd).all())
    return {"latent": compare(gx, rx), "heads": compare(gd, rd), "loss": loss,
            "ref_loss": ref_loss, "finite": finite, "counts": counts,
            "geglu_backward_calls": backward_calls, "tapped_feedforwards": tapped_ff}


def write_sdxl_cache(out_dir: str, seed: int, n: int = 8) -> str:
    """One shard of seeded SDXL-1024 cached samples: 128x128x4 latents,
    (77, 2048) prompt embeds, 1280 pooled embeds (fp16), 1024-px time_ids."""
    import numpy as np

    from pcm_tpu_torch.configs.families import SDXL_CACHED_STEP

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.savez(os.path.join(out_dir, "shard_00000.npz"),
             latents=rng.standard_normal((n, 128, 128, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((n, 77, 2048)).astype(np.float16),
             pooled_embeds=rng.standard_normal((n, 1280)).astype(np.float16),
             time_ids=np.tile(np.array(SDXL_CACHED_STEP.time_ids, np.float32), (n, 1)))
    return out_dir


def train_adv(tag: str, recipe: str, cache_dir: str, out_dir: str, seed: int, batch: int,
              pairing: str, steps: int, resume_to: int = 0, extra=()) -> dict:
    """``main`` of the training CLI on an adversarial recipe for ``steps``
    global steps from scratch (then, with ``resume_to``, a resumed run to that
    step), ``extra`` flags added; checks finite losses, that the LoRA and the
    heads moved and that the adversarial kernels were all launched; returns
    the launch counts of the first run, its rows and, on a resume, what it
    restored. ``out_dir`` is emptied first."""
    from pcm_tpu_torch.configs.families import RECIPES, disc_config
    from pcm_tpu_torch.models.unet import SD15_CONFIG, SDXL_CONFIG
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.train.__main__ import main as train_main
    from pcm_tpu_torch.train.adv import init_discriminator

    argv = ["--recipe", recipe, "--cached-latents-dir", cache_dir, "--output-dir", out_dir,
            "--batch-size", str(batch), "--seed", str(seed), "--log-every", "1",
            "--checkpointing-steps", str(steps), "--adv-pairing", pairing, *extra]
    shutil.rmtree(out_dir, ignore_errors=True)  # a run from scratch: no rows or checkpoints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer = train_main(argv + ["--max-train-steps", str(steps), "--no-resume"])
    counts = launch_counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    lora_b = max(float(v.abs().max()) for k, v in trainer.state.params.items()
                 if k.endswith("lora_b"))
    family = RECIPES[recipe].family
    unet_cfg = SD15_CONFIG if family == "sd15" else SDXL_CONFIG
    _, init = init_discriminator(disc_config(family), unet_cfg.tap_channels(),
                                 torch.Generator("cuda").manual_seed(seed + 1),
                                 torch.device("cuda"))
    heads_moved = max(float((trainer.d_state.params[k] - v).abs().max()) for k, v in init.items())
    out = {"counts": counts, "rows": rows, "lora_b_max": lora_b, "heads_moved": heads_moved,
           "g_updates": trainer.state.step, "d_updates": trainer.d_state.step}
    del trainer, init
    losses = [r[k] for r in rows for k in ("loss", "d_loss") if k in r]
    log(tag, pairing=pairing, batch=batch, steps=[r["step"] for r in rows],
        losses=json.dumps([round(r["loss"], 6) if "loss" in r else None for r in rows]),
        d_losses=json.dumps([round(r["d_loss"], 6) if "d_loss" in r else None for r in rows]),
        step_ms=json.dumps([round(r["step_ms"], 1) for r in rows]),
        peak_gib=f"{max(r['peak_gib'] for r in rows):.3f}", lora_b_max=f"{lora_b:.3e}",
        heads_moved=f"{heads_moved:.3e}", updates=f"G{out['g_updates']}/D{out['d_updates']}",
        counts=json.dumps(counts))
    missing = [k for k in ADV_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {tag} path: {missing}")
    if not (rows and rows[-1]["step"] == steps and all(math.isfinite(x) for x in losses)
            and any("loss" in r for r in rows) and any("d_loss" in r for r in rows)
            and lora_b > 0 and heads_moved > 0):
        raise AssertionError(f"{tag}: rows {rows}, lora_b max {lora_b}, heads moved "
                             f"{heads_moved}")
    if resume_to:
        resumed = train_main(argv + ["--max-train-steps", str(resume_to)])
        out.update(resumed_from=resumed.resumed_from, resumed_step=resumed.global_step,
                   resumed_updates=(resumed.state.step, resumed.d_state.step))
        log(tag, resumed=f"{resumed.resumed_from}->{resumed.global_step}",
            updates=f"G{resumed.state.step}/D{resumed.d_state.step}")
        del resumed
    return out


# ---------------------------------------------------------------------------
# phases 12-14: training from pixels, and serving its kohya files
# ---------------------------------------------------------------------------


def encoder_vs_reference(bundle, frozen, gen) -> dict:
    """The full-width SD1.5 VAE encoder on seeded 512-px pixels at batch 4:
    the posterior mean with every kernel against every plain version
    (``all``) beside the yardstick of bf16 round-off (the all-plain encode of
    pixels scaled by 1 + 2**-8 against the all-plain encode, ``noise``), each
    (max |diff| / max |ref|, ||diff|| / ||ref||); the launches of one encode,
    its CUDA-event ms, the peak memory and its part above what was allocated
    before the encode (the weights); a posterior sample's finiteness."""
    from pcm_tpu_torch.ops import launch_counts, reference_ops, reset_launch_counts

    x = torch.rand((4, 512, 512, 3), generator=gen, device="cuda") * 2 - 1
    noise = torch.randn((4, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    gc.collect()  # earlier phases' garbage would count in the peak
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        out = bundle.encode_pixels(frozen, x)
        torch.cuda.synchronize()
        counts, peak = launch_counts(), torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: bundle.encode_pixels(frozen, x), iters=5, warmup=1)
        sample = bundle.encode_pixels(frozen, x, noise)
        with reference_ops():
            ref = bundle.encode_pixels(frozen, x)
            nudged = bundle.encode_pixels(frozen, x * (1 + 2 ** -8))
    finite = bool(torch.isfinite(out).all() and torch.isfinite(sample).all())
    return {"all": (rel_max(out, ref), rel_l2(out, ref)),
            "noise": (rel_max(nudged, ref), rel_l2(nudged, ref)), "counts": counts, "ms": ms,
            "peak_bytes": peak, "encode_bytes": peak - base, "shape": tuple(out.shape),
            "dtype": str(out.dtype), "finite": finite, "sample_moved": rel_l2(sample, out)}


PIXEL_IMAGES = 12
# two images larger than 512 px and not square: shortest side 576 -> 512, so
# the Lanczos resize and the center crop both run
PIXEL_LARGE = {3: (576, 720), 8: (720, 576)}
HOST_COUNTERS = ("host_data_s", "host_dispatch_s", "fence_s", "feed_iter_s", "feed_put_s")


def png_filtered(img) -> bytes:
    """An (H, W, 3) uint8 image as an RGB PNG whose rows cycle through the
    Sub, Up, Average and Paeth filters, as adaptive encoders (libpng, PIL)
    mix them; the port's `png_bytes` leaves every row unfiltered."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.arange(h) % 4 + 1
    pred = np.stack([a, b, (a + b) >> 1, paeth])[kinds - 1, np.arange(h)]
    rows = np.concatenate([kinds[:, None], (x - pred) & 255], 1).astype(np.uint8)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_images(out_dir: str, seed: int) -> dict:
    """``PIXEL_IMAGES`` seeded PNGs (smooth colour fields with noise; 512 x 512
    but for `PIXEL_LARGE`; rows filtered as `png_filtered`) with sidecar
    captions, but one without. Checks that the port's PNG decoder gives each
    image back exactly, and times the loader's decode + resize of each
    (`load_resized`, the decoder the dataset picks)."""
    import numpy as np

    from pcm_tpu_torch.data import native_image

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rng = np.random.default_rng(seed)
    load_ms = []
    for i in range(PIXEL_IMAGES):
        h, w = PIXEL_LARGE.get(i, (512, 512))
        coarse = rng.uniform(0, 255, (h // 64 + 1, w // 64 + 1, 3))
        field = np.kron(coarse, np.ones((64, 64, 1)))[:h, :w]
        img = np.clip(field + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        path = os.path.join(out_dir, f"img_{i:02d}.png")
        data = png_filtered(img)
        with open(path, "wb") as f:
            f.write(data)
        if not np.array_equal(native_image.decode_png(data), img):
            raise AssertionError(f"the PNG decoder did not give {path} back exactly")
        t0 = time.perf_counter()
        native_image.load_resized(path, 512)
        load_ms.append((time.perf_counter() - t0) * 1000.0)
        if i != 5:
            with open(os.path.join(out_dir, f"img_{i:02d}.txt"), "w") as f:
                f.write(f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light")
    return {"dir": out_dir, "load_ms": load_ms}


def _train_process(argv, stop_after_step: int = 0, timeout: float = 600) -> dict:
    """``python -m pcm_tpu_torch.train`` as a child process; with
    ``stop_after_step`` SIGTERM is sent once its log row of that step is
    printed. Returns its exit code, printed lines and the stop's wall time."""
    import signal

    proc = _popen([sys.executable, "-u", "-m", "pcm_tpu_torch.train", *argv],
                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                  cwd=os.path.dirname(os.path.abspath(__file__)))
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    lines, signalled = [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if stop_after_step and signalled is None and line.startswith(
                    f"step {stop_after_step}:"):
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter()
        rc = proc.wait(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rc": rc, "lines": lines, "signalled": signalled is not None}


# the rate of phase 13's run: the recipe's 5e-6 moves a fresh adapter too
# little in 6 steps to change a served image, and phase 14 serves two of them
PIXEL_LR = "1e-2"


def train_pixels(img_dir: str, out_dir: str, seed: int) -> dict:
    """Phase 13: ``sd15_4phase`` from ``img_dir`` at full width, batch 4, 6
    steps, checkpoints every 2; SIGTERM after the step-3 row, then a rerun
    that resumes and ends at 6. Checks exit codes, the checkpoint and kohya
    file at the step the first run stopped, the ``preempted`` row, the
    resume, finite losses and the kohya files at 4 and 6; sums both
    processes' launch counts (``launches.jsonl``)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--recipe", "sd15_4phase", "--train-data-dir", img_dir, "--output-dir", out_dir,
            "--batch-size", "4", "--max-train-steps", "6", "--checkpointing-steps", "2",
            "--log-every", "1", "--seed", str(seed), "--allow-hash-tokenizer",
            "--learning-rate", PIXEL_LR, "--dataloader-workers", "4"]
    first = _train_process(argv, stop_after_step=3)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    stops = [r["step"] for r in rows if r.get("preempted")]
    if first["rc"] != 0 or not first["signalled"] or len(stops) != 1:
        raise AssertionError(f"pixels: SIGTERM run exit {first['rc']}, preempted rows {stops}:\n"
                             + "\n".join(first["lines"][-30:]))
    stop = stops[0]
    left = [os.path.join(out_dir, "checkpoints", f"step_{stop:07d}.pt"),
            os.path.join(out_dir, f"pcm_lora_{stop:07d}.safetensors")]
    second = _train_process(argv)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "launches.jsonl")) as f:
        runs = [json.loads(line) for line in f]
    kohya = [os.path.join(out_dir, f"pcm_lora_{s:07d}.safetensors") for s in (4, 6)]
    steps = [r for r in rows if "loss" in r]
    decoder = [ln for ln in first["lines"] if " decoder" in ln and ln.startswith("# ")]
    resumed = f"resumed at step {stop}" in "\n".join(second["lines"])
    if not (second["rc"] == 0 and resumed and 3 <= stop < 6
            and [(r["from_step"], r["to_step"]) for r in runs] == [(0, stop), (stop, 6)]
            and all(os.path.exists(p) for p in left + kohya)
            and [r["step"] for r in steps] == list(range(1, 7))
            and all(math.isfinite(r["loss"]) for r in steps)):
        raise AssertionError(f"pixels: stop {stop}, rerun exit {second['rc']} resumed {resumed}, "
                             f"runs {runs}, files {[(p, os.path.exists(p)) for p in left + kohya]}"
                             f", rows {rows}:\n" + "\n".join(second["lines"][-30:]))
    counts = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    return {"rows": steps, "stop": stop, "counts": counts, "runs": runs,
            "decoder": decoder[0][2:] if decoder else "not printed"}


def serve_lora(run_dir: str, seed: int) -> dict:
    """Phase 14: the server as ``python -m pcm_tpu_torch.serving --lora
    <step-6 file>`` builds it (its own `build_engine`), batch 4, 2 steps: a
    request, ``POST /lora`` of the step-4 file, the same request. Each image
    against the same engine fed the step's trained adapter (its checkpoint)
    rounded to fp16 as a dict (``load_lora(tree)``)."""
    import numpy as np

    from pcm_tpu_torch.data.native_image import decode_png
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.serving import BatchingServer
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, check_args

    files = {s: os.path.join(run_dir, f"pcm_lora_{s:07d}.safetensors") for s in (4, 6)}
    ap = build_parser()
    args = ap.parse_args(["--lora", files[6], "--batch-size", "4", "--steps", "2",
                          "--seed", str(seed)])
    check_args(ap, args)
    torch.cuda.synchronize()
    reset_launch_counts()
    engine = build_engine(args)
    server = BatchingServer(engine, "127.0.0.1", 0, max_wait_ms=50.0)
    server.start()
    base = "http://127.0.0.1:%d" % server.address[1]
    req = {"prompt": "a photo of subject 3, red light", "seed": 11}
    res = {}
    try:
        _post(base + "/generate", req, res, "step6")
        _post(base + "/lora", {"path": files[4]}, res, "swap")
        _post(base + "/generate", req, res, "step4")
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.stop()
    counts = launch_counts()
    served = {s: decode_png(base64.b64decode(res[f"step{s}"]["image_b64"])) for s in (6, 4)}
    identical = {}
    for s in (6, 4):
        ck = torch.load(os.path.join(run_dir, "checkpoints", f"step_{s:07d}.pt"),
                        map_location="cpu", weights_only=True)
        engine.load_lora({k: v.half().float() for k, v in ck["lora"].items()})
        ref = engine.generate_batch([req["prompt"]], [req["seed"]])[0]
        identical[s] = bool(np.array_equal(served[s], ref))
    return {"identical": identical, "differ": bool((served[4] != served[6]).any()),
            "swap": res["swap"], "stats": stats, "counts": counts,
            "shape": served[6].shape}


# ---------------------------------------------------------------------------
# phases 15-18: SDXL-1024 from text and from pixels
# ---------------------------------------------------------------------------

XL_RES = 1024


def _measured(fn) -> tuple:
    """``fn()``'s result, its launch counts and its peak memory above what
    was allocated before it."""
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts

    gc.collect()  # earlier phases' garbage would count in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts(), torch.cuda.max_memory_allocated() - base


def sdxl_vae_vs_reference(gen) -> dict:
    """Phase 15: the full-width SDXL VAE at 1024 px: an encode at batch 1
    (the posterior mean) and a decode at batch 4, on seeded pixels and
    latents. Each with every kernel against every plain version (``all``)
    beside the input-nudge yardstick (``noise``), as phase 12; its launches,
    CUDA-event ms and the peak memory above the weights. Also the encode of
    a batch of 4 in chunks of 1 and of 4 (peaks), and whether the decoder
    gives each sample the same bits in reversed batch order (cuDNN on), as a
    batch and one sample a call, with the latter's ms."""
    import dataclasses

    from pcm_tpu_torch.configs.families import sdxl_bundle
    from pcm_tpu_torch.ops import reference_ops

    bundle = sdxl_bundle()
    frozen, _ = bundle.init(gen, torch.device("cuda"), modules=("vae",))
    x = torch.rand((1, XL_RES, XL_RES, 3), generator=gen, device="cuda") * 2 - 1
    z = torch.randn((4, XL_RES // 8, XL_RES // 8, 4), generator=gen, device="cuda")
    res = {}
    with torch.inference_mode():
        for tag, fn, arg in (("encode", bundle.encode_pixels, x),
                             ("decode", bundle.decode_latents, z)):
            out, counts, peak = _measured(lambda: fn(frozen, arg))
            ms = cuda_ms(lambda: fn(frozen, arg), iters=5, warmup=1)
            with reference_ops():
                ref = fn(frozen, arg)
                nudged = fn(frozen, arg * (1 + 2 ** -8))
            res[tag] = {"all": (rel_max(out, ref), rel_l2(out, ref)),
                        "noise": (rel_max(nudged, ref), rel_l2(nudged, ref)),
                        "counts": counts, "ms": ms, "peak_bytes": peak,
                        "shape": tuple(out.shape), "finite": bool(torch.isfinite(out).all())}
            del out, ref, nudged
        # the bits of a sample at another batch position: decoded as a batch
        # (cuDNN on, as the pipeline decodes) and one sample a call (chunk 1)
        for chunk in (None, 1):
            rev = bundle.decode_latents(frozen, z.flip(0), chunk).flip(0)
            res[f"decode_chunk{chunk or 4}_position_invariant"] = bool(torch.equal(
                rev, bundle.decode_latents(frozen, z, chunk)))
        res["decode_chunk1_ms"] = cuda_ms(lambda: bundle.decode_latents(frozen, z, 1), iters=5,
                                          warmup=1)
        x4 = torch.rand((4, XL_RES, XL_RES, 3), generator=gen, device="cuda") * 2 - 1
        res["encode4_peak_bytes"] = {
            c: _measured(lambda: dataclasses.replace(bundle, vae_encode_chunk=c)
                            .encode_pixels(frozen, x4))[2] for c in (1, 4)}
    return res


def sdxl_towers(gen) -> dict:
    """Phase 16: CLIP-L + CLIP-bigG at full width, `encode_prompts` of 4
    hashed captions: shapes, finiteness, CUDA-event ms (no kernel of the
    port runs in the towers: their attention is a masked matmul)."""
    from pcm_tpu_torch.configs.families import sdxl_bundle
    from pcm_tpu_torch.data.tokenizer import HashTokenizer

    bundle = sdxl_bundle()
    frozen, _ = bundle.init(gen, torch.device("cuda"), modules=("text", "text2"))
    caps = [f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light" for i in range(4)]
    ids = torch.from_numpy(HashTokenizer()(caps)).long().cuda()
    time_ids = torch.tensor([[XL_RES, XL_RES, 0, 0, XL_RES, XL_RES]] * 4, device="cuda")
    with torch.inference_mode():
        cond = bundle.encode_prompts(frozen, ids, ids, time_ids)
        ms = cuda_ms(lambda: bundle.encode_prompts(frozen, ids, ids, time_ids), iters=10)
    emb, pooled = cond["prompt_embeds"], cond["added_cond"]["text_embeds"]
    return {"shapes": (tuple(emb.shape), tuple(pooled.shape)), "ms": ms,
            "finite": bool(torch.isfinite(emb).all() and torch.isfinite(pooled).all()),
            "params_m": {k: round(sum(p.numel() for p in m.parameters()) / 1e6, 1)
                         for k, m in frozen.items()}}


XL_IMAGES = 8
# two images larger than 1024 px and not square (width x height 1152 x 896 and
# 896 x 1216): the resize and the random crop both run
XL_LARGE = {2: (896, 1152), 5: (1216, 896)}  # index: (height, width)
XL_TIME_IDS_PLAIN = [XL_RES, XL_RES, 0, 0, XL_RES, XL_RES]


def write_xl_images(out_dir: str, seed: int) -> str:
    """``XL_IMAGES`` seeded captioned PNGs at 1024 px but for `XL_LARGE`,
    rows filtered as `png_filtered`."""
    import numpy as np

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rng = np.random.default_rng(seed)
    for i in range(XL_IMAGES):
        h, w = XL_LARGE.get(i, (XL_RES, XL_RES))
        coarse = rng.uniform(0, 255, (h // 64 + 1, w // 64 + 1, 3))
        field = np.kron(coarse, np.ones((64, 64, 1)))[:h, :w]
        img = np.clip(field + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        with open(os.path.join(out_dir, f"img_{i:02d}.png"), "wb") as f:
            f.write(png_filtered(img))
        with open(os.path.join(out_dir, f"img_{i:02d}.txt"), "w") as f:
            f.write(f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light")
    return out_dir


def sdxl_cache(img_dir: str, out_dir: str, seed: int) -> dict:
    """Phase 17a: ``python -m pcm_tpu_torch.data.cache_latents --family sdxl``
    over ``img_dir`` (batch 4): the four arrays' shapes and ``time_ids``."""
    import numpy as np

    from pcm_tpu_torch.data import cache_latents
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts

    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cache_latents.main(["--family", "sdxl", "--train-data-dir", img_dir, "--output-dir",
                             out_dir, "--batch", "4", "--seed", str(seed)])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    shard = np.load(os.path.join(out_dir, "shard_00000.npz"))
    return {"rc": rc, "seconds": seconds, "counts": counts,
            "shapes": {k: shard[k].shape for k in shard.files},
            "finite": all(bool(np.isfinite(shard[k]).all()) for k in shard.files),
            "time_ids": shard["time_ids"].tolist()}


def loader_time_ids(img_dir: str, seed: int, batch: int, batches: int) -> list:
    """The ``time_ids`` of the first batches that the training CLI's loader
    gives for ``img_dir`` and ``seed`` (random crop, the same sample streams)."""
    from pcm_tpu_torch.data.dataset import DataLoader, ImageFolderDataset, make_collate
    from pcm_tpu_torch.data.tokenizer import HashTokenizer

    ds = ImageFolderDataset(img_dir, resolution=XL_RES, seed=seed, crop="random")
    toks = {"input_ids": HashTokenizer(), "input_ids_2": HashTokenizer()}
    it = iter(DataLoader(ds, batch, make_collate(toks, XL_RES, sdxl=True), num_workers=2,
                         seed=seed))
    try:
        return [next(it)["time_ids"].tolist() for _ in range(batches)]
    finally:
        it.close()


def _adv_child(argv, out_dir: str, seed: int, family: str, saves=(2, 4)) -> dict:
    """``python -m pcm_tpu_torch.train`` on an adversarial recipe of
    ``family`` as a child process (`_adv_run`), then its readings
    (`_adv_read`)."""
    gc.collect()
    torch.cuda.empty_cache()  # the child's memory is the card's, less this process's
    return _adv_read(_adv_run(argv, out_dir), out_dir, seed, family, saves)


def _adv_run(argv, out_dir: str) -> dict:
    """``python -m pcm_tpu_torch.train`` as a child process
    (`_train_process`) writing to ``out_dir``, emptied first; raises unless
    it exits 0. Host work only (a lane run too)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    run = _train_process([*argv, "--output-dir", out_dir])
    if run["rc"] != 0:
        raise AssertionError(f"adversarial child {argv[:2]}: exit {run['rc']}:\n"
                             + "\n".join(run["lines"][-30:]))
    return run


def _adv_read(run: dict, out_dir: str, seed: int, family: str, saves=(2, 4)) -> dict:
    """The readings of an adversarial run of ``family`` (`_adv_run`) with
    checkpoints at ``saves``: its rows, its launches, whether the kohya files
    of ``saves`` exist and the layers of the last one, the (G, D) updates,
    and how far the LoRA and the heads moved (the last checkpoint against
    zero ``lora_b`` and the heads the seed draws)."""
    from pcm_tpu_torch.configs.families import disc_config
    from pcm_tpu_torch.lora.kohya import kohya_layers
    from pcm_tpu_torch.models.mmdit import SD3_MEDIUM_CONFIG
    from pcm_tpu_torch.models.unet import SDXL_CONFIG
    from pcm_tpu_torch.train.adv import init_discriminator
    from pcm_tpu_torch.utils.safetensors import read_header

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "launches.jsonl")) as f:
        counts = json.loads(f.readline())["launches"]
    ck = torch.load(os.path.join(out_dir, "checkpoints", f"step_{saves[-1]:07d}.pt"),
                    map_location="cpu", weights_only=True)
    taps = {"sdxl": SDXL_CONFIG, "sd3": SD3_MEDIUM_CONFIG}[family].tap_channels()
    _, init = init_discriminator(disc_config(family), taps,
                                 torch.Generator("cuda").manual_seed(seed + 1),
                                 torch.device("cuda"))
    heads_moved = max(float((ck["d_params"][k] - v.cpu()).abs().max()) for k, v in init.items())
    lora_b = max(float(v.abs().max()) for k, v in ck["lora"].items() if k.endswith("lora_b"))
    kohya = [os.path.join(out_dir, f"pcm_lora_{s:07d}.safetensors") for s in saves]
    decoder = [ln for ln in run["lines"] if " decoder" in ln and ln.startswith("# ")]
    return {"rows": rows, "counts": counts, "heads_moved": heads_moved, "lora_b_max": lora_b,
            "kohya": all(os.path.exists(p) for p in kohya), "kohya_path": kohya[-1],
            "kohya_layers": set(kohya_layers(read_header(kohya[-1]))),
            "updates": (ck["lora_step"], ck["d_step"]),
            "decoder": decoder[0][2:] if decoder else "not printed"}


def train_xl_pixels(img_dir: str, out_dir: str, seed: int) -> dict:
    """Phase 17b: ``python -m pcm_tpu_torch.train --recipe sdxl_4phase_adv
    --train-data-dir`` as a child process (`_adv_child`) at full width, batch
    2, ``fused``, 4 global steps, a checkpoint at 4 (one: a SDXL checkpoint is
    2.7 GB, and the smoke's disk writes are bounded)."""
    return _adv_child(["--recipe", "sdxl_4phase_adv", "--train-data-dir", img_dir,
                       "--batch-size", "2", "--max-train-steps", "4", "--checkpointing-steps",
                       "4", "--log-every", "1", "--seed", str(seed), "--allow-hash-tokenizer",
                       "--adv-pairing", "fused", "--dataloader-workers", "4"],
                      out_dir, seed, "sdxl", saves=(4,))


def _serve_family(family: str, lora_path: str, seed: int, seed_base: int, *flags: str):
    """The engine of ``python -m pcm_tpu_torch.serving --family <family>
    --lora <file> [flags]`` (its own `build_engine`: the full-width bundle
    from ``--seed``) behind the HTTP server, 2 steps, batch 4, 1024 px: a
    full batch of 4 and a partial one, the shared request's image equal bit
    for bit; steady batch latency. Returns the engine and its readings."""
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.serving import BatchingServer
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, check_args

    ap = build_parser()
    args = ap.parse_args(["--family", family, "--lora", lora_path, "--batch-size", "4",
                          "--steps", "2", "--seed", str(seed), *flags])
    check_args(ap, args)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine = build_engine(args)
    server = BatchingServer(engine, "127.0.0.1", 0, max_wait_ms=1000.0)
    server.start()
    url = "http://127.0.0.1:%d/generate" % server.address[1]
    full = [{"key": f"f{i}", "prompt": f"a photo of subject {i}", "seed": seed_base + i}
            for i in range(4)]
    partial = [{"key": "p0", "prompt": full[1]["prompt"], "seed": full[1]["seed"]},
               {"key": "p1", "prompt": "a partial batch", "seed": 9}]
    res = {}
    try:
        _concurrent(url, full, res)
        _concurrent(url, partial, res)
        lat = []
        set_up_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()  # the timed batches' own peak
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = engine.generate_batch([p["prompt"] for p in full], [p["seed"] for p in full])
            lat.append((time.perf_counter() - t0) * 1000)
        batch_peak = torch.cuda.max_memory_allocated()
        stats = server.stats()
    finally:
        server.stop()
    pngs = {k: base64.b64decode(r["image_b64"]) for k, r in res.items()}
    return engine, {
        "sizes": {k: r["batch_size"] for k, r in res.items()},
        "same_seed_identical": pngs["f1"] == pngs["p0"], "differ": pngs["f0"] != pngs["f1"],
        "header": _png_header(pngs["f0"]), "batch_ms": lat, "images": images,
        "peak_bytes": max(set_up_peak, batch_peak), "batch_peak_bytes": batch_peak,
        "counts": launch_counts(), "stats": stats, "lora": engine.lora_source}


def _serve_teacher(engine, family: str, guidance: float, seed_base: int) -> dict:
    """A teacher engine (no adapter) on ``engine``'s weights and sampler at
    ``guidance``: the backbone at batch 8 under CFG; steady batch latency."""
    import dataclasses

    from pcm_tpu_torch.configs.families import FAMILIES
    from pcm_tpu_torch.data.tokenizer import resolve_tokenizers
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.serving import InferenceEngine

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    teacher = InferenceEngine(engine.bundle, engine.pipe.sampler, engine.frozen, None,
                              resolve_tokenizers(None, FAMILIES[family][1]),
                              dataclasses.replace(engine.cfg, guidance_scale=guidance),
                              torch.device("cuda"))
    lat = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = teacher.generate_batch([f"teacher prompt {j}" for j in range(4)],
                                      [seed_base + j for j in range(4)])
        lat.append((time.perf_counter() - t0) * 1000)
    return {"batch_ms": lat, "peak_bytes": torch.cuda.max_memory_allocated(),
            "counts": launch_counts(), "shape": imgs.shape}


def _serve_readings(sv: dict, tv: dict) -> dict:
    """The student's and the teacher's readings under the names the phases log."""
    return {"sizes": sv["sizes"], "same_seed_identical": sv["same_seed_identical"],
            "differ": sv["differ"], "header": sv["header"], "student_batch_ms": sv["batch_ms"],
            "teacher_batch_ms": tv["batch_ms"], "student_peak_bytes": sv["peak_bytes"],
            "teacher_peak_bytes": tv["peak_bytes"], "student_counts": sv["counts"],
            "teacher_counts": tv["counts"], "stats": sv["stats"], "teacher_shape": tv["shape"],
            "lora": sv["lora"], "student_batch_peak_bytes": sv["batch_peak_bytes"],
            "counts": {k: sv["counts"][k] + tv["counts"][k] for k in sv["counts"]}}


def serve_sdxl(run_dir: str, seed: int, gen) -> dict:
    """Phase 18: ``--family sdxl --lora <step-4 file>`` served (`_serve_family`);
    a teacher engine on the same weights at guidance 7.5 (K5, the UNet at
    batch 8); the UNet's batch-4 forward with cuDNN on and off."""
    engine, sv = _serve_family("sdxl", os.path.join(run_dir, "pcm_lora_0000004.safetensors"),
                               seed, 300)
    out = _serve_readings(sv, _serve_teacher(engine, "sdxl", 7.5, 400))
    bundle, frozen = engine.bundle, engine.frozen
    x = torch.randn((4, XL_RES // 8, XL_RES // 8, 4), generator=gen, device="cuda")
    t = torch.full((4,), 999.0, device="cuda")
    cond = engine._encode([f"a photo of subject {i}" for i in range(4)])
    unet_ms = {}
    with torch.inference_mode():
        for on in (True, False):
            with torch.backends.cudnn.flags(enabled=on):
                unet_ms["cudnn_on" if on else "cudnn_off"] = cuda_ms(
                    lambda: bundle.student(frozen, engine.lora, x, t, cond), iters=5, warmup=1)
    out["unet_ms"] = unet_ms
    return out


def sdxl_phases(seed: int, gen) -> list:
    """Phases 15-18, each checked; returns the runs whose launches count."""
    xv = sdxl_vae_vs_reference(gen)
    for tag, batch in (("encode", 1), ("decode", 4)):
        r = xv[tag]
        log("sdxl-vae", op=tag, batch=batch, shape=r["shape"],
            **{k: "%.3e/%.3e" % r[k] for k in ("all", "noise")}, bounds="max(2e-2,2*noise)",
            ms=f"{r['ms']:.3f}", peak_gib=f"{r['peak_bytes'] / 2**30:.3f}",
            counts=json.dumps(r["counts"]))
        caps = [max(2e-2, 2 * n) for n in r["noise"]]
        if not (r["finite"] and all(e <= c for e, c in zip(r["all"], caps))
                and r["counts"]["flash_attention_fwd"] > 0 and r["counts"]["group_norm_silu"] > 0):
            raise AssertionError(f"full-width SDXL VAE {tag}, kernels vs plain: {r}")
    log("sdxl-vae", decode_chunk4_position_invariant=xv["decode_chunk4_position_invariant"],
        decode_chunk1_position_invariant=xv["decode_chunk1_position_invariant"],
        decode_chunk1_ms=f"{xv['decode_chunk1_ms']:.3f}",
        encode_batch4_peak_gib=json.dumps({c: round(b / 2**30, 3)
                                           for c, b in xv["encode4_peak_bytes"].items()}))

    tw = sdxl_towers(gen)
    log("sdxl-towers", batch=4, shapes=tw["shapes"], finite=tw["finite"], ms=f"{tw['ms']:.3f}",
        params_m=json.dumps(tw["params_m"]))
    if not (tw["finite"] and tw["shapes"] == ((4, 77, 2048), (4, 1280))):
        raise AssertionError(f"SDXL text towers: {tw}")

    xl_imgs = write_xl_images("build/chip_smoke/images_xl", seed)
    xc = sdxl_cache(xl_imgs, "build/chip_smoke/cache_xl_pixels", seed)
    log("sdxl-pixels", cache_shapes=json.dumps(xc["shapes"]), seconds=f"{xc['seconds']:.1f}",
        time_ids=json.dumps(xc["time_ids"]), counts=json.dumps(xc["counts"]))
    if not (xc["rc"] == 0 and xc["finite"] and xc["shapes"] == {
            "latents": (8, 128, 128, 4), "prompt_embeds": (8, 77, 2048),
            "pooled_embeds": (8, 1280), "time_ids": (8, 6)}
            and any(row != XL_TIME_IDS_PLAIN for row in xc["time_ids"])
            and xc["counts"]["flash_attention_fwd"] > 0 and xc["counts"]["group_norm_silu"] > 0):
        raise AssertionError(f"SDXL latent cache: {xc}")
    xp = train_xl_pixels(xl_imgs, "build/chip_smoke/train_xl_pixels", seed)
    fed = loader_time_ids(xl_imgs, seed, 2, 2)  # the run's two batches (fused pairs)
    rows = xp["rows"]
    log("sdxl-pixels", decoder=repr(xp["decoder"]), steps=[r["step"] for r in rows],
        losses=json.dumps([r.get("loss") for r in rows]),
        d_losses=json.dumps([r.get("d_loss") for r in rows]),
        step_ms=json.dumps([round(r["step_ms"], 1) for r in rows]),
        peak_gib=f"{max(r['peak_gib'] for r in rows):.3f}", lora_b_max=f"{xp['lora_b_max']:.3e}",
        heads_moved=f"{xp['heads_moved']:.3e}", updates=xp["updates"], kohya_2_4=xp["kohya"],
        fed_time_ids=json.dumps(fed),
        **{k: json.dumps([round(r[k], 4) for r in rows]) for k in HOST_COUNTERS},
        counts=json.dumps(xp["counts"]))
    losses = [r[k] for r in rows for k in ("loss", "d_loss") if k in r]
    missing = [k for k in ADV_KERNELS if xp["counts"][k] == 0]
    if not (rows and rows[-1]["step"] == 4 and len(losses) >= 4
            and all(math.isfinite(x) for x in losses) and xp["kohya"] and not missing
            and xp["lora_b_max"] > 0 and xp["heads_moved"] > 0 and xp["updates"] == (2, 2)
            and any(row != XL_TIME_IDS_PLAIN for b in fed for row in b)):
        raise AssertionError(f"SDXL training from pixels: {xp} (kernels not launched: "
                             f"{missing}; fed time_ids {fed})")

    sv = serve_sdxl("build/chip_smoke/train_xl_pixels", seed, gen)
    _drop_checkpoints("build/chip_smoke/train_xl_pixels")
    log("sdxl-serve", sizes=json.dumps(sv["sizes"]), same_seed_identical=sv["same_seed_identical"],
        student_batch_ms=json.dumps([round(x, 1) for x in sv["student_batch_ms"]]),
        teacher_batch_ms=json.dumps([round(x, 1) for x in sv["teacher_batch_ms"]]),
        student_peak_gib=f"{sv['student_peak_bytes'] / 2**30:.3f}",
        teacher_peak_gib=f"{sv['teacher_peak_bytes'] / 2**30:.3f}",
        unet_bs4_ms=json.dumps({k: round(v, 2) for k, v in sv["unet_ms"].items()}),
        lora=repr(sv["lora"]), student=json.dumps(sv["student_counts"]),
        teacher=json.dumps(sv["teacher_counts"]))
    sc, tc = sv["student_counts"], sv["teacher_counts"]
    if not (sv["sizes"] == {"f0": 4, "f1": 4, "f2": 4, "f3": 4, "p0": 2, "p1": 2}
            and sv["same_seed_identical"] and sv["differ"] and sv["header"] == (1024, 1024, 8, 2)
            and sv["teacher_shape"] == (4, 1024, 1024, 3) and sc["geglu"] == 0
            and tc["geglu"] > 0 and all(c[k] > 0 for c in (sc, tc)
                                        for k in ("flash_attention_fwd", "group_norm_silu"))
            and sv["lora"].endswith("pcm_lora_0000004.safetensors")):
        raise AssertionError(f"SDXL serving: {sv}")

    return [xv["encode"], xv["decode"], xc, xp, sv]


# ---------------------------------------------------------------------------
# phases 19-23: SD3 at 1024 px
# ---------------------------------------------------------------------------

SD3_LATENT = (XL_RES // 8, XL_RES // 8, 16)


def sd3_cond(n: int, gen) -> dict:
    """Seeded SD3 conditioning on the card: (154, 4096) prompt embeds and 2048 pooled."""
    return {"prompt_embeds": bf16_randn((n, 154, 4096), gen), "pooled": bf16_randn((n, 2048), gen)}


def sd3_mmdit_vs_reference(bundle, frozen, gen, int8: bool = False) -> dict:
    """Phase 19: one full-width MMDiT teacher forward at batch 2 (4250-token
    joint attention through K1) against every plain version (``all``) beside
    the input-nudge yardstick (``noise``), as phase 9; its CUDA-event ms and
    launches. Phase 29 (``int8``): on int8 weights under ``fused`` (every
    Linear through K6), and whether the output with K6's plain version
    alone is equal bit for bit."""
    from pcm_tpu_torch.ops import reference_ops
    from pcm_tpu_torch.utils.quant import int8_matmul

    x = torch.randn((2, *SD3_LATENT), generator=gen, device="cuda")
    t = torch.tensor([999.0, 421.0], device="cuda")
    cond = sd3_cond(2, gen)
    res = {}
    with torch.inference_mode(), int8_matmul("fused") if int8 else contextlib.nullcontext():
        out, counts, peak = _measured(lambda: bundle.teacher(frozen, x, t, cond))
        ms = cuda_ms(lambda: bundle.teacher(frozen, x, t, cond), iters=5, warmup=1)
        with reference_ops():
            ref = bundle.teacher(frozen, x, t, cond)
            nudged = bundle.teacher(frozen, x * (1 + 2 ** -8), t, cond)
        if int8:
            with reference_ops("int8_matmul"):
                res["k6_plain_identical"] = torch.equal(out, bundle.teacher(frozen, x, t, cond))
    return {"all": (rel_max(out, ref), rel_l2(out, ref)),
            "noise": (rel_max(nudged, ref), rel_l2(nudged, ref)), "ms": ms, "counts": counts,
            "peak_bytes": peak, "shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out).all()), **res}


def sd3_batch(n: int, gen) -> dict:
    """A cached SD3 batch drawn on the card with zero uncond (`bench.py:308-320`)."""
    cond = sd3_cond(n, gen)
    return {"latents": torch.randn((n, *SD3_LATENT), generator=gen, device="cuda"),
            "prompt_embeds": cond["prompt_embeds"], "pooled_embeds": cond["pooled"],
            "uncond_embeds": torch.zeros_like(cond["prompt_embeds"]),
            "uncond_pooled": torch.zeros_like(cond["pooled"])}


def sd3_step(bundle, frozen, template, gen, steps: int = 3) -> dict:
    """Phase 20: the SD3 consistency step on cached latents
    (`build_flow_distill_step` on `SD3_CACHED_STEP`: 100 Euler solver steps,
    4 phases, fixed w = 3, rank-32 LoRA, the flow schedule at shift 3, lr
    5e-6) at the recipe's batch of 2, remat full; the batch drawn on the card
    with zero uncond (`bench.py:308-320`)."""
    from pcm_tpu_torch.configs.families import SD3_CACHED_STEP
    from pcm_tpu_torch.core.schedule import make_flow_schedule
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.train.distill import build_flow_distill_step, sample_draws
    from pcm_tpu_torch.train.state import TrainState, make_optimizer

    cfg = SD3_CACHED_STEP.distill
    tx = make_optimizer(SD3_CACHED_STEP.lr)
    step = build_flow_distill_step(bundle, make_flow_schedule(), cfg, tx)
    state = TrainState.create(template, tx)
    batch = sd3_batch(SD3_CACHED_STEP.batch_size, gen)
    losses, norms, times = [], [], []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, batch, [sample_draws(cfg, gen, batch["latents"])])
        losses.append(float(metrics["loss"]))  # a readback: the step has run
        times.append((time.perf_counter() - t0) * 1000)
        norms.append(float(metrics["grad_norm"]))
    counts = launch_counts()
    lora_b = max(float(v.abs().max()) for k, v in state.params.items() if k.endswith("lora_b"))
    return {"losses": losses, "grad_norms": norms, "step_ms": times, "counts": counts,
            "peak_bytes": torch.cuda.max_memory_allocated(), "lora_b_max": lora_b,
            "factors": len(template)}


def sd3_adv_grad(bundle, frozen, gen, seed: int) -> dict:
    """Phase 20a: the SD3 adversarial G loss through the full-width teacher
    at batch 2, on ``bundle``'s adversarial LoRA list (rank 32, seeded b !=
    0) and the SD3 heads drawn from ``seed + 1``: the 24 taps
    (`SD3Bundle.teacher_features`) of a renoised latent with every kernel
    against every plain version beside the input-nudge yardstick (phase
    9's rule, the largest over the taps); then the LoRA gradients of the G
    loss (the student's velocity, its Euler jump, the flow renoising, the
    taps, the heads, `hinge_g_loss`) against every plain version and against
    K2 alone and K3 alone plain, (cosine, relative norm error) each; the
    launches of the kernel run."""
    from pcm_tpu_torch.configs.families import disc_config
    from pcm_tpu_torch.core.losses import hinge_g_loss
    from pcm_tpu_torch.lora.layers import lora_shapes
    from pcm_tpu_torch.ops import launch_counts, reference_ops, reset_launch_counts
    from pcm_tpu_torch.train.adv import _flow_renoise, heads_precision, init_discriminator

    heads_precision()  # as the training CLI's steps set it
    dev = torch.device("cuda")
    disc, heads = init_discriminator(disc_config("sd3"), bundle.tap_channels(),
                                     torch.Generator("cuda").manual_seed(seed + 1), dev)
    adapter = {k: torch.randn(shape, generator=gen, device=dev) * 0.05
               for k, shape in lora_shapes(frozen["mmdit"], bundle.lora.rank).items()}
    x = torch.randn((2, *SD3_LATENT), generator=gen, device=dev)
    eps = torch.randn((2, *SD3_LATENT), generator=gen, device=dev)
    cond = sd3_cond(2, gen)
    t = torch.tensor([900.0, 750.0], device=dev)  # sigma 0.9 / 0.75 on the grid's scale
    t_adv = torch.tensor([812.5, 633.0], device=dev)
    sig, sig_end = (t / 1000).view(2, 1, 1, 1), torch.tensor([0.75, 0.5], device=dev).view(2, 1, 1, 1)
    sig_adv = (t_adv / 1000).view(2, 1, 1, 1)

    def taps(x_):
        return bundle.teacher_features(frozen, x_, t_adv, cond)

    def worst(out, ref):
        return tuple(max(f(out[k], ref[k]) for k in ref) for f in (rel_max, rel_l2))

    fake = _flow_renoise(x, eps, sig_end, sig_adv)
    with torch.inference_mode():
        got = taps(fake)
        with reference_ops():
            ref, nudged = taps(fake), taps(fake * (1 + 2 ** -8))
    tap_readings = {"all": worst(got, ref), "noise": worst(nudged, ref),
                    "finite": all(bool(torch.isfinite(f).all()) for f in got.values()),
                    "shapes": sorted({tuple(f.shape) for f in got.values()}), "taps": len(got)}
    del got, ref, nudged

    def g_grads():
        lora = {k: v.clone().requires_grad_(True) for k, v in adapter.items()}
        v = bundle.student(frozen, lora, x, t, cond)
        jumped = x + (sig_end - sig) * v  # the online student's Euler jump to its phase start
        feats = bundle.teacher_features(frozen, _flow_renoise(jumped, eps, sig_end, sig_adv),
                                        t_adv, cond)
        g = hinge_g_loss(disc.logits(heads, feats))
        return torch.autograd.grad(g, list(lora.values())), float(g.detach())

    def compare(ref):
        flat_ref = torch.cat([g.flatten() for g in ref])
        return (float(torch.nn.functional.cosine_similarity(flat, flat_ref, dim=0)),
                float((flat.norm() - flat_ref.norm()).abs() / flat_ref.norm()))

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    got, loss = g_grads()
    torch.cuda.synchronize()
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated()
    bad = [k for k, g in zip(adapter, got) if not torch.isfinite(g).all()]
    flat = torch.cat([g.flatten() for g in got])
    readings = {}
    for label, names in (("all", ()), *((n, (n,)) for n in BWD_SWAPS)):
        with reference_ops(*names):
            readings[label] = compare(g_grads()[0])
    return {"taps": tap_readings, "readings": readings, "bad": bad, "loss": loss,
            "factors": len(adapter), "counts": counts, "peak_bytes": peak,
            "pos_embed": "pos_embed.proj.lora_a" in adapter}


def write_sd3_cache(out_dir: str, seed: int, n: int = 8) -> str:
    """One shard of seeded SD3-1024 cached samples: 128x128x16 latents,
    (154, 4096) prompt embeds and 2048 pooled embeds (fp16)."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.savez(os.path.join(out_dir, "shard_00000.npz"),
             latents=rng.standard_normal((n, *SD3_LATENT)).astype(np.float16),
             prompt_embeds=rng.standard_normal((n, 154, 4096)).astype(np.float16),
             pooled_embeds=rng.standard_normal((n, 2048)).astype(np.float16))
    return out_dir


def sd3_adv_layers(stochastic: bool = False) -> set:
    """The kohya layer keys of the full-width MMDiT's adversarial LoRA list."""
    from pcm_tpu_torch.configs.families import sd3_bundle
    from pcm_tpu_torch.lora.kohya import kohya_key
    from pcm_tpu_torch.lora.layers import lora_shapes

    bundle = sd3_bundle(adv_targets=True, stochastic=stochastic)
    meta = bundle.build(torch.device("meta"), ("mmdit",))["mmdit"]
    return {kohya_key(k[:-len(".lora_a")], bundle.KOHYA_PREFIX)
            for k in lora_shapes(meta, bundle.lora.rank) if k.endswith(".lora_a")}


# the rate of phase 22a's fused run, whose step-4 file phase 23 serves: the
# recipe's 5e-6 moves a fresh adapter too little in 2 updates to change a
# served image, and phase 23 compares the file with its base-list subset
SD3_SERVED_LR = "1e-2"


SD3_ADV_DIRS = {"fused": "build/chip_smoke/sd3_adv_fused",
                "fresh": "build/chip_smoke/sd3_adv_fresh"}


def sd3_adv_runs(cache_dir: str, seed: int) -> dict:
    """Phase 22a's runs: ``python -m pcm_tpu_torch.train --recipe
    sd3_4phase_adv`` on ``cache_dir`` as child processes (`_adv_run`) at
    full width, batch 2: ``fused`` for 4 global steps (a checkpoint at 4, lr
    `SD3_SERVED_LR`) and ``fresh`` for 4 (the recipe's lr); one checkpoint
    each, as the smoke's disk writes are bounded. A lane run (host work
    only); `train_sd3_adv` reads them."""
    common = ["--recipe", "sd3_4phase_adv", "--cached-latents-dir", cache_dir, "--batch-size",
              "2", "--max-train-steps", "4", "--log-every", "1", "--seed", str(seed)]
    return {"fused": _adv_run(common + ["--adv-pairing", "fused", "--checkpointing-steps", "4",
                                        "--learning-rate", SD3_SERVED_LR], SD3_ADV_DIRS["fused"]),
            "fresh": _adv_run(common + ["--adv-pairing", "fresh", "--checkpointing-steps", "4"],
                              SD3_ADV_DIRS["fresh"])}


def train_sd3_adv(runs: dict, seed: int) -> dict:
    """Phase 22a: the readings of `sd3_adv_runs`'s runs (`_adv_read`); then
    their checkpoints go (phase 23 serves the kohya file)."""
    out = {p: _adv_read(run, SD3_ADV_DIRS[p], seed, "sd3", saves=(4,)) for p, run in runs.items()}
    for d in SD3_ADV_DIRS.values():
        _drop_checkpoints(d)
    return out


def sd3_pixels(img_dir: str, seed: int) -> dict:
    """Phase 22b: ``python -m pcm_tpu_torch.data.cache_latents --family sd3``'s
    ``main`` over the 1024-px PNGs of ``img_dir`` (batch 4: the arrays'
    shapes, launches), then ``python -m pcm_tpu_torch.train --recipe
    sd3_4phase_adv --train-data-dir`` as a child process (`_adv_child`) at
    full width, batch 2, ``fused``, 2 global steps: each encodes its batch
    with the VAE (K1 at d = 512, K4 bf16) and the three towers."""
    import numpy as np

    from pcm_tpu_torch.data import cache_latents
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts

    out_dir = "build/chip_smoke/cache_sd3_pixels"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cache_latents.main(["--family", "sd3", "--train-data-dir", img_dir, "--output-dir",
                             out_dir, "--batch", "4", "--seed", str(seed)])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    shard = np.load(os.path.join(out_dir, "shard_00000.npz"))
    cache = {"rc": rc, "seconds": seconds, "counts": counts,
             "shapes": {k: shard[k].shape for k in shard.files},
             "finite": all(bool(np.isfinite(shard[k]).all()) for k in shard.files)}
    run = _adv_child(["--recipe", "sd3_4phase_adv", "--train-data-dir", img_dir, "--batch-size",
                      "2", "--max-train-steps", "2", "--checkpointing-steps", "2", "--log-every",
                      "1", "--seed", str(seed), "--allow-hash-tokenizer", "--adv-pairing",
                      "fused", "--dataloader-workers", "4"],
                     "build/chip_smoke/train_sd3_pixels", seed, "sd3", saves=(2,))
    _drop_checkpoints("build/chip_smoke/train_sd3_pixels")
    return {"cache": cache, "run": run}


def check_sd3_run(tag: str, r: dict, steps: int, layers: set, kernels) -> None:
    """Finite ``loss`` and ``d_loss`` to the last step, both players updated
    and moved, kohya files holding ``layers``, ``kernels`` launched."""
    rows = r["rows"]
    losses = [x[k] for x in rows for k in ("loss", "d_loss") if k in x]
    missing = [k for k in kernels if r["counts"][k] == 0]
    if not (rows and rows[-1]["step"] == steps and all(math.isfinite(x) for x in losses)
            and any("loss" in x for x in rows) and any("d_loss" in x for x in rows)
            and r["kohya"] and r["kohya_layers"] == layers and not missing
            and r["lora_b_max"] > 0 and r["heads_moved"] > 0
            and r["updates"] == (steps // 2, steps // 2)):
        raise AssertionError(f"{tag}: {({k: v for k, v in r.items() if k != 'kohya_layers'})} "
                             f"(kernels not launched: {missing}; layers match: "
                             f"{r['kohya_layers'] == layers})")


def sd3_towers(bundle, gen) -> dict:
    """Phase 21: CLIP-L (768 projection), CLIP-bigG and T5-XXL at full width,
    `encode_prompts` of 4 hashed captions: shapes, finiteness, T5's range,
    CUDA-event ms (no kernel of the port runs in the towers)."""
    from pcm_tpu_torch.data.tokenizer import HashTokenizer

    frozen, _ = bundle.init(gen, torch.device("cuda"), modules=("text", "text2", "t5"))
    caps = [f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light" for i in range(4)]
    ids = torch.from_numpy(HashTokenizer()(caps)).long().cuda()
    ids3 = torch.from_numpy(HashTokenizer(vocab_size=32128)(caps)).long().cuda()
    with torch.inference_mode():
        cond = bundle.encode_prompts(frozen, ids, ids, ids3)
        t5_out = frozen["t5"](ids3).float()
        ms = cuda_ms(lambda: bundle.encode_prompts(frozen, ids, ids, ids3), iters=10)
        t5_ms = cuda_ms(lambda: frozen["t5"](ids3), iters=10)
    emb, pooled = cond["prompt_embeds"], cond["pooled"]
    return {"shapes": (tuple(emb.shape), tuple(pooled.shape)), "ms": ms, "t5_ms": t5_ms,
            "finite": bool(torch.isfinite(emb).all() and torch.isfinite(pooled).all()),
            "t5_range": (float(t5_out.min()), float(t5_out.max())),
            "t5_rms": float(t5_out.square().mean().sqrt()),
            "params_m": {k: round(sum(p.numel() for p in m.parameters()) / 1e6, 1)
                         for k, m in frozen.items()}}


def sd3_vae_decode(bundle, gen) -> dict:
    """Phase 22: the full-width SD3 VAE (16 latent channels, no quant convs,
    shifted scaling) decoding one 1024-px sample, as serving decodes: every
    kernel against every plain version beside the yardstick (phase 15's
    rule), CUDA-event ms, peak above the weights, K4 / K1 launches."""
    from pcm_tpu_torch.ops import reference_ops

    frozen, _ = bundle.init(gen, torch.device("cuda"), modules=("vae",))
    z = torch.randn((1, *SD3_LATENT), generator=gen, device="cuda")
    with torch.inference_mode():
        out, counts, peak = _measured(lambda: bundle.decode_latents(frozen, z, 1))
        ms = cuda_ms(lambda: bundle.decode_latents(frozen, z, 1), iters=5, warmup=1)
        with reference_ops():
            ref = bundle.decode_latents(frozen, z, 1)
            nudged = bundle.decode_latents(frozen, z * (1 + 2 ** -8), 1)
    return {"all": (rel_max(out, ref), rel_l2(out, ref)),
            "noise": (rel_max(nudged, ref), rel_l2(nudged, ref)), "ms": ms, "counts": counts,
            "peak_bytes": peak, "shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out).all())}


def serve_sd3(lora_path: str, seed: int) -> dict:
    """Phase 23: ``--family sd3 --lora <file>`` served (`_serve_family`:
    PCM-FM on the 100-point grid, the template of the file's target list);
    the same requests with the file's base-list subset (the other layers'
    factors zero, which adds nothing); a teacher engine on the same weights
    at guidance 3.0 (the MMDiT at batch 8); then ``--family sd3 --stochastic
    --lora <file>`` served the same way, its sampler stochastic and its
    images not the deterministic sampler's for the same prompts and seeds."""
    from pcm_tpu_torch.configs.families import sd3_bundle

    engine, sv = _serve_family("sd3", lora_path, seed, 500)
    out = _serve_readings(sv, _serve_teacher(engine, "sd3", 3.0, 600))
    out["sigmas"] = [float(x) for x in engine.pipe.sampler.sigmas]
    base = sd3_bundle().lora
    out["template"] = {"factors": len(engine.lora),
                       "base_factors": sum(base.matches(k.rsplit(".", 1)[0]) for k in engine.lora),
                       "pos_embed": "pos_embed.proj.lora_a" in engine.lora}
    engine.load_lora({k: v if base.matches(k.rsplit(".", 1)[0]) else torch.zeros_like(v)
                      for k, v in engine.lora.items()})
    prompts = [f"a photo of subject {i}" for i in range(4)]
    base_images = engine.generate_batch(prompts, [500 + i for i in range(4)])
    out["base_subset_differs"] = bool((base_images != sv["images"]).any(axis=(1, 2, 3)).all())
    del engine
    stoch, st = _serve_family("sd3", lora_path, seed, 500, "--stochastic")
    out.update({"stochastic_sampler": stoch.pipe.sampler.stochastic,
                "stochastic_sizes": st["sizes"],
                "stochastic_same_seed_identical": st["same_seed_identical"],
                "stochastic_differs": bool((st["images"] != sv["images"]).any(axis=(1, 2, 3)).all()),
                "stochastic_batch_ms": st["batch_ms"], "stochastic_counts": st["counts"],
                "stochastic_lora": st["lora"]})
    del stoch
    out["counts"] = {k: out["counts"][k] + st["counts"][k] for k in out["counts"]}
    return out


def sd3_phases(seed: int, gen, lane: Lane) -> list:
    """Phases 19-23, each checked; returns the runs whose launches count.
    Phase 22a's runs are the lane's ``sd3-adv``; phase 22b trains on the
    1024-px PNGs of phase 17 (written here when they are not there)."""
    from pcm_tpu_torch.configs.families import sd3_bundle
    from pcm_tpu_torch.lora.layers import attach_lora

    sd3 = sd3_bundle(remat=True)
    t0 = time.perf_counter()
    frozen, template = sd3.init(gen, torch.device("cuda"), modules=("mmdit",))
    torch.cuda.synchronize()
    log("sd3-init", seconds=f"{time.perf_counter() - t0:.2f}",
        mmdit_params_m=round(sum(p.numel() for p in frozen["mmdit"].parameters()) / 1e6, 1),
        lora_factors=len(template))

    r = sd3_mmdit_vs_reference(sd3, frozen, gen)
    log("sd3-mmdit", batch=2, shape=r["shape"], **{k: "%.3e/%.3e" % r[k] for k in ("all", "noise")},
        bounds="max(2e-2,2*noise)", ms=f"{r['ms']:.3f}", peak_gib=f"{r['peak_bytes'] / 2**30:.3f}",
        counts=json.dumps(r["counts"]))
    caps = [max(2e-2, 2 * n) for n in r["noise"]]
    if not (r["finite"] and all(e <= c for e, c in zip(r["all"], caps))
            and r["counts"]["flash_attention_fwd"] == sd3.mmdit_cfg.num_layers):
        raise AssertionError(f"full-width MMDiT, kernels vs plain: {r}")
    x = torch.randn((2, *SD3_LATENT), generator=gen, device="cuda")
    g = lora_grad_readings(sd3, frozen, template, gen, x, sd3_cond(2, gen))
    log("sd3-grad", factors=g["factors"], bounds="cos>=0.99,norm<=5e-2",
        **{k: f"{c:.6f}/{e:.3e}" for k, (c, e) in g["readings"].items()})
    if g["bad"] or not all(c >= 0.99 and e <= 5e-2 for c, e in g["readings"].values()):
        raise AssertionError(f"SD3 student gradients, kernels vs plain: {g}")

    st = sd3_step(sd3, frozen, template, gen)
    log("sd3-step", batch=2, losses=json.dumps([round(x, 6) for x in st["losses"]]),
        grad_norms=json.dumps([round(x, 6) for x in st["grad_norms"]]),
        step_ms=json.dumps([round(x, 1) for x in st["step_ms"]]),
        peak_gib=f"{st['peak_bytes'] / 2**30:.3f}", lora_b_max=f"{st['lora_b_max']:.3e}",
        factors=st["factors"], counts=json.dumps(st["counts"]))
    missing = [k for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                           "flash_attention_bwd_dq") if st["counts"][k] == 0]
    if not (len(st["losses"]) >= 3 and all(math.isfinite(x) for x in st["losses"])
            and st["lora_b_max"] > 0) or missing:
        raise AssertionError(f"SD3 cached step: {st} (kernels not launched: {missing})")
    rm = remat_runs(sd3, frozen, template, gen, REMAT_SD3)
    remat_check("sd3", rm, attentions(frozen["mmdit"]))

    adv = sd3_bundle(remat=True, adv_targets=True)
    attach_lora(frozen["mmdit"], adv.lora)  # the same MMDiT on the adversarial list
    ag = sd3_adv_grad(adv, frozen, gen, seed)
    tr = ag["taps"]
    log("sd3-adv-grad", batch=2, taps=tr["taps"], tap_shapes=tr["shapes"],
        **{f"taps_{k}": "%.3e/%.3e" % tr[k] for k in ("all", "noise")},
        tap_bounds="max(2e-2,2*noise)", factors=ag["factors"], loss=f"{ag['loss']:.6f}",
        bounds="cos>=0.99,norm<=5e-2", peak_gib=f"{ag['peak_bytes'] / 2**30:.3f}",
        **{k: f"{c:.6f}/{e:.3e}" for k, (c, e) in ag["readings"].items()},
        counts=json.dumps(ag["counts"]))
    caps = [max(2e-2, 2 * n) for n in tr["noise"]]
    missing = [k for k in SD3_ADV_KERNELS if ag["counts"][k] == 0]
    if not (tr["finite"] and tr["taps"] == 24 and tr["shapes"] == [(2, 4096, 1536)]
            and all(e <= c for e, c in zip(tr["all"], caps)) and not ag["bad"]
            and ag["pos_embed"] and not missing
            and all(c >= 0.99 and e <= 5e-2 for c, e in ag["readings"].values())):
        raise AssertionError(f"SD3 adversarial gradients, kernels vs plain: {ag} (kernels not "
                             f"launched: {missing})")
    del frozen, template

    tw = sd3_towers(sd3, gen)
    log("sd3-towers", batch=4, shapes=tw["shapes"], finite=tw["finite"], ms=f"{tw['ms']:.3f}",
        t5_ms=f"{tw['t5_ms']:.3f}", t5_range="%.4f/%.4f" % tw["t5_range"],
        t5_rms=f"{tw['t5_rms']:.4f}", params_m=json.dumps(tw["params_m"]))
    if not (tw["finite"] and tw["shapes"] == ((4, 154, 4096), (4, 2048))):
        raise AssertionError(f"SD3 text towers: {tw}")

    vd = sd3_vae_decode(sd3, gen)
    log("sd3-vae", op="decode", batch=1, shape=vd["shape"],
        **{k: "%.3e/%.3e" % vd[k] for k in ("all", "noise")}, bounds="max(2e-2,2*noise)",
        ms=f"{vd['ms']:.3f}", peak_gib=f"{vd['peak_bytes'] / 2**30:.3f}",
        counts=json.dumps(vd["counts"]))
    caps = [max(2e-2, 2 * n) for n in vd["noise"]]
    if not (vd["finite"] and vd["shape"] == (1, XL_RES, XL_RES, 3)
            and all(e <= c for e, c in zip(vd["all"], caps))
            and vd["counts"]["flash_attention_fwd"] > 0 and vd["counts"]["group_norm_silu"] > 0):
        raise AssertionError(f"full-width SD3 VAE decode, kernels vs plain: {vd}")

    layers = sd3_adv_layers()
    tr = train_sd3_adv(lane.result("sd3-adv"), seed)
    for pairing, r in tr.items():
        rows = r["rows"]
        log("train-sd3-adv", pairing=pairing, batch=2, steps=[x["step"] for x in rows],
            losses=json.dumps([x.get("loss") for x in rows]),
            d_losses=json.dumps([x.get("d_loss") for x in rows]),
            step_ms=json.dumps([round(x["step_ms"], 1) for x in rows]),
            peak_gib=f"{max(x['peak_gib'] for x in rows):.3f}",
            lora_b_max=f"{r['lora_b_max']:.3e}", heads_moved=f"{r['heads_moved']:.3e}",
            updates=r["updates"], kohya_layers=len(r["kohya_layers"]),
            **{k: json.dumps([round(x[k], 4) for x in rows]) for k in HOST_COUNTERS},
            counts=json.dumps(r["counts"]))
        check_sd3_run(f"train-sd3-adv {pairing}", r, 4, layers, SD3_ADV_KERNELS)

    img_dir = "build/chip_smoke/images_xl"
    if not os.path.isdir(img_dir):
        write_xl_images(img_dir, seed)
    px = sd3_pixels(img_dir, seed)
    c, r = px["cache"], px["run"]
    log("sd3-pixels", cache_shapes=json.dumps(c["shapes"]), seconds=f"{c['seconds']:.1f}",
        cache_counts=json.dumps(c["counts"]), decoder=repr(r["decoder"]),
        steps=[x["step"] for x in r["rows"]], losses=json.dumps([x.get("loss") for x in r["rows"]]),
        d_losses=json.dumps([x.get("d_loss") for x in r["rows"]]),
        step_ms=json.dumps([round(x["step_ms"], 1) for x in r["rows"]]),
        peak_gib=f"{max(x['peak_gib'] for x in r['rows']):.3f}",
        lora_b_max=f"{r['lora_b_max']:.3e}", heads_moved=f"{r['heads_moved']:.3e}",
        **{k: json.dumps([round(x[k], 4) for x in r["rows"]]) for k in HOST_COUNTERS},
        counts=json.dumps(r["counts"]))
    if not (c["rc"] == 0 and c["finite"] and c["shapes"] == {
            "latents": (8, *SD3_LATENT), "prompt_embeds": (8, 154, 4096),
            "pooled_embeds": (8, 2048)}
            and c["counts"]["flash_attention_fwd"] > 0 and c["counts"]["group_norm_silu"] > 0):
        raise AssertionError(f"SD3 latent cache: {c}")
    check_sd3_run("sd3-pixels", r, 2, layers, (*SD3_ADV_KERNELS, "group_norm_silu"))

    sv = serve_sd3(tr["fused"]["kohya_path"], seed)
    log("sd3-serve", sizes=json.dumps(sv["sizes"]), same_seed_identical=sv["same_seed_identical"],
        template=json.dumps(sv["template"]), base_subset_differs=sv["base_subset_differs"],
        stochastic_same_seed_identical=sv["stochastic_same_seed_identical"],
        stochastic_sampler=sv["stochastic_sampler"],
        stochastic_differs=sv["stochastic_differs"], sigmas=json.dumps(sv["sigmas"]),
        student_batch_ms=json.dumps([round(x, 1) for x in sv["student_batch_ms"]]),
        teacher_batch_ms=json.dumps([round(x, 1) for x in sv["teacher_batch_ms"]]),
        stochastic_batch_ms=json.dumps([round(x, 1) for x in sv["stochastic_batch_ms"]]),
        student_peak_gib=f"{sv['student_peak_bytes'] / 2**30:.3f}",
        teacher_peak_gib=f"{sv['teacher_peak_bytes'] / 2**30:.3f}", lora=repr(sv["lora"]),
        student=json.dumps(sv["student_counts"]), teacher=json.dumps(sv["teacher_counts"]),
        stochastic=json.dumps(sv["stochastic_counts"]))
    if not (sv["sizes"] == {"f0": 4, "f1": 4, "f2": 4, "f3": 4, "p0": 2, "p1": 2}
            and sv["same_seed_identical"] and sv["differ"] and sv["header"] == (1024, 1024, 8, 2)
            and sv["template"]["factors"] == 2 * len(layers) and sv["template"]["pos_embed"]
            and sv["base_subset_differs"]
            and sv["stochastic_sampler"] and sv["stochastic_sizes"] == sv["sizes"]
            and sv["stochastic_same_seed_identical"] and sv["stochastic_differs"]
            and sv["teacher_shape"] == (4, 1024, 1024, 3)
            and all(c[k] > 0 for c in (sv["student_counts"], sv["teacher_counts"],
                                       sv["stochastic_counts"])
                    for k in ("flash_attention_fwd", "group_norm_silu"))
            and sv["lora"] == sv["stochastic_lora"] == tr["fused"]["kohya_path"]):
        raise AssertionError(f"SD3 serving: {sv}")
    return [st, rm, ag, vd, tr["fused"], tr["fresh"], c, r, sv]


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 24-26: hub weights, Prodigy with validation, generate
# ---------------------------------------------------------------------------

# the hub's SD1.5 layout: module -> (folder, file) as diffusers ships it
HUB_FILES = {"unet": ("unet", "diffusion_pytorch_model.safetensors"),
             "vae": ("vae", "diffusion_pytorch_model.safetensors"),
             "text": ("text_encoder", "model.safetensors")}
VALIDATION_PROMPTS = ("a photo of subject 3, red light", "a photo of subject 7, blue light")
GENERATE_PROMPTS = ("an astronaut riding a horse", "a red apple on a table",
                    "a lighthouse at dusk", "a bowl of soup")


def write_hub(frozen, out_dir: str) -> dict:
    """The seeded SD1.5 modules as a diffusers folder in BF16 (their bits,
    so the round trip is exact), CLIP's int64 ``position_ids`` beside;
    returns port_weights' flags."""
    import numpy as np

    from pcm_tpu_torch.utils.safetensors import save_file

    flags = []
    for module, (sub, name) in HUB_FILES.items():
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        bits = {k: v.contiguous().cpu().view(torch.int16).numpy().view(np.uint16)
                for k, v in frozen[module].state_dict().items()}
        tensors = dict(bits)
        if module == "text":
            tensors["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        save_file(tensors, os.path.join(out_dir, sub, name), bf16=tuple(bits))
        flags += [f"--{module}", os.path.join(out_dir, sub, "*.safetensors")]
    return flags


def port_hub_weights(seed: int, out_dir: str) -> dict:
    """Phase 24: the seeded full-width SD1.5 bundle written as a BF16 hub
    folder, ``python -m pcm_tpu_torch.port_weights --family sd15`` as a child
    process, the teacher file loaded as ``--teacher-checkpoint`` loads it: each
    state equal bit for bit and a UNet forward on the card (batch 2, the
    kernels) bit-identical to the seeded bundle's."""
    from pcm_tpu_torch.configs.families import sd15_bundle

    shutil.rmtree(out_dir, ignore_errors=True)
    bundle = sd15_bundle()
    gen = torch.Generator("cuda").manual_seed(seed)
    frozen, _ = bundle.init(gen, torch.device("cuda"))
    t0 = time.perf_counter()
    flags = write_hub(frozen, os.path.join(out_dir, "hub"))
    write_s = time.perf_counter() - t0
    teacher = os.path.join(out_dir, "teacher.pt")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "pcm_tpu_torch.port_weights", "--family", "sd15",
                          "--output", teacher, *flags], capture_output=True, text=True,
                         timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    port_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"port_weights: exit {res.returncode}:\n{res.stderr[-3000:]}")
    states = torch.load(teacher, weights_only=True)
    equal = all(torch.equal(states[m][k], v.cpu()) for m in HUB_FILES
                for k, v in frozen[m].state_dict().items())
    loaded = bundle.from_states(states, torch.device("cuda"))
    del states
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    cond = {"prompt_embeds": torch.randn((2, 77, 768), generator=gen, device="cuda").bfloat16()}
    t = torch.tensor([999.0, 421.0], device="cuda")
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, deterministic=True):
        out = bundle.teacher(frozen, x, t, cond)
        ours = bundle.teacher(loaded, x, t, cond)
    del frozen, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"teacher": teacher, "states_equal": equal, "unet_identical": torch.equal(out, ours),
            "finite": bool(torch.isfinite(ours).all()), "write_s": write_s, "port_s": port_s,
            "printed": res.stdout.strip().splitlines()[-1:],
            "file_gib": os.path.getsize(teacher) / 2 ** 30}


def _rows_of(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_prodigy(teacher: str, cache_dir: str, out_dir: str, seed: int) -> dict:
    """Phase 25: ``python -m pcm_tpu_torch.train --recipe sd15_4phase`` on
    phase 24's teacher and the phase-7 cache as a child process, batch 4,
    ``--optimizer prodigy --learning-rate 1.0``, validation (two prompts)
    and a checkpoint every 2 steps, 4 steps; then a rerun to 8 that resumes
    at 4 and is SIGTERM'd after its step-5 row. Checks the grids' shapes,
    ``prodigy_d``, the rerun's resume of Prodigy's state (its checkpoint's
    ``p0`` equal to the step-4 one's bit for bit, its count the step it
    stopped at) and the preempted row; returns the rows and the two
    processes' launches."""
    import numpy as np

    from pcm_tpu_torch.data.native_image import decode_png

    shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--recipe", "sd15_4phase", "--cached-latents-dir", cache_dir, "--output-dir",
            out_dir, "--teacher-checkpoint", teacher, "--batch-size", "4", "--seed", str(seed),
            "--log-every", "1", "--optimizer", "prodigy", "--learning-rate", "1.0",
            "--validation-steps", "2", "--validation-prompts", *VALIDATION_PROMPTS,
            "--checkpointing-steps", "2"]
    first = _train_process(argv + ["--max-train-steps", "4"])
    if first["rc"] != 0:
        raise AssertionError(f"prodigy run: exit {first['rc']}:\n"
                             + "\n".join(first["lines"][-30:]))
    rows = _rows_of(out_dir)
    grids = {}
    for name in sorted(os.listdir(os.path.join(out_dir, "images", "validation"))):
        with open(os.path.join(out_dir, "images", "validation", name), "rb") as f:
            grids[name] = decode_png(f.read()).shape
    second = _train_process(argv + ["--max-train-steps", "8"], stop_after_step=5)
    rows2 = _rows_of(out_dir)[len(rows):]
    stops = [r["step"] for r in rows2 if r.get("preempted")]
    ck4 = torch.load(os.path.join(out_dir, "checkpoints", "step_0000004.pt"), map_location="cpu",
                     weights_only=True)
    stop = stops[0] if stops else None
    resumed = None
    if stop is not None:
        ck = torch.load(os.path.join(out_dir, "checkpoints", f"step_{stop:07d}.pt"),
                        map_location="cpu", weights_only=True)
        resumed = {"count": ck["opt_state"]["count"],
                   "p0_equal": all(torch.equal(ck["opt_state"]["p0"][k], v)
                                   for k, v in ck4["opt_state"]["p0"].items()),
                   "d": float(ck["opt_state"]["d"]), "d4": float(ck4["opt_state"]["d"])}
    with open(os.path.join(out_dir, "launches.jsonl")) as f:
        runs = [json.loads(line) for line in f]
    counts = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    steps = [r for r in rows if "loss" in r]
    ms = {r["step"]: r["step_ms"] for r in steps}
    after = [s + 1 for s in (2,) if s + 1 in ms]  # the step after each save within the run
    steady = [ms[s] for s in ms if s > 1 and s not in after]
    return {"rows": steps, "validation_s": [r["validation_s"] for r in rows
                                           if "validation_s" in r],
            "grids": grids, "prodigy_d": [r.get("prodigy_d") for r in steps],
            "step_ms": ms, "after_save_ms": {s: ms[s] for s in after},
            "steady_ms": statistics.median(steady) if steady else float("nan"),
            **{k: [r[k] for r in steps] for k in ("save_s", "save_wait_s", "write_s")},
            "peak_gib": max(r["peak_gib"] for r in rows if "peak_gib" in r),
            "rerun_rc": second["rc"], "signalled": second["signalled"], "stop": stop,
            "resumed": resumed, "resumed_line": any("resumed at step 4" in ln
                                                    for ln in second["lines"]),
            "counts": counts, "finite": all(np.isfinite(r["loss"]) for r in steps)}


def _host(tree):
    """A synchronous host copy of a nested dict of tensors and numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _same(a, b) -> bool:
    """Equal trees: the same keys, and each leaf equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _saves_under_load(state, update, out_dir: str, saves: int) -> dict:
    """A `Trainer` holding ``state`` on the card saves ``saves`` times through
    its pinned twin and writer thread. Before each save about 0.3 s of
    products keep the card busy, so that the save's non-blocking copies
    queue behind them; right after it, three ``update(state, generator)``
    steps are enqueued; a second save comes while the first file is being
    written. The states saved are kept and read back at the end: each
    checkpoint must equal its own bit for bit (a write that read the twin
    before its copies landed, or while the next save's copies overwrote it,
    would not)."""
    from pcm_tpu_torch.train.loop import LoopConfig, Trainer

    shutil.rmtree(out_dir, ignore_errors=True)
    dev = torch.device("cuda")
    tr = Trainer(LoopConfig(output_dir=out_dir, max_train_steps=0, resume=False,
                            checkpoints_total_limit=None),
                 None, state, None, None, None, dev)
    tr._saved_state()  # the pinned twin, made as a run's first save makes it
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    b = torch.empty_like(a)
    paths, held, save_s = [], [], []
    for _ in range(saves):
        tr.global_step += 1
        held.append((tr.state, tr.generator.get_state()))
        for _ in range(200):
            torch.mm(a, a, out=b)
        t0 = time.perf_counter()
        paths.append(tr.save())
        save_s.append(time.perf_counter() - t0)
        for _ in range(3):
            tr.state = update(tr.state, tr.generator)
    tr.writer.wait()
    saves = []
    for i, (path, (st, gen_state)) in enumerate(zip(paths, held)):
        got = torch.load(path, map_location="cpu", weights_only=True)
        want = {"lora": _host(st.params), "opt_state": _host(st.opt_state),
                "generator": gen_state, "lora_step": st.step}
        saves.append({"save_s": save_s[i], "step": got["step"] == i + 1,
                      "equal": {k: _same(got[k], v) for k, v in want.items()}})
    res = {"saves": saves, "moved": not _same(_host(tr.state.params), _host(held[-1][0].params)),
           "write_s": tr.writer.seconds}
    del tr, held, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return res


def save_order(ck_path: str, out_dir: str) -> dict:
    """Phase 25b: `_saves_under_load` once on the LoRA and Prodigy state of
    ``ck_path`` (phase 25's step 4, ~2800 tensors) with Prodigy updates on
    gradients drawn from the trainer's generator, and twice on two 256-MiB
    tensors: the stream's queue holds their copies whole, so the writer
    starts while they still wait behind the products (~2800 copies fill
    the queue, and the step thread waits for the card until they land).
    One save of the Prodigy state keeps the smoke's disk writes low."""
    from pcm_tpu_torch.train.state import TrainState, apply_updates, make_optimizer

    dev = torch.device("cuda")
    ck = torch.load(ck_path, map_location=dev, weights_only=True)
    tx = make_optimizer(1.0, optimizer="prodigy")

    def prodigy(st, gen):
        return apply_updates(st, {k: 1e-3 * torch.randn(p.shape, generator=gen, device=dev)
                                  for k, p in st.params.items()}, tx)

    def shift(st, gen):
        return TrainState(st.step + 1, {k: p + torch.randn(p.shape, generator=gen, device=dev)
                                        for k, p in st.params.items()}, st.opt_state)

    res = {"prodigy": _saves_under_load(
               TrainState(int(ck["lora_step"]), ck["lora"], ck["opt_state"]), prodigy,
               os.path.join(out_dir, "prodigy"), saves=1),
           "tensors": len(ck["lora"]) + sum(len(v) if isinstance(v, dict) else 1
                                            for v in ck["opt_state"].values())}
    del ck
    big = {"big.lora_a": torch.randn((64, 1 << 20), device=dev),
           "big.lora_b": torch.randn((1 << 20, 64), device=dev)}
    res["large"] = _saves_under_load(TrainState(0, big, {"count": 0}), shift,
                                     os.path.join(out_dir, "large"), saves=2)
    return res


def generate_phase(teacher: str, lora: str, out_dir: str, seed: int) -> dict:
    """Phase 26: ``python -m pcm_tpu_torch.generate``'s ``main`` on phase 24's
    teacher, batch 4 (four prompts), 4 steps: the phase-25 step-4 LoRA with
    ``--scheduler tcd`` (twice: the PNG bytes) and ``ddim``, and the teacher
    at ``--cfg 7.5`` (K5); each one's steady batch latency (median of 3
    synchronized calls after ``main``'s), and, launches aside, its final
    latents with the kernels against all plain versions beside the
    yardstick (the all-plain run from noise scaled by 1 + 2**-8)."""
    from pcm_tpu_torch import generate
    from pcm_tpu_torch.ops import launch_counts, reference_ops, reset_launch_counts

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    base = ["--family", "sd15", "--teacher-checkpoint", teacher, "--prompt", *GENERATE_PROMPTS,
            "--steps", "4", "--seed", str(seed)]
    configs = {"tcd": ["--lora", lora, "--scheduler", "tcd"],
               "ddim": ["--lora", lora, "--scheduler", "ddim"], "teacher": ["--cfg", "7.5"]}
    res = {"counts": {}, "configs": {}}

    def add(counts):
        for k, v in counts.items():
            res["counts"][k] = res["counts"].get(k, 0) + v

    for name, extra in configs.items():
        gc.collect()
        torch.cuda.empty_cache()
        out = os.path.join(out_dir, name + ".png")
        reset_launch_counts()
        r = generate.main(base + extra + ["--out", out])
        built, args = r["built"], r["args"]
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate.generate(built, args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1000.0)
        files = generate.output_paths(out, len(GENERATE_PROMPTS))
        first = [open(p, "rb").read() for p in files]
        same = None
        if name == "tcd":
            generate.main(base + extra + ["--out", out])
            same = [open(p, "rb").read() for p in files] == first
        counts = launch_counts()
        add(counts)
        with torch.inference_mode():
            lat = generate.generate(built, args, decode=False)
            init, gens = generate.noise(built, args)
            with reference_ops():
                ref = generate.generate(built, args, False, (init, gens))
                init, gens = generate.noise(built, args)
                nudged = generate.generate(built, args, False, (init * (1 + 2 ** -8), gens))
        reset_launch_counts()
        res["configs"][name] = {
            "main_ms": r["ms"], "ms": ms, "same_bytes": same, "counts": counts,
            "all": (rel_max(lat, ref), rel_l2(lat, ref)),
            "noise": (rel_max(nudged, ref), rel_l2(nudged, ref)),
            "finite": bool(torch.isfinite(lat).all()), "png_bytes": [len(b) for b in first]}
        del built, r
    return res


def hub_phases(seed: int) -> list:
    """Phases 24-26, each checked; returns the runs whose launches count."""
    root = "build/chip_smoke"
    pw = port_hub_weights(seed, os.path.join(root, "hub_sd15"))
    log("port-weights", states_equal=pw["states_equal"], unet_identical=pw["unet_identical"],
        write_s=f"{pw['write_s']:.2f}", port_s=f"{pw['port_s']:.2f}",
        file_gib=f"{pw['file_gib']:.3f}", printed=repr(pw["printed"]))
    if not (pw["states_equal"] and pw["unet_identical"] and pw["finite"]):
        raise AssertionError(f"hub weights through port_weights: {pw}")

    tp = train_prodigy(pw["teacher"], os.path.join(root, "cache"),
                       os.path.join(root, "train_prodigy"), seed)
    log("train-prodigy", losses=json.dumps([round(r["loss"], 6) for r in tp["rows"]]),
        prodigy_d=json.dumps(tp["prodigy_d"]),
        step_ms=json.dumps({k: round(v, 1) for k, v in tp["step_ms"].items()}),
        after_save_ms=json.dumps({k: round(v, 1) for k, v in tp["after_save_ms"].items()}),
        steady_ms=f"{tp['steady_ms']:.1f}",
        **{k: json.dumps([round(x, 4) for x in tp[k]]) for k in ("save_s", "save_wait_s",
                                                                 "write_s")},
        validation_s=json.dumps([round(x, 3) for x in tp["validation_s"]]),
        peak_gib=f"{tp['peak_gib']:.3f}", grids=json.dumps(tp["grids"]),
        stop=tp["stop"], resumed=json.dumps(tp["resumed"]), counts=json.dumps(tp["counts"]))
    grid = (2 * 512, 4 * 512, 3)
    if not (tp["finite"] and tp["grids"] == {f"cfg{g}_{s:07d}.png": grid for g in ("1", "7.5")
                                              for s in (2, 4)}
            and all(d is not None and math.isfinite(d) for d in tp["prodigy_d"])
            and len(tp["rows"]) == 4 and tp["rerun_rc"] == 0 and tp["signalled"]
            and tp["resumed_line"] and tp["stop"] in (5, 6, 7) and tp["resumed"] is not None
            and tp["resumed"]["p0_equal"] and tp["resumed"]["count"] == tp["stop"]
            and tp["resumed"]["d"] >= tp["resumed"]["d4"]
            and all(tp["counts"][k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                                  "flash_attention_bwd_dq", "group_norm_silu",
                                                  "geglu"))):
        raise AssertionError(f"Prodigy training with validation: {tp}")

    so = save_order(os.path.join(root, "train_prodigy", "checkpoints", "step_0000004.pt"),
                    os.path.join(root, "save_order"))
    log("save-order", tensors=so["tensors"], **{k: json.dumps(so[k]) for k in ("prodigy", "large")})
    if not all(r["moved"] and all(all(v["equal"].values()) and v["step"] for v in r["saves"])
               for r in (so["prodigy"], so["large"])):
        raise AssertionError(f"asynchronous save of the step's state: {so}")

    lora = os.path.join(root, "train_prodigy", "pcm_lora_0000004.safetensors")
    gp = generate_phase(pw["teacher"], lora, os.path.join(root, "generate"), seed)
    for name, c in gp["configs"].items():
        log("generate", config=name, batch=len(GENERATE_PROMPTS), steps=4,
            batch_ms=json.dumps([round(x, 1) for x in c["ms"]]), main_ms=f"{c['main_ms']:.1f}",
            **{k: "%.3e/%.3e" % c[k] for k in ("all", "noise")}, bounds="max(2e-2,2*noise)",
            same_png_bytes=c["same_bytes"], counts=json.dumps(c["counts"]))
        caps = [max(2e-2, 2 * n) for n in c["noise"]]
        if not (c["finite"] and all(e <= cap for e, cap in zip(c["all"], caps))
                and c["counts"]["flash_attention_fwd"] > 0 and c["counts"]["group_norm_silu"] > 0
                and (name != "teacher" or c["counts"]["geglu"] > 0)
                and (name != "tcd" or c["same_bytes"])):
            raise AssertionError(f"generate {name}: {c}")
    return [tp, gp]


# ---------------------------------------------------------------------------
# phase eval: the numpy image decoders, CLIP-FID, CLIP score and the demo
# ---------------------------------------------------------------------------

FIXTURES = "tests/fixtures/torch_images"  # made with PIL by tests/make_torch_image_fixtures.py
# phase eval (c): the card's ViT-L/14 features against the CPU's, both fp32
# without TF32, rel-max to the largest CPU feature
VISION_BOUND = 1e-3
DEMO_PROMPT = "a lighthouse on a cliff at dusk"


def check_fixtures() -> dict:
    """Phase eval (a): every committed JPEG and BMP fixture through the numpy
    decoders against its PIL golden (`goldens.npz` stores each row-differenced
    mod 256), max and mean LSB; the 512-px JPEG's decode ms (median of 5)."""
    import numpy as np

    from pcm_tpu_torch.data.native_image import load_rgb

    stored = np.load(os.path.join(FIXTURES, "goldens.npz"))
    diffs = {}
    for name in sorted(stored.files):
        ref = np.cumsum(stored[name], axis=1, dtype=np.uint8)
        ours = load_rgb(os.path.join(FIXTURES, name))
        d = np.abs(ours.astype(np.int32) - ref.astype(np.int32)) if ours.shape == ref.shape \
            else np.full(1, 255)
        diffs[name] = (int(d.max()), float(d.mean()))
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        load_rgb(os.path.join(FIXTURES, "photo512.jpg"))
        ms.append((time.perf_counter() - t0) * 1000.0)
    return {"diffs": diffs, "jpeg512_ms": statistics.median(ms), "jpeg512_all_ms": ms}


def write_eval_images(out_dir: str) -> str:
    """The fixture JPEGs and a BMP with sidecar captions: a folder of
    formats the port read as PNG only before (phase eval (b) trains on it)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    names = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg")) + ["b24.bmp"]
    for i, name in enumerate(names):
        shutil.copy(os.path.join(FIXTURES, name), os.path.join(out_dir, name))
        with open(os.path.join(out_dir, os.path.splitext(name)[0] + ".txt"), "w") as f:
            f.write(f"a photo of subject {i}, {['red', 'blue', 'green'][i % 3]} light")
    return out_dir


def train_jpeg(img_dir: str, out_dir: str, seed: int) -> dict:
    """Phase eval (b): ``python -m pcm_tpu_torch.train --recipe sd15_4phase
    --train-data-dir`` on the JPEG + BMP folder as a child process, full
    width, batch 4, 2 steps, a save at 2."""
    shutil.rmtree(out_dir, ignore_errors=True)
    run = _train_process(["--recipe", "sd15_4phase", "--train-data-dir", img_dir, "--output-dir",
                          out_dir, "--batch-size", "4", "--max-train-steps", "2",
                          "--checkpointing-steps", "2", "--log-every", "1", "--seed", str(seed),
                          "--allow-hash-tokenizer", "--learning-rate", PIXEL_LR,
                          "--dataloader-workers", "4"])
    if run["rc"] != 0:
        raise AssertionError(f"train from JPEGs: exit {run['rc']}:\n"
                             + "\n".join(run["lines"][-30:]))
    steps = [r for r in _rows_of(out_dir) if "loss" in r]
    with open(os.path.join(out_dir, "launches.jsonl")) as f:
        runs = [json.loads(line) for line in f]
    from pcm_tpu_torch.utils.safetensors import load_file

    kohya = load_file(os.path.join(out_dir, "pcm_lora_0000002.safetensors"), bf16_as_f32=True)
    decoder = [ln for ln in run["lines"] if " decoder" in ln and ln.startswith("# ")]
    _drop_checkpoints(out_dir)
    return {"rows": steps, "counts": {k: sum(r["launches"][k] for r in runs)
                                      for k in runs[0]["launches"]},
            "up_max": max(float(abs(v).max()) for k, v in kohya.items() if "lora_up" in k),
            "decoder": decoder[0][2:] if decoder else "not printed"}


def _gen_images(paths) -> "np.ndarray":
    import numpy as np

    from pcm_tpu_torch.data.native_image import load_rgb

    return np.stack([load_rgb(p).astype(np.float32) / 127.5 - 1.0 for p in paths])


def vision_tower(out_dir: str, images, seed: int) -> dict:
    """Phase eval (c): a ViT-L/14 tower drawn from ``seed`` written in HF
    naming (`utils/safetensors.save_file`), read back through
    `CLIPFeatures.from_torch_file` on the card and on the CPU; the card's
    features of ``images`` against the CPU's (rel-max to the largest), the
    ms of a batch of 32 at 224 px (CUDA events) and the peak."""
    import numpy as np

    from pcm_tpu_torch.models.clip_vision import CLIP_VIT_L14_CONFIG, CLIPVisionModel
    from pcm_tpu_torch.utils.fid import CLIPFeatures, fp32_exact, seeded
    from pcm_tpu_torch.utils.safetensors import save_file

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "clip_vit_l14_vision.safetensors")
    with torch.device("cuda"):
        tower = seeded(CLIPVisionModel(CLIP_VIT_L14_CONFIG), seed, torch.device("cuda"))
    state = {k: v.cpu().numpy() for k, v in tower.state_dict().items()}
    params = sum(v.size for v in state.values())
    del tower
    t0 = time.perf_counter()
    save_file(state, path)
    write_s = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card = CLIPFeatures.from_torch_file(path, device="cuda")
    feats = card(images)
    cpu_feats = CLIPFeatures.from_torch_file(path, device="cpu")(images)
    x = torch.randn((32, 3, 224, 224), generator=torch.Generator("cuda").manual_seed(seed),
                    device="cuda")
    with torch.inference_mode(), fp32_exact():
        ms = cuda_ms(lambda: card.model(x), iters=5, warmup=1)
    err = float(np.abs(feats - cpu_feats).max() / np.abs(cpu_feats).max())
    res = {"path": path, "params_m": params / 1e6, "write_s": write_s, "rel_max": err,
           "shape": feats.shape, "batch32_ms": ms, "features": feats,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(np.isfinite(feats).all())}
    del card, x
    gc.collect()
    torch.cuda.empty_cache()
    return res


def eval_clis(png_dir: str, jpeg_dir: str, gen_paths, clip_weights: str, out_dir: str) -> dict:
    """Phase eval (d): ``python -m pcm_tpu_torch.eval_fid``'s ``main`` in
    images mode with ``--clip-weights`` between the PNG folder and the JPEG
    folder, and the PNG folder against itself; ``eval_clip_score``'s on
    phase 26's images and prompts."""
    import numpy as np

    from pcm_tpu_torch import eval_clip_score, eval_fid

    t0 = time.perf_counter()
    ab = eval_fid.main(["--image-dir-a", png_dir, "--image-dir-b", jpeg_dir, "--clip-weights",
                        clip_weights])
    aa = eval_fid.main(["--image-dir-a", png_dir, "--image-dir-b", png_dir, "--clip-weights",
                        clip_weights])
    fid_s = time.perf_counter() - t0
    score_dir = os.path.join(out_dir, "clip_score")
    shutil.rmtree(score_dir, ignore_errors=True)
    os.makedirs(score_dir)
    for p in gen_paths:
        shutil.copy(p, score_dir)
    with open(os.path.join(out_dir, "prompts.txt"), "w") as f:
        f.write("\n".join(GENERATE_PROMPTS) + "\n")
    t0 = time.perf_counter()
    score = eval_clip_score.main(["--image-dir", score_dir, "--prompts-file",
                                  os.path.join(out_dir, "prompts.txt"), "--vision-weights",
                                  clip_weights])
    trace = float(np.trace(np.cov(aa["features"][0], rowvar=False)))
    return {"fid": ab["fid"], "n": (len(ab["features"][0]), len(ab["features"][1])),
            "self_fid": aa["fid"], "trace": trace, "fid_s": fid_s, "clip_score": score,
            "clip_score_s": time.perf_counter() - t0}


def _demo_run(argv, out_dir: str) -> tuple:
    """``python -m pcm_tpu_torch.demo``'s ``main`` with ``DEMO_PROMPT`` on
    stdin, in ``out_dir``: (demo_out.png's bytes, its launches, seconds)."""
    import io

    from pcm_tpu_torch import demo
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts

    os.makedirs(out_dir, exist_ok=True)
    cwd, stdin = os.getcwd(), sys.stdin
    os.chdir(out_dir)
    sys.stdin = io.StringIO(DEMO_PROMPT + "\n")
    t0 = time.perf_counter()
    try:
        reset_launch_counts()
        demo.main(argv)
        counts = launch_counts()
        reset_launch_counts()
    finally:
        os.chdir(cwd)
        sys.stdin = stdin
    with open(os.path.join(out_dir, "demo_out.png"), "rb") as f:
        return f.read(), counts, time.perf_counter() - t0


def demo_phase(teacher: str, lora: str, clip_weights: str, out_dir: str, seed: int) -> dict:
    """Phase eval (e): the demo's CLI loop on phase 24's teacher with phase
    25's step-4 LoRA under the 2-Step name, one prompt: its image against
    ``generate``'s (the LoRA, 2 DDIM steps, guidance 1, seed 0) bit for bit;
    then with the safety checker on two npz files drawn from that image's own
    CLIP feature: a concept equal to it (flagged: black) and its opposite
    (passed: the same image)."""
    import numpy as np

    from pcm_tpu_torch import demo, generate
    from pcm_tpu_torch.utils.fid import CLIPFeatures

    # absolute: the demo runs in a directory of its own
    teacher, lora, clip_weights, out_dir = map(os.path.abspath,
                                               (teacher, lora, clip_weights, out_dir))
    shutil.rmtree(out_dir, ignore_errors=True)
    loras = os.path.join(out_dir, "loras")
    os.makedirs(loras)
    shutil.copy(lora, os.path.join(loras, demo.CHECKPOINT_REGISTRY["2-Step"][0].format(
        family="sd15")))
    base = ["--family", "sd15", "--teacher-checkpoint", teacher, "--lora-dir", loras]
    plain, counts, plain_s = _demo_run(base, os.path.join(out_dir, "plain"))
    out = os.path.join(out_dir, "generate.png")
    r = generate.main(["--family", "sd15", "--teacher-checkpoint", teacher, "--lora", lora,
                       "--prompt", DEMO_PROMPT, "--steps", "2", "--scheduler", "ddim", "--cfg",
                       "1.0", "--seed", "0", "--out", out])
    with open(out, "rb") as f:
        gen_png = f.read()
    with torch.inference_mode():
        img = generate.generate(r["built"], r["args"]).float().cpu().numpy()
    del r
    gc.collect()
    feat = CLIPFeatures.from_torch_file(clip_weights, device="cuda")(img[:1])[0]
    unit = feat / np.linalg.norm(feat)
    checked = {}
    for name, sign in (("flag", 1.0), ("pass", -1.0)):
        npz = os.path.join(out_dir, f"{name}.npz")
        np.savez(npz, concept_embeds=sign * unit[None],
                 concept_embeds_weights=np.full((1,), 0.5, np.float32),
                 special_care_embeds=-unit[None],
                 special_care_embeds_weights=np.full((1,), 0.5, np.float32))
        checked[name] = _demo_run(base + ["--safety-concepts", npz, "--safety-clip-weights",
                                          clip_weights], os.path.join(out_dir, name))
    from pcm_tpu_torch.data.native_image import decode_png

    flagged = decode_png(checked["flag"][0])
    gc.collect()
    torch.cuda.empty_cache()
    return {"equal_generate": plain == gen_png, "counts": counts, "plain_s": plain_s,
            "flagged_black": flagged.shape == (512, 512, 3) and not flagged.any(),
            "passed_equal": checked["pass"][0] == plain,
            "safety_s": [checked[k][2] for k in ("flag", "pass")],
            "safety_counts": [checked[k][1] for k in ("flag", "pass")],
            "image_nonzero": bool(decode_png(plain).any())}


def eval_phases(seed: int, lane: Lane) -> list:
    """Phase eval, each part checked; returns the runs whose launches count.
    The training from JPEGs is the lane's ``train-jpeg`` run (`train_jpeg`),
    checked last."""
    import numpy as np

    root = "build/chip_smoke"
    t_phase = time.perf_counter()
    fx = check_fixtures()
    log("eval-decode", fixtures=len(fx["diffs"]), diffs=json.dumps(fx["diffs"]),
        bound="max<=3,mean<0.5", jpeg512_ms=f"{fx['jpeg512_ms']:.1f}",
        jpeg512_all_ms=json.dumps([round(t, 1) for t in fx["jpeg512_all_ms"]]))
    if not all(m <= 3 and a < 0.5 for m, a in fx["diffs"].values()):
        raise AssertionError(f"numpy decoders against the PIL goldens: {fx['diffs']}")

    jpeg_dir = os.path.join(root, "eval_images")  # written before the lane's JPEG run
    gen_paths = [os.path.join(root, "generate", f"tcd_{i}.png")
                 for i in range(len(GENERATE_PROMPTS))]
    vt = vision_tower(os.path.join(root, "eval"), _gen_images(gen_paths), seed)
    log("eval-vision", params_m=f"{vt['params_m']:.1f}", write_s=f"{vt['write_s']:.2f}",
        shape=vt["shape"], rel_max=f"{vt['rel_max']:.3e}", bound=VISION_BOUND,
        batch32_ms=f"{vt['batch32_ms']:.2f}", peak_gib=f"{vt['peak_gib']:.3f}")
    if not (vt["finite"] and vt["shape"] == (len(gen_paths), 768)
            and vt["rel_max"] <= VISION_BOUND):
        raise AssertionError(f"the ViT-L/14 tower, card against CPU: {vt}")

    ev = eval_clis(os.path.join(root, "images"), jpeg_dir, gen_paths, vt["path"],
                   os.path.join(root, "eval"))
    log("eval-clis", fid=f"{ev['fid']:.4f}", n=ev["n"], self_fid=f"{ev['self_fid']:.3e}",
        trace=f"{ev['trace']:.4f}", self_bound="1e-5*trace", fid_s=f"{ev['fid_s']:.2f}",
        clip_score=f"{ev['clip_score']:.4f}", clip_score_s=f"{ev['clip_score_s']:.2f}")
    if not (np.isfinite(ev["fid"]) and ev["fid"] > 0 and abs(ev["self_fid"]) <= 1e-5 * ev["trace"]
            and ev["n"] == (PIXEL_IMAGES, len(os.listdir(jpeg_dir)) // 2)
            and 0.0 <= ev["clip_score"] <= 100.0):
        raise AssertionError(f"the eval CLIs: {ev}")

    dm = demo_phase(os.path.join(root, "hub_sd15", "teacher.pt"),
                    os.path.join(root, "train_prodigy", "pcm_lora_0000004.safetensors"),
                    vt["path"], os.path.join(root, "demo"), seed)
    log("eval-demo", equal_generate=dm["equal_generate"], flagged_black=dm["flagged_black"],
        passed_equal=dm["passed_equal"], plain_s=f"{dm['plain_s']:.2f}",
        safety_s=json.dumps([round(s, 2) for s in dm["safety_s"]]),
        counts=json.dumps(dm["counts"]))
    if not (dm["equal_generate"] and dm["flagged_black"] and dm["passed_equal"]
            and dm["image_nonzero"] and dm["counts"]["flash_attention_fwd"] > 0
            and dm["counts"]["group_norm_silu"] > 0):
        raise AssertionError(f"the demo: {dm}")
    os.remove(vt["path"])  # 1.2 GB: the smoke's disk is bounded

    tj = lane.result("train-jpeg")
    log("eval-train-jpeg", decoder=repr(tj["decoder"]),
        losses=json.dumps([round(r["loss"], 6) for r in tj["rows"]]),
        step_ms=json.dumps([round(r["step_ms"], 1) for r in tj["rows"]]),
        peak_gib=f"{max(r['peak_gib'] for r in tj['rows']):.3f}",
        lora_up_max=f"{tj['up_max']:.3e}", counts=json.dumps(tj["counts"]))
    missing = [k for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                           "flash_attention_bwd_dq", "group_norm_silu", "geglu")
               if tj["counts"][k] == 0]
    if not (len(tj["rows"]) == 2 and all(math.isfinite(r["loss"]) for r in tj["rows"])
            and tj["up_max"] > 0 and not missing):
        raise AssertionError(f"training from JPEGs: {tj} (kernels not launched: {missing})")
    log("eval", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return [tj, {"counts": {k: dm["counts"][k] + sum(c[k] for c in dm["safety_counts"])
                            for k in dm["counts"]}}]


# ---------------------------------------------------------------------------
# phases 27-30: int8 frozen weights on every family and recipe
# ---------------------------------------------------------------------------

TRAJ_STEPS = 12  # phase 27's global steps a run: 6 D and 6 G updates (fresh pairing)
# phase 30: `QConvFn`'s dx against autograd of the dequantized conv, rel-max to
# the tensor's largest entry: two bf16 ulps (the two may sum in other orders)
CONV_DX_BOUND = 2 ** -7
INT8 = ("--frozen-weights", "int8", "--int8-matmul")


def _dir_gib(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs) / 2**30


def _drop_checkpoints(run_dir: str) -> float:
    """Delete a finished run's checkpoints (nothing reads them again; the
    smoke's disk is bounded) and return their GiB."""
    path = os.path.join(run_dir, "checkpoints")
    gib = _dir_gib(path)
    shutil.rmtree(path, ignore_errors=True)
    return gib


def _per_point(a: list, b: list, key: str) -> tuple:
    """(max, mean) over the steps both runs logged of |a - b| / |b| for ``key``."""
    ra = {r["step"]: r[key] for r in a if key in r}
    rb = {r["step"]: r[key] for r in b if key in r}
    d = [abs(ra[s] - rb[s]) / max(abs(rb[s]), 1e-12) for s in sorted(set(ra) & set(rb))]
    return (max(d), sum(d) / len(d)) if d else (math.nan, math.nan)


def int8_trajectory(cache_dir: str, seed: int) -> dict:
    """Phase 27: ``sd15_2phase_adv`` from phase 7's cache, batch 4, fresh
    pairing, one seed, for `TRAJ_STEPS` global steps on int8 frozen weights
    under ``fused`` and on bf16 ones; the gate is `scripts/compare_runs.py`
    on their metrics (its default 5 % final-window threshold). Then 2 steps
    under ``scoped`` and under ``dense``. Every run is checked as phase 11's
    are (`train_adv`); K6 launched in the ``fused`` run alone."""
    root = "build/chip_smoke"
    runs, ck_gib = {}, {}
    for tag, extra, steps in (("int8_fused", INT8 + ("fused",), TRAJ_STEPS),
                              ("bf16", (), TRAJ_STEPS), ("int8_scoped", INT8 + ("scoped",), 2),
                              ("int8_dense", INT8 + ("dense",), 2)):
        out = os.path.join(root, f"int8_adv_{tag}")
        runs[tag] = train_adv(f"int8-adv {tag}", "sd15_2phase_adv", cache_dir, out, seed, 4,
                              "fresh", steps, extra=extra)
        runs[tag]["dir"] = out
        ck_gib[tag] = _drop_checkpoints(out)
    metrics = [os.path.join(runs[t]["dir"], "metrics.jsonl") for t in ("int8_fused", "bf16")]
    cmp = subprocess.run([sys.executable, "scripts/compare_runs.py", *metrics, "--label-a",
                          "int8_fused", "--label-b", "bf16"], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    a, b = runs["int8_fused"]["rows"], runs["bf16"]["rows"]
    return {"runs": runs, "compare_rc": cmp.returncode,
            "compare": [ln for ln in (cmp.stdout + cmp.stderr).splitlines()
                        if ln.startswith(("- per-point", "- final", "OK", "DIVERGED"))],
            "loss": _per_point(a, b, "loss"), "d_loss": _per_point(a, b, "d_loss"),
            "checkpoint_gib": ck_gib}


SD3_INT8_DIR = "build/chip_smoke/sd3_adv_int8"


def sd3_int8_argv(cache_dir: str, seed: int) -> list:
    """Phase 29's training: ``sd3_4phase_adv --frozen-weights int8
    --int8-matmul fused`` on ``cache_dir``, fused pairing, batch 2, 2 global
    steps, a checkpoint at 2 (a lane run, `_adv_run`)."""
    return ["--recipe", "sd3_4phase_adv", "--cached-latents-dir", cache_dir, "--batch-size", "2",
            "--max-train-steps", "2", "--checkpointing-steps", "2", "--log-every", "1", "--seed",
            str(seed), "--adv-pairing", "fused", *INT8, "fused"]


def sd3_int8(lora_path: str, seed: int, gen, lane: Lane) -> dict:
    """Phase 29: ``serving --family sd3 --weights int8 --lora <file>``
    (`_serve_family`: a full batch and a partial one, batch ms, peak) and the
    bytes its int8 weights save; its MMDiT at batch 2 under ``fused`` against
    K6's plain version alone (bit for bit) and every plain version (phase
    19's rule); then the readings of the lane's ``sd3-int8-train`` run
    (`sd3_int8_argv`)."""
    from pcm_tpu_torch.utils.quant import quantized_bytes_saved

    engine, sv = _serve_family("sd3", lora_path, seed, 500, "--weights", "int8")
    out = {"serve": sv, "bytes_saved": quantized_bytes_saved(engine.frozen),
           "int8_params_m": {k: round(sum(b.numel() for n, b in m.named_buffers()
                                          if n.endswith("weight_values")) / 1e6, 1)
                             for k, m in engine.frozen.items()}}
    out["mmdit"] = sd3_mmdit_vs_reference(engine.bundle, engine.frozen, gen, int8=True)
    del engine
    out["train"] = _adv_read(lane.result("sd3-int8-train"), SD3_INT8_DIR, seed, "sd3", saves=(2,))
    out["checkpoint_gib"] = _drop_checkpoints(SD3_INT8_DIR)
    return out


def int8_conv(gen) -> dict:
    """Phase 30: the full-width SD1.5 UNet on int8 weights at batch 4, one
    forward under ``both``, ``conv``, ``fused`` and with no int8 mode (the
    dequantized weights); each output's error against the dequantized one,
    CUDA-event ms and launches. The backward under ``both``: at every
    quantized conv, on its input in the dequantized forward, `QConvFn`'s ``dx`` of a
    seeded cotangent against autograd of the conv on the weight dequantized
    to bf16 (``conv_dx``); and, as a reading, the gradient of a fixed
    projection of the whole output to the latents against ``dense``'s
    (whose convs dequantize; every int8 path's backward is the dequantized
    product, but the nonlinear layers' backward reads the forward's
    activations, which differ), beside ``dense`` on the latents nudged by
    half a bf16 step (``grad_noise``)."""
    import warnings

    import torch.nn.functional as F

    from pcm_tpu_torch.configs.families import sd15_bundle
    from pcm_tpu_torch.lora.layers import LoRAConv
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.utils.quant import int8_matmul, quantize_frozen, quantized_conv

    bundle = sd15_bundle()
    frozen, _ = bundle.init(gen, torch.device("cuda"))
    quantize_frozen(frozen)
    x = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((4,), 801.0, device="cuda")
    cond = {"prompt_embeds": bf16_randn((4, 77, 768), gen)}
    proj = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    res = {"out": {}, "ms": {}, "counts": {}}

    def mode(m):
        return int8_matmul(m) if m else contextlib.nullcontext()

    convs = {n: m for n, m in frozen["unet"].named_modules()
             if isinstance(m, LoRAConv) and m.qweight() is not None}
    inputs = {}

    def keep_input(name):
        def hook(module, args, out):
            inputs.setdefault(name, args[0])  # returns None: the output stays
        return hook

    hooks = [m.register_forward_hook(keep_input(n)) for n, m in convs.items()]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # conv / both warn, as in the JAX package
        with torch.no_grad():
            ref = bundle.teacher(frozen, x, t, cond).float()  # and every conv's input
            for h in hooks:
                h.remove()
            for m in ("both", "conv", "fused"):
                with mode(m):
                    reset_launch_counts()
                    y = bundle.teacher(frozen, x, t, cond).float()
                    torch.cuda.synchronize()
                    res["counts"][m] = launch_counts()
                    res["out"][m] = (rel_max(y, ref), rel_l2(y, ref),
                                     bool(torch.isfinite(y).all()))
            for m in ("both", "conv", "fused", None):
                with mode(m):
                    res["ms"][m or "dequant"] = cuda_ms(
                        lambda: bundle.teacher(frozen, x, t, cond), iters=5, warmup=1)

        errs = []
        for n, inp in inputs.items():
            layer, qt = convs[n], convs[n].qweight()
            a = inp.detach().clone().requires_grad_(True)
            with int8_matmul("conv"):
                out = quantized_conv(a, qt, None, layer.stride, layer.padding)
            g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            (dx,) = torch.autograd.grad(out, [a], g)
            b = inp.detach().clone().requires_grad_(True)
            (dref,) = torch.autograd.grad(
                F.conv2d(b, qt.astype(b.dtype), None, layer.stride, layer.padding), [b], g)
            errs.append(rel_max(dx, dref))
        res["conv_dx"] = (len(errs), max(errs))

        def grad(m, lat):
            lat = lat.clone().requires_grad_(True)
            with mode(m):
                y = bundle.teacher(frozen, lat, t, cond)
                (g,) = torch.autograd.grad((y.float() * proj).sum(), [lat])
            return g

        g_both, g_dense = grad("both", x), grad("dense", x)
        g_noise = grad("dense", x * (1 + 2 ** -8))
    res["grad"] = (rel_max(g_both, g_dense), rel_l2(g_both, g_dense))
    res["grad_noise"] = (rel_max(g_noise, g_dense), rel_l2(g_noise, g_dense))
    res["grad_finite"] = bool(torch.isfinite(g_both).all())
    return res


def int8_phases(seed: int, gen, cache_dir: str, xl_cache: str, xl_bf16: dict,
                sd3_serve: dict, lane: Lane) -> list:
    """Phases 27-30, each checked; returns the runs whose launches count.
    ``xl_bf16``: phase 11's bf16 fused SDXL run; ``sd3_serve``: phase 23's
    readings (bf16), each logged beside its int8 twin. Phase 29's training
    is a lane run from the start."""
    root = "build/chip_smoke"
    log("int8-disk", build_chip_smoke_gib=f"{_dir_gib(root):.2f}")
    lane.add("sd3-int8-train", _adv_run, sd3_int8_argv(os.path.join(root, "cache_sd3"), seed),
             SD3_INT8_DIR)
    tj = int8_trajectory(cache_dir, seed)
    runs = tj["runs"]
    log("int8-adv", gate="scripts/compare_runs.py", rc=tj["compare_rc"],
        compare=json.dumps(tj["compare"]), loss_max_mean="%.4e/%.4e" % tj["loss"],
        d_loss_max_mean="%.4e/%.4e" % tj["d_loss"],
        int8_losses=json.dumps([r.get("loss") for r in runs["int8_fused"]["rows"]]),
        bf16_losses=json.dumps([r.get("loss") for r in runs["bf16"]["rows"]]),
        int8_d_losses=json.dumps([r.get("d_loss") for r in runs["int8_fused"]["rows"]]),
        bf16_d_losses=json.dumps([r.get("d_loss") for r in runs["bf16"]["rows"]]),
        k6=json.dumps({k: r["counts"]["int8_matmul"] for k, r in runs.items()}),
        checkpoint_gib=json.dumps({k: round(v, 3) for k, v in tj["checkpoint_gib"].items()}))
    k6_ok = all((r["counts"]["int8_matmul"] > 0) == (k == "int8_fused") for k, r in runs.items())
    if tj["compare_rc"] != 0 or not k6_ok:
        raise AssertionError(f"int8 against bf16 trajectories: compare_runs rc "
                             f"{tj['compare_rc']} {tj['compare']}; K6 launched under fused "
                             f"only: {k6_ok}")

    xr = train_adv("sdxl-adv-int8", "sdxl_4phase_adv", xl_cache,
                   os.path.join(root, "adv_int8_xl"), seed, 2, "fused", 4,
                   extra=INT8 + ("fused",))
    ck = _drop_checkpoints(os.path.join(root, "adv_int8_xl"))
    log("sdxl-adv-int8", pair_ms=json.dumps([round(r["step_ms"], 1) for r in xr["rows"]]),
        peak_gib=f"{max(r['peak_gib'] for r in xr['rows']):.3f}",
        bf16_pair_ms=json.dumps([round(r["step_ms"], 1) for r in xl_bf16["rows"]]),
        bf16_peak_gib=f"{max(r['peak_gib'] for r in xl_bf16['rows']):.3f}",
        k6_launches=xr["counts"]["int8_matmul"], checkpoint_gib=f"{ck:.3f}")
    if not xr["counts"]["int8_matmul"] > 0:
        raise AssertionError(f"K6 not launched on the int8 SDXL adversarial pair: {xr}")

    s3 = sd3_int8(os.path.join(root, "sd3_adv_fused", "pcm_lora_0000004.safetensors"), seed,
                  gen, lane)
    sv, mm, tr = s3["serve"], s3["mmdit"], s3["train"]
    log("sd3-int8", bytes_saved_gib=f"{s3['bytes_saved'] / 2**30:.3f}",
        int8_params_m=json.dumps(s3["int8_params_m"]), sizes=json.dumps(sv["sizes"]),
        same_seed_identical=sv["same_seed_identical"],
        student_batch_ms=json.dumps([round(x, 1) for x in sv["batch_ms"]]),
        peak_gib=f"{sv['peak_bytes'] / 2**30:.3f}",
        batch_peak_gib=f"{sv['batch_peak_bytes'] / 2**30:.3f}",
        bf16_student_batch_ms=json.dumps([round(x, 1) for x in sd3_serve["student_batch_ms"]]),
        bf16_peak_gib=f"{sd3_serve['student_peak_bytes'] / 2**30:.3f}",
        bf16_batch_peak_gib=f"{sd3_serve['student_batch_peak_bytes'] / 2**30:.3f}",
        counts=json.dumps(sv["counts"]))
    log("sd3-int8", op="mmdit", batch=2, **{k: "%.3e/%.3e" % mm[k] for k in ("all", "noise")},
        bounds="max(2e-2,2*noise)", k6_plain_bit_identical=mm["k6_plain_identical"],
        ms=f"{mm['ms']:.3f}", peak_gib=f"{mm['peak_bytes'] / 2**30:.3f}",
        counts=json.dumps(mm["counts"]))
    rows = tr["rows"]
    log("sd3-int8", op="train", steps=[x["step"] for x in rows],
        losses=json.dumps([x.get("loss") for x in rows]),
        d_losses=json.dumps([x.get("d_loss") for x in rows]),
        step_ms=json.dumps([round(x["step_ms"], 1) for x in rows]),
        peak_gib=f"{max(x['peak_gib'] for x in rows):.3f}", lora_b_max=f"{tr['lora_b_max']:.3e}",
        heads_moved=f"{tr['heads_moved']:.3e}", checkpoint_gib=f"{s3['checkpoint_gib']:.3f}",
        counts=json.dumps(tr["counts"]))
    caps = [max(2e-2, 2 * n) for n in mm["noise"]]
    if not (sv["sizes"] == {"f0": 4, "f1": 4, "f2": 4, "f3": 4, "p0": 2, "p1": 2}
            and sv["same_seed_identical"] and sv["differ"] and sv["header"] == (1024, 1024, 8, 2)
            and s3["bytes_saved"] > 0 and all(s3["int8_params_m"][k] > 0
                                              for k in ("mmdit", "text", "text2", "t5"))
            and s3["int8_params_m"]["vae"] == 0
            and mm["finite"] and mm["k6_plain_identical"]
            and all(e <= c for e, c in zip(mm["all"], caps))
            and mm["counts"]["int8_matmul"] > 0):
        raise AssertionError(f"SD3 on int8 weights: {({k: v for k, v in s3.items() if k != 'train'})}")
    check_sd3_run("sd3-int8 train", tr, 2, sd3_adv_layers(), (*SD3_ADV_KERNELS, "int8_matmul"))

    cv = int8_conv(gen)
    log("int8-conv", batch=4, **{f"out_{m}": "%.3e/%.3e" % v[:2] for m, v in cv["out"].items()},
        conv_dx="%d convs, rel-max %.3e" % cv["conv_dx"], conv_dx_bound=CONV_DX_BOUND,
        grad_both_vs_dense="%.3e/%.3e" % cv["grad"], grad_noise="%.3e/%.3e" % cv["grad_noise"],
        ms=json.dumps({k: round(v, 3) for k, v in cv["ms"].items()}),
        k6=json.dumps({m: c["int8_matmul"] for m, c in cv["counts"].items()}))
    if not (all(v[2] for v in cv["out"].values()) and cv["grad_finite"]
            and cv["conv_dx"][0] > 0 and cv["conv_dx"][1] <= CONV_DX_BOUND
            and cv["counts"]["fused"]["int8_matmul"] > 0
            and cv["counts"]["both"]["int8_matmul"] == 0):
        raise AssertionError(f"int8 convs (both / conv) on the SD1.5 UNet: {cv}")
    return [*runs.values(), xr, sv, mm, tr, {"counts": cv["counts"]["fused"]}]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from pcm_tpu_torch.configs.families import sd15_bundle
    from pcm_tpu_torch.ops import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)

    common.lib()
    log("build", seconds=f"{common.build_seconds:.2f}", library=common.library_path())

    gen = torch.Generator("cuda").manual_seed(args.seed)
    kernels = check_kernels(gen)
    kernels.update(check_backward(gen))
    k6 = check_int8(gen)

    bundle = sd15_bundle()
    t0 = time.perf_counter()
    frozen, template = bundle.init(gen, torch.device("cuda"))
    torch.cuda.synchronize()
    log("init", seconds=f"{time.perf_counter() - t0:.2f}",
        params_m={k: round(sum(p.numel() for p in m.parameters()) / 1e6, 1)
                  for k, m in frozen.items()})
    err = unet_vs_reference(bundle, frozen, gen)
    log("unet", rel_max=f"{err:.3e}", bound="5e-2")
    if not err <= 5e-2:
        raise AssertionError(f"full-width UNet: kernels vs plain rel {err:.3e}")

    s = serve_slice(bundle, frozen, template, gen)
    log("slice", counts=json.dumps(s["counts"]), student=json.dumps(s["student_counts"]),
        teacher=json.dumps(s["teacher_counts"]))
    log("slice", student_latency_ms=json.dumps(s["student_latency_ms"]),
        student_wall_s=f"{s['student_wall_s']:.3f}",
        student_batch_ms=json.dumps([round(x, 1) for x in s["student_batch_ms"]]),
        teacher_batch_ms=json.dumps([round(x, 1) for x in s["teacher_batch_ms"]]),
        peak_gib=f"{s['peak_bytes'] / 2**30:.3f}", same_seed_identical=s["same_seed_identical"],
        occupancy=s["server_stats"]["batch_occupancy"])

    g = unet_grad_vs_reference(bundle, frozen, template, gen)
    log("unet-grad", factors=g["factors"], bounds="cos>=0.99,norm<=5e-2",
        **{k: f"{c:.6f}/{e:.3e}" for k, (c, e) in g["readings"].items()})
    if g["bad"] or not all(c >= 0.99 and e <= 5e-2 for c, e in g["readings"].values()):
        raise AssertionError(f"student gradients, kernels vs plain: {g}")
    cache = write_cache(bundle, frozen, "build/chip_smoke/cache", args.seed)
    del frozen, template
    # the lane's runs in their order (`Lane`); the card holds each beside the
    # main thread's phases of the while, the heavier ones once those are lighter
    images = write_images("build/chip_smoke/images", args.seed)
    past_adv, light = threading.Event(), threading.Event()
    lane = Lane()
    lane.add("ddp", ddp_runs, cache, args.seed)
    lane.add("pixels", train_pixels, images["dir"], "build/chip_smoke/train_pixels", args.seed)
    lane.add("sd3-adv", sd3_adv_runs, write_sd3_cache("build/chip_smoke/cache_sd3", args.seed),
             args.seed, after=past_adv)
    lane.add("train-jpeg", train_jpeg, write_eval_images("build/chip_smoke/eval_images"),
             "build/chip_smoke/train_jpeg", args.seed)
    lane.add("fsdp", fsdp_runs, cache, args.seed, after=light)
    bf16_kernels = [k for k in common.KERNELS if k != "int8_matmul"]
    tr = train_slice(cache, "build/chip_smoke/train", args.seed)
    check_train("train", tr, bf16_kernels)
    log("train", resumed=f"{tr['resumed_from']}->{tr['resumed_step']}")
    if (tr["resumed_from"], tr["resumed_step"]) != (3, 4):
        raise AssertionError(f"resume: from {tr['resumed_from']} to {tr['resumed_step']}")
    del tr["trainer"]  # its bf16 weights would count in the next run's peak
    ti = train_slice(cache, "build/chip_smoke/train_int8", args.seed, resume=False,
                     extra=("--frozen-weights", "int8", "--int8-matmul", "fused"))
    from pcm_tpu_torch.utils.quant import quantized_bytes_saved

    log("train-int8", bytes_saved_gib=f"{quantized_bytes_saved(ti['trainer'].frozen) / 2**30:.3f}")
    check_train("train-int8", ti, common.KERNELS)
    del ti["trainer"]

    from pcm_tpu_torch.configs.families import sdxl_bundle
    from pcm_tpu_torch.utils.quant import quantize_frozen

    xl = sdxl_bundle(remat=True)
    t0 = time.perf_counter()
    frozen, template = xl.init(gen, torch.device("cuda"))
    torch.cuda.synchronize()
    log("sdxl-init", seconds=f"{time.perf_counter() - t0:.2f}",
        unet_params_m=round(sum(p.numel() for p in frozen["unet"].parameters()) / 1e6, 1))
    check_sdxl_unet("bf16", sdxl_unet_vs_reference(xl, frozen, gen, int8=False))
    ag = adv_grad_vs_reference(xl, frozen, gen)
    log("adv-grad", batch=2, bounds="cos>=0.99,norm<=5e-2", loss=f"{ag['loss']:.6f}",
        ref_loss=f"{ag['ref_loss']:.6f}", latent="%.6f/%.3e" % ag["latent"],
        heads="%.6f/%.3e" % ag["heads"], geglu_backward_calls=ag["geglu_backward_calls"],
        tapped_feedforwards=ag["tapped_feedforwards"], counts=json.dumps(ag["counts"]))
    missing = [k for k in ADV_KERNELS if ag["counts"][k] == 0]
    if not (ag["finite"] and all(c >= 0.99 and e <= 5e-2 for c, e in (ag["latent"], ag["heads"]))
            and ag["geglu_backward_calls"] == ag["tapped_feedforwards"] > 0 and not missing):
        raise AssertionError(f"adversarial gradients through the SDXL teacher, kernels vs "
                             f"plain: {ag} (kernels not launched: {missing})")
    remat_sdxl = remat_runs(xl, frozen, template, gen, REMAT_SDXL)
    remat_check("sdxl", remat_sdxl, attentions(frozen["unet"]))
    quantize_frozen(frozen)
    log("sdxl-unet", int8_params_m=round(sum(b.numel() for n, b in frozen["unet"].named_buffers()
                                             if n.endswith("weight_values")) / 1e6, 1),
        bytes_saved_gib=f"{quantized_bytes_saved(frozen) / 2**30:.3f}")
    # On int8 weights a bf16 difference upstream can flip an activation code
    # (a step of amax/127), so the max-wise readings grow with the noise
    # yardstick; K6 is held to its plain version bit for bit inside the model.
    check_sdxl_unet("int8-fused", sdxl_unet_vs_reference(xl, frozen, gen, int8=True))
    sx = sdxl_step(xl, frozen, template, gen)
    log("sdxl-step", batch=4, losses=json.dumps([round(x, 6) for x in sx["losses"]]),
        grad_norms=json.dumps([round(x, 6) for x in sx["grad_norms"]]),
        step_ms=json.dumps([round(x, 1) for x in sx["step_ms"]]),
        peak_gib=f"{sx['peak_bytes'] / 2**30:.3f}", lora_b_max=f"{sx['lora_b_max']:.3e}",
        counts=json.dumps(sx["counts"]))
    if not (all(math.isfinite(x) for x in sx["losses"]) and sx["lora_b_max"] > 0):
        raise AssertionError(f"SDXL step: losses {sx['losses']}, lora_b max {sx['lora_b_max']}")
    missing = [k for k in common.KERNELS if sx["counts"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the SDXL step: {missing}")
    del frozen, template, xl

    xl_cache = write_sdxl_cache("build/chip_smoke/cache_xl", args.seed)
    adv_runs = [train_adv("train-adv", "sdxl_4phase_adv", xl_cache, "build/chip_smoke/adv_fused",
                          args.seed, 2, "fused", 4),
                train_adv("train-adv", "sdxl_4phase_adv", xl_cache, "build/chip_smoke/adv_fresh",
                          args.seed, 2, "fresh", 4, resume_to=6),
                train_adv("train-adv", "sd15_2phase_adv", cache, "build/chip_smoke/adv_sd15",
                          args.seed, 4, "fresh", 4)]
    fresh = adv_runs[1]
    if (fresh["resumed_from"], fresh["resumed_step"], fresh["resumed_updates"]) != (4, 6, (3, 3)):
        raise AssertionError(f"adversarial resume: from {fresh['resumed_from']} to "
                             f"{fresh['resumed_step']}, G/D updates {fresh['resumed_updates']}")
    # the card's disk writes are bounded, and nothing reads phase 11's checkpoints again
    freed = sum(_drop_checkpoints(os.path.join("build/chip_smoke", d))
                for d in ("adv_sd15", "adv_fused", "adv_fresh"))
    log("disk", after="phase 11", freed_gib=f"{freed:.2f}")
    gc.collect()
    torch.cuda.empty_cache()
    past_adv.set()  # phase 11's SD1.5 run, the main thread's heaviest, has ended

    frozen, _ = bundle.init(gen, torch.device("cuda"))
    enc = encoder_vs_reference(bundle, frozen, gen)
    del frozen
    log("encoder", batch=4, shape=enc["shape"], dtype=enc["dtype"],
        **{k: "%.3e/%.3e" % enc[k] for k in ("all", "noise")}, bounds="max(2e-2,2*noise)",
        ms=f"{enc['ms']:.3f}", peak_gib=f"{enc['peak_bytes'] / 2**30:.3f}",
        encode_gib=f"{enc['encode_bytes'] / 2**30:.3f}",
        sample_moved=f"{enc['sample_moved']:.3e}", counts=json.dumps(enc["counts"]))
    caps = [max(2e-2, 2 * n) for n in enc["noise"]]
    if not (enc["finite"] and all(e <= c for e, c in zip(enc["all"], caps))
            and enc["counts"]["flash_attention_fwd"] > 0 and enc["counts"]["group_norm_silu"] > 0
            and enc["sample_moved"] > 0):
        raise AssertionError(f"full-width VAE encoder, kernels vs plain: {enc}")

    xl_runs = sdxl_phases(args.seed, gen)
    dp_runs = ddp_phase(lane.result("ddp"))
    px = lane.result("pixels")
    rows = px["rows"]
    log("pixels", decoder=repr(px["decoder"]), stopped_at=px["stop"],
        load_ms=json.dumps([round(t, 1) for t in images["load_ms"]]),
        losses=json.dumps([round(r["loss"], 6) for r in rows]),
        step_ms=json.dumps([round(r["step_ms"], 1) for r in rows]),
        peak_gib=f"{max(r['peak_gib'] for r in rows):.3f}",
        **{k: json.dumps([round(r[k], 4) for r in rows]) for k in HOST_COUNTERS},
        counts=json.dumps(px["counts"]))
    missing = [k for k in bf16_kernels if px["counts"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the pixels path: {missing}")

    sl = serve_lora("build/chip_smoke/train_pixels", args.seed)
    log("serve-lora", identical=json.dumps(sl["identical"]), differ=sl["differ"],
        swaps=sl["stats"]["swaps"], lora=repr(sl["stats"]["lora"]), shape=sl["shape"],
        counts=json.dumps(sl["counts"]))
    if not (all(sl["identical"].values()) and sl["differ"] and sl["stats"]["swaps"] == 1
            and sl["swap"]["swaps"] == 1 and sl["stats"]["lora"].endswith("0000004.safetensors")
            and sl["shape"] == (512, 512, 3) and sl["counts"]["flash_attention_fwd"] > 0):
        raise AssertionError(f"serving the trained kohya files: {sl}")
    _drop_checkpoints("build/chip_smoke/train_pixels")

    sd3_runs = sd3_phases(args.seed, gen, lane)
    gc.collect()
    torch.cuda.empty_cache()
    light.set()  # phases 24-26 and eval hold a few GiB: the fsdp runs go beside them
    hub_runs = hub_phases(args.seed)
    eval_runs = eval_phases(args.seed, lane)
    sharded_runs = fsdp_phase(lane.result("fsdp"))  # ended before the int8 phases' heavy runs
    int8_runs = int8_phases(args.seed, gen, cache, xl_cache, adv_runs[0], sd3_runs[-1], lane)
    dp_runs += ddp_cards(args.seed)
    sharded_runs += fsdp_cards(args.seed)

    retained = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk("build/chip_smoke") for f in fs)
    log("disk", build_chip_smoke_gib=f"{retained / 2**30:.2f}", limit="45 GiB written a call")

    kernels["int8_matmul"] = k6
    sources = {"flash_attention_fwd": ("pcm_tpu_torch/csrc/flash_attention.cu",
                                       "pcm_tpu/ops/flash_attention.py:105"),
               "flash_attention_bwd_dkv": ("pcm_tpu_torch/csrc/flash_attention_bwd.cu",
                                           "pcm_tpu/ops/flash_attention.py:201"),
               "flash_attention_bwd_dq": ("pcm_tpu_torch/csrc/flash_attention_bwd.cu",
                                          "pcm_tpu/ops/flash_attention.py:259"),
               "group_norm_silu": ("pcm_tpu_torch/csrc/groupnorm.cu",
                                   "pcm_tpu/ops/groupnorm.py:33"),
               "geglu": ("pcm_tpu_torch/csrc/geglu.cu", "pcm_tpu/ops/geglu.py:47"),
               "int8_matmul": ("pcm_tpu_torch/csrc/int8_matmul.cu",
                               "pcm_tpu/ops/int8_matmul.py:56")}
    runs = (s, tr, ti, remat_sdxl, sx, *adv_runs, enc, px, sl, *xl_runs, *sd3_runs, *hub_runs,
            *eval_runs, *int8_runs, *dp_runs, *sharded_runs)
    launches = {k: sum(run["counts"][k] for run in runs) for k in sources}
    kernels["group_norm_silu"]["fp32_launches"] = sum(
        run["counts"]["group_norm_silu_fp32"] for run in runs)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # second headlines (K1, K2, K3, K5, K6), K1's VAE head and K5's bare product;
    # the SDXL VAE's K1 and K4 rows at 1024 px; SD3's joint attention (K1-K3)
    extra = ("sdxl_ms", "sdxl_plain_ms", "sdxl_bound_ms", "sdxl_library_ms", "vae_ms",
             "vae_plain_ms", "vae_bound_ms", "vae_library_ms", "product_ms", "sdxl_product_ms",
             "act_none_library", "fp32_shape", "fp32_ms", "fp32_plain_ms", "fp32_bound_ms",
             "fp32_library_ms", "fp32_max_abs_err", "fp32_launches", "vae_1024", "gn_1024",
             "sd3_ms", "sd3_plain_ms", "sd3_bound_ms", "sd3_library_ms", "sd3_4250", "fp32_sd3",
             "sd3_rows")
    line = {"kernels": [{"name": k, "route": "cuda", "source": sources[k][0],
                         "replaces": sources[k][1], "launches": launches[k],
                         **{f: kernels[k][f] for f in keys},
                         **{f: kernels[k][f] for f in extra if f in kernels[k]}}
                        for k in sources]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        _stop_children()
    sys.exit(code)
