#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100): the SD1.5 serving
path, the SD1.5 distillation step (bf16 and int8 frozen weights) and the
SDXL-1024 cached distillation step on int8 frozen weights.

    python3 chip_smoke.py [--seed 0]

Phases, one printed line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the port's CUDA kernels (pcm_tpu_torch/csrc) into one library;
  3. kernels: each kernel against its plain PyTorch version at the SD1.5 shapes
     of the serving path and the SDXL-1024 shapes of the SDXL step, bf16 on the
     card, with errors, CUDA-event times and bit-identical reruns (K1, K5 at
     every shape), and at a second, SDXL headline (``sdxl_*`` fields) for K1,
     K5 and K6 as for K2 / K3, and K1's VAE head (``vae_*``); beside K5 the
     bare cuBLAS product ``F.linear(x, w)`` (``product_ms``), the yardstick of
     its tensor-core part;
     the flash-attention backward (K2 dK/dV, K3 dQ) through its autograd
     Function against autograd of the plain attention at the training shapes,
     and twice bit-identical, with the SDPA backward and the bounds at the
     SD1.5 and SDXL headline shapes; the GroupNorm Function's gradients; the fused
     int8 matmul (K6) at the SD1.5 and SDXL shapes of the int8 paths; beside
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
 10. sdxl-step: the SDXL-1024 cached consistency step (`sdxl_bundle` +
     `build_ddim_distill_step`, 40 solver steps, 4 phases, w in [6, 7), remat
     full) on int8 frozen weights under ``fused``, batch 4, 3 steps: finite
     losses, peak memory, K1-K6 all launched.
Each main path runs with the launch counts set to 0 just before it and read
just after. Then a JSON line of the kernels, the nvidia-smi line, and a last
JSON line ``{"ok": true, ...}``.
Any failed check raises: the script then exits non-zero and prints no result.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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

# (b, sq, sk, h, d): SD1.5 at 512 px, batch 4 (UNet self/cross, mid, VAE mid);
# then the SDXL UNet at 1024 px, batch 4 (self/cross at 64x64 and 32x32)
ATTN_SHAPES = [
    (4, 4096, 4096, 8, 40), (4, 4096, 77, 8, 40), (4, 1024, 1024, 8, 80),
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (4, 256, 77, 8, 160),
    (4, 64, 64, 8, 160), (4, 4096, 4096, 1, 512),
    (4, 4096, 4096, 10, 64), (4, 4096, 77, 10, 64), (4, 1024, 1024, 20, 64),
    (4, 1024, 77, 20, 64),
]
# (shape NHWC, eps, act): UNet resnets / transformer norms, VAE decoder; then
# SDXL at 1024 px, batch 4 (resnets of each level, an up-path concat, a
# transformer norm)
GN_SHAPES = [
    ((4, 64, 64, 320), 1e-5, "silu"), ((4, 64, 64, 960), 1e-5, "silu"),
    ((4, 32, 32, 1920), 1e-5, "silu"), ((4, 16, 16, 2560), 1e-5, "silu"),
    ((4, 8, 8, 1280), 1e-5, "silu"), ((4, 64, 64, 320), 1e-6, None),
    ((4, 64, 64, 512), 1e-6, None), ((4, 512, 512, 128), 1e-6, "silu"),
    ((4, 512, 512, 256), 1e-6, "silu"),
    ((4, 128, 128, 320), 1e-5, "silu"), ((4, 64, 64, 640), 1e-5, "silu"),
    ((4, 32, 32, 2560), 1e-5, "silu"), ((4, 128, 128, 960), 1e-5, "silu"),
    ((4, 32, 32, 1280), 1e-6, None),
]
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


def headline_prefix(name, key):
    """The field prefix of a headline shape ("", "sdxl_", "vae_"), or None."""
    for prefix, table in (("", HEADLINE), ("sdxl_", SDXL_HEADLINE), ("vae_", VAE_HEADLINE)):
        if key == table.get(name):
            return prefix
    return None


def check_kernels(gen) -> dict:
    from pcm_tpu_torch.ops.flash_attention import (attention_lse_reference, attention_reference,
                                                   flash_attention_fwd)
    from pcm_tpu_torch.ops.geglu import geglu, geglu_reference
    from pcm_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference

    results = {k: {"max_abs_err": 0.0, "library_ms": None} for k in HEADLINE}

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
        if headline_prefix("flash_attention_fwd", shp) is not None:
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))  # (b, h, s, d)
            lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
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
        log("kernel", name="group_norm_silu", shape=shp, eps=eps, act=act, rel_max=f"{err:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
        if not err <= 1e-2:
            raise AssertionError(f"group norm {key}: rel {err:.3e}")
        record("group_norm_silu", key, abs_max(out, ref), ms, plain)
        if key == HEADLINE["group_norm_silu"]:  # read x, write y (bf16); ~8 fp32 ops each
            results["group_norm_silu"].update(bound(8.0 * x.numel(), "fp32", 4.0 * x.numel()))
        del x, out, ref

    # stability on a large mean (the Pallas one-pass variance cancels here)
    x = bf16_randn((4, 64, 64, 320), gen, 1.0, 100.0)
    one, zero = torch.ones(320, device="cuda").bfloat16(), torch.zeros(320, device="cuda").bfloat16()
    err = rel_max(group_norm_silu(x, one, zero, 32, 1e-5, None),
                  group_norm_silu_reference(x.double(), one.double(), zero.double(), 32, 1e-5, None))
    log("kernel", name="group_norm_silu", shape="(4,64,64,320)+100", rel_max=f"{err:.3e}")
    if not err <= 1e-2:
        raise AssertionError(f"group norm on a +100 offset: rel {err:.3e}")

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
# then SDXL's at 1024 px
BWD_SHAPES = [
    (4, 4096, 4096, 8, 40), (4, 4096, 77, 8, 40), (4, 1024, 1024, 8, 80),
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (4, 256, 77, 8, 160),
    (4, 64, 64, 8, 160), (4, 64, 77, 8, 160),
    (4, 4096, 4096, 10, 64), (4, 4096, 77, 10, 64), (4, 1024, 1024, 20, 64),
    (4, 1024, 77, 20, 64),
]
BWD_HEADLINE = (4, 4096, 4096, 8, 40)
BWD_SDXL = (4, 4096, 4096, 10, 64)  # second headline: SDXL-1024 self-attention


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
    SDXL headline shapes also the SDPA backward (dQ, dK, dV in one call) and
    the bounds; the SDXL readings go into ``sdxl_*`` fields."""
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
            if shp == BWD_HEADLINE:
                r["ms"], r["plain_ms"] = ms, plain
            if shp == BWD_SDXL:
                r.update(sdxl_ms=ms, sdxl_plain_ms=plain)
        if shp in (BWD_HEADLINE, BWD_SDXL):  # the library call: one backward gives dQ, dK and dV
            lib = sdpa_backward_ms(q, k, v, do)
            bounds = {"flash_attention_bwd_dkv": attn_bound(shp, 4, 2),  # S, dV, dP, dK
                      "flash_attention_bwd_dq": attn_bound(shp, 3, 1)}  # S, dP, dQ
            for name in results:
                if shp == BWD_HEADLINE:
                    results[name].update(library_ms=lib, **bounds[name])
                else:
                    results[name].update(sdxl_library_ms=lib,
                                         sdxl_bound_ms=bounds[name]["bound_ms"])
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


def check_int8(gen) -> dict:
    """K6 against its plain version on the same bf16 activations and int8
    weights (per-channel codes of a seeded weight): both do the same fp32
    operations in the same order, so every output must be equal bit for bit,
    and the all-zero row x[1] must give a zero row."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference)
    from pcm_tpu_torch.utils.quant import quantize

    result = {"max_abs_err": 0.0, "library_ms": None}
    for shp in K6_SHAPES:
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
    """The LoRA gradients of one student forward + backward with every
    kernel, against every plain version (``all``) and against K2 alone and
    K3 alone plain: (cosine, relative norm error) each."""
    from pcm_tpu_torch.ops import reference_ops
    from pcm_tpu_torch.train.bundles import adapter_like

    adapter = adapter_like(template, gen)  # b != 0: every factor gets a gradient
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    t = torch.tensor([999, 421], device="cuda")
    cond = {"prompt_embeds": bf16_randn((2, 77, 768), gen)}

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
    launches = {k: sum(run["counts"][k] for run in (s, tr, ti, sx)) for k in sources}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # second headlines (K1, K2, K3, K5, K6), K1's VAE head and K5's bare product
    extra = ("sdxl_ms", "sdxl_plain_ms", "sdxl_bound_ms", "sdxl_library_ms", "vae_ms",
             "vae_plain_ms", "vae_bound_ms", "vae_library_ms", "product_ms", "sdxl_product_ms")
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
    sys.exit(main())
