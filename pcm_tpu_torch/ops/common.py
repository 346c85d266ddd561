"""Kernel library build, device dispatch and launch counters.

Counterpart of `pcm_tpu/ops/common.py`. All CUDA kernels of the port live in
`pcm_tpu_torch/csrc/*.cu` and are compiled by `nvcc` into ONE shared library
with a plain C interface, loaded through `ctypes` at the first call that
needs it: one `nvcc -c` per source, all started together, then one link.
The build goes to ``<repo>/build/pcm_tpu_torch/<source-hash>/`` under a file
lock, so concurrent processes build once and a source edit builds anew.
The library links the CUDA runtime only: the TMA tensor maps of the
attention, GEGLU and int8 kernels are encoded by ``cuTensorMapEncodeTiled``
of the CUDA driver API, which the runtime hands out through
``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh`` and ``cuda.h`` supply the
types).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor takes the kernel (or the
wrapper raises), any other device raises. ``reference_ops()`` forces the
plain versions; only tests and ``chip_smoke.py`` enter it.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pcm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FORCE_REFERENCE = contextvars.ContextVar("pcm_torch_force_reference", default=frozenset())
ALL_KERNELS = "*"

# One launch counter per kernel; a wrapper adds one where it launches its
# kernel and nowhere else. K4 counts its fp32 instance (the discriminator
# heads) on a counter of its own.
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "group_norm_silu", "geglu", "int8_matmul")
COUNTERS = KERNELS + ("group_norm_silu_fp32",)
_launches: Dict[str, int] = {k: 0 for k in COUNTERS}


@contextlib.contextmanager
def reference_ops(*kernels: str):
    """Run the plain PyTorch versions of the named kernels (of every kernel
    when none is named) within the context (tests and ``chip_smoke.py``
    only: it is how a kernel is held to its plain version on the same inputs)."""
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    tok = _FORCE_REFERENCE.set(frozenset(kernels or (ALL_KERNELS,)))
    try:
        yield
    finally:
        _FORCE_REFERENCE.reset(tok)


def reference_forced() -> frozenset:
    """The kernels the caller forces to their plain versions (``"*"``: all)."""
    return _FORCE_REFERENCE.get()


def use_kernel(*tensors: torch.Tensor, name: Optional[str] = None) -> bool:
    """True when the inputs must take the CUDA kernel ``name``, False for the
    plain version. Raises on mixed or unsupported devices."""
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(devs)}")
    dev = devs.pop()
    forced = _FORCE_REFERENCE.get()
    if dev == "cpu" or ALL_KERNELS in forced or name in forced:
        return False
    if dev == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev!r}")


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def vjp_of(fn, inputs, args, g, needs):
    """Gradients of ``fn(*inputs, *args)`` w.r.t. the ``inputs`` whose entry
    of ``needs`` (a Function's ``ctx.needs_input_grad``) is true, None for the
    others (a frozen weight's), by autograd: the backward of the ops whose
    JAX custom VJP differentiates the plain version."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        grads = iter(torch.autograd.grad(fn(*xs, *args), [x for x in xs if x.requires_grad], g))
        return [next(grads) if x.requires_grad else None for x in xs]


def check_cuda(err: int, what: str) -> None:
    if err != 0:
        name = lib().pcm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Every SM of an H100 SXM: the grids of K2 and K4 are sized to fill them.
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / "libpcm_kernels.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (0 when cached)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    global build_seconds
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                _compile_and_link(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_seconds = time.perf_counter() - t0
    return out


def _compile_and_link(out: Path) -> None:
    """One ``nvcc -c`` per source in parallel, then ``nvcc -shared``; every
    command and its output (ptxas' register and spill report) go to
    ``build.log`` beside the library."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(out.parent / (src.stem + ".o"))]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_suffix(".so.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[c[-1] for c, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    (out.parent / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        _declare(handle)
        _lib = handle
    return _lib


def _declare(h: ctypes.CDLL) -> None:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    h.pcm_error_string.restype = ctypes.c_char_p
    h.pcm_error_string.argtypes = [I]
    h.pcm_flash_attention_fwd.restype = I
    h.pcm_flash_attention_fwd.argtypes = (
        [P, P, P, P, P]  # q k v o lse
        + [I] * 5  # b h sq sk d
        + [L] * 9  # q/k/v strides (b, s, h)
        + [F, P]  # alpha (scale*log2e), stream
    )
    for name, outs, ints in (("pcm_flash_attention_bwd_dkv", 3, 6),  # dk dv part; nsplit
                             ("pcm_flash_attention_bwd_dq", 1, 5)):  # dq
        fn = getattr(h, name)
        fn.restype = I
        fn.argtypes = (
            [P] * (6 + outs)  # q k v do lse delta, then the outputs
            + [I] * ints  # b h sq sk d [nsplit]
            + [L] * 12  # q/k/v/do strides (b, s, h)
            + [F, F, P]  # alpha (scale*log2e), scale, stream
        )
    h.pcm_group_norm_silu.restype = I
    h.pcm_group_norm_silu.argtypes = (
        [P, P, P, P, P]  # x gamma beta out scratch
        + [I] * 11  # elem_size n s c lanes groups act rows_per_chunk rs seg_chan seg_chunk
        + [F, P]  # eps, stream
    )
    h.pcm_geglu.restype = I
    h.pcm_geglu.argtypes = [P, P, P, P] + [I] * 3 + [P]  # x w b out, m k f, stream
    h.pcm_int8_matmul.restype = I
    h.pcm_int8_matmul.argtypes = (
        [P] * 6  # x w ws out, codes scales (scratch)
        + [I] * 4 + [P])  # m n k bk, stream


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
