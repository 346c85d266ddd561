"""Hopper kernels of `pcm_tpu_torch` against their plain PyTorch versions.

These run only where a CUDA card is present (marker ``gpu``); this file
imports no jax so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu -q

Inputs are bf16 on the card; the plain versions compute in fp32 from the
same bf16 inputs with TF32 off. Bounds: rel-max 2e-2 for attention and
GEGLU (bf16 rounding of P and of the output), 1e-2 for GroupNorm, base-2
lse abs 5e-3.
"""

import numpy as np
import pytest
import torch

from pcm_tpu_torch.ops import common
from pcm_tpu_torch.ops.flash_attention import (attention_lse_reference, attention_reference,
                                               flash_attention_fwd)
from pcm_tpu_torch.ops.geglu import geglu, geglu_reference
from pcm_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape, dtype=np.float32) * scale + offset
    return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)


def rel_max(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 8, 40),
    (2, 1024, 77, 8, 40),
    (1, 300, 300, 8, 80),
    (2, 64, 77, 8, 160),
    (1, 1000, 1000, 1, 512),
    (2, 77, 77, 4, 16),
    (1, 130, 70, 2, 64),
])
def test_flash_attention_kernel(cuda, b, sq, sk, h, d):
    q = _randn((b, sq, h, d), 0, cuda)
    k = _randn((b, sk, h, d), 1, cuda)
    v = _randn((b, sk, h, d), 2, cuda)
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref = attention_reference(q.float(), k.float(), v.float())
    lse_ref = attention_lse_reference(q.float(), k.float())
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert rel_max(o, ref) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 5e-3


def test_flash_attention_strided_projection(cuda):
    """Reads (b, s, h, d) views of a fused projection through their strides."""
    qkv = _randn((2, 256, 3, 8, 40), 3, cuda)
    q, k, v = qkv.unbind(2)
    o, _ = flash_attention_fwd(q, k, v)
    ref = attention_reference(q.float(), k.float(), v.float())
    assert rel_max(o, ref) <= 2e-2


@pytest.mark.parametrize("shape,groups,eps,act,offset", [
    ((4, 64, 64, 320), 32, 1e-5, "silu", 0.0),
    ((2, 16, 16, 1280), 32, 1e-6, None, 0.0),
    ((2, 77, 320), 32, 1e-5, "silu", 100.0),
    ((2, 8, 8, 2560), 32, 1e-5, "silu", 0.0),
    ((1, 128, 128, 128), 32, 1e-6, "silu", 0.0),
])
def test_group_norm_kernel(cuda, shape, groups, eps, act, offset):
    x = _randn(shape, 4, cuda, offset=offset)
    c = shape[-1]
    gamma = _randn((c,), 5, cuda, 0.5, 1.0)
    beta = _randn((c,), 6, cuda, 0.5)
    out = group_norm_silu(x, gamma, beta, groups, eps, act)
    torch.cuda.synchronize()
    ref = group_norm_silu_reference(x.float(), gamma.float(), beta.float(), groups, eps, act)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert rel_max(out, ref) <= 1e-2


def test_group_norm_kernel_is_deterministic(cuda):
    x = _randn((4, 64, 64, 640), 7, cuda)
    gamma = torch.ones(640, device=cuda, dtype=torch.bfloat16)
    beta = torch.zeros(640, device=cuda, dtype=torch.bfloat16)
    a = group_norm_silu(x, gamma, beta)
    b = group_norm_silu(x, gamma, beta)
    assert torch.equal(a, b)


@pytest.mark.parametrize("m,k,f", [(4096, 320, 1280), (1000, 640, 2560), (77, 1280, 5120)])
def test_geglu_kernel(cuda, m, k, f):
    x = _randn((m, k), 8, cuda)
    w = _randn((2 * f, k), 9, cuda, k ** -0.5)
    b = _randn((2 * f,), 10, cuda, 0.1)
    out = geglu(x, w, b)
    torch.cuda.synchronize()
    ref = geglu_reference(x.float(), w.float(), b.float())
    assert out.shape == (m, f)
    assert rel_max(out, ref) <= 2e-2


def test_wrappers_count_launches(cuda):
    common.reset_launch_counts()
    x = _randn((2, 16, 64), 11, cuda)
    geglu(x, _randn((128, 64), 12, cuda), _randn((128,), 13, cuda))
    with common.reference_ops():
        geglu(x, _randn((128, 64), 12, cuda), _randn((128,), 13, cuda))
    assert common.launch_counts()["geglu"] == 1


def test_wrappers_reject_unsupported(cuda):
    q = torch.zeros((1, 8, 1, 40), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_fwd(q, q, q)
    x = torch.zeros((1, 4, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        group_norm_silu(x, x[0, 0], x[0, 0], num_groups=4)
