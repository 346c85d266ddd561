"""Hopper kernels of `pcm_tpu_torch` against their plain PyTorch versions.

These run only where a CUDA card is present (marker ``gpu``); this file
imports no jax so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu -q

Inputs are bf16 on the card; the plain versions compute in fp32 from the
same bf16 inputs with TF32 off. Bounds: rel-max 2e-2 for attention (forward
and the K2/K3 gradients: bf16 rounding of P, dS and the outputs) and GEGLU,
1e-2 for GroupNorm, base-2 lse abs 5e-3. The fused int8 matmul (K6) is
held bit for bit to its plain version.
"""

import re

import numpy as np
import pytest
import torch

from pcm_tpu_torch.ops import common
from pcm_tpu_torch.ops.flash_attention import (attention_bwd_reference, attention_lse_reference,
                                               attention_reference, flash_attention,
                                               flash_attention_bwd, flash_attention_fwd)
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
    # the VAE's 512-wide head: ragged q and key lengths against the 64-row
    # tiles and 32-key steps, and SD1.5's decode at batch 1
    (2, 300, 77, 1, 512), (1, 4096, 4096, 1, 512), (2, 1000, 1000, 1, 512),
    (2, 77, 77, 4, 16),
    (1, 130, 70, 2, 64),
    # ragged q and key lengths (sq = 130 straddles the 128-row blocks) at every
    # head dim of the wgmma kernel
    *[(1, 130, 77, 2, d) for d in (16, 32, 40, 64, 80, 128, 160)],
    (1, 77, 300, 2, 40),
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


@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128, 160, 512])
def test_flash_attention_strided_projection(cuda, d):
    """Reads (b, s, h, d) views of a fused projection through their strides."""
    qkv = _randn((2, 200, 3, 4, d), 3, cuda)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    ref = attention_reference(q.float(), k.float(), v.float())
    assert rel_max(o, ref) <= 2e-2
    assert float((lse - attention_lse_reference(q.float(), k.float())).abs().max()) <= 5e-3


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 4, 64), (2, 300, 77, 8, 40),
                                         (1, 256, 256, 2, 160), (1, 130, 130, 1, 512),
                                         (2, 1000, 300, 1, 512)])
def test_flash_attention_kernel_is_deterministic(cuda, b, sq, sk, h, d):
    q, k, v = (_randn((b, s, h, d), 20 + i, cuda) for i, s in enumerate((sq, sk, sk)))
    o1, lse1 = flash_attention_fwd(q, k, v)
    o2, lse2 = flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("shape,groups,eps,act,offset", [
    ((4, 64, 64, 320), 32, 1e-5, "silu", 0.0),
    ((2, 16, 16, 1280), 32, 1e-6, None, 0.0),
    ((2, 77, 320), 32, 1e-5, "silu", 100.0),
    ((2, 8, 8, 2560), 32, 1e-5, "silu", 0.0),
    ((1, 128, 128, 128), 32, 1e-6, "silu", 0.0),
    # 16-byte vectors that straddle two groups (cg = 30, 60), S = 64 (the
    # 8x8 level: 8 rows a block), S = 262144 (the VAE at 512 px), N = 1 (261
    # chunks a sample: 33 a lane of the prologue's 8-lane segments) and N = 8
    ((4, 64, 64, 960), 32, 1e-5, "silu", 0.0),
    ((2, 32, 32, 1920), 32, 1e-5, "silu", 100.0),
    ((4, 8, 8, 1280), 32, 1e-5, "silu", 0.0),
    ((1, 8, 8, 1920), 32, 1e-5, None, 0.0),
    ((1, 512, 512, 128), 32, 1e-6, "silu", 0.0),
    ((8, 32, 32, 1280), 32, 1e-5, None, 0.0),
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


@pytest.mark.parametrize("shape,act", [
    ((4, 64, 64, 320), None), ((4, 32, 32, 1280), None), ((2, 8, 8, 1280), None),
    ((4, 64, 64, 640), "silu"), ((2, 77, 96), None), ((1, 16, 16, 2048), None),
    ((2, 4096, 1536), None), ((4, 4096, 1536), None)])
def test_group_norm_kernel_fp32(cuda, shape, act):
    """K4 on fp32 x, gamma, beta and out (the discriminator heads' GroupNorm:
    4 channels a 16-byte vector, cg = 3 straddles vectors at C = 96; the SD3
    heads' 64x64 grids of 1536 channels, cg = 48, at B and 2B), against
    the plain version in float64 at 1e-5, and bit-identical on a rerun."""
    rng = np.random.default_rng(12)
    c = shape[-1]
    x, gamma, beta = (torch.from_numpy(a).to(cuda) for a in (
        rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5,
        rng.standard_normal(c, dtype=np.float32),
        rng.standard_normal(c, dtype=np.float32)))
    common.reset_launch_counts()
    out = group_norm_silu(x, gamma, beta, 32, 1e-5, act)
    again = group_norm_silu(x, gamma, beta, 32, 1e-5, act)
    torch.cuda.synchronize()
    assert common.launch_counts()["group_norm_silu_fp32"] == 2
    ref = group_norm_silu_reference(x.double(), gamma.double(), beta.double(), 32, 1e-5, act)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert rel_max(out, ref) <= 1e-5 and torch.equal(out, again)


@pytest.mark.parametrize("shape", [(4, 64, 64, 640), (4, 512, 512, 256)])
def test_group_norm_kernel_is_deterministic(cuda, shape):
    x = _randn(shape, 7, cuda)
    gamma = torch.ones(shape[-1], device=cuda, dtype=torch.bfloat16)
    beta = torch.zeros(shape[-1], device=cuda, dtype=torch.bfloat16)
    a = group_norm_silu(x, gamma, beta)
    b = group_norm_silu(x, gamma, beta)
    assert torch.equal(a, b)


def test_group_norm_kernels_do_not_spill(cuda):
    """ptxas spills in none of K4's six kernel instances, bf16 and fp32 (the
    build's ``-Xptxas -v`` report in ``build.log``)."""
    common.lib()
    log = (common.library_path().parent / "build.log").read_text()
    spills = re.findall(r"Compiling entry function '\S*?(gn_\w+?_kernel\w*)' "
                        r"for 'sm_90a'\n.*\n.*?(\d+) bytes spill stores", log)
    assert len(spills) == 6 and all(b == "0" for _, b in spills), spills


@pytest.mark.parametrize("m,k,f", [(4096, 320, 1280), (1000, 640, 2560), (77, 1280, 5120),
                                   (1000, 320, 1000), (130, 72, 136)])
def test_geglu_kernel(cuda, m, k, f):
    x = _randn((m, k), 8, cuda)
    w = _randn((2 * f, k), 9, cuda, k ** -0.5)
    b = _randn((2 * f,), 10, cuda, 0.1)
    out = geglu(x, w, b)
    torch.cuda.synchronize()
    ref = geglu_reference(x.float(), w.float(), b.float())
    assert out.shape == (m, f)
    assert rel_max(out, ref) <= 2e-2


def test_geglu_kernel_is_deterministic(cuda):
    x = _randn((1000, 320), 8, cuda)
    w = _randn((2000, 320), 9, cuda, 320 ** -0.5)
    b = _randn((2000,), 10, cuda, 0.1)
    assert torch.equal(geglu(x, w, b), geglu(x, w, b))


def test_wrappers_count_launches(cuda):
    common.reset_launch_counts()
    x = _randn((2, 16, 64), 11, cuda)
    geglu(x, _randn((128, 64), 12, cuda), _randn((128,), 13, cuda))
    with common.reference_ops():
        geglu(x, _randn((128, 64), 12, cuda), _randn((128,), 13, cuda))
    assert common.launch_counts()["geglu"] == 1


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_attention_bwd_dkv",
                                  "flash_attention_bwd_dq", "group_norm_silu", "geglu"])
def test_reference_ops_by_name(cuda, name):
    """``reference_ops(name)`` sends that kernel alone to its plain version
    (how ``chip_smoke.py`` swaps one kernel at a time inside a model), K2 and
    K3 included through the attention Function's backward."""
    q = _randn((1, 64, 2, 40), 14, cuda).requires_grad_(True)
    xn, gamma, beta = _randn((1, 8, 8, 64), 15, cuda), _randn((64,), 16, cuda), _randn((64,), 17, cuda)
    x, w, b = _randn((2, 16, 64), 11, cuda), _randn((128, 64), 12, cuda), _randn((128,), 13, cuda)
    common.reset_launch_counts()
    with common.reference_ops(name):
        flash_attention(q, q, q).float().square().sum().backward()
        group_norm_silu(xn, gamma, beta, 32, 1e-5, "silu")
        geglu(x, w, b)
    counts = common.launch_counts()
    for k in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
              "group_norm_silu", "geglu"):
        assert counts[k] == (0 if k == name else 1), counts
    assert torch.isfinite(q.grad).all()


def test_wrappers_reject_unsupported(cuda):
    q = torch.zeros((1, 8, 1, 40), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_fwd(q, q, q)
    x = torch.zeros((1, 4, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        group_norm_silu(x, x[0, 0], x[0, 0], num_groups=4)
    w = torch.zeros((16, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        geglu(x[0], w, w[:, 0])
    q = torch.zeros((1, 8, 1, 512), device=cuda, dtype=torch.bfloat16)
    o, lse = flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="backward"):
        flash_attention_bwd(q, q, q, o, lse, o, 512 ** -0.5)


# SD1.5 / SDXL head dims; ragged lengths straddle K2's 64-row q steps and
# 128- (64- at d = 160) row k blocks and K3's 128-row q blocks and 64-row k
# steps; sk = 77 and (1, 300, 77, 8, 40) split K2's q range over blocks
BWD_SHAPES = [(2, 256, 256, 8, 40), (2, 1024, 77, 8, 40), (1, 300, 300, 8, 80),
              (2, 64, 77, 8, 160), (2, 77, 77, 4, 16), (1, 130, 70, 2, 64),
              (1, 1024, 1024, 2, 64), (1, 65, 77, 1, 160), (2, 200, 200, 2, 80),
              (1, 300, 77, 8, 40), (1, 129, 129, 2, 128)]


def _grads(fn, inputs, do):
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*xs).backward(do)
    return [x.grad for x in xs]


@pytest.mark.parametrize("b,sq,sk,h,d", BWD_SHAPES)
def test_flash_attention_backward_kernels(cuda, b, sq, sk, h, d):
    """K2 (dK/dV) and K3 (dQ) through the autograd Function against autograd
    of the fp32 plain attention on the same bf16 inputs; ragged sq and sk."""
    q, k, v = _randn((b, sq, h, d), 20, cuda), _randn((b, sk, h, d), 21, cuda), \
        _randn((b, sk, h, d), 22, cuda)
    do = _randn((b, sq, h, d), 23, cuda)
    common.reset_launch_counts()
    grads = _grads(flash_attention, (q, k, v), do)
    torch.cuda.synchronize()
    counts = common.launch_counts()
    assert counts["flash_attention_bwd_dkv"] == 1 and counts["flash_attention_bwd_dq"] == 1
    refs = _grads(lambda *a: attention_reference(*a), [t.float() for t in (q, k, v)], do.float())
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert rel_max(g, r) <= 2e-2, (name, rel_max(g, r))
    # and against the plain K2+K3 on the kernel forward's own o / lse
    o, lse = flash_attention_fwd(q, k, v)
    plain = attention_bwd_reference(q, k, v, o, lse, do, d ** -0.5)
    for name, g, r in zip("qkv", grads, plain):
        assert rel_max(g, r) <= 2e-2, (name, rel_max(g, r))


def test_flash_attention_backward_is_deterministic(cuda):
    q, k, v = (_randn((2, 1024, 8, 40), s, cuda) for s in (24, 25, 26))
    do = _randn((2, 1024, 8, 40), 27, cuda)
    o, lse = flash_attention_fwd(q, k, v)
    first = flash_attention_bwd(q, k, v, o, lse, do, 40 ** -0.5)
    second = flash_attention_bwd(q, k, v, o, lse, do, 40 ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_backward_noncontiguous_do(cuda):
    """dO as a transposed view (unit stride along head_dim: read through its
    strides) and with a non-unit head_dim stride (copied): same bits."""
    b, s, h, d = 2, 256, 8, 80
    q, k, v = (_randn((b, s, h, d), sd, cuda) for sd in (28, 29, 30))
    do = _randn((b, s, h, d), 31, cuda)
    o, lse = flash_attention_fwd(q, k, v)
    ref = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    do_bhsd = do.transpose(1, 2).contiguous().transpose(1, 2)  # strides (h s d, d, s d, 1)
    do_dlast = do.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)  # head_dim stride h
    assert not do_bhsd.is_contiguous() and do_dlast.stride(3) != 1
    for view in (do_bhsd, do_dlast):
        for a, r in zip(flash_attention_bwd(q, k, v, o, lse, view, d ** -0.5), ref):
            assert torch.equal(a, r)


def test_group_norm_and_geglu_function_grads(cuda):
    """Kernel forwards with autograd-of-plain backwards: grads of x, gamma and
    beta (GroupNorm) and of x, w, b (GEGLU) against fp32 plain autograd."""
    x = _randn((2, 32, 32, 640), 32, cuda)
    gamma, beta = _randn((640,), 33, cuda, 0.5, 1.0), _randn((640,), 34, cuda, 0.5)
    g = _randn((2, 32, 32, 640), 35, cuda)
    common.reset_launch_counts()
    got = _grads(lambda *a: group_norm_silu(*a, 32, 1e-5, "silu"), (x, gamma, beta), g)
    assert common.launch_counts()["group_norm_silu"] == 1
    ref = _grads(lambda *a: group_norm_silu_reference(*a, 32, 1e-5, "silu"),
                 [t.float() for t in (x, gamma, beta)], g.float())
    for a, r in zip(got, ref):
        assert rel_max(a, r) <= 2e-2
    xg = _randn((2, 1024, 320), 36, cuda)
    w, bias = _randn((2560, 320), 37, cuda, 320 ** -0.5), _randn((2560,), 38, cuda, 0.1)
    gg = _randn((2, 1024, 1280), 39, cuda)
    got = _grads(geglu, (xg, w, bias), gg)
    assert common.launch_counts()["geglu"] == 1
    ref = _grads(geglu_reference, [t.float() for t in (xg, w, bias)], gg.float())
    for a, r in zip(got, ref):
        assert rel_max(a, r) <= 2e-2


# ---------------------------------------------------------------------------
# K6: the fused int8 matmul
# ---------------------------------------------------------------------------


def _int8_weight(n, k, seed, device):
    from pcm_tpu_torch.utils.quant import quantize

    qt = quantize(_randn((n, k), seed, device, k ** -0.5).float())
    return qt.values, qt.scale.reshape(-1)


@pytest.mark.parametrize("m,k,n", [(16384, 320, 320), (300, 640, 640), (4, 2816, 1280),
                                   (308, 2048, 1280), (1000, 768, 3072), (77, 5120, 1280),
                                   (130, 1024, 136)])
def test_int8_matmul_kernel(cuda, m, k, n):
    """Bit-identical to the plain version: the same per-(row, K-tile)
    scales, exact int32 tile products and fp32 sums in the same order;
    ragged M (rows past M never stored) and an all-zero row included."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference)

    x = _randn((m, k), 60, cuda)
    x[min(3, m - 1)] = 0
    values, scale = _int8_weight(n, k, 61, cuda)
    got = fused_quantized_dot_fwd(x, values, scale)
    torch.cuda.synchronize()
    ref = fused_quantized_dot_reference(x, values, scale)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert torch.equal(got, ref)
    assert torch.equal(got[min(3, m - 1)], torch.zeros_like(got[0]))


# K -> K-tile: 640 -> 128, 1280 -> 256, 320 -> 320 (64-byte chunks), 768 ->
# 384, 2048 -> 512
@pytest.mark.parametrize("k", [640, 1280, 320, 768, 2048])
@pytest.mark.parametrize("m", [1, 4, 63, 65, 300, 16384])
def test_int8_matmul_kernel_tiles(cuda, m, k):
    """Bit-identical to the plain version at every K-tile of the models
    (every chunk width of the GEMM's ring), M around the 64-row warpgroup
    and 128-row block edges, N not a multiple of the 128-column tile (136,
    320) and wide (1280, 10240); and bit-identical on a rerun."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference, pick_block)

    assert pick_block(k, 512, 128) == {640: 128, 1280: 256, 320: 320, 768: 384, 2048: 512}[k]
    x = _randn((m, k), 70 + m, cuda, 2.0)
    x[m // 2] = 0
    for n in (136, 320, 1280, 10240):
        values, scale = _int8_weight(n, k, 71 + n, cuda)
        got = fused_quantized_dot_fwd(x, values, scale)
        again = fused_quantized_dot_fwd(x, values, scale)
        torch.cuda.synchronize()
        ref = fused_quantized_dot_reference(x, values, scale)
        assert torch.equal(got, ref), (m, k, n, int((got != ref).sum()))
        assert torch.equal(got, again)
        assert not got[m // 2].any()


@pytest.mark.parametrize("k", [544, 960, 992])
def test_int8_matmul_kernel_long_k_tiles(cuda, k):
    """K-tiles the models do not use but the wrapper takes: 544, 960 and 992
    have no multiple of 128 up to 512 that divides them, so the K-tile is K
    itself, in 32- or 64-byte chunks: more chunks than the GEMM's ring has
    stages. Bit-identical to the plain version."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference, pick_block)

    assert pick_block(k, 512, 128) == k
    x = _randn((300, k), 80 + k, cuda)
    values, scale = _int8_weight(320, k, 81 + k, cuda)
    got = fused_quantized_dot_fwd(x, values, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_quantized_dot_reference(x, values, scale))


@pytest.mark.parametrize("x_scale", [1e-33, 1e33])
def test_int8_matmul_kernel_extreme_scales(cuda, x_scale):
    """Activation scales outside [2^-100, 2^100], where the quantize pass
    divides with an IEEE division in place of its one-reciprocal path:
    bit-identical to the plain version."""
    from pcm_tpu_torch.ops.int8_matmul import (fused_quantized_dot_fwd,
                                               fused_quantized_dot_reference)

    x = _randn((300, 640), 82, cuda, x_scale)
    values, scale = _int8_weight(320, 640, 83, cuda)
    got = fused_quantized_dot_fwd(x, values, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_quantized_dot_reference(x, values, scale))


def test_int8_matmul_function_and_paths(cuda):
    """`fused` routes through K6 (one launch a product) with the dequantized
    backward; `dense` (torch._int_mm, padded to 17 rows) equals its CPU
    computation bit for bit, at M = 4 as in SDXL's add_embedding."""
    from pcm_tpu_torch.ops.int8_matmul import dequantized_dx, fused_quantized_dot
    from pcm_tpu_torch.utils import quant

    values, scale = _int8_weight(1280, 2816, 62, cuda)
    x = _randn((4, 2816), 63, cuda).requires_grad_(True)
    g = _randn((4, 1280), 64, cuda)
    common.reset_launch_counts()
    y = fused_quantized_dot(x, values, scale)
    (dx,) = torch.autograd.grad(y, x, g)
    assert common.launch_counts()["int8_matmul"] == 1
    assert torch.equal(dx, dequantized_dx(g, values, scale, torch.bfloat16))
    for m in (4, 300):
        xd = _randn((m, 2816), 65 + m, cuda)
        got = quant.dense_quantized_dot_fwd(xd, values, scale)
        ref = quant.dense_quantized_dot_fwd(xd.cpu(), values.cpu(), scale.cpu())
        assert torch.equal(got.cpu(), ref)


def test_int8_matmul_rejects_unsupported(cuda):
    from pcm_tpu_torch.ops.int8_matmul import fused_quantized_dot_fwd

    values, scale = _int8_weight(64, 80, 66, cuda)  # K-tile 80: not a multiple of 32
    with pytest.raises(ValueError, match="K-tile"):
        fused_quantized_dot_fwd(_randn((8, 80), 67, cuda), values, scale)
    values, scale = _int8_weight(64, 256, 68, cuda)
    with pytest.raises(ValueError, match="bf16"):
        fused_quantized_dot_fwd(_randn((8, 256), 69, cuda).float(), values, scale)
