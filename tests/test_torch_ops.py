"""Plain versions of the port's kernels against the JAX Pallas kernels.

The JAX side runs with ``interpret=True``, as tests/test_ops.py does, so the
Pallas kernel bodies themselves execute on the CPU. Inputs come from numpy
and both sides compute in fp32; only the order of summation differs, so the
bound is rel-max 1e-5. (At K = 320 the JAX GEGLU does not run its kernel:
it falls back to its oracle, `pcm_tpu/ops/geglu.py:_forward`.) The gradients
go through the port's autograd Functions and JAX's custom VJPs, whose
flash-attention backward runs the Pallas K2/K3 bodies (`_bwd`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.ops import flash_attention as jax_flash_attention
from pcm_tpu.ops import geglu as jax_geglu
from pcm_tpu.ops import group_norm_silu as jax_group_norm_silu
from pcm_tpu.ops import group_norm_silu_reference as jax_group_norm_silu_reference
from pcm_tpu.ops.flash_attention import _bwd as jax_fa_bwd
from pcm_tpu.ops.flash_attention import _fwd as jax_fa_fwd
from pcm_tpu_torch.ops import common
from pcm_tpu_torch.ops.flash_attention import (FlashAttentionFn, attention_bwd_reference,
                                               attention_reference, bwd_tiles, dkv_splits,
                                               flash_attention, flash_attention_fwd, fwd_tiles)
from pcm_tpu_torch.ops.geglu import GEGLUFn, geglu, geglu_tiles
from pcm_tpu_torch.ops.groupnorm import (GroupNormSiLUFn, gn_partition, group_norm_silu,
                                         group_norm_stats_chunked)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rel_max(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 50, 77, 2, 16), (1, 70, 77, 2, 40),
                                         (1, 130, 77, 2, 16), (1, 130, 77, 2, 32)])
def test_attention_matches_pallas(b, sq, sk, h, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, d), dtype=np.float32) for s in (sq, sk, sk))
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    o_jax = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    assert rel_max(o, o_jax) < TOL
    # base-2 lse of the JAX forward kernel, (b, h, s, d) layout
    t = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    _, lse_jax = jax_fa_fwd(t(q), t(k), t(v), d ** -0.5, True)
    assert lse.shape == (b, h, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax), rtol=TOL, atol=TOL)


def _bhsd(a):
    return jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))


def _grads(fn, arrays, g):
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*xs).backward(torch.from_numpy(g))
    return [x.grad for x in xs]


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 50, 77, 2, 16), (1, 70, 77, 2, 40),
                                         (1, 130, 77, 2, 64), (1, 70, 70, 1, 80),
                                         (1, 65, 77, 1, 160)])
def test_attention_backward_matches_pallas(b, sq, sk, h, d):
    """The plain K2 + K3 from the saved base-2 lse against the Pallas `_bwd`
    (interpret mode) on the JAX forward's own o / lse, and against torch
    autograd of the plain attention: ragged sq and sk = 77, and the head dims
    of the main path (SD1.5 40/80/160, SDXL 64) with lengths that straddle
    the kernels' 64- and 128-row tiles."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((b, s, h, d), dtype=np.float32) for s in (sq, sk, sk))
    do = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    scale = d ** -0.5
    o_j, lse_j = jax_fa_fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale, True)
    dq_j, dk_j, dv_j = jax_fa_bwd(scale, True, None, None,
                                  (_bhsd(q), _bhsd(k), _bhsd(v), o_j, lse_j), _bhsd(do))
    ours = attention_bwd_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(np.array(jnp.transpose(o_j, (0, 2, 1, 3)))),
                                   torch.from_numpy(np.array(lse_j)), torch.from_numpy(do),
                                   scale)
    for name, a, r in zip("qkv", ours, (dq_j, dk_j, dv_j)):
        assert a.shape == (b, sq if name == "q" else sk, h, d)
        assert rel_max(a, jnp.transpose(r, (0, 2, 1, 3))) < TOL, name
    auto = _grads(lambda *a: attention_reference(*a, scale), (q, k, v), do)
    for name, a, r in zip("qkv", ours, auto):
        assert rel_max(a, r) < TOL, name


@pytest.mark.parametrize("d,tiles", [(16, (16, 1, 128, 64, 128, 64)),
                                     (40, (48, 1, 128, 64, 128, 64)),
                                     (64, (64, 1, 128, 64, 128, 64)),
                                     (80, (80, 1, 128, 32, 128, 64)),
                                     (88, (96, 2, 64, 64, 128, 64)),
                                     (128, (128, 2, 64, 64, 128, 32)),
                                     (160, (160, 2, 64, 32, 128, 32))])
def test_backward_tiles_per_head_dim(d, tiles):
    """K2/K3's padded head_dim, column split, block rows and step rows, as
    the CUDA dispatch takes them: a multiple of 16 up to 80, of 32 above;
    32-row steps where a warpgroup's accumulators are 80 (K2) or at least
    128 (K3) columns wide."""
    assert bwd_tiles(d) == tiles


@pytest.mark.parametrize("d,tiles", [(16, (16, 128, 128, 16)),
                                     (32, (32, 128, 128, 32)),
                                     (40, (48, 128, 128, 16)),
                                     (64, (64, 128, 128, 64)),
                                     (80, (80, 128, 64, 16)),
                                     (128, (128, 128, 64, 64)),
                                     (160, (160, 128, 64, 32)),
                                     (512, (512, 64, 32, 64))])
def test_forward_tiles_per_head_dim(d, tiles):
    """K1's padded head_dim, block rows, key step and TMA chunk, as the CUDA
    dispatch takes them: every head dim on TMA + wgmma; up to 160 128-row
    blocks, chunks of the widest swizzle dividing the padded head dim,
    128-key steps up to 64 accumulator columns and 64-key steps above; the
    VAE's 512-wide head in 64-row blocks of 32-key steps and 128-byte
    chunks."""
    assert fwd_tiles(d) == tiles
    assert fwd_tiles(d).d_pad == bwd_tiles(d).d_pad


@pytest.mark.parametrize("shape,sms,nsplit", [
    ((4, 8, 4096, 4096, 40), 132, 1),    # 1024 K2 blocks: no split
    ((4, 8, 4096, 77, 40), 132, 4),      # 32 blocks of 128 k rows
    ((4, 10, 4096, 77, 64), 132, 3),     # 40 blocks
    ((4, 20, 1024, 77, 64), 132, 1),     # 80 blocks: one wave either way
    ((4, 8, 1024, 77, 80), 132, 4),
    ((4, 8, 256, 77, 160), 132, 2),      # 64-row k blocks at d = 160
    ((4, 8, 64, 77, 160), 132, 1),       # two 32-row q steps
    ((1, 2, 130, 77, 64), 8, 1),         # 3 q steps: no split of 2 steps each
    ((1, 1, 1000, 70, 80), 8, 8),
])
def test_dkv_q_splits(shape, sms, nsplit):
    """How many blocks share K2's q range: about one block a SM when the key
    sequence is short, each split at least two q steps."""
    assert dkv_splits(*shape, sms=sms) == nsplit
    b, h, sq, sk, d = shape
    steps = -(-sq // bwd_tiles(d).k2_step)
    assert nsplit == 1 or -(-steps // nsplit) >= 2


def test_function_grads_match_jax_custom_vjps():
    """Grads of the three autograd Functions against jax.grad of the Pallas
    ops (interpret mode; GEGLU at K = 256 so its kernel runs)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, s, 2, 40), dtype=np.float32) for s in (70, 77, 77))
    g = rng.standard_normal((1, 70, 2, 40), dtype=np.float32)
    jfa = jax.vjp(lambda *a: jax_flash_attention(*a, interpret=True),
                  *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(g))
    for a, r in zip(_grads(flash_attention, (q, k, v), g), jfa):
        assert rel_max(a, r) < TOL

    x = rng.standard_normal((2, 7, 11, 320), dtype=np.float32)
    gamma, beta = (rng.standard_normal(320, dtype=np.float32) for _ in range(2))
    gx = rng.standard_normal(x.shape, dtype=np.float32)
    jgn = jax.vjp(lambda *a: jax_group_norm_silu(*a, 32, 1e-5, "silu", interpret=True),
                  *map(jnp.asarray, (x, gamma, beta)))[1](jnp.asarray(gx))
    for a, r in zip(_grads(lambda *a: group_norm_silu(*a, 32, 1e-5, "silu"), (x, gamma, beta),
                           gx), jgn):
        assert rel_max(a, r) < TOL

    xg = rng.standard_normal((3, 37, 256), dtype=np.float32)
    w = rng.standard_normal((256, 256), dtype=np.float32) * np.float32(256 ** -0.5)
    bias = rng.standard_normal(256, dtype=np.float32)
    gg = rng.standard_normal((3, 37, 128), dtype=np.float32)
    jgg = jax.vjp(lambda *a: jax_geglu(*a, interpret=True),
                  *map(jnp.asarray, (xg, w, bias)))[1](jnp.asarray(gg))
    ours = _grads(geglu, (xg, np.ascontiguousarray(w.T), bias), gg)
    for a, r in zip(ours, (jgg[0], jnp.transpose(jgg[1]), jgg[2])):  # w: nn.Linear layout
        assert rel_max(a, r) < TOL


def test_ops_carry_their_functions_and_student_lora_gets_grads():
    """On the CPU, as on the card, every op's output hangs off its autograd
    Function, so a TINY student forward gives every LoRA factor a gradient
    (a kernel output made with torch.empty would cut the graph there)."""
    from pcm_tpu_torch.configs.families import sd15_bundle
    from pcm_tpu_torch.train.bundles import adapter_like

    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    assert flash_attention(x, x, x).grad_fn.__class__.__name__ == FlashAttentionFn.__name__ + "Backward"
    y = torch.randn(1, 4, 4, 32, requires_grad=True)
    assert group_norm_silu(y, torch.ones(32), torch.zeros(32), 8).grad_fn.__class__.__name__ \
        == GroupNormSiLUFn.__name__ + "Backward"
    assert geglu(y, torch.randn(16, 32), torch.zeros(16)).grad_fn.__class__.__name__ \
        == GEGLUFn.__name__ + "Backward"

    bundle = sd15_bundle(lora_rank=4, dtype=torch.float32, tiny=True)
    gen = torch.Generator().manual_seed(0)
    frozen, template = bundle.init(gen, torch.device("cpu"))
    lora = {k: v.requires_grad_(True) for k, v in adapter_like(template, gen).items()}
    out = bundle.student(frozen, lora, torch.randn(2, 8, 8, 4), torch.tensor([10, 900]),
                         {"prompt_embeds": torch.randn(2, 7, 32)})
    out.square().mean().backward()
    missing = [k for k, v in lora.items() if v.grad is None or not torch.isfinite(v.grad).all()]
    assert not missing and len(lora) > 100


@pytest.mark.parametrize("act", ["silu", None])
def test_group_norm_matches_pallas(act):
    """77 spatial rows (no dividing block), 320 channels in 32 groups of 10."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 11, 320), dtype=np.float32)
    gamma = rng.standard_normal(320, dtype=np.float32)
    beta = rng.standard_normal(320, dtype=np.float32)
    ours = group_norm_silu(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                           32, 1e-5, act)
    ref = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5,
                              act, interpret=True)
    assert rel_max(ours, ref) < TOL


def test_group_norm_one_pass_variance_cancels():
    """Input offset by 100 with std 1, against a float64 GroupNorm. At 100 an
    fp32 input carries rounding of 7.6e-6, so the bound here is 5e-5. The
    Pallas kernel's one-pass E[x²] − μ² cancels and lands further off than
    the port's two-pass plain version (its CUDA kernel merges shifted sums)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 77, 320), dtype=np.float32) + np.float32(100.0)
    g, b = np.ones(320, np.float32), np.zeros(320, np.float32)
    pallas = np.asarray(jax_group_norm_silu(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                            32, 1e-5, None, interpret=True))
    ours = group_norm_silu(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
                           32, 1e-5, None).numpy()
    xg = x.astype(np.float64).reshape(1, 77, 32, 10)
    exact = ((xg - xg.mean(axis=(1, 3), keepdims=True))
             / np.sqrt(xg.var(axis=(1, 3), keepdims=True) + 1e-5)).reshape(x.shape)
    assert rel_max(ours, exact) < 5e-5
    assert rel_max(pallas, exact) > rel_max(ours, exact)


@pytest.mark.parametrize("n,s,c,part", [
    ((4, 262144, 256, (8, 3976, 66, 4, 8))),   # the SD1.5 VAE decoder at 512 px: 2 blocks an SM
    ((1, 262144, 128, (16, 1008, 261, 2, 8))),
    ((4, 4096, 320, (6, 66, 63, 4, 8))),       # SD1.5's 64x64 level: cg = 10
    ((8, 1024, 1280, (1, 32, 32, 4, 4))),
    ((4, 64, 1280, (1, 8, 8, 4, 4))),          # the 8x8 level: one unrolled sweep a chunk
    ((2, 77, 960, (2, 16, 5, 8, 2))),          # cg = 30
])
def test_gn_partition(n, s, c, part):
    """K4's grid: (row phases, rows a chunk, chunks a sample, merge lanes over
    a group's channels, over its chunks), the same for both launches; rows a
    multiple of the row phases, at most 512 threads."""
    got = gn_partition(n, s, c, 32)
    assert got == part
    assert got.rows_per_chunk % got.rs == 0 and got.rs * c // 8 <= 512
    assert (got.nchunk - 1) * got.rows_per_chunk < s <= got.nchunk * got.rows_per_chunk


@pytest.mark.parametrize("shape,rows,offset", [
    ((2, 7, 11, 320), None, 0.0),     # S = 77, cg = 10, two chunks of 48 rows
    ((1, 4000, 320), 48, 100.0),      # 84 chunks (11 a lane of 8-lane segments), the last ragged
    ((2, 7, 11, 960), None, 100.0),   # cg = 30: vectors straddle groups
    ((1, 2000, 960), 16, 0.0),        # 125 ragged chunks
    ((4, 8, 8, 1280), None, 0.0),     # S = 64
])
def test_group_norm_chunked_stats(shape, rows, offset):
    """The kernel's statistics (per-thread shifted sums, Chan's merge over
    row phases, then warp-segment merges over channels and over chunks) against
    float64, and the GroupNorm + SiLU built from them against the JAX
    reference. Bounds: the mean within 2.5e-7 of max |x| (about two fp32
    ulps: 2.6e-5 at the +100 offset), rstd within 1e-5 relative; the output
    within the file's fp32 bound, or 5e-5 at the +100 offset, where an fp32
    input carries rounding of 7.6e-6 and both sides' means err by as much."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape, dtype=np.float32) + np.float32(offset)
    c = shape[-1]
    gamma = rng.standard_normal(c, dtype=np.float32)
    beta = rng.standard_normal(c, dtype=np.float32)
    mean, rstd = group_norm_stats_chunked(torch.from_numpy(x), 32, 1e-5, rows_per_chunk=rows)
    xg = x.astype(np.float64).reshape(shape[0], -1, 32, c // 32)
    assert np.abs(mean.numpy() - xg.mean(axis=(1, 3))).max() <= 2.5e-7 * np.abs(x).max()
    exact = 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5)
    assert np.abs(rstd.numpy() / exact - 1).max() <= 1e-5
    # the kernel's affine map: a_c = rstd * gamma rounded, then (x - mean) * a_c + beta
    xf = torch.from_numpy(x).reshape(shape[0], -1, c)
    a = rstd.repeat_interleave(c // 32, 1) * torch.from_numpy(gamma)
    y = (xf - mean.repeat_interleave(c // 32, 1)[:, None]) * a[:, None] + torch.from_numpy(beta)
    ref = jax_group_norm_silu_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                        32, 1e-5, "silu")
    assert rel_max(torch.nn.functional.silu(y).reshape(shape), ref) < (5e-5 if offset else TOL)


@pytest.mark.parametrize("k,f,rows", [pytest.param(320, 128, 37, id="320-128"),
                                      pytest.param(256, 128, 37, id="256-128"),
                                      pytest.param(256, 128, 100, id="256-128-m300")])
def test_geglu_matches_pallas(k, f, rows):
    """M = 3 x rows (111, 300) is not a multiple of the kernel's 128-row
    blocks nor of the Pallas kernel's 256-row ones."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, rows, k), dtype=np.float32)
    w = rng.standard_normal((k, 2 * f), dtype=np.float32) * np.float32(k ** -0.5)
    b = rng.standard_normal(2 * f, dtype=np.float32)
    # the port takes the nn.Linear layout (2F, K)
    ours = geglu(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                 torch.from_numpy(b))
    ref = jax_geglu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    assert ours.shape == (3, rows, f)
    assert rel_max(ours, ref) < TOL


@pytest.mark.parametrize("m,k,f,tiles", [
    (16384, 320, 1280, (5, (10, 128))), (32768, 320, 1280, (5, (10, 256))),
    (4096, 640, 2560, (10, (20, 32))), (1024, 1280, 5120, (20, (40, 8))),
    (256, 1280, 5120, (20, (40, 2))), (32768, 640, 2560, (10, (20, 256))),
    (8192, 1280, 5120, (20, (40, 64))), (1000, 320, 1000, (5, (8, 8))),
])
def test_geglu_tiles(m, k, f, tiles):
    """K5's k steps and grid (N tiles fastest) at the main path's shapes
    (SD1.5 and SDXL feed-forwards) and a ragged M / F: 128 x 128 blocks of
    value and gate, 64-column k steps (K = 320 takes five)."""
    got = geglu_tiles(m, k, f)
    assert (got.block_m, got.block_n, got.block_k) == (128, 128, 64)
    assert (got.k_steps, got.grid) == tiles


def test_dispatch_by_device():
    x = torch.zeros(2, 8)
    assert common.use_kernel(x) is False
    with pytest.raises(ValueError, match="device"):
        common.use_kernel(torch.zeros(2, 8, device="meta"))
    before = common.launch_counts()
    geglu(torch.ones(2, 8), torch.ones(16, 8), torch.zeros(16))
    assert common.launch_counts() == before  # the plain version counts nothing
    with common.reference_ops():
        assert common.use_kernel(x) is False


def test_hash_tokenizer_matches_jax_package():
    from pcm_tpu.data.tokenizer import HashTokenizer as JaxHash
    from pcm_tpu_torch.data.tokenizer import HashTokenizer

    texts = ["a red square", "", "An astronaut riding a horse " * 20]
    np.testing.assert_array_equal(HashTokenizer()(texts), JaxHash(quiet=True)(texts))


def test_port_imports_no_jax():
    """Importing every module of the port (and the serving entry point) loads no jax."""
    import pkgutil
    import subprocess
    import sys

    import pcm_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(pcm_tpu_torch.__path__, "pcm_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pcm_tpu.'))]\n"
            "print(len(sys.modules)); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "pcm_tpu_torch.serving.__main__" in mods
