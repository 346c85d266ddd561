"""Int8 frozen weights and the K6 fused int8 matmul of the port against
`pcm_tpu` (CPU; the JAX side runs its Pallas kernel in interpret mode).

Inputs are drawn with numpy. Bounds: the K6 plain version against
`fused_quantized_dot` rel-max 1e-6 in fp32 (the same integer products and
scales; XLA may contract ``acc + part * s`` into one rounding) and in bf16
at most one ulp of each entry (or, near zero, the fp32 bound); the weight codes and scales bit-equal; `dense` against
`_qdot` 1e-6; the backward dx against `_qdot_bwd` rtol 1e-5. Whole layers
and models on int8 paths: 1e-3, since an fp32 round-off between the two
packages can flip one activation code (a step of amax/127 in one product).
"""

import contextlib
import json
from fractions import Fraction

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.lora.layers import LoRAConv as JLoRAConv
from pcm_tpu.lora.layers import LoRADense as JLoRADense
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models.unet import TINY_SDXL_CONFIG as J_TINY_SDXL
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.ops.int8_matmul import _pick_block
from pcm_tpu.ops.int8_matmul import fused_quantized_dot as jax_fused_dot
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu.utils import quant as jquant
from pcm_tpu_torch.lora.layers import LoRAConv, LoRALinear, LoRASpec, attach_lora
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.unet import TINY_SDXL_CONFIG, UNet2DCondition
from pcm_tpu_torch.models import unet as unet_module
from pcm_tpu_torch.ops.int8_matmul import (Int8MatmulFn, fused_quantized_dot,
                                           fused_quantized_dot_reference, int_product,
                                           pick_block, quantize_tiles_reference)
from pcm_tpu_torch.utils import quant
from torch_port_helpers import random_params, rel_max


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def _weight(rng, k, n):
    """A JAX dense kernel (k, n) and its JAX quantization."""
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    return w, jquant.quantize(jnp.asarray(w))


def _port_q(qt):
    """JAX QTensor (k, n) -> the port's (n, k) codes and (n,) scales."""
    return t(np.asarray(qt.values).T.copy()), t(np.asarray(qt.scale).reshape(-1))


def _bf16_ulp(a):
    """The bf16 ulp at |a| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(a, np.float32)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


# ---------------------------------------------------------------------------
# K6 and the int8 products
# ---------------------------------------------------------------------------


def test_pick_block_matches_jax():
    for dim in list(range(32, 3000, 32)) + [77, 1000, 2816, 5120, 10240]:
        assert pick_block(dim, 512, 128) == _pick_block(dim, 512, 128), dim


@pytest.mark.parametrize("k", [320, 640, 1280, 2048])
def test_k6_plain_matches_pallas(k):
    """Ragged M (308, not a multiple of the 8-row or 256-row tiles) with an
    all-zero row, at the K-tiles 320 / 128 / 256 / 512."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((308, k)).astype(np.float32)
    x[5] = 0.0
    x[:, : k // 3] *= 20.0  # an outlier block: the K-tiles get different scales
    w, qt = _weight(rng, k, 128)
    values, scale = _port_q(qt)
    ref = np.asarray(jax_fused_dot(jnp.asarray(x), qt.values, qt.scale, out_dtype=jnp.float32))
    ours = fused_quantized_dot_reference(t(x), values, scale).numpy()
    assert rel_max(ours, ref) <= 1e-6
    assert np.all(ours[5] == 0)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_b = jax_fused_dot(xb, qt.values, qt.scale, out_dtype=jnp.bfloat16)
    ours_b = fused_quantized_dot_reference(t(np.asarray(xb, np.float32)).bfloat16(), values, scale)
    assert ours_b.dtype == torch.bfloat16
    # one bf16 ulp of the reference, or the fp32 bound near zero (a value
    # far below its row's scale carries the fp32 sums' round-off)
    ours_b, ref_b = ours_b.float().numpy(), np.asarray(ref_b, np.float32)
    bound = np.maximum(_bf16_ulp(ref_b), 1e-6 * np.abs(ref_b).max())
    assert np.all(np.abs(ours_b - ref_b) <= bound)


@pytest.mark.parametrize("k", [320, 640])
def test_k6_quantize_pass_matches_pallas(k):
    """The plain quantize pass (codes and scales per (row, K-tile), scales
    laid out (K / bk, M)) at the K-tiles 320 and 128, ragged M, an all-zero
    row: bit for bit against the Pallas kernel's own quantization, read
    through an identity weight (each output is then fl(code * s) of one
    tile, in fp32), and, through the exact tile products, against
    `fused_quantized_dot_reference`."""
    rng = np.random.default_rng(10 + k)
    bk = pick_block(k, 512, 128)
    x = rng.standard_normal((300, k)).astype(np.float32)
    x[7] = 0.0
    x[:, : k // 3] *= 20.0
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = t(np.asarray(xb, np.float32)).bfloat16()
    codes, scales = quantize_tiles_reference(xt, bk)
    assert codes.dtype == torch.int8 and codes.shape == (300, k)
    assert scales.dtype == torch.float32 and scales.shape == (k // bk, 300)
    assert not codes[7].any() and torch.all(scales[:, 7] == 1)
    eye = jnp.eye(k, dtype=jnp.int8)
    pallas = np.asarray(jax_fused_dot(xb, eye, jnp.ones((1, k), jnp.float32),
                                      out_dtype=jnp.float32))
    ours = codes.float() * scales.repeat_interleave(bk, 0).t()
    np.testing.assert_array_equal(ours.numpy(), pallas)

    _, qt = _weight(rng, k, 136)
    values, scale = _port_q(qt)
    acc = torch.zeros((300, 136))
    for i in range(k // bk):
        tile = slice(i * bk, (i + 1) * bk)
        acc = acc + int_product(codes[:, tile].float(), values[:, tile]) * scales[i][:, None]
    out = (acc * scale.reshape(1, -1)).bfloat16()
    assert torch.equal(out, fused_quantized_dot_reference(xt, values, scale))


def _rn32(v: Fraction) -> float:
    """A positive rational rounded to the nearest float32, ties to even."""
    e = v.numerator.bit_length() - v.denominator.bit_length()
    while Fraction(2) ** e > v:
        e -= 1
    q = v / Fraction(2) ** (e - 23)
    n, rem = divmod(q.numerator, q.denominator)
    if 2 * rem > q.denominator or (2 * rem == q.denominator and n % 2):
        n += 1
    return float(n * Fraction(2) ** (e - 23))


def test_k6_fast_quotient_is_correctly_rounded():
    """The quantize pass of `csrc/int8_matmul.cu` divides as q0 = fl(x r), q =
    fl(q0 + fl(x - q0 s) r) with r = fl(1/s) taken once a (row, K-tile): two
    FMAs, no reciprocal an element. It must give fl(x / s), the IEEE quotient
    of the plain version, for bf16 x with |x| <= amax and s = fl(amax *
    fl(1/127)). Checked in exact arithmetic for every bf16 significand of x
    and of amax and 21 binades of x below amax (the rounding depends on
    nothing else while s stays in the kernel's range [2^-100, 2^100]; below
    those binades |x / s| < 1e-4, code 0 either way)."""
    f32 = lambda v: v.astype(np.float32).astype(np.float64)  # noqa: E731
    sig = (128 + np.arange(128)) / 128.0  # bf16 significands in [1, 2)
    amax = sig[:, None, None]
    x = np.broadcast_to(sig[None, None, :] * np.exp2(-np.arange(21))[None, :, None],
                        (128, 21, 128))
    s = f32(amax * np.float64(np.float32(1.0 / 127.0)))  # the product is exact in float64
    r = np.array([_rn32(1 / Fraction(v)) for v in s.ravel()]).reshape(s.shape)
    q0 = f32(x * r)  # 8 x 24 bits: exact before the one rounding
    e = x - q0 * s  # fma(-q0, s, x): exact in float64 (checked), then rounded
    assert np.all((x - e) - q0 * s == 0)
    e = f32(e)
    hi = q0 + e * r  # fma(e, r, q0): e r is exact; hi + lo is the exact sum (Fast2Sum)
    lo = (q0 - hi) + e * r
    q = f32(hi)
    up = np.nextafter(q.astype(np.float32), np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(q.astype(np.float32), np.float32(-np.inf)).astype(np.float64)
    # hi on a float32 midpoint: the exact sum's side of it decides
    q = np.where((hi == (q + up) / 2) & (lo > 0), up,
                 np.where((hi == (q + dn) / 2) & (lo < 0), dn, q))
    # q is fl(x / s) iff x / s lies within half the gap to each neighbour of q
    # (on the half only if q is even)
    d = x - q * s
    assert np.all((x - d) - q * s == 0)
    up = np.nextafter(q.astype(np.float32), np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(q.astype(np.float32), np.float32(-np.inf)).astype(np.float64)
    even = (q.astype(np.float32).view(np.uint32) & 1) == 0
    above, below = (up - q) / 2 * s, (q - dn) / 2 * s  # exact: powers of two times s
    ok = np.where(d > 0, (d < above) | ((d == above) & even),
                  (-d < below) | ((-d == below) & even))
    keep = x <= amax
    assert keep.sum() > 300_000 and np.all(ok[keep])


@pytest.mark.parametrize("kind", ["linear", "conv3x3", "conv1x1"])
def test_quantize_codes_match_jax(kind):
    """The port quantizes torch layouts ((out, in), (O, I, kh, kw)) to the
    codes and scales JAX gives the transposed kernel, bit for bit."""
    rng = np.random.default_rng(1)
    shape = {"linear": (96, 40), "conv3x3": (3, 3, 16, 24), "conv1x1": (1, 1, 64, 32)}[kind]
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: scale 1
    ref = jquant.quantize(jnp.asarray(w))
    perm = (1, 0) if w.ndim == 2 else (3, 2, 0, 1)
    ours = quant.quantize(t(w.transpose(perm).copy()))
    assert ours.values.dtype == torch.int8
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(ref.values).transpose(perm))
    np.testing.assert_array_equal(ours.scale.numpy().reshape(-1),
                                  np.asarray(ref.scale).reshape(-1))
    assert ours.scale.shape == (shape[-1],) + (1,) * (w.ndim - 1)
    np.testing.assert_array_equal(ours.astype(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)).transpose(perm))


def test_dense_matches_qdot():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 50, 1280)).astype(np.float32)
    _, qt = _weight(rng, 1280, 64)
    values, scale = _port_q(qt)
    ref = np.asarray(jquant._qdot(jnp.asarray(x), qt.values, qt.scale, jnp.float32))
    ours = quant.dense_quantized_dot_fwd(t(x), values, scale).numpy()
    assert ours.shape == (3, 50, 64)
    assert rel_max(ours, ref) <= 1e-6


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_backward_dx_matches_qdot_bwd(mode):
    """Both int8 paths share `_qdot_bwd`: dx = g · dequant(W), no gradient
    for the codes or the scales."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 640)).astype(np.float32)
    g = rng.standard_normal((2, 30, 96)).astype(np.float32)
    _, qt = _weight(rng, 640, 96)
    ref, _, _ = jquant._qdot_bwd(jnp.float32, (qt.values, qt.scale), jnp.asarray(g))
    values, scale = _port_q(qt)
    xt = t(x).requires_grad_(True)
    with quant.int8_matmul(mode):
        y = quant.quantized_dot(xt, quant.QTensor(values, scale[:, None]))
    y.backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert y.grad_fn is not None
    # the Function itself: nothing flows to the int8 codes or the scales
    fn_grads = Int8MatmulFn.backward(type("Ctx", (), {"saved_tensors": (values, scale),
                                                      "dtype": torch.float32})(), t(g))
    assert fn_grads[1:] == (None, None, None)


def test_int8_modes(monkeypatch):
    """Nested contexts; ``conv`` and ``both`` are entered with the JAX
    package's warning."""
    monkeypatch.delenv("PCM_INT8_MATMUL", raising=False)
    assert quant.int8_mode() is None
    with quant.int8_matmul("fused"):
        assert quant.int8_mode() == "fused"
        with quant.int8_matmul("dense"):
            assert quant.int8_mode() == "dense"
        assert quant.int8_mode() == "fused"
    assert quant.int8_mode() is None
    for which in ("conv", "both"):
        with pytest.warns(UserWarning, match="SPATIAL convs"):
            with quant.int8_matmul(which):
                assert quant.int8_mode() == which
    assert quant.int8_mode() is None


def test_int8_matmul_which_scopes_op_class(monkeypatch):
    """As `tests/test_int8_matmul.py::test_int8_matmul_which_scopes_op_class`:
    ``which`` narrows the int8 path to Linears or convs, ``PCM_INT8_MATMUL``
    is read when no context is set ("1": both), a context beats it, and each
    state gives `int8_matmul_enabled` what JAX's gives on the same calls."""
    def both(kind):
        ours, theirs = quant.int8_matmul_enabled(kind), jquant.int8_matmul_enabled(kind)
        assert ours == theirs, kind
        return ours

    monkeypatch.delenv("PCM_INT8_MATMUL", raising=False)
    assert not both("dense") and not both("conv")
    for which, dense, conv in (("dense", True, False), ("fused", True, False),
                               ("conv", False, True), ("both", True, True)):
        with pytest.warns(UserWarning) if which in ("conv", "both") else contextlib.nullcontext():
            with quant.int8_matmul(which), jquant.int8_matmul(which=which):
                assert (both("dense"), both("conv")) == (dense, conv), which
    for env, mode in (("1", "both"), ("conv", "conv"), ("dense", "dense"), ("fused", "fused"),
                      ("0", None), ("bogus", None)):
        monkeypatch.setenv("PCM_INT8_MATMUL", env)
        assert quant.int8_mode() == mode, env
        both("dense"), both("conv")
    monkeypatch.setenv("PCM_INT8_MATMUL", "conv")
    with quant.int8_matmul(enable=False), jquant.int8_matmul(enable=False):  # context beats env
        assert quant.int8_mode() is None and not both("conv")
    with quant.int8_matmul("dense"), jquant.int8_matmul(which="dense"):
        assert quant.int8_mode() == "dense" and not both("conv")
    with pytest.raises(ValueError):
        quant.int8_matmul("bogus")


@pytest.mark.parametrize("mode", ["conv", "both"])
@pytest.mark.parametrize("geometry", ["1x1", "3x3", "3x3_stride2", "2x2_stride2"])
def test_quantized_conv_matches_qconv(geometry, mode):
    """`quantized_conv` under ``conv`` / ``both`` (`QConvFn`: per-sample
    activation scales over (C, H, W), the exact integer conv, fp32 rescale)
    against JAX's ``_qconv`` under jit: the output bit for bit, at 1x1, 3x3
    stride 1 and 2 (padding 1), and SD3's ``pos_embed.proj`` 2x2 stride 2;
    ``dx`` against ``_qconv_bwd`` rtol 1e-5 (the dequantized conv's input
    gradient), none for the codes or the scales. A sample of all zeros
    gives scale 1 and a zero output."""
    ks, stride, pad = {"1x1": ((1, 1), (1, 1), 0), "3x3": ((3, 3), (1, 1), 1),
                       "3x3_stride2": ((3, 3), (2, 2), 1),
                       "2x2_stride2": ((2, 2), (2, 2), 0)}[geometry]
    rng = np.random.default_rng(20)
    x = rng.standard_normal((3, 8, 8, 32)).astype(np.float32)
    x[1] *= 20.0  # the samples get different scales
    x[2] = 0.0
    w = (rng.standard_normal((*ks, 32, 48)) * 0.1).astype(np.float32)
    qt = jquant.quantize(jnp.asarray(w))
    jpad = ((pad, pad), (pad, pad))
    f = jax.jit(lambda x_: jquant._qconv(x_, qt.values, qt.scale, jnp.float32, stride, jpad))
    ref, vjp = jax.vjp(f, jnp.asarray(x))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    (dref,) = vjp(jnp.asarray(g))
    values = t(np.asarray(qt.values).transpose(3, 2, 0, 1).copy())
    scale = t(np.asarray(qt.scale).reshape(-1, 1, 1, 1).copy())
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    with pytest.warns(UserWarning, match="SPATIAL"), quant.int8_matmul(mode):
        y = quant.quantized_conv(xt, quant.QTensor(values, scale), None, stride, (pad, pad))
    y.backward(t(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert not y[2].any()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dref),
                               rtol=1e-5, atol=1e-6)
    assert y.grad_fn is not None and not values.requires_grad


def test_reference_ops_forces_named_kernels():
    """``reference_ops("int8_matmul")`` forces K6 alone to its plain version
    (how the card holds K6 to it inside a full model); the remat recompute
    keeps that choice."""
    from pcm_tpu_torch.ops import common

    assert common.reference_forced() == frozenset()
    with common.reference_ops("int8_matmul"):
        assert common.reference_forced() == {"int8_matmul"}
        with unet_module._remat_contexts()[1]:
            assert common.reference_forced() == {"int8_matmul"}
    with common.reference_ops():
        assert common.ALL_KERNELS in common.reference_forced()
    with pytest.raises(ValueError, match="unknown"):
        with common.reference_ops("int8"):
            pass


# ---------------------------------------------------------------------------
# LoRA layers on int8 weights
# ---------------------------------------------------------------------------


class _JWrap(fnn.Module):
    """One JAX LoRA layer named ``layer`` (so the LoRA target matches)."""

    kind: str
    features: int
    spec: JLoRASpec

    @fnn.compact
    def __call__(self, x):
        if self.kind == "linear":
            return JLoRADense(self.features, lora=self.spec, name="layer")(x)
        ks = (1, 1) if self.kind == "conv1x1" else (3, 3)
        return JLoRAConv(self.features, ks, padding="SAME", lora=self.spec, name="layer")(x)


def _warns(mode):
    """The JAX package's warning on entering ``conv`` or ``both``."""
    return pytest.warns(UserWarning, match="SPATIAL") if mode in ("conv", "both") \
        else contextlib.nullcontext()


class _Wrap(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x, lora):
        return self.layer(x, lora)


@pytest.mark.parametrize("mode", [None, "dense", "fused", "conv", "both"],
                         ids=["dequant", "dense", "fused", "conv", "both"])
@pytest.mark.parametrize("kind", ["linear", "conv1x1", "conv3x3"])
def test_lora_layers_match_jax(kind, mode):
    """`LoRALinear` / `LoRAConv` with int8 base weights against `LoRADense` /
    `LoRAConv` on `quantize_tree`'s QTensor, in each `int8_matmul` mode: a
    Linear takes the int8 product under ``dense``, ``fused`` and ``both``
    and dequantizes under ``conv``; a conv takes `QConvFn` under ``conv``
    and ``both``, K6 (1x1) or the dequantized conv (3x3) under ``fused``."""
    rng = np.random.default_rng(4)
    spec = JLoRASpec(rank=4, alpha=8.0, targets=("layer",))
    cin, cout = 256, 128
    x = rng.standard_normal((2, 6, 6, cin) if kind != "linear" else (2, 36, cin))
    x = x.astype(np.float32)
    jm = _JWrap(kind, cout, spec)
    v = random_params(jm.init, jnp.asarray(x), seed=5)
    qparams = jquant.quantize_tree(v["params"], min_size=0)
    if mode is None:
        ref = jm.apply({"params": qparams, "lora": v["lora"]}, jnp.asarray(x))
    else:
        with _warns(mode), jquant.int8_matmul(which=mode):
            ref = jax.jit(jm.apply)({"params": qparams, "lora": v["lora"]}, jnp.asarray(x))

    if kind == "linear":
        layer = LoRALinear(cin, cout)
    else:
        k = 1 if kind == "conv1x1" else 3
        layer = LoRAConv(cin, cout, k, padding=k // 2)
    port = _Wrap(layer)
    port.load_state_dict(convert.unet_state_from_jax(v["params"]))
    attach_lora(port, LoRASpec(4, 8.0, ("layer",)))
    quant.quantize_module(port, min_size=0)
    assert layer.weight is None and layer.weight_values.dtype == torch.int8
    adapter = convert.lora_state_from_jax(v["lora"])
    xt = t(x) if kind == "linear" else t(x).permute(0, 3, 1, 2)
    with torch.no_grad(), _warns(mode), (quant.int8_matmul(mode) if mode
                                         else contextlib.nullcontext()):
        out = port(xt, adapter)
    out = out if kind == "linear" else out.permute(0, 2, 3, 1)
    assert rel_max(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# whole UNets: quantize_frozen, convert, remat
# ---------------------------------------------------------------------------


def _tiny_sdxl_params(seed):
    spec = JLoRASpec(rank=4, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    return random_params(JUNet(J_TINY_SDXL, lora=spec).init, jnp.zeros((1, 16, 16, 4)),
                         jnp.zeros((1,)), jnp.zeros((1, 7, 32)), added, seed=seed)


def _port_unet(params, remat=False):
    port = UNet2DCondition(TINY_SDXL_CONFIG, remat=remat)
    port.load_state_dict(convert.unet_state_from_jax(params))
    attach_lora(port, LoRASpec(4, 8.0, SD_UNET_LORA_TARGETS))
    return port.eval().requires_grad_(False)


def test_quantize_frozen_matches_jax_bit_for_bit():
    """`quantize_frozen` on both sides of the same TINY SDXL UNet: the JAX
    QTensor tree converts to the port's int8 state dict exactly, loads into a
    quantized port module, and the bytes saved agree."""
    params = _tiny_sdxl_params(6)["params"]
    jq = jquant.quantize_frozen({"unet": params, "vae": {}}, min_size=0)
    port = _port_unet(params)
    quant.quantize_frozen({"unet": port, "vae": torch.nn.Identity()}, min_size=0)
    ours = port.state_dict()
    theirs = convert.unet_state_from_jax(jax.tree.map(np.asarray, jq["unet"]))
    assert set(ours) == set(theirs)
    n_int8 = 0
    for k, v in ours.items():
        assert theirs[k].shape == v.shape and theirs[k].dtype == v.dtype, k
        assert torch.equal(theirs[k], v), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 > 20
    fresh = _port_unet(params)
    quant.quantize_frozen({"unet": fresh}, min_size=0)
    fresh.load_state_dict(theirs)
    assert quant.quantized_bytes_saved({"unet": fresh}) == jquant.quantized_bytes_saved(jq)
    # the default threshold (65536 elements) picks the same few TINY weights
    default = quant.quantize_frozen({"unet": _port_unet(params)})
    assert quant.quantized_bytes_saved(default) == jquant.quantized_bytes_saved(
        jquant.quantize_frozen({"unet": params}))


@pytest.mark.parametrize("mode", ["conv", "both"])
def test_unet_conv_both_match_jax(mode):
    """The whole TINY SDXL UNet under ``conv`` / ``both`` on the same int8
    codes on both sides (`quantize_frozen`, bit for bit above): its output,
    its input gradient and its LoRA gradients against the JAX package's
    (`_qconv` / `_qdot` on the CPU) under a fixed output cotangent. Over a
    whole model an fp32 round-off between the packages can flip an
    activation code (a step of amax / 127 in one product), so each reading is
    held, as `tests/test_torch_int8_adv.py` holds a whole int8 step, to the
    larger of the whole-model bound of this module (1e-3) and four times the
    mode's own spread: each package's reading moved by nudging the input by
    -2, -1, +1 and +2 fp32 ulps (at these inputs one ulp moves the JAX
    package's own ``conv`` output by 3e-2 and its input gradient by 2e-2, as
    much as the packages differ); a LoRA gradient below 1e-6 of the largest
    is round-off."""
    v = _tiny_sdxl_params(9)
    jq = jquant.quantize_frozen({"unet": v["params"]}, min_size=0)["unet"]
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ts = np.array([999.0, 421.0], np.float32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
             "time_ids": np.tile(np.array([16, 16, 0, 0, 16, 16], np.float32), (2, 1))}
    cot = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    junet = JUNet(J_TINY_SDXL, lora=JLoRASpec(rank=4, alpha=8.0, targets=SD_UNET_LORA_TARGETS))

    def jloss(x_, lora):
        out = junet.apply({"params": jq, "lora": lora}, x_, ts, ctx, added)
        return jnp.sum(out * cot), out

    nudges = [n * 2.0 ** -23 for n in (-2, -1, 1, 2)]
    with _warns(mode), jquant.int8_matmul(which=mode):
        jgrad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))

        def jax_readings(nudge=0.0):
            (_, out), (dx, dlora) = jgrad(jnp.asarray(x * np.float32(1 + nudge)), v["lora"])
            return {"out": t(out), "dx": t(dx),
                    **{"lora." + k: g for k, g in convert.lora_state_from_jax(dlora).items()}}

        ref = jax_readings()
        jax_spread = [jax_readings(n) for n in nudges]

    port = _port_unet(v["params"])
    quant.quantize_frozen({"unet": port}, min_size=0)
    adapter = convert.lora_state_from_jax(v["lora"])

    def readings(nudge=0.0):
        lora = {k: a.clone().requires_grad_(True) for k, a in adapter.items()}
        xt = t(x * np.float32(1 + nudge)).permute(0, 3, 1, 2).requires_grad_(True)
        with _warns(mode), quant.int8_matmul(mode):
            out = port(xt, t(ts), t(ctx), lora, {k: t(a) for k, a in added.items()})
            out = out.permute(0, 2, 3, 1)
            grads = torch.autograd.grad((out * t(cot)).sum(), [xt] + list(lora.values()))
        return {"out": out.detach(), "dx": grads[0].permute(0, 2, 3, 1),
                **{"lora." + k: g for k, g in zip(lora, grads[1:])}}

    ours = readings()
    spread = [readings(n) for n in nudges]
    top = max(float(g.abs().max()) for k, g in ref.items() if k.startswith("lora."))
    assert set(ours) == set(ref)
    for k, r in ref.items():
        if k.startswith("lora.") and float(r.abs().max()) < 1e-6 * top:
            continue  # round-off
        noise = max([rel_max(s[k], ours[k]) for s in spread]
                    + [rel_max(s[k], r) for s in jax_spread])
        err = rel_max(ours[k], r)
        assert err <= max(1e-3, 4 * noise), (k, err, noise)


@pytest.mark.parametrize("mode", ["fused", "conv", "both", "env"])
def test_remat_grads_match_under_fused(mode, monkeypatch):
    """Checkpointed blocks recompute on the int8 path of the forward even
    when the backward runs outside the `int8_matmul` context (autograd's
    thread on the card): remat and no-remat LoRA grads are equal, in each
    mode that takes int8 products in the blocks, and with the mode set by
    ``PCM_INT8_MATMUL=1`` alone (``both``). Without the context's mode handed
    to the recompute they are not."""
    monkeypatch.delenv("PCM_INT8_MATMUL", raising=False)
    v = _tiny_sdxl_params(7)
    rng = np.random.default_rng(8)
    x = t(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    ts = t(np.array([999.0, 421.0], np.float32))
    ctx = t(rng.standard_normal((2, 7, 32)).astype(np.float32))
    added = {"text_embeds": t(rng.standard_normal((2, 32)).astype(np.float32)),
             "time_ids": t(np.tile(np.array([16, 16, 0, 0, 16, 16], np.float32), (2, 1)))}
    adapter = convert.lora_state_from_jax(v["lora"])
    if mode == "env":
        monkeypatch.setenv("PCM_INT8_MATMUL", "1")

    def grads(remat):
        port = _port_unet(v["params"], remat)
        quant.quantize_frozen({"unet": port}, min_size=0)
        lora = {k: a.clone().requires_grad_(True) for k, a in adapter.items()}
        with (contextlib.nullcontext() if mode == "env" else _warns(mode)), \
                (contextlib.nullcontext() if mode == "env" else quant.int8_matmul(mode)):
            loss = port(x, ts, ctx, lora, added).square().mean()
        return torch.autograd.grad(loss, list(lora.values()))  # outside the context

    plain, remat = grads(False), grads(True)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    if mode == "env":
        with quant.int8_matmul(enable=False):  # the env mode took int8 products
            dequant = grads(False)
        assert any(not torch.equal(a, b) for a, b in zip(plain, dequant))
        return

    lost = unet_module._remat_contexts
    try:  # a recompute that drops the int8 mode takes the dequantized weights:
        # torch sees other saved tensors, or the grads differ
        unet_module._remat_contexts = lambda: (contextlib.nullcontext(), contextlib.nullcontext())
        dropped = grads(True)
    except torch.utils.checkpoint.CheckpointError:
        dropped = None
    finally:
        unet_module._remat_contexts = lost
    assert dropped is None or any(not torch.equal(a, b) for a, b in zip(plain, dropped))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _write_cache(path, n=4):
    rng = np.random.default_rng(4)
    path.mkdir()
    np.savez(path / "shard_00000.npz",
             latents=rng.standard_normal((n, 8, 8, 4)).astype(np.float16),
             prompt_embeds=rng.standard_normal((n, 77, 32)).astype(np.float16))


@pytest.mark.parametrize("mode", ["fused", "dense", "scoped"])
def test_train_cli_int8(tmp_path, capsys, mode):
    """``--frozen-weights int8 --int8-matmul {fused,dense,scoped}`` for two
    tiny steps on the CPU: finite losses, int8 frozen weights, moving LoRA."""
    from pcm_tpu_torch.train.__main__ import main

    cache = tmp_path / "cache"
    _write_cache(cache)
    trainer = main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu",
                    "--cached-latents-dir", str(cache), "--output-dir", str(tmp_path / "run"),
                    "--batch-size", "2", "--log-every", "1", "--max-train-steps", "2",
                    "--frozen-weights", "int8", "--int8-matmul", mode])
    printed = capsys.readouterr().out
    assert trainer.global_step == 2 and f"int8 matmul {mode}" in printed
    assert "step 2:" in printed and "nan" not in printed
    assert quant.quantized_bytes_saved(trainer.frozen) > 0
    assert trainer.frozen["unet"].conv_in.weight_values.dtype == torch.int8
    assert trainer.frozen["vae"].state_dict()["post_quant_conv.weight"].is_floating_point()
    assert trainer.distill_cfg.int8_no_grad_fwd == (mode == "scoped")
    b = max(float(p.abs().max()) for k, p in trainer.state.params.items() if k.endswith("lora_b"))
    assert b > 0


def test_train_cli_int8_no_grad_fwd_is_scoped(tmp_path, capsys):
    """``--int8-no-grad-fwd`` (the JAX CLI's alias) trains as ``--int8-matmul
    scoped``: the same losses and the same LoRA, bit for bit."""
    from pcm_tpu_torch.train.__main__ import main

    cache = tmp_path / "cache"
    _write_cache(cache)
    runs = {}
    for flag in (["--int8-matmul", "scoped"], ["--int8-no-grad-fwd"]):
        out = tmp_path / flag[0].strip("-")
        trainer = main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu",
                        "--cached-latents-dir", str(cache), "--output-dir", str(out),
                        "--batch-size", "2", "--log-every", "1", "--max-train-steps", "2",
                        "--frozen-weights", "int8", *flag])
        assert trainer.distill_cfg.int8_no_grad_fwd
        rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        runs[flag[0]] = [r["loss"] for r in rows], trainer.state.params
    (loss_a, lora_a), (loss_b, lora_b) = runs.values()
    assert loss_a == loss_b and len(loss_a) == 2
    assert all(torch.equal(lora_a[k], lora_b[k]) for k in lora_a)
    assert "int8 matmul scoped" in capsys.readouterr().out


def test_train_cli_refuses_int8_matmul_without_int8_weights(tmp_path, capsys):
    from pcm_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--recipe", "sd15_4phase", "--tiny", "--device", "cpu", "--output-dir",
              str(tmp_path / "o"), "--cached-latents-dir", str(tmp_path),
              "--int8-matmul", "fused"])
    assert exc.value.code != 0
    assert "requires --frozen-weights int8" in capsys.readouterr().err


def test_serving_int8_weights_dequantize_per_use():
    """``--weights int8`` serving: weight-only, the products stay in float,
    and the images stay close to those of the float weights."""
    from pcm_tpu_torch.configs.families import sd15_bundle
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.data.tokenizer import HashTokenizer
    from pcm_tpu_torch.sampling.ddim import DDIMSampler
    from pcm_tpu_torch.serving import EngineConfig, InferenceEngine

    bundle = sd15_bundle(4, dtype=torch.float32, tiny=True)
    dev = torch.device("cpu")
    frozen, _ = bundle.init(torch.Generator().manual_seed(3), dev)
    cfg = EngineConfig(batch_size=2, latent_hw=8, guidance_scale=1.0)
    sampler = DDIMSampler.create(make_ddpm_schedule(), 2)
    toks = {"input_ids": HashTokenizer()}
    eng = InferenceEngine(bundle, sampler, frozen, None, toks, cfg, dev)
    ref = eng.generate_batch(["a cat", "a dog"], [1, 2]).astype(np.float32)
    quant.quantize_frozen(frozen, min_size=0)
    out = eng.generate_batch(["a cat", "a dog"], [1, 2]).astype(np.float32)
    assert out.shape == ref.shape and np.abs(out - ref).mean() < 4.0  # of 255
    assert frozen["text"].text_model.encoder.layers[0].mlp.fc1.weight is None
