"""Port modules against their flax counterparts (fp32, CPU, TINY sizes).

Weights are drawn with numpy in the shapes of the JAX init (every leaf
random, LoRA ``b`` non-zero so the adapters act) and cross through
`pcm_tpu_torch.models.convert`. Bound: rel-max 5e-4, as tests/test_parity_torch.py uses for
whole backbones (fp32; convolution and matmul order differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcm_tpu.configs.families import _TINY_CLIP_SD15 as J_TINY_CLIP
from pcm_tpu.configs.families import sd15_bundle as jax_sd15_bundle
from pcm_tpu.lora.layers import LoRASpec as JLoRASpec
from pcm_tpu.models import convert as jconvert
from pcm_tpu.models.attention import Transformer2D as JTransformer2D
from pcm_tpu.models.clip import CLIPTextModel as JCLIP
from pcm_tpu.models.clip import convert_clip_torch_state
from pcm_tpu.models.resnet import ResnetBlock2D as JResnet
from pcm_tpu.models.unet import TINY_UNET_CONFIG as J_TINY_UNET
from pcm_tpu.models.unet import UNet2DCondition as JUNet
from pcm_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from pcm_tpu.models.vae import AutoencoderKL as JVAE
from pcm_tpu.ops.common import reference_ops as jax_reference_ops
from pcm_tpu.train.bundles import SD_UNET_LORA_TARGETS
from pcm_tpu_torch.configs.families import _TINY_CLIP_SD15, sd15_bundle
from pcm_tpu_torch.data.tokenizer import HashTokenizer
from pcm_tpu_torch.lora.layers import LoRASpec, attach_lora, lora_shapes
from pcm_tpu_torch.models import convert
from pcm_tpu_torch.models.attention import Transformer2D
from pcm_tpu_torch.models.clip import CLIP_L_CONFIG, CLIPTextModel
from pcm_tpu_torch.models.resnet import ResnetBlock2D
from pcm_tpu_torch.models.unet import TINY_UNET_CONFIG, UNet2DCondition
from pcm_tpu_torch.models.vae import TINY_VAE_CONFIG, AutoencoderKL
from torch_port_helpers import random_params, rel_max

TOL = 5e-4
TARGETS_NO_FF_IN = tuple(t for t in SD_UNET_LORA_TARGETS if t != "net_0_proj")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def _load(module, state):
    own = module.state_dict()
    module.load_state_dict({k: v for k, v in state.items() if k in own}, strict=True)
    return module.eval()


def test_resnet_block_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 32), dtype=np.float32)
    temb = rng.standard_normal((2, 48), dtype=np.float32)
    spec = JLoRASpec(rank=4, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    jm = JResnet(out_channels=64, norm_groups=8, lora=spec)
    v = random_params(jm.init, jnp.asarray(x), jnp.asarray(temb), seed=1)
    lora = v["lora"]
    ref = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(temb))

    port = _load(ResnetBlock2D(32, 64, 48, norm_groups=8), convert.unet_state_from_jax(v["params"]))
    attach_lora(port, LoRASpec(4, 8.0, SD_UNET_LORA_TARGETS))
    with torch.no_grad():
        out = port(nchw(x), torch.from_numpy(temb), convert.lora_state_from_jax(lora))
    assert rel_max(nhwc(out), ref) < TOL


@pytest.mark.parametrize("targets", [SD_UNET_LORA_TARGETS, TARGETS_NO_FF_IN],
                         ids=["ff_in_lora_split", "ff_in_fused_geglu"])
def test_transformer2d_matches_flax(targets):
    """Both FF forms: LoRA on ``net_0_proj`` (split a·gelu(gate)) and none
    (the fused GEGLU op); the teacher pass (no adapter) takes the fused one."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 32), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 24), dtype=np.float32)
    spec = JLoRASpec(rank=4, alpha=8.0, targets=targets)
    jm = JTransformer2D(channels=32, heads=2, head_dim=16, depth=1, cross_attention_dim=24,
                        norm_groups=8, lora=spec)
    v = random_params(jm.init, jnp.asarray(x), jnp.asarray(ctx), seed=3)
    lora = v["lora"]
    ref_s = jm.apply({"params": v["params"], "lora": lora}, jnp.asarray(x), jnp.asarray(ctx))
    teacher = JTransformer2D(32, 2, 16, 1, 24, norm_groups=8)
    ref_t = teacher.apply({"params": v["params"]}, jnp.asarray(x), jnp.asarray(ctx))

    port = _load(Transformer2D(32, 2, 16, 1, 24, norm_groups=8),
                 convert.unet_state_from_jax(v["params"]))
    attach_lora(port, LoRASpec(4, 8.0, targets))
    ad = convert.lora_state_from_jax(lora)
    assert ("transformer_blocks.0.ff.net.0.proj.lora_a" in ad) == ("net_0_proj" in targets)
    with torch.no_grad():
        out_s = port(nchw(x), torch.from_numpy(ctx), ad)
        out_t = port(nchw(x), torch.from_numpy(ctx), None)
    assert rel_max(nhwc(out_s), ref_s) < TOL
    assert rel_max(nhwc(out_t), ref_t) < TOL


@pytest.fixture(scope="module")
def tiny_unet():
    spec = JLoRASpec(rank=4, alpha=8.0, targets=SD_UNET_LORA_TARGETS)
    x = jnp.zeros((1, 16, 16, 4))
    v = random_params(JUNet(J_TINY_UNET, lora=spec).init, x, jnp.zeros((1,)),
                      jnp.zeros((1, 7, 32)), seed=4)
    return spec, v["params"], v["lora"]


def test_unet_matches_flax(tiny_unet):
    spec, params, lora = tiny_unet
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.array([999.0, 499.0], np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref_s = jax.jit(JUNet(J_TINY_UNET, lora=spec).apply)({"params": params, "lora": lora}, *jargs)
    ref_t = jax.jit(JUNet(J_TINY_UNET).apply)({"params": params}, *jargs)

    port = _load(UNet2DCondition(TINY_UNET_CONFIG), convert.unet_state_from_jax(params))
    attach_lora(port, LoRASpec(4, 8.0, SD_UNET_LORA_TARGETS))
    ad = convert.lora_state_from_jax(lora)
    assert set(ad) == set(lora_shapes(port, 4))  # the same layers carry LoRA
    targs = (nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        assert rel_max(nhwc(port(*targs, ad)), ref_s) < TOL
        assert rel_max(nhwc(port(*targs)), ref_t) < TOL


def test_vae_decoder_matches_flax():
    v = random_params(JVAE(J_TINY_VAE).init, jnp.zeros((1, 16, 16, 3)), seed=5)
    z = np.random.default_rng(6).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ref = jax.jit(lambda v_, z_: JVAE(J_TINY_VAE).apply(v_, z_, method=JVAE.decode))(v, jnp.asarray(z))
    port = _load(AutoencoderKL(TINY_VAE_CONFIG), convert.vae_state_from_jax(v["params"]))
    with torch.no_grad():
        out = nhwc(port.decode(nchw(z)))
    assert out.shape == (2, 16, 16, 3)
    assert rel_max(out, ref) < TOL


def test_clip_matches_flax():
    ids = HashTokenizer()(["a photo of a cat", "an astronaut riding a horse on the moon"])
    v = random_params(JCLIP(J_TINY_CLIP).init, jnp.asarray(ids), seed=6)
    hs_ref, last_ref, pooled_ref = jax.jit(JCLIP(J_TINY_CLIP).apply)(v, jnp.asarray(ids))
    port = _load(CLIPTextModel(_TINY_CLIP_SD15),
                 convert.clip_state_from_jax(v["params"], _TINY_CLIP_SD15))
    with torch.no_grad():
        hs, last, pooled = port(torch.from_numpy(ids).long())
    assert rel_max(last, last_ref) < TOL
    assert rel_max(pooled, pooled_ref) < TOL
    assert rel_max(hs[-2], hs_ref[-2]) < TOL


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("model", ["unet", "vae", "clip"])
def test_convert_round_trip_is_exact(model, tiny_unet):
    """JAX params -> port state dict -> the JAX package's own torch converter
    -> the same JAX tree, bit for bit."""
    if model == "unet":
        params = tiny_unet[1]
        back = jconvert.convert_unet_torch_state(convert.unet_state_from_jax(params), J_TINY_UNET)
    elif model == "vae":
        params = random_params(JVAE(J_TINY_VAE).init, jnp.zeros((1, 16, 16, 3)), seed=7)["params"]
        back = jconvert.convert_vae_torch_state(convert.vae_state_from_jax(params), J_TINY_VAE)
    else:
        params = random_params(JCLIP(J_TINY_CLIP).init, jnp.zeros((1, 77), jnp.int32),
                               seed=8)["params"]
        back = convert_clip_torch_state(convert.clip_state_from_jax(params, _TINY_CLIP_SD15),
                                        J_TINY_CLIP)
    _assert_trees_equal(np_tree(back), params)


def test_full_width_structure_matches_jax_bundle():
    """Every full-width SD1.5 parameter: the converted `jax.eval_shape` tree of
    the JAX bundle gives exactly the port's state-dict keys and shapes (built
    on the meta device: no memory), and the same LoRA factors."""
    jb = jax_sd15_bundle(remat=False)
    with jax_reference_ops():
        frozen, lora = jax.eval_shape(lambda r: jb.init(r), jax.random.PRNGKey(0))
    port = sd15_bundle().build(torch.device("meta"))

    def shapes(module, drop=()):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()
                if not k.startswith(drop)}

    assert convert.state_shapes_from_jax(frozen["unet"]) == shapes(port["unet"])
    assert convert.state_shapes_from_jax(frozen["vae"]) == shapes(port["vae"])  # encoder too
    text = convert.state_shapes_from_jax(convert.clip_tree_from_jax(frozen["text"], CLIP_L_CONFIG))
    assert text == shapes(port["text"])
    assert convert.state_shapes_from_jax(lora) == lora_shapes(port["unet"], 64)
    assert sum(p.numel() for p in port["unet"].parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(frozen["unet"]))
