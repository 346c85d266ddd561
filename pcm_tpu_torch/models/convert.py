"""Weights across the two packages: JAX parameter trees -> port state dicts.

The inverse of `pcm_tpu/models/convert.py:convert_unet_torch_state`,
`convert_vae_torch_state`, `convert_mmdit_torch_state`,
`pcm_tpu/models/clip.py:convert_clip_torch_state`,
`pcm_tpu/models/clip_vision.py:convert_clip_vision_torch_state` and
`pcm_tpu/models/t5.py:convert_t5_torch_state`.
Inputs are nested dicts of numpy arrays (a JAX tree after ``jax.tree.map(
np.asarray, ...)``); outputs are flat dicts of CPU tensors with diffusers /
transformers keys. Conventions:

  kernel (in, out)              -> weight (out, in)
  kernel (kh, kw, in, out)      -> weight (out, in, kh, kw)
  scale                         -> weight
  LoRA a (in, r) / (kh, kw, in, r) -> lora_a (r, in) / (r, in, kh, kw)
  LoRA b (r, out) / (1, 1, r, out) -> lora_b (out, r) / (out, r, 1, 1)
  int8 kernel (`quantize_frozen`'s QTensor: values in the kernel's layout,
  scale (1, out) / (1, 1, 1, out))
                                -> weight_values (the weight's layout, int8)
                                   + weight_scale (out, 1) / (out, 1, 1, 1)

The int8 entries load into a module that `utils.quant.quantize_frozen` has
quantized; the codes are the JAX package's, bit for bit.

Module names map by rule: ``down_blocks_0_resnets_1`` -> ``down_blocks.0.resnets.1``,
``to_out_0`` -> ``to_out.0``, ``net_0_proj`` -> ``net.0.proj``, and the mid
blocks (``mid_block_resnets_0``, the VAE's ``mid_resnets_0``) ->
``mid_block.resnets.0``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_KEEP = {"linear_1", "linear_2"}  # diffusers keeps these underscores


def torch_segment(name: str) -> str:
    """One JAX path segment -> its diffusers module-path form ("to_out_0" ->
    "to_out.0", "net_0_proj" -> "net.0.proj"; "linear_1" stays)."""
    if name in _KEEP:
        return name
    name = re.sub(r"^mid_(block_)?", "mid_block.", name)
    name = re.sub(r"_(\d+)", r".\1", name)
    return re.sub(r"(\.\d+)_", r"\1.", name)


_RENAMED = {"kernel": "weight", "a": "lora_a", "b": "lora_b", "scale": "weight"}


def _leaf_rule(name: str, ndim: int):
    """JAX leaf name and rank -> (torch leaf name, axis permutation or None)."""
    perm = None
    if name in ("kernel", "a", "b"):
        perm = (1, 0) if ndim == 2 else (3, 2, 0, 1)
    return _RENAMED.get(name, name), perm


def _is_qtensor(v) -> bool:
    """A JAX `QTensor` leaf (int8 ``values`` + ``scale``), told by its fields."""
    return hasattr(v, "scale") and hasattr(v, "values") and not callable(v.values)


def _qscale(qt) -> np.ndarray:
    """JAX scale (1, .., 1, out) -> torch (out, 1, .., 1)."""
    nd = np.ndim(qt.values)
    return np.array(qt.scale, np.float32).reshape((-1,) + (1,) * (nd - 1))


def _leaf(name: str, arr):
    """JAX leaf -> [(torch leaf name, tensor)]."""
    if _is_qtensor(arr):
        (wname, values), = _leaf(name, arr.values)
        return [(wname + "_values", values),
                (wname + "_scale", torch.from_numpy(_qscale(arr)))]
    arr = np.asarray(arr)
    name, perm = _leaf_rule(name, arr.ndim)
    if perm is not None:
        arr = arr.transpose(perm)
    return [(name, torch.from_numpy(np.ascontiguousarray(arr)))]


def _flatten(tree: Mapping[str, Any], prefix: str = "", leaf=_leaf) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + torch_segment(k) + ".", leaf))
        else:
            out.update((prefix + name, t) for name, t in leaf(k, v))
    return out


def _shape_leaf(name: str, v):
    name, perm = _leaf_rule(name, len(v.shape))
    return [(name, tuple(v.shape[i] for i in perm) if perm else tuple(v.shape))]


def state_shapes_from_jax(tree: Mapping[str, Any]) -> Dict[str, tuple]:
    """Keys and shapes of the state dict `unet_state_from_jax` /
    `vae_state_from_jax` / `lora_state_from_jax` would build, from any tree
    whose leaves have a ``.shape`` (e.g. ``jax.eval_shape`` output)."""
    return _flatten(tree, leaf=_shape_leaf)


def unet_state_from_jax(params: Mapping[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """JAX ``UNet2DCondition`` params -> port ``UNet2DCondition`` state dict."""
    del cfg  # the names carry the structure
    return _flatten(params)


def vae_state_from_jax(params: Mapping[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> diffusers-named state dict (encoder
    included; the port's decode-only module loads the ``decoder.`` and
    ``post_quant_conv.`` entries)."""
    del cfg
    return _flatten(params)


def lora_state_from_jax(lora_tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``lora`` collection of the UNet -> the port's adapter dict."""
    return _flatten(lora_tree)


def disc_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params -> the port's head parameters
    (`train/adv.py`): ``head_{i}_{j}/conv1/kernel`` (HWIO) ->
    ``head_{i}_{j}.conv1.weight`` (OIHW), GroupNorm ``scale`` -> ``weight``."""
    return {k: v for head, tree in params.items()
            for k, v in _flatten(tree, head + ".").items()}


def train_state_from_jax(state, params_from_jax=lora_state_from_jax):
    """JAX ``TrainState`` (step, params tree, optax AdamW state) -> the port's
    `TrainState`: the params and Adam's mu/nu by ``params_from_jax``
    (`lora_state_from_jax` for the student, `disc_state_from_jax` for the
    discriminator heads), Adam's count as the optimizer count. The 8-bit
    state is refused: its int8 codes are blocked in the JAX layout, so a
    transposed factor would need requantizing."""
    from ..train.state import TrainState

    adam = _find_adam(state.opt_state)
    if adam is None:
        raise ValueError("train_state_from_jax takes an optax AdamW state (clip + adamw)")
    return TrainState(step=int(np.asarray(state.step)),
                      params=params_from_jax(state.params),
                      opt_state={"count": int(np.asarray(adam.count)),
                                 "mu": params_from_jax(adam.mu),
                                 "nu": params_from_jax(adam.nu)})


def _find_adam(node):
    """The ``ScaleByAdamState`` (count, mu, nu of arrays) inside an optax chain state."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        leaves, stack = [], [node.mu]
        while stack:
            n = stack.pop()
            if isinstance(n, Mapping):
                stack.extend(n.values())
            else:
                leaves.append(n)
        return node if leaves and not isinstance(leaves[0], tuple) else None
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def clip_tree_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """JAX ``CLIPTextModel`` params regrouped under the transformers module names."""
    def layer(p):
        return {"self_attn": {k: p[k] for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "mlp": {k: p[k] for k in ("fc1", "fc2")},
                "layer_norm1": p["layer_norm1"], "layer_norm2": p["layer_norm2"]}

    tree = {"text_model": {
        "embeddings": {"token_embedding": {"weight": params["token_embedding"]},
                       "position_embedding": {"weight": params["position_embedding"]}},
        "encoder": {"layers": {str(i): layer(params[f"layers_{i}"])
                               for i in range(cfg.num_layers)}},
        "final_layer_norm": params["final_layer_norm"],
    }}
    if "text_projection" in params:
        tree["text_projection"] = params["text_projection"]
    return tree


def clip_state_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextModel`` params -> transformers-named state dict."""
    return _flatten(clip_tree_from_jax(params, cfg))


def mmdit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MMDiT`` params -> the port's ``MMDiT`` state dict. The port keeps
    the JAX tree's names (``transformer_blocks_0/to_out_0`` ->
    ``transformer_blocks.0.to_out.0``) and its (1, max, max, dim) position
    table, so the rules above carry every leaf; its LoRA collection goes
    through `lora_state_from_jax`."""
    return _flatten(params)


def t5_state_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX ``T5Encoder`` params -> the transformers-named state dict of the
    port's ``T5Encoder`` (the inverse of `convert_t5_torch_state`); int8
    kernels as the module docstring says."""
    def t(a, transpose: bool = False) -> torch.Tensor:
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))

    out = {"shared.weight": t(params["token_embedding"]),
           "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
               t(params["relative_attention_bias"]),
           "encoder.final_layer_norm.weight": t(params["final_layer_norm"]["weight"])}
    for i in range(cfg.num_layers):
        p, bp = params[f"block_{i}"], f"encoder.block.{i}.layer."
        out[bp + "0.layer_norm.weight"] = t(p["attn_layer_norm"]["weight"])
        out[bp + "1.layer_norm.weight"] = t(p["ff_layer_norm"]["weight"])
        for k in ("q", "k", "v", "o"):
            out.update((f"{bp}0.SelfAttention.{k}.{name}", v) for name, v in _leaf(
                "kernel", p[k]["kernel"]))
        for k in ("wi_0", "wi_1", "wo"):
            out.update((f"{bp}1.DenseReluDense.{k}.{name}", v) for name, v in _leaf(
                "kernel", p[k]["kernel"]))
    return out


def clip_vision_state_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPVisionModel`` params -> the transformers-named state dict of
    the port's `CLIPVisionModel` (the inverse of
    `convert_clip_vision_torch_state`): the patch kernel (kh, kw, in, out) ->
    (out, in, kh, kw), the embeddings under ``vision_model.embeddings``, the
    layers regrouped as the text tower's."""
    def layer(p):
        return {"self_attn": {k: p[k] for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "mlp": {k: p[k] for k in ("fc1", "fc2")},
                "layer_norm1": p["layer_norm1"], "layer_norm2": p["layer_norm2"]}

    tree = {"vision_model": {
        "embeddings": {"patch_embedding": params["patch_embedding"],
                       "position_embedding": {"weight": params["position_embedding"]}},
        "pre_layrnorm": params["pre_layrnorm"],
        "encoder": {"layers": {str(i): layer(params[f"layers_{i}"])
                               for i in range(cfg.num_layers)}},
        "post_layernorm": params["post_layernorm"],
    }}
    if "visual_projection" in params:
        tree["visual_projection"] = params["visual_projection"]
    out = _flatten(tree)
    out["vision_model.embeddings.class_embedding"] = torch.from_numpy(
        np.array(params["class_embedding"]))
    return out
