"""CLIP vision tower (counterpart of `pcm_tpu/models/clip_vision.py`),
parameter names of transformers' ``CLIPVisionModelWithProjection``.

It backs CLIP-FID (`utils/fid.py:CLIPFeatures`), CLIP score
(`utils/clip_score.py`) and the demo's safety checker (`utils/safety.py`).
The patch convolution, class and position embeddings, ``pre_layrnorm``, the
encoder layers of the text tower (`models/clip.py:CLIPEncoderLayer`) under an
all-true mask, then ``post_layernorm`` on the class token and
``visual_projection``. Attention is the plain matmul path, as in the JAX
package: this module runs no kernel of `ops/`.

`preprocess_images` resizes as ``jax.image.resize(..., "bilinear")`` does,
antialiased when it shrinks (its default): a triangle kernel widened by the
scale, weights normalized over the taps inside the image (`bilinear_weights`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .clip import CLIPEncoderLayer, CLIPTextConfig


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = 768

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


# ViT-L/14: the tower behind the SD safety checker and CLIP-FID
CLIP_VIT_L14_CONFIG = CLIPVisionConfig()
TINY_CLIP_VISION_CONFIG = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, projection_dim=48)

# CLIPProcessor normalization constants (OpenAI CLIP convention)
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, d)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        layer_cfg = CLIPTextConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                                   intermediate_size=cfg.intermediate_size,
                                   hidden_act=cfg.hidden_act)
        self.layers = nn.ModuleList(CLIPEncoderLayer(layer_cfg) for _ in range(cfg.num_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values)`` -> (last_hidden, pooled) as the JAX model:
    ``pixel_values`` (N, 3, H, W) already CLIP-normalized; ``pooled`` the
    post-LN class token, projected when ``projection_dim`` is set (the
    "image features" every consumer wants)."""

    # keys of a transformers file that hold no parameter
    IGNORED_KEYS = ("vision_model.embeddings.position_ids",)

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_L14_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        if cfg.projection_dim is not None:
            self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        vm = self.vision_model
        emb = vm.embeddings
        n = pixel_values.shape[0]
        patches = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # (N, patches, d), row-major patches
        cls = emb.class_embedding.to(patches.dtype).expand(n, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding.weight[:x.shape[1]].to(x.dtype)
        x = vm.pre_layrnorm(x)
        mask = torch.ones((x.shape[1], x.shape[1]), dtype=torch.bool, device=x.device)
        for layer in vm.encoder.layers:
            x = layer(x, mask)
        pooled = vm.post_layernorm(x[:, 0])
        if self.cfg.projection_dim is not None:
            pooled = self.visual_projection(pooled)
        return x, pooled

    def load_hf_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load a transformers ``CLIPVisionModel(WithProjection)`` state dict
        (a file without ``visual_projection`` leaves the projection as it is)."""
        own = self.state_dict()
        state = {k: v for k, v in state.items() if k not in self.IGNORED_KEYS}
        missing = [k for k in own if k not in state and k != "visual_projection.weight"]
        extra = [k for k in state if k not in own]
        if missing or extra:
            raise ValueError(f"not a CLIP vision state of this config: missing {missing[:5]}, "
                             f"unexpected {extra[:5]}")
        self.load_state_dict(state, strict=False)


@functools.lru_cache(maxsize=16)
def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights of ``jax.image.resize``'s "bilinear" method
    with ``antialias=True`` (`jax/_src/image/scale.py:compute_weight_mat`):
    sample centres at (i + 0.5) x in / out - 0.5, a triangle kernel widened
    by in / out when shrinking, normalized; read only."""
    inv_scale = np.float32(in_size) / np.float32(out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).T.astype(np.float32)
    w.setflags(write=False)
    return w


def preprocess_images(images, size: int = 224) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] (numpy or a tensor, on its device) ->
    CLIP-normalized (N, 3, size, size) float32: [0, 1], clipped, resized as
    the JAX package resizes (`bilinear_weights`; generator outputs are square
    already, so the full frame is the shortest-side resize and center crop),
    then normalized by the CLIP mean and std."""
    x = torch.as_tensor(images).float()
    x = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    n, h, w, _ = x.shape
    if (h, w) != (size, size):
        wh = torch.tensor(bilinear_weights(h, size), device=x.device)
        ww = torch.tensor(bilinear_weights(w, size), device=x.device)
        x = torch.einsum("nhwc,ph,qw->npqc", x, wh, ww)
    mean = torch.from_numpy(CLIP_IMAGE_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_IMAGE_STD).to(x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)
