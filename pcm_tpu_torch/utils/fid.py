"""FID / feature-statistics evaluation (counterpart of `pcm_tpu/utils/fid.py`).

The Frechet distance math is numpy/scipy, a copy of the JAX package's; the
feature extractor is pluggable. `CLIPFeatures` runs the CLIP ViT-L/14 vision
tower (`models/clip_vision.py`, the "CLIP-FID" convention) over weights in
transformers' naming, and any (N, D) activation matrix works.

The tower runs in fp32 with TF32 off (`fp32_exact`): cuDNN's convolutions
default to TF32 on the card, which would round the patch embedding to a
10-bit mantissa; without it the card's features match the CPU's to fp32
round-off.
"""

from __future__ import annotations

import contextlib
import glob
import sys
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def fp32_exact():
    """fp32 matmuls and cuDNN convolutions without TF32 for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def read_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.safetensors`` file (the port's reader) or a torch
    ``.bin`` (``torch.load(weights_only=True)``), on the CPU."""
    if path.endswith(".safetensors"):
        from .safetensors import load_torch

        return load_torch([glob.escape(path)])
    return torch.load(path, map_location="cpu", weights_only=True)


def seeded(module: torch.nn.Module, seed: int, device: torch.device) -> torch.nn.Module:
    """``module``'s weights drawn from ``seed`` (`train/bundles.py:fill_fan_in`)."""
    from ..train.bundles import fill_fan_in

    fill_fan_in(module, torch.Generator(device).manual_seed(seed))
    return module


class CLIPFeatures:
    """CLIP-image-feature extractor for Frechet distance ("CLIP-FID").

    ``weights``: a state dict of transformers' ``CLIPVisionModel(WithProjection)``
    (`from_torch_file` reads one). Without it the weights are drawn from
    ``seed``: a smoke-only metric, and a warning says so. ``device``: where
    the tower runs (the card unless the caller asks for the CPU).
    """

    def __init__(self, weights: Optional[Dict[str, torch.Tensor]] = None, cfg=None,
                 batch: int = 32, device="cuda", seed: int = 0):
        from ..models.clip_vision import CLIP_VIT_L14_CONFIG, CLIPVisionModel

        self.cfg = cfg or CLIP_VIT_L14_CONFIG
        self.device = torch.device(device)
        with self.device:
            self.model = CLIPVisionModel(self.cfg).eval().requires_grad_(False)
        if weights is None:
            print("# WARNING: CLIPFeatures with random weights — smoke metric only",
                  file=sys.stderr)
            seeded(self.model, seed, self.device)
        else:
            self.model.load_hf_state(weights)
        self.batch = batch

    @classmethod
    def from_torch_file(cls, path: str, cfg=None, **kw) -> "CLIPFeatures":
        """Load a transformers CLIPVisionModel(WithProjection) checkpoint
        (.safetensors or torch .bin)."""
        return cls(weights=read_torch_file(path), cfg=cfg, **kw)

    def __call__(self, images) -> np.ndarray:
        """(N, H, W, 3) images in [-1, 1] (numpy or a tensor) -> (N,
        projection_dim) float32 features."""
        from ..models.clip_vision import preprocess_images

        out = []
        with torch.inference_mode(), fp32_exact():
            for i in range(0, len(images), self.batch):
                x = torch.as_tensor(images[i:i + self.batch]).to(self.device)
                out.append(self.model(preprocess_images(x, self.cfg.image_size))[1].cpu())
        return torch.cat(out).numpy()


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mean, covariance)."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)). (``sqrtm`` without
    the JAX package's ``disp=False``: SciPy 1.18, the card's, removed it; its
    default returns the same root.)"""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*activation_statistics(feats_a), *activation_statistics(feats_b))


def fid_from_generator(gen_batches: Iterable[np.ndarray], ref_batches: Iterable[np.ndarray],
                       extract: Callable[[np.ndarray], np.ndarray]) -> float:
    """Stream two image sources ((N,H,W,3) in [-1,1]) through an extractor."""
    fa = np.concatenate([np.asarray(extract(b)) for b in gen_batches])
    fb = np.concatenate([np.asarray(extract(b)) for b in ref_batches])
    return fid_from_features(fa, fb)
