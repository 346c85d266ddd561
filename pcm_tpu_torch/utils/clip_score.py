"""CLIP-score evaluation, prompt-image alignment (counterpart of
`pcm_tpu/utils/clip_score.py`):

    score_i = 100 * max(0, cos(E_img(x_i), E_txt(p_i)))

averaged over the eval set, the ``torchmetrics.CLIPScore`` convention. The
image tower is `utils/fid.py:CLIPFeatures`, the text tower the port's
`models/clip.py:CLIPTextModel` with ``projection_dim`` set; both in fp32
without TF32 (`utils/fid.py:fp32_exact`).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.clip import CLIPTextConfig

# CLIP ViT-L/14 text tower (openai/clip-vit-large-patch14): pairs with
# models/clip_vision.py:CLIP_VIT_L14_CONFIG for CLIP score and CLIP-FID
CLIP_VIT_L14_TEXT_CONFIG = CLIPTextConfig(vocab_size=49408, hidden_size=768, num_layers=12,
                                          num_heads=12, intermediate_size=3072,
                                          projection_dim=768)


class CLIPTextFeatures:
    """Projected text embeddings from the CLIP text tower.

    ``weights``: a state dict of transformers' ``CLIPTextModelWithProjection``
    (`from_torch_file` reads one). Without it the weights are drawn from
    ``seed``: smoke only, and a warning says so.
    """

    # keys of a transformers file that hold no parameter
    IGNORED_KEYS = ("text_model.embeddings.position_ids",)

    def __init__(self, tokenizer, weights: Optional[Dict[str, torch.Tensor]] = None,
                 cfg: Optional[CLIPTextConfig] = None, batch: int = 32, device="cuda",
                 seed: int = 0):
        from ..models.clip import CLIPTextModel
        from .fid import seeded

        self.cfg = cfg or CLIP_VIT_L14_TEXT_CONFIG
        if self.cfg.projection_dim is None:
            raise ValueError("CLIP score needs the projected text tower (projection_dim)")
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        with self.device:
            self.model = CLIPTextModel(self.cfg).eval().requires_grad_(False)
        if weights is None:
            print("# WARNING: CLIPTextFeatures with random weights — smoke metric only",
                  file=sys.stderr)
            seeded(self.model, seed, self.device)
        else:
            self.model.load_state_dict({k: v for k, v in weights.items()
                                        if k not in self.IGNORED_KEYS}, strict=True)
        self.batch = batch

    @classmethod
    def from_torch_file(cls, path: str, tokenizer, cfg=None, **kw) -> "CLIPTextFeatures":
        """Load a transformers CLIPTextModelWithProjection checkpoint
        (.safetensors or torch .bin)."""
        from .fid import read_torch_file

        return cls(tokenizer, weights=read_torch_file(path), cfg=cfg, **kw)

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        from .fid import fp32_exact

        out = []
        with torch.inference_mode(), fp32_exact():
            for i in range(0, len(prompts), self.batch):
                ids = torch.as_tensor(self.tokenizer(list(prompts[i:i + self.batch])),
                                      dtype=torch.long, device=self.device)
                out.append(self.model(ids)[2].cpu())
        return torch.cat(out).numpy()


def clip_score_from_features(img_feats: np.ndarray, txt_feats: np.ndarray) -> float:
    """Mean ``100 * max(0, cos)`` over aligned (N, D) feature rows."""
    a = np.asarray(img_feats, np.float64)
    b = np.asarray(txt_feats, np.float64)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"{a.shape[0]} image features for {b.shape[0]} text features")
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    cos = np.sum(a * b, axis=-1)
    return float(np.mean(100.0 * np.maximum(cos, 0.0)))


def clip_score(images, prompts: Sequence[str], image_extractor, text_extractor) -> float:
    """End to end: (N, H, W, 3) images in [-1, 1] + N prompts -> mean CLIP
    score; ``image_extractor`` a `utils/fid.py:CLIPFeatures`, ``text_extractor``
    a `CLIPTextFeatures`, over the same ViT-L/14 checkpoint pair."""
    return clip_score_from_features(image_extractor(images), text_extractor(prompts))
