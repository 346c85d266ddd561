"""NSFW safety checker (counterpart of `pcm_tpu/utils/safety.py`, the
reference's CLIP-based checker): CLIP image features against concept
embeddings with per-concept thresholds, in numpy float32.

It needs the concept embeddings (an npz of ``concept_embeds``,
``concept_embeds_weights``, ``special_care_embeds`` and
``special_care_embeds_weights``) and the image's CLIP features
(`utils/fid.py:CLIPFeatures`); without either it passes every image and says
it is inactive, as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SafetyChecker:
    def __init__(self, concept_embeds_path: Optional[str] = None, threshold_adjust: float = 0.0):
        self.active = False
        self.threshold_adjust = threshold_adjust
        if concept_embeds_path is not None:
            with np.load(concept_embeds_path) as data:
                self.concept_embeds = np.asarray(data["concept_embeds"], np.float32)
                self.concept_thresholds = np.asarray(data["concept_embeds_weights"], np.float32)
                self.special_embeds = np.asarray(data["special_care_embeds"], np.float32)
                self.special_thresholds = np.asarray(data["special_care_embeds_weights"],
                                                     np.float32)
            self.active = True

    def is_unsafe(self, image: np.ndarray, image_features: Optional[np.ndarray] = None) -> bool:
        """image: (H, W, 3) uint8. True when flagged; ``image_features`` the
        image's CLIP embedding (without it the checker is inactive: False)."""
        if not self.active or image_features is None:
            return False
        feats = np.asarray(image_features, np.float32)
        feats = feats / np.linalg.norm(feats)
        special = feats @ self.special_embeds.T - self.special_thresholds
        adjustment = np.float32(self.threshold_adjust) + np.float32(
            0.01 if np.any(special > 0) else 0.0)
        scores = feats @ self.concept_embeds.T - self.concept_thresholds + adjustment
        return bool(np.any(scores > 0))
