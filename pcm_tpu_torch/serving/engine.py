"""Fixed-shape batched inference engine (counterpart of `pcm_tpu/serving/engine.py`).

Every device batch has ``batch_size`` rows: a partial batch is padded by
repeating its last request, so each batch runs the same shapes. Each request
carries its own seed, and its starting noise comes from a generator seeded
with it on the device, so a request's image does not depend on which batch
it rode in. Adapters (LoRA factor dicts) are arguments of every forward, so
a swap replaces a dict and rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..sampling.pipeline import TextToImagePipeline

Adapter = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int = 4
    latent_hw: int = 64  # image side // vae scale
    guidance_scale: float = 1.0


def make_prompt_encoder(bundle, toks: Mapping[str, Callable], frozen, device) -> Callable:
    """``encode(prompts) -> cond`` over the bundle's text tower (SD1.5)."""
    if type(bundle).__name__ != "SD15Bundle":
        raise NotImplementedError(f"{type(bundle).__name__} serving is not yet ported")

    def encode(prompts: Sequence[str]):
        ids = torch.from_numpy(toks["input_ids"](list(prompts))).long().to(device)
        with torch.inference_mode():
            return bundle.encode_prompts(frozen, ids)

    return encode


class InferenceEngine:
    """Thread-safe batched generate over one model bundle.

    ``generate_batch`` takes up to ``batch_size`` (prompt, seed) pairs and
    returns exactly ``len(prompts)`` uint8 (H, W, 3) images.
    """

    def __init__(self, bundle, sampler, frozen, lora: Optional[Adapter],
                 toks: Mapping[str, Callable], cfg: EngineConfig, device: torch.device):
        self.bundle = bundle
        self.cfg = cfg
        self.device = torch.device(device)
        self.frozen = frozen
        self.lora = lora
        self.lora_source: Optional[str] = None
        self.adapters: Dict[str, Adapter] = {}
        self.pipe = TextToImagePipeline(bundle, sampler)
        self._encode = make_prompt_encoder(bundle, toks, frozen, self.device)
        self._lock = threading.Lock()  # one device executor
        self.stats = {"requests": 0, "batches": 0, "pad_rows": 0, "lora_swaps": 0}
        self._uncond = (self._encode([""] * cfg.batch_size)
                        if cfg.guidance_scale > 1.0 else None)
        self._latent_shape = (cfg.latent_hw, cfg.latent_hw, bundle.latent_channels)

    def _load_tree(self, source: Union[str, os.PathLike, Mapping[str, torch.Tensor]]) -> Adapter:
        """An adapter dict shaped exactly like the engine's own, on its device."""
        if isinstance(source, (str, os.PathLike)):
            raise NotImplementedError("loading a kohya LoRA file is not yet ported")
        if self.lora is None:
            raise ValueError("engine was built without a LoRA tree; construct it with the "
                             "bundle's zero-init lora template to enable hot-swap")
        if set(source) != set(self.lora):
            missing = sorted(set(self.lora) - set(source))[:3]
            extra = sorted(set(source) - set(self.lora))[:3]
            raise ValueError(f"lora tree structure mismatch: missing {missing}, extra {extra}")
        bad = [(k, tuple(v.shape), v.dtype) for k, v in source.items()
               if v.shape != self.lora[k].shape or v.dtype != self.lora[k].dtype]
        if bad:
            raise ValueError(f"lora leaf shape/dtype mismatch: {bad[:3]}")
        return {k: v.to(self.device) for k, v in source.items()}

    def load_lora(self, source) -> None:
        """Swap the default adapter (between batches, never mid-batch)."""
        new = self._load_tree(source)
        with self._lock:
            self.lora = new
            self.lora_source = source if isinstance(source, str) else "<tree>"
            self.stats["lora_swaps"] += 1

    def register_adapter(self, name: str, source) -> None:
        """Register a named adapter for per-request selection."""
        new = self._load_tree(source)
        with self._lock:
            self.adapters[name] = new

    def unregister_adapter(self, name: str) -> None:
        with self._lock:
            if name not in self.adapters:
                raise KeyError(f"unknown adapter {name!r}; registered: {self.adapter_names}")
            del self.adapters[name]

    @property
    def adapter_names(self) -> List[str]:
        return sorted(self.adapters)

    def _init_noise(self, seeds: Sequence[int]) -> torch.Tensor:
        rows = []
        for s in seeds:
            g = torch.Generator(self.device).manual_seed(int(s))
            rows.append(torch.randn(self._latent_shape, generator=g, device=self.device))
        return torch.stack(rows)

    def generate_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       adapter: Optional[str] = None) -> np.ndarray:
        """``adapter``: a name from ``register_adapter`` for the whole batch;
        None = the engine's default ``lora``."""
        n, b = len(prompts), self.cfg.batch_size
        if n == 0 or n != len(seeds) or n > b:
            raise ValueError(f"need 1..{b} prompts with one seed each, got {n}/{len(seeds)}")
        pad = b - n
        prompts = list(prompts) + [prompts[-1]] * pad
        seeds = list(seeds) + [seeds[-1]] * pad
        with self._lock:
            if adapter is not None and adapter not in self.adapters:
                raise KeyError(f"unknown adapter {adapter!r}; registered: {self.adapter_names}")
            lora = self.adapters[adapter] if adapter is not None else self.lora
            imgs = self.pipe.generate(self.frozen, lora, self._encode(prompts), self._uncond,
                                      self._init_noise(seeds), self.cfg.guidance_scale)[:n].float()
            if not torch.isfinite(imgs).all():
                raise FloatingPointError("non-finite pixels in the generated batch")
            out = ((imgs + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["pad_rows"] += pad
        return out

    def warmup(self) -> None:
        self.generate_batch(["warmup"], [0])
