"""Kohya LoRA interop (counterpart of `pcm_tpu/lora/kohya.py`).

An adapter dict of the port (`lora/layers.py`) is already in kohya's
orientation: ``A (r, in)`` / ``(r, in, kh, kw)`` is ``lora_down`` and
``B (out, r)`` / ``(out, r, 1, 1)`` is ``lora_up``. Only the names map:
``<module path>.lora_a`` -> ``<prefix>_<module path with "." -> "_">.lora_down.weight``
(``lora_unet_down_blocks_0_attentions_0_proj_in``), which is the JAX
package's ``prefix + "_" + "_".join(layer)``, plus one ``.alpha`` a layer.
Files are written with the port's own safetensors (`utils/safetensors.py`),
fp16 by default as the reference releases them. Also the release
conventions: weights halved + fp16, and the sqrt(alpha) load rescale.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..utils import safetensors

_A, _B = ".lora_a", ".lora_b"


def _layers(adapter: Mapping[str, object]):
    """The module paths of an adapter dict, sorted."""
    return sorted(k[: -len(_A)] for k in adapter if k.endswith(_A))


def kohya_key(module_path: str, prefix: str = "lora_unet") -> str:
    return prefix + "_" + module_path.replace(".", "_")


def _np(v) -> np.ndarray:
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def to_kohya_state_dict(adapter: Mapping[str, object], alpha: float,
                        prefix: str = "lora_unet") -> Dict[str, np.ndarray]:
    """The port's adapter dict -> a kohya numpy state dict (float32 factors)."""
    out = {}
    for path in _layers(adapter):
        down, up = _np(adapter[path + _A]), _np(adapter[path + _B])
        key = kohya_key(path, prefix)
        out[f"{key}.lora_down.weight"] = down
        out[f"{key}.lora_up.weight"] = up
        out[f"{key}.alpha"] = np.asarray(alpha, down.dtype)
    return out


def from_kohya_state_dict(state: Mapping[str, np.ndarray], template: Mapping[str, torch.Tensor],
                          rank: int, prefix: str = "lora_unet"
                          ) -> Tuple[Dict[str, torch.Tensor], float]:
    """A kohya state dict -> an adapter dict keyed like ``template`` (float32
    CPU tensors), and the file's alpha (``rank`` when it has none). Raises
    KeyError for a layer of the template that the file lacks."""
    out, alpha = {}, float(rank)
    for path in _layers(template):
        key = kohya_key(path, prefix)
        out[path + _A] = torch.from_numpy(np.asarray(state[f"{key}.lora_down.weight"], np.float32))
        out[path + _B] = torch.from_numpy(np.asarray(state[f"{key}.lora_up.weight"], np.float32))
        if f"{key}.alpha" in state:
            alpha = float(np.asarray(state[f"{key}.alpha"], np.float32))
    return out, alpha


def save_kohya_safetensors(path: str, adapter: Mapping[str, object], alpha: float,
                           dtype=np.float16, prefix: str = "lora_unet") -> None:
    sd = to_kohya_state_dict(adapter, alpha, prefix)
    safetensors.save_file({k: v.astype(dtype) for k, v in sd.items()}, path)


def load_kohya_safetensors(path: str, template: Mapping[str, torch.Tensor], rank: int,
                           prefix: str = "lora_unet") -> Tuple[Dict[str, torch.Tensor], float]:
    return from_kohya_state_dict(safetensors.load_file(path, bf16_as_f32=True), template, rank,
                                 prefix)


def halve_fp16(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Release post-processing: weight / 2, then fp16."""
    return {k: (np.asarray(v) / 2).astype(np.float16) for k, v in state.items()}


def rescale_sqrt_alpha(state: Mapping[str, np.ndarray], alpha: float = 1.0
                       ) -> Dict[str, np.ndarray]:
    """Load-time rescale by sqrt(alpha)."""
    return {k: np.asarray(v) * np.sqrt(alpha) for k, v in state.items()}
