"""Few-step text-to-image pipeline (counterpart of `pcm_tpu/sampling/pipeline.py`).

Text encode, k backbone forwards (UNet or MMDiT) with optional
classifier-free guidance (cond and uncond batched into one forward, every
leaf of the cond tree: SDXL's ``added_cond`` and SD3's ``pooled`` too),
sampler steps (trailing DDIM, or PCM-FM for SD3, whose stochastic variant
takes its fresh noise from the caller), VAE decode. Runs under
``torch.inference_mode()``. On a CUDA device every GroupNorm, attention and
(teacher UNet) GEGLU goes through the port's kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..lora.layers import LoRA
from ..train.distill import _merge_cond


@dataclasses.dataclass(frozen=True)
class TextToImagePipeline:
    bundle: Any  # SD15Bundle | SDXLBundle | SD3Bundle
    sampler: Any  # DDIMSampler | PCMFMSampler

    @torch.inference_mode()
    def generate(self, frozen: Dict[str, Any], lora: LoRA, cond: Dict[str, Any],
                 uncond: Optional[Dict[str, Any]], init_latents: torch.Tensor,
                 guidance_scale: float = 1.0, decode_chunk: Optional[int] = None,
                 renoise: Optional[Sequence[torch.Generator]] = None) -> torch.Tensor:
        """cond/uncond from ``bundle.encode_prompts``, starting noise
        ``init_latents`` (N, h, w, C); returns (N, H, W, 3) images in [-1, 1],
        decoded ``decode_chunk`` samples at a time (None: the batch). The
        caller draws the noise (the engine: one generator per request seed),
        and a stochastic sampler's fresh noise of each step from ``renoise``:
        one generator per row, so a row's draws do not depend on the batch."""
        bundle, sampler = self.bundle, self.sampler
        device = cond["prompt_embeds"].device
        latents = init_latents.float()
        use_cfg = guidance_scale > 1.0 and uncond is not None
        merged = _merge_cond(cond, uncond) if use_cfg else cond

        def model_fn(x, t):
            ts = torch.full((x.shape[0],), float(t), device=device)
            # cuDNN's convolutions at some UNet shapes (e.g. 1280 -> 1280 at
            # 32x32 on the H100) round a row differently by its position in
            # the batch; PyTorch's own per-sample convolution does not. So a
            # request's image stays the same in any batch, at the UNet's
            # cuDNN speed-up. The VAE decoder measured position-invariant at
            # 512 px and not at 1024 px, where the serving CLI decodes one
            # sample a call (``decode_chunk`` 1).
            with torch.backends.cudnn.flags(enabled=False):
                if lora is None:
                    return bundle.teacher(frozen, x, ts, merged)
                return bundle.student(frozen, lora, x, ts, merged)

        for i, t in enumerate(sampler.timesteps):
            if use_cfg:
                c_out, u_out = model_fn(torch.cat([latents, latents]), t).chunk(2)
                model_output = u_out + guidance_scale * (c_out - u_out)
            else:
                model_output = model_fn(latents, t)
            latents = sampler.step(model_output, i, latents, renoise)
        return bundle.decode_latents(frozen, latents, decode_chunk)
