"""Fixed-shape batched inference engine (counterpart of `pcm_tpu/serving/engine.py`).

Every device batch has ``batch_size`` rows: a partial batch is padded by
repeating its last request, so each batch runs the same shapes. Each request
carries its own seed, and its starting noise (and, with the stochastic
PCM-FM sampler, each step's fresh noise) comes from a generator seeded with
it on the device, so a request's image does not depend on which batch it
rode in. Adapters (LoRA factor dicts) are arguments of every forward, so
a swap replaces a dict and rebuilds nothing. An adapter comes as a dict or
as a kohya ``.safetensors`` file (`lora/kohya.py`), read into the template's
keys, shapes and dtypes.

Data parallel (`pcm_tpu/serving/engine.py:82-112`): given several devices,
the engine keeps a replica of the frozen weights and of every adapter on
each (a swap or a registration reaches every replica) and splits each padded
batch into equal contiguous chunks, one a device. The caller's thread
dispatches them all, card after card, and the cards run them asynchronously:
first every chunk's sampling passes, then every chunk's VAE decode, then the
copies to the host, the only waits. (A host thread a card ran a SDXL batch
of 16 on four cards in 2141.6 ms against 346.9 ms for 4 on one, NVIDIA H100
80GB HBM3, 700.00 W: PyTorch releases the GIL around every op, so the threads
handed it over at every launch.) A request's noise comes from its own seeded
generator on its chunk's device, so its image is the one a one-device engine
gives it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import os
import threading
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..sampling.pipeline import TextToImagePipeline

Adapter = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int = 4
    latent_hw: int = 64  # image side // vae scale
    resolution: int = 512  # image side (SDXL's time_ids)
    guidance_scale: float = 1.0
    decode_chunk: Optional[int] = None  # samples a VAE decode call (None: the batch)


def make_prompt_encoder(bundle, toks: Mapping[str, Callable], frozen, device,
                        resolution: int = 512) -> Callable:
    """``encode(prompts) -> cond`` over the bundle's text towers
    (`pcm_tpu/serving/engine.py:make_prompt_encoder`): SD1.5's CLIP-L,
    SDXL's two towers with ``time_ids`` [res, res, 0, 0, res, res], or SD3's
    CLIP-L, CLIP-bigG and T5."""
    family = type(bundle).__name__
    if family not in ("SD15Bundle", "SDXLBundle", "SD3Bundle"):
        raise NotImplementedError(f"{family} serving is not yet ported")

    def ids(key: str, prompts: Sequence[str]) -> torch.Tensor:
        return torch.from_numpy(toks[key](list(prompts))).long().to(device)

    def encode(prompts: Sequence[str]):
        with torch.inference_mode():
            if family == "SD15Bundle":
                return bundle.encode_prompts(frozen, ids("input_ids", prompts))
            if family == "SD3Bundle":
                return bundle.encode_prompts(frozen, *(ids(k, prompts) for k in
                                                       ("input_ids", "input_ids_2", "input_ids_3")))
            time_ids = torch.tensor([[resolution, resolution, 0, 0, resolution, resolution]],
                                    dtype=torch.float32, device=device).repeat(len(prompts), 1)
            return bundle.encode_prompts(frozen, ids("input_ids", prompts),
                                         ids("input_ids_2", prompts), time_ids)

    return encode


def _modules_to(frozen: Mapping[str, torch.nn.Module], device: torch.device) -> Dict[str, Any]:
    """A copy of each module with its parameters and buffers moved to
    ``device`` (no copy of them on the source device first)."""
    out = {}
    for name, m in frozen.items():
        memo = {}
        for t in itertools.chain(m.parameters(), m.buffers()):
            moved = t.detach().to(device)
            memo[id(t)] = (torch.nn.Parameter(moved, t.requires_grad)
                           if isinstance(t, torch.nn.Parameter) else moved)
        out[name] = copy.deepcopy(m, memo)
    return out


@dataclasses.dataclass
class _Replica:
    """What one device runs its chunk of a batch on."""
    device: torch.device
    frozen: Dict[str, Any]
    encode: Callable
    uncond: Optional[Dict[str, Any]]
    lora: Optional[Adapter]
    adapters: Dict[str, Adapter]


class InferenceEngine:
    """Thread-safe batched generate over one model bundle.

    ``generate_batch`` takes up to ``batch_size`` (prompt, seed) pairs and
    returns exactly ``len(prompts)`` uint8 (H, W, 3) images. ``device`` is
    one device or a list of them (data parallel: ``batch_size`` must divide
    by their count); ``frozen`` and ``lora`` lie on the first.
    """

    def __init__(self, bundle, sampler, frozen, lora: Optional[Adapter],
                 toks: Mapping[str, Callable], cfg: EngineConfig,
                 device: Union[torch.device, str, Sequence[Union[torch.device, str]]]):
        devices = ([torch.device(device)] if isinstance(device, (str, torch.device))
                   else [torch.device(d) for d in device])
        if not devices or cfg.batch_size % len(devices):
            raise ValueError(f"batch size {cfg.batch_size} does not split over "
                             f"{len(devices)} devices")
        self.bundle = bundle
        self.cfg = cfg
        self.devices = devices
        self.device = devices[0]
        self.frozen = frozen
        self.lora = lora
        self.lora_source: Optional[str] = None
        self.adapters: Dict[str, Adapter] = {}
        self.pipe = TextToImagePipeline(bundle, sampler)
        self._lock = threading.Lock()  # one executor of the devices
        self.stats = {"requests": 0, "batches": 0, "pad_rows": 0, "lora_swaps": 0}
        self._latent_shape = (cfg.latent_hw, cfg.latent_hw, bundle.latent_channels)
        chunk = cfg.batch_size // len(devices)
        self._replicas: List[_Replica] = []
        for i, dev in enumerate(devices):
            fz = frozen if i == 0 else _modules_to(frozen, dev)
            encode = make_prompt_encoder(bundle, toks, fz, dev, cfg.resolution)
            uncond = encode([""] * chunk) if cfg.guidance_scale > 1.0 else None
            self._replicas.append(_Replica(dev, fz, encode, uncond, _moved(lora, dev), {}))
        # the first device's prompt encoder and uncond (its chunk's rows)
        self._encode, self._uncond = self._replicas[0].encode, self._replicas[0].uncond

    def _load_tree(self, source: Union[str, os.PathLike, Mapping[str, torch.Tensor]]) -> Adapter:
        """An adapter dict shaped exactly like the engine's own, on its device.
        A kohya file is read under the family's prefix (``lora_unet``; SD3's
        ``lora_transformer``), its factors cast to the template's dtypes; a file whose
        alpha differs from the bundle's `LoRASpec` is loaded with a warning
        (the spec's scale applies)."""
        if self.lora is None:
            raise ValueError("engine was built without a LoRA tree; construct it with the "
                             "bundle's zero-init lora template to enable hot-swap")
        if isinstance(source, (str, os.PathLike)):
            from ..lora.kohya import load_kohya_safetensors

            spec = self.bundle.lora
            try:
                tree, file_alpha = load_kohya_safetensors(str(source), self.lora, spec.rank,
                                                          self.bundle.KOHYA_PREFIX)
            except KeyError as e:
                raise ValueError(f"{source}: kohya file lacks {e} of the engine's adapter") from e
            alpha = spec.alpha if spec.alpha is not None else spec.rank
            if abs(file_alpha - alpha) > 1e-6:
                warnings.warn(f"kohya file alpha={file_alpha} != the engine's LoRASpec alpha="
                              f"{alpha}: the adapter runs at {alpha / max(file_alpha, 1e-9):.3g}x "
                              "its intended strength", stacklevel=3)
            source = {k: v.to(self.lora[k].dtype) for k, v in tree.items()}
        if set(source) != set(self.lora):
            missing = sorted(set(self.lora) - set(source))[:3]
            extra = sorted(set(source) - set(self.lora))[:3]
            raise ValueError(f"lora tree structure mismatch: missing {missing}, extra {extra}")
        bad = [(k, tuple(v.shape), v.dtype) for k, v in source.items()
               if v.shape != self.lora[k].shape or v.dtype != self.lora[k].dtype]
        if bad:
            raise ValueError(f"lora leaf shape/dtype mismatch: {bad[:3]}")
        return {k: v.to(self.device) for k, v in source.items()}

    def load_lora(self, source, swap: bool = True) -> None:
        """Swap the default adapter (between batches, never mid-batch):
        ``source`` is an adapter dict or a kohya ``.safetensors`` path.
        ``swap=False`` sets the starting adapter, not counted in ``lora_swaps``."""
        new = self._load_tree(source)
        copies = [_moved(new, r.device) for r in self._replicas]
        with self._lock:
            self.lora = new
            for r, c in zip(self._replicas, copies):
                r.lora = c
            self.lora_source = (os.fspath(source) if isinstance(source, (str, os.PathLike))
                                else "<tree>")
            self.stats["lora_swaps"] += int(swap)

    def register_adapter(self, name: str, source) -> None:
        """Register a named adapter for per-request selection."""
        new = self._load_tree(source)
        copies = [_moved(new, r.device) for r in self._replicas]
        with self._lock:
            self.adapters[name] = new
            for r, c in zip(self._replicas, copies):
                r.adapters[name] = c

    def unregister_adapter(self, name: str) -> None:
        with self._lock:
            if name not in self.adapters:
                raise KeyError(f"unknown adapter {name!r}; registered: {self.adapter_names}")
            del self.adapters[name]
            for r in self._replicas:
                del r.adapters[name]

    @property
    def adapter_names(self) -> List[str]:
        return sorted(self.adapters)

    def _sample(self, r: _Replica, prompts: Sequence[str], seeds: Sequence[int],
                adapter: Optional[str]) -> torch.Tensor:
        """A chunk's final latents on its replica: each request's starting
        noise the first draws of a generator seeded with its seed on the
        device, a stochastic sampler's fresh noise the next ones."""
        gens = [torch.Generator(r.device).manual_seed(int(s)) for s in seeds]
        init = torch.stack([torch.randn(self._latent_shape, generator=g, device=r.device)
                            for g in gens])
        lora = r.adapters[adapter] if adapter is not None else r.lora
        return self.pipe.generate(r.frozen, lora, r.encode(prompts), r.uncond, init,
                                  self.cfg.guidance_scale, renoise=gens, decode=False)

    def _decode(self, r: _Replica, latents: torch.Tensor) -> torch.Tensor:
        """A chunk's images in [-1, 1], on its device."""
        with torch.inference_mode():
            return self.bundle.decode_latents(r.frozen, latents, self.cfg.decode_chunk).float()

    def _each(self, fn: Callable, args: Sequence[tuple]) -> list:
        """``fn(replica, *a)`` for each replica in turn, its device the
        current one (the kernels launch on the current device)."""
        out = []
        for r, a in zip(self._replicas, args):
            with torch.cuda.device(r.device) if r.device.type == "cuda" else \
                    contextlib.nullcontext():
                out.append(fn(r, *a))
        return out

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
        k = b // len(self._replicas)
        chunks = [(prompts[i:i + k], seeds[i:i + k], adapter) for i in range(0, b, k)]
        with self._lock:
            if adapter is not None and adapter not in self.adapters:
                raise KeyError(f"unknown adapter {adapter!r}; registered: {self.adapter_names}")
            latents = self._each(self._sample, chunks)
            imgs = self._each(self._decode, [(x,) for x in latents])
            if not all(bool(torch.isfinite(x).all()) for x in imgs):
                raise FloatingPointError("non-finite pixels in the generated batch")
            out = torch.cat([((x + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu()
                             for x in imgs])[:n].numpy()
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["pad_rows"] += pad
        return out

    def warmup(self) -> None:
        self.generate_batch(["warmup"], [0])


def _moved(tree: Optional[Adapter], device: torch.device) -> Optional[Adapter]:
    return None if tree is None else {k: v.to(device) for k, v in tree.items()}
