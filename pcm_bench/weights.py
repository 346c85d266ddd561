"""Seeded weights, adapters and inputs, the same on both sides of a cell.

The program under test and the plain reference are each handed tensors
drawn here from the run's ``--seed``. Each kind of draw takes a generator of
its own (`sub_seed` of the seed and a tag), on the card, in one large call:
every parameter of a module comes out of one normal draw over all of them,
walked in sorted name order, so two modules with the same parameter names
and shapes get the same values whatever their layout or dtype.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch

# tags of the draws
FROZEN, ADAPTER, DATA, LOOP = 0x5EED1, 0x5EED2, 0x5EED3, 0x5EED4

NORM_JITTER = 0.02  # 1-D weights: 1 + 0.02 N(0, 1); biases: 0.02 N(0, 1)


def sub_seed(seed: int, tag: int) -> int:
    """A seed for the draws of kind ``tag`` from the run's seed (any size)."""
    return (int(seed) * 1000003 + tag) % 2 ** 63


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(sub_seed(seed, tag))


@torch.no_grad()
def fill_frozen(params: Iterable[Tuple[str, torch.Tensor]], seed: int, device,
                served: torch.dtype = torch.bfloat16) -> None:
    """Weights drawn in place: a tensor of two or more dims N(0, 1/fan_in)
    (fan_in: all dims but the first), a 1-D weight 1 + 0.02 N(0, 1), a bias
    0.02 N(0, 1); each value rounded to ``served`` (the type the program
    serves the weights in) before it is cast into the parameter."""
    items = sorted(params, key=lambda kv: kv[0])
    total = sum(p.numel() for _, p in items)
    draw = torch.randn(total, generator=generator(seed, FROZEN, device), device=device)
    off = 0
    for name, p in items:
        v = draw[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if p.ndim == 1:
            v = NORM_JITTER * v + (0.0 if name.endswith("bias") else 1.0)
        else:
            v = v * (p[0].numel() ** -0.5)
        p.copy_(v.to(served))
    del draw


def draw_adapter(shapes: Mapping[str, Tuple[int, ...]], rank: int, b_std: float, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """fp32 LoRA factors: ``A ~ N(0, 1/rank^2)`` (the trainers' init) and
    ``B ~ N(0, b_std^2)``, non-zero, as an adapter some steps into training."""
    keys = sorted(shapes)
    sizes = [int(torch.Size(shapes[k]).numel()) for k in keys]
    draw = torch.randn(sum(sizes), generator=generator(seed, ADAPTER, device), device=device)
    out, off = {}, 0
    for k, n in zip(keys, sizes):
        scale = 1.0 / rank if k.endswith(".lora_a") else b_std
        out[k] = (draw[off:off + n] * scale).view(shapes[k]).clone()
        off += n
    return out
