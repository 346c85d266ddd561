"""FSDP of the frozen weights over the ``fsdp`` axis of a `Layout`
(counterpart of `pcm_tpu/parallel/mesh.py:fsdp_sharding` / `shard_fsdp`).

`fsdp_plan` follows JAX's rule (`pcm_tpu/parallel/mesh.py:117-134`) leaf by
leaf, parameters and buffers alike (an int8 weight's ``weight_values`` and
``weight_scale`` are two leaves, as a JAX ``QTensor``'s values and scale):
a leaf of fewer than ``min_size`` elements is replicated; otherwise the
largest of its axes that ``fsdp`` divides is split into ``fsdp`` equal
slices (the first such axis among equals), and a leaf with no such axis is
replicated. Axes are the port's (a Linear ``(out, in)``, a conv ``OIHW``);
the length split is JAX's, whose layouts are the transposes.

`shard_fsdp` keeps on each rank only its slice of each planned leaf: the
slices of one *unit* sit in one flat byte buffer, and the unit's module
holds views of it. A unit is a module whose call runs on its own leaves.
Each model declares its units: ``fsdp_units()`` returns the modules (each
remat block: the UNet's resnets, transformers, the BasicTransformerBlocks
inside them (a unit in a unit: the transformer keeps its norm and
projections) and resamplers, the MMDiT's joint blocks; each CLIP and T5 layer; each VAE resnet, attention and
resampler, and the VAE's encoder and decoder for their own convs and
norms), ``fsdp_entries`` names its entry points besides ``forward``, and
``fsdp_top()`` (T5's relative-position table) the modules inside a unit
whose leaves the top level reads. What no unit holds (the embeddings, the
first and last layers) forms the top-level unit. `shard_fsdp` refuses a
module with leaves to split that declares no units. A forward pre-hook gathers a unit with one all-gather of the
flat buffers on the fsdp group and unpacks each leaf by copying every
rank's slice into its place along the leaf's axis, in a tensor with the
strides the unsharded leaf had (channels-last convs stay channels-last: K5
and K6 read weights through TMA maps built from those strides); a forward
hook that runs also on an exception (a remat recompute that stops early)
puts the slices back. The top-level unit is gathered around the module's
call and its other entry points (`UNet2DCondition.features`,
`MMDiT.features`, `AutoencoderKL.encode` / ``decode``), so it stays
gathered while the blocks inside run: with no gradient the gathered bytes
alive are at most the top-level unit's and one block's.

With gradients the ops keep what their backward needs: an ``F.linear`` or
``F.conv2d`` its weight, so a block run with gradients and without remat
keeps its gathered weights until the backward has passed it. Under remat
(``use_reentrant=False``) the block's forward keeps nothing but what its
policy names (matmul outputs, K1's output: never a gathered weight, a
collective or a copy) and the recompute in the backward calls the block
again, which gathers it again, inside the caller's kernel choice and int8
mode (`models/unet.py:_remat_contexts`); at ``block`` granularity that is a
BasicTransformerBlock, the reason it is a unit of its own, while the
transformer's norm and projections, outside any region, keep their weights
to the backward. The student's forward is remat'ed in training, so a rank
holds its slices plus about one block's weights; without remat it holds
every weight the forward used until the backward.

Every rank of an fsdp group runs the same modules in the same order on the
same rows (`Layout.local_rows`), so the gathers line up. No branch on the
path depends on one rank's data: the discriminator's taps
(`train/adv.py:pair_features`, the bundles' ``teacher_features``) stop by
configuration (``stop_after_mid``), the text towers' pooled token is an
index, not a branch, and the adversarial pairing branches on the global
step. A gather that fails raises, and nothing computes on a slice. NCCL
gathers on the cards; gloo (ranks sharing a card) takes the CUDA tensors
and moves them through host memory itself.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Layout

Plan = Dict[Tuple[str, str], Optional[int]]

_ALIGN = 16  # bytes: every slice starts at a multiple of it in its unit's flat buffer


def shard_axis(shape, fsdp: int, min_size: int = 2 ** 16) -> Optional[int]:
    """The axis a leaf of ``shape`` is split on over ``fsdp`` ranks, None
    when it is replicated (`pcm_tpu/parallel/mesh.py:fsdp_sharding`)."""
    if fsdp == 1 or math.prod(shape) < min_size:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % fsdp == 0:
            return ax
    return None


def _named_leaves(module: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    yield from module.named_parameters()
    yield from module.named_buffers()


def fsdp_plan(frozen: Mapping[str, nn.Module], fsdp: int, min_size: int = 2 ** 16) -> Plan:
    """(module key, parameter or buffer name) -> the axis split over the
    ``fsdp`` ranks, or None (replicated), for every leaf of ``frozen``."""
    return {(key, name): shard_axis(tuple(t.shape), fsdp, min_size)
            for key, module in frozen.items() for name, t in _named_leaves(module)}


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_STATS = {"gathers": 0, "gathered_bytes": 0, "live_bytes": 0, "peak_live_bytes": 0}


def gather_stats() -> Dict[str, int]:
    """Since the last `reset_gather_stats`: ``gathers`` (all-gathers issued),
    ``gathered_bytes`` (the unsharded bytes they rebuilt), ``live_bytes``
    (rebuilt leaves alive now: still installed, or kept by autograd) and
    ``peak_live_bytes`` (the most of those alive at once)."""
    return dict(_STATS)


def reset_gather_stats() -> None:
    _STATS.update(gathers=0, gathered_bytes=0, peak_live_bytes=_STATS["live_bytes"])


def _freed(nbytes: int) -> None:
    _STATS["live_bytes"] -= nbytes


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Every rank's ``inp`` into ``out`` in group-rank order, one collective
    (``all_gather_single`` where torch has it and deprecates
    ``all_gather_into_tensor``; torch 2.11 has only the latter)."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, inp, group=group)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Leaf:
    name: str  # in the top-level module's state dict
    owner: nn.Module
    attr: str
    is_param: bool
    axis: int
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype
    offset: int  # bytes into the flat buffer
    nbytes: int  # of the slice
    shard: torch.Tensor  # this rank's slice, a view of the flat buffer

    def install(self, t: torch.Tensor) -> None:
        (self.owner._parameters if self.is_param else self.owner._buffers)[self.attr] = t


class _Unit:
    """The sharded leaves of one unit, their slices in one flat buffer."""

    def __init__(self, name: str, leaves: List[Tuple[str, nn.Module, str, bool, torch.Tensor, int]],
                 layout: Layout):
        self.name, self.group, self.n = name, layout.fsdp_group, layout.fsdp
        self.depth = 0
        offset, plans = 0, []
        for leaf_name, owner, attr, is_param, full, axis in leaves:
            k = full.shape[axis] // self.n
            view = full.narrow(axis, layout.fsdp_index * k, k)
            like = torch.empty_like(view, device="meta", memory_format=torch.preserve_format)
            nbytes = view.numel() * view.element_size()
            plans.append((leaf_name, owner, attr, is_param, full, axis, view, like.stride(), offset,
                          nbytes))
            offset += -(-nbytes // _ALIGN) * _ALIGN
        devices = {p[4].device for p in plans}
        if len(devices) != 1:
            raise ValueError(f"unit {name!r} spans devices {devices}")
        self.flat = torch.empty(offset, dtype=torch.uint8, device=devices.pop())
        self.leaves = []
        for leaf_name, owner, attr, is_param, full, axis, view, stride, off, nbytes in plans:
            shard = self._piece(self.flat, off, nbytes, full.dtype, view.shape, stride)
            shard.copy_(view)
            if is_param:
                shard = nn.Parameter(shard, requires_grad=False)
            leaf = _Leaf(leaf_name, owner, attr, is_param, axis, tuple(full.shape),
                         tuple(full.stride()), full.dtype, off, nbytes, shard)
            leaf.install(shard)
            self.leaves.append(leaf)

    @staticmethod
    def _piece(buf, off, nbytes, dtype, shape, stride) -> torch.Tensor:
        return buf[off:off + nbytes].view(dtype).as_strided(shape, stride)

    def gather(self) -> None:
        """Install the unsharded leaves."""
        per_rank = self.flat.numel()
        out = torch.empty(self.n * per_rank, dtype=torch.uint8, device=self.flat.device)
        all_gather(out, self.flat, self.group)
        with torch.no_grad():
            for leaf in self.leaves:
                t = torch.empty_strided(leaf.shape, leaf.stride, dtype=leaf.dtype,
                                        device=out.device)
                k = leaf.shape[leaf.axis] // self.n
                for r in range(self.n):
                    t.narrow(leaf.axis, r * k, k).copy_(self._piece(
                        out, r * per_rank + leaf.offset, leaf.nbytes, leaf.dtype,
                        leaf.shard.shape, leaf.shard.stride()))
                nbytes = t.numel() * t.element_size()
                _STATS["gathered_bytes"] += nbytes
                _STATS["live_bytes"] += nbytes
                weakref.finalize(t, _freed, nbytes)
                leaf.install(t)
        _STATS["gathers"] += 1
        _STATS["peak_live_bytes"] = max(_STATS["peak_live_bytes"], _STATS["live_bytes"])

    def release(self) -> None:
        for leaf in self.leaves:
            leaf.install(leaf.shard)

    def enter(self) -> None:
        if self.depth == 0:
            self.gather()
        self.depth += 1

    def exit(self) -> None:
        self.depth -= 1
        if self.depth == 0:
            self.release()


def _hook(module: nn.Module, unit: _Unit) -> None:
    module.register_forward_pre_hook(lambda m, args: unit.enter())
    module.register_forward_hook(lambda m, args, out: unit.exit(), always_call=True)


def _wrap(root: nn.Module, name: str, unit: _Unit) -> None:
    method = getattr(root, name)

    @functools.wraps(method)
    def entry(*args, **kwargs):
        unit.enter()
        try:
            return method(*args, **kwargs)
        finally:
            unit.exit()

    setattr(root, name, entry)


def _declared_paths(key: str, root: nn.Module, method: str) -> List[str]:
    """The module paths of the modules ``root.<method>()`` returns."""
    path_of = {id(m): p for p, m in root.named_modules()}
    mods = getattr(root, method, lambda: [])()
    if not all(id(m) in path_of and path_of[id(m)] for m in mods):
        raise ValueError(f"{key!r}: {method}() returns a module that is not a submodule")
    return [path_of[id(m)] for m in mods]


def _shard_module(key: str, root: nn.Module, plan: Plan, layout: Layout) -> List[_Unit]:
    split = [(name, t, plan[key, name]) for name, t in list(_named_leaves(root))
             if plan[key, name] is not None]
    paths = _declared_paths(key, root, "fsdp_units")
    top = _declared_paths(key, root, "fsdp_top")
    groups: Dict[str, list] = {}
    for name, t, axis in split:
        prefix, _, attr = name.rpartition(".")
        owner = root.get_submodule(prefix)
        unit = "" if any(name.startswith(p + ".") for p in top) else max(
            (p for p in paths if name.startswith(p + ".")), key=len, default="")
        groups.setdefault(unit, []).append((name, owner, attr, attr in owner._parameters, t, axis))
    units = []
    for path, leaves in groups.items():
        unit = _Unit(f"{key}.{path}" if path else key, leaves, layout)
        if path:
            _hook(root.get_submodule(path), unit)
        else:
            _hook(root, unit)
            for entry in getattr(root, "fsdp_entries", ()):
                _wrap(root, entry, unit)
        units.append(unit)
    root._fsdp_units = units
    return units


def shard_fsdp(frozen: Dict[str, nn.Module], layout: Layout,
               min_size: int = 2 ** 16) -> Dict[str, nn.Module]:
    """Keep this rank's slice of each leaf `fsdp_plan` splits in ``frozen``
    (the modules every rank built alike, from the seed or the file) and
    install the gathers on the layout's fsdp group; modules changed in
    place, the dict returned. With ``fsdp = 1`` nothing changes. A module
    with leaves to split that declares no ``fsdp_units`` raises, and then
    no module is changed."""
    if layout.fsdp == 1:
        return frozen
    plan = fsdp_plan(frozen, layout.fsdp, min_size)
    for key, module in frozen.items():
        if getattr(module, "_fsdp_units", None) is not None:
            raise ValueError(f"{key!r} is sharded already")
        n = sum(plan[key, name] is not None for name, _ in _named_leaves(module))
        if n and not hasattr(module, "fsdp_units"):
            raise TypeError(f"{key!r} ({type(module).__name__}) has {n} leaves to shard and "
                            "declares no fsdp_units()")
    for key, module in frozen.items():
        _shard_module(key, module, plan, layout)
    return frozen


def units(module: nn.Module) -> List[_Unit]:
    """The units `shard_fsdp` made in ``module`` (none when not sharded)."""
    return getattr(module, "_fsdp_units", [])


def full_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every leaf of a sharded ``module`` unsharded, by its state-dict name:
    each unit gathered once (a collective: every rank of the fsdp group
    calls it). The replicated leaves are the module's own tensors."""
    state = dict(_named_leaves(module))
    for unit in units(module):
        unit.gather()
        state.update((leaf.name, getattr(leaf.owner, leaf.attr)) for leaf in unit.leaves)
        unit.release()
    return state


def held_bytes(frozen: Mapping[str, nn.Module]) -> int:
    """Device bytes the modules of ``frozen`` hold at rest: every storage
    their parameters and buffers view, once (a unit's flat buffer counts
    whole)."""
    seen, total = set(), 0
    for module in frozen.values():
        for _, t in _named_leaves(module):
            s = t.untyped_storage()
            if s.data_ptr() not in seen:
                seen.add(s.data_ptr())
                total += s.nbytes()
    return total
