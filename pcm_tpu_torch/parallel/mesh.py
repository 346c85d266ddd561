"""Data and FSDP parallelism over `torch.distributed` (counterpart of `pcm_tpu/parallel/mesh.py`).

One process a rank. The ranks form a ``data x fsdp`` grid (`make_mesh`), in
the order of JAX's ``np.asarray(devices).reshape(data, fsdp)``: rank r sits
at data index ``r // fsdp`` and fsdp index ``r % fsdp``. The ranks of one
fsdp group (the same data index) share their rows of the global batch and
their draws, and each holds a slice of the large frozen weights, gathered a
block at a time (`parallel/fsdp.py`); the ranks of one data group (the same
fsdp index) hold different rows. Every rank holds the whole trained state.
With ``fsdp = 1`` (what `init_distributed` alone gives) each rank holds a
whole replica of the frozen weights, as in plain data parallelism.

The global batch is the data groups' local batches in data-index order, as
JAX assembles it (`make_array_from_process_local_data`); the gradients are
averaged over the data group once an optimizer step (`all_reduce_mean`,
called by `train/distill.py:accumulate_grads`), so every rank's optimizer
sees the global gradient and the states stay equal with no broadcast.

The device collectives run on the default group and its subgroups: NCCL
when every rank has a card of its own (``cuda:LOCAL_RANK``), gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU. The
host-side agreements (`barrier`, `any_rank`) run on a gloo group of CPU
tensors over the whole world, as the JAX package's barrier uses the
coordinator's key-value store rather than a device collective: they cost no
device sync.

With no process group (a plain ``python -m pcm_tpu_torch.train``) `rank` is
0, `world` 1, the layout is ``1 x 1``, and nothing here issues a collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..utils import profiling

# the gloo group of the host-side agreements (the default group when it is gloo)
_host_group = None
# the layout `make_mesh` set last (None: data parallelism over the world)
_layout = None


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Explicit arguments come first (``coordinator`` as ``host:port`` or
    ``tcp://host:port``); otherwise the environment that ``python -m
    torch.distributed.run`` sets: ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. With
    ``device="cuda"`` a rank takes ``cuda:LOCAL_RANK`` and NCCL when the host
    has a card for each of its ranks, else the card ``LOCAL_RANK`` modulo the
    cards and gloo; with ``device="cpu"`` the CPU and gloo."""
    global _host_group
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 0))
    rank = process_id if process_id is not None else int(env.get("RANK", -1))
    if world < 1 or not 0 <= rank < world:
        raise RuntimeError("no process group to join: pass coordinator, num_processes and "
                           "process_id, or run under python -m torch.distributed.run (which "
                           "sets WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT)")
    if coordinator is not None:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        local_rank, local_world = rank, world  # explicit arguments: one host
    else:
        init_method = "env://"
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device for the process group: pass --device cpu")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _host_group = (dist.new_group(backend="gloo", timeout=datetime.timedelta(minutes=30))
                   if backend != "gloo" else dist.group.WORLD)
    return dev


def active() -> bool:
    """Whether this process is in a process group (then the steps all-reduce)."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The device collectives' backend, None without a process group."""
    return dist.get_backend() if active() else None


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0: the one that writes logs, checkpoints and images."""
    return rank() == 0


def barrier(name: str) -> None:
    """Wait for every rank on the host group (no device sync); a rank that
    does not arrive within 30 minutes fails it, named with ``name``."""
    if not active():
        return
    try:
        dist.monitored_barrier(group=_host_group, timeout=datetime.timedelta(minutes=30),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (a host-group all-reduce): every
    rank gets the same answer, so all take the same branch."""
    if not active():
        return flag
    with profiling.span("wait.any_rank"):
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
        return bool(t.item())


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/tuple/list, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _rebuild(tree, new: List[torch.Tensor]):
    """``tree`` with its tensors replaced, in `_leaves`' order, by ``new``'s."""
    it = iter(new)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def _memory_order(t: torch.Tensor) -> List[int]:
    """``t``'s dims from the largest stride down: ``t.permute`` by them is
    contiguous when ``t`` is dense (a channels-last conv's gradient too)."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def all_reduce_mean(tree, group=None):
    """The mean over the ranks of ``group`` (default: the world) of a tree of
    tensors on one device: one fp32 buffer, one ``all_reduce``, a division by
    the group's size; each tensor comes back in its own dtype and memory
    layout (a channels-last gradient stays channels-last, so what sums over
    it, a norm, sums in the same order as without a process group; over a
    group of one rank the result is the tree's bits). Without a process
    group, the tree itself."""
    if not active():
        return tree
    n = dist.get_world_size(group)
    leaves = _leaves(tree)
    orders = [_memory_order(t) for t in leaves]
    flat = torch.cat([t.detach().permute(o).reshape(-1).float() for t, o in zip(leaves, orders)])
    dist.all_reduce(flat, group=group)
    flat /= n
    out, off = [], 0
    for t, o in zip(leaves, orders):
        dense = flat[off:off + t.numel()].view([t.shape[d] for d in o])
        out.append(dense.permute([o.index(d) for d in range(t.dim())]).to(t.dtype))
        off += t.numel()
    return _rebuild(tree, out)


def replicate(tree):
    """Rank 0's tree on every rank, bit for bit: the tensors' bytes in one
    buffer, one broadcast (a guard after init and after resume: the ranks
    built it from the same seed or file). Non-tensor leaves are kept."""
    if not active():
        return tree
    leaves = _leaves(tree)
    if not leaves:
        return tree
    raw = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    flat = torch.cat(raw)
    dist.broadcast(flat, src=0)
    out, o = [], 0
    for t, r in zip(leaves, raw):
        # a copy first: a slice at an odd byte offset cannot be viewed as a wider type
        out.append(flat[o:o + r.numel()].clone().view(t.dtype).view(t.shape))
        o += r.numel()
    return _rebuild(tree, out)


def local_rows(tree, rank: int, world: int):
    """Rows ``[rank * B, (rank + 1) * B)`` of each tensor, B its rows over
    ``world`` (the counterpart of `shard_batch`: a rank's block of the global
    batch)."""
    def rows(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0]
        if n % world:
            raise ValueError(f"{n} rows do not split over {world} ranks")
        b = n // world
        return t[rank * b:(rank + 1) * b]

    return _rebuild(tree, [rows(t) for t in _leaves(tree)])



def coordinates(rank: int, fsdp: int) -> tuple:
    """(data index, fsdp index) of ``rank`` in a ``data x fsdp`` grid, the
    position of device ``rank`` in JAX's ``reshape(data, fsdp)``."""
    return rank // fsdp, rank % fsdp


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the ``data x fsdp`` grid (`make_mesh`).

    ``data_group``: the ranks with this rank's fsdp index (the gradients'
    all-reduce); ``fsdp_group``: the ranks with its data index (the frozen
    weights' gathers). Both are None without a process group."""

    data: int
    fsdp: int
    data_index: int
    fsdp_index: int
    data_group: Any = None
    fsdp_group: Any = None

    def local_rows(self, tree):
        """This rank's block of the global batch (or draws): the rows of its
        data index; the ranks of one fsdp group take the same rows."""
        return local_rows(tree, self.data_index, self.data)


def _group(ranks: List[int]):
    """The process group of ``ranks`` (the default group when it is the
    whole world). Every rank calls this for every group, in one order."""
    return dist.group.WORLD if len(ranks) == world() else dist.new_group(ranks)


def make_mesh(data: Optional[int] = None, fsdp: int = 1) -> Layout:
    """The ``data x fsdp`` layout of the ranks (``data`` defaults to the
    world over ``fsdp``), made the one that `data_group` returns. Without a
    process group it is ``1 x 1`` and makes no group. Every rank of the
    world calls it with the same arguments (the subgroups are made in one
    order on all)."""
    global _layout
    n = world()
    if data is None:
        data = n // fsdp
    if data < 1 or fsdp < 1 or data * fsdp != n:
        raise ValueError(f"a {data} x {fsdp} layout does not fit {n} ranks")
    d, f = coordinates(rank(), fsdp)
    if not active():
        _layout = Layout(1, 1, 0, 0)
        return _layout
    data_groups = [_group([j * fsdp + i for j in range(data)]) for i in range(fsdp)]
    fsdp_groups = [_group([j * fsdp + i for i in range(fsdp)]) for j in range(data)]
    _layout = Layout(data, fsdp, d, f, data_groups[f], fsdp_groups[d])
    return _layout


def data_group():
    """The group the gradients are averaged over: the data group of the
    layout `make_mesh` set, else the world (None)."""
    return _layout.data_group if _layout is not None else None
