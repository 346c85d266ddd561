"""Data parallelism over `torch.distributed` (counterpart of `pcm_tpu/parallel/mesh.py`).

One process a rank, each holding a whole replica of the frozen weights and
of the trained state, and a block of the global batch. The global batch is
the ranks' local batches in rank order, as JAX assembles it
(`make_array_from_process_local_data`); the gradients are averaged over the
ranks once an optimizer step (`all_reduce_mean`, called by
`train/distill.py:accumulate_grads`), so every rank's optimizer sees the
global gradient and the states stay equal with no broadcast.

The device collectives run on the default group: NCCL when every rank has a
card of its own (``cuda:LOCAL_RANK``), gloo when ranks share a card (NCCL
refuses two ranks on one device) or run on the CPU. The host-side agreements
(`barrier`, `any_rank`) run on a gloo group of CPU tensors, as the JAX
package's barrier uses the coordinator's key-value store rather than a
device collective: they cost no device sync.

With no process group (a plain ``python -m pcm_tpu_torch.train``) `rank` is
0, `world` 1, and nothing here issues a collective.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# the gloo group of the host-side agreements (the default group when it is gloo)
_host_group = None


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


def all_reduce_mean(tree):
    """The mean over the ranks of a tree of tensors on one device: one fp32
    buffer, one ``all_reduce``, a division by `world`; each tensor comes back
    in its own dtype. Without a process group, the tree itself."""
    if not active():
        return tree
    leaves = _leaves(tree)
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    dist.all_reduce(flat)
    flat /= world()
    out, o = [], 0
    for t in leaves:
        out.append(flat[o:o + t.numel()].view(t.shape).to(t.dtype))
        o += t.numel()
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

