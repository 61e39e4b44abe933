"""Runs across processes (the counterpart of mindthegap_tpu/parallel/distributed.py).

Every process (a rank) runs the same program on the same inputs:

  1. each rank calls `init_distributed()`: torch.distributed over gloo,
     with the coordinator, world size and rank from the arguments or from
     a launcher's environment (torchrun's MASTER_ADDR, WORLD_SIZE, RANK);
  2. a rank's mesh holds its own devices (parallel/mesh.py make_mesh), and
     `global_mesh` places that block in the global shard order: blocks are
     contiguous, of one size on every rank, and in rank order;
  3. the sharded engines scan and count their block's shards on the rank's
     own devices; the results cross ranks through the collectives below,
     so that every rank computes the same artifacts;
  4. rank 0 is the writer of record (`is_writer`).

Gloo carries every collective: each exchange ends on the host, as the JAX
package's process_allgather returns numpy, and gloo lets several ranks
share one card (NCCL does not). Every collective runs under the group's
timeout, so a rank that fails or stops makes the others fail, not hang.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a run across processes. No-op when no coordinator is given and no
    launcher set one (MASTER_ADDR), or when this process already joined.
    coordinator_address: host:port, or an init method URL (tcp://host:port,
    file:///path). Missing arguments are read from WORLD_SIZE and RANK. On
    a machine with CUDA the rank's card becomes the current device: card
    LOCAL_RANK (else the rank) modulo the visible cards."""
    if coordinator_address is None and "MASTER_ADDR" not in os.environ and num_processes is None:
        return
    if dist.is_initialized():
        return
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes the merged artifacts of record (rank 0)."""
    return process_index() == 0


@dataclass(frozen=True)
class GlobalMesh:
    """The mesh of a run across processes, seen from one rank: its own devices
    (`local`, one a shard), the global index of its first shard (`offset`)
    and the shards of every rank (`size`). One process: offset 0, size
    len(local)."""

    local: list
    offset: int
    size: int


def global_mesh(local: list) -> GlobalMesh:
    """Lay every rank's block of shards, in rank order, on one global axis.
    A collective across processes: every rank calls it at the same point.
    Blocks must have one size on every rank (the gathers reassemble equal
    blocks in rank order)."""
    n = process_count()
    if n == 1:
        return GlobalMesh(list(local), 0, len(local))
    sizes = allgather_object(len(local))
    if len(set(sizes)) != 1:
        raise ValueError(f"every rank must hold as many shards: the ranks hold {sizes}")
    return GlobalMesh(list(local), process_index() * len(local), n * len(local))


def allgather_object(obj) -> list:
    """Gather one picklable object a rank; every rank returns the list
    [obj_rank0, obj_rank1, ...] (the merge path of the fill's job results)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allgather_tensor(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (on the host, one shape on every rank), stacked in
    rank order: [n_ranks, *t.shape]."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts)


def all_to_all(t: torch.Tensor) -> torch.Tensor:
    """Block r of `t` ([n_ranks, ...], on the host) goes to rank r; returns
    [n_ranks, ...] whose block r came from rank r."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out


def shard_bounds(n_items: int, n_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous [lo, hi) bounds of `shard` when n_items are split as evenly
    as possible — the job/window partitioning used for find windows and fill
    jobs (deterministic merge = concatenation in shard order)."""
    base, rem = divmod(n_items, n_shards)
    lo = shard * base + min(shard, rem)
    hi = lo + base + (1 if shard < rem else 0)
    return lo, hi
