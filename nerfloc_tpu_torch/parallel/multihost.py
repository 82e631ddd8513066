"""Multi-process eval aggregation (counterpart of
nerfloc_tpu/parallel/multihost.py).

Each process evaluates the strided shard `rank::world` of the test set
(`process_shard_indices`) with no collective inside the eval step; the
per-query metric arrays are padded to the common shard capacity,
all-gathered as tensors (NCCL on the card, gloo on the CPU), trimmed and
put back in test-set order, so every process reduces the same arrays to
the same per-scene table.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import world

Array = np.ndarray


def process_shard_indices(n_items: int, rank: Optional[int] = None,
                          nprocs: Optional[int] = None) -> List[int]:
    """The strided shard of [0, n_items) that process `rank` of `nprocs`
    owns (default: this process of the default group)."""
    r, n = world()
    rank = r if rank is None else rank
    nprocs = n if nprocs is None else nprocs
    return list(range(n_items))[rank::nprocs]


def allgather_metrics(local: Dict[str, Array], indices: List[int], n_items: int,
                      group: Optional[dist.ProcessGroup] = None) -> Dict[str, Array]:
    """All-gather per-query arrays evaluated on strided shards.

    local: name -> [len(indices), ...] arrays of this process's shard;
    indices: the test-set indices it evaluated (ascending); n_items: the
    test-set size. Returns name -> [n_items, ...] in test-set order,
    identical on every process. Shards are padded to the largest shard
    with their first row (dropped after the gather). Every process must
    pass the same names in the same order."""
    nprocs = dist.get_world_size(group)
    cap = (n_items + nprocs - 1) // nprocs
    k = len(indices)
    # NCCL gathers tensors on this rank's card, gloo on the CPU
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] != k:
            raise ValueError(f"metric rows {x.shape[0]} != shard size {k}")
        if k == cap:
            return x
        fill = np.repeat(x[:1], cap - k, axis=0) if k else np.zeros((cap,) + x.shape[1:],
                                                                      x.dtype)
        return np.concatenate([x, fill], axis=0)

    def gather(x: Array) -> Array:
        x = pad(x)
        is_bool = x.dtype == np.bool_
        t = torch.from_numpy(np.ascontiguousarray(x.astype(np.uint8) if is_bool else x)).to(dev)
        parts = [torch.empty_like(t) for _ in range(nprocs)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts).cpu().numpy()
        return out.astype(np.bool_) if is_bool else out

    gidx = gather(np.asarray(indices, np.int64))
    keep = np.concatenate([np.arange(cap) < len(process_shard_indices(n_items, p, nprocs))
                           for p in range(nprocs)])
    order = np.argsort(gidx[keep], kind="stable")
    return {name: gather(v)[keep][order] for name, v in local.items()}
