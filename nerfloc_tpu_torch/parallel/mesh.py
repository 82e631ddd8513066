"""Process groups of a (data, ray) rank grid (counterpart of
nerfloc_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh with two axes:
`data` (one query per device, the gradient all-reduced over it) and `ray`
(the rays of one rendered frame split over it). Here every device is a
process of `torch.distributed`, launched by torchrun: the mesh is a grid
of ranks, `data` groups are its columns (ranks with the same ray index)
and `ray` groups its rows. Collectives are explicit (train/step.py
all-reduces the gradient, parallel/render.py all-gathers the rays).

`batch_sharding`, `ray_sharding` and `replicated` of the JAX module are
XLA layout annotations; a process group has no such thing, and
`shard_batch` returns this rank's rows instead.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    ray: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.ray


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, ray) grid of ranks. `coords` is None
    on a rank outside the grid (the world may be wider than the mesh);
    the groups are None there and when no process group is initialized
    (one process)."""
    spec: MeshSpec
    coords: Optional[Tuple[int, int]]
    data_group: Optional[dist.ProcessGroup] = None
    ray_group: Optional[dist.ProcessGroup] = None

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def ray_index(self) -> int:
        return self.coords[1]


def launched() -> bool:
    """True in a process that torchrun started (its environment names a
    rank and a world)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_distributed(backend: Optional[str] = None,
                     device: DeviceLike = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return
    this rank's device: cuda:(LOCAL_RANK % device_count) unless the
    caller names another device (an indexed one is kept as given). The
    backend is NCCL on CUDA and gloo on the CPU unless it is named. A
    missing variable or a group that fails to form raises; a second call
    in the same process returns the device without joining again."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: torchrun's environment lacks {missing}")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        dev = torch.device("cuda", local % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise RuntimeError("init_distributed: joined as another rank or world")
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=size)
    return dev


def make_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """A (data, ray) grid over the first spec.n_devices ranks of the
    default group, rank = data_index * ray + ray_index; with no spec, every
    rank goes to `data`. Every rank of the world must call it (it creates
    the groups). Raises ValueError when the world is too small."""
    rank, size = world()
    spec = MeshSpec(data=size, ray=1) if spec is None else spec
    if spec.n_devices > size:
        raise ValueError(f"mesh {spec} needs {spec.n_devices} ranks, have {size}")
    coords = divmod(rank, spec.ray) if rank < spec.n_devices else None
    if not is_initialized():
        return Mesh(spec, coords)
    grid = np.arange(spec.n_devices).reshape(spec.data, spec.ray)
    data_group = ray_group = None
    for col in range(spec.ray):
        g = dist.new_group(grid[:, col].tolist())
        if coords is not None and coords[1] == col:
            data_group = g
    for row in range(spec.data):
        g = dist.new_group(grid[row].tolist())
        if coords is not None and coords[0] == row:
            ray_group = g
    return Mesh(spec, coords, data_group, ray_group)


def shard_batch(host_batch: Mapping[str, np.ndarray], mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a host batch laid out over `data`: rank r of
    the axis gets rows r*B/n .. (r+1)*B/n. Leaves without a leading axis
    that n divides are replicated whole."""
    n = mesh.spec.data
    r = mesh.data_index

    def take(x):
        x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] % n == 0 and x.shape[0] >= n:
            k = x.shape[0] // n
            return x[r * k:(r + 1) * k]
        return x

    return {k: take(v) for k, v in host_batch.items()}
