"""Data and ray parallelism over torch.distributed process groups."""
from .mesh import Mesh, MeshSpec, init_distributed, make_mesh, shard_batch

__all__ = ["Mesh", "MeshSpec", "init_distributed", "make_mesh", "shard_batch"]
