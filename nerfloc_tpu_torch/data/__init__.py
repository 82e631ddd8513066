"""Numpy-only data: batch construction, synthetic scenes, and the file
datasets (copies and counterparts of the JAX package's framework-free data
modules, so the port imports nothing of it)."""
from .batching import device_batch, stack_batches
from .factory import build_dataset
from .synthetic import (make_query_batch, write_object_scene, write_scene,
                        write_twelve_scenes_scene)

__all__ = ["device_batch", "stack_batches", "build_dataset", "make_query_batch",
           "write_scene", "write_object_scene", "write_twelve_scenes_scene"]
