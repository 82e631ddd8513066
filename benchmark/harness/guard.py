"""The check that the run loaded neither JAX nor the JAX package."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nerfloc_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name, compared whole, is one of
    FORBIDDEN (`nerfloc_tpu_torch` is not `nerfloc_tpu`)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    return forbidden_modules(list(sys.modules))
