"""Seeds of the run's parts, derived from --seed."""
from __future__ import annotations

import numpy as np

PARTS = ("weights", "scenes", "noise", "sample")


def derive(seed: int, part: str, index: int = 0) -> int:
    """A 63-bit seed for `part` (and its `index`-th item) of run `seed`;
    any whole number is a valid run seed."""
    ss = np.random.SeedSequence(entropy=int(seed) % (1 << 64),
                                spawn_key=(PARTS.index(part), int(index)))
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
