"""Small host-side utilities (counterpart of nerfloc_tpu/utils/common.py):
`colorize_depth` and `AttrDict`."""
from __future__ import annotations

import numpy as np


def colorize_depth(depth: np.ndarray, mask: np.ndarray | None = None,
                   d_min: float | None = None, d_max: float | None = None
                   ) -> np.ndarray:
    """Depth map -> [H, W, 3] float RGB in [0, 1] on a jet-like ramp;
    pixels outside `mask` (or not finite) are black."""
    d = np.asarray(depth, dtype=np.float64)
    valid = np.isfinite(d)
    if mask is not None:
        valid &= mask.astype(bool)
    vals = d[valid]
    lo = float(np.min(vals)) if (d_min is None and vals.size) else (d_min or 0.0)
    hi = float(np.max(vals)) if (d_max is None and vals.size) else (d_max or 1.0)
    x = np.clip((d - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    rgb = np.stack([r, g, b], axis=-1)
    rgb[~valid] = 0.0
    return rgb.astype(np.float32)


class AttrDict(dict):
    """A dict whose keys read and write as attributes; a missing key raises
    AttributeError."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v
