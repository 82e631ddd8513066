"""Retrieval strips: each query beside its first five retrievals
(counterpart of nerfloc_tpu/retrieval/vis.py), written as PNGs through
data/png.py."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..data import png
from ..data.imgproc import resize_linear
from ..data.reader import load_image


def save_retrieval_strips(base_dir: str, top_k: Dict[str, List[str]], out_dir: str,
                          max_queries: int = 20, thumb: int = 128) -> List[str]:
    """For each of the first max_queries queries one row [query | db1 |
    ... | db5] of thumbnails (shorter side `thumb`, cropped square), a red
    separator after the query; returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for qi, (qname, db_names) in enumerate(top_k.items()):
        if qi >= max_queries:
            break
        tiles = []
        for name in [qname] + list(db_names[:5]):
            path = os.path.join(base_dir, name)
            if not os.path.exists(path):
                continue
            img = load_image(path)
            h, w = img.shape[:2]
            s = thumb / min(h, w)
            tiles.append(resize_linear(img, int(w * s), int(h * s))[:thumb, :thumb])
        if not tiles:
            continue
        strip = np.concatenate(tiles, axis=1)
        strip[:, thumb - 2: thumb + 2] = (255, 0, 0)
        out = os.path.join(out_dir, f"retrieval_{qname.replace('/', '_')}.png")
        png.write(out, strip)
        written.append(out)
    return written
