"""Minimal PLY point-cloud IO (a copy of nerfloc_tpu/data/ply.py): xyz and
optional rgb, ascii or binary_little_endian, numpy and struct only.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
    "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2), "ushort": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
}


def read_ply_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (xyz [N,3] float32, rgb [N,3] float32 in [0,1] or None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []  # (name, struct_char, nbytes) for the vertex element
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element")
                ch, nb = _PLY_TYPES[parts[1]]
                props.append((parts[2], ch, nb))
            elif line == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n_vertex, dtype=np.float64)
            rows = np.atleast_2d(rows)
        elif fmt == "binary_little_endian":
            rec = "<" + "".join(p[1] for p in props)
            size = struct.calcsize(rec)
            raw = f.read(size * n_vertex)
            rows = np.array([struct.unpack_from(rec, raw, i * size)
                             for i in range(n_vertex)], dtype=np.float64)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    def col(n):
        return rows[:, names.index(n)] if n in names else None

    xyz = np.stack([col("x"), col("y"), col("z")], axis=-1).astype(np.float32)
    rgb = None
    if "red" in names:
        rgb = np.stack([col("red"), col("green"), col("blue")], axis=-1)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
        rgb = rgb.astype(np.float32)
    return xyz, rgb


def write_ply_points(path: str, xyz: np.ndarray,
                     rgb: Optional[np.ndarray] = None) -> None:
    """Write a binary_little_endian PLY point cloud (xyz float, rgb uchar)."""
    n = len(xyz)
    with open(path, "wb") as f:
        head = ["ply", "format binary_little_endian 1.0",
                f"element vertex {n}",
                "property float x", "property float y", "property float z"]
        if rgb is not None:
            head += ["property uchar red", "property uchar green",
                     "property uchar blue"]
        head.append("end_header")
        f.write(("\n".join(head) + "\n").encode("ascii"))
        xyz = np.asarray(xyz, dtype="<f4")
        if rgb is None:
            f.write(xyz.tobytes())
        else:
            c = np.asarray(rgb)
            if c.dtype != np.uint8:
                c = np.clip(c * 255.0 if c.max() <= 1.5 else c, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = xyz
            rec["rgb"] = c
            f.write(rec.tobytes())
