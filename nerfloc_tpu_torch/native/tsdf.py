"""TSDF fusion (counterpart of nerfloc_tpu/native/tsdf.py): integrate posed
RGB-D frames into a truncated signed-distance volume and extract the
coloured surface points (the `pc.ply` the scene stores read) or a mesh.

The volume lives on the volume's device in five float32 tensors of
nx*ny*nz voxels, z fastest, with int64 flat indices (the JAX engine's
layout): `tsdf` (initialised to 1), `weight`, and the colour accumulators
`r`, `g`, `b`. `integrate_frame` is the wrapper of the integration: CUDA
tensors go through the hand-written kernel csrc/tsdf.cu (built by
ops/native at first use; launches counted in `LAUNCHES`), CPU tensors
through its plain version, csrc/tsdf_host.cpp (the host copy of the JAX
engine's integrate, built with the host's C++ compiler); there is no
fallback between them. The two give bit-equal volumes (see the sources).
The world-to-camera transform is computed once per frame on the host, in
float32 steps in the JAX engine's order, and handed to either.

Point extraction on the card is a mask and `torch.nonzero` over the flat
index (the host loop's (ix, iy, iz) order); on the CPU the host copy's.
`get_mesh` (marching tetrahedra) runs the host copy on a host copy of the
volume.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import native
from ..ops.fused_agg import LaunchCount

Tensor = torch.Tensor
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float


LAUNCHES = LaunchCount()


@functools.lru_cache(maxsize=None)
def _host():
    lib = native.load_host("tsdf_host")
    lib.tsdf_integrate.argtypes = [_P] * 5 + [_I64] * 3 + [_P, _F, _F, _P, _P, ctypes.c_int,
                                                            ctypes.c_int, _P, _P, _P, _F]
    lib.tsdf_integrate.restype = _I64
    lib.tsdf_count_surface.argtypes = [_P, _P, _I64, _F]
    lib.tsdf_count_surface.restype = _I64
    lib.tsdf_extract_points.argtypes = [_P] * 5 + [_I64] * 3 + [_P, _F, _F, _P, _P, _I64]
    lib.tsdf_extract_points.restype = _I64
    lib.tsdf_extract_mesh.argtypes = [_P, _P, _I64, _I64, _I64, _P, _F, _P, _I64]
    lib.tsdf_extract_mesh.restype = _I64
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load("tsdf").tsdf_integrate_cuda
    fn.argtypes = [_P] * 5 + [ctypes.c_int] * 3 + [_P, _F, _F, _P, _P, ctypes.c_int,
                                                   ctypes.c_int, _P, _P, _P, _F, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def world_to_camera(c2w) -> Tuple[np.ndarray, np.ndarray]:
    """(R [9], t [3]) float32 of the rigid camera-to-world c2w [4, 4]: R is
    the transpose of its rotation, t = -(R @ its translation), each product
    and sum rounded to float32 in the JAX engine's order."""
    c = np.asarray(c2w, dtype=np.float32)
    R = np.ascontiguousarray(c[:3, :3].T)
    t = np.empty(3, np.float32)
    for i in range(3):
        t[i] = -(R[i, 0] * c[0, 3] + R[i, 1] * c[1, 3] + R[i, 2] * c[2, 3])
    return R.reshape(9), t


def integrate_frame(vol: Dict[str, Tensor], dims, origin: np.ndarray, voxel_size: float,
                    sdf_trunc: float, depth: Tensor, color: Optional[Tensor], K: np.ndarray,
                    R: np.ndarray, t: np.ndarray, obs_weight: float,
                    overflow: Tensor) -> None:
    """Integrate one frame into the volume `vol` (tsdf, weight, r, g, b
    [nx*ny*nz] float32 contiguous). depth [H, W] metres and color [H, W, 3]
    in [0, 1] (or None) float32 on the volume's device; K [9], R [9], t [3]
    and origin [3] float32 host arrays. `overflow` (int64, on the same
    device) counts the voxels whose projection left the int range. CUDA
    tensors launch the kernel on the current stream, CPU tensors run the
    host copy."""
    nx, ny, nz = (int(d) for d in dims)
    dev = vol["tsdf"].device
    H, W = depth.shape
    for name, x in (*vol.items(), ("depth", depth), ("color", color)):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"tsdf: {name} must be contiguous float32 on {dev}")
    if any(vol[k].numel() != nx * ny * nz for k in vol):
        raise ValueError(f"tsdf: volume tensors do not hold {nx}x{ny}x{nz} voxels")
    if color is not None and tuple(color.shape) != (H, W, 3):
        raise ValueError(f"tsdf: color has shape {tuple(color.shape)}, expected {(H, W, 3)}")
    host = [np.ascontiguousarray(a, dtype=np.float32) for a in (origin, K, R, t)]
    cptr = 0 if color is None else color.data_ptr()
    args = [vol[k].data_ptr() for k in ("tsdf", "weight", "r", "g", "b")]
    if dev.type == "cpu":
        n = _host().tsdf_integrate(*args, nx, ny, nz, _ptr(host[0]), voxel_size, sdf_trunc,
                                   depth.data_ptr(), cptr or None, H, W, _ptr(host[1]),
                                   _ptr(host[2]), _ptr(host[3]), obs_weight)
        overflow += n
        return
    if dev.type != "cuda":
        raise ValueError(f"tsdf: no integration on {dev}")
    if overflow.dtype != torch.int64 or overflow.device != dev:
        raise ValueError(f"tsdf: the overflow counter must be int64 on {dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn()(*args, nx, ny, nz, _ptr(host[0]), voxel_size, sdf_trunc,
                       depth.data_ptr(), cptr or None, H, W, _ptr(host[1]), _ptr(host[2]),
                       _ptr(host[3]), obs_weight, overflow.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tsdf kernel launch failed: CUDA error {err}")
    LAUNCHES.n += 1


class TSDFVolume:
    """Truncated SDF volume over an axis-aligned box, on `device` (cuda
    unless the caller asks for another)."""

    def __init__(self, vol_bounds: np.ndarray, voxel_size: float,
                 trunc_margin: Optional[float] = None, device: DeviceLike = None):
        """vol_bounds: [3, 2] min/max in metres."""
        vol_bounds = np.asarray(vol_bounds, dtype=np.float32)
        self.device = resolve_device(device)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(trunc_margin if trunc_margin is not None
                               else 5.0 * voxel_size)
        dims = np.ceil((vol_bounds[:, 1] - vol_bounds[:, 0])
                       / voxel_size).astype(np.int64)
        self.dims = np.maximum(dims, 1)
        self.origin = np.ascontiguousarray(vol_bounds[:, 0], dtype=np.float32)
        n = int(np.prod(self.dims))
        self.tsdf = torch.ones(n, dtype=torch.float32, device=self.device)
        self.weight, self.r, self.g, self.b = (
            torch.zeros(n, dtype=torch.float32, device=self.device) for _ in range(4))
        self._overflow = torch.zeros((), dtype=torch.int64, device=self.device)

    def volume(self) -> Dict[str, Tensor]:
        return {"tsdf": self.tsdf, "weight": self.weight, "r": self.r, "g": self.g,
                "b": self.b}

    @property
    def projection_overflows(self) -> int:
        """Voxels skipped so far because their projection left the int
        range (reads the device)."""
        return int(self._overflow)

    def _upload(self, a) -> Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)
                               if not isinstance(a, Tensor) else a,
                               dtype=torch.float32).to(self.device).contiguous()

    def integrate(self, color, depth, K: np.ndarray, c2w: np.ndarray,
                  obs_weight: float = 1.0):
        """color [H,W,3] in [0,1] or None; depth [H,W] metres; c2w [4,4].
        color and depth may be numpy arrays (uploaded once) or tensors."""
        R, t = world_to_camera(c2w)
        integrate_frame(self.volume(), self.dims, self.origin, self.voxel_size,
                        self.sdf_trunc, self._upload(depth),
                        None if color is None else self._upload(color),
                        np.asarray(K, np.float32).reshape(9), R, t, float(obs_weight),
                        self._overflow)

    def get_point_cloud(self, thresh: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
        """Surface voxel centres and colours (|tsdf| < thresh, weight > 0),
        numpy float32 [M, 3] each, in flat-index order."""
        if self.device.type == "cpu":
            return self._points_host(thresh)
        return points_torch(self.volume(), self.dims, self.origin, self.voxel_size, thresh)

    def _points_host(self, thresh: float):
        lib = _host()
        n = lib.tsdf_count_surface(self.tsdf.data_ptr(), self.weight.data_ptr(),
                                   self.tsdf.numel(), thresh)
        xyz = np.empty((max(n, 1), 3), dtype=np.float32)
        rgb = np.empty((max(n, 1), 3), dtype=np.float32)
        m = lib.tsdf_extract_points(*[v.data_ptr() for v in self.volume().values()],
                                    *(int(d) for d in self.dims), _ptr(self.origin),
                                    self.voxel_size, thresh, _ptr(xyz), _ptr(rgb), n)
        return xyz[:m], rgb[:m]

    def get_mesh(self, max_triangles: int = 4_000_000) -> np.ndarray:
        """Surface triangles [T, 3, 3] by marching tetrahedra (host code, on
        a host copy of the volume)."""
        tsdf = np.ascontiguousarray(self.tsdf.cpu().numpy())
        weight = np.ascontiguousarray(self.weight.cpu().numpy())
        buf = np.empty((max_triangles, 9), dtype=np.float32)
        n = _host().tsdf_extract_mesh(_ptr(tsdf), _ptr(weight), *(int(d) for d in self.dims),
                                      _ptr(self.origin), self.voxel_size, _ptr(buf),
                                      max_triangles)
        tris = buf[:n].reshape(-1, 3, 3)
        # drop degenerate slivers (crossings collapsed onto a lattice point)
        a = tris[:, 1] - tris[:, 0]
        b = tris[:, 2] - tris[:, 0]
        area2 = np.linalg.norm(np.cross(a, b), axis=1)
        return tris[area2 > 1e-12]

    @staticmethod
    def frustum_bounds(depths, Ks, c2ws, margin: float = 0.1) -> np.ndarray:
        """[3, 2] axis-aligned box of all view frusta (numpy, float64)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for depth, K, c2w in zip(depths, Ks, c2ws):
            d = depth[depth > 0]
            if d.size == 0:
                continue
            dmax = float(d.max())
            H, W = depth.shape
            corners = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)
            for dd in (0.0, dmax):
                x = (corners[:, 0] - K[0, 2]) / K[0, 0] * dd
                y = (corners[:, 1] - K[1, 2]) / K[1, 1] * dd
                pts = np.stack([x, y, np.full(4, dd)], -1)
                w = pts @ np.asarray(c2w)[:3, :3].T + np.asarray(c2w)[:3, 3]
                lo = np.minimum(lo, w.min(0))
                hi = np.maximum(hi, w.max(0))
        return np.stack([lo - margin, hi + margin], axis=-1)


def points_torch(vol: Dict[str, Tensor], dims, origin: np.ndarray, voxel_size: float,
                 thresh: float) -> Tuple[np.ndarray, np.ndarray]:
    """The surface points of `vol` with tensor operations on its device (the
    card's extraction): the voxels with weight > 0 and |tsdf| < thresh, in
    flat-index order, their centres origin + index * voxel_size (one f32
    product, then one f32 sum, as the host computes them) and colours."""
    nx, ny, nz = (int(d) for d in dims)
    dev = vol["tsdf"].device
    th = torch.tensor(thresh, dtype=torch.float32, device=dev)
    keep = (vol["weight"] > 0) & (vol["tsdf"].abs() < th)
    idx = torch.nonzero(keep).squeeze(1)
    ijk = torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz], dim=1)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    o = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    xyz = ijk.to(torch.float32) * vs + o
    rgb = torch.stack([vol[k][idx] for k in ("r", "g", "b")], dim=1)
    return xyz.cpu().numpy(), rgb.cpu().numpy()
