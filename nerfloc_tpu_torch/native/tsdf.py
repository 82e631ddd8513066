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
float32 steps in the JAX engine's order, and handed to either. For the
kernel the host also computes the frame's culling planes in float64
(`cull_planes`): the kernel skips the bricks of 8x8x8 voxels that no
update can reach (csrc/tsdf.cu), and `brick_keep_mask` is the numpy mirror
of its brick test, with the same operations in the same order.

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
                                                   ctypes.c_int, _P, _P, _P, _P, _F, _P, _P]
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


BRICK = 8               # voxels a side of the kernel's bricks
EDGE_PAD = 1.5          # an image edge's widening (pixels): the rounding to a pixel, and one more
_U = 2.0 ** -24         # float32's unit roundoff


def axis_centres(dims, origin: np.ndarray, voxel_size: float):
    """The voxel centres along each axis, float32, as the update computes
    them: origin + (float)i * voxel, each step rounded."""
    vs = np.float32(voxel_size)
    return [np.float32(origin[a]) + np.arange(int(n), dtype=np.float32) * vs
            for a, n in enumerate(dims)]


def cull_planes(dims, origin: np.ndarray, voxel_size: float, sdf_trunc: float, K: np.ndarray,
                R: np.ndarray, t: np.ndarray, H: int, W: int,
                depth_max: Optional[float] = None) -> np.ndarray:
    """The frame's culling planes for the kernel (csrc/tsdf.cu, struct
    Cull), float64 [23]: the camera depth pz as an affine form [4] of the
    world point, the four image edges widened by EDGE_PAD pixels [4 x 4]
    (>= 0 inside, for pz > 0), then m_z, z_far and z_keep.

    With the float32 K, R, t the update uses, taken exactly: a voxel's
    float32 pz, px, py differ from the exact forms by at most e_p = 6 u M
    (M bounds |w| summed over the axes plus |t|), so
    - a voxel with float pz > 0 has exact pz > -m_z (m_z = 2 e_p);
    - a voxel the frame updates has float pz <= depth_max + sdf_trunc, so
      exact pz <= z_far (+inf without depth_max);
    - where pz > z_keep, its pixel is off by under a quarter pixel, so a
      voxel whose rounded pixel is in the image lies inside every widened
      edge; a projection can leave the int range (and is counted) only
      where pz < z_keep / 2.
    A brick is skipped only if all of its voxels fail one of these."""
    k = np.asarray(K, np.float32).reshape(9).astype(np.float64)
    fx, cx, fy, cy = k[0], k[2], k[4], k[5]
    Rm = np.asarray(R, np.float32).reshape(3, 3).astype(np.float64)
    tv = np.asarray(t, np.float32).reshape(3).astype(np.float64)
    px, py, pz = (np.append(Rm[i], tv[i]) for i in range(3))
    side = [fx * px + (cx + EDGE_PAD) * pz, (W - 1 + EDGE_PAD - cx) * pz - fx * px,
            fy * py + (cy + EDGE_PAD) * pz, (H - 1 + EDGE_PAD - cy) * pz - fy * py]
    cent = axis_centres(dims, origin, voxel_size)
    M = sum(max(abs(float(c[0])), abs(float(c[-1]))) for c in cent) + float(np.abs(tv).max())
    e_p = 6 * _U * M
    span = max(W + abs(cx) + 1 + abs(fx), H + abs(cy) + 1 + abs(fy))
    z_ovf = 2 * max(abs(fx), abs(fy)) * (M + e_p) / 2.0 ** 31 + e_p
    z_keep = max(4 * span * e_p, 2 * z_ovf)
    z_far = np.inf
    if depth_max is not None and np.isfinite(depth_max):
        z_far = max((depth_max + sdf_trunc) * (1 + 4 * _U) + 2 * e_p, z_keep)
    return np.concatenate([pz, *side, [2 * e_p, z_far, z_keep]]).astype(np.float64)


def brick_keep_mask(dims, origin: np.ndarray, voxel_size: float, cull: np.ndarray) -> np.ndarray:
    """The kernel's brick test in numpy, on the numbers it is given: bool
    [nbx, nby, nbz], True where the kernel runs the brick's voxels. Each
    plane's extreme over a brick's corners is summed in float64 in the
    kernel's order (plane_extreme), so the two agree brick for brick."""
    cent = axis_centres(dims, origin, voxel_size)
    lo, hi = [], []
    for a, c in enumerate(cent):
        first = np.arange(0, len(c), BRICK)
        shape = [1, 1, 1]
        shape[a] = len(first)
        lo.append(c[first].astype(np.float64).reshape(shape))
        hi.append(c[np.minimum(first + BRICK, len(c)) - 1].astype(np.float64).reshape(shape))

    def extreme(p, largest: bool):
        v = np.float64(p[3])
        for a in range(3):
            v = v + p[a] * (hi[a] if (p[a] > 0.0) == largest else lo[a])
        return v
    pz, side = cull[:4], cull[4:20].reshape(4, 4)
    m_z, z_far, z_keep = cull[20:23]
    zmin = extreme(pz, False)
    keep = ~((extreme(pz, True) < -m_z) | (zmin > z_far))
    outside = np.zeros_like(keep)
    for p in side:
        outside |= extreme(p, True) < 0.0
    return keep & ~((zmin > z_keep) & outside)


def integrate_frame(vol: Dict[str, Tensor], dims, origin: np.ndarray, voxel_size: float,
                    sdf_trunc: float, depth: Tensor, color: Optional[Tensor], K: np.ndarray,
                    R: np.ndarray, t: np.ndarray, obs_weight: float,
                    overflow: Tensor, depth_max: Optional[float] = None) -> None:
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
    cull = cull_planes((nx, ny, nz), host[0], voxel_size, sdf_trunc, host[1], host[2], host[3],
                       H, W, depth_max)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn()(*args, nx, ny, nz, _ptr(host[0]), voxel_size, sdf_trunc,
                       depth.data_ptr(), cptr or None, H, W, _ptr(host[1]), _ptr(host[2]),
                       _ptr(host[3]), _ptr(cull), obs_weight, overflow.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tsdf kernel launch failed: CUDA error {err}")
    LAUNCHES.n += 1


def frame_depth_max(depth) -> float:
    """A frame's largest depth, as float32 values compare (NaN if the frame
    holds one: then nothing is culled by depth). A host frame is reduced on
    the host; a frame already on the card there, and the host reads it."""
    d = torch.as_tensor(depth, dtype=torch.float32)
    return float(d.max()) if d.numel() else 0.0


class TSDFVolume:
    """Truncated SDF volume over an axis-aligned box, on `device` (cuda
    unless the caller asks for another)."""

    def __init__(self, vol_bounds: np.ndarray, voxel_size: float,
                 trunc_margin: Optional[float] = None, device: DeviceLike = None):
        """vol_bounds: [3, 2] min/max in metres."""
        vol_bounds = np.asarray(vol_bounds, dtype=np.float32)
        dims = np.ceil((vol_bounds[:, 1] - vol_bounds[:, 0])
                       / voxel_size).astype(np.int64)
        self._allocate(np.maximum(dims, 1), vol_bounds[:, 0], voxel_size,
                       trunc_margin if trunc_margin is not None else 5.0 * voxel_size,
                       device)

    @classmethod
    def on_grid(cls, dims, origin: np.ndarray, voxel_size: float, sdf_trunc: float,
                device: DeviceLike = None) -> "TSDFVolume":
        """An empty volume of `dims` voxels from `origin` (float32 [3]),
        for example another volume's grid on another device."""
        vol = cls.__new__(cls)
        vol._allocate(np.asarray(dims, np.int64), origin, voxel_size, sdf_trunc, device)
        return vol

    def _allocate(self, dims: np.ndarray, origin, voxel_size: float, sdf_trunc: float,
                  device: DeviceLike) -> None:
        self.device = resolve_device(device)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc)
        self.dims = dims
        self.origin = np.ascontiguousarray(origin, dtype=np.float32)
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
        color and depth may be numpy arrays (uploaded once) or tensors. On
        the card the frame's largest depth gives the kernel its far plane."""
        R, t = world_to_camera(c2w)
        depth_max = frame_depth_max(depth) if self.device.type == "cuda" else None
        integrate_frame(self.volume(), self.dims, self.origin, self.voxel_size,
                        self.sdf_trunc, self._upload(depth),
                        None if color is None else self._upload(color),
                        np.asarray(K, np.float32).reshape(9), R, t, float(obs_weight),
                        self._overflow, depth_max)

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
