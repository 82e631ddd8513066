"""The port's TSDF engine (nerfloc_tpu_torch/native/tsdf.py) on the CPU: its
host copy (csrc/tsdf_host.cpp, the plain version of the CUDA kernel
csrc/tsdf.cu) against the JAX package's native engine on the same frames,
and the card's point extraction (tensor operations) against the host's.

Tolerances. The JAX engine is built with -march=native, which contracts
products and sums into FMAs on an FMA-capable CPU; the port's host copy is
built without contraction (ops/native.HOST_FLAGS), so that the kernel, in
explicit IEEE operations, is bit-equal to it. Between the two builds:
weights equal; TSDF values and colours within TSDF_TOL (this file
measures 1.2e-6 and 2.4e-6, printed with -s); surface points the same
voxels in the same order except voxels whose |tsdf| lies within TSDF_TOL
of the threshold (counted, printed with -s), their centres within XYZ_TOL
(JAX's origin + i * voxel is one FMA: one rounding apart, measured 2.4e-7);
mesh triangles the same in number and order when no voxel lies on the
other side of 0 in the two engines (counted), vertices within MESH_TOL (a
crossing interpolates two TSDF values: measured 4.1e-6). The projection guard (a voxel just in
front of the camera whose pixel would not fit an int is skipped and
counted) is taken by no voxel of these scenes; a test makes it happen.
The kernel's brick culling is held through its numpy mirror
(brick_keep_mask on cull_planes' numbers): on seeded box views, a camera
looking away from the volume and one inside it whose camera plane cuts it
(the overflow case), no voxel the host copy updates or counts lies in a
culled brick; the kernel against the host copy runs on a GPU only.
"""
import ctypes

import numpy as np
import pytest
import torch

from nerfloc_tpu.native.tsdf import TSDFVolume as JTSDFVolume
from nerfloc_tpu_torch.data.synthetic import look_at_pose, render_box_view, texture
from nerfloc_tpu_torch.native import tsdf as ttsdf
from nerfloc_tpu_torch.native.tsdf import TSDFVolume

TSDF_TOL = 1e-5
XYZ_TOL = 1e-6
MESH_TOL = 1e-4


def _box_views(H=60, W=80, n=8):
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    views = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([0.2 * np.cos(ang), 0.0, 0.2 * np.sin(ang)])
        tgt = np.array([2.0 * np.cos(ang), 0.0, 2.0 * np.sin(ang)])
        c2w = look_at_pose(eye, tgt)
        rgb, depth = render_box_view(c2w, K, H, W)
        views.append((rgb, depth, c2w))
    return K, views


def _jax_volume(j, n):
    """(tsdf, weight) of a JAX TSDFVolume, through its library's accessors."""
    out = []
    for name in ("tsdf_data", "tsdf_weights"):
        fn = getattr(j._lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_float)
        fn.argtypes = [ctypes.c_void_p]
        out.append(np.ctypeslib.as_array(fn(j._vol), (n,)).copy())
    return out


def test_tsdf_box_fusion():
    K, views = _box_views()
    bounds = TSDFVolume.frustum_bounds(
        [v[1] for v in views], [K] * len(views), [v[2] for v in views])
    vol = TSDFVolume(bounds, voxel_size=0.08, device="cpu")
    for rgb, depth, c2w in views:
        vol.integrate(rgb, depth, K, c2w)
    xyz, rgb = vol.get_point_cloud(thresh=0.3)
    assert len(xyz) > 200
    # surface points lie near the box walls |coord|_inf ~= 2
    m = np.abs(xyz).max(axis=1)
    assert (np.abs(m - 2.0) < 0.2).mean() > 0.8
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    # colours approximate the analytic texture at the surface points
    assert np.abs(texture(xyz.astype(np.float64)) - rgb).mean() < 0.25
    assert vol.projection_overflows == 0


def test_tsdf_weights_accumulate():
    H, W = 40, 40
    K = np.array([[40.0, 0, 20.0], [0, 40.0, 20.0], [0, 0, 1.0]])
    depth = np.full((H, W), 2.0, np.float32)
    vol = TSDFVolume(np.array([[-1, 1], [-1, 1], [0.5, 3.0]]), 0.05, device="cpu")
    vol.integrate(None, depth, K, np.eye(4))
    xyz1, _ = vol.get_point_cloud(0.2)
    vol.integrate(None, depth, K, np.eye(4))
    xyz2, _ = vol.get_point_cloud(0.2)
    assert len(xyz1) > 0
    # re-integrating the same frame must not move the surface
    assert len(xyz2) == len(xyz1)
    assert (np.abs(xyz1[:, 2] - 2.0) < 0.12).mean() > 0.9
    assert float(vol.weight.max()) == 2.0


def test_tsdf_mesh_extraction():
    H, W = 40, 40
    K = np.array([[40.0, 0, 20.0], [0, 40.0, 20.0], [0, 0, 1.0]])
    depth = np.full((H, W), 2.013, np.float32)
    vol = TSDFVolume(np.array([[-1, 1], [-1, 1], [1.0, 3.0]]), 0.05, device="cpu")
    vol.integrate(None, depth, K, np.eye(4))
    tris = vol.get_mesh()
    assert len(tris) > 50
    # all triangle vertices lie near the z=2.013 plane
    z = tris[..., 2].reshape(-1)
    assert (np.abs(z - 2.013) < 0.1).mean() > 0.95
    a = tris[:, 1] - tris[:, 0]
    b = tris[:, 2] - tris[:, 0]
    assert (0.5 * np.linalg.norm(np.cross(a, b), axis=1) > 0).mean() > 0.9


def _voxel_index(xyz, origin, voxel):
    return np.round((xyz - origin) / np.float32(voxel)).astype(np.int64)


@pytest.mark.parametrize("voxel", [0.08, 0.04])
def test_tsdf_equals_jax(voxel):
    K, views = _box_views()
    bounds = TSDFVolume.frustum_bounds(
        [v[1] for v in views], [K] * len(views), [v[2] for v in views])
    t, j = TSDFVolume(bounds, voxel, device="cpu"), JTSDFVolume(bounds, voxel)
    assert np.array_equal(t.dims, j.dims) and np.array_equal(t.origin, j.origin)
    for i, (rgb, depth, c2w) in enumerate(views):
        # colour on all but one frame: the geometry-only path too
        t.integrate(rgb if i else None, depth, K, c2w)
        j.integrate(rgb if i else None, depth, K, c2w)
    n = int(np.prod(t.dims))
    j_tsdf, j_weight = _jax_volume(j, n)
    assert np.array_equal(t.weight.numpy(), j_weight)
    d_tsdf = np.abs(t.tsdf.numpy() - j_tsdf)
    assert d_tsdf.max() <= TSDF_TOL
    assert t.projection_overflows == 0

    thresh = 0.3
    a_xyz, a_rgb = t.get_point_cloud(thresh)
    b_xyz, b_rgb = j.get_point_cloud(thresh)
    near = np.abs(np.abs(j_tsdf) - thresh) <= TSDF_TOL
    ia, ib = (_voxel_index(x, t.origin, voxel) for x in (a_xyz, b_xyz))
    flat = t.dims[1] * t.dims[2]
    fa, fb = (i[:, 0] * flat + i[:, 1] * t.dims[2] + i[:, 2] for i in (ia, ib))
    keep_a, keep_b = ~near[fa], ~near[fb]
    print(f"voxel {voxel}: {len(a_xyz)} points, {int(near.sum())} voxels within "
          f"{TSDF_TOL} of the threshold, tsdf max diff {d_tsdf.max():.3g}, "
          f"xyz max diff {np.abs(a_xyz[keep_a] - b_xyz[keep_b]).max():.3g}")
    assert np.array_equal(fa[keep_a], fb[keep_b])
    assert np.abs(a_xyz[keep_a] - b_xyz[keep_b]).max() <= XYZ_TOL
    assert np.abs(a_rgb[keep_a] - b_rgb[keep_b]).max() <= TSDF_TOL

    # the card's extraction (tensor operations), here on CPU tensors,
    # equals the host's exactly
    c_xyz, c_rgb = ttsdf.points_torch(t.volume(), t.dims, t.origin, t.voxel_size, thresh)
    assert np.array_equal(c_xyz, a_xyz) and np.array_equal(c_rgb, a_rgb)

    # the mesh reads each voxel's side of 0 (an exact 0 counts as inside):
    # where no voxel changes side between the engines, the same triangles
    def inside(x):
        return np.where(x == 0, -1e-6, x) < 0
    flips = int((inside(t.tsdf.numpy()) != inside(j_tsdf))[j_weight > 0].sum())
    ma, mb = t.get_mesh(), j.get_mesh()
    print(f"mesh: {len(ma)} triangles, {flips} voxels on the other side of 0, "
          f"max diff {np.abs(ma - mb).max() if ma.shape == mb.shape else 'n/a'}")
    if flips == 0:
        assert ma.shape == mb.shape and np.abs(ma - mb).max() <= MESH_TOL


def test_integrate_accepts_tensors_and_checks_them():
    K, views = _box_views(n=2)
    rgb, depth, c2w = views[0]
    bounds = TSDFVolume.frustum_bounds([depth], [K], [c2w])
    a, b = TSDFVolume(bounds, 0.1, device="cpu"), TSDFVolume(bounds, 0.1, device="cpu")
    a.integrate(rgb, depth, K, c2w)
    b.integrate(torch.from_numpy(rgb), torch.from_numpy(depth), K, c2w)
    for k, v in a.volume().items():
        assert torch.equal(v, b.volume()[k]), k
    vol = a.volume()
    R, t = ttsdf.world_to_camera(c2w)
    with pytest.raises(ValueError, match="color"):
        ttsdf.integrate_frame(vol, a.dims, a.origin, a.voxel_size, a.sdf_trunc,
                              torch.from_numpy(depth), torch.zeros(3, 4, 3), K.reshape(9),
                              R, t, 1.0, torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        ttsdf.integrate_frame(vol, a.dims, a.origin, a.voxel_size, a.sdf_trunc,
                              torch.from_numpy(depth).double(), None, K.reshape(9), R, t, 1.0,
                              torch.zeros((), dtype=torch.int64))


def test_world_to_camera_is_the_engines():
    """R is c2w's rotation transposed; t = -(R @ c2w's translation) summed
    left to right in float32."""
    c2w = look_at_pose(np.array([0.3, -0.2, 0.7]), np.array([1.0, 2.0, -3.0]))
    R, t = ttsdf.world_to_camera(c2w)
    c = c2w.astype(np.float32)
    assert np.array_equal(R.reshape(3, 3), c[:3, :3].T)
    want = [-(np.float32(c[0, i] * c[0, 3] + c[1, i] * c[1, 3]) + c[2, i] * c[2, 3])
            for i in range(3)]
    assert np.array_equal(t, np.array(want, np.float32))


def test_projection_overflow_is_skipped_and_counted():
    """A plane of voxels 1e-9 m in front of the camera: fx*px/pz leaves the
    int range for all but the voxels within 0.05 m of the optical axis. The
    host copy skips exactly those numpy counts, in float32 as it computes
    them, and updates the others."""
    H, W = 40, 40
    K = np.array([[40.0, 0, 20.0], [0, 40.0, 20.0], [0, 0, 1.0]])
    vol = TSDFVolume(np.array([[-1.0, 1.0], [-1.0, 1.0], [1e-9, 0.5]]), 0.05, device="cpu")
    vol.integrate(None, np.full((H, W), 0.2, np.float32), K, np.eye(4))
    vs = np.float32(vol.voxel_size)
    w = [vol.origin[a] + np.arange(vol.dims[a], dtype=np.float32) * vs for a in range(3)]
    pz = w[2][0]
    q = [np.float32(40.0) * w[a] / pz + np.float32(20.0) for a in range(2)]
    out = [~(np.abs(x) < np.float32(2 ** 31)) for x in q]
    expect = int((out[0][:, None] | out[1][None, :]).sum())
    assert expect > 0
    assert vol.projection_overflows == expect
    assert np.isfinite(vol.tsdf.numpy()).all()


def _volume_with(bounds, voxel):
    return TSDFVolume(np.asarray(bounds, np.float64), voxel, device="cpu")


def _camera_cases():
    """(name, volume, depth, color, K, c2w): the box scene's seeded views;
    a camera outside the volume looking away from it; a camera inside the
    volume near its low-z face, one float32 step in front of a plane of
    voxel centres (their projections leave the int range: the overflow
    slab)."""
    K, views = _box_views()
    bounds = TSDFVolume.frustum_bounds(
        [v[1] for v in views], [K] * len(views), [v[2] for v in views])
    cases = [(f"box{i}", _volume_with(bounds, 0.08), depth, rgb, K, c2w)
             for i, (rgb, depth, c2w) in enumerate(views[:3])]
    rng = np.random.default_rng(7)
    H, W = 40, 48
    Ks = np.array([[40.0, 0, 24.0], [0, 40.0, 20.0], [0, 0, 1.0]])
    depth = rng.uniform(0.4, 1.6, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = 0.0
    color = rng.random((H, W, 3), dtype=np.float32)
    away = _volume_with([[-1, 1], [-1, 1], [0, 2]], 0.05)
    cases.append(("away", away, depth, color, Ks,
                  look_at_pose(np.array([1.5, 0.1, 1.0]), np.array([4.0, 0.3, 1.2]))))
    inside = _volume_with([[-1, 1], [-1, 1], [0, 2]], 0.05)
    cent = ttsdf.axis_centres(inside.dims, inside.origin, inside.voxel_size)
    c2w = np.eye(4)
    c2w[:2, 3] = [0.003, 0.013]
    c2w[2, 3] = float(np.nextafter(cent[2][5], np.float32(-np.inf)))
    cases.append(("inside", inside, depth, color, Ks, c2w))
    return cases


def _overflow_voxels(vol, K, R, t):
    """The voxels whose projection leaves the int range, in float32 steps
    in the host copy's order (numpy rounds each operation)."""
    f32 = np.float32
    wx, wy, wz = ttsdf.axis_centres(vol.dims, vol.origin, vol.voxel_size)
    wx, wy, wz = wx[:, None, None], wy[None, :, None], wz[None, None, :]
    k = np.asarray(K, f32).reshape(9)
    R = np.asarray(R, f32)
    t = np.asarray(t, f32)
    pz = ((R[6] * wx + R[7] * wy) + t[2]) + R[8] * wz
    px = ((R[0] * wx + R[1] * wy) + t[0]) + R[2] * wz
    py = ((R[3] * wx + R[4] * wy) + t[1]) + R[5] * wz
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        qu = (k[0] * px) / pz + k[2]
        qv = (k[4] * py) / pz + k[5]
    inside = (np.abs(qu) < f32(2 ** 31)) & (np.abs(qv) < f32(2 ** 31))
    return (pz > 0) & ~inside


@pytest.mark.parametrize("case", range(5))
def test_brick_culling_keeps_every_voxel_the_host_copy_touches(case):
    """The kernel's brick test (brick_keep_mask on cull_planes' numbers, with
    the far plane and without): no voxel that the host copy updates, or
    skips and counts because its projection leaves the int range, lies in a
    culled brick; the overflow voxels are the host copy's count. -s prints
    the share of bricks culled."""
    name, vol, depth, color, K, c2w = _camera_cases()[case]
    vol.integrate(color, depth, K, c2w)
    R, t = ttsdf.world_to_camera(c2w)
    touched = vol.weight.numpy().reshape(*vol.dims) > 0
    over = _overflow_voxels(vol, K, R, t)
    assert int(over.sum()) == vol.projection_overflows
    if name == "inside":
        assert vol.projection_overflows > 0
    if name == "away":
        assert not touched.any()
    touched |= over
    H, W = depth.shape
    for depth_max in (ttsdf.frame_depth_max(depth), None):
        cull = ttsdf.cull_planes(vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc,
                                 np.asarray(K, np.float32).reshape(9), R, t, H, W, depth_max)
        keep = ttsdf.brick_keep_mask(vol.dims, vol.origin, vol.voxel_size, cull)
        b = ttsdf.BRICK
        kv = keep.repeat(b, 0).repeat(b, 1).repeat(b, 2)[:vol.dims[0], :vol.dims[1], :vol.dims[2]]
        assert not (touched & ~kv).any(), int((touched & ~kv).sum())
        print(f"{name} (far plane {depth_max is not None}): {keep.size} bricks, "
              f"{100 * (1 - keep.mean()):.1f} % culled, {int(touched.sum())} voxels touched "
              f"({int(over.sum())} overflows)")
    if name == "away":
        assert not keep.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_cuda_culled_kernel_equals_host_copy(case):
    """Runs on a GPU only: the culled kernel's volume bit-equal to the host
    copy's and the same overflow count, one launch, on each camera."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    name, vol, depth, color, K, c2w = _camera_cases()[case]
    gpu = TSDFVolume.on_grid(vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc, "cuda")
    n0 = ttsdf.LAUNCHES.n
    gpu.integrate(color, depth, K, c2w)
    vol.integrate(color, depth, K, c2w)
    assert ttsdf.LAUNCHES.n - n0 == 1
    for k, v in vol.volume().items():
        assert torch.equal(gpu.volume()[k].cpu(), v), (name, k)
    assert gpu.projection_overflows == vol.projection_overflows
