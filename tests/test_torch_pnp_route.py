"""RANSAC PnP's routes (solve/pnp.py): the torch route, split around its
Kabsch SVD into `_ransac_front` and `_ransac_back`, which CPU tensors run op
by op, and its replay from two CUDA graphs, which CUDA tensors take.

The cases are seeded match sets at two sizes (N=1024 matches with 512
hypotheses, the query's, and N=37 with 64), with the Gumbel noise handed
in: all inliers, 30 % and 70 % outliers, fewer than 3 valid matches, all
masked, a third of the points on one line, a fifth of them behind the
camera, and wider pixel noise (6 px).

On the CPU the route is held bit for bit against `_one_pass`, the same
arithmetic written as one function with the chosen candidate read as a
host index and the constants copied to the device at each call. The
cuda-marked tests run on a card and skip without one: the graphed route
equals the torch route run op by op on the card, bit for bit, and syncs
only inside torch.linalg.svd. The file imports no JAX, so they run on the
card with `python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_pnp_route.py`.
"""
import inspect
import warnings

import numpy as np
import pytest
import torch

from nerfloc_tpu_torch.geometry.se3 import se3_exp_map
from nerfloc_tpu_torch.ops.knn import topk_first
from nerfloc_tpu_torch.solve import pnp

CASES = ("all_inliers", "outliers_30", "outliers_70", "few_valid", "all_masked",
         "collinear", "behind", "wide_noise")
SIZES = ((1024, 512), (37, 64))


def _problem(case: str, N: int, H: int):
    """(pts2d, pts3d, mask, K, gumbel) CPU tensors of a seeded match set,
    and its true camera-to-world pose (float64 numpy)."""
    r = np.random.default_rng([CASES.index(case), N])
    K = np.array([[280.0, 0, 176.0], [0, 281.0, 128.0], [0, 0, 1]])
    pc = np.stack([r.uniform(-1.5, 1.5, N), r.uniform(-1.2, 1.2, N), r.uniform(1.5, 5.0, N)], -1)
    if case == "collinear":
        on = r.uniform(size=N) < 1 / 3
        pc[on] = [0.2, -0.1, 3.0] + r.uniform(-1, 1, (on.sum(), 1)) * [0.6, 0.3, 0.8]
    noise = 6.0 if case == "wide_noise" else 0.5
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + K[:2, 2] + r.normal(0, noise, (N, 2))
    outliers = {"outliers_30": 0.3, "outliers_70": 0.7}.get(case, 0.0)
    bad = r.uniform(size=N) < outliers
    uv[bad] = r.uniform(0, 352, (bad.sum(), 2))
    if case == "behind":
        pc[r.uniform(size=N) < 0.2, 2] *= -1.0
    c2w = se3_exp_map(torch.tensor(r.normal(0, 0.5, 6), dtype=torch.float32)).double().numpy()
    pw = pc @ c2w[:3, :3].T + c2w[:3, 3]
    mask = r.uniform(size=N) > 0.1
    if case == "few_valid":
        mask[:] = False
        mask[r.choice(N, 2, replace=False)] = True
    if case == "all_masked":
        mask[:] = False
    u = np.maximum(r.uniform(size=(H, N)), np.finfo(np.float32).tiny).astype(np.float32)
    gumbel = -np.log(-np.log(u))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return f32(uv), f32(pw), torch.as_tensor(mask), f32(K), f32(gumbel), c2w


def _one_pass(pts2d, pts3d, mask, K, gumbel, thresh_px=8.0, refine_iters=10):
    """The torch route's arithmetic as one function: Kabsch whole, NaN
    candidates masked inside P3P, the best candidate read as a host index."""
    dtype, dev = pts3d.dtype, pts3d.device
    f = (K[0, 0] + K[1, 1]) / 2.0
    x_norm = torch.stack([(pts2d[:, 0] - K[0, 2]) / K[0, 0],
                          (pts2d[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
    thresh2 = (thresh_px / f) ** 2
    X_n, centroid, scale = pnp._normalize_pts3d(pts3d, mask)
    logits = torch.where(mask, torch.zeros_like(x_norm[:, 0]),
                         torch.full_like(x_norm[:, 0], float("-inf")))
    idx = topk_first(gumbel + logits[None, :], 3)[1]
    Pw = X_n[idx][:, None].expand(-1, 4, -1, -1)
    Pc, ok = pnp._p3p_depths(X_n[idx], x_norm[idx])
    cw, ccm = Pw.mean(dim=-2), Pc.mean(dim=-2)
    U, Vt = pnp._svd3((Pw - cw[..., None, :]).transpose(-1, -2) @ (Pc - ccm[..., None, :]))
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    sgn = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1))
    R = V @ D @ Ut
    Rt_n = torch.cat([R, (ccm - (R @ cw[..., None])[..., 0])[..., None]], dim=-1)
    Rt_n = torch.where(ok[..., None, None], Rt_n, torch.full_like(Rt_n, float("nan")))
    R = Rt_n[..., :3]
    t = Rt_n[..., 3] * scale - (R @ centroid[:, None])[..., 0]
    hyps = torch.cat([R, t[..., None]], dim=-1).reshape(-1, 3, 4)
    errs = pnp._reproj_err2(hyps, pts3d, x_norm)
    valid_err = torch.where(mask[None, :], errs, torch.full_like(errs, float("inf")))
    counts = torch.sum(valid_err < thresh2, dim=-1)
    finite_h = torch.isfinite(hyps.reshape(hyps.shape[0], -1)).all(dim=-1)
    best = int(torch.argmax(torch.where(finite_h, counts, torch.full_like(counts, -1))))
    eye34 = torch.eye(3, 4, dtype=dtype, device=dev)
    best_h = torch.where(finite_h[best], hyps[best], eye34)
    w0 = (valid_err[best] < thresh2).to(dtype)
    refined = pnp._gauss_newton(best_h, pts3d, x_norm, w0, refine_iters)
    inf1 = torch.full_like(w0, float("inf"))
    err_r = torch.where(mask, pnp._reproj_err2(refined, pts3d, x_norm), inf1)
    refined2 = pnp._gauss_newton(refined, pts3d, x_norm, (err_r < thresh2).to(dtype),
                                 refine_iters // 2 + 1)
    err_f = torch.where(mask, pnp._reproj_err2(refined2, pts3d, x_norm), inf1)
    use_ref = torch.sum(err_f < thresh2) >= counts[best]
    final34 = torch.where(use_ref, refined2, best_h)
    final_err = torch.where(use_ref, err_f, valid_err[best])
    finite = torch.isfinite(final34).all()
    final34 = torch.where(finite, final34, eye34)
    inliers = torch.where(finite, final_err, inf1) < thresh2
    num_inliers = torch.sum(inliers).to(torch.int32)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=dev)
    Rf = final34[:, :3]
    c2w = torch.cat([torch.cat([Rf.T, (-Rf.T @ final34[:, 3])[:, None]], dim=-1), bottom])
    return pnp.PnPResult(c2w=c2w, w2c=torch.cat([final34, bottom]), inliers=inliers,
                         num_inliers=num_inliers, success=num_inliers >= 6)


@pytest.mark.parametrize("size", SIZES, ids=("n1024", "n37"))
@pytest.mark.parametrize("case", CASES)
def test_split_route_is_one_pass_to_the_bit(case, size):
    """ransac_pnp on CPU tensors (front, SVD, back) returns what the one-pass
    arithmetic returns, bit for bit, and a finite pose."""
    *args, _ = _problem(case, *size)
    got = pnp.ransac_pnp(*args[:4], gumbel=args[4])
    want = _one_pass(*args)
    for name, x, y in zip(pnp.PnPResult._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert torch.isfinite(got.c2w).all()


@pytest.mark.parametrize("size", SIZES, ids=("n1024", "n37"))
def test_route_recovers_the_pose(size):
    """With every match an inlier at 0.5 px of noise, the pose is the true
    one to 1e-2 in rotation and translation, and the masked matches it
    keeps as inliers are most of them."""
    pts2d, pts3d, mask, K, gumbel, c2w = _problem("all_inliers", *size)
    got = pnp.ransac_pnp(pts2d, pts3d, mask, K, gumbel=gumbel)
    assert bool(got.success)
    assert np.abs(got.c2w.double().numpy()[:3] - c2w[:3]).max() < 1e-2
    assert int(got.num_inliers) >= 0.9 * int(mask.sum())
    assert not bool((got.inliers & ~mask).any())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_route_syncs_only_in_the_svd():
    """ransac_pnp on CUDA tensors, with the noise handed in and drawn from a
    generator: the host waits for the card only inside _svd3, where
    torch.linalg.svd reads its error flags."""
    dev = _cuda()
    pts2d, pts3d, mask, K, gumbel = (a.to(dev) for a in _problem("outliers_30", 1024, 512)[:5])
    gen = torch.Generator(device=dev).manual_seed(0)
    pnp.ransac_pnp(pts2d, pts3d, mask, K, gumbel=gumbel)     # captures the graphs
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pnp.ransac_pnp(pts2d, pts3d, mask, K, gumbel=gumbel)
            pnp.ransac_pnp(pts2d, pts3d, mask, K, n_hyps=512, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    svd_line = inspect.getsource(pnp._svd3).splitlines().index(
        "    U, S, Vt = torch.linalg.svd(torch.where(ok[..., None, None], H, torch.zeros_like(H)))")
    want = inspect.getsourcelines(pnp._svd3)[1] + svd_line
    sites = {(w.filename, w.lineno) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)}
    assert sites == {(pnp.__file__, want)}, sites


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=("n1024", "n37"))
@pytest.mark.parametrize("case", CASES)
def test_graphed_route_is_the_torch_route_to_the_bit(case, size):
    """ransac_pnp on CUDA tensors (the torch route replayed from its CUDA
    graphs, captured at the first case of each size) returns what the torch
    route returns op by op on the card, bit for bit, call after call."""
    dev = _cuda()
    args = [a.to(dev) for a in _problem(case, *size)[:5]]
    want = pnp.torch_route(*args)
    for _ in range(2):
        got = pnp.ransac_pnp(*args[:4], gumbel=args[4])
        assert all(torch.equal(x, y) for x, y in zip(got, want))
