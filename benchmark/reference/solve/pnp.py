"""On-device P3P-RANSAC with Gauss-Newton polish, always in f32
(counterpart of nerfloc_tpu/solve/pnp.py, `minimal='p3p'`, and
`count_pose_inliers`).

All hypotheses are solved at once as batched tensors; no step reads a
value back to the host. Degenerate samples produce NaN poses that score no
inliers, and a failed solve returns the identity (finite) pose.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.se3 import hat, so3_exp_map
from ..ops.knn import topk_first

Tensor = torch.Tensor

_P3P_NODES = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], dtype=np.float32)
_VAND_INV = np.linalg.inv(np.vander(np.array([-2.0, -1.0, 0.0, 1.0, 2.0]), 5,
                                    increasing=True)).astype(np.float32)


class PnPResult(NamedTuple):
    c2w: Tensor          # [4, 4]
    w2c: Tensor          # [4, 4]
    inliers: Tensor      # [N] bool
    num_inliers: Tensor  # 0-d int32
    success: Tensor      # 0-d bool (>= 6 inliers)


def _normalize_pts3d(pts3d: Tensor, mask: Tensor):
    w = mask.to(pts3d.dtype)[:, None]
    centroid = torch.sum(pts3d * w, dim=0) / torch.clamp(w.sum(), min=1.0)
    d = torch.linalg.vector_norm(pts3d - centroid, dim=-1)
    scale = torch.sum(d * w[:, 0]) / torch.clamp(w.sum(), min=1.0)
    scale = torch.clamp(scale, min=1e-6)
    return (pts3d - centroid) / scale, centroid, scale


def _cubic_max_real_root(a2: Tensor, a1: Tensor, a0: Tensor) -> Tensor:
    """Largest real root of m^3 + a2 m^2 + a1 m + a0 (real arithmetic)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2 ** 3 / 27.0 - a2 * a1 / 3.0 + a0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    pn = torch.clamp(p, max=-1e-12)
    rp = torch.sqrt(-pn / 3.0)
    cos_arg = torch.clamp(3.0 * q / (2.0 * pn) * torch.sqrt(-3.0 / pn), -1.0, 1.0)
    t_trig = 2.0 * rp * torch.cos(torch.arccos(cos_arg) / 3.0)
    ch_arg = torch.clamp(-3.0 * torch.abs(q) / (2.0 * pn) * torch.sqrt(-3.0 / pn), min=1.0)
    t_cosh = -2.0 * torch.sign(q) * rp * torch.cosh(torch.arccosh(ch_arg) / 3.0)
    pp = torch.clamp(p, min=1e-12)
    sh_arg = 3.0 * q / (2.0 * pp) * torch.sqrt(3.0 / pp)
    t_sinh = -2.0 * torch.sqrt(pp / 3.0) * torch.sinh(torch.arcsinh(sh_arg) / 3.0)
    t_one = torch.where(p > 0.0, t_sinh, t_cosh)
    t_tiny = torch.sign(-q) * torch.abs(q) ** (1.0 / 3.0)      # cbrt(-q)
    t = torch.where(disc <= 0.0, t_trig, t_one)
    t = torch.where(torch.abs(p) < 1e-10, t_tiny, t)
    return t - a2 / 3.0


def _quartic_roots(c: Tensor) -> Tensor:
    """Real roots of c[...,4] x^4 + ... + c[...,0] -> [..., 4] (complex-pair
    slots NaN): Ferrari via the largest resolvent root, 2 Newton steps."""
    c0, c1, c2, c3, c4 = c.unbind(-1)
    c4s = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    b, cc, d, e = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    p = cc - 3.0 * b * b / 8.0
    q = d - b * cc / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * cc / 16.0 - 3.0 * b ** 4 / 256.0
    m = _cubic_max_real_root(p, p * p / 4.0 - r, -q * q / 8.0)
    s = torch.sqrt(torch.clamp(2.0 * m, min=0.0))
    qs = q / (2.0 * torch.clamp(s, min=1e-9))
    sq1 = torch.sqrt(s * s - 4.0 * (p / 2.0 + m + qs))
    sq2 = torch.sqrt(s * s - 4.0 * (p / 2.0 + m - qs))
    y_gen = torch.stack([(s + sq1) / 2.0, (s - sq1) / 2.0,
                         (-s + sq2) / 2.0, (-s - sq2) / 2.0], dim=-1)
    db = torch.sqrt(p * p - 4.0 * r)
    z1 = torch.sqrt((-p + db) / 2.0)
    z2 = torch.sqrt((-p - db) / 2.0)
    y_biq = torch.stack([z1, -z1, z2, -z2], dim=-1)
    x = torch.where((torch.abs(q) < 1e-9)[..., None], y_biq, y_gen) - (b / 4.0)[..., None]
    c = c[..., None, :]
    for _ in range(2):
        f = (((c[..., 4] * x + c[..., 3]) * x + c[..., 2]) * x + c[..., 1]) * x + c[..., 0]
        fp = ((4.0 * c[..., 4] * x + 3.0 * c[..., 3]) * x + 2.0 * c[..., 2]) * x + c[..., 1]
        fp = torch.where(torch.abs(fp) < 1e-12, torch.full_like(fp, 1e-12), fp)
        x = x - f / fp
    return x


def _svd3(H: Tensor):
    """Batched 3x3 SVD that tolerates non-finite inputs (their outputs are
    NaN, as jnp.linalg.svd gives)."""
    ok = torch.isfinite(H).all(dim=(-2, -1))
    U, S, Vt = torch.linalg.svd(torch.where(ok[..., None, None], H, torch.zeros_like(H)))
    nan = torch.full_like(U, float("nan"))
    return (torch.where(ok[..., None, None], U, nan),
            torch.where(ok[..., None, None], Vt, nan))


def _kabsch_w2c(Pw: Tensor, Pc: Tensor) -> Tensor:
    """Rigid [R|t] [..., 3, 4] with Pc ~= R Pw + t from 3 correspondences."""
    cw = Pw.mean(dim=-2)
    ccm = Pc.mean(dim=-2)
    H = (Pw - cw[..., None, :]).transpose(-1, -2) @ (Pc - ccm[..., None, :])
    U, Vt = _svd3(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    sgn = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1))
    R = V @ D @ Ut
    t = ccm - (R @ cw[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def _p3p_w2c(Pw: Tensor, xn: Tensor) -> Tensor:
    """Grunert P3P for [B] samples: Pw [B,3,3] world, xn [B,3,2] normalized
    image coords -> [B, 4, 3, 4] w2c candidates (NaN where invalid)."""
    f = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    a2 = torch.sum((Pw[:, 1] - Pw[:, 2]) ** 2, dim=-1)
    b2 = torch.clamp(torch.sum((Pw[:, 0] - Pw[:, 2]) ** 2, dim=-1), min=1e-12)
    c2 = torch.sum((Pw[:, 0] - Pw[:, 1]) ** 2, dim=-1)
    ca = torch.sum(f[:, 1] * f[:, 2], dim=-1)
    cb = torch.sum(f[:, 0] * f[:, 2], dim=-1)
    cg = torch.sum(f[:, 0] * f[:, 1], dim=-1)
    A, B = a2 / b2, c2 / b2
    col = lambda x: x[:, None]  # noqa: E731

    def num(v):
        return 1.0 - v * v + col(A - B) * (1.0 + v * v - 2.0 * v * col(cb))

    def den(v):
        return 2.0 * (col(cg) - v * col(ca))

    def Fv(v):
        n, dd = num(v), den(v)
        return (n * n - 2.0 * col(cg) * n * dd
                + (1.0 - col(B) * (1.0 + v * v - 2.0 * v * col(cb))) * dd * dd)

    nodes = torch.as_tensor(_P3P_NODES, device=Pw.device)[None, :]
    coeffs = Fv(nodes) @ torch.as_tensor(_VAND_INV, device=Pw.device).T   # [B, 5]
    v = _quartic_roots(coeffs)                                             # [B, 4]
    dv = den(v)
    u = num(v) / torch.where(torch.abs(dv) < 1e-12, torch.full_like(dv, 1e-12), dv)
    s1 = torch.sqrt(col(b2)) / torch.sqrt(torch.clamp(1.0 + v * v - 2.0 * v * col(cb),
                                                      min=1e-12))
    s2, s3 = u * s1, v * s1
    ok = (torch.isfinite(v) & (v > 1e-6) & (u > 1e-6)
          & torch.isfinite(s1) & (s1 > 1e-6))
    one = torch.ones_like(s1)
    s1, s2, s3 = (torch.where(ok, s, one) for s in (s1, s2, s3))
    ca, cb, cg = col(ca), col(cb), col(cg)
    a2, b2, c2 = col(a2), col(b2), col(c2)
    for _ in range(3):
        r = torch.stack([s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * ca - a2,
                         s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cb - b2,
                         s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cg - c2], dim=-1)
        z = torch.zeros_like(s1)
        J = torch.stack([
            torch.stack([z, 2 * s2 - 2 * s3 * ca, 2 * s3 - 2 * s2 * ca], -1),
            torch.stack([2 * s1 - 2 * s3 * cb, z, 2 * s3 - 2 * s1 * cb], -1),
            torch.stack([2 * s1 - 2 * s2 * cg, 2 * s2 - 2 * s1 * cg, z], -1),
        ], dim=-2)                                                          # [B,4,3,3]
        ds = torch.linalg.solve_ex(J, r[..., None])[0][..., 0]
        good = torch.isfinite(ds).all(dim=-1)
        s1 = torch.where(good, s1 - ds[..., 0], s1)
        s2 = torch.where(good, s2 - ds[..., 1], s2)
        s3 = torch.where(good, s3 - ds[..., 2], s3)
    Pc = torch.stack([s1[..., None] * f[:, None, 0], s2[..., None] * f[:, None, 1],
                      s3[..., None] * f[:, None, 2]], dim=-2)              # [B,4,3,3]
    Rt = _kabsch_w2c(Pw[:, None].expand(-1, 4, -1, -1), Pc)
    return torch.where(ok[..., None, None], Rt, torch.full_like(Rt, float("nan")))


def _reproj_err2(w2c34: Tensor, pts3d: Tensor, x_norm: Tensor) -> Tensor:
    """Squared normalized reprojection error [..., N]; inf behind camera."""
    p = pts3d @ w2c34[..., :, :3].transpose(-1, -2) + w2c34[..., None, :, 3]
    z = p[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    err = torch.sum((p[..., :2] / safe_z[..., None] - x_norm) ** 2, dim=-1)
    inf = torch.full_like(err, float("inf"))
    err = torch.where(z > 1e-6, err, inf)
    return torch.where(torch.isfinite(err), err, inf)


def _gauss_newton(Rt: Tensor, pts3d: Tensor, x_norm: Tensor, weights: Tensor,
                  iters: int, damping: float = 1e-6) -> Tensor:
    """Levenberg-damped Gauss-Newton on se(3), left-multiplied increments."""
    eye3 = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    eye6 = torch.eye(6, dtype=Rt.dtype, device=Rt.device)
    for _ in range(iters):
        p = pts3d @ Rt[:, :3].T + Rt[:, 3]
        z = torch.where(torch.abs(p[:, 2]) < 1e-8, torch.full_like(p[:, 2], 1e-8), p[:, 2])
        u, v = p[:, 0] / z, p[:, 1] / z
        r = torch.stack([u - x_norm[:, 0], v - x_norm[:, 1]], dim=-1)
        w = weights * (p[:, 2] > 1e-6)
        iz = 1.0 / z
        zero = torch.zeros_like(iz)
        Jp = torch.stack([torch.stack([iz, zero, -u * iz], -1),
                          torch.stack([zero, iz, -v * iz], -1)], dim=-2)    # [N,2,3]
        dpdxi = torch.cat([eye3.expand(p.shape[0], 3, 3), -hat(p)], dim=-1)
        J = Jp @ dpdxi                                                       # [N,2,6]
        Jw = J * w[:, None, None]
        JtJ = torch.einsum("nij,nik->jk", Jw, J) + damping * eye6
        Jtr = torch.einsum("nij,ni->j", Jw, r)
        xi = -torch.linalg.solve_ex(JtJ, Jtr[:, None])[0][:, 0]
        Rd = so3_exp_map(xi[3:])
        new = torch.cat([Rd @ Rt[:, :3], (Rd @ Rt[:, 3] + xi[:3])[:, None]], dim=-1)
        Rt = torch.where(torch.isfinite(new).all(), new, Rt)
    return Rt


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> Tensor:
    """Standard Gumbel noise -log(-log(U)), U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def ransac_pnp(pts2d: Tensor, pts3d: Tensor, mask: Tensor, K: Tensor,
               thresh_px: float = 8.0, n_hyps: int = 512,
               refine_iters: int = 10, gumbel: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> PnPResult:
    """RANSAC over P3P minimal sets + Gauss-Newton absolute pose.

    pts2d [N,2] pixels; pts3d [N,3] world; mask [N] valid matches; K [3,3].
    gumbel: optional [n_hyps, N] Gumbel noise that picks the minimal sets
    (drawn from `generator` when None)."""
    N = pts2d.shape[0]
    dtype, dev = pts3d.dtype, pts3d.device
    f = (K[0, 0] + K[1, 1]) / 2.0
    x_norm = torch.stack([(pts2d[:, 0] - K[0, 2]) / K[0, 0],
                          (pts2d[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
    thresh2 = (thresh_px / f) ** 2
    X_n, centroid, scale = _normalize_pts3d(pts3d, mask)

    if gumbel is None:
        gumbel = gumbel_noise((n_hyps, N), generator, dev)
    logits = torch.where(mask, torch.zeros_like(x_norm[:, 0]),
                         torch.full_like(x_norm[:, 0], float("-inf")))
    sample_idx = topk_first(gumbel + logits[None, :], 3)[1]               # [H, 3]

    Rt_n = _p3p_w2c(X_n[sample_idx], x_norm[sample_idx])                  # [H,4,3,4]
    R = Rt_n[..., :3]
    t = Rt_n[..., 3] * scale - (R @ centroid[:, None])[..., 0]
    hyps = torch.cat([R, t[..., None]], dim=-1).reshape(-1, 3, 4)         # [4H,3,4]

    errs = _reproj_err2(hyps, pts3d, x_norm)                              # [4H, N]
    inf = torch.full_like(errs, float("inf"))
    valid_err = torch.where(mask[None, :], errs, inf)
    inlier_counts = torch.sum(valid_err < thresh2, dim=-1)
    hyp_finite = torch.isfinite(hyps.reshape(hyps.shape[0], -1)).all(dim=-1)
    best = torch.argmax(torch.where(hyp_finite, inlier_counts,
                                    torch.full_like(inlier_counts, -1)))
    eye34 = torch.eye(3, 4, dtype=dtype, device=dev)
    best_h = torch.where(hyp_finite[best], hyps[best], eye34)

    w0 = (valid_err[best] < thresh2).to(dtype)
    refined = _gauss_newton(best_h, pts3d, x_norm, w0, refine_iters)
    inf1 = torch.full_like(w0, float("inf"))
    err_r = torch.where(mask, _reproj_err2(refined, pts3d, x_norm), inf1)
    refined2 = _gauss_newton(refined, pts3d, x_norm, (err_r < thresh2).to(dtype),
                             refine_iters // 2 + 1)
    err_f = torch.where(mask, _reproj_err2(refined2, pts3d, x_norm), inf1)

    use_ref = torch.sum(err_f < thresh2) >= inlier_counts[best]
    final34 = torch.where(use_ref, refined2, best_h)
    final_err = torch.where(use_ref, err_f, valid_err[best])
    finite = torch.isfinite(final34).all()
    final34 = torch.where(finite, final34, eye34)
    final_err = torch.where(finite, final_err, inf1)

    inliers = final_err < thresh2
    num_inliers = torch.sum(inliers).to(torch.int32)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=dev)
    Rf = final34[:, :3]
    c2w = torch.cat([torch.cat([Rf.T, (-Rf.T @ final34[:, 3])[:, None]], dim=-1),
                     bottom], dim=0)
    return PnPResult(c2w=c2w, w2c=torch.cat([final34, bottom], dim=0),
                     inliers=inliers, num_inliers=num_inliers,
                     success=num_inliers >= 6)


def count_pose_inliers(c2w: Tensor, pts2d: Tensor, pts3d: Tensor, mask: Tensor,
                       K: Tensor, thresh_px: float = 8.0) -> Tensor:
    """0-d int32: the matches of mask [N] that a given c2w [4, 4] explains,
    by ransac_pnp's normalized reprojection error and threshold, so that two
    candidate poses can be scored on the same match set."""
    R, t = c2w[:3, :3], c2w[:3, 3]
    w2c34 = torch.cat([R.T, (-R.T @ t)[:, None]], dim=-1)
    f = (K[0, 0] + K[1, 1]) / 2.0
    x_norm = torch.stack([(pts2d[:, 0] - K[0, 2]) / K[0, 0],
                          (pts2d[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
    err = _reproj_err2(w2c34, pts3d.to(x_norm.dtype), x_norm)
    return torch.sum((err < (thresh_px / f) ** 2) & mask).to(torch.int32)
