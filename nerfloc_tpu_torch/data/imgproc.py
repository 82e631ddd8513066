"""Image resampling and colour conversion in numpy, with OpenCV's
arithmetic (the JAX package's transforms call OpenCV; the port has none).

  resize_area        cv2.resize INTER_AREA, uint8: the fractional-area
                     tables (computeResizeAreaTab) summed in float32 in
                     OpenCV's order, or the integer-ratio average
  resize_linear      cv2.resize INTER_LINEAR, uint8: 11-bit fixed-point
                     coefficients, the vertical pass rounded as OpenCV's
                     vector loop rounds it
  resize_nearest     cv2.resize INTER_NEAREST: floor(dst * (1 / (dst/src)))
  rotation_matrix    cv2.getRotationMatrix2D
  warp_affine        cv2.warpAffine INTER_NEAREST and INTER_CUBIC (uint8,
                     A = -0.75), constant-0 border, with float32 source
                     coordinates (one fused multiply-add) and cubic
                     weights, as OpenCV 4.11+ computes them; the cubic
                     sum's order is not OpenCV's, so about 0.04 % of its
                     values land one level apart
  rgb_to_hsv,        cv2.cvtColor RGB<->HSV for uint8 (H in [0, 180)); the
  hsv_to_rgb         way back rounds as OpenCV's vector and scalar loops do
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

COEF_BITS = 11                 # INTER_RESIZE_COEF_BITS
# cvtColor HSV->RGB for uint8: each row's first multiple of HSV_VEC_PIXELS
# pixels goes through OpenCV's vector loop (the result truncated), the rest
# through its scalar loop (rounded); both fuse their multiply-adds
HSV_VEC_PIXELS = 32


def _check_uint8(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.uint8:
        raise NotImplementedError(f"{what}: uint8 images only, got {img.dtype}")
    return img


def _area_tab(ssize: int, dsize: int, scale: float):
    """computeResizeAreaTab: (destination, source, weight) triples in
    OpenCV's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


@lru_cache(maxsize=16)
def _area_matrix(ssize: int, dsize: int, scale: float):
    """_area_tab as [dsize, n] source indices and weights, zero-padded at
    the end of each row (adding 0 leaves a float32 sum unchanged); cached
    per size pair, read-only."""
    tab = _area_tab(ssize, dsize, scale)
    counts = np.bincount([t[0] for t in tab], minlength=dsize)
    idx = np.zeros((dsize, int(counts.max())), np.int64)
    w = np.zeros(idx.shape, np.float32)
    fill = [0] * dsize
    for d, s, a in tab:
        idx[d, fill[d]], w[d, fill[d]] = s, a
        fill[d] += 1
    idx.flags.writeable = w.flags.writeable = False
    return idx, w


def resize_area(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA) for a uint8
    image [h, w] or [h, w, c] shrunk (h >= H, w >= W)."""
    _check_uint8(img, "resize_area")
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    inv_x, inv_y = W / w, H / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx < 1 or sy < 1:
        raise NotImplementedError("resize_area: enlarging is not supported")
    isx, isy = int(round(sx)), int(round(sy))
    if abs(sx - isx) < np.finfo(np.float64).eps and abs(sy - isy) < np.finfo(np.float64).eps:
        return _resize_area_int(img, W, H, isx, isy)
    x = img.astype(np.float32).reshape(h, w, -1)
    ix, wx = _area_matrix(w, W, sx)
    iy, wy = _area_matrix(h, H, sy)
    rows = np.zeros((h, W, x.shape[2]), np.float32)
    for k in range(ix.shape[1]):
        rows = rows + x[:, ix[:, k]] * wx[None, :, k, None]
    out = wy[:, 0, None, None] * rows[iy[:, 0]]
    for k in range(1, iy.shape[1]):
        out = out + wy[:, k, None, None] * rows[iy[:, k]]
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((H, W) + img.shape[2:])


def _resize_area_int(img: np.ndarray, W: int, H: int, kx: int, ky: int) -> np.ndarray:
    """OpenCV's integer-ratio area resize (resizeAreaFast): the kx x ky
    block sums, (s + 2) >> 2 at ratio 2, else rounded s / (kx ky)."""
    h, w = img.shape[:2]
    if W * kx != w or H * ky != h:
        raise NotImplementedError("resize_area: an integer ratio with a partial edge cell")
    blocks = img.astype(np.int64).reshape((H, ky, W, kx) + img.shape[2:])
    s = blocks.sum(axis=(1, 3))
    if kx == ky == 2 and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
        return ((s + 2) >> 2).astype(np.uint8)
    return np.clip(np.rint(s.astype(np.float32) * np.float32(1.0 / (kx * ky))), 0,
                   255).astype(np.uint8)


def _linear_coefs(ssize: int, dsize: int, clamp: bool):
    """Source index and fixed-point weights (x0, x1) of each destination
    position of INTER_LINEAR; `clamp`: the horizontal pass's edge rule
    (weight 0 past either edge; the vertical pass clips its rows
    instead)."""
    scale = 1.0 / (dsize / ssize)
    d = np.arange(dsize, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        left = s < 0
        f[left], s[left] = 0, 0
        right = s >= ssize - 1
        f[right], s[right] = 0, ssize - 1
    one = np.float32(1 << COEF_BITS)
    a0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    a1 = np.rint(f * one).astype(np.int64)
    return s, a0, a1


def resize_linear(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR) for uint8."""
    _check_uint8(img, "resize_linear")
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    if (w == 2 * W and h == 2 * H):
        return _resize_area_int(img, W, H, 2, 2)  # OpenCV takes the area path here
    x = img.astype(np.int64).reshape(h, w, -1)
    sx, ax0, ax1 = _linear_coefs(w, W, clamp=True)
    sx1 = np.minimum(sx + 1, w - 1)
    rows = x[:, sx] * ax0[None, :, None] + x[:, sx1] * ax1[None, :, None]
    sy, by0, by1 = _linear_coefs(h, H, clamp=False)
    r0 = rows[np.clip(sy, 0, h - 1)].reshape(H, -1)
    r1 = rows[np.clip(sy + 1, 0, h - 1)].reshape(H, -1)
    b0, b1 = by0[:, None], by1[:, None]
    # OpenCV's vector loop (VResizeLinearVec_32s8u), which covers every
    # column: (((s >> 4) saturated to int16) * b) >> 16 per row, summed,
    # then (x + 2) >> 2
    t0 = np.clip(r0 >> 4, -32768, 32767)
    t1 = np.clip(r1 >> 4, -32768, 32767)
    out = (((t0 * b0) >> 16) + ((t1 * b1) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((H, W) + img.shape[2:])


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST), any
    dtype."""
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    ifx, ify = 1.0 / (W / w), 1.0 / (H / h)
    ix = np.minimum(np.floor(np.arange(W) * ifx).astype(np.int64), w - 1)
    iy = np.minimum(np.floor(np.arange(H) * ify).astype(np.int64), h - 1)
    return img[iy][:, ix]


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D (center as float32, as OpenCV's Point2f)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _cubic_coefs(x: np.ndarray):
    """interpolateCubic (A = -0.75) in float32, for fractions x."""
    f32 = np.float32
    A, one = f32(-0.75), f32(1)
    c0 = ((A * (x + one) - f32(5) * A) * (x + one) + f32(8) * A) * (x + one) - f32(4) * A
    c1 = ((A + f32(2)) * x - (A + f32(3))) * x * x + one
    c2 = ((A + f32(2)) * (one - x) - (A + f32(3))) * (one - x) * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


def _invert_affine(M: np.ndarray) -> np.ndarray:
    M = np.asarray(M, np.float64).reshape(-1).copy()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    A11, A22 = M[4] * D, M[0] * D
    M[0] = A11
    M[1] *= -D
    M[3] *= -D
    M[4] = A22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return M


def _source_coords(M: np.ndarray, W: int, H: int):
    """float32 source coordinates (X, Y) [H, W] of each destination pixel
    under the affine map M (destination -> source), as OpenCV's warp
    computes them: m0 x fused into (m1 y + m2)."""
    f32 = np.float32
    m = _invert_affine(M).astype(f32)
    xs = np.arange(W, dtype=np.float64)[None, :]
    ys = np.arange(H, dtype=f32)[:, None]
    X = (np.float64(m[0]) * xs + (m[1] * ys + m[2]).astype(np.float64)).astype(f32)
    Y = (np.float64(m[3]) * xs + (m[4] * ys + m[5]).astype(np.float64)).astype(f32)
    return X, Y


def warp_affine(img: np.ndarray, M: np.ndarray, W: int, H: int, cubic: bool) -> np.ndarray:
    """cv2.warpAffine(img, M, (W, H), flags=INTER_CUBIC if cubic else
    INTER_NEAREST) with the default constant-0 border."""
    h, w = img.shape[:2]
    X, Y = _source_coords(M, W, H)
    if not cubic:
        X, Y = np.rint(X).astype(np.int64), np.rint(Y).astype(np.int64)
        inside = (X >= 0) & (X < w) & (Y >= 0) & (Y < h)
        out = img[np.clip(Y, 0, h - 1), np.clip(X, 0, w - 1)]
        out[~inside] = 0
        return out
    # cubic weights in float32; each row's taps summed along x, then the
    # rows along y
    _check_uint8(img, "warp_affine (cubic)")
    f32 = np.float32
    ix, iy = np.floor(X), np.floor(Y)
    wx, wy = _cubic_coefs(X - ix), _cubic_coefs(Y - iy)
    ix, iy = ix.astype(np.int64) - 1, iy.astype(np.int64) - 1
    src = img.astype(f32).reshape(h, w, -1)
    out = None
    for i in range(4):
        yy = iy + i
        row = None
        for j in range(4):
            xx = ix + j
            ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            tap = np.where(ok[..., None], src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                           f32(0)) * wx[j][..., None]
            row = tap if row is None else row + tap
        row = row * wy[i][..., None]
        out = row if out is None else out + row
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape((H, W) + img.shape[2:])


_HSV_SHIFT = 12


@lru_cache(maxsize=1)
def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV) for uint8 RGB."""
    _check_uint8(img, "rgb_to_hsv")
    sdiv, hdiv = _hsv_tables()
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    s = (diff * sdiv[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_HSV2RGB) for uint8 HSV (H in [0, 180))."""
    _check_uint8(img, "hsv_to_rgb")
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    one = f32(1)
    # 1 - s h and 1 - s (1 - h) with one rounding (a fused multiply-add;
    # the product is exact in f64)
    t2, t3 = ((1.0 - s.astype(np.float64) * t.astype(np.float64)).astype(f32)
              for t in (h, one - h))
    vec = np.zeros(img.shape[:-1], bool)
    n_vec = img.shape[-2] // HSV_VEC_PIXELS * HSV_VEC_PIXELS
    vec[..., :n_vec] = True
    tab = np.stack([v, v * (one - s), v * t2, v * t3])
    sel = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = [np.take_along_axis(tab, sel[sector, k][None], axis=0)[0] for k in range(3)]
    rgb = np.stack([bgr[2], bgr[1], bgr[0]], axis=-1) * f32(255.0)
    rgb = np.where(vec[..., None], np.floor(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)
