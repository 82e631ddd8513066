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
  fill_poly          cv2.fillPoly of one polygon, 8-connected, shift 0, as
                     OpenCV 5 scan-converts it (concave polygons that cross
                     the image border excepted)
  line               cv2.line at the default line type, any thickness
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


# -- rasterizers (OpenCV's drawing.cpp at the default 8-connected line type) ----------

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, p1, p2):
    """cv::clipLine on an image of w x h: (inside, p1, p2), the ends moved
    as OpenCV moves them (also where it then finds no part inside).
    Integer coordinates (any scale)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_points(w: int, h: int, p1, p2) -> np.ndarray:
    """cv::LineIterator(img, p1, p2, 8, leftToRight=true): the pixels of an
    8-connected integer line, clipped to the image; [n, 2] (x, y)."""
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return np.zeros((0, 2), np.int64)
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    n = major + 1
    # a step along the minor axis wherever err < 0 before the update: err
    # starts at major - 2 minor and moves by 2 major - 2 minor after such a
    # step, by -2 minor after another
    steps = np.zeros(n, np.int64)
    e, m = major - 2 * minor, 0
    for i in range(n - 1):
        if e < 0:
            m += 1
            e += 2 * major - 2 * minor
        else:
            e -= 2 * minor
        steps[i + 1] = m
    t = np.arange(n)
    if vert:
        xs, ys = x1 + steps, y1 + sy * t
    else:
        xs, ys = x1 + t, y1 + sy * steps
    return np.stack([xs, ys], 1)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _fill_convex_poly(img: np.ndarray, v, color) -> None:
    """cv::FillConvexPoly (drawing.cpp) at the 8-connected line type; v:
    [n, 2] int vertices in XY_SHIFT fixed point (as ThickLine gives it)."""
    H, W = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        p = v[i]
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, max(xx1, 0), min(xx2, W - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """cv::Line2: a line between XY_SHIFT fixed-point ends."""
    H, W = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(W << XY_SHIFT, H << XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    pts = []
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts.append(((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT))
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            pts.append((x1, y1 >> XY_SHIFT))
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            pts.append((x1 >> XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
            ecount -= 1
    for x, y in pts:
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """cv::Circle with fill, as ThickLine rounds a line's ends."""
    H, W = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < W - radius and radius <= cy < H - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, a, b in ((y11, x11, x12), (y12, x11, x12), (y21, x21, x22), (y22, x21, x22)):
                _hline(img, yy, a, b, color)
        elif x11 < W and x12 >= 0 and y21 < H and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, W - 1)
            for yy in (y11, y12):
                if 0 <= yy < H:
                    _hline(img, yy, x11, x12, color)
            if x21 < W and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, W - 1)
                for yy in (y21, y22):
                    if 0 <= yy < H:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p, q, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p, q, color, thickness) in place, at the default
    8-connected line type, shift 0: thickness 1 is the 8-connected line
    (LineIterator), a thicker one a filled quadrilateral in 16-bit fixed
    point (FillConvexPoly) with a filled circle at each end (ThickLine)."""
    p = (int(p[0]), int(p[1]))
    q = (int(q[0]), int(q[1]))
    H, W = img.shape[:2]
    if thickness > 1:
        # the ends are first clipped to the image grown by the thickness
        t = thickness
        inside, p, q = _clip_line(W + 2 * t, H + 2 * t, (p[0] + t, p[1] + t), (q[0] + t, q[1] + t))
        if not inside:
            return img
        p, q = (p[0] - t, p[1] - t), (q[0] - t, q[1] - t)
    color = np.atleast_1d(np.asarray(color, img.dtype))[: img.shape[2] if img.ndim == 3 else 1]
    if img.ndim == 2:
        color = color[0]
    if thickness <= 1:
        pts = _line_points(W, H, p, q)
        img[pts[:, 1], pts[:, 0]] = color
        return img
    p0 = (p[0] << XY_SHIFT, p[1] << XY_SHIFT)
    p1 = (q[0] << XY_SHIFT, q[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (th + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, quad, color)
    for end in (p0, p1):
        _circle_filled(img, (end[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                       (end[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                       (th + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return img


def fill_poly(mask: np.ndarray, poly: np.ndarray, value=255) -> np.ndarray:
    """cv2.fillPoly(mask, [poly], value) in place for one int32 polygon
    [n, 2] (x, y), 8-connected, shift 0, convex or not (OpenCV's
    CollectPolyEdges + FillEdgeCollection: the outline drawn as 8-connected
    lines, the inside scan-converted in 16-bit fixed point)."""
    H, W = mask.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    edges = []
    pt0 = (v[-1][0] << XY_SHIFT, v[-1][1])
    for i in range(len(v)):
        pt1 = (v[i][0] << XY_SHIFT, v[i][1])
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        pts = _line_points(W, H, t0, t1)
        mask[pts[:, 1], pts[:, 0]] = value
        # the edge runs from its ends (clipped to the image where its
        # outline leaves it, as far as cv::clipLine moves them) at the
        # pixels' centres
        c0, c1 = (t0[0] << XY_SHIFT, t0[1]), (t1[0] << XY_SHIFT, t1[1])
        if not (0 <= t0[0] < W and 0 <= t1[0] < W and 0 <= t0[1] < H and 0 <= t1[1] < H):
            _, (a0, b0), (a1, b1) = _clip_line(W, H, t0, t1)
            if b0 != b1:
                c0, c1 = (a0 << XY_SHIFT, b0), (a1 << XY_SHIFT, b1)
        if pt0[1] != pt1[1]:
            top, bot = (c0, c1) if pt0[1] < pt1[1] else (c1, c0)
            edges.append([min(pt0[1], pt1[1]), max(pt0[1], pt1[1]),
                          top[0] + (XY_ONE >> 1), bot[0] + (XY_ONE >> 1), top[1], bot[1]])
        pt0 = pt1
    _fill_edges(mask, edges, value)
    return mask


def _edge_x(e, y: int) -> int:
    """An edge's x at row y with 32 fractional bits, from its ends
    [.., .., x_top, x_bottom (16-bit fixed point), y_top, y_bottom]."""
    xt, xb, yt, yb = e[2], e[3], e[4], e[5]
    return (xt << XY_SHIFT) + ((y - yt) * (xb - xt) << XY_SHIFT) // (yb - yt)


def _fill_edges(img: np.ndarray, edges, color) -> None:
    """cv::FillEdgeCollection: the active edges, ordered by x row by row,
    filled between pairs; a span runs from the left edge's pixel to the
    pixel before the one the right edge reaches (as OpenCV 5 fills; each
    edge's x is taken at the row, not summed up row by row)."""
    H, W = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [_edge_x(e, e[0]) for e in edges] + [_edge_x(e, e[1]) for e in edges]
    if y_max < 0 or y_min >= H or max(xs) < 0 or min(xs) >= (W << 2 * XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], _edge_x(e, e[0])))
    y_max = min(y_max, H)
    total = len(edges)
    active = []          # the active edges, in order of x
    i = 0
    y = edges[0][0]
    while y < y_max:
        # drop the edges ending here; insert the ones starting here before
        # the first active edge whose x is not below theirs
        xa = {id(e): _edge_x(e, y) for e in active}
        merged, j = [], 0
        while j < len(active) or (i < total and edges[i][0] == y):
            last = active[j] if j < len(active) else None
            if last is not None and last[1] == y:
                j += 1
            elif last is not None and (i >= total or edges[i][0] > y or
                                       xa[id(last)] < _edge_x(edges[i], y)):
                merged.append(last)
                j += 1
            elif i < total:
                merged.append(edges[i])
                i += 1
            else:
                break
        active = merged
        if y >= 0:
            for a, b in zip(active[0::2], active[1::2]):
                lo, hi = sorted((_edge_x(a, y), _edge_x(b, y)))
                x1, x2 = lo >> (2 * XY_SHIFT), (hi - XY_ONE) >> (2 * XY_SHIFT)
                if x1 < W and x2 >= 0:
                    _hline(img, y, max(x1, 0), min(x2, W - 1), color)
        y += 1
        active.sort(key=lambda e: _edge_x(e, y))
