"""Baseline JPEG with libjpeg-turbo's arithmetic (the counterpart of
OpenCV's cv2.imread(path, IMREAD_COLOR) where the JAX package reads the
12-Scenes `*color.jpg` frames; OpenCV decodes through libjpeg-turbo).

`read`/`decode` return RGB uint8 [H, W, 3] of a baseline or extended
sequential Huffman file: 8-bit samples, 1 or 3 components, chroma at
4:4:4, 4:2:2 or 4:2:0, restart markers, one interleaved scan or one scan
per component. The entropy decoding and the integer inverse DCT
(libjpeg-turbo's "islow", jidctint.c) run in the host helper
csrc/jpeg_decode.cpp, built with the host's C++ compiler at first use; the
chroma is upsampled with libjpeg-turbo's "fancy" triangle filter
(jdsample.c: the 3:1 weights, the edge rows and columns repeated as its
context rows are) and converted with its integer YCbCr tables (jdcolor.c),
in numpy. A gray file is replicated to three channels. `decode_py` does
the same with the entropy decoding and the IDCT in Python and numpy: the
plain version the helper is held against.

Progressive, arithmetic-coded, lossless and 12-bit files raise
NotImplementedError, and so does an EXIF orientation other than 1 (OpenCV
would rotate the image) or an RGB-coded file; a bad marker raises
ValueError.

`encode` writes a baseline file (4:2:0 or 4:4:4, the standard Huffman and
quantization tables of the JPEG specification's Annex K scaled by a
quality, floating-point forward DCT), for the synthetic scenes; it does
not reproduce any other encoder's bytes.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import native

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class _Frame:
    """What the markers say: size, components, tables, restart interval."""

    def __init__(self):
        self.H = self.W = 0
        self.comps: List[Dict] = []
        self.qt: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
        self.restart = 0
        self.adobe_transform: Optional[int] = None
        self.jfif = False
        self.coefs: Dict[int, np.ndarray] = {}


def _exif_orientation(seg: bytes) -> int:
    if seg[:6] != b"Exif\0\0":
        return 1
    t = seg[6:]
    order = {b"II": "<", b"MM": ">"}.get(t[:2])
    if order is None or len(t) < 8:
        return 1
    off = struct.unpack(order + "I", t[4:8])[0]
    if off + 2 > len(t):
        return 1
    n = struct.unpack(order + "H", t[off:off + 2])[0]
    for i in range(n):
        e = off + 2 + 12 * i
        if e + 12 > len(t):
            break
        tag, typ = struct.unpack(order + "HH", t[e:e + 4])
        if tag == 0x0112:
            return struct.unpack(order + "H", t[e + 8:e + 10])[0]
    return 1


def _mcu_grid(fr: _Frame, comps: List[int]) -> Tuple[int, int]:
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if len(comps) == 1:
        c = fr.comps[comps[0]]
        cw = -(-fr.W * c["h"] // hmax)
        ch = -(-fr.H * c["v"] // vmax)
        return -(-cw // 8), -(-ch // 8)
    return -(-fr.W // (8 * hmax)), -(-fr.H // (8 * vmax))


def _parse(data: bytes, entropy) -> _Frame:
    """Walk the markers; each scan's entropy-coded data goes to
    entropy(frame, scan components, data from the scan's first byte),
    which returns the bytes it consumed."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    fr = _Frame()
    i, n, seen_frame = 2, len(data), False
    while True:
        while i < n and data[i] == 0xFF and i + 1 < n and data[i + 1] == 0xFF:
            i += 1  # fill bytes
        if i + 1 >= n:
            raise ValueError("JPEG data ends before the EOI marker")
        if data[i] != 0xFF:
            raise ValueError(f"bad JPEG marker at byte {i} (0x{data[i]:02x})")
        m = data[i + 1]
        i += 2
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if i + 2 > n:
            raise ValueError("JPEG segment past the end of the file")
        L = struct.unpack(">H", data[i:i + 2])[0]
        seg = data[i + 2:i + L]
        if len(seg) != L - 2:
            raise ValueError("JPEG segment past the end of the file")
        i += L
        if m in (0xC0, 0xC1):
            p, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if p != 8:
                raise NotImplementedError(f"{p}-bit JPEG samples are not supported")
            if nc not in (1, 3):
                raise NotImplementedError(f"JPEG with {nc} components is not supported")
            if H == 0:
                raise NotImplementedError("JPEG height from a DNL marker is not supported")
            fr.H, fr.W = H, W
            for k in range(nc):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                fr.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            seen_frame = True
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            kind = {0xC2: "progressive", 0xC3: "lossless"}.get(
                m, "arithmetic-coded" if m >= 0xC9 else "hierarchical")
            raise NotImplementedError(f"{kind} JPEG (SOF{m - 0xC0}) is not supported")
        elif m == 0xCC:
            raise NotImplementedError("arithmetic-coded JPEG (DAC) is not supported")
        elif m == 0xC4:
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                bits = seg[j + 1:j + 17]
                cnt = sum(bits)
                fr.huff[(tc, th)] = (bits, seg[j + 17:j + 17 + cnt])
                j += 17 + cnt
        elif m == 0xDB:
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                size = 2 if pq else 1
                vals = np.frombuffer(seg[j + 1:j + 1 + 64 * size], ">u2" if pq else "u1")
                q = np.zeros(64, np.uint16)
                q[ZIGZAG] = vals
                fr.qt[tq] = q
                j += 1 + 64 * size
        elif m == 0xDD:
            fr.restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xE0 and seg[:5] == b"JFIF\0":
            fr.jfif = True
        elif m == 0xE1:
            o = _exif_orientation(seg)
            if o != 1:
                raise NotImplementedError(f"EXIF orientation {o}: OpenCV would rotate the image")
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            fr.adobe_transform = seg[11]
        elif m == 0xDA:
            if not seen_frame:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            comps, tabs = [], []
            for k in range(ns):
                cid, t = seg[1 + 2 * k:3 + 2 * k]
                idx = [c["id"] for c in fr.comps].index(cid)
                comps.append(idx)
                tabs.append((t >> 4, t & 15))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise NotImplementedError("JPEG scan with spectral selection or "
                                          "successive approximation is not supported")
            for k, c in enumerate(comps):
                fr.comps[c]["td"], fr.comps[c]["ta"] = tabs[k]
            i += entropy(fr, comps, data[i:])
        elif 0xE0 <= m <= 0xEF or m == 0xFE:
            pass
        else:
            raise ValueError(f"bad JPEG marker 0xff{m:02x}")
    if not fr.comps or not fr.coefs:
        raise ValueError("JPEG without a frame or a scan")
    return fr


def _coef_arrays(fr: _Frame) -> None:
    if fr.coefs:
        return
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    mx, my = -(-fr.W // (8 * hmax)), -(-fr.H // (8 * vmax))
    for k, c in enumerate(fr.comps):
        fr.coefs[k] = np.zeros((my * c["v"], mx * c["h"], 64), np.int16)


def _table_arrays(fr: _Frame) -> Tuple[np.ndarray, np.ndarray]:
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (tc, th), (b, v) in fr.huff.items():
        if th < 4:
            bits[4 * tc + th] = np.frombuffer(b, np.uint8)
            vals[4 * tc + th, :len(v)] = np.frombuffer(v, np.uint8)
    return bits, vals


def _native_lib():
    lib = native.load_host("jpeg_decode")
    lib.jpeg_scan.restype = ctypes.c_int64
    lib.jpeg_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int]
    lib.jpeg_idct_plane.restype = None
    lib.jpeg_idct_plane.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _scan_layout(fr: _Frame, comps: List[int]):
    _coef_arrays(fr)
    mx, my = _mcu_grid(fr, comps)
    info = []
    for c in comps:
        cc = fr.comps[c]
        h, v = (cc["h"], cc["v"]) if len(comps) > 1 else (1, 1)
        if (0, cc["td"]) not in fr.huff or (1, cc["ta"]) not in fr.huff:
            raise ValueError("JPEG scan refers to a Huffman table it does not define")
        info += [h, v, fr.coefs[c].shape[1], fr.coefs[c].shape[0], cc["td"], cc["ta"]]
    return mx, my, np.array(info, np.int32)


_ERRORS = {-1: "a bad Huffman code", -2: "a missing or wrong restart marker",
           -3: "a coefficient index past 63"}


def _entropy_native(fr: _Frame, comps: List[int], data: bytes) -> int:
    mx, my, info = _scan_layout(fr, comps)
    bits, vals = _table_arrays(fr)
    ptrs = (ctypes.c_void_p * len(comps))(*[fr.coefs[c].ctypes.data for c in comps])
    rc = _native_lib().jpeg_scan(data, len(data), len(comps), info.ctypes.data, ptrs,
                                 bits.ctypes.data, vals.ctypes.data, mx, my, fr.restart)
    if rc < 0:
        raise ValueError(f"corrupt JPEG scan: {_ERRORS.get(rc, rc)}")
    return int(rc)


class _BitsPy:
    """The helper's bit reader in Python."""

    def __init__(self, data: bytes):
        self.d, self.p, self.acc, self.n, self.marker = data, 0, 0, 0, False

    def get(self, k: int) -> int:
        while self.n < k:
            b = 0
            if not self.marker and self.p < len(self.d):
                b = self.d[self.p]
                if b == 0xFF:
                    if self.p + 1 < len(self.d) and self.d[self.p + 1] == 0:
                        self.p += 2
                    else:
                        self.marker, b = True, 0
                else:
                    self.p += 1
            self.acc = ((self.acc << 8) | b) & ((1 << 64) - 1)
            self.n += 8
        self.n -= k
        return (self.acc >> self.n) & ((1 << k) - 1)

    def restart(self, expect: int) -> bool:
        self.acc, self.n, self.marker = 0, 0, False
        d = self.d
        while self.p + 1 < len(d) and d[self.p] == 0xFF and d[self.p + 1] == 0xFF:
            self.p += 1
        if self.p + 1 >= len(d) or d[self.p] != 0xFF or d[self.p + 1] != 0xD0 + expect:
            return False
        self.p += 2
        return True


def _huff_py(bits: bytes, vals: bytes) -> Dict[Tuple[int, int], int]:
    """{(length, code): value} of a canonical table."""
    out, code, k = {}, 0, 0
    for L in range(1, 17):
        for _ in range(bits[L - 1]):
            out[(L, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return out


def _entropy_py(fr: _Frame, comps: List[int], data: bytes) -> int:
    mx, my, info = _scan_layout(fr, comps)
    tabs = {key: _huff_py(*v) for key, v in fr.huff.items()}
    b = _BitsPy(data)

    def symbol(tab):
        code, L = 0, 0
        while L < 16:
            code = (code << 1) | b.get(1)
            L += 1
            v = tab.get((L, code))
            if v is not None:
                return v
        raise ValueError(f"corrupt JPEG scan: {_ERRORS[-1]}")

    def extend(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    pred = [0] * len(comps)
    mcu = rst = 0
    for my_ in range(my):
        for mx_ in range(mx):
            if fr.restart and mcu and mcu % fr.restart == 0:
                if not b.restart(rst % 8):
                    raise ValueError(f"corrupt JPEG scan: {_ERRORS[-2]}")
                rst += 1
                pred = [0] * len(comps)
            mcu += 1
            for k, c in enumerate(comps):
                h, v = info[6 * k], info[6 * k + 1]
                dc, ac = tabs[(0, info[6 * k + 4])], tabs[(1, info[6 * k + 5])]
                arr = fr.coefs[c]
                for by in range(v):
                    for bx in range(h):
                        blk = arr[my_ * v + by, mx_ * h + bx]
                        s = symbol(dc)
                        if s:
                            pred[k] += extend(b.get(s), s)
                        blk[0] = pred[k]
                        z = 1
                        while z < 64:
                            rs = symbol(ac)
                            r, s = rs >> 4, rs & 15
                            if s:
                                z += r
                                if z > 63:
                                    raise ValueError(f"corrupt JPEG scan: {_ERRORS[-3]}")
                                blk[ZIGZAG[z]] = extend(b.get(s), s)
                                z += 1
                            elif r == 15:
                                z += 16
                            else:
                                break
    q = b.p
    while q < len(data) and not (data[q] == 0xFF and q + 1 < len(data) and
                                 data[q + 1] != 0 and not 0xD0 <= data[q + 1] <= 0xD7):
        q += 1
    return q


_C = dict(c0_298631336=2446, c0_390180644=3196, c0_541196100=4433, c0_765366865=6270,
          c0_899976223=7373, c1_175875602=9633, c1_501321110=12299, c1_847759065=15137,
          c1_961570560=16069, c2_053119869=16819, c2_562915447=20995, c3_072711026=25172)
_LIMIT = np.array([i + 128 if i < 128 else 255 if i < 512 else 0 if i < 896 else i - 896
                   for i in range(1024)], np.uint8)


def _idct_1d(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jpeg_idct_islow over int64 arrays x[0..7]; outputs
    descaled by `shift`."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["c0_541196100"]
    tmp2 = z1 + z3 * -c["c1_847759065"]
    tmp3 = z1 + z2 * c["c0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * c["c1_175875602"]
    tmp0 = tmp0 * c["c0_298631336"]
    tmp1 = tmp1 * c["c2_053119869"]
    tmp2 = tmp2 * c["c3_072711026"]
    tmp3 = tmp3 * c["c1_501321110"]
    z1 = z1 * -c["c0_899976223"]
    z2 = z2 * -c["c2_562915447"]
    z3 = z3 * -c["c1_961570560"] + z5
    z4 = z4 * -c["c0_390180644"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    r = 1 << (shift - 1)
    out = [t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
           t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3]
    return [(o + r) >> shift for o in out]


def _idct_py(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow over [bh, bw, 64] coefficients -> [bh*8, bw*8]."""
    bh, bw = coefs.shape[:2]
    x = coefs.reshape(-1, 8, 8).astype(np.int64) * qt.reshape(8, 8).astype(np.int64)
    cols = _idct_1d([x[:, r, :] for r in range(8)], 11)        # pass 1: columns
    ws = np.stack(cols, axis=1)                                 # [nb, row, col]
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 18)        # pass 2: rows
    out = _LIMIT[np.stack(rows, axis=2) & 1023]                 # [nb, row, col]
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _idct_native(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    bh, bw = coefs.shape[:2]
    coefs = np.ascontiguousarray(coefs)
    qt = np.ascontiguousarray(qt, np.uint16)
    out = np.empty((bh * 8, bw * 8), np.uint8)
    _native_lib().jpeg_idct_plane(coefs.ctypes.data, bw, bh, qt.ctypes.data, out.ctypes.data)
    return out


def _upsample_h2(x: np.ndarray, cw: int) -> np.ndarray:
    """h2v1_fancy_upsample over the first cw columns of rows x [h, >= cw]."""
    x = x[:, :cw].astype(np.int32)
    out = np.empty((x.shape[0], 2 * cw), np.int32)
    if cw <= 2:
        return np.repeat(x, 2, axis=1).astype(np.uint8)
    v3 = x * 3
    out[:, 0] = x[:, 0]
    out[:, 1:-1:2] = (v3[:, :-1] + x[:, 1:] + 2) >> 2
    out[:, 2::2] = (v3[:, 1:] + x[:, :-1] + 1) >> 2
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _upsample_h2v2(x: np.ndarray, cw: int, ch: int) -> np.ndarray:
    """h2v2_fancy_upsample: rows above the first and below the last repeat
    them (libjpeg-turbo's context rows)."""
    x = x[:ch, :cw].astype(np.int32)
    if cw <= 2:
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1).astype(np.uint8)
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * ch, 2 * cw), np.int32)
    for v, near in ((0, above), (1, below)):
        s = x * 3 + near                                     # column sums
        o = out[v::2]
        o[:, 0] = (s[:, 0] * 4 + 8) >> 4
        o[:, 1:-1:2] = (s[:, :-1] * 3 + s[:, 1:] + 7) >> 4
        o[:, 2::2] = (s[:, 1:] * 3 + s[:, :-1] + 8) >> 4
        o[:, -1] = (s[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = ((_fix(1.40200) * _X + (1 << 15)) >> 16).astype(np.int16)
_CB_B = ((_fix(1.77200) * _X + (1 << 15)) >> 16).astype(np.int16)
# Cb and Cr's green term, for every pair (cb, cr)
_G = ((-_fix(0.34414) * _X[:, None] + (1 << 15) - _fix(0.71414) * _X[None, :]) >> 16
      ).astype(np.int16).reshape(-1)
_CLAMP = np.clip(np.arange(-384, 640), 0, 255).astype(np.uint8)   # index: value + 384


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: R = y + Cr_r[cr], G = y + ((Cb_g[cb] +
    Cr_g[cr]) >> 16), B = y + Cb_b[cb], each clamped to 0..255."""
    y = y.astype(np.int16) + 384
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CR_R[cr]]
    out[..., 1] = _CLAMP[y + _G[(cb.astype(np.int32) << 8) | cr]]
    out[..., 2] = _CLAMP[y + _CB_B[cb]]
    return out


def _finish(fr: _Frame, idct) -> np.ndarray:
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    planes = []
    for k, c in enumerate(fr.comps):
        if c["tq"] not in fr.qt:
            raise ValueError("JPEG component refers to a quantization table it does not define")
        plane = idct(fr.coefs[k], fr.qt[c["tq"]])
        cw = -(-fr.W * c["h"] // hmax)
        ch = -(-fr.H * c["v"] // vmax)
        ratio = (hmax // c["h"], vmax // c["v"])
        if hmax % c["h"] or vmax % c["v"] or ratio not in ((1, 1), (2, 1), (2, 2)):
            raise NotImplementedError(f"JPEG chroma sampling {ratio} is not supported "
                                      "(4:4:4, 4:2:2 and 4:2:0 are)")
        if ratio == (2, 1):
            plane = _upsample_h2(plane[:ch], cw)
        elif ratio == (2, 2):
            plane = _upsample_h2v2(plane, cw, ch)
        planes.append(plane[:fr.H, :fr.W])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = tuple(c["id"] for c in fr.comps)
    if fr.adobe_transform == 0 or (not fr.jfif and fr.adobe_transform is None
                                   and ids == (82, 71, 66)):
        raise NotImplementedError("RGB-coded JPEG is not supported (YCbCr is)")
    return _ycc_to_rgb(*planes)


def decode(data: bytes) -> np.ndarray:
    """RGB uint8 [H, W, 3] (see the module docstring)."""
    fr = _parse(data, _entropy_native)
    return _finish(fr, _idct_native)


def decode_py(data: bytes) -> np.ndarray:
    """decode, with the entropy decoding in Python and the IDCT in numpy."""
    fr = _parse(data, _entropy_py)
    return _finish(fr, _idct_py)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


# -- the encoder ----------------------------------------------------------------------

_Q_LUMA = np.array([16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24,
                    22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72,
                    92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87, 95, 98, 103, 104, 103,
                    62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99])   # zigzag order
_Q_CHROMA = np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47] + [99, 66, 56, 66] + [99] * 50)
_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
            [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119])
# Annex K.3's AC values: these first, then every other (run, size) pair in
# order of run, then size
_AC_HEAD = ([0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
             0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42,
             0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82],
            [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
             0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1,
             0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24,
             0x34, 0xe1, 0x25, 0xf1])


def _ac_vals(head: List[int]) -> List[int]:
    return head + [(r << 4) | s for r in range(16) for s in range(1, 11)
                   if (r << 4) | s not in head]


def _codes(bits: List[int], vals: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol value 0..255."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(bits[L - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, L
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _quant(base: np.ndarray, quality: int) -> np.ndarray:
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    D = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    D[0] /= np.sqrt(2)
    return D


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[h, w] (multiples of 8) -> [h/8, w/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _bitstream(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes (MSB first), pad with 1 bits,
    stuff a 0 after every 0xFF."""
    total = int(lengths.sum())
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    owner = np.repeat(np.arange(len(lengths)), lengths)
    bit = np.arange(total) - starts
    bits = (codes[owner] >> (lengths[owner] - 1 - bit)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def encode(rgb: np.ndarray, quality: int = 90, subsampling: str = "420") -> bytes:
    """Baseline JPEG of an RGB uint8 [H, W, 3] image."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise NotImplementedError(f"JPEG encode: uint8 RGB images only, got {rgb.dtype} "
                                  f"{rgb.shape}")
    if subsampling not in ("420", "444"):
        raise NotImplementedError(f"JPEG encode: subsampling {subsampling}")
    H, W = rgb.shape[:2]
    x = rgb.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    f = 2 if subsampling == "420" else 1
    sampling = [(f, f), (1, 1), (1, 1)]
    hmax = sampling[0][0]
    mcu = 8 * hmax
    Hp, Wp = -(-H // mcu) * mcu, -(-W // mcu) * mcu
    qts = [_quant(_Q_LUMA, quality), _quant(_Q_CHROMA, quality)]
    D = _dct_matrix()
    comp_blocks = []
    for k, p in enumerate(planes):
        p = np.pad(p, ((0, Hp - H), (0, Wp - W)), mode="edge")
        if k and hmax == 2:
            p = p.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))
        F = D @ (_blocks(p) - 128.0) @ D.T                      # [by, bx, 8, 8]
        zz = F.reshape(F.shape[:2] + (64,))[..., ZIGZAG]
        q = qts[min(k, 1)]
        comp_blocks.append(np.rint(zz / q).astype(np.int64))

    # blocks in scan order: MCU by MCU, each component's blocks row by row
    my, mx = Hp // mcu, Wp // mcu
    order, comp_of = [], []
    for k, (h, v) in enumerate(sampling):
        cb = comp_blocks[k].reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
        order.append(cb.reshape(my * mx, h * v, 64))
        comp_of.append(np.full(h * v, k))
    blocks = np.concatenate(order, axis=1).reshape(-1, 64)
    comp = np.tile(np.concatenate(comp_of), my * mx)
    tab = np.minimum(comp, 1)
    dc = blocks[:, 0].copy()
    for k in range(len(sampling)):
        sel = comp == k
        dc[sel] = np.diff(blocks[sel, 0], prepend=0)

    dc_codes = [_codes(_DC_BITS[t], list(range(12))) for t in (0, 1)]
    ac_codes = [_codes(_AC_BITS[t], _ac_vals(_AC_HEAD[t])) for t in (0, 1)]

    def size_bits(v):
        s = np.zeros(v.shape, np.int64)
        a = np.abs(v)
        nz = a > 0
        s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        amp = np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)
        return s, amp

    keys, codes, lens = [], [], []
    nb = len(blocks)
    # DC: the category's code then its bits
    s, amp = size_bits(dc)
    c = np.where(tab == 0, dc_codes[0][0][s], dc_codes[1][0][s])
    L = np.where(tab == 0, dc_codes[0][1][s], dc_codes[1][1][s])
    keys.append(np.arange(nb) * 256)
    codes.append((c << s) | amp)
    lens.append(L + s)
    # AC: runs of zeros (ZRL for each 16), then (run, size) and the bits
    bi, ki = np.nonzero(blocks[:, 1:])
    ki = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], ki[:-1]]))
    run = ki - prev - 1
    s, amp = size_bits(blocks[bi, ki])
    t = tab[bi]
    sym = ((run % 16) << 4) | s
    c = np.where(t == 0, ac_codes[0][0][sym], ac_codes[1][0][sym])
    L = np.where(t == 0, ac_codes[0][1][sym], ac_codes[1][1][sym])
    keys.append(bi * 256 + 2 * ki)
    codes.append((c << s) | amp)
    lens.append(L + s)
    nzrl = run // 16
    zb = np.repeat(bi, nzrl)
    zt = tab[zb]
    keys.append(np.repeat(bi * 256 + 2 * ki - 1, nzrl))
    codes.append(np.where(zt == 0, ac_codes[0][0][0xF0], ac_codes[1][0][0xF0]))
    lens.append(np.where(zt == 0, ac_codes[0][1][0xF0], ac_codes[1][1][0xF0]))
    # EOB after a block's last non-zero coefficient unless it is the 63rd
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, bi, ki)
    eb = np.nonzero(last < 63)[0]
    keys.append(eb * 256 + 255)
    codes.append(np.where(tab[eb] == 0, ac_codes[0][0][0], ac_codes[1][0][0]))
    lens.append(np.where(tab[eb] == 0, ac_codes[0][1][0], ac_codes[1][1][0]))
    keys, codes, lens = (np.concatenate(a) for a in (keys, codes, lens))
    o = np.argsort(keys, kind="stable")
    scan = _bitstream(codes[o], lens[o])

    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(2):
        out.append(seg(0xDB, bytes([t]) + qts[t].astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, H, W, len(sampling))
    for k, (h, v) in enumerate(sampling):
        sof += bytes([k + 1, (h << 4) | v, min(k, 1)])
    out.append(seg(0xC0, sof))
    for t in range(2):
        out.append(seg(0xC4, bytes([t]) + bytes(_DC_BITS[t]) + bytes(range(12))))
        out.append(seg(0xC4, bytes([0x10 | t]) + bytes(_AC_BITS[t])
                       + bytes(_ac_vals(_AC_HEAD[t]))))
    sos = bytes([len(sampling)])
    for k in range(len(sampling)):
        sos += bytes([k + 1, (min(k, 1) << 4) | min(k, 1)])
    out.append(seg(0xDA, sos + b"\x00\x3f\x00"))
    out.append(scan + b"\xff\xd9")
    return b"".join(out)


def write(path: str, rgb: np.ndarray, quality: int = 90, subsampling: str = "420") -> None:
    with open(path, "wb") as f:
        f.write(encode(rgb, quality, subsampling))
