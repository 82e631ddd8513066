"""PNG decoding and encoding with numpy and zlib (no OpenCV or Pillow).

Decoding takes 8-bit gray, gray+alpha, RGB and RGBA (alpha dropped) and
16-bit gray (big-endian samples), non-interlaced. Palettes, other bit
depths and Adam7 interlacing raise `PNGError`. Rows filtered with None (0)
and Sub (1) do not read the row above, so numpy reconstructs them in one
pass (Sub as a cumulative sum modulo 256 per byte of the pixel). The rows
that do, Up (2), Avg (3) and Paeth (4), then go top to bottom through one
call of a small C++ function (`csrc/png_unfilter.cpp`, compiled with the
host compiler at first use by ops/native.load_host; a failed build
raises): Avg and Paeth bytes also run in sequence along the row.
`unfilter_row_py` is the pure-Python version of every filter type, the
plain version the tests hold the others against.

The encoder writes 8-bit gray/RGB/RGBA or 16-bit gray with any filter type
per row (the forward filters read only original bytes, so each is one
numpy expression), or with libpng's adaptive choice per row (`ADAPTIVE`:
the type whose filtered bytes, read as signed, have the least sum of
absolute values); the default is Sub.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from functools import lru_cache
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAPTIVE = "adaptive"
# colour type -> (channels, channels kept)
_COLOR_TYPES = {0: (1, 1), 4: (2, 1), 2: (3, 3), 6: (4, 3)}


class PNGError(ValueError):
    """A file the decoder does not take, or a malformed PNG."""


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise PNGError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: CRC mismatch in chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{name}: no IEND chunk")


@lru_cache(maxsize=None)
def _native():
    from ..ops import native
    fn = native.load_host("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _unfilter_native(ftypes: np.ndarray, filt: np.ndarray, out: np.ndarray, bpp: int) -> None:
    """Reconstruct the rows of filter type 2-4 of `filt` [H, stride] into
    `out` in place (its rows of type 0 and 1 already reconstructed)."""
    ftypes = np.ascontiguousarray(ftypes, dtype=np.uint8)
    filt = np.ascontiguousarray(filt, dtype=np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous or out.shape != filt.shape \
            or filt.ndim != 2 or ftypes.shape != filt.shape[:1] or bpp < 1:
        raise ValueError("png unfilter: [H, stride] uint8 rows, one type per row, bpp >= 1")
    rc = _native()(ftypes.ctypes.data, filt.ctypes.data, out.ctypes.data,
                   filt.shape[0], filt.shape[1], bpp)
    if rc != 0:
        raise PNGError(f"unknown filter type {int(ftypes[-1 - rc])} in row {-1 - rc}")


def unfilter_row_py(ftype: int, filt: Sequence[int], prior: Sequence[int], bpp: int
                    ) -> np.ndarray:
    """Reconstruct one row of any filter type in pure Python (the plain
    version)."""
    out = [0] * len(filt)
    for i, x in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        b = int(prior[i])
        c = int(prior[i - bpp]) if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        elif ftype == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            raise PNGError(f"unknown filter type {ftype}")
        out[i] = (int(x) + pred) & 0xFF
    return np.asarray(out, dtype=np.uint8)


def unfilter(raw: np.ndarray, bpp: int, name: str = "<png>") -> np.ndarray:
    """Reconstructed bytes [H, stride] of the decompressed image data `raw`
    [H, 1 + stride] (a filter-type byte, then the row)."""
    ftypes, filt = raw[:, 0], raw[:, 1:]
    if np.any(ftypes > 4):
        raise PNGError(f"{name}: unknown filter type {int(ftypes.max())}")
    H, stride = filt.shape
    out = np.empty(filt.shape, np.uint8)
    rows0 = ftypes == 0
    out[rows0] = filt[rows0]
    rows1 = ftypes == 1
    if rows1.any():
        sub = filt[rows1].reshape(-1, stride // bpp, bpp)
        out[rows1] = np.cumsum(sub, axis=1, dtype=np.uint8).reshape(-1, stride)
    if np.any(ftypes >= 2):
        _unfilter_native(ftypes, filt, out, bpp)
    return out


def _image_data(data: bytes, name: str):
    """(W, H, depth, channels, keep, bpp, raw [H, 1 + W bpp]) of PNG bytes
    `data`: the header's fields and the decompressed, still filtered rows."""
    ihdr, idat = None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            raise PNGError(f"{name}: palette PNGs are not supported")
    if ihdr is None:
        raise PNGError(f"{name}: no IHDR chunk")
    W, H, depth, ctype_, comp, filt_method, interlace = ihdr
    if interlace != 0:
        raise PNGError(f"{name}: interlaced (Adam7) PNGs are not supported")
    if comp != 0 or filt_method != 0:
        raise PNGError(f"{name}: unknown compression or filter method")
    if ctype_ not in _COLOR_TYPES or depth not in (8, 16) or (depth == 16 and ctype_ != 0):
        raise PNGError(f"{name}: colour type {ctype_} at bit depth {depth} is not supported "
                       "(8-bit gray/gray+alpha/RGB/RGBA and 16-bit gray are)")
    channels, keep = _COLOR_TYPES[ctype_]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise PNGError(f"{name}: image data has {raw.size} bytes, expected "
                       f"{H * (1 + W * bpp)}")
    return W, H, depth, channels, keep, bpp, raw.reshape(H, 1 + W * bpp)


def decode(data: bytes, name: str = "<png>") -> np.ndarray:
    """The image in PNG bytes `data`: uint8 [H, W] (gray) or [H, W, 3]
    (RGB; alpha dropped), or uint16 [H, W] (16-bit gray)."""
    W, H, depth, channels, keep, bpp, raw = _image_data(data, name)
    rows = unfilter(raw, bpp, name)
    if depth == 16:
        return rows.view(">u2").reshape(H, W).astype(np.uint16)
    img = rows.reshape(H, W, channels)[..., :keep]
    return img[..., 0].copy() if keep == 1 else np.ascontiguousarray(img)


def read(path: str) -> np.ndarray:
    """decode() of the file at `path`."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def size(path: str):
    """(H, W) of the PNG file at `path`, from its IHDR chunk alone (no
    pixel is decoded). Raises PNGError for a file that is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise PNGError(f"{path}: not a PNG file")
    if zlib.crc32(head[12:29]) != struct.unpack(">I", head[29:33])[0]:
        raise PNGError(f"{path}: CRC mismatch in chunk b'IHDR'")
    W, H = struct.unpack(">II", head[16:24])
    return H, W


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + \
        struct.pack(">I", zlib.crc32(ctype + body))


def filter_rows(rows: np.ndarray, bpp: int, filters: Union[int, Sequence[int], str]
                ) -> np.ndarray:
    """Forward-filter rows [H, stride] (uint8) with filter type filters[y]
    for row y (one type for all rows, or ADAPTIVE) -> [H, 1 + stride]."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    cand = ((x - preds) & 0xFF).astype(np.uint8)   # [5, H, stride], one per type
    if isinstance(filters, str):
        if filters != ADAPTIVE:
            raise PNGError(f"filters: a type 0-4, one per row, or {ADAPTIVE!r}, not {filters!r}")
        signed = cand.view(np.int8).astype(np.int32)
        f = np.argmin(np.abs(signed).sum(axis=2), axis=0)   # ties: the lower type
    else:
        f = np.broadcast_to(np.asarray(filters, dtype=np.int64), (len(rows),))
        if np.any((f < 0) | (f > 4)):
            raise PNGError(f"filter types are 0-4, got {sorted(set(f.tolist()))}")
    out = cand[f, np.arange(len(rows))]
    return np.concatenate([f.astype(np.uint8)[:, None], out], axis=1)


def encode(img: np.ndarray, filters: Union[int, Sequence[int], str] = 1,
           level: int = 6) -> bytes:
    """PNG bytes of uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W];
    `filters` is one filter type for every row, one per row, or ADAPTIVE."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype_, rows = 16, 0, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        bpp = 2
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        ch = 1 if img.ndim == 2 else img.shape[2]
        depth, ctype_, bpp = 8, {1: 0, 3: 2, 4: 6}[ch], ch
        rows = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    else:
        raise PNGError(f"cannot encode an array of dtype {img.dtype} and shape {img.shape}")
    H, W = img.shape[:2]
    body = filter_rows(rows, bpp, filters).tobytes()
    return SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype_, 0, 0, 0)) \
        + _chunk(b"IDAT", zlib.compress(body, level)) + _chunk(b"IEND", b"")


def filter_types(data: bytes, name: str = "<png>") -> np.ndarray:
    """The filter type of each row of the PNG bytes `data` [H]."""
    return _image_data(data, name)[-1][:, 0].copy()


def write(path: str, img: np.ndarray, filters: Union[int, Sequence[int], str] = 1) -> None:
    """Write encode(img, filters) to `path`."""
    with open(path, "wb") as f:
        f.write(encode(img, filters))

