"""Baseline TIFF in numpy (the counterpart of OpenCV's TIFF reader where
the JAX package calls cv2.imread(path, IMREAD_ANYDEPTH) on depth maps:
OnePose's `*_mvs.tiff`, 7-Scenes' rendered `*.pose.depth.tiff`).

`read` returns the first image of a file: both byte orders; strips or
tiles; compression none (1), LZW (5), Deflate (8 and 32946, zlib) and
PackBits (32773); predictors none (1), horizontal (2) and floating point
(3); 8- and 16-bit unsigned and 32-bit float samples; 1, 3 or 4 samples
per pixel, interleaved. Anything else raises NotImplementedError naming
the tag. LZW codes are expanded by the host helper csrc/jpeg_decode.cpp
(`lzw_decode`; `lzw_decode_py` is its plain version).

`write` writes one image in strips or tiles, in either byte order
(compression none, LZW or Deflate; predictor 1, 2 or 3), for the synthetic
scenes and the tests.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import native

NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS = 1, 5, 8, 32946, 32773
TAG_NAMES = {254: "NewSubfileType", 256: "ImageWidth", 257: "ImageLength",
             258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
             266: "FillOrder", 273: "StripOffsets", 277: "SamplesPerPixel",
             278: "RowsPerStrip", 279: "StripByteCounts", 284: "PlanarConfiguration",
             317: "Predictor", 322: "TileWidth", 323: "TileLength", 324: "TileOffsets",
             325: "TileByteCounts", 338: "ExtraSamples", 339: "SampleFormat"}
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          16: ("Q", 8)}


def _unsupported(tag: int, value) -> NotImplementedError:
    return NotImplementedError(f"TIFF {TAG_NAMES.get(tag, tag)}={value} is not supported")


def _ifd(buf: bytes) -> Tuple[str, Dict[int, List]]:
    """Byte order and the first IFD's tags {tag: [values]}."""
    order = {b"II": "<", b"MM": ">"}.get(buf[:2])
    if order is None:
        raise ValueError("not a TIFF file (no II/MM byte-order mark)")
    magic, off = struct.unpack(order + "HI", buf[2:8])
    if magic != 42:
        raise _unsupported(0, f"version {magic} (BigTIFF)")
    n = struct.unpack(order + "H", buf[off:off + 2])[0]
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", buf[e:e + 8])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        at = e + 8 if nbytes <= 4 else struct.unpack(order + "I", buf[e + 8:e + 12])[0]
        if typ == 2:
            tags[tag] = [buf[at:at + count]]
            continue
        vals = struct.unpack(order + code * count, buf[at:at + nbytes])
        if typ in (5, 10):
            vals = [a / b if b else 0.0 for a, b in zip(vals[::2], vals[1::2])]
        tags[tag] = list(vals)
    return order, tags


def lzw_decode_py(data: bytes, expected: int) -> bytes:
    """TIFF LZW (MSB-first codes, 9 to 12 bits, the width growing one code
    early), the plain version of the helper's lzw_decode."""
    if data[:2] == b"\x00\x01":
        raise _unsupported(LZW, "old-style (LSB-first) LZW")
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    bits, nbits, pos, width, prev = 0, 0, 0, 9, None
    while len(out) < expected:
        while nbits < width and pos < len(data):
            bits = ((bits << 8) | data[pos]) & 0xFFFFFF
            pos += 1
            nbits += 8
        if nbits < width:
            break
        code = (bits >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream (code {code} of {len(table)})")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:expected])


def lzw_decode(data: bytes, expected: int) -> bytes:
    """lzw_decode_py in the host helper."""
    if data[:2] == b"\x00\x01":
        raise _unsupported(LZW, "old-style (LSB-first) LZW")
    lib = native.load_host("jpeg_decode")
    out = ctypes.create_string_buffer(max(expected, 1))
    n = lib.lzw_decode(ctypes.c_char_p(data), ctypes.c_long(len(data)), out,
                       ctypes.c_long(expected))
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return out.raw[:n]


def packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out[:expected])


def _decompress(comp: int, data: bytes, expected: int) -> bytes:
    if comp == NONE:
        return data[:expected]
    if comp == LZW:
        return lzw_decode(data, expected)
    if comp in (DEFLATE, DEFLATE_OLD):
        return zlib.decompress(data)[:expected]
    if comp == PACKBITS:
        return packbits_decode(data, expected)
    raise _unsupported(259, comp)


def _unpredict(block: np.ndarray, predictor: int, dtype: np.dtype, spp: int) -> np.ndarray:
    """block: [rows, width * spp * itemsize] bytes of one strip or tile ->
    [rows, width * spp] samples in native order."""
    rows = block.shape[0]
    if predictor == 3:
        # libtiff's fpAcc: bytes summed along the row with stride spp, then
        # regrouped from byte planes (most significant first)
        size = dtype.itemsize
        acc = np.cumsum(block.reshape(rows, -1, spp).astype(np.uint8), axis=1,
                        dtype=np.uint8).reshape(rows, size, -1)
        return np.ascontiguousarray(acc.transpose(0, 2, 1)).view(">f%d" % size
                                                                 ).reshape(rows, -1)
    samples = np.ascontiguousarray(block).view(dtype).reshape(rows, -1)
    if predictor == 2:
        # libtiff's horAcc8/16/32: unsigned sums along the row (of float
        # samples too, as their bit patterns)
        uint = np.dtype(f"{dtype.byteorder}u{dtype.itemsize}")
        native_u = uint.newbyteorder("=")
        s = samples.view(uint).astype(native_u).reshape(rows, -1, spp)
        samples = np.cumsum(s, axis=1, dtype=native_u).reshape(rows, -1).view(
            dtype.newbyteorder("="))
    elif predictor != 1:
        raise _unsupported(317, predictor)
    return samples


def read(path: str) -> np.ndarray:
    """The first image of a TIFF file: [H, W] or [H, W, spp] (uint8,
    uint16 or float32, samples in file order)."""
    with open(path, "rb") as f:
        buf = f.read()
    order, tags = _ifd(buf)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    W, H = one(256), one(257)
    spp = one(277, 1)
    bps = set(tags.get(258, [1]))
    fmt = set(tags.get(339, [1]))
    comp = one(259, 1)
    # libtiff applies a predictor inside the LZW and Deflate codecs only
    predictor = one(317, 1) if comp in (LZW, DEFLATE, DEFLATE_OLD) else 1
    if len(bps) != 1:
        raise _unsupported(258, sorted(bps))
    bps = bps.pop()
    if len(fmt) != 1:
        raise _unsupported(339, sorted(fmt))
    fmt = fmt.pop()
    if spp not in (1, 3, 4):
        raise _unsupported(277, spp)
    if one(284, 1) != 1 and spp > 1:
        raise _unsupported(284, one(284))
    if one(266, 1) != 1:
        raise _unsupported(266, one(266))
    if one(262, 1) not in (0, 1, 2):
        raise _unsupported(262, one(262))
    kinds = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}
    if (bps, fmt) not in kinds:
        raise _unsupported(258 if (bps, fmt) != (32, 1) else 339, f"{bps}-bit format {fmt}")
    dtype = np.dtype(order + kinds[(bps, fmt)])
    if predictor == 3 and fmt != 3:
        raise _unsupported(317, predictor)
    if comp not in (NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS):
        raise _unsupported(259, comp)

    row_bytes = lambda w: w * spp * dtype.itemsize  # noqa: E731
    out = np.zeros((H, W * spp), dtype.newbyteorder("="))
    if 322 in tags:
        tw, tl = one(322), one(323)
        offs, counts = tags[324], tags[325]
        across = -(-W // tw)
        for i, (o, c) in enumerate(zip(offs, counts)):
            ty, tx = divmod(i, across)
            if ty * tl >= H:
                break
            raw = _decompress(comp, buf[o:o + c], tl * row_bytes(tw))
            raw = raw.ljust(tl * row_bytes(tw), b"\0")
            tile = _unpredict(np.frombuffer(raw, np.uint8).reshape(tl, -1), predictor,
                              dtype, spp)
            h, w = min(tl, H - ty * tl), min(tw, W - tx * tw)
            out[ty * tl:ty * tl + h, tx * tw * spp:(tx * tw + w) * spp] = tile[:h, :w * spp]
    else:
        rps = min(one(278, H), H)
        offs, counts = tags[273], tags.get(279)
        if counts is None:
            raise _unsupported(279, "missing")
        for i, (o, c) in enumerate(zip(offs, counts)):
            y0 = i * rps
            if y0 >= H:
                break
            rows = min(rps, H - y0)
            raw = _decompress(comp, buf[o:o + c], rows * row_bytes(W))
            if len(raw) < rows * row_bytes(W):
                raise ValueError(f"{path}: strip {i} holds {len(raw)} of "
                                 f"{rows * row_bytes(W)} bytes")
            out[y0:y0 + rows] = _unpredict(np.frombuffer(raw, np.uint8).reshape(rows, -1),
                                           predictor, dtype, spp)
    return out.reshape(H, W) if spp == 1 else out.reshape(H, W, spp)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (a clear code first and whenever the table fills)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    put(256, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:  # the table is full: clear it
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt >= (1 << width):
            width += 1
        w = bytes([b])
    if w:
        put(table[w], width)
        if nxt + 1 == 4094:
            put(256, width)
            width = 9
        elif nxt + 1 >= (1 << width):
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _predict(rows: np.ndarray, predictor: int, spp: int, order: str) -> bytes:
    """The inverse of _unpredict on [rows, width * spp] native samples."""
    n = rows.shape[0]
    if predictor == 2:
        u = rows.view(f"u{rows.dtype.itemsize}").reshape(n, -1, spp)
        d = np.diff(u, axis=1, prepend=np.zeros_like(u[:, :1]))
        return d.astype(d.dtype.newbyteorder(order)).tobytes()
    if predictor == 3:
        be = rows.astype(">f4").view(np.uint8).reshape(n, -1, 4)
        planes = be.transpose(0, 2, 1).reshape(n, -1, spp)
        return np.diff(planes, axis=1, prepend=np.zeros_like(planes[:, :1])
                       ).astype(np.uint8).tobytes()
    return rows.astype(rows.dtype.newbyteorder(order)).tobytes()


def write(path: str, img: np.ndarray, compression: int = DEFLATE, predictor: int = 1,
          rows_per_strip: int = 16, tile: Optional[Tuple[int, int]] = None,
          big_endian: bool = False) -> None:
    """A TIFF of a uint8, uint16 or float32 [H, W] or [H, W, spp] array
    (spp 1, 3 or 4): strips of `rows_per_strip` rows, or tiles of
    tile = (width, length) (multiples of 16), little-endian unless
    big_endian. Compression none, LZW or Deflate; predictor 1, 2 (integer
    samples) or 3 (float32), with a compression."""
    img = np.asarray(img)
    kinds = {np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
             np.dtype(np.float32): (32, 3)}
    if img.dtype not in kinds:
        raise NotImplementedError(f"TIFF write: {img.dtype}")
    if compression not in (NONE, LZW, DEFLATE):
        raise _unsupported(259, compression)
    bps, fmt = kinds[img.dtype]
    if predictor not in ((1, 2, 3) if fmt == 3 else (1, 2)) or \
            predictor != 1 and compression == NONE:
        raise _unsupported(317, predictor)
    order = ">" if big_endian else "<"
    H, W = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    data = np.ascontiguousarray(img).reshape(H, W * spp)
    blocks = []
    if tile is None:
        blocks = [data[y0:y0 + rows_per_strip] for y0 in range(0, H, rows_per_strip)]
    else:
        tw, tl = tile
        padded = np.zeros((-(-H // tl) * tl, -(-W // tw) * tw * spp), img.dtype)
        padded[:H, :W * spp] = data
        blocks = [padded[y0:y0 + tl, x0 * spp:(x0 + tw) * spp]
                  for y0 in range(0, H, tl) for x0 in range(0, W, tw)]
    chunks = []
    for rows in blocks:
        raw = _predict(np.ascontiguousarray(rows), predictor, spp, order)
        if compression == LZW:
            raw = lzw_encode(raw)
        elif compression == DEFLATE:
            raw = zlib.compress(raw, 6)
        chunks.append(raw)

    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bps] * spp), (259, 3, [compression]),
               (262, 3, [2 if spp >= 3 else 1])]
    if tile is None:
        entries += [(273, 4, None), (277, 3, [spp]), (278, 4, [rows_per_strip]),
                    (279, 4, [len(c) for c in chunks])]
    else:
        entries += [(277, 3, [spp]), (322, 3, [tile[0]]), (323, 3, [tile[1]]),
                    (324, 4, None), (325, 4, [len(c) for c in chunks])]
    entries += [(284, 3, [1]), (317, 3, [predictor])]
    if spp == 4:
        entries.append((338, 3, [2]))
    entries.append((339, 3, [fmt] * spp))
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = 8 + ifd_size
    extras = bytearray()

    def field(tag, typ, vals):
        code = {3: "H", 4: "I"}[typ]
        payload = struct.pack(order + code * len(vals), *vals)
        if len(payload) <= 4:
            return struct.pack(order + "HHI", tag, typ, len(vals))[:8] + payload.ljust(4, b"\0")
        at = extra_at + len(extras)
        extras.extend(payload + b"\0" * (len(payload) & 1))
        return struct.pack(order + "HHII", tag, typ, len(vals), at)

    # the chunks' offsets come after the IFD and its out-of-line values,
    # whose size depends on the offsets' own: lay them out twice
    offsets = [0] * len(chunks)
    for _ in range(2):
        extras.clear()
        body = b"".join(field(tag, typ, offsets if vals is None else vals)
                        for tag, typ, vals in entries)
        at = extra_at + len(extras)
        offsets = [int(v) for v in np.cumsum([at] + [len(c) for c in chunks[:-1]])]
    with open(path, "wb") as f:
        f.write((b"MM" if big_endian else b"II") + struct.pack(order + "HI", 42, 8))
        f.write(struct.pack(order + "H", len(entries)) + body + struct.pack(order + "I", 0))
        f.write(bytes(extras))
        for c in chunks:
            f.write(c)
