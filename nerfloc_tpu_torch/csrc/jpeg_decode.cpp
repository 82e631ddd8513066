// Baseline JPEG entropy decoding and the integer inverse DCT, with
// libjpeg-turbo's arithmetic (jdhuff.c, jidctint.c "islow"), plus the TIFF
// LZW expander. Host code with a plain C interface, loaded with ctypes by
// nerfloc_tpu_torch/data/jpeg.py and data/tiff.py, which parse the markers,
// upsample the chroma and convert the colours themselves in numpy.
#include <cstdint>
#include <cstring>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Huffman table in the form of JPEG Annex F.2.2.3 (maxcode per length,
// the offset of its first value).
struct Huff {
    int32_t maxcode[18];
    int32_t valoffset[17];
    const uint8_t* vals;
};

void build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        const int n = bits[l - 1];
        h->valoffset[l] = k - code;
        code += n;
        k += n;
        h->maxcode[l] = n ? code - 1 : -1;
        code <<= 1;
    }
    h->maxcode[17] = 0x7FFFFFFF;
    h->vals = vals;
}

// Bit reader over entropy-coded data: 0xFF 0x00 is a data byte 0xFF; at
// any other marker it stops and feeds zero bits (as libjpeg does).
struct Bits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int n = 0;
    bool marker = false;

    int fill() {
        while (n <= 56) {
            int b = 0;
            if (!marker && p < end) {
                b = *p;
                if (b == 0xFF) {
                    if (p + 1 < end && p[1] == 0x00) {
                        p += 2;
                    } else {
                        marker = true;
                        b = 0;
                    }
                } else {
                    ++p;
                }
            }
            acc = (acc << 8) | static_cast<uint64_t>(b);
            n += 8;
        }
        return 0;
    }
    int get(int k) {
        if (k == 0) return 0;
        if (n < k) fill();
        n -= k;
        return static_cast<int>((acc >> n) & ((1ull << k) - 1));
    }
    int bit() { return get(1); }
    // drops the bits left in the current byte and reads a restart marker
    // 0xFF 0xD0 + expect; false when another byte sequence stands there
    bool restart(int expect) {
        acc = 0;
        n = 0;
        marker = false;
        while (p < end && *p == 0xFF && p + 1 < end && p[1] == 0xFF) ++p;
        if (p + 1 >= end || p[0] != 0xFF || p[1] != 0xD0 + expect) return false;
        p += 2;
        return true;
    }
};

int decode_symbol(Bits& b, const Huff& h) {
    int code = b.bit();
    int l = 1;
    while (code > h.maxcode[l]) {
        code = (code << 1) | b.bit();
        if (++l > 16) return -1;
    }
    return h.vals[code + h.valoffset[l]];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

}  // namespace

extern "C" {

// Decodes the entropy-coded data of one baseline scan into quantized
// coefficients (natural order). `data`/`n`: the bytes after the SOS header
// up to the end of the file. `ns` components, each described by 6 ints in
// `info`: h, v (blocks per MCU; 1, 1 in a scan of one component), the
// coefficient array's width and height in blocks, the DC and AC table
// index. `coefs[c]` is that array ([height][width][64] int16). Tables:
// `bits` [8][16] and `vals` [8][256], DC tables 0-3 then AC tables 0-3.
// The MCU grid is mcus_x by mcus_y; `restart` MCUs between restart markers
// (0: none). Returns the bytes consumed (the scan ends before the marker
// that follows it), or a negative error: -1 a bad Huffman code, -2 a
// missing restart marker, -3 a coefficient index past 63.
int64_t jpeg_scan(const uint8_t* data, int64_t n, int ns, const int32_t* info,
                  int16_t* const* coefs, const uint8_t* bits, const uint8_t* vals,
                  int mcus_x, int mcus_y, int restart) {
    Huff tabs[8];
    for (int t = 0; t < 8; ++t) build_huff(bits + 16 * t, vals + 256 * t, &tabs[t]);
    Bits b{data, data + n};
    int pred[4] = {0, 0, 0, 0};
    int64_t mcu = 0, rst = 0;
    for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx, ++mcu) {
            if (restart > 0 && mcu > 0 && mcu % restart == 0) {
                if (!b.restart(static_cast<int>(rst % 8))) return -2;
                ++rst;
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
            }
            for (int c = 0; c < ns; ++c) {
                const int32_t* ci = info + 6 * c;
                const int h = ci[0], v = ci[1], bw = ci[2];
                const Huff& dc = tabs[ci[4]];
                const Huff& ac = tabs[4 + ci[5]];
                for (int by = 0; by < v; ++by) {
                    for (int bx = 0; bx < h; ++bx) {
                        int16_t* blk = coefs[c] +
                            (static_cast<int64_t>(my * v + by) * bw + (mx * h + bx)) * 64;
                        int s = decode_symbol(b, dc);
                        if (s < 0) return -1;
                        if (s) pred[c] += extend(b.get(s), s);
                        blk[0] = static_cast<int16_t>(pred[c]);
                        for (int k = 1; k < 64; ++k) {
                            const int rs = decode_symbol(b, ac);
                            if (rs < 0) return -1;
                            const int r = rs >> 4;
                            s = rs & 15;
                            if (s) {
                                k += r;
                                if (k > 63) return -3;
                                blk[kZigzag[k]] = static_cast<int16_t>(extend(b.get(s), s));
                            } else if (r == 15) {
                                k += 15;
                            } else {
                                break;
                            }
                        }
                    }
                }
            }
        }
    }
    // the scan ends at the next marker: step back over any look-ahead
    const uint8_t* q = b.p;
    while (q < data + n && !(q[0] == 0xFF && q + 1 < data + n && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7)))
        ++q;
    return q - data;
}

// jpeg_idct_islow over a plane of bw x bh blocks (natural-order
// coefficients, the quantization table in natural order) into `out`
// [bh * 8][bw * 8], rounded and range-limited as libjpeg-turbo's table
// does (the value masked to 10 bits, then clamped to 0..255 around 128).
void jpeg_idct_plane(const int16_t* coefs, int bw, int bh, const uint16_t* qt, uint8_t* out) {
    const int64_t C0_298631336 = 2446, C0_390180644 = 3196, C0_541196100 = 4433,
                  C0_765366865 = 6270, C0_899976223 = 7373, C1_175875602 = 9633,
                  C1_501321110 = 12299, C1_847759065 = 15137, C1_961570560 = 16069,
                  C2_053119869 = 16819, C2_562915447 = 20995, C3_072711026 = 25172;
    const int CB = 13, P1 = 2;
    uint8_t limit[1024];
    for (int i = 0; i < 1024; ++i)
        limit[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
    const int64_t stride = static_cast<int64_t>(bw) * 8;
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const int16_t* in = coefs + (static_cast<int64_t>(by) * bw + bx) * 64;
            int ws[64];
            for (int c = 0; c < 8; ++c) {
                auto dq = [&](int r) { return static_cast<int64_t>(in[8 * r + c]) * qt[8 * r + c]; };
                int64_t z2 = dq(2), z3 = dq(6);
                int64_t z1 = (z2 + z3) * C0_541196100;
                int64_t tmp2 = z1 + z3 * -C1_847759065;
                int64_t tmp3 = z1 + z2 * C0_765366865;
                z2 = dq(0);
                z3 = dq(4);
                int64_t tmp0 = (z2 + z3) * (1 << CB);
                int64_t tmp1 = (z2 - z3) * (1 << CB);
                const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
                const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
                tmp0 = dq(7);
                tmp1 = dq(5);
                tmp2 = dq(3);
                tmp3 = dq(1);
                z1 = tmp0 + tmp3;
                z2 = tmp1 + tmp2;
                z3 = tmp0 + tmp2;
                int64_t z4 = tmp1 + tmp3;
                const int64_t z5 = (z3 + z4) * C1_175875602;
                tmp0 *= C0_298631336;
                tmp1 *= C2_053119869;
                tmp2 *= C3_072711026;
                tmp3 *= C1_501321110;
                z1 *= -C0_899976223;
                z2 *= -C2_562915447;
                z3 *= -C1_961570560;
                z4 *= -C0_390180644;
                z3 += z5;
                z4 += z5;
                tmp0 += z1 + z3;
                tmp1 += z2 + z4;
                tmp2 += z2 + z3;
                tmp3 += z1 + z4;
                const int sh = CB - P1;
                const int64_t rnd = int64_t(1) << (sh - 1);
                ws[8 * 0 + c] = static_cast<int>((tmp10 + tmp3 + rnd) >> sh);
                ws[8 * 7 + c] = static_cast<int>((tmp10 - tmp3 + rnd) >> sh);
                ws[8 * 1 + c] = static_cast<int>((tmp11 + tmp2 + rnd) >> sh);
                ws[8 * 6 + c] = static_cast<int>((tmp11 - tmp2 + rnd) >> sh);
                ws[8 * 2 + c] = static_cast<int>((tmp12 + tmp1 + rnd) >> sh);
                ws[8 * 5 + c] = static_cast<int>((tmp12 - tmp1 + rnd) >> sh);
                ws[8 * 3 + c] = static_cast<int>((tmp13 + tmp0 + rnd) >> sh);
                ws[8 * 4 + c] = static_cast<int>((tmp13 - tmp0 + rnd) >> sh);
            }
            for (int r = 0; r < 8; ++r) {
                const int* w = ws + 8 * r;
                int64_t z2 = w[2], z3 = w[6];
                int64_t z1 = (z2 + z3) * C0_541196100;
                int64_t tmp2 = z1 + z3 * -C1_847759065;
                int64_t tmp3 = z1 + z2 * C0_765366865;
                int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << CB);
                int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << CB);
                const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
                const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
                tmp0 = w[7];
                tmp1 = w[5];
                tmp2 = w[3];
                tmp3 = w[1];
                z1 = tmp0 + tmp3;
                z2 = tmp1 + tmp2;
                z3 = tmp0 + tmp2;
                int64_t z4 = tmp1 + tmp3;
                const int64_t z5 = (z3 + z4) * C1_175875602;
                tmp0 *= C0_298631336;
                tmp1 *= C2_053119869;
                tmp2 *= C3_072711026;
                tmp3 *= C1_501321110;
                z1 *= -C0_899976223;
                z2 *= -C2_562915447;
                z3 *= -C1_961570560;
                z4 *= -C0_390180644;
                z3 += z5;
                z4 += z5;
                tmp0 += z1 + z3;
                tmp1 += z2 + z4;
                tmp2 += z2 + z3;
                tmp3 += z1 + z4;
                const int sh = CB + P1 + 3;
                const int64_t rnd = int64_t(1) << (sh - 1);
                uint8_t* o = out + (static_cast<int64_t>(by) * 8 + r) * stride + bx * 8;
                o[0] = limit[((tmp10 + tmp3 + rnd) >> sh) & 1023];
                o[7] = limit[((tmp10 - tmp3 + rnd) >> sh) & 1023];
                o[1] = limit[((tmp11 + tmp2 + rnd) >> sh) & 1023];
                o[6] = limit[((tmp11 - tmp2 + rnd) >> sh) & 1023];
                o[2] = limit[((tmp12 + tmp1 + rnd) >> sh) & 1023];
                o[5] = limit[((tmp12 - tmp1 + rnd) >> sh) & 1023];
                o[3] = limit[((tmp13 + tmp0 + rnd) >> sh) & 1023];
                o[4] = limit[((tmp13 - tmp0 + rnd) >> sh) & 1023];
            }
        }
    }
}

// TIFF LZW: MSB-first codes of 9 to 12 bits, 256 clears the table, 257
// ends the data, the code width grows one code early (libtiff's
// LZWDecode). Writes at most `expected` bytes to `out`; returns the count,
// or -1 on a code that is not in the table.
int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t expected) {
    static thread_local int32_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local int32_t length[4096];
    static thread_local uint8_t stack[4096];
    for (int i = 0; i < 256; ++i) {
        prefix[i] = -1;
        suffix[i] = first[i] = static_cast<uint8_t>(i);
        length[i] = 1;
    }
    int next = 258, width = 9, prev = -1;
    uint32_t acc = 0;
    int nacc = 0;
    int64_t pos = 0, o = 0;
    while (o < expected) {
        while (nacc < width && pos < n) {
            acc = (acc << 8) | in[pos++];
            nacc += 8;
        }
        if (nacc < width) break;
        const int code = static_cast<int>((acc >> (nacc - width)) & ((1u << width) - 1));
        nacc -= width;
        if (code == 257) break;
        if (code == 256) {
            next = 258;
            width = 9;
            prev = -1;
            continue;
        }
        int cur;
        if (code < next) {
            cur = code;
            if (prev >= 0 && next < 4096) {
                prefix[next] = prev;
                suffix[next] = first[code];
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                ++next;
            }
        } else if (code == next && prev >= 0 && next < 4096) {
            prefix[next] = prev;
            suffix[next] = first[prev];
            first[next] = first[prev];
            length[next] = length[prev] + 1;
            cur = next++;
        } else {
            return -1;
        }
        int k = 0;
        for (int c = cur; c >= 0; c = prefix[c]) stack[k++] = suffix[c];
        while (k > 0 && o < expected) out[o++] = stack[--k];
        prev = cur;
        if (next + 1 >= (1 << width) && width < 12) ++width;
    }
    return o;
}

}  // extern "C"
