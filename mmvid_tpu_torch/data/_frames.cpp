// Host core of the port's media I/O, with no external headers:
//   * data/png.py: PNG row unfiltering and Pillow's BILINEAR resize of
//     8-bit images;
//   * data/jpeg.py: the JPEG entropy decoder (Huffman, sequential and
//     progressive scans), libjpeg's islow IDCT, and its fancy upsampling
//     and YCbCr -> RGB conversion;
//   * utils/gif.py: the GIF encoder's median-cut palette, nearest-colour
//     mapping and LZW coder.
//
// Built by g++ at first use and called through ctypes, which releases the
// GIL, so the loader's threads decode frames (and a writer thread encodes
// GIFs) beside the interpreter.  Each stage has a plain numpy / Python
// version beside it (unfilter_plain, resize_plain, jpeg.*_plain,
// gif.*_plain) that the tests hold it against byte for byte.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// The PNG Paeth predictor, p = a + b - c written out so the compiler
// can select without branches.
inline int paeth(int a, int b, int c) {
    int pa = std::abs(b - c), pb = std::abs(a - c);
    int pc = std::abs(a + b - 2 * c);
    int bc = pb <= pc ? b : c;
    return (pa <= pb && pa <= pc) ? a : bc;
}

// Pillow's Resample.c: a triangle filter of support 1, widened by the
// downscale factor; coefficients in double, then in fixed point with
// PRECISION_BITS fraction bits.
constexpr int PRECISION_BITS = 32 - 8 - 2;

inline double bilinear(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

int precompute(int in_size, int out_size, std::vector<int> &bounds,
               std::vector<int32_t> &coeffs) {
    double scale = (double)(float)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;
    int ksize = (int)std::ceil(support) * 2 + 1;
    bounds.assign(out_size * 2, 0);
    coeffs.assign((size_t)out_size * ksize, 0);
    std::vector<double> k(ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = 0.0 + (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; x++) {
            double w = bilinear((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < ksize; x++) {
            double v = x < xmax ? (ww != 0.0 ? k[x] / ww : k[x]) : 0.0;
            coeffs[(size_t)xx * ksize + x] =
                v < 0 ? (int32_t)(-0.5 + v * (1 << PRECISION_BITS))
                      : (int32_t)(0.5 + v * (1 << PRECISION_BITS));
        }
        bounds[xx * 2] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    return ksize;
}

inline uint8_t clip8(int64_t in) {
    if (in >= ((int64_t)1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

}  // namespace

extern "C" {

// Undo the PNG filters of ``h`` rows of ``stride`` bytes, each row led by
// its filter type byte, ``bpp`` bytes a pixel.  Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4.
int frames_unfilter(const uint8_t *in, uint8_t *out, int64_t h,
                    int64_t stride, int bpp) {
    for (int64_t y = 0; y < h; y++) {
        const uint8_t *src = in + y * (stride + 1);
        int ft = src[0];
        src += 1;
        uint8_t *row = out + y * stride;
        const uint8_t *up = y ? row - stride : nullptr;
        switch (ft) {
        case 0:
            for (int64_t x = 0; x < stride; x++) row[x] = src[x];
            break;
        case 1:
            for (int64_t x = 0; x < stride; x++)
                row[x] = src[x] + (x >= bpp ? row[x - bpp] : 0);
            break;
        case 2:
            for (int64_t x = 0; x < stride; x++)
                row[x] = src[x] + (up ? up[x] : 0);
            break;
        case 3:
            for (int64_t x = 0; x < stride; x++) {
                int a = x >= bpp ? row[x - bpp] : 0;
                int b = up ? up[x] : 0;
                row[x] = (uint8_t)(src[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < stride; x++) {
                int a = x >= bpp ? row[x - bpp] : 0;
                int b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                row[x] = (uint8_t)(src[x] + paeth(a, b, c));
            }
            break;
        default:
            return (int)(y + 1);
        }
    }
    return 0;
}

// Pillow's Image.resize((out_w, out_h), BILINEAR) of an 8-bit image
// [in_h, in_w, c]: a horizontal pass over the rows the vertical pass
// reads, rounded to 8 bits, then the vertical pass; a pass is skipped
// where its size does not change.
void frames_resize(const uint8_t *in, int64_t in_h, int64_t in_w, int c,
                   uint8_t *out, int64_t out_h, int64_t out_w) {
    std::vector<int> bh, bv;
    std::vector<int32_t> kh, kv;
    int ksh = precompute((int)in_w, (int)out_w, bh, kh);
    int ksv = precompute((int)in_h, (int)out_h, bv, kv);
    bool need_h = out_w != in_w, need_v = out_h != in_h;
    int64_t y_first = bv[0];
    int64_t y_last = bv[(out_h - 1) * 2] + bv[(out_h - 1) * 2 + 1];
    std::vector<uint8_t> tmp;
    const uint8_t *src = in;
    int64_t rows = in_h;
    if (need_h) {
        rows = y_last - y_first;
        tmp.resize((size_t)rows * out_w * c);
        for (int64_t y = 0; y < rows; y++) {
            const uint8_t *line = in + (y + y_first) * in_w * c;
            for (int64_t xx = 0; xx < out_w; xx++) {
                int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
                const int32_t *k = &kh[(size_t)xx * ksh];
                for (int ch = 0; ch < c; ch++) {
                    int64_t ss = 1 << (PRECISION_BITS - 1);
                    for (int x = 0; x < xmax; x++)
                        ss += (int64_t)line[(x + xmin) * c + ch] * k[x];
                    tmp[(y * out_w + xx) * c + ch] = clip8(ss);
                }
            }
        }
        src = tmp.data();
    } else {
        y_first = 0;
    }
    int64_t w = need_h ? out_w : in_w;
    if (!need_v) {
        for (int64_t i = 0; i < out_h * w * c; i++) out[i] = src[i];
        return;
    }
    for (int64_t yy = 0; yy < out_h; yy++) {
        int ymin = bv[yy * 2] - (int)y_first, ymax = bv[yy * 2 + 1];
        const int32_t *k = &kv[(size_t)yy * ksv];
        for (int64_t i = 0; i < w * c; i++) {
            int64_t ss = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss += (int64_t)src[(y + ymin) * w * c + i] * k[y];
            out[yy * w * c + i] = clip8(ss);
        }
    }
}

}  // extern "C"

// -- JPEG ---------------------------------------------------------------------
//
// What libjpeg-turbo does by default, and so Pillow's JPEG decode: the
// JDCT_ISLOW integer IDCT of jidctint.c, fancy upsampling (jdsample.c) and
// jdcolor.c's fixed-point YCbCr -> RGB.  data/jpeg.py parses the markers
// and hands each scan's entropy-coded bytes to frames_jpeg_scan.

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A Huffman table as the decoder walks it: canonical codes by length,
// and an 8-bit lookahead of (length << 8) | symbol, 0 where the code is
// longer than 8 bits.
struct Huff {
    int32_t maxcode[17];
    int32_t valptr[17];
    int32_t mincode[17];
    uint8_t vals[256];
    uint16_t look[256];
};

void build_huff(const uint8_t *bits, const uint8_t *vals, Huff &h) {
    int code = 0, k = 0;
    std::memcpy(h.vals, vals, 256);
    std::memset(h.look, 0, sizeof(h.look));
    for (int l = 1; l <= 16; l++) {
        int n = bits[l - 1];
        h.valptr[l] = k;
        h.mincode[l] = code;
        for (int i = 0; i < n && k < 256; i++, k++, code++) {
            if (l <= 8 && code < (1 << l)) {
                int shift = 8 - l;
                for (int j = 0; j < (1 << shift); j++)
                    h.look[(code << shift) | j] =
                        (uint16_t)((l << 8) | vals[k]);
            }
        }
        h.maxcode[l] = n ? code - 1 : -1;
        code <<= 1;
    }
}

// The entropy-coded bytes of a scan: 0xFF 0x00 is a data byte 0xFF and
// fill bytes 0xFF are skipped; at any other marker, or the end, the
// reader stops and feeds zero bits.  Those are counted, so a scan that
// needs bits the file does not hold is reported as damaged.
struct Bits {
    const uint8_t *p, *end;
    uint64_t buf = 0;     // left-aligned
    int n = 0;            // valid bits in buf
    int64_t padded = 0;   // zero bits fed past the data
    bool stop = false;

    void fill() {
        while (n <= 56) {
            int byte = -1;
            if (!stop) {
                if (p >= end) {
                    stop = true;
                } else if (*p != 0xFF) {
                    byte = *p++;
                } else {
                    const uint8_t *q = p + 1;
                    while (q < end && *q == 0xFF) q++;
                    if (q < end && *q == 0x00) {
                        byte = 0xFF;
                        p = q + 1;
                    } else {
                        stop = true;   // p on the 0xFF before the code
                        p = q - 1;
                    }
                }
            }
            if (byte < 0) {
                byte = 0;
                padded += 8;
            }
            buf |= (uint64_t)byte << (56 - n);
            n += 8;
        }
    }
    int get(int k) {
        if (k == 0) return 0;
        if (n < k) fill();
        int v = (int)(buf >> (64 - k));
        buf <<= k;
        n -= k;
        return v;
    }
    bool overrun() const { return padded > n; }
};

inline int decode(Bits &b, const Huff &h) {
    if (b.n < 16) b.fill();
    int e = h.look[b.buf >> 56];
    if (e) {
        b.buf <<= e >> 8;
        b.n -= e >> 8;
        return e & 0xFF;
    }
    int code = 0;
    for (int l = 1; l <= 16; l++) {
        code = (code << 1) | (int)((b.buf >> (64 - l)) & 1);
        if (code <= h.maxcode[l]) {
            b.buf <<= l;
            b.n -= l;
            int i = h.valptr[l] + code - h.mincode[l];
            return i < 256 ? h.vals[i] : -1;
        }
    }
    return -1;
}

inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

enum { JPEG_OK = 0, JPEG_BAD_CODE = 1, JPEG_SHORT = 2, JPEG_BAD_RST = 3,
       JPEG_BAD_INDEX = 4 };

struct ScanComp {
    int64_t off, bw;
    int h, v, dc, ac, cols, rows;
};

// One block of a scan, by the scan's kind (jdhuff.c decode_mcu,
// jdphuff.c's four decode_mcu_*).
int decode_block(Bits &b, int16_t *blk, const Huff &dc, const Huff &ac,
                 int &pred, int &eobrun, int progressive, int ss, int se,
                 int ah, int al) {
    if (!progressive) {
        int s = decode(b, dc);
        if (s < 0) return JPEG_BAD_CODE;
        if (s) s = extend(b.get(s), s);
        pred += s;
        blk[0] = (int16_t)pred;
        for (int k = 1; k < 64; k++) {
            int rs = decode(b, ac);
            if (rs < 0) return JPEG_BAD_CODE;
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) return JPEG_BAD_INDEX;
                blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return JPEG_OK;
    }
    if (ss == 0) {   // DC scans
        if (ah == 0) {
            int s = decode(b, dc);
            if (s < 0) return JPEG_BAD_CODE;
            if (s) s = extend(b.get(s), s);
            pred += s;
            blk[0] = (int16_t)(pred * (1 << al));
        } else if (b.get(1)) {
            blk[0] = (int16_t)(blk[0] | (1 << al));
        }
        return JPEG_OK;
    }
    if (ah == 0) {   // AC first
        if (eobrun > 0) {
            eobrun--;
            return JPEG_OK;
        }
        for (int k = ss; k <= se; k++) {
            int rs = decode(b, ac);
            if (rs < 0) return JPEG_BAD_CODE;
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) return JPEG_BAD_INDEX;
                blk[kNatural[k]] = (int16_t)(extend(b.get(s), s) * (1 << al));
            } else {
                if (r == 15) {
                    k += 15;
                } else {
                    eobrun = (1 << r) - 1;
                    if (r) eobrun += b.get(r);
                    break;
                }
            }
        }
        return JPEG_OK;
    }
    // AC refinement
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun == 0) {
        for (; k <= se; k++) {
            int rs = decode(b, ac);
            if (rs < 0) return JPEG_BAD_CODE;
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = b.get(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += b.get(r);
                break;
            }
            do {
                int16_t *c = blk + kNatural[k];
                if (*c != 0) {
                    if (b.get(1) && (*c & p1) == 0)
                        *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                } else {
                    if (--r < 0) break;
                }
                k++;
            } while (k <= se);
            if (s) {
                if (k > 63) return JPEG_BAD_INDEX;
                blk[kNatural[k]] = (int16_t)s;
            }
        }
    }
    if (eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *c = blk + kNatural[k];
            if (*c != 0 && b.get(1) && (*c & p1) == 0)
                *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
        eobrun--;
    }
    return JPEG_OK;
}

// After a restart interval: the bits left belong to the interval's
// padding; the RSTn marker comes next (garbage before it is skipped, as
// libjpeg's next_marker does).
int restart(Bits &b, int expect) {
    if (b.overrun()) return JPEG_SHORT;
    const uint8_t *q = b.p;
    for (;;) {
        while (q < b.end && *q != 0xFF) q++;
        while (q < b.end && *q == 0xFF) q++;
        if (q >= b.end) return JPEG_SHORT;
        if (*q != 0x00) break;
        q++;
    }
    if (*q != 0xD0 + expect) return JPEG_BAD_RST;
    b.p = q + 1;
    b.buf = 0;
    b.n = 0;
    b.padded = 0;
    b.stop = false;
    return JPEG_OK;
}

// jidctint.c's jpeg_idct_islow on one dequantized block.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
    int t = (int)(x & 1023);   // libjpeg's post-IDCT range-limit table
    if (t < 128) return (uint8_t)(t + 128);
    if (t < 512) return 255;
    if (t < 896) return 0;
    return (uint8_t)(t - 896);
}

// The even and odd parts of one 8-point pass over in[0..7] (stride st),
// results in out[0..7] before the pass's descale.
inline void idct_1d(const int64_t *in, int64_t *out) {
    int64_t z2 = in[2], z3 = in[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0];
    z3 = in[4];
    int64_t tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[7];
    tmp1 = in[5];
    tmp2 = in[3];
    tmp3 = in[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    out[0] = tmp10 + tmp3;
    out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2;
    out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1;
    out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0;
    out[4] = tmp13 - tmp0;
}

void idct_block(const int16_t *coef, const uint16_t *q, uint8_t *out,
                int64_t stride) {
    int64_t ws[64], in[8], res[8];
    for (int c = 0; c < 8; c++) {   // pass 1: columns
        for (int r = 0; r < 8; r++)
            in[r] = (int64_t)coef[r * 8 + c] * q[r * 8 + c];
        idct_1d(in, res);
        for (int r = 0; r < 8; r++)
            ws[r * 8 + c] = (int)descale(res[r], CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {   // pass 2: rows
        idct_1d(ws + r * 8, res);
        for (int c = 0; c < 8; c++)
            out[r * stride + c] =
                idct_limit(descale(res[c], CONST_BITS + PASS1_BITS + 3));
    }
}

inline uint8_t clamp255(int x) {
    return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
}

inline int64_t fix16(double x) { return (int64_t)(x * 65536.0 + 0.5); }

}  // namespace

extern "C" {

// Decode one scan's entropy-coded bytes into the coefficient blocks.
// prm: ncomp, Ss, Se, Ah, Al, restart interval (MCUs, 0 for none),
// MCUs across, MCUs down, progressive; then for each scan component its
// first block, blocks a buffer row, h, v, DC table, AC table, blocks
// across and down (for a one-component scan).  huff: 8 tables (0-3 DC,
// 4-7 AC) of 16 code counts and 256 symbols.  coef: int16 blocks of 64
// in natural order, updated in place.  Returns a JPEG_* code.
int frames_jpeg_scan(const uint8_t *data, int64_t n, const int64_t *prm,
                     const uint8_t *huff, int16_t *coef) {
    int ncomp = (int)prm[0], ss = (int)prm[1], se = (int)prm[2];
    int ah = (int)prm[3], al = (int)prm[4];
    int64_t interval = prm[5], mx = prm[6], my = prm[7];
    int progressive = (int)prm[8];
    ScanComp comps[4];
    for (int i = 0; i < ncomp; i++) {
        const int64_t *c = prm + 9 + i * 8;
        comps[i] = {c[0], c[1], (int)c[2], (int)c[3], (int)c[4], (int)c[5],
                    (int)c[6], (int)c[7]};
    }
    std::vector<Huff> tabs(8);
    for (int t = 0; t < 8; t++)
        build_huff(huff + t * 272, huff + t * 272 + 16, tabs[t]);
    Bits b;
    b.p = data;
    b.end = data + n;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0, rst = 0;
    int64_t total = ncomp == 1 ? (int64_t)comps[0].cols * comps[0].rows
                               : mx * my;
    for (int64_t m = 0; m < total; m++) {
        if (interval && m && m % interval == 0) {
            int err = restart(b, rst);
            if (err) return err;
            rst = (rst + 1) & 7;
            for (int i = 0; i < 4; i++) pred[i] = 0;
            eobrun = 0;
        }
        for (int i = 0; i < ncomp; i++) {
            const ScanComp &c = comps[i];
            const Huff &dc = tabs[c.dc], &ac = tabs[4 + c.ac];
            if (ncomp == 1) {
                int64_t r = m / c.cols, col = m % c.cols;
                int16_t *blk = coef + (c.off + r * c.bw + col) * 64;
                int err = decode_block(b, blk, dc, ac, pred[i], eobrun,
                                       progressive, ss, se, ah, al);
                if (err) return err;
                continue;
            }
            int64_t r0 = (m / mx) * c.v, c0 = (m % mx) * c.h;
            for (int v = 0; v < c.v; v++)
                for (int h = 0; h < c.h; h++) {
                    int16_t *blk =
                        coef + (c.off + (r0 + v) * c.bw + c0 + h) * 64;
                    int err = decode_block(b, blk, dc, ac, pred[i], eobrun,
                                           progressive, ss, se, ah, al);
                    if (err) return err;
                }
        }
        if (b.overrun()) return JPEG_SHORT;
    }
    return b.overrun() ? JPEG_SHORT : JPEG_OK;
}

// Dequantize and inverse-transform [bh, bw] blocks (natural order) into
// the plane [bh * 8, bw * 8]; q: the 64 quantization steps, natural order.
void frames_jpeg_idct(const int16_t *coef, int64_t bh, int64_t bw,
                      const uint16_t *q, uint8_t *out) {
    for (int64_t r = 0; r < bh; r++)
        for (int64_t c = 0; c < bw; c++)
            idct_block(coef + (r * bw + c) * 64, q,
                       out + r * 8 * bw * 8 + c * 8, bw * 8);
}

// Upsample each component plane to [H, W] (jdsample.c: fancy h2v1, h1v2
// and h2v2 where libjpeg-turbo takes them, box replication otherwise)
// and convert to RGB.  prm: ncomp (1 or 3), W, H, Hmax, Vmax, transform
// (0: the components are R, G, B; 1: YCbCr); then for each component its
// byte offset in planes, row stride, h, v, downsampled width and
// height.  out: uint8 [H, W, 3].
void frames_jpeg_color(const uint8_t *planes, const int64_t *prm,
                       uint8_t *out) {
    int ncomp = (int)prm[0];
    int64_t W = prm[1], H = prm[2];
    int hmax = (int)prm[3], vmax = (int)prm[4], ycc = (int)prm[5];
    std::vector<uint8_t> full((size_t)ncomp * W * H);
    std::vector<int> colsum;
    for (int ci = 0; ci < ncomp; ci++) {
        const int64_t *c = prm + 6 + ci * 6;
        const uint8_t *src = planes + c[0];
        int64_t stride = c[1], dw = c[4], dh = c[5];
        int hr = hmax / (int)c[2], vr = vmax / (int)c[3];
        uint8_t *dst = full.data() + (size_t)ci * W * H;
        bool fancy_h = dw > 2;
        for (int64_t y = 0; y < H; y++) {
            uint8_t *o = dst + y * W;
            if (hr == 1 && vr == 1) {
                std::memcpy(o, src + y * stride, W);
            } else if (hr == 2 && vr == 1 && fancy_h) {
                const uint8_t *in = src + y * stride;
                for (int64_t x = 0; x < W; x++) {
                    int64_t i = x >> 1;
                    int v3 = in[i] * 3;
                    o[x] = (x & 1)
                        ? (uint8_t)((v3 + in[i + 1 < dw ? i + 1 : i] + 2) >> 2)
                        : (uint8_t)((v3 + in[i ? i - 1 : 0] + 1) >> 2);
                }
            } else if (hr == 1 && vr == 2) {
                int64_t i = y >> 1;
                int64_t nb = (y & 1) ? (i + 1 < dh ? i + 1 : i)
                                     : (i ? i - 1 : 0);
                int bias = (y & 1) ? 2 : 1;
                const uint8_t *a = src + i * stride, *b = src + nb * stride;
                for (int64_t x = 0; x < W; x++)
                    o[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
            } else if (hr == 2 && vr == 2 && fancy_h) {
                int64_t i = y >> 1;
                int64_t nb = (y & 1) ? (i + 1 < dh ? i + 1 : i)
                                     : (i ? i - 1 : 0);
                const uint8_t *a = src + i * stride, *b = src + nb * stride;
                colsum.resize(dw);
                for (int64_t j = 0; j < dw; j++) colsum[j] = a[j] * 3 + b[j];
                for (int64_t x = 0; x < W; x++) {
                    int64_t j = x >> 1;
                    int t3 = colsum[j] * 3;
                    o[x] = (x & 1)
                        ? (uint8_t)((t3 + colsum[j + 1 < dw ? j + 1 : j] + 7)
                                    >> 4)
                        : (uint8_t)((t3 + colsum[j ? j - 1 : 0] + 8) >> 4);
                }
            } else {
                const uint8_t *in = src + (y / vr) * stride;
                for (int64_t x = 0; x < W; x++) o[x] = in[x / hr];
            }
        }
    }
    if (ncomp == 1) {
        for (int64_t i = 0; i < W * H; i++)
            out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = full[i];
        return;
    }
    const uint8_t *c0 = full.data(), *c1 = c0 + W * H, *c2 = c1 + W * H;
    if (!ycc) {
        for (int64_t i = 0; i < W * H; i++) {
            out[i * 3] = c0[i];
            out[i * 3 + 1] = c1[i];
            out[i * 3 + 2] = c2[i];
        }
        return;
    }
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int)((fix16(1.40200) * x + 32768) >> 16);
        cb_b[i] = (int)((fix16(1.77200) * x + 32768) >> 16);
        cr_g[i] = -fix16(0.71414) * x;
        cb_g[i] = -fix16(0.34414) * x + 32768;
    }
    for (int64_t i = 0; i < W * H; i++) {
        int y = c0[i], cb = c1[i], cr = c2[i];
        out[i * 3] = clamp255(y + cr_r[cr]);
        out[i * 3 + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        out[i * 3 + 2] = clamp255(y + cb_b[cb]);
    }
}

}  // extern "C"

// -- GIF ----------------------------------------------------------------------
//
// utils/gif.py: each frame's palette by a median cut of its colours, each
// pixel mapped to the nearest palette entry, the indices LZW-coded.

namespace {

struct Box {
    int64_t lo, hi, n;
    int64_t s1[3], s2[3];
    __int128 num;   // n * the squared error, summed over the channels
};

void box_stats(Box &bx, const uint32_t *col, const int64_t *cnt) {
    bx.n = 0;
    for (int c = 0; c < 3; c++) bx.s1[c] = bx.s2[c] = 0;
    for (int64_t i = bx.lo; i < bx.hi; i++) {
        bx.n += cnt[i];
        for (int c = 0; c < 3; c++) {
            int64_t v = (col[i] >> (16 - 8 * c)) & 255;
            bx.s1[c] += v * cnt[i];
            bx.s2[c] += v * v * cnt[i];
        }
    }
    bx.num = 0;
    for (int c = 0; c < 3; c++)
        bx.num += (__int128)bx.n * bx.s2[c] - (__int128)bx.s1[c] * bx.s1[c];
}

// n * (sum of squared deviations) of one channel
inline __int128 spread(const Box &b, int c) {
    return (__int128)b.n * b.s2[c] - (__int128)b.s1[c] * b.s1[c];
}

// Order m colours (and their counts) by (channel, packed colour): an LSD
// radix sort of the 32-bit key channel << 24 | colour, a byte a pass.
void radix_by(uint32_t *col, int64_t *cnt, int64_t m, int axis) {
    std::vector<uint32_t> key(m), key2(m);
    std::vector<int64_t> tc(cnt, cnt + m), cnt2(m);
    for (int64_t i = 0; i < m; i++)
        key[i] = (((col[i] >> (16 - 8 * axis)) & 255) << 24) | col[i];
    for (int pass = 0; pass < 4; pass++) {
        int shift = 8 * pass;
        int64_t hist[257] = {0};
        for (int64_t i = 0; i < m; i++) hist[((key[i] >> shift) & 255) + 1]++;
        bool one = false;
        for (int k = 1; k <= 256; k++) one |= hist[k] == m;
        if (one) continue;
        for (int k = 0; k < 256; k++) hist[k + 1] += hist[k];
        for (int64_t i = 0; i < m; i++) {
            int64_t at = hist[(key[i] >> shift) & 255]++;
            key2[at] = key[i];
            cnt2[at] = tc[i];
        }
        key.swap(key2);
        tc.swap(cnt2);
    }
    for (int64_t i = 0; i < m; i++) {
        col[i] = key[i] & 0xFFFFFF;
        cnt[i] = tc[i];
    }
}

}  // namespace

extern "C" {

// Median cut of n RGB pixels into at most 256 colours.  The unique
// colours (packed 0xRRGGBB, ascending) form one box; while fewer than
// 256 boxes, the box of the largest squared error that holds two or more
// colours (the first on ties) is split along its channel of the largest
// spread (the lowest on ties), its colours ordered by (that channel,
// packed colour), before the first colour at which the boxes' pixel
// count reaches half (at most the last).  palette [256, 3]: each box's
// rounded mean, the rest 0.  Returns the number of colours.
int frames_gif_palette(const uint8_t *rgb, int64_t n, uint8_t *palette) {
    std::vector<uint32_t> keys(n);
    std::vector<int64_t> ones(n, 1);
    for (int64_t i = 0; i < n; i++)
        keys[i] = ((uint32_t)rgb[i * 3] << 16) | (rgb[i * 3 + 1] << 8) |
                  rgb[i * 3 + 2];
    radix_by(keys.data(), ones.data(), n, 0);   // ascending
    std::vector<uint32_t> col;
    std::vector<int64_t> cnt;
    for (int64_t i = 0; i < n; i++) {
        if (col.empty() || col.back() != keys[i]) {
            col.push_back(keys[i]);
            cnt.push_back(1);
        } else {
            cnt.back()++;
        }
    }
    std::vector<Box> boxes;
    std::memset(palette, 0, 256 * 3);
    if (col.empty()) return 0;
    Box first{0, (int64_t)col.size(), 0, {0, 0, 0}, {0, 0, 0}, 0};
    box_stats(first, col.data(), cnt.data());
    boxes.push_back(first);
    while (boxes.size() < 256) {
        int best = -1;
        __int128 bnum = 0;
        int64_t bn = 1;
        for (size_t i = 0; i < boxes.size(); i++) {
            const Box &b = boxes[i];
            if (b.hi - b.lo < 2) continue;
            if (best < 0 || b.num * bn > bnum * b.n) {
                best = (int)i;
                bnum = b.num;
                bn = b.n;
            }
        }
        if (best < 0) break;
        Box &b = boxes[best];
        int axis = 0;
        for (int c = 1; c < 3; c++)
            if (spread(b, c) > spread(b, axis)) axis = c;
        int64_t m = b.hi - b.lo;
        radix_by(col.data() + b.lo, cnt.data() + b.lo, m, axis);
        int64_t cum = 0, cut = m - 1;
        for (int64_t i = 1; i < m; i++) {
            cum += cnt[b.lo + i - 1];
            if (2 * cum >= b.n) {
                cut = i;
                break;
            }
        }
        Box right{b.lo + cut, b.hi, 0, {0, 0, 0}, {0, 0, 0}, 0};
        b.hi = b.lo + cut;
        box_stats(b, col.data(), cnt.data());
        box_stats(right, col.data(), cnt.data());
        boxes.push_back(right);
    }
    for (size_t i = 0; i < boxes.size(); i++)
        for (int c = 0; c < 3; c++)
            palette[i * 3 + c] =
                (uint8_t)((boxes[i].s1[c] + boxes[i].n / 2) / boxes[i].n);
    return (int)boxes.size();
}

// The palette entry nearest each pixel (squared distance; the lowest
// index on ties).
void frames_gif_map(const uint8_t *rgb, int64_t n, const uint8_t *palette,
                    int ncolors, uint8_t *index) {
    // entries ordered by red, searched outward from the pixel's red until
    // the red gap alone exceeds the best distance
    std::vector<int> byr(ncolors);
    for (int i = 0; i < ncolors; i++) byr[i] = i;
    std::stable_sort(byr.begin(), byr.end(), [&](int a, int b) {
        return palette[a * 3] < palette[b * 3];
    });
    std::vector<int> reds(ncolors);
    for (int i = 0; i < ncolors; i++) reds[i] = palette[byr[i] * 3];
    // a cache of the last answers by packed colour
    const int CACHE = 1 << 14;
    std::vector<uint32_t> ckey(CACHE, 0xFFFFFFFFu);
    std::vector<uint8_t> cval(CACHE);
    for (int64_t p = 0; p < n; p++) {
        int r = rgb[p * 3], g = rgb[p * 3 + 1], bl = rgb[p * 3 + 2];
        uint32_t key = ((uint32_t)r << 16) | (g << 8) | bl;
        uint32_t slot = (key * 2654435761u) >> 18;
        if (ckey[slot] == key) {
            index[p] = cval[slot];
            continue;
        }
        int start = (int)(std::lower_bound(reds.begin(), reds.end(), r) -
                          reds.begin());
        int best = -1, bd = 0;
        auto visit = [&](int j) {
            int e = byr[j];
            int dr = palette[e * 3] - r, dg = palette[e * 3 + 1] - g;
            int db = palette[e * 3 + 2] - bl;
            int d = dr * dr + dg * dg + db * db;
            if (best < 0 || d < bd || (d == bd && e < best)) {
                best = e;
                bd = d;
            }
        };
        for (int lo = start - 1, hi = start; lo >= 0 || hi < ncolors;) {
            bool any = false;
            if (hi < ncolors) {
                int dr = reds[hi] - r;
                if (best < 0 || dr * dr <= bd) {
                    visit(hi);
                    any = true;
                }
                hi++;
                if (!any) hi = ncolors;
            }
            bool any_lo = false;
            if (lo >= 0) {
                int dr = r - reds[lo];
                if (best < 0 || dr * dr <= bd) {
                    visit(lo);
                    any_lo = true;
                }
                lo--;
                if (!any_lo) lo = -1;
            }
        }
        uint8_t v = (uint8_t)(best < 0 ? 0 : best);
        index[p] = v;
        ckey[slot] = key;
        cval[slot] = v;
    }
}

// GIF's variable-length LZW of n indices at code size 8 (clear 256, end
// 257), codes packed LSB first: a clear first, the code size grown when
// the entry just made is 2^size (up to 12 bits), a clear when the table
// is full.  out holds 2 n + 64 bytes; returns the bytes written.
int64_t frames_gif_lzw(const uint8_t *index, int64_t n, uint8_t *out) {
    const int CLEAR = 256, END = 257;
    std::vector<uint16_t> child((size_t)4096 * 256, 0);
    int64_t len = 0;
    uint32_t acc = 0;
    int nacc = 0, size = 9, next = 258;
    auto emit = [&](int code) {
        acc |= (uint32_t)code << nacc;
        nacc += size;
        while (nacc >= 8) {
            out[len++] = (uint8_t)(acc & 255);
            acc >>= 8;
            nacc -= 8;
        }
    };
    emit(CLEAR);
    if (n > 0) {
        int w = index[0];
        for (int64_t i = 1; i < n; i++) {
            int c = index[i];
            uint16_t k = child[(size_t)w * 256 + c];
            if (k) {
                w = k;
                continue;
            }
            emit(w);
            if (next < 4096) {
                child[(size_t)w * 256 + c] = (uint16_t)next;
                if (next == (1 << size) && size < 12) size++;
                next++;
            } else {
                emit(CLEAR);
                std::fill(child.begin(), child.end(), 0);
                size = 9;
                next = 258;
            }
            w = c;
        }
        emit(w);
        if (next < 4096 && next == (1 << size) && size < 12) size++;
    }
    emit(END);
    if (nacc > 0) out[len++] = (uint8_t)(acc & 255);
    return len;
}

}  // extern "C"
