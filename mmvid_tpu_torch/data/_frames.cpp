// Host core of mmvid_tpu_torch/data/png.py: PNG row unfiltering and
// Pillow's BILINEAR resize of 8-bit images, with no external headers.
//
// Built by g++ at first use and called through ctypes, which releases the
// GIL, so the loader's threads decode frames in parallel.  The plain
// versions that the tests hold these against are png.py's
// unfilter_plain / resize_plain; both must give the same bytes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
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
