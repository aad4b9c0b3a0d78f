// mipops — native host-side image preprocessing for colormipsearch_tpu.
//
// The accelerator owns the pair-sweep compute; this library owns the host data
// path that feeds it (the role the reference fills with hand-tuned Java
// inner loops, e.g. imageprocessing/ImageTransformation.java:201-535 and
// ImageArrayUtils.packBitsUncompress, ImageArrayUtils.java:229-258):
//
//  - circular-kernel max filter (ImageJ RankFilters geometry incl. the
//    makeLineRadii radius snapping) as an O(N) monotonic-deque sliding
//    max per distinct row extent
//  - packed scorer-plane construction (the int32 word layout of
//    cds/pixel_kernel.py) straight from interleaved RGB u8
//  - PackBits (TIFF compression 5) range decode
//
// Exposed with a plain C ABI for ctypes; OpenMP parallel across rows /
// images.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------- circular kernel geometry (ImageTransformation.java:549-572) ----

// writes per-row half-extents dx for rows -kR..kR into out (size >= 2*kR+1),
// returns kRadius
int make_line_radii(double radius_arg, int* out) {
    double radius;
    if (radius_arg >= 1.5 && radius_arg < 1.75) radius = 1.75;
    else if (radius_arg >= 2.5 && radius_arg < 2.85) radius = 2.85;
    else radius = radius_arg;
    int r2 = (int)(radius * radius) + 1;
    int kRadius = (int)std::sqrt(r2 + 1e-10);
    for (int y = -kRadius; y <= kRadius; y++) {
        int dx = (int)std::sqrt(r2 - y * y + 1e-10);
        out[y + kRadius] = dx;
    }
    return kRadius;
}

// ---------- sliding-window maximum (monotonic deque), window [i-e, i+e] ----

static void row_max_extent(const uint8_t* src, uint8_t* dst, int w, int e) {
    if (e <= 0) { std::memcpy(dst, src, w); return; }
    // deque of indices with decreasing values
    std::vector<int> dq(w + 2 * e + 1);
    int head = 0, tail = 0; // [head, tail)
    for (int i = -e; i < w; i++) {
        int add = i + e; // incoming index
        if (add < w) {
            while (tail > head && src[dq[tail - 1]] <= src[add]) tail--;
            dq[tail++] = add;
        }
        if (i >= 0) {
            while (tail > head && dq[head] < i - e) head++;
            dst[i] = (tail > head) ? src[dq[head]] : 0;
        }
    }
}

// circular max filter on a single u8 plane, border = clip (zeros outside)
void max_filter_u8(const uint8_t* src, uint8_t* dst, int h, int w,
                   double radius) {
    std::vector<int> dxs(2 * (int)(radius + 2) + 3);
    int kR = make_line_radii(radius, dxs.data());
    int kH = 2 * kR + 1;
    // distinct extents -> horizontal max planes
    std::vector<int> extents;
    for (int r = 0; r < kH; r++)
        if (std::find(extents.begin(), extents.end(), dxs[r]) == extents.end())
            extents.push_back(dxs[r]);
    // hmax[e][y*w + x]
    std::vector<std::vector<uint8_t>> hmax(extents.size(),
                                           std::vector<uint8_t>((size_t)h * w));
    for (size_t ei = 0; ei < extents.size(); ei++) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int y = 0; y < h; y++)
            row_max_extent(src + (size_t)y * w, hmax[ei].data() + (size_t)y * w,
                           w, extents[ei]);
    }
    // vertical combine
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < h; y++) {
        uint8_t* out = dst + (size_t)y * w;
        std::memset(out, 0, w);
        for (int r = 0; r < kH; r++) {
            int sy = y + r - kR;
            if (sy < 0 || sy >= h) continue;
            size_t ei = 0;
            while (extents[ei] != dxs[r]) ei++;
            const uint8_t* hrow = hmax[ei].data() + (size_t)sy * w;
            for (int x = 0; x < w; x++)
                out[x] = std::max(out[x], hrow[x]);
        }
    }
}

// per-channel circular max filter on interleaved RGB u8 [h, w, 3]
void max_filter_rgb(const uint8_t* src, uint8_t* dst, int h, int w,
                    double radius) {
    std::vector<uint8_t> plane((size_t)h * w), out((size_t)h * w);
    for (int c = 0; c < 3; c++) {
        for (size_t i = 0; i < (size_t)h * w; i++) plane[i] = src[i * 3 + c];
        max_filter_u8(plane.data(), out.data(), h, w, radius);
        for (size_t i = 0; i < (size_t)h * w; i++) dst[i * 3 + c] = out[i];
    }
}

// ---------- packed scorer planes (cds/pixel_kernel.py word layout) ---------

// word: b | a<<8 | sector<<16 | sel<<19 | cl<<20 | cu<<21
void pack_planes_rgb(const uint8_t* rgb, int32_t* out, int64_t n_px,
                     int threshold, const uint8_t* excluded /* nullable */) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_px; i++) {
        int r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
        int sel = (r > threshold || g > threshold || b > threshold) ? 1 : 0;
        if (excluded && excluded[i]) sel = 0;
        int sector = 0, first = 0, second = 0;
        if (b > r && b > g) {
            if (r > g) { sector = 1; first = b; second = r; }
            else { sector = 2; first = b; second = g; }
        } else if (g > b && g > r) {
            if (b > r) { sector = 3; first = g; second = b; }
            else { sector = 4; first = g; second = r; }
        } else if (r > b && r > g) {
            if (g > b) { sector = 5; first = r; second = g; }
            else { sector = 6; first = r; second = b; }
        }
        int a = (first != 0 && second != 0) ? second : 0;
        int bden = first > 1 ? first : 1;
        bool lt044 = a * 25 < 11 * bden;
        bool lt054 = a * 50 < 27 * bden;
        bool lt07 = a * 10 < 7 * bden;
        bool gt08 = a * 5 > 4 * bden;
        int cl = (sector == 2 && lt054) || (sector == 3 && gt08) ||
                 (sector == 4 && lt07) || (sector == 5 && gt08) ||
                 (sector == 6 && lt07);
        int cu = (sector == 1 && lt044) || (sector == 2 && gt08) ||
                 (sector == 3 && lt07) || (sector == 4 && gt08) ||
                 (sector == 5 && lt07);
        out[i] = bden | (a << 8) | (sector << 16) | (sel << 19) |
                 (cl << 20) | (cu << 21);
    }
}

// ---------- sparse packed scorer planes (host->device feed) ----------------

// Emit (flat index, word) pairs for ABOVE-THRESHOLD pixels only (sel=1);
// sub-threshold pixels canonicalize to word 1 (the empty-pixel word:
// bden clamps to 1) on the device-side scatter fill. Score-invariant:
// the match predicate gates on sel, the prescreen bins gate on sel, and
// the kernel's window skip reads only bit 19.
// rgb: [t, px_per_t, 3]; idx_buf/word_buf: [t * px_per_t] caller scratch;
// counts: [t] per-target pair counts (pairs are contiguous per target
// at offsets ti * px_per_t, ordered by flat index).
void sparse_pack_block(const uint8_t* rgb, int64_t t, int64_t px_per_t,
                       int threshold, int32_t* idx_buf, int32_t* word_buf,
                       int64_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t ti = 0; ti < t; ti++) {
        const uint8_t* p = rgb + ti * px_per_t * 3;
        int32_t* ib = idx_buf + ti * px_per_t;
        int32_t* wb = word_buf + ti * px_per_t;
        int64_t n = 0;
        for (int64_t i = 0; i < px_per_t; i++) {
            int r = p[i * 3], g = p[i * 3 + 1], b = p[i * 3 + 2];
            if (r <= threshold && g <= threshold && b <= threshold) continue;
            int sector = 0, first = 0, second = 0;
            if (b > r && b > g) {
                if (r > g) { sector = 1; first = b; second = r; }
                else { sector = 2; first = b; second = g; }
            } else if (g > b && g > r) {
                if (b > r) { sector = 3; first = g; second = b; }
                else { sector = 4; first = g; second = r; }
            } else if (r > b && r > g) {
                if (g > b) { sector = 5; first = r; second = g; }
                else { sector = 6; first = r; second = b; }
            }
            int a = (first != 0 && second != 0) ? second : 0;
            int bden = first > 1 ? first : 1;
            bool lt044 = a * 25 < 11 * bden;
            bool lt054 = a * 50 < 27 * bden;
            bool lt07 = a * 10 < 7 * bden;
            bool gt08 = a * 5 > 4 * bden;
            int cl = (sector == 2 && lt054) || (sector == 3 && gt08) ||
                     (sector == 4 && lt07) || (sector == 5 && gt08) ||
                     (sector == 6 && lt07);
            int cu = (sector == 1 && lt044) || (sector == 2 && gt08) ||
                     (sector == 3 && lt07) || (sector == 4 && gt08) ||
                     (sector == 5 && lt07);
            ib[n] = (int32_t)(ti * px_per_t + i);
            wb[n] = bden | (a << 8) | (sector << 16) | (1 << 19) |
                    (cl << 20) | (cu << 21);
            n++;
        }
        counts[ti] = n;
    }
}

// ---------- PackBits range decode (ImageArrayUtils.java:229-258) -----------

// returns new output offset
int64_t packbits_decode_range(const uint8_t* input, int64_t input_len,
                              uint8_t* output, int64_t output_len,
                              int64_t offset, int64_t start, int64_t end) {
    if (end == 0) end = INT64_MAX;
    int64_t index = 0, pos = offset;
    while (pos < end && pos < output_len && index < input_len) {
        int8_t n = (int8_t)input[index++];
        if (n >= 0) {
            int len = n + 1;
            if (index + len > input_len) break;
            if (pos >= start) {
                int64_t ncopy = std::min<int64_t>(len, output_len - pos);
                std::memcpy(output + pos, input + index, ncopy);
            } else if (pos + len >= start) {
                int64_t skip = start - pos;
                int64_t ncopy = std::min<int64_t>(len - skip, output_len - start);
                std::memcpy(output + start, input + index + skip, ncopy);
            }
            pos += len;
            index += len;
        } else if (n != -128) {
            int len = -n + 1;
            if (index >= input_len) break;
            uint8_t v = input[index++];
            for (int i = 0; i < len; i++) {
                if (pos >= start && pos < output_len) output[pos] = v;
                pos++;
            }
        }
    }
    return pos;
}

// ---------- gray conversion + signal (ColorTransformation.java:40-54) ------

// gray = (int)(r/3 + g/3 + b/3 + 0.5) (double semantics), signal = gray > thr
void rgb_gray_signal(const uint8_t* rgb, uint8_t* out, int64_t n_px,
                     int threshold) {
    const double third = 1.0 / 3.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_px; i++) {
        int r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
        int gray = 0;
        if (r | g | b)
            gray = (int)(((r * third + g * third) + b * third) + 0.5);
        out[i] = gray > threshold ? 1 : 0;
    }
}

// ---------- PNG scanline unfiltering (PNG spec section 9) -----------------

// in: h rows of (1 filter byte + stride bytes); out: h * stride bytes.
// Returns 0, or -1 on an unknown filter type.
int png_unfilter(const uint8_t* in, uint8_t* out, int64_t h, int64_t stride,
                 int bpp) {
    for (int64_t y = 0; y < h; y++) {
        const uint8_t* src = in + y * (stride + 1);
        uint8_t f = src[0];
        src++;
        uint8_t* cur = out + y * stride;
        const uint8_t* prev = y ? out + (y - 1) * stride : nullptr;
        for (int64_t x = 0; x < stride; x++) {
            int a = x >= bpp ? cur[x - bpp] : 0;
            int b = prev ? prev[x] : 0;
            int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
            int pred;
            switch (f) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    int p = a + b - c;
                    int pa = std::abs(p - a), pb = std::abs(p - b),
                        pc = std::abs(p - c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -1;
            }
            cur[x] = (uint8_t)(src[x] + pred);
        }
    }
    return 0;
}

}  // extern "C"
