// PNG scanline unfiltering (PNG specification, section 9): the one step
// of decoding a PNG that runs pixel by pixel, so it is native code. The
// rest of the reader (chunks, zlib, sample layout) is
// ocr_inference_tpu_torch/io/images.py.
#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// in: h scanlines of 1 filter-type byte + row_bytes bytes; out: h *
// row_bytes bytes. bpp is the bytes of one complete pixel (at least 1).
// Returns 0, or -1 - y for an unknown filter type on row y.
extern "C" int64_t ocr_png_unfilter(const uint8_t* in, int64_t h,
                                    int64_t row_bytes, int bpp,
                                    uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = in + y * (row_bytes + 1);
        const uint8_t ft = *src++;
        uint8_t* cur = out + y * row_bytes;
        const uint8_t* prev = y ? cur - row_bytes : nullptr;
        switch (ft) {
        case 0:
            std::memcpy(cur, src, row_bytes);
            break;
        case 1:
            for (int64_t i = 0; i < row_bytes; ++i)
                cur[i] = src[i] + (i >= bpp ? cur[i - bpp] : 0);
            break;
        case 2:
            for (int64_t i = 0; i < row_bytes; ++i)
                cur[i] = src[i] + (prev ? prev[i] : 0);
            break;
        case 3:
            for (int64_t i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                cur[i] = src[i] + (uint8_t)((a + b) >> 1);
            }
            break;
        case 4:
            for (int64_t i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                cur[i] = src[i] + paeth(a, b, c);
            }
            break;
        default:
            return -1 - y;
        }
    }
    return 0;
}
