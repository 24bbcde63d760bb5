// BMP RLE8 and RLE4 decoding for the port's image reader (io/images.py),
// as OpenCV's grfmt_bmp.cpp decodes them for cv2.imread: encoded runs,
// absolute runs, end-of-line, end-of-bitmap and delta escapes, the pixels
// an escape skips filled with palette entry 0 (in RLE4 every escape skips
// only its x shift, as OpenCV's does); a run that overflows its row, or
// data that ends before the bitmap does, fails (cv2 gives None).
// The headers, palettes and the other bit depths are io/images.py.
#include <cstdint>
#include <cstring>

namespace {

struct Stream {
    const uint8_t* p;
    int64_t n, pos;
    bool ok = true;
    int byte() {
        if (pos >= n) {
            ok = false;
            return 0;
        }
        return p[pos++];
    }
    int word() {  // little-endian, as RLByteStream::getWord
        int lo = byte();
        int hi = byte();
        return lo | (hi << 8);
    }
};

// FillUniColor: ``count3`` bytes of ``clr`` from ``data``, wrapping to the
// next row (``step`` bytes on, which may be negative) at each row end
uint8_t* fill(uint8_t* data, uint8_t*& line_end, int64_t step, int width3,
              int& y, int height, int count3, const uint8_t* clr) {
    do {
        uint8_t* end = data + count3;
        if (end > line_end) end = line_end;
        count3 -= (int)(end - data);
        for (; data < end; data += 3) {
            data[0] = clr[0];
            data[1] = clr[1];
            data[2] = clr[2];
        }
        if (data >= line_end) {
            line_end += step;
            data = line_end - width3;
            if (++y >= height) break;
        }
    } while (count3 > 0);
    return data;
}

}  // namespace

extern "C" {

// Decode the RLE8 (bits 8) or RLE4 (bits 4) bitmap that starts at
// ``offset`` of the file ``src`` into ``out``, (height, width, 3) BGR in
// top-down rows; ``palette`` holds 256 BGR entries. ``bottom_up``: the
// first row decoded is the image's last. Returns 0, or 1 where cv2.imread
// gives None.
int ocr_bmp_rle(const uint8_t* src, int64_t n, int64_t offset, int width,
                int height, int bits, const uint8_t* palette, int bottom_up,
                uint8_t* out) {
    Stream s{src, n, offset};
    const int nch = 3;
    int width3 = width * nch;
    int64_t step = bottom_up ? -(int64_t)width3 : (int64_t)width3;
    uint8_t* data = bottom_up ? out + (int64_t)(height - 1) * width3 : out;
    uint8_t* line_end = data + width3;
    int y = 0;
    uint8_t buf[256];
    if (bits == 8) {
        int line_end_flag = 0;
        for (;;) {
            int code = s.word();
            if (!s.ok) return 1;
            int len = code & 255;
            code >>= 8;
            if (len != 0) {  // encoded mode
                int prev_y = y;
                len *= nch;
                if (data + len > line_end) return 1;
                data = fill(data, line_end, step, width3, y, height, len,
                            palette + 3 * code);
                line_end_flag = y - prev_y;
                if (y >= height) break;
            } else if (code > 2) {  // absolute mode
                int prev_y = y;
                int code3 = code * nch;
                if (data + code3 > line_end) return 1;
                int sz = (code + 1) & ~1;
                for (int i = 0; i < sz; ++i) buf[i] = (uint8_t)s.byte();
                if (!s.ok) return 1;
                for (int i = 0; i < code; ++i, data += 3)
                    memcpy(data, palette + 3 * buf[i], 3);
                line_end_flag = y - prev_y;
            } else {
                int x_shift3 = (int)(line_end - data);
                int y_shift = height - y;
                if (code || !line_end_flag || x_shift3 < width3) {
                    if (code == 2) {
                        x_shift3 = s.byte() * nch;
                        y_shift = s.byte();
                        if (!s.ok) return 1;
                    }
                    x_shift3 += (y_shift * width3) & ((code == 0) - 1);
                    if (y >= height) break;
                    data = fill(data, line_end, step, width3, y, height,
                                x_shift3, palette);
                    if (y >= height) break;
                }
                line_end_flag = 0;
                if (y >= height) break;
            }
        }
        return 0;
    }
    // RLE4
    for (;;) {
        int code = s.word();
        if (!s.ok) return 1;
        int len = code & 255;
        code >>= 8;
        if (len != 0) {  // encoded mode
            const uint8_t* clr[2] = {palette + 3 * (code >> 4),
                                     palette + 3 * (code & 15)};
            int t = 0;
            uint8_t* end = data + len * nch;
            if (end > line_end) return 1;
            do {
                memcpy(data, clr[t], 3);
                t ^= 1;
            } while ((data += nch) < end);
        } else if (code > 2) {  // absolute mode
            if (data + code * nch > line_end) return 1;
            int sz = (((code + 1) >> 1) + 1) & ~1;
            for (int i = 0; i < sz; ++i) buf[i] = (uint8_t)s.byte();
            if (!s.ok) return 1;
            for (int i = 0; i < code; ++i, data += 3) {
                int idx = (i & 1) ? (buf[i >> 1] & 15) : (buf[i >> 1] >> 4);
                memcpy(data, palette + 3 * idx, 3);
            }
        } else {
            // every escape moves by its x shift alone: end-of-bitmap ends
            // the row as end-of-line does, a delta's rows are not skipped
            int x_shift3 = (int)(line_end - data);
            if (code == 2) {
                x_shift3 = s.byte() * nch;
                s.byte();
                if (!s.ok) return 1;
            }
            data = fill(data, line_end, step, width3, y, height, x_shift3,
                        palette);
            if (y >= height) break;
        }
    }
    return 0;
}

}  // extern "C"
