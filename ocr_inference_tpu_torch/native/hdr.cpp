// Radiance HDR pixels for the port's image reader (io/images.py), as
// OpenCV's rgbe.cpp RGBE_ReadPixels_RLE reads them for cv2.imread: a
// scanline that starts with 2, 2 and its width (big-endian, below 0x8000)
// holds the four channels one after the other, each in runs (a count over
// 128 repeats the next byte, any other count is followed by that many
// bytes); a count of zero or one past the channel's end fails. A
// scanline that does not start so ends the run-length scanlines: it and
// every pixel after it are read as flat RGBE quadruples. Widths under 8
// or over 0x7fff are flat throughout. A file that ends early fails.
// The header and the RGBE -> 8-bit mapping are io/images.py.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Read ``width`` x ``height`` RGBE pixels from ``offset`` of ``src`` into
// ``out`` (height, width, 4). Returns 0, or 1 where cv2.imread gives None.
int ocr_hdr_pixels(const uint8_t* src, int64_t n, int64_t offset, int width,
                   int height, uint8_t* out) {
    int64_t pos = offset;
    const int64_t total = (int64_t)width * height;
    auto flat = [&](int64_t from) -> int {
        int64_t need = (total - from) * 4;
        if (n - pos < need) return 1;
        memcpy(out + from * 4, src + pos, (size_t)need);
        return 0;
    };
    if (width < 8 || width > 0x7fff) return flat(0);
    std::vector<uint8_t> line(4 * (size_t)width);
    for (int y = 0; y < height; ++y) {
        if (n - pos < 4) return 1;
        const uint8_t* q = src + pos;
        pos += 4;
        if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {
            int64_t at = (int64_t)y * width;
            memcpy(out + at * 4, q, 4);
            return flat(at + 1);
        }
        if (((q[2] << 8) | q[3]) != width) return 1;
        uint8_t* ptr = line.data();
        for (int c = 0; c < 4; ++c) {
            uint8_t* end = line.data() + (size_t)(c + 1) * width;
            while (ptr < end) {
                if (n - pos < 2) return 1;
                int count = src[pos];
                uint8_t value = src[pos + 1];
                pos += 2;
                if (count > 128) {
                    count -= 128;
                    if (count > end - ptr) return 1;
                    memset(ptr, value, count);
                    ptr += count;
                } else {
                    if (count == 0 || count > end - ptr) return 1;
                    *ptr++ = value;
                    if (--count > 0) {
                        if (n - pos < count) return 1;
                        memcpy(ptr, src + pos, count);
                        pos += count;
                        ptr += count;
                    }
                }
            }
        }
        uint8_t* row = out + (size_t)y * width * 4;
        for (int x = 0; x < width; ++x)
            for (int c = 0; c < 4; ++c)
                row[4 * x + c] = line[(size_t)c * width + x];
    }
    return 0;
}

}  // extern "C"
