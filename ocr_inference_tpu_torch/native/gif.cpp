// GIF LZW decoding for the port's image reader (io/images.py), as OpenCV
// 5.0's own GIF decoder (grfmt_gif.cpp) decodes the first frame for
// cv2.imread, which departs from a GIF89a decoder in where it stops:
//
// - the codes are read from the data sub-blocks as they come; an end code
//   resets the table and code size like a clear code and ends only the
//   current byte's codes: the codes of the bytes that follow it in the
//   same sub-blocks are decoded on;
// - the bits that pad the last byte are decoded as codes too;
// - the first code after a clear (or an end) code must be a literal, a
//   code past the next table entry fails, and a full table (4096 codes)
//   takes no more entries but keeps decoding at 12 bits;
// - a string that would run past the frame's pixels fails, and so does a
//   frame whose sub-blocks end before its last pixel;
// - once the frame is complete, the codes left in the bytes already read
//   are decoded without output (a code past the table still fails, a
//   string right after a clear code does not), but a byte read after such
//   a code fails. This rule is fitted to cv2's results on hand-written
//   streams (300 random code tails after a complete frame, and seeded
//   corruptions): past the frame's end the decoder that cv2 runs reads a
//   table it has cleared.
//
// The headers, extensions, colour tables, interlacing and the canvas are
// io/images.py.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode the LZW sub-blocks of a frame of ``npix`` pixels that start at
// ``offset`` of the file ``src`` (at the minimum code size byte) into
// ``out`` (npix colour indices, zeroed by the caller). Returns 0, or 1
// where cv2.imread gives None; ``*end`` gets the offset after the block
// terminator.
int ocr_gif_lzw(const uint8_t* src, int64_t n, int64_t offset, int64_t npix,
                uint8_t* out, int64_t* end) {
    int64_t pos = offset;
    if (pos >= n) return 1;
    const int min_size = src[pos++];
    int code_size = min_size + 1;
    if (code_size <= 2 || code_size > 12) return 1;
    const int clear = 1 << min_size;
    const int eoi = clear + 1;
    // each entry: its prefix code, its last byte, its first byte, length
    std::vector<int32_t> prefix(4096), length(4096);
    std::vector<uint8_t> suffix(4096), first(4096);
    for (int i = 0; i < clear; ++i) {
        prefix[i] = -1;
        suffix[i] = (uint8_t)i;
        first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int next = clear + 2;
    int prev = -1;
    int64_t idx = 0;
    bool full = false, extra = false;  // past the last pixel
    int left_bits = 0;
    uint32_t bits = 0;
    if (pos >= n) return 1;
    int block_len = src[pos++];
    while (block_len) {
        if (left_bits < code_size) {
            if (extra) return 1;
            if (pos >= n) return 1;
            bits |= (uint32_t)src[pos++] << left_bits;
            --block_len;
            left_bits += 8;
        }
        while (left_bits >= code_size) {
            int code = (int)(bits & ((1u << code_size) - 1));
            bits >>= code_size;
            left_bits -= code_size;
            if (code == clear || code == eoi) {
                code_size = min_size + 1;
                next = clear + 2;
                prev = -1;
                if (code == eoi) break;
                continue;
            }
            int emit;
            if (prev < 0) {
                if (code >= clear) {
                    if (!full) return 1;
                    extra = true;  // past the frame: no output, no failure
                    continue;
                }
                emit = code;
            } else if (code < next) {
                emit = code;
                if (next < 4096) {
                    prefix[next] = prev;
                    suffix[next] = first[code];
                    first[next] = first[prev];
                    length[next] = length[prev] + 1;
                    ++next;
                }
            } else if (code == next && next < 4096) {
                prefix[next] = prev;
                suffix[next] = first[prev];
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                emit = next++;
            } else {
                return 1;
            }
            if (next == (1 << code_size) && code_size < 12) ++code_size;
            int len = length[emit];
            if (full) {
                extra = true;
                prev = code;
                continue;
            }
            if (idx + len > npix) return 1;
            for (int k = len - 1, c = emit; k >= 0; --k, c = prefix[c])
                out[idx + k] = suffix[c];
            idx += len;
            prev = code;
            full = idx == npix;
        }
        if (block_len == 0) {
            if (pos >= n) return 1;
            block_len = src[pos++];
        }
    }
    *end = pos;
    return idx == npix ? 0 : 1;
}

}  // extern "C"
