// WebP decoding for the port's image reader (io/images.py), as libwebp
// (decoder ABI 0x0210, the build cv2 5.0 bundles) decodes for cv2.imread:
//
// - VP8L (lossless): the prefix-code groups and the meta prefix image, the
//   colour cache, LZ77 with the 120-entry distance map, and the predictor,
//   cross-colour, subtract-green and colour-indexing transforms (pixel
//   bundling included). The bit reader is libwebp's own (a 64-bit window,
//   reads past the end seen as its end-of-stream flag), so that a cut or
//   broken stream fails where libwebp's fails.
// - The ALPH chunk's lossless alpha stream is decoded the same way and
//   checked as libwebp checks it (its 8-bit path when only colour indexing
//   is used and the codes allow it); imread drops alpha, so its values are
//   not kept.
// - VP8 (lossy) key frames: the boolean decoder, segments and quantisers,
//   token partitions and coefficient probabilities, the 16x16, 4x4 and
//   chroma intra predictors over libwebp's edge values (127 above the
//   frame, 129 left of it), its inverse WHT and the inverse DCT as its
//   SSE2 code computes it (16-bit sums that wrap), the simple and normal
//   loop filters with sharpness and the segment and mode deltas; then
//   libwebp's default RGB output: fancy upsampling of the 4:2:0 chroma and
//   the 14-bit fixed-point YUV -> RGB of yuv.h, with dithering off.
//
// The RIFF container, VP8X, ANIM/ANMF and the frame composition are
// io/images.py. The constant tables are those of RFC 6386 (VP8) and of the
// WebP lossless specification.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// VP8L
// ---------------------------------------------------------------------------

constexpr int kLBits = 64;
constexpr int kWBits = 32;
constexpr int kMaxNumBitRead = 24;
constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kCodeToPlaneCodes = 120;
constexpr int kHuffmanTableBits = 8;
constexpr int kMaxCodeLength = 15;
constexpr int kLengthsTableBits = 7;
constexpr int kNumCodeLengthCodes = 19;
constexpr int kMaxCacheBits = 11;

const uint8_t kCodeLengthCodeOrder[kNumCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes,
                              kNumLiteralCodes, kNumLiteralCodes,
                              kNumLiteralCodes, kNumDistanceCodes};

struct LBitReader {
    uint64_t val = 0;
    const uint8_t* buf = nullptr;
    size_t len = 0, pos = 0;
    int bit_pos = 0;
    bool eos = false;

    void init(const uint8_t* start, size_t length) {
        len = length;
        val = 0;
        bit_pos = 0;
        eos = false;
        size_t n = length > 8 ? 8 : length;
        for (size_t i = 0; i < n; ++i) val |= (uint64_t)start[i] << (8 * i);
        pos = n;
        buf = start;
    }
    bool at_end() const {
        return eos || (pos == len && bit_pos > kLBits);
    }
    void set_eos() {
        eos = true;
        bit_pos = 0;
    }
    void shift_bytes() {
        while (bit_pos >= 8 && pos < len) {
            val >>= 8;
            val |= (uint64_t)buf[pos] << (kLBits - 8);
            ++pos;
            bit_pos -= 8;
        }
        if (at_end()) set_eos();
    }
    uint32_t prefetch() const {
        return (uint32_t)(val >> (bit_pos & (kLBits - 1)));
    }
    void fill() {
        if (bit_pos >= kWBits) {
            if (pos + 8 < len) {
                val >>= 32;
                bit_pos -= 32;
                uint32_t w;
                memcpy(&w, buf + pos, 4);
                val |= (uint64_t)w << (kLBits - kWBits);
                pos += 4;
                return;
            }
            shift_bytes();
        }
    }
    uint32_t read(int n) {
        if (!eos && n <= kMaxNumBitRead) {
            uint32_t v = prefetch() & ((1u << n) - 1);
            bit_pos += n;
            shift_bytes();
            return v;
        }
        set_eos();
        return 0;
    }
};

struct HCode {
    uint8_t bits;
    uint16_t value;
};

uint32_t next_key(uint32_t key, int len) {
    uint32_t step = 1u << (len - 1);
    while (key & step) step >>= 1;
    return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
    do {
        end -= step;
        table[end] = code;
    } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
    int left = 1 << (len - root_bits);
    while (len < kMaxCodeLength) {
        left -= count[len];
        if (left <= 0) break;
        ++len;
        left <<= 1;
    }
    return len - root_bits;
}

// libwebp's BuildHuffmanTable: 0 for lengths that are all zero, over-full
// or not a complete code (one symbol alone is a code of zero bits); with
// ``out`` null only the check is made.
int build_huffman(std::vector<HCode>* out, int root_bits, const int* lengths,
                  int n) {
    int count[kMaxCodeLength + 1] = {0};
    int offset[kMaxCodeLength + 1];
    for (int s = 0; s < n; ++s) {
        if (lengths[s] > kMaxCodeLength) return 0;
        ++count[lengths[s]];
    }
    if (count[0] == n) return 0;
    offset[1] = 0;
    for (int len = 1; len < kMaxCodeLength; ++len) {
        if (count[len] > (1 << len)) return 0;
        offset[len + 1] = offset[len] + count[len];
    }
    std::vector<uint16_t> sorted(n);
    for (int s = 0; s < n; ++s)
        if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
    int total_size = 1 << root_bits;
    if (offset[kMaxCodeLength] == 1) {
        if (out) {
            out->assign(total_size, HCode{0, sorted[0]});
        }
        return total_size;
    }
    // the first pass sizes the tables, the second fills them
    std::vector<HCode>* table_out = out;
    int cnt[kMaxCodeLength + 1];
    for (int pass = 0; pass < (out ? 2 : 1); ++pass) {
        memcpy(cnt, count, sizeof(cnt));
        HCode* root = nullptr;
        if (pass == 1) {
            table_out->assign(total_size, HCode{0, 0});
            root = table_out->data();
        }
        HCode* table = root;
        int size = 1 << root_bits;
        uint32_t low = 0xffffffffu;
        uint32_t mask = (1u << root_bits) - 1;
        uint32_t key = 0;
        int num_nodes = 1, num_open = 1;
        int table_bits = root_bits, table_size = 1 << table_bits;
        int symbol = 0;
        int len, step;
        for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= cnt[len];
            if (num_open < 0) return 0;
            for (; cnt[len] > 0; --cnt[len]) {
                if (root)
                    replicate(&table[key], step, table_size,
                              HCode{(uint8_t)len, sorted[symbol]});
                ++symbol;
                key = next_key(key, len);
            }
        }
        for (len = root_bits + 1, step = 2; len <= kMaxCodeLength;
             ++len, step <<= 1) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= cnt[len];
            if (num_open < 0) return 0;
            for (; cnt[len] > 0; --cnt[len]) {
                if ((key & mask) != low) {
                    if (root) table += table_size;
                    table_bits = next_table_bits(cnt, len, root_bits);
                    table_size = 1 << table_bits;
                    size += table_size;
                    low = key & mask;
                    if (root) {
                        root[low].bits = (uint8_t)(table_bits + root_bits);
                        root[low].value = (uint16_t)((table - root) - low);
                    }
                }
                if (root)
                    replicate(&table[key >> root_bits], step, table_size,
                              HCode{(uint8_t)(len - root_bits),
                                    sorted[symbol]});
                ++symbol;
                key = next_key(key, len);
            }
        }
        if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
        total_size = size;
    }
    return total_size;
}

int read_symbol(const HCode* table, LBitReader& br) {
    uint32_t val = br.prefetch();
    table += val & ((1u << kHuffmanTableBits) - 1);
    int nbits = table->bits - kHuffmanTableBits;
    if (nbits > 0) {
        br.bit_pos += kHuffmanTableBits;
        val = br.prefetch();
        table += table->value;
        table += val & ((1u << nbits) - 1);
    }
    br.bit_pos += table->bits;
    return table->value;
}

struct HTreeGroup {
    std::vector<HCode> trees[5];
};

struct Transform {
    int type = 0, bits = 0, xsize = 0, ysize = 0;
    std::vector<uint32_t> data;
};

struct LDecoder {
    LBitReader br;
    Transform transforms[4];
    int num_transforms = 0;
    unsigned seen = 0;  // the transform types read (each at most once)
};

const uint8_t kCodeToPlane[kCodeToPlaneCodes] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26,
    38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
    70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76,
    85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107,
    50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95,
    64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > kCodeToPlaneCodes) return plane_code - kCodeToPlaneCodes;
    int dist_code = kCodeToPlane[plane_code - 1];
    int yoffset = dist_code >> 4;
    int xoffset = 8 - (dist_code & 0xf);
    int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
}

int copy_distance(int symbol, LBitReader& br) {
    if (symbol < 4) return symbol + 1;
    int extra_bits = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + (int)br.read(extra_bits) + 1;
}

bool read_code_lengths(LDecoder& dec, const int* cl_lengths, int num_symbols,
                       int* lengths) {
    LBitReader& br = dec.br;
    std::vector<HCode> table;
    if (!build_huffman(&table, kLengthsTableBits, cl_lengths,
                       kNumCodeLengthCodes))
        return false;
    int max_symbol;
    if (br.read(1)) {
        int length_nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(length_nbits);
        if (max_symbol > num_symbols) return false;
    } else {
        max_symbol = num_symbols;
    }
    int prev = 8;
    int symbol = 0;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        br.fill();
        const HCode& p =
            table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
        br.bit_pos += p.bits;
        int code_len = p.value;
        if (code_len < 16) {
            lengths[symbol++] = code_len;
            if (code_len != 0) prev = code_len;
        } else {
            static const int kExtra[3] = {2, 3, 7};
            static const int kOffset[3] = {3, 3, 11};
            int slot = code_len - 16;
            int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
            if (symbol + repeat > num_symbols) return false;
            int value = code_len == 16 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = value;
        }
    }
    return true;
}

// ReadHuffmanCode: the code's table into ``out`` (null: check only)
bool read_huffman_code(LDecoder& dec, int alphabet_size, int* lengths,
                       std::vector<HCode>* out) {
    LBitReader& br = dec.br;
    bool ok;
    memset(lengths, 0, alphabet_size * sizeof(int));
    if (br.read(1)) {
        int num_symbols = (int)br.read(1) + 1;
        int first_len_code = (int)br.read(1);
        int symbol = (int)br.read(first_len_code == 0 ? 1 : 8);
        lengths[symbol] = 1;
        if (num_symbols == 2) {
            symbol = (int)br.read(8);
            lengths[symbol] = 1;
        }
        ok = true;
    } else {
        int cl[kNumCodeLengthCodes] = {0};
        int num_codes = (int)br.read(4) + 4;
        for (int i = 0; i < num_codes; ++i)
            cl[kCodeLengthCodeOrder[i]] = (int)br.read(3);
        ok = read_code_lengths(dec, cl, alphabet_size, lengths);
    }
    ok = ok && !br.eos;
    if (!ok) return false;
    return build_huffman(out, kHuffmanTableBits, lengths, alphabet_size) != 0;
}

struct Codes {
    int cache_bits = 0;
    int huffman_bits = 0, huffman_xsize = 0;
    std::vector<uint32_t> huffman_image;
    std::vector<HTreeGroup> groups;
};

bool decode_image_stream(LDecoder& dec, int xsize, int ysize, bool level0,
                         std::vector<uint32_t>* out, Codes* codes_out,
                         int* xsize_out);

bool read_huffman_codes(LDecoder& dec, int xsize, int ysize, int cache_bits,
                        bool allow_recursion, Codes& codes) {
    LBitReader& br = dec.br;
    int num_groups = 1;
    codes.huffman_bits = 0;
    if (allow_recursion && br.read(1)) {
        int bits = 2 + (int)br.read(3);
        int hx = (xsize + (1 << bits) - 1) >> bits;
        int hy = (ysize + (1 << bits) - 1) >> bits;
        if (!decode_image_stream(dec, hx, hy, false, &codes.huffman_image,
                                 nullptr, nullptr))
            return false;
        codes.huffman_bits = bits;
        codes.huffman_xsize = hx;
        for (auto& v : codes.huffman_image) {
            v = (v >> 8) & 0xffff;
            if ((int)v >= num_groups) num_groups = (int)v + 1;
        }
    }
    if (br.eos) return false;
    int max_alphabet =
        kAlphabetSize[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
    std::vector<int> lengths(max_alphabet > 256 ? max_alphabet : 256);
    // with more groups than 1000 or than pixels, libwebp reads and checks
    // the groups the meta image does not use without keeping them
    bool mapping = num_groups > 1000 || num_groups > xsize * ysize;
    std::vector<char> used(num_groups, !mapping);
    for (auto v : codes.huffman_image) used[v] = 1;
    codes.groups.assign(num_groups, HTreeGroup());
    for (int i = 0; i < num_groups; ++i) {
        for (int j = 0; j < 5; ++j) {
            int alphabet = kAlphabetSize[j];
            if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
            if (!read_huffman_code(dec, alphabet, lengths.data(),
                                   used[i] ? &codes.groups[i].trees[j]
                                           : nullptr))
                return false;
        }
    }
    codes.cache_bits = cache_bits;
    return true;
}

inline uint32_t cache_key(uint32_t argb, int bits) {
    return (argb * 0x1e35a7bdu) >> (32 - bits);
}

// DecodeImageData over ``data`` (width x height). ``alpha8``: libwebp's
// 8-bit alpha path (green only, no cache; an end of stream after the last
// pixel is no error there). Returns false where libwebp fails.
bool decode_image_data(LDecoder& dec, const Codes& codes, uint32_t* data,
                       uint8_t* data8, int width, int height) {
    LBitReader& br = dec.br;
    const int total = width * height;
    int pos = 0, col = 0, row = 0;
    const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_size = codes.cache_bits > 0 ? 1 << codes.cache_bits : 0;
    const int cache_limit = len_code_limit + cache_size;
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    int last_cached = 0;
    const int hbits = codes.huffman_bits;
    const int mask = hbits == 0 ? ~0 : (1 << hbits) - 1;
    auto group_at = [&](int x, int y) -> const HTreeGroup* {
        if (hbits == 0) return &codes.groups[0];
        return &codes.groups[codes.huffman_image[codes.huffman_xsize *
                                                     (y >> hbits) +
                                                 (x >> hbits)]];
    };
    const HTreeGroup* group = total > 0 ? group_at(0, 0) : nullptr;
    if (data8) {
        while (!br.eos && pos < total) {
            if ((col & mask) == 0) group = group_at(col, row);
            br.fill();
            int code = read_symbol(group->trees[0].data(), br);
            if (code < kNumLiteralCodes) {
                data8[pos++] = (uint8_t)code;
                if (++col >= width) {
                    col = 0;
                    ++row;
                }
            } else if (code < len_code_limit) {
                int length = copy_distance(code - kNumLiteralCodes, br);
                int dist_symbol = read_symbol(group->trees[4].data(), br);
                br.fill();
                int dist = plane_code_to_distance(
                    width, copy_distance(dist_symbol, br));
                if (pos >= dist && total - pos >= length) {
                    for (int i = 0; i < length; ++i)
                        data8[pos + i] = data8[pos + i - dist];
                } else {
                    return false;
                }
                pos += length;
                col += length;
                while (col >= width) {
                    col -= width;
                    ++row;
                }
                if (pos < total && (col & mask))
                    group = group_at(col, row);
            } else {
                return false;
            }
            br.eos = br.at_end();
        }
        br.eos = br.at_end();
        return !(br.eos && pos < total);
    }
    // a code of one symbol reads no bits (libwebp's trivial-literal and
    // packed-table shortcuts give the same pixels)
    while (pos < total) {
        if ((col & mask) == 0) group = group_at(col, row);
        const auto& t = group->trees;
        bool literal = false;
        br.fill();
        int code = read_symbol(t[0].data(), br);
        if (br.at_end()) break;
        if (code < kNumLiteralCodes) {
            int red = read_symbol(t[1].data(), br);
            br.fill();
            int blue = read_symbol(t[2].data(), br);
            int alpha = read_symbol(t[3].data(), br);
            if (br.at_end()) break;
            data[pos] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                        ((uint32_t)code << 8) | (uint32_t)blue;
            literal = true;
        } else if (code >= len_code_limit && code < cache_limit) {
            while (last_cached < pos) {
                uint32_t v = data[last_cached++];
                cache[cache_key(v, codes.cache_bits)] = v;
            }
            data[pos] = cache[code - len_code_limit];
            literal = true;
        }
        if (literal) {
            ++pos;
            if (++col >= width) {
                col = 0;
                ++row;
                if (cache_size)
                    while (last_cached < pos) {
                        uint32_t v = data[last_cached++];
                        cache[cache_key(v, codes.cache_bits)] = v;
                    }
            }
        } else if (code < len_code_limit) {
            int length = copy_distance(code - kNumLiteralCodes, br);
            int dist_symbol = read_symbol(t[4].data(), br);
            br.fill();
            int dist = plane_code_to_distance(width,
                                              copy_distance(dist_symbol, br));
            if (br.at_end()) break;
            if (pos < dist || total - pos < length) return false;
            for (int i = 0; i < length; ++i)
                data[pos + i] = data[pos + i - dist];
            pos += length;
            col += length;
            while (col >= width) {
                col -= width;
                ++row;
            }
            if (col & mask) group = group_at(col, row);
            if (cache_size)
                while (last_cached < pos) {
                    uint32_t v = data[last_cached++];
                    cache[cache_key(v, codes.cache_bits)] = v;
                }
        } else {
            return false;
        }
    }
    br.eos = br.at_end();
    return !br.eos;
}

bool read_transform(LDecoder& dec, int& xsize, int ysize) {
    LBitReader& br = dec.br;
    int type = (int)br.read(2);
    if (dec.seen & (1u << type)) return false;
    dec.seen |= 1u << type;
    Transform& t = dec.transforms[dec.num_transforms++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == 0 || type == 1) {
        t.bits = (int)br.read(3) + 2;
        int sx = (t.xsize + (1 << t.bits) - 1) >> t.bits;
        int sy = (t.ysize + (1 << t.bits) - 1) >> t.bits;
        return decode_image_stream(dec, sx, sy, false, &t.data, nullptr,
                                   nullptr);
    }
    if (type == 3) {
        int num_colors = (int)br.read(8) + 1;
        int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                   : num_colors > 2 ? 2 : 3;
        xsize = (t.xsize + (1 << bits) - 1) >> bits;
        t.bits = bits;
        std::vector<uint32_t> pal;
        if (!decode_image_stream(dec, num_colors, 1, false, &pal, nullptr,
                                 nullptr))
            return false;
        int final_num = 1 << (8 >> bits);
        t.data.assign(final_num, 0);
        t.data[0] = pal[0];
        for (int i = 1; i < num_colors && i < final_num; ++i) {
            uint32_t a = pal[i], b = t.data[i - 1];
            uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
            uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
            t.data[i] = (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
        }
    }
    return true;
}

bool decode_image_stream(LDecoder& dec, int xsize, int ysize, bool level0,
                         std::vector<uint32_t>* out, Codes* codes_out,
                         int* xsize_out) {
    LBitReader& br = dec.br;
    int txsize = xsize;
    if (level0) {
        while (br.read(1)) {
            if (!read_transform(dec, txsize, ysize)) return false;
        }
    }
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = (int)br.read(4);
        if (cache_bits < 1 || cache_bits > kMaxCacheBits) return false;
    }
    Codes local;
    Codes& codes = codes_out ? *codes_out : local;
    if (!read_huffman_codes(dec, txsize, ysize, cache_bits, level0, codes))
        return false;
    if (level0) {
        *xsize_out = txsize;
        return true;
    }
    out->assign((size_t)txsize * ysize, 0);
    if (!decode_image_data(dec, codes, out->data(), nullptr, txsize, ysize))
        return false;
    return !br.eos;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int sub3(int a, int b, int c) {
    int pb = b - c;
    int pa = a - c;
    return abs(pb) - abs(pa);
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
    int d = sub3(a >> 24, b >> 24, c >> 24) +
            sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
            sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
            sub3(a & 0xff, b & 0xff, c & 0xff);
    return d <= 0 ? a : b;
}

inline uint32_t clip255(uint32_t a) {
    if (a < 256) return a;
    return ~a >> 24;
}

inline int add_sub_full(int a, int b, int c) {
    return (int)clip255((uint32_t)(a + b - c));
}

inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
    int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff,
                         (c2 >> 16) & 0xff);
    int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff,
                         (c2 >> 8) & 0xff);
    int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
    return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}

inline int add_sub_half(int a, int b) {
    return (int)clip255((uint32_t)(a + (a - b) / 2));
}

inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t ave = average2(c0, c1);
    int a = add_sub_half(ave >> 24, c2 >> 24);
    int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
    int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
    int b = add_sub_half(ave & 0xff, c2 & 0xff);
    return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}

// the prediction of mode ``mode`` for the pixel at ``out`` (its left
// neighbour out[-1], the row above ``top``)
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
    uint32_t left = out[-1];
    switch (mode) {
        case 1: return left;
        case 2: return top[0];
        case 3: return top[1];
        case 4: return top[-1];
        case 5: return average2(average2(left, top[1]), top[0]);
        case 6: return average2(left, top[-1]);
        case 7: return average2(left, top[0]);
        case 8: return average2(top[-1], top[0]);
        case 9: return average2(top[0], top[1]);
        case 10:
            return average2(average2(left, top[-1]), average2(top[0], top[1]));
        case 11: return select_pred(top[0], left, top[-1]);
        case 12: return clamped_full(left, top[0], top[-1]);
        case 13: return clamped_half(left, top[0], top[-1]);
        default: return 0xff000000u;  // 0, and 14 and 15
    }
}

inline int color_delta(int8_t pred, int8_t color) {
    return ((int)pred * color) >> 5;
}

// the inverse of ``t`` over rows of ``in`` into ``out`` (``out`` may be
// ``in`` for every transform but colour indexing)
void inverse_transform(const Transform& t, const uint32_t* in,
                       uint32_t* out) {
    const int width = t.xsize, height = t.ysize;
    if (t.type == 0) {  // predictor
        const int tiles = (width + (1 << t.bits) - 1) >> t.bits;
        for (int y = 0; y < height; ++y) {
            const uint32_t* src = in + (size_t)y * width;
            uint32_t* dst = out + (size_t)y * width;
            if (y == 0) {
                dst[0] = add_pixels(src[0], 0xff000000u);
                for (int x = 1; x < width; ++x)
                    dst[x] = add_pixels(src[x], dst[x - 1]);
                continue;
            }
            const uint32_t* top = dst - width;
            dst[0] = add_pixels(src[0], top[0]);
            const uint32_t* modes =
                t.data.data() + (size_t)(y >> t.bits) * tiles;
            for (int x = 1; x < width; ++x) {
                int mode = (modes[x >> t.bits] >> 8) & 0xf;
                dst[x] = add_pixels(src[x], predict(mode, dst + x, top + x));
            }
        }
    } else if (t.type == 1) {  // cross colour
        const int tiles = (width + (1 << t.bits) - 1) >> t.bits;
        for (int y = 0; y < height; ++y) {
            const uint32_t* src = in + (size_t)y * width;
            uint32_t* dst = out + (size_t)y * width;
            const uint32_t* ms = t.data.data() + (size_t)(y >> t.bits) * tiles;
            for (int x = 0; x < width; ++x) {
                uint32_t m = ms[x >> t.bits];
                int8_t g2r = (int8_t)(m & 0xff);
                int8_t g2b = (int8_t)((m >> 8) & 0xff);
                int8_t r2b = (int8_t)((m >> 16) & 0xff);
                uint32_t argb = src[x];
                int8_t green = (int8_t)(argb >> 8);
                int new_red = (argb >> 16) & 0xff;
                int new_blue = argb & 0xff;
                new_red += color_delta(g2r, green);
                new_red &= 0xff;
                new_blue += color_delta(g2b, green);
                new_blue += color_delta(r2b, (int8_t)new_red);
                new_blue &= 0xff;
                dst[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) |
                         (uint32_t)new_blue;
            }
        }
    } else if (t.type == 2) {  // subtract green
        size_t n = (size_t)width * height;
        for (size_t i = 0; i < n; ++i) {
            uint32_t argb = in[i];
            uint32_t green = (argb >> 8) & 0xff;
            uint32_t rb = argb & 0x00ff00ffu;
            rb += (green << 16) | green;
            rb &= 0x00ff00ffu;
            out[i] = (argb & 0xff00ff00u) | rb;
        }
    } else {  // colour indexing, from packed rows into ``out``
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int in_width = (width + (1 << t.bits) - 1) >> t.bits;
        for (int y = 0; y < height; ++y) {
            const uint32_t* src = in + (size_t)y * in_width;
            uint32_t* dst = out + (size_t)y * width;
            uint32_t packed = 0;
            for (int x = 0; x < width; ++x) {
                if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
                dst[x] = t.data[packed & bit_mask];
                packed >>= bits_per_pixel;
            }
        }
    }
}

}  // namespace

extern "C" {

// Decode the VP8L bitstream ``src`` (from its signature byte 0x2f) into
// ``argb`` (width x height, the size its header gives). Returns 0, or 1
// where libwebp fails.
int ocr_vp8l_decode(const uint8_t* src, int64_t n, int width, int height,
                    uint32_t* argb) {
    LDecoder dec;
    dec.br.init(src, (size_t)n);
    if (dec.br.read(8) != 0x2f) return 1;
    int w = (int)dec.br.read(14) + 1;
    int h = (int)dec.br.read(14) + 1;
    dec.br.read(1);
    if (dec.br.read(3) != 0 || dec.br.eos) return 1;
    if (w != width || h != height) return 1;
    Codes codes;
    int xsize = 0;
    if (!decode_image_stream(dec, width, height, true, nullptr, &codes,
                             &xsize))
        return 1;
    std::vector<uint32_t> pixels((size_t)xsize * height);
    if (!decode_image_data(dec, codes, pixels.data(), nullptr, xsize, height))
        return 1;
    // inverse transforms, last read first; colour indexing widens the rows
    std::vector<uint32_t> cur = std::move(pixels);
    for (int i = dec.num_transforms - 1; i >= 0; --i) {
        const Transform& t = dec.transforms[i];
        if (t.type == 3) {
            std::vector<uint32_t> wide((size_t)t.xsize * t.ysize);
            inverse_transform(t, cur.data(), wide.data());
            cur.swap(wide);
        } else {
            inverse_transform(t, cur.data(), cur.data());
        }
    }
    memcpy(argb, cur.data(), (size_t)width * height * 4);
    return 0;
}

// Check an ALPH chunk's lossless stream (no header: ``width`` x ``height``
// of the VP8 frame) as libwebp decodes it. Returns 0, or 1 where libwebp
// fails.
int ocr_vp8l_alpha(const uint8_t* src, int64_t n, int width, int height) {
    LDecoder dec;
    dec.br.init(src, (size_t)n);
    Codes codes;
    int xsize = 0;
    if (!decode_image_stream(dec, width, height, true, nullptr, &codes,
                             &xsize))
        return 1;
    bool only_indexing = dec.num_transforms == 1 &&
                         dec.transforms[0].type == 3;
    bool optimizable = codes.cache_bits == 0;
    for (auto& g : codes.groups) {
        if (g.trees[1].empty()) continue;  // a group the meta image skips
        if (g.trees[1][0].bits > 0 || g.trees[2][0].bits > 0 ||
            g.trees[3][0].bits > 0)
            optimizable = false;
    }
    if (only_indexing && optimizable) {
        std::vector<uint8_t> data8((size_t)xsize * height);
        return decode_image_data(dec, codes, nullptr, data8.data(), xsize,
                                 height) ? 0 : 1;
    }
    std::vector<uint32_t> pixels((size_t)xsize * height);
    return decode_image_data(dec, codes, pixels.data(), nullptr, xsize,
                             height) ? 0 : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// VP8
// ---------------------------------------------------------------------------

namespace {

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154,
    157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kBModesProba[10][10][9] = {
 {{231, 120, 48, 89, 115, 113, 120, 152, 112},
  {152, 179, 64, 126, 170, 118, 46, 70, 95},
  {175, 69, 143, 80, 85, 82, 72, 155, 103},
  {56, 58, 10, 171, 218, 189, 17, 13, 152},
  {114, 26, 17, 163, 44, 195, 21, 10, 173},
  {121, 24, 80, 195, 26, 62, 44, 64, 85},
  {144, 71, 10, 38, 171, 213, 144, 34, 26},
  {170, 46, 55, 19, 136, 160, 33, 206, 71},
  {63, 20, 8, 114, 114, 208, 12, 9, 226},
  {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {{134, 183, 89, 137, 98, 101, 106, 165, 148},
  {72, 187, 100, 130, 157, 111, 32, 75, 80},
  {66, 102, 167, 99, 74, 62, 40, 234, 128},
  {41, 53, 9, 178, 241, 141, 26, 8, 107},
  {74, 43, 26, 146, 73, 166, 49, 23, 157},
  {65, 38, 105, 160, 51, 52, 31, 115, 128},
  {104, 79, 12, 27, 217, 255, 87, 17, 7},
  {87, 68, 71, 44, 114, 51, 15, 186, 23},
  {47, 41, 14, 110, 182, 183, 21, 17, 194},
  {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {{88, 88, 147, 150, 42, 46, 45, 196, 205},
  {43, 97, 183, 117, 85, 38, 35, 179, 61},
  {39, 53, 200, 87, 26, 21, 43, 232, 171},
  {56, 34, 51, 104, 114, 102, 29, 93, 77},
  {39, 28, 85, 171, 58, 165, 90, 98, 64},
  {34, 22, 116, 206, 23, 34, 43, 166, 73},
  {107, 54, 32, 26, 51, 1, 81, 43, 31},
  {68, 25, 106, 22, 64, 171, 36, 225, 114},
  {34, 19, 21, 102, 132, 188, 16, 76, 124},
  {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {{193, 101, 35, 159, 215, 111, 89, 46, 111},
  {60, 148, 31, 172, 219, 228, 21, 18, 111},
  {112, 113, 77, 85, 179, 255, 38, 120, 114},
  {40, 42, 1, 196, 245, 209, 10, 25, 109},
  {88, 43, 29, 140, 166, 213, 37, 43, 154},
  {61, 63, 30, 155, 67, 45, 68, 1, 209},
  {100, 80, 8, 43, 154, 1, 51, 26, 71},
  {142, 78, 78, 16, 255, 128, 34, 197, 171},
  {41, 40, 5, 102, 211, 183, 4, 1, 221},
  {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {{138, 31, 36, 171, 27, 166, 38, 44, 229},
  {67, 87, 58, 169, 82, 115, 26, 59, 179},
  {63, 59, 90, 180, 59, 166, 93, 73, 154},
  {40, 40, 21, 116, 143, 209, 34, 39, 175},
  {47, 15, 16, 183, 34, 223, 49, 45, 183},
  {46, 17, 33, 183, 6, 98, 15, 32, 183},
  {57, 46, 22, 24, 128, 1, 54, 17, 37},
  {65, 32, 73, 115, 28, 128, 23, 128, 205},
  {40, 3, 9, 115, 51, 192, 18, 6, 223},
  {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {{104, 55, 44, 218, 9, 54, 53, 130, 226},
  {64, 90, 70, 205, 40, 41, 23, 26, 57},
  {54, 57, 112, 184, 5, 41, 38, 166, 213},
  {30, 34, 26, 133, 152, 116, 10, 32, 134},
  {39, 19, 53, 221, 26, 114, 32, 73, 255},
  {31, 9, 65, 234, 2, 15, 1, 118, 73},
  {75, 32, 12, 51, 192, 255, 160, 43, 51},
  {88, 31, 35, 67, 102, 85, 55, 186, 85},
  {56, 21, 23, 111, 59, 205, 45, 37, 192},
  {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {{125, 98, 42, 88, 104, 85, 117, 175, 82},
  {95, 84, 53, 89, 128, 100, 113, 101, 45},
  {75, 79, 123, 47, 51, 128, 81, 171, 1},
  {57, 17, 5, 71, 102, 57, 53, 41, 49},
  {38, 33, 13, 121, 57, 73, 26, 1, 85},
  {41, 10, 67, 138, 77, 110, 90, 47, 114},
  {115, 21, 2, 10, 102, 255, 166, 23, 6},
  {101, 29, 16, 10, 85, 128, 101, 196, 26},
  {57, 18, 10, 102, 102, 213, 34, 20, 43},
  {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {{102, 61, 71, 37, 34, 53, 31, 243, 192},
  {69, 60, 71, 38, 73, 119, 28, 222, 37},
  {68, 45, 128, 34, 1, 47, 11, 245, 171},
  {62, 17, 19, 70, 146, 85, 55, 62, 70},
  {37, 43, 37, 154, 100, 163, 85, 160, 1},
  {63, 9, 92, 136, 28, 64, 32, 201, 85},
  {75, 15, 9, 9, 64, 255, 184, 119, 16},
  {86, 6, 28, 5, 64, 255, 25, 248, 1},
  {56, 8, 17, 132, 137, 255, 55, 116, 128},
  {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {{164, 50, 31, 137, 154, 133, 25, 35, 218},
  {51, 103, 44, 131, 131, 123, 31, 6, 158},
  {86, 40, 64, 135, 148, 224, 45, 183, 128},
  {22, 26, 17, 131, 240, 154, 14, 1, 209},
  {45, 16, 21, 91, 64, 222, 7, 1, 197},
  {56, 21, 39, 155, 60, 138, 23, 102, 213},
  {83, 12, 13, 54, 192, 255, 68, 47, 28},
  {85, 26, 85, 85, 128, 128, 32, 146, 171},
  {18, 11, 7, 63, 144, 171, 4, 4, 246},
  {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {{190, 80, 35, 99, 180, 80, 126, 54, 45},
  {85, 126, 47, 87, 176, 51, 41, 20, 32},
  {101, 75, 128, 139, 118, 146, 116, 128, 85},
  {56, 41, 15, 176, 236, 85, 37, 9, 62},
  {71, 30, 17, 119, 118, 255, 17, 18, 138},
  {101, 38, 60, 138, 55, 70, 43, 26, 142},
  {146, 36, 19, 30, 171, 255, 97, 27, 20},
  {138, 45, 61, 62, 219, 1, 81, 188, 64},
  {32, 41, 20, 117, 151, 142, 20, 21, 163},
  {112, 19, 12, 61, 195, 128, 48, 4, 24}}};
const uint8_t kCoeffsProba0[4][8][3][11] = {
 {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
   {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
   {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
  {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
   {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
   {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
  {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
   {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
   {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
  {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
   {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
   {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
  {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
   {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
   {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
  {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
   {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
   {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
   {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
   {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
  {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
   {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
   {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
  {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
   {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
   {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
  {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
   {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
   {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
  {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
   {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
   {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
  {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
   {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
   {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
  {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
   {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
   {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
  {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
   {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
   {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
   {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
  {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
   {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
   {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
  {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
   {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
   {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
  {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
   {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
   {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
  {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
   {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
   {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
   {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
   {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
   {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
  {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
   {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
   {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
  {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
   {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
   {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
  {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
   {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
   {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
  {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
   {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
   {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
  {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
   {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
   {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
  {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
   {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
   {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
 {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
   {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
   {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
   {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14,
                             15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's intra modes: 16x16 and chroma DC, TM, V, H; 4x4 as below
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED,
       H_PRED = B_HE_PRED };
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

struct BoolReader {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    uint32_t range = 255 - 1;
    int bits = -8;
    bool eof = false;

    void init(const uint8_t* start, size_t size) {
        buf = start;
        end = start + size;
        value = 0;
        range = 255 - 1;
        bits = -8;
        eof = false;
        load();
    }
    // one byte at a time: libwebp's bulk loads end in the same state
    void load() {
        if (buf < end) {
            bits += 8;
            value = (uint64_t)(*buf++) | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get_bit(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        int pos = bits;
        uint32_t split = (r * (uint32_t)prob) >> 8;
        uint32_t v = (uint32_t)(value >> pos);
        int bit = v > split;
        if (bit) {
            r -= split;
            value -= (uint64_t)(split + 1) << pos;
        } else {
            r = split + 1;
        }
        int shift = 7 ^ (31 - __builtin_clz(r));
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    int get_signed(int v) {
        if (bits < 0) load();
        int pos = bits;
        uint32_t split = range >> 1;
        uint32_t val = (uint32_t)(value >> pos);
        int32_t mask = (int32_t)(split - val) >> 31;
        bits -= 1;
        range += (uint32_t)mask;
        range |= 1;
        value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
        return (v ^ mask) - mask;
    }
    uint32_t get_value(int n) {
        uint32_t v = 0;
        while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
        return v;
    }
    int get_signed_value(int n) {
        int value = (int)get_value(n);
        return get_value(1) ? -value : value;
    }
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

struct FInfo {
    uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
    uint32_t non_zero_y, non_zero_uv;
};

struct Vp8 {
    int width, height, mb_w, mb_h;
    BoolReader br;
    BoolReader parts[8];
    int num_parts_minus_one = 0;
    // segment header
    bool use_segment = false, update_map = false, absolute_delta = true;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    uint8_t segments[3] = {255, 255, 255};
    // filter header
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    int filter_type = 0;
    QuantMatrix dqm[4];
    uint8_t proba[4][8][3][11];
    bool use_skip_proba = false;
    int skip_p = 0;
    FInfo fstrengths[4][2];
};

int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

bool parse_headers(Vp8& d, const uint8_t* buf, size_t size) {
    if (size < 4) return false;
    uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    int key_frame = !(bits & 1);
    int profile = (bits >> 1) & 7;
    int show = (bits >> 4) & 1;
    uint32_t partition_length = bits >> 5;
    if (profile > 3 || !show) return false;
    buf += 3;
    size -= 3;
    if (!key_frame) return false;
    if (size < 7) return false;
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return false;
    d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    d.mb_w = (d.width + 15) >> 4;
    d.mb_h = (d.height + 15) >> 4;
    memcpy(d.proba, kCoeffsProba0, sizeof(d.proba));
    if (partition_length > size) return false;
    BoolReader& br = d.br;
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
    // segment header
    d.use_segment = br.get_value(1);
    if (d.use_segment) {
        d.update_map = br.get_value(1);
        if (br.get_value(1)) {
            d.absolute_delta = br.get_value(1);
            for (int s = 0; s < 4; ++s)
                d.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
            for (int s = 0; s < 4; ++s)
                d.filter_strength[s] =
                    br.get_value(1) ? br.get_signed_value(6) : 0;
        }
        if (d.update_map)
            for (int s = 0; s < 3; ++s)
                d.segments[s] = br.get_value(1) ? br.get_value(8) : 255;
    } else {
        d.update_map = false;
    }
    if (br.eof) return false;
    // filter header
    d.simple = br.get_value(1);
    d.level = br.get_value(6);
    d.sharpness = br.get_value(3);
    d.use_lf_delta = br.get_value(1);
    if (d.use_lf_delta) {
        if (br.get_value(1)) {
            for (int i = 0; i < 4; ++i)
                if (br.get_value(1)) d.ref_lf_delta[i] = br.get_signed_value(6);
            for (int i = 0; i < 4; ++i)
                if (br.get_value(1))
                    d.mode_lf_delta[i] = br.get_signed_value(6);
        }
    }
    d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
    if (br.eof) return false;
    // partitions
    d.num_parts_minus_one = (1 << br.get_value(2)) - 1;
    size_t last_part = d.num_parts_minus_one;
    if (size < 3 * last_part) return false;
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last_part * 3;
    const uint8_t* buf_end = buf + size;
    size_t size_left = size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > size_left) psize = size_left;
        d.parts[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
    }
    d.parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) return false;
    // quantisers
    int base_q0 = br.get_value(7);
    int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
        int q;
        if (d.use_segment) {
            q = d.quantizer[i];
            if (!d.absolute_delta) q += base_q0;
        } else {
            if (i > 0) {
                d.dqm[i] = d.dqm[0];
                continue;
            }
            q = base_q0;
        }
        QuantMatrix& m = d.dqm[i];
        m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clip(q, 127)];
        m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get_value(1);  // update_proba, ignored
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p) {
                    int v = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                ? (int)br.get_value(8)
                                : kCoeffsProba0[t][b][c][p];
                    d.proba[t][b][c][p] = (uint8_t)v;
                }
    d.use_skip_proba = br.get_value(1);
    if (d.use_skip_proba) d.skip_p = br.get_value(8);
    return true;
}

void precompute_filter_strengths(Vp8& d) {
    if (d.filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
        int base_level;
        if (d.use_segment) {
            base_level = d.filter_strength[s];
            if (!d.absolute_delta) base_level += d.level;
        } else {
            base_level = d.level;
        }
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
            FInfo& info = d.fstrengths[s][i4x4];
            int level = base_level;
            if (d.use_lf_delta) {
                level += d.ref_lf_delta[0];
                if (i4x4) level += d.mode_lf_delta[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (d.sharpness > 0) {
                    if (d.sharpness > 4)
                        ilevel >>= 2;
                    else
                        ilevel >>= 1;
                    if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                info.ilevel = (uint8_t)ilevel;
                info.limit = (uint8_t)(2 * level + ilevel);
                info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info.limit = 0;
            }
            info.inner = (uint8_t)i4x4;
        }
    }
}

void parse_intra_mode(Vp8& d, BoolReader& br, MBData& block, uint8_t* top,
                      uint8_t* left) {
    if (d.update_map) {
        block.segment = !br.get_bit(d.segments[0])
                            ? br.get_bit(d.segments[1])
                            : br.get_bit(d.segments[2]) + 2;
    } else {
        block.segment = 0;
    }
    if (d.use_skip_proba) block.skip = br.get_bit(d.skip_p);
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
        int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                    : (br.get_bit(163) ? V_PRED : DC_PRED);
        block.imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba[top[x]][ymode];
                int i = kYModesIntra4[br.get_bit(prob[0])];
                while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
                ymode = -i;
                top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            left[y] = (uint8_t)ymode;
        }
    }
    block.uvmode = !br.get_bit(142)   ? DC_PRED
                   : !br.get_bit(114) ? V_PRED
                   : br.get_bit(183)  ? TM_PRED
                                      : H_PRED;
}

int get_large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.get_bit(p[3])) {
        if (!br.get_bit(p[4]))
            v = 2;
        else
            v = 3 + br.get_bit(p[5]);
    } else {
        if (!br.get_bit(p[6])) {
            if (!br.get_bit(p[7])) {
                v = 5 + br.get_bit(159);
            } else {
                v = 7 + 2 * br.get_bit(165);
                v += br.get_bit(145);
            }
        } else {
            int bit1 = br.get_bit(p[8]);
            int bit0 = br.get_bit(p[9 + bit1]);
            int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
                v += v + br.get_bit(*tab);
            v += 3 + (8 << cat);
        }
    }
    return v;
}

// GetCoeffs: the coefficients of one block from position ``n``; returns
// the position after the last non-zero one (16 when none is left out)
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get_bit(p[0])) return n;
        while (!br.get_bit(p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
        int v;
        if (!br.get_bit(p[2])) {
            v = 1;
            p = p_ctx[1];
        } else {
            v = get_large_value(br, p);
            p = p_ctx[2];
        }
        out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a0 = in[0 + i] + in[12 + i];
        int a1 = in[4 + i] + in[8 + i];
        int a2 = in[4 + i] - in[8 + i];
        int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        int dc = tmp[0 + i * 4] + 3;
        int a0 = dc + tmp[3 + i * 4];
        int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
}

struct NzState {
    uint8_t nz = 0, nz_dc = 0;
};

// ParseResiduals; returns 1 where the macroblock has no non-zero
// coefficient
int parse_residuals(Vp8& d, MBData& block, NzState& mb, NzState& left_mb,
                    BoolReader& br) {
    const QuantMatrix& q = d.dqm[block.segment];
    int16_t* dst = block.coeffs;
    memset(dst, 0, 384 * sizeof(int16_t));
    int first;
    const uint8_t (*ac_proba)[3][11];
    if (!block.is_i4x4) {
        int16_t dc[16] = {0};
        int ctx = mb.nz_dc + left_mb.nz_dc;
        int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
        mb.nz_dc = left_mb.nz_dc = (nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac_proba = d.proba[0];
    } else {
        first = 0;
        ac_proba = d.proba[3];
    }
    uint8_t tnz = mb.nz & 0x0f;
    uint8_t lnz = left_mb.nz & 0x0f;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (int x = 0; x < 4; ++x) {
            int ctx = l + (tnz & 1);
            int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
            l = (nz > first);
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t nz_coeffs = 0;
        tnz = (uint8_t)(mb.nz >> (4 + ch));
        lnz = (uint8_t)(left_mb.nz >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                int ctx = l + (tnz & 1);
                int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
                l = (nz > 0);
                tnz = (uint8_t)((tnz >> 1) | (l << 3));
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        non_zero_uv |= nz_coeffs << (4 * ch);
        out_t_nz |= (uint32_t)(tnz << 4) << ch;
        out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb.nz = (uint8_t)out_t_nz;
    left_mb.nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction (dec.c), over libwebp's work buffer of stride BPS

constexpr int BPS = 32;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

inline int16_t wrap16(int v) { return (int16_t)(uint16_t)(v & 0xffff); }
inline int mulhi16(int16_t x, int k) { return ((int32_t)x * k) >> 16; }

// the full inverse DCT as libwebp's SSE2 Transform computes it: every sum
// in 16-bit lanes that wrap (a broken stream's coefficients can overflow
// them), the two multipliers as 16-bit high products
void transform_full(const int16_t* in, uint8_t* dst) {
    int16_t C[16];
    for (int i = 0; i < 4; ++i) {
        int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i],
                in3 = in[12 + i];
        int16_t a = wrap16(in0 + in2), b = wrap16(in0 - in2);
        int16_t c = wrap16(in1 - in3 + mulhi16(in1, -30068) -
                           mulhi16(in3, 20091));
        int16_t d = wrap16(in1 + in3 + mulhi16(in1, 20091) +
                           mulhi16(in3, -30068));
        C[4 * i + 0] = wrap16(a + d);
        C[4 * i + 1] = wrap16(b + c);
        C[4 * i + 2] = wrap16(b - c);
        C[4 * i + 3] = wrap16(a - d);
    }
    for (int k = 0; k < 4; ++k) {
        int16_t t0 = C[k], t1 = C[4 + k], t2 = C[8 + k], t3 = C[12 + k];
        int16_t dc = wrap16(t0 + 4);
        int16_t a = wrap16(dc + t2), b = wrap16(dc - t2);
        int16_t c = wrap16(t1 - t3 + mulhi16(t1, -30068) -
                           mulhi16(t3, 20091));
        int16_t d = wrap16(t1 + t3 + mulhi16(t1, 20091) +
                           mulhi16(t3, -30068));
        int16_t out[4] = {wrap16(a + d), wrap16(b + c), wrap16(b - c),
                          wrap16(a - d)};
        uint8_t* row = dst + k * BPS;
        for (int m = 0; m < 4; ++m) row[m] = clip8(row[m] + (out[m] >> 3));
    }
}

#define STORE(x, y, v) \
    dst[(x) + (y) * BPS] = clip8(dst[(x) + (y) * BPS] + ((v) >> 3))

void transform_ac3(const int16_t* in, uint8_t* dst) {
    const int a = in[0] + 4;
    const int c4 = MUL2(in[4]), d4 = MUL1(in[4]);
    const int c1 = MUL2(in[1]), d1 = MUL1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; ++y) {
        STORE(0, y, rows[y] + d1);
        STORE(1, y, rows[y] + c1);
        STORE(2, y, rows[y] - c1);
        STORE(3, y, rows[y] - d1);
    }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
    const int DC = in[0] + 4;
    for (int j = 0; j < 4; ++j)
        for (int i = 0; i < 4; ++i) STORE(i, j, DC);
}

// DoTransform: the block's code in the top two bits of ``bits`` picks the
// full transform, the one for three coefficients, DC alone or none
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    switch (bits >> 30) {
        case 3: transform_full(src, dst); break;
        case 2: transform_ac3(src, dst); break;
        case 1: transform_dc(src, dst); break;
        default: break;
    }
}

// DoUVTransform: the full transform on all four blocks if any has an AC
// coefficient, else DC on the blocks whose DC is not zero
void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (!(bits & 0xff)) return;
    for (int k = 0; k < 4; ++k) {
        uint8_t* d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
        if (bits & 0xaa)
            transform_full(src + 16 * k, d);
        else if (src[16 * k])
            transform_dc(src + 16 * k, d);
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        int l = dst[-1];
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
        dst += BPS;
    }
}

void pred4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    switch (mode) {
        case B_DC_PRED: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            dc >>= 3;
            for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc, 4);
            break;
        }
        case B_TM_PRED:
            true_motion(dst, 4);
            break;
        case B_VE_PRED: {
            uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]),
                               AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]),
                               AVG3(top[2], top[3], top[4])};
            for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED: {
            int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
            int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
            memset(dst + 0 * BPS, AVG3(A, B, C), 4);
            memset(dst + 1 * BPS, AVG3(B, C, D), 4);
            memset(dst + 2 * BPS, AVG3(C, D, E), 4);
            memset(dst + 3 * BPS, AVG3(D, E, E), 4);
            break;
        }
        case B_RD_PRED: {
            int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
            int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
            int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
            int C = dst[2 - BPS], D = dst[3 - BPS];
            DST(0, 3) = AVG3(J, K, L);
            DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
            DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
            DST(3, 0) = AVG3(D, C, B);
            break;
        }
        case B_LD_PRED: {
            int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
            int D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS];
            int G = dst[6 - BPS], H = dst[7 - BPS];
            DST(0, 0) = AVG3(A, B, C);
            DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
            DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
            DST(3, 3) = AVG3(G, H, H);
            break;
        }
        case B_VR_PRED: {
            int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
            int K = dst[-1 + 2 * BPS], X = dst[-1 - BPS];
            int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
            int D = dst[3 - BPS];
            DST(0, 0) = DST(1, 2) = AVG2(X, A);
            DST(1, 0) = DST(2, 2) = AVG2(A, B);
            DST(2, 0) = DST(3, 2) = AVG2(B, C);
            DST(3, 0) = AVG2(C, D);
            DST(0, 3) = AVG3(K, J, I);
            DST(0, 2) = AVG3(J, I, X);
            DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
            DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
            DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
            DST(3, 1) = AVG3(B, C, D);
            break;
        }
        case B_VL_PRED: {
            int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
            int D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS];
            int G = dst[6 - BPS], H = dst[7 - BPS];
            DST(0, 0) = AVG2(A, B);
            DST(1, 0) = DST(0, 2) = AVG2(B, C);
            DST(2, 0) = DST(1, 2) = AVG2(C, D);
            DST(3, 0) = DST(2, 2) = AVG2(D, E);
            DST(0, 1) = AVG3(A, B, C);
            DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
            DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
            DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
            DST(3, 2) = AVG3(E, F, G);
            DST(3, 3) = AVG3(F, G, H);
            break;
        }
        case B_HD_PRED: {
            int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
            int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
            int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
            int C = dst[2 - BPS];
            DST(0, 0) = DST(2, 1) = AVG2(I, X);
            DST(0, 1) = DST(2, 2) = AVG2(J, I);
            DST(0, 2) = DST(2, 3) = AVG2(K, J);
            DST(0, 3) = AVG2(L, K);
            DST(3, 0) = AVG3(A, B, C);
            DST(2, 0) = AVG3(X, A, B);
            DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
            DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
            DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
            DST(1, 3) = AVG3(L, K, J);
            break;
        }
        default: {  // B_HU_PRED
            int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
            int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
            DST(0, 0) = AVG2(I, J);
            DST(2, 0) = DST(0, 1) = AVG2(J, K);
            DST(2, 1) = DST(0, 2) = AVG2(K, L);
            DST(1, 0) = AVG3(I, J, K);
            DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
            DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
                DST(3, 3) = (uint8_t)L;
            break;
        }
    }
}

// the 16x16 (size 16) or chroma (8) predictor; ``has_top``/``has_left``
// pick libwebp's DC variants at the frame's edges (CheckMode)
void pred_block(int mode, uint8_t* dst, int size, bool has_top,
                bool has_left) {
    int shift = size == 16 ? 4 : 3;
    switch (mode) {
        case DC_PRED: {
            int dc;
            if (has_top && has_left) {
                dc = size;
                for (int j = 0; j < size; ++j)
                    dc += dst[-1 + j * BPS] + dst[j - BPS];
                dc >>= shift + 1;
            } else if (has_left) {
                dc = size >> 1;
                for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
                dc >>= shift;
            } else if (has_top) {
                dc = size >> 1;
                for (int j = 0; j < size; ++j) dc += dst[j - BPS];
                dc >>= shift;
            } else {
                dc = 0x80;
            }
            for (int j = 0; j < size; ++j) memset(dst + j * BPS, dc, size);
            break;
        }
        case TM_PRED:
            true_motion(dst, size);
            break;
        case V_PRED:
            for (int j = 0; j < size; ++j)
                memcpy(dst + j * BPS, dst - BPS, size);
            break;
        default:  // H_PRED
            for (int j = 0; j < size; ++j)
                memset(dst + j * BPS, dst[j * BPS - 1], size);
            break;
    }
}

const int kScan[16] = {
    0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
    0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
    0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
    0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// ---- loop filter (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7;
    int a2 = (18 * a + 63) >> 7;
    int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    int p0 = p[-step], q0 = p[0];
    int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
           abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

void simple_v16(uint8_t* p, int stride, int thresh) {
    int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i, stride, thresh2)) do_filter2(p + i, stride);
}

void simple_h16(uint8_t* p, int stride, int thresh) {
    int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i * stride, 1, thresh2))
            do_filter2(p + i * stride, 1);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_thresh) {
    int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, thresh2, ithresh)) {
            if (hev(p, hstride, hev_thresh))
                do_filter2(p, hstride);
            else
                do_filter6(p, hstride);
        }
        p += vstride;
    }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_thresh) {
    int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, thresh2, ithresh)) {
            if (hev(p, hstride, hev_thresh))
                do_filter2(p, hstride);
            else
                do_filter4(p, hstride);
        }
        p += vstride;
    }
}

// DoFilter on the macroblock at (mb_x, mb_y) of the frame planes
void do_filter(const Vp8& d, const FInfo& f, int mb_x, int mb_y, uint8_t* y,
               int ys, uint8_t* u, uint8_t* v, int uvs) {
    int limit = f.limit, ilevel = f.ilevel;
    if (limit == 0) return;
    uint8_t* y_dst = y + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (d.filter_type == 1) {
        if (mb_x > 0) simple_h16(y_dst, ys, limit + 4);
        if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_h16(y_dst + 4 * k, ys, limit);
        if (mb_y > 0) simple_v16(y_dst, ys, limit + 4);
        if (f.inner)
            for (int k = 1; k <= 3; ++k)
                simple_v16(y_dst + 4 * k * ys, ys, limit);
        return;
    }
    uint8_t* u_dst = u + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t* v_dst = v + (size_t)mb_y * 8 * uvs + mb_x * 8;
    int hev_t = f.hev_thresh;
    if (mb_x > 0) {
        filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
        filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
        filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
        for (int k = 1; k <= 3; ++k)
            filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
        filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
        filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {
        filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
        filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
        filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
        for (int k = 1; k <= 3; ++k)
            filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
        filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
        filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
}

// ---- output: libwebp's fancy upsampler and yuv.h

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
    return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                                mult_hi(v, 13320) + 8708);
    rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

#define LOAD_UV(u, v) ((u) | ((v) << 16))

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    const int last_pixel_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
    uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    {
        uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
        uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pixel_pair; ++x) {
        uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
        uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
        uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            uint32_t uv0 = (diag_12 + tl_uv) >> 1;
            uint32_t uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                       top_dst + (2 * x - 1) * 3);
            yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16,
                       top_dst + (2 * x) * 3);
        }
        if (bottom_y) {
            uint32_t uv0 = (diag_03 + l_uv) >> 1;
            uint32_t uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                       bottom_dst + (2 * x - 1) * 3);
            yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                       bottom_dst + (2 * x) * 3);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                       top_dst + (len - 1) * 3);
        }
        if (bottom_y) {
            uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                       bottom_dst + (len - 1) * 3);
        }
    }
}

}  // namespace

extern "C" {

// Decode the VP8 key frame ``src`` (a VP8 chunk's payload) into ``rgb``,
// (height, width, 3) with the size its frame header gives. Returns 0, or 1
// where libwebp fails (a header it rejects, a partition cut short).
int ocr_vp8_decode(const uint8_t* src, int64_t n, int width, int height,
                   uint8_t* rgb) {
    Vp8 d;
    if (!parse_headers(d, src, (size_t)n)) return 1;
    if (d.width != width || d.height != height) return 1;
    precompute_filter_strengths(d);
    const int mb_w = d.mb_w, mb_h = d.mb_h;
    const int ys = mb_w * 16, uvs = mb_w * 8;
    std::vector<uint8_t> Y((size_t)ys * mb_h * 16), U((size_t)uvs * mb_h * 8),
        V((size_t)uvs * mb_h * 8);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
    uint8_t intra_l[4];
    std::vector<NzState> nz_top(mb_w);
    NzState nz_left;
    std::vector<MBData> blocks(mb_w);
    std::vector<FInfo> finfo(mb_w);
    // unfiltered samples above each macroblock (VP8TopSamples)
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    uint8_t yuv_b[YUV_SIZE];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        memset(intra_l, B_DC_PRED, 4);
        nz_left = NzState();
        BoolReader& token_br = d.parts[mb_y & d.num_parts_minus_one];
        for (int mb_x = 0; mb_x < mb_w; ++mb_x)
            parse_intra_mode(d, d.br, blocks[mb_x], &intra_t[4 * mb_x],
                             intra_l);
        if (d.br.eof) return 1;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBData& block = blocks[mb_x];
            int skip = d.use_skip_proba ? block.skip : 0;
            if (!skip) {
                skip = parse_residuals(d, block, nz_top[mb_x], nz_left,
                                       token_br);
            } else {
                nz_left.nz = nz_top[mb_x].nz = 0;
                if (!block.is_i4x4) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
                block.non_zero_y = 0;
                block.non_zero_uv = 0;
            }
            if (d.filter_type > 0) {
                finfo[mb_x] = d.fstrengths[block.segment][block.is_i4x4];
                finfo[mb_x].inner |= !skip;
            }
            if (token_br.eof) return 1;
        }
        // ReconstructRow
        uint8_t* y_dst = yuv_b + Y_OFF;
        uint8_t* u_dst = yuv_b + U_OFF;
        uint8_t* v_dst = yuv_b + V_OFF;
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) {
            u_dst[j * BPS - 1] = 129;
            v_dst[j * BPS - 1] = 129;
        }
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            memset(u_dst - BPS - 1, 127, 8 + 1);
            memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            const MBData& block = blocks[mb_x];
            if (mb_x > 0) {
                for (int j = -1; j < 16; ++j)
                    memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
                for (int j = -1; j < 8; ++j) {
                    memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                    memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
                }
            }
            const int16_t* coeffs = block.coeffs;
            if (mb_y > 0) {
                memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
                memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
                memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
            }
            if (block.is_i4x4) {
                uint8_t* top_right = y_dst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1)
                        memset(top_right, top_y[16 * mb_x + 15], 4);
                    else
                        memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
                }
                for (int k = 1; k <= 3; ++k)
                    memcpy(top_right + 4 * k * BPS, top_right, 4);
                uint32_t bits = block.non_zero_y;
                for (int k = 0; k < 16; ++k, bits <<= 2) {
                    uint8_t* dst = y_dst + kScan[k];
                    pred4(block.imodes[k], dst);
                    do_transform(bits, coeffs + k * 16, dst);
                }
            } else {
                pred_block(block.imodes[0], y_dst, 16, mb_y > 0, mb_x > 0);
                uint32_t bits = block.non_zero_y;
                if (bits)
                    for (int k = 0; k < 16; ++k, bits <<= 2)
                        do_transform(bits, coeffs + k * 16, y_dst + kScan[k]);
            }
            pred_block(block.uvmode, u_dst, 8, mb_y > 0, mb_x > 0);
            pred_block(block.uvmode, v_dst, 8, mb_y > 0, mb_x > 0);
            do_uv_transform(block.non_zero_uv, coeffs + 256, u_dst);
            do_uv_transform(block.non_zero_uv >> 8, coeffs + 320, v_dst);
            if (mb_y < mb_h - 1) {
                memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
                memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
                memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
            }
            for (int j = 0; j < 16; ++j)
                memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16],
                       y_dst + j * BPS, 16);
            for (int j = 0; j < 8; ++j) {
                memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8],
                       u_dst + j * BPS, 8);
                memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8],
                       v_dst + j * BPS, 8);
            }
        }
        if (d.filter_type > 0)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x)
                do_filter(d, finfo[mb_x], mb_x, mb_y, Y.data(), ys, U.data(),
                          V.data(), uvs);
    }
    // EmitFancyRGB over the whole frame
    const int stride = width * 3;
    upsample_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], rgb, nullptr,
                  width);
    int y = 0;
    for (; y + 2 < height; y += 2) {
        const uint8_t* top_u = &U[(size_t)(y >> 1) * uvs];
        const uint8_t* top_v = &V[(size_t)(y >> 1) * uvs];
        upsample_pair(&Y[(size_t)(y + 1) * ys], &Y[(size_t)(y + 2) * ys],
                      top_u, top_v, top_u + uvs, top_v + uvs,
                      rgb + (size_t)(y + 1) * stride,
                      rgb + (size_t)(y + 2) * stride, width);
    }
    if (!(height & 1)) {
        const uint8_t* cu = &U[(size_t)(y >> 1) * uvs];
        const uint8_t* cv = &V[(size_t)(y >> 1) * uvs];
        upsample_pair(&Y[(size_t)(y + 1) * ys], nullptr, cu, cv, cu, cv,
                      rgb + (size_t)(y + 1) * stride, nullptr, width);
    }
    return 0;
}

}  // extern "C"
