// TIFF strip and tile decompressors for the port's image reader
// (io/images.py), decoding what libtiff decodes for cv2.imread:
//
// - LZW (compression 5, TIFF 6 "new style": MSB-first codes of 9-12 bits,
//   the code width rising one code early, as tif_lzw.c reads them);
// - PackBits (32773);
// - CCITT modified Huffman (2), T.4 (3, 1-D or 2-D by Group3Options bit
//   0) and T.6 / Group 4 (4), as tif_fax3.c: white runs first, black
//   pixels as 1 bits in the packed output rows.
//
// The IFD parse, Deflate (stdlib zlib), the predictor and the sample
// mapping are io/images.py. Each function returns the bytes (or rows)
// it produced, or a negative number for data libtiff refuses.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Bits {
    const uint8_t* p;
    int64_t n, pos = 0;  // pos in bits
    bool reverse;        // FillOrder 2: the first pixel in the low bit
    inline int bit(int64_t i) const {
        int64_t byte = i >> 3;
        if (byte >= n) return 0;
        int b = p[byte];
        int k = (int)(i & 7);
        return reverse ? (b >> k) & 1 : (b >> (7 - k)) & 1;
    }
    // the next k bits (k <= 24), MSB first, zeros past the end
    inline int peek(int k) const {
        int v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | bit(pos + i);
        return v;
    }
    inline void skip(int k) { pos += k; }
    inline bool at_end() const { return (pos >> 3) >= n; }
};

// ITU-T T.4 run-length codes: {run, length, code}
struct Code { int run, len, code; };

const Code kWhite[] = {
    {0, 8, 0x35}, {1, 6, 0x7}, {2, 4, 0x7}, {3, 4, 0x8}, {4, 4, 0xB},
    {5, 4, 0xC}, {6, 4, 0xE}, {7, 4, 0xF}, {8, 5, 0x13}, {9, 5, 0x14},
    {10, 5, 0x7}, {11, 5, 0x8}, {12, 6, 0x8}, {13, 6, 0x3}, {14, 6, 0x34},
    {15, 6, 0x35}, {16, 6, 0x2A}, {17, 6, 0x2B}, {18, 7, 0x27},
    {19, 7, 0xC}, {20, 7, 0x8}, {21, 7, 0x17}, {22, 7, 0x3}, {23, 7, 0x4},
    {24, 7, 0x28}, {25, 7, 0x2B}, {26, 7, 0x13}, {27, 7, 0x24},
    {28, 7, 0x18}, {29, 8, 0x2}, {30, 8, 0x3}, {31, 8, 0x1A},
    {32, 8, 0x1B}, {33, 8, 0x12}, {34, 8, 0x13}, {35, 8, 0x14},
    {36, 8, 0x15}, {37, 8, 0x16}, {38, 8, 0x17}, {39, 8, 0x28},
    {40, 8, 0x29}, {41, 8, 0x2A}, {42, 8, 0x2B}, {43, 8, 0x2C},
    {44, 8, 0x2D}, {45, 8, 0x4}, {46, 8, 0x5}, {47, 8, 0xA}, {48, 8, 0xB},
    {49, 8, 0x52}, {50, 8, 0x53}, {51, 8, 0x54}, {52, 8, 0x55},
    {53, 8, 0x24}, {54, 8, 0x25}, {55, 8, 0x58}, {56, 8, 0x59},
    {57, 8, 0x5A}, {58, 8, 0x5B}, {59, 8, 0x4A}, {60, 8, 0x4B},
    {61, 8, 0x32}, {62, 8, 0x33}, {63, 8, 0x34},
    {64, 5, 0x1B}, {128, 5, 0x12}, {192, 6, 0x17}, {256, 7, 0x37},
    {320, 8, 0x36}, {384, 8, 0x37}, {448, 8, 0x64}, {512, 8, 0x65},
    {576, 8, 0x68}, {640, 8, 0x67}, {704, 9, 0xCC}, {768, 9, 0xCD},
    {832, 9, 0xD2}, {896, 9, 0xD3}, {960, 9, 0xD4}, {1024, 9, 0xD5},
    {1088, 9, 0xD6}, {1152, 9, 0xD7}, {1216, 9, 0xD8}, {1280, 9, 0xD9},
    {1344, 9, 0xDA}, {1408, 9, 0xDB}, {1472, 9, 0x98}, {1536, 9, 0x99},
    {1600, 9, 0x9A}, {1664, 6, 0x18}, {1728, 9, 0x9B},
};

const Code kBlack[] = {
    {0, 10, 0x37}, {1, 3, 0x2}, {2, 2, 0x3}, {3, 2, 0x2}, {4, 3, 0x3},
    {5, 4, 0x3}, {6, 4, 0x2}, {7, 5, 0x3}, {8, 6, 0x5}, {9, 6, 0x4},
    {10, 7, 0x4}, {11, 7, 0x5}, {12, 7, 0x7}, {13, 8, 0x4}, {14, 8, 0x7},
    {15, 9, 0x18}, {16, 10, 0x17}, {17, 10, 0x18}, {18, 10, 0x8},
    {19, 11, 0x67}, {20, 11, 0x68}, {21, 11, 0x6C}, {22, 11, 0x37},
    {23, 11, 0x28}, {24, 11, 0x17}, {25, 11, 0x18}, {26, 12, 0xCA},
    {27, 12, 0xCB}, {28, 12, 0xCC}, {29, 12, 0xCD}, {30, 12, 0x68},
    {31, 12, 0x69}, {32, 12, 0x6A}, {33, 12, 0x6B}, {34, 12, 0xD2},
    {35, 12, 0xD3}, {36, 12, 0xD4}, {37, 12, 0xD5}, {38, 12, 0xD6},
    {39, 12, 0xD7}, {40, 12, 0x6C}, {41, 12, 0x6D}, {42, 12, 0xDA},
    {43, 12, 0xDB}, {44, 12, 0x54}, {45, 12, 0x55}, {46, 12, 0x56},
    {47, 12, 0x57}, {48, 12, 0x64}, {49, 12, 0x65}, {50, 12, 0x52},
    {51, 12, 0x53}, {52, 12, 0x24}, {53, 12, 0x37}, {54, 12, 0x38},
    {55, 12, 0x27}, {56, 12, 0x28}, {57, 12, 0x58}, {58, 12, 0x59},
    {59, 12, 0x2B}, {60, 12, 0x2C}, {61, 12, 0x5A}, {62, 12, 0x66},
    {63, 12, 0x67},
    {64, 10, 0xF}, {128, 12, 0xC8}, {192, 12, 0xC9}, {256, 12, 0x5B},
    {320, 12, 0x33}, {384, 12, 0x34}, {448, 12, 0x35}, {512, 13, 0x6C},
    {576, 13, 0x6D}, {640, 13, 0x4A}, {704, 13, 0x4B}, {768, 13, 0x4C},
    {832, 13, 0x4D}, {896, 13, 0x72}, {960, 13, 0x73}, {1024, 13, 0x74},
    {1088, 13, 0x75}, {1152, 13, 0x76}, {1216, 13, 0x77}, {1280, 13, 0x52},
    {1344, 13, 0x53}, {1408, 13, 0x54}, {1472, 13, 0x55}, {1536, 13, 0x5A},
    {1600, 13, 0x5B}, {1664, 13, 0x64}, {1728, 13, 0x65},
};

// extended make-up codes, both colours
const Code kExtended[] = {
    {1792, 11, 0x8}, {1856, 11, 0xC}, {1920, 11, 0xD}, {1984, 12, 0x12},
    {2048, 12, 0x13}, {2112, 12, 0x14}, {2176, 12, 0x15}, {2240, 12, 0x16},
    {2304, 12, 0x17}, {2368, 12, 0x1C}, {2432, 12, 0x1D}, {2496, 12, 0x1E},
    {2560, 12, 0x1F},
};

const int kRunEOL = -1, kRunBad = -2;

// 13-bit lookahead tables: (length << 16) | (run + 2)
struct RunTables {
    uint32_t white[1 << 13], black[1 << 13];
    static void put(uint32_t* t, const Code& c) {
        int shift = 13 - c.len;
        for (int i = 0; i < (1 << shift); ++i)
            t[(c.code << shift) | i] = ((uint32_t)c.len << 16) | (c.run + 2);
    }
    RunTables() {
        for (int i = 0; i < (1 << 13); ++i) white[i] = black[i] = 0;
        for (const Code& c : kWhite) put(white, c);
        for (const Code& c : kBlack) put(black, c);
        for (const Code& c : kExtended) {
            put(white, c);
            put(black, c);
        }
        const Code eol{kRunEOL, 12, 1};
        put(white, eol);
        put(black, eol);
    }
};
const RunTables kRuns;

// one run (make-up codes summed with the terminating code); kRunEOL at
// an EOL, kRunBad for a code that is not in the table
int read_run(Bits& b, bool black) {
    int total = 0;
    for (;;) {
        uint32_t e = (black ? kRuns.black : kRuns.white)[b.peek(13)];
        if (!e) return kRunBad;
        int len = (int)(e >> 16), run = (int)(e & 0xFFFF) - 2;
        b.skip(len);
        if (run == kRunEOL) return kRunEOL;
        total += run;
        if (run < 64) return total;
    }
}

enum Mode { P, H, V0, VR1, VR2, VR3, VL1, VL2, VL3, EXT, EOL2D, BAD };

Mode read_mode(Bits& b) {
    int v = b.peek(7);
    if (v & 0x40) { b.skip(1); return V0; }
    if ((v >> 4) == 3) { b.skip(3); return VR1; }
    if ((v >> 4) == 2) { b.skip(3); return VL1; }
    if ((v >> 4) == 1) { b.skip(3); return H; }
    if ((v >> 3) == 1) { b.skip(4); return P; }
    if ((v >> 1) == 3) { b.skip(6); return VR2; }
    if ((v >> 1) == 2) { b.skip(6); return VL2; }
    if (v == 3) { b.skip(7); return VR3; }
    if (v == 2) { b.skip(7); return VL3; }
    if (v == 1) return EXT;
    if (b.peek(12) == 1) { b.skip(12); return EOL2D; }
    return BAD;
}

// the changing elements of one row -> packed bits (1 = black)
void fill_row(const std::vector<int>& ch, int width, uint8_t* row) {
    std::memset(row, 0, (width + 7) / 8);
    for (size_t i = 0; i + 1 < ch.size(); i += 2) {
        int a = ch[i], e = std::min(ch[i + 1], width);
        for (int x = a; x < e; ++x) row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
    }
}

// a 1-D coded row: changing elements, or false on a bad code
bool row_1d(Bits& b, int width, std::vector<int>& ch) {
    ch.clear();
    int a0 = 0;
    bool black = false;
    while (a0 < width) {
        int run = read_run(b, black);
        if (run < 0) return false;
        a0 += run;
        if (a0 > width) a0 = width;
        ch.push_back(a0);
        black = !black;
    }
    if (ch.size() & 1) ch.push_back(width);
    return true;
}

// a 2-D coded row against the reference row's changing elements
bool row_2d(Bits& b, int width, const std::vector<int>& ref,
            std::vector<int>& ch) {
    ch.clear();
    int a0 = -1;
    int color = 0;  // 0 white, 1 black
    size_t i = 0;
    auto b1_index = [&]() {
        i = i >= 2 ? i - 2 : 0;
        while (i < ref.size() &&
               (ref[i] <= a0 || (int)(i & 1) != color))
            ++i;
        return i;
    };
    while (a0 < width) {
        Mode m = read_mode(b);
        size_t k = b1_index();
        int b1 = k < ref.size() ? ref[k] : width;
        int b2 = k + 1 < ref.size() ? ref[k + 1] : width;
        switch (m) {
        case P:
            a0 = b2;
            break;
        case H: {
            int start = a0 < 0 ? 0 : a0;
            int r1 = read_run(b, color == 1);
            if (r1 < 0) return false;
            int r2 = read_run(b, color == 0);
            if (r2 < 0) return false;
            int a1 = std::min(start + r1, width);
            int a2 = std::min(a1 + r2, width);
            ch.push_back(a1);
            ch.push_back(a2);
            a0 = a2;
            break;
        }
        case V0: case VR1: case VR2: case VR3: case VL1: case VL2: case VL3: {
            static const int delta[] = {0, 0, 0, 1, 2, 3, -1, -2, -3};
            int a1 = b1 + delta[m];
            if (a1 < 0 || a1 > width || a1 < a0) return false;
            ch.push_back(a1);
            a0 = a1;
            color ^= 1;
            break;
        }
        default:
            return false;
        }
    }
    if (ch.size() & 1) ch.push_back(width);
    return true;
}

// T.4 synchronisation: skip to the end of the next EOL (tif_fax3.h
// SYNC_EOL); false at the end of the data
bool sync_eol(Bits& b) {
    for (;;) {
        if (b.at_end()) return false;
        if (b.peek(11) == 0) break;
        b.skip(1);
    }
    while (b.peek(1) == 0) {
        if (b.at_end()) return false;
        b.skip(1);
    }
    b.skip(1);
    return true;
}

}  // namespace

// LZW-decode in[0:n] into out[0:out_n]; returns the bytes written, or
// -1 for a code libtiff rejects. Decoding stops at EOI or a full out.
extern "C" int64_t ocr_tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out,
                                int64_t out_n) {
    const int CLEAR = 256, EOI = 257;
    static thread_local std::vector<int32_t> prefix(4096);
    static thread_local std::vector<uint8_t> suffix(4096), first(4096);
    static thread_local std::vector<int32_t> length(4096);
    for (int c = 0; c < 256; ++c) {
        prefix[c] = -1;
        suffix[c] = first[c] = (uint8_t)c;
        length[c] = 1;
    }
    int nbits = 9, free_ent = 258, oldcode = -1;
    int64_t bitpos = 0, written = 0;
    const int64_t total_bits = n * 8;
    std::vector<uint8_t> stack(4096);
    auto next_code = [&]() -> int {
        if (bitpos + nbits > total_bits) return EOI;  // out of data
        int v = 0;
        for (int k = 0; k < nbits; ++k) {
            int64_t bp = bitpos + k;
            v = (v << 1) | ((in[bp >> 3] >> (7 - (bp & 7))) & 1);
        }
        bitpos += nbits;
        return v;
    };
    auto emit = [&](int code) {
        int len = length[code];
        int c = code;
        for (int k = len - 1; k >= 0; --k) {
            stack[k] = suffix[c];
            c = prefix[c];
        }
        int64_t take = std::min<int64_t>(len, out_n - written);
        std::memcpy(out + written, stack.data(), take);
        written += take;
    };
    while (written < out_n) {
        int code = next_code();
        if (code == EOI) break;
        if (code == CLEAR) {
            nbits = 9;
            free_ent = 258;
            code = next_code();
            if (code == EOI) break;
            if (code > 255) return -1;
            emit(code);
            oldcode = code;
            continue;
        }
        if (oldcode < 0) return -1;  // no CLEAR first
        if (code > free_ent || free_ent >= 4096) return -1;
        int firstc = code < free_ent ? first[code] : first[oldcode];
        prefix[free_ent] = oldcode;
        suffix[free_ent] = (uint8_t)firstc;
        first[free_ent] = first[oldcode];
        length[free_ent] = length[oldcode] + 1;
        ++free_ent;
        emit(code);
        oldcode = code;
        if (free_ent > (1 << nbits) - 2 && nbits < 12) ++nbits;
    }
    return written;
}

// PackBits-decode in[0:n] into out[0:out_n]; returns the bytes written
extern "C" int64_t ocr_tiff_packbits(const uint8_t* in, int64_t n,
                                     uint8_t* out, int64_t out_n) {
    int64_t i = 0, o = 0;
    while (i < n && o < out_n) {
        int c = (int8_t)in[i++];
        if (c >= 0) {
            int64_t k = std::min<int64_t>(std::min<int64_t>(c + 1, n - i), out_n - o);
            std::memcpy(out + o, in + i, k);
            i += c + 1;
            o += k;
        } else if (c != -128) {
            if (i >= n) break;
            int64_t k = std::min<int64_t>(1 - c, out_n - o);
            std::memset(out + o, in[i++], k);
            o += k;
        }
    }
    return o;
}

// CCITT-decode one strip or tile of `rows` rows of `width` pixels into
// packed rows of (width + 7) / 8 bytes. compression 2 (modified Huffman,
// rows byte-aligned), 3 (T.4; g3opts bit 0: 2-D) or 4 (T.6). Returns the
// rows decoded; a short count means the data ended or held a bad code.
extern "C" int64_t ocr_tiff_fax(const uint8_t* in, int64_t n, uint8_t* out,
                                int width, int rows, int compression,
                                int g3opts, int fill_order) {
    Bits b{in, n, 0, fill_order == 2};
    const int64_t rb = (width + 7) / 8;
    std::vector<int> ref{width, width}, cur;
    const bool two_d = compression == 3 && (g3opts & 1);
    for (int y = 0; y < rows; ++y) {
        bool ok;
        if (compression == 2) {
            ok = row_1d(b, width, cur);
            b.pos = (b.pos + 7) & ~(int64_t)7;  // FAXMODE_BYTEALIGN
        } else if (compression == 3) {
            if (!sync_eol(b)) return y;
            bool is1d = true;
            if (two_d) {
                is1d = b.peek(1);
                b.skip(1);
            }
            ok = is1d ? row_1d(b, width, cur) : row_2d(b, width, ref, cur);
        } else {
            ok = row_2d(b, width, ref, cur);
        }
        if (!ok) return y;
        fill_row(cur, width, out + y * rb);
        ref = cur;
        ref.push_back(width);
        ref.push_back(width);
    }
    return rows;
}
