// TIFF strip and tile decompressors for the port's image reader
// (io/images.py), decoding what libtiff 4.7 decodes for cv2.imread, damaged
// and cut data included (what was decoded before the fault stays):
//
// - LZW (compression 5): TIFF 6 codes (MSB first, the width rising one
//   code early) and old-style codes (LSB first), as tif_lzw.c reads them;
// - Deflate (8, 32946): zlib's inflate, stopping where zlib stops;
// - PackBits (32773);
// - CCITT modified Huffman (2), RLE-W (32771), T.4 (3, 1-D or 2-D by
//   Group3Options bit 0) and T.6 / Group 4 (4), as tif_fax3.c: white runs
//   first, black pixels as 1 bits in the packed output rows, its recovery
//   from bad codes, bad row lengths and the end of the data;
// - ThunderScan 4-bit (32809), SGI LogL and LogLuv (34676, 34677) as the
//   RGBA interface has tif_thunder.c and tif_luv.c decode them;
// - YCbCr -> RGB with tif_color.c's fixed-point tables, and CIE L*a*b* ->
//   RGB with its float ones.
//
// The IFD parse, the predictor and the sample mapping are io/images.py.
// Each function returns the bytes or rows it produced.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

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

// tif_fax3.h's state tables as mkg3states builds them: indexed by the
// next 7 (mode), 12 (white) or 13 (black) bits taken LSB first; a code
// that is not in a table leaves state S_Null and width 0
enum State {
    S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
    S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};
struct TabEnt {
    uint8_t state = S_Null, width = 0;
    int32_t param = 0;
};

struct FaxTables {
    TabEnt main[1 << 7], white[1 << 12], black[1 << 13];
    // FillTable: every index whose low `len` bits are the code (given MSB
    // first, as T.4 writes it)
    static void fill(TabEnt* t, int size, int len, int code, int state,
                     int param) {
        int rev = 0;
        for (int i = 0; i < len; ++i) rev |= ((code >> i) & 1) << (len - 1 - i);
        for (int i = rev; i < (1 << size); i += 1 << len) {
            t[i].state = (uint8_t)state;
            t[i].width = (uint8_t)len;
            t[i].param = param;
        }
    }
    FaxTables() {
        fill(main, 7, 4, 0x1, S_Pass, 0);
        fill(main, 7, 3, 0x1, S_Horiz, 0);
        fill(main, 7, 1, 0x1, S_V0, 0);
        fill(main, 7, 3, 0x3, S_VR, 1);
        fill(main, 7, 6, 0x3, S_VR, 2);
        fill(main, 7, 7, 0x3, S_VR, 3);
        fill(main, 7, 3, 0x2, S_VL, 1);
        fill(main, 7, 6, 0x2, S_VL, 2);
        fill(main, 7, 7, 0x2, S_VL, 3);
        fill(main, 7, 7, 0x1, S_Ext, 0);
        fill(main, 7, 7, 0x0, S_EOL, 0);
        for (const Code& c : kWhite)
            fill(white, 12, c.len, c.code, c.run < 64 ? S_TermW : S_MakeUpW,
                 c.run);
        for (const Code& c : kBlack)
            fill(black, 13, c.len, c.code, c.run < 64 ? S_TermB : S_MakeUpB,
                 c.run);
        for (const Code& c : kExtended) {
            fill(white, 12, c.len, c.code, S_MakeUp, c.run);
            fill(black, 13, c.len, c.code, S_MakeUp, c.run);
        }
        fill(white, 12, 11, 0, S_EOL, 0);  // EOLH: 11 zero bits
        fill(black, 13, 11, 0, S_EOL, 0);
    }
};
const FaxTables kFax;

// TIFFBitRevTable and TIFFNoBitRevTable: the fax decoder takes its bits
// LSB first, so FillOrder 1 data goes through the reversed table
struct BitMaps {
    uint8_t rev[256], same[256];
    BitMaps() {
        for (int i = 0; i < 256; ++i) {
            int r = 0;
            for (int k = 0; k < 8; ++k) r |= ((i >> k) & 1) << (7 - k);
            rev[i] = (uint8_t)r;
            same[i] = (uint8_t)i;
        }
    }
};
const BitMaps kBitMaps;

// libtiff's uvcode.h (tif_luv.c, generated by Greg Ward Larson at SGI):
// the rows of the (u', v') grid LogLuv24's 14-bit colour index counts
// through, each its first u', its cells and the cells before it
struct UvRow {
    float ustart;
    short nus, ncum;
};
const UvRow kUvRow[163] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10},
    {0.237874f, 9, 17}, {0.235906f, 10, 26}, {0.232153f, 12, 36},
    {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77},
    {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.193560f, 32, 291},
    {0.189878f, 34, 323}, {0.186216f, 36, 357}, {0.186216f, 36, 393},
    {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637},
    {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934},
    {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284},
    {0.138270f, 65, 1346}, {0.138270f, 65, 1411}, {0.138270f, 65, 1476},
    {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129},
    {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370},
    {0.107450f, 86, 2452}, {0.107450f, 86, 2538}, {0.107450f, 86, 2624},
    {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164},
    {0.095126f, 95, 3259}, {0.095126f, 95, 3354}, {0.088276f, 100, 3449},
    {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749},
    {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.068290f, 115, 4709},
    {0.068290f, 115, 4824}, {0.068290f, 115, 4939}, {0.068290f, 115, 5054},
    {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769},
    {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528},
    {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322},
    {0.040571f, 138, 7460}, {0.040571f, 138, 7598}, {0.040571f, 138, 7736},
    {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026},
    {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476},
    {0.023739f, 154, 9630}, {0.023739f, 154, 9784}, {0.023739f, 154, 9938},
    {0.019504f, 158, 10092}, {0.019504f, 158, 10250}, {0.019504f, 158, 10408},
    {0.016976f, 161, 10566}, {0.016976f, 161, 10727}, {0.016976f, 161, 10888},
    {0.016976f, 161, 11049}, {0.012639f, 165, 11210}, {0.012639f, 165, 11375},
    {0.012639f, 165, 11540}, {0.009991f, 168, 11705}, {0.009991f, 168, 11873},
    {0.009991f, 168, 12041}, {0.009016f, 170, 12209}, {0.009016f, 170, 12379},
    {0.009016f, 170, 12549}, {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240}, {0.005097f, 175, 13415},
    {0.003909f, 177, 13590}, {0.003909f, 177, 13767}, {0.002340f, 177, 13944},
    {0.002389f, 170, 14121}, {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.000270f, 136, 14905},
    {0.000484f, 129, 15041}, {0.001103f, 123, 15170}, {0.001242f, 115, 15293},
    {0.001188f, 109, 15408}, {0.001011f, 103, 15517}, {0.000709f, 97, 15620},
    {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095},
    {0.008839f, 47, 16150}, {0.010490f, 40, 16197}, {0.016994f, 31, 16237},
    {0.023659f, 21, 16268}};

// tif_luv.c uv_decode: a colour index -> (u', v'), false out of range
bool uv_decode(double* up, double* vp, int c) {
    const float sqsiz = 0.003500f, vstart = 0.016940f;
    if (c < 0 || c >= 16289) return false;
    int lower = 0, upper = 163;
    while (upper - lower > 1) {
        const int vi = (lower + upper) >> 1;
        const int ui = c - kUvRow[vi].ncum;
        if (ui > 0) {
            lower = vi;
        } else if (ui < 0) {
            upper = vi;
        } else {
            lower = vi;
            break;
        }
    }
    const int vi = lower, ui = c - kUvRow[vi].ncum;
    *up = kUvRow[vi].ustart + (ui + .5) * sqsiz;
    *vp = vstart + (vi + .5) * sqsiz;
    return true;
}

// tif_fax3.c _TIFFFax3fillruns: white runs clear bits, black runs set
// them; runs are clamped to the row
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun,
               uint32_t lastx) {
    static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                    0xf8, 0xfc, 0xfe, 0xff};
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int black = 0; black < 2; ++black) {
            uint32_t run = runs[black];
            if (x + run > lastx || run > lastx)
                run = runs[black] = lastx - x;
            if (!run) continue;
            uint8_t* cp = buf + (x >> 3);
            const uint32_t bx = x & 7;
            if (run > 8 - bx) {
                if (bx) {
                    if (black) *cp++ |= (uint8_t)(0xff >> bx);
                    else *cp++ &= (uint8_t)(0xff << (8 - bx));
                    run -= 8 - bx;
                }
                const uint32_t nb = run >> 3;
                std::memset(cp, black ? 0xff : 0, nb);
                cp += nb;
                run &= 7;
                if (run) {
                    if (black) *cp = (uint8_t)((*cp | (0xff00 >> run)) & 0xff);
                    else *cp &= (uint8_t)(0xff >> run);
                }
            } else {
                if (black) *cp |= (uint8_t)(masks[run] >> bx);
                else *cp &= (uint8_t)~(masks[run] >> bx);
            }
            x += runs[black];
        }
    }
}

}  // namespace

// LZW-decode in[0:n] into out[0:out_n] (zeroed by the caller) as
// libtiff's tif_lzw.c does: `compat` 0 is LZWDecode (TIFF 6: codes MSB
// first, the width rising one code early), 1 is LZWDecodeCompat (old
// style: codes LSB first, the width rising at 512, 1024, 2048). Returns
// the bytes written. Decoding stops at EOI, a full out, the end of the
// data, or a code libtiff rejects (a code not yet in the table, a
// literal once the table is past CSIZE entries, anything before the first
// CLEAR, a string code right after a CLEAR); what was written before
// stays.
extern "C" int64_t ocr_tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out,
                                int64_t out_n, int compat) {
    const int CLEAR = 256, EOI = 257, FIRST = 258;
    const int CSIZE = 4095 + 1024;  // tif_lzw.c: MAXCODE(BITS_MAX) + 1024
    struct Entry {
        int32_t next, length;
        uint8_t value, firstchar;
    };
    std::vector<Entry> tab(CSIZE);
    for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, (uint8_t)c, (uint8_t)c};
    tab[CLEAR] = tab[EOI] = {-1, 0, 0, 0};
    // free_ent -1: before the first CLEAR no entry may be made
    int nbits = 9, free_ent = -1, oldcode = 0;
    int maxcode = compat ? 511 : 510;
    int64_t bitpos = 0, written = 0;
    const int64_t total_bits = n * 8;
    auto next_code = [&]() -> int {
        if (total_bits - bitpos < nbits) return EOI;  // no EOI: the end
        int v = 0;
        for (int k = 0; k < nbits; ++k) {
            const int64_t bp = bitpos + k;
            if (compat) v |= ((in[bp >> 3] >> (bp & 7)) & 1) << k;
            else v = (v << 1) | ((in[bp >> 3] >> (7 - (bp & 7))) & 1);
        }
        bitpos += nbits;
        return v;
    };
    auto emit = [&](int code) {  // a string, cut at the end of out
        const int len = tab[code].length;
        const int64_t take = std::min<int64_t>(len, out_n - written);
        int c = code;
        for (int k = len - 1; k >= 0; --k) {
            if (k < take) out[written + k] = tab[c].value;
            c = tab[c].next;
        }
        written += take;
    };
    auto grow = [&]() {
        if (++free_ent > maxcode) {
            nbits = std::min(nbits + 1, 12);
            maxcode = (1 << nbits) - (compat ? 1 : 2);
            if (!compat && free_ent >= CSIZE) free_ent = -1;
        }
    };
    while (written < out_n) {
        int code = next_code();
        if (code == EOI) break;
        if (code == CLEAR) {
            do {
                free_ent = FIRST;
                nbits = 9;
                maxcode = compat ? 511 : 510;
                // LZWDecodeCompat zeroes the entries past the literals:
                // a code not yet made again has no length
                if (compat)
                    std::fill(tab.begin() + FIRST, tab.end(),
                              Entry{-1, 0, 0, 0});
                code = next_code();
            } while (code == CLEAR);
            if (code == EOI) break;
            if (code > EOI) break;
            out[written++] = (uint8_t)code;
            oldcode = code;
            continue;
        }
        if (compat) {
            if (free_ent < 0 || free_ent >= CSIZE) break;
            Entry& e = tab[free_ent];
            e.next = oldcode;
            e.firstchar = tab[oldcode].firstchar;
            e.length = tab[oldcode].length + 1;
            e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
            grow();
            oldcode = code;
            if (code >= 256 && tab[code].length == 0) break;
            emit(code);
            continue;
        }
        // LZWDecode: a literal needs free_ent past it (no table yet: -1);
        // a string code must be in the table, or the one being made
        if (code < 256 ? code > free_ent : code > free_ent || free_ent < 0)
            break;
        Entry& e = tab[free_ent];
        e.value = code < free_ent ? tab[code].firstchar : tab[oldcode].firstchar;
        e.next = oldcode;
        e.firstchar = tab[oldcode].firstchar;
        e.length = tab[oldcode].length + 1;
        grow();
        oldcode = code;
        emit(code);
    }
    return written;
}

// zlib's inflate over a zlib stream (RFC 1950/1951), as libtiff's
// ZIPDecode leaves its buffer: decoding stops at the end of the stream,
// a full out, the end of the data, or the first thing zlib rejects (a bad
// header or preset dictionary: nothing; a bad block type, stored length,
// code set, code or distance: what came before it); a bad Adler-32 check
// changes nothing written. Returns the bytes written; *ok is 1 when
// ZIPDecode succeeds: out full, and nothing zlib reads on without writing
// (the end of the block, the next block's header, the check) is bad.
extern "C" int64_t ocr_tiff_inflate(const uint8_t* in, int64_t n,
                                    uint8_t* out, int64_t out_n, int* ok) {
    int64_t pos = 0, written = 0;
    uint64_t hold = 0;
    int bits = 0;
    // true when k more bits are there
    auto need = [&](int k) {
        while (bits < k) {
            if (pos >= n) return false;
            hold |= (uint64_t)in[pos++] << bits;
            bits += 8;
        }
        return true;
    };
    auto take = [&](int k) {
        const uint32_t v = (uint32_t)(hold & ((1ull << k) - 1));
        hold >>= k;
        bits -= k;
        return v;
    };
    *ok = 0;
    if (n < 2) return 0;
    const int cmf = in[0], flg = in[1];
    if (((cmf << 8) | flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) + 8 > 15 ||
        (flg & 0x20))
        return 0;
    pos = 2;
    // canonical Huffman decoding (zlib's inflate_table: over-subscribed
    // sets rejected; incomplete ones only as a single 1-bit code)
    struct Huff {
        int count[16], symbol[320];
        bool ok;
    };
    auto build = [](Huff& h, const uint8_t* lens, int nsym, bool codes) {
        std::memset(h.count, 0, sizeof(h.count));
        for (int i = 0; i < nsym; ++i) h.count[lens[i]]++;
        int maxlen = 0;
        for (int l = 1; l < 16; ++l)
            if (h.count[l]) maxlen = l;
        h.ok = true;
        h.count[0] = 0;
        if (maxlen == 0) return;  // every code invalid
        int left = 1;
        for (int l = 1; l < 16; ++l) {
            left <<= 1;
            left -= h.count[l];
            if (left < 0) {
                h.ok = false;
                return;
            }
        }
        if (left > 0 && (codes || maxlen != 1)) {
            h.ok = false;
            return;
        }
        int offs[16];
        offs[1] = 0;
        for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + h.count[l];
        for (int i = 0; i < nsym; ++i)
            if (lens[i]) h.symbol[offs[lens[i]]++] = i;
    };
    // the next symbol (puff's decode); -1: out of data, -2: not a code
    auto decode = [&](const Huff& h) -> int {
        int code = 0, first = 0, index = 0;
        for (int len = 1; len < 16; ++len) {
            if (!need(1)) return -1;
            code |= (int)take(1);
            const int count = h.count[len];
            if (code - count < first) return h.symbol[index + (code - first)];
            index += count;
            first += count;
            first <<= 1;
            code <<= 1;
        }
        return -2;
    };
    static const int lbase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19,
                                  23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
                                  115, 131, 163, 195, 227, 258};
    static const int lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int dbase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49,
                                  65, 97, 129, 193, 257, 385, 513, 769, 1025,
                                  1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                  16385, 24577};
    static const int dext[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12,
                                 13, 13};
    Huff lit, dist;
    uint8_t lens[320];
    // err: zlib reports Z_DATA_ERROR; otherwise decoding left off for
    // want of data or of room, or at the end of the stream
    bool err = false;
    for (bool last = false; !last;) {
        if (!need(3)) goto leave;
        last = take(1);
        const int type = (int)take(2);
        if (type == 0) {
            take(bits & 7);
            if (!need(32)) goto leave;
            const uint32_t len = take(16), nlen = take(16);
            if (len != (~nlen & 0xFFFF)) { err = true; goto leave; }
            uint32_t k = 0;
            while (k < len && written < out_n && bits >= 8) {
                out[written++] = (uint8_t)take(8);
                ++k;
            }
            const int64_t copy = std::min<int64_t>(
                {(int64_t)(len - k), out_n - written, n - pos});
            std::memcpy(out + written, in + pos, copy);
            written += copy;
            pos += copy;
            if (k + copy < len) goto leave;
            continue;
        }
        if (type == 3) { err = true; goto leave; }
        if (type == 1) {
            for (int i = 0; i < 288; ++i)
                lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
            build(lit, lens, 288, false);
            for (int i = 0; i < 32; ++i) lens[i] = 5;
            build(dist, lens, 32, false);
        } else {
            if (!need(14)) goto leave;
            const int nlen = (int)take(5) + 257, ndist = (int)take(5) + 1;
            const int ncode = (int)take(4) + 4;
            if (nlen > 286 || ndist > 30) { err = true; goto leave; }
            static const int order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                          11, 4,  12, 3, 13, 2, 14, 1, 15};
            uint8_t cl[19] = {};
            for (int i = 0; i < ncode; ++i) {
                if (!need(3)) goto leave;
                cl[order[i]] = (uint8_t)take(3);
            }
            Huff lencode;
            build(lencode, cl, 19, true);
            if (!lencode.ok) { err = true; goto leave; }
            int maxl = 0;
            for (int l = 1; l < 16; ++l)
                if (lencode.count[l]) maxl = l;
            int have = 0;
            while (have < nlen + ndist) {
                int sym;
                if (maxl == 0) {  // an all-invalid table: val 0, 1 bit
                    if (!need(1)) goto leave;
                    take(1);
                    sym = 0;
                } else {
                    sym = decode(lencode);
                    if (sym == -1) goto leave;
                }
                if (sym < 16) {
                    lens[have++] = (uint8_t)sym;
                    continue;
                }
                int len = 0, copy;
                if (sym == 16) {
                    if (have == 0) { err = true; goto leave; }
                    len = lens[have - 1];
                    if (!need(2)) goto leave;
                    copy = 3 + (int)take(2);
                } else if (sym == 17) {
                    if (!need(3)) goto leave;
                    copy = 3 + (int)take(3);
                } else {
                    if (!need(7)) goto leave;
                    copy = 11 + (int)take(7);
                }
                if (have + copy > nlen + ndist) { err = true; goto leave; }
                while (copy--) lens[have++] = (uint8_t)len;
            }
            if (lens[256] == 0) { err = true; goto leave; }
            build(lit, lens, nlen, false);
            if (!lit.ok) { err = true; goto leave; }
            uint8_t dl[32] = {};
            std::memcpy(dl, lens + nlen, ndist);
            build(dist, dl, ndist, false);
            if (!dist.ok) { err = true; goto leave; }
        }
        // the block's codes; zlib decodes a code even with no room left,
        // and leaves off where the code would write
        for (;;) {
            int sym = decode(lit);
            if (sym == -1) goto leave;
            if (sym < 0 || sym > 285) { err = true; goto leave; }
            if (sym < 256) {
                if (written >= out_n) goto leave;
                out[written++] = (uint8_t)sym;
                continue;
            }
            if (sym == 256) break;
            sym -= 257;
            if (!need(lext[sym])) goto leave;
            int len = lbase[sym] + (int)take(lext[sym]);
            const int d = decode(dist);
            if (d == -1) goto leave;
            if (d < 0 || d > 29) { err = true; goto leave; }
            if (!need(dext[d])) goto leave;
            const int64_t back = dbase[d] + (int64_t)take(dext[d]);
            if (written >= out_n) goto leave;
            if (back > written) { err = true; goto leave; }  // too far back
            for (; len > 0 && written < out_n; --len, ++written)
                out[written] = out[written - back];
            if (len > 0) goto leave;
        }
    }
    {
        // the Adler-32 check of the whole stream
        take(bits & 7);
        if (!need(32)) goto leave;
        uint32_t want = 0;
        for (int k = 0; k < 4; ++k) want = (want << 8) | take(8);
        uint32_t a = 1, b2 = 0;
        for (int64_t i = 0; i < written; ++i) {
            a = (a + out[i]) % 65521;
            b2 = (b2 + a) % 65521;
        }
        if (((b2 << 16) | a) != want) err = true;
    }
leave:
    *ok = !err && written == out_n;
    return written;
}

// PackBits-decode in[0:n] into out[0:out_n] as tif_packbits.c does: a
// run cut short by the end of the data is not written. Returns the bytes
// written.
extern "C" int64_t ocr_tiff_packbits(const uint8_t* in, int64_t n,
                                     uint8_t* out, int64_t out_n) {
    int64_t i = 0, o = 0;
    while (i < n && o < out_n) {
        int64_t c = (int8_t)in[i++];
        if (c < 0) {
            if (c == -128) continue;
            const int64_t k = std::min<int64_t>(1 - c, out_n - o);
            if (i >= n) break;
            std::memset(out + o, in[i++], k);
            o += k;
        } else {
            const int64_t k = std::min<int64_t>(c + 1, out_n - o);
            if (n - i < k) break;
            std::memcpy(out + o, in + i, k);
            i += k;
            o += k;
        }
    }
    return o;
}

// CCITT-decode one strip or tile of `rows` rows of `width` pixels into
// packed rows of (width + 7) / 8 bytes (zeroed by the caller), as
// libtiff's tif_fax3.c decodes it: compression 2 (modified Huffman, rows
// byte-aligned), 32771 (RLE-W: rows aligned to 16 bits of the file,
// `odd` the parity of the data's file offset), 3 (T.4; g3opts bit 0:
// 2-D) or 4 (T.6). Damaged data is followed as libtiff follows it: a code
// not in a table ends its row (Fax3Unexpected), a row whose runs do not
// sum to the width is evened out (CLEANUP_RUNS, Fax3BadLength), T.4 finds
// the next row by its EOL (SYNC_EOL), and at the end of the data the row
// begun is filled and the rest left as it was (Fax3PrematureEOF; an EOL
// ends a T.6 strip). *noeol is the page's FAXMODE_NOEOL flag, carried
// from strip to strip (libtiff 4.5+ sets it when T.4 data ends inside an
// EOL, and then decodes the strip again from its start without EOLs);
// runs is the page's run arrays (2 * nruns + 2 entries, nruns as
// Fax3SetupState sizes it), zeroed once and kept from strip to strip as
// libtiff keeps them: a damaged row can reach past the reference row's
// runs into what an earlier strip left there.
// Returns the rows decoded in full; counts[0] gets the
// 2-D rows an extension code (uncompressed mode) ended, counts[1] the
// warnings and errors libtiff gives.
extern "C" int64_t ocr_tiff_fax(const uint8_t* in, int64_t n, uint8_t* out,
                                int width, int rows, int compression,
                                int g3opts, int fill_order, int odd,
                                int* noeol, uint32_t* runs, int64_t* counts) {
    const uint8_t* bitmap = fill_order == 2 ? kBitMaps.same : kBitMaps.rev;
    const uint8_t* cp = in;
    const uint8_t* ep = in + n;
    uint32_t BitAcc = 0;
    int BitsAvail = 0, EOLcnt = 0;
    const int lastx = width;
    const int64_t rowbytes = (width + 7) / 8;
    const bool two_d = compression == 4 || (compression == 3 && (g3opts & 1));
    const uint32_t nruns = ((uint32_t)width + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    uint32_t* curruns = runs;
    uint32_t* refruns = two_d ? runs + nruns : nullptr;
    if (refruns) {
        refruns[0] = (uint32_t)width;
        refruns[1] = 0;
    }
    counts[0] = counts[1] = 0;
    int64_t line = 0;
    int64_t warned = 0;
    uint8_t* buf = out;
    int a0 = 0, RunLength = 0, b1 = 0, is1D = 1;
    uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
    const TabEnt* TabEnt = nullptr;

#define EndOfData() (cp >= ep)
#define NeedBits8(nb, eoflab)                                          \
    do {                                                                \
        if (BitsAvail < (nb)) {                                         \
            if (EndOfData()) {                                          \
                if (BitsAvail == 0) goto eoflab;                        \
                BitsAvail = (nb);                                       \
            } else {                                                    \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;       \
                BitsAvail += 8;                                         \
            }                                                           \
        }                                                               \
    } while (0)
#define NeedBits16(nb, eoflab)                                         \
    do {                                                                \
        if (BitsAvail < (nb)) {                                         \
            if (EndOfData()) {                                          \
                if (BitsAvail == 0) goto eoflab;                        \
                BitsAvail = (nb);                                       \
            } else {                                                    \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;       \
                if ((BitsAvail += 8) < (nb)) {                          \
                    if (EndOfData()) {                                  \
                        BitsAvail = (nb);                               \
                    } else {                                            \
                        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail; \
                        BitsAvail += 8;                                 \
                    }                                                   \
                }                                                       \
            }                                                           \
        }                                                               \
    } while (0)
#define GetBits(nb) (BitAcc & ((1u << (nb)) - 1))
#define ClrBits(nb)        \
    do {                   \
        BitsAvail -= (nb); \
        BitAcc >>= (nb);   \
    } while (0)
#define LOOKUP8(wid, tab, eoflab)        \
    do {                                 \
        NeedBits8(wid, eoflab);          \
        TabEnt = tab + GetBits(wid);     \
        ClrBits(TabEnt->width);          \
    } while (0)
#define LOOKUP16(wid, tab, eoflab)       \
    do {                                 \
        NeedBits16(wid, eoflab);         \
        TabEnt = tab + GetBits(wid);     \
        ClrBits(TabEnt->width);          \
    } while (0)
#define WARN() (++warned)
#define OVERFLOW() goto overflow
#define SETVALUE(x)                                  \
    do {                                             \
        if (pa >= thisrun + nruns) OVERFLOW();       \
        *pa++ = (uint32_t)(RunLength + (x));         \
        a0 += (x);                                   \
        RunLength = 0;                               \
    } while (0)
#define CLEANUP_RUNS()                                   \
    do {                                                 \
        if (RunLength) SETVALUE(0);                      \
        if (a0 != lastx) {                               \
            WARN();                                      \
            while (a0 > lastx && pa > thisrun)           \
                a0 -= (int)*--pa;                        \
            if (a0 < lastx) {                            \
                if (a0 < 0) a0 = 0;                      \
                if ((pa - thisrun) & 1) SETVALUE(0);     \
                SETVALUE(lastx - a0);                    \
            } else if (a0 > lastx) {                     \
                SETVALUE(lastx);                         \
                SETVALUE(0);                             \
            }                                            \
        }                                                \
    } while (0)
#define CHECK_b1                                             \
    do {                                                     \
        if (pa != thisrun)                                   \
            while (b1 <= a0 && b1 < lastx) {                 \
                if (pb + 1 >= refruns + nruns) OVERFLOW();   \
                b1 += (int)(pb[0] + pb[1]);                  \
                pb += 2;                                     \
            }                                                \
    } while (0)
    // one 1-D row (EXPAND1D); on the end of the data, to eof1 after
    // CLEANUP_RUNS
#define EXPAND1D(eoflab)                                         \
    do {                                                         \
        for (;;) {                                               \
            for (;;) {                                           \
                LOOKUP16(12, kFax.white, eof1d_##eoflab);        \
                switch (TabEnt->state) {                         \
                case S_EOL: EOLcnt = 1; goto done1d_##eoflab;    \
                case S_TermW:                                    \
                    SETVALUE(TabEnt->param);                     \
                    goto doneWhite1d_##eoflab;                   \
                case S_MakeUpW: case S_MakeUp:                   \
                    a0 += TabEnt->param;                         \
                    RunLength += TabEnt->param;                  \
                    break;                                       \
                default: WARN(); goto done1d_##eoflab;           \
                }                                                \
            }                                                    \
        doneWhite1d_##eoflab:                                    \
            if (a0 >= lastx) goto done1d_##eoflab;               \
            for (;;) {                                           \
                LOOKUP16(13, kFax.black, eof1d_##eoflab);        \
                switch (TabEnt->state) {                         \
                case S_EOL: EOLcnt = 1; goto done1d_##eoflab;    \
                case S_TermB:                                    \
                    SETVALUE(TabEnt->param);                     \
                    goto doneBlack1d_##eoflab;                   \
                case S_MakeUpB: case S_MakeUp:                   \
                    a0 += TabEnt->param;                         \
                    RunLength += TabEnt->param;                  \
                    break;                                       \
                default: WARN(); goto done1d_##eoflab;           \
                }                                                \
            }                                                    \
        doneBlack1d_##eoflab:                                    \
            if (a0 >= lastx) goto done1d_##eoflab;               \
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;       \
        }                                                        \
    eof1d_##eoflab:                                              \
        WARN();                                                  \
        CLEANUP_RUNS();                                          \
        goto eoflab;                                             \
    done1d_##eoflab:                                             \
        CLEANUP_RUNS();                                          \
    } while (0)

    for (; line < rows; ++line) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns;
        if (compression == 2 || compression == 32771) {
            EXPAND1D(eof_rle);
            fill_runs(buf, thisrun, pa, lastx);
            {
                const int pad = BitsAvail & (compression == 2 ? 7 : 15);
                ClrBits(pad);
                if (compression == 32771 && BitsAvail == 0 &&
                    (((cp - in) + odd) & 1))
                    ++cp;
            }
            buf += rowbytes;
            continue;
        eof_rle:
            fill_runs(buf, thisrun, pa, lastx);
            goto done;
        }
        if (compression == 3) {
            // SYNC_EOL: past the next EOL. Data that ends inside one
            // (its zeros found, not its 1 bit) switches the page to
            // FAXMODE_NOEOL, and the strip is decoded again from its
            // start into this row on, with no EOL looked for.
            if (!*noeol) {
                if (EOLcnt == 0) {
                    for (;;) {
                        NeedBits16(11, eof_g3);
                        if (GetBits(11) == 0) break;
                        ClrBits(1);
                    }
                }
                for (;;) {
                    NeedBits8(8, no_eol_found);
                    if (GetBits(8)) break;
                    ClrBits(8);
                }
                while (GetBits(1) == 0) ClrBits(1);
                ClrBits(1);
                EOLcnt = 0;
                goto eol_synced;
            no_eol_found:
                *noeol = 1;
                WARN();
                cp = in;
                BitAcc = 0;
                BitsAvail = 0;
                EOLcnt = 0;
                a0 = 0;
                RunLength = 0;
                pa = thisrun = curruns;
            }
        eol_synced:
            if (two_d) {
                NeedBits8(1, eof_g3);
                is1D = (int)GetBits(1);
                ClrBits(1);
            }
        }
        if (two_d) {
            pb = refruns;
            b1 = (int)*pb++;
        }
        if (!two_d || (compression == 3 && is1D)) {
            EXPAND1D(eof_g3a);
        } else {
            // EXPAND2D
            while (a0 < lastx) {
                if (pa >= thisrun + nruns) OVERFLOW();
                LOOKUP8(7, kFax.main, eof2d);
                switch (TabEnt->state) {
                case S_Pass:
                    CHECK_b1;
                    if (pb + 1 >= refruns + nruns) OVERFLOW();
                    b1 += (int)*pb++;
                    RunLength += b1 - a0;
                    a0 = b1;
                    b1 += (int)*pb++;
                    break;
                case S_Horiz:
                    if ((pa - thisrun) & 1) {
                        for (;;) {  // black first
                            LOOKUP16(13, kFax.black, eof2d);
                            switch (TabEnt->state) {
                            case S_TermB:
                                SETVALUE(TabEnt->param);
                                goto doneWhite2da;
                            case S_MakeUpB: case S_MakeUp:
                                a0 += TabEnt->param;
                                RunLength += TabEnt->param;
                                break;
                            default: goto badBlack2d;
                            }
                        }
                    doneWhite2da:;
                        for (;;) {  // then white
                            LOOKUP16(12, kFax.white, eof2d);
                            switch (TabEnt->state) {
                            case S_TermW:
                                SETVALUE(TabEnt->param);
                                goto doneBlack2da;
                            case S_MakeUpW: case S_MakeUp:
                                a0 += TabEnt->param;
                                RunLength += TabEnt->param;
                                break;
                            default: goto badWhite2d;
                            }
                        }
                    doneBlack2da:;
                    } else {
                        for (;;) {  // white first
                            LOOKUP16(12, kFax.white, eof2d);
                            switch (TabEnt->state) {
                            case S_TermW:
                                SETVALUE(TabEnt->param);
                                goto doneWhite2db;
                            case S_MakeUpW: case S_MakeUp:
                                a0 += TabEnt->param;
                                RunLength += TabEnt->param;
                                break;
                            default: goto badWhite2d;
                            }
                        }
                    doneWhite2db:;
                        for (;;) {  // then black
                            LOOKUP16(13, kFax.black, eof2d);
                            switch (TabEnt->state) {
                            case S_TermB:
                                SETVALUE(TabEnt->param);
                                goto doneBlack2db;
                            case S_MakeUpB: case S_MakeUp:
                                a0 += TabEnt->param;
                                RunLength += TabEnt->param;
                                break;
                            default: goto badBlack2d;
                            }
                        }
                    doneBlack2db:;
                    }
                    CHECK_b1;
                    break;
                case S_V0:
                    CHECK_b1;
                    SETVALUE(b1 - a0);
                    if (pb >= refruns + nruns) OVERFLOW();
                    b1 += (int)*pb++;
                    break;
                case S_VR:
                    CHECK_b1;
                    SETVALUE(b1 - a0 + TabEnt->param);
                    if (pb >= refruns + nruns) OVERFLOW();
                    b1 += (int)*pb++;
                    break;
                case S_VL:
                    CHECK_b1;
                    if (b1 < (int)(a0 + TabEnt->param)) {
                        WARN();
                        goto eol2d;
                    }
                    SETVALUE(b1 - a0 - TabEnt->param);
                    b1 -= (int)*--pb;
                    break;
                case S_Ext:
                    *pa++ = (uint32_t)(lastx - a0);
                    ++counts[0];
                    goto eol2d;
                case S_EOL:
                    *pa++ = (uint32_t)(lastx - a0);
                    NeedBits8(4, eof2d);
                    if (GetBits(4)) WARN();
                    ClrBits(4);
                    EOLcnt = 1;
                    goto eol2d;
                default:
                badMain2d:
                    WARN();
                    goto eol2d;
                badBlack2d:
                    WARN();
                    goto eol2d;
                badWhite2d:
                    WARN();
                    goto eol2d;
                }
            }
            if (RunLength) {
                if (RunLength + a0 < lastx) {  // expect a final V0
                    NeedBits8(1, eof2d);
                    if (!GetBits(1)) goto badMain2d;
                    ClrBits(1);
                }
                SETVALUE(0);
            }
        eol2d:
            CLEANUP_RUNS();
            goto row_done;
        eof2d:
            WARN();
            CLEANUP_RUNS();
            goto eof_g3a;
        }
    row_done:
        if (compression == 4 && EOLcnt) goto eof_g4;
        fill_runs(buf, thisrun, pa, lastx);
        if (two_d) {
            if (compression == 4 || pa < thisrun + nruns) SETVALUE(0);
            std::swap(curruns, refruns);
        }
        buf += rowbytes;
        continue;
    eof_g3:
        if (compression == 4) goto eof_g4;
        CLEANUP_RUNS();
    eof_g3a:
        if (compression == 4) goto eof_g4;
        fill_runs(buf, thisrun, pa, lastx);
        goto done;
    eof_g4:
        // T.6: the row begun is filled and the strip ends
        fill_runs(buf, thisrun, pa, lastx);
        goto done;
    }
done:
    counts[1] = warned;
    return line;
overflow:
    // libtiff's "Buffer overflow": the strip ends, this row unfilled
    counts[1] = warned + 1;
    return line;
#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef WARN
#undef OVERFLOW
#undef SETVALUE
#undef CLEANUP_RUNS
#undef CHECK_b1
#undef EXPAND1D
}

// tif_color.c TIFFYCbCrtoRGB over n pixels of (Y, Cb, Cr) into RGB, with
// the tables io/images.py builds as TIFFYCbCrToRGBInit does: tabs holds
// Y, Cr->R, Cb->B, Cr->G and Cb->G, 256 entries each.
extern "C" void ocr_tiff_ycbcr(const uint8_t* ycc, int64_t n,
                               const int32_t* tabs, uint8_t* out) {
    const int32_t *y_tab = tabs, *cr_r = tabs + 256, *cb_b = tabs + 512,
                  *cr_g = tabs + 768, *cb_g = tabs + 1024;
    auto clamp = [](int32_t v) {
        return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    for (int64_t i = 0; i < n; ++i) {
        const int32_t y = y_tab[ycc[3 * i]];
        const int cb = ycc[3 * i + 1], cr = ycc[3 * i + 2];
        out[3 * i] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
}

// ThunderScan 4-bit (compression 32809) as tif_thunder.c decodes it: each
// row of `width` pixels on its own (ThunderDecodeRow), the pixels packed
// two a byte, first in the high nibble. A row whose codes give too few or
// too many pixels is zeroed from where it stopped, and the strip ends
// there. Returns the rows decoded in full.
extern "C" int64_t ocr_tiff_thunder(const uint8_t* in, int64_t n,
                                    uint8_t* out, int width, int rows) {
    static const int two[4] = {0, 1, 0, -1};
    static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    const int64_t rowbytes = ((int64_t)width + 1) / 2;
    const uint8_t* bp = in;
    int64_t cc = n;
    for (int y = 0; y < rows; ++y) {
        uint8_t* op0 = out + y * rowbytes;
        uint8_t* op = op0;
        const int64_t maxpixels = width;
        unsigned lastpixel = 0;
        int64_t npixels = 0;
        auto set = [&](unsigned v) {
            lastpixel = v & 0xf;
            if (npixels < maxpixels) {
                if (npixels++ & 1) *op++ |= (uint8_t)lastpixel;
                else op[0] = (uint8_t)(lastpixel << 4);
            }
        };
        while (cc > 0 && npixels < maxpixels) {
            int c = *bp++, delta;
            cc--;
            switch (c & 0xc0) {
            case 0x00: {  // a run of the last pixel
                int64_t k = c;
                if (npixels & 1) {
                    op[0] |= (uint8_t)lastpixel;
                    lastpixel = *op++;
                    npixels++;
                    k--;
                } else {
                    lastpixel |= lastpixel << 4;
                }
                npixels += k;
                if (npixels <= maxpixels)
                    for (; k > 0; k -= 2) *op++ = (uint8_t)lastpixel;
                if (k == -1) *--op &= 0xf0;
                lastpixel &= 0xf;
                break;
            }
            case 0x40:  // three 2-bit deltas
                if ((delta = (c >> 4) & 3) != 2) set(lastpixel + two[delta]);
                if ((delta = (c >> 2) & 3) != 2) set(lastpixel + two[delta]);
                if ((delta = c & 3) != 2) set(lastpixel + two[delta]);
                break;
            case 0x80:  // two 3-bit deltas
                if ((delta = (c >> 3) & 7) != 4) set(lastpixel + three[delta]);
                if ((delta = c & 7) != 4) set(lastpixel + three[delta]);
                break;
            default:  // a raw pixel
                set((unsigned)c);
            }
        }
        if (npixels != maxpixels) {
            std::memset(op, 0, (size_t)(op0 + (maxpixels + 1) / 2 - op));
            return y;
        }
    }
    return rows;
}

// SGI LogL (luv 0), LogLuv 32-bit (luv 1) and LogLuv 24-bit (luv 2,
// compression 34677: three bytes a pixel, not run-length coded) rows as
// tif_luv.c decodes
// them under the RGBA interface's SGILOGDATAFMT_8BIT: each row's byte
// planes run-length coded, most significant first (LogL16Decode,
// LogLuvDecode32), then L16toGry (one byte a pixel) or Luv32toRGB (three).
// A row whose data runs out stays zero and ends the strip. Returns the
// rows decoded.
extern "C" int64_t ocr_tiff_sgilog(const uint8_t* in, int64_t n,
                                   uint8_t* out, int width, int rows,
                                   int luv) {
    const int nbytes = luv ? 4 : 2;
    const uint8_t* bp = in;
    int64_t cc = n;
    std::vector<uint32_t> tp(width);
    // XYZtoRGB24's gun: gamma 2
    auto gun = [](double v) -> uint8_t {
        return (uint8_t)(v <= 0. ? 0 : v >= 1. ? 255 : (int)(256. * std::sqrt(v)));
    };
    if (luv == 2) {  // LogLuvDecode24: 3 bytes a pixel, no coding
        for (int y = 0; y < rows; ++y) {
            if (cc < 3 * (int64_t)width) return y;
            uint8_t* op = out + (int64_t)y * width * 3;
            for (int x = 0; x < width; ++x, bp += 3, cc -= 3) {
                const uint32_t p = (uint32_t)bp[0] << 16 | bp[1] << 8 | bp[2];
                float xyz[3] = {0.f, 0.f, 0.f};
                const int le = p >> 14 & 0x3ff;  // LogL10toY
                const double L =
                    le ? std::exp(M_LN2 / 64. * (le + .5) - M_LN2 * 12.) : 0.;
                if (L > 0.) {
                    double u, v;
                    if (!uv_decode(&u, &v, (int)(p & 0x3fff))) {
                        u = 0.210526316;
                        v = 0.473684211;
                    }
                    const double s = 1. / (6. * u - 16. * v + 12.);
                    const double xx = 9. * u * s, yy = 4. * v * s;
                    xyz[0] = (float)(xx / yy * L);
                    xyz[1] = (float)L;
                    xyz[2] = (float)((1. - xx - yy) / yy * L);
                }
                op[3 * x] = gun(2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2]);
                op[3 * x + 1] = gun(-1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2]);
                op[3 * x + 2] = gun(0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2]);
            }
        }
        return rows;
    }
    auto y_of = [](int p16) -> double {  // LogL16toY
        const int le = p16 & 0x7fff;
        if (!le) return 0.;
        const double y = std::exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.);
        return !(p16 & 0x8000) ? y : -y;
    };
    for (int y = 0; y < rows; ++y) {
        std::fill(tp.begin(), tp.end(), 0u);
        for (int shft = 8 * (nbytes - 1); shft >= 0; shft -= 8) {
            int i = 0;
            while (i < width && cc > 0) {
                if (*bp >= 128) {  // a run
                    if (cc < 2) break;
                    int rc = *bp++ + (2 - 128);
                    const uint32_t b = (uint32_t)*bp++ << shft;
                    cc -= 2;
                    while (rc-- && i < width) tp[i++] |= b;
                } else {  // a literal string; 0 does nothing
                    int rc = *bp++;
                    while (--cc && rc-- && i < width)
                        tp[i++] |= (uint32_t)*bp++ << shft;
                }
            }
            if (i != width) return y;
        }
        uint8_t* op = out + (int64_t)y * width * (luv ? 3 : 1);
        for (int x = 0; x < width; ++x) {
            if (!luv) {
                op[x] = gun(y_of((int16_t)tp[x]));
                continue;
            }
            // LogLuv32toXYZ, then XYZtoRGB24 (CCIR-709 primaries, gamma 2)
            const uint32_t p = tp[x];
            float xyz[3] = {0.f, 0.f, 0.f};
            const double L = y_of((int)p >> 16);
            if (L > 0.) {
                const double u = 1. / 410. * ((p >> 8 & 0xff) + .5);
                const double v = 1. / 410. * ((p & 0xff) + .5);
                const double s = 1. / (6. * u - 16. * v + 12.);
                const double xx = 9. * u * s, yy = 4. * v * s;
                xyz[0] = (float)(xx / yy * L);
                xyz[1] = (float)L;
                xyz[2] = (float)((1. - xx - yy) / yy * L);
            }
            const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
            const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
            const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
            op[3 * x] = gun(r);
            op[3 * x + 1] = gun(g);
            op[3 * x + 2] = gun(b);
        }
    }
    return rows;
}

// CIE L*a*b* -> RGB as libtiff's RGBA interface maps it (tif_getimage.c
// putcontig8bitCIELab8/16, tif_color.c TIFFCIELab16ToXYZ and TIFFXYZToRGB
// with the sRGB display and tables of TIFFCIELabToRGBInit), in float as
// libtiff computes it. white: the reference white's X0, Y0, Z0. bits 8:
// lab holds n * 3 bytes (a and b signed); 16: n * 3 uint16 (a, b signed).
extern "C" void ocr_tiff_cielab(const void* lab, int64_t n, int bits,
                                const float* white, uint8_t* out) {
    static const float mat[9] = {3.2410F, -1.5374F, -0.4986F,
                                 -0.9692F, 1.8760F,  0.0416F,
                                 0.0556F,  -0.2040F, 1.0570F};
    const int range = 1500;
    static float table[1501];
    static bool ready = false;
    if (!ready) {
        const double gamma = 1.0 / 2.4F;
        for (int i = 0; i <= range; ++i)
            table[i] = 255u * ((float)std::pow((double)i / range, gamma));
        ready = true;
    }
    const float step = (100.0F - 1.0F) / range;
    const float X0 = white[0], Y0 = white[1], Z0 = white[2];
    for (int64_t k = 0; k < n; ++k) {
        uint32_t l;
        int32_t a, b;
        if (bits == 8) {
            const uint8_t* p = (const uint8_t*)lab + 3 * k;
            l = p[0] * 257u;
            a = (int8_t)p[1] * 256;
            b = (int8_t)p[2] * 256;
        } else {
            const uint16_t* p = (const uint16_t*)lab + 3 * k;
            l = p[0];
            a = (int16_t)p[1];
            b = (int16_t)p[2];
        }
        const float L = (float)l * 100.0F / 65535.0F;
        float X, Y, Z, cby, tmp;
        if (L < 8.856F) {
            Y = (L * Y0) / 903.292F;
            cby = 7.787F * (Y / Y0) + 16.0F / 116.0F;
        } else {
            cby = (L + 16.0F) / 116.0F;
            Y = Y0 * cby * cby * cby;
        }
        tmp = (float)a / 256.0F / 500.0F + cby;
        if (tmp < 0.2069F) X = X0 * (tmp - 0.13793F) / 7.787F;
        else X = X0 * tmp * tmp * tmp;
        tmp = cby - (float)b / 256.0F / 200.0F;
        if (tmp < 0.2069F) Z = Z0 * (tmp - 0.13793F) / 7.787F;
        else Z = Z0 * tmp * tmp * tmp;
        for (int c = 0; c < 3; ++c) {
            float v = mat[3 * c] * X + mat[3 * c + 1] * Y + mat[3 * c + 2] * Z;
            v = std::max(v, 1.0F);
            v = std::min(v, 100.0F);
            size_t i = (size_t)((v - 1.0F) / step);
            i = std::min((size_t)range, i);
            const float t = table[i];
            uint32_t o = (uint32_t)(t > 0 ? (t + 0.5) : (t - 0.5));
            out[3 * k + c] = (uint8_t)std::min(o, 255u);
        }
    }
}
