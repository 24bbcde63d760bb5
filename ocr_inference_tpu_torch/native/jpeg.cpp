// JPEG decoding for the port's image reader (io/images.py), byte-equal
// with what libjpeg-turbo 3.1 gives cv2.imread at its defaults:
//
// - baseline, extended (8-bit) and progressive, Huffman or arithmetic
//   coding (jdarith.c, DAC conditioning), restart intervals, 1, 3 or 4
//   components, any integral sampling factors;
// - lossless frames (SOF3: jdlossls.c, jddiffct.c, jdlhuff.c; predictors
//   1-7, point transform, restarts), every component sampled 1x1;
// - progressive block smoothing (jdcoefct.c decompress_smooth_data, the
//   5x5 DC window of libjpeg-turbo 2.1+) when the scans leave one of the
//   first 10 coefficients of a component unsent or short of bits;
// - the accurate integer IDCT (jidctint.c, "islow") as libjpeg-turbo's
//   AVX2 code computes it, out-of-range data included;
// - fancy upsampling (jdsample.c): triangle filters for h2v1, h1v2 and
//   h2v2, box replication for the other ratios and for h2v1/h2v2 chroma
//   at most 2 samples wide;
// - YCbCr -> RGB with jdcolor.c's fixed-point tables; RGB JPEGs (Adobe
//   transform 0, or component ids 'R' 'G' 'B') are copied; gray is
//   expanded to three channels by the caller; four components are CMYK
//   (YCCK under Adobe transform 2, turned into CMYK as jdcolor.c does),
//   then RGB by OpenCV's icvCvt_CMYK2BGR_8u_C4C3R;
// - the strips and tiles of JPEG-in-TIFF (ocr_jpeg_tiff): a JPEGTables
//   stream's tables first, then the strip's abbreviated stream, its
//   colour handled as libtiff's tif_jpeg.c asks libjpeg to;
// - corrupt data as libjpeg treats it: a bad Huffman code gives symbol 0
//   after 17 bits; past the end of a segment the bits are zeros, and the
//   MCUs after the first one that needed them stay zero (mid-gray); after
//   the end of the data the reader finds fake EOI markers, as libjpeg's
//   data sources insert them; libjpeg's segment checks, and the standard
//   Huffman tables for a sequential scan's slots no DHT defined.
//
// 12-bit DCT and arithmetic lossless frames are JPEG_CORRUPT, as they are
// to OpenCV 5.0 and to an 8-bit TIFF page. EXIF orientation is applied by
// the caller. The return codes name what is not decoded here: see JPEG_*
// below.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
    JPEG_OK = 0,
    JPEG_CORRUPT = 1,         // cv2.imread gives None
    JPEG_LOSSLESS_SUBSAMPLED = 3,  // lossless, a component not 1x1
};

// zigzag index -> natural index, with libjpeg's 16 safety entries
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool defined = false;
    uint8_t counts[17] = {};
    uint8_t symbols[256] = {};
    // derived: canonical decoding (jdhuff.c jpeg_make_d_derived_tbl)
    int32_t maxcode[18];
    int32_t valoffset[17];
    uint16_t look[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = miss
    // dc: symbols are magnitude categories, at most 15 (16 in a
    // lossless frame: jpeg_make_d_derived_tbl)
    bool build(bool dc, int max_category = 15) {
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l) {
            int c = counts[l];
            if (p + c > 256) return false;
            while (c--) huffsize[p++] = l;
        }
        huffsize[p] = 0;
        const int numsymbols = p;
        int code = 0, si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) {
                huffcode[p++] = code;
                code++;
            }
            if ((int64_t)code >= ((int64_t)1 << si)) return false;
            code <<= 1;
            si++;
        }
        p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (counts[l]) {
                valoffset[l] = p - huffcode[p];
                p += counts[l];
                maxcode[l] = huffcode[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        maxcode[17] = 0x7fffffff;
        std::memset(look, 0, sizeof(look));
        p = 0;
        for (int l = 1; l <= 9; ++l) {
            for (int i = 0; i < counts[l]; ++i, ++p) {
                int lookbits = huffcode[p] << (9 - l);
                for (int ctr = 1 << (9 - l); ctr > 0; --ctr)
                    look[lookbits++] = (uint16_t)((l << 8) | symbols[p]);
            }
        }
        if (dc)
            for (int i = 0; i < numsymbols; ++i)
                if (symbols[i] > max_category) return false;
        return true;
    }
};

// jstdhuff.c: the Annex K tables libjpeg-turbo's sequential decoder puts
// in Huffman slots 0 and 1 when no DHT has defined them
const uint8_t kStdDcLumaBits[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00};
const uint8_t kStdDcLumaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdDcChromaBits[] = {
    0x00, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01,
    0x00, 0x00, 0x00, 0x00, 0x00};
const uint8_t kStdDcChromaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcLumaBits[] = {
    0x00, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04,
    0x04, 0x00, 0x00, 0x01, 0x7d};
const uint8_t kStdAcLumaVals[] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromaBits[] = {
    0x00, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04,
    0x04, 0x00, 0x01, 0x02, 0x77};
const uint8_t kStdAcChromaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// the standard table of slot tblno (0 or 1) into h
void std_huffman(Huffman& h, bool dc, int tblno) {
    const uint8_t* bits = dc ? (tblno ? kStdDcChromaBits : kStdDcLumaBits)
                             : (tblno ? kStdAcChromaBits : kStdAcLumaBits);
    const uint8_t* vals = dc ? (tblno ? kStdDcChromaVals : kStdDcLumaVals)
                             : (tblno ? kStdAcChromaVals : kStdAcLumaVals);
    int total = 0;
    for (int l = 0; l <= 16; ++l) {
        h.counts[l] = bits[l];
        total += bits[l];
    }
    std::memset(h.symbols, 0, sizeof(h.symbols));
    std::memcpy(h.symbols, vals, total);
    h.defined = true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;        // allocated blocks per row / column
    int wblocks = 0, hblocks = 0;  // blocks of the component's own size
    int dw = 0, dh = 0;        // downsampled width / height
    int qlatched = -1;         // quantisation table latched at first scan
    uint16_t q[64];            // latched table, natural order
    std::vector<int16_t> coef; // bw * bh blocks of 64, natural order
    int coef_bits[64];         // progressive: -1 unsent, else Al still owed
    int prev_coef_bits[64];    // coef_bits before this component's last scan
};

struct Reader {
    const uint8_t* data;
    int64_t n, pos;
    uint64_t acc = 0;
    int nbits = 0;   // valid bits in acc (real and zero padding)
    int real = 0;    // real bits among them
    bool marker_hit = false;
    int marker = 0;  // the marker code that stopped the reader
    bool insufficient = false;

    void reset_bits() {
        acc = 0;
        nbits = real = 0;
    }
    void fill() {
        while (nbits <= 56) {
            int c = 0;
            bool is_real = false;
            if (!marker_hit) {
                if (pos >= n) {
                    // the source's fake EOI at the end of the file
                    marker_hit = true;
                    marker = 0xD9;
                } else {
                    c = data[pos++];
                    if (c == 0xFF) {
                        int c2;
                        do {
                            c2 = pos < n ? data[pos++] : -1;
                        } while (c2 == 0xFF);
                        if (c2 == 0) {
                            is_real = true;
                        } else {
                            marker_hit = true;
                            marker = c2 < 0 ? 0xD9 : c2;
                            c = 0;
                        }
                    } else {
                        is_real = true;
                    }
                }
            }
            acc |= (uint64_t)c << (56 - nbits);
            nbits += 8;
            if (is_real) real += 8;
        }
    }
    inline void consume(int k) {
        if (k > real) {
            insufficient = true;
            real = 0;
        } else {
            real -= k;
        }
        acc <<= k;
        nbits -= k;
    }
    inline int get_bits(int k) {
        if (k == 0) return 0;
        if (nbits < k) fill();
        int v = (int)(acc >> (64 - k));
        consume(k);
        return v;
    }
    inline int decode(const Huffman& h) {
        if (nbits < 17) fill();  // a bad code takes 17 bits
        int peek = (int)(acc >> (64 - 9));
        int e = h.look[peek];
        if (e) {
            consume(e >> 8);
            return e & 0xFF;
        }
        // slow path: the code is longer than 9 bits (or is bad)
        int code = (int)(acc >> (64 - 9));
        int l = 9;
        while (l < 16 && code > h.maxcode[l]) {
            code = (int)(acc >> (64 - (l + 1)));
            ++l;
        }
        if (code > h.maxcode[l]) {
            // jpeg_huff_decode: JWRN_HUFF_BAD_CODE, symbol 0, after
            // reading 17 bits
            consume(17);
            return 0;
        }
        consume(l);
        return h.symbols[(code + h.valoffset[l]) & 0xFF];
    }
};

// jaricom.c jpeg_aritab (T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(qe, lps, mps, sw) \
    (((uint32_t)(qe) << 16) | ((uint32_t)(mps) << 8) | ((sw) << 7) | (lps))
const uint32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),    V(0x2586, 14, 2, 0),   V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),   V(0x03d8, 20, 5, 0),   V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),   V(0x006f, 28, 8, 0),   V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),  V(0x000d, 35, 11, 0),  V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),  V(0x0001, 12, 13, 0),  V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),  V(0x2cf2, 38, 17, 0),  V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),  V(0x1182, 42, 20, 0),  V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),  V(0x072f, 46, 23, 0),  V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),  V(0x0303, 51, 26, 0),  V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),  V(0x0144, 56, 29, 0),  V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),  V(0x008a, 60, 32, 0),  V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),  V(0x003b, 32, 35, 0),  V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),  V(0x484c, 64, 38, 0),  V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),  V(0x261f, 68, 41, 0),  V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),  V(0x1518, 72, 44, 0),  V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),  V(0x0bfb, 75, 47, 0),  V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),  V(0x0706, 79, 50, 0),  V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),  V(0x040f, 50, 53, 0),  V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),  V(0x025c, 53, 56, 0),  V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),  V(0x0160, 56, 59, 0),  V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),  V(0x00cb, 59, 62, 0),  V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),  V(0x5b12, 65, 65, 1),  V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),  V(0x37d8, 82, 68, 0),  V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),  V(0x2379, 86, 71, 0),  V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),  V(0x174e, 72, 74, 0),  V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),  V(0x0f6b, 74, 77, 0),  V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),  V(0x0a40, 77, 48, 0),  V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),  V(0x438e, 89, 83, 0),  V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),  V(0x2eae, 92, 86, 0),  V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),  V(0x5570, 88, 89, 1),  V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),  V(0x3e22, 97, 92, 0),  V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),  V(0x2e17, 93, 86, 0),  V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// jdarith.c's decoder (T.81 Annex D): the C register holds the interval
// base and the bits not yet used, their count in ct (-16 before the first
// two bytes, -1 after an error). A marker met inside the data is left
// unread, and zeros are fed from then on, as libjpeg does.
struct Arith {
    const uint8_t* data;
    int64_t n, pos;
    bool marker_hit = false;
    int marker = 0;
    bool insufficient = false;  // never set: arithmetic data runs on
    int64_t c = 0, a = 0;
    int ct = -16;

    void reset_bits() {
        c = a = 0;
        ct = -16;
    }
    // the next byte; -1 past the data (which ends in fake EOIs anyway)
    int get_byte() { return pos < n ? data[pos++] : -1; }
    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                int d = 0;
                if (!marker_hit) {
                    d = get_byte();
                    if (d == 0xFF) {
                        do d = get_byte();
                        while (d == 0xFF);
                        if (d == 0) {
                            d = 0xFF;  // a stuffed zero
                        } else {  // a marker: zeros from now on
                            marker_hit = true;
                            marker = d < 0 ? 0xD9 : d;
                            d = 0;
                        }
                    } else if (d < 0) {
                        marker_hit = true;
                        marker = 0xD9;
                        d = 0;
                    }
                }
                c = (c << 8) | d;
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAritab[sv & 0x7F];
        const uint8_t nl = qe & 0xFF;
        qe >>= 8;
        const uint8_t nm = qe & 0xFF;
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r;
}

struct Decoder {
    const uint8_t* data = nullptr;
    int64_t n = 0;
    int64_t pos = 0;
    uint16_t qt[4][64];
    bool qt_defined[4] = {};
    Huffman dc[4], ac[4];
    int restart_interval = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    bool frame = false, progressive = false;
    int width = 0, height = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    std::vector<Component> comps;
    int next_marker = -1;  // marker already read by a scan's bit reader
    int scans = 0;         // SOS markers read (input_scan_number)
    int total_imcu_rows = 0;
    int last_good_imcu_row = 0;  // of the last scan, before data ran out
    int max_height = 0;    // > 0: the frame's height cut to this (TIFF)
    int lossless_precision = 0;     // > 0: a lossless frame
    int sample_precision = 8;
    bool headers_only = false;      // parse(true): scans are not decoded
    // a lossless frame's samples, one plane a component (1x1 sampling)
    std::vector<std::vector<uint16_t>> planes;
    bool arith = false;             // arithmetic coding (SOF9-11)
    // DAC conditioning, reset at SOI: DC L and U, AC Kx per table
    uint8_t dac_L[16], dac_U[16], dac_K[16];
    uint8_t dc_stats[16][64], ac_stats[16][256];
    Decoder() {
        std::memset(dac_L, 0, 16);
        std::memset(dac_U, 1, 16);
        std::memset(dac_K, 5, 16);
    }

    int u16(int64_t at) const { return (data[at] << 8) | data[at + 1]; }

    // next marker code after pos, skipping garbage and fill bytes as
    // jdmarker.c next_marker does; -1 at the end of the data
    int read_marker() {
        if (next_marker >= 0) {
            int m = next_marker;
            next_marker = -1;
            return m;
        }
        for (;;) {
            while (pos < n && data[pos] != 0xFF) ++pos;
            if (pos >= n) return -1;
            while (pos < n && data[pos] == 0xFF) ++pos;
            if (pos >= n) return -1;
            int c = data[pos++];
            if (c != 0) return c;
        }
    }

    int parse_sof(int64_t at, int len, int marker) {
        if (frame) return JPEG_CORRUPT;  // jdmarker.c: JERR_SOF_DUPLICATE
        if (len < 6) return JPEG_CORRUPT;
        int precision = data[at];
        height = u16(at + 1);
        width = u16(at + 3);
        int nc = data[at + 5];
        if (len != 6 + 3 * nc || nc == 0) return JPEG_CORRUPT;
        sample_precision = precision;
        if (marker == 0xCB) return JPEG_CORRUPT;  // JERR_ARITH_NOTIMPL
        if (marker == 0xC3) {
            // lossless: its first scan tells whether libjpeg takes it
            if (precision < 2 || precision > 16) return JPEG_CORRUPT;
            if (width == 0 || height == 0) return JPEG_CORRUPT;
            if (max_height > 0 && height > max_height) height = max_height;
            lossless_precision = precision;
            for (int i = 0; i < nc; ++i) {
                comps.emplace_back();
                Component& c = comps.back();
                c.id = data[at + 6 + 3 * i];
                c.h = data[at + 7 + 3 * i] >> 4;
                c.v = data[at + 7 + 3 * i] & 15;
                if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
                    return JPEG_CORRUPT;
            }
            frame = true;
            return JPEG_OK;
        }
        // hierarchical (SOF5-7, SOF13-15): JERR_SOF_UNSUPPORTED
        if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
            return JPEG_CORRUPT;
        arith = marker >= 0xC9;
        // libjpeg-turbo 3 takes 8 and 12 bits for DCT-based JPEG; 12-bit
        // samples need jpeg12_read_scanlines, which OpenCV 5.0 does not
        // call (and libtiff takes only the precision of the page's
        // samples): the frame gives None
        if (precision != 8) return JPEG_CORRUPT;
        if (nc != 1 && nc != 3 && nc != 4) return JPEG_CORRUPT;
        if (width == 0 || height == 0) return JPEG_CORRUPT;
        if (max_height > 0 && height > max_height) height = max_height;
        progressive = marker == 0xC2 || marker == 0xCA;
        comps.resize(nc);
        for (int i = 0; i < nc; ++i) {
            Component& c = comps[i];
            c.id = data[at + 6 + 3 * i];
            c.h = data[at + 7 + 3 * i] >> 4;
            c.v = data[at + 7 + 3 * i] & 15;
            c.tq = data[at + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                return JPEG_CORRUPT;
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        total_imcu_rows = mcuy;
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v) return JPEG_CORRUPT;
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.wblocks = (c.dw + 7) / 8;
            c.hblocks = (c.dh + 7) / 8;
            c.bw = nc == 1 ? c.wblocks : mcux * c.h;
            c.bh = nc == 1 ? c.hblocks : mcuy * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_coef_bits[k] = -1;
        }
        frame = true;
        return JPEG_OK;
    }

    int parse_dqt(int64_t at, int len) {
        int64_t end = at + len;
        while (at < end) {
            int pq = data[at] >> 4, tq = data[at] & 15;
            ++at;
            if (tq > 3 || pq > 1) return JPEG_CORRUPT;
            if (at + 64 * (pq + 1) > end) return JPEG_CORRUPT;
            for (int k = 0; k < 64; ++k) {
                int v = pq ? u16(at + 2 * k) : data[at + k];
                qt[tq][kNatural[k]] = (uint16_t)v;
            }
            at += 64 * (pq + 1);
            qt_defined[tq] = true;
        }
        return JPEG_OK;
    }

    // jdmarker.c get_dac: arithmetic conditioning (DC L and U, AC Kx)
    int parse_dac(int64_t at, int len) {
        if (len & 1) return JPEG_CORRUPT;
        for (int64_t end = at + len; at < end; at += 2) {
            const int index = data[at], val = data[at + 1];
            if (index >= 32) return JPEG_CORRUPT;
            if (index >= 16) {
                dac_K[index - 16] = (uint8_t)val;
            } else {
                dac_L[index] = (uint8_t)(val & 15);
                dac_U[index] = (uint8_t)(val >> 4);
                if (dac_L[index] > dac_U[index]) return JPEG_CORRUPT;
            }
        }
        return JPEG_OK;
    }

    int parse_dht(int64_t at, int len) {
        int64_t end = at + len;
        while (at < end) {
            if (at + 17 > end) return JPEG_CORRUPT;
            int tc = data[at] >> 4, th = data[at] & 15;
            if (tc > 1 || th > 3) return JPEG_CORRUPT;
            Huffman& h = tc ? ac[th] : dc[th];
            int total = 0;
            h.counts[0] = 0;
            for (int l = 1; l <= 16; ++l) {
                h.counts[l] = data[at + l];
                total += h.counts[l];
            }
            at += 17;
            if (total > 256 || at + total > end) return JPEG_CORRUPT;
            std::memset(h.symbols, 0, sizeof(h.symbols));
            std::memcpy(h.symbols, data + at, total);
            at += total;
            h.defined = true;
        }
        return JPEG_OK;
    }

    // jdhuff.c process_restart / jdmarker.c read_restart_marker and
    // jpeg_resync_to_restart
    template <class R>
    void restart(R& r, int& next_rst) {
        r.reset_bits();
        int m;
        if (r.marker_hit) {
            m = r.marker;
            r.marker_hit = false;
        } else {
            pos = r.pos;
            m = read_marker();
            r.pos = pos;
            if (m < 0) m = 0xD9;
        }
        const int desired = next_rst;
        bool leave = false;
        for (;;) {
            int action;
            if (m < 0xC0) {
                action = 2;
            } else if (m < 0xD0 || m > 0xD7) {
                action = 3;
            } else if (m == 0xD0 + ((desired + 1) & 7) ||
                       m == 0xD0 + ((desired + 2) & 7)) {
                action = 3;
            } else if (m == 0xD0 + ((desired - 1) & 7) ||
                       m == 0xD0 + ((desired - 2) & 7)) {
                action = 2;
            } else {
                action = 1;
            }
            if (action == 1) break;
            if (action == 3) {
                leave = true;
                break;
            }
            pos = r.pos;
            m = read_marker();
            r.pos = pos;
            if (m < 0) m = 0xD9;
        }
        if (leave) {
            // the marker stays unread: the next segment decodes as empty
            r.marker_hit = true;
            r.marker = m;
        } else {
            r.insufficient = false;
        }
        next_rst = (next_rst + 1) & 7;
    }

    int scan(int64_t at, int len) {
        if (!frame) return JPEG_CORRUPT;
        int ns = data[at];
        if (ns < 1 || ns > 4 || len != 4 + 2 * ns) return JPEG_CORRUPT;
        int sc[4], td[4], ta[4];
        for (int i = 0; i < ns; ++i) {
            int cid = data[at + 1 + 2 * i];
            int found = -1;
            for (size_t k = 0; k < comps.size(); ++k)
                if (comps[k].id == cid) found = (int)k;
            if (found < 0) return JPEG_CORRUPT;
            for (int j = 0; j < i; ++j)
                if (sc[j] == found) return JPEG_CORRUPT;
            sc[i] = found;
            td[i] = data[at + 2 + 2 * i] >> 4;
            ta[i] = data[at + 2 + 2 * i] & 15;
        }
        int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns];
        int ah = data[at + 3 + 2 * ns] >> 4, al = data[at + 3 + 2 * ns] & 15;
        if (lossless_precision)
            return lossless_scan(at + len, ns, sc, td, ss, se, ah, al);
        if (!progressive) {
            ss = 0;
            se = 63;
            ah = al = 0;
        } else {
            bool dcscan = ss == 0;
            if (dcscan ? se != 0 : (se < ss || se > 63 || ns != 1))
                return JPEG_CORRUPT;
            if ((ah != 0 && al != ah - 1) || al > 13) return JPEG_CORRUPT;
        }
        ++scans;
        if (scans == 1 && !progressive && !arith) {
            // jdhuff.c jinit_huff_decoder: slots 0 and 1 still empty at
            // the first scan get the standard tables (Motion JPEG)
            for (int t = 0; t < 2; ++t) {
                if (!dc[t].defined) std_huffman(dc[t], true, t);
                if (!ac[t].defined) std_huffman(ac[t], false, t);
            }
        }
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            Component& c = comps[sc[i]];
            blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
            if (c.qlatched < 0) {
                if (!qt_defined[c.tq]) return JPEG_CORRUPT;
                std::memcpy(c.q, qt[c.tq], sizeof(c.q));
                c.qlatched = c.tq;
            }
            // the tables a scan uses (jdhuff.c / jdphuff.c start_pass;
            // jdarith.c takes any of its 16, defined or not)
            if (!arith && ss == 0 && ah == 0 &&
                (td[i] > 3 || !dc[td[i]].defined ||
                                       !dc[td[i]].build(true)))
                return JPEG_CORRUPT;
            if (!arith && se > 0 &&
                (ta[i] > 3 || !ac[ta[i]].defined || !ac[ta[i]].build(false)))
                return JPEG_CORRUPT;
            // jdphuff.c start_pass_phuff_decoder: the state before this scan
            for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
                c.prev_coef_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
            for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
        }
        if (blocks_in_mcu > 10) return JPEG_CORRUPT;  // D_MAX_BLOCKS_IN_MCU

        Reader r{data, n, at + len};
        Arith ar{data, n, at + len};
        int last_dc[4] = {0, 0, 0, 0};
        int dc_context[4] = {0, 0, 0, 0};
        uint8_t fixed_bin = 113;  // jdarith.c's fixed 0.5 estimate
        int eobrun = 0;
        int next_rst = 0;
        int restarts_to_go = restart_interval;
        const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
        // jdarith.c start_pass / process_restart: the statistics a scan
        // codes with start from zero
        auto reset_stats = [&]() {
            for (int i = 0; i < ns; ++i) {
                if (!progressive || (ss == 0 && ah == 0)) {
                    std::memset(dc_stats[td[i]], 0, 64);
                    last_dc[i] = dc_context[i] = 0;
                }
                if (!progressive || ss)
                    std::memset(ac_stats[ta[i]], 0, 256);
            }
            ar.reset_bits();
        };
        if (arith) reset_stats();

        // jdarith.c decode_mcu (sequential) and decode_mcu_DC_first,
        // _AC_first, _DC_refine, _AC_refine over one block. A magnitude or
        // spectral overflow (JWRN_ARITH_BAD_CODE) sets ct to -1, and the
        // blocks after it are left alone up to the next restart (a DC
        // refinement reads on regardless).
        auto decode_arith = [&](int16_t* blk, int ci, int tdi, int tai) {
            const bool dc_refine = progressive && ss == 0 && ah != 0;
            if (ar.ct == -1 && !dc_refine) return;
            if (dc_refine) {
                if (ar.decode(&fixed_bin)) blk[0] = (int16_t)(blk[0] | p1);
                return;
            }
            if (!progressive || ss == 0) {  // DC, first or sequential
                uint8_t* st = dc_stats[tdi] + dc_context[ci];
                if (ar.decode(st) == 0) {
                    dc_context[ci] = 0;
                } else {
                    const int sign = ar.decode(st + 1);
                    st += 2 + sign;
                    int m = ar.decode(st);
                    if (m != 0) {
                        st = dc_stats[tdi] + 20;
                        while (ar.decode(st)) {
                            if ((m <<= 1) == 0x8000) {
                                ar.ct = -1;
                                return;
                            }
                            st += 1;
                        }
                    }
                    if (m < (int)((1L << dac_L[tdi]) >> 1))
                        dc_context[ci] = 0;
                    else if (m > (int)((1L << dac_U[tdi]) >> 1))
                        dc_context[ci] = 12 + sign * 4;
                    else
                        dc_context[ci] = 4 + sign * 4;
                    int v = m;
                    st += 14;
                    while (m >>= 1)
                        if (ar.decode(st)) v |= m;
                    v += 1;
                    if (sign) v = -v;
                    last_dc[ci] = (last_dc[ci] + v) & 0xffff;
                }
                blk[0] = (int16_t)(progressive
                                       ? (int)((unsigned)last_dc[ci] << al)
                                       : last_dc[ci]);
                if (progressive) return;
            }
            if (!progressive || ah == 0) {  // AC, first or sequential
                const int k0 = progressive ? ss : 1, ke = progressive ? se : 63;
                for (int k = k0; k <= ke; ++k) {
                    uint8_t* st = ac_stats[tai] + 3 * (k - 1);
                    if (ar.decode(st)) break;  // EOB
                    while (ar.decode(st + 1) == 0) {
                        st += 3;
                        if (++k > ke) {
                            ar.ct = -1;
                            return;
                        }
                    }
                    const int sign = ar.decode(&fixed_bin);
                    st += 2;
                    int m = ar.decode(st);
                    if (m != 0 && ar.decode(st)) {
                        m <<= 1;
                        st = ac_stats[tai] + (k <= dac_K[tai] ? 189 : 217);
                        while (ar.decode(st)) {
                            if ((m <<= 1) == 0x8000) {
                                ar.ct = -1;
                                return;
                            }
                            st += 1;
                        }
                    }
                    int v = m;
                    st += 14;
                    while (m >>= 1)
                        if (ar.decode(st)) v |= m;
                    v += 1;
                    if (sign) v = -v;
                    blk[kNatural[k]] = (int16_t)(progressive
                                                     ? (int)((unsigned)v << al)
                                                     : v);
                }
                return;
            }
            // AC refinement: EOBx is the last coefficient already nonzero
            int kex = se;
            for (; kex > 0; --kex)
                if (blk[kNatural[kex]]) break;
            for (int k = ss; k <= se; ++k) {
                uint8_t* st = ac_stats[tai] + 3 * (k - 1);
                if (k > kex && ar.decode(st)) break;  // EOB
                for (;;) {
                    int16_t* coef = &blk[kNatural[k]];
                    if (*coef) {
                        if (ar.decode(st + 2))
                            *coef = (int16_t)(*coef < 0 ? *coef + m1
                                                        : *coef + p1);
                        break;
                    }
                    if (ar.decode(st + 1)) {
                        *coef = (int16_t)(ar.decode(&fixed_bin) ? m1 : p1);
                        break;
                    }
                    st += 3;
                    if (++k > se) {
                        ar.ct = -1;
                        return;
                    }
                }
            }
        };

        auto decode_block = [&](int16_t* blk, int ci, int tdi, int tai) {
            if (!progressive) {
                int s = r.decode(dc[tdi]);
                if (s) s = extend(r.get_bits(s), s);
                s += last_dc[ci];
                last_dc[ci] = s;
                blk[0] = (int16_t)s;
                for (int k = 1; k < 64; ++k) {
                    int rs = r.decode(ac[tai]);
                    int rr = rs >> 4;
                    s = rs & 15;
                    if (s) {
                        k += rr;
                        s = extend(r.get_bits(s), s);
                        blk[kNatural[k]] = (int16_t)s;
                    } else {
                        if (rr != 15) break;
                        k += 15;
                    }
                }
                return;
            }
            if (ss == 0) {
                if (ah == 0) {
                    int s = r.decode(dc[tdi]);
                    if (s) s = extend(r.get_bits(s), s);
                    s += last_dc[ci];
                    last_dc[ci] = s;
                    blk[0] = (int16_t)(int)((unsigned)s << al);
                } else if (r.get_bits(1)) {
                    blk[0] = (int16_t)(blk[0] | p1);
                }
                return;
            }
            if (ah == 0) {
                if (eobrun > 0) {
                    --eobrun;
                    return;
                }
                for (int k = ss; k <= se; ++k) {
                    int rs = r.decode(ac[tai]);
                    int rr = rs >> 4, s = rs & 15;
                    if (s) {
                        k += rr;
                        s = extend(r.get_bits(s), s);
                        blk[kNatural[k]] = (int16_t)(int)((unsigned)s << al);
                    } else if (rr == 15) {
                        k += 15;
                    } else {
                        eobrun = 1 << rr;
                        if (rr) eobrun += r.get_bits(rr);
                        --eobrun;
                        break;
                    }
                }
                return;
            }
            int k = ss;
            if (eobrun == 0) {
                for (; k <= se; ++k) {
                    int rs = r.decode(ac[tai]);
                    int rr = rs >> 4, s = rs & 15;
                    if (s) {
                        s = r.get_bits(1) ? p1 : m1;
                    } else if (rr != 15) {
                        eobrun = 1 << rr;
                        if (rr) eobrun += r.get_bits(rr);
                        break;
                    }
                    do {
                        int16_t* coef = &blk[kNatural[k]];
                        if (*coef != 0) {
                            if (r.get_bits(1) && (*coef & p1) == 0)
                                *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                             : *coef + m1);
                        } else {
                            if (--rr < 0) break;
                        }
                        ++k;
                    } while (k <= se);
                    if (s) blk[kNatural[k]] = (int16_t)s;
                }
            }
            if (eobrun > 0) {
                for (; k <= se; ++k) {
                    int16_t* coef = &blk[kNatural[k]];
                    if (*coef != 0 && r.get_bits(1) && (*coef & p1) == 0)
                        *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                     : *coef + m1);
                }
                --eobrun;
            }
        };

        auto one_mcu = [&](int imcu_row, auto&& body) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    if (arith) {
                        restart(ar, next_rst);
                        reset_stats();
                    } else {
                        restart(r, next_rst);
                        for (int& d : last_dc) d = 0;
                        eobrun = 0;
                    }
                    restarts_to_go = restart_interval;
                }
                --restarts_to_go;
            }
            // jdcoefct.c consume_data: the row of the last MCU begun
            // before the data ran out
            if (!r.insufficient) last_good_imcu_row = imcu_row;
            // a DC refinement reads on regardless: zeros change nothing
            if (!r.insufficient || (progressive && ss == 0 && ah != 0))
                body();
        };

        auto block = [&](int16_t* blk, int ci, int tdi, int tai) {
            if (arith) decode_arith(blk, ci, tdi, tai);
            else decode_block(blk, ci, tdi, tai);
        };
        if (ns == 1) {
            Component& c = comps[sc[0]];
            for (int by = 0; by < c.hblocks; ++by)
                for (int bx = 0; bx < c.wblocks; ++bx)
                    one_mcu(by / c.v, [&] {
                        block(&c.coef[((size_t)by * c.bw + bx) * 64], 0,
                              td[0], ta[0]);
                    });
        } else {
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx)
                    one_mcu(my, [&] {
                        for (int i = 0; i < ns; ++i) {
                            Component& c = comps[sc[i]];
                            for (int v = 0; v < c.v; ++v)
                                for (int h = 0; h < c.h; ++h) {
                                    size_t bi = (size_t)(my * c.v + v) * c.bw +
                                                mx * c.h + h;
                                    block(&c.coef[bi * 64], i, td[i],
                                          ta[i]);
                                }
                        }
                    });
        }
        pos = arith ? ar.pos : r.pos;
        if (arith ? ar.marker_hit : r.marker_hit)
            next_marker = arith ? ar.marker : r.marker;
        return JPEG_OK;
    }

    // jdlossls.c, jddiffct.c and jdlhuff.c over one lossless scan: each
    // MCU row's Huffman-coded differences (category 16: 32768), then each
    // component's row undifferenced with predictor psv (the first row of
    // the scan and of each restart interval from the left, its first
    // sample from 2^(P - Pt - 1)), modulo 2^16. A row begun after the data
    // ran out is all differences 0 from a first row: 2^(P - Pt - 1).
    int lossless_scan(int64_t start, int ns, const int* sc, const int* td,
                      int psv, int se, int ah, int pt) {
        // jdlossls.c start_pass_lossless
        if (psv < 1 || psv > 7 || se != 0 || ah != 0 ||
            pt >= lossless_precision)
            return JPEG_CORRUPT;
        if (lossless_refused()) return JPEG_CORRUPT;
        for (int i = 0; i < ns; ++i)
            if (comps[sc[i]].h != 1 || comps[sc[i]].v != 1)
                return JPEG_LOSSLESS_SUBSAMPLED;
        for (int i = 0; i < ns; ++i)
            if (td[i] > 3 || !dc[td[i]].defined ||
                !dc[td[i]].build(true, 16))
                return JPEG_CORRUPT;
        const int W = width, H = height;
        // jddiffct.c start_input_pass: restarts fall on MCU rows
        if (restart_interval % W) return JPEG_CORRUPT;
        ++scans;
        if (headers_only) return JPEG_OK;
        if (planes.size() != comps.size())
            planes.assign(comps.size(), std::vector<uint16_t>());
        for (int i = 0; i < ns; ++i)
            planes[sc[i]].assign((size_t)W * H, 0);
        Reader r{data, n, start};
        std::vector<int> diff((size_t)ns * W);
        const int initial = 1 << (lossless_precision - pt - 1);
        int rows_to_go = restart_interval / W, next_rst = 0;
        bool first = true;
        for (int y = 0; y < H; ++y) {
            if (restart_interval && rows_to_go == 0) {
                restart(r, next_rst);
                first = true;
                rows_to_go = restart_interval / W;
            }
            if (r.insufficient) {
                std::fill(diff.begin(), diff.end(), 0);
                first = true;
            } else {
                for (int x = 0; x < W; ++x)
                    for (int i = 0; i < ns; ++i) {
                        int v = r.decode(dc[td[i]]);
                        if (v == 16) v = 32768;
                        else if (v) v = extend(r.get_bits(v), v);
                        diff[(size_t)i * W + x] = v;
                    }
            }
            if (restart_interval) --rows_to_go;
            for (int i = 0; i < ns; ++i) {
                const int* d = &diff[(size_t)i * W];
                uint16_t* row = planes[sc[i]].data() + (size_t)y * W;
                int Ra;
                if (first) {
                    Ra = (d[0] + initial) & 0xFFFF;
                    row[0] = (uint16_t)Ra;
                    for (int x = 1; x < W; ++x) {
                        Ra = (d[x] + Ra) & 0xFFFF;
                        row[x] = (uint16_t)Ra;
                    }
                    continue;
                }
                const uint16_t* prev = row - W;
                int Rb = prev[0], Rc;
                Ra = (d[0] + Rb) & 0xFFFF;
                row[0] = (uint16_t)Ra;
                for (int x = 1; x < W; ++x) {
                    Rc = Rb;
                    Rb = prev[x];
                    int p;
                    switch (psv) {
                    case 1: p = Ra; break;
                    case 2: p = Rb; break;
                    case 3: p = Rc; break;
                    case 4: p = Ra + Rb - Rc; break;
                    case 5: p = Ra + ((Rb - Rc) >> 1); break;
                    case 6: p = Rb + ((Ra - Rc) >> 1); break;
                    default: p = (Ra + Rb) >> 1; break;
                    }
                    Ra = (d[x] + p) & 0xFFFF;
                    row[x] = (uint16_t)Ra;
                }
            }
            first = false;
        }
        point_transform = pt;
        pos = r.pos;
        if (r.marker_hit) next_marker = r.marker;
        return JPEG_OK;
    }

    int point_transform = 0;
    int tiff_color = -1;  // a TIFF strip's colour request; -1: a file

    // a lossless frame libjpeg-turbo 3 will not give the caller: it
    // converts no colours in lossless mode. OpenCV asks for BGR (or CMYK)
    // and reads 8 bits, so a file decodes only as RGB (no JFIF marker,
    // Adobe transform 0 or none) or CMYK (Adobe transform 0 or none) of 8
    // bits or fewer; libtiff wants its page's 8 bits, and RGB of a YCbCr
    // page
    bool lossless_refused() const {
        const int nc = (int)comps.size();
        if (tiff_color >= 0) return lossless_precision != 8 || tiff_color == 1;
        return lossless_precision > 8 || (nc != 3 && nc != 4) ||
               (nc == 3 && jfif) || (adobe && adobe_transform != 0);
    }

    // a lossless frame's component ci as 8-bit samples (simple_upscale:
    // shifted by the point transform, cut to the low byte)
    uint8_t lossless_sample(int ci, int64_t i) const {
        if (planes[ci].empty()) return 0;
        return (uint8_t)(planes[ci][i] << point_transform);
    }

    int parse(bool header_only) {
        headers_only = header_only;
        if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return JPEG_CORRUPT;
        pos = 2;
        bool seen_scan = false;
        for (;;) {
            int m = read_marker();
            if (m < 0 || m == 0xD9) {
                // the data ended (jdatasrc.c inserts an EOI) or EOI
                return seen_scan ? JPEG_OK : JPEG_CORRUPT;
            }
            if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
            // SOI again, and the markers jdmarker.c read_markers does not
            // know (JPG, DHP, EXP, JPGn, RESn), end the decode
            if (m == 0xD8 || m < 0xC0 || m == 0xC8 || m == 0xDE ||
                m == 0xDF || (m >= 0xF0 && m <= 0xFD))
                return JPEG_CORRUPT;
            if (pos + 2 > n) return seen_scan ? JPEG_OK : JPEG_CORRUPT;
            int len = u16(pos);
            if (len < 2) return JPEG_CORRUPT;
            if (pos + len > n) {
                return seen_scan ? JPEG_OK : JPEG_CORRUPT;
            }
            int64_t at = pos + 2;
            int plen = len - 2;
            pos += len;
            int rc = JPEG_OK;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                m != 0xCC) {
                rc = parse_sof(at, plen, m);
                if (rc == JPEG_OK && header_only && !lossless_precision)
                    return JPEG_OK;
            } else if (m == 0xC4) {
                rc = parse_dht(at, plen);
            } else if (m == 0xCC) {
                rc = parse_dac(at, plen);
            } else if (m == 0xDB) {
                rc = parse_dqt(at, plen);
            } else if (m == 0xDD) {
                if (plen != 2) return JPEG_CORRUPT;
                restart_interval = u16(at);
            } else if (m == 0xDA) {
                if (header_only && !lossless_precision)
                    return frame ? JPEG_OK : JPEG_CORRUPT;
                rc = scan(at, plen);
                seen_scan = true;
                // a single-scan sequential JPEG is out once its scan is:
                // OpenCV, and libtiff for a strip, keep it whatever
                // jpeg_finish_decompress meets after
                if (rc == JPEG_OK && !progressive &&
                    data[at] == (int)comps.size() && scans == 1)
                    return JPEG_OK;
            } else if (m == 0xE0) {
                if (plen >= 5 && std::memcmp(data + at, "JFIF\0", 5) == 0)
                    jfif = true;
            } else if (m == 0xEE) {
                if (plen >= 12 && std::memcmp(data + at, "Adobe", 5) == 0) {
                    adobe = true;
                    adobe_transform = data[at + 11];
                }
            }
            if (rc != JPEG_OK) return rc;
        }
    }

    // A TIFF JPEGTables stream (tag 347): SOI, the tables, EOI. A frame or
    // a scan in it is a bogus JPEGTables field (tif_jpeg.c).
    int parse_tables() {
        if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return JPEG_CORRUPT;
        pos = 2;
        for (;;) {
            int m = read_marker();
            if (m < 0 || m == 0xD9) return JPEG_OK;
            if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
            if (pos + 2 > n || u16(pos) < 2 || pos + u16(pos) > n)
                return JPEG_CORRUPT;
            const int len = u16(pos);
            const int64_t at = pos + 2;
            pos += len;
            int rc = JPEG_OK;
            if (m == 0xC4) rc = parse_dht(at, len - 2);
            else if (m == 0xDB) rc = parse_dqt(at, len - 2);
            else if (m == 0xCC) rc = parse_dac(at, len - 2);
            else if ((m >= 0xC0 && m <= 0xCF) || m == 0xDA) rc = JPEG_CORRUPT;
            if (rc != JPEG_OK) return rc;
        }
    }

    bool is_rgb() const {
        if (comps.size() != 3) return false;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    }
};

// jidctint.c jpeg_idct_islow, 8x8
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

struct RangeLimit {
    uint8_t clamp[256 + 512 + 256];  // jdmaster.c range_limit, colour stage
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            int v = i - 256;
            clamp[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
};
const RangeLimit kRange;

// jdcolor.c build_ycc_rgb_table
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int64_t one_half = (int64_t)1 << 15;
        auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
            cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
    }
};
const YccTables kYcc;

inline int sat16(int64_t v) {
    return (int)std::min<int64_t>(32767, std::max<int64_t>(-32768, v));
}

// the SIMD IDCT's output stage: saturate to int8, then centre. For
// |v| < 512 this is jdmaster.c's post-IDCT range-limit table.
inline uint8_t out8(int64_t v) {
    return (uint8_t)(std::min<int64_t>(127, std::max<int64_t>(-128, v)) +
                     128);
}

inline int64_t wrap16(int64_t v) { return (int16_t)(uint16_t)v; }

// One 1-D pass of jidctint-avx2.asm over 8 values x[0], x[s], ..., x[7s]:
// the sums in0 +- in4, in7 + in3 and in5 + in1 are 16-bit adds that wrap,
// the products 32-bit; the 8 results before their descale.
inline void idct_1d(const int64_t* x, int64_t* o) {
    int64_t z2 = x[2], z3 = x[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = wrap16(x[0] + x[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = wrap16(x[0] - x[4]) * ((int64_t)1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = x[7];
    tmp1 = x[5];
    tmp2 = x[3];
    tmp3 = x[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = wrap16(tmp0 + tmp2);
    int64_t z4 = wrap16(tmp1 + tmp3);
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = tmp10 + tmp3;
    o[7] = tmp10 - tmp3;
    o[1] = tmp11 + tmp2;
    o[6] = tmp11 - tmp2;
    o[2] = tmp12 + tmp1;
    o[5] = tmp12 - tmp1;
    o[3] = tmp13 + tmp0;
    o[4] = tmp13 - tmp0;
}

// jidctint.c's islow IDCT as libjpeg-turbo's AVX2 code computes it:
// 16-bit dequantisation products, the DC-only shortcut only when rows 1-7
// of the whole block are zero, the 16-bit sums of idct_1d, and each pass
// saturated to 16 bits (the second then to 8) after its descale.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
    int64_t ws[64];
    bool ac = false;
    for (int k = 8; k < 64; ++k) ac |= in[k] != 0;
    if (!ac) {
        for (int c = 0; c < 8; ++c) {
            const int64_t dcval = wrap16(wrap16(in[c] * q[c]) * 4);
            for (int k = 0; k < 8; ++k) ws[8 * k + c] = dcval;
        }
    } else {
        for (int c = 0; c < 8; ++c) {
            int64_t x[8], o[8];
            for (int k = 0; k < 8; ++k)
                x[k] = wrap16(in[c + 8 * k] * q[c + 8 * k]);
            idct_1d(x, o);
            for (int k = 0; k < 8; ++k)
                ws[8 * k + c] = sat16(descale(o[k], CONST_BITS - PASS1_BITS));
        }
    }
    for (int r = 0; r < 8; ++r) {
        int64_t o[8];
        idct_1d(ws + 8 * r, o);
        uint8_t* op = out + r * stride;
        for (int k = 0; k < 8; ++k)
            op[k] = out8(sat16(descale(o[k], CONST_BITS + PASS1_BITS + 3)));
    }
}

// One component upsampled to width x height (jdsample.c at
// do_fancy_upsampling = TRUE). plane holds the IDCT output with row
// stride ps; dw x dh of it are real samples.
void upsample(const Component& c, const uint8_t* plane, int64_t ps, int hr,
              int vr, int width, int height, uint8_t* out) {
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int y) { return plane + (int64_t)y * ps; };
    if (hr == 1 && vr == 1) {
        for (int y = 0; y < height; ++y)
            std::memcpy(out + (int64_t)y * width, row(y), width);
        return;
    }
    std::vector<uint8_t> line((size_t)dw * hr + 16);
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
        for (int y = 0; y < height; ++y) {
            const uint8_t* in = row(y);
            uint8_t* o = line.data();
            int v = in[0];
            *o++ = (uint8_t)v;
            *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
            for (int i = 1; i < dw - 1; ++i) {
                v = in[i] * 3;
                *o++ = (uint8_t)((v + in[i - 1] + 1) >> 2);
                *o++ = (uint8_t)((v + in[i + 1] + 2) >> 2);
            }
            v = in[dw - 1];
            *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
            *o++ = (uint8_t)v;
            std::memcpy(out + (int64_t)y * width, line.data(), width);
        }
        return;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < height; ++y) {
            int r = y >> 1;
            int far = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
            int bias = (y & 1) ? 2 : 1;
            const uint8_t* i0 = row(r);
            const uint8_t* i1 = row(far);
            uint8_t* o = out + (int64_t)y * width;
            for (int x = 0; x < width; ++x)
                o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
        }
        return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
        std::vector<int> cs(dw);
        for (int y = 0; y < height; ++y) {
            int r = y >> 1;
            int far = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
            const uint8_t* i0 = row(r);
            const uint8_t* i1 = row(far);
            for (int i = 0; i < dw; ++i) cs[i] = i0[i] * 3 + i1[i];
            uint8_t* o = line.data();
            *o++ = (uint8_t)((cs[0] * 4 + 8) >> 4);
            *o++ = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
            for (int i = 1; i < dw - 1; ++i) {
                *o++ = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
                *o++ = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
            }
            *o++ = (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
            *o++ = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
            std::memcpy(out + (int64_t)y * width, line.data(), width);
        }
        return;
    }
    // int_upsample / h2v1_upsample / h2v2_upsample: box replication
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = row(y / vr);
        uint8_t* o = out + (int64_t)y * width;
        for (int x = 0; x < width; ++x) o[x] = in[x / hr];
    }
}

// jdcoefct.c smoothing_ok: every component's quantisation table latched,
// its DC and first 9 AC quantisers nonzero and its DC at least partly
// sent; useful when one of coefficients 1-9 of some component is unsent
// or still owes bits
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

bool smoothing_ok(const Decoder& d) {
    if (!d.progressive) return false;
    bool useful = false;
    for (const Component& c : d.comps) {
        if (c.qlatched < 0) return false;
        for (int p : kSmoothPos)
            if (c.q[p] == 0) return false;
        if (c.coef_bits[0] < 0) return false;
        for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
}

inline int16_t predict(int64_t q, int64_t num, int al, bool limit) {
    int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+) over one
// component: each block's unsent low coefficients estimated from the DC
// values of its 5x5 neighbourhood, then the IDCT into plane
void smooth_component(const Decoder& d, const Component& c, uint8_t* plane,
                      int64_t ps) {
    const int T = d.total_imcu_rows, v = c.v;
    int cur[10], prev[10];
    for (int k = 0; k < 10; ++k) {
        cur[k] = c.coef_bits[k];
        prev[k] = d.scans > 1 ? c.prev_coef_bits[k] : -1;
    }
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    const int last_col = c.wblocks - 1;
    auto dc = [&](int row, int col) {
        row = std::max(0, std::min(row, c.bh - 1));
        return (int)c.coef[((size_t)row * c.bw + col) * 64];
    };
    for (int r = 0; r < T; ++r) {
        int block_rows = v;
        if (r == T - 1 && c.hblocks % v) block_rows = c.hblocks % v;
        const int image_block_rows = block_rows * T;
        const int* bits = r > d.last_good_imcu_row ? prev : cur;
        bool change_dc = true;
        for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
        for (int b = 0; b < block_rows; ++b) {
            const int ibr = r * block_rows + b, row = r * v + b;
            if (row >= c.hblocks) break;
            const int r0 = ibr > 0 ? row - 1 : row;
            const int rm = ibr > 1 ? row - 2 : r0;
            const int r2 = ibr < image_block_rows - 1 ? row + 1 : row;
            const int rp = ibr < image_block_rows - 2 ? row + 2 : r2;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
                DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
                DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = dc(rm, 0);
            DC06 = DC07 = DC08 = DC09 = DC10 = dc(r0, 0);
            DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
            DC16 = DC17 = DC18 = DC19 = DC20 = dc(r2, 0);
            DC21 = DC22 = DC23 = DC24 = DC25 = dc(rp, 0);
            for (int bx = 0; bx <= last_col; ++bx) {
                int16_t ws[64];
                std::memcpy(ws, &c.coef[((size_t)row * c.bw + bx) * 64],
                            sizeof(ws));
                // the window's columns clamped to the row's blocks
                if (bx == 0) {
                    const int c1 = std::min(1, last_col);
                    DC04 = dc(rm, c1);
                    DC09 = dc(r0, c1);
                    DC14 = dc(row, c1);
                    DC19 = dc(r2, c1);
                    DC24 = dc(rp, c1);
                }
                const int c2 = std::min(bx + 2, last_col);
                DC05 = dc(rm, c2);
                DC10 = dc(r0, c2);
                DC15 = dc(row, c2);
                DC20 = dc(r2, c2);
                DC25 = dc(rp, c2);
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
                    ws[1] = predict(Q01, Q00 * (change_dc ?
                        (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                         38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                        (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                        al, true);
                if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
                    ws[8] = predict(Q10, Q00 * (change_dc ?
                        (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                         DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                         DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                         DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                        (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                        al, true);
                if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
                    ws[16] = predict(Q20, Q00 * (change_dc ?
                        (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                         14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                         2 * DC19 + DC23) :
                        (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                        al, true);
                if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
                    ws[9] = predict(Q11, Q00 * (change_dc ?
                        (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                         9 * DC19 + DC21 - DC25) :
                        (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                         DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
                        al, true);
                if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
                    ws[2] = predict(Q02, Q00 * (change_dc ?
                        (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                         2 * DC19) :
                        (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                        al, true);
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
                        ws[3] = predict(Q03, Q00 * (DC07 - DC09 + 2 * DC12 -
                                                    2 * DC14 + DC17 - DC19),
                                        al, true);
                    if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
                        ws[10] = predict(Q12, Q00 * (DC07 - 3 * DC08 + DC09 -
                                                     DC17 + 3 * DC18 - DC19),
                                         al, true);
                    if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
                        ws[17] = predict(Q21, Q00 * (DC07 - DC09 - 3 * DC12 +
                                                     3 * DC14 + DC17 - DC19),
                                         al, true);
                    if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
                        ws[24] = predict(Q30, Q00 * (DC07 + 2 * DC08 + DC09 -
                                                     DC17 - 2 * DC18 - DC19),
                                         al, true);
                    ws[0] = predict(Q00, Q00 *
                        (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                         2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                         6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                         6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                         2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                         2 * DC25), 0, false);
                }
                idct_islow(ws, c.q, plane + (int64_t)row * 8 * ps + bx * 8,
                           ps);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

// Every component IDCT'd (smoothed where libjpeg smooths) and upsampled
// to the full width x height, one plane each
void render(Decoder& d, std::vector<std::vector<uint8_t>>& full) {
    const int W = d.width, H = d.height, nc = (int)d.comps.size();
    const bool smooth = smoothing_ok(d);
    full.assign(nc, {});
    for (int ci = 0; ci < nc; ++ci) {
        Component& c = d.comps[ci];
        if (c.qlatched < 0)  // never in a scan: jddctmgr.c's zero table
            std::memset(c.q, 0, sizeof(c.q));
        const int64_t ps = (int64_t)c.bw * 8;
        std::vector<uint8_t> plane((size_t)ps * c.bh * 8);
        const int bh = std::min(c.bh, (c.dh + 7) / 8 + 1);
        for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                           plane.data() + (int64_t)by * 8 * ps + bx * 8, ps);
        if (smooth) smooth_component(d, c, plane.data(), ps);
        full[ci].resize((size_t)W * H);
        if (nc == 1) {
            for (int y = 0; y < H; ++y)
                std::memcpy(full[ci].data() + (int64_t)y * W,
                            plane.data() + (int64_t)y * ps, W);
        } else {
            upsample(c, plane.data(), ps, d.hmax / c.h, d.vmax / c.v, W, H,
                     full[ci].data());
        }
    }
}

// jdcolor.c ycc_rgb_convert
void ycc_to_rgb(const std::vector<std::vector<uint8_t>>& p, int64_t np,
                uint8_t* out) {
    const YccTables& t = kYcc;
    const uint8_t* lim = kRange.clamp + 256;
    for (int64_t i = 0; i < np; ++i) {
        int y = p[0][i], cb = p[1][i], cr = p[2][i];
        out[3 * i] = lim[y + t.cr_r[cr]];
        out[3 * i + 1] = lim[y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
        out[3 * i + 2] = lim[y + t.cb_b[cb]];
    }
}

// four components -> RGB: jdcolor.c ycck_cmyk_convert for YCCK, then
// OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (c' = k - ((255 - c) * k >> 8))
void cmyk_to_rgb(const std::vector<std::vector<uint8_t>>& p, int64_t np,
                 bool ycck, uint8_t* out) {
    const YccTables& t = kYcc;
    const uint8_t* lim = kRange.clamp + 256;
    for (int64_t i = 0; i < np; ++i) {
        int c = p[0][i], m = p[1][i], y = p[2][i];
        const int k = p[3][i];
        if (ycck) {
            const int luma = c, cb = m, cr = y;
            c = lim[255 - (luma + t.cr_r[cr])];
            m = lim[255 - (luma + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16))];
            y = lim[255 - (luma + t.cb_b[cb])];
        }
        out[3 * i] = (uint8_t)(k - ((255 - c) * k >> 8));
        out[3 * i + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
        out[3 * i + 2] = (uint8_t)(k - ((255 - y) * k >> 8));
    }
}

// a lossless frame's components as 8-bit planes
void lossless_planes(const Decoder& d, std::vector<std::vector<uint8_t>>& full) {
    const int64_t np = (int64_t)d.width * d.height;
    full.assign(d.comps.size(), std::vector<uint8_t>(np));
    for (size_t ci = 0; ci < d.comps.size(); ++ci)
        for (int64_t i = 0; i < np; ++i) full[ci][i] = d.lossless_sample((int)ci, i);
}

// The data followed by what libjpeg's data sources (jdatasrc.c, and
// tif_jpeg.c's) hand it once the data has ended: fake EOI markers, one
// after another. A marker segment cut short is read on into them, as
// libjpeg reads it.
std::vector<uint8_t> with_fake_eoi(const uint8_t* data, int64_t n) {
    std::vector<uint8_t> buf((size_t)n + 65540);
    std::memcpy(buf.data(), data, (size_t)n);
    for (size_t i = (size_t)n; i + 1 < buf.size(); i += 2) {
        buf[i] = 0xFF;
        buf[i + 1] = 0xD9;
    }
    return buf;
}

}  // namespace

// (width, height, components, progressive) of the first frame into
// info[0..3]. Returns a JPEG_* code.
extern "C" int ocr_jpeg_header(const uint8_t* data, int64_t n,
                               int32_t* info) {
    const std::vector<uint8_t> buf = with_fake_eoi(data, n);
    Decoder d;
    d.data = buf.data();
    d.n = (int64_t)buf.size();
    int rc = d.parse(true);
    if (rc != JPEG_OK) return rc;
    if (!d.frame) return JPEG_CORRUPT;
    info[0] = d.width;
    info[1] = d.height;
    info[2] = (int32_t)d.comps.size();
    info[3] = d.progressive;
    return JPEG_OK;
}

// Decode into out: height x width x 3 RGB (x 1 for a gray JPEG).
extern "C" int ocr_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                               int64_t out_size) {
    const std::vector<uint8_t> buf = with_fake_eoi(data, n);
    Decoder d;
    d.data = buf.data();
    d.n = (int64_t)buf.size();
    int rc = d.parse(false);
    if (rc != JPEG_OK) return rc;
    const int nc = (int)d.comps.size();
    const int64_t np = (int64_t)d.width * d.height;
    if (out_size != np * (nc == 1 ? 1 : 3)) return JPEG_CORRUPT;
    std::vector<std::vector<uint8_t>> full;
    if (d.lossless_precision) {
        lossless_planes(d, full);
        if (nc == 4) cmyk_to_rgb(full, np, false, out);
        else
            for (int64_t i = 0; i < np; ++i)
                for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
        return JPEG_OK;
    }
    render(d, full);
    if (nc == 1) {
        std::memcpy(out, full[0].data(), np);
    } else if (nc == 4) {
        // jdapimin.c: Adobe transform 0 is CMYK, any other YCCK
        cmyk_to_rgb(full, np, d.adobe && d.adobe_transform != 0, out);
    } else if (d.is_rgb()) {
        for (int64_t i = 0; i < np; ++i)
            for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    } else {
        ycc_to_rgb(full, np, out);
    }
    return JPEG_OK;
}

// The Huffman and quantisation tables libtiff's one decompressor holds
// from strip to strip of a page: the JPEGTables stream's, then whatever
// each strip's own stream defines. NULL (and *rc set) for a bogus
// JPEGTables field.
struct TiffTables {
    uint16_t qt[4][64];
    bool qt_defined[4];
    Huffman dc[4], ac[4];
    void load(Decoder& d) const {
        std::memcpy(d.qt, qt, sizeof(qt));
        std::memcpy(d.qt_defined, qt_defined, sizeof(qt_defined));
        for (int i = 0; i < 4; ++i) {
            d.dc[i] = dc[i];
            d.ac[i] = ac[i];
        }
    }
    void keep(const Decoder& d) {
        std::memcpy(qt, d.qt, sizeof(qt));
        std::memcpy(qt_defined, d.qt_defined, sizeof(qt_defined));
        for (int i = 0; i < 4; ++i) {
            dc[i] = d.dc[i];
            ac[i] = d.ac[i];
        }
    }
};

extern "C" void* ocr_jpeg_tiff_open(const uint8_t* tables, int64_t nt,
                                    int* rc) {
    Decoder d;
    *rc = JPEG_OK;
    if (nt > 0) {
        const std::vector<uint8_t> buf = with_fake_eoi(tables, nt);
        d.data = buf.data();
        d.n = (int64_t)buf.size();
        *rc = d.parse_tables();
        if (*rc != JPEG_OK) return nullptr;
    }
    TiffTables* t = new TiffTables();
    t->keep(d);
    return t;
}

extern "C" void ocr_jpeg_tiff_close(void* tables) {
    delete static_cast<TiffTables*>(tables);
}

// One strip or tile of JPEG-in-TIFF (compression 7), as tif_jpeg.c has
// libjpeg decode it: with the tables the page's decompressor holds
// (ocr_jpeg_tiff_open; the strip's own definitions stay for the next
// strip), its height cut to max_height when that is > 0. color 1: YCbCr
// -> RGB (photometric YCbCr read through JPEGCOLORMODE RGB); color 0: the
// components as decoded, whatever the stream's markers say
// (JCS_UNKNOWN). With out == NULL only the header is read, into
// info[0..5]: width, height, components, the first component's
// horizontal and vertical sampling, and 1 when every other component
// samples 1x1. Otherwise out gets height x width x components (x 3 under
// color 1). Returns a JPEG_* code.
extern "C" int ocr_jpeg_tiff(void* tables, const uint8_t* data, int64_t n,
                             int color, int max_height, int32_t* info,
                             uint8_t* out, int64_t out_size) {
    TiffTables* t = static_cast<TiffTables*>(tables);
    Decoder d;
    d.max_height = max_height;
    d.tiff_color = color;
    t->load(d);
    const std::vector<uint8_t> buf = with_fake_eoi(data, n);
    d.data = buf.data();
    d.n = (int64_t)buf.size();
    int rc = d.parse(out == nullptr);
    t->keep(d);
    if (rc != JPEG_OK) return rc;
    if (!d.frame) return JPEG_CORRUPT;
    const int nc = (int)d.comps.size();
    if (out == nullptr) {
        info[0] = d.width;
        info[1] = d.height;
        info[2] = nc;
        info[3] = d.comps[0].h;
        info[4] = d.comps[0].v;
        info[5] = 1;
        for (int ci = 1; ci < nc; ++ci)
            if (d.comps[ci].h != 1 || d.comps[ci].v != 1) info[5] = 0;
        return JPEG_OK;
    }
    if (color == 1 && nc != 3) return JPEG_CORRUPT;
    const int64_t np = (int64_t)d.width * d.height;
    if (out_size != np * (color == 1 ? 3 : nc)) return JPEG_CORRUPT;
    std::vector<std::vector<uint8_t>> full;
    if (d.lossless_precision) {
        lossless_planes(d, full);
        for (int64_t i = 0; i < np; ++i)
            for (int k = 0; k < nc; ++k) out[nc * i + k] = full[k][i];
        return JPEG_OK;
    }
    render(d, full);
    if (color == 1) {
        ycc_to_rgb(full, np, out);
    } else {
        for (int64_t i = 0; i < np; ++i)
            for (int k = 0; k < nc; ++k) out[nc * i + k] = full[k][i];
    }
    return JPEG_OK;
}
