// JPEG decoding for the port's image reader (io/images.py), byte-equal
// with what libjpeg-turbo 3.1 gives cv2.imread at its defaults:
//
// - baseline, extended (8-bit) and progressive Huffman coding, restart
//   intervals, 1 or 3 components, any integral sampling factors;
// - the accurate integer IDCT (jidctint.c, "islow") with its range limit;
// - fancy upsampling (jdsample.c): triangle filters for h2v1, h1v2 and
//   h2v2, box replication for the other ratios and for h2v1/h2v2 chroma
//   at most 2 samples wide;
// - YCbCr -> RGB with jdcolor.c's fixed-point tables; RGB JPEGs (Adobe
//   transform 0, or component ids 'R' 'G' 'B') are copied; gray is
//   expanded to three channels by the caller;
// - corrupt entropy data as libjpeg treats it: a bad Huffman code gives
//   symbol 0; past the end of a segment the bits are zeros, and the MCUs
//   after the first one that needed them stay zero (mid-gray).
//
// EXIF orientation is applied by the caller. The return codes name what
// is not decoded here: see JPEG_* below.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
    JPEG_OK = 0,
    JPEG_CORRUPT = 1,         // cv2.imread gives None
    JPEG_ARITHMETIC = 2,
    JPEG_LOSSLESS = 3,
    JPEG_PRECISION = 4,       // 12- or 16-bit samples
    JPEG_FOUR_COMPONENTS = 5, // CMYK / YCCK
    JPEG_SMOOTHING = 6,       // progressive with coefficients left unsent
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
    bool build(bool dc) {
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
                if (symbols[i] > 15) return false;
        return true;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;        // allocated blocks per row / column
    int wblocks = 0, hblocks = 0;  // blocks of the component's own size
    int dw = 0, dh = 0;        // downsampled width / height
    int qlatched = -1;         // quantisation table latched at first scan
    uint16_t q[64];            // latched table, natural order
    std::vector<int16_t> coef; // bw * bh blocks of 64, natural order
    int coef_bits[64];         // progressive: -1 unsent, else Al still owed
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
        if (nbits < 16) fill();
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

inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r;
}

struct Decoder {
    const uint8_t* data;
    int64_t n;
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
        if (frame) return JPEG_OK;  // the first frame only
        if (len < 6) return JPEG_CORRUPT;
        int precision = data[at];
        height = u16(at + 1);
        width = u16(at + 3);
        int nc = data[at + 5];
        if (len < 6 + 3 * nc || nc == 0) return JPEG_CORRUPT;
        if (marker == 0xC3 || marker == 0xCB) return JPEG_LOSSLESS;
        if (marker >= 0xC9) return JPEG_ARITHMETIC;
        if (marker >= 0xC5) return JPEG_CORRUPT;  // hierarchical
        if (precision != 8) return JPEG_PRECISION;
        if (nc == 4) return JPEG_FOUR_COMPONENTS;
        if (nc != 1 && nc != 3) return JPEG_CORRUPT;
        if (width == 0 || height == 0) return JPEG_CORRUPT;
        progressive = marker == 0xC2;
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
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v) return JPEG_CORRUPT;
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.wblocks = (c.dw + 7) / 8;
            c.hblocks = (c.dh + 7) / 8;
            c.bw = nc == 1 ? c.wblocks : mcux * c.h;
            c.bh = nc == 1 ? c.hblocks : mcuy * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
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
    void restart(Reader& r, int& next_rst) {
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
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return JPEG_CORRUPT;
        int sc[4], td[4], ta[4];
        for (int i = 0; i < ns; ++i) {
            int cid = data[at + 1 + 2 * i];
            int found = -1;
            for (size_t k = 0; k < comps.size(); ++k)
                if (comps[k].id == cid) found = (int)k;
            if (found < 0) return JPEG_CORRUPT;
            sc[i] = found;
            td[i] = data[at + 2 + 2 * i] >> 4;
            ta[i] = data[at + 2 + 2 * i] & 15;
            if (td[i] > 3 || ta[i] > 3) return JPEG_CORRUPT;
        }
        int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns];
        int ah = data[at + 3 + 2 * ns] >> 4, al = data[at + 3 + 2 * ns] & 15;
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
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            Component& c = comps[sc[i]];
            blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
            if (c.qlatched < 0) {
                if (!qt_defined[c.tq]) return JPEG_CORRUPT;
                std::memcpy(c.q, qt[c.tq], sizeof(c.q));
                c.qlatched = c.tq;
            }
            // the tables a scan uses (jdhuff.c / jdphuff.c start_pass)
            if (ss == 0 && ah == 0 &&
                (!dc[td[i]].defined || !dc[td[i]].build(true)))
                return JPEG_CORRUPT;
            if (se > 0 && (!ac[ta[i]].defined || !ac[ta[i]].build(false)))
                return JPEG_CORRUPT;
            for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
        }
        if (blocks_in_mcu > 10) return JPEG_CORRUPT;  // D_MAX_BLOCKS_IN_MCU

        Reader r{data, n, at + len};
        int last_dc[4] = {0, 0, 0, 0};
        int eobrun = 0;
        int next_rst = 0;
        int restarts_to_go = restart_interval;
        const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);

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

        auto one_mcu = [&](auto&& body) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    restart(r, next_rst);
                    for (int& d : last_dc) d = 0;
                    eobrun = 0;
                    restarts_to_go = restart_interval;
                }
                --restarts_to_go;
            }
            // a DC refinement reads on regardless: zeros change nothing
            if (!r.insufficient || (progressive && ss == 0 && ah != 0))
                body();
        };

        if (ns == 1) {
            Component& c = comps[sc[0]];
            for (int by = 0; by < c.hblocks; ++by)
                for (int bx = 0; bx < c.wblocks; ++bx)
                    one_mcu([&] {
                        decode_block(&c.coef[((size_t)by * c.bw + bx) * 64],
                                     0, td[0], ta[0]);
                    });
        } else {
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx)
                    one_mcu([&] {
                        for (int i = 0; i < ns; ++i) {
                            Component& c = comps[sc[i]];
                            for (int v = 0; v < c.v; ++v)
                                for (int h = 0; h < c.h; ++h) {
                                    size_t bi = (size_t)(my * c.v + v) * c.bw +
                                                mx * c.h + h;
                                    decode_block(&c.coef[bi * 64], i, td[i],
                                                 ta[i]);
                                }
                        }
                    });
        }
        pos = r.pos;
        if (r.marker_hit) next_marker = r.marker;
        return JPEG_OK;
    }

    int parse(bool header_only) {
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
            if (m == 0xD8) return JPEG_CORRUPT;
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
                if (rc == JPEG_OK && header_only) return JPEG_OK;
            } else if (m == 0xC4) {
                rc = parse_dht(at, plen);
            } else if (m == 0xCC) {
                if (!frame) return JPEG_ARITHMETIC;
            } else if (m == 0xDB) {
                rc = parse_dqt(at, plen);
            } else if (m == 0xDD) {
                if (plen < 2) return JPEG_CORRUPT;
                restart_interval = u16(at);
            } else if (m == 0xDA) {
                if (header_only) return frame ? JPEG_OK : JPEG_CORRUPT;
                rc = scan(at, plen);
                seen_scan = true;
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

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        int16_t ip[57];
        for (int k = 0; k < 8; ++k)  // 16-bit products, as the SIMD IDCT
            ip[8 * k] = (int16_t)(in[c + 8 * k] * q[c + 8 * k]);
        int* wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dcval = (int16_t)(uint16_t)((unsigned)ip[0] << PASS1_BITS);
            for (int k = 0; k < 8; ++k) wp[8 * k] = dcval;
            continue;
        }
        int64_t z2 = ip[16], z3 = ip[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0];
        z3 = ip[32];
        int64_t tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56];
        tmp1 = ip[40];
        tmp2 = ip[24];
        tmp3 = ip[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
        const int sh = CONST_BITS - PASS1_BITS;
        wp[0] = sat16(descale(tmp10 + tmp3, sh));
        wp[56] = sat16(descale(tmp10 - tmp3, sh));
        wp[8] = sat16(descale(tmp11 + tmp2, sh));
        wp[48] = sat16(descale(tmp11 - tmp2, sh));
        wp[16] = sat16(descale(tmp12 + tmp1, sh));
        wp[40] = sat16(descale(tmp12 - tmp1, sh));
        wp[24] = sat16(descale(tmp13 + tmp0, sh));
        wp[32] = sat16(descale(tmp13 - tmp0, sh));
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + r * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
            wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t dcval = out8(descale(wp[0], PASS1_BITS + 3));
            std::memset(op, dcval, 8);
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = out8(descale(tmp10 + tmp3, sh));
        op[7] = out8(descale(tmp10 - tmp3, sh));
        op[1] = out8(descale(tmp11 + tmp2, sh));
        op[6] = out8(descale(tmp11 - tmp2, sh));
        op[2] = out8(descale(tmp12 + tmp1, sh));
        op[5] = out8(descale(tmp12 - tmp1, sh));
        op[3] = out8(descale(tmp13 + tmp0, sh));
        op[4] = out8(descale(tmp13 - tmp0, sh));
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

}  // namespace

// (width, height, components, progressive) of the first frame into
// info[0..3]. Returns a JPEG_* code.
extern "C" int ocr_jpeg_header(const uint8_t* data, int64_t n,
                               int32_t* info) {
    Decoder d;
    d.data = data;
    d.n = n;
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
    Decoder d;
    d.data = data;
    d.n = n;
    int rc = d.parse(false);
    if (rc != JPEG_OK) return rc;
    const int W = d.width, H = d.height, nc = (int)d.comps.size();
    if (out_size != (int64_t)W * H * (nc == 1 ? 1 : 3)) return JPEG_CORRUPT;
    if (d.progressive) {
        // jdcoefct.c smoothing_ok: libjpeg smooths the blocks when every
        // component's DC is known and the DC or one of the first 9 AC
        // coefficients of some component was not fully sent
        bool ok = true, useful = false;
        for (const Component& c : d.comps) {
            if (c.qlatched < 0 || c.coef_bits[0] < 0) ok = false;
            for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
        }
        if (ok && useful) return JPEG_SMOOTHING;
    }
    std::vector<std::vector<uint8_t>> full(nc);
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
        const int hr = d.hmax / c.h, vr = d.vmax / c.v;
        if (nc == 1) {
            for (int y = 0; y < H; ++y)
                std::memcpy(out + (int64_t)y * W,
                            plane.data() + (int64_t)y * ps, W);
            return JPEG_OK;
        }
        full[ci].resize((size_t)W * H);
        upsample(c, plane.data(), ps, hr, vr, W, H, full[ci].data());
    }
    const uint8_t* p0 = full[0].data();
    const uint8_t* p1 = full[1].data();
    const uint8_t* p2 = full[2].data();
    const int64_t np = (int64_t)W * H;
    if (d.is_rgb()) {
        for (int64_t i = 0; i < np; ++i) {
            out[3 * i] = p0[i];
            out[3 * i + 1] = p1[i];
            out[3 * i + 2] = p2[i];
        }
        return JPEG_OK;
    }
    // jdcolor.c ycc_rgb_convert
    const YccTables& t = kYcc;
    const uint8_t* lim = kRange.clamp + 256;
    for (int64_t i = 0; i < np; ++i) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        out[3 * i] = lim[y + t.cr_r[cr]];
        out[3 * i + 1] = lim[y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
        out[3 * i + 2] = lim[y + t.cb_b[cb]];
    }
    return JPEG_OK;
}
