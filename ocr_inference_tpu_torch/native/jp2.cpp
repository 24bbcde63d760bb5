// JPEG 2000 Part 1 codestream decoder for the port's image reader
// (io/images.py), decoding what OpenJPEG 2.5 decodes for cv2.imread in its
// strict mode (a codestream that ends early, or whose packets run past
// their tile-part, fails: cv2 gives None):
//
// - main and tile-part headers: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM, PPT,
//   TLM/PLM/PLT/CRG/COM, CAP and CPF (read past, after OpenJPEG's checks),
//   several tile-parts per tile;
//   the Part 2 markers OpenJPEG reads: MCT, MCC and MCO (an MCO replaces
//   the DC level shifts by its MCC's offset array, zero without one) and
//   CBD (the components' precision and signedness); the others (ADS, ATK,
//   DCO, NLT) it reads past in the main header, as unknown markers;
// - tier 2: tag trees, packet headers (inclusion, zero bit-planes, passes,
//   Lblock), SOP and EPH markers, the five progression orders with POC
//   changes, precincts, packed packet headers (PPM, PPT);
// - tier 1: the MQ decoder and the three coding passes with every Part 1
//   code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), ROI
//   maxshift;
// - dequantisation, the 5/3 (integer) and 9/7 (float32, OpenJPEG's lifting
//   order and constants; built without fused multiply-adds) inverse
//   wavelets, RCT and ICT, the DC level shift with OpenJPEG's rounding and
//   clipping.
//
// It returns each component's samples as int32; the JP2 boxes, palettes,
// channel definitions and cv2's mapping to 8-bit BGR are io/images.py.
// - HT code-blocks (Part 15, code-block style bit 6 in a COD or COC, per
//   tile-component): the cleanup pass (MEL, VLC and UVLC, MagSgn) and the
//   SigProp and MagRef passes of one HT set, with OpenJPEG 2.5's limits
//   (at most three passes, no ROI shift, the Lcup/Scup and U_q checks) and
//   its reading of packet headers that add passes to an included block;
//   mixed code-blocks (style bit 7) fail, as OpenJPEG fails them.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kFail = 1 };

struct Fail {
    int status;
};

[[noreturn]] void fail(int status = kFail) { throw Fail{status}; }

inline uint32_t ceildiv(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline uint32_t ceildivpow2(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a + ((uint64_t)1 << b) - 1) >> b);
}
inline uint32_t floordivpow2(uint32_t a, uint32_t b) { return a >> b; }

// ---------------------------------------------------------------------------
// coding parameters
// ---------------------------------------------------------------------------

struct StepSize {
    int expn = 0, mant = 0;
};

struct Tccp {
    int csty = 0;  // precincts defined (bit 0)
    int numres = 0;
    int cblkw = 0, cblkh = 0;
    int cblksty = 0;
    int qmfbid = 0;
    int qntsty = 0;
    int numgbits = 0;
    StepSize steps[97];
    int roishift = 0;
    int prcw[33] = {0}, prch[33] = {0};
    int32_t dc_shift = 0;  // set from SIZ; an MCO marker replaces it
};

struct Poc {
    uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

// Part 2 records (OpenJPEG's opj_mct_data_t and
// opj_simple_mcc_decorrelation_data_t)
struct MctRecord {
    uint32_t index = 0, etype = 0;
    std::vector<uint8_t> data;
};

struct MccRecord {
    uint32_t index = 0, ncomps = 0;
    int deco = -1, offset = -1;  // MctRecord positions
};

struct Tcp {
    int csty = 0;  // SOP (bit 1), EPH (bit 2)
    int prg = 0;
    int numlayers = 0;
    int mct = 0;
    std::vector<Tccp> tccps;
    std::vector<Poc> pocs;
    std::vector<MctRecord> mcts;
    std::vector<MccRecord> mccs;
    std::vector<uint8_t> data;  // the tile-parts' data, one after another
    std::vector<uint8_t> ppt;
    std::vector<std::pair<int, std::vector<uint8_t>>> ppt_parts;
    bool ppt_present = false;
    bool seen = false;
    int order = -1;  // when its last tile-part arrived
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 8;
    bool sgnd = false;
};

struct Codestream {
    const uint8_t* p = nullptr;
    size_t len = 0;
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    std::vector<Comp> comps;
    Tcp deftcp;
    std::vector<Tcp> tcps;
    bool ppm = false;
    std::vector<std::pair<int, std::vector<uint8_t>>> ppm_parts;
    std::vector<uint8_t> ppm_data;
    size_t ppm_pos = 0;
    bool have_siz = false, have_cod = false, have_qcd = false;
};

struct Seg {
    uint32_t len = 0, numpasses = 0, maxpasses = 0, numnewpasses = 0,
             newlen = 0;
};

struct Cblk {
    uint32_t x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
    uint32_t numsegs = 0;
    std::vector<Seg> segs;
    std::vector<uint8_t> data;  // the chunks, one after another
};

struct TagTree {
    std::vector<int> value, low, parent;
    void build(int w, int h) {
        std::vector<int> ws, hs;
        int n;
        do {
            ws.push_back(w);
            hs.push_back(h);
            n = w * h;
            w = (w + 1) / 2;
            h = (h + 1) / 2;
        } while (n > 1);
        int total = 0;
        std::vector<int> offs;
        for (size_t i = 0; i < ws.size(); ++i) {
            offs.push_back(total);
            total += ws[i] * hs[i];
        }
        parent.assign(total, -1);
        for (size_t i = 0; i + 1 < ws.size(); ++i)
            for (int y = 0; y < hs[i]; ++y)
                for (int x = 0; x < ws[i]; ++x)
                    parent[offs[i] + y * ws[i] + x] =
                        offs[i + 1] + (y / 2) * ws[i + 1] + x / 2;
        value.assign(total, 999);
        low.assign(total, 0);
    }
    void reset() {
        std::fill(value.begin(), value.end(), 999);
        std::fill(low.begin(), low.end(), 0);
    }
};

struct Prec {
    uint32_t x0, y0, x1, y1;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    uint32_t x0, y0, x1, y1;
    int orient = 0;
    float stepsize = 0;
    int numbps = 0;
    std::vector<Prec> precs;
    bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
    uint32_t x0, y0, x1, y1;
    uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0;
    int numbands = 0;
    Band bands[3];
};

struct TileComp {
    uint32_t x0, y0, x1, y1;
    int numres = 0;
    std::vector<Res> res;
    std::vector<int32_t> idata;
    std::vector<float> fdata;
    uint32_t width() const { return x1 - x0; }
    uint32_t height() const { return y1 - y0; }
};

// ---------------------------------------------------------------------------
// marker segments
// ---------------------------------------------------------------------------

struct Seq {
    const uint8_t* p;
    size_t n, pos = 0;
    uint32_t get(int bytes) {
        if (pos + bytes > n) fail();
        uint32_t v = 0;
        for (int i = 0; i < bytes; ++i) v = (v << 8) | p[pos++];
        return v;
    }
    size_t left() const { return n - pos; }
};

void read_siz(Codestream& cs, Seq s) {
    if (cs.have_siz) fail();
    s.get(2);  // Rsiz: the profile, which OpenJPEG's decode does not read
    cs.x1 = s.get(4);
    cs.y1 = s.get(4);
    cs.x0 = s.get(4);
    cs.y0 = s.get(4);
    cs.tdx = s.get(4);
    cs.tdy = s.get(4);
    cs.tx0 = s.get(4);
    cs.ty0 = s.get(4);
    uint32_t nc = s.get(2);
    if (s.n != 36 + 3 * (size_t)nc) fail();
    if (nc == 0 || nc > 16384) fail();
    if (cs.x0 >= cs.x1 || cs.y0 >= cs.y1) fail();
    if (cs.tdx == 0 || cs.tdy == 0) fail();
    if (cs.tx0 > cs.x0 || cs.ty0 > cs.y0) fail();
    if ((uint64_t)cs.tx0 + cs.tdx <= cs.x0 ||
        (uint64_t)cs.ty0 + cs.tdy <= cs.y0)
        fail();
    cs.comps.resize(nc);
    for (auto& c : cs.comps) {
        uint32_t ssiz = s.get(1);
        c.prec = (ssiz & 0x7f) + 1;
        c.sgnd = (ssiz >> 7) & 1;
        c.dx = s.get(1);
        c.dy = s.get(1);
        if (c.dx == 0 || c.dy == 0) fail();
        if (c.prec > 31) fail();
    }
    cs.tw = ceildiv(cs.x1 - cs.tx0, cs.tdx);
    cs.th = ceildiv(cs.y1 - cs.ty0, cs.tdy);
    // more tiles than the index of an SOT marker can name
    if ((uint64_t)cs.tw * cs.th > 65535) fail();
    cs.deftcp.tccps.assign(nc, Tccp());
    for (size_t c = 0; c < nc; ++c)
        if (!cs.comps[c].sgnd)
            cs.deftcp.tccps[c].dc_shift = (int32_t)1 << (cs.comps[c].prec - 1);
    cs.have_siz = true;
}

void read_spcod(Seq& s, Tccp& t) {
    t.numres = (int)s.get(1) + 1;
    if (t.numres > 33) fail();
    t.cblkw = (int)s.get(1) + 2;
    t.cblkh = (int)s.get(1) + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) fail();
    t.cblksty = (int)s.get(1);
    if (t.cblksty & 0x80) fail();
    t.qmfbid = (int)s.get(1);
    if (t.qmfbid > 1) fail();
    if (t.csty & 1) {
        for (int i = 0; i < t.numres; ++i) {
            uint32_t v = s.get(1);
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail();
            t.prcw[i] = (int)(v & 0xf);
            t.prch[i] = (int)(v >> 4);
        }
    } else {
        for (int i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
}

void read_cod(Tcp& tcp, Seq s) {
    uint32_t scod = s.get(1);
    if (scod & ~7u) fail();
    tcp.csty = (int)scod;
    tcp.prg = (int)s.get(1);
    if (tcp.prg > 4) fail();  // OpenJPEG cannot iterate its packets
    tcp.numlayers = (int)s.get(2);
    if (tcp.numlayers < 1) fail();
    tcp.mct = (int)s.get(1);
    if (tcp.mct > 1) fail();
    Tccp first;
    first.csty = (int)(scod & 1);
    read_spcod(s, first);
    if (s.left()) fail();
    for (auto& t : tcp.tccps) {
        t.csty = first.csty;
        t.numres = first.numres;
        t.cblkw = first.cblkw;
        t.cblkh = first.cblkh;
        t.cblksty = first.cblksty;
        t.qmfbid = first.qmfbid;
        std::copy(first.prcw, first.prcw + 33, t.prcw);
        std::copy(first.prch, first.prch + 33, t.prch);
    }
}

uint32_t comp_index(const Codestream& cs, Seq& s) {
    uint32_t c = s.get(cs.comps.size() <= 256 ? 1 : 2);
    if (c >= cs.comps.size()) fail();
    return c;
}

void read_coc(Codestream& cs, Tcp& tcp, Seq s) {
    Tccp& t = tcp.tccps[comp_index(cs, s)];
    t.csty = (int)s.get(1);
    read_spcod(s, t);
    if (s.left()) fail();
}

void read_sqcd(Seq& s, Tccp& t) {
    uint32_t v = s.get(1);
    t.qntsty = (int)(v & 0x1f);
    t.numgbits = (int)(v >> 5);
    size_t nb = t.qntsty == 1 ? 1 : t.qntsty == 0 ? s.left() : s.left() / 2;
    for (size_t b = 0; b < nb; ++b) {
        if (t.qntsty == 0) {
            uint32_t e = s.get(1);
            if (b < 97) {
                t.steps[b].expn = (int)(e >> 3);
                t.steps[b].mant = 0;
            }
        } else {
            uint32_t e = s.get(2);
            if (b < 97) {
                t.steps[b].expn = (int)(e >> 11);
                t.steps[b].mant = (int)(e & 0x7ff);
            }
        }
    }
    if (t.qntsty == 1) {
        for (int b = 1; b < 97; ++b) {
            t.steps[b].expn = std::max(t.steps[0].expn - (b - 1) / 3, 0);
            t.steps[b].mant = t.steps[0].mant;
        }
    }
}

void read_qcd(Codestream&, Tcp& tcp, Seq s) {
    Tccp first;
    read_sqcd(s, first);
    if (s.left()) fail();
    for (auto& t : tcp.tccps) {
        t.qntsty = first.qntsty;
        t.numgbits = first.numgbits;
        std::copy(first.steps, first.steps + 97, t.steps);
    }
}

void read_qcc(Codestream& cs, Tcp& tcp, Seq s) {
    Tccp& t = tcp.tccps[comp_index(cs, s)];
    read_sqcd(s, t);
    if (s.left()) fail();
}

void read_rgn(Codestream& cs, Tcp& tcp, Seq s) {
    Tccp& t = tcp.tccps[comp_index(cs, s)];
    s.get(1);  // Srgn
    t.roishift = (int)s.get(1);
    if (s.left()) fail();
}

void read_poc(Codestream& cs, Tcp& tcp, Seq s) {
    int room = cs.comps.size() <= 256 ? 1 : 2;
    size_t each = 5 + 2 * room;
    if (s.n % each || s.n == 0) fail();
    size_t n = s.n / each;
    if (tcp.pocs.size() + n > 32) fail();
    for (size_t i = 0; i < n; ++i) {
        Poc p;
        p.resno0 = s.get(1);
        p.compno0 = s.get(room);
        p.layno1 = s.get(2);
        p.resno1 = s.get(1);
        p.compno1 = s.get(room);
        p.prg = s.get(1);
        p.compno1 = std::min<uint32_t>(p.compno1, (uint32_t)cs.comps.size());
        tcp.pocs.push_back(p);
    }
}

// the concatenated Ippm fields (each tile-part's packet headers), the Nppm
// lengths taken out, in Zppm order
void merge_ppm(Codestream& cs) {
    std::stable_sort(cs.ppm_parts.begin(), cs.ppm_parts.end(),
                     [](auto& a, auto& b) { return a.first < b.first; });
    std::vector<uint8_t> all;
    for (auto& part : cs.ppm_parts)
        all.insert(all.end(), part.second.begin(), part.second.end());
    size_t pos = 0;
    while (pos < all.size()) {
        if (pos + 4 > all.size()) fail();
        uint32_t n = ((uint32_t)all[pos] << 24) | (all[pos + 1] << 16) |
                     (all[pos + 2] << 8) | all[pos + 3];
        pos += 4;
        if (pos + n > all.size()) fail();
        cs.ppm_data.insert(cs.ppm_data.end(), all.begin() + pos,
                           all.begin() + pos + n);
        pos += n;
    }
}

// Part 2: OpenJPEG's opj_j2k_read_mct, _read_mcc, _read_mco (with
// opj_j2k_add_mct) and _read_cbd. Where OpenJPEG warns that it cannot take
// a record in charge, the marker is read past; where it errs, fail.

void read_mct(Tcp& tcp, Seq s) {
    if (s.n < 2) fail();
    if (s.get(2) != 0) return;  // Zmct: one of several MCT records
    if (s.n <= 6) fail();
    uint32_t imct = s.get(2);
    uint32_t index = imct & 0xff;
    auto it = std::find_if(tcp.mcts.begin(), tcp.mcts.end(),
                           [&](auto& r) { return r.index == index; });
    MctRecord& rec = it != tcp.mcts.end() ? *it : tcp.mcts.emplace_back();
    rec.index = index;
    rec.etype = (imct >> 10) & 3;
    rec.data.clear();
    if (s.get(2) != 0) return;  // Ymct: one of several MCT markers
    rec.data.assign(s.p + s.pos, s.p + s.n);
}

int find_mct(const Tcp& tcp, uint32_t index) {
    for (size_t i = 0; i < tcp.mcts.size(); ++i)
        if (tcp.mcts[i].index == index) return (int)i;
    fail();
}

void read_mcc(Tcp& tcp, Seq s) {
    if (s.n < 2) fail();
    if (s.get(2) != 0) return;  // Zmcc
    if (s.n < 7) fail();
    uint32_t index = s.get(1);
    auto it = std::find_if(tcp.mccs.begin(), tcp.mccs.end(),
                           [&](auto& r) { return r.index == index; });
    MccRecord added;
    MccRecord& rec = it != tcp.mccs.end() ? *it : added;
    rec.index = index;
    if (s.get(2) != 0) return;  // Ymcc
    uint32_t collections = s.get(2);
    if (collections > 1) return;
    size_t size = s.n - 7;
    for (uint32_t i = 0; i < collections; ++i) {
        if (size < 3) fail();
        if (s.get(1) != 1) return;  // not an array-based decorrelation
        uint32_t n = s.get(2);
        size -= 3;
        int bytes = 1 + (int)(n >> 15);
        rec.ncomps = n & 0x7fff;
        if (size < (size_t)bytes * rec.ncomps + 2) fail();
        size -= (size_t)bytes * rec.ncomps + 2;
        for (uint32_t j = 0; j < rec.ncomps; ++j)
            if (s.get(bytes) != j) return;  // shuffled components
        n = s.get(2);
        bytes = 1 + (int)(n >> 15);
        if ((n & 0x7fff) != rec.ncomps) return;
        if (size < (size_t)bytes * rec.ncomps + 3) fail();
        size -= (size_t)bytes * rec.ncomps + 3;
        for (uint32_t j = 0; j < rec.ncomps; ++j)
            if (s.get(bytes) != j) return;
        uint32_t t = s.get(3);
        rec.deco = (t & 0xff) ? find_mct(tcp, t & 0xff) : -1;
        rec.offset = ((t >> 8) & 0xff) ? find_mct(tcp, (t >> 8) & 0xff) : -1;
    }
    if (size != 0) fail();
    if (it == tcp.mccs.end()) tcp.mccs.push_back(added);
}

// an MCT element as an int32: opj_j2k_read_int16_to_int32 (unsigned),
// _int32_to_int32, _float32_to_int32 and _float64_to_int32 (a C cast,
// which gives INT32_MIN out of range on x86)
int32_t mct_element(const uint8_t* p, uint32_t etype) {
    int n = etype == 0 ? 2 : etype == 3 ? 8 : 4;
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    if (etype < 2) return (int32_t)(uint32_t)v;
    double f;
    if (etype == 2) {
        uint32_t u = (uint32_t)v;
        float g;
        std::memcpy(&g, &u, 4);
        f = g;
    } else {
        std::memcpy(&f, &v, 8);
    }
    if (!(f > -2147483649.0 && f < 2147483648.0)) return INT32_MIN;
    return (int32_t)f;
}

void add_mct(const Codestream& cs, Tcp& tcp, uint32_t index) {
    auto it = std::find_if(tcp.mccs.begin(), tcp.mccs.end(),
                           [&](auto& r) { return r.index == index; });
    size_t nc = cs.comps.size();
    if (it == tcp.mccs.end() || it->ncomps != nc) return;  // discarded
    static const size_t kSize[4] = {2, 4, 4, 8};
    if (it->deco >= 0) {
        const MctRecord& d = tcp.mcts[it->deco];
        if (d.data.size() != kSize[d.etype] * nc * nc) fail();
    }
    if (it->offset >= 0) {
        const MctRecord& o = tcp.mcts[it->offset];
        if (o.data.size() != kSize[o.etype] * nc) fail();
        for (size_t c = 0; c < nc; ++c)
            tcp.tccps[c].dc_shift =
                mct_element(o.data.data() + kSize[o.etype] * c, o.etype);
    }
}

void read_mco(const Codestream& cs, Tcp& tcp, Seq s) {
    if (s.n < 1) fail();
    uint32_t stages = s.get(1);
    if (stages > 1) return;
    if (s.n != stages + 1) fail();
    for (auto& t : tcp.tccps) t.dc_shift = 0;
    for (uint32_t i = 0; i < stages; ++i) add_mct(cs, tcp, s.get(1));
}

void read_cbd(Codestream& cs, Seq s) {
    if (s.n != cs.comps.size() + 2) fail();
    if (s.get(2) != cs.comps.size()) fail();
    for (auto& c : cs.comps) {
        uint32_t d = s.get(1);
        c.sgnd = (d >> 7) & 1;
        c.prec = (d & 0x7f) + 1;
        if (c.prec > 31) fail();
    }
}

// main header, then every tile-part; throws Fail
void parse(Codestream& cs) {
    const uint8_t* p = cs.p;
    size_t n = cs.len, pos = 0;
    auto u16 = [&](size_t at) -> uint32_t {
        if (at + 2 > n) fail();
        return ((uint32_t)p[at] << 8) | p[at + 1];
    };
    if (u16(0) != 0xFF4F) fail();
    pos = 2;
    // main header
    for (;;) {
        uint32_t m = u16(pos);
        if (m < 0xFF00) fail();
        if (m == 0xFF90) break;  // SOT
        if (m == 0xFFD9 || m == 0xFF93) fail();
        uint32_t l = u16(pos + 2);
        if (l < 2) fail();
        if (pos + 2 + l > n) fail();
        Seq s{p + pos + 4, l - 2};
        if (!cs.have_siz && m != 0xFF51) fail();
        switch (m) {
            case 0xFF51: read_siz(cs, s); break;
            case 0xFF52: read_cod(cs.deftcp, s); cs.have_cod = true; break;
            case 0xFF53:
                if (!cs.have_cod) fail();
                read_coc(cs, cs.deftcp, s);
                break;
            case 0xFF5C: read_qcd(cs, cs.deftcp, s); cs.have_qcd = true; break;
            case 0xFF5D: read_qcc(cs, cs.deftcp, s); break;
            case 0xFF5E: read_rgn(cs, cs.deftcp, s); break;
            case 0xFF5F: read_poc(cs, cs.deftcp, s); break;
            case 0xFF60: {  // PPM
                if (s.n < 1) fail();
                int z = (int)s.get(1);
                cs.ppm = true;
                cs.ppm_parts.emplace_back(
                    z, std::vector<uint8_t>(s.p + 1, s.p + s.n));
                break;
            }
            case 0xFF74: read_mct(cs.deftcp, s); break;
            case 0xFF75: read_mcc(cs.deftcp, s); break;
            case 0xFF77: read_mco(cs, cs.deftcp, s); break;
            case 0xFF78: read_cbd(cs, s); break;
            // OpenJPEG's checks of what it otherwise reads past
            case 0xFF55: if (s.n < 2) fail(); break;  // TLM
            case 0xFF57: if (s.n < 1) fail(); break;  // PLM
            case 0xFF63:  // CRG
                if (s.n != 4 * cs.comps.size()) fail();
                break;
            case 0xFF58: case 0xFF61: case 0xFF91:  // PLT, PPT, SOP
                fail();  // not in a main header
            default: break;  // COM, CAP, CPF and unknown markers: read past
        }
        pos += 2 + l;
    }
    if (!cs.have_cod || !cs.have_qcd) fail();
    if (cs.ppm) merge_ppm(cs);
    cs.tcps.assign((size_t)cs.tw * cs.th, cs.deftcp);
    int order = 0;
    // tile-parts
    for (;;) {
        uint32_t m = u16(pos);
        if (m != 0xFF90) fail();
        size_t sot = pos;
        if (u16(pos + 2) != 10) fail();
        Seq s{p + pos + 4, 8};
        if (pos + 12 > n) fail();
        uint32_t isot = s.get(2), psot = s.get(4), tpsot = s.get(1),
                 tnsot = s.get(1);
        if (isot >= cs.tcps.size()) fail();
        if (tnsot != 0 && tpsot >= tnsot) fail();
        if (psot != 0 && psot < 14) fail();
        Tcp& tcp = cs.tcps[isot];
        tcp.seen = true;
        pos += 12;
        // tile-part header
        for (;;) {
            uint32_t mk = u16(pos);
            if (mk == 0xFF93) break;  // SOD
            if (mk < 0xFF00) fail();
            uint32_t l = u16(pos + 2);
            if (l < 2 || pos + 2 + l > n) fail();
            Seq ms{p + pos + 4, l - 2};
            switch (mk) {
                case 0xFF52: read_cod(tcp, ms); break;
                case 0xFF53: read_coc(cs, tcp, ms); break;
                case 0xFF5C: read_qcd(cs, tcp, ms); break;
                case 0xFF5D: read_qcc(cs, tcp, ms); break;
                case 0xFF5E: read_rgn(cs, tcp, ms); break;
                case 0xFF5F: read_poc(cs, tcp, ms); break;
                case 0xFF61: {  // PPT
                    if (cs.ppm) fail();
                    if (ms.n < 1) fail();
                    int z = (int)ms.get(1);
                    tcp.ppt_present = true;
                    tcp.ppt_parts.emplace_back(
                        z, std::vector<uint8_t>(ms.p + 1, ms.p + ms.n));
                    break;
                }
                case 0xFF74: read_mct(tcp, ms); break;
                case 0xFF75: read_mcc(tcp, ms); break;
                case 0xFF77: read_mco(cs, tcp, ms); break;
                case 0xFF58: if (ms.n < 1) fail(); break;  // PLT
                case 0xFF64: break;  // COM
                default: fail();
            }
            pos += 2 + l;
        }
        pos += 2;
        size_t end;
        if (psot == 0) {
            if (n < pos + 2) fail();
            end = n - 2;
        } else {
            end = sot + psot;
            if (end < pos) fail();
            if (end > n) fail();  // strict: the tile-part runs past the end
        }
        tcp.data.insert(tcp.data.end(), p + pos, p + end);
        tcp.order = order++;
        pos = end;
        // the next marker: SOT or EOC (two last bytes that are neither end
        // the stream with a warning)
        if (pos + 2 > n) fail();
        uint32_t next = u16(pos);
        if (next == 0xFFD9) break;
        if (next == 0xFF90) continue;
        if (pos + 2 == n) break;
        fail();
    }
    for (auto& tcp : cs.tcps) {
        if (!tcp.ppt_present) continue;
        std::stable_sort(tcp.ppt_parts.begin(), tcp.ppt_parts.end(),
                         [](auto& a, auto& b) { return a.first < b.first; });
        for (auto& part : tcp.ppt_parts)
            tcp.ppt.insert(tcp.ppt.end(), part.second.begin(),
                           part.second.end());
    }
}

// ---------------------------------------------------------------------------
// tile geometry (tcd.c opj_tcd_init_tile)
// ---------------------------------------------------------------------------

void init_tile(const Codestream& cs, const Tcp& tcp, uint32_t tileno,
               std::vector<TileComp>& tcs, uint32_t& tx0, uint32_t& ty0,
               uint32_t& tx1, uint32_t& ty1) {
    uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
    tx0 = std::max<uint32_t>((uint32_t)std::min<uint64_t>(
                                 (uint64_t)cs.tx0 + (uint64_t)p * cs.tdx,
                                 0xffffffffu),
                             cs.x0);
    ty0 = std::max<uint32_t>((uint32_t)std::min<uint64_t>(
                                 (uint64_t)cs.ty0 + (uint64_t)q * cs.tdy,
                                 0xffffffffu),
                             cs.y0);
    tx1 = (uint32_t)std::min<uint64_t>((uint64_t)cs.tx0 + (uint64_t)(p + 1) *
                                                             cs.tdx,
                                       cs.x1);
    ty1 = (uint32_t)std::min<uint64_t>((uint64_t)cs.ty0 + (uint64_t)(q + 1) *
                                                             cs.tdy,
                                       cs.y1);
    tcs.assign(cs.comps.size(), TileComp());
    for (size_t c = 0; c < cs.comps.size(); ++c) {
        const Comp& comp = cs.comps[c];
        const Tccp& tccp = tcp.tccps[c];
        TileComp& tc = tcs[c];
        tc.x0 = ceildiv(tx0, comp.dx);
        tc.y0 = ceildiv(ty0, comp.dy);
        tc.x1 = ceildiv(tx1, comp.dx);
        tc.y1 = ceildiv(ty1, comp.dy);
        tc.numres = tccp.numres;
        tc.res.resize(tc.numres);
        for (int r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            uint32_t level = (uint32_t)(tc.numres - 1 - r);
            res.x0 = ceildivpow2(tc.x0, level);
            res.y0 = ceildivpow2(tc.y0, level);
            res.x1 = ceildivpow2(tc.x1, level);
            res.y1 = ceildivpow2(tc.y1, level);
            uint32_t pdx = (uint32_t)tccp.prcw[r], pdy = (uint32_t)tccp.prch[r];
            res.pdx = pdx;
            res.pdy = pdy;
            uint32_t px0 = floordivpow2(res.x0, pdx) << pdx;
            uint32_t py0 = floordivpow2(res.y0, pdy) << pdy;
            uint64_t px1 = (uint64_t)ceildivpow2(res.x1, pdx) << pdx;
            uint64_t py1 = (uint64_t)ceildivpow2(res.y1, pdy) << pdy;
            res.pw = res.x0 == res.x1 ? 0 : (uint32_t)((px1 - px0) >> pdx);
            res.ph = res.y0 == res.y1 ? 0 : (uint32_t)((py1 - py0) >> pdy);
            if ((uint64_t)res.pw * res.ph > (1u << 24)) fail();
            uint32_t cbgx0, cbgy0, cbgw, cbgh;
            if (r == 0) {
                cbgx0 = px0;
                cbgy0 = py0;
                cbgw = pdx;
                cbgh = pdy;
            } else {
                cbgx0 = ceildivpow2(px0, 1);
                cbgy0 = ceildivpow2(py0, 1);
                cbgw = pdx - 1;
                cbgh = pdy - 1;
            }
            uint32_t cblkw = std::min<uint32_t>((uint32_t)tccp.cblkw, cbgw);
            uint32_t cblkh = std::min<uint32_t>((uint32_t)tccp.cblkh, cbgh);
            res.numbands = r == 0 ? 1 : 3;
            for (int b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                int bandno = r == 0 ? 0 : b + 1;
                band.orient = bandno;
                if (r == 0) {
                    band.x0 = ceildivpow2(tc.x0, level);
                    band.y0 = ceildivpow2(tc.y0, level);
                    band.x1 = ceildivpow2(tc.x1, level);
                    band.y1 = ceildivpow2(tc.y1, level);
                } else {
                    uint32_t x0b = bandno & 1, y0b = bandno >> 1;
                    uint64_t off_x = (uint64_t)x0b << level,
                             off_y = (uint64_t)y0b << level;
                    auto cdp = [&](uint64_t a, uint64_t off) -> uint32_t {
                        if (a < off) return 0;
                        return ceildivpow2((uint32_t)(a - off), level + 1);
                    };
                    band.x0 = cdp(tc.x0, off_x);
                    band.y0 = cdp(tc.y0, off_y);
                    band.x1 = cdp(tc.x1, off_x);
                    band.y1 = cdp(tc.y1, off_y);
                }
                int stepno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
                const StepSize& ss = tccp.steps[stepno];
                int log2_gain = tccp.qmfbid == 0 ? 0
                                : bandno == 0  ? 0
                                : bandno == 3  ? 2
                                               : 1;
                int rb = (int)comp.prec + log2_gain;
                band.stepsize = (float)((1.0 + ss.mant / 2048.0) *
                                        std::pow(2.0, (double)(rb - ss.expn)));
                band.numbps = ss.expn + tccp.numgbits - 1;
                size_t nprec = (size_t)res.pw * res.ph;
                band.precs.resize(band.empty() ? 0 : nprec);
                if (band.empty()) continue;
                for (size_t pn = 0; pn < nprec; ++pn) {
                    Prec& prc = band.precs[pn];
                    uint32_t gx0 = cbgx0 + (uint32_t)(pn % res.pw) * (1u << cbgw);
                    uint32_t gy0 = cbgy0 + (uint32_t)(pn / res.pw) * (1u << cbgh);
                    uint64_t gx1 = (uint64_t)gx0 + (1u << cbgw);
                    uint64_t gy1 = (uint64_t)gy0 + (1u << cbgh);
                    prc.x0 = std::max(gx0, band.x0);
                    prc.y0 = std::max(gy0, band.y0);
                    prc.x1 = (uint32_t)std::min<uint64_t>(gx1, band.x1);
                    prc.y1 = (uint32_t)std::min<uint64_t>(gy1, band.y1);
                    if (prc.x0 >= prc.x1 || prc.y0 >= prc.y1) {
                        prc.cw = prc.ch = 0;
                        continue;
                    }
                    uint32_t cx0 = floordivpow2(prc.x0, cblkw) << cblkw;
                    uint32_t cy0 = floordivpow2(prc.y0, cblkh) << cblkh;
                    uint64_t cx1 = (uint64_t)ceildivpow2(prc.x1, cblkw) << cblkw;
                    uint64_t cy1 = (uint64_t)ceildivpow2(prc.y1, cblkh) << cblkh;
                    prc.cw = (uint32_t)((cx1 - cx0) >> cblkw);
                    prc.ch = (uint32_t)((cy1 - cy0) >> cblkh);
                    prc.cblks.resize((size_t)prc.cw * prc.ch);
                    for (size_t k = 0; k < prc.cblks.size(); ++k) {
                        Cblk& cb = prc.cblks[k];
                        uint32_t bx0 = cx0 + (uint32_t)(k % prc.cw) * (1u << cblkw);
                        uint32_t by0 = cy0 + (uint32_t)(k / prc.cw) * (1u << cblkh);
                        cb.x0 = std::max(bx0, prc.x0);
                        cb.y0 = std::max(by0, prc.y0);
                        cb.x1 = (uint32_t)std::min<uint64_t>(
                            (uint64_t)bx0 + (1u << cblkw), prc.x1);
                        cb.y1 = (uint32_t)std::min<uint64_t>(
                            (uint64_t)by0 + (1u << cblkh), prc.y1);
                    }
                    prc.incl.build((int)prc.cw, (int)prc.ch);
                    prc.imsb.build((int)prc.cw, (int)prc.ch);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// tier 2
// ---------------------------------------------------------------------------

struct Bio {
    const uint8_t* start;
    const uint8_t* end;
    const uint8_t* bp;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t len) : start(p), end(p + len), bp(p) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        ct = 0;
        if ((buf & 0xff) == 0xff) {
            bytein();
            ct = 0;
        }
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
    int stk[32];
    int sp = 0;
    int node = leaf;
    while (t.parent[node] >= 0) {
        stk[sp++] = node;
        node = t.parent[node];
    }
    int low = 0;
    for (;;) {
        if (low > t.low[node])
            t.low[node] = low;
        else
            low = t.low[node];
        while (low < threshold && low < t.value[node]) {
            if (bio.read(1))
                t.value[node] = low;
            else
                ++low;
        }
        t.low[node] = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.value[node] < threshold ? 1 : 0;
}

uint32_t getnumpasses(Bio& bio) {
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    uint32_t n = bio.read(2);
    if (n != 3) return 3 + n;
    n = bio.read(5);
    if (n != 31) return 6 + n;
    return 37 + bio.read(7);
}

void init_seg(Cblk& cb, uint32_t index, int cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& seg = cb.segs[index];
    seg = Seg();
    if (cblksty & 4) {  // TERMALL
        seg.maxpasses = 1;
    } else if (cblksty & 1) {  // BYPASS
        if (first)
            seg.maxpasses = 10;
        else
            seg.maxpasses = (cb.segs[index - 1].maxpasses == 1 ||
                             cb.segs[index - 1].maxpasses == 10)
                                ? 2
                                : 1;
    } else {
        seg.maxpasses = 109;
    }
}

struct PacketIt {
    uint32_t layno, resno, compno, precno;
};

// the packets of a tile in decoding order (pi.c), each visited once
std::vector<PacketIt> packet_order(const Codestream& cs, const Tcp& tcp,
                                   const std::vector<TileComp>& tcs,
                                   uint32_t tx0, uint32_t ty0, uint32_t tx1,
                                   uint32_t ty1) {
    uint32_t ncomp = (uint32_t)tcs.size();
    uint32_t max_res = 0, max_prec = 0;
    for (auto& tc : tcs) {
        max_res = std::max<uint32_t>(max_res, (uint32_t)tc.numres);
        for (auto& r : tc.res)
            max_prec = std::max<uint32_t>(max_prec, r.pw * r.ph);
    }
    uint64_t step_p = 1, step_c = max_prec, step_r = (uint64_t)ncomp * step_c,
             step_l = (uint64_t)max_res * step_r;
    uint64_t include_size = (uint64_t)(tcp.numlayers + 1) * step_l;
    if (include_size > ((uint64_t)1 << 28)) fail();  // OpenJPEG's calloc
    std::vector<uint8_t> include((size_t)include_size);
    std::vector<PacketIt> out;
    struct P {
        uint32_t resno0, compno0, layno1, resno1, compno1, prg;
    };
    std::vector<P> progs;
    if (!tcp.pocs.empty()) {
        for (auto& poc : tcp.pocs)
            progs.push_back({poc.resno0, poc.compno0,
                             std::min<uint32_t>(poc.layno1,
                                                (uint32_t)tcp.numlayers),
                             poc.resno1, poc.compno1, poc.prg});
    } else {
        progs.push_back({0, 0, (uint32_t)tcp.numlayers, max_res, ncomp,
                         (uint32_t)tcp.prg});
    }
    auto visit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> int {
        uint64_t index = l * step_l + r * step_r + c * step_c + p * step_p;
        if (index >= include_size) return -1;
        if (!include[index]) {
            include[index] = 1;
            out.push_back({l, r, c, p});
        }
        return 0;
    };
    for (auto& pg : progs) {
        uint32_t compno1 = std::min(pg.compno1, ncomp);
        if (pg.prg == 0 || pg.prg == 1) {  // LRCP, RLCP
            bool lrcp = pg.prg == 0;
            uint32_t outer1 = lrcp ? pg.layno1 : pg.resno1;
            uint32_t inner1 = lrcp ? pg.resno1 : pg.layno1;
            uint32_t outer0 = lrcp ? 0 : pg.resno0;
            uint32_t inner0 = lrcp ? pg.resno0 : 0;
            bool stop = false;
            for (uint32_t o = outer0; o < outer1 && !stop; ++o)
                for (uint32_t i = inner0; i < inner1 && !stop; ++i) {
                    uint32_t l = lrcp ? o : i, r = lrcp ? i : o;
                    for (uint32_t c = pg.compno0; c < compno1 && !stop; ++c) {
                        const TileComp& tc = tcs[c];
                        if (r >= (uint32_t)tc.numres) continue;
                        const Res& res = tc.res[r];
                        for (uint32_t p = 0; p < res.pw * res.ph; ++p)
                            if (visit(l, r, c, p) < 0) {
                                stop = true;
                                break;
                            }
                    }
                }
            continue;
        }
        if (pg.prg > 4) continue;
        // position-driven orders: RPCL (2), PCRL (3), CPRL (4)
        auto min_d = [&](uint32_t c0, uint32_t c1, uint32_t& dx,
                         uint32_t& dy) {
            dx = dy = 0;
            for (uint32_t c = c0; c < c1; ++c) {
                const Comp& comp = cs.comps[c];
                const TileComp& tc = tcs[c];
                for (int r = 0; r < tc.numres; ++r) {
                    const Res& res = tc.res[r];
                    uint32_t sh = res.pdx + (uint32_t)(tc.numres - 1 - r);
                    if (sh < 32 && comp.dx <= 0xffffffffu / (1u << sh)) {
                        uint32_t d = comp.dx * (1u << sh);
                        dx = dx ? std::min(dx, d) : d;
                    }
                    sh = res.pdy + (uint32_t)(tc.numres - 1 - r);
                    if (sh < 32 && comp.dy <= 0xffffffffu / (1u << sh)) {
                        uint32_t d = comp.dy * (1u << sh);
                        dy = dy ? std::min(dy, d) : d;
                    }
                }
            }
        };
        // one (x, y, comp, res) position: its precinct's packets
        auto at = [&](uint32_t x, uint32_t y, uint32_t c, uint32_t r) -> int {
            const Comp& comp = cs.comps[c];
            const TileComp& tc = tcs[c];
            if (r >= (uint32_t)tc.numres) return 0;
            const Res& res = tc.res[r];
            uint32_t level = (uint32_t)(tc.numres - 1 - r);
            if (level >= 32 || ((comp.dx << level) >> level) != comp.dx ||
                ((comp.dy << level) >> level) != comp.dy)
                return 0;
            uint32_t trx0 = ceildiv(tx0, comp.dx << level);
            uint32_t try0 = ceildiv(ty0, comp.dy << level);
            uint32_t trx1 = ceildiv(tx1, comp.dx << level);
            uint32_t try1 = ceildiv(ty1, comp.dy << level);
            uint32_t rpx = res.pdx + level, rpy = res.pdy + level;
            if (rpx >= 31 || ((comp.dx << rpx) >> rpx) != comp.dx ||
                rpy >= 31 || ((comp.dy << rpy) >> rpy) != comp.dy)
                return 0;
            if (!((y % (comp.dy << rpy) == 0) ||
                  ((y == ty0) && ((try0 << level) % (1u << rpy)))))
                return 0;
            if (!((x % (comp.dx << rpx) == 0) ||
                  ((x == tx0) && ((trx0 << level) % (1u << rpx)))))
                return 0;
            if (res.pw == 0 || res.ph == 0) return 0;
            if (trx0 == trx1 || try0 == try1) return 0;
            uint32_t prci = floordivpow2(ceildiv(x, comp.dx << level), res.pdx) -
                            floordivpow2(trx0, res.pdx);
            uint32_t prcj = floordivpow2(ceildiv(y, comp.dy << level), res.pdy) -
                            floordivpow2(try0, res.pdy);
            uint32_t precno = prci + prcj * res.pw;
            for (uint32_t l = 0; l < pg.layno1; ++l)
                if (visit(l, r, c, precno) < 0) return -1;
            return 0;
        };
        if (pg.prg == 2) {  // RPCL
            uint32_t dx, dy;
            min_d(0, ncomp, dx, dy);
            if (!dx || !dy) continue;
            bool stop = false;
            for (uint32_t r = pg.resno0; r < pg.resno1 && !stop; ++r)
                for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
                    for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
                        for (uint32_t c = pg.compno0; c < compno1; ++c)
                            if (at(x, y, c, r) < 0) {
                                stop = true;
                                break;
                            }
        } else if (pg.prg == 3) {  // PCRL
            uint32_t dx, dy;
            min_d(0, ncomp, dx, dy);
            if (!dx || !dy) continue;
            bool stop = false;
            for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
                for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
                    for (uint32_t c = pg.compno0; c < compno1 && !stop; ++c) {
                        uint32_t r1 = std::min(pg.resno1,
                                               (uint32_t)tcs[c].numres);
                        for (uint32_t r = pg.resno0; r < r1; ++r)
                            if (at(x, y, c, r) < 0) {
                                stop = true;
                                break;
                            }
                    }
        } else {  // CPRL
            bool stop = false;
            for (uint32_t c = pg.compno0; c < compno1 && !stop; ++c) {
                uint32_t dx, dy;
                min_d(c, c + 1, dx, dy);
                if (!dx || !dy) break;
                uint32_t r1 = std::min(pg.resno1, (uint32_t)tcs[c].numres);
                for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
                    for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
                        for (uint32_t r = pg.resno0; r < r1; ++r)
                            if (at(x, y, c, r) < 0) {
                                stop = true;
                                break;
                            }
            }
        }
    }
    return out;
}

// one packet (t2.c opj_t2_read_packet_header and _data); ``src`` points at
// the packet in the tile's data, ``max`` bytes of which are left; headers
// come from ``hdr`` (the tile data itself, or PPM/PPT data)
size_t decode_packet(const Tcp& tcp, std::vector<TileComp>& tcs,
                     const PacketIt& pk, const uint8_t* src, size_t max,
                     const uint8_t*& hdr, size_t& hdr_left, bool packed) {
    TileComp& tc = tcs[pk.compno];
    Res& res = tc.res[pk.resno];
    const Tccp& tccp = tcp.tccps[pk.compno];
    const uint8_t* cur = src;
    if (pk.layno == 0) {
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            if (pk.precno >= band.precs.size()) fail();
            Prec& prc = band.precs[pk.precno];
            prc.incl.reset();
            prc.imsb.reset();
            for (auto& cb : prc.cblks) cb.numsegs = 0;
        }
    }
    if (tcp.csty & 2) {  // SOP
        if (max >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    if (!packed) {
        hdr = cur;
        hdr_left = (size_t)(src + max - cur);
    }
    const uint8_t* hstart = hdr;
    Bio bio(hdr, hdr_left);
    uint32_t present = bio.read(1);
    bool data = false;
    if (present) {
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Prec& prc = band.precs[pk.precno];
            for (size_t k = 0; k < prc.cblks.size(); ++k) {
                Cblk& cb = prc.cblks[k];
                uint32_t included;
                if (!cb.numsegs)
                    included = tgt_decode(bio, prc.incl, (int)k,
                                          (int)pk.layno + 1);
                else
                    included = bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    uint32_t i = 0;
                    while (!tgt_decode(bio, prc.imsb, (int)k, (int)i)) {
                        ++i;
                        if (i > 0x7fff) fail();
                    }
                    cb.numbps = (uint32_t)band.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                uint32_t inc = 0;
                while (bio.read(1)) ++inc;
                cb.numlenbits += inc;
                uint32_t segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, 0, tccp.cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                }
                int n = (int)cb.numnewpasses;
                const bool ht = (tccp.cblksty & 0x40) != 0;
                do {
                    Seg& seg = cb.segs[segno];
                    // an HT block's first segment takes one pass (the
                    // cleanup), the next segment the rest, as OpenJPEG 2.5
                    // reads every contribution, also a later layer's
                    seg.numnewpasses =
                        ht ? (segno == 0 ? 1u : (uint32_t)n)
                           : (uint32_t)std::min<int>(
                                 (int)(seg.maxpasses - seg.numpasses), n);
                    uint32_t nn = seg.numnewpasses, lg = 0;
                    while (nn >>= 1) ++lg;
                    uint32_t bits = cb.numlenbits + lg;
                    if (bits > 32) fail();
                    seg.newlen = bio.read(bits);
                    n -= (int)seg.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                } while (n > 0);
            }
        }
        data = true;
    }
    bio.inalign();
    const uint8_t* h = hdr + bio.numbytes();
    if (tcp.csty & 4) {  // EPH
        size_t used = (size_t)(h - hstart);
        // OpenJPEG 2.5.3 requires the marker
        if (hdr_left - used < 2 || h[0] != 0xff || h[1] != 0x92) fail();
        h += 2;
    }
    size_t hlen = (size_t)(h - hstart);
    hdr_left -= hlen;
    hdr += hlen;
    if (!packed) cur = hdr;
    if (!data) return (size_t)(cur - src);
    // packet body
    for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prec& prc = band.precs[pk.precno];
        for (auto& cb : prc.cblks) {
            if (!cb.numnewpasses) continue;
            uint32_t si;
            if (!cb.numsegs) {
                si = 0;
                cb.numsegs = 1;
            } else {
                si = cb.numsegs - 1;
                if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                    ++si;
                    ++cb.numsegs;
                }
            }
            do {
                Seg& seg = cb.segs[si];
                if (cur + seg.newlen > src + max) fail();  // strict
                cb.data.insert(cb.data.end(), cur, cur + seg.newlen);
                cur += seg.newlen;
                seg.len += seg.newlen;
                seg.numpasses += seg.numnewpasses;
                cb.numnewpasses -= seg.numnewpasses;
                if (cb.numnewpasses > 0) {
                    ++si;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
        }
    }
    return (size_t)(cur - src);
}

// ---------------------------------------------------------------------------
// tier 1 (t1.c, mqc.c)
// ---------------------------------------------------------------------------

struct MqState {
    uint16_t qeval;
    uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18,
       kNumCtx = 19 };

struct Mq {
    const uint8_t* bp;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[kNumCtx], mps[kNumCtx];
    void reset_states() {
        for (int i = 0; i < kNumCtx; ++i) state[i] = 0, mps[i] = 0;
        state[kCtxUni] = 46;
        state[kCtxAgg] = 3;
        state[kCtxZc] = 4;
    }
    // the segment's bytes are followed by 0xFF 0xFF (mqc.c's synthetic
    // marker)
    void init(const uint8_t* p, uint32_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : (uint32_t)(*bp) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void bytein() {
        uint32_t l = bp[1];
        if (*bp == 0xff) {
            if (l > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += l << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += l << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    uint32_t decode(int cx) {
        const MqState& s = kMq[state[cx]];
        uint32_t d;
        a -= s.qeval;
        if ((c >> 16) < s.qeval) {
            if (a < s.qeval) {
                a = s.qeval;
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                a = s.qeval;
                d = !mps[cx];
                if (s.sw) mps[cx] = !mps[cx];
                state[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= (uint32_t)s.qeval << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qeval) {
                    d = !mps[cx];
                    if (s.sw) mps[cx] = !mps[cx];
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    // BYPASS (raw) segments
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    uint32_t raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

// per sample: the count of significant neighbours, horizontal (bits 0-1),
// vertical (2-3) and diagonal (4-6), kept as samples turn significant (the
// row below a stripe's last row left out in vertically causal mode, as
// OpenJPEG's flags leave it out), then its own state
enum : uint16_t {
    kH1 = 1, kV1 = 4, kD1 = 16, kCounts = 0x7F,
    kSig = 0x80, kNeg = 0x100, kVisit = 0x200, kRefined = 0x400
};

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<int32_t> data;
    std::vector<uint16_t> st;  // (h + 2) x (w + 2), a border ring
    std::vector<uint8_t> buf;
    Mq mq;
    int orient = 0;
    bool vsc = false;

    uint16_t* at(int x, int y) { return &st[(size_t)(y + 1) * stride + x + 1]; }

    int zc_ctx(uint16_t s) const {
        int hh = s & 3, vv = (s >> 2) & 3, dd = (s >> 4) & 7;
        int n;
        if (orient == 3) {
            int hv = hh + vv;
            if (!dd) n = !hv ? 0 : hv == 1 ? 1 : 2;
            else if (dd == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
            else if (dd == 2) n = !hv ? 6 : 7;
            else n = 8;
        } else {
            if (orient == 1) std::swap(hh, vv);
            if (!hh) n = !vv ? (!dd ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
            else if (hh == 1) n = !vv ? (!dd ? 5 : 6) : 7;
            else n = 8;
        }
        return kCtxZc + n;
    }
    static int contribution(uint16_t s) {
        return (s & kSig) ? ((s & kNeg) ? -1 : 1) : 0;
    }
    // the sign's context and its XOR bit, from the N, S, E, W neighbours
    int sc_ctx(int x, int y, int& spb) {
        uint16_t* c = at(x, y);
        bool south = !(vsc && (y & 3) == 3);
        int e = contribution(c[1]), wv = contribution(c[-1]);
        int nv = contribution(c[-stride]), sv = south ? contribution(c[stride]) : 0;
        int hc = std::min((e > 0) + (wv > 0), 1) - std::min((e < 0) + (wv < 0), 1);
        int vc = std::min((nv > 0) + (sv > 0), 1) - std::min((nv < 0) + (sv < 0), 1);
        spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
        if (hc < 0) {
            hc = -hc;
            vc = -vc;
        }
        int n;
        if (!hc) n = vc == 0 ? 0 : 1;
        else n = vc == -1 ? 2 : vc == 0 ? 3 : 4;
        return kCtxSc + n;
    }
    void set_sig(int x, int y, bool neg) {
        uint16_t* c = at(x, y);
        *c |= kSig | (neg ? kNeg : 0);
        c[-1] += kH1;
        c[1] += kH1;
        c[stride] += kV1;  // the row below always sees this one
        c[stride - 1] += kD1;
        c[stride + 1] += kD1;
        if (!(vsc && (y & 3) == 0)) {  // the row above, unless it ends a stripe
            c[-stride] += kV1;
            c[-stride - 1] += kD1;
            c[-stride + 1] += kD1;
        }
    }

    template <class Fn>
    void scan(Fn fn) {
        for (int k = 0; k < h; k += 4) {
            int k1 = std::min(k + 4, h);
            for (int x = 0; x < w; ++x)
                for (int y = k; y < k1; ++y) fn(x, y);
        }
    }

    void decode_sig(int x, int y, int32_t oph, bool raw) {
        uint32_t s;
        if (raw) {
            s = mq.raw();
        } else {
            int spb;
            int cx = sc_ctx(x, y, spb);
            s = mq.decode(cx) ^ (uint32_t)spb;
        }
        data[(size_t)y * w + x] = s ? -oph : oph;
        set_sig(x, y, s);
    }

    void sigpass(int bp, bool raw) {
        int32_t one = 1 << bp, oph = one | (one >> 1);
        scan([&](int x, int y) {
            uint16_t s = *at(x, y);
            if ((s & (kSig | kVisit)) || !(s & kCounts)) return;
            if (raw ? mq.raw() : mq.decode(zc_ctx(s))) decode_sig(x, y, oph, raw);
            *at(x, y) |= kVisit;
        });
    }

    void refpass(int bp, bool raw) {
        int32_t half = (1 << bp) >> 1;
        scan([&](int x, int y) {
            uint16_t& s = *at(x, y);
            if ((s & (kSig | kVisit)) != kSig) return;
            int cx = (s & kRefined) ? kCtxMag + 2
                     : (s & kCounts) ? kCtxMag + 1
                                     : kCtxMag;
            uint32_t v = raw ? mq.raw() : mq.decode(cx);
            int32_t& d = data[(size_t)y * w + x];
            d += (v ^ (uint32_t)(d < 0)) ? half : -half;
            s |= kRefined;
        });
    }

    void clnpass(int bp, bool segsym) {
        int32_t one = 1 << bp, oph = one | (one >> 1);
        const uint16_t busy = kSig | kVisit | kCounts;
        int k = 0;
        for (; k + 4 <= h; k += 4) {
            for (int x = 0; x < w; ++x) {
                int y = k;
                if (!((*at(x, k) | *at(x, k + 1) | *at(x, k + 2) |
                       *at(x, k + 3)) & busy)) {
                    // run-length mode: the column and its neighbours
                    // insignificant, none visited
                    if (!mq.decode(kCtxAgg)) continue;
                    uint32_t r = mq.decode(kCtxUni);
                    r = (r << 1) | mq.decode(kCtxUni);
                    decode_sig(x, k + (int)r, oph, false);
                    for (y = k + (int)r + 1; y < k + 4; ++y)
                        if (mq.decode(zc_ctx(*at(x, y))))
                            decode_sig(x, y, oph, false);
                }
                for (; y < k + 4; ++y) {
                    uint16_t& s = *at(x, y);
                    if (s & (kSig | kVisit)) {
                        s &= ~kVisit;
                        continue;
                    }
                    if (mq.decode(zc_ctx(s))) decode_sig(x, y, oph, false);
                }
            }
        }
        for (int x = 0; k < h && x < w; ++x)
            for (int y = k; y < h; ++y) {
                uint16_t& s = *at(x, y);
                if (s & (kSig | kVisit)) {
                    s &= ~kVisit;
                    continue;
                }
                if (mq.decode(zc_ctx(s))) decode_sig(x, y, oph, false);
            }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
        }
    }

    // opj_t1_decode_cblk; false where OpenJPEG gives up on the code-block
    bool decode(const Cblk& cb, int orient_, int roishift, int cblksty) {
        w = (int)(cb.x1 - cb.x0);
        h = (int)(cb.y1 - cb.y0);
        stride = w + 2;
        orient = orient_;
        vsc = (cblksty & 8) != 0;
        data.assign((size_t)w * h, 0);
        st.assign((size_t)(h + 2) * stride, 0);
        int bpno = roishift + (int)cb.numbps;
        if (cb.numsegs == 0) return true;
        if (bpno >= 31) return false;
        int passtype = 2;
        mq.reset_states();
        size_t off = 0;
        for (uint32_t s = 0; s < cb.numsegs; ++s) {
            const Seg& seg = cb.segs[s];
            bool raw = bpno <= (int)cb.numbps - 4 && passtype < 2 &&
                       (cblksty & 1);
            buf.assign(cb.data.begin() + off, cb.data.begin() + off + seg.len);
            buf.push_back(0xff);
            buf.push_back(0xff);
            off += seg.len;
            if (raw)
                mq.raw_init(buf.data());
            else
                mq.init(buf.data(), seg.len);
            for (uint32_t p = 0; p < seg.numpasses && bpno >= 1; ++p) {
                if (passtype == 0)
                    sigpass(bpno, raw);
                else if (passtype == 1)
                    refpass(bpno, raw);
                else
                    clnpass(bpno, (cblksty & 32) != 0);
                if ((cblksty & 2) && !raw) mq.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    bpno--;
                }
            }
        }
        if (roishift) {
            if (roishift >= 31) {
                std::fill(data.begin(), data.end(), 0);
            } else {
                int32_t thresh = 1 << roishift;
                for (auto& v : data) {
                    int32_t mag = std::abs(v);
                    if (mag >= thresh) {
                        mag >>= roishift;
                        v = v < 0 ? -mag : mag;
                    }
                }
            }
        }
        return true;
    }
};

// ---------------------------------------------------------------------------
// HT code-blocks (JPEG 2000 Part 15, ITU-T T.814; OpenJPEG's ht_dec.c)
// ---------------------------------------------------------------------------

// The CxtVLC decoding tables of the cleanup pass (T.814 Annex C, its tables
// of codewords per context), as OpenJPEG's vlc_tbl0 (the first line pair)
// and vlc_tbl1 (the other lines) hold them: index (context << 7) | the next
// 7 bits of the VLC stream; entry bits 0-2 the codeword's length, 3 u_off,
// 4-7 rho (the quad's significance), 8-11 e_1, 12-15 e_k.
const uint16_t kVlcTbl0[1024] = {
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0xd8df,
    0x0023, 0x10be, 0x0043, 0xf5ff, 0x0083, 0x207e, 0x0055, 0x515f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0xcccf,
    0x0023, 0xe2fe, 0x0043, 0x99ff, 0x0083, 0x0096, 0x00c5, 0x313f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x11df,
    0x0023, 0xf4fe, 0x0043, 0xfcff, 0x0083, 0x009e, 0x0055, 0x0077,
    0x0023, 0x0035, 0x0043, 0xf1ff, 0x0083, 0x88ae, 0x0014, 0x00b7,
    0x0023, 0xf8fe, 0x0043, 0xe4ef, 0x0083, 0x888e, 0x00c5, 0x111f,
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0x54df,
    0x0023, 0x10be, 0x0043, 0x22ef, 0x0083, 0x207e, 0x0055, 0x227f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0x11bf,
    0x0023, 0xe2fe, 0x0043, 0x00f7, 0x0083, 0x0096, 0x00c5, 0x223f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x00d7,
    0x0023, 0xf4fe, 0x0043, 0xbaff, 0x0083, 0x009e, 0x0055, 0x006f,
    0x0023, 0x0035, 0x0043, 0xe6ff, 0x0083, 0x88ae, 0x0014, 0xa2af,
    0x0023, 0xf8fe, 0x0043, 0x00e7, 0x0083, 0x888e, 0x00c5, 0x222f,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0x00f7,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x00d7,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x11df,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x111f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x88ff,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0x00b7,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0x00e7,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x0077,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0xf1ff,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x11bf,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x22ef,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x227f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe4ef,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0xa2af,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0xd8df,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x515f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x32ff,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x00b7,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x0077,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0x00e7,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x555f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x747f,
    0x0002, 0xc4de, 0x0044, 0xf8ff, 0x0002, 0x0096, 0x0014, 0x222f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x00f7,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x888f,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0xc8cf,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x006f,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0xd1df,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x227f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x22bf,
    0x0002, 0xc4de, 0x0044, 0x22ef, 0x0002, 0x0096, 0x0014, 0x323f,
    0x0003, 0xd4de, 0xf4fd, 0xfcff, 0x0014, 0x113e, 0x0055, 0x888f,
    0x0003, 0x32be, 0x0085, 0x00e7, 0x0025, 0x515e, 0xaafe, 0x727f,
    0x0003, 0x44ce, 0xf8fd, 0x44ef, 0x0014, 0x647e, 0x0045, 0xa2af,
    0x0003, 0x00a6, 0x555d, 0x99df, 0xf1fd, 0x0036, 0xf5fe, 0x626f,
    0x0003, 0xd1de, 0xf4fd, 0xe6ff, 0x0014, 0x717e, 0x0055, 0xb1bf,
    0x0003, 0x88ae, 0x0085, 0xd5df, 0x0025, 0x444e, 0xf2fe, 0x667f,
    0x0003, 0x00c6, 0xf8fd, 0xe2ef, 0x0014, 0x545e, 0x0045, 0x119f,
    0x0003, 0x0096, 0x555d, 0xc8cf, 0xf1fd, 0x111e, 0xc8ee, 0x0067,
    0x0003, 0xd4de, 0xf4fd, 0xf3ff, 0x0014, 0x113e, 0x0055, 0x11bf,
    0x0003, 0x32be, 0x0085, 0xd8df, 0x0025, 0x515e, 0xaafe, 0x222f,
    0x0003, 0x44ce, 0xf8fd, 0x00f7, 0x0014, 0x647e, 0x0045, 0x989f,
    0x0003, 0x00a6, 0x555d, 0x00d7, 0xf1fd, 0x0036, 0xf5fe, 0x446f,
    0x0003, 0xd1de, 0xf4fd, 0xb9ff, 0x0014, 0x717e, 0x0055, 0x00b7,
    0x0003, 0x88ae, 0x0085, 0xdcdf, 0x0025, 0x444e, 0xf2fe, 0x0077,
    0x0003, 0x00c6, 0xf8fd, 0xe4ef, 0x0014, 0x545e, 0x0045, 0x737f,
    0x0003, 0x0096, 0x555d, 0xb8bf, 0xf1fd, 0x111e, 0xc8ee, 0x323f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x11df,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0xb2bf,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00e7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x0077,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x00f7,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0xaaaf,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0xc4cf,
    0x0002, 0x44ee, 0x0044, 0xf4ff, 0x0002, 0x223e, 0x0014, 0x111f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x99ff,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0x00b7,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x444f,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe2ef,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0x447f,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0x009f,
    0x0002, 0x44ee, 0x0044, 0x76ff, 0x0002, 0x223e, 0x0014, 0x313f,
    0x0003, 0x00c6, 0x0085, 0xd9ff, 0xf2fd, 0x647e, 0xf1fe, 0x99bf,
    0x0003, 0xa2ae, 0x0025, 0x66ef, 0xf4fd, 0x0056, 0xe2ee, 0x737f,
    0x0003, 0x98be, 0x0045, 0x00f7, 0xf8fd, 0x0066, 0x76fe, 0x889f,
    0x0003, 0x888e, 0x0015, 0xd5df, 0x00a5, 0x222e, 0x98de, 0x444f,
    0x0003, 0xb2be, 0x0085, 0xfcff, 0xf2fd, 0x226e, 0x0096, 0x00b7,
    0x0003, 0xaaae, 0x0025, 0xd1df, 0xf4fd, 0x0036, 0xd4de, 0x646f,
    0x0003, 0xa8ae, 0x0045, 0xeaef, 0xf8fd, 0x445e, 0xe8ee, 0x717f,
    0x0003, 0x323e, 0x0015, 0xc4cf, 0x00a5, 0xfaff, 0x88ce, 0x313f,
    0x0003, 0x00c6, 0x0085, 0x77ff, 0xf2fd, 0x647e, 0xf1fe, 0xb3bf,
    0x0003, 0xa2ae, 0x0025, 0x00e7, 0xf4fd, 0x0056, 0xe2ee, 0x0077,
    0x0003, 0x98be, 0x0045, 0xe4ef, 0xf8fd, 0x0066, 0x76fe, 0x667f,
    0x0003, 0x888e, 0x0015, 0x00d7, 0x00a5, 0x222e, 0x98de, 0x333f,
    0x0003, 0xb2be, 0x0085, 0x75ff, 0xf2fd, 0x226e, 0x0096, 0x919f,
    0x0003, 0xaaae, 0x0025, 0x99df, 0xf4fd, 0x0036, 0xd4de, 0x515f,
    0x0003, 0xa8ae, 0x0045, 0xecef, 0xf8fd, 0x445e, 0xe8ee, 0x727f,
    0x0003, 0x323e, 0x0015, 0xb1bf, 0x00a5, 0xf3ff, 0x88ce, 0x111f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0xcccf,
    0x0003, 0x91be, 0x0045, 0x22ef, 0x0025, 0x222e, 0xf3fe, 0x888f,
    0x0003, 0x00c6, 0x0085, 0x00f7, 0x0014, 0x115e, 0xfcfe, 0xa8af,
    0x0003, 0x00a6, 0x0035, 0xc8df, 0xf1fd, 0x313e, 0x66fe, 0x646f,
    0x0003, 0xc8ce, 0xf2fd, 0xf5ff, 0x0014, 0x0066, 0xf4fe, 0xbabf,
    0x0003, 0x22ae, 0x0045, 0x00e7, 0x0025, 0x323e, 0xeafe, 0x737f,
    0x0003, 0xb2be, 0x0085, 0x55df, 0x0014, 0x0056, 0x717e, 0x119f,
    0x0003, 0x0096, 0x0035, 0xc4cf, 0xf1fd, 0x333e, 0xe8ee, 0x444f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0x99bf,
    0x0003, 0x91be, 0x0045, 0xe2ef, 0x0025, 0x222e, 0xf3fe, 0x667f,
    0x0003, 0x00c6, 0x0085, 0xe4ef, 0x0014, 0x115e, 0xfcfe, 0x989f,
    0x0003, 0x00a6, 0x0035, 0x00d7, 0xf1fd, 0x313e, 0x66fe, 0x226f,
    0x0003, 0xc8ce, 0xf2fd, 0xb9ff, 0x0014, 0x0066, 0xf4fe, 0x00b7,
    0x0003, 0x22ae, 0x0045, 0xd1df, 0x0025, 0x323e, 0xeafe, 0x0077,
    0x0003, 0xb2be, 0x0085, 0xecef, 0x0014, 0x0056, 0x717e, 0x727f,
    0x0003, 0x0096, 0x0035, 0xb8bf, 0xf1fd, 0x333e, 0xe8ee, 0x545f,
    0xf1fc, 0xd1de, 0xfafd, 0x00d7, 0xf8fc, 0x0016, 0xfffd, 0x747f,
    0xf4fc, 0x717e, 0xf3fd, 0xb3bf, 0xf2fc, 0xeaef, 0xe8ee, 0x444f,
    0xf1fc, 0x22ae, 0x0005, 0xb8bf, 0xf8fc, 0x00f7, 0xfcfe, 0x0077,
    0xf4fc, 0x115e, 0xf5fd, 0x757f, 0xf2fc, 0xd8df, 0xe2ee, 0x333f,
    0xf1fc, 0xb2be, 0xfafd, 0x88cf, 0xf8fc, 0xfbff, 0xfffd, 0x737f,
    0xf4fc, 0x006e, 0xf3fd, 0x00b7, 0xf2fc, 0x66ef, 0xf9fe, 0x313f,
    0xf1fc, 0x009e, 0x0005, 0xbabf, 0xf8fc, 0xfdff, 0xf6fe, 0x0067,
    0xf4fc, 0x0026, 0xf5fd, 0x888f, 0xf2fc, 0xdcdf, 0xd4de, 0x222f,
    0xf1fc, 0xd1de, 0xfafd, 0xc4cf, 0xf8fc, 0x0016, 0xfffd, 0x727f,
    0xf4fc, 0x717e, 0xf3fd, 0x99bf, 0xf2fc, 0xecef, 0xe8ee, 0x0047,
    0xf1fc, 0x22ae, 0x0005, 0x00a7, 0xf8fc, 0xf7ff, 0xfcfe, 0x0057,
    0xf4fc, 0x115e, 0xf5fd, 0x0097, 0xf2fc, 0xd5df, 0xe2ee, 0x0037,
    0xf1fc, 0xb2be, 0xfafd, 0x00c7, 0xf8fc, 0xfeff, 0xfffd, 0x667f,
    0xf4fc, 0x006e, 0xf3fd, 0xa8af, 0xf2fc, 0x00e7, 0xf9fe, 0x323f,
    0xf1fc, 0x009e, 0x0005, 0xb1bf, 0xf8fc, 0xe4ef, 0xf6fe, 0x545f,
    0xf4fc, 0x0026, 0xf5fd, 0x0087, 0xf2fc, 0x99df, 0xd4de, 0x111f,
};

const uint16_t kVlcTbl1[1024] = {
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x00d7,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x0077,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0x00e7,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x11ff,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0xa2af,
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x44ef,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x00b7,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0xc4cf,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x00f7,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00d7,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x888f,
    0x0001, 0x0024, 0x0001, 0x00f7, 0x0001, 0x0035, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00b7,
    0x0001, 0x0024, 0x0001, 0x00bf, 0x0001, 0x0045, 0x0001, 0x0067,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x00e7, 0x0001, 0x0035, 0x0001, 0x113f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00cf,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x009f,
    0x0001, 0x0024, 0x0001, 0x00ef, 0x0001, 0x0035, 0x0001, 0x323f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00af,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x007f,
    0x0001, 0x0024, 0x0001, 0x00df, 0x0001, 0x0035, 0x0001, 0x111f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0x00bf,
    0x0001, 0x0014, 0x0001, 0x00f7, 0x0001, 0x00c6, 0x0001, 0x0077,
    0x0001, 0x0024, 0x0001, 0xf8ff, 0x0001, 0x0045, 0x0001, 0x007f,
    0x0001, 0x0014, 0x0001, 0x00df, 0x0001, 0x00a6, 0x0001, 0x313f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0x00b7,
    0x0001, 0x0014, 0x0001, 0x44ef, 0x0001, 0xa2ae, 0x0001, 0x0067,
    0x0001, 0x0024, 0x0001, 0x51ff, 0x0001, 0x0045, 0x0001, 0x0097,
    0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0036, 0x0001, 0x223f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0xb2bf,
    0x0001, 0x0014, 0x0001, 0x40ef, 0x0001, 0x00c6, 0x0001, 0x006f,
    0x0001, 0x0024, 0x0001, 0x72ff, 0x0001, 0x0045, 0x0001, 0x009f,
    0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x00a6, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0xa8af,
    0x0001, 0x0014, 0x0001, 0x00e7, 0x0001, 0xa2ae, 0x0001, 0x005f,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x888f,
    0x0001, 0x0014, 0x0001, 0xaaaf, 0x0001, 0x0036, 0x0001, 0x111f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0x66ff,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0xa8af,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0xb3bf,
    0x0002, 0xb2be, 0x0014, 0xf5ff, 0x0002, 0x0066, 0x517e, 0x545f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x44ef,
    0x0002, 0x00c6, 0x0014, 0xf4ff, 0x0002, 0x0076, 0x0035, 0x447f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0x00d7,
    0x0002, 0x88be, 0x0014, 0xfaff, 0x0002, 0x115e, 0xf1fe, 0x444f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0xc8ef,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0x888f,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0x44df,
    0x0002, 0xb2be, 0x0014, 0xa8ff, 0x0002, 0x0066, 0x517e, 0x006f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x00e7,
    0x0002, 0x00c6, 0x0014, 0xe2ef, 0x0002, 0x0076, 0x0035, 0x727f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0xb1bf,
    0x0002, 0x88be, 0x0014, 0x73ff, 0x0002, 0x115e, 0xf1fe, 0x333f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc4cf,
    0x0001, 0x0044, 0x0001, 0x32ff, 0x0001, 0x0015, 0x0001, 0x888f,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x00af,
    0x0001, 0x0044, 0x0001, 0x22ef, 0x0001, 0x00a6, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0xcccf,
    0x0001, 0x0044, 0x0001, 0x00f7, 0x0001, 0x0015, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x009f,
    0x0001, 0x0044, 0x0001, 0x00df, 0x0001, 0x30fe, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc8cf,
    0x0001, 0x0044, 0x0001, 0x11ff, 0x0001, 0x0015, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x007f,
    0x0001, 0x0044, 0x0001, 0x00e7, 0x0001, 0x00a6, 0x0001, 0x0037,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0x00b7,
    0x0001, 0x0044, 0x0001, 0x00bf, 0x0001, 0x0015, 0x0001, 0x003f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x0097,
    0x0001, 0x0044, 0x0001, 0x00d7, 0x0001, 0x30fe, 0x0001, 0x111f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xf3ff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0xd8df,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x99ff,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x009f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0x76ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0xc8cf,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0xe4ef,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x222f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xfaff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0x11bf,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x22ef,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x227f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0xd5ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0x006f,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0x11df,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x515f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xd4df,
    0x0003, 0xa2ae, 0x0055, 0x76ff, 0x0024, 0x223e, 0x00b6, 0xaaaf,
    0x0003, 0x00e6, 0x0014, 0xf5ff, 0x0044, 0x0066, 0x0085, 0xcccf,
    0x0003, 0x009e, 0x00c5, 0x44ef, 0x0024, 0x0036, 0xf8fe, 0x317f,
    0x0003, 0xe8ee, 0x0014, 0xf1ff, 0x0044, 0x0076, 0x00a5, 0xc4cf,
    0x0003, 0x227e, 0x0055, 0xd1df, 0x0024, 0x444e, 0xf4fe, 0x515f,
    0x0003, 0x00d6, 0x0014, 0xe2ef, 0x0044, 0x445e, 0x0085, 0x22bf,
    0x0003, 0x0096, 0x00c5, 0xc8df, 0x0024, 0x222e, 0xf2fe, 0x226f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xb1bf,
    0x0003, 0xa2ae, 0x0055, 0x33ff, 0x0024, 0x223e, 0x00b6, 0xa8af,
    0x0003, 0x00e6, 0x0014, 0xb9ff, 0x0044, 0x0066, 0x0085, 0xa8bf,
    0x0003, 0x009e, 0x00c5, 0xe4ef, 0x0024, 0x0036, 0xf8fe, 0x646f,
    0x0003, 0xe8ee, 0x0014, 0xfcff, 0x0044, 0x0076, 0x00a5, 0xc8cf,
    0x0003, 0x227e, 0x0055, 0xeaef, 0x0024, 0x444e, 0xf4fe, 0x747f,
    0x0003, 0x00d6, 0x0014, 0xfaff, 0x0044, 0x445e, 0x0085, 0xb2bf,
    0x0003, 0x0096, 0x00c5, 0x44df, 0x0024, 0x222e, 0xf2fe, 0x313f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0x11df,
    0x00f3, 0x54de, 0xf2fd, 0xe4ef, 0x00d5, 0x717e, 0xfcfe, 0x737f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0xb1bf,
    0x00f3, 0x00ce, 0x00b5, 0xd8df, 0xf4fd, 0x0066, 0xb9fe, 0x545f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x009f,
    0x00f3, 0x00ae, 0xf2fd, 0xf7ff, 0x00d5, 0x0046, 0xf5fe, 0x747f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x888f,
    0x00f3, 0x00c6, 0x00b5, 0xe2ef, 0xf4fd, 0x115e, 0xa8ee, 0x113f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0xd1df,
    0x00f3, 0x54de, 0xf2fd, 0xfbff, 0x00d5, 0x717e, 0xfcfe, 0x447f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0x727f,
    0x00f3, 0x00ce, 0x00b5, 0x22ef, 0xf4fd, 0x0066, 0xb9fe, 0x444f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x11bf,
    0x00f3, 0x00ae, 0xf2fd, 0xffff, 0x00d5, 0x0046, 0xf5fe, 0x323f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x006f,
    0x00f3, 0x00c6, 0x00b5, 0xb8bf, 0xf4fd, 0x115e, 0xa8ee, 0x222f,
};

// The cleanup pass's three streams and the refinement passes' two, each
// read a byte at a time into a 64-bit window as OpenJPEG's readers do (its
// 32-bit reads give the same bits): a stuffed bit is not counted, and the
// byte's top bit is ORed into the next byte's first, as there.

// MEL: forward from Lcup - Scup, MSB first; the last of its Scup - 1 bytes
// (it holds Scup's low nibble) with its low nibble set, then 0xFF; a byte
// after 0xFF gives 7 bits
struct MelReader {
    const uint8_t* p;
    int size;
    uint64_t tmp = 0;
    int bits = 0;
    bool unstuff = false;
    int k = 0;
    void init(const uint8_t* data, int lcup, int scup) {
        p = data + lcup - scup;
        size = scup - 1;
    }
    void fill() {
        while (bits <= 56) {
            uint32_t d = size > 0 ? *p : 0xFF;
            if (size == 1) d |= 0xF;
            if (size > 0) ++p;
            --size;
            int n = 8 - (int)unstuff;
            tmp |= (uint64_t)d << (64 - n - bits);
            bits += n;
            unstuff = d == 0xFF;
        }
    }
    // mel_decode: one run, 2 x (0 events) + (ends in a 1 event)
    int run() {
        static const int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
        if (bits < 6) fill();
        int e = kExp[k];
        int r;
        if (tmp >> 63) {
            r = ((1 << e) - 1) << 1;
            k = std::min(k + 1, 12);
            tmp <<= 1;
            bits -= 1;
        } else {
            r = (int)((tmp >> (63 - e)) & ((1u << e) - 1));
            k = std::max(k - 1, 0);
            tmp <<= e + 1;
            bits -= e + 1;
            r = (r << 1) + 1;
        }
        return r;
    }
};

// VLC and MagRef: backward, LSB first; after a byte above 0x8F, a byte
// whose low 7 bits are set gives 7; zeros past the end
struct RevReader {
    const uint8_t* p;
    int size;
    uint64_t tmp = 0;
    uint32_t bits = 0;
    bool unstuff = false;
    // the VLC: its first byte is the upper nibble of byte Lcup - 2
    void init_vlc(const uint8_t* data, int lcup, int scup) {
        p = data + lcup - 2;
        size = scup - 2;
        uint32_t d = *p--;
        tmp = d >> 4;
        bits = 4 - ((tmp & 7) == 7);
        unstuff = (d | 0xF) > 0x8F;
    }
    void init_mrp(const uint8_t* data, int lcup, int len2) {
        p = data + lcup + len2 - 1;
        size = len2;
        unstuff = true;
    }
    uint32_t fetch() {
        while (bits <= 56) {
            uint64_t d = size > 0 ? *p-- : 0;
            --size;
            uint32_t n = 8 - ((unstuff && (d & 0x7F) == 0x7F) ? 1 : 0);
            tmp |= d << bits;
            bits += n;
            unstuff = d > 0x8F;
        }
        return (uint32_t)tmp;
    }
    uint32_t advance(uint32_t n) {
        tmp >>= n;
        bits -= n;
        return (uint32_t)tmp;
    }
};

// MagSgn and SigProp: forward, LSB first; a byte after 0xFF gives 7 bits;
// past the end ``x`` (0xFF for MagSgn, 0 for SigProp)
struct FwdReader {
    const uint8_t* p;
    int size;
    uint32_t x;
    uint64_t tmp = 0;
    uint32_t bits = 0;
    bool unstuff = false;
    void init(const uint8_t* data, int n, uint32_t fill) {
        p = data;
        size = n;
        x = fill;
    }
    uint32_t fetch() {
        while (bits <= 56) {
            uint64_t d = size > 0 ? *p++ : x;
            --size;
            tmp |= d << bits;
            bits += 8 - (unstuff ? 1 : 0);
            unstuff = (d & 0xFF) == 0xFF;
        }
        return (uint32_t)tmp;
    }
    void advance(uint32_t n) {
        tmp >>= n;
        bits -= n;
    }
};

// the u of a quad pair from the UVLC (decode_init_uvlc, decode_noninit_uvlc):
// its prefix table, per the next 3 bits: prefix length (bits 0-1), suffix
// length (2-4), prefix value (5-7)
const uint8_t kUvlcPrefix[8] = {
    3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

uint32_t decode_uvlc(uint32_t vlc, uint32_t mode, bool initial, uint32_t* u) {
    uint32_t consumed = 0;
    auto prefix = [&](uint32_t& d) {
        d = kUvlcPrefix[vlc & 7];
        vlc >>= d & 3;
        consumed += d & 3;
    };
    auto suffix = [&](uint32_t d) {
        uint32_t n = (d >> 2) & 7;
        consumed += n;
        uint32_t v = (d >> 5) + (vlc & ((1u << n) - 1));
        vlc >>= n;
        return v;
    };
    if (mode == 0) {
        u[0] = u[1] = 1;
    } else if (mode <= 2) {
        uint32_t d;
        prefix(d);
        d = suffix(d);
        u[0] = mode == 1 ? d + 1 : 1;
        u[1] = mode == 1 ? 1 : d + 1;
    } else if (mode == 3 && initial) {
        // both u_off set, MEL event 0: when the first prefix is "001" or
        // "000", the second u is 1 + one bit
        uint32_t d1;
        prefix(d1);
        if ((d1 & 3) > 2) {
            u[1] = (vlc & 1) + 1 + 1;
            ++consumed;
            vlc >>= 1;
            u[0] = suffix(d1) + 1;
        } else {
            uint32_t d2;
            prefix(d2);
            u[0] = suffix(d1) + 1;
            u[1] = suffix(d2) + 1;
        }
    } else {
        // both u_off set (mode 4 on the first line pair: MEL event 1, each
        // u above 2)
        uint32_t d1, d2;
        prefix(d1);
        prefix(d2);
        uint32_t add = mode == 4 ? 3 : 1;
        u[0] = suffix(d1) + add;
        u[1] = suffix(d2) + add;
    }
    return consumed;
}

// One HT code-block (opj_t1_ht_decode_cblk) into ``out`` (w x h int32, in
// the Part 1 decoder's convention: bit b of the magnitude at bit b + 1, the
// bin centre below): false where OpenJPEG gives up on it. ``mb`` is the
// band's Mb.
bool decode_ht(const Cblk& cb, uint32_t mb, int roishift, int cblksty,
               int w, int h, std::vector<int32_t>& out) {
    out.assign((size_t)w * h, 0);
    if (roishift != 0) return false;  // OpenJPEG has no ROI for HT blocks
    if (cb.numsegs == 0) return true;
    uint32_t zero_bplanes = (mb + 1) - cb.numbps;
    uint32_t num_passes = cb.segs[0].numpasses;
    if (cb.numsegs > 1) num_passes += cb.segs[1].numpasses;
    uint32_t cblk_len = (uint32_t)cb.data.size();
    uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
    uint32_t lengths2 =
        num_passes > 1 && cb.segs.size() > 1 ? cb.segs[1].len : 0;
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;
    if (num_passes > 3) return false;
    if (mb > 30) return false;
    if (zero_bplanes > mb) return false;
    if (zero_bplanes == mb && num_passes > 1) num_passes = 1;
    const uint32_t p = cb.numbps;
    const uint32_t zero_bplanes_p1 = zero_bplanes + 1;
    if (lengths1 < 2 || lengths1 > cblk_len ||
        (uint64_t)lengths1 + lengths2 > cblk_len)
        return false;
    const uint8_t* coded = cb.data.data();
    int lcup = (int)lengths1;
    int scup = ((int)coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079) return false;
    MelReader mel;
    mel.init(coded, lcup, scup);
    RevReader vlc;
    vlc.init_vlc(coded, lcup, scup);
    FwdReader magsgn;
    magsgn.init(coded, lcup - scup, 0xFF);

    // sign-magnitude samples (bit 31 the sign), and the significance the
    // cleanup finds (SigProp adds its own), with a border of one sample
    std::vector<uint32_t> dec((size_t)w * h, 0);
    const size_t kw = (size_t)w + 2;
    std::vector<uint8_t> sig(kw * (h + 2), 0);
    auto sig_at = [&](int x, int y) -> uint8_t& {
        return sig[(size_t)(y + 1) * kw + x + 1];
    };
    // line state per pair of columns: bit 7 significance, the rest E
    std::vector<uint8_t> line((size_t)w / 2 + 8, 0);
    auto sample = [&](uint32_t q, int n, uint32_t u, int x, int y,
                      uint32_t* e_out) -> bool {
        // sample n of a quad (0 top left, 1 below it, 2 top right, 3)
        if (!(q & (0x10u << n))) return false;
        uint32_t ms = magsgn.fetch();
        uint32_t m_n = u - ((q >> (12 + n)) & 1);
        magsgn.advance(m_n);
        uint32_t val = ms << 31;
        uint32_t v_n = ms & ((1u << m_n) - 1);
        v_n |= ((q >> (8 + n)) & 1) << m_n;
        v_n |= 1;
        dec[(size_t)y * w + x] = val | ((v_n + 2) << (p - 1));
        sig_at(x, y) = 1;
        if (e_out) *e_out = 32 - (uint32_t)__builtin_clz(v_n);
        return true;
    };
    int run = mel.run();
    for (int y = 0; y < h; y += 2) {
        const bool initial = y == 0;
        const uint16_t* table = initial ? kVlcTbl0 : kVlcTbl1;
        uint8_t* lsp = line.data();
        uint8_t ls0 = lsp[0];
        lsp[0] = 0;
        uint32_t c_q = 0;
        for (int x = 0; x < w; x += 4) {
            uint32_t qinf[2] = {0, 0}, u_q[2];
            uint32_t vlc_val = vlc.fetch();
            if (!initial) {
                c_q |= ls0 >> 7;
                c_q |= (lsp[1] >> 5) & 4;
            }
            qinf[0] = table[(c_q << 7) | (vlc_val & 0x7F)];
            if (c_q == 0) {
                run -= 2;
                qinf[0] = run == -1 ? qinf[0] : 0;
                if (run < 0) run = mel.run();
            }
            if (initial)
                c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
            else
                c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
            vlc_val = vlc.advance(qinf[0] & 7);
            if (x + 2 < w) {
                if (!initial) {
                    c_q |= lsp[1] >> 7;
                    c_q |= (lsp[2] >> 5) & 4;
                }
                qinf[1] = table[(c_q << 7) | (vlc_val & 0x7F)];
                if (c_q == 0) {
                    run -= 2;
                    qinf[1] = run == -1 ? qinf[1] : 0;
                    if (run < 0) run = mel.run();
                }
                if (initial)
                    c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
                else
                    c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
                vlc_val = vlc.advance(qinf[1] & 7);
            }
            uint32_t mode = ((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2);
            if (initial && mode == 3) {
                run -= 2;
                mode += run == -1 ? 1 : 0;
                if (run < 0) run = mel.run();
            }
            uint32_t consumed = decode_uvlc(vlc_val, mode, initial, u_q);
            vlc_val = vlc.advance(consumed);
            if (!initial) {
                // kappa: E^max of the neighbours above, where the quad has
                // more than one significant sample
                if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
                    uint32_t e = std::max<uint32_t>(ls0 & 0x7F, lsp[1] & 0x7F);
                    u_q[0] += e > 2 ? e - 2 : 0;
                }
                if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
                    uint32_t e = std::max<uint32_t>(lsp[1] & 0x7F,
                                                    lsp[2] & 0x7F);
                    u_q[1] += e > 2 ? e - 2 : 0;
                }
            }
            if (u_q[0] > zero_bplanes_p1 || u_q[1] > zero_bplanes_p1)
                return false;
            if (!initial) {
                ls0 = lsp[2];
                lsp[1] = lsp[2] = 0;
            }
            uint32_t locs = 0xFF;
            if (x + 4 > w) locs >>= (x + 4 - w) << 1;
            if (y + 2 > h) locs &= 0x55;
            if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
                return false;
            for (int qi = 0; qi < 2; ++qi) {
                uint32_t q = qinf[qi], u = u_q[qi];
                int cx = x + 2 * qi;
                uint32_t e;
                sample(q, 0, u, cx, y, nullptr);
                if (sample(q, 1, u, cx, y + 1, &e)) {
                    uint32_t t = lsp[0] & 0x7F;
                    lsp[0] = (uint8_t)(0x80 | std::max(t, e));
                }
                ++lsp;
                sample(q, 2, u, cx + 1, y, nullptr);
                if (initial) lsp[0] = 0;
                if (sample(q, 3, u, cx + 1, y + 1, &e))
                    lsp[0] = (uint8_t)(0x80 | e);
            }
        }
    }

    if (num_passes > 2) {
        // MagRef: bit p - 1 of each sample significant in the cleanup,
        // stripe by stripe, column by column
        RevReader mrp;
        mrp.init_mrp(coded, lcup, (int)lengths2);
        const uint32_t half = 1u << (p - 2);
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                    size_t i = (size_t)y * w + x;
                    if (!sig_at(x, y)) continue;
                    uint32_t sym = mrp.fetch() & 1;
                    mrp.advance(1);
                    dec[i] ^= (1 - sym) << (p - 1);
                    dec[i] |= half;
                }
    }
    if (num_passes > 1) {
        // SigProp: each stripe, in groups of 4 columns, one bit for each
        // insignificant sample with a significant neighbour (the cleanup's,
        // or found earlier in this pass; the stripe below only through the
        // cleanup, and not at all when stripe-causal), then the new samples'
        // signs
        FwdReader sp;
        sp.init(coded + lengths1, (int)lengths2, 0);
        const bool causal = (cblksty & 8) != 0;
        const uint32_t val = 3u << (p - 2);
        for (int y0 = 0; y0 < h; y0 += 4) {
            int y1 = std::min(y0 + 4, h);
            for (int g = 0; g < w; g += 4) {
                int news[16][2], nnew = 0;
                for (int x = g; x < std::min(g + 4, w); ++x)
                    for (int y = y0; y < y1; ++y) {
                        // each sample is visited once: its own flag is
                        // still the cleanup's
                        const uint8_t* k = &sig_at(x, y);
                        if (*k) continue;
                        const uint8_t* up = k - kw;
                        const uint8_t* down = k + kw;
                        uint8_t near = up[-1] | up[0] | up[1] | k[-1] | k[1];
                        if (!(causal && y == y0 + 3))
                            near |= down[-1] | down[0] | down[1];
                        if (!near) continue;
                        uint32_t bit = sp.fetch() & 1;
                        sp.advance(1);
                        if (bit) {
                            sig_at(x, y) = 1;
                            news[nnew][0] = y;
                            news[nnew][1] = x;
                            ++nnew;
                        }
                    }
                for (int k = 0; k < nnew; ++k) {
                    size_t i = (size_t)news[k][0] * w + news[k][1];
                    uint32_t s = sp.fetch() & 1;
                    sp.advance(1);
                    dec[i] |= (s << 31) | val;
                }
            }
        }
    }
    for (size_t i = 0; i < dec.size(); ++i) {
        int32_t v = (int32_t)(dec[i] & 0x7FFFFFFF);
        out[i] = (dec[i] & 0x80000000u) ? -v : v;
    }
    return true;
}

// ---------------------------------------------------------------------------
// inverse wavelets (dwt.c)
// ---------------------------------------------------------------------------

// ``len`` samples of ``n`` values each (a line, or rows of a block of
// columns), ``sn`` low-pass then the high-pass ones, interleaved into
// ``out`` (cas: the first sample is high-pass)
template <class T>
void interleave(const T* in, T* out, int len, int sn, int cas, int n) {
    for (int i = 0; i < len; ++i) {
        int to = i < sn ? 2 * i + cas : 2 * (i - sn) + 1 - cas;
        std::copy(in + (size_t)i * n, in + (size_t)(i + 1) * n,
                  out + (size_t)to * n);
    }
}

// the 5/3 lifting steps with symmetric extension, each of the ``n``
// values of a sample on its own
void idwt53(int32_t* a, int len, int cas, int n) {
    if (len == 1) {
        if (cas)
            for (int k = 0; k < n; ++k) a[k] /= 2;
        return;
    }
    auto nb = [&](int i) -> const int32_t* {
        if (i < 0) i = 1;
        if (i >= len) i = len - 2;
        return a + (size_t)i * n;
    };
    for (int i = cas; i < len; i += 2) {
        int32_t* x = a + (size_t)i * n;
        const int32_t *l = nb(i - 1), *r = nb(i + 1);
        for (int k = 0; k < n; ++k) x[k] -= (l[k] + r[k] + 2) >> 2;
    }
    for (int i = 1 - cas; i < len; i += 2) {
        int32_t* x = a + (size_t)i * n;
        const int32_t *l = nb(i - 1), *r = nb(i + 1);
        for (int k = 0; k < n; ++k) x[k] += (l[k] + r[k]) >> 1;
    }
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f, kK = 1.230174105f,
            kTwoInvK = 1.625732422f;

// the 9/7 steps as OpenJPEG 2.5 runs them: the scaling first (its
// 1.625732422 on the high band), then delta, gamma, beta, alpha, each
// ``x + (l + r) * c`` rounded step by step, ``x + (c + c) * o`` at an edge
void idwt97(float* a, int len, int cas, int n) {
    int sn = cas ? len / 2 : (len + 1) / 2, dn = len - sn;
    if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
    for (int i = 0; i < len; ++i) {
        float f = ((i & 1) == cas) ? kK : kTwoInvK;
        float* x = a + (size_t)i * n;
        for (int k = 0; k < n; ++k) x[k] = x[k] * f;
    }
    auto step = [&](int first, float c) {
        for (int i = first; i < len; i += 2) {
            float* x = a + (size_t)i * n;
            const float* l = i > 0 ? x - n : nullptr;
            const float* r = i + 1 < len ? x + n : nullptr;
            if (l && r) {
                for (int k = 0; k < n; ++k) x[k] = x[k] + ((l[k] + r[k]) * c);
            } else if (l || r) {
                const float* o = l ? l : r;
                for (int k = 0; k < n; ++k) x[k] = x[k] + (c + c) * o[k];
            }
        }
    };
    step(cas, -kDelta);
    step(1 - cas, -kGamma);
    step(cas, -kBeta);
    step(1 - cas, -kAlpha);
}

// the inverse transform of a tile-component, resolution by resolution:
// each row, then blocks of columns (rows of a block are contiguous)
template <class T, class F>
void idwt(TileComp& tc, T* buf, F lift) {
    const int kBlock = 32;
    uint32_t stride = tc.width();
    std::vector<T> in, out;
    for (int r = 1; r < tc.numres; ++r) {
        const Res& prev = tc.res[r - 1];
        const Res& res = tc.res[r];
        int rw = (int)(res.x1 - res.x0), rh = (int)(res.y1 - res.y0);
        int sw = (int)(prev.x1 - prev.x0), sh = (int)(prev.y1 - prev.y0);
        int casx = (int)(res.x0 & 1), casy = (int)(res.y0 & 1);
        out.resize((size_t)std::max(rw, rh * kBlock));
        in.resize((size_t)rh * kBlock);
        if (rw > 0)
            for (int j = 0; j < rh; ++j) {
                T* row = buf + (size_t)j * stride;
                interleave(row, out.data(), rw, sw, casx, 1);
                lift(out.data(), rw, casx, 1);
                std::copy(out.begin(), out.begin() + rw, row);
            }
        if (rh > 0)
            for (int i0 = 0; i0 < rw; i0 += kBlock) {
                int n = std::min(kBlock, rw - i0);
                for (int j = 0; j < rh; ++j)
                    std::copy(buf + (size_t)j * stride + i0,
                              buf + (size_t)j * stride + i0 + n,
                              in.data() + (size_t)j * n);
                interleave(in.data(), out.data(), rh, sh, casy, n);
                lift(out.data(), rh, casy, n);
                for (int j = 0; j < rh; ++j)
                    std::copy(out.data() + (size_t)j * n,
                              out.data() + (size_t)(j + 1) * n,
                              buf + (size_t)j * stride + i0);
            }
    }
}

// ---------------------------------------------------------------------------
// one tile
// ---------------------------------------------------------------------------

// OpenJPEG's int32 sum of a 5/3 sample and its DC level shift, which
// wraps (an MCO's offset may be anything); the 9/7 sum is int64
inline int64_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

void decode_tile(Codestream& cs, uint32_t tileno, int32_t* out) {
    Tcp& tcp = cs.tcps[tileno];
    std::vector<TileComp> tcs;
    uint32_t tx0, ty0, tx1, ty1;
    init_tile(cs, tcp, tileno, tcs, tx0, ty0, tx1, ty1);
    std::vector<PacketIt> order =
        packet_order(cs, tcp, tcs, tx0, ty0, tx1, ty1);
    // tier 2
    const uint8_t* src = tcp.data.data();
    size_t left = tcp.data.size();
    bool packed = cs.ppm || tcp.ppt_present;
    const uint8_t* hdr = nullptr;
    size_t hdr_left = 0;
    if (cs.ppm) {
        hdr = cs.ppm_data.data() + cs.ppm_pos;
        hdr_left = cs.ppm_data.size() - cs.ppm_pos;
    } else if (tcp.ppt_present) {
        hdr = tcp.ppt.data();
        hdr_left = tcp.ppt.size();
    }
    for (auto& pk : order) {
        size_t n = decode_packet(tcp, tcs, pk, src, left, hdr, hdr_left,
                                 packed);
        src += n;
        left -= n;
    }
    if (cs.ppm) cs.ppm_pos = cs.ppm_data.size() - hdr_left;
    // tier 1 into each tile-component's buffer
    T1 t1;
    for (size_t c = 0; c < tcs.size(); ++c) {
        TileComp& tc = tcs[c];
        const Tccp& tccp = tcp.tccps[c];
        uint32_t stride = tc.width();
        size_t size = (size_t)stride * tc.height();
        if (tccp.qmfbid == 1)
            tc.idata.assign(size, 0);
        else
            tc.fdata.assign(size, 0.0f);
        for (int r = 0; r < tc.numres; ++r) {
            for (int b = 0; b < tc.res[r].numbands; ++b) {
                const Band& band = tc.res[r].bands[b];
                for (auto& prc : band.precs) {
                    for (auto& cb : prc.cblks) {
                        bool ok;
                        if (tccp.cblksty & 0x40) {
                            t1.w = (int)(cb.x1 - cb.x0);
                            t1.h = (int)(cb.y1 - cb.y0);
                            ok = decode_ht(cb, (uint32_t)band.numbps,
                                           tccp.roishift, tccp.cblksty, t1.w,
                                           t1.h, t1.data);
                        } else {
                            ok = t1.decode(cb, band.orient, tccp.roishift,
                                           tccp.cblksty);
                        }
                        if (!ok) fail();
                        uint32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.orient & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (band.orient & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        for (int yy = 0; yy < t1.h; ++yy) {
                            size_t at = (size_t)(y + yy) * stride + x;
                            const int32_t* s = t1.data.data() + (size_t)yy * t1.w;
                            if (tccp.qmfbid == 1) {
                                int32_t* dst = tc.idata.data() + at;
                                for (int xx = 0; xx < t1.w; ++xx) dst[xx] = s[xx] / 2;
                            } else {
                                float step = 0.5f * band.stepsize;
                                float* dst = tc.fdata.data() + at;
                                for (int xx = 0; xx < t1.w; ++xx)
                                    dst[xx] = (float)s[xx] * step;
                            }
                        }
                    }
                }
            }
        }
    }
    // inverse wavelets
    for (size_t c = 0; c < tcs.size(); ++c) {
        TileComp& tc = tcs[c];
        if (tcp.tccps[c].qmfbid == 1)
            idwt(tc, tc.idata.data(), idwt53);
        else
            idwt(tc, tc.fdata.data(), idwt97);
    }
    // the multi-component transform
    if (tcp.mct && tcs.size() >= 3) {
        size_t n = (size_t)tcs[0].width() * tcs[0].height();
        for (int c = 1; c < 3; ++c)
            if ((size_t)tcs[c].width() * tcs[c].height() != n) fail();
        if (tcp.tccps[0].qmfbid == 1) {
            if (tcs[1].idata.size() != n || tcs[2].idata.size() != n) fail();
            int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(),
                    *c2 = tcs[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = y - ((u + v) >> 2);
                c0[i] = v + g;
                c1[i] = g;
                c2[i] = u + g;
            }
        } else {
            if (tcs[1].fdata.size() != n || tcs[2].fdata.size() != n) fail();
            float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(),
                  *c2 = tcs[2].fdata.data();
            for (size_t i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f);
                g = g - (v * 0.71414f);
                float b = y + (u * 1.772f);
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        }
    }
    // DC level shift and clipping, then into the image
    for (size_t c = 0; c < tcs.size(); ++c) {
        TileComp& tc = tcs[c];
        const Comp& comp = cs.comps[c];
        int64_t lo, hi;
        int32_t shift = tcp.tccps[c].dc_shift;
        if (comp.sgnd) {
            lo = -((int64_t)1 << (comp.prec - 1));
            hi = ((int64_t)1 << (comp.prec - 1)) - 1;
        } else {
            lo = 0;
            hi = ((int64_t)1 << comp.prec) - 1;
        }
        uint32_t cw = ceildiv(cs.x1, comp.dx) - ceildiv(cs.x0, comp.dx);
        uint32_t ch = ceildiv(cs.y1, comp.dy) - ceildiv(cs.y0, comp.dy);
        uint32_t ox = tc.x0 - ceildiv(cs.x0, comp.dx),
                 oy = tc.y0 - ceildiv(cs.y0, comp.dy);
        int32_t* plane = out;
        for (size_t k = 0; k < c; ++k) {
            const Comp& pc = cs.comps[k];
            plane += (size_t)(ceildiv(cs.x1, pc.dx) - ceildiv(cs.x0, pc.dx)) *
                     (ceildiv(cs.y1, pc.dy) - ceildiv(cs.y0, pc.dy));
        }
        uint32_t w = tc.width(), h = tc.height();
        for (uint32_t y = 0; y < h; ++y) {
            int32_t* dst = plane + (size_t)(oy + y) * cw + ox;
            if (oy + y >= ch) break;
            for (uint32_t x = 0; x < w; ++x) {
                int64_t v;
                if (tcp.tccps[c].qmfbid == 1) {
                    v = wrap_add(tc.idata[(size_t)y * w + x], shift);
                } else {
                    float f = tc.fdata[(size_t)y * w + x];
                    if (f > (float)INT32_MAX)
                        v = hi;
                    else if (f < (float)INT32_MIN)
                        v = lo;
                    else  // lrintf: to nearest, ties to even; an int64 sum
                        v = (int64_t)std::nearbyintf(f) + shift;
                }
                dst[x] = (int32_t)std::min(std::max(v, lo), hi);
            }
        }
    }
}

}  // namespace

extern "C" {

// The headers of a codestream, main and tile-part, read as the decode
// reads them: status (0 ok, 1 a file cv2 cannot read) and, for status 0, in ``info`` the image's x0, y0, x1, y1, its
// component count, then per component dx, dy, precision and signedness
// (after a CBD marker; at most ``max_info`` values).
int ocr_j2k_header(const uint8_t* data, int64_t len, int32_t* info,
                   int64_t max_info) {
    Codestream cs;
    cs.p = data;
    cs.len = (size_t)len;
    int status = kOk;
    try {
        parse(cs);
    } catch (const Fail& f) {
        status = f.status;
    } catch (const std::bad_alloc&) {
        status = kFail;
    }
    if (status == kFail) return kFail;
    int64_t k = 0;
    auto put = [&](int64_t v) {
        if (k < max_info) info[k] = (int32_t)v;
        ++k;
    };
    put(cs.x0);
    put(cs.y0);
    put(cs.x1);
    put(cs.y1);
    put((int64_t)cs.comps.size());
    for (auto& c : cs.comps) {
        put(c.dx);
        put(c.dy);
        put(c.prec);
        put(c.sgnd);
    }
    return status;
}

// Decode a codestream into ``out``: each component's plane (its samples
// on the reference grid's subsampled size), one after another, int32.
// Returns the status as ocr_j2k_header does.
int ocr_j2k_decode(const uint8_t* data, int64_t len, int32_t* out,
                   int64_t out_len) {
    Codestream cs;
    cs.p = data;
    cs.len = (size_t)len;
    try {
        parse(cs);
        size_t need = 0;
        for (auto& c : cs.comps)
            need += (size_t)(ceildiv(cs.x1, c.dx) - ceildiv(cs.x0, c.dx)) *
                    (ceildiv(cs.y1, c.dy) - ceildiv(cs.y0, c.dy));
        if ((int64_t)need != out_len) return kFail;
        std::fill(out, out + need, 0);
        std::vector<uint32_t> tiles;
        for (uint32_t t = 0; t < cs.tcps.size(); ++t)
            if (cs.tcps[t].seen) tiles.push_back(t);
        std::stable_sort(tiles.begin(), tiles.end(), [&](uint32_t a, uint32_t b) {
            return cs.tcps[a].order < cs.tcps[b].order;
        });
        if (tiles.empty()) return kFail;
        for (uint32_t t : tiles) decode_tile(cs, t, out);
    } catch (const Fail& f) {
        return f.status;
    } catch (const std::bad_alloc&) {
        return kFail;
    }
    return kOk;
}

}  // extern "C"
