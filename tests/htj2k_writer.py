"""A test-side HTJ2K writer (JPEG 2000 Part 15, ITU-T T.814), numpy and
Python only: raw codestreams and JPH files whose code-blocks are HT
(cleanup passes with their MEL, VLC, UVLC and MagSgn streams; SigProp and
MagRef passes on one refinement bit-plane), or Part 1 (an MQ coder with
the three coding passes) on the components a COC names, over the
reversible 5/3 or irreversible 9/7 wavelet, one or several tiles, one or
two layers, LRCP or RPCL progression.

Nothing here writes for the port in particular: a lossless file decodes in
cv2 (OpenJPEG 2.5) to its source array exactly, which proves the coder.
The CxtVLC tables (T.814 Annex C; OpenJPEG's vlc_tbl0/vlc_tbl1 decoder
tables, 1024 entries per table) are read from the port's jp2.cpp, whose
decoder keeps them as constants; this writer inverts them, and
tests/test_torch_htj2k.py holds them against cv2's own copy."""

import re
import struct
from functools import lru_cache
from pathlib import Path

import numpy as np

JP2_CPP = (Path(__file__).resolve().parents[1] / "ocr_inference_tpu_torch"
           / "native" / "jp2.cpp")
PREC, GUARD = 8, 2  # sample precision, guard bits


@lru_cache(None)
def vlc_tables():
    """The two decoder tables (first line pair, other lines) as uint16
    arrays of 1024 entries: index (context << 7) | the next 7 VLC bits;
    entry bits 0-2 the codeword length, 3 u_off, 4-7 rho, 8-11 e_1,
    12-15 e_k."""
    src = JP2_CPP.read_text()
    out = []
    for name in ("kVlcTbl0", "kVlcTbl1"):
        body = re.search(name + r"\[1024\] = \{(.*?)\};", src, re.S).group(1)
        out.append(np.array([int(v, 16) for v in re.findall(
            r"0x[0-9a-fA-F]+", body)], np.uint16))
        assert out[-1].size == 1024
    return tuple(out)


@lru_cache(None)
def vlc_codes(initial: bool):
    """context -> rho -> [(length, codeword, u_off, e_k, e_1)], shortest
    first: the codewords of one table."""
    table = vlc_tables()[0 if initial else 1]
    codes = {}
    for cq in range(8):
        seen = set()
        for i in range(128):
            e = int(table[(cq << 7) | i])
            n = e & 7
            key = (n, i & ((1 << n) - 1), (e >> 3) & 1, e >> 12,
                   (e >> 8) & 15)
            if key in seen:
                continue
            seen.add(key)
            codes.setdefault(cq, {}).setdefault((e >> 4) & 15, []).append(key)
    for per in codes.values():
        for entries in per.values():
            entries.sort()
    return codes


# ---------------------------------------------------------------------------
# bit writers of the HT streams
# ---------------------------------------------------------------------------

class _Mel:
    """The MEL coder (T.814 clause 7.3.3): runs of 0 events, its 13-state
    exponent table; bits MSB first, a 0 bit stuffed after 0xFF."""
    EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

    def __init__(self):
        self.out, self.tmp, self.left = bytearray(), 0, 8
        self.k, self.run = 0, 0

    def bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.left -= 1
        if self.left == 0:
            self.out.append(self.tmp)
            self.left = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, one):
        if not one:
            self.run += 1
            if self.run >= 1 << self.EXP[self.k]:
                self.bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self.bit(0)
            e = self.EXP[self.k]
            for t in range(e - 1, -1, -1):
                self.bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)

    def finish(self):
        if self.run:
            self.bit(1)
        if self.left < 8:  # a partial byte, or a 0 byte after 0xFF
            self.out.append((self.tmp << self.left) & 0xFF)
        return bytes(self.out)


class _Backward:
    """The VLC and MagRef streams (written from the end backward, bits LSB
    first): after a byte above 0x8F, a byte whose low 7 bits are all 1 has
    a 0 stuffed in its MSB. The VLC starts in the upper nibble of the byte
    that holds the low nibble of Scup (``nibble``)."""

    def __init__(self, nibble=False):
        self.out = bytearray()
        self.tmp, self.used = (0xF, 4) if nibble else (0, 0)
        self.last8f = True

    def bits(self, cwd, n):
        while n > 0:
            avail = 8 - self.last8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.last8f and self.tmp != 0x7F:
                    self.last8f = False
                    continue
                self.out.append(self.tmp)
                self.last8f = self.tmp > 0x8F
                self.tmp = self.used = 0

    def finish(self):
        if self.used:
            self.out.append(self.tmp)
        return bytes(reversed(self.out))


class _Forward:
    """The MagSgn and SigProp streams: bits LSB first, a byte after 0xFF
    carries 7 bits (its MSB 0). ``pad``: the last byte's unused bits."""

    def __init__(self, pad):
        self.out, self.tmp, self.used, self.max = bytearray(), 0, 0, 8
        self.pad = pad

    def bits(self, cwd, n):
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used >= self.max:
                self.out.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def finish(self):
        if self.used:
            if self.pad:
                self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            self.out.append(self.tmp)
        return bytes(self.out)


def _uvlc_prefix(u):
    """(codeword, length) of u's UVLC prefix, and (suffix, length)."""
    if u == 0:
        return (0, 0), (0, 0)
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    assert u <= 36
    return (0, 3), (u - 5, 5)


# ---------------------------------------------------------------------------
# HT block coder
# ---------------------------------------------------------------------------

def _exponent(mu):
    """E of a magnitude: the bit length of 2 (mu - 1) + 1 (0 when 0)."""
    return 0 if mu == 0 else (2 * mu - 1).bit_length()


def ht_cleanup(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """The HT cleanup segment of magnitudes ``mu`` (h, w) and signs
    ``neg``: MagSgn, then MEL, then the VLC backward, Scup in its last
    two bytes."""
    h, w = mu.shape
    mel, vlc, ms = _Mel(), _Backward(nibble=True), _Forward(pad=True)
    codes0, codes1 = vlc_codes(True), vlc_codes(False)
    # the bottom row of the quad row above: per column its E and whether it
    # is significant
    e_above = np.zeros(w + 4, np.int64)
    s_above = np.zeros(w + 4, bool)
    mu_i = mu.astype(np.int64)
    for y in range(0, h, 2):
        initial = y == 0
        e_row = np.zeros(w + 4, np.int64)
        s_row = np.zeros(w + 4, bool)
        cq_run = 0
        for x in range(0, w, 4):
            quads = []
            for qi in range(2):
                qx = x + 2 * qi
                if qx >= w:
                    quads.append(None)
                    continue
                pos = [(y, qx), (y + 1, qx), (y, qx + 1), (y + 1, qx + 1)]
                m = [int(mu_i[p]) if p[0] < h and p[1] < w else 0
                     for p in pos]
                sg = [bool(neg[p]) if p[0] < h and p[1] < w else False
                      for p in pos]
                rho = sum((m[i] > 0) << i for i in range(4))
                eq = [_exponent(v) for v in m]
                if initial:
                    cq = cq_run
                    kappa = 1
                else:
                    cq = cq_run
                    cq |= int(s_above[qx - 1] if qx else 0) | int(s_above[qx])
                    cq |= (int(s_above[qx + 1]) | int(s_above[qx + 2])) << 2
                    if rho & (rho - 1):
                        emax = max(e_above[qx - 1] if qx else 0,
                                   e_above[qx], e_above[qx + 1],
                                   e_above[qx + 2])
                        kappa = max(1, int(emax) - 1)
                    else:
                        kappa = 1
                big = max(max(eq), kappa)
                u = big - kappa if rho else 0
                emb = sum((eq[i] == big and m[i] > 0) << i for i in range(4))
                codes = codes0 if initial else codes1
                ek = 0
                if cq == 0:
                    mel.event(rho != 0)
                if rho or cq:
                    for n, cwd, uoff, e_k, e_1 in codes[cq][rho]:
                        if uoff == (u > 0) and (emb & e_k) == e_1:
                            break
                    else:
                        raise AssertionError("no VLC codeword")
                    vlc.bits(cwd, n)
                    ek = e_k
                for i in range(4):
                    if m[i]:
                        nbits = big - ((ek >> i) & 1)
                        v = 2 * (m[i] - 1) + sg[i]
                        ms.bits(v, nbits)
                if initial:
                    cq_run = (rho & 1) | ((rho >> 1) & 1) | \
                        (((rho >> 2) & 1) << 1) | (((rho >> 3) & 1) << 2)
                else:
                    cq_run = (((rho >> 2) & 1) | ((rho >> 3) & 1)) << 1
                e_row[qx] = eq[1]
                e_row[qx + 1] = eq[3]
                s_row[qx] = m[1] > 0
                s_row[qx + 1] = m[3] > 0
                quads.append(u)
            u0 = quads[0]
            u1 = quads[1] or 0
            if initial and u0 > 0 and u1 > 0:
                mel.event(min(u0, u1) > 2)
                if min(u0, u1) > 2:
                    (p0, s0), (p1, s1) = _uvlc_prefix(u0 - 2), \
                        _uvlc_prefix(u1 - 2)
                    vlc.bits(*p0)
                    vlc.bits(*p1)
                    vlc.bits(*s0)
                    vlc.bits(*s1)
                    continue
                if u0 > 2:
                    p0, s0 = _uvlc_prefix(u0)
                    vlc.bits(*p0)
                    vlc.bits(u1 - 1, 1)
                    vlc.bits(*s0)
                    continue
            (p0, s0), (p1, s1) = _uvlc_prefix(u0), _uvlc_prefix(u1)
            vlc.bits(*p0)
            vlc.bits(*p1)
            vlc.bits(*s0)
            vlc.bits(*s1)
        # line state: max of E over columns (2k - 1, 2k) is what the
        # decoder keeps; the writer keeps every column
        e_above, s_above = e_row, s_row
    magsgn = ms.finish()
    if magsgn.endswith(b"\xff"):  # the decoder fills with 0xFF
        magsgn = magsgn[:-1]
    melb = mel.finish()
    vlcb = bytearray(vlc.finish()) + b"\xff"  # the last byte: Scup >> 4
    scup = len(melb) + len(vlcb)
    assert 2 <= scup <= 4079, scup
    vlcb[-1] = scup >> 4
    vlcb[-2] = (vlcb[-2] & 0xF0) | (scup & 15)
    return magsgn + melb + bytes(vlcb)


def ht_refinement(q: np.ndarray, sig: np.ndarray, magref: bool,
                  causal: bool) -> bytes:
    """The HT refinement segment over bit-plane 0 of the magnitudes ``q``
    (signed) whose higher planes the cleanup coded, significant there
    where ``sig``: SigProp forward (each stripe of 4 rows, groups of 4
    columns: significance bits, then the signs of the new ones), then
    MagRef backward from the segment's end (bit 0 of each sample
    significant in the cleanup, stripe by stripe, column by column)."""
    h, w = q.shape
    mag = np.abs(q)
    known = sig.copy()
    sp = _Forward(pad=False)
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for g in range(0, w, 4):
            new = []
            for x in range(g, min(g + 4, w)):
                for y in range(y0, y1):
                    if sig[y, x]:
                        continue
                    ylo = y - 1
                    yhi = y + 1
                    if causal and y == y1 - 1 and y1 - y0 == 4:
                        yhi = y
                    ys = slice(max(ylo, 0), min(yhi, h - 1) + 1)
                    xs = slice(max(x - 1, 0), min(x + 1, w - 1) + 1)
                    if not known[ys, xs].any():
                        continue
                    bit = int(mag[y, x] & 1)
                    sp.bits(bit, 1)
                    if bit:
                        known[y, x] = True
                        new.append((y, x))
            for y, x in new:
                sp.bits(int(q[y, x] < 0), 1)
    spb = sp.finish()
    if spb.endswith(b"\xff"):
        spb += b"\x00"
    mr = _Backward()
    if magref:
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        mr.bits(int(mag[y, x] & 1), 1)
    return spb + mr.finish()


def ht_block(q: np.ndarray, passes: int = 1, causal: bool = False):
    """One HT code-block of quantised coefficients ``q`` (signed ints):
    (cleanup segment, refinement segment, cleanup bit-plane). One pass
    codes every plane in the cleanup; two or three put the cleanup on
    plane 1 and code plane 0 by SigProp (and MagRef). A block whose
    magnitudes are all under 2 takes the cleanup alone, on plane 0."""
    mag = np.abs(q)
    neg = q < 0
    if passes == 1 or mag.max() < 2:
        return ht_cleanup(mag, neg), b"", 0
    mu = mag >> 1
    cup = ht_cleanup(mu, neg)
    return cup, ht_refinement(q, mu > 0, passes == 3, causal), 1


# ---------------------------------------------------------------------------
# Part 1 block coder (the MQ coder and the three coding passes)
# ---------------------------------------------------------------------------

_MQ = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]
_ZC, _SC, _MAG, _AGG, _UNI = 0, 9, 14, 17, 18


class _MqEncoder:
    """The MQ coder of T.800 Annex C (OpenJPEG's mqc.c encoder)."""

    def __init__(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # the byte before the first
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[_UNI], self.state[_AGG], self.state[_ZC] = 46, 3, 4

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx, d):
        qe, nmps, nlps, sw = _MQ[self.state[cx]]
        if self.mps[cx] == d:
            self.a -= qe
            if not self.a & 0x8000:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.state[cx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] = 1 - self.mps[cx]
            self.state[cx] = nlps
            self._renorm()

    def flush(self):
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        data = bytes(self.out[1:])
        return data[:-1] if data.endswith(b"\xff") else data


def part1_block(q: np.ndarray, orient: int):
    """One Part 1 code-block (every bit-plane, one segment, no style
    bits): (data, passes, bit-planes)."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64)
    nbps = int(mag.max()).bit_length()
    sig = np.zeros((h + 2, w + 2), bool)
    neg = np.zeros((h + 2, w + 2), bool)
    visit = np.zeros((h, w), bool)
    refined = np.zeros((h, w), bool)
    mq = _MqEncoder()

    def counts(y, x):
        s = sig[y:y + 3, x:x + 3]
        hh = int(s[1, 0]) + int(s[1, 2])
        vv = int(s[0, 1]) + int(s[2, 1])
        dd = int(s[0, 0]) + int(s[0, 2]) + int(s[2, 0]) + int(s[2, 2])
        return hh, vv, dd

    def zc(y, x):
        hh, vv, dd = counts(y, x)
        if orient == 3:
            hv = hh + vv
            if not dd:
                n = 0 if not hv else 1 if hv == 1 else 2
            elif dd == 1:
                n = 3 if not hv else 4 if hv == 1 else 5
            elif dd == 2:
                n = 6 if not hv else 7
            else:
                n = 8
        else:
            if orient == 1:
                hh, vv = vv, hh
            if not hh:
                n = (0 if not dd else 1 if dd == 1 else 2) if not vv else \
                    3 if vv == 1 else 4
            elif hh == 1:
                n = (5 if not dd else 6) if not vv else 7
            else:
                n = 8
        return _ZC + n

    def contribution(y, x):
        return 0 if not sig[y, x] else -1 if neg[y, x] else 1

    def sign(y, x):
        yy, xx = y + 1, x + 1
        e, wv = contribution(yy, xx + 1), contribution(yy, xx - 1)
        nv, sv = contribution(yy - 1, xx), contribution(yy + 1, xx)
        hc = min((e > 0) + (wv > 0), 1) - min((e < 0) + (wv < 0), 1)
        vc = min((nv > 0) + (sv > 0), 1) - min((nv < 0) + (sv < 0), 1)
        spb = 0 if (not hc and not vc) else int(not (hc > 0 or
                                                     (not hc and vc > 0)))
        if hc < 0:
            hc, vc = -hc, -vc
        if not hc:
            n = 0 if vc == 0 else 1
        else:
            n = 2 if vc == -1 else 3 if vc == 0 else 4
        s = int(q[y, x] < 0)
        mq.encode(_SC + n, s ^ spb)
        sig[yy, xx] = True
        neg[yy, xx] = bool(s)

    def has_nbr(y, x):
        return sig[y:y + 3, x:x + 3].sum() - sig[y + 1, x + 1] > 0

    def scan():
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    yield y, x

    def sigpass(b):
        for y, x in scan():
            if sig[y + 1, x + 1] or visit[y, x] or not has_nbr(y, x):
                continue
            bit = int((mag[y, x] >> b) & 1)
            mq.encode(zc(y, x), bit)
            if bit:
                sign(y, x)
            visit[y, x] = True

    def refpass(b):
        for y, x in scan():
            if not sig[y + 1, x + 1] or visit[y, x]:
                continue
            cx = _MAG + 2 if refined[y, x] else \
                _MAG + 1 if has_nbr(y, x) else _MAG
            mq.encode(cx, int((mag[y, x] >> b) & 1))
            refined[y, x] = True

    def clnpass(b):
        def one(y, x):
            if sig[y + 1, x + 1] or visit[y, x]:
                visit[y, x] = False
                return
            bit = int((mag[y, x] >> b) & 1)
            mq.encode(zc(y, x), bit)
            if bit:
                sign(y, x)

        k = 0
        while k + 4 <= h:
            for x in range(w):
                busy = any(sig[y + 1, x + 1] or visit[y, x]
                           or has_nbr(y, x) for y in range(k, k + 4))
                y = k
                if not busy:
                    bits = [(mag[yy, x] >> b) & 1 for yy in range(k, k + 4)]
                    if not any(bits):
                        mq.encode(_AGG, 0)
                        continue
                    mq.encode(_AGG, 1)
                    r = bits.index(1)
                    mq.encode(_UNI, r >> 1)
                    mq.encode(_UNI, r & 1)
                    sign(k + r, x)
                    y = k + r + 1
                for yy in range(y, k + 4):
                    one(yy, x)
            k += 4
        for x in range(w):
            for y in range(k, h):
                one(y, x)

    passes = 0
    for b in range(nbps - 1, -1, -1):
        if b != nbps - 1:
            sigpass(b)
            refpass(b)
            passes += 2
        clnpass(b)
        passes += 1
    return mq.flush(), passes, nbps


# ---------------------------------------------------------------------------
# wavelets
# ---------------------------------------------------------------------------

def _reflect(i0, i1, pad):
    idx = np.arange(i0 - pad, i1 + pad)
    n = i1 - i0
    if n == 1:
        return np.zeros(idx.size, np.int64)
    period = 2 * (n - 1)
    r = np.mod(idx - i0, period)
    return np.where(r < n, r, period - r)


def fdwt53_1d(a: np.ndarray, i0: int) -> np.ndarray:
    """The reversible 5/3 along axis 0 of integer samples at absolute
    positions i0..i0 + n - 1, interleaved (low at even positions)."""
    n = a.shape[0]
    if n == 1:
        return a * 2 if i0 & 1 else a.copy()
    x = a[_reflect(i0, i0 + n, 2)].astype(np.int64)
    pos = np.arange(i0 - 2, i0 + n + 2)
    odd = (pos & 1) == 1
    y = x.copy()
    for i in np.nonzero(odd)[0]:
        if 0 < i < len(pos) - 1:
            y[i] = x[i] - ((x[i - 1] + x[i + 1]) >> 1)
    for i in np.nonzero(~odd)[0]:
        if 0 < i < len(pos) - 1:
            y[i] = x[i] + ((y[i - 1] + y[i + 1] + 2) >> 2)
    return y[2:2 + n]


_A, _B, _G, _D = -1.586134342, -0.052980118, 0.882911075, 0.443506852
_K = 1.230174105


def fdwt97_1d(a: np.ndarray, i0: int) -> np.ndarray:
    """The irreversible 9/7 along axis 0, interleaved, in OpenJPEG's
    normalisation (the inverse scales low by K and high by 2/K)."""
    n = a.shape[0]
    if n == 1:  # OpenJPEG's 9/7 leaves a lone sample as it is
        return a.astype(np.float64)
    pad = 4
    x = a[_reflect(i0, i0 + n, pad)].astype(np.float64)
    pos = np.arange(i0 - pad, i0 + n + pad)
    odd = (pos & 1) == 1
    for par, c in ((1, _A), (0, _B), (1, _G), (0, _D)):
        sel = np.nonzero(odd == bool(par))[0]
        sel = sel[(sel > 0) & (sel < len(pos) - 1)]
        x[sel] = x[sel] + c * (x[sel - 1] + x[sel + 1])
    x[~odd] /= _K
    x[odd] *= _K / 2
    return x[pad:pad + n]


def _split(a, i0, axis):
    """Low (even positions) and high (odd) halves along ``axis``."""
    first = i0 & 1
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(first, None, 2)
    low = a[tuple(sl)]
    sl[axis] = slice(1 - first, None, 2)
    return low, a[tuple(sl)]


def fdwt(x: np.ndarray, x0: int, y0: int, levels: int, reversible: bool):
    """Bands of a tile-component at (x0, y0): [LL] then per level from the
    coarsest (HL, LH, HH), each an array with its (x0, y0) band origin."""
    f = fdwt53_1d if reversible else fdwt97_1d
    bands = []
    ll = x
    for _ in range(levels):
        h, w = ll.shape
        v = f(ll, y0) if h and w else ll
        rows_lo, rows_hi = _split(v, y0, 0)
        out = []
        for part in (rows_lo, rows_hi):
            if part.shape[0] and w:
                t = f(part.T, x0).T
            else:
                t = part
            out.append(_split(t, x0, 1))
        (lo_lo, lo_hi), (hi_lo, hi_hi) = out
        bands.append((lo_hi, hi_lo, hi_hi))
        ll = lo_lo
        x0, y0 = (x0 + 1) >> 1, (y0 + 1) >> 1
    return [ll] + [b for b in reversed(bands)]


# ---------------------------------------------------------------------------
# tier 2
# ---------------------------------------------------------------------------

class _Bits:
    """Packet header bits (MSB first; a 0 bit stuffed after 0xFF)."""

    def __init__(self):
        self.out, self.tmp, self.left = bytearray(), 0, 8

    def put(self, v, n=1):
        for i in range(n - 1, -1, -1):
            self.tmp = (self.tmp << 1) | ((v >> i) & 1)
            self.left -= 1
            if self.left == 0:
                self.out.append(self.tmp)
                self.left = 7 if self.tmp == 0xFF else 8
                self.tmp = 0

    def finish(self):
        if self.left < 8:
            self.out.append((self.tmp << self.left) & 0xFF)
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    def __init__(self, w, h, values):
        self.levels = []
        vals = np.asarray(values, np.int64).reshape(h, w)
        while True:
            self.levels.append({"v": vals, "low": np.zeros_like(vals),
                                "known": np.zeros(vals.shape, bool)})
            if vals.size == 1:
                break
            hh, ww = vals.shape
            nh, nw = (hh + 1) // 2, (ww + 1) // 2
            pad = np.full((nh * 2, nw * 2), np.iinfo(np.int64).max)
            pad[:hh, :ww] = vals
            vals = pad.reshape(nh, 2, nw, 2).min(axis=(1, 3))
        self.w = w

    def encode(self, bits, leaf, threshold):
        y, x = divmod(leaf, self.w)
        path = []
        for lv in self.levels:
            path.append((lv, y, x))
            y, x = y >> 1, x >> 1
        low = 0
        for lv, y, x in reversed(path):
            if low > lv["low"][y, x]:
                lv["low"][y, x] = low
            else:
                low = int(lv["low"][y, x])
            while low < threshold:
                if low >= lv["v"][y, x]:
                    if not lv["known"][y, x]:
                        bits.put(1)
                        lv["known"][y, x] = True
                    break
                bits.put(0)
                low += 1
            lv["low"][y, x] = low


def _put_passes(bits, n):
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(3, 2)
        bits.put(n - 3, 2)
    elif n <= 36:
        bits.put(15, 4)
        bits.put(n - 6, 5)
    else:
        bits.put(0x1FF, 9)
        bits.put(n - 37, 7)


class _Block:
    """A code-block's contributions: per layer a list of (passes, segment
    lengths as OpenJPEG reads them, data)."""

    def __init__(self, zero_planes):
        self.zero_planes = zero_planes
        self.layers = {}
        self.lblock = 3
        self.included = False


def _floorlog2(n):
    return n.bit_length() - 1


def _packet(blocks_per_band, layer, bits, body):
    """One packet's header bits and body: ``blocks_per_band`` a list of
    (cw, ch, [ _Block ]) per band of the precinct."""
    any_data = any(layer in b.layers for e in blocks_per_band
                   for b in e[2])
    bits.put(int(any_data))
    if not any_data:
        return
    for cw, ch, bl, incl, imsb in blocks_per_band:
        for k, b in enumerate(bl):
            contrib = b.layers.get(layer)
            if not b.included:
                incl.encode(bits, k, layer + 1)
            else:
                bits.put(int(contrib is not None))
            if contrib is None:
                continue
            if not b.included:
                imsb.encode(bits, k, 1 << 20)
                b.included = True
            passes, segs = contrib
            _put_passes(bits, passes)
            need = 0
            for np_, data in segs:
                need = max(need, len(data).bit_length() - _floorlog2(np_))
            inc = max(0, need - b.lblock)
            bits.put((1 << (inc + 1)) - 2, inc + 1)  # inc ones, then a 0
            b.lblock += inc
            for i, (np_, data) in enumerate(segs):
                bits.put(len(data), b.lblock + _floorlog2(np_))
                body.append((data, "cleanup" if i == 0 and layer ==
                             min(b.layers) else "refinement"))


def _blocks(band, bx0, by0, cbw, cbh):
    """The code-blocks of a band (one precinct): (cw, ch, [(y, x, arr)])."""
    h, w = band.shape
    if not h or not w:
        return 0, 0, []
    cx0, cy0 = (bx0 >> cbw) << cbw, (by0 >> cbh) << cbh
    cw = -(-(bx0 + w) // (1 << cbw)) - (cx0 >> cbw)
    ch = -(-(by0 + h) // (1 << cbh)) - (cy0 >> cbh)
    out = []
    for j in range(ch):
        for i in range(cw):
            gx0 = max(cx0 + (i << cbw), bx0) - bx0
            gy0 = max(cy0 + (j << cbh), by0) - by0
            gx1 = min(cx0 + ((i + 1) << cbw), bx0 + w) - bx0
            gy1 = min(cy0 + ((j + 1) << cbh), by0 + h) - by0
            out.append(band[gy0:gy1, gx0:gx1])
    return cw, ch, out


# ---------------------------------------------------------------------------
# the codestream
# ---------------------------------------------------------------------------

def _seg(marker, payload):
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _spcod(levels, cblk, style, reversible):
    return bytes([levels, cblk[0] - 2, cblk[1] - 2, style,
                  1 if reversible else 0])


def _gains(levels):
    """log2 gain of each band in order (LL, then HL, LH, HH per level)."""
    return [0] + [1, 1, 2] * levels


def _steps(levels, reversible, step):
    """(QCD body, per-band exponents, the 9/7 step size or None)."""
    if reversible:
        eps = [PREC + g for g in _gains(levels)]
        return bytes([GUARD << 5]) + bytes(e << 3 for e in eps), eps, None
    # one step size for every band: 2^(PREC - expn) (1 + mant / 2048)
    expn = PREC - int(np.floor(np.log2(step)))
    mant = int(round((step / 2.0 ** (PREC - expn) - 1) * 2048))
    mant = min(max(mant, 0), 2047)
    real = 2.0 ** (PREC - expn) * (1 + mant / 2048)
    n = 1 + 3 * levels
    body = bytes([(GUARD << 5) | 2]) + b"".join(
        struct.pack(">H", (expn << 11) | mant) for _ in range(n))
    return body, [expn] * n, real


def htj2k_encode(samples: np.ndarray, *, levels: int = 5,
                 cblk=(6, 6), tile=None, offset=(0, 0), layers: int = 1,
                 progression: str = "LRCP", reversible: bool = True,
                 passes: int = 1, causal: bool = False, mct=None,
                 part1=(), step: float = 0.5, split: bool = False,
                 style: int = 0, hook=None, layout=None) -> bytes:
    """A raw HTJ2K codestream of (h, w) or (h, w, c) 8-bit samples.

    ``cblk`` the code-block size as (log2 width, log2 height); ``tile``
    (w, h) or None (one tile), the tile grid at the reference grid's
    origin; ``offset`` (x, y) the image's origin on the reference grid
    (inside the first tile); ``layers`` 1 or 2 (with 2, every other HT
    code-block waits for layer 1, and with ``split`` the refinement
    segment of the others comes in layer 1 as OpenJPEG 2.5 reads such a
    contribution: a zero-length addition to the cleanup segment, then the
    refinement); ``passes`` 1 (cleanup only), 2 (+ SigProp) or 3
    (+ MagRef); ``causal`` the stripe-causal style bit; ``mct`` the RCT or
    ICT (default for 3 components); ``part1`` the components coded Part 1
    through a COC; ``step`` the 9/7 quantiser step; ``style`` more
    code-block style bits for the HT components. ``hook(block)`` may
    change each HT code-block's contributions before the packets are
    written (``block.zero_planes``; ``block.layers``: layer -> (passes,
    [(passes of a segment as OpenJPEG reads it, bytes)])). ``layout``, a
    list, receives (offset in the codestream, length, "cleanup" or
    "refinement" or "part1") of each segment written."""
    x = np.asarray(samples, np.int64)
    if x.ndim == 2:
        x = x[..., None]
    h, w, nc = x.shape
    ox, oy = offset
    if mct is None:
        mct = nc >= 3
    tw, th = tile if tile else (ox + w, oy + h)
    assert ox < tw and oy < th
    ht_style = 0x40 | (8 if causal else 0) | style
    out = [b"\xff\x4f"]
    siz = struct.pack(">HIIIIIIIIH", 0x4000, ox + w, oy + h, ox, oy, tw, th,
                      0, 0, nc)
    siz += b"".join(bytes([PREC - 1, 1, 1]) for _ in range(nc))
    out.append(_seg(0xFF51, siz))
    # CAP: Part 15 (Pcap bit 15 from the MSB), Ccap15: HT only, one set
    # per block, irreversible (bit 5), MAGB
    out.append(_seg(0xFF50, struct.pack(
        ">IH", 0x00020000, (0 if reversible else 0x20) | (PREC + GUARD + 1))))
    prg = {"LRCP": 0, "RPCL": 2}[progression]
    cod = struct.pack(">BBHB", 0, prg, layers, int(mct))
    cod += _spcod(levels, cblk, ht_style, reversible)
    out.append(_seg(0xFF52, cod))
    for c in part1:
        out.append(_seg(0xFF53, bytes([c, 0]) + _spcod(levels, cblk, 0,
                                                       reversible)))
    qcd, eps, real = _steps(levels, reversible, step)
    out.append(_seg(0xFF5C, qcd))
    ntx, nty = -(-(ox + w) // tw), -(-(oy + h) // th)
    at = sum(map(len, out))
    for t in range(ntx * nty):
        tx0 = max((t % ntx) * tw, ox)
        ty0 = max((t // ntx) * th, oy)
        tx1, ty1 = min((t % ntx + 1) * tw, ox + w), min((t // ntx + 1) * th,
                                                        oy + h)
        segs = []
        body = _tile(x[ty0 - oy:ty1 - oy, tx0 - ox:tx1 - ox], tx0, ty0,
                     levels, cblk, layers, prg, reversible, passes, causal,
                     mct, part1, eps, real, split, hook, segs)
        sot = struct.pack(">HHHIBB", 0xFF90, 10, t, 12 + 2 + len(body), 0, 1)
        out.append(sot + b"\xff\x93" + body)
        if layout is not None:
            layout.extend((at + 14 + o, n, k) for o, n, k in segs)
        at += len(out[-1])
    out.append(b"\xff\xd9")
    return b"".join(out)


def _tile(x, tx0, ty0, levels, cblk, layers, prg, reversible, passes,
          causal, mct, part1, eps, real, split, hook, segs):
    h, w, nc = x.shape
    comps = [(x[..., c] - (1 << (PREC - 1))) for c in range(nc)]
    if mct:
        r, g, b = comps[:3]
        if reversible:
            comps[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
        else:
            r, g, b = (v.astype(np.float64) for v in (r, g, b))
            comps[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                         -0.16875 * r - 0.33126 * g + 0.5 * b,
                         0.5 * r - 0.41869 * g - 0.08131 * b]
    # per component, per resolution: the precinct's bands as
    # (cw, ch, blocks, inclusion tree, zero bit-plane tree)
    res = []
    counter = 0
    for c in range(nc):
        bands = fdwt(comps[c], tx0, ty0, levels, reversible)
        per_res = []
        for r in range(levels + 1):
            lv = max(levels - r + 1, 1)
            entries = []
            names = [0] if r == 0 else [1, 2, 3]
            arrs = [bands[0]] if r == 0 else list(bands[r])
            for bi, (orient, arr) in enumerate(zip(names, arrs)):
                if r == 0:
                    bx0 = -(-tx0 // (1 << levels))
                    by0 = -(-ty0 // (1 << levels))
                else:
                    ox, oy = orient & 1, orient >> 1
                    bx0 = max(0, -(-(tx0 - (ox << (lv - 1))) // (1 << lv)))
                    by0 = max(0, -(-(ty0 - (oy << (lv - 1))) // (1 << lv)))
                band_index = 0 if r == 0 else 3 * (r - 1) + bi + 1
                mb = eps[band_index] + GUARD - 1
                cw, ch, arrs_b = _blocks(arr, bx0, by0, cblk[0], cblk[1])
                blocks = []
                for a in arrs_b:
                    if reversible:
                        q = a.astype(np.int64)
                    else:
                        q = (np.sign(a) * np.floor(np.abs(a) / real)
                             ).astype(np.int64)
                    blk = _block(q, c in part1, orient, mb, passes, causal,
                                 layers, counter, split)
                    if hook is not None and c not in part1 and blk.layers:
                        hook(blk)
                    counter += 1
                    blocks.append(blk)
                values_incl = [min(b.layers) if b.layers else layers + 5
                               for b in blocks]
                values_msb = [b.zero_planes for b in blocks]
                entries.append((cw, ch, blocks,
                                _TagTree(cw, ch, values_incl) if cw else None,
                                _TagTree(cw, ch, values_msb) if cw else None))
            per_res.append(entries)
        res.append(per_res)
    order = []
    if prg == 0:
        for lay in range(layers):
            for r in range(levels + 1):
                for c in range(nc):
                    order.append((lay, r, c))
    else:  # RPCL: one precinct a resolution, every component alike
        for r in range(levels + 1):
            for c in range(nc):
                for lay in range(layers):
                    order.append((lay, r, c))
    data = []
    at = 0
    for lay, r, c in order:
        sh = levels - r  # a resolution of no samples has no packets
        if -(-tx0 // (1 << sh)) == -(-(tx0 + w) // (1 << sh)) or \
                -(-ty0 // (1 << sh)) == -(-(ty0 + h) // (1 << sh)):
            continue
        bits = _Bits()
        body = []
        entries = [e for e in res[c][r] if e[0]]
        _packet(entries, lay, bits, body)
        data.append(bits.finish())
        at += len(data[-1])
        for chunk, kind in body:
            segs.append((at, len(chunk), "part1" if c in part1 else kind))
            data.append(chunk)
            at += len(chunk)
    return b"".join(data)


def _block(q, is_part1, orient, mb, passes, causal, layers, counter, split):
    if not q.size or not q.any():
        return _Block(0)
    if is_part1:
        data, npass, nbps = part1_block(q, orient)
        blk = _Block(mb - nbps)
        blk.layers[0] = (npass, [(npass, data)])
        return blk
    cup, ref, plane = ht_block(q, passes, causal)
    blk = _Block(mb - 1 - plane)
    assert blk.zero_planes >= 0
    first = 1 if layers == 2 and counter % 2 else 0
    if not ref:
        blk.layers[first] = (1, [(1, cup)])
    elif split and layers == 2 and first == 0:
        blk.layers[0] = (1, [(1, cup)])
        # OpenJPEG 2.5 reads the next contribution to the cleanup segment
        # (one pass, zero bytes here), then the rest as the refinement
        blk.layers[1] = (passes - 1, [(1, b""), (passes - 2, ref)]
                         if passes > 2 else [(1, ref)])
    else:
        blk.layers[first] = (passes, [(1, cup), (passes - 1, ref)])
    return blk


# ---------------------------------------------------------------------------
# JPH files
# ---------------------------------------------------------------------------

JP2_SIGNATURE_BOX = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def jph_file(codestream: bytes, h: int, w: int, nc: int, colr=("enum", 16),
             brand: bytes = b"jph ", bpc: int = 7) -> bytes:
    """A JPH file (T.814 Annex D): the signature box, ftyp of brand
    ``brand``, jp2h (ihdr, colr as ("enum", EnumCS), ("cicp", primaries,
    transfer, matrix, full range): method 5, or None), jp2c."""
    body = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    if colr is not None:
        if colr[0] == "enum":
            body += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr[1]))
        else:
            _, cp, tc, mc, full = colr
            body += _box(b"colr", struct.pack(">BBBHHHB", 5, 0, 0, cp, tc,
                                              mc, full << 7))
    return (JP2_SIGNATURE_BOX + _box(b"ftyp", brand + b"\0\0\0\0" + brand)
            + _box(b"jp2h", body) + _box(b"jp2c", codestream))
