// First-party host geometry library: contour extraction and polygon
// analysis for binary line masks.
//
// The reference delegates all contour topology to OpenCV
// (reference: BDRC/line_detection.py:33-44 findContours RETR_LIST +
// CHAIN_APPROX_SIMPLE, minAreaRect/convexHull/boundingRect call sites
// throughout). This library provides the framework's own native
// implementation of that capability behind a C ABI consumed via ctypes:
//
//  - connected-components labeling (8-connectivity, BFS) + Moore
//    border tracing with Jacob's stopping criterion (one outer contour per
//    component; hole borders are dropped — they carry no information for
//    the line pipeline) and direction-change point compression
//    (CHAIN_APPROX_SIMPLE-style);
//  - shoelace contour area;
//  - Andrew monotone-chain convex hull;
//  - rotating-calipers minimum-area rectangle;
//  - filled-contour rasterization with cv2.drawContours(..., -1, v, -1)
//    semantics (ocr_fill_contour, at the end of this file).
//
// Build: g++ -O3 -shared -fPIC geometry.cpp -o libocr_geometry.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

// 16-bit "byte is nonzero" mask of 16 contiguous bytes at p.
#if defined(__SSE2__)
static inline uint32_t nz16(const uint8_t* p) {
    __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
    uint32_t z = (uint32_t)_mm_movemask_epi8(
        _mm_cmpeq_epi8(v, _mm_setzero_si128()));
    return (~z) & 0xFFFFu;
}
#endif

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

namespace {

struct Point {
    int32_t x;
    int32_t y;
};

// 8-neighborhood in Suzuki-Abe index order: counterclockwise from east in
// the paper's (row i down, column j right) convention. DROW/DCOL are the
// (di, dj) deltas for indices 0..7: E, NE, N, NW, W, SW, S, SE.
static const int DROW[8] = {0, -1, -1, -1, 0, 1, 1, 1};
static const int DCOL[8] = {1, 1, 0, -1, -1, -1, 0, 1};

static inline int dir_index(int di, int dj) {
    for (int d = 0; d < 8; ++d)
        if (DROW[d] == di && DCOL[d] == dj) return d;
    return 0;  // unreachable for valid neighbor deltas
}

// Suzuki-Abe border following (Suzuki & Abe 1985) — the algorithm behind
// cv2.findContours. Follows ONE border (outer or hole) starting at (i, j)
// with initial probe pixel (i2, j2), marking the label image F, and
// records the visited border pixels in cv2's traversal order. Returns the
// point sequence byte-identical to cv2's (RETR_LIST traversal order and
// orientation), pinned by tests/test_reference_diff.py.
// F is an int8 label image: 0 background, 1 unvisited foreground, 2 any
// positively-marked border, -1 any negatively-marked border. Suzuki-Abe
// proper labels borders with distinct NBD values, but RETR_LIST emits no
// hierarchy and every condition in this file tests only f==0 / f==1 /
// f>=1 / sign — so collapsing all positive marks to 2 and negative marks
// to -1 is exactly equivalent while moving 4x less label memory (the
// full-page label fill+scan dominates find_contours wall time).
static void follow_border(std::vector<int8_t>& F, int h, int w, int i,
                          int j, int i2, int j2, int32_t nbd,
                          std::vector<Point>& contour) {
    auto at = [&](int r, int c) -> int32_t {
        return (r >= 0 && r < h && c >= 0 && c < w) ? F[(size_t)r * w + c]
                                                    : 0;
    };
    contour.push_back({j, i});

    // step 3.1: clockwise scan around (i, j) starting at (i2, j2)
    int dir = dir_index(i2 - i, j2 - j);
    int i1 = -1, j1 = -1;
    for (int k = 0; k < 8; ++k) {
        int d = (dir - k + 8) % 8;  // clockwise = decreasing index
        if (at(i + DROW[d], j + DCOL[d]) != 0) {
            i1 = i + DROW[d];
            j1 = j + DCOL[d];
            break;
        }
    }
    if (i1 < 0) {  // isolated pixel
        F[(size_t)i * w + j] = -1;
        return;
    }

    // step 3.2
    i2 = i1;
    j2 = j1;
    int i3 = i, j3 = j;

    size_t guard = (size_t)8 * h * w + 64;
    while (guard--) {
        // step 3.3: counterclockwise scan around (i3, j3) starting just
        // after (i2, j2)
        dir = dir_index(i2 - i3, j2 - j3);
        int i4 = -1, j4 = -1;
        bool east_examined_zero = false;
        for (int k = 1; k <= 8; ++k) {
            int d = (dir + k) % 8;  // counterclockwise = increasing index
            int r = i3 + DROW[d], c = j3 + DCOL[d];
            if (at(r, c) != 0) {
                i4 = r;
                j4 = c;
                break;
            }
            if (d == 0) east_examined_zero = true;  // (i3, j3+1) was 0
        }
        // step 3.4: mark the current border pixel
        int8_t& f3 = F[(size_t)i3 * w + j3];
        if (east_examined_zero)
            f3 = -1;
        else if (f3 == 1)
            f3 = 2;
        // step 3.5: closing condition
        if (i4 == i && j4 == j && i3 == i1 && j3 == j1) return;
        i2 = i3;
        j2 = j3;
        i3 = i4;
        j3 = j4;
        contour.push_back({j4, i4});
    }
}

// Compress a contour: keep only direction changes (CHAIN_APPROX_SIMPLE).
static void compress(const std::vector<Point>& in, std::vector<Point>& out) {
    size_t n = in.size();
    if (n <= 2) { out = in; return; }
    out.clear();
    for (size_t i = 0; i < n; ++i) {
        const Point& p0 = in[(i + n - 1) % n];
        const Point& p1 = in[i];
        const Point& p2 = in[(i + 1) % n];
        int dx1 = p1.x - p0.x, dy1 = p1.y - p0.y;
        int dx2 = p2.x - p1.x, dy2 = p2.y - p1.y;
        if (dx1 != dx2 || dy1 != dy2) out.push_back(p1);
    }
    if (out.empty()) out.push_back(in[0]);
}


// ---- cv2.convexHull parity (Sklansky '82 as OpenCV implements it) ----

static inline int cv_sign_ll(long long x) { return (x > 0) - (x < 0); }

// One Sklansky scan over the (x,y)-sorted pointer order, positions
// [start..end] inclusive (direction from the sign of end-start). Writes
// positions (indices into the sorted order) into stack; returns count.
static int sklansky_scan(const Point* const* arr, int start, int end,
                         int* stack, int nsign, int sign2) {
    int incr = end > start ? 1 : -1;
    int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
    int stacksize = 3;
    if (start == end ||
        (arr[start]->x == arr[end]->x && arr[start]->y == arr[end]->y)) {
        stack[0] = start;
        return 1;
    }
    stack[0] = pprev;
    stack[1] = pcur;
    stack[2] = pnext;
    end += incr;
    while (pnext != end) {
        int cury = arr[pcur]->y;
        int nexty = arr[pnext]->y;
        int by = nexty - cury;
        if (((by > 0) - (by < 0)) != nsign) {
            long long ax = arr[pcur]->x - arr[pprev]->x;
            long long bx = arr[pnext]->x - arr[pcur]->x;
            long long ay = (long long)cury - arr[pprev]->y;
            long long convexity = ay * bx - ax * (long long)by;
            if (cv_sign_ll(convexity) == sign2 && (ax != 0 || ay != 0)) {
                pprev = pcur;
                pcur = pnext;
                pnext += incr;
                stack[stacksize] = pnext;
                stacksize++;
            } else {
                if (pprev == start) {
                    pcur = pnext;
                    stack[1] = pcur;
                    pnext += incr;
                    stack[2] = pnext;
                } else {
                    stack[stacksize - 2] = pnext;
                    pcur = pprev;
                    pprev = stack[stacksize - 4];
                    stacksize--;
                }
            }
        } else {
            pnext += incr;
            stack[stacksize - 1] = pnext;
        }
    }
    return --stacksize;
}

// Full cv2.convexHull replication for integer points: sorted-pointer
// Sklansky upper/lower half-hulls, the collinear-input special case, and
// the final rotate-to-ascending/descending-index pass. Returns hull size,
// writing ORIGINAL point indices into out_idx.
static int cv2_hull_indices(const Point* pts, int n, int clockwise,
                            int* out_idx) {
    if (n <= 0) return 0;
    std::vector<const Point*> pointer(n);
    for (int i = 0; i < n; ++i) pointer[i] = &pts[i];
    std::sort(pointer.begin(), pointer.end(),
              [](const Point* a, const Point* b) {
                  return a->x < b->x || (a->x == b->x && a->y < b->y);
              });
    int nout = 0;
    if (pointer[0]->x == pointer[n - 1]->x &&
        pointer[0]->y == pointer[n - 1]->y) {
        out_idx[nout++] = (int)(pointer[0] - pts);
        return nout;
    }
    std::vector<int> stackbuf(2 * (size_t)(n + 4));
    int* stack = stackbuf.data();

    int* tl_stack = stack;
    int tl_count = sklansky_scan(pointer.data(), 0, n - 1, tl_stack, -1, 1);
    int* tr_stack = stack + tl_count;
    int tr_count = sklansky_scan(pointer.data(), n - 1, 0, tr_stack, -1, -1);
    if (!clockwise) {
        std::swap(tl_stack, tr_stack);
        std::swap(tl_count, tr_count);
    }
    for (int i = 0; i < tl_count - 1; ++i)
        out_idx[nout++] = (int)(pointer[tl_stack[i]] - pts);
    for (int i = tr_count - 1; i > 0; --i)
        out_idx[nout++] = (int)(pointer[tr_stack[i]] - pts);
    int stop_idx = tr_count > 2 ? tr_stack[1]
                   : tl_count > 2 ? tl_stack[tl_count - 2]
                                  : -1;

    int* bl_stack = stack;
    int bl_count = sklansky_scan(pointer.data(), 0, n - 1, bl_stack, 1, -1);
    int* br_stack = stack + bl_count;
    int br_count = sklansky_scan(pointer.data(), n - 1, 0, br_stack, 1, 1);
    if (clockwise) {
        std::swap(bl_stack, br_stack);
        std::swap(bl_count, br_count);
    }
    if (stop_idx >= 0) {
        int check_idx = bl_count > 2 ? bl_stack[1]
                        : bl_count + br_count > 2 ? br_stack[2 - bl_count]
                                                  : -1;
        if (check_idx == stop_idx ||
            (check_idx >= 0 &&
             pointer[check_idx]->x == pointer[stop_idx]->x &&
             pointer[check_idx]->y == pointer[stop_idx]->y)) {
            // all points on one line: bottom hull mirrors the top
            bl_count = bl_count < 2 ? bl_count : 2;
            br_count = br_count < 2 ? br_count : 2;
        }
    }
    for (int i = 0; i < bl_count - 1; ++i)
        out_idx[nout++] = (int)(pointer[bl_stack[i]] - pts);
    for (int i = br_count - 1; i > 0; --i)
        out_idx[nout++] = (int)(pointer[br_stack[i]] - pts);

    // drop consecutive duplicate vertices (incl. the wrap-around pair):
    // the chain-junction bookkeeping above can emit a junction vertex
    // twice; a convex hull never legitimately repeats a vertex, and with
    // this dedup the output matches cv2.convexHull vertex-for-vertex
    // (pinned empirically over tens of thousands of random point sets)
    {
        int m = 0;
        for (int i = 0; i < nout; ++i) {
            const Point& cur = pts[out_idx[i]];
            const Point& prv = pts[out_idx[(i + nout - 1) % nout]];
            if (i > 0 && cur.x == prv.x && cur.y == prv.y) continue;
            out_idx[m++] = out_idx[i];
        }
        if (m > 1) {
            const Point& a = pts[out_idx[0]];
            const Point& b = pts[out_idx[m - 1]];
            if (a.x == b.x && a.y == b.y) --m;
        }
        nout = m;
    }

    // a hull never visits a vertex twice: drop any later re-occurrence of
    // an already-emitted vertex (tiny-n chain bookkeeping can re-emit one
    // non-consecutively, which the consecutive dedup above cannot see)
    {
        int m = 0;
        for (int i = 0; i < nout; ++i) {
            bool seen = false;
            for (int j = 0; j < m; ++j)
                if (pts[out_idx[j]].x == pts[out_idx[i]].x &&
                    pts[out_idx[j]].y == pts[out_idx[i]].y) {
                    seen = true;
                    break;
                }
            if (!seen) out_idx[m++] = out_idx[i];
        }
        nout = m;
    }

    // enforce convexity: a provisional Sklansky candidate (a window the
    // scan slid past without ever validating) can survive in a length-2
    // chain; such a point is strictly interior and shows up as a
    // wrong-orientation turn. Remove wrong-side vertices to a fixpoint —
    // this can only delete non-hull points (cv2's own output is strictly
    // convex), and with it the output matches cv2.convexHull exactly on
    // large randomized samples.
    if (nout >= 4) {
        // polygon orientation from the signed area
        long long area2 = 0;
        for (int i = 0; i < nout; ++i) {
            const Point& a = pts[out_idx[i]];
            const Point& b = pts[out_idx[(i + 1) % nout]];
            area2 += (long long)a.x * b.y - (long long)b.x * a.y;
        }
        int orient = (area2 > 0) - (area2 < 0);
        bool changed = orient != 0;
        while (changed && nout >= 4) {
            changed = false;
            for (int i = 0; i < nout && nout >= 4; ++i) {
                const Point& a = pts[out_idx[(i + nout - 1) % nout]];
                const Point& b = pts[out_idx[i]];
                const Point& c = pts[out_idx[(i + 1) % nout]];
                long long cross =
                    (long long)(b.x - a.x) * (c.y - a.y) -
                    (long long)(b.y - a.y) * (c.x - a.x);
                if (cross != 0 && ((cross > 0) - (cross < 0)) != orient) {
                    for (int j = i; j + 1 < nout; ++j)
                        out_idx[j] = out_idx[j + 1];
                    --nout;
                    --i;
                    changed = true;
                }
            }
        }
    }

    // rotate so hull indices form an ascending/descending run when the
    // input was already a convex polygon (cv2's stabilization pass)
    if (nout >= 3) {
        int min_idx = 0, max_idx = 0, lt = 0;
        for (int i = 1; i < nout; ++i) {
            int idx = out_idx[i];
            lt += out_idx[i - 1] < idx;
            if (out_idx[min_idx] > idx) min_idx = i;
            if (out_idx[max_idx] < idx) max_idx = i;
        }
        int mmdist = max_idx - min_idx;
        if (mmdist < 0) mmdist = -mmdist;
        if ((mmdist == 1 || mmdist == nout - 1) &&
            (lt <= 1 || lt >= nout - 2)) {
            int ascending = (max_idx + 1) % nout == min_idx;
            int i0 = ascending ? min_idx : max_idx, j = i0;
            if (i0 > 0) {
                int i;
                for (i = 0; i < nout; ++i) {
                    int curr_idx = stack[i] = out_idx[j];
                    int next_j = j + 1 < nout ? j + 1 : 0;
                    int next_idx = out_idx[next_j];
                    if (i < nout - 1 &&
                        ((ascending != 0) != (curr_idx < next_idx)))
                        break;
                    j = next_j;
                }
                if (i == nout)
                    std::memcpy(out_idx, stack, nout * sizeof(out_idx[0]));
            }
        }
    }
    return nout;
}

}  // namespace

extern "C" {

// cv2.findContours(RETR_LIST, CHAIN_APPROX_SIMPLE) parity: Suzuki-Abe
// border following emitting BOTH outer and hole borders in raster
// discovery order, compressed to direction changes. Points are written as
// x,y pairs into out_points with per-contour offsets (prefix sums,
// n_contours+1 entries) in out_offsets. Returns the number of contours, or
// -1 (points overflow) / -2 (contour count overflow).
int ocr_find_contours(const uint8_t* mask, int h, int w,
                      int32_t* out_points, int64_t max_points,
                      int64_t* out_offsets, int max_contours) {
    std::vector<int8_t> F((size_t)h * w, 0);
    for (size_t p = 0; p < (size_t)h * w; ++p) F[p] = mask[p] ? 1 : 0;

    int n_contours = 0;
    int64_t cursor = 0;
    int32_t nbd = 1;
    std::vector<Point> contour, packed;

    for (int i = 0; i < h; ++i) {
        const int8_t* Frow = F.data() + (size_t)i * w;
        for (int j = 0; j < w; ++j) {
            // the raster discovery scan dominates wall time on sparse
            // pages: hop zero runs a word at a time (exact — only f==0
            // pixels are skipped, and they take no branch below)
            if (Frow[j] == 0) {
                ++j;
                while (j + 8 <= w) {
                    uint64_t blk;
                    std::memcpy(&blk, Frow + j, 8);
                    if (blk) break;
                    j += 8;
                }
                while (j < w && Frow[j] == 0) ++j;
                if (j >= w) break;
            }
            int32_t f = Frow[j];
            bool outer = (f == 1) && (j == 0 || F[(size_t)i * w + j - 1] == 0);
            bool hole =
                (f >= 1) && (j == w - 1 || F[(size_t)i * w + j + 1] == 0);
            if (!outer && !hole) continue;
            ++nbd;
            int i2 = i, j2 = outer ? j - 1 : j + 1;
            contour.clear();
            follow_border(F, h, w, i, j, i2, j2, nbd, contour);
            compress(contour, packed);
            if (n_contours >= max_contours) return -2;
            if (cursor + (int64_t)packed.size() * 2 > max_points) return -1;
            out_offsets[n_contours] = cursor / 2;
            for (const Point& p : packed) {
                out_points[cursor++] = p.x;
                out_points[cursor++] = p.y;
            }
            ++n_contours;
        }
    }
    out_offsets[n_contours] = cursor / 2;
    return n_contours;
}

double ocr_contour_area(const int32_t* points, int n) {
    double area = 0.0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        double x1 = points[2 * i], y1 = points[2 * i + 1];
        double x2 = points[2 * j], y2 = points[2 * j + 1];
        area += x1 * y2 - x2 * y1;
    }
    return std::fabs(area) * 0.5;
}

void ocr_bounding_rect(const int32_t* points, int n, int32_t* out_xywh) {
    int32_t minx = points[0], maxx = points[0];
    int32_t miny = points[1], maxy = points[1];
    for (int i = 1; i < n; ++i) {
        minx = std::min(minx, points[2 * i]);
        maxx = std::max(maxx, points[2 * i]);
        miny = std::min(miny, points[2 * i + 1]);
        maxy = std::max(maxy, points[2 * i + 1]);
    }
    out_xywh[0] = minx;
    out_xywh[1] = miny;
    out_xywh[2] = maxx - minx + 1;
    out_xywh[3] = maxy - miny + 1;
}

// Andrew monotone chain; returns hull size, writes x,y pairs (counter-
// clockwise in image coordinates).
int ocr_convex_hull(const int32_t* points, int n, int32_t* out_points) {
    std::vector<Point> pts(n);
    for (int i = 0; i < n; ++i) pts[i] = {points[2 * i], points[2 * i + 1]};
    std::vector<int> idx(4 * (size_t)n + 8);
    int k = cv2_hull_indices(pts.data(), n, /*clockwise=*/0, idx.data());
    for (int i = 0; i < k; ++i) {
        out_points[2 * i] = pts[idx[i]].x;
        out_points[2 * i + 1] = pts[idx[i]].y;
    }
    return k;
}

double ocr_arc_length(const int32_t* points, int n, int closed) {
    if (n < 2) return 0.0;
    double total = 0.0;
    int last = closed ? n : n - 1;
    for (int i = 0; i < last; ++i) {
        int j = (i + 1) % n;
        // cv2.arcLength does the whole per-segment computation in float32
        // (deltas AND sqrt), accumulating the float32 results into a
        // double; replicated so epsilon = f(arcLength) feeds approxPolyDP
        // with bit-identical values
        float dx = (float)(points[2 * j] - points[2 * i]);
        float dy = (float)(points[2 * j + 1] - points[2 * i + 1]);
        total += (double)sqrtf(dx * dx + dy * dy);
    }
    return total;
}

// Polygon simplification mirroring OpenCV's approxPolyDP_ exactly
// (modules/imgproc/src/approx.cpp): squared-epsilon cross-product tests,
// the 3-iteration approximate-farthest-point initialization for closed
// curves (which also fixes the output's starting vertex), an explicit
// slice stack, and the final extra-point cleanup pass over [almost]
// straight runs. Byte-parity with cv2.approxPolyDP is pinned by
// tests/test_reference_diff.py and tests/test_geometry_backend.py.
int ocr_approx_poly_dp(const int32_t* points, int n, double epsilon,
                       int closed, int32_t* out_points) {
    if (n <= 0) return 0;
    std::vector<Point> src(n), dst((size_t)n + 1);
    for (int i = 0; i < n; ++i) src[i] = {points[2 * i], points[2 * i + 1]};

    struct Slice { int start, end; };
    std::vector<Slice> stack;
    stack.reserve((size_t)n + 4);
    int count = n, new_count = 0, pos = 0;
    bool le_eps = false;
    double eps = epsilon * epsilon;
    Point start_pt{-1000000, -1000000}, end_pt{0, 0}, pt{0, 0};
    Slice slice{0, 0}, right_slice{0, 0};

    auto read_src = [&](Point& p, int& position) {
        p = src[position];
        if (++position >= count) position = 0;
    };

    if (closed) {
        // 1. find two approximately-farthest points (3 iterations)
        right_slice.start = 0;
        for (int i = 0; i < 3; ++i) {
            double max_dist = 0;
            pos = (pos + right_slice.start) % count;
            read_src(start_pt, pos);
            for (int j = 1; j < count; ++j) {
                read_src(pt, pos);
                double dx = pt.x - start_pt.x, dy = pt.y - start_pt.y;
                double dist = dx * dx + dy * dy;
                if (dist > max_dist) {
                    max_dist = dist;
                    right_slice.start = j;
                }
            }
            le_eps = max_dist <= eps;
        }
        // 2. initialize the stack
        if (!le_eps) {
            right_slice.end = slice.start = pos % count;
            slice.end = right_slice.start =
                (right_slice.start + slice.start) % count;
            stack.push_back(right_slice);
            stack.push_back(slice);
        } else {
            dst[new_count++] = start_pt;
        }
    } else {
        slice.start = 0;
        slice.end = count - 1;
        stack.push_back(slice);
    }

    // 3. recursive (explicit-stack) Douglas-Peucker over the slices
    while (!stack.empty()) {
        slice = stack.back();
        stack.pop_back();
        end_pt = src[slice.end];
        pos = slice.start;
        read_src(start_pt, pos);
        if (pos != slice.end) {
            double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y;
            double max_dist = 0;
            while (pos != slice.end) {
                read_src(pt, pos);
                double dist = std::fabs((pt.y - start_pt.y) * dx -
                                        (pt.x - start_pt.x) * dy);
                if (dist > max_dist) {
                    max_dist = dist;
                    right_slice.start = (pos + count - 1) % count;
                }
            }
            le_eps = max_dist * max_dist <= eps * (dx * dx + dy * dy);
        } else {
            le_eps = true;
            start_pt = src[slice.start];
        }
        if (le_eps) {
            dst[new_count++] = start_pt;
        } else {
            right_slice.end = slice.end;
            slice.end = right_slice.start;
            stack.push_back(right_slice);
            stack.push_back(slice);
        }
    }

    if (!closed) dst[new_count++] = src[count - 1];

    // 4. cleanup: drop extra points on [almost] straight runs
    count = new_count;
    pos = closed ? count - 1 : 0;
    auto read_dst = [&](Point& p, int& position) {
        p = dst[position];
        if (++position >= count) position = 0;
    };
    read_dst(start_pt, pos);
    int wpos = pos;
    read_dst(pt, pos);
    int not_closed = closed ? 0 : 1;
    for (int i = not_closed; i < count - not_closed && new_count > 2; ++i) {
        read_dst(end_pt, pos);
        double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y;
        double dist = std::fabs((pt.x - start_pt.x) * dy -
                                (pt.y - start_pt.y) * dx);
        double successive =
            (double)(pt.x - start_pt.x) * (end_pt.x - pt.x) +
            (double)(pt.y - start_pt.y) * (end_pt.y - pt.y);
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) && dx != 0 &&
            dy != 0 && successive >= 0) {
            new_count--;
            dst[wpos] = start_pt = end_pt;
            if (++wpos >= count) wpos = 0;
            read_dst(pt, pos);
            ++i;
            continue;
        }
        dst[wpos] = start_pt = pt;
        if (++wpos >= count) wpos = 0;
        pt = end_pt;
    }
    if (!closed) dst[wpos] = pt;

    for (int i = 0; i < new_count; ++i) {
        out_points[2 * i] = dst[i].x;
        out_points[2 * i + 1] = dst[i].y;
    }
    return new_count;
}

// cv2.minAreaRect parity: rotating calipers in float32 over the CLOCKWISE
// convex hull, replicating OpenCV's icvRotatingCalipers arithmetic
// (modules/imgproc/src/rotcalipers.cpp) operation for operation — cv2
// computes in float32, so landing on its exact values (including the
// int-truncation behavior of downstream consumers) requires the same
// precision and accumulation order. Writes cx, cy, w, h, angle_deg.
void ocr_min_area_rect(const int32_t* points, int n, double* out5) {
    // cv2.minAreaRect builds the CLOCKWISE hull (convexHull(pts, true))
    // and runs calipers over it in float32
    std::vector<Point> ptv(n);
    for (int i = 0; i < n; ++i) ptv[i] = {points[2 * i], points[2 * i + 1]};
    std::vector<int> hidx(4 * (size_t)n + 8);
    int hn = cv2_hull_indices(ptv.data(), n, /*clockwise=*/1, hidx.data());
    if (hn == 0) {
        out5[0] = out5[1] = out5[2] = out5[3] = out5[4] = 0;
        return;
    }
    std::vector<float> hx(hn), hy(hn);
    for (int i = 0; i < hn; ++i) {
        hx[i] = (float)ptv[hidx[i]].x;
        hy[i] = (float)ptv[hidx[i]].y;
    }

    float angle_deg;
    if (hn == 1) {
        out5[0] = hx[0];
        out5[1] = hy[0];
        out5[2] = out5[3] = 0;
        out5[4] = -90.0;  // cv2 5.x normalized convention, single point
        return;
    }
    if (hn == 2) {
        out5[0] = (hx[0] + hx[1]) * 0.5f;
        out5[1] = (hy[0] + hy[1]) * 0.5f;
        double dx = hx[1] - hx[0], dy = hy[1] - hy[0];
        float w2 = (float)std::sqrt(dx * dx + dy * dy);
        float h2 = 0.f;
        angle_deg = (float)((float)std::atan2(dy, dx) * 180.0 / M_PI);
        while (angle_deg >= 0.f) {
            angle_deg -= 90.f;
            float t = w2; w2 = h2; h2 = t;
        }
        while (angle_deg < -90.f) {
            angle_deg += 90.f;
            float t = w2; w2 = h2; h2 = t;
        }
        out5[2] = w2;
        out5[3] = h2;
        out5[4] = angle_deg;
        return;
    }

    // --- icvRotatingCalipers(points, n, CALIPERS_MINAREA, out) ---
    std::vector<float> inv_vect_length(hn);
    std::vector<float> vx(hn), vy(hn);
    int left = 0, bottom = 0, right = 0, top = 0;
    float left_x, right_x, top_y, bottom_y;
    float p0x = hx[0], p0y = hy[0];
    left_x = right_x = p0x;
    top_y = bottom_y = p0y;
    for (int i = 0; i < hn; ++i) {
        if (p0x < left_x) { left_x = p0x; left = i; }
        if (p0x > right_x) { right_x = p0x; right = i; }
        if (p0y > top_y) { top_y = p0y; top = i; }
        if (p0y < bottom_y) { bottom_y = p0y; bottom = i; }
        int nxt = (i + 1 < hn) ? i + 1 : 0;
        double dx = hx[nxt] - p0x, dy = hy[nxt] - p0y;
        vx[i] = (float)dx;
        vy[i] = (float)dy;
        inv_vect_length[i] = (float)(1. / std::sqrt(dx * dx + dy * dy));
        p0x = hx[nxt];
        p0y = hy[nxt];
    }
    // hull orientation
    double orientation = 0;
    {
        double ax = vx[hn - 1], ay = vy[hn - 1];
        for (int i = 0; i < hn; ++i) {
            double bx = vx[i], by = vy[i];
            double convexity = ax * by - ay * bx;
            if (convexity != 0) {
                orientation = convexity > 0 ? 1.0 : -1.0;
                break;
            }
            ax = bx;
            ay = by;
        }
    }
    float base_a = (float)orientation;
    float base_b = 0.f;

    int seq[4] = {bottom, right, top, left};
    float minarea = 3.402823466e+38f;  // FLT_MAX
    float rec_base_a = 0, rec_base_b = 0, rec_width = 0, rec_height = 0;
    int rec_left = left, rec_bottom = bottom;

    for (int k = 0; k < hn; ++k) {
        float dp[4] = {
            +base_a * vx[seq[0]] + base_b * vy[seq[0]],
            -base_b * vx[seq[1]] + base_a * vy[seq[1]],
            -base_a * vx[seq[2]] - base_b * vy[seq[2]],
            +base_b * vx[seq[3]] - base_a * vy[seq[3]],
        };
        float maxcos = dp[0] * inv_vect_length[seq[0]];
        int main_element = 0;
        for (int i = 1; i < 4; ++i) {
            float cosalpha = dp[i] * inv_vect_length[seq[i]];
            if (cosalpha > maxcos) {
                main_element = i;
                maxcos = cosalpha;
            }
        }
        {
            int pindex = seq[main_element];
            float lead_x = vx[pindex] * inv_vect_length[pindex];
            float lead_y = vy[pindex] * inv_vect_length[pindex];
            switch (main_element) {
                case 0: base_a = lead_x; base_b = lead_y; break;
                case 1: base_a = lead_y; base_b = -lead_x; break;
                case 2: base_a = -lead_x; base_b = -lead_y; break;
                default: base_a = -lead_y; base_b = lead_x; break;
            }
        }
        seq[main_element] += 1;
        if (seq[main_element] == hn) seq[main_element] = 0;

        float dx = hx[seq[1]] - hx[seq[3]];
        float dy = hy[seq[1]] - hy[seq[3]];
        float width = dx * base_a + dy * base_b;
        dx = hx[seq[2]] - hx[seq[0]];
        dy = hy[seq[2]] - hy[seq[0]];
        float height = -dx * base_b + dy * base_a;
        float area = width * height;
        if (area <= minarea) {
            minarea = area;
            rec_left = seq[3];
            rec_base_a = base_a;
            rec_width = width;
            rec_base_b = base_b;
            rec_height = height;
            rec_bottom = seq[0];
        }
    }

    float A1 = rec_base_a, B1 = rec_base_b;
    float A2 = -rec_base_b, B2 = rec_base_a;
    float C1 = A1 * hx[rec_left] + hy[rec_left] * B1;
    float C2 = A2 * hx[rec_bottom] + hy[rec_bottom] * B2;
    float idet = 1.f / (A1 * B2 - A2 * B1);
    float px = (C1 * B2 - C2 * B1) * idet;
    float py = (A1 * C2 - A2 * C1) * idet;
    float o1x = A1 * rec_width, o1y = B1 * rec_width;
    float o2x = A2 * rec_height, o2y = B2 * rec_height;

    // --- minAreaRect final assembly (float32 like cv2) ---
    float cx = px + (o1x + o2x) * 0.5f;
    float cy = py + (o1y + o2y) * 0.5f;
    float w = (float)std::sqrt((double)o1x * o1x + (double)o1y * o1y);
    float h = (float)std::sqrt((double)o2x * o2x + (double)o2y * o2y);
    float angle = (float)std::atan2((double)o1y, (double)o1x);
    angle_deg = (float)(angle * 180.0 / M_PI);
    // cv2 5.x normalizes the box representation to angle in [-90, 0),
    // swapping width/height per quarter turn (an axis-aligned wide box
    // reports as (h, w, -90), not (w, h, 0))
    while (angle_deg >= 0.f) {
        angle_deg -= 90.f;
        float t = w; w = h; h = t;
    }
    while (angle_deg < -90.f) {
        angle_deg += 90.f;
        float t = w; w = h; h = t;
    }
    out5[0] = cx;
    out5[1] = cy;
    out5[2] = w;
    out5[3] = h;
    out5[4] = angle_deg;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Packed-bit line-strip extraction (geometry/lines.py _LineRoi; reference
// line_detection.py:267-327). The adaptive-k loop's cost is dominated by
// rect-kernel dilation + per-channel row profiles on the line ROI; on
// 0/255 masks rect dilation is a window-OR, which on LSB-first u64 bit
// rows is a shift-OR spread (horizontal, log(kw) word passes) plus a
// Gil-Werman block prefix/suffix OR (vertical, O(1) rows per output row).
// A rejected k attempt therefore costs ~H*W/64 word ops instead of six
// full-ROI byte passes through cv2.
// ---------------------------------------------------------------------------

// out[i] = in shifted s bit positions toward HIGHER bit/col indices.
static void shift_words_up(const uint64_t* in, uint64_t* out, int nw, int s) {
    int ws = s >> 6, bs = s & 63;
    for (int i = nw - 1; i >= 0; --i) {
        uint64_t v = 0;
        int src = i - ws;
        if (src >= 0) {
            v = in[src] << bs;
            if (bs && src - 1 >= 0) v |= in[src - 1] >> (64 - bs);
        }
        out[i] = v;
    }
}

static void shift_words_down(const uint64_t* in, uint64_t* out, int nw,
                             int s) {
    int ws = s >> 6, bs = s & 63;
    for (int i = 0; i < nw; ++i) {
        uint64_t v = 0;
        int src = i + ws;
        if (src < nw) {
            v = in[src] >> bs;
            if (bs && src + 1 < nw) v |= in[src + 1] << (64 - bs);
        }
        out[i] = v;
    }
}

// x |= OR of x shifted by 1..n positions (doubling: log(n) passes).
static void spread_or(uint64_t* x, uint64_t* tmp, int nw, int n, bool up) {
    int covered = 0;
    while (covered < n) {
        int s = covered ? std::min(covered, n - covered) : 1;
        if (up)
            shift_words_up(x, tmp, nw, s);
        else
            shift_words_down(x, tmp, nw, s);
        for (int i = 0; i < nw; ++i) x[i] |= tmp[i];
        covered += s;
    }
}

// Rect-kernel binary dilation of per-row bitmaps, cv2 anchor semantics:
// kernel (kw, kh), anchor (kw/2, kh/2), so dilated(r, c) = OR of
// mask(r + dy, c + dx) for dx in [-(kw/2), kw-1-kw/2], dy likewise —
// i.e. a mask bit spreads UP by kw/2 columns and DOWN by kw-1-kw/2.
// HD gets the horizontally spread rows; pre/suf get the Gil-Werman
// block-OR tables (block size kh) for composing any vertical window.
struct DilateTables {
    std::vector<uint64_t> HD, pre, suf, tmp;
    int h, nw, kh, ay;
    void build(const uint64_t* mask_bits, int h_, int nw_, int kw, int kh_) {
        h = h_;
        nw = nw_;
        kh = kh_ < 1 ? 1 : kh_;
        ay = kh / 2;
        HD.assign((size_t)h * nw, 0);
        tmp.resize(nw);
        std::memcpy(HD.data(), mask_bits, (size_t)h * nw * 8);
        int ax = kw / 2;
        for (int r = 0; r < h; ++r) {
            uint64_t* row = HD.data() + (size_t)r * nw;
            if (ax > 0) spread_or(row, tmp.data(), nw, ax, true);
            if (kw - 1 - ax > 0)
                spread_or(row, tmp.data(), nw, kw - 1 - ax, false);
        }
        pre.resize((size_t)h * nw);
        suf.resize((size_t)h * nw);
        for (int r = 0; r < h; ++r) {
            const uint64_t* src = HD.data() + (size_t)r * nw;
            uint64_t* dst = pre.data() + (size_t)r * nw;
            if (r % kh == 0)
                std::memcpy(dst, src, (size_t)nw * 8);
            else {
                const uint64_t* prev = pre.data() + (size_t)(r - 1) * nw;
                for (int i = 0; i < nw; ++i) dst[i] = prev[i] | src[i];
            }
        }
        for (int r = h - 1; r >= 0; --r) {
            const uint64_t* src = HD.data() + (size_t)r * nw;
            uint64_t* dst = suf.data() + (size_t)r * nw;
            if (r % kh == kh - 1 || r == h - 1)
                std::memcpy(dst, src, (size_t)nw * 8);
            else {
                const uint64_t* nxt = suf.data() + (size_t)(r + 1) * nw;
                for (int i = 0; i < nw; ++i) dst[i] = nxt[i] | src[i];
            }
        }
    }
    // OR of HD rows in the clipped window around output row r, written
    // into out (nw words).
    void window(int r, uint64_t* out) const {
        int lo = r - ay;
        int hi = r + (kh - 1 - ay);
        if (lo < 0) lo = 0;
        if (hi > h - 1) hi = h - 1;
        if (hi < lo) {
            std::memset(out, 0, (size_t)nw * 8);
            return;
        }
        int b1 = lo / kh, b2 = hi / kh;
        const uint64_t* plo = suf.data() + (size_t)lo * nw;
        const uint64_t* phi = pre.data() + (size_t)hi * nw;
        if (b1 == b2) {
            // full-size windows inside one block start AT the block start
            // (block size == kh); clipped windows start at row 0 or end at
            // h-1 — in every case one table alone is exact
            if (lo % kh == 0)
                std::memcpy(out, phi, (size_t)nw * 8);
            else
                std::memcpy(out, plo, (size_t)nw * 8);
        } else {
            for (int i = 0; i < nw; ++i) out[i] = plo[i] | phi[i];
        }
    }
};

extern "C" {

// Pack a line ROI into LSB-first u64 bit rows: mask_bits (h x nw) from the
// 0/255 contour mask, nz_bits (C x h x nw) marking nonzero image bytes.
// roi strides are in bytes (rows / pixels); channels must be interleaved
// with stride 1 (or C == 1).
void ocr_pack_line_bits(const uint8_t* roi, int64_t rs, int64_t ps, int C,
                        const uint8_t* mask, int64_t mask_rs, int h, int w,
                        int nw, uint64_t* mask_bits, uint64_t* nz_bits) {
    std::memset(mask_bits, 0, (size_t)h * nw * 8);
    std::memset(nz_bits, 0, (size_t)C * h * nw * 8);
    for (int r = 0; r < h; ++r) {
        const uint8_t* mrow = mask + (size_t)r * mask_rs;
        uint64_t* mb = mask_bits + (size_t)r * nw;
        int j = 0;
#if defined(__SSE2__)
        for (; j + 16 <= w; j += 16)
            mb[j >> 6] |= (uint64_t)nz16(mrow + j) << (j & 63);
#endif
        for (; j < w; ++j)
            if (mrow[j]) mb[j >> 6] |= 1ull << (j & 63);
        const uint8_t* irow = roi + (size_t)r * rs;
        if (C == 1 && ps == 1) {
            uint64_t* nb = nz_bits + (size_t)r * nw;
            j = 0;
#if defined(__SSE2__)
            for (; j + 16 <= w; j += 16)
                nb[j >> 6] |= (uint64_t)nz16(irow + j) << (j & 63);
#endif
            for (; j < w; ++j)
                if (irow[j]) nb[j >> 6] |= 1ull << (j & 63);
            continue;
        }
#if defined(__SSE2__) && defined(__BMI2__)
        if (C == 3 && ps == 3) {
            // Deinterleave RGB nonzero-ness: 48 bytes -> one 48-bit
            // byte-nonzero mask, then PEXT with a stride-3 selector pulls
            // each channel's 16 pixel bits out in order.
            uint64_t* nb0 = nz_bits + ((size_t)0 * h + r) * nw;
            uint64_t* nb1 = nz_bits + ((size_t)1 * h + r) * nw;
            uint64_t* nb2 = nz_bits + ((size_t)2 * h + r) * nw;
            const uint64_t SEL0 = 0x249249249249ull;  // bits 3k, k=0..15
            j = 0;
            for (; j + 16 <= w; j += 16) {
                const uint8_t* p = irow + (size_t)j * 3;
                uint64_t m = (uint64_t)nz16(p)
                           | ((uint64_t)nz16(p + 16) << 16)
                           | ((uint64_t)nz16(p + 32) << 32);
                int sh = j & 63;  // j is a multiple of 16: never straddles
                nb0[j >> 6] |= _pext_u64(m, SEL0) << sh;
                nb1[j >> 6] |= _pext_u64(m, SEL0 << 1) << sh;
                nb2[j >> 6] |= _pext_u64(m, SEL0 << 2) << sh;
            }
            for (; j < w; ++j) {
                const uint8_t* p = irow + (size_t)j * 3;
                if (p[0]) nb0[j >> 6] |= 1ull << (j & 63);
                if (p[1]) nb1[j >> 6] |= 1ull << (j & 63);
                if (p[2]) nb2[j >> 6] |= 1ull << (j & 63);
            }
            continue;
        }
#endif
        for (int c = 0; c < C; ++c) {
            uint64_t* nb = nz_bits + ((size_t)c * h + r) * nw;
            const uint8_t* p = irow + c;
            for (int j2 = 0; j2 < w; ++j2)
                if (p[(size_t)j2 * ps]) nb[j2 >> 6] |= 1ull << (j2 & 63);
        }
    }
}

// Height (count of kept rows) of one dilation attempt: a row survives iff
// EVERY channel has a nonzero byte under the dilated mask in that row
// (mask_n_crop's np.delete semantics, lines.py _LineRoi.attempt).
int ocr_attempt_height(const uint64_t* mask_bits, const uint64_t* nz_bits,
                       int C, int h, int nw, int kw, int kh) {
    DilateTables dt;
    dt.build(mask_bits, h, nw, kw, kh);
    std::vector<uint64_t> win(nw);
    int height = 0;
    for (int r = 0; r < h; ++r) {
        dt.window(r, win.data());
        bool all = true;
        for (int c = 0; c < C && all; ++c) {
            const uint64_t* nb = nz_bits + ((size_t)c * h + r) * nw;
            bool any = false;
            for (int i = 0; i < nw; ++i)
                if (win[i] & nb[i]) {
                    any = true;
                    break;
                }
            all = any;
        }
        if (all) ++height;
    }
    return height;
}

// Materialize the accepted attempt's strip: kept rows x kept cols, bytes
// masked by the dilated contour (byte-parity with the cv2 path:
// bitwise_and(channel, dilated) -> row filter -> column filter -> stack).
// out must hold h*w*C bytes; actual dims return via out_h/out_w.
void ocr_masked_crop(const uint8_t* roi, int64_t rs, int64_t ps, int C,
                     const uint64_t* mask_bits, const uint64_t* nz_bits,
                     int h, int w, int nw, int kw, int kh, uint8_t* out,
                     int* out_h, int* out_w) {
    DilateTables dt;
    dt.build(mask_bits, h, nw, kw, kh);
    // Materialize every dilated row once (pass 1-3 all need them).
    std::vector<uint64_t> WD((size_t)h * nw);
    for (int r = 0; r < h; ++r) dt.window(r, WD.data() + (size_t)r * nw);
    std::vector<uint8_t> rows_keep(h, 0);
    std::vector<uint64_t> colbits((size_t)nw, ~0ull);
    std::vector<uint64_t> ch_cols(nw);
    int height = 0;
    // pass 1: row profile
    for (int r = 0; r < h; ++r) {
        const uint64_t* win = WD.data() + (size_t)r * nw;
        bool all = true;
        for (int c = 0; c < C && all; ++c) {
            const uint64_t* nb = nz_bits + ((size_t)c * h + r) * nw;
            bool any = false;
            for (int i = 0; i < nw; ++i)
                if (win[i] & nb[i]) {
                    any = true;
                    break;
                }
            all = any;
        }
        if (all) {
            rows_keep[r] = 1;
            ++height;
        }
    }
    if (height == 0) {
        *out_h = 0;
        *out_w = w;
        return;
    }
    // pass 2: column profile over kept rows (per channel, then AND)
    for (int c = 0; c < C; ++c) {
        std::fill(ch_cols.begin(), ch_cols.end(), 0ull);
        for (int r = 0; r < h; ++r) {
            if (!rows_keep[r]) continue;
            const uint64_t* win = WD.data() + (size_t)r * nw;
            const uint64_t* nb = nz_bits + ((size_t)c * h + r) * nw;
            for (int i = 0; i < nw; ++i) ch_cols[i] |= win[i] & nb[i];
        }
        for (int i = 0; i < nw; ++i) colbits[i] &= ch_cols[i];
    }
    std::vector<int32_t> rank(w, -1);
    int w2 = 0;
    for (int j = 0; j < w; ++j)
        if (colbits[j >> 6] & (1ull << (j & 63))) rank[j] = w2++;
    // pass 3: fill. Output row = zeros except where the dilated mask covers
    // a kept column; a run of consecutive kept+dilated columns has
    // consecutive ranks, so each run is one memcpy when pixels are
    // contiguous (ps == C).
    uint8_t* dst = out;
    for (int r = 0; r < h; ++r) {
        if (!rows_keep[r]) continue;
        const uint64_t* win = WD.data() + (size_t)r * nw;
        const uint8_t* irow = roi + (size_t)r * rs;
        std::memset(dst, 0, (size_t)w2 * C);
        for (int i = 0; i < nw; ++i) {
            uint64_t word = win[i] & colbits[i];
            while (word) {
                int b = __builtin_ctzll(word);
                uint64_t low = word >> b;
                int len = (~low == 0ull) ? 64 - b : __builtin_ctzll(~low);
                int j0 = i * 64 + b;
                int run = len;
                if (j0 + run > w) run = w - j0;
                if (run > 0) {
                    uint8_t* d = dst + (size_t)rank[j0] * C;
                    if (ps == C) {
                        std::memcpy(d, irow + (size_t)j0 * ps,
                                    (size_t)run * C);
                    } else {
                        for (int t = 0; t < run; ++t) {
                            const uint8_t* p = irow + (size_t)(j0 + t) * ps;
                            for (int c = 0; c < C; ++c) *d++ = p[c];
                        }
                    }
                }
                if (b + len >= 64) break;
                word &= ~0ull << (b + len);
            }
        }
        dst += (size_t)w2 * C;
    }
    *out_h = height;
    *out_w = w2;
}
}  // extern "C"

extern "C" {

// get_line_threshold (geometry/lines.py:389; reference
// line_detection.py:362-421) as ONE native call. The Python loop pays a
// Python->ctypes roundtrip, a slice copy, and a fresh points buffer for
// every 20-px slice (~63 per page); here the full page mask is scanned in
// place. Semantics are pinned to the slice loop: nonzero bbox of the mask,
// per-slice Suzuki-Abe border counting (outer AND hole borders, exactly
// ocr_find_contours' discovery loop), numpy-style column clipping for
// slices that run off the page, first-maximum slice wins, and the result
// is floor(median(bbox y-centers) / n_borders). Row stride is in bytes;
// element stride must be 1.
double ocr_line_threshold(const uint8_t* mask, int h, int w,
                          int64_t row_stride, int slice_width) {
    int minx = w, maxx = -1, miny = h, maxy = -1;
    for (int i = 0; i < h; ++i) {
        const uint8_t* row = mask + (size_t)i * row_stride;
        int j = 0;
        while (j < w && row[j] == 0) ++j;
        if (j == w) continue;
        if (j < minx) minx = j;
        if (miny == h) miny = i;
        maxy = i;
        int k = w - 1;
        while (k >= 0 && row[k] == 0) --k;
        if (k > maxx) maxx = k;
    }
    if (maxx < 0) return 0.0;  // empty mask -> zero slices -> 0.0
    int bx = minx, by = miny;
    int bw = maxx - minx + 1, bh = maxy - miny + 1;
    int x_steps = (bw / slice_width) / 2;

    std::vector<int8_t> F;
    std::vector<Point> contour;
    std::vector<int32_t> centers, best_centers;
    int best_n = -1;  // Python max() keeps the FIRST maximal slice
    for (int step = 1; step <= x_steps; ++step) {
        int64_t x_start = (int64_t)bx + (int64_t)x_steps * step;
        int64_t x_end = x_start + slice_width;
        int64_t c0 = std::min<int64_t>(std::max<int64_t>(x_start, 0), w);
        int64_t c1 = std::min<int64_t>(std::max<int64_t>(x_end, 0), w);
        int sw = (int)(c1 > c0 ? c1 - c0 : 0);
        centers.clear();
        if (sw > 0) {
            F.assign((size_t)bh * sw, 0);
            for (int i = 0; i < bh; ++i) {
                const uint8_t* row =
                    mask + (size_t)(by + i) * row_stride + c0;
                int8_t* frow = F.data() + (size_t)i * sw;
                for (int j = 0; j < sw; ++j) frow[j] = row[j] ? 1 : 0;
            }
            int32_t nbd = 1;
            for (int i = 0; i < bh; ++i) {
                for (int j = 0; j < sw; ++j) {
                    int32_t f = F[(size_t)i * sw + j];
                    if (f == 0) continue;
                    bool outer = (f == 1) &&
                                 (j == 0 || F[(size_t)i * sw + j - 1] == 0);
                    bool hole =
                        (f >= 1) &&
                        (j == sw - 1 || F[(size_t)i * sw + j + 1] == 0);
                    if (!outer && !hole) continue;
                    ++nbd;
                    int i2 = i, j2 = outer ? j - 1 : j + 1;
                    contour.clear();
                    follow_border(F, bh, sw, i, j, i2, j2, nbd, contour);
                    // bbox of the uncompressed border == bbox of the
                    // CHAIN_APPROX_SIMPLE contour (direction-change
                    // filtering keeps every extremal pixel)
                    int32_t cmin = contour[0].y, cmax = contour[0].y;
                    for (const Point& p : contour) {
                        if (p.y < cmin) cmin = p.y;
                        if (p.y > cmax) cmax = p.y;
                    }
                    centers.push_back(cmin + (cmax - cmin + 1) / 2);
                }
            }
        }
        if ((int)centers.size() > best_n) {
            best_n = (int)centers.size();
            best_centers = centers;
        }
    }
    if (best_n <= 0) return 0.0;
    std::sort(best_centers.begin(), best_centers.end());
    size_t n = best_centers.size();
    double median = (n % 2) ? (double)best_centers[n / 2]
                            : 0.5 * ((double)best_centers[n / 2 - 1] +
                                     (double)best_centers[n / 2]);
    return std::floor(median / (double)best_n);
}
}  // extern "C"

// ---------------------------------------------------------------------------
// Filled contour (cv2.drawContours(img, [c], -1, value, thickness=-1))
// ---------------------------------------------------------------------------
//
// cv2 draws a filled contour as fillPoly with LINE_8 and shift 0: every
// edge is first drawn as an 8-connected line, then the polygon is filled
// scanline by scanline (even-odd rule over the non-horizontal edges, each
// edge active on [y_top, y_bottom), x kept in 16.16 fixed point and
// advanced by an integer slope; the span runs from ceil(left) to
// floor(right)). Byte-equal with cv2 on contours from find_contours and on
// random self-intersecting polygons (tests/test_torch_ops.py).

namespace {

constexpr int kXYShift = 16;
constexpr int64_t kXYOne = (int64_t)1 << kXYShift;

inline void put_px(uint8_t* img, int h, int w, int64_t stride, int x, int y,
                   uint8_t v) {
  if (x >= 0 && y >= 0 && x < w && y < h) img[(int64_t)y * stride + x] = v;
}

// cv2 LineIterator with connectivity 8 and leftToRight = true
void line8(uint8_t* img, int h, int w, int64_t stride, int x0, int y0, int x1,
           int y1, uint8_t v) {
  int dx = x1 - x0, dy = y1 - y0;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x0, x1);
    std::swap(y0, y1);
  }
  int sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int err = dx - (dy + dy);
  const int plus = dx + dx, minus = -(dy + dy);
  int x = x0, y = y0;
  for (int i = 0; i <= dx; ++i) {
    put_px(img, h, w, stride, x, y, v);
    const bool neg = err < 0;
    err += minus + (neg ? plus : 0);
    if (vert) {
      y += sy;
      if (neg) x += 1;
    } else {
      x += 1;
      if (neg) y += sy;
    }
  }
}

struct FillEdge {
  int y0, y1;
  int64_t x, dx;
};

}  // namespace

extern "C" {

void ocr_fill_contour(uint8_t* img, int h, int w, int64_t stride,
                      const int32_t* pts, int n, uint8_t value) {
  if (n <= 0) return;
  std::vector<FillEdge> edges;
  edges.reserve(n);
  int px = pts[2 * (n - 1)], py = pts[2 * (n - 1) + 1];
  for (int i = 0; i < n; ++i) {
    const int cx = pts[2 * i], cy = pts[2 * i + 1];
    line8(img, h, w, stride, px, py, cx, cy, value);
    if (py != cy) {
      const int64_t X0 = (int64_t)px << kXYShift, X1 = (int64_t)cx << kXYShift;
      FillEdge e;
      e.dx = (X1 - X0) / (int64_t)(cy - py);
      if (py < cy) {
        e.y0 = py; e.y1 = cy; e.x = X0;
      } else {
        e.y0 = cy; e.y1 = py; e.x = X1;
      }
      edges.push_back(e);
    }
    px = cx;
    py = cy;
  }
  if (edges.size() < 2) return;
  int y_min = INT32_MAX, y_max = INT32_MIN;
  for (const FillEdge& e : edges) {
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
  }
  y_max = std::min(y_max, h);
  std::vector<int64_t> xs;
  for (int y = std::max(y_min, 0); y < y_max; ++y) {
    xs.clear();
    for (const FillEdge& e : edges)
      if (e.y0 <= y && y < e.y1) xs.push_back(e.x + e.dx * (int64_t)(y - e.y0));
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int x1 = (int)((xs[k] + kXYOne - 1) >> kXYShift);
      int x2 = (int)(xs[k + 1] >> kXYShift);
      if (x1 >= w || x2 < 0) continue;
      x1 = std::max(x1, 0);
      x2 = std::min(x2, w - 1);
      if (x1 <= x2) memset(img + (int64_t)y * stride + x1, value, x2 - x1 + 1);
    }
  }
}

}  // extern "C"
