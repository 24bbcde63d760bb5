// Adaptive Gaussian binarization (cv2.adaptiveThreshold GAUSSIAN_C,
// block 51, C 13) for Hopper, sm_90a.
//
// Replaces both Pallas kernels of ocr_inference_tpu/ops/pallas_kernels.py:
//   - _binarize_kernel (:81-99, launched by binarize_tile_pallas :130-163):
//     (N, 512, 512, 3) RGB page tiles, gray conversion fused in;
//   - _line_window_kernel (:102-112, launched by binarize_lines_pallas
//     :186-224): (B, 80, W) gray line canvases, W up to 3000.
// The TPU kernels blur with banded matmuls on the MXU (L @ gray @ R). Here
// one templated kernel serves both as two specialisations:
//   - tiles: 64 x 128 output pixels a block, RGB -> gray fused in;
//   - lines: 80 rows (the whole canvas for the recognizer's height) by a
//     column strip of 32, 64 or 128, chosen by the wrapper so that the grid
//     covers at least one wave of the card's SMs. Taller images take more
//     row blocks, each with its halo, as the tiles do.
// A block stages its output tile plus the 25-px halo as gray in shared
// memory, replicating the image's own edges (a page tile never sees its
// neighbour), blurs over rows into shared memory, then over columns, and
// thresholds.
//
// The decision. With integer gray g and m = clip(rint(acc), 0, 255), the
// rule g > m - 13 is always true for g >= 243; otherwise it is true exactly
// when acc < g + 12.5, or acc == g + 12.5 and g + 12 is even (rint rounds
// half to even). So a pixel needs acc only against g + 12.5.
//
// Two tiers, one kernel. The blur runs in float32 with FMA, in the order
// that suits the card, on cv2's float32 taps. A pixel whose float32 sum
// lies more than eps from g + 12.5 is decided by it. Any other pixel is
// recomputed from the staged gray values by its warp in exactly cv2's own
// float32 arithmetic (adaptiveThreshold blurs the float image with its
// separable filter: the row pass first, each row's 51 taps left to right,
// fused for columns below 4 * (w / 4) and product and sum rounded apart
// beyond; then the column pass, the centre row first and each symmetric
// pair of rows added and multiplied in, fused for columns below 8 * (w /
// 8); a one-row image has no column pass, a one-column image no row
// pass), and decided by that. This is the plain version's arithmetic
// (ops/imaging.py blur_cv2).
//
// The bound on |acc32 - acc_cv2|, with u = 2^-24, gamma_n = n u / (1 -
// n u), taps t_i > 0 with sum S = 1 + O(u), gray 0..255: each float32
// order lies within
//   rows:    gamma_51 * 255 * S = 7.75e-4 for each of the 51 row sums (any
//            order, with or without FMA);
//   columns: gamma_51 * 255 * S * (1 + gamma_51) from its own rounding,
//            plus S * 7.75e-4 carried from the rows: 1.55e-3 in all
// of the exact sum, so the two orders lie within 3.1e-3 < eps = 2^-8 =
// 3.9e-3 of each other. g + 12.5 +- eps is exact in float32 (below 256
// float32 resolves 2^-16), so the two tests acc32 < g + 12.5 - eps and
// acc32 > g + 12.5 + eps are exact and decide like acc_cv2 would. The
// wrapper passes eps (ops/kernels.py RECHECK_EPS). The recheck counts its
// pixels into a 64-bit counter the wrapper owns.
//
// Bound on this card: 2 * 51 * 2 = 204 flop a pixel against 2-4 bytes of
// traffic, so operations bound it (float32, 67 TFLOP/s). The design spends
// its instructions on FFMA: the taps live in __constant__ memory and the
// tap loops are unrolled, so each tap is one FFMA with its operand from the
// constant bank (a uniform register); each thread slides a register window
// over 16-20 outputs along the blur axis (k + 50 loads for 51 k FFMAs);
// the gray is staged as bf16 (exact for 0..255, one shift to float32) with
// replicated edge rows, so the row pass addresses shared memory with
// immediate offsets; the column pass reads float4s, its lanes along a row
// so that a warp stores whole 32-byte sectors of the mask; two blocks fit
// on an SM. The halo costs 178 / 128 = 1.39x in the row pass of a 128-wide
// tile. What holds it back (PERF.md): the blur passes issue FFMA at about
// half the card's rate, and staging, conversion and the decision take
// about as long again. A persistent variant that prefetched each next tile
// with cp.async hid the loads completely but ran slower, with one block an
// SM; neither taps in ordinary registers nor other window sizes moved the
// FFMA rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 51;
constexpr int kHalf = kBlock / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;  // pixels staged by one thread
constexpr int kOutH = 8;    // outputs of one thread in the column pass

__constant__ float c_taps[kBlock];

template <int TH, int TW>
struct Layout {
  static constexpr int kRowsOut = TH / 4;           // row-pass outputs a thread
  static constexpr int kGrayRows = TH + 2 * kHalf;  // staged, edges replicated
  static constexpr int kGrayW = TW + 64;            // staged cols, x0-32 ..
  static constexpr int kVertCols = TW + 2 * kHalf;  // row-pass columns
  // the column pass reads float4s up to column TW + 51
  static constexpr int kVertW = TW + 52;
  static constexpr int kScratchBytes = kWarps * kBlock * 4;
  static constexpr int kVertBytes = TH * kVertW * 4;
  static constexpr int kGrayBytes = kGrayRows * kGrayW * 2;
  static constexpr int kSmemBytes = kScratchBytes + kVertBytes + kGrayBytes;
  static_assert(TH % 4 == 0 && TW % kGroup == 0, "tile shape");
  static_assert(kScratchBytes % 16 == 0 && kVertBytes % 16 == 0, "align");
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// cv2's rule on its float32 mean: rounded half to even, saturated to
// 0..255, white where g > mean - 13
__device__ __forceinline__ bool rule(float acc, float g) {
  float mean = rintf(acc);
  mean = mean < 0.0f ? 0.0f : (mean > 255.0f ? 255.0f : mean);
  return g > mean - 13.0f;
}

// Load 16 pixels (16 * CH bytes) of one image row from column gx on: the
// widest loads the row's alignment allows, byte loads with the column
// clamped where the group crosses the image's left or right edge.
template <int CH>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ row,
                                           int gx, int w, int align,
                                           uint32_t (&words)[4 * CH]) {
  const bool inside = gx >= 0 && gx + kGroup <= w;
  const uint8_t* p = row + (size_t)gx * CH;
  if (inside && align >= 16) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      words[4 * k] = v.x; words[4 * k + 1] = v.y;
      words[4 * k + 2] = v.z; words[4 * k + 3] = v.w;
    }
  } else if (inside && align >= 8) {
#pragma unroll
    for (int k = 0; k < 2 * CH; ++k) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
      words[2 * k] = v.x; words[2 * k + 1] = v.y;
    }
  } else if (inside && align >= 4) {
#pragma unroll
    for (int k = 0; k < 4 * CH; ++k)
      words[k] = __ldg(reinterpret_cast<const uint32_t*>(p) + k);
  } else {
#pragma unroll
    for (int k = 0; k < 4 * CH; ++k) words[k] = 0;
#pragma unroll
    for (int b = 0; b < kGroup * CH; ++b) {
      const int x = clampi(gx + b / CH, 0, w - 1);
      words[b / 4] |= (uint32_t)row[(size_t)x * CH + b % CH] << (8 * (b % 4));
    }
  }
}

// 16 pixels -> 16 bf16 gray values in shared memory (two 16-byte stores);
// RGB with cv2 5.x's RGB2GRAY, 15-bit fixed point.
template <int CH>
__device__ __forceinline__ void store_gray(const uint32_t (&words)[4 * CH],
                                           uint16_t* dst) {
  uint32_t packed[kGroup / 2];
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    uint32_t g;
    if (CH == 3) {
      const int b0 = 3 * p;
      const uint32_t cr = (words[b0 / 4] >> (8 * (b0 % 4))) & 0xff;
      const uint32_t cg = (words[(b0 + 1) / 4] >> (8 * ((b0 + 1) % 4))) & 0xff;
      const uint32_t cb = (words[(b0 + 2) / 4] >> (8 * ((b0 + 2) % 4))) & 0xff;
      g = (cr * 9798u + cg * 19235u + cb * 3735u + 16384u) >> 15;
    } else {
      g = (words[p / 4] >> (8 * (p % 4))) & 0xff;
    }
    const uint32_t bits = __float_as_uint((float)g) >> 16;
    if (p % 2 == 0) packed[p / 2] = bits;
    else packed[p / 2] |= bits << 16;
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
  out[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  out[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// Stage gray rows y0-25 .. y0+TH+24 and columns x0-32 .. x0+TW+31 of one
// image as bf16, the image's edges replicated: a row or column past an
// edge reads the edge row or column.
template <int TH, int TW, int CH>
__device__ __forceinline__ void stage_gray(
    const uint8_t* __restrict__ img, uint16_t* gray, int h, int w, int y0,
    int x0, int align) {
  using L = Layout<TH, TW>;
  constexpr int kGroups = L::kGrayW / kGroup;
  for (int i = threadIdx.x; i < L::kGrayRows * kGroups; i += kThreads) {
    const int r = i / kGroups, grp = i % kGroups;
    const int gy = clampi(y0 - kHalf + r, 0, h - 1);
    uint32_t words[4 * CH];
    load_group<CH>(img + (size_t)gy * w * CH, x0 - 32 + grp * kGroup, w,
                   align, words);
    store_gray<CH>(words, gray + r * L::kGrayW + grp * kGroup);
  }
}

// The exact tier for one pixel (image column x), by the whole warp, in
// cv2's float32 arithmetic: lanes take the 51 row sums (window rows, taps
// over columns left to right), lane `owner` the column sum (the centre
// row, then each symmetric pair of rows).
template <int TH, int TW>
__device__ bool recheck(const uint16_t* gray, float* scratch, int r, int o,
                        int lane, int owner, int x, int h, int w) {
  using L = Layout<TH, TW>;
  const bool row_fma = x < (w / 4) * 4;
  const bool col_fma = x < (w / 8) * 8;
  // window rows r .. r+50 of the staged gray, columns o+7 .. o+57
  for (int j = lane; j < kBlock; j += 32) {
    const uint16_t* row = gray + (r + j) * L::kGrayW + o + 7;
    float acc = bf16_to_float(row[kHalf]);
    if (w > 1) {
      acc = __fmul_rn(bf16_to_float(row[0]), c_taps[0]);
      for (int t = 1; t < kBlock; ++t) {
        const float v = bf16_to_float(row[t]);
        acc = row_fma ? __fmaf_rn(v, c_taps[t], acc)
                      : __fadd_rn(acc, __fmul_rn(v, c_taps[t]));
      }
    }
    scratch[j] = acc;
  }
  __syncwarp();
  bool white = false;
  if (lane == owner) {
    float acc = scratch[kHalf];
    if (h > 1) {
      acc = __fmul_rn(acc, c_taps[kHalf]);
      for (int j = 1; j <= kHalf; ++j) {
        const float pair = __fadd_rn(scratch[kHalf + j], scratch[kHalf - j]);
        acc = col_fma ? __fmaf_rn(pair, c_taps[kHalf + j], acc)
                      : __fadd_rn(acc, __fmul_rn(pair, c_taps[kHalf + j]));
      }
    }
    white = rule(acc, bf16_to_float(gray[(r + kHalf) * L::kGrayW + o + 32]));
  }
  __syncwarp();
  return white;
}

template <int TH, int TW, int CH>
__global__ void __launch_bounds__(kThreads, 2)
binarize_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                unsigned long long* __restrict__ rechecked, int h, int w,
                float eps, int align) {
  using L = Layout<TH, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* vert = reinterpret_cast<float*>(smem + L::kScratchBytes);
  uint16_t* gray =
      reinterpret_cast<uint16_t*>(smem + L::kScratchBytes + L::kVertBytes);

  const int img = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const size_t plane = (size_t)h * (size_t)w;

  stage_gray<TH, TW, CH>(src + (size_t)img * plane * CH, gray, h, w, y0, x0,
                         align);
  __syncthreads();

  // row pass: vert[r][v] = sum_t tap[t] * gray[r + t][v + 7], a thread
  // sliding down one column over kRowsOut outputs
  constexpr int KV = L::kRowsOut;
  for (int i = tid; i < L::kVertCols * 4; i += kThreads) {
    const int v = i % L::kVertCols, r0 = (i / L::kVertCols) * KV;
    const uint16_t* col = gray + r0 * L::kGrayW + v + 7;
    float acc[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < KV + kBlock - 1; ++j) {
      const float x = bf16_to_float(col[j * L::kGrayW]);
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int t = j - k;
        if (t >= 0 && t < kBlock) acc[k] = fmaf(c_taps[t], x, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < KV; ++k) vert[(r0 + k) * L::kVertW + v] = acc[k];
  }
  __syncthreads();

  // column pass, threshold, exact tier, store; the loop runs the same
  // count on every lane so that a warp can recheck together
  constexpr int kTasks = TH * (TW / kOutH);
  // g + 12.5 -+ eps, exact in float32 for g in 0..255
  const float lo_off = 12.5f - eps, hi_off = 12.5f + eps;
  float* my_scratch = scratch + (tid / 32) * kBlock;
  for (int base = 0; base < kTasks; base += kThreads) {
    const int task = base + tid;
    const bool active = task < kTasks;
    // lanes along a row, so that a warp stores whole sectors
    const int r = active ? task / (TW / kOutH) : 0;
    const int o = active ? (task % (TW / kOutH)) * kOutH : 0;
    const int gy = y0 + r;
    float acc[kOutH];
#pragma unroll
    for (int k = 0; k < kOutH; ++k) acc[k] = 0.0f;
    const float4* row = reinterpret_cast<const float4*>(vert + r * L::kVertW + o);
#pragma unroll
    for (int q = 0; q < (kOutH + kBlock - 1 + 3) / 4; ++q) {
      const float4 f = row[q];
      const float xs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
#pragma unroll
        for (int k = 0; k < kOutH; ++k) {
          const int t = j - k;
          if (t >= 0 && t < kBlock) acc[k] = fmaf(c_taps[t], xs[e], acc[k]);
        }
      }
    }
    const uint4 gq = *reinterpret_cast<const uint4*>(
        gray + (r + kHalf) * L::kGrayW + o + 32);
    const uint32_t gw[4] = {gq.x, gq.y, gq.z, gq.w};
    uint32_t bytes[2] = {0, 0};
    uint32_t need = 0;
#pragma unroll
    for (int k = 0; k < kOutH; ++k) {
      const float g = __uint_as_float(
          k % 2 ? gw[k / 2] & 0xffff0000u : gw[k / 2] << 16);
      const bool white = g >= 243.0f || acc[k] < g + lo_off;
      const bool black = !white && acc[k] > g + hi_off;
      if (white) bytes[k / 4] |= 0xffu << (8 * (k % 4));
      if (!white && !black && x0 + o + k < w) need |= 1u << k;
    }
    if (!active || gy >= h) need = 0;
    unsigned pending = __ballot_sync(0xffffffffu, need != 0);
    while (pending) {
      const int owner = __ffs(pending) - 1;
      pending &= pending - 1;
      unsigned bits = __shfl_sync(0xffffffffu, need, owner);
      const int orow = __shfl_sync(0xffffffffu, r, owner);
      const int ocol = __shfl_sync(0xffffffffu, o, owner);
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const bool white = recheck<TH, TW>(gray, my_scratch, orow, ocol + k,
                                           lane, owner, x0 + ocol + k, h, w);
        if (lane == owner) {
          // k is not known at compile time: no indexing of `bytes` by it
          const uint32_t bit = white ? 0xffu << (8 * (k % 4)) : 0u;
          if (k < 4) bytes[0] |= bit;
          else bytes[1] |= bit;
          atomicAdd(rechecked, 1ull);
        }
      }
    }
    if (active && gy < h) {
      const int gx = x0 + o;
      uint8_t* out = dst + (size_t)img * plane + (size_t)gy * w + gx;
      if (align >= 8 && gx + kOutH <= w) {
        *reinterpret_cast<uint2*>(out) = make_uint2(bytes[0], bytes[1]);
      } else if (align >= 4 && gx + kOutH <= w) {
        reinterpret_cast<uint32_t*>(out)[0] = bytes[0];
        reinterpret_cast<uint32_t*>(out)[1] = bytes[1];
      } else {
        for (int k = 0; k < kOutH && gx + k < w; ++k)
          out[k] = (uint8_t)(bytes[k / 4] >> (8 * (k % 4)));
      }
    }
  }
}

template <int TH, int TW, int CH>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(binarize_kernel<TH, TW, CH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<TH, TW>::kSmemBytes);
}

template <int TH, int TW, int CH>
cudaError_t launch(const void* src, void* dst, void* rechecked, int n, int h,
                   int w, float eps, cudaStream_t stream) {
  // the widest access (16, 8, 4 or 1 bytes) that every row start allows
  int align = 16;
  while (align > 1 && (w % align || (uintptr_t)src % align ||
                       (uintptr_t)dst % align))
    align /= 2;
  if (align == 2) align = 1;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  binarize_kernel<TH, TW, CH><<<grid, kThreads, Layout<TH, TW>::kSmemBytes,
                                stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, (unsigned long long*)rechecked, h,
      w, eps, align);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before any launch: the 51 float32 taps into constant
// memory, and the dynamic shared memory each specialisation needs.
int ocr_binarize_init(const float* taps) {
  cudaError_t err = cudaMemcpyToSymbol(c_taps, taps, kBlock * sizeof(float));
  if (err == cudaSuccess) err = set_smem<64, 128, 3>();
  if (err == cudaSuccess) err = set_smem<80, 128, 1>();
  if (err == cudaSuccess) err = set_smem<80, 64, 1>();
  if (err == cudaSuccess) err = set_smem<80, 32, 1>();
  return (int)err;
}

// src: (n, h, w, channels) uint8; dst: (n, h, w) uint8; rechecked: one
// uint64 that the kernel adds its rechecked pixels to. channels 3: the
// tile specialisation; channels 1: the line specialisation with column
// strips of strip_w (32, 64 or 128). Launches on `stream`, allocates
// nothing, returns cudaGetLastError() of the launch.
int ocr_binarize(const void* src, void* dst, void* rechecked, int n, int h,
                 int w, int channels, int strip_w, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 3) return (int)launch<64, 128, 3>(src, dst, rechecked, n, h, w, eps, s);
  if (channels != 1) return (int)cudaErrorInvalidValue;
  switch (strip_w) {
    case 128: return (int)launch<80, 128, 1>(src, dst, rechecked, n, h, w, eps, s);
    case 64: return (int)launch<80, 64, 1>(src, dst, rechecked, n, h, w, eps, s);
    case 32: return (int)launch<80, 32, 1>(src, dst, rechecked, n, h, w, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
