// Adaptive Gaussian binarization (cv2.adaptiveThreshold GAUSSIAN_C,
// block 51, C 13) for Hopper, sm_90a.
//
// Replaces both Pallas kernels of ocr_inference_tpu/ops/pallas_kernels.py:
//   - _binarize_kernel (:81-99, launched by binarize_tile_pallas :130-163):
//     (N, 512, 512, 3) RGB page tiles, gray conversion fused in;
//   - _line_window_kernel (:102-112, launched by binarize_lines_pallas
//     :186-224): (B, 80, W) gray line canvases, W up to 3000.
// The TPU kernels blur with banded matmuls on the MXU (L @ gray @ R) and,
// for lines, cut W into windows with a materialized 25-px halo stack. Here
// one kernel serves both: a block owns an output tile of TH x TW pixels of
// one image, stages the tile plus its 25-px halo in shared memory (the
// replicate border is applied at the image's own edges, so a page tile
// never sees its neighbour tile), runs the 51-tap blur over rows, then
// over columns, rounds, and thresholds.
//
// Arithmetic: float64, each tap added in order t = 0..50 as a separately
// rounded product and sum (__dmul_rn / __dadd_rn, no FMA contraction), the
// same operations in the same order as the plain PyTorch version
// (ops/imaging.py adaptive_threshold_gaussian), so the two agree bit for
// bit. No TF32 and no tensor cores: a reduced-precision blur flipped 152 of
// 640k pixels on the TPU.
//
// Bound: at 512^2 the work is 2 * 51 * 2 = 204 flop per pixel against
// 3-4 bytes of traffic, so it is bound by operations: 53 MFLOP per tile,
// about 1.6 us at the card's 34 TFLOP/s float64 (67 TFLOP/s float32).
// The design keeps every intermediate in shared memory (one HBM read of
// the input, one write of the mask) and reads the halo in place instead of
// materializing a window stack as the TPU line kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 51;
constexpr int kHalf = kBlock / 2;
constexpr int kTH = 32;                 // output rows per block
constexpr int kTW = 64;                 // output cols per block
constexpr int kInH = kTH + 2 * kHalf;   // 82 staged rows
constexpr int kInW = kTW + 2 * kHalf;   // 114 staged cols
constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
binarize_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                const double* __restrict__ taps, int h, int w, int channels) {
  __shared__ double s_taps[kBlock];
  __shared__ uint8_t s_gray[kInH][kInW];
  __shared__ double s_vert[kTH][kInW];

  const int img = blockIdx.z;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)h * (size_t)w;

  if (tid < kBlock) s_taps[tid] = taps[tid];

  // stage the tile plus halo, replicate border at this image's own edges;
  // RGB input is converted with cv2 5.x's 15-bit fixed-point weights
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int gy = clampi(y0 + r - kHalf, 0, h - 1);
    const int gx = clampi(x0 + c - kHalf, 0, w - 1);
    const size_t p = (size_t)img * plane + (size_t)gy * w + gx;
    uint8_t g;
    if (channels == 3) {
      const uint8_t* px = src + 3 * p;
      g = (uint8_t)((px[0] * 9798 + px[1] * 19235 + px[2] * 3735 + 16384)
                    >> 15);
    } else {
      g = src[p];
    }
    s_gray[r][c] = g;
  }
  __syncthreads();

  // vertical pass (rows of the 51-tap window): every staged column
  for (int i = tid; i < kTH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    double acc = __dmul_rn(s_taps[0], (double)s_gray[r][c]);
    for (int t = 1; t < kBlock; ++t)
      acc = __dadd_rn(acc, __dmul_rn((double)s_gray[r + t][c], s_taps[t]));
    s_vert[r][c] = acc;
  }
  __syncthreads();

  // horizontal pass, round, threshold, store
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW, c = i % kTW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    double acc = __dmul_rn(s_vert[r][c], s_taps[0]);
    for (int t = 1; t < kBlock; ++t)
      acc = __dadd_rn(acc, __dmul_rn(s_vert[r][c + t], s_taps[t]));
    double mean = rint(acc);
    mean = mean < 0.0 ? 0.0 : (mean > 255.0 ? 255.0 : mean);
    const double g = (double)s_gray[r + kHalf][c + kHalf];
    dst[(size_t)img * plane + (size_t)gy * w + gx] =
        g > mean - 13.0 ? 255 : 0;
  }
}

}  // namespace

extern "C" {

// src: (n, h, w, channels) uint8, channels 1 or 3; dst: (n, h, w) uint8;
// taps: 51 float64. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() of the launch.
int ocr_binarize(const void* src, void* dst, const void* taps, int n, int h,
                 int w, int channels, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (channels != 1 && channels != 3) return (int)cudaErrorInvalidValue;
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, n);
  binarize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, (const double*)taps, h, w,
      channels);
  return (int)cudaGetLastError();
}

}  // extern "C"
