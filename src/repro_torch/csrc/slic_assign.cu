// SLIC assignment: each pixel's label is the argmin of the joint feature +
// weighted spatial squared distance over the centers of its 3x3 grid-cell
// neighbourhood.
//
// Replaces src/repro/kernels/slic_assign.py::slic_assign_pallas (body
// _slic_assign_kernel), with the public layout of
// src/repro/superpixel/slic.py::assign_ref: img (H, W, D) float32
// channels-last, centers (K, D + 2) float32 rows [features..., y, x] on a
// (gy, gx) grid, -> (H, W) int32. The TPU kernel scores every pixel of a
// (rows, 128) tile against all K centers, masks the ones outside the pixel's
// 3x3 cell neighbourhood to +inf and takes an argmin over the padded lanes:
// gather-free, as the TPU wants. That is not carried over: here each thread
// scores only its nine candidates.
//
// What bounds it on an H100: memory. A pixel's D features are read once and
// its label written once, H * W * (4 D + 4) B in all; nine candidates cost
// about 9 (3 D + 8) float operations a pixel, far below the card's rate.
//
// Design: one thread per pixel (a grid-stride loop over H * W); the whole
// center table in shared memory (K (D + 2) * 4 B, 5 KB at K = 256, D = 3;
// the wrapper raises past what a block may hold). Bit for bit as assign_ref:
//   - the pixel's cell is (int)(y * inv_sy) and (int)(x * inv_sx), clipped to
//     the grid, with the float32 reciprocals rounded once on the host;
//   - the candidates in assign_ref's order (dy, then dx, each -1, 0, 1, the
//     cell clipped to the grid, so border cells repeat a candidate);
//   - d2 = 0, plus (f - c)^2 for each channel in channel order, plus
//     sw * (y - cy)^2, plus sw * (x - cx)^2, each square a product and each
//     sum rounded on its own (--fmad=false);
//   - a strict < running minimum, so a tie keeps the earlier candidate, the
//     lowest index among the distinct ones.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// pixels a thread handles, through the grid-stride loop
constexpr int kPixelsPerThread = 4;
// shared memory a block may use on Hopper (227 KB)
constexpr int kMaxCenterBytes = 232448;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ int clip(int a, int hi) {
  return a < 0 ? 0 : a > hi ? hi : a;
}

__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ img, int h, int w, int d,
                   const float* __restrict__ centers, int gy, int gx,
                   float inv_sy, float inv_sx, float sw,
                   int* __restrict__ out) {
  extern __shared__ float cs[];
  const int row = d + 2;
  const int n_center_vals = gy * gx * row;
  for (int i = threadIdx.x; i < n_center_vals; i += kThreads)
    cs[i] = centers[i];
  __syncthreads();

  const long long n = (long long)h * w;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < n;
       p += stride) {
    const int py = (int)(p / w);
    const int px = (int)(p - (long long)py * w);
    const float y = (float)py;
    const float x = (float)px;
    const int pcy = clip((int)(y * inv_sy), gy - 1);
    const int pcx = clip((int)(x * inv_sx), gx - 1);
    const float* f = img + p * d;
    float best_d = kBig;
    int best_k = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      const int cyc = clip(pcy + dy, gy - 1);
      for (int dx = -1; dx <= 1; ++dx) {
        const int cxc = clip(pcx + dx, gx - 1);
        const int kk = cyc * gx + cxc;
        const float* cr = cs + kk * row;
        float d2 = 0.f;
        for (int ch = 0; ch < d; ++ch) {
          const float e = f[ch] - cr[ch];
          d2 = d2 + e * e;
        }
        const float ey = y - cr[d];
        d2 = d2 + sw * (ey * ey);
        const float ex = x - cr[d + 1];
        d2 = d2 + sw * (ex * ex);
        if (d2 < best_d) {
          best_d = d2;
          best_k = kk;
        }
      }
    }
    out[p] = best_k;
  }
}

}  // namespace

extern "C" int slic_max_center_bytes() { return kMaxCenterBytes; }

// img (H, W, D), centers (gy * gx, D + 2) float32, contiguous -> out (H, W)
// int32.
extern "C" int slic_assign(const void* img, int h, int w, int d,
                           const void* centers, int gy, int gx, float inv_sy,
                           float inv_sx, float sw, void* out, void* stream) {
  if (h < 1 || w < 1 || d < 1 || gy < 1 || gx < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)gy * gx * (d + 2) * sizeof(float);
  if (smem > kMaxCenterBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slic_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)h * w;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  slic_assign_kernel<<<blocks, kThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(
      (const float*)img, h, w, d, (const float*)centers, gy, gx, inv_sy,
      inv_sx, sw, (int*)out);
  return (int)cudaGetLastError();
}
