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
// Design: a block of 256 threads owns a 32 x 8 tile of the image, one thread
// a pixel, whose (y, x) come from the block and thread indices (no division).
// At 512 x 512 that is 1 024 blocks, about one full wave. A block stages
// only the center rows its pixels can name: the cell window from
// clip(cell(y0) - 1) to clip(cell(y1) + 1), and the same in x, with cell()
// the float32 rule below; cell() is monotone in y and x, so the tile's first
// and last pixels bound the cell of every pixel inside
// (kernels/slic_assign.py::tile_cell_window is its host twin). A window row
// of the grid is a contiguous run of the center table, which one warp copies.
// A warp's pixels are one image row of the tile, a contiguous run of 32 D
// floats: its D channel loads together read that run once, coalesced, so the
// features need no staging. D is a compile-time tier (1, 3, or a runtime loop
// for any other D), so the channel loops unroll. Bit for bit as assign_ref:
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
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
// shared memory a block may use on Hopper (227 KB)
constexpr int kMaxSmemBytes = 232448;
// the cells a window may span beyond the tile's pixel extent along an axis:
// one on each side for the 3x3 neighbourhood, and the float32 rule's
// rounding (see window_span)
constexpr int kWindowSlack = 5;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ int clip(int a, int hi) {
  return a < 0 ? 0 : a > hi ? hi : a;
}

// The cell of pixel coordinate p: (int)(p * inv) in float32, clipped.
__device__ __forceinline__ int cell_of(int p, float inv, int g) {
  return clip((int)((float)p * inv), g - 1);
}

// The most cells of one axis a tile of t pixels can name: its pixels' cells
// differ by at most floor((t - 1) * inv) + 2 (the exact span plus one for
// each end's truncation and rounding), plus one neighbour on each side; never
// more than the g cells of the axis.
inline int window_span(int t, float inv, int g) {
  const double span = floor((double)(t - 1) * (double)inv) + kWindowSlack;
  return span < (double)g ? (int)span : g;
}

size_t smem_bytes(int d, int gy, int gx, float inv_sy, float inv_sx) {
  const size_t win = (size_t)window_span(kTileH, inv_sy, gy) *
                     window_span(kTileW, inv_sx, gx) * (d + 2);
  return win * sizeof(float);
}

// DT: the channel count, or 0 for a runtime d.
template <int DT>
__global__ void __launch_bounds__(kThreads)
slic_tile_kernel(const float* __restrict__ img, int h, int w, int d_rt,
                 const float* __restrict__ centers, int gy, int gx,
                 float inv_sy, float inv_sx, float sw, int* __restrict__ out) {
  extern __shared__ float win[];             // (ny, nx, d + 2)
  const int d = DT > 0 ? DT : d_rt;
  const int row = d + 2;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int x1 = min(x0 + kTileW, w) - 1;    // the tile's last pixel
  const int y1 = min(y0 + kTileH, h) - 1;
  const int cy0 = clip(cell_of(y0, inv_sy, gy) - 1, gy - 1);
  const int cy1 = clip(cell_of(y1, inv_sy, gy) + 1, gy - 1);
  const int cx0 = clip(cell_of(x0, inv_sx, gx) - 1, gx - 1);
  const int cx1 = clip(cell_of(x1, inv_sx, gx) + 1, gx - 1);
  const int nx = cx1 - cx0 + 1;
  const int span = nx * row;                 // one window row, contiguous
  const int ly = threadIdx.x / kTileW;       // the warp
  const int lx = threadIdx.x % kTileW;
  for (int r = ly; r <= cy1 - cy0; r += kTileH) {
    const float* src = centers + (long long)((cy0 + r) * gx + cx0) * row;
    for (int q = lx; q < span; q += kTileW) win[r * span + q] = src[q];
  }
  __syncthreads();
  const int py = y0 + ly;
  const int px = x0 + lx;
  if (py > y1 || px > x1) return;

  const float y = (float)py;
  const float x = (float)px;
  const int pcy = cell_of(py, inv_sy, gy);
  const int pcx = cell_of(px, inv_sx, gx);
  const float* f = img + ((long long)py * w + px) * d;
  float best_d = kBig;
  int best_k = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int cyc = clip(pcy + dy, gy - 1);
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int cxc = clip(pcx + dx, gx - 1);
      const float* cr = win + ((cyc - cy0) * nx + (cxc - cx0)) * row;
      float d2 = 0.f;
      if constexpr (DT > 0) {
#pragma unroll
        for (int ch = 0; ch < DT; ++ch) {
          const float e = f[ch] - cr[ch];
          d2 = d2 + e * e;
        }
      } else {
        for (int ch = 0; ch < d; ++ch) {
          const float e = f[ch] - cr[ch];
          d2 = d2 + e * e;
        }
      }
      const float ey = y - cr[d];
      d2 = d2 + sw * (ey * ey);
      const float ex = x - cr[d + 1];
      d2 = d2 + sw * (ex * ex);
      if (d2 < best_d) {
        best_d = d2;
        best_k = cyc * gx + cxc;
      }
    }
  }
  out[(long long)py * w + px] = best_k;
}

template <int DT>
int launch(const void* img, int h, int w, int d, const void* centers, int gy,
           int gx, float inv_sy, float inv_sx, float sw, size_t smem,
           void* out, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slic_tile_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH));
  slic_tile_kernel<DT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)img, h, w, d, (const float*)centers, gy, gx, inv_sy,
      inv_sx, sw, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slic_max_center_bytes() { return kMaxSmemBytes; }
extern "C" int slic_tile_w() { return kTileW; }
extern "C" int slic_tile_h() { return kTileH; }
extern "C" int slic_window_slack() { return kWindowSlack; }

// img (H, W, D), centers (gy * gx, D + 2) float32, contiguous -> out (H, W)
// int32. inv_sy, inv_sx: the float32 reciprocals of the cell sizes.
extern "C" int slic_assign(const void* img, int h, int w, int d,
                           const void* centers, int gy, int gx, float inv_sy,
                           float inv_sx, float sw, void* out, void* stream) {
  if (h < 1 || w < 1 || d < 1 || gy < 1 || gx < 1 || h > 65535 * kTileH ||
      !(inv_sy > 0.f) || !(inv_sx > 0.f))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, gy, gx, inv_sy, inv_sx);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 1:
      return launch<1>(img, h, w, d, centers, gy, gx, inv_sy, inv_sx, sw, smem,
                       out, stream);
    case 3:
      return launch<3>(img, h, w, d, centers, gy, gx, inv_sy, inv_sx, sw, smem,
                       out, stream);
    default:
      return launch<0>(img, h, w, d, centers, gy, gx, inv_sy, inv_sx, sw, smem,
                       out, stream);
  }
}
