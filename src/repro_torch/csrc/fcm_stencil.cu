// Whole-solve FCM_S: every lane's complete Eq. 4' / Eq. 3' fixed point in one
// launch, for slices and small volumes.
//
// Replaces src/repro/kernels/fcm_resident.py::resident_stencil_solve_pallas
// (body _resident_stencil_kernel): the TPU kernel holds a lane's padded grid,
// its validity sheet, the hoisted neighborhood fields and the (c, *grid)
// membership temporaries in VMEM and runs the lax.while_loop over the
// stencil step inside the kernel, to max|v' - v| < tol or max_iters. Hopper
// has no VMEM of that size: here nothing of the grid stays on chip between
// iterations, and no (c, N) field exists at all.
//
// Design: the design of fcm_streamed.cu, with the stencil in the row math.
// One thread-block cluster a lane (cudaLaunchKernelEx with a cluster
// dimension), of at most 8 blocks, the portable cluster size; the block count
// comes from the lane's pixel count alone (a block for each 4096 pixels), so
// a lane's reduction order, and every bit of its result, do not depend on the
// other lanes of its launch. Each block owns a contiguous range of the lane's
// pixels in raster order (a band of rows of a slice, or of slices of a
// volume). One iteration:
//   1. every thread walks its pixels (a stride of the block size through the
//      band) and re-reads each pixel and its in-grid neighbors from device
//      memory (after the first pass they come from L1 and the 50 MB L2);
//      it recomputes the stencil sums (count, intensity sum and, per cluster,
//      the squared neighbor distances, in the order of
//      repro_torch.core.spatial.neighbor_offsets), then
//      x_eff = (x + alpha * (sx / cnt)) / (1 + alpha), the effective distance
//      (v_j - x)^2 + alpha * (nb_j / cnt), the Eq. 4 membership with the
//      1e-12 floor and the even split over zero distances, u^m, and adds
//      u^m * x_eff and u^m into its 2c sums: the term order of the plain
//      version (kernels/fcm_stencil.py::stencil_solve_plain, the reference
//      form of Eq. 3', with x_eff hoisted out of the loop there);
//   2. each warp folds the sums with a fixed shuffle tree, the block adds its
//      warps in warp order and publishes the result in its shared memory, in
//      one of two buffers chosen by iteration parity;
//   3. after one cluster barrier every block reads all blocks' partials
//      through distributed shared memory, adds them in rank order and forms
//      v' = num / max(den, 1e-12) and delta = max|v' - v| (NaN-propagating).
//      All blocks compute the same sums in the same order, so they hold
//      bit-identical centers, delta and iteration count, and the loop test
//      agrees across the cluster.
// No float atomics: a run repeats bit for bit. The pixel sums run in another
// order than the plain version's, so centers agree to rounding, not bitwise.
//
// What bounds it on an H100: operations, and the serial chain of iterations.
// A lane's pixels are read once (4 B each) but every iteration costs about
// c (3 k + 14) float operations a pixel for k neighbors; and one lane uses at
// most 8 SMs, so a single large lane leaves the card mostly idle. That is why
// the dispatch bound (kernels/fcm_stencil.py::STENCIL_MAX_PIXELS) sends lanes
// past it to the per-iteration step kernels of fcm_spatial.cu, which spread
// one lane over every SM.
//
// Bounds: pixels <= 2^20 a lane, c <= 8, 2-D (4 or 8 neighbors) or 3-D (6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fcm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPixels = 1 << 20;
constexpr int kMaxC = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size
// a block gets at least this many pixels before the lane's cluster grows
constexpr int kMinPixelsPerBlock = 4096;

// max that propagates NaN, like jnp.max and torch.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__host__ __device__ constexpr int threads_for(int ct) {
  return ct <= 4 ? 1024 : 512;
}

// neighbor deltas (dz, dy, dx) in neighbor_offsets order: the neighbor of
// offset o sits at i - o (the 3-D tables end in two unused zero entries, so
// every table has the 2-D arity's length)
__device__ __constant__ int kD2y[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__device__ __constant__ int kD2x[8] = {0, 0, 1, -1, 1, -1, 1, -1};
__device__ __constant__ int kD3z[8] = {1, -1, 0, 0, 0, 0, 0, 0};
__device__ __constant__ int kD3y[8] = {0, 0, 1, -1, 0, 0, 0, 0};
__device__ __constant__ int kD3x[8] = {0, 0, 0, 0, 1, -1, 0, 0};

template <int CT>
__global__ void __launch_bounds__(threads_for(CT))
stencil_solve_kernel(const float* __restrict__ x, const float* __restrict__ v0,
                     const float* __restrict__ tol, int depth, int h, int w,
                     int c, int neighbors, float alpha, float one_alpha,
                     float m, float expo, int max_iters,
                     float* __restrict__ v_out, float* __restrict__ delta_out,
                     int* __restrict__ iters_out) {
  constexpr int kThreads = threads_for(CT);
  constexpr int kWarps = kThreads / 32;
  constexpr int kSums = 2 * CT;  // CT numerators, then CT denominators
  __shared__ float v_s[CT];
  __shared__ float part[kWarps][kSums];
  __shared__ float pub[2][kSums];  // this block's partials, by parity
  __shared__ float tot[kSums];
  __shared__ float delta_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const bool m_is_2 = (m == 2.0f);
  const bool three_d = neighbors == 6;
  const int plane = h * w;
  const int n = depth * plane;

  // this block's contiguous band [p0, p1) of the lane's pixels
  const int per = (n + n_ranks - 1) / n_ranks;
  const int p0 = min(n, rank * per);
  const int p1 = min(n, p0 + per);
  const float* xl = x + (long long)lane * n;

  for (int j = tid; j < CT; j += kThreads)
    v_s[j] = j < c ? v0[(long long)lane * c + j] : 0.f;
  const float tl = tol[lane];
  __syncthreads();

  float delta = INFINITY;
  int it = 0;
  int par = 0;
  while (delta >= tl && it < max_iters) {
    float num[CT];
    float den[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) num[j] = den[j] = 0.f;

    for (int p = p0 + tid; p < p1; p += kThreads) {
      const int z = p / plane;
      const int rem = p - z * plane;
      const int y = rem / w;
      const int xc = rem - y * w;
      const float xi = xl[p];
      float cnt = 0.f;
      float sx = 0.f;
      float nb[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) nb[j] = 0.f;
      for (int o = 0; o < neighbors; ++o) {
        const int dz = three_d ? kD3z[o] : 0;
        const int dy = three_d ? kD3y[o] : kD2y[o];
        const int dx = three_d ? kD3x[o] : kD2x[o];
        const int zz = z + dz;
        const int yy = y + dy;
        const int xx = xc + dx;
        if (zz < 0 || zz >= depth || yy < 0 || yy >= h || xx < 0 || xx >= w)
          continue;
        const float xs = xl[p + dz * plane + dy * w + dx];
        cnt = cnt + 1.0f;
        sx = sx + xs;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < c) {
            const float e = v_s[j] - xs;
            nb[j] = nb[j] + e * e;
          }
        }
      }
      cnt = cnt < 1.0f ? 1.0f : cnt;
      const float x_eff = (xi + alpha * (sx / cnt)) / one_alpha;
      float u[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float s = 0.f;
        if (j < c) {
          const float e = v_s[j] - xi;
          s = e * e + alpha * (nb[j] / cnt);
        }
        u[j] = s;
      }
      fcm::membership_from_d2<CT>(c, m_is_2, expo, u);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j < c) {
          const float um = m_is_2 ? u[j] * u[j] : powf(u[j], m);
          num[j] = num[j] + um * x_eff;
          den[j] = den[j] + um;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (j < c) {  // uniform across the block: every lane shuffles
        float a = num[j];
        float b = den[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a = a + __shfl_down_sync(0xffffffffu, a, off);
          b = b + __shfl_down_sync(0xffffffffu, b, off);
        }
        if (lid == 0) {
          part[wid][j] = a;
          part[wid][CT + j] = b;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kSums; i += kThreads) {
      float s = part[0][i];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s = s + part[q][i];
      pub[par][i] = s;
    }
    cluster.sync();  // every block's partials of this iteration are published

    if (wid == 0) {
      for (int i = lid; i < kSums; i += 32) {
        float s = cluster.map_shared_rank(&pub[par][0], 0)[i];
        for (int r = 1; r < n_ranks; ++r)
          s = s + cluster.map_shared_rank(&pub[par][0], r)[i];
        tot[i] = s;
      }
      __syncwarp();
      float dmax = 0.f;
      for (int j = lid; j < c; j += 32) {
        const float vn = tot[j] / fcm::floor_at(tot[CT + j]);
        dmax = nan_max(dmax, fabsf(vn - v_s[j]));
        v_s[j] = vn;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dmax = nan_max(dmax, __shfl_down_sync(0xffffffffu, dmax, off));
      if (lid == 0) delta_s = dmax;
    }
    __syncthreads();
    delta = delta_s;
    ++it;
    par ^= 1;
  }
  // No block leaves while another may still read its published partials.
  cluster.sync();

  if (rank == 0) {
    for (int j = tid; j < c; j += kThreads)
      v_out[(long long)lane * c + j] = v_s[j];
    if (tid == 0) {
      delta_out[lane] = delta;
      iters_out[lane] = it;
    }
  }
}

template <int CT>
int launch(const void* x, const void* v0, const void* tol, int n_lanes,
           int depth, int h, int w, int c, int neighbors, float alpha,
           float one_alpha, float m, float expo, int max_iters, void* v_out,
           void* delta_out, void* iters_out, void* stream) {
  constexpr int kThreads = threads_for(CT);
  const int n = depth * h * w;
  // Blocks a lane from its pixels alone, never from the batch or the card,
  // so a lane's bits are the same in any bucket.
  int ranks = (n + kMinPixelsPerBlock - 1) / kMinPixelsPerBlock;
  if (ranks > kMaxCluster) ranks = kMaxCluster;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ranks, (unsigned)n_lanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = stencil_solve_kernel<CT>;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)x, (const float*)v0,
      (const float*)tol, depth, h, w, c, neighbors, alpha, one_alpha, m, expo,
      max_iters, (float*)v_out, (float*)delta_out, (int*)iters_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcm_stencil_max_pixels() { return kMaxPixels; }
extern "C" int fcm_stencil_max_c() { return kMaxC; }

// x (B, D, H, W) float32 contiguous (D = 1 for 2-D lanes), v0 (B, c), tol (B,)
// -> v (B, c), delta (B,) float32, iters (B,) int32. neighbors is 4 or 8 for
// D = 1 lanes, 6 for volumes; alpha and one_alpha are the float32 alpha and
// 1 + alpha; expo is the float32 exponent -1/(m-1).
extern "C" int fcm_stencil_solve(const void* x, const void* v0, const void* tol,
                                 int n_lanes, int depth, int h, int w, int c,
                                 int neighbors, float alpha, float one_alpha,
                                 float m, float expo, int max_iters,
                                 void* v_out, void* delta_out, void* iters_out,
                                 void* stream) {
  const long long n = (long long)depth * h * w;
  if (n_lanes < 1 || n_lanes > 65535 || depth < 1 || h < 1 || w < 1 ||
      n > kMaxPixels || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  if (!(neighbors == 6 || (depth == 1 && (neighbors == 4 || neighbors == 8))))
    return (int)cudaErrorInvalidValue;
  if (c <= 4)
    return launch<4>(x, v0, tol, n_lanes, depth, h, w, c, neighbors, alpha,
                     one_alpha, m, expo, max_iters, v_out, delta_out,
                     iters_out, stream);
  return launch<8>(x, v0, tol, n_lanes, depth, h, w, c, neighbors, alpha,
                   one_alpha, m, expo, max_iters, v_out, delta_out, iters_out,
                   stream);
}
