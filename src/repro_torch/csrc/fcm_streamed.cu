// HBM-streamed whole-solve weighted FCM: every lane's complete fixed point in
// one launch, for lanes with far more rows than one block holds in registers.
//
// Replaces src/repro/kernels/fcm_resident.py::resident_streamed_solve_pallas
// (body _streamed_kernel): the TPU kernel keeps a lane's centers and Eq. 3
// partial sums in VMEM and, on every iteration of its lax.while_loop, streams
// the lane's rows from HBM in 8-row chunks through a two-slot VMEM buffer,
// stopping at max|v' - v| < tol or max_iters. The TPU's chunking and double
// buffer are not carried over: here every iteration reads the rows from
// device memory, and after the first pass they sit in the 50 MB L2 (a bucket
// of 64 BrainWeb slices, 64 x 39,277 rows x 8 B, is 20 MB).
//
// What bounds it on an H100: operations, not bytes. Each row is read once an
// iteration (4 (D + 1) B) but costs about c (5 D + 7) float operations,
// two of them divisions, and a lane needs tens of iterations; across
// iterations the rows come from L2. Beside that, every iteration ends in a
// reduction that crosses the blocks of the lane, the serial chain that the
// resident kernel (fcm_resident.cu) keeps inside one block.
//
// Design: one thread-block cluster per lane (launched with cudaLaunchKernelEx
// and a cluster-dimension attribute), of at most 8 blocks, the portable
// cluster size; the size is picked from the row count alone (a block for
// each 4096 rows), so a lane's slices, and with them its reduction order
// and every bit of its result, do not depend on the other lanes of its
// launch. A bucket of one spreads its rows over 8 SMs; clusters past the
// first wave queue. Each block owns a contiguous slice of the lane's rows.
// One iteration:
//   1. every thread computes, for each of its rows (a stride of the block
//      size through the slice, in order), the Eq. 4 membership with the 1e-12
//      distance floor and the even split over zero-distance centers, u^m * w,
//      and adds u^m * w * x and u^m * w into its c * (D + 1) partial sums;
//   2. each warp folds the sums with a fixed shuffle tree into shared memory;
//      the block adds its warps in warp order and publishes the result in its
//      own shared memory, in one of two buffers chosen by iteration parity;
//   3. after one cluster barrier every block reads all blocks' partials
//      through distributed shared memory (cluster.map_shared_rank), adds them
//      in rank order and forms v' = num / max(den, 1e-12) and delta =
//      max|v' - v| (NaN-propagating). Every block computes the same sums in
//      the same order, so all blocks hold bit-identical centers and delta and
//      the loop test agrees across the cluster. The parity buffers let a block
//      publish iteration i + 1 while a slower one still reads iteration i: no
//      block can publish i + 2 before every block has passed barrier i + 1.
// A last cluster barrier keeps every block alive until no block reads its
// shared memory any more. No float atomics: a run repeats bit for bit. The
// reduction order differs from the plain version's, so centers agree to
// rounding, not bitwise.
//
// Per-row math as fcm_resident.cu: with m == 2, d^(-1) as 1 / d and u^2 as
// u * u; other m use powf with the float32 exponents -1/(m-1) and m; the
// library is compiled with --fmad=false.
//
// Bounds: rows <= 2^20 a lane (a wall-clock choice covering the paper's
// 1000 KB image, 1,024,000 rows; offsets are 64-bit), c <= 8, D <= 16. Each
// thread's sums live in registers, sized by cluster-count tiers (4, 8) and
// feature tiers (1, 3, 8, 16) instantiated as templates, so D = 1 does not
// pay for D = 16; the block size shrinks as the sums grow (1024 threads up to
// 16 sums a thread, 512 up to 48, else 256). Padded feature slots hold 0 in
// both the rows and the centers, which adds exactly 0 to every distance.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 1 << 20;
constexpr int kMaxC = 8;
constexpr int kMaxFeat = 16;
constexpr int kMaxCluster = 8;  // the portable cluster size
// a block gets at least this many rows before the lane's cluster grows
constexpr int kMinRowsPerBlock = 4096;
constexpr float kFloor = 1e-12f;

// max that propagates NaN, like jnp.max and torch.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// max(a, floor) that propagates NaN, like jnp.maximum / torch.clamp
__device__ __forceinline__ float floor_at(float a) {
  return a < kFloor ? kFloor : a;
}

// threads a block, from the partial sums a thread keeps in registers
__host__ __device__ constexpr int threads_for(int n_sums) {
  return n_sums <= 16 ? 1024 : n_sums <= 48 ? 512 : 256;
}

template <int CT, int DT>
__global__ void __launch_bounds__(threads_for(CT * (DT + 1)))
streamed_solve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ v0,
                      const float* __restrict__ tol, int k, int d, int c,
                      float m, float expo, int max_iters,
                      float* __restrict__ v_out, float* __restrict__ delta_out,
                      int* __restrict__ iters_out) {
  constexpr int kAcc = DT + 1;  // DT numerator sums and one denominator sum
  constexpr int kSums = CT * kAcc;
  constexpr int kThreads = threads_for(kSums);
  constexpr int kWarps = kThreads / 32;
  __shared__ float v_s[CT * DT];
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
  const int n_sums = c * kAcc;

  // this block's contiguous slice [r0, r1) of the lane's rows
  const int per = (k + n_ranks - 1) / n_ranks;
  const int r0 = min(k, rank * per);
  const int r1 = min(k, r0 + per);
  const float* xl = x + (long long)lane * k * d;
  const float* wl = w + (long long)lane * k;

  for (int i = tid; i < CT * DT; i += kThreads) {
    const int j = i / DT;
    const int dd = i - j * DT;
    v_s[i] = (j < c && dd < d) ? v0[((long long)lane * c + j) * d + dd] : 0.f;
  }
  const float tl = tol[lane];
  __syncthreads();

  float delta = INFINITY;
  int it = 0;
  int par = 0;
  while (delta >= tl && it < max_iters) {
    float acc[CT][kAcc];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[j][a] = 0.f;

    for (int row = r0 + tid; row < r1; row += kThreads) {
      const float* xp = xl + (long long)row * d;
      float xr[DT];
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) xr[dd] = dd < d ? xp[dd] : 0.f;
      const float wr = wl[row];
      float d2[CT];
      int n_zero = 0;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float s = 0.f;
        if (j < c) {
#pragma unroll
          for (int dd = 0; dd < DT; ++dd) {
            const float e = v_s[j * DT + dd] - xr[dd];
            s = s + e * e;
          }
          if (s <= 0.f) ++n_zero;
        }
        d2[j] = s;
      }
      float u[CT];
      if (n_zero > 0) {
        const float share = 1.0f / (float)n_zero;
#pragma unroll
        for (int j = 0; j < CT; ++j) u[j] = d2[j] <= 0.f ? share : 0.f;
      } else {
        float p[CT];
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < c) {
            const float dj = floor_at(d2[j]);
            p[j] = m_is_2 ? 1.0f / dj : powf(dj, expo);
            ps = ps + p[j];
          } else {
            p[j] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) u[j] = p[j] / ps;
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j < c) {
          const float um = (m_is_2 ? u[j] * u[j] : powf(u[j], m)) * wr;
#pragma unroll
          for (int dd = 0; dd < DT; ++dd) acc[j][dd] = acc[j][dd] + um * xr[dd];
          acc[j][DT] = acc[j][DT] + um;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (j < c) {  // uniform across the block: every lane shuffles
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          float s = acc[j][a];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s = s + __shfl_down_sync(0xffffffffu, s, off);
          if (lid == 0) part[wid][j * kAcc + a] = s;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < n_sums; i += kThreads) {
      float s = part[0][i];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s = s + part[q][i];
      pub[par][i] = s;
    }
    cluster.sync();  // every block's partials of this iteration are published

    if (wid == 0) {
      for (int i = lid; i < n_sums; i += 32) {
        float s = cluster.map_shared_rank(&pub[par][0], 0)[i];
        for (int r = 1; r < n_ranks; ++r)
          s = s + cluster.map_shared_rank(&pub[par][0], r)[i];
        tot[i] = s;
      }
      __syncwarp();
      float dmax = 0.f;
      for (int i = lid; i < c * DT; i += 32) {
        const int j = i / DT;
        const int dd = i - j * DT;
        if (dd < d) {
          const float vn = tot[j * kAcc + dd] / floor_at(tot[j * kAcc + DT]);
          dmax = nan_max(dmax, fabsf(vn - v_s[i]));
          v_s[i] = vn;
        }
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
    for (int i = tid; i < c * d; i += kThreads) {
      const int j = i / d;
      const int dd = i - j * d;
      v_out[(long long)lane * c * d + i] = v_s[j * DT + dd];
    }
    if (tid == 0) {
      delta_out[lane] = delta;
      iters_out[lane] = it;
    }
  }
}

template <int CT, int DT>
int launch(const void* x, const void* w, const void* v0, const void* tol,
           int n_lanes, int k, int d, int c, float m, float expo,
           int max_iters, void* v_out, void* delta_out, void* iters_out,
           void* stream) {
  constexpr int kThreads = threads_for(CT * (DT + 1));
  auto kernel = streamed_solve_kernel<CT, DT>;
  // Blocks a lane from its rows alone, never from the batch or the card,
  // so a lane's bits are the same in any bucket.
  int ranks = (k + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
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
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)x, (const float*)w, (const float*)v0,
      (const float*)tol, k, d, c, m, expo, max_iters, (float*)v_out,
      (float*)delta_out, (int*)iters_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcm_streamed_max_rows() { return kMaxRows; }
extern "C" int fcm_streamed_max_c() { return kMaxC; }
extern "C" int fcm_streamed_max_feat() { return kMaxFeat; }

// x (B, K, D), w (B, K), v0 (B, c, D), tol (B,) float32, all contiguous ->
// v (B, c, D), delta (B,) float32, iters (B,) int32.
extern "C" int fcm_streamed_solve(const void* x, const void* w, const void* v0,
                                  const void* tol, int n_lanes, int k, int d,
                                  int c, float m, float expo, int max_iters,
                                  void* v_out, void* delta_out,
                                  void* iters_out, void* stream) {
  if (n_lanes < 1 || n_lanes > 65535 || k < 1 || k > kMaxRows || c < 1 ||
      c > kMaxC || d < 1 || d > kMaxFeat)
    return (int)cudaErrorInvalidValue;
#define REPRO_CASE(CC, DD)                                                  \
  return launch<CC, DD>(x, w, v0, tol, n_lanes, k, d, c, m, expo,           \
                        max_iters, v_out, delta_out, iters_out, stream);
  const int dt = d <= 1 ? 1 : d <= 3 ? 3 : d <= 8 ? 8 : 16;
  if (c <= 4) {
    switch (dt) {
      case 1: REPRO_CASE(4, 1)
      case 3: REPRO_CASE(4, 3)
      case 8: REPRO_CASE(4, 8)
      default: REPRO_CASE(4, 16)
    }
  }
  switch (dt) {
    case 1: REPRO_CASE(8, 1)
    case 3: REPRO_CASE(8, 3)
    case 8: REPRO_CASE(8, 8)
    default: REPRO_CASE(8, 16)
  }
#undef REPRO_CASE
}
