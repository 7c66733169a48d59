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
// iteration (4 (D + 1) B) but costs about c (5 D + 7) float operations, two
// of them IEEE divisions of about ten instructions each, and every iteration
// ends in a reduction across the blocks of the lane. So the design's aim is
// to keep every SM issuing: all blocks of a launch resident at once, each
// with enough warps, and a cross-block reduction short next to the row work.
//
// Design: a cooperative launch (cudaLaunchAttributeCooperative, so the
// runtime refuses a grid whose blocks cannot all be resident at once) of
// 256-thread blocks. A lane takes `ranks` blocks, each a contiguous slice of
// its rows; ranks comes from the lane's row count and feature tier alone (a
// block for each rows_per_block(DT) rows, at most kMaxRanks), never from the
// batch or the card, so a lane's slices, its reduction order and every bit
// of its result are the same alone and in any bucket. The grid holds
// lanes_per_round groups of `ranks` blocks; group g solves lanes g, g +
// lanes_per_round, ... in turn (rounds), so a bucket larger than the card's
// resident blocks runs in rounds inside the one launch while the
// decomposition and the fold order never depend on the grid.
// (kernels/fcm_resident.py::streamed_plan picks ranks and lanes_per_round
// from the rows, the SM count and the occupancy this library reports.)
// One iteration of a lane:
//   1. every thread computes, for each of its rows (a stride of 256 through
//      its block's slice, in order, the loads of kAhead rows issued before
//      their math), the Eq. 4 membership with the 1e-12 distance floor and
//      the even split over zero-distance centers, u^m * w, and adds u^m * w *
//      x and u^m * w into its c * (D + 1) partial sums;
//   2. each warp folds the sums with a fixed shuffle tree into shared memory;
//      the block adds its warps in warp order and writes the result to its
//      rank's row of the lane's partials in device memory, in one of two
//      buffers chosen by iteration parity;
//   3. the block arrives at the lane's barrier (an integer counter: an add
//      with release semantics, then acquire loads) and waits until all
//      `ranks` blocks of the lane have arrived for this iteration. Every block is resident (the
//      cooperative launch guarantees it) and waits only on blocks of its own
//      group, so the wait cannot deadlock;
//   4. every block reads all ranks' partials from L2 and adds them in a fixed
//      order (warp w takes sums w, w + 8, ...; lane l adds ranks l, l + 32,
//      ... in order, then a shuffle tree), forms v' = num / max(den, 1e-12)
//      and delta = max|v' - v| (NaN-propagating). Every block computes the
//      same sums in the same order, so all hold bit-identical centers and
//      delta and the loop test agrees across the lane. The parity buffers
//      let a block publish iteration i + 1 while a slower one still reads
//      iteration i: no block can publish i + 2 before every block has
//      arrived at barrier i + 1.
// The counters (two ints a lane: arrivals, departures) are zero on entry; the
// last block of a lane to leave sets both back to zero, so the wrapper keeps
// one zeroed buffer per stream and never clears it. No float atomics: a run
// repeats bit for bit. The reduction order differs from the plain version's,
// so centers agree to rounding, not bitwise.
//
// Per-row math as fcm_resident.cu: with m == 2, d^(-1) as 1 / d and u^2 as
// u * u; other m use powf with the float32 exponents -1/(m-1) and m; the
// library is compiled with --fmad=false.
//
// Bounds: rows <= 2^20 a lane (a wall-clock choice covering the paper's
// 1000 KB image, 1,024,000 rows; offsets are 64-bit), c <= 8, D <= 16. Each
// thread's sums live in registers, sized by cluster-count tiers (4, 8) and
// feature tiers (1, 3, 8, 16) instantiated as templates, so D = 1 does not
// pay for D = 16. __launch_bounds__ asks for 4 blocks an SM up to 16 sums a
// thread (64 registers: a 64-lane bucket of BrainWeb slices, 8 blocks a lane,
// is 512 blocks, within 132 x 4), 2 up to 36, else 1. Padded feature slots
// hold 0 in both the rows and the centers, which adds exactly 0 to every
// distance.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "fcm_common.cuh"

namespace {

constexpr int kMaxRows = 1 << 20;
constexpr int kMaxC = 8;
constexpr int kMaxFeat = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the most blocks a lane takes: on any card of at least 128 SMs one block an
// SM, whatever the tier's occupancy
constexpr int kMaxRanks = 128;

// rows a block, by feature tier: about the same float work a block (a row
// costs about c (5 D + 7) operations), and at D = 1 few enough blocks that a
// 64-lane bucket of BrainWeb slices (39,277 rows a lane) is resident at once
__host__ __device__ constexpr int rows_per_block(int dt) {
  return dt <= 1 ? 5120 : dt <= 3 ? 2048 : dt <= 8 ? 1024 : 512;
}

// the blocks an SM __launch_bounds__ asks for, from the sums a thread keeps
__host__ __device__ constexpr int min_blocks_for(int n_sums) {
  return n_sums <= 16 ? 4 : n_sums <= 36 ? 2 : 1;
}

int feat_tier(int d) { return d <= 1 ? 1 : d <= 3 ? 3 : d <= 8 ? 8 : 16; }

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One row's Eq. 4 membership and its Eq. 3 terms, added into acc in the
// plain version's order.
template <int CT, int DT, bool M2>
__device__ __forceinline__ void add_row(const float (&xr)[DT], float wr,
                                        const float* __restrict__ v_s, int c,
                                        float m, float expo,
                                        float (&acc)[CT][DT + 1]) {
  float u[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    float s = 0.f;
    if (j < c) {
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) {
        const float e = v_s[j * DT + dd] - xr[dd];
        s = s + e * e;
      }
    }
    u[j] = s;
  }
  fcm::membership_from_d2<CT>(c, M2, expo, u);
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < c) {
      const float um = (M2 ? u[j] * u[j] : powf(u[j], m)) * wr;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[j][dd] = acc[j][dd] + um * xr[dd];
      acc[j][DT] = acc[j][DT] + um;
    }
  }
}

// part (B, 2, ranks, c (d + 1)): a lane's partials by parity and rank, each
// row compact: c groups of d numerators and one denominator. sync (B, 2) int:
// a lane's arrivals and departures. M2 (m == 2) and EXACT (c == CT) are
// compile-time, so the common case carries no powf path and no predicate on
// the cluster index; a tier-1 lane has exactly one feature.
template <int CT, int DT, bool M2, bool EXACT>
__global__ void __launch_bounds__(kThreads, min_blocks_for(CT * (DT + 1)))
streamed_solve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ v0,
                      const float* __restrict__ tol, int n_lanes, int k,
                      int d_in, int c_in, float m, float expo, int max_iters,
                      int ranks, int lanes_per_round, float* __restrict__ part,
                      int* __restrict__ sync, float* __restrict__ v_out,
                      float* __restrict__ delta_out,
                      int* __restrict__ iters_out) {
  constexpr int kAcc = DT + 1;  // DT numerator sums and one denominator sum
  constexpr int kSums = CT * kAcc;
  // rows whose loads a thread issues before their math: two or four rows'
  // values stay in registers beside the sums
  constexpr int kAhead = DT <= 3 ? 4 : DT <= 8 ? 2 : 1;
  __shared__ float v_s[CT * DT];
  __shared__ float warp_s[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ float delta_s;

  const int c = EXACT ? CT : c_in;
  const int d = DT == 1 ? 1 : d_in;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const int group = blockIdx.x / ranks;
  const int rank = blockIdx.x - group * ranks;
  const int n_out = c * (d + 1);  // a compact partials row
  // this block's contiguous slice [r0, r1) of a lane's rows
  const int per = (k + ranks - 1) / ranks;
  const int r0 = min(k, rank * per);
  const int r1 = min(k, r0 + per);

  for (int lane = group; lane < n_lanes; lane += lanes_per_round) {
    const float* xl = x + (long long)lane * k * d;
    const float* wl = w + (long long)lane * k;
    float* lpart = part + (long long)lane * 2 * ranks * n_out;
    int* arrive = sync + 2 * (long long)lane;
    int* leave = arrive + 1;

    __syncthreads();  // the previous lane's last reads of v_s are done
    for (int i = tid; i < CT * DT; i += kThreads) {
      const int j = i / DT;
      const int dd = i - j * DT;
      v_s[i] = (j < c && dd < d) ? v0[((long long)lane * c + j) * d + dd]
                                 : 0.f;
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

      for (int base = r0 + tid; base < r1; base += kAhead * kThreads) {
        float xr[kAhead][DT];
        float wr[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int row = base + q * kThreads;
          const bool in = row < r1;
          const float* xp = xl + (long long)row * d;
#pragma unroll
          for (int dd = 0; dd < DT; ++dd)
            xr[q][dd] = (in && dd < d) ? xp[dd] : 0.f;
          wr[q] = in ? wl[row] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q)
          if (base + q * kThreads < r1)
            add_row<CT, DT, M2>(xr[q], wr[q], v_s, c, m, expo, acc);
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
            if (lid == 0) warp_s[wid][j * kAcc + a] = s;
          }
        }
      }
      __syncthreads();
      float* mine = lpart + ((long long)par * ranks + rank) * n_out;
      for (int i = tid; i < n_out; i += kThreads) {
        const int j = i / (d + 1);
        const int a = i - j * (d + 1);
        const int slot = j * kAcc + (a < d ? a : DT);
        float s = warp_s[0][slot];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) s = s + warp_s[q][slot];
        mine[i] = s;
      }
      // After the barrier thread 0 arrives with release semantics at gpu
      // scope (publishing the block's partials) and waits with acquire loads
      // (seeing every block's).
      __syncthreads();
      if (tid == 0) {
        add_release(arrive, 1);
        const int target = (it + 1) * ranks;
        while (load_acquire(arrive) < target) __nanosleep(32);
      }
      __syncthreads();

      const float* all = lpart + (long long)par * ranks * n_out;
      for (int i = wid; i < n_out; i += kWarps) {  // uniform across the warp
        float s = 0.f;
#pragma unroll 4
        for (int r = lid; r < ranks; r += 32)
          s = s + __ldcg(all + (long long)r * n_out + i);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s = s + __shfl_down_sync(0xffffffffu, s, off);
        if (lid == 0) {
          const int j = i / (d + 1);
          const int a = i - j * (d + 1);
          tot[j * kAcc + (a < d ? a : DT)] = s;
        }
      }
      __syncthreads();
      if (wid == 0) {
        float dmax = 0.f;
        for (int i = lid; i < c * DT; i += 32) {
          const int j = i / DT;
          const int dd = i - j * DT;
          if (dd < d) {
            const float vn =
                tot[j * kAcc + dd] / fcm::floor_at(tot[j * kAcc + DT]);
            dmax = fcm::nan_max(dmax, fabsf(vn - v_s[i]));
            v_s[i] = vn;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dmax = fcm::nan_max(dmax, __shfl_down_sync(0xffffffffu, dmax, off));
        if (lid == 0) delta_s = dmax;
      }
      __syncthreads();
      delta = delta_s;
      ++it;
      par ^= 1;
    }

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
    // The last block of the lane to leave has seen every arrival: it sets the
    // lane's counters back to zero for the next launch on the stream.
    if (tid == 0 && fcm::fetch_add_acq_rel(leave, 1) == ranks - 1) {
      *arrive = 0;
      *leave = 0;
    }
  }
}

template <int CT, int DT>
void* kernel_of(int c, bool m2) {
  if (m2)
    return c == CT ? (void*)streamed_solve_kernel<CT, DT, true, true>
                   : (void*)streamed_solve_kernel<CT, DT, true, false>;
  return c == CT ? (void*)streamed_solve_kernel<CT, DT, false, true>
                 : (void*)streamed_solve_kernel<CT, DT, false, false>;
}

template <int CT>
void* kernel_of_tier(int c, int d, bool m2) {
  const int dt = feat_tier(d);
  return dt == 1 ? kernel_of<CT, 1>(c, m2) : dt == 3 ? kernel_of<CT, 3>(c, m2)
       : dt == 8 ? kernel_of<CT, 8>(c, m2) : kernel_of<CT, 16>(c, m2);
}

// The kernel instance for c clusters, d features and exponent m.
void* kernel_for(int c, int d, float m) {
  return c <= 4 ? kernel_of_tier<4>(c, d, m == 2.0f)
                : kernel_of_tier<8>(c, d, m == 2.0f);
}

bool bad_tier(int c, int d) {
  return c < 1 || c > kMaxC || d < 1 || d > kMaxFeat;
}

}  // namespace

extern "C" int fcm_streamed_max_rows() { return kMaxRows; }
extern "C" int fcm_streamed_max_c() { return kMaxC; }
extern "C" int fcm_streamed_max_feat() { return kMaxFeat; }
extern "C" int fcm_streamed_threads() { return kThreads; }
extern "C" int fcm_streamed_max_ranks() { return kMaxRanks; }

// Rows a block for a lane of d features (the feature tier's rule).
extern "C" int fcm_streamed_rows_per_block(int d) {
  return d < 1 || d > kMaxFeat ? -1 : rows_per_block(feat_tier(d));
}

// The blocks an SM that the (c, d) tier's __launch_bounds__ asks for.
extern "C" int fcm_streamed_min_blocks(int c, int d) {
  if (bad_tier(c, d)) return -1;
  return min_blocks_for((c <= 4 ? 4 : 8) * (feat_tier(d) + 1));
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the kernel that c, d and m
// launch, on the current device, or a negative cudaError_t.
extern "C" int fcm_streamed_blocks_per_sm(int c, int d, float m) {
  if (bad_tier(c, d)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_for(c, d, m), kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// Registers a thread of the kernel that c, d and m launch, or a negative
// cudaError_t.
extern "C" int fcm_streamed_registers(int c, int d, float m) {
  if (bad_tier(c, d)) return -(int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_for(c, d, m));
  return e == cudaSuccess ? a.numRegs : -(int)e;
}

// x (B, K, D), w (B, K), v0 (B, c, D), tol (B,) float32, all contiguous ->
// v (B, c, D), delta (B,) float32, iters (B,) int32. ranks (blocks a lane)
// and lanes_per_round come from kernels/fcm_resident.py::streamed_plan; the
// grid is lanes_per_round * ranks blocks, launched cooperatively (refused
// unless all fit at once). part is scratch of B * 2 * ranks * c * (D + 1)
// floats; sync holds 2B ints that are zero on entry and left zero on exit.
// The grid is 1-D and takes B in rounds, so B has no bound but an int's.
extern "C" int fcm_streamed_solve(const void* x, const void* w, const void* v0,
                                  const void* tol, int n_lanes, int k, int d,
                                  int c, float m, float expo, int max_iters,
                                  int ranks, int lanes_per_round, void* part,
                                  void* sync, void* v_out, void* delta_out,
                                  void* iters_out, void* stream) {
  // a lane's arrival counter reaches max_iters * ranks
  if (n_lanes < 1 || k < 1 || k > kMaxRows ||
      bad_tier(c, d) || ranks < 1 || ranks > kMaxRanks || ranks > k ||
      lanes_per_round < 1 || lanes_per_round > n_lanes || max_iters < 0 ||
      (long long)max_iters * ranks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes_per_round * ranks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&x,         (void*)&w,     (void*)&v0,
                  (void*)&tol,       (void*)&n_lanes, (void*)&k,
                  (void*)&d,         (void*)&c,     (void*)&m,
                  (void*)&expo,      (void*)&max_iters, (void*)&ranks,
                  (void*)&lanes_per_round, (void*)&part, (void*)&sync,
                  (void*)&v_out,     (void*)&delta_out, (void*)&iters_out};
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(c, d, m), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
