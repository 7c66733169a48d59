// Whole-solve weighted FCM: every lane's complete fixed point in one launch.
//
// Replaces src/repro/kernels/fcm_resident.py::resident_solve_pallas (body
// _resident_kernel, membership from fcm_membership.py::membership_from_d2_tile):
// the TPU kernel holds a lane's rows in VMEM and runs the whole
// lax.while_loop of Eq. 4 -> Eq. 3 steps inside one pallas_call, stopping at
// max|v' - v| < tol or max_iters.
//
// What bounds it on an H100: not bytes (a 256-row histogram lane is
// 256 * (D + 1) * 4 B = 2 KiB at D = 1) and not operations (about 30 float
// operations per row, cluster and iteration). The limit is the serial chain
// of one iteration times the iterations of the bucket's slowest lane: a
// per-row pass, a reduction across the block, the new centers and the stop
// test. The lanes run side by side, one block each, so a 64-lane bucket
// takes 64 of the 132 SMs and no SM does more than one lane.
//
// Design: one block of 256 threads per lane on a 1-D grid (any number of
// lanes, one launch). Each thread keeps its rows (row tid + 256 r, r < 4)
// and weights in registers for the whole solve, and so do the centers:
// every thread holds all c * D of them. One iteration:
//   1. every thread computes, for each of its rows in order, d2 to each
//      center, Eq. 4 (fcm::membership_from_d2: the 1e-12 distance floor, the
//      zero test by the minimum and the even split over zero-distance
//      centers), u^m * w, and adds u^m * w * x and u^m * w into its
//      c * (D + 1) sums;
//   2. each warp reduces its sums with __shfl_xor_sync butterflies, so every
//      lane holds the warp's sums, and lane 0 stores them into the shared
//      slot of the iteration's parity;
//   3. one __syncthreads(); then every warp adds the 8 warps' sums in warp
//      order and forms v' = num / max(den, 1e-12) and delta = max|v' - v|
//      (NaN-propagating, as jnp.max) itself: at the tier every thread forms
//      all 4 centers; in the run-time bodies lane i forms center elements i
//      and i + 32, a butterfly takes the warp's max, and shuffles hand each
//      lane the c * D new centers (every thread forming all of them cost
//      14 % at c = 8, D = 3, kernel_ab.py).
// Every warp does the same operations in the same order on the same values
// (and a + b == b + a exactly, so the butterflies leave a warp's lanes
// equal), so every thread holds the same bits and the loop test
// delta >= tol && it < max_iters stays uniform with no second barrier and no
// broadcast across warps. The two parity slots make the one barrier enough:
// a warp stores into a slot again only after the next iteration's barrier,
// which every warp reaches after its reads of that slot.
//
// Forms (resident_plan in kernels/fcm_resident.py picks one from the shape):
// the tier, c == 4, D == 1 and m == 2 compile-time (the paper's
// configuration, which the histogram route runs), with one reciprocal for a
// row's 4 divisions by its sum (fcm::quotient_by, the same bits), and
// run-time bodies for every other c <= 8, D <= 8 (one instance a D) and m.
// 8 warps measured faster than 4 (one an SM sub-partition) on the
// histogram bucket in both forms (kernel_ab.py, PERF.md). Rows a thread at
// most 4, so a lane holds at most 1024 rows; at D = 8 a thread keeps 4 * 8
// row values, 8 * 8 centers and 8 * 9 sums in registers, within the 255 a
// thread may have at 256 threads. Larger flat problems take the
// HBM-streamed solve (fcm_streamed.cu).
//
// The reduction order is fixed (rows a thread in order, the butterfly, the
// warps in order), so a run repeats bit for bit and a lane's bits do not
// depend on its bucket. It differs from the plain version's order, so
// centers agree to rounding, not bitwise. With m == 2 the two powers are
// computed exactly as the plain version does: d^(-1) as 1 / d and u^2 as
// u * u (torch.pow and XLA take the same special cases for exponents -1 and
// 2); other m use powf with the float32 exponents -1/(m-1) and m. The
// library is compiled with --fmad=false so that no multiply-add is
// contracted where the plain version rounds twice.
#include <cuda_runtime.h>
#include <math.h>

#include "fcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kMaxRows = kThreads * kRowsPerThread;
constexpr int kMaxC = 8;

// TIER: c == 4, D == 1 and m == 2 at compile time; else c <= kMaxC and m at
// run time.
template <int D, bool TIER>
__global__ void __launch_bounds__(kThreads)
resident_solve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ v0,
                      const float* __restrict__ tol, int k, int c_rt, float m,
                      float expo, int max_iters, float* __restrict__ v_out,
                      float* __restrict__ delta_out,
                      int* __restrict__ iters_out) {
  constexpr int CM = TIER ? 4 : kMaxC;  // cluster slots held in registers
  constexpr int kAcc = D + 1;           // D numerator sums and one denominator
  constexpr int kSums = CM * kAcc;
  constexpr int kSlot = (kSums + 3) / 4 * 4;  // a warp's sums, whole float4s
  __shared__ __align__(16) float part[2][kWarps][kSlot];

  const int c = TIER ? 4 : c_rt;
  const int cd = c * D;
  const bool m_is_2 = TIER || m == 2.0f;
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;

  float xr[kRowsPerThread][D];
  float wr[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = tid + r * kThreads;
    const bool ok = row < k;
#pragma unroll
    for (int d = 0; d < D; ++d)
      xr[r][d] = ok ? x[(lane * k + row) * D + d] : 0.f;
    wr[r] = ok ? w[lane * k + row] : 0.f;
  }
  const float* v0l = v0 + lane * cd;
  float v[CM][D];
#pragma unroll
  for (int j = 0; j < CM; ++j)
#pragma unroll
    for (int d = 0; d < D; ++d) v[j][d] = j < c ? v0l[j * D + d] : 0.f;
  // run-time bodies: center elements lid and lid + 32, which this lane forms
  float own[2] = {lid < cd ? v0l[lid] : 0.f, lid + 32 < cd ? v0l[lid + 32]
                                                           : 0.f};
  const float tl = tol[lane];

  float delta = INFINITY;
  int it = 0;
  while (delta >= tl && it < max_iters) {
    float acc[CM][kAcc];
#pragma unroll
    for (int j = 0; j < CM; ++j)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[j][a] = 0.f;

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (tid + r * kThreads < k) {
        float u[CM];
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          float s = 0.f;
          if (j < c) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float e = v[j][d] - xr[r][d];
              s = s + e * e;
            }
          }
          u[j] = s;
        }
        fcm::membership_from_d2<CM, TIER>(c, m_is_2, expo, u);
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          if (j < c) {
            const float um = (m_is_2 ? u[j] * u[j] : powf(u[j], m)) * wr[r];
#pragma unroll
            for (int d = 0; d < D; ++d) acc[j][d] = acc[j][d] + um * xr[r][d];
            acc[j][D] = acc[j][D] + um;
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CM; ++j) {
      if (j < c) {  // uniform across the block: every lane shuffles
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[j][a] = acc[j][a] + __shfl_xor_sync(0xffffffffu, acc[j][a],
                                                   off);
        }
      }
    }
    const float(*slot)[kSlot] = part[it & 1];
    if (lid == 0) {
#pragma unroll
      for (int i = 0; i < kSlot; ++i)
        part[it & 1][wid][i] = i < kSums ? acc[i / kAcc][i % kAcc] : 0.f;
    }
    __syncthreads();

    float dmax = 0.f;
    if constexpr (TIER) {
      // every thread: the warps' 8 sums in warp order, the 4 centers
      float tot[kSlot];
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
#pragma unroll
        for (int i = 0; i < kSlot / 4; ++i) {
          const float4 s4 = reinterpret_cast<const float4*>(slot[q])[i];
          const float in[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[4 * i + e] = q == 0 ? in[e] : tot[4 * i + e] + in[e];
        }
      }
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const float vn = tot[j * kAcc] / fcm::floor_at(tot[j * kAcc + 1]);
        dmax = fcm::nan_max(dmax, fabsf(vn - v[j][0]));
        v[j][0] = vn;
      }
    } else {
      // lane i: center elements i and i + 32 (j = i / D, d = i % D)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lid + 32 * h;
        if (i < cd) {
          const int at = (i / D) * kAcc + i % D;
          const int den_at = (i / D) * kAcc + D;
          float num = slot[0][at];
          float den = slot[0][den_at];
#pragma unroll
          for (int q = 1; q < kWarps; ++q) {
            num = num + slot[q][at];
            den = den + slot[q][den_at];
          }
          const float vn = num / fcm::floor_at(den);
          dmax = fcm::nan_max(dmax, fabsf(vn - own[h]));
          own[h] = vn;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dmax = fcm::nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        if (j < c) {  // uniform
#pragma unroll
          for (int d = 0; d < D; ++d) {
            constexpr int kLanes = 32;
            const int i = j * D + d;  // compile-time after unrolling
            v[j][d] = __shfl_sync(0xffffffffu, i < kLanes ? own[0] : own[1],
                                  i % kLanes);
          }
        }
      }
    }
    delta = dmax;
    ++it;
  }

  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < CM; ++j)
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (j < c) v_out[(lane * c + j) * D + d] = v[j][d];
    delta_out[lane] = delta;
    iters_out[lane] = it;
  }
}

template <int D, bool TIER>
int launch(const void* x, const void* w, const void* v0, const void* tol,
           int n_lanes, int k, int c, float m, float expo, int max_iters,
           void* v_out, void* delta_out, void* iters_out, void* stream) {
  resident_solve_kernel<D, TIER>
      <<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)w, (const float*)v0,
          (const float*)tol, k, c, m, expo, max_iters, (float*)v_out,
          (float*)delta_out, (int*)iters_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcm_resident_max_rows() { return kMaxRows; }
extern "C" int fcm_resident_threads() { return kThreads; }

// x (B, K, D), w (B, K), v0 (B, c, D), tol (B,) float32, all contiguous ->
// v (B, c, D), delta (B,) float32, iters (B,) int32. tier (from
// kernels/fcm_resident.py::resident_plan) takes c == 4, D == 1 and m == 2
// only.
extern "C" int fcm_resident_solve(const void* x, const void* w, const void* v0,
                                  const void* tol, int n_lanes, int k, int d,
                                  int c, float m, float expo, int max_iters,
                                  int tier, void* v_out, void* delta_out,
                                  void* iters_out, void* stream) {
  if (n_lanes < 1 || k < 1 || k > kMaxRows || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  if (tier) {
    if (c != 4 || d != 1 || m != 2.0f) return (int)cudaErrorInvalidValue;
    return launch<1, true>(x, w, v0, tol, n_lanes, k, c, m, expo, max_iters,
                           v_out, delta_out, iters_out, stream);
  }
#define REPRO_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<DD, false>(x, w, v0, tol, n_lanes, k, c, m, expo,         \
                             max_iters, v_out, delta_out, iters_out,        \
                             stream);
  switch (d) {
    REPRO_CASE(1)
    REPRO_CASE(2)
    REPRO_CASE(3)
    REPRO_CASE(4)
    REPRO_CASE(5)
    REPRO_CASE(6)
    REPRO_CASE(7)
    REPRO_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CASE
}
