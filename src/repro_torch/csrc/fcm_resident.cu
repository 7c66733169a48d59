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
// operations per row, cluster and iteration). The limit is the serial chain:
// each iteration is a dependent sequence of a per-row pass, a block-wide
// reduction and a broadcast of the new centers, with two block barriers, and
// a lane needs tens of iterations. The design keeps that chain on one SM with
// no trip to device memory and no launch between iterations.
//
// Design: one block per lane (a full 64-lane bucket is one launch of 64
// blocks). Each thread keeps its rows and weights in registers for the whole
// solve; the centers live in shared memory. One iteration:
//   1. every thread computes, for each of its rows, d2 to each center, the
//      Eq. 4 membership with the 1e-12 distance floor and the even split over
//      zero-distance centers, u^m * w, and adds u^m * w * x and u^m * w into
//      its c * (D + 1) partial sums (its rows in order);
//   2. each warp reduces the partial sums with a fixed shuffle tree and writes
//      them to shared memory; after a barrier warp 0 adds the eight warps'
//      sums in warp order, forms v' = num / max(den, 1e-12) and
//      delta = max|v' - v| (NaN-propagating, as jnp.max), and publishes both
//      through shared memory;
//   3. after a second barrier every thread tests delta >= tol && it < max_iters
//      on the same shared value, so the loop stays uniform across the block.
// The reduction order is fixed, so a run repeats bit for bit. It differs from
// the plain version's order, so centers agree to rounding, not bitwise.
// With m == 2 the two powers are computed exactly as the plain version does:
// d^(-1) as 1 / d and u^2 as u * u (torch.pow and XLA take the same special
// cases for exponents -1 and 2); other m use powf with the float32 exponents
// -1/(m-1) and m. The library is compiled with --fmad=false so that no
// multiply-add is contracted where the plain version rounds twice.
//
// Row bound: rows stay in registers, ROWS_PER_THREAD of them per thread, so a
// lane holds at most THREADS * ROWS_PER_THREAD = 256 * 4 = 1024 rows. At
// D = 8 a thread keeps 4 * (8 + 1) row values, 8 * 9 partial sums and three
// c-vectors, about 140 registers, within the 255 a thread may have; 256
// threads at that count fit one block per SM's 65,536 registers. Larger flat
// problems need the HBM-streamed solve, which is not ported yet.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kMaxRows = kThreads * kRowsPerThread;
constexpr int kMaxC = 8;
constexpr float kFloor = 1e-12f;

// max that propagates NaN, like jnp.max and torch.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// max(a, floor) that propagates NaN, like jnp.maximum / torch.clamp
__device__ __forceinline__ float floor_at(float a) {
  return a < kFloor ? kFloor : a;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
resident_solve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ v0,
                      const float* __restrict__ tol, int k, int c, float m,
                      float expo, int max_iters, float* __restrict__ v_out,
                      float* __restrict__ delta_out,
                      int* __restrict__ iters_out) {
  constexpr int kAcc = D + 1;  // D numerator sums and one denominator sum
  __shared__ float v_s[kMaxC * D];
  __shared__ float part[kWarps][kMaxC * kAcc];
  __shared__ float delta_s;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const bool m_is_2 = (m == 2.0f);
  const int cd = c * D;

  float xr[kRowsPerThread][D];
  float wr[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = tid + r * kThreads;
    const bool ok = row < k;
#pragma unroll
    for (int d = 0; d < D; ++d)
      xr[r][d] = ok ? x[((long long)lane * k + row) * D + d] : 0.f;
    wr[r] = ok ? w[(long long)lane * k + row] : 0.f;
  }
  for (int i = tid; i < cd; i += kThreads)
    v_s[i] = v0[(long long)lane * cd + i];
  const float tl = tol[lane];
  __syncthreads();

  float delta = INFINITY;
  int it = 0;
  while (delta >= tl && it < max_iters) {
    float acc[kMaxC][kAcc];
#pragma unroll
    for (int j = 0; j < kMaxC; ++j)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[j][a] = 0.f;

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (tid + r * kThreads < k) {
        float d2[kMaxC];
        int n_zero = 0;
#pragma unroll
        for (int j = 0; j < kMaxC; ++j) {
          float s = 0.f;
          if (j < c) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float e = v_s[j * D + d] - xr[r][d];
              s = s + e * e;
            }
            if (s <= 0.f) ++n_zero;
          }
          d2[j] = s;
        }
        float u[kMaxC];
        if (n_zero > 0) {
          const float share = 1.0f / (float)n_zero;
#pragma unroll
          for (int j = 0; j < kMaxC; ++j) u[j] = d2[j] <= 0.f ? share : 0.f;
        } else {
          float p[kMaxC];
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxC; ++j) {
            if (j < c) {
              const float dd = floor_at(d2[j]);
              p[j] = m_is_2 ? 1.0f / dd : powf(dd, expo);
              ps = ps + p[j];
            } else {
              p[j] = 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < kMaxC; ++j) u[j] = p[j] / ps;
        }
#pragma unroll
        for (int j = 0; j < kMaxC; ++j) {
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
    for (int j = 0; j < kMaxC; ++j) {
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

    if (wid == 0) {
      float dmax = 0.f;
      for (int i = lid; i < cd; i += 32) {
        const int j = i / D;
        const int d = i - j * D;
        float num = part[0][j * kAcc + d];
        float den = part[0][j * kAcc + D];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) {
          num = num + part[q][j * kAcc + d];
          den = den + part[q][j * kAcc + D];
        }
        const float vn = num / floor_at(den);
        dmax = nan_max(dmax, fabsf(vn - v_s[i]));
        v_s[i] = vn;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dmax = nan_max(dmax, __shfl_down_sync(0xffffffffu, dmax, off));
      if (lid == 0) delta_s = dmax;
    }
    __syncthreads();
    delta = delta_s;
    ++it;
  }

  for (int i = tid; i < cd; i += kThreads)
    v_out[(long long)lane * cd + i] = v_s[i];
  if (tid == 0) {
    delta_out[lane] = delta;
    iters_out[lane] = it;
  }
}

template <int D>
int launch(const void* x, const void* w, const void* v0, const void* tol,
           int n_lanes, int k, int c, float m, float expo, int max_iters,
           void* v_out, void* delta_out, void* iters_out, void* stream) {
  resident_solve_kernel<D><<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)v0, (const float*)tol, k,
      c, m, expo, max_iters, (float*)v_out, (float*)delta_out,
      (int*)iters_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcm_resident_max_rows() { return kMaxRows; }

// x (B, K, D), w (B, K), v0 (B, c, D), tol (B,) float32, all contiguous ->
// v (B, c, D), delta (B,) float32, iters (B,) int32.
extern "C" int fcm_resident_solve(const void* x, const void* w, const void* v0,
                                  const void* tol, int n_lanes, int k, int d,
                                  int c, float m, float expo, int max_iters,
                                  void* v_out, void* delta_out,
                                  void* iters_out, void* stream) {
  if (n_lanes < 1 || k < 1 || k > kMaxRows || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
#define REPRO_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<DD>(x, w, v0, tol, n_lanes, k, c, m, expo, max_iters,     \
                      v_out, delta_out, iters_out, stream);
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
