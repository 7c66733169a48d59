// Device helpers shared by the FCM kernels (fcm_membership.cu, fcm_centers.cu,
// fcm_spatial.cu, fcm_stencil.cu, fcm_streamed.cu, fcm_resident.cu): the Eq. 4
// membership of one pixel from its c squared distances, computed in registers
// with the same float32 operations as the plain PyTorch version
// (repro_torch.core.fcm.membership_from_d2), a block's fixed-order fold of
// per-thread sums, the cluster-count tiers the kernels are instantiated
// for, the counter add that fcm_centers.cu, fcm_streamed.cu and
// histogram_bin.cu synchronise blocks with, and the last-block fold of a
// lane's partial rows that fcm_centers.cu and fcm_spatial.cu end their
// one-launch reductions with.
//
// Arithmetic, as the plain version does it:
//   d2_j = (v_j - x) * (v_j - x)                      ((v - x) ** 2)
//   p_j  = 1 / max(d2_j, 1e-12)         when m == 2  (pow with exponent -1)
//        = powf(max(d2_j, 1e-12), -1/(m-1))  otherwise
//   u_j  = p_j / (p_0 + p_1 + ... + p_{c-1})         (a correctly rounded
//                                                      divide, not a
//                                                      reciprocal multiply)
// and a pixel at distance exactly 0 from some centers splits its mass evenly
// over those centers (1 / count each, 0 elsewhere). The library is compiled
// with --fmad=false, so no multiply-add is contracted where the plain version
// rounds twice. powf and PyTorch's pow may differ by an ulp, so general m
// agrees to a tolerance; m == 2 takes no powf at all.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fcm {

constexpr float kFloor = 1e-12f;
// the largest cluster count the per-iteration kernels take (the membership
// of one pixel lives in MAXC registers)
constexpr int kMaxC = 32;

// max(a, floor) that propagates NaN, like torch.clamp / jnp.maximum
__device__ __forceinline__ float floor_at(float a) {
  return a < kFloor ? kFloor : a;
}

// max that propagates NaN, like jnp.max and torch.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// a / b rounded to nearest, from y = RN(1 / b) (__frcp_rn), in multiplies and
// fused multiply-adds with no range check or branch: q0 = RN(a y) is within
// two ulps of a / b, one correction brings it within one, and Markstein's
// theorem makes the second correction's RN(q1 + RN(a - b q1) y) equal to
// RN(a / b) when y is within half an ulp of 1 / b and nothing underflows or
// overflows. The c quotients of a row share their divisor, so one
// reciprocal serves them all, in place of c IEEE divisions (each a
// reciprocal, its refinement, a range check and a branch).
__device__ __forceinline__ float quotient_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// Eq. 4 from squared distances: u[0..c) holds a pixel's c distances on entry
// and its memberships on exit; u[c..MAXC) is zeroed. A zero distance is found
// by testing the distances' minimum (fminf passes NaN over, as a count of
// zeros would, so the bits are the same), and the zeros are counted only
// then: faster than a count on every pixel in every kernel that takes it
// (kernel_ab.py, PERF.md). ONE_RCP: at m == 2, when every distance is at
// most 2^55, the c divisions by the sum go through quotient_by with one
// reciprocal: then p_j lies in [2^-55, 2^40] and the sum in [2^-55, 2^45],
// so no quotient, residual or reciprocal leaves the normal range and the
// bits are the IEEE division's; other rows (and NaN or infinite distances)
// take the divisions.
template <int MAXC, bool ONE_RCP = false>
__device__ __forceinline__ void membership_from_d2(int c, bool m_is_2,
                                                   float expo,
                                                   float (&u)[MAXC]) {
  float dmin = u[0];
  float dmax = u[0];
#pragma unroll
  for (int j = 1; j < MAXC; ++j) {
    if (j < c) {
      dmin = fminf(dmin, u[j]);
      if constexpr (ONE_RCP) dmax = fmaxf(dmax, u[j]);
    }
  }
  if (dmin <= 0.f) {
    int n_zero = 0;
#pragma unroll
    for (int j = 0; j < MAXC; ++j)
      if (j < c && u[j] <= 0.f) ++n_zero;
    const float share = 1.0f / (float)n_zero;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) u[j] = (j < c && u[j] <= 0.f) ? share : 0.f;
    return;
  }
  float ps = 0.f;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      const float dd = floor_at(u[j]);
      u[j] = m_is_2 ? 1.0f / dd : powf(dd, expo);
      ps = ps + u[j];
    } else {
      u[j] = 0.f;
    }
  }
  if constexpr (ONE_RCP) {
    // a NaN distance makes the sum NaN, and so every quotient either way
    if (m_is_2 && dmax <= 0x1p55f) {
      const float y = __frcp_rn(ps);
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
        if (j < c) u[j] = quotient_by(u[j], ps, y);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    if (j < c) u[j] = u[j] / ps;
}

// Eq. 4 for one scalar pixel xi against c <= MAXC centers v (shared memory):
// fills u[0..c) and zeroes u[c..MAXC).
template <int MAXC>
__device__ __forceinline__ void membership_of(float xi,
                                              const float* __restrict__ v,
                                              int c, bool m_is_2, float expo,
                                              float (&u)[MAXC]) {
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    float s = 0.f;
    if (j < c) {
      const float e = v[j] - xi;
      s = e * e;
    }
    u[j] = s;
  }
  membership_from_d2<MAXC>(c, m_is_2, expo, u);
}

// Fold each thread's c numerator and c denominator sums over a block of
// THREADS threads, in a fixed order (a shuffle tree in each warp, then the
// warps in warp order), into out[k * stride] for k < 2c: c numerators, then
// c denominators.
template <int MAXC, int THREADS>
__device__ __forceinline__ void block_partials(const float (&num)[MAXC],
                                               const float (&den)[MAXC],
                                               int c, float* __restrict__ out,
                                               long long stride = 1) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float warp_s[kWarps][2 * MAXC];
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {  // uniform across the block: every lane shuffles
      float a = num[j];
      float b = den[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a = a + __shfl_down_sync(0xffffffffu, a, off);
        b = b + __shfl_down_sync(0xffffffffu, b, off);
      }
      if (lid == 0) {
        warp_s[wid][j] = a;
        warp_s[wid][MAXC + j] = b;
      }
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * c) {
    const int slot = t < c ? t : MAXC + (t - c);
    float s = warp_s[0][slot];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s = s + warp_s[q][slot];
    out[t * stride] = s;
  }
}

// atomicAdd with acquire-release semantics at gpu scope: it publishes what
// the calling block stored before its last barrier, and sees what the blocks
// that added before it published. Returns the old value.
__device__ __forceinline__ int fetch_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Called by every thread of a block after its partials are stored: true in
// the one block of a group of n blocks that arrives last at ticket (zero on
// entry), which then sees every block's stores. After the barrier thread 0
// takes the ticket with one add of acquire-release semantics at gpu scope
// (cumulative: it releases the stores the barrier made it observe, and the
// last block's acquires everyone's, which the second barrier passes on to
// its threads). The last block must set the ticket back to zero when it is
// done.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = fetch_add_acq_rel(ticket, 1) == n - 1;
  __syncthreads();
  return last;
}

// The width of the thread groups fold_rows gives an output: the smallest
// power of two that holds n_rows, at most a warp.
__device__ __forceinline__ int fold_width(int n_rows) {
  int sw = 1;
  while (sw < 32 && sw < n_rows) sw <<= 1;
  return sw;
}

// The last block's fold of a lane's partials, in a fixed order that depends
// on n_rows alone: out o (o < n_out) is the sum over the blocks r < n_rows of
// src(o)[r], each output's blocks stored contiguously (output-major, so a
// group's loads are coalesced). A group of fold_width(n_rows) threads takes
// an output, thread k of it blocks k, k + width, ... in order through L2,
// then a shuffle tree within the group; the groups of the block take the
// outputs in turn. dst(o, s) stores the sum. A thread issues kFoldBatch
// loads (clamped to the last row, so none waits on a branch) before it adds
// them: this fold is the last step of its launch, and loads taken one at a
// time cost an L2 round trip each (about 4 us at 500 rows on an H100, see
// PERF.md). Every thread of the block calls it (the shuffles need whole
// warps).
constexpr int kFoldBatch = 16;

template <int THREADS, typename Src, typename Dst>
__device__ __forceinline__ void fold_rows(int n_out, int n_rows, Src src,
                                          Dst dst) {
  const int sw = fold_width(n_rows);
  const int groups = THREADS / sw;
  const int g = threadIdx.x / sw;
  const int k = threadIdx.x - g * sw;
  for (int o0 = 0; o0 < n_out; o0 += groups) {  // uniform across the block
    const int o = o0 + g;
    float s = 0.f;
    if (o < n_out) {
      const float* p = src(o);
      for (int r0 = k; r0 < n_rows; r0 += kFoldBatch * sw) {
        float vals[kFoldBatch];
#pragma unroll
        for (int q = 0; q < kFoldBatch; ++q)
          vals[q] = __ldcg(p + min(r0 + q * sw, n_rows - 1));
#pragma unroll
        for (int q = 0; q < kFoldBatch; ++q)
          if (r0 + q * sw < n_rows) s = s + vals[q];
      }
    }
    for (int off = sw >> 1; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off, sw);
    if (o < n_out && k == 0) dst(o, s);
  }
}

// The smallest instantiated tier that holds c clusters (0 if none does).
inline int tier_of(int c) {
  return c < 1 ? 0 : c <= 4 ? 4 : c <= 8 ? 8 : c <= 16 ? 16 : c <= kMaxC ? 32
                                                                         : 0;
}

}  // namespace fcm
