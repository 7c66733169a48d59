// The Mamba selective scan: for u, dt (B, S, di), B_t, C_t (B, S, ds) and
// A (di, ds), float32,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,  h_0 = 0,
//   y_t = sum_s h_t[s] * C_t[s]                       -> y (B, S, di).
//
// Replaces src/repro/kernels/selective_scan.py::selective_scan_pallas. The
// TPU kernel walks a grid of (batch, d_inner tiles, sequence blocks) in
// order on one core and carries the (di_tile, ds) state from one sequence
// block to the next in a VMEM accumulator; it needs S % seq_blk == 0 and
// di % di_tile == 0 (VMEM tilings). None of that is carried over: the
// kernels here take any S and di, and 1 <= ds <= 32.
//
// Design: a chunked scan. The recurrence is linear in h, so S is cut into
// n_c chunks of L positions (L from S, di and the SM count alone:
// kernels/selective_scan.py::chunk_len) and the parallelism comes from the
// sequence: one thread holds one (batch, chunk, channel)'s whole d_state
// vector in registers, forms dt * u once a position, reads B_t and C_t as
// broadcast vectors from shared memory and sums <h, C_t> in registers in a
// fixed order, with no shuffles. Three launches:
//   1. chunk_walk<DS, false>: every chunk but the last walks its positions
//      from zero state and leaves its end state and the sum of its dt in
//      the workspace;
//   2. chunk_carry: one thread a (batch, state, channel) walks the n_c - 1
//      end states in order, h_in(k+1) = exp(A * sum dt(k)) * h_in(k) +
//      end(k), overwriting each end state with the state carried into the
//      next chunk;
//   3. chunk_walk<DS, true>: every chunk walks its positions again from its
//      carried-in state (zero for the first) and writes y; where the caller
//      asks for the end state h_S (prefill), the threads of the last chunk
//      store their state vector there, (B, di, ds), after their walk.
// A single chunk (S <= L) takes launch 3 alone, and stores h_S alike.
// Separate launches, and not one launch with a decoupled look-back, because
// a look-back spins on flags that earlier blocks publish and so needs those
// blocks resident or already done, which the grid cannot promise at every
// width. B_t and C_t reach shared memory kTile positions at a time, padded
// to the DS tier; u and dt are read straight from device memory, coalesced
// along the channels. The workspace, (B, n_c - 1, ds, di) end states and
// (B, n_c - 1, di) dt sums, is allocated by the wrapper.
//
// Arithmetic: da = 2^(dt * A log2 e) with the hardware's ex2.approx (one
// special-function instruction), h = da * h + (dt * u) * b, compiled with
// --fmad=false; the chunk's decay in launch 2 is 2^(A log2 e * sum dt), not
// the product of its factors. The plain version (kernels/selective_scan.py::
// selective_scan_ref) multiplies PyTorch's exp factors one position at a
// time, so y agrees to a tolerance, not bitwise. Every sum runs in a fixed
// order and nothing is atomic: a run repeats bit for bit.
//
// What bounds it on an H100: memory by the card's peaks (u, dt and y are
// 12 B a (b, t, channel); at (1, 4096, 8192, 16) 403 MB, 0.120 ms at 3.35
// TB/s); the design reads u and dt twice (268 MB more) and moves its
// workspace (69 MB at L = 125), 0.74 GB in all. Every (position, channel,
// state) takes one ex2 in each walk, 2 x 5.4e8 at that shape, 0.26 ms at 16
// a clock an SM and 1.98 GHz. Measured there (chip_smoke, NVIDIA H100 80GB
// HBM3, 700 W): the walks take 0.19 and 0.22 ms at 1.4 and 1.8 TB/s, and a
// build without the ex2 was barely faster, so what holds them is the latency
// of their loads (one 4-byte element a thread and position, rows 32 KB
// apart), which the group-ahead loads of u and dt hide only in part.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // channels a block of the walks and the carry
constexpr int kTile = 64;      // positions of B_t, C_t staged at a time
constexpr int kGroup = 8;      // positions whose u, dt are loaded a group ahead
constexpr int kCarryBatch = 8; // end states prefetched at a time in the carry
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [t0, t0 + nt) of a (S, ds) matrix into a (kTile, DS) tile, zero
// past ds
template <int DS>
__device__ __forceinline__ void stage(const float* __restrict__ src, int t0,
                                      int nt, int ds, float (*dst)[DS]) {
  for (int e = threadIdx.x; e < nt * DS; e += kThreads) {
    const int tt = e / DS, k = e % DS;
    dst[tt][k] = k < ds ? src[(long long)(t0 + tt) * ds + k] : 0.f;
  }
}

// The walk of one chunk by one (batch, channel): launch 1 (OUT false) keeps
// the end state and the dt sum, launch 3 (OUT true) writes y.
template <int DS, bool OUT>
__global__ void __launch_bounds__(kThreads)
chunk_walk(const float* __restrict__ u, const float* __restrict__ dt,
           const float* __restrict__ bm, const float* __restrict__ cm,
           const float* __restrict__ a, int s, int di, int ds, int chunk,
           int n_c, float* __restrict__ hws, float* __restrict__ dws,
           float* __restrict__ y, float* __restrict__ hout) {
  __shared__ __align__(16) float b_s[kTile][DS];
  __shared__ __align__(16) float c_s[OUT ? kTile : 1][DS];
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int bb = blockIdx.z;
  const bool live = ch < di;
  // a thread past di walks the last channel too and stores nothing
  const int chl = live ? ch : di - 1;
  const int t0 = k * chunk;
  const int n = min(s, t0 + chunk) - t0;
  float a2[DS];
  float h[DS];
  // launch 3's chunk k > 0 starts from the state launch 2 left in slot k - 1
  const long long slot_in = ((long long)bb * (n_c - 1) + k - 1) * ds;
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    a2[j] = j < ds ? a[(long long)chl * ds + j] * kLog2e : 0.f;
    h[j] = (OUT && k > 0 && j < ds) ? hws[(slot_in + j) * di + chl] : 0.f;
  }
  const float* bml = bm + (long long)bb * s * ds;
  const float* cml = cm + (long long)bb * s * ds;
  // this thread's u, dt and y at the position the pointers reach, a step of
  // di a position
  const long long row = ((long long)bb * s + t0) * di;
  const long long step = di;
  const float* dtp = dt + row + chl;
  const float* up = u + row + chl;
  float* yp = y + row + chl;
  // the next group's dt and u, loaded while the current group is walked
  float dt_n[kGroup], u_n[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    dt_n[q] = q < n ? dtp[q * step] : 0.f;
    u_n[q] = q < n ? up[q * step] : 0.f;
  }
  float dsum = 0.f;
  for (int g0 = 0; g0 < n; g0 += kGroup) {
    const int tt0 = g0 % kTile;
    if (tt0 == 0) {
      __syncthreads();  // the last tile's reads of b_s, c_s are done
      const int nt = min(kTile, n - g0);
      stage<DS>(bml, t0 + g0, nt, ds, b_s);
      if (OUT) stage<DS>(cml, t0 + g0, nt, ds, c_s);
      __syncthreads();
    }
    float dt_c[kGroup], u_c[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      dt_c[q] = dt_n[q];
      u_c[q] = u_n[q];
    }
    dtp += kGroup * step;
    up += kGroup * step;
    const int ahead = n - g0 - kGroup;  // positions past this group
    if (ahead >= kGroup) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        dt_n[q] = dtp[q * step];
        u_n[q] = up[q * step];
      }
    } else {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        dt_n[q] = q < ahead ? dtp[q * step] : 0.f;
        u_n[q] = q < ahead ? up[q * step] : 0.f;
      }
    }
    const int nq = min(kGroup, n - g0);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (q < nq) {
        const float dtv = dt_c[q];
        const float dtu = dtv * u_c[q];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < DS; ++j) {
          const float da = ex2(dtv * a2[j]);
          h[j] = da * h[j] + dtu * b_s[tt0 + q][j];
          if (OUT) acc = acc + h[j] * c_s[tt0 + q][j];
        }
        if (OUT) {
          if (live) yp[q * step] = acc;
        } else {
          dsum = dsum + dtv;
        }
      }
    }
    yp += kGroup * step;
  }
  if (!OUT && live) {
    const long long slot = (long long)bb * (n_c - 1) + k;
#pragma unroll
    for (int j = 0; j < DS; ++j)
      if (j < ds) hws[(slot * ds + j) * di + ch] = h[j];
    dws[slot * di + ch] = dsum;
  }
  // the end state, read by nothing else: one (B, di, ds) row a thread
  if (OUT && live && hout != nullptr && k == n_c - 1) {
    float* ho = hout + ((long long)bb * di + ch) * ds;
#pragma unroll
    for (int j = 0; j < DS; ++j)
      if (j < ds) ho[j] = h[j];
  }
}

// Launch 2: one thread a (batch, state, channel) carries the state across
// the chunks in order, end states read kCarryBatch at a time ahead of the
// chain.
__global__ void __launch_bounds__(kThreads)
chunk_carry(const float* __restrict__ a, int di, int ds, int n_c,
            float* __restrict__ hws, const float* __restrict__ dws) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int bb = blockIdx.z;
  if (ch >= di) return;
  const float a2 = a[(long long)ch * ds + j] * kLog2e;
  const long long base = (long long)bb * (n_c - 1);
  float hin = 0.f;
  for (int k0 = 0; k0 < n_c - 1; k0 += kCarryBatch) {
    float e[kCarryBatch], d[kCarryBatch];
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      const bool ok = k0 + q < n_c - 1;
      const long long slot = base + k0 + q;
      e[q] = ok ? hws[(slot * ds + j) * di + ch] : 0.f;
      d[q] = ok ? dws[slot * di + ch] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (k0 + q < n_c - 1) {
        hin = ex2(a2 * d[q]) * hin + e[q];
        hws[((base + k0 + q) * ds + j) * di + ch] = hin;
      }
    }
  }
}

template <int DS>
int launch(const float* u, const float* dt, const float* bm, const float* cm,
           const float* a, int b, int s, int di, int ds, int chunk, float* hws,
           float* dws, float* y, float* hout, cudaStream_t st) {
  const int n_c = (s + chunk - 1) / chunk;
  const unsigned gx = (unsigned)((di + kThreads - 1) / kThreads);
  if (n_c > 1) {
    chunk_walk<DS, false><<<dim3(gx, n_c - 1, b), kThreads, 0, st>>>(
        u, dt, bm, cm, a, s, di, ds, chunk, n_c, hws, dws, y, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunk_carry<<<dim3(gx, ds, b), kThreads, 0, st>>>(a, di, ds, n_c, hws,
                                                       dws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  chunk_walk<DS, true><<<dim3(gx, n_c, b), kThreads, 0, st>>>(
      u, dt, bm, cm, a, s, di, ds, chunk, n_c, hws, dws, y, hout);
  return (int)cudaGetLastError();
}

}  // namespace

// u, dt (B, S, di), bmat, cmat (B, S, ds), a (di, ds), float32 contiguous ->
// y (B, S, di). 1 <= B <= 65535, S >= 1, di >= 1, 1 <= ds <= 32, chunk >= 1
// with ceil(S / chunk) <= 65535; hws (B, n_c - 1, ds, di) and dws (B, n_c -
// 1, di) float32 workspace, n_c = ceil(S / chunk) (unused when n_c == 1);
// h_out (B, di, ds) float32 receives the end state h_S, or is null when the
// caller does not want it (y's bits are the same either way).
extern "C" int selective_scan_f32(const void* u, const void* dt,
                                  const void* bmat, const void* cmat,
                                  const void* a, int b, int s, int di, int ds,
                                  int chunk, void* hws, void* dws, void* y,
                                  void* h_out, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || di < 1 || ds < 1 || ds > 32 ||
      chunk < 1 || (s + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  if (s > chunk && (hws == nullptr || dws == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* fu = (const float*)u;
  const float* fdt = (const float*)dt;
  const float* fb = (const float*)bmat;
  const float* fc = (const float*)cmat;
  const float* fa = (const float*)a;
  float* fh = (float*)hws;
  float* fd = (float*)dws;
  float* fy = (float*)y;
  float* fo = (float*)h_out;
  cudaStream_t st = (cudaStream_t)stream;
  if (ds <= 4)
    return launch<4>(fu, fdt, fb, fc, fa, b, s, di, ds, chunk, fh, fd, fy, fo,
                     st);
  if (ds <= 8)
    return launch<8>(fu, fdt, fb, fc, fa, b, s, di, ds, chunk, fh, fd, fy, fo,
                     st);
  if (ds <= 16)
    return launch<16>(fu, fdt, fb, fc, fa, b, s, di, ds, chunk, fh, fd, fy, fo,
                      st);
  return launch<32>(fu, fdt, fb, fc, fa, b, s, di, ds, chunk, fh, fd, fy, fo,
                    st);
}
