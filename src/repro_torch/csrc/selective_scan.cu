// The Mamba selective scan: for u, dt (B, S, di), B_t, C_t (B, S, ds) and
// A (di, ds), float32,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,  h_0 = 0,
//   y_t = sum_s h_t[s] * C_t[s]                       -> y (B, S, di).
//
// Replaces src/repro/kernels/selective_scan.py::selective_scan_pallas. The
// TPU kernel walks a grid of (batch, d_inner tiles, sequence blocks) in
// order on one core and carries the (di_tile, ds) state from one sequence
// block to the next in a VMEM accumulator; it needs S % seq_blk == 0 and
// di % di_tile == 0 (VMEM tilings). None of that is carried over: here each
// (batch, channel) owns a group of G lanes (G the power of two >= ds, at
// least 4), lane s holding state element h[s] in a register for the whole
// sequence, so the state never leaves the SM and blocks need no order. The
// kernel takes any S and di; lanes past ds and channels past di hold zeros.
//
// Design: a block of 256 threads serves 256 / G channels of one batch row
// (16 at d_state 16: 131,072 threads at (1, 4096, 8192, 16), where one
// thread a channel would leave most of the 132 SMs idle). It walks the
// sequence in tiles of kTBlk positions: the tile's u and dt (kTBlk x
// channels, coalesced along the channels) and the B_t, C_t that all its
// channels share (kTBlk x ds) are staged in shared memory; every lane steps
// its state through the tile, the group folds h * C_t with warp shuffles
// (a fixed xor tree), and lane 0 leaves y_t in a shared tile that the block
// stores, coalesced, after the walk.
//
// Arithmetic, as the plain version (kernels/selective_scan.py::
// selective_scan_ref) does it, compiled with --fmad=false: da = expf(dt *
// a); h = da * h + (dt * u) * b. expf and PyTorch's exp may differ by an
// ulp and the sum over ds runs in another order, so y agrees to a
// tolerance, not bitwise.
//
// What bounds it on an H100: memory by the card's peaks (u, dt and y are
// 12 B a (b, t, channel); at (1, 4096, 8192, 16) 403 MB, 0.120 ms at 3.35
// TB/s, against about 3.2 GFLOP, 0.048 ms at 67 TFLOP/s), but in practice
// the serial walk: every lane issues an expf, two multiplies, an add and
// the group's four shuffles a position, S positions in a row. A
// chunked-scan redesign is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTBlk = 32;

template <int G>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, int s, int di, int ds,
                      float* __restrict__ y) {
  constexpr int kCh = kThreads / G;  // channels a block
  __shared__ float u_s[kTBlk][kCh];
  __shared__ float dt_s[kTBlk][kCh];
  __shared__ float y_s[kTBlk][kCh];
  __shared__ float b_s[kTBlk][G];
  __shared__ float c_s[kTBlk][G];
  const int ch0 = blockIdx.x * kCh;
  const long long row0 = (long long)blockIdx.y * s;  // (batch, t = 0)
  const int cc = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int ch = ch0 + cc;
  const float av = (ch < di && lane < ds) ? a[(long long)ch * ds + lane] : 0.f;
  float h = 0.f;
  for (int t0 = 0; t0 < s; t0 += kTBlk) {
    const int nt = min(kTBlk, s - t0);
    for (int e = threadIdx.x; e < kTBlk * kCh; e += kThreads) {
      const int tt = e / kCh, c2 = e % kCh;
      const bool ok = tt < nt && ch0 + c2 < di;
      const long long off = (row0 + t0 + tt) * di + ch0 + c2;
      u_s[tt][c2] = ok ? u[off] : 0.f;
      dt_s[tt][c2] = ok ? dt[off] : 0.f;
    }
    for (int e = threadIdx.x; e < kTBlk * G; e += kThreads) {
      const int tt = e / G, k = e % G;
      const bool ok = tt < nt && k < ds;
      const long long off = (row0 + t0 + tt) * ds + k;
      b_s[tt][k] = ok ? bm[off] : 0.f;
      c_s[tt][k] = ok ? cm[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dt_s[tt][cc];
      const float da = expf(dtv * av);
      h = da * h + (dtv * u_s[tt][cc]) * b_s[tt][lane];
      float p = h * c_s[tt][lane];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        p = p + __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) y_s[tt][cc] = p;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * kCh; e += kThreads) {
      const int tt = e / kCh, c2 = e % kCh;
      if (ch0 + c2 < di) y[(row0 + t0 + tt) * di + ch0 + c2] = y_s[tt][c2];
    }
    // the next tile's staging writes only u_s, dt_s, b_s and c_s, and its
    // walk writes y_s after the next __syncthreads, when these stores are done
  }
}

template <int G>
int launch(const void* u, const void* dt, const void* bm, const void* cm,
           const void* a, int b, int s, int di, int ds, void* y,
           void* stream) {
  constexpr int kCh = kThreads / G;
  const dim3 grid((di + kCh - 1) / kCh, b);
  selective_scan_kernel<G><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)dt, (const float*)bm, (const float*)cm,
      (const float*)a, s, di, ds, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// u, dt (B, S, di), bmat, cmat (B, S, ds), a (di, ds), float32 contiguous ->
// y (B, S, di). 1 <= B <= 65535, S >= 1, di >= 1, 1 <= ds <= 32.
extern "C" int selective_scan_f32(const void* u, const void* dt,
                                  const void* bmat, const void* cmat,
                                  const void* a, int b, int s, int di, int ds,
                                  void* y, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || di < 1 || ds < 1 || ds > 32)
    return (int)cudaErrorInvalidValue;
  if (ds <= 4) return launch<4>(u, dt, bmat, cmat, a, b, s, di, ds, y, stream);
  if (ds <= 8) return launch<8>(u, dt, bmat, cmat, a, b, s, di, ds, y, stream);
  if (ds <= 16)
    return launch<16>(u, dt, bmat, cmat, a, b, s, di, ds, y, stream);
  return launch<32>(u, dt, bmat, cmat, a, b, s, di, ds, y, stream);
}
