// Eq. 3 center partial sums: num_j = sum_i u_ji^m w_i x_i and
// den_j = sum_i u_ji^m w_i over (N,) scalar pixels, in two forms:
//
//   fcm_center_partials  from a materialized (c, N) membership u
//     (replaces src/repro/kernels/fcm_centers.py::center_partials_pallas,
//     the paper's staged reduction kernels);
//   fcm_fused_partials   from the centers v, the Eq. 4 membership computed in
//     registers and reduced at once, so the (c, N) array never exists
//     (replaces src/repro/kernels/fcm_centers.py::fused_partials_pallas, one
//     launch pair per FCM iteration).
//   fcm_fused_partials_batched  the same fused sums over a bucket of lanes of
//     vector rows, x (B, N, D) and w (B, N) -> num (B, c, D), den (B, c): the
//     batched flat step the solver runs once an iteration under its
//     per-lane-masked loop for lanes past the whole-solve kernels' bounds
//     (c > 8, rows > 2^20 or D > 16). The TPU kernel takes one lane of scalar
//     rows; the lane axis is the CUDA form of the JAX route's vmap, and the
//     feature axis is walked in chunks of DCH, so D has no bound.
//
// The TPU kernels walk (block_rows, 128) tiles in order on one core and add
// each tile into one (c, 128) accumulator that the grid carries from step to
// step; padding rows weigh 0. Hopper's blocks run in parallel and in no order,
// so nothing carries between them: each block reduces its grid-stride share
// of the pixels to 2c per-block partial sums, which are then folded in a
// fixed order: by a second launch for the fused forms, and inside the one
// launch for fcm_center_partials, whose last block to finish (an integer
// ticket taken after a fence) folds every block's partials. The tail is
// masked, not padded.
//
// fcm_center_partials reads its pixels in quads: thread t of the grid takes
// quads t, t + G, ... (G the grid's threads), pixels 4q .. 4q + 3 of a quad
// in order. x, each u row and w are loaded as one 16-byte vector a quad where
// their address is 16-byte aligned (u rows need N % 4 == 0 as well), else as
// four scalars; the last quad is masked. The order of the sums does not
// depend on which loads were used, so a pixel array's bits are the same at
// any alignment. The wrapper gives each thread about eight quads (125 blocks
// at the 1000 KB image), four of them loaded at once: enough bytes in flight
// for HBM's rate, and few enough blocks that the last block's fold is one
// round of loads from L2.
//
// What bounds them on an H100: memory. fcm_center_partials reads 4 B of x and
// 4c B of u a pixel (20.5 MB at the paper's 1000 KB image, c = 4: about 6 us
// at 3.35 TB/s); fcm_fused_partials reads only x (4 MB, about 1.2 us) and
// spends about 10 float operations a pixel and cluster, still below the
// card's float32 rate. Weights w (histogram counts) add 4 B a pixel; a null w
// means unit weights and is not read.
// fcm_fused_partials_batched reads 4 (D + 1) B a row (x and w) and spends
// about c (3 D + 12) float operations on it: bytes bound it for the route's
// shapes (a lane of 2^20 RGB rows at c = 12: 16.8 MB against 0.26 GFLOP).
//
// Determinism: no float atomics. Each thread adds its pixels in index order,
// each warp folds its threads with a fixed shuffle tree, warp 0's threads add
// the eight warps in warp order, and the fold (a launch of its own, or the
// last block of fcm_center_partials) adds the blocks with a fixed lane stride
// and shuffle tree. The block count depends only on N (the wrapper picks it),
// so a run repeats bit for bit. The order differs from the plain version's,
// so sums agree to rounding, not bitwise.
//
// Arithmetic per pixel and cluster, as the plain version: um = u * u when
// m == 2, else powf(u, m); um = um * w; num += um * x; den += um.
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// four pixels p[i0 .. i0 + 3] (zeros past n): one 16-byte load when vec
__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          long long i0, long long n, bool vec,
                                          float (&q)[4]) {
  if (vec && i0 + 4 <= n) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i0));
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] = i0 + e < n ? __ldcs(p + i0 + e) : 0.f;
  }
}

// One launch: each block reduces its quads to 2c partials in part; the last
// block to finish folds all blocks' partials into num, den and sets the
// ticket back to zero for the next launch on the stream. A thread loads
// kAhead quads (x, w and every u row) before it adds any of them: at c <= 4
// four of the eight quads the wrapper gives a thread, so 4 (c + 2) 16-byte
// loads a thread are in flight at once. M2 (m == 2) is compile-time.
template <int MAXC, bool M2>
__global__ void __launch_bounds__(kThreads)
center_partials_kernel(const float* __restrict__ x,
                       const float* __restrict__ u,
                       const float* __restrict__ w, long long n, int c,
                       float m, bool vec_x, bool vec_u, bool vec_w,
                       float* __restrict__ part, int* __restrict__ ticket,
                       float* __restrict__ num_out,
                       float* __restrict__ den_out) {
  constexpr int kAhead = MAXC <= 4 ? 4 : MAXC <= 8 ? 2 : 1;
  float num[MAXC];
  float den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) num[j] = den[j] = 0.f;
  const long long n_quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q0 = (long long)blockIdx.x * kThreads + threadIdx.x;
       q0 < n_quads; q0 += kAhead * stride) {
    float xq[kAhead][4], wq[kAhead][4], uq[kAhead][MAXC][4];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long i0 = 4 * (q0 + a * stride);
      load_quad(x, i0, n, vec_x, xq[a]);
      if (w) {
        load_quad(w, i0, n, vec_w, wq[a]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) wq[a][e] = 1.0f;
      }
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
        if (j < c) load_quad(u + (long long)j * n, i0, n, vec_u, uq[a][j]);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long i0 = 4 * (q0 + a * stride);
      const int valid = (int)max(0LL, min(4LL, n - i0));
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < valid) {
              const float uj = uq[a][j][e];
              const float um = (M2 ? uj * uj : powf(uj, m)) * wq[a][e];
              num[j] = num[j] + um * xq[a][e];
              den[j] = den[j] + um;
            }
          }
        }
      }
    }
  }
  fcm::block_partials<MAXC, kThreads>(num, den, c,
                                      part + (long long)blockIdx.x * 2 * c);
  // block_partials ends with the partials' stores; after the barrier thread
  // 0 takes the ticket with acquire-release semantics at gpu scope: it
  // releases the block's partials, and the last block acquires everyone's
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = fcm::fetch_add_acq_rel(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // part (gridDim.x, 2c) -> num, den: one warp an output, its lanes striding
  // over the blocks in order, then a fixed shuffle tree (the fold kernel's
  // order), reading through L2
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int n_blocks = (int)gridDim.x;
  for (int o = wid; o < 2 * c; o += kWarps) {  // uniform across the warp
    float s = 0.f;
#pragma unroll 8
    for (int b = lid; b < n_blocks; b += 32)
      s = s + __ldcg(part + (long long)b * 2 * c + o);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lid == 0) {
      if (o < c)
        num_out[o] = s;
      else
        den_out[o - c] = s;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
fused_partials_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, long long n,
                      const float* __restrict__ v, int c, float m, float expo,
                      float* __restrict__ part) {
  __shared__ float v_s[MAXC];
  for (int j = threadIdx.x; j < c; j += blockDim.x) v_s[j] = v[j];
  __syncthreads();
  const bool m_is_2 = (m == 2.0f);
  float num[MAXC];
  float den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) num[j] = den[j] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xi = x[i];
    const float wi = w ? w[i] : 1.0f;
    float ui[MAXC];
    fcm::membership_of<MAXC>(xi, v_s, c, m_is_2, expo, ui);
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < c) {
        const float um = (m_is_2 ? ui[j] * ui[j] : powf(ui[j], m)) * wi;
        num[j] = num[j] + um * xi;
        den[j] = den[j] + um;
      }
    }
  }
  fcm::block_partials<MAXC, kThreads>(num, den, c,
                                      part + (long long)blockIdx.x * 2 * c);
}

// part (n_blocks, 2c) -> num (c,), den (c,): one warp per output, its lanes
// stride over the blocks in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ part, int n_blocks, int c,
            float* __restrict__ num, float* __restrict__ den) {
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int n_out = 2 * c;
  for (int o = wid; o < n_out; o += kWarps) {  // uniform across the warp
    float s = 0.f;
    for (int b = lid; b < n_blocks; b += 32)
      s = s + part[(long long)b * n_out + o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lid == 0) {
      if (o < c)
        num[o] = s;
      else
        den[o - c] = s;
    }
  }
}

int fold(const void* part, int n_blocks, int c, void* num, void* den,
         void* stream) {
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)part, n_blocks, c, (float*)num, (float*)den);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int MAXC>
int launch_center(const void* x, const void* u, const void* w, long long n,
                  int c, float m, void* part, int n_blocks, void* ticket,
                  void* num, void* den, void* stream) {
  auto kernel = m == 2.0f ? center_partials_kernel<MAXC, true>
                          : center_partials_kernel<MAXC, false>;
  kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (const float*)w, n, c, m,
      aligned16(x), aligned16(u) && n % 4 == 0, w && aligned16(w),
      (float*)part, (int*)ticket, (float*)num, (float*)den);
  return (int)cudaGetLastError();
}

template <int MAXC>
int launch_fused(const void* x, const void* w, long long n, const void* v,
                 int c, float m, float expo, void* part, int n_blocks,
                 void* num, void* den, void* stream) {
  fused_partials_kernel<MAXC><<<n_blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, n, (const float*)v, c, m, expo,
      (float*)part);
  return fold(part, n_blocks, c, num, den, stream);
}

// Batched vector rows. Grid (row blocks of a lane, feature chunks, lanes).
// A thread takes a grid-stride share of its lane's rows; for each row it
// forms the c squared distances over all D features (d outer, j inner, so
// each d2_j adds its features in index order, as the plain version's sum),
// the Eq. 4 membership, um_j = u_j^m w_i, and adds um_j x_id for the DCH
// features of its block's chunk (and, in chunk 0, um_j to den_j). The
// centers are read through the read-only cache: c * D floats a lane, no
// shared-memory bound on D. acc holds num at [j * DCH + k], den at
// [MAXC * DCH + j]; a block's partials leave compact, c * DCH numerators
// then c denominators, and a fold launch adds the blocks in a fixed order.
template <int MAXC, int DCH>
__global__ void __launch_bounds__(kThreads)
fused_partials_batched_kernel(const float* __restrict__ x,
                              const float* __restrict__ w, long long n, int d,
                              const float* __restrict__ v, int c, float m,
                              float expo, float* __restrict__ part) {
  constexpr int kAcc = MAXC * (DCH + 1);
  __shared__ float warp_s[kWarps][kAcc];
  const int blk = blockIdx.x, chunk = blockIdx.y, lane = blockIdx.z;
  const int d0 = chunk * DCH;
  const bool m_is_2 = (m == 2.0f);
  const float* xl = x + (long long)lane * n * d;
  const float* wl = w + (long long)lane * n;
  const float* vl = v + (long long)lane * c * d;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blk * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float* xi = xl + i * d;
    float u[MAXC];
#pragma unroll
    for (int j = 0; j < MAXC; ++j) u[j] = 0.f;
    for (int f = 0; f < d; ++f) {
      const float xf = __ldg(xi + f);
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < c) {
          const float e = __ldg(vl + (long long)j * d + f) - xf;
          u[j] = u[j] + e * e;
        }
      }
    }
    fcm::membership_from_d2<MAXC>(c, m_is_2, expo, u);
    const float wi = wl[i];
    float xk[DCH];
#pragma unroll
    for (int k = 0; k < DCH; ++k)
      xk[k] = (d0 + k < d) ? __ldg(xi + d0 + k) : 0.f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < c) {
        const float um = (m_is_2 ? u[j] * u[j] : powf(u[j], m)) * wi;
#pragma unroll
        for (int k = 0; k < DCH; ++k)
          acc[j * DCH + k] = acc[j * DCH + k] + um * xk[k];
        acc[MAXC * DCH + j] = acc[MAXC * DCH + j] + um;
      }
    }
  }
  // the block's fold: a fixed shuffle tree in each warp, then the warps in
  // warp order (as fcm::block_partials, over kAcc sums)
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int j = a < MAXC * DCH ? a / DCH : a - MAXC * DCH;
    if (j < c) {  // uniform across the block: every lane shuffles
      float s = acc[a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = s + __shfl_down_sync(0xffffffffu, s, off);
      if (lid == 0) warp_s[wid][a] = s;
    }
  }
  __syncthreads();
  const int n_out = c * DCH + c;
  float* out = part + (((long long)lane * gridDim.y + chunk) * gridDim.x +
                       blk) * n_out;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    const int slot = t < c * DCH ? t : MAXC * DCH + (t - c * DCH);
    float s = warp_s[0][slot];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s = s + warp_s[q][slot];
    out[t] = s;
  }
}

// part (B, n_chunks, n_blocks, c * DCH + c) -> num (B, c, D), den (B, c):
// one block a (chunk, lane), one warp an output, its lanes striding over the
// blocks in order, then a fixed shuffle tree. Chunk 0 writes den.
template <int DCH>
__global__ void __launch_bounds__(kThreads)
fold_batched_kernel(const float* __restrict__ part, int n_blocks, int c,
                    int d, float* __restrict__ num, float* __restrict__ den) {
  const int chunk = blockIdx.x, lane = blockIdx.y;
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int n_out = c * DCH + c;
  const float* p = part + ((long long)lane * gridDim.x + chunk) *
                              (long long)n_blocks * n_out;
  for (int o = wid; o < n_out; o += kWarps) {  // uniform across the warp
    float s = 0.f;
    for (int b = lid; b < n_blocks; b += 32)
      s = s + p[(long long)b * n_out + o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lid == 0) {
      if (o < c * DCH) {
        const int f = chunk * DCH + o % DCH;
        if (f < d) num[((long long)lane * c + o / DCH) * d + f] = s;
      } else if (chunk == 0) {
        den[(long long)lane * c + (o - c * DCH)] = s;
      }
    }
  }
}

// The feature chunk of a cluster tier: the (DCH + 1) * MAXC sums a thread
// carries stay within a register budget that keeps the c = 32 tier free of
// spills.
constexpr int dchunk_of_tier(int tier) { return tier <= 8 ? 4 : 2; }

template <int MAXC>
int launch_fused_batched(const void* x, const void* w, int b, long long n,
                         int d, const void* v, int c, float m, float expo,
                         void* part, int n_blocks, void* num, void* den,
                         void* stream) {
  constexpr int DCH = dchunk_of_tier(MAXC);
  const int n_chunks = (d + DCH - 1) / DCH;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks, n_chunks, b);
  fused_partials_batched_kernel<MAXC, DCH><<<grid, kThreads, 0,
                                             (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, n, d, (const float*)v, c, m, expo,
      (float*)part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_batched_kernel<DCH><<<dim3(n_chunks, b), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)part, n_blocks, c, d, (float*)num, (float*)den);
  return (int)cudaGetLastError();
}

bool bad_args(long long n, int n_blocks) {
  return n < 1 || n_blocks < 1 || n_blocks > 65535;
}

}  // namespace

// x (N,), u (c, N), w (N,) or null, float32 contiguous -> num (c,), den (c,),
// in one launch. part is scratch of n_blocks * 2c floats; ticket is one int
// that is zero on entry and left zero on exit; 1 <= c <= 32.
extern "C" int fcm_center_partials(const void* x, const void* u, const void* w,
                                   long long n, int c, float m, void* part,
                                   int n_blocks, void* ticket, void* num,
                                   void* den, void* stream) {
  if (bad_args(n, n_blocks)) return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch_center<4>(x, u, w, n, c, m, part, n_blocks, ticket, num,
                              den, stream);
    case 8:
      return launch_center<8>(x, u, w, n, c, m, part, n_blocks, ticket, num,
                              den, stream);
    case 16:
      return launch_center<16>(x, u, w, n, c, m, part, n_blocks, ticket, num,
                               den, stream);
    case 32:
      return launch_center<32>(x, u, w, n, c, m, part, n_blocks, ticket, num,
                               den, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (N,), w (N,) or null, v (c,) float32 contiguous -> num (c,), den (c,).
// part is scratch of n_blocks * 2c floats; 1 <= c <= 32; expo is the float32
// exponent -1/(m-1).
extern "C" int fcm_fused_partials(const void* x, const void* w, long long n,
                                  const void* v, int c, float m, float expo,
                                  void* part, int n_blocks, void* num,
                                  void* den, void* stream) {
  if (bad_args(n, n_blocks)) return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch_fused<4>(x, w, n, v, c, m, expo, part, n_blocks, num, den,
                             stream);
    case 8:
      return launch_fused<8>(x, w, n, v, c, m, expo, part, n_blocks, num, den,
                             stream);
    case 16:
      return launch_fused<16>(x, w, n, v, c, m, expo, part, n_blocks, num,
                              den, stream);
    case 32:
      return launch_fused<32>(x, w, n, v, c, m, expo, part, n_blocks, num,
                              den, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The feature chunk DCH of fcm_fused_partials_batched for c clusters (0 when
// no tier holds c): the wrapper sizes part as B * ceil(D / DCH) * n_blocks *
// (c * DCH + c) floats.
extern "C" int fcm_fused_batched_dchunk(int c) {
  const int tier = fcm::tier_of(c);
  return tier == 0 ? 0 : dchunk_of_tier(tier);
}

// x (B, N, D), w (B, N), v (B, c, D) float32 contiguous -> num (B, c, D),
// den (B, c). Every lane holds N rows (zero-weight rows are inert); part is
// scratch (see fcm_fused_batched_dchunk); 1 <= c <= 32, D >= 1, 1 <= B <=
// 65535; expo is the float32 exponent -1/(m-1).
extern "C" int fcm_fused_partials_batched(const void* x, const void* w, int b,
                                          long long n, int d, const void* v,
                                          int c, float m, float expo,
                                          void* part, int n_blocks, void* num,
                                          void* den, void* stream) {
  if (bad_args(n, n_blocks) || b < 1 || b > 65535 || d < 1)
    return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch_fused_batched<4>(x, w, b, n, d, v, c, m, expo, part,
                                     n_blocks, num, den, stream);
    case 8:
      return launch_fused_batched<8>(x, w, b, n, d, v, c, m, expo, part,
                                     n_blocks, num, den, stream);
    case 16:
      return launch_fused_batched<16>(x, w, b, n, d, v, c, m, expo, part,
                                      n_blocks, num, den, stream);
    case 32:
      return launch_fused_batched<32>(x, w, b, n, d, v, c, m, expo, part,
                                      n_blocks, num, den, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
