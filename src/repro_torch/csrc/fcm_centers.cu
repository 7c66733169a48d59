// Eq. 3 center partial sums: num_j = sum_i u_ji^m w_i x_i and
// den_j = sum_i u_ji^m w_i over (N,) scalar pixels, in two forms:
//
//   fcm_center_partials  from a materialized (c, N) membership u
//     (replaces src/repro/kernels/fcm_centers.py::center_partials_pallas,
//     the paper's staged reduction kernels);
//   fcm_fused_partials   from the centers v, the Eq. 4 membership computed in
//     registers and reduced at once, so the (c, N) array never exists
//     (replaces src/repro/kernels/fcm_centers.py::fused_partials_pallas, one
//     launch per FCM iteration): the batched form's D = 1 body at B = 1.
//   fcm_fused_partials_batched  the same fused sums over a bucket of lanes of
//     vector rows, x (B, N, D) and w (B, N) -> num (B, c, D), den (B, c): the
//     batched flat step the solver runs once an iteration under its
//     per-lane-masked loop for lanes past the whole-solve kernels' bounds
//     (c > 8, rows > 2^20 or D > 16). The TPU kernel takes one lane of scalar
//     rows; the lanes are the CUDA form of the JAX route's vmap, on a 1-D
//     grid, so a bucket of any size launches once.
//
// The TPU kernels walk (block_rows, 128) tiles in order on one core and add
// each tile into one (c, 128) accumulator that the grid carries from step to
// step; padding rows weigh 0. Hopper's blocks run in parallel and in no order,
// so nothing carries between them: each block reduces its share of the
// pixels to per-block partial sums, which are then folded in a fixed order
// inside the one launch: the last block to finish (an integer ticket taken
// with an acquire-release add; one a lane in the fused forms) folds every
// block's partials. The tail is masked, not padded.
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
// at 3.35 TB/s). The fused forms read x and w, 4 (D + 1) B a row (4 MB at the
// 1000 KB image, about 1.2 us: a null w means unit weights, not read and not
// multiplied), and spend about c (3 D + 12) float operations on it, 2c of
// them IEEE divisions and
// reciprocals (each a range check and a branch around its fast path): at
// D = 1 the operations bound it on this card (the pixel route's c = 12
// bucket, 16 x 39 277 rows: 5 MB against about 0.2 G instructions). So its
// D = 1 form keeps a lane's centers in registers (tiers 4, 8, 12, 16, 32),
// takes m == 2 and c == tier at compile time where the main path needs them
// (c = 4 and c = 12, m = 2; run-time elsewhere), carries 2c sums, gives a
// thread several rows (their x and w loaded before their math, 16 bytes at
// a time where the lane is aligned) and a lane a block for each 1024-4096
// rows (batched_plan), so the bucket fills the card and a lone lane of 2^20
// rows spreads over it. fcm_fused_partials is that form at one lane: 8 rows a
// thread with unit weights (the 1000 KB image's 500 blocks sit on the card
// at once), or one row a thread where that leaves fewer blocks than SMs or
// m != 2 (kernels/fcm_centers.py::scalar_plan). Wide D takes the chunked
// form: the centers in shared memory, the features in chunks of DCH a block.
//
// Determinism: no float atomics. Each thread adds its pixels in index order,
// each warp folds its threads with a fixed shuffle tree, warp 0's threads add
// the eight warps in warp order, and the last block adds the blocks with a
// fixed lane stride and shuffle tree. The block count depends only on N (in
// the fused forms on the lane's N, D, c and plan), so a run repeats bit for
// bit. The order differs from the plain version's,
// so sums agree to rounding, not bitwise.
//
// Arithmetic per pixel and cluster, as the plain version: um = u * u when
// m == 2, else powf(u, m); um = um * w (weights only); num += um * x;
// den += um.
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
  // over the blocks in order, then a fixed shuffle tree, reading through L2
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

// --- the batched form: a bucket of lanes of vector rows ---------------------
//
// One launch, a 1-D grid: block (lane * chunks + chunk) * blocks + blk, so a
// bucket of any number of lanes launches. A lane's feature chunks and its
// blocks a chunk come from its own shape (kernels/fcm_centers.py::
// batched_plan): a block takes tiles of kThreads * rows_per_thread rows, tile
// blk, blk + blocks, ..., and leaves one partial row; the last block of the
// lane to take its ticket folds the lane's rows in block order (fcm::
// fold_rows) and sets the ticket back to zero. So a lane's bits come from its
// own rows alone, whatever the bucket.

// blocks a (lane, chunk) takes at most; past that its threads stride
constexpr int kBatchedMaxBlocks = 1024;
// the chunked form's rows a thread: about kChunkWork / (tier * D), at least 1
constexpr int kChunkWork = 192;

// The D = 1 form's cluster tiers: the shared ones and 12, the pixel route's
// twelve-class bucket, so that c == tier there too (0 if none holds c).
inline int d1_tier(int c) { return c > 8 && c <= 12 ? 12 : fcm::tier_of(c); }

// quads (four rows) a thread takes in a tile of the D = 1 form, from
// per-block stamps on the card (PERF.md):
// at tier 4, 8 rows with unit weights (48 registers at c == 4, m == 2; the
// 1000 KB image's 500 blocks sit on the card at once), 4 with weights (54;
// 16 took 80 registers and 14 warps an SM); 8 at tier 8; 4 past it
__host__ __device__ constexpr int d1_quads(int tier, bool has_w) {
  return tier <= 4 ? (has_w ? 1 : 2) : tier <= 8 ? 2 : 1;
}

// The feature chunk of the chunked form's cluster tier: the (DCH + 1) * MAXC
// sums a thread carries stay within a register budget that keeps the c = 32
// tier free of spills.
constexpr int dchunk_of_tier(int tier) { return tier <= 8 ? 4 : 2; }

// The plan's rule for rows a thread, from (c, D) and whether weights are
// read (0 if not admitted).
int rows_per_thread_of(int c, int d, bool has_w) {
  if (d < 1) return 0;
  if (d == 1) return d1_tier(c) ? 4 * d1_quads(d1_tier(c), has_w) : 0;
  const int tier = fcm::tier_of(c);
  if (!tier) return 0;
  const long long rows = kChunkWork / ((long long)tier * d);
  return rows < 1 ? 1 : (int)rows;
}

// four rows p[i0 .. i0 + 3] (zeros past n): one 16-byte load when vec. The
// loads keep the default caching: the solver reads the rows every iteration.
__device__ __forceinline__ void load_rows4(const float* __restrict__ p,
                                           long long i0, long long n,
                                           bool vec, float (&q)[4]) {
  if (vec && i0 + 4 <= n) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i0));
    q[0] = t.x;
    q[1] = t.y;
    q[2] = t.z;
    q[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] = i0 + e < n ? __ldg(p + i0 + e) : 0.f;
  }
}

// The D = 1 form: x (B, N), w (B, N) or null, v (B, c) -> part (B, 2c,
// blocks), then num (B, c), den (B, c); the scalar fused partials are its
// B = 1 call. A thread's centers sit in registers; it loads the QUADS quads
// of a tile (x, and w where HAS_W, 16 bytes each where the lane's rows are
// 16-byte aligned) before it adds any, then for each row in index order forms
// the c distances (v_j - x)^2, the Eq. 4 membership, um_j = u_j^m (times w
// where HAS_W: unit weights spend no load or multiply) and adds um_j x to
// num_j and um_j to den_j. It carries 2c sums. FAST: c == MAXC and m == 2
// at compile time (the main path's tiers 4 and 12), else both are run-time
// values. At tiers 4 and 8 the membership's c divisions by one sum go
// through one reciprocal at m == 2 (fcm::quotient_by, the same bits): 1-6 %
// faster there on the card, and 10 % slower on the c = 12 bucket (PERF.md).

template <int MAXC, bool FAST, bool HAS_W, int QUADS = d1_quads(MAXC, HAS_W)>
__global__ void __launch_bounds__(kThreads)
d1_kernel(const float* __restrict__ x, const float* __restrict__ w,
          long long n, const float* __restrict__ v, int c_rt, float m,
          float expo, int blocks, float* __restrict__ part,
          int* __restrict__ ticket, float* __restrict__ num_out,
          float* __restrict__ den_out) {
  // QUADS == 0: one row a thread, a scalar load (small lanes)
  constexpr int kW = QUADS ? 4 : 1;          // rows a load
  constexpr int kLoads = QUADS ? QUADS : 1;  // loads a thread a tile
  const int c = FAST ? MAXC : c_rt;
  const bool m2 = FAST || m == 2.0f;
  const int lane = blockIdx.x / blocks;
  const int blk = blockIdx.x - lane * blocks;
  const float* xl = x + (long long)lane * n;
  const float* wl = HAS_W ? w + (long long)lane * n : nullptr;
  const bool vec_x = ((uintptr_t)xl & 15) == 0;
  const bool vec_w = ((uintptr_t)wl & 15) == 0;
  float vr[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    vr[j] = j < c ? __ldg(v + (long long)lane * c + j) : 0.f;
  float num[MAXC];
  float den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) num[j] = den[j] = 0.f;
  const long long tile = (long long)kW * kLoads * kThreads;
  for (long long t0 = (long long)blk * tile; t0 < n;
       t0 += (long long)blocks * tile) {
    float xq[kLoads][kW], wq[HAS_W ? kLoads : 1][kW];
#pragma unroll
    for (int a = 0; a < kLoads; ++a) {
      const long long i0 = t0 + kW * ((long long)a * kThreads + threadIdx.x);
      if constexpr (kW == 4) {
        load_rows4(xl, i0, n, vec_x, xq[a]);
        if constexpr (HAS_W) load_rows4(wl, i0, n, vec_w, wq[a]);
      } else {
        xq[a][0] = i0 < n ? __ldg(xl + i0) : 0.f;
        if constexpr (HAS_W) wq[a][0] = i0 < n ? __ldg(wl + i0) : 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < kLoads; ++a) {
      const long long i0 = t0 + kW * ((long long)a * kThreads + threadIdx.x);
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (i0 + e < n) {
          const float xi = xq[a][e];
          float u[MAXC];
#pragma unroll
          for (int j = 0; j < MAXC; ++j) {
            float s = 0.f;
            if (j < c) {
              const float dj = vr[j] - xi;
              s = dj * dj;
            }
            u[j] = s;
          }
          fcm::membership_from_d2<MAXC, (MAXC <= 8)>(c, m2, expo, u);
#pragma unroll
          for (int j = 0; j < MAXC; ++j) {
            if (j < c) {
              float um = m2 ? u[j] * u[j] : powf(u[j], m);
              if constexpr (HAS_W) um = um * wq[a][e];
              num[j] = num[j] + um * xi;
              den[j] = den[j] + um;
            }
          }
        }
      }
    }
  }
  // the lane's partials are (output, block), block fastest
  float* lp = part + (long long)lane * 2 * c * blocks;
  float* nl = num_out + (long long)lane * c;
  float* dl = den_out + (long long)lane * c;
  fcm::block_partials<MAXC, kThreads>(num, den, c, lp + blk, blocks);
  if (blocks == 1) {  // uniform: the block's sums are the lane's
    // thread t < 2c stored output t just above; it copies its own store
    const int t = threadIdx.x;
    if (t < c)
      nl[t] = lp[t];
    else if (t < 2 * c)
      dl[t - c] = lp[t];
    return;
  }
  if (!fcm::last_to_arrive(ticket + lane, blocks)) return;
  fcm::fold_rows<kThreads>(
      2 * c, blocks, [&](int o) { return lp + (long long)o * blocks; },
      [&](int o, float s) {
        if (o < c)
          nl[o] = s;
        else
          dl[o - c] = s;
      });
  if (threadIdx.x == 0) ticket[lane] = 0;
}

// The chunked form, any D: x (B, N, D), w (B, N), v (B, c, D) -> part (B,
// chunks, c * DCH + c, blocks), then num (B, c, D), den (B, c). A block
// takes the DCH features of its chunk: for each row it forms the c squared
// distances over all D features (d outer, j inner, so each d2_j adds its
// features in index order, as the plain version's sum), the Eq. 4
// membership, um_j = u_j^m w, and adds um_j x_id for its chunk's features
// and um_j to den_j (chunk 0's den is the one folded). The lane's centers sit
// in shared memory when v_shared (c * D floats within what the 48 KB a block
// has without opting in leaves beside the kernel's own shared memory), else
// they are read through the cache. acc holds num at [j * DCH + k], den at
// [MAXC * DCH + j]; a block's row leaves compact, c * DCH numerators then c
// denominators.
template <int MAXC, int DCH, bool M2>
__global__ void __launch_bounds__(kThreads)
batched_chunk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     long long n, int d, const float* __restrict__ v, int c,
                     float m, float expo, int chunks, int blocks,
                     int rows_per_thread, bool v_shared,
                     float* __restrict__ part, int* __restrict__ ticket,
                     float* __restrict__ num_out,
                     float* __restrict__ den_out) {
  constexpr int kAcc = MAXC * (DCH + 1);
  extern __shared__ float v_s[];
  __shared__ float warp_s[kWarps][kAcc];
  const int per_lane = chunks * blocks;
  const int lane = blockIdx.x / per_lane;
  const int rest = blockIdx.x - lane * per_lane;
  const int chunk = rest / blocks;
  const int blk = rest - chunk * blocks;
  const int d0 = chunk * DCH;
  const float* xl = x + (long long)lane * n * d;
  const float* wl = w + (long long)lane * n;
  const float* vl = v + (long long)lane * c * d;
  if (v_shared) {  // uniform across the block
    for (int i = threadIdx.x; i < c * d; i += kThreads) v_s[i] = vl[i];
    __syncthreads();
  }
  const float* vc = v_shared ? v_s : vl;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  const long long tile = (long long)rows_per_thread * kThreads;
  for (long long t0 = (long long)blk * tile; t0 < n;
       t0 += (long long)blocks * tile) {
    for (int q = 0; q < rows_per_thread; ++q) {
      const long long i = t0 + (long long)q * kThreads + threadIdx.x;
      if (i >= n) break;
      const float* xi = xl + i * d;
      float u[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) u[j] = 0.f;
      for (int f = 0; f < d; ++f) {
        const float xf = __ldg(xi + f);
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          if (j < c) {
            const float e = vc[j * d + f] - xf;
            u[j] = u[j] + e * e;
          }
        }
      }
      fcm::membership_from_d2<MAXC>(c, M2, expo, u);
      const float wi = __ldg(wl + i);
      float xk[DCH];
#pragma unroll
      for (int k = 0; k < DCH; ++k)
        xk[k] = (d0 + k < d) ? __ldg(xi + d0 + k) : 0.f;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < c) {
          const float um = (M2 ? u[j] * u[j] : powf(u[j], m)) * wi;
#pragma unroll
          for (int k = 0; k < DCH; ++k)
            acc[j * DCH + k] = acc[j * DCH + k] + um * xk[k];
          acc[MAXC * DCH + j] = acc[MAXC * DCH + j] + um;
        }
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
  // the lane's partials are (chunk, slot, block), block fastest
  const int n_row = c * DCH + c;
  float* lp = part + (long long)lane * chunks * n_row * blocks;
  float* row = lp + (long long)chunk * n_row * blocks + blk;
  for (int t = threadIdx.x; t < n_row; t += kThreads) {
    const int slot = t < c * DCH ? t : MAXC * DCH + (t - c * DCH);
    float s = warp_s[0][slot];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s = s + warp_s[q][slot];
    row[(long long)t * blocks] = s;
  }
  if (!fcm::last_to_arrive(ticket + lane, per_lane)) return;
  // output o < c * D is num (j, f) = (o / D, o % D), from the chunk of f;
  // the c after it are den, from chunk 0
  float* nl = num_out + (long long)lane * c * d;
  float* dl = den_out + (long long)lane * c;
  fcm::fold_rows<kThreads>(
      c * d + c, blocks,
      [&](int o) -> const float* {
        if (o >= c * d) return lp + (long long)(c * DCH + o - c * d) * blocks;
        const int j = o / d;
        const int f = o - j * d;
        const int ch = f / DCH;
        return lp + ((long long)ch * n_row + j * DCH + (f - ch * DCH)) *
                        blocks;
      },
      [&](int o, float s) {
        if (o < c * d)
          nl[o] = s;
        else
          dl[o - c * d] = s;
      });
  if (threadIdx.x == 0) ticket[lane] = 0;
}

// FAST instances: c == tier == 4 or 12 and m == 2; at tier 12 only with
// weights (the pixel route's twelve-class bucket). QUADS: the tier's quads a
// thread, or 0 for one row a thread (the scalar fused partials of a small
// lane).
template <int MAXC, bool HAS_W, int QUADS>
int launch_d1(const void* x, const void* w, int b, long long n,
              const void* v, int c, float m, float expo, int blocks,
              void* part, void* ticket, void* num, void* den,
              cudaStream_t st) {
  auto kernel = d1_kernel<MAXC, false, HAS_W, QUADS>;
  if constexpr (MAXC == 4 || (MAXC == 12 && HAS_W))
    if (c == MAXC && m == 2.0f) kernel = d1_kernel<MAXC, true, HAS_W, QUADS>;
  kernel<<<(unsigned)((long long)b * blocks), kThreads, 0, st>>>(
      (const float*)x, (const float*)w, n, (const float*)v, c, m, expo,
      blocks, (float*)part, (int*)ticket, (float*)num, (float*)den);
  return (int)cudaGetLastError();
}

template <int MAXC, bool HAS_W>
int launch_d1_rows(const void* x, const void* w, int b, long long n,
                   const void* v, int c, float m, float expo, int blocks,
                   int rows_per_thread, void* part, void* ticket, void* num,
                   void* den, cudaStream_t st) {
  if (rows_per_thread == 1)
    return launch_d1<MAXC, HAS_W, 0>(x, w, b, n, v, c, m, expo, blocks, part,
                                     ticket, num, den, st);
  return launch_d1<MAXC, HAS_W, d1_quads(MAXC, HAS_W)>(
      x, w, b, n, v, c, m, expo, blocks, part, ticket, num, den, st);
}

// The D = 1 form over b lanes, w null for unit weights; rows_per_thread is
// the tier's (rows_per_thread_of) or 1.
int launch_d1_tier(const void* x, const void* w, int b, long long n,
                   const void* v, int c, float m, float expo, int blocks,
                   int rows_per_thread, void* part, void* ticket, void* num,
                   void* den, cudaStream_t st) {
  if ((long long)b * blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (d1_tier(c)) {
#define FCM_D1(T)                                                            \
  case T:                                                                    \
    return w ? launch_d1_rows<T, true>(x, w, b, n, v, c, m, expo, blocks,    \
                                       rows_per_thread, part, ticket, num,   \
                                       den, st)                              \
             : launch_d1_rows<T, false>(x, w, b, n, v, c, m, expo, blocks,   \
                                        rows_per_thread, part, ticket, num,  \
                                        den, st);
    FCM_D1(4)
    FCM_D1(8)
    FCM_D1(12)
    FCM_D1(16)
    FCM_D1(32)
#undef FCM_D1
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory a block gets without opting in, static included
constexpr long long kBlockSharedBytes = 48 * 1024;

template <int MAXC>
int launch_chunked(const void* x, const void* w, int b, long long n, int d,
                   const void* v, int c, float m, float expo, int blocks,
                   int rows_per_thread, void* part, void* ticket, void* num,
                   void* den, cudaStream_t st) {
  constexpr int DCH = dchunk_of_tier(MAXC);
  const int chunks = (d + DCH - 1) / DCH;
  const long long grid = (long long)b * chunks * blocks;
  if (grid > 0x7fffffffLL || (long long)chunks * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = m == 2.0f ? batched_chunk_kernel<MAXC, DCH, true>
                          : batched_chunk_kernel<MAXC, DCH, false>;
  // the centers go to shared memory where they fit beside the kernel's
  // static shared memory (warp_s, the ticket's flag), the same for both
  // values of M2; read once a tier
  static long long static_bytes = -1;
  if (static_bytes < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    static_bytes = (long long)attr.sharedSizeBytes;
  }
  const long long v_bytes = 4LL * c * d;
  const bool v_shared = v_bytes + static_bytes <= kBlockSharedBytes;
  kernel<<<(unsigned)grid, kThreads, v_shared ? (size_t)v_bytes : 0, st>>>(
      (const float*)x, (const float*)w, n, d, (const float*)v, c, m, expo,
      chunks, blocks, rows_per_thread, v_shared, (float*)part, (int*)ticket,
      (float*)num, (float*)den);
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

// x (N,), w (N,) or null (unit weights), v (c,) float32 contiguous -> num
// (c,), den (c,), in one launch: the D = 1 form at B = 1. blocks and
// rows_per_thread come from kernels/fcm_centers.py::scalar_plan (rows_per_
// thread is fcm_batched_rows_per_thread(c, 1, w != null), or 1 for a lane
// too small to give the tier's rows a block on each SM); part is
// scratch of 2c * blocks floats; ticket is one int that is zero on entry and
// left zero on exit; 1 <= c <= 32; expo is the float32 exponent -1/(m-1).
extern "C" int fcm_fused_partials(const void* x, const void* w, long long n,
                                  const void* v, int c, float m, float expo,
                                  int blocks, int rows_per_thread, void* part,
                                  void* ticket, void* num, void* den,
                                  void* stream) {
  if (n < 1 || blocks < 1 || blocks > kBatchedMaxBlocks ||
      (rows_per_thread != 1 &&
       rows_per_thread != rows_per_thread_of(c, 1, w != nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_d1_tier(x, w, 1, n, v, c, m, expo, blocks, rows_per_thread,
                        part, ticket, num, den, (cudaStream_t)stream);
}

extern "C" int fcm_batched_threads() { return kThreads; }
extern "C" int fcm_batched_max_blocks() { return kBatchedMaxBlocks; }

// The cluster tier fcm_fused_partials_batched takes for (c, D): the D = 1
// form's (4, 8, 12, 16, 32) at D = 1, else the shared ones (0 if none).
extern "C" int fcm_batched_tier(int c, int d) {
  return d == 1 ? d1_tier(c) : d > 1 ? fcm::tier_of(c) : 0;
}

// Features a block's chunk holds for (c, D): 1 at D = 1 (0 if not admitted).
extern "C" int fcm_batched_dchunk(int c, int d) {
  const int tier = fcm_batched_tier(c, d);
  return tier == 0 ? 0 : d == 1 ? 1 : dchunk_of_tier(tier);
}

// Rows a thread takes in a tile for (c, D), with or without weights (0 if
// not admitted).
extern "C" int fcm_batched_rows_per_thread(int c, int d, int has_w) {
  return rows_per_thread_of(c, d, has_w != 0);
}

// x (B, N, D), w (B, N), v (B, c, D) float32 contiguous -> num (B, c, D),
// den (B, c), in one launch. Every lane holds N rows (zero-weight rows are
// inert). blocks (a lane's blocks a chunk, at most fcm_batched_max_blocks)
// and rows_per_thread (fcm_batched_rows_per_thread's) come from
// kernels/fcm_centers.py::batched_plan; part is scratch of B * chunks *
// blocks * (c * DCH + c) floats (chunks = ceil(D / DCH), DCH =
// fcm_batched_dchunk); ticket holds B ints that are zero on entry and left
// zero on exit. 1 <= c <= 32, D >= 1, B >= 1; expo is the float32 exponent
// -1/(m-1).
extern "C" int fcm_fused_partials_batched(const void* x, const void* w, int b,
                                          long long n, int d, const void* v,
                                          int c, float m, float expo,
                                          int blocks, int rows_per_thread,
                                          void* part, void* ticket, void* num,
                                          void* den, void* stream) {
  const int tier = fcm_batched_tier(c, d);
  if (n < 1 || b < 1 || tier == 0 || blocks < 1 ||
      blocks > kBatchedMaxBlocks ||
      rows_per_thread != rows_per_thread_of(c, d, true))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 1)
    return launch_d1_tier(x, w, b, n, v, c, m, expo, blocks, rows_per_thread,
                          part, ticket, num, den, st);
  switch (tier) {
#define FCM_BATCHED_CHUNKED(T)                                               \
  case T:                                                                    \
    return launch_chunked<T>(x, w, b, n, d, v, c, m, expo, blocks,           \
                             rows_per_thread, part, ticket, num, den, st);
    FCM_BATCHED_CHUNKED(4)
    FCM_BATCHED_CHUNKED(8)
    FCM_BATCHED_CHUNKED(16)
    FCM_BATCHED_CHUNKED(32)
#undef FCM_BATCHED_CHUNKED
    default:
      return (int)cudaErrorInvalidValue;
  }
}
