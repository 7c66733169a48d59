// One FCM_S (spatially regularized FCM) step over a bucket of same-shape
// lanes: the Eq. 3' partial sums num_j = sum_i u_ji^m (x_i + alpha xbar_i) and
// den_j = sum_i u_ji^m of every lane, with u the Eq. 4' membership on the
// effective distances d2_ji + alpha * mean_{r in N_i} d2_jr. The caller forms
// v'_j = num_j / max((1 + alpha) den_j, 1e-12).
//
// Replaces src/repro/kernels/fcm_spatial.py::spatial_partials_pallas_2d
// (4 or 8 neighbors over an (H, W) image) and ::spatial_partials_pallas_3d
// (6 neighbors over a (D, H, W) volume). The TPU kernels walk row blocks (or
// depth slices) of a grid padded to (8, 128) tiles, see the halo rows through
// three clamped copies of the grid (block i-1, i, i+1), mask the padding with
// a validity sheet, and carry one (c, 128) accumulator from grid step to grid
// step. None of that is carried over: here the grid is unpadded, each block
// masks its own edge by coordinates, and the sums leave as per-block partials
// that a second launch folds in a fixed order (as in fcm_centers.cu).
//
// 2-D design (spatial_partials_kernel): one thread a pixel. A block of 256
// threads covers a 32 x 8 tile of the image and stages the tile plus a halo
// of one pixel on each side in shared memory. The grid is (tiles of a lane,
// lanes), so one launch serves a whole bucket: the host loop of the batched
// solve costs one step launch (and its fold) an iteration.
//
// 3-D design (spatial3d_march_kernel): a block owns a 32 x 8 column of the
// volume over a run of z_run consecutive planes (2.5-D blocking) and marches
// along z. A thread keeps its own column's values at z - 1, z and z + 1 in
// registers and rotates them a plane at a time, so the z-neighbors cost no
// memory access; only the current plane's tile and its one-pixel in-plane
// halo go through shared memory, double-buffered, one __syncthreads a plane.
// Plane z + 2's value and plane z + 1's halo are loaded into registers before
// plane z is computed, so the loads are in flight during the arithmetic; each
// voxel leaves device memory once a step, plus the halo and two planes a run.
// A thread adds its num/den over the run's planes in registers before the
// block's one fold, so a lane leaves tiles * runs partial rows (2 016 at
// 181x217x181 in runs of 16 planes, against 30 408 one plane a block), which
// the 2-D path's fold then adds up. A tile whose pixels all have their four
// in-plane neighbors in the grid skips the bounds tests on its inner planes,
// with cnt = 6 known at compile time. The run length comes from
// kernels/fcm_spatial.py::spatial3d_plan, from the lane's shape alone.
//
// A thread computes, for its pixel:
//   - over the in-grid neighbors, in the order of
//     repro_torch.core.spatial.neighbor_offsets (the neighbor of offset o sits
//     at i - o: in 3-D z + 1, z - 1, then down, up, right, left), the count
//     cnt, the intensity sum sx and, per cluster, the sum of squared neighbor
//     distances nb_j = sum (v_j - x_r)^2; an out-of-grid neighbor adds
//     nothing, which is what the plain version's zero-filled shifts add
//     (exact zeros);
//   - cnt = max(cnt, 1), d2e_j = (v_j - x)^2 + alpha * (nb_j / cnt) (an IEEE
//     division, also at cnt = 6), the Eq. 4 membership of d2e with the 1e-12
//     floor and the even split over zero distances (fcm_common.cuh), u^m
//     (u * u when m == 2, else powf), and x + alpha * (sx / cnt).
// The order and rounding of each of these float32 operations are the plain
// version's (kernels/fcm_spatial.py::spatial_partials_plain); the library is
// compiled with --fmad=false. Only the sums over pixels run in another order.
//
// What bounds it on an H100: operations. A pixel is read once (4 B, its halo
// neighbors come from shared memory or registers) but costs about
// c (3 k + 12) float operations for k neighbors, 3c + 1 of them IEEE
// divisions or reciprocals: at the 1000 KB image (1,024,000 pixels, c = 4,
// k = 8) about 150 MFLOP against 4 MB read.
//
// Determinism: no float atomics. Each block folds its threads with a fixed
// shuffle tree and warp order; the fold kernel, one block a lane, adds a
// fixed stride of the lane's partial rows in each thread and folds its
// threads the same way. The rows depend on the lane's shape alone, so a
// lane's bits do not depend on its bucket, and a run repeats bit for bit.
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

// The neighbors of offsets (oy, ox) in neighbor_offsets order sit at
// (y - oy, x - ox): down, up, right, left, then the four diagonals.
__device__ __constant__ int kDy2[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__device__ __constant__ int kDx2[8] = {0, 0, 1, -1, 1, -1, 1, -1};

// Adds one in-grid neighbor xs to the running stencil sums.
template <int MAXC>
__device__ __forceinline__ void add_neighbor(float xs, const float* v_s, int c,
                                             float& cnt, float& sx,
                                             float (&nb)[MAXC]) {
  cnt = cnt + 1.0f;
  sx = sx + xs;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      const float e = v_s[j] - xs;
      nb[j] = nb[j] + e * e;
    }
  }
}

// The Eq. 4' / 3' terms of one pixel x with its stencil sums: num[j] =
// u_j^m * (x + alpha * xbar), den[j] = u_j^m.
template <int MAXC>
__device__ __forceinline__ void pixel_terms(float x, float cnt, float sx,
                                            const float (&nb)[MAXC],
                                            const float* v_s, int c,
                                            float alpha, bool m_is_2, float m,
                                            float expo, float (&num)[MAXC],
                                            float (&den)[MAXC]) {
  cnt = cnt < 1.0f ? 1.0f : cnt;
  float u[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    float s = 0.f;
    if (j < c) {
      const float e = v_s[j] - x;
      s = e * e + alpha * (nb[j] / cnt);
    }
    u[j] = s;
  }
  fcm::membership_from_d2<MAXC>(c, m_is_2, expo, u);
  const float xe = x + alpha * (sx / cnt);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      const float um = m_is_2 ? u[j] * u[j] : powf(u[j], m);
      num[j] = um * xe;
      den[j] = um;
    }
  }
}

// x (B, D, H, W) (D = 1 and THREE_D false for 2-D), v (B, c) ->
// part (B, n_tiles, 2c). Block (tile, lane); tiles run x fastest, then y,
// then z.
template <int MAXC, bool THREE_D>
__global__ void __launch_bounds__(kThreads)
spatial_partials_kernel(const float* __restrict__ x,
                        const float* __restrict__ v, int depth, int h, int w,
                        int c, int neighbors, float alpha, float m, float expo,
                        int tiles_x, int tiles_y, float* __restrict__ part) {
  __shared__ float s[kTileH + 2][kTileW + 2];
  __shared__ float s_zp[THREE_D ? kTileH : 1][THREE_D ? kTileW : 1];
  __shared__ float s_zm[THREE_D ? kTileH : 1][THREE_D ? kTileW : 1];
  __shared__ float v_s[MAXC];

  const int lane = blockIdx.y;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int rest = tile / tiles_x;
  const int ty = rest % tiles_y;
  const int z = rest / tiles_y;
  const int x0 = tx * kTileW;
  const int y0 = ty * kTileH;
  const long long plane = (long long)h * w;
  const float* xl = x + (long long)lane * depth * plane;
  const float* xz = xl + (long long)z * plane;
  const int tid = threadIdx.x;

  for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += kThreads) {
    const int r = i / (kTileW + 2);
    const int q = i - r * (kTileW + 2);
    const int yy = y0 + r - 1;
    const int xx = x0 + q - 1;
    s[r][q] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                  ? xz[(long long)yy * w + xx]
                  : 0.f;
  }
  const int ly = tid / kTileW;
  const int lx = tid - ly * kTileW;
  const int y = y0 + ly;
  const int xc = x0 + lx;
  const bool inside = y < h && xc < w;
  if constexpr (THREE_D) {
    s_zp[ly][lx] = (inside && z + 1 < depth)
                       ? xz[plane + (long long)y * w + xc]
                       : 0.f;
    s_zm[ly][lx] = (inside && z > 0) ? xz[-plane + (long long)y * w + xc]
                                     : 0.f;
  }
  for (int j = tid; j < c; j += kThreads) v_s[j] = v[(long long)lane * c + j];
  __syncthreads();

  const bool m_is_2 = (m == 2.0f);
  float num[MAXC];
  float den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) num[j] = den[j] = 0.f;
  if (inside) {
    float cnt = 0.f;
    float sx = 0.f;
    float nb[MAXC];
#pragma unroll
    for (int j = 0; j < MAXC; ++j) nb[j] = 0.f;
    if constexpr (THREE_D) {
      // offsets (-1,0,0), (1,0,0): the slices below and above
      if (z + 1 < depth) add_neighbor<MAXC>(s_zp[ly][lx], v_s, c, cnt, sx, nb);
      if (z > 0) add_neighbor<MAXC>(s_zm[ly][lx], v_s, c, cnt, sx, nb);
    }
    const int k = THREE_D ? 4 : neighbors;
    for (int o = 0; o < k; ++o) {
      const int yy = y + kDy2[o];
      const int xx = xc + kDx2[o];
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        add_neighbor<MAXC>(s[ly + 1 + kDy2[o]][lx + 1 + kDx2[o]], v_s, c, cnt,
                           sx, nb);
    }
    pixel_terms<MAXC>(s[ly + 1][lx + 1], cnt, sx, nb, v_s, c, alpha, m_is_2, m,
                      expo, num, den);
  }
  fcm::block_partials<MAXC, kThreads>(
      num, den, c,
      part + ((long long)lane * gridDim.x + tile) * 2 * c);
}

// part (B, n_tiles, 2c) -> out (B, 2c): one block a lane; thread t adds the
// rows of tiles t, t + 256, ... in order (neighboring threads read
// neighboring rows), then the block folds its threads in a fixed order.
template <int MAXC>
__global__ void __launch_bounds__(kThreads)
fold_lanes_kernel(const float* __restrict__ part, int n_tiles, int c,
                  float* __restrict__ out) {
  const int lane = blockIdx.x;
  const float* pl = part + (long long)lane * n_tiles * 2 * c;
  float num[MAXC];
  float den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) num[j] = den[j] = 0.f;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const float* row = pl + (long long)t * 2 * c;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < c) {
        num[j] = num[j] + row[j];
        den[j] = den[j] + row[c + j];
      }
    }
  }
  fcm::block_partials<MAXC, kThreads>(num, den, c,
                                      out + (long long)lane * 2 * c);
}

// --- 3-D: march along z ----------------------------------------------------

// The march's tile: one thread a column, kMarchW x kMarchH columns a block.
constexpr int kMarchW = 32;
constexpr int kMarchH = 8;
constexpr int kMarchThreads = kMarchW * kMarchH;
// threads that load the in-plane halo: a row above, a row below, a column
// on each side (the 6-connected stencil reads no corner)
constexpr int kHaloSlots = 2 * kMarchW + 2 * kMarchH;
static_assert(kHaloSlots <= kMarchThreads, "one halo value a thread");

// The six-neighbor stencil sums of one voxel and its Eq. 4' / 3' terms,
// added to the thread's run sums. xz, xm, xp: the voxel's column at z,
// z - 1 and z + 1; t: the plane's staged tile with its halo, the voxel at
// t[ly + 1][lx + 1]. INTERIOR: every neighbor is in the grid (cnt = 6 at
// compile time, no tests); else the has_* flags say which are.
template <int MAXC, bool M2, bool INTERIOR>
__device__ __forceinline__ void voxel_terms(
    float xz, float xm, float xp, const float (*t)[kMarchW + 2], int ly,
    int lx,
    bool has_zp, bool has_zm, bool has_dn, bool has_up, bool has_rt,
    bool has_lf, const float (&vr)[MAXC], int c, float alpha, float m,
    float expo, float (&acc_num)[MAXC], float (&acc_den)[MAXC]) {
  float cnt = 0.f;
  float sx = 0.f;
  float nb[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) nb[j] = 0.f;
  if (INTERIOR || has_zp) add_neighbor<MAXC>(xp, vr, c, cnt, sx, nb);
  if (INTERIOR || has_zm) add_neighbor<MAXC>(xm, vr, c, cnt, sx, nb);
  if (INTERIOR || has_dn)
    add_neighbor<MAXC>(t[ly + 2][lx + 1], vr, c, cnt, sx, nb);
  if (INTERIOR || has_up) add_neighbor<MAXC>(t[ly][lx + 1], vr, c, cnt, sx, nb);
  if (INTERIOR || has_rt)
    add_neighbor<MAXC>(t[ly + 1][lx + 2], vr, c, cnt, sx, nb);
  if (INTERIOR || has_lf) add_neighbor<MAXC>(t[ly + 1][lx], vr, c, cnt, sx, nb);
  float num[MAXC];
  float den[MAXC];
  pixel_terms<MAXC>(xz, cnt, sx, nb, vr, c, alpha, M2, m, expo, num, den);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      acc_num[j] = acc_num[j] + num[j];
      acc_den[j] = acc_den[j] + den[j];
    }
  }
}

// x (B, D, H, W), v (B, c) -> part (B, runs, tiles, 2c). Block (tile of the
// plane, run of z_run planes, lane); tiles run x fastest. EXACT: c == MAXC,
// so no cluster test is left in the unrolled loops; M2: m == 2.
template <int MAXC, bool EXACT, bool M2>
__global__ void __launch_bounds__(kMarchThreads)
spatial3d_march_kernel(const float* __restrict__ x,
                       const float* __restrict__ v, int depth, int h, int w,
                       int c_rt, float alpha, float m, float expo, int tiles_x,
                       int z_run, float* __restrict__ part) {
  __shared__ float s[2][kMarchH + 2][kMarchW + 2];
  const int c = EXACT ? MAXC : c_rt;
  const int lane = blockIdx.z;
  const int run = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int x0 = (tile - ty * tiles_x) * kMarchW;
  const int y0 = ty * kMarchH;
  const int z0 = run * z_run;
  const int z1 = min(depth, z0 + z_run);
  const long long plane = (long long)h * w;
  const float* xl = x + (long long)lane * depth * plane;
  const int tid = threadIdx.x;
  const int ly = tid / kMarchW;
  const int lx = tid % kMarchW;
  const int y = y0 + ly;
  const int xc = x0 + lx;
  const bool inside = y < h && xc < w;
  const bool tile_interior =
      x0 >= 1 && y0 >= 1 && x0 + kMarchW < w && y0 + kMarchH < h;

  // this thread's halo slot: row 0 and row kMarchH + 1 of the staged tile,
  // then column 0 and column kMarchW + 1
  int hy = -1, hx = 0;
  if (tid < kMarchW) {
    hy = 0;
    hx = tid + 1;
  } else if (tid < 2 * kMarchW) {
    hy = kMarchH + 1;
    hx = tid - kMarchW + 1;
  } else if (tid < 2 * kMarchW + kMarchH) {
    hy = tid - 2 * kMarchW + 1;
    hx = 0;
  } else if (tid < kHaloSlots) {
    hy = tid - 2 * kMarchW - kMarchH + 1;
    hx = kMarchW + 1;
  }
  const bool halo = hy >= 0;
  const int hgy = y0 + hy - 1;
  const int hgx = x0 + hx - 1;
  const bool halo_in = halo && hgy >= 0 && hgy < h && hgx >= 0 && hgx < w;
  const long long halo_off = halo_in ? (long long)hgy * w + hgx : 0;
  const long long own_off = inside ? (long long)y * w + xc : 0;

  float vr[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    vr[j] = j < c ? v[(long long)lane * c + j] : 0.f;
  float acc_num[MAXC];
  float acc_den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) acc_num[j] = acc_den[j] = 0.f;

  // the column at z - 1, z, z + 1 and the halo of plane z
  const float* col = xl + own_off;
  float xm = (inside && z0 > 0) ? col[(z0 - 1) * plane] : 0.f;
  float xz = inside ? col[z0 * plane] : 0.f;
  float xp = (inside && z0 + 1 < depth) ? col[(z0 + 1) * plane] : 0.f;
  float hv = halo_in ? xl[z0 * plane + halo_off] : 0.f;
  // plane z + 2 of the column (the run's last plane needs z1 as its z + 1)
  // and plane z + 1 of the halo, loaded while plane z is computed
  const float* next_col = col + (z0 + 2) * plane;
  const float* next_halo = xl + halo_off + (z0 + 1) * plane;
  const int col_last = min(z1, depth - 1) - 2;
  const int halo_last = z1 - 2;
  // the planes whose six neighbors are all in the grid
  const int zi0 = tile_interior ? max(z0, 1) : z1;
  const int zi1 = min(z1, depth - 1);
  int buf = 0;
  // unrolled by two: the buffer and the register rotation resolve at
  // compile time
#pragma unroll 2
  for (int z = z0; z < z1; ++z) {
    float(*t)[kMarchW + 2] = s[buf];
    t[ly + 1][lx + 1] = xz;
    if (halo) t[hy][hx] = hv;
    const float xn = (inside && z <= col_last) ? *next_col : 0.f;
    const float hn = (halo_in && z <= halo_last) ? *next_halo : 0.f;
    next_col += plane;
    next_halo += plane;
    __syncthreads();
    if (z >= zi0 && z < zi1) {
      voxel_terms<MAXC, M2, true>(xz, xm, xp, t, ly, lx, true, true, true,
                                  true, true, true, vr, c, alpha, m, expo,
                                  acc_num, acc_den);
    } else if (inside) {
      voxel_terms<MAXC, M2, false>(xz, xm, xp, t, ly, lx, z + 1 < depth,
                                   z > 0, y + 1 < h, y > 0, xc + 1 < w,
                                   xc > 0, vr, c, alpha, m, expo, acc_num,
                                   acc_den);
    }
    xm = xz;
    xz = xp;
    xp = xn;
    hv = hn;
    buf ^= 1;
  }
  fcm::block_partials<MAXC, kMarchThreads>(
      acc_num, acc_den, c,
      part + (((long long)lane * gridDim.y + run) * gridDim.x + tile) * 2 * c);
}

// The march's grid for a (depth, h, w) lane: tiles of a plane and runs.
inline void march_grid(int depth, int h, int w, int z_run, long long& tiles,
                       long long& runs) {
  tiles = (long long)((w + kMarchW - 1) / kMarchW) *
          ((h + kMarchH - 1) / kMarchH);
  runs = (depth + (long long)z_run - 1) / z_run;
}

int launch_2d(int tier, const void* x, const void* v, int n_lanes, int h,
              int w, int c, int neighbors, float alpha, float m, float expo,
              void* part, void* out, void* stream) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const long long n_tiles = (long long)tiles_x * tiles_y;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_lanes, 1);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* vf = (const float*)v;
  switch (tier) {
#define FCM_SPATIAL_2D(T)                                                    \
  case T:                                                                    \
    spatial_partials_kernel<T, false><<<grid, kThreads, 0, st>>>(            \
        xf, vf, 1, h, w, c, neighbors, alpha, m, expo, tiles_x, tiles_y,     \
        (float*)part);                                                       \
    break;
    FCM_SPATIAL_2D(4)
    FCM_SPATIAL_2D(8)
    FCM_SPATIAL_2D(16)
    FCM_SPATIAL_2D(32)
#undef FCM_SPATIAL_2D
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int MAXC, bool EXACT>
int launch_march(const void* x, const void* v, int n_lanes, int depth, int h,
                 int w, int c, float alpha, float m, float expo, int z_run,
                 void* part, void* stream) {
  long long tiles, runs;
  march_grid(depth, h, w, z_run, tiles, runs);
  if (tiles > 0x7fffffffLL || runs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)runs, (unsigned)n_lanes);
  const int tiles_x = (w + kMarchW - 1) / kMarchW;
  const cudaStream_t st = (cudaStream_t)stream;
  if (m == 2.0f)
    spatial3d_march_kernel<MAXC, EXACT, true><<<grid, kMarchThreads, 0, st>>>(
        (const float*)x, (const float*)v, depth, h, w, c, alpha, m, expo,
        tiles_x, z_run, (float*)part);
  else
    spatial3d_march_kernel<MAXC, EXACT, false><<<grid, kMarchThreads, 0, st>>>(
        (const float*)x, (const float*)v, depth, h, w, c, alpha, m, expo,
        tiles_x, z_run, (float*)part);
  return (int)cudaGetLastError();
}

int launch_3d(int tier, const void* x, const void* v, int n_lanes, int depth,
              int h, int w, int c, float alpha, float m, float expo, int z_run,
              void* part, void* stream) {
  const bool exact = c == tier;
  switch (tier) {
#define FCM_SPATIAL_3D(T)                                                    \
  case T:                                                                    \
    return exact ? launch_march<T, true>(x, v, n_lanes, depth, h, w, c,      \
                                         alpha, m, expo, z_run, part,        \
                                         stream)                             \
                 : launch_march<T, false>(x, v, n_lanes, depth, h, w, c,     \
                                          alpha, m, expo, z_run, part,       \
                                          stream);
    FCM_SPATIAL_3D(4)
    FCM_SPATIAL_3D(8)
    FCM_SPATIAL_3D(16)
    FCM_SPATIAL_3D(32)
#undef FCM_SPATIAL_3D
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fixed-order fold of each lane's n_rows partial rows into out (B, 2c).
int fold(int tier, const void* part, int n_lanes, long long n_rows, int c,
         void* out, void* stream) {
  if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tier) {
#define FCM_SPATIAL_FOLD(T)                                                  \
  case T:                                                                    \
    fold_lanes_kernel<T><<<n_lanes, kThreads, 0, st>>>(                      \
        (const float*)part, (int)n_rows, c, (float*)out);                    \
    break;
    FCM_SPATIAL_FOLD(4)
    FCM_SPATIAL_FOLD(8)
    FCM_SPATIAL_FOLD(16)
    FCM_SPATIAL_FOLD(32)
#undef FCM_SPATIAL_FOLD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcm_spatial_tile_w() { return kTileW; }
extern "C" int fcm_spatial_tile_h() { return kTileH; }
extern "C" int fcm_spatial3d_tile_w() { return kMarchW; }
extern "C" int fcm_spatial3d_tile_h() { return kMarchH; }
// shared memory of the march's staged tiles (two planes with their halo);
// block_partials adds 8 warps x 2 MAXC floats
extern "C" int fcm_spatial3d_tile_bytes() {
  return (int)(2 * (kMarchH + 2) * (kMarchW + 2) * sizeof(float));
}

// Partial rows a (depth, h, w) lane leaves with runs of z_run planes
// (0 for an empty or invalid shape).
extern "C" long long fcm_spatial3d_rows(int depth, int h, int w, int z_run) {
  if (depth < 1 || h < 1 || w < 1 || z_run < 1) return 0;
  long long tiles, runs;
  march_grid(depth, h, w, z_run, tiles, runs);
  return tiles * runs;
}

// x (B, H, W), v (B, c) float32 contiguous -> out (B, 2c): each lane's c
// numerators, then its c denominators. neighbors is 4 or 8; part is scratch
// of B * n_tiles * 2c floats with n_tiles = ceil(H / 8) * ceil(W / 32);
// 1 <= c <= 32; expo is the float32 exponent -1/(m-1).
extern "C" int fcm_spatial_partials_2d(const void* x, const void* v,
                                       int n_lanes, int h, int w, int c,
                                       int neighbors, float alpha, float m,
                                       float expo, void* part, void* out,
                                       void* stream) {
  const int tier = fcm::tier_of(c);
  if (neighbors != 4 && neighbors != 8) return (int)cudaErrorInvalidValue;
  if (n_lanes < 1 || n_lanes > 65535 || h < 1 || w < 1 || tier == 0)
    return (int)cudaErrorInvalidValue;
  const int err = launch_2d(tier, x, v, n_lanes, h, w, c, neighbors, alpha, m,
                            expo, part, out, stream);
  if (err != 0) return err;
  const long long n_tiles =
      (long long)((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  return fold(tier, part, n_lanes, n_tiles, c, out, stream);
}

// x (B, D, H, W), v (B, c) float32 contiguous -> out (B, 2c) over the
// 6-connected stencil, the volume cut into runs of z_run planes; part holds
// B * fcm_spatial3d_rows(D, H, W, z_run) * 2c floats.
extern "C" int fcm_spatial_partials_3d(const void* x, const void* v,
                                       int n_lanes, int depth, int h, int w,
                                       int c, float alpha, float m, float expo,
                                       int z_run, void* part, void* out,
                                       void* stream) {
  const int tier = fcm::tier_of(c);
  if (n_lanes < 1 || n_lanes > 65535 || depth < 1 || h < 1 || w < 1 ||
      z_run < 1 || tier == 0)
    return (int)cudaErrorInvalidValue;
  const int err = launch_3d(tier, x, v, n_lanes, depth, h, w, c, alpha, m,
                            expo, z_run, part, stream);
  if (err != 0) return err;
  return fold(tier, part, n_lanes, fcm_spatial3d_rows(depth, h, w, z_run), c,
              out, stream);
}
