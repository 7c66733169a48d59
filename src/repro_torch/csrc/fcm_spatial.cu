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
// Design: one thread a pixel. A block of 256 threads covers a 32 x 8 tile of
// one slice (2-D: of the image) and stages the tile plus a halo of one pixel
// on each side in shared memory; a 3-D block also stages the same tile of the
// slices above and below. The grid is (tiles of a lane, lanes), so one launch
// serves a whole bucket: the host loop of the batched solve costs one step
// launch (and its fold) an iteration. A thread computes, for its pixel:
//   - over the in-grid neighbors, in the order of
//     repro_torch.core.spatial.neighbor_offsets (the neighbor of offset o sits
//     at i - o), the count cnt, the intensity sum sx and, per cluster, the sum
//     of squared neighbor distances nb_j = sum (v_j - x_r)^2; an out-of-grid
//     neighbor adds nothing, which is what the plain version's zero-filled
//     shifts add (exact zeros);
//   - cnt = max(cnt, 1), d2e_j = (v_j - x)^2 + alpha * (nb_j / cnt), the
//     Eq. 4 membership of d2e with the 1e-12 floor and the even split over
//     zero distances (fcm_common.cuh), u^m (u * u when m == 2, else powf),
//     and x + alpha * (sx / cnt).
// The order and rounding of each of these float32 operations are the plain
// version's (kernels/fcm_spatial.py::spatial_partials_plain); the library is
// compiled with --fmad=false. Only the sums over pixels run in another order.
//
// What bounds it on an H100: operations. A pixel is read once (4 B, its halo
// neighbors come from shared memory) but costs about c (3 k + 12) float
// operations for k neighbors, two of them divisions: at the 1000 KB image
// (1,024,000 pixels, c = 4, k = 8) about 150 MFLOP against 4 MB read.
//
// Determinism: no float atomics. Each block folds its threads with a fixed
// shuffle tree and warp order; the fold kernel, one block a lane, adds a
// fixed stride of the lane's tiles in each thread and folds its threads the
// same way. The tile count depends on the lane's shape alone, so a lane's
// bits do not depend on its bucket, and a run repeats bit for bit.
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

template <int MAXC, bool THREE_D>
int launch(const void* x, const void* v, int n_lanes, int depth, int h, int w,
           int c, int neighbors, float alpha, float m, float expo, void* part,
           void* out, void* stream) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const long long n_tiles = (long long)tiles_x * tiles_y * depth;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  spatial_partials_kernel<MAXC, THREE_D>
      <<<dim3((unsigned)n_tiles, (unsigned)n_lanes, 1), kThreads, 0,
         (cudaStream_t)stream>>>((const float*)x, (const float*)v, depth, h,
                                 w, c, neighbors, alpha, m, expo, tiles_x,
                                 tiles_y, (float*)part);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_lanes_kernel<MAXC><<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)part, (int)n_tiles, c, (float*)out);
  return (int)cudaGetLastError();
}

template <bool THREE_D>
int dispatch(const void* x, const void* v, int n_lanes, int depth, int h,
             int w, int c, int neighbors, float alpha, float m, float expo,
             void* part, void* out, void* stream) {
  if (n_lanes < 1 || n_lanes > 65535 || depth < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch<4, THREE_D>(x, v, n_lanes, depth, h, w, c, neighbors,
                                alpha, m, expo, part, out, stream);
    case 8:
      return launch<8, THREE_D>(x, v, n_lanes, depth, h, w, c, neighbors,
                                alpha, m, expo, part, out, stream);
    case 16:
      return launch<16, THREE_D>(x, v, n_lanes, depth, h, w, c, neighbors,
                                 alpha, m, expo, part, out, stream);
    case 32:
      return launch<32, THREE_D>(x, v, n_lanes, depth, h, w, c, neighbors,
                                 alpha, m, expo, part, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fcm_spatial_tile_w() { return kTileW; }
extern "C" int fcm_spatial_tile_h() { return kTileH; }

// x (B, H, W), v (B, c) float32 contiguous -> out (B, 2c): each lane's c
// numerators, then its c denominators. neighbors is 4 or 8; part is scratch
// of B * n_tiles * 2c floats with n_tiles = ceil(H / 8) * ceil(W / 32);
// 1 <= c <= 32; expo is the float32 exponent -1/(m-1).
extern "C" int fcm_spatial_partials_2d(const void* x, const void* v,
                                       int n_lanes, int h, int w, int c,
                                       int neighbors, float alpha, float m,
                                       float expo, void* part, void* out,
                                       void* stream) {
  if (neighbors != 4 && neighbors != 8) return (int)cudaErrorInvalidValue;
  return dispatch<false>(x, v, n_lanes, 1, h, w, c, neighbors, alpha, m, expo,
                         part, out, stream);
}

// x (B, D, H, W), v (B, c) float32 contiguous -> out (B, 2c) over the
// 6-connected stencil; part holds B * n_tiles * 2c floats with n_tiles =
// D * ceil(H / 8) * ceil(W / 32).
extern "C" int fcm_spatial_partials_3d(const void* x, const void* v,
                                       int n_lanes, int depth, int h, int w,
                                       int c, float alpha, float m, float expo,
                                       void* part, void* out, void* stream) {
  return dispatch<true>(x, v, n_lanes, depth, h, w, c, 6, alpha, m, expo, part,
                        out, stream);
}
