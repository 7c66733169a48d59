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
// masks its own edge by coordinates, and the sums leave as per-block partial
// rows that are folded in a fixed order (as in fcm_centers.cu).
//
// 2-D design (spatial2d_march_kernel): a warp takes a strip of 32 columns
// over a run of warp_rows rows (1 to 8, fewer for smaller lanes, so a lone
// 217x181 slice still spreads over 82 blocks), one thread a column, and
// marches it along y. A thread keeps its column's values at y - 1, y and
// y + 1 in registers and rotates them a row at a time (row y + 2 loaded while
// row y is computed); its left and right neighbors come from warp shuffles,
// and lanes 0 and 31 carry the strip's two halo columns the same way; the
// column's squared distances to the centers are kept too, and serve as the
// pixel's own and its upper and lower neighbors' terms. So each pixel leaves
// device memory once a step, plus the halo and two rows a warp.
// A block takes 16 consecutive tasks, strips fastest, so edge strips (which
// take the general path) spread evenly over the blocks and SMs. A warp row
// whose neighbors are all in the grid takes an interior path with no bounds
// tests and cnt = 4 or 8 known at compile time (nb / cnt and sx / cnt become
// products with 0.25 or 0.125, bit-equal to the divisions); the stencil
// arity is a template value, and so are m == 2 and c == tier at c = 4 (the
// main path's; other c and m take a body with both at run time). A thread
// adds its num/den over its rows in registers before the block's one fold;
// the last block of each lane to take its ticket then folds the lane's rows
// in block order, so a call is one launch on a 1-D grid, (lane, block), with
// no bound on the lanes. The plan comes from
// kernels/fcm_spatial.py::spatial2d_plan, from the lane's shape alone.
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
// a second launch, one block a lane, folds. A tile whose pixels all have
// their four in-plane neighbors in the grid skips the bounds tests on its
// inner planes, with cnt = 6 known at compile time. The run length comes from
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
//     division, also at cnt = 6; a product with 1 / cnt on the 2-D interior
//     path, where cnt is 4 or 8), the Eq. 4 membership of d2e with the 1e-12
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
// shuffle tree and warp order; the lane's fold (the 2-D march's last block,
// or the 3-D fold kernel, one block a lane) adds the lane's partial rows in a
// fixed order. The rows depend on the lane's shape alone, so a lane's bits do
// not depend on its bucket, and a run repeats bit for bit.
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

// threads of a block of the 3-D march's fold
constexpr int kThreads = 256;

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

// sq[j] = (v_j - x)^2 for j < c, 0 above: the squared distances of one
// value, which a 2-D column computes once and reuses as the pixel's own and
// as its lower and upper neighbors' terms (the same float32 operations, so
// the same bits, as computing them afresh).
template <int MAXC>
__device__ __forceinline__ void squares(float x, const float (&v)[MAXC],
                                        int c, float (&sq)[MAXC]) {
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const float e = v[j] - x;
    sq[j] = j < c ? e * e : 0.f;
  }
}

// add_neighbor with the neighbor's squared distances already at hand.
template <int MAXC>
__device__ __forceinline__ void add_neighbor_sq(float xs,
                                                const float (&sq)[MAXC], int c,
                                                float& cnt, float& sx,
                                                float (&nb)[MAXC]) {
  cnt = cnt + 1.0f;
  sx = sx + xs;
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    if (j < c) nb[j] = nb[j] + sq[j];
}

// nb / cnt: a multiplication by 1 / KNOWN when the count is known at compile
// time to be that power of two (bit-equal to the division: both round the same
// real number once, subnormals included), else an IEEE division.
template <int KNOWN>
__device__ __forceinline__ float over_count(float a, float cnt) {
  static_assert(KNOWN == 0 || KNOWN == 4 || KNOWN == 8, "a power of two");
  if constexpr (KNOWN > 0)
    return a * (1.0f / KNOWN);
  else
    return a / cnt;
}

// The Eq. 4' / 3' terms of one pixel x with its own squared distances d2 and
// its stencil sums: num[j] = u_j^m * (x + alpha * xbar), den[j] = u_j^m.
// KNOWN: the count when the caller knows it is 4 or 8 (an interior pixel of
// a 2-D grid), else 0.
template <int MAXC, int KNOWN = 0>
__device__ __forceinline__ void pixel_terms_d2(
    float x, const float (&d2)[MAXC], float cnt, float sx,
    const float (&nb)[MAXC], int c, float alpha, bool m_is_2, float m,
    float expo, float (&num)[MAXC], float (&den)[MAXC]) {
  cnt = cnt < 1.0f ? 1.0f : cnt;
  float u[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    u[j] = j < c ? d2[j] + alpha * over_count<KNOWN>(nb[j], cnt) : 0.f;
  fcm::membership_from_d2<MAXC>(c, m_is_2, expo, u);
  const float xe = x + alpha * over_count<KNOWN>(sx, cnt);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      const float um = m_is_2 ? u[j] * u[j] : powf(u[j], m);
      num[j] = um * xe;
      den[j] = um;
    }
  }
}

// pixel_terms_d2 with the pixel's squared distances to the centers v_s.
template <int MAXC>
__device__ __forceinline__ void pixel_terms(float x, float cnt, float sx,
                                            const float (&nb)[MAXC],
                                            const float* v_s, int c,
                                            float alpha, bool m_is_2, float m,
                                            float expo, float (&num)[MAXC],
                                            float (&den)[MAXC]) {
  float d2[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const float e = v_s[j] - x;
    d2[j] = j < c ? e * e : 0.f;
  }
  pixel_terms_d2<MAXC>(x, d2, cnt, sx, nb, c, alpha, m_is_2, m, expo, num,
                       den);
}

// --- 2-D: march along y ----------------------------------------------------

// A warp's task: a strip of kStripW columns (one thread a column) over a run
// of warp_rows rows (at most kMaxWarpRows, the plan's). A lane's tasks run
// strips fastest, and a block takes kStripWarps consecutive tasks, so every
// block mixes edge and interior strips alike and the SMs get even work. 16
// warps a block halve the partial rows against 8 (the last block's fold and
// the ticket are the launch's tail), and at c <= 4 __launch_bounds__ asks
// for 2 blocks an SM, 64 registers a thread, so the 1000 KB image's 250
// blocks are all resident at once (see PERF.md for the shapes timed).
constexpr int kStripW = 32;
constexpr int kStripWarps = 16;
constexpr int kStripThreads = kStripW * kStripWarps;
constexpr int kMaxWarpRows = 8;
// the tiers from which the march takes pixel2d_terms_lean
constexpr int kLeanTier = 16;

// The 2-D stencil sums of one pixel and its Eq. 4' / 3' terms, added to the
// thread's run sums. z, up, dn: the pixel's column at rows y, y - 1, y + 1,
// with their squared distances qz, qu, qd; lz, lu, ld and rz, ru, rd: the
// left and the right column at rows y, y - 1, y + 1. Neighbors in
// neighbor_offsets order (the neighbor of offset o sits at i - o): down, up,
// right, left, then with NB == 8 down-right, down-left, up-right, up-left.
// INTERIOR: all NB neighbors in the grid (cnt = NB at compile time, no tests,
// and nb starts at the first neighbor's term: 0 + e^2 is e^2); else the
// has_* flags say which are.
template <int MAXC, int NB, bool INTERIOR>
__device__ __forceinline__ void pixel2d_terms(
    float z, float up, float dn, const float (&qz)[MAXC],
    const float (&qu)[MAXC], const float (&qd)[MAXC], float lz, float lu,
    float ld, float rz, float ru, float rd, bool has_dn, bool has_up,
    bool has_rt, bool has_lf, const float (&vr)[MAXC], int c, float alpha,
    bool m2, float m, float expo, float (&acc_num)[MAXC],
    float (&acc_den)[MAXC]) {
  float cnt = 0.f;
  float sx = 0.f;
  float nb[MAXC];
  if (INTERIOR) {
    sx = sx + dn;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) nb[j] = qd[j];
  } else {
#pragma unroll
    for (int j = 0; j < MAXC; ++j) nb[j] = 0.f;
    if (has_dn) add_neighbor_sq<MAXC>(dn, qd, c, cnt, sx, nb);
  }
  if (INTERIOR || has_up) add_neighbor_sq<MAXC>(up, qu, c, cnt, sx, nb);
  if (INTERIOR || has_rt) add_neighbor<MAXC>(rz, vr, c, cnt, sx, nb);
  if (INTERIOR || has_lf) add_neighbor<MAXC>(lz, vr, c, cnt, sx, nb);
  if constexpr (NB == 8) {
    if (INTERIOR || (has_dn && has_rt))
      add_neighbor<MAXC>(rd, vr, c, cnt, sx, nb);
    if (INTERIOR || (has_dn && has_lf))
      add_neighbor<MAXC>(ld, vr, c, cnt, sx, nb);
    if (INTERIOR || (has_up && has_rt))
      add_neighbor<MAXC>(ru, vr, c, cnt, sx, nb);
    if (INTERIOR || (has_up && has_lf))
      add_neighbor<MAXC>(lu, vr, c, cnt, sx, nb);
  }
  float num[MAXC];
  float den[MAXC];
  pixel_terms_d2<MAXC, INTERIOR ? NB : 0>(z, qz, cnt, sx, nb, c, alpha, m2,
                                          m, expo, num, den);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      acc_num[j] = acc_num[j] + num[j];
      acc_den[j] = acc_den[j] + den[j];
    }
  }
}

// pixel2d_terms for the larger tiers (MAXC >= kLeanTier): clusters outer,
// each neighbor's squared distance formed afresh from the centers in shared
// memory v_s, so a thread carries no squared distances from row to row and no
// centers in registers (4c registers fewer, which at 128 registers a thread
// is the difference between spilling and not). Each nb_j adds the same terms
// in the same neighbor order, and 0 + e^2 is e^2, so the bits are
// pixel2d_terms'.
template <int MAXC, int NB, bool INTERIOR>
__device__ __forceinline__ void pixel2d_terms_lean(
    float z, float up, float dn, float lz, float lu, float ld, float rz,
    float ru, float rd, bool has_dn, bool has_up, bool has_rt, bool has_lf,
    const float* v_s, int c, float alpha, bool m2, float m, float expo,
    float (&acc_num)[MAXC], float (&acc_den)[MAXC]) {
  constexpr int KNOWN = INTERIOR ? NB : 0;
  const bool t_dn = INTERIOR || has_dn;
  const bool t_up = INTERIOR || has_up;
  const bool t_rt = INTERIOR || has_rt;
  const bool t_lf = INTERIOR || has_lf;
  const bool t_rd = NB == 8 && t_dn && t_rt;
  const bool t_ld = NB == 8 && t_dn && t_lf;
  const bool t_ru = NB == 8 && t_up && t_rt;
  const bool t_lu = NB == 8 && t_up && t_lf;
  float cnt = 0.f;
  float sx = 0.f;
  auto count = [&](bool t, float xs) {
    if (t) {
      cnt = cnt + 1.0f;
      sx = sx + xs;
    }
  };
  count(t_dn, dn);
  count(t_up, up);
  count(t_rt, rz);
  count(t_lf, lz);
  count(t_rd, rd);
  count(t_ld, ld);
  count(t_ru, ru);
  count(t_lu, lu);
  cnt = cnt < 1.0f ? 1.0f : cnt;
  float u[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    float uj = 0.f;
    if (j < c) {
      const float vj = v_s[j];
      float nb = 0.f;
      auto add = [&](bool t, float xs) {
        const float e = vj - xs;
        if (t) nb = nb + e * e;
      };
      add(t_dn, dn);
      add(t_up, up);
      add(t_rt, rz);
      add(t_lf, lz);
      add(t_rd, rd);
      add(t_ld, ld);
      add(t_ru, ru);
      add(t_lu, lu);
      uj = (vj - z) * (vj - z) + alpha * over_count<KNOWN>(nb, cnt);
    }
    u[j] = uj;
  }
  fcm::membership_from_d2<MAXC>(c, m2, expo, u);
  const float xe = z + alpha * over_count<KNOWN>(sx, cnt);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < c) {
      const float um = m2 ? u[j] * u[j] : powf(u[j], m);
      acc_num[j] = acc_num[j] + um * xe;
      acc_den[j] = acc_den[j] + um;
    }
  }
}

// x (B, H, W), v (B, c) -> part (B, 2c, blocks), then out (B, 2c). Block
// (lane, blk) on a 1-D grid; warp k of the block takes the lane's task
// blk * kStripWarps + k. A thread keeps its column's rows y - 1, y, y + 1 in
// registers and rotates them a row at a time, row y + 2 loaded while row y
// is computed; its left and right neighbors come from warp shuffles, and
// lanes 0 and 31 keep the same three rows of the strip's halo columns x0 - 1
// and x0 + 32 (loaded beside their own). A warp row whose NB neighbors are
// all in the grid (the columns x0 - 1 .. x0 + 32, rows y - 1 and y + 1)
// takes the interior path. The thread adds its num/den over its rows in
// registers; after the block's one fold the last block of the lane folds
// the lane's rows in block order. FAST: c == MAXC and m == 2 at compile
// time, else both are run-time values. Tier 4 asks for 2 blocks an SM (64
// registers a thread); the larger tiers for 1 (128 registers), which tier
// 8's 9c live floats need, and within which the tiers from kLeanTier on fit
// only in the lean form (pixel2d_terms_lean).
template <int MAXC, bool FAST, int NB>
__global__ void __launch_bounds__(kStripThreads, MAXC <= 4 ? 2 : 1)
spatial2d_march_kernel(const float* __restrict__ x,
                       const float* __restrict__ v, int h, int w, int c_rt,
                       float alpha, float m, float expo, int warp_rows,
                       int strips, int blocks, float* __restrict__ part,
                       int* __restrict__ ticket, float* __restrict__ out) {
  const int c = FAST ? MAXC : c_rt;
  const bool m2 = FAST || m == 2.0f;
  const int lane = blockIdx.x / blocks;
  const int blk = blockIdx.x - lane * blocks;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const int task = blk * kStripWarps + wid;  // uniform across the warp
  const int wrun = task / strips;
  const int x0 = (task - wrun * strips) * kStripW;
  const int ya = wrun * warp_rows;  // >= h past the lane's last task
  const int yb = min(h, ya + warp_rows);
  const float* xl = x + (long long)lane * h * w;
  const int col = x0 + lid;
  const bool in_col = col < w;
  // lanes 0 and 31 also carry the halo column on their side
  const int hcol = lid == 0 ? x0 - 1 : x0 + kStripW;
  const bool in_halo = (lid == 0 || lid == kStripW - 1) && hcol >= 0 &&
                       hcol < w;
  const float* cp = xl + (in_col ? col : 0);
  const float* hp = xl + (in_halo ? hcol : 0);
  const bool first = ya > 0 && ya < h;
  const bool second = ya + 1 < h;
  float xm = (in_col && first) ? cp[(long long)(ya - 1) * w] : 0.f;
  float xz = (in_col && ya < h) ? cp[(long long)ya * w] : 0.f;
  float xp = (in_col && second) ? cp[(long long)(ya + 1) * w] : 0.f;
  float hm = (in_halo && first) ? hp[(long long)(ya - 1) * w] : 0.f;
  float hz = (in_halo && ya < h) ? hp[(long long)ya * w] : 0.f;
  float hq = (in_halo && second) ? hp[(long long)(ya + 1) * w] : 0.f;
  constexpr bool kLean = MAXC >= kLeanTier;
  // the centers: in registers, or for the lean form in shared memory
  float vr[MAXC];
  const float* v_s = nullptr;
  if constexpr (kLean) {
    __shared__ float v_sh[MAXC];
    if (tid < MAXC) v_sh[tid] = tid < c ? v[(long long)lane * c + tid] : 0.f;
    __syncthreads();
    v_s = v_sh;
  } else {
#pragma unroll
    for (int j = 0; j < MAXC; ++j)
      vr[j] = j < c ? v[(long long)lane * c + j] : 0.f;
  }
  float acc_num[MAXC];
  float acc_den[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) acc_num[j] = acc_den[j] = 0.f;

  // the column's squared distances at rows y - 1, y, y + 1 (not kept by
  // the lean form)
  float qm[MAXC], qz[MAXC], qp[MAXC];
  if constexpr (!kLean) {
    squares<MAXC>(xm, vr, c, qm);
    squares<MAXC>(xz, vr, c, qz);
    squares<MAXC>(xp, vr, c, qp);
  }
  const bool strip_interior = x0 >= 1 && x0 + kStripW < w;
  const bool left = lid == 0;
  const bool right = lid == kStripW - 1;
#pragma unroll 2
  for (int y = ya; y < yb; ++y) {  // uniform across the warp
    const bool more = y + 2 < h && y + 1 < yb;
    const float xn = (in_col && more) ? cp[(long long)(y + 2) * w] : 0.f;
    const float hn = (in_halo && more) ? hp[(long long)(y + 2) * w] : 0.f;
    float lz = __shfl_up_sync(0xffffffffu, xz, 1);
    float rz = __shfl_down_sync(0xffffffffu, xz, 1);
    lz = left ? hz : lz;
    rz = right ? hz : rz;
    float lu = 0.f, ld = 0.f, ru = 0.f, rd = 0.f;
    if constexpr (NB == 8) {
      lu = __shfl_up_sync(0xffffffffu, xm, 1);
      ld = __shfl_up_sync(0xffffffffu, xp, 1);
      ru = __shfl_down_sync(0xffffffffu, xm, 1);
      rd = __shfl_down_sync(0xffffffffu, xp, 1);
      lu = left ? hm : lu;
      ld = left ? hq : ld;
      ru = right ? hm : ru;
      rd = right ? hq : rd;
    }
    if (strip_interior && y > 0 && y + 1 < h) {
      if constexpr (kLean)
        pixel2d_terms_lean<MAXC, NB, true>(
            xz, xm, xp, lz, lu, ld, rz, ru, rd, true, true, true, true, v_s,
            c, alpha, m2, m, expo, acc_num, acc_den);
      else
        pixel2d_terms<MAXC, NB, true>(
            xz, xm, xp, qz, qm, qp, lz, lu, ld, rz, ru, rd, true, true, true,
            true, vr, c, alpha, m2, m, expo, acc_num, acc_den);
    } else if (in_col) {
      if constexpr (kLean)
        pixel2d_terms_lean<MAXC, NB, false>(
            xz, xm, xp, lz, lu, ld, rz, ru, rd, y + 1 < h, y > 0,
            col + 1 < w, col > 0, v_s, c, alpha, m2, m, expo, acc_num,
            acc_den);
      else
        pixel2d_terms<MAXC, NB, false>(
            xz, xm, xp, qz, qm, qp, lz, lu, ld, rz, ru, rd, y + 1 < h, y > 0,
            col + 1 < w, col > 0, vr, c, alpha, m2, m, expo, acc_num,
            acc_den);
    }
    xm = xz;
    xz = xp;
    xp = xn;
    if constexpr (!kLean) {
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        qm[j] = qz[j];
        qz[j] = qp[j];
      }
      squares<MAXC>(xn, vr, c, qp);
    }
    hm = hz;
    hz = hq;
    hq = hn;
  }
  // the lane's partials are (output, block), block fastest
  float* lp = part + (long long)lane * 2 * c * blocks;
  fcm::block_partials<MAXC, kStripThreads>(acc_num, acc_den, c, lp + blk,
                                           blocks);
  if (!fcm::last_to_arrive(ticket + lane, blocks)) return;
  float* ol = out + (long long)lane * 2 * c;
  fcm::fold_rows<kStripThreads>(
      2 * c, blocks, [&](int o) { return lp + (long long)o * blocks; },
      [&](int o, float s) { ol[o] = s; });
  if (tid == 0) ticket[lane] = 0;
}

// The 2-D march's grid for an (h, w) lane at warp_rows rows a warp: strips
// of columns and blocks of kStripWarps tasks.
inline void march2d_grid(int h, int w, int warp_rows, long long& strips,
                         long long& blocks) {
  strips = (w + kStripW - 1) / kStripW;
  const long long tasks = strips * ((h + warp_rows - 1) / warp_rows);
  blocks = (tasks + kStripWarps - 1) / kStripWarps;
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

template <int MAXC>
int launch_march2d(const void* x, const void* v, int n_lanes, int h, int w,
                   int c, int neighbors, float alpha, float m, float expo,
                   int warp_rows, void* part, void* ticket, void* out,
                   cudaStream_t st) {
  long long strips, blocks;
  march2d_grid(h, w, warp_rows, strips, blocks);
  if (blocks * n_lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, int, int, int, float,
                          float, float, int, int, int, float*, int*, float*);
  Kernel k = neighbors == 4 ? spatial2d_march_kernel<MAXC, false, 4>
                             : spatial2d_march_kernel<MAXC, false, 8>;
  if constexpr (MAXC == 4)
    if (c == MAXC && m == 2.0f)
      k = neighbors == 4 ? spatial2d_march_kernel<MAXC, true, 4>
                         : spatial2d_march_kernel<MAXC, true, 8>;
  k<<<(unsigned)(blocks * n_lanes), kStripThreads, 0, st>>>(
      (const float*)x, (const float*)v, h, w, c, alpha, m, expo, warp_rows,
      (int)strips, (int)blocks, (float*)part, (int*)ticket, (float*)out);
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

extern "C" int fcm_spatial2d_strip_w() { return kStripW; }
extern "C" int fcm_spatial2d_warps() { return kStripWarps; }
extern "C" int fcm_spatial2d_max_warp_rows() { return kMaxWarpRows; }

// Blocks (and partial rows) an (h, w) lane of the 2-D march takes at
// warp_rows rows a warp (0 for an empty shape or a warp_rows out of range).
extern "C" long long fcm_spatial2d_blocks(int h, int w, int warp_rows) {
  if (h < 1 || w < 1 || warp_rows < 1 || warp_rows > kMaxWarpRows) return 0;
  long long strips, blocks;
  march2d_grid(h, w, warp_rows, strips, blocks);
  return blocks;
}

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
// numerators, then its c denominators, in one launch. neighbors is 4 or 8;
// warp_rows (rows a warp marches, 1 .. kMaxWarpRows) comes from
// kernels/fcm_spatial.py::spatial2d_plan; part is scratch of B *
// fcm_spatial2d_blocks(H, W, warp_rows) * 2c floats; ticket holds B ints that
// are zero on entry and left zero on exit; 1 <= c <= 32, B >= 1; expo is the
// float32 exponent -1/(m-1).
extern "C" int fcm_spatial_partials_2d(const void* x, const void* v,
                                       int n_lanes, int h, int w, int c,
                                       int neighbors, float alpha, float m,
                                       float expo, int warp_rows, void* part,
                                       void* ticket, void* out,
                                       void* stream) {
  const int tier = fcm::tier_of(c);
  if (neighbors != 4 && neighbors != 8) return (int)cudaErrorInvalidValue;
  if (n_lanes < 1 || h < 1 || w < 1 || tier == 0 || warp_rows < 1 ||
      warp_rows > kMaxWarpRows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tier) {
#define FCM_SPATIAL_2D(T)                                                    \
  case T:                                                                    \
    return launch_march2d<T>(x, v, n_lanes, h, w, c, neighbors, alpha, m,    \
                             expo, warp_rows, part, ticket, out, st);
    FCM_SPATIAL_2D(4)
    FCM_SPATIAL_2D(8)
    FCM_SPATIAL_2D(16)
    FCM_SPATIAL_2D(32)
#undef FCM_SPATIAL_2D
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (B, D, H, W), v (B, c) float32 contiguous -> out (B, 2c) over the
// 6-connected stencil, the volume cut into runs of z_run planes; part holds
// B * fcm_spatial3d_rows(D, H, W, z_run) * 2c floats. The lanes sit on
// gridDim.z, so B <= 65535 (the wrapper takes larger buckets in chunks).
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
