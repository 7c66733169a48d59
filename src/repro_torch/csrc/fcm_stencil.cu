// Whole-solve FCM_S: every lane's complete Eq. 4' / Eq. 3' fixed point in one
// launch, for slices and small volumes.
//
// Replaces src/repro/kernels/fcm_resident.py::resident_stencil_solve_pallas
// (body _resident_stencil_kernel): the TPU kernel holds a lane's padded grid,
// its validity sheet, the hoisted neighborhood fields and the (c, *grid)
// membership temporaries in VMEM and runs the lax.while_loop over the
// stencil step inside the kernel, to max|v' - v| < tol or max_iters. Here a
// lane's grid is held in the shared memory of a thread-block cluster, and no
// (c, N) field exists at all.
//
// Design: one thread-block cluster a lane (cudaLaunchKernelEx with a cluster
// dimension), of at most 8 blocks, the portable cluster size. The plan, the
// cluster size and the form, comes from the lane's grid alone
// (kernels/fcm_stencil.py::stencil_plan), so a lane's reduction order, and
// every bit of its result, do not depend on the other lanes of its launch.
// Each block owns a band of the lane: whole rows of a slice (2-D) or whole
// planes of a volume (3-D) on chip, a contiguous range of pixels in raster
// order off chip. Two forms:
//   on chip (stencil_onchip_kernel): the lane's band of each block, plus one
//     halo row (plane) on each side, is held in that block's shared memory
//     (up to 227 KB) for the whole solve, in a block for each 4096 pixels (up
//     to 8) but never fewer blocks than fit. Blocks of 512 threads, two an SM
//     where x_eff is held at c <= 4; else one block an SM, of 1024 threads at
//     c <= 4 and 512 at c <= 8. The band and its
//     halo are staged once at kernel start; where they fit beside it, the
//     iteration-invariant x_eff = (x + alpha * (sx / cnt)) / (1 + alpha) of
//     every pixel of the band is computed once into shared memory too (else
//     recomputed each iteration from the staged neighbors). Each thread
//     walks its pixels (a stride of the block size through the band) with
//     coordinates it carries from pixel to pixel, no division in the loop;
//     the neighbor offsets are compile-time per stencil, and a pixel whose
//     neighbors all lie in the grid takes a path with no bounds tests, cnt
//     the arity and nb / cnt a multiply where the arity is a power of two.
//     A 217x181 slice takes 8 blocks of 42 KB. The fewest blocks that fit,
//     2 of 159 KB, took the route's 64-lane bucket no faster (0.975 against
//     0.955 ms) and a lane alone 3.1x as long (0.81 against 0.26 ms;
//     kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W), and a lane's plan may
//     not depend on its bucket;
//   off chip (stencil_offchip_kernel, 1024 or 512 threads), for lanes whose
//     bands fit no cluster: a block for each 4096 pixels, up to 8, every
//     iteration re-reading each pixel and its in-grid neighbors from device
//     memory (after the first pass from L1 and the 50 MB L2).
// One iteration, in both forms:
//   1. every thread sums, for each of its pixels, the squared neighbor
//      distances (v_j - x_s)^2 in the order of
//      repro_torch.core.spatial.neighbor_offsets (an out-of-grid neighbor is
//      skipped, where the plain version adds +0), the effective distance
//      (v_j - x)^2 + alpha * (nb_j / cnt), the Eq. 4 membership with the
//      1e-12 floor and the even split over zero distances, u^m, and adds
//      u^m * x_eff and u^m into its 2c sums: the term order of the plain
//      version (kernels/fcm_stencil.py::stencil_solve_plain, the reference
//      form of Eq. 3', with x_eff hoisted out of the loop there);
//   2. each warp folds the sums with a fixed shuffle tree, the block adds its
//      warps in warp order and publishes the result in its shared memory, in
//      one of two buffers chosen by iteration parity;
//   3. after one cluster barrier every block reads all blocks' partials
//      through distributed shared memory, adds them in rank order and forms
//      v' = num / max(den, 1e-12) and delta = max|v' - v| (NaN-propagating).
//      All blocks compute the same sums in the same order, so they hold
//      bit-identical centers, delta and iteration count, and the loop test
//      agrees across the cluster.
// No float atomics: a run repeats bit for bit. The pixel sums run in another
// order than the plain version's, so centers agree to rounding, not bitwise.
//
// What bounds it on an H100: operations, and the serial chain of iterations.
// A lane's pixels are read once (4 B each) but every iteration costs about
// c (3 k + 14) float operations a pixel for k neighbors (divisions counted
// as one; each is about eight instructions, and Eq. 4 takes 2c of them), and
// the launch lasts as long as its slowest lane's iterations. Measured on the
// route's bucket (64 lanes of 217x181, 15-23 iterations; chip_smoke, NVIDIA
// H100 80GB HBM3, 700 W): 0.93 ms of device time, 16x the bound, held by the
// chain of divisions of each pixel's membership, with 32 warps an SM to hide
// it. One lane uses at most 8 SMs, so a single large lane leaves the
// card mostly idle. That is why the dispatch bound (kernels/fcm_stencil.py::STENCIL_MAX_PIXELS) sends
// lanes past it to the per-iteration step kernels of fcm_spatial.cu, which
// spread one lane over every SM.
//
// Bounds: pixels <= 2^20 a lane, c <= 8, 2-D (4 or 8 neighbors) or 3-D (6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fcm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPixels = 1 << 20;
constexpr int kMaxC = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size
// the forms of kernels/fcm_stencil.py::stencil_plan
constexpr int kOffChip = 0;
constexpr int kOnChipX = 1;     // x and its halo on chip, x_eff recomputed
constexpr int kOnChipXEff = 2;  // x_eff on chip too

// threads a block: as many as the registers of the tier allow one block an
// SM, but at c <= 4 with x_eff held (small bands) two blocks of 512 an SM
__host__ __device__ constexpr int threads_for(int ct, int form = 0) {
  return ct <= 4 && form != kOnChipXEff ? 1024 : 512;
}
__host__ __device__ constexpr int blocks_an_sm(int ct, int form) {
  return ct <= 4 && form == kOnChipXEff ? 2 : 1;
}

// neighbor deltas (dz, dy, dx) in neighbor_offsets order (NB = 4 or 8 in
// 2-D, 6 in 3-D): the neighbor of offset o sits at i - o. Compile-time in the
// on-chip kernel's unrolled neighbor loop.
__device__ __forceinline__ constexpr int nb_dz(int nb, int o) {
  return nb == 6 ? (o == 0 ? 1 : o == 1 ? -1 : 0) : 0;
}
__device__ __forceinline__ constexpr int nb_dy(int nb, int o) {
  return nb == 6 ? (o == 2 ? 1 : o == 3 ? -1 : 0)
                 : ((o == 0 || o == 4 || o == 5) ? 1
                    : (o == 1 || o == 6 || o == 7) ? -1 : 0);
}
__device__ __forceinline__ constexpr int nb_dx(int nb, int o) {
  return nb == 6 ? (o == 4 ? 1 : o == 5 ? -1 : 0)
                 : ((o == 2 || o == 4 || o == 6) ? 1
                    : (o == 3 || o == 5 || o == 7) ? -1 : 0);
}

// Shared memory of the per-iteration fold, by tier and block size.
template <int CT, int THREADS>
struct FoldSmem {
  float v[CT];
  float part[THREADS / 32][2 * CT];
  float pub[2][2 * CT];  // this block's partials, by parity
  float tot[2 * CT];
  float delta;
};

// Steps 2 and 3 of an iteration: fold the threads' sums over the block and
// the cluster, update the centers in f.v and return delta (the same bits in
// every block of the cluster).
template <int CT, int THREADS>
__device__ __forceinline__ float cluster_update(const float (&num)[CT],
                                                const float (&den)[CT], int c,
                                                int par,
                                                FoldSmem<CT, THREADS>& f,
                                                cg::cluster_group& cluster) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kSums = 2 * CT;  // CT numerators, then CT denominators
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < c) {  // uniform across the block: every lane shuffles
      float a = num[j];
      float b = den[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a = a + __shfl_down_sync(0xffffffffu, a, off);
        b = b + __shfl_down_sync(0xffffffffu, b, off);
      }
      if (lid == 0) {
        f.part[wid][j] = a;
        f.part[wid][CT + j] = b;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kSums; i += THREADS) {
    float s = f.part[0][i];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s = s + f.part[q][i];
    f.pub[par][i] = s;
  }
  cluster.sync();  // every block's partials of this iteration are published

  const int n_ranks = (int)cluster.num_blocks();
  if (wid == 0) {
    for (int i = lid; i < kSums; i += 32) {
      float s = cluster.map_shared_rank(&f.pub[par][0], 0)[i];
      for (int r = 1; r < n_ranks; ++r)
        s = s + cluster.map_shared_rank(&f.pub[par][0], r)[i];
      f.tot[i] = s;
    }
    __syncwarp();
    float dmax = 0.f;
    for (int j = lid; j < c; j += 32) {
      const float vn = f.tot[j] / fcm::floor_at(f.tot[CT + j]);
      dmax = fcm::nan_max(dmax, fabsf(vn - f.v[j]));
      f.v[j] = vn;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dmax = fcm::nan_max(dmax, __shfl_down_sync(0xffffffffu, dmax, off));
    if (lid == 0) f.delta = dmax;
  }
  __syncthreads();
  return f.delta;
}

// Step 1's tail for one pixel: the effective distances from the own
// distance and the neighbor sums, the membership, u^m, and the 2c sums.
template <int CT>
__device__ __forceinline__ void add_pixel(float xi, float x_eff, float cnt,
                                          const float (&nb)[CT],
                                          const float (&vr)[CT], int c,
                                          float alpha, bool m_is_2, float m,
                                          float expo, float (&num)[CT],
                                          float (&den)[CT]) {
  float u[CT];
  // nb / cnt: a multiply where cnt is a power of two (the interior of a 2-D
  // lane), the same correctly rounded quotient as the divide
  const float rc = cnt == 8.0f ? 0.125f : cnt == 4.0f ? 0.25f
                   : cnt == 2.0f ? 0.5f : cnt == 1.0f ? 1.0f : 0.0f;
  if (rc != 0.0f) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      float s = 0.f;
      if (j < c) {
        const float e = vr[j] - xi;
        s = e * e + alpha * (nb[j] * rc);
      }
      u[j] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      float s = 0.f;
      if (j < c) {
        const float e = vr[j] - xi;
        s = e * e + alpha * (nb[j] / cnt);
      }
      u[j] = s;
    }
  }
  fcm::membership_from_d2<CT>(c, m_is_2, expo, u);
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < c) {
      const float um = m_is_2 ? u[j] * u[j] : powf(u[j], m);
      num[j] = num[j] + um * x_eff;
      den[j] = den[j] + um;
    }
  }
}

// Pixel coordinates carried through a band at a fixed stride, with no
// division past the first pixel: (z, y, x) of 3-D lanes, (y, x) of 2-D
// ones (z stays 0).
struct Walker {
  int z, y, x;     // the current pixel
  int sz, sy, sx;  // the stride, as a (z, y, x) step
  int h, w;
  __device__ Walker(int first, int stride, int u0, bool three_d, int h_,
                    int w_)
      : h(h_), w(w_) {
    const int plane = h_ * w_;
    if (three_d) {
      z = u0 + first / plane;
      const int r = first % plane;
      y = r / w_;
      x = r % w_;
      sz = stride / plane;
      const int rs = stride % plane;
      sy = rs / w_;
      sx = rs % w_;
    } else {
      z = 0;
      y = u0 + first / w_;
      x = first % w_;
      sz = 0;
      sy = stride / w_;
      sx = stride % w_;
    }
  }
  __device__ __forceinline__ void advance(bool three_d) {
    x += sx;
    y += sy;
    z += sz;
    if (x >= w) {
      x -= w;
      ++y;
    }
    if (three_d && y >= h) {
      y -= h;
      ++z;
    }
  }
};

// One pixel of an iteration in the on-chip form: its neighbor sums from the
// staged band, x_eff held (HOIST) or recomputed, then add_pixel. CHECK false
// is for pixels all of whose neighbors lie in the grid: no bounds tests, and
// cnt is the arity.
template <int CT, int NB, bool CHECK, bool HOIST>
__device__ __forceinline__ void onchip_pixel(
    const float* __restrict__ xs, const float* __restrict__ xe, int q, int i,
    const Walker& p, int depth, int h, int w, int c, const float (&vr)[CT],
    float alpha, float one_alpha, bool m_is_2, float m, float expo,
    float (&num)[CT], float (&den)[CT]) {
  const float xi = xs[i];
  float cnt = 0.f;
  float sx = 0.f;
  float nb[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) nb[j] = 0.f;
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    const int dz = nb_dz(NB, o), dy = nb_dy(NB, o), dx = nb_dx(NB, o);
    const bool ok = !CHECK ||
                    ((dz <= 0 || p.z + 1 < depth) && (dz >= 0 || p.z > 0) &&
                     (dy <= 0 || p.y + 1 < h) && (dy >= 0 || p.y > 0) &&
                     (dx <= 0 || p.x + 1 < w) && (dx >= 0 || p.x > 0));
    if (ok) {
      const float xn = xs[i + (dz * h + dy) * w + dx];
      cnt = cnt + 1.0f;
      if (!HOIST) sx = sx + xn;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j < c) {
          const float e = vr[j] - xn;
          nb[j] = nb[j] + e * e;
        }
      }
    }
  }
  cnt = cnt < 1.0f ? 1.0f : cnt;
  const float x_eff = HOIST ? xe[q] : (xi + alpha * (sx / cnt)) / one_alpha;
  add_pixel<CT>(xi, x_eff, cnt, nb, vr, c, alpha, m_is_2, m, expo, num, den);
}

// The on-chip form. Dynamic shared memory: x of units [u0 - 1, u1 + 1) (a
// unit is a row of a 2-D lane, a plane of a 3-D one; the halo slots outside
// the grid are never read), then, in form kOnChipXEff, x_eff of units
// [u0, u1).
template <int CT, int NB, int FORM, bool FULL>
__global__ void __launch_bounds__(threads_for(CT, FORM),
                                  blocks_an_sm(CT, FORM))
stencil_onchip_kernel(const float* __restrict__ x, const float* __restrict__ v0,
                      const float* __restrict__ tol, int depth, int h, int w,
                      int c, float alpha, float one_alpha, float m, float expo,
                      int max_iters, float* __restrict__ v_out,
                      float* __restrict__ delta_out,
                      int* __restrict__ iters_out) {
  constexpr bool k3 = NB == 6;
  constexpr bool hoist = FORM == kOnChipXEff;
  constexpr int kOnThreads = threads_for(CT, FORM);
  const int cc = FULL ? CT : c;  // a compile-time cluster count at c == CT
  extern __shared__ float4 dyn_smem[];
  float* xs = reinterpret_cast<float*>(dyn_smem);
  __shared__ FoldSmem<CT, kOnThreads> f;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const bool m_is_2 = (m == 2.0f);
  const int plane = h * w;
  const int unit = k3 ? plane : w;
  const int n_units = k3 ? depth : h;
  const int per = (n_units + n_ranks - 1) / n_ranks;
  const int u0 = min(n_units, rank * per);
  const int u1 = min(n_units, u0 + per);
  const int band = (u1 - u0) * unit;
  const float* xl = x + (long long)lane * depth * plane;
  float* xe = xs + (per + 2) * unit;
  // in-band pixel q sits at xs[unit + q]; the neighbor (dz, dy, dx) at a
  // fixed offset from it
  constexpr int kNb = NB;

  {  // stage units [u0 - 1, u1 + 1) that lie in the grid
    const int lo = max(0, u0 - 1);
    const int hi = min(n_units, u1 + 1);
    float* dst = xs + (lo - (u0 - 1)) * unit;
    const float* src = xl + (long long)lo * unit;
    const int count = (hi - lo) * unit;
    for (int i = tid; i < count; i += kOnThreads) dst[i] = src[i];
  }
  for (int j = tid; j < CT; j += kOnThreads)
    f.v[j] = j < c ? v0[(long long)lane * c + j] : 0.f;
  const float tl = tol[lane];
  __syncthreads();

  if (hoist) {  // x_eff once, in the order the plain version's sx takes
    Walker p(tid, kOnThreads, u0, k3, h, w);
    for (int q = tid; q < band; q += kOnThreads) {
      const int i = unit + q;
      float cnt = 0.f;
      float sx = 0.f;
#pragma unroll
      for (int o = 0; o < kNb; ++o) {
        const int dz = nb_dz(NB, o), dy = nb_dy(NB, o), dx = nb_dx(NB, o);
        const bool ok = (dz <= 0 || p.z + 1 < depth) && (dz >= 0 || p.z > 0) &&
                        (dy <= 0 || p.y + 1 < h) && (dy >= 0 || p.y > 0) &&
                        (dx <= 0 || p.x + 1 < w) && (dx >= 0 || p.x > 0);
        if (ok) {
          cnt = cnt + 1.0f;
          sx = sx + xs[i + (dz * h + dy) * w + dx];
        }
      }
      cnt = cnt < 1.0f ? 1.0f : cnt;
      xe[q] = (xs[i] + alpha * (sx / cnt)) / one_alpha;
      p.advance(k3);
    }
    __syncthreads();
  }

  float delta = INFINITY;
  int it = 0;
  int par = 0;
  while (delta >= tl && it < max_iters) {
    float vr[CT];
    float num[CT];
    float den[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      vr[j] = f.v[j];
      num[j] = den[j] = 0.f;
    }
    Walker p(tid, kOnThreads, u0, k3, h, w);
    for (int q = tid; q < band; q += kOnThreads) {
      const int i = unit + q;
      const bool inner = p.x > 0 && p.x + 1 < w && p.y > 0 && p.y + 1 < h &&
                         (!k3 || (p.z > 0 && p.z + 1 < depth));
      if (inner)
        onchip_pixel<CT, NB, false, hoist>(xs, xe, q, i, p, depth, h, w, cc,
                                           vr, alpha, one_alpha, m_is_2, m,
                                           expo, num, den);
      else
        onchip_pixel<CT, NB, true, hoist>(xs, xe, q, i, p, depth, h, w, cc,
                                          vr, alpha, one_alpha, m_is_2, m,
                                          expo, num, den);
      p.advance(k3);
    }
    delta = cluster_update<CT, kOnThreads>(num, den, c, par, f, cluster);
    ++it;
    par ^= 1;
  }
  // No block leaves while another may still read its published partials.
  cluster.sync();

  if (rank == 0) {
    for (int j = tid; j < c; j += kOnThreads)
      v_out[(long long)lane * c + j] = f.v[j];
    if (tid == 0) {
      delta_out[lane] = delta;
      iters_out[lane] = it;
    }
  }
}

// The off-chip form: each block's contiguous range of the lane's pixels,
// re-read from device memory every iteration.
template <int CT>
__global__ void __launch_bounds__(threads_for(CT))
stencil_offchip_kernel(const float* __restrict__ x,
                       const float* __restrict__ v0,
                       const float* __restrict__ tol, int depth, int h, int w,
                       int c, int neighbors, float alpha, float one_alpha,
                       float m, float expo, int max_iters,
                       float* __restrict__ v_out,
                       float* __restrict__ delta_out,
                       int* __restrict__ iters_out) {
  constexpr int kThreads = threads_for(CT);
  __shared__ FoldSmem<CT, kThreads> f;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const bool m_is_2 = (m == 2.0f);
  const int plane = h * w;
  const int n = depth * plane;

  // this block's contiguous band [p0, p1) of the lane's pixels
  const int per = (n + n_ranks - 1) / n_ranks;
  const int p0 = min(n, rank * per);
  const int p1 = min(n, p0 + per);
  const float* xl = x + (long long)lane * n;

  for (int j = tid; j < CT; j += kThreads)
    f.v[j] = j < c ? v0[(long long)lane * c + j] : 0.f;
  const float tl = tol[lane];
  __syncthreads();

  float delta = INFINITY;
  int it = 0;
  int par = 0;
  while (delta >= tl && it < max_iters) {
    float vr[CT];
    float num[CT];
    float den[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      vr[j] = f.v[j];
      num[j] = den[j] = 0.f;
    }

    for (int p = p0 + tid; p < p1; p += kThreads) {
      const int z = p / plane;
      const int rem = p - z * plane;
      const int y = rem / w;
      const int xc = rem - y * w;
      const float xi = xl[p];
      float cnt = 0.f;
      float sx = 0.f;
      float nb[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) nb[j] = 0.f;
      for (int o = 0; o < neighbors; ++o) {
        const int dz = nb_dz(neighbors, o);
        const int dy = nb_dy(neighbors, o);
        const int dx = nb_dx(neighbors, o);
        const int zz = z + dz;
        const int yy = y + dy;
        const int xx = xc + dx;
        if (zz < 0 || zz >= depth || yy < 0 || yy >= h || xx < 0 || xx >= w)
          continue;
        const float xs = xl[p + dz * plane + dy * w + dx];
        cnt = cnt + 1.0f;
        sx = sx + xs;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < c) {
            const float e = vr[j] - xs;
            nb[j] = nb[j] + e * e;
          }
        }
      }
      cnt = cnt < 1.0f ? 1.0f : cnt;
      const float x_eff = (xi + alpha * (sx / cnt)) / one_alpha;
      add_pixel<CT>(xi, x_eff, cnt, nb, vr, c, alpha, m_is_2, m, expo, num,
                    den);
    }
    delta = cluster_update<CT, kThreads>(num, den, c, par, f, cluster);
    ++it;
    par ^= 1;
  }
  // No block leaves while another may still read its published partials.
  cluster.sync();

  if (rank == 0) {
    for (int j = tid; j < c; j += kThreads)
      v_out[(long long)lane * c + j] = f.v[j];
    if (tid == 0) {
      delta_out[lane] = delta;
      iters_out[lane] = it;
    }
  }
}

// Dynamic shared memory of the on-chip form (0 for the off-chip one): the
// layout stencil_onchip_kernel uses, and kernels/fcm_stencil.py::
// stencil_plan's count.
long long onchip_bytes(int depth, int h, int w, int neighbors, int ranks,
                       int form) {
  if (form == kOffChip) return 0;
  const bool k3 = neighbors == 6;
  const long long unit = k3 ? (long long)h * w : w;
  const int n_units = k3 ? depth : h;
  const long long per = (n_units + ranks - 1) / ranks;
  return 4 * unit * (per + 2 + (form == kOnChipXEff ? per : 0));
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void cluster_config(Launch& l, int ranks, int n_lanes, int threads,
                    size_t smem, cudaStream_t stream) {
  l.cfg = {};
  l.cfg.gridDim = dim3((unsigned)ranks, (unsigned)n_lanes, 1);
  l.cfg.blockDim = dim3((unsigned)threads, 1, 1);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = (unsigned)ranks;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
}

template <int CT, int FORM, bool FULL>
void* onchip_kernel(int neighbors) {
  return neighbors == 4   ? (void*)stencil_onchip_kernel<CT, 4, FORM, FULL>
         : neighbors == 8 ? (void*)stencil_onchip_kernel<CT, 8, FORM, FULL>
                          : (void*)stencil_onchip_kernel<CT, 6, FORM, FULL>;
}

template <int CT>
void* onchip_tier(int c, int neighbors, int form) {
  if (c == CT)
    return form == kOnChipXEff ? onchip_kernel<CT, kOnChipXEff, true>(neighbors)
                               : onchip_kernel<CT, kOnChipX, true>(neighbors);
  return form == kOnChipXEff ? onchip_kernel<CT, kOnChipXEff, false>(neighbors)
                             : onchip_kernel<CT, kOnChipX, false>(neighbors);
}

void* onchip_for(int c, int neighbors, int form) {
  return c <= 4 ? onchip_tier<4>(c, neighbors, form)
                : onchip_tier<8>(c, neighbors, form);
}

// admits what the exported functions take; 0 or a cudaError_t
int validate(int n_lanes, int depth, int h, int w, int c, int neighbors,
             int ranks, int form) {
  const long long n = (long long)depth * h * w;
  if (n_lanes < 1 || n_lanes > 65535 || depth < 1 || h < 1 || w < 1 ||
      n > kMaxPixels || c < 1 || c > kMaxC || ranks < 1 ||
      ranks > kMaxCluster || form < kOffChip || form > kOnChipXEff)
    return (int)cudaErrorInvalidValue;
  if (!(neighbors == 6 || (depth == 1 && (neighbors == 4 || neighbors == 8))))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int fcm_stencil_max_pixels() { return kMaxPixels; }
extern "C" int fcm_stencil_max_c() { return kMaxC; }
extern "C" int fcm_stencil_max_cluster() { return kMaxCluster; }

// The on-chip form's dynamic shared memory a block for a lane's grid, its
// cluster size and form (0 for the off-chip form; -1 if not admitted).
extern "C" long long fcm_stencil_smem_bytes(int depth, int h, int w,
                                            int neighbors, int ranks,
                                            int form) {
  if (validate(1, depth, h, w, 1, neighbors, ranks, form) != 0) return -1;
  return onchip_bytes(depth, h, w, neighbors, ranks, form);
}

// cudaOccupancyMaxActiveClusters of the on-chip form at a lane's plan (the
// clusters the card holds at once), or a negative cudaError_t.
extern "C" int fcm_stencil_active_clusters(int depth, int h, int w, int c,
                                           int neighbors, int ranks,
                                           int form) {
  int err = validate(1, depth, h, w, c, neighbors, ranks, form);
  if (err != 0 || form == kOffChip) return -(err ? err : 1);
  const size_t smem = (size_t)onchip_bytes(depth, h, w, neighbors, ranks,
                                           form);
  void* kernel = onchip_for(c, neighbors, form);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  Launch l;
  cluster_config(l, ranks, 1, threads_for(c <= 4 ? 4 : 8, form), smem, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// x (B, D, H, W) float32 contiguous (D = 1 for 2-D lanes), v0 (B, c), tol (B,)
// -> v (B, c), delta (B,) float32, iters (B,) int32. neighbors is 4 or 8 for
// D = 1 lanes, 6 for volumes; alpha and one_alpha are the float32 alpha and
// 1 + alpha; expo is the float32 exponent -1/(m-1); ranks (the cluster size)
// and form come from kernels/fcm_stencil.py::stencil_plan.
extern "C" int fcm_stencil_solve(const void* x, const void* v0, const void* tol,
                                 int n_lanes, int depth, int h, int w, int c,
                                 int neighbors, float alpha, float one_alpha,
                                 float m, float expo, int max_iters, int ranks,
                                 int form, void* v_out, void* delta_out,
                                 void* iters_out, void* stream) {
  int bad = validate(n_lanes, depth, h, w, c, neighbors, ranks, form);
  if (bad != 0) return bad;
  Launch l;
  cudaError_t err;
  if (form == kOffChip) {
    const int threads = threads_for(c <= 4 ? 4 : 8);
    cluster_config(l, ranks, n_lanes, threads, 0, (cudaStream_t)stream);
    if (c <= 4)
      err = cudaLaunchKernelEx(
          &l.cfg, stencil_offchip_kernel<4>, (const float*)x,
          (const float*)v0, (const float*)tol, depth, h, w, c, neighbors,
          alpha, one_alpha, m, expo, max_iters, (float*)v_out,
          (float*)delta_out, (int*)iters_out);
    else
      err = cudaLaunchKernelEx(
          &l.cfg, stencil_offchip_kernel<8>, (const float*)x,
          (const float*)v0, (const float*)tol, depth, h, w, c, neighbors,
          alpha, one_alpha, m, expo, max_iters, (float*)v_out,
          (float*)delta_out, (int*)iters_out);
  } else {
    const size_t smem = (size_t)onchip_bytes(depth, h, w, neighbors, ranks,
                                             form);
    void* kernel = onchip_for(c, neighbors, form);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cluster_config(l, ranks, n_lanes, threads_for(c <= 4 ? 4 : 8, form), smem,
                   (cudaStream_t)stream);
    const float* xp = (const float*)x;
    const float* vp = (const float*)v0;
    const float* tp = (const float*)tol;
    float* vo = (float*)v_out;
    float* dl = (float*)delta_out;
    int* io = (int*)iters_out;
    void* args[] = {&xp, &vp, &tp, &depth, &h, &w, &c, &alpha, &one_alpha,
                    &m, &expo, &max_iters, &vo, &dl, &io};
    err = cudaLaunchKernelExC(&l.cfg, kernel, args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
