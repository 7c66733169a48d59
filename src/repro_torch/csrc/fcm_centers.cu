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
//
// The TPU kernels walk (block_rows, 128) tiles in order on one core and add
// each tile into one (c, 128) accumulator that the grid carries from step to
// step; padding rows weigh 0. Hopper's blocks run in parallel and in no order,
// so nothing carries between them: each block reduces its grid-stride share
// of the pixels to 2c per-block partial sums, and a second launch folds the
// per-block partials in a fixed order. The tail is masked, not padded.
//
// What bounds them on an H100: memory. fcm_center_partials reads 4 B of x and
// 4c B of u a pixel (20.5 MB at the paper's 1000 KB image, c = 4: about 6 us
// at 3.35 TB/s); fcm_fused_partials reads only x (4 MB, about 1.2 us) and
// spends about 10 float operations a pixel and cluster, still below the
// card's float32 rate. Weights w (histogram counts) add 4 B a pixel; a null w
// means unit weights and is not read.
//
// Determinism: no float atomics. Each thread adds its pixels in index order,
// each warp folds its threads with a fixed shuffle tree, warp 0's threads add
// the eight warps in warp order, and the fold kernel adds the blocks with a
// fixed lane stride and shuffle tree. The block count depends only on N (the
// wrapper picks it), so a run repeats bit for bit. The order differs from the
// plain version's, so sums agree to rounding, not bitwise.
//
// Arithmetic per pixel and cluster, as the plain version: um = u * u when
// m == 2, else powf(u, m); um = um * w; num += um * x; den += um.
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
center_partials_kernel(const float* __restrict__ x,
                       const float* __restrict__ u,
                       const float* __restrict__ w, long long n, int c,
                       float m, float* __restrict__ part) {
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
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < c) {
        const float uj = u[(long long)j * n + i];
        const float um = (m_is_2 ? uj * uj : powf(uj, m)) * wi;
        num[j] = num[j] + um * xi;
        den[j] = den[j] + um;
      }
    }
  }
  fcm::block_partials<MAXC, kThreads>(num, den, c,
                                      part + (long long)blockIdx.x * 2 * c);
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

template <int MAXC>
int launch_center(const void* x, const void* u, const void* w, long long n,
                  int c, float m, void* part, int n_blocks, void* num,
                  void* den, void* stream) {
  center_partials_kernel<MAXC><<<n_blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (const float*)w, n, c, m,
      (float*)part);
  return fold(part, n_blocks, c, num, den, stream);
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

bool bad_args(long long n, int n_blocks) {
  return n < 1 || n_blocks < 1 || n_blocks > 65535;
}

}  // namespace

// x (N,), u (c, N), w (N,) or null, float32 contiguous -> num (c,), den (c,).
// part is scratch of n_blocks * 2c floats; 1 <= c <= 32.
extern "C" int fcm_center_partials(const void* x, const void* u, const void* w,
                                   long long n, int c, float m, void* part,
                                   int n_blocks, void* num, void* den,
                                   void* stream) {
  if (bad_args(n, n_blocks)) return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch_center<4>(x, u, w, n, c, m, part, n_blocks, num, den,
                              stream);
    case 8:
      return launch_center<8>(x, u, w, n, c, m, part, n_blocks, num, den,
                              stream);
    case 16:
      return launch_center<16>(x, u, w, n, c, m, part, n_blocks, num, den,
                               stream);
    case 32:
      return launch_center<32>(x, u, w, n, c, m, part, n_blocks, num, den,
                               stream);
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
