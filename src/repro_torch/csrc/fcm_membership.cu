// Eq. 4 membership: (N,) scalar pixels + (c,) centers -> (c, N) float32
// memberships, cluster-major.
//
// Replaces src/repro/kernels/fcm_membership.py::membership_pallas, which lays
// the pixels out as (M, 128) tiles so each VPU lane holds one pixel and writes
// the (c, block_rows, 128) membership tile of each grid step. That tiling and
// its zero padding are the TPU's; here the kernel reads the flat (N,) pixels
// and masks the tail itself.
//
// What bounds it on an H100: memory. Each pixel is read once (4 B) and its c
// memberships written once (4c B): at the paper's 1000 KB image and c = 4 that
// is 20.5 MB a call, about 6 us at 3.35 TB/s. The arithmetic (about 7 float
// operations per pixel and cluster) is far below the card's float32 rate.
//
// Design: one thread per pixel, grid-stride, the centers staged once per
// block in shared memory. A thread computes its pixel's c memberships in
// registers (fcm_common.cuh, the plain version's arithmetic) and writes
// u[j * N + i] for each cluster j, so the writes of a warp are coalesced
// within each cluster's row.
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
membership_kernel(const float* __restrict__ x, long long n,
                  const float* __restrict__ v, int c, float m, float expo,
                  float* __restrict__ u) {
  __shared__ float v_s[MAXC];
  for (int j = threadIdx.x; j < c; j += blockDim.x) v_s[j] = v[j];
  __syncthreads();
  const bool m_is_2 = (m == 2.0f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float ui[MAXC];
    fcm::membership_of<MAXC>(x[i], v_s, c, m_is_2, expo, ui);
#pragma unroll
    for (int j = 0; j < MAXC; ++j)
      if (j < c) u[(long long)j * n + i] = ui[j];
  }
}

template <int MAXC>
int launch(const void* x, long long n, const void* v, int c, float m,
           float expo, void* u, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  membership_kernel<MAXC><<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)v, c, m, expo, (float*)u);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N,), v (c,) float32, contiguous -> u (c, N) float32. N >= 1,
// 1 <= c <= 32; m is the fuzzifier, expo the float32 exponent -1/(m-1).
extern "C" int fcm_membership(const void* x, long long n, const void* v, int c,
                              float m, float expo, void* u, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (fcm::tier_of(c)) {
    case 4:
      return launch<4>(x, n, v, c, m, expo, u, stream);
    case 8:
      return launch<8>(x, n, v, c, m, expo, u, stream);
    case 16:
      return launch<16>(x, n, v, c, m, expo, u, stream);
    case 32:
      return launch<32>(x, n, v, c, m, expo, u, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fcm_max_c() { return fcm::kMaxC; }
