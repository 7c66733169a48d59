// Ingest binning: (B, N) uint8 or int32 pixels -> (B, n_bins) integer counts.
//
// Replaces src/repro/kernels/histogram_bin.py::histogram_bin_pallas, the
// TPU's one-pass comparison binning (a (rows, 128) tile tested against the
// bin iota, the one-hot mass summed into a per-lane VMEM accumulator; a TPU
// has no fast scatter, so it compares instead).
//
// What bounds it on an H100: it reads B*N bytes once and writes B*n_bins
// counts. A full serving bucket (64 slices of 217x181 uint8) is 2.5 MB, under
// a microsecond at 3.35 TB/s, so at serving sizes the launch itself and the
// shared-memory atomics are the limit, not the bytes.
//
// Design: Hopper scatters into shared memory cheaply, so each block zeroes an
// n_bins-entry unsigned histogram in shared memory, bins its chunk of one
// lane's pixels with shared atomics, and adds its nonzero counts into the
// lane's global row with one global atomic per bin. Before a shared atomic the
// warp groups the lanes that hit the same bin (__match_any_sync) and only one
// of them adds the group's size: a phantom's background is one value on about
// half its pixels, which would otherwise serialise 32 atomics on one address.
// The ragged tail is masked (no zero padding, no bin-0 correction). Counts are
// integers, so the result is exact and independent of the order of the
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int bin_of(uint8_t x, int n_bins) {
  const int b = x;
  return b < n_bins ? b : n_bins - 1;
}

__device__ __forceinline__ int bin_of(int32_t x, int n_bins) {
  return x < 0 ? 0 : (x >= n_bins ? n_bins - 1 : x);
}

template <typename T>
__global__ void histogram_bin_kernel(const T* __restrict__ px, long long n,
                                     int n_bins, long long per_block,
                                     unsigned int* __restrict__ out) {
  extern __shared__ unsigned int hist[];
  const int lane = blockIdx.y;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();

  const long long start = (long long)blockIdx.x * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  const T* row = px + (long long)lane * n;
  const int lid = threadIdx.x & 31;
  // Every lane of a warp runs the same number of trips (the bound is rounded
  // up to a multiple of blockDim), so the full-mask match below is legal;
  // lanes past the tail carry bin -1 and add nothing.
  const long long span = stop - start;
  const long long trips = (span + blockDim.x - 1) / blockDim.x;
  for (long long t = 0; t < trips; ++t) {
    const long long i = start + t * blockDim.x + threadIdx.x;
    const int b = i < stop ? bin_of(row[i], n_bins) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lid == __ffs(peers) - 1) atomicAdd(&hist[b], __popc(peers));
  }
  __syncthreads();

  unsigned int* dst = out + (long long)lane * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const unsigned int h = hist[i];
    if (h) atomicAdd(&dst[i], h);
  }
}

template <typename T>
int launch(const void* px, long long n_lanes, long long n, int n_bins,
           long long per_block, void* out, void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + per_block - 1) / per_block;
  dim3 grid((unsigned)blocks, (unsigned)n_lanes);
  histogram_bin_kernel<T><<<grid, kThreads, n_bins * sizeof(unsigned int),
                            (cudaStream_t)stream>>>(
      (const T*)px, n, n_bins, per_block, (unsigned int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// out must hold n_lanes * n_bins zeroed 32-bit counters.
extern "C" int histogram_bin_u8(const void* px, long long n_lanes, long long n,
                                int n_bins, long long per_block, void* out,
                                void* stream) {
  return launch<uint8_t>(px, n_lanes, n, n_bins, per_block, out, stream);
}

extern "C" int histogram_bin_i32(const void* px, long long n_lanes,
                                 long long n, int n_bins, long long per_block,
                                 void* out, void* stream) {
  return launch<int32_t>(px, n_lanes, n, n_bins, per_block, out, stream);
}
