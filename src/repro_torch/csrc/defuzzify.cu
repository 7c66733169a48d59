// Hard labels: (B, N) scalar pixels + (B, c) centers -> (B, N) int32
// argmin-distance labels, ties to the lowest cluster index.
//
// Replaces src/repro/kernels/defuzzify.py::labels_pallas, which computes the
// per-cluster squared distances of a (rows, 128) tile in VMEM and writes the
// argmin tile, so the (c, N) distance matrix never reaches HBM.
//
// What bounds it on an H100: memory. Each pixel is read once (4 B as float32,
// 1 B as uint8) and its label written once (4 B); the c subtractions and
// squares per pixel are far below the card's float32 rate.
//
// Design: one thread per pixel, one grid row per lane, the lane's centers
// staged once per block in shared memory. The distance is (v - x) * (v - x)
// exactly as the reference computes (v - x) ** 2, and the argmin keeps the
// first minimum (strict <), as jnp.argmin / torch.argmin do. Reading the
// uint8 payload directly gives the same labels as the engine's 256-entry
// label table gathered over the pixels, since table entry p is this argmin
// for the value p.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void labels_kernel(const T* __restrict__ x, long long n,
                              const float* __restrict__ v, int c,
                              int* __restrict__ out) {
  extern __shared__ float vs[];
  const int lane = blockIdx.y;
  for (int j = threadIdx.x; j < c; j += blockDim.x) vs[j] = v[lane * c + j];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long at = (long long)lane * n + i;
  const float xi = (float)x[at];
  float e = vs[0] - xi;
  float best_d = e * e;
  int best = 0;
  for (int j = 1; j < c; ++j) {
    e = vs[j] - xi;
    const float d = e * e;
    if (d < best_d) {
      best_d = d;
      best = j;
    }
  }
  out[at] = best;
}

template <typename T>
int launch(const void* x, long long n_lanes, long long n, const void* v,
           int c, void* out, void* stream) {
  constexpr int kThreads = 256;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)n_lanes);
  labels_kernel<T><<<grid, kThreads, c * sizeof(float),
                     (cudaStream_t)stream>>>((const T*)x, n, (const float*)v,
                                             c, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int labels_f32(const void* x, long long n_lanes, long long n,
                          const void* v, int c, void* out, void* stream) {
  return launch<float>(x, n_lanes, n, v, c, out, stream);
}

extern "C" int labels_u8(const void* x, long long n_lanes, long long n,
                         const void* v, int c, void* out, void* stream) {
  return launch<uint8_t>(x, n_lanes, n, v, c, out, stream);
}

extern "C" int labels_i32(const void* x, long long n_lanes, long long n,
                          const void* v, int c, void* out, void* stream) {
  return launch<int32_t>(x, n_lanes, n, v, c, out, stream);
}
