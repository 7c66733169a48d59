// Hard labels: (B, N) scalar pixels + (B, c) centers -> (B, N) int32
// argmin-distance labels, ties to the lowest cluster index.
//
// Replaces src/repro/kernels/defuzzify.py::labels_pallas, which computes the
// per-cluster squared distances of a (rows, 128) tile in VMEM and writes the
// argmin tile, so the (c, N) distance matrix never reaches HBM.
//
// What bounds it on an H100: memory. Each pixel is read once (1 B as uint8,
// 4 B as int32 or float32) and its label written once (4 B); the c
// subtractions and squares per pixel are far below the card's float32 rate.
//
// Design: one launch for a bucket of any number of lanes. A 1-D grid of
// (lane, segment) blocks, kernels/defuzzify.py::labels_plan: a block labels
// kBlockPixels = 4096 pixels of one lane, 16 a thread, so the main path's
// 64 x 39 277 bucket is 640 blocks, one wave on the card. A lane's pixels
// split into a head (before the first 16-byte aligned pixel word), whole
// aligned words, and a tail, at any lane length and pointer offset. Threads
// load their words first (16 uint8 pixels, or 4 int32 / float32 pixels, a
// 16-byte load; one word a thread at uint8, four at 4 bytes), then:
//   - uint8: the block computes its lane's 256-entry label table in shared
//     memory, entry p the argmin for the value p, and each pixel is a lookup.
//     A value's label does not depend on which pixel holds it, so these are
//     the bits of the per-pixel argmin, and the JAX engine's bin table
//     gathered over the pixels;
//   - int32 and float32: the lane's centers are staged in shared memory and
//     each pixel takes its argmin.
// Labels leave as 16-byte int4 stores, contiguous across a warp (uint8
// labels through a swizzled shared stage, since a thread's 16 pixels make
// 64 bytes of labels), where the output lines up with the words (always for
// an aligned input), else one int at a time; segment 0's threads label the
// head and the tail one pixel each.
// The distance is (v - x) * (v - x) exactly as the reference computes
// (v - x) ** 2, and the argmin keeps the first minimum (strict <), as
// jnp.argmin / torch.argmin do.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 16;
constexpr int kBlockPixels = kThreads * kPixelsPerThread;

// the nearest of c centers v to xi, ties to the lowest index
__device__ __forceinline__ int nearest(float xi, const float* __restrict__ v,
                                       int c) {
  float e = v[0] - xi;
  float best_d = e * e;
  int best = 0;
  for (int j = 1; j < c; ++j) {
    e = v[j] - xi;
    const float d = e * e;
    if (d < best_d) {
      best_d = d;
      best = j;
    }
  }
  return best;
}

// pixel i (0 <= i < 16 / sizeof(T)) of a 16-byte word
template <typename T>
__device__ __forceinline__ T pixel_of(const uint4& q, int i) {
  const unsigned int u = i < 4 / (int)sizeof(T)    ? q.x
                         : i < 8 / (int)sizeof(T)  ? q.y
                         : i < 12 / (int)sizeof(T) ? q.z
                                                   : q.w;
  if constexpr (sizeof(T) == 1) {
    return (T)((u >> (8 * (i & 3))) & 0xffu);
  } else if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(u);
  } else {
    return (T)u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
labels_kernel(const T* __restrict__ x, long long n,
              const float* __restrict__ v, int c, int segs,
              int* __restrict__ out) {
  constexpr int W = 16 / sizeof(T);             // pixels a word
  constexpr int kWords = kPixelsPerThread / W;  // words a thread
  constexpr bool kTable = sizeof(T) == 1;  // one table entry a thread
  static_assert(!kTable || kThreads == 256, "the table takes 256 threads");
  __shared__ unsigned short table[kTable ? 256 : 1];
  extern __shared__ float vs[];

  const long long lane = blockIdx.x / segs;
  const int seg = (int)(blockIdx.x - lane * segs);
  const int tid = threadIdx.x;
  const long long g0 = lane * n;  // the lane's pixels [g0, g0 + n)
  // pixels before the lane's first 16-byte aligned word, at most n
  const long long lead =
      (long long)((16 - (reinterpret_cast<uintptr_t>(x + g0) & 15)) & 15) /
      sizeof(T);
  const long long a0 = g0 + (lead < n ? lead : n);
  const long long n_words = (g0 + n - a0) / W;
  const long long t0 = a0 + n_words * W;  // the tail's first pixel

  const long long first_word = (long long)seg * kThreads * kWords;
  uint4 word[kWords] = {};
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const long long wi = first_word + q * kThreads + tid;
    if (wi < n_words)
      word[q] = __ldg(reinterpret_cast<const uint4*>(x + a0 + wi * W));
  }
  // segment 0: thread t < 16 the head's pixel t, thread 16 + t the tail's
  const long long edge =
      tid < 16 ? g0 + tid : tid < 32 ? t0 + (tid - 16) : -1;
  const bool has_edge = seg == 0 && edge >= 0 &&
                        (tid < 16 ? edge < a0 : edge < g0 + n);
  const T edge_px = has_edge ? x[edge] : (T)0;

  const float* vl = v + lane * c;
  if constexpr (kTable) {
    table[tid] = (unsigned short)nearest((float)tid, vl, c);
  } else {
    for (int j = tid; j < c; j += kThreads) vs[j] = vl[j];
  }
  __syncthreads();
  auto label = [&](T p) -> int {
    if constexpr (kTable) {
      return table[p];
    } else {
      return nearest((float)p, vs, c);
    }
  };

  const bool vec_out = (reinterpret_cast<uintptr_t>(out + a0) & 15) == 0;
  // four labels to out[p .. p + 3]: one int4 store where the output lines
  // up with the words, else one int at a time
  auto store4 = [&](long long p, const int4& l) {
    if (vec_out) {
      *reinterpret_cast<int4*>(out + p) = l;
    } else {
      out[p] = l.x;
      out[p + 1] = l.y;
      out[p + 2] = l.z;
      out[p + 3] = l.w;
    }
  };
  if constexpr (kTable) {
    // A warp's 32 words are 512 consecutive pixels. Stored straight from
    // each thread, a warp's int4 stores would lie 64 bytes apart, and the
    // bucket took 12.5-13.1 us against 4.5 us this way (kernel_ab.py): the
    // labels go through a shared stage, chunk r of lane l's four at slot
    // 4 l + (r ^ ((l >> 1) & 3)) (no bank conflict on either side), and
    // store q of lane l takes the warp's pixels 4 (32 q + l) .. + 3, so
    // each store instruction writes 512 consecutive bytes.
    __shared__ int4 stage[kThreads / 32][128];
    const int wid = tid >> 5;
    const int lid = tid & 31;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      stage[wid][4 * lid + (r ^ ((lid >> 1) & 3))] =
          make_int4(label(pixel_of<T>(word[0], 4 * r)),
                    label(pixel_of<T>(word[0], 4 * r + 1)),
                    label(pixel_of<T>(word[0], 4 * r + 2)),
                    label(pixel_of<T>(word[0], 4 * r + 3)));
    __syncwarp();
    const long long warp_word = first_word + 32 * wid;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = 32 * q + lid;  // pixels 4 g .. 4 g + 3 of the warp's
      const int src = g >> 2;      // the lane whose word holds them
      if (warp_word + src < n_words)
        store4(a0 + warp_word * W + 4 * g,
               stage[wid][4 * src + ((g & 3) ^ ((src >> 1) & 3))]);
    }
  } else {
    // neighbouring threads hold neighbouring words: the stores are
    // contiguous across the warp as they are
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const long long wi = first_word + q * kThreads + tid;
      if (wi < n_words)
        store4(a0 + wi * W, make_int4(label(pixel_of<T>(word[q], 0)),
                                      label(pixel_of<T>(word[q], 1)),
                                      label(pixel_of<T>(word[q], 2)),
                                      label(pixel_of<T>(word[q], 3))));
    }
  }
  if (has_edge) out[edge] = label(edge_px);
}

template <typename T>
int launch(const void* x, long long n_lanes, long long n, const void* v,
           int c, int segs, void* out, void* stream) {
  if (n_lanes < 1 || n < 1 || c < 1 || segs < 1 ||
      segs < (n + kBlockPixels - 1) / kBlockPixels ||
      n_lanes > INT_MAX / segs)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) == 1 ? 0 : c * sizeof(float);
  labels_kernel<T><<<(unsigned)(n_lanes * segs), kThreads, smem,
                     (cudaStream_t)stream>>>((const T*)x, n, (const float*)v,
                                             c, segs, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int labels_block_pixels() { return kBlockPixels; }

// x (B, N) pixels, v (B, c) float32 centers, out (B, N) int32, all
// contiguous; segs = blocks a lane, from kernels/defuzzify.py::labels_plan.
extern "C" int labels_f32(const void* x, long long n_lanes, long long n,
                          const void* v, int c, int segs, void* out,
                          void* stream) {
  return launch<float>(x, n_lanes, n, v, c, segs, out, stream);
}

extern "C" int labels_u8(const void* x, long long n_lanes, long long n,
                         const void* v, int c, int segs, void* out,
                         void* stream) {
  return launch<uint8_t>(x, n_lanes, n, v, c, segs, out, stream);
}

extern "C" int labels_i32(const void* x, long long n_lanes, long long n,
                          const void* v, int c, int segs, void* out,
                          void* stream) {
  return launch<int32_t>(x, n_lanes, n, v, c, segs, out, stream);
}
