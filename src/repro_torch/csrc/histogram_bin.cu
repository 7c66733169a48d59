// Ingest binning: (B, N) uint8 or int32 pixels -> (B, n_bins) float32
// counts, in one launch.
//
// Replaces src/repro/kernels/histogram_bin.py::histogram_bin_pallas, the
// TPU's one-pass comparison binning (a (rows, 128) tile tested against the
// bin iota, the one-hot mass summed into a per-lane VMEM accumulator; a TPU
// has no fast scatter, so it compares instead).
//
// What bounds it on an H100: it reads B*N*size bytes once and writes
// B*n_bins counts. A full serving bucket (64 slices of 217x181 uint8) is
// 2.5 MB, under a microsecond at 3.35 TB/s, so at serving sizes the launch,
// the latency of the loads and the last block's fold are the limit, not the
// bytes.
//
// Design: a 1-D grid of (lane, chunk) tasks, blocks_of(N, size) blocks a
// lane, so a bucket of any number of lanes launches once. A block takes
// kBlockBytes of its lane's bytes as aligned 16-byte words (the lane's
// first word is the aligned word holding its first byte, so a lane may
// start at any alignment): each thread issues its kWords loads before it
// bins any pixel, and the bytes of a word outside the lane are masked out.
// A phantom's background is three values on a third of its pixels, and
// only a third of its neighbouring pixels are equal, so shared atomics on a
// block histogram serialise on a few addresses, and grouping a warp's equal
// bins with __match_any_sync costs more than it saves (PERF.md). Up
// to 256 bins a block therefore counts in private byte counters, one for
// each (bin, thread) in 64 KB of shared memory, with plain loads and
// stores, and folds them into its histogram with __dp4a; past 256 bins a
// thread merges runs of one bin and adds each with a shared atomic. A lane
// of one block writes its float32 counts at once. A lane of 2 to kMaxCluster
// blocks (a 217x181 slice is 2) runs as one thread block cluster: after a
// cluster barrier its first block adds the blocks' histograms from their
// shared memory and writes float32, with no fence, ticket or round trip
// through L2 (the ticket and fold of the first design took 2.8 us after the
// last block on the route's bucket). A longer lane has each block store its
// histogram as an int row of part, and the lane's last block to take its
// ticket (fcm::last_to_arrive) adds the rows with 16-byte loads, kFoldBatch
// in flight a thread, writes float32 counts and sets the ticket
// back to zero. No zero-fill and no cast: one device operation a call.
// Counts are integers, exact in any order, so the result is np.bincount's
// bits up to 2^24 pixels a lane (the int counters hold 2^31 - 1).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// 16-byte words a thread loads, all before it bins (5: a 217x181 slice is 2
// blocks and the route's bucket of 64 one block an SM; PERF.md)
constexpr int kWords = 5;
// bytes of a lane one block takes: 20 KB (20 480 uint8 or 5120 int32 pixels)
constexpr long long kBlockBytes = 16LL * kWords * kThreads;
// partial rows the fold keeps in flight a thread
constexpr int kFoldBatch = 16;
// the private form's bins: a byte counter for each (bin, thread), 64 KB of
// shared memory; a thread bins at most 16 * kWords pixels, so no byte wraps
constexpr int kPrivateBins = 256;
constexpr int kPrivateBytes = kPrivateBins * kThreads;
static_assert(16 * kWords < 256, "a thread's pixels must fit a byte");
// the most blocks a lane takes as one cluster (the portable cluster size)
constexpr int kMaxCluster = 8;

// Blocks a lane of n pixels of size bytes takes: enough kBlockBytes spans of
// aligned words to cover the lane at any alignment of its start.
__host__ __device__ long long blocks_of(long long n, int size) {
  return (n * size + 15 + kBlockBytes - 1) / kBlockBytes;
}

__device__ __forceinline__ int bin_of(uint32_t byte, int n_bins) {
  const int b = (int)byte;
  return b < n_bins ? b : n_bins - 1;
}

__device__ __forceinline__ int bin_of(int32_t x, int n_bins) {
  return x < 0 ? 0 : (x >= n_bins ? n_bins - 1 : x);
}

// The pixels of one 16-byte word whose bytes lie in [first, last), in
// order: f(bin) for each.
template <typename T, typename F>
__device__ __forceinline__ void each_pixel(uint4 word, int first, int last,
                                           int n_bins, F f) {
  const uint32_t q[4] = {word.x, word.y, word.z, word.w};
  constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int at = e * (int)sizeof(T);
    if (at >= first && at < last) {
      if constexpr (sizeof(T) == 1)
        f(bin_of((q[e >> 2] >> (8 * (e & 3))) & 0xffu, n_bins));
      else
        f(bin_of((int32_t)q[e], n_bins));
    }
  }
}

// px (B, N) -> out (B, n_bins) float32. Block (lane, blk), blk < blocks;
// part holds B * blocks rows of nbp ints (n_bins rounded up to 4; unused
// when blocks == 1 or CLUSTER); ticket B ints, zero on entry and left zero.
// CLUSTER: the lane's blocks are one cluster (2 <= blocks <= kMaxCluster);
// after a cluster barrier the leader adds every block's histogram from its
// shared memory, and a second barrier keeps them there until it has.
//
// PRIVATE (n_bins <= kPrivateBins): thread t counts bin b in byte b * 256 +
// col(t) of shared memory, adding 1 << 8 (col % 4) to the 32-bit word that
// holds it with a shared atomic whose result it never waits for (a byte
// never carries: it counts at most 16 * kWords pixels);
// col gives lane l of warp w byte w / 2 of word l + 32 (w % 2) of a row, so
// a warp's 32 lanes touch 32 distinct banks whatever their bins. Then thread
// t sums row t, sixteen 16-byte loads in a rotated order (conflict-free),
// four bytes a __dp4a, into the block's histogram. Else each thread merges runs of one
// bin in a register and adds a run with one shared atomic.
template <typename T, bool PRIVATE, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
histogram_bin_kernel(const T* __restrict__ px, long long n, int n_bins,
                     int blocks, int nbp, int* __restrict__ part,
                     int* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ int4 smem[];
  unsigned char* cnt8 = reinterpret_cast<unsigned char*>(smem);
  int* hist = reinterpret_cast<int*>(cnt8 + (PRIVATE ? kPrivateBytes : 0));
  const int lane = blockIdx.x / blocks;
  const int blk = blockIdx.x - lane * blocks;
  const int tid = threadIdx.x;
  // this thread's byte in a row of the private form's counters
  const int col = 4 * ((tid & 31) + 32 * ((tid >> 5) & 1)) + (tid >> 6);
  const uintptr_t lo = (uintptr_t)(px + (long long)lane * n);
  const uintptr_t hi = lo + (uintptr_t)n * sizeof(T);
  const uintptr_t w0 = (lo & ~(uintptr_t)15) + (uintptr_t)blk * kBlockBytes;
  uint4 words[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uintptr_t a = w0 + 16u * (uintptr_t)(k * kThreads + tid);
    words[k] = a < hi ? __ldg(reinterpret_cast<const uint4*>(a))
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (PRIVATE) {
#pragma unroll
    for (int k = 0; k < kPrivateBytes / 16 / kThreads; ++k)
      smem[k * kThreads + tid] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = tid; i < n_bins; i += kThreads) hist[i] = 0;
  }
  __syncthreads();
  int cur = 0;  // the run form's current bin and its length
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uintptr_t a = w0 + 16u * (uintptr_t)(k * kThreads + tid);
    if (a < hi) {
      const int first = lo > a ? (int)(lo - a) : 0;
      const int last = hi - a < 16u ? (int)(hi - a) : 16;
      each_pixel<T>(words[k], first, last, n_bins, [&](int b) {
        if constexpr (PRIVATE) {
          atomicAdd(reinterpret_cast<unsigned*>(cnt8) +
                        ((b * kThreads + col) >> 2),
                    1u << (8 * (col & 3)));
        } else if (b == cur) {
          ++cnt;
        } else {
          if (cnt) atomicAdd(&hist[cur], cnt);
          cur = b;
          cnt = 1;
        }
      });
    }
  }
  if constexpr (PRIVATE) {
    __syncthreads();
    if (tid < n_bins) {
      const uint4* row = reinterpret_cast<const uint4*>(cnt8) +
                         tid * (kThreads / 16);
      unsigned s = 0u;
#pragma unroll
      for (int k = 0; k < kThreads / 16; ++k) {
        const uint4 q = row[(k + tid) & (kThreads / 16 - 1)];
        s = __dp4a(q.x, 0x01010101u, s) + __dp4a(q.y, 0x01010101u, 0u) +
            __dp4a(q.z, 0x01010101u, 0u) + __dp4a(q.w, 0x01010101u, 0u);
      }
      hist[tid] = (int)s;
    }
  } else if (cnt) {
    atomicAdd(&hist[cur], cnt);
  }
  __syncthreads();
  float* dst = out + (long long)lane * n_bins;
  if (blocks == 1) {  // uniform: the lane is this block's alone
    for (int i = tid; i < n_bins; i += kThreads) dst[i] = (float)hist[i];
    return;
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's histogram is complete
    if (cluster.block_rank() == 0) {
      for (int i = tid; i < n_bins; i += kThreads) {
        int s = hist[i];
        for (int r = 1; r < blocks; ++r)
          s += cluster.map_shared_rank(hist, r)[i];
        dst[i] = (float)s;
      }
    }
    cluster.sync();  // the leader has read every block's histogram
  } else {
    int* lp = part + (long long)lane * blocks * nbp;
    int* row = lp + (long long)blk * nbp;
    for (int i = tid; i < nbp; i += kThreads)
      row[i] = i < n_bins ? hist[i] : 0;
    if (!fcm::last_to_arrive(ticket + lane, blocks)) return;
    // the lane's rows -> hist: thread (group g, quad q) adds bins 4q ..
    // 4q + 3 of rows g, g + groups, ..., 16 bytes a load, kFoldBatch loads
    // in flight
    for (int i = tid; i < n_bins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int quads = nbp / 4;
    const int per_pass = quads < kThreads ? quads : kThreads;
    const int groups = kThreads / per_pass;
    const int g = tid / per_pass;
    if (g < groups) {
      for (int q = tid - g * per_pass; q < quads; q += per_pass) {
        int s[4] = {0, 0, 0, 0};
        for (int r0 = g; r0 < blocks; r0 += kFoldBatch * groups) {
          int4 vals[kFoldBatch];
#pragma unroll
          for (int t = 0; t < kFoldBatch; ++t) {
            const int r = min(r0 + t * groups, blocks - 1);
            vals[t] = __ldcg(reinterpret_cast<const int4*>(
                                 lp + (long long)r * nbp) + q);
          }
#pragma unroll
          for (int t = 0; t < kFoldBatch; ++t) {
            if (r0 + t * groups < blocks) {
              s[0] += vals[t].x;
              s[1] += vals[t].y;
              s[2] += vals[t].z;
              s[3] += vals[t].w;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s[e] && 4 * q + e < n_bins) atomicAdd(&hist[4 * q + e], s[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < n_bins; i += kThreads) dst[i] = (float)hist[i];
    if (tid == 0) ticket[lane] = 0;
  }
}

// Lets the instance take bytes of dynamic shared memory on the current
// device. Past 48 KB, static shared memory included, a kernel must opt in,
// and the attribute belongs to the device: the private form always needs it
// (64 KB of counters), the run form near kernels/histogram_bin.py's MAX_BINS
// (48 KB of bins, and the ticket's flag is static). The most bytes set so far is kept a device, so a call past the
// first costs a cudaGetDevice.
template <typename T, bool PRIVATE, bool CLUSTER>
cudaError_t allow_smem(int bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kDevices;
  if (kept && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(histogram_bin_kernel<T, PRIVATE, CLUSTER>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) allowed[dev] = bytes;
  return e;
}

template <typename T, bool PRIVATE>
int launch_form(const void* px, long long n_lanes, long long n, int n_bins,
                int blocks, void* part, void* ticket, void* out,
                cudaStream_t st) {
  const size_t smem = (PRIVATE ? kPrivateBytes : 0) + n_bins * sizeof(int);
  const bool clustered = blocks > 1 && blocks <= kMaxCluster;
  auto kernel = clustered ? histogram_bin_kernel<T, PRIVATE, true>
                          : histogram_bin_kernel<T, PRIVATE, false>;
  const cudaError_t opt = clustered
                              ? allow_smem<T, PRIVATE, true>((int)smem)
                              : allow_smem<T, PRIVATE, false>((int)smem);
  if (opt != cudaSuccess) return (int)opt;
  const int nbp = (n_bins + 3) / 4 * 4;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(n_lanes * blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (clustered) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)px, n, n_bins, blocks, nbp, (int*)part,
      (int*)ticket, (float*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch(const void* px, long long n_lanes, long long n, int n_bins,
           int blocks, void* part, void* ticket, void* out, void* stream) {
  if (n_lanes < 1 || n < 1 || n_bins < 1 || blocks != blocks_of(n, sizeof(T))
      || n_lanes * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return n_bins <= kPrivateBins
             ? launch_form<T, true>(px, n_lanes, n, n_bins, blocks, part,
                                    ticket, out, st)
             : launch_form<T, false>(px, n_lanes, n, n_bins, blocks, part,
                                     ticket, out, st);
}

}  // namespace

// Bytes of a lane one block takes, and the blocks a lane of n pixels of size
// bytes takes (kernels/histogram_bin.py::bin_blocks).
extern "C" long long histogram_bin_block_bytes() { return kBlockBytes; }
extern "C" int histogram_bin_max_cluster() { return kMaxCluster; }
extern "C" long long histogram_bin_blocks(long long n, int size) {
  return blocks_of(n, size);
}

// px (n_lanes, n) contiguous -> out (n_lanes, n_bins) float32 counts, in one
// launch. blocks must be histogram_bin_blocks(n, size); part is scratch of
// n_lanes * blocks * (n_bins rounded up to 4) ints when blocks > 1 (else
// unused); ticket holds n_lanes ints that are zero on entry and left zero.
extern "C" int histogram_bin_u8(const void* px, long long n_lanes, long long n,
                                int n_bins, int blocks, void* part,
                                void* ticket, void* out, void* stream) {
  return launch<uint8_t>(px, n_lanes, n, n_bins, blocks, part, ticket, out,
                         stream);
}

extern "C" int histogram_bin_i32(const void* px, long long n_lanes,
                                 long long n, int n_bins, int blocks,
                                 void* part, void* ticket, void* out,
                                 void* stream) {
  return launch<int32_t>(px, n_lanes, n, n_bins, blocks, part, ticket, out,
                         stream);
}
