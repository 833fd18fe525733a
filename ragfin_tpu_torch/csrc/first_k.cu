// First k set positions of a byte hit vector, in row order, for sm_90a.
//
// Replaces ragfin_tpu/index/graph_index.py:_first_k_kernel (Pallas, via
// masked_first_k). Same function: hit [N] bytes (int8 or bool, nonzero =
// hit) -> ids [k] int32, the first k hit positions ascending, padded with
// INT32_MAX, and count = min(number of hits, k). The graph store's fact
// table is sorted quarter-major, so the first k hits of a predicate ARE its
// top-k under the reference's ORDER BY, with no sort of the table.
//
// Bound on an H100: N bytes read once (10 MB at N = 10M, 3 us at 3.35 TB/s);
// the operations are a compare per byte. At that size three launches cost
// more than the bytes, which is this version's known slack.
//
// Design. The TPU kernel walks tiles in grid order and carries the running
// count in scalar memory from one grid step to the next. CUDA blocks run in
// any order, so nothing is carried: position = prefix + rank.
//  - count_hits: block b counts the hits of its span (16-byte loads,
//    __vcmpne4 + __popc per word) into counts[b];
//  - scan_counts (one block): exclusive prefix sum of counts into prefix[],
//    count = min(total, k), and ids[0..k) = INT32_MAX;
//  - write_hits: every block whose prefix is under k and whose count is not
//    0 reads its span again and writes each hit at prefix + its rank in the
//    block (a block-wide exclusive scan of per-thread counts per 4 KB
//    chunk), dropping ranks at or past k. With a sparse hit vector almost
//    all blocks return at once; with a dense one only the first few write.
// Positions are int32 throughout (never a float key), so rows past 2^24
// stay exact; N < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ragfin {

constexpr int kFkThreads = 256;
constexpr int kFkIters = 8;                            // 16-byte loads per thread per block
constexpr int kFkChunk = kFkThreads * 16;              // bytes per block per iteration
constexpr int kFkSpan = kFkChunk * kFkIters;           // bytes per block
constexpr int kFkIdSentinel = 0x7FFFFFFF;
constexpr unsigned kFkFull = 0xffffffffu;

// 16 bytes starting at byte `pos` (a multiple of 16), zero past n. One
// vector load where the pointer is 16-byte aligned and the bytes all exist.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ hit, long long pos,
                                        long long n, bool aligned) {
  if (aligned && pos + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(hit + pos));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16; ++j)
    if (pos + j < n && hit[pos + j]) w[j >> 2] |= 1u << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int count16(const uint4& v) {
  // __vcmpne4 gives 0xff per nonzero byte: 8 set bits each.
  return (__popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
          __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u))) >> 3;
}

// Block-wide sums over kFkThreads threads: returns the exclusive prefix of
// `c` in thread order and sets `total`. `warp_sums` is shared, 8 ints.
__device__ __forceinline__ int block_exclusive(int c, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFkFull, inc, o);
    if (lane >= o) inc += up;
  }
  __syncthreads();  // warp_sums of the previous call are read by now
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kFkThreads / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  return before + inc - c;
}

__global__ void __launch_bounds__(kFkThreads)
count_hits(const uint8_t* __restrict__ hit, long long n, int* __restrict__ counts) {
  __shared__ int warp_sums[kFkThreads / 32];
  const bool aligned = reinterpret_cast<uintptr_t>(hit) % 16 == 0;
  const long long base = (long long)blockIdx.x * kFkSpan;
  int c = 0;
#pragma unroll
  for (int it = 0; it < kFkIters; ++it) {
    const long long pos = base + (long long)it * kFkChunk + threadIdx.x * 16;
    if (pos < n) c += count16(load16(hit, pos, n, aligned));
  }
  int total;
  block_exclusive(c, warp_sums, total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFkThreads)
scan_counts(const int* __restrict__ counts, int n_blocks, int k, int* __restrict__ prefix,
            int* __restrict__ ids, int* __restrict__ count) {
  __shared__ int warp_sums[kFkThreads / 32];
  for (int j = threadIdx.x; j < k; j += kFkThreads) ids[j] = kFkIdSentinel;
  long long carry = 0;  // hits can exceed int32 only past N = 2^31, which the wrapper refuses
  for (int b0 = 0; b0 < n_blocks; b0 += kFkThreads) {
    const int b = b0 + threadIdx.x;
    const int c = b < n_blocks ? counts[b] : 0;
    int total;
    const int ex = block_exclusive(c, warp_sums, total);
    if (b < n_blocks) prefix[b] = (int)(carry + ex);
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry < k ? (int)carry : k;
}

__global__ void __launch_bounds__(kFkThreads)
write_hits(const uint8_t* __restrict__ hit, long long n, const int* __restrict__ counts,
           const int* __restrict__ prefix, int k, int* __restrict__ ids) {
  __shared__ int warp_sums[kFkThreads / 32];
  int at = prefix[blockIdx.x];
  if (at >= k || counts[blockIdx.x] == 0) return;  // uniform over the block
  const bool aligned = reinterpret_cast<uintptr_t>(hit) % 16 == 0;
  const long long base = (long long)blockIdx.x * kFkSpan;
  for (int it = 0; it < kFkIters && at < k; ++it) {
    const long long pos = base + (long long)it * kFkChunk + threadIdx.x * 16;
    const uint4 v = pos < n ? load16(hit, pos, n, aligned) : make_uint4(0u, 0u, 0u, 0u);
    int total;
    int slot = at + block_exclusive(count16(v), warp_sums, total);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // Byte j of the 16 is byte (j & 3) of word j >> 2 (little-endian).
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) {
        if (slot < k) ids[slot] = (int)(pos + j);
        ++slot;
      }
    }
    at += total;
  }
}

}  // namespace ragfin

using namespace ragfin;

// hit: n bytes on the device. counts, prefix: scratch of n_blocks ints each,
// n_blocks = ceil(n / 32768) (kFkSpan; the wrapper mirrors the constant and
// a mismatch is refused). ids: k ints, count: one int. Returns the first
// CUDA error (0 on success); nothing synchronises.
extern "C" int ragfin_first_k(const uint8_t* hit, long long n, int k, int n_blocks, int* counts,
                              int* prefix, int* ids, int* count, void* stream_ptr) {
  if (n < 1 || n >= (1ll << 31) || k < 1 || n_blocks != (int)((n + kFkSpan - 1) / kFkSpan))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  count_hits<<<n_blocks, kFkThreads, 0, stream>>>(hit, n, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_counts<<<1, kFkThreads, 0, stream>>>(counts, n_blocks, k, prefix, ids, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_hits<<<n_blocks, kFkThreads, 0, stream>>>(hit, n, counts, prefix, k, ids);
  return (int)cudaGetLastError();
}
