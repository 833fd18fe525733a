// First k set positions of a byte hit vector, in row order, for sm_90a: one
// launch, a single-pass scan with decoupled look-back.
//
// Replaces ragfin_tpu/index/graph_index.py:_first_k_kernel (:81; Pallas,
// called at :149 through masked_first_k). Same function: hit [N] bytes (int8,
// uint8 or bool, nonzero = hit) -> ids [k] int32, the first k hit positions
// ascending, padded with INT32_MAX, and count = min(number of hits, k). The
// graph store's fact table is sorted quarter-major, so the first k hits of a
// predicate ARE its top-k under the reference's ORDER BY, with no sort.
//
// Bound on an H100: N bytes read once and 4 (k + 1) bytes written, 10 MB at
// N = 10M: 0.0030 ms at 3.35 TB/s; the operations are a compare per byte.
// The bytes the work needs depend on the data: the TPU kernel stops scanning
// once it has k hits (pl.when(cnt0 < k)), so with k hits in the first span
// the work is that span, and with no hit it is every byte.
//
// What the first design (three launches) cost: count_hits over every span, a
// one-block scan_counts, then write_hits, so every byte of N was read on
// every call whatever the hits, and the wrapper allocated the per-span counts
// and prefixes on every call. That was 0.0116 ms of device time against the
// 0.0030 ms bound, and a wrapper call of 0.033-0.066 ms, mostly host time.
//
// This design:
//  - One launch of ceil(N / span) blocks, 32 KB of hits a block. A block
//    takes its span from an atomic ticket when it starts, not from blockIdx,
//    so spans are handed out in the order blocks start.
//  - Single pass, decoupled look-back. A block reads its span into registers
//    and counts its hits, publishes the count (an aggregate) in its span's
//    status word, then reads the status words of the spans before it, newest
//    first, 32 at a time (one per lane of warp 0), adding aggregates until it
//    meets an inclusive prefix or the sum reaches k. The sum, saturated at k,
//    is its exclusive prefix; it publishes its inclusive prefix, and writes
//    each hit at prefix + its rank in the block (a block-wide scan per 4 KB
//    round), dropping ranks at or past k. A block whose prefix is k already
//    writes nothing. Every value is kept saturated at k: the scan only
//    compares with k.
//  - Why the spin cannot deadlock: a block waits only on the status words of
//    spans before its own, and the ticket handed those spans to blocks that
//    had started before it. Started blocks are resident and publish their
//    aggregate without waiting on anything, so every wait ends. Span 0 never
//    waits.
//  - No early exit before the read. The blocks of a 10M call (306) are all
//    resident at once and read their spans before any crossing is known, so
//    a done word and a look-back before the read (tried: PERF.md's first-k
//    findings) only lengthened each block's chain, and were no faster at
//    10M. They pay only where blocks outnumber the resident slots (2.8 x at
//    N = 100M with sparse hits), which no caller reaches.
//  - The block whose span takes the count from below k to k or more writes
//    count = k. With fewer than k hits, the last span writes count = the
//    total and pads slots [count, k) with INT32_MAX.
//  - Scratch that persists across calls (the wrapper keeps one per device and
//    stream): a header (ticket, blocks finished, calls completed) and one
//    64-bit status word per span, tagged with the call's tag (calls
//    completed + 1) in its high half, so no call reads a word of an earlier
//    call as its own. The last block to finish puts the ticket and the
//    finished count back to 0 and advances the call count; when the tag
//    reaches 2^32 - 1 it also clears the status words and starts again from
//    tag 1, so a tag never returns while an old word still carries it.
//    Nothing is cleared per call: one launch, no memset.
//  - Positions are int32 throughout (never a float key), so rows past 2^24
//    stay exact; N < 2^31. 16-byte loads where the pointer is aligned, a
//    byte-wise path for an unaligned pointer or a ragged tail.
#include <cuda_runtime.h>
#include <stdint.h>

// Rounds of 4 KB a block reads: 8 (32 KB spans). chip_smoke.py --sweep
// builds other values to time the span.
#ifndef RAGFIN_FK_ITERS
#define RAGFIN_FK_ITERS 8
#endif

namespace ragfin {

typedef unsigned long long u64;

constexpr int kFkThreads = 256;
constexpr int kFkWarps = kFkThreads / 32;
constexpr int kFkChunk = kFkThreads * 16;  // bytes a block reads per round
constexpr int kFkIters = RAGFIN_FK_ITERS;
constexpr long long kFkSpan = (long long)kFkChunk * kFkIters;
constexpr int kFkIdSentinel = 0x7FFFFFFF;
constexpr unsigned kFkFull = 0xffffffffu;
constexpr u64 kFkInclusive = 1ull << 31;  // status word: an inclusive prefix, not an aggregate
constexpr u64 kFkValue = kFkInclusive - 1;
constexpr int kFkHeaderWords = 2;         // u64 words of scratch before the status words

// Scratch header; the status words follow it:
// tag << 32 | kFkInclusive for an inclusive prefix | value (saturated at k).
struct FkHeader {
  unsigned ticket;    // next span to hand out; 0 between calls
  unsigned finished;  // blocks of this call that have finished; 0 between calls
  unsigned calls;     // calls completed on this scratch (mod 2^32 - 1); the tag is calls + 1
  unsigned unused;
};
static_assert(sizeof(FkHeader) == kFkHeaderWords * sizeof(u64), "scratch header size");

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 status_word(unsigned tag, bool inclusive, int value) {
  return (u64)tag << 32 | (inclusive ? kFkInclusive : 0ull) | (u64)(unsigned)value;
}

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
// `c` in thread order and sets `total`. `warp_sums` is shared, kFkWarps ints.
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
  for (int w = 0; w < kFkWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  return before + inc - c;
}

// Warp 0, all lanes: the exclusive prefix of `span` (> 0), saturated at k,
// from the status words before it, newest first; lane i reads span - 1 - i
// of each window of 32, and a word not yet published is read again until it
// is. Returns at the first inclusive prefix (exact), or once the sum reaches
// k (then k). Before span 0 stands an inclusive prefix of 0. The result is
// the same in every lane.
__device__ int look_back(const u64* status, int span, unsigned tag, int k) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  int j = span - 1;  // the newest span not yet summed
  while (true) {
    const int idx = j - lane;
    const u64 w = idx >= 0 ? ld_relaxed(status + idx) : status_word(tag, true, 0);
    const bool ready = (unsigned)(w >> 32) == tag;
    const unsigned waiting = __ballot_sync(kFkFull, !ready);
    const unsigned inclusive = __ballot_sync(kFkFull, ready && (w & kFkInclusive) != 0ull);
    const int run = waiting ? __ffs(waiting) - 1 : 32;         // lanes [0, run) are published
    const int stop = inclusive ? __ffs(inclusive) - 1 : 32;    // the first inclusive prefix
    const int take = stop < run ? stop + 1 : run;
    long long v = lane < take ? (long long)(w & kFkValue) : 0ll;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFkFull, v, o);
    sum += v;
    if (stop < run || sum >= k) return sum < k ? (int)sum : k;
    j -= run;
  }
}

__global__ void __launch_bounds__(kFkThreads)
first_k_kernel(const uint8_t* __restrict__ hit, long long n, int k, int n_spans, int n_status,
               u64* __restrict__ scratch, int* __restrict__ ids, int* __restrict__ count) {
  __shared__ int warp_sums[kFkWarps];
  __shared__ int s_span, s_excl, s_last;
  __shared__ unsigned s_tag;
  FkHeader* head = reinterpret_cast<FkHeader*>(scratch);
  u64* status = scratch + kFkHeaderWords;
  const int lane = threadIdx.x & 31;

  // 1. The ticket and the call's tag.
  if (threadIdx.x == 0) {
    s_span = (int)atomicAdd(&head->ticket, 1u);
    s_tag = *reinterpret_cast<volatile unsigned*>(&head->calls) + 1u;
  }
  __syncthreads();
  const int span = s_span;
  const unsigned tag = s_tag;

  // 2. Read the span into registers and count its hits.
  const bool aligned = reinterpret_cast<uintptr_t>(hit) % 16 == 0;
  const long long base = (long long)span * kFkSpan;
  uint4 v[kFkIters];
  int c = 0;
#pragma unroll
  for (int it = 0; it < kFkIters; ++it) {
    const long long pos = base + (long long)it * kFkChunk + threadIdx.x * 16;
    v[it] = pos < n ? load16(hit, pos, n, aligned) : make_uint4(0u, 0u, 0u, 0u);
    c += count16(v[it]);
  }
  int agg;
  block_exclusive(c, warp_sums, agg);

  // 3. Publish the aggregate, look back, publish the inclusive prefix. The
  //    crossing span sets the count, and so does the last span when there
  //    are fewer than k hits in all.
  if (threadIdx.x < 32) {
    int excl = 0;
    if (span > 0) {
      if (lane == 0) st_relaxed(status + span, status_word(tag, false, agg < k ? agg : k));
      excl = look_back(status, span, tag, k);
    }
    if (lane == 0) {
      const long long sum = (long long)excl + agg;
      const int incl = sum < k ? (int)sum : k;
      st_relaxed(status + span, status_word(tag, true, incl));
      if (excl < k && incl >= k) {
        *count = k;
      } else if (span == n_spans - 1 && incl < k) {
        *count = incl;
      }
      s_excl = excl;
    }
  }
  __syncthreads();
  const int excl = s_excl;

  // 4. This span's hits at excl + their rank in the block, ranks below k;
  //    the last span pads the slots past the count.
  if (excl < k && agg > 0) {
    int at = excl;
#pragma unroll
    for (int it = 0; it < kFkIters; ++it) {
      if (at >= k) break;  // uniform over the block
      const long long pos = base + (long long)it * kFkChunk + threadIdx.x * 16;
      int total;
      int slot = at + block_exclusive(count16(v[it]), warp_sums, total);
      const uint32_t w[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
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
  if (span == n_spans - 1) {
    const long long sum = (long long)excl + agg;
    for (long long j = sum + threadIdx.x; j < k; j += kFkThreads) ids[j] = kFkIdSentinel;
  }

  // 5. The last block of the call leaves the scratch ready for the next one.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&head->finished, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    const bool wrap = tag == 0xffffffffu;
    if (wrap) {
      for (int j = threadIdx.x; j < n_status; j += kFkThreads) status[j] = 0ull;
    }
    if (threadIdx.x == 0) {
      head->ticket = 0u;
      head->finished = 0u;
      head->calls = wrap ? 0u : tag;
    }
  }
}

}  // namespace ragfin

using namespace ragfin;

// hit: n bytes on the device. scratch: (kFkHeaderWords + n_status) u64
// words, zeroed once when allocated and owned by one stream; n_status >=
// ceil(n / span). out: k + 1 ints, ids then count. Returns the first CUDA
// error (0 on success); nothing synchronises.
extern "C" int ragfin_first_k(const uint8_t* hit, long long n, int k, void* scratch, int n_status,
                              int* out, void* stream_ptr) {
  if (n < 1 || n >= (1ll << 31) || k < 1) return (int)cudaErrorInvalidValue;
  const long long n_spans = (n + kFkSpan - 1) / kFkSpan;
  if (n_spans > n_status) return (int)cudaErrorInvalidValue;
  first_k_kernel<<<(unsigned)n_spans, kFkThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      hit, n, k, (int)n_spans, n_status, static_cast<u64*>(scratch), out, out + k);
  return (int)cudaGetLastError();
}
