// The selection of the fused and pruned top-k kernels, for sm_90a: candidate
// queues drained in batches by bitonic sorts and merges (WarpSelect /
// BlockSelect: Johnson, Douze, Jegou, "Billion-scale similarity search with
// GPUs", 2017), and pass 2 by bound. Pass 1 (fused_pass1.cuh) gates and
// queues candidates and drains the queues into per-row lists; pass 2
// (merge_bound, here) merges the chunks' lists; merge_cases.cu runs each
// primitive alone as a unit test on the card (ops/merge_cases.py has the
// plain versions).
//
// Replaces the selection of ragfin_tpu/ops/topk.py:_merge_tile_twolevel as
// the port first carried it over (per-tile sub-block maxima, a walk of one
// candidate at a time, a pass 2 folding lists entry by entry).
//
// Arrays across a warp are slot-major: entry j of a 32 * S entry array is
// slot j / 32 of lane j % 32, so a sort's strides of 32 and more compare two
// slots of one lane and the shorter ones are xor shuffles. Order: better()
// (topk_common.cuh), scores descending, the lower id first; empty entries
// are (-inf, INT32_MAX), which rank after every real one.
#pragma once

#include "topk_common.cuh"

namespace ragfin {

__device__ __forceinline__ void take_if(bool c, float& s, int& i, float os, int oi) {
  if (c) {
    s = os;
    i = oi;
  }
}

// Bitonic sort of a slot-major array of 32 * S entries into better() order
// (entry 0 the best). Ids are distinct but for empty entries, which are equal
// to each other, so every exchange is decided or moves equal entries.
template <int S>
__device__ __forceinline__ void sort_slots(float (&s)[S], int (&i)[S]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * S; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int m = stride >> 5;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          if (t & m) continue;
          const int u = t + m;
          const bool desc = ((t << 5) & size) == 0;  // this run's direction
          if (desc ? better(s[u], i[u], s[t], i[t]) : better(s[t], i[t], s[u], i[u])) {
            const float ts = s[t];
            const int ti = i[t];
            s[t] = s[u];
            i[t] = i[u];
            s[u] = ts;
            i[u] = ti;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const float os = __shfl_xor_sync(kFull, s[t], stride);
          const int oi = __shfl_xor_sync(kFull, i[t], stride);
          const bool desc = (((t << 5) | lane) & size) == 0;
          const bool keep_better = ((lane & stride) == 0) == desc;
          take_if(keep_better == better(os, oi, s[t], i[t]), s[t], i[t], os, oi);
        }
      }
    }
  }
}

// Sort a bitonic slot-major sequence of 32 * S entries into better() order:
// the second half of a bitonic sort (slot pairs, then lane pairs).
template <int S>
__device__ __forceinline__ void merge_bitonic(float (&s)[S], int (&i)[S]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = S / 2; m >= 1; m >>= 1)
#pragma unroll
    for (int t = 0; t < S; ++t)
      if ((t & m) == 0 && better(s[t + m], i[t + m], s[t], i[t])) {
        const float ts = s[t];
        const int ti = i[t];
        s[t] = s[t + m];
        i[t] = i[t + m];
        s[t + m] = ts;
        i[t + m] = ti;
      }
#pragma unroll
  for (int st = 16; st >= 1; st >>= 1)
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const float os = __shfl_xor_sync(kFull, s[t], st);
      const int oi = __shfl_xor_sync(kFull, i[t], st);
      take_if(((lane & st) == 0) == better(os, oi, s[t], i[t]), s[t], i[t], os, oi);
    }
}

// (ls, li), sorted, KS slots, becomes the best 32 * KS entries of itself and
// the sorted QS-slot array (qs, qi): entry j is set to the better of list
// entry j and queue entry P - 1 - j (P = 32 * KS; the queue's best P, or the
// queue padded with empty entries), which leaves the best P of the two,
// bitonic; merge_bitonic sorts them.
template <int KS, int QS>
__device__ __forceinline__ void merge_sorted_into(float (&ls)[KS], int (&li)[KS],
                                                  const float (&qs)[QS], const int (&qi)[QS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    constexpr int kLast = KS - 1;
    const int u = kLast - t;  // the queue slot that meets slot t, reversed
    float rs = -CUDART_INF_F;
    int ri = kIdSentinel;
    if (u < QS) {
      rs = __shfl_sync(kFull, qs[u < QS ? u : 0], 31 - lane);
      ri = __shfl_sync(kFull, qi[u < QS ? u : 0], 31 - lane);
    }
    take_if(better(rs, ri, ls[t], li[t]), ls[t], li[t], rs, ri);
  }
  merge_bitonic<KS>(ls, li);
}

// Entries past k of a list become empty, so that a list holds exactly the
// best k of what it was offered.
template <int KS>
__device__ __forceinline__ void clip_list(float (&ls)[KS], int (&li)[KS], int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < KS; ++t)
    if (t * 32 + lane >= k) {
      ls[t] = -CUDART_INF_F;
      li[t] = kIdSentinel;
    }
}

// Drain n (<= 32 * QS) queued entries (qs_mem, qi_mem, in any order) into a
// sorted list of k entries: load, sort, merge, clip. A queue of at most 32
// entries is sorted as one slot.
template <int KS, int QS>
__device__ __forceinline__ void drain_queue(float (&ls)[KS], int (&li)[KS], const float* qs_mem,
                                            const int* qi_mem, int n, int k) {
  const int lane = threadIdx.x & 31;
  if (n <= 32) {
    float s[1] = {lane < n ? qs_mem[lane] : -CUDART_INF_F};
    int i[1] = {lane < n ? qi_mem[lane] : kIdSentinel};
    sort_slots<1>(s, i);
    merge_sorted_into<KS, 1>(ls, li, s, i);
  } else {
    float s[QS];
    int i[QS];
#pragma unroll
    for (int t = 0; t < QS; ++t) {
      const int j = t * 32 + lane;
      s[t] = j < n ? qs_mem[j] : -CUDART_INF_F;
      i[t] = j < n ? qi_mem[j] : kIdSentinel;
    }
    sort_slots<QS>(s, i);
    merge_sorted_into<KS, QS>(ls, li, s, i);
  }
  clip_list<KS>(ls, li, k);
}

// The k-th entry's score of a list, in every lane (-inf while the list holds
// fewer than k entries).
template <int KS>
__device__ __forceinline__ float list_kth(const float (&ls)[KS], int k) {
  float v = __shfl_sync(kFull, ls[0], (k - 1) & 31);
#pragma unroll
  for (int t = 1; t < KS; ++t) {
    const float w = __shfl_sync(kFull, ls[t], (k - 1) & 31);
    v = ((k - 1) >> 5) == t ? w : v;
  }
  return v;
}

// --- the push of pass 1's producers ------------------------------------------

// Push the candidates a producer lane holds into its rows' queues. The lane
// holds an mma fragment: entry (mt, nt, jj) is the score of row r0 + nt * 8 +
// (jj & 1) at column c0 + mt * 16 + (jj >> 1) * 8; bit (mt * NT + nt) * 4 + jj
// of `want` marks the candidates. Each row with candidates reserves slots
// with one shared-memory atomicAdd (cnt counts every reservation, so it may
// pass cap); the entries that land past cap stay in the returned mask, to be
// pushed again into the next queue once this one is handed over. Queue row r
// is qs[r * cap ...], qi[r * cap ...].
template <int MT, int NT>
__device__ __forceinline__ unsigned push_fragment(const float (&S)[MT][NT][4], unsigned want,
                                                  int r0, int c0, float* qs, int* qi, int* cnt,
                                                  int cap) {
  static_assert(MT * NT * 4 <= 32, "one mask bit per fragment entry");
  unsigned left = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      unsigned row_bits = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) row_bits |= 5u << ((mt * NT + nt) * 4 + j);  // jj = j, j + 2
      const unsigned mine = want & row_bits;
      if (mine == 0) continue;
      const int r = r0 + nt * 8 + j;
      int slot = atomicAdd(cnt + r, __popc(mine));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = (mt * NT + nt) * 4 + 2 * h + j;
          if (!((mine >> bit) & 1u)) continue;
          if (slot < cap) {
            qs[r * cap + slot] = S[mt][nt][2 * h + j];
            qi[r * cap + slot] = c0 + mt * 16 + h * 8;
          } else {
            left |= 1u << bit;
          }
          ++slot;
        }
    }
  return left;
}

// --- pass 2 by bound ----------------------------------------------------------

// The largest k-th score over chunks c0, c0 + step, ... < n_chunks of one
// row's partial lists (row q of part [n_chunks, Q, k]), in every lane of the
// warp: a lower bound of the row's global k-th score, since each chunk alone
// holds k entries at or above its own.
__device__ __forceinline__ float chunk_bound(const float* __restrict__ part_s, int n_chunks, int Q,
                                             int q, int k, int c0, int step) {
  const int lane = threadIdx.x & 31;
  float b = -CUDART_INF_F;
  for (int c = c0 + lane * step; c < n_chunks; c += 32 * step)
    b = fmaxf(b, part_s[((long long)c * Q + q) * k + k - 1]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) b = fmaxf(b, __shfl_xor_sync(kFull, b, off));
  return b;
}

// Merge into the warp's list the entries of chunks c0, c0 + step, ... that
// reach the bound (score >= bound and > -inf: a sorted partial list's
// survivors are a prefix of it). Survivors are compacted with ballots into a
// warp queue in shared memory (32 * QS entries) and drained into the list
// when the next chunk's survivors would not fit, and at the end. kG chunks
// are loaded before any is filtered, so their loads overlap. Returns the
// number of survivors.
template <int KS, int QS>
__device__ __forceinline__ int bound_merge(float (&ls)[KS], int (&li)[KS],
                                           const float* __restrict__ part_s,
                                           const int* __restrict__ part_i, int n_chunks, int Q,
                                           int q, int k, int c0, int step, float bound,
                                           float* qs_mem, int* qi_mem) {
  static_assert(QS >= KS, "a queue holds one chunk's survivors");
  constexpr int kG = 8 / KS;  // 8 loads in flight a lane, within the registers of KS = 4
  const int lane = threadIdx.x & 31;
  int queued = 0, total = 0;
  for (int cg = c0; cg < n_chunks; cg += kG * step) {
    float v[kG][KS];
    int id[kG][KS];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int c = cg + g * step;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        const int j = t * 32 + lane;
        const bool in = c < n_chunks && j < k;
        const long long o = ((long long)c * Q + q) * k + j;
        v[g][t] = in ? part_s[o] : -CUDART_INF_F;
        id[g][t] = in ? part_i[o] : kIdSentinel;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      unsigned keep[KS];
      int n = 0;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        keep[t] = __ballot_sync(kFull, v[g][t] > -CUDART_INF_F && v[g][t] >= bound);
        n += __popc(keep[t]);
      }
      if (n == 0) continue;
      if (queued + n > 32 * QS) {
        __syncwarp();
        drain_queue<KS, QS>(ls, li, qs_mem, qi_mem, queued, k);
        queued = 0;
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        if ((keep[t] >> lane) & 1u) {
          const int at = queued + __popc(keep[t] & ((1u << lane) - 1u));
          qs_mem[at] = v[g][t];
          qi_mem[at] = id[g][t];
        }
        queued += __popc(keep[t]);
      }
      total += n;
    }
  }
  __syncwarp();
  if (queued > 0) drain_queue<KS, QS>(ls, li, qs_mem, qi_mem, queued, k);
  __syncwarp();
  return total;
}

// Pass 2: one block of W warps per query row. The block's bound is the
// largest chunk k-th score; warp w merges the survivors of chunks w, w + W,
// ... into its own list, then the lists are merged pairwise in a tree
// (log2 W levels). `row_scale` (int8 only) is the per-row query scale,
// applied at the end with -inf kept exact, as the int8 Pallas kernel applies
// it at its flush.
template <int KS, int W>
__global__ void __launch_bounds__(32 * W, 1)
merge_bound(const float* __restrict__ part_s, const int* __restrict__ part_i, int n_chunks, int Q,
            int k, const float* __restrict__ row_scale, float* __restrict__ out_s,
            int* __restrict__ out_i) {
  constexpr int QS = 4;  // a warp queue of 128 entries
  constexpr int P = 32 * KS;
  __shared__ float red[W];
  __shared__ float qs_all[W][32 * QS];
  __shared__ int qi_all[W][32 * QS];
  __shared__ float ls_all[W][P];
  __shared__ int li_all[W][P];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x;
  float b = chunk_bound(part_s, n_chunks, Q, q, k, warp, W);
  if (lane == 0) red[warp] = b;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < W; ++w) b = fmaxf(b, red[w]);
  float ls[KS];
  int li[KS];
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    ls[t] = -CUDART_INF_F;
    li[t] = kIdSentinel;
  }
  bound_merge<KS, QS>(ls, li, part_s, part_i, n_chunks, Q, q, k, warp, W, b, qs_all[warp],
                      qi_all[warp]);
#pragma unroll
  for (int span = 1; span < W; span <<= 1) {
    if (warp % (2 * span) == span) {
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        ls_all[warp][t * 32 + lane] = ls[t];
        li_all[warp][t * 32 + lane] = li[t];
      }
    }
    __syncthreads();
    if (warp % (2 * span) == 0) {
      float os[KS];
      int oi[KS];
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        os[t] = ls_all[warp + span][t * 32 + lane];
        oi[t] = li_all[warp + span][t * 32 + lane];
      }
      merge_sorted_into<KS, KS>(ls, li, os, oi);
    }
    __syncthreads();
  }
  if (warp != 0) return;
  const float scale = row_scale ? row_scale[q] : 1.0f;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    const int j = t * 32 + lane;
    if (j < k) {
      const float s = ls[t];
      out_s[(long long)q * k + j] = (row_scale && s != -CUDART_INF_F) ? __fmul_rn(s, scale) : s;
      out_i[(long long)q * k + j] = li[t];
    }
  }
}

// Warps per row of pass 2: 16 (512 threads, so that the lists of k <= 128
// stay in registers; 16 ran ahead of 8 at Q = 1, 8 and 64, PERF.md).
constexpr int kMergeWarps = 16;

// Pass 2 over part_s/part_i [n_chunks, Q, k] (k <= kMaxK): one block per row.
inline cudaError_t launch_merge(const float* part_s, const int* part_i, int n_chunks, int Q,
                                int k, const float* row_scale, float* out_s, int* out_i,
                                cudaStream_t stream) {
  if (k <= 64)
    merge_bound<2, kMergeWarps><<<Q, 32 * kMergeWarps, 0, stream>>>(
        part_s, part_i, n_chunks, Q, k, row_scale, out_s, out_i);
  else
    merge_bound<4, kMergeWarps><<<Q, 32 * kMergeWarps, 0, stream>>>(
        part_s, part_i, n_chunks, Q, k, row_scale, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace ragfin
