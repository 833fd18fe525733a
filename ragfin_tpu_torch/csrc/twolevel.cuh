// Two-level in-tile selection: the warp-level device functions of the
// Pallas bisect cases (scripts/mosaic_bisect.py, the primitives of
// ragfin_tpu/ops/topk.py:_merge_tile_twolevel), which merge_cases.cu runs
// one at a time; the row-maximum reductions (lanes_max, lanes_best) of the
// ceiling stages; and RowList, the sorted list in a warp's registers that
// pass 1's drainers keep (queue_select.cuh merges into it).
//
// Level 1 is a score tile cut into sub-blocks of columns; each row keeps the
// maximum of each sub-block. Level 2 walks, for one row, only the sub-blocks
// whose maximum beats the row's k-th score, lowest block first, and inside a
// block takes candidates in (score desc, id asc) order, the successor order,
// each inserted into the row's sorted list until one fails. Order and list
// contract: better() in topk_common.cuh.
#pragma once

#include "topk_common.cuh"

namespace ragfin {

// Sub-block row maxima: the maximum of v over the lanes that differ in the
// lane bits FROM..16 (FROM = 1: the whole warp; FROM = 4: the eight lanes of
// an mma fragment that hold one row's columns).
template <int FROM>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int off = 16; off >= FROM; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The best (score, id) pair over the same lanes, in better()'s order: the
// maximum score, the lowest id among equal scores.
template <int FROM>
__device__ __forceinline__ void lanes_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off >= FROM; off >>= 1) {
    const float s2 = __shfl_xor_sync(kFull, s, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    if (better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
}

// Any row improves: lane b (< nb) holds block b's gate value m; returns the
// ballot of the blocks whose value beats kth. Strict >: see the walk's
// exactness argument in fused_pass1.cuh.
__device__ __forceinline__ unsigned improving_blocks(float m, float kth, int nb) {
  return __ballot_sync(kFull, (int)(threadIdx.x & 31) < nb && m > kth);
}

// The lowest improving block of a ballot, kIdSentinel (INT32_MAX) if none.
__device__ __forceinline__ int lowest_block(unsigned hits) {
  return hits ? __ffs(hits) - 1 : kIdSentinel;
}

// Retire a visited block: lane b's gate value becomes -inf (no lane matches
// an index out of range).
__device__ __forceinline__ void retire_block(float& m, int b) {
  if ((int)(threadIdx.x & 31) == b) m = -CUDART_INF_F;
}

// Stage a [rows, sub] block of a row-major [rows, ld] tile into the
// block-major buffer buf [nb, rows, sub], and read block b of it back: row r
// of block b starts at block_row(buf, b, r, rows, sub). The calling threads
// share the copy; the caller synchronises before reading.
__device__ __forceinline__ void stage_block(float* buf, const float* tile, int ld, int b,
                                            int rows, int sub) {
  for (int idx = threadIdx.x; idx < rows * sub; idx += blockDim.x) {
    const int r = idx / sub, c = idx - r * sub;
    buf[((long long)b * rows + r) * sub + c] = tile[(long long)r * ld + b * sub + c];
  }
}

__device__ __forceinline__ const float* block_row(const float* buf, int b, int r, int rows,
                                                  int sub) {
  return buf + ((long long)b * rows + r) * sub;
}

// Successor of (cur_s, cur_i) inside one block of a row, in (score desc, id
// asc) order. Lane l holds the block's columns l, l + 32, ... as v[0..V-1]
// (local ids; a column past the block's end holds -inf). Returns the best
// pair among the columns that come after (cur_s, cur_i): a lower score, or
// an equal score and a higher id. Nothing after it gives (-inf, 0), the
// first column, as an arg-maximum over an all -inf row does. With cur =
// (+inf, -1) it is the block's maximum and arg-maximum.
template <int V>
__device__ __forceinline__ void block_successor(const float (&v)[V], float cur_s, int cur_i,
                                                float& nxt_s, int& nxt_i) {
  const int lane = threadIdx.x & 31;
  nxt_s = -CUDART_INF_F;
  nxt_i = kIdSentinel;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int id = j * 32 + lane;
    const bool later = v[j] < cur_s || (v[j] == cur_s && id > cur_i);
    const float s = later ? v[j] : -CUDART_INF_F;
    if (better(s, id, nxt_s, nxt_i)) {
      nxt_s = s;
      nxt_i = id;
    }
  }
  lanes_best<1>(nxt_s, nxt_i);
}

// Sorted insertion into a row's running top-k, held by one warp in
// registers: entry j (score s, id i) is slot j / 32 of lane j % 32, KS slots
// (k <= 32 * KS). insert() places a candidate after every entry that ranks
// before it in better()'s order and shifts the rest down by one lane; a
// candidate at position k is dropped, so a list of k entries stays sorted
// whatever is offered (ragfin_tpu/ops/topk.py _sorted_insert).
template <int KS>
struct RowList {
  float s[KS];
  int i[KS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      s[t] = -CUDART_INF_F;
      i[t] = kIdSentinel;
    }
  }

  // Entry j, in every lane. Every slot is shuffled and the wanted one
  // picked afterwards: picking a slot by the runtime j before the shuffle
  // would index the slots at run time and put the list in local memory.
  __device__ __forceinline__ void entry(int j, float& es, int& ei) const {
    es = __shfl_sync(kFull, s[0], j & 31);
    ei = __shfl_sync(kFull, i[0], j & 31);
#pragma unroll
    for (int t = 1; t < KS; ++t) {
      const float v = __shfl_sync(kFull, s[t], j & 31);
      const int w = __shfl_sync(kFull, i[t], j & 31);
      es = (j >> 5) == t ? v : es;
      ei = (j >> 5) == t ? w : ei;
    }
  }

  __device__ __forceinline__ void insert(float cs, int ci, int k) {
    const int lane = threadIdx.x & 31;
    int pos = 0;
#pragma unroll
    for (int t = 0; t < KS; ++t)
      pos += __popc(__ballot_sync(kFull, t * 32 + lane < k && better(s[t], i[t], cs, ci)));
    float ps[KS];
    int pi[KS];
#pragma unroll
    for (int t = 0; t < KS; ++t) {  // entry j - 1 of every j, before any moves
      const float up = __shfl_up_sync(kFull, s[t], 1);
      const int upi = __shfl_up_sync(kFull, i[t], 1);
      const float carry = __shfl_sync(kFull, s[t > 0 ? t - 1 : 0], 31);
      const int carryi = __shfl_sync(kFull, i[t > 0 ? t - 1 : 0], 31);
      ps[t] = lane == 0 ? carry : up;
      pi[t] = lane == 0 ? carryi : upi;
    }
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      const int j = t * 32 + lane;
      if (j < k && j > pos) {
        s[t] = ps[t];
        i[t] = pi[t];
      } else if (j == pos && j < k) {
        s[t] = cs;
        i[t] = ci;
      }
    }
  }

  // The list's first k entries to S/I.
  __device__ __forceinline__ void store(float* S, int* I, int k) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int t = 0; t < KS; ++t)
      if (t * 32 + lane < k) {
        S[t * 32 + lane] = s[t];
        I[t * 32 + lane] = i[t];
      }
  }
};

}  // namespace ragfin
