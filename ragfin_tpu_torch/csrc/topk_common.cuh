// Shared pieces of the top-k kernels: better(), the order every list keeps;
// the pass-2 merge of per-chunk partial lists (fused_topk.cu,
// fused_topk_int8.cu, ivf_topk.cu) with its shared-memory lists and
// warp-wide insertion; the chunk and probe walks (tile_base, ProbeWalk); and
// the ceiling stages (ceiling.cu). Pass 1 (fused_pass1.cuh) selects with
// twolevel.cuh, whose lists live in registers.
//
// Order contract (ragfin_tpu/ops/topk.py): scores descending, the lower id
// wins a tie, empty slots hold score -inf and id INT32_MAX. A -inf score
// never enters a list, so a row with fewer than k valid columns ends in
// (-inf, INT32_MAX) slots, as the Pallas kernels' flush leaves them.
//
// better() is a strict total order on (score, id) pairs with distinct ids,
// so the top-k of any set is unique whatever order candidates arrive in.
// That is what lets blocks run in any order and the merge combine their
// partial lists: nothing carries over between blocks.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ragfin {

constexpr int kMaxK = 128;        // 4 list slots per lane
constexpr int kTN = 128;          // corpus columns per tile
constexpr int kThreads = 256;     // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kIdSentinel = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Insert (s, id) into the sorted list S/I of length k (shared memory). All
// 32 lanes call it with the same candidate. A candidate that does not beat
// the list's last entry lands at position k, which is no slot: the list is
// unchanged.
__device__ __forceinline__ void warp_insert(float* S, int* I, int k, float s, int id) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
    const int j = t * 32 + lane;
    const bool b = j < k && better(S[j], I[j], s, id);
    pos += __popc(__ballot_sync(kFull, b));
  }
  float vs[kMaxK / 32];
  int vi[kMaxK / 32];
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
    const int j = t * 32 + lane;
    if (j < k && j > pos) {
      vs[t] = S[j - 1];
      vi[t] = I[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
    const int j = t * 32 + lane;
    if (j < k && j > pos) {
      S[j] = vs[t];
      I[j] = vi[t];
    } else if (j == pos && j < k) {
      S[j] = s;
      I[j] = id;
    }
  }
  __syncwarp();
}

// Offer each lane's candidate (v, id) to the list. Returns the ballot of the
// valid lanes whose candidate did not beat the list's last entry at entry.
__device__ __forceinline__ unsigned warp_offer(float* S, int* I, int k, float v, int id,
                                               bool valid) {
  const bool live = valid && v > -CUDART_INF_F;
  const bool ok = live && better(v, id, S[k - 1], I[k - 1]);
  unsigned m = __ballot_sync(kFull, ok);
  const unsigned rejected = __ballot_sync(kFull, valid && !ok);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, v, src);
    const int ci = __shfl_sync(kFull, id, src);
    if (better(cs, ci, S[k - 1], I[k - 1])) warp_insert(S, I, k, cs, ci);
  }
  return rejected;
}

__device__ __forceinline__ void init_lists(float* S, int* I, int n) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    S[idx] = -CUDART_INF_F;
    I[idx] = kIdSentinel;
  }
}

// Fold m sorted candidates (ps, pi) into the list S/I of length k; the
// first 32-wide group with a rejected candidate is the last one offered.
__device__ __forceinline__ void fold_sorted(float* S, int* I, int k, const float* ps,
                                            const int* pi, int m) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < m;
    const float v = valid ? ps[j] : -CUDART_INF_F;
    const int id = valid ? pi[j] : kIdSentinel;
    if (warp_offer(S, I, k, v, id, valid)) break;
  }
}

// Pass 2: one block per query row merges the n_chunks sorted partial
// lists. Warp w folds chunks w, w + 8, ... into its own list (eight short
// dependent chains instead of one long one), then warp 0 folds the eight
// lists. A partial list is sorted, so the first entry that fails a list's
// threshold ends that list. `row_scale` (int8 only) is the per-row query
// scale, applied at the end with -inf kept exact, as the int8 Pallas kernel
// applies it at its flush.
__global__ void __launch_bounds__(kThreads)
merge_partials(const float* __restrict__ part_s, const int* __restrict__ part_i, int n_chunks,
               int Q, int k, const float* __restrict__ row_scale, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* S_all = reinterpret_cast<float*>(smem);              // [kWarps][k]
  int* I_all = reinterpret_cast<int*>(S_all + kWarps * k);    // [kWarps][k]
  float* S = S_all + warp * k;
  int* I = I_all + warp * k;
  const int q = blockIdx.x;
  init_lists(S_all, I_all, kWarps * k);
  __syncthreads();
  // The head (first 32 entries) of the warp's next chunk is loaded before
  // the current chunk is folded, so the global loads overlap the fold.
  float head_v = -CUDART_INF_F;
  int head_i = kIdSentinel;
  auto load_head = [&](int c) {
    const long long o = ((long long)c * Q + q) * k;
    head_v = (c < n_chunks && lane < k) ? part_s[o + lane] : -CUDART_INF_F;
    head_i = (c < n_chunks && lane < k) ? part_i[o + lane] : kIdSentinel;
  };
  load_head(warp);
  for (int c = warp; c < n_chunks; c += kWarps) {
    const float v = head_v;
    const int id = head_i;
    load_head(c + kWarps);
    if (warp_offer(S, I, k, v, id, lane < k) || k <= 32) continue;
    const long long o = ((long long)c * Q + q) * k;
    fold_sorted(S, I, k, part_s + o + 32, part_i + o + 32, k - 32);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) fold_sorted(S, I, k, S_all + w * k, I_all + w * k, k);
  const float scale = row_scale ? row_scale[q] : 1.0f;
  for (int j = lane; j < k; j += 32) {
    const float s = S[j];
    out_s[(long long)q * k + j] = (row_scale && s != -CUDART_INF_F) ? __fmul_rn(s, scale) : s;
    out_i[(long long)q * k + j] = I[j];
  }
}

inline cudaError_t launch_merge(const float* part_s, const int* part_i, int n_chunks, int Q,
                                int k, const float* row_scale, float* out_s, int* out_i,
                                cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * k * (sizeof(float) + sizeof(int));
  merge_partials<<<Q, kThreads, smem, stream>>>(part_s, part_i, n_chunks, Q, k, row_scale,
                                                out_s, out_i);
  return cudaGetLastError();
}

// Corpus element (d, col) of a [kTN]-column tile starting at col0: flat
// [D, N] has ld = N and bn past any column; tile-major [n_tiles, D, bn] has
// ld = bn and tile_stride = D * bn (bn a multiple of kTN, so a kTN tile never
// straddles two layout tiles).
__device__ __forceinline__ long long tile_base(int col0, long long tile_stride, int bn) {
  return (long long)(col0 / bn) * tile_stride + (col0 % bn);
}

// A probed walk (ivf_topk.cu): instead of chunk c covering tiles
// [c * tiles_per_chunk, ...), block (query tile, y) covers split y % splits
// of the cell that row (q0 / block_q) of the probe table [q_tiles, nprobe]
// names at position y / splits. A cell is tiles_per_cell tiles of the
// tile-major corpus, so a column's global index is its permuted id.
struct ProbeWalk {
  const int* probe = nullptr;
  int nprobe = 0;
  int block_q = 1;
  int tiles_per_cell = 0;
  int splits = 1;
};

__device__ __forceinline__ int probed_tile(const ProbeWalk& w, int q0, int y,
                                           int tiles_per_chunk) {
  const int j = y / w.splits, s = y - j * w.splits;
  const int cell = w.probe[(long long)(q0 / w.block_q) * w.nprobe + j];
  return cell * w.tiles_per_cell + s * tiles_per_chunk;
}

// ---------------------------------------------------------------------------
// Ceiling stages (ceiling.cu): pass 1 with the per-row list insertion
// replaced by a cheaper reduction. A "probe tile" is block_tiles consecutive
// kTN-column tiles; each query row sums one value per probe tile.
//   kStageSelect     the real pass 1 (the two-level selection)
//   kCeilDma         loads only: element (0, first column) of the probe tile
//   kCeilMm          product; score of the probe tile's first column, unmasked
//   kCeilMask        the same with columns >= limit set to -inf
//   kCeilRowmax      masked row maximum over the probe tile
//   kCeilPrologue    masked row maximum + arg-maximum (lowest column on a
//                    tie, within the probe tile) as f32
//   kCeilMmInt / kCeilRowmaxInt   (int8 corpus) the raw int32 sums, no
//                    dequantisation; the mask value is -(2^31) + 1
enum Stage : int {
  kStageSelect = 0,
  kCeilDma = 1,
  kCeilMm = 2,
  kCeilMask = 3,
  kCeilRowmax = 4,
  kCeilPrologue = 5,
  kCeilMmInt = 6,
  kCeilRowmaxInt = 7,
};

struct CeilArgs {
  int block_tiles = 1;          // kTN tiles per probe tile; a chunk holds whole probe tiles
  unsigned* sink = nullptr;     // dma: XOR of every word a thread loaded, one word per thread
                                // ([blocks, 512]); written only when non-null, so the loads
                                // cannot be dropped
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

}  // namespace ragfin
