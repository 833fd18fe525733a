// Shared pieces of the top-k kernels: better(), the order every list keeps;
// the chunk and probe walks (tile_base, ProbeWalk); and the ceiling stages
// (ceiling.cu). The selection, pass 1's queues and drains and pass 2, is
// queue_select.cuh.
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
// Ceiling stages (ceiling.cu): pass 1 with the selection replaced by a
// cheaper reduction. A "probe tile" is block_tiles consecutive
// kTN-column tiles; each query row sums one value per probe tile.
//   kStageSelect     the real pass 1 (gate, queues, drains)
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
                                // ([blocks, 512]); mm, mask, mmint: XOR of its accumulators;
                                // written only when non-null, so neither the loads nor the
                                // products can be dropped
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

}  // namespace ragfin
