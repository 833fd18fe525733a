// Fused exact cosine top-k over an f32 or bf16 corpus, for sm_90a.
//
// Replaces ragfin_tpu/ops/topk.py:_fused_kernel (Pallas, via _fused_call and
// cosine_topk_fused). Same function: queries [Q, D] f32 against corpus_t,
// flat [D, N] or tile-major [n_tiles, D, bn], columns >= limit masked,
// (scores [Q, k] f32 descending, ids [Q, k] int32), lower id first on ties.
//
// Bound on an H100: the "exact" tier must be f32-accurate, so it runs on the
// FP32 cores (no TF32, no bf16 split). At Q = 64 and N = 1M that is
// 2*64*1M*384 = 49 GFLOP, 0.73 ms at 67 TFLOP/s, against 1.536 GB of f32
// corpus, 0.46 ms at 3.35 TB/s: compute bound. At Q = 1 the corpus read
// bounds it. The "fast" tier over a bf16 corpus (queries rounded to bf16 by
// the wrapper) multiplies bf16 values converted to f32; their products are
// exact in f32, so it matches a bf16 product with f32 accumulation.
//
// Design, two passes (the TPU kernel's sequential carry across grid steps
// has no counterpart when blocks run in any order):
//  - pass 1, grid (query tile, corpus chunk): the block keeps its TQ query
//    rows in shared memory, walks its chunk in kTN-column tiles, scores each
//    tile with register-blocked FMAs (thread: TQ/8 rows x 4 columns) into a
//    shared [TQ, kTN] tile, and offers it to per-row running top-k lists in
//    shared memory (one warp per row, ballot + insertion). Each corpus
//    element is read from device memory once per query tile; query tiles of
//    one chunk are neighbours in the grid, so the second read of a chunk
//    mostly hits L2. The next slice's global loads (16-byte vectors where
//    the layout allows) are issued before the current slice's FMAs.
//  - pass 2 (topk_common.cuh merge_partials): a warp per row merges the
//    chunks' partial lists.
// Simple on purpose: no wgmma, TMA or multi-stage pipeline yet.
#include "fused_pass1.cuh"


using namespace ragfin;

// corpus_dtype: 0 = f32, 1 = bf16. tq: 8 or 32 query rows per block.
// Returns the first CUDA error (0 on success); nothing synchronises.
extern "C" int ragfin_fused_topk(const float* q, int Q, int D, const void* ct, int corpus_dtype,
                                 long long ld, long long tile_stride, int bn, int n_phys,
                                 int limit, int k, int tq, int tiles_per_chunk, int n_chunks,
                                 float* part_s, int* part_i, float* out_s, int* out_i,
                                 void* stream_ptr) {
  if (k < 1 || k > kMaxK || (tq != 8 && tq != 32) || corpus_dtype < 0 || corpus_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (corpus_dtype == 0) {
    err = tq == 8 ? launch_pass1<float, 8>(q, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k,
                                           tiles_per_chunk, n_chunks, part_s, part_i, stream)
                  : launch_pass1<float, 32>(q, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k,
                                            tiles_per_chunk, n_chunks, part_s, part_i, stream);
  } else {
    err = tq == 8
              ? launch_pass1<__nv_bfloat16, 8>(q, Q, D, ct, ld, tile_stride, bn, n_phys, limit,
                                               k, tiles_per_chunk, n_chunks, part_s, part_i,
                                               stream)
              : launch_pass1<__nv_bfloat16, 32>(q, Q, D, ct, ld, tile_stride, bn, n_phys, limit,
                                                k, tiles_per_chunk, n_chunks, part_s, part_i,
                                                stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_chunks, Q, k, nullptr, out_s, out_i, stream);
}
