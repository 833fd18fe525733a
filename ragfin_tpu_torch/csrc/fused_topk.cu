// Fused exact cosine top-k over an f32 or bf16 corpus, for sm_90a.
//
// Replaces ragfin_tpu/ops/topk.py:_fused_kernel (Pallas, via _fused_call and
// cosine_topk_fused). Same function: queries [Q, D] f32 against corpus_t,
// flat [D, N] or tile-major [n_tiles, D, bn], columns >= limit masked,
// (scores [Q, k] f32 descending, ids [Q, k] int32), lower id first on ties.
//
// Bound on an H100 at Q = 64 and N = 1M: the corpus read, 1.536 GB of f32
// in 0.4585 ms at 3.35 TB/s (bf16: 0.768 GB, 0.2293 ms). The "exact" tier
// is f32-accurate on the tensor cores (3xTF32 over an f32 corpus, a three-way
// bf16 split of the queries over a bf16 corpus): 3 * 49.2 GFLOP in 0.30 ms at
// 495 TFLOP/s, under the bytes. The "fast" tier over a bf16 corpus (queries
// rounded to bf16 as pass 1 stages them) is one bf16 product with f32
// accumulation.
//
// Design, two passes (the TPU kernel's sequential carry across grid steps
// has no counterpart when blocks run in any order):
//  - pass 1 (fused_pass1.cuh), grid (query tile, corpus chunk): the block
//    keeps its TQ query rows (8, 32 or 64, so that Q = 64 reads the corpus
//    once) in shared memory, streams its chunk through a cp.async ring of
//    corpus slices, scores each kTN-column tile with mma.sync, gates every
//    score in registers against its row's k-th score, queues the few that
//    pass in shared memory, and drains the queues into per-row lists in
//    batches (bitonic sort and merge, queue_select.cuh). The chunk count is
//    about one wave of resident blocks, so pass 2 merges few lists.
//  - pass 2 (queue_select.cuh merge_bound): a block per row keeps only the
//    entries at or above the largest chunk k-th score and merges them.
#include "fused_pass1.cuh"


using namespace ragfin;

// corpus_dtype: 0 = f32, 1 = bf16. round_q (bf16 only): round the queries
// to bf16 first, the fast tier. tq: 8, 32 or 64 query rows per block (64
// only where its shared memory fits: ops/topk.py _pass1_tile). Returns the
// first CUDA error (0 on success); nothing synchronises.
extern "C" int ragfin_fused_topk(const float* q, int Q, int D, const void* ct, int corpus_dtype,
                                 int round_q, long long ld, long long tile_stride, int bn,
                                 int n_phys, int limit, int k, int tq, int tiles_per_chunk,
                                 int n_chunks, float* part_s, int* part_i, float* out_s,
                                 int* out_i, void* stream_ptr) {
  if (k < 1 || k > kMaxK || (tq != 8 && tq != 32 && tq != 64) || corpus_dtype < 0 ||
      corpus_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto run = [&](auto tag, auto tq_c) {
    using T = decltype(tag);
    constexpr int TQ = decltype(tq_c)::value;
    return k <= 64 ? launch_pass1<T, TQ, false, kStageSelect, 2>(
                         q, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k, tiles_per_chunk,
                         n_chunks, part_s, part_i, stream, ProbeWalk{}, CeilArgs{}, nullptr,
                         nullptr, round_q != 0)
                   : launch_pass1<T, TQ, false, kStageSelect, 4>(
                         q, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k, tiles_per_chunk,
                         n_chunks, part_s, part_i, stream, ProbeWalk{}, CeilArgs{}, nullptr,
                         nullptr, round_q != 0);
  };
  auto by_tq = [&](auto tag) {
    if (tq == 8) return run(tag, std::integral_constant<int, 8>{});
    if (tq == 32) return run(tag, std::integral_constant<int, 32>{});
    return run(tag, std::integral_constant<int, 64>{});
  };
  cudaError_t err = corpus_dtype == 0 ? by_tq(float{}) : by_tq(__nv_bfloat16{});
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_chunks, Q, k, nullptr, out_s, out_i, stream);
}
