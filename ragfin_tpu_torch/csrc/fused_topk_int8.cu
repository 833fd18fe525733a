// Fused cosine top-k over an int8 corpus with per-column scales, for sm_90a.
//
// Replaces ragfin_tpu/ops/topk.py:_fused_kernel_int8 (Pallas, via
// _fused_call_int8 and cosine_topk_fused_int8). Same function and the same
// order of operations, so the scores match the JAX kernel's bit for bit:
//   - the int8 x int8 dot product accumulates exactly in int32 (mma.sync
//     m16n8k32 s8 on the tensor cores; an integer sum is the same in any
//     order);
//   - it is converted to f32 and multiplied by the column's corpus scale
//     BEFORE selection;
//   - the per-row query scale (a positive constant per row, so it cannot
//     change the order) is applied once at the end, in the merge, keeping
//     -inf exact (an all-zero query row gives no NaN).
// Query quantization stays outside the kernel (ops/quantize.py), as it is
// plain XLA outside the Pallas call in JAX.
//
// Bound on an H100: N = 1M columns of D = 384 int8 plus 4 MB of scales is
// 0.388 GB, 0.116 ms at 3.35 TB/s; the 49 GOP of the product at Q = 64 take
// 0.025 ms at 1,979 TOP/s, so the read bounds it.
//
// Design: fused_topk.cu's, on the same pass 1 (fused_pass1.cuh, T = int8_t):
// a cp.async ring of corpus slices, the byte transpose into a k-packed
// buffer that mma.sync reads, int -> f32 times the column scale per tile,
// the gate, queues and drains (queue_select.cuh), then the merge of the
// chunks' lists by bound (queue_select.cuh merge_bound) with the row scale.
#include "fused_pass1.cuh"


using namespace ragfin;

// q8 [Q, D] int8 and qscale [Q] f32 from ops/quantize.py; cscale holds one
// f32 per physical column (flat [1, N] or tile-major [n_tiles, 1, bn], both
// contiguous). D must be a multiple of 4. tq: 8, 32 or 64 query rows per
// block (ops/topk.py _tile). Returns the first CUDA error.
extern "C" int ragfin_fused_topk_int8(const int8_t* q8, const float* qscale, int Q, int D,
                                      const int8_t* ct, const float* cscale, long long ld,
                                      long long tile_stride, int bn, int n_phys, int limit,
                                      int k, int tq, int tiles_per_chunk, int n_chunks,
                                      float* part_s, int* part_i, float* out_s, int* out_i,
                                      void* stream_ptr) {
  if (k < 1 || k > kMaxK || (tq != 8 && tq != 32 && tq != 64) || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto run = [&](auto tq_c) {
    constexpr int TQ = decltype(tq_c)::value;
    return k <= 64 ? launch_pass1<int8_t, TQ, false, kStageSelect, 2>(
                         q8, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k, tiles_per_chunk,
                         n_chunks, part_s, part_i, stream, ProbeWalk{}, CeilArgs{}, cscale)
                   : launch_pass1<int8_t, TQ, false, kStageSelect, 4>(
                         q8, Q, D, ct, ld, tile_stride, bn, n_phys, limit, k, tiles_per_chunk,
                         n_chunks, part_s, part_i, stream, ProbeWalk{}, CeilArgs{}, cscale);
  };
  cudaError_t err = tq == 8    ? run(std::integral_constant<int, 8>{})
                    : tq == 32 ? run(std::integral_constant<int, 32>{})
                               : run(std::integral_constant<int, 64>{});
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_chunks, Q, k, qscale, out_s, out_i, stream);
}
