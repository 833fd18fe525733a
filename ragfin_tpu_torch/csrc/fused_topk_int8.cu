// Fused cosine top-k over an int8 corpus with per-column scales, for sm_90a.
//
// Replaces ragfin_tpu/ops/topk.py:_fused_kernel_int8 (Pallas, via
// _fused_call_int8 and cosine_topk_fused_int8). Same function and the same
// order of operations, so the scores match the JAX kernel's bit for bit:
//   - the int8 x int8 dot product accumulates exactly in int32 (__dp4a);
//   - it is converted to f32 and multiplied by the column's corpus scale
//     BEFORE selection;
//   - the per-row query scale (a positive constant per row, so it cannot
//     change the order) is applied once at the end, in the merge, keeping
//     -inf exact (an all-zero query row gives no NaN).
// Query quantization stays outside the kernel (ops/quantize.py), as it is
// plain XLA outside the Pallas call in JAX.
//
// Bound on an H100: N = 1M columns of D = 384 int8 plus 4 MB of scales is
// 0.388 GB, 0.116 ms at 3.35 TB/s; the tensor cores' int8 rate would make
// the 49 GOP at Q = 64 cheaper than that. This kernel runs __dp4a on the
// CUDA cores instead (a simple first version: no int8 mma yet), which at
// Q = 64 makes it compute-bound on its own instruction rate.
//
// Layout: the corpus is [D, N] (or tile-major), so four consecutive d of
// one column are N bytes apart. Each staged slice is repacked in shared
// memory to d-major words (4 d of one column per 32-bit word, a 4x4 byte
// transpose with __byte_perm) for __dp4a; query rows are contiguous in d
// and are words already. The rest (two passes, list selection) is
// fused_topk.cu's design.
#include "fused_pass1_int8.cuh"


using namespace ragfin;

// q8 [Q, D] int8 and qscale [Q] f32 from ops/quantize.py; cscale holds one
// f32 per physical column (flat [1, N] or tile-major [n_tiles, 1, bn], both
// contiguous). D must be a multiple of 4. Returns the first CUDA error.
extern "C" int ragfin_fused_topk_int8(const int8_t* q8, const float* qscale, int Q, int D,
                                      const int8_t* ct, const float* cscale, long long ld,
                                      long long tile_stride, int bn, int n_phys, int limit,
                                      int k, int tq, int tiles_per_chunk, int n_chunks,
                                      float* part_s, int* part_i, float* out_s, int* out_i,
                                      void* stream_ptr) {
  if (k < 1 || k > kMaxK || (tq != 8 && tq != 32) || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err =
      tq == 8 ? launch_pass1_int8<8>(q8, Q, D, ct, cscale, ld, tile_stride, bn, n_phys, limit, k,
                                     tiles_per_chunk, n_chunks, part_s, part_i, stream)
              : launch_pass1_int8<32>(q8, Q, D, ct, cscale, ld, tile_stride, bn, n_phys, limit,
                                      k, tiles_per_chunk, n_chunks, part_s, part_i, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_chunks, Q, k, qscale, out_s, out_i, stream);
}
