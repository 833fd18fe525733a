// Ceiling probes of the fused cosine top-k kernels, for sm_90a.
//
// Replaces the Pallas ceiling probes of scripts/kernel_probe.py
// (ceiling_parts_1m, ceiling_1m, ceiling_tiled_1m, ceiling_q64,
// ceiling_q1024): the fused kernel's tile walk and product with the running
// top-k merge replaced by a cheaper stand-in, so that the stages of pass 1
// can be timed one on top of the other. Same function: for every query row,
// the sum over corpus tiles of block_n columns ("probe tiles") of
//   dma        element (0, 0) of the tile (the queries are not read)
//   mm         column 0 of q . tile                    (no mask)
//   mask       the same, -inf where the column >= limit
//   rowmax     max over the tile's columns, masked
//   prologue   that maximum plus its arg-maximum inside the tile (lowest
//              column on a tie) as f32
//   mmint, rowmaxint (int8 only)  the same as mm / rowmax on the raw int32
//              sums, masked with -(2^31) + 1, summed in int32
// over an f32 or bf16 corpus (the f32-accurate tensor-core product of pass
// 1: 3xTF32, or bf16 with the queries split unless they are bf16 values) or
// an int8 corpus with per-column scales (int32 product, then int32 -> f32
// times the column scale). Output [Q] f32.
//
// What bounds each stage on an H100: dma reads the corpus once per query
// tile and does nothing else, so device memory bounds it (768 MB of bf16 at
// N = 1M: 0.23 ms at 3.35 TB/s); from mm on, the product runs on the tensor
// cores (f32/bf16 under that same bound at Q = 64; int8 at Q = 1024, 0.40
// ms of s8 products at 1,979 TOP/s against a 0.12 ms read, is bound by its
// operations); the stages above mm add a reduction of every score in
// registers, as the selection's gate compares every score with a register
// threshold, with one combine across warps per probe tile.
//
// Design: the probe IS pass 1 (fused_pass1.cuh, template parameter STAGE):
// the same chunk-of-tiles grid and the same staged slices and product, so a
// change to pass 1 changes the probe with it. Only what follows the scored
// tile differs: mm and mask (and mmint) read one accumulator (and fold every
// accumulator into a word stored only when a sink is passed, so that no
// product is dropped: without it ptxas removed the products of the
// accumulators no stage read, half of them at 64 query rows), rowmax and
// prologue (and rowmaxint) keep each lane's best (and its column) in
// registers across the probe tile and combine the warps' at its end. The TPU probes carry their sum from grid step
// to grid step; here each block sums the probe tiles of its own chunk (a
// chunk holds whole probe tiles) and writes one partial per (chunk, row); ceiling_reduce then adds the partials in
// chunk order, so the result does not depend on how blocks were scheduled
// (no float atomics) and the int stages are exact. On the TPU the BlockSpec
// copy happens whatever the body reads; here nothing is read unless a thread
// loads it, so the dma stage stages every slice of its chunk and each thread
// XORs the words it copied into one word, which the block writes when the
// host passes a sink buffer: the copies cannot be dropped, and the host can
// check the XOR of the words against the corpus.
#include "fused_pass1.cuh"

using namespace ragfin;

// out[q] = sum over chunks, in chunk order, of the float or the int partials.
__global__ void ceiling_reduce(const float* __restrict__ part_f, const int* __restrict__ part_i,
                               int n_chunks, int Q, float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  if (part_i != nullptr) {
    int acc = 0;
    for (int c = 0; c < n_chunks; ++c) acc = wrap_add(acc, part_i[(long long)c * Q + q]);
    out[q] = __int2float_rn(acc);
  } else {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part_f[(long long)c * Q + q];
    out[q] = acc;
  }
}

namespace {

struct Call {
  const void* q;
  int Q, D;
  const void* ct;
  const float* cscale;
  long long ld, tile_stride;
  int bn, n_phys, limit, tiles_per_chunk, n_chunks;
  float* part_f;
  int* part_i;
  cudaStream_t stream;
  CeilArgs ceil;
};

template <typename T, int TQ, int STAGE>
cudaError_t run(const Call& c) {
  return launch_pass1<T, TQ, false, STAGE>(c.q, c.Q, c.D, c.ct, c.ld, c.tile_stride, c.bn,
                                           c.n_phys, c.limit, 0, c.tiles_per_chunk, c.n_chunks,
                                           c.part_f, c.part_i, c.stream, ProbeWalk{}, c.ceil,
                                           c.cscale);
}

template <typename T, int TQ>
cudaError_t dispatch(int stage, const Call& c) {
  static_assert(TQ == 8 || TQ == 32 || TQ == 64, "tq");
  switch (stage) {
    case kCeilDma: return run<T, TQ, kCeilDma>(c);
    case kCeilMm: return run<T, TQ, kCeilMm>(c);
    case kCeilMask: return run<T, TQ, kCeilMask>(c);
    case kCeilRowmax: return run<T, TQ, kCeilRowmax>(c);
    case kCeilPrologue: return run<T, TQ, kCeilPrologue>(c);
    default: break;
  }
  if constexpr (std::is_same<T, int8_t>::value) {
    if (stage == kCeilMmInt) return run<T, TQ, kCeilMmInt>(c);
    if (stage == kCeilRowmaxInt) return run<T, TQ, kCeilRowmaxInt>(c);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_tq(int tq, int stage, const Call& c) {
  return tq == 8 ? dispatch<T, 8>(stage, c) : tq == 32 ? dispatch<T, 32>(stage, c)
                                                       : dispatch<T, 64>(stage, c);
}

}  // namespace

// corpus_dtype: 0 = f32, 1 = bf16 (q is f32 [Q, D]), 2 = int8 (q is int8
// [Q, D], cscale the column scales). stage: a Stage of topk_common.cuh other
// than kStageSelect. tq: 8, 32 or 64 query rows per block. int_partials: whether
// this (stage, dtype) sums in int32 (part_i) or in f32 (part_f). sink: null,
// or [n_chunks * q_tiles * 512] words for the dma stage. Returns the first
// CUDA error (0 on success); nothing synchronises.
extern "C" int ragfin_ceiling(const void* q, int Q, int D, const void* ct, const float* cscale,
                              int corpus_dtype, int stage, long long ld, long long tile_stride,
                              int bn, int n_phys, int limit, int tq, int tiles_per_chunk,
                              int n_chunks, int block_tiles, int int_partials, float* part_f,
                              int* part_i, unsigned* sink, float* out, void* stream_ptr) {
  if ((tq != 8 && tq != 32 && tq != 64) || corpus_dtype < 0 ||
      corpus_dtype > 2 || block_tiles < 1 || tiles_per_chunk % block_tiles != 0)
    return (int)cudaErrorInvalidValue;
  Call c{q,      Q,     D,      ct,    cscale, ld, tile_stride, bn, n_phys, limit, tiles_per_chunk,
         n_chunks, part_f, part_i, static_cast<cudaStream_t>(stream_ptr), CeilArgs{block_tiles, sink}};
  const cudaError_t err = corpus_dtype == 0   ? dispatch_tq<float>(tq, stage, c)
                          : corpus_dtype == 1 ? dispatch_tq<__nv_bfloat16>(tq, stage, c)
                                              : dispatch_tq<int8_t>(tq, stage, c);
  if (err != cudaSuccess) return (int)err;
  ceiling_reduce<<<(Q + 255) / 256, 256, 0, c.stream>>>(part_f, int_partials ? part_i : nullptr,
                                                        n_chunks, Q, out);
  return (int)cudaGetLastError();
}
