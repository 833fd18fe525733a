// Cluster-pruned cosine top-k over the probed cells of an IVF index, for
// sm_90a: f32, bf16 and int8 cells.
//
// Replaces ragfin_tpu/ops/ivf.py:_pruned_kernel (Pallas, via _ivf_call and
// ivf_topk). Same function: queries [Qp, D] in tiles of block_q rows; a
// probe table [q_tiles, nprobe] int32, ascending per row, names the cells
// [n_cells, D, cell] each tile scans; columns whose permuted position
// cell_id * cell + col is at or past n_valid are masked; per row the top k
// of the scanned columns, scores descending, the lower permuted id first on
// ties, empty slots (-inf, INT32_MAX). Ids stay in permuted space (the
// wrapper maps them back). The int8 route multiplies int32 -> f32, then by
// the ROW scale, then by the column scale, per tile and before selection,
// the TPU kernel's order (and the other order than fused_topk_int8.cu's),
// so its scores equal the TPU kernel's bit for bit.
//
// Bound on an H100: the probed cells are read once per query tile,
// q_tiles * nprobe * cell * D * itemsize bytes (Q = 8, nprobe = 32,
// cell = 2048, D = 384, f32: 101 MB, 30 us at 3.35 TB/s), against
// 2 * Qp * nprobe * cell * D operations (0.40 GFLOP; the f32-accurate
// product on the tensor cores, 3xTF32, takes 2.4 us at 495 TFLOP/s): bytes
// bound.
//
// Design. The TPU kernel's grid is (probe position, query tile), run in
// order on one core, with the running top-k carried in VMEM from one probe
// position to the next; its probe list is ascending so that permuted ids
// grow along the walk and a strict > keeps the lowest id on ties. Blocks
// run in any order here, so nothing is carried: the cells ARE the
// tile-major corpus layout of fused_topk.cu (bn = cell, a column's global
// index = its permuted id), so pass 1 is that kernel's pass 1
// (fused_pass1.cuh: mma.sync products, a cp.async ring, the gate, queues
// and drains) with the block's tile run taken from the probe table
// (ProbeWalk, topk_common.cuh): block (query sub-tile, probe position x
// split) scores its TQ rows against its share of one probed cell, in
// ascending column order, and writes a sorted partial list; pass 2
// (merge_bound) merges the nprobe * splits lists of each row. better()
// is a strict total order on (score, permuted id), so the result is the
// ascending walk's whatever order the blocks ran in. `splits` cuts a cell
// over several blocks so that a single query tile still fills the card.
// int8 cells run the same pass 1 (T = int8_t: mma.sync s8 products).
#include "fused_pass1.cuh"

using namespace ragfin;

// dtype: 0 = f32 cells, 1 = bf16 cells (q is f32 [Qp, D]; qscale and cscale
// unused), 2 = int8 cells (q is int8 [Qp, D], qscale f32 [Qp], cscale f32
// [n_cells * cell]). Qp is a multiple of block_q, block_q of tq (8 or 32;
// the probed walk's 64-row blocks spilled registers over f32 cells), cell of
// 128 * splits. probe: [Qp / block_q, nprobe] int32. part_*:
// [nprobe * splits, Qp, k]. Returns the first CUDA error (0 on success);
// nothing synchronises.
extern "C" int ragfin_ivf_topk(const void* q, const float* qscale, int Qp, int D,
                               const void* cells, const float* cscale, int dtype, int n_cells,
                               int cell, int n_valid, int k, int tq, int block_q,
                               const int* probe, int nprobe, int splits, float* part_s,
                               int* part_i, float* out_s, int* out_i, void* stream_ptr) {
  if (k < 1 || k > kMaxK || (tq != 8 && tq != 32) || dtype < 0 || dtype > 2 || block_q < 1 ||
      block_q % tq != 0 || Qp % block_q != 0 || cell % kTN != 0 || splits < 1 ||
      (cell / kTN) % splits != 0 || nprobe < 1 || nprobe > n_cells ||
      (long long)n_cells * cell >= (1ll << 31) || (dtype == 2 && D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ProbeWalk walk;
  walk.probe = probe;
  walk.nprobe = nprobe;
  walk.block_q = block_q;
  walk.tiles_per_cell = cell / kTN;
  walk.splits = splits;
  const int per_chunk = walk.tiles_per_cell / splits;
  const int n_chunks = nprobe * splits;
  const int n_phys = n_cells * cell;
  const long long ld = cell, tile_stride = (long long)D * cell;
  auto run = [&](auto tag, auto tq_c) {
    using T = decltype(tag);
    constexpr int TQ = decltype(tq_c)::value;
    return k <= 64 ? launch_pass1<T, TQ, true, kStageSelect, 2>(
                         q, Qp, D, cells, ld, tile_stride, cell, n_phys, n_valid, k, per_chunk,
                         n_chunks, part_s, part_i, stream, walk, CeilArgs{}, cscale, qscale)
                   : launch_pass1<T, TQ, true, kStageSelect, 4>(
                         q, Qp, D, cells, ld, tile_stride, cell, n_phys, n_valid, k, per_chunk,
                         n_chunks, part_s, part_i, stream, walk, CeilArgs{}, cscale, qscale);
  };
  auto by_tq = [&](auto tag) {
    return tq == 8 ? run(tag, std::integral_constant<int, 8>{})
                   : run(tag, std::integral_constant<int, 32>{});
  };
  const cudaError_t err = dtype == 0   ? by_tq(float{})
                          : dtype == 1 ? by_tq(__nv_bfloat16{})
                                       : by_tq(int8_t{});
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_chunks, Qp, k, nullptr, out_s, out_i, stream);
}
