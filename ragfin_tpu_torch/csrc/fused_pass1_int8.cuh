// Pass 1 of the fused cosine top-k kernels over an int8 corpus with
// per-column scales (see fused_topk_int8.cu for the design). Shared by
// fused_topk_int8.cu, which walks a contiguous chunk of the corpus and
// applies the per-row query scale in the merge, and ivf_topk.cu, which
// walks the cell a probe table names and applies the row scale per tile,
// before the column scale and before selection (PROBED), and ceiling.cu,
// which keeps the walk, the loads and the __dp4a product and puts a cheaper
// reduction in the selection's place (STAGE; part_s, or part_i for the
// stages that stay in int32, then holds one partial sum per chunk and row).
#pragma once

#include <type_traits>

#include "topk_common.cuh"

namespace ragfin {

constexpr int kDK8 = 64;          // depth of a staged corpus slice, in d
constexpr int kPK = kDK8 / 4;     // packed words per column in a slice
constexpr int kTasks = kPK * (kTN / 4) / kThreads;  // staging tasks per thread

__device__ __forceinline__ uint32_t load_word(const int8_t* p, bool aligned, int valid_cols) {
  if (aligned && valid_cols >= 4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
  for (int j = 0; j < 4 && j < valid_cols; ++j) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

template <int TQ, bool PROBED, int STAGE>
__global__ void __launch_bounds__(kThreads)
fused_topk_int8_pass1(const int8_t* __restrict__ q8, int Q, int D, const int8_t* __restrict__ ct,
                      const float* __restrict__ cscale, long long ld, long long tile_stride,
                      int bn, int n_phys, int limit, int k, int tiles_per_chunk, ProbeWalk walk,
                      CeilArgs ceil, const float* __restrict__ qscale, float* __restrict__ part_s,
                      int* __restrict__ part_i) {
  constexpr int RQ = TQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int DW = D / 4;                                   // words per query row
  int* qs = reinterpret_cast<int*>(smem);                 // [TQ][DW]
  int* cs = qs + ((TQ * DW + 3) / 4) * 4;                 // [kPK][kTN]
  float* tile = reinterpret_cast<float*>(cs + kPK * kTN); // [TQ][kTN]
  float* S = tile + TQ * kTN;                             // [TQ][k]
  int* I = reinterpret_cast<int*>(S + TQ * k);            // [TQ][k]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int rows = min(TQ, Q - q0);
  const int chunk = blockIdx.y;
  const int* qw = reinterpret_cast<const int*>(q8);
  for (int idx = tid; idx < TQ * DW; idx += kThreads) {
    const int r = idx / DW;
    qs[idx] = r < rows ? qw[(long long)q0 * DW + idx] : 0;
  }
  init_lists(S, I, TQ * k);
  __syncthreads();

  const bool aligned = (ld % 4) == 0 && (tile_stride % 4) == 0 &&
                       (reinterpret_cast<uintptr_t>(ct) % 4) == 0;
  const int ty = tid >> 5, tx = tid & 31;
  const int n_tiles = (n_phys + kTN - 1) / kTN;
  const int t_begin = PROBED ? probed_tile(walk, q0, chunk, tiles_per_chunk)
                             : chunk * tiles_per_chunk;
  const int t_end = min(t_begin + tiles_per_chunk, n_tiles);
  const int n_slices = (D + kDK8 - 1) / kDK8;
  const int steps = (t_end - t_begin) * n_slices;

  // Step s stages slice (s % n_slices) of tile t_begin + s / n_slices; the
  // next step's raw words are loaded before this step's __dp4a loop. Task
  // (p, c4) covers d = d0+4p..+3 of columns 4*c4..+3: four 32-bit words.
  uint32_t pre[kTasks][4];
  auto fetch = [&](int step) {
    const int col0 = (t_begin + step / n_slices) * kTN;
    const int d0 = (step % n_slices) * kDK8;
    const long long base = tile_base(col0, tile_stride, bn);
#pragma unroll
    for (int it = 0; it < kTasks; ++it) {
      const int task = it * kThreads + tid;
      const int p = task / (kTN / 4), c4 = task % (kTN / 4);
      const int d = d0 + 4 * p;
      const int valid_cols = n_phys - (col0 + 4 * c4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pre[it][r] = (d < D && valid_cols > 0)
                         ? load_word(ct + base + (long long)(d + r) * ld + 4 * c4, aligned,
                                     valid_cols)
                         : 0u;
    }
  };
  if (steps > 0) fetch(0);
  __syncthreads();

  if constexpr (STAGE == kCeilDma) {
    // The loads of every slice, folded into a word the block may have to
    // write; the low byte of thread 0's first word of slice 0 is element
    // (0, col0).
    unsigned sink = 0;
    int first_sum = 0;
    for (int step = 0; step < steps; ++step) {
      const int t = t_begin + step / n_slices;
      if (tid == 0 && step % n_slices == 0 && t % ceil.block_tiles == 0)
        first_sum = wrap_add(first_sum, (int)(int8_t)(pre[0][0] & 0xffu));
#pragma unroll
      for (int it = 0; it < kTasks; ++it) sink ^= pre[it][0] ^ pre[it][1] ^ pre[it][2] ^ pre[it][3];
      if (step + 1 < steps) fetch(step + 1);
    }
    if (ceil.sink != nullptr)
      ceil.sink[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid] = sink;
    if (tid == 0) cs[0] = first_sum;
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) part_i[(long long)chunk * Q + q0 + r] = cs[0];
    return;
  }

  constexpr bool kIntStage = STAGE == kCeilMmInt || STAGE == kCeilRowmaxInt;
  using CeilV = std::conditional_t<kIntStage, int, float>;
  CeilRows<STAGE, RQ, CeilV> ceil_rows;
  if constexpr (STAGE != kStageSelect) ceil_rows.init();
  int acc[RQ][4];
  for (int step = 0; step < steps; ++step) {
    const int slice = step % n_slices;
    const int d0 = slice * kDK8;
    if (slice == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    }
#pragma unroll
    for (int it = 0; it < kTasks; ++it) {
      // 4x4 byte transpose: word r holds row d+r of four columns; packed
      // word j holds rows d..d+3 of column j.
      const int task = it * kThreads + tid;
      const int p = task / (kTN / 4), c4 = task % (kTN / 4);
      const uint32_t* w = pre[it];
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
      int4 packed;
      packed.x = (int)__byte_perm(lo01, lo23, 0x5410);
      packed.y = (int)__byte_perm(lo01, lo23, 0x7632);
      packed.z = (int)__byte_perm(hi01, hi23, 0x5410);
      packed.w = (int)__byte_perm(hi01, hi23, 0x7632);
      *reinterpret_cast<int4*>(&cs[p * kTN + 4 * c4]) = packed;
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
    const int pmax = min(kPK, (D - d0) / 4);
    const int w0 = d0 / 4;
    for (int p = 0; p < pmax; ++p) {
      const int4 b = *reinterpret_cast<const int4*>(&cs[p * kTN + tx * 4]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int a = qs[(ty * RQ + i) * DW + w0 + p];
        acc[i][0] = __dp4a(a, b.x, acc[i][0]);
        acc[i][1] = __dp4a(a, b.y, acc[i][1]);
        acc[i][2] = __dp4a(a, b.z, acc[i][2]);
        acc[i][3] = __dp4a(a, b.w, acc[i][3]);
      }
    }
    if constexpr (kIntStage) {
      if (slice == n_slices - 1) {
        // The raw int32 sums: no dequantisation, no f32 tile.
        const int col0 = (t_begin + step / n_slices) * kTN;
        int* itile = reinterpret_cast<int*>(tile);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          *reinterpret_cast<int4*>(&itile[(ty * RQ + i) * kTN + tx * 4]) =
              make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        __syncthreads();
        ceil_rows.tile(itile, rows, col0, limit, n_phys, ceil.block_tiles);
      }
    } else if (slice == n_slices - 1) {
      const int col0 = (t_begin + step / n_slices) * kTN;
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        sc[j] = col < n_phys ? cscale[col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float v[4];
        if (PROBED) {
          // (int -> f32) * row scale * column scale, left to right, as the
          // TPU pruned kernel orders it per tile.
          const int r = ty * RQ + i;
          const float rs = r < rows ? qscale[q0 + r] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), rs), sc[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(__int2float_rn(acc[i][j]), sc[j]);
        }
        *reinterpret_cast<float4*>(&tile[(ty * RQ + i) * kTN + tx * 4]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      if constexpr (STAGE == kStageSelect) select_tile(tile, S, I, k, rows, col0, limit);
      else ceil_rows.tile(tile, rows, col0, limit, n_phys, ceil.block_tiles);
    }
    __syncthreads();
  }
  if constexpr (STAGE == kStageSelect) store_partials(S, I, k, rows, q0, Q, chunk, part_s, part_i);
  else if constexpr (kIntStage) ceil_rows.store(rows, q0, Q, chunk, part_i);
  else ceil_rows.store(rows, q0, Q, chunk, part_s);
}

template <int TQ, bool PROBED = false, int STAGE = kStageSelect>
cudaError_t launch_pass1_int8(const int8_t* q8, int Q, int D, const int8_t* ct,
                              const float* cscale, long long ld, long long tile_stride, int bn,
                              int n_phys, int limit, int k, int tiles_per_chunk, int n_chunks,
                              float* part_s, int* part_i, cudaStream_t stream,
                              ProbeWalk walk = ProbeWalk{}, const float* qscale = nullptr,
                              CeilArgs ceil = CeilArgs{}) {
  const size_t qwords = ((size_t)TQ * (D / 4) + 3) / 4 * 4;
  const size_t smem = sizeof(int) * (qwords + kPK * kTN) + sizeof(float) * TQ * kTN +
                      (size_t)TQ * k * (sizeof(float) + sizeof(int));
  auto kernel = fused_topk_int8_pass1<TQ, PROBED, STAGE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + TQ - 1) / TQ, n_chunks);
  kernel<<<grid, kThreads, smem, stream>>>(q8, Q, D, ct, cscale, ld, tile_stride, bn, n_phys,
                                           limit, k, tiles_per_chunk, walk, ceil, qscale, part_s,
                                           part_i);
  return cudaGetLastError();
}

}  // namespace ragfin
