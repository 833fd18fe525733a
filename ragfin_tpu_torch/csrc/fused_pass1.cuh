// Pass 1 of the fused cosine top-k kernels over an f32 or bf16 corpus: score
// a block's query rows against a run of kTN-column tiles and keep a running
// top-k per row (see fused_topk.cu for the design). Shared by fused_topk.cu,
// which walks a contiguous chunk of the corpus, ivf_topk.cu, which walks the
// cell a probe table names (PROBED), and ceiling.cu, which keeps the walk,
// the loads and the product and puts a cheaper reduction in the selection's
// place (STAGE; part_s then holds one partial sum per chunk and row).
#pragma once

#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace ragfin {

constexpr int kDK = 32;  // depth of a staged corpus slice

// Four consecutive corpus values of row d, columns c..c+3 of the tile, as
// floats: one 16-byte (f32) or 8-byte (bf16) load where the layout allows,
// else element by element with the column bound.
__device__ __forceinline__ float4 load4(const float* p, bool vec, int valid) {
  if (vec && valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < valid ? __ldg(p + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec, int valid) {
  if (vec && valid >= 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

constexpr int kLoads = kDK * kTN / 4 / kThreads;  // float4 per thread per slice

__device__ __forceinline__ unsigned fold_bits(const float4& v) {
  return __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^
         __float_as_uint(v.w);
}

template <typename T, int TQ, bool PROBED, int STAGE>
__global__ void __launch_bounds__(kThreads)
fused_topk_pass1(const float* __restrict__ q, int Q, int D, const T* __restrict__ ct,
                 long long ld, long long tile_stride, int bn, int n_phys, int limit, int k,
                 int tiles_per_chunk, ProbeWalk walk, CeilArgs ceil, float* __restrict__ part_s,
                 int* __restrict__ part_i) {
  constexpr int RQ = TQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [TQ][D]
  float* cs = qs + TQ * D;                      // [kDK][kTN]
  float* tile = cs + kDK * kTN;                 // [TQ][kTN]
  float* S = tile + TQ * kTN;                   // [TQ][k]
  int* I = reinterpret_cast<int*>(S + TQ * k);  // [TQ][k]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int rows = min(TQ, Q - q0);
  const int chunk = blockIdx.y;
  for (int idx = tid; idx < TQ * D; idx += kThreads) {
    const int r = idx / D;
    qs[idx] = r < rows ? q[(long long)q0 * D + idx] : 0.f;
  }
  init_lists(S, I, TQ * k);

  const bool vec = ld % 4 == 0 && tile_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ct) % (4 * sizeof(T)) == 0;
  const int ty = tid >> 5, tx = tid & 31;
  const int n_tiles = (n_phys + kTN - 1) / kTN;
  const int t_begin = PROBED ? probed_tile(walk, q0, chunk, tiles_per_chunk)
                             : chunk * tiles_per_chunk;
  const int t_end = min(t_begin + tiles_per_chunk, n_tiles);
  const int n_slices = (D + kDK - 1) / kDK;
  const int steps = (t_end - t_begin) * n_slices;

  // Step s stages slice (s % n_slices) of tile t_begin + s / n_slices. The
  // next step's global loads are issued before this step's FMAs (and before
  // a finished tile's selection), so they are in flight meanwhile.
  float4 pre[kLoads];
  auto fetch = [&](int step) {
    const int t = t_begin + step / n_slices;
    const int d0 = (step % n_slices) * kDK;
    const int col0 = t * kTN;
    const long long base = tile_base(col0, tile_stride, bn);
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int v = it * kThreads + tid;
      const int dd = v / (kTN / 4), c = (v % (kTN / 4)) * 4;
      const int d = d0 + dd;
      pre[it] = d < D ? load4(ct + base + (long long)d * ld + c, vec, n_phys - col0 - c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (steps > 0) fetch(0);
  __syncthreads();

  if constexpr (STAGE == kCeilDma) {
    // The loads of every slice, folded into a word the block may have to
    // write; thread 0's first value of slice 0 is element (0, col0).
    unsigned sink = 0;
    float first_sum = 0.f;
    for (int step = 0; step < steps; ++step) {
      const int t = t_begin + step / n_slices;
      if (tid == 0 && step % n_slices == 0 && t % ceil.block_tiles == 0) first_sum += pre[0].x;
#pragma unroll
      for (int it = 0; it < kLoads; ++it) sink ^= fold_bits(pre[it]);
      if (step + 1 < steps) fetch(step + 1);
    }
    if (ceil.sink != nullptr)
      ceil.sink[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid] = sink;
    if (tid == 0) tile[0] = first_sum;
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) part_s[(long long)chunk * Q + q0 + r] = tile[0];
    return;
  }

  CeilRows<STAGE, RQ, float> ceil_rows;
  if constexpr (STAGE != kStageSelect) ceil_rows.init();
  float acc[RQ][4];
  for (int step = 0; step < steps; ++step) {
    const int slice = step % n_slices;
    const int d0 = slice * kDK;
    if (slice == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it)
      reinterpret_cast<float4*>(cs)[it * kThreads + tid] = pre[it];
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
    const int dmax = min(kDK, D - d0);
    if ((D & 3) == 0) {
      // Four d at a time: one 16-byte broadcast load per query row serves
      // four corpus rows (a multiple of 4 when D is).
      for (int dd = 0; dd < dmax; dd += 4) {
        float4 b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          b[u] = *reinterpret_cast<const float4*>(&cs[(dd + u) * kTN + tx * 4]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(&qs[(ty * RQ + i) * D + d0 + dd]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][0] = fmaf(a[u], b[u].x, acc[i][0]);
            acc[i][1] = fmaf(a[u], b[u].y, acc[i][1]);
            acc[i][2] = fmaf(a[u], b[u].z, acc[i][2]);
            acc[i][3] = fmaf(a[u], b[u].w, acc[i][3]);
          }
        }
      }
    } else {
      for (int dd = 0; dd < dmax; ++dd) {
        const float4 b = *reinterpret_cast<const float4*>(&cs[dd * kTN + tx * 4]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float a = qs[(ty * RQ + i) * D + d0 + dd];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
    if (slice == n_slices - 1) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        *reinterpret_cast<float4*>(&tile[(ty * RQ + i) * kTN + tx * 4]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();
      const int col0 = (t_begin + step / n_slices) * kTN;
      if constexpr (STAGE == kStageSelect) select_tile(tile, S, I, k, rows, col0, limit);
      else ceil_rows.tile(tile, rows, col0, limit, n_phys, ceil.block_tiles);
    }
    __syncthreads();
  }
  if constexpr (STAGE == kStageSelect) store_partials(S, I, k, rows, q0, Q, chunk, part_s, part_i);
  else ceil_rows.store(rows, q0, Q, chunk, part_s);
}

template <typename T, int TQ, bool PROBED = false, int STAGE = kStageSelect>
cudaError_t launch_pass1(const float* q, int Q, int D, const void* ct, long long ld,
                         long long tile_stride, int bn, int n_phys, int limit, int k,
                         int tiles_per_chunk, int n_chunks, float* part_s, int* part_i,
                         cudaStream_t stream, ProbeWalk walk = ProbeWalk{},
                         CeilArgs ceil = CeilArgs{}) {
  const size_t smem = sizeof(float) * ((size_t)TQ * D + kDK * kTN + TQ * kTN) +
                      (size_t)TQ * k * (sizeof(float) + sizeof(int));
  auto kernel = fused_topk_pass1<T, TQ, PROBED, STAGE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + TQ - 1) / TQ, n_chunks);
  kernel<<<grid, kThreads, smem, stream>>>(q, Q, D, static_cast<const T*>(ct), ld, tile_stride,
                                           bn, n_phys, limit, k, tiles_per_chunk, walk, ceil,
                                           part_s, part_i);
  return cudaGetLastError();
}

}  // namespace ragfin
