// The primitives of the two-level in-tile selection, one kernel per case, for
// sm_90a.
//
// Replaces scripts/mosaic_bisect.py:_run (the pallas_call of the nine Mosaic
// bisect cases). Same function as each case: one [64, 256] f32 tile in, two
// sub-blocks of 128 columns, a [64, 128] f32 result (ops/merge_cases.py says
// what each case computes). On the TPU the cases asked whether Mosaic could
// lower each operation of ragfin_tpu/ops/topk.py:_merge_tile_twolevel; here
// the nine run the device functions of twolevel.cuh, and four more run the
// primitives of the selection that pass 1 and pass 2 of the fused and pruned
// kernels use (queue_select.cuh: the queue push, the bitonic sort, the
// bitonic merge, pass 2's bound filter), so each is a unit test of that
// selection on the card, bit for bit against its plain version.
//
// Bound on an H100: 64 KB in, 32 KB out, about 30 ns of memory; one block,
// so a launch's few microseconds are the whole time. No request path runs
// these kernels.
//
// Design: one block of eight warps; warp w owns rows w, w + 8, ... A
// reduction over rows (any, min) is a block barrier (__syncthreads_or, or an
// atomicMin in shared memory between two barriers); everything per row is
// the warp's, as in pass 1.
#include "queue_select.cuh"
#include "twolevel.cuh"

using namespace ragfin;

namespace {

constexpr int kRows = 64, kCols = 256, kSub = 128, kNb = kCols / kSub, kCaseK = 10;
constexpr int kOut = 128;
constexpr int kRowsPerWarp = kRows / kWarps;

enum Case : int {
  kSubmax = 0,
  kAnyAxis0 = 1,
  kScalarMin = 2,
  kLaneMinThenScalar = 3,
  kBufload = 4,
  kRetire = 5,
  kWhileLoopM = 6,
  kNestedInsert = 7,
  kNestedWhile = 8,
  kQueuePush = 9,
  kBitonicSort = 10,
  kBitonicMerge = 11,
  kBoundFilter = 12,
};

// The queue push case: pass 1's producer layout at 64 rows (Layout<64> of
// fused_pass1.cuh: four column groups of 32 by two query groups, each lane
// an m16n8 fragment of 2 x 4 tiles), the tile's two halves as two tiles,
// a small queue so that rows overflow it, and a threshold of 0.5.
constexpr int kPMT = 2, kPNT = 4, kPWC = 4, kPSub = 32, kPushCap = 16;
constexpr float kPushAbove = 0.5f;
// The bound filter case: each row's four 64-column quarters are the chunks,
// each keeping its best kPartK.
constexpr int kChunks = 4, kChunkCols = kCols / kChunks, kPartK = 16;

// Row r's 32 * S entries from column c0 on, slot-major (id = the column).
template <int S>
__device__ __forceinline__ void load_row(const float* x, int r, int c0, float (&s)[S], int (&i)[S]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    i[t] = c0 + t * 32 + lane;
    s[t] = x[r * kCols + i[t]];
  }
}

// Entries 0..63 of a sorted slot-major list: ids (as f32) to out[r][0..63],
// scores to out[r][64..127].
__device__ __forceinline__ void write_sorted(float* out, int r, const float (&s)[2],
                                             const int (&i)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    out[r * kOut + t * 32 + lane] = __int2float_rn(i[t]);
    out[r * kOut + 64 + t * 32 + lane] = s[t];
  }
}

// The minimum of every thread's v over the block.
__device__ __forceinline__ int block_min(int v, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = kIdSentinel;
  __syncthreads();
  atomicMin(slot, v);
  __syncthreads();
  return *slot;
}

__device__ __forceinline__ void fill_row(float* out, int r, float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = lane; c < kOut; c += 32) out[r * kOut + c] = v;
}

// Gate values of a row: its first kNb columns, one per lane (-inf past them).
__device__ __forceinline__ float gate(const float* x, int r) {
  const int lane = threadIdx.x & 31;
  return lane < kNb ? x[r * kCols + lane] : -CUDART_INF_F;
}

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1) merge_case_kernel(const float* __restrict__ x,
                                                              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);                      // [kNb][kRows][kSub]
  int* slot = reinterpret_cast<int*>(buf + kNb * kRows * kSub);  // block_min's word
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if constexpr (CASE == kSubmax) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < kNb; ++b) {
        float v = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kSub / 32; ++j) v = fmaxf(v, x[r * kCols + b * kSub + j * 32 + lane]);
        mx = fmaxf(mx, lanes_max<1>(v));  // the maximum of the sub-block maxima
      }
      fill_row(out, r, mx);
    }
  } else if constexpr (CASE == kAnyAxis0) {
    int count = 0;
#pragma unroll
    for (int b = 0; b < kNb; ++b) {
      bool h = false;
      for (int r = tid; r < kRows; r += blockDim.x) h |= x[r * kCols + b] > 0.5f;
      count += __syncthreads_or(h) ? 1 : 0;
    }
    for (int idx = tid; idx < kRows * kOut; idx += blockDim.x) out[idx] = (float)count;
  } else if constexpr (CASE == kScalarMin || CASE == kLaneMinThenScalar) {
    int v = kIdSentinel;
    if constexpr (CASE == kScalarMin) {
      // One min over every (row, column) pair.
      for (int idx = tid; idx < kRows * kNb; idx += blockDim.x) {
        const int r = idx / kNb, b = idx - r * kNb;
        if (x[r * kCols + b] > 0.5f) v = min(v, b);
      }
    } else {
      // Each row's lowest improving block, then the min over rows.
      for (int i = 0; i < kRowsPerWarp; ++i)
        v = min(v, lowest_block(improving_blocks(gate(x, warp + kWarps * i), 0.5f, kNb)));
    }
    const float b = __int2float_rn(block_min(v, slot));
    for (int idx = tid; idx < kRows * kOut; idx += blockDim.x) out[idx] = b;
  } else if constexpr (CASE == kBufload) {
#pragma unroll
    for (int b = 0; b < kNb; ++b) stage_block(buf, x, kCols, b, kRows, kSub);
    __syncthreads();
    // A runtime index: int(x[0, 0]) saturates, and the slice clamps it.
    const int b = max(0, min(min(1, __float2int_rz(x[0])), kNb - 1));
    for (int idx = tid; idx < kRows * kOut; idx += blockDim.x) {
      const int r = idx / kOut, c = idx - r * kOut;
      out[idx] = block_row(buf, b, r, kRows, kSub)[c];
    }
  } else if constexpr (CASE == kRetire) {
    const int b = __float2int_rz(x[0]);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      float m = gate(x, r);
      retire_block(m, b);
      fill_row(out, r, lanes_max<1>(m));
    }
  } else if constexpr (CASE == kWhileLoopM) {
    float m[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) m[i] = gate(x, warp + kWarps * i);
    int steps = 0;
    while (true) {
      int lowest = kIdSentinel;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        lowest = min(lowest, lowest_block(improving_blocks(m[i], 0.5f, kNb)));
      if (!__syncthreads_or(lowest != kIdSentinel)) break;
      const int b = block_min(lowest, slot);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) retire_block(m[i], b);
      ++steps;
    }
    for (int idx = tid; idx < kRows * kOut; idx += blockDim.x) out[idx] = (float)steps;
  } else if constexpr (CASE == kQueuePush) {
    // Every column above the threshold is queued exactly once: each handed
    // over queue is counted into seen[row][column] (in buf) and emptied, and
    // what did not fit is pushed again.
    int* seen = reinterpret_cast<int*>(buf);                   // [kRows][kCols]
    int* qcnt = slot + 1;                                      // [kRows]
    float* q_s = reinterpret_cast<float*>(qcnt + kRows + 3);   // [kRows][kPushCap]
    int* q_i = reinterpret_cast<int*>(q_s + kRows * kPushCap);
    for (int idx = tid; idx < kRows * kCols; idx += blockDim.x) seen[idx] = 0;
    for (int r = tid; r < kRows; r += blockDim.x) qcnt[r] = 0;
    const int wc = warp % kPWC, wq = warp / kPWC, g = lane >> 2, t4 = lane & 3;
    const int r0 = wq * (kRows / 2) + 2 * t4;
    // The lane's fragment of the tile at col0 (read again for every round,
    // so that no register array lives across the rounds' barriers).
    auto push = [&](int col0, unsigned want) -> unsigned {
      float S[kPMT][kPNT][4];
#pragma unroll
      for (int mt = 0; mt < kPMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kPNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            S[mt][nt][j] = x[(r0 + nt * 8 + (j & 1)) * kCols + col0 + wc * kPSub + mt * 16 + g +
                             (j >> 1) * 8];
      return push_fragment<kPMT, kPNT>(S, want, r0, col0 + wc * kPSub + g, q_s, q_i, qcnt,
                                       kPushCap);
    };
#pragma unroll 1
    for (int col0 = 0; col0 < kCols; col0 += kOut) {
      unsigned want = 0;
#pragma unroll
      for (int mt = 0; mt < kPMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kPNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x[(r0 + nt * 8 + (j & 1)) * kCols + col0 + wc * kPSub + mt * 16 + g +
                  (j >> 1) * 8] > kPushAbove)
              want |= 1u << ((mt * kPNT + nt) * 4 + j);
      __syncthreads();
      unsigned left = push(col0, want);
      while (true) {
        const bool more = __syncthreads_or(left != 0);
        for (int r = warp; r < kRows; r += kWarps) {
          const int n = min(qcnt[r], kPushCap);
          if (lane < n) atomicAdd(seen + r * kCols + q_i[r * kPushCap + lane], 1);
        }
        __syncthreads();
        for (int r = tid; r < kRows; r += blockDim.x) qcnt[r] = 0;
        __syncthreads();
        if (!more) break;
        left = push(col0, left);
      }
    }
    for (int idx = tid; idx < kRows * kOut; idx += blockDim.x) {
      const int r = idx / kOut, c = idx - r * kOut;
      out[idx] = __int2float_rn(seen[r * kCols + c] + 2 * seen[r * kCols + c + kOut]);
    }
  } else if constexpr (CASE == kBitonicSort) {
    // Each row's 256 entries sorted; its best 64.
    for (int r = warp; r < kRows; r += kWarps) {
      float s[kCols / 32];
      int i[kCols / 32];
      load_row<kCols / 32>(x, r, 0, s, i);
      sort_slots<kCols / 32>(s, i);
      write_sorted(out, r, {s[0], s[1]}, {i[0], i[1]});
    }
  } else if constexpr (CASE == kBitonicMerge) {
    // The best 64 of the first half, sorted, as a list; the second half,
    // sorted, as a queue; the list becomes the best 64 of both.
    for (int r = warp; r < kRows; r += kWarps) {
      float ls[kSub / 32], qs[kSub / 32];
      int li[kSub / 32], qi[kSub / 32];
      load_row<kSub / 32>(x, r, 0, ls, li);
      load_row<kSub / 32>(x, r, kSub, qs, qi);
      sort_slots<kSub / 32>(ls, li);
      sort_slots<kSub / 32>(qs, qi);
      float l2[2] = {ls[0], ls[1]};
      int i2[2] = {li[0], li[1]};
      merge_sorted_into<2, kSub / 32>(l2, i2, qs, qi);
      write_sorted(out, r, l2, i2);
    }
  } else if constexpr (CASE == kBoundFilter) {
    // Pass 2 over the row's four quarters as chunks: each chunk's best
    // kPartK (sorted; -inf entries keep their columns) as partial lists
    // [chunk][row][kPartK], the bound, the survivors merged. Out: ids, then
    // scores of the best kPartK, the bound, the survivor count.
    float* part_s = buf;                                          // [kChunks][kRows][kPartK]
    int* part_i = reinterpret_cast<int*>(part_s + kChunks * kRows * kPartK);
    float* q_s = reinterpret_cast<float*>(part_i + kChunks * kRows * kPartK);  // [kWarps][128]
    int* q_i = reinterpret_cast<int*>(q_s + kWarps * 128);
    for (int r = warp; r < kRows; r += kWarps) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float s[kChunkCols / 32];
        int i[kChunkCols / 32];
        load_row<kChunkCols / 32>(x, r, c * kChunkCols, s, i);
        sort_slots<kChunkCols / 32>(s, i);
        if (lane < kPartK) {
          part_s[(c * kRows + r) * kPartK + lane] = s[0];
          part_i[(c * kRows + r) * kPartK + lane] = i[0];
        }
      }
      __syncwarp();
      const float b = chunk_bound(part_s, kChunks, kRows, r, kPartK, 0, 1);
      float ls[1] = {-CUDART_INF_F};
      int li[1] = {kIdSentinel};
      const int n = bound_merge<1, 4>(ls, li, part_s, part_i, kChunks, kRows, r, kPartK, 0, 1, b,
                                      q_s + warp * 128, q_i + warp * 128);
      for (int c = lane; c < kOut; c += 32) out[r * kOut + c] = 0.f;
      __syncwarp();
      if (lane < kPartK) {
        out[r * kOut + lane] = __int2float_rn(li[0]);
        out[r * kOut + kPartK + lane] = ls[0];
      }
      if (lane == 0) {
        out[r * kOut + 2 * kPartK] = b;
        out[r * kOut + 2 * kPartK + 1] = __int2float_rn(n);
      }
    }
  } else {  // kNestedInsert, kNestedWhile
#pragma unroll
    for (int b = 0; b < kNb; ++b) stage_block(buf, x, kCols, b, kRows, kSub);
    __syncthreads();
    float m[kRowsPerWarp];
    RowList<1> lists[kRowsPerWarp];  // each row's k = 10 list, in the owning warp's registers
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = gate(x, warp + kWarps * i);
      lists[i].init();
    }
    while (true) {
      // The lowest block whose gate beats some row's k-th score.
      int lowest = kIdSentinel;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float kth_s;
        int kth_i;
        lists[i].entry(kCaseK - 1, kth_s, kth_i);
        lowest = min(lowest, lowest_block(improving_blocks(m[i], kth_s, kNb)));
      }
      if (!__syncthreads_or(lowest != kIdSentinel)) break;
      const int b = block_min(lowest, slot);
      float v[kRowsPerWarp][kSub / 32];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float* row = block_row(buf, b, warp + kWarps * i, kRows, kSub);
#pragma unroll
        for (int j = 0; j < kSub / 32; ++j) v[i][j] = row[j * 32 + lane];
      }
      if constexpr (CASE == kNestedInsert) {
        // One insertion per row: the block's maximum and first arg-maximum.
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          float s;
          int id;
          block_successor<kSub / 32>(v[i], CUDART_INF_F, -1, s, id);
          lists[i].insert(s, id + b * kSub, kCaseK);
        }
      } else {
        // The block's walk: every row inserts its next candidate while any
        // row's candidate beats its k-th score.
        float cur_s[kRowsPerWarp];
        int cur_i[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          block_successor<kSub / 32>(v[i], CUDART_INF_F, -1, cur_s[i], cur_i[i]);
        while (true) {
          bool any = false;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            float kth_s;
            int kth_i;
            lists[i].entry(kCaseK - 1, kth_s, kth_i);
            any |= cur_s[i] > kth_s;
          }
          if (!__syncthreads_or(any)) break;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            lists[i].insert(cur_s[i], cur_i[i] + b * kSub, kCaseK);
            block_successor<kSub / 32>(v[i], cur_s[i], cur_i[i], cur_s[i], cur_i[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) retire_block(m[i], b);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float s0;
      int i0;
      lists[i].entry(0, s0, i0);
      fill_row(out, warp + kWarps * i, __fadd_rn(s0, __int2float_rn(i0)));
    }
  }
}

template <int CASE>
cudaError_t launch_case(const float* x, float* out, cudaStream_t stream) {
  // The tile's worth of floats (the staged blocks; the push case's column
  // counts; the bound case's partial lists), the push case's queues, and
  // the block's words.
  const size_t smem = sizeof(float) * kNb * kRows * kSub + 8 * kRows * kPushCap + 4 * (kRows + 4);
  auto kernel = merge_case_kernel<CASE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(x, out);
  return cudaGetLastError();
}

}  // namespace

// which: the case's index in ops/merge_cases.py CASES. x [64, 256] f32, out
// [64, 128] f32, both contiguous on the card. Returns the first CUDA error (0
// on success); nothing synchronises.
extern "C" int ragfin_merge_case(const float* x, float* out, int which, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (which) {
    case kSubmax: return (int)launch_case<kSubmax>(x, out, stream);
    case kAnyAxis0: return (int)launch_case<kAnyAxis0>(x, out, stream);
    case kScalarMin: return (int)launch_case<kScalarMin>(x, out, stream);
    case kLaneMinThenScalar: return (int)launch_case<kLaneMinThenScalar>(x, out, stream);
    case kBufload: return (int)launch_case<kBufload>(x, out, stream);
    case kRetire: return (int)launch_case<kRetire>(x, out, stream);
    case kWhileLoopM: return (int)launch_case<kWhileLoopM>(x, out, stream);
    case kNestedInsert: return (int)launch_case<kNestedInsert>(x, out, stream);
    case kNestedWhile: return (int)launch_case<kNestedWhile>(x, out, stream);
    case kQueuePush: return (int)launch_case<kQueuePush>(x, out, stream);
    case kBitonicSort: return (int)launch_case<kBitonicSort>(x, out, stream);
    case kBitonicMerge: return (int)launch_case<kBitonicMerge>(x, out, stream);
    case kBoundFilter: return (int)launch_case<kBoundFilter>(x, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
