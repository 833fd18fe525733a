// The primitives of the two-level in-tile selection, one kernel per case, for
// sm_90a.
//
// Replaces scripts/mosaic_bisect.py:_run (the pallas_call of the nine Mosaic
// bisect cases). Same function as each case: one [64, 256] f32 tile in, two
// sub-blocks of 128 columns, a [64, 128] f32 result (ops/merge_cases.py says
// what each case computes). On the TPU the cases asked whether Mosaic could
// lower each operation of ragfin_tpu/ops/topk.py:_merge_tile_twolevel; here
// they run the device functions of twolevel.cuh that pass 1 of the fused and
// pruned kernels selects with, so each is a unit test of that selection on
// the card, bit for bit against its plain version.
//
// Bound on an H100: 64 KB in, 32 KB out, about 30 ns of memory; one block,
// so a launch's few microseconds are the whole time. No request path runs
// these kernels.
//
// Design: one block of eight warps; warp w owns rows w, w + 8, ... A
// reduction over rows (any, min) is a block barrier (__syncthreads_or, or an
// atomicMin in shared memory between two barriers); everything per row is
// the warp's, as in pass 1.
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
};

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
__global__ void __launch_bounds__(kThreads) merge_case_kernel(const float* __restrict__ x,
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
  const size_t smem = sizeof(float) * kNb * kRows * kSub + 16;
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
    default: return (int)cudaErrorInvalidValue;
  }
}
