// Pass 1 of the fused cosine top-k kernels over an f32 or bf16 corpus: score
// a block's query rows against a run of kTN-column tiles on the tensor cores
// and keep a running top-k per row with the two-level selection of
// twolevel.cuh. Shared by fused_topk.cu, which walks a contiguous chunk of
// the corpus, ivf_topk.cu, which walks the cell a probe table names
// (PROBED), and ceiling.cu, which keeps the walk, the copies and the product
// and puts a cheaper reduction in the selection's place (STAGE; part_s then
// holds one partial sum per chunk and row).
//
// Bound on an H100 at Q = 64, N = 1M, D = 384: the corpus read, 1.536 GB of
// f32 in 0.4585 ms at 3.35 TB/s (bf16: 0.2293 ms). The f32-accurate product
// is 3xTF32, 3 * 49.2 GFLOP in 0.30 ms at 495 TFLOP/s, under the bytes; a
// bf16 product is 0.05 ms at 989 TFLOP/s. So mma.sync is enough: the
// asynchronous wgmma and its 64-row tiles would buy compute this kernel does
// not lack, and the design puts its effort into keeping the copies in flight
// and the selection off the common path.
//
// Design. A block is 16 warps on one SM: eight producers and eight walkers.
//  - Product (producers). The corpus columns are the M side of mma.sync (16
//    per m-tile), the queries the N side (8 per n-tile), so Q <= 8 fills its
//    tiles. Producer warp w owns columns (w % WC) * SUBW .. + SUBW - 1 of a
//    tile and query rows (w / WC) * TQ / WQ .. of the block. f32 corpus:
//    m16n8k8 TF32 with both operands split into a head and a residual
//    (cvt.rna.tf32), summed as res*head + head*res + head*head in f32:
//    3xTF32, f32-accurate ("fast" over f32 is the exact tier, as the plain
//    version has it). bf16 corpus: m16n8k16 with f32 accumulation; queries
//    that are bf16 values (the fast tier rounds them) take one product, any
//    other query tile is split into three bf16 parts (head, middle, tail,
//    about 24 bits), so the "exact" tier is f32-accurate: the corpus values
//    are exact in bf16. The block decides which at run time from its
//    queries; a split of bf16 values has zero parts, so both give the same
//    sums. Every column's score is summed in the same order, so
//    bitwise-equal columns score bitwise equal.
//  - Copies (producers). A ring of kStages corpus slices (kDK rows of d by
//    kTN columns, 16 KB) in shared memory, filled by 16-byte cp.async.cg with
//    zero fill past the last column and past D, kStages - 1 slices ahead of
//    the product. Where the layout cannot be copied in aligned 16-byte
//    pieces (the corpus pointer, ld or the tile stride not a multiple of 16
//    bytes) the same slices are staged element by element. Shared-memory
//    rows are padded (corpus kTN + 8, queries Dp + 4 or + 8) so the fragment
//    loads hit 32 banks.
//  - Level 1 of the two-level selection (producers, twolevel.cuh). After a
//    tile's last slice each producer warp takes, from its accumulators, every
//    row's maximum over its SUBW columns (the sub-block maxima, a shuffle
//    over the eight lanes of a row) and compares it with the row's k-th
//    score; only a warp with an improving row writes its scores to the
//    shared score tile. The maxima and the tile go to the walkers through
//    one of two buffers (named barriers: full, empty), so the next tile's
//    product runs while the walkers select.
//  - Level 2 (walkers). Walker warp w keeps rows w, w + 8, ... in its
//    registers as sorted lists (RowList) and, per tile and row, walks the
//    sub-blocks whose maximum beats the row's k-th score, lowest first: their
//    candidates in successor order, each inserted while it beats the list's
//    last entry, then the block is retired and the next improving one
//    taken. The walkers publish each row's k-th score for the producers'
//    gate; a value a tile or two old is lower, so the gate only writes more.
//    Exactness of the strict > gates: a block walks its tiles in ascending
//    column order (a chunk, or a split of one probed cell), and a tile's
//    sub-blocks in ascending order, so every candidate's id is larger than
//    every id already in the list. A candidate whose score only ties the
//    k-th score therefore loses the tie, and a sub-block whose maximum does
//    not beat the k-th score (which only rises) holds nothing that enters.
//    The walk itself compares with better(), the pass-2 order.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "topk_common.cuh"
#include "twolevel.cuh"

namespace ragfin {

constexpr int kTS = kTN + 4;          // score-tile row stride (floats)
constexpr int kCS = kTN + 8;          // corpus slice row stride (elements)
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use
constexpr int kSinkWords = 512;       // dma-stage sink words per block (one per thread)

// Slice depth and mma depth per corpus type: a slice is 16 KB either way.
template <typename T>
struct Slice;
template <>
struct Slice<float> {
  static constexpr int kDK = 32, kKStep = 8, kQPad = 4;
};
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kDK = 64, kKStep = 16, kQPad = 8;
};

// A block is kProducers threads that copy and multiply (eight warps) and
// kWalkers that select (eight warps): one block per SM.
constexpr int kProducers = 256, kWalkers = 256, kPass1Threads = kProducers + kWalkers;
constexpr int kPWarps = kProducers / 32, kWWarps = kWalkers / 32;
// Named barriers (0 is __syncthreads): the producers' own, and a full and an
// empty barrier for each of the two score-tile buffers.
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 4;

// Producer layout of a TQ-row block: WC column groups of SUBW columns (the
// sub-blocks) times WQ query groups; RW rows per walker warp; kStages corpus
// slices in the ring (three at TQ = 64, where shared memory is tightest).
template <int TQ>
struct Layout {
  static constexpr int kStages = TQ == 64 ? 3 : 4;
  static constexpr int WC = TQ == 8 ? 8 : 4;
  static constexpr int WQ = kPWarps / WC;
  static constexpr int SUBW = kTN / WC;
  static constexpr int MT = SUBW / 16;
  static constexpr int NT = TQ / WQ / 8;
  static constexpr int RW = TQ / kWWarps;
  static_assert(MT >= 1 && NT >= 1 && WQ * WC == kPWarps && RW >= 1, "layout");
};

template <typename T>
__host__ __device__ constexpr int padded_depth(int D) {
  return (D + Slice<T>::kDK - 1) / Slice<T>::kDK * Slice<T>::kDK;
}

// Dynamic shared memory of one block (ops/topk.py _pass1_smem mirrors it):
// queries, the ring, two buffers of sub-block maxima and their columns, the
// ceiling sums, and for the selection two score tiles and the k-th scores.
template <typename T, int TQ, int STAGE>
__host__ __device__ constexpr size_t pass1_smem(int D) {
  return sizeof(float) * (size_t)TQ * (padded_depth<T>(D) + Slice<T>::kQPad) +
         sizeof(T) * (size_t)Layout<TQ>::kStages * Slice<T>::kDK * kCS +
         (size_t)2 * TQ * Layout<TQ>::WC * 8 + (size_t)TQ * 12 +
         (STAGE == kStageSelect ? sizeof(float) * (size_t)TQ * (2 * kTS + 1) : 0);
}

// --- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Head and residual of x, both TF32 (the residual of the rounded head).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16x16 bf16 A fragment from a [k][m] (m contiguous) slice: the transposed
// ldmatrix gives each lane the (m, k..k+1) pairs the fragment wants.
__device__ __forceinline__ void ldmatrix_a_trans(unsigned (&a)[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Three bf16 parts of the pair (x, y): head, middle and tail, each the
// round-to-nearest of what the parts before it left.
__device__ __forceinline__ void split_bf16x3(float x, float y, unsigned (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    p[i] = *reinterpret_cast<const unsigned*>(&v);
    x -= __low2float(v);
    y -= __high2float(v);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The dma stage folds what it staged: f32 words as they are, bf16 values
// widened to f32 words (ops/ceiling.py corpus_xor), zero fill adds nothing.
__device__ __forceinline__ unsigned fold_word(float w) { return __float_as_uint(w); }
__device__ __forceinline__ unsigned fold_word(unsigned w) {
  return (w << 16) ^ (w & 0xffff0000u);
}

// A walker warp's row lists move up one place (the first to the end):
// its row loop works on lists[0] only, so one copy of the walk's code runs
// every row while the lists stay in registers (a runtime index would put
// them in local memory, an unrolled loop would copy the code per row).
template <int N, int KS>
__device__ __forceinline__ void rotate(RowList<KS> (&lists)[N]) {
  const RowList<KS> first = lists[0];
#pragma unroll
  for (int j = 0; j + 1 < N; ++j) lists[j] = lists[j + 1];
  lists[N - 1] = first;
}

// --- the kernel --------------------------------------------------------------

template <typename T, int TQ, bool PROBED, int STAGE, int KS>
__global__ void __launch_bounds__(kPass1Threads, 1)
fused_topk_pass1(const float* __restrict__ q, int Q, int D, const T* __restrict__ ct,
                 long long ld, long long tile_stride, int bn, int n_phys, int limit, int k,
                 int tiles_per_chunk, ProbeWalk walk, CeilArgs ceil, float* __restrict__ part_s,
                 int* __restrict__ part_i) {
  using L = Layout<TQ>;
  constexpr int kStages = L::kStages;
  constexpr int kDK = Slice<T>::kDK, kKStep = Slice<T>::kKStep;
  constexpr int kEPC = 16 / sizeof(T);               // elements per 16-byte copy
  constexpr int kCPR = kTN / kEPC;                   // copies per slice row
  constexpr int kCopies = kDK * kCPR / kProducers;   // copies per producer per slice
  constexpr bool kSelect = STAGE == kStageSelect;
  // Stages whose tiles the walkers consume: the selection, and the two
  // ceiling stages that reduce the sub-block maxima per row.
  constexpr bool kWalk = kSelect || STAGE == kCeilRowmax || STAGE == kCeilPrologue;

  const int Dp = padded_depth<T>(D);
  const int QS = Dp + Slice<T>::kQPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                        // [TQ][QS]
  T* ring = reinterpret_cast<T*>(qs + (size_t)TQ * QS);              // [kStages][kDK][kCS]
  float* mx = reinterpret_cast<float*>(ring + kStages * kDK * kCS);  // [2][TQ][WC] sub-block maxima
  int* ax = reinterpret_cast<int*>(mx + 2 * TQ * L::WC);             // [2][TQ][WC] their columns
  float* csum = reinterpret_cast<float*>(ax + 2 * TQ * L::WC);       // [TQ] ceiling sums
  float* cbest = csum + TQ;                                          // [TQ]
  int* carg = reinterpret_cast<int*>(cbest + TQ);                    // [TQ]
  float* tile = reinterpret_cast<float*>(carg + TQ);                 // [2][TQ][kTS] (select)
  // Each row's k-th score, written by the walkers and read by the
  // producers' gate while they run: a value one or two tiles old is lower,
  // so the gate stays conservative.
  volatile float* kth = tile + 2 * TQ * kTS;                         // [TQ] (select)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ;
  const int rows = min(TQ, Q - q0);
  const int chunk = blockIdx.y;

  // Queries, zero past D and past the last row. For a bf16 corpus the block
  // notes whether any query value is not a bf16 value (then it splits).
  bool inexact = false;
  for (int idx = tid; idx < TQ * Dp; idx += kPass1Threads) {
    const int r = idx / Dp, d = idx - r * Dp;
    const float v = r < rows && d < D ? q[(long long)(q0 + r) * D + d] : 0.f;
    qs[r * QS + d] = v;
    if constexpr (!std::is_same<T, float>::value)
      inexact |= __bfloat162float(__float2bfloat16_rn(v)) != v;
  }
  for (int r = tid; r < TQ; r += kPass1Threads) {
    csum[r] = 0.f;
    cbest[r] = -CUDART_INF_F;
    carg[r] = 0;
    if constexpr (kSelect) kth[r] = -CUDART_INF_F;
  }
  const bool split = __syncthreads_or(inexact);

  const int n_tiles = (n_phys + kTN - 1) / kTN;
  const int t_begin = PROBED ? probed_tile(walk, q0, chunk, tiles_per_chunk)
                             : chunk * tiles_per_chunk;
  const int block_tiles = max(0, min(t_begin + tiles_per_chunk, n_tiles) - t_begin);

  if (tid < kProducers) {
    // ---------------- producers: copies, product, level 1 ----------------
    const int wc = warp % L::WC, wq = warp / L::WC;
    const int g = lane >> 2, t4 = lane & 3;
    const bool aligned = ld % kEPC == 0 && tile_stride % kEPC == 0 &&
                         reinterpret_cast<uintptr_t>(ct) % 16 == 0;
    const int n_slices = Dp / kDK;
    const int steps = block_tiles * n_slices;

    // Step s stages slice (s % n_slices) of tile t_begin + s / n_slices into
    // ring buffer s % kStages.
    auto issue = [&](int step) {
      const int t = t_begin + step / n_slices;
      const int d0 = (step % n_slices) * kDK;
      const int col0 = t * kTN;
      const long long base = tile_base(col0, tile_stride, bn);
      T* dst = ring + (step % kStages) * kDK * kCS;
#pragma unroll
      for (int it = 0; it < kCopies; ++it) {
        const int v = it * kProducers + tid;
        const int dd = v / kCPR, c = (v % kCPR) * kEPC;
        const int d = d0 + dd;
        const int valid = d < D ? max(0, min(kEPC, n_phys - col0 - c)) : 0;
        const T* src = valid > 0 ? ct + base + (long long)d * ld + c : ct;
        if (aligned) {
          cp_async16(dst + dd * kCS + c, src, valid * (int)sizeof(T));
        } else {
#pragma unroll
          for (int e = 0; e < kEPC; ++e) dst[dd * kCS + c + e] = e < valid ? src[e] : T(0.f);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) issue(s);
      else cp_async_commit();
    }

    if constexpr (STAGE == kCeilDma) {
      // Every staged word folded once, by the thread that copied it (so no
      // barrier: a thread reads and rewrites only its own pieces of the
      // ring); thread 0's first word of slice 0 is element (0, col0).
      unsigned sink = 0;
      float first_sum = 0.f;
      for (int step = 0; step < steps; ++step) {
        cp_async_wait<kStages - 2>();
        const T* buf = ring + (step % kStages) * kDK * kCS;
        const int t = t_begin + step / n_slices;
        if (tid == 0 && step % n_slices == 0 && t % ceil.block_tiles == 0)
          first_sum += to_float(buf[0]);
#pragma unroll
        for (int it = 0; it < kCopies; ++it) {
          const int v = it * kProducers + tid;
          const int dd = v / kCPR, c = (v % kCPR) * kEPC;
          const uint4 w = *reinterpret_cast<const uint4*>(buf + dd * kCS + c);
          if constexpr (std::is_same<T, float>::value)
            sink ^= fold_word(__uint_as_float(w.x)) ^ fold_word(__uint_as_float(w.y)) ^
                    fold_word(__uint_as_float(w.z)) ^ fold_word(__uint_as_float(w.w));
          else
            sink ^= fold_word(w.x) ^ fold_word(w.y) ^ fold_word(w.z) ^ fold_word(w.w);
        }
        if (step + kStages - 1 < steps) issue(step + kStages - 1);
        else cp_async_commit();
      }
      cp_async_wait<0>();
      if (ceil.sink != nullptr)
        ceil.sink[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kSinkWords + tid] = sink;
      if (tid == 0) csum[0] = first_sum;
    } else {
      float acc[L::MT][L::NT][4];
      const int cw = wc * L::SUBW;                          // the warp's first column
      const int r0 = wq * (TQ / L::WQ) + 2 * t4;            // row of acc[*][0][0]
      const float* qw = qs + (wq * (TQ / L::WQ) + g) * QS;  // row g of the warp's queries
      for (int step = 0; step < steps; ++step) {
        const int slice = step % n_slices;
        const int d0 = slice * kDK;
        if (slice == 0) {
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
        }
        cp_async_wait<kStages - 2>();
        bar_sync(kBarProducers, kProducers);  // slice `step` landed; slice step - 1 is read
        if (step + kStages - 1 < steps) issue(step + kStages - 1);
        else cp_async_commit();

        const T* cs = ring + (step % kStages) * kDK * kCS;
#pragma unroll
        for (int k0 = 0; k0 < kDK; k0 += kKStep) {
          if constexpr (std::is_same<T, float>::value) {
            unsigned ah[L::MT][4], al[L::MT][4];
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt) {
              const float* a = cs + (k0 + t4) * kCS + cw + mt * 16 + g;
              split_tf32(a[0], ah[mt][0], al[mt][0]);
              split_tf32(a[8], ah[mt][1], al[mt][1]);
              split_tf32(a[4 * kCS], ah[mt][2], al[mt][2]);
              split_tf32(a[4 * kCS + 8], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt) {
              const float* b = qw + nt * 8 * QS + d0 + k0 + t4;
              unsigned bh0, bl0, bh1, bl1;
              split_tf32(b[0], bh0, bl0);
              split_tf32(b[4], bh1, bl1);
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt) {
                mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
                mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
                mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
              }
            }
          } else {
            unsigned a[L::MT][4];
            const int row = lane & 7, mat = lane >> 3;
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt)
              ldmatrix_a_trans(a[mt], cs + (k0 + (mat >> 1) * 8 + row) * kCS + cw + mt * 16 +
                                          (mat & 1) * 8);
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt) {
              const float* b = qw + nt * 8 * QS + d0 + k0 + 2 * t4;
              const float2 lo = *reinterpret_cast<const float2*>(b);
              const float2 hi = *reinterpret_cast<const float2*>(b + 8);
              if (split) {
                unsigned p0[3], p1[3];
                split_bf16x3(lo.x, lo.y, p0);
                split_bf16x3(hi.x, hi.y, p1);
#pragma unroll
                for (int mt = 0; mt < L::MT; ++mt) {
                  mma_bf16(acc[mt][nt], a[mt], p0[2], p1[2]);
                  mma_bf16(acc[mt][nt], a[mt], p0[1], p1[1]);
                  mma_bf16(acc[mt][nt], a[mt], p0[0], p1[0]);
                }
              } else {
                const unsigned b0 = pack_bf16(lo.x, lo.y), b1 = pack_bf16(hi.x, hi.y);
#pragma unroll
                for (int mt = 0; mt < L::MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
              }
            }
          }
        }
        if (slice != n_slices - 1) continue;

        // The tile is scored. Lane (g, t4) holds columns cw + mt * 16 + g + 8h
        // (h = 0, 1) of rows r0 + nt * 8 + j (j = 0, 1): acc[mt][nt][2h + j].
        const int tl = step / n_slices;  // the tile's place in the block's walk
        const int col0 = (t_begin + tl) * kTN;
        if constexpr (STAGE == kCeilMm || STAGE == kCeilMask) {
          // Column 0 of the probe tile: lane g = 0 of column group 0, h = 0.
          if (wc == 0 && g == 0 && (col0 / kTN) % ceil.block_tiles == 0) {
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int r = r0 + nt * 8 + j;
                const float v =
                    STAGE == kCeilMask && col0 >= limit ? -CUDART_INF_F : acc[0][nt][j];
                if (r < rows) csum[r] += v;
              }
          }
          continue;
        }
        if (col0 + kTN > limit) {
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (col0 + cw + g + mt * 16 + (j >> 1) * 8 >= limit) acc[mt][nt][j] = -CUDART_INF_F;
        }
        // Level 1: each row's maximum over the warp's SUBW columns (and, for
        // the prologue, its lowest column), in every lane of the row's group.
        float m[L::NT][2];
        int am[L::NT][2];
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = -CUDART_INF_F;
            int a = kIdSentinel;
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if constexpr (STAGE == kCeilPrologue) {
                  const int c = cw + mt * 16 + g + 8 * h;  // lowest column on a tie
                  if (better(acc[mt][nt][2 * h + j], c, v, a)) {
                    v = acc[mt][nt][2 * h + j];
                    a = c;
                  }
                } else {
                  v = fmaxf(v, acc[mt][nt][2 * h + j]);
                }
              }
            if constexpr (STAGE == kCeilPrologue) lanes_best<4>(v, a);
            else v = lanes_max<4>(v);
            m[nt][j] = v;
            am[nt][j] = a;
          }
        // Hand the tile to the walkers through buffer tl % 2, once they have
        // released it (tile tl - 2).
        const int buf = tl & 1;
        if (tl >= 2) bar_sync(kBarEmpty + buf, kPass1Threads);
        float* mxb = mx + buf * TQ * L::WC;
        if constexpr (kSelect) {
          // The gate: a warp writes its scores only if one of its rows
          // improves on this tile.
          bool hit = false;
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = r0 + nt * 8 + j;
              hit |= r < rows && m[nt][j] > kth[r];
            }
          if (__any_sync(kFull, hit)) {
            float* tb = tile + buf * TQ * kTS;
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  tb[(r0 + nt * 8 + (j & 1)) * kTS + cw + mt * 16 + g + (j >> 1) * 8] =
                      acc[mt][nt][j];
          }
        }
        if (g == 0) {
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mxb[(r0 + nt * 8 + j) * L::WC + wc] = m[nt][j];
              if constexpr (STAGE == kCeilPrologue)
                ax[buf * TQ * L::WC + (r0 + nt * 8 + j) * L::WC + wc] = am[nt][j];
            }
        }
        bar_arrive(kBarFull + buf, kPass1Threads);
      }
      cp_async_wait<0>();
    }
  } else if constexpr (kWalk) {
    // ---------------- walkers: level 2 ----------------
    // Walker warp w takes rows w, w + kWWarps, ...; for the selection their
    // running top-k lists live in its registers.
    const int ww = warp - kPWarps;
    RowList<KS> lists[kSelect ? L::RW : 1];
#pragma unroll
    for (int i = 0; i < (kSelect ? L::RW : 1); ++i) lists[i].init();
    for (int tl = 0; tl < block_tiles; ++tl) {
      const int buf = tl & 1;
      const int col0 = (t_begin + tl) * kTN;
      const float* mxb = mx + buf * TQ * L::WC;
      bar_sync(kBarFull + buf, kPass1Threads);
      if constexpr (kSelect) {
        const float* tb = tile + buf * TQ * kTS;
#pragma unroll 1
        for (int i = 0; i < L::RW; ++i, rotate(lists)) {
          const int r = ww + kWWarps * i;  // lists[0] is row r's
          if (r >= rows) continue;
          float mb = lane < L::WC ? mxb[r * L::WC + lane] : -CUDART_INF_F;
          float ks;
          int ki;
          lists[0].entry(k - 1, ks, ki);
          unsigned hits = improving_blocks(mb, ks, L::WC);
          if (!hits) continue;
          while (hits) {
            const int b = lowest_block(hits);
            const float v = lane < L::SUBW ? tb[r * kTS + b * L::SUBW + lane] : -CUDART_INF_F;
            walk_block<KS>(lists[0], k, v, col0 + b * L::SUBW, ks, ki);
            retire_block(mb, b);
            hits = improving_blocks(mb, ks, L::WC);
          }
          if (lane == 0) kth[r] = ks;
        }
      } else {
        // kCeilRowmax / kCeilPrologue: the row's maximum (and lowest
        // arg-max) over the tile, then over the probe tile.
        const int sub = (col0 / kTN) % ceil.block_tiles;
        const bool first = sub == 0;
        const bool last = sub == ceil.block_tiles - 1 || col0 + kTN >= n_phys;
        for (int r = ww; r < rows; r += kWWarps) {
          float v = lane < L::WC ? mxb[r * L::WC + lane] : -CUDART_INF_F;
          int a = STAGE == kCeilPrologue && lane < L::WC ? ax[buf * TQ * L::WC + r * L::WC + lane]
                                                          : kIdSentinel;
          lanes_best<1>(v, a);
          if (lane == 0) {
            // Tiles arrive in ascending column order: strict > keeps the
            // lowest column of the probe tile on a tie.
            if (first || v > cbest[r]) {
              cbest[r] = v;
              carg[r] = sub * kTN + a;
            }
            if (last) {
              csum[r] += cbest[r];
              if constexpr (STAGE == kCeilPrologue) csum[r] += (float)carg[r];
            }
          }
        }
      }
      // Release the buffer unless no producer waits for it any more.
      if (tl + 2 < block_tiles) bar_arrive(kBarEmpty + buf, kPass1Threads);
    }
    if constexpr (kSelect) {
#pragma unroll 1
      for (int i = 0; i < L::RW; ++i, rotate(lists)) {
        const int r = ww + kWWarps * i;
        if (r >= rows) continue;
        const long long o = ((long long)chunk * Q + q0 + r) * k;
        lists[0].store(part_s + o, part_i + o, k);
      }
    }
  }
  if constexpr (!kSelect) {
    __syncthreads();
    for (int r = tid; r < rows; r += kPass1Threads)
      part_s[(long long)chunk * Q + q0 + r] = STAGE == kCeilDma ? csum[0] : csum[r];
  }
}

// KS: list slots per lane, k <= 32 * KS (the wrappers take 2 for k <= 64, else 4).
template <typename T, int TQ, bool PROBED = false, int STAGE = kStageSelect, int KS = 2>
cudaError_t launch_pass1(const float* q, int Q, int D, const void* ct, long long ld,
                         long long tile_stride, int bn, int n_phys, int limit, int k,
                         int tiles_per_chunk, int n_chunks, float* part_s, int* part_i,
                         cudaStream_t stream, ProbeWalk walk = ProbeWalk{},
                         CeilArgs ceil = CeilArgs{}) {
  const size_t smem = pass1_smem<T, TQ, STAGE>(D);
  if (smem > (size_t)kSmemLimit || k > 32 * KS) return cudaErrorInvalidValue;
  auto kernel = fused_topk_pass1<T, TQ, PROBED, STAGE, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + TQ - 1) / TQ, n_chunks);
  kernel<<<grid, kPass1Threads, smem, stream>>>(q, Q, D, static_cast<const T*>(ct), ld, tile_stride,
                                           bn, n_phys, limit, k, tiles_per_chunk, walk, ceil,
                                           part_s, part_i);
  return cudaGetLastError();
}

}  // namespace ragfin
