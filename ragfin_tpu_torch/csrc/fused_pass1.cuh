// Pass 1 of the fused cosine top-k kernels over an f32, bf16 or int8 corpus:
// score a block's query rows against a run of kTN-column tiles on the tensor
// cores and keep a running top-k per row: a gate in registers, candidate
// queues in shared memory, drained in batches by bitonic sorts and merges
// (queue_select.cuh). Shared by fused_topk.cu and fused_topk_int8.cu, which
// walk a contiguous chunk of the corpus, ivf_topk.cu, which walks the cell a
// probe table names (PROBED), and ceiling.cu, which keeps the walk, the
// copies and the product and puts a cheaper reduction in the selection's
// place (STAGE; part_s, or part_i for the sums that stay integers, then
// holds one partial sum per chunk and row).
//
// Bound on an H100 at Q = 64, N = 1M, D = 384: the corpus read, 1.536 GB of
// f32 in 0.4585 ms at 3.35 TB/s (bf16: 0.2293 ms; int8 with its column
// scales: 0.388 GB, 0.116 ms). The f32-accurate product is 3xTF32, 3 * 49.2
// GFLOP in 0.30 ms at 495 TFLOP/s, under the bytes; a bf16 product is 0.05
// ms at 989 TFLOP/s, the int8 one 0.025 ms at 1,979 TOP/s (at Q = 1024 the
// int8 product is 0.40 ms, over its 0.12 ms read). So mma.sync is enough: the
// asynchronous wgmma and its 64-row tiles would buy compute this kernel does
// not lack at the batch sizes it serves, and the design puts its effort into
// keeping the copies in flight and the selection off the common path.
//
// Design. A block is 16 warps on one SM: eight producers and eight drainers.
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
//    bitwise-equal columns score bitwise equal. int8 corpus (int8 queries):
//    m16n8k32 s8 x s8 -> s32, exact in any order, then int -> f32 times the
//    column scale (times the row scale first, PROBED, the TPU pruned
//    kernel's order), so the scores equal the plain versions' bit for bit.
//  - The int8 operands' k order. mma wants 4 consecutive k of one column in
//    one 32-bit register, and the corpus is [D, N]: column-contiguous. Of
//    the two places the byte transpose can go (prmt of the landed words
//    straight into the A registers, or a transposing pass into a second
//    buffer), this kernel takes the second: each producer copies, and then
//    transposes, the same 4 rows d = p, p + 32, p + 64, p + 96 (p its lane)
//    of 16 columns, so no barrier sits between the landing and the
//    transpose; it writes one word per column (8 prmt per 4 columns) to a
//    k-packed [kTN][kTBS] buffer (two of them, so one barrier per slice
//    covers both the transpose and the reuse), which ldmatrix (b16, not
//    transposed) reads as the A fragment. The k order inside a slice is
//    then (w, i) -> d = w + 32 i; the block stores its queries in the same
//    order, so each product pairs the same d. The first design would have
//    needed each lane's four words to come from rows 4 t4 .. 4 t4 + 3 of its
//    own two columns: 16 byte loads, or shuffles, per fragment.
//  - Copies (producers). A ring of kStages corpus slices (kDK rows of d by
//    kTN columns, 16 KB) in shared memory, filled by 16-byte cp.async.cg with
//    zero fill past the last column and past D, kStages - 1 slices ahead of
//    the product. Where the layout cannot be copied in aligned 16-byte
//    pieces (the corpus pointer, ld or the tile stride not a multiple of 16
//    bytes) the same slices are staged element by element. Shared-memory
//    rows are padded (corpus kTN + 8, int8 kTN + 16; queries Dp + 4, + 8 or,
//    int8, + 16 bytes; the k-packed buffer 32 + 4 words) so the fragment
//    loads and the transpose's stores hit 32 banks.
//  - The gate (producers). After a tile's last slice each producer lane
//    compares its accumulators with a register copy of its rows' k-th
//    scores, read from shared memory on every tile; __any_sync skips the
//    rest when no lane of the warp has a candidate, so a tile that improves
//    no row costs the comparisons and nothing else: no maxima, no barrier.
//  - The queues (producers). A lane appends its candidates, (score, column),
//    to its rows' queues in shared memory (kQCap entries a row, one
//    atomicAdd per row and lane for the slots). Candidates that do not fit
//    stay in the lane's registers (a mask over its fragment). At the next
//    producer barrier (every slice already has one) the producers see
//    whether any did not fit; then they hand the queue buffer to the
//    drainers (named barrier kBarFull + b), take the other buffer (waiting on
//    kBarEmpty + b' for its drain to end) and push what is left: a producer
//    may stall on a drain, no candidate is dropped. At the end of the chunk
//    the last buffer is handed over, marked final.
//  - The drains (drainers). Drainer warp w keeps rows w, w + 8, ... in its
//    registers as sorted lists (RowList) and, per handed-over buffer and
//    row, bitonic-sorts the queue in better() order and merges it with the
//    list (queue_select.cuh drain_queue), then publishes the row's k-th
//    score for the producers' gate.
//    Exactness of the strict > gate: a block walks its tiles in ascending
//    column order (a chunk, or a split of one probed cell), so every
//    candidate's id is larger than every id in the drained list. A value
//    that only ties the list's k-th score therefore loses the tie to k
//    entries and cannot enter; a published k-th score is a drained list's,
//    and only rises, so a stale one is lower and the gate only lets more
//    through; -inf never passes. The sort orders ties by id whatever order
//    the queue holds them in.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "queue_select.cuh"
#include "topk_common.cuh"
#include "twolevel.cuh"

namespace ragfin {

constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use
constexpr int kSinkWords = 512;       // dma-stage sink words per block (one per thread)
constexpr int kIntMask = -2147483647; // the int stages' mask value, -(2^31) + 1

// Slice depth, mma depth, query row padding (query elements) and corpus row
// stride (corpus elements) per corpus type: a slice is 16 KB each time.
template <typename T>
struct Slice;
template <>
struct Slice<float> {
  static constexpr int kDK = 32, kKStep = 8, kQPad = 4, kCS = kTN + 8;
};
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kDK = 64, kKStep = 16, kQPad = 8, kCS = kTN + 8;
};
template <>
struct Slice<int8_t> {
  static constexpr int kDK = 128, kKStep = 32, kQPad = 16, kCS = kTN + 16;
};
// Row stride, in 32-bit words, of the int8 k-packed buffer: a column's kDK
// bytes and 4 words of padding.
constexpr int kTBS = Slice<int8_t>::kDK / 4 + 4;

template <typename T>
constexpr bool kIsInt8 = std::is_same<T, int8_t>::value;
// Queries in shared memory: int8 over an int8 corpus, else f32.
template <typename T>
using QElem = std::conditional_t<kIsInt8<T>, int8_t, float>;

// A block is kProducers threads that copy, multiply and gate (eight warps)
// and kDrainers that keep the lists (eight warps): one block per SM.
constexpr int kProducers = 256, kDrainers = 256, kPass1Threads = kProducers + kDrainers;
constexpr int kPWarps = kProducers / 32, kDWarps = kDrainers / 32;
// Named barriers (0 is __syncthreads): the producers' own, and a full and an
// empty barrier for each of the two queue buffers.
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 4;
// Queue entries a row holds per buffer (two slots of a warp array).
constexpr int kQCap = 64;

// Producer layout of a TQ-row block: WC column groups of SUBW columns times
// WQ query groups; RW rows per drainer warp; kStages corpus slices in the
// ring (three at TQ = 64, where shared memory is tightest).
template <int TQ>
struct Layout {
  static constexpr int kStages = TQ == 64 ? 3 : 4;
  static constexpr int WC = TQ == 8 ? 8 : 4;
  static constexpr int WQ = kPWarps / WC;
  static constexpr int SUBW = kTN / WC;
  static constexpr int MT = SUBW / 16;
  static constexpr int NT = TQ / WQ / 8;
  static constexpr int RW = TQ / kDWarps;
  static_assert(MT >= 1 && NT >= 1 && WQ * WC == kPWarps && RW >= 1, "layout");
};

template <typename T>
__host__ __device__ constexpr int padded_depth(int D) {
  return (D + Slice<T>::kDK - 1) / Slice<T>::kDK * Slice<T>::kDK;
}

// Dynamic shared memory of one block (ops/topk.py _pass1_smem mirrors it):
// queries, the ring, for int8 two k-packed buffers, the ceiling sums, and
// for the selection two queue buffers with their counts, the k-th scores and
// four control words, for the ceiling stages two buffers of per-warp row
// maxima and their columns.
template <typename T, int TQ, int STAGE>
__host__ __device__ constexpr size_t pass1_smem(int D) {
  return sizeof(QElem<T>) * (size_t)TQ * (padded_depth<T>(D) + Slice<T>::kQPad) +
         sizeof(T) * (size_t)Layout<TQ>::kStages * Slice<T>::kDK * Slice<T>::kCS +
         (kIsInt8<T> ? sizeof(unsigned) * 2 * kTN * kTBS : 0) + (size_t)TQ * 12 +
         (STAGE == kStageSelect ? (size_t)TQ * (2 * kQCap * 8 + 2 * 4 + 4) + 16
                                : (size_t)2 * TQ * Layout<TQ>::WC * 8);
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16x32 s8 A fragment from a k-packed [m][k] buffer (k contiguous): the
// four 8x8 b16 matrices at rows m 0-7 / 8-15 and bytes k 0-15 / 16-31 are
// the fragment's four registers, untransposed.
__device__ __forceinline__ void ldmatrix_a(unsigned (&a)[4], const unsigned* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// 4x4 byte transpose: w0..w3 hold four columns of rows 0..3; the word of
// column j (bytes: rows 0..3 of it) goes to dst[j * kTBS].
__device__ __forceinline__ void transpose_store(unsigned w0, unsigned w1, unsigned w2,
                                                unsigned w3, unsigned* dst) {
  const unsigned lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const unsigned lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  dst[0] = __byte_perm(lo01, lo23, 0x5410);
  dst[kTBS] = __byte_perm(lo01, lo23, 0x7632);
  dst[2 * kTBS] = __byte_perm(hi01, hi23, 0x5410);
  dst[3 * kTBS] = __byte_perm(hi01, hi23, 0x7632);
}

// The int stages' row maximum over the lanes that differ in bits FROM..16.
template <int FROM>
__device__ __forceinline__ int lanes_max_int(int v) {
#pragma unroll
  for (int off = 16; off >= FROM; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Producer `tid`'s copy `it` of a slice: row dd, kEPC columns from c. int8:
// rows lane, lane + 32, lane + 64, lane + 96 of the warp's 16 columns, so
// the copying thread holds what its transpose needs and a warp's 32 rows
// fall on 32 banks (row stride kCS = 144 bytes); f32/bf16: consecutive
// threads along a row.
template <typename T>
__device__ __forceinline__ void piece(int it, int tid, int& dd, int& c) {
  constexpr int kEPC = 16 / sizeof(T), kCPR = kTN / kEPC;
  if constexpr (kIsInt8<T>) {
    dd = (tid & 31) + 32 * it;
    c = (tid >> 5) * kEPC;
  } else {
    const int v = it * kProducers + tid;
    dd = v / kCPR;
    c = (v % kCPR) * kEPC;
  }
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
// widened to f32 words, int8 words (four consecutive columns of a row) as
// they are (ops/ceiling.py corpus_xor); zero fill adds nothing.
template <typename T>
__device__ __forceinline__ unsigned fold_word(unsigned w) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return (w << 16) ^ (w & 0xffff0000u);
  else return w;
}

// A drainer warp's row lists move up one place (the first to the end):
// its row loop works on lists[0] only, so one copy of the drain's code runs
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

// q: f32 [Q, D], or int8 [Q, D] over an int8 corpus; cscale: the int8
// corpus's column scales, one per physical column; qscale: the int8 query
// row scales, read only where PROBED (the fused route applies them in the
// merge). Both null for f32/bf16.
template <typename T, int TQ, bool PROBED, int STAGE, int KS>
__global__ void __launch_bounds__(kPass1Threads, 1)
fused_topk_pass1(const void* __restrict__ q, int Q, int D, const T* __restrict__ ct,
                 const float* __restrict__ cscale, const float* __restrict__ qscale,
                 long long ld, long long tile_stride, int bn, int n_phys, int limit, int k,
                 int tiles_per_chunk, ProbeWalk walk, CeilArgs ceil, float* __restrict__ part_s,
                 int* __restrict__ part_i, bool round_q) {
  using L = Layout<TQ>;
  using QT = QElem<T>;
  constexpr bool kInt8 = kIsInt8<T>;
  constexpr int kStages = L::kStages;
  constexpr int kDK = Slice<T>::kDK, kKStep = Slice<T>::kKStep, kCS = Slice<T>::kCS;
  constexpr int kEPC = 16 / sizeof(T);               // elements per 16-byte copy
  constexpr int kCPR = kTN / kEPC;                   // copies per slice row
  constexpr int kCopies = kDK * kCPR / kProducers;   // copies per producer per slice
  constexpr bool kSelect = STAGE == kStageSelect;
  // Ceiling stages that reduce each row over a probe tile: every producer
  // lane keeps its rows' best in registers across the probe tile, as the
  // gate keeps its thresholds, and the warps combine once per probe tile.
  constexpr bool kRowBest =
      STAGE == kCeilRowmax || STAGE == kCeilPrologue || STAGE == kCeilRowmaxInt;
  // Ceiling sums kept in int32 (wrapping), written to part_i: the int
  // stages, and the int8 dma stage.
  constexpr bool kIntSum =
      kInt8 && (STAGE == kCeilDma || STAGE == kCeilMmInt || STAGE == kCeilRowmaxInt);
  static_assert(kInt8 || (STAGE != kCeilMmInt && STAGE != kCeilRowmaxInt), "int stage");

  const int Dp = padded_depth<T>(D);
  const int QS = Dp + Slice<T>::kQPad;
  extern __shared__ __align__(16) unsigned char smem[];
  QT* qs = reinterpret_cast<QT*>(smem);                              // [TQ][QS]
  T* ring = reinterpret_cast<T*>(qs + (size_t)TQ * QS);              // [kStages][kDK][kCS]
  unsigned* kp = reinterpret_cast<unsigned*>(ring + kStages * kDK * kCS);  // int8: [2][kTN][kTBS]
  float* csum = reinterpret_cast<float*>(kp + (kInt8 ? 2 * kTN * kTBS : 0));  // [TQ] ceiling sums
  int* csum_i = reinterpret_cast<int*>(csum);                        // the int sums' view
  unsigned char* rest = reinterpret_cast<unsigned char*>(csum + 3 * TQ);
  // Ceiling stages: [2][TQ][WC] per-warp row maxima and their columns.
  float* mx = reinterpret_cast<float*>(rest);
  int* ax = reinterpret_cast<int*>(mx + 2 * TQ * L::WC);
  // Selection: two queue buffers [2][TQ][kQCap] of scores and columns, their
  // counts [2][TQ], each row's k-th score [TQ], published by the drainers and
  // read by the producers' gate, and the control words: the overflow tags of
  // the two latest push rounds and the final handoff's number plus one.
  float* qbuf_s = reinterpret_cast<float*>(rest);
  int* qbuf_i = reinterpret_cast<int*>(qbuf_s + 2 * TQ * kQCap);
  int* qcnt = qbuf_i + 2 * TQ * kQCap;
  volatile float* kth = reinterpret_cast<volatile float*>(qcnt + 2 * TQ);
  volatile int* ovf = reinterpret_cast<volatile int*>(kth + TQ);  // [2]
  volatile int* final_flag = ovf + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ;
  const int rows = min(TQ, Q - q0);
  const int chunk = blockIdx.y;

  // Queries, zero past D and past the last row; with round_q (the fast tier
  // over a bf16 corpus) each rounded to the nearest bf16 value, as the plain
  // version rounds them. For a bf16 corpus the block notes whether any query
  // value is not a bf16 value (then it splits). The int8 queries are stored
  // in the corpus fragments' k order: position s * kDK + 4 w + i holds
  // d = s * kDK + w + 32 i.
  bool inexact = false;
  for (int idx = tid; idx < TQ * Dp; idx += kPass1Threads) {
    const int r = idx / Dp, dq = idx - r * Dp;
    if constexpr (kInt8) {
      const int within = dq & (kDK - 1);
      const int d = dq - within + (within >> 2) + 32 * (within & 3);
      qs[r * QS + dq] = r < rows && d < D
                            ? static_cast<const int8_t*>(q)[(long long)(q0 + r) * D + d]
                            : (int8_t)0;
    } else {
      float v = r < rows && dq < D ? static_cast<const float*>(q)[(long long)(q0 + r) * D + dq]
                                   : 0.f;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (round_q) v = __bfloat162float(__float2bfloat16_rn(v));
        inexact |= __bfloat162float(__float2bfloat16_rn(v)) != v;
      }
      qs[r * QS + dq] = v;
    }
  }
  for (int r = tid; r < TQ; r += kPass1Threads) {
    csum[r] = 0.f;
    if constexpr (kSelect) {
      kth[r] = -CUDART_INF_F;
      qcnt[r] = 0;
      qcnt[TQ + r] = 0;
    }
  }
  if constexpr (kSelect) {
    if (tid == 0) {
      ovf[0] = ovf[1] = -1;
      *final_flag = 0;
    }
  }
  const bool split = __syncthreads_or(inexact);

  const int n_tiles = (n_phys + kTN - 1) / kTN;
  const int t_begin = PROBED ? probed_tile(walk, q0, chunk, tiles_per_chunk)
                             : chunk * tiles_per_chunk;
  const int block_tiles = max(0, min(t_begin + tiles_per_chunk, n_tiles) - t_begin);

  if (tid < kProducers) {
    // ---------------- producers: copies, product, gate, queues ----------------
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
        int dd, c;
        piece<T>(it, tid, dd, c);
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
      int first_int = 0;
      for (int step = 0; step < steps; ++step) {
        cp_async_wait<kStages - 2>();
        const T* buf = ring + (step % kStages) * kDK * kCS;
        const int t = t_begin + step / n_slices;
        if (tid == 0 && step % n_slices == 0 && t % ceil.block_tiles == 0) {
          if constexpr (kInt8) first_int = wrap_add(first_int, (int)buf[0]);
          else first_sum += to_float(buf[0]);
        }
#pragma unroll
        for (int it = 0; it < kCopies; ++it) {
          int dd, c;
          piece<T>(it, tid, dd, c);
          const uint4 w = *reinterpret_cast<const uint4*>(buf + dd * kCS + c);
          sink ^= fold_word<T>(w.x) ^ fold_word<T>(w.y) ^ fold_word<T>(w.z) ^ fold_word<T>(w.w);
        }
        if (step + kStages - 1 < steps) issue(step + kStages - 1);
        else cp_async_commit();
      }
      cp_async_wait<0>();
      if (ceil.sink != nullptr)
        ceil.sink[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kSinkWords + tid] = sink;
      if (tid == 0) {
        if constexpr (kInt8) csum_i[0] = first_int;
        else csum[0] = first_sum;
      }
    } else {
      using Acc = std::conditional_t<kInt8, int, float>;
      Acc acc[L::MT][L::NT][4];
      float fs[L::MT][L::NT][4];  // int8: the dequantised tile
      const int cw = wc * L::SUBW;                          // the warp's first column
      const int r0 = wq * (TQ / L::WQ) + 2 * t4;            // row of acc[*][0][0]
      const QT* qw = qs + (wq * (TQ / L::WQ) + g) * QS;     // row g of the warp's queries

      // The float scores S of the tile just scored: the accumulators, or for
      // int8 the dequantised tile (written at the tile's end).
      auto scores = [&]() -> float (&)[L::MT][L::NT][4] {
        if constexpr (kInt8) return fs;
        else return acc;
      };

      // Selection state, uniform over the producers: the queue buffer being
      // filled (handoffs & 1), the handoffs so far and the push round; per
      // lane, the candidates of the last scored tile not yet queued, and the
      // first column of that tile.
      int handoffs = 0, round = 0;
      unsigned left = 0;
      int left_col0 = 0;
      // One push round: `want` of the tile at col0 into the current buffer;
      // a lane with candidates that did not fit tags the round.
      auto push = [&](unsigned want, int col0) -> unsigned {
        ++round;
        unsigned rest_bits = 0;
        if (__any_sync(kFull, want != 0)) {
          const int b = handoffs & 1;
          rest_bits = push_fragment<L::MT, L::NT>(scores(), want, r0, col0 + cw + g,
                                                   qbuf_s + b * TQ * kQCap,
                                                   qbuf_i + b * TQ * kQCap, qcnt + b * TQ, kQCap);
          if (rest_bits) ovf[round & 1] = round;
        }
        return rest_bits;
      };
      // Hand the current buffer to the drainers and take the other one, once
      // its drain (handoff - 1) has ended.
      auto hand_over = [&]() {
        bar_arrive(kBarFull + (handoffs & 1), kPass1Threads);
        ++handoffs;
        if (handoffs >= 2) bar_sync(kBarEmpty + (handoffs & 1), kPass1Threads);
      };
      // Right after a producer barrier that follows a push round: while some
      // lane's candidates did not fit, hand over and push them again.
      auto settle = [&]() {
        while (ovf[round & 1] == round) {
          hand_over();
          left = push(left, left_col0);
          bar_sync(kBarProducers, kProducers);
        }
      };
      // Ceiling row-best stages: each lane's best over its rows' columns of
      // the current probe tile (and, prologue, its lowest column in it), and
      // whether a probe tile's per-warp values await the combine.
      float best[L::NT][2];
      int best_i[L::NT][2], arg[L::NT][2];
      bool combine_pending = false;
      int combine_buf = 0;
      // mm, mask, mmint: the XOR of every accumulator's bits, stored only
      // when a sink is passed (never, from the wrappers): without a use,
      // ptxas drops the products whose accumulators no stage reads (half of
      // them at 64 rows), and these stages would time half a product.
      unsigned keep = 0;
      auto keep_all = [&]() {
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (kInt8) keep ^= (unsigned)acc[mt][nt][j];
              else keep ^= __float_as_uint(acc[mt][nt][j]);
            }
      };
      // The combine: the warps of column group 0, lanes g == 0, each hold
      // rows r0 + nt * 8 + j: they fold the WC per-warp values into the sums.
      auto combine = [&]() {
        if (!combine_pending) return;
        combine_pending = false;
        if (wc != 0 || g != 0) return;
        const float* mxb = mx + combine_buf * TQ * L::WC;
        const int* axb = ax + combine_buf * TQ * L::WC;
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = r0 + nt * 8 + j;
            if (r >= rows) continue;
            if constexpr (STAGE == kCeilRowmaxInt) {
              const int* mxi = reinterpret_cast<const int*>(mxb);
              int v = mxi[r * L::WC];
              for (int w = 1; w < L::WC; ++w) v = max(v, mxi[r * L::WC + w]);
              csum_i[r] = wrap_add(csum_i[r], v);
            } else {
              float v = mxb[r * L::WC];
              int a = axb[r * L::WC];
              for (int w = 1; w < L::WC; ++w)
                if (better(mxb[r * L::WC + w], axb[r * L::WC + w], v, a)) {
                  v = mxb[r * L::WC + w];
                  a = axb[r * L::WC + w];
                }
              csum[r] += v;
              if constexpr (STAGE == kCeilPrologue) csum[r] += (float)a;
            }
          }
      };

      for (int step = 0; step < steps; ++step) {
        const int slice = step % n_slices;
        const int d0 = slice * kDK;
        cp_async_wait<kStages - 2>();
        if constexpr (kInt8) {
          // The thread's own pieces of slice `step` have landed, and it read
          // the ring buffer the next copy overwrites (slice step - 1) itself.
          if (step + kStages - 1 < steps) issue(step + kStages - 1);
          else cp_async_commit();
          const T* buf = ring + (step % kStages) * kDK * kCS;
          const int c = (tid >> 5) * kEPC;
          uint4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint4*>(buf + (lane + 32 * i) * kCS + c);
          unsigned* dst = kp + (step & 1) * kTN * kTBS + c * kTBS + lane;
          transpose_store(w[0].x, w[1].x, w[2].x, w[3].x, dst);
          transpose_store(w[0].y, w[1].y, w[2].y, w[3].y, dst + 4 * kTBS);
          transpose_store(w[0].z, w[1].z, w[2].z, w[3].z, dst + 8 * kTBS);
          transpose_store(w[0].w, w[1].w, w[2].w, w[3].w, dst + 12 * kTBS);
          // The k-packed slice is whole; every producer is past the product
          // of step - 1, so the other buffer is free for step + 1.
          bar_sync(kBarProducers, kProducers);
        } else {
          bar_sync(kBarProducers, kProducers);  // slice `step` landed; slice step - 1 is read
          if (step + kStages - 1 < steps) issue(step + kStages - 1);
          else cp_async_commit();
        }
        if (slice == 0) {
          // Every push of the tile before has landed (the barrier above):
          // settle its overflow while its scores are still in registers,
          // and combine the last probe tile's per-warp maxima.
          if constexpr (kSelect) settle();
          if constexpr (kRowBest) combine();
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
        }

        const T* cs = ring + (step % kStages) * kDK * kCS;
#pragma unroll
        for (int k0 = 0; k0 < kDK; k0 += kKStep) {
          if constexpr (kInt8) {
            unsigned a[L::MT][4];
            const int row = lane & 7, mat = lane >> 3;
            const unsigned* kb = kp + (step & 1) * kTN * kTBS;
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt)
              ldmatrix_a(a[mt], kb + (cw + mt * 16 + (mat & 1) * 8 + row) * kTBS + k0 / 4 +
                                    (mat >> 1) * 4);
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt) {
              const unsigned* b =
                  reinterpret_cast<const unsigned*>(qw + nt * 8 * QS + d0 + k0) + t4;
              const unsigned b0 = b[0], b1 = b[4];
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
            }
          } else if constexpr (std::is_same<T, float>::value) {
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
        const int sub = (col0 / kTN) % ceil.block_tiles;  // the tile's place in its probe tile
        const bool probe_first = sub == 0;
        const bool probe_last = sub == ceil.block_tiles - 1 || col0 + kTN >= n_phys;
        if constexpr (STAGE == kCeilMmInt) {
          // The raw int32 sum of column 0 of the probe tile, wrapping.
          keep_all();
          if (wc == 0 && g == 0 && probe_first) {
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int r = r0 + nt * 8 + j;
                if (r < rows) csum_i[r] = wrap_add(csum_i[r], (int)acc[0][nt][j]);
              }
          }
          continue;
        } else if constexpr (STAGE == kCeilRowmaxInt) {
          // The raw int32 row maxima over the warp's columns of the probe
          // tile, masked with kIntMask, kept per lane until its last tile.
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              int v = probe_first ? kIntMask : best_i[nt][j];
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (col0 + cw + g + mt * 16 + 8 * h < limit) v = max(v, (int)acc[mt][nt][2 * h + j]);
              best_i[nt][j] = v;
            }
          if (probe_last) {
            combine_buf ^= 1;
            int* mxi = reinterpret_cast<int*>(mx) + combine_buf * TQ * L::WC;
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int m = lanes_max_int<4>(best_i[nt][j]);
                if (g == 0) mxi[(r0 + nt * 8 + j) * L::WC + wc] = m;
              }
            combine_pending = true;
          }
          continue;
        }
        // The float scores S: the accumulators, or for int8 int -> f32 times
        // the column scale (PROBED: times the row scale, then the column
        // scale, left to right, as ragfin_tpu/ops/ivf.py orders it per tile).
        if constexpr (kInt8) {
          float csc[L::MT][2];
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = col0 + cw + mt * 16 + g + 8 * h;
              csc[mt][h] = col < n_phys ? cscale[col] : 0.f;
            }
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = r0 + nt * 8 + j;
              const float rs = PROBED && r < rows ? qscale[q0 + r] : 1.f;
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float v = __int2float_rn(acc[mt][nt][2 * h + j]);
                  if constexpr (PROBED) v = __fmul_rn(v, rs);
                  fs[mt][nt][2 * h + j] = __fmul_rn(v, csc[mt][h]);
                }
            }
        }
        float (&S)[L::MT][L::NT][4] = scores();
        if constexpr (STAGE == kCeilMm || STAGE == kCeilMask) {
          // Column 0 of the probe tile: lane g = 0 of column group 0, h = 0.
          keep_all();
          if (wc == 0 && g == 0 && probe_first) {
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int r = r0 + nt * 8 + j;
                const float v =
                    STAGE == kCeilMask && col0 >= limit ? -CUDART_INF_F : S[0][nt][j];
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
                if (col0 + cw + g + mt * 16 + (j >> 1) * 8 >= limit) S[mt][nt][j] = -CUDART_INF_F;
        }
        if constexpr (kSelect) {
          // The gate: each value against its row's k-th score, in registers.
          float th[L::NT][2];
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = r0 + nt * 8 + j;
              th[nt][j] = r < rows ? kth[r] : CUDART_INF_F;
            }
          unsigned want = 0;
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (S[mt][nt][j] > th[nt][j & 1]) want |= 1u << ((mt * L::NT + nt) * 4 + j);
          left = push(want, col0);
          left_col0 = col0;
        } else {
          // kCeilRowmax / kCeilPrologue: each lane's best over its columns of
          // the probe tile (the prologue: the lowest column of a tie, tiles
          // and columns arriving in ascending order), combined per probe tile.
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float v = probe_first ? -CUDART_INF_F : best[nt][j];
              int a = probe_first ? kIdSentinel : arg[nt][j];
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  if constexpr (STAGE == kCeilPrologue) {
                    const int c = sub * kTN + cw + mt * 16 + g + 8 * h;
                    if (better(S[mt][nt][2 * h + j], c, v, a)) {
                      v = S[mt][nt][2 * h + j];
                      a = c;
                    }
                  } else {
                    v = fmaxf(v, S[mt][nt][2 * h + j]);
                  }
                }
              best[nt][j] = v;
              arg[nt][j] = a;
            }
          if (probe_last) {
            combine_buf ^= 1;
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                float v = best[nt][j];
                int a = arg[nt][j];
                if constexpr (STAGE == kCeilPrologue) lanes_best<4>(v, a);
                else v = lanes_max<4>(v);
                if (g == 0) {
                  const int o = combine_buf * TQ * L::WC + (r0 + nt * 8 + j) * L::WC + wc;
                  mx[o] = v;
                  ax[o] = a;
                }
              }
            combine_pending = true;
          }
        }
      }
      cp_async_wait<0>();
      if constexpr (STAGE == kCeilMm || STAGE == kCeilMask || STAGE == kCeilMmInt) {
        if (ceil.sink != nullptr)
          ceil.sink[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kSinkWords + tid] = keep;
      }
      if constexpr (kSelect) {
        // The last tile's pushes, then the final handoff, and the wait for
        // the drain before it, whose release nothing else consumes.
        bar_sync(kBarProducers, kProducers);
        settle();
        if (tid == 0) *final_flag = handoffs + 1;  // which handoff is the final one
        bar_arrive(kBarFull + (handoffs & 1), kPass1Threads);
        if (handoffs >= 1) bar_sync(kBarEmpty + ((handoffs - 1) & 1), kPass1Threads);
      }
      if constexpr (kRowBest) {
        bar_sync(kBarProducers, kProducers);
        combine();
      }
    }
  } else if constexpr (kSelect) {
    // ---------------- drainers: the lists ----------------
    // Drainer warp w takes rows w, w + kDWarps, ...; their running top-k
    // lists live in its registers. Per handed-over buffer: sort each row's
    // queue and merge it into the row's list, publish the k-th score, empty
    // the queue, and release the buffer unless it was the final one.
    const int dw = warp - kPWarps;
    RowList<KS> lists[L::RW];
#pragma unroll
    for (int i = 0; i < L::RW; ++i) lists[i].init();
    for (int h = 0;; ++h) {
      const int b = h & 1;
      bar_sync(kBarFull + b, kPass1Threads);
      // The flag names the final handoff: read for handoff h - 1, it may
      // already hold h + 1, written while that drain runs.
      const bool last = *final_flag == h + 1;
#pragma unroll 1
      for (int i = 0; i < L::RW; ++i, rotate(lists)) {
        const int r = dw + kDWarps * i;  // lists[0] is row r's
        if (r >= rows) continue;
        const int n = min(qcnt[b * TQ + r], kQCap);
        if (n == 0) continue;
        const int o = (b * TQ + r) * kQCap;
        drain_queue<KS, kQCap / 32>(lists[0].s, lists[0].i, qbuf_s + o, qbuf_i + o, n, k);
        const float ks = list_kth<KS>(lists[0].s, k);
        if (lane == 0) {
          kth[r] = ks;
          qcnt[b * TQ + r] = 0;
        }
      }
      if (last) break;
      bar_arrive(kBarEmpty + b, kPass1Threads);
    }
#pragma unroll 1
    for (int i = 0; i < L::RW; ++i, rotate(lists)) {
      const int r = dw + kDWarps * i;
      if (r >= rows) continue;
      const long long o = ((long long)chunk * Q + q0 + r) * k;
      lists[0].store(part_s + o, part_i + o, k);
    }
  }
  if constexpr (!kSelect) {
    __syncthreads();
    for (int r = tid; r < rows; r += kPass1Threads) {
      const int from = STAGE == kCeilDma ? 0 : r;
      if constexpr (kIntSum) part_i[(long long)chunk * Q + q0 + r] = csum_i[from];
      else part_s[(long long)chunk * Q + q0 + r] = csum[from];
    }
  }
}

// KS: list slots per lane, k <= 32 * KS (the wrappers take 2 for k <= 64,
// else 4). q is f32 [Q, D], or int8 over an int8 corpus with its column
// scales (cscale) and, PROBED, the query row scales (qscale).
template <typename T, int TQ, bool PROBED = false, int STAGE = kStageSelect, int KS = 2>
cudaError_t launch_pass1(const void* q, int Q, int D, const void* ct, long long ld,
                         long long tile_stride, int bn, int n_phys, int limit, int k,
                         int tiles_per_chunk, int n_chunks, float* part_s, int* part_i,
                         cudaStream_t stream, ProbeWalk walk = ProbeWalk{},
                         CeilArgs ceil = CeilArgs{}, const float* cscale = nullptr,
                         const float* qscale = nullptr, bool round_q = false) {
  const size_t smem = pass1_smem<T, TQ, STAGE>(D);
  if (smem > (size_t)kSmemLimit || k > 32 * KS) return cudaErrorInvalidValue;
  constexpr bool kScaled = STAGE != kCeilDma && STAGE != kCeilMmInt && STAGE != kCeilRowmaxInt;
  if (kIsInt8<T> && ((kScaled && cscale == nullptr) || (PROBED && qscale == nullptr) || D % 4))
    return cudaErrorInvalidValue;
  auto kernel = fused_topk_pass1<T, TQ, PROBED, STAGE, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + TQ - 1) / TQ, n_chunks);
  kernel<<<grid, kPass1Threads, smem, stream>>>(q, Q, D, static_cast<const T*>(ct), cscale, qscale,
                                           ld, tile_stride, bn, n_phys, limit, k,
                                           tiles_per_chunk, walk, ceil, part_s, part_i, round_q);
  return cudaGetLastError();
}

}  // namespace ragfin
