// Pass 1 of the fused cosine top-k kernels over an f32, bf16 or int8 corpus:
// score a block's query rows against a run of kTN-column tiles on the tensor
// cores and keep a running top-k per row with the two-level selection of
// twolevel.cuh. Shared by fused_topk.cu and fused_topk_int8.cu, which walk a
// contiguous chunk of the corpus, ivf_topk.cu, which walks the cell a probe
// table names (PROBED), and ceiling.cu, which keeps the walk, the copies and
// the product and puts a cheaper reduction in the selection's place (STAGE;
// part_s, or part_i for the sums that stay integers, then holds one partial
// sum per chunk and row).
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
// queries, the ring, for int8 two k-packed buffers, two buffers of sub-block
// maxima and their columns, the ceiling sums, and for the selection two score
// tiles and the k-th scores.
template <typename T, int TQ, int STAGE>
__host__ __device__ constexpr size_t pass1_smem(int D) {
  return sizeof(QElem<T>) * (size_t)TQ * (padded_depth<T>(D) + Slice<T>::kQPad) +
         sizeof(T) * (size_t)Layout<TQ>::kStages * Slice<T>::kDK * Slice<T>::kCS +
         (kIsInt8<T> ? sizeof(unsigned) * 2 * kTN * kTBS : 0) +
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
                 int* __restrict__ part_i) {
  using L = Layout<TQ>;
  using QT = QElem<T>;
  constexpr bool kInt8 = kIsInt8<T>;
  constexpr int kStages = L::kStages;
  constexpr int kDK = Slice<T>::kDK, kKStep = Slice<T>::kKStep, kCS = Slice<T>::kCS;
  constexpr int kEPC = 16 / sizeof(T);               // elements per 16-byte copy
  constexpr int kCPR = kTN / kEPC;                   // copies per slice row
  constexpr int kCopies = kDK * kCPR / kProducers;   // copies per producer per slice
  constexpr bool kSelect = STAGE == kStageSelect;
  // Stages whose tiles the walkers consume: the selection, and the ceiling
  // stages that reduce the sub-block maxima per row.
  constexpr bool kWalk = kSelect || STAGE == kCeilRowmax || STAGE == kCeilPrologue ||
                         STAGE == kCeilRowmaxInt;
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
  float* mx = reinterpret_cast<float*>(kp + (kInt8 ? 2 * kTN * kTBS : 0));  // [2][TQ][WC] sub-block maxima
  int* ax = reinterpret_cast<int*>(mx + 2 * TQ * L::WC);             // [2][TQ][WC] their columns
  float* csum = reinterpret_cast<float*>(ax + 2 * TQ * L::WC);       // [TQ] ceiling sums
  float* cbest = csum + TQ;                                          // [TQ]
  int* carg = reinterpret_cast<int*>(cbest + TQ);                    // [TQ]
  int* csum_i = reinterpret_cast<int*>(csum);                        // the int sums' view
  int* cbest_i = reinterpret_cast<int*>(cbest);
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
  // notes whether any query value is not a bf16 value (then it splits). The
  // int8 queries are stored in the corpus fragments' k order: position
  // s * kDK + 4 w + i holds d = s * kDK + w + 32 i.
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
      const float v = r < rows && dq < D ? static_cast<const float*>(q)[(long long)(q0 + r) * D + dq]
                                         : 0.f;
      qs[r * QS + dq] = v;
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        inexact |= __bfloat162float(__float2bfloat16_rn(v)) != v;
    }
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
      float fs[kInt8 ? L::MT : 1][kInt8 ? L::NT : 1][4];  // int8: the dequantised tile
      const int cw = wc * L::SUBW;                          // the warp's first column
      const int r0 = wq * (TQ / L::WQ) + 2 * t4;            // row of acc[*][0][0]
      const QT* qw = qs + (wq * (TQ / L::WQ) + g) * QS;     // row g of the warp's queries
      for (int step = 0; step < steps; ++step) {
        const int slice = step % n_slices;
        const int d0 = slice * kDK;
        if (slice == 0) {
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
        }
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
        const bool probe_first = (col0 / kTN) % ceil.block_tiles == 0;
        const int buf = tl & 1;
        if constexpr (STAGE == kCeilMmInt) {
          // The raw int32 sum of column 0 of the probe tile, wrapping.
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
          // The raw int32 row maxima over the warp's columns, masked with
          // kIntMask, handed to the walkers as int bits.
          int* mxb = reinterpret_cast<int*>(mx) + buf * TQ * L::WC;
          int m[L::NT][2];
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              int v = kIntMask;
#pragma unroll
              for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (col0 + cw + g + mt * 16 + 8 * h < limit) v = max(v, (int)acc[mt][nt][2 * h + j]);
              m[nt][j] = lanes_max_int<4>(v);
            }
          if (tl >= 2) bar_sync(kBarEmpty + buf, kPass1Threads);
          if (g == 0) {
#pragma unroll
            for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) mxb[(r0 + nt * 8 + j) * L::WC + wc] = m[nt][j];
          }
          bar_arrive(kBarFull + buf, kPass1Threads);
          continue;
        }
        // The float scores S: the accumulators, or for int8 int -> f32 times
        // the column scale (PROBED: times the row scale, then the column
        // scale, left to right, as ragfin_tpu/ops/ivf.py orders it per tile).
        float (*sp)[L::MT][L::NT][4];
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
          sp = &fs;
        } else {
          sp = &acc;
        }
        float (&S)[L::MT][L::NT][4] = *sp;
        if constexpr (STAGE == kCeilMm || STAGE == kCeilMask) {
          // Column 0 of the probe tile: lane g = 0 of column group 0, h = 0.
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
                  if (better(S[mt][nt][2 * h + j], c, v, a)) {
                    v = S[mt][nt][2 * h + j];
                    a = c;
                  }
                } else {
                  v = fmaxf(v, S[mt][nt][2 * h + j]);
                }
              }
            if constexpr (STAGE == kCeilPrologue) lanes_best<4>(v, a);
            else v = lanes_max<4>(v);
            m[nt][j] = v;
            am[nt][j] = a;
          }
        // Hand the tile to the walkers through buffer tl % 2, once they have
        // released it (tile tl - 2).
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
                      S[mt][nt][j];
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
        // kCeilRowmax / kCeilPrologue / kCeilRowmaxInt: the row's maximum
        // (and lowest arg-max) over the tile, then over the probe tile.
        const int sub = (col0 / kTN) % ceil.block_tiles;
        const bool first = sub == 0;
        const bool last = sub == ceil.block_tiles - 1 || col0 + kTN >= n_phys;
        for (int r = ww; r < rows; r += kWWarps) {
          if constexpr (STAGE == kCeilRowmaxInt) {
            const int* mxi = reinterpret_cast<const int*>(mxb);
            const int v = lanes_max_int<1>(lane < L::WC ? mxi[r * L::WC + lane] : kIntMask);
            if (lane == 0) {
              if (first || v > cbest_i[r]) cbest_i[r] = v;
              if (last) csum_i[r] = wrap_add(csum_i[r], cbest_i[r]);
            }
            continue;
          }
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
                         const float* qscale = nullptr) {
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
                                           tiles_per_chunk, walk, ceil, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace ragfin
