// FlashAttention forward and backward for Hopper (sm_90a): blocked
// online-softmax attention whose S x S score matrix never reaches device
// memory. Built by dml_cnn_cifar10_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes from ops/flash_attention.py (plain C interface).
//
// Replaces the Pallas TPU kernels of dml_cnn_cifar10_tpu/ops/flash_attention.py:
//   flash_out_kernel   (K3) <- _flash_kernel (:345), _fwd_call(mode="out")
//   flash_lse_kernel   (K4) <- _flash_fwd_kernel (:360), mode="lse"
//   flash_stats_kernel (K5) <- _flash_stats_kernel (:386), mode="stats"
//   flash_dq_kernel    (K6) <- _flash_bwd_dq_kernel (:688)
//   flash_dkv_kernel   (K7) <- _flash_bwd_dkv_kernel (:736)
// (pallas_call sites :617/:629, :854/:866, :894/:906).
//
// What they compute, for one (batch, head) and q, k, v, dO laid out
// [B, S, H, D] (read through their B/S/H strides; the head dim is
// contiguous), with s = (q . k) * scale and the mask of _score_mask (:152):
//   K3/K4: out = softmax(s) v; K4 also lse = m + log l per row.
//   K5:    the raw partial-softmax state that the ring merge consumes:
//          the UNNORMALIZED acc = sum_j exp(s_j - m) v_j, the row max m
//          and the normalizer l = sum_j exp(s_j - m), all f32 whatever
//          the input dtype (a partial rounded to bf16 would quantize
//          every ring step). A row with no live key writes m = -1e30,
//          l = 0, acc = 0 exactly; the Pallas kernel leaves l/acc
//          undefined there and its caller keys on m alone.
//   K6:    p = exp(s - lse), dS = p * (dO . v - delta) * scale,
//          dQ = sum_j dS K.
//   K7:    dV = sum_i p^T dO, dK = sum_i dS^T Q.
// Scores, p, m, l and every accumulator are f32 for f32 and bf16 inputs
// alike; outputs are rounded to their dtype on the store. Masked scores
// are NEG_INF = -1e30, never -inf. A row with no live key (every key
// masked: causal/window bands, segments, kv_start, cross lengths) outputs
// exactly 0 and publishes lse = 1e30, so the backward's p = exp(s - lse)
// is exactly 0 there.
//
// Design. A block owns one 64-row tile of one (batch, head): query rows
// for K3-K6, key rows for K7. It initialises its own m, l and
// accumulators, then walks the tiles of the other axis in a loop (the
// Pallas grid's sequential inner axis becomes this loop; CUDA blocks
// share no state). band() gives that loop's bounds from the causal/window
// band, one definition for all five kernels; score_live() is the element
// mask inside it, so the skip logic cannot drift from the mask (the role
// of _band_live, :481). Ragged edges are bounds-checked in the kernel:
// nothing is padded to the tile size.
//   Every kernel runs every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), four warps of 16 rows each: the
// softmax (K3/K4/K5) and its Jacobian (K6/K7) work on the accumulator
// fragments, P and dS are repacked in registers as the second product's A
// operand, streamed tiles are double-buffered by cp.async, and operands
// that are not bf16 values are split into bf16 terms; see the sections
// before flash_dq_kernel and flash_fwd_tc. K3, K4 and K5 are one body,
// flash_fwd_tc<T, D, Mode>, that differs only in its epilogue: K5 stores
// the f32 accumulator unnormalized, m scaled and l, where K3/K4 divide by
// l and round to the input dtype.
//
// What bounds them on an H100 SXM. The work is 4*B*H*Sq*Skv_live*D FLOPs
// forward, 6*... for dQ and 8*... for dK/dV. At the ViT main path's
// [128, 257, 3, 64] f32 the forward is 6.5 GFLOP, ~0.1 ms at the card's
// 67 TFLOP/s of f32 on the CUDA cores, while its bytes (q, k, v, out:
// 101 MB) take 0.03 ms at 3.35 TB/s, so operations bound it; the long
// [2, 8100, 3, 64] bf16 shape (101 GFLOP, 0.102 ms at 989 TFLOP/s) and
// K5's ring block [2, 4050, 3, 64] bf16 (25.2 GFLOP, 25 us, against 15.7
// MB of inputs and outputs, 4.7 us at 3.35 TB/s) are operation-bound at
// the bf16 tensor-core rate too. The kernels issue their products at that
// rate, times the term pairs of their split: 6 for every product with f32
// inputs (K3/K4 0.039 ms of tensor-core work at the ViT shape, K6 + K7
// 0.059 + 0.079 ms); with bf16 inputs 1, but 3 for K5's P V and for
// K6/K7's second products with f32 gradients (K5 0.051 ms at the ring
// block; at the long shape with bf16 gradients K3/K4 0.102 ms, K6 + K7
// 0.153 + 0.204 ms). ptxas -v for
// sm_90a: the head-dim-64 backward instances take 144-177 registers (K6
// f32 144, bf16 156; K7 f32 177, bf16 163), no spills, 100,096 B of
// dynamic shared memory with f32 inputs, 56,832 (K6) and 37,632 (K7) with
// bf16 inputs; K7 with f32 and D = 128 holds 255 registers and 190,208 B,
// one block an SM. The forward's D = 64 instances: f32 131 registers and
// 71,936 B (three blocks an SM), bf16 128 and 46,592 B (four), no spills;
// bf16 D = 128 spills 4 B.
//
// What remains: the kernels use mma.sync, not wgmma with TMA loads, warp
// specialisation and persistent blocks (the FlashAttention-3 design), and
// K7 recomputes the scores K6 already built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr float kNegInf = -1e30f;   // masked score (not -inf: no NaN rows)
constexpr float kDeadLse = 1e30f;   // lse of a row with no live key

enum DType { kF32 = 0, kBF16 = 1 };
// What a forward kernel stores: K3 out; K4 out and lse; K5 acc, m and l.
enum FwdMode { kOut = 0, kLse = 1, kStats = 2 };

struct Mask {
  int q_len, kv_len;
  int kv_start;  // global column of local key 0 (causal/window only)
  int window;    // band |row - col| < window; 0 = no window
  int causal;
};

struct Range {
  int lo, hi;  // half-open
};

// The causal/window band. For the span [a0, a1) of one axis of the score
// matrix -- query rows (k_major false) or local key columns (true) -- the
// half-open span of the other axis that can hold a live score, clipped to
// that axis' length. Every kernel's loop bounds come from here.
__device__ __forceinline__ Range band(const Mask& m, int a0, int a1,
                                      bool k_major) {
  constexpr long long kFar = 1LL << 40;
  const long long w = m.window;
  long long lo = -kFar, hi = kFar;
  if (!k_major) {  // rows [a0, a1) -> global key columns
    if (m.causal) hi = a1;                     // col <= row
    if (w) {
      lo = (long long)a0 - w + 1;              // col > row - w
      if (!m.causal && (long long)a1 - 1 + w < hi) hi = (long long)a1 - 1 + w;
    }
    lo -= m.kv_start;                          // global -> local columns
    hi -= m.kv_start;
    if (lo < 0) lo = 0;
    if (hi > m.kv_len) hi = m.kv_len;
  } else {         // local key columns [a0, a1) -> query rows
    const long long c0 = (long long)a0 + m.kv_start;
    const long long c1 = (long long)a1 - 1 + m.kv_start;
    if (m.causal) lo = c0;                     // row >= col
    if (w) {
      hi = c1 + w;                             // row < col + w
      if (!m.causal && c0 - w + 1 > lo) lo = c0 - w + 1;  // row > col - w
    }
    if (lo < 0) lo = 0;
    if (hi > m.q_len) hi = m.q_len;
  }
  if (hi < lo) hi = lo;
  return {(int)lo, (int)hi};
}

// The element mask of _score_mask: row r, local column c, their segment
// ids (equal when the call has none). A term added here must also clear
// tile_all_live() below, which lets K6/K7 skip this mask on full tiles.
__device__ __forceinline__ bool score_live(const Mask& m, int r, int c,
                                           int qs, int ks) {
  if (r >= m.q_len || c >= m.kv_len) return false;
  const long long cg = (long long)c + m.kv_start;
  if (m.causal && cg > r) return false;
  if (m.window) {
    if (cg <= (long long)r - m.window) return false;
    if (!m.causal && cg >= (long long)r + m.window) return false;
  }
  return qs == ks;
}

// True only where score_live holds for every row < r1 and local column <
// c1 of a tile: no causal/window band, no segment ids, inside both
// lengths. Such tiles (every tile of a plain full-attention call but the
// ragged last) skip the per-element mask.
__device__ __forceinline__ bool tile_all_live(const Mask& m, bool has_seg,
                                              int r1, int c1) {
  return !m.causal && !m.window && !has_seg && r1 <= m.q_len &&
         c1 <= m.kv_len;
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;  // [B, Sq] int32 or null
  const int* kseg;  // [B, Skv] int32 or null
  void* out;        // [B, Sq, H, D] contiguous: q's dtype; K5's acc f32
  float* lse;       // [B, Sq, H] contiguous f32 (K4 only)
  float* m_out;     // [B, Sq, H] contiguous f32 (K5 only)
  float* l_out;     // [B, Sq, H] contiguous f32 (K5 only)
  int64_t qs[3], ks[3], vs[3];  // B, S, H strides in elements
  int heads, dtype;
  float scale;
  Mask m;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Sq, H] contiguous f32
  const float* delta;  // [B, Sq, H] contiguous f32
  const int* qseg;
  const int* kseg;
  void* dq;  // [B, Sq, H, D] contiguous
  void* dk;  // [B, Skv, H, D] contiguous
  void* dv;
  int64_t qs[3], ks[3], vs[3], ds[3];
  int heads, dq_dtype, dk_dtype, dv_dtype;
  float scale;
  Mask m;
};

// ---- K6/K7: the backward on the tensor cores ------------------------------
//
// A block is 4 warps and owns 64 rows (query rows in K6, key rows in K7);
// a warp owns 16 of them. The block walks the kN-wide tiles of the other
// axis over band(). Every product is mma.sync m16n8k16 bf16 x bf16 -> f32:
//   K6: S = Q K^T, dP = dO V^T; then dQ += dS K.
//   K7: S^T = K Q^T, dP^T = V dO^T; then dV += P^T dO, dK += dS^T Q.
// S and dP come out in registers in the m16n8 accumulator layout; the mask,
// exp and the softmax Jacobian work on those fragments (a lane knows its
// row and column from its lane id), and P and dS are repacked in registers
// as the A operand of the second product. The resident operands (Q and dO
// in K6, K and V in K7) are loaded once; the streamed tiles (K, V in K6; Q,
// dO, lse, delta in K7) arrive by cp.async, tile j + 1 in flight while tile
// j is multiplied. Shared-memory rows are padded to D + 8 bf16, so the 8
// rows of an ldmatrix fall in distinct banks.
//
// Precision by instance. An operand that is not a bf16 value is split into
// bf16 terms x = t0 + t1 + t2, t_i = bf16(x - t0 - ... - t_{i-1}), and a
// product of split operands keeps the term pairs (i, j) with i + j <
// max(terms of a, terms of b):
//   f32 inputs: q, k, v, dO as kF32Planes bf16 planes in shared memory, P
//     and dS as kF32Planes terms (six products each). Two planes (bf16x3,
//     three products) miss the f32 gradient pin 5e-5 on causal rows with
//     few keys (tests/test_torch_flash_split.py).
//   bf16 inputs, f32 gradients (the ring's out_dtype): S and dP exact in
//     one product; P and dS as kRingTerms terms.
//   bf16 inputs, bf16 gradients: P and dS rounded to bf16 once.

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // rows a block owns
constexpr int kF32Planes = 3;  // bf16 terms of an f32 operand (and of P, dS)
constexpr int kRingTerms = 3;  // P, dS terms: bf16 inputs, f32 gradients
constexpr int kBf16Terms = 1;  // P, dS terms: bf16 inputs, bf16 gradients
constexpr int kStatsBf16Terms = 3;  // P terms of K5 with bf16 inputs
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. trans: each matrix is transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b for a 16x16 A (row), a 16x8 B (col), f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += sum of a_i b_j over i + j < max(NA, NB), smallest terms first. b
// holds two n8 tiles of an ldsm4 (regs 0-1 and 2-3); `half` picks one.
template <int NA, int NB>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][4],
                                          int half) {
  constexpr int kN = NA > NB ? NA : NB;
#pragma unroll
  for (int s = kN - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (s - i >= 0 && s - i < NB)
        mma(c, a[i], b[s - i][2 * half], b[s - i][2 * half + 1]);
}

// x, y rounded to one bf16 pair (x in the low half), and what is left.
__device__ __forceinline__ uint32_t round_pair(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x -= __low2float(h);
  y -= __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x, y (adjacent columns) as N bf16 terms, each packed as one b32 pair.
template <int N>
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&out)[N][4], int reg) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i][reg] = round_pair(x, y);
}

// The A operand of a k16 step from two n8 accumulator tiles (columns
// 16kk .. 16kk + 15 of a 16-row strip), as N bf16 terms.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[N][4]) {
  split_pair<N>(c0[0], c0[1], a, 0);
  split_pair<N>(c0[2], c0[3], a, 1);
  split_pair<N>(c1[0], c1[1], a, 2);
  split_pair<N>(c1[2], c1[3], a, 3);
}

// Four f32 values as NP bf16 planes (plane stride `pstride` elements).
template <int NP>
__device__ __forceinline__ void store_planes(bf16* dst, int pstride,
                                             float4 x) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint32_t lo = round_pair(x.x, x.y), hi = round_pair(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + p * pstride) = make_uint2(lo, hi);
  }
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice by 16-byte cp.async
// copies into shared memory (row stride `ld` elements of T); rows past
// `len` are zero-filled. Needs 16-byte aligned rows (the wrapper checks).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int64_t row_stride, int row0,
                                          int len) {
  constexpr int kChunks = D * (int)sizeof(T) / 16, kPer = 16 / sizeof(T);
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = (e % kChunks) * kPer;
    const bool valid = row0 + r < len;
    cp_async16(dst + r * ld + c,
               src + (valid ? (int64_t)(row0 + r) * row_stride : 0) + c,
               valid);
  }
}

// f32 rows (staged raw, row stride D) -> NP bf16 planes (row stride D + 8).
template <int D, int ROWS, int NP>
__device__ __forceinline__ void split_rows(bf16* planes, const float* raw) {
  constexpr int LD = D + 8;
  for (int e = threadIdx.x; e < ROWS * D / 4; e += kTcThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    store_planes<NP>(planes + r * LD + c, ROWS * LD,
                     *reinterpret_cast<const float4*>(raw + r * D + c));
  }
}

// The resident rows of an f32 tensor, read once straight into NP planes.
template <int D, int NP>
__device__ __forceinline__ void load_planes(bf16* planes, const float* src,
                                            int64_t row_stride, int row0,
                                            int len) {
  constexpr int LD = D + 8;
  for (int e = threadIdx.x; e < kTcRows * D / 4; e += kTcThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const float4 x =
        row0 + r < len
            ? *reinterpret_cast<const float4*>(
                  src + (int64_t)(row0 + r) * row_stride + c)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    store_planes<NP>(planes + r * LD + c, kTcRows * LD, x);
  }
}

// The resident 64 rows of q/dO (K6) or k/v (K7) into shared memory.
template <typename T, int D, int NP>
__device__ __forceinline__ void load_resident(bf16* planes, const T* src,
                                              int64_t row_stride, int row0,
                                              int len) {
  if constexpr (std::is_same<T, float>::value) {
    load_planes<D, NP>(planes, src, row_stride, row0, len);
  } else {
    copy_rows<bf16, D, kTcRows>(planes, D + 8, src, row_stride, row0, len);
  }
}

__device__ __forceinline__ void store2(void* base, int64_t i, float x,
                                       float y, int dtype) {
  if (dtype == kF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i) =
        make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + i) =
        __floats2bfloat162_rn(x, y);
  }
}

// Shared-memory plan of one tensor-core instance: RES resident tensors of
// kTcRows rows, two streamed tensors of N rows (two stages for bf16; for
// f32 one stage of planes plus the raw f32 rows the copies land in), STATS
// f32 values per streamed row (K7: lse and delta) and segment ids, the
// last two in two slots.
template <typename T, int D, int N, int RES, int STATS>
struct TilePlan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kNP = kF32 ? kF32Planes : 1;  // bf16 planes
  static constexpr int kN = N;
  static constexpr int LD = D + 8;
  static constexpr int kStages = kF32 ? 1 : 2;
  static constexpr int kResident = RES * kNP * kTcRows * LD;  // bf16 elems
  static constexpr int kStage = 2 * kNP * kN * LD;             // bf16 elems
  static constexpr int kRaw = kF32 ? 2 * kN * D : 0;           // f32 elems
  static constexpr int kStats = 2 * STATS * kN;                // f32 elems
  static constexpr int bytes = (kResident + kStages * kStage) * 2 +
                               (kRaw + kStats) * 4 + 2 * kN * 4;
};

// K6 (kDkv false) and K7: q and dO (K6) or k and v (K7) resident; K6
// keeps K7's lse/delta slots, unused. The streamed tiles are 64 rows wide
// for K6 with bf16 and D <= 64, else 32:
// K7 keeps dK and dV beside its score strips, and at 32 it fits three
// blocks an SM at D = 64 without spills.
template <typename T, int D, bool kDkv>
using BwdPlan =
    TilePlan<T, D, (kDkv || std::is_same<T, float>::value || D == 128) ? 32
                                                                       : 64,
             2, 2>;

struct TileSmem {
  bf16* res;      // [RES tensors][kNP][64][LD]
  bf16* stream;   // [kStages][2 tensors][kNP][kN][LD]
  float* raw;     // [2 tensors][kN][D] (f32 only)
  float* stats;   // [2 slots][STATS][kN] (K7: lse, delta)
  int* seg;       // [2 slots][kN]
};

template <typename P>
__device__ __forceinline__ TileSmem tile_smem(unsigned char* base) {
  TileSmem s;
  s.res = reinterpret_cast<bf16*>(base);
  s.stream = s.res + P::kResident;
  s.raw = reinterpret_cast<float*>(s.stream + P::kStages * P::kStage);
  s.stats = s.raw + P::kRaw;
  s.seg = reinterpret_cast<int*>(s.stats + P::kStats);
  return s;
}

// Issue the cp.async copies of streamed tile `it` (rows r0 .. r0 + kN of
// x and y) and commit them as one group.
template <typename T, int D, typename P>
__device__ __forceinline__ void issue_tile(const TileSmem& sm, int it,
                                           const T* x, int64_t xs,
                                           const T* y, int64_t ys, int r0,
                                           int len) {
  if constexpr (P::kF32) {
    copy_rows<float, D, P::kN>(sm.raw, D, x, xs, r0, len);
    copy_rows<float, D, P::kN>(sm.raw + P::kN * D, D, y, ys, r0, len);
  } else {
    bf16* st = sm.stream + (it & 1) * P::kStage;
    copy_rows<bf16, D, P::kN>(st, P::LD, x, xs, r0, len);
    copy_rows<bf16, D, P::kN>(st + P::kN * P::LD, P::LD, y, ys, r0, len);
  }
}

// Wait for streamed tile `it`; for f32 split it into planes. Returns its
// two tensors' plane base (x; y follows at kNP * kN * LD).
template <typename T, int D, typename P>
__device__ __forceinline__ const bf16* land_tile(const TileSmem& sm, int it) {
  cp_async_wait_all();
  __syncthreads();  // the tile landed; everyone is done with tile it - 1
  if constexpr (P::kF32) {
    split_rows<D, P::kN, P::kNP>(sm.stream, sm.raw);
    split_rows<D, P::kN, P::kNP>(sm.stream + P::kNP * P::kN * P::LD,
                                 sm.raw + P::kN * D);
    __syncthreads();  // planes ready; the raw rows may be refilled
    return sm.stream;
  } else {
    return sm.stream + (it & 1) * P::kStage;
  }
}

// Streamed tile's first two products for one warp: c1 = A1 B1^T and
// c2 = A2 B2^T over D, A from the resident planes (16 rows at `a1`/`a2`,
// plane stride 64 * LD), B from the streamed planes (kN rows at `b1`/`b2`,
// plane stride kN * LD). n8 column tiles at or past `live` are skipped.
template <int D, typename P>
__device__ __forceinline__ void scores(float (&c1)[P::kN / 8][4],
                                       float (&c2)[P::kN / 8][4],
                                       const bf16* a1, const bf16* a2,
                                       const bf16* b1, const bf16* b2,
                                       int live, int lane) {
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.0f;
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t x1[NP][4], x2[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ldsm4(x1[p], a1 + p * kTcRows * LD + a_off + 16 * kk);
      ldsm4(x2[p], a2 + p * kTcRows * LD + a_off + 16 * kk);
    }
#pragma unroll
    for (int jj = 0; jj < kN / 16; ++jj) {
      if (16 * jj >= live) continue;
      uint32_t y1[NP][4], y2[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        ldsm4(y1[p], b1 + p * kN * LD + 16 * jj * LD + b_off + 16 * kk);
        ldsm4(y2[p], b2 + p * kN * LD + 16 * jj * LD + b_off + 16 * kk);
      }
      mma_split<NP, NP>(c1[2 * jj], x1, y1, 0);
      mma_split<NP, NP>(c2[2 * jj], x2, y2, 0);
      if (16 * jj + 8 < live) {
        mma_split<NP, NP>(c1[2 * jj + 1], x1, y1, 1);
        mma_split<NP, NP>(c2[2 * jj + 1], x2, y2, 1);
      }
    }
  }
}

// acc += G B for one warp: G the 16 x kN strip in accumulator registers
// (as NT bf16 terms), B the streamed planes' kN rows at `b` read
// transposed (k = the streamed rows, n = D). k16 steps at or past `live`
// are skipped.
template <int D, int NT, typename P>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&g)[P::kN / 8][4],
                                           const bf16* b, int live,
                                           int lane) {
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    if (16 * kk >= live) continue;
    uint32_t x[NT][4];
    acc_to_a<NT>(g[2 * kk], g[2 * kk + 1], x);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t y[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        ldsm4t(y[p], b + p * kN * LD + 16 * kk * LD + b_off + 16 * nn);
      mma_split<NT, NP>(acc[2 * nn], x, y, 0);
      mma_split<NT, NP>(acc[2 * nn + 1], x, y, 1);
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base,
                                          const int64_t (&s)[3], int b,
                                          int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[2];
}

// K6: one block per 64 query rows; walks the key tiles of its band.
// NT: bf16 terms of dS in dQ = dS K.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(kTcThreads) flash_dq_kernel(BwdArgs a) {
  using P = BwdPlan<T, D, false>;
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem sm = tile_smem<P>(smem_raw);
  bf16* sq = sm.res;
  bf16* sdo = sm.res + NP * kTcRows * LD;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const T* q = slice<T>(a.q, a.qs, b, h);
  const T* k = slice<T>(a.k, a.ks, b, h);
  const T* v = slice<T>(a.v, a.vs, b, h);
  const T* dout = slice<T>(a.dout, a.ds, b, h);
  const bool has_seg = a.qseg != nullptr;
  load_resident<T, D, NP>(sq, q, a.qs[1], row0, a.m.q_len);
  load_resident<T, D, NP>(sdo, dout, a.ds[1], row0, a.m.q_len);
  cp_async_commit();

  // This lane's two rows (g and g + 8 of the warp's 16): lse in log2
  // units and delta * scale, so p = exp2(s * scale * log2(e) - lse2) and
  // dS = p (dP * scale - dl).
  float lse2_r[2], dl_r[2];
  int qseg_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    const bool valid = r < a.m.q_len;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
    lse2_r[i] = (valid ? a.lse[row] : kDeadLse) * kLog2e;
    dl_r[i] = valid ? a.delta[row] * a.scale : 0.0f;
    qseg_r[i] = has_seg && valid ? a.qseg[(int64_t)b * a.m.q_len + r] : 0;
  }
  const float sl2 = a.scale * kLog2e;

  const int rows_hi = min(row0 + kTcRows, a.m.q_len);
  const Range kr = band(a.m, row0, rows_hi, false);
  const int first = (kr.lo / kN) * kN;
  const int n_tiles = kr.hi > kr.lo ? (kr.hi - first + kN - 1) / kN : 0;
  auto issue = [&](int it) {
    const int c0 = first + it * kN;
    issue_tile<T, D, P>(sm, it, k, a.ks[1], v, a.vs[1], c0, a.m.kv_len);
    if (has_seg)
      for (int r = threadIdx.x; r < kN; r += kTcThreads) {
        const bool valid = c0 + r < a.m.kv_len;
        cp_async4(sm.seg + (it & 1) * kN + r,
                  a.kseg + (int64_t)b * a.m.kv_len + (valid ? c0 + r : 0),
                  valid);
      }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const bool warp_live = row0 + 16 * warp < a.m.q_len;

  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = first + it * kN;
    const bf16* sk = land_tile<T, D, P>(sm, it);
    const bf16* sv = sk + NP * kN * LD;
    if (it + 1 < n_tiles) issue(it + 1);
    if (!warp_live) continue;
    const int live = a.m.kv_len - c0;  // columns inside the key axis
    float s[kN / 8][4], ds[kN / 8][4];
    scores<D, P>(s, ds, sq + 16 * warp * LD, sdo + 16 * warp * LD, sk, sv,
                 live, lane);
    const int* kseg = sm.seg + (it & 1) * kN;
    auto jacobian = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, cl = 8 * j + 2 * t + (e & 1);
          bool alive = true;
          if constexpr (decltype(masked)::value)
            alive = score_live(a.m, row0 + 16 * warp + g + 8 * i, c0 + cl,
                               qseg_r[i], has_seg ? kseg[cl] : 0);
          const float p =
              alive ? exp2f(fmaf(s[j][e], sl2, -lse2_r[i])) : 0.0f;
          ds[j][e] = p * fmaf(ds[j][e], a.scale, -dl_r[i]);
        }
    };
    if (tile_all_live(a.m, has_seg, row0 + 16 * warp + 16, c0 + kN))
      jacobian(std::false_type{});
    else
      jacobian(std::true_type{});
    accumulate<D, NT, P>(acc, ds, sk, live, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    if (r >= a.m.q_len) continue;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(a.dq, row * D + 8 * j + 2 * t, acc[j][2 * i],
             acc[j][2 * i + 1], a.dq_dtype);
  }
}

// K7: one block per 64 key rows; walks the query tiles of its band. The
// score strips are transposed: a warp's rows are keys, columns queries.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(kTcThreads) flash_dkv_kernel(BwdArgs a) {
  using P = BwdPlan<T, D, true>;
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem sm = tile_smem<P>(smem_raw);
  bf16* sk = sm.res;
  bf16* sv = sm.res + NP * kTcRows * LD;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int col0 = blockIdx.y * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const T* q = slice<T>(a.q, a.qs, b, h);
  const T* k = slice<T>(a.k, a.ks, b, h);
  const T* v = slice<T>(a.v, a.vs, b, h);
  const T* dout = slice<T>(a.dout, a.ds, b, h);
  const bool has_seg = a.qseg != nullptr;
  load_resident<T, D, NP>(sk, k, a.ks[1], col0, a.m.kv_len);
  load_resident<T, D, NP>(sv, v, a.vs[1], col0, a.m.kv_len);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  int kseg_r[2];  // this lane's two keys
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = col0 + 16 * warp + g + 8 * i;
    kseg_r[i] = has_seg && c < a.m.kv_len
                    ? a.kseg[(int64_t)b * a.m.kv_len + c]
                    : 0;
  }

  const int cols_hi = min(col0 + kTcRows, a.m.kv_len);
  const Range qr = band(a.m, col0, cols_hi, true);
  const int first = (qr.lo / kN) * kN;
  const int n_tiles = qr.hi > qr.lo ? (qr.hi - first + kN - 1) / kN : 0;
  auto issue = [&](int it) {
    const int r0 = first + it * kN;
    issue_tile<T, D, P>(sm, it, q, a.qs[1], dout, a.ds[1], r0, a.m.q_len);
    float* st = sm.stats + (it & 1) * 2 * kN;
    for (int r = threadIdx.x; r < kN; r += kTcThreads) {
      const bool valid = r0 + r < a.m.q_len;
      const int64_t row =
          ((int64_t)b * a.m.q_len + (valid ? r0 + r : 0)) * a.heads + h;
      cp_async4(st + r, a.lse + row, valid);
      cp_async4(st + kN + r, a.delta + row, valid);
      if (has_seg)
        cp_async4(sm.seg + (it & 1) * kN + r,
                  a.qseg + (int64_t)b * a.m.q_len + (valid ? r0 + r : 0),
                  valid);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const bool warp_live = col0 + 16 * warp < a.m.kv_len;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = first + it * kN;
    const bf16* sq = land_tile<T, D, P>(sm, it);
    const bf16* sdo = sq + NP * kN * LD;
    if (it + 1 < n_tiles) issue(it + 1);
    if (!warp_live) continue;
    const int live = a.m.q_len - r0;  // columns inside the query axis
    float p[kN / 8][4], ds[kN / 8][4];
    scores<D, P>(p, ds, sk + 16 * warp * LD, sv + 16 * warp * LD, sq, sdo,
                 live, lane);
    const float* lse = sm.stats + (it & 1) * 2 * kN;
    const float* delta = lse + kN;
    const int* qseg = sm.seg + (it & 1) * kN;
    auto jacobian = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        // This lane's two query columns 8j + 2t, + 1: lse in log2 units
        // and delta * scale, as K6's rows.
        const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
        const float2 dd =
            *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
        const float lse2[2] = {l.x * kLog2e, l.y * kLog2e};
        const float dl[2] = {dd.x * a.scale, dd.y * a.scale};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, rl = 8 * j + 2 * t + (e & 1);
          bool alive = true;
          if constexpr (decltype(masked)::value)
            alive = score_live(a.m, r0 + rl, col0 + 16 * warp + g + 8 * i,
                               has_seg ? qseg[rl] : 0, kseg_r[i]);
          const float pe =
              alive ? exp2f(fmaf(p[j][e], sl2, -lse2[e & 1])) : 0.0f;
          p[j][e] = pe;
          ds[j][e] = pe * fmaf(ds[j][e], a.scale, -dl[e & 1]);
        }
      }
    };
    if (tile_all_live(a.m, has_seg, r0 + kN, col0 + 16 * warp + 16))
      jacobian(std::false_type{});
    else
      jacobian(std::true_type{});
    accumulate<D, NT, P>(dv, p, sdo, live, lane);
    accumulate<D, NT, P>(dk, ds, sq, live, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = col0 + 16 * warp + g + 8 * i;
    if (c >= a.m.kv_len) continue;
    const int64_t row = ((int64_t)b * a.m.kv_len + c) * a.heads + h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(a.dk, row * D + 8 * j + 2 * t, dk[j][2 * i], dk[j][2 * i + 1],
             a.dk_dtype);
      store2(a.dv, row * D + 8 * j + 2 * t, dv[j][2 * i], dv[j][2 * i + 1],
             a.dv_dtype);
    }
  }
}

// ---- K3/K4/K5: the forward on the tensor cores ----------------------------
//
// flash_out_kernel (K3), flash_lse_kernel (K4) and flash_stats_kernel (K5)
// are one body, flash_fwd_tc<T, D, Mode>, that differs only in what it
// stores. A block
// is 4 warps and owns 64 query rows of one (batch, head); a warp owns 16
// of them. Q is resident: loaded once, bf16 rows by cp.async, f32 rows as
// kF32Planes bf16 planes. K and V stream in by cp.async in tiles of kN
// keys over band(), tile j + 1 in flight while tile j is multiplied (the
// K6 plan: two stages for bf16; for f32 one stage of planes beside the raw
// rows the copies land in, split once they land). Per tile, each warp:
//   S = Q K^T by mma.sync m16n8k16 (K read by ldmatrix), scaled into base-2
//     units (scale * log2(e) folded in, exp2 below);
//   runs the online softmax on the accumulator fragments: a lane holds two
//     rows (g and g + 8 of the warp's 16), their tile max reduces over the
//     lane's quad (__shfl_xor_sync 1, 2), the running max m rescales l and
//     the O accumulators by alpha = exp2(m_old - m_new) in registers;
//   O += P V, P repacked from the S accumulators as the A operand
//     (acc_to_a), never through shared memory; V read by ldmatrix.trans.
// score_live() runs only on tiles that tile_all_live() does not clear. A
// masked score is kNegInf and its p exactly 0, also in a row with no live
// key so far; a row that never sees one is stored as dead (K5: exactly
// m = -1e30, l = 0, acc = 0, which the ring merge relies on).
//
// Precision by instance (tests/test_torch_flash_split.py emulates each
// against the JAX package's forward and stats):
//   bf16 inputs: S exact in one product; P rounded to bf16 once for P V,
//     as FlashAttention-2 does (l sums the unrounded f32 p). K5 splits P
//     into kStatsBf16Terms = 3 terms, as the Pallas kernel keeps P in f32
//     for P V: one term held K5 to its own pins (acc / l at 11% of the
//     1e-2 x max|out| gate in the emulation, 15% on an H100), but the
//     2-rank SP run's step-10 loss then lay 1.65e-3 from the ring-free
//     run's (gate 1e-3; 3.7e-5 with P in f32): AdamW turns the rounding
//     noise of gradients that are near 0 into steps of lr either way.
//   f32 inputs: q, k, v as kF32Planes bf16 planes and P as as many terms,
//     six products each through mma_split. Two planes reach 3.6e-5 on out
//     (pin 5e-6), two P terms 6.6e-6: the forward needs the backward's three.
//
// Tiles. kN = 64 keys for bf16. f32 streams 32: its raw rows and three
// planes of K and V at 64 keys would take 116 KB, one block an SM; at 32
// they take 72 KB, three. Ragged edges: a warp whose 16 rows lie past
// q_len skips its products (it still meets every __syncthreads), and S's
// n8 column tiles and P V's k16 steps wholly past kv_len are skipped. At
// the ViT's 257 tokens = 4 * 64 + 1, 64 x 64 tiles make 25 tile pairs for
// 16.1 tiles of real work (1.55x; f32's 64 x 32 tiles, 45 for 32.3); with
// the skips S issues 272 x 264 and P V 272 x 272 of the 257 x 257 scores
// (1.09x and 1.12x).
template <typename T, int D>
using FwdPlan = TilePlan<T, D, std::is_same<T, float>::value ? 32 : 64, 1, 0>;

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// c = A B^T for one warp over D: A the warp's 16 resident rows at `a`
// (plane stride kTcRows * LD), B the kN streamed rows at `b` (plane stride
// kN * LD). n8 column tiles at or past `live` are skipped (left 0). With
// split operands each k16 step sums its six products in a fresh
// accumulator, added to c in f32: the tensor cores truncate the sums they
// accumulate, and a chain of 6 * D / 16 products into c carries that bias
// into the scores. On an H100 at the ViT's shape, f32 out was up to 7.3e-6
// off the plain version (pin 5e-6) with one chain for S and one for O
// across tiles, 1.7e-6 with both fresh.
template <int D, typename P>
__device__ __forceinline__ void score_strip(float (&c)[P::kN / 8][4],
                                            const bf16* a, const bf16* b,
                                            int live, int lane) {
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
  zero(c);
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t x[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldsm4(x[p], a + p * kTcRows * LD + a_off + 16 * kk);
    auto products = [&](float (&d)[kN / 8][4]) {
#pragma unroll
      for (int jj = 0; jj < kN / 16; ++jj) {
        if (16 * jj >= live) continue;
        uint32_t y[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          ldsm4(y[p], b + p * kN * LD + 16 * jj * LD + b_off + 16 * kk);
        mma_split<NP, NP>(d[2 * jj], x, y, 0);
        if (16 * jj + 8 < live) mma_split<NP, NP>(d[2 * jj + 1], x, y, 1);
      }
    };
    if constexpr (NP == 1) {
      products(c);
    } else {
      float t[kN / 8][4];
      zero(t);
      products(t);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] += t[j][e];
    }
  }
}

// 2^x by the SFU, subnormal results flushed to 0 (as --use_fast_math's
// exp2f; a softmax weight under 2^-126 is 0 for every pin here).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the quad of lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D, int Mode>
__device__ __forceinline__ void flash_fwd_tc(const FwdArgs& a) {
  using P = FwdPlan<T, D>;
  constexpr int NP = P::kNP, LD = P::LD, kN = P::kN;
  // Terms of P in P V: as many as V has planes; K5's bf16 instance
  // kStatsBf16Terms.
  constexpr int NT = P::kF32 ? NP : (Mode == kStats ? kStatsBf16Terms : 1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem sm = tile_smem<P>(smem_raw);
  const bf16* sq = sm.res;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const T* q = slice<T>(a.q, a.qs, b, h);
  const T* k = slice<T>(a.k, a.ks, b, h);
  const T* v = slice<T>(a.v, a.vs, b, h);
  const bool has_seg = a.qseg != nullptr;
  load_resident<T, D, NP>(sm.res, q, a.qs[1], row0, a.m.q_len);
  cp_async_commit();

  int qseg_r[2];  // this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    qseg_r[i] = has_seg && r < a.m.q_len
                    ? a.qseg[(int64_t)b * a.m.q_len + r]
                    : 0;
  }
  const float sl2 = a.scale * kLog2e;

  const int rows_hi = min(row0 + kTcRows, a.m.q_len);
  const Range kr = band(a.m, row0, rows_hi, false);
  const int first = (kr.lo / kN) * kN;
  const int n_tiles = kr.hi > kr.lo ? (kr.hi - first + kN - 1) / kN : 0;
  auto issue = [&](int it) {
    const int c0 = first + it * kN;
    issue_tile<T, D, P>(sm, it, k, a.ks[1], v, a.vs[1], c0, a.m.kv_len);
    if (has_seg)
      for (int r = threadIdx.x; r < kN; r += kTcThreads) {
        const bool valid = c0 + r < a.m.kv_len;
        cp_async4(sm.seg + (it & 1) * kN + r,
                  a.kseg + (int64_t)b * a.m.kv_len + (valid ? c0 + r : 0),
                  valid);
      }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  // Running max of the lane's two rows (unscaled, and ms in base-2 units)
  // and normalizer; l is the lane's share, reduced over the quad at the
  // end.
  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, ms[2] = {0.0f, 0.0f},
                       l[2] = {0.0f, 0.0f};
  zero(acc);
  const bool warp_live = row0 + 16 * warp < a.m.q_len;

  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = first + it * kN;
    const bf16* sk = land_tile<T, D, P>(sm, it);
    const bf16* sv = sk + NP * kN * LD;
    if (it + 1 < n_tiles) issue(it + 1);
    if (!warp_live) continue;
    const int live = a.m.kv_len - c0;  // columns inside the key axis
    float s[kN / 8][4];
    score_strip<D, P>(s, sq + 16 * warp * LD, sk, live, lane);
    const int* kseg = sm.seg + (it & 1) * kN;
    float alpha[2];  // rescale of O and l for this tile
    auto softmax = [&](auto masked) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, cl = 8 * j + 2 * t + (e & 1);
          if constexpr (decltype(masked)::value)
            if (!score_live(a.m, row0 + 16 * warp + g + 8 * i, c0 + cl,
                            qseg_r[i], has_seg ? kseg[cl] : 0))
              s[j][e] = kNegInf;
          mx[i] = fmaxf(mx[i], s[j][e]);
        }
      // p = exp2(s * sl2 - ms): ms is the row max in base-2 units, or 0
      // while the row has no live key, so that its masked scores give
      // exp2(-1e30 * sl2) = 0 and l and acc stay exactly 0 until one
      // arrives (alpha = 0 then). alpha takes the difference of the kept,
      // rounded ms: recomputing the old one as m * sl2 - ms contracts to
      // an FMA whose alpha is 1 - 2e-7, not 1, on every tile (lse off by
      // 2.3e-5 after 127 tiles at 8,100 keys).
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        const float ms_new = mx[i] == kNegInf ? 0.0f : mx[i] * sl2;
        alpha[i] = m[i] == kNegInf ? 0.0f : fast_exp2(ms[i] - ms_new);
        m[i] = mx[i];
        ms[i] = ms_new;
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -ms[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], sum[i]);
    };
    if (tile_all_live(a.m, has_seg, row0 + 16 * warp + 16, c0 + kN))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    // O = alpha O + P V, P as NT terms. With split operands the tile's
    // products go to a fresh accumulator first, as in score_strip.
    if constexpr (NP == 1 && NT == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      accumulate<D, NT, P>(acc, s, sv, live, lane);
    } else {
      float o[D / 8][4];
      zero(o);
      accumulate<D, NT, P>(o, s, sv, live, lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], o[j][e]);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    if (r >= a.m.q_len) continue;
    const bool dead = m[i] == kNegInf;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
    if constexpr (Mode == kStats) {
      // K5: acc unnormalized in f32; m in the units of the scaled scores
      // (the max of s * scale is the rounded m * scale: scale > 0); l
      // relative to exp2(s * sl2 - ms), which is exp(s * scale - m).
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(a.out, row * D + 8 * j + 2 * t, dead ? 0.0f : acc[j][2 * i],
               dead ? 0.0f : acc[j][2 * i + 1], kF32);
      if (t == 0) {
        a.m_out[row] = dead ? kNegInf : m[i] * a.scale;
        a.l_out[row] = dead ? 0.0f : l[i];
      }
    } else {
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(a.out, row * D + 8 * j + 2 * t,
               dead ? 0.0f : acc[j][2 * i] * inv,
               dead ? 0.0f : acc[j][2 * i + 1] * inv, a.dtype);
      if (Mode == kLse && t == 0)
        a.lse[row] = dead ? kDeadLse : fmaf(m[i], a.scale, logf(l[i]));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_out_kernel(FwdArgs a) {
  flash_fwd_tc<T, D, kOut>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_lse_kernel(FwdArgs a) {
  flash_fwd_tc<T, D, kLse>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_stats_kernel(FwdArgs a) {
  flash_fwd_tc<T, D, kStats>(a);
}

// Calls f(T*{}, integral_constant<D>) for the input dtype and head dim the
// kernels were built for; anything else is cudaErrorInvalidValue.
template <typename F>
int dispatch(int dtype, int d, F&& f) {
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  if (dtype == kF32) {
    if (d == 32) return f((float*)nullptr, I32{});
    if (d == 64) return f((float*)nullptr, I64{});
    if (d == 128) return f((float*)nullptr, I128{});
  } else if (dtype == kBF16) {
    if (d == 32) return f((__nv_bfloat16*)nullptr, I32{});
    if (d == 64) return f((__nv_bfloat16*)nullptr, I64{});
    if (d == 128) return f((__nv_bfloat16*)nullptr, I128{});
  }
  return (int)cudaErrorInvalidValue;
}

// Every kernel is kTcWarps warps of kTcThreads threads.
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, int grid_x, int grid_y,
           int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(grid_x, grid_y), kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dispatch() for the backward, adding the P/dS term count of the instance
// (f32 inputs: kF32Planes; bf16 inputs: kRingTerms when a gradient is f32,
// else kBf16Terms) as a third integral_constant.
template <typename F>
int dispatch_bwd(int dtype, int d, bool f32_grads, F&& f) {
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    if constexpr (std::is_same<T, float>::value) {
      return f(t, dd, std::integral_constant<int, kF32Planes>{});
    } else {
      return f32_grads ? f(t, dd, std::integral_constant<int, kRingTerms>{})
                       : f(t, dd, std::integral_constant<int, kBf16Terms>{});
    }
  });
}

Mask make_mask(int sq, int skv, int causal, int window, int kv_start) {
  Mask m;
  m.q_len = sq;
  m.kv_len = skv;
  m.kv_start = kv_start;
  m.window = window;
  m.causal = causal;
  return m;
}

int fwd(FwdMode mode, const void* q, const void* k, const void* v,
        const int* qseg, const int* kseg, void* out, float* lse,
        float* m_out, float* l_out, int dtype, int batch, int heads, int sq,
        int skv, int d, const int64_t* strides, float scale, int causal,
        int window, int kv_start, cudaStream_t stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = qseg;
  a.kseg = kseg;
  a.out = out;
  a.lse = lse;
  a.m_out = m_out;
  a.l_out = l_out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  a.heads = heads;
  a.dtype = dtype;
  a.scale = scale;
  a.m = make_mask(sq, skv, causal, window, kv_start);
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    void (*kernel)(FwdArgs) = mode == kStats ? flash_stats_kernel<T, kD>
                              : mode == kLse ? flash_lse_kernel<T, kD>
                                             : flash_out_kernel<T, kD>;
    return launch(kernel, a, batch * heads, (sq + kTcRows - 1) / kTcRows,
                  FwdPlan<T, kD>::bytes, stream);
  });
}

BwdArgs bwd_args(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* qseg, const int* kseg, int heads, int sq,
                 int skv, const int64_t* strides, float scale, int causal,
                 int window, int kv_start) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.qseg = qseg;
  a.kseg = kseg;
  a.dq = a.dk = a.dv = nullptr;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.ds[i] = strides[9 + i];
  }
  a.heads = heads;
  a.dq_dtype = a.dk_dtype = a.dv_dtype = kF32;
  a.scale = scale;
  a.m = make_mask(sq, skv, causal, window, kv_start);
  return a;
}

}  // namespace

extern "C" {

// Strides: 9 int64 (q, k, v; each B, S, H) for the forward, 12 (q, k, v,
// dO) for the backward, in elements. dtype: 0 = f32, 1 = bf16. window 0 =
// none. Each returns cudaGetLastError() after its launch (0 = launched).

// K3: out only.
int flash_fwd_out(const void* q, const void* k, const void* v,
                  const int* qseg, const int* kseg, void* out, int dtype,
                  int batch, int heads, int sq, int skv, int d,
                  const int64_t* strides, float scale, int causal, int window,
                  int kv_start, cudaStream_t stream) {
  return fwd(kOut, q, k, v, qseg, kseg, out, nullptr, nullptr, nullptr, dtype,
             batch, heads, sq, skv, d, strides, scale, causal, window,
             kv_start, stream);
}

// K4: out and the row logsumexp.
int flash_fwd_lse(const void* q, const void* k, const void* v,
                  const int* qseg, const int* kseg, void* out, float* lse,
                  int dtype, int batch, int heads, int sq, int skv, int d,
                  const int64_t* strides, float scale, int causal, int window,
                  int kv_start, cudaStream_t stream) {
  return fwd(kLse, q, k, v, qseg, kseg, out, lse, nullptr, nullptr, dtype,
             batch, heads, sq, skv, d, strides, scale, causal, window,
             kv_start, stream);
}

// K5: the unnormalized f32 acc [B, Sq, H, D], row max m and normalizer l
// [B, Sq, H] (f32 for f32 and bf16 inputs alike).
int flash_fwd_stats(const void* q, const void* k, const void* v,
                    const int* qseg, const int* kseg, float* acc, float* m,
                    float* l, int dtype, int batch, int heads, int sq,
                    int skv, int d, const int64_t* strides, float scale,
                    int causal, int window, int kv_start,
                    cudaStream_t stream) {
  return fwd(kStats, q, k, v, qseg, kseg, acc, nullptr, m, l, dtype, batch,
             heads, sq, skv, d, strides, scale, causal, window, kv_start,
             stream);
}

// K6: dQ.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* qseg, const int* kseg, void* dq, int dtype,
                 int dq_dtype, int batch, int heads, int sq, int skv, int d,
                 const int64_t* strides, float scale, int causal, int window,
                 int kv_start, cudaStream_t stream) {
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, qseg, kseg, heads, sq, skv,
                       strides, scale, causal, window, kv_start);
  a.dq = dq;
  a.dq_dtype = dq_dtype;
  return dispatch_bwd(dtype, d, dq_dtype == kF32, [&](auto t, auto dd,
                                                      auto nt) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return launch(flash_dq_kernel<T, kD, decltype(nt)::value>, a,
                  batch * heads, (sq + kTcRows - 1) / kTcRows,
                  BwdPlan<T, kD, false>::bytes, stream);
  });
}

// K7: dK and dV.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const int* qseg, const int* kseg, void* dk, void* dv,
                  int dtype, int dk_dtype, int dv_dtype, int batch, int heads,
                  int sq, int skv, int d, const int64_t* strides, float scale,
                  int causal, int window, int kv_start, cudaStream_t stream) {
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, qseg, kseg, heads, sq, skv,
                       strides, scale, causal, window, kv_start);
  a.dk = dk;
  a.dv = dv;
  a.dk_dtype = dk_dtype;
  a.dv_dtype = dv_dtype;
  return dispatch_bwd(dtype, d, dk_dtype == kF32 || dv_dtype == kF32,
                      [&](auto t, auto dd, auto nt) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return launch(flash_dkv_kernel<T, kD, decltype(nt)::value>, a,
                  batch * heads, (skv + kTcRows - 1) / kTcRows,
                  BwdPlan<T, kD, true>::bytes, stream);
  });
}

// The dynamic shared memory K6 (dkv 0) or K7 (dkv 1) launches with for
// this input dtype and head dim, for reports.
int flash_bwd_smem_bytes(int dkv, int dtype, int d) {
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return dkv ? BwdPlan<T, kD, true>::bytes : BwdPlan<T, kD, false>::bytes;
  });
}

// The same for K3/K4 (stats 0) or K5 (stats 1): one plan for all three.
int flash_fwd_smem_bytes(int stats, int dtype, int d) {
  (void)stats;
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return FwdPlan<T, kD>::bytes;
  });
}

}  // extern "C"
