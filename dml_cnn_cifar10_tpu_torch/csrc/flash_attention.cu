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
// alike (bf16 tiles are widened to f32 in shared memory); outputs are
// rounded to their dtype on the store. Masked scores are NEG_INF = -1e30,
// never -inf. A row with no live key (every key masked: causal/window
// bands, segments, kv_start, cross lengths) outputs exactly 0 and publishes
// lse = 1e30, so the backward's p = exp(s - lse) is exactly 0 there.
//
// Design. A block owns one 64-row tile of one (batch, head): query rows
// for K3/K4/K5/K6, key rows for K7. It initialises its own m, l and
// accumulators, then walks the 64-wide tiles of the other axis in a loop
// (the Pallas grid's sequential inner axis becomes this loop; CUDA blocks
// share no state). K3, K4 and K5 are one body, flash_fwd<T, D, Mode>,
// that differs only in what it stores. band() gives that loop's bounds
// from the causal/window band, one definition for all five kernels;
// score_live() is the element
// mask inside it, so the skip logic cannot drift from the mask (the role
// of _band_live, :481). Ragged edges are bounds-checked in the kernel:
// nothing is padded to the tile size. 256 threads as 16 x 16; a thread
// owns a 4 x 4 micro-tile of the 64 x 64 score tile (rows ty + 16i, cols
// tx + 16j, strided so shared-memory rows of stride D + 1 fall in distinct
// banks) and 4 x D/16 of the output tile; row max and row sums reduce over
// the 16 lanes that share a row with warp shuffles.
//
// What bounds them on an H100 SXM. The work is 4*B*H*Sq*Skv_live*D FLOPs
// forward, 6*... for dQ and 8*... for dK/dV; at the ViT main path's
// [128, 257, 3, 64] f32 the forward is 6.5 GFLOP, ~0.1 ms at the card's
// 67 TFLOP/s of f32 on the CUDA cores, while its bytes (q, k, v, out:
// 101 MB) take 0.03 ms at 3.35 TB/s, so operations bound it. In bf16 the
// same FLOPs could run on the tensor cores at 989 TFLOP/s, and the long
// [2, 8100, 3, 64] bf16 shape is operation-bound there too. K5 does K4's
// FLOPs and writes its acc in f32; at the ring's [2, 4050, 3, 64] bf16
// block (two ranks of the 8,100-token recipe) it is operation-bound as
// well: 25.2 GFLOP (25 us at 989 TFLOP/s) against 15.7 MB of inputs
// and outputs (4.7 us at 3.35 TB/s).
//
// What this simple design leaves on the table: every product runs as f32
// FMAs on the CUDA cores from shared memory (no wgmma/mma.sync tensor-core
// path, even for bf16), tiles are loaded synchronously by all threads
// (no TMA, no cp.async double buffering), a ragged last tile (257 = 4 x 64
// + 1) costs a full tile's work, and K7 recomputes the scores that K6
// already built. Those are the next PRs' work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kTile = 64;           // rows of a block's tile = cols of a step
constexpr int kTx = 16, kTy = 16;   // thread grid of a block
constexpr int kThreads = kTx * kTy;
constexpr int kRows = kTile / kTy;  // micro-tile rows per thread
constexpr int kCols = kTile / kTx;  // micro-tile cols per thread
constexpr int kPld = kTile + 1;     // row stride of a score tile in smem
constexpr float kNegInf = -1e30f;   // masked score (not -inf: no NaN rows)
constexpr float kDeadLse = 1e30f;   // lse of a row with no live key

enum DType { kF32 = 0, kBF16 = 1 };
// What the forward body stores: K3 out; K4 out and lse; K5 acc, m and l.
enum FwdMode { kOut = 0, kLse = 1, kStats = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(void* base, int64_t i, float v,
                                      int dtype) {
  if (dtype == kF32) {
    static_cast<float*>(base)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  }
}

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
// ids (equal when the call has none).
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

// Rows [row0, row0 + kTile) of one (batch, head) slice into shared memory
// as f32 (row stride D + 1), zeros past `len`. `src` points at row 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int len) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < len ? to_f32(src[(int64_t)row * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* seg, int b,
                                         int len, int row0) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    dst[r] = (seg != nullptr && row < len) ? seg[(int64_t)b * len + row] : 0;
  }
}

// Reductions over the 16 lanes that hold one row (lanes ty*16 .. +15).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (D + 1) + kTile * kPld) * 4 + 2 * kTile * 4;
}

template <typename T, int D, int Mode>
__device__ __forceinline__ void flash_fwd(const FwdArgs& a) {
  constexpr int LD = D + 1, kC = D / kTx;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;
  int* sqseg = reinterpret_cast<int*>(sp + kTile * kPld);
  int* skseg = sqseg + kTile;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  load_tile<T, D>(sq, q, a.qs[1], row0, a.m.q_len);
  load_seg(sqseg, a.qseg, b, a.m.q_len, row0);

  float m_i[kRows], l_i[kRows], acc[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;
  }

  const int rows_hi = min(row0 + kTile, a.m.q_len);
  const Range kr = band(a.m, row0, rows_hi, false);
  for (int c0 = (kr.lo / kTile) * kTile; c0 < kr.hi; c0 += kTile) {
    __syncthreads();  // the previous step's readers are done
    load_tile<T, D>(sk, k, a.ks[1], c0, a.m.kv_len);
    load_tile<T, D>(sv, v, a.vs[1], c0, a.m.kv_len);
    load_seg(skseg, a.kseg, b, a.m.kv_len, c0);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(ty + kTy * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sk[(tx + kTx * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTy * i;
      bool live[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTx * j;
        live[j] = score_live(a.m, row0 + r, c0 + c, sqseg[r], skseg[c]);
        s[i][j] = live[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        sp[r * kPld + tx + kTx * j] = p;
        sum += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = sv[j * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = sp[(ty + kTy * i) * kPld + j];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + ty + kTy * i;
    if (r >= a.m.q_len) continue;
    const bool dead = m_i[i] <= kNegInf * 0.5f;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
    if constexpr (Mode == kStats) {
      float* acc_out = static_cast<float*>(a.out);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        acc_out[row * D + tx + kTx * c] = dead ? 0.0f : acc[i][c];
      if (tx == 0) {
        a.m_out[row] = dead ? kNegInf : m_i[i];
        a.l_out[row] = dead ? 0.0f : l_i[i];
      }
    } else {
      const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        store(a.out, row * D + tx + kTx * c, dead ? 0.0f : acc[i][c] / l,
              a.dtype);
      if (Mode == kLse && tx == 0)
        a.lse[row] = dead ? kDeadLse : m_i[i] + logf(l);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_out_kernel(FwdArgs a) {
  flash_fwd<T, D, kOut>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_lse_kernel(FwdArgs a) {
  flash_fwd<T, D, kLse>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_stats_kernel(FwdArgs a) {
  flash_fwd<T, D, kStats>(a);
}

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

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 1) + kTile * kPld) * 4 + 2 * kTile * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + 1) + 2 * kTile * kPld + 2 * kTile) * 4 +
         2 * kTile * 4;
}

// K6: one block per 64 query rows; walks the key tiles of its band.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  constexpr int LD = D + 1, kC = D / kTx;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;
  int* sqseg = reinterpret_cast<int*>(sds + kTile * kPld);
  int* skseg = sqseg + kTile;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const T* dout = static_cast<const T*>(a.dout) + b * a.ds[0] + h * a.ds[2];
  load_tile<T, D>(sq, q, a.qs[1], row0, a.m.q_len);
  load_tile<T, D>(sdo, dout, a.ds[1], row0, a.m.q_len);
  load_seg(sqseg, a.qseg, b, a.m.q_len, row0);

  float lse_i[kRows], delta_i[kRows], acc[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + ty + kTy * i;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
    lse_i[i] = r < a.m.q_len ? a.lse[row] : kDeadLse;
    delta_i[i] = r < a.m.q_len ? a.delta[row] : 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;
  }

  const int rows_hi = min(row0 + kTile, a.m.q_len);
  const Range kr = band(a.m, row0, rows_hi, false);
  for (int c0 = (kr.lo / kTile) * kTile; c0 < kr.hi; c0 += kTile) {
    __syncthreads();
    load_tile<T, D>(sk, k, a.ks[1], c0, a.m.kv_len);
    load_tile<T, D>(sv, v, a.vs[1], c0, a.m.kv_len);
    load_seg(skseg, a.kseg, b, a.m.kv_len, c0);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sq[(ty + kTy * i) * LD + d];
        ov[i] = sdo[(ty + kTy * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = sk[(tx + kTx * j) * LD + d];
        vv[j] = sv[(tx + kTx * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTx * j;
        const bool live =
            score_live(a.m, row0 + r, c0 + c, sqseg[r], skseg[c]);
        const float p = live ? expf(s[i][j] * a.scale - lse_i[i]) : 0.0f;
        sds[r * kPld + c] = p * (dp[i][j] - delta_i[i]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kk[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) kk[c] = sk[j * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float g = sds[(ty + kTy * i) * kPld + j];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(g, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + ty + kTy * i;
    if (r >= a.m.q_len) continue;
    const int64_t row = ((int64_t)b * a.m.q_len + r) * a.heads + h;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      store(a.dq, row * D + tx + kTx * c, acc[i][c], a.dq_dtype);
  }
}

// K7: one block per 64 key rows; walks the query tiles of its band. A
// thread's micro-tile is transposed: rows are keys (ty + 16i), columns
// are queries (tx + 16j).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  constexpr int LD = D + 1, kC = D / kTx;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* spt = sdo + kTile * LD;
  float* sdst = spt + kTile * kPld;
  float* slse = sdst + kTile * kPld;
  float* sdelta = slse + kTile;
  int* sqseg = reinterpret_cast<int*>(sdelta + kTile);
  int* skseg = sqseg + kTile;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int col0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const T* dout = static_cast<const T*>(a.dout) + b * a.ds[0] + h * a.ds[2];
  load_tile<T, D>(sk, k, a.ks[1], col0, a.m.kv_len);
  load_tile<T, D>(sv, v, a.vs[1], col0, a.m.kv_len);
  load_seg(skseg, a.kseg, b, a.m.kv_len, col0);

  float dk[kRows][kC], dv[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int cols_hi = min(col0 + kTile, a.m.kv_len);
  const Range qr = band(a.m, col0, cols_hi, true);
  for (int r0 = (qr.lo / kTile) * kTile; r0 < qr.hi; r0 += kTile) {
    __syncthreads();
    load_tile<T, D>(sq, q, a.qs[1], r0, a.m.q_len);
    load_tile<T, D>(sdo, dout, a.ds[1], r0, a.m.q_len);
    load_seg(sqseg, a.qseg, b, a.m.q_len, r0);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = r0 + r;
      const int64_t idx = ((int64_t)b * a.m.q_len + row) * a.heads + h;
      slse[r] = row < a.m.q_len ? a.lse[idx] : kDeadLse;
      sdelta[r] = row < a.m.q_len ? a.delta[idx] : 0.0f;
    }
    __syncthreads();

    float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = sk[(ty + kTy * i) * LD + d];
        vv[i] = sv[(ty + kTy * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = sq[(tx + kTx * j) * LD + d];
        ov[j] = sdo[(tx + kTx * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int c = ty + kTy * i;  // key
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = tx + kTx * j;  // query
        const bool live =
            score_live(a.m, r0 + r, col0 + c, sqseg[r], skseg[c]);
        const float p = live ? expf(st[i][j] * a.scale - slse[r]) : 0.0f;
        spt[c * kPld + r] = p;
        sdst[c * kPld + r] = p * (dpt[i][j] - sdelta[r]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float ov[kC], qv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        ov[c] = sdo[r * LD + tx + kTx * c];
        qv[c] = sq[r * LD + tx + kTx * c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = spt[(ty + kTy * i) * kPld + r];
        const float g = sdst[(ty + kTy * i) * kPld + r];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dv[i][c] = fmaf(p, ov[c], dv[i][c]);
          dk[i][c] = fmaf(g, qv[c], dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = col0 + ty + kTy * i;
    if (c >= a.m.kv_len) continue;
    const int64_t row = ((int64_t)b * a.m.kv_len + c) * a.heads + h;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      store(a.dk, row * D + tx + kTx * cc, dk[i][cc], a.dk_dtype);
      store(a.dv, row * D + tx + kTx * cc, dv[i][cc], a.dv_dtype);
    }
  }
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

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, int grid_x, int grid_y,
           int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

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
    return launch(kernel, a, batch * heads, tiles(sq), fwd_smem_bytes<kD>(),
                  stream);
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
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return launch(flash_dq_kernel<T, kD>, a, batch * heads, tiles(sq),
                  dq_smem_bytes<kD>(), stream);
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
  return dispatch(dtype, d, [&](auto t, auto dd) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(dd)::value;
    return launch(flash_dkv_kernel<T, kD>, a, batch * heads, tiles(skv),
                  dkv_smem_bytes<kD>(), stream);
  });
}

}  // extern "C"
