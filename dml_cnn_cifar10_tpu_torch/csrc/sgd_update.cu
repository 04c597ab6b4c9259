// Fused single-pass SGD update for Hopper (sm_90a), with and without
// momentum. Built by dml_cnn_cifar10_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes from ops/optimizer.py (plain C interface).
//
// Replaces the Pallas TPU kernels of dml_cnn_cifar10_tpu/ops/optimizer.py:
//   sgd_update_plain    <- _sgd_kernel_plain (:83), launched by
//                          _pallas_leaf (:105) at the pallas_call (:140)
//   sgd_update_momentum <- _sgd_kernel (:70), pallas_call (:129)
// The Pallas kernel is launched once per leaf; both CUDA kernels take
// every leaf of a step in one launch (a multi-tensor apply), through one
// body, sgd_multi_kernel<kMomentum>.
//
// What it computes (per leaf, in place):
//   plain:    g' = g + wd*p (only when wd != 0);  p = p - lr*g'
//   momentum: g' = g + wd*p (only when wd != 0);  m = mu*m + g';
//             p = p - lr*m
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn), in the order of the JAX package's _xla_leaf (:59), so nvcc
// cannot contract a pair into an FMA: the result equals the plain
// PyTorch expression bit for bit, which runs each op as its own kernel.
// lr is read from a device pointer (a 0-d f32 tensor the schedule
// computes on the card), so the update never waits for the host; wd and
// mu travel in the launch's table.
//
// What bounds it. The update is a pure elementwise pass: K1 reads p and
// g and writes p (12 B/param), K2 reads p, g, m and writes p, m
// (20 B/param), 3-4 f32 operations per param. For the reference CNN
// (1,068,298 params in 10 leaves) that is 12.8 MB (3.8 us at 3.35 TB/s,
// H100 SXM) and 21.4 MB (6.4 us). Those bytes fit in the card's 50 MB L2,
// where the backward pass has just written the gradients, and a launch
// costs a few microseconds of device time and some 17 us of host time
// through ctypes, so at this size the update is bound by its launches,
// not by memory. So each kernel updates every leaf of a step in ONE
// launch: the host passes a table of up to kMaxLeaves leaf records
// ({p, g, n}; K2's {p, g, m, n}) by value (a kernel parameter, under the
// 4 KB limit) with the prefix sums of each leaf's kChunk-element chunks;
// block c finds its leaf by a binary search of those sums and updates its
// chunk, by float4 where the leaf's pointers are 16-byte aligned and
// scalar otherwise and for the ragged tail (no padding to the TPU's
// 8x128 tile). A step with more leaves launches once per kMaxLeaves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;         // leaves one launch takes
constexpr int kChunk = 16 * kThreads;  // elements a block updates

__device__ __forceinline__ float decayed(float g, float p, float wd) {
  return wd != 0.0f ? __fadd_rn(g, __fmul_rn(wd, p)) : g;
}

// One element: p (and, for K2, m) updated in place.
template <bool kMomentum>
__device__ __forceinline__ void sgd_step(float& p, float g, float& m,
                                         float lr, float mu, float wd) {
  if constexpr (kMomentum) {
    m = __fadd_rn(__fmul_rn(mu, m), decayed(g, p, wd));
    p = __fsub_rn(p, __fmul_rn(lr, m));
  } else {
    p = __fsub_rn(p, __fmul_rn(lr, decayed(g, p, wd)));
  }
}

__host__ __device__ inline bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
}

// One leaf of a launch: K1's record, and K2's with its m pointer.
template <bool kMomentum>
struct Leaf {
  float* p;
  const float* g;
  int64_t n;  // > 0
};
template <>
struct Leaf<true> {
  float* p;
  const float* g;
  float* m;
  int64_t n;  // > 0
};

// The kernel parameter of a launch: the leaves, and each leaf's first
// chunk (first[leaves] is the grid size).
template <typename L>
struct LeafTable {
  const float* lr;
  float wd, mu;  // mu: K2 only
  int leaves;
  int first[kMaxLeaves + 1];
  L leaf[kMaxLeaves];
};
// CUDA passes at most 4 KB of kernel parameters; K2's table is the larger.
static_assert(sizeof(LeafTable<Leaf<true>>) <= 4096,
              "the leaf table must fit the kernel parameter space");

struct Chunk {
  int leaf;
  int64_t start, len;  // elements of the leaf
};

// Block c's chunk: the last leaf whose first chunk is <= c.
template <typename L>
__device__ __forceinline__ Chunk chunk_of(const LeafTable<L>& t, int c) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int64_t start = (int64_t)(c - t.first[lo]) * kChunk;
  const int64_t left = t.leaf[lo].n - start;
  return {lo, start, left < kChunk ? left : (int64_t)kChunk};
}

template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
    sgd_multi_kernel(const __grid_constant__ LeafTable<Leaf<kMomentum>> t) {
  const Chunk c = chunk_of(t, blockIdx.x);
  const Leaf<kMomentum>& leaf = t.leaf[c.leaf];
  float* p = leaf.p + c.start;
  const float* g = leaf.g + c.start;
  float* m = nullptr;
  if constexpr (kMomentum) m = leaf.m + c.start;
  const float lr = *t.lr, mu = t.mu, wd = t.wd;
  int64_t done = 0;
  if (aligned16(p) && aligned16(g) && (!kMomentum || aligned16(m))) {
    const int64_t n4 = c.len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = p4[i];
      const float4 gv = g4[i];
      float4 mv = {};
      if constexpr (kMomentum) mv = m4[i];
      sgd_step<kMomentum>(pv.x, gv.x, mv.x, lr, mu, wd);
      sgd_step<kMomentum>(pv.y, gv.y, mv.y, lr, mu, wd);
      sgd_step<kMomentum>(pv.z, gv.z, mv.z, lr, mu, wd);
      sgd_step<kMomentum>(pv.w, gv.w, mv.w, lr, mu, wd);
      p4[i] = pv;
      if constexpr (kMomentum) m4[i] = mv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + threadIdx.x; i < c.len; i += kThreads) {
    float pi = p[i], mi = 0.0f;
    if constexpr (kMomentum) mi = m[i];
    sgd_step<kMomentum>(pi, g[i], mi, lr, mu, wd);
    p[i] = pi;
    if constexpr (kMomentum) m[i] = mi;
  }
}

// One launch over `leaves` (1 .. kMaxLeaves) f32 leaves: leaf i is p[i],
// g[i] (and m[i] for K2) of n[i] > 0 elements. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue without
// launching.
template <bool kMomentum>
int launch_multi(const float* lr, float* const* p, const float* const* g,
                 float* const* m, const int64_t* n, int leaves, float mu,
                 float wd, cudaStream_t stream) {
  if (leaves < 1 || leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable<Leaf<kMomentum>> t;
  t.lr = lr;
  t.wd = wd;
  t.mu = mu;
  t.leaves = leaves;
  int64_t chunks = 0;
  for (int i = 0; i < leaves; ++i) {
    if (n[i] <= 0) return (int)cudaErrorInvalidValue;
    if constexpr (kMomentum) t.leaf[i] = {p[i], g[i], m[i], n[i]};
    else t.leaf[i] = {p[i], g[i], n[i]};
    t.first[i] = (int)chunks;
    chunks += (n[i] + kChunk - 1) / kChunk;
  }
  if (chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  t.first[leaves] = (int)chunks;
  sgd_multi_kernel<kMomentum><<<(unsigned)chunks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 over `leaves` f32 leaves in one launch (launch_multi).
int sgd_update_plain(const float* lr, float* const* p, const float* const* g,
                     const int64_t* n, int leaves, float wd,
                     cudaStream_t stream) {
  return launch_multi<false>(lr, p, g, nullptr, n, leaves, 0.0f, wd, stream);
}

// K2 over `leaves` f32 leaves and their momentum buffers in one launch.
int sgd_update_momentum(const float* lr, float* const* p,
                        const float* const* g, float* const* m,
                        const int64_t* n, int leaves, float mu, float wd,
                        cudaStream_t stream) {
  return launch_multi<true>(lr, p, g, m, n, leaves, mu, wd, stream);
}

}  // extern "C"
