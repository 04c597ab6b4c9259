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
//
// What it computes (one leaf, in place):
//   plain:    g' = g + wd*p (only when wd != 0);  p = p - lr*g'
//   momentum: g' = g + wd*p (only when wd != 0);  m = mu*m + g';
//             p = p - lr*m
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn), in the order of the JAX package's _xla_leaf (:59), so nvcc
// cannot contract a pair into an FMA: the result equals the plain
// PyTorch expression bit for bit, which runs each op as its own kernel.
// lr is read from a device pointer (a 0-d f32 tensor the schedule
// computes on the card), so the update never waits for the host; wd and
// mu are launch arguments.
//
// What bounds it. The update is a pure elementwise pass: K1 reads p and
// g and writes p (12 B/param), K2 reads p, g, m and writes p, m
// (20 B/param), 3-4 f32 operations per param. For the reference CNN
// (1,068,298 params in 10 leaves) that is 12.8 MB (3.8 us at 3.35 TB/s,
// H100 SXM) and 21.4 MB (6.4 us). Those bytes fit in the card's 50 MB L2,
// where the backward pass has just written the gradients, and a launch
// costs a few microseconds, so at this size the update is bound by its
// 10 launches (one per leaf), not by memory. The design is the simple
// one that is right: a grid-stride loop, float4 loads and stores where
// every pointer of the leaf is 16-byte aligned, and a scalar loop for the
// ragged tail (no padding to the TPU's 8x128 tile). One multi-tensor
// launch over all leaves is the next step for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per H100 SM

__device__ __forceinline__ float decayed(float g, float p, float wd) {
  return wd != 0.0f ? __fadd_rn(g, __fmul_rn(wd, p)) : g;
}

__device__ __forceinline__ float plain_step(float p, float g, float lr,
                                            float wd) {
  return __fsub_rn(p, __fmul_rn(lr, decayed(g, p, wd)));
}

__device__ __forceinline__ float momentum_step(float p, float g, float& m,
                                               float lr, float mu, float wd) {
  m = __fadd_rn(__fmul_rn(mu, m), decayed(g, p, wd));
  return __fsub_rn(p, __fmul_rn(lr, m));
}

__global__ void sgd_plain_kernel(const float* __restrict__ lr_ptr,
                                 float* __restrict__ p,
                                 const float* __restrict__ g, int64_t n,
                                 float wd, bool vec) {
  const float lr = *lr_ptr;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pv = p4[i];
      const float4 gv = g4[i];
      pv.x = plain_step(pv.x, gv.x, lr, wd);
      pv.y = plain_step(pv.y, gv.y, lr, wd);
      pv.z = plain_step(pv.z, gv.z, lr, wd);
      pv.w = plain_step(pv.w, gv.w, lr, wd);
      p4[i] = pv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    p[i] = plain_step(p[i], g[i], lr, wd);
  }
}

__global__ void sgd_momentum_kernel(const float* __restrict__ lr_ptr,
                                    float* __restrict__ p,
                                    const float* __restrict__ g,
                                    float* __restrict__ m, int64_t n,
                                    float mu, float wd, bool vec) {
  const float lr = *lr_ptr;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pv = p4[i];
      const float4 gv = g4[i];
      float4 mv = m4[i];
      pv.x = momentum_step(pv.x, gv.x, mv.x, lr, mu, wd);
      pv.y = momentum_step(pv.y, gv.y, mv.y, lr, mu, wd);
      pv.z = momentum_step(pv.z, gv.z, mv.z, lr, mu, wd);
      pv.w = momentum_step(pv.w, gv.w, mv.w, lr, mu, wd);
      p4[i] = pv;
      m4[i] = mv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mi = m[i];
    p[i] = momentum_step(p[i], g[i], mi, lr, mu, wd);
    m[i] = mi;
  }
}

inline bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
}

inline int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// K1. Returns cudaGetLastError() after the launch (0 = launched).
int sgd_update_plain(const float* lr, float* p, const float* g, int64_t n,
                     float wd, cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(g);
  sgd_plain_kernel<<<blocks_for(vec ? n / 4 : n), kThreads, 0, stream>>>(
      lr, p, g, n, wd, vec);
  return (int)cudaGetLastError();
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
int sgd_update_momentum(const float* lr, float* p, const float* g, float* m,
                        int64_t n, float mu, float wd, cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m);
  sgd_momentum_kernel<<<blocks_for(vec ? n / 4 : n), kThreads, 0, stream>>>(
      lr, p, g, m, n, mu, wd, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
