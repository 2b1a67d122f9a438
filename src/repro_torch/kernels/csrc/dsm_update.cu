// Fused global sign-momentum step of DSM (paper eqs. 6-8) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/dsm_update.py::_dsm_kernel
// (pallas_call in dsm_update_2d), reached from ops.dsm_update_tree.
//
//   delta = (x0 - x_tau) / gamma
//   u     = beta1 * m + (1 - beta1) * delta
//   x0'   = x0 - (eta * gamma) * (sign(u) + lam * x0)
//   m'    = beta2 * m + (1 - beta2) * delta
//
// x0 and x_tau are in the param dtype (f32 or bf16), m is f32; all
// arithmetic is f32 in the reference's order, with a true division by gamma
// and sign(0) = 0, sign(NaN) = NaN.  Updates x0 and m IN PLACE.
//
// Bound on an H100 SXM: bytes.  3 reads + 2 writes = 14 B/element with bf16
// params (x0, x_tau 2 B; m 4 B; x0', m' written), 1.73 GB for GPT-2 small's
// N = 123,882,240, so >= 0.52 ms at 3.35 TB/s; ~12 flops/element is far
// below the card's compute rate.  Design: one pass over the whole flat
// parameter buffer (all leaves in one launch, no per-leaf padding), 16-byte
// vector loads and stores, a grid-stride loop with 64-bit indices, no
// shared memory, no atomics; the scalar tail covers n % (16 / sizeof(T)).

#include "common.cuh"

namespace {

struct DsmArgs {
  float gamma, eta_gamma, beta1, omb1, beta2, omb2, lam;
};

__device__ __forceinline__ void dsm_elem(float x0, float m, float xt, const DsmArgs& a,
                                         float& x_new, float& m_new) {
  const float delta = (x0 - xt) / a.gamma;
  const float u = a.beta1 * m + a.omb1 * delta;
  const float s = u > 0.f ? 1.f : (u < 0.f ? -1.f : u);
  x_new = x0 - a.eta_gamma * (s + a.lam * x0);
  m_new = a.beta2 * m + a.omb2 * delta;
}

template <typename T>
__global__ void __launch_bounds__(256)
dsm_kernel(T* __restrict__ x0, float* __restrict__ m, const T* __restrict__ xt,
           int64_t n, DsmArgs a) {
  constexpr int V = rt::Vec<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / V;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    alignas(16) T xv[V];
    alignas(16) T tv[V];
    alignas(16) float mv[V];
    rt::load(x0 + e, xv);
    rt::load(xt + e, tv);
    rt::load(m + e, mv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xn, mn;
      dsm_elem(rt::to_f32(xv[j]), mv[j], rt::to_f32(tv[j]), a, xn, mn);
      xv[j] = rt::from_f32<T>(xn);
      mv[j] = mn;
    }
    rt::store(x0 + e, xv);
    rt::store(m + e, mv);
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    float xn, mn;
    dsm_elem(rt::to_f32(x0[e]), m[e], rt::to_f32(xt[e]), a, xn, mn);
    x0[e] = rt::from_f32<T>(xn);
    m[e] = mn;
  }
}

template <typename T>
int launch(void* x0, void* m, const void* xt, int64_t n, DsmArgs a, void* stream) {
  constexpr int threads = 256;
  const int blocks = rt::grid_blocks(n / rt::Vec<T>::N, threads);
  dsm_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x0), static_cast<float*>(m), static_cast<const T*>(xt), n, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dsm_update_f32(void* x0, void* m, const void* xt, int64_t n, float gamma,
                   float eta_gamma, float beta1, float omb1, float beta2, float omb2,
                   float lam, void* stream) {
  return launch<float>(x0, m, xt, n, DsmArgs{gamma, eta_gamma, beta1, omb1, beta2, omb2, lam},
                       stream);
}

int dsm_update_bf16(void* x0, void* m, const void* xt, int64_t n, float gamma,
                    float eta_gamma, float beta1, float omb1, float beta2, float omb2,
                    float lam, void* stream) {
  return launch<__nv_bfloat16>(x0, m, xt, n,
                               DsmArgs{gamma, eta_gamma, beta1, omb1, beta2, omb2, lam}, stream);
}

const char* dsm_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
