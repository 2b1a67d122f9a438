// Fused AdamW local step (paper Alg. 2) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/adamw_update.py::_adamw_kernel
// (pallas_call in adamw_update_2d), reached from ops.adamw_update_tree.
//
//   m' = beta1 * m + (1 - beta1) * g
//   v' = beta2 * v + (1 - beta2) * g^2
//   d  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p,  bc = 1 - beta^(step+1)
//   p' = p - lr * d
//
// Two roundings, a template flag:
//   ROUND_DIR = false  computes what _adamw_kernel computes: p' rounded once
//                      to the param dtype; v' as ((1 - beta2) * g) * g.
//   ROUND_DIR = true   computes what the reference TRAINING path computes:
//                      base_opt.adamw's direction d rounded to the param dtype
//                      first, then (p - lr * d) in f32, rounded again; v' as
//                      (1 - beta2) * (g * g).  The two agree for f32 params.
// The bias corrections bc1, bc2 are computed once on the host in f32 and
// passed by value.  p, g in the param dtype (f32 or bf16), m, v f32.
// Updates p, m and v IN PLACE over the whole (W, N) worker buffer.
//
// Bound on an H100 SXM: bytes.  4 reads + 3 writes = 22 B/element with bf16
// params (p, g 2 B; m, v 4 B; p', m', v' written): 10.9 GB for 4 workers of
// GPT-2 small (4 x 123,882,240 elements), so >= 3.25 ms at 3.35 TB/s;
// ~20 flops/element is far below the compute rate.  Design: one launch over
// all leaves of all workers, 16-byte vector accesses, a grid-stride loop
// with 64-bit indices (W * N passes 2^31 for larger models), no shared
// memory, no atomics; a scalar tail covers n % (16 / sizeof(T)).

#include "common.cuh"

namespace {

struct AdamWArgs {
  float lr, bc1, bc2, beta1, omb1, beta2, omb2, eps, wd;
};

template <typename T, bool ROUND_DIR>
__device__ __forceinline__ void adamw_elem(float p, float g, float m, float v,
                                           const AdamWArgs& a, float& p_new, float& m_new,
                                           float& v_new) {
  m_new = a.beta1 * m + a.omb1 * g;
  v_new = ROUND_DIR ? a.beta2 * v + a.omb2 * (g * g) : a.beta2 * v + (a.omb2 * g) * g;
  float d = (m_new / a.bc1) / (sqrtf(v_new / a.bc2) + a.eps) + a.wd * p;
  if (ROUND_DIR) d = rt::to_f32(rt::from_f32<T>(d));
  p_new = p - a.lr * d;
}

template <typename T, bool ROUND_DIR>
__global__ void __launch_bounds__(256)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, int64_t n, AdamWArgs a) {
  constexpr int V = rt::Vec<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / V;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    alignas(16) T pv[V];
    alignas(16) T gv[V];
    alignas(16) float mv[V];
    alignas(16) float vv[V];
    rt::load(p + e, pv);
    rt::load(g + e, gv);
    rt::load(m + e, mv);
    rt::load(v + e, vv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float pn, mn, vn;
      adamw_elem<T, ROUND_DIR>(rt::to_f32(pv[j]), rt::to_f32(gv[j]), mv[j], vv[j], a, pn, mn,
                               vn);
      pv[j] = rt::from_f32<T>(pn);
      mv[j] = mn;
      vv[j] = vn;
    }
    rt::store(p + e, pv);
    rt::store(m + e, mv);
    rt::store(v + e, vv);
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    float pn, mn, vn;
    adamw_elem<T, ROUND_DIR>(rt::to_f32(p[e]), rt::to_f32(g[e]), m[e], v[e], a, pn, mn, vn);
    p[e] = rt::from_f32<T>(pn);
    m[e] = mn;
    v[e] = vn;
  }
}

template <typename T>
int launch(void* p, const void* g, void* m, void* v, int64_t n, AdamWArgs a, int round_dir,
           void* stream) {
  constexpr int threads = 256;
  const int blocks = rt::grid_blocks(n / rt::Vec<T>::N, threads);
  auto s = static_cast<cudaStream_t>(stream);
  if (round_dir)
    adamw_kernel<T, true><<<blocks, threads, 0, s>>>(
        static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
        static_cast<float*>(v), n, a);
  else
    adamw_kernel<T, false><<<blocks, threads, 0, s>>>(
        static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
        static_cast<float*>(v), n, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int adamw_update_f32(void* p, const void* g, void* m, void* v, int64_t n, float lr, float bc1,
                     float bc2, float beta1, float omb1, float beta2, float omb2, float eps,
                     float wd, int round_dir, void* stream) {
  return launch<float>(p, g, m, v, n, AdamWArgs{lr, bc1, bc2, beta1, omb1, beta2, omb2, eps, wd},
                       round_dir, stream);
}

int adamw_update_bf16(void* p, const void* g, void* m, void* v, int64_t n, float lr, float bc1,
                      float bc2, float beta1, float omb1, float beta2, float omb2, float eps,
                      float wd, int round_dir, void* stream) {
  return launch<__nv_bfloat16>(p, g, m, v, n,
                               AdamWArgs{lr, bc1, bc2, beta1, omb1, beta2, omb2, eps, wd},
                               round_dir, stream);
}

const char* adamw_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
