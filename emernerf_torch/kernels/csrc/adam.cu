// L2-then-Adam update with low-precision moment storage (K8).
//
// Replaces: emernerf_tpu/train/optim.py:make_adam (optax
// add_decayed_weights, then _scale_by_adam_lp) with apply_update, which XLA
// fuses into one elementwise pass per parameter.
//
// What bounds it on the H100: bytes.  Per element it reads the fp32 param
// and grad and both moments and writes param and moments back, a few
// FLOPs each; the flagship's 316 M elements move ~6 GB per update, so the
// kernel runs at memory bandwidth.  The plain PyTorch version takes ~15
// full passes for the same update.
//
// Design: one grid-stride elementwise kernel per parameter tensor, in place,
// moments fp32 or bf16 (the four big tables, >= 2^20 elements, store bf16
// moments).  The math follows the reference op for op, each rounded once
// (__fmul_rn etc., no FMA contraction), so kernel and plain version agree
// bit for bit:
//   g' = g + wd * p
//   m  = b1 * m + (1 - b1) * g'        (fp32, then rounded to storage)
//   v  = b2 * v + ((1 - b2) * g') * g' (fp32, then rounded to storage)
//   p  = p + (-lr) * ((m / c1) / (sqrt(v / c2) + eps))
// where m and v are the STORED (rounded) moments, as the reference's
// direction() reads them.  A null grad is a zero grad (the parameter was
// not used by the branch; Adam still decays its moments).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct AdamHyper {
  float weight_decay, b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, neg_lr;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename M>
__global__ void adam_kernel(float* __restrict__ param, const float* __restrict__ grad,
                            M* __restrict__ mu, M* __restrict__ nu, long long n,
                            const AdamHyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const float p = param[i];
    const float g0 = grad != nullptr ? grad[i] : 0.f;
    const float g = __fadd_rn(g0, __fmul_rn(h.weight_decay, p));
    const float m = __fadd_rn(__fmul_rn(h.b1, to_f(mu[i])), __fmul_rn(h.one_minus_b1, g));
    const float v = __fadd_rn(__fmul_rn(h.b2, to_f(nu[i])),
                              __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
    from_f(mu + i, m);
    from_f(nu + i, v);
    const float ms = to_f(mu[i]), vs = to_f(nu[i]);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vs, h.c2)), h.eps);
    const float dir = __fdiv_rn(__fdiv_rn(ms, h.c1), den);
    param[i] = __fadd_rn(p, __fmul_rn(h.neg_lr, dir));
  }
}

}  // namespace

extern "C" int emt_adam(void* param, const void* grad, void* mu, void* nu,
                        int moments_bf16, long long n, const void* hyper,
                        void* stream) {
  if (n == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(param);
  const float* g = static_cast<const float*>(grad);
  if (moments_bf16)
    adam_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, g, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), n, h);
  else
    adam_kernel<float><<<blocks, threads, 0, s>>>(
        p, g, static_cast<float*>(mu), static_cast<float*>(nu), n, h);
  return static_cast<int>(cudaGetLastError());
}
