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
//
// K11, the explicit-collective data-parallel step's Adam, three entry
// points.  Replaces: emernerf_tpu/parallel/spmd.py:_adam_direction (:96)
// and spmd_apply_update (:107-153), which XLA fuses per leaf inside the
// shard_map step.  Unlike K8 the direction reads the UNROUNDED fp32
// moments; the stored moments are rounded once, after.
//   emt_spmd_adam      a replicated leaf (:141-143): g' = g + wd * p, the
//                      moments, p + (-lr) * dir;
//   emt_zero_slab      this rank's slab of a ZeRO-routed leaf (:127-136):
//                      g = float(slab in the wire dtype) / n_ranks,
//                      g' = g + wd * p_local, the moment shard, and the
//                      direction rounded to the all-gather's dtype;
//   emt_apply_direction  the gathered direction (:137-140): p + (-lr) * dir.
// What bounds them: bytes (a few flops per element).  Design: K8's
// grid-stride loop, templated on the wire, moment and direction dtypes,
// each operation rounded once as XLA's fp32 ops are.

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

template <typename M>
__global__ void spmd_adam_kernel(float* __restrict__ param, const float* __restrict__ grad,
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
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
    const float dir = __fdiv_rn(__fdiv_rn(m, h.c1), den);
    param[i] = __fadd_rn(p, __fmul_rn(h.neg_lr, dir));
  }
}

template <typename W, typename M, typename D>
__global__ void zero_slab_kernel(const W* __restrict__ slab, const float* __restrict__ p_local,
                                 M* __restrict__ mu, M* __restrict__ nu, D* __restrict__ dir_out,
                                 long long n, float n_ranks, const AdamHyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const float g0 = __fdiv_rn(to_f(slab[i]), n_ranks);
    const float g = __fadd_rn(g0, __fmul_rn(h.weight_decay, p_local[i]));
    const float m = __fadd_rn(__fmul_rn(h.b1, to_f(mu[i])), __fmul_rn(h.one_minus_b1, g));
    const float v = __fadd_rn(__fmul_rn(h.b2, to_f(nu[i])),
                              __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
    from_f(mu + i, m);
    from_f(nu + i, v);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
    from_f(dir_out + i, __fdiv_rn(__fdiv_rn(m, h.c1), den));
  }
}

template <typename D>
__global__ void apply_direction_kernel(float* __restrict__ param, const D* __restrict__ dir,
                                       long long n, float neg_lr) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride)
    param[i] = __fadd_rn(param[i], __fmul_rn(neg_lr, to_f(dir[i])));
}

unsigned grid_blocks(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
}

template <typename W, typename M>
void launch_zero_slab(const void* slab, const float* p, void* mu, void* nu, void* dir,
                      int dir_bf16, long long n, float n_ranks, const AdamHyper& h,
                      cudaStream_t s) {
  const unsigned blocks = grid_blocks(n, 256);
  const W* w = static_cast<const W*>(slab);
  M* m = static_cast<M*>(mu);
  M* v = static_cast<M*>(nu);
  if (dir_bf16)
    zero_slab_kernel<W, M, __nv_bfloat16><<<blocks, 256, 0, s>>>(
        w, p, m, v, static_cast<__nv_bfloat16*>(dir), n, n_ranks, h);
  else
    zero_slab_kernel<W, M, float><<<blocks, 256, 0, s>>>(
        w, p, m, v, static_cast<float*>(dir), n, n_ranks, h);
}

}  // namespace

extern "C" int emt_spmd_adam(void* param, const void* grad, void* mu, void* nu,
                             int moments_bf16, long long n, const void* hyper, void* stream) {
  if (n == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(param);
  const float* g = static_cast<const float*>(grad);
  if (moments_bf16)
    spmd_adam_kernel<__nv_bfloat16><<<grid_blocks(n, 256), 256, 0, s>>>(
        p, g, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), n, h);
  else
    spmd_adam_kernel<float><<<grid_blocks(n, 256), 256, 0, s>>>(
        p, g, static_cast<float*>(mu), static_cast<float*>(nu), n, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_zero_slab(const void* slab, int wire_bf16, const void* p_local, void* mu,
                             void* nu, int moments_bf16, void* dir_out, int dir_bf16,
                             long long n, float n_ranks, const void* hyper, void* stream) {
  if (n == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(p_local);
  if (wire_bf16 && moments_bf16)
    launch_zero_slab<__nv_bfloat16, __nv_bfloat16>(slab, p, mu, nu, dir_out, dir_bf16, n,
                                                   n_ranks, h, s);
  else if (wire_bf16)
    launch_zero_slab<__nv_bfloat16, float>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, s);
  else if (moments_bf16)
    launch_zero_slab<float, __nv_bfloat16>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, s);
  else
    launch_zero_slab<float, float>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_apply_direction(void* param, const void* dir, int dir_bf16, long long n,
                                   float neg_lr, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(param);
  if (dir_bf16)
    apply_direction_kernel<__nv_bfloat16><<<grid_blocks(n, 256), 256, 0, s>>>(
        p, static_cast<const __nv_bfloat16*>(dir), n, neg_lr);
  else
    apply_direction_kernel<float><<<grid_blocks(n, 256), 256, 0, s>>>(
        p, static_cast<const float*>(dir), n, neg_lr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_adam(void* param, const void* grad, void* mu, void* nu,
                        int moments_bf16, long long n, const void* hyper,
                        void* stream) {
  if (n == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  const int threads = 256;
  const unsigned blocks = grid_blocks(n, threads);
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
