// Inverse-CDF importance sampling (K2).
//
// Replaces: emernerf_tpu/ops/stepfuns.py:importance_sampling (with
// _searchsorted_batched and _take_rowwise).  The TPU version compares every
// u against every CDF edge, (R, M, K) at once, and gathers with one-hot
// contractions, because the TPU's own searchsorted and take_along_axis
// lower to serialized gathers.
//
// What bounds it on the H100: reading the (R, K+1) CDF and edges and writing
// the (R, M) result, ~1-2 MB per call at the eval chunk; the arithmetic
// (a log2(K)-step binary search per output edge) is small.  Launch latency
// matters as much as the bytes at these sizes.
//
// Design: one block per ray.  The block normalizes the ray's CDF into
// shared memory once (cdf / max(cdf[-1], 1e-7), as the reference does),
// stages the edges beside it, and each thread then produces output edges
// with a binary search with searchsorted(side="right") semantics, the same
// index clipping, and nan_to_num(nan=0) followed by clip(0, 1) on the
// interpolation fraction: 0/0 gives t = 0, x/0 with x > 0 gives t = 1.
// The per-ray jitter is an input (or NULL), never drawn in the kernel.
// Arithmetic is explicitly rounded (no FMA) to match the plain version.

#include <cuda_runtime.h>

namespace {

__global__ void importance_sampling_kernel(const float* __restrict__ s_vals,
                                           const float* __restrict__ cdfs,
                                           const float* __restrict__ u_base,
                                           const float* __restrict__ jitter,
                                           float* __restrict__ out, int k1,
                                           int m) {
  extern __shared__ float smem[];
  float* cdf = smem;       // (k1,) normalized CDF
  float* sv = smem + k1;   // (k1,) edges
  const long long r = blockIdx.x;
  const float* crow = cdfs + r * k1;
  const float* srow = s_vals + r * k1;
  const float denom = fmaxf(crow[k1 - 1], 1e-7f);
  for (int k = threadIdx.x; k < k1; k += blockDim.x) {
    cdf[k] = __fdiv_rn(crow[k], denom);
    sv[k] = srow[k];
  }
  __syncthreads();
  const float jit = jitter != nullptr ? jitter[r] : 0.f;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float u = jitter != nullptr ? __fadd_rn(u_base[j], jit) : u_base[j];
    // count of cdf entries <= u (upper bound on a sorted row)
    int lo = 0, hi = k1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int i0 = min(max(lo - 1, 0), k1 - 1);
    const int i1 = min(max(lo, 0), k1 - 1);
    const float c0 = cdf[i0], c1 = cdf[i1];
    const float s0 = sv[i0], s1 = sv[i1];
    float t = __fdiv_rn(__fsub_rn(u, c0), __fsub_rn(c1, c0));
    if (isnan(t)) t = 0.f;
    t = fminf(fmaxf(t, 0.f), 1.f);
    out[r * m + j] = __fadd_rn(s0, __fmul_rn(t, __fsub_rn(s1, s0)));
  }
}

}  // namespace

extern "C" int emt_importance_sampling(const void* s_vals, const void* cdfs,
                                       const void* u_base, const void* jitter,
                                       void* out, int n_rays, int n_in_edges,
                                       int n_out_edges, void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (n_in_edges < 1 || n_out_edges < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(n_in_edges) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int threads = n_out_edges >= 128 ? 128 : ((n_out_edges + 31) / 32) * 32;
  importance_sampling_kernel<<<n_rays, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_vals), static_cast<const float*>(cdfs),
      static_cast<const float*>(u_base), static_cast<const float*>(jitter),
      static_cast<float*>(out), n_in_edges, n_out_edges);
  return static_cast<int>(cudaGetLastError());
}
