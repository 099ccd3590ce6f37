// zip-NeRF anti-aliased interlevel loss, forward and backward (K5).
//
// Replaces: emernerf_tpu/ops/stepfuns.py:blur_stepfun and
// sorted_interp_quad as emernerf_tpu/render/prop_sampler.py:compute_prop_loss
// calls them (the anti-aliased branch), with the XLA autodiff of its loss.
// On the TPU these are dense (R, 2K+2) key-value sorts, cumsums and
// compare-all searchsorteds over one-hot contractions.
//
// What bounds it on the H100: neither bytes nor FLOPs at these shapes.
// Per ray it reads 65 final edges, 64 transmittances and 2 x (M+1) cache
// values (M+1 = 129 or 65) and writes M + 1 floats, ~2 KB per ray; the
// work is a short merge, three scans and M+1 binary searches.  The kernel
// is latency-bound per ray, so it keeps every intermediate in shared
// memory and launches one warp per ray over all 8,192 rays at once.
//
// Forward, one warp (one block) per ray:
//   * y = diff(1 - [trans, 0]) / diff(x) on the final edges x (K+1);
//   * the blurred step function's edges are a MERGE of the two sorted runs
//     x - r and x + r (each is sorted because x is), not a general sort:
//     each lane places its elements by binary search in the other run,
//     preferring the left run on ties, as the stable lax.sort does;
//   * lane 0 runs the two cumsums and the clip of blur_stepfun and the
//     area cumsum of compute_prop_loss (2K+2 edges, serial);
//   * the lanes interpolate the blurred CDF at the cache edges
//     (sorted_interp_quad: upper-bound search, nan_to_num, clip);
//   * w_s = diff(interpolated CDF) is written out as the residual, and the
//     per-ray sum of clip(w_s - wp, 0)^2 / (wp + 1e-5) with wp = diff(cache
//     cdfs).
// Backward, one thread per cache edge: the gradient w.r.t. wp is
// elementwise, g * (-2c / (wp + 1e-5) - c^2 / (wp + 1e-5)^2) with
// c = clip(w_s - wp, 0) (both terms vanish at c = 0, so the clip's tie
// gradient does not matter), then the transpose of the diff.
// Mul/add pairs are explicitly rounded (__fmul_rn/__fadd_rn) so nvcc does
// not contract them into FMAs the reference does not have.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxEdges = 257;  // K+1 and M+1 limits (256 intervals)
constexpr int kMaxMerged = 2 * kMaxEdges;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// number of k in [0, n) with (x[k] + shift) < v (strict) or <= v
template <bool kStrict>
__device__ __forceinline__ int count_before(const float* x, int n, float shift,
                                            float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float e = __fadd_rn(x[mid], shift);
    const bool before = kStrict ? (e < v) : (e <= v);
    if (before) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void interlevel_fwd_kernel(const float* __restrict__ s_final,
                                      const float* __restrict__ trans_final,
                                      float r, const float* __restrict__ cache_s,
                                      const float* __restrict__ cache_cdfs,
                                      float* __restrict__ w_s_out,
                                      float* __restrict__ loss_out, int K1,
                                      int M1) {
  __shared__ float xs[kMaxEdges];   // final edges
  __shared__ float y1[kMaxEdges];   // step heights' jumps / (2r)
  __shared__ float xr[kMaxMerged];  // merged edges
  __shared__ float y2[kMaxMerged];  // merged jumps, then the blurred CDF
  __shared__ float wv[kMaxMerged];  // blurred pdf at the merged edges
  __shared__ float ci[kMaxEdges];   // blurred CDF at the cache edges
  const long long ray = blockIdx.x;
  const int lane = threadIdx.x;
  const int K = K1 - 1;
  const int E = 2 * K1;
  const float* tr = trans_final + ray * K;
  for (int k = lane; k < K1; k += 32) xs[k] = s_final[ray * K1 + k];
  __syncwarp();
  const float two_r = 2.f * r;
  for (int k = lane; k < K1; k += 32) {
    // y[k] = (cdf[k+1] - cdf[k]) / (x[k+1] - x[k]) with cdf = 1 - [trans, 0]
    float yk = 0.f, yp = 0.f;
    if (k < K) {
      const float c1 = k + 1 < K ? __fsub_rn(1.f, tr[k + 1]) : 1.f;
      yk = __fdiv_rn(__fsub_rn(c1, __fsub_rn(1.f, tr[k])), __fsub_rn(xs[k + 1], xs[k]));
    }
    if (k > 0) {
      const float c1 = k < K ? __fsub_rn(1.f, tr[k]) : 1.f;
      yp = __fdiv_rn(__fsub_rn(c1, __fsub_rn(1.f, tr[k - 1])), __fsub_rn(xs[k], xs[k - 1]));
    }
    y1[k] = __fdiv_rn(__fsub_rn(yk, yp), two_r);
  }
  __syncwarp();
  // merge x - r (left run) and x + r (right run); ties: left run first
  for (int k = lane; k < K1; k += 32) {
    const float a = __fsub_rn(xs[k], r);
    const int pa = k + count_before<true>(xs, K1, r, a);
    xr[pa] = a;
    y2[pa] = y1[k];
    const float b = __fadd_rn(xs[k], r);
    const int pb = k + count_before<false>(xs, K1, -r, b);
    xr[pb] = b;
    y2[pb] = -y1[k];
  }
  __syncwarp();
  if (lane == 0) {
    // yr = clip(cumsum(diff(xr) * cumsum(y2[:-1])), 0); w = [0, yr]
    float cy = 0.f, acc = 0.f;
    wv[0] = 0.f;
    for (int k = 0; k + 1 < E; ++k) {
      cy = __fadd_rn(cy, y2[k]);
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(xr[k + 1], xr[k]), cy));
      wv[k + 1] = fmaxf(acc, 0.f);
    }
    // blurred CDF = [0, cumsum(0.5 * (w[1:] + w[:-1]) * diff(xr))]
    float cdf = 0.f;
    y2[0] = 0.f;
    for (int k = 0; k + 1 < E; ++k) {
      const float area = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(wv[k + 1], wv[k])),
                                   __fsub_rn(xr[k + 1], xr[k]));
      cdf = __fadd_rn(cdf, area);
      y2[k + 1] = cdf;
    }
  }
  __syncwarp();
  const float* qs = cache_s + ray * M1;
  for (int j = lane; j < M1; j += 32) {
    const float x = qs[j];
    const int up = count_before<false>(xr, E, 0.f, x);
    const int i0 = min(max(up - 1, 0), E - 1);
    const int i1 = min(max(up, 0), E - 1);
    const float xp0 = xr[i0], xp1 = xr[i1];
    float off = __fdiv_rn(__fsub_rn(x, xp0), __fsub_rn(xp1, xp0));
    if (off != off) off = 0.f;  // nan_to_num(nan=0); +-inf clip to 1 / 0
    off = fminf(fmaxf(off, 0.f), 1.f);
    const float f0 = wv[i0], f1 = wv[i1];
    const float mix = __fadd_rn(__fadd_rn(f0, __fmul_rn(f1, off)),
                                __fmul_rn(f0, __fsub_rn(1.f, off)));
    ci[j] = __fadd_rn(y2[i0], __fdiv_rn(__fmul_rn(__fsub_rn(x, xp0), mix), 2.f));
  }
  __syncwarp();
  const int M = M1 - 1;
  const float* cc = cache_cdfs + ray * M1;
  float loss = 0.f;
  for (int j = lane; j < M; j += 32) {
    const float ws = __fsub_rn(ci[j + 1], ci[j]);
    const float wp = __fsub_rn(cc[j + 1], cc[j]);
    const float c = fmaxf(__fsub_rn(ws, wp), 0.f);
    loss += __fdiv_rn(__fmul_rn(c, c), __fadd_rn(wp, 1e-5f));
    w_s_out[ray * M + j] = ws;
  }
  loss = warp_sum(loss);
  if (lane == 0) loss_out[ray] = loss;
}

__device__ __forceinline__ float d_wp(const float* w_s, const float* cdfs, float g,
                                      int k) {
  const float wp = __fsub_rn(cdfs[k + 1], cdfs[k]);
  const float c = fmaxf(__fsub_rn(w_s[k], wp), 0.f);
  const float den = __fadd_rn(wp, 1e-5f);
  const float t1 = __fdiv_rn(__fmul_rn(-2.f, c), den);
  const float t2 = __fdiv_rn(__fmul_rn(c, c), __fmul_rn(den, den));
  return __fmul_rn(g, __fsub_rn(t1, t2));
}

__global__ void interlevel_bwd_kernel(const float* __restrict__ w_s,
                                      const float* __restrict__ cache_cdfs,
                                      const float* __restrict__ g_loss,
                                      float* __restrict__ d_cdfs, long long n_rays,
                                      int M1) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= n_rays * M1) return;
  const long long ray = idx / M1;
  const int j = static_cast<int>(idx - ray * M1);
  const int M = M1 - 1;
  const float* ws = w_s + ray * M;
  const float* cd = cache_cdfs + ray * M1;
  const float g = g_loss[ray];
  const float right = j < M ? d_wp(ws, cd, g, j) : 0.f;  // wp[j] = cdf[j+1] - cdf[j]
  const float left = j > 0 ? d_wp(ws, cd, g, j - 1) : 0.f;
  d_cdfs[idx] = __fadd_rn(-right, left);
}

}  // namespace

extern "C" int emt_interlevel_forward(const void* s_final, const void* trans_final,
                                      float r, const void* cache_s,
                                      const void* cache_cdfs, void* w_s,
                                      void* loss, int n_rays, int K1, int M1,
                                      void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (K1 < 2 || K1 > kMaxEdges || M1 < 2 || M1 > kMaxEdges)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  interlevel_fwd_kernel<<<n_rays, 32, 0, s>>>(
      static_cast<const float*>(s_final), static_cast<const float*>(trans_final), r,
      static_cast<const float*>(cache_s), static_cast<const float*>(cache_cdfs),
      static_cast<float*>(w_s), static_cast<float*>(loss), K1, M1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_interlevel_backward(const void* w_s, const void* cache_cdfs,
                                       const void* g_loss, void* d_cdfs, int n_rays,
                                       int M1, void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (M1 < 2) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n_rays) * M1;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  interlevel_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_s), static_cast<const float*>(cache_cdfs),
      static_cast<const float*>(g_loss), static_cast<float*>(d_cdfs), n_rays, M1);
  return static_cast<int>(cudaGetLastError());
}
