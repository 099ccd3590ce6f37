// Transmittance and compositing along rays (K3).
//
// Replaces: emernerf_tpu/ops/stepfuns.py:render_transmittance_from_density
// together with emernerf_tpu/render/volrend.py:composite_rays,
// weights_opacity_depth_from_density and _row_searchsorted (median depth).
// On the TPU these are dense (R, S) XLA cumsums, exps and weighted
// reductions that fuse into a handful of passes.
//
// What bounds it on the H100: bytes.  Per ray it reads S samples of up to
// three densities and C packed value channels and writes weights and
// transmittance; there are ~10 FLOPs per byte at most, so the kernel is
// memory- and launch-bound, and the win over the plain PyTorch version is
// doing in one pass what eager PyTorch does in ~30 kernels with (R, S)
// intermediates in device memory.
//
// Design: one warp per ray, K = ceil(S/32) consecutive samples per lane
// (two at S = 64).  sigma*dt is summed within the lane, a warp shuffle scan
// gives each lane its exclusive offset, and T = exp(-exclusive cumsum),
// alpha = 1 - exp(-sigma*dt), w = T*alpha follow in registers for every
// density set (total, static, dynamic).  Opacity (clipped to [1e-6, 1]),
// depth, the median depth (count of cumsum(w) < 0.5, clipped to S-1) and
// the weighted sums of every value channel, each under the weight set its
// channel names, are warp reductions.  Nothing but the outputs touches
// device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 3;
constexpr int kMaxC = 64;
constexpr unsigned kFull = 0xffffffffu;

struct ChanSets {
  int set[kMaxC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// exclusive prefix of per-lane totals across the warp
__device__ __forceinline__ float warp_exclusive_scan(float total, int lane) {
  float incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const float ex = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.f : ex;
}

template <int K>
__global__ void composite_kernel(const float* __restrict__ ts,
                                 const float* __restrict__ te,
                                 const float* __restrict__ dens,
                                 const float* __restrict__ vals, int n_rays,
                                 int S, int D, int C, const ChanSets cs,
                                 float* __restrict__ weights,
                                 float* __restrict__ trans,
                                 float* __restrict__ opacity,
                                 float* __restrict__ depth,
                                 float* __restrict__ median,
                                 float* __restrict__ sums) {
  const long long warp_id =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= n_rays) return;  // uniform across the warp
  const long long r = warp_id;
  const long long row = r * S;
  const int s0 = lane * K;

  bool valid[K];
  float step[K], dt[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    valid[i] = s < S;
    const float a = valid[i] ? ts[row + s] : 0.f;
    const float b = valid[i] ? te[row + s] : 0.f;
    dt[i] = __fsub_rn(b, a);
    step[i] = __fmul_rn(__fadd_rn(a, b), 0.5f);
  }

  float w[kMaxD][K];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d >= D) break;
    float sdt[K], pre[K];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      sdt[i] = valid[i] ? __fmul_rn(dens[(row + s0 + i) * D + d], dt[i]) : 0.f;
      pre[i] = run;
      run = __fadd_rn(run, sdt[i]);
    }
    const float off = warp_exclusive_scan(run, lane);
    float wsum = 0.f, dsum = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float tr = expf(-__fadd_rn(off, pre[i]));
      const float alpha = __fsub_rn(1.f, expf(-sdt[i]));
      const float wi = valid[i] ? __fmul_rn(tr, alpha) : 0.f;
      w[d][i] = wi;
      if (valid[i]) {
        const long long o = (row + s0 + i) * D + d;
        weights[o] = wi;
        trans[o] = tr;
      }
      wsum += wi;
      dsum += wi * step[i];
    }
    wsum = warp_sum(wsum);
    dsum = warp_sum(dsum);
    const float opc = fminf(fmaxf(wsum, 1e-6f), 1.f);
    if (lane == 0) {
      opacity[r * D + d] = opc;
      depth[r * D + d] = __fdiv_rn(dsum, opc);
    }
    if (d == 0) {
      // median depth: count(inclusive cumsum(w) < 0.5), clipped to S-1
      float cw[K];
      float crun = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        crun = __fadd_rn(crun, w[0][i]);
        cw[i] = crun;
      }
      const float coff = warp_exclusive_scan(crun, lane);
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < K; ++i)
        cnt += (valid[i] && __fadd_rn(coff, cw[i]) < 0.5f) ? 1 : 0;
      cnt = warp_sum_int(cnt);
      if (lane == 0) {
        const int idx = min(cnt, S - 1);
        median[r] = __fmul_rn(__fadd_rn(ts[row + idx], te[row + idx]), 0.5f);
      }
    }
  }

  for (int c = 0; c < C; ++c) {
    const int set = cs.set[c];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (!valid[i]) continue;
      const float wi = set == 0 ? w[0][i] : (set == 1 ? w[1][i] : w[2][i]);
      acc += wi * vals[(row + s0 + i) * C + c];
    }
    acc = warp_sum(acc);
    if (lane == 0) sums[r * C + c] = acc;
  }
}

// Backward (K3 bwd): the reverse of the scan above, one warp per ray.
// Replaces the XLA autodiff of the same reference functions.  Forward
// quantities are recomputed in registers with the forward's exact ops
// (nothing but the inputs is saved).  Per density set d, with q_i =
// gw_i * w_i + gT_i * T_i:
//   d(sigma dt)_k = gw_k * T_k * exp(-sigma_k dt_k) - sum_{i>k} q_i
// where gw gathers every cotangent that reaches the weights: the weights'
// own, the per-channel sums' (times the value), depth (through /opacity)
// and opacity (through the clip to [1e-6, 1], whose gradient is 0.5 at a
// tie, as jnp.clip's).  The suffix sum is a per-lane reverse loop on top
// of a warp suffix scan (shuffles down, never total minus prefix).  d values[k, c] = g_sums[c] * w_{set(c), k}.
// Null cotangent pointers stand for zeros.
__device__ __forceinline__ float clip_tie_grad(float x, float lo, float hi) {
  const float a = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float b = x < hi ? 1.f : (x == hi ? 0.5f : 0.f);
  return a * b;
}

template <int K>
__global__ void composite_bwd_kernel(
    const float* __restrict__ ts, const float* __restrict__ te,
    const float* __restrict__ dens, const float* __restrict__ vals,
    int n_rays, int S, int D, int C, const ChanSets cs,
    const float* __restrict__ g_weights, const float* __restrict__ g_trans,
    const float* __restrict__ g_opacity, const float* __restrict__ g_depth,
    const float* __restrict__ g_sums, float* __restrict__ d_dens,
    float* __restrict__ d_vals) {
  const long long warp_id =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= n_rays) return;  // uniform across the warp
  const long long r = warp_id;
  const long long row = r * S;
  const int s0 = lane * K;

  bool valid[K];
  float step[K], dt[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    valid[i] = s < S;
    const float a = valid[i] ? ts[row + s] : 0.f;
    const float b = valid[i] ? te[row + s] : 0.f;
    dt[i] = __fsub_rn(b, a);
    step[i] = __fmul_rn(__fadd_rn(a, b), 0.5f);
  }

  for (int d = 0; d < D; ++d) {
    float sdt[K], pre[K], tr[K], ex[K], w[K], gw[K];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      sdt[i] = valid[i] ? __fmul_rn(dens[(row + s0 + i) * D + d], dt[i]) : 0.f;
      pre[i] = run;
      run = __fadd_rn(run, sdt[i]);
    }
    const float off = warp_exclusive_scan(run, lane);
    float wsum = 0.f, dsum = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      tr[i] = expf(-__fadd_rn(off, pre[i]));
      ex[i] = expf(-sdt[i]);
      w[i] = valid[i] ? __fmul_rn(tr[i], __fsub_rn(1.f, ex[i])) : 0.f;
      wsum += w[i];
      dsum += w[i] * step[i];
    }
    wsum = warp_sum(wsum);
    dsum = warp_sum(dsum);
    const float opc = fminf(fmaxf(wsum, 1e-6f), 1.f);
    const float depth = __fdiv_rn(dsum, opc);
    const float g_op = g_opacity ? g_opacity[r * D + d] : 0.f;
    const float g_dp = g_depth ? g_depth[r * D + d] : 0.f;
    const float d_num = g_dp / opc;                 // d depth / d sum(w t)
    const float d_opc = g_op - g_dp * depth / opc;  // total d / d opacity
    const float d_wsum = d_opc * clip_tie_grad(wsum, 1e-6f, 1.f);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const long long o = (row + s0 + i) * D + d;
      gw[i] = (valid[i] && g_weights) ? g_weights[o] : 0.f;
      gw[i] += d_wsum + d_num * step[i];
    }
    if (g_sums) {
      for (int c = 0; c < C; ++c) {
        if (cs.set[c] != d) continue;
        const float gs = g_sums[r * C + c];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (!valid[i]) continue;
          const long long o = (row + s0 + i) * C + c;
          gw[i] += gs * vals[o];
          d_vals[o] = gs * w[i];
        }
      }
    }
    // suffix sums of q over the samples after each one, accumulated from
    // the ray's end as a reverse cumsum does: behind an opaque surface q is
    // ~1e-8 of the q in front of it, and total - prefix would leave an ulp
    // of the total there in place of the true suffix
    float q[K], lane_q = 0.f;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const float gt = (valid[i] && g_trans) ? g_trans[(row + s0 + i) * D + d] : 0.f;
      q[i] = valid[i] ? gw[i] * w[i] + gt * tr[i] : 0.f;
      lane_q += q[i];
    }
    float suffix = lane_q;  // over this lane and the lanes after it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(kFull, suffix, o);
      if (lane + o < 32) suffix += v;
    }
    float after = __shfl_down_sync(kFull, suffix, 1);  // the lanes after this one
    if (lane == 31) after = 0.f;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (valid[i]) {
        const float g_sdt = gw[i] * tr[i] * ex[i] - after;
        d_dens[(row + s0 + i) * D + d] = g_sdt * dt[i];
      }
      after += q[i];
    }
  }
}

}  // namespace

extern "C" int emt_composite_backward(
    const void* t_starts, const void* t_ends, const void* dens,
    const void* vals, const void* chan_set, int n_rays, int S, int D, int C,
    const void* g_weights, const void* g_trans, const void* g_opacity,
    const void* g_depth, const void* g_sums, void* d_dens, void* d_vals,
    void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (S < 1 || S > 256 || D < 1 || D > kMaxD || C < 0 || C > kMaxC)
    return cudaErrorInvalidValue;
  ChanSets cs = {};
  const int* sets = static_cast<const int*>(chan_set);
  for (int c = 0; c < C; ++c) {
    if (sets[c] < 0 || sets[c] >= D) return cudaErrorInvalidValue;
    cs.set[c] = sets[c];
  }
  const int threads = 128;  // 4 rays per block
  const long long total = static_cast<long long>(n_rays) * 32;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(t_starts);
  const float* b = static_cast<const float*>(t_ends);
  const float* dn = static_cast<const float*>(dens);
  const float* v = static_cast<const float*>(vals);
  const float* gw = static_cast<const float*>(g_weights);
  const float* gt = static_cast<const float*>(g_trans);
  const float* go = static_cast<const float*>(g_opacity);
  const float* gd = static_cast<const float*>(g_depth);
  const float* gs = static_cast<const float*>(g_sums);
  float* dd = static_cast<float*>(d_dens);
  float* dv = static_cast<float*>(d_vals);
  const int k = (S + 31) / 32;
#define EMT_LAUNCH(KV)                                                        \
  composite_bwd_kernel<KV><<<blocks, threads, 0, s>>>(a, b, dn, v, n_rays, S, \
                                                     D, C, cs, gw, gt, go, gd, \
                                                     gs, dd, dv)
  if (k == 1) EMT_LAUNCH(1);
  else if (k == 2) EMT_LAUNCH(2);
  else if (k <= 4) EMT_LAUNCH(4);
  else EMT_LAUNCH(8);
#undef EMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_composite(const void* t_starts, const void* t_ends,
                             const void* dens, const void* vals,
                             const void* chan_set, int n_rays, int S, int D,
                             int C, void* weights, void* trans, void* opacity,
                             void* depth, void* median, void* sums,
                             void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (S < 1 || S > 256 || D < 1 || D > kMaxD || C < 0 || C > kMaxC)
    return cudaErrorInvalidValue;
  ChanSets cs = {};
  const int* sets = static_cast<const int*>(chan_set);
  for (int c = 0; c < C; ++c) {
    if (sets[c] < 0 || sets[c] >= D) return cudaErrorInvalidValue;
    cs.set[c] = sets[c];
  }
  const int threads = 128;  // 4 rays per block
  const long long total = static_cast<long long>(n_rays) * 32;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(t_starts);
  const float* b = static_cast<const float*>(t_ends);
  const float* dn = static_cast<const float*>(dens);
  const float* v = static_cast<const float*>(vals);
  float* w = static_cast<float*>(weights);
  float* tr = static_cast<float*>(trans);
  float* op = static_cast<float*>(opacity);
  float* dp = static_cast<float*>(depth);
  float* md = static_cast<float*>(median);
  float* sm = static_cast<float*>(sums);
  const int k = (S + 31) / 32;
#define EMT_LAUNCH(KV)                                                      \
  composite_kernel<KV><<<blocks, threads, 0, s>>>(a, b, dn, v, n_rays, S, D, \
                                                 C, cs, w, tr, op, dp, md, sm)
  if (k == 1) EMT_LAUNCH(1);
  else if (k == 2) EMT_LAUNCH(2);
  else if (k <= 4) EMT_LAUNCH(4);
  else EMT_LAUNCH(8);
#undef EMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
