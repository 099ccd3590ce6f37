// Transmittance and compositing along rays (K3).
//
// Replaces: emernerf_tpu/ops/stepfuns.py:64 (render_transmittance_from_density)
// together with emernerf_tpu/render/volrend.py:33 (composite_rays),
// weights_opacity_depth_from_density and _row_searchsorted (median depth).
// On the TPU these are dense (R, S) XLA cumsums, exps and weighted
// reductions that fuse into a handful of passes.
//
// What bounds it on the H100: bytes.  Per ray it reads S samples of two
// edges, up to three densities and C packed value channels (at the eval
// shape, S = 64, D = 3, C = 23, the values are 96 of the call's 145 MB)
// and writes weights and transmittance; there are ~10 FLOPs per byte at
// most.  At the training shapes (8,192 rays, D = 1) the bound is a few
// microseconds, so the wrapper's host time and the launch matter as much.
//
// Forward design.  The first version of this file ran one warp per ray on
// direct loads and read the C value channels one channel at a time, each
// pass spanning the ray's whole value tile, and densities and weights with
// stride D.  emt_composite now picks one of two routes by shape:
//
// Wide or long rays (D > 1, C > 4 or S > 64: the eval shape, 5,888 bytes
// of values a ray, and the 128-sample proposal level).
// A persistent block of rb <= 4 warps walks stages of rb rays: the stage's
// inputs are contiguous runs (S edges twice, S*D densities, S*C values),
// staged in shared memory with 16-byte cp.async copies, double-buffered,
// so the next stage's copies fly while this one computes.  Each warp scans
// one ray in registers in the order that composite_bwd_kernel recomputes
// it: K consecutive samples per lane (ceil(S/32) rounded up to 1, 2, 4 or
// 8), sigma*dt summed within the lane, then a warp shuffle scan; T =
// exp(-exclusive cumsum), alpha = 1 - exp(-sigma*dt), w = T*alpha for
// every density set, bit for bit with the kernel it replaces.  Opacity
// (clipped to [1e-6, 1]), depth and the median depth (count of cumsum(w)
// < 0.5, clipped to S-1) are warp reductions; weights and transmittance go
// to shared memory.  The weighted sums then read the staged values with
// lanes across channels: lane (g, c) sums channel c over samples g, g + G,
// ... (G = 32 / C sample groups), so consecutive lanes read consecutive
// words, and the G partial sums meet by shuffles.  Weights and
// transmittance leave as one contiguous run per stage with float4 stores.
//
// Narrow, short rays (D = 1, C <= 4 and S <= 64: the 64-sample levels of
// training and eval, a few hundred bytes a ray).  There the staging's
// barriers and shared-memory round trip cost more than the strided reads
// they remove (1-3 us of a 5-9 us kernel on the card), so the first
// version's warp per ray stays, with the same scan: with D = 1 its loads
// and stores are contiguous runs already.  At S = 128 (K = 4) the warp
// per ray lost to the staging on the card, so those rays are staged.
//
// More than 64 value channels (the feature head's: 68 at the training
// shape, 215 at the eval shape with decomposition, 55 KB of values a ray
// there) are two launches in one call: the route above with no value
// channels writes the weights, then composite_sums_kernel streams the
// values, one thread per (ray, channel), each channel summed over the
// samples in order.  Staging 55 KB rays left one or two warps per SM, and
// a warp that read its ray's channels itself (lanes across channels, the
// loads of two samples in flight) was slower than four staged calls of
// <= 64 channels (PERF.md, PR 12).  At most 256 channels.
//
// The value channels' density sets come by value, 2 bits per channel, in
// one 64-byte struct (ChanSets).
//
// Backward design: one warp per ray, reading its inputs from device
// memory with vector loads where its rows are aligned; see
// composite_bwd_kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 3;
constexpr int kMaxC = 256;
// above this many value channels the forward's sums are a second kernel,
// composite_sums_kernel, and the backward's lanes go across the channels
// (see the header and composite_bwd_kernel)
constexpr int kMaxStagedC = 64;
constexpr int kSetWords = kMaxC / 32;
constexpr unsigned kFull = 0xffffffffu;

// the density set of each value channel, 2 bits per channel: channel c in
// bits 2(c % 32), 2(c % 32) + 1 of word c / 32 (render/volrend.py:pack_chan_sets)
struct ChanSets {
  unsigned long long w[kSetWords];
};

// density set of value channel c; the word is picked by compare and select,
// so the struct stays in the kernel's parameter space
__device__ __forceinline__ int chan_set(const ChanSets& sets, int c) {
  const int k = c >> 5;
  unsigned long long word = 0;
#pragma unroll
  for (int i = 0; i < kSetWords; ++i) word = i == k ? sets.w[i] : word;
  return static_cast<int>((word >> (2 * (c & 31))) & 3ull);
}

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

// ---- forward, narrow rays (D = 1, C <= 4, S <= 64): one warp per ray ----
//
// The lanes load their K consecutive samples straight from device memory (a
// warp's loads are one contiguous run, since D = 1) and write weights and
// transmittance the same way (see the header).

constexpr int kWarpRouteMaxC = 4;

template <int K>
__global__ void composite_warp_kernel(const float* __restrict__ ts, const float* __restrict__ te,
                                      const float* __restrict__ dens,
                                      const float* __restrict__ vals, int n_rays, int S, int C,
                                      float* __restrict__ weights, float* __restrict__ trans,
                                      float* __restrict__ opacity, float* __restrict__ depth,
                                      float* __restrict__ median, float* __restrict__ sums) {
  const long long r = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rays) return;  // uniform across the warp
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
  float sdt[K], pre[K], w[K];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    sdt[i] = valid[i] ? __fmul_rn(dens[row + s0 + i], dt[i]) : 0.f;
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
    w[i] = wi;
    if (valid[i]) {
      weights[row + s0 + i] = wi;
      trans[row + s0 + i] = tr;
    }
    wsum += wi;
    dsum += wi * step[i];
  }
  wsum = warp_sum(wsum);
  dsum = warp_sum(dsum);
  const float opc = fminf(fmaxf(wsum, 1e-6f), 1.f);
  if (lane == 0) {
    opacity[r] = opc;
    depth[r] = __fdiv_rn(dsum, opc);
  }
  // median depth: count(inclusive cumsum(w) < 0.5), clipped to S-1
  float cw[K];
  float crun = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    crun = __fadd_rn(crun, w[i]);
    cw[i] = crun;
  }
  const float coff = warp_exclusive_scan(crun, lane);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) cnt += (valid[i] && __fadd_rn(coff, cw[i]) < 0.5f) ? 1 : 0;
  cnt = warp_sum_int(cnt);
  if (lane == 0) {
    const int idx = min(cnt, S - 1);
    median[r] = __fmul_rn(__fadd_rn(ts[row + idx], te[row + idx]), 0.5f);
  }
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (valid[i]) acc += w[i] * vals[(row + s0 + i) * C + c];
    acc = warp_sum(acc);
    if (lane == 0) sums[r * C + c] = acc;
  }
}

// ---- forward, wide rays: rays staged in shared memory (see the header) ----

constexpr int kMaxRaysPerStage = 4;  // warps per block: one ray each per stage
constexpr int kStageBudget = 75 * 1024;  // bytes per block: 3 blocks per SM at the eval shape

// floats of a shared region for a run of x floats: room for the run's
// misalignment (up to 3 floats) and a 16-byte-aligned end
__host__ __device__ __forceinline__ int region(int x) { return (x + 7) & ~3; }

// the place of global address g in a region: the same offset modulo 16
// bytes, so that the run's 16-byte-aligned middle maps to aligned shared
// memory
template <typename T>
__device__ __forceinline__ T* shifted(T* base, const void* g) {
  return base + ((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy n floats from global src to shared dst (= shifted(region, src)):
// 4-byte head and tail, 16-byte cp.async in between
__device__ __forceinline__ void stage_run(float* dst, const float* src, int n) {
  const int head = min(n, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst + i)),
                 "l"(src + i));
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     shared_addr(dst + head + 4 * i)),
                 "l"(src + head + 4 * i));
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst + i)),
                 "l"(src + i));
}

// store n floats from shared src (= shifted(region, dst)) to global dst:
// scalar head and tail, float4 in between
__device__ __forceinline__ void store_run(float* dst, const float* src, int n) {
  const int head = min(n, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    reinterpret_cast<float4*>(dst + head)[i] = reinterpret_cast<const float4*>(src + head)[i];
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// shared floats of one stage of rb rays: two input buffers, one output
__host__ __device__ __forceinline__ int stage_in_floats(int rb, int S, int D, int C) {
  return 2 * region(rb * S) + region(rb * S * D) + region(rb * S * C);
}
__host__ __device__ __forceinline__ int stage_floats(int rb, int S, int D, int C) {
  return 2 * stage_in_floats(rb, S, D, C) + 2 * region(rb * S * D);
}

template <int K>
__global__ void __launch_bounds__(32 * kMaxRaysPerStage)
composite_kernel(const float* __restrict__ ts, const float* __restrict__ te,
                 const float* __restrict__ dens, const float* __restrict__ vals, int n_rays,
                 int S, int D, int C, const ChanSets sets,
                 float* __restrict__ weights, float* __restrict__ trans,
                 float* __restrict__ opacity, float* __restrict__ depth,
                 float* __restrict__ median, float* __restrict__ sums) {
  extern __shared__ __align__(16) float smem[];
  const int rb = blockDim.x >> 5;  // rays per stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_stages = (n_rays + rb - 1) / rb;
  const int in_floats = stage_in_floats(rb, S, D, C);
  float* out_w = smem + 2 * in_floats;
  float* out_t = out_w + region(rb * S * D);
  // the value channels' lanes: G samples of C <= 32 channels per step
  const int G = C > 0 && C <= 32 ? 32 / C : 1;
  const int g = C > 0 && C <= 32 ? lane / C : 0;
  const int cl = lane - g * (C > 0 && C <= 32 ? C : 0);

  auto stage_inputs = [&](int stage, int buf) {
    float* base = smem + buf * in_floats;
    const long long ray0 = static_cast<long long>(stage) * rb;
    const int nr = static_cast<int>(min(static_cast<long long>(rb), n_rays - ray0));
    const float* a = ts + ray0 * S;
    const float* b = te + ray0 * S;
    const float* dn = dens + ray0 * S * D;
    stage_run(shifted(base, a), a, nr * S);
    base += region(rb * S);
    stage_run(shifted(base, b), b, nr * S);
    base += region(rb * S);
    stage_run(shifted(base, dn), dn, nr * S * D);
    if (C > 0) {
      base += region(rb * S * D);
      const float* v = vals + ray0 * S * C;
      stage_run(shifted(base, v), v, nr * S * C);
    }
  };

  int stage = blockIdx.x;
  if (stage >= n_stages) return;
  stage_inputs(stage, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int k = 0; stage < n_stages; ++k, stage += gridDim.x) {
    const int next = stage + gridDim.x;
    if (next < n_stages) stage_inputs(next, (k + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);  // possibly empty: one group per stage
    asm volatile("cp.async.wait_group 1;\n" ::);  // this stage's copies are done
    __syncthreads();

    const long long ray0 = static_cast<long long>(stage) * rb;
    const int nr = static_cast<int>(min(static_cast<long long>(rb), n_rays - ray0));
    const float* base = smem + (k & 1) * in_floats;
    const float* s_ts = shifted(base, ts + ray0 * S);
    base += region(rb * S);
    const float* s_te = shifted(base, te + ray0 * S);
    base += region(rb * S);
    const float* s_dn = shifted(base, dens + ray0 * S * D);
    base += region(rb * S * D);
    const float* s_v = C > 0 ? shifted(base, vals + ray0 * S * C) : nullptr;
    float* s_w = shifted(out_w, weights + ray0 * S * D);
    float* s_t = shifted(out_t, trans + ray0 * S * D);

    if (warp < nr) {
      // the transmittance scan of ray r, in registers, in the order of
      // composite_bwd_kernel's recomputation: a lane's K consecutive
      // samples, then the warp's exclusive scan
      const long long r = ray0 + warp;
      const int row = warp * S;
      const int s0 = lane * K;
      bool valid[K];
      float step[K], dt[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int s = s0 + i;
        valid[i] = s < S;
        const float a = valid[i] ? s_ts[row + s] : 0.f;
        const float b = valid[i] ? s_te[row + s] : 0.f;
        dt[i] = __fsub_rn(b, a);
        step[i] = __fmul_rn(__fadd_rn(a, b), 0.5f);
      }
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d >= D) break;
        float sdt[K], pre[K], w0[K];
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          sdt[i] = valid[i] ? __fmul_rn(s_dn[(row + s0 + i) * D + d], dt[i]) : 0.f;
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
          w0[i] = wi;
          if (valid[i]) {
            s_w[(row + s0 + i) * D + d] = wi;
            s_t[(row + s0 + i) * D + d] = tr;
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
            crun = __fadd_rn(crun, w0[i]);
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
            median[r] = __fmul_rn(__fadd_rn(s_ts[row + idx], s_te[row + idx]), 0.5f);
          }
        }
      }
      __syncwarp();

      // the weighted sums from the staged values: lane (g, c) sums channel
      // c over the samples g, g + G, ... (consecutive lanes on consecutive
      // words), then the G partial sums meet by shuffles
      if (C > 0 && C <= 32) {
        float acc = 0.f;
        if (g < G) {
          const int set = chan_set(sets, cl);
          const float* v = s_v + row * C + cl;
          const float* w = s_w + row * D + set;
          for (int s = g; s < S; s += G) acc += w[s * D] * v[s * C];
        }
        for (int o = 1; o < G; o <<= 1) {
          const float t = __shfl_down_sync(kFull, acc, o * C);
          if (g + o < G) acc += t;
        }
        if (g == 0) sums[r * C + cl] = acc;
      } else if (C > 32) {
        for (int c = lane; c < C; c += 32) {
          const int set = chan_set(sets, c);
          float acc = 0.f;
          for (int s = 0; s < S; ++s) acc += s_w[(row + s) * D + set] * s_v[(row + s) * C + c];
          sums[r * C + c] = acc;
        }
      }
    }
    __syncthreads();
    // weights and transmittance of the stage: one contiguous run each
    store_run(weights + ray0 * S * D, s_w, nr * S * D);
    store_run(trans + ray0 * S * D, s_t, nr * S * D);
  }
}

// The weighted sums above kMaxStagedC channels, from the weights that
// composite_kernel or composite_warp_kernel wrote: one thread per (ray,
// channel), so that neighbouring threads read neighbouring words of a
// sample's row and every thread keeps several samples' loads in flight;
// each channel is summed over the samples in order.
__global__ void composite_sums_kernel(const float* __restrict__ weights,
                                      const float* __restrict__ vals, unsigned n, int S, int D,
                                      int C, const ChanSets sets, float* __restrict__ sums) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned r = i / static_cast<unsigned>(C);
  const int c = static_cast<int>(i - r * static_cast<unsigned>(C));
  const float* w = weights + static_cast<long long>(r) * S * D + chan_set(sets, c);
  const float* v = vals + static_cast<long long>(r) * S * C + c;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) acc += w[s * D] * __ldg(v + s * C);
  sums[i] = acc;
}

// Backward (K3 bwd): the reverse of the scan above, one warp per ray.
// Replaces the XLA autodiff of the same reference functions.  Forward
// quantities are recomputed in registers with the forward's exact ops
// (nothing but the inputs is saved), so T and w are bit for bit with K3
// forward's.  Per density set d, with q_i = gw_i * w_i + gT_i * T_i:
//   d(sigma dt)_k = gw_k * T_k * exp(-sigma_k dt_k) - sum_{i>k} q_i
// where gw gathers every cotangent that reaches the weights: the weights'
// own, the per-channel sums' (times the value), depth (through /opacity)
// and opacity (through the clip to [1e-6, 1], whose gradient is 0.5 at a
// tie, as jnp.clip's).  The suffix sum is a per-lane reverse loop on top
// of a warp suffix scan (shuffles down, never total minus prefix).  d
// values[k, c] = g_sums[c] * w_{set(c), k}.  Null cotangent pointers stand
// for zeros.
//
// Loads and stores.  A lane's K consecutive samples of a row are one
// contiguous run.  Where every row starts 16-byte aligned (D = 1, S a
// multiple of 4 and aligned pointers: `vec`), the lane moves its run of
// t_starts, t_ends, densities, the weights' and transmittance's cotangents
// and d densities as one float2 (K = 2), one float4 (K = 4) or two float4
// (K = 8), else as scalars, in the same kernel.  Where also C <= 4
// (`narrow`), a sample's C values and their gradients move as one C-wide
// vector.  Above 64 channels (`wide`: the feature head's), the lanes go
// across the channels instead: for each sample, lane c reads value c
// (then c + 32, ...) of the row and writes its gradient, the sample's
// weight comes from the lane that holds it by a shuffle, and the value
// terms of gw meet by a warp sum, so that a row is read and written as
// consecutive words.  The proposal levels' calls carry the
// transmittance's cotangent alone: kTransOnly drops the weights' terms
// (gw = 0) and their branches.
__device__ __forceinline__ float clip_tie_grad(float x, float lo, float hi) {
  const float a = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float b = x < hi ? 1.f : (x == hi ? 0.5f : 0.f);
  return a * b;
}

// p[s0 .. s0+K) of a row of S floats, zeros past its end: vectors where
// vec (a vector is then wholly inside the row or past it), else scalars
template <int K>
__device__ __forceinline__ void load_lane_run(float (&v)[K], const float* __restrict__ p, int s0,
                                              int S, bool vec) {
  if constexpr (K >= 2) {
    if (vec) {
      constexpr int W = K >= 4 ? 4 : 2;
#pragma unroll
      for (int h = 0; h < K; h += W) {
        if (s0 + h >= S) {
#pragma unroll
          for (int i = 0; i < W; ++i) v[h + i] = 0.f;
        } else if constexpr (W == 4) {
          const float4 t = *reinterpret_cast<const float4*>(p + s0 + h);
          v[h] = t.x;
          v[h + 1] = t.y;
          v[h + 2] = t.z;
          v[h + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(p + s0 + h);
          v[h] = t.x;
          v[h + 1] = t.y;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = s0 + i < S ? p[s0 + i] : 0.f;
}

template <int K>
__device__ __forceinline__ void store_lane_run(float* __restrict__ p, const float (&v)[K], int s0,
                                               int S, bool vec) {
  if constexpr (K >= 2) {
    if (vec) {
      constexpr int W = K >= 4 ? 4 : 2;
#pragma unroll
      for (int h = 0; h < K; h += W) {
        if (s0 + h >= S) continue;
        if constexpr (W == 4)
          *reinterpret_cast<float4*>(p + s0 + h) = make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
        else
          *reinterpret_cast<float2*>(p + s0 + h) = make_float2(v[h], v[h + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (s0 + i < S) p[s0 + i] = v[i];
}

// density set d's values of a lane's K samples (stride D), zeros past the row
template <int K>
__device__ __forceinline__ void load_set(float (&v)[K], const float* __restrict__ p,
                                         long long row, int s0, int S, int D, int d, bool vec) {
  if (vec) {  // D = 1
    load_lane_run<K>(v, p + row, s0, S, true);
    return;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = s0 + i < S ? p[(row + s0 + i) * D + d] : 0.f;
}

// the C <= 4 values of one sample as one vector (C = 1, 3: scalars)
__device__ __forceinline__ void load_sample(float (&v)[4], const float* __restrict__ p, int C) {
  if (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < C ? p[c] : 0.f;
  }
}

__device__ __forceinline__ void store_sample(float* __restrict__ p, const float (&v)[4], int C) {
  if (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C) p[c] = v[c];
  }
}

template <int K, bool kTransOnly>
__global__ void composite_bwd_kernel(
    const float* __restrict__ ts, const float* __restrict__ te,
    const float* __restrict__ dens, const float* __restrict__ vals,
    int n_rays, int S, int D, int C, const ChanSets sets, bool vec, bool narrow, bool wide,
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
  {
    float a[K], b[K];
    load_lane_run<K>(a, ts + row, s0, S, vec);
    load_lane_run<K>(b, te + row, s0, S, vec);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      valid[i] = s0 + i < S;
      dt[i] = __fsub_rn(b[i], a[i]);
      step[i] = __fmul_rn(__fadd_rn(a[i], b[i]), 0.5f);
    }
  }

  for (int d = 0; d < D; ++d) {
    float sdt[K], pre[K], tr[K], gt[K], q[K];
    float run = 0.f;
    {
      float dn[K];
      load_set<K>(dn, dens, row, s0, S, D, d, vec);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        sdt[i] = valid[i] ? __fmul_rn(dn[i], dt[i]) : 0.f;
        pre[i] = run;
        run = __fadd_rn(run, sdt[i]);
      }
    }
    const float off = warp_exclusive_scan(run, lane);
    if (g_trans) {
      load_set<K>(gt, g_trans, row, s0, S, D, d, vec);
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) gt[i] = 0.f;
    }
    float lane_q = 0.f;
    float gw[K], ex[K];  // the weights' cotangent and exp(-sigma dt); unused if kTransOnly
    if constexpr (kTransOnly) {
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        tr[i] = expf(-__fadd_rn(off, pre[i]));
        q[i] = valid[i] ? gt[i] * tr[i] : 0.f;
        lane_q += q[i];
      }
    } else {
      float w[K];
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
      if (g_weights) {
        load_set<K>(gw, g_weights, row, s0, S, D, d, vec);
      } else {
#pragma unroll
        for (int i = 0; i < K; ++i) gw[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) gw[i] += d_wsum + d_num * step[i];
      if (g_sums && narrow) {  // D = 1: every channel is weighted by set 0
        float gs[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gs[c] = c < C ? g_sums[r * C + c] : 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (!valid[i]) continue;
          const long long o = (row + s0 + i) * C;
          float v[4], dv[4];
          load_sample(v, vals + o, C);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c >= C) break;
            gw[i] += gs[c] * v[c];
            dv[c] = gs[c] * w[i];
          }
          store_sample(d_vals + o, dv, C);
        }
      } else if (g_sums && wide) {
        // this lane's channels of set d and their cotangents
        float gs[kSetWords];
        unsigned mine = 0;
#pragma unroll
        for (int j = 0; j < kSetWords; ++j) {
          const int c = lane + 32 * j;
          const bool in_set = c < C && chan_set(sets, c) == d;
          gs[j] = in_set ? g_sums[r * C + c] : 0.f;
          mine |= in_set ? 1u << j : 0u;
        }
        for (int src = 0; src < 32; ++src) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const int s = src * K + i;
            if (s >= S) continue;  // uniform across the warp
            const float ws = __shfl_sync(kFull, w[i], src);
            const float* v = vals + (row + s) * C + lane;
            float* dv = d_vals + (row + s) * C + lane;
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kSetWords; ++j) {
              if (!((mine >> j) & 1u)) continue;
              part += gs[j] * v[32 * j];
              dv[32 * j] = gs[j] * ws;
            }
            part = warp_sum(part);
            if (lane == src) gw[i] += part;
          }
        }
      } else if (g_sums) {
        for (int c = 0; c < C; ++c) {
          if (chan_set(sets, c) != d) continue;
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
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        q[i] = valid[i] ? gw[i] * w[i] + gt[i] * tr[i] : 0.f;
        lane_q += q[i];
      }
    }
    // suffix sums of q over the samples after each one, accumulated from
    // the ray's end as a reverse cumsum does: behind an opaque surface q is
    // ~1e-8 of the q in front of it, and total - prefix would leave an ulp
    // of the total there in place of the true suffix
    float suffix = lane_q;  // over this lane and the lanes after it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(kFull, suffix, o);
      if (lane + o < 32) suffix += v;
    }
    float after = __shfl_down_sync(kFull, suffix, 1);  // the lanes after this one
    if (lane == 31) after = 0.f;
    float dd[K];
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      float g_sdt;
      if constexpr (kTransOnly) g_sdt = -after;
      else g_sdt = gw[i] * tr[i] * ex[i] - after;
      dd[i] = g_sdt * dt[i];
      after += q[i];
    }
    if (vec) {
      store_lane_run<K>(d_dens + row, dd, s0, S, true);
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (valid[i]) d_dens[(row + s0 + i) * D + d] = dd[i];
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// sets: host array of kSetWords words, the density set of each value
// channel packed as the forward takes them (render/volrend.py:pack_chan_sets)
extern "C" int emt_composite_backward(
    const void* t_starts, const void* t_ends, const void* dens, const void* vals,
    const void* sets, int n_rays, int S, int D, int C,
    const void* g_weights, const void* g_trans, const void* g_opacity,
    const void* g_depth, const void* g_sums, void* d_dens, void* d_vals,
    void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (S < 1 || S > 256 || D < 1 || D > kMaxD || C < 0 || C > kMaxC)
    return cudaErrorInvalidValue;
  // every row of the per-sample tensors starts 16-byte aligned
  const bool vec = D == 1 && S % 4 == 0 && aligned16(t_starts) && aligned16(t_ends) &&
                   aligned16(dens) && aligned16(g_weights) && aligned16(g_trans) &&
                   aligned16(d_dens);
  const bool narrow = vec && C <= 4 && aligned16(vals) && aligned16(d_vals);
  const bool wide = C > kMaxStagedC;
  ChanSets cs;
  for (int i = 0; i < kSetWords; ++i) cs.w[i] = static_cast<const unsigned long long*>(sets)[i];
  const bool trans_only = g_trans && !g_weights && !g_opacity && !g_depth && !g_sums;
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
#define EMT_LAUNCH(KV, TO)                                                               \
  composite_bwd_kernel<KV, TO><<<blocks, threads, 0, s>>>(a, b, dn, v, n_rays, S, D, C, cs, \
                                                          vec, narrow, wide, gw, gt, go,  \
                                                          gd, gs, dd, dv)
#define EMT_LAUNCH_K(TO)          \
  if (k == 1) EMT_LAUNCH(1, TO);  \
  else if (k == 2) EMT_LAUNCH(2, TO); \
  else if (k <= 4) EMT_LAUNCH(4, TO); \
  else EMT_LAUNCH(8, TO)
  if (trans_only) {
    EMT_LAUNCH_K(true);
  } else {
    EMT_LAUNCH_K(false);
  }
#undef EMT_LAUNCH_K
#undef EMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Forward.  sets: the density set of each value channel (ChanSets).
// out: weights (R,S,D), trans (R,S,D), opacity (R,D), depth (R,D), median
// (R,1), sums (R,C), one after the other.
template <int K>
cudaError_t launch_composite(const float* a, const float* b, const float* dn, const float* v,
                             int n_rays, int S, int D, int C, const ChanSets& sets, float* out,
                             cudaStream_t s) {
  const long long rs = static_cast<long long>(n_rays) * S;
  float* w = out;
  float* tr = w + rs * D;
  float* op = tr + rs * D;
  float* dp = op + static_cast<long long>(n_rays) * D;
  float* md = dp + static_cast<long long>(n_rays) * D;
  float* sm = md + n_rays;
  if constexpr (K <= 2) {  // narrow, short rays: one warp each, 4 per block
    if (D == 1 && C <= kWarpRouteMaxC) {
      const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n_rays) + 3) / 4);
      composite_warp_kernel<K><<<blocks, 128, 0, s>>>(a, b, dn, v, n_rays, S, C, w, tr, op, dp,
                                                       md, sm);
      return cudaGetLastError();
    }
  }
  // rays per stage: the most, up to kMaxRaysPerStage, within the budget
  int rb = kMaxRaysPerStage;
  while (rb > 1 && stage_floats(rb, S, D, C) * 4 > kStageBudget) --rb;
  const int smem = stage_floats(rb, S, D, C) * 4;
  static bool opted_in = false;
  if (!opted_in) {
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(composite_kernel<K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // resident blocks per SM for (rb, smem): a few shapes recur, so remember them
  static int memo[16][3];
  static int n_memo = 0;
  int per_sm = 0;
  for (int i = 0; i < n_memo; ++i)
    if (memo[i][0] == rb && memo[i][1] == smem) per_sm = memo[i][2];
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, composite_kernel<K>, 32 * rb, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    if (n_memo < 16) {
      memo[n_memo][0] = rb;
      memo[n_memo][1] = smem;
      memo[n_memo][2] = per_sm;
      ++n_memo;
    }
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long n_stages = (static_cast<long long>(n_rays) + rb - 1) / rb;
  const long long most = static_cast<long long>(per_sm) * sms;
  composite_kernel<K><<<static_cast<unsigned>(n_stages < most ? n_stages : most), 32 * rb,
                        smem, s>>>(a, b, dn, v, n_rays, S, D, C, sets, w, tr, op, dp, md, sm);
  return cudaGetLastError();
}

// sets: host array of kSetWords words (render/volrend.py:pack_chan_sets)
extern "C" int emt_composite(const void* t_starts, const void* t_ends, const void* dens,
                             const void* vals, const void* sets, int n_rays, int S, int D,
                             int C, void* out, void* stream) {
  if (n_rays == 0) return cudaSuccess;
  if (S < 1 || S > 256 || D < 1 || D > kMaxD || C < 0 || C > kMaxC)
    return cudaErrorInvalidValue;
  ChanSets cs;
  for (int i = 0; i < kSetWords; ++i) cs.w[i] = static_cast<const unsigned long long*>(sets)[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(t_starts);
  const float* b = static_cast<const float*>(t_ends);
  const float* dn = static_cast<const float*>(dens);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  // above kMaxStagedC channels: the weights first (no value channels), then
  // the sums from them
  const int cw = C > kMaxStagedC ? 0 : C;
  const int k = (S + 31) / 32;
  cudaError_t err;
  if (k == 1) err = launch_composite<1>(a, b, dn, v, n_rays, S, D, cw, cs, o, s);
  else if (k == 2) err = launch_composite<2>(a, b, dn, v, n_rays, S, D, cw, cs, o, s);
  else if (k <= 4) err = launch_composite<4>(a, b, dn, v, n_rays, S, D, cw, cs, o, s);
  else err = launch_composite<8>(a, b, dn, v, n_rays, S, D, cw, cs, o, s);
  if (err != cudaSuccess || cw == C) return err;
  const long long rs = static_cast<long long>(n_rays) * S;
  const unsigned n = static_cast<unsigned>(n_rays) * static_cast<unsigned>(C);
  composite_sums_kernel<<<(n + 255) / 256, 256, 0, s>>>(o, v, n, S, D, C, cs,
                                                        o + 2 * rs * D + 2LL * n_rays * D + n_rays);
  return cudaGetLastError();
}
