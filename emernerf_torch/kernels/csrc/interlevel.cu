// zip-NeRF anti-aliased interlevel loss, forward and backward (K5).
//
// Replaces: emernerf_tpu/ops/stepfuns.py:blur_stepfun and
// sorted_interp_quad as emernerf_tpu/render/prop_sampler.py:compute_prop_loss
// calls them (the anti-aliased branch), with the XLA autodiff of its loss.
// On the TPU these are dense (R, 2K+2) key-value sorts, cumsums and
// compare-all searchsorteds over one-hot contractions.
//
// What bounds it on the H100: neither bytes nor FLOPs at these shapes.
// Per ray it reads 65 final edges, 64 transmittances and 2 x (M+1) values
// of each cache level (M+1 = 129 and 65) and writes M floats per level,
// ~2 KB per ray; the work is a short merge, three scans and a search and
// an interpolation per cache edge, a few thousand dependent instructions
// per ray.  Every step is spread over a warp's 32 lanes, and the wrapper's
// host time counts more than the device time: one launch covers every
// cache level of a branch (interlevel_loss_levels), forward and backward.
//
// Forward: a block holds rb rays x L levels, one warp per (ray, level),
// the warps of a ray next to each other (8 warps a block).  Each warp
// first starts cp.async copies of its level's cache edges and CDFs into
// shared memory, whose latency passes during the rest of the staging: per
// ray, its L warps stage once the final edges x (K+1) and the jumps of the
// step heights dy = y[k] - y[k-1], y = diff(1 - [trans, 0]) / diff(x),
// which do not depend on the level's half-width r.  Then each warp:
//   * divides the jumps by 2r once per edge, and merges the two sorted
//     runs x - r and x + r (2K+2 edges) by merge path: lane i takes the P
//     consecutive merged edges from i * P on, finds where they start by
//     one binary search along its diagonal, and walks them in order
//     without branches (a run past its end compares as +inf), left run
//     first on ties (as the stable lax.sort does); the right run's jumps
//     are negated;
//   * runs blur_stepfun's two cumsums (of the jumps, then of diff(x) times
//     that) and compute_prop_loss's cumsum of the trapezoid areas over its
//     lane's run, then a warp shuffle scan of the lanes' totals.  The
//     blurred pdf is a cumsum of jumps +-|y|/(2r) that cancel, so the three
//     scans accumulate in float64 and round each prefix to float32, as
//     torch.cumsum on the CPU does (the plain version's reference): an
//     fp32 shuffle scan lands further from a float64 evaluation than a
//     serial fp32 loop over the edges;
//   * gives each lane a run of consecutive cache edges: the first one's
//     upper bound among the blurred edges by binary search, the next ones'
//     by advancing from it, and runs sorted_interp_quad there (nan_to_num,
//     clip).  A merge path of the two sorted runs (a co-rank search per
//     lane, then a walk) and a binary search per edge were no faster on
//     the card (PERF.md);
//   * writes w_s = diff(interpolated CDF) as the residual and the per-ray
//     sum of clip(w_s - wp, 0)^2 / (wp + 1e-5), wp = diff(cache cdfs).
// Backward, a warp per (level, ray), lanes on consecutive cache edges, all
// loads issued first: the gradient w.r.t. wp is elementwise, g * (-2c /
// (wp + 1e-5) - c^2 / (wp + 1e-5)^2) with c = clip(w_s - wp, 0) (both terms
// vanish at c = 0, so the clip's tie gradient does not matter), computed
// once per interval; the transpose of the diff takes the neighbour's by
// shuffle.
// Mul/add pairs are explicitly rounded (__fmul_rn/__fadd_rn) so nvcc does
// not contract them into FMAs the reference does not have.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxEdges = 257;  // K+1 and M+1 limits (256 intervals)
constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = (kMaxEdges + 31) / 32;  // a level's edges per lane, at most
constexpr unsigned kFull = 0xffffffffu;

// One cache level.  Forward: in = cache edges (R, M+1), out = w_s (R, M).
// Backward: in = w_s (R, M), out = d cdfs (R, M+1).  The caller's array of
// these (render/prop_sampler.py through ops/stepfuns.py) is copied into the
// launch's parameters, which the kernels index in place (__grid_constant__).
struct Level {
  const float* in;
  const float* cdfs;  // (R, M+1)
  float* out;
  float r;  // the blur's half-width (forward)
  int m1;   // M+1
};

struct Levels {
  Level level[kMaxLevels];
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// exclusive prefix of per-lane totals across the warp
__device__ __forceinline__ double warp_exclusive_scan(double total, int lane) {
  double incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const double ex = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0 : ex;
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// shared floats of one (ray, level) warp: merged edges, blurred pdf and
// CDF there (3 x 2(K+1)), cache edges and CDFs and the blurred CDF
// interpolated at the edges (3 x (M+1))
__host__ __device__ __forceinline__ int level_floats(int k1, int m1) {
  return 6 * k1 + 3 * m1;
}

// P: merged edges per lane, 32 P >= 2(K+1)
template <int P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
interlevel_fwd_kernel(const float* __restrict__ s_final, const float* __restrict__ trans_final,
                      const __grid_constant__ Levels lv, float* __restrict__ loss_out,
                      int n_rays, int K1, int rb, int ray_floats) {
  extern __shared__ float smem[];
  const int L = lv.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray_local = warp / L, l = warp - ray_local * L;
  const long long ray = static_cast<long long>(blockIdx.x) * rb + ray_local;
  const int K = K1 - 1, E = 2 * K1;
  const Level& me = lv.level[l];
  const int m1 = me.m1;
  float* xs = smem + ray_local * ray_floats;  // final edges
  float* dy = xs + K1;                        // jumps of the step heights
  float* xr = xs + 2 * K1;
  for (int i = 0; i < l; ++i) xr += level_floats(K1, lv.level[i].m1);
  float* wv = xr + E;   // blurred pdf at the merged edges
  float* cdf = wv + E;  // blurred CDF there; first the jumps / (2r)
  float* qs = cdf + E;  // cache edges
  float* cc = qs + m1;  // cache CDFs
  float* ci = cc + m1;  // blurred CDF at the cache edges
  if (ray < n_rays) {
    // the level's cache edges and CDFs, copied to shared memory by
    // cp.async: their latency passes during the staging, in no register
    const float* q_src = me.in + ray * m1;
    const float* c_src = me.cdfs + ray * m1;
    for (int j = lane; j < m1; j += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(qs + j)),
                   "l"(q_src + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(cc + j)),
                   "l"(c_src + j));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // the ray's L warps stage its edges and jumps
    const float* sf = s_final + ray * K1;
    const float* tr = trans_final + ray * K;
    for (int k = l * 32 + lane; k < K1; k += 32 * L) {
      // y[k] = (cdf[k+1] - cdf[k]) / (x[k+1] - x[k]) with cdf = 1 - [trans, 0]
      float yk = 0.f, yp = 0.f;
      if (k < K) {
        const float c1 = k + 1 < K ? __fsub_rn(1.f, tr[k + 1]) : 1.f;
        yk = __fdiv_rn(__fsub_rn(c1, __fsub_rn(1.f, tr[k])), __fsub_rn(sf[k + 1], sf[k]));
      }
      if (k > 0) {
        const float c1 = k < K ? __fsub_rn(1.f, tr[k]) : 1.f;
        yp = __fdiv_rn(__fsub_rn(c1, __fsub_rn(1.f, tr[k - 1])), __fsub_rn(sf[k], sf[k - 1]));
      }
      xs[k] = sf[k];
      dy[k] = __fsub_rn(yk, yp);
    }
  }
  __syncthreads();
  if (ray >= n_rays) return;  // uniform across the warp; no barrier follows

  const float r = me.r, two_r = 2.f * r;
  float* y1 = cdf;
  for (int k = lane; k < K1; k += 32) y1[k] = __fdiv_rn(dy[k], two_r);
  __syncwarp();

  // merge x - r (left run) and x + r (right run): lane's run starts at d0
  const int d0 = lane * P;
  int a = 0;
  if (d0 < E) {  // left-run edges among the first d0 merged ones
    int lo = max(0, d0 - K1), hi = min(d0, K1);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__fsub_rn(xs[mid], r) <= __fadd_rn(xs[d0 - mid - 1], r)) lo = mid + 1;
      else hi = mid;
    }
    a = lo;
  }
  int b = d0 - a;
  float xm[P], ym[P];
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < P; ++i) {  // branch-free: a run past its end compares as +inf
    const float xa = a < K1 ? __fsub_rn(xs[min(a, K1 - 1)], r) : inf;
    const float xb = b < K1 ? __fadd_rn(xs[min(b, K1 - 1)], r) : inf;
    const bool left = xa <= xb;
    xm[i] = d0 + i < E ? (left ? xa : xb) : 0.f;
    ym[i] = d0 + i < E ? (left ? y1[min(a, K1 - 1)] : -y1[min(b, K1 - 1)]) : 0.f;
    a += left;
    b += !left;
  }
  __syncwarp();  // y1 is read; cdf is written below

  // the three cumsums over the terms k = d0 + i < E - 1: lane runs in
  // float64, then the warp's scan of the lanes' totals
  const float xnext = __shfl_down_sync(kFull, xm[0], 1);
  float dx[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    dx[i] = d0 + i < E - 1 ? __fsub_rn(i + 1 < P ? xm[i + 1] : xnext, xm[i]) : 0.f;
  double part[P];
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < P; ++i) {  // cumsum of the jumps
    if (d0 + i < E - 1) run += static_cast<double>(ym[i]);
    part[i] = run;
  }
  double off = warp_exclusive_scan(run, lane);
  run = 0.0;
#pragma unroll
  for (int i = 0; i < P; ++i) {  // cumsum of diff(x) x the jumps' cumsum
    if (d0 + i < E - 1) {
      const float cy = __double2float_rn(off + part[i]);
      run += static_cast<double>(__fmul_rn(dx[i], cy));
    }
    part[i] = run;
  }
  off = warp_exclusive_scan(run, lane);
  float w[P];  // blurred pdf at merged edge d0 + i + 1, clipped at 0
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = fmaxf(__double2float_rn(off + part[i]), 0.f);
  float wprev = __shfl_up_sync(kFull, w[P - 1], 1);  // at merged edge d0
  if (lane == 0) wprev = 0.f;
  run = 0.0;
#pragma unroll
  for (int i = 0; i < P; ++i) {  // cumsum of 0.5 (w[k+1] + w[k]) diff(x)
    if (d0 + i < E - 1) {
      const float area = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(w[i], i > 0 ? w[i - 1] : wprev)),
                                   dx[i]);
      run += static_cast<double>(area);
    }
    part[i] = run;
  }
  off = warp_exclusive_scan(run, lane);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int k = d0 + i;
    if (k < E) xr[k] = xm[i];
    if (k < E - 1) {
      wv[k + 1] = w[i];
      cdf[k + 1] = __double2float_rn(off + part[i]);
    }
  }
  if (lane == 0) {
    wv[0] = 0.f;
    cdf[0] = 0.f;
  }
  __syncwarp();

  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();  // every lane's copies of the cache edges and CDFs landed

  // the blurred CDF at each cache edge: a lane takes a run of consecutive
  // cache edges, finds the first one's upper bound among the merged edges
  // by binary search and advances from there
  const int per = (m1 + 31) >> 5;
  const int j0 = min(lane * per, m1), j1 = min(j0 + per, m1);
  int up = 0;
  if (j0 < j1) {
    const float x0 = qs[j0];
    int hi = E;
    while (up < hi) {
      const int mid = (up + hi) >> 1;
      if (xr[mid] <= x0) up = mid + 1;
      else hi = mid;
    }
  }
  for (int j = j0; j < j1; ++j) {
    const float x = qs[j];
    while (up < E && xr[up] <= x) ++up;
    const int i0 = min(max(up - 1, 0), E - 1);
    const int i1 = min(up, E - 1);
    const float xp0 = xr[i0], xp1 = xr[i1];
    float o = __fdiv_rn(__fsub_rn(x, xp0), __fsub_rn(xp1, xp0));
    if (o != o) o = 0.f;  // nan_to_num(nan=0); +-inf clip to 1 / 0
    o = fminf(fmaxf(o, 0.f), 1.f);
    const float f0 = wv[i0], f1 = wv[i1];
    const float mix = __fadd_rn(__fadd_rn(f0, __fmul_rn(f1, o)), __fmul_rn(f0, __fsub_rn(1.f, o)));
    // / 2 as * 0.5: the same rounding, without a division
    ci[j] = __fadd_rn(cdf[i0], __fmul_rn(__fmul_rn(__fsub_rn(x, xp0), mix), 0.5f));
  }
  __syncwarp();

  const int M = m1 - 1;
  float* w_s = me.out + ray * M;
  float loss = 0.f;
  for (int k = lane; k < M; k += 32) {
    const float ws = __fsub_rn(ci[k + 1], ci[k]);
    const float wp = __fsub_rn(cc[k + 1], cc[k]);
    const float c = fmaxf(__fsub_rn(ws, wp), 0.f);
    loss += __fdiv_rn(__fmul_rn(c, c), __fadd_rn(wp, 1e-5f));
    w_s[k] = ws;
  }
  loss = warp_sum(loss);
  if (lane == 0) loss_out[static_cast<long long>(l) * n_rays + ray] = loss;
}

__device__ __forceinline__ float d_wp(float w_s, float c0, float c1, float g) {
  const float wp = __fsub_rn(c1, c0);
  const float c = fmaxf(__fsub_rn(w_s, wp), 0.f);
  const float den = __fadd_rn(wp, 1e-5f);
  const float t1 = __fdiv_rn(__fmul_rn(-2.f, c), den);
  const float t2 = __fdiv_rn(__fmul_rn(c, c), __fmul_rn(den, den));
  return __fmul_rn(g, __fsub_rn(t1, t2));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
interlevel_bwd_kernel(const __grid_constant__ Levels lv, const float* __restrict__ g_loss,
                      long long g_stride_l, long long g_stride_r, int n_rays) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(lv.n) * n_rays) return;  // uniform across the warp
  int l = 0;
  long long ray = row;
  while (ray >= n_rays) {  // at most kMaxLevels - 1 steps; no division
    ray -= n_rays;
    ++l;
  }
  const Level& me = lv.level[l];
  const int m1 = me.m1, M = m1 - 1;
  const float* ws = me.in + ray * M;
  const float* cd = me.cdfs + ray * m1;
  float* d = me.out + ray * m1;
  const float g = g_loss[l * g_stride_l + ray * g_stride_r];
  // every load first (edge 32 t + lane in chunk t): the stores below may
  // alias them as far as the compiler knows
  float c0[kChunks], w[kChunks];
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int j = 32 * t + lane;
    c0[t] = j < m1 ? cd[j] : 0.f;
    w[t] = j < M ? ws[j] : 0.f;
  }
  float carry = 0.f;  // d wp of the interval before this chunk's first edge
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    if (32 * t >= m1) break;  // uniform across the warp
    const int j = 32 * t + lane;
    // cdf[j + 1]: the next lane's, or the next chunk's first
    float c1 = __shfl_down_sync(kFull, c0[t], 1);
    const float next = __shfl_sync(kFull, t + 1 < kChunks ? c0[t + 1] : 0.f, 0);
    if (lane == 31) c1 = next;
    // wp[j] = cdf[j+1] - cdf[j]: edge j takes -d wp[j] and + d wp[j-1]
    const float right = j < M ? d_wp(w[t], c0[t], c1, g) : 0.f;
    float left = __shfl_up_sync(kFull, right, 1);
    if (lane == 0) left = carry;
    carry = __shfl_sync(kFull, right, 31);
    if (j < m1) d[j] = __fadd_rn(-right, j > 0 ? left : 0.f);
  }
}

bool read_levels(const void* levels, int n_levels, Levels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  *lv = Levels{};
  lv->n = n_levels;
  const Level* src = static_cast<const Level*>(levels);
  for (int i = 0; i < n_levels; ++i) {
    if (src[i].m1 < 2 || src[i].m1 > kMaxEdges) return false;
    lv->level[i] = src[i];
  }
  return true;
}

template <int P>
cudaError_t launch_forward(const float* s_final, const float* trans, const Levels& lv,
                           float* loss, int n_rays, int K1, cudaStream_t s) {
  const int rb = kWarpsPerBlock / lv.n > 0 ? kWarpsPerBlock / lv.n : 1;  // rays per block
  int ray_floats = 2 * K1;
  for (int i = 0; i < lv.n; ++i) ray_floats += level_floats(K1, lv.level[i].m1);
  const int smem = rb * ray_floats * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // at most 8 levels of 257 edges: ~76 KB a ray
    static bool opted_in = false;
    if (!opted_in) {
      int dev = 0, most = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(interlevel_fwd_kernel<P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
  }
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n_rays) + rb - 1) / rb);
  interlevel_fwd_kernel<P><<<blocks, 32 * lv.n * rb, smem, s>>>(s_final, trans, lv, loss, n_rays,
                                                                  K1, rb, ray_floats);
  return cudaGetLastError();
}

}  // namespace

// levels: host array of n_levels Level; loss: (n_levels, n_rays)
extern "C" int emt_interlevel_forward(const void* s_final, const void* trans_final,
                                      const void* levels, int n_levels, void* loss, int n_rays,
                                      int K1, void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, &lv) || K1 < 2 || K1 > kMaxEdges)
    return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const float* sf = static_cast<const float*>(s_final);
  const float* tr = static_cast<const float*>(trans_final);
  float* lo = static_cast<float*>(loss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = 2 * K1;
  if (E <= 32 * 2) return static_cast<int>(launch_forward<2>(sf, tr, lv, lo, n_rays, K1, s));
  if (E <= 32 * 5) return static_cast<int>(launch_forward<5>(sf, tr, lv, lo, n_rays, K1, s));
  if (E <= 32 * 9) return static_cast<int>(launch_forward<9>(sf, tr, lv, lo, n_rays, K1, s));
  return static_cast<int>(launch_forward<17>(sf, tr, lv, lo, n_rays, K1, s));
}

// levels: host array of n_levels Level (in = w_s, out = d cdfs);
// g_loss: (n_levels, n_rays) with strides (g_stride_l, g_stride_r) in floats
extern "C" int emt_interlevel_backward(const void* levels, int n_levels, const void* g_loss,
                                       long long g_stride_l, long long g_stride_r, int n_rays,
                                       void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, &lv)) return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const long long warps = static_cast<long long>(n_levels) * n_rays;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  interlevel_bwd_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(g_loss), g_stride_l, g_stride_r, n_rays);
  return static_cast<int>(cudaGetLastError());
}
