// MX grid lines forward and backward (K12).
//
// Replaces: emernerf_tpu/ops/mxgrid.py:mxgrid_encode's factored scales (the
// tent matrices of _axis_tent, the chunk body one_chunk) and their autodiff.
// The TPU version builds dense (2S, chunk, block) tent matrices and runs
// batched matmuls on the MXU, because a matmul is what the TPU does fast and
// its backward has no scatter.  Per (point, scale, axis) only two entries of
// each 128-entry line are non-zero, so on the H100 the dense form is ~60x
// the arithmetic of the gather it computes.
//
// A point at a factored scale s reads, per axis a with coordinate c, two
// rows of the clamped coarse line (u = c (block - 1)) and two of the
// periodic line (u = (c freq) mod 1 * block, circular), each row W = rank *
// F lanes, and forms
//   u_a[e] = (w0 coarse[j0][e] + w1 coarse[j1][e]) + (v0 periodic[k0][e] + v1 periodic[k1][e]),
//   out[s F + f] = sum_r prod_a u_a[r F + f]   (ranks in order).
// The weights are max(0, 1 - dist) exactly as the tents compute them (every
// product and sum rounded on its own: __fmul_rn / __fadd_rn, so nvcc fuses
// nothing), rounded to the compute type C as the JAX package casts its
// tents to the table's dtype; line values are read as C holds them.
//
// What bounds it on the H100: the rows.  A point reads 4 rows of W values
// per (scale, axis) (S x A x 4 x W x 4 bytes: 80 KB at the fused grid's 10
// scales, 4 axes and W = 128), almost all from L2: the lines are at most a
// few MB.  The arithmetic is a few FLOPs per value read.
//
// Design (simple first):
//   - forward: a group of LP lanes per point (LP = 32, or the power of two
//     at or above a narrower W; 32 / LP points per warp), element e of a
//     row in lane e % LP, so each row is read with coalesced loads; the
//     scales in a loop, the rank sum through the warp's slice of shared
//     memory in rank order;
//   - line gradients: a block per (point chunk, scale, value slot); its
//     warps take the chunk's points and add w * du_a into fp32 partials of
//     the scale's lines in shared memory (axes x 2 lines x block x LP),
//     rebuilding every u_b from the positions (the TPU version recomputes
//     them too, under jax.checkpoint); the block then adds its non-zero
//     partials into the fp32 gradient.  du_a is the cotangent of u_a in
//     autodiff's order of products (reverse through ((u0 u1) u2) u3);
//   - position gradients (the flow-warped queries only): as the forward, a
//     lane group per point; per (scale, axis) the rows floor(u) - 1 (read
//     only at a knot), floor(u) and floor(u) + 1 with the weights'
//     derivatives as autodiff of the tents gives them (at a knot max's tie
//     at 0 counts 0.5 and |0|'s slope is +1), summed over the lanes by
//     shuffles;
//   - an fp32 line table of a bf16 computation gets its gradient rounded to
//     bf16 precision, float(bf16(sum)), by one pass (mx_round_to_bf16_kernel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "grid_common.cuh"

namespace {

constexpr int kMaxScales = 32;
constexpr int kMaxValues = 8;  // W <= 256
constexpr int kMaxAxes = 4;

struct MxParams {
  int n_dims;      // 3 (xyz) or 4 (xyz + t): the positions' row length
  int n_axes;      // axes with lines (= n_dims)
  int n_scales;
  int block;       // entries per line
  int width;       // W = rank * F
  int n_features;  // F
  int lanes;       // LP: lanes per point
  int values;      // ceil(W / LP): values per lane
  long long axis_part;  // elements of one axis's lines: 2 S block W
  float freqs[kMaxAxes * kMaxScales];  // periods of the periodic lines
};

using emt::kFullMask;

// The tent's weight max(0, 1 - dist(u, j)) and its derivative in u.
__device__ __forceinline__ float2 tent(float u, float j, float fb, bool periodic) {
  const float diff = __fsub_rn(u, j);
  float d = fabsf(diff);
  const float sgn = diff >= 0.f ? 1.f : -1.f;
  float slope = sgn;
  if (periodic) {
    const float e = __fsub_rn(fb, d);
    slope = d < e ? sgn : (d > e ? -sgn : 0.f);
    d = fminf(d, e);
  }
  const float y = __fsub_rn(1.f, d);
  const float dmax = y > 0.f ? 1.f : (y == 0.f ? 0.5f : 0.f);
  return make_float2(fmaxf(y, 0.f), -dmax * slope);
}

// Candidate rows floor(u) - 1, floor(u), floor(u) + 1 of one line: rows
// clamped into the coarse line (weight 0 outside it) or wrapped around the
// periodic one, with their weights and the weights' derivatives in u.
struct Rows {
  int row[3];
  float w[3], dw[3];
};

__device__ __forceinline__ Rows coarse_rows(float c, int blk) {
  Rows r;
  const float uc = __fmul_rn(c, static_cast<float>(blk - 1));
  const float fl = floorf(uc);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float j = __fadd_rn(fl, static_cast<float>(t - 1));
    const float2 td = tent(uc, j, static_cast<float>(blk), false);
    const bool ok = j >= 0.f && j <= static_cast<float>(blk - 1);
    r.row[t] = static_cast<int>(fminf(fmaxf(j, 0.f), static_cast<float>(blk - 1)));
    r.w[t] = ok ? td.x : 0.f;
    r.dw[t] = ok ? td.y : 0.f;
  }
  return r;
}

__device__ __forceinline__ Rows periodic_rows(float c, float freq, int blk) {
  Rows r;
  const float fb = static_cast<float>(blk);
  float m = fmodf(__fmul_rn(c, freq), 1.f);
  if (m < 0.f) m = __fadd_rn(m, 1.f);
  const float up = __fmul_rn(m, fb);
  const float fk = floorf(up);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float k = __fadd_rn(fk, static_cast<float>(t - 1));
    if (k < 0.f) k = __fadd_rn(k, fb);
    if (k >= fb) k = __fsub_rn(k, fb);
    const float2 td = tent(up, k, fb, true);
    r.row[t] = static_cast<int>(k);
    r.w[t] = td.x;
    r.dw[t] = td.y;
  }
  return r;
}

template <typename T, typename C>
__device__ __forceinline__ float load_value(const T* p) {
  return emt::to_compute<C>(emt::load_f(p));
}

// u_a[e] at the forward's rows (candidates 1 and 2) of one scale's coarse
// line cl and periodic line pl (row-major, W values a row).
template <typename T, typename C>
__device__ __forceinline__ float axis_value(const T* cl, const T* pl, const Rows& rc,
                                            const Rows& rp, int w, int e) {
  const float wc0 = emt::to_compute<C>(rc.w[1]), wc1 = emt::to_compute<C>(rc.w[2]);
  const float wp0 = emt::to_compute<C>(rp.w[1]), wp1 = emt::to_compute<C>(rp.w[2]);
  const float cv = __fadd_rn(__fmul_rn(wc0, load_value<T, C>(cl + rc.row[1] * w + e)),
                             __fmul_rn(wc1, load_value<T, C>(cl + rc.row[2] * w + e)));
  const float pv = __fadd_rn(__fmul_rn(wp0, load_value<T, C>(pl + rp.row[1] * w + e)),
                             __fmul_rn(wp1, load_value<T, C>(pl + rp.row[2] * w + e)));
  return __fadd_rn(cv, pv);
}

// Reverse mode through prod = ((u0 u1) u2) u3: du[a] from the cotangent g.
__device__ __forceinline__ void axis_cotangents(const float* u, int n_axes, float g, float* du) {
  float prods[kMaxAxes];
  prods[0] = u[0];
#pragma unroll
  for (int a = 1; a < kMaxAxes; ++a)
    if (a < n_axes) prods[a] = __fmul_rn(prods[a - 1], u[a]);
  float ct = g;
#pragma unroll
  for (int a = kMaxAxes - 1; a > 0; --a) {
    if (a < n_axes) {
      du[a] = __fmul_rn(ct, prods[a - 1]);
      ct = __fmul_rn(ct, u[a]);
    }
  }
  du[0] = ct;
}

// Forward.  Warp slice of shared memory: 32 * kMaxValues floats (the
// products of the warp's points, e-major per point).
template <typename T, typename C>
__global__ void mx_forward_kernel(const T* __restrict__ lines, const float* __restrict__ pos,
                                  float* __restrict__ out, long long n, const MxParams p) {
  extern __shared__ float s_prod[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lp = p.lanes, ppw = 32 / lp;
  const int sub = lane / lp, l = lane % lp;
  const long long first = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * ppw;
  if (first >= n) return;  // the whole warp
  const long long i = first + sub;
  const bool live = i < n;
  const float* x = pos + (live ? i : first) * p.n_dims;
  const int w = p.width, f_out = p.n_scales * p.n_features;
  float* buf = s_prod + warp * 32 * kMaxValues + sub * lp * p.values;
  Rows rc[kMaxAxes];
  float c[kMaxAxes];
#pragma unroll
  for (int a = 0; a < kMaxAxes; ++a) {
    if (a < p.n_axes) {
      c[a] = __ldg(x + a);
      rc[a] = coarse_rows(c[a], p.block);
    }
  }
  for (int s = 0; s < p.n_scales; ++s) {
    float prod[kMaxValues];
#pragma unroll
    for (int a = 0; a < kMaxAxes; ++a) {
      if (a >= p.n_axes) continue;
      const Rows rp = periodic_rows(c[a], p.freqs[a * kMaxScales + s], p.block);
      const T* cl = lines + a * p.axis_part + static_cast<long long>(s) * p.block * w;
      const T* pl = cl + static_cast<long long>(p.n_scales) * p.block * w;
#pragma unroll
      for (int v = 0; v < kMaxValues; ++v) {
        const int e = v * lp + l;
        if (v >= p.values || e >= w) continue;
        const float u = axis_value<T, C>(cl, pl, rc[a], rp, w, e);
        prod[v] = a == 0 ? u : __fmul_rn(prod[v], u);
      }
    }
#pragma unroll
    for (int v = 0; v < kMaxValues; ++v) {
      const int e = v * lp + l;
      if (v < p.values && e < w) buf[e] = prod[v];
    }
    __syncwarp();
    if (live && l < p.n_features) {
      float acc = buf[l];
      for (int k = l + p.n_features; k < w; k += p.n_features) acc = __fadd_rn(acc, buf[k]);
      out[i * f_out + s * p.n_features + l] = acc;
    }
    __syncwarp();
  }
}

// Line gradients.  Block (chunk, scale s, value slot v): elements v * LP +
// l; dynamic shared memory n_axes * 2 * block * LP floats of partials,
// [axis][coarse | periodic][row][lane].
template <typename T, typename C>
__global__ void mx_lines_grad_kernel(const T* __restrict__ lines, const float* __restrict__ pos,
                                     const float* __restrict__ grad, float* __restrict__ d_lines,
                                     long long n, long long chunk, const MxParams p) {
  extern __shared__ float s_part[];
  const int s = blockIdx.y, vslot = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int lp = p.lanes, ppw = 32 / lp;
  const int sub = lane / lp, l = lane % lp;
  const int w = p.width, e = vslot * lp + l;
  const int part = p.n_axes * 2 * p.block * lp;
  for (int k = threadIdx.x; k < part; k += blockDim.x) s_part[k] = 0.f;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = first + chunk < n ? first + chunk : n;
  const int f = e % p.n_features, f_out = p.n_scales * p.n_features;
  if (e < w) {
    for (long long base = first + warp * ppw; base < end; base += n_warps * ppw) {
      const long long i = base + sub;
      if (i >= end) continue;
      const float* x = pos + i * p.n_dims;
      Rows rc[kMaxAxes], rp[kMaxAxes];
      float u[kMaxAxes], du[kMaxAxes];
#pragma unroll
      for (int a = 0; a < kMaxAxes; ++a) {
        if (a >= p.n_axes) continue;
        const float c = __ldg(x + a);
        rc[a] = coarse_rows(c, p.block);
        rp[a] = periodic_rows(c, p.freqs[a * kMaxScales + s], p.block);
        const T* cl = lines + a * p.axis_part + static_cast<long long>(s) * p.block * w;
        u[a] = axis_value<T, C>(cl, cl + static_cast<long long>(p.n_scales) * p.block * w,
                                rc[a], rp[a], w, e);
      }
      axis_cotangents(u, p.n_axes, __ldg(grad + i * f_out + s * p.n_features + f), du);
#pragma unroll
      for (int a = 0; a < kMaxAxes; ++a) {
        if (a >= p.n_axes) continue;
        float* sc = s_part + (a * 2) * p.block * lp + l;
        float* sp = sc + p.block * lp;
#pragma unroll
        for (int t = 1; t < 3; ++t) {
          if (rc[a].w[t] != 0.f)
            atomicAdd(sc + rc[a].row[t] * lp, __fmul_rn(emt::to_compute<C>(rc[a].w[t]), du[a]));
          if (rp[a].w[t] != 0.f)
            atomicAdd(sp + rp[a].row[t] * lp, __fmul_rn(emt::to_compute<C>(rp[a].w[t]), du[a]));
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < part; k += blockDim.x) {
    const float val = s_part[k];
    const int kl = k % lp;
    if (val == 0.f || vslot * lp + kl >= w) continue;
    const int row = (k / lp) % p.block, line = (k / (lp * p.block)) % 2, a = k / (lp * p.block * 2);
    atomicAdd(d_lines + a * p.axis_part +
                  (static_cast<long long>(line * p.n_scales + s) * p.block + row) * w + vslot * lp + kl,
              val);
  }
}

// Position gradients: a lane group per point, as the forward.
template <typename T, typename C>
__global__ void mx_pos_grad_kernel(const T* __restrict__ lines, const float* __restrict__ pos,
                                   const float* __restrict__ grad, float* __restrict__ d_pos,
                                   long long n, const MxParams p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lp = p.lanes, ppw = 32 / lp;
  const int sub = lane / lp, l = lane % lp;
  const long long first = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * ppw;
  if (first >= n) return;
  const long long i = first + sub;
  const bool live = i < n;
  const float* x = pos + (live ? i : first) * p.n_dims;
  const int w = p.width, f_out = p.n_scales * p.n_features;
  const float fb = static_cast<float>(p.block), fb1 = static_cast<float>(p.block - 1);
  Rows rc[kMaxAxes];
  float c[kMaxAxes], dp[kMaxAxes];
#pragma unroll
  for (int a = 0; a < kMaxAxes; ++a) {
    dp[a] = 0.f;
    if (a < p.n_axes) {
      c[a] = __ldg(x + a);
      rc[a] = coarse_rows(c[a], p.block);
    }
  }
  for (int s = 0; s < p.n_scales; ++s) {
    float u[kMaxAxes][kMaxValues], dudc[kMaxAxes][kMaxValues];
#pragma unroll
    for (int a = 0; a < kMaxAxes; ++a) {
      if (a >= p.n_axes) continue;
      const float fr = p.freqs[a * kMaxScales + s];
      const Rows rp = periodic_rows(c[a], fr, p.block);
      const float pscale = __fmul_rn(fb, fr);
      const T* cl = lines + a * p.axis_part + static_cast<long long>(s) * p.block * w;
      const T* pl = cl + static_cast<long long>(p.n_scales) * p.block * w;
#pragma unroll
      for (int v = 0; v < kMaxValues; ++v) {
        const int e = v * lp + l;
        if (v >= p.values || e >= w) continue;
        u[a][v] = axis_value<T, C>(cl, pl, rc[a], rp, w, e);
        float dc = 0.f, dq = 0.f;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (rc[a].dw[t] != 0.f)
            dc = __fadd_rn(dc, __fmul_rn(rc[a].dw[t], load_value<T, C>(cl + rc[a].row[t] * w + e)));
          if (rp.dw[t] != 0.f)
            dq = __fadd_rn(dq, __fmul_rn(rp.dw[t], load_value<T, C>(pl + rp.row[t] * w + e)));
        }
        dudc[a][v] = __fadd_rn(__fmul_rn(dc, fb1), __fmul_rn(dq, pscale));
      }
    }
    const float g = live ? __ldg(grad + i * f_out + s * p.n_features + l % p.n_features) : 0.f;
    float q[kMaxAxes] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < kMaxValues; ++v) {
      if (v >= p.values) break;  // the same for every lane
      const int e = v * lp + l;
      // element e's feature is e % F: that lane of the group loaded its cotangent
      const float ge = __shfl_sync(kFullMask, g, sub * lp + e % p.n_features);
      if (e >= w) continue;
      float uv[kMaxAxes], du[kMaxAxes];
#pragma unroll
      for (int a = 0; a < kMaxAxes; ++a) uv[a] = a < p.n_axes ? u[a][v] : 1.f;
      axis_cotangents(uv, p.n_axes, ge, du);
#pragma unroll
      for (int a = 0; a < kMaxAxes; ++a)
        if (a < p.n_axes) q[a] = __fadd_rn(q[a], __fmul_rn(du[a], dudc[a][v]));
    }
#pragma unroll
    for (int a = 0; a < kMaxAxes; ++a) {
      if (a >= p.n_axes) continue;
      for (int off = lp >> 1; off > 0; off >>= 1)
        q[a] = __fadd_rn(q[a], __shfl_xor_sync(kFullMask, q[a], off));
      dp[a] = __fadd_rn(dp[a], q[a]);
    }
  }
  if (live && l == 0) {
#pragma unroll
    for (int a = 0; a < kMaxAxes; ++a)
      if (a < p.n_axes) d_pos[i * p.n_dims + a] = dp[a];
  }
}

// d <- float(bf16(d)) in place, n floats.
__global__ void mx_round_to_bf16_kernel(float* __restrict__ d, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride)
    d[k] = emt::to_compute<__nv_bfloat16>(d[k]);
}

constexpr int kThreads = 256;      // forward and position gradient
constexpr int kGradThreads = 512;  // line gradients
constexpr int kGradBlocks = 4 * 132;

template <typename T, typename C>
cudaError_t forward_typed(const void* lines, const float* pos, float* out, long long n,
                          const MxParams& p, cudaStream_t st) {
  const long long warps = (n + 32 / p.lanes - 1) / (32 / p.lanes);
  const unsigned blocks = static_cast<unsigned>((warps + kThreads / 32 - 1) / (kThreads / 32));
  const size_t smem = sizeof(float) * kThreads * kMaxValues;
  mx_forward_kernel<T, C><<<blocks, kThreads, smem, st>>>(static_cast<const T*>(lines), pos, out,
                                                          n, p);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t backward_typed(const void* lines, const float* pos, const float* grad, float* d_lines,
                           float* d_pos, long long n, const MxParams& p, cudaStream_t st) {
  const T* tab = static_cast<const T*>(lines);
  // point chunks: about kGradBlocks blocks over (chunks, scales, value slots)
  const long long per_chunk = static_cast<long long>(p.n_scales) * p.values;
  long long n_chunks = (kGradBlocks + per_chunk - 1) / per_chunk;
  const long long most = (n + 255) / 256;
  if (n_chunks > most) n_chunks = most;
  if (n_chunks < 1) n_chunks = 1;
  const long long chunk = (n + n_chunks - 1) / n_chunks;
  n_chunks = (n + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * p.n_axes * 2 * p.block * p.lanes;
  cudaError_t err = cudaFuncSetAttribute(mx_lines_grad_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_chunks), p.n_scales, p.values);
  mx_lines_grad_kernel<T, C><<<grid, kGradThreads, smem, st>>>(tab, pos, grad, d_lines, n, chunk,
                                                               p);
  err = cudaGetLastError();
  if (err != cudaSuccess || d_pos == nullptr) return err;
  const long long warps = (n + 32 / p.lanes - 1) / (32 / p.lanes);
  const unsigned blocks = static_cast<unsigned>((warps + kThreads / 32 - 1) / (kThreads / 32));
  mx_pos_grad_kernel<T, C><<<blocks, kThreads, 0, st>>>(tab, pos, grad, d_pos, n, p);
  return cudaGetLastError();
}

bool valid(const MxParams& p) {
  return p.n_axes >= 1 && p.n_axes <= kMaxAxes && p.n_scales >= 1 && p.n_scales <= kMaxScales &&
         p.lanes >= 1 && p.lanes <= 32 && (p.lanes & (p.lanes - 1)) == 0 && p.values >= 1 &&
         p.values <= kMaxValues && p.lanes * p.values >= p.width && p.n_features >= 1 &&
         p.n_features <= p.lanes && p.width % p.n_features == 0 && p.block >= 4;
}

}  // namespace

// lines: the flat line parts (axis-major, each (2S, block, W)) in their
// storage dtype; positions (n, n_dims) fp32; out (n, S * F) fp32.
extern "C" int emt_mxgrid_encode(const void* lines, int lines_is_bf16, int compute_is_bf16,
                                 const void* positions, void* out, long long n_points,
                                 const void* params, void* stream) {
  const MxParams p = *static_cast<const MxParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  float* o = static_cast<float*>(out);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (lines_is_bf16)
    err = compute_is_bf16 ? forward_typed<bf16, bf16>(lines, pos, o, n_points, p, st)
                          : forward_typed<bf16, float>(lines, pos, o, n_points, p, st);
  else
    err = compute_is_bf16 ? forward_typed<float, bf16>(lines, pos, o, n_points, p, st)
                          : forward_typed<float, float>(lines, pos, o, n_points, p, st);
  return static_cast<int>(err);
}

// grad: the (n, S * F) fp32 cotangent; d_lines: the zeroed fp32 line
// gradient, returned rounded to bf16 precision when fp32 lines serve a bf16
// computation; d_pos: (n, n_dims) fp32 or NULL.
extern "C" int emt_mxgrid_backward(const void* lines, int lines_is_bf16, int compute_is_bf16,
                                   const void* positions, const void* grad, void* d_lines,
                                   void* d_pos, long long n_points, const void* params,
                                   void* stream) {
  const MxParams p = *static_cast<const MxParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  const float* g = static_cast<const float*>(grad);
  float* dl = static_cast<float*>(d_lines);
  float* dp = static_cast<float*>(d_pos);
  using bf16 = __nv_bfloat16;
  if (n_points > 0) {
    cudaError_t err;
    if (lines_is_bf16)
      err = compute_is_bf16 ? backward_typed<bf16, bf16>(lines, pos, g, dl, dp, n_points, p, st)
                            : backward_typed<bf16, float>(lines, pos, g, dl, dp, n_points, p, st);
    else
      err = compute_is_bf16 ? backward_typed<float, bf16>(lines, pos, g, dl, dp, n_points, p, st)
                            : backward_typed<float, float>(lines, pos, g, dl, dp, n_points, p, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!lines_is_bf16 && compute_is_bf16) {
    const long long numel = p.n_axes * p.axis_part;
    const long long want = (numel + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 132 * 8 ? want : 132 * 8);
    mx_round_to_bf16_kernel<<<blocks, 256, 0, st>>>(dl, numel);
  }
  return static_cast<int>(cudaGetLastError());
}
