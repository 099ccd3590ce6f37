// MX grid lines forward and backward (K12).
//
// Replaces: emernerf_tpu/ops/mxgrid.py:mxgrid_encode's factored scales (the
// tent matrices of _axis_tent, the chunk body one_chunk) and their autodiff.
// The TPU version builds dense (2S, chunk, block) tent matrices and runs
// batched matmuls on the MXU, because a matmul is what the TPU does fast and
// its backward has no scatter.  Per (point, scale, axis) only two entries of
// each line are non-zero, so on the H100 the dense form is ~60x the
// arithmetic of the gather it computes.
//
// What bounds it on the H100: the issue rate of the per-value arithmetic and
// shared-memory traffic, and the latency of their dependent chains.  A point
// reads 4 rows of W values per (scale, axis), 80 KB at the fused grid's 10
// scales, 4 axes and W = 128; read from L2 for every point that is ~21 GB a
// call, so the rows come from shared memory: a grid's lines are a few MB,
// and the slice that one (scale, value slot) needs, every axis and both
// lines, is at most 128 KB.  The line gradient adds 16 rows of W per (point,
// scale) into 1-2 K rows; fp32 atomicAdd on shared memory is a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), so the backward adds
// without atomics.
//
// A point at a factored scale s reads, per axis a with coordinate c, two
// rows of the clamped coarse line (u = c (block - 1)) and two of the
// periodic line (u = (c freq) mod 1 * block, circular), each row W = rank *
// F values, and forms
//   u_a[e] = (w0 coarse[j0][e] + w1 coarse[j1][e]) + (v0 periodic[k0][e] + v1 periodic[k1][e]),
//   out[s F + f] = sum_r prod_a u_a[r F + f]   (ranks in order).
// The weights are max(0, 1 - dist) exactly as the tents compute them (every
// product and sum rounded on its own: __fmul_rn / __fadd_rn, so nvcc fuses
// nothing), rounded to the compute type C as the JAX package casts its
// tents to the table's dtype; line values are read as C holds them.
//
// Design:
//   - a value slot is LP consecutive values of a row (LP a power of two,
//     planned by ops/mxgrid.py:plan_slots so that a block's shared memory
//     fits); a group of LP lanes works on one point, element v LP + l of
//     slot v in lane l;
//   - a block copies one scale's slice of the lines for one slot (every
//     axis, coarse and periodic line, all rows) into shared memory
//     (cp.async, or loads that round fp32 to bf16 for a bf16 computation:
//     the slice is held as bf16 whenever either type is bf16, which changes
//     no value) and reads rows from there; a group's lanes compute its
//     points' tents, a (point, axis) a lane, into a table the group reads;
//   - forward (mx_encode_kernel): a block per (point chunk, scale) walks the
//     slots in order, restaging the slice; each group takes a contiguous
//     run of the chunk's points; the rank sum continues across slots in
//     rank order (a lane per feature adds its slot's ranks onto the sum the
//     previous slot left in the output), the plain version's order, so the
//     two agree bit for bit;
//   - backward (mx_backward_kernel): a block per (point chunk, scale,
//     slot), in batches of a point a group.  Phase 1: each group forms u_a
//     and du_a (autodiff's order of products, reverse through ((u0 u1) u2)
//     u3) from one read of the staged rows, puts du into shared memory,
//     and reduces its position gradient's partial (the tents' derivatives,
//     by shuffles in a fixed order) into a scratch buffer.  Phase 2: a warp
//     per (axis, line, row parity, column block) adds the batch's terms
//     w * du into the block's fp32 partials, a point a lane: equal rows of
//     neighbouring lanes merged by shuffles, others in turns decided by a
//     tag in shared memory, so no two lanes write one partial at once.  The
//     block then adds its partials into the fp32 gradient;
//   - mx_finish_kernel sums the position gradient's partials over (scale,
//     slot) in order into d_pos (the same from run to run) and, where fp32
//     lines serve a bf16 computation, rounds the line gradient to bf16
//     precision, float(bf16(sum)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "grid_common.cuh"

namespace {

constexpr int kMaxScales = 32;
constexpr int kMaxAxes = 4;
constexpr int kThreads = 1024;  // every K12 kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kFwdWords = 8;    // tent words per (point, axis): rows and weights
constexpr int kBwdWords = 16;   // the backward's: + the third rows and the derivatives
constexpr int kMaxRun = 8;      // the forward's tent batch: LP / 4 points
constexpr int kCols = 16;       // columns of a backward phase-2 job

struct MxParams {
  int n_dims;      // 3 (xyz) or 4 (xyz + t): the positions' row length
  int n_axes;      // axes with lines (= n_dims)
  int n_scales;
  int block;       // entries per line
  int width;       // W = rank * F
  int n_features;  // F
  int lanes;       // the forward's slot: LP lanes (a power of two, >= F)
  int values;      // the forward's slots: ceil(W / LP)
  int bwd_lanes;   // the backward's slot
  int bwd_values;  // the backward's slots
  long long axis_part;  // elements of one axis's lines: 2 S block W
  float freqs[kMaxAxes * kMaxScales];  // periods of the periodic lines
};

using emt::kFullMask;

// The slice's element type: bf16 where the lines or the computation are
// bf16 (a bf16 value widens to fp32 exactly; an fp32 value for a bf16
// computation is rounded once, at the copy, as the plain version's cast to
// the compute dtype rounds it), else fp32.
template <typename T, typename C>
using Staged = std::conditional_t<std::is_same_v<T, float> && std::is_same_v<C, float>, float,
                                  __nv_bfloat16>;

__device__ __forceinline__ float sval(const float* s) { return *s; }
__device__ __forceinline__ float sval(const __nv_bfloat16* s) { return __bfloat162float(*s); }

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// The forward's tent batch: LP / 4 points a group (at least one).
__host__ __device__ inline int tent_points(int lanes) { return lanes >= 4 ? lanes / 4 : 1; }

// The backward's batch: a point a group of LP lanes.
__host__ __device__ inline int batch_points(int lanes) { return kThreads / lanes; }

// Floats a row of the backward's du: LP + 4 (LP / 4 + 1 odd float4s), or
// LP + 1 below 4 lanes.
__host__ __device__ inline int du_stride(int lanes) { return lanes >= 4 ? lanes + 4 : lanes + 1; }

// Columns of a backward phase-2 job: 16, or a narrower slot's.
__host__ __device__ inline int job_cols(int lanes) { return lanes < kCols ? lanes : kCols; }

// Dynamic shared memory of a block, in bytes from its start.  Forward: the
// slice (rows of LP values), the groups' tent tables (float4s [word
// group][axis][point], tent_points(LP) points) and a float a thread (the
// products the rank sum reads).  Backward: the slice, the fp32 partials
// (rows of LP + 1 floats, each row's columns rotated by row / 32: lanes on
// different rows of one column hit different banks), the batch's tent
// table (4 word groups, a point a group), du ([axis][point][column], rows
// of du_stride(LP) floats: 16-byte loads of 8 lanes' rows hit different
// banks) and a tag byte a (warp, row).
// ops/mxgrid.py:shared_bytes mirrors it.
struct Layout {
  size_t partials, tents, vals, tags, total;
};

__host__ __device__ inline Layout layout(const MxParams& p, int lanes, size_t staged_bytes,
                                         bool backward) {
  const size_t rows = static_cast<size_t>(p.n_axes) * 2 * p.block;
  Layout L;
  size_t off = align16(rows * lanes * staged_bytes);
  L.partials = off;
  if (backward) {
    const size_t batch = batch_points(lanes);
    off += align16(rows * (lanes + 1) * sizeof(float));
    L.tents = off;
    off += batch * kMaxAxes * kBwdWords * sizeof(float);
    L.vals = off;
    off += kMaxAxes * batch * du_stride(lanes) * sizeof(float);
    L.tags = off;
    off += align16(static_cast<size_t>(kWarps) * p.block);
  } else {
    L.tents = off;
    off += static_cast<size_t>(kThreads / lanes) * tent_points(lanes) * kMaxAxes * kFwdWords *
           sizeof(float);
    L.vals = off;
    off += kThreads * sizeof(float);
  }
  L.total = off;
  return L;
}

// Where column c of partial row r lives: rows of LP + 1 floats, columns
// rotated by r / 32.
__device__ __forceinline__ int part_at(int r, int c, int lp) {
  return r * (lp + 1) + ((c + (r >> 5)) & (lp - 1));
}

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
  // (c freq) mod 1 as fmodf then + 1 where negative gives it: the same
  // real number rounded once, so the same float
  const float x = __fmul_rn(c, freq);
  const float m = __fsub_rn(x, floorf(x));
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

__device__ __forceinline__ float pack_rows(int lo, int hi) {
  return __int_as_float(lo | (hi << 16));
}
__device__ __forceinline__ int row_lo(float v) { return __float_as_int(v) & 0xffff; }
__device__ __forceinline__ int row_hi(float v) {
  return static_cast<int>(static_cast<unsigned>(__float_as_int(v)) >> 16);
}

// One (point, axis) entry of a tent table, a float4 a word group, the
// groups `stride` float4s apart: [rows 1 | 2, w1, w2 (the weights as C
// holds them), row 0] of the coarse line, then of the periodic line; with
// kDeriv [dw0, dw1, dw2, -] of each.
template <typename C, bool kDeriv>
__device__ __forceinline__ void write_tents(float4* t, int stride, float c, float freq, int blk) {
  const Rows rc = coarse_rows(c, blk);
  const Rows rp = periodic_rows(c, freq, blk);
  t[0] = make_float4(pack_rows(rc.row[1], rc.row[2]), emt::to_compute<C>(rc.w[1]),
                     emt::to_compute<C>(rc.w[2]), __int_as_float(rc.row[0]));
  t[stride] = make_float4(pack_rows(rp.row[1], rp.row[2]), emt::to_compute<C>(rp.w[1]),
                          emt::to_compute<C>(rp.w[2]), __int_as_float(rp.row[0]));
  if constexpr (kDeriv) {
    t[2 * stride] = make_float4(rc.dw[0], rc.dw[1], rc.dw[2], 0.f);
    t[3 * stride] = make_float4(rp.dw[0], rp.dw[1], rp.dw[2], 0.f);
  }
}

// u_a of one lane from the staged coarse line cl and periodic line pl (the
// lane's column, rows LP apart) at the forward's rows.
template <typename S>
__device__ __forceinline__ float axis_value(const S* cl, const S* pl, float4 tc, float4 tp,
                                            int lp) {
  const float cv = __fadd_rn(__fmul_rn(tc.y, sval(cl + row_lo(tc.x) * lp)),
                             __fmul_rn(tc.z, sval(cl + row_hi(tc.x) * lp)));
  const float pv = __fadd_rn(__fmul_rn(tp.y, sval(pl + row_lo(tp.x) * lp)),
                             __fmul_rn(tp.z, sval(pl + row_hi(tp.x) * lp)));
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

// The bits of (bf16(lo), bf16(hi)), rounded to nearest even.
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The block copies slot v (elements [v LP, v LP + LP) of every row) of
// scale s's lines, every axis, coarse then periodic line, into
// slice[((axis * 2 + line) * block + row) * LP + l]; elements past W are 0.
// 16 bytes of the slice a step (cp.async where no rounding is needed) when
// rows, slots and the lines' pointer allow, else one value a step.
template <typename T, typename S>
__device__ void stage_slice(S* slice, const T* __restrict__ lines, int s, int v, int lp,
                            const MxParams& p) {
  const int rows = p.n_axes * 2 * p.block;
  const int first = v * lp;
  const int valid = min(lp, p.width - first);
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));
  const bool vec = lp % kVec == 0 && p.width % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(lines) % 16 == 0;
  auto source = [&](int r) {
    const int al = r / p.block, row = r - al * p.block;
    return lines + (al >> 1) * p.axis_part +
           (static_cast<long long>((al & 1) * p.n_scales + s) * p.block + row) * p.width + first;
  };
  if (vec) {
    const int cpr = lp / kVec;  // 16-byte chunks a row
    for (int k = threadIdx.x; k < rows * cpr; k += blockDim.x) {
      const int r = k / cpr, c = (k - r * cpr) * kVec;
      S* dst = slice + r * lp + c;
      if (c >= valid) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (std::is_same_v<T, S>) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)),
                     "l"(source(r) + c));
      } else {  // fp32 lines, bf16 slice: 8 values rounded to bf16
        const float4* src = reinterpret_cast<const float4*>(source(r) + c);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        *reinterpret_cast<uint4*>(dst) = make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w),
                                                    bf16_pair(b.x, b.y), bf16_pair(b.z, b.w));
      }
    }
    if constexpr (std::is_same_v<T, S>) asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int k = threadIdx.x; k < rows * lp; k += blockDim.x) {
      const int r = k / lp, c = k - r * lp;
      const float val = c < valid ? emt::load_f(source(r) + c) : 0.f;
      emt::store_f(slice + k, val);
    }
  }
}

// Tent entries (point q, axis a) for q < n_q, a lane each, into a table of
// float4s [word group][axis][point] with `np` points an axis; the points'
// first coordinates at x, n_dims apart.
template <typename C, bool kDeriv>
__device__ __forceinline__ void tent_entries(float4* tbl, int np, const float* __restrict__ x,
                                             int n_q, int l, int lp, int s, const MxParams& p) {
  for (int k = l; k < n_q * kMaxAxes; k += lp) {
    const int q = k / kMaxAxes, a = k % kMaxAxes;
    if (a < p.n_axes)
      write_tents<C, kDeriv>(tbl + a * np + q, kMaxAxes * np, __ldg(x + q * p.n_dims + a),
                             p.freqs[a * kMaxScales + s], p.block);
  }
}

// Forward.  Block (chunk, scale s); the slots in order; each group a
// contiguous run of the chunk's points, tent_points(LP) at a time.
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    mx_encode_kernel(const T* __restrict__ lines, const float* __restrict__ pos,
                     float* __restrict__ out, long long n, long long chunk, const MxParams p) {
  using S = Staged<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = p.lanes, s = blockIdx.y, np = tent_points(lp);
  const Layout L = layout(p, lp, sizeof(S), false);
  S* slice = reinterpret_cast<S*>(smem);
  const int l = threadIdx.x % lp, group = threadIdx.x / lp, groups = kThreads / lp;
  float4* tbl = reinterpret_cast<float4*>(smem + L.tents) + group * np * kMaxAxes * 2;
  float* buf = reinterpret_cast<float*>(smem + L.vals) + group * lp;
  const int w = p.width, nf = p.n_features, f_out = p.n_scales * nf;
  const long long first = static_cast<long long>(blockIdx.x) * chunk;
  const long long count = min(chunk, n - first);
  const long long per = (count + groups - 1) / groups;  // the same for every group
  const long long g0 = first + group * per, g1 = min(g0 + per, first + count);
  for (int v = 0; v < p.values; ++v) {
    __syncthreads();  // the previous slot's reads are done
    stage_slice<T, S>(slice, lines, s, v, lp, p);
    __syncthreads();
    const int e = v * lp + l;
    // lane l < F sums feature l: this slot's lanes k0, k0 + F, ... (its ranks, in order)
    const int k0 = ((l - v * lp) % nf + nf) % nf;
    for (long long b = 0; b < per; b += np) {
      const long long i0 = g0 + b;
      const int n_q = static_cast<int>(max(0LL, min(static_cast<long long>(np), g1 - i0)));
      tent_entries<C, false>(tbl, np, pos + i0 * p.n_dims, n_q, l, lp, s, p);
      float prev[kMaxRun];
#pragma unroll
      for (int q = 0; q < kMaxRun; ++q)
        prev[q] = q < n_q && v > 0 && l < nf ? out[(i0 + q) * f_out + s * nf + l] : 0.f;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kMaxRun; ++q) {
        if (q >= np) break;  // the same for every lane
        const bool live = q < n_q;
        if (live && e < w) {
          float prod = 0.f;
#pragma unroll
          for (int a = 0; a < kMaxAxes; ++a) {
            if (a >= p.n_axes) continue;
            const S* cl = slice + (a * 2) * p.block * lp + l;
            const float u = axis_value(cl, cl + p.block * lp, tbl[a * np + q],
                                       tbl[(kMaxAxes + a) * np + q], lp);
            prod = a == 0 ? u : __fmul_rn(prod, u);
          }
          buf[l] = prod;
        }
        __syncwarp();
        if (live && l < nf) {
          int k = k0;
          float acc = prev[q];
          if (v == 0) {  // the first rank starts the sum, as the plain version's
            acc = buf[k];
            k += nf;
          }
          for (; k < lp && v * lp + k < w; k += nf) acc = __fadd_rn(acc, buf[k]);
          out[(i0 + q) * f_out + s * nf + l] = acc;
        }
        __syncwarp();
      }
    }
  }
}

// The position gradient's partial of the group's point: the sum of q[a]
// over the group's LP lanes, by shuffles in a fixed order.  Returns the axis
// whose complete sum this lane holds in q[0], kMaxAxes where it holds every
// axis's in q, or -1.
__device__ __forceinline__ int group_sums(float (&q)[kMaxAxes], int l, int lp) {
  if (lp >= 4) {
    const int h = lp >> 1, h2 = lp >> 2;
    const bool hi = l & h, hi2 = l & h2;
    // keep axes {2, 3} (hi) or {0, 1}, add the partner's copy of them
    const float k0 = hi ? q[2] : q[0], k1 = hi ? q[3] : q[1];
    const float s0 = hi ? q[0] : q[2], s1 = hi ? q[1] : q[3];
    const float a0 = __fadd_rn(k0, __shfl_xor_sync(kFullMask, s0, h));
    const float a1 = __fadd_rn(k1, __shfl_xor_sync(kFullMask, s1, h));
    float acc = __fadd_rn(hi2 ? a1 : a0, __shfl_xor_sync(kFullMask, hi2 ? a0 : a1, h2));
    for (int off = h2 >> 1; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
    q[0] = acc;
    return l % h2 == 0 ? (hi ? 2 : 0) + (hi2 ? 1 : 0) : -1;
  }
#pragma unroll
  for (int a = 0; a < kMaxAxes; ++a)
    for (int off = lp >> 1; off > 0; off >>= 1)
      q[a] = __fadd_rn(q[a], __shfl_xor_sync(kFullMask, q[a], off));
  return l == 0 ? kMaxAxes : -1;
}

// Backward.  Block (chunk, scale s, slot v); batches of a point a group
// (phases 1 and 2, see the top).  pos_part: (S * V, n, n_dims) fp32, or
// NULL.
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    mx_backward_kernel(const T* __restrict__ lines, const float* __restrict__ pos,
                       const float* __restrict__ grad, float* __restrict__ d_lines,
                       float* __restrict__ pos_part, long long n, long long chunk,
                       const MxParams p) {
  using S = Staged<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = p.bwd_lanes, s = blockIdx.y, v = blockIdx.z;
  const Layout L = layout(p, lp, sizeof(S), true);
  S* slice = reinterpret_cast<S*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.partials);
  float4* tents = reinterpret_cast<float4*>(smem + L.tents);
  float* dus = reinterpret_cast<float*>(smem + L.vals);
  const int batch = batch_points(lp);
  const int l = threadIdx.x % lp, q = threadIdx.x / lp;  // this group's point of a batch
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* tag = smem + L.tags + warp * p.block;
  const int rows = p.n_axes * 2 * p.block, ds = du_stride(lp);
  for (int k = threadIdx.x; k < rows * (lp + 1); k += blockDim.x) part[k] = 0.f;
  stage_slice<T, S>(slice, lines, s, v, lp, p);
  const int w = p.width, nf = p.n_features, f_out = p.n_scales * nf;
  const int e = v * lp + l, f = e % nf;
  const bool on = e < w, want_pos = pos_part != nullptr;
  const float fb1 = static_cast<float>(p.block - 1);
  const long long n_pos = n * p.n_dims;
  float* pos_out = want_pos ? pos_part + (static_cast<long long>(s) * p.bwd_values + v) * n_pos
                            : nullptr;
  // phase 2's jobs: (axis, line, row parity, column block), kWarps apart
  const int cols = job_cols(lp), per_line = lp / cols, jobs = p.n_axes * 4 * per_line;
  const int passes = p.block % 2 ? 2 : 1;  // an odd block wraps an even row onto row 0
  const long long first = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(first + chunk, n);
  for (long long base = first; base < end; base += batch) {
    const int live_n = static_cast<int>(min(static_cast<long long>(batch), end - base));
    const bool live = q < live_n;
    const long long i = base + q;
    const float g = live && on ? __ldg(grad + i * f_out + s * nf + f) : 0.f;
    __syncthreads();  // the slice and partials are ready; the previous batch's phase 2 is done
    // phase 1: the point's tents (lane a computes axis a), u, du and d_pos partial
    for (int a = l; a < kMaxAxes; a += lp) {
      if (live && a < p.n_axes) {
        const float ca = __ldg(pos + i * p.n_dims + a);
        if (want_pos)
          write_tents<C, true>(tents + a * batch + q, kMaxAxes * batch, ca,
                               p.freqs[a * kMaxScales + s], p.block);
        else
          write_tents<C, false>(tents + a * batch + q, kMaxAxes * batch, ca,
                                p.freqs[a * kMaxScales + s], p.block);
      }
    }
    __syncwarp();
    float du[kMaxAxes] = {0.f, 0.f, 0.f, 0.f}, qa[kMaxAxes] = {0.f, 0.f, 0.f, 0.f};
    if (live && on) {
      float u[kMaxAxes];
#pragma unroll
      for (int a = 0; a < kMaxAxes; ++a) {
        u[a] = 1.f;
        if (a >= p.n_axes) continue;
        const S* cl = slice + (a * 2) * p.block * lp + l;
        u[a] = axis_value(cl, cl + p.block * lp, tents[a * batch + q],
                          tents[(kMaxAxes + a) * batch + q], lp);
      }
      axis_cotangents(u, p.n_axes, g, du);
      if (want_pos) {
#pragma unroll
        for (int a = 0; a < kMaxAxes; ++a) {
          if (a >= p.n_axes) continue;
          const S* cl = slice + (a * 2) * p.block * lp + l;
          const S* pl = cl + p.block * lp;
          const float4 tc = tents[a * batch + q], tp = tents[(kMaxAxes + a) * batch + q];
          const float4 dc4 = tents[(2 * kMaxAxes + a) * batch + q];
          const float4 dp4 = tents[(3 * kMaxAxes + a) * batch + q];
          const int crow[3] = {__float_as_int(tc.w), row_lo(tc.x), row_hi(tc.x)};
          const int prow[3] = {__float_as_int(tp.w), row_lo(tp.x), row_hi(tp.x)};
          const float dwc[3] = {dc4.x, dc4.y, dc4.z}, dwp[3] = {dp4.x, dp4.y, dp4.z};
          float dc = 0.f, dq = 0.f;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            if (dwc[t] != 0.f) dc = __fadd_rn(dc, __fmul_rn(dwc[t], sval(cl + crow[t] * lp)));
            if (dwp[t] != 0.f) dq = __fadd_rn(dq, __fmul_rn(dwp[t], sval(pl + prow[t] * lp)));
          }
          const float pscale = __fmul_rn(static_cast<float>(p.block), p.freqs[a * kMaxScales + s]);
          qa[a] = __fmul_rn(du[a], __fadd_rn(__fmul_rn(dc, fb1), __fmul_rn(dq, pscale)));
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kMaxAxes; ++a) dus[(a * batch + q) * ds + l] = du[a];
    if (want_pos) {
      const int axis = group_sums(qa, l, lp);
      if (live && axis >= 0) {
        if (axis < kMaxAxes) {
          if (axis < p.n_axes) pos_out[i * p.n_dims + axis] = qa[0];
        } else {
#pragma unroll
          for (int a = 0; a < kMaxAxes; ++a)
            if (a < p.n_axes) pos_out[i * p.n_dims + a] = qa[a];
        }
      }
    }
    __syncthreads();
    // phase 2
    for (int job = warp; job < jobs; job += kWarps) {
      const int c0 = (job % per_line) * cols, rest = job / per_line;
      const int par = rest & 1, al = rest >> 1, a = al >> 1, li = al & 1;
      const float* du_a = dus + a * batch * ds + c0;
      float* pa = part + al * p.block * (lp + 1);
      for (int qb = 0; qb < live_n; qb += 32) {
        const int pq = qb + lane;
        const float4 t = pq < live_n ? tents[(li * kMaxAxes + a) * batch + pq]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const int r1 = row_lo(t.x), r2 = row_hi(t.x);
        const bool m1 = pq < live_n && (r1 & 1) == par && t.y != 0.f;
        const bool m2 = pq < live_n && (r2 & 1) == par && t.z != 0.f;
        for (int pass = 0; pass < passes; ++pass) {
          // the lane's term of this parity (pass 1: the second, where both rows have it)
          const bool take2 = pass ? m1 && m2 : !m1 && m2;
          const int key = (pass ? m1 && m2 : m1 || m2) ? (take2 ? r2 : r1) : -1;
          const float wt = take2 ? t.z : t.y;
          float val[kCols];
          const float* dq = du_a + pq * ds;
          if (cols % 4 == 0) {  // rows of whole float4s
#pragma unroll
            for (int k = 0; k < kCols; k += 4) {
              const float4 d4 = k < cols && key >= 0 ? *reinterpret_cast<const float4*>(dq + k)
                                                     : make_float4(0.f, 0.f, 0.f, 0.f);
              val[k] = __fmul_rn(wt, d4.x), val[k + 1] = __fmul_rn(wt, d4.y);
              val[k + 2] = __fmul_rn(wt, d4.z), val[k + 3] = __fmul_rn(wt, d4.w);
            }
          } else {
#pragma unroll
            for (int k = 0; k < kCols; ++k)
              val[k] = k < cols && key >= 0 ? __fmul_rn(wt, dq[k]) : 0.f;
          }
          bool pending = emt::merge_runs<kCols>(key, -1, val, lane);
          // lanes left with equal rows take turns: a tag names one of them a turn
          while (__any_sync(kFullMask, pending)) {
            if (pending) tag[key] = static_cast<unsigned char>(lane);
            __syncwarp();
            const bool turn = pending && tag[key] == lane;
            if (turn) {
#pragma unroll
              for (int k = 0; k < kCols; ++k) {
                if (k >= cols) continue;
                float* pr = pa + part_at(key, c0 + k, lp);
                *pr = __fadd_rn(*pr, val[k]);
              }
            }
            __syncwarp();
            pending = pending && !turn;
          }
        }
      }
    }
  }
  __syncthreads();
  const int valid = min(lp, w - v * lp);
  for (int k = threadIdx.x; k < rows * lp; k += blockDim.x) {
    const int r = k / lp, c = k - r * lp;
    const int al = r / p.block, row = r - al * p.block;
    const float val = part[al * p.block * (lp + 1) + part_at(row, c, lp)];
    if (val == 0.f || c >= valid) continue;
    atomicAdd(d_lines + (al >> 1) * p.axis_part +
                  (static_cast<long long>((al & 1) * p.n_scales + s) * p.block + row) * w +
                  v * lp + c,
              val);
  }
}

// d_pos[k] = the partials of (scale, slot) 0, 1, ... added in that order,
// for k < n_pos; d_lines[k] = float(bf16(d_lines[k])) for k < n_round.
__global__ void mx_finish_kernel(const float* __restrict__ pos_part, float* __restrict__ d_pos,
                                 long long n_pos, int n_parts, float* __restrict__ d_lines,
                                 long long n_round) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long most = n_pos > n_round ? n_pos : n_round;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < most;
       k += stride) {
    if (k < n_pos) {
      float acc = __ldcs(pos_part + k);
      for (int j = 1; j < n_parts; ++j) acc = __fadd_rn(acc, __ldcs(pos_part + j * n_pos + k));
      d_pos[k] = acc;
    }
    if (k < n_round) d_lines[k] = emt::to_compute<__nv_bfloat16>(d_lines[k]);
  }
}

// Point chunks over (chunks, `per_chunk` blocks each), in as balanced
// waves of blocks as the count allows.
template <typename K>
cudaError_t chunking(K kernel, int threads, size_t smem, long long n, long long per_chunk,
                     long long* chunk, long long* n_chunks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the chunk count whose waves of blocks take the fewest points' time, a
  // block's set-up counted as 256 points; chunks of at least 256 points
  const long long wave = static_cast<long long>(sms) * per_sm;
  const long long most = (n + 255) / 256, top = 16 * wave / per_chunk + 1;
  long long want = 1, best = -1;
  for (long long nc = 1; nc <= (most < top ? most : top); ++nc) {
    const long long ch = (n + nc - 1) / nc, blocks = (n + ch - 1) / ch * per_chunk;
    const long long cost = (blocks + wave - 1) / wave * (ch + 256);
    if (best < 0 || cost < best) best = cost, want = nc;
  }
  *chunk = (n + want - 1) / want;
  *n_chunks = (n + *chunk - 1) / *chunk;
  return cudaSuccess;
}

template <typename T, typename C>
cudaError_t forward_typed(const void* lines, const float* pos, float* out, long long n,
                          const MxParams& p, cudaStream_t st) {
  const size_t smem = layout(p, p.lanes, sizeof(Staged<T, C>), false).total;
  long long chunk = 0, n_chunks = 0;
  cudaError_t err =
      chunking(mx_encode_kernel<T, C>, kThreads, smem, n, p.n_scales, &chunk, &n_chunks);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_chunks), p.n_scales);
  mx_encode_kernel<T, C><<<grid, kThreads, smem, st>>>(static_cast<const T*>(lines), pos, out, n,
                                                       chunk, p);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t backward_typed(const void* lines, const float* pos, const float* grad, float* d_lines,
                           float* pos_part, long long n, const MxParams& p, cudaStream_t st) {
  const size_t smem = layout(p, p.bwd_lanes, sizeof(Staged<T, C>), true).total;
  const int threads = kThreads;
  long long chunk = 0, n_chunks = 0;
  cudaError_t err = chunking(mx_backward_kernel<T, C>, threads, smem, n,
                             static_cast<long long>(p.n_scales) * p.bwd_values, &chunk, &n_chunks);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_chunks), p.n_scales, p.bwd_values);
  mx_backward_kernel<T, C><<<grid, threads, smem, st>>>(static_cast<const T*>(lines), pos, grad,
                                                        d_lines, pos_part, n, chunk, p);
  return cudaGetLastError();
}

bool pow2(int x) { return x >= 1 && (x & (x - 1)) == 0; }

bool valid(const MxParams& p) {
  return p.n_axes >= 1 && p.n_axes <= kMaxAxes && p.n_dims == p.n_axes && p.n_scales >= 1 &&
         p.n_scales <= kMaxScales && p.block >= 4 && p.block < 65536 && p.n_features >= 1 &&
         p.width % p.n_features == 0 && pow2(p.lanes) && p.lanes <= 32 &&
         p.lanes >= p.n_features && p.values == (p.width + p.lanes - 1) / p.lanes &&
         pow2(p.bwd_lanes) && p.bwd_lanes <= 32 &&
         p.bwd_values == (p.width + p.bwd_lanes - 1) / p.bwd_lanes;
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
// computation; d_pos: (n, n_dims) fp32 or NULL, with pos_part its scratch,
// (S * bwd_values, n, n_dims) fp32.
extern "C" int emt_mxgrid_backward(const void* lines, int lines_is_bf16, int compute_is_bf16,
                                   const void* positions, const void* grad, void* d_lines,
                                   void* d_pos, void* pos_part, long long n_points,
                                   const void* params, void* stream) {
  const MxParams p = *static_cast<const MxParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  const float* g = static_cast<const float*>(grad);
  float* dl = static_cast<float*>(d_lines);
  float* dp = static_cast<float*>(d_pos);
  float* pp = d_pos == nullptr ? nullptr : static_cast<float*>(pos_part);
  using bf16 = __nv_bfloat16;
  if (n_points > 0) {
    cudaError_t err;
    if (lines_is_bf16)
      err = compute_is_bf16 ? backward_typed<bf16, bf16>(lines, pos, g, dl, pp, n_points, p, st)
                            : backward_typed<bf16, float>(lines, pos, g, dl, pp, n_points, p, st);
    else
      err = compute_is_bf16 ? backward_typed<float, bf16>(lines, pos, g, dl, pp, n_points, p, st)
                            : backward_typed<float, float>(lines, pos, g, dl, pp, n_points, p, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_pos = dp == nullptr ? 0 : n_points * p.n_dims;
  const long long n_round = !lines_is_bf16 && compute_is_bf16 ? p.n_axes * p.axis_part : 0;
  if (n_pos == 0 && n_round == 0) return cudaSuccess;
  const long long most = n_pos > n_round ? n_pos : n_round;
  const long long want = (most + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 8 ? want : 132 * 8);
  mx_finish_kernel<<<blocks, 256, 0, st>>>(pp, dp, n_pos, p.n_scales * p.bwd_values, dl, n_round);
  return static_cast<int>(cudaGetLastError());
}
