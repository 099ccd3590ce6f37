// Brick-grid encoder forward and backward (K1).
//
// Replaces: emernerf_tpu/ops/brickgrid.py:brickgrid_encode (forward,
// _encode_impl).  The TPU version gathers one whole brick row per
// (point, level) and reduces it against a dense 27- or 125-wide weight row,
// because TPU gathers are bound by the row rate, not by the bytes.
//
// What bounds it on the H100: random reads of table rows that mostly miss
// L2 (the static and fused tables are ~0.3-0.6 GB in fp32), i.e. memory
// latency and DRAM sector traffic; the arithmetic is a few dozen FLOPs per
// (point, level).
//
// Forward design (K4 forward's recipe, hashgrid.cu):
//   - one warp per (32 consecutive points, level); a block holds the L
//     warps of the same 32 points, so in eval and training neighbouring
//     lanes are neighbouring samples of a ray and share rows on the coarse
//     levels;
//   - only the 8 corners with a non-zero trilinear weight are read, not the
//     dense weight row.  The two corners that differ in x are neighbouring
//     slots of one row, so each (dy, dz, time slice) is ONE span of 2F
//     contiguous values, read with the widest aligned vector loads
//     (emt::load_span: 16-byte loads for F = 8 and F = 4, a float2 or a
//     bf16 pair for F = 1 where the slot is even, else two scalars);
//     time-paired rows read the t+1 slice at r0 + row_width / 2;
//   - storage and compute types are separate: the table may be the fp32
//     parameter itself with a bf16 computation.  Each loaded value is then
//     rounded to bf16 in registers (emt::round_loaded), which is what a read
//     of table.to(torch.bfloat16) gives, bit for bit, without that copy:
//     the kernel reads only the fp32 entries its points touch, where the
//     cast read the whole table and wrote half of it again;
//   - accumulation is fp32; the block's output tile is staged in shared
//     memory and written as one coalesced tile in the compute type.
//
// Rounding: the cell and fraction math uses __fmul_rn / __fadd_rn so that
// nvcc cannot fuse x*scale+0.5 into an FMA.  A fused product moves points
// that sit next to a cell boundary into the neighbouring cell, and across a
// brick boundary that is a different table row.  The reduction uses the
// same explicitly rounded mul/add in the same corner order (dz, dy, dx) as
// the plain PyTorch version (emernerf_torch/ops/brickgrid.py:
// brickgrid_encode_ref), so the two agree bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "grid_common.cuh"

namespace {

constexpr int kMaxLevels = 32;
// Instant-NGP spatial-hash primes (prime_0 = 1, as in tiny-cuda-nn)
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;
constexpr unsigned kPrime3 = 3674653429u;

struct BrickParams {
  int n_levels;
  int n_features;
  int n_dims;           // 3 (xyz) or 4 (xyz + t)
  int log2_brick_size;  // 1 -> 2^3-cell bricks (27 corners), 2 -> 4^3 (125)
  int time_pair;        // 4D only: one row holds time corners t and t+1
  int row_width;
  long long bricks_per_level;
  float scales[kMaxLevels];
  unsigned strides[kMaxLevels * 4];  // per level: x, y, z, t (linear rows)
  int uses_hash[kMaxLevels];
};

using emt::load_f;
using emt::store_f;

__device__ __forceinline__ unsigned brick_row(const BrickParams& p, int lvl,
                                              const unsigned b[3], bool has_t,
                                              unsigned t) {
  unsigned r;
  if (p.uses_hash[lvl]) {
    r = b[0] ^ (b[1] * kPrime1) ^ (b[2] * kPrime2);
    if (has_t) r ^= t * kPrime3;
  } else {
    const unsigned* s = p.strides + 4 * lvl;
    r = b[0] * s[0] + b[1] * s[1] + b[2] * s[2];
    if (has_t) r += t * s[3];
  }
  return r & static_cast<unsigned>(p.bricks_per_level - 1);
}

// Per (point, level): the cell fraction per axis, the corner offset inside
// the brick, the time fraction and the element offsets of the row(s) that
// hold the point's corners (r1 < 0 when the level has no time corner).
// Forward and backward share it, so a boundary point scatters into the very
// row it gathered from.
struct Geo {
  float frac[3];
  int off[3];
  float tfrac;
  long long r0, r1;
};

__device__ __forceinline__ Geo level_geo(const BrickParams& p, const float* x,
                                         int lvl) {
  Geo g;
  const float sc = p.scales[lvl];
  const int cells = 1 << p.log2_brick_size;
  unsigned brick[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ps = __fadd_rn(__fmul_rn(__ldg(x + a), sc), 0.5f);
    const float c = floorf(ps);
    g.frac[a] = __fsub_rn(ps, c);
    const int ci = static_cast<int>(c);
    g.off[a] = ci & (cells - 1);
    brick[a] = static_cast<unsigned>(ci >> p.log2_brick_size);
  }
  const bool has_t = p.n_dims == 4;
  g.tfrac = 0.f;
  unsigned tcell = 0u;
  if (has_t) {
    const float ps = __fadd_rn(__fmul_rn(__ldg(x + 3), sc), 0.5f);
    const float c = floorf(ps);
    g.tfrac = __fsub_rn(ps, c);
    tcell = static_cast<unsigned>(static_cast<int>(c));
  }
  const long long level_base = static_cast<long long>(lvl) * p.bricks_per_level;
  const unsigned row0 = brick_row(p, lvl, brick, has_t, tcell);
  g.r0 = (level_base + row0) * p.row_width;
  g.r1 = -1;  // the t+1 time corner, when the level has time
  if (has_t) {
    if (p.time_pair) {
      g.r1 = g.r0 + p.row_width / 2;
    } else {
      const unsigned row1 = brick_row(p, lvl, brick, true, tcell + 1u);
      g.r1 = (level_base + row1) * p.row_width;
    }
  }
  return g;
}

// Block: L warps x 32 points; warp l takes level l of the block's 32
// consecutive points.  T is the table's storage type, C the compute type
// (the output's and the load policy's); 32 * L * F values of C of dynamic
// shared memory hold the output tile.  The table is 16-byte aligned.
template <typename T, typename C, int F>
__global__ void brickgrid_encode_kernel(const T* __restrict__ table,
                                        const float* __restrict__ pos,
                                        C* __restrict__ out, long long n,
                                        const BrickParams p) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  C* s_out = reinterpret_cast<C*>(s_raw);  // [lane][level][feature]
  const int lane = threadIdx.x & 31, lvl = threadIdx.x >> 5;
  const int L = p.n_levels;
  const long long first = static_cast<long long>(blockIdx.x) * 32;
  const long long i = first + lane;
  if (i < n) {
    const Geo g = level_geo(p, pos + i * p.n_dims, lvl);
    const bool has_t = g.r1 >= 0;
    const int cpa = (1 << p.log2_brick_size) + 1;
    const float wx0 = __fsub_rn(1.f, g.frac[0]), wx1 = g.frac[0];
    float acc0[F], acc1[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc0[f] = 0.f, acc1[f] = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float wz = dz ? g.frac[2] : __fsub_rn(1.f, g.frac[2]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? g.frac[1] : __fsub_rn(1.f, g.frac[1]);
        // the dx = 0 and dx = 1 corners: one span of 2F values per slice
        const long long slot = (g.off[0] + cpa * ((g.off[1] + dy) + cpa * (g.off[2] + dz))) * F;
        float v0[2 * F], v1[2 * F];
        emt::load_span<T, 2 * F, F, C>(table + g.r0 + slot, v0);
        if (has_t) emt::load_span<T, 2 * F, F, C>(table + g.r1 + slot, v1);
        const float w0 = __fmul_rn(__fmul_rn(wx0, wy), wz);
        const float w1 = __fmul_rn(__fmul_rn(wx1, wy), wz);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          acc0[f] = __fadd_rn(acc0[f], __fmul_rn(w0, v0[f]));
          acc0[f] = __fadd_rn(acc0[f], __fmul_rn(w1, v0[F + f]));
        }
        if (has_t) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            acc1[f] = __fadd_rn(acc1[f], __fmul_rn(w0, v1[f]));
            acc1[f] = __fadd_rn(acc1[f], __fmul_rn(w1, v1[F + f]));
          }
        }
      }
    }
    C* o = s_out + (lane * L + lvl) * F;
    if (has_t) {
      const float tw0 = __fsub_rn(1.f, g.tfrac);
#pragma unroll
      for (int f = 0; f < F; ++f)
        store_f(o + f, __fadd_rn(__fmul_rn(acc0[f], tw0), __fmul_rn(acc1[f], g.tfrac)));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) store_f(o + f, acc0[f]);
    }
  }
  __syncthreads();
  // the block's rows of the (n, L * F) output are one contiguous tile
  const long long rows = n - first < 32 ? n - first : 32;
  const int count = static_cast<int>(rows) * L * F;
  constexpr int kVec = 16 / sizeof(C);
  C* dst = out + first * L * F;
  for (int k = threadIdx.x; k < count / kVec; k += blockDim.x)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(s_out)[k];
  for (int k = count / kVec * kVec + threadIdx.x; k < count; k += blockDim.x) dst[k] = s_out[k];
}

// Backward (K1 bwd).  Replaces emernerf_tpu/ops/brickgrid.py:_brickgrid_bwd,
// which scatter-adds one dense (N, 27F) weight-row update per level (wide
// scatters or one-hot MXU contractions, whichever the TPU measured faster).
//
// What bounds it on the H100: atomic read-modify-writes into the fp32
// gradient table, 8 corners x F lanes (x 2 time slices) per (point, level).
// Fine levels spread them over ~10^5-10^6 rows; the coarse dense levels
// (a 16^3 grid is 512 bricks) put thousands of points on each row, and
// those atomics serialise in L2.  One scalar atomic per feature was 128 per
// (point, level) on the fused F = 8 time-paired grid.
//
// Design (K4 backward's, hashgrid.cu, without a layout change: a brick
// corner's F features are already contiguous):
//   - one warp per (32 consecutive points, level); a block holds the L warps
//     of 32 points.  In training, consecutive points are consecutive samples
//     of a ray, so on the coarse levels neighbouring lanes hit the same
//     brick row and corner slot;
//   - the two corners that differ in dimension 0 are neighbouring slots of
//     one row (corner index + 1), so each (dy, dz, time slice) is one span
//     of 2F floats.  Before its atomics the warp merges runs of lanes whose
//     spans start at the same slot (emt::merge_runs, a segmented shuffle
//     sum; skipped after one ballot where all 32 differ), and the run's
//     first lane adds the span with the widest aligned vector atomics
//     (emt::add_span: F = 8 and F = 4 spans are float4s, an F = 1 span a
//     float2 where its slot is even), into the zeroed fp32 (L*B, W) buffer;
//   - position gradients (only the flow-warped queries): each lane re-reads
//     its corners' F features with one vector load per time slice, in a
//     loop of its own before the atomics, and forms in corner order
//       acc_a = sum_c dW_c/dfrac_a * gl_c,  acc_t = sum_c W_c * (dot1_c - dot0_c)
//     (gl_c the time-lerped feats . g); each level's acc goes to shared
//     memory and the block's first warp sums d_pos = d_pos + acc_l * scale_l
//     over the levels in order: no atomics on d_pos, every product and sum
//     rounded explicitly, the plain version's order of operations exactly
//     (emernerf_torch/ops/brickgrid.py:brickgrid_encode_bwd_ref).  The JAX
//     reference reads forward-saved reductions instead: the math is the
//     same, the rounding is not.  The re-read takes the forward's load
//     policy: an fp32 table of a bf16 computation is rounded in registers;
//   - an fp32 table of a bf16 computation gets its gradient back rounded to
//     bf16 precision, float(bf16(sum)), by one in-place pass over the fp32
//     buffer (round_to_bf16_kernel): what autograd of table.to(bf16) gave,
//     and JAX's astype VJP gives, with no bf16 gradient tensor.
// T is the table's storage type, C the compute type (the cotangent's).
template <typename T, typename C, int F>
__global__ void brickgrid_backward_kernel(const T* __restrict__ table,
                                          const float* __restrict__ pos,
                                          const C* __restrict__ grad,
                                          float* __restrict__ d_table,
                                          float* __restrict__ d_pos, long long n,
                                          const BrickParams p) {
  extern __shared__ float s_acc[];  // [level][axis (4)][lane]
  const int lane = threadIdx.x & 31, lvl = threadIdx.x >> 5;
  const int L = p.n_levels;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = i < n;
  const bool has_t = p.n_dims == 4;
  const int cpa = (1 << p.log2_brick_size) + 1;
  Geo g = {};
  float gf[F];
  if (live) {
    g = level_geo(p, pos + i * p.n_dims, lvl);
    emt::load_vec<C, F>(grad + (i * L + lvl) * F, gf);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = 0.f;
  }
  const float tw0 = has_t ? __fsub_rn(1.f, g.tfrac) : 1.f;

  // the position gradient first: a loop of loads and arithmetic only,
  // whose loads the compiler can keep in flight across corners
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (d_pos != nullptr && live) {
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float wz = dz ? g.frac[2] : __fsub_rn(1.f, g.frac[2]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? g.frac[1] : __fsub_rn(1.f, g.frac[1]);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float wx = dx ? g.frac[0] : __fsub_rn(1.f, g.frac[0]);
          const long long slot =
              ((g.off[0] + dx) + cpa * ((g.off[1] + dy) + cpa * (g.off[2] + dz))) * F;
          float feat[F];
          emt::load_vec<T, F, C>(table + g.r0 + slot, feat);
          float dot0 = 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f) dot0 = __fadd_rn(dot0, __fmul_rn(gf[f], feat[f]));
          float gl = dot0;
          if (has_t) {
            emt::load_vec<T, F, C>(table + g.r1 + slot, feat);
            float dot1 = 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f) dot1 = __fadd_rn(dot1, __fmul_rn(gf[f], feat[f]));
            gl = __fadd_rn(__fmul_rn(dot0, tw0), __fmul_rn(dot1, g.tfrac));
            const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
            acc[3] = __fadd_rn(acc[3], __fmul_rn(w, __fsub_rn(dot1, dot0)));
          }
          // dW/dfrac_a: the axis' own weight becomes +-1
          const float pyz = __fmul_rn(wy, wz), pxz = __fmul_rn(wx, wz), pxy = __fmul_rn(wx, wy);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(dx ? pyz : -pyz, gl));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(dy ? pxz : -pxz, gl));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(dz ? pxy : -pxy, gl));
        }
      }
    }
  }

  // the table gradient: per (dz, dy, time slice) one merged span of the
  // dx = 0 and dx = 1 corners' 2F values
  const float wx0 = __fsub_rn(1.f, g.frac[0]), wx1 = g.frac[0];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? g.frac[2] : __fsub_rn(1.f, g.frac[2]);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? g.frac[1] : __fsub_rn(1.f, g.frac[1]);
      const float w0 = __fmul_rn(__fmul_rn(wx0, wy), wz);
      const float w1 = __fmul_rn(__fmul_rn(wx1, wy), wz);
      const long long slot = (g.off[0] + cpa * ((g.off[1] + dy) + cpa * (g.off[2] + dz))) * F;
#pragma unroll 2
      for (int s = 0; s < (has_t ? 2 : 1); ++s) {
        const float tw = s ? g.tfrac : tw0;
        const long long key = live ? (s ? g.r1 : g.r0) + slot : -1LL;
        float v[2 * F];
        const float a0 = __fmul_rn(w0, tw), a1 = __fmul_rn(w1, tw);
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __fmul_rn(a0, gf[f]), v[F + f] = __fmul_rn(a1, gf[f]);
        if (emt::merge_runs<2 * F>(key, -1LL, v, lane)) emt::add_span<2 * F>(d_table + key, v);
      }
    }
  }
  if (d_pos == nullptr) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) s_acc[(lvl * 4 + a) * 32 + lane] = acc[a];
  __syncthreads();
  if (lvl != 0 || !live) return;
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int l = 0; l < L; ++l) {
    const float sc = p.scales[l];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      dp[a] = __fadd_rn(dp[a], __fmul_rn(s_acc[(l * 4 + a) * 32 + lane], sc));
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (a < p.n_dims) d_pos[i * p.n_dims + a] = dp[a];
}

// d <- float(bf16(d)) in place, n floats, d 16-byte aligned.  Most of a
// gradient buffer stays zero (rows no point touched), and a zero rounds to
// itself, so a vector is written back only where rounding changed it.
__global__ void round_to_bf16_kernel(float* __restrict__ d, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* d4 = reinterpret_cast<float4*>(d);
  for (long long k = t; k < n / 4; k += stride) {
    const float4 v = d4[k];
    const float4 r = make_float4(
        emt::to_compute<__nv_bfloat16>(v.x), emt::to_compute<__nv_bfloat16>(v.y),
        emt::to_compute<__nv_bfloat16>(v.z), emt::to_compute<__nv_bfloat16>(v.w));
    if (r.x != v.x || r.y != v.y || r.z != v.z || r.w != v.w) d4[k] = r;
  }
  for (long long k = n / 4 * 4 + t; k < n; k += stride) d[k] = emt::to_compute<__nv_bfloat16>(d[k]);
}

#define EMT_F_CASES(CASE) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)

template <typename T, typename C>
cudaError_t launch_typed(const void* table, const float* pos, void* out,
                         long long n, const BrickParams& p, cudaStream_t s) {
  const int threads = 32 * p.n_levels;
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  const size_t smem = sizeof(C) * 32 * p.n_levels * p.n_features;
  const T* tab = static_cast<const T*>(table);
  C* o = static_cast<C*>(out);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                                   \
  case FV:                                                                             \
    brickgrid_encode_kernel<T, C, FV><<<blocks, threads, smem, s>>>(tab, pos, o, n, p); \
    break;
    EMT_F_CASES(EMT_CASE)
#undef EMT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_backward_typed(const void* table, const float* pos,
                                  const void* grad, float* d_table, float* d_pos,
                                  long long n, const BrickParams& p, cudaStream_t s) {
  const int threads = 32 * p.n_levels;
  const size_t smem = d_pos != nullptr ? sizeof(float) * p.n_levels * 4 * 32 : 0;
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  const T* tab = static_cast<const T*>(table);
  const C* g = static_cast<const C*>(grad);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                                 \
  case FV:                                                                           \
    brickgrid_backward_kernel<T, C, FV><<<blocks, threads, smem, s>>>(tab, pos, g,   \
                                                                      d_table, d_pos, \
                                                                      n, p);          \
    break;
    EMT_F_CASES(EMT_CASE)
#undef EMT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The four (storage, compute) pairs: T in {fp32, bf16} x C in {fp32, bf16}.
template <template <typename, typename> class Launch, typename... Args>
cudaError_t by_types(int table_is_bf16, int compute_is_bf16, Args... args) {
  using bf16 = __nv_bfloat16;
  if (table_is_bf16)
    return compute_is_bf16 ? Launch<bf16, bf16>::run(args...) : Launch<bf16, float>::run(args...);
  return compute_is_bf16 ? Launch<float, bf16>::run(args...) : Launch<float, float>::run(args...);
}

template <typename T, typename C>
struct Forward {
  static cudaError_t run(const void* table, const float* pos, void* out, long long n,
                         const BrickParams& p, cudaStream_t s) {
    return launch_typed<T, C>(table, pos, out, n, p, s);
  }
};

template <typename T, typename C>
struct Backward {
  static cudaError_t run(const void* table, const float* pos, const void* grad, float* d_table,
                         float* d_pos, long long n, const BrickParams& p, cudaStream_t s) {
    return launch_backward_typed<T, C>(table, pos, grad, d_table, d_pos, n, p, s);
  }
};

}  // namespace

// table: (L*B, W) in its storage dtype, 16-byte aligned; grad: (n, L*F) in
// the compute dtype; d_table: the zeroed fp32 (L*B, W) buffer, returned
// rounded to bf16 precision when an fp32 table serves a bf16 computation.
extern "C" int emt_brickgrid_backward(const void* table, int table_is_bf16,
                                      int compute_is_bf16, const void* positions,
                                      const void* grad, void* d_table, void* d_pos,
                                      long long n_points, const void* params,
                                      void* stream) {
  const BrickParams p = *static_cast<const BrickParams*>(params);
  if (p.n_levels < 1 || p.n_levels > kMaxLevels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dt = static_cast<float*>(d_table);
  if (n_points > 0) {
    const cudaError_t err = by_types<Backward>(
        table_is_bf16, compute_is_bf16, table, static_cast<const float*>(positions), grad, dt,
        static_cast<float*>(d_pos), n_points, p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!table_is_bf16 && compute_is_bf16) {
    const long long numel = p.n_levels * p.bricks_per_level * p.row_width;
    const long long want = (numel / 4 + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : want < 132 * 16 ? want : 132 * 16);
    round_to_bf16_kernel<<<blocks, 256, 0, s>>>(dt, numel);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: (L*B, W) in its storage dtype, 16-byte aligned; out: (n, L*F) in
// the compute dtype.
extern "C" int emt_brickgrid_encode(const void* table, int table_is_bf16,
                                    int compute_is_bf16, const void* positions, void* out,
                                    long long n_points, const void* params,
                                    void* stream) {
  const BrickParams p = *static_cast<const BrickParams*>(params);
  if (p.n_levels < 1 || p.n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  return static_cast<int>(by_types<Forward>(
      table_is_bf16, compute_is_bf16, table, static_cast<const float*>(positions), out,
      n_points, p, static_cast<cudaStream_t>(stream)));
}
