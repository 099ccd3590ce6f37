// Brick-grid encoder forward (K1).
//
// Replaces: emernerf_tpu/ops/brickgrid.py:brickgrid_encode (forward,
// _encode_impl).  The TPU version gathers one whole brick row per
// (point, level) and reduces it against a dense 27- or 125-wide weight row,
// because TPU gathers are bound by the row rate, not by the bytes.
//
// What bounds it on the H100: random reads of table rows that mostly miss
// L2 (the static and fused tables are ~0.3-0.6 GB), i.e. memory latency and
// DRAM sector traffic; the arithmetic is a few dozen FLOPs per (point, level).
//
// Design: one thread per (point, level), levels fastest so the L threads of
// one point share its position load and write one contiguous output row.
// Only the 8 corners with a non-zero trilinear weight are read (F values
// each, doubled for time-paired rows), not the dense weight row: that cuts
// the bytes per query from 27F (or 125F) to 8F.  Accumulation is fp32; the
// table may be fp32 or bf16 and the output is written in the table's dtype.
//
// Rounding: the cell and fraction math uses __fmul_rn / __fadd_rn so that
// nvcc cannot fuse x*scale+0.5 into an FMA.  A fused product moves points
// that sit next to a cell boundary into the neighbouring cell, and across a
// brick boundary that is a different table row.  The reduction uses the
// same explicitly rounded mul/add in the same corner order as the plain
// PyTorch version (emernerf_torch/ops/brickgrid.py:brickgrid_encode_ref).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T, int F>
__global__ void brickgrid_encode_kernel(const T* __restrict__ table,
                                        const float* __restrict__ pos,
                                        T* __restrict__ out, long long n,
                                        const BrickParams p) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int L = p.n_levels;
  if (tid >= n * L) return;
  const long long i = tid / L;
  const int lvl = static_cast<int>(tid - i * L);
  const float sc = p.scales[lvl];
  const int cells = 1 << p.log2_brick_size;
  const int cpa = cells + 1;

  float frac[3];
  int off[3];
  unsigned brick[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ps = __fadd_rn(__fmul_rn(__ldg(pos + i * p.n_dims + a), sc), 0.5f);
    const float c = floorf(ps);
    frac[a] = __fsub_rn(ps, c);
    const int ci = static_cast<int>(c);
    off[a] = ci & (cells - 1);
    brick[a] = static_cast<unsigned>(ci >> p.log2_brick_size);
  }
  const bool has_t = p.n_dims == 4;
  float tfrac = 0.f;
  unsigned tcell = 0u;
  if (has_t) {
    const float ps = __fadd_rn(__fmul_rn(__ldg(pos + i * p.n_dims + 3), sc), 0.5f);
    const float c = floorf(ps);
    tfrac = __fsub_rn(ps, c);
    tcell = static_cast<unsigned>(static_cast<int>(c));
  }
  const long long level_base = static_cast<long long>(lvl) * p.bricks_per_level;
  const unsigned row0 = brick_row(p, lvl, brick, has_t, tcell);
  const T* r0 = table + (level_base + row0) * p.row_width;
  const T* r1 = nullptr;  // the t+1 time corner, when the level has time
  if (has_t) {
    if (p.time_pair) {
      r1 = r0 + p.row_width / 2;
    } else {
      const unsigned row1 = brick_row(p, lvl, brick, true, tcell + 1u);
      r1 = table + (level_base + row1) * p.row_width;
    }
  }

  float acc0[F], acc1[F];
#pragma unroll
  for (int f = 0; f < F; ++f) { acc0[f] = 0.f; acc1[f] = 0.f; }
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? frac[2] : __fsub_rn(1.f, frac[2]);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? frac[1] : __fsub_rn(1.f, frac[1]);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? frac[0] : __fsub_rn(1.f, frac[0]);
        const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
        const int corner = (off[0] + dx) + cpa * ((off[1] + dy) + cpa * (off[2] + dz));
        const int lane = corner * F;
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc0[f] = __fadd_rn(acc0[f], __fmul_rn(w, load_f(r0 + lane + f)));
        if (r1 != nullptr) {
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc1[f] = __fadd_rn(acc1[f], __fmul_rn(w, load_f(r1 + lane + f)));
        }
      }
    }
  }
  T* o = out + i * static_cast<long long>(L) * F + lvl * F;
  if (has_t) {
    const float tw0 = __fsub_rn(1.f, tfrac);
#pragma unroll
    for (int f = 0; f < F; ++f)
      store_f(o + f, __fadd_rn(__fmul_rn(acc0[f], tw0), __fmul_rn(acc1[f], tfrac)));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) store_f(o + f, acc0[f]);
  }
}

template <typename T>
cudaError_t launch_typed(const void* table, const float* pos, void* out,
                         long long n, const BrickParams& p, cudaStream_t s) {
  const long long total = n * p.n_levels;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* tab = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                        \
  case FV:                                                                  \
    brickgrid_encode_kernel<T, FV><<<blocks, threads, 0, s>>>(tab, pos, o, n, p); \
    break;
    EMT_CASE(1) EMT_CASE(2) EMT_CASE(3) EMT_CASE(4)
    EMT_CASE(5) EMT_CASE(6) EMT_CASE(7) EMT_CASE(8)
#undef EMT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int emt_brickgrid_encode(const void* table, int table_is_bf16,
                                    const void* positions, void* out,
                                    long long n_points, const void* params,
                                    void* stream) {
  const BrickParams p = *static_cast<const BrickParams*>(params);
  if (p.n_levels < 1 || p.n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  cudaError_t err = table_is_bf16
      ? launch_typed<__nv_bfloat16>(table, pos, out, n_points, p, s)
      : launch_typed<float>(table, pos, out, n_points, p, s);
  return static_cast<int>(err);
}
