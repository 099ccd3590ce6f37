// Multi-resolution hash-grid encoder forward and backward (K4).
//
// Replaces: emernerf_tpu/ops/hashgrid.py:hashgrid_encode (the custom-VJP op
// at :312, forward :408) and its backward _hashgrid_bwd (:415).  The TPU
// version runs one unrolled loop over levels of XLA gathers from a
// feature-major (F, L*T) table, chunked along the points to bound the
// lane-padded gather temporaries, and XLA scatter-adds in the backward.
//
// What bounds it on the H100: random 2- or 4-byte reads (forward) and fp32
// atomic adds (backward) at 2^D corners x F features per (point, level),
// scattered over tables of 8-84 MB that only partly fit the 50 MB L2.  One
// call's least time is the bytes it must move over 3.35 TB/s: positions in,
// encodings out, the table entries the points touch (forward and position
// gradient) and, in the backward, the dense fp32 gradient table written
// once.  The arithmetic, ~2^D (D - 1 + 2F) FLOPs per (point, level) in the
// forward and ~2^D (D - 1 + 3F + D^2) in the backward with position
// gradients, is below the card's fp32 rate except for the latter on 4D.
//
// Design.  Forward: one thread per (point, level), levels fastest, so the L
// threads of a point share its position load and write one contiguous
// output row.  The thread loops over the 2^D corners in corner order (bit
// i of the corner index is dimension i), forms each weight as a product in
// dimension order, reads the F features of the corner's row (F separate
// loads: the table is feature-major, the JAX package's layout) and
// accumulates them in fp32; the encoding is written once in the table's
// dtype (bf16 or fp32).  F is 1, 2 or 4 (the grids of every profile);
// any other F is refused.
//
// Backward: one thread per POINT, looping over the levels.  Table
// gradients are atomicAdd(w * g) into a zeroed fp32 (F, L*T) buffer that
// the wrapper casts once to the table's dtype.  When the positions need a
// gradient (the flow-warped queries), the same thread re-reads each corner,
// forms gdotf = sum_f feat_f * g_f and accumulates
//   d_pos[i] += scale_l * sum_c gdotf_c * dW_c/dfrac_i
// with dW_c/dfrac_i the signed product of the other dimensions' factors, in
// registers over the levels in order: d_pos needs no atomics and follows
// the plain version's order of operations exactly.  The coarse linear
// levels (16^3-64^3 cells) put many points on each entry; their atomics
// contend, as K1's do.  That is measured, not fixed, here.
//
// Rounding: the cell math uses __fmul_rn / __fadd_rn so that nvcc cannot
// fuse x*scale+0.5 into an FMA (a fused product moves points next to a cell
// boundary into the neighbouring cell).  Every product and sum is rounded
// explicitly, in the order of the plain PyTorch version
// (emernerf_torch/ops/hashgrid.py).  Index math is unsigned int, which
// wraps as the reference's uint32 does; corner coordinates may reach R.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;

// Instant-NGP spatial-hash primes of dimensions 1-3 (prime_0 = 1, as in
// tiny-cuda-nn)
__device__ __forceinline__ unsigned prime(int a) {
  return a == 1 ? 2654435761u : (a == 2 ? 805459861u : 3674653429u);
}

struct HashParams {
  int n_levels;
  int n_features;
  int n_dims;      // 3 (xyz) or 4 (xyz + t)
  int log2_table;  // T = 2^log2_table entries per level
  float scales[kMaxLevels];
  unsigned strides[kMaxLevels * 4];  // per level: R^i mod 2^32 (linear rows)
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

// The cell coordinates and fractions of one point on one level.
template <int D>
__device__ __forceinline__ void level_cell(const HashParams& p, const float* x, int lvl,
                                           unsigned grid[D], float frac[D]) {
  const float sc = p.scales[lvl];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const float ps = __fadd_rn(__fmul_rn(__ldg(x + a), sc), 0.5f);
    const float c = floorf(ps);
    frac[a] = __fsub_rn(ps, c);
    grid[a] = static_cast<unsigned>(static_cast<int>(c));
  }
}

// Level-local row of corner c.
template <int D>
__device__ __forceinline__ unsigned corner_row(const HashParams& p, int lvl,
                                               const unsigned grid[D], int c) {
  unsigned r;
  if (p.uses_hash[lvl]) {
    r = grid[0] + (c & 1);
#pragma unroll
    for (int a = 1; a < D; ++a) r ^= (grid[a] + ((c >> a) & 1)) * prime(a);
  } else {
    const unsigned* s = p.strides + 4 * lvl;
    r = (grid[0] + (c & 1)) * s[0];
#pragma unroll
    for (int a = 1; a < D; ++a) r += (grid[a] + ((c >> a) & 1)) * s[a];
  }
  return r & ((1u << p.log2_table) - 1u);
}

// Weight factor of dimension a for corner c.
__device__ __forceinline__ float factor(const float* frac, int c, int a) {
  return ((c >> a) & 1) ? frac[a] : __fsub_rn(1.f, frac[a]);
}

// Product of the factors of corner c in dimension order, leaving out
// dimension `skip` (-1: none); 1 when nothing is left.
template <int D>
__device__ __forceinline__ float factor_product(const float* frac, int c, int skip) {
  float w = 1.f;
  bool first = true;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    if (a == skip) continue;
    const float t = factor(frac, c, a);
    w = first ? t : __fmul_rn(w, t);
    first = false;
  }
  return w;
}

template <typename T, int D, int F>
__global__ void hashgrid_encode_kernel(const T* __restrict__ table,
                                       const float* __restrict__ pos,
                                       T* __restrict__ out, long long n,
                                       const HashParams p) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int L = p.n_levels;
  if (tid >= n * L) return;
  const long long i = tid / L;
  const int lvl = static_cast<int>(tid - i * L);
  unsigned grid[D];
  float frac[D];
  level_cell<D>(p, pos + i * D, lvl, grid, frac);
  const long long lt = static_cast<long long>(L) << p.log2_table;  // feature stride
  const T* tab = table + (static_cast<long long>(lvl) << p.log2_table);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    const float w = factor_product<D>(frac, c, -1);
    const T* row = tab + corner_row<D>(p, lvl, grid, c);
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w, load_f(row + f * lt)));
  }
  T* o = out + tid * F;  // (i * L + lvl) * F
#pragma unroll
  for (int f = 0; f < F; ++f) store_f(o + f, acc[f]);
}

template <typename T, int D, int F>
__global__ void hashgrid_backward_kernel(const T* __restrict__ table,
                                         const float* __restrict__ pos,
                                         const T* __restrict__ grad,
                                         float* __restrict__ d_table,
                                         float* __restrict__ d_pos, long long n,
                                         const HashParams p) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int L = p.n_levels;
  const long long lt = static_cast<long long>(L) << p.log2_table;
  float dp[D];
#pragma unroll
  for (int a = 0; a < D; ++a) dp[a] = 0.f;

  for (int lvl = 0; lvl < L; ++lvl) {
    unsigned grid[D];
    float frac[D];
    level_cell<D>(p, pos + i * D, lvl, grid, frac);
    const long long base = static_cast<long long>(lvl) << p.log2_table;
    float gf[F];
    const T* gi = grad + (i * L + lvl) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = load_f(gi + f);

    float acc[D];
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] = 0.f;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const long long row = base + corner_row<D>(p, lvl, grid, c);
      const float w = factor_product<D>(frac, c, -1);
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(d_table + row + f * lt, __fmul_rn(w, gf[f]));
      if (d_pos != nullptr) {
        float gdotf = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          gdotf = __fadd_rn(gdotf, __fmul_rn(load_f(table + row + f * lt), gf[f]));
#pragma unroll
        for (int a = 0; a < D; ++a) {
          const float dw = factor_product<D>(frac, c, a);
          acc[a] = __fadd_rn(acc[a], __fmul_rn(gdotf, ((c >> a) & 1) ? dw : -dw));
        }
      }
    }
    if (d_pos != nullptr) {
      const float sc = p.scales[lvl];
#pragma unroll
      for (int a = 0; a < D; ++a) dp[a] = __fadd_rn(dp[a], __fmul_rn(acc[a], sc));
    }
  }
  if (d_pos != nullptr) {
#pragma unroll
    for (int a = 0; a < D; ++a) d_pos[i * D + a] = dp[a];
  }
}

template <typename T, int D>
cudaError_t launch_forward(const void* table, const float* pos, void* out, long long n,
                           const HashParams& p, cudaStream_t s) {
  const long long total = n * p.n_levels;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* tab = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                                  \
  case FV:                                                                            \
    hashgrid_encode_kernel<T, D, FV><<<blocks, threads, 0, s>>>(tab, pos, o, n, p);  \
    break;
    EMT_CASE(1) EMT_CASE(2) EMT_CASE(4)
#undef EMT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_backward(const void* table, const float* pos, const void* grad,
                            float* d_table, float* d_pos, long long n, const HashParams& p,
                            cudaStream_t s) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const T* tab = static_cast<const T*>(table);
  const T* g = static_cast<const T*>(grad);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                              \
  case FV:                                                                        \
    hashgrid_backward_kernel<T, D, FV><<<blocks, threads, 0, s>>>(tab, pos, g,    \
                                                                  d_table, d_pos, \
                                                                  n, p);          \
    break;
    EMT_CASE(1) EMT_CASE(2) EMT_CASE(4)
#undef EMT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool valid(const HashParams& p) {
  return p.n_levels >= 1 && p.n_levels <= kMaxLevels && (p.n_dims == 3 || p.n_dims == 4) &&
         p.log2_table >= 1 && p.log2_table <= 30;
}

}  // namespace

extern "C" int emt_hashgrid_encode(const void* table, int table_is_bf16,
                                   const void* positions, void* out, long long n_points,
                                   const void* params, void* stream) {
  const HashParams p = *static_cast<const HashParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  cudaError_t err;
  if (table_is_bf16) {
    err = p.n_dims == 3 ? launch_forward<__nv_bfloat16, 3>(table, pos, out, n_points, p, s)
                        : launch_forward<__nv_bfloat16, 4>(table, pos, out, n_points, p, s);
  } else {
    err = p.n_dims == 3 ? launch_forward<float, 3>(table, pos, out, n_points, p, s)
                        : launch_forward<float, 4>(table, pos, out, n_points, p, s);
  }
  return static_cast<int>(err);
}

extern "C" int emt_hashgrid_backward(const void* table, int table_is_bf16,
                                     const void* positions, const void* grad, void* d_table,
                                     void* d_pos, long long n_points, const void* params,
                                     void* stream) {
  const HashParams p = *static_cast<const HashParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  float* dt = static_cast<float*>(d_table);
  float* dp = static_cast<float*>(d_pos);
  cudaError_t err;
  if (table_is_bf16) {
    err = p.n_dims == 3
        ? launch_backward<__nv_bfloat16, 3>(table, pos, grad, dt, dp, n_points, p, s)
        : launch_backward<__nv_bfloat16, 4>(table, pos, grad, dt, dp, n_points, p, s);
  } else {
    err = p.n_dims == 3 ? launch_backward<float, 3>(table, pos, grad, dt, dp, n_points, p, s)
                        : launch_backward<float, 4>(table, pos, grad, dt, dp, n_points, p, s);
  }
  return static_cast<int>(err);
}
