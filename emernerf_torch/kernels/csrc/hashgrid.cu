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
// gradient) and, in the backward, the dense gradient table written once in
// the table's dtype.  The arithmetic, ~2^D (D - 1 + 2F) FLOPs per (point,
// level) in the forward and ~2^D (D - 1 + 3F + D^2) in the backward with position
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
// Backward.  What bounds it on this card is the pattern of its atomics, not
// their number: 2^D corners per (point, level) each add F values w * g_f
// into the table gradient.  Into the feature-major (F, L*T) layout a
// corner's F values lie L*T*4 bytes apart, so each corner cost F separate
// L2 sector read-modify-writes (one thread per point, ~25 G atomics/s),
// while coalesced fp32 atomics into an L2-resident table run at ~370 G/s
// (P3, gather_scatter.cu).  The design:
//   - the gradient is summed into a zeroed fp32 FEATURES-MINOR (L*T, F)
//     scratch, one vector atomic per corner (float4 for F = 4, float2 for
//     F = 2, a scalar for F = 1: F times fewer sector operations; for
//     F <= 2 one atomic for two corners where their rows form an aligned
//     pair); a second small kernel transposes the scratch to (F, L*T) and
//     casts it to the table's dtype once, so the parameter layout stays
//     the JAX package's;
//   - one warp per (32 consecutive points, level): a block holds the L
//     warps of 32 points.  In training, consecutive points are consecutive
//     samples of a ray, so on the coarse levels neighbouring lanes hit the
//     same row.  Before each corner's atomic the warp merges runs of lanes
//     with equal rows (a segmented shuffle sum into the run's first lane),
//     so that each run issues one atomic; a warp whose 32 rows all differ
//     skips the merge after one ballot, so the merge costs nothing on the
//     fine hashed levels where it cannot pay;
//   - position gradients: each warp re-reads its corners' F features from
//     the feature-major table (F 2-byte loads, in a loop of their own
//     before the atomics, so that the loads of all corners can be in
//     flight at once), forms gdotf = sum_f feat_f * g_f and its level's
//       acc_i = sum_c gdotf_c * dW_c/dfrac_i
//     (dW_c/dfrac_i the signed product of the other dimensions' factors) in
//     corner order, writes acc to shared memory, and the block's first warp
//     sums d_pos = d_pos + acc_l * scale_l over the levels in order: no
//     atomics on d_pos, the plain version's order of operations exactly.
// Dense coarse levels are not accumulated in shared memory: a block of 32
// points would flush the whole level (16^3 rows for the static grid's
// first level) for a few hundred corner updates.
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

constexpr unsigned kFullMask = 0xffffffffu;

// Read-only loads through the non-coherent path (the backward's table).
__device__ __forceinline__ float load_nc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_nc(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
constexpr unsigned kNoRow = 0xffffffffu;  // lanes past the last point (rows < 2^30)

// The F values of one (point, level) of the cotangent, in one load where F
// values of T fill 4, 8 or 16 aligned bytes.
template <typename T, int F>
__device__ __forceinline__ void load_grad(const T* p, float (&g)[F]) {
  if constexpr (sizeof(T) == 4 && F == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    g[0] = v.x, g[1] = v.y, g[2] = v.z, g[3] = v.w;
  } else if constexpr (sizeof(T) == 4 && F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    g[0] = v.x, g[1] = v.y;
  } else if constexpr (sizeof(T) == 2 && F == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    g[0] = __low2float(a), g[1] = __high2float(a), g[2] = __low2float(b), g[3] = __high2float(b);
  } else if constexpr (sizeof(T) == 2 && F == 2) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v);
    g[0] = __low2float(a), g[1] = __high2float(a);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = load_f(p + f);
  }
}

// One vector atomic of a corner's F values into its features-minor row.
template <int F>
__device__ __forceinline__ void add_row(float* p, const float (&v)[F]) {
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Sums the F values v of runs of neighbouring lanes with equal rows into
// the run's first lane (a segmented suffix sum by shuffles, as many steps
// as the longest run needs).  Returns whether this lane must add its v to
// `row` (the first lane of its run, and a row: not kNoRow).  The whole
// warp must call it.  Equal rows that are not neighbours stay separate.
template <int F>
__device__ __forceinline__ bool merge_runs(unsigned row, float (&v)[F], int lane) {
  const unsigned left = __shfl_up_sync(kFullMask, row, 1);
  const bool head = lane == 0 || left != row;
  const unsigned heads = __ballot_sync(kFullMask, head);
  if (heads != kFullMask) {
    const unsigned later = heads & (0xfffffffeu << lane);  // heads after this lane
    const int last = later ? __ffs(later) - 2 : 31;        // the run's last lane
    const int span = __reduce_max_sync(kFullMask, static_cast<unsigned>(last - lane));
    for (int off = 1; off <= span; off <<= 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float o = __shfl_down_sync(kFullMask, v[f], off);
        if (lane + off <= last) v[f] += o;
      }
    }
  }
  return head && row != kNoRow;
}

// Adds the merged values of two corners that differ in dimension 0 (rows
// r0 != r1), F <= 2.  Where the two rows are the halves of one aligned
// pair (r0 ^ r1 == 1: half of such corner pairs on hashed and on linear
// levels), one float2 (F = 1) or float4 (F = 2) atomic covers both.
template <int F>
__device__ __forceinline__ void add_corner_pair(float* __restrict__ dst, unsigned r0,
                                                unsigned r1, const float (&v0)[F],
                                                const float (&v1)[F], bool add0, bool add1) {
  static_assert(F <= 2, "two rows of F <= 2 floats fill one vector atomic");
  if (add0 && add1 && (r0 ^ r1) == 1u) {
    const float(&lo)[F] = (r0 & 1u) ? v1 : v0;
    const float(&hi)[F] = (r0 & 1u) ? v0 : v1;
    float* p = dst + static_cast<long long>(r0 & ~1u) * F;
    if constexpr (F == 1)
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(lo[0], hi[0]));
    else
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(lo[0], lo[1], hi[0], hi[1]));
    return;
  }
  if (add0) add_row<F>(dst + static_cast<long long>(r0) * F, v0);
  if (add1) add_row<F>(dst + static_cast<long long>(r1) * F, v1);
}

// Block: L warps x 32 points; warp l takes level l of the block's 32
// consecutive points.  d_table: the zeroed fp32 features-minor (L*T, F)
// scratch.  d_pos (or nullptr) needs L*D*32 floats of dynamic shared
// memory.
template <typename T, int D, int F>
__global__ void hashgrid_backward_kernel(const T* __restrict__ table,
                                         const float* __restrict__ pos,
                                         const T* __restrict__ grad,
                                         float* __restrict__ d_table,
                                         float* __restrict__ d_pos, long long n,
                                         const HashParams p) {
  extern __shared__ float s_acc[];  // [level][dimension][lane]
  const int lane = threadIdx.x & 31, lvl = threadIdx.x >> 5;
  const int L = p.n_levels;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = i < n;
  const long long lt = static_cast<long long>(L) << p.log2_table;  // feature stride
  const T* tab = table + (static_cast<long long>(lvl) << p.log2_table);
  float* dst = d_table + (static_cast<long long>(lvl) << p.log2_table) * F;

  unsigned grid[D];
  float frac[D], gf[F];
  if (live) {
    level_cell<D>(p, pos + i * D, lvl, grid, frac);
    load_grad<T, F>(grad + (i * L + lvl) * F, gf);
  } else {
#pragma unroll
    for (int a = 0; a < D; ++a) grid[a] = 0u, frac[a] = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = 0.f;
  }
  // the position gradient first: a loop of loads and arithmetic only,
  // whose loads the compiler can keep in flight across corners
  float acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = 0.f;
  if (d_pos != nullptr && live) {
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const T* row = tab + corner_row<D>(p, lvl, grid, c);
      float gdotf = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f)
        gdotf = __fadd_rn(gdotf, __fmul_rn(load_nc(row + f * lt), gf[f]));
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const float dw = factor_product<D>(frac, c, a);
        acc[a] = __fadd_rn(acc[a], __fmul_rn(gdotf, ((c >> a) & 1) ? dw : -dw));
      }
    }
  }
  // the table gradient: for F <= 2, corners in pairs (c, c + 1) that
  // differ in dimension 0; for F = 4 (no wider vector atomic), each
  // corner's atomic as soon as its runs are merged
#pragma unroll
  for (int c = 0; c < (1 << D); c += (F <= 2 ? 2 : 1)) {
    constexpr int K = F <= 2 ? 2 : 1;
    unsigned row[K];
    float v[K][F];
    bool add[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      row[k] = live ? corner_row<D>(p, lvl, grid, c + k) : kNoRow;
      const float w = factor_product<D>(frac, c + k, -1);
#pragma unroll
      for (int f = 0; f < F; ++f) v[k][f] = __fmul_rn(w, gf[f]);
      add[k] = merge_runs<F>(row[k], v[k], lane);
    }
    if constexpr (K == 2)
      add_corner_pair<F>(dst, row[0], row[1], v[0], v[1], add[0], add[1]);
    else if (add[0])
      add_row<F>(dst + static_cast<long long>(row[0]) * F, v[0]);
  }
  if (d_pos == nullptr) return;
#pragma unroll
  for (int a = 0; a < D; ++a) s_acc[(lvl * D + a) * 32 + lane] = acc[a];
  __syncthreads();
  if (lvl != 0 || !live) return;
  float dp[D];
#pragma unroll
  for (int a = 0; a < D; ++a) dp[a] = 0.f;
  for (int l = 0; l < L; ++l) {
    const float sc = p.scales[l];
#pragma unroll
    for (int a = 0; a < D; ++a)
      dp[a] = __fadd_rn(dp[a], __fmul_rn(s_acc[(l * D + a) * 32 + lane], sc));
  }
#pragma unroll
  for (int a = 0; a < D; ++a) d_pos[i * D + a] = dp[a];
}

// The features-minor fp32 (rows, F) gradient -> feature-major (F, rows) in
// the table's dtype, one row per thread (coalesced vector reads, coalesced
// writes per feature plane).
template <typename T, int F>
__global__ void transpose_cast_kernel(const float* __restrict__ src, T* __restrict__ out,
                                      long long rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; r < rows;
       r += stride) {
    float v[F];
    if constexpr (F == 4) {
      const float4 x = reinterpret_cast<const float4*>(src)[r];
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else if constexpr (F == 2) {
      const float2 x = reinterpret_cast<const float2*>(src)[r];
      v[0] = x.x, v[1] = x.y;
    } else {
      v[0] = src[r];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) store_f(out + f * rows + r, v[f]);
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

// The scatter into the features-minor scratch, then its transpose and cast
// into d_table (F, L*T) of the table's dtype T.
template <typename T, int D, int F>
cudaError_t backward_f(const T* tab, const float* pos, const T* g, float* scratch, T* d_table,
                       float* d_pos, long long n, const HashParams& p, cudaStream_t s) {
  const int threads = 32 * p.n_levels;
  const size_t smem = d_pos != nullptr ? sizeof(float) * p.n_levels * D * 32 : 0;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
    hashgrid_backward_kernel<T, D, F><<<blocks, threads, smem, s>>>(tab, pos, g, scratch, d_pos,
                                                                    n, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long rows = static_cast<long long>(p.n_levels) << p.log2_table;
  const long long want = (rows + 255) / 256;
  transpose_cast_kernel<T, F><<<static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16), 256,
                                0, s>>>(scratch, d_table, rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_backward(const void* table, const float* pos, const void* grad,
                            float* scratch, void* d_table, float* d_pos, long long n,
                            const HashParams& p, cudaStream_t s) {
  const T* tab = static_cast<const T*>(table);
  const T* g = static_cast<const T*>(grad);
  T* out = static_cast<T*>(d_table);
  switch (p.n_features) {
    case 1: return backward_f<T, D, 1>(tab, pos, g, scratch, out, d_pos, n, p, s);
    case 2: return backward_f<T, D, 2>(tab, pos, g, scratch, out, d_pos, n, p, s);
    case 4: return backward_f<T, D, 4>(tab, pos, g, scratch, out, d_pos, n, p, s);
    default: return cudaErrorInvalidValue;
  }
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

// scratch: a zeroed fp32 (L*T, F) buffer; d_table: the (F, L*T) gradient
// in the table's dtype, written whole; grad: 16-byte aligned.
extern "C" int emt_hashgrid_backward(const void* table, int table_is_bf16,
                                     const void* positions, const void* grad, void* scratch,
                                     void* d_table, void* d_pos, long long n_points,
                                     const void* params, void* stream) {
  const HashParams p = *static_cast<const HashParams*>(params);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pos = static_cast<const float*>(positions);
  float* sc = static_cast<float*>(scratch);
  float* dp = static_cast<float*>(d_pos);
  cudaError_t err;
  if (table_is_bf16) {
    err = p.n_dims == 3
        ? launch_backward<__nv_bfloat16, 3>(table, pos, grad, sc, d_table, dp, n_points, p, s)
        : launch_backward<__nv_bfloat16, 4>(table, pos, grad, sc, d_table, dp, n_points, p, s);
  } else {
    err = p.n_dims == 3
        ? launch_backward<float, 3>(table, pos, grad, sc, d_table, dp, n_points, p, s)
        : launch_backward<float, 4>(table, pos, grad, sc, d_table, dp, n_points, p, s);
  }
  return static_cast<int>(err);
}
