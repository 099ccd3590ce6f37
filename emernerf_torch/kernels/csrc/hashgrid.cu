// Multi-resolution hash-grid encoder forward and backward (K4).
//
// Replaces: emernerf_tpu/ops/hashgrid.py:hashgrid_encode (the custom-VJP op
// at :312, forward :408) and its backward _hashgrid_bwd (:415).  The TPU
// version runs one unrolled loop over levels of XLA gathers from a
// feature-major (F, L*T) table, chunked along the points to bound the
// lane-padded gather temporaries, and XLA scatter-adds in the backward.
//
// What bounds it on the H100: random reads (forward) and fp32 atomic adds
// (backward) at 2^D corners x F features per (point, level), scattered over
// tables of 8-84 MB that only partly fit the 50 MB L2: the rate of L2
// sector requests, one per corner row and load.  One
// call's least time is the bytes it must move over 3.35 TB/s: positions in,
// encodings out, the table entries the points touch (forward and position
// gradient) and, in the backward, the dense gradient table written once in
// the table's dtype.  The arithmetic, ~2^D (D - 1 + 2F) FLOPs per (point,
// level) in the forward and ~2^D (D - 1 + 3F + D^2) in the backward with position
// gradients, is below the card's fp32 rate except for the latter on 4D.
//
// Design.  Forward: the wrapper hands the kernels a FEATURES-MINOR (L*T, F)
// copy of the feature-major (F, L*T) table (the JAX package's layout, kept
// for the parameter; F = 1 tables are both layouts at once and are not
// copied), so that a corner's F features are one vector load (8 bytes for
// bf16 F = 4) instead of F separate 2-byte loads L*T elements apart, each
// its own 32-byte sector request.  One warp per (32 consecutive points,
// level): a block holds the L warps of 32 points, so on the coarse levels
// neighbouring samples of a ray share the load instructions' sectors.  Each
// lane forms its 2^D corner rows, issues all corners' loads in a loop before
// the arithmetic, then sums w_c * feat_c in corner order (bit i of the corner
// index is dimension i; each weight a product in dimension order) in fp32.
// The block's 32 x L x F encodings are staged in shared memory, rounded once
// to the table's dtype, and written as one contiguous tile.  F is 1, 2 or 4
// (the grids of every profile); any other F is refused.
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
//     the forward's features-minor copy (one vector load per corner, in a
//     loop of its own before the atomics, so that the loads of all corners
//     can be in flight at once), forms gdotf = sum_f feat_f * g_f and its level's
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

#include "grid_common.cuh"

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

using emt::store_f;

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

// Block: L warps x 32 points; warp l takes level l of the block's 32
// consecutive points.  table: the features-minor (L*T, F) copy.  Needs
// 32 * L * F * sizeof(T) bytes of dynamic shared memory (the output tile).
template <typename T, int D, int F>
__global__ void hashgrid_encode_kernel(const T* __restrict__ table,
                                       const float* __restrict__ pos,
                                       T* __restrict__ out, long long n,
                                       const HashParams p) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_out = reinterpret_cast<T*>(s_raw);  // [lane][level][feature]
  const int lane = threadIdx.x & 31, lvl = threadIdx.x >> 5;
  const int L = p.n_levels;
  const long long first = static_cast<long long>(blockIdx.x) * 32;
  const long long i = first + lane;
  if (i < n) {
    unsigned grid[D];
    float frac[D];
    level_cell<D>(p, pos + i * D, lvl, grid, frac);
    const T* tab = table + (static_cast<long long>(lvl) << p.log2_table) * F;
    float feat[1 << D][F];
#pragma unroll
    for (int c = 0; c < (1 << D); ++c)
      emt::load_vec<T, F>(tab + static_cast<long long>(corner_row<D>(p, lvl, grid, c)) * F,
                           feat[c]);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const float w = factor_product<D>(frac, c, -1);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, feat[c][f]));
    }
    T* o = s_out + (lane * L + lvl) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) store_f(o + f, acc[f]);
  }
  __syncthreads();
  // the block's rows of the (n, L * F) output are one contiguous tile
  const long long rows = n - first < 32 ? n - first : 32;
  const int count = static_cast<int>(rows) * L * F;
  constexpr int kVec = 16 / sizeof(T);
  T* dst = out + first * L * F;
  for (int k = threadIdx.x; k < count / kVec; k += blockDim.x)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(s_out)[k];
  for (int k = count / kVec * kVec + threadIdx.x; k < count; k += blockDim.x) dst[k] = s_out[k];
}

constexpr unsigned kNoRow = 0xffffffffu;  // lanes past the last point (rows < 2^30)

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
    float both[2 * F];
#pragma unroll
    for (int f = 0; f < F; ++f) both[f] = lo[f], both[F + f] = hi[f];
    emt::add_span<2 * F>(dst + static_cast<long long>(r0 & ~1u) * F, both);
    return;
  }
  if (add0) emt::add_span<F>(dst + static_cast<long long>(r0) * F, v0);
  if (add1) emt::add_span<F>(dst + static_cast<long long>(r1) * F, v1);
}

// Block: L warps x 32 points; warp l takes level l of the block's 32
// consecutive points.  d_table: the zeroed fp32 features-minor (L*T, F)
// scratch.  d_pos (or nullptr) needs L*D*32 floats of dynamic shared
// memory.  table: the forward's features-minor (L*T, F) copy.
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
  const T* tab = table + (static_cast<long long>(lvl) << p.log2_table) * F;
  float* dst = d_table + (static_cast<long long>(lvl) << p.log2_table) * F;

  unsigned grid[D];
  float frac[D], gf[F];
  if (live) {
    level_cell<D>(p, pos + i * D, lvl, grid, frac);
    emt::load_vec<T, F>(grad + (i * L + lvl) * F, gf);
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
      float feat[F];
      emt::load_vec<T, F>(tab + static_cast<long long>(corner_row<D>(p, lvl, grid, c)) * F, feat);
      float gdotf = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) gdotf = __fadd_rn(gdotf, __fmul_rn(feat[f], gf[f]));
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
      add[k] = emt::merge_runs<F>(row[k], kNoRow, v[k], lane);
    }
    if constexpr (K == 2)
      add_corner_pair<F>(dst, row[0], row[1], v[0], v[1], add[0], add[1]);
    else if (add[0])
      emt::add_span<F>(dst + static_cast<long long>(row[0]) * F, v[0]);
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

// The feature-major (F, rows) table -> its features-minor (rows, F) copy,
// bits unchanged (W: a 2- or 4-byte word), one row per thread: coalesced
// reads of each feature plane, one F * sizeof(W)-byte vector store per row.
template <typename W, int F>
__global__ void features_minor_kernel(const W* __restrict__ src, W* __restrict__ out,
                                      long long rows) {
  struct alignas(F * sizeof(W)) Row { W v[F]; };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; r < rows;
       r += stride) {
    Row row;
#pragma unroll
    for (int f = 0; f < F; ++f) row.v[f] = __ldg(src + f * rows + r);
    reinterpret_cast<Row*>(out)[r] = row;
  }
}

template <typename W>
cudaError_t launch_features_minor(const void* table, void* out, long long rows, int f,
                                  cudaStream_t s) {
  const long long want = (rows + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  const W* src = static_cast<const W*>(table);
  W* dst = static_cast<W*>(out);
  switch (f) {
    case 2: features_minor_kernel<W, 2><<<blocks, 256, 0, s>>>(src, dst, rows); break;
    case 4: features_minor_kernel<W, 4><<<blocks, 256, 0, s>>>(src, dst, rows); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_forward(const void* table, const float* pos, void* out, long long n,
                           const HashParams& p, cudaStream_t s) {
  const int threads = 32 * p.n_levels;
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  const size_t smem = sizeof(T) * 32 * p.n_levels * p.n_features;
  const T* tab = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  switch (p.n_features) {
#define EMT_CASE(FV)                                                                     \
  case FV:                                                                               \
    hashgrid_encode_kernel<T, D, FV><<<blocks, threads, smem, s>>>(tab, pos, o, n, p);  \
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

// out (rows, F) <- table (F, rows), elements of elem_bytes (2 or 4) bytes,
// F in {2, 4}; out aligned to F * elem_bytes bytes.
extern "C" int emt_hashgrid_features_minor(const void* table, int elem_bytes, void* out,
                                           long long rows, int n_features, void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 2)
    err = launch_features_minor<uint16_t>(table, out, rows, n_features, s);
  else if (elem_bytes == 4)
    err = launch_features_minor<uint32_t>(table, out, rows, n_features, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// table: the features-minor (L*T, F) copy, 16-byte aligned.
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

// table: the features-minor (L*T, F) copy; scratch: a zeroed fp32 (L*T, F)
// buffer; d_table: the (F, L*T) gradient in the table's dtype, written
// whole; table and grad: 16-byte aligned.
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
