// Row gather and scatter-add probes (P1-P4).
//
// Replaces: perf/pallas_experiments.py and perf/bench_scatter_alts.py, the
// four Pallas TPU probes that are the only functions of the repository
// reaching pl.pallas_call:
//   P1 perf/pallas_experiments.py:60 bench_pallas_gather_loop (body
//      gather_loop_kernel :50): out[i] = table[idx[i]], one row per step;
//   P2 perf/pallas_experiments.py:94 bench_pallas_gather_take (body
//      gather_take_kernel :90): the same gather as one take per tile;
//   P3 perf/pallas_experiments.py:124 bench_pallas_scatter_rmw (body :128):
//      out[idx[i]] += upd[i], accumulated in a table-sized scratch;
//   P4 perf/bench_scatter_alts.py:196 case_pallas_onehot (body :203):
//      out = onehot(rows)^T . bf16(upd), bf16 operands, fp32 accumulation.
// They measure the row gather and scatter-add rates that the grid encoders
// (K1, K4) live on: P3's atomics are K4 backward's, P4 asks whether a
// tensor-core one-hot product beats atomics for small tables.
//
// What bounds it on the H100: bytes.  A gather writes n rows and reads the
// indices and, at least once, the table; a scatter-add reads n rows and
// indices and writes the table.  Their arithmetic (none, or n*w adds) is
// far below the fp32 rate.  P4's one-hot product does 2*T*n*w tensor-core
// FLOPs for n*w adds of work: its route, not its work, can make it
// operation-bound.
//
// Design.  On the TPU the "fast memory" that holds the 4-8 MiB tables of
// P1-P3 is VMEM; on Hopper it is the 50 MB L2, not shared memory (at most
// 227 KB per block), so the tables stay in device memory and L2 serves
// the repeated rows.
//   P1: one thread per output element in a grid-stride loop (the
//       straightforward counterpart of the TPU's one-row-per-step loop).
//   P2: one block per tile of 2048 rows (the TPU tile) stages its indices
//       in shared memory; then each warp copies whole rows with 16-byte
//       vector loads and stores.
//   P3: one thread per update element, atomicAdd into a zeroed fp32
//       table (the wrapper zeroes it).
//   P4: a block owns a 128 x 64 tile of the (T, W) output and a range of
//       whole row tiles.  Per step of 64 update rows it stages the rows'
//       one-hot (128 x 64, bf16, set and cleared entry by entry) and the
//       bf16-rounded update tile (64 x 64, columns past W zero-padded) in
//       shared memory; 8 warps each multiply their 16 output rows with
//       WMMA bf16 16x16x16 fragments, accumulating in fp32 registers.  At
//       the end the partial tile is atomically added into the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

namespace {

constexpr int kTakeTile = 2048;  // rows per block of the take gather
constexpr int kThreads = 256;

template <typename T>
__global__ void gather_loop_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                   T* __restrict__ out, long long n, int w) {
  const long long total = n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / w;
    const int j = static_cast<int>(e - i * w);
    out[e] = table[static_cast<long long>(idx[i]) * w + j];
  }
}

__global__ void gather_take_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                                   uint4* __restrict__ out, long long n, int vecs_per_row) {
  __shared__ int s_idx[kTakeTile];
  const long long row0 = static_cast<long long>(blockIdx.x) * kTakeTile;
  const int rows = static_cast<int>(n - row0 < kTakeTile ? n - row0 : kTakeTile);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s_idx[r] = idx[row0 + r];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const uint4* src = table + static_cast<long long>(s_idx[r]) * vecs_per_row;
    uint4* dst = out + (row0 + r) * vecs_per_row;
    for (int v = lane; v < vecs_per_row; v += 32) dst[v] = src[v];
  }
}

__global__ void scatter_rmw_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                                   float* __restrict__ out, long long n, int w) {
  const long long total = n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / w;
    const int j = static_cast<int>(e - i * w);
    atomicAdd(out + static_cast<long long>(idx[i]) * w + j, upd[e]);
  }
}

// P4 tile sizes: output rows (8 warps x 16), output columns (4 fragments
// of 16), update rows per step
constexpr int kBT = 128, kBW = 64, kBK = 64;

__global__ void __launch_bounds__(kThreads)
onehot_scatter_kernel(const int* __restrict__ rows, const float* __restrict__ upd,
                      float* __restrict__ out, long long n, int t, int w,
                      long long rows_per_block, int w_blocks) {
  using namespace nvcuda;
  // one-hot A (kBT x kBK bf16, 16 KB) and update tile B (kBK x kBW bf16,
  // 8 KB); the fp32 partial C (kBT x kBW, 32 KB) reuses the same bytes at
  // the end
  __shared__ __align__(128) unsigned char smem[kBT * kBW * sizeof(float)];
  __shared__ int s_rows[kBK];
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* B = A + kBT * kBK;
  float* C = reinterpret_cast<float*>(smem);

  const int t0 = (blockIdx.x / w_blocks) * kBT;
  const int w0 = (blockIdx.x % w_blocks) * kBW;
  const long long n0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long n1 = n0 + rows_per_block < n ? n0 + rows_per_block : n;
  const int warp = threadIdx.x >> 5;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f), one = __float2bfloat16_rn(1.f);

  for (int e = threadIdx.x; e < kBT * kBK; e += kThreads) A[e] = zero;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBW / 16];
  for (int f = 0; f < kBW / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (long long k0 = n0; k0 < n1; k0 += kBK) {
    // column threadIdx.x of A is only ever written by thread threadIdx.x
    if (threadIdx.x < kBK) {
      const long long r = k0 + threadIdx.x;
      s_rows[threadIdx.x] = r < n1 ? rows[r] - t0 : -1;
    }
    for (int e = threadIdx.x; e < kBK * kBW; e += kThreads) {
      const int kk = e / kBW, c = e % kBW;
      const long long r = k0 + kk;
      B[e] = __float2bfloat16_rn(r < n1 && w0 + c < w ? upd[r * w + w0 + c] : 0.f);
    }
    __syncthreads();
    if (threadIdx.x < kBK) {
      const int row = s_rows[threadIdx.x];
      if (row >= 0 && row < kBT) A[row * kBK + threadIdx.x] = one;
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + warp * 16 * kBK + kk, kBK);
      for (int f = 0; f < kBW / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * kBW + f * 16, kBW);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
    if (threadIdx.x < kBK) {
      const int row = s_rows[threadIdx.x];
      if (row >= 0 && row < kBT) A[row * kBK + threadIdx.x] = zero;
    }
  }
  __syncthreads();
  for (int f = 0; f < kBW / 16; ++f)
    wmma::store_matrix_sync(C + warp * 16 * kBW + f * 16, acc[f], kBW, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBT * kBW; e += kThreads) {
    const int r = e / kBW, c = e % kBW;
    if (t0 + r < t && w0 + c < w)
      atomicAdd(out + static_cast<long long>(t0 + r) * w + w0 + c, C[e]);
  }
}

unsigned grid_stride_blocks(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
}

}  // namespace

// P1.  elem_bytes 4 (fp32) or 2 (bf16: rows are copied as bits).
extern "C" int emt_gather_loop(const void* table, int elem_bytes, const void* idx, void* out,
                               long long n, int w, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_stride_blocks(n * w);
  const int* i = static_cast<const int*>(idx);
  if (elem_bytes == 4)
    gather_loop_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), i, static_cast<float*>(out), n, w);
  else
    gather_loop_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(table), i, static_cast<uint16_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}

// P2.  row_bytes a multiple of 16; table and out 16-byte aligned.
extern "C" int emt_gather_take(const void* table, const void* idx, void* out, long long n,
                               int row_bytes, void* stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((n + kTakeTile - 1) / kTakeTile);
  gather_take_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(idx), static_cast<uint4*>(out),
      n, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// P3.  out: a zeroed fp32 (t, w) table.
extern "C" int emt_scatter_rmw(const void* idx, const void* upd, void* out, long long n, int w,
                               void* stream) {
  if (n == 0) return cudaSuccess;
  scatter_rmw_kernel<<<grid_stride_blocks(n * w), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(upd), static_cast<float*>(out),
      n, w);
  return static_cast<int>(cudaGetLastError());
}

// P4.  out: a zeroed fp32 (t, w) table; n a multiple of tile_n (a multiple
// of 64).  Each block takes whole tiles of tile_n rows, as many as keep
// about four blocks per SM over the output tiles.
extern "C" int emt_scatter_onehot(const void* rows, const void* upd, void* out, long long n,
                                  int t, int w, int tile_n, void* stream) {
  if (n == 0) return cudaSuccess;
  const int t_blocks = (t + kBT - 1) / kBT, w_blocks = (w + kBW - 1) / kBW;
  const long long tiles = n / tile_n;
  const long long out_blocks = static_cast<long long>(t_blocks) * w_blocks;
  long long splits = (4 * 132 + out_blocks - 1) / out_blocks;
  if (splits > tiles) splits = tiles;
  const long long tiles_per_block = (tiles + splits - 1) / splits;
  splits = (tiles + tiles_per_block - 1) / tiles_per_block;
  const dim3 grid(static_cast<unsigned>(out_blocks), static_cast<unsigned>(splits));
  onehot_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const float*>(upd), static_cast<float*>(out),
      n, t, w, tiles_per_block * tile_n, w_blocks);
  return static_cast<int>(cudaGetLastError());
}
