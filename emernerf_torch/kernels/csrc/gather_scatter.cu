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
// (K1, K4) live on: P3's atomics are K4 backward's; P4 (the TPU's one-hot
// MXU product) sizes a scatter-add that accumulates in on-chip memory.
//
// What bounds it on the H100: bytes.  A gather writes n rows and reads the
// indices and, at least once, the table; a scatter-add reads n rows and
// indices and writes the table.  Their arithmetic (none, or n*w adds) is
// far below the fp32 rate.  A one-hot product would do 2*T*n*w tensor-core
// FLOPs for P4's n*w adds of work (a WMMA version of it took time in T, not
// in bytes), so P4 here adds and multiplies nothing.
//
// Design.  On the TPU the "fast memory" that holds the 4-8 MiB tables of
// P1-P3 is VMEM; on Hopper it is the 50 MB L2, not shared memory (at most
// 227 KB per block), so the tables stay in device memory and L2 serves
// the repeated rows.
//   P1 (redesigned; it replaces the thread-per-element grid-stride loop of
//       this file's first version, whose per-element 64-bit division,
//       re-read index and 2- or 4-byte accesses reached 21-40% of the
//       bound): a warp per tile of 32 output rows, one coalesced load of
//       the tile's 32 indices, each broadcast with __shfl_sync; the warp
//       copies the tile's rows as one run of V-byte vectors, lane l moving
//       vectors l, l + 32, ... of the run, so a 512-byte fp32 row is one
//       16-byte-per-lane instruction and a 256-byte bf16 row half of one.
//       Each lane keeps kGatherUnroll loads in flight before it stores;
//       table reads take the read-only path (__ldg), output stores the
//       streaming hint (__stcs: the output is written once and must not
//       push the L2-resident table out).  One warp per tile, all tiles in
//       one grid.  A persistent grid, plain stores and Hopper bulk copies
//       (cp.async.bulk of each row into shared memory, one bulk store of
//       the tile) all ran slower: 63-81% of the bound against 84%
//       (PERF.md).  V is the widest of 16, 8, 4, 2 bytes that divides the
//       row and both pointers' alignment (ops/gather_scatter.py:p1_plan),
//       so odd widths and table views at an offset take narrower vectors.  Row and column of each vector
//       follow by carries, with no division.
//   P2: one block per tile of 2048 rows (the TPU tile) stages its indices
//       in shared memory; then each warp copies whole rows with 16-byte
//       vector loads and stores.
//   P3 (redesigned; it replaces the thread-per-element grid-stride loop of
//       this file's first version: a 64-bit division and an index load per
//       fp32 element, 2^29 scalar atomics at the probe's shape, update
//       reads through the cache, 45% of the bound): P1's pattern turned
//       round.  A warp per tile of 32 update rows, one coalesced load of
//       the tile's 32 indices, each broadcast with __shfl_sync; the warp
//       reads the tile's rows as one run of V-vectors (float4, float2 or
//       float: the widest that divides the row and both pointers'
//       alignment, ops/gather_scatter.py:p3_plan), lane l taking vectors
//       l, l + 32, ..., row and column by carries.  Each lane has
//       kScatterUnroll streaming loads (__ldcs: the updates are read once
//       and must not push the L2-resident table out) in flight before it
//       adds them with one vector reduction each (atomicAdd on float4 /
//       float2, sm_90's red.global.add.v4.f32 / .v2.f32) into the zeroed
//       fp32 table (the wrapper zeroes it): at w = 128 a quarter of a row
//       per instruction, 32x fewer atomic instructions than one per
//       element.  All tiles in one grid.  It runs at the L2's reduction
//       rate (~1.85 TB/s of fp32 adds whatever the vector width); a binned
//       route (update rows sorted by destination range, a block per range
//       accumulating in shared memory) matched it alone at w = 128 and
//       lost at odd widths and per call (PERF.md, P3).
//   P4: no one-hot product: the scatter-add itself, at N*W adds, reading
//       each update byte once.  Where the fp32 (T, W) table fits one
//       block's shared memory ((512, 108) is 221,184 of the 232,448
//       bytes), one block per SM takes a range of whole tiles of update
//       rows, one warp per row, lanes across the columns, rounds each value
//       to bf16 and adds it into its own copy of the table with
//       shared-memory atomics; then it flushes the copy with coalesced
//       global atomics (blocks x T x W adds, ~3% of N x W).  Larger tables
//       (up to 7.1 MB, L2-resident) take one vector reduction (atomicAdd on
//       float4) per 4 columns of an update row straight into the zeroed
//       table.  Column slabs in shared memory and rows binned by
//       destination row tile were measured against it and did not win
//       (PERF.md, P4).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kTakeTile = 2048;  // rows per block of the take gather
constexpr int kThreads = 256;
constexpr int kGatherUnroll = 8;  // P1: vector loads in flight per lane
constexpr int kScatterUnroll = 8;  // P3: vector loads in flight per lane

// P1: a warp per tile of 32 rows of vpr V-vectors each (see the header).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_loop_kernel(const V* __restrict__ table, const int* __restrict__ idx, V* __restrict__ out,
                   long long n, int vpr) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5)) << 5;
  if (row0 >= n) return;  // uniform across the warp
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  const int my_idx = lane < rows ? __ldg(idx + row0 + lane) : 0;
  const int total = rows * vpr;
  V* dst = out + row0 * vpr;
  // a step of 32 vectors moves a lane by dq rows and dr vectors
  const int dq = 32 / vpr, dr = 32 - dq * vpr;
  int r = lane / vpr, c = lane - r * vpr;
  for (int base = 0; base < total; base += 32 * kGatherUnroll) {
    V v[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int src = __shfl_sync(0xffffffffu, my_idx, r & 31);
      if (base + 32 * u + lane < total)
        v[u] = __ldg(table + static_cast<long long>(src) * vpr + c);
      r += dq;
      c += dr;
      if (c >= vpr) {
        c -= vpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int e = base + 32 * u + lane;
      if (e < total) __stcs(dst + e, v[u]);
    }
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

// P3: a warp per tile of 32 update rows of vpr V-vectors each (see the
// header).
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rmw_kernel(const int* __restrict__ idx, const V* __restrict__ upd, V* __restrict__ out,
                   long long n, int vpr) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5)) << 5;
  if (row0 >= n) return;  // uniform across the warp
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  const int my_idx = lane < rows ? __ldcs(idx + row0 + lane) : 0;
  const int total = rows * vpr;
  const V* src = upd + row0 * vpr;
  // a step of 32 vectors moves a lane by dq rows and dr vectors
  const int dq = 32 / vpr, dr = 32 - dq * vpr;
  int r = lane / vpr, c = lane - r * vpr;
  for (int base = 0; base < total; base += 32 * kScatterUnroll) {
    V v[kScatterUnroll];
    long long dst[kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int row = __shfl_sync(0xffffffffu, my_idx, r & 31);
      dst[u] = static_cast<long long>(row) * vpr + c;
      if (base + 32 * u + lane < total) v[u] = __ldcs(src + base + 32 * u + lane);
      r += dq;
      c += dr;
      if (c >= vpr) {
        c -= vpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u)
      if (base + 32 * u + lane < total) atomicAdd(out + dst[u], v[u]);
  }
}

unsigned grid_stride_blocks(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
}

// P4.
constexpr int kP4Threads = 1024;
constexpr int kP4Unroll = 4;  // update rows in flight per warp; 8 spill

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float4 bf16_round(float4 x) {
  return make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z), bf16_round(x.w));
}

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Shared-table kernel: block b adds update rows [b * per_block, ...),
// rounded to bf16, into its own copy s_tab of the whole (t, w) fp32 table:
// one warp per update row, kP4Unroll rows in flight, the lanes across the
// columns (coalesced reads).  Where w % 4 == 0 (upd 16-byte aligned) a
// lane reads 4 columns at once and adds them in an order rotated by lane /
// 8, so that the warp's 32 shared atomics of one row hit 32 different
// banks.  Then the block flushes its copy with coalesced global atomics,
// each block from its own offset, so that the blocks flushing at once hit
// different rows.
__global__ void __launch_bounds__(kP4Threads)
scatter_shared_table_kernel(const int* __restrict__ rows, const float* __restrict__ upd,
                            float* __restrict__ out, long long n, int t, int w,
                            long long per_block) {
  extern __shared__ float s_tab[];
  const int count = t * w;
  for (int e = threadIdx.x; e < count; e += blockDim.x) s_tab[e] = 0.f;
  __syncthreads();
  const long long k0 = blockIdx.x * per_block;
  const long long k1 = k0 + per_block < n ? k0 + per_block : n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int rot = lane >> 3;
  for (long long k = k0 + static_cast<long long>(warp) * kP4Unroll; k < k1;
       k += static_cast<long long>(n_warps) * kP4Unroll) {
    int src[kP4Unroll], dst[kP4Unroll];  // 32-bit: registers, not the stack
#pragma unroll
    for (int u = 0; u < kP4Unroll; ++u) {
      src[u] = k + u < k1 ? static_cast<int>(k + u) : -1;
      dst[u] = src[u] >= 0 ? __ldg(rows + src[u]) * w : 0;
    }
    if (w % 4 == 0) {
      for (int c = 4 * lane; c < w; c += 128) {
        float4 v[kP4Unroll];
#pragma unroll
        for (int u = 0; u < kP4Unroll; ++u) {
          const float* r = upd + static_cast<long long>(src[u]) * w + c;
          v[u] = src[u] >= 0 ? __ldg(reinterpret_cast<const float4*>(r))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kP4Unroll; ++u) {
          if (src[u] < 0) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = (j + rot) & 3;
            atomicAdd(s_tab + dst[u] + c + q, bf16_round(component(v[u], q)));
          }
        }
      }
    } else {
      for (int c = lane; c < w; c += 32) {
        float v[kP4Unroll];
#pragma unroll
        for (int u = 0; u < kP4Unroll; ++u)
          v[u] = src[u] >= 0 ? __ldg(upd + static_cast<long long>(src[u]) * w + c) : 0.f;
#pragma unroll
        for (int u = 0; u < kP4Unroll; ++u)
          if (src[u] >= 0) atomicAdd(s_tab + dst[u] + c, bf16_round(v[u]));
      }
    }
  }
  __syncthreads();
  const int shift = (count / gridDim.x / 32 * 32) * blockIdx.x % count;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int e = i + shift < count ? i + shift : i + shift - count;
    const float v = s_tab[e];
    if (v != 0.f) atomicAdd(out + e, v);
  }
}

// Reduction kernel: one thread per vector of an update row, one global
// reduction each into the L2-resident table (V = float4 where w % 4 == 0).
template <typename V>
__global__ void scatter_red_kernel(const int* __restrict__ rows, const V* __restrict__ upd,
                                   V* __restrict__ out, long long n, int wv) {
  const long long total = n * wv;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += stride) {
    const long long i = e / wv;
    atomicAdd(out + static_cast<long long>(__ldg(rows + i)) * wv + (e - i * wv),
              bf16_round(__ldg(upd + e)));
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}


}  // namespace

// P1.  vec_bytes (16, 8, 4 or 2) divides row_bytes and the alignment of
// table and out (ops/gather_scatter.py:p1_plan); rows are copied as bits.
template <typename V>
cudaError_t launch_gather_loop(const void* table, const int* idx, void* out, long long n,
                               int vpr, cudaStream_t s) {
  const long long blocks = ((n + 31) / 32 + kThreads / 32 - 1) / (kThreads / 32);
  gather_loop_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), n, vpr);
  return cudaGetLastError();
}

extern "C" int emt_gather_loop(const void* table, const void* idx, void* out, long long n,
                               int row_bytes, int vec_bytes, void* stream) {
  if (n == 0 || row_bytes == 0) return cudaSuccess;
  if (vec_bytes <= 0 || row_bytes % vec_bytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const int vpr = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return launch_gather_loop<uint4>(table, i, out, n, vpr, s);
    case 8: return launch_gather_loop<uint2>(table, i, out, n, vpr, s);
    case 4: return launch_gather_loop<unsigned int>(table, i, out, n, vpr, s);
    case 2: return launch_gather_loop<unsigned short>(table, i, out, n, vpr, s);
    default: return cudaErrorInvalidValue;
  }
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

// P3.  out: a zeroed fp32 (t, w) table; vec_bytes (16, 8 or 4) divides
// 4 * w and the alignment of upd and out (ops/gather_scatter.py:p3_plan).
template <typename V>
cudaError_t launch_scatter_rmw(const int* idx, const void* upd, void* out, long long n, int vpr,
                               cudaStream_t s) {
  const long long blocks = ((n + 31) / 32 + kThreads / 32 - 1) / (kThreads / 32);
  scatter_rmw_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      idx, static_cast<const V*>(upd), static_cast<V*>(out), n, vpr);
  return cudaGetLastError();
}

extern "C" int emt_scatter_rmw(const void* idx, const void* upd, void* out, long long n, int w,
                               int vec_bytes, void* stream) {
  if (n == 0 || w == 0) return cudaSuccess;
  if (vec_bytes <= 0 || (4 * w) % vec_bytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const int vpr = 4 * w / vec_bytes;
  switch (vec_bytes) {
    case 16: return launch_scatter_rmw<float4>(i, upd, out, n, vpr, s);
    case 8: return launch_scatter_rmw<float2>(i, upd, out, n, vpr, s);
    case 4: return launch_scatter_rmw<float>(i, upd, out, n, vpr, s);
    default: return cudaErrorInvalidValue;
  }
}

// P4.  out: a zeroed fp32 (t, w) table; tile_n > 0; shared_table: whether
// the table goes through one block's shared memory (4 * t * w bytes at
// most the opt-in limit, ops/gather_scatter.py:p4_plan), else the global
// reductions; upd 16-byte aligned.
extern "C" int emt_scatter_onehot(const void* rows_, const void* upd_, void* out_, long long n,
                                  int t, int w, int tile_n, int shared_table, void* stream) {
  if (n == 0 || w == 0) return cudaSuccess;
  if (n > 0x7fffffffLL || tile_n <= 0) return cudaErrorInvalidValue;  // 32-bit row numbers
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rows = static_cast<const int*>(rows_);
  const float* upd = static_cast<const float*>(upd_);
  float* out = static_cast<float*>(out_);
  if (shared_table) {  // blocks take whole tiles, one block per SM
    const size_t smem = sizeof(float) * t * w;
    const cudaError_t err = allow_shared(scatter_shared_table_kernel, smem);
    if (err != cudaSuccess) return err;
    const int sms = sm_count();
    const long long tiles = (n + tile_n - 1) / tile_n;
    const long long per = (tiles + sms - 1) / sms;
    const long long blocks = (tiles + per - 1) / per;
    scatter_shared_table_kernel<<<static_cast<unsigned>(blocks), kP4Threads, smem, s>>>(
        rows, upd, out, n, t, w, per * tile_n);
  } else if (w % 4 == 0) {
    scatter_red_kernel<float4><<<grid_stride_blocks(n * (w / 4)), kThreads, 0, s>>>(
        rows, reinterpret_cast<const float4*>(upd), reinterpret_cast<float4*>(out), n, w / 4);
  } else {
    scatter_red_kernel<float><<<grid_stride_blocks(n * w), kThreads, 0, s>>>(rows, upd, out, n,
                                                                            w);
  }
  return static_cast<int>(cudaGetLastError());
}
