// L2-then-Adam update with low-precision moment storage (K8).
//
// Replaces: emernerf_tpu/train/optim.py:make_adam (optax
// add_decayed_weights, then _scale_by_adam_lp) with apply_update, which XLA
// fuses into one elementwise pass per parameter.
//
// What bounds it on the H100: bytes.  Per element it reads the fp32 param
// and grad and both moments and writes param and moments back, a few
// FLOPs each; the flagship's 316 M elements move ~6 GB per update, so the
// kernel runs at memory bandwidth.  The plain PyTorch version takes ~15
// full passes for the same update.
//
// Design: one grid-stride elementwise kernel per parameter tensor, in place,
// moments fp32 or bf16 (the four big tables, >= 2^20 elements, store bf16
// moments).  The math follows the reference op for op, each rounded once
// (__fmul_rn etc., no FMA contraction), so kernel and plain version agree
// bit for bit:
//   g' = g + wd * p
//   m  = b1 * m + (1 - b1) * g'        (fp32, then rounded to storage)
//   v  = b2 * v + ((1 - b2) * g') * g' (fp32, then rounded to storage)
//   p  = p + (-lr) * ((m / c1) / (sqrt(v / c2) + eps))
// where m and v are the STORED (rounded) moments, as the reference's
// direction() reads them.  A null grad is a zero grad (the parameter was
// not used by the branch; Adam still decays its moments).
//
// K11, the explicit-collective data-parallel step's Adam.  Replaces:
// emernerf_tpu/parallel/spmd.py:_adam_direction (:96) and spmd_apply_update
// (:107-153), which XLA fuses per leaf inside the shard_map step.  Unlike
// K8 the direction reads the UNROUNDED fp32 moments; the stored moments are
// rounded once, after.  Three entry points:
//   emt_spmd_adam_multi  every replicated leaf of a parameter group
//                        (:141-143) in one launch: g' = g + wd * p, the
//                        moments, p + (-lr) * dir;
//   emt_zero_slab        this rank's slab of a ZeRO-routed leaf (:127-136):
//                        g = float(slab in the wire dtype) / n_ranks,
//                        g' = g + wd * p_local, the moment shard, and the
//                        direction rounded to the all-gather's dtype;
//   emt_apply_direction  the gathered direction (:137-140): p + (-lr) * dir.
// What bounds them: bytes.  Each stream is read once and written once with
// a few flops per element, so a pass can go no faster than its bytes over
// the HBM rate; what keeps it from that rate is too few bytes in flight per
// thread and, for the replicated leaves, one launch (and one ragged tail
// wave) per small leaf.  Design: each thread moves 8 consecutive elements
// per access (fp32 streams as two float4, bf16 streams as one 16-byte load
// of eight bf16), every stream's loads issued before any arithmetic; the
// grid is the SM count times the blocks resident per SM (occupancy API),
// grid-striding over the groups.  An operand that is not 16-byte aligned
// (the wrapper checks every pointer) runs the same kernel at a width of 1;
// a scalar tail covers any length.  The replicated leaves of a group go in
// one launch: a table of up to kMaxLeaves leaf descriptors passed by value
// (__grid_constant__, indexed in place), blocks striding over (leaf,
// chunk) through the table's prefix of chunk counts.  Every element goes through
// the same operations in the same order, each rounded once
// (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn, no FMA contraction), so the
// kernels stay bit for bit with their plain versions in train/optim.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct AdamHyper {
  float weight_decay, b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, neg_lr;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename M>
__global__ void adam_kernel(float* __restrict__ param, const float* __restrict__ grad,
                            M* __restrict__ mu, M* __restrict__ nu, long long n,
                            const AdamHyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const float p = param[i];
    const float g0 = grad != nullptr ? grad[i] : 0.f;
    const float g = __fadd_rn(g0, __fmul_rn(h.weight_decay, p));
    const float m = __fadd_rn(__fmul_rn(h.b1, to_f(mu[i])), __fmul_rn(h.one_minus_b1, g));
    const float v = __fadd_rn(__fmul_rn(h.b2, to_f(nu[i])),
                              __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
    from_f(mu + i, m);
    from_f(nu + i, v);
    const float ms = to_f(mu[i]), vs = to_f(nu[i]);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vs, h.c2)), h.eps);
    const float dir = __fdiv_rn(__fdiv_rn(ms, h.c1), den);
    param[i] = __fadd_rn(p, __fmul_rn(h.neg_lr, dir));
  }
}

unsigned grid_blocks(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
}


// ------------------------------------------------------------------ K11

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per vector access: 16 bytes of bf16, 2 x 16 of fp32
constexpr int kMaxLeaves = 64;  // leaf descriptors per multi-leaf launch (train/optim.py)
constexpr long long kChunk = 16384;  // elements of a leaf per block step of a multi-leaf launch

// W consecutive elements from / to registers: W = kVec as 16-byte vectors
// (the pointer 16-byte aligned), W = 1 as one scalar.
template <int W>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (W == kVec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (W == kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (W == kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (W == kVec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The moments of g' (= g + wd * p) from the stored ones, in place, and the
// direction from them (unrounded).
__device__ __forceinline__ float adam_direction(const AdamHyper& h, float g, float& m,
                                                float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
  return __fdiv_rn(__fdiv_rn(m, h.c1), den);
}

// One pass's operands and arithmetic: load<W>(i, r) reads elements
// [i, i + W) into registers, finish<W>(i, r) computes and writes them;
// kUnroll groups of every stream in flight per thread.  The Adam steps
// read four streams: one group of each is 64-128 bytes in flight, and a
// second doubles their registers and halves the threads resident per SM
// (slower on the card); the direction's update reads two and takes four.
template <typename M>
struct SpmdAdamOp {  // a replicated leaf
  static constexpr int kUnroll = 1;
  float* param;
  const float* grad;  // null: a zero gradient
  M* mu;
  M* nu;
  AdamHyper h;
  template <int W>
  struct Regs {
    float p[W], g[W], m[W], v[W];
  };
  template <int W>
  __device__ __forceinline__ void load(long long i, Regs<W>& r) const {
    ::load<W>(param + i, r.p);
    if (grad != nullptr) {
      ::load<W>(grad + i, r.g);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) r.g[k] = 0.f;
    }
    ::load<W>(mu + i, r.m);
    ::load<W>(nu + i, r.v);
  }
  template <int W>
  __device__ __forceinline__ void finish(long long i, Regs<W>& r) const {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float g = __fadd_rn(r.g[k], __fmul_rn(h.weight_decay, r.p[k]));
      const float dir = adam_direction(h, g, r.m[k], r.v[k]);
      r.p[k] = __fadd_rn(r.p[k], __fmul_rn(h.neg_lr, dir));
    }
    store<W>(mu + i, r.m);
    store<W>(nu + i, r.v);
    store<W>(param + i, r.p);
  }
};

template <typename G, typename M, typename D>
struct ZeroSlabOp {  // this rank's slab of a ZeRO-routed leaf
  static constexpr int kUnroll = 1;
  const G* slab;  // the reduce-scattered gradient sum, the wire's dtype
  const float* p_local;
  M* mu;
  M* nu;
  D* dir;
  float n_ranks;
  AdamHyper h;
  template <int W>
  struct Regs {
    float s[W], p[W], m[W], v[W];
  };
  template <int W>
  __device__ __forceinline__ void load(long long i, Regs<W>& r) const {
    ::load<W>(slab + i, r.s);
    ::load<W>(p_local + i, r.p);
    ::load<W>(mu + i, r.m);
    ::load<W>(nu + i, r.v);
  }
  template <int W>
  __device__ __forceinline__ void finish(long long i, Regs<W>& r) const {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float g = __fadd_rn(__fdiv_rn(r.s[k], n_ranks), __fmul_rn(h.weight_decay, r.p[k]));
      r.s[k] = adam_direction(h, g, r.m[k], r.v[k]);
    }
    store<W>(mu + i, r.m);
    store<W>(nu + i, r.v);
    store<W>(dir + i, r.s);
  }
};

template <typename D>
struct ApplyDirectionOp {  // the gathered direction
  static constexpr int kUnroll = 4;
  float* param;
  const D* dir;
  float neg_lr;
  template <int W>
  struct Regs {
    float p[W], d[W];
  };
  template <int W>
  __device__ __forceinline__ void load(long long i, Regs<W>& r) const {
    ::load<W>(param + i, r.p);
    ::load<W>(dir + i, r.d);
  }
  template <int W>
  __device__ __forceinline__ void finish(long long i, Regs<W>& r) const {
#pragma unroll
    for (int k = 0; k < W; ++k) r.p[k] = __fadd_rn(r.p[k], __fmul_rn(neg_lr, r.d[k]));
    store<W>(param + i, r.p);
  }
};

// Groups g, g + step, ... below `end` (group j = elements [j W, j W + W)),
// U at a time: all U loaded before any is computed.
template <int W, int U, class Op>
__device__ __forceinline__ void sweep(const Op& op, long long g, long long end, long long step) {
  for (; g < end; g += U * step) {
    typename Op::template Regs<W> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g + u * step < end) op.template load<W>((g + u * step) * W, r[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g + u * step < end) op.template finish<W>((g + u * step) * W, r[u]);
  }
}

// Elements [begin, end) (begin a multiple of kVec) by thread t of nt: at
// width kVec the whole groups, then the tail one element per thread.
template <class Op>
__device__ __forceinline__ void sweep_range(const Op& op, int vec, long long begin,
                                            long long end, long long t, long long nt) {
  if (vec == kVec) {
    const long long groups = end / kVec;
    sweep<kVec, Op::kUnroll>(op, begin / kVec + t, groups, nt);
    sweep<1, 1>(op, groups * kVec + t, end, nt);
  } else {
    sweep<1, Op::kUnroll>(op, begin + t, end, nt);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads) stream_kernel(const Op op, int vec, long long n) {
  sweep_range(op, vec, 0, n, blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x,
              static_cast<long long>(gridDim.x) * blockDim.x);
}

// One replicated leaf of a multi-leaf launch; the same layout as
// train/optim.py:SpmdLeaf.  first_chunk: the leaf's first chunk of kChunk
// elements in the launch's numbering (the prefix of the chunk counts).
struct LeafDesc {
  float* param;
  const float* grad;
  void* mu;
  void* nu;
  long long n;
  long long first_chunk;
  int moments_bf16;
  int vec;
};

struct LeafTable {
  LeafDesc leaf[kMaxLeaves];
  long long n_chunks;
  int n_leaves;
};

// One chunk [begin, end) of a leaf, for one moment dtype.
template <typename M>
__device__ __noinline__ void spmd_adam_chunk(const LeafDesc& d, const AdamHyper& h,
                                             long long begin, long long end) {
  const SpmdAdamOp<M> op{d.param, d.grad, static_cast<M*>(d.mu), static_cast<M*>(d.nu), h};
  sweep_range(op, d.vec, begin, end, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kThreads)
spmd_adam_multi_kernel(const __grid_constant__ LeafTable tab, const AdamHyper h) {
  for (long long c = blockIdx.x; c < tab.n_chunks; c += gridDim.x) {
    int lo = 0, hi = tab.n_leaves - 1;  // the last leaf whose first chunk is <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.leaf[mid].first_chunk <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    const LeafDesc& d = tab.leaf[lo];
    const long long begin = (c - d.first_chunk) * kChunk;
    const long long end = begin + kChunk < d.n ? begin + kChunk : d.n;
    if (d.moments_bf16)
      spmd_adam_chunk<__nv_bfloat16>(d, h, begin, end);
    else
      spmd_adam_chunk<float>(d, h, begin, end);
  }
}

// The SM count times the blocks of kThreads that stay resident on one SM.
template <auto Kernel>
long long resident_blocks() {
  static long long blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <class Op>
int launch_stream(const Op& op, int vec, long long n, void* stream) {
  if (n == 0) return cudaSuccess;
  if (vec != 1 && vec != kVec) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(kThreads) * Op::kUnroll * vec;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = resident_blocks<stream_kernel<Op>>();
  stream_kernel<Op><<<static_cast<unsigned>(want < cap ? want : cap), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(op, vec, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename G, typename M>
int launch_zero_slab(const void* slab, const float* p, void* mu, void* nu, void* dir,
                     int dir_bf16, long long n, float n_ranks, const AdamHyper& h, int vec,
                     void* stream) {
  const G* w = static_cast<const G*>(slab);
  M* m = static_cast<M*>(mu);
  M* v = static_cast<M*>(nu);
  if (dir_bf16)
    return launch_stream(ZeroSlabOp<G, M, __nv_bfloat16>{
        w, p, m, v, static_cast<__nv_bfloat16*>(dir), n_ranks, h}, vec, n, stream);
  return launch_stream(ZeroSlabOp<G, M, float>{w, p, m, v, static_cast<float*>(dir), n_ranks, h},
                       vec, n, stream);
}

}  // namespace

extern "C" int emt_adam(void* param, const void* grad, void* mu, void* nu,
                        int moments_bf16, long long n, const void* hyper,
                        void* stream) {
  if (n == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  const int threads = 256;
  const unsigned blocks = grid_blocks(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(param);
  const float* g = static_cast<const float*>(grad);
  if (moments_bf16)
    adam_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, g, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), n, h);
  else
    adam_kernel<float><<<blocks, threads, 0, s>>>(
        p, g, static_cast<float*>(mu), static_cast<float*>(nu), n, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_spmd_adam_multi(const void* leaves, int n_leaves, const void* hyper,
                                   void* stream) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  LeafTable tab;
  const LeafDesc* in = static_cast<const LeafDesc*>(leaves);
  tab.n_leaves = 0;
  tab.n_chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (in[i].n == 0) continue;
    if (in[i].vec != 1 && in[i].vec != kVec) return cudaErrorInvalidValue;
    LeafDesc& d = tab.leaf[tab.n_leaves++];
    d = in[i];
    d.first_chunk = tab.n_chunks;
    tab.n_chunks += (d.n + kChunk - 1) / kChunk;
  }
  if (tab.n_chunks == 0) return cudaSuccess;
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  const long long cap = resident_blocks<spmd_adam_multi_kernel>();
  spmd_adam_multi_kernel<<<static_cast<unsigned>(tab.n_chunks < cap ? tab.n_chunks : cap),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tab, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emt_zero_slab(const void* slab, int wire_bf16, const void* p_local, void* mu,
                             void* nu, int moments_bf16, void* dir_out, int dir_bf16,
                             long long n, float n_ranks, const void* hyper, int vec,
                             void* stream) {
  const AdamHyper h = *static_cast<const AdamHyper*>(hyper);
  const float* p = static_cast<const float*>(p_local);
  using bf16 = __nv_bfloat16;
  if (wire_bf16 && moments_bf16)
    return launch_zero_slab<bf16, bf16>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, vec,
                                        stream);
  if (wire_bf16)
    return launch_zero_slab<bf16, float>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, vec,
                                         stream);
  if (moments_bf16)
    return launch_zero_slab<float, bf16>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, vec,
                                         stream);
  return launch_zero_slab<float, float>(slab, p, mu, nu, dir_out, dir_bf16, n, n_ranks, h, vec,
                                        stream);
}

extern "C" int emt_apply_direction(void* param, const void* dir, int dir_bf16, long long n,
                                   float neg_lr, int vec, void* stream) {
  float* p = static_cast<float*>(param);
  if (dir_bf16)
    return launch_stream(ApplyDirectionOp<__nv_bfloat16>{
        p, static_cast<const __nv_bfloat16*>(dir), neg_lr}, vec, n, stream);
  return launch_stream(ApplyDirectionOp<float>{p, static_cast<const float*>(dir), neg_lr}, vec, n,
                       stream);
}
