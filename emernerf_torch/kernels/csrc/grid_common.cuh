// Device helpers shared by the grid encoders' kernels (brickgrid.cu, K1, and
// hashgrid.cu, K4): scalar and vector loads of a row's features (with the
// load policy of a table stored in one type and computed on in another),
// the warp merge of equal destinations, and vector atomics of a span of
// floats.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace emt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void unpack(unsigned w, float* out) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  out[0] = __low2float(h), out[1] = __high2float(h);
}

// The value v as the compute type C holds it: a bf16 computation rounds to
// nearest even (as .to(torch.bfloat16) does), an fp32 one keeps v.
template <typename C>
__device__ __forceinline__ float to_compute(float v) {
  if constexpr (std::is_same_v<C, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The load policy of a table stored as T and computed on as C: values read
// from an fp32 table for a bf16 computation are rounded in registers, so
// the kernel sees what it would read from table.to(torch.bfloat16), bit for
// bit, without that copy.  Every other pair reads the values as they are.
template <typename T, typename C, int N>
__device__ __forceinline__ void round_loaded(float (&v)[N]) {
  if constexpr (sizeof(T) == 4 && std::is_same_v<C, __nv_bfloat16>) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_compute<C>(v[k]);
  }
}

// W consecutive values of T at p in one read-only load: W * sizeof(T) is 4,
// 8 or 16 bytes and p is aligned to it, or W = 1 (a scalar).
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* p, float* out) {
  if constexpr (W == 1) {
    out[0] = load_f(p);
  } else if constexpr (sizeof(T) == 4 && W == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (sizeof(T) == 4 && W == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x, out[1] = v.y;
  } else if constexpr (sizeof(T) == 2 && W == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    unpack(v.x, out), unpack(v.y, out + 2), unpack(v.z, out + 4), unpack(v.w, out + 6);
  } else if constexpr (sizeof(T) == 2 && W == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    unpack(v.x, out), unpack(v.y, out + 2);
  } else {
    static_assert(sizeof(T) == 2 && W == 2, "a load of 4, 8 or 16 bytes, or a scalar");
    unpack(__ldg(reinterpret_cast<const unsigned*>(p)), out);
  }
}

// The N consecutive values at p, read-only: 16-byte loads where N values of
// T fill a multiple of 16 bytes, one load where they fill 4 or 8, else one
// by one; p must be aligned to the load's width.  C is the load policy.
template <typename T, int N, typename C = T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int kV = 16 / sizeof(T);  // values per 16 bytes
  if constexpr (N % kV == 0) {
#pragma unroll
    for (int k = 0; k < N; k += kV) load_chunk<T, kV>(p + k, out + k);
  } else if constexpr (N == kV / 2 || N == kV / 4) {
    load_chunk<T, N>(p, out);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = load_f(p + k);
  }
  round_loaded<T, C, N>(out);
}

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// v[K..N) from p[K..N), where p's element offset modulo G is M: at each
// step the widest load that is aligned there and fits (all resolved at
// compile time).  G is a power of two no wider than the widest load.
template <typename T, int N, int G, int M, int K = 0>
__device__ __forceinline__ void load_span_at(const T* p, float (&v)[N]) {
  if constexpr (K < N) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int m = (M + K) % G;
    constexpr int w = (m % kV == 0 && K + kV <= N)             ? kV
                      : (m % (kV / 2) == 0 && K + kV / 2 <= N) ? kV / 2
                      : (kV / 4 > 1 && m % (kV / 4) == 0 && K + kV / 4 <= N) ? kV / 4
                                                                             : 1;
    load_chunk<T, w>(p + K, v + K);
    load_span_at<T, N, G, M, K + w>(p, v);
  }
}

template <typename T, int N, int G, int S, int M = 0>
__device__ __forceinline__ void load_span_from(const T* p, int m, float (&v)[N]) {
  if constexpr (M + S < G) {
    if (m == M) {
      load_span_at<T, N, G, M>(p, v);
    } else {
      load_span_from<T, N, G, S, M + S>(p, m, v);
    }
  } else {
    load_span_at<T, N, G, M>(p, v);
  }
}

// The N consecutive values at p, read-only, in the widest loads p's
// alignment allows: p's element offset from a 16-byte aligned base is a
// multiple of A, so only the alignments that leaves are told apart at run
// time (one when A * sizeof(T) covers the widest load N values can use,
// e.g. none for an 8-aligned span of 16 fp32; two for a span of 2 values at
// any element).  C is the load policy.
template <typename T, int N, int A, typename C = T>
__device__ __forceinline__ void load_span(const T* p, float (&v)[N]) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int G = N >= kV ? kV : N >= kV / 2 ? kV / 2 : N >= kV / 4 ? kV / 4 : 1;
  const int m = static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % G);
  load_span_from<T, N, G, gcd(A, G)>(p, m, v);
  round_loaded<T, C, N>(v);
}

// Sums the N values v of runs of neighbouring lanes with equal keys into
// the run's first lane (a segmented suffix sum by shuffles, as many steps as
// the longest run needs).  Returns whether this lane must add its v at `key`
// (the first lane of its run, and a key other than `none`).  The whole warp
// must call it.  A warp whose 32 keys all differ leaves after one ballot.
// Equal keys that are not neighbours stay separate.
template <int N, typename Key>
__device__ __forceinline__ bool merge_runs(Key key, Key none, float (&v)[N], int lane) {
  const Key left = __shfl_up_sync(kFullMask, key, 1);
  const bool head = lane == 0 || left != key;
  const unsigned heads = __ballot_sync(kFullMask, head);
  if (heads != kFullMask) {
    const unsigned later = heads & (0xfffffffeu << lane);  // heads after this lane
    const int last = later ? __ffs(later) - 2 : 31;        // the run's last lane
    const int span = __reduce_max_sync(kFullMask, static_cast<unsigned>(last - lane));
    for (int off = 1; off <= span; off <<= 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float o = __shfl_down_sync(kFullMask, v[k], off);
        if (lane + off <= last) v[k] += o;
      }
    }
  }
  return head && key != none;
}

// atomicAdd of v[K..N) at p[K..N), where p's float offset modulo 4 is M:
// float4 atomics where 16 bytes are aligned, float2 where 8 are, else
// scalars (all resolved at compile time).
template <int N, int M, int K = 0>
__device__ __forceinline__ void add_span_at(float* p, const float (&v)[N]) {
  if constexpr (K < N) {
    constexpr int m = (M + K) & 3;
    if constexpr (m == 0 && K + 4 <= N) {
      atomicAdd(reinterpret_cast<float4*>(p + K), make_float4(v[K], v[K + 1], v[K + 2], v[K + 3]));
      add_span_at<N, M, K + 4>(p, v);
    } else if constexpr ((m & 1) == 0 && K + 2 <= N) {
      atomicAdd(reinterpret_cast<float2*>(p + K), make_float2(v[K], v[K + 1]));
      add_span_at<N, M, K + 2>(p, v);
    } else {
      atomicAdd(p + K, v[K]);
      add_span_at<N, M, K + 1>(p, v);
    }
  }
}

// atomicAdd of the N consecutive floats v at p (4-byte aligned), in the
// widest vector atomics p's alignment allows.
template <int N>
__device__ __forceinline__ void add_span(float* p, const float (&v)[N]) {
  switch ((reinterpret_cast<uintptr_t>(p) >> 2) & 3) {
    case 0: add_span_at<N, 0>(p, v); break;
    case 1: add_span_at<N, 1>(p, v); break;
    case 2: add_span_at<N, 2>(p, v); break;
    default: add_span_at<N, 3>(p, v); break;
  }
}

}  // namespace emt
