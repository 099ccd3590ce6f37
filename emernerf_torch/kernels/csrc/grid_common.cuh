// Device helpers shared by the grid encoders' kernels (brickgrid.cu, K1, and
// hashgrid.cu, K4): scalar and vector loads of a row's features, the warp
// merge of equal destinations, and vector atomics of a span of floats.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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

// The N consecutive values at p, read-only, in one load where N values of T
// fill 4, 8 or 16 bytes (two 16-byte loads for 8 fp32), else one by one.  p
// must be aligned to N * sizeof(T) bytes for N in {2, 4, 8}.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  if constexpr (sizeof(T) == 4 && N == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  } else if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x, out[1] = v.y;
  } else if constexpr (sizeof(T) == 2 && N == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    unpack(v.x, out), unpack(v.y, out + 2), unpack(v.z, out + 4), unpack(v.w, out + 6);
  } else if constexpr (sizeof(T) == 2 && N == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    unpack(v.x, out), unpack(v.y, out + 2);
  } else if constexpr (sizeof(T) == 2 && N == 2) {
    unpack(__ldg(reinterpret_cast<const unsigned*>(p)), out);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = load_f(p + k);
  }
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
