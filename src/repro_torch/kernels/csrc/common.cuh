// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace repro {

// finite "minus infinity" of the online softmax, as in the reference
// kernels: exp(NEG_INF - m) underflows to +0.0 and NEG_INF - NEG_INF is 0
constexpr float NEG_INF = -1e30f;

// element strides of a (B, S, heads, head_dim) tensor; head_dim's is 1
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// four consecutive elements as f32 (16-byte load for f32, 8-byte for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// sum / max over the 2^log_width lanes of an aligned lane group, in a
// fixed butterfly order (the same on every run)
template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// raise the dynamic shared memory a kernel may use above the 48 KB
// default.  `allowed` is the caller's record (a static of the kernel's
// launch function) of the size already set, so the attribute is set once
// per kernel instantiation, not on every launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// f(std::integral_constant<int, DH>{}) at the head dims the kernels are
// built for, 16 to 128; any other is refused
template <class F>
inline cudaError_t with_head_dim(int dh, F&& f) {
  switch (dh) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
