// Shared helpers for the attention kernels: element storage types and
// 16-byte vector loads.
//
// Tensors arrive as raw pointers from the ctypes wrappers.  An element is
// stored either as fp32 (`float`) or as bf16 (`unsigned short`, the raw
// bits); every product and sum is taken in fp32.  Loads move 16 bytes per
// thread (8 bf16 or 4 fp32 values), neighbouring threads on neighbouring
// addresses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16_raw = unsigned short;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16_raw x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_raw from_float<bf16_raw>(float x) {
  // Round to nearest even, as torch's fp32 -> bf16 cast does.
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Number of elements in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// Unpack one 16-byte vector into N floats.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, bf16_raw) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16);
  f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16);
  f[7] = __uint_as_float(u.w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack(u, f, T());
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element type codes shared with the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
