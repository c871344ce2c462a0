// Shared helpers for the attention kernels: element storage types and
// 16-byte vector loads.
//
// Tensors arrive as raw pointers from the ctypes wrappers.  An element is
// stored as fp32 (`float`), as bf16 (`unsigned short`, the raw bits) or,
// in an int8 KV cache, as `int8_t`; every product and sum is taken in
// fp32.  Loads move 16 bytes per thread (4 fp32, 8 bf16 or 16 int8
// values), neighbouring threads on neighbouring addresses.
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

// Signed bytes to fp32, exactly, without the slow integer-to-float
// conversion instruction: flipping the sign bit of each byte gives
// u = b + 128 in [0, 255]; 0x4B000000 | u is the float 2^23 + u; less
// 2^23 + 128 that is b.
__device__ __forceinline__ void unpack_word_s8(unsigned w, float* f) {
  w ^= 0x80808080u;
  f[0] = __uint_as_float(0x4B000000u | (w & 0xffu)) - 8388736.f;
  f[1] = __uint_as_float(0x4B000000u | ((w >> 8) & 0xffu)) - 8388736.f;
  f[2] = __uint_as_float(0x4B000000u | ((w >> 16) & 0xffu)) - 8388736.f;
  f[3] = __uint_as_float(0x4B000000u | (w >> 24)) - 8388736.f;
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, int8_t) {
  unpack_word_s8(u.x, f);
  unpack_word_s8(u.y, f + 4);
  unpack_word_s8(u.z, f + 8);
  unpack_word_s8(u.w, f + 12);
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

// log2(e): scores are kept in the log2 domain so the softmax uses exp2f.
constexpr float kLog2e = 1.4426950408889634f;

// -- Asynchronous copies (cp.async, sm_80+) ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; with !valid nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
