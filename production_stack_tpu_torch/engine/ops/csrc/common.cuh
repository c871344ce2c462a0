// Shared helpers for the kernels: element storage types, vector loads,
// asynchronous copies, and the split and merge of the split-KV decode
// kernels.
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
// u = b + 128 in [0, 255]; one byte permute builds the float 2^23 + u
// (bytes u, 0, 0, 0x4B); less 2^23 + 128 that is b.  Two instructions a
// value, on the integer and the fp32 pipes.
__device__ __forceinline__ void unpack_word_s8(unsigned w, float* f) {
  w ^= 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - 8388736.f;
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

// N consecutive fp32 or bf16 elements (N * sizeof(T) in {4, 8, 16, 32}
// bytes, aligned to that size) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* p, float* f) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  unsigned w[W];
  if constexpr (W >= 4) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// N consecutive int8 values (N in {2, 4, 8}, aligned to N bytes) as floats.
template <int N>
__device__ __forceinline__ void load_s8(const int8_t* p, float* f) {
  if constexpr (N == 2) {
    float t[4];
    unpack_word_s8(*reinterpret_cast<const unsigned short*>(p), t);
    f[0] = t[0];
    f[1] = t[1];
  } else if constexpr (N == 4) {
    unpack_word_s8(*reinterpret_cast<const unsigned*>(p), f);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack_word_s8(u.x, f);
    unpack_word_s8(u.y, f + 4);
  }
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

// The same for 4 bytes (cp.async.cg takes only 16).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
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

// -- Tensor-core fragments (mma.sync, sm_80+): flash_prefill.cu and
// w8a16_gemm.cu -------------------------------------------------------

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16_raw* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16_raw* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b on one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, the first in the low half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// -- Split-KV decode: the split and the merge of both decode kernels -------
//
// paged_decode.cu (dense caches) and paged_decode_int8.cu (int8 caches)
// run a grid (row, KV head, split) of kDecodeWarps warps a block.  Each
// warp keeps its own online-softmax state per query head g of the block's
// KV head: the running max m and sum l (log2 units; every lane holds the
// same) and the accumulator's columns lane * D/32 .. + D/32 - 1.  The
// Python side of the same arithmetic is kernels/paged_attention.py
// (split_count, split_bounds, paged_decode_partials_plain,
// _merge_partials).

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeMaxG = 8;  // query heads per KV head
constexpr int kMaxSplit = 64;   // splits per (row, KV head); MAX_SPLIT in the wrapper

struct DecodeSplit {
  int n_row;     // splits this row takes
  int beg, end;  // this split's tokens [beg, end)
};

// A row takes n_row = ceil((ctx - lo) / split_tokens) of the grid's
// n_split splits (at least 1) and cuts its live range [lo, ctx) into
// chunks of ceil((ctx - lo) / n_row) tokens rounded up to whole tiles of
// `tile` tokens; lo = ctx - window with a sliding window, else 0.  Splits
// at or past n_row have nothing to do (the caller returns).
__device__ __forceinline__ DecodeSplit decode_split(int ctx, int window, int n_split,
                                                    int split_tokens, int split,
                                                    int tile) {
  const int lo = window >= 0 ? max(0, ctx - window) : 0;
  DecodeSplit r;
  r.n_row = min(n_split, max(1, (ctx - lo + split_tokens - 1) / split_tokens));
  int chunk = (ctx - lo + r.n_row - 1) / r.n_row;
  chunk = (chunk + tile - 1) / tile * tile;
  r.beg = min(ctx, lo + split * chunk);
  r.end = min(ctx, r.beg + chunk);
  return r;
}

// Bytes of shared memory decode_merge uses: the warps' states, then the
// last split's ([kMaxSplit][kDecodeMaxG] weights and sums, kDecodeMaxG
// inverses).
template <int D>
struct DecodeMergeSmem {
  static constexpr size_t WARPS = sizeof(float) * kDecodeWarps * kDecodeMaxG * (D + 2);
  static constexpr size_t SPLITS = sizeof(float) * (2 * kMaxSplit + 1) * kDecodeMaxG;
  static constexpr size_t BYTES = WARPS > SPLITS ? WARPS : SPLITS;
};

// The end of a split, called by every thread of the block once its warps'
// copies have landed: merge the warps' states; a row with one split writes
// its output [S, H, D], any other split its fp32 partial (m, l) to part_ml
// [S, K, n_split, G, 2] and its accumulator to part_acc [S, K, n_split, G,
// D], then bumps the (row, KV head) counter; the split that takes it to
// n_row merges all partials by log-sum-exp, in split order (the same bits
// every call), and sets the counter back to 0 for the next call.  A part
// that saw no token carries m = -inf and l = 0 and weighs 0; a row with no
// token gives zeros.  `smem` is the block's shared memory, at least
// DecodeMergeSmem<D>::BYTES, free to reuse from here on.  NG (<=
// kDecodeMaxG) is the number of head slots the caller's state arrays hold;
// heads g >= G are ignored.  This rather than a second kernel: a decode
// step launches the kernel once per layer, and a reduce kernel would add
// as many launches again on a host-bound step.
template <typename T, int D, int NG>
__device__ __forceinline__ void decode_merge(
    const float (&m)[NG], const float (&l)[NG],
    const float (&acc)[NG][D / 32], float* smem, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counters, int s, int kh, int split, int n_row, int n_split,
    int H, int K, int G) {
  constexpr int VC = D / 32;
  __shared__ int sLast;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Merge the warps: the shared memory now holds each warp's (m, l) per
  // head and its accumulator.
  __syncthreads();
  float* sM = smem;                      // [kDecodeWarps][kDecodeMaxG]
  float* sL = sM + kDecodeWarps * kDecodeMaxG;  // [kDecodeWarps][kDecodeMaxG]
  float* sAcc = sL + kDecodeWarps * kDecodeMaxG;  // [kDecodeWarps][kDecodeMaxG][D]
  static_assert(NG <= kDecodeMaxG, "at most kDecodeMaxG heads per KV head");
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sM[warp * kDecodeMaxG + g] = m[g];
      sL[warp * kDecodeMaxG + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VC; ++e)
      sAcc[(warp * kDecodeMaxG + g) * D + lane * VC + e] = acc[g][e];
  }
  __syncthreads();

  const size_t pair = static_cast<size_t>(s) * K + kh;
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sM[w * kDecodeMaxG + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float mw = sM[w * kDecodeMaxG + g];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      lsum += sL[w * kDecodeMaxG + g] * wt;
      a += sAcc[(w * kDecodeMaxG + g) * D + d] * wt;
    }
    if (n_row == 1) {
      out[(static_cast<size_t>(s) * H + kh * G + g) * D + d] =
          from_float<T>(lsum > 0.f ? a / lsum : 0.f);
    } else {
      const size_t pi = pair * n_split + split;  // n_split: the scratch's stride
      part_acc[(pi * G + g) * D + d] = a;
      if (d == 0) {
        part_ml[(pi * G + g) * 2] = mx;
        part_ml[(pi * G + g) * 2 + 1] = lsum;
      }
    }
  }
  if (n_row == 1) return;

  // The last of the row's n_row splits to arrive merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sLast = atomicAdd(counters + pair, 1) == n_row - 1;
    if (sLast) counters[pair] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  // Each split's weight 2^(m_j - M) per head, then sum_j w_j l_j, in
  // shared memory (free again: every thread is past the barrier above);
  // the accumulators' loads are then independent across splits.
  const size_t p0 = pair * n_split;
  float* sW = smem;                         // [n_row][G]: m, then w
  float* sLj = sW + n_split * kDecodeMaxG;  // [n_row][G]: l
  float* sInv = sLj + n_split * kDecodeMaxG;  // [G]: 1 / sum_j w_j l_j
  for (int i = tid; i < n_row * G; i += kDecodeThreads) {
    sW[i] = __ldcg(part_ml + (p0 * G + i) * 2);
    sLj[i] = __ldcg(part_ml + (p0 * G + i) * 2 + 1);
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int j = 0; j < n_row; ++j) mx = fmaxf(mx, sW[j * G + tid]);
    float lsum = 0.f;
    for (int j = 0; j < n_row; ++j) {
      const float mj = sW[j * G + tid];
      const float wt = mj == -INFINITY ? 0.f : exp2f(mj - mx);  // no token: 0
      sW[j * G + tid] = wt;
      lsum += sLj[j * G + tid] * wt;
    }
    sInv[tid] = lsum > 0.f ? 1.f / lsum : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_row; ++j)
      a += __ldcg(part_acc + (p0 + j) * G * D + i) * sW[j * G + g];
    out[(static_cast<size_t>(s) * H + kh * G) * D + i] = from_float<T>(a * sInv[g]);
  }
}
