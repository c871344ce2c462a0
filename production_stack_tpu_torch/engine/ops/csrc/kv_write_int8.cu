// Quantize-on-write into the int8 paged KV cache, for Hopper (sm_90a).
//
// Replaces the int8 branches of the JAX package's cache writers,
// production_stack_tpu/engine/ops/attention.py: `write_prefill_kv`
// (:261-271) and `append_decode_kv` (:289-299), which XLA fuses into the
// step's program.  One launch quantizes both K and V rows [R, K, D] (bf16
// or fp32) per (token, KV head) vector and scatters them in place into the
// int8 data [N, bs, K, D] and the fp32 scale [N, bs, K] of each side.
// Row r goes to (block_ids[r], offsets[r]) (decode: one token per
// sequence) or, without offsets, to (block_ids[r / bs], r % bs) (prefill:
// whole blocks).  Padding rows name block 0, the null block, which is never
// read; which of their duplicate writes lands does not matter.
//
// It gives the bits of the port's plain `quantize_vectors` on the CPU (and
// so the JAX package's): scale = amax|x| / 127 and x / safe as IEEE
// divisions (safe = 1 where scale == 0, so a zero vector stores zeros and
// scale 0), rounded half to even, clamped to +-127.  The build has no fast
// math, and the divisions are written as __fdiv_rn all the same.
//
// What bounds it on an H100: bytes, and at a decode step's size the
// launch.  It reads each row once (2 * R * K * D elements) and writes
// 2 * R * K * (D + 4) bytes; a few operations an element.  What the design
// does about it: one warp per (side, row, KV head) vector, D / 32 values a
// lane loaded in one 8- or 16-byte access, the max by shuffles, one store
// of D / 32 int8 values a lane and one of the scale; both sides and every
// row in one launch, where eager PyTorch launched ~24 ops a layer for the
// same write.  The block ids and offsets are read as the engine makes them
// (int32), so no cast launches either.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // vectors per block

template <int N>
__device__ __forceinline__ void store_s8(int8_t* p, const int* b) {
  unsigned w[(N + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < N; ++e) w[e / 4] |= (static_cast<unsigned>(b[e]) & 0xffu) << (8 * (e % 4));
  if constexpr (N == 2) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<unsigned*>(p) = w[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

template <typename T, int VC>
__global__ void __launch_bounds__(kWarps * 32)
kv_write_int8_kernel(const T* __restrict__ k_new,       // [R, K, D]
                     const T* __restrict__ v_new,
                     int8_t* __restrict__ k_data,       // [N, bs, K, D]
                     int8_t* __restrict__ v_data,
                     float* __restrict__ k_scale,       // [N, bs, K]
                     float* __restrict__ v_scale,
                     const int* __restrict__ block_ids,  // [R] or [R / bs]
                     const int* __restrict__ offsets,    // [R] or null
                     int R, int K, int bs) {
  constexpr int D = VC * 32;
  const int lane = threadIdx.x % 32;
  const long long vec = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long per_side = static_cast<long long>(R) * K;
  if (vec >= 2 * per_side) return;
  const bool is_v = vec >= per_side;
  const long long rk = is_v ? vec - per_side : vec;  // row * K + KV head
  const int r = static_cast<int>(rk / K), kh = static_cast<int>(rk % K);
  const int blk = offsets ? block_ids[r] : block_ids[r / bs];
  const int off = offsets ? offsets[r] : r % bs;

  float x[VC];
  load_cols<T, VC>((is_v ? v_new : k_new) + rk * D + lane * VC, x);
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < VC; ++e) amax = fmaxf(amax, fabsf(x[e]));
  amax = warp_max(amax);
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = scale > 0.f ? scale : 1.f;
  int b[VC];
#pragma unroll
  for (int e = 0; e < VC; ++e)
    b[e] = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x[e], safe)), -127.f), 127.f));

  const long long dst = (static_cast<long long>(blk) * bs + off) * K + kh;
  store_s8<VC>((is_v ? v_data : k_data) + dst * D + lane * VC, b);
  if (lane == 0) (is_v ? v_scale : k_scale)[dst] = scale;
}

template <typename T>
cudaError_t launch_typed(const void* k_new, const void* v_new, int8_t* kd, int8_t* vd,
                         float* ks, float* vs, const int* block_ids, const int* offsets,
                         int R, int K, int D, int bs, cudaStream_t stream) {
  const long long vectors = 2LL * R * K;
  const unsigned blocks = static_cast<unsigned>((vectors + kWarps - 1) / kWarps);
#define PSTT_KV_WRITE_CASE(DIM)                                                \
  case DIM:                                                                    \
    kv_write_int8_kernel<T, DIM / 32><<<blocks, kWarps * 32, 0, stream>>>(     \
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), kd, vd,    \
        ks, vs, block_ids, offsets, R, K, bs);                                 \
    break;
  switch (D) {
    PSTT_KV_WRITE_CASE(64)
    PSTT_KV_WRITE_CASE(128)
    PSTT_KV_WRITE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PSTT_KV_WRITE_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Every tensor is contiguous; dtype is
// the new rows' DType code.  With offsets (int32 [R]) row r goes to
// (block_ids[r], offsets[r]); with offsets null, R is a multiple of bs and
// row r goes to (block_ids[r / bs], r % bs).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int kv_write_int8_launch(const void* k_new, const void* v_new, void* k_data,
                                    void* v_data, void* k_scale, void* v_scale,
                                    const void* block_ids, const void* offsets, int R,
                                    int K, int D, int bs, int dtype, void* stream) {
  if (R == 0) return 0;
  if (K <= 0 || bs <= 0 || (!offsets && R % bs != 0)) return cudaErrorInvalidValue;
  int8_t* kd = static_cast<int8_t*>(k_data);
  int8_t* vd = static_cast<int8_t*>(v_data);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  const int* ids = static_cast<const int*>(block_ids);
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(k_new, v_new, kd, vd, ks, vs, ids, offs, R, K, D, bs, st);
  if (dtype == kFloat32)
    return launch_typed<float>(k_new, v_new, kd, vd, ks, vs, ids, offs, R, K, D, bs, st);
  return cudaErrorInvalidValue;
}
