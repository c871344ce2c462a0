// Paged decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the int8 branch (`quantized=True`) of the TPU kernel
// `paged_decode_attention_pallas` (body `_decode_kernel`) in
// production_stack_tpu/engine/ops/pallas/paged_attention.py.  Each cache
// side is int8 data [N, bs, K, D] with one fp32 scale per (token, KV head),
// [N, bs, K]; the stored vector is data * scale.  For each row s it
// computes softmax(q . K^T * scale) . V over the first ctx_lens[s] tokens,
// blocks taken from block_tables[s], query head h reading KV head h / G,
// with an optional sliding window (keep pos > ctx - 1 - window).  Rows with
// ctx == 0 give zeros.  q is bf16 or fp32 and the output is in q's type;
// every sum is fp32.
//
// What bounds it on an H100: bytes.  Each row must read every live KV
// vector once, D int8 values plus a 4-byte scale per side: K * (D + 4) * 2
// bytes a token, about half of the bf16 kernel's.  The arithmetic is ~4 * G
// operations per token and head dimension, far under what would make the
// card's arithmetic the limit.
//
// What the design does about it (the dense kernel's, paged_decode.cu, with
// int8 tiles):
//  * One thread block per (row, KV head) serves all G query heads, so each
//    KV vector is read once per KV head.
//  * The loop runs over the row's live tokens only, looking blocks up in
//    block_tables as it goes; the table's padded width is never walked,
//    and a sliding window skips whole tiles before it.
//  * K and V move as 16-byte vectors (16 int8 values) into shared tiles of
//    ~16 KB each: 128 tokens at D = 128 (the cap), 64 at D = 256.  Rows are
//    padded by 16 bytes so the per-token dot products read shared memory
//    without bank conflicts.  The tile's scales sit beside it in shared
//    memory.
//  * The scales stay outside the inner products: score = (q . k_int8) *
//    k_scale[t], and v_scale[t] is folded into the probability before the
//    value sum (the softmax denominator takes the unscaled probability).
//    The same function as dequantizing first, rounded differently at
//    ~1e-7 relative.  A scale of 0 (null block, zero vector) gives exact
//    zeros, never NaN.
//  * Bytes become floats by integer and float adds (common.cuh,
//    unpack_word_s8), not by the integer-to-float conversion instruction,
//    which runs at an eighth of the FMA rate; the value pass reads 4
//    bytes at a time for 4 outputs.
//  * Simple first: one tile in flight, no split over the context.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;  // query heads per KV head
constexpr int kV = 16;    // int8 values in one 16-byte vector

template <int D>
struct Int8Shape {
  // Tokens per tile: ~16 KB of K (and of V) per tile, at most 128 tokens.
  static constexpr int TT_RAW = 16384 / D;
  static constexpr int TT = TT_RAW < 128 ? TT_RAW : 128;
  static constexpr int ROW = D + kV;  // padded row, in bytes
  // Outputs (g, d) per thread, in runs of 4 consecutive d: kMaxG * D is a
  // multiple of 4 * kThreads for every D taken (64, 128, 256).
  static constexpr int ACC = kMaxG * D / kThreads;
  static_assert(ACC % 4 == 0, "outputs per thread come in runs of 4");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const T* __restrict__ q,              // [S, H, D]
                         const int8_t* __restrict__ k_data,    // [N, bs, K, D]
                         const int8_t* __restrict__ v_data,
                         const float* __restrict__ k_scale,    // [N, bs, K]
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables, // [S, bmax]
                         const int* __restrict__ ctx_lens,     // [S]
                         T* __restrict__ out,                  // [S, H, D]
                         int H, int K, int G, int bs, int bmax, float scale,
                         int window) {
  using Sh = Int8Shape<D>;
  constexpr int TT = Sh::TT;
  constexpr int ROW = Sh::ROW;
  constexpr int NV = D / kV;  // vectors per row

  __shared__ __align__(16) int8_t sK[TT * ROW];
  __shared__ __align__(16) int8_t sV[TT * ROW];
  __shared__ float sKs[TT], sVs[TT];
  __shared__ __align__(16) float sQ[kMaxG * D];
  __shared__ float sS[kMaxG * TT];
  __shared__ float sM[kMaxG], sL[kMaxG], sAlpha[kMaxG];

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ctx = ctx_lens[s];
  const int* table = block_tables + static_cast<size_t>(s) * bmax;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sQ[i] = to_float(q[(static_cast<size_t>(s) * H + kh * G + g) * D + d]) * scale;
  }
  if (tid < kMaxG) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[Sh::ACC];
#pragma unroll
  for (int a = 0; a < Sh::ACC; ++a) acc[a] = 0.f;

  // Sliding window: keys with pos >= ctx - window are kept.
  const int lo = window >= 0 ? max(0, ctx - window) : 0;
  for (int p0 = (lo / TT) * TT; p0 < ctx; p0 += TT) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < TT * NV; i += kThreads) {
      const int t = i / NV, dv = i % NV;
      const int p = p0 + t;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (p < ctx) {
        const int blk = table[p / bs];
        const size_t off =
            ((static_cast<size_t>(blk) * bs + p % bs) * K + kh) * D + dv * kV;
        kx = *reinterpret_cast<const uint4*>(k_data + off);
        vx = *reinterpret_cast<const uint4*>(v_data + off);
      }
      *reinterpret_cast<uint4*>(sK + t * ROW + dv * kV) = kx;
      *reinterpret_cast<uint4*>(sV + t * ROW + dv * kV) = vx;
    }
    // Scales: one per (token, KV head); the plane's stride is K, not D.
    for (int t = tid; t < TT; t += kThreads) {
      const int p = p0 + t;
      float ks = 0.f, vs = 0.f;
      if (p < ctx) {
        const size_t off =
            (static_cast<size_t>(table[p / bs]) * bs + p % bs) * K + kh;
        ks = k_scale[off];
        vs = v_scale[off];
      }
      sKs[t] = ks;
      sVs[t] = vs;
    }
    __syncthreads();

    // Scores: one (head, token) dot product per thread and pass, the K
    // scale applied once to the finished sum.
    for (int i = tid; i < G * TT; i += kThreads) {
      const int g = i / TT, t = i % TT;
      const int p = p0 + t;
      float dot = 0.f;
#pragma unroll 2
      for (int dv = 0; dv < NV; ++dv) {
        float kf[kV];
        load_vec(sK + t * ROW + dv * kV, kf);
        const float* qg = sQ + g * D + dv * kV;
#pragma unroll
        for (int e = 0; e < kV; ++e) dot = fmaf(qg[e], kf[e], dot);
      }
      sS[i] = (p < ctx && p >= lo) ? dot * sKs[t] : -INFINITY;
    }
    __syncthreads();

    // Online softmax: one warp per query head.  The sum takes p; the
    // value pass reads p * v_scale[t].
    for (int g = warp; g < G; g += kThreads / 32) {
      float mt = -INFINITY;
      for (int t = lane; t < TT; t += 32) mt = fmaxf(mt, sS[g * TT + t]);
      mt = warp_max(mt);
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      for (int t = lane; t < TT; t += 32) {
        const float sv = sS[g * TT + t];
        const float pv = sv == -INFINITY ? 0.f : expf(sv - m_new);
        sS[g * TT + t] = pv * sVs[t];
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + sum;
        sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha[g] + sum_t (p[g, t] * vs[t]) * v_int8[t, d],
    // 4 consecutive d per run: one 4-byte shared load gives 4 values.
#pragma unroll
    for (int r = 0; r < Sh::ACC / 4; ++r) {
      const int o = (tid + r * kThreads) * 4;
      if (o < G * D) {
        const int g = o / D, d = o % D;
        const float al = sAlpha[g];
        float sum[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] = acc[4 * r + e] * al;
        const float* pg = sS + g * TT;
        for (int t = 0; t < TT; ++t) {
          float vf[4];
          unpack_word_s8(*reinterpret_cast<const unsigned*>(sV + t * ROW + d), vf);
          const float pt = pg[t];
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e] = fmaf(pt, vf[e], sum[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * r + e] = sum[e];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < Sh::ACC / 4; ++r) {
    const int o = (tid + r * kThreads) * 4;
    if (o < G * D) {
      const int g = o / D, d = o % D;
      const float l = sL[g];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(static_cast<size_t>(s) * H + kh * G + g) * D + d + e] =
            from_float<T>(l > 0.f ? acc[4 * r + e] / l : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const int8_t* kd, const int8_t* vd,
                         const float* ks, const float* vs, const int* tables,
                         const int* ctx, void* out, int S, int H, int K, int D,
                         int bs, int bmax, float scale, int window,
                         cudaStream_t stream) {
  const dim3 grid(S, K);
  const int G = H / K;
#define PSTT_DECODE_INT8_CASE(DIM)                                             \
  case DIM:                                                                    \
    paged_decode_int8_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(           \
        static_cast<const T*>(q), kd, vd, ks, vs, tables, ctx,                 \
        static_cast<T*>(out), H, K, G, bs, bmax, scale, window);               \
    break;
  switch (D) {
    PSTT_DECODE_INT8_CASE(64)
    PSTT_DECODE_INT8_CASE(128)
    PSTT_DECODE_INT8_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PSTT_DECODE_INT8_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Every tensor is contiguous; dtype is
// q's (and the output's) DType code; window < 0 means no sliding window.
// Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_int8_launch(
    const void* q, const void* k_data, const void* v_data, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* ctx_lens,
    void* out, int S, int H, int K, int D, int bs, int bmax, int dtype,
    float scale, int window, void* stream) {
  if (S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxG) return cudaErrorInvalidValue;
  const int8_t* kd = static_cast<const int8_t*>(k_data);
  const int8_t* vd = static_cast<const int8_t*>(v_data);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(q, kd, vd, ks, vs, tables, ctx, out, S, H, K,
                                  D, bs, bmax, scale, window, st);
  if (dtype == kFloat32)
    return launch_typed<float>(q, kd, vd, ks, vs, tables, ctx, out, S, H, K, D,
                               bs, bmax, scale, window, st);
  return cudaErrorInvalidValue;
}
