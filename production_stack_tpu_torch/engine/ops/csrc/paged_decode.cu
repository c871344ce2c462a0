// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_pallas` (body
// `_decode_kernel`) in production_stack_tpu/engine/ops/pallas/paged_attention.py:
// for each row s, softmax(q . K^T * scale) . V over the first ctx_lens[s]
// tokens of the paged cache [N, bs, K, D], blocks taken from
// block_tables[s], query head h reading KV head h / G, with an optional
// sliding window (keep pos > ctx - 1 - window).  Rows with ctx == 0 give
// zeros.  Scores, the running max and sum and the accumulator are fp32;
// the output is written in q's type.
//
// What bounds it on an H100: bytes.  Each row must read every live KV
// block once (2 * ctx * K * D elements); the arithmetic is ~2 * G
// operations per byte, far under the ~295 the card needs to be bound by
// its tensor cores.
//
// What the design does about it:
//  * One thread block per (row, KV head) serves all G query heads of that
//    KV head, so each KV block is read from device memory once per KV
//    head, not once per query head.
//  * The loop runs over the row's live tokens only, ceil(ctx / tile)
//    tiles, looking blocks up in block_tables as it goes; the table's
//    padded width (Bmax, 2048 at max_model_len 32768) is never walked.
//  * K and V move as 16-byte vectors, neighbouring threads on neighbouring
//    addresses, into shared memory tiles of ~16 KB each.  Rows are padded
//    by 16 bytes so that the per-token dot products (one thread per
//    token) read shared memory without bank conflicts.
//  * Simple first: one tile in flight at a time and no split over the
//    context.  At S = 8 rows and K = 8 KV heads the grid is 64 blocks,
//    under half of the card's 132 SMs; split-KV with a second reduction
//    pass is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;  // query heads per KV head

template <typename T, int D>
struct DecodeShape {
  static constexpr int V = Vec<T>::N;
  // Tokens per tile: ~16 KB of K (and of V) per tile, at most 128 tokens.
  static constexpr int TT_RAW = 16384 / (D * static_cast<int>(sizeof(T)));
  static constexpr int TT = TT_RAW < 128 ? TT_RAW : 128;
  static constexpr int ROW = D + V;  // padded row, in elements
  static constexpr int ACC = (kMaxG * D + kThreads - 1) / kThreads;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [S, H, D]
                    const T* __restrict__ k_cache,  // [N, bs, K, D]
                    const T* __restrict__ v_cache,
                    const int* __restrict__ block_tables,  // [S, bmax]
                    const int* __restrict__ ctx_lens,      // [S]
                    T* __restrict__ out,                   // [S, H, D]
                    int H, int K, int G, int bs, int bmax, float scale,
                    int window) {
  using Sh = DecodeShape<T, D>;
  constexpr int V = Sh::V;
  constexpr int TT = Sh::TT;
  constexpr int ROW = Sh::ROW;
  constexpr int NV = D / V;  // vectors per row

  __shared__ __align__(16) T sK[TT * ROW];
  __shared__ __align__(16) T sV[TT * ROW];
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
            ((static_cast<size_t>(blk) * bs + p % bs) * K + kh) * D + dv * V;
        kx = *reinterpret_cast<const uint4*>(k_cache + off);
        vx = *reinterpret_cast<const uint4*>(v_cache + off);
      }
      *reinterpret_cast<uint4*>(sK + t * ROW + dv * V) = kx;
      *reinterpret_cast<uint4*>(sV + t * ROW + dv * V) = vx;
    }
    __syncthreads();

    // Scores: one (head, token) dot product per thread and pass.
    for (int i = tid; i < G * TT; i += kThreads) {
      const int g = i / TT, t = i % TT;
      const int p = p0 + t;
      float dot = 0.f;
#pragma unroll 4
      for (int dv = 0; dv < NV; ++dv) {
        float kf[V];
        load_vec(sK + t * ROW + dv * V, kf);
        const float* qg = sQ + g * D + dv * V;
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qg[e], kf[e], dot);
      }
      sS[i] = (p < ctx && p >= lo) ? dot : -INFINITY;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
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
        sS[g * TT + t] = pv;
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

    // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * V[t, d].
#pragma unroll
    for (int a = 0; a < Sh::ACC; ++a) {
      const int o = tid + a * kThreads;
      if (o < G * D) {
        const int g = o / D, d = o % D;
        float sum = acc[a] * sAlpha[g];
        const float* pg = sS + g * TT;
        for (int t = 0; t < TT; ++t) sum = fmaf(pg[t], to_float(sV[t * ROW + d]), sum);
        acc[a] = sum;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < Sh::ACC; ++a) {
    const int o = tid + a * kThreads;
    if (o < G * D) {
      const int g = o / D, d = o % D;
      const float l = sL[g];
      out[(static_cast<size_t>(s) * H + kh * G + g) * D + d] =
          from_float<T>(l > 0.f ? acc[a] / l : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* tables, const int* ctx, void* out, int S,
                         int H, int K, int D, int bs, int bmax, float scale,
                         int window, cudaStream_t stream) {
  const dim3 grid(S, K);
  const int G = H / K;
#define PSTT_DECODE_CASE(DIM)                                                  \
  case DIM:                                                                    \
    paged_decode_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(                \
        static_cast<const T*>(q), static_cast<const T*>(k),                    \
        static_cast<const T*>(v), tables, ctx, static_cast<T*>(out), H, K, G,  \
        bs, bmax, scale, window);                                              \
    break;
  switch (D) {
    PSTT_DECODE_CASE(64)
    PSTT_DECODE_CASE(128)
    PSTT_DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PSTT_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Every tensor is contiguous; dtype is a
// DType code; window < 0 means no sliding window.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* block_tables,
                                   const void* ctx_lens, void* out, int S, int H,
                                   int K, int D, int bs, int bmax, int dtype,
                                   float scale, int window, void* stream) {
  if (S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxG) return cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(q, k_cache, v_cache, tables, ctx, out, S, H,
                                  K, D, bs, bmax, scale, window, st);
  if (dtype == kFloat32)
    return launch_typed<float>(q, k_cache, v_cache, tables, ctx, out, S, H, K,
                               D, bs, bmax, scale, window, st);
  return cudaErrorInvalidValue;
}
