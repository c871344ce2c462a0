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
// ctx == 0 give exact zeros.  q is bf16 or fp32 and the output is in q's
// type; every product and sum is fp32.
//
// What bounds it on an H100: bytes.  Each row must read every live KV
// vector once, D int8 values plus a 4-byte scale per side: K * (D + 4) * 2
// bytes a token, about half of the bf16 kernel's.  The arithmetic is ~4 * G
// operations per token, KV head and head dimension plus ~2 to turn each
// byte into a float, far under what would make the arithmetic the limit.
//
// What the design does about it: the dense kernel's split-KV design
// (paged_decode.cu), sized for int8 tiles, with the per-tile work cut
// where an H100 measured it (PERF.md): at 8 rows the kernel is
// bound by each warp's instruction stream, not by DRAM.
//  * Grid (row, KV head, split), the split and the merge shared with the
//    dense kernel (decode_split, decode_merge in common.cuh).  Each block
//    serves all G query heads of its KV head, so each KV vector is read
//    once per KV head.  n_split comes from the host (`split_count` with
//    12 blocks an SM, against the dense kernel's 8: at 8 rows of up to
//    4000 tokens that cuts the longest split to 10 tiles, and more splits
//    no longer fit the card at once) and the launch never waits on a
//    device value; each row takes ceil(live / split_tokens) of the splits
//    on the device, so the 64 blocks of the old (row, KV head) grid at 8
//    rows became ~620 live ones, and one 32000-token row is spread over
//    64.
//  * Inside a block each of the 4 warps owns its own tiles of TT tokens
//    (2 KB of int8 K and 2 KB of V, the dense kernel's tile in bytes: TT =
//    16 at D = 128) and its own online softmax, and loads them by cp.async
//    into its own 2-stage ring, the next tile in flight while the current
//    one is scored; it synchronises only itself (__syncwarp).  The block's
//    barriers come once, at the end, for the merge.
//  * The scales ride the same ring: the lane that computes a token's row
//    address (and broadcasts it by __shfl_sync for the 16-byte copies)
//    issues one 4-byte cp.async per side for that token's scale; the
//    scale plane is [N, bs, K], so a token's scale index is its row index
//    over D.
//  * Scores: lane (tok, part) dots its D / PARTS values of tokens tok and
//    tok + TT / 2 with every head's q (fp32 in shared memory, pre-scaled
//    by scale * log2 e, each part padded by 16 bytes), so each q load
//    feeds two tokens; the parts are summed by shuffles.
//  * Softmax: the tile's scores go through shared memory, so that each
//    lane runs the online softmax of one head over TT * G / 32 tokens,
//    with 3 shuffles for the max and 3 for the sum, instead of every lane
//    reducing every head.  The scales stay outside the inner products:
//    score = (q . k_int8) * k_scale[t], and v_scale[t] folds into the
//    probability before the value sum (the softmax sum takes the unscaled
//    one).  A scale of 0 (null block, zero vector) gives exact zeros,
//    never NaN.
//  * Value pass: p * v_scale of every (token, head) is read back from
//    shared memory as one broadcast 16-byte load per token and 4 heads,
//    in place of a shuffle per token and head (that change alone took
//    8 rows from 0.034 to 0.029 ms).  Each lane reads D / 32 bytes of a V
//    row for its D / 32 output columns.
//  * Bytes become floats by a byte permute and an fp32 subtract
//    (unpack_word_s8 in common.cuh), not by the integer-to-float
//    instruction, which runs at an eighth of the FMA rate.
//  * The per-head arrays are sized for G rounded up to 4 or 8 (template
//    GP): at G = 4 and D = 128 the kernel takes ~95 registers and 41 KB of
//    shared memory, so 5 blocks fit an SM.
#include "common.cuh"

namespace {

constexpr int kWarps = kDecodeWarps;
constexpr int kThreads = kDecodeThreads;
constexpr int kStages = 2;          // tiles in each warp's ring
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Int8Shape {
  // Tokens per warp tile: 2 KB of K (and of V) per tile, at most 16.
  static constexpr int TT = 2048 / D < 16 ? 2048 / D : 16;
  // Score pass: lane (tok, part) dots its PER_PART values of tokens tok
  // and tok + TT / 2 with q, so each q load feeds two tokens.
  static constexpr int HALF = TT / 2;         // token slots of a pass
  static constexpr int PARTS = 32 / HALF;     // lanes per token
  static constexpr int PER_PART = D / PARTS;  // int8 values of a row per lane
  // q is stored [G][PARTS][QP]: padding each part by 16 bytes puts the
  // parts' reads of one instruction in different bank groups.
  static constexpr int QP = PER_PART + 4;
  static constexpr int CH = D / 16;           // 16-byte chunks per row
  static constexpr int ROW = D + 16;          // row padded by 16 bytes
  static constexpr int VC = D / 32;           // output columns per lane
  static constexpr int TILE = TT * ROW;       // bytes of one K (or V) tile
  static constexpr int LOADS = TT * CH / 32;  // 16-byte copies per lane per side
  // A stage: the K tile, the V tile, then TT K scales and TT V scales.
  static constexpr int STAGE = 2 * TILE + 2 * TT * static_cast<int>(sizeof(float));
  static_assert(STAGE % 16 == 0, "stages start on 16 bytes");
  static constexpr size_t STAGING = static_cast<size_t>(kWarps) * kStages * STAGE;
  // The merge (decode_merge, common.cuh) reuses the tiles' shared memory.
  static constexpr size_t MERGE = DecodeMergeSmem<D>::BYTES;
  static constexpr size_t SMEM_TILES = STAGING > MERGE ? STAGING : MERGE;
};

// GP: head slots per warp, G rounded up to 4 or 8 (the per-head state
// arrays are sized for it; heads g >= G are skipped).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const T* __restrict__ q,              // [S, H, D]
                         const int8_t* __restrict__ k_data,    // [N, bs, K, D]
                         const int8_t* __restrict__ v_data,
                         const float* __restrict__ k_scale,    // [N, bs, K]
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables, // [S, bmax]
                         const int* __restrict__ ctx_lens,     // [S]
                         T* __restrict__ out,                  // [S, H, D]
                         float* __restrict__ part_ml,   // [S, K, n_split, G, 2]
                         float* __restrict__ part_acc,  // [S, K, n_split, G, D]
                         int* __restrict__ counters,    // [S * K], 0 between calls
                         int H, int K, int G, int bs, int bmax, int n_split,
                         int split_tokens, float scale_log2, int window) {
  using Sh = Int8Shape<D>;
  constexpr int TT = Sh::TT;
  constexpr int HALF = Sh::HALF;
  constexpr int ROW = Sh::ROW;
  constexpr int VC = Sh::VC;

  __shared__ __align__(16) float sQ[GP * Sh::PARTS * Sh::QP];  // q * scale * log2(e)
  __shared__ __align__(16) float sP[kWarps][TT][GP];  // a tile's scores, then p * v_scale
  __shared__ __align__(16) float sA[kWarps][GP];      // a tile's rescale per head
  __shared__ __align__(16) unsigned char sTiles[Sh::SMEM_TILES];

  const int s = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ctx = ctx_lens[s];
  const int* table = block_tables + static_cast<size_t>(s) * bmax;

  // This row's splits, and this split's tokens [beg, end).
  const DecodeSplit sp = decode_split(ctx, window, n_split, split_tokens, split, TT);
  if (split >= sp.n_row) return;
  const int beg = sp.beg, end = sp.end;
  const int ntile = (end - beg + TT - 1) / TT;
  const int nmine = ntile > warp ? (ntile - warp - 1) / kWarps + 1 : 0;

  unsigned char* ring = sTiles + warp * kStages * Sh::STAGE;
  auto load = [&](int i, int stage) {  // this warp's i-th tile
    const int p0 = beg + (warp + i * kWarps) * TT;
    unsigned char* dk = ring + stage * Sh::STAGE;
    unsigned char* dv = dk + Sh::TILE;
    float* dks = reinterpret_cast<float*>(dv + Sh::TILE);
    long long vec = 0;  // index of token p0 + lane's (token, KV head) vector
    int ok = 0;
    if (lane < TT) {
      const int p = p0 + lane;
      ok = p < end;
      if (ok) vec = (static_cast<long long>(table[p / bs]) * bs + p % bs) * K + kh;
      cp_async4(dks + lane, k_scale + vec, ok);
      cp_async4(dks + TT + lane, v_scale + vec, ok);
    }
#pragma unroll
    for (int c = 0; c < Sh::LOADS; ++c) {
      const int chunk_id = lane + 32 * c;
      const int t = chunk_id / Sh::CH, ch = chunk_id % Sh::CH;
      const long long b = __shfl_sync(kFull, vec, t);
      const bool v = __shfl_sync(kFull, ok, t);
      const long long off = v ? b * D + ch * 16 : 0;
      cp_async16(dk + t * ROW + ch * 16, k_data + off, v);
      cp_async16(dv + t * ROW + ch * 16, v_data + off, v);
    }
  };
  if (nmine > 0) load(0, 0);
  cp_async_commit();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sQ[(g * Sh::PARTS + d / Sh::PER_PART) * Sh::QP + d % Sh::PER_PART] =
        to_float(q[(static_cast<size_t>(s) * H + kh * G + g) * D + d]) * scale_log2;
  }
  __syncthreads();

  // Per-warp online softmax: lane (hg, hs) keeps head hg's running max
  // and sum; every lane keeps output columns lane * VC .. + VC - 1 of
  // each head.
  constexpr int LPG = 32 / GP;   // lanes per head in the softmax
  constexpr int PPL = TT / LPG;  // tokens per lane in the softmax
  const int hg = lane / LPG, hs = lane % LPG;
  float m_mine = -INFINITY, l_mine = 0.f, acc[GP][VC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int e = 0; e < VC; ++e) acc[g][e] = 0.f;
  }

  const int tok = lane % HALF, part = lane / HALF;
  float* myP = &sP[warp][0][0];
  float* myA = &sA[warp][0];
  for (int i = 0; i < nmine; ++i) {
    const int stage = i % kStages;
    if (i + 1 < nmine) load(i + 1, (i + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int8_t* tk = reinterpret_cast<const int8_t*>(ring + stage * Sh::STAGE);
    const int8_t* tv = tk + Sh::TILE;
    const float* tks = reinterpret_cast<const float*>(tv + Sh::TILE);
    const int p0 = beg + (warp + i * kWarps) * TT;

    // Scores: lane (tok, part) dots its part of tokens tok and tok + HALF
    // with every head.
    float sc[GP][2];
#pragma unroll
    for (int g = 0; g < GP; ++g) sc[g][0] = sc[g][1] = 0.f;
    const int8_t* krow = tk + tok * ROW + part * Sh::PER_PART;
#pragma unroll
    for (int c = 0; c < Sh::PER_PART / 16; ++c) {
      float k0[16], k1[16];
      load_vec(krow + c * 16, k0);
      load_vec(krow + HALF * ROW + c * 16, k1);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
          const float4* qg = reinterpret_cast<const float4*>(
              sQ + (g * Sh::PARTS + part) * Sh::QP + c * 16);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 qv = qg[e4];
            sc[g][0] = fmaf(qv.x, k0[4 * e4], sc[g][0]);
            sc[g][0] = fmaf(qv.y, k0[4 * e4 + 1], sc[g][0]);
            sc[g][0] = fmaf(qv.z, k0[4 * e4 + 2], sc[g][0]);
            sc[g][0] = fmaf(qv.w, k0[4 * e4 + 3], sc[g][0]);
            sc[g][1] = fmaf(qv.x, k1[4 * e4], sc[g][1]);
            sc[g][1] = fmaf(qv.y, k1[4 * e4 + 1], sc[g][1]);
            sc[g][1] = fmaf(qv.z, k1[4 * e4 + 2], sc[g][1]);
            sc[g][1] = fmaf(qv.w, k1[4 * e4 + 3], sc[g][1]);
          }
        }
      }
    }
    // Sum the parts: every lane of a token then holds its scores.  Then
    // transpose through shared memory, so that lane (hg, hs) runs the
    // online softmax of head hg alone, over tokens hs * PPL .. + PPL - 1.
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int o = HALF; o < 32; o <<= 1) sc[g][j] += __shfl_xor_sync(kFull, sc[g][j], o);
      }
    }
    if (part == 0) {
#pragma unroll
      for (int g4 = 0; g4 < GP / 4; ++g4) {
        reinterpret_cast<float4*>(myP + tok * GP)[g4] =
            make_float4(sc[4 * g4][0], sc[4 * g4 + 1][0], sc[4 * g4 + 2][0], sc[4 * g4 + 3][0]);
        reinterpret_cast<float4*>(myP + (tok + HALF) * GP)[g4] =
            make_float4(sc[4 * g4][1], sc[4 * g4 + 1][1], sc[4 * g4 + 2][1], sc[4 * g4 + 3][1]);
      }
    }
    __syncwarp();
    float x[PPL];
    float mt = -INFINITY;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int t = hs * PPL + k;
      x[k] = p0 + t < end ? myP[t * GP + hg] * tks[t] : -INFINITY;
      mt = fmaxf(mt, x[k]);
    }
#pragma unroll
    for (int o = 1; o < LPG; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    const float m_new = fmaxf(m_mine, mt);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_mine - m_use);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int t = hs * PPL + k;
      const float pu = exp2f(x[k] - m_use);
      sum += pu;
      myP[t * GP + hg] = pu * tks[TT + t];  // the slot this lane read: p * v_scale
    }
#pragma unroll
    for (int o = 1; o < LPG; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
    l_mine = l_mine * alpha + sum;
    m_mine = m_new;
    if (hs == 0) myA[hg] = alpha;
    __syncwarp();
#pragma unroll
    for (int g4 = 0; g4 < GP / 4; ++g4) {
      const float4 a = reinterpret_cast<const float4*>(myA)[g4];
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        acc[4 * g4][e] *= a.x;
        acc[4 * g4 + 1][e] *= a.y;
        acc[4 * g4 + 2][e] *= a.z;
        acc[4 * g4 + 3][e] *= a.w;
      }
    }

    // acc[g, :] += sum_t p[g, t] * v_int8[t, :].
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float vf[VC];
      load_s8<VC>(tv + t * ROW + lane * VC, vf);
      float pt[GP];
#pragma unroll
      for (int g4 = 0; g4 < GP / 4; ++g4) {
        const float4 pa = reinterpret_cast<const float4*>(myP + t * GP)[g4];
        pt[4 * g4] = pa.x;
        pt[4 * g4 + 1] = pa.y;
        pt[4 * g4 + 2] = pa.z;
        pt[4 * g4 + 3] = pa.w;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VC; ++e) acc[g][e] = fmaf(pt[g], vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // the stage and sP are consumed before this warp reuses them
  }
  cp_async_wait<0>();
  float m[GP], l[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = __shfl_sync(kFull, m_mine, g * LPG);
    l[g] = __shfl_sync(kFull, l_mine, g * LPG);
  }
  decode_merge<T, D>(m, l, acc, reinterpret_cast<float*>(sTiles), out, part_ml,
                     part_acc, counters, s, kh, split, sp.n_row, n_split, H, K, G);
}

template <typename T, int D, int GP>
void launch_one(dim3 grid, cudaStream_t stream, const void* q, const int8_t* kd,
                const int8_t* vd, const float* ks, const float* vs, const int* tables,
                const int* ctx, void* out, float* part_ml, float* part_acc,
                int* counters, int H, int K, int bs, int bmax, int n_split,
                int split_tokens, float scale, int window) {
  paged_decode_int8_kernel<T, D, GP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), kd, vd, ks, vs, tables, ctx, static_cast<T*>(out),
      part_ml, part_acc, counters, H, K, H / K, bs, bmax, n_split, split_tokens,
      scale * kLog2e, window);
}

template <typename T>
cudaError_t launch_typed(const void* q, const int8_t* kd, const int8_t* vd,
                         const float* ks, const float* vs, const int* tables,
                         const int* ctx, void* out, float* part_ml, float* part_acc,
                         int* counters, int S, int H, int K, int D, int bs, int bmax,
                         int n_split, int split_tokens, float scale, int window,
                         cudaStream_t stream) {
  const dim3 grid(S, K, n_split);
  const bool wide = H / K > 4;  // more than 4 query heads per KV head
#define PSTT_DECODE_INT8_CASE(DIM)                                             \
  case DIM:                                                                    \
    (wide ? launch_one<T, DIM, 8> : launch_one<T, DIM, 4>)(                    \
        grid, stream, q, kd, vd, ks, vs, tables, ctx, out, part_ml, part_acc,  \
        counters, H, K, bs, bmax, n_split, split_tokens, scale, window);       \
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
// n_split is the most splits a row may take, split_tokens the fewest
// tokens a split is given.  With n_split > 1, part_ml / part_acc are fp32
// scratch of S * K * n_split * G * 2 and * G * D floats and counters
// S * K int32 zeros, left zero again by the kernel; with n_split == 1 all
// three may be null.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_int8_launch(
    const void* q, const void* k_data, const void* v_data, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* ctx_lens,
    void* out, void* part_ml, void* part_acc, void* counters, int S, int H, int K,
    int D, int bs, int bmax, int dtype, int n_split, int split_tokens, float scale,
    int window, void* stream) {
  if (S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kDecodeMaxG) return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplit || split_tokens < 1 ||
      (n_split > 1 && (!part_ml || !part_acc || !counters)))
    return cudaErrorInvalidValue;
  const int8_t* kd = static_cast<const int8_t*>(k_data);
  const int8_t* vd = static_cast<const int8_t*>(v_data);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(q, kd, vd, ks, vs, tables, ctx, out, ml, acc, cnt,
                                  S, H, K, D, bs, bmax, n_split, split_tokens,
                                  scale, window, st);
  if (dtype == kFloat32)
    return launch_typed<float>(q, kd, vd, ks, vs, tables, ctx, out, ml, acc, cnt, S,
                               H, K, D, bs, bmax, n_split, split_tokens, scale,
                               window, st);
  return cudaErrorInvalidValue;
}
