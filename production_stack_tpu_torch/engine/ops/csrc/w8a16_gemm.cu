// W8A16 GEMM for Hopper (sm_90a): out = (x @ q) * s, in fp32.
//
// Replaces no Pallas kernel: it is the int8 branch of the JAX package's
// `_dot` (production_stack_tpu/engine/models/llama.py:119-129), plain jnp
// that XLA fuses, so that the int8 -> bf16 convert happens in the matrix
// unit's operand read and "int8 is what streams from HBM".  On the card a
// plain `x @ q.to(bf16)` reads the int8 weight (1 byte), writes a bf16
// copy (2 bytes) and reads it again (2 bytes): 5 bytes a weight against
// bf16 weights' 2, which would make int8 weights slower than the bf16
// ones they replace.  This kernel reads each int8 weight once.
//
// x [M, K] is bf16 (fp32 for fp32 models), q int8 [K, N] (the JAX package's
// [in, out] layout, row-major), s fp32 [N] the per-out-channel scale, out
// fp32 [M, N]; callers add LoRA deltas and biases to the fp32 result before
// they cast, as the JAX callers do.  M runs from 1 (a K=1 decode step)
// through 8-40 (windows, verifies) and ~520 (a mixed iteration) to 16384
// (an encode batch).
//
// What bounds it on an H100: at decode row counts bytes, the weight at one
// byte a value (llama-3.1-8b's projections at M = 8: 5 us for q_proj, 17.5
// us for gate_proj, 157 us for the lm_head at 3.35 TB/s); from a few
// hundred rows the tensor cores (2 M N K operations at 989 TFLOP/s bf16).
//
// What the design does about it, simple first:
// - Tiles of q come into shared memory with cp.async (16 bytes a thread),
//   STAGES deep, beside the matching tile of x, so int8 is all that
//   crosses HBM for the weight.
// - x is read with ldmatrix, q's int8 tile with ldmatrix.trans as byte
//   pairs and converted to bf16 in registers (exact: |q| <= 128; see
//   mma_step); the product runs on mma.sync.m16n8k16 bf16 -> fp32 (the
//   fragments of common.cuh, as in flash_prefill.cu), and the scale is
//   applied in the epilogue, on the fp32 sum, with one coalesced store a
//   row (fp32, or rounded to bf16 for a caller that casts at once).
// - The design follows M.  At decode row counts (M <= 64) bytes bound it,
//   so the weight must stream from every SM: a block is 8 warps over a
//   BM x 64 tile, each warp with a cp.async pipeline of its own over
//   every 8th 32-deep tile of K (no block barrier in the loop), their sums
//   added in shared memory in warp order; a weight with fewer column tiles
//   than SMs (k_proj's 1024 columns: 16 tiles) is split over K across
//   blocks (split_k in the wrapper), the last split of a tile to arrive
//   adding the splits' fp32 partials in split order, so the result is the
//   same whatever order blocks ran in.  From 65 rows, blocks of 128 x 128
//   (warps of 64 x 64) share each staged tile between warps, and walk the
//   output in groups of 8 row tiles, so a weight tile is read from HBM
//   about once a group.  They reach ~270 TFLOP/s, a third of cuBLAS's bf16
//   GEMM: neither the tile shape nor shared-memory traffic bounds them
//   (removing the bf16 tile's round trip gained 7%); mma.sync's issue rate
//   with the in-register convert beside it does.  wgmma is the remedy, for
//   a later PR.
// - fp32 activations (the fp32 reference models) take a CUDA-core body.
// - Nothing is allocated, synchronised or read back: the kernel runs
//   inside captured CUDA graphs.  Ragged M, N and K edges are masked (K a
//   multiple of 8 and N of 16, which the wrapper checks).
#include "common.cuh"

namespace {

// Four signed bytes as two words of two bf16 each: bytes 0 and 2 into
// `even`, bytes 1 and 3 into `odd` (low half first).  Exact: each value
// is an integer of at most 8 significant bits, so its fp32 bits end in 16
// zeros and the upper half is the bf16.
__device__ __forceinline__ void s8x4_to_bf16(unsigned w, unsigned& even, unsigned& odd) {
  float f[4];
  unpack_word_s8(w, f);
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// One warp's MT x NT tiles of 16 x 8 over a 16-deep step of K.  A (bf16,
// a_row elements a row): rows [row0, row0 + 16 MT) at column k, through
// ldmatrix.  B is q's int8 tile ([k][n], b_row bytes a row), read with
// ldmatrix.trans as if its byte pairs were b16: lane (g, c) receives
// q[k + 2c][n + 2g], q[k + 2c][n + 2g + 1], q[k + 2c + 1][n + 2g] and
// q[k + 2c + 1][n + 2g + 1], so its even bytes are the B fragment of
// column n + 2g and its odd bytes that of column n + 2g + 1.  Each 16
// columns are therefore two n8 tiles, of the even and of the odd columns
// (acc[.][2j] and acc[.][2j + 1] for columns col0 + 16 j ..), which
// stash() writes back in column order.  The int8 tile is converted in
// registers; nothing is written back to shared memory.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const bf16_raw* a,
                                         int a_row, int row0, const int8_t* b, int b_row,
                                         int col0, int k, int lane) {
  static_assert(NT % 4 == 0, "32 columns an ldmatrix");
  unsigned af[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldmatrix_x4(af[mt], a + (row0 + mt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * a_row + k +
                            (lane / 16) * 8);
#pragma unroll
  for (int gp = 0; gp < NT / 4; ++gp) {
    // Matrices: k rows [k, k + 8) and [k + 8, k + 16) of columns
    // [col0 + 32 gp, + 16), then the same of the next 16 columns.
    unsigned r[4];
    ldmatrix_x4_trans(r, reinterpret_cast<const bf16_raw*>(
                             b + (k + ((lane / 8) % 2) * 8 + lane % 8) * b_row + col0 +
                             gp * 32 + (lane / 16) * 16));
    unsigned e[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s8x4_to_bf16(r[i], e[i], o[i]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][4 * gp], af[mt], e[0], e[1]);
      mma_bf16(acc[mt][4 * gp + 1], af[mt], o[0], o[1]);
      mma_bf16(acc[mt][4 * gp + 2], af[mt], e[2], e[3]);
      mma_bf16(acc[mt][4 * gp + 3], af[mt], o[2], o[3]);
    }
  }
}

// A warp's accumulators (mma_step's even / odd column tiles) into
// red[row][col] (fp32, o_row a row), in column order: lane (g, c) holds
// columns 4c .. 4c + 3 of each 16.
template <int MT, int NT>
__device__ __forceinline__ void stash(const float (&acc)[MT][NT][4], float* red, int o_row,
                                      int row0, int col0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const float* e = acc[mt][2 * j];
      const float* o = acc[mt][2 * j + 1];
      float* p = red + static_cast<size_t>(row0 + mt * 16 + lane / 4) * o_row + col0 + j * 16 +
                 (lane % 4) * 4;
      *reinterpret_cast<float4*>(p) = make_float4(e[0], o[0], e[1], o[1]);
      *reinterpret_cast<float4*>(p + 8 * o_row) = make_float4(e[2], o[2], e[3], o[3]);
    }
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// Four sums times their columns' scales, stored as fp32 or rounded to
// bf16 (nearest even, as torch's cast of the fp32 result rounds).
__device__ __forceinline__ void scale_store(float* out, float4 v, const float* s) {
  const float4 sc = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<float4*>(out) = make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
}
__device__ __forceinline__ void scale_store(bf16_raw* out, float4 v, const float* s) {
  const float4 sc = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<uint2*>(out) =
      make_uint2(pack_bf16x2(v.x * sc.x, v.y * sc.y), pack_bf16x2(v.z * sc.z, v.w * sc.w));
}

// -- bf16 activations at decode row counts (M <= 64) -------------------------
//
// A block of 8 warps owns a BM x 64 tile of the output and a range of K
// (its split).  Each warp runs a pipeline of its own over every 8th 32-deep
// tile of that range: a STAGES-deep cp.async ring of x's and q's tiles,
// mma.sync into its own accumulators (mma_step); only __syncwarp inside the
// loop.  The 8 warps' sums are
// added in shared memory in warp order, times the scale when the block is
// the only split; else they go to the fp32 workspace ws [splits, M, N], and
// the last split of the tile to arrive (an arrival counter that it resets)
// adds the splits in split order.  The result does not depend on the order
// in which blocks run.

// On one H100 (700 W), 128 or 256 columns a block read the lm_head's
// weight ~15% faster but gate/up's ~25% slower (fewer column tiles than
// SMs), and 2-8 stages or 64-deep tiles moved no shape by more than 10%.
template <int MT_, int STAGES_>
struct Skinny {
  static constexpr int MT = MT_, STAGES = STAGES_;
  static constexpr int WARPS = 8, THREADS = WARPS * 32;
  static constexpr int BM = MT * 16, BN = 64, KT = 32, NT = BN / 8;
  // Rows padded by 16 bytes: the 8 rows one ldmatrix reads at one column
  // fall in 8 different bank groups.
  static constexpr int A_ROW = KT + 8, Q_ROW = BN + 16, O_ROW = BN + 4;
  static constexpr int A_BYTES = BM * A_ROW * 2;  // one stage of x, bf16
  static constexpr int Q_BYTES = KT * Q_ROW;      // one stage of q, int8
  static constexpr int WARP_BYTES = STAGES * (A_BYTES + Q_BYTES);
  static constexpr size_t PIPE = static_cast<size_t>(WARPS) * WARP_BYTES;
  static constexpr size_t EPI = static_cast<size_t>(WARPS) * BM * O_ROW * sizeof(float);
  static constexpr size_t SMEM = PIPE > EPI ? PIPE : EPI;
};

template <class C, typename OutT>
__global__ void __launch_bounds__(C::THREADS, 1)
w8a16_skinny_kernel(const bf16_raw* __restrict__ x,  // [M, K]
                    const int8_t* __restrict__ q,    // [K, N]
                    const float* __restrict__ s,     // [N]
                    OutT* __restrict__ out,          // [M, N], fp32 or bf16
                    float* __restrict__ ws,          // [splits, M, N] when splits > 1
                    int* __restrict__ counters,      // one a (row, column) tile
                    int M, int N, int K, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sLast;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  const int m_tiles = (M + C::BM - 1) / C::BM;
  const int tile = blockIdx.x % (n_tiles * m_tiles);
  const int split = blockIdx.x / (n_tiles * m_tiles);
  const int n0 = (tile % n_tiles) * C::BN, m0 = (tile / n_tiles) * C::BM;
  const int k_tiles = (K + C::KT - 1) / C::KT;
  const int per_split = (k_tiles + splits - 1) / splits;
  const int kt0 = split * per_split + warp, kt1 = min(k_tiles, (split + 1) * per_split);
  const int mine = kt0 < kt1 ? (kt1 - kt0 + C::WARPS - 1) / C::WARPS : 0;

  unsigned char* base = smem + warp * C::WARP_BYTES;
  bf16_raw* sA = reinterpret_cast<bf16_raw*>(base);
  int8_t* sQ = reinterpret_cast<int8_t*>(base + C::STAGES * C::A_BYTES);

  auto load = [&](int i, int stage) {
    const int k0 = (kt0 + i * C::WARPS) * C::KT;
    bf16_raw* a = sA + stage * (C::A_BYTES / 2);
    constexpr int ACH = C::KT / 8;  // 16-byte chunks in a row of x's tile
#pragma unroll
    for (int j = lane; j < C::BM * ACH; j += 32) {
      const int r = j / ACH, c = j % ACH;
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      cp_async16(a + r * C::A_ROW + c * 8, ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    }
    int8_t* b = sQ + stage * C::Q_BYTES;
    constexpr int QCH = C::BN / 16;  // 16-byte chunks in a row of q's tile
#pragma unroll
    for (int j = lane; j < C::KT * QCH; j += 32) {
      const int r = j / QCH, c = j % QCH;
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < K && gn < N;
      cp_async16(b + r * C::Q_ROW + c * 16, ok ? q + static_cast<size_t>(gk) * N + gn : q, ok);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int stage = i % C::STAGES;
    cp_async_wait<C::STAGES - 2>();
    __syncwarp();  // every lane's copies of tile i visible; tile i - 1 consumed
    if (i + C::STAGES - 1 < mine) load(i + C::STAGES - 1, (i + C::STAGES - 1) % C::STAGES);
    cp_async_commit();
    const bf16_raw* a = sA + stage * (C::A_BYTES / 2);
    const int8_t* b = sQ + stage * C::Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::KT / 16; ++kk)
      mma_step(acc, a, C::A_ROW, 0, b, C::Q_ROW, 0, kk * 16, lane);
    __syncwarp();  // tile i read by every lane before its stage is reused
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipelines' shared memory becomes the epilogue's

  float* red = reinterpret_cast<float*>(smem);
  stash(acc, red + static_cast<size_t>(warp) * C::BM * C::O_ROW, C::O_ROW, 0, 0, lane);
  __syncthreads();
  constexpr int OCH = C::BN / 4;
  for (int i = tid; i < C::BM * OCH; i += C::THREADS) {
    const int r = i / OCH, c = (i % OCH) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(red + static_cast<size_t>(r) * C::O_ROW + c);
#pragma unroll
    for (int w = 1; w < C::WARPS; ++w)
      v = add4(v, *reinterpret_cast<const float4*>(
                      red + (static_cast<size_t>(w) * C::BM + r) * C::O_ROW + c));
    if (splits == 1) {
      scale_store(out + static_cast<size_t>(gm) * N + gn, v, s + gn);
    } else {
      *reinterpret_cast<float4*>(ws + (static_cast<size_t>(split) * M + gm) * N + gn) = v;
    }
  }
  if (splits == 1) return;
  // The last split of this tile to arrive adds them all, in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sLast = atomicAdd(counters + tile, 1) == splits - 1;
    if (sLast) counters[tile] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  for (int i = tid; i < C::BM * OCH; i += C::THREADS) {
    const int r = i / OCH, c = (i % OCH) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float4 v = __ldcg(reinterpret_cast<const float4*>(ws + static_cast<size_t>(gm) * N + gn));
    for (int j = 1; j < splits; ++j)
      v = add4(v, __ldcg(reinterpret_cast<const float4*>(
                      ws + (static_cast<size_t>(j) * M + gm) * N + gn)));
    scale_store(out + static_cast<size_t>(gm) * N + gn, v, s + gn);
  }
}

template <class C, typename OutT>
cudaError_t launch_skinny(const void* x, const void* q, const void* s, void* out, void* ws,
                          void* counters, int M, int N, int K, int splits,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      w8a16_skinny_kernel<C, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int blocks = ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN) * splits;
  w8a16_skinny_kernel<C, OutT><<<blocks, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16_raw*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<OutT*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), M, N, K, splits);
  return cudaGetLastError();
}

// -- bf16 activations from 65 rows -------------------------------------------
//
// A block is WM x WN warps over a (WM * MT * 16) x (WN * NT * 8) tile of the
// output; the whole block stages each BK-deep tile of x and q (cp.async,
// STAGES deep), converts q's tile to bf16 once for all warps, and each warp
// multiplies its MT x NT tiles of 16 x 8.  Blocks walk the output in groups
// of kGroup row tiles, so the blocks in flight share weight tiles.

template <int WM_, int WN_, int MT_, int NT_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int BM = WM * MT * 16;
  static constexpr int BN = WN * NT * 8;
  static constexpr int A_ROW = BK + 8;
  static constexpr int Q_ROW = BN + 16;           // bytes
  static constexpr int A_BYTES = BM * A_ROW * 2;  // one stage of x, bf16
  static constexpr int Q_BYTES = BK * Q_ROW;      // one stage of q, int8
  static constexpr int O_ROW = BN + 4;            // the epilogue's fp32 rows
  static constexpr size_t PIPE = static_cast<size_t>(STAGES) * (A_BYTES + Q_BYTES);
  static constexpr size_t EPI = static_cast<size_t>(BM) * O_ROW * sizeof(float);
  static constexpr size_t SMEM = PIPE > EPI ? PIPE : EPI;
  static_assert(BK % 16 == 0 && NT % 2 == 0 && BN % 16 == 0, "tile shape");
};

// 128 x 128, warps of 64 x 64.  On one H100 (700 W) this beat 64 x 128,
// 128 x 256 and 256-thread blocks at M = 128-2048, and 4 stages or 32-deep
// tiles; every shape tried ran within 25% of it.
using Big = Cfg<2, 2, 4, 8, 64, 3>;

constexpr int kGroup = 8;  // row tiles a group of blocks walks together

template <class C, typename OutT>
__global__ void __launch_bounds__(C::THREADS, 2)
w8a16_tc_kernel(const bf16_raw* __restrict__ x,  // [M, K]
                const int8_t* __restrict__ q,    // [K, N]
                const float* __restrict__ s,     // [N]
                OutT* __restrict__ out,          // [M, N], fp32 or bf16
                int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_raw* sA = reinterpret_cast<bf16_raw*>(smem);
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + C::STAGES * C::A_BYTES);

  const int m_tiles = (M + C::BM - 1) / C::BM;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  const int per_group = kGroup * n_tiles;
  const int first_m = (blockIdx.x / per_group) * kGroup;
  const int rows = min(m_tiles - first_m, kGroup);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows) * C::BM;
  const int n0 = (in_group / rows) * C::BN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wn = warp % C::WN, wm = warp / C::WN;
  const int tiles = (K + C::BK - 1) / C::BK;

  auto load = [&](int tile, int stage) {
    const int k0 = tile * C::BK;
    bf16_raw* a = sA + stage * (C::A_BYTES / 2);
    constexpr int ACH = C::BK / 8;
#pragma unroll
    for (int i = tid; i < C::BM * ACH; i += C::THREADS) {
      const int r = i / ACH, c = i % ACH;
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      cp_async16(a + r * C::A_ROW + c * 8, ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    }
    int8_t* b = sQ + stage * C::Q_BYTES;
    constexpr int QCH = C::BN / 16;
#pragma unroll
    for (int i = tid; i < C::BK * QCH; i += C::THREADS) {
      const int r = i / QCH, c = i % QCH;
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < K && gn < N;
      cp_async16(b + r * C::Q_ROW + c * 16, ok ? q + static_cast<size_t>(gk) * N + gn : q, ok);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < tiles) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % C::STAGES;
    cp_async_wait<C::STAGES - 2>();
    // Tile t has landed for every thread, and every warp is done with tile
    // t - 1, whose stage the next load writes.
    __syncthreads();
    if (t + C::STAGES - 1 < tiles) load(t + C::STAGES - 1, (t + C::STAGES - 1) % C::STAGES);
    cp_async_commit();
    const bf16_raw* a = sA + stage * (C::A_BYTES / 2);
    const int8_t* b = sQ + stage * C::Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
      mma_step(acc, a, C::A_ROW, wm * C::MT * 16, b, C::Q_ROW, wn * C::NT * 8, kk * 16, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the epilogue's

  // Staged through shared memory for one coalesced store a row.
  float* red = reinterpret_cast<float*>(smem);
  stash(acc, red, C::O_ROW, wm * C::MT * 16, wn * C::NT * 8, lane);
  __syncthreads();
  constexpr int OCH = C::BN / 4;
#pragma unroll 4
  for (int i = tid; i < C::BM * OCH; i += C::THREADS) {
    const int r = i / OCH, c = (i % OCH) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    scale_store(out + static_cast<size_t>(gm) * N + gn,
                *reinterpret_cast<const float4*>(red + static_cast<size_t>(r) * C::O_ROW + c),
                s + gn);
  }
}

template <class C, typename OutT>
cudaError_t launch_tc(const void* x, const void* q, const void* s, void* out, int M, int N,
                      int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      w8a16_tc_kernel<C, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int blocks = ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  w8a16_tc_kernel<C, OutT><<<blocks, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16_raw*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

// -- fp32 activations: CUDA cores -------------------------------------------

constexpr int kSimtTile = 64;  // output rows and columns a block
constexpr int kSimtK = 16;

__global__ void __launch_bounds__(256)
w8a16_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, float* __restrict__ out, int M, int N, int K) {
  __shared__ float sA[kSimtK][kSimtTile + 4];  // x's tile, [k][row]
  __shared__ float sB[kSimtK][kSimtTile + 4];  // q's tile as fp32, [k][col]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtTile, n0 = blockIdx.x * kSimtTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtK) {
    for (int i = tid; i < kSimtTile * kSimtK; i += 256) {
      const int r = i / kSimtK, c = i % kSimtK;
      const int gm = m0 + r, gk = k0 + c;
      sA[c][r] = gm < M && gk < K ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
      const int kr = i / kSimtTile, nc = i % kSimtTile;
      const int qk = k0 + kr, qn = n0 + nc;
      sB[kr][nc] = qk < K && qn < N ? static_cast<float>(q[static_cast<size_t>(qk) * N + qn])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[kk][ty * 4 + i];
        b[i] = sB[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j] * s[gn];
    }
}

template <typename OutT>
cudaError_t launch_bf16(const void* x, const void* q, const void* s, void* out, void* ws,
                        void* counters, int M, int N, int K, int splits,
                        cudaStream_t stream) {
  if (M <= 16) return launch_skinny<Skinny<1, 4>, OutT>(x, q, s, out, ws, counters, M, N, K,
                                                        splits, stream);
  if (M <= 32) return launch_skinny<Skinny<2, 4>, OutT>(x, q, s, out, ws, counters, M, N, K,
                                                        splits, stream);
  if (M <= 64) return launch_skinny<Skinny<4, 3>, OutT>(x, q, s, out, ws, counters, M, N, K,
                                                        splits, stream);
  return launch_tc<Big, OutT>(x, q, s, out, M, N, K, stream);
}

}  // namespace

// out is fp32, or with out_bf16 (bf16 x only) the fp32 result rounded to
// bf16, for callers that cast it straight away.
extern "C" int w8a16_gemm_launch(const void* x, const void* q, const void* s, void* out,
                                 void* ws, void* counters, int M, int N, int K, int splits,
                                 int dtype, int out_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == kFloat32 && !out_bf16) {
    const dim3 grid((N + kSimtTile - 1) / kSimtTile, (M + kSimtTile - 1) / kSimtTile);
    w8a16_simt_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kBFloat16 || splits < 1 || (splits > 1 && M > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      out_bf16 ? launch_bf16<bf16_raw>(x, q, s, out, ws, counters, M, N, K, splits, stream)
               : launch_bf16<float>(x, q, s, out, ws, counters, M, N, K, splits, stream));
}
