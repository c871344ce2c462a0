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
// byte a value (llama-3.1-8b's projections at M = 8: 5 us for q_proj, 17.7
// us for gate_proj, 158 us for the lm_head at 3.35 TB/s); from a few
// hundred rows the tensor cores (2 M N K operations at 989 TFLOP/s bf16).
//
// What the design does about it: one body for bf16 x at every M, on
// Hopper's wgmma with the operands swapped.  It computes out^T, so the int8
// weight is wgmma's A operand, taken from registers after an exact convert
// (s8x4_to_bf16), and x's rows are the B operand, read from shared memory
// as they lie (wgmma's N, any multiple of 8 up to 256, fits M: 8 rows run
// as 32, 520 as 3 x 176).  A producer warp keeps a TMA ring of x's and q's
// tiles full (128-byte swizzle, mbarriers); two consumer warpgroups of 64
// features each convert step t + 1 while step t runs on the tensor cores,
// so int8 is all that crosses HBM for the weight and the convert hides
// behind the MMAs.  Where the (row, feature) tiles are fewer than the SMs
// (q/o, k/v and down at decode rows, k/v at a mixed iteration) the call
// may split over K, a tile's splits one thread-block cluster that adds
// its partials through distributed shared memory in split order, so the
// result does not depend on the order blocks ran in.  The row tile and
// split come from wide_plan in the wrapper: the fewest row tiles, and for
// a call of fewer tiles than SMs the most splits whose clusters the card
// holds in one wave.  The weight is read in place: no repacked or
// transposed copy.
//
// - fp32 activations (the fp32 reference models) take a CUDA-core body.
// - Nothing is allocated, synchronised or read back: the kernel runs
//   inside captured CUDA graphs.  Ragged M, N and K edges are zero-filled
//   by TMA (K a multiple of 8 and N of 16, 16-byte aligned bases, which
//   the wrapper checks).
#include <atomic>

#include "hopper.cuh"

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

// -- bf16 activations: wgmma from a TMA ring --------------------------------
//
// The product is taken transposed, out^T[n, m] = sum_k q[k, n] x[m, k], so
// that the int8 weight is wgmma's A operand, converted to bf16 in
// registers, and x's rows are its B operand (wgmma's N = the block's BT
// rows, read from shared memory as they lie in x: K-major).  A block owns
// kWideBN = 128 output features (two consumer warpgroups of 64) by BT rows
// (a multiple of 16 from 32 to 256, chosen by wide_plan in the wrapper) over one
// range of K (its split).  Warpgroup 0 is the producer: one thread keeps a
// ring of STAGES stages full, each x's [BT x 64] bf16 tile and q's [64 x
// 128] int8 tile, both by TMA under the 128-byte swizzle, with a full and
// an empty mbarrier a stage.  A consumer warp reads its 16 features' int8
// bytes with ldmatrix.trans as if their byte pairs were b16 (the swizzle's
// XOR in the row address): lane (g, c) receives q[k + 2c][n + 2g],
// q[k + 2c][n + 2g + 1], q[k + 2c + 1][n + 2g] and q[k + 2c + 1][n + 2g +
// 1], so s8x4_to_bf16 splits them into the k-pair (2c, 2c + 1) of feature
// n + 2g and that of n + 2g + 1: the A fragment of 16 rows whose even
// features lie on rows 0-7 and odd ones on rows 8-15.  The
// accumulator rows g and g + 8 are then features n + 2g and n + 2g + 1,
// side by side in the output.  The convert of one 16-deep step is issued
// while the step before runs on the tensor cores (wgmma.wait_group 1).
// The epilogue stages the fp32 tile in shared memory (rows = x's rows) for
// coalesced 16-byte stores, times the scale.  A call split over K runs each
// tile's splits as one thread-block cluster: each block stages its partial
// sums, and after a cluster barrier block j adds every block's sums for
// the j-th share of the rows, in split order, read through distributed
// shared memory.  The result is the same whatever order blocks ran in, and
// no partial crosses L2 (partials in global memory, added by the last split
// to arrive, cost about twice as much a call on an H100).

constexpr int kWideBN = 128;           // output features a block
constexpr int kWideBK = 64;            // K a stage: x's rows are 128 bytes, the swizzle's span
constexpr int kWideThreads = 384;      // a producer warpgroup and two consumer warpgroups
constexpr int kWideRing = 200 * 1024;  // shared memory the ring may take
constexpr int kGroup = 8;              // row tiles a group of blocks walks together
constexpr int kWideMaxSplits = 8;      // a cluster's portable size; WIDE_MAX_SPLITS

// BT_ rows a block; the ring as many stages as kWideRing holds, at most 6
// (on an H100 3 stages ran slower, 4 as fast).
template <int BT_>
struct Wide {
  static constexpr int BT = BT_;
  static constexpr int X_BYTES = BT * kWideBK * 2;  // x's tile, bf16
  static constexpr int Q_BYTES = kWideBK * kWideBN;  // q's tile, int8
  static constexpr int STAGE = X_BYTES + Q_BYTES;
  static constexpr int STAGES = kWideRing / STAGE < 6 ? kWideRing / STAGE : 6;
  static constexpr int O_ROW = kWideBN + 4;  // the staged tile's fp32 rows
  static constexpr size_t RING = static_cast<size_t>(STAGES) * STAGE;
  static constexpr size_t EPI = static_cast<size_t>(BT) * O_ROW * sizeof(float);
  // The ring starts on a 1024-byte boundary (the swizzle's period): slack.
  static constexpr size_t SMEM = (RING > EPI ? RING : EPI) + 1024;
  static_assert(BT % 16 == 0 && BT >= 32 && BT <= 256, "rows a block: WgmmaRS's widths");
  static_assert(X_BYTES % 1024 == 0, "q's tile on a 1024-byte boundary");
  static_assert(SMEM <= 227 * 1024, "shared memory a block");
};

// Four fp32 sums times their features' scales, stored as 16 bytes (fp32 x 4)
// or, for a bf16 output, 8 sums as 16 bytes.
__device__ __forceinline__ void scale_store16(float* out, const float* v, const float* s) {
  scale_store(out, *reinterpret_cast<const float4*>(v), s);
}
__device__ __forceinline__ void scale_store16(bf16_raw* out, const float* v, const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  const float4 b = *reinterpret_cast<const float4*>(v + 4);
  const float4 sa = *reinterpret_cast<const float4*>(s);
  const float4 sb = *reinterpret_cast<const float4*>(s + 4);
  *reinterpret_cast<uint4*>(out) =
      make_uint4(pack_bf16x2(a.x * sa.x, a.y * sa.y), pack_bf16x2(a.z * sa.z, a.w * sa.w),
                 pack_bf16x2(b.x * sb.x, b.y * sb.y), pack_bf16x2(b.z * sb.z, b.w * sb.w));
}

// The staged tile st [rows][O_ROW] (fp32 sums) times the scale into out's
// rows m0 .. m0 + rows, features n0 .. n0 + kWideBN (those below N), by the
// 256 consumer threads.
template <typename OutT, int O_ROW>
__device__ __forceinline__ void store_tile(const float* st, const float* s, OutT* out, int m0,
                                           int rows, int n0, int N, int ctid) {
  constexpr int E = 16 / sizeof(OutT);  // values a 16-byte store
  constexpr int CH = kWideBN / E;
  for (int i = ctid; i < rows * CH; i += 256) {
    const int r = i / CH, c = (i % CH) * E;
    const int gn = n0 + c;
    if (gn >= N) continue;
    scale_store16(out + static_cast<size_t>(m0 + r) * N + gn, st + r * O_ROW + c, s + gn);
  }
}

// SPLIT: the call is split over K, each tile's splits one cluster.  Only
// split calls run the body with the cluster epilogue: on an H100 the same
// body with it compiled in ran unsplit calls of many waves 18-26% slower
// (M = 2048 gate/up 399 us against 338, M = 16384 q/o 979 against 779;
// w8a16_ab.py cases).
template <int BT, bool SPLIT>
__global__ void __launch_bounds__(kWideThreads, 1)
w8a16_wide_kernel(const __grid_constant__ CUtensorMap tx,  // x [M, K] bf16, boxes BT x 64
                  const __grid_constant__ CUtensorMap tq,  // q [K, N] int8, boxes 64 x 128
                  const float* __restrict__ s,             // [N]
                  void* __restrict__ out,                  // [M, N], fp32 or (out_bf16) bf16
                  int M, int N, int K, int splits, int out_bf16) {
  using C = Wide<BT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int m_tiles = (M + BT - 1) / BT, n_tiles = (N + kWideBN - 1) / kWideBN;
  // A tile's splits are one cluster: consecutive blocks, the split its rank.
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  // Blocks walk the output in groups of kGroup row tiles, row tile fastest,
  // so the blocks in flight share each weight tile through L2.
  const int per_group = kGroup * n_tiles;
  const int first_m = (tile / per_group) * kGroup;
  const int group_rows = min(m_tiles - first_m, kGroup);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % group_rows) * BT;
  const int n0 = (in_group / group_rows) * kWideBN;
  const int k_tiles = (K + kWideBK - 1) / kWideBK;
  const int per_split = (k_tiles + splits - 1) / splits;
  const int kt0 = split * per_split;
  const int n_k = min(k_tiles, kt0 + per_split) - kt0;  // >= 1: the launcher checks

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);   // the producer's arrival, then the bytes
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int i = 0; i < n_k; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);  // the first round passes at once
        unsigned char* dst = ring + stage * C::STAGE;
        const int k0 = (kt0 + i) * kWideBK;
        mbar_expect_tx(&full[stage], C::STAGE);
        tma_load_2d(dst, &tx, &full[stage], k0, m0);
        tma_load_2d(dst + C::X_BYTES, &tq, &full[stage], n0, k0);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, cw = ctid / 128, warp = (ctid / 32) % 4, lane = tid % 32;
  // This lane's ldmatrix row: k row `lane` of a 32-deep pair of steps (lanes
  // 8i .. 8i + 7 address matrix i: k rows 8i .. 8i + 7), at the 16-byte
  // chunk of the warp's 16 features, XORed with the row's swizzle phase.
  const int a_off = lane * kWideBN + (((cw * 4 + warp) ^ (lane % 8)) << 4);

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);
  unsigned frag[2][4];  // the A fragments of two 16-deep steps in flight
  int stage = 0, prev = 0;
  unsigned phase = 0;
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(&full[stage], phase);
    const unsigned char* xt = ring + stage * C::STAGE;
    const uint64_t desc = sw128_desc(xt);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned r[4];
      ldmatrix_x4_trans(r, reinterpret_cast<const bf16_raw*>(xt + C::X_BYTES + p * 32 * kWideBN +
                                                             a_off));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // Step 2p + h: its fragment's registers were last read by step
        // 2p + h - 2, done once at most one group (step 2p + h - 1) is in
        // flight.
        wgmma_wait<1>();
        if (p == 0 && h == 1 && i > 0 && lane == 0) {
          mbar_arrive(&empty[prev]);  // the previous stage's last step is done
        }
        s8x4_to_bf16(r[2 * h], frag[h][0], frag[h][1]);
        s8x4_to_bf16(r[2 * h + 1], frag[h][2], frag[h][3]);
        fence_operands(frag[h]);
        wgmma_fence();
        WgmmaRS<BT>::mma(acc, frag[h], desc + 2 * (2 * p + h));
        wgmma_commit();
      }
    }
    prev = stage;
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Both warpgroups are done with the ring before it holds the staged tile.
  named_bar_sync(1, 256);
  float* st = reinterpret_cast<float*>(ring);
  const int f = cw * 64 + warp * 16 + 2 * (lane / 4);  // accumulator rows g, g + 8
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int r = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(st + r * C::O_ROW + f) = make_float2(acc[4 * j], acc[4 * j + 2]);
    *reinterpret_cast<float2*>(st + (r + 1) * C::O_ROW + f) =
        make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }
  const int rows = min(BT, M - m0);
  if constexpr (!SPLIT) {
    named_bar_sync(1, 256);
    if (out_bf16) {
      store_tile<bf16_raw, C::O_ROW>(st, s, static_cast<bf16_raw*>(out), m0, rows, n0, N, ctid);
    } else {
      store_tile<float, C::O_ROW>(st, s, static_cast<float*>(out), m0, rows, n0, N, ctid);
    }
    return;
  }
  // Every split of the tile has staged its sums in its own block's shared
  // memory; block `split` adds all of them, in split order, for its share
  // of the rows, reading the others' through the cluster.
  cluster_sync();
  constexpr int OCH = kWideBN / 4;
  const int per = (rows + splits - 1) / splits;
  const int r_begin = split * per, r_end = min(rows, r_begin + per);
  for (int i = r_begin * OCH + ctid; i < r_end * OCH; i += 256) {
    const int r = i / OCH, c = (i % OCH) * 4;
    const int gn = n0 + c;
    if (gn >= N) continue;
    const float* mine = st + r * C::O_ROW + c;
    float4 part[kWideMaxSplits];
#pragma unroll
    for (int j = 0; j < kWideMaxSplits; ++j)
      if (j < splits) part[j] = ld_cluster_f4(cluster_addr(mine, j));
    float4 v = part[0];
#pragma unroll
    for (int j = 1; j < kWideMaxSplits; ++j)
      if (j < splits) v = add4(v, part[j]);
    const size_t o = static_cast<size_t>(m0 + r) * N + gn;
    if (out_bf16) {
      scale_store(static_cast<bf16_raw*>(out) + o, v, s + gn);
    } else {
      scale_store(static_cast<float*>(out) + o, v, s + gn);
    }
  }
  cluster_sync();  // no block leaves while another still reads its tile
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `elem`-byte values, read in boxes of
// box_rows x box_cols under the 128-byte swizzle, zeros past its edges.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows, int cols,
               int elem, int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch of `blocks` blocks, as clusters of `splits` when split (a launch
// with a cluster attribute, even of 1, places blocks another way: unsplit
// calls of many waves ran up to 26% slower with it on an H100).
template <int BT>
cudaLaunchConfig_t wide_config(int blocks, int splits, cudaLaunchAttribute* cluster,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = Wide<BT>::SMEM;
  cfg.stream = stream;
  if (splits > 1) {
    cluster->id = cudaLaunchAttributeClusterDimension;
    cluster->val.clusterDim.x = splits;
    cluster->val.clusterDim.y = 1;
    cluster->val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once a device: `done` holds a bit for each device already set.
cudaError_t allow_smem(const void* kernel, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The descriptors are encoded at every call and passed by value, so a
// captured graph keeps its own copies.
template <int BT>
cudaError_t launch_wide(const void* x, const void* q, const void* s, void* out, int M, int N,
                        int K, int splits, int out_bf16, cudaStream_t stream) {
  using C = Wide<BT>;
  static std::atomic<unsigned> smem_set[2];  // unsplit, split
  const int k_tiles = (K + kWideBK - 1) / kWideBK;
  const int per_split = (k_tiles + splits - 1) / splits;
  if (splits > kWideMaxSplits || (splits - 1) * per_split >= k_tiles)
    return cudaErrorInvalidValue;  // too many splits, or an empty one
  CUtensorMap tx, tq;
  if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, BT, kWideBK) ||
      !encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, 1, kWideBK, kWideBN))
    return cudaErrorInvalidValue;
  const void* kernel =
      splits > 1 ? reinterpret_cast<const void*>(w8a16_wide_kernel<BT, true>)
                 : reinterpret_cast<const void*>(w8a16_wide_kernel<BT, false>);
  cudaError_t err = allow_smem(kernel, C::SMEM, smem_set[splits > 1]);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg = wide_config<BT>(
      ((M + BT - 1) / BT) * ((N + kWideBN - 1) / kWideBN) * splits, splits, &cluster, stream);
  const float* sp = static_cast<const float*>(s);
  void* args[] = {&tx, &tq, &sp, &out, &M, &N, &K, &splits, &out_bf16};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_wide_rows(int rows, const void* x, const void* q, const void* s, void* out,
                             int M, int N, int K, int splits, int out_bf16,
                             cudaStream_t stream) {
  switch (rows) {
#define W8A16_WIDE(BT) \
  case BT:             \
    return launch_wide<BT>(x, q, s, out, M, N, K, splits, out_bf16, stream);
    W8A16_WIDE(32)
    W8A16_WIDE(48)
    W8A16_WIDE(64)
    W8A16_WIDE(80)
    W8A16_WIDE(96)
    W8A16_WIDE(112)
    W8A16_WIDE(128)
    W8A16_WIDE(144)
    W8A16_WIDE(160)
    W8A16_WIDE(176)
    W8A16_WIDE(192)
    W8A16_WIDE(208)
    W8A16_WIDE(224)
    W8A16_WIDE(240)
    W8A16_WIDE(256)
#undef W8A16_WIDE
    default:
      return cudaErrorInvalidValue;
  }
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

}  // namespace

// Resolves the driver's tensor-map encoder once, outside any graph capture;
// 0 when it is there.
extern "C" int w8a16_gemm_prepare() {
  return encode_tiled() == nullptr ? static_cast<int>(cudaErrorNotSupported) : 0;
}

// How many clusters of `splits` blocks of the wgmma body the card holds at
// once, into *clusters (splits 1: blocks).  Every row-tile width runs one
// block an SM (384 threads at up to 168 registers), so the widest stands
// for all.  A cluster's blocks share one GPC, so on an H100 (132 SMs in
// GPCs of 14-18) this is below 132 / splits for most sizes.
extern "C" int w8a16_gemm_cluster_capacity(int splits, int* clusters) {
  const void* kernel = reinterpret_cast<const void*>(w8a16_wide_kernel<256, true>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Wide<256>::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg = wide_config<256>(splits, splits, &cluster, nullptr);
  // The query counts clusters only with the attribute given, 1 included.
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// out is fp32, or with out_bf16 (bf16 x only) the fp32 result rounded to
// bf16, for callers that cast it straight away.  bf16 x runs the wgmma
// body at `rows` rows a block (a multiple of 16 in 32 .. 256) and `splits`
// over K (1 .. 8); fp32 x the CUDA-core body.
extern "C" int w8a16_gemm_launch(const void* x, const void* q, const void* s, void* out, int M,
                                 int N, int K, int splits, int rows, int dtype, int out_bf16,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == kFloat32 && !out_bf16) {
    const dim3 grid((N + kSimtTile - 1) / kSimtTile, (M + kSimtTile - 1) / kSimtTile);
    w8a16_simt_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kBFloat16 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_wide_rows(rows, x, q, s, out, M, N, K, splits, out_bf16, stream));
}
