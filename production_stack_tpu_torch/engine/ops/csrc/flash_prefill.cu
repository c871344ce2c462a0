// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_attention` (body
// `_flash_prefill_kernel`) in production_stack_tpu/engine/ops/pallas/flash_prefill.py:
// causal attention for T new queries at positions cached_len + t over the
// keys [prefix C || new T].  Prefix slot j is valid while j < cached_len,
// at position j; new key j is valid while j < valid_len, at position
// cached_len + j.  Masks are applied in the order validity, causality,
// sliding window (keep key_pos > q_pos - window).  The online softmax and
// the accumulator run in fp32; a row with no valid key gives zeros.
//
// What bounds it on an H100: operations.  A 2048-token chunk does
// ~4 * T^2/2 * D * H multiply-adds against ~(T + C) * K * D * 4 bytes of
// K and V, hundreds of operations per byte, above the ~295 a byte at which
// the bf16 tensor cores and not the memory set the pace.
//
// What the design does about it.  Both versions share the grid and the
// walk: grid (query tile, KV head); a tile is rows of the GQA-regrouped
// axis r = t * G + g, so every K/V tile a block loads serves all G query
// heads of its KV head; one block walks its KV tiles in a loop, the live
// prefix [0, cached_len) first, then the new keys up to the tile's causal
// frontier (and from the sliding window's lower edge), never loading a
// tile past the frontier; ragged T is masked in the kernel; any T and any
// D in {64, 128, 256} is taken.
//
// bf16 (the main path), on the tensor cores:
//  * Both products are mma.sync.m16n8k16 (bf16 in, fp32 accumulators),
//    FA2's shape: 4 warps, each owning 16 of the block's 64 rows.
//    S = Q . K^T reads Q and K from shared memory with ldmatrix (K's
//    [keys][D] rows are already the column-major B operand); P stays in
//    registers, rounded to bf16, as the A operand of O += P . V; V is read
//    with ldmatrix.trans.  mma.sync rather than wgmma: it needs no
//    shared-memory descriptors or swizzled layouts, and rows padded by 16
//    bytes keep ldmatrix free of bank conflicts.
//  * K/V tiles of 64 keys come in by cp.async (16 bytes a thread) into a
//    ring of 2 stages in shared memory, bf16 as stored: the next tile's
//    load is in flight while the current one is computed.  Two barriers a
//    tile.  87 KB of shared memory at D = 128, so two blocks share an SM.
//  * The scale is applied to S in fp32, folded with log2(e) into exp2f.
//  * The causal frontier makes late query tiles long: blocks take tiles in
//    reverse order so the longest start first.  A warp whose rows all sit
//    before a KV tile's first key skips that tile's products.
//
// fp32 (the card's model reference runs the model in fp32 and holds the
// logits within 2e-3; TF32 tensor cores keep ~3 digits and would break
// it): the first version of this kernel, fp32 FMAs on the CUDA cores over
// fp32 tiles in shared memory (4 rows x 4 keys per thread for Q.K^T, 4
// rows x D/16 columns for P.V), Q and K stored transposed so each thread
// reads float4 runs.
//
// Where the prefix comes from is a template parameter of both bodies (the
// prefix loader), with three entry points:
//  * flash_prefill_launch: the prefix gathered contiguous, [C, K, D], and
//    both lengths host ints;
//  * flash_prefill_paged_launch: the prefix read straight from the paged
//    KV pool through a block-table row (prefix key j lives at
//    cache[table[j / bs]][j % bs]), dense in q's dtype or int8 with fp32
//    scales, and both lengths read from device memory when the kernel
//    starts, so a CUDA graph replays it at any cursor.  The walk covers
//    min(cached_len, P * bs) prefix keys and never the table's padding;
//    the live part of the table row is staged in shared memory when the
//    kernel starts (where it fits beside the tiles), so a tile's copies
//    start without waiting on a table read from device memory.
//    An int8 tile comes in by cp.async as its bytes and its scales into a
//    staging area, then each value is converted in shared memory: int8 x
//    scale in fp32, rounded once to bf16 (nearest even) for the tensor
//    cores, as kv_quant.dequantize(..., dtype=bf16) rounds it; the fp32
//    body takes the fp32 product and does not round.  This replaces the
//    eager gather (and, on int8 caches, dequantization) of the prefix
//    before every prefill and mixed step;
//  * flash_prefill_batched_launch: no prefix and B independent rows of T
//    tokens, grid (query tile, KV head, b) (the encode lane, which the JAX
//    package runs as a vmap of the single-text kernel with C = 0).  Each
//    block reads valid_lens[b] from device memory when it starts; only
//    query rows t < valid_lens[b] are computed, the others are written as
//    zeros, a query tile wholly past valid_lens[b] loads no K/V, and the
//    walk never loads a key at or past it, so a batch of ragged texts
//    costs the valid causal work, not B padded passes.
#include "common.cuh"

namespace {

// Dynamic shared memory a block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

// -- prefix loaders: where prefix key j of KV head kh lives ------------------

// Contiguous [C, K, D] in q's dtype.
struct PrefixContig {
  static constexpr bool kInt8 = false;
  static constexpr bool kPaged = false;
  static constexpr bool kBatched = false;
  const void* k;
  const void* v;
  __device__ __forceinline__ size_t vec(int j, int K, int kh) const {
    return static_cast<size_t>(j) * K + kh;
  }
};

// Block-table addressing: key j sits in block table[j >> shift] at row
// j & (bs - 1) (bs = 1 << shift).  `table` is a generic pointer: the row in
// device memory, or its copy in shared memory (stage_table).
struct PagedRows {
  static constexpr bool kPaged = true;
  static constexpr bool kBatched = false;
  const int* table;
  int shift;
  __device__ __forceinline__ size_t vec(int j, int K, int kh) const {
    const size_t row = (static_cast<size_t>(table[j >> shift]) << shift) +
                       (j & ((1 << shift) - 1));
    return row * K + kh;
  }
};

// The paged pool [N, bs, K, D] in q's dtype.
struct PrefixPaged : PagedRows {
  static constexpr bool kInt8 = false;
  const void* k;
  const void* v;
};

// The int8 paged pool: data [N, bs, K, D], fp32 scales [N, bs, K].
struct PrefixPagedInt8 : PagedRows {
  static constexpr bool kInt8 = true;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
};

// No prefix, B rows (the batched entry): row b = blockIdx.z has its own
// [T, H, D] slices of q and out, [T, K, D] slices of k and v, and
// valid_len; pre_cap is 0, so vec() is never called.
struct PrefixNoneBatched {
  static constexpr bool kInt8 = false;
  static constexpr bool kPaged = false;
  static constexpr bool kBatched = true;
  const void* k = nullptr;
  const void* v = nullptr;
  __device__ __forceinline__ size_t vec(int, int, int) const { return 0; }
};

// The element offset of this block's row in a [B, T, width] tensor: row
// blockIdx.z for the batched entry, 0 for the single-row entries.
template <class Pre>
__device__ __forceinline__ size_t row_base(int Tn, int width) {
  if constexpr (Pre::kBatched) {
    return static_cast<size_t>(blockIdx.z) * Tn * width;
  } else {
    return 0;
  }
}

// Query tokens of the tile [t0, t0 + ntok) that are computed: all of them,
// except in the batched entry, which computes only t < valid and writes
// zeros for the rest.
template <class Pre>
__device__ __forceinline__ int live_tokens(int t0, int ntok, int valid) {
  if constexpr (Pre::kBatched) {
    return max(0, min(ntok, valid - t0));
  } else {
    return ntok;
  }
}

// Copy the table entries the walk reads (the blocks of the first n_pre
// keys) into shared memory at s_table, then point the loader at the copy;
// s_table == nullptr (the row does not fit) leaves the loader reading
// device memory.  Called by every thread of the block.
template <class Pre>
__device__ __forceinline__ void stage_table(Pre& pre, int* s_table, int n_pre) {
  if constexpr (Pre::kPaged) {
    if (s_table != nullptr) {
      const int nb = (n_pre + (1 << pre.shift) - 1) >> pre.shift;
      for (int i = threadIdx.x; i < nb; i += blockDim.x) s_table[i] = pre.table[i];
      pre.table = s_table;
      __syncthreads();
    }
  }
}

// N consecutive values (columns d..d+N-1) of prefix key j as floats: the
// stored values, or an int8 side's values times their scale in fp32.
template <typename T, int D, int N, class Pre>
__device__ __forceinline__ void load_prefix(const Pre& pre, bool v_side, int j, int K,
                                            int kh, int d, float* f) {
  const size_t vi = pre.vec(j, K, kh);
  if constexpr (Pre::kInt8) {
    load_s8<N>((v_side ? pre.v : pre.k) + vi * D + d, f);
    const float s = (v_side ? pre.v_scale : pre.k_scale)[vi];
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] *= s;
  } else {
    load_cols<T, N>(static_cast<const T*>(v_side ? pre.v : pre.k) + vi * D + d, f);
  }
}

// The kernel's lengths: the host ints, or the device int32 values where the
// pointers are given.  valid_len is clamped to [0, T].
__device__ __forceinline__ void read_lengths(const int* cached_dev, const int* valid_dev,
                                             int Tn, int& cached, int& valid) {
  if (cached_dev != nullptr) cached = max(0, *cached_dev);
  if (valid_dev != nullptr) valid = *valid_dev;
  valid = min(max(valid, 0), Tn);
}

// -- fp32: fp32 FMAs on the CUDA cores --------------------------------------
namespace simt {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // query rows (t, g) per block
constexpr int kKeys = 64;      // keys per KV tile

template <int D>
constexpr size_t smem_bytes() {
  // sQt [D][kRows] + sKt [D][kKeys] + sV [kKeys][D] + sPt [kKeys][kRows]
  return sizeof(float) *
         (static_cast<size_t>(D) * kRows + static_cast<size_t>(D) * kKeys +
          static_cast<size_t>(kKeys) * D + static_cast<size_t>(kKeys) * kRows);
}

template <typename T, int D, class Pre>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q,      // [T, H, D]
                     const T* __restrict__ k_new,  // [T, K, D]
                     const T* __restrict__ v_new,
                     Pre pre,  // the prefix, pre_cap keys at most
                     T* __restrict__ out,  // [T, H, D]
                     int Tn, int H, int K, int G, int tok_per_tile,
                     int cached, int valid, const int* cached_dev,
                     const int* valid_dev, int pre_cap, int staged, float scale,
                     int window) {
  constexpr int V = Vec<T>::N;
  constexpr int NV = D / V;
  constexpr int CG = D / 64;  // float4 column groups per thread in P.V

  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                // [D][kRows], pre-scaled
  float* sKt = sQt + D * kRows;     // [D][kKeys]
  float* sV = sKt + D * kKeys;      // [kKeys][D]
  float* sPt = sV + kKeys * D;      // [kKeys][kRows]

  q += row_base<Pre>(Tn, H * D);
  out += row_base<Pre>(Tn, H * D);
  k_new += row_base<Pre>(Tn, K * D);
  v_new += row_base<Pre>(Tn, K * D);
  if (Pre::kBatched) valid_dev += blockIdx.z;
  read_lengths(cached_dev, valid_dev, Tn, cached, valid);
  const int n_pre = min(cached, pre_cap);  // prefix keys to walk
  stage_table(pre, staged ? reinterpret_cast<int*>(sPt + kKeys * kRows) : nullptr, n_pre);
  const int kh = blockIdx.y;
  const int t0 = blockIdx.x * tok_per_tile;
  const int ntok = min(tok_per_tile, Tn - t0);
  const int ltok = live_tokens<Pre>(t0, ntok, valid);
  const int rows = ltok * G;  // live rows in this tile (computed)
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // Q tile, transposed: sQt[d][r], r = t_local * G + g.
  for (int i = tid; i < kRows * NV; i += kThreads) {
    const int r = i % kRows, dv = i / kRows;
    float f[V];
    if (r < rows) {
      const int t = t0 + r / G, h = kh * G + r % G;
      load_vec(q + (static_cast<size_t>(t) * H + h) * D + dv * V, f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) sQt[(dv * V + e) * kRows + r] = f[e] * scale;
  }

  float m[4], l[4], acc[4][CG * 4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    const int r = ty * 4 + i;
    qpos[i] = r < rows ? cached + t0 + r / G : -1;  // -1: padding row
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this tile can see.  New keys stop at the tile's last
  // live query (causal frontier) and at valid_len; with a window, keys
  // below the first query's window edge are invisible to every row.
  const int t_last = t0 + ltok - 1;
  const int new_count = ltok > 0 ? min(valid, t_last + 1) : 0;
  const int lo_pos = window >= 0 ? cached + t0 - window + 1 : 0;

  for (int seg = 0; seg < 2; ++seg) {
    const int count = seg == 0 ? n_pre : new_count;
    const int pos_base = seg == 0 ? 0 : cached;
    const int start = max(0, lo_pos - pos_base);
    for (int j0 = start; j0 < count; j0 += kKeys) {
      __syncthreads();  // previous tile's sKt / sV / sPt fully consumed
      for (int i = tid; i < kKeys * NV; i += kThreads) {
        // K transposed: consecutive threads take consecutive keys.
        const int j = i % kKeys, dv = i / kKeys;
        float f[V];
        if (j0 + j < count && seg == 0) {
          load_prefix<T, D, V>(pre, false, j0 + j, K, kh, dv * V, f);
        } else if (j0 + j < count) {
          load_vec(k_new + (static_cast<size_t>(j0 + j) * K + kh) * D + dv * V, f);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) sKt[(dv * V + e) * kKeys + j] = f[e];
      }
      for (int i = tid; i < kKeys * NV; i += kThreads) {
        // V row-major: consecutive threads take consecutive vectors.
        const int j = i / NV, dv = i % NV;
        float f[V];
        if (j0 + j < count && seg == 0) {
          load_prefix<T, D, V>(pre, true, j0 + j, K, kh, dv * V, f);
        } else if (j0 + j < count) {
          load_vec(v_new + (static_cast<size_t>(j0 + j) * K + kh) * D + dv * V, f);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) sV[j * D + dv * V + e] = f[e];
      }
      __syncthreads();

      // S = Q . K^T on a 4 x 4 micro-tile: rows ty*4.., keys tx*4...
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(sQt + d * kRows + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(sKt + d * kKeys + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
      }

      // Mask (validity, causality, window) and the online softmax.  A row's
      // 64 scores sit on the 16 lanes that share ty (one half-warp).
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = j0 + tx * 4 + j;
          const int kpos = pos_base + jj;
          bool ok = qpos[i] >= 0 && jj < count && kpos <= qpos[i];
          if (window >= 0) ok = ok && kpos > qpos[i] - window;
          if (!ok) sc[i][j] = -INFINITY;
          mt = fmaxf(mt, sc[i][j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[i], mt);
        const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
          sum += p[i][j];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CG * 4; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(sPt + (tx * 4 + j) * kRows + ty * 4) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      __syncthreads();

      // O += P . V: rows ty*4.., columns cg*64 + tx*4...
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(sPt + j * kRows + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 b = *reinterpret_cast<const float4*>(sV + j * D + cg * 64 + tx * 4);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][cg * 4 + e] = fmaf(av[i], bv[e], acc[i][cg * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= ntok * G) continue;
    const bool live = r < rows;  // else a batched row's padding: zeros
    const int t = t0 + r / G, h = kh * G + r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + (static_cast<size_t>(t) * H + h) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[cg * 64 + tx * 4 + e] = from_float<T>(live ? acc[i][cg * 4 + e] * inv : 0.f);
  }
}

template <typename T, int D, class Pre>
cudaError_t launch_dim(const void* q, const void* kn, const void* vn, const Pre& pre,
                       void* out, int B, int Tn, int H, int K, int cached, int valid,
                       const int* cached_dev, const int* valid_dev, int pre_cap,
                       int table_len, float scale, int window, cudaStream_t stream) {
  const int G = H / K;
  const int tok_per_tile = kRows / G;
  const dim3 grid((Tn + tok_per_tile - 1) / tok_per_tile, K, B);
  const size_t table_bytes = sizeof(int) * static_cast<size_t>(table_len);
  const int staged = Pre::kPaged && smem_bytes<D>() + table_bytes <= kMaxSmem;
  const size_t smem = smem_bytes<D>() + (staged ? table_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D, Pre>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_prefill_kernel<T, D, Pre><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), pre, static_cast<T*>(out), Tn, H, K, G,
      tok_per_tile, cached, valid, cached_dev, valid_dev, pre_cap, staged, scale,
      window);
  return cudaGetLastError();
}

}  // namespace simt

// -- bf16: mma.sync on the tensor cores --------------------------------------
namespace tc {

constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kStages = 2;  // K/V tiles in the shared-memory ring

template <int D>
struct Shape {
  // 4 warps of 16 rows: 64 rows a block, two blocks an SM at D <= 128.
  // (On one H100 at 700 W this beat 4 or 8 warps of 32 rows and 8 warps
  // of 16 at T = 2048 and at a 512-token chunk over a prefix: more
  // blocks in flight mattered more than reading each K/V fragment for
  // two m-tiles.)
  static constexpr int THREADS = 128;
  static constexpr int ROWS = 64;  // query rows (t, g) per block
  // A row padded by 16 bytes: the 8 rows one ldmatrix reads at one column
  // fall in 8 different bank groups.
  static constexpr int ROW = D + 8;
  static constexpr int CH = D / 8;  // 16-byte chunks in a row
  static constexpr int Q_ELEMS = ROWS * ROW;
  static constexpr int KV_ELEMS = kKeys * ROW;
  static constexpr size_t SMEM =
      sizeof(bf16_raw) * (static_cast<size_t>(Q_ELEMS) + 2 * kStages * KV_ELEMS);
  // An int8 prefix adds one staging tile a side, its bytes and its scales.
  static constexpr size_t STAGE8 = static_cast<size_t>(kKeys) * (D + sizeof(float));
  static constexpr size_t SMEM_INT8 = SMEM + 2 * STAGE8;
};

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

template <int D, class Pre>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_prefill_bf16_kernel(const bf16_raw* __restrict__ q,      // [T, H, D]
                          const bf16_raw* __restrict__ k_new,  // [T, K, D]
                          const bf16_raw* __restrict__ v_new,
                          Pre pre,  // the prefix, pre_cap keys at most
                          bf16_raw* __restrict__ out,  // [T, H, D]
                          int Tn, int H, int K, int G, int tok_per_tile,
                          int cached, int valid, const int* cached_dev,
                          const int* valid_dev, int pre_cap, int staged,
                          float scale_log2, int window) {
  using Sh = Shape<D>;
  constexpr int ROW = Sh::ROW;
  constexpr int CH = Sh::CH;
  constexpr int THREADS = Sh::THREADS;
  constexpr int NT = kKeys / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;      // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_raw* sQ = reinterpret_cast<bf16_raw*>(smem_raw);  // [ROWS][ROW]
  bf16_raw* sK = sQ + Sh::Q_ELEMS;                       // [kStages][kKeys][ROW]
  bf16_raw* sV = sK + kStages * Sh::KV_ELEMS;
  // An int8 prefix tile's staging: bytes [kKeys][D] a side, then scales.
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + kStages * Sh::KV_ELEMS);
  int8_t* sV8 = sK8 + kKeys * D;
  float* sKs = reinterpret_cast<float*>(sV8 + kKeys * D);
  float* sVs = sKs + kKeys;

  q += row_base<Pre>(Tn, H * D);
  out += row_base<Pre>(Tn, H * D);
  k_new += row_base<Pre>(Tn, K * D);
  v_new += row_base<Pre>(Tn, K * D);
  if (Pre::kBatched) valid_dev += blockIdx.z;
  read_lengths(cached_dev, valid_dev, Tn, cached, valid);
  const int n_pre = min(cached, pre_cap);  // prefix keys to walk
  // The staged table follows the tiles (and the int8 staging area).
  unsigned char* after = Pre::kInt8 ? reinterpret_cast<unsigned char*>(sVs + kKeys)
                                    : reinterpret_cast<unsigned char*>(sK8);
  stage_table(pre, staged ? reinterpret_cast<int*>(after) : nullptr, n_pre);
  const int kh = blockIdx.y;
  // Reversed: the latest query tiles see the most keys and start first.
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tok_per_tile;
  const int ntok = min(tok_per_tile, Tn - t0);
  const int ltok = live_tokens<Pre>(t0, ntok, valid);
  const int rows = ltok * G;  // live rows in this tile (computed)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_row0 = warp * 16;  // the warp's rows: warp_row0 .. + 15

  // Q tile: row r = t_local * G + g; padding rows are zero-filled.
  for (int c = tid; c < Sh::ROWS * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r < rows;
    const bf16_raw* src =
        ok ? q + (static_cast<size_t>(t0 + r / G) * H + kh * G + r % G) * D + ch * 8 : q;
    cp_async16(sQ + r * ROW + ch * 8, src, ok);
  }

  // Keys any row of this tile can see.  New keys stop at the tile's last
  // live query (causal frontier) and at valid_len; with a window, keys
  // below the first query's window edge are invisible to every row.
  // Tiles 0..n0-1 walk the prefix, n0..n0+n1-1 the new keys.
  const int t_last = t0 + ltok - 1;
  const int new_count = ltok > 0 ? min(valid, t_last + 1) : 0;
  const int lo_pos = window >= 0 ? cached + t0 - window + 1 : 0;
  const int start0 = max(0, lo_pos);
  const int start1 = max(0, lo_pos - cached);
  const int n0 = start0 < n_pre ? (n_pre - start0 + kKeys - 1) / kKeys : 0;
  const int n1 = start1 < new_count ? (new_count - start1 + kKeys - 1) / kKeys : 0;
  const int ntiles = n0 + n1;

  // Tile i into stage `stage` of the ring; an int8 prefix tile into the
  // staging area instead (convert_tile moves it into the ring).
  auto load_tile = [&](int i, int stage) {
    bf16_raw* dk = sK + stage * Sh::KV_ELEMS;
    bf16_raw* dv = sV + stage * Sh::KV_ELEMS;
    if (i >= n0) {  // new keys, contiguous [T, K, D]
      const int j0 = start1 + (i - n0) * kKeys;
      for (int c = tid; c < kKeys * CH; c += THREADS) {
        const int j = c / CH, ch = c % CH;
        const bool ok = j0 + j < new_count;
        const size_t off = ok ? (static_cast<size_t>(j0 + j) * K + kh) * D + ch * 8 : 0;
        cp_async16(dk + j * ROW + ch * 8, k_new + off, ok);
        cp_async16(dv + j * ROW + ch * 8, v_new + off, ok);
      }
      return;
    }
    const int j0 = start0 + i * kKeys;
    if constexpr (Pre::kInt8) {
      constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
      for (int c = tid; c < kKeys * CH8; c += THREADS) {
        const int j = c / CH8, ch = c % CH8;
        const bool ok = j0 + j < n_pre;
        const size_t off = ok ? pre.vec(j0 + j, K, kh) * D + ch * 16 : 0;
        cp_async16(sK8 + j * D + ch * 16, pre.k + off, ok);
        cp_async16(sV8 + j * D + ch * 16, pre.v + off, ok);
      }
      for (int j = tid; j < kKeys; j += THREADS) {
        const bool ok = j0 + j < n_pre;
        const size_t vi = ok ? pre.vec(j0 + j, K, kh) : 0;
        cp_async4(sKs + j, pre.k_scale + vi, ok);
        cp_async4(sVs + j, pre.v_scale + vi, ok);
      }
    } else {
      const bf16_raw* kp = static_cast<const bf16_raw*>(pre.k);
      const bf16_raw* vp = static_cast<const bf16_raw*>(pre.v);
      for (int c = tid; c < kKeys * CH; c += THREADS) {
        const int j = c / CH, ch = c % CH;
        const bool ok = j0 + j < n_pre;
        const size_t off = ok ? pre.vec(j0 + j, K, kh) * D + ch * 8 : 0;
        cp_async16(dk + j * ROW + ch * 8, kp + off, ok);
        cp_async16(dv + j * ROW + ch * 8, vp + off, ok);
      }
    }
  };
  // The staged int8 tile into stage `stage`: int8 x scale in fp32, rounded
  // to nearest-even bf16; 8 values a thread and step.
  auto convert_tile = [&](int stage) {
    bf16_raw* dk = sK + stage * Sh::KV_ELEMS;
    bf16_raw* dv = sV + stage * Sh::KV_ELEMS;
    constexpr int C8 = D / 8;
    for (int c = tid; c < kKeys * C8; c += THREADS) {
      const int j = c / C8, g = c % C8;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        float f[8];
        load_s8<8>((side ? sV8 : sK8) + j * D + g * 8, f);
        const float s = (side ? sVs : sKs)[j];
        uint4 u;
        u.x = pack_bf16x2(f[0] * s, f[1] * s);
        u.y = pack_bf16x2(f[2] * s, f[3] * s);
        u.z = pack_bf16x2(f[4] * s, f[5] * s);
        u.w = pack_bf16x2(f[6] * s, f[7] * s);
        *reinterpret_cast<uint4*>((side ? dv : dk) + j * ROW + g * 8) = u;
      }
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();  // Q and the first K/V tile

  // This thread's two rows of the warp's 16 (the mma C layout): r_base
  // and r_base + 8; its columns are (lane % 4) * 2 + {0, 1} of each tile.
  const int r_base = warp_row0 + lane / 4;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_base + 8 * i;
    qpos[i] = r < rows ? cached + t0 + r / G : -1;  // -1: padding row
  }
  const int warp_qmax =
      warp_row0 < rows ? cached + t0 + min(warp_row0 + 15, rows - 1) / G : -1;
  const int blk_qmin = cached + t0;

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int i = 0; i < ntiles; ++i) {
    const int stage = i % kStages;
    if constexpr (!Pre::kInt8) {
      if (i + 1 < ntiles) load_tile(i + 1, (i + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();  // tile i (and Q) landed for this thread ...
      __syncthreads();     // ... and for every thread
    } else {
      // One staging tile: tile i lands and is converted before tile i + 1
      // is requested, which then loads while tile i is computed.
      cp_async_wait<0>();
      __syncthreads();
      if (i < n0) {
        convert_tile(stage);
        __syncthreads();
      }
      if (i + 1 < ntiles) load_tile(i + 1, (i + 1) % kStages);
      cp_async_commit();
    }

    const bool in_prefix = i < n0;
    const int count = in_prefix ? n_pre : new_count;
    const int j0 = in_prefix ? start0 + i * kKeys : start1 + (i - n0) * kKeys;
    const int pos0 = (in_prefix ? 0 : cached) + j0;  // position of the tile's key 0
    if (pos0 <= warp_qmax) {  // else every row of this warp precedes the tile
      const bf16_raw* kt = sK + stage * Sh::KV_ELEMS;
      const bf16_raw* vt = sV + stage * Sh::KV_ELEMS;

      // S = Q . K^T: 16 rows x 64 keys per warp.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, sQ + (warp_row0 + lane % 8 + ((lane / 8) % 2) * 8) * ROW + kk * 16 +
                           (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * ROW + kk * 16 +
                             ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }

      // Mask (validity, causality, window) unless every key of the tile is
      // valid and visible to every row, then the online softmax in log2
      // units.  A row's 64 scores sit on the 4 lanes of one quad.
      const bool full = j0 + kKeys <= count && pos0 + kKeys - 1 <= blk_qmin &&
                        (window < 0 || pos0 > cached + t_last - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e / 2;
          float x = s[nt][e] * scale_log2;
          if (!full) {
            const int jj = j0 + nt * 8 + (lane % 4) * 2 + e % 2;
            const int kpos = pos0 + nt * 8 + (lane % 4) * 2 + e % 2;
            bool ok = qpos[ri] >= 0 && jj < count && kpos <= qpos[ri];
            if (window >= 0) ok = ok && kpos > qpos[ri] - window;
            if (!ok) x = -INFINITY;
          }
          s[nt][e] = x;
          mx[ri] = fmaxf(mx[ri], x);
        }
      float m_use[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
        const float m_new = fmaxf(m[ri], mx[ri]);
        m_use[ri] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
        const float alpha = exp2f(m[ri] - m_use[ri]);
        m[ri] = m_new;
        l[ri] *= alpha;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[dt][2 * ri] *= alpha;
          o[dt][2 * ri + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - m_use[e / 2]);
          s[nt][e] = p;
          l[e / 2] += p;
        }

      // O += P . V: P from registers (the C layout of two 8-key tiles is
      // the A layout of one 16-key step), rounded to bf16.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const unsigned a[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ROW +
                                   dp * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage consumed by every warp before it is reloaded
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float sum = l[ri];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = r_base + 8 * ri;
    if (r >= ntok * G) continue;
    const bool live = r < rows;  // else a batched row's padding: zeros
    const int t = t0 + r / G, h = kh * G + r % G;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16_raw* orow = out + (static_cast<size_t>(t) * H + h) * D + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<unsigned*>(orow + dt * 8) =
          live ? pack_bf16x2(o[dt][2 * ri] * inv, o[dt][2 * ri + 1] * inv) : 0u;
  }
}

template <int D, class Pre>
cudaError_t launch(const void* q, const void* kn, const void* vn, const Pre& pre,
                   void* out, int B, int Tn, int H, int K, int cached, int valid,
                   const int* cached_dev, const int* valid_dev, int pre_cap, int table_len,
                   float scale, int window, cudaStream_t stream) {
  using Sh = Shape<D>;
  const int G = H / K;
  const int tok_per_tile = Sh::ROWS / G;
  const dim3 grid((Tn + tok_per_tile - 1) / tok_per_tile, K, B);
  constexpr size_t base = Pre::kInt8 ? Sh::SMEM_INT8 : Sh::SMEM;
  const size_t table_bytes = sizeof(int) * static_cast<size_t>(table_len);
  const int staged = Pre::kPaged && base + table_bytes <= kMaxSmem;
  const size_t smem = base + (staged ? table_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<D, Pre>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bf16_kernel<D, Pre>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  using P = const bf16_raw*;
  flash_prefill_bf16_kernel<D, Pre><<<grid, Sh::THREADS, smem, stream>>>(
      static_cast<P>(q), static_cast<P>(kn), static_cast<P>(vn), pre,
      static_cast<bf16_raw*>(out), Tn, H, K, G, tok_per_tile, cached, valid,
      cached_dev, valid_dev, pre_cap, staged, scale * kLog2e, window);
  return cudaGetLastError();
}

}  // namespace tc

template <int D, class Pre>
cudaError_t launch_dim(int dtype, const void* q, const void* kn, const void* vn,
                       const Pre& pre, void* out, int B, int Tn, int H, int K, int cached,
                       int valid, const int* cached_dev, const int* valid_dev,
                       int pre_cap, int table_len, float scale, int window,
                       cudaStream_t stream) {
  if (dtype == kBFloat16)
    return tc::launch<D>(q, kn, vn, pre, out, B, Tn, H, K, cached, valid, cached_dev,
                         valid_dev, pre_cap, table_len, scale, window, stream);
  return simt::launch_dim<float, D>(q, kn, vn, pre, out, B, Tn, H, K, cached, valid,
                                    cached_dev, valid_dev, pre_cap, table_len, scale,
                                    window, stream);
}

// B rows (grid z) of T tokens; B is 1 for every entry but the batched one.
template <class Pre>
cudaError_t launch_any(int D, int dtype, const void* q, const void* kn, const void* vn,
                       const Pre& pre, void* out, int Tn, int H, int K, int cached,
                       int valid, const int* cached_dev, const int* valid_dev,
                       int pre_cap, int table_len, float scale, int window,
                       void* stream, int B = 1) {
  if (Tn == 0 || B == 0) return cudaSuccess;
  if (B < 0 || B > 65535) return cudaErrorInvalidValue;
  if (K <= 0 || H % K != 0 || H / K > simt::kRows) return cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dim<64>(dtype, q, kn, vn, pre, out, B, Tn, H, K, cached, valid,
                            cached_dev, valid_dev, pre_cap, table_len, scale, window, st);
    case 128:
      return launch_dim<128>(dtype, q, kn, vn, pre, out, B, Tn, H, K, cached, valid,
                            cached_dev, valid_dev, pre_cap, table_len, scale, window, st);
    case 256:
      return launch_dim<256>(dtype, q, kn, vn, pre, out, B, Tn, H, K, cached, valid,
                            cached_dev, valid_dev, pre_cap, table_len, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points bound with ctypes.  Every tensor is contiguous; dtype is a
// DType code; window < 0 means no sliding window.  Each returns the launch's
// cudaError_t.
//
// The contiguous prefix [C, K, D], lengths as host ints.  k_prefix /
// v_prefix may be null when cached_len == 0.
extern "C" int flash_prefill_launch(const void* q, const void* k_new,
                                    const void* v_new, const void* k_prefix,
                                    const void* v_prefix, void* out, int T,
                                    int H, int K, int D, int cached_len,
                                    int valid_len, int dtype, float scale,
                                    int window, void* stream) {
  const PrefixContig pre{k_prefix, v_prefix};
  return launch_any(D, dtype, q, k_new, v_new, pre, out, T, H, K, cached_len,
                    valid_len, nullptr, nullptr, cached_len, 0, scale, window, stream);
}

// The prefix read from the paged pool [N, bs, K, D] through table[P]
// (int32; any P, zero-padded past the prefix), lengths read from the int32
// device values cached_len[0] and valid_len[0]; bs a power of two.  int8
// != 0: the cache is int8 with fp32 scales [N, bs, K] (k_scale, v_scale);
// else it is in q's dtype and the scales are ignored.
extern "C" int flash_prefill_paged_launch(const void* q, const void* k_new,
                                          const void* v_new, const void* k_cache,
                                          const void* v_cache, const void* k_scale,
                                          const void* v_scale, const int* table,
                                          int P, int bs, const int* cached_len,
                                          const int* valid_len, void* out, int T,
                                          int H, int K, int D, int int8, int dtype,
                                          float scale, int window, void* stream) {
  if (bs <= 0 || (bs & (bs - 1)) != 0 || P < 0) return cudaErrorInvalidValue;
  const int cap = P * bs;
  const int shift = __builtin_ctz(static_cast<unsigned>(bs));
  if (int8) {
    PrefixPagedInt8 pre;
    pre.table = table;
    pre.shift = shift;
    pre.k = static_cast<const int8_t*>(k_cache);
    pre.v = static_cast<const int8_t*>(v_cache);
    pre.k_scale = static_cast<const float*>(k_scale);
    pre.v_scale = static_cast<const float*>(v_scale);
    return launch_any(D, dtype, q, k_new, v_new, pre, out, T, H, K, 0, T, cached_len,
                      valid_len, cap, P, scale, window, stream);
  }
  PrefixPaged pre;
  pre.table = table;
  pre.shift = shift;
  pre.k = k_cache;
  pre.v = v_cache;
  return launch_any(D, dtype, q, k_new, v_new, pre, out, T, H, K, 0, T, cached_len,
                    valid_len, cap, P, scale, window, stream);
}

// No prefix, B rows of T tokens: q and out [B, T, H, D], k and v [B, T, K,
// D], valid_lens [B] int32 in device memory (each clamped to [0, T]).  Row
// b's query t < valid_lens[b] attends causally over its keys < valid_lens[b]
// (within the window); its rows t >= valid_lens[b] are zeros.
extern "C" int flash_prefill_batched_launch(const void* q, const void* k, const void* v,
                                            const int* valid_lens, void* out, int B,
                                            int T, int H, int K, int D, int dtype,
                                            float scale, int window, void* stream) {
  const PrefixNoneBatched pre{};
  return launch_any(D, dtype, q, k, v, pre, out, T, H, K, 0, T, nullptr, valid_lens,
                    0, 0, scale, window, stream, B);
}
