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
#include "common.cuh"

namespace {

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q,      // [T, H, D]
                     const T* __restrict__ k_new,  // [T, K, D]
                     const T* __restrict__ v_new,
                     const T* __restrict__ k_pre,  // [C, K, D]
                     const T* __restrict__ v_pre,
                     T* __restrict__ out,  // [T, H, D]
                     int Tn, int H, int K, int G, int tok_per_tile,
                     int cached, int valid, float scale, int window) {
  constexpr int V = Vec<T>::N;
  constexpr int NV = D / V;
  constexpr int CG = D / 64;  // float4 column groups per thread in P.V

  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                // [D][kRows], pre-scaled
  float* sKt = sQt + D * kRows;     // [D][kKeys]
  float* sV = sKt + D * kKeys;      // [kKeys][D]
  float* sPt = sV + kKeys * D;      // [kKeys][kRows]

  const int kh = blockIdx.y;
  const int t0 = blockIdx.x * tok_per_tile;
  const int ntok = min(tok_per_tile, Tn - t0);
  const int rows = ntok * G;  // live rows in this tile
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
  // query (causal frontier) and at valid_len; with a window, keys below
  // the first query's window edge are invisible to every row.
  const int t_last = t0 + ntok - 1;
  const int new_count = min(valid, t_last + 1);
  const int lo_pos = window >= 0 ? cached + t0 - window + 1 : 0;

  for (int seg = 0; seg < 2; ++seg) {
    const T* kp = seg == 0 ? k_pre : k_new;
    const T* vp = seg == 0 ? v_pre : v_new;
    const int count = seg == 0 ? cached : new_count;
    const int pos_base = seg == 0 ? 0 : cached;
    const int start = max(0, lo_pos - pos_base);
    for (int j0 = start; j0 < count; j0 += kKeys) {
      __syncthreads();  // previous tile's sKt / sV / sPt fully consumed
      for (int i = tid; i < kKeys * NV; i += kThreads) {
        // K transposed: consecutive threads take consecutive keys.
        const int j = i % kKeys, dv = i / kKeys;
        float f[V];
        if (j0 + j < count) {
          load_vec(kp + (static_cast<size_t>(j0 + j) * K + kh) * D + dv * V, f);
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
        if (j0 + j < count) {
          load_vec(vp + (static_cast<size_t>(j0 + j) * K + kh) * D + dv * V, f);
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
    if (r >= rows) continue;
    const int t = t0 + r / G, h = kh * G + r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + (static_cast<size_t>(t) * H + h) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[cg * 64 + tx * 4 + e] = from_float<T>(acc[i][cg * 4 + e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_dim(const void* q, const void* kn, const void* vn,
                       const void* kp, const void* vp, void* out, int Tn, int H,
                       int K, int cached, int valid, float scale, int window,
                       cudaStream_t stream) {
  const int G = H / K;
  const int tok_per_tile = kRows / G;
  const dim3 grid((Tn + tok_per_tile - 1) / tok_per_tile, K);
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<T*>(out), Tn, H, K, G,
      tok_per_tile, cached, valid, scale, window);
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

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_prefill_bf16_kernel(const bf16_raw* __restrict__ q,      // [T, H, D]
                          const bf16_raw* __restrict__ k_new,  // [T, K, D]
                          const bf16_raw* __restrict__ v_new,
                          const bf16_raw* __restrict__ k_pre,  // [C, K, D]
                          const bf16_raw* __restrict__ v_pre,
                          bf16_raw* __restrict__ out,  // [T, H, D]
                          int Tn, int H, int K, int G, int tok_per_tile,
                          int cached, int valid, float scale_log2, int window) {
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

  const int kh = blockIdx.y;
  // Reversed: the latest query tiles see the most keys and start first.
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tok_per_tile;
  const int ntok = min(tok_per_tile, Tn - t0);
  const int rows = ntok * G;  // live rows in this tile
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
  // query (causal frontier) and at valid_len; with a window, keys below
  // the first query's window edge are invisible to every row.  Tiles
  // 0..n0-1 walk the prefix, n0..n0+n1-1 the new keys.
  const int t_last = t0 + ntok - 1;
  const int new_count = min(valid, t_last + 1);
  const int lo_pos = window >= 0 ? cached + t0 - window + 1 : 0;
  const int start0 = max(0, lo_pos);
  const int start1 = max(0, lo_pos - cached);
  const int n0 = start0 < cached ? (cached - start0 + kKeys - 1) / kKeys : 0;
  const int n1 = start1 < new_count ? (new_count - start1 + kKeys - 1) / kKeys : 0;
  const int ntiles = n0 + n1;

  auto load_tile = [&](int i, int stage) {
    const bool pre = i < n0;
    const bf16_raw* kp = pre ? k_pre : k_new;
    const bf16_raw* vp = pre ? v_pre : v_new;
    const int count = pre ? cached : new_count;
    const int j0 = pre ? start0 + i * kKeys : start1 + (i - n0) * kKeys;
    bf16_raw* dk = sK + stage * Sh::KV_ELEMS;
    bf16_raw* dv = sV + stage * Sh::KV_ELEMS;
    for (int c = tid; c < kKeys * CH; c += THREADS) {
      const int j = c / CH, ch = c % CH;
      const bool ok = j0 + j < count;
      const size_t off = ok ? (static_cast<size_t>(j0 + j) * K + kh) * D + ch * 8 : 0;
      cp_async16(dk + j * ROW + ch * 8, kp + off, ok);
      cp_async16(dv + j * ROW + ch * 8, vp + off, ok);
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
    if (i + 1 < ntiles) load_tile(i + 1, (i + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and Q) landed for this thread ...
    __syncthreads();     // ... and for every thread

    const bool pre = i < n0;
    const int count = pre ? cached : new_count;
    const int j0 = pre ? start0 + i * kKeys : start1 + (i - n0) * kKeys;
    const int pos0 = (pre ? 0 : cached) + j0;  // position of the tile's key 0
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
    if (r >= rows) continue;
    const int t = t0 + r / G, h = kh * G + r % G;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16_raw* orow = out + (static_cast<size_t>(t) * H + h) * D + (lane % 4) * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<unsigned*>(orow + dt * 8) =
          pack_bf16x2(o[dt][2 * ri] * inv, o[dt][2 * ri + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kn, const void* vn, const void* kp,
                   const void* vp, void* out, int Tn, int H, int K, int cached,
                   int valid, float scale, int window, cudaStream_t stream) {
  using Sh = Shape<D>;
  const int G = H / K;
  const int tok_per_tile = Sh::ROWS / G;
  const dim3 grid((Tn + tok_per_tile - 1) / tok_per_tile, K);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bf16_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  using P = const bf16_raw*;
  flash_prefill_bf16_kernel<D><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
      static_cast<P>(q), static_cast<P>(kn), static_cast<P>(vn), static_cast<P>(kp),
      static_cast<P>(vp), static_cast<bf16_raw*>(out), Tn, H, K, G, tok_per_tile,
      cached, valid, scale * kLog2e, window);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch_dim(int dtype, const void* q, const void* kn, const void* vn,
                       const void* kp, const void* vp, void* out, int Tn, int H,
                       int K, int cached, int valid, float scale, int window,
                       cudaStream_t stream) {
  if (dtype == kBFloat16)
    return tc::launch<D>(q, kn, vn, kp, vp, out, Tn, H, K, cached, valid, scale,
                         window, stream);
  return simt::launch_dim<float, D>(q, kn, vn, kp, vp, out, Tn, H, K, cached, valid,
                                    scale, window, stream);
}

}  // namespace

// C entry point bound with ctypes.  Every tensor is contiguous; dtype is a
// DType code; window < 0 means no sliding window.  k_prefix / v_prefix may
// be null when cached_len == 0.  Returns the launch's cudaError_t.
extern "C" int flash_prefill_launch(const void* q, const void* k_new,
                                    const void* v_new, const void* k_prefix,
                                    const void* v_prefix, void* out, int T,
                                    int H, int K, int D, int cached_len,
                                    int valid_len, int dtype, float scale,
                                    int window, void* stream) {
  if (T == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > simt::kRows) return cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dim<64>(dtype, q, k_new, v_new, k_prefix, v_prefix, out, T, H, K,
                            cached_len, valid_len, scale, window, st);
    case 128:
      return launch_dim<128>(dtype, q, k_new, v_new, k_prefix, v_prefix, out, T, H, K,
                             cached_len, valid_len, scale, window, st);
    case 256:
      return launch_dim<256>(dtype, q, k_new, v_new, k_prefix, v_prefix, out, T, H, K,
                             cached_len, valid_len, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}
