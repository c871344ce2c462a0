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
// K and V, hundreds of operations per byte.
//
// What the design does about it, simple and right first:
//  * Grid (query tile, KV head).  A tile is 64 query rows of the GQA
//    regrouped axis r = t * G + g, so one block computes all G query heads
//    of its KV head and each K/V tile it loads serves G heads.
//  * Hopper blocks cannot carry state across a grid axis, so one block
//    walks its KV tiles in a loop: the live prefix [0, cached_len) first,
//    then the new keys up to the tile's causal frontier (and from the
//    sliding window's lower edge).  Tiles past the frontier are never
//    loaded.
//  * Products are fp32 FMAs on register micro-tiles (4 rows x 4 keys for
//    Q.K^T, 4 rows x D/16 columns for P.V) over fp32 tiles in shared
//    memory, Q and K stored transposed so each thread reads float4 runs.
//    The tensor cores (mma.sync, wgmma) and TMA are later work: this
//    version runs on the CUDA cores at a fraction of the bf16 peak.
//  * Ragged T is masked in the kernel; any T and any D in {64, 128, 256}
//    is taken.
#include "common.cuh"

namespace {

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

template <typename T>
cudaError_t launch_typed(const void* q, const void* kn, const void* vn,
                         const void* kp, const void* vp, void* out, int Tn,
                         int H, int K, int D, int cached, int valid,
                         float scale, int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_dim<T, 64>(q, kn, vn, kp, vp, out, Tn, H, K, cached, valid, scale, window, stream);
    case 128:
      return launch_dim<T, 128>(q, kn, vn, kp, vp, out, Tn, H, K, cached, valid, scale, window, stream);
    case 256:
      return launch_dim<T, 256>(q, kn, vn, kp, vp, out, Tn, H, K, cached, valid, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (K <= 0 || H % K != 0 || H / K > kRows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(q, k_new, v_new, k_prefix, v_prefix, out, T,
                                  H, K, D, cached_len, valid_len, scale, window, st);
  if (dtype == kFloat32)
    return launch_typed<float>(q, k_new, v_new, k_prefix, v_prefix, out, T, H,
                               K, D, cached_len, valid_len, scale, window, st);
  return cudaErrorInvalidValue;
}
