// Hopper (sm_90a) primitives as inline PTX, for kernels that run a TMA ring
// into warpgroup MMAs: mbarriers, the 2-D tensor load, wgmma's fence,
// commit and wait, the shared-memory matrix descriptor, wgmma with A in
// registers, register reallocation between warpgroups and named barriers.
// w8a16_gemm.cu's bf16 body is their user.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol is linked
#include <stdint.h>

#include "common.cuh"

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); then a
// block barrier before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier how many bytes of TMA traffic
// complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned addr, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of the given parity has completed.  A fresh
// barrier is in phase 0, so a wait on parity 1 passes at once.  A wait of
// more than ~10 s (2^34 cycles) traps: a lost arrival or TMA load becomes
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// -- TMA -------------------------------------------------------------------------

// The box of `map` at coordinates (c0 innermost, c1) into shared memory at
// dst; completion is counted in bytes on `bar`.  Out-of-bounds elements
// are written as zeros (and counted).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// -- Warpgroup MMA -----------------------------------------------------------------

// Orders this thread's register writes (A fragments, accumulators) before
// the warpgroup's next wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the program: the compiler may not move
// their writes below, or their reads above, it.  Placed before
// wgmma_fence() (the writes it orders must come first) and after
// wgmma_wait() (the accumulators are read only once the MMAs are done).
template <int R>
__device__ __forceinline__ void fence_operands(unsigned (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major bf16 operand whose rows are 128 bytes (64
// values) under the 128-byte swizzle, as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: rows in groups of 8 at 1024 bytes (the
// stride byte offset); the tile starts on a 1024-byte boundary.  Adding
// 2 to the descriptor moves the start 32 bytes along K (one 16-deep step).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // leading byte offset (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // stride byte offset
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

// d[64 x N] += a[64 x 16] . b[16 x N]: bf16 inputs, fp32 sums.  A comes from
// registers (each warp of the warpgroup holds 16 rows in mma.sync's A
// fragment layout), B from shared memory through its descriptor (K-major:
// N rows of K).  Lane (g, c) of warp w holds d[4 j .. 4 j + 3] = rows 16 w
// + g and 16 w + g + 8, columns 8 j + 2 c and 8 j + 2 c + 1, as
// (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1).
template <int N>
struct WgmmaRS;

// PTX names every accumulator of the instruction: the lists below are the
// registers %0 .. %(N/2 - 1) and the matching operands, 8 at a time.
#define HOPPER_S8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_S16 HOPPER_S8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_S24 HOPPER_S16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HOPPER_S32 HOPPER_S24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_S40 HOPPER_S32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_S48 HOPPER_S40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_S56 HOPPER_S48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define HOPPER_S64 HOPPER_S56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_S72 HOPPER_S64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define HOPPER_S80 HOPPER_S72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_S88 HOPPER_S80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define HOPPER_S96 HOPPER_S88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_S104 HOPPER_S96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define HOPPER_S112 HOPPER_S104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_S120 HOPPER_S112 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define HOPPER_S128 HOPPER_S120 ", %120, %121, %122, %123, %124, %125, %126, %127"

#define HOPPER_D(i) "+f"(d[i])
#define HOPPER_D8(i)                                                                  \
  HOPPER_D(i), HOPPER_D(i + 1), HOPPER_D(i + 2), HOPPER_D(i + 3), HOPPER_D(i + 4), \
      HOPPER_D(i + 5), HOPPER_D(i + 6), HOPPER_D(i + 7)
#define HOPPER_D16 HOPPER_D8(0), HOPPER_D8(8)
#define HOPPER_D24 HOPPER_D16, HOPPER_D8(16)
#define HOPPER_D32 HOPPER_D24, HOPPER_D8(24)
#define HOPPER_D40 HOPPER_D32, HOPPER_D8(32)
#define HOPPER_D48 HOPPER_D40, HOPPER_D8(40)
#define HOPPER_D56 HOPPER_D48, HOPPER_D8(48)
#define HOPPER_D64 HOPPER_D56, HOPPER_D8(56)
#define HOPPER_D72 HOPPER_D64, HOPPER_D8(64)
#define HOPPER_D80 HOPPER_D72, HOPPER_D8(72)
#define HOPPER_D88 HOPPER_D80, HOPPER_D8(80)
#define HOPPER_D96 HOPPER_D88, HOPPER_D8(88)
#define HOPPER_D104 HOPPER_D96, HOPPER_D8(96)
#define HOPPER_D112 HOPPER_D104, HOPPER_D8(104)
#define HOPPER_D120 HOPPER_D112, HOPPER_D8(112)
#define HOPPER_D128 HOPPER_D120, HOPPER_D8(120)

// N columns (N / 2 accumulators a thread, registers %0 .. %(R - 1)); a0 ..
// a3, the descriptor and the scale-d flag (always 1: d accumulates) follow
// as %R .. %(R + 5).
#define HOPPER_WGMMA_RS(N, R, A0, A1, A2, A3, DESC, SCALE)                                  \
  template <>                                                                               \
  struct WgmmaRS<N> {                                                                       \
    __device__ __forceinline__ static void mma(float (&d)[R], const unsigned (&a)[4],      \
                                               uint64_t desc) {                             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE ", 0;\n"                     \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" HOPPER_S##R \
                   "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1, 0;\n}\n" \
                   : HOPPER_D##R                                                            \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));        \
    }                                                                                       \
  };

HOPPER_WGMMA_RS(32, 16, 16, 17, 18, 19, 20, 21)
HOPPER_WGMMA_RS(48, 24, 24, 25, 26, 27, 28, 29)
HOPPER_WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37)
HOPPER_WGMMA_RS(80, 40, 40, 41, 42, 43, 44, 45)
HOPPER_WGMMA_RS(96, 48, 48, 49, 50, 51, 52, 53)
HOPPER_WGMMA_RS(112, 56, 56, 57, 58, 59, 60, 61)
HOPPER_WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69)
HOPPER_WGMMA_RS(144, 72, 72, 73, 74, 75, 76, 77)
HOPPER_WGMMA_RS(160, 80, 80, 81, 82, 83, 84, 85)
HOPPER_WGMMA_RS(176, 88, 88, 89, 90, 91, 92, 93)
HOPPER_WGMMA_RS(192, 96, 96, 97, 98, 99, 100, 101)
HOPPER_WGMMA_RS(208, 104, 104, 105, 106, 107, 108, 109)
HOPPER_WGMMA_RS(224, 112, 112, 113, 114, 115, 116, 117)
HOPPER_WGMMA_RS(240, 120, 120, 121, 122, 123, 124, 125)
HOPPER_WGMMA_RS(256, 128, 128, 129, 130, 131, 132, 133)

// -- Warp specialisation ---------------------------------------------------------

// Give back registers (a producer warpgroup) or take them (consumers); every
// warp of the warpgroup runs the same one.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- Thread-block clusters -------------------------------------------------------

// Every thread of the cluster that has not exited arrives, then waits for
// the others: shared-memory writes before it are visible to the cluster's
// reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of `p` (this block's shared memory) in the shared memory of
// the cluster's block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// A barrier among `count` threads (whole warps) on barrier `id` (1-15: 0 is
// __syncthreads's).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
