// Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels: shared
// memory addresses, mbarriers, TMA tile loads from a tensor map, wgmma
// shared-memory descriptors and the warpgroup fences. The wgmma products
// themselves are in wgmma_ops.cuh.
//
// Tiles live in shared memory as column chunks: a ROWS x D tile is D / 16
// chunks, each ROWS rows of 16 bf16 (32 bytes), swizzled by the TMA's
// SWIZZLE_32B mode and read by wgmma with the matching B32 layout type. The
// same chunked tile is read two ways (CUTLASS's canonical GMMA layouts,
// cute/arch/mma_sm90_desc.hpp):
//   K-major (rows = M or N, columns = K): 8-row groups 256 bytes apart (SBO);
//     a K step of 16 is the next chunk.
//   MN-major (columns = N, rows = K): N groups of 16 one chunk apart (LBO),
//     8-row K groups 256 bytes apart (SBO); a K step of 16 rows moves 512
//     bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ops.cuh"

namespace pcm {

constexpr int CHUNK_BYTES = 32;  // one row of a 16-column chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add ``bytes`` to the transaction count of the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A wait that never
// ends (a copy that never lands) traps after ~2^28 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA loads (completion counted in bytes on an mbarrier)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma descriptors and fences
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor of the 32-byte swizzle (layout type 3,
// B32); offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// K-major operand: rows r0.. of a chunked tile of ROWS rows, K step kk (16
// wide: one chunk).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int r0, int kk) {
  return gmma_desc(tile + kk * (ROWS * CHUNK_BYTES) + r0 * CHUNK_BYTES, 16, 8 * CHUNK_BYTES);
}

// MN-major operand: columns c0.. (a multiple of 16) as N, rows 16 kk.. as K.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int c0, int kk) {
  return gmma_desc(tile + (c0 / 16) * (ROWS * CHUNK_BYTES) + kk * 16 * CHUNK_BYTES,
                   ROWS * CHUNK_BYTES, 8 * CHUNK_BYTES);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register budget of a warpgroup (setmaxnreg): a producer warpgroup gives
// registers back, consumer warpgroups take them. Every warp of the warpgroup
// executes it, on a branch that does not rejoin the others.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keeps the compiler from moving reads of an accumulator above a wg_wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}

template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]));
}

// 2^x by the special function unit (ex2.approx, denormal results flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace pcm
