// Shared device helpers for the port's Hopper kernels: the bf16 tensor-core
// product (mma.sync m16n8k16, fp32 accumulate) and bf16x2 packing.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A 16x16 row-major: a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                      a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B 16x8 given as Bt[n][k] (n-major):  b[0] = Bt[g][2t..2t+1], b[1] = Bt[g][2t+8..2t+9]
//   C 16x8 fp32: c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pcm {

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 32-bit load of two adjacent bf16 from shared memory.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace pcm
