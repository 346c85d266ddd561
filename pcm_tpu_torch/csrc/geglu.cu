// Fused GEGLU projection: out = (x Wa^T + ba) * gelu_erf(x Wb^T + bb).
//
// Replaces: pcm_tpu/ops/geglu.py `_geglu_kernel` (launched by `_forward`).
// Like it, the kernel reads both halves of the projection weight in place
// (here the nn.Linear layout (2F, K): value rows [0, F), gate rows [F, 2F)),
// keeps two fp32 accumulators, and applies the gate in the epilogue, so the
// (M, 2F) intermediate is never written to device memory. The gate uses the
// exact erff, where the Pallas kernel needed the A&S 7.1.26 approximation.
// It takes any K and F that are multiples of 8: SD1.5's level-0 K = 320
// runs here, where the Pallas path fell back to XLA.
//
// Bound on this card: tensor-core throughput (M = 256..16384 rows against
// K = 320..1280 and 2F = 2560..10240 at the SD1.5 shapes).
//
// Design: a 64 x 64 output tile per block of 4 warps (2 x 2), each warp a
// 32 x 32 value tile and the matching 32 x 32 gate tile, k steps of 32
// through shared memory, mma.sync m16n8k16 bf16 with fp32 accumulation.
// Loads are synchronous and edge tiles are zero-filled; a cp.async/TMA +
// wgmma pipeline is a later PR's work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64, BN = 64, BK = 32, PITCH = BK + 8;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__global__ void __launch_bounds__(128)
geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int k, int f) {
  __shared__ __align__(16) bf16 Xs[BM * PITCH];
  __shared__ __align__(16) bf16 Wa[BN * PITCH];
  __shared__ __align__(16) bf16 Wb[BN * PITCH];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc_a[2][4][4], acc_b[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[mi][ni][e] = acc_b[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += 128) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool kin = k0 + c < k;
      uint4 xv = zero, av = zero, bv = zero;
      if (kin && m0 + r < m)
        xv = *reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * k + k0 + c);
      if (kin && n0 + r < f) {
        av = *reinterpret_cast<const uint4*>(w + (int64_t)(n0 + r) * k + k0 + c);
        bv = *reinterpret_cast<const uint4*>(w + (int64_t)(f + n0 + r) * k + k0 + c);
      }
      *reinterpret_cast<uint4*>(Xs + r * PITCH + c) = xv;
      *reinterpret_cast<uint4*>(Wa + r * PITCH + c) = av;
      *reinterpret_cast<uint4*>(Wb + r * PITCH + c) = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = Xs + (wm + mi * 16 + g) * PITCH + kk * 16 + 2 * t;
        a[mi][0] = pcm::ld32(p);
        a[mi][1] = pcm::ld32(p + 8 * PITCH);
        a[mi][2] = pcm::ld32(p + 8);
        a[mi][3] = pcm::ld32(p + 8 * PITCH + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int off = (wn + ni * 8 + g) * PITCH + kk * 16 + 2 * t;
        uint32_t ba[2] = {pcm::ld32(Wa + off), pcm::ld32(Wa + off + 8)};
        uint32_t bb[2] = {pcm::ld32(Wb + off), pcm::ld32(Wb + off + 8)};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          pcm::mma_bf16_16816(acc_a[mi][ni], a[mi], ba);
          pcm::mma_bf16_16816(acc_b[mi][ni], a[mi], bb);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= f) continue;
    const float ba0 = __bfloat162float(bias[col]), ba1 = __bfloat162float(bias[col + 1]);
    const float bb0 = __bfloat162float(bias[f + col]), bb1 = __bfloat162float(bias[f + col + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= m) continue;
        const float y0 = (acc_a[mi][ni][2 * half] + ba0) * gelu_erf(acc_b[mi][ni][2 * half] + bb0);
        const float y1 =
            (acc_a[mi][ni][2 * half + 1] + ba1) * gelu_erf(acc_b[mi][ni][2 * half + 1] + bb1);
        *reinterpret_cast<uint32_t*>(out + (int64_t)row * f + col) = pcm::pack_bf16x2(y0, y1);
      }
  }
}

}  // namespace

// x: contiguous (m, k) bf16; w: contiguous (2f, k) bf16; bias: (2f,) bf16;
// out: contiguous (m, f) bf16. k and f multiples of 8, pointers 16-byte aligned.
extern "C" int pcm_geglu(const void* x, const void* w, const void* bias, void* out, int m,
                         int k, int f, void* stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  geglu_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, k, f);
  return cudaGetLastError();
}
