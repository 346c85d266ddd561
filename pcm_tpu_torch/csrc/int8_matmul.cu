// Fused int8 matmul with in-kernel activation quantization:
//   out[m, n] = bf16( ws[n] * sum_t float(xq_t[m] . wq[n, t]) * s_t[m] )
// where, for each K-tile t of bk columns, s_t[m] = max|x[m, t]| * fl(1/127)
// (1 when the max is 0) and xq_t = clip(rint(x[m, t] / s_t[m]), -127, 127) in
// int8. (The JAX kernel writes amax / 127.0; XLA compiles that into the
// product with the fp32 reciprocal, and this is the function it computes.)
//
// Replaces: pcm_tpu/ops/int8_matmul.py `_kernel` (launched by
// `fused_quantized_dot`). As there, the activations are quantized per
// (row, K-tile) on chip, so neither fp32 nor int8 copies of x reach device
// memory, and the product reads the int8 weight (half the bf16 bytes). The
// K-tile bk is part of the numerics, not a tiling choice: the caller passes
// `_pick_block(K, 512, 128)`. The fp32 sum runs over the K-tiles in order and
// rounds each term as `part * s` and then `acc + term` (__fmul_rn/__fadd_rn:
// no FMA contraction), x / s is an IEEE division (__fdiv_rn) and the rounding
// is half to even (rintf), so the kernel computes what the plain version does.
//
// Bound on this card: device-memory bytes at K = N = 320 (a 1x1 conv over
// 16384 pixels: ~21 MB moved for 3.4 GOP), int8 tensor-core throughput at
// the wide SDXL feed-forward shapes (K 1280 -> N 10240).
//
// Design: a 64 x 128 output tile per block of 8 warps (2 x 4, each 32 x 32).
// For each K-tile the warps quantize the block's 64 x-rows into shared int8
// (one warp per row at a time: a max over the row by warp shuffles, then a
// second, cached read that quantizes), the block copies the 128 x bk int8
// weight tile beside it, and each warp runs mma.sync m16n8k32 s8 x s8 -> s32
// over the tile: exact, since bk * 127^2 < 2^31. The int32 partials are then
// scaled into fp32 accumulators by the rows' scales. Rows past M are zero in
// shared memory (s = 1, xq = 0) and never stored. Loads are synchronous; a
// TMA + wgmma pipeline is a later PR's work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64, BN = 128, THREADS = 256;
constexpr int PAD = 16;  // bytes after each shared row: rows start 4 banks apart
constexpr float RECIP_127 = 0x1.020408p-7f;  // fl(1/127)

// mma.m16n8k32 s8 fragments (PTX ISA), g = lane / 4, t = lane % 4:
//   A 16x32 row-major: a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] = A[g][16+4t..],
//                      a[3] = A[g+8][16+4t..]
//   B 32x8 given as Bt[n][k]: b[0] = Bt[g][4t..4t+3], b[1] = Bt[g][16+4t..16+4t+3]
//   C 16x8 int32: c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four bf16 -> four int8 codes packed little-endian
__device__ __forceinline__ uint32_t quant4(const bf16* e, float s) {
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float q = rintf(__fdiv_rn(__bfloat162float(e[j]), s));
    q = fminf(fmaxf(q, -127.f), 127.f);
    packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q) << (8 * j);
  }
  return packed;
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ ws, bf16* __restrict__ out, int m, int n, int k,
                   int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = bk + PAD;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);  // BM x pitch
  int8_t* wt = xq + BM * pitch;                   // BN x pitch
  float* sx = reinterpret_cast<float*>(wt + BN * pitch);  // BM row scales

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    // 1. quantize the block's x rows of this K-tile (one warp per row)
    for (int r = warp; r < BM; r += THREADS / 32) {
      int8_t* dst = xq + r * pitch;
      if (m0 + r >= m) {
        for (int c = lane * 16; c < bk; c += 32 * 16) *reinterpret_cast<uint4*>(dst + c) = zero;
        if (lane == 0) sx[r] = 1.f;
        continue;
      }
      const bf16* src = x + (int64_t)(m0 + r) * k + k0;
      float amax = 0.f;
      for (int c = lane * 8; c < bk; c += 32 * 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = amax > 0.f ? __fmul_rn(amax, RECIP_127) : 1.f;
      if (lane == 0) sx[r] = s;
      for (int c = lane * 8; c < bk; c += 32 * 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(quant4(e, s), quant4(e + 4, s));
      }
    }
    // 2. the int8 weight tile, rows n0.. of the (N, K) weight
    const int chunks = bk / 16;
    for (int i = tid; i < BN * chunks; i += THREADS) {
      const int r = i / chunks, c = (i % chunks) * 16;
      uint4 v = zero;
      if (n0 + r < n) v = *reinterpret_cast<const uint4*>(w + (int64_t)(n0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(wt + r * pitch + c) = v;
    }
    __syncthreads();

    // 3. int8 products of the K-tile, exact in int32
    int part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0;
    for (int kk = 0; kk < bk; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = xq + (wm + mi * 16 + g) * pitch + kk + 4 * t;
        a[mi][0] = ld_s32(p);
        a[mi][1] = ld_s32(p + 8 * pitch);
        a[mi][2] = ld_s32(p + 16);
        a[mi][3] = ld_s32(p + 8 * pitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = wt + (wn + ni * 8 + g) * pitch + kk + 4 * t;
        const uint32_t b[2] = {ld_s32(q), ld_s32(q + 16)};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8_16832(part[mi][ni], a[mi], b);
      }
    }

    // 4. acc += float(part) * s, rounded as two operations
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = sx[wm + mi * 16 + g + half * 8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a = acc[mi][ni][2 * half + e];
            a = __fadd_rn(a, __fmul_rn(__int2float_rn(part[mi][ni][2 * half + e]), s));
          }
      }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= n) continue;
    const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= m) continue;
        *reinterpret_cast<uint32_t*>(out + (int64_t)row * n + col) = pcm::pack_bf16x2(
            __fmul_rn(acc[mi][ni][2 * half], w0), __fmul_rn(acc[mi][ni][2 * half + 1], w1));
      }
  }
}

int smem_bytes(int bk) { return (BM + BN) * (bk + PAD) + BM * (int)sizeof(float); }

}  // namespace

// x: contiguous (m, k) bf16; w: contiguous (n, k) int8 (the nn.Linear layout);
// ws: (n,) fp32; out: contiguous (m, n) bf16. bk divides k, bk % 32 == 0,
// bk <= 1024; n % 8 == 0; pointers 16-byte aligned.
extern "C" int pcm_int8_matmul(const void* x, const void* w, const void* ws, void* out, int m,
                               int n, int k, int bk, void* stream) {
  const int smem = smem_bytes(bk);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<bf16*>(out), m, n, k, bk);
  return cudaGetLastError();
}
