// Fused GEGLU projection for Hopper (sm_90a):
// out = (x Wa^T + ba) * gelu_erf(x Wb^T + bb).
//
// Replaces: pcm_tpu/ops/geglu.py:47 `_geglu_kernel` (launched by `_forward`,
// `pallas_call` at :100). Like it, the kernel reads both halves of the
// projection weight in place (here the nn.Linear layout (2F, K): value rows
// [0, F), gate rows [F, 2F)), keeps two fp32 accumulators, and applies the
// gate in the epilogue, so the (M, 2F) intermediate is never written to
// device memory. The gate uses the exact erff, where the Pallas kernel needed
// the A&S 7.1.26 approximation. It takes any K and F that are multiples of 8:
// SD1.5's level-0 K = 320 runs here, where the Pallas path fell back to XLA.
//
// Bound on this card: operations, 2 M K 2F of bf16 tensor-core work against
// (M K + 2F K + M F) * 2 bytes; at the SD1.5 / SDXL shapes (M = 256..32768,
// K = 320..1280, 2F = 2560..10240) far above the memory rate's line.
//
// Design: a TMA + wgmma GEMM with the gate fused into its epilogue.
// - A block computes 128 rows x 128 columns of both the value and the gate:
//   two consumer warpgroups of 64 rows, each holding a 64 x 128 fp32
//   accumulator of each (128 registers a thread), and a producer warpgroup
//   (setmaxnreg: 232 registers a consumer thread, 40 a producer one) whose
//   first thread keeps a ring of 4 stages of (x, Wa, Wb) k tiles of 64
//   columns in flight (a full and an empty mbarrier per stage).
// - Tiles are TMA loads (tensor maps from hopper.cuh, cached by their inputs)
//   of 64 columns, 128 bytes a row, with the 128-byte swizzle: one box per
//   operand a stage. Both operands are K-major, x's rows and w's rows (the N
//   rows of B, K contiguous), so wgmma SS m64n128k16 takes them as they
//   land; each consumer keeps one k tile's products in flight while it waits
//   for the next tile.
// - Persistent blocks, one an SM, walk the 128 x 128 tiles N fastest (the
//   blocks resident together share their x rows in L2); the ring runs on
//   across tiles, so the producer fills the next tile's stages while the
//   consumers run this tile's epilogue.
// - Edges: the TMA zero-fills rows beyond M and columns beyond K (K = 320 is
//   five whole k tiles; a K that is not a multiple of 64 multiplies zeros).
//   Value rows beyond F read gate rows (in bounds, never stored), gate rows
//   beyond 2F are zero-filled; stores are masked to rows < M, columns < F.
// - Epilogue: bias, the exact erff gate and the product on the accumulator
//   registers, bf16 pairs stored straight to device memory.
// `geglu_tiles` in ops/geglu.py mirrors the tiles and the grid.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NWG = 2;                    // consumer warpgroups of a block
constexpr int THREADS = 128 * (NWG + 1);  // + a producer warpgroup
constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int BM = 64 * NWG, BN = 128, BK = 64;  // BK columns: one 128-byte swizzled chunk
constexpr int X_BYTES = BM * BK * 2;  // one stage's x tile
constexpr int W_BYTES = BN * BK * 2;  // one of its Wa, Wb tiles
constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr size_t SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__global__ void __launch_bounds__(THREADS, 1)
geglu_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int k, int f) {
  const int tiles_n = (f + BN - 1) / BN, tiles = tiles_n * ((m + BM - 1) / BM);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int n = (k + BK - 1) / BK;  // k steps of a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pcm::mbar_init(&full[s], 1);
      pcm::mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    pcm::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer warpgroup: one thread issues every copy
    pcm::reg_dealloc<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      pcm::tma_prefetch_desc(&tx);
      pcm::tma_prefetch_desc(&tw);
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BM;
        for (int kt = 0; kt < n; ++kt, ++it) {
          const int s = it % STAGES;
          pcm::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * STAGE_BYTES;
          pcm::mbar_expect_tx(&full[s], STAGE_BYTES);
          pcm::tma_load_2d(st, &tx, &full[s], kt * BK, m0);
          pcm::tma_load_2d(st + X_BYTES, &tw, &full[s], kt * BK, n0);
          pcm::tma_load_2d(st + X_BYTES + W_BYTES, &tw, &full[s], kt * BK, f + n0);
        }
      }
    }
  } else {  // consumer warpgroup wg, warp wq of it; rows g, g + 8 of the warp's 16
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const int xr = 64 * wg;  // this warpgroup's first row in the tile
    float acc_a[BN / 2], acc_b[BN / 2];
    int it = 0;  // stages consumed so far, over all tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BM;
      pcm::zero(acc_a);
      pcm::zero(acc_b);
      pcm::reg_fence(acc_a);
      pcm::reg_fence(acc_b);
      for (int kt = 0; kt < n; ++kt, ++it) {
        const int s = it % STAGES;
        pcm::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t xs = sbase + s * STAGE_BYTES, was = xs + X_BYTES, wbs = was + W_BYTES;
        pcm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = pcm::desc_kmajor<BM, BK>(xs, xr, kk);
          pcm::wg::mma_ss(acc_a, da, pcm::desc_kmajor<BN, BK>(was, 0, kk), 1);
          pcm::wg::mma_ss(acc_b, da, pcm::desc_kmajor<BN, BK>(wbs, 0, kk), 1);
        }
        pcm::wg_commit();
        pcm::wg_wait<1>();  // the products of the step before are done: its stage is free
        if (kt > 0) pcm::release(&empty[(it - 1) % STAGES], lane);
      }
      pcm::wg_wait<0>();
      pcm::reg_fence(acc_a);
      pcm::reg_fence(acc_b);
      pcm::release(&empty[(it - 1) % STAGES], lane);

      // bias, gate and product; rows g (entries 0, 1 of each 4) and g + 8
      const int row0 = m0 + xr + 16 * wq + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= f) continue;
        const __nv_bfloat162 ba = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + f + col);
        const float2 fa = __bfloat1622float2(ba), fb = __bfloat1622float2(bb);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row >= m) continue;
          const int e = 4 * j + 2 * r;
          const float y0 = (acc_a[e] + fa.x) * gelu_erf(acc_b[e] + fb.x);
          const float y1 = (acc_a[e + 1] + fa.y) * gelu_erf(acc_b[e + 1] + fb.y);
          *reinterpret_cast<uint32_t*>(out + (int64_t)row * f + col) = pcm::pack_bf16x2(y0, y1);
        }
      }
    }
  }
}

}  // namespace

// x: contiguous (m, k) bf16; w: contiguous (2f, k) bf16; bias: (2f,) bf16;
// out: contiguous (m, f) bf16. k and f multiples of 8, pointers 16-byte aligned.
extern "C" int pcm_geglu(const void* x, const void* w, const void* bias, void* out, int m,
                         int k, int f, void* stream) {
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t wdims[2] = {(cuuint64_t)k, 2 * (cuuint64_t)f};
  const cuuint64_t row_bytes[1] = {(cuuint64_t)k * 2};
  const cuuint32_t xbox[2] = {BK, BM}, wbox[2] = {BK, BN};
  if (!(pcm::tensor_map(&tx, x, 2, xdims, row_bytes, xbox) &&
        pcm::tensor_map(&tw, w, 2, wdims, row_bytes, wbox)))
    return cudaErrorInvalidPitchValue;  // cuTensorMapEncodeTiled refused a tensor map
  const cudaError_t allowed = pcm::allow_smem(geglu_kernel, SMEM_BYTES);  // once a device
  if (allowed != cudaSuccess) return allowed;
  const int tiles = ((f + BN - 1) / BN) * ((m + BM - 1) / BM);
  geglu_kernel<<<std::min(tiles, pcm::sm_count()), THREADS, SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, k, f);
  return cudaGetLastError();
}
