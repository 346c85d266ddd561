// Fused int8 matmul with activation quantization per (row, K-tile):
//   out[m, n] = bf16( ws[n] * sum_t float(xq_t[m] . wq[n, t]) * s_t[m] )
// where, for each K-tile t of bk columns, s_t[m] = max|x[m, t]| * fl(1/127)
// (1 when the max is 0) and xq_t = clip(rint(x[m, t] / s_t[m]), -127, 127) in
// int8. (The JAX kernel writes amax / 127.0; XLA compiles that into the
// product with the fp32 reciprocal, and this is the function it computes.)
//
// Replaces: pcm_tpu/ops/int8_matmul.py `_kernel` (launched by
// `fused_quantized_dot`). As there, the product reads the int8 weight (half
// the bf16 bytes) and the activations are quantized per (row, K-tile). The
// K-tile bk is part of the numerics, not a tiling choice: the caller passes
// `_pick_block(K, 512, 128)`. The fp32 sum runs over the K-tiles in order and
// rounds each term as `part * s` and then `acc + term` (__fmul_rn/__fadd_rn:
// no FMA contraction), x / s is the IEEE quotient (see `quotient`) and the
// rounding is half to even, so the kernels compute what the plain version does.
//
// Bound on this card: device-memory bytes at K = N = 320 (a 1x1 conv over
// 16384 pixels: ~21 MB moved for 3.4 GOP), int8 tensor-core throughput at
// the wide SDXL feed-forward shapes (K 1280 -> N 10240: 107 GOP).
//
// Design: two kernels behind one call.
// - A quantize pass, one warp per (row, K-tile): the lanes hold the tile's
//   bf16 values in registers (bk <= 1024: four 16-byte loads a lane at most),
//   reduce the max by shuffles and write the int8 codes (M, K) and the scale,
//   laid out (K / bk, M) so that a block's scales of one K-tile are
//   contiguous. x is read once; a GEMM that quantized inside its blocks would
//   quantize each x tile once per N block (80 times at N = 10240). The codes
//   cost M K bytes written and read once per N block, against 2 M K bytes of
//   bf16 x read as often. The division, the rounding and the conversion to
//   int8 run on the FP32 pipe (quotient, quant4), not on quarter-rate
//   instructions.
// - A persistent TMA + wgmma GEMM over 128 x 128 output tiles, N fastest (the
//   blocks resident together share their code rows in L2): a producer
//   warpgroup (setmaxnreg 40) whose first thread keeps a ring of stages in
//   flight, each the 128 x CB code chunk and the 128 x CB weight chunk of one
//   K step (TMA with the CB-byte swizzle, zero fill beyond M, N; 192 KB of
//   ring), and two consumer warpgroups (setmaxnreg 232) of 64 rows each.
//   CB is the widest swizzle row that divides bk (128 bytes; 64 at bk = 320;
//   32 for other multiples of 32), so a chunk never straddles two K-tiles.
//   Both operands are K-major as 8-bit wgmma needs: the codes (M, K) and the
//   nn.Linear weight (N, K) as they lie in memory.
// - A K-tile's chunks run as wgmma m64n128k32 s8 x s8 -> s32 into an int32
//   part that restarts at zero (scale-d 0) on the tile's first K step: exact,
//   since bk * 127^2 < 2^31, and exactly representable in fp32 (< 2^24). At
//   most three chunks are in flight, each stage released as its products end:
//   a K-tile may have more chunks than the ring has stages (bk = 960, 15
//   chunks of 64 bytes, in SD1.5's 960 -> 640 shortcut convs).
//   After the K-tile's products are waited, the part is folded, acc +=
//   float(part) * s: CUDA-core work while the other warpgroup's products run
//   (the two drift apart and fill each other's gaps). 64 int32 + 64 fp32
//   registers a thread. A second part, to overlap the fold with the same
//   warpgroup's next products, needs 192 registers live across the fold:
//   with the epilogue below ptxas spilled ~1 KB and the GEMM ran 1.5-2.5x
//   slower on an H100 SXM; explicit turns of the two warpgroups (named
//   barriers) ran 5-20 % slower than letting them drift.
// - Epilogue: ws[n] (copied to shared memory at the tile's start) on the
//   accumulator, bf16 pairs written to a staging tile in shared memory (two
//   64 x 64 boxes a warpgroup, 128-byte swizzle) and stored by the TMA, which
//   clips rows >= M and columns >= N, while the next tile's products run.
//   Stored from registers straight to device memory, the epilogue held the
//   tensor cores idle for 20-40 % of the GEMM's time on an H100 SXM (the
//   output is the larger part of the bytes at small K: 335 MB at (32768,
//   640, 5120)).
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float RECIP_127 = 0x1.020408p-7f;  // fl(1/127)

// ---------------------------------------------------------------------------
// the quantize pass
// ---------------------------------------------------------------------------

constexpr int Q_WARPS = 8;  // warps of a quantize block, one (row, K-tile) each
constexpr int MAX_VEC = 4;  // 16-byte loads a lane: bk <= 4 * 32 * 8 = 1024

constexpr float ROUND = 12582912.f;  // 1.5 * 2^23: its ulp is 1

// x / s rounded to nearest, as __fdiv_rn gives it. With FAST (s within
// [2^-100, 2^100]), from r = fl(1/s), taken once a (row, K-tile): q0 = fl(x r)
// and one Markstein correction, fl(q0 + fl(x - q0 s) r), two FMAs on the
// FP32 pipe. For bf16 x and |x| <= 127 s this is the correctly rounded
// quotient: checked in exact arithmetic over every bf16 significand of x and
// of the tile's max and 21 binades of x below the max, where nothing else
// moves the rounding; below, |x / s| < 1e-4 gives code 0 either way
// (tests/test_torch_int8.py). __fdiv_rn spends a quarter-rate reciprocal on
// every element.
template <bool FAST>
__device__ __forceinline__ float quotient(float x, float s, float r) {
  if constexpr (FAST) {
    const float q0 = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q0, s, x), r, q0);
  } else {
    return __fdiv_rn(x, s);
  }
}

// Four bf16 -> four int8 codes packed little-endian. Adding 1.5 * 2^23 to
// x / s rounds it half to even onto the integers (|x / s| <= 127 + 2^-16, far
// below 2^22), the clamp to +-127 is taken on the sum, and the sum's low byte
// is the code in two's complement: the rounding and the conversion run on the
// FP32 pipe, where rintf and a float -> int conversion are quarter-rate.
template <bool FAST>
__device__ __forceinline__ uint32_t quant4(const bf16* e, float s, float r) {
  uint32_t b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q = __fadd_rn(quotient<FAST>(__bfloat162float(e[j]), s, r), ROUND);
    b[j] = __float_as_uint(fminf(fmaxf(q, ROUND - 127.f), ROUND + 127.f));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// The codes of a lane's values: vector i holds columns (32 i + lane) * 8 ...
template <bool FAST>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint4 (&v)[MAX_VEC], int bk,
                                            int lane, float s) {
  const float r = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int c = (32 * i + lane) * 8;
    if (c >= bk) break;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
    *reinterpret_cast<uint2*>(dst + c) =
        make_uint2(quant4<FAST>(e, s, r), quant4<FAST>(e + 4, s, r));
  }
}

__global__ void __launch_bounds__(32 * Q_WARPS)
int8_matmul_quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                            float* __restrict__ sx, int m, int k, int bk) {
  const int ktiles = k / bk, lane = threadIdx.x % 32;
  const int64_t w = (int64_t)blockIdx.x * Q_WARPS + threadIdx.x / 32;
  if (w >= (int64_t)m * ktiles) return;
  const int row = (int)(w / ktiles), t = (int)(w % ktiles);
  const int64_t off = (int64_t)row * k + (int64_t)t * bk;
  uint4 v[MAX_VEC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int c = (32 * i + lane) * 8;
    if (c >= bk) break;
    v[i] = *reinterpret_cast<const uint4*>(x + off + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, sh));
  const float s = amax > 0.f ? __fmul_rn(amax, RECIP_127) : 1.f;
  if (s >= 0x1p-100f && s <= 0x1p100f)  // the warp's branch
    store_codes<true>(xq + off, v, bk, lane, s);
  else
    store_codes<false>(xq + off, v, bk, lane, s);
  if (lane == 0) sx[(int64_t)t * m + row] = s;
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

constexpr int NWG = 2;                    // consumer warpgroups of a block
constexpr int THREADS = 128 * (NWG + 1);  // + a producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int BM = 64 * NWG, BN = 128;
constexpr int RING_BYTES = 192 * 1024;
constexpr int OUT_BOX = 64;                             // columns and rows of a TMA store box
constexpr int OUT_WG_BYTES = 64 * BN * 2;               // a warpgroup's bf16 rows: two boxes
constexpr int OUT_BOX_BYTES = OUT_BOX * OUT_BOX * 2;

template <int CB>  // bytes of a chunk row: 128, 64 or 32
struct GemmCfg {
  static constexpr int X_BYTES = BM * CB, W_BYTES = BN * CB;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;  // 6, 12 or 24
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;  // the output tile, staged
  static constexpr int WS_OFF = OUT_OFF + NWG * OUT_WG_BYTES;  // the tile's ws, per warpgroup
  static constexpr int BAR_OFF = WS_OFF + NWG * BN * 4;
  static constexpr size_t smem_bytes = BAR_OFF + 2 * STAGES * 8 + 1024;
  static constexpr int KSTEPS = CB / 32;  // m64n128k32 products of a chunk
  static constexpr int CW = CB / 2;       // the chunk in bf16 columns (descriptors)
  static_assert(X_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
};

template <int CB>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap to, const float* __restrict__ sx,
                        const float* __restrict__ ws, int m, int n, int k, int bk) {
  using C = GemmCfg<CB>;
  constexpr int STAGES = C::STAGES;
  const int tiles_n = (n + BN - 1) / BN, tiles = tiles_n * ((m + BM - 1) / BM);
  const int ktiles = k / bk, cpt = bk / CB;  // K-tiles, chunks of a K-tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
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
      const int chunks = k / CB;
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BM;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % STAGES;
          pcm::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * C::STAGE_BYTES;
          pcm::mbar_expect_tx(&full[s], C::STAGE_BYTES);
          pcm::tma_load_2d(st, &tx, &full[s], c * CB, m0);
          pcm::tma_load_2d(st + C::X_BYTES, &tw, &full[s], c * CB, n0);
        }
      }
    }
  } else {  // consumer warpgroup wg, warp wq of it; rows g, g + 8 of the warp's 16
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
    unsigned char* stage_out = smem + C::OUT_OFF + wg * OUT_WG_BYTES;
    float* ws_tile = reinterpret_cast<float*>(smem + C::WS_OFF) + wg * BN;
    float acc[BN / 2];
    int part[BN / 2];  // a K-tile's exact int32 products
    int it = 0;        // stages consumed so far, over all tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BM;
      const int row0 = m0 + 64 * wg + 16 * wq + g;
      pcm::zero(acc);
      ws_tile[threadIdx.x % 128] =  // the tile's ws[n], for its epilogue
          n0 + threadIdx.x % 128 < n ? __ldg(ws + n0 + threadIdx.x % 128) : 0.f;

      for (int kt = 0; kt < ktiles; ++kt) {
        float s[2];  // the K-tile's scales of rows g, g + 8
#pragma unroll
        for (int r = 0; r < 2; ++r)
          s[r] = row0 + 8 * r < m ? __ldg(sx + (int64_t)kt * m + row0 + 8 * r) : 1.f;
        // the K-tile's chunks, the part restarted on its first K step
        for (int c = 0; c < cpt; ++c, ++it) {
          const int st = it % STAGES;
          pcm::mbar_wait(&full[st], (it / STAGES) & 1);
          const uint32_t xs = sbase + st * C::STAGE_BYTES, wsm = xs + C::X_BYTES;
          pcm::wg_fence();
#pragma unroll
          for (int kk = 0; kk < C::KSTEPS; ++kk)
            pcm::wg::mma_ss(part, pcm::desc_kmajor<BM, C::CW>(xs, 64 * wg, kk),
                            pcm::desc_kmajor<BN, C::CW>(wsm, 0, kk), (c | kk) != 0);
          pcm::wg_commit();
          if (c >= 2) {  // at most three chunks in flight
            pcm::wg_wait<2>();
            pcm::release(&empty[(it - 2) % STAGES], lane);
          }
        }
        pcm::wg_wait<0>();
        for (int c = cpt < 2 ? cpt : 2; c >= 1; --c) pcm::release(&empty[(it - c) % STAGES], lane);
        pcm::reg_fence(part);
        // acc += float(part) * s, rounded as two operations
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(__int2float_rn(part[i]), s[(i >> 1) & 1]));
      }

      // out = bf16(acc * ws[n]), staged in shared memory as two 64 x 64 boxes
      // (128-byte swizzle: conflict-free writes) and stored by the TMA while
      // the next tile's products run; rows g (entries 0, 1 of each 4), g + 8
      if (leader) pcm::bulk_wait<0, true>();  // the last tile's stores have read it
      pcm::named_sync(1 + wg, 128);
      // row 16 wq + g + 8 r of a box, 16-byte chunk j ^ g (the swizzle: row %
      // 8 == g), word t; row_g holds g in the chunk bits 4-6 of the address,
      // and an XOR with j puts chunk j ^ g there
      const uint32_t row_g = pcm::smem_u32(stage_out) + (16 * wq + g) * 128 + (g << 4) + 4 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(ws_tile + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pcm::st_shared((row_g + (j / 8) * OUT_BOX_BYTES + r * 8 * 128) ^ ((j % 8) << 4),
                         pcm::pack_bf16x2(__fmul_rn(acc[4 * j + 2 * r], w.x),
                                          __fmul_rn(acc[4 * j + 2 * r + 1], w.y)));
      }
      pcm::fence_proxy_async();
      pcm::named_sync(1 + wg, 128);
      const int r0 = m0 + 64 * wg;
      if (leader && r0 < m) {
        for (int b = 0; b < BN / OUT_BOX && n0 + b * OUT_BOX < n; ++b)
          pcm::tma_store_2d(&to, stage_out + b * OUT_BOX_BYTES, n0 + b * OUT_BOX, r0);
        pcm::bulk_commit();
      }
    }
    if (leader) pcm::bulk_wait<0, false>();  // every store has landed
  }
}

template <int CB>
cudaError_t launch_gemm(const int8_t* xq, const int8_t* w, const float* sx, const float* ws,
                        bf16* out, int m, int n, int k, int bk, cudaStream_t stream) {
  using C = GemmCfg<CB>;
  CUtensorMap tx, tw, to;
  const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t wdims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t odims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t row_bytes[1] = {(cuuint64_t)k}, out_row_bytes[1] = {(cuuint64_t)n * 2};
  const cuuint32_t xbox[2] = {CB, BM}, wbox[2] = {CB, BN}, obox[2] = {OUT_BOX, OUT_BOX};
  if (!(pcm::tensor_map(&tx, xq, 2, xdims, row_bytes, xbox, true) &&
        pcm::tensor_map(&tw, w, 2, wdims, row_bytes, wbox, true) &&
        pcm::tensor_map(&to, out, 2, odims, out_row_bytes, obox)))
    return cudaErrorInvalidPitchValue;  // cuTensorMapEncodeTiled refused a tensor map
  auto kern = int8_matmul_gemm_kernel<CB>;
  const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once a device
  if (allowed != cudaSuccess) return allowed;
  const int tiles = ((n + BN - 1) / BN) * ((m + BM - 1) / BM);
  kern<<<std::min(tiles, pcm::sm_count()), THREADS, C::smem_bytes, stream>>>(
      tx, tw, to, sx, ws, m, n, k, bk);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (m, k) bf16; w: contiguous (n, k) int8 (the nn.Linear layout);
// ws: (n,) fp32; out: contiguous (m, n) bf16; xq: (m, k) int8 and sx: (k / bk,
// m) fp32 scratch for the codes and scales. bk divides k, bk % 32 == 0,
// bk <= 1024; n % 8 == 0; pointers 16-byte aligned.
extern "C" int pcm_int8_matmul(const void* x, const void* w, const void* ws, void* out,
                               void* xq, void* sx, int m, int n, int k, int bk, void* stream) {
  auto S = static_cast<cudaStream_t>(stream);
  auto XQ = static_cast<int8_t*>(xq);
  auto SX = static_cast<float*>(sx);
  const int64_t warps = (int64_t)m * (k / bk);
  int8_matmul_quantize_kernel<<<(unsigned)((warps + Q_WARPS - 1) / Q_WARPS), 32 * Q_WARPS, 0,
                                S>>>(static_cast<const bf16*>(x), XQ, SX, m, k, bk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto W = static_cast<const int8_t*>(w);
  auto WS = static_cast<const float*>(ws);
  auto O = static_cast<bf16*>(out);
  if (bk % 128 == 0) return launch_gemm<128>(XQ, W, SX, WS, O, m, n, k, bk, S);
  if (bk % 64 == 0) return launch_gemm<64>(XQ, W, SX, WS, O, m, n, k, bk, S);
  return launch_gemm<32>(XQ, W, SX, WS, O, m, n, k, bk, S);
}
