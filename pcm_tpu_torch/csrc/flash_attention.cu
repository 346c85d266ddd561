// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax and
// accumulation, bf16 out plus a base-2 logsumexp.
//
// Replaces: pcm_tpu/ops/flash_attention.py:105 `_fwd_kernel` (the Pallas body
// launched by `_fwd`, `pallas_call` at :165). It computes the same thing:
// softmax(Q K^T * scale) V with an online softmax in the exp2 domain (alpha =
// scale * log2 e folded into the score scaling), running max / sum /
// accumulator in fp32, the l == 0 guard, and lse = m + log2(l) per (b, h, q)
// for the backward kernels. Edge key blocks are masked twice, as the Pallas
// kernel does: scores of keys >= sk become -1e30, and the V rows of those
// keys are zero in shared memory, so no stale value can reach the P V
// product.
//
// Bound on this card: operations. Two products of 2 sq sk d per (b, h)
// (S = Q K^T, O = P V), tensor-core work far above the bytes of q, k, v and o
// at the self-attention shapes (sq = sk = 256..4096); at sk = 77
// (cross-attention) the bytes of q and o weigh as much.
//
// Design, every head dim <= 160 (SD1.5 40/80/160, SDXL 64, the tiny 16/32):
// - Persistent blocks, one an SM, walk the tiles of 128 q rows of one (b, h)
//   (q tiles of a (b, h) next to each other, so that the blocks resident
//   together share K and V in L2). A block is two consumer warpgroups of 64
//   rows and a producer warpgroup (setmaxnreg: 232 registers a consumer
//   thread, 40 a producer one) whose first thread issues every copy: each
//   tile's Q into one of two buffers, then the K and V tiles of each key step
//   into a ring of 3 stages (a full and an empty mbarrier per stage and per Q
//   buffer). The ring runs on across tiles, so the next tile's Q, K and V
//   land while this tile's last product and its epilogue run; at sk = 77
//   (cross-attention: one key step a tile) that overlap is most of the gain.
// - Copies are TMA loads (tensor maps from hopper.cuh, read through the
//   (b, s, h, d) strides, cached by their inputs) into column chunks of the
//   widest swizzle that divides d_pad: 64 columns (128 bytes a row) at
//   d_pad 64 and 128, 32 at 32, 96 and 160, 16 at 16, 48 and 80. Fewer,
//   wider rows keep the TMA's request count down. The TMA zero-fills d up
//   to d_pad (48 for d = 40) and rows beyond sq / sk, so no padded copy
//   exists in device memory.
// - S = Q K^T is wgmma SS, both operands K-major (Q's rows, K's rows). The
//   online softmax turns S into P in the accumulator registers, which become
//   the register A operand of O += P V (wgmma RS); V is read MN-major from
//   its (s, d) TMA tile through the transpose flag, so no transposed copy of
//   V exists.
// - A warpgroup issues S of step i and then P V of step i - 1, and computes
//   the softmax of step i while that P V product runs; the other warpgroup
//   fills the tensor cores' remaining gaps. Register fences pin the zeroed
//   accumulator and the repacked P, so that no other instruction defines a
//   wgmma's registers while it is in flight.
// - Key steps are 128 keys where the accumulator is at most 64 columns wide
//   and 64 above, so that the scores, P and the accumulator fit the registers
//   (`fwd_tiles` in ops/flash_attention.py mirrors the dispatch).
// - o is stored from the accumulator (rows < sq, columns < d), lse by one
//   thread of each row: lse rows start at b*h*sq, not 16-byte aligned for a
//   TMA box.
//
// head_dim 512, the VAE mid-block's single head (SD1.5 at 512 px: (4, 4096,
// 4096, 1, 512), one launch a decode; SDXL at 1024 px: 16384 tokens): the
// same ring, TMA and wgmma, on 64 q rows a block.
// - A 64 x 512 fp32 accumulator is 256 registers a thread for one
//   warpgroup: the head is split over the two consumer warpgroups, each
//   owning 256 output columns (64 x 256, 128 registers).
// - The scores are computed once, split over d: each warpgroup takes the
//   partial S over its own 256 columns of Q and K (wgmma SS, both K-major),
//   writes it to a 64 x BK fp32 exchange buffer and adds the other's,
//   thread for thread at the same fragment positions (a named barrier per
//   warp pair, two a step). fp32 addition commutes, so both hold the same
//   S, run the same online softmax and feed P from registers to their own
//   half of P V (wgmma RS, V read MN-major through the transpose flag: no
//   transposed copy of V).
// - Shared memory sets the key step: Q alone is 64 KB (one buffer; the next
//   tile's Q lands while this tile's last P V and its epilogue run), a K or
//   V tile BK KB. K and V have separate rings, so that K of the next step
//   loads while P V of this one runs: 32-key steps in two stages each (208
//   KB with the exchange buffer). 64-key steps fit one stage each (224 KB)
//   but need more than the 232 registers a consumer thread has (acc 128 +
//   scores 32 + P 16): ptxas spills, and they ran 1.3x slower (D512Cfg).
// - Persistent blocks walk the 64-row tiles (256 at SD1.5's shape over 132
//   SMs); o is stored by both warpgroups from their halves, lse by the
//   first.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

constexpr int NWG = 2;                    // consumer warpgroups of a block
constexpr int THREADS = 128 * (NWG + 1);  // + a producer warpgroup
constexpr int STAGES = 3;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 2 x 128 x 232 + 128 x 40 <= 65536

template <int D_PAD, int BK_, int CW_>
struct FwdCfg {
  static constexpr int BQ = 64 * NWG, BK = BK_, CW = CW_, NCH = D_PAD / CW;
  static constexpr int Q_BYTES = NCH * BQ * CW * 2;
  static constexpr int KT_BYTES = NCH * BK * CW * 2;  // one of K, V
  static constexpr uint32_t STAGE_TX = 2 * KT_BYTES;
  static constexpr int STAGE_BYTES = pcm::round_up(STAGE_TX, 1024);
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * STAGE_BYTES;  // two Q buffers
  static constexpr size_t smem_bytes = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
};

// The online softmax of one key step in place of its scores: s * alpha (keys
// at column >= lim are -1e30 when MASK), the running max m of rows g and g +
// 8 raised over the quad's columns, s turned into P = exp2(s * alpha - m),
// the thread's partial row sums l rescaled and added to; corr is each row's
// factor for the accumulator.
template <bool MASK, int R>
__device__ __forceinline__ void online_softmax(float (&s)[R], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float alpha, int lim, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float val = !MASK || c < lim ? s[4 * j + e] * alpha : kNegInf;
      s[4 * j + e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = pcm::exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = pcm::exp2_approx(s[4 * j + e] - m[e >> 1]);
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// Rows g (entries 0, 1 of each 4) and g + 8 (entries 2, 3) of an accumulator
// times a factor each.
template <int R>
__device__ __forceinline__ void scale_rows(float (&acc)[R], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] *= f[(i >> 1) & 1];
}

template <int D_PAD, int BK_, int CW_>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int h, int sq, int sk, int d, int tiles, float alpha) {
  using C = FwdCfg<D_PAD, BK_, CW_>;
  constexpr int BQ = C::BQ, BK = C::BK, CW = C::CW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;  // two Q buffers
  uint64_t* qempty = qfull + 2;

  const int nq = (sq + BQ - 1) / BQ;  // q tiles of a (b, h); tile = bh * nq + q tile
  const int n = (sk + BK - 1) / BK;   // key steps of a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pcm::mbar_init(&full[s], 1);
      pcm::mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      pcm::mbar_init(&qfull[s], 1);
      pcm::mbar_init(&qempty[s], 4 * NWG);
    }
    pcm::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer warpgroup: one thread issues every copy
    pcm::reg_dealloc<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      pcm::tma_prefetch_desc(&tq);
      pcm::tma_prefetch_desc(&tk);
      pcm::tma_prefetch_desc(&tv);
      int it = 0;  // key steps loaded, over all tiles
      for (int tile = blockIdx.x, li = 0; tile < tiles; tile += gridDim.x, ++li) {
        const int bh = tile / nq, bi = bh / h, hi = bh % h, q0 = (tile % nq) * BQ;
        const int qb = li & 1;
        pcm::mbar_wait(&qempty[qb], ((li >> 1) & 1) ^ 1);
        pcm::mbar_expect_tx(&qfull[qb], C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          pcm::tma_load_4d(smem + qb * C::Q_BYTES + c * BQ * CW * 2, &tq, &qfull[qb], c * CW, hi,
                           q0, bi);
        for (int kt = 0; kt < n; ++kt, ++it) {
          const int s = it % STAGES;
          pcm::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + 2 * C::Q_BYTES + s * C::STAGE_BYTES;
          pcm::mbar_expect_tx(&full[s], C::STAGE_TX);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            pcm::tma_load_4d(st + c * BK * CW * 2, &tk, &full[s], c * CW, hi, kt * BK, bi);
            pcm::tma_load_4d(st + C::KT_BYTES + c * BK * CW * 2, &tv, &full[s], c * CW, hi,
                             kt * BK, bi);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg, warp wq of it; rows g, g + 8 of the warp's 16
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const int qr = 64 * wg;  // this warpgroup's first q row in the tile
    float acc[D_PAD / 2], sacc[BK / 2], m[2], l[2], corr[2];
    uint32_t pa[BK / 16][4];
    auto stage = [&](int it) { return sbase + 2 * C::Q_BYTES + (it % STAGES) * C::STAGE_BYTES; };
    // S = Q K^T of step it (64 q rows of the Q buffer at qs x BK keys), one commit group
    auto issue_scores = [&](uint32_t qs, int it) {
      pcm::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      const uint32_t ks = stage(it);
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        pcm::wg::mma_ss(sacc, pcm::desc_kmajor<BQ, CW>(qs, qr, kk),
                        pcm::desc_kmajor<BK, CW>(ks, 0, kk), kk > 0);
      pcm::wg_commit();
    };
    // O += P V of step it from the repacked P, one commit group
    auto issue_pv = [&](int it) {
      const uint32_t vs = stage(it) + C::KT_BYTES;
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pcm::wg::mma_rs(acc, pa[kk], pcm::desc_mnmajor<BK, CW>(vs, 0, kk), 1);
      pcm::wg_commit();
    };
    // the online softmax of key step kt
    auto softmax = [&](int kt) {
      const int lim = sk - kt * BK;
      if (lim >= BK)
        online_softmax<false>(sacc, m, l, corr, alpha, lim, t);
      else
        online_softmax<true>(sacc, m, l, corr, alpha, lim, t);
    };

    int it = 0;  // key steps consumed, over all tiles
    for (int tile = blockIdx.x, li = 0; tile < tiles; tile += gridDim.x, ++li, it += n) {
      const int bh = tile / nq, bi = bh / h, hi = bh % h, q0 = (tile % nq) * BQ;
      const int qb = li & 1;
      const uint32_t qs = sbase + qb * C::Q_BYTES;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      pcm::zero(acc);
      pcm::reg_fence(acc);
      pcm::mbar_wait(&qfull[qb], (li >> 1) & 1);
      issue_scores(qs, it);  // sk >= 1: at least one step
      pcm::wg_wait<0>();
      pcm::reg_fence(sacc);
      softmax(0);
      pcm::to_a(pa, sacc);
      pcm::reg_fence(pa);
      for (int kt = 1; kt < n; ++kt) {
        issue_scores(qs, it + kt);
        issue_pv(it + kt - 1);
        pcm::wg_wait<1>();  // S of step kt is done; P V of step kt - 1 may run
        pcm::reg_fence(sacc);
        softmax(kt);
        pcm::wg_wait<0>();  // P V of step kt - 1 is done: its stage is free
        pcm::reg_fence(acc);
        pcm::release(&empty[(it + kt - 1) % STAGES], lane);
        scale_rows(acc, corr);
        pcm::to_a(pa, sacc);
        pcm::reg_fence(pa);
      }
      pcm::release(&qempty[qb], lane);  // every S product of the tile is done
      issue_pv(it + n - 1);
      pcm::wg_wait<0>();
      pcm::reg_fence(acc);
      pcm::release(&empty[(it + n - 1) % STAGES], lane);

      // the quad's partial sums, then o = acc / l and lse = m + log2(l)
      float inv[2], lsafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        lsafe[r] = l[r] == 0.f ? 1.f : l[r];
        inv[r] = 1.f / lsafe[r];
      }
      scale_rows(acc, inv);
      const int row0 = q0 + qr + 16 * wq + g;
      // o: a fresh contiguous (b, sq, h, d) tensor
      pcm::store_rows(o, nullptr, acc, ((int64_t)bi * sq * h + hi) * d, row0, sq, h, d, 0, t);
      if (t == 0) {
        float* lb = lse + (int64_t)bh * sq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < sq) lb[row0 + 8 * r] = m[r] + log2f(lsafe[r]);
      }
    }
  }
}

template <int D_PAD, int BK, int CW>
cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                         int b, int h, int sq, int sk, int d, const int64_t* st, float alpha,
                         cudaStream_t stream) {
  using C = FwdCfg<D_PAD, BK, CW>;
  CUtensorMap tq, tk, tv;
  if (!(pcm::map_bshd(&tq, q, b, sq, h, d, st[0], st[1], st[2], C::BQ, CW) &&
        pcm::map_bshd(&tk, k, b, sk, h, d, st[3], st[4], st[5], BK, CW) &&
        pcm::map_bshd(&tv, v, b, sk, h, d, st[6], st[7], st[8], BK, CW)))
    return cudaErrorInvalidPitchValue;  // cuTensorMapEncodeTiled refused a tensor map
  auto kern = flash_fwd_kernel<D_PAD, BK, CW>;
  const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once a device
  if (allowed != cudaSuccess) return allowed;
  const int tiles = (sq + C::BQ - 1) / C::BQ * b * h;
  kern<<<std::min(tiles, pcm::sm_count()), THREADS, C::smem_bytes, stream>>>(
      tq, tk, tv, o, lse, h, sq, sk, d, tiles, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim 512 (the VAE's mid-block): the head split over the two warpgroups
// ---------------------------------------------------------------------------

// BK keys a step, ST stages in each of the K and V rings (64 keys in one
// stage spill 188 bytes and ran 1.3x slower on an H100 SXM).
struct D512Cfg {
  static constexpr int D = 512, HALF = D / NWG, BQ = 64, BK = 32, ST = 2, CW = 64;
  static constexpr int NCH = D / CW;                 // 128-byte chunks of a row
  static constexpr int Q_BYTES = BQ * D * 2;         // 64 KB
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int X_BYTES = NWG * BQ * BK * 4;  // both warpgroups' partial scores
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int X_OFF = V_OFF + ST * KV_BYTES, BAR_OFF = X_OFF + X_BYTES;
  static constexpr size_t smem_bytes = BAR_OFF + (4 * ST + 2) * 8 + 1024;
};

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int h, int sq, int sk, int d, int tiles,
                      float alpha) {
  using C = D512Cfg;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, CW = C::CW, HALF = C::HALF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* kempty = kfull + ST;
  uint64_t* vfull = kempty + ST;
  uint64_t* vempty = vfull + ST;
  uint64_t* qfull = vempty + ST;  // one Q buffer
  uint64_t* qempty = qfull + 1;

  const int nq = (sq + BQ - 1) / BQ;  // q tiles of a (b, h); tile = bh * nq + q tile
  const int n = (sk + BK - 1) / BK;   // key steps of a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      pcm::mbar_init(&kfull[s], 1);
      pcm::mbar_init(&vfull[s], 1);
      pcm::mbar_init(&kempty[s], 4 * NWG);  // one arrival per consumer warp
      pcm::mbar_init(&vempty[s], 4 * NWG);
    }
    pcm::mbar_init(qfull, 1);
    pcm::mbar_init(qempty, 4 * NWG);
    pcm::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer warpgroup: one thread issues every copy
    pcm::reg_dealloc<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      pcm::tma_prefetch_desc(&tq);
      pcm::tma_prefetch_desc(&tk);
      pcm::tma_prefetch_desc(&tv);
      int it = 0;  // key steps loaded, over all tiles
      for (int tile = blockIdx.x, li = 0; tile < tiles; tile += gridDim.x, ++li) {
        const int bh = tile / nq, bi = bh / h, hi = bh % h, q0 = (tile % nq) * BQ;
        pcm::mbar_wait(qempty, (li & 1) ^ 1);
        pcm::mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          pcm::tma_load_4d(smem + c * BQ * CW * 2, &tq, qfull, c * CW, hi, q0, bi);
        for (int kt = 0; kt < n; ++kt, ++it) {
          const int s = it % ST;
          const uint32_t phase = ((it / ST) & 1) ^ 1;
          unsigned char* ks = smem + C::K_OFF + s * C::KV_BYTES;
          unsigned char* vs = smem + C::V_OFF + s * C::KV_BYTES;
          pcm::mbar_wait(&kempty[s], phase);
          pcm::mbar_expect_tx(&kfull[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            pcm::tma_load_4d(ks + c * BK * CW * 2, &tk, &kfull[s], c * CW, hi, kt * BK, bi);
          pcm::mbar_wait(&vempty[s], phase);
          pcm::mbar_expect_tx(&vfull[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            pcm::tma_load_4d(vs + c * BK * CW * 2, &tv, &vfull[s], c * CW, hi, kt * BK, bi);
        }
      }
    }
  } else {  // consumer warpgroup wg (output columns 256 wg..), warp wq of it
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x % 128;
    float acc[HALF / 2], sacc[BK / 2], m[2], l[2], corr[2];
    uint32_t pa[BK / 16][4];
    // a thread's partial scores lie beside those of the thread of the other
    // warpgroup at the same fragment positions: 16-byte words, 128 apart
    float4* xmine = reinterpret_cast<float4*>(smem + C::X_OFF) + wg * (BK / 8) * 128 + tid;
    const float4* xother =
        reinterpret_cast<const float4*>(smem + C::X_OFF) + (1 - wg) * (BK / 8) * 128 + tid;
    const uint32_t qs = sbase;
    // this warpgroup's partial S = Q K^T over its 256 columns of step it
    auto issue_scores = [&](int it) {
      pcm::mbar_wait(&kfull[it % ST], (it / ST) & 1);
      const uint32_t ks = sbase + C::K_OFF + (it % ST) * C::KV_BYTES;
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk)
        pcm::wg::mma_ss(sacc, pcm::desc_kmajor<BQ, CW>(qs, 0, HALF / 16 * wg + kk),
                        pcm::desc_kmajor<BK, CW>(ks, 0, HALF / 16 * wg + kk), kk > 0);
      pcm::wg_commit();
    };
    // O[:, 256 wg..] += P V[:, 256 wg..] of step it, V read MN-major
    auto issue_pv = [&](int it) {
      pcm::mbar_wait(&vfull[it % ST], (it / ST) & 1);
      const uint32_t vs = sbase + C::V_OFF + (it % ST) * C::KV_BYTES;
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pcm::wg::mma_rs(acc, pa[kk], pcm::desc_mnmajor<BK, CW>(vs, HALF * wg, kk), 1);
      pcm::wg_commit();
    };
    // S = the two partials, summed alike in both warpgroups (fp32 addition
    // commutes), so both hold the same scores, max, sums and P
    auto exchange = [&]() {
      pcm::named_sync(1 + wq, 64);  // the other warp has read the last step's partial
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        xmine[i * 128] = make_float4(sacc[4 * i], sacc[4 * i + 1], sacc[4 * i + 2], sacc[4 * i + 3]);
      pcm::named_sync(1 + wq, 64);  // both partials are written
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float4 v = xother[i * 128];
        sacc[4 * i] += v.x;
        sacc[4 * i + 1] += v.y;
        sacc[4 * i + 2] += v.z;
        sacc[4 * i + 3] += v.w;
      }
    };
    auto softmax = [&](int kt) {
      const int lim = sk - kt * BK;
      if (lim >= BK)
        online_softmax<false>(sacc, m, l, corr, alpha, lim, t);
      else
        online_softmax<true>(sacc, m, l, corr, alpha, lim, t);
    };

    int it = 0;  // key steps consumed, over all tiles
    for (int tile = blockIdx.x, li = 0; tile < tiles; tile += gridDim.x, ++li, it += n) {
      const int bh = tile / nq, bi = bh / h, hi = bh % h, q0 = (tile % nq) * BQ;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      pcm::zero(acc);
      pcm::reg_fence(acc);
      pcm::mbar_wait(qfull, li & 1);
      issue_scores(it);  // sk >= 1: at least one step
      pcm::wg_wait<0>();
      pcm::reg_fence(sacc);
      pcm::release(&kempty[it % ST], lane);
      exchange();
      softmax(0);
      pcm::to_a(pa, sacc);
      pcm::reg_fence(pa);
      for (int kt = 1; kt < n; ++kt) {
        issue_scores(it + kt);
        issue_pv(it + kt - 1);
        pcm::wg_wait<1>();  // S of step kt is done; P V of step kt - 1 may run
        pcm::reg_fence(sacc);
        pcm::release(&kempty[(it + kt) % ST], lane);
        exchange();
        softmax(kt);
        pcm::wg_wait<0>();  // P V of step kt - 1 is done: its V stage is free
        pcm::reg_fence(acc);
        pcm::release(&vempty[(it + kt - 1) % ST], lane);
        scale_rows(acc, corr);
        pcm::to_a(pa, sacc);
        pcm::reg_fence(pa);
      }
      pcm::release(qempty, lane);  // every S product of the tile is done
      issue_pv(it + n - 1);
      pcm::wg_wait<0>();
      pcm::reg_fence(acc);
      pcm::release(&vempty[(it + n - 1) % ST], lane);

      // the quad's partial sums, then o = acc / l (this warpgroup's columns)
      // and lse = m + log2(l) (warpgroup 0)
      float inv[2], lsafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        lsafe[r] = l[r] == 0.f ? 1.f : l[r];
        inv[r] = 1.f / lsafe[r];
      }
      scale_rows(acc, inv);
      const int row0 = q0 + 16 * wq + g;
      pcm::store_rows(o, nullptr, acc, ((int64_t)bi * sq * h + hi) * d, row0, sq, h, d,
                      HALF * wg, t);
      if (wg == 0 && t == 0) {
        float* lb = lse + (int64_t)bh * sq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < sq) lb[row0 + 8 * r] = m[r] + log2f(lsafe[r]);
      }
    }
  }
}

cudaError_t launch_d512(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                        int b, int h, int sq, int sk, int d, const int64_t* st, float alpha,
                        cudaStream_t stream) {
  using C = D512Cfg;
  CUtensorMap tq, tk, tv;
  if (!(pcm::map_bshd(&tq, q, b, sq, h, d, st[0], st[1], st[2], C::BQ, C::CW) &&
        pcm::map_bshd(&tk, k, b, sk, h, d, st[3], st[4], st[5], C::BK, C::CW) &&
        pcm::map_bshd(&tv, v, b, sk, h, d, st[6], st[7], st[8], C::BK, C::CW)))
    return cudaErrorInvalidPitchValue;  // cuTensorMapEncodeTiled refused a tensor map
  auto kern = flash_fwd_d512_kernel;
  const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once a device
  if (allowed != cudaSuccess) return allowed;
  const int tiles = (sq + C::BQ - 1) / C::BQ * b * h;
  kern<<<std::min(tiles, pcm::sm_count()), THREADS, C::smem_bytes, stream>>>(
      tq, tk, tv, o, lse, h, sq, sk, d, tiles, alpha);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (b, s, h, d) bf16 with unit stride along d; strides in elements,
// each a multiple of 8, 16-byte aligned bases, d a multiple of 8 and <= 512.
// o: contiguous (b, sq, h, d) bf16; lse: contiguous (b, h, sq) fp32, base 2.
extern "C" int pcm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int b, int h, int sq,
                                       int sk, int d, int64_t qsb, int64_t qss,
                                       int64_t qsh, int64_t ksb, int64_t kss,
                                       int64_t ksh, int64_t vsb, int64_t vss,
                                       int64_t vsh, float alpha, void* stream) {
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(o);
  auto L = static_cast<float*>(lse);
  auto S = static_cast<cudaStream_t>(stream);
  // (d_pad, key step, chunk columns): 128 keys up to d_pad 64, 64 above
#define PCM_FWD(DP, BK, CW) \
  return launch_wgmma<DP, BK, CW>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S)
  if (d <= 16) PCM_FWD(16, 128, 16);
  if (d <= 32) PCM_FWD(32, 128, 32);
  if (d <= 48) PCM_FWD(48, 128, 16);
  if (d <= 64) PCM_FWD(64, 128, 64);
  if (d <= 80) PCM_FWD(80, 64, 16);
  if (d <= 96) PCM_FWD(96, 64, 32);
  if (d <= 128) PCM_FWD(128, 64, 64);
  if (d <= 160) PCM_FWD(160, 64, 32);
#undef PCM_FWD
  if (d <= 512) return launch_d512(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many TMA tensor maps this process has encoded (hopper.cuh:tensor_map's
// cache misses, for every kernel of the library).
extern "C" unsigned long long pcm_tma_encodes() { return pcm::tma_encode_count(); }
