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
// The VAE's single 512-wide head (one launch a decode, serving only) runs the
// mma.sync kernel at the end of this file: a 16 x 512 fp32 accumulator does
// not fit one warp's registers, so head_dim is split over WD = 2 warps, each
// computing the (same) scores of its 16 rows and owning 256 output columns; 8
// warps, a 64-row q tile and 32-key tiles, with synchronous loads and V stored
// transposed in shared memory.
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
  static const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once an instance
  if (allowed != cudaSuccess) return allowed;
  const int tiles = (sq + C::BQ - 1) / C::BQ * b * h;
  kern<<<std::min(tiles, pcm::sm_count()), THREADS, C::smem_bytes, stream>>>(
      tq, tk, tv, o, lse, h, sq, sk, d, tiles, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim 512 (the VAE's mid-block): mma.sync m16n8k16, synchronous loads
// ---------------------------------------------------------------------------

template <int D_PAD, int NWARPS, int BK, int WD>
struct MmaCfg {
  static constexpr int BQ = 16 * NWARPS / WD;
  static constexpr int QP = D_PAD + 8;  // bf16 pitch of Q and K rows in smem
  static constexpr int VP = BK + 8;     // bf16 pitch of V^T rows in smem
  static constexpr int NT = D_PAD / 8 / WD;  // n8 output tiles of one warp
  static constexpr int KT = D_PAD / 16; // k16 steps of Q K^T
  static constexpr int ST = BK / 8;     // n8 tiles of one score block
  static constexpr int PT = BK / 16;    // k16 steps of P V
  static constexpr size_t smem_bytes = (size_t)(BQ + BK) * QP * 2 + (size_t)D_PAD * VP * 2;
};

template <int D_PAD, int NWARPS, int BK, int WD>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int sk, int d,
                     int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                     int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float alpha) {
  using C = MmaCfg<D_PAD, NWARPS, BK, WD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + C::BQ * C::QP;
  bf16* Vt = Ks + BK * C::QP;

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * C::BQ;
  const bf16* qb = q + bi * qsb + hi * qsh;
  const bf16* kb = k + bi * ksb + hi * ksh;
  const bf16* vb = v + bi * vsb + hi * vsh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  constexpr int NVEC = D_PAD / 8;  // 16-byte vectors per smem row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < C::BQ * NVEC; i += 32 * NWARPS) {
    const int r = i / NVEC, c = (i % NVEC) * 8;
    uint4 val = zero;
    if (q0 + r < sq && c < d)
      val = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * qss + c);
    *reinterpret_cast<uint4*>(Qs + r * C::QP + c) = val;
  }

  const int wrow = (warp / WD) * 16;  // this warp's first row within the q tile
  const int col0 = (warp % WD) * C::NT * 8;  // and its first output column
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[C::NT][4];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * NVEC; i += 32 * NWARPS) {
      const int r = i / NVEC, c = (i % NVEC) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < sk && c < d) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + r) * kss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + r) * vss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * C::QP + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * C::VP + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the BK keys of the tile
    float s[C::ST][4];
#pragma unroll
    for (int j = 0; j < C::ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KT; ++kk) {
      const bf16* qr = Qs + (wrow + g) * C::QP + kk * 16 + 2 * t;
      uint32_t a[4] = {pcm::ld32(qr), pcm::ld32(qr + 8 * C::QP), pcm::ld32(qr + 8),
                       pcm::ld32(qr + 8 * C::QP + 8)};
#pragma unroll
      for (int j = 0; j < C::ST; ++j) {
        const bf16* kr = Ks + (j * 8 + g) * C::QP + kk * 16 + 2 * t;
        uint32_t b[2] = {pcm::ld32(kr), pcm::ld32(kr + 8)};
        pcm::mma_bf16_16816(s[j], a, b);
      }
    }

    // online softmax in the exp2 domain; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < C::ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float val = col < sk ? s[j][e] * alpha : kNegInf;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    // per-thread partial row sums; the 4 lanes of a row are summed at the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];

    uint32_t pa[C::PT][4];
#pragma unroll
    for (int kk = 0; kk < C::PT; ++kk) {
      pa[kk][0] = pcm::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pcm::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pcm::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pcm::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O = O * corr + P V over this warp's head_dim tiles that hold real columns
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      float* c = acc[nt];
      c[0] *= corr[0]; c[1] *= corr[0]; c[2] *= corr[1]; c[3] *= corr[1];
      if (col0 + nt * 8 >= d) continue;
#pragma unroll
      for (int kk = 0; kk < C::PT; ++kk) {
        const bf16* vr = Vt + (col0 + nt * 8 + g) * C::VP + kk * 16 + 2 * t;
        uint32_t b[2] = {pcm::ld32(vr), pcm::ld32(vr + 8)};
        pcm::mma_bf16_16816(c, pa[kk], b);
      }
    }
  }

  float inv[2], lsafe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lsafe[r] = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / lsafe[r];
  }
  const int row0 = q0 + wrow + g, row1 = row0 + 8;
  // o is a fresh contiguous (b, sq, h, d) tensor
  bf16* ob = o + ((int64_t)bi * sq * h + hi) * d;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    if (col >= d) continue;
    const float* c = acc[nt];
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row0 * h * d + col) =
          pcm::pack_bf16x2(c[0] * inv[0], c[1] * inv[0]);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row1 * h * d + col) =
          pcm::pack_bf16x2(c[2] * inv[1], c[3] * inv[1]);
  }
  if (t == 0 && col0 == 0) {
    float* lb = lse + ((int64_t)bi * h + hi) * sq;
    if (row0 < sq) lb[row0] = m[0] + log2f(lsafe[0]);
    if (row1 < sq) lb[row1] = m[1] + log2f(lsafe[1]);
  }
}

template <int D_PAD, int NWARPS, int BK, int WD>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                       int b, int h, int sq, int sk, int d, const int64_t* st, float alpha,
                       cudaStream_t stream) {
  using C = MmaCfg<D_PAD, NWARPS, BK, WD>;
  auto kern = flash_fwd_mma_kernel<D_PAD, NWARPS, BK, WD>;
  static const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once an instance
  if (allowed != cudaSuccess) return allowed;
  dim3 grid((sq + C::BQ - 1) / C::BQ, b * h);
  kern<<<grid, 32 * NWARPS, C::smem_bytes, stream>>>(
      q, k, v, o, lse, h, sq, sk, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], alpha);
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
  if (d <= 512) return launch_mma<512, 8, 32, 2>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  return static_cast<int>(cudaErrorInvalidValue);
}
