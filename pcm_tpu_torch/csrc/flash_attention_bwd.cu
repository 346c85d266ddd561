// Flash attention backward for Hopper (sm_90a): a dK/dV kernel and a dQ
// kernel, bf16 in and out, fp32 accumulation, TMA loads into a ring of
// shared-memory stages and wgmma products.
//
// Replaces: pcm_tpu/ops/flash_attention.py:201 `_bwd_dkv_kernel` (K2) and
// :259 `_bwd_dq_kernel` (K3), the two Pallas bodies launched by `_bwd`. Both
// recompute the probabilities from the forward's base-2 logsumexp:
//   P  = exp2(Q K^T * alpha - lse)            alpha = scale * log2 e
//   dS = P o (dO V^T - delta) * scale         delta = rowsum(dO o O), from the wrapper
//   dV = P^T dO,  dK = dS^T Q                 (K2: per k tile, looping over q tiles)
//   dQ = dS K                                 (K3: per q tile, looping over k tiles)
// P and dS are rounded to bf16 before their products, as the Pallas kernels
// cast them to the input dtype. The split into two kernels keeps every output
// owned by one block: no atomics, so dQ/dK/dV are bit-identical run to run.
//
// Bound on this card: operations. K2 does 4 products of 2 sq sk d per (b, h)
// (S, dP, dV, dK), K3 three (S, dP, dQ); at the SD1.5/SDXL training shapes
// that is tensor-core work, far above the bytes each input needs.
//
// Design, one path for every head dim (d <= 160, a multiple of 8; SD1.5
// runs 40, 80, 160 and SDXL 64, all through wgmma):
// - Tiles are copied by TMA (tensor maps built on the host with
//   cuTensorMapEncodeTiled of the CUDA driver API, passed as
//   __grid_constant__) into shared memory as column chunks of 16 bf16 (32
//   bytes, SWIZZLE_32B). The TMA zero-fills d up to a multiple of 16 (48 for
//   d = 40; 96/128/160 above 80) and rows beyond sq / sk. 16 columns is
//   wgmma's K step, so the padding costs no product beyond the K16 rounding
//   any bf16 tensor-core product pays.
// - A block is two consumer warpgroups and a producer warpgroup (setmaxnreg:
//   232 registers a consumer thread, 40 a producer one), whose first warp
//   issues every copy. K2 holds K and V of its k rows and streams Q and dO of
//   each q step through a ring of 3 stages (full / empty mbarriers per stage),
//   the warp's lanes adding the step's lse / delta (a row offset of b*h*sq is
//   not 16-byte aligned, as a TMA box needs); K3 holds Q and dO (each thread
//   its rows' lse / delta) and streams K and V.
// - S^T = K Q^T and dP^T = V dO^T (K2), S = Q K^T and dP = dO V^T (K3) take
//   both operands K-major from shared memory (wgmma SS). P^T and dS^T (K2),
//   dS (K3) are formed in the accumulator registers and reused as the
//   register A operand of dV += P^T dO, dK += dS^T Q, dQ += dS K (wgmma RS);
//   there B is the dO, Q or K tile read MN-major through wgmma's transpose
//   flag, so no transposed copy exists anywhere.
// - Each product is its own commit group: a warpgroup issues the next step's
//   scores while this step's dV / dK (dQ) products run, and the two
//   warpgroups fill each other's gaps on the tensor cores. Register fences pin
//   the zeroed accumulators and the repacked fragments, so that no other
//   instruction defines a wgmma's registers while one is in flight; where
//   that happens, ptxas serializes every wgmma of the kernel (its C7513 /
//   C7515 notes). K3 waits for both score products before its exponentials
//   and is free of it; K2 computes P^T while its dP^T product runs and keeps
//   C7513: waiting as K3 does removes the note but needs more registers than
//   168 a thread, and spills (PERF.md, section 6).
// - K2: a warpgroup owns 64 k rows; above d = 80 the dK / dV columns are
//   split over the two warpgroups (WD = 2), which then share 64 k rows and
//   each recompute S / dP. Where a warpgroup's dK and dV are 80 columns wide
//   (d = 80, 160) a q step is 32 rows (64 elsewhere), and K3 above d = 96
//   takes 32-row k steps (64 elsewhere), so that the scores and the
//   accumulators fit the registers without a spill. K3: a warpgroup owns 64
//   q rows.
// - Short key sequences (cross-attention, sk = 77) give K2 few blocks; the
//   host then splits the q range over blocks (`nsplit`), each writes fp32
//   partial dK / dV, and a second kernel sums them in split order
//   (deterministic) into bf16.
// Ragged edges: rows beyond sq (K2) and keys beyond sk (K3) are selected to
// 0 in P / dS before any contraction (their lse / delta are 0 or another
// row's, never used); rows of the block's own tile beyond the sequence are
// computed on zeros and never written.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pcm::SW;

constexpr int NWG = 2;           // consumer warpgroups of a block
constexpr int THREADS = 128 * (NWG + 1);  // + a producer warpgroup
constexpr int STAGES = 3;
// setmaxnreg budgets (2 x 128 x 232 + 128 x 40 <= 65536): without them ptxas
// holds every thread of a three-warpgroup block to 168 registers, and K2 at
// d = 64 spills
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// K2's P^T in place of the scores S^T of a step: q column c (this thread's
// 8 j + 2 t + (e & 1)) reads Ls[c] and is 0 at c >= lim when MASK.
template <bool MASK, int R>
__device__ __forceinline__ void k2_probs(float (&s)[R], const float* Ls, float alpha, int lim,
                                         int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float p = pcm::exp2_approx(s[4 * j + e] * alpha - Ls[c]);
      s[4 * j + e] = !MASK || c < lim ? p : 0.f;
    }
}

// K2's dS^T = P^T o (dP^T - delta) * scale in place of dP^T.
template <bool MASK, int R>
__device__ __forceinline__ void k2_dscores(float (&dp)[R], const float (&p)[R], const float* Ds,
                                           float scale, int lim, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float ds = p[4 * j + e] * (dp[4 * j + e] - Ds[c]) * scale;
      dp[4 * j + e] = !MASK || c < lim ? ds : 0.f;
    }
}

// K3's dS = P o (dP - delta) * scale in place of dP, P = exp2(S alpha - lse)
// from the scores; rows g (lrow[0], drow[0]) and g + 8; k column c is 0 at
// c >= lim when MASK.
template <bool MASK, int R>
__device__ __forceinline__ void k3_dscores(float (&dp)[R], const float (&s)[R],
                                           const float (&lrow)[2], const float (&drow)[2],
                                           float alpha, float scale, int lim, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
      const float p = pcm::exp2_approx(s[4 * j + e] * alpha - lrow[r]);
      const float ds = p * (dp[4 * j + e] - drow[r]) * scale;
      dp[4 * j + e] = !MASK || c < lim ? ds : 0.f;
    }
}

// ---------------------------------------------------------------------------
// K2: dK, dV. One block per (k tile of BK rows, b*h, q split); walks the
// split's q steps of BQ rows.
// ---------------------------------------------------------------------------

template <int D_PAD, int WD, int BQ_>
struct DkvCfg {
  static constexpr int BQ = BQ_, BK = 64 * NWG / WD, NCH = D_PAD / SW, NV = D_PAD / WD;
  static constexpr int KV_BYTES = NCH * BK * SW * 2;  // one of K, V
  static constexpr int QT_BYTES = NCH * BQ * SW * 2;  // one of Q, dO
  static constexpr uint32_t STAGE_TX = 2 * QT_BYTES;  // TMA bytes; lse, delta by the warp
  static constexpr int STAGE_BYTES = pcm::round_up(STAGE_TX + 2 * BQ * 4, 1024);
  static constexpr int BAR_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t smem_bytes = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(NV % SW == 0, "a warpgroup's output columns are whole chunks");
};

template <int D_PAD, int WD, int BQ_>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                     int h, int sq, int sk, int d, int steps_per_split, int64_t n_out,
                     float alpha, float scale) {
  using C = DkvCfg<D_PAD, WD, BQ_>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int k0 = blockIdx.x * BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int n = max(0, min((sq + BQ - 1) / BQ, s_begin + steps_per_split) - s_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pcm::mbar_init(&full[s], 1 + 32);    // the TMA's expect_tx + the warp's lse / delta
      pcm::mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    pcm::mbar_init(kvbar, 1);
    pcm::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer warpgroup: its first warp issues every copy
    pcm::reg_dealloc<PRODUCER_REGS>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        pcm::tma_prefetch_desc(&tq);
        pcm::tma_prefetch_desc(&tdo);
        pcm::mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          pcm::tma_load_4d(smem + c * BK * SW * 2, &tk, kvbar, c * SW, hi, k0, bi);
          pcm::tma_load_4d(smem + C::KV_BYTES + c * BK * SW * 2, &tv, kvbar, c * SW, hi, k0, bi);
        }
      }
      const float* lb = lse + (int64_t)bh * sq;
      const float* db = delta + (int64_t)bh * sq;
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES, q0 = (s_begin + it) * BQ;
        pcm::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + 2 * C::KV_BYTES + s * C::STAGE_BYTES;
        if (lane == 0) {
          pcm::mbar_expect_tx(&full[s], C::STAGE_TX);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            pcm::tma_load_4d(st + c * BQ * SW * 2, &tq, &full[s], c * SW, hi, q0, bi);
            pcm::tma_load_4d(st + C::QT_BYTES + c * BQ * SW * 2, &tdo, &full[s], c * SW, hi,
                             q0, bi);
          }
        }
        // lse / delta of the step's rows (0 beyond sq), by the whole warp: a
        // row offset of b*h*sq is not 16-byte aligned for a TMA box in general
        float* Ls = reinterpret_cast<float*>(st + 2 * C::QT_BYTES);
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
          const bool ok = q0 + c < sq;
          Ls[c] = ok ? lb[q0 + c] : 0.f;
          Ls[BQ + c] = ok ? db[q0 + c] : 0.f;
        }
        pcm::mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroup wg, warp wq of it; rows g, g + 8 of the warp's 16
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const int kr = (wg / WD) * 64;     // this warpgroup's first k row in the tile
    const int c0 = (wg % WD) * C::NV;  // and its first output column
    float adk[C::NV / 2], adv[C::NV / 2], sacc[BQ / 2], dpacc[BQ / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    pcm::zero(adk);
    pcm::zero(adv);
    pcm::reg_fence(adk);
    pcm::reg_fence(adv);
    auto stage = [&](int it) { return sbase + 2 * C::KV_BYTES + (it % STAGES) * C::STAGE_BYTES; };
    // S^T = K Q^T and dP^T = V dO^T of step it (64 k rows x BQ q columns),
    // one commit group each
    auto issue_scores = [&](int it) {
      pcm::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      const uint32_t qs = stage(it), os = qs + C::QT_BYTES;
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        pcm::wg::mma_ss(sacc, pcm::desc_kmajor<BK>(sbase, kr, kk),
                        pcm::desc_kmajor<BQ>(qs, 0, kk), kk > 0);
      pcm::wg_commit();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        pcm::wg::mma_ss(dpacc, pcm::desc_kmajor<BK>(sbase + C::KV_BYTES, kr, kk),
                        pcm::desc_kmajor<BQ>(os, 0, kk), kk > 0);
      pcm::wg_commit();
    };

    pcm::mbar_wait(kvbar, 0);
    if (n > 0) issue_scores(0);
    for (int it = 0; it < n; ++it) {
      const int q0 = (s_begin + it) * BQ;
      const uint32_t qs = stage(it), os = qs + C::QT_BYTES;
      const float* Ls = reinterpret_cast<const float*>(smem + (qs - sbase) + 2 * C::QT_BYTES);
      const float* Ds = Ls + BQ;
      // S of this step is done, and every product of the step before: its
      // stage is free. dP may still run.
      pcm::wg_wait<1>();
      pcm::reg_fence(sacc);
      if (it > 0) pcm::release(&empty[(it - 1) % STAGES], lane);

      // P^T (q columns beyond sq are 0), then dV += P^T dO on this warpgroup's columns
      const bool whole = q0 + BQ <= sq;
      if (whole)
        k2_probs<false>(sacc, Ls, alpha, sq - q0, t);
      else
        k2_probs<true>(sacc, Ls, alpha, sq - q0, t);
      pcm::to_a(pa, sacc);
      pcm::reg_fence(pa);
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        pcm::wg::mma_rs(adv, pa[kk], pcm::desc_mnmajor<BQ>(os, c0, kk), 1);
      pcm::wg_commit();

      // dS^T once dP is done (dV may still run), then dK += dS^T Q
      pcm::wg_wait<1>();
      pcm::reg_fence(dpacc);
      if (whole)
        k2_dscores<false>(dpacc, sacc, Ds, scale, sq - q0, t);
      else
        k2_dscores<true>(dpacc, sacc, Ds, scale, sq - q0, t);
      pcm::to_a(da, dpacc);
      pcm::reg_fence(da);
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        pcm::wg::mma_rs(adk, da[kk], pcm::desc_mnmajor<BQ>(qs, c0, kk), 1);
      pcm::wg_commit();
      if (it + 1 < n) issue_scores(it + 1);  // overlaps this step's dV / dK
    }
    pcm::wg_wait<0>();
    pcm::reg_fence(adv);
    pcm::reg_fence(adk);
    if (n > 0) pcm::release(&empty[(n - 1) % STAGES], lane);

    // dk, dv: fresh contiguous (b, sk, h, d), or this split's fp32 partials
    const int64_t base = ((int64_t)bi * sk * h + hi) * d;
    const int row0 = k0 + kr + 16 * wq + g;
    float* pk = part == nullptr ? nullptr : part + (int64_t)blockIdx.z * 2 * n_out;
    pcm::store_rows(dk, pk, adk, base, row0, sk, h, d, c0, t);
    pcm::store_rows(dv, pk == nullptr ? nullptr : pk + n_out, adv, base, row0, sk, h, d, c0, t);
  }
}

// Sum of the q splits' fp32 partials (nsplit x {dK, dV} x n_out), in split
// order, into bf16 dk and dv.
__global__ void dkv_reduce_kernel(const float* __restrict__ part, int nsplit, int64_t n_out,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 2;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 2; i < n_out; i += stride) {
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    for (int z = 0; z < nsplit; ++z) {
      const float2 x = *reinterpret_cast<const float2*>(part + (2 * z) * n_out + i);
      const float2 y = *reinterpret_cast<const float2*>(part + (2 * z + 1) * n_out + i);
      a.x += x.x;
      a.y += x.y;
      b.x += y.x;
      b.y += y.y;
    }
    *reinterpret_cast<uint32_t*>(dk + i) = pcm::pack_bf16x2(a.x, a.y);
    *reinterpret_cast<uint32_t*>(dv + i) = pcm::pack_bf16x2(b.x, b.y);
  }
}

// ---------------------------------------------------------------------------
// K3: dQ. One block per (q tile of BQ rows, b*h); walks the k steps of BK rows.
// ---------------------------------------------------------------------------

template <int D_PAD, int BK_>
struct DqCfg {
  static constexpr int BQ = 64 * NWG, BK = BK_, NCH = D_PAD / SW;
  static constexpr int QT_BYTES = NCH * BQ * SW * 2;  // one of Q, dO
  static constexpr int KT_BYTES = NCH * BK * SW * 2;  // one of K, V
  static constexpr uint32_t STAGE_TX = 2 * KT_BYTES;
  static constexpr int STAGE_BYTES = pcm::round_up(STAGE_TX, 1024);
  static constexpr int BAR_OFF = 2 * QT_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t smem_bytes = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

template <int D_PAD, int BK_>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk, int d, float alpha,
                    float scale) {
  using C = DqCfg<D_PAD, BK_>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = pcm::align1024(smem_raw);
  const uint32_t sbase = pcm::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qobar = empty + STAGES;

  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int n = (sk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pcm::mbar_init(&full[s], 1);
      pcm::mbar_init(&empty[s], 4 * NWG);
    }
    pcm::mbar_init(qobar, 1);
    pcm::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer warpgroup: one thread issues every copy
    pcm::reg_dealloc<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      pcm::tma_prefetch_desc(&tk);
      pcm::tma_prefetch_desc(&tv);
      pcm::mbar_expect_tx(qobar, 2 * C::QT_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        pcm::tma_load_4d(smem + c * BQ * SW * 2, &tq, qobar, c * SW, hi, q0, bi);
        pcm::tma_load_4d(smem + C::QT_BYTES + c * BQ * SW * 2, &tdo, qobar, c * SW, hi, q0, bi);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        pcm::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + 2 * C::QT_BYTES + s * C::STAGE_BYTES;
        pcm::mbar_expect_tx(&full[s], C::STAGE_TX);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          pcm::tma_load_4d(st + c * BK * SW * 2, &tk, &full[s], c * SW, hi, it * BK, bi);
          pcm::tma_load_4d(st + C::KT_BYTES + c * BK * SW * 2, &tv, &full[s], c * SW, hi,
                           it * BK, bi);
        }
      }
    }
  } else {  // consumer warpgroup wg, warp wq of it
    pcm::reg_alloc<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
    const int qr = 64 * wg;  // this warpgroup's first q row in the tile
    // lse / delta of rows g and g + 8 of this warp; 0 beyond sq
    float lrow[2], drow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + qr + 16 * wq + g + 8 * r;
      lrow[r] = row < sq ? lse[(int64_t)bh * sq + row] : 0.f;
      drow[r] = row < sq ? delta[(int64_t)bh * sq + row] : 0.f;
    }
    float acc[D_PAD / 2], sacc[BK / 2], dpacc[BK / 2];
    uint32_t da[BK / 16][4];
    pcm::zero(acc);
    pcm::reg_fence(acc);
    auto stage = [&](int it) { return sbase + 2 * C::QT_BYTES + (it % STAGES) * C::STAGE_BYTES; };
    // S = Q K^T and dP = dO V^T of step it (64 q rows x BK k columns), one
    // commit group each
    auto issue_scores = [&](int it) {
      pcm::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      const uint32_t ks = stage(it), vs = ks + C::KT_BYTES;
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        pcm::wg::mma_ss(sacc, pcm::desc_kmajor<BQ>(sbase, qr, kk),
                        pcm::desc_kmajor<BK>(ks, 0, kk), kk > 0);
      pcm::wg_commit();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        pcm::wg::mma_ss(dpacc, pcm::desc_kmajor<BQ>(sbase + C::QT_BYTES, qr, kk),
                        pcm::desc_kmajor<BK>(vs, 0, kk), kk > 0);
      pcm::wg_commit();
    };

    pcm::mbar_wait(qobar, 0);
    issue_scores(0);  // sk >= 1: at least one step
    for (int it = 0; it < n; ++it) {
      const int k0 = it * BK;
      // S and dP of this step are done, and the dQ product of the step
      // before: its stage is free.
      pcm::wg_wait<0>();
      pcm::reg_fence(sacc);
      pcm::reg_fence(dpacc);
      if (it > 0) pcm::release(&empty[(it - 1) % STAGES], lane);

      // dS (k columns beyond sk are 0), then dQ += dS K
      if (k0 + BK <= sk)
        k3_dscores<false>(dpacc, sacc, lrow, drow, alpha, scale, sk - k0, t);
      else
        k3_dscores<true>(dpacc, sacc, lrow, drow, alpha, scale, sk - k0, t);
      pcm::to_a(da, dpacc);
      pcm::reg_fence(da);
      pcm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pcm::wg::mma_rs(acc, da[kk], pcm::desc_mnmajor<BK>(stage(it), 0, kk), 1);
      pcm::wg_commit();
      if (it + 1 < n) issue_scores(it + 1);  // overlaps this step's dQ product
    }
    pcm::wg_wait<0>();
    pcm::reg_fence(acc);
    pcm::release(&empty[(n - 1) % STAGES], lane);

    // dq: fresh contiguous (b, sq, h, d)
    pcm::store_rows(dq, nullptr, acc, ((int64_t)bi * sq * h + hi) * d, q0 + qr + 16 * wq + g, sq,
               h, d, 0, t);
  }
}

// ---------------------------------------------------------------------------
// host: launches (tensor maps from hopper.cuh)
// ---------------------------------------------------------------------------

struct Args {  // what both entry points take
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int b, h, sq, sk, d;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float alpha, scale;
  cudaStream_t stream;
};

template <int D_PAD, int WD, int BQ>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv, float* part, int nsplit) {
  using C = DkvCfg<D_PAD, WD, BQ>;
  CUtensorMap tq, tk, tv, tdo;
  if (!(pcm::map_bshd(&tq, a.q, a.b, a.sq, a.h, a.d, a.qsb, a.qss, a.qsh, C::BQ) &&
        pcm::map_bshd(&tdo, a.dout, a.b, a.sq, a.h, a.d, a.osb, a.oss, a.osh, C::BQ) &&
        pcm::map_bshd(&tk, a.k, a.b, a.sk, a.h, a.d, a.ksb, a.kss, a.ksh, C::BK) &&
        pcm::map_bshd(&tv, a.v, a.b, a.sk, a.h, a.d, a.vsb, a.vss, a.vsh, C::BK)))
    return cudaErrorInvalidPitchValue;  // cuTensorMapEncodeTiled refused a tensor map
  auto kern = flash_bwd_dkv_kernel<D_PAD, WD, BQ>;
  const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once a device
  cudaError_t err = allowed;
  if (err != cudaSuccess) return err;
  const int nsteps = (a.sq + C::BQ - 1) / C::BQ;
  const int per = (nsteps + nsplit - 1) / nsplit;
  const int64_t n_out = (int64_t)a.b * a.sk * a.h * a.d;
  dim3 grid((a.sk + C::BK - 1) / C::BK, a.b * a.h, nsplit);
  kern<<<grid, THREADS, C::smem_bytes, a.stream>>>(tq, tk, tv, tdo, a.lse, a.delta, dk, dv,
                                                   nsplit > 1 ? part : nullptr, a.h, a.sq, a.sk,
                                                   a.d, per, n_out, a.alpha, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int blocks = (int)std::min<int64_t>((n_out / 2 + 255) / 256, 4096);
  dkv_reduce_kernel<<<blocks, 256, 0, a.stream>>>(part, nsplit, n_out, dk, dv);
  return cudaGetLastError();
}

template <int D_PAD, int BK>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  using C = DqCfg<D_PAD, BK>;
  CUtensorMap tq, tk, tv, tdo;
  if (!(pcm::map_bshd(&tq, a.q, a.b, a.sq, a.h, a.d, a.qsb, a.qss, a.qsh, C::BQ) &&
        pcm::map_bshd(&tdo, a.dout, a.b, a.sq, a.h, a.d, a.osb, a.oss, a.osh, C::BQ) &&
        pcm::map_bshd(&tk, a.k, a.b, a.sk, a.h, a.d, a.ksb, a.kss, a.ksh, C::BK) &&
        pcm::map_bshd(&tv, a.v, a.b, a.sk, a.h, a.d, a.vsb, a.vss, a.vsh, C::BK)))
    return cudaErrorInvalidPitchValue;
  auto kern = flash_bwd_dq_kernel<D_PAD, BK>;
  const cudaError_t allowed = pcm::allow_smem(kern, C::smem_bytes);  // once a device
  cudaError_t err = allowed;
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.b * a.h);
  kern<<<grid, THREADS, C::smem_bytes, a.stream>>>(tq, tk, tv, tdo, a.lse, a.delta,
                                                   dq, a.h, a.sq, a.sk, a.d, a.alpha, a.scale);
  return cudaGetLastError();
}

}  // namespace

// q, dO: (b, sq, h, d) bf16; k, v: (b, sk, h, d) bf16; unit stride along d,
// other strides in elements and multiples of 8, 16-byte aligned bases; d a
// multiple of 8, <= 160. lse (base 2) and delta: contiguous (b, h, sq) fp32.
// dk, dv: contiguous (b, sk, h, d) bf16. alpha = scale * log2 e. nsplit >= 1
// splits the q range over blocks; above 1, ``part`` is fp32 scratch of
// nsplit * 2 * b * sk * h * d elements.
extern "C" int pcm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* part, int b, int h, int sq, int sk, int d,
    int nsplit, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh, float alpha,
    float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               b, h, sq, sk, d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
               alpha, scale, static_cast<cudaStream_t>(stream)};
  if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
  auto DK = static_cast<bf16*>(dk);
  auto DV = static_cast<bf16*>(dv);
  auto P = static_cast<float*>(part);
  // (d_pad, column split, q step): 32-row q steps where a warpgroup owns 80
  // output columns, so that the scores and both accumulators fit its registers
#define PCM_DKV(DP, WD, BQ) return launch_dkv<DP, WD, BQ>(a, DK, DV, P, nsplit)
  if (d <= 16) PCM_DKV(16, 1, 64);
  if (d <= 32) PCM_DKV(32, 1, 64);
  if (d <= 48) PCM_DKV(48, 1, 64);
  if (d <= 64) PCM_DKV(64, 1, 64);
  if (d <= 80) PCM_DKV(80, 1, 32);
  if (d <= 96) PCM_DKV(96, 2, 64);
  if (d <= 128) PCM_DKV(128, 2, 64);
  if (d <= 160) PCM_DKV(160, 2, 32);
#undef PCM_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same inputs as pcm_flash_attention_bwd_dkv; dq: contiguous (b, sq, h, d) bf16.
extern "C" int pcm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int h, int sq, int sk, int d, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
    int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh, float alpha,
    float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               b, h, sq, sk, d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
               alpha, scale, static_cast<cudaStream_t>(stream)};
  auto DQ = static_cast<bf16*>(dq);
  // (d_pad, k step): 32-row k steps at d_pad 128 and 160 for the registers
#define PCM_DQ(DP, BK) return launch_dq<DP, BK>(a, DQ)
  if (d <= 16) PCM_DQ(16, 64);
  if (d <= 32) PCM_DQ(32, 64);
  if (d <= 48) PCM_DQ(48, 64);
  if (d <= 64) PCM_DQ(64, 64);
  if (d <= 80) PCM_DQ(80, 64);
  if (d <= 96) PCM_DQ(96, 64);
  if (d <= 128) PCM_DQ(128, 32);
  if (d <= 160) PCM_DQ(160, 32);
#undef PCM_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
