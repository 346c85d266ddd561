// Flash attention backward for Hopper (sm_90a): a dK/dV kernel and a dQ
// kernel, bf16 in and out, fp32 accumulation.
//
// Replaces: pcm_tpu/ops/flash_attention.py `_bwd_dkv_kernel` (K2) and
// `_bwd_dq_kernel` (K3), the two Pallas bodies launched by `_bwd`. Both
// recompute the probabilities from the forward's base-2 logsumexp:
//   P  = exp2(Q K^T * alpha - lse)            alpha = scale * log2 e
//   dS = P o (dO V^T - delta) * scale         delta = rowsum(dO o O), from the wrapper
//   dV = P^T dO,  dK = dS^T Q                 (K2: per k tile, looping over q tiles)
//   dQ = dS K                                 (K3: per q tile, looping over k tiles)
// P and dS are rounded to bf16 before their products, as the Pallas kernels
// cast them to the input dtype. The split into two kernels keeps every output
// owned by one block: no atomics, so dQ/dK/dV are bit-identical run to run.
//
// Ragged edges: rows beyond sq (K2) and keys beyond sk (K3) are zero in shared
// memory, their lse/delta are loaded as 0 (a garbage lse never reaches exp2),
// and P / dS of those rows (K2) or columns (K3) are selected to 0, so no
// inf or NaN can enter a contraction. Rows of the block's own tile beyond
// the sequence are computed on zeros and never written.
//
// Bound on this card: like the forward, both kernels are tensor-core work at
// the SD1.5 training shapes (4 products per score tile in K2, 3 in K3, plus
// one exp2 per score). Loads are synchronous, as in the forward.
//
// Design, reusing the forward's pieces (common.cuh mma.sync m16n8k16 bf16,
// head_dim zero-padded to a multiple of 16 in shared memory only, inputs read
// through their (b, s, h, d) strides): each warp owns 16 rows of the block's
// tile. The score-shaped products take both operands row-major from shared
// memory; the products that contract over the score axis take the score
// fragment from registers (C layout -> A layout in place, as the forward's
// P V) and the other operand from a transposed copy in shared memory. K2
// holds two fp32 accumulators (dK, dV) per row: at head_dim 160 that is too
// many registers for one warp, so head_dim is split over WD = 2 warps, which
// each recompute the same scores and own half of the output columns (the
// forward's d = 512 scheme).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // elements; (batch, seq, head) of q, k, v and dO
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ROWS x D_PAD tile of a (seq, d) slice starting at row r0: rows >= n and
// columns >= d are zero. Written row-major (pitch P) and, when dst_t is given,
// transposed (dst_t[c * PT + r]).
template <int ROWS, int D_PAD, int NTH>
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, bf16* dst_t, int pitch_t,
                                          const bf16* src, int64_t rs, int r0, int n,
                                          int d, int tid) {
  constexpr int NVEC = D_PAD / 8;  // 16-byte vectors per row
  for (int i = tid; i < ROWS * NVEC; i += NTH) {
    const int r = i / NVEC, c = (i % NVEC) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n && c < d)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * pitch_t + r] = e[j];
    }
  }
}

// A fragment (16 x 16, row-major) of the warp's rows at column kk * 16.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base, int pitch, int g,
                                       int t, int kk) {
  const bf16* r = base + g * pitch + kk * 16 + 2 * t;
  a[0] = pcm::ld32(r);
  a[1] = pcm::ld32(r + 8 * pitch);
  a[2] = pcm::ld32(r + 8);
  a[3] = pcm::ld32(r + 8 * pitch + 8);
}

// B fragment (16 x 8) from an n-major tile: rows n0..n0+7, columns kk*16..+15.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* base, int pitch, int n0,
                                       int g, int t, int kk) {
  const bf16* r = base + (n0 + g) * pitch + kk * 16 + 2 * t;
  b[0] = pcm::ld32(r);
  b[1] = pcm::ld32(r + 8);
}

// Score-shaped C fragments (n8 tiles) -> bf16 A fragments over the score axis.
template <int ST>
__device__ __forceinline__ void to_a(uint32_t out[ST / 2][4], const float c[ST][4]) {
#pragma unroll
  for (int kk = 0; kk < ST / 2; ++kk) {
    out[kk][0] = pcm::pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    out[kk][1] = pcm::pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    out[kk][2] = pcm::pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    out[kk][3] = pcm::pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Row-major 16-row fp32 accumulator of a warp -> bf16 rows of a contiguous
// (b, s, h, d) output; rows >= n and padded columns are not written.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, const float acc[NT][4], int row0,
                                           int n, int h, int d, int col0, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    if (col >= d) continue;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out + (int64_t)row0 * h * d + col) =
          pcm::pack_bf16x2(acc[nt][0], acc[nt][1]);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(out + (int64_t)row1 * h * d + col) =
          pcm::pack_bf16x2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// K2: dK, dV. One block per (k tile of BK rows, b*h); loops over q tiles.
// ---------------------------------------------------------------------------

template <int D_PAD, int NWARPS, int BQ, int WD>
struct DkvCfg {
  static constexpr int BK = 16 * NWARPS / WD;
  static constexpr int P = D_PAD + 8;   // bf16 pitch of row-major tiles
  static constexpr int PT = BQ + 8;     // bf16 pitch of the transposed Q / dO tiles
  static constexpr int NT = D_PAD / 8 / WD;
  static constexpr size_t smem_bytes =
      (size_t)(2 * BK + 2 * BQ) * P * 2 + (size_t)2 * D_PAD * PT * 2 + (size_t)2 * BQ * 4;
};

template <int D_PAD, int NWARPS, int BQ, int WD>
__global__ void __launch_bounds__(32 * NWARPS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int sq, int sk,
                     int d, Strides st, float alpha, float scale) {
  using C = DkvCfg<D_PAD, NWARPS, BQ, WD>;
  constexpr int NTH = 32 * NWARPS, KT = D_PAD / 16, ST = BQ / 8, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::BK * C::P;
  bf16* Qs = Vs + C::BK * C::P;
  bf16* Os = Qs + BQ * C::P;      // dO
  bf16* Qt = Os + BQ * C::P;      // Q^T
  bf16* Ot = Qt + D_PAD * C::PT;  // dO^T
  float* Ls = reinterpret_cast<float*>(Ot + D_PAD * C::PT);
  float* Ds = Ls + BQ;

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int k0 = blockIdx.x * C::BK;
  const bf16* qb = q + bi * st.qb + hi * st.qh;
  const bf16* kb = k + bi * st.kb + hi * st.kh;
  const bf16* vb = v + bi * st.vb + hi * st.vh;
  const bf16* ob = dout + bi * st.ob + hi * st.oh;
  const float* lb = lse + ((int64_t)bi * h + hi) * sq;
  const float* db = delta + ((int64_t)bi * h + hi) * sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp / WD) * 16;         // this warp's first k row in the tile
  const int col0 = (warp % WD) * NT * 8;     // and its first output column

  load_tile<C::BK, D_PAD, NTH>(Ks, C::P, nullptr, 0, kb, st.ks, k0, sk, d, tid);
  load_tile<C::BK, D_PAD, NTH>(Vs, C::P, nullptr, 0, vb, st.vs, k0, sk, d, tid);

  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous q tile is no longer read
    load_tile<BQ, D_PAD, NTH>(Qs, C::P, Qt, C::PT, qb, st.qs, q0, sq, d, tid);
    load_tile<BQ, D_PAD, NTH>(Os, C::P, Ot, C::PT, ob, st.os, q0, sq, d, tid);
    for (int i = tid; i < BQ; i += NTH) {
      const bool ok = q0 + i < sq;
      Ls[i] = ok ? lb[q0 + i] : 0.f;
      Ds[i] = ok ? db[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k rows x BQ q columns
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks + wrow * C::P, C::P, g, t, kk);
      load_a(av, Vs + wrow * C::P, C::P, g, t, kk);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t b[2];
        load_b(b, Qs, C::P, j * 8, g, t, kk);
        pcm::mma_bf16_16816(s[j], ak, b);
        load_b(b, Os, C::P, j * 8, g, t, kk);
        pcm::mma_bf16_16816(dp[j], av, b);
      }
    }

    // P^T and dS^T; q columns beyond sq are 0 in both
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const bool ok = q0 + col < sq;
        const float p = ok ? exp2f(s[j][e] * alpha - Ls[col]) : 0.f;
        dp[j][e] = ok ? p * (dp[j][e] - Ds[col]) * scale : 0.f;
        s[j][e] = p;
      }
    uint32_t pa[ST / 2][4], da[ST / 2][4];
    to_a<ST>(pa, s);
    to_a<ST>(da, dp);

    // dV += P^T dO, dK += dS^T Q over this warp's head_dim columns
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (col0 + nt * 8 >= d) continue;
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t b[2];
        load_b(b, Ot, C::PT, col0 + nt * 8, g, t, kk);
        pcm::mma_bf16_16816(adv[nt], pa[kk], b);
        load_b(b, Qt, C::PT, col0 + nt * 8, g, t, kk);
        pcm::mma_bf16_16816(adk[nt], da[kk], b);
      }
    }
  }

  // dk, dv: fresh contiguous (b, sk, h, d)
  const int64_t off = ((int64_t)bi * sk * h + hi) * d;
  store_rows<NT>(dk + off, adk, k0 + wrow + g, sk, h, d, col0, t);
  store_rows<NT>(dv + off, adv, k0 + wrow + g, sk, h, d, col0, t);
}

// ---------------------------------------------------------------------------
// K3: dQ. One block per (q tile of 16 * NWARPS rows, b*h); loops over k tiles.
// ---------------------------------------------------------------------------

template <int D_PAD, int NWARPS, int BK>
struct DqCfg {
  static constexpr int BQ = 16 * NWARPS;
  static constexpr int P = D_PAD + 8;
  static constexpr int PT = BK + 8;  // pitch of the transposed K tile
  static constexpr size_t smem_bytes =
      (size_t)(2 * BQ + 2 * BK) * P * 2 + (size_t)D_PAD * PT * 2;
};

template <int D_PAD, int NWARPS, int BK>
__global__ void __launch_bounds__(32 * NWARPS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk, int d, Strides st,
                    float alpha, float scale) {
  using C = DqCfg<D_PAD, NWARPS, BK>;
  constexpr int NTH = 32 * NWARPS, KT = D_PAD / 16, ST = BK / 8, NT = D_PAD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + C::BQ * C::P;  // dO
  bf16* Ks = Os + C::BQ * C::P;
  bf16* Vs = Ks + BK * C::P;
  bf16* Kt = Vs + BK * C::P;     // K^T

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * C::BQ;
  const bf16* qb = q + bi * st.qb + hi * st.qh;
  const bf16* kb = k + bi * st.kb + hi * st.kh;
  const bf16* vb = v + bi * st.vb + hi * st.vh;
  const bf16* ob = dout + bi * st.ob + hi * st.oh;
  const float* lb = lse + ((int64_t)bi * h + hi) * sq;
  const float* db = delta + ((int64_t)bi * h + hi) * sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  load_tile<C::BQ, D_PAD, NTH>(Qs, C::P, nullptr, 0, qb, st.qs, q0, sq, d, tid);
  load_tile<C::BQ, D_PAD, NTH>(Os, C::P, nullptr, 0, ob, st.os, q0, sq, d, tid);
  // rows g (r = 0) and g + 8 (r = 1) of this warp; 0 beyond sq
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    lrow[r] = row < sq ? lb[row] : 0.f;
    drow[r] = row < sq ? db[row] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous k tile is no longer read
    load_tile<BK, D_PAD, NTH>(Ks, C::P, Kt, C::PT, kb, st.ks, k0, sk, d, tid);
    load_tile<BK, D_PAD, NTH>(Vs, C::P, nullptr, 0, vb, st.vs, k0, sk, d, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x BK k columns
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, Qs + wrow * C::P, C::P, g, t, kk);
      load_a(ao, Os + wrow * C::P, C::P, g, t, kk);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t b[2];
        load_b(b, Ks, C::P, j * 8, g, t, kk);
        pcm::mma_bf16_16816(s[j], aq, b);
        load_b(b, Vs, C::P, j * 8, g, t, kk);
        pcm::mma_bf16_16816(dp[j], ao, b);
      }
    }

    // dS; k columns beyond sk are 0
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p = exp2f(s[j][e] * alpha - lrow[r]);
        dp[j][e] = col < sk ? p * (dp[j][e] - drow[r]) * scale : 0.f;
      }
    uint32_t da[ST / 2][4];
    to_a<ST>(da, dp);

    // dQ += dS K
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 >= d) continue;
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t b[2];
        load_b(b, Kt, C::PT, nt * 8, g, t, kk);
        pcm::mma_bf16_16816(acc[nt], da[kk], b);
      }
    }
  }

  // dq: fresh contiguous (b, sq, h, d)
  store_rows<NT>(dq + ((int64_t)bi * sq * h + hi) * d, acc, q0 + wrow + g, sq, h, d, 0, t);
}

template <int D_PAD, int NWARPS, int BQ, int WD>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int b,
                       int h, int sq, int sk, int d, const Strides& st, float alpha,
                       float scale, cudaStream_t stream) {
  using C = DkvCfg<D_PAD, NWARPS, BQ, WD>;
  auto kern = flash_bwd_dkv_kernel<D_PAD, NWARPS, BQ, WD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + C::BK - 1) / C::BK, b * h);
  kern<<<grid, 32 * NWARPS, C::smem_bytes, stream>>>(q, k, v, o, lse, delta, dk, dv, h, sq,
                                                      sk, d, st, alpha, scale);
  return cudaGetLastError();
}

template <int D_PAD, int NWARPS, int BK>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const float* lse, const float* delta, bf16* dq, int b, int h, int sq,
                      int sk, int d, const Strides& st, float alpha, float scale,
                      cudaStream_t stream) {
  using C = DqCfg<D_PAD, NWARPS, BK>;
  auto kern = flash_bwd_dq_kernel<D_PAD, NWARPS, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + C::BQ - 1) / C::BQ, b * h);
  kern<<<grid, 32 * NWARPS, C::smem_bytes, stream>>>(q, k, v, o, lse, delta, dq, h, sq, sk,
                                                      d, st, alpha, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dO: (b, sq, h, d) bf16; k, v: (b, sk, h, d) bf16; unit stride along d,
// other strides in elements and multiples of 8; d a multiple of 8, <= 160.
// lse (base 2) and delta: contiguous (b, h, sq) fp32. dk, dv: contiguous
// (b, sk, h, d) bf16. alpha = scale * log2 e.
extern "C" int pcm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int h, int sq, int sk, int d,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
    float alpha, float scale, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto D = static_cast<const float*>(delta);
  auto DK = static_cast<bf16*>(dk);
  auto DV = static_cast<bf16*>(dv);
  auto S = static_cast<cudaStream_t>(stream);
#define PCM_DKV(DP, NW, BQ, WD) \
  return launch_dkv<DP, NW, BQ, WD>(Q, K, V, O, L, D, DK, DV, b, h, sq, sk, d, st, alpha, scale, S)
  if (d <= 16) PCM_DKV(16, 4, 64, 1);
  if (d <= 32) PCM_DKV(32, 4, 64, 1);
  if (d <= 48) PCM_DKV(48, 4, 64, 1);
  if (d <= 64) PCM_DKV(64, 4, 64, 1);
  if (d <= 80) PCM_DKV(80, 4, 64, 1);
  if (d <= 128) PCM_DKV(128, 4, 64, 2);
  if (d <= 160) PCM_DKV(160, 4, 64, 2);
#undef PCM_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same arguments as pcm_flash_attention_bwd_dkv; dq: contiguous (b, sq, h, d) bf16.
extern "C" int pcm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int h, int sq, int sk, int d, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
    int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh, float alpha,
    float scale, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto D = static_cast<const float*>(delta);
  auto DQ = static_cast<bf16*>(dq);
  auto S = static_cast<cudaStream_t>(stream);
#define PCM_DQ(DP, NW, BK) \
  return launch_dq<DP, NW, BK>(Q, K, V, O, L, D, DQ, b, h, sq, sk, d, st, alpha, scale, S)
  if (d <= 16) PCM_DQ(16, 4, 64);
  if (d <= 32) PCM_DQ(32, 4, 64);
  if (d <= 48) PCM_DQ(48, 4, 64);
  if (d <= 64) PCM_DQ(64, 4, 64);
  if (d <= 80) PCM_DQ(80, 4, 64);
  if (d <= 128) PCM_DQ(128, 4, 32);
  if (d <= 160) PCM_DQ(160, 4, 32);
#undef PCM_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
