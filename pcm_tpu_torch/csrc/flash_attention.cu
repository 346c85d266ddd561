// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax and
// accumulation, bf16 out plus a base-2 logsumexp.
//
// Replaces: pcm_tpu/ops/flash_attention.py `_fwd_kernel` (the Pallas body
// launched by `_fwd`). It computes the same thing: softmax(Q K^T * scale) V
// with an online softmax in the exp2 domain (alpha = scale * log2 e folded
// into the score scaling), running max / sum / accumulator in fp32, the
// l == 0 guard, and lse = m + log2(l) per (b, h, q) for a later backward.
// Edge key blocks are masked twice, as the Pallas kernel does: scores of
// keys >= sk become -1e30 and the V rows of those keys are zero in shared
// memory, so no stale value can reach the P V product.
//
// Bound on this card: at the SD1.5 shapes (seq 256..4096, head_dim 40..160,
// and the VAE's single head at 512) both products are tensor-core work and
// the kernel is matmul-bound; K/V are re-read once per 64-row q tile.
//
// Design: one block per (q tile, b*h). Each warp owns 16 query rows; Q, the
// current K tile and the current V tile (stored transposed) sit in shared
// memory, zero-padded along head_dim to a multiple of 16 (the k depth of a
// bf16 mma) so that head_dim 40 needs no padded copy in device memory. The
// products are mma.sync m16n8k16 bf16 with fp32 accumulation; the score
// fragment of a warp is turned into the A fragment of the P V product in
// registers. Q/K/V are read through their (b, s, h, d) strides, so the
// projections are never transposed in device memory. A 16 x 512 fp32
// accumulator does not fit one warp's registers, so head_dim is split over
// WD warps: the WD warps of a 16-row group each compute the (same) scores and
// own D_PAD / WD output columns. head_dim 512 runs 8 warps with WD = 2 (a
// 64-row q tile, 128 accumulator registers a thread) and 32-key tiles, which
// keeps Q, K and V^T within 141 KB of shared memory; the smaller head_dims run
// 4 warps with WD = 1. Loads are synchronous (no cp.async/TMA pipeline): a
// later PR's work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

template <int D_PAD, int NWARPS, int BK, int WD>
struct FaCfg {
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
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int h, int sq, int sk, int d,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                 int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float alpha) {
  using C = FaCfg<D_PAD, NWARPS, BK, WD>;
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
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   int b, int h, int sq, int sk, int d, const int64_t* st, float alpha,
                   cudaStream_t stream) {
  using C = FaCfg<D_PAD, NWARPS, BK, WD>;
  auto kern = flash_fwd_kernel<D_PAD, NWARPS, BK, WD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + C::BQ - 1) / C::BQ, b * h);
  kern<<<grid, 32 * NWARPS, C::smem_bytes, stream>>>(
      q, k, v, o, lse, h, sq, sk, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], alpha);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (b, s, h, d) bf16 with unit stride along d; strides in elements,
// each a multiple of 8, d a multiple of 8 and <= 512. o: contiguous
// (b, sq, h, d) bf16; lse: contiguous (b, h, sq) fp32, base 2.
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
  if (d <= 16) return launch<16, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 32) return launch<32, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 48) return launch<48, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 64) return launch<64, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 80) return launch<80, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 128) return launch<128, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 160) return launch<160, 4, 64, 1>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  if (d <= 512) return launch<512, 8, 32, 2>(Q, K, V, O, L, b, h, sq, sk, d, st, alpha, S);
  return static_cast<int>(cudaErrorInvalidValue);
}
