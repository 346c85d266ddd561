// GroupNorm (+ optional SiLU) over channels-last bf16 input (N, S, C).
//
// Replaces: pcm_tpu/ops/groupnorm.py `_stats_kernel` (per-channel partial
// sums over spatial blocks) and `_norm_kernel` ((x - mean) * rstd * gamma +
// beta, then SiLU when act == "silu"), both launched from `_forward`.
//
// Bound on this card: memory bandwidth. The pass reads the activation twice
// and writes it once (up to 512 MiB per call in the SD1.5 VAE decoder at
// 512 px, batch 4), with a handful of flops per element.
//
// Design, in three launches on one stream:
//  1. stats: one block per (spatial chunk, sample) reads its rows with
//     16-byte vector loads, eight channels per thread. Each thread keeps
//     shifted sums (shift = its first value of each channel), which do not
//     cancel on inputs with a large mean; the block merges them into a
//     (mean, M2) per group with Chan's formula in a fixed order and writes
//     them to scratch. Unlike the Pallas kernel's one-pass E[x^2] - mean^2,
//     this stays exact for an input offset by 100 with unit spread.
//  2. finalize: one thread per (sample, group) merges the chunks' partials
//     in chunk order (Chan again) into mean and rstd. Hopper blocks cannot
//     carry a sum across the grid, and float atomics would make the sum's
//     order vary; the fixed order keeps every run bit-identical.
//  3. normalize: a grid-stride pass of 16-byte vectors applying the affine
//     map and SiLU in fp32, storing bf16. Channels per group need not be a
//     power of two (10, 20, ... in SD1.5): each channel looks up its group.
// No fp32 copy of the activation is ever made.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void chan_merge(float& na, float& ma, float& Ma, float nb,
                                           float mb, float Mb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float delta = mb - ma;
  ma += delta * (nb / n);
  Ma += Mb + delta * delta * (na * nb / n);
  na = n;
}

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// grid (nblk, n); blockDim = (c / 8) * rs; dynamic smem (2 * rs * c + rs) floats
__global__ void gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                                int s, int c, int groups, int rows_per_block, int rs) {
  extern __shared__ float sh[];
  float* sh_mean = sh;
  float* sh_m2 = sh + rs * c;
  float* sh_n = sh + 2 * rs * c;
  const int n = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int nv = c / 8;
  const int tid = threadIdx.x, v = tid % nv, r = tid / nv;
  const int row0 = blk * rows_per_block;
  const int row1 = min(s, row0 + rows_per_block);
  const bf16* xb = x + (int64_t)n * s * c + v * 8;

  float shift[8], s1[8], s2[8], xv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) shift[j] = s1[j] = s2[j] = 0.f;
  int cnt = 0;
  if (row0 + r < row1)
    unpack8(*reinterpret_cast<const uint4*>(xb + (int64_t)(row0 + r) * c), shift);
  for (int row = row0 + r; row < row1; row += rs, ++cnt) {
    unpack8(*reinterpret_cast<const uint4*>(xb + (int64_t)row * c), xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dv = xv[j] - shift[j];
      s1[j] += dv;
      s2[j] += dv * dv;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float fc = (float)cnt;
    sh_mean[r * c + v * 8 + j] = cnt ? shift[j] + s1[j] / fc : 0.f;
    sh_m2[r * c + v * 8 + j] = cnt ? fmaxf(s2[j] - s1[j] * s1[j] / fc, 0.f) : 0.f;
  }
  if (v == 0) sh_n[r] = (float)cnt;
  __syncthreads();

  // per channel: merge the rs row-phases in order (a thread touches only its
  // own channel's column, so slot 0 can take the result)
  for (int ch = tid; ch < c; ch += blockDim.x) {
    float na = 0.f, ma = 0.f, Ma = 0.f;
    for (int i = 0; i < rs; ++i) chan_merge(na, ma, Ma, sh_n[i], sh_mean[i * c + ch], sh_m2[i * c + ch]);
    sh_mean[ch] = ma;
    sh_m2[ch] = Ma;
  }
  __syncthreads();

  const int cg = c / groups;
  const float rows = (float)(row1 - row0);
  for (int gi = tid; gi < groups; gi += blockDim.x) {
    float na = 0.f, ma = 0.f, Ma = 0.f;
    for (int j = 0; j < cg; ++j) chan_merge(na, ma, Ma, rows, sh_mean[gi * cg + j], sh_m2[gi * cg + j]);
    float* out = part + (((int64_t)n * nblk + blk) * groups + gi) * 2;
    out[0] = ma;
    out[1] = Ma;
  }
}

// grid n; one thread per group (strided)
__global__ void gn_finalize_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                   int nblk, int groups, int s, int cg, int rows_per_block,
                                   float eps) {
  const int n = blockIdx.x;
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    float na = 0.f, ma = 0.f, Ma = 0.f;
    for (int blk = 0; blk < nblk; ++blk) {
      const int rows = min(s, (blk + 1) * rows_per_block) - blk * rows_per_block;
      const float* p = part + (((int64_t)n * nblk + blk) * groups + gi) * 2;
      chan_merge(na, ma, Ma, (float)rows * cg, p[0], p[1]);
    }
    stats[((int64_t)n * groups + gi) * 2] = ma;
    stats[((int64_t)n * groups + gi) * 2 + 1] = rsqrtf(Ma / na + eps);
  }
}

__global__ void gn_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                               const bf16* __restrict__ beta, const float* __restrict__ stats,
                               bf16* __restrict__ out, int64_t total_vec, int s, int c,
                               int groups, int act) {
  const int nv = c / 8, cg = c / groups;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total_vec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / nv;
    const int v = (int)(i % nv);
    const int n = (int)(row / s);
    float xv[8], gv[8], bv[8];
    unpack8(*reinterpret_cast<const uint4*>(x + i * 8), xv);
    unpack8(*reinterpret_cast<const uint4*>(gamma + v * 8), gv);
    unpack8(*reinterpret_cast<const uint4*>(beta + v * 8), bv);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gi = (v * 8 + j + e) / cg;
        const float* st = stats + ((int64_t)n * groups + gi) * 2;
        float val = (xv[j + e] - st[0]) * st[1] * gv[j + e] + bv[j + e];
        if (act) val = val / (1.f + expf(-val));
        y[e] = val;
      }
      o[j / 2] = pcm::pack_bf16x2(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(out + i * 8) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// x, out: contiguous (n, s, c) bf16; gamma, beta: (c,) bf16; c % 8 == 0,
// c <= 4096, c % groups == 0; all pointers 16-byte aligned. scratch: fp32
// of 2 * n * groups * (ceil(s / rows_per_block) + 1) elements.
extern "C" int pcm_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* out, void* scratch, int n, int s, int c,
                                   int groups, int act, int rows_per_block, float eps,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int nblk = (s + rows_per_block - 1) / rows_per_block;
  const int nv = c / 8;
  const int rs = nv >= 256 ? 1 : 256 / nv;
  const size_t smem = (size_t)(2 * rs * c + rs) * sizeof(float);
  float* part = static_cast<float*>(scratch);
  float* stats = part + (size_t)n * nblk * groups * 2;
  gn_stats_kernel<<<dim3(nblk, n), nv * rs, smem, st>>>(
      static_cast<const bf16*>(x), part, s, c, groups, rows_per_block, rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<n, groups < 256 ? groups : 256, 0, st>>>(
      part, stats, nblk, groups, s, c / groups, rows_per_block, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total_vec = (int64_t)n * s * nv;
  int64_t blocks = (total_vec + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gn_norm_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), stats, static_cast<bf16*>(out), total_vec, s, c,
      groups, act);
  return cudaGetLastError();
}
