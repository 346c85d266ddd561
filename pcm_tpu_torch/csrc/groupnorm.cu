// GroupNorm (+ optional SiLU) over channels-last bf16 or fp32 input (N, S, C).
//
// Replaces: pcm_tpu/ops/groupnorm.py `_stats_kernel` (per-channel partial
// sums over spatial blocks) and `_norm_kernel` ((x - mean) * rstd * gamma +
// beta, then SiLU when act == "silu"), both launched from `_forward`.
//
// Bound on this card: memory bandwidth. The function reads the activation
// once and writes it once with a handful of fp32 operations an element; its
// bound counts those bytes (0.32 ms at the SD1.5 VAE decoder's (4, 512 x 512,
// 256), 537 MB in). The two passes read x twice:
//  - at the VAE's shapes x is ten times the 50 MB L2, so both reads come from
//    HBM: each pass is bound by its bytes (x; then x and y) at the memory rate;
//  - at the UNet's step shapes (3-84 MB a call) the second read can come from
//    L2, and a call's fixed cost weighs as much as its bytes: two launches,
//    the grid's ramp and tail, and the chains of dependent merges in each
//    block (one IEEE division each; a finalize with one thread a group that
//    merges 256 chunk partials in turn costs tens of microseconds a call).
//
// Design, two launches on one stream, no state kept between calls, no float
// atomics, every sum in a fixed order (reruns are bit-identical):
//  1. gn_stats_kernel, grid (chunk, sample): about two blocks an SM over the
//     whole batch (`gn_partition` in ops/groupnorm.py sizes the chunks; the
//     normalize pass takes the same grid). A thread owns one 16-byte vector
//     (8 bf16 or 4 fp32 channels) and a row phase and walks its chunk's rows with kStatsUnroll
//     independent 16-byte loads in flight (32 KB a 256-thread block). It keeps
//     shifted sums (shift = its first value of each channel), which do not
//     cancel on inputs with a large mean (unlike the Pallas kernel's one-pass
//     E[x^2] - mean^2). The block merges them with Chan's formula: the row
//     phases in order per channel, then each group's channels in a warp
//     segment (`seg_merge`), and writes one (mean, M2) per group to scratch.
//  2. gn_norm_kernel, the same grid. It first issues the loads that need no
//     statistics (gamma, beta, its first rows of x), then, as a prologue,
//     merges its sample's chunk partials into mean and rstd per group in
//     shared memory (`seg_merge` again). Every block repeats this merge of a
//     few KB from L2, so nothing outlives the call. Each thread turns its
//     vector's channels' statistics into fp32 coefficients in registers (mean_c, a_c =
//     rstd_g * gamma_c, beta_c): the main loop divides no index. It walks its
//     chunk's rows front to back, as the stats pass did, kNormUnroll 16-byte
//     loads in flight, evict-first (the last read of x), and stores (x -
//     mean_c) * a_c + beta_c, then SiLU as v / (1 + exp(-v)) with the fast
//     exponential and division (MUFU ex2 and rcp), in the input's type. (Walking back to
//     front, so that the lines the stats pass read last come first, timed the
//     same on scripts/bench_group_norm.py; PERF.md.)
// The lanes of a merge segment, a power of two, are launch arguments:
// `gn_partition` in ops/groupnorm.py picks them, the width that makes the
// block's chain of merges shortest (at the UNet's 8x8 level a block has 5
// warps for 32 groups of 40 channels, and 4-lane segments merge them in 12
// steps where a warp a group took 49), and the CPU tests' mirror of these
// merges takes the same partition. No fp32 copy of the activation is made.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStatsUnroll = 8;  // 16-byte loads in flight a thread, stats pass
constexpr int kNormUnroll = 4;   // the same, normalize pass (each also stores 16 bytes)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void chan_merge(float& na, float& ma, float& Ma, float nb,
                                           float mb, float Mb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float delta = mb - ma;
  const float w = nb / n;
  ma += delta * w;
  Ma += Mb + delta * delta * (na * w);
  na = n;
}

// The lanes of a warp in segments of `width` (a power of two <= 32), one
// partial each: lane 0 of each segment ends with the merge of its
// segment's, lane i taking lane i + width / 2, then i + width / 4, ... (a
// fixed order). Every lane of the warp must call it.
__device__ __forceinline__ void seg_merge(float& n, float& m, float& M, int width) {
  const int lane = threadIdx.x & (width - 1);
  for (int off = width / 2; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(kFull, n, off, width);
    const float mb = __shfl_down_sync(kFull, m, off, width);
    const float Mb = __shfl_down_sync(kFull, M, off, width);
    if (lane < off) chan_merge(n, m, M, nb, mb, Mb);
  }
}

// One thread's 16-byte vector of T: kN channels, unpacked to fp32 and packed back.
template <typename T>
struct Vec16;

template <>
struct Vec16<bf16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(pcm::pack_bf16x2(f[0], f[1]), pcm::pack_bf16x2(f[2], f[3]),
                      pcm::pack_bf16x2(f[4], f[5]), pcm::pack_bf16x2(f[6], f[7]));
  }
};

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// Rows row, row + rs, ..., U of them, of one thread's 16-byte column of x
// (zeros from row1 on); kLast loads evict-first (the last read of x).
template <int U, bool kLast, typename T>
__device__ __forceinline__ void load_rows(uint4 (&raw)[U], const T* xb, int row, int row1,
                                          int rs, int c) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int rr = row + k * rs;
    const uint4* p = reinterpret_cast<const uint4*>(xb + (int64_t)rr * c);
    raw[k] = rr >= row1 ? make_uint4(0, 0, 0, 0) : kLast ? __ldcs(p) : __ldg(p);
  }
}

// grid (nchunk, n); blockDim = nv * rs rounded up to a warp (nv = lanes,
// c / kN); dynamic smem (2 * rs * c + rs) floats. part: (n, groups, nchunk)
// float2. width: the lanes of the segment that merges a group's channels.
template <typename T>
__global__ void __launch_bounds__(512)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int s, int c, int nv,
                int groups, int rows_per_chunk, int rs, int width) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  extern __shared__ float sh[];
  float* sh_mean = sh;
  float* sh_m2 = sh + rs * c;
  float* sh_n = sh + 2 * rs * c;
  const int n = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(s, row0 + rows_per_chunk);

  if (tid < nv * rs) {
    const int v = tid % nv, r = tid / nv;
    const T* xb = x + (int64_t)n * s * c + v * kN;
    float shift[kN], s1[kN], s2[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) shift[j] = s1[j] = s2[j] = 0.f;
    int cnt = 0;
    for (int row = row0 + r; row < row1; row += rs * kStatsUnroll) {
      uint4 raw[kStatsUnroll];
      load_rows<kStatsUnroll, false>(raw, xb, row, row1, rs, c);
      if (cnt == 0) V::unpack(raw[0], shift);  // the thread's first row
#pragma unroll
      for (int k = 0; k < kStatsUnroll; ++k) {
        if (row + k * rs < row1) {
          float xv[kN];
          V::unpack(raw[k], xv);
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            const float dv = xv[j] - shift[j];
            s1[j] += dv;
            s2[j] = fmaf(dv, dv, s2[j]);
          }
          ++cnt;
        }
      }
    }
    const float inv = cnt ? 1.f / (float)cnt : 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      sh_mean[r * c + v * kN + j] = cnt ? shift[j] + s1[j] * inv : 0.f;
      sh_m2[r * c + v * kN + j] = cnt ? fmaxf(s2[j] - s1[j] * s1[j] * inv, 0.f) : 0.f;
    }
    if (v == 0) sh_n[r] = (float)cnt;
  }
  __syncthreads();

  // per channel: merge the rs row phases in order (a thread touches only its
  // own channel's column, so phase 0's slot can take the result)
  for (int ch = rs > 1 ? tid : c; ch < c; ch += blockDim.x) {
    float na = 0.f, ma = 0.f, Ma = 0.f;
    for (int i = 0; i < rs; ++i) chan_merge(na, ma, Ma, sh_n[i], sh_mean[i * c + ch], sh_m2[i * c + ch]);
    sh_mean[ch] = ma;
    sh_m2[ch] = Ma;
  }
  __syncthreads();

  // per group, a warp segment each: lane l merges channels l, l + width,
  // ... of the group (each counts the chunk's rows), then the shuffle tree
  const int cg = c / groups, per_warp = 32 / width;
  const int seg = (tid & 31) / width, lane = tid & (width - 1);
  const float rows = (float)(row1 - row0);
  for (int g0 = (tid >> 5) * per_warp; g0 < groups; g0 += (blockDim.x >> 5) * per_warp) {
    const int g = g0 + seg;
    float na = 0.f, ma = 0.f, Ma = 0.f;
    if (g < groups)
      for (int i = lane; i < cg; i += width)
        chan_merge(na, ma, Ma, rows, sh_mean[g * cg + i], sh_m2[g * cg + i]);
    seg_merge(na, ma, Ma, width);
    if (g < groups && lane == 0)
      part[((int64_t)n * groups + g) * nchunk + chunk] = make_float2(ma, Ma);
  }
}

// grid (nchunk, n), as the stats pass; blockDim as there; dynamic smem
// 2 * groups floats. width: the lanes of the segment that merges a group's
// chunk partials. The explicit minimum of one block an SM: with the bare
// (512), ptxas held the bf16 act=None instance to 64 registers and spilled
// 64 bytes; with it, both bf16 instances take 86 and none spills.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(512, 1)
gn_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               const T* __restrict__ beta, const float2* __restrict__ part,
               T* __restrict__ out, int s, int c, int nv, int groups, int rows_per_chunk,
               int rs, int width, float eps) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  extern __shared__ float sh_stat[];  // (mean, rstd) per group
  const int n = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int tid = threadIdx.x, cg = c / groups;
  const bool worker = tid < nv * rs;
  const int v = tid % nv, r = tid / nv;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(s, row0 + rows_per_chunk);
  const int64_t base = (int64_t)n * s * c + v * kN;
  const T* xb = x + base;
  T* ob = out + base;

  // the loads that need no statistics go first, their latency under the prologue
  uint4 graw = make_uint4(0, 0, 0, 0), braw = graw, raw[kNormUnroll];
  int row = row0 + r;
  if (worker) {
    graw = __ldg(reinterpret_cast<const uint4*>(gamma + v * kN));
    braw = __ldg(reinterpret_cast<const uint4*>(beta + v * kN));
    load_rows<kNormUnroll, true>(raw, xb, row, row1, rs, c);
  }

  // prologue: this sample's chunk partials -> mean, rstd per group, a warp
  // segment a group (lane l merges chunks l, l + width, ...)
  const int per_warp = 32 / width;
  const int seg = (tid & 31) / width, lane = tid & (width - 1);
  for (int g0 = (tid >> 5) * per_warp; g0 < groups; g0 += (blockDim.x >> 5) * per_warp) {
    const int g = g0 + seg;
    float na = 0.f, ma = 0.f, Ma = 0.f;
    if (g < groups) {
      const float2* p = part + ((int64_t)n * groups + g) * nchunk;
      for (int i = lane; i < nchunk; i += width) {
        const float2 q = p[i];
        const int rows = min(s, (i + 1) * rows_per_chunk) - i * rows_per_chunk;
        chan_merge(na, ma, Ma, (float)rows * cg, q.x, q.y);
      }
    }
    seg_merge(na, ma, Ma, width);
    if (g < groups && lane == 0) {
      sh_stat[2 * g] = ma;
      sh_stat[2 * g + 1] = rsqrtf(Ma / na + eps);
    }
  }
  __syncthreads();
  if (!worker) return;

  float mu[kN], a[kN], b[kN];
  V::unpack(graw, a);
  V::unpack(braw, b);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int g = (v * kN + j) / cg;
    mu[j] = sh_stat[2 * g];
    a[j] *= sh_stat[2 * g + 1];
  }

  for (; row < row1; row += rs * kNormUnroll) {
    if (row != row0 + r) load_rows<kNormUnroll, true>(raw, xb, row, row1, rs, c);
#pragma unroll
    for (int k = 0; k < kNormUnroll; ++k) {
      const int rr = row + k * rs;
      if (rr < row1) {
        float y[kN];
        V::unpack(raw[k], y);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          float val = fmaf(y[j] - mu[j], a[j], b[j]);
          if (kSilu) val = __fdividef(val, 1.f + __expf(-val));
          y[j] = val;
        }
        *reinterpret_cast<uint4*>(ob + (int64_t)rr * c) = V::pack(y);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* out,
                   float2* part, int n, int s, int c, int lanes, int groups, int act,
                   int rows_per_chunk, int rs, int seg_chan, int seg_chunk, float eps,
                   cudaStream_t st) {
  if (lanes * Vec16<T>::kN != c) return cudaErrorInvalidValue;
  const dim3 grid((s + rows_per_chunk - 1) / rows_per_chunk, n);
  const int threads = (lanes * rs + 31) / 32 * 32;
  gn_stats_kernel<T><<<grid, threads, (size_t)(2 * rs * c + rs) * sizeof(float), st>>>(
      static_cast<const T*>(x), part, s, c, lanes, groups, rows_per_chunk, rs, seg_chan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)2 * groups * sizeof(float);
  auto norm = act ? gn_norm_kernel<T, true> : gn_norm_kernel<T, false>;
  norm<<<grid, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      part, static_cast<T*>(out), s, c, lanes, groups, rows_per_chunk, rs, seg_chunk, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (n, s, c) of elem_size-byte elements (2: bf16, 4:
// fp32); gamma, beta: (c,) of the same type; lanes = c * elem_size / 16
// (16-byte vectors a row), lanes * rs <= 512, c % groups == 0; all pointers
// 16-byte aligned. rows_per_chunk a multiple of rs. seg_chan, seg_chunk:
// powers of two <= 32, the merge segments' lanes over a group's channels
// (stats pass) and over its chunk partials (normalize pass). scratch: 2 * n
// * groups * ceil(s / rows_per_chunk) floats.
extern "C" int pcm_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* out, void* scratch, int elem_size, int n, int s,
                                   int c, int lanes, int groups, int act, int rows_per_chunk,
                                   int rs, int seg_chan, int seg_chunk, float eps,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float2*>(scratch);
  if (elem_size == 2)
    return launch<bf16>(x, gamma, beta, out, part, n, s, c, lanes, groups, act,
                        rows_per_chunk, rs, seg_chan, seg_chunk, eps, st);
  if (elem_size == 4)
    return launch<float>(x, gamma, beta, out, part, n, s, c, lanes, groups, act,
                         rows_per_chunk, rs, seg_chan, seg_chunk, eps, st);
  return cudaErrorInvalidValue;
}
