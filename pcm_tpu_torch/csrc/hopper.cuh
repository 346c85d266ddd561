// Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels: shared
// memory addresses, mbarriers, TMA tile loads from a tensor map, wgmma
// shared-memory descriptors and the warpgroup fences, accumulator helpers,
// and on the host the tensor maps (cached by their inputs). The wgmma
// products themselves are in wgmma_ops.cuh.
//
// Tiles live in shared memory as column chunks: a ROWS x D tile is D / CW
// chunks, each ROWS rows of CW bf16 (2 CW bytes: 16, 32 or 64 columns,
// swizzled by the TMA's SWIZZLE_32B / 64B / 128B mode and read by wgmma with
// the matching layout type). An int8 tile is addressed the same way, as a
// chunk of half as many bf16 columns: the descriptors see bytes, and a K
// step of 32 int8 (m64nNk32) moves the same 32 bytes as one of 16 bf16. The same chunked tile is read two ways
// (CUTLASS's canonical GMMA layouts, cute/arch/mma_sm90_desc.hpp), with
// CB = 2 CW bytes a chunk row:
//   K-major (rows = M or N, columns = K): 8-row groups 8 CB bytes apart (SBO);
//     a K step of 16 moves 32 bytes along the row, into the next chunk
//     every CW / 16 steps.
//   MN-major (columns = N, rows = K): N groups of CW one chunk apart (LBO),
//     8-row K groups 8 CB bytes apart (SBO); a K step of 16 rows moves 16 CB
//     bytes.
// A tile's chunks start at multiples of 8 CB bytes (the swizzle's atom).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"
#include "wgmma_ops.cuh"

namespace pcm {

constexpr int SW = 16;  // bf16 columns of the narrowest chunk (32 bytes: SWIZZLE_32B)

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add ``bytes`` to the transaction count of the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A wait that never
// ends (a copy that never lands) traps after ~2^28 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA loads (completion counted in bytes on an mbarrier)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA store of a shared-memory box to the tensor at (c0, c1); boxes beyond the
// tensor's bounds are clipped. The thread that issues stores commits them as
// one bulk group and alone can wait for them.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's bulk groups are pending: their shared
// memory read (READ) or their writes done.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Makes this thread's shared-memory writes visible to the TMA (the async
// proxy) before a barrier and a store of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma descriptors and fences
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor of CW-column chunks, offsets in bytes;
// layout type 1: 128-byte swizzle, 2: 64-byte, 3: 32-byte.
template <int CW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(CW == 16 || CW == 32 || CW == 64, "chunks are 16, 32 or 64 bf16 wide");
  constexpr uint64_t layout = CW == 16 ? 3 : CW == 32 ? 2 : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows r0.. of a chunked tile of ROWS rows, K step kk (16
// wide).
template <int ROWS, int CW = 16>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int r0, int kk) {
  constexpr int CB = 2 * CW, STEPS = CW / 16;  // bytes of a chunk row, K steps of a chunk
  return gmma_desc<CW>(tile + (kk / STEPS) * (ROWS * CB) + r0 * CB + (kk % STEPS) * 32, 16,
                       8 * CB);
}

// MN-major operand: columns c0.. (a multiple of CW) as N, rows 16 kk.. as K.
template <int ROWS, int CW = 16>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int c0, int kk) {
  constexpr int CB = 2 * CW;
  return gmma_desc<CW>(tile + (c0 / CW) * (ROWS * CB) + kk * 16 * CB, ROWS * CB, 8 * CB);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register budget of a warpgroup (setmaxnreg): a producer warpgroup gives
// registers back, consumer warpgroups take them. Every warp of the warpgroup
// executes it, on a branch that does not rejoin the others.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keeps the compiler from moving reads of an accumulator above a wg_wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}

template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]));
}

template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]));
}

// A barrier of ``count`` threads (whole warps) under id ``id`` (0 is
// __syncthreads'); it also orders their shared-memory accesses.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x by the special function unit (ex2.approx, denormal results flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// accumulators and the pipeline's bookkeeping
// ---------------------------------------------------------------------------

// Length-N/2 fp32 accumulator of a 64 x N wgmma tile -> bf16 A fragments of
// the products that contract over its N axis (16 columns per K step).
template <int R>
__device__ __forceinline__ void to_a(uint32_t out[R / 8][4], const float (&c)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    out[kk][0] = pack_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
    out[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    out[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    out[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&c)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) c[i] = 0.f;
}

// A warp's 16 rows of a 64 x N fp32 accumulator into a contiguous (b, s, h, d)
// output at row0 (the warp's row g) and column col0: rows >= n and columns >=
// d are not written. bf16 pairs, or fp32 pairs when ``part`` is given.
template <int R>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, float* part, const float (&acc)[R],
                                           int64_t base, int row0, int n, int h, int d,
                                           int col0, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      const int64_t off = base + (int64_t)row * h * d + col;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + off) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      else
        *reinterpret_cast<uint32_t*>(out + off) =
            pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Arrival of a consumer warp on a stage's empty barrier: its products on the
// stage have completed.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, reached through the runtime (the
// library links cudart only).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 (or, with ``int8``, 8-bit) tensor map of ``rank`` <= 4 dimensions
// (innermost first; ``strides`` in bytes of dimensions 1..rank-1), box
// ``box`` whose first extent is the chunk width (32, 64 or 128 bytes: 16, 32
// or 64 bf16 columns, the 32-, 64- or 128-byte swizzle), zero fill out of
// bounds. Encoding costs microseconds of host time, as much as a small
// launch's kernel, so recent maps are kept by their inputs (a map is a
// function of them alone; the caching allocator hands the same addresses
// back step after step).
// The tensor maps `tensor_map` has encoded in this process (its cache misses;
// `pcm_tma_encodes`): a weight gathered anew lands at a new address, so the
// maps that read it are encoded again.
inline uint64_t& tma_encode_count() {
  static uint64_t n = 0;
  return n;
}

inline bool tensor_map(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box, bool int8 = false) {
  constexpr int KEY = 13;  // base, rank and type, dims[4], strides[3], box[4]
  const cuuint32_t row_bytes = box[0] * (int8 ? 1 : 2);
  const CUtensorMapSwizzle swizzle = row_bytes == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  struct Entry {
    uint64_t key[KEY];
    CUtensorMap map;
  };
  constexpr int SLOTS = 64;
  static Entry cache[SLOTS];
  static bool used[SLOTS];
  static std::mutex mu;
  uint64_t key[KEY] = {(uint64_t)(uintptr_t)base, (uint64_t)rank | (uint64_t)int8 << 8};
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[9 + i] = box[i];
    if (i + 1 < rank) key[6 + i] = strides[i];
  }
  uint64_t hash = 1469598103934665603ull;
  for (uint64_t k : key) hash = (hash ^ k) * 1099511628211ull;
  Entry& e = cache[hash % SLOTS];
  std::lock_guard<std::mutex> lock(mu);
  if (used[hash % SLOTS] && std::equal(key, key + KEY, e.key)) {
    *m = e.map;
    return true;
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr ||
      enc(m, type, rank, const_cast<void*>(base), dims, strides, box,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::copy(key, key + KEY, e.key);
  e.map = *m;
  used[hash % SLOTS] = true;
  ++tma_encode_count();
  return true;
}

// A (b, s, h, d) bf16 tensor read through its strides (elements) as a 4-d map
// (d, h, s, b); box: ``cw`` columns x ``rows`` rows of one (b, h).
inline bool map_bshd(CUtensorMap* m, const void* base, int b, int s, int h, int d, int64_t sb,
                     int64_t ss, int64_t sh, int rows, int cw = SW) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  return tensor_map(m, base, 4, dims, strides, box);
}

// SMs of the current device (a persistent kernel's grid), read once a device.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = counts[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Dynamic shared memory above 48 KB for a kernel on the current device. The
// attribute belongs to a device's context, so it is set once a (kernel,
// device), here: a process that launches on several cards (the serving
// engine's data-parallel replicas, one host thread a card) sets it on each.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == fn && d.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.emplace_back(fn, dev);
  return err;
}

}  // namespace pcm
