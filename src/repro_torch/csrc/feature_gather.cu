// Feature-row gather and fanout mean on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/feature_gather.py:
// `feature_gather_rows` (the shared body `_kernel` with K = 1: the exact row
// copy out[r] = table[ids[r]]) and `feature_gather_mean` (the same body with
// K > 1: out[m] = sum_k table[ids[m, k]] / K, accumulated in float32 in k
// order as `_kernel` does, `out += row / K`).  float32 tables.
//
// What bounds it on this card: memory bandwidth.  Each output row reads K
// table rows at data-dependent places and writes one row; there is one add
// and one divide per element read, far below what the card can do per byte.
//
// What the design does about it: one warp per output row, its 32 lanes
// walking the row with vector loads, so each row is read as whole 32-byte
// sectors by neighbouring lanes and the many independent rows of the grid
// keep enough loads in flight to cover the latency of the random row
// starts.  The vector width is the widest that the row length and the
// pointers allow (a 602-float row is 8-byte aligned: float2, no tail).
// The TPU kernel's per-row DMA into a VMEM tile, its semaphore, and its
// padding of the row count to TILE_M are not carried over: a warp reads its
// rows straight from device memory and the ragged edge is masked.  For
// K = 1 the kernel is a plain copy (x / 1 == x exactly); for K > 1 the sum
// stays in registers, so no (M, K, F) intermediate is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output rows per block

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.0f, 0.0f); }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void accum(float& acc, float v, float k) { acc += v / k; }
__device__ __forceinline__ void accum(float2& acc, float2 v, float k) {
  acc.x += v.x / k;
  acc.y += v.y / k;
}
__device__ __forceinline__ void accum(float4& acc, float4 v, float k) {
  acc.x += v.x / k;
  acc.y += v.y / k;
  acc.z += v.z / k;
  acc.w += v.w / k;
}

template <int VEC, bool MEAN>
__global__ void __launch_bounds__(kWarps * 32)
feature_gather_kernel(const float* __restrict__ table, int64_t vecs_per_row,
                      const int32_t* __restrict__ ids, int64_t rows, int fanout,
                      float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= rows) return;
  const T* __restrict__ src = reinterpret_cast<const T*>(table);
  T* __restrict__ dst = reinterpret_cast<T*>(out) + m * vecs_per_row;
  if (!MEAN) {
    const T* row = src + static_cast<int64_t>(ids[m]) * vecs_per_row;
#pragma unroll 4
    for (int64_t c = lane; c < vecs_per_row; c += 32) dst[c] = row[c];
    return;
  }
  const int32_t* __restrict__ mids = ids + m * fanout;
  const float k = static_cast<float>(fanout);
  for (int64_t c = lane; c < vecs_per_row; c += 32) {
    T acc = zero<T>();
    for (int j = 0; j < fanout; ++j)
      accum(acc, src[static_cast<int64_t>(mids[j]) * vecs_per_row + c], k);
    dst[c] = acc;
  }
}

// The cached gather (replaces feature_gather.py:feature_gather_cached, body
// `_cached_kernel`): out[r] = cache[max(slot_of[ids[r]], 0)], an exact
// float32 row copy through the node -> slot table; slot -1 (not resident)
// reads slot 0, as the TPU kernel clamps it.  The TPU kernel's padding of
// the row count with repeats of the last id is not carried over: the
// ragged edge is masked.
//
// What bounds it at the out-of-core step's widths: bytes, at launches whose
// bytes take about as long as the launch itself (a segment of 2,000-3,500
// rows of 2,408 bytes is 10-17 MB read and written: 3-5 us at 3.35 TB/s).
// Phase 3's timer rewrites L2 before each launch, so the kernel's misses
// also evict dirty lines; with L2 read instead, a 3,460-row launch is
// ~2.5 us faster (PERF.md).
//
// What the design does about it:
// - each block resolves all of its rows first, one coalesced pass over ids
//   and one over slot_of into shared memory, before any row byte moves;
// - a warp copies a row by loading all of it (up to 3 KB: 96 bytes a lane)
//   into registers before its first store, so every row's bytes are in
//   flight at once;
// - the grid is one full wave: rows_per_block = 8 warps x the fewest rows
//   a warp that cover all rows with the blocks resident at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs).
// The vector width is the widest the row length and the pointers allow
// (float2 for a 602-float row).  Two other row copies were measured on the
// card and were no faster (PERF.md): float4 through each row's 16-
// byte-aligned interior where source and destination share their phase
// mod 16 (every other slot and output row at F = 602), and Hopper's 1-d
// bulk copy (cp.async.bulk into shared memory on an mbarrier, the lanes
// writing the row out).  The parent kernel, with four of a warp's loads in
// flight, took the same time: the memory system, not the chain, sets it.
constexpr int kGatherWarps = 8;
constexpr int kGatherThreads = kGatherWarps * 32;
constexpr int kLaneBytes = 96;  // in flight per lane for one row chunk

// a row of F floats (a multiple of V) from src to dst by one warp: each
// lane loads its kLaneBytes of a chunk into registers, then stores them
template <int V>
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int F,
                                         int lane) {
  using T = typename Vec<V>::T;
  constexpr int U = kLaneBytes / (4 * V);
  const T* __restrict__ s = reinterpret_cast<const T*>(src);
  T* __restrict__ d = reinterpret_cast<T*>(dst);
  const int nv = F / V;
  for (int base = lane; base < nv; base += 32 * U) {
    T buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + 32 * u < nv) buf[u] = __ldg(s + base + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + 32 * u < nv) d[base + 32 * u] = buf[u];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kGatherThreads)
feature_gather_cached_kernel(const float* __restrict__ cache, int F,
                             const int32_t* __restrict__ slot_of,
                             const int32_t* __restrict__ ids, int32_t rows,
                             int32_t rows_per_block, float* __restrict__ out) {
  __shared__ int32_t s_slot[kGatherThreads];  // rows_per_block <= threads
  const int32_t row0 = static_cast<int32_t>(blockIdx.x) * rows_per_block;
  const int32_t n = min(rows_per_block, rows - row0);
  const int k0 = threadIdx.x;
  int32_t id = 0;
  if (k0 < n) id = ids[row0 + k0];
  if (k0 < n) {
    const int32_t slot = slot_of[id];
    s_slot[k0] = slot < 0 ? 0 : slot;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < n; k += kGatherWarps)
    copy_row<VEC>(cache + static_cast<int64_t>(s_slot[k]) * F,
                  out + static_cast<int64_t>(row0 + k) * F, F, lane);
}

// the blocks of one instance resident on the current device at once
template <int VEC>
int wave_blocks() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, feature_gather_cached_kernel<VEC>, kGatherThreads, 0);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int VEC>
cudaError_t launch_cached(const float* cache, int64_t feat, const int32_t* slot_of,
                          const int32_t* ids, int64_t rows, float* out,
                          cudaStream_t stream) {
  const int64_t wave = wave_blocks<VEC>();
  int64_t per_warp = wave > 0 ? (rows + kGatherWarps * wave - 1) /
                                    (kGatherWarps * wave)
                              : 1;
  per_warp = per_warp < 1 ? 1 : (per_warp > 32 ? 32 : per_warp);
  const int64_t per_block = kGatherWarps * per_warp;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  feature_gather_cached_kernel<VEC><<<blocks, kGatherThreads, 0, stream>>>(
      cache, static_cast<int>(feat), slot_of, ids, static_cast<int32_t>(rows),
      static_cast<int32_t>(per_block), out);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch(const float* table, int64_t feat, const int32_t* ids,
                   int64_t rows, int fanout, float* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int64_t vecs = feat / VEC;
  if (fanout == 1)
    feature_gather_kernel<VEC, false><<<blocks, kWarps * 32, 0, stream>>>(
        table, vecs, ids, rows, fanout, out);
  else
    feature_gather_kernel<VEC, true><<<blocks, kWarps * 32, 0, stream>>>(
        table, vecs, ids, rows, fanout, out);
  return cudaGetLastError();
}

}  // namespace

// ids: (rows, fanout) int32; out: (rows, feat) float32.  `vec` is 1, 2 or
// 4 and must divide `feat`, with both pointers aligned to 4 * vec bytes.
extern "C" int feature_gather_launch(const void* table, int64_t feat,
                                     const void* ids, int64_t rows, int fanout,
                                     void* out, int vec, void* stream) {
  if (rows == 0 || feat == 0) return static_cast<int>(cudaSuccess);
  const float* t = static_cast<const float*>(table);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return static_cast<int>(launch<4>(t, feat, i, rows, fanout, o, s));
    case 2: return static_cast<int>(launch<2>(t, feat, i, rows, fanout, o, s));
    case 1: return static_cast<int>(launch<1>(t, feat, i, rows, fanout, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cache: (C, feat) float32; slot_of: (N+1,) int32; ids: (rows,) int32;
// out: (rows, feat) float32.  `vec` as above; rows and feat below 2**31.
extern "C" int feature_gather_cached_launch(const void* cache, int64_t feat,
                                            const void* slot_of, const void* ids,
                                            int64_t rows, void* out, int vec,
                                            void* stream) {
  if (rows == 0 || feat == 0) return static_cast<int>(cudaSuccess);
  if (rows >= (int64_t{1} << 31) || feat >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cache);
  const int32_t* so = static_cast<const int32_t*>(slot_of);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return static_cast<int>(launch_cached<4>(c, feat, so, i, rows, o, s));
    case 2: return static_cast<int>(launch_cached<2>(c, feat, so, i, rows, o, s));
    case 1: return static_cast<int>(launch_cached<1>(c, feat, so, i, rows, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
