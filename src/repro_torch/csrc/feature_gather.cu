// Feature-row gather and fanout mean on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/feature_gather.py:
// `feature_gather_rows` (the shared body `_kernel` with K = 1: the exact row
// copy out[r] = table[ids[r]]) and `feature_gather_mean` (the same body with
// K > 1: out[m] = sum_k table[ids[m, k]] / K, accumulated in float32 in k
// order as `_kernel` does, `out += row / K`).  float32 tables.
//
// The row gather.  What bounds it: memory bandwidth; each output row reads
// one table row at a data-dependent place and writes it.  The design: one
// warp per output row, its 32 lanes walking the row with vector loads, so
// each row is read as whole 32-byte sectors by neighbouring lanes and the
// many independent rows of the grid keep enough loads in flight to cover
// the latency of the random row starts.  The vector width is the widest
// that the row length and the pointers allow (a 602-float row is 8-byte
// aligned: float2, no tail).  The TPU kernel's per-row DMA into a VMEM tile,
// its semaphore, and its padding of the row count to TILE_M are not carried
// over: a warp reads its rows straight from device memory and the ragged
// edge is masked.
//
// The fanout mean.  What bounds it at (25,600, 10, 602), hop 2 of the
// in-memory step on a reddit-sized R-MAT graph: bytes, and how many of them
// L2 serves.  It requests 616 MB of table rows, but they are ~49,300
// distinct rows (119 MB) read five times each on average, so its bound
// (each distinct row read once, the 61.6 MB output written once) is reached
// only if every repeat comes from the 50 MB L2.  Measured on the card
// (PERF.md): the same kernel over as many distinct rows reads them at ~92 %
// of a contiguous copy's rate, so what is left is the repeats L2 misses.
// What the design does about it:
// - one warp per output row reads each of its K source rows whole (2,408
//   bytes at F = 602: ten float2 loads a lane, all in flight at once), one
//   row after another in k order, adding it into the output row's sums,
//   which stay in registers; rows longer than 32 x kMeanFloats floats go in
//   segments of that length;
// - the row's K ids are loaded once, coalesced (lane k holds id k), and
//   passed to the lanes by __shfl_sync (ids past 32 a run of 32 at a time);
// - the sum is `acc += v / K` in k order, in float32, with IEEE division
//   (no reciprocal, no fast math): the reference's `_kernel` order, bit
//   for bit; for K = 1 too (0 + x / 1 is +0.0 where x is -0.0, which a
//   row copy would not give);
// - the output goes out by streaming stores (st.global.cs, evict first), so
//   that it pushes fewer table rows out of L2 (0.5 % faster on the card).
// Designs measured on the card and dropped (PERF.md; times against this
// one's at (25,600, 10, 602)): all K loads of each 32-vector chunk of the
// output row in flight before its adds (2.3x: a warp touches each source
// row once per chunk, and ~320 distinct rows are in flight per SM); the
// next row's loads issued before the current row's adds (96 registers,
// half the warps: +24 %; with loads that skip L1 +33 %); rows in pairs (88
// registers: +32 %); segments of 10 floats a lane (44 registers, two passes
// over the K rows: +6 %); loads under an L2 evict_last policy (+1 %).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output rows per block
// floats of one source row a lane of the mean kernel holds: a row is read
// in segments of 32 x kMeanFloats floats, one segment of every source row
// in k order per output segment (kernels/feature_gather.py's
// MEAN_LANE_FLOATS is the same number; 602 floats fit one segment)
constexpr int kMeanFloats = 20;

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

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
feature_gather_rows_kernel(const float* __restrict__ table, int64_t vecs_per_row,
                           const int32_t* __restrict__ ids, int64_t rows,
                           float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= rows) return;
  const T* __restrict__ src = reinterpret_cast<const T*>(table);
  T* __restrict__ dst = reinterpret_cast<T*>(out) + m * vecs_per_row;
  const T* row = src + static_cast<int64_t>(ids[m]) * vecs_per_row;
#pragma unroll 4
  for (int64_t c = lane; c < vecs_per_row; c += 32) dst[c] = row[c];
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
feature_gather_mean_kernel(const float* __restrict__ table,
                           int32_t vecs_per_row,
                           const int32_t* __restrict__ ids, int64_t rows,
                           int32_t fanout, float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  constexpr int C = kMeanFloats / VEC;  // vectors of a segment a lane holds
  const int lane = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= rows) return;  // the whole warp: its shuffles stay full
  const T* __restrict__ src = reinterpret_cast<const T*>(table);
  T* __restrict__ dst = reinterpret_cast<T*>(out) + m * vecs_per_row;
  const int32_t* __restrict__ mids = ids + m * fanout;
  // ids 0..31 of the row, lane k holding id k; ids 32.. are loaded a run of
  // 32 at a time as the walk reaches them
  const int32_t head = lane < fanout ? __ldg(mids + lane) : 0;
  const float k = static_cast<float>(fanout);
  for (int32_t s0 = 0; s0 < vecs_per_row; s0 += 32 * C) {
    const int32_t left = vecs_per_row - s0 - lane;  // this lane's vectors
    T acc[C], v[C];
#pragma unroll
    for (int u = 0; u < C; ++u) acc[u] = zero<T>();
    int32_t held = head;
    for (int32_t j = 0; j < fanout; ++j) {
      if (j > 0 && (j & 31) == 0)
        held = lane < fanout - j ? __ldg(mids + j + lane) : 0;
      const int32_t id = __shfl_sync(0xffffffffu, held, j & 31);
      const T* __restrict__ row = src + static_cast<int64_t>(id) * vecs_per_row + s0 + lane;
      // the whole segment of row j in flight before its adds
#pragma unroll
      for (int u = 0; u < C; ++u)
        if (32 * u < left) v[u] = __ldg(row + 32 * u);
#pragma unroll
      for (int u = 0; u < C; ++u)
        if (32 * u < left) accum(acc[u], v[u], k);
    }
#pragma unroll
    for (int u = 0; u < C; ++u)
      if (32 * u < left) __stcs(dst + s0 + lane + 32 * u, acc[u]);
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
                   int64_t rows, int fanout, bool mean, float* out,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int64_t vecs = feat / VEC;
  if (mean)
    feature_gather_mean_kernel<VEC><<<blocks, kWarps * 32, 0, stream>>>(
        table, static_cast<int32_t>(vecs), ids, rows, fanout, out);
  else
    feature_gather_rows_kernel<VEC><<<blocks, kWarps * 32, 0, stream>>>(
        table, vecs, ids, rows, out);
  return cudaGetLastError();
}

}  // namespace

// ids: (rows, fanout) int32; out: (rows, feat) float32.  `mean` takes the
// fanout mean (any fanout; 0 gives zeros), else the row copy (fanout 1).  `vec` is 1,
// 2 or 4 and must divide `feat`, with both pointers aligned to 4 * vec
// bytes; feat below 2**31.
extern "C" int feature_gather_launch(const void* table, int64_t feat,
                                     const void* ids, int64_t rows, int fanout,
                                     int mean, void* out, int vec,
                                     void* stream) {
  if (rows == 0 || feat == 0) return static_cast<int>(cudaSuccess);
  if (feat >= (int64_t{1} << 31) || fanout < 0 || (!mean && fanout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(table);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  const bool m = mean != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return static_cast<int>(launch<4>(t, feat, i, rows, fanout, m, o, s));
    case 2: return static_cast<int>(launch<2>(t, feat, i, rows, fanout, m, o, s));
    case 1: return static_cast<int>(launch<1>(t, feat, i, rows, fanout, m, o, s));
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
