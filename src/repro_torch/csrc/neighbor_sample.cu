// CSR fanout sampling on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/neighbor_sample.py:neighbor_sample
// (body `_kernel`): out[m, s] = indices[min(indptr[t] + rand[m, s] mod deg(t),
// E - 1)], or t when deg(t) == 0, with t = targets[m]; int32 throughout.
//
// What bounds it at the in-memory step's widths (hop 1: 1,024 targets x 25,
// hop 2: 25,600 x 10, on a reddit-sized R-MAT graph): latency.  A thread
// reads one 4-byte entry of `indices` at a data-dependent place and its
// target's two `indptr` entries, so a launch moves a few MB (hop 2: ~256,000
// random 32-byte sectors, ~8 MB, ~2.4 us at the HBM rate, under the launch
// floor) and the time is the launch plus the dependent chain targets ->
// indptr -> indices, each link a round trip to device memory.
//
// What the design does about it: one thread per output, every thread of a
// hop resident at once (one wave), so each link of the chain is in flight
// across the whole grid at once and no thread waits on another; and, as in
// the cached sampler below:
// - rand[i] is loaded at the top beside targets[i / S], so the chain has
//   three dependent round trips (the first, scalar design loaded it inside
//   the degree test, after indptr: four);
// - i / S is a widening multiply and a shift by the host's fast_divisor
//   multiplier (kernels/neighbor_sample.py); only rand mod deg, whose
//   divisor is data, stays a 32-bit division (the first design divided
//   i / S as a 64-bit division: a branch to a ~20-instruction 32-bit path
//   with a reciprocal on the special-function unit);
// - 32-bit indexing: the entry point refuses M x S or E at or above 2**31;
// - the read-only inputs load through the non-coherent path (__ldg);
// - 128 threads a block (kThreads; 256 measured alike on the card).
// Measured on the card (PERF.md), these moved the time above the launch
// floor by only 1-6 % at either hop, not the quarter the shorter chain
// suggested: hop 1 stays ~2.3 us above the floor, hop 2 ~7 us, of which
// ~2.5 us go to writing back dirty lines that its misses evict when L2 was
// last written (timed with L2 read, not written, before each launch, hop 2
// is ~4.6 us above the floor); the rest is the random `indices` sectors.
// The TPU kernel's block staging (a VMEM pair of edge blocks per target,
// `edge_pad` / `max_base`, the one-hot iota gather, TILE_M padding with
// node 0) exists to feed the TPU's vector unit and is not carried over:
// each thread reads its one sampled entry directly, so there is no
// `max_degree <= block_e` limit, and the ragged edge of the grid is masked
// rather than padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// n / d for 0 <= n < 2**31, with (mul, shift) from the host's fast_divisor
__device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t mul,
                                             uint32_t shift) {
  return static_cast<uint32_t>((static_cast<uint64_t>(n) * mul) >> shift);
}

__global__ void __launch_bounds__(kThreads)
neighbor_sample_kernel(const int32_t* __restrict__ indptr,
                       const int32_t* __restrict__ indices,
                       int32_t last_edge,
                       const int32_t* __restrict__ targets,
                       const int32_t* __restrict__ rand,
                       int32_t* __restrict__ out, int32_t total,
                       uint32_t fanout_mul, uint32_t fanout_shift) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads +
                    static_cast<int32_t>(threadIdx.x);
  if (i >= total) return;
  const int32_t t = __ldg(targets + fast_div(i, fanout_mul, fanout_shift));
  const int32_t rnd = __ldg(rand + i);
  const int32_t start = __ldg(indptr + t);
  const int32_t deg = __ldg(indptr + t + 1) - start;
  int32_t v = t;  // degree-0 targets sample themselves
  if (deg > 0) {
    int32_t r = rnd % deg;
    if (r < 0) r += deg;  // floor-mod, as jnp's `%` takes it
    // start + r < indptr[t + 1] <= INT32_MAX: no overflow before the clamp
    v = __ldg(indices + min(start + r, last_edge));
  }
  out[i] = v;
}

// The cached variant (replaces neighbor_sample.py:neighbor_sample_cached,
// body `_cached_kernel`): the edge array stays off the card and the sampled
// entry is read from the (C, block_e) edge-block cache through the slot
// table, slot -1 (not resident) read as slot 0, as the TPU kernel clamps
// it.  The TPU kernel stages the pair of blocks (b, b+1) of each target, b
// = min(start / block_e, max_block), and picks pair[local], local = start -
// b * block_e + r; the entry it picks lies in block b + local / block_e =
// pos / block_e at offset pos % block_e, pos = start + r, whatever b is
// (b * block_e is a whole number of blocks), so the kernel divides pos once
// and needs no max_block.
//
// What bounds it at the out-of-core step's widths: latency.  A launch
// samples one chunk of a hop, ~100-500 targets at fanout 25 or 10 (320 to
// 12,800 outputs, a few KB), so the bytes are nanoseconds and a launch is
// its fixed cost plus one chain of dependent loads: targets -> indptr ->
// block_slots -> cache.
//
// What the design does about it:
// - the slot table (344 entries on reddit) is copied into shared memory
//   with cp.async at the top of each block, in flight beside targets ->
//   indptr, so the chain has three dependent global round trips, not four.
//   A table above kSlotBudget entries is looked up in global memory (the
//   <false> instance): the wrapper picks the instance;
// - rand[i] is loaded unconditionally at the top, beside targets[i / S];
// - no 64-bit division: i / S and pos / block_e are a widening multiply and
//   a shift by constants computed on the host (fast_divisor in
//   kernels/neighbor_sample.py: exact for every numerator below 2**31);
//   only rand mod deg, data-dependent, is a 32-bit division;
// - 128 threads a block (kCachedThreads; 64, 128 and 256 measured alike on
//   the card, PERF.md).
// It stays one launch per planned chunk: the cache's contents change
// between chunks.

constexpr int kCachedThreads = 128;
// slot-table entries staged in shared memory (16 KB); kernels/
// neighbor_sample.py's SLOT_BUDGET is the same number
constexpr int64_t kSlotBudget = 4096;

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(kCachedThreads)
neighbor_sample_cached_kernel(const int32_t* __restrict__ indptr,
                              const int32_t* __restrict__ block_slots,
                              int32_t num_slots,
                              const int32_t* __restrict__ cache,
                              uint32_t block_e, uint32_t block_mul,
                              uint32_t block_shift,
                              const int32_t* __restrict__ targets,
                              const int32_t* __restrict__ rand,
                              int32_t* __restrict__ out, int32_t total,
                              uint32_t fanout_mul, uint32_t fanout_shift) {
  extern __shared__ int32_t s_slots[];
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kCachedThreads +
                    static_cast<int32_t>(threadIdx.x);
  const bool live = i < total;
  int32_t t = 0, rnd = 0;
  if (live) {
    t = targets[fast_div(i, fanout_mul, fanout_shift)];
    rnd = rand[i];
  }
  if (kStaged) {
    for (int32_t k = threadIdx.x; k < num_slots; k += kCachedThreads)
      cp_async4(s_slots + k, block_slots + k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int32_t start = 0, deg = 0;
  if (live) {
    start = indptr[t];
    deg = indptr[t + 1] - start;
  }
  if (kStaged) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  if (!live) return;
  int32_t v = t;  // degree-0 targets sample themselves
  if (deg > 0) {
    int32_t r = rnd % deg;
    if (r < 0) r += deg;  // floor-mod, as jnp's `%` takes it
    const uint32_t pos = static_cast<uint32_t>(start + r);
    const uint32_t blk = fast_div(pos, block_mul, block_shift);
    int32_t slot = kStaged ? s_slots[blk] : block_slots[blk];
    if (slot < 0) slot = 0;
    v = cache[static_cast<int64_t>(slot) * block_e + (pos - blk * block_e)];
  }
  out[i] = v;
}

}  // namespace

// indptr: (N+1,), indices: (num_edges,), targets: (num_targets,), rand and
// out: (num_targets, fanout), all int32.  (fanout_mul, fanout_shift) divide
// by fanout.  num_targets * fanout and num_edges must be below 2**31.
extern "C" int neighbor_sample_launch(const void* indptr, const void* indices,
                                      int64_t num_edges, const void* targets,
                                      const void* rand, void* out,
                                      int64_t num_targets, int fanout,
                                      int64_t fanout_mul, int64_t fanout_shift,
                                      void* stream) {
  const int64_t total = num_targets * fanout;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (total >= (int64_t{1} << 31) || num_edges >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  neighbor_sample_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<int32_t>(num_edges - 1), static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(rand), static_cast<int32_t*>(out),
      static_cast<int32_t>(total), static_cast<uint32_t>(fanout_mul),
      static_cast<uint32_t>(fanout_shift));
  return static_cast<int>(cudaGetLastError());
}

// block_slots: (num_slots,) int32; cache: (C, block_e) int32; targets:
// (num_targets,), rand and out: (num_targets, fanout) int32.  (block_mul,
// block_shift) divide by block_e, (fanout_mul, fanout_shift) by fanout;
// `staged` picks the shared-memory slot table (num_slots <= kSlotBudget).
// num_targets * fanout must be below 2**31.
extern "C" int neighbor_sample_cached_launch(
    const void* indptr, const void* block_slots, int64_t num_slots,
    const void* cache, int64_t block_e, int64_t block_mul,
    int64_t block_shift, const void* targets, const void* rand, void* out,
    int64_t num_targets, int fanout, int64_t fanout_mul,
    int64_t fanout_shift, int staged, void* stream) {
  const int64_t total = num_targets * fanout;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (total >= (int64_t{1} << 31) || num_slots >= (int64_t{1} << 31) ||
      (staged && num_slots > kSlotBudget))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((total + kCachedThreads - 1) / kCachedThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* bs = static_cast<const int32_t*>(block_slots);
  const auto* c = static_cast<const int32_t*>(cache);
  const auto* tg = static_cast<const int32_t*>(targets);
  const auto* rd = static_cast<const int32_t*>(rand);
  auto* o = static_cast<int32_t*>(out);
  if (staged)
    neighbor_sample_cached_kernel<true>
        <<<blocks, kCachedThreads, num_slots * sizeof(int32_t), s>>>(
            ip, bs, static_cast<int32_t>(num_slots), c,
            static_cast<uint32_t>(block_e), static_cast<uint32_t>(block_mul),
            static_cast<uint32_t>(block_shift), tg, rd, o,
            static_cast<int32_t>(total), static_cast<uint32_t>(fanout_mul),
            static_cast<uint32_t>(fanout_shift));
  else
    neighbor_sample_cached_kernel<false><<<blocks, kCachedThreads, 0, s>>>(
        ip, bs, static_cast<int32_t>(num_slots), c,
        static_cast<uint32_t>(block_e), static_cast<uint32_t>(block_mul),
        static_cast<uint32_t>(block_shift), tg, rd, o,
        static_cast<int32_t>(total), static_cast<uint32_t>(fanout_mul),
        static_cast<uint32_t>(fanout_shift));
  return static_cast<int>(cudaGetLastError());
}
