// CSR fanout sampling on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/neighbor_sample.py:neighbor_sample
// (body `_kernel`): out[m, s] = indices[indptr[t] + rand[m, s] mod deg(t)],
// or t when deg(t) == 0, with t = targets[m]; int32 throughout.
//
// What bounds it on this card: latency and random 32-byte sector reads.
// Per output it reads one 4-byte entry of `indices` at a data-dependent
// place, and per target two 4-byte `indptr` entries, so a call moves a few
// MB and the bandwidth bound is microseconds; the time is the dependent
// chain targets -> indptr -> indices and the launch itself.
//
// What the design does about it: one thread per output, so every load of
// the chain is in flight across the whole grid at once and no thread waits
// on another.  The TPU kernel's block staging (a VMEM pair of edge blocks
// per target, `edge_pad` / `max_base`, the one-hot iota gather, TILE_M
// padding with node 0) exists to feed the TPU's vector unit and is not
// carried over: each thread reads its one sampled entry directly, so there
// is no `max_degree <= block_e` limit, and the ragged edge of the grid is
// masked rather than padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void neighbor_sample_kernel(const int32_t* __restrict__ indptr,
                                       const int32_t* __restrict__ indices,
                                       int64_t num_edges,
                                       const int32_t* __restrict__ targets,
                                       const int32_t* __restrict__ rand,
                                       int32_t* __restrict__ out,
                                       int64_t total, int fanout) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int32_t t = targets[i / fanout];
  const int32_t start = indptr[t];
  const int32_t deg = indptr[t + 1] - start;
  int32_t v = t;  // degree-0 targets sample themselves
  if (deg > 0) {
    int32_t r = rand[i] % deg;
    if (r < 0) r += deg;  // floor-mod, as jnp's `%` takes it
    int64_t pos = static_cast<int64_t>(start) + r;
    if (pos > num_edges - 1) pos = num_edges - 1;
    v = indices[pos];
  }
  out[i] = v;
}

// The cached variant (replaces neighbor_sample.py:neighbor_sample_cached,
// body `_cached_kernel`): the edge array stays off the card and the sampled
// entry is read from the (C, block_e) edge-block cache.  The TPU kernel
// stages the pair of blocks (b, b+1) of each target, b = min(start /
// block_e, max_block), and picks pair[start - b * block_e + r]; here the
// thread computes that position `local` and reads its one entry from block
// b + local / block_e through the slot table, with slot -1 (not resident)
// read as slot 0, as the TPU kernel clamps it.  No pair is staged in shared
// memory: on a graph whose largest neighbour list is ~38k entries a pair is
// ~300 KB, more than a block's 227 KB, and each thread needs one entry of
// it.  Same bound and design as above, with one more dependent load
// (block_slots) in the chain.
__global__ void neighbor_sample_cached_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ block_slots,
    const int32_t* __restrict__ cache, int64_t block_e, int64_t max_block,
    const int32_t* __restrict__ targets, const int32_t* __restrict__ rand,
    int32_t* __restrict__ out, int64_t total, int fanout) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int32_t t = targets[i / fanout];
  const int64_t start = indptr[t];
  const int32_t deg = indptr[t + 1] - static_cast<int32_t>(start);
  int32_t v = t;  // degree-0 targets sample themselves
  if (deg > 0) {
    int32_t r = rand[i] % deg;
    if (r < 0) r += deg;  // floor-mod, as jnp's `%` takes it
    int64_t b = start / block_e;
    if (b > max_block) b = max_block;
    const int64_t local = start - b * block_e + r;
    int64_t slot = block_slots[b + local / block_e];
    if (slot < 0) slot = 0;
    v = cache[slot * block_e + local % block_e];
  }
  out[i] = v;
}

}  // namespace

extern "C" int neighbor_sample_launch(const void* indptr, const void* indices,
                                      int64_t num_edges, const void* targets,
                                      const void* rand, void* out,
                                      int64_t num_targets, int fanout,
                                      void* stream) {
  const int64_t total = num_targets * fanout;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  neighbor_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      num_edges, static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(rand), static_cast<int32_t*>(out), total,
      fanout);
  return static_cast<int>(cudaGetLastError());
}

// block_slots: (NB+1,) int32; cache: (C, block_e) int32; the rest as above.
extern "C" int neighbor_sample_cached_launch(
    const void* indptr, const void* block_slots, const void* cache,
    int64_t block_e, int64_t max_block, const void* targets, const void* rand,
    void* out, int64_t num_targets, int fanout, void* stream) {
  const int64_t total = num_targets * fanout;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  neighbor_sample_cached_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(block_slots),
      static_cast<const int32_t*>(cache), block_e, max_block,
      static_cast<const int32_t*>(targets), static_cast<const int32_t*>(rand),
      static_cast<int32_t*>(out), total, fanout);
  return static_cast<int>(cudaGetLastError());
}
