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
