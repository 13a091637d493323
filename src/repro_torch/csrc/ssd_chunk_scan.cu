// Mamba-2 SSD chunked scan on Hopper: the selective state-space scan of the
// SSM mixer's prefill, in the chunked (state-space duality) form.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk_scan.py:ssd_chunk_scan
// (body `_kernel`).  For every (batch b, head j, chunk c) of q positions,
// with cs = cumsum(dt * A) within the chunk:
//   y_i   = sum_{k <= i} (C_i . B_k) exp(cs_i - cs_k) dt_k x_k
//           + exp(cs_i) C_i . prev                              (P values)
//   state = exp(cs_last) state + sum_k exp(cs_last - cs_k) dt_k x_k (x) B_k
// where prev is the (P x N) state before the chunk (zero before chunk 0)
// and head j reads group j / (h / g) of B and C.  All in float32, as the
// TPU kernel computes (its inputs are float32, every product float32).
//
// What bounds it on this card: operations.  At mamba2-370m's prefill (b 8,
// s 2048, h 32, p 64, n 128, chunk 256) the two q x q products over the
// i >= k half, the chunk states and the inter-chunk term are ~43 GFLOP a
// layer against ~295 MB of inputs and outputs, ~146 flops a byte; the
// scalar float32 rate (67 TFLOP/s) is the bound, 0.64 ms a layer, and the
// bytes would allow 0.09 ms.
//
// What the design does about it, simply first (scalar float32, no tensor
// cores; TF32 `mma`/`wgmma` is later work).  The TPU grid walks the chunks of
// one (b, h) in series and carries the state in VMEM; here that would leave
// b*h blocks, each walking every chunk.  Instead the three stages of the
// reference's `ssd_chunked` are three launches on the caller's stream:
//   1. chunk states: one block per (b, h, chunk).  The chunk's prefix sum
//      of dt*A is a block scan over its q <= 256 positions, written to a
//      float32 scratch cs (b, h, nc, q); the chunk's own state, the
//      (P x q).(q x N) product of exp(cs_last - cs)*dt*x and B, is written
//      to a float32 scratch (b, h, nc, P, N), 64 positions at a time
//      through shared memory, each thread holding a (P/16) x (N/16)
//      register tile;
//   2. state pass: one thread per (b, h, p, n) walks the nc chunks,
//      prev[c] = run, run = run*exp(cs_last[c]) + states[c], writing prev
//      over the chunk states and the final state;
//   3. output: one block per (b, h, chunk, 64-row tile), the flash forward's
//      tile loop without the softmax: the block's C rows (transposed) and,
//      per 64-key tile up to the diagonal, B (transposed) and x in shared
//      memory; s_ik = C_i . B_k in 4 x 4 register tiles, scaled by
//      exp(cs_i - cs_k)*dt_k where k <= i and set to 0 elsewhere, then
//      acc_i += s_ik x_k; the inter-chunk term exp(cs_i) C_i . prev is
//      computed first from prev staged (transposed) in the same shared
//      memory the key tiles use later.
// Overflow: cs falls by up to q*dt*|A| within a chunk, so exp(cs_i)*
// exp(-cs_k) overflows in float32; only differences cs_i - cs_k with
// i >= k (and cs_last - cs_k, and cs_i itself, all <= 0) are exponentiated,
// and a masked entry is a 0 written in place of the product, never 0*inf.
// At mamba2's shape stage 3 takes 104 KB of shared memory (2 blocks an SM)
// and has b*h*nc*4 blocks (8,192 at b 8); stage 1 has b*h*nc (2,048 at b
// 8, 256 at b 1).  The scratch comes from the caller (PyTorch's allocator).
// Inputs are contiguous: x (b, s, h, p), dt (b, s, h), A (h,), B and C
// (b, s, g, n); p and n up to 128, chunk up to 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = 64;              // positions per tile
constexpr int kMaxChunk = 256;         // one position per thread in the scan
constexpr int kMaxDim = 128;           // p and n
constexpr int kRowStride = kRows + 4;  // transposed rows, float4-aligned
constexpr int kKeyStride = kRows + 1;  // transposed B rows

// inclusive prefix sum of one value per thread over the block
__device__ float block_scan(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kThreads / 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? v + warp_sums[warp - 1] : v;
}

template <int PT, int NT>
constexpr int state_smem_bytes() {
  return sizeof(float) * (kMaxChunk + kRows * 16 * PT + kRows * 16 * NT);
}

// stage 1: cs and the chunk's own state, one block per (chunk, head, batch)
template <int PT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ cs,
                       float* __restrict__ states, int s, int h, int p,
                       int g, int n, int chunk) {
  constexpr int PW = 16 * PT, NW = 16 * NT;
  extern __shared__ float smem[];
  float* sW = smem;                 // [kMaxChunk] exp(cs_last - cs) * dt
  float* sX = sW + kMaxChunk;       // [kRows][PW] x rows times sW
  float* sB = sX + kRows * PW;      // [kRows][NW]
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float cs_last;

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int grp = hh / (h / g);
  const int64_t t0 = (int64_t)bb * s + (int64_t)c * chunk;  // row in (b, s)
  const int64_t bhc = ((int64_t)bb * h + hh) * nc + c;

  const float dtv = tid < chunk ? dt[(t0 + tid) * h + hh] : 0.0f;
  const float csv = block_scan(dtv * A[hh], warp_sums);
  if (tid == chunk - 1) cs_last = csv;
  __syncthreads();
  if (tid < chunk) {
    cs[bhc * chunk + tid] = csv;
    sW[tid] = expf(cs_last - csv) * dtv;
  }

  const int tx = tid & 15, ty = tid >> 4;
  float acc[PT][NT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.0f;

  for (int q0 = 0; q0 < chunk; q0 += kRows) {
    __syncthreads();   // sW is written; the previous tile's readers are done
    for (int e = tid; e < kRows * PW; e += kThreads) {
      const int r = e / PW, col = e % PW, q = q0 + r;
      sX[e] = q < chunk && col < p
                  ? x[((t0 + q) * h + hh) * p + col] * sW[q] : 0.0f;
    }
    for (int e = tid; e < kRows * NW; e += kThreads) {
      const int r = e / NW, col = e % NW, q = q0 + r;
      sB[e] = q < chunk && col < n ? B[((t0 + q) * g + grp) * n + col]
                                   : 0.0f;
    }
    __syncthreads();
    const int rn = min(kRows, chunk - q0);
    for (int r = 0; r < rn; ++r) {
      float xv[PT], bv[NT];
#pragma unroll
      for (int i = 0; i < PT; ++i) xv[i] = sX[r * PW + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NT; ++j) bv[j] = sB[r * NW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

  float* out = states + bhc * p * n;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pp = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nn = tx + 16 * j;
      if (pp < p && nn < n) out[pp * n + nn] = acc[i][j];
    }
  }
}

// stage 2: the state recurrence across chunks, one thread per (b, h, p, n)
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ cs, float* __restrict__ states,
                      float* __restrict__ final_state, int nc, int chunk,
                      int pn, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t bh = idx / pn;
  const int e = static_cast<int>(idx % pn);
  const float* last = cs + bh * nc * chunk + chunk - 1;
  float* st = states + bh * nc * pn + e;
  float run = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float own = st[(int64_t)c * pn];
    st[(int64_t)c * pn] = run;
    run = run * expf(last[(int64_t)c * chunk]) + own;
  }
  final_state[idx] = run;
}

template <int PT>
constexpr int output_smem_bytes(int n) {
  return sizeof(float) *
         (2 * kMaxChunk + n * kRowStride + kRows * kRowStride +
          (n * 16 * PT > n * kKeyStride + kRows * 16 * PT
               ? n * 16 * PT : n * kKeyStride + kRows * 16 * PT));
}

// stage 3: y, one block per (chunk x 64-row tile, head, batch)
template <int PT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_output_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ B,
                        const float* __restrict__ C,
                        const float* __restrict__ cs,
                        const float* __restrict__ prev, float* __restrict__ y,
                        int s, int h, int p, int g, int n, int chunk,
                        int tiles) {
  constexpr int PW = 16 * PT;
  extern __shared__ float smem[];
  float* sCs = smem;                    // [kMaxChunk] cs of the chunk
  float* sDt = sCs + kMaxChunk;         // [kMaxChunk] dt of the chunk
  float* sC = sDt + kMaxChunk;          // [n][kRowStride] C rows, transposed
  float* sP = sC + n * kRowStride;      // [kRows][kRowStride] s, transposed
  float* sU = sP + kRows * kRowStride;  // prev^T [n][PW]; then:
  float* sBt = sU;                      //   [n][kKeyStride] B keys, transposed
  float* sX = sU + n * kKeyStride;      //   [kRows][PW] x keys

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int c = blockIdx.x / tiles;
  const int tile = tiles - 1 - blockIdx.x % tiles;   // heaviest first
  const int nc = gridDim.x / tiles;
  const int i0 = tile * kRows;
  const int row_end = min(chunk, i0 + kRows);
  const int grp = hh / (h / g);
  const int64_t t0 = (int64_t)bb * s + (int64_t)c * chunk;
  const int64_t bhc = ((int64_t)bb * h + hh) * nc + c;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < row_end; e += kThreads) {
    sCs[e] = cs[bhc * chunk + e];
    sDt[e] = dt[(t0 + e) * h + hh];
  }
  for (int e = tid; e < kRows * n; e += kThreads) {
    const int r = e / n, k = e % n;
    sC[k * kRowStride + r] =
        i0 + r < chunk ? C[((t0 + i0 + r) * g + grp) * n + k] : 0.0f;
  }
  const bool has_prev = c > 0;   // the state before chunk 0 is zero
  if (has_prev) {
    const float* pv = prev + bhc * p * n;
    for (int e = tid; e < PW * n; e += kThreads) {
      const int pp = e / n, k = e % n;
      sU[k * PW + pp] = pp < p ? pv[(int64_t)pp * n + k] : 0.0f;
    }
  }
  __syncthreads();

  // rows i0 + ty*4 + i, columns tx + 16*j
  float acc[4][PT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[i][j] = 0.0f;
  if (has_prev) {
    for (int k = 0; k < n; ++k) {
      const float4 cv =
          *reinterpret_cast<const float4*>(&sC[k * kRowStride + ty * 4]);
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const float pw = sU[k * PW + tx + 16 * j];
        acc[0][j] = fmaf(cv.x, pw, acc[0][j]);
        acc[1][j] = fmaf(cv.y, pw, acc[1][j]);
        acc[2][j] = fmaf(cv.z, pw, acc[2][j]);
        acc[3][j] = fmaf(cv.w, pw, acc[3][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty * 4 + i;
      const float decay = r < row_end ? expf(sCs[r]) : 0.0f;
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[i][j] *= decay;
    }
  }

  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();   // prev's and the previous tile's readers are done
    for (int e = tid; e < kRows * n; e += kThreads) {
      const int r = e / n, k = e % n;
      sBt[k * kKeyStride + r] =
          k0 + r < chunk ? B[((t0 + k0 + r) * g + grp) * n + k] : 0.0f;
    }
    for (int e = tid; e < kRows * PW; e += kThreads) {
      const int r = e / PW, col = e % PW;
      sX[e] = k0 + r < chunk && col < p
                  ? x[((t0 + k0 + r) * h + hh) * p + col] : 0.0f;
    }
    __syncthreads();

    // s = C . B^T: rows ty*4 + i, keys tx + 16*jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 cv =
          *reinterpret_cast<const float4*>(&sC[k * kRowStride + ty * 4]);
      float bv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = sBt[k * kKeyStride + tx + 16 * jj];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sc[0][jj] = fmaf(cv.x, bv[jj], sc[0][jj]);
        sc[1][jj] = fmaf(cv.y, bv[jj], sc[1][jj]);
        sc[2][jj] = fmaf(cv.z, bv[jj], sc[2][jj]);
        sc[3][jj] = fmaf(cv.w, bv[jj], sc[3][jj]);
      }
    }
    // the decay where key <= row, 0 elsewhere (no exp of a positive value)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kk = k0 + tx + 16 * jj;
        sc[i][jj] = kk <= r && r < row_end
                        ? sc[i][jj] * (expf(sCs[r] - sCs[kk]) * sDt[kk])
                        : 0.0f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(&sP[(tx + 16 * jj) * kRowStride + ty * 4]) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncthreads();

    // acc += s . x over the keys up to the block's last row
    const int kn = min(kRows, row_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 pr =
          *reinterpret_cast<const float4*>(&sP[kk * kRowStride + ty * 4]);
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const float xv = sX[kk * PW + tx + 16 * j];
        acc[0][j] = fmaf(pr.x, xv, acc[0][j]);
        acc[1][j] = fmaf(pr.y, xv, acc[1][j]);
        acc[2][j] = fmaf(pr.z, xv, acc[2][j]);
        acc[3][j] = fmaf(pr.w, xv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= row_end) continue;
    float* yo = y + ((t0 + r) * h + hh) * p;
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (tx + 16 * j < p) yo[tx + 16 * j] = acc[i][j];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* configured) {
  if (*configured >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

struct Args {
  const float *x, *dt, *A, *B, *C;
  float *y, *final_state, *cs, *states;
  int b, s, h, p, g, n, chunk;
  cudaStream_t stream;
};

template <int PT, int NT>
cudaError_t launch_states(const Args& a) {
  static int configured = 0;
  constexpr int smem = state_smem_bytes<PT, NT>();
  cudaError_t err =
      allow_smem(ssd_chunk_state_kernel<PT, NT>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.s / a.chunk, a.h, a.b);
  ssd_chunk_state_kernel<PT, NT><<<grid, kThreads, smem, a.stream>>>(
      a.x, a.dt, a.A, a.B, a.cs, a.states, a.s, a.h, a.p, a.g, a.n, a.chunk);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_states_n(const Args& a) {
  if (a.n <= 16) return launch_states<PT, 1>(a);
  if (a.n <= 32) return launch_states<PT, 2>(a);
  if (a.n <= 64) return launch_states<PT, 4>(a);
  return launch_states<PT, 8>(a);
}

template <int PT>
cudaError_t launch_output(const Args& a) {
  static int configured = 0;
  const int smem = output_smem_bytes<PT>(a.n);
  cudaError_t err = allow_smem(ssd_chunk_output_kernel<PT>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int tiles = (a.chunk + kRows - 1) / kRows;
  const dim3 grid(a.s / a.chunk * tiles, a.h, a.b);
  ssd_chunk_output_kernel<PT><<<grid, kThreads, smem, a.stream>>>(
      a.x, a.dt, a.B, a.C, a.cs, a.states, a.y, a.s, a.h, a.p, a.g, a.n,
      a.chunk, tiles);
  return cudaGetLastError();
}

}  // namespace

// x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n), all contiguous
// float32 -> y (b, s, h, p) and final_state (b, h, p, n), contiguous float32;
// cs (b, h, s/chunk, chunk) and states (b, h, s/chunk, p, n) are float32
// scratch.  s > 0 a multiple of chunk <= 256, h a multiple of g, p and n in
// [1, 128].  Three launches on `stream`.
extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, void* y,
                                     void* final_state, void* cs,
                                     void* states, int b, int s, int h, int p,
                                     int g, int n, int chunk, void* stream) {
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || chunk > kMaxChunk || s < chunk || s % chunk != 0 ||
      g < 1 || h % g != 0 || p < 1 || p > kMaxDim || n < 1 || n > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(B),
               static_cast<const float*>(C), static_cast<float*>(y),
               static_cast<float*>(final_state), static_cast<float*>(cs),
               static_cast<float*>(states), b, s, h, p, g, n, chunk,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = p <= 64 ? launch_states_n<4>(a) : launch_states_n<8>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pn = p * n;
  const int64_t total = (int64_t)b * h * pn;
  ssd_state_pass_kernel<<<static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, a.stream>>>(
      a.cs, a.states, a.final_state, s / chunk, chunk, pn, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = p <= 64 ? launch_output<4>(a) : launch_output<8>(a);
  return static_cast<int>(err);
}
