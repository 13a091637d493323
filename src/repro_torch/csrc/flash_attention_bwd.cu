// Flash-attention backward on Hopper: dQ, dK and dV of causal or full GQA
// attention, for LM training.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:_flash_bwd
// (bodies `_bwd_dkv_kernel` and `_bwd_dq_kernel`).  Both recompute the
// probabilities from the forward's logsumexp: s = q.k scaled by 1/sqrt(D),
// p = exp(s - lse) with masked scores at NEG_INF = -1e30, so p is exactly 0
// there and is written as 0 here; dv = p^T.dO; dp = dO.v^T;
// ds = p * (dp - delta) * scale; dk = ds^T.q; dq = ds.k; all in float32,
// dq, dk and dv written in bf16.  delta = rowsum(dO * O) is computed in
// float32 in the prologue of the dQ kernel (the reference computes it in jnp
// before its kernels) and written out for the dK/dV kernel, which runs after
// it on the same stream.
//
// What bounds it on this card: operations.  A causal backward needs at least
// five products of 2 * (S^2 / 2) * D flops per (batch, query head) (s, dp,
// dv, dk, dq); at qwen2-0.5b's training shape (B 4, S 4096, Hq 14, D 64)
// that is ~301 GFLOP a layer against ~50 MB of q, k, v, O, dO and the
// gradients, far above the ~295 flops per byte where HBM stops being the
// limit.  The bound is the bf16 tensor-core rate.  This split design does
// seven products (s and dp are recomputed in both kernels), as the
// reference's does.
//
// What the design does about it, simply first: scalar float32 (no tensor
// cores yet; `mma`/`wgmma` is later work), so every product, p and ds stay
// in float32 as in the TPU bodies.  Tiles live in shared memory row-major
// with one float of padding per row, so the 16 lanes that read 16 different
// rows at one column hit 16 banks.  A block has 256 threads as a 16 x 16
// grid: for the (query x key) tiles s, dp, p and ds a thread owns BQ/16 rows
// and BK/16 keys (tx + 16 * j); for the (key x head-dim) accumulators dk and
// dv it owns BK/16 keys and D/16 columns; for dq, BQ/16 rows and D/16
// columns.
// - dK/dV: one block per (batch, KV head, key tile).  It walks the group's
//   query heads (7 for qwen2) and, for each, the query tiles from the
//   diagonal to the end, skipping the tiles wholly above it; dk and dv of
//   its key tile accumulate in registers across the whole group and are
//   written once in bf16.  That replaces the reference's per-query-head
//   float32 (B, Hq, S, D) outputs and its wrapper's group sum (it takes the
//   2 * B * Hq * S * D * 4 bytes of scratch away); the sum runs in another
//   order.
// - dQ: one block per (batch, query head, query tile), walking the key tiles
//   from 0 to the diagonal; dq accumulates in registers.
// Key and query tiles are 64 wide up to D 128 and 32 at D 256, where the
// float32 tiles would not fit in 227 KB of shared memory and dk and dv in
// registers.  Any S is taken: the ragged tail of rows and keys is
// zero-filled and masked.  The lse is the forward kernel's output as it is,
// so both passes agree on NEG_INF and the max(l, 1e-30) clamp.  q, k, v,
// O and dO are read in the model's (B, S, H, D) layout through their
// strides, 16 bytes at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16

template <int DMAX>
struct Tiles {
  static constexpr int BQ = DMAX >= 256 ? 32 : 64;   // query rows per tile
  static constexpr int BK = BQ;                      // keys per tile
  static constexpr int RQ = BQ / 16;     // query rows per thread
  static constexpr int RK = BK / 16;     // keys per thread
  static constexpr int NO = DMAX / 16;   // head-dim columns per thread
  static constexpr int DS = DMAX + 1;    // row stride of the q/dO/k/v tiles
  static constexpr int PS = BK + 4;      // row stride of the p/ds tiles
  static constexpr int kDkvFloats = 2 * BK * DS + 2 * BQ * DS + 2 * BQ * PS
                                    + 2 * BQ;
  static constexpr int kDqFloats = 2 * BQ * DS + 2 * BK * DS + BQ * PS
                                   + 2 * BQ;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* src, bool ok,
                                      float* f) {
  if (!ok) {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    return;
  }
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// rows [r0, r0 + ROWS) of a (S, D) bf16 slice with row stride `ss` into a
// [ROWS][DS] float32 tile; rows at or past S read as zeros
template <int ROWS, int DS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base,
                                          int64_t ss, int r0, int S, int D,
                                          float* dst) {
  const int chunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * chunks; c += kThreads) {
    const int r = c / chunks, d0 = (c % chunks) * 8;
    float f[8];
    load8(base + (int64_t)(r0 + r) * ss + d0, r0 + r < S, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * DS + d0 + e] = f[e];
  }
}

// p and ds of the tile at (q0, k0) for rows ty * RQ + i and keys tx + 16 * j:
// s = q.k and dp = dO.v from shared memory, then p = exp(s * scale - lse) on
// the valid entries (0 elsewhere, what exp(NEG_INF - lse) gives) and
// ds = p * (dp - delta) * scale, stored at [row][key] of sP (if given) and
// sG.
template <int DMAX>
__device__ __forceinline__ void probs(const float* sQ, const float* sO,
                                      const float* sK, const float* sV,
                                      const float* sL, const float* sD,
                                      float* sP, float* sG, int q0, int k0,
                                      int S, int D, float scale, int causal) {
  using T = Tiles<DMAX>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[T::RQ][T::RK], dp[T::RQ][T::RK];
#pragma unroll
  for (int i = 0; i < T::RQ; ++i)
#pragma unroll
    for (int j = 0; j < T::RK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[T::RQ], ov[T::RQ], kv[T::RK], vv[T::RK];
#pragma unroll
    for (int i = 0; i < T::RQ; ++i) {
      qv[i] = sQ[(ty * T::RQ + i) * T::DS + d];
      ov[i] = sO[(ty * T::RQ + i) * T::DS + d];
    }
#pragma unroll
    for (int j = 0; j < T::RK; ++j) {
      kv[j] = sK[(tx + 16 * j) * T::DS + d];
      vv[j] = sV[(tx + 16 * j) * T::DS + d];
    }
#pragma unroll
    for (int i = 0; i < T::RQ; ++i)
#pragma unroll
      for (int j = 0; j < T::RK; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += ov[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int r = ty * T::RQ + i, qpos = q0 + r;
    const float lse = sL[r], delta = sD[r];
#pragma unroll
    for (int j = 0; j < T::RK; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool ok = qpos < S && kpos < S && (!causal || kpos <= qpos);
      const float p = ok ? expf(s[i][j] * scale - lse) : 0.0f;
      if (sP != nullptr) sP[r * T::PS + c] = p;
      sG[r * T::PS + c] = p * (dp[i][j] - delta) * scale;
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int Hq, int Hkv,
                     int group, int D, int64_t q_sb, int64_t q_ss,
                     int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                     int64_t o_ss, int64_t o_sh, float scale, int causal) {
  using T = Tiles<DMAX>;
  extern __shared__ float smem[];
  float* sK = smem;                        // [BK][DS]
  float* sV = sK + T::BK * T::DS;          // [BK][DS]
  float* sQ = sV + T::BK * T::DS;          // [BQ][DS]
  float* sO = sQ + T::BQ * T::DS;          // dO, [BQ][DS]
  float* sP = sO + T::BQ * T::DS;          // p, [BQ][PS]
  float* sG = sP + T::BQ * T::PS;          // ds, [BQ][PS]
  float* sL = sG + T::BQ * T::PS;          // lse, [BQ]
  float* sD = sL + T::BQ;                  // delta, [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * T::BK;       // the first key tiles see most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  load_tile<T::BK, T::DS>(k + b * k_sb + hk * k_sh, k_ss, k0, S, D, sK);
  load_tile<T::BK, T::DS>(v + b * v_sb + hk * v_sh, v_ss, k0, S, D, sV);

  float ak[T::RK][T::NO], av[T::RK][T::NO];
#pragma unroll
  for (int i = 0; i < T::RK; ++i)
#pragma unroll
    for (int j = 0; j < T::NO; ++j) ak[i][j] = av[i][j] = 0.0f;

  // BQ == BK: the query tile holding the diagonal starts at k0, and the
  // tiles before it lie wholly above the diagonal
  const int q_first = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
    const float* lb = lse + ((int64_t)b * Hq + h) * S;
    const float* db = delta + ((int64_t)b * Hq + h) * S;
    for (int q0 = q_first; q0 < S; q0 += T::BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<T::BQ, T::DS>(qb, q_ss, q0, S, D, sQ);
      load_tile<T::BQ, T::DS>(ob, o_ss, q0, S, D, sO);
      for (int r = tid; r < T::BQ; r += kThreads) {
        const bool ok = q0 + r < S;
        sL[r] = ok ? lb[q0 + r] : 0.0f;
        sD[r] = ok ? db[q0 + r] : 0.0f;
      }
      __syncthreads();
      probs<DMAX>(sQ, sO, sK, sV, sL, sD, sP, sG, q0, k0, S, D, scale,
                  causal);
      __syncthreads();

      // dv += p^T.dO and dk += ds^T.q: keys ty * RK + i, columns tx + 16 * j
      const int qn = min(T::BQ, S - q0);
      for (int r = 0; r < qn; ++r) {
        float pv[T::RK], gv[T::RK];
#pragma unroll
        for (int i = 0; i < T::RK; ++i) {
          pv[i] = sP[r * T::PS + ty * T::RK + i];
          gv[i] = sG[r * T::PS + ty * T::RK + i];
        }
#pragma unroll
        for (int j = 0; j < T::NO; ++j) {
          if (16 * j < D) {
            const float o = sO[r * T::DS + tx + 16 * j];
            const float x = sQ[r * T::DS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < T::RK; ++i) {
              av[i][j] += pv[i] * o;
              ak[i][j] += gv[i] * x;
            }
          }
        }
      }
    }
  }

  // dk and dv: (B, S, Hkv, D), contiguous
#pragma unroll
  for (int i = 0; i < T::RK; ++i) {
    const int r = k0 + ty * T::RK + i;
    if (r >= S) continue;
    const int64_t off = (((int64_t)b * S + r) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < T::NO; ++j) {
      if (16 * j < D) {
        dk[off + tx + 16 * j] = __float2bfloat16(ak[i][j]);
        dv[off + tx + 16 * j] = __float2bfloat16(av[i][j]);
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ out,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int S, int Hq, int group,
                    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, int64_t x_sb, int64_t x_ss,
                    int64_t x_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                    float scale, int causal) {
  using T = Tiles<DMAX>;
  extern __shared__ float smem[];
  float* sQ = smem;                        // [BQ][DS]
  float* sO = sQ + T::BQ * T::DS;          // dO, [BQ][DS]
  float* sK = sO + T::BQ * T::DS;          // [BK][DS]
  float* sV = sK + T::BK * T::DS;          // [BK][DS]
  float* sG = sV + T::BK * T::DS;          // ds, [BQ][PS]
  float* sL = sG + T::BQ * T::PS;          // lse, [BQ]
  float* sD = sL + T::BQ;                  // delta, [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  load_tile<T::BQ, T::DS>(q + b * q_sb + h * q_sh, q_ss, q0, S, D, sQ);
  load_tile<T::BQ, T::DS>(dout + b * o_sb + h * o_sh, o_ss, q0, S, D, sO);
  const float* lb = lse + ((int64_t)b * Hq + h) * S;
  for (int r = tid; r < T::BQ; r += kThreads)
    sL[r] = q0 + r < S ? lb[q0 + r] : 0.0f;
  __syncthreads();

  // delta = rowsum(dO * O) in float32, a warp per row; written out for the
  // dK/dV kernel
  const int warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* xb = out + b * x_sb + h * x_sh;
  for (int r = warp; r < T::BQ; r += kThreads / 32) {
    float acc = 0.0f;
    if (q0 + r < S) {
      const __nv_bfloat16* row = xb + (int64_t)(q0 + r) * x_ss;
      for (int d = lane; d < D; d += 32)
        acc += sO[r * T::DS + d] * __bfloat162float(row[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sD[r] = acc;
      if (q0 + r < S) delta[((int64_t)b * Hq + h) * S + q0 + r] = acc;
    }
  }

  float acc[T::RQ][T::NO];
#pragma unroll
  for (int i = 0; i < T::RQ; ++i)
#pragma unroll
    for (int j = 0; j < T::NO; ++j) acc[i][j] = 0.0f;

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int k_end = causal ? min(S, q0 + T::BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += T::BK) {
    __syncthreads();   // the previous tile's readers are done; sD is written
    load_tile<T::BK, T::DS>(kb, k_ss, k0, S, D, sK);
    load_tile<T::BK, T::DS>(vb, v_ss, k0, S, D, sV);
    __syncthreads();
    probs<DMAX>(sQ, sO, sK, sV, sL, sD, nullptr, sG, q0, k0, S, D, scale,
                causal);
    __syncthreads();

    // dq += ds.k: rows ty * RQ + i, columns tx + 16 * j
    const int kn = min(T::BK, k_end - k0);
    for (int c = 0; c < kn; ++c) {
      float gv[T::RQ];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i) gv[i] = sG[(ty * T::RQ + i) * T::PS + c];
#pragma unroll
      for (int j = 0; j < T::NO; ++j) {
        if (16 * j < D) {
          const float x = sK[c * T::DS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < T::RQ; ++i) acc[i][j] += gv[i] * x;
        }
      }
    }
  }

  // dq: (B, S, Hq, D), contiguous
#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int r = q0 + ty * T::RQ + i;
    if (r >= S) continue;
    __nv_bfloat16* o = dq + (((int64_t)b * S + r) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < T::NO; ++j)
      if (16 * j < D) o[tx + 16 * j] = __float2bfloat16(acc[i][j]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

typedef const __nv_bfloat16* bf16p;

template <int DMAX>
cudaError_t launch_dq(bf16p q, bf16p k, bf16p v, bf16p out, bf16p dout,
                      const float* lse, float* delta, __nv_bfloat16* dq,
                      int B, int S, int Hq, int Hkv, int D, const int64_t* qs,
                      const int64_t* ks, const int64_t* vs, const int64_t* xs,
                      const int64_t* os, float scale, int causal,
                      cudaStream_t stream) {
  using T = Tiles<DMAX>;
  const size_t smem = sizeof(float) * T::kDqFloats;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::BQ - 1) / T::BQ, Hq, B);
  flash_bwd_dq_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, dout, lse, delta, dq, S, Hq, Hq / Hkv, D, qs[0], qs[1],
      qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], xs[0], xs[1], xs[2],
      os[0], os[1], os[2], scale, causal);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(bf16p q, bf16p k, bf16p v, bf16p dout,
                       const float* lse, const float* delta,
                       __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S,
                       int Hq, int Hkv, int D, const int64_t* qs,
                       const int64_t* ks, const int64_t* vs,
                       const int64_t* os, float scale, int causal,
                       cudaStream_t stream) {
  using T = Tiles<DMAX>;
  const size_t smem = sizeof(float) * T::kDkvFloats;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::BK - 1) / T::BK, Hkv, B);
  flash_bwd_dkv_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Hq, Hkv, Hq / Hkv, D, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os[0], os[1],
      os[2], scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int D, int Hq, int Hkv) {
  return D % 16 != 0 || D < 16 || D > 256 || Hkv < 1 || Hq % Hkv != 0;
}

}  // namespace

// q and out (O): (B, S, Hq, D), k and v: (B, S, Hkv, D), dout (dO): (B, S,
// Hq, D), all bf16 with element strides {batch, seq, head} in *_strides
// (x_strides are O's, do_strides dO's; last dim contiguous, rows 16-byte
// aligned); lse: (B, Hq, S) float32 from the forward kernel, contiguous.
// Writes dq (B, S, Hq, D) bf16 and delta (B, Hq, S) float32, both
// contiguous.  D is a multiple of 16 up to 256 and Hq a multiple of Hkv.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int B, int S,
    int Hq, int Hkv, int D, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* x_strides, const int64_t* do_strides, float scale,
    int causal, void* stream) {
  if (B == 0 || S == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(D, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  bf16p qq = static_cast<bf16p>(q), kk = static_cast<bf16p>(k);
  bf16p vv = static_cast<bf16p>(v), xx = static_cast<bf16p>(out);
  bf16p oo = static_cast<bf16p>(dout);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch_dq<64>(
        qq, kk, vv, xx, oo, ls, dl, g, B, S, Hq, Hkv, D, q_strides,
        k_strides, v_strides, x_strides, do_strides, scale, causal, s));
  if (D <= 128)
    return static_cast<int>(launch_dq<128>(
        qq, kk, vv, xx, oo, ls, dl, g, B, S, Hq, Hkv, D, q_strides,
        k_strides, v_strides, x_strides, do_strides, scale, causal, s));
  return static_cast<int>(launch_dq<256>(
      qq, kk, vv, xx, oo, ls, dl, g, B, S, Hq, Hkv, D, q_strides, k_strides,
      v_strides, x_strides, do_strides, scale, causal, s));
}

// q, k, v, dout and lse as above; delta: (B, Hq, S) float32 from
// flash_attention_bwd_dq_launch, contiguous.  Writes dk and dv (B, S, Hkv,
// D) bf16, contiguous, each summed over the group's query heads.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int Hq, int Hkv, int D, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* do_strides, float scale, int causal, void* stream) {
  if (B == 0 || S == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(D, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  bf16p qq = static_cast<bf16p>(q), kk = static_cast<bf16p>(k);
  bf16p vv = static_cast<bf16p>(v), oo = static_cast<bf16p>(dout);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch_dkv<64>(
        qq, kk, vv, oo, ls, dl, gk, gv, B, S, Hq, Hkv, D, q_strides,
        k_strides, v_strides, do_strides, scale, causal, s));
  if (D <= 128)
    return static_cast<int>(launch_dkv<128>(
        qq, kk, vv, oo, ls, dl, gk, gv, B, S, Hq, Hkv, D, q_strides,
        k_strides, v_strides, do_strides, scale, causal, s));
  return static_cast<int>(launch_dkv<256>(
      qq, kk, vv, oo, ls, dl, gk, gv, B, S, Hq, Hkv, D, q_strides, k_strides,
      v_strides, do_strides, scale, causal, s));
}
