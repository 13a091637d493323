// Flash-attention backward on Hopper: dQ, dK and dV of causal or full GQA
// attention, for LM training.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:_flash_bwd
// (bodies `_bwd_dkv_kernel` and `_bwd_dq_kernel`).  Both recompute the
// probabilities from the forward's logsumexp: s = q.k scaled by 1/sqrt(D),
// p = exp(s - lse) with masked scores at NEG_INF = -1e30, so p is exactly 0
// there and is written as 0 here; dv = p^T.dO; dp = dO.v^T;
// ds = p * (dp - delta) * scale; dk = ds^T.q; dq = ds.k; dq, dk and dv
// written in bf16.  delta = rowsum(dO * O) is computed in float32 in the
// prologue of the dQ kernel (the reference computes it in jnp before its
// kernels) and written out for the dK/dV kernel, which runs after it on the
// same stream.  The lse is the forward kernel's output as it is, so both
// passes agree on NEG_INF and the max(l, 1e-30) clamp.
//
// What bounds it on this card: operations.  A causal backward needs at least
// five products of 2 * (S^2 / 2) * D flops per (batch, query head) (s, dp,
// dv, dk, dq); at qwen2-0.5b's training shape (B 4, S 4096, Hq 14, D 64)
// that is ~301 GFLOP a layer against ~50 MB of q, k, v, O, dO and the
// gradients, far above the ~295 flops per byte where HBM stops being the
// limit.  The bound is the bf16 tensor-core rate, 989 TFLOP/s.  This split
// design does seven products (s and dp are recomputed in both kernels), as
// the reference's does.
//
// - dK/dV, on the tensor cores: one block per (64 keys of one KV head,
//   batch; at D 256 also one half of D's columns), issued heaviest tile
//   first, with one consumer warpgroup and one producer warp.  Everything
//   is computed transposed, with the key tile as wgmma's M, so all four
//   products take the shared-memory tiles in their natural row-major
//   layout and P^T and dS^T never leave registers:
//     1. S^T = K.Q^T and 4. dP^T = V.dO^T: wgmma.m64n64k16 with A (K, V)
//        and B (the q and dO tiles) K-major in shared memory;
//     2. P^T = exp(S^T * scale - lse), lse per column (query), 0 on masked
//        entries and on query rows >= S;
//     5. dS^T = P^T * (dP^T - delta) * scale in float32;
//     3. dV += P^T.dO and 6. dK += dS^T.q: A = P^T and dS^T rounded to
//        bf16 in registers (the accumulator layout is the A-fragment
//        layout), B = dO and q MN-major in shared memory (the transpose
//        bit), D/64 instructions per 16 queries.
//   K and V are loaded once by TMA; the producer walks the group's query
//   heads (7 for qwen2) and, per head, the query tiles from the diagonal to
//   S, loading the q and dO tiles (4-d tensor maps over the strided (B, S,
//   H, D) views, 128-byte swizzle, zero fill past S and D) and 64 values
//   each of lse and delta (1-d maps over (B, Hq, S)) into a 2-stage ring
//   under full/empty mbarriers.  dK and dV accumulate in float32 registers
//   across the whole group and are written once in bf16: no float32
//   scratch, and the reference wrapper's group sum happens in the products.
//   At D 256 dK and dV together would need 256 accumulator registers a
//   thread, so each block owns one half of D's columns for them and
//   computes S^T and dP^T over the full D: those two products are done
//   twice at D 256 only.  Precision: P^T and dS^T are rounded to bf16
//   before their products (what SDPA's backward does too); S^T and dP^T
//   are exact products of bf16 inputs summed in float32.  dK and dV are
//   off the float32 reference by about 2^-9 of their largest entry plus
//   the final bf16 rounding.
// - dQ, scalar float32 (no tensor cores yet): one block per (batch, query
//   head, query tile) of 256 threads as a 16 x 16 grid, walking the key
//   tiles from 0 to the diagonal; tiles live in shared memory row-major as
//   float32 with one float of padding per row, so the 16 lanes that read
//   16 different rows at one column hit 16 banks; a thread owns BQ/16 rows
//   and BK/16 keys of the (query x key) tiles s, dp and ds and BQ/16 rows
//   and D/16 columns of dq, which accumulates in registers.  Tiles are 64
//   wide up to D 128 and 32 at D 256.  q, k, v, O and dO are read in the
//   model's (B, S, H, D) layout through their strides, 16 bytes at a time;
//   any S is taken, the ragged tail of rows and keys zero-filled and
//   masked.

#include "hopper.cuh"


namespace {

using namespace hopper;

// ------------------------------------------------------------- dK/dV

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;            // keys a block, queries a ring tile
constexpr int kStages = 2;           // q/dO ring depth
constexpr int kDkvThreads = 128 + 32;   // a consumer warpgroup, a producer warp

template <int DMAX>
struct Dkv {
  static constexpr int NA = DMAX / 64;                 // 64-column atoms
  static constexpr int NSPLIT = DMAX == 256 ? 2 : 1;   // column halves
  static constexpr int NO = NA / NSPLIT;               // atoms a block owns
  static constexpr int kTileBytes = NA * kTile * 128;  // one 64-row tile
  // stage: q, dO, then 64 floats of lse and of delta
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kRingOff = 2 * kTileBytes;      // after K and V
  static constexpr int kBarOff = kRingOff + kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 64 + 1024;   // + alignment slack
};

template <int DMAX>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tl,
                     const __grid_constant__ CUtensorMap td,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int Hq, int Hkv,
                     int group, int D, float scale, int causal) {
  using L = Dkv<DMAX>;
  constexpr int NA = L::NA, NO = L::NO;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + L::kTileBytes;
  uint8_t* ring = smem + L::kRingOff;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int split = blockIdx.x % L::NSPLIT;
  const int k0 = (blockIdx.x / L::NSPLIT) * kTile;   // first tiles: most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  // the query tile holding the diagonal starts at k0; those before it lie
  // wholly above the diagonal
  const int q_first = causal ? k0 : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {   // the producer warp: one thread issues TMA
    if (tid == 128) {
      mbar_expect_tx(kvbar, 2 * L::kTileBytes);
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(sK + a * kTile * 128, &tk, kvbar, 64 * a, hk, k0, b);
        tma_load_4d(sV + a * kTile * 128, &tv, kvbar, 64 * a, hk, k0, b);
      }
      int j = 0;
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        for (int q0 = q_first; q0 < S; q0 += kTile, ++j) {
          const int s = j % kStages;
          if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::kTileBytes + 2 * kTile * 4);
          uint8_t* st = ring + s * L::kStageBytes;
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(st + a * kTile * 128, &tq, &full[s], 64 * a, h, q0,
                        b);
            tma_load_4d(st + L::kTileBytes + a * kTile * 128, &tdo, &full[s],
                        64 * a, h, q0, b);
          }
          const int row = ((int)b * Hq + h) * S + q0;
          tma_load_1d(st + 2 * L::kTileBytes, &tl, &full[s], row);
          tma_load_1d(st + 2 * L::kTileBytes + 256, &td, &full[s], row);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's keys are krow and krow + 8
  // (accumulator registers i with (i / 2) % 2 == 0, 1), its queries
  // 8 (i / 4) + 2 (lane % 4) + i % 2 of each tile
  const int warp = tid >> 5, lane = tid & 31;
  const int krow = k0 + 16 * warp + (lane >> 2);
  const uint32_t ka = smem_addr(sK), va = smem_addr(sV);
  const float sl2 = scale * kLog2e;

  float adk[NO][32], adv[NO][32];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[n][i] = adv[n][i] = 0.0f;

  mbar_wait(kvbar, 0);
  int j = 0;
  for (int g = 0; g < group; ++g) {
    for (int q0 = q_first; q0 < S; q0 += kTile, ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      uint8_t* st = ring + s * L::kStageBytes;
      const uint32_t qa = smem_addr(st), oa = qa + L::kTileBytes;
      const float* sl = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
      const float* sd = sl + 64;

      // S^T = K.Q^T and dP^T = V.dO^T
      float pt[32], gt[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        mma_ss(pt, desc_k(ka, kTile, kk), desc_k(qa, kTile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        mma_ss(gt, desc_k(va, kTile, kk), desc_k(oa, kTile, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(pt);
      pin(gt);

      // P^T and dS^T in float32; the mask on the diagonal tile and past S
      const bool edge = (causal && q0 < k0 + kTile - 1) || q0 + kTile > S ||
                        k0 + kTile > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        float p = exp2_approx(pt[i] * sl2 - sl[c] * kLog2e);
        if (edge) {
          const int qpos = q0 + c, kpos = krow + 8 * ((i >> 1) & 1);
          if (qpos >= S || kpos >= S || (causal && kpos > qpos)) p = 0.0f;
        }
        gt[i] = p * (gt[i] - sd[c]) * scale;
        pt[i] = p;
      }

      // dV += P^T.dO and dK += dS^T.q, A from registers in bf16, B MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        frag(pt, kk, a);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_rs_t(adv[n], a, desc_mn(oa, kTile, kk, split * NO + n));
        frag(gt, kk, a);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_rs_t(adk[n], a, desc_mn(qa, kTile, kk, split * NO + n));
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        pin(adk[n]);
        pin(adv[n]);
      }
      mbar_arrive(&empty[s]);
    }
  }

  // dk and dv: (B, S, Hkv, D), contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + 8 * r;
    if (key >= S) continue;
    const int64_t off = (((int64_t)b * S + key) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * (split * NO + n) + 8 * c + 2 * (lane & 3);
        if (col < D) {
          const int i = 4 * c + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(adk[n][i], adk[n][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(adv[n][i], adv[n][i + 1]);
        }
      }
  }
}

// --------------------------------------------------------------- dQ

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

// ds of the tile at (q0, k0) for rows ty * RQ + i and keys tx + 16 * j:
// s = q.k and dp = dO.v from shared memory, then p = exp(s * scale - lse) on
// the valid entries (0 elsewhere, what exp(NEG_INF - lse) gives) and
// ds = p * (dp - delta) * scale, stored at [row][key] of sG.
template <int DMAX>
__device__ __forceinline__ void probs(const float* sQ, const float* sO,
                                      const float* sK, const float* sV,
                                      const float* sL, const float* sD,
                                      float* sG, int q0, int k0,
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
      sG[r * T::PS + c] = p * (dp[i][j] - delta) * scale;
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
    probs<DMAX>(sQ, sO, sK, sV, sL, sD, sG, q0, k0, S, D, scale, causal);
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
  using L = Dkv<DMAX>;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  const int64_t rows = (int64_t)B * Hq * S;
  cudaError_t err = bshd_map(&tq, q, B, S, Hq, D, qs, kTile);
  if (err == cudaSuccess) err = bshd_map(&tk, k, B, S, Hkv, D, ks, kTile);
  if (err == cudaSuccess) err = bshd_map(&tv, v, B, S, Hkv, D, vs, kTile);
  if (err == cudaSuccess) err = bshd_map(&tdo, dout, B, S, Hq, D, os, kTile);
  if (err == cudaSuccess) err = flat_map(&tl, lse, rows, kTile);
  if (err == cudaSuccess) err = flat_map(&td, delta, rows, kTile);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_kernel<DMAX>, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile * L::NSPLIT, Hkv, B);
  flash_bwd_dkv_kernel<DMAX><<<grid, kDkvThreads, L::kBytes, stream>>>(
      tq, tk, tv, tdo, tl, td, dk, dv, S, Hq, Hkv, Hq / Hkv, D, scale,
      causal);
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

// q, k, v, dout and lse as above (the strides multiples of 8 and the base
// addresses 16-byte aligned, as TMA needs); delta: (B, Hq, S) float32 from
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
