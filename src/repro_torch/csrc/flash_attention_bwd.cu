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
// - dQ, on the tensor cores: one block per (128 query rows, query head,
//   batch; 64 rows at D 256), issued heaviest tile first, with two consumer
//   warpgroups of 64 rows (one at D 256) and a producer warp (a producer
//   warpgroup at D 128, which gives its registers to the consumers with
//   setmaxnreg).  It is the forward's layout with K in V's place:
//     1. S = Q.K^T and 2. dP = dO.V^T: wgmma.m64n64k16 with A (the q and
//        dO tiles) and B (K, V) K-major in shared memory;
//     3. P = exp2(S * scale * log2e - lse * log2e), 0 on the diagonal
//        tile's masked entries and on keys >= S; dS = P * (dP - delta) *
//        scale in float32;
//     4. dQ += dS.K: A = dS rounded to bf16 in registers, B = K MN-major
//        in shared memory (the transpose bit), D/64 instructions per 16
//        keys.
//   The producer loads the q and dO tiles once and streams 64-key K and V
//   tiles through a 2-stage ring under full/empty mbarriers (the same
//   4-d tensor maps, zero fill past S and D); a warpgroup skips the key
//   tiles wholly above its rows and still releases their stage.  While
//   the tiles load, each thread reads its two rows' lse and computes their
//   delta = rowsum(dO * O) in float32 from global memory (each lane of a
//   quad sums every fourth 8-column chunk, 16-byte loads through the
//   strides, then two shuffles); the quad's first lane writes it for the
//   dK/dV kernel.  dQ accumulates in float32 registers and is written once
//   in bf16.  At D 256 dQ alone is 128 accumulator registers beside S and
//   dP, and 128-row q and dO tiles would not fit beside the ring, so the
//   block is one warpgroup of 64 rows (255 registers a thread), not the
//   dK/dV kernel's split of D's columns, which would recompute S and dP.
//   Precision: dS is rounded to bf16 before dS.K (as in SDPA's backward
//   and the dK/dV kernel); S and dP are exact products of bf16 inputs
//   summed in float32, and delta is exact in float32 up to the order of
//   its sum.  dq is off the float32 reference by about 2^-9 of its largest
//   entry plus the final bf16 rounding.

#include "hopper.cuh"


namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
// rows of a tile: dK/dV's keys a block and queries a ring tile, dQ's keys
// a ring tile
constexpr int kTile = 64;
constexpr int kStages = 2;  // ring depth (q/dO tiles for dK/dV, K/V for dQ)

// ------------------------------------------------------------- dK/dV

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

template <int DMAX>
struct Dq {
  static constexpr int NA = DMAX / 64;                 // 64-column atoms
  // consumer warpgroups of 64 query rows: two, but one at D 256, where
  // 128-row q and dO tiles (128 KB) and the K/V ring (128 KB) would not fit
  // in a block's 227 KB
  static constexpr int WG = DMAX == 256 ? 1 : 2;
  static constexpr int BQ = 64 * WG;                   // query rows a block
  static constexpr int kQBytes = NA * BQ * 128;        // the q or dO tile
  static constexpr int kTileBytes = NA * kTile * 128;  // a K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;   // stage: K, then V
  static constexpr int kRingOff = 2 * kQBytes;         // after q and dO
  static constexpr int kBarOff = kRingOff + kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 64 + 1024;   // + alignment slack
  // a 288-thread block costs 384 threads' registers (168 a thread at most);
  // at D 128 the dq, S and dP accumulators (64 + 32 + 32 registers) need
  // more, so the producer is a warpgroup that gives its registers to the
  // consumers (setmaxnreg: 24 for it, 240 for them).  At D 256 the single
  // consumer warpgroup and a producer warp (160 threads) get 255 each.
  static constexpr bool kRebalance = DMAX == 128;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + (kRebalance ? 128 : 32);
};

template <int DMAX>
__global__ void __launch_bounds__(Dq<DMAX>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __nv_bfloat16* __restrict__ out,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int S, int Hq, int group,
                    int D, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                    int causal) {
  using L = Dq<DMAX>;
  constexpr int NA = L::NA;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sO = smem + L::kQBytes;   // dO
  uint8_t* ring = smem + L::kRingOff;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q_end = min(S, q0 + L::BQ);
  const int n_tiles = ((causal ? q_end : S) + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= L::kConsumers) {   // the producer: one thread issues TMA
    if constexpr (L::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == L::kConsumers) {
      mbar_expect_tx(qbar, 2 * L::kQBytes);
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(sQ + a * L::BQ * 128, &tq, qbar, 64 * a, h, q0, b);
        tma_load_4d(sO + a * L::BQ * 128, &tdo, qbar, 64 * a, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        uint8_t* sK = ring + s * L::kStageBytes;
        uint8_t* sV = sK + L::kTileBytes;
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(sK + a * kTile * 128, &tk, &full[s], 64 * a, hk,
                      j * kTile, b);
          tma_load_4d(sV + a * kTile * 128, &tv, &full[s], 64 * a, hk,
                      j * kTile, b);
        }
      }
    }
    return;
  }

  if constexpr (L::kRebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // consumers: warpgroup wg owns rows first .. first + 63; this thread rows
  // row0 and row0 + 8 (accumulator registers i with (i / 2) % 2 == 0, 1)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int first = q0 + 64 * wg;
  const int row0 = first + 16 * warp + (lane >> 2);
  const uint32_t qa = smem_addr(sQ) + wg * 64 * 128;
  const uint32_t oa = smem_addr(sO) + wg * 64 * 128;
  const float sl2 = scale * kLog2e;

  // while TMA loads the tiles: this thread's rows' lse (in log2 units) and
  // delta = rowsum(dO * O) in float32, each lane of the quad summing every
  // fourth 8-column chunk of the two rows from global memory; the quad's
  // first lane writes delta for the dK/dV kernel (rows < S only)
  const int64_t hrow = ((int64_t)b * Hq + h) * S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.0f;
    lse2[r] = 0.0f;
    if (row < S) {
      lse2[r] = lse[hrow + row] * kLog2e;
      const __nv_bfloat16* xr = out + b * x_sb + row * x_ss + h * x_sh;
      const __nv_bfloat16* gr = dout + b * o_sb + row * o_ss + h * o_sh;
      for (int c = 8 * (lane & 3); c < D; c += 32) {
        const uint4 xu = *reinterpret_cast<const uint4*>(xr + c);
        const uint4 gu = *reinterpret_cast<const uint4*>(gr + c);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xu);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          acc = fmaf(xf.x, gf.x, acc);
          acc = fmaf(xf.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    if ((lane & 3) == 0 && row < S) delta[hrow + row] = acc;
  }

  float adq[NA][32];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[n][i] = 0.0f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = j * kTile;
    mbar_wait(&full[s], (j / kStages) & 1);
    // key tiles wholly above this warpgroup's rows, and a warpgroup whose
    // rows all lie past S, are skipped; the arrival still releases the stage
    if (first < S && (!causal || k0 <= first + 63)) {
      const uint32_t ka = smem_addr(ring + s * L::kStageBytes);
      const uint32_t va = ka + L::kTileBytes;

      // S = Q.K^T and dP = dO.V^T
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        mma_ss(sc, desc_k(qa, L::BQ, kk), desc_k(ka, kTile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        mma_ss(dp, desc_k(oa, L::BQ, kk), desc_k(va, kTile, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(sc);
      pin(dp);

      // P and dS in float32; the mask on the diagonal tile and past S
      const bool edge = (causal && k0 + kTile - 1 > first) || k0 + kTile > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(sc[i] * sl2 - lse2[r]);
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (key >= S || (causal && key > row0 + 8 * r)) p = 0.0f;
        }
        sc[i] = p * (dp[i] - dlt[r]) * scale;
      }

      // dQ += dS.K: dS in bf16 from registers, K MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        frag(sc, kk, a);
#pragma unroll
        for (int n = 0; n < NA; ++n)
          mma_rs_t(adq[n], a, desc_mn(ka, kTile, kk, n));
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NA; ++n) pin(adq[n]);
    }
    mbar_arrive(&empty[s]);
  }

  // dq: (B, S, Hq, D), contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = dq + (((int64_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(adq[n][4 * c + 2 * r],
                                    adq[n][4 * c + 2 * r + 1]);
      }
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
  using L = Dq<DMAX>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bshd_map(&tq, q, B, S, Hq, D, qs, L::BQ);
  if (err == cudaSuccess) err = bshd_map(&tk, k, B, S, Hkv, D, ks, kTile);
  if (err == cudaSuccess) err = bshd_map(&tv, v, B, S, Hkv, D, vs, kTile);
  if (err == cudaSuccess) err = bshd_map(&tdo, dout, B, S, Hq, D, os, L::BQ);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<DMAX>, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BQ - 1) / L::BQ, Hq, B);
  flash_bwd_dq_kernel<DMAX><<<grid, L::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, tdo, out, dout, lse, delta, dq, S, Hq, Hq / Hkv, D, xs[0],
      xs[1], xs[2], os[0], os[1], os[2], scale, causal);
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
// (x_strides are O's, do_strides dO's; last dim contiguous, strides
// multiples of 8 and base addresses 16-byte aligned, as TMA needs); lse:
// (B, Hq, S) float32 from the forward kernel, contiguous.
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
