// Flash-attention forward on Hopper: causal or full GQA attention with the
// per-row logsumexp, for LM prefill and training.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_fwd
// (body `_fwd_kernel`): scores q.k in float32 scaled by 1/sqrt(D), the causal
// mask qpos >= kpos with masked scores set to NEG_INF = -1e30 (not -inf), an
// online max and sum over key tiles, out = acc / max(l, 1e-30) cast to bf16
// and lse = m + log(max(l, 1e-30)) in float32.  The backward kernels of that
// file are in flash_attention_bwd.cu.
//
// What bounds it on this card: operations.  A causal (B, Hq, S, D) forward
// does 2*B*Hq*S^2*D flops over 2*B*S*(Hq + Hkv)*D*2 bytes of q, k, v and o;
// at qwen2-0.5b's prefill (B 8, S 2048, Hq 14, Hkv 2, D 64) that is 60 GFLOP
// against 17 MB, far above the ~295 flops per byte where HBM stops being the
// limit.  The bound is the bf16 tensor-core rate, 989 TFLOP/s.
//
// What the design does about it: both products run on the tensor cores
// with wgmma (hopper.cuh), fed by TMA.  One block per (128 query rows,
// query head, batch), issued heaviest tile first, has two consumer
// warpgroups of 64 rows each (wgmma's M) and one producer warp (a
// producer warpgroup at D 256, which hands its registers over).  The
// producer loads the q tile once and then K and V tiles of 64 keys x D
// into a 2-stage ring, each stage guarded by a "full" mbarrier (TMA's
// transaction count) and an "empty" one (the 256 consumer threads' arrivals).
// The loads read the model's strided (B, S, H, D) views through 4-d tensor
// maps (dims D, H, S, B; query head h reads kv head h / group), with
// 128-byte swizzle, and zero-fill past S and past D.  Per key tile a
// warpgroup computes S = Q.K^T with D/16 wgmma.m64n64k16 (both operands
// K-major in shared memory, float32 accumulator), masks on the diagonal
// tile and past S only, and runs the online softmax in registers (row max
// and sum over the 4 lanes of a quad, exp2 with log2(e) folded into the
// scale).  P is rounded to bf16 in registers, where the accumulator's
// layout is already the A-from-registers layout, and O += P.V runs as
// wgmma with A from registers and B = V from shared memory, MN-major (the
// transpose bit), D/64 instructions per 16 keys.  The sum l is taken from
// the float32 P, so only the numerator sees P's rounding: out is off the
// float32 reference by about 2^-9 of its scale.  Key tiles wholly above a
// warpgroup's rows are skipped (its arrival still releases the stage),
// which is exact: every row meets a valid key in the first tile.  D 64, 128
// and 256 are template instances (1, 2 and 4 swizzle atoms of 64 columns);
// a D between them reads zeros past D.  The epilogue writes out / max(l,
// 1e-30) in bf16 and lse in float32.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;           // query rows per block, 64 a warpgroup
constexpr int kBK = 64;            // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kConsumers = 256;    // two warpgroups

template <int DMAX>
struct Smem {
  static constexpr int NA = DMAX / 64;            // 64-column atoms
  static constexpr int kQBytes = NA * kBQ * 128;
  static constexpr int kTileBytes = NA * kBK * 128;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 64 + 1024;  // + alignment slack
  // Registers are allocated to warps in groups of four, so a producer warp
  // costs a warpgroup's registers and the block gets at most 168 a thread.
  // That spills at D 256, where the O accumulator alone is 128 registers:
  // there the producer is a whole warpgroup that gives its registers to
  // the consumers (setmaxnreg: 24 for it, 240 for them).
  static constexpr bool kRebalance = DMAX == 256;
  static constexpr int kThreads = kConsumers + (kRebalance ? 128 : 32);
};

template <int DMAX>
__global__ void __launch_bounds__(Smem<DMAX>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int Hq, int group, int D, float scale, int causal) {
  using L = Smem<DMAX>;
  constexpr int NA = L::NA;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::kQBytes;   // stage s: K, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q_end = min(S, q0 + kBQ);
  const int n_tiles = ((causal ? q_end : S) + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer: one thread issues TMA
    if constexpr (L::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int a = 0; a < NA; ++a)
        tma_load_4d(sQ + a * kBQ * 128, &tq, qbar, 64 * a, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        uint8_t* sK = sKV + s * L::kStageBytes;
        uint8_t* sV = sK + L::kTileBytes;
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(sK + a * kBK * 128, &tk, &full[s], 64 * a, hk, j * kBK,
                      b);
          tma_load_4d(sV + a * kBK * 128, &tv, &full[s], 64 * a, hk, j * kBK,
                      b);
        }
      }
    }
    return;
  }

  if constexpr (L::kRebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows
  // row0 and row0 + 8 (accumulator registers i with (i / 2) % 2 == 0, 1)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int first = q0 + 64 * wg;
  const int row0 = first + 16 * warp + (lane >> 2);
  const uint32_t qa = smem_addr(sQ) + wg * 64 * 128;

  float o[NA][32];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = j * kBK;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (!causal || k0 <= first + 63) {
      const uint32_t ka = smem_addr(sKV + s * L::kStageBytes);
      const uint32_t va = ka + L::kTileBytes;
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        mma_ss(sc, desc_k(qa, kBQ, kk), desc_k(ka, kBK, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(sc);

      // mask (diagonal tile and past S only), online max and sum
      const bool edge = (causal && k0 + kBK - 1 > first) || k0 + kBK > S;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * scale;
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (key >= S || (causal && key > row0 + 8 * r)) x = kNegInf;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2_approx((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= corr[r];   // this thread's share; summed over the quad last
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2_approx((sc[i] - m[r]) * kLog2e);
        l[r] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i >> 1) & 1];

      // O += P.V: P in bf16 from registers, V MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        frag(sc, kk, a);
#pragma unroll
        for (int n = 0; n < NA; ++n)
          mma_rs_t(o[n], a, desc_mn(va, kBK, kk, n));
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NA; ++n) pin(o[n]);
    }
    mbar_arrive(&empty[s]);
  }

  // out (B, S, Hq, D) and lse (B, Hq, S), both contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f), inv = 1.0f / lc;
    __nv_bfloat16* orow = out + (((int64_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[n][4 * c + 2 * r] * inv,
                                    o[n][4 * c + 2 * r + 1] * inv);
      }
    if ((lane & 3) == 0) lse[((int64_t)b * Hq + h) * S + row] = m[r] + logf(lc);
  }
}

template <int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   __nv_bfloat16* out, float* lse, int B, int S, int Hq,
                   int Hkv, int D, const int64_t* qs, const int64_t* ks,
                   const int64_t* vs, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bshd_map(&tq, q, B, S, Hq, D, qs, kBQ);
  if (err == cudaSuccess) err = bshd_map(&tk, k, B, S, Hkv, D, ks, kBK);
  if (err == cudaSuccess) err = bshd_map(&tv, v, B, S, Hkv, D, vs, kBK);
  if (err != cudaSuccess) return err;
  const int smem = Smem<DMAX>::kBytes;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<DMAX><<<grid, Smem<DMAX>::kThreads, smem, stream>>>(
      tq, tk, tv, out, lse, S, Hq, Hq / Hkv, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, Hq, D), k and v: (B, S, Hkv, D) bf16 with element strides
// {batch, seq, head} in q_strides / k_strides / v_strides (last dim
// contiguous, strides multiples of 8 and base addresses 16-byte aligned, as
// TMA needs); out: (B, S, Hq, D) bf16 and lse: (B, Hq, S) float32, both
// contiguous.  D is a multiple of 16 up to 256 and Hq a multiple of Hkv.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int Hq, int Hkv, int D, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, float scale,
    int causal, void* stream) {
  if (B == 0 || S == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch<64>(q, k, v, o, ls, B, S, Hq, Hkv, D,
                                       q_strides, k_strides, v_strides,
                                       scale, causal, s));
  if (D <= 128)
    return static_cast<int>(launch<128>(q, k, v, o, ls, B, S, Hq, Hkv, D,
                                        q_strides, k_strides, v_strides,
                                        scale, causal, s));
  return static_cast<int>(launch<256>(q, k, v, o, ls, B, S, Hq, Hkv, D,
                                      q_strides, k_strides, v_strides, scale,
                                      causal, s));
}
