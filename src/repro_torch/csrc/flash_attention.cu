// Flash-attention forward on Hopper: causal or full GQA attention with the
// per-row logsumexp, for LM prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_fwd
// (body `_fwd_kernel`): scores q.k in float32 scaled by 1/sqrt(D), the causal
// mask qpos >= kpos with masked scores set to NEG_INF = -1e30 (not -inf), an
// online max and sum over key tiles, out = acc / max(l, 1e-30) cast to bf16
// and lse = m + log(max(l, 1e-30)) in float32.  The backward kernels of that
// file are not part of this source.
//
// What bounds it on this card: operations.  A causal (B, Hq, S, D) forward
// does 2*B*Hq*S^2*D flops over 2*B*S*(Hq + Hkv)*D*2 bytes of q, k, v and o;
// at qwen2-0.5b's prefill (B 8, S 2048, Hq 14, Hkv 2, D 64) that is 60 GFLOP
// against 17 MB, far above the ~295 flops per byte where HBM stops being the
// limit.  The bound is the bf16 tensor-core rate.
//
// What the design does about it, simply first: this kernel computes in
// scalar float32 (no tensor cores yet; `mma`/`wgmma` is later work), which
// keeps every product and the probabilities P in float32 as the TPU kernel
// does.  One block of 256 threads owns 64 query rows of one (batch, query
// head) and walks the key tiles from key 0; query head h reads kv head
// h / group (any group, 7 for qwen2).  The q tile and each K tile are staged
// in shared memory transposed (d-major), V row-major, all as float32, so the
// 4x4 register tiles of the score product and of P.V read shared memory
// without bank conflicts; the 64 x BK score tile, its max and its sum never
// leave the SM.  Each thread owns 4 query rows: its running max, sum and
// 4 x D/16 accumulators stay in registers, and the row max and sum are
// reduced across the 16 lanes that share those rows with warp shuffles.
// Key tiles wholly above the diagonal are skipped, which is exact: in the
// reference such an entry seen after a valid one adds exp(-1e30 - m) = 0,
// and the causal walk from key 0 meets a valid key in every row's first
// tile, so no fully masked tile is ever seen first.  q/k/v are read in the
// model's (B, S, H, D) layout through their strides (no transposes), 16
// bytes at a time; any S is taken, the ragged tail of keys and rows is
// zero-filled and masked.  Blocks are issued heaviest tile first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 256;    // 16 x 16 threads, 4 rows each
constexpr int kQStride = kBQ + 4;

template <int DMAX>
struct Tiles {
  static constexpr int BK = DMAX >= 256 ? 32 : 64;   // keys per tile
  static constexpr int KStride = BK + 1;
  static constexpr int kSmemFloats =
      DMAX * kQStride + DMAX * KStride + BK * DMAX + BK * kQStride;
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

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int Hq, int group, int D,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, int causal) {
  using T = Tiles<DMAX>;
  constexpr int BK = T::BK;
  constexpr int NS = BK / 16;     // keys per thread in a score tile
  constexpr int NO = DMAX / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                          // [DMAX][kQStride], q^T
  float* sK = sQ + DMAX * kQStride;          // [DMAX][KStride], k^T
  float* sV = sK + DMAX * T::KStride;        // [BK][DMAX]
  float* sP = sV + BK * DMAX;                // [BK][kQStride], P^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int chunks = D / 8;   // 16-byte chunks per row

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  for (int c = tid; c < kBQ * chunks; c += kThreads) {
    const int r = c / chunks, d0 = (c % chunks) * 8;
    float f[8];
    load8(qb + (int64_t)(q0 + r) * q_ss + d0, q0 + r < S, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sQ[(d0 + e) * kQStride + r] = f[e];
  }

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.0f;
  }

  const int q_end = min(S, q0 + kBQ);
  const int k_end = causal ? q_end : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int c = tid; c < BK * chunks; c += kThreads) {
      const int r = c / chunks, d0 = (c % chunks) * 8;
      const bool ok = k0 + r < S;
      float fk[8], fv[8];
      load8(kb + (int64_t)(k0 + r) * k_ss + d0, ok, fk);
      load8(vb + (int64_t)(k0 + r) * v_ss + d0, ok, fv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sK[(d0 + e) * T::KStride + r] = fk[e];
        sV[r * DMAX + d0 + e] = fv[e];
      }
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][NS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &sQ[d * kQStride + ty * 4]);
      float kv[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) kv[j] = sK[d * T::KStride + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[0][j] += qv.x * kv[j];
        s[1][j] += qv.y * kv[j];
        s[2][j] += qv.z * kv[j];
        s[3][j] += qv.w * kv[j];
      }
    }

    // mask, online max and sum; rows are shared by the 16 lanes of a
    // half-warp, so the row reductions are xor shuffles over 8, 4, 2, 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      *reinterpret_cast<float4*>(&sP[(tx + 16 * j) * kQStride + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P . V: rows ty*4 + i, columns tx + 16*j
    const int kn = min(BK, k_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(
          &sP[kk * kQStride + ty * 4]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (tx + 16 * j < D) {
          const float vv = sV[kk * DMAX + tx + 16 * j];
          acc[0][j] += p.x * vv;
          acc[1][j] += p.y * vv;
          acc[2][j] += p.z * vv;
          acc[3][j] += p.w * vv;
        }
      }
    }
  }

  // out (B, S, Hq, D) and lse (B, Hq, S), both contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + (((int64_t)b * S + r) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (tx + 16 * j < D) o[tx + 16 * j] = __float2bfloat16(acc[i][j] / lc);
    if (tx == 0) lse[((int64_t)b * Hq + h) * S + r] = m[i] + logf(lc);
  }
}

template <int DMAX>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                   int B, int S, int Hq, int Hkv, int D, const int64_t* qs,
                   const int64_t* ks, const int64_t* vs, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tiles<DMAX>::kSmemFloats;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, S, Hq, Hq / Hkv, D, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, Hq, D), k and v: (B, S, Hkv, D) bf16 with element strides
// {batch, seq, head} in q_strides / k_strides / v_strides (last dim
// contiguous, rows 16-byte aligned); out: (B, S, Hq, D) bf16 and lse:
// (B, Hq, S) float32, both contiguous.  D is a multiple of 16 up to 256 and
// Hq a multiple of Hkv.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int Hq, int Hkv, int D, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, float scale,
    int causal, void* stream) {
  if (B == 0 || S == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch<64>(qq, kk, vv, o, ls, B, S, Hq, Hkv, D,
                                       q_strides, k_strides, v_strides,
                                       scale, causal, s));
  if (D <= 128)
    return static_cast<int>(launch<128>(qq, kk, vv, o, ls, B, S, Hq, Hkv, D,
                                        q_strides, k_strides, v_strides,
                                        scale, causal, s));
  return static_cast<int>(launch<256>(qq, kk, vv, o, ls, B, S, Hq, Hkv, D,
                                      q_strides, k_strides, v_strides, scale,
                                      causal, s));
}
