// Decode attention on Hopper: one new token's GQA attention over a KV cache,
// with a valid length and a sliding window.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (body `_kernel`): key s is valid iff s < valid_len and,
// when window > 0, s >= valid_len - window; scores q.k in float32 scaled by
// 1/sqrt(D), invalid ones NEG_INF = -1e30; an online max and sum over key
// tiles; out = acc / max(l, 1e-30) cast to bf16.
//
// What bounds it on this card: bytes.  Each valid key's K and V rows are
// read once and serve all `group` query heads of their kv head: 2 flops per
// element per query head, a handful of flops per byte, so HBM bandwidth is
// the limit (qwen2-0.5b at batch 8 and a 2,112-token cache reads 4.3 MB of
// K/V per layer: ~1.3 us at 3.35 TB/s).
//
// What the design does about it: the work is split over the sequence so that
// the card has enough blocks to pull the cache at full rate (batch 8 x 2 kv
// heads alone would be 16 blocks on 132 SMs).  Block (split, kv head, batch)
// reads its slice of keys once, in tiles of 64 staged in shared memory as
// float32, and serves all `group` query heads from it (any group, 7 for
// qwen2): one thread per (head, key) score, one warp per head for the
// tile's max and sum, one thread per (head, column) for the P.V update of
// the running accumulators, which stay in shared memory.  It writes its
// partial (m, l, acc); a second kernel combines the splits with the global
// max, out = sum_i acc_i e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30).
// The host clips the key range to the valid keys [lo, hi) before splitting,
// which is exact: with at least one valid key (valid_len >= 1) every
// masked score contributes exp(-1e30 - m) = 0 to the reference's sums, so
// masked keys are never read.  The cache is read in its (B, S, Hkv, D)
// layout through strides, 16 bytes at a time; any cache length is taken
// (no padding to a block multiple).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// Partial softmax of one (batch, kv head) over keys [lo + split * split_len,
// min(hi, lo + (split + 1) * split_len)).  q: (B, Hq, D) contiguous; k, v
// strided; partials m, l: (B, Hq, nsplit), o: (B, Hq, nsplit, D).
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ o_part, int Hq, int group, int D,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                      int64_t v_ss, int64_t v_sh, int lo, int hi,
                      int split_len, float scale) {
  extern __shared__ float smem[];
  const int KS = D + 1;
  float* sQ = smem;                    // [group][D]
  float* sK = sQ + group * D;          // [kTK][D + 1]
  float* sV = sK + kTK * KS;           // [kTK][D]
  float* sS = sV + kTK * D;            // [group][kTK]
  float* sO = sS + group * kTK;        // [group][D]
  float* sM = sO + group * D;          // [group]
  float* sL = sM + group;              // [group]
  float* sC = sL + group;              // [group], this tile's correction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int h0 = hk * group;
  const int s_begin = lo + split * split_len;
  const int s_end = min(hi, s_begin + split_len);
  const int chunks = D / 8;

  for (int c = tid; c < group * chunks; c += kThreads) {
    const int g = c / chunks, d0 = (c % chunks) * 8;
    float f[8];
    load8(q + ((int64_t)b * Hq + h0 + g) * D + d0, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sQ[g * D + d0 + e] = f[e];
  }
  for (int i = tid; i < group * D; i += kThreads) sO[i] = 0.0f;
  for (int g = tid; g < group; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.0f;
  }

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  for (int t0 = s_begin; t0 < s_end; t0 += kTK) {
    const int n = min(kTK, s_end - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int c = tid; c < n * chunks; c += kThreads) {
      const int r = c / chunks, d0 = (c % chunks) * 8;
      float fk[8], fv[8];
      load8(kb + (int64_t)(t0 + r) * k_ss + d0, fk);
      load8(vb + (int64_t)(t0 + r) * v_ss + d0, fv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sK[r * KS + d0 + e] = fk[e];
        sV[r * D + d0 + e] = fv[e];
      }
    }
    __syncthreads();
    for (int i = tid; i < group * n; i += kThreads) {
      const int g = i / n, r = i % n;
      const float* qr = sQ + g * D;
      const float* kr = sK + r * KS;
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      sS[g * kTK + r] = dot * scale;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kThreads / 32) {
      const float a = lane < n ? sS[g * kTK + lane] : kNegInf;
      const float c = lane + 32 < n ? sS[g * kTK + lane + 32] : kNegInf;
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = lane < n ? expf(a - m_new) : 0.0f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.0f;
      if (lane < n) sS[g * kTK + lane] = pa;
      if (lane + 32 < n) sS[g * kTK + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
        sC[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* p = sS + g * kTK;
      float a = sO[i] * sC[g];
      for (int r = 0; r < n; ++r) a += p[r] * sV[r * D + d];
      sO[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const int64_t row = ((int64_t)b * Hq + h0 + g) * nsplit + split;
    o_part[row * D + d] = sO[i];
    if (d == 0) {
      m_part[row] = sM[g];
      l_part[row] = sL[g];
    }
  }
}

// out[b, h] = sum_i o_i e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30).
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ o_part,
                      __nv_bfloat16* __restrict__ out, int nsplit, int D) {
  const int64_t row = blockIdx.x;   // b * Hq + h
  const float* mp = m_part + row * nsplit;
  const float* lp = l_part + row * nsplit;
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, mp[i]);
  float l = 0.0f;
  for (int i = 0; i < nsplit; ++i) l += lp[i] * expf(mp[i] - m);
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int i = 0; i < nsplit; ++i)
      a += o_part[(row * nsplit + i) * D + d] * expf(mp[i] - m);
    out[row * D + d] = __float2bfloat16(a * inv_l);
  }
}

}  // namespace

// Shared memory the partial kernel needs for a group and head dim, in bytes.
extern "C" int64_t decode_attention_smem_bytes(int group, int D) {
  return static_cast<int64_t>(sizeof(float)) *
         (2 * group * D + kTK * (D + 1) + kTK * D + group * kTK + 3 * group);
}

// q: (B, Hq, D) bf16 contiguous; k, v: (B, S, Hkv, D) bf16 with element
// strides {batch, seq, head} (last dim contiguous, rows 16-byte aligned);
// out: (B, Hq, D) bf16; m_part, l_part: (B, Hq, nsplit) and o_part: (B, Hq,
// nsplit, D) float32 scratch.  Keys [lo, hi) are the valid ones (hi > lo),
// cut into nsplit slices of split_len.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* m_part,
    void* l_part, void* o_part, int B, int Hq, int Hkv, int D,
    const int64_t* k_strides, const int64_t* v_strides, int lo, int hi,
    int split_len, int nsplit, float scale, void* stream) {
  if (B == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv < 1 || Hq % Hkv != 0 ||
      hi <= lo || split_len < 1 || nsplit < 1 ||
      static_cast<int64_t>(split_len) * nsplit < hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = Hq / Hkv;
  const int64_t smem = decode_attention_smem_bytes(group, D);
  static int configured = 0;   // the largest size the attribute allows
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = static_cast<int>(smem);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* op = static_cast<float*>(o_part);
  decode_partial_kernel<<<dim3(nsplit, Hkv, B), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mp, lp, op, Hq, group, D,
      k_strides[0], k_strides[1], k_strides[2], v_strides[0], v_strides[1],
      v_strides[2], lo, hi, split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * Hq, kThreads, 0, s>>>(
      mp, lp, op, static_cast<__nv_bfloat16*>(out), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}
