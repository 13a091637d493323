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
// the limit (qwen2-0.5b at batch 8 and a 2,112-token cache reads 8.6 MB of
// K and V a layer: ~2.6 us at 3.35 TB/s).
//
// What the design does about it: one launch that keeps the card's memory
// system busy and does little else.
// - Grid.  The host clips the key range to the valid keys [lo, hi), which
//   is exact (with at least one valid key every masked score adds
//   exp(-1e30 - m) = 0 to the reference's sums), and cuts it into slices
//   of whole 64-key tiles so that batch x kv heads x slices gives the card
//   a few blocks per SM (batch 8 x 2 kv heads alone would be 16 blocks on
//   132 SMs).  Block (slice, kv head, batch) reads its keys once and
//   serves all `group` query heads from them.
// - Loads.  cp.async, 16 bytes a thread, into a 2-stage ring of 64-key K
//   and V tiles: the first two tiles (all of a slice at qwen2's shape,
//   where a slice is one tile) are requested before any is waited for.
//   cp.async rather than TMA: it needs no tensor map, whose encoding on the
//   host would add to a launch that the host already paces, and its
//   per-row zero fill takes any cache length and stride.  Rows are padded
//   by 16 bytes so that ldmatrix's 8-row reads hit 8 distinct bank groups.
// - Products on the tensor cores, mma.sync.m16n8k16 (bf16 in, float32
//   accumulate): the group's query heads are the 16 M rows (zero rows past
//   the group; a group above 16 takes further M tiles, one pass over the
//   slice each).  Each of the 4 warps owns 16 keys of a tile: S = Q.K^T
//   (ldmatrix of q and K), the mask past the slice, the online max and sum
//   in registers (over the 4 lanes of a quad), P rounded to bf16 straight
//   from the score registers (the C layout of two n8 tiles is the A layout
//   of one k16 slice) for acc += P.V (ldmatrix.trans of V); l is summed
//   from the float32 P, as in the flash forward.
// - Combine in the same launch.  The 4 warps' (m, l, acc) merge through
//   shared memory into the block's partial, written to a float32
//   workspace; after a barrier one thread adds 1 to the (batch, kv
//   head)'s ticket with an acquire-release atomic (what a fence on every
//   thread would do, at one thread's cost).  The block that takes the last
//   ticket reads every slice's partial (through L2, up to 12 slices' loads
//   in flight a thread), writes out =
//   sum_i acc_i 2^(m_i - m) / max(sum_i l_i 2^(m_i - m), 1e-30) in bf16
//   (m in log2 units) and resets the ticket to 0 for the next launch.  The
//   wrapper keeps the workspace and the tickets per stream, so launches
//   that could share them are ordered.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTK = 64;        // keys per tile, 16 a warp
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 128;  // 4 warps
// slices whose partials the last block loads at once (a round trip to L2
// each batch); registers bound it, see min_blocks
constexpr int kBatch = 12;

// blocks an SM must hold: qwen2's decode grid (33 slices x 2 kv heads x
// batch 8) is 4 blocks per SM of 132, all in one wave only if the
// registers allow 4 (128 a thread); at D 128 shared memory allows 3, at
// D 256 one
constexpr int min_blocks(int dmax) {
  return dmax == 64 ? 4 : dmax == 128 ? 3 : 1;
}

typedef __nv_bfloat16 bf16;

// Shared memory, in bytes, of the instance for head dims up to DMAX: the
// ring, q's M tiles and the last-block flag.  The warps' partials are
// merged in the ring once it is drained.
__host__ __device__ constexpr int row_stride(int dmax) { return dmax + 8; }
__host__ __device__ constexpr int64_t ring_bytes(int dmax) {
  return (int64_t)kStages * 2 * kTK * row_stride(dmax) * 2;
}
int64_t smem_bytes(int dmax, int group) {
  const int mt = (group + 15) / 16;
  return ring_bytes(dmax) + (int64_t)mt * 16 * row_stride(dmax) * 2 + 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A.B, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// atomicAdd(p, 1) with acquire-release semantics at device scope
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Block (split, kv head, batch) over keys [lo + split * split_len,
// min(hi, lo + (split + 1) * split_len)).  q: (B, Hq, D) contiguous; k, v
// strided; work: the partials' acc (B, Hq, nsplit, D) then their (m, l)
// (B, Hq, nsplit, 2), float32; tickets: (B, Hkv) int32, zero between
// launches.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, min_blocks(DMAX))
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ work, int* __restrict__ tickets, int Hq,
              int group, int D, int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh, int lo, int hi,
              int split_len, float scale) {
  constexpr int RS = row_stride(DMAX);    // shared row stride, bf16
  constexpr int CH = DMAX / 8;            // 16-byte chunks a row
  constexpr int kTileElems = kTK * RS;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: K, then V
  const int MT = (group + 15) / 16;
  bf16* sQ = ring + kStages * 2 * kTileElems;   // [MT * 16][RS]
  int* sLast = reinterpret_cast<int*>(sQ + MT * 16 * RS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, Hkv = gridDim.y;
  const int h0 = hk * group;
  const int s_begin = lo + split * split_len;
  const int s_end = min(hi, s_begin + split_len);
  const int ntk = (s_end - s_begin + kTK - 1) / kTK;
  const int64_t rows = (int64_t)gridDim.z * Hq * nsplit;   // partials
  float* ws_acc = work;
  float2* ws_ml = reinterpret_cast<float2*>(work + rows * D);
  const float sl2 = scale * kLog2e;

  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  // tile t of the slice into ring stage st; keys past the slice and
  // columns past D read as zeros
  auto load = [&](int t, int st) {
    bf16* sK = ring + st * 2 * kTileElems;
    bf16* sV = sK + kTileElems;
    const int t0 = s_begin + t * kTK;
    for (int c = tid; c < kTK * CH; c += kThreads) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const bool ok = t0 + r < s_end && d0 < D;
      const int64_t key = ok ? t0 + r : 0;
      cp_async16(sK + r * RS + d0, kb + key * k_ss + (ok ? d0 : 0), ok);
      cp_async16(sV + r * RS + d0, vb + key * v_ss + (ok ? d0 : 0), ok);
    }
  };
  // the group's q rows, zero past the group and past D, ride with tile 0
  for (int c = tid; c < MT * 16 * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool ok = r < group && d0 < D;
    cp_async16(sQ + r * RS + d0,
               q + ((int64_t)b * Hq + h0 + (ok ? r : 0)) * D + (ok ? d0 : 0),
               ok);
  }

  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  for (int mt = 0; mt < MT; ++mt) {
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float acc[DMAX / 8][4];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    load(0, 0);
    cp_async_commit();
    for (int t = 0; t < ntk; ++t) {
      if (t + 1 < ntk) load(t + 1, (t + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();   // tile t (and q) have landed
      __syncthreads();
      const bf16* sK = ring + (t % kStages) * 2 * kTileElems;
      const bf16* sV = sK + kTileElems;
      const int key0 = s_begin + t * kTK + 16 * warp;   // this warp's keys

      // S = Q.K^T over this warp's 16 keys: two n8 tiles
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, sQ + (mt * 16 + (lane & 15)) * RS + 16 * kk +
                           8 * (lane >> 4));
        ldmatrix_x4(bk, sK + (16 * warp + (lane & 7) + 8 * (lane >> 4)) * RS +
                            16 * kk + 8 * ((lane >> 3) & 1));
        mma(sc[0], a, bk[0], bk[1]);
        mma(sc[1], a, bk[2], bk[3]);
      }

      // mask past the slice, online max and sum (rows g and g + 8)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * n + 2 * t4 + (e & 1);
          const float x = key < s_end ? sc[n][e] * sl2 : kNegInf;
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];   // this thread's share; summed over the quad last
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * n + 2 * t4 + (e & 1);
          const float p = key < s_end ? exp2f(sc[n][e] - m[e >> 1]) : 0.0f;
          l[e >> 1] += p;
          sc[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

      // acc += P.V: P in bf16 from the score registers, V by ldmatrix.trans
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_t(bv, sV + (16 * warp + (lane & 15)) * RS + 16 * np +
                              8 * (lane >> 4));
        mma(acc[2 * np], pa, bv[0], bv[1]);
        mma(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
      __syncthreads();   // the stage is refilled next iteration
    }
    cp_async_wait<0>();

    // the 4 warps' (m, l, acc) through the drained ring: [warp][16][DMAX]
    // and [warp][16] (m, l)
    float* wacc = reinterpret_cast<float*>(ring);
    float2* wml = reinterpret_cast<float2*>(wacc + 4 * 16 * DMAX);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = 16 * warp + g + 8 * r;
      if (t4 == 0) wml[row] = make_float2(m[r], l[r]);
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n)
        *reinterpret_cast<float2*>(wacc + row * DMAX + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
    __syncthreads();

    // the block's partial of rows mt * 16 .. of the group
    const int nrows = min(16, group - mt * 16);
    for (int i = tid; i < nrows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      float mw[4], M = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        mw[w] = wml[16 * w + r].x;
        M = fmaxf(M, mw[w]);
      }
      float L = 0.0f;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float s = exp2f(mw[w] - M);
        L += wml[16 * w + r].y * s;
        const float4 x = reinterpret_cast<const float4*>(
            wacc + (16 * w + r) * DMAX)[c4];
        a.x += x.x * s;
        a.y += x.y * s;
        a.z += x.z * s;
        a.w += x.w * s;
      }
      const int64_t idx =
          ((int64_t)b * Hq + h0 + mt * 16 + r) * nsplit + split;
      reinterpret_cast<float4*>(ws_acc + idx * D)[c4] = a;
      if (c4 == 0) ws_ml[idx] = make_float2(M, L);
    }
    __syncthreads();   // the ring is refilled by the next M tile
  }

  // the last block of this (batch, kv head) to finish combines the slices:
  // the barrier orders the block's partial before thread 0's acq_rel
  // ticket, which releases it and, in the last block, acquires every other
  // block's (the barrier after it passes that on to the block's threads)
  int* ticket = tickets + (int64_t)b * Hkv + hk;
  if (tid == 0) *sLast = ticket_add(ticket) == nsplit - 1;
  __syncthreads();
  if (!*sLast) return;

  // one pass per (row, 4 columns): the slices' (m, l, acc) merged online,
  // in even batches of at most kBatch slices whose loads are all in flight
  // at once
  const int nb = (nsplit + kBatch - 1) / kBatch;
  const int per = (nsplit + nb - 1) / nb;
  for (int i = tid; i < group * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    const int64_t row = (int64_t)b * Hq + h0 + r;
    const float2* ml = ws_ml + row * nsplit;
    const float4* pa =
        reinterpret_cast<const float4*>(ws_acc + row * nsplit * D) + c4;
    float M = kNegInf, L = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < nsplit; s0 += per) {
      const int cnt = min(per, nsplit - s0);
      float2 y[kBatch];
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (j < cnt) {
          y[j] = __ldcg(ml + s0 + j);
          x[j] = __ldcg(pa + (int64_t)(s0 + j) * (D / 4));
        }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (j < cnt) {
          const float mn = fmaxf(M, y[j].x);
          const float c = exp2f(M - mn), w = exp2f(y[j].x - mn);
          L = L * c + y[j].y * w;
          a.x = a.x * c + x[j].x * w;
          a.y = a.y * c + x[j].y * w;
          a.z = a.z * c + x[j].z * w;
          a.w = a.w * c + x[j].w * w;
          M = mn;
        }
    }
    const float inv = 1.0f / fmaxf(L, 1e-30f);
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out + row * D + 4 * c4);
    o[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
  if (tid == 0) *ticket = 0;
}

int dmax_of(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* work, void* tickets, int B, int Hq, int Hkv, int D,
                   const int64_t* ks, const int64_t* vs, int lo, int hi,
                   int split_len, int nsplit, float scale,
                   cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int64_t smem = smem_bytes(DMAX, group);
  static int64_t configured = 48 * 1024;   // the largest size allowed yet
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  decode_kernel<DMAX><<<dim3(nsplit, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(work), static_cast<int*>(tickets), Hq, group, D,
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], lo, hi, split_len, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a group and head dim, in bytes.
extern "C" int64_t decode_attention_smem_bytes(int group, int D) {
  return smem_bytes(dmax_of(D), group);
}

// q: (B, Hq, D) bf16 contiguous, 16-byte aligned; k, v: (B, S, Hkv, D)
// bf16 with element strides {batch, seq, head} in k_strides / v_strides
// (last dim contiguous, rows 16-byte aligned); out: (B, Hq, D) bf16;
// work: B * Hq * nsplit * (D + 2) float32 scratch; tickets: B * Hkv int32,
// all zero (the launch leaves them zero).  Keys [lo, hi) are the valid ones
// (hi > lo), cut into nsplit slices of split_len, a multiple of 64.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* work,
    void* tickets, int B, int Hq, int Hkv, int D, const int64_t* k_strides,
    const int64_t* v_strides, int lo, int hi, int split_len, int nsplit,
    float scale, void* stream) {
  if (B == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv < 1 || Hq % Hkv != 0 ||
      hi <= lo || split_len < 1 || split_len % kTK != 0 || nsplit < 1 ||
      static_cast<int64_t>(split_len) * nsplit < hi - lo ||
      static_cast<int64_t>(split_len) * (nsplit - 1) >= hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch<64>(q, k, v, out, work, tickets, B, Hq,
                                       Hkv, D, k_strides, v_strides, lo, hi,
                                       split_len, nsplit, scale, s));
  if (D <= 128)
    return static_cast<int>(launch<128>(q, k, v, out, work, tickets, B, Hq,
                                        Hkv, D, k_strides, v_strides, lo, hi,
                                        split_len, nsplit, scale, s));
  return static_cast<int>(launch<256>(q, k, v, out, work, tickets, B, Hq,
                                      Hkv, D, k_strides, v_strides, lo, hi,
                                      split_len, nsplit, scale, s));
}
