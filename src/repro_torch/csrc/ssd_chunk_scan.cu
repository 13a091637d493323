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
// and head j reads group j / (h / g) of B and C.  Inputs and outputs are
// float32, as the TPU kernel's.
//
// What bounds it on this card: operations.  At mamba2-370m's prefill (b 8,
// s 2048, h 32, p 64, n 128, chunk 256) the four products, S = C.B^T (once
// per group) and W.x (per head) over the i >= k half of each chunk, the
// chunks' own states and the carried state's term C.prev^T, are 26.3
// GFLOP a layer against 296 MB of inputs and outputs.  This kernel forms S
// per head (its output blocks are per head), 43.1 GFLOP in all.  One TF32
// product (a 10-bit mantissa) misses the kernel's tolerance of 1e-4 of the
// largest entry, so every product is 3xTF32: each operand v splits into
// hi, v rounded to TF32 (to nearest, ties away, cvt.rna's rounding, in
// two integer operations), and lo = v - hi, whose TF32 part the tensor
// core reads, and a.b is hi.hi + hi.lo + lo.hi summed in float32
// accumulators, as accurate as float32
// (tests/test_torch_ssd_precision.py emulates it).  Three TF32 products for
// each: 79 GFLOP at the dense TF32 rate (495 TFLOP/s) is 0.160 ms a layer
// (the 129 GFLOP this kernel issues, 0.261 ms); the bytes allow 0.088.
//
// What the design does about it: two grids on the caller's stream (there
// were three), so the chunk states cross device memory once.
// 1. States (mma.sync.m16n8k8.tf32): one block of 4 warps per (b, h, state
//    tile: 64 x 128, or 64 x 32 for n <= 64), walking the chunks in series
//    as the TPU grid does and carrying its tile of the state in the warps'
//    accumulators (32 x 64 or 16 x 32 each).  Per chunk it scans dt * A
//    (cs), writes the state before the chunk to the `prev` scratch (b, h,
//    nc - 1, p, n), scales it by exp(cs_last) and adds (x o w)^T.B, w =
//    exp(cs_last - cs) dt, over 64-position tiles that cp.async brings in
//    two stages ahead.  Both operands reduce over positions while x and B
//    are stored feature-contiguous: mma.sync reads its fragments from
//    shared memory in any layout, here the layout of global memory with a
//    row stride of 4 mod 8 floats, and with k permuted within each k8 step
//    (fragment column t is position 2 t, column t + 4 position 2 t + 1) a
//    fragment's loads fall in 32 distinct banks.  Each x o w and B value is
//    split in registers once per warp and serves 8 (or 4) and 2 (or 1)
//    products.  The three products into one accumulator depend on each
//    other, so each term is issued for all of a warp's tiles before the
//    next.
// 2. Output (wgmma m64nNk8 tf32): one warpgroup per (b, h, chunk, 64-row
//    tile), heaviest tiles first.  The tile's C rows are split once into a
//    hi and a lo K-major tile with 128-byte swizzle (the layout a TMA load
//    writes, so hopper::desc_k addresses its 32-byte k8 slices), then per
//    32-key tile up to the diagonal: the keys' B rows (K-major as stored)
//    and their dt x rows, transposed so that K is the keys and permuted as
//    above, likewise split; S = C.B^T (m64n32k8, both operands in shared
//    memory); W = S o exp(cs_i - cs_k), masked, formed in the registers
//    that hold S, which with the permuted k are already the A fragments of
//    y += W.(dt x) (m64n64k8, A from registers).  C.prev^T comes first, 32
//    columns of y a pass, scaled by exp(cs_i).  The next key tile's loads
//    are in flight during a tile's products.  Shared memory is 115,712
//    bytes at mamba2's shape, all of it dynamic: with the 1 KB the card
//    reserves for each block, two blocks an SM, one's loads and scan under
//    the other's products.
// Overflow: cs falls by up to q * dt * |A| within a chunk, so exp(cs_i) *
// exp(-cs_k) overflows in float32; only differences cs_i - cs_k (and
// cs_last - cs_k, and cs_i itself) clamped to <= 0 are exponentiated, and
// a masked entry of W is a 0 selected in place of the product, never 0 *
// inf.  __expf of a difference <= 0 is within ~1e-6 of exp where the
// result is not tiny.  The mask is a select, not a branch: a branch per
// entry serializes the entries' loads and exponentials.
// Any shape the wrapper takes: p and n in [1, 128], chunk up to 256, any g
// dividing h.  p, n and the position tiles are padded to the tiles with
// zeros in shared memory, and only real rows and columns are stored.
// Loads go 16 bytes at a time where p (for x) and n (for B, C and prev) are
// multiples of 4 and the inputs 16-byte aligned, 4 bytes otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;       // positions per tile (rows of the output)
constexpr int kMaxChunk = 256;  // a chunk's scan is 2 positions a thread
constexpr int kMaxDim = 128;    // p and n

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
// the row stride of a raw shared tile of `cols` floats: a multiple of 4 (16
// bytes, for cp.async) that is 4 mod 8, so that the permuted fragment
// load's 4 row pairs x 8 columns fall in 32 distinct banks
__host__ __device__ constexpr int lead(int cols) { return round8(cols) + 4; }

// 16 or 4 bytes from global to shared memory, or zeros when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x width floats into dst[r * ld + col] (width a multiple of 4): row
// r < nrows from src + r * stride, columns < ncols; zeros elsewhere.  vec:
// 16-byte copies (src, stride and ncols multiples of 4 floats, src
// 16-byte aligned).
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int nrows, int ncols, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kRows * W / 4; e += kThreads) {
      const int r = e / (W / 4), c = e % (W / 4) * 4;
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// hi = v rounded to TF32 (to nearest, ties away: cvt.rna's rounding, in two
// integer operations); lo = v - hi, exact in float32, of which the tensor
// core reads the TF32 part (its low 13 bits are ignored)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
struct Frag4 { uint32_t hi[4], lo[4]; };   // an A fragment, split
__device__ __forceinline__ Frag4 split4(float a0, float a1, float a2,
                                        float a3) {
  Frag4 f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}
// a B fragment (b0, b1), split: {b0 hi, b1 hi, b0 lo, b1 lo}
__device__ __forceinline__ uint4 split2(float b0, float b1) {
  uint4 q;
  split(b0, q.x, q.z);
  split(b1, q.y, q.w);
  return q;
}

// d += a.b, m16n8k8, tf32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d[j] += a.b[j] in 3xTF32 for N independent n8 tiles, the small products
// first.  Each term is issued for every tile before the next term: the
// three products into one accumulator depend on each other (~40 cycles
// apart on this card), the N tiles do not.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const Frag4& a,
                                     const uint4 (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.lo, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.hi, b[j].z, b[j].w);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.hi, b[j].x, b[j].y);
}

// The chunk's dt (sDt) and inclusive prefix sum cs of dt * a (sCs) over
// its positions, two a thread; 0 at positions >= chunk.  Both grids call
// it on the same data, so they see the same cs.
__device__ void chunk_cumsum(const float* __restrict__ dt, int64_t stride,
                             float a, int chunk, float* sDt, float* sCs,
                             float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = 2 * threadIdx.x;
  const float d0 = q < chunk ? dt[q * stride] : 0.0f;
  const float d1 = q + 1 < chunk ? dt[(q + 1) * stride] : 0.0f;
  const float v0 = d0 * a, v1 = v0 + d1 * a;
  float incl = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  float base = 0.0f;
  for (int w = 0; w < warp; ++w) base += warp_sums[w];
  excl += base;
  sDt[q] = d0;
  sDt[q + 1] = d1;
  sCs[q] = q < chunk ? excl + v0 : 0.0f;
  sCs[q + 1] = q + 1 < chunk ? excl + v1 : 0.0f;
  __syncthreads();
}

template <int MT, int NT, int WP>
constexpr int state_smem_floats() {
  return 2 * kRows * (lead(16 * MT * WP) + lead(8 * NT * (kWarps / WP)));
}

// grid 1: block (state tile, head, batch) walks the chunks in series.  Its
// 4 warps are WP x (4 / WP) over the block's (p, n) tile, each warp
// (16 MT) x (8 NT): every split x o w fragment serves NT products and
// every split B fragment MT.
template <int MT, int NT, int WP>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ prev, float* __restrict__ final_state,
                 int s, int h, int p, int g, int n, int chunk, int tiles_n,
                 int vec_x, int vec_n) {
  constexpr int WN = kWarps / WP;
  constexpr int PT = 16 * MT * WP, NTB = 8 * NT * WN;   // the block's tile
  constexpr int LX = lead(PT), LB = lead(NTB);
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                   // [2][kRows][LX] x rows
  float* sB = sX + 2 * kRows * LX;    // [2][kRows][LB] B rows
  __shared__ float sCs[kMaxChunk], sDt[kMaxChunk], sW[kMaxChunk];
  __shared__ float warp_sums[kWarps];

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int p0 = blockIdx.x / tiles_n * PT, n0 = blockIdx.x % tiles_n * NTB;
  const int grp = hh / (h / g);
  const int nc = s / chunk, nsub = (chunk + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row, column
  const int wr = warp / WN * 16 * MT, wc = warp % WN * 8 * NT;
  const float a = A[hh];
  const int64_t bh = (int64_t)bb * h + hh;

  auto issue = [&](int it) {
    const int c = it / nsub, q0 = it % nsub * kRows;
    const int64_t row = (int64_t)bb * s + (int64_t)c * chunk + q0;
    const int nrows = min(kRows, chunk - q0);
    load_tile<PT>(sX + (it & 1) * kRows * LX, LX,
                  x + (row * h + hh) * p + p0, (int64_t)h * p, nrows, p - p0,
                  vec_x);
    load_tile<NTB>(sB + (it & 1) * kRows * LB, LB,
                   B + (row * g + grp) * n + n0, (int64_t)g * n, nrows,
                   n - n0, vec_n);
    cp_async_commit();
  };

  // rows p0 + wr + 16 m + gq (+ 8), columns n0 + wc + 8 j + 2 tq (+ 1)
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
  auto store = [&](float* out) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pr = p0 + wr + 16 * m + gq + 8 * (i >> 1);
          const int nn = n0 + wc + 8 * j + 2 * tq + (i & 1);
          if (pr < p && nn < n) out[(int64_t)pr * n + nn] = acc[m][j][i];
        }
  };

  const int total = nc * nsub;
  issue(0);
  for (int it = 0; it < total; ++it) {
    const int c = it / nsub, sub = it % nsub, q0 = sub * kRows;
    if (sub == 0) {
      chunk_cumsum(dt + ((int64_t)bb * s + (int64_t)c * chunk) * h + hh, h,
                   a, chunk, sDt, sCs, warp_sums);
      const float last = sCs[chunk - 1];
      for (int q = threadIdx.x; q < kMaxChunk; q += kThreads)
        sW[q] = q < chunk ? __expf(fminf(last - sCs[q], 0.0f)) * sDt[q]
                          : 0.0f;
      if (c > 0) store(prev + (bh * (nc - 1) + c - 1) * p * n);
      const float decay = __expf(fminf(last, 0.0f));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] *= decay;
    }
    if (it + 1 < total) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the tile and sW are in place

    // permuted k: fragment column tq is position 2 tq, column tq + 4 is
    // 2 tq + 1
    const float* X = sX + (it & 1) * kRows * LX + wr + gq;
    const float* Bt = sB + (it & 1) * kRows * LB + wc + gq;
    const int ksteps = (min(kRows, chunk - q0) + 7) / 8;
#pragma unroll 2
    for (int kk = 0; kk < ksteps; ++kk) {
      const int r = 8 * kk + 2 * tq;   // positions r and r + 1 of the tile
      const float w0 = sW[q0 + r], w1 = sW[q0 + r + 1];
      const float* x0 = X + r * LX;
      Frag4 fa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        fa[m] = split4(x0[16 * m] * w0, x0[16 * m + 8] * w0,
                       x0[LX + 16 * m] * w1, x0[LX + 16 * m + 8] * w1);
      uint4 fb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        fb[j] = split2(Bt[r * LB + 8 * j], Bt[(r + 1) * LB + 8 * j]);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc[m], fa[m], fb);
    }
    __syncthreads();   // the buffer is free for tile it + 2
  }
  store(final_state + bh * p * n);
}

// ---------------------------------------------------------------------
// The output grid: warpgroup products (wgmma) on 128-byte-swizzled K-major
// tf32 tiles that the block's threads write, each split once into a hi and
// a lo tile.  A K-major tile of R rows holds K / 32 atoms of R rows x 128
// bytes; the 16-byte chunk c of row r sits at c ^ (r % 8) (what TMA's
// 128-byte swizzle writes, so hopper::desc_k addresses its k8 slices: 32
// bytes, like a bf16 k16 slice).

constexpr int kKeys = 32;                   // keys per tile of the output

#define SSD_D16                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SSD_D32                                                             \
  SSD_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define SSD_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SSD_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d += A.B, m64n32k8, tf32 in, float32 accumulate; A and B K-major in
// shared memory.  d is 16 registers of an m64n32 accumulator, or the half
// of an m64n64 one that holds 32 of its columns.
__device__ __forceinline__ void wg_ss32(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SSD_R16
      ", %16, %17, p, 1, 1;\n}"
      : SSD_D16
      : "l"(a), "l"(b));
}
// d += A.B, m64n64k8: A from registers (the m16n8k8 tf32 fragment of the
// warp's 16 rows), B K-major in shared memory
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SSD_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : SSD_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
#undef SSD_D16
#undef SSD_D32
#undef SSD_R16
#undef SSD_R32

// the byte offset of 16-byte chunk c (columns 4 c .. 4 c + 3) of row r in
// a K-major swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}
__device__ __forceinline__ void st_shared4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// four values split into a hi chunk and a lo chunk
__device__ __forceinline__ void split_store(uint32_t hi, uint32_t lo,
                                            float a, float b, float c,
                                            float d) {
  uint4 h, l;
  split(a, h.x, l.x);
  split(b, h.y, l.y);
  split(c, h.z, l.z);
  split(d, h.w, l.w);
  st_shared4(hi, h);
  st_shared4(lo, l);
}

// ROWS rows of K = 32 KA columns of a row-major source (row r at src + r *
// stride; rows < nrows and columns < ncols real, zeros elsewhere) into a
// K-major tile pair (hi, lo): load() issues all of the thread's loads,
// store() splits and writes them.  vec: 16-byte loads (src, stride and
// ncols multiples of 4 floats, src 16-byte aligned).
template <int ROWS, int KA>
struct KStage {
  static constexpr int kItems = ROWS * KA * 8 / kThreads;
  float4 v[kItems];

  __device__ __forceinline__ void load(int tid, const float* src,
                                       int64_t stride, int nrows, int ncols,
                                       bool vec) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads, r = e / (KA * 8);
      const int col = e % (KA * 8) * 4;
      const float* q = src + r * stride + col;
      const int valid = r < nrows ? ncols - col : 0;
      if (vec && valid >= 4) {
        v[i] = *reinterpret_cast<const float4*>(q);
      } else {
        v[i].x = valid > 0 ? q[0] : 0.0f;
        v[i].y = valid > 1 ? q[1] : 0.0f;
        v[i].z = valid > 2 ? q[2] : 0.0f;
        v[i].w = valid > 3 ? q[3] : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store(int tid, uint32_t hi,
                                        uint32_t lo) const {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      const uint32_t off = sw_off(ROWS, e / (KA * 8), e % (KA * 8));
      split_store(hi + off, lo + off, v[i].x, v[i].y, v[i].z, v[i].w);
    }
  }
};

// the key tile's dt x rows (key r's x at src + r * stride and dt at
// dts[r * dstride]; keys < nrows and columns < p real) transposed into PC
// K-major tile pairs of 64 columns x 32 keys, the keys of each 8-key block
// permuted: position t is key 2 t, position t + 4 key 2 t + 1 (chunk 2 j +
// half holds keys 8 j + half + 2 i, i = 0 .. 3)
template <int PC>
struct XStage {
  static constexpr int kItems = 64 * 8 / kThreads;
  float v[PC][kItems][4], d[kItems][4];

  __device__ __forceinline__ void load(int tid, const float* src,
                                       int64_t stride, const float* dts,
                                       int64_t dstride, int nrows, int p) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int ch = (tid + i * kThreads) / 64;
      const int k = 8 * (ch >> 1) + (ch & 1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[i][q] = k + 2 * q < nrows ? dts[(k + 2 * q) * dstride] : 0.0f;
    }
#pragma unroll
    for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int e = tid + i * kThreads;
        const int pc = 64 * pcc + e % 64, ch = e / 64;
        const int k = 8 * (ch >> 1) + (ch & 1);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[pcc][i][q] = pc < p && k + 2 * q < nrows
                             ? src[(k + 2 * q) * stride + pc] : 0.0f;
      }
  }
  __device__ __forceinline__ void store(int tid, uint32_t hi,
                                        uint32_t lo) const {
#pragma unroll
    for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int e = tid + i * kThreads;
        const uint32_t off = pcc * 8192 + sw_off(64, e % 64, e / 64);
        split_store(hi + off, lo + off, d[i][0] * v[pcc][i][0],
                    d[i][1] * v[pcc][i][1], d[i][2] * v[pcc][i][2],
                    d[i][3] * v[pcc][i][3]);
      }
  }
};

// the descriptor of a K-major tile's first k8 slice, made where it is
// used: the volatile move keeps the compiler from hoisting the descriptors
// of every slice out of the key loop into registers of their own
__device__ __forceinline__ uint64_t desc_base(uint32_t tile) {
  uint32_t t;
  asm volatile("mov.b32 %0, %1;" : "=r"(t) : "r"(tile));
  return hopper::desc_k(t, 64, 0);
}
// slice kk of a tile of `rows` rows from its first slice's descriptor: the
// start address (in 16-byte units, the descriptor's low bits) moves by the
// atom (kk / 4) and the 32-byte step within it (hopper::desc_k)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int rows, int kk) {
  return d + (((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);
}

// make the threads' shared-memory writes visible to the tensor cores' reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The block's shared memory, all of it dynamic and 1024-byte aligned: C (64
// rows), the B of a key tile (32 rows) and its dt x^T (PC tiles of 64 rows
// x 32 keys), each a hi and a lo tile, then cs.  At mamba2's shape that is
// 115,712 bytes: with the 1 KB the card reserves for each block, exactly
// two blocks an SM.
template <int KA>
__host__ __device__ constexpr int c_tile_bytes() { return 64 * 128 * KA; }
template <int KA>
__host__ __device__ constexpr int b_tile_bytes() { return 32 * 128 * KA; }
template <int KA, int PC>
__host__ __device__ constexpr int cs_offset() {
  return 2 * c_tile_bytes<KA>() + 2 * b_tile_bytes<KA>() + 2 * PC * 8192;
}
template <int KA, int PC>
constexpr int output_smem_bytes() {
  return cs_offset<KA, PC>() + sizeof(float) * kMaxChunk;
}

// grid 2: y, block (chunk x 64-row tile, head, batch), one warpgroup; n <=
// 32 KA, p <= 64 PC
template <int KA, int PC>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ C,
                  const float* __restrict__ prev, float* __restrict__ y,
                  int s, int h, int p, int g, int n, int chunk, int tiles,
                  int vec_n) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  if (base & 1023) __trap();   // the swizzled tiles need 1024-byte alignment
  const uint32_t cH = base, cL = base + c_tile_bytes<KA>();   // C rows
  const uint32_t bH = base + 2 * c_tile_bytes<KA>();   // B keys, or prev
  const uint32_t bL = bH + b_tile_bytes<KA>();
  const uint32_t xH = bL + b_tile_bytes<KA>(), xL = xH + PC * 8192;
  float* sCs = reinterpret_cast<float*>(smem_raw + cs_offset<KA, PC>());
  // the scan's scratch lies in the key tiles, which it precedes
  float* sDt = reinterpret_cast<float*>(smem_raw + (xH - base));
  float* warp_sums = sDt + kMaxChunk;

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int c = blockIdx.x / tiles;
  const int tile = tiles - 1 - blockIdx.x % tiles;   // heaviest first
  const int nc = s / chunk, i0 = tile * kRows;
  const int grp = hh / (h / g);
  const int64_t t0 = (int64_t)bb * s + (int64_t)c * chunk;
  const int64_t bh = (int64_t)bb * h + hh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ilo = i0 + 16 * warp + gq, ihi = ilo + 8;   // chunk rows

  // the block's first loads, all in flight while the chunk's cs is
  // scanned: C's rows, prev's first 32 columns and the first key tile
  const float* pv = prev + (bh * (nc - 1) + c - 1) * p * n;
  const int k_end = min(chunk, i0 + kRows);
  KStage<64, KA> cst;
  KStage<32, KA> ps, bs;
  XStage<PC> xs;
  cst.load(tid, C + ((t0 + i0) * g + grp) * n, (int64_t)g * n, chunk - i0, n,
           vec_n);
  if (c > 0)   // the state before chunk 0 is zero
    ps.load(tid, pv, n, p, n, vec_n);
  auto load_keys = [&](int k0) {
    bs.load(tid, B + ((t0 + k0) * g + grp) * n, (int64_t)g * n, chunk - k0,
            n, vec_n);
    xs.load(tid, x + ((t0 + k0) * h + hh) * p, (int64_t)h * p,
            dt + (t0 + k0) * h + hh, h, chunk - k0, p);
  };
  load_keys(0);
  chunk_cumsum(dt + t0 * h + hh, h, A[hh], chunk, sDt, sCs, warp_sums);
  cst.store(tid, cH, cL);

  // accumulator register i of y[pcc]: row ilo (i % 4 < 2) or ihi, column
  // 64 pcc + 8 (i / 4) + 2 tq + i % 2
  float acc[PC][32];
#pragma unroll
  for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pcc][i] = 0.0f;
  if (c > 0) {
#pragma unroll
    for (int pass = 0; pass < 2 * PC; ++pass) {   // 32 columns of y a pass
      if (pass > 0) {
        __syncthreads();   // the previous pass's products are done
        ps.load(tid, pv + (int64_t)32 * pass * n, n, p - 32 * pass, n, vec_n);
      }
      ps.store(tid, bH, bL);
      fence_async();
      __syncthreads();
      float* d = acc[pass / 2] + 16 * (pass % 2);
      const uint64_t dcl = desc_base(cL), dch = desc_base(cH);
      const uint64_t dbh = desc_base(bH), dbl = desc_base(bL);
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * KA; ++kk) {
        wg_ss32(d, desc_add(dcl, 64, kk), desc_add(dbh, 32, kk));
        wg_ss32(d, desc_add(dch, 64, kk), desc_add(dbl, 32, kk));
        wg_ss32(d, desc_add(dch, 64, kk), desc_add(dbh, 32, kk));
      }
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::pin(acc[pass / 2]);
    }
    const float elo = ilo < chunk ? __expf(fminf(sCs[ilo], 0.0f)) : 0.0f;
    const float ehi = ihi < chunk ? __expf(fminf(sCs[ihi], 0.0f)) : 0.0f;
#pragma unroll
    for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pcc][i] *= i % 4 < 2 ? elo : ehi;
  }

  // W (i, k) = S (i, k) exp(cs_i - cs_k) where k <= i < chunk, else 0 (dt_k
  // is in x^T): the decay is computed for every entry (its exponent clamped
  // to <= 0) and the mask selects, without a branch, so the entries' loads
  // and exponentials overlap
  auto w_of = [&](float sv, int i, int k) {
    const float w = sv * __expf(fminf(sCs[i] - sCs[k], 0.0f));
    return k <= i && i < chunk ? w : 0.0f;
  };
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the previous products are done
    bs.store(tid, bH, bL);
    xs.store(tid, xH, xL);
    fence_async();
    __syncthreads();
    // the next key tile's loads are in flight during this one's products
    if (k0 + kKeys < k_end) load_keys(k0 + kKeys);

    // S = C.B^T over the 32 keys
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
    const uint64_t dcl = desc_base(cL), dch = desc_base(cH);
    const uint64_t dbh = desc_base(bH), dbl = desc_base(bL);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * KA; ++kk) {
      wg_ss32(sc, desc_add(dcl, 64, kk), desc_add(dbh, 32, kk));
      wg_ss32(sc, desc_add(dch, 64, kk), desc_add(dbl, 32, kk));
      wg_ss32(sc, desc_add(dch, 64, kk), desc_add(dbh, 32, kk));
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(sc[i])::"memory");

    // W in place, as A fragments: key block j's registers 4 j .. 4 j + 3
    // hold rows (ilo, ilo, ihi, ihi) x keys (2 tq, 2 tq + 1), which with
    // the permuted k are fragment columns (tq, tq + 4)
    uint32_t wh[4][4], wl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ka = k0 + 8 * j + 2 * tq, kb = ka + 1;
      split(w_of(sc[4 * j], ilo, ka), wh[j][0], wl[j][0]);
      split(w_of(sc[4 * j + 2], ihi, ka), wh[j][1], wl[j][1]);
      split(w_of(sc[4 * j + 1], ilo, kb), wh[j][2], wl[j][2]);
      split(w_of(sc[4 * j + 3], ihi, kb), wh[j][3], wl[j][3]);
    }
    const uint64_t dxh = desc_base(xH), dxl = desc_base(xL);
    hopper::wg_fence();
#pragma unroll
    for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // x^T tile pcc is pcc * 8192 bytes (512 units) on
        wg_rs(acc[pcc], wl[j], desc_add(dxh + 512 * pcc, 64, j));
        wg_rs(acc[pcc], wh[j], desc_add(dxl + 512 * pcc, 64, j));
        wg_rs(acc[pcc], wh[j], desc_add(dxh + 512 * pcc, 64, j));
      }
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int pcc = 0; pcc < PC; ++pcc) hopper::pin(acc[pcc]);
  }

#pragma unroll
  for (int pcc = 0; pcc < PC; ++pcc)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i % 4 < 2 ? ilo : ihi;
      const int col = 64 * pcc + 8 * (i / 4) + 2 * tq + (i & 1);
      if (r < chunk && col < p)
        y[((t0 + r) * h + hh) * p + col] = acc[pcc][i];
    }
}

// the kernel may take `bytes` of dynamic shared memory, and the SM gives
// shared memory all it can (the output grid fits two blocks only so)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* configured) {
  if (*configured >= bytes) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

struct Args {
  const float *x, *dt, *A, *B, *C;
  float *y, *final_state, *prev;
  int b, s, h, p, g, n, chunk, vec_x, vec_n;
  cudaStream_t stream;
};

template <int MT, int NT, int WP>
cudaError_t launch_states(const Args& a) {
  static int configured = 0;
  constexpr int smem = sizeof(float) * state_smem_floats<MT, NT, WP>();
  cudaError_t err =
      allow_smem(ssd_state_kernel<MT, NT, WP>, smem, &configured);
  if (err != cudaSuccess) return err;
  constexpr int PT = 16 * MT * WP, NTB = 8 * NT * (kWarps / WP);
  const int tiles_n = (a.n + NTB - 1) / NTB, tiles_p = (a.p + PT - 1) / PT;
  const dim3 grid(tiles_n * tiles_p, a.h, a.b);
  ssd_state_kernel<MT, NT, WP><<<grid, kThreads, smem, a.stream>>>(
      a.x, a.dt, a.A, a.B, a.prev, a.final_state, a.s, a.h, a.p, a.g, a.n,
      a.chunk, tiles_n, a.vec_x, a.vec_n);
  return cudaGetLastError();
}

template <int KA, int PC>
cudaError_t launch_output(const Args& a) {
  static int configured = 0;
  constexpr int smem = output_smem_bytes<KA, PC>();
  cudaError_t err =
      allow_smem(ssd_output_kernel<KA, PC>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int tiles = (a.chunk + kRows - 1) / kRows;
  const dim3 grid(a.s / a.chunk * tiles, a.h, a.b);
  ssd_output_kernel<KA, PC><<<grid, kThreads, smem, a.stream>>>(
      a.x, a.dt, a.A, a.B, a.C, a.prev, a.y, a.s, a.h, a.p, a.g, a.n,
      a.chunk, tiles, a.vec_n);
  return cudaGetLastError();
}

template <int KA>
cudaError_t launch_output_p(const Args& a) {
  return a.p <= 64 ? launch_output<KA, 1>(a) : launch_output<KA, 2>(a);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n), all contiguous
// float32 -> y (b, s, h, p) and final_state (b, h, p, n), contiguous float32;
// prev (b, h, s/chunk - 1, p, n) is float32 scratch (the state before each
// chunk but the first).  s > 0 a multiple of chunk <= 256, h a multiple of
// g, p and n in [1, 128].  Launches the states grid, then the output grid.
extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, void* y,
                                     void* final_state, void* prev, int b,
                                     int s, int h, int p, int g, int n,
                                     int chunk, void* stream) {
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || chunk > kMaxChunk || s < chunk || s % chunk != 0 ||
      g < 1 || h % g != 0 || p < 1 || p > kMaxDim || n < 1 || n > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = p % 4 == 0 && aligned16(x);
  const int vec_n = n % 4 == 0 && aligned16(B) && aligned16(C) &&
                    aligned16(prev);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(B),
               static_cast<const float*>(C), static_cast<float*>(y),
               static_cast<float*>(final_state), static_cast<float*>(prev),
               b, s, h, p, g, n, chunk, vec_x, vec_n,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err =
      n > 64 ? launch_states<2, 8, 2>(a) : launch_states<1, 4, 4>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 32) err = launch_output_p<1>(a);
  else if (n <= 64) err = launch_output_p<2>(a);
  else err = launch_output_p<4>(a);
  return static_cast<int>(err);
}
