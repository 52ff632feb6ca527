// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), plain C
// interface for ctypes (see src/repro_torch/kernels/ssd/ssd.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd/ssd.py:
//   ssd_f32, ssd_bf16  <-  ssd_pallas (body _ssd_kernel)
//
// For one (batch b, head h) and chunks of L steps, with a = dt * A and
// a_cs its cumulative sum over the chunk:
//   G       = C B^T                                   [L, L]
//   W       = G * exp(a_cs[i] - a_cs[j]) * dt[j]  for i >= j, else 0
//   y       = W x + exp(a_cs) * (C state_in^T)        [L, p]
//   U       = (x * w)^T B,  w = dt * exp(a_cs[L-1] - a_cs)      [p, n]
//   state_out = exp(a_cs[L-1]) * state_in + U
// x, y [b, s, h, p], dt [b, s, h], A [h], B, C [b, s, g, n], state
// [b, h, p, n] float32; head h reads B/C of group h / (h_total / g) (the
// reference's bc_map), so grouped B/C are never expanded per head. Steps
// past s read as zeros (dt = 0: decay 1, no state contribution; the TPU
// wrapper padded with zeros), by zero-filled copies rather than padding.
//
// The TPU kernel walked the chunks of one (b, h) in order, carrying the
// state in VMEM. Here the chunk axis is parallel, in three launches:
//   1. chunk_state   one block per (head, chunk, batch): a_cs, the chunk's
//      own contribution U and its decay exp(a_cs[L-1]), into float32
//      scratch [b, s/L, h, p, n] and [b, s/L, h] that the wrapper
//      allocates (25 MB at the mamba2-780m prefill: it stays in L2);
//   2. state_pass    one thread per 4 state entries of one (b, h), walking
//      the chunks: replaces each U by the state entering its chunk (in
//      place) and writes the final state;
//   3. chunk_output  one block per (head, chunk, batch): y from the chunk's
//      inputs and its incoming state; only the 16-column blocks of W on or
//      below the diagonal, C B^T recomputed rather than stored.
// At the mamba2-780m prefill (b 1, s 2048, h 48, chunk 128) passes 1 and 3
// launch 768 blocks each (the earlier kernel: 48 blocks for 132 SMs, each
// walking 16 chunks). Blocks of one chunk and neighbouring heads run side
// by side, so a group's B/C chunk is read from device memory once and from
// L2 after.
//
// bfloat16: every product runs on the tensor cores as mma.sync m16n8k16
// (bf16 in, float32 accumulate). mma.sync rather than wgmma: it takes every
// shape the wrapper accepts (chunk 16 to 128, p 16 to 64, n padded to 16)
// where wgmma needs 64-row tiles, its accumulator fragment is directly the
// A fragment of the next product (G's accumulators become W x's A operand
// in registers, as in flash attention), and the products are not what
// bounds the kernel (see Bound). x, B and C are exact bf16 and enter as
// they are; a float32 operand enters split into bf16 terms (hi = bf16(v),
// lo = bf16(v - hi), ...), one product each: x * w (pass 1 puts the weight
// on x, split once per k-step in registers, so B enters as it is) and the
// incoming state as hi + lo pairs, W as hi + mid + lo (see
// chunk_output_bf16). One rounding of x * w and the state to bf16 would
// put the final state's relative error near 2e-3, above the 1e-3 the port
// holds it to. n is zero-padded in shared memory to a multiple of 16, so
// its padding contributes nothing.
// Tiles are staged by cp.async (16-byte copies where rows are aligned,
// zero-filled past s; plain loads for bf16 rows that are not) with row
// strides padded by 16 bytes so that ldmatrix's rows hit distinct banks;
// in pass 3 each warp loads its own 16 rows of C straight into A-fragment
// registers, and the state passes through registers to be split.
//
// float32: the same three launches; the products stay float32 FMA loops on
// the CUDA cores (a float32 model keeps float32 accuracy, no TF32), with
// tiles staged by 4-byte cp.async.
//
// exp is expf throughout; y is written in x's type.
//
// Bound (mamba2-780m prefill, bf16): ~28 MB of inputs and outputs against
// 5.7 GFLOP (lower triangles of G and W x only), 8.4 us of HBM against
// 5.8 us of tensor-core peak: bytes. The split operands and the
// recomputed C B^T raise the products issued to ~11 GFLOP, and the
// scratch adds 25 MB written and read twice, mostly in L2. What holds the
// kernel above that: each block of passes 1 and 3 loads, then computes,
// and the blocks of a wave (4 an SM in pass 1, 2 in pass 3, by shared
// memory and registers) load together, so a wave's loads run at the
// memory system's rate and its products at the tensor cores' with little
// overlap between them (PERF.md has the per-phase times).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kMaxN = 128;          // largest state size n
constexpr int kSmemLimit = 232448;  // bytes a block may use on the H100
constexpr int kFmaThreads = 256;    // float32 passes: a 16 x 16 thread grid
constexpr int kStateThreads = 256;  // pass 2
constexpr int kStateBatch = 8;      // chunks whose loads pass 2 issues at once

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- copies ----------------------------------------------------------------

// cp.async of BYTES (4 or 16) from device to shared memory; with `valid`
// false nothing is read and the shared bytes are zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Rows [0, R) of a slice whose row r starts at src + r * stride into shared
// rows of `ld` elements: columns [0, cols) copied, [cols, cols_pad) zero,
// rows at or past `rows_in` zero. `vec`: 16-byte copies (cols, stride and
// ld multiples of 16 bytes, src 16-byte aligned); otherwise 4-byte copies
// for float and plain loads for bf16 (whose rows need not be 4-byte
// aligned). The caller waits with cp_async_wait_all and a barrier.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ld,
                                           const T* __restrict__ src,
                                           int64_t stride, int R, int rows_in,
                                           int cols, int cols_pad, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = cols / V;
    for (int u = tid; u < R * per; u += NT) {
      const int r = u / per, c = (u - r * per) * V;
      const bool in = r < rows_in;
      cp_async<16>(dst + r * ld + c, in ? src + r * stride + c : src, in);
    }
  } else {
    for (int u = tid; u < R * cols; u += NT) {
      const int r = u / cols, c = u - r * cols;
      const bool in = r < rows_in;
      if constexpr (sizeof(T) == 4) {
        cp_async<4>(dst + r * ld + c, in ? src + r * stride + c : src, in);
      } else {
        dst[r * ld + c] = in ? src[r * stride + c] : from_f<T>(0.0f);
      }
    }
  }
  const int pad = cols_pad - cols;
  for (int u = tid; u < R * pad; u += NT) {
    const int r = u / pad;
    dst[r * ld + cols + u - r * pad] = from_f<T>(0.0f);
  }
}

// dt of the chunk's rows (0 past s)
template <int L, int NT>
__device__ __forceinline__ void stage_dt(float* __restrict__ dts,
                                         const float* __restrict__ dtg,
                                         int n_heads, int rows_in) {
  for (int r = threadIdx.x; r < L; r += NT) {
    dts[r] = r < rows_in ? dtg[static_cast<int64_t>(r) * n_heads] : 0.0f;
  }
}

// a_cs: inclusive scan of dt * A over the chunk, by the 32 lanes of warp 0;
// with `wl`, also wl[r] = dt[r] * exp(a_cs[L-1] - a_cs[r])
template <int L>
__device__ __forceinline__ void chunk_scan(const float* __restrict__ dts,
                                           float a_h, float* __restrict__ acs,
                                           float* __restrict__ wl) {
  constexpr int E = (L + 31) / 32;      // elements per lane
  const int lane = threadIdx.x & 31;
  float loc[E];
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    run += r < L ? dts[r] * a_h : 0.0f;
    loc[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  const float excl = lane == 0 ? 0.0f : prev;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    if (r < L) acs[r] = excl + loc[e];
  }
  if (wl == nullptr) return;
  __syncwarp();
  const float last = acs[L - 1];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    if (r < L) wl[r] = dts[r] * expf(last - acs[r]);
  }
}

// Where a block of passes 1 and 3 reads and writes: head blockIdx.x, chunk
// blockIdx.y, batch blockIdx.z.
struct Chunk {
  int h, ci, b, c0, rows_in, grp;
  int64_t x_off, bc_off, dt_off, slab;   // slab: (b, chunk, head) of scratch

  __device__ __forceinline__ Chunk(int L, int P, int n, int n_heads,
                                   int n_groups, int s) {
    h = blockIdx.x;
    ci = blockIdx.y;
    b = blockIdx.z;
    c0 = ci * L;
    rows_in = s - c0;
    grp = h / (n_heads / n_groups);
    const int64_t row0 = static_cast<int64_t>(b) * s + c0;
    x_off = (row0 * n_heads + h) * P;
    bc_off = (row0 * n_groups + grp) * n;
    dt_off = row0 * n_heads + h;
    slab = (static_cast<int64_t>(b) * gridDim.y + ci) * n_heads + h;
  }
};

// ---- pass 2: the state entering each chunk -----------------------------------

// u [b, chunks, h, p n] holds each chunk's contribution U on entry and the
// state entering that chunk on exit; dec [b, chunks, h] each chunk's decay;
// state [b, h, p n] the state after the last chunk. One thread per 4
// entries of one (b, h); pn4 = p n / 4 (p is a multiple of 16).
__global__ void __launch_bounds__(kStateThreads)
state_pass(float* __restrict__ u, const float* __restrict__ dec,
           float* __restrict__ state, int n_heads, int n_chunks, int pn4,
           int64_t total4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kStateThreads
                    + threadIdx.x;
  if (i >= total4) return;
  const int64_t bh = i / pn4;
  const int e = static_cast<int>(i - bh * pn4);
  const int64_t b = bh / n_heads;
  const int h = static_cast<int>(bh - b * n_heads);
  const int64_t step = static_cast<int64_t>(n_heads) * pn4;  // per chunk
  float4* up = reinterpret_cast<float4*>(u)
               + (b * n_chunks * n_heads + h) * pn4 + e;
  const float* dp = dec + b * n_chunks * n_heads + h;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < n_chunks; c0 += kStateBatch) {
    float4 v[kStateBatch];
    float d[kStateBatch];
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (c0 + k < n_chunks) {
        v[k] = up[(c0 + k) * step];
        d[k] = dp[static_cast<int64_t>(c0 + k) * n_heads];
      }
    }
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (c0 + k < n_chunks) {
        up[(c0 + k) * step] = run;
        run.x = fmaf(d[k], run.x, v[k].x);
        run.y = fmaf(d[k], run.y, v[k].y);
        run.z = fmaf(d[k], run.z, v[k].z);
        run.w = fmaf(d[k], run.w, v[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(state)[i] = run;
}

// ---- bfloat16: mma.sync m16n8k16 ----------------------------------------------

__device__ __forceinline__ uint32_t bits(bf162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi_a, b - hi_b)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const bf162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// the same with a third term: hi + mid + lo, ~24 bits of v
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const bf162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const bf162 m = __floats2bfloat162_rn(ra, rb);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(ra - __low2float(m), rb - __high2float(m)));
}

// (row[c], row[c + 1]) as one register of an A fragment, zero past n;
// `pair`: row + c is 4-byte aligned wherever c + 1 < n
__device__ __forceinline__ uint32_t ld_pair(const bf16* row, int c, int n,
                                            bool pair) {
  if (pair && c + 1 < n) return *reinterpret_cast<const uint32_t*>(row + c);
  return bits(__floats2bfloat162_rn(c < n ? __bfloat162float(row[c]) : 0.0f,
                                    c + 1 < n ? __bfloat162float(row[c + 1])
                                              : 0.0f));
}

// four 8 x 8 bf16 matrices; lanes 8 m .. 8 m + 7 give the row addresses of
// matrix m, register m receives it (thread: row lane / 4, columns 2 (lane % 4)
// and + 1; with trans, that element of the transposed matrix)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for one m16n8k16 tile: a 4 and b 2 registers of bf16 pairs,
// c 4 float32 (rows g and g + 8, columns 2t and 2t + 1; g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset into a row-major tile of `ld` elements that this lane hands
// ldmatrix x4 for the 16 x 16 block at (r0, c0); lanes 8 m .. 8 m + 7
// address the rows of matrix m, which is
//   rows_first: row half m & 1, column half m >> 1. Non-trans on a tile
//     stored [m][k] that is the A fragment a0..a3; trans on [k][n], the B
//     fragments b0, b1 of n columns 0-7, then b0, b1 of columns 8-15;
//   cols_first: column half m & 1, row half m >> 1. Non-trans on [n][k]
//     that is b0, b1 of n rows 0-7, then of rows 8-15; trans on [k][m], the
//     A fragment a0..a3 of the transpose.
__device__ __forceinline__ int off_rows_first(int r0, int c0, int ld) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  return (r0 + (lane & 7) + ((m & 1) << 3)) * ld + c0 + ((m >> 1) << 3);
}
__device__ __forceinline__ int off_cols_first(int r0, int c0, int ld) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  return (r0 + (lane & 7) + ((m >> 1) << 3)) * ld + c0 + ((m & 1) << 3);
}

// shared bytes of the bf16 passes at chunk L, head dim P, padded n16
__host__ __device__ constexpr int smem_state_bf16(int L, int P, int n16) {
  return (L * (P + 8) + L * (n16 + 8)) * 2 + 3 * L * 4;
}
__host__ __device__ constexpr int smem_output_bf16(int L, int P, int n16) {
  return (L * (P + 8) + (L + 2 * P) * (n16 + 8)) * 2 + 2 * L * 4;
}
static_assert(smem_output_bf16(128, 64, kMaxN) <= kSmemLimit, "pass 3 smem");

// Pass 1, bf16: 8 warps; warp (wm, wn) owns p rows [16 wm, +16) and the
// n16 column tiles wn, wn + WN, ... of U = (x * w)^T B, the reduction over
// the chunk's steps. The A operand (x * w)^T comes from ldmatrix.trans of
// x [step][p], is weighted in registers and split into hi + lo once per
// k-step; B [step][n] enters as it is (ldmatrix.trans).
template <int L, int P>
__global__ void __launch_bounds__(256)
chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ u, float* __restrict__ dec, int n_heads,
                 int n_groups, int s, int n, int vec_x, int vec_bc) {
  constexpr int NT = 256;
  constexpr int LX = P + 8;
  constexpr int WM = P / 16;            // warps along p
  constexpr int WN = 8 / WM;            // warps along n
  constexpr int QN = (kMaxN / 16) / WN; // n16 tiles a warp may own
  const int n16 = (n + 15) & ~15, LB = n16 + 8, nt16 = n16 / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);        // [L][LX]
  bf16* bs = xs + L * LX;                              // [L][LB]
  float* dts = reinterpret_cast<float*>(bs + L * LB);  // [L]
  float* acs = dts + L;                                // [L]
  float* wl = acs + L;                                 // [L]

  const Chunk ch(L, P, n, n_heads, n_groups, s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  stage_rows<bf16, NT>(xs, LX, x + ch.x_off,
                       static_cast<int64_t>(n_heads) * P, L, ch.rows_in, P,
                       P, vec_x);
  stage_rows<bf16, NT>(bs, LB, Bm + ch.bc_off,
                       static_cast<int64_t>(n_groups) * n, L, ch.rows_in, n,
                       n16, vec_bc);
  stage_dt<L, NT>(dts, dt + ch.dt_off, n_heads, ch.rows_in);
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_scan<L>(dts, A[ch.h], acs, wl);
  __syncthreads();
  if (tid == 0) dec[ch.slab] = expf(acs[L - 1]);

  const int wm = warp % WM, wn = warp / WM;
  float acc[QN][2][4];
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < L / 16; ++ks) {
    // a0, a1 hold steps 16 ks + 2t, + 1; a2, a3 the same + 8
    uint32_t a[4], ahi[4], alo[4];
    ldsm_x4_trans(a, xs + off_cols_first(16 * ks, 16 * wm, LX));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 16 * ks + 2 * t + 8 * (r >> 1);
      const bf162 v = *reinterpret_cast<const bf162*>(&a[r]);
      split2(__low2float(v) * wl[j], __high2float(v) * wl[j + 1], ahi[r],
             alo[r]);
    }
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int nt = wn + WN * q;
      if (nt < nt16) {
        uint32_t b[4];
        ldsm_x4_trans(b, bs + off_rows_first(16 * ks, 16 * nt, LB));
        mma(acc[q][0], ahi, b[0], b[1]);
        mma(acc[q][0], alo, b[0], b[1]);
        mma(acc[q][1], ahi, b[2], b[3]);
        mma(acc[q][1], alo, b[2], b[3]);
      }
    }
  }

  float* out = u + ch.slab * P * n;
#pragma unroll
  for (int q = 0; q < QN; ++q) {
    const int nt = wn + WN * q;
    if (nt >= nt16) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * nt + 8 * j + 2 * t;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float* o = out + (16 * wm + g + 8 * rh) * n + col;
        const float v0 = acc[q][j][2 * rh], v1 = acc[q][j][2 * rh + 1];
        if ((n & 1) == 0 && col + 1 < n) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < n) o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

// Pass 3, bf16: one warp per 16 rows i of the chunk (2 L threads). Each
// warp loads its rows of C straight into A fragments (no other warp reads
// them) and keeps them for both products with C:
//   y  = exp(a_cs) * (C (state_hi + state_lo)^T)   (chunks after the first)
//   y += sum over 16-column blocks j <= i of (W_hi + W_mid + W_lo) x,
// W's block built in registers from G = C B^T's accumulators. W enters as
// three bf16 terms, not two: with y rounded to bf16 on both sides, the
// pair's error (~2^-17 of each term of W x) moved enough outputs across a
// rounding boundary to fail chip_smoke's per-element limit (one bf16 step
// against 2^-8 |y| + 1e-3 max |y|) near |y| = 2^7 and 2^8; with three it is
// that of float32 products. x, B and the state take 89 KB of shared memory
// at chunk 128 (two blocks an SM).
template <int L, int P>
__global__ void __launch_bounds__(2 * L)
chunk_output_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ u,
                  bf16* __restrict__ y, int n_heads, int n_groups, int s,
                  int n, int vec_x, int vec_bc) {
  constexpr int NT = 2 * L;
  constexpr int LX = P + 8;
  constexpr int KMAX = kMaxN / 16;
  const int n16 = (n + 15) & ~15, LB = n16 + 8, nk = n16 / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);        // [L][LX]
  bf16* bs = xs + L * LX;                              // [L][LB]
  bf16* sh = bs + L * LB;                              // [P][LB] state hi
  bf16* sl = sh + P * LB;                              // [P][LB] state lo
  float* dts = reinterpret_cast<float*>(sl + P * LB);  // [L]
  float* acs = dts + L;                                // [L]

  const Chunk ch(L, P, n, n_heads, n_groups, s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * warp, ia = i0 + g, ib = ia + 8;
  const int64_t bc_row = static_cast<int64_t>(n_groups) * n;
  const int64_t x_row = static_cast<int64_t>(n_heads) * P;
  stage_rows<bf16, NT>(xs, LX, x + ch.x_off, x_row, L, ch.rows_in, P, P,
                       vec_x);
  stage_rows<bf16, NT>(bs, LB, Bm + ch.bc_off, bc_row, L, ch.rows_in, n,
                       n16, vec_bc);
  stage_dt<L, NT>(dts, dt + ch.dt_off, n_heads, ch.rows_in);
  uint32_t cf[KMAX][4];                 // rows ia, ib of C, A fragments
  {
    const bf16* ca = Cm + ch.bc_off + ia * bc_row;
    const bf16* cb = Cm + ch.bc_off + ib * bc_row;
    const bool in_a = ia < ch.rows_in, in_b = ib < ch.rows_in;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk >= nk) continue;
      const int c = 16 * kk + 2 * t;
      cf[kk][0] = in_a ? ld_pair(ca, c, n, vec_bc) : 0u;
      cf[kk][1] = in_b ? ld_pair(cb, c, n, vec_bc) : 0u;
      cf[kk][2] = in_a ? ld_pair(ca, c + 8, n, vec_bc) : 0u;
      cf[kk][3] = in_b ? ld_pair(cb, c + 8, n, vec_bc) : 0u;
    }
  }
  const bool has_state = ch.ci > 0;     // the first chunk enters with zeros
  if (has_state) {
    // the incoming state, float32 [P][n], split into hi + lo [P][LB]
    const float* st = u + ch.slab * P * n;
    if ((n & 3) == 0) {
      // kBatch float4 loads a thread in flight before their stores, so
      // the block waits for L2 once per batch (once at chunk 128, p 64)
      constexpr int kBatch = 8;
      const int q4 = n16 / 4, total = P * q4;
      for (int base = 0; base < total; base += kBatch * NT) {
        float4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * NT + tid;
          const int r = i / q4, c = (i - r * q4) * 4;
          v[k] = i < total && c < n
              ? *reinterpret_cast<const float4*>(st + r * n + c)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * NT + tid;
          if (i >= total) break;
          const int r = i / q4, c = (i - r * q4) * 4;
          uint2 hi, lo;
          split2(v[k].x, v[k].y, hi.x, lo.x);
          split2(v[k].z, v[k].w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(sh + r * LB + c) = hi;
          *reinterpret_cast<uint2*>(sl + r * LB + c) = lo;
        }
      }
    } else {
      for (int i = tid; i < P * n16; i += NT) {
        const int r = i / n16, c = i - r * n16;
        const float v = c < n ? st[r * n + c] : 0.0f;
        const bf16 hi = __float2bfloat16_rn(v);
        sh[r * LB + c] = hi;
        sl[r * LB + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_scan<L>(dts, A[ch.h], acs, nullptr);
  __syncthreads();

  float yacc[P / 8][4];
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.0f;

  const float acs_a = acs[ia], acs_b = acs[ib];
  if (has_state) {
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk >= nk) continue;
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        const int off = off_cols_first(16 * np, 16 * kk, LB);
        uint32_t hi[4], lo[4];
        ldsm_x4(hi, sh + off);
        ldsm_x4(lo, sl + off);
        mma(yacc[2 * np], cf[kk], hi[0], hi[1]);
        mma(yacc[2 * np], cf[kk], lo[0], lo[1]);
        mma(yacc[2 * np + 1], cf[kk], hi[2], hi[3]);
        mma(yacc[2 * np + 1], cf[kk], lo[2], lo[3]);
      }
    }
    const float ea = expf(acs_a), eb = expf(acs_b);
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      yacc[pt][0] *= ea;
      yacc[pt][1] *= ea;
      yacc[pt][2] *= eb;
      yacc[pt][3] *= eb;
    }
  }

  for (int kb = 0; kb <= warp; ++kb) {  // 16-column blocks on or below i
    const int j0 = 16 * kb;
    float gacc[2][4];                   // G's two n8 tiles
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk >= nk) continue;
      uint32_t bb[4];
      ldsm_x4(bb, bs + off_cols_first(j0, 16 * kk, LB));
      mma(gacc[0], cf[kk], bb[0], bb[1]);
      mma(gacc[1], cf[kk], bb[2], bb[3]);
    }
    // W = G * exp(a_cs[i] - a_cs[j]) * dt[j] for i >= j; its A fragment is
    // (row a, cols j0 + 2t..), (row b, ..), (row a, cols j0 + 8 + 2t..),
    // (row b, ..)
    uint32_t whi[4], wmid[4], wlo[4];
#pragma unroll
    for (int hj = 0; hj < 2; ++hj) {
      const int j = j0 + 8 * hj + 2 * t;
      const float a0 = acs[j], a1 = acs[j + 1];
      const float d0 = dts[j], d1 = dts[j + 1];
      const float* gv = gacc[hj];
      split3(ia >= j ? gv[0] * expf(acs_a - a0) * d0 : 0.0f,
             ia >= j + 1 ? gv[1] * expf(acs_a - a1) * d1 : 0.0f,
             whi[2 * hj], wmid[2 * hj], wlo[2 * hj]);
      split3(ib >= j ? gv[2] * expf(acs_b - a0) * d0 : 0.0f,
             ib >= j + 1 ? gv[3] * expf(acs_b - a1) * d1 : 0.0f,
             whi[2 * hj + 1], wmid[2 * hj + 1], wlo[2 * hj + 1]);
    }
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      uint32_t xb[4];
      ldsm_x4_trans(xb, xs + off_rows_first(j0, 16 * np, LX));
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        float (&c)[4] = yacc[2 * np + h8];
        mma(c, whi, xb[2 * h8], xb[2 * h8 + 1]);
        mma(c, wmid, xb[2 * h8], xb[2 * h8 + 1]);
        mma(c, wlo, xb[2 * h8], xb[2 * h8 + 1]);
      }
    }
  }

  bf16* yg = y + ch.x_off;
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
    const int col = 8 * pt + 2 * t;
    if (ia < ch.rows_in) {
      *reinterpret_cast<bf162*>(yg + ia * x_row + col) =
          __floats2bfloat162_rn(yacc[pt][0], yacc[pt][1]);
    }
    if (ib < ch.rows_in) {
      *reinterpret_cast<bf162*>(yg + ib * x_row + col) =
          __floats2bfloat162_rn(yacc[pt][2], yacc[pt][3]);
    }
  }
}

// ---- float32: FMA loops on the CUDA cores -----------------------------------

// floats of shared memory of the float32 passes at chunk L, head dim P, n
__host__ __device__ constexpr int smem_state_f32(int L, int P, int n) {
  return L * (P + 1) + L * (n + 1) + 3 * L;
}
__host__ __device__ constexpr int smem_output_f32(int L, int P, int n) {
  return L * (P + 1) + 2 * L * (n + 1) + P * (n + 1)
         + (L < 64 ? L : 64) * ((L < 64 ? L : 64) + 1) + 2 * L;
}
static_assert(smem_output_f32(128, 64, kMaxN) * 4 <= kSmemLimit,
              "shared memory of the largest chunk");

// Pass 1, float32: thread (tr, tc) of a 16 x 16 grid owns U's rows
// tr + 16 qq and columns tc + 16 kk.
template <int L, int P>
__global__ void __launch_bounds__(kFmaThreads)
chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ u, float* __restrict__ dec, int n_heads,
                int n_groups, int s, int n) {
  constexpr int NT = kFmaThreads;
  constexpr int LX = P + 1;
  constexpr int CP = P / 16;
  constexpr int NK = kMaxN / 16;
  const int LN = n + 1;
  extern __shared__ float smem[];
  float* xs = smem;                     // [L][LX]
  float* bs = xs + L * LX;              // [L][LN]
  float* dts = bs + L * LN;             // [L]
  float* acs = dts + L;                 // [L]
  float* wl = acs + L;                  // [L]

  const Chunk ch(L, P, n, n_heads, n_groups, s);
  const int tid = threadIdx.x;
  stage_rows<float, NT>(xs, LX, x + ch.x_off,
                        static_cast<int64_t>(n_heads) * P, L, ch.rows_in, P,
                        P, false);
  stage_rows<float, NT>(bs, LN, Bm + ch.bc_off,
                        static_cast<int64_t>(n_groups) * n, L, ch.rows_in, n,
                        n, false);
  stage_dt<L, NT>(dts, dt + ch.dt_off, n_heads, ch.rows_in);
  cp_async_wait_all();
  __syncthreads();
  if ((tid >> 5) == 0) chunk_scan<L>(dts, A[ch.h], acs, wl);
  __syncthreads();
  if (tid == 0) dec[ch.slab] = expf(acs[L - 1]);

  const int tr = tid >> 4, tc = tid & 15;
  float sn[CP][NK];
#pragma unroll
  for (int qq = 0; qq < CP; ++qq)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) sn[qq][kk] = 0.0f;
  for (int r = 0; r < L; ++r) {
    const float w = wl[r];
    float xv[CP];
#pragma unroll
    for (int qq = 0; qq < CP; ++qq) xv[qq] = xs[r * LX + tr + 16 * qq] * w;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = tc + 16 * kk;
      if (c < n) {
        const float bv = bs[r * LN + c];
#pragma unroll
        for (int qq = 0; qq < CP; ++qq)
          sn[qq][kk] = fmaf(xv[qq], bv, sn[qq][kk]);
      }
    }
  }
  float* out = u + ch.slab * P * n;
#pragma unroll
  for (int qq = 0; qq < CP; ++qq)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = tc + 16 * kk;
      if (c < n) out[(tr + 16 * qq) * n + c] = sn[qq][kk];
    }
}

// Pass 3, float32: thread (tr, tc) owns (L/16) rows x (P/16) columns of y;
// G and W in 64 x 64 blocks (those on or below the diagonal), W through
// shared memory into the same y registers.
template <int L, int P>
__global__ void __launch_bounds__(kFmaThreads)
chunk_output_f32(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ u,
                 float* __restrict__ y, int n_heads, int n_groups, int s,
                 int n) {
  constexpr int NT = kFmaThreads;
  constexpr int BL = L < 64 ? L : 64;   // G/W block
  constexpr int NB = L / BL;            // blocks per chunk side
  constexpr int RB = BL / 16;           // rows (and cols) per thread in a block
  constexpr int CP = P / 16;            // y columns per thread
  constexpr int LX = P + 1;
  const int LN = n + 1;
  extern __shared__ float smem[];
  float* xs = smem;                     // [L][LX]
  float* bs = xs + L * LX;              // [L][LN]
  float* cs = bs + L * LN;              // [L][LN]
  float* st = cs + L * LN;              // [P][LN], the incoming state
  float* ws = st + P * LN;              // [BL][BL + 1]
  float* dts = ws + BL * (BL + 1);      // [L]
  float* acs = dts + L;                 // [L]

  const Chunk ch(L, P, n, n_heads, n_groups, s);
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int64_t x_row = static_cast<int64_t>(n_heads) * P;
  const int64_t bc_row = static_cast<int64_t>(n_groups) * n;
  stage_rows<float, NT>(xs, LX, x + ch.x_off, x_row, L, ch.rows_in, P, P,
                        false);
  stage_rows<float, NT>(bs, LN, Bm + ch.bc_off, bc_row, L, ch.rows_in, n, n,
                        false);
  stage_rows<float, NT>(cs, LN, Cm + ch.bc_off, bc_row, L, ch.rows_in, n, n,
                        false);
  const bool has_state = ch.ci > 0;
  if (has_state) {
    stage_rows<float, NT>(st, LN, u + ch.slab * P * n, n, P, P, n, n, false);
  }
  stage_dt<L, NT>(dts, dt + ch.dt_off, n_heads, ch.rows_in);
  cp_async_wait_all();
  __syncthreads();
  if ((tid >> 5) == 0) chunk_scan<L>(dts, A[ch.h], acs, nullptr);
  __syncthreads();

  // y_inter = exp(a_cs) * (C state^T); the thread's y rows are
  // bi * BL + tr * RB + ii, its columns tc + 16 * cc
  float yacc[NB][RB][CP];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int ii = 0; ii < RB; ++ii)
#pragma unroll
      for (int cc = 0; cc < CP; ++cc) yacc[bi][ii][cc] = 0.0f;
  if (has_state) {
    for (int k = 0; k < n; ++k) {
      float sv[CP];
#pragma unroll
      for (int cc = 0; cc < CP; ++cc) sv[cc] = st[(tc + 16 * cc) * LN + k];
#pragma unroll
      for (int bi = 0; bi < NB; ++bi)
#pragma unroll
        for (int ii = 0; ii < RB; ++ii) {
          const float cv = cs[(bi * BL + tr * RB + ii) * LN + k];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            yacc[bi][ii][cc] = fmaf(cv, sv[cc], yacc[bi][ii][cc]);
        }
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int ii = 0; ii < RB; ++ii) {
        const float e = expf(acs[bi * BL + tr * RB + ii]);
#pragma unroll
        for (int cc = 0; cc < CP; ++cc) yacc[bi][ii][cc] *= e;
      }
  }

  // y_intra = W x, one BL x BL block of W at a time, blocks on or below
  // the diagonal only
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
#pragma unroll
    for (int bj = 0; bj <= bi; ++bj) {
      float g[RB][RB];
#pragma unroll
      for (int ii = 0; ii < RB; ++ii)
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) g[ii][jj] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float cv[RB], bv[RB];
#pragma unroll
        for (int ii = 0; ii < RB; ++ii)
          cv[ii] = cs[(bi * BL + tr * RB + ii) * LN + k];
#pragma unroll
        for (int jj = 0; jj < RB; ++jj)
          bv[jj] = bs[(bj * BL + tc + 16 * jj) * LN + k];
#pragma unroll
        for (int ii = 0; ii < RB; ++ii)
#pragma unroll
          for (int jj = 0; jj < RB; ++jj)
            g[ii][jj] = fmaf(cv[ii], bv[jj], g[ii][jj]);
      }
      __syncthreads();                // the last W block is no longer read
#pragma unroll
      for (int ii = 0; ii < RB; ++ii) {
        const int i = bi * BL + tr * RB + ii;
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) {
          const int j = bj * BL + tc + 16 * jj;
          ws[(tr * RB + ii) * (BL + 1) + tc + 16 * jj] =
              i >= j ? g[ii][jj] * expf(acs[i] - acs[j]) * dts[j] : 0.0f;
        }
      }
      __syncthreads();
      for (int jl = 0; jl < BL; ++jl) {
        float xv[CP];
#pragma unroll
        for (int cc = 0; cc < CP; ++cc)
          xv[cc] = xs[(bj * BL + jl) * LX + tc + 16 * cc];
#pragma unroll
        for (int ii = 0; ii < RB; ++ii) {
          const float w = ws[(tr * RB + ii) * (BL + 1) + jl];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            yacc[bi][ii][cc] = fmaf(w, xv[cc], yacc[bi][ii][cc]);
        }
      }
    }
  }
  float* yg = y + ch.x_off;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int ii = 0; ii < RB; ++ii) {
      const int r = bi * BL + tr * RB + ii;
      if (r < ch.rows_in) {
#pragma unroll
        for (int cc = 0; cc < CP; ++cc)
          yg[r * x_row + tc + 16 * cc] = yacc[bi][ii][cc];
      }
    }
}

// ---- launch ------------------------------------------------------------------

struct Args {
  const void *x, *dt, *A, *Bm, *Cm;
  void *y, *state, *u, *dec;
  int b, s, h, p, g, n;
};

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t launch_state_pass(const Args& a, int n_chunks, cudaStream_t st) {
  const int pn4 = a.p * a.n / 4;
  const int64_t total4 = static_cast<int64_t>(a.b) * a.h * pn4;
  const int64_t blocks = (total4 + kStateThreads - 1) / kStateThreads;
  state_pass<<<static_cast<unsigned>(blocks), kStateThreads, 0, st>>>(
      static_cast<float*>(a.u), static_cast<const float*>(a.dec),
      static_cast<float*>(a.state), a.h, n_chunks, pn4, total4);
  return cudaGetLastError();
}

template <int L, int P>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
  const int n_chunks = (a.s + L - 1) / L;
  const dim3 grid(a.h, n_chunks, a.b);
  const int n16 = (a.n + 15) & ~15;
  const int vec_x = aligned16(a.x);
  const int vec_bc = aligned16(a.Bm) && aligned16(a.Cm) && a.n % 8 == 0;
  const auto* x = static_cast<const bf16*>(a.x);
  const auto* dt = static_cast<const float*>(a.dt);
  const auto* A = static_cast<const float*>(a.A);
  const auto* Bm = static_cast<const bf16*>(a.Bm);
  auto* u = static_cast<float*>(a.u);
  auto* dec = static_cast<float*>(a.dec);

  int bytes = smem_state_bf16(L, P, n16);
  cudaError_t err = set_smem(chunk_state_bf16<L, P>, bytes);
  if (err != cudaSuccess) return err;
  chunk_state_bf16<L, P><<<grid, 256, bytes, st>>>(
      x, dt, A, Bm, u, dec, a.h, a.g, a.s, a.n, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_state_pass(a, n_chunks, st)) != cudaSuccess) return err;
  bytes = smem_output_bf16(L, P, n16);
  if ((err = set_smem(chunk_output_bf16<L, P>, bytes)) != cudaSuccess)
    return err;
  chunk_output_bf16<L, P><<<grid, 2 * L, bytes, st>>>(
      x, dt, A, Bm, static_cast<const bf16*>(a.Cm), u,
      static_cast<bf16*>(a.y), a.h, a.g, a.s, a.n, vec_x, vec_bc);
  return cudaGetLastError();
}

template <int L, int P>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  const int n_chunks = (a.s + L - 1) / L;
  const dim3 grid(a.h, n_chunks, a.b);
  const auto* x = static_cast<const float*>(a.x);
  const auto* dt = static_cast<const float*>(a.dt);
  const auto* A = static_cast<const float*>(a.A);
  const auto* Bm = static_cast<const float*>(a.Bm);
  auto* u = static_cast<float*>(a.u);
  auto* dec = static_cast<float*>(a.dec);

  int bytes = smem_state_f32(L, P, a.n) * static_cast<int>(sizeof(float));
  cudaError_t err = set_smem(chunk_state_f32<L, P>, bytes);
  if (err != cudaSuccess) return err;
  chunk_state_f32<L, P><<<grid, kFmaThreads, bytes, st>>>(
      x, dt, A, Bm, u, dec, a.h, a.g, a.s, a.n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_state_pass(a, n_chunks, st)) != cudaSuccess) return err;
  bytes = smem_output_f32(L, P, a.n) * static_cast<int>(sizeof(float));
  if ((err = set_smem(chunk_output_f32<L, P>, bytes)) != cudaSuccess)
    return err;
  chunk_output_f32<L, P><<<grid, kFmaThreads, bytes, st>>>(
      x, dt, A, Bm, static_cast<const float*>(a.Cm), u,
      static_cast<float*>(a.y), a.h, a.g, a.s, a.n);
  return cudaGetLastError();
}

template <typename T, int L, int P>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    return launch_bf16<L, P>(a, st);
  } else {
    return launch_f32<L, P>(a, st);
  }
}

template <typename T, int L>
cudaError_t by_p(const Args& a, cudaStream_t st) {
  switch (a.p) {
    case 16: return launch<T, L, 16>(a, st);
    case 32: return launch<T, L, 32>(a, st);
    case 64: return launch<T, L, 64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const Args& a, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = chunk > 0 ? (a.s + chunk - 1) / chunk : 0;
  if (a.g <= 0 || a.h % a.g || a.n <= 0 || a.n > kMaxN || a.s <= 0
      || n_chunks > 65535 || a.b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (chunk) {
    case 16: return static_cast<int>(by_p<T, 16>(a, st));
    case 32: return static_cast<int>(by_p<T, 32>(a, st));
    case 64: return static_cast<int>(by_p<T, 64>(a, st));
    case 128: return static_cast<int>(by_p<T, 128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y [b, s, h, p] and B, C [b, s, g, n] float32; dt [b, s, h] and A [h]
// float32; state [b, h, p, n] float32; scratch u [b, ceil(s / chunk), h,
// p, n] and dec [b, ceil(s / chunk), h] float32; all contiguous. p in
// {16, 32, 64}, n <= 128, chunk in {16, 32, 64, 128}, h % g == 0. Three
// launches on `stream`; returns the first cudaError_t (0 = launched).
extern "C" int ssd_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       void* u, void* dec, int b, int s, int h, int p, int g,
                       int n, int chunk, void* stream) {
  return dispatch<float>({x, dt, A, Bm, Cm, y, state, u, dec, b, s, h, p, g,
                          n}, chunk, stream);
}

// The same with x, y, B, C in bfloat16 (tensor-core products, float32
// accumulation and state).
extern "C" int ssd_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        void* u, void* dec, int b, int s, int h, int p, int g,
                        int n, int chunk, void* stream) {
  return dispatch<bf16>({x, dt, A, Bm, Cm, y, state, u, dec, b, s, h, p, g,
                         n}, chunk, stream);
}
