// Flash attention (forward) for Hopper (sm_90a), plain C interface for
// ctypes (see src/repro_torch/kernels/flash_attention/flash_attention.py).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_f32, flash_attention_bf16
//       <- flash_attention_pallas (body _flash_kernel)
//
// o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(d)) v[b, j, h / G]
// over the keys j < kv_len (and j <= i when causal), G = H / KV query heads
// per kv head. q, o are [B, Sq, H, d] and k, v [B, Skv, KV, d], read where
// they lie: the kv head of query head h is h / G, so GQA needs no repeated
// K/V and no transposes (the TPU wrapper repeated K/V and flattened heads).
//
// Three kernels, chosen by type and head dim d (never after a failure):
//
// float32, every d (flash_f32_kernel; d 16, 32, 64, 112, 128, 256): FMA
// loops on the CUDA cores, never TF32, so a float32 input keeps float32
// accuracy. One block per (64 query rows, b * H + h), 4 warps; each lane
// owns 4 rows x 8 keys of a score tile and 4 rows x d/8 output columns; a
// row's running max and sum live in the 8 lanes that share it. Q stays in
// shared memory; one kv buffer holds a tile's K, then its V; P goes
// through shared memory.
//
// bfloat16, d 64, 112, 128 and 256 (wg::flash_wgmma_kernel): the Hopper
// design, see its own note below. One block per (128 query rows, b * H +
// h), two consumer warpgroups and a TMA producer; both products are
// wgmma. d 112 runs d 128's tiles over a zero-filled pad of 16 columns;
// d 256 takes 64-key kv tiles, so that Q and a two-stage K/V ring fit in
// shared memory.
//
// bfloat16, d 16 and 32 (flash_bf16_kernel; no served config has them):
// mma.sync m16n8k16 with one block per (64 query rows, b * H + h), 4 warps
// of 16 rows. A 64-row wgmma tile would be mostly padding of the reduction
// and a TMA box row would be 32 or 64 bytes, so the warp-level products
// stay. Each warp keeps its 16 rows of Q as A fragments in registers; S =
// Q K^T lands in C fragments (a thread holds rows g and g + 8, g = lane /
// 4, and 2 keys of every 8), whose layout is that of the A fragment of P
// for the PV product, so P never leaves the registers. K and V are staged
// row-major by 16-byte loads; a B fragment of V is one ldmatrix.trans.
//
// Common to all three: the kv tiles are walked in order up to the causal
// limit of the block's last row (tiles masked for every row are never
// loaded, as the TPU kernel clamped its kv extent), with the online-softmax
// state m, l and the output accumulator in float32 registers. Scores are
// masked with a finite NEG_INF (-1e30, as the TPU kernel) and p is zeroed
// on masked keys, so a row whose keys are all masked ends as
// 0 / max(0, 1e-20) = 0. p is rounded to V's type before the PV product
// while l sums the unrounded p (the TPU kernel and nn/layers.attention_core
// do the same); out = acc / max(l, 1e-20), rounded to the input type. The
// float32 and mma.sync kernels take exp as expf of s / sqrt(d) - m; the
// wgmma kernel as exp2f(s * log2(e) / sqrt(d) - m) with m kept in that
// log2 domain (a relative difference of ~1e-7 in p, far inside the 2^-8
// of p's rounding to bf16).
//
// Bound: operations. Causal at B*H = 16, S = 2048, d = 128 the work is
// ~17 GFLOP against ~34 MB of q, k, v and o in bfloat16: tensor-core work
// (989 TFLOP/s bf16 dense, 17.4 us) ahead of the bytes (10 us at 3.35
// TB/s). At the other two serving shapes, causal at S = 2048: d 112 at 32
// heads (zamba2-7b's shared block) 30.1 GFLOP against 58.7 MB, 30.4 us;
// d 256 at 16 heads (gemma-7b) 34.4 GFLOP against 67.1 MB, 34.8 us. The
// mma.sync kernel reached 8 % of the bound at d 128, and 9-10 % at d 112
// and 256 (0.3254 and 0.3402 ms on an H100 80GB HBM3 at 700 W, beside
// 0.0862 and 0.0961 ms for scaled_dot_product_attention): a block staged
// each K/V tile with every thread between two __syncthreads (no copy
// overlapped a product), issued warp-level mma.sync, masked every element
// of every tile and launched its longest causal blocks last; at d 256 it
// also re-read Q's fragments from shared memory at every k-step. The
// wgmma kernel answers each point: TMA loads in a two-stage ring, issued
// by a producer warp, run ahead of the products; wgmma reads Q and K
// straight from swizzled shared memory (no fragment copies at any d); only
// a tile on the diagonal or across kv_len is masked; and the grid starts
// the longest blocks first. In float32 the CUDA cores' 67 TFLOP/s bound it.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (4 warps x 16)
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;
constexpr int kLdP = kBK + 1;  // padded row of the per-warp P tile
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "q and kv tiles are staged by one routine");

using bf16 = __nv_bfloat16;

// shared-memory bytes of each kernel
template <int D>
constexpr int smem_f32() {
  return (2 * kBQ * (D + 1) + 4 * 16 * kLdP) * 4;
}
template <int D>
constexpr int smem_bf16() {
  return 3 * kBQ * (D + 8) * 2;
}

// the largest batch of at most 8 loads that divides a thread's n loads
__host__ __device__ constexpr int load_batch(int n) {
  for (int b = 8; b > 1; --b) {
    if (n % b == 0) return b;
  }
  return 1;
}

// stage rows [r0, r0 + 64) of one head of a [.., S, heads, D] tensor
// (row stride `stride` elements) into a tile with rows of `LD` elements;
// rows >= s are 0. Every thread issues its 16-byte loads in batches of up
// to 8 before it stores them, so it waits for device memory once per
// batch rather than once per element.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, int r0,
                                      int s, int64_t stride) {
  constexpr int V = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int PER_ROW = D / V;
  constexpr int N = kBQ * PER_ROW / kThreads; // loads per thread
  constexpr int NB = load_batch(N);           // 7 of 14 at float32 d 112
  static_assert(N * kThreads == kBQ * PER_ROW, "tile splits evenly");
  static_assert(N % NB == 0, "batches split a thread's loads evenly");
#pragma unroll
  for (int base = 0; base < N; base += NB) {
    uint4 buf[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int u = threadIdx.x + kThreads * (base + j);
      const int r = u / PER_ROW, c = (u % PER_ROW) * V;
      buf[j] = r0 + r < s
          ? *reinterpret_cast<const uint4*>(
                src + static_cast<int64_t>(r0 + r) * stride + c)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int u = threadIdx.x + kThreads * (base + j);
      const int r = u / PER_ROW, c = (u % PER_ROW) * V;
      if constexpr (LD % V == 0) {         // 16-byte aligned rows
        *reinterpret_cast<uint4*>(dst + r * LD + c) = buf[j];
      } else {
        const T* e = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) dst[r * LD + c + i] = e[i];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int n_heads, int n_kv_heads, int sq, int skv, int kv_len,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 8;          // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][LD]
  float* kvs = qs + kBQ * LD;        // [kBK][LD]: a tile's K, then its V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  float* pw = kvs + kBK * LD + warp * 16 * kLdP;   // this warp's [16][kLdP]

  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * D;
  const int64_t kv_stride = static_cast<int64_t>(n_kv_heads) * D;
  const float* qb = q + (static_cast<int64_t>(b) * sq * n_heads + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * skv * n_kv_heads + kvh) * D;
  const float* vb = v + (static_cast<int64_t>(b) * skv * n_kv_heads + kvh) * D;
  float* ob = o + (static_cast<int64_t>(b) * sq * n_heads + h) * D;

  stage<float, D, LD>(qs, qb, q0, sq, q_stride);

  const int row0 = warp * 16 + rg * 4;   // the lane's first row in the tile
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  int kv_hi = kv_len;
  if (causal) kv_hi = min(kv_hi, min(q0 + kBQ, sq));
  const int n_tiles = (kv_hi + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's V is no longer read
    stage<float, D, LD>(kvs, kb, k0, skv, kv_stride);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(row0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kvs[(cg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + row0 + i;
      bool ok[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + cg + 8 * j;
        ok[j] = kp < kv_len && (!causal || qp >= kp);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        pw[(rg * 4 + i) * kLdP + cg + 8 * j] = p;
      }
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                 // every warp is done with K
    stage<float, D, LD>(kvs, vb, k0, skv, kv_stride);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pw[(rg * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kvs[kk * LD + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int qr = q0 + row0 + i;
    if (qr < sq) {
      const float den = fmaxf(li, 1e-20f);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ob[static_cast<int64_t>(qr) * q_stride + cg + 8 * c] = acc[i][c] / den;
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the B fragment (b0, b1) of keys [k0, k0 + 16) x columns [n0, n0 + 8)
// of a row-major [key][d] tile: ldmatrix.trans gives every thread keys
// 2t, 2t + 1 (and + 8) of column g
__device__ __forceinline__ void ldsm_trans(uint32_t& b0, uint32_t& b1,
                                           const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// c += a b for one m16n8k16 tile: a 4 and b 2 registers of bf16 pairs,
// c 4 float32 (rows g and g + 8, columns 2t and 2t + 1)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int n_heads, int n_kv_heads, int sq, int skv, int kv_len,
                  int causal, float scale) {
  constexpr int LQ = D + 8;         // row of the Q, K and V tiles (bf16)
  constexpr int KS = D / 16;        // k-steps of QK^T over d
  constexpr int NT = kBK / 8;       // 8-key column tiles of S
  constexpr int DT = D / 8;         // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][LQ]
  bf16* ks = qs + kBQ * LQ;                        // [kBK][LQ]
  bf16* vs = ks + kBK * LQ;                        // [kBK][LQ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * D;
  const int64_t kv_stride = static_cast<int64_t>(n_kv_heads) * D;
  const bf16* qb = q + (static_cast<int64_t>(b) * sq * n_heads + h) * D;
  const bf16* kb = k + (static_cast<int64_t>(b) * skv * n_kv_heads + kvh) * D;
  const bf16* vb = v + (static_cast<int64_t>(b) * skv * n_kv_heads + kvh) * D;
  bf16* ob = o + (static_cast<int64_t>(b) * sq * n_heads + h) * D;

  stage<bf16, D, LQ>(qs, qb, q0, sq, q_stride);
  __syncthreads();
  const int r0 = warp * 16;         // the warp's first row in the tile
  uint32_t qa[KS][4];               // Q's A fragments, kept in registers
#pragma unroll
  for (int kq = 0; kq < KS; ++kq) {
    const bf16* p = qs + (r0 + g) * LQ + kq * 16 + 2 * t;
    qa[kq][0] = ld32(p);
    qa[kq][1] = ld32(p + 8 * LQ);
    qa[kq][2] = ld32(p + 8);
    qa[kq][3] = ld32(p + 8 * LQ + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, acc[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  int kv_hi = kv_len;
  if (causal) kv_hi = min(kv_hi, min(q0 + kBQ, sq));
  const int n_tiles = (kv_hi + kBK - 1) / kBK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();                 // the last tile's K and V are read
    stage<bf16, D, LQ>(ks, kb, k0, skv, kv_stride);
    stage<bf16, D, LQ>(vs, vb, k0, skv, kv_stride);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int kq = 0; kq < KS; ++kq) {
        const bf16* p = ks + (nt * 8 + g) * LQ + kq * 16 + 2 * t;
        mma(s[nt], qa[kq], ld32(p), ld32(p + 8));
      }

#pragma unroll
    for (int i = 0; i < 2; ++i) {          // rows g and g + 8
      const int qp = q0 + r0 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + nt * 8 + 2 * t + j;
          const bool ok = kp < kv_len && (!causal || qp >= kp);
          float& x = s[nt][2 * i + j];
          x = ok ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + nt * 8 + 2 * t + j;
          const bool ok = kp < kv_len && (!causal || qp >= kp);
          float& x = s[nt][2 * i + j];
          x = ok ? expf(x - m_new) : 0.0f;
          rs += x;
        }
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        acc[c][2 * i] *= corr;
        acc[c][2 * i + 1] *= corr;
      }
    }

    // PV: the C fragments of S tiles 2kk and 2kk + 1 are the A fragment of
    // P's 16-key step kk (rounded to bf16 here)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        uint32_t b0, b1;
        ldsm_trans(b0, b1, vs + (kk * 16 + (lane & 15)) * LQ + c * 8);
        mma(acc[c], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qr = q0 + r0 + g + 8 * i;
    if (qr < sq) {
      const float den = fmaxf(li, 1e-20f);
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        *reinterpret_cast<uint32_t*>(
            ob + static_cast<int64_t>(qr) * q_stride + c * 8 + 2 * t) =
            pack(acc[c][2 * i] / den, acc[c][2 * i + 1] / den);
      }
    }
  }
}

// ---- bfloat16, d 64, 112, 128 and 256: wgmma + TMA ----------------------
//
// One block per (128 query rows, b * H + h): warps 0-7 are two consumer
// warpgroups of 64 rows each, warp 8 the producer (warps 8-11 at d 256,
// see below). The producer's one thread loads the block's Q once and then
// K and V of each kv tile with TMA into a two-stage ring, each stage with
// a full barrier for K, one for V and an empty barrier the two consumers
// arrive on once they are done with it, so the next tile's loads run
// while this one is multiplied. A
// consumer runs S = Q K^T as wgmma with both operands in shared memory, the
// online softmax on S in registers, and O += P V as wgmma with P from
// registers (S's accumulator layout is P's A fragment, as in the mma.sync
// route) and V MN-major from shared memory.
//
// The tensor maps are 4-D over (d, heads, S, B) with boxes of (64, 1, rows,
// 1) into 128-byte swizzled rows: the row stride H d (or KV d) is the
// tensor's own, and rows past Sq or Skv are zero-filled within the batch,
// never read from batch b + 1. The output is written from the accumulator
// registers by each thread, rows >= Sq skipped, so no store crosses into
// the next batch either. Blocks run longest causal row range first (grid
// y reversed, all heads of one query tile together).
//
// Per head dim (Layout: kDP the width in shared memory, kBK keys a tile):
//  - d 64 and 128: kDP = d, kBK = 128; S is m64n128k16, PV m64nDk16.
//  - d 112 (zamba2's shared block): kDP = 128. The maps keep d = 112 as
//    their innermost extent, so the second 64-column box brings columns
//    64..111 and zero-fills 112..127; TMA bounds each dimension on its
//    own, so the pad is never the next head's first columns, and counts
//    the zero-filled bytes toward the barrier's transactions. The tiles and
//    products are then d 128's; QK^T skips its eighth k-step (columns
//    112..127, all zeros), PV computes 16 zero columns, which the epilogue
//    does not store.
//  - d 256 (gemma): kBK = 64, so Q (64 KB) and the two-stage ring of K and
//    V tiles (4 x 32 KB) fit in 227 KB (197,696 bytes with the barriers
//    and the alignment slack); S is m64n64k16 over 16 k-steps, PV one
//    m64n256k16 per 16 keys into O's 128 float registers. The producer is
//    a whole warpgroup here (warps 8-11, one thread issuing), so that
//    setmaxnreg can move registers between warpgroups: ptxas starts every
//    thread at 168 (65,536 / 384) and the consumers take 232 from the
//    producer's 168 - 40 (8 x 64 = 4 x 128 more a lane). At kBK 64
//    the block's last causal tile lies wholly past warpgroup 0's rows, so
//    that warpgroup stops one tile early (the producer never waits for its
//    last stage).
namespace wg {

constexpr int kBQ = 128;           // query rows per block
constexpr int kStages = 2;
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kChunk = 64;         // bf16 columns of one 128-byte row
constexpr int kRowBytes = 128;

template <int D>
struct Layout {
  static constexpr int kDP = (D + kChunk - 1) / kChunk * kChunk;
  static constexpr int kBK = D > 128 ? 64 : 128;  // keys per kv tile
  static constexpr bool kMoveRegs = D > 128;      // setmaxnreg
  // a producer warp, or a producer warpgroup that gives up its registers
  static constexpr int kThreads = kConsumers + (kMoveRegs ? 128 : 32);
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kKVBytes = kBK * kDP * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + barriers and the slack to align the base to 1024 bytes
  static constexpr int kBytes = kBarOffset + 64 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// S (+)= Q K^T for one 16-column k-step over a tile of BK keys
template <int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint64_t desc_q,
                                   uint64_t desc_k, int scale_d) {
  if constexpr (BK == 128) {
    hopper::wgmma_ss_m64n128k16(s, desc_q, desc_k, scale_d);
  } else {
    hopper::wgmma_ss_m64n64k16(s, desc_q, desc_k, scale_d);
  }
}

// O += P V for one 16-key k-step over DP columns
template <int DP>
__device__ __forceinline__ void pv(float (&acc)[DP / 2],
                                   const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (DP == 256) {
    hopper::wgmma_rs_m64n256k16(acc, a, desc, 1);
  } else if constexpr (DP == 128) {
    hopper::wgmma_rs_m64n128k16(acc, a, desc, 1);
  } else {
    hopper::wgmma_rs_m64n64k16(acc, a, desc, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   bf16* __restrict__ o, int n_heads, int n_kv_heads, int sq,
                   int kv_len, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int kDP = L::kDP, kBK = L::kBK;
  constexpr int kChunks = kDP / kChunk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;                        // [chunk][kBQ][128 B]
  unsigned char* ks = qs + L::kQBytes;             // [stage][chunk][kBK][128 B]
  unsigned char* vs = ks + kStages * L::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  // the longest causal blocks start first, so the short ones fill the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int kv_hi = kv_len;
  if (causal) kv_hi = min(kv_hi, min(q0 + kBQ, sq));
  const int n_tiles = (kv_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 2);       // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // the producer
    if constexpr (L::kMoveRegs) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      hopper::mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(qs + c * kBQ * kRowBytes, &q_map, q_full,
                            c * kChunk, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(empty + s, (t / kStages - 1) & 1);
        unsigned char* kt = ks + s * L::kKVBytes;
        unsigned char* vt = vs + s * L::kKVBytes;
        hopper::mbar_expect_tx(k_full + s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(kt + c * kBK * kRowBytes, &k_map, k_full + s,
                              c * kChunk, kvh, t * kBK, b);
        }
        hopper::mbar_expect_tx(v_full + s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(vt + c * kBK * kRowBytes, &v_map, v_full + s,
                              c * kChunk, kvh, t * kBK, b);
        }
      }
    }
    return;
  }
  if constexpr (L::kMoveRegs) hopper::setmaxnreg_inc<232>();

  const int wgi = threadIdx.x / 128;          // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r_min = q0 + wgi * 64;            // the warpgroup's first row
  const int row = r_min + (tid >> 5) * 16 + g;  // and rows row, row + 8
  const uint32_t q_addr = hopper::smem_u32(qs) + wgi * 64 * kRowBytes;
  // the warpgroup's tiles: under the causal mask none past its last row
  const int wg_hi = causal ? min(kv_hi, r_min + 64) : kv_hi;
  const int n_mine = (wg_hi + kBK - 1) / kBK;

  float acc[kDP / 2];                         // O, m64nDP accumulator
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  if (n_mine > 0) hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_mine; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = t * kBK;

    // S = Q K^T (m64n kBK, one k-step per 16 of the D true columns)
    float sc[kBK / 2];
    hopper::mbar_wait(k_full + s, parity);
    const uint32_t k_addr = hopper::smem_u32(ks + s * L::kKVBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
      qk<kBK>(sc, hopper::desc_sw128(q_addr + off, 16, 1024),
              hopper::desc_sw128(k_addr + koff, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);

    // masks only where the tile crosses the diagonal or kv_len
    const bool masked = (causal && k0 + kBK - 1 > r_min) || k0 + kBK > kv_len;
    if (masked) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          const int qp = row + 8 * (e >> 1);
          if (kp >= kv_len || (causal && kp > qp)) sc[4 * j + e] = kNegInf;
        }
    }

    // online softmax in the log2 domain: p = 2^(s scale log2(e) - m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {             // rows row and row + 8
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          float& x = sc[4 * j + e];
          const float p = exp2f(fmaf(x, scale_log2, -m_new));
          x = (masked && x == kNegInf) ? 0.0f : p;
          rs += x;
        }
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDP / 8; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }

    // P in bf16 as the A fragments of PV's 16-key steps
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V (m64n kDP, kBK / 16 k-steps of 16 keys; V MN-major, its
    // 64-column chunks kBK rows apart)
    hopper::mbar_wait(v_full + s, parity);
    const uint32_t v_addr = hopper::smem_u32(vs + s * L::kKVBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pv<kDP>(acc, pa[kk], hopper::desc_sw128(v_addr + kk * 16 * kRowBytes,
                                              kBK * kRowBytes, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) hopper::fence_operands(pa[kk]);
    if (tid == 0) hopper::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qr = row + 8 * i;
    if (qr < sq) {
      const float den = fmaxf(li, 1e-20f);
      bf16* orow = o + ((static_cast<int64_t>(b) * sq + qr) * n_heads + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {       // the D true columns
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
            pack(acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int kv, int sq, int skv, int kv_len,
                   int causal, cudaStream_t stream) {
  using L = Layout<D>;
  // innermost extent D, the true head dim: columns D..kDP-1 arrive as 0
  CUtensorMap qm, km, vm;
  cudaError_t err = hopper::map_bf16_4d(&qm, q, D, h, sq, b, kBQ);
  if (err == cudaSuccess) err = hopper::map_bf16_4d(&km, k, D, kv, skv, b, L::kBK);
  if (err == cudaSuccess) err = hopper::map_bf16_4d(&vm, v, D, kv, skv, b, L::kBK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_wgmma_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), h, kv, sq, kv_len, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace wg

// one launch of the kernel for the pointers' type
template <int D>
cudaError_t start(dim3 grid, cudaStream_t st, const float* q, const float* k,
                  const float* v, float* o, int h, int kv, int sq, int skv,
                  int kv_len, int causal, float scale) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_f32<D>());
  if (err != cudaSuccess) return err;
  flash_f32_kernel<D><<<grid, kThreads, smem_f32<D>(), st>>>(
      q, k, v, o, h, kv, sq, skv, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t start(dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
                  const bf16* v, bf16* o, int h, int kv, int sq, int skv,
                  int kv_len, int causal, float scale) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bf16<D>());
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<D><<<grid, kThreads, smem_bf16<D>(), st>>>(
      q, k, v, o, h, kv, sq, skv, kv_len, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int kv, int sq, int skv, int kv_len,
                   int causal, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  return start<D>(grid, stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), h, kv, sq, skv, kv_len, causal, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int h, int kv, int sq, int skv, int d, int kv_len, int causal,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv <= 0 || h % kv) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, bf16>) {     // by d: wgmma, or mma.sync
    switch (d) {
      case 64: return static_cast<int>(wg::launch<64>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 112: return static_cast<int>(wg::launch<112>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 128: return static_cast<int>(wg::launch<128>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 256: return static_cast<int>(wg::launch<256>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      default: break;
    }
    if (b * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16: return static_cast<int>(launch<T, 16>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 32: return static_cast<int>(launch<T, 32>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (b * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16: return static_cast<int>(launch<T, 16>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 32: return static_cast<int>(launch<T, 32>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 64: return static_cast<int>(launch<T, 64>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 112: return static_cast<int>(launch<T, 112>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 128: return static_cast<int>(launch<T, 128>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      case 256: return static_cast<int>(launch<T, 256>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace

// q, o [B, Sq, H, d]; k, v [B, Skv, KV, d]; all float32, contiguous;
// d in {16, 32, 64, 112, 128, 256}; keys j >= kv_len are masked (kv_len <= Skv).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int b, int h, int kv, int sq,
                                   int skv, int d, int kv_len, int causal,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, b, h, kv, sq, skv, d, kv_len, causal,
                         stream);
}

// The same for bfloat16 (tensor-core products, float32 accumulation and
// softmax, P rounded to bfloat16).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int h,
                                    int kv, int sq, int skv, int d,
                                    int kv_len, int causal, void* stream) {
  return dispatch<bf16>(q, k, v, o, b, h, kv, sq, skv, d, kv_len, causal,
                        stream);
}
