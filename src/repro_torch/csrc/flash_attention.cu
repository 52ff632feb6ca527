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
// Both kernels run one block per (64 query rows, b * H + h), 4 warps of 16
// rows each. A block walks the kv tiles of 64 keys in order up to the
// causal limit of its last row (tiles masked for every row are never
// loaded, as the TPU kernel clamped its kv extent), keeping the
// online-softmax state m, l and the output accumulator in float32
// registers. Scores are masked with a finite NEG_INF (-1e30, as the TPU
// kernel) and p is zeroed on masked keys, so a row whose keys are all
// masked ends as 0 / max(0, 1e-20) = 0. Sq and Skv are padded to the tile
// by bounds checks, never by copies. exp is expf, not __expf; p is rounded
// to V's type before the PV product while l sums the unrounded p (the TPU
// kernel and nn/layers.attention_core do the same); out = acc / max(l,
// 1e-20), rounded to the input type.
//
// float32 (flash_f32_kernel): FMA loops on the CUDA cores, never TF32, so
// a float32 input keeps float32 accuracy. Each lane owns 4 rows x 8 keys
// of a score tile and 4 rows x d/8 output columns; a row's running max
// and sum live in the 8 lanes that share it. Q stays in shared memory; one
// kv buffer holds a tile's K, then its V; P goes through shared memory.
//
// bfloat16 (flash_bf16_kernel): both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, float32 accumulate). Each warp keeps its 16
// rows of Q as A fragments in registers for the whole walk; S = Q K^T
// lands in C fragments (a thread holds rows g and g + 8, g = lane / 4, and
// 2 keys of every 8), whose layout is that of the A fragment of P for the
// PV product, so P never leaves the registers. K and V are staged
// row-major in bf16; a B fragment of K is two 32-bit shared loads, one of
// V one ldmatrix.trans.
//
// Bound: operations. Causal at B*H = 16, S = 2048, d = 128 the work is
// ~17 GFLOP against ~34 MB of q, k, v and o in bfloat16: tensor-core work
// (989 TFLOP/s bf16 dense). In float32 the CUDA cores' 67 TFLOP/s bound it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  constexpr int NB = N < 8 ? N : 8;
  static_assert(N * kThreads == kBQ * PER_ROW, "tile splits evenly");
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
  uint32_t qa[KS][4];
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
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kq = 0; kq < KS; ++kq) {
        const bf16* p = ks + (nt * 8 + g) * LQ + kq * 16 + 2 * t;
        mma(s[nt], qa[kq], ld32(p), ld32(p + 8));
      }
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
  if (b * h > 65535 || kv <= 0 || h % kv) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return static_cast<int>(launch<T, 16>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
    case 32: return static_cast<int>(launch<T, 32>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
    case 64: return static_cast<int>(launch<T, 64>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
    case 128: return static_cast<int>(launch<T, 128>(q, k, v, o, b, h, kv, sq, skv, kv_len, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o [B, Sq, H, d]; k, v [B, Skv, KV, d]; all float32, contiguous;
// d in {16, 32, 64, 128}; keys j >= kv_len are masked (kv_len <= Skv).
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
