// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), plain C
// interface for ctypes (see src/repro_torch/kernels/ssd/ssd.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd/ssd.py:
//   ssd_f32, ssd_bf16  <-  ssd_pallas (body _ssd_kernel)
//
// For one (batch b, head h) and chunks of L steps, with a = dt * A,
// a_cs its cumulative sum over the chunk, and the state [p, n] carried
// from chunk to chunk (zero at the start):
//   G     = C B^T                                   [L, L]
//   W     = G * exp(a_cs[i] - a_cs[j]) * dt[j]  for i >= j, else 0
//   y     = W x + exp(a_cs) * (C state^T)           [L, p]
//   state = exp(a_cs[L-1]) * state + x^T (B * dt * exp(a_cs[L-1] - a_cs))
// x, y [b, s, h, p], dt [b, s, h], A [h], B, C [b, s, g, n], state
// [b, h, p, n] float32; head h reads B/C of group h / (h_total / g) (the
// reference's bc_map), so grouped B/C are never expanded per head. Steps
// past s are read as dt = 0 (decay 1, no state contribution; the TPU
// wrapper padded with zeros), by bounds checks rather than copies.
//
// One block of 256 threads per (b, h) walks the chunks in order (on the
// TPU the chunk axis was the sequential grid dimension). The state lives
// in shared memory for the whole walk; each chunk stages x, B, C and dt
// (widened to float32), scans a = dt * A in one warp, then:
//   y_inter  each thread owns (L/16) rows x (p/16) columns of y;
//   y_intra  G and W in 64 x 64 blocks (only the blocks on or below the
//            diagonal), W through shared memory into the same y registers;
//   state    each thread updates (p/16) x (n/16) state entries.
// Shared memory is the constraint at L 128, n 128, p 64: x, B, C and the
// state in float32 with padded rows (216 KB) fit the 227 KB a block may
// use only because W is staged one 64 x 64 block at a time (16 KB), never
// as the whole [L, L] (64 KB). B and C stay float32 (a float32 model keeps
// float32 accuracy). At batch-1 prefill, b * h blocks (48 for mamba2-780m)
// are less than one wave on 132 SMs; a split over chunks is left to a
// later version.
//
// Numerics: all arithmetic in float32 with FMAs (no tensor cores, no TF32);
// exp is expf. y is written in x's type.
//
// Bound: operations. Per chunk ~(L^2 (n + p) / 2 + 2 L n p) FMAs (the
// lower triangles of G and W only), 5.7 GFLOP for the mamba2-780m prefill
// (b 1, s 2048, h 48, p 64, n 128) against ~28 MB of inputs and outputs,
// far above the card's ~20 fp32 flops per byte.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 thread grid
constexpr int kMaxN = 128;         // largest state size n
constexpr int kSmemLimit = 232448; // bytes a block may use on the H100

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// floats of shared memory for chunk L, head dim P and state size n
__host__ __device__ constexpr int smem_floats(int L, int P, int n) {
  return L * (P + 1) + 2 * L * (n + 1) + P * (n + 1)
         + (L < 64 ? L : 64) * ((L < 64 ? L : 64) + 1) + 3 * L;
}

// the largest shape the wrappers accept (chunk 128, p 64, n 128) fits
static_assert(smem_floats(128, 64, kMaxN) * 4 <= kSmemLimit,
              "shared memory of the largest chunk");

template <typename T, int L, int P>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, int n_heads, int n_groups, int s,
           int n) {
  constexpr int BL = L < 64 ? L : 64;   // G/W block
  constexpr int NB = L / BL;            // blocks per chunk side
  constexpr int RB = BL / 16;           // rows (and cols) per thread in a block
  constexpr int CP = P / 16;            // y columns / state rows per thread
  constexpr int NK = kMaxN / 16;        // state columns per thread, at most
  constexpr int E = (L + 31) / 32;      // scan elements per lane
  constexpr int LX = P + 1;
  const int LN = n + 1;

  extern __shared__ float smem[];
  float* xs = smem;                     // [L][LX]
  float* bs = xs + L * LX;              // [L][LN]
  float* cs = bs + L * LN;              // [L][LN]
  float* st = cs + L * LN;              // [P][LN], the carried state
  float* ws = st + P * LN;              // [BL][BL + 1]
  float* dts = ws + BL * (BL + 1);      // [L]
  float* acs = dts + L;                 // [L] cumulative a
  float* wl = acs + L;                  // [L] dt * exp(a_cs[L-1] - a_cs)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int grp = h / (n_heads / n_groups);
  const float a_h = A[h];
  const int64_t x_row = static_cast<int64_t>(n_heads) * P;   // x/y step stride
  const int64_t bc_row = static_cast<int64_t>(n_groups) * n;
  const T* xb = x + (static_cast<int64_t>(b) * s * n_heads + h) * P;
  T* yb = y + (static_cast<int64_t>(b) * s * n_heads + h) * P;
  const float* dtb = dt + static_cast<int64_t>(b) * s * n_heads + h;
  const T* bb = Bm + (static_cast<int64_t>(b) * s * n_groups + grp) * n;
  const T* cb = Cm + (static_cast<int64_t>(b) * s * n_groups + grp) * n;

  for (int i = tid; i < P * LN; i += kThreads) st[i] = 0.0f;

  const int n_chunks = (s + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * L;
    __syncthreads();                  // the last chunk is no longer read
    for (int i = tid; i < L * P; i += kThreads) {
      const int r = i / P, c = i % P;
      xs[r * LX + c] = c0 + r < s
          ? to_f<T>(xb[static_cast<int64_t>(c0 + r) * x_row + c]) : 0.0f;
    }
    for (int i = tid; i < L * n; i += kThreads) {
      const int r = i / n, c = i % n;
      const bool in = c0 + r < s;
      const int64_t off = static_cast<int64_t>(c0 + r) * bc_row + c;
      bs[r * LN + c] = in ? to_f<T>(bb[off]) : 0.0f;
      cs[r * LN + c] = in ? to_f<T>(cb[off]) : 0.0f;
    }
    for (int r = tid; r < L; r += kThreads) {
      dts[r] = c0 + r < s ? dtb[static_cast<int64_t>(c0 + r) * n_heads] : 0.0f;
    }
    __syncthreads();

    // a_cs: inclusive scan of dt * A over the chunk, in warp 0
    if (warp == 0) {
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
      __syncwarp();
      const float last = acs[L - 1];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane * E + e;
        if (r < L) wl[r] = dts[r] * expf(last - acs[r]);
      }
    }
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
        __syncthreads();              // the last W block is no longer read
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
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int ii = 0; ii < RB; ++ii) {
        const int r = bi * BL + tr * RB + ii;
        if (c0 + r < s) {
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            yb[static_cast<int64_t>(c0 + r) * x_row + tc + 16 * cc] =
                from_f<T>(yacc[bi][ii][cc]);
        }
      }

    // state <- exp(a_cs[L-1]) * state + x^T (B * wl); the thread owns
    // state rows tr + 16 * qq and columns tc + 16 * kk. Every read of the
    // old state (y_inter) is behind the barriers of the W blocks above.
    const float dec = expf(acs[L - 1]);
    float sn[CP][NK];
#pragma unroll
    for (int qq = 0; qq < CP; ++qq)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int c = tc + 16 * kk;
        sn[qq][kk] = c < n ? st[(tr + 16 * qq) * LN + c] * dec : 0.0f;
      }
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
#pragma unroll
    for (int qq = 0; qq < CP; ++qq)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int c = tc + 16 * kk;
        if (c < n) st[(tr + 16 * qq) * LN + c] = sn[qq][kk];
      }
  }
  __syncthreads();
  float* so = state_out + static_cast<int64_t>(bh) * P * n;
  for (int i = tid; i < P * n; i += kThreads) so[i] = st[(i / n) * LN + i % n];
}

template <typename T, int L, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int b, int s, int h, int g, int n, cudaStream_t stream) {
  const int bytes = smem_floats(L, P, n) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, L, P><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), h, g, s, n);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t by_p(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int b, int s, int h,
                 int p, int g, int n, cudaStream_t st) {
  switch (p) {
    case 16: return launch<T, L, 16>(x, dt, A, Bm, Cm, y, state, b, s, h, g, n, st);
    case 32: return launch<T, L, 32>(x, dt, A, Bm, Cm, y, state, b, s, h, g, n, st);
    case 64: return launch<T, L, 64>(x, dt, A, Bm, Cm, y, state, b, s, h, g, n, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, int b, int s, int h, int p,
             int g, int n, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g <= 0 || h % g || n <= 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (chunk) {
    case 16: return static_cast<int>(by_p<T, 16>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n, st));
    case 32: return static_cast<int>(by_p<T, 32>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n, st));
    case 64: return static_cast<int>(by_p<T, 64>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n, st));
    case 128: return static_cast<int>(by_p<T, 128>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y [b, s, h, p] and B, C [b, s, g, n] float32; dt [b, s, h] and A [h]
// float32; state [b, h, p, n] float32; all contiguous. p in {16, 32, 64},
// n <= 128, chunk in {16, 32, 64, 128}, h % g == 0. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int ssd_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       int b, int s, int h, int p, int g, int n, int chunk,
                       void* stream) {
  return dispatch<float>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n, chunk,
                         stream);
}

// The same with x, y, B, C in bfloat16 (float32 arithmetic and state).
extern "C" int ssd_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        int b, int s, int h, int p, int g, int n, int chunk,
                        void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, b, s, h, p, g, n,
                                 chunk, stream);
}
