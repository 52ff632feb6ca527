// LIF neuron scan over time for Hopper (sm_90a), plain C interface for
// ctypes (see src/repro_torch/kernels/lif/lif.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/lif/lif.py:
//   lif_f32, lif_bf16  <-  lif_pallas (body _lif_kernel)
//
// For every column n of x [T, N], starting from v = 0:
//   v <- v + (x[t, n] - v) / tau;  s = v > v_th;
//   v <- v - s * v_th (soft reset)  or  v * (1 - s) (hard reset).
//
// Bound: bytes, 2 * T * N * sizeof(type) (x read once, spikes written
// once) at a handful of operations per element. At the main path's
// shape (T 4, N 524,288) one launch moves 8-17 MB, which a plain device
// copy of the same bytes (x.clone()) does not move in under ~2x that
// bound on the H100 either; the kernel aims at copy speed.
//
// Design: a thread owns one lane of B bytes of a row (16, 8 or 4: 4 to 1
// float32 columns, 8 to 2 bfloat16), the widest lane that keeps at least
// 65,536 threads busy (few columns spread over more threads in narrower
// lanes) and that the row layout allows; the membranes stay in
// registers. The thread walks time in chunks of D steps, double-buffered:
// the streaming loads (ld.global.cs) of the next chunk are issued before
// the current chunk is scanned, and each step's spikes leave as one
// streaming store (st.global.cs), so loads and stores overlap. A row not
// on 4 bytes (bfloat16 with N odd, or a view 2 bytes off) takes one
// column a thread, the loads of 8 steps issued together. Tried on the
// card and not kept: persistent blocks staging [8 rows, tile] items
// through a shared-memory ring by cp.async.bulk on mbarriers, slower than
// these lanes at every shape timed (PERF.md, section 6).
//
// Numerics: bit-exact with the plain eager version (kernels/lif/ref.py).
// float32: every op a separately rounded __fsub_rn/__fadd_rn/__fmul_rn
// (no FMA contraction). The division by tau: where tau is a power of two
// the wrapper passes qmode 0 and the kernel multiplies by 1/tau, which
// rounds the same real number d * 2^-k as the division does, so the two
// are bit-identical (subnormal results included); otherwise Markstein's
// correction step with r = RN(1/tau) (qmode 1), exact unless the remainder
// underflows or the product overflows, so |d| outside [2^-100, 2^100)
// (and any non-finite d) takes __fdiv_rn; qmode 2 is __fdiv_rn alone (tau
// outside [2^-20, 2^20] or not positive). bfloat16: PyTorch computes each
// eager op in float32 and rounds to bfloat16; float32 has 24 bits against
// bfloat16's 8, at least 2 * 8 + 2, so that double rounding equals one
// rounding of the exact result, which the native bf16x2 instructions
// (add.rn/sub.rn/mul.rn.bf16x2, two columns an instruction) compute
// directly; the comparison is set.gt.bf16x2 (1.0 / 0.0). A quotient by a
// tau that is not a power of two is taken in float32 (as above) and
// rounded, as eager does. tau and v_th arrive already rounded to the
// working type by the wrapper.
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kElementChunk = 8;   // steps whose loads go out together

struct Consts {
  float tau, inv_tau, recip, v_th;
  int qmode;   // 0: d * inv_tau, 1: Markstein's step, 2: __fdiv_rn
  int soft;
};

// d / tau, correctly rounded in float32 (see the note at the top)
__device__ __forceinline__ float quotient(float d, const Consts& c) {
  if (c.qmode == 0) return __fmul_rn(d, c.inv_tau);
  if (c.qmode == 1) {
    const uint32_t a = __float_as_uint(d) & 0x7fffffffu;
    // 0x0d800000 is 2^-100's bit pattern, 0x71800000 2^100's
    if (a == 0u || (a >= 0x0d800000u && a < 0x71800000u)) {
      const float q = __fmul_rn(d, c.recip);
      const float e = __fmaf_rn(-q, c.tau, d);
      return copysignf(__fmaf_rn(e, c.recip, q), d);
    }
  }
  return __fdiv_rn(d, c.tau);
}

// one LIF step of one float32 column; returns the spike
__device__ __forceinline__ float lif_step(float& v, float x,
                                          const Consts& c) {
  v = __fadd_rn(v, quotient(__fsub_rn(x, v), c));
  const float s = v > c.v_th ? 1.0f : 0.0f;
  v = c.soft ? __fsub_rn(v, __fmul_rn(s, c.v_th))
             : __fmul_rn(v, __fsub_rn(1.0f, s));
  return s;
}

// one LIF step of two bfloat16 columns; returns the spikes
__device__ __forceinline__ __nv_bfloat162 lif_step(__nv_bfloat162& v,
                                                   __nv_bfloat162 x,
                                                   const Consts& c) {
  const __nv_bfloat162 vth = __float2bfloat162_rn(c.v_th);
  const __nv_bfloat162 d = __hsub2_rn(x, v);
  const __nv_bfloat162 q =
      c.qmode == 0
          ? __hmul2_rn(d, __float2bfloat162_rn(c.inv_tau))
          : __floats2bfloat162_rn(quotient(__low2float(d), c),
                                  quotient(__high2float(d), c));
  v = __hadd2_rn(v, q);
  const __nv_bfloat162 s = __hgt2(v, vth);
  v = c.soft ? __hsub2_rn(v, __hmul2_rn(s, vth))
             : __hmul2_rn(v, __hsub2_rn(__float2bfloat162_rn(1.0f), s));
  return s;
}

// the register type one step works on: a float32 column, or two bfloat16
template <typename T> struct Lane;
template <> struct Lane<float> { using V = float; };
template <> struct Lane<__nv_bfloat16> { using V = __nv_bfloat162; };

// the raw type of a B-byte lane
template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };

// One B-byte lane of every row (B / 4 step values: float32 columns or
// bfloat16 pairs), D steps a chunk, the next chunk's loads in flight
// while this one is scanned.
template <typename T, int B, int D>
__global__ void __launch_bounds__(kThreads)
lif_lane_kernel(const char* __restrict__ x, char* __restrict__ out,
                long long row_bytes, int t_dim, Consts c) {
  using V = typename Lane<T>::V;
  using R = typename Raw<B>::type;
  constexpr int K = B / 4;
  const long long off =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * B;
  if (off >= row_bytes) return;
  V v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = V{};
  R a[D], b[D];
  auto load = [&](R (&buf)[D], int t0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (t0 + d < t_dim) {
        buf[d] = __ldcs(reinterpret_cast<const R*>(
            x + static_cast<long long>(t0 + d) * row_bytes + off));
      }
    }
  };
  auto scan = [&](const R (&buf)[D], int t0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (t0 + d >= t_dim) break;
      V in[K], s[K];
      memcpy(in, &buf[d], B);
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = lif_step(v[k], in[k], c);
      R o;
      memcpy(&o, s, B);
      __stcs(reinterpret_cast<R*>(
                 out + static_cast<long long>(t0 + d) * row_bytes + off),
             o);
    }
  };
  load(a, 0);
  for (int t0 = 0; t0 < t_dim; t0 += 2 * D) {
    load(b, t0 + D);
    scan(a, t0);
    load(a, t0 + 2 * D);
    scan(b, t0 + D);
  }
}

__device__ __forceinline__ float element_step(float& v, float x,
                                             const Consts& c) {
  return lif_step(v, x, c);
}

// bfloat16 through the pair step, the column in the low half
__device__ __forceinline__ __nv_bfloat16 element_step(__nv_bfloat162& v,
                                                     __nv_bfloat16 x,
                                                     const Consts& c) {
  return __low2bfloat16(lif_step(v, __bfloat162bfloat162(x), c));
}

// one column a thread, for rows that do not start on 4 bytes
template <typename T>
__global__ void lif_element_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, long long n,
                                   int t_dim, Consts c) {
  const long long col =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  typename Lane<T>::V v{};
  for (int t0 = 0; t0 < t_dim; t0 += kElementChunk) {
    T in[kElementChunk];
#pragma unroll
    for (int k = 0; k < kElementChunk; ++k) {
      if (t0 + k < t_dim) in[k] = x[static_cast<long long>(t0 + k) * n + col];
    }
#pragma unroll
    for (int k = 0; k < kElementChunk; ++k) {
      if (t0 + k >= t_dim) break;
      out[static_cast<long long>(t0 + k) * n + col] = element_step(v, in[k], c);
    }
  }
}

template <typename T, int B, int D>
cudaError_t launch_lanes(const void* x, void* out, long long t,
                         long long row_bytes, const Consts& c,
                         cudaStream_t s) {
  const long long threads = row_bytes / B;
  lif_lane_kernel<T, B, D>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, s>>>(static_cast<const char*>(x), static_cast<char*>(out),
                 row_bytes, static_cast<int>(t), c);
  return cudaGetLastError();
}

// lane = 16, 8 or 4 bytes (x and out aligned to it, N * size a multiple
// of it), or sizeof(T) for one column a thread
template <typename T>
cudaError_t launch(const void* x, void* out, long long t, long long n,
                   const Consts& c, int lane, cudaStream_t s) {
  const long long row = n * static_cast<long long>(sizeof(T));
  switch (lane) {
    case 16: return launch_lanes<T, 16, 4>(x, out, t, row, c, s);
    case 8: return launch_lanes<T, 8, 8>(x, out, t, row, c, s);
    case 4: return launch_lanes<T, 4, 8>(x, out, t, row, c, s);
    default: break;
  }
  if (lane != static_cast<int>(sizeof(T))) return cudaErrorInvalidValue;
  lif_element_kernel<T>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         s>>>(static_cast<const T*>(x), static_cast<T*>(out), n,
              static_cast<int>(t), c);
  return cudaGetLastError();
}

}  // namespace

// x, out [T, N] contiguous, float32 (lif_f32) or bfloat16 (lif_bf16).
// tau and v_th already rounded to the type; inv_tau = 1/tau and recip =
// RN(1/tau) in float32; qmode as in the note at the top; lane as in
// launch(). Returns the cudaError_t of the launch (0 = launched).
extern "C" int lif_f32(const void* x, void* out, long long t, long long n,
                       float tau, float inv_tau, float recip, float v_th,
                       int qmode, int soft_reset, int lane, void* stream) {
  const Consts c{tau, inv_tau, recip, v_th, qmode, soft_reset};
  return static_cast<int>(launch<float>(x, out, t, n, c, lane,
                                        static_cast<cudaStream_t>(stream)));
}

extern "C" int lif_bf16(const void* x, void* out, long long t, long long n,
                        float tau, float inv_tau, float recip, float v_th,
                        int qmode, int soft_reset, int lane, void* stream) {
  const Consts c{tau, inv_tau, recip, v_th, qmode, soft_reset};
  return static_cast<int>(launch<__nv_bfloat16>(
      x, out, t, n, c, lane, static_cast<cudaStream_t>(stream)));
}
