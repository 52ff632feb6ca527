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
// once) at a handful of flops per element. Each thread owns one column
// (or, where N is large enough, the 4 float32 / 8 bfloat16 columns of one
// 16-byte load) and keeps the membrane in registers across the T loop, so
// v never touches device memory; neighbouring threads read neighbouring
// addresses at every t, and each thread issues the loads of 8 steps at a
// time, since at small N the few threads would otherwise wait out one
// memory latency per step. The TPU kernel kept the membrane tile in VMEM
// over an N-tile grid; here the columns are independent threads and need
// no grid order.
//
// Numerics: bit-exact with the plain eager version (kernels/lif/ref.py).
// Every op is a separately rounded __fsub_rn/__fdiv_rn/__fadd_rn/__fmul_rn
// (no FMA contraction, and a true division by tau, never a reciprocal
// multiply). In bfloat16 each op is computed in float32 and rounded to
// bfloat16, as PyTorch's eager bfloat16 ops are. tau and v_th arrive
// already rounded to the working type by the wrapper.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;

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

// round a float32 result to the working type and back
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__global__ void lif_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int64_t groups, int t_dim, float tau, float v_th,
                           int soft_reset) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x);
  Pack<T, V>* op = reinterpret_cast<Pack<T, V>*>(out);
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
  // kChunk time steps' loads are issued together, so a thread waits for
  // device memory once per chunk rather than once per step
  for (int t0 = 0; t0 < t_dim; t0 += kChunk) {
    Pack<T, V> in[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < t_dim) in[c] = xp[static_cast<int64_t>(t0 + c) * groups + g];
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c >= t_dim) break;
      Pack<T, V> res;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = rnd<T>(__fsub_rn(to_f<T>(in[c].x[i]), v[i]));
        v[i] = rnd<T>(__fadd_rn(v[i], rnd<T>(__fdiv_rn(d, tau))));
        const float s = v[i] > v_th ? 1.0f : 0.0f;
        if (soft_reset) {
          v[i] = rnd<T>(__fsub_rn(v[i], rnd<T>(__fmul_rn(s, v_th))));
        } else {
          v[i] = rnd<T>(__fmul_rn(v[i], rnd<T>(__fsub_rn(1.0f, s))));
        }
        res.x[i] = from_f<T>(s);
      }
      op[static_cast<int64_t>(t0 + c) * groups + g] = res;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* out, long long t, long long n,
                   float tau, float v_th, int soft_reset, cudaStream_t s) {
  const int64_t groups = n / V;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  lif_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), groups,
      static_cast<int>(t), tau, v_th, soft_reset);
  return cudaGetLastError();
}

}  // namespace

// x, out [T, N] float32, contiguous. vec = 4 reads 4 columns per thread
// with 16-byte loads (N % 4 == 0 and x 16-byte aligned), vec = 1 one.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int lif_f32(const void* x, void* out, long long t, long long n,
                       float tau, float v_th, int soft_reset, int vec,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return static_cast<int>(launch<float, 4>(x, out, t, n, tau, v_th, soft_reset, s));
  if (vec == 1) return static_cast<int>(launch<float, 1>(x, out, t, n, tau, v_th, soft_reset, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for bfloat16; vec = 8 (16-byte loads) or 1.
extern "C" int lif_bf16(const void* x, void* out, long long t, long long n,
                        float tau, float v_th, int soft_reset, int vec,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) return static_cast<int>(launch<__nv_bfloat16, 8>(x, out, t, n, tau, v_th, soft_reset, s));
  if (vec == 1) return static_cast<int>(launch<__nv_bfloat16, 1>(x, out, t, n, tau, v_th, soft_reset, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
