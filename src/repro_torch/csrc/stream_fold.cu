// Streaming leak-fold kernels for Hopper (sm_90a), plain C interface for
// ctypes (see src/repro_torch/kernels/stream_fold/stream_fold.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/stream_fold/stream_fold.py:
//   stream_fold_f32      <- stream_fold_pallas     (body _fold_kernel)
//   stream_fold_mac_f32  <- stream_fold_mac_pallas (body _fold_mac_kernel)
//
// Both advance every lane's charge through the S fine sub-slots of one
// replay chunk, x <- x*a[f] + deposit[s], keeping the carry in a register
// so only the final state is written. On the TPU the grid ran in order over
// N tiles with the S loop inside; here every thread owns its elements and
// loops over S itself, so blocks are independent and need no ordering.
//
// stream_fold has two routes, chosen by shape (src/repro_torch/kernels/
// stream_fold/stream_fold.py, fold_route), never after a failure:
//   vector (stream_fold_x4_kernel) when F % 4 == 0 and x0, deposits, a
//     and out start 16-byte aligned: each thread folds four consecutive
//     floats of one row with 16-byte loads and stores, reads a[f..f+3] as
//     one float4, and issues the deposit loads of up to 8 sub-slots before
//     it folds them; x0, deposits and out move with streaming cache hints
//     (__ldcs/__stcs: every byte is touched once);
//   scalar (stream_fold_kernel) otherwise: one float per thread.
//
// Bound (both are memory-bound: a handful of flops per byte, far below the
// H100's ~20 fp32 flops/byte balance point):
//   stream_fold      HBM bytes (S+2)*N*F*4        (read x0, deposits; write out)
//   stream_fold_mac  HBM bytes (S*K + 2F)*N*4 + K*F*4
// The design reads every input byte from device memory once: x0 and the
// deposits/patches stream through with neighbouring threads on neighbouring
// addresses, a and w sit in registers/shared memory, and the carry never
// leaves the register file between sub-slots. The scalar fold reached 70 %
// of its bound at the serving shape (S 1, N 262,144, F 16): 4-byte
// accesses, a 64-bit modulo per element and one deposit load in flight per
// thread; the vector route does a quarter of the memory instructions and
// keeps S loads in flight.
//
// Numerics: stream_fold must be bit-exact with the plain PyTorch fold
// (eager x * a + dep, two separately rounded ops), so both routes use
// __fmul_rn and __fadd_rn, which nvcc never contracts into an FMA.
// stream_fold_mac sums the K-term dot product with FMAs in another order
// than the plain matmul (held to 1e-5 abs); its fold step rounds like the
// plain fold, so where the dot product is exact — event counts times
// quantized weights, as in serving — it agrees with deposit mode bit for
// bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void stream_fold_kernel(const float* __restrict__ x0,
                                   const float* __restrict__ dep,
                                   const float* __restrict__ a,
                                   float* __restrict__ out,
                                   int64_t nf, int f_dim, int s_dim) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nf) return;
  const float af = a[i % f_dim];
  float x = x0[i];
  for (int s = 0; s < s_dim; ++s) {
    x = __fadd_rn(__fmul_rn(x, af), dep[static_cast<int64_t>(s) * nf + i]);
  }
  out[i] = x;
}

constexpr int kLoadBatch = 8;     // deposit loads in flight per thread

__device__ __forceinline__ float4 fold4(float4 x, float4 a, float4 d) {
  return make_float4(__fadd_rn(__fmul_rn(x.x, a.x), d.x),
                     __fadd_rn(__fmul_rn(x.y, a.y), d.y),
                     __fadd_rn(__fmul_rn(x.z, a.z), d.z),
                     __fadd_rn(__fmul_rn(x.w, a.w), d.w));
}

// x0, out [N F / 4] and dep [S][N F / 4] as float4; a [F / 4] as float4
__global__ void stream_fold_x4_kernel(const float4* __restrict__ x0,
                                      const float4* __restrict__ dep,
                                      const float4* __restrict__ a,
                                      float4* __restrict__ out, int64_t nv,
                                      unsigned f4, int s_dim) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  // i mod f4 in 32-bit arithmetic: i = blockIdx.x * blockDim.x + threadIdx.x
  const unsigned f = ((blockIdx.x % f4) * (blockDim.x % f4) + threadIdx.x) % f4;
  const float4 af = __ldg(a + f);
  float4 x = __ldcs(x0 + i);
  for (int s0 = 0; s0 < s_dim; s0 += kLoadBatch) {
    float4 d[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      if (s0 + j < s_dim) d[j] = __ldcs(dep + static_cast<int64_t>(s0 + j) * nv + i);
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      if (s0 + j < s_dim) x = fold4(x, af, d[j]);
    }
  }
  __stcs(out + i, x);
}

// shared memory: w [K, F] row-major, then a [F]
__global__ void stream_fold_mac_kernel(const float* __restrict__ x0,
                                       const float* __restrict__ patches,
                                       const float* __restrict__ w,
                                       const float* __restrict__ a,
                                       float* __restrict__ out,
                                       int64_t n_dim, int k_dim, int f_dim,
                                       int s_dim, float dv_unit) {
  extern __shared__ float smem[];
  const int kf = k_dim * f_dim;
  for (int j = threadIdx.x; j < kf; j += blockDim.x) smem[j] = w[j];
  for (int j = threadIdx.x; j < f_dim; j += blockDim.x) smem[kf + j] = a[j];
  __syncthreads();
  const int64_t nf = n_dim * f_dim;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nf) return;
  const int64_t n = i / f_dim;
  const int f = static_cast<int>(i - n * f_dim);
  const float af = smem[kf + f];
  float x = x0[i];
  for (int s = 0; s < s_dim; ++s) {
    const float* p = patches + (static_cast<int64_t>(s) * n_dim + n) * k_dim;
    float acc = 0.0f;
    for (int k = 0; k < k_dim; ++k) acc = fmaf(p[k], smem[k * f_dim + f], acc);
    x = __fadd_rn(__fmul_rn(x, af), __fmul_rn(acc, dv_unit));
  }
  out[i] = x;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// x0 [N, F], dep [S, N, F], a [F] -> out [N, F]; all float32, contiguous;
// the scalar route. Returns the cudaError_t of the launch (0 = launched).
extern "C" int stream_fold_f32(const float* x0, const float* dep,
                               const float* a, float* out, long long n,
                               int f, int s, void* stream) {
  const int64_t nf = static_cast<int64_t>(n) * f;
  stream_fold_kernel<<<blocks_for(nf), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x0, dep, a, out,
                                                            nf, f, s);
  return static_cast<int>(cudaGetLastError());
}

// The vector route of stream_fold_f32: F % 4 == 0 and every pointer 16-byte
// aligned, else cudaErrorInvalidValue (nothing is launched).
extern "C" int stream_fold_x4_f32(const float* x0, const float* dep,
                                  const float* a, float* out, long long n,
                                  int f, int s, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (f % 4 || !aligned(x0) || !aligned(dep) || !aligned(a) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nv = static_cast<int64_t>(n) * (f / 4);
  stream_fold_x4_kernel<<<blocks_for(nv), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x0), reinterpret_cast<const float4*>(dep),
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(out), nv,
      f / 4, s);
  return static_cast<int>(cudaGetLastError());
}

// x0 [N, F], patches [S, N, K], w [K, F], a [F] -> out [N, F]; float32,
// contiguous. (K*F + F)*4 bytes of shared memory, at most 48 KB.
extern "C" int stream_fold_mac_f32(const float* x0, const float* patches,
                                   const float* w, const float* a, float* out,
                                   long long n, int k, int f, int s,
                                   float dv_unit, void* stream) {
  const int64_t nf = static_cast<int64_t>(n) * f;
  const size_t shmem = static_cast<size_t>(k * f + f) * sizeof(float);
  stream_fold_mac_kernel<<<blocks_for(nf), kThreads, shmem,
                           static_cast<cudaStream_t>(stream)>>>(
      x0, patches, w, a, out, n, k, f, s, dv_unit);
  return static_cast<int>(cudaGetLastError());
}
