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
// N tiles with the S loop inside; here every thread owns one (n, f) element
// and loops over S itself, so blocks are independent and need no ordering.
//
// Bound (both are memory-bound: a handful of flops per byte, far below the
// H100's ~20 fp32 flops/byte balance point):
//   stream_fold      HBM bytes (S+2)*N*F*4        (read x0, deposits; write out)
//   stream_fold_mac  HBM bytes (S*K + 2F)*N*4 + K*F*4
// The design reads every input byte from device memory once: x0 and the
// deposits/patches stream through with neighbouring threads on neighbouring
// addresses, a and w sit in registers/shared memory, and the carry never
// leaves the register file between sub-slots.
//
// Numerics: stream_fold must be bit-exact with the plain PyTorch fold
// (eager x * a + dep, two separately rounded ops), so it uses __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA. stream_fold_mac sums
// the K-term dot product with FMAs in another order than the plain matmul
// (held to 1e-5 abs); its fold step rounds like the plain fold, so where
// the dot product is exact — event counts times quantized weights, as in
// serving — it agrees with deposit mode bit for bit.
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

// x0 [N, F], dep [S, N, F], a [F] -> out [N, F]; all float32, contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int stream_fold_f32(const float* x0, const float* dep,
                               const float* a, float* out, long long n,
                               int f, int s, void* stream) {
  const int64_t nf = static_cast<int64_t>(n) * f;
  stream_fold_kernel<<<blocks_for(nf), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x0, dep, a, out,
                                                            nf, f, s);
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
