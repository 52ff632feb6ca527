// P²M in-pixel conv kernel for Hopper (sm_90a), plain C interface for
// ctypes (see src/repro_torch/kernels/p2m_conv/p2m_conv.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/p2m_conv/p2m_conv.py:
//   p2m_conv_f32  <-  p2m_conv_multi_pallas (body _p2m_kernel); the
//                     single-config p2m_conv_pallas is the n_cfg = 1 case.
//
// Per circuit config c, output site and filter f, over the n_sub event
// sub-slots of one integration window:
//   v <- v_inf[c] + (v - v_inf[c]) * decay[c]            leak
//   ideal = (patch . w[:, f]) * dv_unit                  in-pixel MAC
//   g = clip(1 - (v / half_swing)^2, 0.05, 1)            step non-linearity
//   v <- clip(v + ideal * g * pv_gain, v_lo, v_hi)       rails
// then v_pre = v + pv_offset and spike = v_pre > theta[c].
//
// Bound: bytes. The outputs (spikes and v_pre, [n_cfg, B, T, H', W', F]
// float32) are 2 * n_cfg * F / (n_sub * Cin) times the event input: at the
// full-width shape (B 4, T 400, n_sub 4, 128x128, Cin 2, F 16, 3 configs)
// 10.1 GB written against 0.84 GB read, ~3.3 ms at 3.35 TB/s, while the
// ~110 GFLOP need ~1.65 ms at the 67 TFLOP/s fp32 rate.
//
// Design. The TPU kernel took materialised im2col patches [T, n_sub, P, K]
// and revisited each patch tile once per config. Here the kernel reads the
// event frames [B, T, n_sub, H, W, Cin] itself (patches would be 7.5 GB at
// the full-width shape, 9x the events) and does the SAME-padded im2col in
// shared memory: a block owns an 8x8 tile of output sites of one (b, t)
// and all F filters, stages every sub-slot's input tile plus its halo, and
// keeps w [K, F] and the per-config legs in shared memory. Each thread owns
// one filter of four sites; it computes the config-independent ideal step
// once per sub-slot and carries one voltage per config in registers, so
// the events are read once for all configs. Outputs go straight into the
// final [n_cfg, B, T, H', W', F] layout, F innermost, so a warp's stores
// cover two whole sites (128 contiguous bytes). For the paper's 3x3 kernel
// over ON/OFF the dot product is unrolled at compile time with the
// thread's weight column in registers (3x faster than runtime loops over
// k, k and Cin on the H100); a layout with one site and four filters per
// thread measured slower still and was dropped.
//
// Numerics. The K-term dot product is an fp32 FMA loop (K = k*k*Cin = 18
// is far below a wgmma tile, and TF32 would not hold the tolerance). The
// update is written with __fadd_rn/__fmul_rn/__fdiv_rn, which nvcc never
// contracts, in the plain version's operation order; with event counts and
// quantized weights every dot product is exact, and the kernel then agrees
// with the plain version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kSitesPerThread = 4;
constexpr int kSitesPerPass = kTileH * kTileW / kSitesPerThread;  // 16

struct Args {
  const float* events;   // [BT, n_sub, H, W, Cin]
  const float* w;        // [K, F], K ordered (kh, kw, Cin)
  const float* v_inf;    // [n_cfg, F]
  const float* decay;    // [n_cfg, F]
  const float* theta;    // [n_cfg, F]
  const float* pv_gain;  // [F]
  const float* pv_offset;// [F]
  float* spikes;         // [n_cfg, BT, Ho, Wo, F]
  float* v_pre;          // [n_cfg, BT, Ho, Wo, F]
  int64_t bt;
  int n_sub, h, w_dim, cin, ho, wo, f, k, stride, pad_top, pad_left;
  int tiles_x, tiles_y, in_h, in_w;
  float dv_unit, half_swing, v_lo, v_hi;
  int nonlinear;
};

// KS, CI > 0 fix the kernel size and input channels at compile time (the
// paper's 3x3 over ON/OFF): the dot product then unrolls with constant
// shared-memory offsets and the thread's weight column sits in registers.
// KS = CI = 0 takes both from the arguments.
template <int NCFG, int KS, int CI>
__global__ void p2m_conv_kernel(const Args a) {
  extern __shared__ float smem[];
  const int F = a.f;
  const int k = KS > 0 ? KS : a.k;
  const int cin = CI > 0 ? CI : a.cin;
  const int K = k * k * cin;
  float* s_w = smem;                       // [K, F]
  float* s_vinf = s_w + K * F;             // [NCFG, F]
  float* s_decay = s_vinf + NCFG * F;
  float* s_theta = s_decay + NCFG * F;
  float* s_pvg = s_theta + NCFG * F;       // [F]
  float* s_pvo = s_pvg + F;
  float* s_ev = s_pvo + F;                 // [n_sub, in_h, in_w, Cin]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int tiles = a.tiles_x * a.tiles_y;
  const int64_t bt = blockIdx.x / tiles;
  const int tile = blockIdx.x - static_cast<int>(bt) * tiles;
  const int oy0 = (tile / a.tiles_x) * kTileH;
  const int ox0 = (tile % a.tiles_x) * kTileW;
  const int iy0 = oy0 * a.stride - a.pad_top;
  const int ix0 = ox0 * a.stride - a.pad_left;

  for (int j = tid; j < K * F; j += nthr) s_w[j] = a.w[j];
  for (int j = tid; j < NCFG * F; j += nthr) {
    s_vinf[j] = a.v_inf[j];
    s_decay[j] = a.decay[j];
    s_theta[j] = a.theta[j];
  }
  for (int j = tid; j < F; j += nthr) {
    s_pvg[j] = a.pv_gain[j];
    s_pvo[j] = a.pv_offset[j];
  }
  // every sub-slot's input tile with its halo; SAME padding reads zeros
  const int row = a.in_w * cin;
  const int plane = a.in_h * row;
  const float* ev = a.events + bt * a.n_sub * static_cast<int64_t>(a.h) *
                                   a.w_dim * cin;
  for (int j = tid; j < a.n_sub * plane; j += nthr) {
    const int s = j / plane;
    const int r = j - s * plane;
    const int y = r / row;
    const int q = r - y * row;
    const int x = q / cin;
    const int c = q - x * cin;
    const int gy = iy0 + y;
    const int gx = ix0 + x;
    float val = 0.0f;
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_dim) {
      val = ev[((static_cast<int64_t>(s) * a.h + gy) * a.w_dim + gx) * cin + c];
    }
    s_ev[j] = val;
  }
  __syncthreads();

  const int f = tid % F;
  const int site0 = tid / F;
  float vinf[NCFG], dec[NCFG];
#pragma unroll
  for (int c = 0; c < NCFG; ++c) {
    vinf[c] = s_vinf[c * F + f];
    dec[c] = s_decay[c * F + f];
  }
  const float pvg = s_pvg[f];
  const float pvo = s_pvo[f];
  constexpr int kFixedK = KS > 0 ? KS * KS * CI : 1;
  float wcol[kFixedK];
  if constexpr (KS > 0) {
#pragma unroll
    for (int j = 0; j < kFixedK; ++j) wcol[j] = s_w[j * F + f];
  }
  const int64_t cfg_stride = a.bt * a.ho * static_cast<int64_t>(a.wo) * F;

#pragma unroll
  for (int r = 0; r < kSitesPerThread; ++r) {
    const int site = site0 + r * kSitesPerPass;
    const int ty = site / kTileW;
    const int tx = site - ty * kTileW;
    const int oy = oy0 + ty;
    const int ox = ox0 + tx;
    if (oy >= a.ho || ox >= a.wo) continue;
    float v[NCFG];
#pragma unroll
    for (int c = 0; c < NCFG; ++c) v[c] = 0.0f;
    for (int s = 0; s < a.n_sub; ++s) {
      const float* e = s_ev + s * plane + ty * a.stride * row + tx * a.stride * cin;
      float acc = 0.0f;
      if constexpr (KS > 0) {
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
          for (int j = 0; j < KS * CI; ++j) {
            acc = fmaf(e[kh * row + j], wcol[kh * KS * CI + j], acc);
          }
        }
      } else {
        int kidx = 0;
        for (int kh = 0; kh < k; ++kh) {
          for (int kw = 0; kw < k; ++kw) {
            for (int c = 0; c < cin; ++c, ++kidx) {
              acc = fmaf(e[kh * row + kw * cin + c], s_w[kidx * F + f], acc);
            }
          }
        }
      }
      const float ideal = __fmul_rn(acc, a.dv_unit);
#pragma unroll
      for (int c = 0; c < NCFG; ++c) {
        const float vl = __fadd_rn(vinf[c], __fmul_rn(__fsub_rn(v[c], vinf[c]), dec[c]));
        float step = ideal;
        if (a.nonlinear) {
          const float t = __fdiv_rn(vl, a.half_swing);
          const float g = fminf(fmaxf(__fsub_rn(1.0f, __fmul_rn(t, t)), 0.05f), 1.0f);
          step = __fmul_rn(ideal, g);
        }
        step = __fmul_rn(step, pvg);
        v[c] = fminf(fmaxf(__fadd_rn(vl, step), a.v_lo), a.v_hi);
      }
    }
    const int64_t out = ((bt * a.ho + oy) * a.wo + ox) * F + f;
#pragma unroll
    for (int c = 0; c < NCFG; ++c) {
      const float vp = __fadd_rn(v[c], pvo);
      a.v_pre[c * cfg_stride + out] = vp;
      a.spikes[c * cfg_stride + out] = vp > s_theta[c * F + f] ? 1.0f : 0.0f;
    }
  }
}

template <int NCFG>
cudaError_t launch(const Args& a, unsigned blocks, int threads, size_t shmem,
                   cudaStream_t stream) {
  if (a.k == 3 && a.cin == 2) {
    p2m_conv_kernel<NCFG, 3, 2><<<blocks, threads, shmem, stream>>>(a);
  } else {
    p2m_conv_kernel<NCFG, 0, 0><<<blocks, threads, shmem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one block of p2m_conv_f32 needs (for the wrapper's
// check against the 48 KB a launch may take without opting in).
extern "C" long long p2m_conv_shmem_bytes(int n_sub, int cin, int f, int k,
                                          int stride, int n_cfg) {
  const long long in_h = (kTileH - 1) * stride + k;
  const long long in_w = (kTileW - 1) * stride + k;
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(k) * k * cin * f + 3LL * n_cfg * f + 2LL * f +
          static_cast<long long>(n_sub) * in_h * in_w * cin);
}

// events [B*T, n_sub, H, W, Cin], w [k*k*Cin, F], v_inf/decay/theta
// [n_cfg, F], pv_gain/pv_offset [F] -> spikes, v_pre [n_cfg, B*T, Ho, Wo, F];
// all float32, contiguous. 1 <= n_cfg <= 8 and 16*F <= 1024 threads; the
// wrapper checks both and the shared-memory size (at most 48 KB).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int p2m_conv_f32(const float* events, const float* w,
                            const float* v_inf, const float* decay,
                            const float* theta, const float* pv_gain,
                            const float* pv_offset, float* spikes,
                            float* v_pre, long long bt, int n_sub, int h,
                            int w_dim, int cin, int ho, int wo, int f, int k,
                            int stride, int pad_top, int pad_left, int n_cfg,
                            float dv_unit, float half_swing, float v_lo,
                            float v_hi, int nonlinear, void* stream) {
  Args a{events, w, v_inf, decay, theta, pv_gain, pv_offset, spikes, v_pre,
         bt, n_sub, h, w_dim, cin, ho, wo, f, k, stride, pad_top, pad_left,
         (wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH,
         (kTileH - 1) * stride + k, (kTileW - 1) * stride + k,
         dv_unit, half_swing, v_lo, v_hi, nonlinear};
  const long long n_blocks = bt * a.tiles_x * a.tiles_y;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  const int threads = kSitesPerPass * f;
  const size_t shmem =
      static_cast<size_t>(p2m_conv_shmem_bytes(n_sub, cin, f, k, stride, n_cfg));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_cfg) {
    case 1: return static_cast<int>(launch<1>(a, blocks, threads, shmem, s));
    case 2: return static_cast<int>(launch<2>(a, blocks, threads, shmem, s));
    case 3: return static_cast<int>(launch<3>(a, blocks, threads, shmem, s));
    case 4: return static_cast<int>(launch<4>(a, blocks, threads, shmem, s));
    case 5: return static_cast<int>(launch<5>(a, blocks, threads, shmem, s));
    case 6: return static_cast<int>(launch<6>(a, blocks, threads, shmem, s));
    case 7: return static_cast<int>(launch<7>(a, blocks, threads, shmem, s));
    case 8: return static_cast<int>(launch<8>(a, blocks, threads, shmem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
