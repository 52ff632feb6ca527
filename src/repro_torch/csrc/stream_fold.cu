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
// stream_fold takes the deposits; stream_fold_mac computes them, the SAME
// conv of the chunk's event frames [B, S, H, W, Cin] with w [k*k*Cin, F]
// times dv_unit, in the kernel: the TPU kernel and this one's earlier
// version read im2col patches [S, N, K] that PyTorch built first (9x the
// events at Cin 2 and a 3x3 kernel, three device passes before the launch).
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
//   stream_fold_mac  HBM bytes (B*S*H*W*Cin + 2*N*F)*4 + (K*F + F)*4
//                    (read the frames, x0, w, a; write out)
// The design reads every input byte from device memory once: x0 and the
// deposits stream through with neighbouring threads on neighbouring
// addresses, a and w sit in registers/shared memory, and the carry never
// leaves the register file between sub-slots. The scalar fold reached 70 %
// of its bound at the serving shape (S 1, N 262,144, F 16): 4-byte
// accesses, a 64-bit modulo per element and one deposit load in flight per
// thread; the vector route does a quarter of the memory instructions and
// keeps S loads in flight.
//
// stream_fold_mac stages the frames through shared memory as K1 does
// (p2m_tile.cuh: persistent blocks over 8x16-site tiles, the next two
// tiles loading into a ring of buffers while this one computes, one site
// and 4 filters a thread, each patch value read from shared memory once
// per site and 4 filters); x0 arrives in the same ring, and out leaves as
// float4 streaming stores (__stcs). Two routes, chosen by shape
// (stream_fold.py, mac_route):
//   TMA (stream_fold_mac_f32) for the 3x3 kernel over ON/OFF with F % 8
//     == 0, W even and x0 and the frames 16-byte aligned: a tile is one
//     frames box and one x0 box, issued by one thread on one mbarrier, and
//     the dot products run on the tensor cores as K1's do (dot_mma);
//   cp.async (stream_fold_mac_cp_f32) otherwise: every thread copies
//     floats of the frames and 16-byte x0 runs (4-byte when x0 is off the
//     16-byte grid, then one filter a thread), and the products are FMA
//     loops, 4 filters an item.
//
// Numerics: stream_fold must be bit-exact with the plain PyTorch fold
// (eager x * a + dep, two separately rounded ops), so both routes use
// __fmul_rn and __fadd_rn, which nvcc never contracts into an FMA.
// stream_fold_mac sums the K-term dot product with FMAs in another order
// than the plain matmul (held to 1e-5 abs) and its fold step rounds like the
// plain fold, so where the dot product is exact — event counts times
// quantized weights, as in serving — it agrees with deposit mode bit for
// bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "p2m_tile.cuh"

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

struct MacArgs {
  const float* x0;       // [B*Ho*Wo, F]
  const float* frames;   // [B, S, H, W, Cin]
  const float* w;        // [K, F], K ordered (kh, kw, Cin)
  const float* a;        // [F]
  float* out;            // [B*Ho*Wo, F]
  p2m::Geo g;
  int s_dim, f, k;
  float dv_unit;
  int x_shift;           // TMA route: staged rows start this many pixels
                         // left of the tile's input (16-byte TMA rows)
};

// The cp.async route, for any shape: one staged tile, every (site, FB
// filters) item folding x over the S sub-slots from x0's staged tile xs
// [kTileH * kTileW, F] and the staged frames ev, then storing out.
template <int FB>
__device__ __forceinline__ void fold_tile(const MacArgs& m, const float* s_w,
                                          const float* s_a, const float* ev,
                                          const float* xs, long long img,
                                          int oy0, int ox0) {
  const p2m::Geo& g = m.g;
  const int F = m.f;
  const int G = F / FB;
  const int items = p2m::kTileH * p2m::kTileW * G;
  const int row = g.in_w * g.cin;
  const int plane = g.in_h * row;
  for (int j = threadIdx.x; j < items; j += p2m::kThreads) {
    const int gi = j % G;
    const int site = j / G;
    const int ty = site / p2m::kTileW;
    const int tx = site - ty * p2m::kTileW;
    const int oy = oy0 + ty;
    const int ox = ox0 + tx;
    if (oy >= g.ho || ox >= g.wo) continue;
    const int f0 = gi * FB;
    float af[FB], x[FB];
    p2m::load_fb<FB>(s_a + f0, af);
    p2m::load_fb<FB>(xs + site * F + f0, x);
    const float* e0 = ev + ty * g.stride * row + tx * g.stride * g.cin;
    for (int s = 0; s < m.s_dim; ++s) {
      float acc[FB];
      p2m::dot_generic<FB>(e0 + s * plane, row, m.k, g.cin, s_w, F, f0, acc);
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        x[f] = __fadd_rn(__fmul_rn(x[f], af[f]), __fmul_rn(acc[f], m.dv_unit));
      }
    }
    p2m::store_fb<FB>(m.out + ((img * g.ho + oy) * g.wo + ox) * F + f0, x);
  }
}

// The TMA route: k 3, Cin 2, F % 8 == 0. A tile is one frames box [S]
// [in_h][in_w * 2] and one x0 box [kTileH][kTileW][F], on one mbarrier;
// the dot products run on the tensor cores as in K1 (p2m_tile.cuh,
// dot_mma): a warp owns a row of 16 sites, thread (g = lane / 4, t = lane
// % 4) the values of sites g and g + 8, columns 2t, 2t + 1 of each n8
// tile: 2 NT neighbouring filters of each site (p2m::tile_filter), read
// from x0 and written to out as one run. Shared memory: the ring of slots, the B fragments [F / 8][term][3]
// [32], the tile's pixels as bf16 terms [3][px4], a [F], the mbarriers.
template <int NT>
__global__ void __launch_bounds__(p2m::kThreads)
stream_fold_mac_tma_kernel(const __grid_constant__ CUtensorMap fr_map,
                           const __grid_constant__ CUtensorMap x_map,
                           const MacArgs m) {
  extern __shared__ __align__(128) float smem[];
  const p2m::Geo& g = m.g;
  const int F = m.f;
  const int px = m.s_dim * g.in_h * g.in_w;         // pixels of a tile
  const int px4 = (px + 3) & ~3;
  const int fr_floats = static_cast<int>(p2m::tile_floats(g, m.s_dim, 32));
  const int slot_floats = fr_floats + p2m::kTileH * p2m::kTileW * F;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem + p2m::kStages * slot_floats);
  uint32_t* s_ab = s_b + F / 8 * 9 * 32;
  float* s_a = reinterpret_cast<float*>(s_ab + 3 * px4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_a + ((F + 3) & ~3));
  bool w_exact = true;
  const auto init = [&] {
    for (int j = threadIdx.x; j < F; j += p2m::kThreads) s_a[j] = m.a[j];
    w_exact = !__syncthreads_or(p2m::build_bfrags(s_b, m.w, F));
  };
  const uint32_t bytes = 4u * (px * 2 + p2m::kTileH * p2m::kTileW * F);
  const auto issue = [&](int tile, int slot, uint64_t* bar) {
    const int img = tile / g.tiles_per_img;
    const int t = tile - img * g.tiles_per_img;
    const int oy0 = (t / g.tiles_x) * p2m::kTileH;
    const int ox0 = (t % g.tiles_x) * p2m::kTileW;
    float* dst = smem + slot * slot_floats;
    hopper::mbar_expect_tx(bar, bytes);
    hopper::tma_load_3d(dst, &fr_map, bar,
                        2 * (ox0 * g.stride - g.pad_left - m.x_shift),
                        oy0 * g.stride - g.pad_top, img * m.s_dim);
    hopper::tma_load_3d(dst + fr_floats, &x_map, bar, 0, ox0,
                        img * g.ho + oy0);
  };
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;               // the tile row it owns
  const int gr = lane >> 2, t = lane & 3;
  p2m::run_tiles_tma(g, bars, init, issue,
      [&](int slot, long long img, int oy0, int ox0) {
    const float* ev = smem + slot * slot_floats;
    const float* xs = ev + fr_floats + warp * p2m::kTileW * F;   // its row
    const bool a_exact =
        !__syncthreads_or(p2m::convert_tile(ev, s_ab, px, px4));
    const int oy = oy0 + warp;
    if (oy >= g.ho) return;
    const int y0 = warp * g.stride;
    const int x_g = gr * g.stride + m.x_shift;
    const int x_g8 = (gr + 8) * g.stride + m.x_shift;
    const bool ok_g = ox0 + gr < g.wo, ok_g8 = ox0 + gr + 8 < g.wo;
    const long long site_g = (img * g.ho + oy) * g.wo + ox0 + gr;
    for (int n0 = 0; n0 < F; n0 += 8 * NT) {
      // the lane's filters fb .. fb + 2 NT - 1 (p2m::tile_filter): tile j
      // holds fb + 2 j and fb + 2 j + 1, of site g (x[j][0], x[j][1]) and
      // of site g + 8 (x[j][2], x[j][3])
      const int fb = n0 + 2 * NT * t;
      p2m::BFrag bh[NT];
      float af[2 * NT], xr[2 * NT], xr8[2 * NT], x[NT][4];
      p2m::load_fb<2 * NT>(s_a + fb, af);
      p2m::load_fb<2 * NT>(xs + gr * F + fb, xr);
      p2m::load_fb<2 * NT>(xs + (gr + 8) * F + fb, xr8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bh[j] = p2m::bfrag(s_b, n0 / 8 + j, 0, lane);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[j][e] = xr[2 * j + e];
          x[j][2 + e] = xr8[2 * j + e];
        }
      }
      for (int s = 0; s < m.s_dim; ++s) {
        float acc[NT][4];
        p2m::dot_mma<NT>(acc, s_ab + s * g.in_h * g.in_w, px4, g.in_w, y0,
                         x_g, x_g8, t, bh, s_b, n0 / 8, lane, a_exact,
                         w_exact);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[j][e] = __fadd_rn(__fmul_rn(x[j][e], af[2 * j + (e & 1)]),
                                __fmul_rn(acc[j][e], m.dv_unit));
          }
        }
      }
      // 16-byte stores (8 with NT 1): a warp's store covers the 8 NT
      // filters of 8 neighbouring sites, one contiguous run
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xr[2 * j + e] = x[j][e];
          xr8[2 * j + e] = x[j][2 + e];
        }
      }
      float* o = m.out + site_g * F + fb;
      if (ok_g) p2m::store_fb<2 * NT>(o, xr);
      if (ok_g8) p2m::store_fb<2 * NT>(o + 8 * F, xr8);
    }
  });
}

// The cp.async route's kernel. Shared memory: w [K, F], a [F], then the
// rings of x0 tiles [kTileH * kTileW, F] and of frame tiles.
template <int FB>
__global__ void __launch_bounds__(p2m::kThreads)
stream_fold_mac_cp_kernel(const MacArgs m) {
  extern __shared__ __align__(16) float smem[];
  const int F = m.f;
  const int K = m.k * m.k * m.g.cin;
  float* s_w = smem;
  float* s_a = s_w + K * F;
  float* s_x = smem + ((K * F + F + 3) & ~3);      // the ring of x0 tiles
  const int x_tile = p2m::kTileH * p2m::kTileW * F;
  float* s_ev = s_x + p2m::kStages * x_tile;
  const auto init = [&] {          // visible after run_tiles' first sync
    for (int j = threadIdx.x; j < K * F; j += p2m::kThreads) s_w[j] = m.w[j];
    for (int j = threadIdx.x; j < F; j += p2m::kThreads) s_a[j] = m.a[j];
  };
  p2m::run_tiles(m.g, m.frames, m.s_dim, s_ev, init,
      [&](int tile, int slot) {
        p2m::stage_sites<FB>(s_x + slot * x_tile, m.x0, F, m.g, tile);
      },
      [&](const float* ev, int slot, long long img, int oy0, int ox0) {
    fold_tile<FB>(m, s_w, s_a, ev, s_x + slot * x_tile, img, oy0, ox0);
  });
}

// g: the TMA route's geometry (in_w padded)
long long mac_tma_shmem_floats(const p2m::Geo& g, int s_dim, int f) {
  const long long px = (static_cast<long long>(s_dim) * g.in_h * g.in_w + 3) & ~3LL;
  return p2m::kStages * (p2m::tile_floats(g, s_dim, 32) +
                         static_cast<long long>(p2m::kTileH) * p2m::kTileW * f) +
         f / 8 * 9 * 32 + 3 * px + ((f + 3) & ~3) + 2 * p2m::kStages;
}

long long mac_cp_shmem_floats(const p2m::Geo& g, int s_dim, int f, int k) {
  return ((static_cast<long long>(k) * k * g.cin * f + f + 3) & ~3LL) +
         static_cast<long long>(p2m::kStages) *
             (p2m::kTileH * p2m::kTileW * f + p2m::tile_floats(g, s_dim));
}

MacArgs make_mac(const float* x0, const float* frames, const float* w,
                 const float* a, float* out, long long b, int s, int h,
                 int w_dim, int cin, int ho, int wo, int f, int k, int stride,
                 int pad_top, int pad_left, float dv_unit) {
  return MacArgs{x0, frames, w, a, out,
                 p2m::make_geo(h, w_dim, cin, ho, wo, stride, k, pad_top,
                               pad_left, b),
                 s, f, k, dv_unit, 0};
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

// Shared-memory bytes one block of the MAC fold needs (tma: 1 for
// stream_fold_mac_f32, 0 for stream_fold_mac_cp_f32; at most 227 KB).
extern "C" long long stream_fold_mac_shmem_bytes(int s, int cin, int f,
                                                 int k, int stride, int tma) {
  p2m::Geo g = p2m::make_geo(1, 1, cin, 1, 1, stride, k, 0, 0, 1);
  if (tma) g.in_w = (g.in_w + 2) & ~1;     // the most x_shift can add
  return static_cast<long long>(sizeof(float)) *
         (tma ? mac_tma_shmem_floats(g, s, f) : mac_cp_shmem_floats(g, s, f, k));
}

// The TMA route. x0 [B*Ho*Wo, F], frames [B, S, H, W, 2], w [18, F] (k 3),
// a [F] -> out [B*Ho*Wo, F]; float32, contiguous, x0, frames and out
// 16-byte aligned, F % 8 == 0, W even (else cudaErrorInvalidValue and
// nothing launched); SAME padding with pad_top / pad_left rows and columns
// before the frame. Returns the cudaError_t of the launch (0 = launched).
extern "C" int stream_fold_mac_f32(const float* x0, const float* frames,
                                   const float* w, const float* a, float* out,
                                   long long b, int s, int h, int w_dim,
                                   int cin, int ho, int wo, int f, int k,
                                   int stride, int pad_top, int pad_left,
                                   float dv_unit, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (k != 3 || cin != 2 || f % 8 != 0 || f > 256 || w_dim % 2 != 0 ||
      !aligned(x0) || !aligned(frames) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MacArgs m = make_mac(x0, frames, w, a, out, b, s, h, w_dim, cin, ho, wo, f,
                       k, stride, pad_top, pad_left, dv_unit);
  // TMA boxes start and end on 16 bytes: an even pixel on both sides
  m.x_shift = pad_left & 1;
  m.g.in_w = (m.g.in_w + m.x_shift + 1) & ~1;
  if (m.g.n_tiles < 1 || s > 256 || m.g.in_h > 256 || 2 * m.g.in_w > 256) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  CUtensorMap fr_map, x_map;
  cudaError_t e = hopper::map_f32_3d(&fr_map, frames, 2LL * w_dim, h, b * s,
                                     2 * m.g.in_w, m.g.in_h, s);
  if (e == cudaSuccess) {
    e = hopper::map_f32_3d(&x_map, x0, f, wo, b * ho, f, p2m::kTileW,
                           p2m::kTileH);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t shmem = sizeof(float) * static_cast<size_t>(
      mac_tma_shmem_floats(m.g, s, f));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f % 16 == 0
          ? p2m::launch_persistent(stream_fold_mac_tma_kernel<2>, shmem, st,
                                   m.g.n_tiles, fr_map, x_map, m)
          : p2m::launch_persistent(stream_fold_mac_tma_kernel<1>, shmem, st,
                                   m.g.n_tiles, fr_map, x_map, m));
}

// The cp.async route: the same arguments for any k, Cin, F and alignment.
extern "C" int stream_fold_mac_cp_f32(const float* x0, const float* frames,
                                      const float* w, const float* a,
                                      float* out, long long b, int s, int h,
                                      int w_dim, int cin, int ho, int wo,
                                      int f, int k, int stride, int pad_top,
                                      int pad_left, float dv_unit,
                                      void* stream) {
  const MacArgs m = make_mac(x0, frames, w, a, out, b, s, h, w_dim, cin, ho,
                             wo, f, k, stride, pad_top, pad_left, dv_unit);
  if (m.g.n_tiles < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t shmem = sizeof(float) * static_cast<size_t>(
      mac_cp_shmem_floats(m.g, s, f, k));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // four filters an item, x0 staged in 16-byte runs, where F and the
  // pointers allow
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return static_cast<int>(
      vec ? p2m::launch_persistent(stream_fold_mac_cp_kernel<4>, shmem, st,
                                   m.g.n_tiles, m)
          : p2m::launch_persistent(stream_fold_mac_cp_kernel<1>, shmem, st,
                                   m.g.n_tiles, m));
}
