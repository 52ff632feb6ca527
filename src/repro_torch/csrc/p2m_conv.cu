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
// Bound. The outputs (spikes and v_pre, [n_cfg, B, T, H', W', F] float32)
// are 2 * n_cfg * F / (n_sub * Cin) times the event input: at the
// full-width shape (B 4, T 400, n_sub 4, 128x128, Cin 2, F 16) 3.4 GB a
// config written against 0.84 GB read, so bytes bound it from n_cfg 2 up;
// at n_cfg 1 the ~85 GFLOP of dot products and updates bound it.
//
// Design. The TPU kernel took materialised im2col patches [T, n_sub, P,
// K]; here the kernel reads the event frames [B, T, n_sub, H, W, Cin]
// itself (patches would be 9x the events) and does the SAME-padded im2col
// in shared memory. A persistent block walks 8x16-site tiles of one
// (b, t) with the next two tiles loading into a ring of shared-memory
// buffers (p2m_tile.cuh). Two routes, chosen by shape in the wrapper:
//   tensor cores (p2m_conv_f32; 3x3 over ON/OFF, F % 8 == 0, W even,
//     events 16-byte aligned): a tile is one TMA box [n_sub][10][20 x 2]
//     (out-of-bounds rows and columns arrive as zeros), converted once to
//     bf16 terms; a warp owns a row of 16 sites, and each pixel's ON/OFF
//     pair is loaded once per site as one register of an mma.sync A
//     fragment, shared by all F filters in the product; the filters are
//     laid out so that a lane's outputs of a site are 4 neighbouring
//     floats (2 unless F % 16 == 0), written with 16-byte streaming
//     stores;
//   FMA (p2m_conv_fma_f32; any k, Cin, F, W, alignment): cp.async staging,
//     a thread's item is one site and 4 filters (F % 4 == 0; else 1), each
//     patch value read from shared memory once and fed to the 4 filters.
// Both load each patch value once per site and not once per filter (the
// previous version, one filter a thread, read it F times: 0.94 G warp-wide
// shared loads at the full-width shape). The tensor-core product won:
// chip_smoke.py times both routes on the physics batch in the same run
// (PERF.md). An FMA layout with the weights of a thread's 4 filters in
// registers needed up to 167 registers a thread, so few warps were
// resident, and was dropped. Loads, not products, set the pace: in an
// instrumented copy of the kernel (not kept) issuing per-lane 8-byte
// cp.async took most of a warp's cycles at n_cfg 1, and TMA boxes, one
// instruction a tile, removed that. The config-independent ideal step is
// computed once per sub-slot and the voltages of every config stay in
// registers, so the events are read once for all configs.
//
// Numerics. The update is written with __fadd_rn/__fmul_rn/__fsub_rn,
// which nvcc never contracts, in the plain version's operation order. On
// the tensor cores a float32 operand enters as hi + mid + lo bf16 terms
// (24 bits); operands whose mid term is 0 (event counts to 256, weights in
// eighths) enter as hi alone, so the physics batch's products are single
// exact bf16 products. v / half_swing is Markstein's correction of v * r
// with r = RN(1 / half_swing) from the wrapper: q = v r, e = fma(-q,
// half_swing, v), t = fma(e, r, q), correctly rounded unless the remainder
// e underflows, so for 0 < |v| < 2^-100 the kernel's quotient is
// __fdiv_rn's; t takes v's sign, which keeps -0. The update runs
// Markstein's step on one straight-line path and flags such a voltage;
// a warp (an item, on the FMA route) that raised the flag integrates its
// window again with the exact quotient (a branch per config instead kept
// the compiler from interleaving the configs' chains).
// p2m_quotient_check compares this quotient with __fdiv_rn for every
// float32 of magnitude <= 1. With event
// counts and quantized weights every dot product is exact on both routes,
// and the kernel agrees with the plain version bit for bit.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "p2m_tile.cuh"

namespace {

using p2m::kThreads;
using p2m::kTileH;
using p2m::kTileW;
using p2m::load_fb;
using p2m::store_fb;
using p2m::BFrag;

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
  p2m::Geo g;
  int n_sub, f, k;
  float dv_unit, half_swing, recip, v_lo, v_hi;
  int nonlinear;
  int x_shift;   // tensor-core route: the staged rows start this many
                 // pixels left of the tile's input (TMA rows start on 16 B)
};

// Markstein's step for v / half_swing: correctly rounded unless the
// remainder underflows (see the note), i.e. unless quotient_tiny(v); the
// sign is v's, so that -0 gives -0
__device__ __forceinline__ float markstein(float v, float half_swing,
                                           float recip) {
  const float q = __fmul_rn(v, recip);
  const float e = __fmaf_rn(-q, half_swing, v);
  return copysignf(__fmaf_rn(e, recip, q), v);
}

// 0 < |v| < 2^-100 (0x0d800000 is 2^-100's bit pattern): voltages at rest
// (exactly 0, common where no event arrives) stay on the fast path
__device__ __forceinline__ bool quotient_tiny(float v) {
  return (__float_as_uint(v) & 0x7fffffffu) - 1u < 0x0d800000u - 1u;
}

// The kernel's v / half_swing, bit-identical to __fdiv_rn(v, half_swing)
__device__ __forceinline__ float quotient(float v, float half_swing,
                                          float recip) {
  return quotient_tiny(v) ? __fdiv_rn(v, half_swing)
                          : markstein(v, half_swing, recip);
}

// One sub-slot of every config for N (site, filter) voltages v, in the
// plain version's operation order: leak, the step gain clip(1 - (v /
// half_swing)^2, 0.05, 1), the process-variation gain, the rails. legs(c,
// vinf, dec) fills config c's leg of each voltage. kExact takes the
// kernel's quotient (a branch per voltage); else Markstein's step alone,
// on one straight-line path, setting `tiny` for a voltage in (0, 2^-100),
// where that step may be off (the caller then integrates again exactly).
template <bool kExact, int NCFG, int N, typename Legs>
__device__ __forceinline__ void update(float (&v)[NCFG][N],
                                       const float (&ideal)[N],
                                       const float (&pvg)[N], const Args& a,
                                       Legs&& legs, bool& tiny) {
#pragma unroll
  for (int c = 0; c < NCFG; ++c) {
    float vinf[N], dec[N];
    legs(c, vinf, dec);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float vl =
          __fadd_rn(vinf[i], __fmul_rn(__fsub_rn(v[c][i], vinf[i]), dec[i]));
      float t;
      if constexpr (kExact) {
        t = quotient(vl, a.half_swing, a.recip);
      } else {
        t = markstein(vl, a.half_swing, a.recip);
        tiny |= quotient_tiny(vl);
      }
      // clip(., 0.05, 1) of 1 - t^2 <= 1 is its max with 0.05; ideal * 1
      // is ideal: the linear circuit takes the same path
      const float gain = a.nonlinear
          ? fmaxf(__fsub_rn(1.0f, __fmul_rn(t, t)), 0.05f)
          : 1.0f;
      const float step = __fmul_rn(__fmul_rn(ideal[i], gain), pvg[i]);
      v[c][i] = fminf(fmaxf(__fadd_rn(vl, step), a.v_lo), a.v_hi);
    }
  }
}

// shared memory (floats): w [K, F], v_inf/decay/theta [n_cfg, F],
// pv_gain/pv_offset [F], rounded up to 16 bytes
__host__ __device__ inline int params_floats(int K, int F, int n_cfg) {
  return (K * F + 3 * n_cfg * F + 2 * F + 3) & ~3;
}

template <int NCFG>
__device__ __forceinline__ void load_params(const Args& a, float* smem,
                                            int K) {
  const int F = a.f;
  float* s_vinf = smem + K * F;
  for (int j = threadIdx.x; j < NCFG * F; j += kThreads) {
    s_vinf[j] = a.v_inf[j];
    s_vinf[NCFG * F + j] = a.decay[j];
    s_vinf[2 * NCFG * F + j] = a.theta[j];
  }
  for (int j = threadIdx.x; j < F; j += kThreads) {
    s_vinf[3 * NCFG * F + j] = a.pv_gain[j];
    s_vinf[3 * NCFG * F + F + j] = a.pv_offset[j];
  }
}

// ---- the tensor-core route: k 3, Cin 2, F % 8 == 0 -----------------------
//
// A warp owns one row of 16 sites of the tile and 8 NT filters at a time:
// the dot products of a sub-slot are mma.sync m16n8k16 + m16n8k8 over K =
// 18 (k 18..23 zero in B), A the sites' patches, gathered pixel by pixel
// (a pixel's ON/OFF pair is one register of bf16 pairs) from the staged
// tile converted to bf16 terms, B the weights in registers. A float32
// operand enters as hi + mid + lo bf16 terms, which hold its 24 bits; an
// operand whose mid term is 0 everywhere (event counts up to 256, weights
// in eighths) enters as hi alone, decided per tile for the events (a
// block-wide vote while converting) and per block for the weights. The
// product terms: hi*hi, then hi*mid and hi*lo of w, mid*hi and lo*hi of
// the events, mid*mid where both need it. Thread (g = lane / 4, t = lane %
// 4) holds sites g and g + 8, filters 2t, 2t + 1 of each n8 tile.

template <int NCFG, int NT>
__global__ void __launch_bounds__(kThreads, 2)
p2m_conv_mma_kernel(const __grid_constant__ CUtensorMap ev_map,
                    const Args a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int K = 18;
  const int F = a.f;
  const p2m::Geo& g = a.g;                         // in_w even: TMA rows
  const int px = a.n_sub * g.in_h * g.in_w;         // pixels of a tile
  const int px4 = (px + 3) & ~3;
  const int slot_floats = static_cast<int>(p2m::tile_floats(g, a.n_sub, 32));
  // the ring of staged tiles (TMA boxes [n_sub][in_h][in_w * 2]), the
  // parameters, the B fragments [F / 8][term][3][32 lanes], the tile's
  // pixels as bf16 pairs (hi, mid, lo [px4] each), the ring's mbarriers
  float* params = smem + p2m::kStages * slot_floats;
  const float* s_vinf = params + K * F;
  const float* s_decay = s_vinf + NCFG * F;
  const float* s_theta = s_decay + NCFG * F;
  const float* s_pvg = s_theta + NCFG * F;
  const float* s_pvo = s_pvg + F;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(params + params_floats(K, F, NCFG));
  uint32_t* s_ab = s_b + F / 8 * 9 * 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_ab + 3 * px4);

  // the weights' B fragments and the vote on their bf16 terms
  bool w_exact = true;
  const auto init = [&] {
    load_params<NCFG>(a, params, K);
    w_exact = !__syncthreads_or(p2m::build_bfrags(s_b, a.w, F));
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;               // the tile row it owns
  const int gr = lane >> 2, t = lane & 3;
  const long long cfg_stride =
      g.n_tiles / g.tiles_per_img * g.ho * static_cast<long long>(g.wo) * F;
  constexpr int N = 4 * NT;                        // voltages a thread holds

  const uint32_t box_bytes = 4u * a.n_sub * g.in_h * g.in_w * 2;
  const auto issue = [&](int tile, int slot, uint64_t* bar) {
    const int img = tile / g.tiles_per_img;
    const int t = tile - img * g.tiles_per_img;
    hopper::mbar_expect_tx(bar, box_bytes);
    hopper::tma_load_3d(smem + slot * slot_floats, &ev_map, bar,
                        2 * ((t % g.tiles_x) * kTileW * g.stride - g.pad_left -
                             a.x_shift),
                        (t / g.tiles_x) * kTileH * g.stride - g.pad_top,
                        img * a.n_sub);
  };

  p2m::run_tiles_tma(g, bars, init, issue,
      [&](int slot, long long img, int oy0, int ox0) {
    const float* ev = smem + slot * slot_floats;
    // the tile's events as bf16 terms; one vote for the whole tile
    const bool a_exact =
        !__syncthreads_or(p2m::convert_tile(ev, s_ab, px, px4));
    const int oy = oy0 + warp;
    if (oy >= g.ho) return;
    const int y0 = warp * g.stride;
    const int x_g = gr * g.stride + a.x_shift;
    const int x_g8 = (gr + 8) * g.stride + a.x_shift;
    const bool ok_g = ox0 + gr < g.wo, ok_g8 = ox0 + gr + 8 < g.wo;
    const long long site_g = (img * g.ho + oy) * g.wo + ox0 + gr;
    for (int n0 = 0; n0 < F; n0 += 8 * NT) {
      // the lane's filters fb .. fb + 2 NT - 1 (p2m::tile_filter): tile j
      // holds fb + 2 j and fb + 2 j + 1, of site g (v[.][4 j], [4 j + 1])
      // and of site g + 8 (v[.][4 j + 2], [4 j + 3])
      const int fb = n0 + 2 * NT * t;
      BFrag bh[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) bh[j] = p2m::bfrag(s_b, n0 / 8 + j, 0, lane);
      const auto spread = [](const float (&x)[2 * NT], float (&out)[N]) {
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i) {
          out[(i >> 1) * 4 + (i & 1)] = out[(i >> 1) * 4 + 2 + (i & 1)] = x[i];
        }
      };
      float pvg[N];
      {
        float x[2 * NT];
        load_fb<2 * NT>(s_pvg + fb, x);
        spread(x, pvg);
      }
      const auto legs = [&](int c, float (&vinf)[N], float (&dec)[N]) {
        float x[2 * NT];
        load_fb<2 * NT>(s_vinf + c * F + fb, x);
        spread(x, vinf);
        load_fb<2 * NT>(s_decay + c * F + fb, x);
        spread(x, dec);
      };
      // every sub-slot of the window; a warp whose voltages met (0,
      // 2^-100) integrates again with the exact quotient
      float v[NCFG][N];
      const auto integrate = [&](auto exact) {
#pragma unroll
        for (int c = 0; c < NCFG; ++c) {
#pragma unroll
          for (int i = 0; i < N; ++i) v[c][i] = 0.0f;
        }
        bool tiny = false;
        for (int s = 0; s < a.n_sub; ++s) {
          float acc[NT][4];
          p2m::dot_mma<NT>(acc, s_ab + s * g.in_h * g.in_w, px4, g.in_w, y0,
                           x_g, x_g8, t, bh, s_b, n0 / 8, lane, a_exact,
                           w_exact);
          float ideal[N];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ideal[4 * j + e] = __fmul_rn(acc[j][e], a.dv_unit);
          }
          update<decltype(exact)::value, NCFG, N>(v, ideal, pvg, a, legs, tiny);
        }
        return tiny;
      };
      if (__any_sync(0xffffffffu, integrate(std::false_type{}))) {
        integrate(std::true_type{});
      }
      // v_pre = v + pv_offset and the comparator; 16-byte stores (8 with
      // NT 1) of a site's run of the lane's filters: a warp's store covers
      // the 8 NT filters of 8 neighbouring sites, one contiguous run
      float po[2 * NT];
      load_fb<2 * NT>(s_pvo + fb, po);
#pragma unroll
      for (int c = 0; c < NCFG; ++c) {
        float th[2 * NT], p0[2 * NT], p1[2 * NT], s0[2 * NT], s1[2 * NT];
        load_fb<2 * NT>(s_theta + c * F + fb, th);
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i) {
          const int e = (i >> 1) * 4 + (i & 1);
          p0[i] = __fadd_rn(v[c][e], po[i]);
          p1[i] = __fadd_rn(v[c][e + 2], po[i]);
          s0[i] = p0[i] > th[i] ? 1.0f : 0.0f;
          s1[i] = p1[i] > th[i] ? 1.0f : 0.0f;
        }
        const long long o = c * cfg_stride + site_g * F + fb;
        if (ok_g) {
          store_fb<2 * NT>(a.v_pre + o, p0);
          store_fb<2 * NT>(a.spikes + o, s0);
        }
        if (ok_g8) {
          store_fb<2 * NT>(a.v_pre + o + 8 * F, p1);
          store_fb<2 * NT>(a.spikes + o + 8 * F, s1);
        }
      }
    }
  });
}

// ---- the FMA route: any k, Cin and F ---------------------------------------
//
// A thread's item is one site and FB = 4 filters (F % 4 == 0; else 1): it
// reads each patch value from shared memory once and feeds it to FB
// filters, with the weights read as one FB-wide vector per k.

template <int NCFG, int FB>
__global__ void __launch_bounds__(kThreads)
p2m_conv_fma_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int F = a.f;
  const p2m::Geo& g = a.g;
  const int k = a.k, cin = g.cin;
  const int K = k * k * cin;
  float* s_w = smem;
  const float* s_vinf = s_w + K * F;
  const float* s_decay = s_vinf + NCFG * F;
  const float* s_theta = s_decay + NCFG * F;
  const float* s_pvg = s_theta + NCFG * F;
  const float* s_pvo = s_pvg + F;
  float* s_ev = smem + params_floats(K, F, NCFG);
  const auto init = [&] {          // visible after run_tiles' first sync
    for (int j = threadIdx.x; j < K * F; j += kThreads) s_w[j] = a.w[j];
    load_params<NCFG>(a, smem, K);
  };

  const int G = F / FB;                    // filter groups of a site
  const int items = kTileH * kTileW * G;
  const int row = g.in_w * cin;
  const int plane = g.in_h * row;
  const long long cfg_stride =
      g.n_tiles / g.tiles_per_img * g.ho * static_cast<long long>(g.wo) * F;

  p2m::run_tiles(g, a.events, a.n_sub, s_ev, init, [](int, int) {},
      [&](const float* ev, int, long long img, int oy0, int ox0) {
    for (int j = threadIdx.x; j < items; j += kThreads) {
      const int gi = j % G;
      const int site = j / G;
      const int ty = site / kTileW;
      const int tx = site - ty * kTileW;
      const int oy = oy0 + ty;
      const int ox = ox0 + tx;
      if (oy >= g.ho || ox >= g.wo) continue;
      const int f0 = gi * FB;
      float pvg[FB];
      load_fb<FB>(s_pvg + f0, pvg);
      const auto legs = [&](int c, float (&vinf)[FB], float (&dec)[FB]) {
        load_fb<FB>(s_vinf + c * F + f0, vinf);
        load_fb<FB>(s_decay + c * F + f0, dec);
      };
      const float* e0 = ev + ty * g.stride * row + tx * g.stride * cin;
      // every sub-slot of the window, again with the exact quotient if a
      // voltage met (0, 2^-100)
      float v[NCFG][FB];
      const auto integrate = [&](auto exact) {
#pragma unroll
        for (int c = 0; c < NCFG; ++c) {
#pragma unroll
          for (int f = 0; f < FB; ++f) v[c][f] = 0.0f;
        }
        bool tiny = false;
        for (int s = 0; s < a.n_sub; ++s) {
          float acc[FB];
          p2m::dot_generic<FB>(e0 + s * plane, row, k, cin, s_w, F, f0, acc);
          float ideal[FB];
#pragma unroll
          for (int f = 0; f < FB; ++f) ideal[f] = __fmul_rn(acc[f], a.dv_unit);
          update<decltype(exact)::value, NCFG, FB>(v, ideal, pvg, a, legs,
                                                   tiny);
        }
        return tiny;
      };
      if (integrate(std::false_type{})) integrate(std::true_type{});
      float pvo[FB];
      load_fb<FB>(s_pvo + f0, pvo);
      const long long out = ((img * g.ho + oy) * g.wo + ox) * F + f0;
#pragma unroll
      for (int c = 0; c < NCFG; ++c) {
        float th[FB], vp[FB], sp[FB];
        load_fb<FB>(s_theta + c * F + f0, th);
#pragma unroll
        for (int f = 0; f < FB; ++f) {
          vp[f] = __fadd_rn(v[c][f], pvo[f]);
          sp[f] = vp[f] > th[f] ? 1.0f : 0.0f;
        }
        store_fb<FB>(a.v_pre + c * cfg_stride + out, vp);
        store_fb<FB>(a.spikes + c * cfg_stride + out, sp);
      }
    }
  });
}

// g: the tensor-core route's geometry (in_w rounded up to even)
long long mma_shmem_floats(const p2m::Geo& g, int n_sub, int f, int n_cfg) {
  const long long px = (static_cast<long long>(n_sub) * g.in_h * g.in_w + 3) & ~3LL;
  return p2m::kStages * p2m::tile_floats(g, n_sub, 32) +
         params_floats(18, f, n_cfg) + f / 8 * 9 * 32 + 3 * px +
         2 * p2m::kStages;
}

long long fma_shmem_floats(const p2m::Geo& g, int n_sub, int f, int k,
                           int n_cfg) {
  return params_floats(k * k * g.cin, f, n_cfg) +
         p2m::kStages * p2m::tile_floats(g, n_sub);
}

// fn(std::integral_constant<int, n_cfg>{}) for n_cfg 1..8: the kernels
// keep one voltage register a config
template <typename Fn>
cudaError_t by_configs(int n_cfg, Fn&& fn) {
  switch (n_cfg) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

__global__ void quotient_check_kernel(float half_swing, float recip,
                                      unsigned long long* mismatches) {
  constexpr uint32_t kTop = 0x3f800000u;   // 1.0f
  const uint64_t n = 2ull * (kTop + 1);    // both signs
  unsigned long long bad = 0;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const uint32_t bits = i <= kTop ? static_cast<uint32_t>(i)
                                    : (static_cast<uint32_t>(i - kTop - 1) |
                                       0x80000000u);
    const float v = __uint_as_float(bits);
    bad += __float_as_uint(quotient(v, half_swing, recip)) !=
           __float_as_uint(__fdiv_rn(v, half_swing));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, bad);
}

Args make_args(const float* events, const float* w, const float* v_inf,
               const float* decay, const float* theta, const float* pv_gain,
               const float* pv_offset, float* spikes, float* v_pre,
               long long bt, int n_sub, int h, int w_dim, int cin, int ho,
               int wo, int f, int k, int stride, int pad_top, int pad_left,
               float dv_unit, float half_swing, float recip, float v_lo,
               float v_hi, int nonlinear) {
  return Args{events, w, v_inf, decay, theta, pv_gain, pv_offset, spikes,
              v_pre,
              p2m::make_geo(h, w_dim, cin, ho, wo, stride, k, pad_top,
                            pad_left, bt),
              n_sub, f, k, dv_unit, half_swing, recip, v_lo, v_hi, nonlinear,
              0};
}

}  // namespace

// Shared-memory bytes one block of the route needs (mma: 1 for
// p2m_conv_f32, 0 for p2m_conv_fma_f32), for the wrapper's check against
// the 227 KB a block may opt in to.
extern "C" long long p2m_conv_shmem_bytes(int n_sub, int cin, int f, int k,
                                          int stride, int n_cfg, int mma) {
  p2m::Geo g = p2m::make_geo(1, 1, cin, 1, 1, stride, k, 0, 0, 1);
  if (mma) g.in_w = (g.in_w + 2) & ~1;     // the most x_shift can add
  return static_cast<long long>(sizeof(float)) *
         (mma ? mma_shmem_floats(g, n_sub, f, n_cfg)
              : fma_shmem_floats(g, n_sub, f, k, n_cfg));
}

// The tensor-core route. events [B*T, n_sub, H, W, 2] (16-byte aligned, W
// even: the rows TMA reads), w [18, F] (k 3, F % 8 == 0), v_inf/decay/
// theta [n_cfg, F], pv_gain/pv_offset [F] -> spikes, v_pre [n_cfg, B*T,
// Ho, Wo, F]; all float32, contiguous. 1 <= n_cfg <= 8; recip = RN(1 /
// half_swing). Any other shape returns cudaErrorInvalidValue and launches
// nothing. Returns the cudaError_t of the launch (0 = launched).
extern "C" int p2m_conv_f32(const float* events, const float* w,
                            const float* v_inf, const float* decay,
                            const float* theta, const float* pv_gain,
                            const float* pv_offset, float* spikes,
                            float* v_pre, long long bt, int n_sub, int h,
                            int w_dim, int cin, int ho, int wo, int f, int k,
                            int stride, int pad_top, int pad_left, int n_cfg,
                            float dv_unit, float half_swing, float recip,
                            float v_lo, float v_hi, int nonlinear,
                            void* stream) {
  if (k != 3 || cin != 2 || f % 8 != 0 || w_dim % 2 != 0 ||
      reinterpret_cast<uintptr_t>(events) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(events, w, v_inf, decay, theta, pv_gain, pv_offset,
                     spikes, v_pre, bt, n_sub, h, w_dim, cin, ho, wo, f, k,
                     stride, pad_top, pad_left, dv_unit, half_swing, recip,
                     v_lo, v_hi, nonlinear);
  // TMA boxes start and end on 16 bytes: an even pixel on both sides
  a.x_shift = pad_left & 1;
  a.g.in_w = (a.g.in_w + a.x_shift + 1) & ~1;
  if (a.g.n_tiles < 1 || n_sub > 256 || a.g.in_h > 256 || 2 * a.g.in_w > 256) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  CUtensorMap map;
  const cudaError_t e = hopper::map_f32_3d(&map, events, 2LL * w_dim, h,
                                           bt * n_sub, 2 * a.g.in_w,
                                           a.g.in_h, n_sub);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t shmem = sizeof(float) * static_cast<size_t>(
      mma_shmem_floats(a.g, n_sub, f, n_cfg));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_configs(n_cfg, [&](auto c) {
    constexpr int kCfg = decltype(c)::value;
    return a.f % 16 == 0
        ? p2m::launch_persistent(p2m_conv_mma_kernel<kCfg, 2>, shmem, s,
                                 a.g.n_tiles, map, a)
        : p2m::launch_persistent(p2m_conv_mma_kernel<kCfg, 1>, shmem, s,
                                 a.g.n_tiles, map, a);
  }));
}

// The FMA route: the same arguments for any k, Cin and F.
extern "C" int p2m_conv_fma_f32(const float* events, const float* w,
                                const float* v_inf, const float* decay,
                                const float* theta, const float* pv_gain,
                                const float* pv_offset, float* spikes,
                                float* v_pre, long long bt, int n_sub, int h,
                                int w_dim, int cin, int ho, int wo, int f,
                                int k, int stride, int pad_top, int pad_left,
                                int n_cfg, float dv_unit, float half_swing,
                                float recip, float v_lo, float v_hi,
                                int nonlinear, void* stream) {
  const Args a = make_args(events, w, v_inf, decay, theta, pv_gain, pv_offset,
                           spikes, v_pre, bt, n_sub, h, w_dim, cin, ho, wo, f,
                           k, stride, pad_top, pad_left, dv_unit, half_swing,
                           recip, v_lo, v_hi, nonlinear);
  if (a.g.n_tiles < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t shmem = sizeof(float) * static_cast<size_t>(
      fma_shmem_floats(a.g, n_sub, f, k, n_cfg));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_configs(n_cfg, [&](auto c) {
    constexpr int kCfg = decltype(c)::value;
    return a.f % 4 == 0
        ? p2m::launch_persistent(p2m_conv_fma_kernel<kCfg, 4>, shmem, s,
                                 a.g.n_tiles, a)
        : p2m::launch_persistent(p2m_conv_fma_kernel<kCfg, 1>, shmem, s,
                                 a.g.n_tiles, a);
  }));
}

// Adds to *mismatches (device memory) the number of float32 v with |v| <= 1
// (both signs, zeros and subnormals included: 2,130,706,434 values) whose
// kernel quotient v / half_swing differs in any bit from __fdiv_rn's.
extern "C" int p2m_quotient_check(float half_swing, float recip,
                                  unsigned long long* mismatches,
                                  void* stream) {
  quotient_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      half_swing, recip, mismatches);
  return static_cast<int>(cudaGetLastError());
}
