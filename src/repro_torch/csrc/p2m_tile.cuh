// The in-kernel im2col shared by the P²M conv kernel (p2m_conv.cu, K1) and
// the MAC-mode streaming fold (stream_fold.cu, K3). Both run a SAME-padded
// k x k conv over event frames [n_img, planes, H, W, Cin] (planes = the
// sub-slots of one window), one K = k*k*Cin dot product per (output site,
// filter, plane), and carry a per-(site, filter) state over the planes.
//
// Work split. An output tile is kTileH x kTileW sites of one image. A block
// is persistent: it walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
// keeps its next kStages - 1 tiles' input (every plane, with its halo,
// zeros where the padding lies) loading into a ring of shared-memory
// buffers while it computes the current one: by TMA boxes, one thread and
// one mbarrier a tile (run_tiles_tma), or by every thread's cp.async where
// a shape does not suit TMA (run_tiles).
//
// The dot products. For the paper's 3x3 kernel over ON/OFF they run on the
// tensor cores (dot_mma): a warp owns a row of 16 sites, each pixel's
// ON/OFF pair is one register of an mma.sync A fragment, loaded once per
// site for all filters, and float32 operands enter as bf16 terms. Else a
// thread's item is one site and FB filters: it reads each patch value from
// shared memory once and feeds it to FB filters (dot_generic).
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace p2m {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kThreads = 256;
constexpr int kStages = 3;     // tiles a block has staged or in flight

// n_tiles is 0 when the tiles (with a ring's lookahead) would not fit a
// 32-bit index; the launch then fails
struct Geo {
  int h, w, cin, ho, wo, stride, pad_top, pad_left;
  int in_h, in_w, tiles_x, tiles_per_img, n_tiles;
};

inline Geo make_geo(int h, int w, int cin, int ho, int wo, int stride,
                    int k, int pad_top, int pad_left, long long n_img) {
  Geo g{h, w, cin, ho, wo, stride, pad_top, pad_left,
        (kTileH - 1) * stride + k, (kTileW - 1) * stride + k,
        (wo + kTileW - 1) / kTileW, 0, 0};
  g.tiles_per_img = g.tiles_x * ((ho + kTileH - 1) / kTileH);
  const long long n = n_img * g.tiles_per_img;
  g.n_tiles = n < (1LL << 29) ? static_cast<int>(n) : 0;
  return g;
}

// floats of one staged tile (every plane), rounded up to 16 bytes, or to
// 128 bytes for a TMA destination
__host__ __device__ inline long long tile_floats(const Geo& g, int planes,
                                                 int align = 4) {
  return (static_cast<long long>(planes) * g.in_h * g.in_w * g.cin + align - 1)
         & ~static_cast<long long>(align - 1);
}

// copy B bytes global -> shared, or write B zero bytes when !valid
template <int B>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(B), "r"(valid ? B : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most the newest kStages - 1 groups are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Stage every plane of the input tile of output tile `tile` into dst
// [planes, in_h, in_w, Cin], one float a copy: a warp takes one staged row
// at a time, its lanes the row's floats, so a row's indices are worked out
// once.
__device__ __forceinline__ void stage_tile(float* dst, const float* frames,
                                           int planes, const Geo& g,
                                           int tile) {
  const int img = tile / g.tiles_per_img;
  const int t = tile - img * g.tiles_per_img;
  const int iy0 = (t / g.tiles_x) * kTileH * g.stride - g.pad_top;
  const int ix0 = (t % g.tiles_x) * kTileW * g.stride - g.pad_left;
  const float* src0 = frames + static_cast<long long>(img) * planes * g.h *
                                   g.w * g.cin;
  const int row = g.in_w * g.cin;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < planes * g.in_h; r += blockDim.x >> 5) {
    const int s = r / g.in_h;
    const int gy = iy0 + r - s * g.in_h;
    const bool row_ok = gy >= 0 && gy < g.h;
    const float* src_row =
        src0 + (static_cast<long long>(s) * g.h + (row_ok ? gy : 0)) * g.w * g.cin;
    for (int q = lane; q < row; q += 32) {
      const int x = q / g.cin;
      const int gx = ix0 + x;
      const bool ok = row_ok && gx >= 0 && gx < g.w;
      cp_async_zfill<4>(dst + r * row + q,
                        ok ? src_row + gx * g.cin + (q - x * g.cin) : frames,
                        ok);
    }
  }
}

// The persistent walk over tiles through a ring of kStages shared-memory
// buffers (s_ev: kStages * tile_floats(g, planes) floats): while
// compute(buf, slot, img, oy0, ox0) runs on one staged tile, the block's
// next kStages - 1 tiles are loading. stage_more(tile, slot) issues any
// other cp.async a tile needs into ring slot `slot`, in the same group;
// init() runs once, after the first tiles' loads are issued.
template <typename Init, typename Stage, typename Compute>
__device__ __forceinline__ void run_tiles(const Geo& g, const float* frames,
                                          int planes, float* s_ev,
                                          Init&& init, Stage&& stage_more,
                                          Compute&& compute) {
  const long long buf = tile_floats(g, planes);
  const auto stage = [&](int tile, int slot) {
    if (tile < g.n_tiles) {
      stage_tile(s_ev + slot * buf, frames, planes, g, tile);
      stage_more(tile, slot);
    }
    cp_async_commit();             // one group a tile, empty past the end
  };
  // gridDim.x <= n_tiles, so these indices stay below 2 n_tiles
  for (int i = 0; i < kStages - 1; ++i) stage(blockIdx.x + i * gridDim.x, i);
  init();                          // the block's own set-up, loads in flight
  int tile = blockIdx.x;
  for (int it = 0; tile < g.n_tiles; ++it, tile += gridDim.x) {
    const int slot = it % kStages;
    // the slot computed last round takes the tile kStages - 1 ahead
    stage(tile + (kStages - 1) * gridDim.x, (it + kStages - 1) % kStages);
    cp_async_wait_ring();          // this thread's copies of `tile` landed
    __syncthreads();               // ... and every other thread's
    const int img = tile / g.tiles_per_img;
    const int t = tile - img * g.tiles_per_img;
    compute(s_ev + slot * buf, slot, static_cast<long long>(img),
            (t / g.tiles_x) * kTileH, (t % g.tiles_x) * kTileW);
    __syncthreads();               // the slot is restaged next round
  }
}

// The same walk with the tiles brought in by TMA: issue(tile, slot, bar)
// runs on one thread and starts the tile's box loads into ring slot `slot`,
// completing their bytes on the slot's mbarrier `bar` (expect_tx included);
// every thread waits on that barrier before compute(slot, img, oy0, ox0).
// bars: kStages mbarriers in shared memory.
template <typename Init, typename Issue, typename Compute>
__device__ __forceinline__ void run_tiles_tma(const Geo& g, uint64_t* bars,
                                              Init&& init, Issue&& issue,
                                              Compute&& compute) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(bars + i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages - 1; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile < g.n_tiles) issue(tile, i, bars + i);
    }
  }
  init();                          // the block's own set-up, loads in flight
  int tile = blockIdx.x;
  for (int it = 0; tile < g.n_tiles; ++it, tile += gridDim.x) {
    const int slot = it % kStages;
    if (threadIdx.x == 0) {        // the slot computed last round
      const int ahead = tile + (kStages - 1) * gridDim.x;
      const int s2 = (it + kStages - 1) % kStages;
      if (ahead < g.n_tiles) issue(ahead, s2, bars + s2);
    }
    hopper::mbar_wait(bars + slot, (it / kStages) & 1);
    if (it == 0) __syncthreads();  // init's shared-memory writes
    const int img = tile / g.tiles_per_img;
    const int t = tile - img * g.tiles_per_img;
    compute(slot, static_cast<long long>(img), (t / g.tiles_x) * kTileH,
            (t % g.tiles_x) * kTileW);
    __syncthreads();               // the slot is refilled next round
  }
}

// Stage the rows of a per-site array [n_img, Ho, Wo, F] that tile `tile`
// covers into dst [kTileH * kTileW, F] (site = ty * kTileW + tx), VEC
// floats a copy (src 4*VEC-byte aligned, VEC divides F); sites past the
// image are left as they are.
template <int VEC>
__device__ __forceinline__ void stage_sites(float* dst, const float* src,
                                            int F, const Geo& g,
                                            int tile) {
  const int img = tile / g.tiles_per_img;
  const int t = tile - img * g.tiles_per_img;
  const int oy0 = (t / g.tiles_x) * kTileH;
  const int ox0 = (t % g.tiles_x) * kTileW;
  const int cols = min(kTileW, g.wo - ox0);
  const int rows = min(kTileH, g.ho - oy0);
  const int per_row = cols * F / VEC;
  for (int j = threadIdx.x; j < rows * per_row; j += blockDim.x) {
    const int ty = j / per_row;
    const int e = (j - ty * per_row) * VEC;
    const long long at =
        ((static_cast<long long>(img) * g.ho + oy0 + ty) * g.wo + ox0) * F + e;
    cp_async_zfill<4 * VEC>(dst + ty * kTileW * F + e, src + at, true);
  }
}

// FB floats at p (4*FB-byte aligned when FB is 2 or 4)
template <int FB>
__device__ __forceinline__ void load_fb(const float* p, float (&out)[FB]) {
  if constexpr (FB == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (FB == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int f = 0; f < FB; ++f) out[f] = p[f];
  }
}

// FB floats to p with a streaming hint (every byte is written once)
template <int FB>
__device__ __forceinline__ void store_fb(float* p, const float (&x)[FB]) {
  if constexpr (FB == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (FB == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
#pragma unroll
    for (int f = 0; f < FB; ++f) __stcs(p + f, x[f]);
  }
}

// The dot products of one site's patch (e: its top-left input in the
// staged plane, row: floats per staged row) with the FB weight columns of
// s_w [K, F] at f0 .. f0 + FB - 1 (one FB-wide load per k, k ordered kh,
// kw, Cin), each filter's terms summed in k order with FMAs.
template <int FB>
__device__ __forceinline__ void dot_generic(const float* e, int row, int k,
                                            int cin, const float* s_w, int F,
                                            int f0, float (&acc)[FB]) {
#pragma unroll
  for (int f = 0; f < FB; ++f) acc[f] = 0.0f;
  int kidx = 0;
  for (int kh = 0; kh < k; ++kh) {
    for (int kw = 0; kw < k; ++kw) {
      for (int c = 0; c < cin; ++c, ++kidx) {
        const float p = e[kh * row + kw * cin + c];
        float w[FB];
        load_fb<FB>(s_w + kidx * F + f0, w);
#pragma unroll
        for (int f = 0; f < FB; ++f) acc[f] = fmaf(p, w[f], acc[f]);
      }
    }
  }
}

// ---- the tensor-core dot product (k 3 over Cin 2) ---------------------------

using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint32_t bits(bf162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi + mid + lo (24 bits of each)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const bf162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const bf162 m = __floats2bfloat162_rn(ra, rb);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(ra - __low2float(m), rb - __high2float(m)));
}

__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float (&c)[4], uint32_t a0, uint32_t a1,
                                     uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// B fragments of one n8 tile, one bf16 term: k16 (b0, b1), k8 (b2)
struct BFrag {
  uint32_t r[3];
};

// A fragments of 16 sites, one bf16 term: k16 (4 registers), k8 (2)
struct AFrag {
  uint32_t k16[4];
  uint32_t k8[2];
};

__device__ __forceinline__ void mma_term(float (&c)[4], const AFrag& x,
                                         const BFrag& y) {
  mma16(c, x.k16, y.r[0], y.r[1]);
  mma8(c, x.k8[0], x.k8[1], y.r[2]);
}

// a: the staged tile's pixels of one sub-slot as bf16 pairs [in_h][in_w];
// (y0, x0): the input pixel of site 0 of the warp's row
__device__ __forceinline__ void load_a(AFrag& x, const uint32_t* a, int in_w,
                                       int y0, int x_g, int x_g8, int t) {
  // pixel p of the 3x3 patch is (p / 3, p % 3); k = 2 p + channel
  const int p0 = t, p1 = t + 4;
  const int o0 = (y0 + p0 / 3) * in_w + p0 % 3;
  const int o1 = (y0 + p1 / 3) * in_w + p1 % 3;
  x.k16[0] = a[o0 + x_g];
  x.k16[1] = a[o0 + x_g8];
  x.k16[2] = a[o1 + x_g];
  x.k16[3] = a[o1 + x_g8];
  const int o8 = (y0 + 2) * in_w + 2;          // pixel 8; k 18..23 are 0
  x.k8[0] = t == 0 ? a[o8 + x_g] : 0u;
  x.k8[1] = t == 0 ? a[o8 + x_g8] : 0u;
}

// The filter of column n (0..7) of n8 tile j. With F % 16 == 0 the kernels
// take the n8 tiles in pairs (NT = 2), and a pair's 16 filters are laid out
// so that lane (g, t), which holds columns 2t and 2t + 1 of both tiles,
// holds filters 4t .. 4t + 3 of the pair: one 16-byte run a site for each
// store. Else column n is filter 8 j + n (2 filters a lane).
__device__ __forceinline__ int tile_filter(int j, int n, int F) {
  return F % 16 == 0 ? 16 * (j >> 1) + 4 * (n >> 1) + 2 * (j & 1) + (n & 1)
                     : 8 * j + n;
}

// B fragments of w [18, F] (global) for every n8 tile and bf16 term, into
// s_b [F / 8][term][3][32 lanes] (k pairs 2t, 2t + 8, 2t + 16 of filter
// tile_filter(j, lane / 4); k 18..23 zero); true if some weight is not
// one bf16.
__device__ __forceinline__ bool build_bfrags(uint32_t* s_b, const float* w,
                                             int F) {
  bool inexact = false;
  for (int i = threadIdx.x; i < F / 8 * 32; i += blockDim.x) {
    const int j = i >> 5, l = i & 31;
    const int f = tile_filter(j, l >> 2, F), t2 = 2 * (l & 3);
    const auto wk = [&](int k) { return k < 18 ? w[k * F + f] : 0.0f; };
    uint32_t* b = s_b + j * 9 * 32 + l;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      uint32_t hi, mid, lo;
      split3(wk(t2 + 8 * r), wk(t2 + 8 * r + 1), hi, mid, lo);
      b[r * 32] = hi;
      b[(3 + r) * 32] = mid;
      b[(6 + r) * 32] = lo;
      inexact |= mid != 0u;
    }
  }
  return inexact;
}

// lane's fragment of n8 tile j, bf16 term `term`, from build_bfrags' s_b
__device__ __forceinline__ BFrag bfrag(const uint32_t* s_b, int j, int term,
                                       int lane) {
  BFrag b;
#pragma unroll
  for (int r = 0; r < 3; ++r) b.r[r] = s_b[(j * 9 + term * 3 + r) * 32 + lane];
  return b;
}

// The staged float pixels (ON/OFF pairs) of a tile as bf16 terms hi, mid,
// lo into s_ab [3][px4]; true if some value of this thread's share is not
// one bf16 (the caller votes with __syncthreads_or).
__device__ __forceinline__ bool convert_tile(const float* ev, uint32_t* s_ab,
                                             int px, int px4) {
  bool inexact = false;
  for (int i = threadIdx.x; i < px; i += blockDim.x) {
    const float2 e = reinterpret_cast<const float2*>(ev)[i];
    uint32_t hi, mid, lo;
    split3(e.x, e.y, hi, mid, lo);
    s_ab[i] = hi;
    s_ab[px4 + i] = mid;
    s_ab[2 * px4 + i] = lo;
    inexact |= mid != 0u;
  }
  return inexact;
}

// acc[j] = the dot products of a warp's 16 sites (A from the sub-slot's
// bf16 planes: plane, plane + px4, plane + 2 px4) with n8 tiles n0/8 + j,
// over the terms the exactness of each operand needs
template <int NT>
__device__ __forceinline__ void dot_mma(float (&acc)[NT][4],
                                        const uint32_t* plane, int px4,
                                        int in_w, int y0, int x_g, int x_g8,
                                        int t, const BFrag (&bh)[NT],
                                        const uint32_t* s_b, int j0, int lane,
                                        bool a_exact, bool w_exact) {
  AFrag ah;
  load_a(ah, plane, in_w, y0, x_g, x_g8, t);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    mma_term(acc[j], ah, bh[j]);
  }
  if (!w_exact) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_term(acc[j], ah, bfrag(s_b, j0 + j, 1, lane));
      mma_term(acc[j], ah, bfrag(s_b, j0 + j, 2, lane));
    }
  }
  if (!a_exact) {
    AFrag am, al;
    load_a(am, plane + px4, in_w, y0, x_g, x_g8, t);
    load_a(al, plane + 2 * px4, in_w, y0, x_g, x_g8, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_term(acc[j], am, bh[j]);
      mma_term(acc[j], al, bh[j]);
      if (!w_exact) mma_term(acc[j], am, bfrag(s_b, j0 + j, 1, lane));
    }
  }
}

// Blocks of a persistent launch: as many as fit on the card at once, and
// no more than there are tiles.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t shmem, int n_tiles,
                              unsigned* blocks) {
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, shmem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned>(n_tiles < fit ? n_tiles : fit);
  return cudaSuccess;
}

// kernel<<<persistent blocks, kThreads, shmem, stream>>>(params...)
template <typename Kernel, typename... Params>
cudaError_t launch_persistent(Kernel kernel, size_t shmem, cudaStream_t stream,
                              int n_tiles, const Params&... params) {
  unsigned blocks = 0;
  const cudaError_t e = persistent_blocks(kernel, shmem, n_tiles, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, shmem, stream>>>(params...);
  return cudaGetLastError();
}

}  // namespace p2m
