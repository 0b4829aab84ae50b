// K6, tensor-core route: the RRDBNet tail in one launch, upconv2 -> conv_hr ->
// conv_last, for bf16 activations at nf 64, on the tile routines of
// mma_tile.cuh (bf16 mma.sync m16n8k16, ldmatrix, cp.async).
//
// It computes exactly the function of tail_fused.cu (see the note there):
//
//   u2  = T(lrelu(conv_up2(nearest2x(x)) + b_up2))     (B, 2 H2, 2 W2, 64)
//   hr  = T(lrelu(conv_hr(u2) + b_hr))                 (B, 2 H2, 2 W2, 64)
//   out = T(conv_last(hr) + b_last)                    (B, 2 H2, 2 W2, 3)
//
// every conv SAME at the 2 H2 x 2 W2 frame, T() the rounding to bf16, u2 and
// hr never in device memory. It serves video_restore_tpu/ops/pallas_tail.py
// tail_fused_q (the VRT_TAIL_Q=1 tail) for the calls whose widths feed the
// tensor cores (ops/tail.py::tail_fused_route): bf16 at nf 64, every RRDBNet
// of the zoo. fp32 and the narrow nf 16 of the checks stay on tail_fused.cu.
//
// It adds products in the order of K1's tensor-core route (conv3x3_mma.cu):
// 16 input channels per stage in order, the nine taps in order within a
// stage, the same m16n8k16 MMA from zero, and repeats that kernel's epilogue
// (bias, lrelu 0.2, rounding, zero outside the frame); conv_last stays on
// fp32 FMAs in the order of K1's FMA kernel (conv3x3.cu: input channel, then
// ky, kx). So the tail equals the three-launch chain (ops/tail.py::
// tail_fused) bit for bit, as K5's route equals K1's five launches.
//
// What bounds it on the H100: at nf 64 a 7680x4320 frame is 4.89e12 useful
// operations in the two wide convs (upconv2 as 9 taps on the fine grid) plus
// 1.15e11 in conv_last, against 1.26 GB of compulsory traffic (x in, RGB
// out): the tensor cores bound it (3.7 ms at the bf16 peak with upconv2 in
// phase form; the phase form sums in another order than K1, so it is not
// used). What the design does:
//  - a block owns a 16 x 28 output tile and holds, pixel-major with a 16 B
//    pad per pixel (144 B, so each `ldmatrix` row of eight pixels falls on
//    eight bank groups), the coarse x window (12 x 18), and the u2 window
//    (20 x 32 = 40 m16 tiles); once conv_hr has read u2, a barrier lets hr
//    (18 x 30 = 34 m16 tiles) take its place, so 16 x 28 fits beside a
//    3-slot weight ring (195,216 B, one block of 8 warps per SM). The halo is
//    recomputed: 1.43x upconv2's useful MACs, 1.21x conv_hr's;
//  - upconv2 reads x through the nearest-2x map: each lane's `ldmatrix` row
//    address is the coarse pixel ((wy + ky + 1) >> 1, (wx + kx + 1) >> 1) of
//    the window, a base plus a per-lane step of 0 or 1 pixel at the middle
//    tap; no 2x copy exists. conv_hr's m16 tiles are gathered (a tile may
//    wrap a window row), so its tap shifts are immediate offsets;
//  - a warp owns up to five m16 tiles by all 64 output channels (160 fp32
//    accumulators a thread): per tap, four `ldmatrix.x4.trans` of B feed
//    each m tile's eight MMAs, and each A fragment feeds eight;
//  - the weights stream through a 3-slot `cp.async` ring of 16 input
//    channels x 9 taps (mma_tile.cuh load_weights), one commit group and one
//    barrier per stage, eight stages per tile, running on across the two
//    convs and across tiles; the next tile's x window joins the group of
//    conv_hr's first stage, once upconv2 has read x;
//  - conv_last reads the hr window from shared memory, a thread per pair of
//    output pixels, its weights as one fp32 float4 per (tap, channel);
//  - the grid is persistent: one block per SM, tiles strided over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using bf16 = __nv_bfloat16;

constexpr int NF = 64;
constexpr int NT = NF / 8;                 // n8 tiles: a warp takes all couts
constexpr int TH = 16, TW = 28;            // output tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int STAGES = 3;                  // weight slots of the ring
constexpr int CONV_STAGES = NF / KC;       // 16-channel stages per conv
constexpr int TILE_STAGES = 2 * CONV_STAGES;
constexpr int P = NF * 2 + 16;             // bytes per window pixel
constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;  // x window, coarse grid
constexpr int UH = TH + 4, UW = TW + 4;          // u2: the tile + 2 px
constexpr int HH = TH + 2, HW = TW + 2;          // hr: the tile + 1 px
constexpr int U_MT = UH * UW / 16;               // m16 tiles of u2
constexpr int H_MT = (HH * HW + 15) / 16;        // m16 tiles of hr
constexpr int MPW = 5;                           // m16 tiles per warp
constexpr int SLOT = Weights<NT>::BYTES;
constexpr int X_OFF = 0;
constexpr int U_OFF = X_OFF + XH * XW * P;       // u2, then hr
constexpr int W_OFF = U_OFF + UH * UW * P;
constexpr int L_OFF = W_OFF + STAGES * SLOT;     // conv_last: float4 per (tap, ci)
constexpr int LB_OFF = L_OFF + 9 * NF * 16;      // conv_last's bias (3 floats)
constexpr int B_OFF = LB_OFF + 16;               // b_up2, b_hr as fp32
constexpr int SMEM_BYTES = B_OFF + 2 * NF * 4;
static_assert(TH % 2 == 0 && TW % 2 == 0, "even tiles: coarse windows");
static_assert(UH * UW % 16 == 0 && UW % 16 == 0, "u2's m16 tiles are half rows");
static_assert(U_MT <= MPW * kWarps && H_MT <= MPW * kWarps, "warp share");
static_assert(HH * HW <= UH * UW, "hr takes u2's place");
static_assert(U_OFF % 16 == 0 && W_OFF % 16 == 0 && L_OFF % 16 == 0, "alignment");
static_assert(SMEM_BYTES + 1024 <= 232448, "one block per SM");

struct TailArgs {
  const bf16* x;       // (B, H2, W2, 64) contiguous
  bf16* y;             // (B, 2 H2, 2 W2, 3) contiguous
  const bf16* w_up2;   // HWIO (3, 3, 64, 64)
  const bf16* b_up2;   // (64,)
  const bf16* w_hr;    // HWIO (3, 3, 64, 64)
  const bf16* b_hr;    // (64,)
  const bf16* w_last;  // HWIO (3, 3, 64, 3)
  const bf16* b_last;  // (3,)
  int B, H2, W2;
};

// Where one tile lies.
struct Tile {
  int n, ty0, tx0, OH, OW;
};

// The weight rows of stage i (0..7) of a tile: upconv2's, then conv_hr's.
__device__ __forceinline__ void fetch_weights(const TailArgs& a, uint32_t slot,
                                              int i, int tid) {
  if (i < CONV_STAGES)
    load_weights<NT, kThreads>(slot, a.w_up2, NF, i * KC, tid);
  else
    load_weights<NT, kThreads>(slot, a.w_hr, NF, (i - CONV_STAGES) * KC, tid);
}

// The coarse x window of the tile at (n, ty0, tx0): rows ty0 / 2 - 2 ..,
// columns tx0 / 2 - 2 .., zero outside x (the copy's zero fill), which is
// SAME padding on the 2x grid for upconv2.
__device__ __forceinline__ void load_x_window(uint32_t s_base, const bf16* x,
                                              int n, int ty0, int tx0, int H2,
                                              int W2, int tid) {
  constexpr int CH = NF / 8;  // 16-byte chunks per pixel
  for (int i = tid; i < XH * XW * CH; i += kThreads) {
    const int pix = i / CH, c = i % CH;
    const int wy = pix / XW, wx = pix - wy * XW;
    const int cy = (ty0 >> 1) - 2 + wy, cx = (tx0 >> 1) - 2 + wx;
    const bool ok = cy >= 0 && cy < H2 && cx >= 0 && cx < W2;
    const bf16* src =
        ok ? x + ((((long long)n * H2 + cy) * W2 + cx) * NF + c * 8) : x;
    cp_async16(s_base + X_OFF + pix * P + c * 16, src, ok);
  }
}

__device__ __forceinline__ void zero(float (&acc)[MPW][NT][4]) {
#pragma unroll
  for (int j = 0; j < MPW; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
}

// This lane's `ldmatrix` row of m16 tile mt: pixel (l & 7) + 8 ((l >> 3) & 1).
__device__ __forceinline__ int lane_pixel(int mt, int lane) {
  return mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
}

// The B fragments of one tap: n8 tiles 2 np and 2 np + 1 in b[np].
__device__ __forceinline__ void load_b(uint32_t (&b)[NT / 2][4], uint32_t addr) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) ldmatrix_x4_trans(b[np], addr + np * 32);
}

__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[NT / 2][4]) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    mma_16816(acc[2 * np], a, b[np][0], b[np][1]);
    mma_16816(acc[2 * np + 1], a, b[np][2], b[np][3]);
  }
}

// upconv2 over the u2 window (40 m16 tiles: warp w owns w, w + 8, ..): the
// four stages of 16 input channels, read from the coarse x window through the
// nearest-2x map.
template <typename Step>
__device__ __forceinline__ void conv_up2(float (&acc)[MPW][NT][4],
                                         uint32_t s_base, Step& step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // u2 pixel (wy, wx), tap (ky, kx) reads x window pixel
  // ((wy + ky + 1) >> 1, (wx + kx + 1) >> 1): the base at tap 0, one row or
  // column more at tap 2, and at tap 1 one more where wy (wx) is even
  uint32_t base[MPW], r1[MPW], c1[MPW];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int pix = lane_pixel(warp + j * kWarps, lane);
    const int wy = pix / UW, wx = pix % UW;
    base[j] = s_base + X_OFF + (((wy + 1) >> 1) * XW + ((wx + 1) >> 1)) * P +
              (lane >> 4) * 16;
    r1[j] = (wy & 1) ? 0u : (uint32_t)(XW * P);
    c1[j] = (wx & 1) ? 0u : (uint32_t)P;
  }
  const uint32_t b_off = b_lane_offset<NT>(lane);
#pragma unroll 1
  for (int c = 0; c < CONV_STAGES; ++c) {
    const uint32_t slot = step();
#ifndef VR_PROBE_NO_MMA  // tools/probe_k6.py: the load pipeline alone
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t b[NT / 2][4];
        load_b(b, slot + b_off + (ky * 3 + kx) * KC * Weights<NT>::PITCH);
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          if (warp + j * kWarps >= U_MT) continue;  // the same for the warp
          const uint32_t ro = ky == 0 ? 0u : (ky == 1 ? r1[j] : (uint32_t)(XW * P));
          const uint32_t co = kx == 0 ? 0u : (kx == 1 ? c1[j] : (uint32_t)P);
          uint32_t av[4];
          ldmatrix_x4(av, base[j] + c * 32 + ro + co);
          mma_row(acc[j], av, b);
        }
      }
#endif
  }
}

// conv_hr over the hr window (34 gathered m16 tiles), read from the u2 window.
template <typename Step>
__device__ __forceinline__ void conv_hr(float (&acc)[MPW][NT][4],
                                        uint32_t s_base, Step& step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t base[MPW];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    int pix = lane_pixel(warp + j * kWarps, lane);
    if (pix >= HH * HW) pix = 0;  // rows past the window: read, never stored
    const int oy = pix / HW, ox = pix - oy * HW;
    base[j] = s_base + U_OFF + (oy * UW + ox) * P + (lane >> 4) * 16;
  }
  const uint32_t b_off = b_lane_offset<NT>(lane);
#pragma unroll 1
  for (int c = 0; c < CONV_STAGES; ++c) {
    const uint32_t slot = step();
#ifndef VR_PROBE_NO_MMA
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t b[NT / 2][4];
        load_b(b, slot + b_off + (ky * 3 + kx) * KC * Weights<NT>::PITCH);
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          if (warp + j * kWarps >= H_MT) continue;
          uint32_t av[4];
          ldmatrix_x4(av, base[j] + c * 32 + (ky * UW + kx) * P);
          mma_row(acc[j], av, b);
        }
      }
#endif
  }
}

// conv3x3_mma.cu's epilogue into a window: bias, lrelu 0.2, zero outside the
// frame, rounded to bf16. R x C: the window (its m16 tiles, MT of them),
// starting HALO pixels before the tile; bias: fp32 in shared memory.
template <int R, int C, int MT, int HALO>
__device__ __forceinline__ void epilogue(const float (&acc)[MPW][NT][4],
                                         unsigned char* smem, const float* bias,
                                         const Tile& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int mt = warp + j * kWarps;
    if (mt >= MT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = frag_pixel(lane, 0, half) + mt * 16;
      if (pix >= R * C) continue;
      const int wy = pix / C, wx = pix - wy * C;
      const int fy = t.ty0 - HALO + wy, fx = t.tx0 - HALO + wx;
      const bool in = fy >= 0 && fy < t.OH && fx >= 0 && fx < t.OW;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(smem + U_OFF + pix * P);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = frag_channel(lane, nt);
        float v0 = __fadd_rn(acc[j][nt][half * 2], bias[co]);
        float v1 = __fadd_rn(acc[j][nt][half * 2 + 1], bias[co + 1]);
        v0 = v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0);
        v1 = v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1);
        dst[co / 2] = __floats2bfloat162_rn(in ? v0 : 0.f, in ? v1 : 0.f);
      }
    }
  }
}

// element i (0..7) of eight bf16 as fp32 (exact)
__device__ __forceinline__ float bf_elem(const uint4& v, int i) {
  const uint32_t w = (&v.x)[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// conv_last on the hr window: a thread per pair of output pixels, sums in the
// order of conv3x3.cu (channel, then ky, kx), then its epilogue.
__device__ __forceinline__ void last_stage(const unsigned char* smem, bf16* y,
                                           const Tile& t) {
#ifndef VR_PROBE_NO_LAST  // tools/probe_k6.py: the wide convs alone
  const float4* wl = reinterpret_cast<const float4*>(smem + L_OFF);
  const float* bl = reinterpret_cast<const float*>(smem + LB_OFF);
  constexpr int PAIRS = TW / 2;
  for (int item = threadIdx.x; item < TH * PAIRS; item += kThreads) {
    const int row = item / PAIRS, col = (item - row * PAIRS) * 2;
    const unsigned char* hr = smem + U_OFF + (row * HW + col) * P;
    float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll 1
    for (int c8 = 0; c8 < NF / 8; ++c8) {
      uint4 v[3][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[ky][j] = *reinterpret_cast<const uint4*>(hr + (ky * HW + j) * P + c8 * 16);
#pragma unroll
      for (int ci = 0; ci < 8; ++ci)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4 w = wl[(ky * 3 + kx) * NF + c8 * 8 + ci];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const float xv = bf_elem(v[ky][p + kx], ci);
              acc[p][0] = fmaf(xv, w.x, acc[p][0]);
              acc[p][1] = fmaf(xv, w.y, acc[p][1]);
              acc[p][2] = fmaf(xv, w.z, acc[p][2]);
            }
          }
    }
    const int fy = t.ty0 + row;
    if (fy >= t.OH) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int fx = t.tx0 + col + p;
      if (fx >= t.OW) continue;
      const long long pix = ((long long)t.n * t.OH + fy) * t.OW + fx;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        y[pix * 3 + c] = __float2bfloat16_rn(__fadd_rn(acc[p][c], bl[c]));
    }
  }
#endif
}

__global__ void __launch_bounds__(kThreads, 1) tail_mma_kernel(const TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int OH = 2 * a.H2, OW = 2 * a.W2;
  const int tiles_x = (OW + TW - 1) / TW;
  const int per_image = tiles_x * ((OH + TH - 1) / TH);
  const int ntiles = a.B * per_image;
  if ((int)blockIdx.x >= ntiles) return;
  const int mine = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * TILE_STAGES;
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_w = s_base + W_OFF;

  // conv_last's weights as fp32 (the three couts of a (tap, ci) in one
  // float4) and the three biases; read after the first stage's barrier
  float4* s_last = reinterpret_cast<float4*>(smem + L_OFF);
  for (int i = tid; i < 9 * NF; i += kThreads)
    s_last[i] = make_float4(__bfloat162float(a.w_last[i * 3]),
                            __bfloat162float(a.w_last[i * 3 + 1]),
                            __bfloat162float(a.w_last[i * 3 + 2]), 0.f);
  float* s_bias = reinterpret_cast<float*>(smem + B_OFF);
  for (int i = tid; i < 2 * NF; i += kThreads)
    s_bias[i] = __bfloat162float(i < NF ? a.b_up2[i] : a.b_hr[i - NF]);
  if (tid < 3)
    reinterpret_cast<float*>(smem + LB_OFF)[tid] = __bfloat162float(a.b_last[tid]);

  Tile t;
  t.OH = OH; t.OW = OW;
  auto place = [&](int k) {  // the block's k-th tile
    const int tile = (int)blockIdx.x + k * (int)gridDim.x;
    const int rem = tile % per_image;
    t.n = tile / per_image;
    t.ty0 = (rem / tiles_x) * TH;
    t.tx0 = (rem % tiles_x) * TW;
  };

  place(0);
  load_x_window(s_base, a.x, t.n, t.ty0, t.tx0, a.H2, a.W2, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) fetch_weights(a, s_w + s * SLOT, s, tid);
    cp_async_commit();
  }
  int use = 0;
  // before each stage's MMAs: the stage has landed for every thread and the
  // slot about to be refilled is free; start the stage STAGES - 1 ahead and,
  // once upconv2 is past x, the next tile's x window
  auto step = [&]() -> uint32_t {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int q = use + STAGES - 1;
    if (q < total) fetch_weights(a, s_w + (q % STAGES) * SLOT, q % TILE_STAGES, tid);
    if (use % TILE_STAGES == CONV_STAGES && use / TILE_STAGES + 1 < mine) {
      const int tile = (int)blockIdx.x + (use / TILE_STAGES + 1) * (int)gridDim.x;
      const int rem = tile % per_image;
      load_x_window(s_base, a.x, tile / per_image, (rem / tiles_x) * TH,
                    (rem % tiles_x) * TW, a.H2, a.W2, tid);
    }
    cp_async_commit();
    const uint32_t slot = s_w + (use % STAGES) * SLOT;
    ++use;
    return slot;
  };

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    place(k);
    float acc[MPW][NT][4];
    zero(acc);
    conv_up2(acc, s_base, step);
    // u2 into its window: its last reader (the previous tile's conv_last)
    // finished before this tile's first stage barrier
    epilogue<UH, UW, U_MT, 2>(acc, smem, s_bias, t);
    zero(acc);
    conv_hr(acc, s_base, step);
    __syncthreads();  // every warp has read u2: hr takes its place
    epilogue<HH, HW, H_MT, 1>(acc, smem, s_bias + NF, t);
    __syncthreads();
    last_stage(smem, a.y, t);
  }
  cp_async_wait<0>();
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

cudaError_t launch(const TailArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      tail_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tail_mma_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const long long ntiles = (long long)a.B * ((2LL * a.H2 + TH - 1) / TH) *
                           ((2LL * a.W2 + TW - 1) / TW);
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_mma_kernel,
                                                    kThreads, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = ntiles < (long long)per_sm * sms ? (int)ntiles : per_sm * sms;
  tail_mma_kernel<<<grid, kThreads, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of vr_tail_fused (tail_fused.cu). bf16 at nf 64 with x and
// the two wide weights 16-byte aligned only: cudaErrorInvalidValue for any
// other call (ops/tail.py::tail_fused_route sends those to vr_tail_fused).
// Returns the cudaError_t of the launch.
int vr_tail_fused_mma(int dtype, int nf, const void* x, void* y,
                      const void* w_up2, const void* b_up2, const void* w_hr,
                      const void* b_hr, const void* w_last, const void* b_last,
                      int B, int H2, int W2, void* stream) {
  if (dtype != 1 || nf != NF || B <= 0 || H2 <= 0 || W2 <= 0)
    return cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w_up2, 16) || !aligned(w_hr, 16) ||
      !aligned(b_up2, 2) || !aligned(b_hr, 2) || !aligned(y, 2))
    return cudaErrorInvalidValue;
  TailArgs a;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.w_up2 = static_cast<const bf16*>(w_up2);
  a.b_up2 = static_cast<const bf16*>(b_up2);
  a.w_hr = static_cast<const bf16*>(w_hr);
  a.b_hr = static_cast<const bf16*>(b_hr);
  a.w_last = static_cast<const bf16*>(w_last);
  a.b_last = static_cast<const bf16*>(b_last);
  a.B = B; a.H2 = H2; a.W2 = W2;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
