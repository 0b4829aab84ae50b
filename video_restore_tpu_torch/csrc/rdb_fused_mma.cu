// K5, tensor-core route: one residual dense block (RDB) in one launch, or a
// whole RRDB in one cooperative launch, for bf16 activations at nf 64 / gc 32,
// on the tile routines of mma_tile.cuh (bf16 mma.sync m16n8k16, ldmatrix,
// cp.async).
//
// It computes exactly the function of rdb_fused.cu (see the note there):
//
//   c_k = T(lrelu(conv_k([x | c_1 .. c_{k-1}]) + b_k))     k = 1..4
//   out = T(x + 0.2 * (conv_5([x | c_1 .. c_4]) + b_5))
//   out = T(x0 + 0.2 * out)                                 (optional x0)
//
// every conv SAME (each c_k zeroed outside the frame), sums in fp32, T() the
// rounding to bf16; the RRDB is x + 0.2 RDB3(RDB2(RDB1(x))). It serves the
// same Pallas entry points of video_restore_tpu/ops as rdb_fused.cu:
//   pallas_rdb.py    rdb_fused, rrdb_fused
//   pallas_stripe.py rdb_stripe, rrdb_stripe_padded
// for the calls whose widths feed the tensor cores (ops/rdb.py::rdb_route):
// bf16 with (nf, gc) = (64, 32), every RRDBNet of the zoo. fp32 and the
// narrow (16, 8) of the checks stay on rdb_fused.cu.
//
// What bounds it on the H100: a 1080p RDB is 9.94e11 useful operations
// against ~0.5 GB of compulsory traffic, so the tensor cores bound it (1.0
// ms at the bf16 peak), and below them, as in K1 (conv3x3_mma.cu), the 128
// bytes a clock that shared memory gives `ldmatrix`. What the design does:
//  - a block owns a 12 x 12 output tile and keeps the whole dense chain in
//    shared memory: the x window (22 x 22 pixels x 64 channels) and c_1..c_4
//    on windows that shrink by 2 per conv (20, 18, 16, 14), pixel-major with
//    16 bytes of pad per pixel (144 bytes for 64 channels, 80 for 32), so
//    every `ldmatrix` row of eight neighbouring pixels falls on eight bank
//    groups (mma_tile.cuh). 163,776 bytes of windows and three 20,736-byte
//    weight stages = 225,984 bytes: one block of 256 threads per SM. The
//    halo is recomputed: 1.47x the useful MACs at this tile (1.34x at 16 x
//    16, which does not fit padded);
//  - the M side is gathered: conv k's output window (side 22 - 2k) is
//    flattened into m16 tiles, each lane hands `ldmatrix` the address of
//    its own pixel, so a tile may wrap a window row and a tap shift stays an
//    immediate offset (ky * side + kx) * pitch;
//  - a warp owns up to four m16 tiles by 32 output channels (conv5: two
//    warps per pixel set, one per half of cout), so each B fragment pair
//    meets every m tile of the warp;
//  - the weights stream through a 3-slot `cp.async` ring of 16 input
//    channels x 9 taps (mma_tile.cuh load_weights), one commit group and
//    one __syncthreads per stage, the next stage in flight during the MMAs
//    of the current one. A tile is 40 stages (4, 6, 8, 10, 12 per conv) and
//    the ring runs on across convs and tiles, since the weights are the
//    same for every tile; the next tile's x window is fetched into the same
//    groups as soon as conv5 has read its last x stage;
//  - each conv's epilogue (bias, lrelu, frame mask, rounding) writes c_k
//    straight into its window; the next stage's barrier orders it before
//    any read. conv5's epilogue adds the residual, read from device memory
//    (L2), since the x window then holds the next tile already;
//  - the grid is persistent (one block per SM, tiles strided over blocks),
//    and the RRDB form runs the three passes with two grid syncs between
//    them, the intermediates in the output buffer and one scratch.
// Sums are fp32 in the tensor cores, in another order than rdb_fused.cu's
// FMAs, so the two agree within bf16 steps of the output, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma_tile;
using bf16 = __nv_bfloat16;

constexpr int NF = 64, GC = 32;
constexpr int TILE = 12;                     // output tile side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int STAGES = 3;                    // weight slots of the ring
constexpr int TILE_STAGES = 40;              // 16-channel stages per tile

// window of source s (0: x, k: c_k); conv k's output window is side(k)
__host__ __device__ constexpr int side(int s) { return TILE + 10 - 2 * s; }
__host__ __device__ constexpr int chans(int s) { return s == 0 ? NF : GC; }
__host__ __device__ constexpr int pitch(int s) { return chans(s) * 2 + 16; }
__host__ __device__ constexpr int win_off(int s) {
  return s == 0 ? 0 : win_off(s - 1) + side(s - 1) * side(s - 1) * pitch(s - 1);
}
constexpr int WIN_BYTES = win_off(5);
constexpr int SLOT_BYTES = Weights<NF / 8>::BYTES;  // the widest stage (conv5)
constexpr int SMEM_BYTES = WIN_BYTES + STAGES * SLOT_BYTES;
static_assert(WIN_BYTES % 16 == 0 && SLOT_BYTES % 16 == 0, "alignment");
static_assert(SMEM_BYTES + 1024 <= 232448, "one block per SM");

struct RdbWeights {
  const bf16* w[5];  // HWIO (3, 3, 64 + (k-1) 32, 32 | 64), contiguous
  const bf16* b[5];
};

struct RdbArgs {
  const bf16* x;   // (B, H, W, 64) contiguous
  const bf16* x0;  // (B, H, W, 64) contiguous, or null
  bf16* y;         // (B, H, W, 64) contiguous
  bf16* scratch;   // RRDB: (B, H, W, 64), RDB2's output
  RdbWeights p[3];
  int B, H, W;
};

template <int K>
struct Conv {
  static constexpr int CIN = NF + (K - 1) * GC;
  static constexpr int NT = (K < 5 ? GC : NF) / 8;   // n8 tiles of cout
  static constexpr int NH = NT / 4;                  // 32-channel halves
  static constexpr int R = side(K);                  // output window side
  static constexpr int MT = (R * R + 15) / 16;       // m16 tiles
  static constexpr int GROUPS = kWarps / NH;         // warps per half
  static constexpr int MPW = (MT + GROUPS - 1) / GROUPS;
  static constexpr int FIRST = K * (K + 1) - 2;      // its first stage
};
static_assert(Conv<5>::FIRST + Conv<5>::CIN / KC == TILE_STAGES, "stages");

// The weight rows of stage i (0..39) of a tile: conv k, rows 16 j .. 16 j + 15
// (rows follow the growth order [x | c_1 | ..], as the stages do).
__device__ __forceinline__ void fetch_weights(const RdbWeights& p,
                                              uint32_t slot, int i, int tid) {
  if (i < Conv<2>::FIRST)
    load_weights<4, kThreads>(slot, p.w[0], Conv<1>::CIN, i * KC, tid);
  else if (i < Conv<3>::FIRST)
    load_weights<4, kThreads>(slot, p.w[1], Conv<2>::CIN,
                              (i - Conv<2>::FIRST) * KC, tid);
  else if (i < Conv<4>::FIRST)
    load_weights<4, kThreads>(slot, p.w[2], Conv<3>::CIN,
                              (i - Conv<3>::FIRST) * KC, tid);
  else if (i < Conv<5>::FIRST)
    load_weights<4, kThreads>(slot, p.w[3], Conv<4>::CIN,
                              (i - Conv<4>::FIRST) * KC, tid);
  else
    load_weights<8, kThreads>(slot, p.w[4], Conv<5>::CIN,
                              (i - Conv<5>::FIRST) * KC, tid);
}

// The x window of the tile at (n, ty0, tx0), zero outside the frame (the
// copy's zero fill). x may have been written earlier in this launch (the
// RRDB's passes), which cp.async.cg reads through L2, after the grid sync.
__device__ __forceinline__ void load_x_window(uint32_t s_base, const bf16* x,
                                              int n, int ty0, int tx0, int H,
                                              int W, int tid) {
  constexpr int S = side(0), CH = NF / 8;  // 16-byte chunks per pixel
  for (int i = tid; i < S * S * CH; i += kThreads) {
    const int pix = i / CH, c = i % CH;
    const int wy = pix / S, wx = pix - wy * S;
    const int fy = ty0 - 5 + wy, fx = tx0 - 5 + wx;
    const bool ok = fy >= 0 && fy < H && fx >= 0 && fx < W;
    const bf16* src = ok ? x + ((((long long)n * H + fy) * W + fx) * NF + c * 8) : x;
    cp_async16(s_base + pix * pitch(0) + c * 16, src, ok);
  }
}

// acc += the nine taps of one stage of conv K read from source S. a_lane:
// this lane's `ldmatrix` row address per m tile (tap (0, 0), the stage's
// channel chunk included); b_lane: the stage's weight slot plus the lane's
// offset and the warp's half of cout.
template <int K, int S>
__device__ __forceinline__ void mma_stage(float (&acc)[Conv<K>::MPW][4][4],
                                          const uint32_t (&a_lane)[Conv<K>::MPW],
                                          uint32_t b_lane, int mg) {
  using C = Conv<K>;
  constexpr int SS = side(S), P = pitch(S);
  constexpr int WP = Weights<C::NT>::PITCH;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t b[2][4];
      ldmatrix_x4_trans(b[0], b_lane + (ky * 3 + kx) * KC * WP);
      ldmatrix_x4_trans(b[1], b_lane + (ky * 3 + kx) * KC * WP + 32);
#pragma unroll
      for (int j = 0; j < C::MPW; ++j) {
        if (mg + j * C::GROUPS >= C::MT) continue;  // the same for the warp
        uint32_t a[4];
        ldmatrix_x4(a, a_lane[j] + (ky * SS + kx) * P);
        mma_16816(acc[j][0], a, b[0][0], b[0][1]);
        mma_16816(acc[j][1], a, b[0][2], b[0][3]);
        mma_16816(acc[j][2], a, b[1][0], b[1][1]);
        mma_16816(acc[j][3], a, b[1][2], b[1][3]);
      }
    }
}

// The stages of conv K that read source S (4 of 16 channels for x, 2 for a
// c_k), then those of S + 1. oy, ox: this lane's output pixel per m tile.
template <int K, int S, typename Step>
__device__ __forceinline__ void conv_sources(
    float (&acc)[Conv<K>::MPW][4][4], const int (&oy)[Conv<K>::MPW],
    const int (&ox)[Conv<K>::MPW], uint32_t s_base, uint32_t b_off, int mg,
    Step& step) {
  using C = Conv<K>;
  constexpr int SS = side(S), P = pitch(S), D = K - 1 - S;
  const int lane = threadIdx.x & 31;
  uint32_t a_lane[C::MPW];
#pragma unroll
  for (int j = 0; j < C::MPW; ++j)
    a_lane[j] = s_base + win_off(S) + ((oy[j] + D) * SS + ox[j] + D) * P +
                (lane >> 4) * 16;
#pragma unroll 1
  for (int c = 0; c < chans(S) / KC; ++c) {
    const uint32_t slot = step();
#ifndef VR_PROBE_NO_MMA  // a load-pipeline probe build
    uint32_t a_c[C::MPW];
#pragma unroll
    for (int j = 0; j < C::MPW; ++j) a_c[j] = a_lane[j] + c * 32;
    mma_stage<K, S>(acc, a_c, slot + b_off, mg);
#endif
  }
  if constexpr (S + 1 < K) conv_sources<K, S + 1>(acc, oy, ox, s_base, b_off, mg, step);
}

// Where one tile's output goes, and what the conv5 epilogue adds.
struct TileOut {
  const bf16* x;   // the RDB's input (the residual), device memory
  const bf16* x0;  // or null
  bf16* y;
  int n, ty0, tx0, H, W;
};

// Conv K of the dense chain on the block's windows, with its epilogue: c_K
// into its window (K < 5), or the tile's output (K == 5).
template <int K, typename Step>
__device__ __forceinline__ void conv(const RdbWeights& p, const TileOut& t,
                                     unsigned char* smem, Step& step) {
  using C = Conv<K>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nh = warp % C::NH, mg = warp / C::NH;
  float acc[C::MPW][4][4];
#pragma unroll
  for (int j = 0; j < C::MPW; ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
  // this lane's `ldmatrix` row: pixel (l & 7) + 8 ((l >> 3) & 1) of each m
  // tile; rows past the window read pixel 0 and are never stored
  int oy[C::MPW], ox[C::MPW];
#pragma unroll
  for (int j = 0; j < C::MPW; ++j) {
    int pix = (mg + j * C::GROUPS) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    if (pix >= C::R * C::R) pix = 0;
    oy[j] = pix / C::R;
    ox[j] = pix - oy[j] * C::R;
  }
  const uint32_t s_base = smem_u32(smem);
  conv_sources<K, 0>(acc, oy, ox, s_base, b_lane_offset<C::NT>(lane) + nh * 64,
                     mg, step);

  const bf16* bias = p.b[K - 1];
  float2 bb[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    bb[nt] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        bias + nh * 32 + frag_channel(lane, nt)));
#pragma unroll
  for (int j = 0; j < C::MPW; ++j) {
    const int mt = mg + j * C::GROUPS;
    if (mt >= C::MT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = frag_pixel(lane, 0, half) + mt * 16;
      if (pix >= C::R * C::R) continue;
      const int wy = pix / C::R, wx = pix - wy * C::R;
      if constexpr (K < 5) {
        // c_K: lrelu, zero outside the frame, rounded, into its window
        const int fy = t.ty0 - (5 - K) + wy, fx = t.tx0 - (5 - K) + wx;
        const bool in = fy >= 0 && fy < t.H && fx >= 0 && fx < t.W;
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            smem + win_off(K) + pix * pitch(K));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float v0 = __fadd_rn(acc[j][nt][half * 2], bb[nt].x);
          float v1 = __fadd_rn(acc[j][nt][half * 2 + 1], bb[nt].y);
          v0 = v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0);
          v1 = v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1);
          dst[frag_channel(lane, nt) / 2] =
              __floats2bfloat162_rn(in ? v0 : 0.f, in ? v1 : 0.f);
        }
      } else {
        // out = x + 0.2 (conv5 + b5) [then x0 + 0.2 T(out)], in the frame
        const int fy = t.ty0 + wy, fx = t.tx0 + wx;
        if (fy >= t.H || fx >= t.W) continue;
        const long long px = ((long long)t.n * t.H + fy) * t.W + fx;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int co = nh * 32 + frag_channel(lane, nt);
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(t.x + px * NF + co));
          float v0 = __fadd_rn(acc[j][nt][half * 2], bb[nt].x);
          float v1 = __fadd_rn(acc[j][nt][half * 2 + 1], bb[nt].y);
          v0 = __fadd_rn(xv.x, __fmul_rn(0.2f, v0));
          v1 = __fadd_rn(xv.y, __fmul_rn(0.2f, v1));
          if (t.x0) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(t.x0 + px * NF + co));
            const float2 o = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
            v0 = __fadd_rn(r.x, __fmul_rn(0.2f, o.x));
            v1 = __fadd_rn(r.y, __fmul_rn(0.2f, o.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(t.y + px * NF + co) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// One RDB over every tile this block owns (blockIdx.x, + gridDim.x, ...).
// p lives in shared memory. All threads of the block call it.
__device__ __forceinline__ void rdb_pass(const bf16* x, const bf16* x0,
                                         bf16* y, const RdbWeights& p, int B,
                                         int H, int W, unsigned char* smem) {
  const int tiles_x = (W + TILE - 1) / TILE;
  const int per_image = tiles_x * ((H + TILE - 1) / TILE);
  const int ntiles = B * per_image;
  if ((int)blockIdx.x >= ntiles) return;
  const int mine = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * TILE_STAGES;
  const int tid = threadIdx.x;
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_w = s_base + WIN_BYTES;

  TileOut t;
  t.x = x; t.x0 = x0; t.y = y; t.H = H; t.W = W;
  auto place = [&](int k) {  // the block's k-th tile
    const int tile = (int)blockIdx.x + k * (int)gridDim.x;
    const int rem = tile % per_image;
    t.n = tile / per_image;
    t.ty0 = (rem / tiles_x) * TILE;
    t.tx0 = (rem % tiles_x) * TILE;
  };

  place(0);
  load_x_window(s_base, x, t.n, t.ty0, t.tx0, H, W, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) fetch_weights(p, s_w + s * SLOT_BYTES, s, tid);
    cp_async_commit();
  }
  int use = 0;
  // before each stage's MMAs: the stage has landed for every thread and the
  // slot about to be refilled is free; start the stage STAGES - 1 ahead and,
  // once conv5 is past x, the next tile's x window
  auto step = [&]() -> uint32_t {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int q = use + STAGES - 1;
    if (q < total)
      fetch_weights(p, s_w + (q % STAGES) * SLOT_BYTES, q % TILE_STAGES, tid);
    if (use % TILE_STAGES == Conv<5>::FIRST + NF / KC &&
        use / TILE_STAGES + 1 < mine) {
      const int tile = (int)blockIdx.x + (use / TILE_STAGES + 1) * (int)gridDim.x;
      const int rem = tile % per_image;
      load_x_window(s_base, x, tile / per_image, (rem / tiles_x) * TILE,
                    (rem % tiles_x) * TILE, H, W, tid);
    }
    cp_async_commit();
    const uint32_t slot = s_w + (use % STAGES) * SLOT_BYTES;
    ++use;
    return slot;
  };

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    place(k);
    conv<1>(p, t, smem, step);
    conv<2>(p, t, smem, step);
    conv<3>(p, t, smem, step);
    conv<4>(p, t, smem, step);
    conv<5>(p, t, smem, step);
  }
  cp_async_wait<0>();
  __syncthreads();  // the windows and slots are free for a next pass
}

__global__ void __launch_bounds__(kThreads, 1) rdb_mma_kernel(const RdbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RdbWeights s_p;
  if (threadIdx.x == 0) s_p = a.p[0];
  __syncthreads();
  rdb_pass(a.x, a.x0, a.y, s_p, a.B, a.H, a.W, smem);
}

__global__ void __launch_bounds__(kThreads, 1) rrdb_mma_kernel(const RdbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RdbWeights s_p[3];
  if (threadIdx.x == 0) {
    s_p[0] = a.p[0];
    s_p[1] = a.p[1];
    s_p[2] = a.p[2];
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  // RDB1: x -> y; RDB2: y -> scratch; RDB3 + residual: scratch, x -> y
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {
    const bf16* src = r == 0 ? a.x : (r == 1 ? a.y : a.scratch);
    bf16* dst = r == 1 ? a.scratch : a.y;
    rdb_pass(src, r == 2 ? a.x : nullptr, dst, s_p[r], a.B, a.H, a.W, smem);
    if (r < 2) grid.sync();
  }
}

cudaError_t launch(const RdbArgs& a, bool whole, cudaStream_t stream) {
  void (*kern)(const RdbArgs) = whole ? rrdb_mma_kernel : rdb_mma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const long long ntiles = (long long)a.B * ((a.H + TILE - 1) / TILE) *
                           ((a.W + TILE - 1) / TILE);
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = ntiles < (long long)per_sm * sms ? (int)ntiles : per_sm * sms;
  if (!whole) {
    kern<<<grid, kThreads, SMEM_BYTES, stream>>>(a);
    return cudaGetLastError();
  }
  RdbArgs arg = a;
  void* params[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(kThreads), params, SMEM_BYTES, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// Fill the args from the C arrays; false for a call this kernel does not take.
bool fill(RdbArgs& a, int dtype, int nf, int gc, int rdbs, const void* x,
          const void* x0, void* y, void* scratch, const void* const* ws,
          const void* const* bs, int B, int H, int W) {
  if (dtype != 1 || nf != NF || gc != GC) return false;
  if (!aligned(x, 16) || !aligned(x0, 16) || !aligned(y, 16) ||
      !aligned(scratch, 16))
    return false;
  if ((long long)B * H * W > 0x7fffffffLL) return false;
  a = RdbArgs{};
  a.x = static_cast<const bf16*>(x);
  a.x0 = static_cast<const bf16*>(x0);
  a.y = static_cast<bf16*>(y);
  a.scratch = static_cast<bf16*>(scratch);
  for (int r = 0; r < rdbs; ++r)
    for (int k = 0; k < 5; ++k) {
      if (!aligned(ws[5 * r + k], 16) || !aligned(bs[5 * r + k], 4)) return false;
      a.p[r].w[k] = static_cast<const bf16*>(ws[5 * r + k]);
      a.p[r].b[k] = static_cast<const bf16*>(bs[5 * r + k]);
    }
  a.B = B; a.H = H; a.W = W;
  return true;
}

}  // namespace

extern "C" {

// The arguments of vr_rdb_fused (rdb_fused.cu). bf16 with (nf, gc) = (64,
// 32) only: cudaErrorInvalidValue for any other call (ops/rdb.py::rdb_route
// sends those to vr_rdb_fused). Returns the cudaError_t of the launch.
int vr_rdb_fused_mma(int dtype, int nf, int gc, const void* x, const void* x0,
                     void* y, const void* const* ws, const void* const* bs,
                     int B, int H, int W, void* stream) {
  RdbArgs a;
  if (!fill(a, dtype, nf, gc, 1, x, x0, y, nullptr, ws, bs, B, H, W))
    return cudaErrorInvalidValue;
  return launch(a, false, static_cast<cudaStream_t>(stream));
}

// The arguments of vr_rrdb_fused: a whole RRDB in one cooperative launch.
int vr_rrdb_fused_mma(int dtype, int nf, int gc, const void* x, void* y,
                      void* scratch, const void* const* ws,
                      const void* const* bs, int B, int H, int W,
                      void* stream) {
  RdbArgs a;
  if (!fill(a, dtype, nf, gc, 3, x, nullptr, y, scratch, ws, bs, B, H, W))
    return cudaErrorInvalidValue;
  return launch(a, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
