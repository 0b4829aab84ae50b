// K1, Hopper route: SAME 3x3 convolution on NHWC bf16 activations, HWIO bf16
// weights, as an implicit GEMM on `wgmma` fed by TMA.
//
// It computes the function of conv3x3.cu and conv3x3_mma.cu (bias, act in
// {none, lrelu 0.2, PReLU}, r1 + s1 * v, r2 + s2 * T(v), `up2` input read
// through nearest 2x with zero padding on the 2x grid, every activation
// operand a channel-prefix view with its own pixel stride, `out` possibly a
// channel slice of a wider buffer) for the calls that conv3x3_mma.cu takes:
// bf16, cin a multiple of 16, cout 32 or 64, 16-byte-aligned operands. x
// may also carry a tail (not with `up2`): KC-channel blocks of a contiguous
// (blocks, B, H, W, KC) tensor whose channels follow x's (the RDB's c1 ..
// c4, ops/stripe.py). It serves the same Pallas entry points:
//   pallas_stripe.py rdb_stripe2d_split / rdb_stripe2d_padded /
//                    rdb_res_stripe2d_padded / rdb_stripe_padded /
//                    rdb_res_stripe_padded (the five dense-block convs)
//   pallas_tail.py   conv3x3_fused (conv_body + residual), up1_fused (up2),
//                    tail_fused_raw / tail_fused (upconv2 and conv_hr, where
//                    the tail runs as three launches)
//   pallas_srvgg.py  srvgg_stripe2d_split / srvgg_stripe2d_padded /
//                    srvgg_stripe_padded (the chained conv + PReLU body)
//
// The GEMM: M = output pixels (a `wgmma` m64 tile = 64 neighbouring pixels
// of one output row), N = cout (32 or 64), K = 9 taps x cin, KC = 32 input
// channels a stage (two k16 steps). What bounds it on the H100: the tensor
// cores for conv5 and the 64 -> 64 convs, device memory for the four
// 32-wide dense-block convs (tools/probe_k1.py prints both terms per conv).
// The design:
//
//  - A (the input window, (TH + 2) x (TW + 2) pixels of KC channels) in
//    shared memory, K-major, one pixel a 64-byte row in the 64-byte swizzle
//    that TMA writes and `wgmma` reads: a tap's (dy, dx) shift moves only
//    the descriptor's start address by (dy * PW + dx) * 64 bytes (the
//    swizzle follows the address bits, so no base offset), and one window
//    serves the nine taps of every output row. (A first design kept 16-byte
//    pixels, no swizzle, in planes of 8 channels: TMA's 16-byte box rows
//    then held the ring to 2.4 ms of loads a 1080p RDB.)
//  - B (the weights) N-major (HWIO's cout-contiguous rows, `wgmma`'s
//    transpose bit) in the 128-byte (cout 64) or 64-byte (cout 32) swizzle.
//    Where all of a conv's weights fit VR_WG_RESIDENT bytes (every conv but
//    the RDB's conv5), they are loaded once per block and stay resident;
//    else each stage carries its KC channels' weights.
//  - TMA with `mbarrier`s: one thread of a producer warpgroup keeps a ring
//    of stages in flight: the window (a 4-D tensor map over (channels, W,
//    H, B) whose W stride is the view's pixel stride, out-of-bounds reads
//    zero-filled: SAME padding at every edge, no per-thread address
//    bookkeeping; a 5-D map over the tail's blocks for its stages) and,
//    streamed, the weights (a 3-D map over (cout, cin, 9)).
//  - The nearest-2x producer (`up2`: up1, and upconv2 where the tail runs as
//    three launches): a TMA box copies the tensor as it lies, and the 2x
//    grid is not one. So the producer warpgroup's 128 threads fill each
//    stage's window at the fine grid themselves: one 16-byte `cp.async` a
//    (fine pixel, 8 channels) from coarse pixel (y >> 1, x >> 1) into the
//    swizzled address TMA would have written, zero fill outside the 2x
//    frame (SAME padding there) and past cin; each thread waits for its
//    copies of the stage before, fences them to the async proxy and arrives
//    on that stage's full barrier (128 arrivals, and the weights' expect_tx
//    where they stream). The consumers are the same.
//  - Two consumer warpgroups share each tile, RPC = 2 output rows each (two
//    64 x cout fp32 accumulators a thread); per stage a warpgroup issues 18
//    `wgmma`s a k16 step, commits them, and releases the stage before once
//    that group has completed (wait_group 1). setmaxnreg hands the
//    producer's registers to the consumers.
//  - A persistent grid (one block an SM) walks the tiles, row-major within
//    an image; the producer runs ahead across tiles.
//  - The epilogue reads the accumulator layout of `wgmma` (warp w of the
//    warpgroup rows 16 w .. 16 w + 15, lane 4 g + q: rows g and g + 8,
//    columns 8 i + 2 q and + 1), applies bias, act, r1 and r2 with
//    conv3x3.cu's arithmetic and rounding points, and stores bf16 pairs
//    from registers, a row's residuals loaded before its first store;
//    partial tiles mask their stores.
// Measured with the `up2` producer (NVIDIA H100 80GB HBM3, 700 W; up1,
// 1x1080x1920x64 -> 2160x3840, lrelu): 1.832 ms against conv3x3_mma.cu's
// 2.101 in the same run (chip_smoke.py [k1]; tools/probe_k1.py --route
// wgmma: 1.861-1.872 against 2.105-2.169), 334 TFLOP/s of 9-tap work, the
// same bits; its bound is 0.396 ms of bytes, 0.618 of 9-tap operations.
// Measured and not kept (tools/probe_k1.py; PERF.md): 16-byte stores after
// a transpose in each quad, staging the tile for a TMA store (with r1 by
// TMA), consumer warpgroups on tiles of their own (ping-pong), 8-row tiles
// (they spill at the 168 registers of 384 threads), two blocks an SM,
// streaming stores. What holds it (probe, 1x1080x1920 RDB): the epilogue's
// stores, 1.5-1.6 ms alone in a growth buffer's 64-byte slices of 384-byte
// pixels, which a PyTorch copy writes no faster; hence the tail.
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// got through cudaGetDriverEntryPointByVersion: no link flag; the helpers
// are wgmma_tile.cuh's, shared with K5's rdb_fused_wgmma.cu) from the
// dims, byte strides and boxes that ops/tail.py::wgmma_plan computes, and
// passed as __grid_constant__ parameters. The tile, ring depths, stage
// width and resident bytes are compile-time (-DVR_WG_*; tools/probe_k1.py
// --route wgmma builds and times variants); vr_conv3x3_wgmma_config reports
// the build's, and the plan must match them. Sums are fp32 in the tensor
// cores, in another order than the other routes', so the routes agree
// within a bf16 step of the output, not bit for bit.

#include <stdint.h>

#include "wgmma_tile.cuh"

#ifndef VR_WG_CONSUMERS
#define VR_WG_CONSUMERS 2  // consumer warpgroups a block, sharing each tile
#endif
#ifndef VR_WG_ROWS
#define VR_WG_ROWS 2  // output rows (m64 tiles) a consumer warpgroup
#endif
#ifndef VR_WG_STAGES
#define VR_WG_STAGES 3  // depth of the ring of windows and weights
#endif
#ifndef VR_WG_STAGES_RES
#define VR_WG_STAGES_RES 4  // depth of the ring of windows, weights resident
#endif
#ifndef VR_WG_CTAS
#define VR_WG_CTAS 1  // blocks an SM (the plan's grid and __launch_bounds__)
#endif
#ifndef VR_WG_KC
#define VR_WG_KC 32  // input channels a stage: one TMA box row a pixel
#endif
#ifndef VR_WG_RESIDENT
// bytes of weights a block keeps resident for the whole launch (0: none);
// larger weights stream through the ring with the window
#define VR_WG_RESIDENT 98304
#endif

namespace {

using namespace wgmma_tile;

constexpr int NC = VR_WG_CONSUMERS, RPC = VR_WG_ROWS, STAGES = VR_WG_STAGES;
constexpr int CTAS = VR_WG_CTAS;
constexpr int TH = NC * RPC;  // output rows of a tile
constexpr int TW = 64;        // output pixels of a tile row: one m64
constexpr int PH = TH + 2, PW = TW + 2;
constexpr int KC = VR_WG_KC;   // input channels a stage
constexpr int KS = KC / 16;    // k16 steps a stage
constexpr int A_ROW = KC * 2;  // bytes of a window pixel: one swizzle row
static_assert(KC == 16 || KC == 32 || KC == 64, "a window pixel is 32, 64 or 128 bytes");
// the window's swizzle: A_ROW bytes, descriptor layout 3 (32 B), 2 (64 B), 1 (128 B)
constexpr int A_LAYOUT = KC == 16 ? 3 : KC == 32 ? 2 : 1;
// consumers, then the producer warpgroup (one thread of it issues the
// copies): a whole warpgroup, so that it can hand its registers to the
// consumers (setmaxnreg)
constexpr int kThreads = NC * 128 + 128;
constexpr int PRODUCER_REGS = 40;
// what the consumers may take: the SM's registers over the blocks, less the
// producer's, in steps of 8, at most 256
constexpr int CONSUMER_REGS_ =
    ((65536 / CTAS - 128 * PRODUCER_REGS) / (NC * 128)) / 8 * 8;
constexpr int CONSUMER_REGS = CONSUMER_REGS_ > 256 ? 256 : CONSUMER_REGS_;
constexpr int PLAN_LEN = 34;

struct ConvArgs {
  const __nv_bfloat16* x;      // up2: (B, ih, iw, >=cin) pixel stride xs
  const __nv_bfloat16* b;      // (cout,)
  const __nv_bfloat16* alpha;  // (cout,) for PReLU, else null
  const __nv_bfloat16* r1;     // (B, H, W, >=cout) pixel stride r1s, or null
  const __nv_bfloat16* r2;     // (B, H, W, >=cout) pixel stride r2s, or null
  __nv_bfloat16* y;            // (B, H, W, >=cout) pixel stride ys
  int B, H, W, nk;             // the output's B, H, W; nk = ceil(cin / KC)
  int ih, iw, cin;             // up2: x's H and W (half the output's), cin
  long long xs;
  int head;                    // stages read from x; the rest from the tail
  int tiles_x, tiles_y, tiles;
  long long ys, r1s, r2s;
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  float s1, s2;
};

constexpr int RES_BYTES = (VR_WG_RESIDENT + 1023) / 1024 * 1024;

// Shared-memory geometry for N = NT * 8 output channels: RES, the weights
// resident (loaded once, before the first tile) and a ring of windows, or
// a ring of stages that each hold a window and its KC channels' weights.
template <int NT, bool RES>
struct Geo {
  static constexpr int N = NT * 8;
  static constexpr int A_BYTES = PH * PW * A_ROW;  // the window, swizzled
  static constexpr int A_PAD = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int TAP_BYTES = KC * N * 2;  // KC rows of cout bf16
  static constexpr int CHUNK = 9 * TAP_BYTES;   // KC channels of every tap
  static constexpr int DEPTH = RES ? VR_WG_STAGES_RES : STAGES;
  static constexpr int W_BYTES = RES ? RES_BYTES : 0;  // the resident weights
  static constexpr int STAGE_BYTES = A_PAD + (RES ? 0 : CHUNK);  // a multiple of 1024
  static constexpr int TX_BYTES = A_BYTES + (RES ? 0 : CHUNK);   // what TMA writes
  // 1024 for the alignment (the 128-byte swizzle's atom), the resident
  // weights, the ring, then its full and empty barriers and the weights'
  static constexpr int SMEM = 1024 + W_BYTES + DEPTH * STAGE_BYTES + (2 * DEPTH + 1) * 8;
  static constexpr int B_LAYOUT = N == 64 ? 1 : 2;  // 128 B : 64 B swizzle
  static constexpr int B_SBO = 8 * N * 2;           // 8 rows of cout
};

// The swizzled address of 16-byte chunk `ch` of window pixel `pix`, as TMA
// writes it.
__device__ __forceinline__ uint32_t window_at(uint32_t st, int pix, int ch) {
  return swizzle<A_ROW>(st + pix * A_ROW + ch * 16);
}

// The up2 producer's share of one stage: the (TH + 2) x (TW + 2) window at
// the fine grid from output pixel (oy0 - 1, ox0 - 1), KC channels from c0,
// each fine pixel read from coarse pixel (y >> 1, x >> 1); zero outside the
// 2x frame and past cin. Thread pt of 128.
__device__ __forceinline__ void up2_window(uint32_t st, const ConvArgs& a, int n, int oy0,
                                           int ox0, int c0, int pt) {
  constexpr int CH = KC / 8;  // 16-byte chunks a pixel
  for (int i = pt; i < PH * PW * CH; i += 128) {
    const int pix = i / CH, ch = i - pix * CH;
    const int py = pix / PW, px = pix - py * PW;
    const int fy = oy0 - 1 + py, fx = ox0 - 1 + px, c = c0 + ch * 8;
    const bool ok = fy >= 0 && fy < a.H && fx >= 0 && fx < a.W && c < a.cin;
    const __nv_bfloat16* src =
        ok ? a.x + ((((long long)n * a.ih + (fy >> 1)) * a.iw + (fx >> 1)) * a.xs + c) : a.x;
    cp_async16(window_at(st, pix, ch), src, ok);
  }
}

// ---- the kernel -------------------------------------------------------------------

template <int NT, bool RES, bool UP2>
__global__ void __launch_bounds__(kThreads, CTAS)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_t,
                         const __grid_constant__ CUtensorMap tm_w, const ConvArgs a) {
  using G = Geo<NT, RES>;
  constexpr int N = G::N, DEPTH = G::DEPTH;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;  // resident weights
  const uint32_t ring = base + G::W_BYTES;
  const uint32_t full0 = ring + DEPTH * G::STAGE_BYTES;
  const uint32_t empty0 = full0 + DEPTH * 8;
  const uint32_t wbar = empty0 + DEPTH * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      // the producer's expect_tx; up2: its 128 threads' arrivals, and the
      // streamed weights' expect_tx
      mbar_init(full0 + 8 * s, UP2 ? 128 + (RES ? 0 : 1) : 1);
      mbar_init(empty0 + 8 * s, NC * 4);  // one arrive a consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_image = a.tiles_x * a.tiles_y;

  if (warp >= NC * 4) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if constexpr (UP2) {
      const int pt = tid - NC * 128;
      if (RES && pt == 0) {  // every weight, once
        mbar_expect_tx(wbar, a.nk * G::CHUNK);
        for (int k = 0; k < a.nk; ++k)
          tma_load_3d(base + k * G::CHUNK, &tm_w, wbar, 0, k * KC, 0);
      }
      int s = 0, pend = -1;  // pend: the stage whose copies are in flight
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int n = t / per_image, rem = t - n * per_image;
        const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
        for (int k = 0; k < a.nk; ++k) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * G::STAGE_BYTES;
          if (!RES && pt == 0) {
            mbar_expect_tx(full0 + 8 * s, G::CHUNK);
            tma_load_3d(st + G::A_PAD, &tm_w, full0 + 8 * s, 0, k * KC, 0);
          }
#ifndef VR_PROBE_NO_LOADS
          up2_window(st, a, n, ty * TH, tx * TW, k * KC, pt);
#endif
          cp_async_commit();
          if (pend >= 0) {  // the stage before has landed: hand it over
            cp_async_wait<1>();
            fence_async_shared();
            mbar_arrive(full0 + 8 * pend);
          }
          pend = s;
          if (++s == DEPTH) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      if (pend >= 0) {
        cp_async_wait<0>();
        fence_async_shared();
        mbar_arrive(full0 + 8 * pend);
      }
    } else if (warp == NC * 4 && lane == 0) {
      if (RES) {  // every weight, once
        mbar_expect_tx(wbar, a.nk * G::CHUNK);
        for (int k = 0; k < a.nk; ++k)
          tma_load_3d(base + k * G::CHUNK, &tm_w, wbar, 0, k * KC, 0);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int n = t / per_image, rem = t - n * per_image;
        const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
        const int oy0 = ty * TH, ox0 = tx * TW;
        for (int k = 0; k < a.nk; ++k) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t full = full0 + 8 * s;
#ifdef VR_PROBE_NO_LOADS  // tools/probe_k1.py: the stages arrive empty
          mbar_arrive(full);
#else
          mbar_expect_tx(full, G::TX_BYTES);
          const uint32_t st = ring + s * G::STAGE_BYTES;
          if (k < a.head)
            tma_load_4d(st, &tm_x, full, k * KC, ox0 - 1, oy0 - 1, n);
          else  // one KC-channel block of the tail
            tma_load_5d(st, &tm_t, full, 0, ox0 - 1, oy0 - 1, n, k - a.head);
          if (!RES) tma_load_3d(st + G::A_PAD, &tm_w, full, 0, k * KC, 0);
#endif
          if (++s == DEPTH) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;  // this warpgroup's rows of a tile: wg * RPC ..
  const int wl = warp & 3, g = lane >> 2, q = lane & 3;

  // this thread's output channels: 8 i + 2 q and + 1
  float bias[NT][2], al[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(a.b + 8 * i + 2 * q));
    bias[i][0] = bb.x;
    bias[i][1] = bb.y;
    float2 aa = make_float2(0.f, 0.f);
    if (a.act == 2)
      aa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.alpha + 8 * i + 2 * q));
    al[i][0] = aa.x;
    al[i][1] = aa.y;
  }

  // descriptors at byte offsets of the ring (A: K-major in the A_ROW-byte
  // swizzle, 8-pixel groups 8 * A_ROW bytes apart) and of the resident
  // weights or the ring (B: a tap's KC x cout rows, N-major in the
  // cout * 2-byte swizzle); a stage, row, tap and k16 step move only the
  // start address (16-byte units)
  const uint64_t da0 = make_desc(ring, 16, 8 * A_ROW, A_LAYOUT);
  const uint64_t db0 = make_desc(RES ? base : ring, 16, G::B_SBO, G::B_LAYOUT);
  if (RES) mbar_wait(wbar, 0);

  float acc[RPC][NT * 4];
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int n = t / per_image, rem = t - n * per_image;
    const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
    const int oy0 = ty * TH, ox0 = tx * TW;
    int prev = 0;
    for (int k = 0; k < a.nk; ++k) {
      mbar_wait(full0 + 8 * s, ph);
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
      wg_fence();
      const uint32_t st = s * G::STAGE_BYTES;
      const uint64_t db = db0 + (uint64_t)((RES ? k * G::CHUNK : st + G::A_PAD) >> 4);
#ifndef VR_PROBE_NO_MMA  // tools/probe_k1.py: the ring alone
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap - ky * 3;
#pragma unroll
          for (int rr = 0; rr < RPC; ++rr)
            Wgmma<N>::run(
                acc[rr],
                da0 + (uint64_t)((st + ((wg * RPC + rr + ky) * PW + kx) * A_ROW + j * 32) >> 4),
                db + (uint64_t)((tap * G::TAP_BYTES + j * 16 * N * 2) >> 4),
                (k | j | tap) != 0);
        }
      }
#endif
      wg_commit();
      if (k > 0) {
        wg_wait<1>();  // the previous stage's MMAs are done: release it
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      if (++s == DEPTH) {
        s = 0;
        ph ^= 1;
      }
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);

    // epilogue: conv3x3.cu's arithmetic, two neighbouring channels at a
    // time, stored from registers. A row's residuals are all loaded before
    // its first store: the stores could alias them for all the compiler
    // knows, and a load after a store would wait for it, one memory latency
    // per channel pair.
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) {
      const int oy = oy0 + wg * RPC + rr;
      long long p[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + wl * 16 + g + 8 * h;
        ok[h] = oy < a.H && ox < a.W;
        p[h] = ((long long)n * a.H + oy) * a.W + ox;
      }
#ifdef VR_PROBE_NO_STORE  // tools/probe_k1.py: no epilogue loads or stores
      ok[0] = ok[1] = false;
#endif
      __nv_bfloat162 v1[2][NT], v2[2][NT];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int co = 8 * i + 2 * q;
          v1[h][i] = v2[h][i] = __floats2bfloat162_rn(0.f, 0.f);
          if (ok[h] && a.r1)
            v1[h][i] = *reinterpret_cast<const __nv_bfloat162*>(a.r1 + p[h] * a.r1s + co);
          if (ok[h] && a.r2)
            v2[h][i] = *reinterpret_cast<const __nv_bfloat162*>(a.r2 + p[h] * a.r2s + co);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int co = 8 * i + 2 * q;
          float v[2] = {acc[rr][4 * i + 2 * h], acc[rr][4 * i + 2 * h + 1]};
#ifdef VR_PROBE_NO_MMA
          v[0] = v[1] = 0.f;
#endif
          const float2 u1 = __bfloat1622float2(v1[h][i]), u2 = __bfloat1622float2(v2[h][i]);
          const float rr1[2] = {u1.x, u1.y}, rr2[2] = {u2.x, u2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float u = __fadd_rn(v[e], bias[i][e]);
            if (a.act == 1) {
              u = u >= 0.f ? u : __fmul_rn(0.2f, u);
            } else if (a.act == 2) {
              u = u > 0.f ? u : __fmul_rn(u, al[i][e]);
            }
            if (a.r1) u = __fadd_rn(rr1[e], __fmul_rn(a.s1, u));
            if (a.r2)
              u = __fadd_rn(rr2[e],
                            __fmul_rn(a.s2, __bfloat162float(__float2bfloat16_rn(u))));
            v[e] = u;
          }
          *reinterpret_cast<__nv_bfloat162*>(a.y + p[h] * a.ys + co) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

// ---- host -------------------------------------------------------------------------

template <int NT, bool RES, bool UP2>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_t, const CUtensorMap& tm_w,
                   const ConvArgs& a, int grid, cudaStream_t stream) {
  using G = Geo<NT, RES>;
  auto kernel = conv3x3_wgmma_kernel<NT, RES, UP2>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, G::SMEM, stream>>>(tm_x, tm_t, tm_w, a);
  return cudaGetLastError();
}

// The weights stay resident when all their KC-channel chunks fit.
template <int NT, bool UP2>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_t, const CUtensorMap& tm_w,
                   const ConvArgs& a, int grid, cudaStream_t stream) {
  if ((long long)a.nk * Geo<NT, true>::CHUNK <= RES_BYTES)
    return launch<NT, true, UP2>(tm_x, tm_t, tm_w, a, grid, stream);
  return launch<NT, false, UP2>(tm_x, tm_t, tm_w, a, grid, stream);
}

template <int NT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_t, const CUtensorMap& tm_w,
                   const ConvArgs& a, int grid, bool up2, cudaStream_t stream) {
  return up2 ? launch<NT, true>(tm_x, tm_t, tm_w, a, grid, stream)
             : launch<NT, false>(tm_x, tm_t, tm_w, a, grid, stream);
}

}  // namespace

extern "C" {

// The build's tile rows, tile width, ring depth and blocks an SM (what
// ops/tail.py::wgmma_plan needs), its consumer warpgroups, its dynamic
// shared memory a block at cout 64 and 32 (weights streamed), its channels
// a stage, its bytes of resident weights, and the ring depth and shared
// memory at cout 64 with them: out[0..10].
int vr_conv3x3_wgmma_config(int* out) {
  out[0] = TH;
  out[1] = TW;
  out[2] = STAGES;
  out[3] = CTAS;
  out[4] = NC;
  out[5] = Geo<8, false>::SMEM;
  out[6] = Geo<4, false>::SMEM;
  out[7] = KC;
  out[8] = RES_BYTES;
  out[9] = Geo<8, true>::DEPTH;
  out[10] = Geo<8, true>::SMEM;
  return 0;
}

// bf16 only. plan: PLAN_LEN int64 values from ops/tail.py::wgmma_plan (x's
// 4-D map: dims, byte strides, box, swizzle bytes; w's 3-D map: dims, byte
// strides, box, swizzle bytes; the grid; the tile; the tail's blocks, its
// 5-D map's byte strides and box). up2: x is read through nearest 2x (the
// output is 2H x 2W; x's map is checked, not encoded: the producer copies
// the windows itself). xt: the tail, (blocks, B, H, W, KC) contiguous,
// whose channels follow x's (null without one; never with up2). Returns the
// cudaError_t of the
// launch; cudaErrorInvalidValue for a call the route does not take or a plan
// that does not fit this build; cudaErrorNotSupported when no tensor map
// encoder was found or cuTensorMapEncodeTiled refused a map.
int vr_conv3x3_wgmma(const void* x, const void* w, const void* b, const void* alpha,
                     const void* r1, const void* r2, void* y, int B, int H, int W,
                     int cin, int cout, long long xs, long long ys, long long r1s,
                     long long r2s, int act, int up2, float s1, float s2, void* stream,
                     const long long* plan, int plan_len, const void* xt) {
  if (cin <= 0 || cin % 16 != 0 || (cout != 32 && cout != 64) || (up2 && xt))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(alpha) ||
      !aligned16(r1) || !aligned16(r2) || !aligned16(y) || xs % 8 || ys % 8 ||
      r1s % 8 || r2s % 8)
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long *a_dims = plan, *a_strides = plan + 4, *a_box = plan + 7;
  const long long a_swz = plan[11];
  const long long *w_dims = plan + 12, *w_strides = plan + 15, *w_box = plan + 17;
  const long long w_swz = plan[20], grid = plan[21];
  const long long nblk = plan[24], *t_strides = plan + 25, *t_box = plan + 29;
  const long long head = a_dims[0];  // x's channels; the tail's follow
  // the plan must describe this call and this build
  if (nblk < 0 || (nblk > 0) != (xt != nullptr) || !aligned16(xt) ||
      head + nblk * KC != cin || (nblk > 0 && head % KC != 0) ||
      (nblk > 0 && (t_strides[0] != KC * 2 || t_box[0] != KC || t_box[1] != PW ||
                    t_box[2] != TH + 2 || t_box[3] != 1 || t_box[4] != 1)))
    return cudaErrorInvalidValue;
  if (a_dims[1] != W || a_dims[2] != H || a_dims[3] != B ||
      a_strides[0] != xs * 2 || a_box[0] != KC || a_box[1] != PW || a_box[2] != TH + 2 ||
      a_box[3] != 1 || a_swz != A_ROW || w_dims[0] != cout || w_dims[1] != cin ||
      w_dims[2] != 9 || w_box[0] != cout || w_box[1] != KC || w_box[2] != 9 ||
      w_swz != 2 * cout || plan[22] != TH || plan[23] != TW || grid <= 0 ||
      grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long OH = up2 ? 2LL * H : H, OW = up2 ? 2LL * W : W;
  if (OH > 0x7fffffffLL || OW > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles_x = (OW + TW - 1) / TW, tiles_y = (OH + TH - 1) / TH;
  if ((long long)B * tiles_x * tiles_y > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tm_x = {}, tm_w, tm_t = {};
  const long long t_dims[5] = {KC, W, H, B, nblk};
  const CUtensorMapSwizzle a_mode = KC == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                   : KC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle n_mode =
      cout == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if ((!up2 && !encode(&tm_x, x, 4, a_dims, a_strides, a_box, a_mode)) ||
      !encode(&tm_w, w, 3, w_dims, w_strides, w_box, n_mode) ||
      (nblk > 0 && !encode(&tm_t, xt, 5, t_dims, t_strides, t_box, a_mode)))
    return cudaErrorNotSupported;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.alpha = static_cast<const __nv_bfloat16*>(alpha);
  a.r1 = static_cast<const __nv_bfloat16*>(r1);
  a.r2 = static_cast<const __nv_bfloat16*>(r2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B;
  a.H = (int)OH;
  a.W = (int)OW;
  a.ih = H;
  a.iw = W;
  a.cin = cin;
  a.xs = xs;
  a.nk = (cin + KC - 1) / KC;  // a last stage past cin reads TMA's zero fill
  a.head = nblk > 0 ? (int)(head / KC) : a.nk;
  a.tiles_x = (int)tiles_x;
  a.tiles_y = (int)tiles_y;
  a.tiles = (int)(B * tiles_x * tiles_y);
  a.ys = ys;
  a.r1s = r1s;
  a.r2s = r2s;
  a.act = act;
  a.s1 = s1;
  a.s2 = s2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch<8>(tm_x, tm_t, tm_w, a, (int)grid, up2 != 0, st)
                    : launch<4>(tm_x, tm_t, tm_w, a, (int)grid, up2 != 0, st);
}

}  // extern "C"
