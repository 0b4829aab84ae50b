// The RRDBNet tail, Hopper route: upconv2 -> conv_hr -> conv_last in one
// launch, for bf16 activations at nf 64, on `wgmma` fed by TMA over rolling
// rings of rows in shared memory (the design of K5's rdb_fused_wgmma.cu).
//
// It computes exactly the function of tail_fused_mma.cu and tail_fused.cu:
//
//   u2  = T(lrelu(conv_up2(nearest2x(x)) + b_up2))     (B, 2 H2, 2 W2, 64)
//   hr  = T(lrelu(conv_hr(u2) + b_hr))                 (B, 2 H2, 2 W2, 64)
//   out = T(conv_last(hr) + b_last)                    (B, 2 H2, 2 W2, 3)
//
// every conv SAME at the 2 H2 x 2 W2 frame (u2 and hr zero outside it), T()
// the rounding to bf16, u2 and hr never in device memory. It replaces, for
// the calls ops/tail.py::tail_fused_route sends it (bf16 at nf 64, aligned
// operands), three Pallas entry points of video_restore_tpu/ops:
//   pallas_tail.py:266  tail_fused_raw  } the default tail, through
//   pallas_tail.py:425  tail_fused      } ops/tail.py::tail_fused
//   pallas_tail.py:1018 tail_fused_q      VRT_TAIL_Q=1, ops/tail.py::tail_fused_q
//
// Sums: upconv2 and conv_hr per 16 input channels in order, the nine taps in
// order, one k16 `wgmma` each into one fp32 accumulator from zero (the order
// of K1's tensor-core routes and of tail_fused_mma.cu); conv_last on fp32
// FMAs in conv3x3_narrow.cu's order (input channel, then ky, kx), then the
// bias. So the kernel equals the three-launch chain and K6's two kernels bit
// for bit.
//
// What bounds it on the H100: at 7680x4320 the two wide convs are 4.89e12
// useful operations (upconv2 as 9 taps on the fine grid) and conv_last
// 1.15e11, against 1.26 GB of compulsory traffic (x in, RGB out): the tensor
// cores, 5.06 ms at the bf16 peak (3.69 with upconv2 in phase form, 4/9 of
// its MACs, which sums in another order and is not used). The design:
//
//  - Column stripes, rolling rows. A block owns SW = 60 output columns of a
//    stripe and walks down a segment of its rows, R = 3 rows a step (one
//    consumer warpgroup a row). upconv2's `wgmma` m64 row is the frame
//    columns X - 2 .. X + 61, conv_hr's X - 1 .. X + 62 (62 needed),
//    conv_last's X .. X + 59. conv_hr runs one row behind upconv2 and
//    conv_last two behind conv_hr, so no halo row is recomputed. Executed
//    over useful work: 64 / 60 x (1 + ~(R + 4) / L) for a segment of L rows
//    (1.07 at 8K; K6's square tiles recompute 1.43x upconv2's and 1.21x
//    conv_hr's).
//  - The nearest-2x producer: the consumers copy x's coarse rows with
//    16-byte `cp.async` (zero fill outside the frame: SAME padding at the 2x
//    grid's edge) straight into fine-width rows of a ring, in the 64-byte
//    swizzle that `wgmma` reads (one 64-byte row a pixel per 32-channel
//    plane, K1's layout): fine pixel f is coarse pixel (f + 1) >> 1 of the
//    stripe's window, each coarse chunk copied twice. Fine row r reads
//    coarse row r >> 1 by ring index alone, so the vertical doubling costs
//    nothing; a tap's (dy, dx) moves only the descriptor's start address. A
//    step's rows go out one step ahead, and are waited for and fenced to the
//    async proxy before the barrier that ends the step before.
//  - u2 in a ring of R + 2 rows in the same swizzled layout (conv_hr's A
//    operand), written by upconv2's epilogue (bias, lrelu, frame mask,
//    rounding: the arithmetic of the other routes) and fenced before a named
//    barrier over the consumers; hr in a ring of R + 3 rows, pixel-major
//    with 16 bytes of pad (144-byte pixels), the even pixels of a row before
//    its odd ones, so that conv_last's 16-byte reads (two neighbouring
//    pixels a lane) meet no bank conflict (13.93 ms against 14.24 with the
//    pixels in order). A read past a u2 row's end (hr's two unneeded
//    pixels) stays in the buffer.
//  - Weights: the two wide convs stream in stages of 16 input channels x 9
//    taps x 64 couts (18,432 bytes, 128-byte swizzle: K5's conv-5 stage)
//    through VR_TAIL_WSLOTS = 3 slots that one thread of the fourth
//    warpgroup's warp 0 keeps full with TMA; each stage's slot is released once the next
//    stage's `wgmma`s are committed.
//  - conv_last on LAST_WARPS = 3 warps of their own (warps 1-3 of the
//    fourth warpgroup: three SM sub-partitions), one output row of a step
//    each, two pixels (three couts each) a lane. Its weights stay resident
//    in shared memory as fp32, a float4 of three couts per (tap, channel)
//    (9,216 bytes); a channel's nine are loaded together ahead of its 54
//    FMAs. They wait on an mbarrier that the
//    consumer warps arrive on once a step's hr rows are written, and arrive
//    on another once they have read them; the consumers wait for that
//    before they overwrite hr rows a step later. So conv_last issues beside
//    the next step's `wgmma`s instead of between them. Measured and not kept
//    (tools/probe_k6.py, 8K tail): conv_last in the consumer warps between
//    a stage's issue and its wait, 19.85 ms, spread over two warps a
//    warpgroup 17.4; on three warps of their own with the weights in shared
//    memory, one 16-byte load a (channel, tap), 14.4 (14.2 with a fourth
//    weight slot); its weights by three 4-byte loads, not one 16-byte load,
//    16.3; on six warps of one pixel a lane 16.2 (twice the weight
//    loads), on eight 18.3 (ptxas gives 672 threads 80 registers: spills);
//    the weights as fp32 kernel parameters, each an FMA's constant-bank
//    operand, 46.3-47.7 (6.9 KB streamed through the constant cache at
//    every FMA). The `wgmma`s' operands alone nearly fill the shared-memory
//    port: an m64n64k16 with both operands in shared memory reads 4 KB for
//    32 clocks of tensor work, against the port's 128 bytes a clock.
//  - A persistent grid, one block an SM; the plan
//    (ops/tail.py::tail_wgmma_plan) cuts the concatenated stripes' rows
//    into one run a block. Every thread keeps the launch's 128 registers
//    (no setmaxnreg: no role needs more); each consumer thread holds its
//    channels' 16 bias pairs in registers (13.42 ms against 13.93 with
//    them read from shared memory in every epilogue).
// 206,960 bytes of shared memory, 512 threads a block, no spills.
//
// Measured (tools/probe_k6.py --route wgmma; NVIDIA H100 80GB HBM3 at 700
// W; the 8K tail, 1x2160x3840x64 -> 1x4320x7680x3): 13.41-13.53 ms against
// tail_fused_mma.cu's 25.9-26.1, 362-365 TFLOP/s useful, 387-390 executed
// (1.070x). Without conv_last (`no_last`) 9.25-9.47 ms, without the
// `wgmma`s (`no_mma`: rings, loads, epilogues and conv_last) 8.1-9.2,
// conv_last without its hr loads 12.4, without its weight loads 13.1-14.5
// (no gain): what holds the kernel is conv_last's three warps, whose
// FMAs issue at about half a warp instruction a clock, beside MMAs that
// nearly fill the shared-memory port; a step waits for the slower of the
// two. More rows a step would help both and do not fit: R = 3 is the
// most that 232,448 bytes hold (`rows2` 16.3-16.6 ms, `rows1` 25.8-26.1,
// a fourth weight slot `s4` 13.3-13.4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

#ifndef VR_TAIL_ROWS
#define VR_TAIL_ROWS 3  // consumer warpgroups: output rows a step (R)
#endif
#ifndef VR_TAIL_SW
#define VR_TAIL_SW 60  // output columns of a stripe
#endif
#ifndef VR_TAIL_WSLOTS
#define VR_TAIL_WSLOTS 3  // weight slots of 18,432 bytes
#endif


namespace {

using namespace wgmma_tile;
using bf16 = __nv_bfloat16;

constexpr int NF = 64;
constexpr int R = VR_TAIL_ROWS;
constexpr int SW = VR_TAIL_SW;
constexpr int WS = VR_TAIL_WSLOTS;
constexpr int PIX = 64;                // bytes of a pixel in a 32-channel plane
// fine pixels upconv2 reads: columns X - 3 .. X + SW + 2
constexpr int XF = SW + 6;
constexpr int XP = (XF + 7) / 8 * 8;   // pixels of an x ring row: whole swizzle atoms
constexpr int XPLANE = XP * PIX;
constexpr int XROW = 2 * XPLANE;       // x's two planes
constexpr int DX = R + 2;              // coarse x rows held: a step's and the next's
constexpr int UPLANE = 64 * PIX;       // a u2 row: 64 pixels
constexpr int UROW = 2 * UPLANE;
constexpr int DU = R + 2;              // u2 rows held: conv_hr reads u - 2 .. u + R - 1
constexpr int HPX = SW + 2;            // hr pixels conv_last reads
constexpr int HP = NF * 2 + 16;        // bytes of an hr pixel (16 of pad)
// an hr row: the even pixels, then the odd ones from HODD on, 16 banks
// apart, so that a lane's two neighbouring pixels and its neighbour lanes'
// fall on different banks
constexpr int HODD = ((HPX + 1) / 2 * HP + 64 + 127) / 128 * 128 - 64;  // 64 mod 128
constexpr int HROW = HODD + HPX / 2 * HP;
constexpr int DH = R + 3;              // hr rows held: conv_last reads u - 4 .. u + R - 2
constexpr int SLOT = 18432;            // a weight stage: 16 cin x 9 taps x 64 cout
constexpr int X_OFF = WS * SLOT;
constexpr int U_OFF = X_OFF + DX * XROW;
constexpr int H_OFF = U_OFF + DU * UROW;
constexpr int L_OFF = H_OFF + DH * HROW;
constexpr int B_OFF = L_OFF + 9 * NF * 16;
constexpr int BAR_OFF = B_OFF + 2 * NF * 2 + 16;  // b_up2, b_hr (bf16), b_last (fp32)
constexpr int SMEM = 1024 + BAR_OFF + (2 * WS + 2) * 8;
// the consumer warpgroups, then a fourth: its warp 0 issues the weight
// copies (one thread), its warps 1-3 compute conv_last
constexpr int LAST_WARPS = 3;
constexpr int kThreads = R * 128 + 128;
constexpr int PLAN_LEN = 16;
static_assert(R >= 1 && R <= 3, "one to three consumer warpgroups");
static_assert(SW % 2 == 0 && SW + 4 <= 64 && SW / 2 <= 32,
              "u2's 64 pixels cover the stripe and its halo of 2; a lane takes two outputs");
static_assert(SMEM <= 232448, "one block an SM");
static_assert(X_OFF % 1024 == 0 && U_OFF % 1024 == 0 && XPLANE % 512 == 0 && H_OFF % 16 == 0 &&
                  L_OFF % 16 == 0 && BAR_OFF % 8 == 0,
              "alignment");

// steps of a segment of L rows: conv_last, three rows behind upconv2's,
// reaches the segment's last row
__host__ __device__ constexpr int n_steps(int L) { return (L + R + 4) / R; }

struct __align__(64) TailParams {
  CUtensorMap tm_w[2];  // upconv2's and conv_hr's weights: (cout, cin, 9)
  const bf16* x;        // (B, H2, W2, 64)
  bf16* y;              // (B, OH, OW, 3)
  const bf16* b_up2;
  const bf16* b_hr;
  const bf16* w_last;   // HWIO (3, 3, 64, 3)
  const bf16* b_last;
  long long rows;       // B * stripes * OH: the rows the blocks share
  int H2, W2, OH, OW, S;
};

// One segment: image n, the stripe at column X, output rows [y0, y1).
struct Seg {
  int n, X, y0, y1;
};

__device__ __forceinline__ bool seg_at(const TailParams& p, long long r, long long r1, Seg& s) {
  if (r >= r1) return false;
  const long long idx = r / p.OH;
  s.y0 = (int)(r - idx * p.OH);
  const long long len = r1 - r < (long long)(p.OH - s.y0) ? r1 - r : (long long)(p.OH - s.y0);
  s.y1 = s.y0 + (int)len;
  s.n = (int)(idx / p.S);
  s.X = (int)(idx - (long long)s.n * p.S) * SW;
  return true;
}

__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// element i (0..7) of eight bf16 as fp32 (exact)
__device__ __forceinline__ float bf_elem(const uint4& v, int i) {
  const uint32_t w = (&v.x)[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(R * 128) : "memory");
}

__device__ __forceinline__ int ring(int row, int depth) {
  const int m = row % depth;
  return m < 0 ? m + depth : m;
}

// where hr pixel px of a row lies in it
__device__ __forceinline__ int hr_at(int px) { return ((px & 1) ? HODD : 0) + (px >> 1) * HP; }

// The shared-memory map: weight slots, the x, u2 and hr rings, conv_last's
// weights, the biases, the weight slots' full and empty barriers, then
// hfull (a step's hr rows are written: one arrive a consumer warp) and
// hread (conv_last has read them: one arrive a conv_last warp). The weight
// ring is a FIFO: stage c sits in slot c % WS, and its barriers' phase is
// (c / WS) & 1; the hr barriers complete once a step, phase k & 1 for the
// block's k-th step. `at` is the base as a pointer, for conv_last's loads,
// which the compiler schedules (the asm accesses it may not move).
struct Smem {
  uint32_t w, x, u, h, bias, wfull, wempty, hfull, hread;
  const unsigned char* at;
};

__device__ __forceinline__ Smem smem_map(uint32_t base, const unsigned char* at) {
  Smem m;
  m.at = at;
  m.w = base;
  m.x = base + X_OFF;
  m.u = base + U_OFF;
  m.h = base + H_OFF;
  m.bias = base + B_OFF;
  m.wfull = base + BAR_OFF;
  m.wempty = m.wfull + 8 * WS;
  m.hfull = m.wempty + 8 * WS;
  m.hread = m.hfull + 8;
  return m;
}

// ---- producer: one thread --------------------------------------------------------

struct Producer {
  const TailParams& p;
  Smem m;
  uint32_t wn = 0;  // weight stages issued

  __device__ Producer(const TailParams& p_, Smem m_) : p(p_), m(m_) {}

  __device__ __forceinline__ void w_stage(const CUtensorMap* map, int cin0) {
    const uint32_t slot = wn % WS;
    mbar_wait(m.wempty + 8 * slot, ((wn / WS) & 1) ^ 1);
    const uint32_t full = m.wfull + 8 * slot;
#ifdef VR_PROBE_NO_LOADS  // tools/probe_k6.py: the stages arrive empty
    mbar_arrive(full);
#else
    mbar_expect_tx(full, SLOT);
    tma_load_3d(m.w + slot * SLOT, map, full, 0, cin0, 0);
#endif
    ++wn;
  }

  // Every weight stage of the block's rows [r0, r1), in the order the
  // consumers take them: per step upconv2's four, then conv_hr's.
  __device__ void run(long long r0, long long r1) {
    Seg s;
    for (long long r = r0; seg_at(p, r, r1, s); r += s.y1 - s.y0) {
      const int T = n_steps(s.y1 - s.y0);
      for (int t = 0; t < T; ++t)
        for (int conv = 0; conv < 2; ++conv)
          for (int c = 0; c < 4; ++c) w_stage(&p.tm_w[conv], 16 * c);
    }
  }
};

// ---- conv_last: warps 1-3 of the fourth warpgroup --------------------------------

struct Last {
  const TailParams& p;
  Smem m;
  int j, lane;  // this warp's row of a step, 0 .. 2; two pixels a lane

  __device__ Last(const TailParams& p_, Smem m_, int j_) : p(p_), m(m_), j(j_) {
    lane = threadIdx.x & 31;
  }

  // conv_last at output row `row` of segment s for this lane's pixels
  // 2 lane, + 1 (lanes past the stripe repeat the last pair, storing
  // nothing): per 8 input channels, each over ky, kx, in
  // conv3x3_narrow.cu's order; then the bias, the rounding, the stores
  // inside the frame.
  __device__ __forceinline__ void row(const Seg& s, int row) const {
#ifndef VR_PROBE_NO_LAST
    const int o = 2 * (lane < SW / 2 ? lane : SW / 2 - 1);
    float la[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    const unsigned char* hr[3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) hr[ky] = m.at + H_OFF + ring(row - 1 + ky, DH) * HROW;
    const float4* lw = reinterpret_cast<const float4*>(m.at + L_OFF);
#pragma unroll 1
    for (int i = 0; i < NF / 8; ++i) {
      uint4 v[3][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#ifdef VR_PROBE_NO_HLOAD  // tools/probe_k6.py: conv_last without its hr loads
          v[ky][c] = make_uint4(lane * c, i * ky, row, lane ^ i);
#else
          v[ky][c] = *reinterpret_cast<const uint4*>(hr[ky] + hr_at(o + c) + i * 16);
#endif
        }
#pragma unroll
      for (int ci = 0; ci < 8; ++ci) {
        float4 w[9];  // the channel's nine taps, loaded before its FMAs
#pragma unroll
        for (int t = 0; t < 9; ++t) {
#ifdef VR_PROBE_NO_WLOAD  // tools/probe_k6.py: conv_last without its weight loads
          w[t] = make_float4(t + 0.5f, i + 0.25f, ci + 0.125f, 0.f);
#else
          w[t] = lw[t * NF + 8 * i + ci];
#endif
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              const float xv = bf_elem(v[ky][pp + kx], ci);
              const float4& wt = w[ky * 3 + kx];
              la[pp][0] = fmaf(xv, wt.x, la[pp][0]);
              la[pp][1] = fmaf(xv, wt.y, la[pp][1]);
              la[pp][2] = fmaf(xv, wt.z, la[pp][2]);
            }
      }
    }
    if (lane >= SW / 2) return;
    const float* bl = reinterpret_cast<const float*>(m.at + B_OFF + 2 * NF * 2);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int fx = s.X + o + pp;
      if (fx >= p.OW) continue;
      bf16* y = p.y + (((long long)s.n * p.OH + row) * p.OW + fx) * 3;
      y[0] = __float2bfloat16_rn(__fadd_rn(la[pp][0], bl[0]));
      y[1] = __float2bfloat16_rn(__fadd_rn(la[pp][1], bl[1]));
      y[2] = __float2bfloat16_rn(__fadd_rn(la[pp][2], bl[2]));
    }
#endif
  }

  // Per step: wait for its hr rows, compute this warp's row (u - 3 + j:
  // conv_hr's rows but the last two), let the rows go.
  __device__ void run(long long r0, long long r1) {
    Seg s;
    uint32_t k = 0;  // the block's steps
    for (long long r = r0; seg_at(p, r, r1, s); r += s.y1 - s.y0) {
      const int T = n_steps(s.y1 - s.y0);
      for (int t = 0, u = s.y0 - 2; t < T; ++t, u += R, ++k) {
        mbar_wait(m.hfull, k & 1);
        const int lrow = u - 3 + j;
        if (j < R && lrow >= s.y0 && lrow < s.y1) row(s, lrow);
        __syncwarp();
        if (lane == 0) mbar_arrive(m.hread);
      }
    }
  }
};

// ---- consumers -------------------------------------------------------------------

struct Consumer {
  const TailParams& p;
  Smem m;
  int wg, wl, g, q, lane;
  uint32_t wn = 0;  // weight stages taken
  uint32_t k = 0;   // the block's steps
  uint32_t bias[2][8];  // b_up2's and b_hr's pairs at this thread's channels 8 i + 2 q
  Seg s;

  __device__ Consumer(const TailParams& p_, Smem m_) : p(p_), m(m_) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wg = warp >> 2;
    wl = warp & 3;
    g = lane >> 2;
    q = lane & 3;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) bias[c][i] = ld_shared(m.bias + c * NF * 2 + (8 * i + 2 * q) * 2);
  }

  // the shared address of coarse x row c (plane 0), of u2's and hr's row
  __device__ __forceinline__ uint32_t x_row(int c) const { return m.x + ring(c, DX) * XROW; }
  __device__ __forceinline__ uint32_t u_row(int r) const { return m.u + ring(r, DU) * UROW; }
  __device__ __forceinline__ uint32_t h_row(int r) const { return m.h + ring(r, DH) * HROW; }

  // Coarse rows [c0, c1] of the segment's window into their ring rows at
  // fine width: one 16-byte cp.async a (fine pixel, 8 channels), fine pixel
  // f (column X - 3 + f) from coarse column X / 2 - 2 + ((f + 1) >> 1); one
  // commit group a thread.
  __device__ __forceinline__ void load_x(int c0, int c1) const {
#ifndef VR_PROBE_NO_LOADS
    const int cx0 = s.X / 2 - 2;
    const int items = (c1 - c0 + 1) * XF * 8;
    for (int i = threadIdx.x; i < items; i += R * 128) {
      const int k = i & 7, rest = i >> 3;
      const int cr = rest / XF, f = rest - cr * XF;
      const int c = c0 + cr, cx = cx0 + ((f + 1) >> 1);
      const bool ok = c >= 0 && c < p.H2 && cx >= 0 && cx < p.W2;
      const bf16* src =
          ok ? p.x + ((((long long)s.n * p.H2 + c) * p.W2 + cx) * NF + k * 8) : p.x;
      cp_async16(swizzle<64>(x_row(c) + (k >> 2) * XPLANE + f * PIX + (k & 3) * 16), src, ok);
    }
#endif
    cp_async_commit();
  }

  // The MMAs of upconv2 (CONV 0: A from the x ring, fine row r reads coarse
  // row r >> 1) or conv_hr (CONV 1: A from the u2 ring) at output row `row`
  // into acc, over the conv's four weight stages: each waits for its
  // weights, issues its nine wgmmas and commits them; the stage before is
  // then waited for and its slot released, so one group stays in flight;
  // the last is drained.
  template <int CONV>
  __device__ __forceinline__ void mma(float (&acc)[32], int row) {
    constexpr uint32_t PLANE = CONV == 0 ? XPLANE : UPLANE;
    uint32_t a_row[3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      a_row[ky] = CONV == 0 ? x_row((row - 1 + ky) >> 1) : u_row(row - 1 + ky);
    // descriptors: the start address (16-byte units) in the low 14 bits; A
    // K-major in the 64-byte swizzle, B N-major in the 128-byte swizzle
    const uint64_t da0 = make_desc(0, 16, 8 * PIX, 2);
    const uint64_t db0 = make_desc(0, 16, 8 * NF * 2, 1);
    uint32_t prev = 0;  // the slot of the stage committed before
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t slot = wn % WS;
      mbar_wait(m.wfull + 8 * slot, (wn / WS) & 1);
      fence_acc(acc);
      wg_fence();
      const uint32_t wb = m.w + slot * SLOT;
#ifndef VR_PROBE_NO_MMA  // tools/probe_k6.py: the rings alone
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - ky * 3;
        const uint64_t da =
            da0 + (uint64_t)((a_row[ky] + (c >> 1) * PLANE + kx * PIX + (c & 1) * 32) >> 4);
        const uint64_t db = db0 + (uint64_t)((wb + tap * 2048) >> 4);
        Wgmma<64>::run(acc, da, db, (c | tap) != 0);
      }
#endif
      wg_commit();
      if (c > 0) {
        wg_wait<1>();  // the stage before is done: release its slot
        if (lane == 0) mbar_arrive(m.wempty + 8 * prev);
      }
      prev = slot;
      ++wn;
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(m.wempty + 8 * prev);
    fence_acc(acc);
#ifdef VR_PROBE_NO_MMA
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#endif
  }

  // upconv2's (CONV 0) or conv_hr's (CONV 1) epilogue at output row `row`:
  // bias, lrelu, the frame mask, the rounding, into the u2 ring (swizzled,
  // then fenced to the async proxy) or the hr ring. This thread's pixels
  // are 16 wl + g + 8 h, its channels 8 i + 2 q and + 1.
  template <int CONV>
  __device__ __forceinline__ void epi(const float (&acc)[32], int row) const {
    const bool row_in = row >= 0 && row < p.OH;
    const uint32_t dst = CONV == 0 ? u_row(row) : h_row(row);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 16 * wl + g + 8 * h;
      if (CONV == 1 && px >= HPX) continue;  // hr's pixels no output reads
      const int fx = s.X - 2 + CONV + px;
      const bool in = row_in && fx >= 0 && fx < p.OW;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = 8 * i + 2 * q;
        const float2 bb = unpack(bias[CONV][i]);
        float v0 = __fadd_rn(acc[4 * i + 2 * h], bb.x);
        float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], bb.y);
        v0 = v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0);
        v1 = v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1);
        const uint32_t a = CONV == 0
                               ? swizzle<64>(dst + (i >> 2) * UPLANE + px * PIX + (co & 31) * 2)
                               : dst + hr_at(px) + co * 2;
        st_shared(a, pack(in ? v0 : 0.f, in ? v1 : 0.f));
      }
    }
  }

  // One step: upconv2 at rows u + wg, conv_hr at u - 1 + wg, each conv's
  // MMAs drained before its epilogue; conv_hr's rows are written once
  // conv_last has read the step before's (the hr ring holds R + 3 rows), and
  // handed to it. The step ends once the next step's x rows have landed.
  __device__ __forceinline__ void step(int u) {
    float acc[32];
    mma<0>(acc, u + wg);
    epi<0>(acc, u + wg);
    fence_async_shared();  // u2 before conv_hr's wgmmas read it
    consumers_sync();
    mma<1>(acc, u - 1 + wg);
    if (k > 0) mbar_wait(m.hread, (k - 1) & 1);
    epi<1>(acc, u - 1 + wg);
    __syncwarp();
    if (lane == 0) mbar_arrive(m.hfull);
    ++k;
    cp_async_wait<0>();  // the next step's x rows
    fence_async_shared();
    consumers_sync();
  }

  __device__ void run(long long r0, long long r1) {
    for (long long r = r0; seg_at(p, r, r1, s); r += s.y1 - s.y0) {
      const int T = n_steps(s.y1 - s.y0);
      // step t runs upconv2 at rows u .. u + R - 1, u = y0 - 2 + R t: fine x
      // rows u - 1 .. u + R, coarse rows (u - 1) >> 1 .. (u + R) >> 1
      int u = s.y0 - 2;
      int hi = (u + R) >> 1;
      load_x((u - 1) >> 1, hi);
      cp_async_wait<0>();
      fence_async_shared();
      consumers_sync();
      for (int t = 0; t < T; ++t, u += R) {
        if (t + 1 < T && (u + 2 * R) >> 1 > hi) {
          load_x(hi + 1, (u + 2 * R) >> 1);
          hi = (u + 2 * R) >> 1;
        }
        step(u);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    tail_wgmma_kernel(const __grid_constant__ TailParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const Smem m = smem_map(base, smem + (base - smem_u32(smem)));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the rings are zero before anything reads them
  for (int o = tid * 16; o < L_OFF - X_OFF; o += kThreads * 16)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(m.x + o), "r"(0)
                 : "memory");
  // conv_last's weights as fp32, the three couts of a (tap, channel) and 0
  for (int i = tid; i < 9 * NF; i += kThreads)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + L_OFF + 16 * i),
                 "f"(__bfloat162float(p.w_last[3 * i])), "f"(__bfloat162float(p.w_last[3 * i + 1])),
                 "f"(__bfloat162float(p.w_last[3 * i + 2])), "f"(0.f)
                 : "memory");
  // b_up2 and b_hr as bf16, b_last as fp32
  for (int i = tid; i < 2 * NF; i += kThreads) {
    const bf16 v = i < NF ? p.b_up2[i] : p.b_hr[i - NF];
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(m.bias + 2 * i),
                 "h"(*reinterpret_cast<const unsigned short*>(&v))
                 : "memory");
  }
  if (tid < 3)
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(m.bias + 4 * NF + 4 * tid),
                 "f"(__bfloat162float(p.b_last[tid]))
                 : "memory");
  fence_async_shared();
  if (tid == 0) {
    for (int i = 0; i < WS; ++i) {
      mbar_init(m.wfull + 8 * i, 1);       // the producer's expect_tx
      mbar_init(m.wempty + 8 * i, R * 4);  // one arrive a consumer warp
    }
    mbar_init(m.hfull, R * 4);
    mbar_init(m.hread, LAST_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r0 = p.rows * blockIdx.x / gridDim.x;
  const long long r1 = p.rows * (blockIdx.x + 1) / gridDim.x;
  if (warp < R * 4) {
    Consumer(p, m).run(r0, r1);
  } else if (warp == R * 4) {
    if (lane == 0) Producer(p, m).run(r0, r1);
  } else {
    Last(p, m, warp - R * 4 - 1).run(r0, r1);
  }
}

bool aligned2(const void* ptr) { return ptr && (reinterpret_cast<uintptr_t>(ptr) & 1) == 0; }

}  // namespace

extern "C" {

// The build's geometry (what ops/tail.py::tail_wgmma_plan needs): out[0] R,
// out[1] stripe columns, out[2] x ring pixels, out[3..5] x, u2 and hr rows
// held, out[6] weight slots, out[7] dynamic shared memory a block, out[8]
// threads a block.
int vr_tail_fused_wgmma_config(int* out) {
  out[0] = R;
  out[1] = SW;
  out[2] = XP;
  out[3] = DX;
  out[4] = DU;
  out[5] = DH;
  out[6] = WS;
  out[7] = SMEM;
  out[8] = kThreads;
  return 0;
}

// The arguments of vr_tail_fused_mma, then the plan (PLAN_LEN int64 values
// of ops/tail.py::tail_wgmma_plan: the build's geometry as the plan assumed
// it, the grid, the stripes and rows, the weights' box and swizzle). bf16
// at nf 64, x and the two wide weights 16-byte aligned only. Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for a call or plan this
// build does not take, cudaErrorNotSupported when a tensor map cannot be
// encoded.
int vr_tail_fused_wgmma(int dtype, int nf, const void* x, void* y, const void* w_up2,
                        const void* b_up2, const void* w_hr, const void* b_hr,
                        const void* w_last, const void* b_last, int B, int H2, int W2,
                        void* stream, const long long* plan, int plan_len) {
  if (dtype != 1 || nf != NF || B <= 0 || H2 <= 0 || W2 <= 0 || H2 > (1 << 29) ||
      W2 > (1 << 29))
    return cudaErrorInvalidValue;
  if (!x || !w_up2 || !w_hr || !aligned16(x) || !aligned16(w_up2) || !aligned16(w_hr) ||
      !aligned2(y) || !aligned2(b_up2) || !aligned2(b_hr) || !aligned2(w_last) ||
      !aligned2(b_last))
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long OH = 2LL * H2, OW = 2LL * W2, S = (OW + SW - 1) / SW;
  if (plan[0] != R || plan[1] != SW || plan[2] != XP || plan[3] != DX || plan[4] != DU ||
      plan[5] != DH || plan[6] != WS || plan[7] != SMEM || plan[15] != kThreads)
    return cudaErrorInvalidValue;
  const long long grid = plan[8];
  if (grid <= 0 || grid > 65535 || plan[9] != S || plan[10] != (long long)B * S * OH ||
      plan[11] != NF || plan[12] != 16 || plan[13] != 9 || plan[14] != 128)
    return cudaErrorInvalidValue;
  TailParams k = {};
  const long long dims[3] = {NF, NF, 9}, strides[2] = {NF * 2, NF * NF * 2};
  const long long box[3] = {plan[11], plan[12], plan[13]};
  if (!encode(&k.tm_w[0], w_up2, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&k.tm_w[1], w_hr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorNotSupported;
  k.x = static_cast<const bf16*>(x);
  k.w_last = static_cast<const bf16*>(w_last);
  k.y = static_cast<bf16*>(y);
  k.b_up2 = static_cast<const bf16*>(b_up2);
  k.b_hr = static_cast<const bf16*>(b_hr);
  k.b_last = static_cast<const bf16*>(b_last);
  k.rows = (long long)B * S * OH;
  k.H2 = H2;
  k.W2 = W2;
  k.OH = (int)OH;
  k.OW = (int)OW;
  k.S = (int)S;
  cudaError_t e =
      cudaFuncSetAttribute(tail_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tail_wgmma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  tail_wgmma_kernel<<<(int)grid, kThreads, SMEM, static_cast<cudaStream_t>(stream)>>>(k);
  return cudaGetLastError();
}

}  // extern "C"
