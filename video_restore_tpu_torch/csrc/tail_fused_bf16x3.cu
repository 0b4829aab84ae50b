// The RRDBNet tail, fp32 route ("bf16x3"): upconv2 -> conv_hr -> conv_last in
// one launch, for fp32 activations at nf 64, the two wide convs on the bf16
// tensor cores as three bf16 parts a value (K1's "bf16x3" arithmetic,
// conv3x3_bf16x3_wgmma.cu), over rolling rows in shared memory.
//
// It computes exactly the function of tail_fused.cu at fp32:
//
//   u2  = lrelu(conv_up2(nearest2x(x)) + b_up2)     (B, 2 H2, 2 W2, 64)
//   hr  = lrelu(conv_hr(u2) + b_hr)                 (B, 2 H2, 2 W2, 64)
//   out = conv_last(hr) + b_last                    (B, 2 H2, 2 W2, 3)
//
// every conv SAME at the 2 H2 x 2 W2 frame (u2 and hr zero outside it),
// every rounding to fp32, u2 and hr never in device memory. It replaces, for
// the calls ops/tail.py::tail_fused_route sends it (fp32 at nf 64, aligned
// contiguous operands), pallas_tail.py:1018 tail_fused_q (VRT_TAIL_Q=1,
// ops/tail.py::tail_fused_q). The default tail's entry points
// (pallas_tail.py:266 tail_fused_raw, :425 tail_fused) stay the fp32 chain at
// fp32 (ops/tail.py::default_tail_route): this kernel measured 1.04x its time,
// and 1.43x since the chain's conv_last runs on conv3x3_narrow.cu.
//
// Sums: upconv2 and conv_hr in K1 "bf16x3"'s order (per 16 input channels,
// the nine taps in order, the six products a2 w0, a1 w1, a0 w2, a1 w0, a0 w1,
// a0 w0 into one fp32 accumulator from zero, then bias and lrelu); conv_last
// on fp32 FMAs in conv3x3.cu's order (input channel, then ky, kx, from zero),
// then the bias, which is also the order of K1's narrow fp32 conv_last
// (conv3x3_narrow.cu, last32_kernel). So the kernel equals the fp32
// three-launch chain (upconv2 and conv_hr on K1 "bf16x3", conv_last on K1
// "narrow", or forced "fma") bit for bit.
//
// What bounds it on the H100: at 7680x4320 the two wide convs are 4.89e12
// useful operations, six bf16 products a MAC at 989 TFLOP/s: 29.7 ms;
// conv_last's 1.15e11 on fp32 FMAs, 1.7 ms at 67 TFLOP/s, run beside them
// on the CUDA cores, so the bound is the larger, 29.7 ms. The
// bf16 tail's rings (tail_fused_wgmma.cu) do not fit in three parts (its x
// ring would be 138 KB, its u2 ring 120 KB). The design:
//
//  - Column stripes, rolling rows, one output row a step. A block owns SW =
//    60 output columns of a stripe and walks down a segment of its rows. At
//    step t upconv2 computes u2 row t (the `wgmma` m64 row of fine columns
//    X - 2 .. X + 61), conv_hr hr row t - 1 (X - 1 .. X + 62, 62 needed)
//    and conv_last output row t - 2 (X .. X + 59). A segment of L rows
//    takes L + 4 steps.
//  - Each conv is K1 "bf16x3"'s at 64 pixels by 64 couts, the two consumer
//    warpgroups one 32-cout half each (m64n32k16). upconv2's A operand: a
//    producer warpgroup fills two stages of split windows (3 fine rows x
//    66 pixels x 16 channels, three parts, K1's swizzled layout), each
//    thread loading its fp32 values at the fine grid from coarse pixel
//    (y >> 1, x >> 1) (zero outside the 2x frame) before it waits for a
//    free stage, then splitting them (K1's split).
//  - u2 in a ring of 3 rows already split: upconv2's epilogue (bias,
//    lrelu, the frame mask) writes each value's three bf16 parts in the
//    layout `wgmma` reads (a row: 16-channel planes of 66 pixels a part,
//    32-byte swizzle), fenced to the async proxy before a barrier over the
//    consumers; conv_hr's A operand is the ring itself. hr in a ring of 3
//    rows in fp32 (272-byte pixels, the even pixels of a row before its odd
//    ones, so conv_last's 16-byte reads meet no bank conflict) written by
//    conv_hr's epilogue.
//  - Weights stream in stages of one tap row: 3 taps x 16 input channels x
//    64 couts x 3 parts (18,432 bytes, two boxes of 32 couts in the 64-byte
//    swizzle, K1's cout-32 layout) through 3 slots that one thread of a warp
//    of their own keeps full with TMA (24 stages a step).
//  - conv_last on a warp of its own, one output row a step, two pixels (3
//    couts each) a lane; its weights fp32 in shared memory, a float4 of
//    three couts a (tap, channel). It waits for a step's hr row on an
//    mbarrier the consumers arrive on, and arrives on another once it has
//    read the rows, which the consumers wait for before they overwrite one.
//  - A persistent grid, one block an SM; the plan
//    (ops/tail.py::tail_x3_plan) cuts the concatenated stripes' rows into
//    one run a block.
//  - The roles are dispatched before the consumers' code (which follows
//    no branch on the warp): `wgmma`s behind a divergent branch are
//    serialised by ptxas (C7518).
// 231,184 bytes of shared memory, 448 threads a block, 120 registers, no
// spills.
//
// Measured (tools/probe_k6.py --dtype fp32; NVIDIA H100 80GB HBM3 at 700 W;
// the 8K tail, 1x2160x3840x64 -> 1x4320x7680x3): 73.7-75.6 ms against the
// fp32 chain's 70.5-72.1 and tail_fused.cu's 337-340, 39-40% of its bound.
// Without the MMAs 34.7-34.9; with two of the six products 48; without any
// weight load 71.3 (so a cluster multicasting the weight stages could not
// pass the chain). The clock build: the consumers wait for weights 8-11% of
// their walk and spend 6-7% in epilogues; the producer and the weights'
// thread idle 77-90%. What holds it is the n32 MMAs between those waits.
// Measured and not kept: u2 in fp32 split again by the producer for conv_hr
// (114-116 ms, the `wgmma`s then serialised), conv_last's weights read
// through L1 (91.7: conv_last's warp became the bottleneck), two weight
// slots (101), conv_hr's first tap rows issued under upconv2's epilogue
// into a second accumulator (no gain).

#define VR_X3_DEVICE_ONLY
#include "conv3x3_bf16x3_wgmma.cu"

namespace {

constexpr int T_NF = 64;
constexpr int T_SW = 60;                               // output columns of a stripe
constexpr int T_WS = 3;                                // weight slots of one tap row
constexpr int T_AS = 2;                                // stages of split windows
constexpr int T_PH = 3;                                // rows of a window
// a part of a window, swizzled; on 256 bytes, the 32-byte swizzle's period
constexpr int T_A_PART = (T_PH * PW * A_ROW + 255) / 256 * 256;
constexpr int T_A_STAGE = 3 * T_A_PART;
constexpr int T_W_TAP = KC * 32 * 2;                   // 16 cin x 32 couts, bf16
constexpr int T_W_PART = 3 * T_W_TAP;                  // a part's tap row
constexpr int T_W_HALF = 3 * T_W_PART;                 // a 32-cout half, three parts
constexpr int T_W_SLOT = 2 * T_W_HALF;                 // 18,432
constexpr int T_U_PLANE = PW * A_ROW;                  // 16 channels of a u2 row, one part
constexpr int T_U_ROW = 4 * 3 * T_U_PLANE;             // (channel stage, part) planes
constexpr int T_HPX = T_SW + 2;                        // hr pixels conv_last reads
constexpr int T_HP = T_NF * 4 + 16;                    // bytes of an hr pixel (16 of pad)
constexpr int T_HODD = (T_HPX + 1) / 2 * T_HP;         // the odd pixels of an hr row
constexpr int T_H_ROW = T_HODD + T_HPX / 2 * T_HP;
constexpr int T_W_OFF = 0;
constexpr int T_A_OFF = T_W_OFF + T_WS * T_W_SLOT;
constexpr int T_U_OFF = T_A_OFF + T_AS * T_A_STAGE;
constexpr int T_H_OFF = T_U_OFF + 3 * T_U_ROW;
constexpr int T_L_OFF = T_H_OFF + 3 * T_H_ROW;
constexpr int T_B_OFF = T_L_OFF + 9 * T_NF * 16;
constexpr int T_BAR_OFF = T_B_OFF + (2 * T_NF + 4) * 4;
constexpr int T_BARS = 2 * T_WS + 2 * T_AS + 2;
constexpr int T_SMEM = 1024 + T_BAR_OFF + T_BARS * 8;
// the consumer warpgroups (warps 0-7), the producer warpgroup (8-11), the
// weights' warp (12), conv_last's warp (13)
constexpr int T_PROD = NC * 4, T_WARP_W = T_PROD + 4, T_WARP_L = T_WARP_W + 1;
constexpr int T_THREADS = (T_WARP_L + 1) * 32;
constexpr int T_PLAN_LEN = 10;
static_assert(T_SW % 2 == 0 && T_SW + 4 <= 64 && T_SW / 2 <= 32,
              "u2's 64 pixels cover the stripe and its halo of 2; a lane takes two outputs");
static_assert(T_SMEM <= SMEM_MAX, "one block an SM");
static_assert(T_A_OFF % 1024 == 0 && T_A_PART % 256 == 0 && T_W_HALF % 1024 == 0 &&
                  T_U_OFF % 256 == 0 && T_U_PLANE % 32 == 0 && T_H_OFF % 16 == 0 &&
                  T_HP % 16 == 0 && T_HODD % 16 == 0 && T_L_OFF % 16 == 0 &&
                  T_BAR_OFF % 8 == 0,
              "alignment");

// steps of a segment of L rows: conv_last, two rows behind upconv2, from the
// segment's first row - 2 until it has written the last
__host__ __device__ constexpr int tx3_steps(int L) { return L + 4; }

struct __align__(64) TailX3Params {
  CUtensorMap tm_w[2];  // upconv2's and conv_hr's weight parts: (cout, cin, 9, 3)
  const float* x;       // (B, H2, W2, 64)
  float* y;             // (B, OH, OW, 3)
  const float* b_up2;
  const float* b_hr;
  const float* w_last;  // HWIO (3, 3, 64, 3)
  const float* b_last;
  long long rows;       // B * stripes * OH: the rows the blocks share
  int H2, W2, OH, OW, S;
};

// One segment: image n, the stripe at column X, output rows [y0, y1).
struct TSeg {
  int n, X, y0, y1;
};

__device__ __forceinline__ bool tseg_at(const TailX3Params& p, long long r, long long r1,
                                        TSeg& s) {
  if (r >= r1) return false;
  const long long idx = r / p.OH;
  s.y0 = (int)(r - idx * p.OH);
  const long long len = r1 - r < (long long)(p.OH - s.y0) ? r1 - r : (long long)(p.OH - s.y0);
  s.y1 = s.y0 + (int)len;
  s.n = (int)(idx / p.S);
  s.X = (int)(idx - (long long)s.n * p.S) * T_SW;
  return true;
}

__device__ __forceinline__ int ring3(int row) {
  const int m = row % 3;
  return m < 0 ? m + 3 : m;
}

// where hr pixel px of a row lies in it
__device__ __forceinline__ int thr_at(int px) { return ((px & 1) ? T_HODD : 0) + (px >> 1) * T_HP; }

// The shared-memory map (1024-aligned base): the weight slots, the window
// stages, the u2 ring (three parts) and the hr ring (fp32), conv_last's
// weights (fp32, a float4 of the three couts of a tap and channel), the biases,
// then the barriers: the weight slots' full and empty, the window stages'
// full and empty, hfull (a step's hr row is written: one arrive a consumer
// warp) and hread (conv_last has read the rows). Each ring is a FIFO whose
// item c sits in slot c % depth at phase (c / depth) & 1; hfull and hread
// complete once a step.
struct TSmem {
  unsigned char* at;  // the base as a pointer
  uint32_t base, wfull, wempty, afull, aempty, hfull, hread;
};

__device__ __forceinline__ TSmem tsmem(unsigned char* smem) {
  TSmem m;
  const uint32_t s0 = smem_u32(smem);
  m.base = (s0 + 1023u) & ~1023u;
  m.at = smem + (m.base - s0);
  m.wfull = m.base + T_BAR_OFF;
  m.wempty = m.wfull + 8 * T_WS;
  m.afull = m.wempty + 8 * T_WS;
  m.aempty = m.afull + 8 * T_AS;
  m.hfull = m.aempty + 8 * T_AS;
  m.hread = m.hfull + 8;
  return m;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(NC * 128) : "memory");
}

// tools/probe_k6.py's clock build (-DVR_PROBE_CLOCKS): each role's cycles
// (waits, work, its whole walk), written over the output, 16 values a block
#ifdef VR_PROBE_CLOCKS
#define TX3_CLOCKED(var, stmt)          \
  do {                                  \
    const long long c0_ = clock64();    \
    stmt;                               \
    var += clock64() - c0_;             \
  } while (0)
#define TX3_CLOCK_NOW() clock64()
__device__ __forceinline__ void tx3_clocks(const TailX3Params& p, int slot, long long v) {
  p.y[blockIdx.x * 16 + slot] = (float)v;
}
#else
#define TX3_CLOCKED(var, stmt) stmt
#define TX3_CLOCK_NOW() 0LL
#endif

// ---- the weights: one thread -----------------------------------------------------

// Every weight stage of the block's rows [r0, r1), in the order the
// consumers take them: per step upconv2's twelve (4 channel stages x 3 tap
// rows), then conv_hr's; each stage two boxes of 32 couts.
__device__ void tx3_weights(const TailX3Params& p, const TSmem& m, long long r0, long long r1) {
  uint32_t wn = 0;
  long long c_wait = 0;
  const long long c_all = TX3_CLOCK_NOW();
  TSeg s;
  for (long long r = r0; tseg_at(p, r, r1, s); r += s.y1 - s.y0) {
    const int T = tx3_steps(s.y1 - s.y0);
    for (int t = 0; t < T; ++t)
      for (int conv = 0; conv < 2; ++conv)
        for (int k = 0; k < 4; ++k)
          for (int ky = 0; ky < 3; ++ky, ++wn) {
            const uint32_t slot = wn % T_WS;
            TX3_CLOCKED(c_wait, mbar_wait(m.wempty + 8 * slot, ((wn / T_WS) & 1) ^ 1));
            const uint32_t full = m.wfull + 8 * slot, dst = m.base + T_W_OFF + slot * T_W_SLOT;
#ifdef VR_PROBE_NO_WLOAD  // tools/probe_k6.py: the weight stages arrive empty
            (void)dst;
            mbar_arrive(full);
#else
            mbar_expect_tx(full, T_W_SLOT);
            tma_load_4d(dst, &p.tm_w[conv], full, 0, k * KC, 3 * ky, 0);
            tma_load_4d(dst + T_W_HALF, &p.tm_w[conv], full, 32, k * KC, 3 * ky, 0);
#endif
          }
  }
#ifdef VR_PROBE_CLOCKS
  tx3_clocks(p, 0, c_wait);
  tx3_clocks(p, 1, clock64() - c_all);
#endif
  (void)c_wait;
  (void)c_all;
}

// ---- the producer warpgroup: upconv2's split windows ----------------------------

struct TProducer {
  const TailX3Params& p;
  TSmem m;
  int pt;
  uint32_t an = 0;  // window stages filled
  long long c_empty = 0, c_split = 0;  // tools/probe_k6.py's clocks

  __device__ TProducer(const TailX3Params& p_, const TSmem& m_) : p(p_), m(m_) {
    pt = threadIdx.x - T_PROD * 32;
  }

  // chunk c of upconv2's window of channel stage k for u2 row `row` (8
  // channels of window pixel c / 2: fine row row - 1 + c / 2 / PW, fine
  // column X - 3 + c / 2 % PW), from coarse pixel (y >> 1, x >> 1); zero
  // outside the 2x frame.
  __device__ __forceinline__ void load(const TSeg& s, int row, int k, int c, float4& lo,
                                       float4& hi) const {
    const int pix = c >> 1, ry = pix / PW, px = pix - ry * PW;
    const int fy = row - 1 + ry, fx = s.X - 3 + px;
    if (fy >= 0 && fy < p.OH && fx >= 0 && fx < p.OW) {
      const float4* src = reinterpret_cast<const float4*>(
          p.x + (((long long)s.n * p.H2 + (fy >> 1)) * p.W2 + (fx >> 1)) * T_NF + k * KC +
          (c & 1) * 8);
      lo = __ldg(src);
      hi = __ldg(src + 1);
    } else {
      lo = hi = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // The next window stage (channel stage k of u2 row `row`): this thread's
  // chunks c = pt + PT u loaded, then, once the stage is free, split into
  // its three parts (K1's split), fenced to the async proxy; one arrive a
  // warp.
  __device__ __forceinline__ void fill(const TSeg& s, int row, int k) {
    constexpr int CHUNKS = T_PH * PW * 2, FULL = CHUNKS / PT, TAIL = CHUNKS % PT;
    constexpr int N = FULL + (TAIL ? 1 : 0);
    float4 v[N][2];
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (u < FULL || pt < TAIL) load(s, row, k, pt + PT * u, v[u][0], v[u][1]);
    const uint32_t slot = an % T_AS;
    TX3_CLOCKED(c_empty, mbar_wait(m.aempty + 8 * slot, ((an / T_AS) & 1) ^ 1));
    const long long c0 = TX3_CLOCK_NOW();
    const uint32_t dst = m.base + T_A_OFF + slot * T_A_STAGE;
#ifndef VR_PROBE_NO_SPLIT  // tools/probe_k6.py: the stages as they lie
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (u < FULL || pt < TAIL) {
        const int c = pt + PT * u;
        uint4 p0, p1, p2;
        split8(v[u][0], v[u][1], p0, p1, p2);
        const uint32_t off = swizzle<32>(dst + c * 16) - m.base;
        *reinterpret_cast<uint4*>(m.at + off) = p0;
        *reinterpret_cast<uint4*>(m.at + off + T_A_PART) = p1;
        *reinterpret_cast<uint4*>(m.at + off + 2 * T_A_PART) = p2;
      }
#endif
    fence_async_shared();  // this thread's stores, before `wgmma` reads them
    __syncwarp();
    c_split += TX3_CLOCK_NOW() - c0;
    if ((pt & 31) == 0) mbar_arrive(m.afull + 8 * slot);
    ++an;
  }

  // Per step u: upconv2's four window stages (u2 row u).
  __device__ void run(long long r0, long long r1) {
    const long long c_all = TX3_CLOCK_NOW();
    TSeg s;
    for (long long r = r0; tseg_at(p, r, r1, s); r += s.y1 - s.y0) {
      const int T = tx3_steps(s.y1 - s.y0);
      for (int t = 0, u = s.y0 - 2; t < T; ++t, ++u)
        for (int k = 0; k < 4; ++k) fill(s, u, k);
    }
#ifdef VR_PROBE_CLOCKS
    if (pt == 0) {
      tx3_clocks(p, 3, c_empty);
      tx3_clocks(p, 5, c_split);
      tx3_clocks(p, 6, clock64() - c_all);
    }
#endif
    (void)c_all;
  }
};

// ---- conv_last: one warp ---------------------------------------------------------

// conv_last at output row `row` of segment s (hr rows row - 1 .. row + 1 in
// the ring) for this lane's pixels 2 lane, + 1 (lanes past the stripe
// repeat the last pair, storing nothing): per channel, each over ky, kx, in
// conv3x3.cu's order, from zero; then the bias, the stores inside the frame.
__device__ __forceinline__ void tx3_last_row(const TailX3Params& p, const TSmem& m,
                                             const TSeg& s, int row) {
  const int lane = threadIdx.x & 31;
  const int o = 2 * (lane < T_SW / 2 ? lane : T_SW / 2 - 1);
  float la[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const unsigned char* hr[3];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) hr[ky] = m.at + T_H_OFF + ring3(row - 1 + ky) * T_H_ROW;
  const float4* lw = reinterpret_cast<const float4*>(m.at + T_L_OFF);
#pragma unroll 1
  for (int i = 0; i < T_NF / 4; ++i) {
    float4 v[3][4];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[ky][c] = *reinterpret_cast<const float4*>(hr[ky] + thr_at(o + c) + i * 16);
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      float4 w[9];  // the channel's nine taps, loaded before its FMAs
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = lw[t * T_NF + 4 * i + ci];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const float4& hv = v[ky][pp + kx];
            const float xv = ci == 0 ? hv.x : ci == 1 ? hv.y : ci == 2 ? hv.z : hv.w;
            const float4& wt = w[ky * 3 + kx];
            la[pp][0] = fmaf(xv, wt.x, la[pp][0]);
            la[pp][1] = fmaf(xv, wt.y, la[pp][1]);
            la[pp][2] = fmaf(xv, wt.z, la[pp][2]);
          }
    }
  }
  if (lane >= T_SW / 2) return;
  const float* bl = reinterpret_cast<const float*>(m.at + T_B_OFF + 2 * T_NF * 4);
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    const int fx = s.X + o + pp;
    if (fx >= p.OW) continue;
    float* y = p.y + (((long long)s.n * p.OH + row) * p.OW + fx) * 3;
    y[0] = __fadd_rn(la[pp][0], bl[0]);
    y[1] = __fadd_rn(la[pp][1], bl[1]);
    y[2] = __fadd_rn(la[pp][2], bl[2]);
  }
}

// Per step: wait for hr row u - 1, compute output row u - 2 where the
// segment needs it, let the rows go.
__device__ void tx3_last(const TailX3Params& p, const TSmem& m, long long r0, long long r1) {
  TSeg s;
  uint32_t k = 0;
  const int lane = threadIdx.x & 31;
  long long c_wait = 0, c_row = 0;
  const long long c_all = TX3_CLOCK_NOW();
  for (long long r = r0; tseg_at(p, r, r1, s); r += s.y1 - s.y0) {
    const int T = tx3_steps(s.y1 - s.y0);
    for (int t = 0, u = s.y0 - 2; t < T; ++t, ++u, ++k) {
      TX3_CLOCKED(c_wait, mbar_wait(m.hfull, k & 1));
#ifndef VR_PROBE_NO_LAST  // tools/probe_k6.py: without conv_last
      if (u - 2 >= s.y0) TX3_CLOCKED(c_row, tx3_last_row(p, m, s, u - 2));
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(m.hread);
    }
  }
#ifdef VR_PROBE_CLOCKS
  if (lane == 0) {
    tx3_clocks(p, 7, c_wait);
    tx3_clocks(p, 8, c_row);
    tx3_clocks(p, 9, clock64() - c_all);
  }
#endif
  (void)c_wait;
  (void)c_row;
  (void)c_all;
}

// ---- the consumer warpgroups -----------------------------------------------------

struct TConsumer {
  const TailX3Params& p;
  TSmem m;
  int wg, wl, g, q, lane;
  uint32_t wn = 0, an = 0;  // weight and window stages taken
  long long c_a = 0, c_w = 0, c_h = 0, c_epi = 0;  // tools/probe_k6.py's clocks
  float bias[2][4][2];      // b_up2's and b_hr's at this thread's channels 32 wg + 8 i + 2 q, + 1
  TSeg s;

  __device__ TConsumer(const TailX3Params& p_, const TSmem& m_) : p(p_), m(m_) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wg = warp >> 2;
    wl = warp & 3;
    g = lane >> 2;
    q = lane & 3;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b = *reinterpret_cast<const float2*>(
            m.at + T_B_OFF + (c * T_NF + 32 * wg + 8 * i + 2 * q) * 4);
        bias[c][i][0] = b.x;
        bias[c][i][1] = b.y;
      }
  }

  // One tap row's group into acc (this warpgroup's 32 couts at 64 pixels):
  // A at `ab` (the window row's 16 channels, part 0; parts `part` bytes
  // apart), the three taps' six products smallest first on the next weight
  // stage, the first of a conv overwriting acc; committed.
  __device__ __forceinline__ void group(float (&acc)[16], uint32_t ab, uint32_t part, bool first) {
    const uint64_t da0 = make_desc(0, 16, 8 * A_ROW, 3);
    const uint64_t db0 = make_desc(0, 16, 8 * 32 * 2, 2);
    const uint32_t wslot = wn % T_WS;
    TX3_CLOCKED(c_w, mbar_wait(m.wfull + 8 * wslot, (wn / T_WS) & 1));
    fence_acc(acc);
    wg_fence();
    const uint32_t wb = m.base + T_W_OFF + wslot * T_W_SLOT + wg * T_W_HALF;
#ifndef VR_PROBE_NO_MMA  // tools/probe_k6.py: the rings, fills and epilogues alone
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int pr = 6 - VR_PROBE_PRODUCTS; pr < 6; ++pr) {
        const uint32_t a_off = ab + PA(pr) * part + kx * A_ROW;
        const uint32_t b_off = wb + PWP(pr) * T_W_PART + kx * T_W_TAP;
        Wgmma<32>::run(acc, da0 + (uint64_t)(a_off >> 4), db0 + (uint64_t)(b_off >> 4),
                       !(first && kx == 0 && pr == 6 - VR_PROBE_PRODUCTS));
      }
#else
    (void)ab;
    (void)part;
    (void)first;
    (void)wb;
#endif
    wg_commit();
    ++wn;
  }

  // the u2 ring's rows row - 1 .. row + 1 as conv_hr's A: tap row ky,
  // channel stage k, part 0
  __device__ __forceinline__ uint32_t u2_at(int row, int k, int ky) const {
    return m.base + T_U_OFF + ring3(row - 1 + ky) * T_U_ROW + 3 * k * T_U_PLANE;
  }

  // upconv2's sums into acc: per channel stage (a window stage), its three
  // tap rows (a weight stage each); a weight stage (and, after its last,
  // the window stage) is released once the next group is committed and its
  // own is done; drained.
  __device__ __forceinline__ void upconv2(float (&acc)[16]) {
    uint32_t aslot = 0;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      aslot = an % T_AS;
      TX3_CLOCKED(c_a, mbar_wait(m.afull + 8 * aslot, (an / T_AS) & 1));
      const uint32_t ab = m.base + T_A_OFF + aslot * T_A_STAGE;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        group(acc, ab + ky * PW * A_ROW, T_A_PART, (k | ky) == 0);
        if (k | ky) {
          wg_wait<1>();  // the group before is done: release its slots
          if (lane == 0) {
            mbar_arrive(m.wempty + 8 * ((wn - 2) % T_WS));
            if (ky == 0) mbar_arrive(m.aempty + 8 * ((an - 1) % T_AS));
          }
        }
      }
      ++an;
    }
    wg_wait<0>();
    if (lane == 0) {
      mbar_arrive(m.wempty + 8 * ((wn - 1) % T_WS));
      mbar_arrive(m.aempty + 8 * aslot);
    }
    fence_acc(acc);
  }

  // conv_hr's sums at hr row `row` into acc (u2 rows row - 1 .. row + 1 of
  // the ring), released as upconv2's; drained.
  __device__ __forceinline__ void conv_hr(float (&acc)[16], int row) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        group(acc, u2_at(row, k, ky), T_U_PLANE, (k | ky) == 0);
        if (k | ky) {
          wg_wait<1>();  // the group before is done: release its slot
          if (lane == 0) mbar_arrive(m.wempty + 8 * ((wn - 2) % T_WS));
        }
      }
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(m.wempty + 8 * ((wn - 1) % T_WS));
    fence_acc(acc);
  }

  // upconv2's epilogue (u2 row `row` into the u2 ring as three bf16 parts,
  // swizzled as `wgmma` reads them) or conv_hr's (hr row `row` into the hr
  // ring, fp32): bias, lrelu, zero outside the frame. This thread's pixels
  // are 16 wl + g + 8 h, its channels 32 wg + 8 i + 2 q and + 1.
  template <int CONV>
  __device__ __forceinline__ void epi(const float (&acc)[16], int row) const {
    const bool row_in = row >= 0 && row < p.OH;
    const uint32_t dst = CONV == 0 ? m.base + T_U_OFF + ring3(row) * T_U_ROW
                                   : m.base + T_H_OFF + ring3(row) * T_H_ROW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 16 * wl + g + 8 * h;
      if (CONV == 1 && px >= T_HPX) continue;  // hr's pixels no output reads
      const int fx = s.X - 2 + CONV + px;
      const bool in = row_in && fx >= 0 && fx < p.OW;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = 32 * wg + 8 * i + 2 * q;
        float v0 = __fadd_rn(acc[4 * i + 2 * h], bias[CONV][i][0]);
        float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], bias[CONV][i][1]);
        v0 = in ? (v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0)) : 0.f;
        v1 = in ? (v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1)) : 0.f;
        if (CONV == 0) {
          // the three parts of the pair, K1's split
          const __nv_bfloat162 b0 = __floats2bfloat162_rn(v0, v1);
          const float2 f0 = __bfloat1622float2(b0);
          const float e0 = __fsub_rn(v0, f0.x), e1 = __fsub_rn(v1, f0.y);
          const __nv_bfloat162 b1 = __floats2bfloat162_rn(e0, e1);
          const float2 f1 = __bfloat1622float2(b1);
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(__fsub_rn(e0, f1.x), __fsub_rn(e1, f1.y));
          const uint32_t a = dst + 3 * (co >> 4) * T_U_PLANE + px * A_ROW + (co & 15) * 2;
          *reinterpret_cast<__nv_bfloat162*>(m.at + (swizzle<32>(a) - m.base)) = b0;
          *reinterpret_cast<__nv_bfloat162*>(m.at + (swizzle<32>(a + T_U_PLANE) - m.base)) = b1;
          *reinterpret_cast<__nv_bfloat162*>(m.at + (swizzle<32>(a + 2 * T_U_PLANE) - m.base)) =
              b2;
        } else {
          *reinterpret_cast<float2*>(m.at + (dst + thr_at(px) + co * 4 - m.base)) =
              make_float2(v0, v1);
        }
      }
    }
  }

  // Per step u: upconv2 at u2 row u into the ring, fenced for conv_hr's
  // `wgmma`s; conv_hr at hr row u - 1 (u2 rows u - 2 .. u), written once
  // conv_last has read the row it replaces, and handed to it.
  __device__ void run(long long r0, long long r1) {
    uint32_t k = 0;  // the block's steps
    const long long c_all = TX3_CLOCK_NOW();
    for (long long r = r0; tseg_at(p, r, r1, s); r += s.y1 - s.y0) {
      const int T = tx3_steps(s.y1 - s.y0);
      for (int t = 0, u = s.y0 - 2; t < T; ++t, ++u, ++k) {
        float acc[16];
        upconv2(acc);
        TX3_CLOCKED(c_epi, epi<0>(acc, u));
        fence_async_shared();  // u2 before conv_hr's wgmmas read it
        consumers_sync();
        conv_hr(acc, u - 1);
        // conv_last read the row this one replaces
        if (k > 0) TX3_CLOCKED(c_h, mbar_wait(m.hread, (k - 1) & 1));
        TX3_CLOCKED(c_epi, epi<1>(acc, u - 1));
        __syncwarp();
        if (lane == 0) mbar_arrive(m.hfull);
      }
    }
#ifdef VR_PROBE_CLOCKS
    if (threadIdx.x == 0) {
      tx3_clocks(p, 10, c_a);
      tx3_clocks(p, 11, c_w);
      tx3_clocks(p, 12, c_h);
      tx3_clocks(p, 13, c_epi);
      tx3_clocks(p, 14, clock64() - c_all);
    }
#endif
    (void)c_all;
  }
};

__global__ void __launch_bounds__(T_THREADS, 1)
    tail_bf16x3_kernel(const __grid_constant__ TailX3Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const TSmem m = tsmem(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the stages and rings are zero before anything reads them
  for (int o = T_A_OFF + tid * 16; o < T_L_OFF; o += T_THREADS * 16)
    *reinterpret_cast<uint4*>(m.at + o) = make_uint4(0, 0, 0, 0);
  // conv_last's weights, the three couts of a (tap, channel) and 0
  for (int i = tid; i < 9 * T_NF; i += T_THREADS)
    *reinterpret_cast<float4*>(m.at + T_L_OFF + 16 * i) =
        make_float4(p.w_last[3 * i], p.w_last[3 * i + 1], p.w_last[3 * i + 2], 0.f);
  // b_up2, b_hr, b_last
  float* bias = reinterpret_cast<float*>(m.at + T_B_OFF);
  for (int i = tid; i < 2 * T_NF + 3; i += T_THREADS)
    bias[i] = i < T_NF ? p.b_up2[i] : i < 2 * T_NF ? p.b_hr[i - T_NF] : p.b_last[i - 2 * T_NF];
  fence_async_shared();
  if (tid == 0) {
    for (int i = 0; i < T_WS; ++i) {
      mbar_init(m.wfull + 8 * i, 1);        // the expect_tx
      mbar_init(m.wempty + 8 * i, NC * 4);  // one arrive a consumer warp
    }
    for (int i = 0; i < T_AS; ++i) {
      mbar_init(m.afull + 8 * i, PT / 32);  // one arrive a producer warp
      mbar_init(m.aempty + 8 * i, NC * 4);
    }
    mbar_init(m.hfull, NC * 4);
    mbar_init(m.hread, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r0 = p.rows * blockIdx.x / gridDim.x;
  const long long r1 = p.rows * (blockIdx.x + 1) / gridDim.x;
  if (warp >= T_PROD) {
    if (warp < T_WARP_W)
      TProducer(p, m).run(r0, r1);
    else if (warp == T_WARP_W && lane == 0)
      tx3_weights(p, m, r0, r1);
    else if (warp == T_WARP_L)
      tx3_last(p, m, r0, r1);
    return;
  }
  TConsumer(p, m).run(r0, r1);
}

}  // namespace

extern "C" {

// fp32 at nf 64: x (B, H2, W2, 64) -> y (B, 2 H2, 2 W2, 3); w_up2 and w_hr
// the (3, 3, 3, 64, 64) bf16 parts of ops/tail.py::weight_parts, the rest
// fp32; then the plan (T_PLAN_LEN int64 values of ops/tail.py::tail_x3_plan:
// the source's stripe, weight slots, shared memory and threads as the plan
// assumed them, the grid, the stripes and the rows, the weight boxes' couts,
// input channels and taps). cudaErrorInvalidValue for a call or plan this
// build does not take, cudaErrorNotSupported when a tensor map cannot be
// encoded.
int vr_tail_fused_bf16x3(int nf, const void* x, void* y, const void* w_up2, const void* b_up2,
                         const void* w_hr, const void* b_hr, const void* w_last,
                         const void* b_last, int B, int H2, int W2, void* stream,
                         const long long* plan, int plan_len) {
  if (nf != T_NF || B <= 0 || H2 <= 0 || W2 <= 0 || H2 > (1 << 29) || W2 > (1 << 29))
    return cudaErrorInvalidValue;
  if (!x || !y || !w_up2 || !w_hr || !b_up2 || !b_hr || !w_last || !b_last || !aligned16(x) ||
      !aligned16(w_up2) || !aligned16(w_hr) || !aligned16(b_up2) || !aligned16(b_hr) ||
      (reinterpret_cast<uintptr_t>(y) & 3) || (reinterpret_cast<uintptr_t>(w_last) & 3) ||
      (reinterpret_cast<uintptr_t>(b_last) & 3))
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != T_PLAN_LEN) return cudaErrorInvalidValue;
  const long long OH = 2LL * H2, OW = 2LL * W2, S = (OW + T_SW - 1) / T_SW;
  const long long grid = plan[4];
  if (plan[0] != T_SW || plan[1] != T_WS || plan[2] != T_SMEM || plan[3] != T_THREADS ||
      grid <= 0 || grid > 65535 || plan[5] != S || plan[6] != (long long)B * S * OH ||
      plan[7] != 32 || plan[8] != KC || plan[9] != 3)
    return cudaErrorInvalidValue;
  TailX3Params k = {};
  const long long dims[4] = {T_NF, T_NF, 9, 3};
  const long long strides[3] = {T_NF * 2, T_NF * T_NF * 2, 9 * T_NF * T_NF * 2};
  const long long box[4] = {32, KC, 3, 3};
  if (!encode(&k.tm_w[0], w_up2, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&k.tm_w[1], w_hr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorNotSupported;
  k.x = static_cast<const float*>(x);
  k.y = static_cast<float*>(y);
  k.b_up2 = static_cast<const float*>(b_up2);
  k.b_hr = static_cast<const float*>(b_hr);
  k.w_last = static_cast<const float*>(w_last);
  k.b_last = static_cast<const float*>(b_last);
  k.rows = (long long)B * S * OH;
  k.H2 = H2;
  k.W2 = W2;
  k.OH = (int)OH;
  k.OW = (int)OW;
  k.S = (int)S;
  cudaError_t e =
      cudaFuncSetAttribute(tail_bf16x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tail_bf16x3_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  tail_bf16x3_kernel<<<(int)grid, T_THREADS, T_SMEM, static_cast<cudaStream_t>(stream)>>>(k);
  return cudaGetLastError();
}

}  // extern "C"
