// K5, Hopper route: one residual dense block (RDB) in one launch, or a whole
// RRDB in one cooperative launch, for bf16 activations at nf 64 / gc 32, on
// `wgmma` fed by TMA over rolling rings of rows in shared memory.
//
// It computes exactly the function of rdb_fused_mma.cu and rdb_fused.cu:
//
//   c_k = T(lrelu(conv_k([x | c_1 .. c_{k-1}]) + b_k))     k = 1..4
//   out = T(x + 0.2 * (conv_5([x | c_1 .. c_4]) + b_5))
//   out = T(x0 + 0.2 * out)                                 (optional x0)
//
// every conv SAME (each c_k zero outside the frame), sums in fp32, T() the
// rounding to bf16; the RRDB is x + 0.2 RDB3(RDB2(RDB1(x))). It replaces the
// same Pallas entry points of video_restore_tpu/ops as the other two K5
// sources:
//   pallas_rdb.py:257    rrdb_fused          (the VRT_PALLAS=1 body)
//   pallas_rdb.py:313    rdb_fused
//   pallas_stripe.py:1016 rrdb_stripe_padded
//   pallas_stripe.py:2079 rdb_stripe
// for the calls ops/rdb.py::rdb_route sends it: bf16 at (nf, gc) = (64, 32).
//
// What bounds it on the H100: a 1080p RDB is 9.94e11 useful operations
// against ~0.5 GB of compulsory traffic, so the tensor cores bound it: 1.005
// ms at the bf16 peak of 989 TFLOP/s. The square tiles of rdb_fused_mma.cu
// recompute a halo (1.47x the useful MACs) and feed `mma.sync` through
// `ldmatrix`; this design streams instead:
//
//  - Column stripes, rolling rows. A block owns SW = 54 output columns of a
//    stripe and walks down a segment of its rows. Each conv computes one
//    `wgmma` m64 row (64 pixels) per output row: conv k's pixel m is the
//    frame column X - 5 + k + m, so conv 5 writes X .. X + 53 and conv k
//    reads source s (x = 0, c_s) at ring column m + dx + (k - 1 - s). Within
//    a step of R = 3 rows (one consumer warpgroup a row), conv k computes
//    the rows base - (k - 1) + w: each conv one row behind the one before,
//    conv 5 four behind conv 1 (line-buffer fusion). Executed over useful
//    work: (64 / 54) x (1 + ~4 / L) for a segment of L rows (1.22 at 1080p).
//  - Rings in shared memory in the layout `wgmma` reads: one 64-byte row a
//    pixel per 32-channel plane, in the 64-byte swizzle that TMA writes and
//    `wgmma` reads (K1's layout, conv3x3_wgmma.cu). x holds R + 6 rows of 64
//    pixels in 2 planes; c_k holds R + 6 - k rows (conv 5 reads c_k
//    longest) of the SW + 10 - 2k pixels a needed output reads. The rings
//    lie end to end, so that a read past a row's end (only by pixels no
//    needed output reads) stays in the buffer. A tap's (dy, dx) and the
//    source's column offset move only the descriptor's start address; the
//    rings' modulo applies per tap row.
//  - Conv k's epilogue (bias, lrelu, frame mask, rounding: the arithmetic
//    of the other routes) writes c_k straight into its ring at swizzled
//    addresses, then `fence.proxy.async.shared::cta` and a named barrier
//    over the consumer warpgroups before any `wgmma` reads it. Conv 5's
//    epilogue adds the residual (read from the x ring into registers before
//    its MMAs) and x0 (device memory) and stores the output rows.
//  - Warp specialisation as in K1: one thread of a producer warpgroup keeps
//    TMA loads in flight (x rows through a 4-D map over (channels, W, H, B),
//    whose zero fill is SAME padding at every edge; weight stages through a
//    3-D map over (cout, cin, 9) per conv), R consumer warpgroups share each
//    weight stage (M = 192), setmaxnreg hands the producer's registers to
//    them. The grid is persistent, one block an SM; the plan
//    (ops/rdb.py::rdb_wgmma_plan) cuts the concatenated stripes' rows into
//    one run a block (294 or 295 rows at 1080p), so every block has the
//    same work but a segment's fill.
//  - Weights stream in stages of 18,432 bytes through VR_K5_WSLOTS = 3
//    slots: conv 1-4 32 input channels x 9 taps (K1's stage), conv 5 16 x 9
//    (64 couts, 128-byte swizzle). The x rows of the next step are loaded as
//    soon as conv 5 has read its x part (its first four stages: x leads the
//    growth order, so the sum's order is kept) (VR_K5_EARLY_X).
//  - Sums: per 16 input channels in growth order, the nine taps in order,
//    one k16 `wgmma` each into one fp32 accumulator: the order of
//    rdb_fused_mma.cu and of K1's five-launch chain, so the three give the
//    same bits.
//  - The RRDB is one cooperative launch of three passes with a grid-wide
//    barrier between them (RDB1: x -> y, RDB2: y -> scratch, RDB3 +
//    residual: scratch, x -> y) and `fence.proxy.async.global` around it,
//    since the next pass reads the last one's rows through TMA.
// 231,744 bytes of shared memory and 512 threads a block, the consumers at
// 152 registers a thread, no spills.
//
// Measured (tools/probe_k5k3.py --route wgmma, NVIDIA H100 80GB HBM3 at
// 700 W, a 1080p RDB): 2.75-2.78 ms against rdb_fused_mma.cu's 8.05-8.24. What
// holds it is each consumer warpgroup's rate of `wgmma`s, about one a ~110
// clocks whatever their width (K1 runs at the same rate): two warpgroups
// take 3.57-3.64 ms, one 6.0-7.3, at the same time a weight stage, while a
// second accumulator chain a warpgroup (3.69-3.73, not the function) and
// the loads (every copy arriving at once: 3.20-3.39 with two warpgroups)
// move little. Conv 1-4 are n32, the least work a `wgmma`. Measured and not
// kept: stripes of 50 columns (2.99), two weight slots (4.45-4.68 with two
// warpgroups), the next step's x rows loaded after conv 5 instead of after
// its x part (4.21-4.44), a fourth weight slot on 54-column stripes with
// two warpgroups (3.68-3.87), the next conv's x part issued before each
// epilogue (3.60-3.67 against 3.54-3.62), each stage's slot freed as soon
// as its MMAs end (3.70), the residual read from device memory (2.88
// against 2.81 with three warpgroups), a producer warp of its own in place
// of the warpgroup (three warpgroups then spill at 128 registers: 2.81-
// 2.84), a fourth consumer warpgroup on 46-column stripes (it faulted on
// its first launch; R is held to three). No cluster multicast of the
// weight stages: the loads alone (`loads`, every TMA copy and no MMA) take
// 0.93-0.95 ms of the 2.75 and the build without MMAs 1.03-1.05, so L2's
// weight traffic does not hold the kernel; its MMAs do (without loads
// 2.57-2.58).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

#ifndef VR_K5_ROWS
#define VR_K5_ROWS 3  // consumer warpgroups: output rows a step (R)
#endif
#ifndef VR_K5_SW
#define VR_K5_SW 54  // output columns of a stripe (conv 5's needed pixels of 64)
#endif
#ifndef VR_K5_WSLOTS
#define VR_K5_WSLOTS 3  // weight slots of 18,432 bytes
#endif
#ifndef VR_K5_EARLY_X
#define VR_K5_EARLY_X 1  // release a step's oldest x rows after conv 5's x part
#endif

namespace cg = cooperative_groups;

namespace {

using namespace wgmma_tile;
using bf16 = __nv_bfloat16;

constexpr int NF = 64, GC = 32;
constexpr int R = VR_K5_ROWS;
constexpr int WS = VR_K5_WSLOTS;
constexpr bool EARLY_X = VR_K5_EARLY_X != 0;
constexpr int SW = VR_K5_SW;           // output columns of a stripe
// pixels of an x ring row: the SW + 10 that conv 1 reads, whole atoms
constexpr int XP = (SW + 10 + 7) / 8 * 8;
constexpr int PIX = 64;                // bytes of a pixel in a 32-channel plane
constexpr int XPLANE = XP * PIX;
constexpr int XROW = 2 * XPLANE;       // x's two planes
constexpr int XPAD = 1024;             // after the x ring: 16 pixels of overrun
constexpr int DX = R + 6;              // x rows held
constexpr int SLOT = 18432;            // a weight stage
// the consumer warpgroups, then the producer warpgroup (one thread of it
// issues the copies): a whole warpgroup, so that it can hand its registers
// to the consumers (setmaxnreg), as in K1
constexpr int kThreads = R * 128 + 128;
constexpr int PRODUCER_REGS = 56;
// what the consumers may take: the SM's registers less the producer's, in
// steps of 8, at most 248
constexpr int CONSUMER_REGS_ = (65536 - 128 * PRODUCER_REGS) / (R * 128) / 8 * 8;
constexpr int CONSUMER_REGS = CONSUMER_REGS_ > 248 ? 248 : CONSUMER_REGS_;
static_assert(R >= 1 && R <= 3, "one to three consumer warpgroups");
static_assert(SW >= 8 && SW <= 56, "conv 1's 64 pixels cover the stripe and its halo of 8");

// rows of c_k's ring (k = 1..4): conv 5 reads c_k from base_k - (6 - k)
__host__ __device__ constexpr int dc(int k) { return R + 6 - k; }
// pixels of a c_k ring row: the SW + 10 - 2k columns a needed output reads
// (of the 64 conv k computes)
__host__ __device__ constexpr int cp(int k) { return SW + 10 - 2 * k; }
// c_k's ring from the c region: the sum over j < k of dc(j) cp(j) pixels,
// in closed form (no call). The rings lie end to end, then the x ring, then
// XPAD: a read past a row's last pixel (for outputs no needed pixel reads)
// lands in the next row, ring or the pad.
__host__ __device__ constexpr int c_off(int k) {
  return ((R + 6) * (SW + 10) * (k - 1) - (2 * (R + 6) + SW + 10) * (k - 1) * k / 2 +
          (k - 1) * k * (2 * k - 1) / 3) * PIX;
}
constexpr int C_OFF = WS * SLOT;
constexpr int X_OFF = (C_OFF + c_off(5) + 1023) / 1024 * 1024;
constexpr int BAR_OFF = X_OFF + DX * XROW + XPAD;
constexpr int NBARS = 2 * DX + 2 * WS;
constexpr int BIAS_OFF = BAR_OFF + NBARS * 8;
constexpr int BIAS = 4 * GC + NF;  // one RDB's biases, conv 1 .. 5
constexpr int SMEM = 1024 + BIAS_OFF + 3 * BIAS * 2;
static_assert(SMEM <= 232448, "one block an SM");
static_assert(SLOT % 1024 == 0 && C_OFF % 1024 == 0 && XROW % 512 == 0, "alignment");
constexpr int PLAN_LEN = 33;

// weight stages of conv k; conv k's first step (the first whose rows a
// needed output reads)
__host__ __device__ constexpr int n_stages(int k) { return k < 5 ? k + 1 : 12; }
__host__ __device__ constexpr int first_step(int k) { return (2 * k - 2) / R; }
// steps of a segment of L rows: conv 5's rows reach its last
__host__ __device__ constexpr int n_steps(int L) { return (L + 7) / R + 1; }

struct __align__(64) K5Params {
  CUtensorMap tm_a[3];   // the activations the passes read: x, y, scratch
  CUtensorMap tm_w[15];  // conv k of RDB r: 5 r + k - 1
  const bf16* b[15];
  const bf16* x;   // (B, H, W, 64): the RRDB residual
  const bf16* x0;  // RDB: optional
  bf16* y;
  bf16* scratch;
  long long rows;  // B * stripes * H: the rows the blocks share
  int H, W, S, passes;
};

// One segment: image n, the stripe at column X, output rows [y0, y1).
struct Seg {
  int n, X, y0, y1;
};

__device__ __forceinline__ bool seg_at(const K5Params& p, long long r, long long r1,
                                       Seg& s) {
  if (r >= r1) return false;
  const long long idx = r / p.H;
  s.y0 = (int)(r - idx * p.H);
  const long long len = r1 - r < (long long)(p.H - s.y0) ? r1 - r : (long long)(p.H - s.y0);
  s.y1 = s.y0 + (int)len;
  s.n = (int)(idx / p.S);
  s.X = (int)(idx - (long long)s.n * p.S) * SW;
  return true;
}

// Where conv k's weight stage i starts in its input channels.
__device__ __forceinline__ int stage_cin(int k, int i) { return k < 5 ? 32 * i : 16 * i; }

__device__ __forceinline__ uint32_t swz64(uint32_t a) { return a ^ ((a >> 3) & 0x30); }

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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(R * 128) : "memory");
}

// The shared-memory map: weight slots, c rings, x ring, the rings' full and
// empty barriers, the biases. The x and weight rings are FIFOs: item c sits
// in slot c % depth, and its barriers' phase is (c / depth) & 1.
struct Smem {
  uint32_t w, x, c, xfull, xempty, wfull, wempty, bias;
};

__device__ __forceinline__ Smem smem_map(uint32_t base) {
  Smem m;
  m.w = base;
  m.x = base + X_OFF;
  m.c = base + C_OFF;
  m.xfull = base + BAR_OFF;
  m.xempty = m.xfull + 8 * DX;
  m.wfull = m.xempty + 8 * DX;
  m.wempty = m.wfull + 8 * WS;
  m.bias = base + BIAS_OFF;
  return m;
}

// ---- producer: one thread --------------------------------------------------------

struct Producer {
  const K5Params& p;
  Smem m;
  uint32_t xn = 0, wn = 0;  // x rows and weight stages issued

  __device__ Producer(const K5Params& p_, Smem m_) : p(p_), m(m_) {}

  __device__ __forceinline__ void x_rows(const CUtensorMap* map, const Seg& s, int row0,
                                         int count) {
    for (int i = 0; i < count; ++i, ++xn) {
      const uint32_t slot = xn % DX;
      mbar_wait(m.xempty + 8 * slot, ((xn / DX) & 1) ^ 1);
      const uint32_t full = m.xfull + 8 * slot, dst = m.x + slot * XROW;
#ifdef VR_PROBE_NO_LOADS  // tools/probe_k5k3.py: the rows arrive empty
      mbar_arrive(full);
#else
      mbar_expect_tx(full, XROW);
      tma_load_4d(dst, map, full, 0, s.X - 5, row0 + i, s.n);
      tma_load_4d(dst + XPLANE, map, full, 32, s.X - 5, row0 + i, s.n);
#endif
    }
  }

  __device__ __forceinline__ void w_stage(const CUtensorMap* map, int cin0) {
    const uint32_t slot = wn % WS;
    mbar_wait(m.wempty + 8 * slot, ((wn / WS) & 1) ^ 1);
    const uint32_t full = m.wfull + 8 * slot;
#ifdef VR_PROBE_NO_LOADS
    mbar_arrive(full);
#else
    mbar_expect_tx(full, SLOT);
    tma_load_3d(m.w + slot * SLOT, map, full, 0, cin0, 0);
#endif
    ++wn;
  }

  // Every copy of one pass over the block's rows [r0, r1), in the order the
  // consumers take them.
  __device__ void pass(int pass_i, long long r0, long long r1) {
    const CUtensorMap* src = &p.tm_a[p.passes == 1 ? 0 : pass_i];
    const CUtensorMap* wm = &p.tm_w[5 * pass_i];
    Seg s;
    long long r = r0;
    bool have = seg_at(p, r, r1, s);
    if (have) x_rows(src, s, s.y0 - 5, R + 2);
    while (have) {
      const int L = s.y1 - s.y0, T = n_steps(L);
      Seg nxt;
      const bool more = seg_at(p, r + L, r1, nxt);
      for (int t = 0; t < T; ++t) {
        // the next step's x rows go once this step's release is near: in
        // conv 5, as its slot for the stage after the x part is refilled
        bool x_done = t + 1 >= T;
        for (int k = 1; k <= 5; ++k) {
          if (t < first_step(k)) continue;
          for (int i = 0; i < n_stages(k); ++i) {
            if (EARLY_X && k == 5 && i == 3 + WS && !x_done) {
              x_rows(src, s, s.y0 - 3 + R * (t + 1), R);
              x_done = true;
            }
            w_stage(wm + k - 1, stage_cin(k, i));
          }
        }
        if (!x_done) x_rows(src, s, s.y0 - 3 + R * (t + 1), R);
      }
      if (more) x_rows(src, nxt, nxt.y0 - 5, R + 2);
      r += L;
      s = nxt;
      have = more;
    }
  }
};

// ---- consumers -------------------------------------------------------------------

struct Consumer {
  const K5Params& p;
  Smem m;
  int wg, wl, g, q, lane;
  uint32_t xw = 0, xr = 0, wn = 0;  // x rows waited for and released; stages taken
  uint32_t xbase = 0;               // the FIFO index of the segment's row y0 - 5
  Seg s;

  __device__ Consumer(const K5Params& p_, Smem m_) : p(p_), m(m_) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wg = warp >> 2;
    wl = warp & 3;
    g = lane >> 2;
    q = lane & 3;
  }

  // the shared address of x's row `row` (plane 0), of c_k's row `row`
  __device__ __forceinline__ uint32_t x_row(int row) const {
    return m.x + ((xbase + (uint32_t)(row - (s.y0 - 5))) % DX) * XROW;
  }
  __device__ __forceinline__ uint32_t c_row(int k, int row) const {
    const int d = dc(k);
    return m.c + c_off(k) + (uint32_t)(((row % d) + d) % d) * (cp(k) * PIX);
  }

  // release x's rows up to FIFO index `upto` (one arrive a warp)
  __device__ __forceinline__ void release_x(uint32_t upto) {
    __syncwarp();
    for (; xr < upto; ++xr)
      if (lane == 0) mbar_arrive(m.xempty + 8 * (xr % DX));
  }

  // The MMAs of conv K at output row `row` into acc, over all its weight
  // stages: each waits for its weights, issues its wgmmas and commits them;
  // the stage before it is then waited for and its slot released, so one
  // group stays in flight; the last is drained. Conv 5 releases the step's
  // oldest x rows up to FIFO index `rel` once its x part (stages 0-3) is
  // read.
  template <int K, int ACC>
  __device__ __forceinline__ void mma(float (&acc)[ACC], int row, uint32_t rel) {
    constexpr int N = K < 5 ? GC : NF;
    static_assert(ACC == N / 2, "one m64 x N fp32 accumulator");
    // the three source rows of each tap row: x's (plane 0) and c_s's
    uint32_t xa[3], ca[4][3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      xa[ky] = x_row(row - 1 + ky);
#pragma unroll
      for (int s_ = 1; s_ < K; ++s_) ca[s_ - 1][ky] = c_row(s_, row - 1 + ky);
    }
    // descriptors: the start address (16-byte units) in the low 14 bits of
    // each; A K-major in the 64-byte swizzle, B N-major in the 64-byte (n32)
    // or 128-byte (n64) swizzle
    const uint64_t da0 = make_desc(0, 16, 8 * PIX, 2);
    const uint64_t db0 = make_desc(0, 16, 8 * N * 2, K < 5 ? 2 : 1);
    // every stage unrolled, so that its source, plane and k16 steps are
    // constants and the wgmmas run straight through
    uint32_t prev = 0;  // the slot of the stage committed before
#pragma unroll
    for (int i = 0; i < n_stages(K); ++i) {
      // this stage's source (0: x), plane and k16 steps [j0, j1)
      const int src = K < 5 ? (i < 2 ? 0 : i - 1) : (i < 4 ? 0 : (i - 4) / 2 + 1);
      const int plane = K < 5 ? (i < 2 ? i : 0) : (i < 4 ? i >> 1 : 0);
      const int j0 = K < 5 ? 0 : (i & 1), j1 = K < 5 ? 2 : j0 + 1;
      const int shift = K - 1 - src;  // the source's column offset
      uint32_t a_row[3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        a_row[ky] = (src == 0 ? xa[ky] + plane * XPLANE : ca[src > 0 ? src - 1 : 0][ky]) +
                    shift * PIX;
      const uint32_t slot = wn % WS;
      mbar_wait(m.wfull + 8 * slot, (wn / WS) & 1);
      fence_acc(acc);
      wg_fence();
      const uint32_t wb = m.w + slot * SLOT;
#ifndef VR_PROBE_NO_MMA  // tools/probe_k5k3.py: the rings alone
#pragma unroll
      for (int j = j0; j < j1; ++j)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap - ky * 3;
          const uint64_t da = da0 + (uint64_t)((a_row[ky] + kx * PIX + j * 32) >> 4);
          const uint64_t db =
              db0 + (uint64_t)((wb + (K < 5 ? tap * 2048 + j * 1024 : tap * 2048)) >> 4);
          Wgmma<N>::run(acc, da, db, (i | j | tap) != 0);
        }
#endif
      wg_commit();
      if (i > 0) {
        wg_wait<1>();  // the stage before is done: release its slot
        if (lane == 0) mbar_arrive(m.wempty + 8 * prev);
      }
      prev = slot;
      ++wn;
      // conv 5's x part (stages 0-3) is read: the oldest x rows may go
      if (K == 5 && EARLY_X && i == 4) release_x(rel);
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(m.wempty + 8 * prev);
  }

  // Conv K's epilogue at output row `row`, its MMAs done: bias, lrelu,
  // frame mask, rounding into c_K's ring (K < 5), or bias, residual (xres,
  // read from the x ring before the rows could go), x0 and the store of the
  // segment's rows (K == 5); then the consumers' barrier.
  template <int K, int ACC>
  __device__ __forceinline__ void epi(float (&acc)[ACC], int row, uint32_t bias,
                                      const uint32_t (&xres)[2][8], bf16* dst, const bf16* x0) {
    fence_acc(acc);
#ifdef VR_PROBE_NO_MMA
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
#endif
    // this thread's pixels 16 wl + g + 8 h, channels 8 i + 2 q, + 1
    if constexpr (K < 5) {
      const bool row_in = row >= 0 && row < p.H;
      const uint32_t ca = c_row(K, row);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = 16 * wl + g + 8 * h;
        const int fx = s.X - 5 + K + px;
        const bool in = row_in && fx >= 0 && fx < p.W;
        if (px >= cp(K)) continue;  // a column no needed output reads
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = 8 * i + 2 * q;
          const float2 bb = unpack(ld_shared(bias + co * 2));
          float v0 = __fadd_rn(acc[4 * i + 2 * h], bb.x);
          float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], bb.y);
          v0 = v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0);
          v1 = v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1);
          st_shared(swz64(ca + px * PIX + co * 2), pack(in ? v0 : 0.f, in ? v1 : 0.f));
        }
      }
      // the generic-proxy writes before the async proxy's reads of the next conv
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else {
#ifndef VR_PROBE_NO_STORE
      const bool row_ok = row >= s.y0 && row < s.y1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = 16 * wl + g + 8 * h;
        const int fx = s.X + px;
        if (!row_ok || px >= SW || fx >= p.W) continue;
        const long long o = (((long long)s.n * p.H + row) * p.W + fx) * NF;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int co = 8 * i + 2 * q;
          const float2 bb = unpack(ld_shared(bias + co * 2));
          const float2 xv = unpack(xres[h][i]);
          float v0 = __fadd_rn(acc[4 * i + 2 * h], bb.x);
          float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], bb.y);
          v0 = __fadd_rn(xv.x, __fmul_rn(0.2f, v0));
          v1 = __fadd_rn(xv.y, __fmul_rn(0.2f, v1));
          if (x0) {
            const float2 r = unpack(*reinterpret_cast<const uint32_t*>(x0 + o + co));
            const float2 t = unpack(pack(v0, v1));
            v0 = __fadd_rn(r.x, __fmul_rn(0.2f, t.x));
            v1 = __fadd_rn(r.y, __fmul_rn(0.2f, t.y));
          }
          *reinterpret_cast<uint32_t*>(dst + o + co) = pack(v0, v1);
        }
      }
#endif
    }
    consumers_sync();
  }

  // conv 5's residual at this thread's pixels of row `row`, read before
  // conv 5's x part lets the rows go
  __device__ __forceinline__ void residual(int row, uint32_t (&xres)[2][8]) const {
    const uint32_t xa = x_row(row);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xres[h][i] = ld_shared(swz64(xa + (i >> 2) * XPLANE + (16 * wl + g + 8 * h + 5) * PIX +
                                     (8 * (i & 3) + 2 * q) * 2));
  }

  // One step: conv k at rows base - (k - 1) for the convs active at step t
  // (a segment's first steps run fewer), each conv's MMAs drained before
  // its epilogue.
  __device__ __forceinline__ void step(int t, int base, uint32_t b, uint32_t rel, bf16* dst,
                                       const bf16* x0) {
    float a1[GC / 2], a2[GC / 2], a3[GC / 2], a4[GC / 2], a5[NF / 2];
    uint32_t xres[2][8];
    mma<1>(a1, base, 0);
    epi<1>(a1, base, b, xres, nullptr, nullptr);
    if (t < first_step(2)) return;
    mma<2>(a2, base - 1, 0);
    epi<2>(a2, base - 1, b + GC * 2, xres, nullptr, nullptr);
    if (t < first_step(3)) return;
    mma<3>(a3, base - 2, 0);
    epi<3>(a3, base - 2, b + 2 * GC * 2, xres, nullptr, nullptr);
    if (t < first_step(4)) return;
    mma<4>(a4, base - 3, 0);
    epi<4>(a4, base - 3, b + 3 * GC * 2, xres, nullptr, nullptr);
    if (t < first_step(5)) return;
    residual(base - 4, xres);
    mma<5>(a5, base - 4, rel);
    if (!EARLY_X) release_x(rel);
    epi<5>(a5, base - 4, b + 4 * GC * 2, xres, dst, x0);
  }

  __device__ void pass(int pass_i, long long r0, long long r1) {
    bf16* dst = p.passes == 3 && pass_i == 1 ? p.scratch : p.y;
    const bf16* x0 = p.passes == 3 ? (pass_i == 2 ? p.x : nullptr) : p.x0;
    const uint32_t b = m.bias + pass_i * BIAS * 2;  // conv k's at (k - 1) GC
    long long r = r0;
    bool have = seg_at(p, r, r1, s);
    while (have) {
      const int L = s.y1 - s.y0, T = n_steps(L);
      xbase = xr;
      for (int t = 0; t < T; ++t) {
        // this step's new x rows (all R + 2 of the first)
        const uint32_t loaded = xbase + R + 2 + R * t;
        for (; xw < loaded; ++xw) mbar_wait(m.xfull + 8 * (xw % DX), (xw / DX) & 1);
        // after this step, conv 5 of the next reads from row index R (t + 1) - 4
        const int keep = R * (t + 1) - 4;
        const uint32_t rel = t + 1 == T ? loaded : xbase + (keep > 0 ? keep : 0);
        // the last step lets every row go after conv 5, the others the
        // oldest once conv 5's x part is read
        const int base = s.y0 - 4 + R * t + wg;  // conv 1's row
        step(t, base, b, t + 1 == T ? xr : rel, dst, x0);
        release_x(rel);
      }
      r += L;
      have = seg_at(p, r, r1, s);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    rdb_wgmma_kernel(const __grid_constant__ K5Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const Smem m = smem_map(base);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the rings and the atom after them are zero before anything reads them
  for (int o = tid * 16; o < BAR_OFF - C_OFF; o += kThreads * 16)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(m.c + o), "r"(0)
                 : "memory");
  // the biases of every pass, conv 1 .. 5 in a row
  for (int i = tid; i < p.passes * BIAS; i += kThreads) {
    const int r = i / BIAS, c = i - r * BIAS;
    const int k = c < 4 * GC ? c / GC : 4, ch = c - k * GC;
    const __nv_bfloat16 v = p.b[5 * r + k][ch];
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(m.bias + 2 * i),
                 "h"(*reinterpret_cast<const unsigned short*>(&v))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < DX; ++i) {
      mbar_init(m.xfull + 8 * i, 1);       // the producer's expect_tx
      mbar_init(m.xempty + 8 * i, R * 4);  // one arrive a consumer warp
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(m.wfull + 8 * i, 1);
      mbar_init(m.wempty + 8 * i, R * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r0 = p.rows * blockIdx.x / gridDim.x;
  const long long r1 = p.rows * (blockIdx.x + 1) / gridDim.x;
  if (warp >= R * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    Producer pr(p, m);
    for (int i = 0; i < p.passes; ++i) {
      if (warp == R * 4 && lane == 0) {
        if (i > 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
        pr.pass(i, r0, r1);
      }
      __syncwarp();
      if (i + 1 < p.passes) cg::this_grid().sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    Consumer co(p, m);
    for (int i = 0; i < p.passes; ++i) {
      co.pass(i, r0, r1);
      if (i + 1 < p.passes) {
        // this pass's stores before the next pass's TMA reads, in any block
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        cg::this_grid().sync();
      }
    }
  }
}

}  // namespace

extern "C" {

// The build's geometry (what ops/rdb.py::rdb_wgmma_plan needs): out[0] R,
// out[1] stripe columns, out[2] x ring pixels, out[3] x rows held, out[4..7]
// c_1 .. c_4 rows held, out[8] weight slots, out[9] dynamic shared memory a
// block, out[10] early x release, out[11] threads a block.
int vr_rdb_fused_wgmma_config(int* out) {
  out[0] = R;
  out[1] = SW;
  out[2] = XP;
  out[3] = DX;
  for (int k = 1; k <= 4; ++k) out[3 + k] = dc(k);
  out[8] = WS;
  out[9] = SMEM;
  out[10] = EARLY_X ? 1 : 0;
  out[11] = kThreads;
  return 0;
}

namespace {

// Fill the kernel's parameters from the plan (PLAN_LEN int64 values of
// ops/rdb.py::rdb_wgmma_plan: the build's geometry as the plan assumed it,
// the grid, the stripes and rows, x's 4-D map (dims, byte strides, box,
// swizzle bytes) and the weight boxes and swizzles of conv 1-4 and conv 5);
// cudaErrorInvalidValue for a call or plan this build does not take,
// cudaErrorNotSupported when a tensor map cannot be encoded.
cudaError_t fill(K5Params& k, int& grid, int dtype, int nf, int gc, int rdbs,
                 const void* x, const void* x0, void* y, void* scratch,
                 const void* const* ws, const void* const* bs, int B, int H, int W,
                 const long long* plan, int plan_len) {
  if (dtype != 1 || nf != NF || gc != GC || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(x0) || !aligned16(y) || !aligned16(scratch))
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long S = (W + SW - 1) / SW;
  if (plan[0] != R || plan[1] != SW || plan[2] != XP || plan[3] != DX || plan[4] != dc(1) ||
      plan[5] != dc(2) || plan[6] != dc(3) || plan[7] != dc(4) || plan[8] != WS ||
      plan[9] != SMEM)
    return cudaErrorInvalidValue;
  const long long *a_dims = plan + 13, *a_strides = plan + 17, *a_box = plan + 20;
  const long long *w_box = plan + 25, *w5_box = plan + 29;
  grid = (int)plan[10];
  if (plan[10] <= 0 || plan[10] > 65535 || plan[11] != S || plan[12] != (long long)B * S * H ||
      a_dims[0] != NF || a_dims[1] != W || a_dims[2] != H || a_dims[3] != B ||
      a_strides[0] != NF * 2 || a_strides[1] != (long long)W * NF * 2 ||
      a_strides[2] != (long long)H * W * NF * 2 || a_box[0] != 32 || a_box[1] != XP ||
      a_box[2] != 1 || a_box[3] != 1 || plan[24] != 64 || w_box[0] != GC || w_box[1] != 32 ||
      w_box[2] != 9 || plan[28] != 64 || w5_box[0] != NF || w5_box[1] != 16 ||
      w5_box[2] != 9 || plan[32] != 128)
    return cudaErrorInvalidValue;
  k = K5Params{};
  const void* acts[3] = {x, y, scratch};
  for (int i = 0; i < (rdbs == 3 ? 3 : 1); ++i)
    if (!encode(&k.tm_a[i], acts[i], 4, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorNotSupported;
  for (int r = 0; r < rdbs; ++r)
    for (int c = 0; c < 5; ++c) {
      const void* w = ws[5 * r + c];
      const void* b = bs[5 * r + c];
      if (!aligned16(w) || !w || !b || (reinterpret_cast<uintptr_t>(b) & 3))
        return cudaErrorInvalidValue;
      const long long cin = NF + c * GC, cout = c < 4 ? GC : NF;
      const long long dims[3] = {cout, cin, 9}, strides[2] = {cout * 2, cin * cout * 2};
      if (!encode(&k.tm_w[5 * r + c], w, 3, dims, strides, c < 4 ? w_box : w5_box,
                  c < 4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorNotSupported;
      k.b[5 * r + c] = static_cast<const bf16*>(b);
    }
  k.x = static_cast<const bf16*>(x);
  k.x0 = static_cast<const bf16*>(x0);
  k.y = static_cast<bf16*>(y);
  k.scratch = static_cast<bf16*>(scratch);
  k.rows = (long long)B * S * H;
  k.H = H;
  k.W = W;
  k.S = (int)S;
  k.passes = rdbs;
  return cudaSuccess;
}

cudaError_t launch(const K5Params& k, int grid, bool whole, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(rdb_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(rdb_wgmma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (!whole) {
    rdb_wgmma_kernel<<<grid, kThreads, SMEM, stream>>>(k);
    return cudaGetLastError();
  }
  // the grid-wide barrier needs every block resident
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rdb_wgmma_kernel, kThreads, SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  K5Params arg = k;
  void* params[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rdb_wgmma_kernel), dim3(grid),
                                  dim3(kThreads), params, SMEM, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The arguments of vr_rdb_fused_mma, then the plan. bf16 at (nf, gc) = (64,
// 32) only. Returns the cudaError_t of the launch (see fill).
int vr_rdb_fused_wgmma(int dtype, int nf, int gc, const void* x, const void* x0, void* y,
                       const void* const* ws, const void* const* bs, int B, int H, int W,
                       void* stream, const long long* plan, int plan_len) {
  K5Params k;
  int grid = 0;
  const cudaError_t e = fill(k, grid, dtype, nf, gc, 1, x, x0, y, nullptr, ws, bs, B, H, W,
                             plan, plan_len);
  if (e != cudaSuccess) return e;
  return launch(k, grid, false, static_cast<cudaStream_t>(stream));
}

// The arguments of vr_rrdb_fused_mma, then the plan: a whole RRDB in one
// cooperative launch.
int vr_rrdb_fused_wgmma(int dtype, int nf, int gc, const void* x, void* y, void* scratch,
                        const void* const* ws, const void* const* bs, int B, int H, int W,
                        void* stream, const long long* plan, int plan_len) {
  K5Params k;
  int grid = 0;
  const cudaError_t e = fill(k, grid, dtype, nf, gc, 3, x, nullptr, y, scratch, ws, bs, B, H,
                             W, plan, plan_len);
  if (e != cudaSuccess) return e;
  return launch(k, grid, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
