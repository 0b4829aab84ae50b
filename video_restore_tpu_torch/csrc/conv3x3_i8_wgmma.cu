// K4, Hopper route: the W8A8 int8 direct SAME 3x3 convolution of
// conv3x3_i8.cu on int8 `wgmma` (m64nNk32, s32 accumulators) fed by TMA,
// with a producer warpgroup that quantises the activations on load.
//
// It computes exactly the function of `vr_conv3x3_i8` (see the note at the
// top of conv3x3_i8.cu: per-segment A8 quantised on load, exact int32 dot
// per segment, the fp32 fold in segment order, K1's epilogue, the optional
// per-image output amax), dynamic A8 (scales from the device amax array) and
// static A8 (fixed scales from the host), for the calls conv3x3_i8_mma.cu
// takes: bf16, every segment width a multiple of 32, cin <= 192, cout 32 or
// 64, 16-byte-aligned operands with pixel strides that are multiples of 8
// (ops/quant.py::conv3x3_i8_route). x may also carry a tail, as K1's
// `wgmma` route does: 32-channel blocks of a contiguous (blocks, B, H, W, 32)
// tensor whose channels follow x's (the RDB's c1 .. c4, ops/stripe.py). It
// replaces the same Pallas code as conv3x3_i8.cu: the int8 branch of
// `_conv_prefix` (video_restore_tpu/ops/pallas_stripe.py:358) in the RDB and
// SRVGG body kernels. The integer sums are exact in any order, the quantiser
// is conv3x3_i8_mma.cu's (i8_quant.cuh) and every fp32 step repeats
// conv3x3_i8.cu's, so the three kernels agree bit for bit.
//
// The GEMM is K1's (conv3x3_wgmma.cu): M = output pixels (an m64 tile = 64
// neighbouring pixels of one output row), N = cout, K = 9 taps x cin, one
// stage = KC = 32 input channels = one k32 step, each stage inside one
// segment. What bounds it on the H100: device memory (each conv reads its
// bf16 input and writes its bf16 output; an RDB at 1080p moves 3.7 GB, 1.11
// ms at 3.35 TB/s, against 0.50 ms of int8 operations at 1979 TOPS). What
// held conv3x3_i8_mma.cu at a third of that (tools/probe_k4.py): the same
// warps quantised, fed the MMAs and ran the epilogue in turn. The design:
//
//  - TMA brings each stage's bf16 window ((TH + 2) x (TW + 2) pixels of 32
//    channels, 64-byte rows, no swizzle) into a ring of `dr` raw slots (as
//    many as fit beside the weights: ops/quant.py::i8_wgmma_plan): x through
//    a 4-D map over (channels, W, H, B) whose W stride is the view's pixel
//    stride, a tail block through a 5-D map; out-of-frame reads are zero
//    filled, and q(0) = 0, so SAME padding costs nothing.
//  - TMA cannot quantise: a producer warpgroup (registers handed to the
//    consumers with setmaxnreg) turns each raw window into the int8 A
//    operand, K-major, one pixel a 32-byte row in the 32-byte swizzle
//    `wgmma` reads, applying that (image, segment)'s T(1 / sa); each thread
//    fences its stores to the async proxy and each warp arrives on the int8
//    slot's full barrier. Its thread 0 issues every TMA copy, `dr` steps
//    ahead, once the warpgroup's named barrier says a raw slot has been
//    read. So the quantiser runs beside the tensor cores, on warps of its
//    own. Its chunks carry no per-chunk branch and plain shared loads and
//    stores, so that the compiler interleaves their chains (branches around
//    each chunk cost a third of the RDB's time).
//  - B (the weights, packed (9, cout, cin) by ops/quant.py::pack_i8_weights:
//    K-major, as int8 `wgmma` requires) is loaded once per block by a 3-D
//    map over (cin, cout, 9) in the 32-byte swizzle and stays resident (108
//    KB for RDB conv5, cin 192).
//  - Two consumer warpgroups share each tile: 4 m64 rows each at cout 32
//    (an 8 x 64 tile: the window's halo a smaller share of the quantiser's
//    work), 2 at cout 64 (4 x 64: its s32 and fp32 sums take twice the
//    registers); per stage 9 taps x the rows of `wgmma` m64nNk32; a tap's
//    (dy, dx) shift moves only the A descriptor's start address. The first
//    MMA of a segment overwrites the s32 sums (scale-d 0).
//  - The fold at a segment's end: the segment's s32 sums must be complete,
//    so the consumer waits for its MMAs (wait_group 0), converts them and
//    adds float(acc) * (sa * sw) into the fp32 sums in segment order
//    (segment 0 as acc * sc, then fma(acc, sc, sum); a single segment
//    folds in the epilogue with the bias as addend). Chosen: one s32 set;
//    the other warpgroup's MMAs and the producer's next stage run while one
//    folds. A second set, issued into while the first is folded, would take
//    32 more registers a row at cout 64, where the consumers already spill
//    (tools/probe_k4.py --route wgmma's clocks build: the folds are 2-3% of
//    a tile's cycles).
//  - A persistent grid (one block an SM) walks the tiles, row-major within
//    an image; the producer runs ahead across tiles.
//  - The epilogue: K1 `wgmma`'s accumulator layout and store path (bf16
//    pairs from registers, a pixel's residuals loaded before its first
//    store), conv3x3_i8.cu's rounding points, with the call's act, r1 and r2
//    applied without branches (each channel's bias and act slope in shared
//    memory: lrelu 0.2, PReLU alpha, none 1, which leaves u as it is);
//    branches around each value cost the SRVGG conv a third of its time.
//    The |max| of the stored values: |bf16(v)| = bf16(|v|) and rounding
//    keeps order, so each thread keeps max |v| while the block stays in one
//    image, then the warp's is rounded to bf16 and added by atomicMax on its
//    float bits (the values are >= 0, so the bits order as integers; the
//    wrapper zeroes out_amax).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/probe_k4.py --route wgmma,
// each build timed in order and back, without the amax pass): the 1080p
// RDB's five convs 0.21-0.23, 0.31, 0.41, 0.49, 1.07-1.09 ms against
// conv3x3_i8_mma.cu's 0.32-0.33, 0.44, 0.55, 0.65, 1.33-1.38; the RDB
// 2.46-2.51 (45% of its 1.109 ms byte bound) against 3.52-3.62, static A8
// 2.43-2.46 against 3.33-3.36; one SRVGG conv 0.38 against 0.57. The same
// bits as mma, dp4a and plain (chip_smoke.py [k4]). What each step took off
// the RDB (ms, in the probe's terms of the time): the `wgmma`s serialised
// by the compiler until an explicit wait before the epilogue (4.58 ->
// 3.90, the probe's amax pass included until the next step); 8-row tiles
// at cout 32 (3.79 -> 3.14); no branches in the epilogue and spent sums zeroed
// (3.20); no per-chunk branches in the quantiser (2.92); an epilogue
// without residuals for the convs that have none (2.83); the quantiser's
// loads batched ahead of its math (2.50). Measured and not kept: 16-byte
// stores after quad transposes, per-warp release of the raw slots, a
// second quantiser warpgroup, more producer registers, truncation by
// float magic in place of F2I, 4 int8 slots, one m64 row a consumer at
// cout 64, an epilogue per residual count, an L2 prefetch of the
// residuals, partly unrolled taps. What holds it now (the probe's clocks
// build, cycles a 1080p tile): conv 5's epilogue with its residual, 12.6k
// of 31k (its sums spill around it), and at cout 32 the quantiser, 3.2-3.6k
// cycles a stage against the consumers' 2.5-3.0k.
//
// The tensor maps are encoded on the host per call from the dims, byte
// strides and boxes that ops/quant.py::i8_wgmma_plan computes, with the
// stage schedule (each stage's segment, the segments' first and last
// stages), the raw ring's depth and the shared-memory bytes; the launcher
// checks the plan against this build (vr_conv3x3_i8_wgmma_config) and the
// call, and refuses a plan that does not match.

#include <stdint.h>

#include <type_traits>

#include "i8_quant.cuh"
#include "wgmma_tile.cuh"

#ifndef VR_I8_ROWS32
#define VR_I8_ROWS32 4  // output rows (m64 tiles) a consumer warpgroup, cout 32
#endif
#ifndef VR_I8_ROWS64
#define VR_I8_ROWS64 2  // the same at cout 64 (s32 and fp32 sums: 64 registers a row)
#endif
#ifndef VR_I8_QSTAGES
#define VR_I8_QSTAGES 3  // depth of the ring of quantised windows
#endif
#ifndef VR_I8_RAW_MAX
#define VR_I8_RAW_MAX 6  // most raw windows in flight (the plan takes what fits)
#endif
#ifndef VR_I8_PRODUCER_REGS
#define VR_I8_PRODUCER_REGS 56  // the quantiser's registers a thread
#endif

namespace {

using namespace wgmma_tile;
using namespace i8_quant;

constexpr int NC = 2;  // consumer warpgroups a block, sharing each tile
constexpr int TW = 64;  // output pixels of a tile row: one m64
constexpr int PW = TW + 2;
constexpr int KC = 32;         // input channels a stage: one k32 step, 32-byte rows
constexpr int kMaxSeg = 5;
constexpr int kMaxStages = 6;  // cin <= 192
constexpr int QS = VR_I8_QSTAGES, RAW_MAX = VR_I8_RAW_MAX;
constexpr int PARAM_BYTES = 2048;  // sw (nseg x cout), bias, alpha as fp32
static_assert((kMaxSeg + 2) * 64 * 4 <= PARAM_BYTES, "parameters");

// The tile of NT = cout / 8: RPC output rows a consumer warpgroup, TH a tile,
// and the windows of a stage: (TH + 2) x (TW + 2) pixels of KC channels.
template <int NT>
struct Geo {
  static constexpr int RPC = NT == 4 ? VR_I8_ROWS32 : VR_I8_ROWS64;
  static constexpr int TH = NC * RPC;                    // output rows of a tile
  static constexpr int PH = TH + 2;
  static constexpr int RAW_BYTES = PH * PW * KC * 2;     // bf16 window, as TMA writes it
  static constexpr int Q_BYTES = PH * PW * KC;           // int8 window, swizzled
  static constexpr int Q_PAD = (Q_BYTES + 1023) / 1024 * 1024;
  static constexpr int CHUNKS = PH * PW * KC / 8;        // 16-byte bf16 chunks of a window
  static_assert(RAW_BYTES % 128 == 0, "TMA destinations on 128 bytes");
};
// the producer warpgroup's threads (its first issues the copies, all of them
// quantise), the block's threads, and the registers the consumers take from
// the producer (less 8 a thread: the pool cannot hand out its last ones)
constexpr int PT = 128;
constexpr int kThreads = NC * 128 + PT;
constexpr int PRODUCER_REGS = VR_I8_PRODUCER_REGS;
constexpr int CONSUMER_REGS_ = ((65536 - PT * PRODUCER_REGS) / (NC * 128)) / 8 * 8 - 8;
constexpr int CONSUMER_REGS = CONSUMER_REGS_ > 256 ? 256 : CONSUMER_REGS_;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can have
constexpr int PLAN_LEN = 40;

// Dynamic shared memory of a call: the 1024-byte alignment, the resident
// weights, the int8 ring, the raw ring, the parameters, the barriers (the
// int8 ring's full and empty, the raw ring's full, the weights').
template <int NT>
constexpr long long smem_bytes(int nk, int dr) {
  return 1024 + (long long)nk * 9 * NT * 8 * KC + QS * Geo<NT>::Q_PAD +
         (long long)dr * Geo<NT>::RAW_BYTES + PARAM_BYTES + (2 * QS + dr + 1) * 8;
}

struct I8Args {
  const float* amax;           // amax[n * as + s]: per-(image, segment) |max|
  const float* sw;             // (nseg, cout) weight scales
  const __nv_bfloat16* b;      // (cout,)
  const __nv_bfloat16* alpha;  // (cout,) for PReLU, else null
  const __nv_bfloat16* r1;     // (B, H, W, >=cout) pixel stride r1s, or null
  const __nv_bfloat16* r2;     // (B, H, W, >=cout) pixel stride r2s, or null
  __nv_bfloat16* y;            // (B, H, W, >=cout) pixel stride ys
  float* out_amax;             // out_amax[n * os], or null
  int H, W, cout, nk, head, nseg, dr;
  int tiles_x, tiles_y, tiles;
  long long ys, r1s, r2s, as, os;
  int seg_of;       // stage k's segment in bits 4k .. 4k + 3
  int first, last;  // bit k: stage k starts / ends its segment
  int act;          // 0 none, 1 lrelu(0.2), 2 prelu
  int stat;         // static A8: the segments' scales from sa / inv
  float s1, s2;
  float sa[kMaxSeg];   // static A8: the segments' fixed scales
  float inv[kMaxSeg];  // static A8: bf16(1 / sa), held as float
};

#ifdef VR_PROBE_CLOCKS
// tools/probe_k4.py: clock64 cycles summed over the blocks. Producer thread
// 0: [0] raw window waits, [1] int8 slot waits, [2] quantising, [3] the
// fence, arrivals, barrier and copies after it, [4] steps. Consumer thread
// 0: [5] int8 window waits, [6] issuing the `wgmma`s, [7] waits for them,
// [8] folds, [9] epilogues, [10] tiles, [11] the block's consumer cycles.
__device__ unsigned long long vr_i8_clocks[12];
#define VR_CLK(v) const long long v = clock64()
#define VR_ADD(i, d) clk[i] += (d)
#else
#define VR_CLK(v)
#define VR_ADD(i, d)
#endif

// The activation scale of segment s of image n.
__device__ __forceinline__ float seg_scale(const I8Args& a, int n, int s) {
  return a.stat ? a.sa[s] : act_scale(__ldg(a.amax + n * a.as + s));
}


// ---- the kernel -------------------------------------------------------------------

// NT: cout / 8. MULTI: more than one segment (fp32 sums beside the s32 ones,
// folded at each segment's end; a single segment folds in the epilogue).
template <int NT, bool MULTI>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_i8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_t,
                            const __grid_constant__ CUtensorMap tm_w, const I8Args a) {
  using G = Geo<NT>;
  constexpr int N = NT * 8, RPC = G::RPC, TH = G::TH;
  constexpr int RAW_BYTES = G::RAW_BYTES, Q_PAD = G::Q_PAD, CHUNKS = G::CHUNKS;
  constexpr int TAP_BYTES = N * KC;        // a tap's cout rows of 32 bytes
  constexpr int STAGE_W = 9 * TAP_BYTES;   // a stage's weights, every tap
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t wbase = (s0 + 1023u) & ~1023u;  // the resident weights
  const uint32_t qring = wbase + a.nk * STAGE_W;
  const uint32_t raw = qring + QS * Q_PAD;
  const uint32_t prm = raw + a.dr * RAW_BYTES;
  const uint32_t qfull0 = prm + PARAM_BYTES;
  const uint32_t qempty0 = qfull0 + QS * 8;
  const uint32_t rfull0 = qempty0 + QS * 8;
  const uint32_t wbar = rfull0 + a.dr * 8;
  float* s_sw = reinterpret_cast<float*>(smem + (prm - s0));  // (nseg, cout)
  float* s_cb = s_sw + kMaxSeg * 64;  // each channel's (bias, slope of its act)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < a.nseg * a.cout; i += kThreads) s_sw[i] = a.sw[i];
  for (int i = tid; i < a.cout; i += kThreads) {
    s_cb[2 * i] = __bfloat162float(a.b[i]);
    s_cb[2 * i + 1] = a.act == 1 ? 0.2f : a.act == 2 ? __bfloat162float(a.alpha[i]) : 1.f;
  }
  if (tid == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(qfull0 + 8 * s, PT / 32);  // every quantiser warp
      mbar_init(qempty0 + 8 * s, NC * 4);  // one arrive a consumer warp
    }
    for (int s = 0; s < a.dr; ++s) mbar_init(rfull0 + 8 * s, 1);  // the copy's expect_tx
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_image = a.tiles_x * a.tiles_y;

  if (warp >= NC * 4) {
    // ---- producer: TMA copies (thread 0) and the quantiser (all PT) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - NC * 128;
    const int my_tiles = (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
    const int steps = my_tiles * a.nk;
    // step i: stage i % nk of this block's tile i / nk, into raw slot i % dr
    auto issue = [&](int i) {
      const int j = i / a.nk, k = i - j * a.nk;
      const int t = blockIdx.x + j * gridDim.x;
      const int n = t / per_image, rem = t - n * per_image;
      const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
      const int slot = i % a.dr;
      const uint32_t bar = rfull0 + 8 * slot, dst = raw + slot * RAW_BYTES;
#ifdef VR_PROBE_NO_LOAD  // tools/probe_k4.py: the windows arrive as they are
      mbar_arrive(bar);
#else
      mbar_expect_tx(bar, RAW_BYTES);
      if (k < a.head)
        tma_load_4d(dst, &tm_x, bar, k * KC, tx * TW - 1, ty * TH - 1, n);
      else  // one 32-channel block of the tail
        tma_load_5d(dst, &tm_t, bar, 0, tx * TW - 1, ty * TH - 1, n, k - a.head);
#endif
    };
    if (pt == 0) {
      mbar_expect_tx(wbar, a.nk * STAGE_W);  // every weight, once
      for (int k = 0; k < a.nk; ++k) tma_load_3d(wbase + k * STAGE_W, &tm_w, wbar, k * KC, 0, 0);
      for (int i = 0; i < a.dr && i < steps; ++i) issue(i);
    }
    // step i's (image, segment): its amax is loaded a step ahead and its
    // multiplier worked out after the step before is quantised, so that
    // neither the load nor the division waits on the chain
    int k = 0, j = 0;
    auto amax_of_next = [&]() {
      const int n = (int)(blockIdx.x + j * gridDim.x) / per_image;
      const int s = (a.seg_of >> (4 * k)) & 15;
      if (++k == a.nk) {
        k = 0;
        ++j;
      }
      return make_int2(s, __float_as_int(a.stat ? 0.f : __ldg(a.amax + n * a.as + s)));
    };
    auto inverse = [&](int2 sm) {
      return inv_pair(a.stat ? a.inv[sm.x] : act_inverse(act_scale(__int_as_float(sm.y))));
    };
    uint32_t inv2 = inverse(amax_of_next());
    int rs = 0, qs = 0;
    uint32_t rph = 0, qph = 0;
#ifdef VR_PROBE_CLOCKS
    long long clk[5] = {0, 0, 0, 0, steps};
#endif
    for (int i = 0; i < steps; ++i) {
      const int2 next = i + 1 < steps ? amax_of_next() : make_int2(0, 0);
      VR_CLK(c0);
      mbar_wait(rfull0 + 8 * rs, rph);
      VR_CLK(c1);
      mbar_wait(qempty0 + 8 * qs, qph ^ 1);
      VR_CLK(c2);
      const uint32_t src = raw + rs * RAW_BYTES, dst = qring + qs * Q_PAD;
      // chunk c: 8 channels of window pixel c / 4, 16 bytes at c * 16 of the
      // raw window and 8 bytes at c * 8 of the int8 one (swizzled); a
      // thread's chunks are c = pt + PT u: FULL of them for every thread,
      // one more for the first TAIL threads, BATCH loads ahead of their
      // quantiser and stores, so that the chunks' chains interleave (the
      // two windows never overlap; the fence after them orders the stores
      // before the consumers' `wgmma`s)
      constexpr int FULL = CHUNKS / PT, TAIL = CHUNKS % PT, BATCH = 4;
      const uint4* __restrict__ rw = reinterpret_cast<const uint4*>(smem + (src - s0));
      unsigned char* __restrict__ qw = smem + (dst - s0);
      auto quantise = [&](int c, const uint4& v) {
#ifndef VR_PROBE_NO_QUANT
        const uint2 q = quant8(v.x, v.y, v.z, v.w, inv2);
#else  // tools/probe_k4.py: the same bytes moved, no quantiser
        const uint2 q =
            make_uint2(__byte_perm(v.x, v.y, 0x6420) ^ inv2, __byte_perm(v.z, v.w, 0x6420));
#endif
        *reinterpret_cast<uint2*>(qw + (swizzle<32>(dst + c * 8) - dst)) = q;
      };
#pragma unroll
      for (int u0 = 0; u0 < FULL; u0 += BATCH) {
        uint4 v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (u0 + u < FULL) v[u] = rw[pt + PT * (u0 + u)];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (u0 + u < FULL) quantise(pt + PT * (u0 + u), v[u]);
      }
      if (TAIL && pt < TAIL) quantise(pt + PT * FULL, rw[pt + PT * FULL]);
      VR_CLK(c3);
      fence_async_shared();  // this thread's stores, before `wgmma` reads them
      __syncwarp();
      if ((pt & 31) == 0) mbar_arrive(qfull0 + 8 * qs);  // this warp's share is stored
      if (i + 1 < steps) inv2 = inverse(next);
      asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");  // raw slot rs is read
      if (pt == 0 && i + a.dr < steps) issue(i + a.dr);
      VR_CLK(c4);
      VR_ADD(0, c1 - c0);
      VR_ADD(1, c2 - c1);
      VR_ADD(2, c3 - c2);
      VR_ADD(3, c4 - c3);
      if (++rs == a.dr) {
        rs = 0;
        rph ^= 1;
      }
      if (++qs == QS) {
        qs = 0;
        qph ^= 1;
      }
    }
#ifdef VR_PROBE_CLOCKS
    if (pt == 0)
      for (int i = 0; i < 5; ++i) atomicAdd(vr_i8_clocks + i, (unsigned long long)clk[i]);
#endif
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;  // this warpgroup's rows of a tile: wg * RPC ..
  const int wl = warp & 3, g = lane >> 2, q = lane & 3;

  // descriptors (K-major, 32-byte swizzle, 8-row groups 256 bytes apart) at
  // the int8 ring and at the resident weights; a stage, row, tap moves only
  // the start address (16-byte units)
  const uint64_t da0 = make_desc(qring, 16, 8 * KC, 3);
  const uint64_t db0 = make_desc(wbase, 16, 8 * KC, 3);
  mbar_wait(wbar, 0);

  int acc[RPC][NT * 4];
  float fsum[MULTI ? RPC : 1][MULTI ? NT * 4 : 1];
  float m = 0.f;  // |max| of the values stored (before rounding) of image mn
  int mn = -1;
  auto flush = [&]() {  // warp-uniform: the block's tile is the warp's
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    m = __bfloat162float(__float2bfloat16_rn(m));
    if (lane == 0 && m > 0.f)
      atomicMax(reinterpret_cast<int*>(a.out_amax + mn * a.os), __float_as_int(m));
  };
  int qs = 0;
  uint32_t qph = 0;
#ifdef VR_PROBE_CLOCKS
  long long clk[12] = {};
  VR_CLK(k0);
#endif
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int n = t / per_image, rem = t - n * per_image;
    const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
    const int oy0 = ty * TH, ox0 = tx * TW;
    int pend = -1;  // an int8 slot whose MMAs are in flight
    for (int k = 0; k < a.nk; ++k) {
      const bool first = (a.first >> k) & 1, last = (a.last >> k) & 1;
      VR_CLK(d0);
      mbar_wait(qfull0 + 8 * qs, qph);
      VR_CLK(d1);
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
      wg_fence();
      const uint32_t st = qs * Q_PAD;
      const uint64_t db = db0 + (uint64_t)((k * STAGE_W) >> 4);
#ifndef VR_PROBE_NO_MMA  // tools/probe_k4.py: the ring and the quantiser alone
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - ky * 3;
#pragma unroll
        for (int rr = 0; rr < RPC; ++rr)
          WgmmaS8<N>::run(acc[rr],
                          da0 + (uint64_t)((st + ((wg * RPC + rr + ky) * PW + kx) * KC) >> 4),
                          db + (uint64_t)((tap * TAP_BYTES) >> 4), !(first && tap == 0));
      }
#else
      if (first) {
#pragma unroll
        for (int rr = 0; rr < RPC; ++rr)
#pragma unroll
          for (int e = 0; e < NT * 4; ++e) acc[rr][e] = 0;
      }
#endif
      wg_commit();
      VR_CLK(d2);
      VR_ADD(5, d1 - d0);
      VR_ADD(6, d2 - d1);
      if (last) {
        // segment s's scale, read while its MMAs run
        const int s = (a.seg_of >> (4 * k)) & 15;
        const float sa = MULTI ? seg_scale(a, n, s) : 0.f;
        wg_wait<0>();  // the segment's sums are complete: release its slots
        if (lane == 0) {
          if (pend >= 0) mbar_arrive(qempty0 + 8 * pend);
          mbar_arrive(qempty0 + 8 * qs);
        }
        pend = -1;
#pragma unroll
        for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
        VR_CLK(d3);
        VR_ADD(7, d3 - d2);
        if constexpr (MULTI) {
          // segment s: float(acc) * (sa * sw) added after the earlier ones
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sc = __fmul_rn(sa, s_sw[s * a.cout + 8 * i + 2 * q + e]);
#pragma unroll
              for (int rr = 0; rr < RPC; ++rr)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int r = 4 * i + 2 * h + e;
                  const float v = __int2float_rn(acc[rr][r]);
                  fsum[rr][r] = s == 0 ? __fmul_rn(v, sc) : __fmaf_rn(v, sc, fsum[rr][r]);
                }
            }
        }
        VR_CLK(d4);
        VR_ADD(8, d4 - d3);
      } else {
        wg_wait<1>();  // the stage before is done: release it
        if (lane == 0 && pend >= 0) mbar_arrive(qempty0 + 8 * pend);
        pend = qs;
        VR_CLK(d3);
        VR_ADD(7, d3 - d2);
      }
      if (++qs == QS) {
        qs = 0;
        qph ^= 1;
      }
    }
    // nothing is in flight (the last stage ends a segment), but say so:
    // without it the compiler guards the epilogue's reads of the sums with
    // waits of its own, and then serialises every `wgmma`
    wg_wait<0>();
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
    // sums whose values are spent: zero (which the next tile's first `wgmma`
    // ignores: scale-d 0), so that nothing keeps them in registers through
    // the epilogue
    if constexpr (MULTI) {
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr)
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) acc[rr][e] = 0;
    }

    // epilogue: conv3x3_i8.cu's arithmetic, two neighbouring channels at a
    // time, stored from registers, a row's residuals all loaded first
    VR_CLK(e0);
    float sc1[NT][2];  // a single segment: sa * sw, the bias its addend
    if constexpr (!MULTI) {
      const float sa = seg_scale(a, n, 0);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc1[i][e] = __fmul_rn(sa, s_sw[8 * i + 2 * q + e]);
    }
    if (a.out_amax && n != mn) {
      if (mn >= 0) flush();
      m = 0.f;
      mn = n;
    }
    // the call's choices, uniform: read once a tile, applied without
    // branches; an epilogue with residuals and one without (the RDB's convs
    // 1-4 and the SRVGG body have none: no loads or their addresses; one
    // for each residual count spilled more and ran slower)
    const bool ge = a.act == 1;
    const float4* cb = reinterpret_cast<const float4*>(s_cb);
    auto epilogue = [&](auto residuals) {
      constexpr bool RES = decltype(residuals)::value;
      const bool has_r1 = RES && a.r1 != nullptr, has_r2 = RES && a.r2 != nullptr;
      const float s1 = a.s1, s2 = a.s2;
      __nv_bfloat16* const y = a.y;
      const long long ys = a.ys;
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr) {
        const int oy = oy0 + wg * RPC + rr;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = ox0 + wl * 16 + g + 8 * h;
          const long long p = ((long long)n * a.H + oy) * a.W + ox;
          bool ok = oy < a.H && ox < a.W;
#ifdef VR_PROBE_NO_STORE  // tools/probe_k4.py: no epilogue loads or stores
          ok = false;
#endif
          // this pixel's residuals, all loaded before its first store (read
          // only: r1 and r2 never alias y)
          uint32_t w1[NT], w2[NT];
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            const int co = 8 * i + 2 * q;
            w1[i] = w2[i] = 0u;
            if constexpr (RES) {
              if (ok && has_r1)
                w1[i] = __ldg(reinterpret_cast<const unsigned*>(a.r1 + p * a.r1s + co));
              if (ok && has_r2)
                w2[i] = __ldg(reinterpret_cast<const unsigned*>(a.r2 + p * a.r2s + co));
            }
          }
          __nv_bfloat16* const yp = y + p * ys;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            const int co = 8 * i + 2 * q;
            const float4 c = cb[co / 2];  // bias and slope of channels co, co + 1
            const float bias[2] = {c.x, c.z}, slope[2] = {c.y, c.w};
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 4 * i + 2 * h + e;
              const uint32_t sh = e ? 0 : 16;  // element e of a bf16 pair
              float u;
              if constexpr (MULTI)
                u = __fadd_rn(fsum[rr][r], bias[e]);
              else
                u = __fmaf_rn(__int2float_rn(acc[rr][r]), sc1[i][e], bias[e]);
              // lrelu keeps u >= 0, PReLU u > 0; no act has slope 1 (u * 1 == u)
              u = u > 0.f || (ge && u == 0.f) ? u : __fmul_rn(u, slope[e]);
              if constexpr (RES) {
                if (has_r1) u = __fmaf_rn(s1, u, __uint_as_float((w1[i] << sh) & 0xffff0000u));
                if (has_r2)
                  u = __fmaf_rn(s2, __bfloat162float(__float2bfloat16_rn(u)),
                                __uint_as_float((w2[i] << sh) & 0xffff0000u));
              }
              v[e] = u;
            }
            if (ok) {
              *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v[0], v[1]);
              // |bf16(v)| = bf16(|v|), and rounding keeps order: the stored
              // values' |max| is bf16(max |v|), rounded at the flush
              m = fmaxf(m, fmaxf(fabsf(v[0]), fabsf(v[1])));
            }
          }
        }
      }
    };
    if (a.r1 || a.r2)
      epilogue(std::true_type{});
    else
      epilogue(std::false_type{});
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr)
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) {
        if constexpr (MULTI)
          fsum[rr][e] = 0.f;  // the next tile's first fold overwrites it
        else
          acc[rr][e] = 0;
      }
    VR_CLK(e1);
    VR_ADD(9, e1 - e0);
    VR_ADD(10, 1);
  }
  if (a.out_amax && mn >= 0) flush();
#ifdef VR_PROBE_CLOCKS
  VR_CLK(k1);
  clk[11] = k1 - k0;
  if (tid == 0)
    for (int i = 5; i < 12; ++i) atomicAdd(vr_i8_clocks + i, (unsigned long long)clk[i]);
#endif
}

// ---- host -------------------------------------------------------------------------

template <int NT, bool MULTI>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_t, const CUtensorMap& tm_w,
                   const I8Args& a, int grid, int smem, cudaStream_t stream) {
  auto kernel = conv3x3_i8_wgmma_kernel<NT, MULTI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(tm_x, tm_t, tm_w, a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_t, const CUtensorMap& tm_w,
                   const I8Args& a, int grid, int smem, cudaStream_t stream) {
  return a.nseg > 1 ? launch<NT, true>(tm_x, tm_t, tm_w, a, grid, smem, stream)
                    : launch<NT, false>(tm_x, tm_t, tm_w, a, grid, smem, stream);
}

}  // namespace

extern "C" {

// The build's tile rows at cout 32 and 64 and its tile pixels, channels a
// stage, int8 ring depth, most raw slots, consumer warpgroups, bytes of the
// parameters, the dynamic shared memory a block can have, and the bytes of a
// raw and of an int8 slot at cout 32 and 64: out[0..12] (what
// ops/quant.py::i8_wgmma_plan needs).
int vr_conv3x3_i8_wgmma_config(int* out) {
  out[0] = Geo<4>::TH;
  out[1] = Geo<8>::TH;
  out[2] = TW;
  out[3] = KC;
  out[4] = QS;
  out[5] = RAW_MAX;
  out[6] = NC;
  out[7] = PARAM_BYTES;
  out[8] = SMEM_MAX;
  out[9] = Geo<4>::RAW_BYTES;
  out[10] = Geo<4>::Q_PAD;
  out[11] = Geo<8>::RAW_BYTES;
  out[12] = Geo<8>::Q_PAD;
  return 0;
}

// vr_conv3x3_i8_mma's arguments and contract (w the packed (9, cout, cin)
// int8 weight), then the plan: PLAN_LEN int64 values from
// ops/quant.py::i8_wgmma_plan (x's 4-D map: dims, byte strides, box; the
// tail's blocks, its 5-D map's byte strides and box; w's 3-D map: dims,
// byte strides, box, swizzle bytes; the grid, the tile, the raw ring's
// depth, the int8 ring's, the shared-memory bytes; the stages, each stage's
// segment (4 bits a stage), the masks of the segments' first and last
// stages), and xt: the tail, (blocks, B, H, W, 32) contiguous, whose
// channels follow x's (null without one). cudaErrorInvalidValue for a call
// the route does not take or a plan that does not describe this call and
// build; cudaErrorNotSupported when no tensor map encoder was found or
// cuTensorMapEncodeTiled refused a map.
int vr_conv3x3_i8_wgmma(const void* x, const void* amax, const void* w, const void* sw,
                        const void* b, const void* alpha, const void* r1, const void* r2,
                        void* y, void* out_amax, int B, int H, int W, int cin, int cout,
                        long long xs, long long ys, long long r1s, long long r2s, long long as,
                        long long os, int nseg, const int* seg, const float* sa,
                        const float* inv, int act, float s1, float s2, void* stream,
                        const long long* plan, int plan_len, const void* xt) {
  if (nseg < 1 || nseg > kMaxSeg || seg == nullptr || seg[0] != 0 || seg[nseg] != cin)
    return cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i)
    if (seg[i + 1] <= seg[i] || (seg[i + 1] - seg[i]) % KC) return cudaErrorInvalidValue;
  if ((sa == nullptr) != (inv == nullptr) ||
      (sa ? amax != nullptr || out_amax != nullptr : amax == nullptr))
    return cudaErrorInvalidValue;
  if ((cout != 32 && cout != 64) || cin > kMaxStages * KC || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(alpha) ||
      !aligned16(r1) || !aligned16(r2) || !aligned16(y) || !aligned16(xt) || xs % 8 ||
      ys % 8 || r1s % 8 || r2s % 8)
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long *a_dims = plan, *a_strides = plan + 4, *a_box = plan + 7;
  const long long nblk = plan[11], *t_strides = plan + 12, *t_box = plan + 16;
  const long long *w_dims = plan + 21, *w_strides = plan + 24, *w_box = plan + 26;
  const long long w_swz = plan[29], grid = plan[30], dr = plan[33], qs = plan[34];
  const long long smem = plan[35], nk = plan[36];
  const long long seg_of = plan[37], first = plan[38], last = plan[39];
  const long long head = a_dims[0];  // x's channels; the tail's follow
  // the plan must describe this call and this build
  const int TH = cout == 64 ? Geo<8>::TH : Geo<4>::TH, PH = TH + 2;
  if (nblk < 0 || (nblk > 0) != (xt != nullptr) || head + nblk * KC != cin || head % KC ||
      (nblk > 0 && (t_strides[0] != KC * 2 || t_box[0] != KC || t_box[1] != PW ||
                    t_box[2] != PH || t_box[3] != 1 || t_box[4] != 1)))
    return cudaErrorInvalidValue;
  if (a_dims[1] != W || a_dims[2] != H || a_dims[3] != B || a_strides[0] != xs * 2 ||
      a_strides[1] != xs * 2 * W || a_strides[2] != xs * 2 * W * H ||
      (nblk > 0 && (t_strides[1] != KC * 2LL * W || t_strides[2] != KC * 2LL * W * H ||
                    t_strides[3] != KC * 2LL * W * H * B)) ||
      a_box[0] != KC || a_box[1] != PW || a_box[2] != PH || a_box[3] != 1 ||
      w_dims[0] != cin || w_dims[1] != cout || w_dims[2] != 9 || w_strides[0] != cin ||
      w_strides[1] != (long long)cout * cin || w_box[0] != KC || w_box[1] != cout ||
      w_box[2] != 9 || w_swz != KC || plan[31] != TH || plan[32] != TW || qs != QS ||
      dr < 1 || dr > RAW_MAX || nk != cin / KC ||
      smem != (cout == 64 ? smem_bytes<8>((int)nk, (int)dr) : smem_bytes<4>((int)nk, (int)dr)) ||
      smem > SMEM_MAX || grid <= 0 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the stage schedule: each stage's segment, the segments' first and last
  long long want_of = 0, want_first = 0, want_last = 0;
  for (int k = 0, s = 0; k < nk; ++k) {
    while (seg[s + 1] <= k * KC) ++s;
    want_of |= (long long)s << (4 * k);
    if (seg[s] == k * KC) want_first |= 1LL << k;
    if (seg[s + 1] == (k + 1) * KC) want_last |= 1LL << k;
  }
  if (seg_of != want_of || first != want_first || last != want_last) return cudaErrorInvalidValue;
  const long long tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if (tiles > 0x7fffffffLL || grid > tiles || (long long)B * H * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w, tm_t = {};
  const long long t_dims[5] = {KC, W, H, B, nblk};
  if (!encode(&tm_x, x, 4, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&tm_w, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_32B,
              CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      (nblk > 0 &&
       !encode(&tm_t, xt, 5, t_dims, t_strides, t_box, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorNotSupported;
  I8Args a;
  a.amax = static_cast<const float*>(amax);
  a.sw = static_cast<const float*>(sw);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.alpha = static_cast<const __nv_bfloat16*>(alpha);
  a.r1 = static_cast<const __nv_bfloat16*>(r1);
  a.r2 = static_cast<const __nv_bfloat16*>(r2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.out_amax = static_cast<float*>(out_amax);
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.nk = (int)nk;
  a.head = (int)(head / KC);
  a.nseg = nseg;
  a.dr = (int)dr;
  a.tiles_x = (int)tiles_x;
  a.tiles_y = (int)tiles_y;
  a.tiles = (int)tiles;
  a.ys = ys;
  a.r1s = r1s;
  a.r2s = r2s;
  a.as = as;
  a.os = os;
  a.seg_of = (int)seg_of;
  a.first = (int)first;
  a.last = (int)last;
  a.act = act;
  a.stat = sa != nullptr;
  a.s1 = s1;
  a.s2 = s2;
  for (int i = 0; i < kMaxSeg; ++i) {
    a.sa[i] = sa && i < nseg ? sa[i] : 0.f;
    a.inv[i] = sa && i < nseg ? inv[i] : 0.f;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch<8>(tm_x, tm_t, tm_w, a, (int)grid, (int)smem, st)
                    : launch<4>(tm_x, tm_t, tm_w, a, (int)grid, (int)smem, st);
}

#ifdef VR_PROBE_CLOCKS
// tools/probe_k4.py: the clocks summed since the last call (12 values), then zeroed.
int vr_conv3x3_i8_wgmma_clocks(long long* out) {
  unsigned long long v[12];
  cudaError_t e = cudaMemcpyFromSymbol(v, vr_i8_clocks, sizeof v);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < 12; ++i) out[i] = (long long)v[i];
  const unsigned long long z[12] = {};
  return cudaMemcpyToSymbol(vr_i8_clocks, z, sizeof z);
}
#endif

}  // extern "C"
