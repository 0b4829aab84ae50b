// K1, Hopper route for fp32 ("bf16x3"): SAME 3x3 convolution on NHWC fp32
// activations and fp32 weights, computed on the bf16 tensor cores as three
// bf16 parts a value.
//
// It computes the function of conv3x3.cu at fp32 (bias, act in {none, lrelu
// 0.2, PReLU}, r1 + s1 * v, r2 + s2 * v, `up2` input read through nearest 2x
// with zero padding on the 2x grid, every activation operand a
// channel-prefix view with its own pixel stride, `out` possibly a channel
// slice of a wider buffer, conv3x3.cu's epilogue arithmetic and rounding
// points) for the fp32 calls whose widths conv3x3_wgmma.cu takes in bf16:
// cin a multiple of 16, cout 32 or 64, 16-byte-aligned operands
// (ops/tail.py::conv3x3_route). It serves the same Pallas entry points as
// conv3x3_wgmma.cu at `--precision fp32`:
//   pallas_stripe.py rdb_stripe2d_split / rdb_stripe2d_padded /
//                    rdb_res_stripe2d_padded / rdb_stripe_padded /
//                    rdb_res_stripe_padded (the five dense-block convs)
//   pallas_tail.py   conv3x3_fused (conv_body + residual), up1_fused (up2),
//                    tail_fused_raw / tail_fused (upconv2 and conv_hr: the
//                    fp32 tail runs as three K1 launches)
//   pallas_srvgg.py  srvgg_stripe2d_split / srvgg_stripe2d_padded /
//                    srvgg_stripe_padded (the chained conv + PReLU body)
//
// The arithmetic. Each fp32 value splits exactly into three bf16 parts,
// a = a0 + a1 + a2 with a0 = bf16(a), a1 = bf16(a - a0), a2 = a - a0 - a1
// (each difference is exact in fp32, and bf16 has fp32's exponent range).
// A product a * w is the nine products of the parts; the six with i + j <= 2
// (a2 w0, a1 w1, a0 w2, a1 w0, a0 w1, a0 w0, smallest first) are summed in
// one fp32 accumulator, the three left out are ~2^-24 of each term: fp32's
// own rounding. Each bf16 product is exact; the tensor cores add each k16
// group into the fp32 accumulator with a rounding of their own, whose error
// grows with the groups a sum has (chip_smoke.py [k1] fp32 precision checks
// a single product within 2^-22 of fp32's, read at 7e-8 - 9e-8, and a sum
// of cin channels within 1.5e-7 x cin of its largest value against
// float64, read at about 7e-8 x cin: 1.15e-5 - 1.22e-5 at cin 192, where
// cuDNN fp32 reads ~1.7e-6). The weights are split once on the host
// (ops/tail.py::weight_parts: a (3, 3, 3, cin, cout) bf16 tensor,
// part-major, kept for as long as the weight is unchanged); TMA cannot
// split the activations, so a producer warpgroup does (below). This is not TF32
// (10 mantissa bits, ~1e-3), which the port's callers never enable.
//
// The GEMM is conv3x3_wgmma.cu's: M = output pixels (an m64 tile = 64
// neighbouring pixels of one output row), N = cout, K = 9 taps x cin, KC =
// 16 input channels a stage (one k16 step of each part). What bounds it on
// the H100: the tensor cores, six bf16 products a MAC (a 1080p RDB: 6 x
// 0.994 TFLOP over 989 TFLOP/s = 6.0 ms, against 2.35 ms of its fp32 bytes
// and 14.8 ms of fp32 FMAs at the CUDA cores' 67 TFLOP/s). The design:
//
//  - A window stage: TMA brings the raw fp32 window ((TH + 2) x (TW + 2)
//    pixels of KC channels, 64-byte rows, no swizzle) into a raw slot,
//    through a 4-D map over (channels, W, H, B) whose W stride is the view's
//    pixel stride, out-of-frame reads zero filled (SAME padding; every part
//    of 0 is 0). `up2` (up1, upconv2): a box cannot read the 2x grid, so the
//    producer's 128 threads fill the raw slot with 16-byte `cp.async`s from
//    coarse pixel (y >> 1, x >> 1), zero outside the 2x frame.
//  - The split: the producer warpgroup (registers handed to the consumers
//    with setmaxnreg) turns each raw window into its three bf16 parts, each
//    K-major, one pixel a 32-byte row in the 32-byte swizzle `wgmma` reads,
//    fences its stores to the async proxy and each warp arrives on the
//    stage's full barrier; its thread 0 adds the stage's weights (one 4-D
//    TMA box over (cout, cin, 9, 3): KC channels of every tap of the three
//    parts, N-major in the cout * 2-byte swizzle, `wgmma`'s transpose bit)
//    with the barrier's expect_tx, and refills the raw slot once the
//    warpgroup's named barrier says it has been read. (K4's quantiser
//    warpgroup, conv3x3_i8_wgmma.cu, with a split in place of the
//    quantiser.)
//  - Shared memory sets the shape: three parts of a window and three of a
//    stage's weights are 95 KB at cout 64 (4 x 64 tile) and 92 KB at cout 32
//    (8 x 64: at half the weights a tap, twice the rows, so the halo is a
//    smaller share of the split), two such stages and one raw slot (25 or
//    42 KB) fill the 227 KB a block can have: a third stage cannot fit.
//    The weights cannot stay
//    resident (221 KB for a 64 -> 64 conv in three parts), so each stage
//    streams its own, from L2.
//  - Two consumer warpgroups share each tile, RPC rows each (4 at cout 32,
//    2 at cout 64: 64 fp32 sums a thread either way); per stage a warpgroup
//    issues 9 taps x 6 products x RPC `wgmma` m64nNk16, commits them, and
//    releases the stage before once that group has completed (wait_group
//    1). A tap's (dy, dx) shift moves only the A descriptor's start.
//  - A persistent grid (one block an SM) walks the tiles, row-major within
//    an image; the producer runs ahead across tiles.
//  - The epilogue: conv3x3_wgmma.cu's accumulator layout (warp w of the
//    warpgroup rows 16 w .. 16 w + 15, lane 4 g + q: rows g and g + 8,
//    columns 8 i + 2 q and + 1) and store path (fp32 pairs from registers, a
//    row's residuals loaded before its first store), conv3x3.cu's
//    arithmetic; partial tiles mask their stores.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/probe_k1.py --dtype fp32,
// each build timed in order and back): the 1080p fp32 RDB 11.84-11.96 ms
// against conv3x3.cu's 43.8-45.4 and cuDNN's fp32 chain's 39.3-40.0 (TF32
// off); its cout-32 convs at 46-51% of their bound, conv5 at 72%, up1 at
// 64%. What holds it: the time follows the products (conv1 0.98 / 0.75 /
// 0.51 ms with 6 / 4 / 2 of them; conv5's each at the tensor cores' peak),
// so at cout 32 the operands' shared-memory reads (an m64n32k16 reads 3 KB
// for 64 K MACs) and at cout 64 a fixed share (~1.1 ms of conv5: the tile
// epilogue and the ring's fill) hold it; the split costs 4-6%. Measured
// and not kept: 4-row tiles at cout 32 with three raw windows (no better),
// 2-row tiles at cout 64 (slower: twice the weights from L2 a pixel).
//
// The tensor maps are encoded on the host per call from the dims, byte
// strides and boxes that ops/tail.py::bf16x3_plan computes; the launcher
// checks the plan against this build (vr_conv3x3_bf16x3_config) and the
// call, and refuses one that does not match. The tile rows are
// compile-time (-DVR_X3_ROWS32, -DVR_X3_ROWS64; tools/probe_k1.py --dtype
// fp32 builds and times variants); K3's rows at N 48 and 16 are fixed.

#include <stdint.h>

#include "wgmma_tile.cuh"

#ifndef VR_X3_ROWS32
#define VR_X3_ROWS32 4  // output rows (m64 tiles) a consumer warpgroup, cout 32
#endif
#ifndef VR_X3_ROWS64
#define VR_X3_ROWS64 2  // the same at cout 64
#endif
#ifndef VR_PROBE_PRODUCTS
#define VR_PROBE_PRODUCTS 6  // tools/probe_k1.py: the largest N of the six products only
#endif

namespace {

using namespace wgmma_tile;

constexpr int NC = 2;    // consumer warpgroups a block, sharing each tile
constexpr int TW = 64;   // output pixels of a tile row: one m64
constexpr int PW = TW + 2;
constexpr int KC = 16;   // input channels a stage: one k16 step a part
constexpr int A_ROW = KC * 2;      // bytes of a pixel of one bf16 part: a 32-byte swizzle row
constexpr int RAW_ROW = KC * 4;    // bytes of a raw fp32 pixel
constexpr int QS = 2;              // stages of split windows and their weights
constexpr int DR = 1;              // raw windows in flight
constexpr int PT = 128;            // the producer warpgroup's threads
constexpr int kThreads = NC * 128 + PT;
constexpr int PRODUCER_REGS = 56;  // the producer's registers a thread
// what the consumers may take: the SM's registers less the producer's, in
// steps of 8, less 8 (the pool cannot hand out its last ones), at most 256
constexpr int CONSUMER_REGS_ = ((65536 - PT * PRODUCER_REGS) / (NC * 128)) / 8 * 8 - 8;
constexpr int CONSUMER_REGS = CONSUMER_REGS_ > 256 ? 256 : CONSUMER_REGS_;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can have
constexpr int PLAN_LEN = 27;
constexpr int ROWS48 = 2;  // output rows a consumer warpgroup at N 48 (K3 at r 4: srvgg_up_bf16x3.cu)
constexpr int ROWS16 = 4;  // the same at N 16 (K3 at r 2, 12 columns padded to 16)

constexpr int pad1k(int v) { return (v + 1023) / 1024 * 1024; }

// The tile of NT = N / 8 and its shared memory: a ring of QS stages, each
// the three weight parts (KC channels of every tap) then, from the next 1024
// bytes, the three window parts, then DR raw fp32 windows, then the barriers
// (the stages' full and empty, the raw slots' full). NT 4 and 8 are K1's
// cout 32 and 64, whose weights are N-major (the transpose bit) in the
// cout * 2-byte swizzle; NT 6 and 2 are K3's N 48 and 16
// (srvgg_up_bf16x3.cu), whose 96-byte N-major rows no swizzle mode fits:
// their weights are K-major, a cout's KC channels one 32-byte row in the
// 32-byte swizzle, as the windows are.
template <int NT>
struct Geo {
  static constexpr int N = NT * 8;
  static constexpr bool B_KMAJOR = NT == 6 || NT == 2;
  static constexpr int RPC = NT == 4   ? VR_X3_ROWS32
                             : NT == 8 ? VR_X3_ROWS64
                             : NT == 6 ? ROWS48
                                       : ROWS16;
  static constexpr int TH = NC * RPC;
  static constexpr int PH = TH + 2;
  static constexpr int TAP_BYTES = KC * N * 2;            // KC x cout bf16
  static constexpr int W_PART = 9 * TAP_BYTES;            // a part's weights, every tap
  static constexpr int A_OFF = pad1k(3 * W_PART);         // the window parts in a stage
  static constexpr int A_PART = pad1k(PH * PW * A_ROW);   // a part's window, swizzled
  static constexpr int STAGE = A_OFF + 3 * A_PART;        // a multiple of 1024
  static constexpr int RAW_BYTES = PH * PW * RAW_ROW;     // as TMA writes it
  static constexpr int SMEM = 1024 + QS * STAGE + DR * RAW_BYTES + (2 * QS + DR) * 8;
  // 128 B : 64 B swizzle (N-major), 32 B (K-major)
  static constexpr int B_LAYOUT = B_KMAJOR ? 3 : N == 64 ? 1 : 2;
  static constexpr int B_SBO = B_KMAJOR ? 8 * KC * 2 : 8 * N * 2;  // 8 rows of K or of cout
  static constexpr int CHUNKS = PH * PW * KC / 8;   // 8-channel chunks of a window
  static_assert(SMEM <= SMEM_MAX, "the stages and the raw window must fit");
  static_assert(RAW_BYTES % 128 == 0, "TMA destinations on 128 bytes");
  static_assert(W_PART % (B_KMAJOR ? 256 : 1024) == 0, "weight parts on the swizzle's atoms");
  static_assert(B_KMAJOR || A_OFF == 3 * W_PART, "K1's stage layout");
};

struct X3Args {
  const float* x;      // up2: (B, ih, iw, >=cin) pixel stride xs
  const float* b;      // (cout,)
  const float* alpha;  // (cout,) for PReLU, else null
  const float* r1;     // (B, H, W, >=cout) pixel stride r1s, or null
  const float* r2;     // (B, H, W, >=cout) pixel stride r2s, or null
  float* y;            // (B, H, W, >=cout) pixel stride ys
  int H, W, nk;        // the output's H, W; nk = cin / KC
  int ih, iw;          // up2: x's H and W (half the output's)
  long long xs;
  int tiles_x, tiles_y, tiles;
  long long ys, r1s, r2s;
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  float s1, s2;
};

// The (image, first output row, first output column) of this block's j-th tile.
__device__ __forceinline__ void tile_of(const X3Args& a, int j, int th, int& n, int& oy0,
                                        int& ox0) {
  const int t = blockIdx.x + j * gridDim.x;
  const int per_image = a.tiles_x * a.tiles_y;
  n = t / per_image;
  const int rem = t - n * per_image;
  const int ty = rem / a.tiles_x;
  oy0 = ty * th;
  ox0 = (rem - ty * a.tiles_x) * TW;
}

// 8 fp32 values -> their three bf16 parts, 8 each (16 bytes a part).
__device__ __forceinline__ void split8(const float4& lo, const float4& hi, uint4& p0, uint4& p1,
                                       uint4& p2) {
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t q0[4], q1[4], q2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b0 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    const float2 f0 = __bfloat1622float2(b0);
    const float r0 = __fsub_rn(v[2 * j], f0.x), r1 = __fsub_rn(v[2 * j + 1], f0.y);
    const __nv_bfloat162 b1 = __floats2bfloat162_rn(r0, r1);
    const float2 f1 = __bfloat1622float2(b1);
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(__fsub_rn(r0, f1.x), __fsub_rn(r1, f1.y));
    q0[j] = *reinterpret_cast<const uint32_t*>(&b0);
    q1[j] = *reinterpret_cast<const uint32_t*>(&b1);
    q2[j] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  p0 = make_uint4(q0[0], q0[1], q0[2], q0[3]);
  p1 = make_uint4(q1[0], q1[1], q1[2], q1[3]);
  p2 = make_uint4(q2[0], q2[1], q2[2], q2[3]);
}

// The six products of a tap, smallest terms first, p = 0 .. 5: window part
// PA(p) times weight part PWP(p) (a2 w0, a1 w1, a0 w2, a1 w0, a0 w1, a0 w0).
__host__ __device__ constexpr int PA(int p) { return p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0; }
__host__ __device__ constexpr int PWP(int p) { return p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0; }

// ---- the roles --------------------------------------------------------------------
//
// The producer's and the consumers' walks over one conv's tiles, as device
// functions: the kernel below runs one conv; rdb_fused_bf16x3.cu and
// tail_fused_bf16x3.cu include this source (VR_X3_DEVICE_ONLY: without the
// kernel and the entry points) and run several convs on the same ring;
// srvgg_up_bf16x3.cu runs the producer at its own widths (N 48 and 16,
// K-major weights) beside consumers of its own.

// A block's shared memory: its generic base and shared address, the ring of
// QS stages (1024-aligned; the raw slot follows a conv's stages) and the
// barriers (the stages' full and empty, the raw slots' full).
struct X3Smem {
  unsigned char* base;
  uint32_t s0, ring, qfull0, qempty0, rfull0;
};

// `bars`: the barriers' offset from the ring (past the largest ring a
// kernel uses).
__device__ __forceinline__ X3Smem x3_smem(unsigned char* smem, int bars) {
  X3Smem m;
  m.base = smem;
  m.s0 = smem_u32(smem);
  m.ring = (m.s0 + 1023u) & ~1023u;
  m.qfull0 = m.ring + bars;
  m.qempty0 = m.qfull0 + QS * 8;
  m.rfull0 = m.qempty0 + QS * 8;
  return m;
}

__device__ __forceinline__ void x3_init_barriers(const X3Smem& m) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(m.qfull0 + 8 * s, PT / 32 + 1);  // every producer warp, and the weights' expect_tx
      mbar_init(m.qempty0 + 8 * s, NC * 4);      // one arrive a consumer warp
    }
    for (int s = 0; s < DR; ++s) mbar_init(m.rfull0 + 8 * s, 1);  // the window's expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Where a role is in the ring (raw slot and phase, stage and phase), carried
// from one conv to the next.
struct X3Ring {
  int rs = 0, qs = 0;
  uint32_t rph = 0, qph = 0;
};

__device__ __forceinline__ int x3_my_tiles(const X3Args& a) {
  return (int)blockIdx.x < a.tiles ? (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

// The producer warpgroup's walk (TMA copies by its thread 0, the up2
// windows and the split by all PT): stage k < ka of a tile reads tm_x at
// channel k * KC, a later one tm_x2 at channel (k - ka) * KC (K5's input
// and its c_1 .. c_4; K1 passes tm_x twice and ka = nk).
template <int NT, bool UP2>
__device__ __forceinline__ void x3_produce(const X3Smem& m, const CUtensorMap* tm_x,
                                           const CUtensorMap* tm_x2, int ka,
                                           const CUtensorMap* tm_w, const X3Args& a,
                                           int my_tiles, X3Ring& r) {
  using G = Geo<NT>;
  constexpr int TH = G::TH;
  unsigned char* smem = m.base;
  const uint32_t s0 = m.s0, ring = m.ring;
  const uint32_t raw = ring + QS * G::STAGE;  // DR raw windows
  const uint32_t qfull0 = m.qfull0, qempty0 = m.qempty0, rfull0 = m.rfull0;
  const int pt = threadIdx.x - NC * 128;
  const int steps = my_tiles * a.nk;
  const int rs0 = r.rs;
  // step i: stage i % nk of this block's tile i / nk, into raw slot (rs0 + i) % DR
  auto issue = [&](int i) {
    const int j = i / a.nk, k = i - j * a.nk;
    int n, oy0, ox0;
    tile_of(a, j, TH, n, oy0, ox0);
    const int slot = (rs0 + i) % DR;
    const uint32_t dst = raw + slot * G::RAW_BYTES;
    if constexpr (UP2) {
      // the window at the fine grid from output pixel (oy0 - 1, ox0 - 1),
      // each fine pixel read from coarse pixel (y >> 1, x >> 1): 16 bytes
      // (4 channels) a copy, zero outside the 2x frame
      constexpr int CH = KC / 4;
      for (int u = pt; u < G::PH * PW * CH; u += PT) {
        const int pix = u / CH, ch = u - pix * CH;
        const int py = pix / PW, px = pix - py * PW;
        const int fy = oy0 - 1 + py, fx = ox0 - 1 + px;
        const bool ok = fy >= 0 && fy < a.H && fx >= 0 && fx < a.W;
        const float* src =
            ok ? a.x + ((((long long)n * a.ih + (fy >> 1)) * a.iw + (fx >> 1)) * a.xs +
                        k * KC + ch * 4)
               : a.x;
        cp_async16(dst + pix * RAW_ROW + ch * 16, src, ok);
      }
      cp_async_commit();
    } else if (pt == 0) {
      const uint32_t bar = rfull0 + 8 * slot;
      mbar_expect_tx(bar, G::RAW_BYTES);
      if (k < ka)
        tma_load_4d(dst, tm_x, bar, k * KC, ox0 - 1, oy0 - 1, n);
      else
        tma_load_4d(dst, tm_x2, bar, (k - ka) * KC, ox0 - 1, oy0 - 1, n);
    }
  };
  for (int i = 0; i < DR && i < steps; ++i) issue(i);
  for (int i = 0; i < steps; ++i) {
    const int k = i % a.nk;
    const int rs = r.rs, qs = r.qs;
    if constexpr (UP2) {
      cp_async_wait<0>();  // this thread's copies; the barrier below, everyone's
      asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");
    } else {
      mbar_wait(rfull0 + 8 * rs, r.rph);
    }
    mbar_wait(qempty0 + 8 * qs, r.qph ^ 1);
    const uint32_t st = ring + qs * G::STAGE;
    if (pt == 0) {  // the stage's weights: KC channels of every tap of the three parts
      mbar_expect_tx(qfull0 + 8 * qs, 3 * G::W_PART);
      if constexpr (G::B_KMAJOR)  // a map over (cin, cout, 9, 3)
        tma_load_4d(st, tm_w, qfull0 + 8 * qs, k * KC, 0, 0, 0);
      else  // over (cout, cin, 9, 3)
        tma_load_4d(st, tm_w, qfull0 + 8 * qs, 0, k * KC, 0, 0);
    }
    // chunk c: 8 channels of window pixel c / 2, 32 bytes at c * 32 of the
    // raw window and 16 bytes at c * 16 of each part (swizzled); a thread's
    // chunks are c = pt + PT u, BATCH loaded ahead of their splits
    const uint32_t src = raw + rs * G::RAW_BYTES, dst = st + G::A_OFF;
    const float4* __restrict__ rw = reinterpret_cast<const float4*>(smem + (src - s0));
    constexpr int FULL = G::CHUNKS / PT, TAIL = G::CHUNKS % PT, BATCH = 4;
    auto split = [&](int c, const float4& lo, const float4& hi) {
      uint4 p0, p1, p2;
      split8(lo, hi, p0, p1, p2);
      const uint32_t off = swizzle<32>(dst + c * 16) - s0;
      *reinterpret_cast<uint4*>(smem + off) = p0;
      *reinterpret_cast<uint4*>(smem + off + G::A_PART) = p1;
      *reinterpret_cast<uint4*>(smem + off + 2 * G::A_PART) = p2;
    };
#ifndef VR_PROBE_NO_SPLIT  // tools/probe_k1.py: the parts as they lie
#pragma unroll
    for (int u0 = 0; u0 < FULL; u0 += BATCH) {
      float4 v[BATCH][2];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (u0 + u < FULL) {
          v[u][0] = rw[2 * (pt + PT * (u0 + u))];
          v[u][1] = rw[2 * (pt + PT * (u0 + u)) + 1];
        }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (u0 + u < FULL) split(pt + PT * (u0 + u), v[u][0], v[u][1]);
    }
    if (TAIL && pt < TAIL) {
      const int c = pt + PT * FULL;
      split(c, rw[2 * c], rw[2 * c + 1]);
    }
#endif
    fence_async_shared();  // this thread's stores, before `wgmma` reads them
    __syncwarp();
    if ((pt & 31) == 0) mbar_arrive(qfull0 + 8 * qs);  // this warp's share is stored
    asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");  // raw slot rs is read
    if (i + DR < steps) issue(i + DR);
    if (++r.rs == DR) {
      r.rs = 0;
      r.rph ^= 1;
    }
    if (++r.qs == QS) {
      r.qs = 0;
      r.qph ^= 1;
    }
  }
}

// The consumer warpgroups' walk: the MMAs of each stage and each tile's
// epilogue (r.qs, r.qph: the ring's stage and phase).
template <int NT>
__device__ __forceinline__ void x3_consume(const X3Smem& m, const X3Args& a, int my_tiles,
                                           X3Ring& r) {
  using G = Geo<NT>;
  constexpr int N = G::N, RPC = G::RPC, TH = G::TH;
  const uint32_t ring = m.ring, qfull0 = m.qfull0, qempty0 = m.qempty0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // this warpgroup's rows of a tile: wg * RPC ..
  const int wl = warp & 3, g = lane >> 2, q = lane & 3;

  // this thread's output channels: 8 i + 2 q and + 1
  float bias[NT][2], al[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(a.b + 8 * i + 2 * q);
    bias[i][0] = bb.x;
    bias[i][1] = bb.y;
    float2 aa = make_float2(0.f, 0.f);
    if (a.act == 2) aa = *reinterpret_cast<const float2*>(a.alpha + 8 * i + 2 * q);
    al[i][0] = aa.x;
    al[i][1] = aa.y;
  }

  // descriptors at the ring: A K-major in the 32-byte swizzle (8-pixel groups
  // 256 bytes apart), B a tap's KC x cout rows, N-major in the cout * 2-byte
  // swizzle; a stage, part, row, tap moves only the start (16-byte units)
  const uint64_t da0 = make_desc(ring, 16, 8 * A_ROW, 3);
  const uint64_t db0 = make_desc(ring, 16, G::B_SBO, G::B_LAYOUT);

  float acc[RPC][NT * 4];
  int s = r.qs;
  uint32_t ph = r.qph;
  for (int j = 0; j < my_tiles; ++j) {
    int n, oy0, ox0;
    tile_of(a, j, TH, n, oy0, ox0);
    int prev = 0;
    for (int k = 0; k < a.nk; ++k) {
      mbar_wait(qfull0 + 8 * s, ph);
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
      wg_fence();
      const uint32_t st = s * G::STAGE;
#ifndef VR_PROBE_NO_MMA  // tools/probe_k1.py: the ring and the split alone
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - ky * 3;
#pragma unroll
        for (int p = 6 - VR_PROBE_PRODUCTS; p < 6; ++p) {
          const uint32_t a_off = st + G::A_OFF + PA(p) * G::A_PART;
          const uint32_t b_off = st + PWP(p) * G::W_PART + tap * G::TAP_BYTES;
#pragma unroll
          for (int rr = 0; rr < RPC; ++rr)
            Wgmma<N>::run(acc[rr],
                          da0 + (uint64_t)((a_off + ((wg * RPC + rr + ky) * PW + kx) * A_ROW) >> 4),
                          db0 + (uint64_t)(b_off >> 4), (k | tap | (p - 6 + VR_PROBE_PRODUCTS)) != 0);
        }
      }
#endif
      wg_commit();
      if (k > 0) {
        wg_wait<1>();  // the previous stage's MMAs are done: release it
        if (lane == 0) mbar_arrive(qempty0 + 8 * prev);
      }
      prev = s;
      if (++s == QS) {
        s = 0;
        ph ^= 1;
      }
    }
    // the tile's sums are complete; said explicitly, so that the compiler
    // sees the last wait before the epilogue reads them
    wg_wait<0>();
    if (lane == 0) mbar_arrive(qempty0 + 8 * prev);
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);

    // epilogue: conv3x3.cu's arithmetic at fp32, two neighbouring channels
    // at a time, stored from registers; a row's residuals all loaded before
    // its first store
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) {
      const int oy = oy0 + wg * RPC + rr;
      long long pix[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + wl * 16 + g + 8 * h;
        ok[h] = oy < a.H && ox < a.W;
        pix[h] = ((long long)n * a.H + oy) * a.W + ox;
      }
#ifdef VR_PROBE_NO_STORE  // tools/probe_k1.py: no epilogue loads or stores
      ok[0] = ok[1] = false;
#endif
      float2 v1[2][NT], v2[2][NT];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int co = 8 * i + 2 * q;
          v1[h][i] = v2[h][i] = make_float2(0.f, 0.f);
          if (ok[h] && a.r1) v1[h][i] = *reinterpret_cast<const float2*>(a.r1 + pix[h] * a.r1s + co);
          if (ok[h] && a.r2) v2[h][i] = *reinterpret_cast<const float2*>(a.r2 + pix[h] * a.r2s + co);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int co = 8 * i + 2 * q;
          float v[2] = {acc[rr][4 * i + 2 * h], acc[rr][4 * i + 2 * h + 1]};
          const float rr1[2] = {v1[h][i].x, v1[h][i].y}, rr2[2] = {v2[h][i].x, v2[h][i].y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float u = __fadd_rn(v[e], bias[i][e]);
            if (a.act == 1) {
              u = u >= 0.f ? u : __fmul_rn(0.2f, u);
            } else if (a.act == 2) {
              u = u > 0.f ? u : __fmul_rn(u, al[i][e]);
            }
            if (a.r1) u = __fadd_rn(rr1[e], __fmul_rn(a.s1, u));
            if (a.r2) u = __fadd_rn(rr2[e], __fmul_rn(a.s2, u));
            v[e] = u;
          }
          *reinterpret_cast<float2*>(a.y + pix[h] * a.ys + co) = make_float2(v[0], v[1]);
        }
      }
    }
  }
  r.qs = s;
  r.qph = ph;
}

#ifndef VR_X3_DEVICE_ONLY

// ---- the kernel -------------------------------------------------------------------

template <int NT, bool UP2>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_bf16x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w, const X3Args a) {
  using G = Geo<NT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const X3Smem m = x3_smem(smem, QS * G::STAGE + DR * G::RAW_BYTES);
  x3_init_barriers(m);
  __syncthreads();
  const int my_tiles = x3_my_tiles(a);
  X3Ring r;
  if ((threadIdx.x >> 5) >= NC * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    x3_produce<NT, UP2>(m, &tm_x, &tm_x, a.nk, &tm_w, a, my_tiles, r);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  x3_consume<NT>(m, a, my_tiles, r);
}

// ---- host -------------------------------------------------------------------------

template <int NT, bool UP2>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const X3Args& a, int grid,
                   cudaStream_t stream) {
  using G = Geo<NT>;
  auto kernel = conv3x3_bf16x3_kernel<NT, UP2>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, G::SMEM, stream>>>(tm_x, tm_w, a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const X3Args& a, int grid,
                   bool up2, cudaStream_t stream) {
  return up2 ? launch<NT, true>(tm_x, tm_w, a, grid, stream)
             : launch<NT, false>(tm_x, tm_w, a, grid, stream);
}

#endif  // VR_X3_DEVICE_ONLY

}  // namespace

#ifndef VR_X3_DEVICE_ONLY

extern "C" {

// The build's tile rows at cout 32 and 64, tile pixels, channels a stage,
// consumer warpgroups, and dynamic shared memory a block at cout 32 and 64:
// out[0..6] (what ops/tail.py::bf16x3_plan needs).
int vr_conv3x3_bf16x3_config(int* out) {
  out[0] = Geo<4>::TH;
  out[1] = Geo<8>::TH;
  out[2] = TW;
  out[3] = KC;
  out[4] = NC;
  out[5] = Geo<4>::SMEM;
  out[6] = Geo<8>::SMEM;
  return 0;
}

// fp32 only: vr_conv3x3's arguments (w the (3, 3, 3, cin, cout) bf16 parts of
// ops/tail.py::split3, part-major), then the plan: PLAN_LEN int64 values from
// ops/tail.py::bf16x3_plan (x's 4-D map: dims, byte strides, box; w's 4-D
// map: dims, byte strides, box, swizzle bytes; the grid, the tile, the
// shared-memory bytes). up2: x is read through nearest 2x (the output is 2H
// x 2W; x's map is checked, not encoded: the producer copies the windows
// itself). cudaErrorInvalidValue for a call the route does not take or a
// plan that does not describe this call and build; cudaErrorNotSupported
// when no tensor map encoder was found or cuTensorMapEncodeTiled refused a
// map.
int vr_conv3x3_bf16x3(const void* x, const void* w, const void* b, const void* alpha,
                      const void* r1, const void* r2, void* y, int B, int H, int W, int cin,
                      int cout, long long xs, long long ys, long long r1s, long long r2s, int act,
                      int up2, float s1, float s2, void* stream, const long long* plan,
                      int plan_len) {
  if (cin <= 0 || cin % KC != 0 || (cout != 32 && cout != 64) || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(alpha) ||
      !aligned16(r1) || !aligned16(r2) || !aligned16(y) || xs % 4 || ys % 4 || r1s % 4 ||
      r2s % 4 || xs < cin || ys < cout || (act == 2 && alpha == nullptr))
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long *a_dims = plan, *a_strides = plan + 4, *a_box = plan + 7;
  const long long *w_dims = plan + 11, *w_strides = plan + 15, *w_box = plan + 18;
  const long long w_swz = plan[22], grid = plan[23], smem = plan[26];
  const int TH = cout == 64 ? Geo<8>::TH : Geo<4>::TH;
  const int SMEM = cout == 64 ? Geo<8>::SMEM : Geo<4>::SMEM;
  // the plan must describe this call and this build
  if (a_dims[0] != cin || a_dims[1] != W || a_dims[2] != H || a_dims[3] != B ||
      a_strides[0] != xs * 4 || a_strides[1] != xs * 4 * W || a_strides[2] != xs * 4 * W * H ||
      a_box[0] != KC || a_box[1] != PW || a_box[2] != TH + 2 || a_box[3] != 1 ||
      w_dims[0] != cout || w_dims[1] != cin || w_dims[2] != 9 || w_dims[3] != 3 ||
      w_strides[0] != cout * 2 || w_strides[1] != (long long)cin * cout * 2 ||
      w_strides[2] != 9LL * cin * cout * 2 || w_box[0] != cout || w_box[1] != KC ||
      w_box[2] != 9 || w_box[3] != 3 || w_swz != 2 * cout || plan[24] != TH || plan[25] != TW ||
      smem != SMEM || grid <= 0 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long OH = up2 ? 2LL * H : H, OW = up2 ? 2LL * W : W;
  if ((long long)B * OH * OW > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles_x = (OW + TW - 1) / TW, tiles_y = (OH + TH - 1) / TH;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if (grid > tiles) return cudaErrorInvalidValue;
  CUtensorMap tm_x = {}, tm_w;
  if ((!up2 && !encode(&tm_x, x, 4, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) ||
      !encode(&tm_w, w, 4, w_dims, w_strides, w_box,
              cout == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorNotSupported;
  X3Args a;
  a.x = static_cast<const float*>(x);
  a.b = static_cast<const float*>(b);
  a.alpha = static_cast<const float*>(alpha);
  a.r1 = static_cast<const float*>(r1);
  a.r2 = static_cast<const float*>(r2);
  a.y = static_cast<float*>(y);
  a.H = (int)OH;
  a.W = (int)OW;
  a.nk = cin / KC;
  a.ih = H;
  a.iw = W;
  a.xs = xs;
  a.tiles_x = (int)tiles_x;
  a.tiles_y = (int)tiles_y;
  a.tiles = (int)tiles;
  a.ys = ys;
  a.r1s = r1s;
  a.r2s = r2s;
  a.act = act;
  a.s1 = s1;
  a.s2 = s2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch<8>(tm_x, tm_w, a, (int)grid, up2 != 0, st)
                    : launch<4>(tm_x, tm_w, a, (int)grid, up2 != 0, st);
}

}  // extern "C"

#endif  // VR_X3_DEVICE_ONLY
