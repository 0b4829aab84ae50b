// K4, tensor-core route: the W8A8 int8 direct SAME 3x3 convolution of
// conv3x3_i8.cu on `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`
// (mma_tile.cuh's int8 routines).
//
// It computes exactly the function of `vr_conv3x3_i8` (see the note at the
// top of conv3x3_i8.cu: per-segment A8 quantised on load, exact int32 dot
// per segment, the fp32 fold in segment order, K1's epilogue, the optional
// per-image output amax), dynamic A8 (scales from the device amax array) and
// static A8 (fixed scales from the host), with the same arguments but the
// weights packed (9, cout, cin) int8 (ops/quant.py::pack_i8_weights). It
// serves the calls whose widths feed the tensor cores: bf16, every segment
// width a multiple of 32 (every RDB at nf 64 / gc 32: 64, 32, 32, 32, 32; the
// SRVGG body at nf 64: one segment of 64), cout 32 or 64, 16-byte-aligned
// operands with pixel strides that are multiples of 8;
// ops/quant.py::conv3x3_i8_route sends the rest to conv3x3_i8.cu's `__dp4a`
// kernel. The integer sums are exact in any order and every fp32 step repeats
// conv3x3_i8.cu's, so the two kernels agree bit for bit.
//
// Design. The work is K1's implicit GEMM (conv3x3_mma.cu) with twice the
// MACs per MMA and half the operand bytes, so what it has to hide is
// everything around the MMAs: quantising the activations, the epilogue, the
// loads. tools/probe_k4.py times the kernel without its MMAs, loads,
// quantiser or stores; each step below took time off what it showed.
//  - Tiles: 16 x 32 pixels at cout 32, a warp a row (two m16 tiles by four
//    n8 tiles); 8 x 32 at cout 64, two warps a row of 32 couts each (the
//    int32 and fp32 sums of 64 couts would be 128 registers a thread). 16
//    warps, one block per SM.
//  - Persistent: block b takes tiles b, b + gridDim.x, .. of every image,
//    and its steps (tile, k32 stage) run through one ring, so the next tile's
//    first stages load and quantise under this tile's last MMAs and
//    epilogue. Every stage of the conv's weights stays resident in shared
//    memory (9 x cout x cin int8, cin <= 192: 108 KB for RDB conv5), loaded
//    once per block.
//  - Quantise on load. The activations are bf16 in device memory and int8 in
//    shared memory. `cp.async` brings step g + 2's bf16 patch (16 bytes, 8
//    channels of a pixel, per copy; zero-filled outside the frame, and
//    q(0) = 0: SAME padding) into a ring of two slots; during the MMAs of
//    step g, after those of each tap, each thread quantises one of its own
//    16-byte chunks of step g + 1 into the other int8 patch, so the
//    quantiser runs beside the tensor cores and needs no barrier between the
//    copy and the read. One barrier per step.
//  - The quantiser on bf16x2 pairs (i8_quant.cuh, shared with
//    conv3x3_i8_wgmma.cu): `mul.rn.bf16x2` (a * inv), the sign of p | 0.5
//    (copysign), `add.rn.bf16x2`, `max`/`min.bf16x2` (clip to +-127.5), then
//    truncation to int: the same values as conv3x3_i8.cu's fp32 chain.
//  - Scales: each step's (image, segment) amax is loaded an iteration before
//    it is needed; weight scales, bias and alpha sit in shared memory.
//  - Sums: int32 for the segment in flight and, with several segments, fp32
//    for the running sum, folded at each segment's end as conv3x3_i8.cu does
//    (segment 0 as acc * sc, then fma(acc, sc, sum)).
//  - Epilogue: each quad of lanes turns its residuals (one 16-byte load per
//    lane and pixel, all in flight together) into the accumulator layout and
//    its outputs back (a 4 x 4 transpose by shuffles), so loads and stores
//    move 16 bytes a lane instead of 4.
//
// What bounds it on the H100: at nf 64 an RDB does 9.94e11 int8 operations
// at 1080p (0.50 ms at 1979 TOPS) and its five launches move ~3.4 GB of bf16
// (~1.0 ms at 3.35 TB/s); below those, the `ldmatrix` feed (as K1: 6
// `ldmatrix.x4` per 16 MMAs) and the issue slots of the quantiser and the
// epilogue, which tools/probe_k4.py shows to be the larger share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_quant.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using namespace i8_quant;

constexpr int kMaxSeg = 5;
constexpr int kMaxCin = 192;  // every stage of the weights stays resident

struct I8Args {
  const __nv_bfloat16* x;  // (B, H, W, >=cin), pixel stride xs
  const float* amax;       // amax[n * as + s]: per-(image, segment) |max|
  const int8_t* w;         // (9, cout, cin) contiguous
  const float* sw;         // (nseg, cout) weight scales
  const __nv_bfloat16* b;      // (cout,)
  const __nv_bfloat16* alpha;  // (cout,) for PReLU, else null
  const __nv_bfloat16* r1;     // (B, H, W, >=cout) pixel stride r1s, or null
  const __nv_bfloat16* r2;     // (B, H, W, >=cout) pixel stride r2s, or null
  __nv_bfloat16* y;            // (B, H, W, >=cout) pixel stride ys
  float* out_amax;             // out_amax[n * os], or null
  int B, H, W, cin, cout;
  long long xs, ys, r1s, r2s;
  long long as, os;
  int nseg;
  int seg[kMaxSeg + 1];
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  float s1, s2;
  float sa[kMaxSeg];    // static A8: the segments' fixed scales
  float inv[kMaxSeg];   // static A8: bf16(1 / sa), held as float
};

// NT: cout / 8. A tile is TH rows of 32 pixels, WN warps a row, each with
// NT / WN n8 tiles. Shared memory: every stage of the weights (nk * W_BYTES, resident), then a
// ring of two bf16 patches, then two int8 patches. Step g + 2 loads while
// step g + 1 is quantised and step g runs its MMAs.
template <int NT, int TH, int WN>
struct Geo {
  static constexpr int THREADS = 32 * TH * WN;
  static constexpr int NTW = NT / WN;  // n8 tiles per warp
  static constexpr int TW = ROW_PIX;
  static constexpr int PH = TH + 2, PW = TW + 2;
  static constexpr int CHUNKS = PH * PW * (KC8 / 8);  // 16-byte bf16 chunks
  static constexpr int ITEMS = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr int RAW_BYTES = CHUNKS * 16;       // bf16 patch, linear
  static constexpr int PATCH_BYTES = PH * PW * PIX_PITCH;  // int8 patch
  static constexpr int W_BYTES = WeightsI8<NT>::BYTES;
  static constexpr int RING_BYTES = 2 * RAW_BYTES + 2 * PATCH_BYTES;
  static int bytes(int nk) { return nk * W_BYTES + RING_BYTES; }
  static_assert(ITEMS <= 9, "one chunk per tap and thread");
  static_assert(RAW_BYTES % 16 == 0 && W_BYTES % 16 == 0 &&
                    PATCH_BYTES % 16 == 0,
                "alignment");
};

// 4 x 4 transpose of 32-bit values across each quad of lanes (t = lane & 3):
// on return a[s] holds what lane s of the quad held in a[t]
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
  uint32_t x = t & 1 ? a[0] : a[1], y = t & 1 ? a[2] : a[3];
  x = __shfl_xor_sync(0xffffffffu, x, 1);
  y = __shfl_xor_sync(0xffffffffu, y, 1);
  if (t & 1) {
    a[0] = x; a[2] = y;
  } else {
    a[1] = x; a[3] = y;
  }
  x = t & 2 ? a[0] : a[2];
  y = t & 2 ? a[1] : a[3];
  x = __shfl_xor_sync(0xffffffffu, x, 2);
  y = __shfl_xor_sync(0xffffffffu, y, 2);
  if (t & 2) {
    a[0] = x; a[1] = y;
  } else {
    a[2] = x; a[3] = y;
  }
}

// NT, TH, WN: as Geo. STATIC: the segments' scales from a.sa / a.inv.
// MULTI: more than one segment (fp32 running sums beside the int32 ones).
template <int NT, int TH, int WN, bool STATIC, bool MULTI>
__global__ void __launch_bounds__(32 * TH * WN, 1)
    conv3x3_i8_mma_kernel(const I8Args a) {
  using G = Geo<NT, TH, WN>;
  constexpr int NTW = G::NTW;
  constexpr int PW = G::PW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[TH * WN];
  __shared__ float s_sw[kMaxSeg * 64], s_b[64], s_al[64];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = warp / WN, n_first = (warp % WN) * NTW;  // the warp's tile
  const int nk = a.cin / KC8;
  const uint32_t s_w = smem_u32(smem);
  const uint32_t s_raw = s_w + nk * G::W_BYTES;
  const uint32_t s_patch = s_raw + 2 * G::RAW_BYTES;
  const int tiles_x = (a.W + G::TW - 1) / G::TW;
  const int tiles_img = tiles_x * ((a.H + TH - 1) / TH);
  const int total = a.B * tiles_img;
  const int my_tiles =
      (int)blockIdx.x < total ? (total - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_tiles * nk;
  if (steps == 0) return;  // the grid has no more blocks than tiles

  struct Tile {
    int n, oy0, ox0;
  };
  auto tile_of = [&](int i) {  // this block's i-th tile
    const int t = blockIdx.x + i * gridDim.x;
    const int n = t / tiles_img, r = t - n * tiles_img;
    const int ty = r / tiles_x;
    return Tile{n, ty * TH, (r - ty * tiles_x) * G::TW};
  };
  // the next step to load, in order (tile is_i of this block, input
  // channels 32 is_k ..), into ring slot g % 2: this thread's bf16
  // chunks (8 channels of a patch pixel, zero-filled outside the frame: q(0)
  // = 0, SAME padding), from the source pixels worked out once per tile; one
  // commit group per step, empty past the last
  int is_i = 0, is_k = 0;
  int spix[G::ITEMS];  // source pixel of each chunk, or -1 outside the frame
  auto issue = [&](int g) {
    if (g < steps) {
      if (is_k == 0) {
        const Tile tl = tile_of(is_i);
#pragma unroll
        for (int it = 0; it < G::ITEMS; ++it) {
          const int pix = (tid + it * G::THREADS) >> 2;
          const int py = pix / PW, px = pix - py * PW;
          const int oy = tl.oy0 + py - 1, ox = tl.ox0 + px - 1;
          spix[it] = oy >= 0 && oy < a.H && ox >= 0 && ox < a.W
                         ? (tl.n * a.H + oy) * a.W + ox
                         : -1;
        }
      }
      const uint32_t raw = s_raw + (g & 1) * G::RAW_BYTES;
#pragma unroll
      for (int it = 0; it < G::ITEMS; ++it) {
        const int c = tid + it * G::THREADS;
        if (c < G::CHUNKS) {
          const __nv_bfloat16* src =
              spix[it] >= 0
                  ? a.x + ((long long)spix[it] * a.xs + is_k * KC8 + (c & 3) * 8)
                  : a.x;
#ifndef VR_PROBE_NO_LOAD  // tools/probe_k4.py: no activation loads
          cp_async16(raw + c * 16, src, spix[it] >= 0);
#endif
        }
      }
      if (++is_k == nk) {
        is_k = 0;
        ++is_i;
      }
    }
    cp_async_commit();
  };
  // quantise item it of step g (landed for this thread) into patch p: only
  // this thread's own chunks, so no barrier between the copy and the read
  auto quant_item = [&](int it, int g, int p, uint32_t inv2) {
    const int c = tid + it * G::THREADS;
    if (c < G::CHUNKS) {
      uint32_t v0, v1, v2, v3;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                   : "r"(s_raw + (g & 1) * G::RAW_BYTES + c * 16));
#ifndef VR_PROBE_NO_QUANT  // tools/probe_k4.py: the same bytes moved, no quantiser
      const uint32_t q0 =
          __byte_perm(quant_pair(v0, inv2), quant_pair(v1, inv2), 0x5410);
      const uint32_t q1 =
          __byte_perm(quant_pair(v2, inv2), quant_pair(v3, inv2), 0x5410);
#else
      const uint32_t q0 = __byte_perm(v0, v1, 0x6420) ^ inv2;
      const uint32_t q1 = __byte_perm(v2, v3, 0x6420);
#endif
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(
                       s_patch + p * G::PATCH_BYTES + (c >> 2) * PIX_PITCH +
                       (c & 3) * 8),
                   "r"(q0), "r"(q1)
                   : "memory");
    }
  };
  // the image and the segment of the next step of a second cursor, which
  // runs ahead of the steps for the scales
  int pf_i = 0, pf_k = 0;
  auto next_ns = [&]() {
    int sg = 0;
    while (sg + 1 < a.nseg && a.seg[sg + 1] <= pf_k * KC8) ++sg;
    const int2 ns =
        make_int2((int)(blockIdx.x + pf_i * gridDim.x) / tiles_img, sg);
    if (++pf_k == nk) {
      pf_k = 0;
      ++pf_i;
    }
    return ns;
  };
  // a step's amax (dynamic A8), loaded an iteration before scale_at needs it
  auto amax_at = [&](int2 ns, bool valid) {
    return STATIC || !valid ? 0.f : __ldg(a.amax + ns.x * a.as + ns.y);
  };
  // a step's scale sa and bf16(1 / sa) (conv3x3_i8.cu's)
  auto scale_at = [&](int2 ns, float am) {
    if constexpr (STATIC) return make_float2(a.sa[ns.y], a.inv[ns.y]);
    const float sa = act_scale(am);
    return make_float2(sa, __bfloat162float(__float2bfloat16_rn(__fdiv_rn(1.0f, sa))));
  };
  auto inv2_of = [](float inv) {
    return bf2_bits(__float2bfloat162_rn(inv));  // exact: a bf16 value
  };

  int iacc[1][2][NTW][4];
  float facc[MULTI ? 2 : 1][MULTI ? NTW : 1][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) iacc[0][mt][nt][e] = 0;

  const uint32_t a_lane = s_patch + a_lane_offset<PW>(row, lane);
  const uint32_t b_lane =
      s_w + b_lane_offset_i8(lane) + n_first * 8 * WeightsI8<NT>::PITCH;

  load_weights_i8<NT, G::THREADS>(s_w, a.w, a.cin, tid);  // in group 0
  issue(0);
  issue(1);
  // the weight scales, bias and alpha, read by every fold and epilogue
  for (int i = tid; i < a.nseg * a.cout; i += G::THREADS) s_sw[i] = a.sw[i];
  for (int i = tid; i < a.cout; i += G::THREADS) {
    s_b[i] = __bfloat162float(a.b[i]);
    s_al[i] = a.act == 2 ? __bfloat162float(a.alpha[i]) : 0.f;
  }
  Tile cur = tile_of(0);
  int2 ns2 = next_ns();  // steps g, g + 1; g + 2 in flight
  float2 sc0 = scale_at(ns2, amax_at(ns2, true));
  ns2 = next_ns();
  float2 sc1 = scale_at(ns2, amax_at(ns2, steps > 1));
  ns2 = next_ns();
  float am2 = amax_at(ns2, steps > 2);
  cp_async_wait<1>();  // step 0 and every weight, for this thread
  {
    const uint32_t inv2 = inv2_of(sc0.y);
#pragma unroll
    for (int it = 0; it < G::ITEMS; ++it) quant_item(it, 0, 0, inv2);
  }
  int ti = 0, k = 0, s = 0, seg_end = a.seg[1];
  for (int g = 0; g < steps; ++g) {
    // patch g and every weight are in shared memory for everyone, and
    // everyone is done with the MMAs of step g - 1, whose ring slot and
    // patch are refilled below
    __syncthreads();
    issue(g + 2);
    cp_async_wait<1>();  // step g + 1, for this thread
    const bool last = k + 1 == nk;  // this tile's last step
    const bool seg_done = (k + 1) * KC8 == seg_end;
    const Tile nxt = last ? tile_of(ti + 1) : cur;
    const int s_next = last ? 0 : (seg_done ? s + 1 : s);
    const uint32_t inv2 = inv2_of(sc1.y);
    const float sa = sc0.x;
    // the MMAs of step g, and after the MMAs of each tap one chunk of step
    // g + 1 quantised into the other patch
    auto between = [&](int tap) {
      if (tap < G::ITEMS && g + 1 < steps) quant_item(tap, g + 1, (g + 1) & 1, inv2);
    };
#ifndef VR_PROBE_NO_MMA  // tools/probe_k4.py: loads and quantiser alone
    mma_taps_i8<NTW, 1, PW, NT>(iacc, a_lane + (g & 1) * G::PATCH_BYTES,
                                b_lane + k * G::W_BYTES, between);
#else
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) between(tap);
#endif
    sc0 = sc1;
    sc1 = scale_at(ns2, am2);
    ns2 = next_ns();
    am2 = amax_at(ns2, g + 3 < steps);
    if constexpr (MULTI) {
      if (seg_done) {
        // segment s is complete: dequantise it and add it after the earlier
        // ones (with a single segment the epilogue does it, bias as addend)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int co = frag_channel(lane, n_first + nt);
          const float sc[2] = {__fmul_rn(sa, s_sw[s * a.cout + co]),
                               __fmul_rn(sa, s_sw[s * a.cout + co + 1])};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __int2float_rn(iacc[0][mt][nt][e]);
              facc[mt][nt][e] = s == 0 ? __fmul_rn(v, sc[e & 1])
                                       : __fmaf_rn(v, sc[e & 1], facc[mt][nt][e]);
              iacc[0][mt][nt][e] = 0;
            }
        }
      }
    }
    if (seg_done && !last) {
      s = s_next;
      seg_end = a.seg[s + 1];
    }
    if (!last) {
      ++k;
      continue;
    }

    // this tile's epilogue (conv3x3_i8.cu's), four n8 tiles at a time: the
    // residuals loaded first (16 bytes, 8 channels of one n8 tile, per lane
    // and pixel, every load in flight at once), turned into the accumulator
    // layout across each quad of lanes, and the outputs turned back and
    // stored 16 bytes at a time; then the block's |max| of the stored values
    const int oy = cur.oy0 + row;
    const int t4 = lane & 3;
    long long pix[4];
    bool ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ox = cur.ox0 + frag_pixel(lane, q >> 1, q & 1);
      ok[q] = oy < a.H && ox < a.W;
      pix[q] = ((long long)cur.n * a.H + oy) * a.W + ox;
    }
    float m = 0.f;
#pragma unroll
    for (int n0 = 0; n0 < NTW; n0 += 4) {
      const int c8 = (n_first + n0 + t4) * 8;  // this lane's 8 channels
      uint32_t r1[4][4], r2[4][4], out[4][4];  // [q][nt - n0]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint4 v1 = make_uint4(0u, 0u, 0u, 0u), v2 = v1;
        if (a.r1 && ok[q])
          v1 = *reinterpret_cast<const uint4*>(a.r1 + pix[q] * a.r1s + c8);
        if (a.r2 && ok[q])
          v2 = *reinterpret_cast<const uint4*>(a.r2 + pix[q] * a.r2s + c8);
        r1[q][0] = v1.x; r1[q][1] = v1.y; r1[q][2] = v1.z; r1[q][3] = v1.w;
        r2[q][0] = v2.x; r2[q][1] = v2.y; r2[q][2] = v2.z; r2[q][3] = v2.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // r1[q][j]: channels co, co + 1 of n8 tile n0 + j
        if (a.r1) quad_transpose(r1[q], t4);
        if (a.r2) quad_transpose(r2[q], t4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = n0 + j;
        const int co = frag_channel(lane, n_first + nt);
        const float bb[2] = {s_b[co], s_b[co + 1]};
        const float al[2] = {s_al[co], s_al[co + 1]};
        float sc[2] = {0.f, 0.f};
        if constexpr (!MULTI) {
          sc[0] = __fmul_rn(sa, s_sw[co]);
          sc[1] = __fmul_rn(sa, s_sw[co + 1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mt = q >> 1, hf = q & 1;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float u;
            if constexpr (MULTI)
              u = __fadd_rn(facc[mt][nt][hf * 2 + e], bb[e]);
            else
              u = __fmaf_rn(__int2float_rn(iacc[0][mt][nt][hf * 2 + e]), sc[e], bb[e]);
            iacc[0][mt][nt][hf * 2 + e] = 0;
            if (a.act == 1) {
              u = u >= 0.f ? u : __fmul_rn(0.2f, u);
            } else if (a.act == 2) {
              u = u > 0.f ? u : __fmul_rn(u, al[e]);
            }
            const uint32_t sh = e ? 0 : 16;  // element e of a bf16 pair
            if (a.r1)
              u = __fmaf_rn(a.s1, u, __uint_as_float((r1[q][j] << sh) & 0xffff0000u));
            if (a.r2)
              u = __fmaf_rn(a.s2, __bfloat162float(__float2bfloat16_rn(u)),
                            __uint_as_float((r2[q][j] << sh) & 0xffff0000u));
            v[e] = u;
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
          out[q][j] = bf2_bits(o);
          if (ok[q]) {
            const float2 f = __bfloat1622float2(o);
            m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        quad_transpose(out[q], t4);  // out[q][s]: channels c8 + 2 s, + 1
#ifndef VR_PROBE_NO_STORE  // tools/probe_k4.py: no output stores
        if (ok[q])
          *reinterpret_cast<uint4*>(a.y + pix[q] * a.ys + c8) =
              make_uint4(out[q][0], out[q][1], out[q][2], out[q][3]);
#endif
      }
    }
    if (a.out_amax) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_red[warp] = m;
      __syncthreads();
      if (tid == 0) {
        for (int i = 1; i < TH * WN; ++i) m = fmaxf(m, s_red[i]);
        if (m > 0.f)
          atomicMax(reinterpret_cast<int*>(a.out_amax + cur.n * a.os),
                    __float_as_int(m));
      }
    }
    cur = nxt;
    ++ti;
    k = s = 0;
    seg_end = a.seg[1];
  }
}

template <int NT, bool STATIC, bool MULTI>
cudaError_t launch(const I8Args& a, cudaStream_t stream) {
  constexpr int WN = NT == 8 ? 2 : 1;  // warps a row
  constexpr int TH = NT == 8 ? 8 : 16;  // rows a tile
  using G = Geo<NT, TH, WN>;
  const long long tiles = (long long)a.B * ((a.W + G::TW - 1) / G::TW) *
                          ((a.H + TH - 1) / TH);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  auto kernel = conv3x3_i8_mma_kernel<NT, TH, WN, STATIC, MULTI>;
  const int bytes = G::bytes(a.cin / KC8);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int grid = (int)(tiles < sms ? tiles : sms);  // one block per SM
  kernel<<<grid, G::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const I8Args& a, bool stat, cudaStream_t stream) {
  const bool multi = a.nseg > 1;
  if (stat)
    return multi ? launch<NT, true, true>(a, stream)
                 : launch<NT, true, false>(a, stream);
  return multi ? launch<NT, false, true>(a, stream)
               : launch<NT, false, false>(a, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// vr_conv3x3_i8's arguments and contract, with w the packed (9, cout, cin)
// int8 weight. cudaErrorInvalidValue for a call the route does not take
// (ops/quant.py::conv3x3_i8_route sends those to vr_conv3x3_i8).
int vr_conv3x3_i8_mma(const void* x, const void* amax, const void* w,
                      const void* sw, const void* b, const void* alpha,
                      const void* r1, const void* r2, void* y, void* out_amax,
                      int B, int H, int W, int cin, int cout, long long xs,
                      long long ys, long long r1s, long long r2s, long long as,
                      long long os, int nseg, const int* seg, const float* sa,
                      const float* inv, int act, float s1, float s2,
                      void* stream) {
  if (nseg < 1 || nseg > kMaxSeg || seg[0] != 0 || seg[nseg] != cin)
    return cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i)
    if (seg[i + 1] <= seg[i] || (seg[i + 1] - seg[i]) % KC8)
      return cudaErrorInvalidValue;
  if ((sa == nullptr) != (inv == nullptr) ||
      (sa ? amax != nullptr || out_amax != nullptr : amax == nullptr))
    return cudaErrorInvalidValue;
  if ((cout != 32 && cout != 64) || cin > kMaxCin) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(alpha) ||
      !aligned16(r1) || !aligned16(r2) || !aligned16(y) || xs % 8 || ys % 8 ||
      r1s % 8 || r2s % 8)
    return cudaErrorInvalidValue;
  if ((long long)B * H * W > 0x7fffffffLL) return cudaErrorInvalidValue;
  I8Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.amax = static_cast<const float*>(amax);
  a.w = static_cast<const int8_t*>(w);
  a.sw = static_cast<const float*>(sw);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.alpha = static_cast<const __nv_bfloat16*>(alpha);
  a.r1 = static_cast<const __nv_bfloat16*>(r1);
  a.r2 = static_cast<const __nv_bfloat16*>(r2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.out_amax = static_cast<float*>(out_amax);
  a.B = B; a.H = H; a.W = W; a.cin = cin; a.cout = cout;
  a.xs = xs; a.ys = ys; a.r1s = r1s; a.r2s = r2s; a.as = as; a.os = os;
  a.nseg = nseg;
  for (int i = 0; i <= kMaxSeg; ++i) a.seg[i] = i <= nseg ? seg[i] : cin;
  a.act = act; a.s1 = s1; a.s2 = s2;
  for (int i = 0; i < kMaxSeg; ++i) {
    a.sa[i] = sa && i < nseg ? sa[i] : 0.f;
    a.inv[i] = sa && i < nseg ? inv[i] : 0.f;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch_nt<8>(a, sa != nullptr, st)
                    : launch_nt<4>(a, sa != nullptr, st);
}

}  // extern "C"
