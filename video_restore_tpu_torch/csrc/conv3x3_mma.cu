// K1, tensor-core route: SAME 3x3 convolution on NHWC bf16 activations, HWIO
// bf16 weights, as an implicit GEMM on mma.sync (mma_tile.cuh).
//
// It computes exactly the function of conv3x3.cu (see the note there: bias,
// act in {none, lrelu 0.2, PReLU}, r1 + s1 * v, r2 + s2 * T(v), `up2` input
// read through nearest 2x with zero padding on the 2x grid, every activation
// operand a channel-prefix view with its own pixel stride), for the calls
// whose widths feed the tensor cores: bf16, cin a multiple of 16, cout 32 or
// 64, 16-byte-aligned operands. It serves the same Pallas entry points of
// video_restore_tpu/ops:
//   pallas_stripe.py rdb_stripe2d_split / rdb_stripe2d_padded /
//                    rdb_res_stripe2d_padded / rdb_stripe_padded /
//                    rdb_res_stripe_padded (the five dense-block convs)
//   pallas_tail.py   conv3x3_fused (conv_body + residual), up1_fused,
//                    tail_fused_raw / tail_fused (upconv2, conv_hr)
//   pallas_srvgg.py  srvgg_stripe2d_split / srvgg_stripe2d_padded /
//                    srvgg_stripe_padded (the chained conv + PReLU body)
// The stems (cin 3 or 12), conv_last (cout 3), fp32 and narrow test widths
// stay on conv3x3.cu; ops/tail.py::conv3x3_route picks the kernel.
//
// What bounds it on the H100: 9 * cin multiply-adds per output value put
// every one of these convs far above the card's 295 operations per byte, so
// device memory is not the limit; the tensor cores would be, and below them
// two feeds that this design runs close to: the 128 bytes a clock that an
// SM's shared memory gives `ldmatrix` (6 `ldmatrix.x4` = 3 KB per 16 MMAs of
// a warp at cout 64, 4 per 8 at cout 32: about two thirds of the tensor
// cores' peak at best) and the L2-to-SM traffic of the stages (every block
// re-reads its conv's weights, 18 of a stage's 29 KB at cout 64). What the
// design does about it:
//  - one block computes all cout of an 8 x 32 pixel tile, so the input
//    prefix is read from device memory once per conv and each A fragment
//    meets every output channel; a warp owns one row of 32 pixels, 64 fp32
//    accumulators a thread at cout 64, two blocks of 256 threads per SM, so
//    one block's epilogue and pipeline fill hide behind the other's MMAs;
//  - patch and weights stay bf16 in shared memory, padded so that every
//    `ldmatrix` is bank-conflict free (mma_tile.cuh);
//  - `cp.async` (16 bytes: 8 channels of a pixel, 8 couts of a weight row)
//    fills a ring of three stages of 16 input channels, one commit group
//    and one __syncthreads per stage, the next stage started before the MMAs
//    of the current one; a pixel outside the output-grid frame is zero-filled
//    by the copy itself (SAME padding at every edge, also on the 2x grid);
//  - each thread works out the source pixel of its few patch chunks once,
//    before the channel loop; a stage adds only the channel offset.
// Tried on the card and not kept (each gave the same values and no gain): a
// persistent grid whose loads run ahead across tiles; that grid with 512
// threads, 16 x 32 pixel tiles and the conv's weights resident in shared
// memory (a third of the L2 traffic, 5-9% slower: one block per SM leaves
// its epilogue uncovered); two or four stages; two rows per warp at cout 32.
// A larger accumulator tile per warp is what would cut the shared-memory
// reads per MMA, and that is `wgmma` (+ TMA for the loads), the step after
// this one.
//
// Sums are fp32 in the tensor cores, in another order than conv3x3.cu's
// FMAs, so the two routes agree within a bf16 step of the output, not bit
// for bit. The epilogue repeats conv3x3.cu's arithmetic and rounding points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

struct ConvArgs {
  const __nv_bfloat16* x;      // (B, H, W, >=cin) with pixel stride xs
  const __nv_bfloat16* w;      // (3, 3, cin, cout) contiguous
  const __nv_bfloat16* b;      // (cout,)
  const __nv_bfloat16* alpha;  // (cout,) for PReLU, else null
  const __nv_bfloat16* r1;     // (B, OH, OW, >=cout) pixel stride r1s, or null
  const __nv_bfloat16* r2;     // (B, OH, OW, >=cout) pixel stride r2s, or null
  __nv_bfloat16* y;            // (B, OH, OW, >=cout) pixel stride ys
  int B, H, W, OH, OW;
  int cin;
  long long xs, ys, r1s, r2s;
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  int up2;
  float s1, s2;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RW = 1;      // pixel rows per warp
constexpr int STAGES = 3;  // depth of the cp.async ring

// NT: cout / 8.
template <int NT>
struct Geo {
  static constexpr int TH = kWarps * RW, TW = ROW_PIX;
  static constexpr int PH = TH + 2, PW = TW + 2;
  static constexpr int PATCH_BYTES = PH * PW * PIX_PITCH;
  static constexpr int PATCH_CHUNKS = PH * PW * 2;  // 16-byte copies
  static constexpr int PATCH_ITEMS = (PATCH_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int STAGE_BYTES = PATCH_BYTES + Weights<NT>::BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
  static_assert(PATCH_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "alignment");
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_mma_kernel(const ConvArgs a) {
  using G = Geo<NT>;
  constexpr int PW = G::PW;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (a.OW + G::TW - 1) / G::TW;
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int n = blockIdx.z;
  const int oy0 = ty * G::TH, ox0 = tx * G::TW;

  // where this thread's patch chunks come from: the source pixel's linear
  // index, or -1 outside the output-grid frame (zero fill = SAME padding)
  int src_pix[G::PATCH_ITEMS];
#pragma unroll
  for (int it = 0; it < G::PATCH_ITEMS; ++it) {
    const int pix = (tid + it * kThreads) >> 1;
    const int py = pix / PW, px = pix - py * PW;
    const int oy = oy0 + py - 1, ox = ox0 + px - 1;
    int s = -1;
    if (pix < G::PH * PW && oy >= 0 && oy < a.OH && ox >= 0 && ox < a.OW) {
      const int iy = a.up2 ? (oy >> 1) : oy;
      const int ix = a.up2 ? (ox >> 1) : ox;
      s = (n * a.H + iy) * a.W + ix;
    }
    src_pix[it] = s;
  }

  auto load_stage = [&](int stage, int c0) {
    const uint32_t s_patch = s_base + stage * G::STAGE_BYTES;
#pragma unroll
    for (int it = 0; it < G::PATCH_ITEMS; ++it) {
      const int i = tid + it * kThreads;
      if (i < G::PATCH_CHUNKS) {
        const int s = src_pix[it];
        const int half = i & 1;
        const __nv_bfloat16* src =
            s >= 0 ? a.x + ((long long)s * a.xs + c0 + half * 8) : a.x;
        cp_async16(s_patch + (i >> 1) * PIX_PITCH + half * 16, src, s >= 0);
      }
    }
    load_weights<NT, kThreads>(s_patch + G::PATCH_BYTES, a.w, a.cin, c0, tid);
  };

  float acc[RW][2][NT][4];
#pragma unroll
  for (int rw = 0; rw < RW; ++rw)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rw][mt][nt][e] = 0.f;

  const uint32_t a_lane = s_base + a_lane_offset<PW>(warp * RW, lane);
  const uint32_t b_lane = s_base + G::PATCH_BYTES + b_lane_offset<NT>(lane);

  const int nk = a.cin / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * KC);
    cp_async_commit();
  }
  int stage = 0, next = STAGES - 1;
  for (int k = 0; k < nk; ++k) {
    // stage k has landed for this thread; the barrier makes it so for all,
    // and says that everyone is done with the stage about to be refilled
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + STAGES - 1 < nk) load_stage(next, (k + STAGES - 1) * KC);
    cp_async_commit();
#ifndef VR_PROBE_NO_MMA  // tools/probe_k1.py: the load pipeline alone
    mma_taps<NT, RW, PW>(acc, a_lane + stage * G::STAGE_BYTES,
                         b_lane + stage * G::STAGE_BYTES);
#endif
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    next = next + 1 == STAGES ? 0 : next + 1;
  }

  // epilogue: conv3x3.cu's arithmetic, two neighbouring channels at a time
  long long pix[RW * 4];
  bool ok[RW * 4];
#pragma unroll
  for (int rw = 0; rw < RW; ++rw)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int oy = oy0 + warp * RW + rw;
      const int ox = ox0 + frag_pixel(lane, q >> 1, q & 1);
      ok[rw * 4 + q] = oy < a.OH && ox < a.OW;
      pix[rw * 4 + q] = ((long long)n * a.OH + oy) * a.OW + ox;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = frag_channel(lane, nt);
    const float2 bias = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(a.b + co));
    float2 al = make_float2(0.f, 0.f);
    if (a.act == 2)
      al = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.alpha + co));
#pragma unroll
    for (int rw = 0; rw < RW; ++rw)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!ok[rw * 4 + q]) continue;
        const long long p = pix[rw * 4 + q];
        float v[2] = {acc[rw][q >> 1][nt][(q & 1) * 2],
                      acc[rw][q >> 1][nt][(q & 1) * 2 + 1]};
        const float bb[2] = {bias.x, bias.y}, aa[2] = {al.x, al.y};
        float rr1[2] = {0.f, 0.f}, rr2[2] = {0.f, 0.f};
        if (a.r1) {
          const float2 t = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.r1 + p * a.r1s + co));
          rr1[0] = t.x; rr1[1] = t.y;
        }
        if (a.r2) {
          const float2 t = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.r2 + p * a.r2s + co));
          rr2[0] = t.x; rr2[1] = t.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float u = __fadd_rn(v[e], bb[e]);
          if (a.act == 1) {
            u = u >= 0.f ? u : __fmul_rn(0.2f, u);
          } else if (a.act == 2) {
            u = u > 0.f ? u : __fmul_rn(u, aa[e]);
          }
          if (a.r1) u = __fadd_rn(rr1[e], __fmul_rn(a.s1, u));
          if (a.r2)
            u = __fadd_rn(rr2[e],
                          __fmul_rn(a.s2, __bfloat162float(
                                              __float2bfloat16_rn(u))));
          v[e] = u;
        }
#ifdef VR_PROBE_NO_STORE  // tools/probe_k1.py: everything but the stores
        if (v[0] != 123456.75f) continue;
#endif
        *reinterpret_cast<__nv_bfloat162*>(a.y + p * a.ys + co) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
  }
}

template <int NT>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  using G = Geo<NT>;
  const long long tiles = (long long)((a.OW + G::TW - 1) / G::TW) *
                          ((a.OH + G::TH - 1) / G::TH);
  if (tiles > 0x7fffffffLL || a.B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, a.B);
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_mma_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e != cudaSuccess) return e;
  // two blocks of this size fit an SM only with the largest shared-memory
  // share of the L1
  e = cudaFuncSetAttribute(conv3x3_mma_kernel<NT>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  conv3x3_mma_kernel<NT><<<grid, kThreads, G::BYTES, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// bf16 only. Returns the cudaError_t of the launch; cudaErrorInvalidValue for
// a call the route does not take (ops/tail.py::conv3x3_route sends those to
// vr_conv3x3).
int vr_conv3x3_mma(const void* x, const void* w, const void* b,
                   const void* alpha, const void* r1, const void* r2, void* y,
                   int B, int H, int W, int cin, int cout, long long xs,
                   long long ys, long long r1s, long long r2s, int act,
                   int up2, float s1, float s2, void* stream) {
  if (cin <= 0 || cin % KC != 0 || (cout != 32 && cout != 64))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(alpha) ||
      !aligned16(r1) || !aligned16(r2) || !aligned16(y) || xs % 8 || ys % 8 ||
      r1s % 8 || r2s % 8)
    return cudaErrorInvalidValue;
  if ((long long)B * H * W > 0x7fffffffLL) return cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.alpha = static_cast<const __nv_bfloat16*>(alpha);
  a.r1 = static_cast<const __nv_bfloat16*>(r1);
  a.r2 = static_cast<const __nv_bfloat16*>(r2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B; a.H = H; a.W = W;
  a.OH = up2 ? 2 * H : H;
  a.OW = up2 ? 2 * W : W;
  a.cin = cin;
  a.xs = xs; a.ys = ys; a.r1s = r1s; a.r2s = r2s;
  a.act = act; a.up2 = up2; a.s1 = s1; a.s2 = s2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch<8>(a, s) : launch<4>(a, s);
}

}  // extern "C"
