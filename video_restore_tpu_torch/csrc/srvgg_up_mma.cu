// K3, tensor-core route: the SRVGGNetCompact upsampler in one pass, bf16,
// on the tile routines of mma_tile.cuh.
//
//   out = pixel_shuffle(conv3x3_SAME(feat, w) + b, r) + upsample_nearest(x_in, r)
//
// It computes exactly the function of srvgg_up.cu (see the note there: fp32
// conv sums, bias and skip, one rounding; conv output channel o r^2 + a r +
// b goes to fine pixel (r y + a, r x + b), colour o; zero SAME padding at
// every edge) and serves the same Pallas entry points,
// video_restore_tpu/ops/pallas_srvgg.py srvgg_up_fused_raw (full frame) and
// srvgg_up_fused (tiles), for the calls whose widths feed the tensor cores
// (ops/srvgg.py::srvgg_up_route): bf16, cin a multiple of 16 up to 64, r 2
// or 4. fp32 at those widths takes srvgg_up_bf16x3.cu (Hopper `wgmma` on
// three bf16 parts a value).
//
// What bounds it on the H100: at the config-4 frame (1080x1920, cin 64, r 4)
// it moves ~477 MB (265 MB of feat read, 199 MB of output written) = 0.14 ms
// at 3.35 TB/s against 115 GFLOP = 0.12 ms at the bf16 peak: bytes, with
// the operations close behind. What the design does:
//  - an implicit GEMM of pixels x 16 input channels by 16 x cout on
//    mma.sync, as K1's tensor-core route: a block of 8 warps owns 8 rows of
//    32 LR pixels, a warp one row (two m16 tiles) by every output channel:
//    cout 48 (r 4) = six n8 tiles, cout 12 (r 2) padded to 16 with zero
//    weight columns that the host prepares once (ops/srvgg.py
//    srvgg_up_weights);
//  - the whole (8 + 2) x (32 + 2) patch and the 9 x cin x cout weights sit
//    in shared memory, pixel-major and padded 16 bytes per pixel and per
//    weight row so that every `ldmatrix` is conflict free, 113,472 bytes at
//    cin 64 and r 4: two blocks per SM, so one block's epilogue and loads
//    hide behind the other's MMAs. The copies form a 4-stage `cp.async`
//    ring over cin 64 (16 input channels of patch and weights per commit
//    group); the MMAs of stage s start as soon as it lands;
//  - the epilogue adds the bias and the nearest skip to each fragment and
//    puts the r x r x 3 fine block of each LR pixel in place in a staging
//    copy of the warp's r fine rows in shared memory (over the patch and
//    weights, which the MMAs no longer need), which the warp then
//    writes as contiguous 16-byte stores (768 bytes per fine row of a
//    32-pixel strip at r 4, 384 at r 2; 4-byte stores where a fine row does
//    not start on 16 bytes).
// Sums are fp32 in the tensor cores, in another order than srvgg_up.cu's
// FMAs: the two agree within a bf16 step of the output, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TH = kWarps, TW = ROW_PIX;  // 8 rows of 32 LR pixels
constexpr int PH = TH + 2, PW = TW + 2;
constexpr int CO = 3;                     // output colours

struct UpArgs {
  const bf16* x;     // (B, H, W, cin) contiguous
  const bf16* w;     // (3, 3, cin, NT * 8) contiguous (cout padded)
  const bf16* b;     // (3 r^2,)
  const bf16* skip;  // (B, H, W, 3) contiguous
  bf16* y;           // (B, r H, r W, 3) contiguous
  int B, H, W;
};

template <int R, int NK>
struct Geo {
  static constexpr int CIN = NK * KC;
  static constexpr int COUT = CO * R * R;             // 12, 48
  static constexpr int NT = (COUT + 15) / 16 * 2;     // n8 tiles: 2, 6
  static constexpr int XP = CIN * 2 + 16;             // patch pixel pitch
  static constexpr int WP = Weights<NT>::PITCH;       // weight row pitch
  static constexpr int PATCH_BYTES = PH * PW * XP;
  static constexpr int BYTES = PATCH_BYTES + 9 * CIN * WP;
  static constexpr int PATCH_ITEMS = (PH * PW * 2 + kThreads - 1) / kThreads;
  static constexpr int FINE = TW * R * CO;            // values per fine row
  static_assert(PATCH_BYTES % 16 == 0, "alignment");
  static_assert(kWarps * R * FINE * 2 <= BYTES, "the staging fits");
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks per SM");
};

// cp.async.wait_group with a count known only after unrolling
__device__ __forceinline__ void wait_pending(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

template <int R, int NK>
__global__ void __launch_bounds__(kThreads, 2)
    srvgg_up_mma_kernel(const UpArgs a) {
  using G = Geo<R, NK>;
  constexpr int NT = G::NT, XP = G::XP, WP = G::WP;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_w = s_base + G::PATCH_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (a.W + TW - 1) / TW;
  const int ox0 = (blockIdx.x % tiles_x) * TW;
  const int oy0 = (blockIdx.x / tiles_x) * TH;
  const int n = blockIdx.z;

  // where this thread's patch chunks (8 channels of a pixel) come from: the
  // source pixel, or -1 outside the frame (zero fill = SAME padding)
  int src_pix[G::PATCH_ITEMS];
#pragma unroll
  for (int it = 0; it < G::PATCH_ITEMS; ++it) {
    const int pix = (tid + it * kThreads) >> 1;
    const int py = pix / PW, px = pix - py * PW;
    const int gy = oy0 + py - 1, gx = ox0 + px - 1;
    src_pix[it] = pix < PH * PW && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W
                      ? (n * a.H + gy) * a.W + gx
                      : -1;
  }
  // every stage at once: channels [16 s, 16 s + 16) of the patch and weight
  // rows [16 s, 16 s + 16) of each tap, one commit group each
#pragma unroll
  for (int s = 0; s < NK; ++s) {
#pragma unroll
    for (int it = 0; it < G::PATCH_ITEMS; ++it) {
      const int i = tid + it * kThreads;
      if (i < PH * PW * 2) {
        const int sp = src_pix[it], half = i & 1;
        const bf16* src =
            sp >= 0 ? a.x + ((long long)sp * G::CIN + s * KC + half * 8) : a.x;
        cp_async16(s_base + (i >> 1) * XP + s * 32 + half * 16, src, sp >= 0);
      }
    }
    for (int i = tid; i < 9 * KC * NT; i += kThreads) {
      const int chunk = i % NT, row = i / NT;
      const int wrow = (row >> 4) * G::CIN + s * KC + (row & 15);  // tap, ci
      cp_async16(s_w + wrow * WP + chunk * 16,
                 a.w + ((long long)wrow * (NT * 8) + chunk * 8), true);
    }
    cp_async_commit();
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int lm = lane >> 3, lr = lane & 7;
  const uint32_t a_lane =
      s_base + (warp * PW + lr + (lm & 1) * 8) * XP + (lm >> 1) * 16;
  const uint32_t b_lane = s_w + b_lane_offset<NT>(lane);
#pragma unroll
  for (int s = 0; s < NK; ++s) {
    wait_pending(NK - 1 - s);
    __syncthreads();
#ifndef VR_PROBE_NO_MMA  // a load-pipeline probe build
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(af[mt], a_lane + s * 32 + (ky * PW + mt * 16 + kx) * XP);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, b_lane + ((ky * 3 + kx) * G::CIN + s * KC) * WP + np * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16816(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_16816(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
#endif
  }

  // epilogue: fine rows of the warp's strip, staged over patch and weights
  __syncthreads();  // every warp is done with both
  bf16* stage = reinterpret_cast<bf16*>(smem) + warp * R * G::FINE;
  const int oy = oy0 + warp;
  const bool row_in = oy < a.H;
  float2 bias[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int q = frag_channel(lane, nt);
    bias[nt] = q < G::COUT ? __bfloat1622float2(
                                 *reinterpret_cast<const __nv_bfloat162*>(a.b + q))
                           : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = frag_pixel(lane, mt, half);
      if (!row_in || ox0 + px >= a.W) continue;
      const bf16* sk = a.skip + (((long long)n * a.H + oy) * a.W + ox0 + px) * CO;
      const float skv[CO] = {__bfloat162float(sk[0]), __bfloat162float(sk[1]),
                             __bfloat162float(sk[2])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = frag_channel(lane, nt) + e;
          if (q >= G::COUT) continue;
          const int o = q / (R * R), fa = (q / R) % R, fb = q % R;
          const float bq = e ? bias[nt].y : bias[nt].x;
          const float v =
              __fadd_rn(__fadd_rn(acc[mt][nt][half * 2 + e], bq), skv[o]);
          stage[fa * G::FINE + (px * R + fb) * CO + o] = __float2bfloat16_rn(v);
        }
    }
  __syncwarp();
  if (!row_in) return;
  const int bytes = min(TW, a.W - ox0) * R * CO * 2;  // a multiple of 4
#pragma unroll
  for (int fa = 0; fa < R; ++fa) {
    char* dst = reinterpret_cast<char*>(
        a.y + (((long long)n * R * a.H + (long long)R * oy + fa) * R * a.W +
               (long long)R * ox0) * CO);
    const char* src = reinterpret_cast<const char*>(stage + fa * G::FINE);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      done = bytes & ~15;
      for (int i = lane * 16; i < done; i += 32 * 16)
        *reinterpret_cast<uint4*>(dst + i) =
            *reinterpret_cast<const uint4*>(src + i);
    }
    for (int i = done + lane * 4; i < bytes; i += 32 * 4)
      *reinterpret_cast<uint32_t*>(dst + i) =
          *reinterpret_cast<const uint32_t*>(src + i);
  }
}

template <int R, int NK>
cudaError_t launch(const UpArgs& a, cudaStream_t stream) {
  using G = Geo<R, NK>;
  const long long tiles =
      (long long)((a.W + TW - 1) / TW) * ((a.H + TH - 1) / TH);
  if (tiles > 0x7fffffffLL || a.B > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      srvgg_up_mma_kernel<R, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(srvgg_up_mma_kernel<R, NK>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  srvgg_up_mma_kernel<R, NK>
      <<<dim3((unsigned)tiles, 1, a.B), kThreads, G::BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_cin(const UpArgs& a, int cin, cudaStream_t s) {
  switch (cin) {
    case 16: return launch<R, 1>(a, s);
    case 32: return launch<R, 2>(a, s);
    case 48: return launch<R, 3>(a, s);
    case 64: return launch<R, 4>(a, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

extern "C" {

// bf16 only; r 2 or 4; cin 16, 32, 48 or 64; w: (3, 3, cin, 16) at r 2 (the
// 12 conv channels, then 4 zero columns), (3, 3, cin, 48) at r 4. Returns
// the cudaError_t of the launch; cudaErrorInvalidValue for a call the route
// does not take (ops/srvgg.py::srvgg_up_route sends those to vr_srvgg_up).
int vr_srvgg_up_mma(int r, const void* x, const void* w, const void* b,
                    const void* skip, void* y, int B, int H, int W, int cin,
                    void* stream) {
  if (!aligned(x, 16) || !aligned(w, 16) || !aligned(b, 4) || !aligned(skip, 2) ||
      !aligned(y, 16))
    return cudaErrorInvalidValue;
  if ((long long)B * H * W > 0x7fffffffLL) return cudaErrorInvalidValue;
  UpArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.skip = static_cast<const bf16*>(skip);
  a.y = static_cast<bf16*>(y);
  a.B = B; a.H = H; a.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r == 2) return launch_cin<2>(a, cin, s);
  if (r == 4) return launch_cin<4>(a, cin, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
