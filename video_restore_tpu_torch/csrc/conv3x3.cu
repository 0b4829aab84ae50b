// K1: direct SAME 3x3 convolution on NHWC activations, HWIO weights.
//
// Replaces the Pallas stripe convs of video_restore_tpu/ops:
//   pallas_tail.py conv3x3_fused   (stem, conv_body + residual)
//   pallas_tail.py up1_fused       (nearest-2x + conv + lrelu)
//   pallas_tail.py tail_fused_raw / tail_fused (upconv2, conv_hr, conv_last)
//   pallas_stripe.py rdb_stripe2d_split / rdb_stripe2d_padded /
//                    rdb_res_stripe2d_padded (the five dense-block convs)
// The Pallas versions differ mainly in TPU layout (dx N-packing, W-sd lane
// pairs, 128-lane pads, split edge/interior launches); what they compute is
// one SAME 3x3 conv with an epilogue, which is what this kernel does:
//
//   v   = sum_{ky,kx,ci} x[y+ky-1, x+kx-1, ci] * w[ky, kx, ci, co]  (fp32)
//   v   = act(v + b[co])            act in {none, lrelu 0.2, PReLU alpha[co]}
//   v   = r1 + s1 * v               (optional residual)
//   v   = r2 + s2 * T(v)            (optional outer residual; the inner sum
//                                    is rounded to T first, as the Pallas
//                                    RRDB epilogue rounds rdb3's output)
//   out = T(v)
//
// Options: `up2` reads the input through nearest 2x upsampling, with zero
// padding on the 2x grid (exactly conv2d(upsample_nearest(x, 2))); every
// activation operand is a channel-prefix view of an NHWC buffer with its own
// pixel stride, so the dense block's concat never exists (conv k reads the
// prefix [0, 64 + 32(k-1)) of one growth buffer and writes its 32 channels
// at their offset in the same buffer).
//
// K1 has five routes behind one wrapper (ops/tail.py::conv3x3_route). This
// kernel, the "fma" route, takes what the tensor-core routes
// (conv3x3_wgmma.cu, conv3x3_bf16x3_wgmma.cu, conv3x3_mma.cu) and the narrow
// route (conv3x3_narrow.cu: the stems, cin 3 or 12 -> 64, and conv_last, 64
// -> 3, each in bf16 and fp32) do not: the narrow test widths, cout 48, and
// operands the other kernels cannot load; and any call forced onto it. The narrow route sums in this kernel's order, so a
// call forced onto this kernel gives the narrow kernels' outputs bit for
// bit.
//
// What bounds it on the H100: a wide conv does 9*cin FMAs per output value,
// far above the card's bytes-to-operations balance, so it is compute bound
// on the CUDA cores' fp32 rate (67 TFLOP/s peak): a block stages a (TH+2) x
// (TW+2) x CI input patch and the 9 x CI x CO_T weight slice in shared
// memory as fp32, and each thread keeps an 8-pixel x 8-channel register
// tile, reusing each loaded input row segment across the three kx taps (192
// FMAs per 16 shared-memory loads). The one-launch RDB is K5 (rdb_fused.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct ConvArgs {
  const void* x;      // (B, H, W, >=cin) with pixel stride xs
  const void* w;      // (3, 3, cin, cout) contiguous
  const void* b;      // (cout,)
  const void* alpha;  // (cout,) for PReLU, else null
  const void* r1;     // (B, OH, OW, >=cout) pixel stride r1s, or null
  const void* r2;     // (B, OH, OW, >=cout) pixel stride r2s, or null
  void* y;            // (B, OH, OW, >=cout) pixel stride ys
  int B, H, W, OH, OW;
  int cin, cout;
  long long xs, ys, r1s, r2s;
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  int up2;
  float s1, s2;
};

constexpr int kThreads = 128;

// COG: groups of 8 output channels per block; each thread owns 8 pixels of
// one output row and 8 output channels.
template <int COG>
struct Tile;
template <>
struct Tile<4> {  // cout >= 32: 16x16 pixels x 32 channels, CI = 16
  static constexpr int TW = 16, TH = 16, CI = 16;
};
template <>
struct Tile<1> {  // cout <= 8 (conv_last): 32x32 pixels x 8 channels, CI = 8
  static constexpr int TW = 32, TH = 32, CI = 8;
};

template <int COG>
struct Smem {
  static constexpr int TW = Tile<COG>::TW, TH = Tile<COG>::TH;
  static constexpr int CI = Tile<COG>::CI, CO = 8 * COG;
  static constexpr int PW = TW + 2, PH = TH + 2;
  // odd channel pitch: the transposed patch stores hit distinct banks
  static constexpr int CS = (PH * PW) | 1;
  static constexpr int IN = (CI * CS + 3) / 4 * 4;  // keep s_w 16B aligned
  static constexpr int WT = 9 * CI * CO;
  static constexpr int BYTES = (IN + WT) * 4;
};

template <typename T, int COG>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const ConvArgs a) {
  using S = Smem<COG>;
  constexpr int TW = S::TW, TH = S::TH, CI = S::CI, CO = S::CO;
  constexpr int PW = S::PW, PH = S::PH, CS = S::CS;
  constexpr int GPR = TW / 8;  // pixel groups per tile row
  static_assert((kThreads / COG) == GPR * TH, "tile does not match threads");

  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);  // [CI][PH][PW], pitch CS
  float* s_w = s_in + S::IN;                      // [9][CI][CO]

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);

  const int tiles_x = (a.OW + TW - 1) / TW;
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int co_base = blockIdx.y * CO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % COG;
  const int pg = tid / COG;
  const int prow = pg / GPR;
  const int pcol = (pg % GPR) * 8;
  const int oy0 = ty * TH, ox0 = tx * TW;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += CI) {
    const int cn = min(CI, a.cin - c0);
    __syncthreads();
    // input patch, channel-fastest for coalesced global reads; zero outside
    // the (output-grid) frame gives SAME padding, also on the 2x grid
    for (int i = tid; i < PH * PW * CI; i += kThreads) {
      const int ci = i % CI;
      const int pix = i / CI;
      const int py = pix / PW, px = pix % PW;
      const int oy = oy0 + py - 1, ox = ox0 + px - 1;
      float v = 0.f;
      if (ci < cn && oy >= 0 && oy < a.OH && ox >= 0 && ox < a.OW) {
        const int iy = a.up2 ? (oy >> 1) : oy;
        const int ix = a.up2 ? (ox >> 1) : ox;
        const long long off =
            ((long long)n * a.H + iy) * a.W + ix;
        v = to_f(x[off * a.xs + c0 + ci]);
      }
      s_in[ci * CS + pix] = v;
    }
    for (int i = tid; i < 9 * CI * CO; i += kThreads) {
      const int co = i % CO;
      const int ci = (i / CO) % CI;
      const int tap = i / (CO * CI);
      const int gco = co_base + co;
      float v = 0.f;
      if (ci < cn && gco < a.cout)
        v = to_f(w[((long long)tap * a.cin + c0 + ci) * a.cout + gco]);
      s_w[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < cn; ++ci) {
      const float* sin_c = s_in + ci * CS;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* row = sin_c + (prow + ky) * PW + pcol;
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = row[j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + ((ky * 3 + kx) * CI + ci) * CO + cg * 8);
          const float4 w0 = wp[0], w1 = wp[1];
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[p][q] = fmaf(xin[p + kx], wv[q], acc[p][q]);
        }
      }
    }
  }

  // epilogue
  const T* __restrict__ bias = static_cast<const T*>(a.b);
  const T* __restrict__ alpha = static_cast<const T*>(a.alpha);
  const T* __restrict__ r1 = static_cast<const T*>(a.r1);
  const T* __restrict__ r2 = static_cast<const T*>(a.r2);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int oy = oy0 + prow;
  if (oy >= a.OH) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ox = ox0 + pcol + p;
    if (ox >= a.OW) continue;
    const long long pix = ((long long)n * a.OH + oy) * a.OW + ox;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int co = co_base + cg * 8 + q;
      if (co >= a.cout) continue;
      float v = __fadd_rn(acc[p][q], to_f(bias[co]));
      if (a.act == 1) {
        v = v >= 0.f ? v : __fmul_rn(0.2f, v);
      } else if (a.act == 2) {
        v = v > 0.f ? v : __fmul_rn(v, to_f(alpha[co]));
      }
      if (r1) v = __fadd_rn(to_f(r1[pix * a.r1s + co]), __fmul_rn(a.s1, v));
      if (r2)
        v = __fadd_rn(to_f(r2[pix * a.r2s + co]),
                      __fmul_rn(a.s2, to_f(from_f<T>(v))));
      y[pix * a.ys + co] = from_f<T>(v);
    }
  }
}

template <typename T, int COG>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  using S = Smem<COG>;
  const int tiles = ((a.OW + S::TW - 1) / S::TW) * ((a.OH + S::TH - 1) / S::TH);
  const dim3 grid(tiles, (a.cout + S::CO - 1) / S::CO, a.B);
  if (S::BYTES > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_kernel<T, COG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::BYTES);
    if (e != cudaSuccess) return e;
  }
  conv3x3_kernel<T, COG><<<grid, kThreads, S::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int vr_conv3x3(int dtype, const void* x, const void* w, const void* b,
               const void* alpha, const void* r1, const void* r2, void* y,
               int B, int H, int W, int cin, int cout, long long xs,
               long long ys, long long r1s, long long r2s, int act, int up2,
               float s1, float s2, void* stream) {
  ConvArgs a;
  a.x = x; a.w = w; a.b = b; a.alpha = alpha; a.r1 = r1; a.r2 = r2; a.y = y;
  a.B = B; a.H = H; a.W = W;
  a.OH = up2 ? 2 * H : H;
  a.OW = up2 ? 2 * W : W;
  a.cin = cin; a.cout = cout;
  a.xs = xs; a.ys = ys; a.r1s = r1s; a.r2s = r2s;
  a.act = act; a.up2 = up2; a.s1 = s1; a.s2 = s2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = cout <= 8;
  if (dtype == 0)
    return narrow ? launch<float, 1>(a, s) : launch<float, 4>(a, s);
  if (dtype == 1)
    return narrow ? launch<__nv_bfloat16, 1>(a, s)
                  : launch<__nv_bfloat16, 4>(a, s);
  return cudaErrorInvalidValue;
}

const char* vr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
