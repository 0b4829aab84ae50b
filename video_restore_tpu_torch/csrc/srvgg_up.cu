// K3: the SRVGGNetCompact upsampler, one pass.
//
//   out = pixel_shuffle(conv3x3_SAME(feat, w) + b, r) + upsample_nearest(x_in, r)
//
// Replaces video_restore_tpu/ops/pallas_srvgg.py srvgg_up_fused_raw (the
// full-frame form, reading the 2D-padded body array) and srvgg_up_fused
// (plain NHWC input, the tiled form). Both compute the function above; they
// differ only in TPU layout (phase-lane weights, 64-lane skip replication,
// edge-zeroed roll taps). Shapes: feat (B, H, W, cin) NHWC, w (3, 3, cin,
// 3 r^2) HWIO, b (3 r^2,), x_in (B, H, W, 3), out (B, rH, rW, 3), all in one
// dtype (fp32 or bf16); r in {2, 4}.
//
// Semantics kept from the Pallas kernels (pallas_srvgg.py:837-842,
// :1005-1010): the conv sum, the bias and the skip add in fp32 and the
// result is rounded once; conv output channel o r^2 + a r + b goes to fine
// pixel (r y + a, r x + b), colour o (torch PixelShuffle order); the skip of
// every phase (a, b) is x_in[y, x, o]; zero SAME padding at every edge of
// the (tile) frame.
//
// What bounds it on the H100: at the config-4 frame (1080x1920, cin 64,
// r 4, bf16) it moves ~477 MB (265 MB of feat read, 199 MB of output
// written) = 0.14 ms at 3.35 TB/s, against 115 GFLOP = 0.12 ms at the bf16
// tensor-core peak, so the bound is bytes. This first design is simple and
// runs the FMAs in fp32 on the CUDA cores, so it is far from that bound:
// one thread per LR pixel with 3 r^2 fp32 accumulators; a block of 32 x 4
// pixels stages its (4+2) x (32+2) input patch and the 9 x 16 x 3r^2 weight
// slice in shared memory as fp32, 16 input channels at a time (every warp
// reads one patch row, so the patch loads are conflict-free and the weight
// loads are broadcasts); the epilogue writes each pixel's r x r x 3 fine
// block, r runs of 3r contiguous values. The tensor-core kernels,
// srvgg_up_mma.cu (bf16) and srvgg_up_bf16x3.cu (fp32), take the zoo's
// widths; this one takes the rest (ops/srvgg.py::srvgg_up_route) and the
// calls forced onto it, the side-by-side yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

struct UpArgs {
  const void* x;     // (B, H, W, cin) contiguous
  const void* w;     // (3, 3, cin, 3 r^2) contiguous
  const void* b;     // (3 r^2,)
  const void* skip;  // (B, H, W, 3) contiguous
  void* y;           // (B, r H, r W, 3) contiguous
  int B, H, W, cin;
};

constexpr int kTW = 32, kTH = 4, kThreads = kTW * kTH;
constexpr int kCI = 16;  // input channels staged per pass
constexpr int kCO = 3;   // output colours
constexpr int kPW = kTW + 2, kPH = kTH + 2;
constexpr int kCS = (kPW * kPH) | 1;  // odd channel pitch of the patch
constexpr int kIN = (kCI * kCS + 3) / 4 * 4;  // keep the weights 16B aligned

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) srvgg_up_kernel(const UpArgs a) {
  constexpr int NACC = kCO * R * R;
  static_assert(NACC % 4 == 0, "weights are read as float4");
  __shared__ __align__(16) float s_in[kIN];            // [CI][PH][PW]
  __shared__ __align__(16) float s_w[9 * kCI * NACC];  // [tap][CI][NACC]

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ox0 = (blockIdx.x % tiles_x) * kTW;
  const int oy0 = (blockIdx.x / tiles_x) * kTH;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kTW, ty = tid / kTW;

  float acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += kCI) {
    const int cn = min(kCI, a.cin - c0);
    __syncthreads();
    // input patch, channel-fastest for contiguous global reads; zero
    // outside the frame is the conv's SAME padding
    for (int i = tid; i < kPH * kPW * kCI; i += kThreads) {
      const int ci = i % kCI;
      const int pix = i / kCI;
      const int gy = oy0 + pix / kPW - 1, gx = ox0 + pix % kPW - 1;
      float v = 0.f;
      if (ci < cn && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
        v = to_f(x[(((long long)n * a.H + gy) * a.W + gx) * a.cin + c0 + ci]);
      s_in[ci * kCS + pix] = v;
    }
    for (int i = tid; i < 9 * kCI * NACC; i += kThreads) {
      const int co = i % NACC;
      const int ci = (i / NACC) % kCI;
      const int tap = i / (NACC * kCI);
      float v = 0.f;
      if (ci < cn) v = to_f(w[((long long)tap * a.cin + c0 + ci) * NACC + co]);
      s_w[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < cn; ++ci) {
      const float* sin_c = s_in + ci * kCS + ty * kPW + tx;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv = sin_c[(tap / 3) * kPW + tap % 3];
        const float4* wp =
            reinterpret_cast<const float4*>(s_w + (tap * kCI + ci) * NACC);
#pragma unroll
        for (int q = 0; q < NACC / 4; ++q) {
          const float4 wv = wp[q];
          acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= a.H || ox >= a.W) return;
  const T* __restrict__ bias = static_cast<const T*>(a.b);
  const T* __restrict__ skip = static_cast<const T*>(a.skip);
  T* __restrict__ y = static_cast<T*>(a.y);
  const long long pix = ((long long)n * a.H + oy) * a.W + ox;
  float s[kCO];
#pragma unroll
  for (int o = 0; o < kCO; ++o) s[o] = to_f(skip[pix * kCO + o]);
  const long long fw = (long long)R * a.W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // fine row R*oy + r, columns R*ox .. R*ox + R - 1: 3R contiguous values
    T* row = y + (((long long)n * R * a.H + (long long)R * oy + r) * fw +
                  (long long)R * ox) * kCO;
#pragma unroll
    for (int c = 0; c < R; ++c)
#pragma unroll
      for (int o = 0; o < kCO; ++o) {
        const int q = o * R * R + r * R + c;
        const float v = __fadd_rn(__fadd_rn(acc[q], to_f(bias[q])), s[o]);
        row[c * kCO + o] = from_f<T>(v);
      }
  }
}

template <typename T, int R>
cudaError_t launch(const UpArgs& a, cudaStream_t stream) {
  const int tiles = ((a.W + kTW - 1) / kTW) * ((a.H + kTH - 1) / kTH);
  const dim3 grid(tiles, 1, a.B);
  srvgg_up_kernel<T, R><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; r: 2 or 4. Returns the cudaError_t of
// the launch.
int vr_srvgg_up(int dtype, int r, const void* x, const void* w, const void* b,
                const void* skip, void* y, int B, int H, int W, int cin,
                void* stream) {
  UpArgs a;
  a.x = x; a.w = w; a.b = b; a.skip = skip; a.y = y;
  a.B = B; a.H = H; a.W = W; a.cin = cin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && r == 2) return launch<float, 2>(a, s);
  if (dtype == 0 && r == 4) return launch<float, 4>(a, s);
  if (dtype == 1 && r == 2) return launch<__nv_bfloat16, 2>(a, s);
  if (dtype == 1 && r == 4) return launch<__nv_bfloat16, 4>(a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
