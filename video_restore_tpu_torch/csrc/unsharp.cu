// K2: single-pass unsharp mask on (B, H, W, C) float32 or bfloat16 frames.
//
// Replaces video_restore_tpu/ops/pallas_post.py unsharp_fused:
//
//   xf   = float(x)
//   blur = gauss_w(gauss_h(xf))      separable taps, edge-replicate padding
//   hp   = xf - blur;  hp = |hp| >= threshold ? hp : 0   (threshold > 0)
//   out  = T(clip(xf + amount * hp, 0, 1))
//
// in the same operation order as the plain version (ops/unsharp.py
// unsharp_fused_plain): vertical pass first, each pass summing rounded
// products tap by tap; __fmul_rn/__fadd_rn keep the compiler from fusing
// them. fp32 inside for either element type T, one rounding on the store.
//
// What bounds it on the H100: 2 * (2r + 1) + 4 operations per value against
// 8 bytes moved (one read, one write), far below the card's balance, so it
// is memory bound: at the 7680x4320x3 flagship frame, 0.8 GB per call in
// fp32 (0.4 GB in bf16). The
// design reads each input value from device memory once: a block stages its
// (TH + 2r) x (TW + 2r) x C window (rows and columns clamped to the frame,
// which is exactly edge-replicate padding) in shared memory, runs the
// vertical pass into a second shared buffer, and writes each output once.
// Unlike the Pallas kernel it needs no row alignment, so every height works.
//
// Route "tile" of K2 (ops/unsharp.py::unsharp_route): it takes any C; the
// paths' RGB frames take unsharp_rows.cu, which equals it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kTW = 32, kTH = 16, kThreads = 256;

struct Taps {
  float k[2 * kMaxRadius + 1];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    unsharp_kernel(const T* __restrict__ x, T* __restrict__ y, int H,
                   int W, int C_arg, int r_arg, const Taps taps, float amount,
                   float threshold) {
#ifdef VR_PROBE_CONST_DECODE
  // tools/probe_k2.py: C and r compiled in (its frames' 3 and 4), so the
  // index decode divides by constants
  constexpr int C = 3, r = 4;
#else
  const int C = C_arg, r = r_arg;
#endif
  extern __shared__ float smem[];
  const int PW = kTW + 2 * r, PH = kTH + 2 * r;
  float* s_in = smem;              // [PH][PW][C]
  float* s_v = smem + PH * PW * C;  // [kTH][PW][C]

  const int tiles_x = (W + kTW - 1) / kTW;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const long long base = (long long)blockIdx.y * H * W * C;
  const int tid = threadIdx.x;

  for (int i = tid; i < PH * PW * C; i += kThreads) {
    const int c = i % C;
    const int px = (i / C) % PW;
    const int py = i / (C * PW);
    const int gy = min(max(y0 + py - r, 0), H - 1);
    const int gx = min(max(x0 + px - r, 0), W - 1);
    s_in[i] = widen(x[base + ((long long)gy * W + gx) * C + c]);
  }
  __syncthreads();

  const int n = 2 * r + 1;
#ifndef VR_PROBE_NO_MATH  // tools/probe_k2.py: no vertical pass
  for (int i = tid; i < kTH * PW * C; i += kThreads) {
    const int c = i % C;
    const int px = (i / C) % PW;
    const int py = i / (C * PW);
    float v = __fmul_rn(s_in[(py * PW + px) * C + c], taps.k[0]);
    for (int t = 1; t < n; ++t)
      v = __fadd_rn(v, __fmul_rn(s_in[((py + t) * PW + px) * C + c],
                                 taps.k[t]));
    s_v[i] = v;
  }
  __syncthreads();
#endif

  for (int i = tid; i < kTH * kTW * C; i += kThreads) {
    const int c = i % C;
    const int px = (i / C) % kTW;
    const int py = i / (C * kTW);
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= H || gx >= W) continue;
#ifdef VR_PROBE_NO_MATH  // the centre value, no taps
    narrow(&y[base + ((long long)gy * W + gx) * C + c], s_in[((py + r) * PW + px + r) * C + c]);
    continue;
#endif
    float blur = __fmul_rn(s_v[(py * PW + px) * C + c], taps.k[0]);
    for (int t = 1; t < n; ++t)
      blur = __fadd_rn(blur,
                       __fmul_rn(s_v[(py * PW + px + t) * C + c], taps.k[t]));
    const float center = s_in[((py + r) * PW + px + r) * C + c];
    float hp = __fsub_rn(center, blur);
    if (threshold > 0.f && !(fabsf(hp) >= threshold)) hp = 0.f;
    const float out = __fadd_rn(center, __fmul_rn(amount, hp));
    narrow(&y[base + ((long long)gy * W + gx) * C + c], fminf(fmaxf(out, 0.f), 1.f));
  }
}

template <typename T>
int run(const T* x, T* y, int B, int H, int W, int C, int radius,
        const float* taps, float amount, float threshold, void* stream) {
  if (radius < 0 || radius > kMaxRadius || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < 2 * radius + 1; ++i) t.k[i] = taps[i];
  const int PW = kTW + 2 * radius, PH = kTH + 2 * radius;
  const int bytes = (PH * PW + kTH * PW) * C * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        unsharp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const int tiles = ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
  unsharp_kernel<T><<<dim3(tiles, B), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      x, y, H, W, C, radius, t, amount, threshold);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// taps: host array of 2 * radius + 1 floats. Returns the cudaError_t.
int vr_unsharp(const float* x, float* y, int B, int H, int W, int C,
               int radius, const float* taps, float amount, float threshold,
               void* stream) {
  return run(x, y, B, H, W, C, radius, taps, amount, threshold, stream);
}

// The same on bfloat16 frames: fp32 inside, one rounding on the store.
int vr_unsharp_bf16(const void* x, void* y, int B, int H, int W, int C,
                    int radius, const float* taps, float amount, float threshold,
                    void* stream) {
  return run(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), B,
             H, W, C, radius, taps, amount, threshold, stream);
}

}  // extern "C"
