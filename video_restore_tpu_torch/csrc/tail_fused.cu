// K6: the RRDBNet tail in one launch: upconv2 -> conv_hr -> conv_last.
//
// Replaces the quad tail of video_restore_tpu/ops/pallas_tail.py:
//   tail_fused_q (kernel body _tail_q_kernel), reached with VRT_TAIL_Q=1,
// which computes, from up1's output x (B, H2, W2, nf) on NHWC:
//
//   u2  = T(lrelu(conv_up2(nearest2x(x)) + b_up2))     (B, 2 H2, 2 W2, nf)
//   hr  = T(lrelu(conv_hr(u2) + b_hr))                 (B, 2 H2, 2 W2, nf)
//   out = T(conv_last(hr) + b_last)                    (B, 2 H2, 2 W2, 3)
//
// with every conv 3x3 SAME (zero padding at the 2 H2 x 2 W2 frame edge),
// products summed in fp32, the epilogues in fp32 and T() the rounding to the
// activation dtype; u2 and hr never reach device memory. The Pallas kernel's
// layout (four fine columns packed per lane group, structural-zero weight
// matrices, up1's raw (b, o) lane pairs) is the TPU's and is not carried
// over: x is a plain tensor and the weights are read as given, upconv2
// reading x through the nearest-2x index map.
//
// Design. A block owns a TH x TW tile of the output grid and holds three
// shared-memory windows in T, channel-planar:
//   x  at the coarse grid, (TH/2 + 4) x (TW/2 + 4) x nf, zero outside x;
//   u2 on the tile + 2 px each side, (TH + 4) x (TW + 4) x nf;
//   hr on the tile + 1 px each side, (TH + 2) x (TW + 2) x nf.
// The halo of u2 and hr is recomputed by every tile (bf16, 16 x 28: 1.43x
// the useful MACs of upconv2, 1.21x of conv_hr). Both intermediates are
// zeroed outside the frame and rounded to T as they are stored, so conv_hr
// and conv_last see exact SAME padding at the frame edge whatever the tile.
// The two nf x nf weight sets (73.7 KB each in bf16 at nf 64) do not fit
// beside the windows, so they stream through shared memory as fp32 in chunks
// of 8 input channels; conv_last's 9 x nf x 3 fit whole. In the two wide
// convs each thread owns 8 pixels of one window row x 8 output channels in
// fp32 registers and reuses every input row segment across the three kx
// taps, as K1 and K5 do (upconv2 loads 6 coarse values for its 10 fine
// ones); in conv_last a thread owns 4 pixels x 3 channels.
//
// What bounds it on the H100: at nf 64 the tail does 3.65e12 operations
// (upconv2 in phase form) per 7680x4320 frame against 1.26 GB of compulsory
// traffic (x in, RGB out), so it is compute bound (3.7 ms at the bf16
// tensor-core peak). This first design runs fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak) at one block of 320 threads per SM; what it saves over
// three K1 launches is the 17 GB of intermediate traffic and 8.5 GB of
// device memory, not operations. bf16 at nf 64 runs on the tensor cores in
// tail_fused_mma.cu; this kernel keeps fp32 and nf 16
// (ops/tail.py::tail_fused_route).

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

constexpr int kThreads = 320;  // 10 warps: the bf16 tile's 640 and 576 items
constexpr int kCI = 8;         // input channels per streamed weight chunk
constexpr int kSlack = 32;     // elements after each window (overrun reads)
constexpr int kOut = 3;        // conv_last's output channels

struct TailArgs {
  const void* x;  // (B, H2, W2, NF) contiguous
  void* y;        // (B, 2 H2, 2 W2, 3) contiguous
  const void* w_up2;   // HWIO (3, 3, NF, NF)
  const void* b_up2;   // (NF,)
  const void* w_hr;    // HWIO (3, 3, NF, NF)
  const void* b_hr;    // (NF,)
  const void* w_last;  // HWIO (3, 3, NF, 3)
  const void* b_last;  // (3,)
  int B, H2, W2;
};

template <int NF, int TH, int TW>
struct Layout {
  static_assert(TH % 2 == 0 && TW % 4 == 0 && (TW + 4) % 8 == 0,
                "tile: even rows, conv_last's 4-pixel groups, upconv2's "
                "8-pixel groups");
  static_assert(NF % 8 == 0, "8-channel register tiles");
  static constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;  // x, coarse grid
  static constexpr int UH = TH + 4, UW = TW + 4;          // u2
  static constexpr int HH = TH + 2, HW = TW + 2;          // hr
  static constexpr int kXOff = 0;
  static constexpr int kUOff = kXOff + NF * XH * XW + kSlack;
  static constexpr int kHOff = kUOff + NF * UH * UW + kSlack;
  static constexpr int kActElems = kHOff + NF * HH * HW + kSlack;
  static constexpr int kWElems = 9 * kCI * NF;  // >= conv_last's 9 * NF * 3
  template <typename T>
  __host__ __device__ static constexpr int bytes() {
    return kWElems * 4 + (kActElems * (int)sizeof(T) + 15) / 16 * 16;
  }
};

// One of the two nf -> nf convs on the block's windows. STAGE 1: upconv2,
// reads the x window through the nearest-2x index map and writes the u2
// window; STAGE 2: conv_hr, reads the u2 window and writes the hr window.
// The output is lrelu'd, zeroed outside the frame and rounded to T.
template <typename T, int NF, int TH, int TW, int STAGE>
__device__ __forceinline__ void conv_stage(const T* __restrict__ w,
                                           const T* __restrict__ bias, int OH,
                                           int OW, int ty0, int tx0,
                                           float* s_w, T* s_act) {
  using L = Layout<NF, TH, TW>;
  constexpr bool UP = STAGE == 1;
  constexpr int R = UP ? L::UH : L::HH;  // output window rows
  constexpr int C = UP ? L::UW : L::HW;  // output window columns
  constexpr int SW = UP ? L::XW : L::UW;  // source row pitch
  constexpr int SP = UP ? L::XH * L::XW : L::UH * L::UW;  // source plane
  constexpr int SRC = UP ? L::kXOff : L::kUOff;
  constexpr int DST = UP ? L::kUOff : L::kHOff;
  constexpr int HALO = UP ? 2 : 1;  // the window starts at (ty0, tx0) - HALO
  constexpr int COG = NF / 8;
  constexpr int NCG = (C + 7) / 8;
  constexpr int NITEMS = R * NCG * COG;

  for (int base = 0; base < NITEMS; base += kThreads) {
    const int item = base + threadIdx.x;
    const bool active = item < NITEMS;
    const int cgi = item % COG;
    const int pg = item / COG;
    const int row = pg / NCG;
    const int col = (pg % NCG) * 8;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int cl = 0; cl < NF; cl += kCI) {
      __syncthreads();  // the previous chunk (or stage) is consumed
      for (int i = threadIdx.x; i < 9 * kCI * NF; i += kThreads) {
        const int co = i % NF;
        const int ci = (i / NF) % kCI;
        const int tap = i / (NF * kCI);
        s_w[i] = to_f(w[((long long)tap * NF + cl + ci) * NF + co]);
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll 2
      for (int ci = 0; ci < kCI; ++ci) {
        const T* plane = s_act + SRC + (cl + ci) * SP;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float xin[10];
          if constexpr (UP) {
            // fine (row + ky, col + j) of the window + 1 px is coarse
            // ((row + ky + 1) / 2, (col + j + 1) / 2) of the x window
            const T* r = plane + ((row + ky + 1) >> 1) * SW + (col >> 1);
            float xc[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) xc[j] = to_f(r[j]);
#pragma unroll
            for (int j = 0; j < 10; ++j) xin[j] = xc[(j + 1) >> 1];
          } else {
            const T* r = plane + (row + ky) * SW + col;
#pragma unroll
            for (int j = 0; j < 10; ++j) xin[j] = to_f(r[j]);
          }
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4* wp = reinterpret_cast<const float4*>(
                s_w + ((ky * 3 + kx) * kCI + ci) * NF + cgi * 8);
            const float4 w0 = wp[0], w1 = wp[1];
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int q = 0; q < 8; ++q)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[q][c] = fmaf(xin[q + kx], wv[c], acc[q][c]);
          }
        }
      }
    }
    if (!active) continue;

    T* dst = s_act + DST + row * C + col;
    const int fy = ty0 - HALO + row;
    const bool row_in = fy >= 0 && fy < OH;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (col + q >= C) continue;
      const int fx = tx0 - HALO + col + q;
      const bool in = row_in && fx >= 0 && fx < OW;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = cgi * 8 + c;
        float v = __fadd_rn(acc[q][c], to_f(bias[co]));
        v = v >= 0.f ? v : __fmul_rn(0.2f, v);
        dst[co * R * C + q] = from_f<T>(in ? v : 0.f);
      }
    }
  }
}

// conv_last on the hr window: the tile's RGB values, inside the frame.
template <typename T, int NF, int TH, int TW>
__device__ __forceinline__ void last_stage(const T* __restrict__ w,
                                           const T* __restrict__ bias,
                                           T* __restrict__ y, int OH, int OW,
                                           int n, int ty0, int tx0,
                                           float* s_w, const T* s_act) {
  using L = Layout<NF, TH, TW>;
  constexpr int NPG = TW / 4;
  constexpr int NITEMS = TH * NPG;
  __syncthreads();  // the hr window is complete; the weight chunk is free
  for (int i = threadIdx.x; i < 9 * NF * kOut; i += kThreads)
    s_w[i] = to_f(w[i]);
  __syncthreads();
  for (int item = threadIdx.x; item < NITEMS; item += kThreads) {
    const int row = item / NPG;
    const int col = (item % NPG) * 4;
    float acc[4][kOut];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[q][c] = 0.f;
#pragma unroll 4
    for (int ci = 0; ci < NF; ++ci) {
      const T* plane = s_act + L::kHOff + ci * L::HH * L::HW;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const T* r = plane + (row + ky) * L::HW + col;
        float xin[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xin[j] = to_f(r[j]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wp = s_w + ((ky * 3 + kx) * NF + ci) * kOut;
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < kOut; ++c)
              acc[q][c] = fmaf(xin[q + kx], wp[c], acc[q][c]);
        }
      }
    }
    const int fy = ty0 + row;
    if (fy >= OH) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int fx = tx0 + col + q;
      if (fx >= OW) continue;
      const long long pix = ((long long)n * OH + fy) * OW + fx;
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        y[pix * kOut + c] = from_f<T>(__fadd_rn(acc[q][c], to_f(bias[c])));
    }
  }
}

template <typename T, int NF, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(const TailArgs a) {
  using L = Layout<NF, TH, TW>;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  T* s_act = reinterpret_cast<T*>(s_w + L::kWElems);

  const int OH = 2 * a.H2, OW = 2 * a.W2;
  const int tiles_x = (OW + TW - 1) / TW;
  const int tiles_y = (OH + TH - 1) / TH;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int rem = blockIdx.x % (tiles_x * tiles_y);
  const int ty0 = (rem / tiles_x) * TH, tx0 = (rem % tiles_x) * TW;

  // the x window: coarse rows ty0/2 - 2 .., columns tx0/2 - 2 ..; zero
  // outside x, which is zero padding on the 2x grid for upconv2
  const T* __restrict__ x = static_cast<const T*>(a.x);
  constexpr int XP = L::XH * L::XW;
  for (int i = threadIdx.x; i < XP * NF; i += kThreads) {
    const int c = i % NF;
    const int pix = i / NF;
    const int cy = ty0 / 2 - 2 + pix / L::XW, cx = tx0 / 2 - 2 + pix % L::XW;
    T v = from_f<T>(0.f);
    if (cy >= 0 && cy < a.H2 && cx >= 0 && cx < a.W2)
      v = x[(((long long)n * a.H2 + cy) * a.W2 + cx) * NF + c];
    s_act[L::kXOff + c * XP + pix] = v;
  }
  conv_stage<T, NF, TH, TW, 1>(static_cast<const T*>(a.w_up2),
                               static_cast<const T*>(a.b_up2), OH, OW, ty0,
                               tx0, s_w, s_act);
  conv_stage<T, NF, TH, TW, 2>(static_cast<const T*>(a.w_hr),
                               static_cast<const T*>(a.b_hr), OH, OW, ty0,
                               tx0, s_w, s_act);
  last_stage<T, NF, TH, TW>(static_cast<const T*>(a.w_last),
                            static_cast<const T*>(a.b_last),
                            static_cast<T*>(a.y), OH, OW, n, ty0, tx0, s_w,
                            s_act);
}

template <typename T, int NF, int TH, int TW>
cudaError_t launch(const TailArgs& a, cudaStream_t stream) {
  using L = Layout<NF, TH, TW>;
  constexpr int bytes = L::template bytes<T>();
  static_assert(bytes <= 232448, "windows exceed a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      tail_kernel<T, NF, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)a.B * ((2 * a.H2 + TH - 1) / TH) *
                          ((2 * a.W2 + TW - 1) / TW);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  tail_kernel<T, NF, TH, TW><<<(unsigned)tiles, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = conv_last(lrelu(conv_hr(lrelu(conv_up2(nearest2x(x)))))), one launch.
// x: (B, H2, W2, nf); y: (B, 2 H2, 2 W2, 3); weights HWIO, all contiguous
// and of one dtype (0 = float32, 1 = bfloat16); nf in {64, 16}. The bf16
// tile is 16 x 28 output pixels, the fp32 tile 8 x 12. Returns the
// cudaError_t of the launch.
int vr_tail_fused(int dtype, int nf, const void* x, void* y,
                  const void* w_up2, const void* b_up2, const void* w_hr,
                  const void* b_hr, const void* w_last, const void* b_last,
                  int B, int H2, int W2, void* stream) {
  TailArgs a;
  a.x = x; a.y = y;
  a.w_up2 = w_up2; a.b_up2 = b_up2;
  a.w_hr = w_hr; a.b_hr = b_hr;
  a.w_last = w_last; a.b_last = b_last;
  a.B = B; a.H2 = H2; a.W2 = W2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf == 64) {
    if (dtype == 0) return launch<float, 64, 8, 12>(a, s);
    if (dtype == 1) return launch<__nv_bfloat16, 64, 16, 28>(a, s);
  } else if (nf == 16) {
    if (dtype == 0) return launch<float, 16, 8, 12>(a, s);
    if (dtype == 1) return launch<__nv_bfloat16, 16, 16, 28>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
