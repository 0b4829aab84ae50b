// K5: one residual dense block (RDB) in one launch, or a whole RRDB (three
// RDBs and the RRDB residual) in one cooperative launch: the fp32-FMA route
// (the kernel templates; rdb_fused.cu holds the C entry points and
// rdb_fused_{f32,bf16,narrow}.cu the instances, each its own translation
// unit so that nvcc compiles them in parallel).
//
// Replaces the fused-RDB Pallas kernels of video_restore_tpu/ops:
//   pallas_rdb.py    rdb_fused            (one RDB, square blocks)
//   pallas_stripe.py rdb_stripe           (one RDB, stripes, unpadded NHWC)
//   pallas_rdb.py    rrdb_fused           (a whole RRDB, square blocks)
//   pallas_stripe.py rrdb_stripe_padded   (a whole RRDB, padded stripes)
// All four compute, for one RDB with growth gc on NHWC activations:
//
//   c_k = T(lrelu(conv_k([x | c_1 .. c_{k-1}]) + b_k))     k = 1..4
//   out = T(x + 0.2 * (conv_5([x | c_1 .. c_4]) + b_5))
//   out = T(x0 + 0.2 * out)                                 (optional x0)
//
// with every conv SAME (zero padding at the frame edge), products summed in
// fp32 and T() the rounding to the activation dtype. The RRDB is
// x + 0.2 * RDB3(RDB2(RDB1(x))), each RDB output rounded to T and the
// residual added in fp32 (pallas_stripe.py rrdb epilogue). The pallas_rdb.py
// forms leave c_1..c_4 unmasked outside the frame; this kernel masks them
// (exact SAME, as pallas_stripe.py does and as every other port path does).
//
// Design. A block owns a TILE x TILE output tile and keeps the whole dense
// chain in shared memory: the x window (TILE + 10)^2 x nf, zero outside the
// frame, and c_k on windows that shrink by 2 per conv, (TILE + 10 - 2k)^2 x
// gc, so conv k reads only what the block holds and the halo is recomputed
// (about 1.34x the useful MACs at TILE 16). Each c_k is zeroed outside the
// frame and rounded to T as it is stored. Activations stay in T in shared
// memory (bf16: TILE 16, 201 KB; fp32: TILE 8, 173 KB); the conv weights
// (conv5 alone is 9 x 192 x 64) are streamed through shared memory as fp32
// in chunks of 8 input channels. Each thread owns 8 output pixels of one
// window row x 8 output channels in fp32 registers and reuses every input
// row segment across the three kx taps, as K1 does.
//
// The RRDB form runs the same tile routine as a persistent cooperative
// kernel (grid <= the co-resident blocks): all tiles of RDB1, a grid sync,
// RDB2, a grid sync, RDB3 with the residual fused into its epilogue. The two
// intermediates go through device memory (the output buffer and one
// scratch): a halo-15 window would not fit on chip.
//
// What bounds it on the H100: the dense chain does ~9.9e11 useful operations
// per 1080p RDB against ~0.5 GB of compulsory traffic, so it is compute
// bound (1.0 ms at the bf16 tensor-core peak). This first design runs fp32
// FMAs on the CUDA cores (67 TFLOP/s peak) at one block of 288 threads per
// SM; tensor-core mma/wgmma over the same shared-memory windows is later
// work.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace rdb_fma {

struct RdbWeights {
  const void* w[5];  // HWIO (3, 3, nf + (k-1) gc, gc | nf), contiguous
  const void* b[5];
};

struct RdbArgs {
  const void* x;   // (B, H, W, NF) contiguous
  const void* x0;  // (B, H, W, NF) contiguous, or null
  void* y;         // (B, H, W, NF) contiguous
  void* scratch;   // RRDB: (B, H, W, NF) for RDB2's output
  RdbWeights p[3];
  int B, H, W;
};

// The instances, one translation unit each (rdb_fused_f32.cu,
// rdb_fused_bf16.cu, rdb_fused_narrow.cu): the RDB (whole = false) or the
// RRDB (whole = true) at (dtype, nf, gc).
cudaError_t launch_f32_64(const RdbArgs& a, bool whole, cudaStream_t s);
cudaError_t launch_bf16_64(const RdbArgs& a, bool whole, cudaStream_t s);
cudaError_t launch_f32_16(const RdbArgs& a, bool whole, cudaStream_t s);
cudaError_t launch_bf16_16(const RdbArgs& a, bool whole, cudaStream_t s);

}  // namespace rdb_fma

namespace {

using rdb_fma::RdbArgs;
using rdb_fma::RdbWeights;

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

constexpr int kThreads = 288;  // 9 warps: conv1's 24 x 3 x 4 items at TILE 16
constexpr int kCI = 8;         // input channels per streamed weight chunk
constexpr int kSlack = 32;     // elements after each window (overrun reads)

template <int NF, int GC, int TILE>
struct Layout {
  // window side of source s (0: x, k: c_k) and of conv k's output
  __host__ __device__ static constexpr int side(int s) { return TILE + 10 - 2 * s; }
  __host__ __device__ static constexpr int chans(int s) { return s == 0 ? NF : GC; }
  __host__ __device__ static constexpr int size(int s) {
    return chans(s) * side(s) * side(s) + kSlack;
  }
  __host__ __device__ static constexpr int offset(int s) {
    return s == 0 ? 0 : offset(s - 1) + size(s - 1);
  }
  static constexpr int kWElems = 9 * kCI * NF;  // the widest chunk (conv5)
  template <typename T>
  __host__ __device__ static constexpr int bytes() {
    return kWElems * 4 + (offset(5) * (int)sizeof(T) + 15) / 16 * 16;
  }
};

// Conv K of the dense chain on the block's windows: reads sources 0..K-1,
// writes c_K (K < 5) into its window, or (K == 5) the tile's output.
template <typename T, int NF, int GC, int TILE, int K>
__device__ __forceinline__ void conv_stage(
    const RdbWeights& p, const T* __restrict__ x0, T* __restrict__ y, int H,
    int W, int n, int ty0, int tx0, float* s_w, T* s_act) {
  using L = Layout<NF, GC, TILE>;
  constexpr int CIN = NF + (K - 1) * GC;
  constexpr int COUT = K < 5 ? GC : NF;
  constexpr int COG = COUT / 8;
  constexpr int R = L::side(K);  // output window side (K == 5: TILE)
  constexpr int NCG = (R + 7) / 8;
  constexpr int NITEMS = R * NCG * COG;
  const T* __restrict__ w = static_cast<const T*>(p.w[K - 1]);
  const T* __restrict__ bias = static_cast<const T*>(p.b[K - 1]);

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

#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int cs = L::chans(s);
      const int S = L::side(s);
      const int d = K - 1 - s;  // window offset of source s against conv K
      const int cbase = s == 0 ? 0 : NF + (s - 1) * GC;
      for (int cl = 0; cl < cs; cl += kCI) {
        __syncthreads();  // the previous chunk (or stage) is consumed
        for (int i = threadIdx.x; i < 9 * kCI * COUT; i += kThreads) {
          const int co = i % COUT;
          const int ci = (i / COUT) % kCI;
          const int tap = i / (COUT * kCI);
          s_w[i] = to_f(w[((long long)tap * CIN + cbase + cl + ci) * COUT + co]);
        }
        __syncthreads();
        if (!active) continue;
        const T* src = s_act + L::offset(s) + cl * S * S + (row + d) * S + col + d;
#pragma unroll 2
        for (int ci = 0; ci < kCI; ++ci) {
          const T* plane = src + ci * S * S;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const T* r = plane + ky * S;
            float xin[10];
#pragma unroll
            for (int j = 0; j < 10; ++j) xin[j] = to_f(r[j]);
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float4* wp = reinterpret_cast<const float4*>(
                  s_w + ((ky * 3 + kx) * kCI + ci) * COUT + cgi * 8);
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
    }
    if (!active) continue;

    if constexpr (K < 5) {
      // c_K: lrelu, zero outside the frame, rounded to T, into its window
      T* dst = s_act + L::offset(K) + row * R + col;
      const int fy = ty0 - (5 - K) + row;
      const bool row_in = fy >= 0 && fy < H;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (col + q >= R) continue;
        const int fx = tx0 - (5 - K) + col + q;
        const bool in = row_in && fx >= 0 && fx < W;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int co = cgi * 8 + c;
          float v = __fadd_rn(acc[q][c], to_f(bias[co]));
          v = v >= 0.f ? v : __fmul_rn(0.2f, v);
          dst[co * R * R + q] = from_f<T>(in ? v : 0.f);
        }
      }
    } else {
      // out = x + 0.2 (conv5 + b5) [then x0 + 0.2 T(out)], inside the frame
      const int fy = ty0 + row;
      if (fy >= H) continue;
      constexpr int S0 = L::side(0);
      const T* xc = s_act + (row + 5) * S0 + col + 5;  // x at the output pixel
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int fx = tx0 + col + q;
        if (col + q >= TILE || fx >= W) continue;
        const long long pix = ((long long)n * H + fy) * W + fx;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int co = cgi * 8 + c;
          float v = __fadd_rn(acc[q][c], to_f(bias[co]));
          v = __fadd_rn(to_f(xc[co * S0 * S0 + q]), __fmul_rn(0.2f, v));
          if (x0)
            v = __fadd_rn(to_f(x0[pix * NF + co]),
                          __fmul_rn(0.2f, to_f(from_f<T>(v))));
          y[pix * NF + co] = from_f<T>(v);
        }
      }
    }
  }
}

// One RDB on one output tile: load the x window, then the five convs. x is
// not __restrict__: in the RRDB kernel it was written earlier in the same
// launch (before a grid sync), so it must not go through the read-only path.
template <typename T, int NF, int GC, int TILE>
__device__ void rdb_tile(const T* x, const T* __restrict__ x0,
                         T* __restrict__ y, const RdbWeights& p, int H, int W,
                         int tile, float* s_w, T* s_act) {
  using L = Layout<NF, GC, TILE>;
  constexpr int S = L::side(0);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  const int n = tile / (tiles_x * tiles_y);
  const int rem = tile % (tiles_x * tiles_y);
  const int ty0 = (rem / tiles_x) * TILE, tx0 = (rem % tiles_x) * TILE;

  __syncthreads();  // the previous tile's windows are consumed
  for (int i = threadIdx.x; i < S * S * NF; i += kThreads) {
    const int c = i % NF;
    const int pix = i / NF;
    const int fy = ty0 - 5 + pix / S, fx = tx0 - 5 + pix % S;
    T v = from_f<T>(0.f);
    if (fy >= 0 && fy < H && fx >= 0 && fx < W)
      v = x[(((long long)n * H + fy) * W + fx) * NF + c];
    s_act[c * S * S + pix] = v;
  }
  conv_stage<T, NF, GC, TILE, 1>(p, x0, y, H, W, n, ty0, tx0, s_w, s_act);
  conv_stage<T, NF, GC, TILE, 2>(p, x0, y, H, W, n, ty0, tx0, s_w, s_act);
  conv_stage<T, NF, GC, TILE, 3>(p, x0, y, H, W, n, ty0, tx0, s_w, s_act);
  conv_stage<T, NF, GC, TILE, 4>(p, x0, y, H, W, n, ty0, tx0, s_w, s_act);
  conv_stage<T, NF, GC, TILE, 5>(p, x0, y, H, W, n, ty0, tx0, s_w, s_act);
}

template <typename T, int NF, int GC, int TILE>
__global__ void __launch_bounds__(kThreads, 1) rdb_kernel(const RdbArgs a) {
  using L = Layout<NF, GC, TILE>;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  T* s_act = reinterpret_cast<T*>(s_w + L::kWElems);
  rdb_tile<T, NF, GC, TILE>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.x0),
      static_cast<T*>(a.y), a.p[0], a.H, a.W, blockIdx.x, s_w, s_act);
}

template <typename T, int NF, int GC, int TILE>
__global__ void __launch_bounds__(kThreads, 1) rrdb_kernel(const RdbArgs a) {
  using L = Layout<NF, GC, TILE>;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  T* s_act = reinterpret_cast<T*>(s_w + L::kWElems);
  cg::grid_group grid = cg::this_grid();
  const int ntiles =
      a.B * ((a.H + TILE - 1) / TILE) * ((a.W + TILE - 1) / TILE);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  T* tmp = static_cast<T*>(a.scratch);
  // RDB1: x -> y; RDB2: y -> tmp; RDB3 + residual: tmp, x -> y
  for (int r = 0; r < 3; ++r) {
    const T* src = r == 0 ? x : (r == 1 ? y : tmp);
    T* dst = r == 1 ? tmp : y;
    const T* res = r == 2 ? x : nullptr;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
      rdb_tile<T, NF, GC, TILE>(src, res, dst, a.p[r], a.H, a.W, t, s_w, s_act);
    if (r < 2) grid.sync();
  }
}

template <typename T, int NF, int GC, int TILE>
cudaError_t launch(const RdbArgs& a, bool whole, cudaStream_t stream) {
  using L = Layout<NF, GC, TILE>;
  constexpr int bytes = L::template bytes<T>();
  void (*kern)(const RdbArgs) =
      whole ? rrdb_kernel<T, NF, GC, TILE> : rdb_kernel<T, NF, GC, TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int ntiles =
      a.B * ((a.H + TILE - 1) / TILE) * ((a.W + TILE - 1) / TILE);
  if (ntiles <= 0) return cudaErrorInvalidValue;
  if (!whole) {
    kern<<<ntiles, kThreads, bytes, stream>>>(a);
    return cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  RdbArgs arg = a;
  void* params[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(kThreads), params, bytes, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
