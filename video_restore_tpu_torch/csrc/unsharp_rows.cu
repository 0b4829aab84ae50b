// K2, rows route: single-pass unsharp mask on (B, H, W, C) float32 or
// bfloat16 frames, streaming down rows.
//
// Replaces video_restore_tpu/ops/pallas_post.py unsharp_fused (its
// pallas_call at :167), the same function as the tile kernel in
// csrc/unsharp.cu, and equal to it bit for bit in either element type:
//
//   xf   = float(x)
//   blur = gauss_w(gauss_h(xf))      separable taps, edge-replicate padding
//   hp   = xf - blur;  hp = |hp| >= threshold ? hp : 0   (threshold > 0)
//   out  = T(clip(xf + amount * hp, 0, 1))
//
// fp32 inside whatever the element type T, and one rounding to T on the
// store, as the Pallas kernel widens its bf16 window and casts its result
// to x.dtype (pallas_post.py:98-119, :175). Vertical pass first, each pass
// summing the rounded products tap by tap (__fmul_rn / __fadd_rn, so the
// compiler fuses nothing), then unsharp.cu's epilogue: the same operations
// on the same values in the same order.
//
// What bounds it on the H100: 2 sizeof(T) bytes moved per value (one read,
// one write) against 4(2r + 1) + 4 operations, so device memory: at the
// flagship's 7680x4320x3, 796 MB and 0.238 ms in fp32, 398 MB and 0.119 ms
// in bf16 (3.35 TB/s). The tile kernel decodes every index with runtime
// divisions by C and the padded tile width, re-reads 1.875x its tile
// through a 32x16 window at r = 4, and loads one value per thread from
// unaligned windows.
//
// Design. A row is W*C values ("flat", as the Pallas kernel views it), so a
// horizontal tap is an offset of t*C values. C (3, the frames' channels) and
// the radius R are template parameters: no loop over rows divides by
// anything. Each thread owns one group of G flat columns (16 bytes: G = 4
// floats or 8 bf16). A block of kThreads threads owns a strip of whole
// groups plus HG = ceil(R*C / G) halo groups on each side (clamped to the
// edge pixel once, when a thread sets up its columns) and streams down a run
// of rows of one frame:
//   - each thread copies its group of the coming input rows into its own
//     slots of a shared-memory ring by cp.async (16 bytes; where the row is
//     not 16-byte aligned or the group lies over the frame's edge, 4 x 4
//     bytes for fp32, and 8 plain 2-byte loads and one store for bf16),
//     kAhead rows ahead of the row it sums; no thread reads another's slots,
//     so the ring needs no barrier;
//   - it keeps the last 2R + 1 rows of its group in registers as loaded
//     (16 bytes each, whatever T: the row loop is unrolled by 2R + 1, so the
//     window turns by renaming), widens each value to fp32 where a tap reads
//     it, and sums the vertical taps;
//   - the fp32 vertical sums go to a double-buffered row in shared memory;
//     after one barrier a thread of the strip reads the 2HG + 1 groups
//     around its own (16-byte loads), sums the horizontal taps and writes
//     its group once, 16 bytes at a time.
// Each input row of a strip is read once per run (plus 2R rows where a run
// starts, and the halo groups), each output row written once. The grid is
// persistent: as many blocks as fit on the card, each taking an equal,
// contiguous share of the (frame, strip, row) index as one or more runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kThreads = 256;       // groups of 16 bytes per block: 4 KB a row
constexpr int kAhead = 6;           // input rows in flight per thread
constexpr int kSlots = kAhead + 1;  // ring depth: the slot read last is refilled
constexpr int kMinRows = 16;        // fewest rows a block takes

struct Taps {
  float k[2 * kMaxRadius + 1];
};

template <typename T>
struct Params {
  const T* x;
  T* y;
  int H, WC;              // rows; values per row (W * C)
  int nstrips, sg;        // strips per row; groups per strip
  long long total;        // B * nstrips * H: the (frame, strip, row) index
  long long chunk;        // rows of that index per block
  int vec;                // W*C % G == 0 and x, y 16-byte aligned
  float amount, threshold;
  Taps taps;
};

__device__ __forceinline__ uint32_t& word(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A 16-byte group of T as loaded, and the fp32 value of its lane q; G lanes.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int G = 4;
  __device__ static float get(const uint4& v, int q) { return __uint_as_float(word(v, q)); }
  __device__ static void put(uint4& v, int q, float f) { word(v, q) = __float_as_uint(f); }
  __device__ static void store(float* p, float f) { *p = f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int G = 8;
  // bf16 -> fp32 is exact: the 16 bits are the float's high half
  __device__ static float get(const uint4& v, int q) {
    const uint32_t w = word(v, q >> 1);
    return __uint_as_float(q & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ static void put(uint4& v, int q, float f) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    uint32_t& w = word(v, q >> 1);
    w = q & 1 ? (w & 0x0000ffffu) | (b << 16) : (w & 0xffff0000u) | b;
  }
  __device__ static void store(__nv_bfloat16* p, float f) { *p = __float2bfloat16_rn(f); }
};

__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The flat column that edge-replicate padding reads for flat column j of a
// row of wc = W * C values: pixel j / C clamped to [0, W), channel kept.
template <int C>
__device__ __forceinline__ int clamp_col(int j, int wc) {
  if (j < 0) return j + (C - 1 - j) / C * C;
  if (j >= wc) return j - ((j - wc) / C + 1) * C;
  return j;
}

template <typename T, int C, int R>
__global__ void __launch_bounds__(kThreads)
    unsharp_rows_kernel(const Params<T> p) {
  using E = Elem<T>;
  constexpr int G = E::G;              // values per group
  constexpr int N = 2 * R + 1;         // taps, and rows in the window
  constexpr int HG = (R * C + G - 1) / G;  // halo groups on each side
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                                               // [kSlots][kThreads]
  float4* vrow = reinterpret_cast<float4*>(smem + kSlots * kThreads);  // [2][kThreads][G/4]
  const int tid = threadIdx.x;
  const int wcg = (p.WC + G - 1) / G;  // groups per row
  int parity = 0;

  long long i = blockIdx.x * p.chunk;
  const long long end = min(i + p.chunk, p.total);
  while (i < end) {
    // one run: rows y0 .. y0 + rows - 1 of one strip of one frame
    const long long bs = i / p.H;
    const int y0 = static_cast<int>(i - bs * p.H);
    const int strip = static_cast<int>(bs % p.nstrips);
    const T* xf = p.x + bs / p.nstrips * p.H * (long long)p.WC;
    T* yf = p.y + bs / p.nstrips * p.H * (long long)p.WC;
    const int rows = static_cast<int>(min(static_cast<long long>(p.H - y0), end - i));
    i += rows;

    const int g0 = strip * p.sg;
    const int ng = min(p.sg, wcg - g0);  // the strip's groups
    const int g = g0 - HG + tid;         // this thread's group
    const bool active = tid < ng + 2 * HG;
    const bool writer = tid >= HG && tid < HG + ng;
    const bool vec = p.vec && g >= 0 && G * g < p.WC;
    int col[G];
#pragma unroll
    for (int q = 0; q < G; ++q) col[q] = clamp_col<C>(G * g + q, p.WC);

    const int L = rows + 2 * R;  // input rows of the run
    // input row n of the run into ring slot s
    auto issue = [&](int n, int s) {
      if (!active || n >= L) return;
      const int yc = min(max(y0 - R + n, 0), p.H - 1);
      const T* src = xf + (long long)yc * p.WC;
      uint4* dst = ring + s * kThreads + tid;
      if (vec) {
        cp_async16(dst, src + G * g);
      } else if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int q = 0; q < G; ++q)
          cp_async4(reinterpret_cast<uint32_t*>(dst) + q, src + col[q]);
      } else {  // 2-byte values: below cp.async's least size
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
        uint4 v;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          word(v, w) = s16[col[2 * w]] | static_cast<uint32_t>(s16[col[2 * w + 1]]) << 16;
        *dst = v;
      }
    };
#pragma unroll
    for (int n = 0; n < kAhead; ++n) {
      issue(n, n);
      cp_async_commit();
    }

    uint4 win[N];
    int rs = 0;  // the ring slot of the next input row
    for (int base = 0; base < L; base += N) {
#pragma unroll
      for (int ph = 0; ph < N; ++ph) {
        const int n = base + ph;
        if (n >= L) break;
        cp_async_wait<kAhead - 1>();  // input row n, this thread's group
        win[ph] = ring[rs * kThreads + tid];
        issue(n + kAhead, rs == 0 ? kSlots - 1 : rs - 1);  // the slot read last
        cp_async_commit();
        rs = rs == kSlots - 1 ? 0 : rs + 1;
        if (n < 2 * R) continue;
        // output row y0 + n - 2R: window slot (ph + 1 + t) % N holds its
        // input row - R + t
        float v[G];
#ifdef VR_PROBE_NO_MATH
#pragma unroll
        for (int q = 0; q < G; ++q) v[q] = E::get(win[(ph + 1 + R) % N], q);
#else
#pragma unroll
        for (int q = 0; q < G; ++q) v[q] = __fmul_rn(E::get(win[(ph + 1) % N], q), p.taps.k[0]);
#pragma unroll
        for (int t = 1; t < N; ++t)
#pragma unroll
          for (int q = 0; q < G; ++q)
            v[q] = __fadd_rn(v[q], __fmul_rn(E::get(win[(ph + 1 + t) % N], q), p.taps.k[t]));
#endif
        float4* vb = vrow + parity * kThreads * (G / 4);
        parity ^= 1;
#pragma unroll
        for (int c = 0; c < G / 4; ++c)
          vb[tid * (G / 4) + c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
        __syncthreads();
        if (!writer) continue;
        const uint4 center = win[(ph + 1 + R) % N];
        float res[G];
#ifdef VR_PROBE_NO_MATH
#pragma unroll
        for (int c = 0; c < G / 4; ++c) {
          const float4 a = vb[tid * (G / 4) + c];
          res[4 * c] = a.x;
          res[4 * c + 1] = a.y;
          res[4 * c + 2] = a.z;
          res[4 * c + 3] = a.w;
        }
#else
        // the groups tid - HG .. tid + HG; tap t of lane q is value
        // G * HG + q - R * C + t * C of them
        float h[G * (2 * HG + 1)];
#pragma unroll
        for (int c = 0; c < (2 * HG + 1) * (G / 4); ++c) {
          const float4 a = vb[(tid - HG) * (G / 4) + c];
          h[4 * c] = a.x;
          h[4 * c + 1] = a.y;
          h[4 * c + 2] = a.z;
          h[4 * c + 3] = a.w;
        }
        constexpr int o = G * HG - R * C;
        float blur[G];
#pragma unroll
        for (int q = 0; q < G; ++q) blur[q] = __fmul_rn(h[o + q], p.taps.k[0]);
#pragma unroll
        for (int t = 1; t < N; ++t)
#pragma unroll
          for (int q = 0; q < G; ++q)
            blur[q] = __fadd_rn(blur[q], __fmul_rn(h[o + q + t * C], p.taps.k[t]));
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float c = E::get(center, q);
          float hp = __fsub_rn(c, blur[q]);
          if (p.threshold > 0.f && !(fabsf(hp) >= p.threshold)) hp = 0.f;
          const float o_ = __fadd_rn(c, __fmul_rn(p.amount, hp));
          res[q] = fminf(fmaxf(o_, 0.f), 1.f);
        }
#endif
        T* dst = yf + (long long)(y0 + n - 2 * R) * p.WC;
        if (vec) {
          uint4 out;
#pragma unroll
          for (int q = 0; q < G; ++q) E::put(out, q, res[q]);
          *reinterpret_cast<uint4*>(dst + G * g) = out;
        } else {
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (G * g + q < p.WC) E::store(dst + G * g + q, res[q]);
        }
      }
    }
  }
}

template <typename T, int C, int R>
cudaError_t launch(Params<T>& p, int B, cudaStream_t stream) {
  constexpr int G = Elem<T>::G;
  constexpr int HG = (R * C + G - 1) / G;
  const int wcg = (p.WC + G - 1) / G;
  const int sg_max = kThreads - 2 * HG;
  p.nstrips = (wcg + sg_max - 1) / sg_max;
  p.sg = (wcg + p.nstrips - 1) / p.nstrips;
  // whole 128-byte lines per strip where that costs no strip
  const int sg8 = (p.sg + 7) / 8 * 8;
  if (sg8 <= sg_max && (wcg + sg8 - 1) / sg8 == p.nstrips) p.sg = sg8;
  p.total = (long long)B * p.nstrips * p.H;
  // the ring of 16-byte groups, then two rows of G fp32 vertical sums
  const int smem = kSlots * kThreads * static_cast<int>(sizeof(uint4)) +
                   2 * kThreads * G * static_cast<int>(sizeof(float));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unsharp_rows_kernel<T, C, R>,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  const long long want = (p.total + kMinRows - 1) / kMinRows;
  const int grid = static_cast<int>(std::min(want, (long long)std::max(per_sm, 1) * sms));
  p.chunk = (p.total + grid - 1) / grid;
  unsharp_rows_kernel<T, C, R><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// launch<T, C, r> for a runtime r in [0, R]
template <typename T, int C, int R>
cudaError_t launch_r(int r, Params<T>& p, int B, cudaStream_t stream) {
  if constexpr (R > 0) {
    if (r != R) return launch_r<T, C, R - 1>(r, p, B, stream);
  }
  return launch<T, C, R>(p, B, stream);
}

template <typename T>
int run(const T* x, T* y, int B, int H, int W, int C, int radius,
        const float* taps, float amount, float threshold, void* stream) {
  if (radius < 0 || radius > kMaxRadius || B < 1 || H < 1 || W < 1 ||
      C != 3 || (long long)W * C > (1 << 30))
    return cudaErrorInvalidValue;
  Params<T> p;
  p.x = x;
  p.y = y;
  p.H = H;
  p.WC = W * C;
  p.vec = p.WC % Elem<T>::G == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  p.amount = amount;
  p.threshold = threshold;
  for (int i = 0; i < 2 * radius + 1; ++i) p.taps.k[i] = taps[i];
  return launch_r<T, 3, kMaxRadius>(radius, p, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// taps: host array of 2 * radius + 1 floats; C must be 3, the paths' frames
// (the tile kernel in unsharp.cu takes any C). Returns the cudaError_t.
int vr_unsharp_rows(const float* x, float* y, int B, int H, int W, int C,
                    int radius, const float* taps, float amount, float threshold,
                    void* stream) {
  return run(x, y, B, H, W, C, radius, taps, amount, threshold, stream);
}

// The same on bfloat16 frames: fp32 inside, one rounding on the store.
int vr_unsharp_rows_bf16(const void* x, void* y, int B, int H, int W, int C,
                         int radius, const float* taps, float amount,
                         float threshold, void* stream) {
  return run(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), B,
             H, W, C, radius, taps, amount, threshold, stream);
}

}  // extern "C"
