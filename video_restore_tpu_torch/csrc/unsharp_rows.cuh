// K2, rows route: single-pass unsharp mask on (B, H, W, C) float32 or
// bfloat16 frames, streaming down rows. The kernel template; each element
// type is instantiated in its own translation unit (unsharp_rows.cu: fp32,
// unsharp_rows_bf16.cu: bf16), so that the two build in parallel.
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
// one write) against 2(2(2r + 1) - 1) + 5 fp32 instructions, none of them
// an FMA (39 at r = 4). At the flagship's 7680x4320x3: 796 MB, 0.238 ms in
// fp32 and 398 MB, 0.119 ms in bf16 (3.35 TB/s); 3.9 G instructions,
// 0.116 ms at one instruction per lane per clock (132 SMs x 128 lanes x
// 1.98 GHz). So fp32 is held by its bytes and bf16 by both: the kernel has
// to overlap its loads with its arithmetic, which takes enough warps on
// each SM, and spend few instructions besides the taps'. The tile kernel decodes every index with runtime divisions by
// C and the padded tile width, re-reads 1.875x its tile through a 32x16
// window at r = 4, and loads one value per thread from unaligned windows.
//
// Design. A row is W*C values ("flat", as the Pallas kernel views it), so a
// horizontal tap is an offset of t*C values. C (3, the frames' channels) and
// the radius R are template parameters: no loop over rows divides by
// anything. Each thread owns one group of G = 4 flat columns, whatever T:
// 16 bytes of fp32 or 8 bytes of bf16, so a warp reads 512 or 256
// contiguous bytes of a row and both types keep the same registers a
// thread (2R + 1 groups of 4 floats in the window, (2HG + 1) x 4 floats in
// the horizontal pass), few enough that min_blocks() can cut them for two
// or three 256-thread blocks an SM. A block of kThreads threads owns a
// strip of whole groups plus
// HG = ceil(R*C / G) halo groups on each side (clamped to the edge pixel
// once, when a thread sets up its columns) and streams down a run of rows
// of one frame:
//   - each thread copies its group of the coming input rows into its own
//     slots of a shared-memory ring by cp.async (one 16- or 8-byte copy;
//     where the row is not aligned or the group lies over the frame's edge,
//     4 x 4 bytes: the fp32 values, or the aligned words that hold the bf16
//     values, whose 2 bytes are below cp.async's least size; such a word
//     may reach 2 bytes before the tensor's first value or after its last,
//     bytes that are read and discarded and lie in the same 4-byte word,
//     so inside any allocation aligned to 4 bytes), kAhead rows
//     ahead of the row it sums (kAhead + 1 slots: ring_slots(), so that
//     every slot's address is a compile-time offset); no thread reads
//     another's slots, so the ring needs no barrier, and no thread waits on
//     a load of the row it sums (a plain load at the frame's edge would
//     stall every row of the edge strips' blocks, and the kernel ends with
//     its slowest block);
//   - it widens each group to fp32 once, as it leaves the ring (exact:
//     a bf16 value is the high half of its float), keeps the last 2R + 1
//     rows of its group in registers (the row loop is unrolled by 2R + 1,
//     so the window turns by renaming) and sums the vertical taps;
//   - the fp32 vertical sums go to a double-buffered row in shared memory;
//     after one barrier a thread of the strip reads the 2HG groups around
//     its own (16-byte loads; its own is still in registers), sums the
//     horizontal taps and writes its group once (one 16- or 8-byte store).
// Each input row of a strip is read once per run (plus 2R rows where a run
// starts, and the halo groups), each output row written once. The grid is
// persistent: as many blocks as fit on the card, each taking an equal,
// contiguous share of the (frame, strip, row) index as one or more runs.
// Offsets within a row are 32-bit (W * C <= 2^30), a row's offset in its
// frame and a frame's in the batch 64-bit, so a frame may hold more than
// 2^31 values.
//
// Probe build (tools/probe_k2.py): VR_PROBE_NO_MATH drops the taps (the
// ring, window, barrier and stores stay).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kThreads = 256;  // groups of 4 values per block
constexpr int kMinRows = 16;   // fewest rows a block takes
constexpr int G = 4;           // values per group
constexpr int kMinAhead = 6;   // fewest input rows in flight per thread

// Ring depth for 2R + 1 = N rows in the window: the least divisor of N that
// holds kMinAhead + 1 rows, else the least multiple of N that does. Either
// way the slot of input row base + ph (base a multiple of N) is rb + ph %
// slots, rb fixed over the unrolled phases (0 where slots divides N), so
// the ring's addresses are compile-time offsets.
__host__ __device__ constexpr int ring_slots(int n) {
  for (int d = kMinAhead + 1; d <= n; ++d)
    if (n % d == 0) return d;
  return (kMinAhead / n + 1) * n;
}

// Blocks per SM the register budget is cut for, at r <= 4 (a longer window
// keeps its registers). bf16, held by its instruction issue: three (80
// registers a thread, 24 warps an SM), whose warps hide the stalls of each
// row's barrier and of the horizontal pass's shared-memory loads; two and
// four (64 registers, which spill) were slower. fp32, held by its bytes:
// two.
template <typename T>
__host__ __device__ constexpr int min_blocks(int r) {
  return r > 4 ? 1 : sizeof(T) == 2 ? 3 : 2;
}

struct Taps {
  float k[2 * kMaxRadius + 1];
};

template <typename T>
struct Params {
  const T* x;
  T* y;
  int H, WC;              // rows; values per row (W * C <= 2^30)
  int nstrips, sg;        // strips per row; groups per strip
  long long total;        // B * nstrips * H: the (frame, strip, row) index
  long long chunk;        // rows of that index per block
  int vec;                // W*C % G == 0 and x, y aligned to a group
  float amount, threshold;
  Taps taps;
};

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// A group of G values of T: its copy from a row into this thread's entry i
// of the ring (of n entries a half), its widening to fp32 as it leaves the
// ring, and the rounding of results back to T. Every copy is a cp.async,
// so no thread waits on a load before the row it sums: a block's threads
// meet at a barrier every row, so one thread that waited would hold them
// all. A group that is not aligned or lies over the frame's edge (its
// columns clamped, col[]) is copied value by value.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kEntryBytes = 16;  // ring bytes a thread a row
  // one 16-byte copy, or 4 x 4 bytes
  __device__ static void copy(unsigned char* ring, int i, int n, const float* row, int gofs,
                              const int* col, bool vec) {
    uint4* dst = reinterpret_cast<uint4*>(ring) + i;
    if (vec) {
      cp_async16(dst, row + gofs);
    } else {
#pragma unroll
      for (int q = 0; q < G; ++q) cp_async4(reinterpret_cast<uint32_t*>(dst) + q, row + col[q]);
    }
  }
  __device__ static float4 read(const unsigned char* ring, int i, int n, bool vec,
                                const float* row, const int* col) {
    const uint4 v = reinterpret_cast<const uint4*>(ring)[i];
    return make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                       __uint_as_float(v.w));
  }
  __device__ static void put(float* p, const float4& f) { *reinterpret_cast<float4*>(p) = f; }
  __device__ static void store(float* p, float f) { *p = f; }
};

template <>
struct Elem<__nv_bfloat16> {
  // two halves of 8 bytes: an aligned group fills the first; a group
  // copied value by value takes each value's aligned 4-byte word (below 4
  // bytes there is no cp.async; its other half may lie just outside the
  // tensor, and is discarded), two words in each half
  static constexpr int kEntryBytes = 16;
  __device__ static void copy(unsigned char* ring, int i, int n, const __nv_bfloat16* row,
                              int gofs, const int* col, bool vec) {
    uint2* lo = reinterpret_cast<uint2*>(ring) + i;
    if (vec) {
      cp_async8(lo, row + gofs);
    } else {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(row + col[q]) & ~uintptr_t{3};
        cp_async4(reinterpret_cast<uint32_t*>(q < 2 ? lo : lo + n) + (q & 1),
                  reinterpret_cast<const void*>(a));
      }
    }
  }
  // bf16 -> fp32 is exact: the 16 bits are the float's high half
  __device__ static float4 read(const unsigned char* ring, int i, int n, bool vec,
                                const __nv_bfloat16* row, const int* col) {
    const uint2 a = reinterpret_cast<const uint2*>(ring)[i];
    if (vec)
      return make_float4(__uint_as_float(a.x << 16), __uint_as_float(a.x & 0xffff0000u),
                         __uint_as_float(a.y << 16), __uint_as_float(a.y & 0xffff0000u));
    const uint2 b = reinterpret_cast<const uint2*>(ring)[i + n];
    const uint32_t w[G] = {a.x, a.y, b.x, b.y};
    float f[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {  // the value's half of its word
      const bool high = reinterpret_cast<uintptr_t>(row + col[q]) & 2;
      f[q] = __uint_as_float(high ? w[q] & 0xffff0000u : w[q] << 16);
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static uint32_t pack(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
  }
  __device__ static void put(__nv_bfloat16* p, const float4& f) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(f.x, f.y), pack(f.z, f.w));
  }
  __device__ static void store(__nv_bfloat16* p, float f) { *p = __float2bfloat16_rn(f); }
};

// The flat column that edge-replicate padding reads for flat column j of a
// row of wc = W * C values: pixel j / C clamped to [0, W), channel kept.
template <int C>
__device__ __forceinline__ int clamp_col(int j, int wc) {
  if (j < 0) return j + (C - 1 - j) / C * C;
  if (j >= wc) return j - ((j - wc) / C + 1) * C;
  return j;
}

template <typename T, int C, int R>
__global__ void __launch_bounds__(kThreads, min_blocks<T>(R))
    unsharp_rows_kernel(const Params<T> p) {
  using E = Elem<T>;
  constexpr int N = 2 * R + 1;             // taps, and rows in the window
  constexpr int HG = (R * C + G - 1) / G;  // halo groups on each side
  constexpr int kSlots = ring_slots(N);
  constexpr int kAhead = kSlots - 1;       // the slot read last is refilled
  constexpr int kStep = N % kSlots == 0 ? 0 : N;  // rb's move a pass (else kSlots % N == 0)
  constexpr int kEntries = kSlots * kThreads;     // ring entries
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);        // [kSlots][kThreads]
  float4* vrow = reinterpret_cast<float4*>(ring + kEntries * E::kEntryBytes);  // [2][kThreads]
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
    const int gofs = G * g;              // its first flat column
    const bool writer = tid >= HG && tid < HG + ng;
    const bool vec = p.vec && g >= 0 && gofs < p.WC;
    int col[G];
#pragma unroll
    for (int q = 0; q < G; ++q) col[q] = clamp_col<C>(gofs + q, p.WC);

    const int L = rows + 2 * R;                      // input rows of the run
    const int copied = tid < ng + 2 * HG ? L : 0;    // the rows this thread copies
    // input row n of the run (edge-replicated above and below the frame)
    auto row_of = [&](int n) { return xf + (long long)min(max(y0 - R + n, 0), p.H - 1) * p.WC; };
    // input row n into ring slot s
    auto issue = [&](int n, int s) {
      if (n < copied) E::copy(ring, s * kThreads + tid, kEntries, row_of(n), gofs, col, vec);
    };
#pragma unroll
    for (int n = 0; n < kAhead; ++n) {
      issue(n, n);
      cp_async_commit();
    }

    float4 win[N];
    int rb = 0;  // the ring slot of input row base
    for (int base = 0; base < L; base += N) {
#pragma unroll
      for (int ph = 0; ph < N; ++ph) {
        const int n = base + ph;
        if (n >= L) break;
        cp_async_wait<kAhead - 1>();  // input row n, this thread's group
        const int s = rb + ph % kSlots;
        win[ph] = E::read(ring, s * kThreads + tid, kEntries, vec, row_of(n), col);
        // into the slot read last, that of row n - 1
        issue(n + kAhead, ph % kSlots ? s - 1 : rb == 0 ? kSlots - 1 : rb - 1);
        cp_async_commit();
        if (n < 2 * R) continue;
        // output row y0 + n - 2R: window slot (ph + 1 + t) % N holds its
        // input row - R + t
        float v[G];
#ifdef VR_PROBE_NO_MATH
#pragma unroll
        for (int q = 0; q < G; ++q) v[q] = lane(win[(ph + 1 + R) % N], q);
#else
#pragma unroll
        for (int q = 0; q < G; ++q) v[q] = __fmul_rn(lane(win[(ph + 1) % N], q), p.taps.k[0]);
#pragma unroll
        for (int t = 1; t < N; ++t)
#pragma unroll
          for (int q = 0; q < G; ++q)
            v[q] = __fadd_rn(v[q], __fmul_rn(lane(win[(ph + 1 + t) % N], q), p.taps.k[t]));
#endif
        float4* vb = vrow + parity * kThreads;
        parity ^= 1;
        vb[tid] = make_float4(v[0], v[1], v[2], v[3]);
        __syncthreads();
        if (!writer) continue;
        const float4 center = win[(ph + 1 + R) % N];
        float res[G];
#ifdef VR_PROBE_NO_MATH
#pragma unroll
        for (int q = 0; q < G; ++q) res[q] = v[q];
#else
        // the groups tid - HG .. tid + HG (its own from registers); tap t
        // of lane q is value G * HG + q - R * C + t * C of them
        float h[G * (2 * HG + 1)];
#pragma unroll
        for (int c = 0; c < 2 * HG + 1; ++c) {
          const float4 a = c == HG ? make_float4(v[0], v[1], v[2], v[3]) : vb[tid - HG + c];
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
        // the threshold (uniform) chooses one of two epilogues, so that
        // the usual threshold 0 pays no test per value
        auto epilogue = [&](auto with_threshold) {
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const float c = lane(center, q);
            float hp = __fsub_rn(c, blur[q]);
            if constexpr (decltype(with_threshold)::value)
              if (!(fabsf(hp) >= p.threshold)) hp = 0.f;
            const float o_ = __fadd_rn(c, __fmul_rn(p.amount, hp));
            res[q] = fminf(fmaxf(o_, 0.f), 1.f);
          }
        };
        if (p.threshold > 0.f)
          epilogue(std::true_type{});
        else
          epilogue(std::false_type{});
#endif
        T* dst = yf + (long long)(y0 + n - 2 * R) * p.WC + gofs;
        if (vec) {
          E::put(dst, make_float4(res[0], res[1], res[2], res[3]));
        } else {
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (gofs + q < p.WC) E::store(dst + q, res[q]);
        }
      }
      if constexpr (kStep != 0) rb = rb + kStep == kSlots ? 0 : rb + kStep;
    }
  }
}

// the ring of groups, then two rows of G fp32 vertical sums
template <typename T, int R>
constexpr int smem_bytes() {
  return ring_slots(2 * R + 1) * kThreads * Elem<T>::kEntryBytes +
         2 * kThreads * G * static_cast<int>(sizeof(float));
}

// above 48 KB a block's dynamic shared memory has to be asked for
template <typename T, int R>
cudaError_t allow_smem(void (*kernel)(Params<T>)) {
  if (smem_bytes<T, R>() <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T, R>());
}

template <typename T, int C, int R>
cudaError_t launch(Params<T>& p, int B, cudaStream_t stream) {
  constexpr int HG = (R * C + G - 1) / G;
  const int wcg = (p.WC + G - 1) / G;
  const int sg_max = kThreads - 2 * HG;
  p.nstrips = (wcg + sg_max - 1) / sg_max;
  p.sg = (wcg + p.nstrips - 1) / p.nstrips;
  // whole 128-byte lines per strip where that costs no strip
  constexpr int line = 128 / (G * static_cast<int>(sizeof(T)));  // groups a line
  const int sgl = (p.sg + line - 1) / line * line;
  if (sgl <= sg_max && (wcg + sgl - 1) / sgl == p.nstrips) p.sg = sgl;
  p.total = (long long)B * p.nstrips * p.H;
  constexpr int smem = smem_bytes<T, R>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = allow_smem<T, R>(unsharp_rows_kernel<T, C, R>);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
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

// f(std::integral_constant<int, r>) for a runtime r in [0, R]
template <int R, typename F>
cudaError_t with_radius(int r, F&& f) {
  if constexpr (R > 0) {
    if (r != R) return with_radius<R - 1>(r, f);
  }
  return f(std::integral_constant<int, R>{});
}

template <typename T>
int run(const T* x, T* y, int B, int H, int W, int C, int radius,
        const float* taps, float amount, float threshold, void* stream) {
  if (radius < 0 || radius > kMaxRadius || B < 1 || H < 1 || W < 1 || C != 3 ||
      (long long)W * C > (1 << 30))
    return cudaErrorInvalidValue;
  Params<T> p;
  p.x = x;
  p.y = y;
  p.H = H;
  p.WC = W * C;
  constexpr int align = G * static_cast<int>(sizeof(T));
  p.vec = p.WC % G == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
          reinterpret_cast<uintptr_t>(y) % align == 0;
  p.amount = amount;
  p.threshold = threshold;
  for (int i = 0; i < 2 * radius + 1; ++i) p.taps.k[i] = taps[i];
  return with_radius<kMaxRadius>(radius, [&](auto rc) {
    return launch<T, 3, decltype(rc)::value>(p, B, static_cast<cudaStream_t>(stream));
  });
}

// The instance's registers a thread and resident blocks per SM at radius r
// (C = 3), as the runtime reports them for the current device.
template <typename T>
int info(int radius, int* regs, int* blocks_per_sm) {
  if (radius < 0 || radius > kMaxRadius) return cudaErrorInvalidValue;
  return with_radius<kMaxRadius>(radius, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    const auto kernel = unsharp_rows_kernel<T, 3, R>;
    cudaFuncAttributes a;
    cudaError_t e = allow_smem<T, R>(kernel);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    *regs = a.numRegs;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                         smem_bytes<T, R>());
  });
}

}  // namespace
