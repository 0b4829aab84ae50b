// K1, narrow route: the two narrow shapes of K1's function on every
// default path, each on a kernel of its own.
//
//   stem_kernel   cin 3 or 12 -> cout 64, act none / lrelu / PReLU, in bf16
//                 or fp32 (two instances of one template): RRDBNet's
//                 conv_first (cin 12 after x2plus's pixel unshuffle) and
//                 SRVGG's conv_in, at --precision bf16 / int8 and fp32
//   last_kernel   cin 64 -> cout 3, bf16: RRDBNet's conv_last, after conv_hr
//
// Replaces, for these calls, the Pallas convs of video_restore_tpu/ops:
//   pallas_tail.py conv3x3_fused (the stem form of the conv)
//   pallas_tail.py tail_fused_raw / tail_fused (their conv_last stage)
// Neither the tensor-core route (conv3x3_mma.cu: cin a multiple of 16,
// cout 32 or 64) nor the wide fp32 tile of conv3x3.cu suits them: cin 3
// pads 13 of 16 channels and cout 3 pads 5 of 8 lanes there.
//
// Exactness. Every output value is one fp32 accumulator starting at 0,
// fmaf(x, w, acc) over ci ascending, then ky, then kx (taps outside the
// frame multiply a zero, as in conv3x3.cu), then conv3x3.cu's epilogue:
// __fadd_rn of the bias, its lrelu / PReLU and, in bf16, one
// round-to-nearest to bf16 (in fp32 nothing is rounded after the sum).
// That is conv3x3.cu's order for any chunking of ci, so the outputs equal
// the fp32-FMA kernel's bit for bit in either type, and conv_last's equal
// K6's conv_last stage (tail_fused_mma.cu sums in the same order).
//
// What bounds them on the H100. A stem does 27 (cin 12: 108) FMAs per
// output value and writes 128 bytes per pixel in bf16, 256 in fp32: at
// 1080p its stores (265 MB, 0.079 ms at 3.35 TB/s; fp32 531 MB and 25 MB
// of input, 0.166 ms) and its fp32 FMAs (0.107 ms at 67 TFLOP/s) are near
// each other, and at fp32 the bytes bound it. A block of 256 threads keeps
// every weight resident in shared memory as fp32 (in bf16 the couts
// permuted so that a warp's eight 16-byte weight reads are one contiguous
// 128 bytes; in fp32 they lie in order), stages each 10 x 34 input patch
// as a contiguous run of cin x 34 values per row (cin 3: 6-byte pixels in
// bf16, 12-byte in fp32, at any pixel stride) into fp32 planes, and gives
// each thread 8 pixels x 8 couts, so each 16-byte weight read feeds 32
// FMAs; the next tile's patch is loaded into registers while this one's
// FMAs run, and each thread stores whole 16-byte pieces: in bf16 its 8
// couts 8 g .. 8 g + 7 (a warp one 4 KB output row at a time), in fp32
// couts 4 g .. 4 g + 3 and 32 + 4 g .. 32 + 4 g + 3, so that each of the
// two stores of a warp writes whole 128-byte halves of four pixels.
// Persistent blocks. Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// [k1n], [kernel32]): the bf16 stem 0.213-0.218 ms against the fma
// kernel's 1.325-1.364; the fp32 stem 0.223 ms (74% of its 0.166 ms bound)
// against forced fma's 1.631 and F.conv2d's fp32 1.072 in the same run,
// bit-equal to fma.
//
// conv_last reads 64 channels and writes 3 per pixel: at 4320x7680 that is
// 4.25 GB in (1.27 ms) and 57.3 G useful FMAs (1.71 ms at the fp32 peak),
// so it is bound by the FMAs, and by how the input reaches them: loads of
// 16 bytes (8 channels) of each 128-byte pixel, as a stage of 8 channels
// would make them, are each a line request of its own, which the load path
// serves far below the memory's rate; 64 bytes a pixel keep the loads
// under the FMAs' time. So a block of 128 threads owns a 32 x
// 32 output tile and brings its 34 x 34 patch in two stages of 32 channels,
// 64 bytes a pixel by cp.async, into one pixel-major buffer (76 KB, two
// blocks per SM: one sums while the other waits for its stage), with the
// 16-byte chunks and pixel slots XOR-swizzled so that the threads' 16-byte
// reads are free of bank conflicts. A thread owns 2 rows x 4 pixels x the
// 3 couts (24 accumulators, no padded lanes): per 8 channels it reads its
// 4 x 6 window pixels as 16 bytes apiece, and per channel the 9 taps'
// weights (fp32 float4s, broadcasts) once for both rows, 216 FMAs for
// them. Persistent blocks. fp32 conv_last is not built here: its 64-byte
// stages would double (conv3x3.cu takes it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// T: bf16 or float, every operand in it
template <typename T>
struct NarrowArgsT {
  const T* x;      // (B, H, W, >=cin), pixel stride xs
  const T* w;      // (3, 3, cin, cout) contiguous
  const T* b;      // (cout,)
  const T* alpha;  // (cout,) for PReLU, else null
  T* y;            // (B, H, W, >=cout), pixel stride ys
  int B, H, W;
  long long xs, ys;
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
};
using NarrowArgs = NarrowArgsT<bf16>;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// bf16 bit patterns as fp32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// conv3x3.cu's epilogue for a call without residuals
__device__ __forceinline__ float epilogue(float acc, float bias, float alpha, int act) {
  float v = __fadd_rn(acc, bias);
  if (act == 1) {
    v = v >= 0.f ? v : __fmul_rn(0.2f, v);
  } else if (act == 2) {
    v = v > 0.f ? v : __fmul_rn(v, alpha);
  }
  return v;
}

struct TileAt {
  int n, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(int tile, int tiles_x, int per_image, int TH,
                                          int TW) {
  TileAt t;
  t.n = tile / per_image;
  const int r = tile - t.n * per_image;
  const int ty = r / tiles_x;
  t.oy0 = ty * TH;
  t.ox0 = (r - ty * tiles_x) * TW;
  return t;
}

// ---- the stems: cin 3 or 12 -> cout 64 -----------------------------------

namespace stem {

constexpr int kThreads = 256;
constexpr int COUT = 64;
constexpr int TW = 32, TH = 8;  // a thread: 8 pixels of one row x 8 couts
constexpr int PW = TW + 2, PH = TH + 2;
constexpr int PITCH = 36;  // floats per patch row: 16-byte aligned rows

template <int CIN>
struct Shape {
  static constexpr int ELEMS = PH * PW * CIN;  // one tile's input patch
  static constexpr int PER_THREAD = (ELEMS + kThreads - 1) / kThreads;
  static constexpr int WTS = 9 * CIN * COUT;
};

// A thread's couts: cout_of(g, q) for q = 0 .. 7, and where cout co lies in
// a tap's row of s_w: at pos(co), so that the thread reads q = 0 .. 3 as
// one float4 at 4 g and q = 4 .. 7 as one at 32 + 4 g. bf16: couts 8 g .. 8
// g + 7 (cout 8 g + 4 h + j at 32 h + 4 g + j), whose 16 output bytes are
// one store; fp32: 4 g + j and 32 + 4 g + j in place, whose 32 output bytes
// are two stores, each of a warp's eight groups one contiguous 128 bytes.
template <typename T>
struct Couts {
  static __device__ __forceinline__ int cout_of(int g, int q) { return 8 * g + q; }
  static __device__ __forceinline__ int pos(int co) {
    return ((co >> 2) & 1) * 32 + (co >> 3) * 4 + (co & 3);
  }
};
template <>
struct Couts<float> {
  static __device__ __forceinline__ int cout_of(int g, int q) {
    return (q >> 2) * 32 + 4 * g + (q & 3);
  }
  static __device__ __forceinline__ int pos(int co) { return co; }
};

// the raw bits a thread prefetches of each patch value (bf16: 16, fp32: 32)
template <typename T>
struct Raw {
  using type = unsigned short;
  static __device__ __forceinline__ float f(type v) { return __uint_as_float((uint32_t)v << 16); }
};
template <>
struct Raw<float> {
  using type = float;
  static __device__ __forceinline__ float f(type v) { return v; }
};

// cin 12 holds 16 prefetched values a thread: one block per SM, no spills
template <typename T, int CIN>
__global__ void __launch_bounds__(kThreads, CIN <= 3 ? 2 : 1)
    stem_kernel(const NarrowArgsT<T> a, int tiles_x, int per_image, int tiles) {
  using S = Shape<CIN>;
  using C = Couts<T>;
  using R = Raw<T>;
  __shared__ __align__(16) float s_in[CIN * PH * PITCH];  // [ci][row][col]
  __shared__ __align__(16) float s_w[S::WTS];             // [tap][ci][pos(cout)]
  __shared__ float s_b[COUT], s_a[COUT];

  const int tid = threadIdx.x;
  for (int i = tid; i < S::WTS; i += kThreads) {
    const int co = i & (COUT - 1);
    s_w[(i - co) + C::pos(co)] = to_f(a.w[i]);
  }
  if (tid < COUT) {
    s_b[tid] = to_f(a.b[tid]);
    s_a[tid] = a.alpha ? to_f(a.alpha[tid]) : 0.f;
  }

  const int cg = tid & 7, pg = tid >> 3;
  const int prow = pg >> 2, pcol = (pg & 3) * 8;
  const typename R::type* __restrict__ xr = reinterpret_cast<const typename R::type*>(a.x);

  // the patch, element e = (row * PW + px) * CIN + ci: each patch row is one
  // run of PW * CIN values, contiguous in memory when the pixel stride is cin
  typename R::type pre[S::PER_THREAD];
  auto fetch = [&](int tile) {
    const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
#pragma unroll
    for (int k = 0; k < S::PER_THREAD; ++k) {
      const int e = tid + k * kThreads;
      typename R::type v = 0;
#ifndef VR_PROBE_NO_LOAD
      if (e < S::ELEMS) {
        const int row = e / (PW * CIN);
        const int rem = e - row * (PW * CIN);
        const int px = rem / CIN, ci = rem - px * CIN;
        const int fy = t.oy0 + row - 1, fx = t.ox0 + px - 1;
        if (fy >= 0 && fy < a.H && fx >= 0 && fx < a.W)
          v = xr[(((long long)t.n * a.H + fy) * a.W + fx) * a.xs + ci];
      }
#endif
      pre[k] = v;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int k = 0; k < S::PER_THREAD; ++k) {
      const int e = tid + k * kThreads;
      if (e < S::ELEMS) {
        const int row = e / (PW * CIN);
        const int rem = e - row * (PW * CIN);
        const int px = rem / CIN, ci = rem - px * CIN;
        s_in[(ci * PH + row) * PITCH + px] = R::f(pre[k]);
      }
    }
  };

  int tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's FMAs are done with s_in
    put();
    __syncthreads();
    if (tile + (int)gridDim.x < tiles) fetch(tile + gridDim.x);

    float acc[8][8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
#ifndef VR_PROBE_NO_FMA
#pragma unroll (CIN <= 3 ? CIN : 1)
    for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* row = s_in + (ci * PH + prow + ky) * PITCH + pcol;
        const float4 r0 = *reinterpret_cast<const float4*>(row);
        const float4 r1 = *reinterpret_cast<const float4*>(row + 4);
        const float2 r2 = *reinterpret_cast<const float2*>(row + 8);
        const float xin[10] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = s_w + ((ky * 3 + kx) * CIN + ci) * COUT + cg * 4;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(xin[p + kx], wv[q], acc[p][q]);
        }
      }
    }
#endif

    const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
    const int oy = t.oy0 + prow;
    if (oy < a.H) {
      const long long row0 = ((long long)t.n * a.H + oy) * a.W;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int ox = t.ox0 + pcol + p;
        if (ox >= a.W) continue;
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int co = C::cout_of(cg, q);
          v[q] = epilogue(acc[p][q], s_b[co], s_a[co], a.act);
        }
        T* dst = a.y + (row0 + ox) * a.ys;
        if constexpr (sizeof(T) == 2) {
          uint32_t packed[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
            packed[h] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          *reinterpret_cast<uint4*>(dst + C::cout_of(cg, 0)) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        } else {
          *reinterpret_cast<float4*>(dst + C::cout_of(cg, 0)) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + C::cout_of(cg, 4)) =
              make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
}

}  // namespace stem

// ---- conv_last: cin 64 -> cout 3 -----------------------------------------

namespace last {

constexpr int kThreads = 128;
constexpr int CIN = 64, COUT = 3;
// a thread: 2 rows x 4 pixels; a warp: 4 x-groups x 8 row pairs (16 x 16
// pixels); the block: 2 x 2 warps
constexpr int TW = 32, TH = 32, P = 4;
constexpr int PW = TW + 2, PH = TH + 2;  // the 34 x 34 input patch
constexpr int RP = 36;  // pixel slots per patch row in shared memory (even)
constexpr int CS = 32;                   // channels per stage: 64 bytes per pixel
constexpr int STAGE = PH * RP * CS * 2;  // bytes of one stage
constexpr int W_OFF = STAGE;                  // [ci][tap] float4 (w0, w1, w2, 0)
constexpr int BA_OFF = W_OFF + CIN * 9 * 16;  // bias, alpha as float4
constexpr int SMEM = BA_OFF + 2 * 16;

// byte offset of 16-byte chunk c (channels 8c..8c+7 of the stage) of patch
// pixel (row, col): pixel-major, 64 bytes a pixel; the chunk index XORed
// with (p >> 2) & 3 and the pixel's slot with bit 1 of the row, so that a
// quarter warp's 16-byte reads (4 x-groups x 2 row pairs) fall on 8
// different 16-byte bank groups
__device__ __forceinline__ uint32_t chunk_at(int row, int col, int c) {
  const int p = row * RP + col;
  return (uint32_t)((p ^ ((row >> 1) & 1)) * 64 + ((c ^ ((p >> 2) & 3)) << 4));
}

__device__ __forceinline__ float bf_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return (i & 1) ? bf_hi(w) : bf_lo(w);
}

__global__ void __launch_bounds__(kThreads, 2)
    last_kernel(const NarrowArgs a, int tiles_x, int per_image, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_w = reinterpret_cast<float4*>(smem + W_OFF);
  float4* s_ba = reinterpret_cast<float4*>(smem + BA_OFF);
  const uint32_t s_base = mma_tile::smem_u32(smem);

  const int tid = threadIdx.x;
  for (int i = tid; i < CIN * 9; i += kThreads) {
    const int ci = i / 9, tap = i - ci * 9;
    const bf16* wp = a.w + (tap * CIN + ci) * COUT;
    s_w[i] = make_float4(__bfloat162float(wp[0]), __bfloat162float(wp[1]),
                         __bfloat162float(wp[2]), 0.f);
  }
  if (tid < 2) {
    const bf16* v = tid == 0 ? a.b : a.alpha;
    s_ba[tid] = v ? make_float4(__bfloat162float(v[0]), __bfloat162float(v[1]),
                                __bfloat162float(v[2]), 0.f)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // one stage: channels [c0, c0 + 32) of a tile's patch, zeros outside the
  // frame (the SAME padding); warp w copies patch rows w, w + 4, ..., four
  // lanes a pixel (64 bytes), eight pixels an instruction
  const int lane_c = tid & 3, lane_p = (tid & 31) >> 2;
  auto issue = [&](int tile, int c0) {
#ifndef VR_PROBE_NO_LOAD
    const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
    for (int pr = tid >> 5; pr < PH; pr += kThreads / 32) {
      const int fy = t.oy0 + pr - 1;
      const bool row_in = fy >= 0 && fy < a.H;
      const bf16* src_row =
          a.x + ((long long)t.n * a.H + (row_in ? fy : 0)) * a.W * a.xs + c0 + lane_c * 8;
#pragma unroll
      for (int k = 0; k < (PW + 7) / 8; ++k) {
        const int pc = lane_p + 8 * k;
        if (pc < PW) {
          const int fx = t.ox0 + pc - 1;
          const bool in = row_in && fx >= 0 && fx < a.W;
          mma_tile::cp_async16(s_base + chunk_at(pr, pc, lane_c),
                               in ? src_row + (long long)fx * a.xs : a.x, in);
        }
      }
    }
#endif
    mma_tile::cp_async_commit();
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = (warp & 1) * 16 + (lane & 3) * P;  // pixels col0 .. col0 + 3
  const int row0 = ((warp >> 1) * 8 + (lane >> 2)) * 2;  // rows row0, row0 + 1

  float acc[2][P][COUT];
  // the FMAs of one stage: 4 groups of 8 channels, each group's 4 x 6 window
  // pixels read as 16 bytes (8 channels) apiece; per channel the 9 taps'
  // weights once, for both rows
  auto stage = [&](int c0) {
#ifndef VR_PROBE_NO_FMA
#pragma unroll 1
    for (int g = 0; g < CS / 8; ++g) {
      uint4 win[4][P + 2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < P + 2; ++j)
          win[r][j] = *reinterpret_cast<const uint4*>(smem + chunk_at(row0 + r, col0 + j, g));
      const float4* wg = s_w + (c0 + 8 * g) * 9;
#pragma unroll
      for (int cl = 0; cl < 8; ++cl) {
        float4 w9[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) w9[tap] = wg[cl * 9 + tap];
        // input row r feeds output row 0 at ky = r and output row 1 at
        // ky = r - 1, so each output sees its taps in (ky, kx) order
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float xin[P + 2];
#pragma unroll
          for (int j = 0; j < P + 2; ++j) xin[j] = bf_at(win[r][j], cl);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if (r < 3) {
              const float4 w = w9[r * 3 + kx];
#pragma unroll
              for (int p = 0; p < P; ++p) {
                acc[0][p][0] = fmaf(xin[p + kx], w.x, acc[0][p][0]);
                acc[0][p][1] = fmaf(xin[p + kx], w.y, acc[0][p][1]);
                acc[0][p][2] = fmaf(xin[p + kx], w.z, acc[0][p][2]);
              }
            }
            if (r > 0) {
              const float4 w = w9[(r - 1) * 3 + kx];
#pragma unroll
              for (int p = 0; p < P; ++p) {
                acc[1][p][0] = fmaf(xin[p + kx], w.x, acc[1][p][0]);
                acc[1][p][1] = fmaf(xin[p + kx], w.y, acc[1][p][1]);
                acc[1][p][2] = fmaf(xin[p + kx], w.z, acc[1][p][2]);
              }
            }
          }
        }
      }
    }
#endif
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int q = 0; q < COUT; ++q) acc[r][p][q] = 0.f;
    // one stage buffer: the other block on the SM sums while this one waits
#pragma unroll 1
    for (int c0 = 0; c0 < CIN; c0 += CS) {
      issue(tile, c0);
      mma_tile::cp_async_wait<0>();
      __syncthreads();
      stage(c0);
      __syncthreads();
    }

    const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
    const float4 bias = s_ba[0], alpha = s_ba[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int oy = t.oy0 + row0 + r;
      if (oy >= a.H) continue;
      const long long rowp = ((long long)t.n * a.H + oy) * a.W;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int ox = t.ox0 + col0 + p;
        if (ox >= a.W) continue;
        bf16* dst = a.y + (rowp + ox) * a.ys;
        dst[0] = __float2bfloat16_rn(epilogue(acc[r][p][0], bias.x, alpha.x, a.act));
        dst[1] = __float2bfloat16_rn(epilogue(acc[r][p][1], bias.y, alpha.y, a.act));
        dst[2] = __float2bfloat16_rn(epilogue(acc[r][p][2], bias.z, alpha.z, a.act));
      }
    }
  }
}

}  // namespace last

// a persistent grid: as many blocks as fit on the card at once, at most one
// per tile
template <typename K, typename A>
cudaError_t launch(K kernel, int threads, int smem, const A& a, int TH, int TW,
                   cudaStream_t stream) {
  const int tiles_x = (a.W + TW - 1) / TW;
  const int per_image = tiles_x * ((a.H + TH - 1) / TH);
  const long long tiles = (long long)per_image * a.B;
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, threads, smem, stream>>>(a, tiles_x, per_image, (int)tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, then the arguments of vr_conv3x3_mma
// (vr_conv3x3's). Takes the stems (cin 3 or 12, cout 64, y 16-byte aligned
// with a pixel stride of whole 16-byte pieces: a multiple of 8 elements in
// bf16, of 4 in fp32) in either type, and bf16 conv_last (cin 64, cout 3,
// x 16-byte aligned with a pixel stride that is a multiple of 8), without
// residuals or upsampling; returns cudaErrorInvalidValue for any other
// call. Returns the cudaError_t of the launch.
int vr_conv3x3_narrow(int dtype, const void* x, const void* w, const void* b,
                      const void* alpha, const void* r1, const void* r2, void* y, int B, int H,
                      int W, int cin, int cout, long long xs, long long ys, long long r1s,
                      long long r2s, int act, int up2, float s1, float s2, void* stream) {
  (void)r1s; (void)r2s; (void)s1; (void)s2;
  if ((dtype != 0 && dtype != 1) || r1 || r2 || up2 || act < 0 || act > 2 ||
      (act == 2 && !alpha))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stem_call = cout == stem::COUT && (cin == 3 || cin == 12);
  if (dtype == 0) {
    // fp32: the stems only
    if (!stem_call || reinterpret_cast<uintptr_t>(y) % 16 || ys % 4 || xs < cin)
      return cudaErrorInvalidValue;
    NarrowArgsT<float> a;
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.b = static_cast<const float*>(b);
    a.alpha = static_cast<const float*>(alpha);
    a.y = static_cast<float*>(y);
    a.B = B; a.H = H; a.W = W;
    a.xs = xs; a.ys = ys;
    a.act = act;
    return cin == 3
               ? launch(stem::stem_kernel<float, 3>, stem::kThreads, 0, a, stem::TH, stem::TW, s)
               : launch(stem::stem_kernel<float, 12>, stem::kThreads, 0, a, stem::TH, stem::TW,
                        s);
  }
  NarrowArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.alpha = static_cast<const bf16*>(alpha);
  a.y = static_cast<bf16*>(y);
  a.B = B; a.H = H; a.W = W;
  a.xs = xs; a.ys = ys;
  a.act = act;
  if (stem_call) {
    if (reinterpret_cast<uintptr_t>(y) % 16 || ys % 8 || xs < cin) return cudaErrorInvalidValue;
    return cin == 3
               ? launch(stem::stem_kernel<bf16, 3>, stem::kThreads, 0, a, stem::TH, stem::TW, s)
               : launch(stem::stem_kernel<bf16, 12>, stem::kThreads, 0, a, stem::TH, stem::TW,
                        s);
  }
  if (cin == last::CIN && cout == last::COUT) {
    if (reinterpret_cast<uintptr_t>(x) % 16 || xs % 8 || ys < cout) return cudaErrorInvalidValue;
    return launch(last::last_kernel, last::kThreads, last::SMEM, a, last::TH, last::TW, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
