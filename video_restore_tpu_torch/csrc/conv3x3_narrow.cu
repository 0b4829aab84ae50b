// K1, narrow route: the two narrow shapes of K1's function on every
// default path, each on a kernel of its own.
//
//   stem_kernel   cin 3 or 12 -> cout 64, act none / lrelu / PReLU, in bf16
//                 or fp32 (two instances of one template): RRDBNet's
//                 conv_first (cin 12 after x2plus's pixel unshuffle) and
//                 SRVGG's conv_in, at --precision bf16 / int8 and fp32
//   last_kernel   cin 64 -> cout 3, bf16: RRDBNet's conv_last, after conv_hr
//   last32_kernel cin 64 -> cout 3, fp32, fed by TMA: RRDBNet's conv_last at
//                 --precision fp32 (the chain tail's third launch)
//
// Replaces, for these calls, the Pallas convs of video_restore_tpu/ops:
//   pallas_tail.py conv3x3_fused (the stem form of the conv; :767)
//   pallas_tail.py tail_fused_raw / tail_fused (their conv_last stage,
//   :209-212; :266, :425)
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
// K6's conv_last stage (tail_fused_mma.cu sums in the same order) and, in
// fp32, the one-launch tail's (tail_fused_bf16x3.cu). For this reason no
// conv_last runs on the tensor cores: 3 couts pad to n8, and a wgmma or
// bf16x3 form would change the bits of every fp32 RRDBNet frame.
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
// them. Persistent blocks.
//
// The fp32 conv_last reads twice the bytes: 8.49 GB in and 0.40 GB out at
// 4320x7680, 2.654 ms at 3.35 TB/s, above its 1.71 ms of FMAs, so the bytes
// bound it. The bf16 kernel's stages would double (two of 32 fp32 channels
// are 148 KB). Its design:
//  - Stages of 16 channels, 64 bytes a pixel, four a tile, copied by TMA: a
//    4-D map over x (C, W, H, B) at x's pixel stride, a (16, 35, 34, 1) box
//    from (oy0 - 1, ox0 - 1), whose zero fill outside the frame is the SAME
//    padding. No thread computes an input address.
//  - The box lands in the 64-byte swizzle (bits 4-5 of the address XOR bits
//    7-8), which makes the bank group of a 16-byte piece a function of its
//    pixel's index mod 8. A thread owns 1 row x 8 pixels x the 3 couts (24
//    accumulators, no padded lanes), a quarter warp 8 consecutive rows; the
//    box is 35 pixels wide (one more than the patch) so that the row pitch
//    is odd and those rows fall on 8 different bank groups: the window reads
//    are free of conflicts. A thread keeps its 24 swizzled window offsets
//    and per chunk XORs in the chunk's index.
//  - Two slots of 76 KB and a producer warp: one thread issues each stage's
//    copy as soon as the four consumer warps release its slot (an mbarrier
//    pair a slot), so the next stage is in flight while this one is summed.
//    One block an SM (161,856 bytes; a third slot does not fit).
//  - Per chunk of 4 channels a thread reads its 3 x 10 window as 16-byte
//    pieces, and per channel its 27 weights as 7 broadcast float4s (resident,
//    7 KB): 216 FMAs a channel for 7.5 window and 7 weight reads.
//  - Each thread writes its 24 consecutive output floats as six 16-byte
//    stores where the output is a contiguous 3-channel tensor.
// 161,856 bytes of shared memory, 1 block an SM. Measured (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_smoke.py [k1n], [kernel32]): 3.332-3.359 ms at
// 1x4320x7680 (80% of the 2.654 ms bound) against forced fma's
// 23.659-24.040 and F.conv2d's 48.863-49.263, bit-equal to fma. What holds
// it is device memory (tools/probe_k1n.py): with every copy served from L2
// it takes the FMAs' time (2.80 against 2.75 ms without copies), and the
// copies alone take as long as the whole kernel. An L2 prefetch of the next
// tile's whole pixels, an L2 promotion of 64 or 256 bytes in place of 128,
// and walking the tiles in bands of 2-8 tile rows were each slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

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

// ---- conv_last in fp32: cin 64 -> cout 3, fed by TMA ----------------------

namespace last32 {

constexpr int kConsumers = 128;            // 4 warps; a thread: 1 row x 8 pixels
constexpr int kThreads = kConsumers + 32;  // and a producer warp (one thread copies)
constexpr int CIN = 64, COUT = 3;
constexpr int TW = 32, TH = 32, P = 8;
constexpr int PH = TH + 2;  // patch rows
// pixels a box row: the 34 of the patch and one more, so that the row pitch
// (35 pixels of 64 bytes) is odd and eight rows fall on eight bank groups
constexpr int BW = TW + 3;
constexpr int CS = 16;     // channels a stage: 64 bytes a pixel
constexpr int DEPTH = 2;   // stages held: a third does not fit
constexpr int BOX_BYTES = CS * 4 * BW * PH;             // 76,160
constexpr int SLOT = (BOX_BYTES + 1023) / 1024 * 1024;  // 76,800
constexpr int WPC = 28;  // fp32 weights a channel: [ky][kx][co], one pad
constexpr int W_OFF = DEPTH * SLOT;
constexpr int BA_OFF = W_OFF + CIN * WPC * 4;  // bias, alpha as float4
constexpr int BAR_OFF = BA_OFF + 2 * 16;       // full[DEPTH], empty[DEPTH]
constexpr int SMEM = 1024 + BAR_OFF + 2 * DEPTH * 8;  // 1024: the alignment
// the launch plan ops/tail.py::last32_plan sends: x's 4-D map (dims, byte
// strides of dims 1-3, box), the grid, the tile
constexpr int PLAN_LEN = 4 + 3 + 4 + 1 + 2;

__global__ void __launch_bounds__(kThreads, 1)
    last32_kernel(const __grid_constant__ CUtensorMap tm_x, const NarrowArgsT<float> a,
                  int tiles_x, int per_image, int tiles) {
  using namespace wgmma_tile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the slots on 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  float* s_w = reinterpret_cast<float*>(smem + W_OFF);
  float4* s_ba = reinterpret_cast<float4*>(smem + BA_OFF);
  const uint32_t full0 = base + BAR_OFF, empty0 = full0 + DEPTH * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < CIN * WPC; i += kThreads) {
    const int ci = i / WPC, k = i - ci * WPC;  // k = (ky * 3 + kx) * 3 + co
    s_w[i] = k < 27 ? a.w[((k / 3) * CIN + ci) * COUT + k % 3] : 0.f;
  }
  if (tid < 2) {
    const float* v = tid == 0 ? a.b : a.alpha;
    s_ba[tid] = v ? make_float4(v[0], v[1], v[2], 0.f) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: one thread copies each stage, channels [16 k, 16 k + 16)
    // of a tile's patch, (oy0 - 1, ox0 - 1) on; the map's zero fill outside
    // the frame is the SAME padding ----
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#ifdef VR_PROBE_L2  // tools/probe_k1n.py: every copy reads one of the first 64
                    // tiles' patches, which stay in L2 (no valid output)
        const TileAt t = tile_at(tile % 64, tiles_x, per_image, TH, TW);
#else
        const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
#endif
        for (int k = 0; k < CIN / CS; ++k) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
#ifdef VR_PROBE_NO_LOAD  // tools/probe_k1n.py: the stages arrive unfilled
          mbar_arrive(full0 + 8 * s);
#else
          mbar_expect_tx(full0 + 8 * s, BOX_BYTES);
          tma_load_4d(base + s * SLOT, &tm_x, full0 + 8 * s, k * CS, t.ox0 - 1, t.oy0 - 1,
                      t.n);
#endif
          if (++s == DEPTH) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: output row orow of the tile, pixels col0 .. col0 + 7; a
  // quarter warp is eight rows, which the odd pitch puts on eight 16-byte
  // bank groups ----
  const int orow = warp * 8 + (lane & 7), col0 = (lane >> 3) * P;
  // the window's 16-byte pieces at slot 0, chunk 0, as offsets from base:
  // patch pixel (orow + ky, col0 + j) in the 64-byte swizzle TMA writes
  // (bits 4-5 of the address XOR bits 7-8; base is on 1024 bytes); chunk g
  // of slot s lies at (at + s * SLOT) ^ (g << 4), pixel j + 8 512 bytes past
  // pixel j
  uint32_t at[3][8];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      at[ky][j] = swizzle<64>((uint32_t)(((orow + ky) * BW + col0 + j) * 64));

  float acc[P][COUT];
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < COUT; ++q) acc[p][q] = 0.f;
#pragma unroll 1
    for (int k = 0; k < CIN / CS; ++k) {
      mbar_wait(full0 + 8 * s, ph);
#ifndef VR_PROBE_NO_FMA
      const uint32_t off = s * SLOT;
      // four chunks of 4 channels: each chunk's 3 x 10 window pieces (16
      // bytes, 4 channels, apiece), then per channel its 27 weights (7
      // broadcast float4s) and 216 FMAs, in conv3x3.cu's order (ci, ky, kx)
#pragma unroll 1
      for (int g = 0; g < CS / 4; ++g) {
        const uint32_t gx = (uint32_t)g << 4;
        float4 win[3][P + 2];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int j = 0; j < P + 2; ++j) {
            const uint32_t ad = ((at[ky][j & 7] + off) ^ gx) + (j >> 3) * 512;
            win[ky][j] = *reinterpret_cast<const float4*>(smem + ad);
          }
        const float4* wg = reinterpret_cast<const float4*>(s_w + (k * CS + 4 * g) * WPC);
#pragma unroll
        for (int cl = 0; cl < 4; ++cl) {
          float wv[WPC];
#pragma unroll
          for (int i = 0; i < WPC / 4; ++i) {
            const float4 v = wg[cl * (WPC / 4) + i];
            wv[4 * i] = v.x;
            wv[4 * i + 1] = v.y;
            wv[4 * i + 2] = v.z;
            wv[4 * i + 3] = v.w;
          }
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int p = 0; p < P; ++p) {
                const float4& v = win[ky][p + kx];
                const float xv = cl == 0 ? v.x : cl == 1 ? v.y : cl == 2 ? v.z : v.w;
#pragma unroll
                for (int q = 0; q < COUT; ++q)
                  acc[p][q] = fmaf(xv, wv[(ky * 3 + kx) * 3 + q], acc[p][q]);
              }
        }
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the slot
      if (++s == DEPTH) {
        s = 0;
        ph ^= 1;
      }
    }

    const TileAt t = tile_at(tile, tiles_x, per_image, TH, TW);
    const int oy = t.oy0 + orow, ox = t.ox0 + col0;
    if (oy >= a.H) continue;
    const float4 bias = s_ba[0], alpha = s_ba[1];
    float v[P * COUT];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      v[3 * p] = epilogue(acc[p][0], bias.x, alpha.x, a.act);
      v[3 * p + 1] = epilogue(acc[p][1], bias.y, alpha.y, a.act);
      v[3 * p + 2] = epilogue(acc[p][2], bias.z, alpha.z, a.act);
    }
    float* dst = a.y + (((long long)t.n * a.H + oy) * a.W + ox) * a.ys;
    if (a.ys == COUT && ox + P <= a.W && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      // 24 consecutive floats: six 16-byte stores
#pragma unroll
      for (int i = 0; i < P * COUT / 4; ++i)
        reinterpret_cast<float4*>(dst)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (ox + p >= a.W) break;
        dst[p * a.ys] = v[3 * p];
        dst[p * a.ys + 1] = v[3 * p + 1];
        dst[p * a.ys + 2] = v[3 * p + 2];
      }
    }
  }
}

// The fp32 conv_last on the plan of ops/tail.py::last32_plan. Returns
// cudaErrorInvalidValue for a plan that does not describe this call and
// this build, cudaErrorNotSupported when the tensor map cannot be encoded.
cudaError_t launch_last32(const NarrowArgsT<float>& a, int cin, const long long* plan,
                          int plan_len, cudaStream_t stream) {
  using namespace wgmma_tile;
  if (plan == nullptr || plan_len != PLAN_LEN) return cudaErrorInvalidValue;
  const long long *dims = plan, *strides = plan + 4, *box = plan + 7;
  const long long grid = plan[11];
  const long long xs = a.xs;
  if (dims[0] != cin || dims[1] != a.W || dims[2] != a.H || dims[3] != a.B ||
      strides[0] != xs * 4 || strides[1] != a.W * xs * 4 || strides[2] != a.H * a.W * xs * 4 ||
      box[0] != CS || box[1] != BW || box[2] != PH || box[3] != 1 || plan[12] != TH ||
      plan[13] != TW || grid <= 0 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long tiles_x = (a.W + TW - 1) / TW;
  const long long per_image = tiles_x * ((a.H + TH - 1) / TH);
  const long long tiles = per_image * a.B;
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL || grid > tiles) return cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!encode(&tm, a.x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorNotSupported;
  cudaError_t e = cudaFuncSetAttribute(last32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  last32_kernel<<<(int)grid, kThreads, SMEM, stream>>>(tm, a, (int)tiles_x, (int)per_image,
                                                       (int)tiles);
  return cudaGetLastError();
}

}  // namespace last32

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
// (vr_conv3x3's), then the plan of the fp32 conv_last (null and 0 for any
// other call). Takes the stems (cin 3 or 12, cout 64, y 16-byte aligned
// with a pixel stride of whole 16-byte pieces: a multiple of 8 elements in
// bf16, of 4 in fp32) in either type, and conv_last (cin 64, cout 3, x
// 16-byte aligned with a pixel stride of whole 16-byte pieces) in either
// type, fp32 on last32::PLAN_LEN values of ops/tail.py::last32_plan,
// without residuals or upsampling; returns cudaErrorInvalidValue for any
// other call or a plan that does not describe it, cudaErrorNotSupported
// when the fp32 conv_last's tensor map cannot be encoded. Returns the
// cudaError_t of the launch.
int vr_conv3x3_narrow(int dtype, const void* x, const void* w, const void* b,
                      const void* alpha, const void* r1, const void* r2, void* y, int B, int H,
                      int W, int cin, int cout, long long xs, long long ys, long long r1s,
                      long long r2s, int act, int up2, float s1, float s2, void* stream,
                      const long long* plan, int plan_len) {
  (void)r1s; (void)r2s; (void)s1; (void)s2;
  if ((dtype != 0 && dtype != 1) || r1 || r2 || up2 || act < 0 || act > 2 ||
      (act == 2 && !alpha))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stem_call = cout == stem::COUT && (cin == 3 || cin == 12);
  const bool last_call = cin == last::CIN && cout == last::COUT;
  if (dtype == 0) {
    NarrowArgsT<float> a;
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.b = static_cast<const float*>(b);
    a.alpha = static_cast<const float*>(alpha);
    a.y = static_cast<float*>(y);
    a.B = B; a.H = H; a.W = W;
    a.xs = xs; a.ys = ys;
    a.act = act;
    if (last_call) {
      if (reinterpret_cast<uintptr_t>(x) % 16 || xs % 4 || xs < cin || ys < cout)
        return cudaErrorInvalidValue;
      return last32::launch_last32(a, cin, plan, plan_len, s);
    }
    if (!stem_call || reinterpret_cast<uintptr_t>(y) % 16 || ys % 4 || xs < cin)
      return cudaErrorInvalidValue;
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
  if (last_call) {
    if (reinterpret_cast<uintptr_t>(x) % 16 || xs % 8 || ys < cout) return cudaErrorInvalidValue;
    return launch(last::last_kernel, last::kThreads, last::SMEM, a, last::TH, last::TW, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
