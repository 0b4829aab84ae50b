// Tensor-core tile routines for the 3x3 convs of the port (bf16 in, fp32 sums).
//
// A SAME 3x3 conv over NHWC activations is, per tap (ky, kx) and per 16 input
// channels, a product of (pixels x 16) by (16 x cout). These device functions
// run that product on `mma.sync.aligned.m16n8k16` from two shared-memory
// tiles that `cp.async` fills:
//
//   patch    (PH x PW pixels) x 16 channels, pixel-major, channels contiguous,
//            bf16 as in device memory. A pixel takes PIX_PITCH = 48 bytes: 32
//            of data and 16 of padding, so the eight 16-byte rows of one
//            `ldmatrix` 8x8 matrix (eight neighbouring pixels) fall on eight
//            different 16-byte bank groups of a 128-byte line (0, 48, 96, 16,
//            64, 112, 32, 80): conflict free for every tap shift. (The other
//            cure, an XOR swizzle of the chunk index at a 32-byte pitch, would
//            put address arithmetic that depends on the tap into the inner
//            loop; padding costs shared memory only.)
//   weights  9 taps x 16 input channels x cout, exactly as HWIO has them (row
//            = input channel, cout contiguous), which is what `ldmatrix.trans`
//            wants for the "col" B operand: no re-layout on the host. A row
//            takes cout * 2 + 16 bytes, for the same reason as the pixel pad
//            (rows 128 or 64 bytes apart would hit the same banks 8 or 4
//            times).
//
// A warp owns RW rows of 32 pixels of the patch interior and all NT * 8
// output channels: RW * 2 m16 tiles by NT n8 tiles. Per tap it runs RW * 2
// `ldmatrix.x4` for A, NT / 2 `ldmatrix.x4.trans` for B and RW * 2 * NT MMAs.
// Tap shifts, rows and tiles are immediate offsets on two per-lane base
// addresses, so the inner loop holds no index arithmetic.
//
// Fragment layouts (PTX ISA, m16n8k16, lane = 4 g + t):
//   A (row major): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k), a2 (row g,
//     k + 8), a3 (row g + 8, k + 8) = the four 8x8 matrices of one
//     `ldmatrix.x4` in the order (rows 0-7, k 0-7), (rows 8-15, k 0-7),
//     (rows 0-7, k 8-15), (rows 8-15, k 8-15);
//   B ("col"): b0 (k 2t..2t+1, n g), b1 (k + 8, n g): `ldmatrix.trans` of a
//     [k][n] tile; one `.x4.trans` gives (k 0-7, n 0-7), (k 8-15, n 0-7),
//     (k 0-7, n 8-15), (k 8-15, n 8-15) = b0, b1 of two neighbouring n8 tiles;
//   C: c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8, same columns).
//
// Written for the K1 conv (conv3x3_mma.cu); the one-launch RDB
// (rdb_fused_mma.cu), the SRVGG upsampler (srvgg_up_mma.cu) and the one-launch
// tail (tail_fused_mma.cu) are built on the same routines.
//
// int8 (the W8A8 conv, conv3x3_i8_mma.cu): `mma.sync.aligned.m16n8k32` s8 x s8
// -> s32, one k32 step per 32 input channels. The patch holds 32 int8
// channels in the 32 data bytes of the same 48-byte pixel, so a_lane_offset
// and the same `ldmatrix.x4` give the s8 A fragment unchanged (a0 row g, k
// 4t..4t+3; a1 row g + 8; a2, a3 the same at k + 16). The B operand cannot go
// through `ldmatrix.trans`, which moves 16-bit elements and would split int8
// pairs: the weights are laid out once as (9, cout, cin) int8 (n-major, k
// contiguous; ops/quant.py::pack_i8_weights), a row (tap, n) of 32 k bytes
// (swizzled, WeightsI8), and a plain `ldmatrix.x4` of (n 0-7, k 0-15), (n 0-7,
// k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31) gives b0 (k 4t..4t+3 of column
// g), b1 (k 16 + 4t..) of two neighbouring n8 tiles. The accumulator layout is
// the fp32 one (frag_pixel, frag_channel).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

constexpr int KC = 16;          // input channels per stage: one k16 step
constexpr int PIX_PITCH = 48;   // bytes per patch pixel (32 data + 16 pad)
constexpr int ROW_PIX = 32;     // output pixels per warp row: two m16 tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero fill when !valid (the
// source address must still be a mapped one: pass a clamped pointer).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (m16 x k16, row) * b (k16 x n8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory geometry of one stage for NT * 8 output channels.
template <int NT>
struct Weights {
  static constexpr int PITCH = NT * 16 + 16;       // bytes per input channel
  static constexpr int BYTES = 9 * KC * PITCH;     // 9 taps x 16 channels
  static constexpr int CHUNKS = 9 * KC * NT;       // 16-byte copies per stage
};

// Stage the weight rows [c0, c0 + 16) of every tap: w is HWIO (3, 3, cin,
// NT * 8) bf16, 16-byte aligned. All THREADS threads of the block call it.
template <int NT, int THREADS>
__device__ __forceinline__ void load_weights(uint32_t s_w,
                                             const __nv_bfloat16* __restrict__ w,
                                             int cin, int c0, int tid) {
  for (int i = tid; i < Weights<NT>::CHUNKS; i += THREADS) {
    const int chunk = i % NT;  // 8 output channels of
    const int row = i / NT;    // row tap * 16 + ci
    const int tap = row >> 4, ci = row & 15;
    const __nv_bfloat16* src =
        w + ((long long)(tap * cin + c0 + ci) * (NT * 8) + chunk * 8);
    cp_async16(s_w + row * Weights<NT>::PITCH + chunk * 16, src, true);
  }
}

// Byte offset of this lane's `ldmatrix` row inside a patch whose rows hold PW
// pixels, for the warp's first pixel row `row0` (patch coordinates of tap
// (0, 0), m-tile 0): matrix l >> 3 of the x4, row l & 7 of that matrix.
template <int PW>
__device__ __forceinline__ uint32_t a_lane_offset(int row0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (row0 * PW + r + (m & 1) * 8) * PIX_PITCH + (m >> 1) * 16;
}

// The same for the weight tile (tap 0, n-tile pair 0).
template <int NT>
__device__ __forceinline__ uint32_t b_lane_offset(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + (m & 1) * 8) * Weights<NT>::PITCH + (m >> 1) * 16;
}

// acc += the nine taps of one stage (16 input channels). a_lane, b_lane: the
// shared-memory addresses of the stage's patch and weights plus the lane
// offsets above. acc[rw][mt][nt][4]: row rw of the warp, m16 tile mt (pixels
// mt * 16 ..), n8 tile nt.
template <int NT, int RW, int PW>
__device__ __forceinline__ void mma_taps(float (&acc)[RW][2][NT][4],
                                         uint32_t a_lane, uint32_t b_lane) {
  static_assert(NT % 2 == 0, "n8 tiles are loaded in pairs");
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a[RW][2][4];
#pragma unroll
      for (int rw = 0; rw < RW; ++rw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[rw][mt],
                      a_lane + ((rw + ky) * PW + mt * 16 + kx) * PIX_PITCH);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, b_lane + (ky * 3 + kx) * KC * Weights<NT>::PITCH + np * 32);
#pragma unroll
        for (int rw = 0; rw < RW; ++rw)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16816(acc[rw][mt][2 * np], a[rw][mt], b[0], b[1]);
            mma_16816(acc[rw][mt][2 * np + 1], a[rw][mt], b[2], b[3]);
          }
      }
    }
  }
}

// ---- int8 -------------------------------------------------------------------

constexpr int KC8 = 32;  // int8 input channels per stage: one k32 step

// c += a (m16 x k32, row) * b (k32 x n8, col), s8 in, exact s32 sums
__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory geometry of one int8 weight stage for NT * 8 output channels:
// row (tap, n) holds k 0..31 of the stage, 32 bytes, its two 16-byte halves
// swapped in rows 4-7 of every 8 (half ^ ((n >> 2) & 1)): the eight rows of
// one `ldmatrix` 8x8 matrix then fall on eight different 16-byte bank groups
// of a 128-byte line without the padding of the bf16 tiles, so a block can
// keep every stage of a conv's weights resident.
template <int NT>
struct WeightsI8 {
  static constexpr int PITCH = 32;                 // bytes per (tap, n) row
  static constexpr int BYTES = 9 * NT * 8 * PITCH;
  static constexpr int CHUNKS = 9 * NT * 8 * 2;    // 16-byte copies per stage
};

// Every stage of the weights: wp is (9, NT * 8, cin) int8, 16-byte aligned,
// cin a multiple of 32; stage j (input channels 32 j ..) at s_w + j * BYTES.
template <int NT, int THREADS>
__device__ __forceinline__ void load_weights_i8(uint32_t s_w,
                                                const int8_t* __restrict__ wp,
                                                int cin, int tid) {
  const int n = (cin / KC8) * WeightsI8<NT>::CHUNKS;
  for (int i = tid; i < n; i += THREADS) {
    const int j = i / WeightsI8<NT>::CHUNKS;
    const int c = i - j * WeightsI8<NT>::CHUNKS;
    const int row = c >> 1, half = c & 1;  // row = tap * cout + n
    cp_async16(s_w + j * WeightsI8<NT>::BYTES + row * WeightsI8<NT>::PITCH +
                   ((half ^ (row >> 2)) & 1) * 16,
               wp + ((long long)row * cin + j * KC8 + half * 16), true);
  }
}

// Byte offset of this lane's `ldmatrix` row in the int8 weight tile (tap 0,
// n-tile pair 0): matrix l >> 3 is (n + 8 (m >> 1), k + 16 (m & 1)), its
// half swapped in rows 4-7. Tap and n-pair offsets move by multiples of 8
// rows, which keep the swap.
__device__ __forceinline__ uint32_t b_lane_offset_i8(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + (m >> 1) * 8) * WeightsI8<2>::PITCH + ((m ^ (r >> 2)) & 1) * 16;
}

struct NoWork {
  __device__ __forceinline__ void operator()(int) const {}
};

// acc += the nine taps of one int8 stage (32 input channels), as mma_taps,
// for NT of the NB n8 tiles of a tap (b_lane points at the warp's first).
// between(tap) runs after the MMAs of each tap (0..8): other work the warp
// can issue while the tensor cores run them (conv3x3_i8_mma.cu quantises the
// next stage there).
template <int NT, int RW, int PW, int NB = NT, typename Between = NoWork>
__device__ __forceinline__ void mma_taps_i8(int (&acc)[RW][2][NT][4],
                                            uint32_t a_lane, uint32_t b_lane,
                                            Between between = Between()) {
  static_assert(NT % 2 == 0, "n8 tiles are loaded in pairs");
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a[RW][2][4];
#pragma unroll
      for (int rw = 0; rw < RW; ++rw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[rw][mt],
                      a_lane + ((rw + ky) * PW + mt * 16 + kx) * PIX_PITCH);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_lane + ((ky * 3 + kx) * NB * 8 + np * 16) *
                                    WeightsI8<NB>::PITCH);
#pragma unroll
        for (int rw = 0; rw < RW; ++rw)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16832_s8(acc[rw][mt][2 * np], a[rw][mt], b[0], b[1]);
            mma_16832_s8(acc[rw][mt][2 * np + 1], a[rw][mt], b[2], b[3]);
          }
      }
      between(ky * 3 + kx);
    }
  }
}

// Accumulator fragment -> (pixel of the warp's row, output channel): element
// e of acc[.][mt][nt] is pixel frag_pixel(lane, mt, e >> 1), channel
// frag_channel(lane, nt) + (e & 1).
__device__ __forceinline__ int frag_pixel(int lane, int mt, int half) {
  return mt * 16 + (lane >> 2) + half * 8;
}

__device__ __forceinline__ int frag_channel(int lane, int nt) {
  return nt * 8 + (lane & 3) * 2;
}

}  // namespace mma_tile
