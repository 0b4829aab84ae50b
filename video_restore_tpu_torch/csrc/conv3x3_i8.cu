// K4: W8A8 int8 direct SAME 3x3 convolution on NHWC bf16 activations.
//
// Replaces the int8 branch (`sw`) of `_conv_prefix` in
// video_restore_tpu/ops/pallas_stripe.py:358, which every body kernel runs
// with `--precision int8`: the RDB stripe kernels rdb_stripe2d_split /
// rdb_stripe2d_padded / rdb_res_stripe2d_padded / rdb_stripe_padded /
// rdb_res_stripe_padded, and the SRVGG body kernels srvgg_stripe2d_split /
// srvgg_stripe2d_padded / srvgg_stripe_padded (pallas_srvgg.py). The input
// channels are read as up to 5 segments (an RDB conv reads the prefix
// [x | c1 .. c4] of one growth buffer; an SRVGG conv one segment); for each
// segment s and output channel o:
//
//   sa_s = max(amax[n, s], 1e-12) * (1/127)          one scale per image
//   inv  = bf16(1 / sa_s)                            (_quant_act, :259-265)
//   p    = bf16(a * inv)
//   q    = trunc(clip(bf16(p + copysign(0.5, p)), -127.5, 127.5))  (:268-290)
//   acc_s = sum_{ky,kx,c in s} q * wq[ky, kx, c, o]           exact int32
//   v    = ((acc_0 sc_0 + acc_1 sc_1) + ...) + b[o],  sc_s = sa_s * sw[s, o]
//          fp32, sources in order (:586-629)
//   v    = act(v); v = r1 + s1 v; v = r2 + s2 bf16(v); out = bf16(v)  (as K1)
//
// The integer dot is exact (|acc| <= 576 * 127^2 < 2^31), so the order of
// the int32 sums does not matter. Each fp32 multiply-add (a dequantised
// term added to the sum before it, the bias after a single segment, the
// residuals) rounds once, with explicit `__fmaf_rn`: XLA fuses the JAX
// kernel's multiply-adds the same way, and the CPU tests hold the plain
// version to it bit for bit in bf16. The A8 scale comes from a
// device array of per-(image, segment) amaxes, so nothing waits on the host:
// K4 optionally writes the per-image amax of the bf16 values it stores
// (block reduction, then atomicMax on the float bits, valid because the
// values are >= 0), which is the next conv's scale; `vr_amax_bf16` gives it
// for a tensor K4 did not write (the stem's output).
//
// Where the JAX kernel takes one scale per row chunk of its VMEM window,
// K4 takes one per image (per tile when tiled); the two agree when one
// stripe and one chunk cover the frame (ROADMAP queue 3).
//
// Static A8 (the `sa_static` branch of the same `_conv_prefix`, :396-404,
// with `_quant_act_static` :293 and `fold_static_act_scales` :904): each
// segment takes a fixed calibrated scale sa_s from the host instead of an
// amax, with `inv = bf16(1 / sa_s)` rounded once from the host's double and
// `sc_s = sw[s, o] * float(sa_s)`; the rest is the same chain. No amax is
// read, and none is written.
//
// What bounds it on the H100: at nf 64 an RDB does 9.94e11 int8 operations
// at 1080p against 0.53 GB of bf16 in and out, so its bound is the tensor
// cores' 1979 TOPS dense int8 (0.50 ms per RDB). This first design runs
// `__dp4a` (four int8 products summed into int32) on the CUDA cores, about
// twice K1's fp32-FMA rate in multiply-accumulates: a block of 128 threads
// quantises a (16+2) x (16+2) pixel x 32-channel input patch on load into
// shared memory as int8 packed by 4 channels, stages the 9 x 32 x 32 int8
// weight slice the same way, and each thread keeps 8 pixels x 8 output
// channels of int32 sums (and their fp32 dequantised totals) in registers.
// The int8 tensor cores (`mma.sync` m16n8k32) are conv3x3_i8_mma.cu, the
// same function bit for bit, which takes the calls at nf 64 / gc 32
// (ops/quant.py::conv3x3_i8_route); this kernel keeps the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 5;
constexpr int kThreads = 128;
constexpr int TW = 16, TH = 16;  // output pixels per block
constexpr int CO = 32;           // output channels per block
constexpr int CI = 32;           // input channels per shared-memory chunk
constexpr int CW = CI / 4;       // packed int32 words per pixel per chunk
constexpr int PW = TW + 2, PH = TH + 2;
constexpr int CS = (PH * PW) | 1;           // odd pitch of one word plane
constexpr int IN = (CW * CS + 3) / 4 * 4;   // keeps s_w 16-byte aligned
constexpr int WT = 9 * CW * CO;
constexpr float kInv127 = 1.0f / 127.0f;

struct I8Args {
  const __nv_bfloat16* x;  // (B, H, W, >=cin), pixel stride xs
  const float* amax;       // amax[n * as + s]: per-(image, segment) |max|
  const int8_t* w;         // (3, 3, cin, cout) contiguous
  const float* sw;         // (nseg, cout) weight scales
  const __nv_bfloat16* b;      // (cout,)
  const __nv_bfloat16* alpha;  // (cout,) for PReLU, else null
  const __nv_bfloat16* r1;     // (B, H, W, >=cout) pixel stride r1s, or null
  const __nv_bfloat16* r2;     // (B, H, W, >=cout) pixel stride r2s, or null
  __nv_bfloat16* y;            // (B, H, W, >=cout) pixel stride ys
  float* out_amax;             // out_amax[n * os], or null
  int B, H, W, cin, cout;
  long long xs, ys, r1s, r2s;
  long long as, os;
  int nseg;
  int seg[kMaxSeg + 1];
  int act;  // 0 none, 1 lrelu(0.2), 2 prelu
  float s1, s2;
  float sa[kMaxSeg];    // static A8: the segments' fixed scales
  float inv[kMaxSeg];   // static A8: bf16(1 / sa), held as float
};

__device__ __forceinline__ float act_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), kInv127);
}

// _quant_act + _round_clip_i8 for one bf16 value, with inv already bf16
__device__ __forceinline__ int quant(__nv_bfloat16 a, float inv) {
  const float p = __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), inv)));
  float t = __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(p, copysignf(0.5f, p))));
  t = fminf(fmaxf(t, -127.5f), 127.5f);
  return __float2int_rz(t);
}

__device__ __forceinline__ void block_amax(float m, float* s_red,
                                           float* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < blockDim.x / 32; ++i) m = fmaxf(m, s_red[i]);
    if (m > 0.f) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
  }
}

// STATIC: the segments' scales come from a.sa / a.inv, not from a.amax
template <bool STATIC>
__global__ void __launch_bounds__(kThreads) conv3x3_i8_kernel(const I8Args a) {
  __shared__ __align__(16) int s_mem[IN + WT];
  __shared__ float s_red[kThreads / 32];
  int* s_in = s_mem;       // [CW][PH * PW], pitch CS
  int* s_w = s_mem + IN;   // [9][CW][CO]

  const int tiles_x = (a.W + TW - 1) / TW;
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int co_base = blockIdx.y * CO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % 4;  // 8-channel group of CO
  const int pg = tid / 4;  // 8-pixel group of the 16 x 16 tile
  const int prow = pg / 2;
  const int pcol = (pg % 2) * 8;
  const int oy0 = ty * TH, ox0 = tx * TW;

  float facc[8][8];
  int iacc[8][8];

  for (int s = 0; s < a.nseg; ++s) {
    const int lo = a.seg[s], hi = a.seg[s + 1];
    float sa, inv;
    if constexpr (STATIC) {
      sa = a.sa[s];
      inv = a.inv[s];
    } else {
      sa = act_scale(a.amax[n * a.as + s]);
      inv = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(1.0f, sa)));
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) iacc[p][q] = 0;

    for (int c0 = lo; c0 < hi; c0 += CI) {
      const int cend = min(c0 + CI, hi);
      __syncthreads();
      // input patch, quantised on load; zero outside the frame (SAME)
      for (int i = tid; i < PH * PW * CW; i += kThreads) {
        const int cw = i % CW;
        const int pix = i / CW;
        const int py = pix / PW, px = pix % PW;
        const int oy = oy0 + py - 1, ox = ox0 + px - 1;
        unsigned word = 0;
        if (oy >= 0 && oy < a.H && ox >= 0 && ox < a.W) {
          const __nv_bfloat16* src =
              a.x + (((long long)n * a.H + oy) * a.W + ox) * a.xs;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * cw + j;
            if (c < cend)
              word |= (unsigned)(quant(src[c], inv) & 0xff) << (8 * j);
          }
        }
        s_in[cw * CS + pix] = (int)word;
      }
      for (int i = tid; i < WT; i += kThreads) {
        const int co = i % CO;
        const int cw = (i / CO) % CW;
        const int tap = i / (CO * CW);
        const int gco = co_base + co;
        unsigned word = 0;
        if (gco < a.cout) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * cw + j;
            if (c < cend)
              word |= (unsigned)(uint8_t)a.w[((long long)tap * a.cin + c) *
                                                 a.cout + gco]
                      << (8 * j);
          }
        }
        s_w[i] = (int)word;
      }
      __syncthreads();

      const int ncw = (cend - c0 + 3) / 4;
      for (int cw = 0; cw < ncw; ++cw) {
        const int* sin_c = s_in + cw * CS;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int* row = sin_c + (prow + ky) * PW + pcol;
          int xin[10];
#pragma unroll
          for (int j = 0; j < 10; ++j) xin[j] = row[j];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int4* wp = reinterpret_cast<const int4*>(
                s_w + ((ky * 3 + kx) * CW + cw) * CO + cg * 8);
            const int4 w0 = wp[0], w1 = wp[1];
            const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < 8; ++p)
#pragma unroll
              for (int q = 0; q < 8; ++q)
                iacc[p][q] = __dp4a(xin[p + kx], wv[q], iacc[p][q]);
          }
        }
      }
    }

    // dequantise this segment and add it after the earlier ones; with a
    // single segment the bias is the addend
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int co = co_base + cg * 8 + q;
      const bool ok = co < a.cout;
      const float sc = ok ? __fmul_rn(sa, a.sw[s * a.cout + co]) : 0.f;
      const float bias = ok && a.nseg == 1 ? __bfloat162float(a.b[co]) : 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float v = __int2float_rn(iacc[p][q]);
        if (s > 0)
          facc[p][q] = __fmaf_rn(v, sc, facc[p][q]);
        else if (a.nseg == 1)
          facc[p][q] = __fmaf_rn(v, sc, bias);
        else
          facc[p][q] = __fmul_rn(v, sc);
      }
    }
  }

  // epilogue (K1's), then the block's |max| of the stored values
  const int oy = oy0 + prow;
  float m = 0.f;
  if (oy < a.H) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int ox = ox0 + pcol + p;
      if (ox >= a.W) continue;
      const long long pix = ((long long)n * a.H + oy) * a.W + ox;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int co = co_base + cg * 8 + q;
        if (co >= a.cout) continue;
        float v = a.nseg == 1
                      ? facc[p][q]
                      : __fadd_rn(facc[p][q], __bfloat162float(a.b[co]));
        if (a.act == 1) {
          v = v >= 0.f ? v : __fmul_rn(0.2f, v);
        } else if (a.act == 2) {
          v = v > 0.f ? v : __fmul_rn(v, __bfloat162float(a.alpha[co]));
        }
        if (a.r1)
          v = __fmaf_rn(a.s1, v, __bfloat162float(a.r1[pix * a.r1s + co]));
        if (a.r2)
          v = __fmaf_rn(a.s2, __bfloat162float(__float2bfloat16_rn(v)),
                        __bfloat162float(a.r2[pix * a.r2s + co]));
        const __nv_bfloat16 out = __float2bfloat16_rn(v);
        a.y[pix * a.ys + co] = out;
        m = fmaxf(m, fabsf(__bfloat162float(out)));
      }
    }
  }
  if (a.out_amax) block_amax(m, s_red, a.out_amax + n * a.os);
}

// Per-image |max| of a (B, H*W, >=C) bf16 channel-prefix view with pixel
// stride xs (the A8 amax of _quant_act, pallas_stripe.py:239, for a tensor K4
// did not write). VEC channels per load: 8 (16 bytes; C and xs multiples of
// 8, base 16-byte aligned) or 1 (any view). A thread walks positions (pixel,
// chunk) of the view strided by the grid's thread count, four loads in
// flight, stepping its pixel and chunk by a precomputed quotient and
// remainder (no division per element); |.| and max on bf16x2 are exact, so
// the result equals the plain version bit for bit in any order; one widening
// to fp32 and one atomicMax per block. Bound: the bytes of the view.
template <int VEC>
__global__ void __launch_bounds__(256)
    amax_kernel(const __nv_bfloat16* x, long long xs, int hw, int c,
                float* out, long long os) {
  __shared__ float s_red[256 / 32];
  constexpr int UNROLL = 4;
  const int n = blockIdx.y;
  const __nv_bfloat16* base = x + (long long)n * hw * xs;
  const int cc = c / VEC;  // positions per pixel
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int dp = (int)(nthreads / cc), dc = (int)(nthreads % cc);
  int pix = (int)(first / cc), ch = (int)(first % cc);
  __nv_bfloat162 m2 = __floats2bfloat162_rn(0.f, 0.f);
  while (pix < hw) {
    uint4 v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = pix < hw;
      if (ok[u]) {
        const __nv_bfloat16* p = base + (long long)pix * xs + ch * VEC;
        if constexpr (VEC == 8) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
          v[u] = make_uint4(bits, 0u, 0u, 0u);
        }
      }
      ch += dc;
      pix += dp;
      if (ch >= cc) {
        ch -= cc;
        ++pix;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int k = 0; k < (VEC == 8 ? 4 : 1); ++k)
        m2 = __hmax2(m2, __habs2(h[k]));  // VEC 1: the high half is +0
    }
  }
  const float m = fmaxf(__low2float(m2), __high2float(m2));
  block_amax(m, s_red, out + n * os);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch. out_amax must be zeroed by the
// caller (atomicMax of values >= 0). Static A8: `sa` and `inv` are host
// arrays of nseg floats (the fixed scales and bf16(1 / sa)), and `amax` and
// `out_amax` are null; dynamic A8: `sa` and `inv` are null.
int vr_conv3x3_i8(const void* x, const void* amax, const void* w,
                  const void* sw, const void* b, const void* alpha,
                  const void* r1, const void* r2, void* y, void* out_amax,
                  int B, int H, int W, int cin, int cout, long long xs,
                  long long ys, long long r1s, long long r2s, long long as,
                  long long os, int nseg, const int* seg, const float* sa,
                  const float* inv, int act, float s1, float s2,
                  void* stream) {
  if (nseg < 1 || nseg > kMaxSeg || seg[0] != 0 || seg[nseg] != cin)
    return cudaErrorInvalidValue;
  if ((sa == nullptr) != (inv == nullptr) ||
      (sa ? amax != nullptr || out_amax != nullptr : amax == nullptr))
    return cudaErrorInvalidValue;
  I8Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.amax = static_cast<const float*>(amax);
  a.w = static_cast<const int8_t*>(w);
  a.sw = static_cast<const float*>(sw);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.alpha = static_cast<const __nv_bfloat16*>(alpha);
  a.r1 = static_cast<const __nv_bfloat16*>(r1);
  a.r2 = static_cast<const __nv_bfloat16*>(r2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.out_amax = static_cast<float*>(out_amax);
  a.B = B; a.H = H; a.W = W; a.cin = cin; a.cout = cout;
  a.xs = xs; a.ys = ys; a.r1s = r1s; a.r2s = r2s; a.as = as; a.os = os;
  a.nseg = nseg;
  for (int i = 0; i <= kMaxSeg; ++i) a.seg[i] = i <= nseg ? seg[i] : cin;
  a.act = act; a.s1 = s1; a.s2 = s2;
  for (int i = 0; i < kMaxSeg; ++i) {
    a.sa[i] = sa && i < nseg ? sa[i] : 0.f;
    a.inv[i] = sa && i < nseg ? inv[i] : 0.f;
  }
  const int tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  const dim3 grid(tiles, (cout + CO - 1) / CO, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sa)
    conv3x3_i8_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else
    conv3x3_i8_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

int vr_amax_bf16(const void* x, void* out, int B, int HW, int C, long long xs,
                 long long os, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || xs < C)
    return cudaErrorInvalidValue;
  const bool vec = C % 8 == 0 && xs % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long positions = (long long)HW * (vec ? C / 8 : C);
  // a few blocks per SM over all images, no more than the positions need
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  long long blocks = (4LL * sms + B - 1) / B;
  const long long need = (positions + 256 * 4 - 1) / (256 * 4);
  if (blocks > need) blocks = need;
  const dim3 grid((unsigned)blocks, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* op = static_cast<float*>(out);
  if (vec)
    amax_kernel<8><<<grid, 256, 0, st>>>(xp, xs, HW, C, op, os);
  else
    amax_kernel<1><<<grid, 256, 0, st>>>(xp, xs, HW, C, op, os);
  return cudaGetLastError();
}

}  // extern "C"
