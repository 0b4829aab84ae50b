// K3, fp32 route ("bf16x3"): the SRVGGNetCompact upsampler in one pass, for
// fp32 activations, on the bf16 tensor cores as three bf16 parts a value
// (K1's "bf16x3" arithmetic, conv3x3_bf16x3_wgmma.cu).
//
//   out = pixel_shuffle(conv3x3_SAME(feat, w) + b, r) + upsample_nearest(x_in, r)
//
// It computes the function of srvgg_up.cu (see the note there: conv output
// channel o r^2 + a r + b goes to fine pixel (r y + a, r x + b), colour o;
// the skip of every phase is x_in[y, x, o]; zero SAME padding at every
// edge; the bias and the skip added in fp32 in that order) and serves the
// same Pallas entry points of video_restore_tpu/ops/pallas_srvgg.py,
// srvgg_up_fused_raw (full frame) and srvgg_up_fused (tiles), for the calls
// ops/srvgg.py::srvgg_up_route sends it: fp32, cin a multiple of 16 up to
// 64, r 2 or 4.
//
// The arithmetic is K1 bf16x3's: each fp32 value of feat and of the weights
// is three bf16 parts, a product the six part products a_i w_j with i + j
// <= 2, summed in one fp32 accumulator per 16 input channels, the nine taps
// in order, smallest product first. The sums run in another order than
// srvgg_up.cu's FMAs, so the two agree within fp32 sums' rounding
// (chip_smoke.py [k3] holds it to plain within 1e-4 of the largest value),
// not bit for bit.
//
// What bounds it on the H100: at the config-4 frame (1x1080x1920x64, r 4)
// conv_out is 114.7 GFLOP of useful work, six bf16 products a MAC at 989
// TFLOP/s: 0.696 ms, against 954 MB of fp32 bytes (feat 531 MB, the skip 25
// MB, the 8K output 398 MB: 0.285 ms) and 1.711 ms of fp32 FMAs at the CUDA
// cores' 67 TFLOP/s (srvgg_up.cu's route). So it is bound by the tensor
// cores, and the design is K1 bf16x3's at conv_out's widths:
//
//  - The GEMM: M = LR pixels (an m64 tile = 64 neighbouring pixels of one
//    row), N = 3 r^2 padded to a multiple of 16 (r 4: 48; r 2: 12 -> 16 with
//    zero weight columns, ops/srvgg.py::srvgg_up_weights), K = 9 taps x cin,
//    16 input channels a stage. `wgmma` m64n48k16 and m64n16k16 are valid
//    shapes, but an N-major weight row of 48 bf16 is 96 bytes, which no
//    swizzle mode fits, so B is K-major: a cout's 16 channels one 32-byte
//    row in the 32-byte swizzle (the windows' layout), transposed once on
//    the host with the split (ops/tail.py::weight_parts(k_major=True): a
//    (3, 3, 3, N, cin) bf16 tensor), `wgmma` without the transpose bit
//    (wgmma_tile.cuh Wgmma<48, true>, Wgmma<16, true>).
//  - K1 bf16x3's producer warpgroup, as is (x3_produce, Geo<6> and Geo<2>):
//    TMA brings each stage's raw fp32 window ((TH + 2) x 66 pixels of 16
//    channels, out-of-frame reads zero filled) and the stage's weights (one
//    4-D box over (cin, N, 9, 3): 16 channels of every tap of the three
//    parts); its 128 threads split each window into three bf16 parts. Two
//    stages of split windows and weights, one raw window.
//  - Two consumer warpgroups share each tile, RPC rows each (r 4: 2 rows, a
//    4 x 64 tile; r 2: 4 rows, 8 x 64); per stage a warpgroup issues 9 taps
//    x 6 products x RPC `wgmma`s and releases the stage before once they
//    are done. A persistent grid, one block an SM.
//  - The epilogue adds the bias and the nearest skip in fp32 to each
//    accumulator and puts each LR pixel's r x r x 3 fine block in place in a
//    staging copy of the warp's r fine rows in shared memory (a warp owns 16
//    LR pixels of a row with every channel: r 4, four fine rows of 768
//    bytes), which the warp then writes with 16-byte stores, contiguous
//    runs of 768 bytes (r 2: 384; 4-byte stores where a fine row does not
//    start on 16 bytes: r 2 at an odd width). Shared memory: two stages,
//    the raw window, the barriers and 8 warps' staging, 214,912 bytes at r 4
//    (207,232 at r 2).
//
// The tensor maps are encoded on the host per call from the dims, byte
// strides and boxes that ops/srvgg.py::srvgg_up_x3_plan computes; the
// launcher checks the plan against this build (vr_srvgg_up_bf16x3_config)
// and the call, and refuses one that does not match.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py [kernel32]): 1.196
// ms at the config-4 frame, 58% of the 0.696 ms bound, against
// srvgg_up.cu's 6.708 (forced) and cuDNN's fp32 conv_out alone (TF32 off)
// 4.610 in the same run; within 1.1e-5 of plain there ([k3] fp32: 1.2e-5
// at most over its cases). ptxas: 168 registers, no spills.

#define VR_X3_DEVICE_ONLY
#include "conv3x3_bf16x3_wgmma.cu"

namespace {

constexpr int UP_PLAN_LEN = 26;
constexpr int CO = 3;  // output colours

// K3's geometry at scale R: N = 3 R^2 padded to a multiple of 16, K1's ring
// at that width (Geo<N / 8>), and each consumer warp's staging of its 16
// pixels' R fine rows after the ring's barriers.
template <int R>
struct UpGeo {
  static constexpr int COUT = CO * R * R;          // 48, 12
  static constexpr int N = (COUT + 15) / 16 * 16;  // 48, 16
  static constexpr int NT = N / 8;
  using G = Geo<NT>;
  static constexpr int FINE = 16 * R * CO;         // floats of a warp's fine row
  static constexpr int STG_WARP = R * FINE * 4;    // bytes: its R fine rows
  static constexpr int BARS = QS * G::STAGE + DR * G::RAW_BYTES;  // from the ring
  static constexpr int STG = (BARS + (2 * QS + DR) * 8 + 127) / 128 * 128;
  static constexpr int SMEM = 1024 + STG + NC * 4 * STG_WARP;
  static_assert(SMEM <= SMEM_MAX, "the ring and the staging must fit");
  static_assert(G::B_KMAJOR, "K3's widths read K-major weights");
};

// The epilogue's operands (the producer's walk reads X3Args).
struct UpEpi {
  const float* b;     // (3 r^2,)
  const float* skip;  // (B, H, W, 3) contiguous
  float* y;           // (B, r H, r W, 3) contiguous
};

// The consumer warpgroups' walk: the MMAs of each stage, then each tile
// row's epilogue through the warp's staging rows.
template <int R>
__device__ __forceinline__ void up_consume(const X3Smem& m, const X3Args& a, const UpEpi e,
                                           int my_tiles, X3Ring& r) {
  using U = UpGeo<R>;
  using G = typename U::G;
  constexpr int N = U::N, NT = U::NT, RPC = G::RPC, TH = G::TH;
  constexpr int RR = R * R, FINE = U::FINE;
  const uint32_t ring = m.ring, qfull0 = m.qfull0, qempty0 = m.qempty0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // this warpgroup's rows of a tile: wg * RPC ..
  const int wl = warp & 3, g = lane >> 2, q = lane & 3;

  // this thread's conv channels 8 i + 2 q and + 1 (the padded ones: none)
  float bias[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = 8 * i + 2 * q + c;
      bias[i][c] = ch < U::COUT ? e.b[ch] : 0.f;
    }
  float* stg = reinterpret_cast<float*>(m.base + (ring - m.s0) + U::STG + warp * U::STG_WARP);

  // descriptors at the ring: A and B both K-major in the 32-byte swizzle
  // (8-row groups 256 bytes apart); a stage, part, row, tap moves only the start
  const uint64_t da0 = make_desc(ring, 16, 8 * A_ROW, 3);
  const uint64_t db0 = make_desc(ring, 16, G::B_SBO, G::B_LAYOUT);

  float acc[RPC][N / 2];
  int s = r.qs;
  uint32_t ph = r.qph;
  for (int j = 0; j < my_tiles; ++j) {
    int n, oy0, ox0;
    tile_of(a, j, TH, n, oy0, ox0);
    int prev = 0;
    for (int k = 0; k < a.nk; ++k) {
      mbar_wait(qfull0 + 8 * s, ph);
#pragma unroll
      for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);
      wg_fence();
      const uint32_t st = s * G::STAGE;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - ky * 3;
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const uint32_t a_off = st + G::A_OFF + PA(p) * G::A_PART;
          const uint32_t b_off = st + PWP(p) * G::W_PART + tap * G::TAP_BYTES;
#pragma unroll
          for (int rr = 0; rr < RPC; ++rr)
            Wgmma<N, true>::run(
                acc[rr], da0 + (uint64_t)((a_off + ((wg * RPC + rr + ky) * PW + kx) * A_ROW) >> 4),
                db0 + (uint64_t)(b_off >> 4), (k | tap | p) != 0);
        }
      }
      wg_commit();
      if (k > 0) {
        wg_wait<1>();  // the previous stage's MMAs are done: release it
        if (lane == 0) mbar_arrive(qempty0 + 8 * prev);
      }
      prev = s;
      if (++s == QS) {
        s = 0;
        ph ^= 1;
      }
    }
    // the tile's sums are complete; said explicitly, so that the compiler
    // sees the last wait before the epilogue reads them
    wg_wait<0>();
    if (lane == 0) mbar_arrive(qempty0 + 8 * prev);
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) fence_acc(acc[rr]);

    // epilogue: this warp's 16 LR pixels of each of its rows (rows g and g +
    // 8 of the m64 tile, accumulator layout as K1's: 4 i + 2 h + c is pixel
    // g + 8 h, channel 8 i + 2 q + c), bias then skip in fp32, into the
    // staging rows: fine row a, fine column R px + b, colour o
    const int xs0 = ox0 + wl * 16;
    const int npx = min(16, a.W - xs0);
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) {
      const int oy = oy0 + wg * RPC + rr;
      if (oy >= a.H || npx <= 0) continue;  // the same for the whole warp
      float sk[2][CO];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = g + 8 * h;
        const long long pix = ((long long)n * a.H + oy) * a.W + xs0 + px;
#pragma unroll
        for (int o = 0; o < CO; ++o) sk[h][o] = px < npx ? e.skip[pix * CO + o] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ch = 8 * i + 2 * q + c;
            if (ch >= U::COUT) continue;
            const int o = ch / RR, fa = (ch / R) % R, fb = ch % R;
            stg[fa * FINE + ((g + 8 * h) * R + fb) * CO + o] =
                __fadd_rn(__fadd_rn(acc[rr][4 * i + 2 * h + c], bias[i][c]), sk[h][o]);
          }
      __syncwarp();
      // fine rows R oy .. R oy + R - 1, from fine column R xs0: npx R CO
      // contiguous values each
      const long long fw = (long long)R * a.W * CO;  // floats of a fine row
      float* out = e.y + ((long long)n * R * a.H + (long long)R * oy) * fw + (long long)R * xs0 * CO;
      const int nval = npx * R * CO;
      if (fw % 4 == 0 && nval % 4 == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(stg);
#pragma unroll
        for (int fa = 0; fa < R; ++fa)
          for (int u = lane; u < nval / 4; u += 32)
            *reinterpret_cast<float4*>(out + fa * fw + 4 * u) = s4[fa * (FINE / 4) + u];
      } else {
#pragma unroll
        for (int fa = 0; fa < R; ++fa)
          for (int u = lane; u < nval; u += 32) out[fa * fw + u] = stg[fa * FINE + u];
      }
      __syncwarp();  // the staging rows are free for the next row
    }
  }
  r.qs = s;
  r.qph = ph;
}

// ---- the kernel -------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    srvgg_up_bf16x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w, const X3Args a,
                           const UpEpi e) {
  using U = UpGeo<R>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const X3Smem m = x3_smem(smem, U::BARS);
  x3_init_barriers(m);
  __syncthreads();
  const int my_tiles = x3_my_tiles(a);
  X3Ring r;
  // the producer's role first: the consumers' `wgmma`s outside any branch
  // over the warp, where ptxas keeps them in flight
  if ((threadIdx.x >> 5) >= NC * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    x3_produce<U::NT, false>(m, &tm_x, &tm_x, a.nk, &tm_w, a, my_tiles, r);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  up_consume<R>(m, a, e, my_tiles, r);
}

template <int R>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const X3Args& a,
                   const UpEpi& e, int grid, cudaStream_t stream) {
  auto kernel = srvgg_up_bf16x3_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         UpGeo<R>::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, UpGeo<R>::SMEM, stream>>>(tm_x, tm_w, a, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The build's tile rows at r 2 and 4, tile pixels, channels a stage,
// dynamic shared memory a block at r 2 and 4, and the plan's length:
// out[0..6] (what ops/srvgg.py::srvgg_up_x3_plan needs).
int vr_srvgg_up_bf16x3_config(int* out) {
  out[0] = UpGeo<2>::G::TH;
  out[1] = UpGeo<4>::G::TH;
  out[2] = TW;
  out[3] = KC;
  out[4] = UpGeo<2>::SMEM;
  out[5] = UpGeo<4>::SMEM;
  out[6] = UP_PLAN_LEN;
  return 0;
}

// fp32 only: r (2 or 4), feat (B, H, W, cin) contiguous, w the K-major split
// parts of conv_out's weight padded to N columns (ops/tail.py::weight_parts
// (k_major=True): (3, 3, 3, N, cin) bf16), b (3 r^2,), skip (B, H, W, 3), y
// (B, r H, r W, 3), B, H, W, cin, the stream, then the plan: UP_PLAN_LEN
// int64 values from ops/srvgg.py::srvgg_up_x3_plan (feat's 4-D map: dims,
// byte strides, box; w's 4-D map: dims, byte strides, box; the grid, the
// tile, the shared-memory bytes). cudaErrorInvalidValue for a call the route
// does not take or a plan that does not describe this call and build;
// cudaErrorNotSupported when no tensor map encoder was found or
// cuTensorMapEncodeTiled refused a map.
int vr_srvgg_up_bf16x3(int r, const void* x, const void* w, const void* b, const void* skip,
                       void* y, int B, int H, int W, int cin, void* stream, const long long* plan,
                       int plan_len) {
  if ((r != 2 && r != 4) || cin <= 0 || cin % KC != 0 || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) || b == nullptr || skip == nullptr)
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != UP_PLAN_LEN) return cudaErrorInvalidValue;
  const long long *a_dims = plan, *a_strides = plan + 4, *a_box = plan + 7;
  const long long *w_dims = plan + 11, *w_strides = plan + 15, *w_box = plan + 18;
  const long long grid = plan[22], smem = plan[25];
  const int N = r == 4 ? UpGeo<4>::N : UpGeo<2>::N;
  const int TH = r == 4 ? UpGeo<4>::G::TH : UpGeo<2>::G::TH;
  const int SMEM = r == 4 ? UpGeo<4>::SMEM : UpGeo<2>::SMEM;
  // the plan must describe this call and this build
  if (a_dims[0] != cin || a_dims[1] != W || a_dims[2] != H || a_dims[3] != B ||
      a_strides[0] != cin * 4LL || a_strides[1] != cin * 4LL * W ||
      a_strides[2] != cin * 4LL * W * H || a_box[0] != KC || a_box[1] != PW ||
      a_box[2] != TH + 2 || a_box[3] != 1 || w_dims[0] != cin || w_dims[1] != N ||
      w_dims[2] != 9 || w_dims[3] != 3 || w_strides[0] != cin * 2LL ||
      w_strides[1] != (long long)N * cin * 2 || w_strides[2] != 9LL * N * cin * 2 ||
      w_box[0] != KC || w_box[1] != N || w_box[2] != 9 || w_box[3] != 3 || plan[23] != TH ||
      plan[24] != TW || smem != SMEM || grid <= 0)
    return cudaErrorInvalidValue;
  const long long tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if ((long long)B * H * W > 0x7fffffffLL || grid > tiles) return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  if (!encode(&tm_x, x, 4, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode(&tm_w, w, 4, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorNotSupported;
  X3Args a = {};
  a.x = static_cast<const float*>(x);
  a.H = H;
  a.W = W;
  a.nk = cin / KC;
  a.ih = H;
  a.iw = W;
  a.xs = cin;
  a.tiles_x = (int)tiles_x;
  a.tiles_y = (int)tiles_y;
  a.tiles = (int)tiles;
  UpEpi e;
  e.b = static_cast<const float*>(b);
  e.skip = static_cast<const float*>(skip);
  e.y = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return r == 4 ? launch<4>(tm_x, tm_w, a, e, (int)grid, st)
                : launch<2>(tm_x, tm_w, a, e, (int)grid, st);
}

}  // extern "C"
