// K5, fp32 route ("bf16x3"): one residual dense block (RDB), or a whole RRDB,
// in one persistent cooperative launch, for fp32 activations at nf 64 / gc
// 32, on the bf16 tensor cores as three bf16 parts a value (K1's "bf16x3"
// arithmetic, conv3x3_bf16x3_wgmma.cu).
//
// It computes the function of rdb_fused.cu's fp32 instance
// (rdb_fused_f32.cu):
//
//   c_k = lrelu(conv_k([x | c_1 .. c_{k-1}]) + b_k)      k = 1..4
//   out = x + 0.2 * (conv_5([x | c_1 .. c_4]) + b_5)
//   out = x0 + 0.2 * out                                 (optional x0)
//
// every conv SAME, every rounding to fp32; the RRDB is x + 0.2 RDB3(RDB2(
// RDB1(x))). It replaces, for the calls ops/rdb.py::rdb_route sends it (fp32
// at (nf, gc) = (64, 32), aligned contiguous operands), the same Pallas entry
// points of video_restore_tpu/ops as the other K5 sources:
//   pallas_rdb.py:257    rrdb_fused          (the VRT_PALLAS=1 body)
//   pallas_rdb.py:313    rdb_fused
//   pallas_stripe.py:1016 rrdb_stripe_padded
//   pallas_stripe.py:2079 rdb_stripe
//
// Sums: each conv is K1 "bf16x3"'s: per 16 input channels in growth order,
// the nine taps in order, the six products a2 w0, a1 w1, a0 w2, a1 w0, a0 w1,
// a0 w0 into one fp32 accumulator, then conv3x3.cu's epilogue arithmetic. So
// the kernel equals K1 "bf16x3"'s five-launch RDB (ops/stripe.py::rdb_fused
// at fp32) and three of them with the residual bit for bit.
//
// What bounds it on the H100: a 1080p RDB is 9.94e11 useful operations, six
// bf16 products a MAC at 989 TFLOP/s: 6.03 ms (18.09 for the RRDB), against
// ~1.1 GB of fp32 bytes (0.33 ms) and 14.8 ms of fp32 FMAs on the CUDA
// cores' 67 TFLOP/s. rdb_fused_f32.cu recomputes square tiles' halos (1.77x
// the useful MACs) on the CUDA cores; the row-ring fusion of
// rdb_fused_wgmma.cu does not fit in three parts (its x ring alone would be
// 221,184 bytes). This design keeps K1 bf16x3's conv and drops what five
// launches cost around it:
//
//  - One persistent cooperative launch, one block an SM, whose phases are
//    the RDB's 5 convs (the RRDB's 15). Each phase is K1 "bf16x3"'s tile
//    walk (this source includes conv3x3_bf16x3_wgmma.cu's producer and
//    consumer roles): its tiles (8 x 64 at cout 32, 4 x 64 at cout 64), a
//    producer warpgroup that splits each TMA window into its three parts,
//    two consumer warpgroups, two stages of split windows and weights.
//  - c_1 .. c_4 go to device memory, in one (B, H, W, 128) buffer (conv k
//    writes its 32 channels at 32 (k - 1)); conv k reads its input's 64
//    channels through one 4-D map and c_1 .. c_{k-1} through another, so x
//    is never copied. RRDB: RDB1 x -> y, RDB2 y -> scratch, RDB3 scratch
//    (+ x0 = x) -> y.
//  - Between phases a grid-wide barrier with `fence.proxy.async.global` on
//    both sides (the next phase reads the last one's stores through TMA),
//    as rdb_fused_wgmma.cu's RRDB passes have. The ring's stages and
//    barriers carry over; a phase at cout 64 lays its ring out as K1 does at
//    that width (the raw slot after its stages), so shared memory is the
//    larger of the two layouts: 227,624 bytes.
//
// The tensor maps are encoded on the host per call (the plan of
// ops/rdb.py::rdb_x3_plan, checked against this build: vr_rdb_fused_bf16x3_
// config); the weights are ops/tail.py::weight_parts of each conv.
//
// Measured (NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py [k5] fp32 and
// tools/probe_k5k3.py --dtype fp32): the 1080p RRDB 33.9-35.5 ms against K1
// bf16x3's chain of 15 launches' 34.5-37.2 and rdb_fused_f32.cu's 378.6-381.0
// (53% of its 18.09 ms bound), the RDB 10.9-12.1 against 11.1-11.5. As for
// K1, the time follows the products (two of six: 17.5 of 35.2 ms) and the
// epilogues do not overlap the MMAs (without the stores 10.4); the split
// costs ~8% (without it 32.5). ptxas: 168 registers and 404 bytes of
// spill stores (where is not measured), which the timings include. Measured
// and not kept:
// the producer at K1's 56 registers (34.4-35.1), 4-row tiles at cout 32
// (34.5-36.1). c_k written in three parts (TMA straight into the stages)
// would drop the split of c_1 .. c_4 but not the raw slot x needs, and a
// third stage (92-95 KB) would still not fit.

#define VR_X3_DEVICE_ONLY
#include "conv3x3_bf16x3_wgmma.cu"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int K5_NF = 64, K5_GC = 32;
constexpr int K5_CONVS = 15;  // the RRDB's
constexpr int RING4 = QS * Geo<4>::STAGE + DR * Geo<4>::RAW_BYTES;
constexpr int RING8 = QS * Geo<8>::STAGE + DR * Geo<8>::RAW_BYTES;
constexpr int K5_RING = RING4 > RING8 ? RING4 : RING8;  // the barriers' offset from the ring
constexpr int K5_SMEM = 1024 + K5_RING + (2 * QS + DR) * 8;
constexpr int K5_PLAN_LEN = 31;
// the producer's registers: K1's consumers keep their 216, the producer
// takes what K1's leaves (its phases' maps and arguments)
constexpr int K5_PRODUCER_REGS = 72;
static_assert(PT * K5_PRODUCER_REGS + NC * 128 * CONSUMER_REGS <= 65536, "the SM's registers");
static_assert(K5_SMEM <= SMEM_MAX, "the larger ring and the barriers must fit");

struct __align__(64) K5X3Params {
  CUtensorMap tm_w[K5_CONVS];  // the split weights: (cout, cin, 9, 3)
  CUtensorMap tm_in[3][2];     // the RDBs' inputs x, y, scratch: boxes of Geo<4>, Geo<8> rows
  CUtensorMap tm_c[2];         // c_1 .. c_4 (the 128-channel buffer), the same boxes
  const float* b[K5_CONVS];
  const float* x;
  const float* x0;  // one RDB's x0, or null
  float* y;
  float* scratch;
  float* c;
  int B, H, W, rdbs, tiles_x, tiles_y32, tiles_y64;
};

// Phase i: conv k = i % 5 + 1 of RDB i / 5, as K1's arguments; `src`: the
// RDB's input (0 x, 1 y, 2 scratch).
__device__ __forceinline__ X3Args phase_args(const K5X3Params& p, int i, int& src) {
  const int r = i / 5, k = i - 5 * r;
  src = p.rdbs == 1 ? 0 : r;
  const float* in = src == 0 ? p.x : src == 1 ? p.y : p.scratch;
  X3Args a = {};
  a.b = p.b[i];
  a.H = p.H;
  a.W = p.W;
  a.nk = (K5_NF + k * K5_GC) / KC;
  a.tiles_x = p.tiles_x;
  a.tiles_y = k < 4 ? p.tiles_y32 : p.tiles_y64;
  a.tiles = p.B * a.tiles_x * a.tiles_y;
  if (k < 4) {  // c_{k+1} into its 32 channels of the 128
    a.y = p.c + k * K5_GC;
    a.ys = 4 * K5_GC;
    a.act = 1;
  } else {  // the RDB's output: its input + 0.2 conv, then x0 + 0.2 that
    a.y = p.rdbs == 1 || r != 1 ? p.y : p.scratch;
    a.ys = K5_NF;
    a.r1 = in;
    a.r1s = K5_NF;
    a.s1 = 0.2f;
    a.r2 = p.rdbs == 1 ? p.x0 : r == 2 ? p.x : nullptr;
    a.r2s = K5_NF;
    a.s2 = 0.2f;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads, 1)
    rdb_bf16x3_kernel(const __grid_constant__ K5X3Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const X3Smem m = x3_smem(smem, K5_RING);
  x3_init_barriers(m);
  __syncthreads();
  const int phases = 5 * p.rdbs;
  X3Ring r;
  if ((threadIdx.x >> 5) >= NC * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(K5_PRODUCER_REGS));
    for (int i = 0; i < phases; ++i) {
      int src;
      const X3Args a = phase_args(p, i, src);
      // the last phase's stores (any block's) before this phase's TMA reads
      if (i > 0 && threadIdx.x == NC * 128) asm volatile("fence.proxy.async.global;\n" ::: "memory");
      // stages 0-3 read the input's 64 channels, the rest c_1 .. c_{k-1}
      if (i % 5 < 4)
        x3_produce<4, false>(m, &p.tm_in[src][0], &p.tm_c[0], K5_NF / KC, &p.tm_w[i], a,
                             x3_my_tiles(a), r);
      else
        x3_produce<8, false>(m, &p.tm_in[src][1], &p.tm_c[1], K5_NF / KC, &p.tm_w[i], a,
                             x3_my_tiles(a), r);
      if (i + 1 < phases) cg::this_grid().sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  for (int i = 0; i < phases; ++i) {
    int src;
    const X3Args a = phase_args(p, i, src);
    if (i % 5 < 4)
      x3_consume<4>(m, a, x3_my_tiles(a), r);
    else
      x3_consume<8>(m, a, x3_my_tiles(a), r);
    if (i + 1 < phases) {
      // this phase's stores before the next phase's TMA reads, in any block
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      cg::this_grid().sync();
    }
  }
}

cudaError_t launch_k5(const K5X3Params& k, int grid, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(rdb_bf16x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K5_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(rdb_bf16x3_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  // the grid-wide barrier needs every block resident
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rdb_bf16x3_kernel, kThreads,
                                                     K5_SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  K5X3Params arg = k;
  void* params[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rdb_bf16x3_kernel), dim3(grid),
                                  dim3(kThreads), params, K5_SMEM, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The build's tile rows at cout 32 and 64, tile pixels, channels a stage,
// dynamic shared memory a block, threads a block, the plan's length:
// out[0..6] (what ops/rdb.py::rdb_x3_plan needs).
int vr_rdb_fused_bf16x3_config(int* out) {
  out[0] = Geo<4>::TH;
  out[1] = Geo<8>::TH;
  out[2] = TW;
  out[3] = KC;
  out[4] = K5_SMEM;
  out[5] = kThreads;
  out[6] = K5_PLAN_LEN;
  return 0;
}

// One RDB (rdbs 1: x, x0 or null -> y) or a whole RRDB (rdbs 3: x -> y,
// through scratch), fp32 at (nf, gc) = (64, 32): ws the split parts of the
// 5 rdbs convs' weights ((3, 3, 3, cin, cout) bf16, ops/tail.py::weight_parts),
// bs their fp32 biases, c a (B, H, W, 128) fp32 buffer for c_1 .. c_4;
// then the plan (K5_PLAN_LEN int64 values of ops/rdb.py::rdb_x3_plan: the
// build's tile rows at cout 32 and 64, tile pixels, channels a stage, shared
// memory; the grid, the tile columns and rows at each width; the input's
// and c's 4-D maps (dims, byte strides) and the boxes at each width).
// cudaErrorInvalidValue for a call or plan this build does not take,
// cudaErrorNotSupported when a tensor map cannot be encoded.
int vr_rdb_fused_bf16x3(int nf, int gc, int rdbs, const void* x, const void* x0, void* y,
                        void* scratch, void* c, const void* const* ws, const void* const* bs,
                        int B, int H, int W, void* stream, const long long* plan,
                        int plan_len) {
  if (nf != K5_NF || gc != K5_GC || (rdbs != 1 && rdbs != 3) || B <= 0 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (!x || !y || !c || (rdbs == 3 && (!scratch || x0)) || !aligned16(x) || !aligned16(x0) ||
      !aligned16(y) || !aligned16(scratch) || !aligned16(c))
    return cudaErrorInvalidValue;
  if (plan == nullptr || plan_len != K5_PLAN_LEN) return cudaErrorInvalidValue;
  if ((long long)B * H * W > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles_x = (W + TW - 1) / TW;
  const long long ty32 = (H + Geo<4>::TH - 1) / Geo<4>::TH, ty64 = (H + Geo<8>::TH - 1) / Geo<8>::TH;
  const long long most = (long long)B * tiles_x * (ty32 > ty64 ? ty32 : ty64);
  const long long in_dims[4] = {K5_NF, W, H, B};
  const long long in_strides[3] = {K5_NF * 4, (long long)W * K5_NF * 4,
                                   (long long)H * W * K5_NF * 4};
  const long long c_dims[4] = {4 * K5_GC, W, H, B};
  const long long c_strides[3] = {4 * K5_GC * 4, (long long)W * 4 * K5_GC * 4,
                                  (long long)H * W * 4 * K5_GC * 4};
  const long long box[2][4] = {{KC, PW, Geo<4>::TH + 2, 1}, {KC, PW, Geo<8>::TH + 2, 1}};
  const long long want[K5_PLAN_LEN] = {
      Geo<4>::TH, Geo<8>::TH, TW, KC, K5_SMEM, plan[5], tiles_x, ty32, ty64,
      in_dims[0], in_dims[1], in_dims[2], in_dims[3], in_strides[0], in_strides[1], in_strides[2],
      c_dims[0], c_dims[1], c_dims[2], c_dims[3], c_strides[0], c_strides[1], c_strides[2],
      box[0][0], box[0][1], box[0][2], box[0][3], box[1][0], box[1][1], box[1][2],
      box[1][3]};
  for (int i = 0; i < K5_PLAN_LEN; ++i)
    if (plan[i] != want[i]) return cudaErrorInvalidValue;
  const long long grid = plan[5];
  if (grid <= 0 || grid > most) return cudaErrorInvalidValue;
  K5X3Params k = {};
  const void* ins[3] = {x, y, scratch};
  for (int i = 0; i < rdbs; ++i)
    for (int t = 0; t < 2; ++t)
      if (!encode(&k.tm_in[i][t], ins[i], 4, in_dims, in_strides, box[t],
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
        return cudaErrorNotSupported;
  for (int t = 0; t < 2; ++t)
    if (!encode(&k.tm_c[t], c, 4, c_dims, c_strides, box[t], CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return cudaErrorNotSupported;
  for (int i = 0; i < 5 * rdbs; ++i) {
    const int kk = i % 5;
    const long long cin = K5_NF + kk * K5_GC, cout = kk < 4 ? K5_GC : K5_NF;
    if (!ws[i] || !bs[i] || !aligned16(ws[i]) || !aligned16(bs[i])) return cudaErrorInvalidValue;
    const long long w_dims[4] = {cout, cin, 9, 3};
    const long long w_strides[3] = {cout * 2, cin * cout * 2, 9 * cin * cout * 2};
    const long long w_box[4] = {cout, KC, 9, 3};
    if (!encode(&k.tm_w[i], ws[i], 4, w_dims, w_strides, w_box,
                cout == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorNotSupported;
    k.b[i] = static_cast<const float*>(bs[i]);
  }
  k.x = static_cast<const float*>(x);
  k.x0 = static_cast<const float*>(x0);
  k.y = static_cast<float*>(y);
  k.scratch = static_cast<float*>(scratch);
  k.c = static_cast<float*>(c);
  k.B = B;
  k.H = H;
  k.W = W;
  k.rdbs = rdbs;
  k.tiles_x = (int)tiles_x;
  k.tiles_y32 = (int)ty32;
  k.tiles_y64 = (int)ty64;
  return launch_k5(k, (int)grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
