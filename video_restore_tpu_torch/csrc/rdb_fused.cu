// K5, fp32-FMA route: the C entry points. The kernel and its note are in
// rdb_fused.cuh; its four instances (fp32 and bf16 at (64, 32) and at the
// narrow (16, 8)) are compiled in rdb_fused_f32.cu, rdb_fused_bf16.cu and
// rdb_fused_narrow.cu, one nvcc each.

#include <cuda_runtime.h>

#include "rdb_fused.cuh"

namespace {

using rdb_fma::RdbArgs;

cudaError_t dispatch(int dtype, int nf, int gc, const RdbArgs& a, bool whole,
                     cudaStream_t s) {
  if (nf == 64 && gc == 32) {
    if (dtype == 0) return rdb_fma::launch_f32_64(a, whole, s);
    if (dtype == 1) return rdb_fma::launch_bf16_64(a, whole, s);
  } else if (nf == 16 && gc == 8) {
    if (dtype == 0) return rdb_fma::launch_f32_16(a, whole, s);
    if (dtype == 1) return rdb_fma::launch_bf16_16(a, whole, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One RDB: y = RDB(x) [x0 + 0.2 RDB(x) when x0 is not null]. ws/bs: the five
// conv weights and biases. dtype: 0 = float32, 1 = bfloat16; (nf, gc) in
// {(64, 32), (16, 8)}. Returns the cudaError_t of the launch.
int vr_rdb_fused(int dtype, int nf, int gc, const void* x, const void* x0,
                 void* y, const void* const* ws, const void* const* bs, int B,
                 int H, int W, void* stream) {
  RdbArgs a = {};
  a.x = x; a.x0 = x0; a.y = y; a.scratch = nullptr;
  for (int k = 0; k < 5; ++k) {
    a.p[0].w[k] = ws[k];
    a.p[0].b[k] = bs[k];
  }
  a.B = B; a.H = H; a.W = W;
  return dispatch(dtype, nf, gc, a, false, static_cast<cudaStream_t>(stream));
}

// A whole RRDB: y = x + 0.2 RDB3(RDB2(RDB1(x))) in one cooperative launch.
// ws/bs: the 15 conv weights and biases, RDB-major; scratch: (B, H, W, nf)
// in x's dtype. Returns the cudaError_t of the launch.
int vr_rrdb_fused(int dtype, int nf, int gc, const void* x, void* y,
                  void* scratch, const void* const* ws, const void* const* bs,
                  int B, int H, int W, void* stream) {
  RdbArgs a = {};
  a.x = x; a.x0 = nullptr; a.y = y; a.scratch = scratch;
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 5; ++k) {
      a.p[r].w[k] = ws[5 * r + k];
      a.p[r].b[k] = bs[5 * r + k];
    }
  a.B = B; a.H = H; a.W = W;
  return dispatch(dtype, nf, gc, a, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
