// K5, fp32-FMA route: the fp32 and bf16 instances at the narrow (nf, gc) =
// (16, 8) (the templates of rdb_fused.cuh), one translation unit, so that
// nvcc compiles the instances in parallel.

#include "rdb_fused.cuh"

namespace rdb_fma {

cudaError_t launch_f32_16(const RdbArgs& a, bool whole, cudaStream_t s) {
  return launch<float, 16, 8, 8>(a, whole, s);
}

cudaError_t launch_bf16_16(const RdbArgs& a, bool whole, cudaStream_t s) {
  return launch<__nv_bfloat16, 16, 8, 16>(a, whole, s);
}

}  // namespace rdb_fma
