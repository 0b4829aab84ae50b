// K5, fp32-FMA route: the bf16 instances at (nf, gc) = (64, 32)
// (the templates of rdb_fused.cuh), one translation unit, so that nvcc
// compiles the instances in parallel.

#include "rdb_fused.cuh"

namespace rdb_fma {

cudaError_t launch_bf16_64(const RdbArgs& a, bool whole, cudaStream_t s) {
  return launch<__nv_bfloat16, 64, 32, 16>(a, whole, s);
}

}  // namespace rdb_fma
