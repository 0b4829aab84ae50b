// K2, rows route, bf16 instance: vr_unsharp_rows_bf16. The kernel, its note
// and its design are in unsharp_rows.cuh (fp32 inside, one rounding on the
// store); the fp32 instance is built from the same template in
// unsharp_rows.cu. Its own translation unit, so that the two instances'
// 17 radii each build in parallel.
//
// Replaces video_restore_tpu/ops/pallas_post.py unsharp_fused (its
// pallas_call at :167) on the bf16 frames of VRT_POST_DT=bf16 (out_shape
// x.dtype, :175).

#include "unsharp_rows.cuh"

extern "C" {

// The same arguments as vr_unsharp_rows, on bfloat16 frames.
int vr_unsharp_rows_bf16(const void* x, void* y, int B, int H, int W, int C,
                         int radius, const float* taps, float amount,
                         float threshold, void* stream) {
  return run(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), B,
             H, W, C, radius, taps, amount, threshold, stream);
}

// The instance's registers a thread and resident blocks per SM at radius.
int vr_unsharp_rows_bf16_info(int radius, int* regs, int* blocks_per_sm) {
  return info<__nv_bfloat16>(radius, regs, blocks_per_sm);
}

}  // extern "C"
