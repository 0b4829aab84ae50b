// K2, rows route, fp32 instance: vr_unsharp_rows. The kernel, its note and
// its design are in unsharp_rows.cuh; the bf16 instance is built from the
// same template in unsharp_rows_bf16.cu.
//
// Replaces video_restore_tpu/ops/pallas_post.py unsharp_fused (its
// pallas_call at :167) on float32 frames.

#include "unsharp_rows.cuh"

extern "C" {

// taps: host array of 2 * radius + 1 floats; C must be 3, the paths' frames
// (the tile kernel in unsharp.cu takes any C). Returns the cudaError_t.
int vr_unsharp_rows(const float* x, float* y, int B, int H, int W, int C,
                    int radius, const float* taps, float amount, float threshold,
                    void* stream) {
  return run(x, y, B, H, W, C, radius, taps, amount, threshold, stream);
}

// The instance's registers a thread and resident blocks per SM at radius.
int vr_unsharp_rows_info(int radius, int* regs, int* blocks_per_sm) {
  return info<float>(radius, regs, blocks_per_sm);
}

}  // extern "C"
