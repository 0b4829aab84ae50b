// K4's A8 quantiser on bf16x2 pairs, shared by its tensor-core routes
// (conv3x3_i8_mma.cu, conv3x3_i8_wgmma.cu), so that both quantise with the
// same instructions.
//
// conv3x3_i8.cu's `quant` of one value is, in fp32: p = bf16(a * inv),
// t = bf16(p + copysign(0.5, p)), q = trunc(clip(t, -127.5, 127.5)). A
// bf16 product and a bf16 sum are exact in fp32, so the fp32 chain rounds
// the same exact values once to bf16, as `mul.rn.bf16x2` and
// `add.rn.bf16x2` do here (explicit `.rn`, so nothing fuses the two into
// one rounding); chip_smoke.py's [k4] phase checks every finite bf16 value
// through all three kernels.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace i8_quant {

constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mul_rn_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_rn_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// conv3x3_i8.cu's `quant` of two bf16 values (inv2: bf16(inv) twice), as two
// int8 bytes in the low half of the result
__device__ __forceinline__ uint32_t quant_pair(uint32_t v, uint32_t inv2) {
  const uint32_t p = mul_rn_bf16x2(v, inv2);
  const uint32_t half = (p & 0x80008000u) | 0x3f003f00u;  // copysign(0.5, p)
  __nv_bfloat162 t;
  *reinterpret_cast<uint32_t*>(&t) = add_rn_bf16x2(p, half);
  __nv_bfloat162 cmin, cmax;  // -127.5 and 127.5 twice, as bf16 bits
  *reinterpret_cast<uint32_t*>(&cmin) = 0xC2FFC2FFu;
  *reinterpret_cast<uint32_t*>(&cmax) = 0x42FF42FFu;
  t = __hmin2(__hmax2(t, cmin), cmax);
  const uint32_t tb = bf2_bits(t);
  const int lo = __float2int_rz(__uint_as_float(tb << 16));
  const int hi = __float2int_rz(__uint_as_float(tb & 0xffff0000u));
  return __byte_perm(lo, hi, 0x0040);
}

// Four bf16x2 words (8 channels) quantised: 8 int8 bytes in channel order.
__device__ __forceinline__ uint2 quant8(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                                        uint32_t inv2) {
  return make_uint2(__byte_perm(quant_pair(v0, inv2), quant_pair(v1, inv2), 0x5410),
                    __byte_perm(quant_pair(v2, inv2), quant_pair(v3, inv2), 0x5410));
}

// The dynamic A8 scale of a segment whose |max| is amax (conv3x3_i8.cu's).
__device__ __forceinline__ float act_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), kInv127);
}

// bf16(1 / sa) held as a float: the dynamic quantiser's multiplier.
__device__ __forceinline__ float act_inverse(float sa) {
  return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(1.0f, sa)));
}

// bf16(inv) twice: the quantiser's operand (exact: inv is a bf16 value).
__device__ __forceinline__ uint32_t inv_pair(float inv) {
  return bf2_bits(__float2bfloat162_rn(inv));
}

}  // namespace i8_quant
