// Pieces shared by the folded-MLP kernels for Hopper (wgmma_layer.cu,
// wgmma_layer_kmajor.cu): the epilogue codes, the bf16 rounding, the tf32
// split and the static int8 quantization.
//
// Float operations use explicit _rn intrinsics so that nvcc contracts
// nothing into an FMA it was not asked for.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

enum Epilogue { kStore = 0, kRelu = 1, kAddRelu = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as an f32 whose 13 low bits are zero: adding half of the dropped
// range to the magnitude bits carries into the kept ones. The plain version
// is `split_tf32_plain` in ops/fused_mlp.py.
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// The 3xTF32 split of v0 and v1: big = tf32(v), small = tf32(v - big), so
// that big + small is within 2^-22 |v| of v (v - big is exact in f32).
__device__ __forceinline__ void store_tf32_split2(float* big, float* small, float v0, float v1) {
  const float b0 = tf32_round(v0), b1 = tf32_round(v1);
  *reinterpret_cast<float2*>(big) = make_float2(b0, b1);
  *reinterpret_cast<float2*>(small) =
      make_float2(tf32_round(__fsub_rn(v0, b0)), tf32_round(__fsub_rn(v1, b1)));
}

// clip(rint(v * inv), +-127), rint half to even: the quantization of
// `_int8_mm` (monoloco_tpu/ops/fused_mlp.py:338, 349). A product beyond the
// int range saturates in the conversion and then clips like the rest.
__device__ __forceinline__ int quant_s8(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}

// quant_s8(v0, inv) and quant_s8(v1, inv) as the two bytes of a 16-bit
// word, v0 first in memory. The plain version is `quantize_static_plain` in
// ops/fused_mlp.py.
__device__ __forceinline__ uint32_t pack_s8x2(float v0, float v1, float inv) {
  return (static_cast<uint32_t>(quant_s8(v0, inv)) & 0xFFu) |
         ((static_cast<uint32_t>(quant_s8(v1, inv)) & 0xFFu) << 8);
}

// q[0], q[1] = quant_s8(v0, inv), quant_s8(v1, inv); q is 2-byte aligned.
__device__ __forceinline__ void store_s8x2(int8_t* q, float v0, float v1, float inv) {
  *reinterpret_cast<uint16_t*>(q) = static_cast<uint16_t>(pack_s8x2(v0, v1, inv));
}

// What an activation becomes before a product with weights of type T: bf16
// rounds it, f32 keeps it.
template <typename T> __device__ __forceinline__ float act_in(float v);
template <> __device__ __forceinline__ float act_in<float>(float v) { return v; }
template <> __device__ __forceinline__ float act_in<__nv_bfloat16>(float v) {
  return bf16_round(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

}  // namespace mlp
