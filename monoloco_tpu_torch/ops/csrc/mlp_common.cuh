// Pieces shared by the folded-MLP kernels for Hopper: the 16-row tile of
// dyn8_mlp.cu (K4), its epilogue stores, input projection and heads, which
// it runs on CUDA cores in f32 sums (their widths, in_dim and out_dim, are
// too narrow for an mma tile); and the epilogue codes, the bf16 rounding and
// the tf32 split that the layer kernels (wgmma_layer*.cu) use too.
//
// Float operations use explicit _rn intrinsics so that nvcc contracts
// nothing into an FMA it was not asked for.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kTileRows = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// k-steps whose weight loads are in flight at once in a layer's register
// ring; it divides 4, so that hidden % 128 == 0 makes whole rounds.
constexpr int kPrefetch = 4;
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

// What an activation becomes before a product with weights of type T: bf16
// rounds it, f32 keeps it.
template <typename T> __device__ __forceinline__ float act_in(float v);
template <> __device__ __forceinline__ float act_in<float>(float v) { return v; }
template <> __device__ __forceinline__ float act_in<__nv_bfloat16>(float v) {
  return bf16_round(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// d[0..3] (op)= v[0..3], with op the layer's epilogue; d is 16-byte aligned.
__device__ __forceinline__ void store4(float* d, const float v[4], Epilogue epilogue) {
  float4* p = reinterpret_cast<float4*>(d);
  if (epilogue == kStore) {
    *p = make_float4(v[0], v[1], v[2], v[3]);
  } else if (epilogue == kRelu) {
    *p = make_float4(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f), fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));
  } else {
    const float4 o = *p;
    *p = make_float4(__fadd_rn(o.x, fmaxf(v[0], 0.f)), __fadd_rn(o.y, fmaxf(v[1], 0.f)),
                     __fadd_rn(o.z, fmaxf(v[2], 0.f)), __fadd_rn(o.w, fmaxf(v[3], 0.f)));
  }
}

// xs[r][k] = act_in<T>(x[row0 + r][k]), zeros for rows past m (the JAX
// package pads with zeros; those rows are never stored).
template <typename T>
__device__ void load_tile_inputs(const float* __restrict__ x, float* xs, int row0, int m,
                                 int in_dim) {
  for (int i = threadIdx.x; i < kTileRows * in_dim; i += kThreads) {
    const int r = i / in_dim;
    const int k = i % in_dim;
    xs[i] = row0 + r < m ? act_in<T>(x[static_cast<size_t>(row0 + r) * in_dim + k]) : 0.f;
  }
}

// y[r][j] = relu(sum_k xs[r][k] * w0[k][j] + b0[j]); xs went through
// act_in<T> already, so with bf16 weights every product is exact in f32.
template <typename T>
__device__ void input_layer(const float* xs, const T* __restrict__ w0,
                            const float* __restrict__ b0, float* y, int in_dim, int hidden) {
  for (int j = threadIdx.x; j < hidden; j += kThreads) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < in_dim; ++k) {
      const float wv = to_f32(w0[static_cast<size_t>(k) * hidden + j]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = __fmaf_rn(xs[r * in_dim + k], wv, acc[r]);
    }
    const float b = b0[j];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) y[r * hidden + j] = fmaxf(__fadd_rn(acc[r], b), 0.f);
  }
}

// out[row0 + r][col0 + c] = sum_k act_in<T>(act[r][k]) * w[k][c] + b[c] for
// the rows of the tile that exist: one warp per (row, column) dot product.
template <typename T>
__device__ void head_layer(const float* act, const T* __restrict__ w,
                           const float* __restrict__ b, int ncols, float* out, int out_dim,
                           int col0, int row0, int m, int hidden) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int p = warp; p < kTileRows * ncols; p += kWarps) {
    const int r = p / ncols;
    const int c = p % ncols;
    float acc = 0.f;
    for (int k = lane; k < hidden; k += 32)
      acc = __fmaf_rn(act_in<T>(act[r * hidden + k]),
                      to_f32(w[static_cast<size_t>(k) * ncols + c]), acc);
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0 && row0 + r < m)
      out[static_cast<size_t>(row0 + r) * out_dim + col0 + c] = __fadd_rn(acc, b[c]);
  }
}

}  // namespace mlp
