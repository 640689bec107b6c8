// Pieces shared by the folded-MLP kernels for Hopper (dyn8_mlp.cu and
// fused_mlp.cu): the 16-row tile, the tensor-core instructions, the epilogue
// stores, and the input projection and heads, which every kernel runs on
// CUDA cores in f32 sums (their widths, in_dim and out_dim, are too narrow
// for an mma tile).
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
// Row pitch pad, in elements, of the bf16 activation tile that feeds the
// bf16 mma: H + 16 puts a half-warp's 8-byte A-fragment loads in 32
// different banks (H is a multiple of 128).
constexpr int kBf16Pad = 16;

enum Epilogue { kStore = 0, kRelu = 1, kAddRelu = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// acc (16x8, f32) += A (16x16, bf16, row-major) x B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float acc[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of one bf16 k16-step for lane (g, t), with the step's k
// order permuted so that each register pair is one 8-byte load: the mma's
// k = 2t, 2t+1 | 2t+8, 2t+9 are the step's columns 4t, 4t+1 | 4t+2, 4t+3.
// The B fragments must use the same permutation (a sum does not care).
// `lo` and `hi` point at rows g and g + 8, column 4t of the step.
__device__ __forceinline__ void load_a_bf16(const __nv_bfloat16* lo, const __nv_bfloat16* hi,
                                            uint32_t a[4]) {
  const uint2 l = *reinterpret_cast<const uint2*>(lo);
  const uint2 h = *reinterpret_cast<const uint2*>(hi);
  a[0] = l.x;
  a[1] = h.x;
  a[2] = l.y;
  a[3] = h.y;
}

// dst[r][j] = bf16(src[r][j]) for the tile, into a buffer of pitch H + kBf16Pad.
__device__ inline void round_rows_bf16(const float* src, __nv_bfloat16* dst, int hidden) {
  for (int i = threadIdx.x; i < kTileRows * hidden; i += kThreads) {
    const int r = i / hidden;
    const int k = i % hidden;
    dst[r * (hidden + kBf16Pad) + k] = __float2bfloat16_rn(src[i]);
  }
}

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
