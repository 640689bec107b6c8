// Fused folded Loco MLP with bf16 or f32 weights for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (K1, monoloco_tpu/ops/fused_mlp.py,
// called through `_fused_call`), whose weight dtype picks the product type.
// The weight type T is this kernel's template parameter:
//   T = __nv_bfloat16: every product's activation is rounded to bf16 first
//       and the sums are f32 (mma.sync m16n8k16 bf16 on the tensor cores for
//       the H x H layers); the residual y stays f32.
//   T = float: f32 products and sums, fused multiply-adds on CUDA cores. No
//       TF32: its 10-bit mantissa would not meet an f32 tolerance.
//
// One launch computes the whole folded forward for a tile of kTileRows rows:
//   y   = relu(x @ W0 + b0)
//   per stage: h = relu(y @ Wa + ba); y += relu(h @ Wb + bb)
//   y2  = y @ W2 + b2;  aux = y2 @ Waux + baux
//   y3  = relu(y2 @ W3f + b3f);  fin = y3 @ Wfin + bfin
//   out = [fin..., aux]                                     (m, out_dim) f32
// As in the Pallas kernel, each product's sum is rounded before its bias is
// added, and explicit _rn intrinsics keep nvcc from fusing anything else.
//
// The layout is that of dyn8_mlp.cu: y and h (f32) stay in dynamic shared
// memory, 128 KB at H = 1024, plus for bf16 the layer input rounded to bf16
// (32 KB); so a tile is 16 rows and hidden <= 1408 fits (1792 with f32
// weights). The weights stay in L2 (16 MB bf16, 32 MB f32 at H = 1024). Every
// 16-row tile re-reads the whole stack from L2, which bounds the bf16 kernel
// as it bounds dyn8's, at twice dyn8's bytes: each lane loads 8-byte words of
// four neighbouring weight rows and __byte_perm pairs them into B fragments,
// with the mma's k order permuted (load_a_bf16) so that the weights keep
// their (in, out) layout and the activations load 8 bytes at a time; a ring
// of kPrefetch k-steps keeps the weight loads in flight. The f32 kernel is
// bound by its FMAs (2 * H^2 per row and layer at 67 TFLOP/s peak) and by
// reading 32 MB of weights per tile: each thread owns 4 columns of all 16
// rows (64 accumulators), loads 16 bytes of a weight row per k, and takes the
// activations as shared-memory broadcasts. Measured on the H100 at 131072
// rows (PERF.md): bf16 31.0 ms, f32 94.1 ms, against 8.9 and 52.0 ms for the
// bf16 and f32 MLPs in torch.matmul.
//
// A later PR should try, for bf16, what dyn8_mlp.cu's note lists (TMA rings,
// cluster multicast, wgmma on 64-row tiles, a persistent grid); for f32, a
// register-blocked tile with the weights staged through shared memory, or
// bf16x3 split products on the tensor cores, which keep f32 accuracy.

#include <type_traits>

#include "mlp_common.cuh"

using namespace mlp;

namespace {

// One bf16 k16-step of lane (g, t)'s weight words: rows k + 4t + i (i < 4)
// of w, 8 bytes each at columns cb + 4g .. + 3.
__device__ __forceinline__ void load_bf16_step(const __nv_bfloat16* wl, int k, int hidden,
                                               uint2 words[4]) {
  const __nv_bfloat16* wk = wl + static_cast<size_t>(k) * hidden;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    words[i] = __ldg(reinterpret_cast<const uint2*>(wk + static_cast<size_t>(i) * hidden));
}

// dst (op)= bf16(act) @ w + bias for one H x H bf16 layer. `abf` is the
// layer's input rounded to bf16 (pitch H + kBf16Pad). Each warp takes 32
// output columns at a time as four mma n-tiles: n-tile c holds columns
// cb + 4n + c (n < 8), so lane (g, t)'s accumulators cover columns
// cb + 8t .. + 7 of rows g and g + 8.
__device__ void bf16_layer(const __nv_bfloat16* abf, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, float* dst, int hidden,
                           Epilogue epilogue) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16* a_lo = abf + g * (hidden + kBf16Pad) + 4 * t;
  const __nv_bfloat16* a_hi = abf + (g + 8) * (hidden + kBf16Pad) + 4 * t;
  for (int cb = warp * 32; cb < hidden; cb += kWarps * 32) {
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

    const __nv_bfloat16* wl = w + static_cast<size_t>(4 * t) * hidden + cb + 4 * g;
    uint2 ring[kPrefetch][4];
#pragma unroll
    for (int st = 0; st < kPrefetch; ++st) load_bf16_step(wl, 16 * st, hidden, ring[st]);
    for (int k0 = 0; k0 < hidden; k0 += 16 * kPrefetch) {
#pragma unroll
      for (int st = 0; st < kPrefetch; ++st) {
        const int k = k0 + 16 * st;
        uint2 u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = ring[st][i];
        if (k + 16 * kPrefetch < hidden) load_bf16_step(wl, k + 16 * kPrefetch, hidden, ring[st]);
        uint32_t a[4];
        load_a_bf16(a_lo + k, a_hi + k, a);
        // n-tile c = column 4g + c: the low (c even) or high (c odd) half of
        // word .x (c < 2) or .y of rows 4t, 4t+1 (b0) and 4t+2, 4t+3 (b1).
        mma_bf16(acc[0], a, __byte_perm(u[0].x, u[1].x, 0x5410), __byte_perm(u[2].x, u[3].x, 0x5410));
        mma_bf16(acc[1], a, __byte_perm(u[0].x, u[1].x, 0x7632), __byte_perm(u[2].x, u[3].x, 0x7632));
        mma_bf16(acc[2], a, __byte_perm(u[0].y, u[1].y, 0x5410), __byte_perm(u[2].y, u[3].y, 0x5410));
        mma_bf16(acc[3], a, __byte_perm(u[0].y, u[1].y, 0x7632), __byte_perm(u[2].y, u[3].y, 0x7632));
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {          // rows g and g + 8
      const int r = g + 8 * half;
#pragma unroll
      for (int p = 0; p < 2; ++p) {                 // columns j0 .. j0 + 3
        const int j0 = cb + 8 * t + 4 * p;
        const float4 bs = __ldg(reinterpret_cast<const float4*>(bias + j0));
        const float v[4] = {__fadd_rn(acc[0][2 * half + p], bs.x),
                            __fadd_rn(acc[1][2 * half + p], bs.y),
                            __fadd_rn(acc[2][2 * half + p], bs.z),
                            __fadd_rn(acc[3][2 * half + p], bs.w)};
        store4(dst + r * hidden + j0, v, epilogue);
      }
    }
  }
}

// dst (op)= act @ w + bias for one H x H f32 layer on CUDA cores: thread
// owns columns 4cg .. 4cg + 3 of all 16 rows and sums over k in order.
__device__ void f32_layer(const float* act, const float* __restrict__ w,
                          const float* __restrict__ bias, float* dst, int hidden,
                          Epilogue epilogue) {
  for (int cg = threadIdx.x; cg < hidden / 4; cg += kThreads) {
    float acc[kTileRows][4];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const float* wc = w + 4 * cg;
    for (int k = 0; k < hidden; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = __ldg(reinterpret_cast<const float4*>(wc + static_cast<size_t>(k + i) * hidden));
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(act + r * hidden + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r][0] = __fmaf_rn(av[i], wv[i].x, acc[r][0]);
          acc[r][1] = __fmaf_rn(av[i], wv[i].y, acc[r][1]);
          acc[r][2] = __fmaf_rn(av[i], wv[i].z, acc[r][2]);
          acc[r][3] = __fmaf_rn(av[i], wv[i].w, acc[r][3]);
        }
      }
    }
    const float4 bs = __ldg(reinterpret_cast<const float4*>(bias + 4 * cg));
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float v[4] = {__fadd_rn(acc[r][0], bs.x), __fadd_rn(acc[r][1], bs.y),
                          __fadd_rn(acc[r][2], bs.z), __fadd_rn(acc[r][3], bs.w)};
      store4(dst + r * hidden + 4 * cg, v, epilogue);
    }
  }
}

template <typename T>
__host__ __device__ constexpr size_t bf16_tile_bytes(int hidden) {
  return std::is_same<T, __nv_bfloat16>::value
             ? static_cast<size_t>(kTileRows) * (hidden + kBf16Pad) * sizeof(__nv_bfloat16)
             : 0;
}

template <typename T>
size_t smem_bytes(int hidden, int in_dim) {
  return static_cast<size_t>(kTileRows) * hidden * 2 * sizeof(float) + bf16_tile_bytes<T>(hidden) +
         static_cast<size_t>(kTileRows) * in_dim * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, const T* __restrict__ w0,
                 const float* __restrict__ b0, const T* __restrict__ wstack,
                 const float* __restrict__ bstack, const T* __restrict__ waux,
                 const float* __restrict__ baux, const T* __restrict__ wfin,
                 const float* __restrict__ bfin, float* __restrict__ out, int m, int in_dim,
                 int hidden, int n_mm, int out_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);                      // (16, H) f32
  float* h = y + kTileRows * hidden;                              // (16, H) f32
  __nv_bfloat16* abf = reinterpret_cast<__nv_bfloat16*>(h + kTileRows * hidden);
  float* xs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(abf) +
                                       bf16_tile_bytes<T>(hidden));  // (16, in)

  const int row0 = blockIdx.x * kTileRows;
  load_tile_inputs<T>(x, xs, row0, m, in_dim);
  __syncthreads();
  input_layer(xs, w0, b0, y, in_dim, hidden);
  __syncthreads();

  const size_t hh = static_cast<size_t>(hidden) * hidden;
  // One H x H layer: dst (op)= src @ W_i + b_i. For bf16 the layer reads
  // only its rounded copy of src, so dst may be any buffer but that copy.
  auto layer = [&](const float* src, int i, float* dst, Epilogue epilogue) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      round_rows_bf16(src, abf, hidden);
      __syncthreads();
      bf16_layer(abf, wstack + i * hh, bstack + i * hidden, dst, hidden, epilogue);
    } else {
      f32_layer(src, wstack + i * hh, bstack + i * hidden, dst, hidden, epilogue);
    }
    __syncthreads();
  };

  const int n_stage = (n_mm - 2) / 2;
  for (int s = 0; s < n_stage; ++s) {
    layer(y, 2 * s, h, kRelu);
    layer(h, 2 * s + 1, y, kAddRelu);
  }
  layer(y, n_mm - 2, h, kStore);                                   // y2 -> h
  head_layer(h, waux, baux, 1, out, out_dim, out_dim - 1, row0, m, hidden);
  // The aux head still reads h: the bf16 layer only reads it into abf, and
  // the f32 layer only reads it, so neither needs a barrier first.
  layer(h, n_mm - 1, y, kRelu);                                    // y3 -> y
  head_layer(y, wfin, bfin, out_dim - 1, out, out_dim, 0, row0, m, hidden);
}

template <typename T>
int launch(const float* x, const void* w0, const float* b0, const void* wstack,
           const float* bstack, const void* waux, const float* baux, const void* wfin,
           const float* bfin, float* out, int m, int in_dim, int hidden, int n_mm, int out_dim,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hidden, in_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  fused_mlp_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, static_cast<const T*>(w0), b0, static_cast<const T*>(wstack), bstack,
      static_cast<const T*>(waux), baux, static_cast<const T*>(wfin), bfin, out, m, in_dim,
      hidden, n_mm, out_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; bf16 != 0 for bf16 weights.
size_t fused_mlp_smem_bytes(int bf16, int hidden, int in_dim) {
  return bf16 ? smem_bytes<__nv_bfloat16>(hidden, in_dim) : smem_bytes<float>(hidden, in_dim);
}

// Launches on `stream` with bf16 (bf16 != 0) or f32 weights; returns the
// cudaError_t of the attribute call or of the launch (0 on success). The
// caller checks shapes and hidden % 128.
int fused_mlp_forward(int bf16, const float* x, const void* w0, const float* b0,
                      const void* wstack, const float* bstack, const void* waux,
                      const float* baux, const void* wfin, const float* bfin, float* out, int m,
                      int in_dim, int hidden, int n_mm, int out_dim, void* stream) {
  if (m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w0, b0, wstack, bstack, waux, baux, wfin, bfin, out, m,
                                      in_dim, hidden, n_mm, out_dim, s)
              : launch<float>(x, w0, b0, wstack, bstack, waux, baux, wfin, bfin, out, m, in_dim,
                              hidden, n_mm, out_dim, s);
}

}  // extern "C"
