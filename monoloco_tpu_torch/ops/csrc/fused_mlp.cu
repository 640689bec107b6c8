// Fused folded Loco MLP with f32 weights for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (K1, monoloco_tpu/ops/fused_mlp.py
// :63, called through `_fused_call`) when its weights are f32: f32 products
// and sums, fused multiply-adds on CUDA cores. No TF32: its 10-bit mantissa
// would not meet an f32 tolerance. (K1 with bf16 weights is wgmma_layer.cu.)
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
// memory, 128 KB at H = 1024, so a tile is 16 rows and hidden <= 1792 fits.
// The kernel is bound by its FMAs (2 * H^2 per row and layer at 67 TFLOP/s
// peak) and by reading the 32 MB of weights from L2 per 16-row tile: each
// thread owns 4 columns of all 16 rows (64 accumulators), loads 16 bytes of
// a weight row per k, and takes the activations as shared-memory
// broadcasts. Measured on the H100 at 131072 rows (PERF.md): 94.1 ms,
// against 52.0 ms for the f32 MLP in torch.matmul.
//
// A later PR should try a register-blocked tile with the weights staged
// through shared memory, or bf16x3 split products on the tensor cores, which
// keep f32 accuracy.

#include "mlp_common.cuh"

using namespace mlp;

namespace {

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

size_t smem_bytes(int hidden, int in_dim) {
  return static_cast<size_t>(kTileRows) * hidden * 2 * sizeof(float) +
         static_cast<size_t>(kTileRows) * in_dim * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                 const float* __restrict__ b0, const float* __restrict__ wstack,
                 const float* __restrict__ bstack, const float* __restrict__ waux,
                 const float* __restrict__ baux, const float* __restrict__ wfin,
                 const float* __restrict__ bfin, float* __restrict__ out, int m, int in_dim,
                 int hidden, int n_mm, int out_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);                      // (16, H) f32
  float* h = y + kTileRows * hidden;                              // (16, H) f32
  float* xs = h + kTileRows * hidden;                             // (16, in)

  const int row0 = blockIdx.x * kTileRows;
  load_tile_inputs<float>(x, xs, row0, m, in_dim);
  __syncthreads();
  input_layer(xs, w0, b0, y, in_dim, hidden);
  __syncthreads();

  const size_t hh = static_cast<size_t>(hidden) * hidden;
  // One H x H layer: dst (op)= src @ W_i + b_i.
  auto layer = [&](const float* src, int i, float* dst, Epilogue epilogue) {
    f32_layer(src, wstack + i * hh, bstack + i * hidden, dst, hidden, epilogue);
    __syncthreads();
  };

  const int n_stage = (n_mm - 2) / 2;
  for (int s = 0; s < n_stage; ++s) {
    layer(y, 2 * s, h, kRelu);
    layer(h, 2 * s + 1, y, kAddRelu);
  }
  layer(y, n_mm - 2, h, kStore);                                   // y2 -> h
  head_layer(h, waux, baux, 1, out, out_dim, out_dim - 1, row0, m, hidden);
  // The aux head still reads h, which the next layer only reads, so neither
  // needs a barrier first.
  layer(h, n_mm - 1, y, kRelu);                                    // y3 -> y
  head_layer(y, wfin, bfin, out_dim - 1, out, out_dim, 0, row0, m, hidden);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs.
size_t fused_mlp_smem_bytes(int hidden, int in_dim) { return smem_bytes(hidden, in_dim); }

// Launches on `stream`; returns the cudaError_t of the attribute call or of
// the launch (0 on success). The caller checks shapes and hidden % 128.
int fused_mlp_forward(const float* x, const float* w0, const float* b0, const float* wstack,
                      const float* bstack, const float* waux, const float* baux,
                      const float* wfin, const float* bfin, float* out, int m, int in_dim,
                      int hidden, int n_mm, int out_dim, void* stream) {
  if (m == 0) return 0;
  const size_t smem = smem_bytes(hidden, in_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  fused_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w0, b0, wstack, bstack, waux, baux, wfin, bfin, out, m, in_dim, hidden, n_mm, out_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
