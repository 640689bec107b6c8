// Fused static-int8 folded Loco MLP for NVIDIA Hopper (sm_90a): K4,
// `_kernel_int8` act_mode 'static' of monoloco_tpu/ops/fused_mlp.py (:367,
// through `_fused_call_int8`), a8w8 with the calibrated per-layer scalar
// inv_in. (dyn8, K2/K3, is wgmma_layer_kmajor.cu; K5 is wgmma_layer.cu.)
//
// One launch computes the whole folded forward for a tile of kTileRows rows:
//   y   = relu(bf16(x) @ bf16(W0) + b0)                     f32 sum
//   per stage: h = relu(mm(y, Wa)); y += relu(mm(h, Wb))
//   y2  = mm(y, W2);  aux = bf16(y2) @ bf16(Waux) + baux
//   y3  = relu(mm(y2, W3f));  fin = bf16(y3) @ bf16(Wfin) + bfin
//   out = [fin..., aux]                                     (m, out_dim) f32
// where mm(a, W) is, in the float order of `_int8_mm` 'static'
// (fused_mlp.py:335-343): q = clip(rint(a * inv_in), +-127); s8 x s8 -> s32;
// acc * out_scale + b (no row scale), with explicit _rn intrinsics so nvcc
// contracts nothing into an FMA.
//
// The activations never leave the SM: y and h (f32) and the layer input (q,
// int8) live in dynamic shared memory, about 16 * H * 9 bytes (144 KB at
// H = 1024), and never touch device memory.
// The weights stay in L2 (8 MB at H = 1024), so HBM bytes do not bound the
// kernel; but every 16-row tile re-reads the whole stack from L2, and
// measured on the H100 (PERF.md) a block takes about as long alone on the
// card as in a full grid: each SM is bound by how fast it pulls weight bytes
// from L2, with the tensor cores mostly idle. The design answers that in
// three ways: the products run on the tensor cores (mma.sync m16n8k32 s8,
// whose 16 rows are the tile), so the arithmetic costs little; each lane
// loads 4-byte words of four neighbouring weight rows (whole 32-byte sectors
// across the warp) and __byte_perm turns them into B fragments, so the
// weights keep their (in, out) layout and are read once per tile; and a ring
// of kPrefetch k-steps of weight words keeps those loads in flight. One
// 256-thread block fills an SM's shared memory.
//
// Next: the s8 layer kernel of wgmma_layer_kmajor.cu (128-row tiles on TMA
// and wgmma), with the static quantization in place of the per-row one.

#include "mlp_common.cuh"

using namespace mlp;

namespace {

// Row pitch of q in bytes: H + 16 puts the 32 lanes' A-fragment words in 32
// different shared-memory banks (H is a multiple of 128).
constexpr int kQPad = 16;

// q[r][k] = clip(rint(act[r][k] * inv_in), +-127), one scale for the tensor.
__device__ void quantize_rows_static(const float* act, int8_t* q, float inv_in, int hidden) {
  for (int i = threadIdx.x; i < kTileRows * hidden; i += kThreads) {
    const int r = i / hidden;
    const int k = i % hidden;
    const int v = __float2int_rn(__fmul_rn(act[i], inv_in));   // half to even
    q[r * (hidden + kQPad) + k] = static_cast<int8_t>(min(max(v, -127), 127));
  }
}

// 4x4 byte transpose: in[i] holds W[k+i][j..j+3]; out[c] holds W[k..k+3][j+c].
__device__ __forceinline__ void transpose4x4(const uint32_t in[4], uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// acc (16x8, s32) += A (16x32, s8, row-major) x B (32x8, s8, column-major).
__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of lane (g, t)'s weight words: w[k + 4t + i][cb + 4g .. + 3]
// in words[i] and w[k + 16 + 4t + i][...] in words[4 + i], i < 4.
__device__ __forceinline__ void load_weight_step(const int8_t* wl, int k, int hidden,
                                                 uint32_t words[8]) {
  const int8_t* wk = wl + static_cast<size_t>(k) * hidden;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    words[i] = __ldg(reinterpret_cast<const uint32_t*>(wk + static_cast<size_t>(i) * hidden));
    words[4 + i] = __ldg(reinterpret_cast<const uint32_t*>(
        wk + static_cast<size_t>(16 + i) * hidden));
  }
}

// dst (op)= mm(act, w) + bias for one H x H layer; `q` is the layer's
// input quantized (int8, pitch H + kQPad). w is (H, H) int8 in (in, out)
// layout. Each warp takes 32 output columns at a time as four mma
// n-tiles: lane (g, t) = (lane / 4, lane % 4) loads w[k + 4t + i][cb + 4g ..
// + 3] for i < 4, so n-tile c holds the columns cb + 4n + c (n < 8). Its
// accumulators then cover columns cb + 8t .. + 7 of rows g and g + 8. The
// 4x4 bytes are transposed into the B fragments of m16n8k32.
__device__ void int8w_layer(const int8_t* q, const int8_t* __restrict__ w,
                            const float* __restrict__ oscale, const float* __restrict__ bias,
                            float* dst, int hidden, Epilogue epilogue) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int8_t* q_lo = q + g * (hidden + kQPad) + 4 * t;            // row g
  const int8_t* q_hi = q + (g + 8) * (hidden + kQPad) + 4 * t;      // row g + 8
  for (int cb = warp * 32; cb < hidden; cb += kWarps * 32) {
    int iacc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) iacc[c][i] = 0;

    // Weight words of kPrefetch k-steps stay in flight in a register ring:
    // step k's slot is refilled with step k + kPrefetch * 32 right after it
    // is consumed. hidden % 128 == 0, so the steps come in whole rounds.
    const int8_t* wl = w + static_cast<size_t>(4 * t) * hidden + cb + 4 * g;
    uint32_t ring[kPrefetch][8];
#pragma unroll
    for (int st = 0; st < kPrefetch; ++st) load_weight_step(wl, 32 * st, hidden, ring[st]);
    for (int k0 = 0; k0 < hidden; k0 += 32 * kPrefetch) {
#pragma unroll
      for (int st = 0; st < kPrefetch; ++st) {
        const int k = k0 + 32 * st;
        uint32_t words[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) words[i] = ring[st][i];
        if (k + 32 * kPrefetch < hidden) load_weight_step(wl, k + 32 * kPrefetch, hidden, ring[st]);
        uint32_t blo[4], bhi[4];
        transpose4x4(words, blo);
        transpose4x4(words + 4, bhi);
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(q_lo + k);
        a[1] = *reinterpret_cast<const uint32_t*>(q_hi + k);
        a[2] = *reinterpret_cast<const uint32_t*>(q_lo + k + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(q_hi + k + 16);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(iacc[c], a, blo[c], bhi[c]);
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {          // rows g and g + 8
      const int r = g + 8 * half;
#pragma unroll
      for (int p = 0; p < 2; ++p) {                 // columns j0 .. j0 + 3
        const int j0 = cb + 8 * t + 4 * p;
        const float4 os = __ldg(reinterpret_cast<const float4*>(oscale + j0));
        const float4 bs = __ldg(reinterpret_cast<const float4*>(bias + j0));
        const float osv[4] = {os.x, os.y, os.z, os.w};
        const float bsv[4] = {bs.x, bs.y, bs.z, bs.w};
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 2 * half + p;   // acc * out_scale + b
          v[c] = __fadd_rn(__fmul_rn(__int2float_rn(iacc[c][e]), osv[c]), bsv[c]);
        }
        store4(dst + r * hidden + j0, v, epilogue);
      }
    }
  }
}

__host__ __device__ constexpr size_t q_tile_bytes(int hidden) {
  return static_cast<size_t>(kTileRows) * (hidden + kQPad);
}

__global__ void __launch_bounds__(kThreads)
int8w_mlp_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
                 const float* __restrict__ b0, const int8_t* __restrict__ wq,
                 const float* __restrict__ inv_in, const float* __restrict__ oscale,
                 const float* __restrict__ bstack, const __nv_bfloat16* __restrict__ waux,
                 const float* __restrict__ baux, const __nv_bfloat16* __restrict__ wfin,
                 const float* __restrict__ bfin, float* __restrict__ out, int m, int in_dim,
                 int hidden, int n_mm, int out_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);                      // (16, H) f32
  float* h = y + kTileRows * hidden;                              // (16, H) f32
  int8_t* q = reinterpret_cast<int8_t*>(h + kTileRows * hidden);   // (16, H + kQPad)
  float* xs = reinterpret_cast<float*>(q + q_tile_bytes(hidden));  // (16, in)

  const int row0 = blockIdx.x * kTileRows;
  load_tile_inputs<__nv_bfloat16>(x, xs, row0, m, in_dim);
  __syncthreads();
  input_layer(xs, w0, b0, y, in_dim, hidden);
  __syncthreads();

  const size_t hh = static_cast<size_t>(hidden) * hidden;
  // One H x H layer: dst (op)= mm(src, W_i).
  auto layer = [&](const float* src, int i, float* dst, Epilogue epilogue) {
    quantize_rows_static(src, q, inv_in[i], hidden);
    __syncthreads();
    int8w_layer(q, wq + i * hh, oscale + i * hidden, bstack + i * hidden, dst, hidden,
                epilogue);
    __syncthreads();
  };

  const int n_stage = (n_mm - 2) / 2;
  for (int s = 0; s < n_stage; ++s) {
    layer(y, 2 * s, h, kRelu);
    // The second layer reads only q, so its output adds straight into y.
    layer(h, 2 * s + 1, y, kAddRelu);
  }
  layer(y, n_mm - 2, h, kStore);                                   // y2 -> h
  head_layer(h, waux, baux, 1, out, out_dim, out_dim - 1, row0, m, hidden);
  layer(h, n_mm - 1, y, kRelu);                                    // y3 -> y
  head_layer(y, wfin, bfin, out_dim - 1, out, out_dim, 0, row0, m, hidden);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs.
size_t int8w_mlp_smem_bytes(int hidden, int in_dim) {
  return static_cast<size_t>(kTileRows) * hidden * 2 * sizeof(float) + q_tile_bytes(hidden) +
         static_cast<size_t>(kTileRows) * in_dim * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the attribute call or of
// the launch (0 on success). The caller checks shapes and hidden % 128.
int int8w_mlp_forward(const float* x, const void* w0, const float* b0,
                      const int8_t* wq, const float* inv_in, const float* oscale,
                      const float* bstack, const void* waux, const float* baux,
                      const void* wfin, const float* bfin, float* out, int m, int in_dim,
                      int hidden, int n_mm, int out_dim, void* stream) {
  if (m == 0) return 0;
  const size_t smem = int8w_mlp_smem_bytes(hidden, in_dim);
  cudaError_t err = cudaFuncSetAttribute(
      int8w_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  int8w_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(w0), b0, wq, inv_in, oscale, bstack,
      static_cast<const __nv_bfloat16*>(waux), baux,
      static_cast<const __nv_bfloat16*>(wfin), bfin, out, m, in_dim, hidden, n_mm,
      out_dim);
  return static_cast<int>(cudaGetLastError());
}

// What an error code of this library's C functions means: a cudaError_t,
// or >= 1000 for a TMA descriptor that failed to encode (wgmma_layer*.cu).
const char* mlp_error_string(int code) {
  if (code >= 1000) return "cuTensorMapEncodeTiled failed (CUresult = code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
