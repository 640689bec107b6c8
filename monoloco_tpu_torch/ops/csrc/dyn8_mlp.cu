// Fused dynamic-int8 (dyn8) folded Loco MLP for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kernel_int8` (act_mode 'dynamic',
// streaming) and `_kernel_int8_resident` in monoloco_tpu/ops/fused_mlp.py.
// The two differ only in where the int8 weight stack lives on the TPU; here
// one kernel serves both, and "resident" means the stack (8 MB at hidden
// 1024) stays in the 50 MB L2 that every block reads it from.
//
// One launch computes the whole folded forward for a tile of kTileRows rows:
//   y   = relu(bf16(x) @ bf16(W0) + b0)                     f32 sum
//   per stage: h = relu(mm8(y, Wa)); y += relu(mm8(h, Wb))
//   y2  = mm8(y, W2);  aux = bf16(y2) @ bf16(Waux) + baux
//   y3  = relu(mm8(y2, W3f));  fin = bf16(y3) @ bf16(Wfin) + bfin
//   out = [fin..., aux]                                     (m, out_dim) f32
// where mm8(a, W) quantizes each row of `a` on its own amax
// (q = clip(rint(a * 127/max(amax, 1e-8)), +-127)), multiplies s8 x s8 into
// s32, and rescales: acc * (row_scale * col_scale) + b. The float operations
// run in the order of `_int8_mm` (fused_mlp.py:344-356), with explicit _rn
// intrinsics so nvcc contracts nothing into an FMA.
//
// The activations never leave the SM: y and h (f32) and q (int8) live in
// dynamic shared memory, about 16 * H * 9 bytes (144 KB at H = 1024), and
// never touch device memory. The weights stay in L2 (8 MB at H = 1024), so
// HBM bytes do not bound the kernel; but every 16-row tile re-reads the
// whole stack from L2, and measured on the H100 (PERF.md) a block takes
// about as long alone on the card as in a full grid: each SM is bound by
// how fast it pulls weight bytes from L2, with the tensor cores mostly idle.
// The design answers that in three ways: the s8 x s8 products run on the
// tensor cores (mma.sync m16n8k32, whose 16 rows are the tile), so the
// arithmetic costs little; each lane loads 4-byte words of four neighbouring
// weight rows (whole 32-byte sectors across the warp) and __byte_perm turns
// them into B fragments, so the weights keep their (in, out) layout and are
// read once per tile; and a ring of kPrefetch k-steps of weight words keeps
// those loads in flight. One 256-thread block fills an SM's shared memory.
//
// A later PR should try: TMA (or cp.async) rings of weight tiles in the
// free shared memory, read with 16-byte loads; TMA multicast across a
// cluster, so neighbouring SMs share one L2 read of each tile; wgmma with
// 64-row tiles to reuse each weight byte on more rows; a persistent grid of
// one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Row pitch of q in bytes: H + 16 puts the 32 lanes' A-fragment words in 32
// different shared-memory banks (H is a multiple of 128).
constexpr int kQPad = 16;
// k-steps of 32 whose weight loads are in flight at once; it divides 4, so
// that hidden % 128 == 0 makes whole rounds.
constexpr int kPrefetch = 4;

enum Epilogue { kStore = 0, kRelu = 1, kAddRelu = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// q[r][k] = clip(rint(act[r][k] * 127 / max(amax_r, 1e-8)), +-127) and
// row_scale[r] = max(amax_r, 1e-8) * (1/127): one warp per row.
__device__ void quantize_rows(const float* act, int8_t* q, float* row_scale,
                              int hidden) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTileRows; r += kWarps) {
    const float* a = act + r * hidden;
    float amax = 0.f;
    for (int k = lane; k < hidden; k += 32) amax = fmaxf(amax, fabsf(a[k]));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float safe = fmaxf(amax, 1e-8f);
    const float inv = __fdiv_rn(127.0f, safe);
    int8_t* qr = q + r * (hidden + kQPad);
    for (int k = lane; k < hidden; k += 32) {
      int v = __float2int_rn(__fmul_rn(a[k], inv));   // half to even
      qr[k] = static_cast<int8_t>(min(max(v, -127), 127));
    }
    if (lane == 0) row_scale[r] = __fmul_rn(safe, 1.0f / 127.0f);
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

// dst (op)= acc * (row_scale[r] * oscale[j]) + bias[j], with acc the s8 x s8
// product of q (kTileRows, H; pitch H + kQPad) and w (H, H) in (in, out)
// layout. Each warp takes 32 output columns at a time as four mma n-tiles:
// lane (g, t) = (lane / 4, lane % 4) loads w[k + 4t + i][cb + 4g .. + 3] for
// i < 4 and transposes the 4x4 bytes, so n-tile c holds the columns
// cb + 4n + c (n < 8). Its accumulators then cover columns cb + 8t .. + 7 of
// rows g and g + 8.
__device__ void int8_layer(const int8_t* q, const float* row_scale,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ oscale,
                           const float* __restrict__ bias, float* dst,
                           int hidden, Epilogue epilogue) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pitch = hidden + kQPad;
  const int8_t* q_lo = q + g * pitch + 4 * t;         // row g
  const int8_t* q_hi = q + (g + 8) * pitch + 4 * t;   // row g + 8
  for (int cb = warp * 32; cb < hidden; cb += kWarps * 32) {
    int acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0;

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
        uint32_t blo[4], bhi[4];
        transpose4x4(ring[st], blo);
        transpose4x4(ring[st] + 4, bhi);
        if (k + 32 * kPrefetch < hidden) load_weight_step(wl, k + 32 * kPrefetch, hidden, ring[st]);
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(q_lo + k);
        a[1] = *reinterpret_cast<const uint32_t*>(q_hi + k);
        a[2] = *reinterpret_cast<const uint32_t*>(q_lo + k + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(q_hi + k + 16);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(acc[c], a, blo[c], bhi[c]);
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {          // rows g and g + 8
      const int r = g + 8 * half;
      const float s = row_scale[r];
#pragma unroll
      for (int p = 0; p < 2; ++p) {                 // columns j0 .. j0 + 3
        const int j0 = cb + 8 * t + 4 * p;
        const float4 os = __ldg(reinterpret_cast<const float4*>(oscale + j0));
        const float4 bs = __ldg(reinterpret_cast<const float4*>(bias + j0));
        const float osv[4] = {os.x, os.y, os.z, os.w};
        const float bsv[4] = {bs.x, bs.y, bs.z, bs.w};
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = __fadd_rn(__fmul_rn(__int2float_rn(acc[c][2 * half + p]),
                                     __fmul_rn(s, osv[c])),
                           bsv[c]);
        float4* d = reinterpret_cast<float4*>(dst + r * hidden + j0);
        if (epilogue == kStore) {
          *d = make_float4(v[0], v[1], v[2], v[3]);
        } else if (epilogue == kRelu) {
          *d = make_float4(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f), fmaxf(v[2], 0.f),
                           fmaxf(v[3], 0.f));
        } else {
          const float4 o = *d;
          *d = make_float4(__fadd_rn(o.x, fmaxf(v[0], 0.f)), __fadd_rn(o.y, fmaxf(v[1], 0.f)),
                           __fadd_rn(o.z, fmaxf(v[2], 0.f)), __fadd_rn(o.w, fmaxf(v[3], 0.f)));
        }
      }
    }
  }
}

// y[r][j] = relu(sum_k xs[r][k] * bf16(w0[k][j]) + b0[j]); xs is already
// rounded to bf16, so every product is exact in f32.
__device__ void input_layer(const float* xs, const __nv_bfloat16* __restrict__ w0,
                            const float* __restrict__ b0, float* y, int in_dim,
                            int hidden) {
  for (int j = threadIdx.x; j < hidden; j += kThreads) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < in_dim; ++k) {
      const float wv = __bfloat162float(w0[static_cast<size_t>(k) * hidden + j]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = __fmaf_rn(xs[r * in_dim + k], wv, acc[r]);
    }
    const float b = b0[j];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) y[r * hidden + j] = fmaxf(__fadd_rn(acc[r], b), 0.f);
  }
}

// out[row0 + r][col0 + c] = sum_k bf16(act[r][k]) * bf16(w[k][c]) + b[c] for
// the rows of the tile that exist: one warp per (row, column) dot product.
__device__ void head_layer(const float* act, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ b, int ncols, float* out,
                           int out_dim, int col0, int row0, int m, int hidden) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int p = warp; p < kTileRows * ncols; p += kWarps) {
    const int r = p / ncols;
    const int c = p % ncols;
    float acc = 0.f;
    for (int k = lane; k < hidden; k += 32)
      acc = __fmaf_rn(bf16_round(act[r * hidden + k]),
                      __bfloat162float(w[static_cast<size_t>(k) * ncols + c]), acc);
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0 && row0 + r < m)
      out[static_cast<size_t>(row0 + r) * out_dim + col0 + c] = __fadd_rn(acc, b[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
dyn8_mlp_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
                const float* __restrict__ b0, const int8_t* __restrict__ wq,
                const float* __restrict__ oscale, const float* __restrict__ bstack,
                const __nv_bfloat16* __restrict__ waux, const float* __restrict__ baux,
                const __nv_bfloat16* __restrict__ wfin, const float* __restrict__ bfin,
                float* __restrict__ out, int m, int in_dim, int hidden, int n_mm,
                int out_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);                      // (16, H) f32
  float* h = y + kTileRows * hidden;                              // (16, H) f32
  int8_t* q = reinterpret_cast<int8_t*>(h + kTileRows * hidden);  // (16, H + 16) s8
  float* xs = reinterpret_cast<float*>(q + kTileRows * (hidden + kQPad));  // (16, in)
  float* row_scale = xs + kTileRows * in_dim;                     // (16,) f32

  const int row0 = blockIdx.x * kTileRows;
  // Rows past m compute on zeros (the JAX package pads with zeros) and are
  // never stored.
  for (int i = threadIdx.x; i < kTileRows * in_dim; i += kThreads) {
    const int r = i / in_dim;
    const int k = i % in_dim;
    xs[i] = row0 + r < m ? bf16_round(x[static_cast<size_t>(row0 + r) * in_dim + k]) : 0.f;
  }
  __syncthreads();
  input_layer(xs, w0, b0, y, in_dim, hidden);
  __syncthreads();

  const size_t hh = static_cast<size_t>(hidden) * hidden;
  const int n_stage = (n_mm - 2) / 2;
  for (int s = 0; s < n_stage; ++s) {
    const int ia = 2 * s;
    const int ib = 2 * s + 1;
    quantize_rows(y, q, row_scale, hidden);
    __syncthreads();
    int8_layer(q, row_scale, wq + ia * hh, oscale + ia * hidden, bstack + ia * hidden,
               h, hidden, kRelu);
    __syncthreads();
    quantize_rows(h, q, row_scale, hidden);
    __syncthreads();
    // The second layer reads only q, so its output adds straight into y.
    int8_layer(q, row_scale, wq + ib * hh, oscale + ib * hidden, bstack + ib * hidden,
               y, hidden, kAddRelu);
    __syncthreads();
  }

  const int i2 = n_mm - 2;
  const int i3 = n_mm - 1;
  quantize_rows(y, q, row_scale, hidden);
  __syncthreads();
  int8_layer(q, row_scale, wq + i2 * hh, oscale + i2 * hidden, bstack + i2 * hidden,
             h, hidden, kStore);                                   // y2 -> h
  __syncthreads();
  head_layer(h, waux, baux, 1, out, out_dim, out_dim - 1, row0, m, hidden);
  quantize_rows(h, q, row_scale, hidden);                          // w3f reads y2
  __syncthreads();
  int8_layer(q, row_scale, wq + i3 * hh, oscale + i3 * hidden, bstack + i3 * hidden,
             y, hidden, kRelu);                                    // y3 -> y
  __syncthreads();
  head_layer(y, wfin, bfin, out_dim - 1, out, out_dim, 0, row0, m, hidden);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs.
size_t dyn8_mlp_smem_bytes(int hidden, int in_dim) {
  return static_cast<size_t>(kTileRows) * hidden * 2 * sizeof(float) +
         static_cast<size_t>(kTileRows) * (hidden + kQPad) +
         static_cast<size_t>(kTileRows) * in_dim * sizeof(float) +
         kTileRows * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the attribute call or of
// the launch (0 on success). The caller checks shapes and hidden % 128.
int dyn8_mlp_forward(const float* x, const void* w0, const float* b0, const int8_t* wq,
                     const float* oscale, const float* bstack, const void* waux,
                     const float* baux, const void* wfin, const float* bfin, float* out,
                     int m, int in_dim, int hidden, int n_mm, int out_dim, void* stream) {
  if (m == 0) return 0;
  const size_t smem = dyn8_mlp_smem_bytes(hidden, in_dim);
  cudaError_t err = cudaFuncSetAttribute(
      dyn8_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  dyn8_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(w0), b0, wq, oscale, bstack,
      static_cast<const __nv_bfloat16*>(waux), baux,
      static_cast<const __nv_bfloat16*>(wfin), bfin, out, m, in_dim, hidden, n_mm,
      out_dim);
  return static_cast<int>(cudaGetLastError());
}

const char* dyn8_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
