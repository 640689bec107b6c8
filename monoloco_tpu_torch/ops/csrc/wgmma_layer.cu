// The folded Loco MLP with bf16 or int8 weights for NVIDIA Hopper (sm_90a),
// as one kernel launch per layer: an input projection, 2S + 2 H x H layers on
// TMA and wgmma, and the heads.
//
// Replaces two Pallas TPU kernels of monoloco_tpu/ops/fused_mlp.py:
//   K1 `_kernel` (:63, through `_fused_call`) with bf16 weights: every
//      product's activation is rounded to bf16, sums are f32;
//   K5 `_kernel_int8` act_mode 'none' (:367, through `_fused_call_int8`),
//      w8a16: bf16 activations times int8 weights (exact in bf16), f32 sums,
//      the per-column scale on the output.
// The input projection and heads kernels here serve K1 with f32 weights too
// (f32 flavours), dyn8 (as they are) and K4 (the input projection also
// writing the first layer's int8 input); their H x H layers, whose operands
// wgmma reads K-major only, are wgmma_layer_kmajor.cu.
//
// What bounds it. At hidden 1024 the eight H x H layers are 16.8 MFLOP a
// row: 2.2 TFLOP at 131072 rows, 2.2 ms at the bf16 peak (989 TFLOP/s),
// while the weights, inputs and outputs are about 40 MB. So the work is
// bound by its arithmetic, as long as each weight byte serves enough rows.
// The Pallas kernel kept a whole tile's activations in VMEM (megabytes) and
// ran all layers in one grid step; an SM has 227 KB, which at H = 1024 holds
// the activations of 16 rows, and then every 16-row tile re-reads the whole
// stack from L2 (137 GB per 131072-row call, the limit of the previous
// design). Here a layer is one launch over 128 x 256 output tiles: each
// weight byte is read once per 128 rows, and the activations
// cross device memory between layers (bf16, about 8 GB a call, 2.5 ms at
// 3.35 TB/s, partly hidden behind the products).
//
// The layer kernel: one persistent block of 384 threads per SM, walking
// over the output tiles. Warpgroup 2 is the producer: one thread
// keeps TMA loads of the A tile (bf16 activations, 128 rows x 64 k, 128-byte
// swizzle) and the B tile (64 k x BN, as 64-column boxes) in flight in a
// kStages-deep ring guarded by mbarriers. Warpgroups 0 and 1 each run wgmma
// m64nBNk16 bf16 -> f32 on their 64 rows, with A K-major and B MN-major: the
// weights keep their (in, out) layout, which wgmma reads with its transpose
// bit. The epilogue works on the accumulators in registers, in the float
// order of the previous kernels:
//   K1: v = acc + b;  K5: v = acc * oscale + b;
//   kRelu: out = bf16(relu(v));  kStore: out = bf16(v);
//   kAddRelu: y = y + relu(v) (f32, in place), out = bf16(y).
// Only the residual y stays f32: every other consumer of an activation
// rounds it to bf16 first, and bf16(relu(v)) == relu(bf16(v)).
//
// K5's int8 weights are widened to bf16 once per call, by widen_kernel into
// a scratch stack (8 MB -> 16 MB at H = 1024, 0.02-0.03 ms on the H100), and
// the layers then run as K1's with the column scale in the epilogue.
// Widening inside the layer kernel instead, once per 128-row tile, was
// tried and ran its layers well behind those with bf16 weights: the widened
// tile adds its shared-memory traffic to what the wgmma reads, and every
// tile widens its slice of the stack again.
//
// Rows: TMA fills rows past m with zeros and the epilogue stores rows < m
// only. The tile shape and the k order never depend on m and nothing splits
// K, so a row's result is the same whatever the batch around it.
//
// A next step: a 2-block cluster sharing each B tile by TMA multicast would
// halve the B reads from L2; consumer warpgroups on alternate tiles
// (ping-pong) would overlap one tile's epilogue with the next one's products.
// relu_chain.cu (K6's layer) measures that design on the card, with one
// wgmma group in flight and a TMA-store epilogue: see its note and PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>

#include "hopper_common.cuh"
#include "mlp_common.cuh"

using namespace hopper;

namespace {

constexpr int kBM = 128;                 // rows of an output tile
constexpr int kBK = 64;                  // k of a pipeline stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kLayerThreads = 384;       // two consumer warpgroups, one producer
constexpr int kConsumerThreads = 256;
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBoxBytes = 64 * kBK * 2;  // one 64-column box of a B tile, 8 KB
constexpr int kInRows = 32;              // rows of an input-projection block
constexpr int kMaxOut = 16;              // output columns the heads kernel takes

template <int BN>
struct Layout {
  static constexpr int kStageBytes = kABytes + kBK * BN * 2;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;
};

template <int N> struct Acc;
template <> struct Acc<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    wgmma_m64n256k16(d, a, b, 1);
  }
};
template <> struct Acc<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_m64n128k16(d, a, b, 1);
  }
};

// Four int8 values (the bytes of `word`) as two bf16 pairs, exactly. An
// int-to-float conversion runs at a quarter of the FP32 rate, so instead
// each byte b goes into the low mantissa byte of 2^23 (0x4B000000) as
// u = b + 128, and 2^23 + u - (2^23 + 128) = b exactly.
__device__ __forceinline__ void widen4(uint32_t word, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)), 8388736.0f);
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);   // .x (low half) = f[0]
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// dst[i] = bf16(src[i]) for n int8 values (n % 16 == 0): one 16-byte load
// and two 16-byte stores a thread and step.
__global__ void __launch_bounds__(256)
widen_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, size_t n16) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n16;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint4 raw = __ldg(src + i);
    uint4 lo, hi;
    widen4(raw.x, lo.x, lo.y);
    widen4(raw.y, lo.z, lo.w);
    widen4(raw.z, hi.x, hi.y);
    widen4(raw.w, hi.z, hi.w);
    dst[2 * i] = lo;
    dst[2 * i + 1] = hi;
  }
}

// One H x H layer; kScaled multiplies the sums by oscale (K5) before the
// bias. The grid is persistent: block b takes the 128 x BN output tiles b,
// b + gridDim.x, ..., and its producer loads the next tile's first stages
// while the consumers run the epilogue of the last one.
template <bool kScaled, int BN>
__global__ void __launch_bounds__(kLayerThreads, 1)
layer_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
             const float* __restrict__ oscale, const float* __restrict__ bias,
             float* __restrict__ y, __nv_bfloat16* __restrict__ out, int m, int hidden,
             int epilogue) {
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);   // stage loaded
  uint64_t* empty = full + kStages;                                      // stage free again
  auto a_tile = [&](int s) { return base + s * L::kStageBytes; };
  auto b_tile = [&](int s) { return base + s * L::kStageBytes + kABytes; };

  const int n_tiles = hidden / BN;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  const int nk = hidden / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumerThreads) {
      int g = 0;   // k-tiles this block has loaded
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(&empty[s], ((g / kStages) + 1) & 1);
          mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          tma_load_2d(a_tile(s), &a_map, &full[s], kt * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_tile(s) + j * kBoxBytes, &b_map, &full[s], n0 + 64 * j, kt * kBK);
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of the tile.
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    float d[BN / 2];
    int g = 0;   // k-tiles this block has consumed
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % kStages;
        mbar_wait(&full[s], (g / kStages) & 1);
        wgmma_wait<0>();                        // k-tile g - 1's products are done
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);
        wgmma_fence();
        const unsigned char* at = a_tile(s) + wg * 64 * 128;
        const unsigned char* bt = b_tile(s);
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          Acc<BN>::mma(d, sw128_desc(at + 32 * ks, 16, 1024),
                       sw128_desc(bt + 2048 * ks, kBoxBytes, 1024));
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);

      // Thread (warp, lane) holds rows r0 and r0 + 8, columns c0 + 8 j (+ 1).
      // The epilogue goes kChunk column groups at a time, all their loads
      // first, so that the residual's loads are in flight together.
      const int r0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
      constexpr int kChunk = 8;
      const bool add = epilogue == mlp::kAddRelu;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
        float2 b[kChunk], sc[kChunk], old[kChunk][2];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = c0 + 8 * (j0 + j);
          b[j] = __ldg(reinterpret_cast<const float2*>(bias + col));
          sc[j] = kScaled ? __ldg(reinterpret_cast<const float2*>(oscale + col))
                          : make_float2(1.f, 1.f);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            old[j][h] = add && r0 + 8 * h < m
                            ? *reinterpret_cast<const float2*>(
                                  y + static_cast<size_t>(r0 + 8 * h) * hidden + col)
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = c0 + 8 * (j0 + j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r >= m) continue;
            float v0 = d[4 * (j0 + j) + 2 * h];
            float v1 = d[4 * (j0 + j) + 2 * h + 1];
            if constexpr (kScaled) {
              v0 = __fadd_rn(__fmul_rn(v0, sc[j].x), b[j].x);
              v1 = __fadd_rn(__fmul_rn(v1, sc[j].y), b[j].y);
            } else {
              v0 = __fadd_rn(v0, b[j].x);
              v1 = __fadd_rn(v1, b[j].y);
            }
            const size_t off = static_cast<size_t>(r) * hidden + col;
            if (add) {
              v0 = __fadd_rn(old[j][h].x, fmaxf(v0, 0.f));
              v1 = __fadd_rn(old[j][h].y, fmaxf(v1, 0.f));
              *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
            } else if (epilogue == mlp::kRelu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// Two neighbouring weights, and eight activations (16-byte aligned), as
// floats.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// What the input projection writes besides y (f32): the first H x H layer's
// input.
enum class InOut {
  kBf16,        // bf16(y): K1-bf16, K5, dyn8 (whose layers quantize y)
  kTf32Parts,   // y's tf32 parts in out0, out1: K1-f32's 3xTF32 layers
  kInt8,        // clip(rint(y * inv[0]), +-127): K4's static layers
};

// y = relu(act_in<T>(x) @ w0 + b0) (f32, k in order) for kInRows rows a
// block, w0 of type T; a thread owns columns 2 j and 2 j + 1; out0 (and
// out1) get y's second form, kOut. The inputs sit in shared memory as
// (in_dim, kInRows), so one 16-byte broadcast feeds four rows of both
// columns.
template <typename T, InOut kOut>
__global__ void __launch_bounds__(256)
input_kernel(const float* __restrict__ x, const T* __restrict__ w0,
             const float* __restrict__ b0, float* __restrict__ y, void* __restrict__ out0,
             void* __restrict__ out1, const float* __restrict__ inv, int m, int in_dim,
             int hidden) {
  extern __shared__ float4 xs4[];   // (in_dim, kInRows) f32
  float* xs = reinterpret_cast<float*>(xs4);
  const int row0 = blockIdx.x * kInRows;
  float inv_q = 0.f;
  if constexpr (kOut == InOut::kInt8) inv_q = __ldg(inv);
  for (int i = threadIdx.x; i < kInRows * in_dim; i += blockDim.x) {
    const int r = i / in_dim;
    const int k = i % in_dim;
    xs[k * kInRows + r] =
        row0 + r < m ? mlp::act_in<T>(x[static_cast<size_t>(row0 + r) * in_dim + k]) : 0.f;
  }
  __syncthreads();
  for (int j = 2 * threadIdx.x; j < hidden; j += 2 * blockDim.x) {
    float acc[kInRows][2];
#pragma unroll
    for (int r = 0; r < kInRows; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int k = 0; k < in_dim; ++k) {
      const float2 wv = load2(w0 + static_cast<size_t>(k) * hidden + j);
#pragma unroll
      for (int r = 0; r < kInRows; r += 4) {
        const float4 xv = xs4[(k * kInRows + r) / 4];
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r + i][0] = __fmaf_rn(xr[i], wv.x, acc[r + i][0]);
          acc[r + i][1] = __fmaf_rn(xr[i], wv.y, acc[r + i][1]);
        }
      }
    }
    const float2 b = *reinterpret_cast<const float2*>(b0 + j);
#pragma unroll
    for (int r = 0; r < kInRows; ++r) {
      if (row0 + r >= m) break;
      const float v0 = fmaxf(__fadd_rn(acc[r][0], b.x), 0.f);
      const float v1 = fmaxf(__fadd_rn(acc[r][1], b.y), 0.f);
      const size_t off = static_cast<size_t>(row0 + r) * hidden + j;
      *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
      if constexpr (kOut == InOut::kTf32Parts)
        mlp::store_tf32_split2(static_cast<float*>(out0) + off, static_cast<float*>(out1) + off,
                               v0, v1);
      else if constexpr (kOut == InOut::kInt8)
        mlp::store_s8x2(static_cast<int8_t*>(out0) + off, v0, v1, inv_q);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out0) + off) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// out[row] = [y3 @ wfin + bfin, y2 @ waux + baux], activations and weights
// of type T: one warp per row, lane l sums k = 8 l + 256 i .. + 7 of every
// output column, then the warp adds its lanes. The heads' weights sit in
// shared memory as f32 (out_dim, H).
template <typename T>
__global__ void __launch_bounds__(256)
heads_kernel(const T* __restrict__ y2, const T* __restrict__ y3, const T* __restrict__ waux,
             const float* __restrict__ baux, const T* __restrict__ wfin,
             const float* __restrict__ bfin, float* __restrict__ out, int m, int hidden,
             int out_dim) {
  extern __shared__ float4 ws4[];   // (out_dim, hidden) f32
  float* ws = reinterpret_cast<float*>(ws4);
  const int n_fin = out_dim - 1;
  for (int i = threadIdx.x; i < hidden * out_dim; i += blockDim.x) {
    const int k = i / out_dim;
    const int c = i % out_dim;
    ws[c * hidden + k] = mlp::to_f32(c < n_fin ? wfin[static_cast<size_t>(k) * n_fin + c]
                                               : waux[k]);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * 8 + threadIdx.x / 32; row < m; row += gridDim.x * 8) {
    float acc[kMaxOut];
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int k0 = 8 * lane; k0 < hidden; k0 += 256) {
      const size_t off = static_cast<size_t>(row) * hidden + k0;
      float v3[8], v2[8];
      load8(y3 + off, v3);
      load8(y2 + off, v2);
#pragma unroll
      for (int c = 0; c < kMaxOut; ++c) {
        if (c >= out_dim) break;
        const float4 wa = ws4[(c * hidden + k0) / 4];
        const float4 wb = ws4[(c * hidden + k0) / 4 + 1];
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[c] = __fmaf_rn(c < n_fin ? v3[i] : v2[i], wv[i], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) {
      if (c >= out_dim) break;
      for (int off = 16; off > 0; off >>= 1)
        acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], off));
      if (lane == 0)
        out[static_cast<size_t>(row) * out_dim + c] =
            __fadd_rn(acc[c], c < n_fin ? bfin[c] : baux[0]);
    }
  }
}

template <typename T, InOut kOut>
int launch_input(const float* x, const void* w0, const float* b0, float* y, void* out0,
                 void* out1, const float* inv, int m, int in_dim, int hidden,
                 cudaStream_t stream) {
  if (m == 0) return 0;
  const size_t smem = static_cast<size_t>(kInRows) * in_dim * sizeof(float);
  input_kernel<T, kOut><<<(m + kInRows - 1) / kInRows, 256, smem, stream>>>(
      x, static_cast<const T*>(w0), b0, y, out0, out1, inv, m, in_dim, hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_heads(const void* y2, const void* y3, const void* waux, const float* baux,
                 const void* wfin, const float* bfin, float* out, int m, int hidden, int out_dim,
                 cudaStream_t stream) {
  if (m == 0) return 0;
  if (out_dim > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = hidden * out_dim * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(heads_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block stays resident and its warps loop over the rows.
  int sms = 0, per_sm = 0;
  int ierr = sm_count(&sms);
  if (ierr) return ierr;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, heads_kernel<T>, 256, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (m + 7) / 8;
  const int blocks = want < sms * per_sm ? want : sms * per_sm;
  heads_kernel<T><<<blocks, 256, smem, stream>>>(
      static_cast<const T*>(y2), static_cast<const T*>(y3), static_cast<const T*>(waux), baux,
      static_cast<const T*>(wfin), bfin, out, m, hidden, out_dim);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScaled, int BN>
int launch_layer(const void* a, const void* w, const float* oscale, const float* bias, float* y,
                 void* out, int m, int hidden, int epilogue, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  int err = make_map(&a_map, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, m, kBM);
  if (err) return err;
  err = make_map(&b_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, hidden, kBK);
  if (err) return err;
  constexpr int smem = Layout<BN>::kSmemBytes;
  cudaError_t cerr = cudaFuncSetAttribute(layer_kernel<kScaled, BN>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const int tiles = (m + kBM - 1) / kBM * (hidden / BN);
  const int grid = tiles < sms ? tiles : sms;
  layer_kernel<kScaled, BN><<<grid, kLayerThreads, smem, stream>>>(
      a_map, b_map, oscale, bias, y, static_cast<__nv_bfloat16*>(out), m, hidden, epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One H x H layer on `stream`: out (m, H) bf16 = epilogue(a (m, H) bf16 @ w
// (H, H) bf16, times oscale unless it is null, + bias); kAddRelu also
// updates y (m, H) f32 in place. Returns 0 or a cudaError_t (>= 1000: the
// TMA descriptor failed to encode). The caller checks shapes, alignment and
// hidden % 128 == 0.
int wgmma_layer_forward(const void* a, const void* w, const float* oscale, const float* bias,
                        float* y, void* out, int m, int hidden, int epilogue, void* stream) {
  if (m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool wide = hidden % 256 == 0;
  if (oscale != nullptr)
    return wide ? launch_layer<true, 256>(a, w, oscale, bias, y, out, m, hidden, epilogue, s)
                : launch_layer<true, 128>(a, w, oscale, bias, y, out, m, hidden, epilogue, s);
  return wide ? launch_layer<false, 256>(a, w, oscale, bias, y, out, m, hidden, epilogue, s)
              : launch_layer<false, 128>(a, w, oscale, bias, y, out, m, hidden, epilogue, s);
}

// dst (n) bf16 = src (n) int8, exactly; n % 16 == 0, both 16-byte aligned.
int widen_int8_forward(const void* src, void* dst, size_t n, void* stream) {
  if (n == 0) return 0;
  const size_t n16 = n / 16;
  const size_t want = (n16 + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 1024 ? want : 1024);
  widen_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16);
  return static_cast<int>(cudaGetLastError());
}

// y (m, H) f32 = relu(bf16(x) @ w0 + b0) and ybf = bf16(y), w0 (in, H) bf16.
int loco_input_forward(const float* x, const void* w0, const float* b0, float* y, void* ybf,
                       int m, int in_dim, int hidden, void* stream) {
  return launch_input<__nv_bfloat16, InOut::kBf16>(x, w0, b0, y, ybf, nullptr, nullptr, m,
                                                   in_dim, hidden,
                                                   static_cast<cudaStream_t>(stream));
}

// y (m, H) f32 as loco_input_forward, and q (m, H) int8 = clip(rint(y *
// inv[0]), +-127), the first static a8w8 layer's input; inv is a device
// pointer.
int loco_input_int8_forward(const float* x, const void* w0, const float* b0, float* y, void* q,
                            const float* inv, int m, int in_dim, int hidden, void* stream) {
  return launch_input<__nv_bfloat16, InOut::kInt8>(x, w0, b0, y, q, nullptr, inv, m, in_dim,
                                                   hidden, static_cast<cudaStream_t>(stream));
}

// y (m, H) f32 = relu(x @ w0 + b0), w0 (in, H) f32, and y's tf32 parts
// (big, small), the first operand of the 3xTF32 layers.
int loco_input_f32_forward(const float* x, const float* w0, const float* b0, float* y,
                           float* big, float* small, int m, int in_dim, int hidden,
                           void* stream) {
  return launch_input<float, InOut::kTf32Parts>(x, w0, b0, y, big, small, nullptr, m, in_dim,
                                                hidden, static_cast<cudaStream_t>(stream));
}

// out (m, out_dim) f32 = [y3 @ wfin + bfin, y2 @ waux + baux], y2 and y3
// (m, H) bf16, waux (H, 1) and wfin (H, out_dim - 1) bf16; out_dim <= 16.
int loco_heads_forward(const void* y2, const void* y3, const void* waux, const float* baux,
                       const void* wfin, const float* bfin, float* out, int m, int hidden,
                       int out_dim, void* stream) {
  return launch_heads<__nv_bfloat16>(y2, y3, waux, baux, wfin, bfin, out, m, hidden, out_dim,
                                     static_cast<cudaStream_t>(stream));
}

// The same with f32 activations and weights.
int loco_heads_f32_forward(const float* y2, const float* y3, const float* waux,
                           const float* baux, const float* wfin, const float* bfin, float* out,
                           int m, int hidden, int out_dim, void* stream) {
  return launch_heads<float>(y2, y3, waux, baux, wfin, bfin, out, m, hidden, out_dim,
                             static_cast<cudaStream_t>(stream));
}

// What an error code of this library's C functions means: a cudaError_t,
// or >= 1000 for a TMA descriptor that failed to encode.
const char* mlp_error_string(int code) {
  if (code >= kTmaError) return "cuTensorMapEncodeTiled failed (CUresult = code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
