// The H x H layers of the folded Loco MLP whose operands wgmma reads K-major
// only, for NVIDIA Hopper (sm_90a): one persistent TMA + wgmma launch per
// layer with the layer's epilogue fused, and the small launches around it.
//
// With the input projection and heads kernels of wgmma_layer.cu, replaces
// three Pallas TPU kernels of monoloco_tpu/ops/fused_mlp.py:
//   K1 `_kernel` (:63, through `_fused_call`) with f32 weights: f32 products
//      and sums, here as 3xTF32 (kind Tf32x3);
//   K2/K3 `_kernel_int8` act_mode 'dynamic' (:367, through `_fused_call_int8`)
//      and `_kernel_int8_resident` (:474): per-row dynamic a8w8, dyn8 (kind
//      S8<BN>). On the TPU the two differ in where the int8 stack lives;
//      here one forward serves both;
//   K4 `_kernel_int8` act_mode 'static' (:367, through `_fused_call_int8`):
//      a8w8 with a calibrated per-tensor scale per layer (kind S8<BN, true>).
//
// The layer kernel is that of wgmma_layer.cu (one persistent block of 384
// threads per SM over 128 x BN output tiles; one producer thread keeps TMA
// loads of 128-byte-swizzled A and B boxes in flight in a ring of stages
// guarded by mbarriers; two consumer warpgroups run wgmma on 64 rows each),
// with two differences. wgmma reads 32-bit and 8-bit operands K-major only
// (its transpose bits are for 16-bit types), so B is the transposed stack
// Wt (out, in), made once per call by transpose_kernel: a stage is 128
// bytes of k of A (128 rows) and of Wt (BN rows). And the epilogues:
//
// Tf32x3 (K1-f32). f32 accuracy on the tensor cores: every operand x is
// split into two tf32 parts, big = tf32(x) and small = tf32(x - big), and a
// layer sums a_big w_big + a_big w_small + a_small w_big (the dropped
// a_small w_small is below 2^-22 of a product). The big product and the two
// small ones go to separate accumulators, added once at the end, so the
// small terms are not lost to the big sum's roundings; and the big product
// is summed by the tensor cores one 32-k tile at a time, the tiles then
// added in registers rounding to nearest, since the tensor cores' own
// additions over all of K drift (measured on the H100: 9e-6 of a layer's
// output at H = 1024 without this, against a 1e-5 rule). Each layer's
// epilogue writes its output's parts for the next layer (and the f32 output
// where the residual or a head reads it):
//   v = (acc_big + acc_small) + b;  relu: o = relu(v);  store: o = v;
//   add_relu: o = y + relu(v), y f32 in place;  out = o, (big, small) = split(o).
// BN = 128 keeps the three sums (192 values) in a consumer thread's
// registers; a stage (A and B, two parts each, 32 k) is 64 KB, so the ring
// holds three.
//
// S8 (dyn8). A layer is two launches: quantize_rows_kernel takes the f32
// activation row's amax and writes the int8 row and its scale, then the s8
// layer (s8 x s8 -> s32, exact) runs its epilogue in the float order of
// `_int8_mm` 'dynamic' (fused_mlp.py:344-356):
//   v = f32(acc) * (s_row * oscale) + b;  relu / store / add_relu as above,
//   writing f32 (what the next quantization reads) and/or bf16 (the heads).
// |acc| <= H * 127 * 127 < 2^24 up to H = 1040, so f32(acc) is exact there,
// and one quantize + layer pair is bit for bit the plain layer.
// A row's max spans all H columns, more than one output tile, so the
// quantization is its own launch; fusing it into the previous layer's
// epilogue (a second pass over the row) is a later step.
//
// Static S8 (K4). The next layer's scale is a calibrated scalar, inv_in[i +
// 1], known before the layer runs, so no second pass is needed: the
// epilogue, in the float order of `_int8_mm` 'static' (fused_mlp.py:335-343),
//   v = f32(acc) * oscale + b;  relu / store / add_relu as above,
// writes the next layer's int8 input itself,
//   q_next = clip(rint(o * inv_next), +-127),  o the value it just made
// (for add_relu the f32 y after the add), with inv_next read on the card
// (no host sync per layer); and f32 (the residual y only) and/or bf16 (the
// heads) where they are read. No quantization launch, no f32 traffic but
// the residual: a call is 2S + 5 launches. A thread holds two neighbouring
// columns of a row, so the four lanes of a row trade their 2-byte pairs
// by shuffles and each stores 8 contiguous bytes (store_q_rows): measured
// on the H100, 2-byte stores from each lane made the layers 19% slower.
//
// What bounds them, at hidden 1024, 131072 rows, 3 stages: the eight layers
// are 2.2 TFLOP a call. 3xTF32 does it three times at 495 TFLOP/s (13.3 ms);
// s8 once at 1979 TOP/s (1.1 ms), and its activations then weigh more: each
// dyn8 layer reads 0.5 GB of f32 to quantize and writes 0.5 GB of f32 (3.35
// TB/s); a static layer reads 0.13 GB of int8 and writes 0.13 GB of int8,
// plus 1 GB of f32 for the residual of add_relu. Each weight byte is read
// from L2 once per 128 rows, not once per 16 as in the kernels these
// replace.
//
// Rows: TMA fills rows past m with zeros and the epilogue stores rows < m
// only. The tile shape and the k order never depend on m and nothing splits
// K, so a row's result is the same whatever the batch around it.

#include <cuda.h>
#include <cuda_bf16.h>

#include "hopper_common.cuh"
#include "mlp_common.cuh"

using namespace hopper;

namespace {

constexpr int kBM = 128;                  // rows of an output tile
constexpr int kLayerThreads = 384;        // two consumer warpgroups, one producer
constexpr int kConsumerThreads = 256;
constexpr int kATileBytes = kBM * 128;    // 128 rows x 128 bytes of k: 16 KB
constexpr int kRingBytes = 192 * 1024;    // shared memory of the stage ring
constexpr int kQuantVec = 16;             // rows up to 2048 wide stay in registers

// 3xTF32: A and B in two parts each; the big product and the cross products
// in two accumulators.
struct Tf32x3 {
  static constexpr int kBN = 128;
  static constexpr int kParts = 2;
  static constexpr int kElemBytes = 4;
  static constexpr bool kStatic = false;
  using Acc = float;
};

// s8 x s8 -> s32, one part, one accumulator. The scale mode is a template
// parameter, so that neither mode's epilogue moves when the other changes:
// kStatic = false is dyn8 (row scales), true is K4 (no row scale, the next
// layer's int8 input written by the epilogue).
template <int BN, bool Static = false>
struct S8 {
  static constexpr int kBN = BN;
  static constexpr int kParts = 1;
  static constexpr int kElemBytes = 1;
  static constexpr bool kStatic = Static;
  using Acc = int;
};

template <class K>
struct Layout {
  static constexpr int kBK = 128 / K::kElemBytes;     // k of a stage
  static constexpr int kBTileBytes = K::kBN * 128;
  static constexpr int kStageBytes = K::kParts * (kATileBytes + kBTileBytes);
  static constexpr int kStages = kRingBytes / kStageBytes;   // 3 (Tf32x3), 4 or 6 (S8)
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;
};

struct Maps {
  CUtensorMap a[2], b[2];   // part 0 (big, or the only one), part 1 (small)
};

struct Params {
  const float* bias;
  const float* oscale;      // S8: the weights' column scales
  const float* row_scale;   // dynamic S8: the activation rows' scales
  float* out;               // f32 result or null; add_relu: the residual y, in place
  __nv_bfloat16* out_bf;    // S8: bf16 result or null
  float* big;               // Tf32x3: the result's tf32 parts, or null
  float* small;
  int epilogue;
  const float* inv_next;    // static S8: the next layer's inv_in (one value, on the card)
  int8_t* q_next;           // static S8: the next layer's int8 input, or null
};

// One 32-byte k-step of a k-tile. Tf32x3: d[1] sums the cross products over
// the whole K; d[0] the big product over this k-tile only (it restarts at
// the k-tile's first step, `first`), and the consumer adds it to an f32 sum
// in registers after each k-tile.
template <class K>
__device__ __forceinline__ void mma_step(typename K::Acc (&d)[K::kParts][K::kBN / 2],
                                         const unsigned char* a0, const unsigned char* a1,
                                         const unsigned char* b0, const unsigned char* b1,
                                         bool first) {
  if constexpr (K::kParts == 2) {
    const uint64_t ab = sw128_desc(a0, 16, 1024), as = sw128_desc(a1, 16, 1024);
    const uint64_t bb = sw128_desc(b0, 16, 1024), bs = sw128_desc(b1, 16, 1024);
    wgmma_m64n128k8_tf32(d[1], ab, bs, 1);
    wgmma_m64n128k8_tf32(d[1], as, bb, 1);
    wgmma_m64n128k8_tf32(d[0], ab, bb, first ? 0 : 1);
  } else if constexpr (K::kBN == 256) {
    wgmma_m64n256k32_s8(d[0], sw128_desc(a0, 16, 1024), sw128_desc(b0, 16, 1024), 1);
  } else {
    wgmma_m64n128k32_s8(d[0], sw128_desc(a0, 16, 1024), sw128_desc(b0, 16, 1024), 1);
  }
}

// The static epilogue's q_next store for a chunk of 8 column groups. Lane
// (row r, t = lane % 4) holds qp[k][h], the 2 bytes of row r0 + 8 h at
// columns col0 + 8 k + 2 t. Three shuffles among the four lanes of a row
// hand each lane all 8 bytes of group k = t (and of k = 4 + t), which it
// stores as one word: a warp's store then covers 32 contiguous bytes of each
// of its 8 rows, whole 32-byte sectors, where each lane's own 2-byte stores
// write a quarter of a sector per store.
__device__ __forceinline__ void store_q_rows(int8_t* q, const uint32_t (&qp)[8][2], int lane,
                                             int r0, int col0, int m, int hidden) {
  const int t = lane % 4;
#pragma unroll
  for (int g = 0; g < 8; g += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned long long word = 0;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        // Round rr: each lane sends its pair of group (t + rr) % 4, and so
        // receives, from lane s = (t - rr) % 4, s's pair of group t: the
        // bytes 2 s and 2 s + 1 of the word.
        const int k = (t + rr) & 3;
        const uint32_t mine = k == 0   ? qp[g][h]
                              : k == 1 ? qp[g + 1][h]
                              : k == 2 ? qp[g + 2][h]
                                       : qp[g + 3][h];
        const int s = (t - rr) & 3;
        const uint32_t got = __shfl_sync(0xffffffffu, mine, (lane & ~3) | s);
        word |= static_cast<unsigned long long>(got) << (16 * s);
      }
      const int r = r0 + 8 * h;
      if (r < m)
        *reinterpret_cast<unsigned long long*>(q + static_cast<size_t>(r) * hidden + col0 +
                                               8 * (g + t)) = word;
    }
  }
}

// One H x H layer. The grid is persistent: block b takes the 128 x BN
// output tiles b, b + gridDim.x, ..., and its producer loads the next
// tile's first stages while the consumers run the epilogue of the last one.
template <class K>
__global__ void __launch_bounds__(kLayerThreads, 1)
layer_kernel(const __grid_constant__ Maps maps, const Params p, int m, int hidden) {
  using L = Layout<K>;
  constexpr int BN = K::kBN;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);   // stage loaded
  uint64_t* empty = full + kStages;                                      // stage free again
  auto a_tile = [&](int s, int part) { return base + s * L::kStageBytes + part * kATileBytes; };
  auto b_tile = [&](int s, int part) {
    return base + s * L::kStageBytes + K::kParts * kATileBytes + part * L::kBTileBytes;
  };

  const int n_tiles = hidden / BN;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  const int nk = hidden / L::kBK;

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
#pragma unroll
          for (int part = 0; part < K::kParts; ++part) {
            tma_load_2d(a_tile(s, part), &maps.a[part], &full[s], kt * L::kBK, m0);
            tma_load_2d(b_tile(s, part), &maps.b[part], &full[s], kt * L::kBK, n0);
          }
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
    typename K::Acc d[K::kParts][BN / 2];
    // Tf32x3: the big product's sum, k-tile by k-tile, rounded to nearest.
    // The tensor cores' own sum over a whole K of 8-k steps drifts by more
    // (its additions do not round to nearest), enough to miss the 1e-5 of a
    // layer at H = 1024.
    float big_sum[K::kParts == 2 ? BN / 2 : 1];
    int g = 0;   // k-tiles this block has consumed
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * BN;
#pragma unroll
      for (int part = 0; part < K::kParts; ++part)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[part][i] = 0;
#pragma unroll
      for (int i = 0; i < (K::kParts == 2 ? BN / 2 : 1); ++i) big_sum[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % kStages;
        mbar_wait(&full[s], (g / kStages) & 1);
        wgmma_wait<0>();                        // k-tile g - 1's products are done
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);
        if constexpr (K::kParts == 2) {
          if (kt > 0) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) big_sum[i] = __fadd_rn(big_sum[i], d[0][i]);
          }
        }
        wgmma_fence();
        const unsigned char* a0 = a_tile(s, 0) + wg * 64 * 128;
        const unsigned char* a1 = a_tile(s, K::kParts - 1) + wg * 64 * 128;
        const unsigned char* b0 = b_tile(s, 0);
        const unsigned char* b1 = b_tile(s, K::kParts - 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)          // four 32-byte k-steps
          mma_step<K>(d, a0 + 32 * ks, a1 + 32 * ks, b0 + 32 * ks, b1 + 32 * ks, ks == 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);
      if constexpr (K::kParts == 2) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) big_sum[i] = __fadd_rn(big_sum[i], d[0][i]);
      }

      // Thread (warp, lane) holds rows r0 and r0 + 8, columns c0 + 8 j (+ 1).
      // The epilogue goes kChunk column groups at a time, all their loads
      // first, so that the residual's loads are in flight together.
      const int r0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
      const bool add = p.epilogue == mlp::kAddRelu;
      float rs[2] = {0.f, 0.f};
      if constexpr (K::kParts == 1 && !K::kStatic) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r0 + 8 * h < m) rs[h] = p.row_scale[r0 + 8 * h];
      }
      float inv_next = 0.f;
      if constexpr (K::kStatic) {
        if (p.q_next != nullptr) inv_next = __ldg(p.inv_next);
      }
      constexpr int kChunk = 8;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
        float2 b[kChunk], sc[kChunk], old[kChunk][2];
        uint32_t qp[K::kStatic ? kChunk : 1][2] = {};   // static: q_next pairs, 2 bytes each
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = c0 + 8 * (j0 + j);
          b[j] = __ldg(reinterpret_cast<const float2*>(p.bias + col));
          sc[j] = K::kParts == 1 ? __ldg(reinterpret_cast<const float2*>(p.oscale + col))
                                 : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            old[j][h] = add && r0 + 8 * h < m
                            ? *reinterpret_cast<const float2*>(
                                  p.out + static_cast<size_t>(r0 + 8 * h) * hidden + col)
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = c0 + 8 * (j0 + j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r >= m) continue;
            const int i = 4 * (j0 + j) + 2 * h;
            float v0, v1;
            if constexpr (K::kParts == 2) {
              v0 = __fadd_rn(__fadd_rn(big_sum[i], d[1][i]), b[j].x);
              v1 = __fadd_rn(__fadd_rn(big_sum[i + 1], d[1][i + 1]), b[j].y);
            } else if constexpr (K::kStatic) {
              v0 = __fadd_rn(__fmul_rn(__int2float_rn(d[0][i]), sc[j].x), b[j].x);
              v1 = __fadd_rn(__fmul_rn(__int2float_rn(d[0][i + 1]), sc[j].y), b[j].y);
            } else {
              v0 = __fadd_rn(__fmul_rn(__int2float_rn(d[0][i]), __fmul_rn(rs[h], sc[j].x)),
                             b[j].x);
              v1 = __fadd_rn(__fmul_rn(__int2float_rn(d[0][i + 1]), __fmul_rn(rs[h], sc[j].y)),
                             b[j].y);
            }
            if (add) {
              v0 = __fadd_rn(old[j][h].x, fmaxf(v0, 0.f));
              v1 = __fadd_rn(old[j][h].y, fmaxf(v1, 0.f));
            } else if (p.epilogue == mlp::kRelu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const size_t off = static_cast<size_t>(r) * hidden + col;
            if (p.out != nullptr) *reinterpret_cast<float2*>(p.out + off) = make_float2(v0, v1);
            if constexpr (K::kParts == 2) {
              if (p.big != nullptr) mlp::store_tf32_split2(p.big + off, p.small + off, v0, v1);
            } else {
              if (p.out_bf != nullptr)
                *reinterpret_cast<__nv_bfloat162*>(p.out_bf + off) = __floats2bfloat162_rn(v0, v1);
              if constexpr (K::kStatic) {
                if (p.q_next != nullptr) qp[j][h] = mlp::pack_s8x2(v0, v1, inv_next);
              }
            }
          }
        }
        if constexpr (K::kStatic) {
          if (p.q_next != nullptr) store_q_rows(p.q_next, qp, lane, r0, n0 + 8 * j0, m, hidden);
        }
      }
    }
  }
}

// q[r] = clip(rint(act[r] * (127 / s)), +-127) and row_scale[r] = s * (1/127),
// s = max(max |act[r]|, 1e-8), with a true division and rint half to even:
// the float order of `_int8_mm` 'dynamic'. One warp per row, 16 bytes of
// the row a lane and step; hidden % 128 == 0. With kVec > 0 (hidden <=
// 128 kVec) a lane keeps its part of the row in registers, so the row is
// read from memory once and all its loads are in flight together; kVec = 0
// reads it twice.
__device__ __forceinline__ uint32_t quant_byte(float v, float inv, int shift) {
  return (static_cast<uint32_t>(mlp::quant_s8(v, inv)) & 0xFFu) << shift;
}

__device__ __forceinline__ float amax4(float amax, float4 v) {
  return fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

__device__ __forceinline__ uint32_t quant4(float4 v, float inv) {
  return quant_byte(v.x, inv, 0) | quant_byte(v.y, inv, 8) | quant_byte(v.z, inv, 16) |
         quant_byte(v.w, inv, 24);
}

template <int kVec>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ act, int8_t* __restrict__ q,
                     float* __restrict__ row_scale, int m, int hidden) {
  const int lane = threadIdx.x % 32;
  const int n4 = hidden / 4;
  for (int row = blockIdx.x * 8 + threadIdx.x / 32; row < m; row += gridDim.x * 8) {
    const float4* a = reinterpret_cast<const float4*>(act + static_cast<size_t>(row) * hidden);
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * hidden);
    float amax = 0.f;
    float4 v[kVec > 0 ? kVec : 1];
    if constexpr (kVec > 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (lane + 32 * i < n4) v[i] = __ldg(a + lane + 32 * i);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (lane + 32 * i < n4) amax = amax4(amax, v[i]);
    } else {
      for (int k = lane; k < n4; k += 32) amax = amax4(amax, __ldg(a + k));
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float safe = fmaxf(amax, 1e-8f);
    const float inv = __fdiv_rn(127.0f, safe);
    if constexpr (kVec > 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (lane + 32 * i < n4) qr[lane + 32 * i] = quant4(v[i], inv);
    } else {
      for (int k = lane; k < n4; k += 32) qr[k] = quant4(__ldg(a + k), inv);
    }
    if (lane == 0) row_scale[row] = __fmul_rn(safe, 1.0f / 127.0f);
  }
}

// dst[l][j][i] = src[l][i][j] for n hidden x hidden matrices, through a
// 32 x 32 tile in shared memory; with kSplit, dst and dst_small get the
// tf32 parts of the f32 values. blockDim (32, 8), grid (H / 32, H / 32, n).
template <typename T, bool kSplit>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ src, T* __restrict__ dst, T* __restrict__ dst_small,
                 int hidden) {
  __shared__ T tile[32][33];
  const size_t mat = static_cast<size_t>(blockIdx.z) * hidden * hidden;
  int x = blockIdx.x * 32 + threadIdx.x;
  int y = blockIdx.y * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    tile[threadIdx.y + j][threadIdx.x] = src[mat + static_cast<size_t>(y + j) * hidden + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const T v = tile[threadIdx.x][threadIdx.y + j];
    const size_t off = mat + static_cast<size_t>(y + j) * hidden + x;
    if constexpr (kSplit) {
      const float big = mlp::tf32_round(v);
      dst[off] = big;
      dst_small[off] = mlp::tf32_round(__fsub_rn(v, big));
    } else {
      dst[off] = v;
    }
  }
}

// big[i], small[i] = the tf32 parts of src[i]; n % 4 == 0, 16-byte aligned.
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ src, float* __restrict__ big, float* __restrict__ small,
             size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = __ldg(src + i);
    mlp::store_tf32_split2(big + 4 * i, small + 4 * i, v.x, v.y);
    mlp::store_tf32_split2(big + 4 * i + 2, small + 4 * i + 2, v.z, v.w);
  }
}

template <class K>
int launch_layer(const void* const a[2], const void* const wt[2], const Params& p, int m,
                 int hidden, cudaStream_t stream) {
  using L = Layout<K>;
  const CUtensorMapDataType type =
      K::kElemBytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  Maps maps = {};
  for (int part = 0; part < K::kParts; ++part) {
    int err = make_map(&maps.a[part], a[part], type, K::kElemBytes, hidden, m, kBM);
    if (err) return err;
    err = make_map(&maps.b[part], wt[part], type, K::kElemBytes, hidden, hidden, K::kBN);
    if (err) return err;
  }
  cudaError_t cerr = cudaFuncSetAttribute(layer_kernel<K>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          L::kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const int tiles = (m + kBM - 1) / kBM * (hidden / K::kBN);
  const int grid = tiles < sms ? tiles : sms;
  layer_kernel<K><<<grid, kLayerThreads, L::kSmemBytes, stream>>>(maps, p, m, hidden);
  return static_cast<int>(cudaGetLastError());
}

unsigned blocks_for(size_t work, size_t per_block) {
  const size_t want = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(want < 4096 ? want : 4096);
}

}  // namespace

extern "C" {

// One 3xTF32 layer on `stream`: v = a @ W + bias from the tf32 parts of a
// (m, H) and of W's transpose wt (H_out, H_in), then the epilogue; out
// (m, H) f32 gets the result unless null (add_relu: out is the residual y,
// read and updated in place), big and small its tf32 parts unless null.
// Returns 0 or a cudaError_t (>= 1000: a TMA descriptor failed to encode).
// The caller checks shapes, alignment and hidden % 128 == 0.
int tf32x3_layer_forward(const float* a_big, const float* a_small, const float* wt_big,
                         const float* wt_small, const float* bias, float* out, float* big,
                         float* small, int m, int hidden, int epilogue, void* stream) {
  if (m == 0) return 0;
  const void* a[2] = {a_big, a_small};
  const void* wt[2] = {wt_big, wt_small};
  const Params p = {bias, nullptr, nullptr, out, nullptr, big, small, epilogue, nullptr, nullptr};
  return launch_layer<Tf32x3>(a, wt, p, m, hidden, static_cast<cudaStream_t>(stream));
}

// One dyn8 layer on `stream`: v = f32(q @ Wq) * (row_scale * oscale) + bias
// from q (m, H) int8 and the transposed int8 weights wt (H_out, H_in), then
// the epilogue; out (m, H) f32 unless null (add_relu: the residual y, in
// place), out_bf (m, H) bf16 unless null. As tf32x3_layer_forward otherwise.
int s8_layer_forward(const int8_t* q, const float* row_scale, const int8_t* wt,
                     const float* oscale, const float* bias, float* out, void* out_bf, int m,
                     int hidden, int epilogue, void* stream) {
  if (m == 0) return 0;
  const void* a[2] = {q, q};
  const void* w[2] = {wt, wt};
  const Params p = {bias, oscale, row_scale, out, static_cast<__nv_bfloat16*>(out_bf),
                    nullptr, nullptr, epilogue, nullptr, nullptr};
  auto s = static_cast<cudaStream_t>(stream);
  return hidden % 256 == 0 ? launch_layer<S8<256>>(a, w, p, m, hidden, s)
                           : launch_layer<S8<128>>(a, w, p, m, hidden, s);
}

// One static a8w8 (K4) layer on `stream`: v = f32(q @ Wq) * oscale + bias
// from q (m, H) int8 and the transposed int8 weights wt (H_out, H_in), then
// the epilogue; out (m, H) f32 unless null (add_relu: the residual y, in
// place), out_bf (m, H) bf16 unless null, and q_next (m, H) int8 unless
// null, the result quantized with the scalar *inv_next (a device pointer).
// As tf32x3_layer_forward otherwise.
int s8_static_layer_forward(const int8_t* q, const int8_t* wt, const float* oscale,
                            const float* bias, const float* inv_next, float* out, void* out_bf,
                            int8_t* q_next, int m, int hidden, int epilogue, void* stream) {
  if (m == 0) return 0;
  const void* a[2] = {q, q};
  const void* w[2] = {wt, wt};
  const Params p = {bias, oscale, nullptr, out, static_cast<__nv_bfloat16*>(out_bf),
                    nullptr, nullptr, epilogue, inv_next, q_next};
  auto s = static_cast<cudaStream_t>(stream);
  return hidden % 256 == 0 ? launch_layer<S8<256, true>>(a, w, p, m, hidden, s)
                           : launch_layer<S8<128, true>>(a, w, p, m, hidden, s);
}

// q (m, H) int8 and row_scale (m,) f32 from act (m, H) f32, per row.
int quantize_rows_forward(const float* act, int8_t* q, float* row_scale, int m, int hidden,
                          void* stream) {
  if (m == 0) return 0;
  auto kernel = hidden <= 128 * kQuantVec ? quantize_rows_kernel<kQuantVec>
                                          : quantize_rows_kernel<0>;
  kernel<<<blocks_for(m, 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(act, q, row_scale, m,
                                                                         hidden);
  return static_cast<int>(cudaGetLastError());
}

// wt (n, H, H) int8 = the transpose of each of the n matrices of w.
int transpose_int8_forward(const int8_t* w, int8_t* wt, int n, int hidden, void* stream) {
  if (n == 0) return 0;
  const dim3 grid(hidden / 32, hidden / 32, n);
  transpose_kernel<int8_t, false><<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      w, wt, nullptr, hidden);
  return static_cast<int>(cudaGetLastError());
}

// big, small (n, H, H) f32 = the tf32 parts of the transpose of each of the
// n matrices of w.
int transpose_split_tf32_forward(const float* w, float* big, float* small, int n, int hidden,
                                 void* stream) {
  if (n == 0) return 0;
  const dim3 grid(hidden / 32, hidden / 32, n);
  transpose_kernel<float, true><<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      w, big, small, hidden);
  return static_cast<int>(cudaGetLastError());
}

// big, small (n) f32 = the tf32 parts of src (n); n % 4 == 0.
int split_tf32_forward(const float* src, float* big, float* small, size_t n, void* stream) {
  if (n == 0) return 0;
  split_kernel<<<blocks_for(n / 4, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), big, small, n / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
