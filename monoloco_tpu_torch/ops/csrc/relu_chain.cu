// K6, the roofline probe's relu chain, as one layer kernel for NVIDIA Hopper
// (sm_90a): out = bf16(relu(a @ w)), a (m, H) and w (H, H) bf16, f32 sums,
// no bias; the chain is one launch per layer.
//
// Replaces the Pallas TPU kernel `kernel` of tools/bench_roofline.py:100
// (reaching pl.pallas_call in `run_tile`, :110, inside bench_chain_resident):
// eight dependent layers y <- bf16(relu(y @ W_i)) on a 512-row tile whose
// activations and weights stay in VMEM.
//
// What bounds it. At 131072 x 1024 x 8 the chain is 2.2 TFLOP, 2.22 ms at
// the bf16 peak (989 TFLOP/s), against 0.55 GB of device memory (x and the
// output once each, the 16 MB of weights; 0.17 ms at 3.35 TB/s): bound by
// its products. A block's 227 KB cannot hold a tile's activations across
// layers (128 rows x 1024 bf16 is 256 KB), so each layer's output crosses
// device memory (256 MB a layer) and each layer re-reads its operands per
// 128 x BN output tile from L2: at H = 1024 and BN = 256, 1 GB of A and 2 GB
// of B a layer when every tile loads its own B.
//
// The design, a step each against the layer kernel of wgmma_layer.cu (which
// ran K6 before, with a zero bias):
//  1. One wgmma group in flight: a k-step issues its four wgmma, commits,
//     then waits until only that group is outstanding and releases the
//     previous step's stage. The tensor pipe never drains inside a tile
//     (wgmma_layer.cu waits for all products before each k-step).
//  2. A 2-block cluster sharing B: the two blocks of a cluster take
//     adjacent 128-row blocks on the same BN-column tile, and each block's
//     producer loads half of each stage's B boxes with a multicast TMA into
//     both blocks, so B is read from L2 once per 256 rows: 1 GB a layer
//     instead of 2. A stage is refilled only when the consumer warps of
//     both blocks have released it: each arrives on its own block's and on
//     the peer's `empty` barrier. Clusters take (row pair, column tile)
//     units in row-pair-major order, so the H / BN column tiles of a row
//     pair run at about the same time and A comes from device memory once.
//     The persistent grid is sized by cudaOccupancyMaxActiveClusters (the
//     GPCs may not hold 66 pairs).
//  3. The epilogue does not hold up the next tile: the consumer warpgroups
//     pack relu(acc) to bf16 into a swizzled shared-memory staging buffer
//     with stmatrix and one thread of each warpgroup issues TMA stores of
//     its 64 rows, which the consumers do not wait for before the next
//     tile's products; the producer has that tile's first stages loaded
//     meanwhile. The map's bounds clip rows >= m. Ping-pong warpgroups (each
//     on its own 64-row tile) were not taken: they halve the rows each B
//     tile serves, undoing step 2's saving.
//
// Measured on the H100 (PERF.md): 0.36 ms a layer at 131072 x 1024 against
// 0.53 for wgmma_layer.cu's relu layer. Step 3 made the gain: the stores
// from registers, 4 bytes a thread, held the old kernel back. What steps 1
// and 2 add on top of it is unresolved at this size: without the cluster the
// same kernel ran within one call's spread of this one. Each peer arrival
// must keep the default (CTA-scope) release: a cluster-scope one cost a third
// of the speed.
//
// Kept from wgmma_layer.cu: one persistent launch a layer; one TMA
// producer thread and two consumer warpgroups running wgmma m64nBNk16 bf16
// -> f32 on 64 rows each; A K-major with the 128-byte swizzle, B MN-major
// through the transpose bit; no split of K, and a k order that does not
// depend on m, so a row's result never depends on the batch around it, and
// the same wgmma shape and k order as that kernel's relu layer, so the two
// agree bit for bit.
//
// Rows: TMA loads rows past m as zeros. With an odd number of 128-row
// blocks, the second block of the last row pair has no rows: it still loads
// its half of B and releases every stage, and its stores fall outside the
// map. A block leaves only after a cluster barrier, when its peer no longer
// writes into its shared memory or arrives on its barriers.

#include <cuda.h>
#include <cuda_bf16.h>

#include "hopper_common.cuh"

using namespace hopper;

namespace {

constexpr int kBM = 128;                 // rows of a block's output tile
constexpr int kBK = 64;                  // k of a stage: 128 bytes of bf16
constexpr int kThreads = 384;            // two consumer warpgroups, one producer
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBoxBytes = 64 * 64 * 2;   // a 64 x 64 bf16 box: B's (k, n) and the output's

// Four stages; at BN = 256 four 48 KB stages leave room for half the output
// tile (64 rows x 128 columns a warpgroup), stored in two passes; at BN =
// 128 the whole tile fits. Three stages with the whole tile staged in one
// pass read 3.5% slower in one call, about that call's spread (PERF.md).
template <int BN>
struct Layout {
  static constexpr int kStages = 4;
  static constexpr int kOutCols = 128;    // columns a warpgroup stages a pass
  static constexpr int kStageBytes = kABytes + kBK * BN * 2;
  static constexpr int kOutOffset = kStages * kStageBytes;
  static constexpr int kOutWgBytes = 64 * kOutCols * 2;   // one warpgroup's staging
  static constexpr int kBarOffset = kOutOffset + 2 * kOutWgBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "a block has 232448 bytes of shared memory");
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

__device__ __forceinline__ uint32_t relu_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A layer's units: (row pair, column tile), one for a 2-block cluster.
template <int BN>
__host__ __device__ __forceinline__ int units_of(int m, int hidden) {
  return ((m + kBM - 1) / kBM + 1) / 2 * (hidden / BN);
}

// One layer. Cluster c (blocks 2c and 2c + 1, ranks 0 and 1) takes the
// units c, c + clusters, ...; unit u is row pair u / n_tiles and column
// tile u % n_tiles, and rank r its row block 2 (u / n_tiles) + r.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
relu_layer_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap out_map, int m, int hidden) {
  using L = Layout<BN>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);   // stage loaded
  uint64_t* empty = full + S;                                            // stage free again
  auto a_tile = [&](int s) { return base + s * L::kStageBytes; };
  auto b_tile = [&](int s) { return base + s * L::kStageBytes + kABytes; };

  const int rank = static_cast<int>(cluster_ctarank());
  const int cluster = blockIdx.x >> 1;
  const int clusters = gridDim.x >> 1;
  const int n_tiles = hidden / BN;
  const int units = units_of<BN>(m, hidden);
  const int nk = hidden / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      // One arrival per consumer warp of both blocks: each stage's B is
      // half the peer's.
      mbar_init(&empty[s], 2 * kConsumerWarps);
    }
    mbar_fence_init();
  }
  // The peer's barriers are initialised before anything reaches them.
  cluster_sync();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumerThreads) {
      int g = 0;   // k-steps this block has loaded
      for (int u = cluster; u < units; u += clusters) {
        const int m0 = (2 * (u / n_tiles) + rank) * kBM;
        const int n0 = (u % n_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % S;
          // Both blocks' consumers have released the stage: its A is this
          // block's, and the peer's producer multicasts into its B too.
          if (g >= S) mbar_wait(&empty[s], ((g / S) + 1) & 1);
          mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          tma_load_2d(a_tile(s), &a_map, &full[s], kt * kBK, m0);
          constexpr int kHalf = BN / 128;   // B boxes this block loads for both
#pragma unroll
          for (int j = 0; j < kHalf; ++j) {
            const int box = rank * kHalf + j;
            tma_load_2d_multicast(b_tile(s) + box * kBoxBytes, &b_map, &full[s], n0 + 64 * box,
                                  kt * kBK, 0x3);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // Consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of the tile.
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;   // issues the warpgroup's stores
    const uint32_t peer = static_cast<uint32_t>(rank ^ 1);
    unsigned char* staging = base + L::kOutOffset + wg * L::kOutWgBytes;
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive_cluster(&empty[s], peer);
      }
    };
    // Lane l of warp w gives stmatrix the row address of 8 x 8 piece l / 8:
    // row 16 (w % 4) + 8 (l / 8 % 2) + l % 8 of the warpgroup's 64, column
    // group l / 16 of the pair a store takes.
    const int r = 16 * (warp % 4) + 8 * ((lane >> 3) & 1) + (lane & 7);
    const int half = lane >> 4;
    float d[BN / 2];
    int g = 0;   // k-steps this block has consumed
    for (int u = cluster; u < units; u += clusters) {
      const int m0 = (2 * (u / n_tiles) + rank) * kBM;
      const int n0 = (u % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % S;
        mbar_wait(&full[s], (g / S) & 1);
        wgmma_fence();
        const unsigned char* at = a_tile(s) + wg * 64 * 128;
        const unsigned char* bt = b_tile(s);
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          Acc<BN>::mma(d, sw128_desc(at + 32 * ks, 16, 1024),
                       sw128_desc(bt + 2048 * ks, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<1>();                  // k-step g - 1's products are done
        if (kt > 0) release((g - 1) % S);
      }
      wgmma_wait<0>();
      release((g - 1) % S);

      // relu(acc) as bf16 through the staging buffer: 64-column boxes of
      // 128-byte rows with the 128-byte swizzle (chunk c of row r at c ^ (r
      // % 8)), the layout the output map's TMA store reads.
      const int rows0 = m0 + 64 * wg;    // this warpgroup's first row
#pragma unroll
      for (int pass = 0; pass < BN / L::kOutCols; ++pass) {
        if (leader) bulk_wait_read<0>();   // the last store has read the buffer
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < L::kOutCols / 8; jj += 2) {
          const int j = pass * (L::kOutCols / 8) + jj;
          const int col = 8 * (jj + half);
          const int chunk = (col % 64) / 8;
          stmatrix_x4(staging + (col / 64) * kBoxBytes + r * 128 + ((chunk ^ (r & 7)) << 4),
                      relu_bf16x2(d[4 * j], d[4 * j + 1]),
                      relu_bf16x2(d[4 * j + 2], d[4 * j + 3]),
                      relu_bf16x2(d[4 * j + 4], d[4 * j + 5]),
                      relu_bf16x2(d[4 * j + 6], d[4 * j + 7]));
        }
        fence_proxy_async_shared();
        named_bar_sync(1 + wg, 128);
        if (leader && rows0 < m) {
#pragma unroll
          for (int b = 0; b < L::kOutCols / 64; ++b)
            tma_store_2d(&out_map, staging + b * kBoxBytes, n0 + pass * L::kOutCols + 64 * b,
                         rows0);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait<0>();
  }
  cluster_sync();
}

template <int BN>
cudaLaunchConfig_t launch_config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<BN>::kSmemBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

constexpr int kMaxDevices = 64;

template <int BN>
int launch(const void* a, const void* w, void* out, int m, int hidden, cudaStream_t stream) {
  CUtensorMap a_map, b_map, out_map;
  int err = make_map(&a_map, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, m, kBM);
  if (!err) err = make_map(&b_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, hidden, kBK);
  if (!err) err = make_map(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, m, 64);
  if (err) return err;
  const void* kernel = reinterpret_cast<const void*>(relu_layer_kernel<BN>);
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          Layout<BN>::kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // The persistent grid: as many clusters as fit on the card at once
  // (queried once a device), or fewer when the layer has fewer units.
  static int fitting[kMaxDevices] = {};
  int device = 0;
  cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaLaunchAttribute attr[1];
  if (fitting[device] == 0) {
    int n = 0;
    cudaLaunchConfig_t probe = launch_config<BN>(1, nullptr, attr);
    cerr = cudaOccupancyMaxActiveClusters(&n, kernel, &probe);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fitting[device] = n;
  }
  const int units = units_of<BN>(m, hidden);
  cudaLaunchConfig_t cfg =
      launch_config<BN>(units < fitting[device] ? units : fitting[device], stream, attr);
  void* args[] = {&a_map, &b_map, &out_map, &m, &hidden};
  cerr = cudaLaunchKernelExC(&cfg, kernel, args);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One relu chain layer on `stream`: out (m, H) bf16 = bf16(relu(a (m, H)
// bf16 @ w (H, H) bf16)). Returns 0 or a cudaError_t (>= 1000: a TMA
// descriptor failed to encode; cudaErrorInvalidConfiguration: no 2-block
// cluster fits on the card). The caller checks shapes, alignment, m > 0 and
// H % 128 == 0.
int relu_chain_layer_forward(const void* a, const void* w, void* out, int m, int hidden,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return hidden % 256 == 0 ? launch<256>(a, w, out, m, hidden, s)
                           : launch<128>(a, w, out, m, hidden, s);
}

}  // extern "C"
