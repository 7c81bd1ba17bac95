// queue_matmul: y = x @ w through two shared-memory operand rings.
//
// Replaces the Pallas kernel src/repro/kernels/queue_matmul/kernel.py
// (queue_matmul_kernel, body _kernel): COPIFTv2's hardware FIFO queues as a
// GEMM, with one ring of `depth_x` stages for activation tiles and one of
// `depth_w` stages for weight tiles.  Depth 1 is COPIFT (copy, wait,
// compute); depth >= 2 keeps the next tiles in flight (COPIFTv2).  Each
// depth is a real stage count, and every depth gives the same bits.
//
// What bounds it on an H100 depends on M, so the wrapper picks one of two
// bf16 kernels by M (ops.py); both keep the same contract.
//
// bf16, M > 16 ("wide", the forward products, M = tokens): bound by
// operations (989 TFLOP/s).  The paper's mapping onto Hopper:
//  * one producer warp (the paper's integer thread) issues TMA copies: a
//    128-row box of x into the x ring and four 64-column boxes of w into
//    the w ring (w is (K, N) row-major, so its boxes are MN-major with the
//    128-byte swizzle).  Each stage has a full mbarrier, armed with the
//    stage's bytes, and an empty one, one arrival per consumer warp;
//  * two consumer warpgroups (the FP thread), 64 rows each, pop a stage
//    from each ring, run wgmma m64n64k16 bf16 -> fp32 with both operands
//    read from shared memory through descriptors, wait for them and
//    release the stages.  A block computes a 128 x 256 tile of y;
//  * a stage is 64 deep (x 16 KB, w 32 KB) when both rings fit at that
//    depth, else 32 deep (8 and 16 KB, x with the 64-byte swizzle), so
//    every pair up to (8, 8) fits.  Every k16 step is the same either way;
//  * where the column tiles alone would leave SMs idle (narrow N), K is
//    split into parts of whole 64-deep units, a function of (K, N) alone
//    (ops.split_k); the parts of a tile form one cluster, store fp32
//    partials to a workspace the wrapper allocates, and after the
//    cluster's barrier each rank sums a share of the rows in rank order;
//  * the tensor maps are encoded per call on the host (hopper.cuh).
//
// bf16, M <= 16 ("thin", decode over the slots): bound by the bytes of w
// (3.35 TB/s), so w has to stream from every SM at once:
//  * 64-column tiles, 128 deep, copied with 16-byte cp.async by all 128
//    threads (no tensor map, so nothing is encoded per call), one mbarrier
//    a stage, each thread's cp.async.mbarrier.arrive completing the phase;
//  * K is split into `split` parts, one block each, `split` a function of
//    (K, N) alone (ops.split_k).  The parts of a column tile form one
//    thread-block cluster: each block sums its four warps' partials in warp
//    order, then the cluster sums its blocks' partials through distributed
//    shared memory in rank order;
//  * each warp multiplies its own k16 slices of every stage (mma.sync
//    m16n8k16; w through ldmatrix.trans from XOR-swizzled rows).
// No atomics in either kernel, so a result never depends on timing.
//
// fp32, any M: plain FMAs (no TF32, whose error misses the 2e-4 tolerance),
// each 32-deep K tile summed apart and added to the running sum, in a 16- or
// 64-row block (tile_ring.cuh).  Unchanged since it was written.
//
// Bits: within a kernel every output element gets the same sequence of
// operations whatever the depths, M or its row, so depths are bit-identical
// and a row does not depend on its neighbours.  The two bf16 kernels sum in
// other orders (wgmma in one chain over each part; mma.sync in k16 slices
// per warp and part), so a row's bf16 bits depend on the regime, i.e. on
// whether M <= 16.  Chunked and token prefill both run decode bodies at M =
// slots, so they stay bit-exact.
//
// C interface: queue_matmul_launch(...) returns a cudaError_t.  Operands are
// row-major and contiguous: x (M, K), w (K, N), out (M, N), with K and N
// multiples of 16 bytes' worth of elements (the wrapper pads).

#include <cooperative_groups.h>

#include "../../_csrc/hopper.cuh"
#include "../../_csrc/tile_ring.cuh"

namespace {

using namespace tile_ring;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// Let `Kernel` use `bytes` of dynamic shared memory on the current device.
// cudaFuncSetAttribute costs host time on every call, and the host sets the
// pace of a decode body, so it is called only when a launch needs more than
// the kernel was last allowed on that device.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// fp32: the cp.async ring of tile_ring.cuh
// ---------------------------------------------------------------------------

template <typename T, int BM>
size_t smem_bytes(int depth_x, int depth_w) {
  return tiles_offset(depth_x + depth_w) +
         sizeof(T) * (static_cast<size_t>(depth_x) * BM * kBK +
                      static_cast<size_t>(depth_w) * kBK * kBN);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    queue_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int M, int N, int K, int depth_x,
                        int depth_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = bar_x + depth_x;
  T* xs = reinterpret_cast<T*>(smem + tiles_offset(depth_x + depth_w));
  T* ws = xs + static_cast<size_t>(depth_x) * BM * kBK;
  constexpr int kXTile = BM * kBK, kWTile = kBK * kBN;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth_x; ++s) mbar_init(bar_x + s, kThreads);
    for (int s = 0; s < depth_w; ++s) mbar_init(bar_w + s, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  // prologue: fill each ring to its own depth
  for (int t = 0; t < depth_x && t < nk; ++t) {
    load_tile<T, BM, kBK>(xs + t * kXTile, x, M, K, m0, t * kBK);
    cp_async_arrive(bar_x + t);
  }
  for (int t = 0; t < depth_w && t < nk; ++t) {
    load_tile<T, kBK, kBN>(ws + t * kWTile, w, K, N, t * kBK, n0);
    cp_async_arrive(bar_w + t);
  }

  typename TileFor<T, BM>::type tile;
  tile.zero();
  for (int t = 0; t < nk; ++t) {
    const int sx = t % depth_x, sw = t % depth_w;
    // queue pop: wait until this slot's copies have landed
    mbar_wait(bar_x + sx, (t / depth_x) & 1);
    mbar_wait(bar_w + sw, (t / depth_w) & 1);
    tile.mma(xs + sx * kXTile, ws + sw * kWTile);
    __syncthreads();  // every thread is done with both slots
    if (t + depth_x < nk) {
      load_tile<T, BM, kBK>(xs + sx * kXTile, x, M, K, m0, (t + depth_x) * kBK);
      cp_async_arrive(bar_x + sx);
    }
    if (t + depth_w < nk) {
      load_tile<T, kBK, kBN>(ws + sw * kWTile, w, K, N, (t + depth_w) * kBK, n0);
      cp_async_arrive(bar_w + sw);
    }
  }
  tile.store(out, M, N, m0, n0);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int depth_x, int depth_w, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BM>(depth_x, depth_w);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = queue_matmul_kernel<T, BM>;
  cudaError_t err = allow_smem<queue_matmul_kernel<T, BM>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, K, depth_x, depth_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, M > 16: producer warp with TMA, two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

namespace wide {

constexpr int kBM = 128, kBN = 256;
constexpr int kHalves = kBN / 64;             // 64-column boxes of w
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kUnit = 64;                     // K parts are multiples of it

// A stage is BK deep: 64 when both rings fit at that depth, else 32.  Every
// k16 step is the same either way, so the choice never changes a bit.
template <int BK>
struct Stage {
  static constexpr int kX = kBM * BK * 2;       // x: 8 or 16 KB
  static constexpr int kWBox = BK * 64 * 2;     // one 64-column box of w
  static constexpr int kW = kHalves * kWBox;    // w: 16 or 32 KB
  static constexpr int kXRow = BK * 2;          // x row, bytes: 64 or 128
  static constexpr int kXSwz = BK == 32 ? 2 : 1;  // descriptor swizzle
  static size_t smem(int depth_x, int depth_w) {
    return 1024 + static_cast<size_t>(depth_x) * kX +
           static_cast<size_t>(depth_w) * kW +
           16 * static_cast<size_t>(depth_x + depth_w);
  }
};

size_t smem_bytes(int depth_x, int depth_w) {
  const size_t deep = Stage<64>::smem(depth_x, depth_w);
  return deep <= static_cast<size_t>(kMaxSmem)
             ? deep
             : Stage<32>::smem(depth_x, depth_w);
}

template <int BK>
__global__ void __launch_bounds__(kThreads, 1)
    queue_matmul_wide(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      bf16* __restrict__ out, float* __restrict__ ws_part,
                      int M, int N, int K, int depth_x, int depth_w,
                      int split) {
  using S = Stage<BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stages on a 1024-byte boundary (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;
  unsigned char* ws = xs + static_cast<size_t>(depth_x) * S::kX;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(
      ws + static_cast<size_t>(depth_w) * S::kW);
  uint64_t* empty_x = full_x + depth_x;
  uint64_t* full_w = empty_x + depth_x;
  uint64_t* empty_w = full_w + depth_w;

  // blocks of one cluster hold the `split` K parts of one output tile; a
  // part is a run of 64-deep units, whatever the stage depth
  const int rank = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * kBM, n0 = blockIdx.y * kBN;
  const int units = (K + kUnit - 1) / kUnit;
  const int per = (units + split - 1) / split;
  const int u0 = min(units, rank * per), u1 = min(units, u0 + per);
  const int k_begin = u0 * kUnit;
  const int nk = (u1 - u0) * (kUnit / BK);  // this part's stages
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth_x; ++s) {
      mbar_init(full_x + s, 1);
      mbar_init(empty_x + s, kConsumers / 32);
    }
    for (int s = 0; s < depth_w; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[kHalves][32];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps both rings full
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int sx = t % depth_x, sw = t % depth_w;
        const int k0 = k_begin + t * BK;
        if (t >= depth_x)
          hopper::mbar_wait_or_trap(empty_x + sx, (t / depth_x - 1) & 1);
        hopper::mbar_expect_tx(full_x + sx, S::kX);
        hopper::tma_load_2d(xs + sx * S::kX, &tmx, full_x + sx, k0, m0);
        if (t >= depth_w)
          hopper::mbar_wait_or_trap(empty_w + sw, (t / depth_w - 1) & 1);
        hopper::mbar_expect_tx(full_w + sw, S::kW);
        unsigned char* wst = ws + sw * S::kW;
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          hopper::tma_load_2d(wst + h * S::kWBox, &tmw, full_w + sw,
                              n0 + 64 * h, k0);
      }
    }
  } else {
    // consumers: warpgroup g owns rows m0 + 64 g .. + 63, all 256 columns;
    // they pop a stage from each ring, run its products, wait for them
    // and release both stages.  No branch sits between the products (a
    // branch there makes the compiler serialise them).
    const int g = threadIdx.x / 128;
    for (int t = 0; t < nk; ++t) {
      const int sx = t % depth_x, sw = t % depth_w;
      hopper::mbar_wait_or_trap(full_x + sx, (t / depth_x) & 1);
      hopper::mbar_wait_or_trap(full_w + sw, (t / depth_w) & 1);
      const unsigned char* xa = xs + sx * S::kX + g * (S::kX / 2);
      const unsigned char* wb = ws + sw * S::kW;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // x: kXRow-byte rows, 8-row groups 8 kXRow apart, k16 = 32 bytes
        // on; w: 128-byte rows of 64 columns, 8-row groups 1024 bytes
        // apart, k16 = 16 rows on.  The unused offset is set to the used
        // one.
        const uint64_t da = hopper::gmma_desc(xa + 32 * kk, 8 * S::kXRow,
                                              8 * S::kXRow, S::kXSwz);
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const uint64_t db = hopper::gmma_desc(
              wb + h * S::kWBox + 2048 * kk, 1024, 1024, 1);
          hopper::wgmma_m64n64k16(acc[h], da, db);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (threadIdx.x % 32 == 0) {
        hopper::mbar_arrive(empty_x + sx);
        hopper::mbar_arrive(empty_w + sw);
      }
    }
  }

  // epilogue: one part stores bf16; several store fp32 partials to the
  // workspace and, after the cluster's barrier, each rank sums a share of
  // the tile's rows over the parts in rank order
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + 64 * (threadIdx.x / 128) + 16 * warp + lane / 4;
  const size_t plane = static_cast<size_t>(M) * N;
  if (threadIdx.x < kConsumers) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + 64 * h + 8 * j + 2 * (lane % 4);
        if (c >= N) continue;  // N is even: c + 1 < N too
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * e;
          if (r >= M) continue;
          const float lo = acc[h][4 * j + 2 * e];
          const float hi = acc[h][4 * j + 2 * e + 1];
          const size_t at = static_cast<size_t>(r) * N + c;
          if (split == 1)
            *reinterpret_cast<__nv_bfloat162*>(out + at) =
                __floats2bfloat162_rn(lo, hi);
          else
            *reinterpret_cast<float2*>(ws_part + rank * plane + at) =
                make_float2(lo, hi);
        }
      }
  }
  if (split == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's partial is in the workspace
  const int rows = (kBM + split - 1) / split;
  const int cols = min(kBN, N - n0) / 2;  // column pairs in the tile
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = m0 + rank * rows + i / cols, c = n0 + 2 * (i % cols);
    if (r >= M || r >= m0 + kBM) continue;
    const size_t at = static_cast<size_t>(r) * N + c;
    float2 v = *reinterpret_cast<const float2*>(ws_part + at);
    for (int q = 1; q < split; ++q) {
      const float2 u =
          *reinterpret_cast<const float2*>(ws_part + q * plane + at);
      v.x += u.x;
      v.y += u.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + at) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

template <int BK>
cudaError_t launch_bk(const void* x, const void* w, void* out, void* work,
                      int M, int N, int K, int depth_x, int depth_w,
                      int split, cudaStream_t stream) {
  using S = Stage<BK>;
  const size_t smem = S::smem(depth_x, depth_w);
  CUtensorMap tmx, tmw;
  cudaError_t err = hopper::encode_tiled(
      &tmx, x, M, K, kBM, BK,
      BK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_tiled(&tmw, w, K, N, BK, 64,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = queue_matmul_wide<BK>;
  err = allow_smem<queue_matmul_wide<BK>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kBM - 1) / kBM * split, (N + kBN - 1) / kBN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, static_cast<bf16*>(out),
                           static_cast<float*>(work), M, N, K, depth_x,
                           depth_w, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w, void* out, void* work,
                   int M, int N, int K, int depth_x, int depth_w, int split,
                   cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit || (split > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (Stage<64>::smem(depth_x, depth_w) <= static_cast<size_t>(kMaxSmem))
    return launch_bk<64>(x, w, out, work, M, N, K, depth_x, depth_w, split,
                         stream);
  if (Stage<32>::smem(depth_x, depth_w) <= static_cast<size_t>(kMaxSmem))
    return launch_bk<32>(x, w, out, work, M, N, K, depth_x, depth_w, split,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace wide

// ---------------------------------------------------------------------------
// bf16, M <= 16: split-K over a cluster, cp.async rings, mma.sync
// ---------------------------------------------------------------------------

namespace thin {

constexpr int kBM = 16, kBN = 64, kBK = 128;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kXTile = kBM * kBK, kWTile = kBK * kBN;  // elements

// The fp32 partials (each warp's, then the block's) reuse the rings once
// the last stage is consumed; the rings at depth (1, 1) are as large.
constexpr size_t kPartBytes = 4 * static_cast<size_t>(kWarps + 1) * kBM * kBN;

size_t smem_bytes(int depth_x, int depth_w) {
  const size_t rings = 2 * (static_cast<size_t>(depth_x) * kXTile +
                            static_cast<size_t>(depth_w) * kWTile);
  return tiles_offset(depth_x + depth_w) +
         (rings > kPartBytes ? rings : kPartBytes);
}

// x tile: 16 rows of 16 chunks (16 bytes each), w tile: 128 rows of 8; in
// both, chunk c of row r sits at c ^ (r & 7), so the 8 rows an ldmatrix
// reads fall on 8 different bank groups.
__device__ __forceinline__ int x_at(int r, int c) {
  return r * (kBK / 8) + (c ^ (r & 7));
}
__device__ __forceinline__ int w_at(int r, int c) {
  return r * (kBN / 8) + (c ^ (r & 7));
}

// Rows past M and the K or N edge arrive as zeros.
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ x,
                                       int M, int K, int k0) {
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = i % (kBK / 8);
    const int gc = k0 + 8 * c;
    const bool in = r < M && gc < K;
    cp_async16(xs + 8 * x_at(r, c), in ? x + static_cast<size_t>(r) * K + gc : x,
               in ? 2 * min(8, K - gc) : 0);
  }
}

__device__ __forceinline__ void load_w(bf16* ws, const bf16* __restrict__ w,
                                       int N, int K, int k0, int n0) {
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = i % (kBN / 8);
    const int gr = k0 + r, gc = n0 + 8 * c;
    const bool in = gr < K && gc < N;
    cp_async16(ws + 8 * w_at(r, c),
               in ? w + static_cast<size_t>(gr) * N + gc : w,
               in ? 2 * min(8, N - gc) : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    queue_matmul_thin(const bf16* __restrict__ x, const bf16* __restrict__ w,
           bf16* __restrict__ out, int M, int N, int K, int depth_x,
           int depth_w, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = bar_x + depth_x;
  bf16* xs = reinterpret_cast<bf16*>(smem + tiles_offset(depth_x + depth_w));
  bf16* ws = xs + static_cast<size_t>(depth_x) * kXTile;
  // after the last stage: [kWarps][16][kBN], then the block's [16][kBN]
  float* warp_part = reinterpret_cast<float*>(xs);
  float* part = warp_part + kWarps * kBM * kBN;

  const int n0 = blockIdx.y * kBN;
  const int nk_all = (K + kBK - 1) / kBK;
  const int per = (nk_all + split - 1) / split;
  const int t0 = blockIdx.x * per;
  const int nk = max(0, min(nk_all, t0 + per) - t0);  // this part's k tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth_x; ++s) mbar_init(bar_x + s, kThreads);
    for (int s = 0; s < depth_w; ++s) mbar_init(bar_w + s, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  for (int t = 0; t < depth_x && t < nk; ++t) {
    load_x(xs + t * kXTile, x, M, K, (t0 + t) * kBK);
    cp_async_arrive(bar_x + t);
  }
  for (int t = 0; t < depth_w && t < nk; ++t) {
    load_w(ws + t * kWTile, w, N, K, (t0 + t) * kBK, n0);
    cp_async_arrive(bar_w + t);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int sx = t % depth_x, sw = t % depth_w;
    hopper::mbar_wait_or_trap(bar_x + sx, (t / depth_x) & 1);
    hopper::mbar_wait_or_trap(bar_w + sw, (t / depth_w) & 1);
    const bf16* xt = xs + sx * kXTile;
    const bf16* wt = ws + sw * kWTile;
    // warp w takes the k16 slices w and w + 4 of the 128-deep stage
#pragma unroll
    for (int q = 0; q < kBK / 16 / kWarps; ++q) {
      const int ks = warp + kWarps * q;
      uint32_t a[4];
      {
        const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = 2 * ks + (lane >> 4);
        hopper::ldmatrix_x4(a, xt + 8 * x_at(r, c));
      }
#pragma unroll
      for (int jj = 0; jj < kBN / 16; ++jj) {
        uint32_t b[4];
        const int r = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = 2 * jj + (lane >> 4);
        hopper::ldmatrix_x4_trans(b, wt + 8 * w_at(r, c));
        hopper::mma_16816(acc[2 * jj], a, b[0], b[1]);
        hopper::mma_16816(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with both stages
    if (t + depth_x < nk) {
      load_x(xs + sx * kXTile, x, M, K, (t0 + t + depth_x) * kBK);
      cp_async_arrive(bar_x + sx);
    }
    if (t + depth_w < nk) {
      load_w(ws + sw * kWTile, w, N, K, (t0 + t + depth_w) * kBK, n0);
      cp_async_arrive(bar_w + sw);
    }
  }

  // the block's partial: its warps' sums added in warp order, in the
  // rings' memory (every copy has landed and every stage is consumed)
  __syncthreads();
  {
    float* mine = warp_part + warp * kBM * kBN;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(g + 8 * (e >> 1)) * kBN + 8 * j + 2 * tq + (e & 1)] = acc[j][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    float v = warp_part[i];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) v += warp_part[q * kBM * kBN + i];
    part[i] = v;
  }

  if (split == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, c = n0 + i % kBN;
      if (r < M && c < N)
        out[static_cast<size_t>(r) * N + c] = __float2bfloat16(part[i]);
    }
    return;
  }
  // the cluster's sum: the parts added in rank order, each rank storing a
  // share of the tile
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = blockIdx.x;
  const int share = (kBM * kBN + split - 1) / split;
  for (int i = rank * share + threadIdx.x;
       i < min(kBM * kBN, (rank + 1) * share); i += kThreads) {
    const int r = i / kBN, c = n0 + i % kBN;
    if (r >= M || c >= N) continue;
    float v = *cluster.map_shared_rank(part + i, 0);
    for (int q = 1; q < split; ++q) v += *cluster.map_shared_rank(part + i, q);
    out[static_cast<size_t>(r) * N + c] = __float2bfloat16(v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int depth_x, int depth_w, int split,
                   cudaStream_t stream) {
  if (M > kBM || split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(depth_x, depth_w);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<queue_matmul_thin>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(split, (N + kBN - 1) / kBN);
  if (split == 1) {  // no cluster to form: the plain launch costs less
    queue_matmul_thin<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), M, N, K, depth_x, depth_w, split);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, queue_matmul_thin,
                           static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w),
                           static_cast<bf16*>(out), M, N, K, depth_x, depth_w,
                           split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace thin

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  split is the bf16 kernels' K split
// (ops.split_k); the wide kernel's parts meet in `work`, an fp32 buffer of
// split x M x N the caller allocates when split > 1.  fp32 ignores both.
int queue_matmul_launch(const void* x, const void* w, void* out, void* work,
                        int M, int N, int K, int depth_x, int depth_w,
                        int dtype, int split, void* stream) {
  if (M < 1 || N < 1 || K < 1 || depth_x < 1 || depth_w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, out, M, N, K, depth_x, depth_w, s)
                 : launch<float, 64>(x, w, out, M, N, K, depth_x, depth_w, s);
  if (dtype == 1)
    return small ? thin::launch(x, w, out, M, N, K, depth_x, depth_w, split, s)
                 : wide::launch(x, w, out, work, M, N, K, depth_x, depth_w,
                                split, s);
  return cudaErrorInvalidValue;
}

// Shared memory a launch needs (the wrapper refuses a pair above 227 KB
// before it launches; ops.py computes the same numbers).
long long queue_matmul_smem_bytes(int M, int depth_x, int depth_w, int dtype) {
  const bool small = M <= 16;
  if (dtype == 0)
    return static_cast<long long>(
        small ? smem_bytes<float, 16>(depth_x, depth_w)
              : smem_bytes<float, 64>(depth_x, depth_w));
  return static_cast<long long>(small ? thin::smem_bytes(depth_x, depth_w)
                                      : wide::smem_bytes(depth_x, depth_w));
}

const char* queue_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
