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
// No atomics in either kernel, so a result never depends on timing.  The
// two bf16 kernels' bodies live in kernels/_csrc/wide_gemm.cuh (the ring)
// and kernels/_csrc/thin_gemm.cuh (the whole block), which moe_gemm.cu
// shares; this file adds the split-K epilogue and the launches.
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
#include "../../_csrc/thin_gemm.cuh"
#include "../../_csrc/tile_ring.cuh"
#include "../../_csrc/wide_gemm.cuh"

namespace {

using namespace tile_ring;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

using hopper::allow_smem;

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

  FmaTile<BM> tile;
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

namespace wide_path {

using ::wide::kBM;
using ::wide::kBN;
using ::wide::kConsumers;
using ::wide::kHalves;
using ::wide::kThreads;
using ::wide::mainloop;
using ::wide::Stage;
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kUnit = 64;                     // K parts are multiples of it

template <int BK>
__global__ void __launch_bounds__(kThreads, 1)
    queue_matmul_wide(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      bf16* __restrict__ out, float* __restrict__ ws_part,
                      int M, int N, int K, int depth_x, int depth_w,
                      int split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // blocks of one cluster hold the `split` K parts of one output tile; a
  // part is a run of 64-deep units, whatever the stage depth
  const int rank = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * kBM, n0 = blockIdx.y * kBN;
  const int units = (K + kUnit - 1) / kUnit;
  const int per = (units + split - 1) / split;
  const int u0 = min(units, rank * per), u1 = min(units, u0 + per);
  const int k_begin = u0 * kUnit;
  const int nk = (u1 - u0) * (kUnit / BK);  // this part's stages

  float acc[kHalves][32];
  mainloop<BK>(
      smem_raw, nk, depth_x, depth_w,
      [&](void* dst, uint64_t* bar, int t) {
        hopper::tma_load_2d(dst, &tmx, bar, k_begin + t * BK, m0);
      },
      [&](void* dst, uint64_t* bar, int t, int h) {
        hopper::tma_load_2d(dst, &tmw, bar, n0 + 64 * h, k_begin + t * BK);
      },
      acc);

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
  err = allow_smem<queue_matmul_wide<BK>>(smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_in_cluster(
      queue_matmul_wide<BK>,
      dim3((M + kBM - 1) / kBM * split, (N + kBN - 1) / kBN), kThreads, smem,
      stream, split, tmx, tmw, static_cast<bf16*>(out),
      static_cast<float*>(work), M, N, K, depth_x, depth_w, split);
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

}  // namespace wide_path

// ---------------------------------------------------------------------------
// bf16, M <= 16: split-K over a cluster, cp.async rings, mma.sync
// ---------------------------------------------------------------------------

namespace thin_path {

using ::thin::gemm;
using ::thin::kBM;
using ::thin::kBN;
using ::thin::kMaxSplit;
using ::thin::kThreads;
using ::thin::smem_bytes;

__global__ void __launch_bounds__(kThreads)
    queue_matmul_thin(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ out, int M, int N, int K,
                      int depth_x, int depth_w, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm(x, w, out, M, N, K, depth_x, depth_w, split, blockIdx.x,
       blockIdx.y * kBN, smem);
}

cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int depth_x, int depth_w, int split,
                   cudaStream_t stream) {
  if (M > kBM || split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(depth_x, depth_w);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<queue_matmul_thin>(smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_in_cluster(
      queue_matmul_thin, dim3(split, (N + kBN - 1) / kBN), kThreads, smem,
      stream, split, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), M, N, K, depth_x,
      depth_w, split);
}

}  // namespace thin_path

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
    return small ? thin_path::launch(x, w, out, M, N, K, depth_x, depth_w,
                                     split, s)
                 : wide_path::launch(x, w, out, work, M, N, K, depth_x,
                                     depth_w, split, s);
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
