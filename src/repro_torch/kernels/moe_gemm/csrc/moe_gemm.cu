// moe_gemm: y[e] = x[e] @ w[e] for every active expert e, fp32 out; an
// inactive expert's block of y is zeros and its weights are never read.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gemm/kernel.py
// (moe_gemm_kernel, body _kernel): a (E, C/bc, f/bf) grid whose blocks walk
// K through one ring of `depth` VMEM slots, each slot holding an x tile and
// a w tile copied by DMA, with an fp32 accumulator in scratch.  Depth 1 is
// COPIFT (copy, wait, compute); depth >= 2 keeps the next tiles in flight
// (COPIFTv2).  The routing is the kernel's integer stream: `active` (E
// bytes, 0 = inactive, or null for every expert) is read by each block
// itself, so the caller never copies the routing to the host.
//
// What bounds it on an H100 depends on C (rows per expert), so the wrapper
// picks one of three kernels (ops.regime); all keep the same contract.
//
// bf16, C <= 16 ("thin", decode over the slots): bound by the bytes of the
// active experts' weights (3.35 TB/s): 4 MB an expert for olmoe's
// (2048, 1024) matrices, about 26 of 64 experts for 4 independent tokens
// at top-8.  The block is queue_matmul's thin one (kernels/_csrc/
// thin_gemm.cuh: 64-column tiles 128 deep through cp.async rings,
// mma.sync, K split over a cluster and summed in rank order), with the
// expert on the grid's third axis; a cluster of an inactive expert stores
// its zeros and leaves.
//
// bf16, C > 16 ("wide", forward over a sequence): bound by operations
// (989 TFLOP/s).  A grouped GEMM: queue_matmul's wide ring (kernels/_csrc/
// wide_gemm.cuh: a producer warp issuing TMA copies, two wgmma consumer
// warpgroups, 128 x 256 tiles) with the expert on the grid's third axis.
// x and w are stacks of matrices read through 3-D tensor maps, so a box
// never crosses into the next expert: rows past C and columns past d or f
// arrive as zeros whatever C is.  A broadcast x (expert stride 0) is one
// matrix, a map of depth 1 read at matrix 0 by every expert.  K is summed
// in one chain, in order.
//
// fp32, any C: plain FMAs (no TF32, whose error misses the 2e-4
// tolerance), each 32-deep K tile summed apart and added to the running
// sum, in a 16- or 64-row block (tile_ring.cuh).
//
// Bits: within a kernel every output element gets the same sequence of
// operations whatever the depth, C or its row, so depths are bit-identical
// and a row does not depend on its neighbours; the mask changes which
// blocks run, never what a running block computes.  A bf16 row's bits
// depend on the regime (C <= 16 or not), as queue_matmul's do.  x's expert
// stride is an argument, so the dense dispatch's x, one (C, d) matrix seen
// by every expert, is passed with stride 0 and read from its one copy.
// No atomics, so a result never depends on timing.
//
// C interface: moe_gemm_launch(...) returns a cudaError_t.  x: (E, M, K)
// with rows of K contiguous and expert stride x_stride_e elements (0 = one
// matrix for every expert); w: (E, K, N) contiguous; out: (E, M, N) fp32
// contiguous; K and N multiples of 16 bytes' worth of elements (the wrapper
// pads).

#include "../../_csrc/hopper.cuh"
#include "../../_csrc/thin_gemm.cuh"
#include "../../_csrc/tile_ring.cuh"
#include "../../_csrc/wide_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::allow_smem;
using tile_ring::kMaxSmem;

// Zeros into rows [r0, r0 + rows) x cols [c0, c0 + cols) of the (M, N)
// matrix `out`, clipped to it, by `threads` threads.
__device__ __forceinline__ void store_zeros(float* out, int M, int N, int r0,
                                            int rows, int c0, int cols,
                                            int threads) {
  for (int i = threadIdx.x; i < rows * cols; i += threads) {
    const int r = r0 + i / cols, c = c0 + i % cols;
    if (r < M && c < N) out[static_cast<size_t>(r) * N + c] = 0.f;
  }
}

__device__ __forceinline__ bool inactive(const unsigned char* active, int e) {
  return active != nullptr && active[e] == 0;
}

// ---------------------------------------------------------------------------
// fp32: the cp.async ring of tile_ring.cuh
// ---------------------------------------------------------------------------

namespace fma_path {

using namespace tile_ring;

template <int BM>
size_t smem_bytes(int depth) {
  return tiles_offset(depth) +
         sizeof(float) * static_cast<size_t>(depth) * (BM * kBK + kBK * kBN);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
    moe_gemm_fma(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, const unsigned char* active, int M,
                 int N, int K, long long x_stride_e, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  float* oe = out + static_cast<size_t>(e) * M * N;
  if (inactive(active, e)) {
    store_zeros(oe, M, N, m0, BM, n0, kBN, kThreads);
    return;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + tiles_offset(depth));
  float* ws = xs + static_cast<size_t>(depth) * BM * kBK;
  constexpr int kXTile = BM * kBK, kWTile = kBK * kBN;

  const int nk = (K + kBK - 1) / kBK;
  const float* xe = x + static_cast<long long>(e) * x_stride_e;
  const float* we = w + static_cast<size_t>(e) * K * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(bar + s, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  // prologue: fill the ring
  for (int t = 0; t < depth && t < nk; ++t) {
    load_tile<float, BM, kBK>(xs + t * kXTile, xe, M, K, m0, t * kBK);
    load_tile<float, kBK, kBN>(ws + t * kWTile, we, K, N, t * kBK, n0);
    cp_async_arrive(bar + t);
  }

  FmaTile<BM> tile;
  tile.zero();
  for (int t = 0; t < nk; ++t) {
    const int s = t % depth;
    // queue pop: wait until both tiles of this slot have landed
    mbar_wait(bar + s, (t / depth) & 1);
    tile.mma(xs + s * kXTile, ws + s * kWTile);
    __syncthreads();  // every thread is done with the slot
    if (t + depth < nk) {
      load_tile<float, BM, kBK>(xs + s * kXTile, xe, M, K, m0,
                                (t + depth) * kBK);
      load_tile<float, kBK, kBN>(ws + s * kWTile, we, K, N, (t + depth) * kBK,
                                 n0);
      cp_async_arrive(bar + s);
    }
  }
  tile.store(oe, M, N, m0, n0);
}

template <int BM>
cudaError_t launch(const void* x, const void* w, void* out,
                   const unsigned char* active, int E, int M, int N, int K,
                   long long x_stride_e, int depth, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(depth);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<moe_gemm_fma<BM>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, E);
  moe_gemm_fma<BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), active, M, N, K, x_stride_e, depth);
  return cudaGetLastError();
}

}  // namespace fma_path

// ---------------------------------------------------------------------------
// bf16, C <= 16: queue_matmul's thin block, one expert per grid z
// ---------------------------------------------------------------------------

namespace thin_path {

using ::thin::gemm;
using ::thin::kBM;
using ::thin::kBN;
using ::thin::kMaxSplit;
using ::thin::kThreads;
using ::thin::smem_bytes;

__global__ void __launch_bounds__(kThreads)
    moe_gemm_thin(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  float* __restrict__ out, const unsigned char* active, int M,
                  int N, int K, long long x_stride_e, int depth, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.z, n0 = blockIdx.y * kBN;
  float* oe = out + static_cast<size_t>(e) * M * N;
  if (inactive(active, e)) {  // the whole cluster leaves together
    if (blockIdx.x == 0) store_zeros(oe, M, N, 0, kBM, n0, kBN, kThreads);
    return;
  }
  gemm(x + static_cast<long long>(e) * x_stride_e,
       w + static_cast<size_t>(e) * K * N, oe, M, N, K, depth, depth, split,
       blockIdx.x, n0, smem);
}

cudaError_t launch(const void* x, const void* w, void* out,
                   const unsigned char* active, int E, int M, int N, int K,
                   long long x_stride_e, int depth, int split,
                   cudaStream_t stream) {
  if (M > kBM || split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(depth, depth);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<moe_gemm_thin>(smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_in_cluster(
      moe_gemm_thin, dim3(split, (N + kBN - 1) / kBN, E), kThreads, smem,
      stream, split, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<float*>(out), active, M, N, K,
      x_stride_e, depth, split);
}

}  // namespace thin_path

// ---------------------------------------------------------------------------
// bf16, C > 16: a grouped GEMM on TMA and wgmma, one expert per grid z
// ---------------------------------------------------------------------------

namespace wide_path {

using ::wide::kBM;
using ::wide::kBN;
using ::wide::kConsumers;
using ::wide::kHalves;
using ::wide::kThreads;
using ::wide::mainloop;
using ::wide::Stage;

template <int BK>
__global__ void __launch_bounds__(kThreads, 1)
    moe_gemm_wide(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw,
                  float* __restrict__ out, const unsigned char* active, int M,
                  int N, int K, int x_bcast, int depth) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float* oe = out + static_cast<size_t>(e) * M * N;
  if (inactive(active, e)) {
    store_zeros(oe, M, N, m0, kBM, n0, kBN, kThreads);
    return;
  }
  const int ex = x_bcast ? 0 : e;
  float acc[kHalves][32];
  mainloop<BK>(
      smem_raw, (K + BK - 1) / BK, depth, depth,
      [&](void* dst, uint64_t* bar, int t) {
        hopper::tma_load_3d(dst, &tmx, bar, t * BK, m0, ex);
      },
      [&](void* dst, uint64_t* bar, int t, int h) {
        hopper::tma_load_3d(dst, &tmw, bar, n0 + 64 * h, t * BK, e);
      },
      acc);
  if (threadIdx.x >= kConsumers) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + 64 * (threadIdx.x / 128) + 16 * warp + lane / 4;
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 64 * h + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;  // N is even: c + 1 < N too
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= M) continue;
        *reinterpret_cast<float2*>(oe + static_cast<size_t>(r) * N + c) =
            make_float2(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1]);
      }
    }
}

template <int BK>
cudaError_t launch_bk(const void* x, const void* w, void* out,
                      const unsigned char* active, int E, int M, int N, int K,
                      long long x_stride_e, int depth, cudaStream_t stream) {
  const size_t smem = Stage<BK>::smem(depth, depth);
  CUtensorMap tmx, tmw;
  // x: E matrices of (M, K), or one (depth 1) when it is broadcast
  cudaError_t err = hopper::encode_tiled_3d(
      &tmx, x, x_stride_e == 0 ? 1 : E, M, K,
      x_stride_e == 0 ? static_cast<long long>(M) * K : x_stride_e, kBM, BK,
      BK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_tiled_3d(&tmw, w, E, K, N,
                                static_cast<long long>(K) * N, BK, 64,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = allow_smem<moe_gemm_wide<BK>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
  moe_gemm_wide<BK><<<grid, kThreads, smem, stream>>>(
      tmx, tmw, static_cast<float*>(out), active, M, N, K,
      x_stride_e == 0 ? 1 : 0, depth);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w, void* out,
                   const unsigned char* active, int E, int M, int N, int K,
                   long long x_stride_e, int depth, cudaStream_t stream) {
  if (Stage<64>::smem(depth, depth) <= static_cast<size_t>(kMaxSmem))
    return launch_bk<64>(x, w, out, active, E, M, N, K, x_stride_e, depth,
                         stream);
  if (Stage<32>::smem(depth, depth) <= static_cast<size_t>(kMaxSmem))
    return launch_bk<32>(x, w, out, active, E, M, N, K, x_stride_e, depth,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace wide_path

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w); out is always float32.
// active: E bytes on the device (0 = inactive expert) or null (every
// expert).  split: the thin kernel's K split (ops.split_k); the other
// kernels ignore it.
int moe_gemm_launch(const void* x, const void* w, void* out,
                    const void* active, int E, int M, int N, int K,
                    long long x_stride_e, int depth, int dtype, int split,
                    void* stream) {
  if (E < 1 || E > 65535 || M < 1 || N < 1 || K < 1 || depth < 1 ||
      x_stride_e < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const unsigned char*>(active);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? fma_path::launch<16>(x, w, out, act, E, M, N, K,
                                        x_stride_e, depth, s)
                 : fma_path::launch<64>(x, w, out, act, E, M, N, K,
                                        x_stride_e, depth, s);
  if (dtype == 1)
    return small ? thin_path::launch(x, w, out, act, E, M, N, K, x_stride_e,
                                     depth, split, s)
                 : wide_path::launch(x, w, out, act, E, M, N, K, x_stride_e,
                                     depth, s);
  return cudaErrorInvalidValue;
}

// Shared memory one block needs at this depth (the wrapper refuses a depth
// above 227 KB before it launches; ops.py computes the same numbers).
long long moe_gemm_smem_bytes(int M, int depth, int dtype) {
  const bool small = M <= 16;
  if (dtype == 0)
    return static_cast<long long>(small ? fma_path::smem_bytes<16>(depth)
                                        : fma_path::smem_bytes<64>(depth));
  return static_cast<long long>(small ? ::thin::smem_bytes(depth, depth)
                                      : ::wide::smem_bytes(depth, depth));
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
