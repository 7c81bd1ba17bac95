// queue_matmul: y = x @ w through two shared-memory operand rings.
//
// Replaces the Pallas kernel src/repro/kernels/queue_matmul/kernel.py
// (queue_matmul_kernel, body _kernel): COPIFTv2's hardware FIFO queues as a
// GEMM, with one ring of `depth_x` slots for activation tiles and one of
// `depth_w` slots for weight tiles.  Step t reads slot t % depth and, once
// every thread is done with it, refills that slot with tile t + depth.
// Depth 1 is COPIFT: copy, wait, compute.
//
// What bounds it on an H100: on the serve path M is the number of decode
// slots (4) or a chunk of them, so every weight byte is used by a handful of
// rows and the kernel is bound by the bytes of w it streams from device
// memory (3.35 TB/s), far below the tensor cores' rate.  Large-M calls
// (forward over a sequence) are bound by operations instead.
//
// What the design does about it:
//  * tiles are copied with 16-byte cp.async straight into shared memory, so
//    the copies of the next `depth - 1` tiles of each operand are in flight
//    while the current tile is multiplied;
//  * the two rings have their own depths, so a single cp.async.wait_group
//    count cannot track them: each slot has its own mbarrier, and every
//    thread's cp.async.mbarrier.arrive.noinc makes the barrier's phase
//    complete only when all copies into that slot have landed.  The wait on
//    the slot's barrier is the queue pop;
//  * the block's M is 16 when M <= 16 (decode) and 64 otherwise, so decode
//    does not pay for 128 rows of padding;
//  * bf16 multiplies on the tensor cores with mma.sync m16n8k16 and an fp32
//    accumulator; fp32 multiplies with plain FMAs (no TF32), in K order,
//    each 32-deep K tile summed apart and then added to the running sum.
// The order of the sums over K never depends on the ring depths, so every
// depth gives bit-identical output.  No wgmma, TMA or warp specialisation
// yet: this is the simple, right version.
//
// The rings, the barriers and the two tile multipliers are in
// ../../_csrc/tile_ring.cuh, shared with moe_gemm.cu.
//
// C interface: queue_matmul_launch(...) returns cudaGetLastError().
// Operands are row-major and contiguous: x (M, K), w (K, N), out (M, N),
// with K and N multiples of 16 bytes' worth of elements (the wrapper pads).

#include "../../_csrc/tile_ring.cuh"

namespace {

using namespace tile_ring;

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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, K, depth_x, depth_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int queue_matmul_launch(const void* x, const void* w, void* out, int M, int N,
                        int K, int depth_x, int depth_w, int dtype,
                        void* stream) {
  if (M < 1 || N < 1 || K < 1 || depth_x < 1 || depth_w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, out, M, N, K, depth_x, depth_w, s)
                 : launch<float, 64>(x, w, out, M, N, K, depth_x, depth_w, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, out, M, N, K, depth_x,
                                             depth_w, s)
                 : launch<__nv_bfloat16, 64>(x, w, out, M, N, K, depth_x,
                                             depth_w, s);
  return cudaErrorInvalidValue;
}

const char* queue_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
