// moe_gemm: y[e] = x[e] @ w[e] for every expert e, summed and stored in fp32.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gemm/kernel.py
// (moe_gemm_kernel, body _kernel): a (E, C/bc, f/bf) grid whose blocks walk
// K through one ring of `depth` VMEM slots, each slot holding an x tile and
// a w tile copied by DMA, with an fp32 accumulator in scratch.  Depth 1 is
// COPIFT (copy, wait, compute); depth >= 2 keeps the next tiles in flight
// (COPIFTv2).
//
// What bounds it on an H100: on the decode path C is the number of slots
// (4), so each expert's weights are used by a handful of rows and the
// kernel is bound by the bytes of w it streams from device memory
// (3.35 TB/s): 268 MB a call for olmoe's (64, 2048, 1024) bf16 experts.
// With C in the hundreds (forward over a sequence) it is bound by
// operations instead.
//
// What the design does about it:
//  * the grid is (f tiles, C tiles, E): every expert's weight columns are
//    spread over many blocks, 1024 of them at the decode shape, so enough
//    copies are in flight to stream the weights;
//  * each block walks K through one ring of `depth` slots, each holding an
//    x tile and a w tile copied with 16-byte cp.async; one mbarrier per slot
//    completes when both tiles have landed (tile_ring.cuh);
//  * the block's rows are 16 when C <= 16 (decode) and 64 otherwise;
//  * x's expert stride is an argument, so the dense dispatch's x, one
//    (C, d) matrix seen by every expert, is passed with stride 0 and read
//    from its one copy;
//  * bf16 multiplies on the tensor cores (mma.sync m16n8k16) and fp32 on
//    plain FMAs (no TF32, each 32-deep K tile summed apart and then added),
//    both into fp32 sums in K order, which never depends on the depth, on
//    C, or on a row's place in the block: depths give bit-identical
//    outputs, and so do chunked and token prefill.
// No wgmma, TMA or warp specialisation yet: this is the simple, right
// version.
//
// C interface: moe_gemm_launch(...) returns cudaGetLastError().
// x: (E, M, K) with rows of K contiguous and expert stride x_stride_e
// elements (0 = one matrix for every expert); w: (E, K, N) contiguous;
// out: (E, M, N) fp32 contiguous; K and N multiples of 16 bytes' worth of
// elements (the wrapper pads).

#include "../../_csrc/tile_ring.cuh"

namespace {

using namespace tile_ring;

template <typename T, int BM>
size_t smem_bytes(int depth) {
  return tiles_offset(depth) +
         sizeof(T) * static_cast<size_t>(depth) * (BM * kBK + kBK * kBN);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ out, int M, int N, int K,
                    long long x_stride_e, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* xs = reinterpret_cast<T*>(smem + tiles_offset(depth));
  T* ws = xs + static_cast<size_t>(depth) * BM * kBK;
  constexpr int kXTile = BM * kBK, kWTile = kBK * kBN;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const T* xe = x + static_cast<long long>(e) * x_stride_e;
  const T* we = w + static_cast<size_t>(e) * K * N;
  float* oe = out + static_cast<size_t>(e) * M * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(bar + s, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  // prologue: fill the ring
  for (int t = 0; t < depth && t < nk; ++t) {
    load_tile<T, BM, kBK>(xs + t * kXTile, xe, M, K, m0, t * kBK);
    load_tile<T, kBK, kBN>(ws + t * kWTile, we, K, N, t * kBK, n0);
    cp_async_arrive(bar + t);
  }

  typename TileFor<T, BM>::type tile;
  tile.zero();
  for (int t = 0; t < nk; ++t) {
    const int s = t % depth;
    // queue pop: wait until both tiles of this slot have landed
    mbar_wait(bar + s, (t / depth) & 1);
    tile.mma(xs + s * kXTile, ws + s * kWTile);
    __syncthreads();  // every thread is done with the slot
    if (t + depth < nk) {
      load_tile<T, BM, kBK>(xs + s * kXTile, xe, M, K, m0, (t + depth) * kBK);
      load_tile<T, kBK, kBN>(ws + s * kWTile, we, K, N, (t + depth) * kBK, n0);
      cp_async_arrive(bar + s);
    }
  }
  tile.store(oe, M, N, m0, n0);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, void* out, int E, int M,
                   int N, int K, long long x_stride_e, int depth,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BM>(depth);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = moe_gemm_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(out), M, N, K, x_stride_e, depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w); out is always float32.
int moe_gemm_launch(const void* x, const void* w, void* out, int E, int M,
                    int N, int K, long long x_stride_e, int depth, int dtype,
                    void* stream) {
  if (E < 1 || E > 65535 || M < 1 || N < 1 || K < 1 || depth < 1 ||
      x_stride_e < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, out, E, M, N, K, x_stride_e,
                                     depth, s)
                 : launch<float, 64>(x, w, out, E, M, N, K, x_stride_e,
                                     depth, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, out, E, M, N, K,
                                             x_stride_e, depth, s)
                 : launch<__nv_bfloat16, 64>(x, w, out, E, M, N, K,
                                             x_stride_e, depth, s);
  return cudaErrorInvalidValue;
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
