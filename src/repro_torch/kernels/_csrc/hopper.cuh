// Hopper building blocks shared by the port's kernels (queue_matmul.cu,
// moe_gemm.cu, flash_attention.cu and the GEMM headers beside this one):
// mbarriers that count bytes (expect_tx), TMA tile copies, wgmma with
// shared-memory descriptors, ldmatrix and mma.sync fragments, the
// tensor-map encoder reached through the runtime, and two host helpers.
//
// What each piece is for:
//  * mbar_expect_tx / mbar_arrive: a TMA ring's "full" barrier is armed by
//    the producer with the bytes its copies will bring (one arrival, then
//    the copies complete the transaction count); its "empty" barrier
//    counts one arrival per consumer warp.  mbar_wait_or_trap spins on a
//    phase parity, which is the queue pop for both, and traps after about
//    10 s rather than hang the card;
//  * tma_load_2d / tma_load_3d: one thread asks the Tensor Memory
//    Accelerator for a whole box of a row-major matrix, or of one matrix
//    of a stack of them (the third coordinate picks the matrix, so a box
//    never reaches into the next one).  Rows or columns past the matrix
//    arrive as zeros, and the barrier still counts the whole box;
//  * wgmma_m64n64k16: four warps multiply a 64 x 16 bf16 tile of A by a
//    16 x 64 tile of B, both read from shared memory through descriptors
//    (gmma_desc), into 32 fp32 accumulators a thread.  A is K-major, a 64-
//    or 32-element K tile a row with the 128- or 64-byte swizzle; B is
//    MN-major, 64 columns a row with the 128-byte swizzle: the layouts TMA
//    writes with CU_TENSOR_MAP_SWIZZLE_128B and _64B.  One wgmma spans one
//    64-column swizzle atom of B, so only the offset between 8-row groups
//    matters, and the descriptor sets both offsets to it.  wgmma_fence,
//    wgmma_commit and wgmma_wait bracket a group of them;
//  * ldmatrix_x4(_trans) and mma_16816: the warp-level tensor-core path
//    (mma.sync m16n8k16, bf16 in, fp32 accumulators);
//  * encode_tiled / encode_tiled_3d: cuTensorMapEncodeTiled is not in the
//    CUDA runtime; it is looked up once through the runtime's entry-point
//    query (the ByVersion form from CUDA 12.5), so the library links
//    against the runtime only, not against -lcuda;
//  * allow_smem: the dynamic shared-memory opt-in, set only when a launch
//    needs more than the kernel was last allowed (it costs host time, and
//    the host sets the pace of a decode body); launch_in_cluster: a launch
//    whose blocks form clusters of `cluster` along x (a plain launch when
//    it is 1).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace hopper {

using tile_ring::smem_u32;

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// mbar_wait with a limit: a wait that lasts about 10 s (2^34 cycles) means
// a copy or an arrival that will never come, and traps, so that the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One arrival that also announces `bytes` of copies still to land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Box at (c0 = column, c1 = row) of the matrix `map` describes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Box at (c0 = column, c1 = row, c2 = matrix) of the stack `map` describes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  const uint64_t a = (smem_u32(p) & 0x3FFFF) >> 4;
  return a | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, fp32) += A (64 x 16, K-major) * B (16 x 64, MN-major).
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and + 8,
// columns 8 j + 2 (t % 4) and + 1: d[4 j + {0, 1, 2, 3}].
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once.
inline cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A tensor map of `depth` row-major (rows, cols) bf16 matrices at `base`,
// matrix_stride elements apart (rank 3; rank 2 when depth is 0), in boxes
// of box_rows x box_cols (x 1 matrix), with the given swizzle.
inline cudaError_t encode_tiled_3d(CUtensorMap* map, const void* base,
                                   uint64_t depth, uint64_t rows,
                                   uint64_t cols, uint64_t matrix_stride,
                                   uint32_t box_rows, uint32_t box_cols,
                                   CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t rank = depth == 0 ? 2 : 3;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * sizeof(__nv_bfloat16),
                                 matrix_stride * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map of the row-major (rows, cols) bf16 matrix at `base`, in
// boxes of box_rows x box_cols, with the given swizzle.
inline cudaError_t encode_tiled(CUtensorMap* map, const void* base,
                                uint64_t rows, uint64_t cols,
                                uint32_t box_rows, uint32_t box_cols,
                                CUtensorMapSwizzle swizzle) {
  return encode_tiled_3d(map, base, 0, rows, cols, 0, box_rows, box_cols,
                         swizzle);
}

// Let `Kernel` use `bytes` of dynamic shared memory on the current device.
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

// Launch `kernel` with clusters of `cluster` blocks along x (no cluster to
// form when it is 1: the plain launch costs less); returns the launch's
// error.
template <typename... Params, typename... Args>
cudaError_t launch_in_cluster(void (*kernel)(Params...), dim3 grid,
                              int threads, size_t smem, cudaStream_t stream,
                              int cluster, Args... args) {
  if (cluster == 1) {
    kernel<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace hopper
