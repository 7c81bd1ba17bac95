// Device code shared by queue_matmul.cu, moe_gemm.cu and thin_gemm.cuh:
// shared-memory tile rings filled with cp.async, one mbarrier per slot, and
// the fp32 tile multiplier (FMAs).
//
// A ring slot holds one BM x kBK tile of the activations and/or one
// kBK x kBN tile of the weights.  Every thread copies its share of a slot
// with 16-byte cp.async and then issues cp.async.mbarrier.arrive.noinc on
// the slot's barrier (initialised to kThreads), so the barrier's phase
// completes once every copy into the slot has landed; waiting on that phase
// is the queue pop.
//
// The multiplier sums over K in K order, one kBK tile after the other, and
// gives every output element the same sequence of operations whatever the
// block's row count (16 or 64) and the element's place in it, so a result
// of it never depends on the ring depth, on M, or on which row a token
// sits in.  queue_matmul's and moe_gemm's fp32 products use it; their
// bf16 products take the thin (M <= 16) or wide kernel (thin_gemm.cuh,
// wide_gemm.cuh), which sum in other orders, so there a bf16 row's bits
// depend on whether M <= 16, and on nothing else.
// It sums each kBK tile on its own and adds that partial
// sum to the running one: a chain of kBK + K/kBK additions in place of K,
// which keeps its rounding error below a blocked CPU sgemm's (one long
// chain of FMAs was twice as far from an fp64 product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_ring {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 16-byte copy; bytes past `src_bytes` are zero-filled (ragged edges).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major (R, C) matrix
// into a dense ROWS x COLS tile; out-of-range elements become zero.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int R, int C,
                                          int r0, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = COLS / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c % kChunksPerRow) * kVec;
    const int gr = r0 + r, gc = c0 + cc;
    uint32_t bytes = 0;
    const T* p = src;
    if (gr < R && gc < C) {
      bytes = static_cast<uint32_t>(min(kVec, C - gc) * sizeof(T));
      p = src + static_cast<size_t>(gr) * C + gc;
    }
    cp_async16(dst + r * COLS + cc, p, bytes);
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// fp32: a 16 x 16 thread grid, each thread owns (BM/16) x (BN/16) outputs
// strided by 16 so shared-memory reads of w are conflict-free.
template <int BM>
struct FmaTile {
  static constexpr int TM = BM / 16, TN = kBN / 16;
  float acc[TM][TN];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  __device__ void mma(const float* xs, const float* ws) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float part[TM][TN];  // this kBK tile's sum, added to acc at the end
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + 16 * i) * kBK + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
  }
  template <typename O>
  __device__ void store(O* out, int M, int N, int m0, int n0) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < N) put(out + static_cast<size_t>(r) * N + c, acc[i][j]);
      }
    }
  }
};

// Shared memory starts with `n_barriers` mbarriers (8 bytes each); tiles
// start at the next 128-byte boundary.
__host__ __device__ inline size_t tiles_offset(int n_barriers) {
  return (static_cast<size_t>(n_barriers) * 8 + 127) / 128 * 128;
}

}  // namespace tile_ring
