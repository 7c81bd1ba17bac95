// Device code shared by queue_matmul.cu, moe_gemm.cu, thin_gemm.cuh and
// flash_attention.cu: shared-memory tile rings filled with cp.async, one
// mbarrier per slot, and the fp32 GEMM block (FMAs).
//
// Every thread copies its share of a ring slot with cp.async and then
// issues cp.async.mbarrier.arrive.noinc on the slot's barrier (initialised
// to kThreads), so the barrier's phase completes once every copy into the
// slot has landed; waiting on that phase is the queue pop.
//
// The fp32 block (Fma, fma_gemm) is queue_matmul's and moe_gemm's fp32
// product at any M; their bf16 products take the thin (M <= 16) or wide
// kernel (thin_gemm.cuh, wide_gemm.cuh).  On an H100 an fp32 product is
// bound by the FMA rate (67 TFLOP/s; TF32 would miss the 2e-4 tolerance)
// at M of a few hundred and up, and by the bytes of w at decode's M <= 16.
// A thread keeps an 8 x 8 micro-tile of a 128 x 128 tile (8 x 4 of
// 128 x 64, 4 x 4 of 64 x 64, where the larger tiles would leave SMs
// idle; 1 x 4 of 16 x 64 at M <= 16) and reads x and w as float4s, 16
// vector loads for 256 FMAs; every copy into a ring is 16 bytes.  The
// fixed sum order below keeps a partial sum beside each output, 128
// registers for the 8 x 8 tile, so the block runs at 8 warps an SM, and
// there its loop of FMAs alone, loads, copies and barriers taken out,
// stays well short of the FMA rate; the barriers and waits of its 16-deep
// stages, and its loads and copies, add to that.
//
// Every output element gets one fixed sequence of operations, whatever the
// tile, the stage depth (16 or 32 k), the ring depths, M or the element's
// row: for each 32-deep K tile in K order, a chain of fmaf from 0 in k
// order, then acc += that partial sum.  So a result never depends on the
// ring depth, on M, or on which row a token sits in, and the bits are
// those of the 4 x 4 block it replaced.  The chain of 32 + K/32 additions
// in place of K keeps its rounding error below a blocked CPU sgemm's (one
// long chain of FMAs was twice as far from an fp64 product).  The bf16
// kernels sum in other orders, so a bf16 row's bits depend on whether
// M <= 16, and on nothing else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_ring {

constexpr int kThreads = 256;
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

// Wait for a phase of `bar` (the queue pop).  A wait that lasts about 10 s
// (2^34 cycles) means a copy or an arrival that will never come, and traps,
// so that the launch fails with an error instead of holding the card.
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

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory starts with `n_barriers` mbarriers (8 bytes each); tiles
// start at the next 128-byte boundary.
__host__ __device__ inline size_t tiles_offset(int n_barriers) {
  return (static_cast<size_t>(n_barriers) * 8 + 127) / 128 * 128;
}

// 4-byte copy; zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Component e of v (e known at compile time once loops are unrolled).
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// The fp32 GEMM block: out = x @ w on FMAs, x (M, K) and w (K, N) row-major,
// K and N multiples of 4, out fp32.
// ---------------------------------------------------------------------------

// Every output element gets one sequence of operations: for each kSum-deep
// K tile in K order, a chain of fmaf from 0 in k order, then acc += that
// partial sum.  The block's shape, the stage depth and the ring depths
// change which thread runs it and when, never the sequence.
constexpr int kSum = 32;

// A block of BM x BN outputs, 256 threads as a 16 x 16 grid (ty, tx):
//  * BM = 128: a thread keeps rows 4 ty + i and 64 + 4 ty + i (i < 4) and
//    columns 4 tx + j (BN = 64) or those and 64 + 4 tx + j (BN = 128), an
//    8 x 4 or 8 x 8 micro-tile.  A stage holds 16 k: x as it lies (128
//    rows of 16 k, a row's float4s XOR-swizzled by bit 2 of the row, so
//    the two row groups a warp reads fall on other banks), w as it lies
//    (16 rows of BN).  Per 4 k a thread reads a float4 of each of its 8 x
//    rows and one or two float4 of w a k: 16 vector loads for 256 FMAs;
//  * BM = 64: a thread keeps rows 4 ty + i and columns 4 tx + j; a stage
//    holds 32 k (64 rows of x, their float4s swizzled the same way);
//  * BM = 16 (M <= 16, decode): a thread keeps row ty and columns 4 tx + j
//    of a 16 x 64 tile (2 tx + j of 16 x 32, where 64-wide tiles would
//    leave SMs idle); a stage holds 32 k of x and of w.
// A ring slot is 8 KB of x and 8 KB of w at BM = 128 and 64 (BN = 64 at
// BM = 128 fills half the w slot) and 2 KB and 8 KB at BM = 16, so the
// shared memory a depth pair needs depends on M <= 16 only.  Every copy is
// 16 bytes, and a thread's copies into a slot are fixed by its index: their
// sources and slot offsets are worked out once, so a refill costs a few
// instructions a copy (4-byte copies with their addresses worked out each
// stage took a quarter of the block's instructions).
template <int BM, int BN>
struct Fma {
  static_assert((BM == 128 && (BN == 128 || BN == 64)) ||
                    (BM == 64 && BN == 64) ||
                    (BM == 16 && (BN == 64 || BN == 32)),
                "fp32 blocks are 128 x 128, 128 x 64, 64 x 64, 16 x 64 or "
                "16 x 32");
  static constexpr int kBK = BM == 128 ? 16 : 32;        // k a stage
  static constexpr int kXSlot = BM * kBK;                  // floats
  static constexpr int kWSlot = kBK * (BM == 128 ? 128 : 64);
  static constexpr int kTM = BM / 16;                      // rows a thread
  static constexpr int kTN = BN / 16;                      // cols a thread
  // w: 16-byte chunks a row, rows a pass of the 256 threads, passes
  static constexpr int kCpr = BN / 4, kRpp = kThreads / kCpr;
  static constexpr int kWPasses = kBK / kRpp;

  float acc[kTM][kTN], part[kTM][kTN];
  // this thread's copies: x from x_src (+ k0), w from w_src (+ k0 N), each
  // masked by its row or column and by k < K
  const float* x_src;
  const float* w_src;
  size_t x_half;  // 64 rows of x (BM = 128)
  size_t w_rows;  // kRpp rows of w
  int x_at, x_k, w_k, x_rows_in, w_col_in;

  __device__ __forceinline__ void init(const float* x, const float* w, int M,
                                       int N, int K, int m0, int n0) {
    if constexpr (BM == 128) {
      // chunk q = tid + 256 p: row q / 4 (tid / 4 + 64 p), k 4 (q % 4);
      // rows of 16 k, a row's chunks XOR-swizzled by bit 2 of the row
      const int r0 = threadIdx.x >> 2, c = threadIdx.x & 3;
      x_k = 4 * c;
      x_at = r0 * 16 + 4 * (c ^ ((r0 >> 2) & 1));
      x_src = x + static_cast<size_t>(m0 + r0) * K + x_k;
      x_half = 64 * static_cast<size_t>(K);
      x_rows_in = (m0 + r0 < M) | ((m0 + r0 + 64 < M) << 1);
    } else if constexpr (BM == 64) {
      // chunk q = tid + 256 p: row q / 8 (tid / 8 + 32 p), k 4 (q % 8);
      // rows of 32 k, a row's chunks XOR-swizzled by bit 2 of the row
      const int r0 = threadIdx.x >> 3, c = threadIdx.x & 7;
      x_k = 4 * c;
      x_at = r0 * 32 + 4 * (c ^ ((r0 >> 2) & 1));
      x_src = x + static_cast<size_t>(m0 + r0) * K + x_k;
      x_half = 32 * static_cast<size_t>(K);
      x_rows_in = (m0 + r0 < M) | ((m0 + r0 + 32 < M) << 1);
    } else {
      // chunk tid (threads 0-127): row tid / 8, k 4 (tid % 8); rows of 32 k
      const int r = (threadIdx.x >> 3) & 15, c = threadIdx.x & 7;
      x_k = 4 * c;
      x_at = threadIdx.x < 128 ? 4 * threadIdx.x : -1;
      x_src = x + static_cast<size_t>(m0 + r) * K + x_k;
      x_half = 0;
      x_rows_in = m0 + r < M;
    }
    const int col = 4 * (threadIdx.x % kCpr);
    w_k = threadIdx.x / kCpr;
    w_src = w + static_cast<size_t>(w_k) * N + n0 + col;
    w_rows = static_cast<size_t>(kRpp) * N;
    w_col_in = n0 + col < N;  // N % 4 == 0: the whole chunk or none
  }

  // x rows [m0, m0 + BM) x k [k0, k0 + kBK) into a slot; rows past M and
  // k past K arrive as zeros (K % 4 == 0: a chunk is all in or all out)
  __device__ __forceinline__ void load_x(float* xs, const float* x, int K,
                                         int k0) const {
    if constexpr (BM != 16) {  // 128 or 64 rows: two chunks a thread
      const bool k_in = k0 + x_k < K;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const bool in = k_in && ((x_rows_in >> p) & 1);
        cp_async16(xs + x_at + 1024 * p, in ? x_src + p * x_half + k0 : x,
                   in ? 16 : 0);
      }
    } else if (x_at >= 0) {
      const bool in = x_rows_in && k0 + x_k < K;
      cp_async16(xs + x_at, in ? x_src + k0 : x, in ? 16 : 0);
    }
  }

  // w rows [k0, k0 + kBK) x cols [n0, n0 + BN) as they lie, 16-byte copies
  __device__ __forceinline__ void load_w(float* ws, const float* w, int K,
                                         int N, int k0) const {
    const float* src = w_src + static_cast<size_t>(k0) * N;
#pragma unroll
    for (int p = 0; p < kWPasses; ++p) {
      const bool in = w_col_in && k0 + w_k + kRpp * p < K;
      cp_async16(ws + 4 * threadIdx.x + 1024 * p, in ? src + p * w_rows : w,
                 in ? 16 : 0);
    }
  }

  __device__ __forceinline__ void zero(float (&a)[kTM][kTN]) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) a[i][j] = 0.f;
  }

  // one stage's kBK k into part, in k order
  __device__ __forceinline__ void mma(const float* xs, const float* ws) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    if constexpr (BM == 128) {
#pragma unroll
      for (int kq = 0; kq < kBK / 4; ++kq) {
        float4 xr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 4 * ty + (i & 3) + 64 * (i >> 2);
          xr[i] = *reinterpret_cast<const float4*>(
              xs + r * 16 + 4 * (kq ^ (ty & 1)));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * kq + kk;
          float a[kTM], b[kTN];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = elem(xr[i], kk);
#pragma unroll
          for (int h = 0; h < kTN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                ws + k * BN + 64 * h + 4 * tx);
            b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
            b[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              part[i][j] = fmaf(a[i], b[j], part[i][j]);
        }
      }
    } else if constexpr (BM == 64) {
#pragma unroll
      for (int kq = 0; kq < kBK / 4; ++kq) {
        float4 xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xr[i] = *reinterpret_cast<const float4*>(
              xs + (4 * ty + i) * 32 + 4 * (kq ^ (ty & 1)));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (4 * kq + kk) * 64 + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i][j] = fmaf(elem(xr[i], kk), elem(v, j), part[i][j]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float a = xs[ty * 32 + k];
        if constexpr (BN == 64) {
          const float4 v =
              *reinterpret_cast<const float4*>(ws + k * 64 + 4 * tx);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[0][j] = fmaf(a, elem(v, j), part[0][j]);
        } else {
          const float2 v =
              *reinterpret_cast<const float2*>(ws + k * 32 + 2 * tx);
          part[0][0] = fmaf(a, v.x, part[0][0]);
          part[0][1] = fmaf(a, v.y, part[0][1]);
        }
      }
    }
  }

  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += part[i][j];
  }

  __device__ __forceinline__ void store(float* out, int M, int N, int m0,
                                        int n0) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = m0 + (BM == 128   ? 4 * ty + (i & 3) + 64 * (i >> 2)
                          : BM == 64 ? 4 * ty + i
                                     : ty);
      if (r >= M) continue;
      if constexpr (kTN == 2) {
        const int c = n0 + 2 * tx;  // N % 4 == 0: both or neither
        if (c < N)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + c) =
              make_float2(acc[i][0], acc[i][1]);
      }
#pragma unroll
      for (int h = 0; h < kTN / 4; ++h) {
        const int c = n0 + 64 * h + 4 * tx;  // N % 4 == 0: all 4 or none
        if (c < N)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * N + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      }
    }
  }
};

// Shared memory of the fp32 block for `n_bars` mbarriers and the two rings
// (the host's ops.smem_bytes computes the same).
template <int BM>
__host__ __device__ inline size_t fma_smem_bytes(int n_bars, int depth_x,
                                                 int depth_w) {
  using F = Fma<BM, 64>;
  return tiles_offset(n_bars) +
         sizeof(float) * (static_cast<size_t>(depth_x) * F::kXSlot +
                          static_cast<size_t>(depth_w) * F::kWSlot);
}

// The fp32 block over all of K through cp.async rings: x through
// `depth_x` slots and w through `depth_w`, each slot's copies completing a
// phase of its mbarrier (depth 1: copy, wait, compute; deeper rings keep
// the next tiles in flight).  kJoint: one ring of `depth_x` slots whose x
// and w tiles share a barrier (moe_gemm's layout; depth_w is depth_x).
// The outer loop walks the 32-deep summing units, the inner one their
// stages (two at BM = 128), so a unit's partial sums start from zero and
// end in acc without a test on every stage.
template <int BM, int BN, bool kJoint>
__device__ __forceinline__ void fma_gemm(const float* __restrict__ x,
                                         const float* __restrict__ w,
                                         float* __restrict__ out, int M,
                                         int N, int K, int depth_x,
                                         int depth_w, int m0, int n0,
                                         unsigned char* smem) {
  using F = Fma<BM, BN>;
  constexpr int kPer = kSum / F::kBK;  // stages a summing unit
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = kJoint ? bar_x : bar_x + depth_x;
  const int n_bars = kJoint ? depth_x : depth_x + depth_w;
  float* xs = reinterpret_cast<float*>(smem + tiles_offset(n_bars));
  float* ws = xs + static_cast<size_t>(depth_x) * F::kXSlot;
  const int nk = (K + F::kBK - 1) / F::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_bars; ++s) mbar_init(bar_x + s, kThreads);
    mbar_init_fence();
  }
  F f;
  f.init(x, w, M, N, K, m0, n0);
  __syncthreads();

  // prologue: fill each ring to its own depth
  for (int t = 0; t < depth_x && t < nk; ++t) {
    f.load_x(xs + t * F::kXSlot, x, K, t * F::kBK);
    if (kJoint) f.load_w(ws + t * F::kWSlot, w, K, N, t * F::kBK);
    cp_async_arrive(bar_x + t);
  }
  if (!kJoint)
    for (int t = 0; t < depth_w && t < nk; ++t) {
      f.load_w(ws + t * F::kWSlot, w, K, N, t * F::kBK);
      cp_async_arrive(bar_w + t);
    }

  // refill the slots of stage t with stage t + depth (all threads are done
  // with them)
  auto refill = [&](int t) {
    const int sx = t % depth_x, sw = t % depth_w;
    if (t + depth_x < nk) {
      f.load_x(xs + sx * F::kXSlot, x, K, (t + depth_x) * F::kBK);
      if (kJoint)
        f.load_w(ws + sx * F::kWSlot, w, K, N, (t + depth_x) * F::kBK);
      cp_async_arrive(bar_x + sx);
    }
    if (!kJoint && t + depth_w < nk) {
      f.load_w(ws + sw * F::kWSlot, w, K, N, (t + depth_w) * F::kBK);
      cp_async_arrive(bar_w + sw);
    }
  };
  f.zero(f.acc);
  for (int t0 = 0; t0 < nk; t0 += kPer) {
    f.zero(f.part);
    // a last, shorter unit ends with K: the k past K it lacks would add
    // fmaf(0, 0, .), which changes no sum
    const int t1 = min(nk, t0 + kPer);
#pragma unroll 1
    for (int t = t0; t < t1; ++t) {
      // queue pop: wait until this stage's slots have landed
      mbar_wait_or_trap(bar_x + t % depth_x, (t / depth_x) & 1);
      if (!kJoint) mbar_wait_or_trap(bar_w + t % depth_w, (t / depth_w) & 1);
      f.mma(xs + (t % depth_x) * F::kXSlot, ws + (t % depth_w) * F::kWSlot);
      __syncthreads();  // every thread is done with both slots
      refill(t);
    }
    f.fold();
  }
  f.store(out, M, N, m0, n0);
}

// The fp32 block's tile for `batches` products of M x N outputs: at
// M <= 16, 16 x 64, or 16 x 32 where the 64-wide tiles alone would leave
// SMs of an H100 (132) idle (w's bytes stream through more SMs at once);
// above, 128 x 128 where those tiles alone give every SM a block, else
// 128 x 64 where those do, else 64 x 64 (small products: more blocks, and
// 32-deep stages, half as many barriers).  Any tile gives the same bits.
enum FmaTile {
  kTile16x32, kTile16x64, kTile64x64, kTile128x64, kTile128x128
};
__host__ __device__ inline FmaTile fma_tile(int M, int N, int batches) {
  const long long cols64 = static_cast<long long>(batches) * ((N + 63) / 64);
  if (M <= 16) return cols64 >= 132 ? kTile16x64 : kTile16x32;
  const long long rows = (M + 127) / 128;
  if (rows * batches * ((N + 127) / 128) >= 132) return kTile128x128;
  if (rows * cols64 >= 132) return kTile128x64;
  return kTile64x64;
}

}  // namespace tile_ring
