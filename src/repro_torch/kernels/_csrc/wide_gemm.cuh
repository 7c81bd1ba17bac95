// The wide bf16 GEMM's main loop (M > 16 rows), shared by queue_matmul.cu
// (one matrix) and moe_gemm.cu (one matrix per expert).  Bound by
// operations (989 TFLOP/s):
//  * one producer warp issues TMA copies: a 128-row box of x into the x
//    ring and four 64-column boxes of w into the w ring (w is (K, N)
//    row-major, so its boxes are MN-major with the 128-byte swizzle).
//    Each stage has a full mbarrier, armed with the stage's bytes, and an
//    empty one, one arrival per consumer warp;
//  * two consumer warpgroups, 64 rows each, pop a stage from each ring,
//    run wgmma m64n64k16 bf16 -> fp32 with both operands read from shared
//    memory through descriptors, wait for them and release the stages.  A
//    block computes a 128 x 256 tile;
//  * a stage is 64 deep (x 16 KB, w 32 KB) when both rings fit at that
//    depth, else 32 deep (8 and 16 KB, x with the 64-byte swizzle).  Every
//    k16 step is the same either way, so the choice never changes a bit.
// The caller supplies the copies (2-D or 3-D boxes, where its K part
// starts) and stores the accumulators.

#pragma once

#include "hopper.cuh"
#include "tile_ring.cuh"

namespace wide {

using tile_ring::kMaxSmem;
using tile_ring::mbar_init;
using tile_ring::mbar_init_fence;
using tile_ring::smem_u32;

constexpr int kBM = 128, kBN = 256;
constexpr int kHalves = kBN / 64;             // 64-column boxes of w
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and one producer warp

// A stage is BK deep: 64 when both rings fit at that depth, else 32.
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

inline size_t smem_bytes(int depth_x, int depth_w) {
  const size_t deep = Stage<64>::smem(depth_x, depth_w);
  return deep <= static_cast<size_t>(kMaxSmem)
             ? deep
             : Stage<32>::smem(depth_x, depth_w);
}

// The ring of `nk` BK-deep stages in the dynamic shared memory at
// `smem_raw` (Stage<BK>::smem bytes), run by all kThreads threads.
// load_x(dst, bar, t) and load_w(dst, bar, t, h) issue stage t's TMA copy
// of x and of w's 64-column box h, completing on `bar`.  On return the
// consumer threads (threadIdx.x < kConsumers) hold in acc[h] their share of
// columns 64 h .. 64 h + 63 of rows 64 (threadIdx.x / 128) .. + 63, in
// wgmma_m64n64k16's layout (hopper.cuh), summed over the stages in order.
template <int BK, typename LoadX, typename LoadW>
__device__ __forceinline__ void mainloop(unsigned char* smem_raw, int nk,
                                         int depth_x, int depth_w,
                                         LoadX load_x, LoadW load_w,
                                         float (&acc)[kHalves][32]) {
  using S = Stage<BK>;
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

#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps both rings full
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int sx = t % depth_x, sw = t % depth_w;
        if (t >= depth_x)
          hopper::mbar_wait_or_trap(empty_x + sx, (t / depth_x - 1) & 1);
        hopper::mbar_expect_tx(full_x + sx, S::kX);
        load_x(xs + sx * S::kX, full_x + sx, t);
        if (t >= depth_w)
          hopper::mbar_wait_or_trap(empty_w + sw, (t / depth_w - 1) & 1);
        hopper::mbar_expect_tx(full_w + sw, S::kW);
        unsigned char* wst = ws + sw * S::kW;
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          load_w(wst + h * S::kWBox, full_w + sw, t, h);
      }
    }
    return;
  }
  // consumers: warpgroup g owns rows 64 g .. 64 g + 63, all 256 columns;
  // they pop a stage from each ring, run its products, wait for them and
  // release both stages.  No branch sits between the products (a branch
  // there makes the compiler serialise them).
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

}  // namespace wide
