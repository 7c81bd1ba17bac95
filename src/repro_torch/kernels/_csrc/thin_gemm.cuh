// The thin bf16 GEMM (M <= 16 rows, decode over the slots), shared by
// queue_matmul.cu (one matrix, bf16 out) and moe_gemm.cu (one matrix per
// expert, fp32 out).
//
// Bound by the bytes of w (3.35 TB/s), so w has to stream from every SM
// at once:
//  * 64-column tiles, 128 deep, copied with 16-byte cp.async by all 128
//    threads (no tensor map, so nothing is encoded per call), one mbarrier
//    a stage, each thread's cp.async.mbarrier.arrive completing the phase;
//  * K is split into `split` parts, one block each, `split` a function of
//    the shapes alone (each wrapper's split_k).  The parts of a column tile
//    form one thread-block cluster: each block sums its four warps'
//    partials in warp order, then the cluster sums its blocks' partials
//    through distributed shared memory in rank order;
//  * each warp multiplies its own k16 slices of every stage (mma.sync
//    m16n8k16; w through ldmatrix.trans from XOR-swizzled rows).
// No atomics, and every output element gets the same sequence of
// operations whatever the depths, M or its row: depths give the same bits
// and a row never depends on the other rows of its block.

#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile_ring.cuh"

namespace thin {

using bf16 = __nv_bfloat16;
using tile_ring::cp_async16;
using tile_ring::cp_async_arrive;
using tile_ring::mbar_init;
using tile_ring::mbar_init_fence;
using tile_ring::tiles_offset;

constexpr int kBM = 16, kBN = 64, kBK = 128;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kXTile = kBM * kBK, kWTile = kBK * kBN;  // elements

// The fp32 partials (each warp's, then the block's) reuse the rings once
// the last stage is consumed; the rings at depth (1, 1) are as large.
constexpr size_t kPartBytes = 4 * static_cast<size_t>(kWarps + 1) * kBM * kBN;

inline size_t smem_bytes(int depth_x, int depth_w) {
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

// One block's work: part `rank` of `split` of the K sum for columns
// [n0, n0 + 64) of out (M, N) = x (M, K) @ w (K, N), all row-major.  The
// block needs smem_bytes(depth_x, depth_w) of dynamic shared memory at
// `smem`; with split > 1 it must be launched in a cluster of `split`
// blocks along x, rank = its place there.
template <typename O>
__device__ __forceinline__ void gemm(const bf16* __restrict__ x,
                                     const bf16* __restrict__ w,
                                     O* __restrict__ out, int M, int N, int K,
                                     int depth_x, int depth_w, int split,
                                     int rank, int n0, unsigned char* smem) {
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = bar_x + depth_x;
  bf16* xs = reinterpret_cast<bf16*>(smem + tiles_offset(depth_x + depth_w));
  bf16* ws = xs + static_cast<size_t>(depth_x) * kXTile;
  // after the last stage: [kWarps][16][kBN], then the block's [16][kBN]
  float* warp_part = reinterpret_cast<float*>(xs);
  float* part = warp_part + kWarps * kBM * kBN;

  const int nk_all = (K + kBK - 1) / kBK;
  const int per = (nk_all + split - 1) / split;
  const int t0 = rank * per;
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
        tile_ring::put(out + static_cast<size_t>(r) * N + c, part[i]);
    }
    return;
  }
  // the cluster's sum: the parts added in rank order, each rank storing a
  // share of the tile
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (kBM * kBN + split - 1) / split;
  for (int i = rank * share + threadIdx.x;
       i < min(kBM * kBN, (rank + 1) * share); i += kThreads) {
    const int r = i / kBN, c = n0 + i % kBN;
    if (r >= M || c >= N) continue;
    float v = *cluster.map_shared_rank(part + i, 0);
    for (int q = 1; q < split; ++q) v += *cluster.map_shared_rank(part + i, q);
    tile_ring::put(out + static_cast<size_t>(r) * N + c, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace thin
