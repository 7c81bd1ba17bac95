// The thin bf16 GEMM (decode over the slots, 16 rows a tile), shared by
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
//  * a block takes G 16-row tiles of x (G = 1 for M <= 16; both kernels
//    take up to 4 for the rows of a chunk, row groups of 16 G rows in grid
//    z): each w stage it loads serves all G tiles, and each tile has its
//    own accumulators and partials.
// No atomics, and every output element gets the same sequence of
// operations whatever the depths, M, G or its row: depths give the same
// bits and a row never depends on the other rows of its launch.

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
constexpr int kMaxTiles = 4;                  // 16-row tiles a block
constexpr int kXTile = kBM * kBK, kWTile = kBK * kBN;  // elements

// The fp32 partials (each warp's of one tile at a time, then the block's
// of every tile) reuse the rings once the last stage is consumed; at
// depth (1, 1) and one tile the rings are as large.
inline size_t part_bytes(int tiles) {
  return 4 * static_cast<size_t>(kWarps + tiles) * kBM * kBN;
}

inline size_t smem_bytes(int depth_x, int depth_w, int tiles = 1) {
  const size_t rings =
      2 * (static_cast<size_t>(depth_x) * tiles * kXTile +
           static_cast<size_t>(depth_w) * kWTile);
  const size_t parts = part_bytes(tiles);
  return tiles_offset(depth_x + depth_w) + (rings > parts ? rings : parts);
}

// The 16-row tiles a block takes for M rows: every tile of M in one block
// up to kMaxTiles (a power of two), fewer where the rings at these depths
// would not fit; 0 when not even one tile's rings fit.  The bits do not
// depend on it.
inline int tiles(int M, int depth_x, int depth_w) {
  const size_t most = static_cast<size_t>(tile_ring::kMaxSmem);
  const int need = (M + kBM - 1) / kBM;
  int g = 1;
  while (g < need && g < kMaxTiles) g *= 2;
  while (g > 1 && smem_bytes(depth_x, depth_w, g) > most) g /= 2;
  return smem_bytes(depth_x, depth_w, g) <= most ? g : 0;
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

// Rows past M and the K or N edge arrive as zeros.  G tiles of rows
// [m0, m0 + 16 G), one after the other in the stage.
template <int G>
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ x,
                                       int M, int K, int k0, int m0) {
  for (int i = threadIdx.x; i < G * kBM * (kBK / 8); i += kThreads) {
    const int g = i / (kBM * (kBK / 8)), j = i % (kBM * (kBK / 8));
    const int r = j / (kBK / 8), c = j % (kBK / 8);
    const int gr = m0 + kBM * g + r, gc = k0 + 8 * c;
    const bool in = gr < M && gc < K;
    cp_async16(xs + g * kXTile + 8 * x_at(r, c),
               in ? x + static_cast<size_t>(gr) * K + gc : x,
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
// [n0, n0 + 64) and rows [m0, m0 + 16 G) of out (M, N) = x (M, K) @
// w (K, N), all row-major.  The block needs smem_bytes(depth_x, depth_w, G)
// of dynamic shared memory at `smem`; with split > 1 it must be launched
// in a cluster of `split` blocks along x, rank = its place there.
template <int G, typename O>
__device__ __forceinline__ void gemm(const bf16* __restrict__ x,
                                     const bf16* __restrict__ w,
                                     O* __restrict__ out, int M, int N, int K,
                                     int depth_x, int depth_w, int split,
                                     int rank, int n0, int m0,
                                     unsigned char* smem) {
  constexpr int kTile = kBM * kBN;  // outputs of one row tile
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = bar_x + depth_x;
  bf16* xs = reinterpret_cast<bf16*>(smem + tiles_offset(depth_x + depth_w));
  bf16* ws = xs + static_cast<size_t>(depth_x) * G * kXTile;
  // after the last stage: [kWarps][16][kBN] for one tile at a time, then
  // the block's [G][16][kBN]
  float* warp_part = reinterpret_cast<float*>(xs);
  float* part = warp_part + kWarps * kTile;

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
    load_x<G>(xs + t * G * kXTile, x, M, K, (t0 + t) * kBK, m0);
    cp_async_arrive(bar_x + t);
  }
  for (int t = 0; t < depth_w && t < nk; ++t) {
    load_w(ws + t * kWTile, w, N, K, (t0 + t) * kBK, n0);
    cp_async_arrive(bar_w + t);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[G][kBN / 8][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int sx = t % depth_x, sw = t % depth_w;
    hopper::mbar_wait_or_trap(bar_x + sx, (t / depth_x) & 1);
    hopper::mbar_wait_or_trap(bar_w + sw, (t / depth_w) & 1);
    const bf16* xt = xs + sx * G * kXTile;
    const bf16* wt = ws + sw * kWTile;
    // warp w takes the k16 slices w and w + 4 of the 128-deep stage
#pragma unroll
    for (int q = 0; q < kBK / 16 / kWarps; ++q) {
      const int ks = warp + kWarps * q;
      uint32_t a[G][4];
      {
        const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = 2 * ks + (lane >> 4);
#pragma unroll
        for (int g = 0; g < G; ++g)
          hopper::ldmatrix_x4(a[g], xt + g * kXTile + 8 * x_at(r, c));
      }
#pragma unroll
      for (int jj = 0; jj < kBN / 16; ++jj) {
        uint32_t b[4];
        const int r = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = 2 * jj + (lane >> 4);
        hopper::ldmatrix_x4_trans(b, wt + 8 * w_at(r, c));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          hopper::mma_16816(acc[g][2 * jj], a[g], b[0], b[1]);
          hopper::mma_16816(acc[g][2 * jj + 1], a[g], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with both stages
    if (t + depth_x < nk) {
      load_x<G>(xs + sx * G * kXTile, x, M, K, (t0 + t + depth_x) * kBK, m0);
      cp_async_arrive(bar_x + sx);
    }
    if (t + depth_w < nk) {
      load_w(ws + sw * kWTile, w, N, K, (t0 + t + depth_w) * kBK, n0);
      cp_async_arrive(bar_w + sw);
    }
  }

  // the block's partial of each tile: its warps' sums added in warp order,
  // in the rings' memory (every copy has landed and every stage is
  // consumed)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    __syncthreads();  // the rings, or the last tile's warp partials, are free
    {
      float* mine = warp_part + warp * kTile;
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(gq + 8 * (e >> 1)) * kBN + 8 * j + 2 * tq + (e & 1)] =
              acc[g][j][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      float v = warp_part[i];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) v += warp_part[q * kTile + i];
      part[g * kTile + i] = v;
    }
  }

  if (split == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < G * kTile; i += kThreads) {
      const int r = m0 + i / kBN, c = n0 + i % kBN;
      if (r < M && c < N)
        tile_ring::put(out + static_cast<size_t>(r) * N + c, part[i]);
    }
    return;
  }
  // the cluster's sum: the parts added in rank order, each rank storing a
  // share of the tiles
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (G * kTile + split - 1) / split;
  for (int i = rank * share + threadIdx.x;
       i < min(G * kTile, (rank + 1) * share); i += kThreads) {
    const int r = m0 + i / kBN, c = n0 + i % kBN;
    if (r >= M || c >= N) continue;
    float v = *cluster.map_shared_rank(part + i, 0);
    for (int q = 1; q < split; ++q) v += *cluster.map_shared_rank(part + i, q);
    tile_ring::put(out + static_cast<size_t>(r) * N + c, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace thin
