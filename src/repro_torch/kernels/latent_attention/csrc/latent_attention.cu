// latent_attention: MLA's absorbed decode attention, each query row against
// the first `rows` rows of its slot's latent and rope caches and then its
// column's own new row: the attention of the serve path's decode and chunk
// bodies for an MLA model (minicpm3).
//
// Replaces no Pallas kernel: the JAX package computes the absorbed
// attention in jnp (src/repro/models/attention.py:306, mla_decode) and XLA
// fuses it.  The port adds it because its plain version's products and
// softmax are PyTorch kernels whose launch shape, and so whose sum order,
// follows the number of query rows: a chunk's batched body attends C x B
// columns where token prefill attends B, so it needs an attention whose row
// bits do not depend on the rows around it.
//
// Layout: q_eff (R, H, r) and q_rope (R, H, dr) with R = rows of (column,
// slot), row c * B + b; the caches latent (B, T, r) and rope (B, T, dr);
// rows (R,) int32: row i reads cache positions [0, rows[i]) (clamped to
// [0, T]); self_lat (R, r) and self_rope (R, dr): the column's own new row,
// attended after the cache rows; out (R, H, r).
//
// MLA decode is multi-query attention over one shared latent "head": K =
// [latent | rope] (288 wide at minicpm3), V = latent (256), read by all
// H x C query rows of a slot.  So the work of a slot is two small GEMMs,
// S = [q_eff | q_rope] [latent | rope]^T and P latent, over a tile of cache
// rows that every query row shares; at a long cache it is bound by the
// bytes of that tile, at a short one by latency.  A row's decomposition is
// a constant of the kernel and of (r, dr, dtype) alone
// (kernels/latent_attention/plan.py mirrors it):
//  * a row's positions fall in spans of kSpan = 64, and spans in groups of
//    kGroup = 256 positions; a row of one group writes its output from
//    group 0's block, a longer row's group partials go to a workspace and
//    the merge kernel folds them in group order (the max first), then the
//    column's own new row (the self row);
//  * every score and sum of a row is a function of the row, its cache rows
//    and these constants: which block, warp or 16-row tile runs the row,
//    and which rows run beside it, never changes its operations, so its
//    bits do not depend on B, C, H, T or the grid.
//
// bf16 (latent_attention_tc), on the tensor cores.  An mma.sync output
// element depends only on its own row of A, its own column of B and its own
// accumulator, so a row's bits follow the tile only if the k order, the cut
// of its positions or the fold order change with the row count; here all
// three are fixed by the constants above and (r, dr):
//  * a block takes one 256-position group of a tile of up to kMaxTiles x 16
//    of a slot's H x C query rows (in (column, head) order), and
//    kWarpsATile = 4 warps a 16-row sub-tile (the last sub-tile zero-padded:
//    40 heads at C = 1 are three); warp w of a sub-tile takes chunk w
//    (positions [16 w, 16 w + 16)) of each of the group's spans, in span
//    order, so all four warps work at a short cache, where every row's walk
//    ends inside span 0 (a warp a span would leave three of four idle
//    there); a block of one sub-tile has four more warps, which copy and
//    fold (eight warps' registers fit an SM, and its copies are the block's
//    longest phase);
//  * the rows' [q_eff | q_rope] and each span's [latent | rope] rows are
//    copied once a block into shared memory with cp.async (16 bytes; the
//    rope in 4-byte words where dr is not a whole number of 16-byte
//    vectors), one mbarrier a span, so a warp starts on a span as soon as it
//    has landed; only up to the block's longest walk, in chunks; rows padded
//    by 16 bytes, so the 8 rows an ldmatrix reads fall on 8 bank groups (a
//    512-byte latent row would put them on one); r and dr zero-padded to
//    powers of two of at least 16 (whole k-steps, and a power-of-two count
//    of copies a row, so a thread's copies need no division);
//  * S = [q_eff | q_rope] . [latent | rope]^T over the chunk's 16 positions
//    in 16-wide k-steps in order (latent, then rope), ldmatrix and
//    mma_16816 (bf16 in, fp32 sums); the scores in the log2 domain, masked
//    past the row's walk; an online softmax over the warp's chunks in span
//    order, the max and sum over the row's four lanes (lane-local in
//    position order, then xor 1, xor 2), P = exp2(S - max) rounded to bf16
//    (the sum taken over the rounded weights), packed into an A fragment in
//    registers (FlashAttention-2's layout), and O = O corr + P . latent into
//    a 16 x 256 fp32 accumulator a warp (128 registers a lane);
//  * the warps' partials (max, sum, weighted latent) meet in shared memory
//    over the dead tiles and are folded in warp order, the max first, as
//    decode_attention folds its warps; group 0 then folds the self row,
//    scored on CUDA cores in fp32 in Query::score's arithmetic while the
//    spans are in flight;
//  * mma.sync, not wgmma: a slot's 40 rows fill 16-row tiles, where a
//    wgmma's 64-row tile would be mostly padding at decode.  Two sub-tiles
//    at most: four warps a sub-tile at up to 255 registers a lane (the
//    accumulator alone is 128) keep a block at 8 warps, and its partials,
//    16 KB a warp, within the tiles' shared memory.  One block an SM (the
//    group's tiles are 151 KB at minicpm3), so a block takes two sub-tiles
//    only where that still leaves 132 blocks or more.
// fp32 (latent_attention_split<float>), on CUDA cores: the 2e-4 tolerance
// rules out TF32, and fp32 runs only on the parity path, so it keeps its
// first design and its bits: one warp a query row walking its spans, a
// score split over kLanesAPosition lanes (lane j sums the latent's 16-byte
// vectors j, j + 8, ... and the rope's elements j, j + 8, ... in order, then
// a butterfly adds each sum over the lanes), the spans folded into the row's
// online softmax in span order, a two-stage cp.async ring of spans.
//
// Both paths size the grid from T, never from `rows`: a block whose group
// lies past its rows' walks exits at once (one node of a CUDA graph, no
// host read).
//
// C interface: latent_attention_launch(...) returns a cudaError_t.  dtype
// 0 = float32, 1 = bfloat16 for every operand and out.  r <= 256 in whole
// 16-byte vectors, dr <= 64 in whole 4-byte words; the operands 16-byte
// aligned.  rows_a_block is the fp32 path's rows a block (a warp each,
// plan.rows_a_block), passed whatever the dtype, so a build that took it
// for bf16 too is launched as it launched itself; the bf16 path sizes its
// tiles from B, H x C and T (tiles_of).  `work` holds R * H * ceil(T / 256) * (r + 2) floats when
// T > 256 (else unused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

using tile_ring::cp_async16;
using tile_ring::cp_async4;
using bf16 = __nv_bfloat16;

// The decomposition and the launch's limits (plan.py mirrors these).
constexpr int kSpan = 64;
constexpr int kGroup = 256;
constexpr int kLanesAPosition = 8;
constexpr int kPositionsAPass = 32 / kLanesAPosition;
constexpr int kPasses = kSpan / kPositionsAPass;
constexpr int kSpansAGroup = kGroup / kSpan;
constexpr int kMaxRows = 8;                  // fp32: rows a block, a warp each
constexpr int kStages = 2;
constexpr int kCopyBytes = 16;
constexpr int kRopeCopyBytes = 4;
constexpr int kMaxR = 256;
constexpr int kMaxRope = 64;
constexpr int kMergeRows = 4;                // rows a merge block
constexpr int kAcc = kMaxR / 32;             // accumulator floats a lane
constexpr float kLog2e = 1.4426950408889634f;
// bf16: the tensor-core path
constexpr int kTile = 16;                    // query rows a sub-tile
constexpr int kMaxTiles = 2;                 // sub-tiles a block
constexpr int kChunk = 16;                   // positions a warp takes of a span
constexpr int kWarpsATile = kSpan / kChunk;  // warps a sub-tile, a chunk each
constexpr int kMinBlocks = 132;              // fewer: a block takes one tile
constexpr int kPad = 8;                      // elements padding a shared row
constexpr int kPartPad = 8;                  // floats padding a partial's row
constexpr int kBarBytes = 128;               // the barriers' room
constexpr int kMaxK16 = (kMaxR + kMaxRope) / 16;  // k-steps of a score
constexpr int kMaxN8 = kMaxR / 8;            // 8-column tiles of the output
constexpr int kMinicpm3K16 = 18;             // minicpm3's k-steps: 256 + 32

// plan.smem_bytes (fp32): the ring's latent and rope tiles.
size_t smem_bytes(int r, int dr, int esize) {
  return static_cast<size_t>(kStages) * kSpan * (r + dr) * esize;
}

// plan.padded: r or dr padded to a power of two of at least 16 elements
// (whole k-steps, and a power-of-two count of copies a shared row).
__host__ __device__ constexpr int padded(int n) {
  int p = 16;
  while (p < n) p *= 2;
  return p;
}

// plan.smem_bytes (bf16): the barriers, then the rows' queries and the
// group's spans as padded bf16 rows, or, once the products are done, the
// (sub-tile, warp) partials (fp32 weighted latent, max and sum) over them.
size_t smem_bytes_tc(int r, int dr, int tiles) {
  const size_t ld = padded(r) + padded(dr) + kPad;
  const size_t rows = static_cast<size_t>(kTile) * tiles;
  const size_t tiles_b = (rows + kGroup) * ld * sizeof(bf16);
  const size_t parts_b = static_cast<size_t>(tiles) * kWarpsATile * kTile *
                         (padded(r) + kPartPad + 2) * sizeof(float);
  return kBarBytes + (tiles_b > parts_b ? tiles_b : parts_b);
}

// plan.tiles_a_block: sub-tiles a block, up to kMaxTiles, halved while the
// launch would have fewer than kMinBlocks blocks.
int tiles_of(int rows, int B, int n_groups) {
  int tiles = kMaxTiles;
  while (tiles > 1 && (static_cast<long long>(rows + kTile * tiles - 1) /
                           (kTile * tiles) * B * n_groups < kMinBlocks ||
                       rows <= kTile * (tiles / 2)))
    tiles /= 2;
  return tiles;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The elements of a 16-byte vector, exactly, as fp32.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One query row's elements a lane holds, as fp32: of the latent part the
// 16-byte vectors j, j + 8, ..., of the rope part the elements j, j + 8,
// ... (j the lane's place among the kLanesAPosition lanes of a score).
template <typename T>
struct Query {
  static constexpr int kVec = kCopyBytes / sizeof(T);
  static constexpr int kLatVecs = kMaxR / kVec / kLanesAPosition;
  static constexpr int kRopeEls = kMaxRope / kLanesAPosition;
  float lat[kLatVecs * kVec];
  float rope[kRopeEls];

  __device__ __forceinline__ void load(const T* q_lat, const T* q_rope,
                                       int r, int dr, int j8) {
    const int nvec = r / kVec;
#pragma unroll
    for (int u = 0; u < kLatVecs; ++u) {
      const int vv = j8 + u * kLanesAPosition;
      if (vv < nvec) {
        unpack(*reinterpret_cast<const uint4*>(q_lat + vv * kVec),
               lat + u * kVec, T());
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) lat[u * kVec + e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRopeEls; ++u) {
      const int e = j8 + u * kLanesAPosition;
      rope[u] = e < dr ? to_float(q_rope[e]) : 0.f;
    }
  }

  // The score of one key row (its latent and rope elements), in the log2
  // domain: every lane of the warp calls it (the butterflies), each group
  // of kLanesAPosition lanes on its own row, and gets its group's score.
  __device__ __forceinline__ float score(const T* k_lat, const T* k_rope,
                                         int r, int dr, int j8,
                                         float scale_log2) const {
    const int nvec = r / kVec;
    float dl = 0.f;
#pragma unroll
    for (int u = 0; u < kLatVecs; ++u) {
      const int vv = j8 + u * kLanesAPosition;
      if (vv < nvec) {
        float f[kVec];
        unpack(*reinterpret_cast<const uint4*>(k_lat + vv * kVec), f, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) dl = fmaf(lat[u * kVec + e], f[e], dl);
      }
    }
    float dp = 0.f;
#pragma unroll
    for (int u = 0; u < kRopeEls; ++u) {
      const int e = j8 + u * kLanesAPosition;
      if (e < dr) dp = fmaf(rope[u], to_float(k_rope[e]), dp);
    }
#pragma unroll
    for (int o = 1; o < kLanesAPosition; o <<= 1) {
      dl += __shfl_xor_sync(0xffffffffu, dl, o);
      dp += __shfl_xor_sync(0xffffffffu, dp, o);
    }
    return (dl + dp) * scale_log2;
  }
};

// grid: (row_blocks * B, n_groups), 32 * rows threads.  Block x serves
// rows [rb * rows, rb * rows + rows) of slot b's H * C rows (row qi:
// column qi / H, head qi % H), warp w row rb * rows + w, over group y.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRows)
    latent_attention_split(const T* __restrict__ q_eff,
                           const T* __restrict__ q_rope,
                           const T* __restrict__ lat,
                           const T* __restrict__ rope,
                           const int* __restrict__ rows,
                           const T* __restrict__ self_lat,
                           const T* __restrict__ self_rope,
                           T* __restrict__ out, float* __restrict__ work,
                           int B, int C, int H, int T_len, int r, int dr,
                           int rows_a_block, int row_blocks, int n_groups,
                           float scale_log2) {
  constexpr int kVec = kCopyBytes / sizeof(T);
  constexpr int kRopeVec = kRopeCopyBytes / sizeof(T);
  constexpr int kAccVecs = kAcc / kVec;  // a lane's latent vectors
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int walk_s[kMaxRows];

  const int rb = blockIdx.x % row_blocks, b = blockIdx.x / row_blocks;
  const int nrows = min(rows_a_block, H * C - rb * rows_a_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j8 = lane % kLanesAPosition, grp = lane / kLanesAPosition;
  const bool has_row = warp < nrows;
  const int qi = rb * rows_a_block + warp;
  const int rr = (qi / H) * B + b;  // the (column, slot) row
  const size_t rh = static_cast<size_t>(rr) * H + qi % H;
  if (has_row && lane == 0) walk_s[warp] = min(max(rows[rr], 0), T_len);
  __syncthreads();
  int longest = 0;
  for (int i = 0; i < nrows; ++i) longest = max(longest, walk_s[i]);
  const int wk = has_row ? walk_s[warp] : 0;
  const int s0 = blockIdx.y * kSpansAGroup;
  const int s_end = min(s0 + kSpansAGroup, (longest + kSpan - 1) / kSpan);
  // every row's walk ends before this group (group 0 still folds the self
  // rows)
  if (blockIdx.y != 0 && s0 >= s_end) return;

  Query<T> q;
  if (has_row) q.load(q_eff + rh * r, q_rope + rh * dr, r, dr, j8);

  const int stage = kSpan * (r + dr);  // elements of one stage
  T* ring = reinterpret_cast<T*>(smem);
  const T* lat_b = lat + static_cast<size_t>(b) * T_len * r;
  const T* rope_b = rope + static_cast<size_t>(b) * T_len * dr;
  // Span s's latent and rope rows below T, zeros past T; one commit group.
  auto copy_span = [&](int st, int s) {
    const int p0 = s * kSpan;
    const int have = min(kSpan, T_len - p0);
    T* ls = ring + st * stage;
    T* rs = ls + kSpan * r;
    const int lv = r / kVec, rw = dr / kRopeVec;
    const T* lg = lat_b + static_cast<size_t>(p0) * r;
    const T* rg = rope_b + static_cast<size_t>(p0) * dr;
    for (int i = threadIdx.x; i < kSpan * lv; i += blockDim.x) {
      const bool in = i < have * lv;
      cp_async16(ls + i * kVec, in ? lg + i * kVec : lat, in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kSpan * rw; i += blockDim.x) {
      const bool in = i < have * rw;
      cp_async4(rs + i * kRopeVec, in ? rg + i * kRopeVec : rope,
                in ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int nv = r / kVec;
  float M = -INFINITY, L = 0.f, acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if (s0 < s_end) copy_span(0, s0);
  for (int s = s0, j = 0; s < s_end; ++s, ++j) {
    if (s + 1 < s_end)
      copy_span((j + 1) % kStages, s + 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // span s's tiles have landed, for every thread
    const T* ls = ring + (j % kStages) * stage;
    const T* rs = ls + kSpan * r;
    if (has_row && s * kSpan < wk) {  // uniform in the warp
      const int nt = min(kSpan, wk - s * kSpan);  // the row's positions
      float p[kPasses];
      float mx = -INFINITY;
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        const int pos = pass * kPositionsAPass + grp;
        const float sv = q.score(ls + pos * r, rs + pos * dr, r, dr, j8,
                                 scale_log2);
        p[pass] = pos < nt ? sv : -INFINITY;  // past the walk: no weight
        mx = fmaxf(mx, p[pass]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m = fmaxf(M, mx);
      const float corr = exp2f(M - m);  // 0 before the first span
      float l = 0.f;
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        p[pass] = exp2f(p[pass] - m);
        l += p[pass];
      }
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      L = fmaf(L, corr, l);
      M = m;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= corr;
      // the span's weighted latent, positions in order: lane's vectors
      // lane, lane + 32, ...
#pragma unroll
      for (int t = 0; t < kSpan; ++t) {
        const float pt =
            __shfl_sync(0xffffffffu, p[t / kPositionsAPass],
                        (t % kPositionsAPass) * kLanesAPosition);
        if (t < nt) {
          const T* vr = ls + t * r;
#pragma unroll
          for (int u = 0; u < kAccVecs; ++u) {
            const int vv = lane + 32 * u;
            if (vv < nv) {
              float f[kVec];
              unpack(*reinterpret_cast<const uint4*>(vr + vv * kVec), f, T());
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[u * kVec + e] = fmaf(pt, f[e], acc[u * kVec + e]);
            }
          }
        }
      }
    }
    __syncthreads();  // span s consumed before its stage is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!has_row) return;

  if (wk <= kGroup) {
    // A row of one group: group 0's block folds its self row and writes.
    if (blockIdx.y != 0) return;
    const float ss = q.score(self_lat + static_cast<size_t>(rr) * r,
                             self_rope + static_cast<size_t>(rr) * dr, r, dr,
                             j8, scale_log2);
    const float m = fmaxf(M, ss);
    const float corr = exp2f(M - m), ps = exp2f(ss - m);
    const float inv = 1.f / fmaf(L, corr, ps);
#pragma unroll
    for (int u = 0; u < kAccVecs; ++u) {
      const int vv = lane + 32 * u;
      if (vv < nv) {
        float f[kVec];
        unpack(*reinterpret_cast<const uint4*>(
                   self_lat + static_cast<size_t>(rr) * r + vv * kVec),
               f, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          store(out + rh * r + vv * kVec + e,
                fmaf(ps, f[e], acc[u * kVec + e] * corr) * inv);
      }
    }
    return;
  }
  // A longer row: this group's partial, where the row reaches the group.
  if (s0 * kSpan >= wk) return;
  float* wp = work + (rh * n_groups + blockIdx.y) * (r + 2);
  if (lane == 0) {
    wp[0] = M;
    wp[1] = L;
  }
#pragma unroll
  for (int u = 0; u < kAccVecs; ++u) {
    const int vv = lane + 32 * u;
    if (vv < nv) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        wp[2 + vv * kVec + e] = acc[u * kVec + e];
    }
  }
}

// One warp a query row (rh = i * H + h) whose walk crosses groups: its
// groups' partials folded in group order (the max first, the self row's
// score in it), then its self row, the output written.
template <typename T>
__global__ void __launch_bounds__(32 * kMergeRows)
    latent_attention_merge(const T* __restrict__ q_eff,
                           const T* __restrict__ q_rope,
                           const int* __restrict__ rows,
                           const T* __restrict__ self_lat,
                           const T* __restrict__ self_rope,
                           const float* __restrict__ work,
                           T* __restrict__ out, int n_rows, int H, int T_len,
                           int r, int dr, int n_groups, float scale_log2) {
  constexpr int kVec = kCopyBytes / sizeof(T);
  constexpr int kAccVecs = kAcc / kVec;
  const int row = blockIdx.x * kMergeRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32, j8 = lane % kLanesAPosition;
  if (row >= n_rows) return;
  const size_t rh = row;
  const int rr = row / H;
  const int wk = min(max(rows[rr], 0), T_len);
  if (wk <= kGroup) return;  // written by the split kernel
  const int ng = (wk + kGroup - 1) / kGroup;
  Query<T> q;
  q.load(q_eff + rh * r, q_rope + rh * dr, r, dr, j8);
  const float ss = q.score(self_lat + static_cast<size_t>(rr) * r,
                           self_rope + static_cast<size_t>(rr) * dr, r, dr,
                           j8, scale_log2);
  const float* wp = work + rh * n_groups * (r + 2);
  float m = ss;
  for (int g = 0; g < ng; ++g) m = fmaxf(m, wp[g * (r + 2)]);
  const int nv = r / kVec;
  float l = 0.f, acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int g = 0; g < ng; ++g) {
    const float* ps = wp + g * (r + 2);
    const float f = exp2f(ps[0] - m);
    l = fmaf(ps[1], f, l);
#pragma unroll
    for (int u = 0; u < kAccVecs; ++u) {
      const int vv = lane + 32 * u;
      if (vv < nv) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[u * kVec + e] = fmaf(ps[2 + vv * kVec + e], f, acc[u * kVec + e]);
      }
    }
  }
  const float p_self = exp2f(ss - m);
  const float inv = 1.f / (l + p_self);
#pragma unroll
  for (int u = 0; u < kAccVecs; ++u) {
    const int vv = lane + 32 * u;
    if (vv < nv) {
      float f[kVec];
      unpack(*reinterpret_cast<const uint4*>(
                 self_lat + static_cast<size_t>(rr) * r + vv * kVec),
             f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        store(out + rh * r + vv * kVec + e,
              fmaf(p_self, f[e], acc[u * kVec + e]) * inv);
    }
  }
}

// cp.async copies of kBytes into n shared rows `ld` elements apart, `per`
// (a power of two, at most blockDim.x) a row: copy c of row i from
// src_of(i) + c kBytes where i < have and c < real, else zeros.  Thread t
// takes copy t % per of rows t / per, + blockDim.x / per, ...
template <int kBytes, typename SrcOf>
__device__ __forceinline__ void copy_cols(bf16* dst, int ld, int n, int have,
                                          int per, int real, SrcOf src_of,
                                          const bf16* any) {
  constexpr int kEls = kBytes / sizeof(bf16);
  const int shift = __ffs(per) - 1, c = threadIdx.x & (per - 1);
  const int drow = blockDim.x >> shift;
  const bool col_in = c < real;
#pragma unroll 4
  for (int row = threadIdx.x >> shift; row < n; row += drow) {
    const bool in = col_in && row < have;
    bf16* d = dst + row * ld + c * kEls;
    const bf16* src = in ? src_of(row) + c * kEls : any;
    if (kBytes == 16)
      cp_async16(d, src, in ? 16 : 0);
    else
      cp_async4(d, src, in ? 4 : 0);
  }
}

// Rows [0, n) of shared [latent | rope] rows `ld` elements apart: row i's
// latent from lat_of(i) and rope from rope_of(i) for i < have (the rope in
// 4-byte copies where it is not whole 16-byte vectors), zeros past `have`
// and in the columns past r and dr (the padding).
template <typename LatOf, typename RopeOf>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, int n, int have,
                                          int r, int dr, LatOf lat_of,
                                          RopeOf rope_of, const bf16* any) {
  const int rk = padded(r), dk = padded(dr);
  copy_cols<16>(dst, ld, n, have, rk / 8, r / 8, lat_of, any);
  if (dr % 8 == 0)
    copy_cols<16>(dst + rk, ld, n, have, dk / 8, dr / 8, rope_of, any);
  else
    copy_cols<4>(dst + rk, ld, n, have, dk / 2, dr / 2, rope_of, any);
}

// The max of v over lanes of a warp: over each half-warp (xor 1, 2, 4, 8),
// then over the warp (xor 16).
__device__ __forceinline__ int half_max(int v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid: (row_blocks * B, n_groups), 32 * kWarpsATile * kMaxTiles threads.
// Block x serves rows [rb * 16 tiles, (rb + 1) * 16 tiles) of slot b's
// H * C rows (row qi: column qi / H, head qi % H) over group y; warp
// w < kWarpsATile * tiles takes sub-tile w % tiles and, of each of the
// group's spans in order, its chunk w / tiles (kChunk positions); at one
// tile the other four warps only copy and fold (the registers of a block
// of eight are there: one block an SM).  Shared memory: the barriers (one a span,
// then the rows' queries'), then the rows' queries and the group's spans,
// or the (sub-tile, warp) partials.  kK16: the k-steps of a score where
// the build knows them (minicpm3's 18), else 0.
template <int kK16>
__global__ void __launch_bounds__(32 * kWarpsATile * kMaxTiles, 1)
    latent_attention_tc(const bf16* __restrict__ q_eff,
                        const bf16* __restrict__ q_rope,
                        const bf16* __restrict__ lat,
                        const bf16* __restrict__ rope,
                        const int* __restrict__ rows,
                        const bf16* __restrict__ self_lat,
                        const bf16* __restrict__ self_rope,
                        bf16* __restrict__ out, float* __restrict__ work,
                        int B, int C, int H, int T_len, int r, int dr,
                        int tiles, int row_blocks, int n_groups,
                        float scale_log2) {
  constexpr int kMaxRowsTc = kTile * kMaxTiles;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int walk_s[kMaxRowsTc];
  __shared__ size_t rh_s[kMaxRowsTc];
  __shared__ float self_s[kMaxRowsTc];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_q = bar + kSpansAGroup;

  const int rows_blk = kTile * tiles;
  const int rb = blockIdx.x % row_blocks, b = blockIdx.x / row_blocks;
  const int q0 = rb * rows_blk;
  const int nrows = min(rows_blk, H * C - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = warp % tiles, chunk = warp / tiles;
  const bool computes = warp < kWarpsATile * tiles;
  const int rk = padded(r), ld = rk + padded(dr) + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem + kBarBytes);
  bf16* cs = qs + rows_blk * ld;  // span t of the group at cs + t kSpan ld
  // row i of the block: its (column, slot) row and its (row, head) index
  auto rr_of = [&](int i) { return ((q0 + i) / H) * B + b; };
  auto rh_of = [&](int i) {
    return static_cast<size_t>(rr_of(i)) * H + (q0 + i) % H;
  };
  auto copy_queries = [&] {
    copy_rows(
        qs, ld, rows_blk, nrows, r, dr,
        [&](int i) { return q_eff + rh_of(i) * r; },
        [&](int i) { return q_rope + rh_of(i) * dr; }, q_eff);
  };
  // Every warp reads the rows' walks (lane i row i).
  const int wl = lane < nrows ? min(max(rows[rr_of(lane)], 0), T_len) : 0;

  // Group 0's blocks copy the queries while the walks come, and request
  // their self rows, used once the spans are on their way: for the self
  // scores, 8 lanes a row (lane j8 the 16-byte vectors j8, j8 + 8, ... of
  // the latent and the elements j8, j8 + 8, ... of the rope), and for the
  // output, a lane's column pairs of the rows it writes (rows warp,
  // warp + warps, ...; two columns a lane).
  constexpr int kVecs = kMaxR / 8 / kLanesAPosition;
  constexpr int kRopeEls = kMaxRope / kLanesAPosition;
  constexpr int kOwnRows = kTile / kWarpsATile, kPairs = kMaxR / 64;
  const int j8 = lane % kLanesAPosition, grp = lane / kLanesAPosition;
  const int self_i = min(warp * kPositionsAPass + grp, nrows - 1);
  uint4 self_v[kVecs] = {};
  bf16 self_e[kRopeEls] = {};
  uint32_t own[kOwnRows][kPairs] = {};
  if (blockIdx.y == 0) {
    copy_queries();
    const bf16* sl = self_lat + static_cast<size_t>(rr_of(self_i)) * r;
    const bf16* sr = self_rope + static_cast<size_t>(rr_of(self_i)) * dr;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int vv = j8 + u * kLanesAPosition;
      if (vv < r / 8) self_v[u] = *reinterpret_cast<const uint4*>(sl + 8 * vv);
    }
#pragma unroll
    for (int u = 0; u < kRopeEls; ++u) {
      const int e = j8 + u * kLanesAPosition;
      if (e < dr) self_e[u] = sr[e];
    }
#pragma unroll
    for (int m = 0; m < kOwnRows; ++m) {
      const int i = min(warp + m * (blockDim.x / 32), nrows - 1);
      const bf16* orow = self_lat + static_cast<size_t>(rr_of(i)) * r;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int c = 2 * lane + 64 * k;
        if (c < r) own[m][k] = *reinterpret_cast<const uint32_t*>(orow + c);
      }
    }
  }

  // The block's longest walk and the sub-tile's, in registers; the walks
  // and (row, head) indices also in shared memory for the output.
  const int half = half_max(wl);
  const int longest = max(half, __shfl_xor_sync(0xffffffffu, half, 16));
  const int tl = __shfl_sync(0xffffffffu, half, kTile * tile);
  if (warp == 0 && lane < rows_blk) {
    walk_s[lane] = wl;
    rh_s[lane] = rh_of(lane);
  }
  if (threadIdx.x == 0) {
    for (int t = 0; t <= kSpansAGroup; ++t)
      tile_ring::mbar_init(bar + t, blockDim.x);
    tile_ring::mbar_init_fence();
  }
  const int s0 = blockIdx.y * kSpansAGroup;
  const int s_end = min(s0 + kSpansAGroup, (longest + kSpan - 1) / kSpan);
  // every row's walk ends before this group (group 0 still folds the self
  // rows)
  if (blockIdx.y != 0 && s0 >= s_end) return;
  __syncthreads();
  if (blockIdx.y != 0) copy_queries();
  tile_ring::cp_async_arrive(bar_q);
  {
    const bf16* lat_b = lat + static_cast<size_t>(b) * T_len * r;
    const bf16* rope_b = rope + static_cast<size_t>(b) * T_len * dr;
    for (int t = 0; s0 + t < s_end; ++t) {
      const int p0 = (s0 + t) * kSpan;
      const int have = min(kSpan, longest - p0);
      copy_rows(
          cs + t * kSpan * ld, ld, (have + kChunk - 1) / kChunk * kChunk,
          have, r, dr,
          [&](int i) { return lat_b + static_cast<size_t>(p0 + i) * r; },
          [&](int i) { return rope_b + static_cast<size_t>(p0 + i) * dr; },
          lat);
      tile_ring::cp_async_arrive(bar + t);  // after the queries: covers them
    }
  }

  // The self rows' scores while the spans are in flight, 8 lanes a row
  // (warp w rows 4 w to 4 w + 3): the query from shared memory, in the
  // arithmetic of Query::score.
  if (blockIdx.y == 0) {
    hopper::mbar_wait_or_trap(bar_q, 0);
    Query<bf16> q;
    q.load(qs + self_i * ld, qs + self_i * ld + rk, r, dr, j8);
    float dl = 0.f;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      if (j8 + u * kLanesAPosition < r / 8) {
        float f[8];
        unpack(self_v[u], f, bf16());
#pragma unroll
        for (int e = 0; e < 8; ++e) dl = fmaf(q.lat[u * 8 + e], f[e], dl);
      }
    }
    float dp = 0.f;
#pragma unroll
    for (int u = 0; u < kRopeEls; ++u)
      if (j8 + u * kLanesAPosition < dr)
        dp = fmaf(q.rope[u], __bfloat162float(self_e[u]), dp);
#pragma unroll
    for (int o = 1; o < kLanesAPosition; o <<= 1) {
      dl += __shfl_xor_sync(0xffffffffu, dl, o);
      dp += __shfl_xor_sync(0xffffffffu, dp, o);
    }
    if (j8 == 0 && warp * kPositionsAPass + grp < nrows)
      self_s[warp * kPositionsAPass + grp] = (dl + dp) * scale_log2;
  }

  // This warp's partial of its sub-tile's 16 rows over its chunk of each
  // span, in span order (an online softmax): lane holds rows g and g + 8,
  // columns 8 j + 2 tq and + 1 of each 8-wide tile j.
  const int g = lane >> 2, tq = lane & 3;
  const int wk[2] = {__shfl_sync(0xffffffffu, wl, kTile * tile + g),
                     __shfl_sync(0xffffffffu, wl, kTile * tile + g + 8)};
  const int k16 = kK16 ? kK16 : (rk + padded(dr)) / 16, n8 = rk / 8;
  const bf16* qt = qs + tile * kTile * ld;
  float o[kMaxN8][4];
#pragma unroll
  for (int j = 0; j < kMaxN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  for (int t = 0; computes && s0 + t < s_end; ++t) {
    const int p0 = (s0 + t) * kSpan + kChunk * chunk;
    if (p0 >= tl) break;  // no row of the sub-tile reaches this chunk
    hopper::mbar_wait_or_trap(bar + t, 0);
    const bf16* ct = cs + (t * kSpan + kChunk * chunk) * ld;
    // S = [q_eff | q_rope] . [latent | rope]^T over the chunk's 16
    // positions, k-steps in order
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < (kK16 ? kK16 : kMaxK16); ++kk) {
      if (kk >= k16) break;
      uint32_t a[4], bk[4];
      hopper::ldmatrix_x4(a, qt + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                 16 * kk + (lane >> 4) * 8);
      hopper::ldmatrix_x4(bk, ct + ((lane & 7) + (lane >> 4) * 8) * ld +
                                  16 * kk + ((lane >> 3) & 1) * 8);
      hopper::mma_16816(sc[0], a, bk[0], bk[1]);
      hopper::mma_16816(sc[1], a, bk[2], bk[3]);
    }
    // the online softmax in the log2 domain, past the row's walk no
    // weight: the new max, the old sums' factor, the weights rounded to
    // bf16 and summed in position order (lane-local, then xor 1, xor 2)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int pos = p0 + 8 * j + 2 * tq + (e & 1);
          const float x = pos < wk[h] ? sc[j][e] * scale_log2 : -INFINITY;
          sc[j][e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m = fmaxf(m_row[h], mx);
      // no position of the row yet: nothing to fold
      corr[h] = m == -INFINITY ? 1.f : exp2f(m_row[h] - m);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = m == -INFINITY ? 0.f : exp2f(sc[j][e] - m);
          sc[j][e] = __bfloat162float(__float2bfloat16(p));
          l += sc[j][e];
        }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[h] = fmaf(l_row[h], corr[h], l);
      m_row[h] = m;
    }
    // O = O corr + P latent, P packed into an A fragment in registers
    const uint32_t a[4] = {hopper::pack_bf16x2(sc[0][0], sc[0][1]),
                           hopper::pack_bf16x2(sc[0][2], sc[0][3]),
                           hopper::pack_bf16x2(sc[1][0], sc[1][1]),
                           hopper::pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dd = 0; dd < kMaxN8 / 2; ++dd) {
      if (2 * dd >= n8) break;
      uint32_t bv[4];
      hopper::ldmatrix_x4_trans(
          bv, ct + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + 16 * dd +
                  (lane >> 4) * 8);
#pragma unroll
      for (int x = 2 * dd; x < 2 * dd + 2; ++x) {
        o[x][0] *= corr[0];
        o[x][1] *= corr[0];
        o[x][2] *= corr[1];
        o[x][3] *= corr[1];
      }
      hopper::mma_16816(o[2 * dd], a, bv[0], bv[1]);
      hopper::mma_16816(o[2 * dd + 1], a, bv[2], bv[3]);
    }
  }

  // The partials meet in shared memory over the queries and spans: every
  // warp is done with them (and every copy has landed).  Partial (tile,
  // chunk): the weighted latent, row-major, rows rk + kPartPad floats apart
  // (so a warp's stores of 8 rows fall on distinct banks; zeros from a warp
  // that saw no position), then the rows' maxima and sums.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int pld = rk + kPartPad, part_floats = kTile * (pld + 2);
  float* part = reinterpret_cast<float*>(qs);
  if (computes) {
    float* my = part + (tile * kWarpsATile + chunk) * part_floats;
#pragma unroll
    for (int j = 0; j < kMaxN8; ++j) {
      if (j >= n8) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(my + (g + 8 * h) * pld + 8 * j + 2 * tq) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
    if (tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        my[kTile * pld + g + 8 * h] = m_row[h];
        my[kTile * pld + kTile + g + 8 * h] = l_row[h];
      }
    }
  }
  __syncthreads();
  // A row a warp (rows warp, warp + warps, ...), two columns a lane: the
  // warps' partials folded in warp order, the max first (a warp that saw no
  // position of the row adds nothing: its factor is 0 and its partial 0);
  // a row of one group then folds its self row and is written from group
  // 0's block, a longer row's partial goes to the workspace where it
  // reaches the group.  The rows' factors first, side by side, then their
  // columns.
  float f[kOwnRows][kWarpsATile], mrow[kOwnRows], lrow[kOwnRows];
  float corr[kOwnRows], ps[kOwnRows], inv[kOwnRows];
#pragma unroll
  for (int mi = 0; mi < kOwnRows; ++mi) {
    const int i = min(warp + mi * (blockDim.x / 32), nrows - 1);
    const float* st =
        part + (i / kTile) * kWarpsATile * part_floats + kTile * pld + i % kTile;
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int t = 0; t < kWarpsATile; ++t)
      if (st[t * part_floats + kTile] != 0.f)
        m = fmaxf(m, st[t * part_floats]);
#pragma unroll
    for (int t = 0; t < kWarpsATile; ++t) {
      const float lt = st[t * part_floats + kTile];
      f[mi][t] = lt != 0.f ? exp2f(st[t * part_floats] - m) : 0.f;
      l = fmaf(lt, f[mi][t], l);
    }
    const float ss = self_s[i], mm = fmaxf(m, ss);
    mrow[mi] = m;
    lrow[mi] = l;
    corr[mi] = exp2f(m - mm);
    ps[mi] = exp2f(ss - mm);
    inv[mi] = 1.f / fmaf(l, corr[mi], ps[mi]);
  }
#pragma unroll
  for (int mi = 0; mi < kOwnRows; ++mi) {
    const int i = warp + mi * (blockDim.x / 32);
    if (i >= nrows) break;
    const int w = walk_s[i];
    if (w <= kGroup ? blockIdx.y != 0 : s0 * kSpan >= w) continue;
    const float* pr =
        part + (i / kTile) * kWarpsATile * part_floats + (i % kTile) * pld;
    const size_t rh = rh_s[i];
    float* wp = work + (rh * n_groups + blockIdx.y) * (r + 2);
    if (w > kGroup && lane == 0) {
      wp[0] = mrow[mi];
      wp[1] = lrow[mi];
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * lane + 64 * k;  // r is even: c + 1 < r too
      if (c >= r) break;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kWarpsATile; ++t) {
        const float2 x =
            *reinterpret_cast<const float2*>(pr + t * part_floats + c);
        acc.x = fmaf(x.x, f[mi][t], acc.x);
        acc.y = fmaf(x.y, f[mi][t], acc.y);
      }
      if (w <= kGroup) {
        const float2 o2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&own[mi][k]));
        *reinterpret_cast<__nv_bfloat162*>(out + rh * r + c) =
            __floats2bfloat162_rn(
                fmaf(ps[mi], o2.x, acc.x * corr[mi]) * inv[mi],
                fmaf(ps[mi], o2.y, acc.y * corr[mi]) * inv[mi]);
      } else {
        *reinterpret_cast<float2*>(wp + 2 + c) = acc;
      }
    }
  }
}

// The merge of a longer row's group partials (both paths).
template <typename T>
cudaError_t launch_merge(const T* qe, const T* qr, const int* rows,
                         const T* sl, const T* sr, const float* work, T* out,
                         int R, int H, int T_len, int r, int dr, int n_groups,
                         float scale_log2, cudaStream_t stream) {
  const int n_rows = R * H;
  latent_attention_merge<T>
      <<<(n_rows + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0,
         stream>>>(qe, qr, rows, sl, sr, work, out, n_rows, H, T_len, r, dr,
                   n_groups, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_fma(const float* q_eff, const float* q_rope,
                       const float* lat, const float* rope, const int* rows,
                       const float* self_lat, const float* self_rope,
                       float* out, float* work, int B, int R, int H,
                       int T_len, int r, int dr, int rows_a_block,
                       float scale, cudaStream_t stream) {
  const int C = R / B;
  const int n_groups = (T_len + kGroup - 1) / kGroup;
  const int row_blocks = (H * C + rows_a_block - 1) / rows_a_block;
  const long long gx = static_cast<long long>(row_blocks) * B;
  if (gx > 0x7fffffffLL || n_groups > 65535 ||
      (n_groups > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r, dr, sizeof(float));
  cudaError_t err = hopper::allow_smem<latent_attention_split<float>>(smem);
  if (err != cudaSuccess) return err;
  latent_attention_split<float>
      <<<dim3(static_cast<unsigned>(gx), n_groups), 32 * rows_a_block, smem,
         stream>>>(q_eff, q_rope, lat, rope, rows, self_lat, self_rope, out,
                   work, B, C, H, T_len, r, dr, rows_a_block, row_blocks,
                   n_groups, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return err;
  return launch_merge(q_eff, q_rope, rows, self_lat, self_rope, work, out, R,
                      H, T_len, r, dr, n_groups, scale * kLog2e, stream);
}

cudaError_t launch_tc(const bf16* q_eff, const bf16* q_rope, const bf16* lat,
                      const bf16* rope, const int* rows, const bf16* self_lat,
                      const bf16* self_rope, bf16* out, float* work, int B,
                      int R, int H, int T_len, int r, int dr, float scale,
                      cudaStream_t stream) {
  const int C = R / B;
  const int n_groups = (T_len + kGroup - 1) / kGroup;
  const int tiles = tiles_of(H * C, B, n_groups);
  const int row_blocks = (H * C + kTile * tiles - 1) / (kTile * tiles);
  const long long gx = static_cast<long long>(row_blocks) * B;
  if (gx > 0x7fffffffLL || n_groups > 65535 ||
      (n_groups > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_tc(r, dr, tiles);
  // minicpm3's [latent | rope] (256 + 32: 18 k-steps) with its loop counts
  // known to the compiler
  const bool k18 = (padded(r) + padded(dr)) / 16 == kMinicpm3K16;
  auto kernel = k18 ? latent_attention_tc<kMinicpm3K16> : latent_attention_tc<0>;
  cudaError_t err = k18
                        ? hopper::allow_smem<latent_attention_tc<kMinicpm3K16>>(smem)
                        : hopper::allow_smem<latent_attention_tc<0>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(gx), n_groups),
           32 * kWarpsATile * kMaxTiles, smem, stream>>>(q_eff, q_rope, lat, rope, rows, self_lat, self_rope,
                           out, work, B, C, H, T_len, r, dr, tiles, row_blocks,
                           n_groups, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return err;
  return launch_merge(q_eff, q_rope, rows, self_lat, self_rope, work, out, R,
                      H, T_len, r, dr, n_groups, scale * kLog2e, stream);
}

}  // namespace

extern "C" {

int latent_attention_launch(const void* q_eff, const void* q_rope,
                            const void* lat, const void* rope,
                            const void* rows, const void* self_lat,
                            const void* self_rope, void* out, void* work,
                            int B, int R, int H, int T_len, int r, int dr,
                            int dtype, int rows_a_block, float scale,
                            void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (B < 1 || R < B || R % B || H < 1 || T_len < 1 || r < 1 || r > kMaxR ||
      r % (kCopyBytes / esize) || dr < 1 || dr > kMaxRope ||
      (dr * esize) % kRopeCopyBytes || rows_a_block < 1 ||
      rows_a_block > kMaxRows)
    return cudaErrorInvalidValue;
  const void* aligned[] = {q_eff, q_rope, lat, rope, self_lat, self_rope};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % kCopyBytes)
      return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(rows);
  float* wp = static_cast<float*>(work);
  if (dtype == 0)
    return launch_fma(
        static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
        static_cast<const float*>(lat), static_cast<const float*>(rope), rp,
        static_cast<const float*>(self_lat),
        static_cast<const float*>(self_rope), static_cast<float*>(out), wp, B,
        R, H, T_len, r, dr, rows_a_block, scale, s);
  if (dtype == 1)
    return launch_tc(
        static_cast<const bf16*>(q_eff), static_cast<const bf16*>(q_rope),
        static_cast<const bf16*>(lat), static_cast<const bf16*>(rope), rp,
        static_cast<const bf16*>(self_lat), static_cast<const bf16*>(self_rope),
        static_cast<bf16*>(out), wp, B, R, H, T_len, r, dr, scale, s);
  return cudaErrorInvalidValue;
}

const char* latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
