// decode_attention: each query row against the first `valid` rows of its
// slot's K/V cache, the attention of the serve path's decode and chunk
// bodies (GQA: a query head reads K/V head hq / G).
//
// Replaces no Pallas kernel: the JAX package computes decode attention in
// jnp (src/repro/models/attention.py:137, decode_attention_ref) and XLA
// fuses it.  The port adds it because its plain version's products and
// softmax are PyTorch kernels whose launch shape, and so whose sum order,
// follows the number of query rows: on an H100 a query among a chunk's C
// columns came out 8.3e-7 (fp32) from the same query alone
// (repro_torch.benchmarks.row_bits).  A chunk's batched body attends B x C
// queries where token prefill attends B, so it needs an attention whose
// row bits do not depend on the rows around it.
//
// Layout: q and out (R, Hq, D) with R = rows (row r of slot r % B), the
// caches (B, Hkv, T, D), valid (R,) int32: row r sees positions
// [0, valid[r]) (at most T; a row with valid 0 sees all T positions, all
// masked, which the plain version's softmax turns into the mean of V).
//
// Bound by the bytes of the visible K/V rows at a long cache, by latency
// at a short one.  Split over the cache length (flash-decoding), in a
// decomposition that is a constant of the kernel and of (D, dtype) alone
// (kernels/decode_attention/plan.py mirrors it):
//  * a row's positions fall in spans of kSpan (64; 32 where a row of the
//    cache is over 256 bytes), and spans in groups of kGroup = 256
//    positions;
//  * a span's work is split among a team of kWarps warps, warp w taking
//    kSpan / kWarps positions and computing its partial (max, sum,
//    weighted V); a score is split over kLanesAPosition lanes (lane j sums
//    the 16-byte vectors j, j + 8, ... of the head dim in order, then a
//    butterfly adds the lanes: every lane ends with the same value), so
//    four positions are scored at once a warp;
//  * within a group the spans are folded in span order into the row's
//    running partial, each span's four warp partials in warp order;
//  * a row of one group writes its output; a longer row's group partials
//    go to a workspace and the merge kernel folds them in group order (the
//    max first, then the sums from group 0 up).
// A block serves one group of up to kMaxRows rows of one (slot, K/V head)
// pair (its GQA group times the chunk's columns), which read each span's K
// and V tiles once, from shared memory: a two-stage ring of 16-byte
// cp.async copies, the next span's tiles in flight while this span's are
// used, in the cache's dtype (converted on read), zero-filled past T.  A
// block holds one team of warps a row up to four rows, so a chunk's rows
// run side by side and a decode step's one row has its team.  Group 0's
// first span is copied before the lengths are read (every row reaches it),
// so a short row costs one trip to memory.  Which block, team or warp runs
// which work never changes a row's operations, so its bits do not depend
// on B, C, G, T or the grid.  The grid is sized from T, never from
// `valid`: a block whose group lies past its rows' lengths exits at once
// (one node of a CUDA graph, no host read).
//
// C interface: decode_attention_launch(...) returns a cudaError_t.  dtype
// 0 = float32, 1 = bfloat16 for q, the caches and out.  D <= 256, a
// multiple of 16 bytes; q and the caches 16-byte aligned.  `work` holds
// R * Hq * ceil(T / 256) * (D + 2) floats when T > 256 (else unused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

using tile_ring::cp_async16;

// The decomposition and the launch's limits (plan.py mirrors these).
constexpr int kWarps = 4;                   // the team: warps a span
constexpr int kLanesAPosition = 8;          // lanes a score
constexpr int kPositionsAPass = 32 / kLanesAPosition;
constexpr int kMaxSpan = 64;
constexpr int kSpanRowBytes = 256;          // longer cache rows: half spans
constexpr int kGroup = 256;                 // positions a block walks
constexpr int kMaxRows = 8;                 // rows a block
constexpr int kMaxTeams = 4;                // teams a block
constexpr int kStages = 2;
constexpr int kCopyBytes = 16;
constexpr int kMaxD = 256;
constexpr int kMaxThreads = 32 * kWarps * kMaxTeams;
constexpr int kSmallD = 128;                // the register buckets: head
constexpr int kMidD = 192;                  // dims up to 128, 192, 256
constexpr int kDims = kMaxD / 32;           // output dims a lane (merge)
constexpr int kMergeGroups = 4;             // groups a merge loads at once
constexpr float kNegInf = -1e30f;           // the plain version's mask
constexpr float kLog2e = 1.4426950408889634f;

// plan.span: positions a span.
constexpr int span_of(int D, int esize) {
  return D * esize <= kSpanRowBytes ? kMaxSpan : kMaxSpan / 2;
}

// plan.smem_bytes: the ring's K and V tiles, the rows' queries (fp32),
// each (row, warp) partial's weighted V, max and sum.
size_t smem_bytes(int D, int esize, int rows) {
  const size_t ring = static_cast<size_t>(kStages) * 2 * span_of(D, esize) *
                      D * esize;
  return ring + sizeof(float) * (static_cast<size_t>(rows) * D +
                                 static_cast<size_t>(rows) * kWarps * (D + 2));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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
// Elements d and d + 1 of a row, as fp32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// grid: (row_blocks * B * Hkv, n_groups), 32 * kWarps * teams threads.
// Block x serves rows [rb * rows, rb * rows + rows) of pair (b, hkv) (row
// qi: column qi / G, query head hkv * G + qi % G) over group y.  kDMax
// (128, 192 or 256: the least that holds D) sizes the per-lane arrays, so
// head dims up to 192 keep to 64 registers and two blocks of 512 threads
// fit an SM.
template <typename T, int kSpan, int kDMax>
__global__ void __launch_bounds__(kMaxThreads, kDMax <= kMidD ? 2 : 1)
    decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ valid, T* __restrict__ out,
                           float* __restrict__ work, int B, int C, int Hq,
                           int Hkv, int T_len, int D, int rows,
                           int row_blocks, int n_groups, float scale_log2) {
  constexpr int kSub = kSpan / kWarps;  // positions a warp of the team
  constexpr int kPasses = kSub / kPositionsAPass;
  constexpr int kVec = kCopyBytes / sizeof(T);
  constexpr int kSpansAGroup = kGroup / kSpan;
  constexpr int kPairs = kDMax / 64;                   // dim pairs a lane
  constexpr int kQFloats = kDMax / kLanesAPosition;    // query floats a lane
  constexpr int kMaxItems = kMaxRows * kDMax / kMaxThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int walk_s[kMaxRows], vis_s[kMaxRows], rh_s[kMaxRows];

  const int nthreads = blockDim.x, teams = nthreads / (32 * kWarps);
  const int G = Hq / Hkv;
  const int rb = blockIdx.x % row_blocks, bh = blockIdx.x / row_blocks;
  const int b = bh / Hkv, hkv = bh % Hkv;
  const int nrows = min(rows, G * C - rb * rows);
  // query row i of the block: (r, hq) -> r * Hq + hq
  auto row_head = [&](int i) {
    const int qi = rb * rows + i;
    return ((qi / G) * B + b) * Hq + hkv * G + qi % G;
  };
  if (threadIdx.x < nrows) {
    const int rh = row_head(threadIdx.x);
    const int vis = min(valid[rh / Hq], T_len);
    walk_s[threadIdx.x] = vis > 0 ? vis : T_len;
    vis_s[threadIdx.x] = vis;
    rh_s[threadIdx.x] = rh;
  }

  const int tile = kSpan * D;  // elements of one K (or V) tile
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + sizeof(T) * kStages * 2 * tile);
  float* part = qs + rows * D;              // [row][warp][D]
  float* stats = part + rows * kWarps * D;  // [row][warp]{max, sum}
  const size_t head = (static_cast<size_t>(b) * Hkv + hkv) * T_len;

  // Span s's K and V rows below T, 16 bytes a copy, zeros past T (so a
  // weight of 0 never meets a stale value); one commit group.
  auto copy_span = [&](int stage, int s) {
    const int p0 = s * kSpan;
    const int per_row = D / kVec;
    const int have = min(kSpan, T_len - p0) * per_row;
    T* ks = ring + stage * 2 * tile;
    const T* kg = k + (head + p0) * D;
    const T* vg = v + (head + p0) * D;
    for (int i = threadIdx.x; i < kSpan * per_row; i += nthreads) {
      const bool in = i < have;
      cp_async16(ks + i * kVec, in ? kg + i * kVec : k, in ? 16 : 0);
      cp_async16(ks + tile + i * kVec, in ? vg + i * kVec : v, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int s0 = blockIdx.y * kSpansAGroup;
  if (blockIdx.y == 0) copy_span(0, 0);  // every row reaches span 0
  // the rows' queries as fp32, in 16-byte loads
  const int nvec = D / kVec;
  for (int i = threadIdx.x; i < nrows * nvec; i += nthreads) {
    const int r = i / nvec, e = (i - r * nvec) * kVec;
    float f[kVec];
    unpack(*reinterpret_cast<const uint4*>(
               q + static_cast<size_t>(row_head(r)) * D + e),
           f, T());
#pragma unroll
    for (int x = 0; x < kVec; x += 4)
      *reinterpret_cast<float4*>(qs + r * D + e + x) =
          make_float4(f[x], f[x + 1], f[x + 2], f[x + 3]);
  }
  __syncthreads();
  int longest = 0;
  for (int i = 0; i < nrows; ++i) longest = max(longest, walk_s[i]);
  const int s_end = min(s0 + kSpansAGroup, (longest + kSpan - 1) / kSpan);
  if (s0 >= s_end) return;  // every row's walk ends before this group
  if (blockIdx.y != 0) copy_span(0, s0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % kWarps, team = warp / kWarps;
  const int j8 = lane % kLanesAPosition, grp = lane / kLanesAPosition;
  // this thread's (row, dim) items of the fold, threadIdx.x + u * nthreads
  // for item u: the first's row and dim, the step between them; and their
  // running partials
  const int i0 = threadIdx.x / D, d0 = threadIdx.x - i0 * D;
  const int di = nthreads / D, dd = nthreads - di * D;
  float M[kMaxItems], L[kMaxItems], A[kMaxItems];
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    M[u] = -INFINITY;
    L[u] = 0.f;
    A[u] = 0.f;
  }
  for (int s = s0, j = 0; s < s_end; ++s, ++j) {
    if (s + 1 < s_end)
      copy_span((j + 1) % kStages, s + 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // span s's tiles have landed, for every thread
    const T* ks = ring + (j % kStages) * 2 * tile;
    const T* vs = ks + tile;

    // Team `team` takes rows team, team + teams, ...: warp w its sub-span.
    for (int i = team; i < nrows; i += teams) {
      const int wk = walk_s[i];
      if (s * kSpan >= wk) continue;
      const int lo = s * kSpan + w * kSub;
      const int n = min(kSub, wk - lo);
      float* st = stats + (i * kWarps + w) * 2;
      if (n <= 0) {  // an empty partial, skipped by the fold
        if (lane == 0) {
          st[0] = -INFINITY;
          st[1] = 0.f;
        }
        continue;
      }
      // this lane's query elements: vectors j8, j8 + 8, ...
      float qr[kQFloats];
#pragma unroll
      for (int u = 0; u < kQFloats / kVec; ++u) {
        const int vv = j8 + u * kLanesAPosition;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 f4 =
              vv < nvec
                  ? *reinterpret_cast<const float4*>(qs + i * D + vv * kVec + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          qr[u * kVec + e] = f4.x;
          qr[u * kVec + e + 1] = f4.y;
          qr[u * kVec + e + 2] = f4.z;
          qr[u * kVec + e + 3] = f4.w;
        }
      }
      const int vis = vis_s[i];
      float p[kPasses];
      float mx = -INFINITY;
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        const int pos = pass * kPositionsAPass + grp;
        const T* kr = ks + (w * kSub + pos) * D;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < kQFloats / kVec; ++u) {
          const int vv = j8 + u * kLanesAPosition;
          if (vv < nvec) {
            float f[kVec];
            unpack(*reinterpret_cast<const uint4*>(kr + vv * kVec), f, T());
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot = fmaf(qr[u * kVec + e], f[e], dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        float sv = -INFINITY;  // past the row's walk: no weight
        if (pos < n) sv = lo + pos < vis ? dot * scale_log2 : kNegInf;
        p[pass] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      float l = 0.f;
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        p[pass] = exp2f(p[pass] - mx);  // 0 past the walk
        l += p[pass];
      }
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      // weighted V over the sub-span's positions in order (a weight of 0
      // past the walk): lane's dims 2 lane + 64 u and the next
      float acc[2 * kPairs];
#pragma unroll
      for (int u = 0; u < 2 * kPairs; ++u) acc[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float pt =
            __shfl_sync(0xffffffffu, p[t / kPositionsAPass],
                        (t % kPositionsAPass) * kLanesAPosition);
        const T* vr = vs + (w * kSub + t) * D;
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            const float2 f = load_pair(vr + d);
            acc[2 * u] = fmaf(pt, f.x, acc[2 * u]);
            acc[2 * u + 1] = fmaf(pt, f.y, acc[2 * u + 1]);
          }
        }
      }
      float* pa = part + (i * kWarps + w) * D;
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D)
          *reinterpret_cast<float2*>(pa + d) =
              make_float2(acc[2 * u], acc[2 * u + 1]);
      }
      if (lane == 0) {
        st[0] = mx;
        st[1] = l;
      }
    }
    __syncthreads();  // partials written; the tiles of span s are consumed

    // Fold span s into each row's running partial: the warps' partials in
    // warp order.
    int i = i0, d = d0;
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      if (i >= nrows) break;
      if (s * kSpan < walk_s[i]) {
        const float* st = stats + i * kWarps * 2;
        float m = M[u];
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) m = fmaxf(m, st[2 * ww]);
        const float fr = exp2f(M[u] - m);  // 0 before the first span
        float l = L[u] * fr, a = A[u] * fr;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) {
          if (st[2 * ww + 1] == 0.f) continue;
          const float f = exp2f(st[2 * ww] - m);
          l = fmaf(st[2 * ww + 1], f, l);
          a = fmaf(part[(i * kWarps + ww) * D + d], f, a);
        }
        M[u] = m;
        L[u] = l;
        A[u] = a;
      }
      i += di;
      d += dd;
      if (d >= D) {
        d -= D;
        ++i;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // A row of one group: its output.  A longer row: this group's partial.
  int i = i0, d = d0;
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u) {
    if (i >= nrows) break;
    const int wk = walk_s[i];
    if (s0 * kSpan < wk) {
      const size_t rh = rh_s[i];
      if (wk <= kGroup) {
        store(out + rh * D + d, A[u] * (1.f / L[u]));
      } else {
        float* wp = work + (rh * n_groups + blockIdx.y) * (D + 2);
        wp[2 + d] = A[u];
        if (d == 0) {
          wp[0] = M[u];
          wp[1] = L[u];
        }
      }
    }
    i += di;
    d += dd;
    if (d >= D) {
      d -= D;
      ++i;
    }
  }
}

// One warp a query row (rh = r * Hq + hq) that crosses groups: its groups'
// partials folded in group order (the max first), the output written.
template <typename T>
__global__ void __launch_bounds__(128)
    decode_attention_merge(const float* __restrict__ work,
                           const int* __restrict__ valid, T* __restrict__ out,
                           int n_rows, int Hq, int T_len, int D,
                           int n_groups) {
  const int rh = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (rh >= n_rows) return;
  const int vis = min(valid[rh / Hq], T_len);
  const int wk = vis > 0 ? vis : T_len;
  const int ng = (wk + kGroup - 1) / kGroup;
  if (ng <= 1) return;  // written by the split kernel
  const float* wp = work + static_cast<size_t>(rh) * n_groups * (D + 2);
  float m = -INFINITY;
  for (int g = lane; g < ng; g += 32) m = fmaxf(m, wp[g * (D + 2)]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, acc[kDims];
#pragma unroll
  for (int u = 0; u < kDims; ++u) acc[u] = 0.f;
  for (int g0 = 0; g0 < ng; g0 += kMergeGroups) {
    float mg[kMergeGroups], lg[kMergeGroups], ag[kMergeGroups][kDims];
#pragma unroll
    for (int gg = 0; gg < kMergeGroups; ++gg) {
      const float* ps = wp + (g0 + gg) * (D + 2);
      const bool in = g0 + gg < ng;
      mg[gg] = in ? ps[0] : -INFINITY;
      lg[gg] = in ? ps[1] : 0.f;
#pragma unroll
      for (int u = 0; u < kDims; ++u) {
        const int d = lane + 32 * u;
        ag[gg][u] = in && d < D ? ps[2 + d] : 0.f;
      }
    }
#pragma unroll
    for (int gg = 0; gg < kMergeGroups; ++gg) {
      if (g0 + gg >= ng) break;
      const float f = exp2f(mg[gg] - m);
      l = fmaf(lg[gg], f, l);
#pragma unroll
      for (int u = 0; u < kDims; ++u) acc[u] = fmaf(ag[gg][u], f, acc[u]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int u = 0; u < kDims; ++u) {
    const int d = lane + 32 * u;
    if (d < D) store(out + static_cast<size_t>(rh) * D + d, acc[u] * inv);
  }
}

// plan.teams: a team of warps a row, up to kMaxTeams.
int teams_of(int rows) { return rows < kMaxTeams ? rows : kMaxTeams; }

template <typename T, int kSpan, int kDMax>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* valid, void* out, float* work, int B, int R,
                     int Hq, int Hkv, int T_len, int D, int rows, float scale,
                     cudaStream_t stream) {
  const int C = R / B, G = Hq / Hkv;
  const int n_groups = (T_len + kGroup - 1) / kGroup;
  const int row_blocks = (G * C + rows - 1) / rows;
  const long long gx = static_cast<long long>(row_blocks) * B * Hkv;
  if (gx > 0x7fffffffLL || n_groups > 65535 ||
      (n_groups > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, sizeof(T), rows);
  cudaError_t err =
      hopper::allow_smem<decode_attention_split<T, kSpan, kDMax>>(smem);
  if (err != cudaSuccess) return err;
  decode_attention_split<T, kSpan, kDMax>
      <<<dim3(static_cast<unsigned>(gx), n_groups),
         32 * kWarps * teams_of(rows), smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), valid, static_cast<T*>(out), work, B, C,
          Hq, Hkv, T_len, D, rows, row_blocks, n_groups, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return err;
  const int n_rows = R * Hq;
  decode_attention_merge<T><<<(n_rows + 3) / 4, 128, 0, stream>>>(
      work, valid, static_cast<T*>(out), n_rows, Hq, T_len, D, n_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, void* work, int B,
                            int R, int Hq, int Hkv, int T_len, int D,
                            int dtype, int rows, float scale, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (B < 1 || R < B || R % B || Hkv < 1 || Hq % Hkv || T_len < 1 || D < 1 ||
      D > kMaxD || D % (kCopyBytes / esize) || rows < 1 || rows > kMaxRows)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % kCopyBytes ||
      reinterpret_cast<uintptr_t>(k) % kCopyBytes ||
      reinterpret_cast<uintptr_t>(v) % kCopyBytes)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vp = static_cast<const int*>(valid);
  float* wp = static_cast<float*>(work);
  // (span, register bucket) of (D, dtype): fp32 64 up to D 64, 32 above;
  // bf16 64 up to D 128, 32 above; the bucket the least that holds D
  if (dtype == 0) {
    if (span_of(D, 4) == kMaxSpan)
      return launch_t<float, kMaxSpan, kSmallD>(q, k, v, vp, out, wp, B, R,
                                                Hq, Hkv, T_len, D, rows,
                                                scale, s);
    if (D <= kSmallD)
      return launch_t<float, kMaxSpan / 2, kSmallD>(
          q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
    if (D <= kMidD)
      return launch_t<float, kMaxSpan / 2, kMidD>(
          q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
    return launch_t<float, kMaxSpan / 2, kMaxD>(
        q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
  }
  if (dtype == 1) {
    if (span_of(D, 2) == kMaxSpan)
      return launch_t<__nv_bfloat16, kMaxSpan, kSmallD>(
          q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
    if (D <= kMidD)
      return launch_t<__nv_bfloat16, kMaxSpan / 2, kMidD>(
          q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
    return launch_t<__nv_bfloat16, kMaxSpan / 2, kMaxD>(
        q, k, v, vp, out, wp, B, R, Hq, Hkv, T_len, D, rows, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
