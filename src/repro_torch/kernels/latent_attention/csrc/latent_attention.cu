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
// The score of a position is (q_eff . latent + q_rope . rope) * scale, the
// two dot products summed separately and then added.  MLA decode is
// multi-query attention over one shared latent "head": K = [latent | rope]
// (288 wide at minicpm3), V = latent (256), read by all H x C query rows of
// a slot.  On this card it is bound by operations: the rows' fp32 scores
// and weighted sums on CUDA cores (kept off the tensor cores, whose row
// bits follow the tile, as decode_attention's are), against a cache of a
// few hundred KB a layer.  The design reads each cache row once a block
// and shares it among the block's rows, in a decomposition that is a
// constant of the kernel and of (r, dr, dtype) alone
// (kernels/latent_attention/plan.py mirrors it):
//  * a row's positions fall in spans of kSpan = 64, and spans in groups of
//    kGroup = 256 positions; one warp walks a row's spans;
//  * a score is split over kLanesAPosition lanes (lane j sums the latent's
//    16-byte vectors j, j + 8, ... and the rope's elements j, j + 8, ... in
//    order, then a butterfly adds each sum over the lanes: every lane ends
//    with the same value), so four positions are scored at once a warp;
//  * within a group the spans are folded into the row's online softmax in
//    span order, a span's positions in order (8 fp32 dims of the 256-wide
//    accumulator a lane); the self row folds last.  A row of one group
//    writes its output from group 0's block; a longer row's group partials
//    go to a workspace and the merge kernel folds them in group order (the
//    max first), then the self row.
// A block serves up to kMaxRows rows of one slot (a warp each), which read
// each span's latent and rope tiles once, from shared memory: a two-stage
// ring of cp.async copies (16 bytes for the latent, 4 for the rope), the
// next span's tiles in flight while this span's are used, in the caches'
// dtype (converted on read), zero-filled past T.  Which block or warp runs
// which row never changes a row's operations, so its bits do not depend on
// B, C, H, T or the grid.  The grid is sized from T, never from `rows`: a
// block whose group lies past its rows' walks exits at once (one node of a
// CUDA graph, no host read).
//
// C interface: latent_attention_launch(...) returns a cudaError_t.  dtype
// 0 = float32, 1 = bfloat16 for every operand and out.  r <= 256 in whole
// 16-byte vectors, dr <= 64 in whole 4-byte words; the operands 16-byte
// aligned.  `work` holds R * H * ceil(T / 256) * (r + 2) floats when
// T > 256 (else unused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

using tile_ring::cp_async16;

// The decomposition and the launch's limits (plan.py mirrors these).
constexpr int kSpan = 64;
constexpr int kGroup = 256;
constexpr int kLanesAPosition = 8;
constexpr int kPositionsAPass = 32 / kLanesAPosition;
constexpr int kPasses = kSpan / kPositionsAPass;
constexpr int kSpansAGroup = kGroup / kSpan;
constexpr int kMaxRows = 8;                  // rows a block, a warp each
constexpr int kStages = 2;
constexpr int kCopyBytes = 16;
constexpr int kRopeCopyBytes = 4;
constexpr int kMaxR = 256;
constexpr int kMaxRope = 64;
constexpr int kMergeRows = 4;                // rows a merge block
constexpr int kAcc = kMaxR / 32;             // accumulator floats a lane
constexpr float kLog2e = 1.4426950408889634f;

// plan.smem_bytes: the ring's latent and rope tiles.
size_t smem_bytes(int r, int dr, int esize) {
  return static_cast<size_t>(kStages) * kSpan * (r + dr) * esize;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tile_ring::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
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

template <typename T>
cudaError_t launch_t(const void* q_eff, const void* q_rope, const void* lat,
                     const void* rope, const int* rows, const void* self_lat,
                     const void* self_rope, void* out, float* work, int B,
                     int R, int H, int T_len, int r, int dr, int rows_a_block,
                     float scale, cudaStream_t stream) {
  const int C = R / B;
  const int n_groups = (T_len + kGroup - 1) / kGroup;
  const int row_blocks = (H * C + rows_a_block - 1) / rows_a_block;
  const long long gx = static_cast<long long>(row_blocks) * B;
  if (gx > 0x7fffffffLL || n_groups > 65535 ||
      (n_groups > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r, dr, sizeof(T));
  cudaError_t err = hopper::allow_smem<latent_attention_split<T>>(smem);
  if (err != cudaSuccess) return err;
  const T* qe = static_cast<const T*>(q_eff);
  const T* qr = static_cast<const T*>(q_rope);
  const T* sl = static_cast<const T*>(self_lat);
  const T* sr = static_cast<const T*>(self_rope);
  latent_attention_split<T>
      <<<dim3(static_cast<unsigned>(gx), n_groups), 32 * rows_a_block, smem,
         stream>>>(qe, qr, static_cast<const T*>(lat),
                   static_cast<const T*>(rope), rows, sl, sr,
                   static_cast<T*>(out), work, B, C, H, T_len, r, dr,
                   rows_a_block, row_blocks, n_groups, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return err;
  const int n_rows = R * H;
  latent_attention_merge<T>
      <<<(n_rows + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0,
         stream>>>(qe, qr, rows, sl, sr, work, static_cast<T*>(out), n_rows,
                   H, T_len, r, dr, n_groups, scale * kLog2e);
  return cudaGetLastError();
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
    return launch_t<float>(q_eff, q_rope, lat, rope, rp, self_lat, self_rope,
                           out, wp, B, R, H, T_len, r, dr, rows_a_block,
                           scale, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q_eff, q_rope, lat, rope, rp, self_lat,
                                   self_rope, out, wp, B, R, H, T_len, r, dr,
                                   rows_a_block, scale, s);
  return cudaErrorInvalidValue;
}

const char* latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
