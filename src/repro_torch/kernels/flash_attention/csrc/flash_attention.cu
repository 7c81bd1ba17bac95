// flash_attention: blocked online-softmax attention over (B, H, S, D).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _kernel), which runs a (BH, nq, nk) grid and
// carries the running max, sum and accumulator in VMEM scratch from one k
// block to the next.  On the card blocks run in parallel and in no order, so
// the k loop moves inside the block: one block per (batch x head, q tile)
// walks the k tiles itself, and the running state stays in registers.
//
// Semantics are the Pallas kernel's, with the q_offset of the model-level
// reference added: scale 1/sqrt(D); keys past Sk masked; causal keeps
// k <= q_offset + q; a window keeps k > q_offset + q - window, applied
// whether or not the mask is causal; masked scores are -1e30; the output is
// acc / max(l, 1e-30) in the input type.  GQA is expanded by index: query
// head h reads KV head h / (Hq / Hkv), with no copy of K or V.  k tiles that
// the causal or window mask covers entirely for every row of the block are
// skipped, and a row with no key in range gives 0 (its probabilities stay
// 0 while no key in range has been seen, in both paths).  When an lse
// pointer is passed (training: flash_attention_bwd.cu recomputes the
// probabilities from it), each row's log-sum-exp of its scaled scores is
// written there in fp32, +inf for a row with no key in range; the output's
// bits do not depend on it.
//
// What bounds it on an H100: at the serve path's shapes (S of a few hundred
// to a few thousand, D = 96 to 256) attention does 4 S^2 D operations per
// head (half of that under a causal mask) against 4 S D elements moved, so
// it is bound by operations: in bf16 by the tensor cores.
//
// bf16 (namespace tc), on the tensor cores (FlashAttention-2's loop):
//  * four warps, each owning 16 of the block's 64 query rows; both products
//    are mma.sync m16n8k16 with fp32 accumulators.  S = Q K^T comes out as
//    accumulator fragments, the online softmax runs on them (row max and sum
//    reduced over the 4 lanes of a quad), and P is packed into bf16 A
//    fragments in registers, never written to shared memory;
//  * Q and each K tile reach the first product through ldmatrix, V the
//    second through ldmatrix.trans; rows are padded by 16 bytes so the 8
//    rows an ldmatrix reads fall on 8 bank groups;
//  * K and V stream through a ring of two stages filled with cp.async, one
//    mbarrier a stage, so the next tile loads while this one is multiplied;
//  * D is zero-padded to a multiple of 16 in shared memory; the kernel is a
//    template on the widest head dim it takes (64, 128 or 256), which sets
//    the output registers a lane keeps (D / 2 at most) and the k tile (64
//    keys, 32 at D > 128, so two blocks fit an SM: 101 KB at D = 256), and
//    on the count of 16-wide slices for the common head dims, so their
//    loops and loads have fixed trip counts;
//  * at D = 256 a lane keeps 128 fp32 outputs; ptxas reports no spills
//    (chip_smoke.py phase 1 prints its register and spill counts);
//  * the q tiles with the most keys start first (the grid walks them in
//    reverse), so a causal launch ends on light tiles.
//
// fp32 (namespace f32), on FMAs (the fp32 tolerance, 2e-4, rules out TF32),
// bound by the FMA rate (67 TFLOP/s).  What held it back was one lane per
// key, with a D-long dot product out of shared memory and P V one key at a
// time: a shared-memory load per FMA or two.  So, as the fp32 backward
// (flash_attention_bwd.cu):
//  * 256 threads as a 16 x 16 grid (ty, tx); query tiles of 64 rows (32 at
//    D > 128) and key tiles of 64 keys (32 at D > 64), so that two blocks
//    fit an SM up to D = 128 (111 KB at D = 128, 169 KB at D = 256);
//  * K and V stream through a two-stage cp.async ring, one mbarrier a
//    stage; rows are padded to an odd count of float4s, so 16 rows read at
//    one column fall on 8 bank groups twice;
//  * a thread keeps a (tile / 16) x (keys / 16) micro-tile of S (rows
//    ty + 16 i, keys tx + 16 j), reading Q and K as float4 along D; a row's
//    max and sum reduce over its 16 threads, a half-warp, by shuffles;
//  * P goes through shared memory into a (tile / 16) x (D / 16) micro-tile
//    of O (columns 64 c + 4 tx + e), P and V read as float4s;
//  * at 64 query rows and 64 keys (D <= 64) a column group of S is 8
//    vector loads for 64 FMAs, and 4 keys of O the same.
//
// C interface: flash_attention_launch(...) returns cudaGetLastError().
// q (B, Hq, Sq, ld), k and v (B, Hkv, Sk, ld), out (B, Hq, Sq, ld),
// contiguous, head dim D <= ld: ld = D for fp32; for bf16 ld is D rounded up
// to a multiple of 8 (16-byte rows), the columns past D zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32 on FMAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // a 16 x 16 grid (ty, tx)
constexpr int kStages = 2;     // K/V ring stages

// The tiles for head dims up to kDMax: query rows a block, keys a tile,
// the padded row of Q, K and V (kDMax + 4 floats: an odd count of float4s,
// so 16 rows read at one column fall on 8 bank groups twice) and of P
// (keys + 16: the two half-warps' rows 16 banks apart); then the byte
// offsets of Q, the ring and P after the barriers.
template <int kDMax>
struct Geom {
  static constexpr int kBQ = kDMax > 128 ? 32 : 64;
  static constexpr int kBK = kDMax > 64 ? 32 : 64;
  static constexpr int kLd = kDMax + 4;
  static constexpr int kLdP = kBK + 16;
  static constexpr int kRQ = kBQ / 16;   // query rows a thread
  static constexpr int kKJ = kBK / 16;   // keys a thread (S)
  static constexpr int kOC = kDMax / 64;  // float4 column groups a thread (O)
  static constexpr size_t kOffQ = 128;
  static constexpr size_t kOffKV = kOffQ + sizeof(float) * kBQ * kLd;
  static constexpr size_t kStage = sizeof(float) * 2 * kBK * kLd;  // K, V
  static constexpr size_t kOffP = kOffKV + kStages * kStage;
  static constexpr size_t kSmem = kOffP + sizeof(float) * kBQ * kLdP;
};

// Rows [r0, r0 + rows) of a (R, D) matrix into rows of kLd, columns up to
// the float4 that holds column D - 1; rows past R and columns past D
// arrive as zeros.  16-byte copies when D is a multiple of 4 and the
// matrix 16-byte aligned (`vec`), else 4-byte ones; a warp copies a run
// of one row either way.
template <int kDMax, int kLd>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int R,
                                          int D, int r0, int rows, bool vec) {
  const int width = (D + 3) / 4;  // float4s a row
  if (vec) {
    constexpr int kPer = kDMax / 4, kPass = kThreads / kPer;
    const int c = threadIdx.x % kPer;
    if (c >= width) return;
    for (int r = threadIdx.x / kPer; r < rows; r += kPass) {
      const bool in = r0 + r < R;
      tile_ring::cp_async16(
          dst + r * kLd + 4 * c,
          in ? src + static_cast<size_t>(r0 + r) * D + 4 * c : src,
          in ? 16 : 0);
    }
    return;
  }
  constexpr int kPass = kThreads / kDMax;
  const int c = threadIdx.x % kDMax;
  if (c >= 4 * width) return;
  for (int r = threadIdx.x / kDMax; r < rows; r += kPass) {
    const bool in = r0 + r < R && c < D;
    tile_ring::cp_async4(
        dst + r * kLd + c,
        in ? src + static_cast<size_t>(r0 + r) * D + c : src, in ? 4 : 0);
  }
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads, kDMax > 128 ? 1 : 2)
    flash_attention_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int Hq, int Hkv, int Sq,
                        int Sk, int D, int causal, int has_window, int window,
                        int q_offset, float scale) {
  using G = Geom<kDMax>;
  constexpr int kBQ = G::kBQ, kBK = G::kBK, kLd = G::kLd, kLdP = G::kLdP;
  constexpr int kRQ = G::kRQ, kKJ = G::kKJ, kOC = G::kOC;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + G::kOffQ);  // [kBQ][kLd]
  float* ps = reinterpret_cast<float*>(smem + G::kOffP);  // P [kBQ][kLdP]
  auto stage = [&](int s) {  // K [kBK][kLd], then V
    return reinterpret_cast<float*>(smem + G::kOffKV + s * G::kStage);
  };

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the q tiles with the most keys first, so the last wave is the lightest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const float* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  float* ob = out + static_cast<size_t>(bh) * Sq * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d4 = (D + 3) / 4;  // float4 columns in use
  const bool vec =
      D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // k tiles that hold a key some row of this block may attend to
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = max(0, min(k_end, q_last + 1));
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  // this thread's rows ty + 16 i; S's keys tx + 16 j; O's columns
  // 64 c + 4 tx + e
  float m[kRQ], l[kRQ], o[kRQ][4 * kOC];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kOC; ++c) o[i][c] = 0.f;
  }

  auto fill = [&](int s, int t) {
    float* ks = stage(s);
    load_rows<kDMax, kLd>(ks, kb, Sk, D, t * kBK, kBK, vec);
    load_rows<kDMax, kLd>(ks + kBK * kLd, vb, Sk, D, t * kBK, kBK, vec);
    tile_ring::cp_async_arrive(bar + s);
  };
  if (t_begin < t_end) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s)
        tile_ring::mbar_init(bar + s, kThreads);
      tile_ring::mbar_init_fence();
    }
    __syncthreads();
    load_rows<kDMax, kLd>(qs, qb, Sq, D, q0, kBQ, vec);
    for (int s = 0; s < kStages && t_begin + s < t_end; ++s)
      fill(s, t_begin + s);  // the first arrival also covers Q
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int u = t - t_begin, st = u % kStages;
    hopper::mbar_wait_or_trap(bar + st, (u / kStages) & 1);
    const float* ks = stage(st);
    const float* vs = ks + kBK * kLd;

    // S = Q K^T over float4 columns: per column group, kRQ + kKJ vector
    // loads for 4 kRQ kKJ FMAs
    float sc[kRQ][kKJ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDMax / 4; ++dd) {
      if (dd >= d4) break;
      float4 qv[kRQ], kv[kKJ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd +
                                                 4 * dd);
#pragma unroll
      for (int j = 0; j < kKJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd +
                                                 4 * dd);
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // scaled, masked where the tile is not all in range
    const int k0 = t * kBK;
    const bool full = k0 + kBK <= Sk &&
                      (!causal || k0 + kBK - 1 <= q_first) &&
                      (!has_window || k0 > q_last - window);
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        float x = sc[i][j] * scale;
        if (!full) {
          const int kpos = k0 + tx + 16 * j;
          const int qpos = q_offset + q0 + ty + 16 * i;
          bool valid = kpos < Sk;
          if (causal) valid = valid && kpos <= qpos;
          if (has_window) valid = valid && kpos > qpos - window;
          x = valid ? x : kNegInf;
        }
        sc[i][j] = x;
      }

    // online softmax; a row's 16 threads are a half-warp (tx), so its max
    // and sum reduce over shuffles 8, 4, 2, 1.  A row whose keys so far
    // are all masked keeps p = 0, so it ends at 0 if no key is in range
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < kKJ; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const bool dead = m_new <= kNegInf;
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float p = dead ? 0.f : expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffff, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kOC; ++c) o[i][c] *= corr;
    }
    __syncthreads();  // P is in shared memory

    // O += P V: per 4 keys, kRQ float4s of P and 4 kOC of V for
    // 16 kRQ kOC FMAs
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRQ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          if (64 * c >= D) break;
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (kk + e) * kLd + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < kRQ; ++i) {
            const float p = tile_ring::elem(pv[i], e);
            o[i][4 * c] = fmaf(p, vv.x, o[i][4 * c]);
            o[i][4 * c + 1] = fmaf(p, vv.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p, vv.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p, vv.w, o[i][4 * c + 3]);
          }
        }
      }
    }

    __syncthreads();  // every thread is done with this stage and with P
    if (t + kStages < t_end) fill(st, t + kStages);
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * Sq + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = ob + static_cast<size_t>(r) * D;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < D) orow[col] = o[i][4 * c + e] * inv;
      }
  }
}

template <int kDMax>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int causal, int has_window, int window, int q_offset,
                   cudaStream_t stream) {
  using G = Geom<kDMax>;
  cudaError_t err =
      hopper::allow_smem<flash_attention_f32<kDMax>>(G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + G::kBQ - 1) / G::kBQ, B * Hq);
  flash_attention_f32<kDMax><<<grid, kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Hq, Hkv,
      Sq, Sk, D, causal, has_window, window, q_offset,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

size_t smem_bytes(int D) {
  return D > 128 ? Geom<256>::kSmem
                 : (D > 64 ? Geom<128>::kSmem : Geom<64>::kSmem);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps of 16 query rows
constexpr int kBQ = 64;

template <int kDMax>
struct Geom {
  static constexpr int kBK = kDMax > 128 ? 32 : 64;  // keys a tile
  static constexpr int kStages = 2;                  // K/V ring stages
  static constexpr int kLd = kDMax + 8;              // smem row, elements
  static constexpr size_t kSmem =
      128 + sizeof(bf16) * (static_cast<size_t>(kBQ) * kLd +
                            kStages * 2 * static_cast<size_t>(kBK) * kLd);
};

// rows [r0, r0 + rows) of a (R, ld) matrix into a tile with row stride
// kLd; rows past R and chunks past ld arrive as zeros
template <int kLd>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int R,
                                          int ld, int r0, int rows,
                                          int nchunk) {
  for (int i = threadIdx.x; i < rows * nchunk; i += kThreads) {
    const int r = i / nchunk, c = i % nchunk;
    const bool in = r0 + r < R && 8 * c < ld;
    tile_ring::cp_async16(dst + r * kLd + 8 * c,
                          in ? src + static_cast<size_t>(r0 + r) * ld + 8 * c
                             : src,
                          in ? 16 : 0);
  }
}

template <int kDMax, int kD16>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int D,
           int ld, int causal, int has_window, int window, int q_offset,
           float scale_log2) {
  using G = Geom<kDMax>;
  constexpr int kBK = G::kBK, kLd = G::kLd, kStages = G::kStages;
  constexpr int kNT = kBK / 8, kDT = kDMax / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + 128);
  bf16* kv = qs + kBQ * kLd;  // stage s: K at kv + 2 s kBK kLd, V after it

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the q tiles with the most keys first, so the last wave is the lightest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const bf16* qb = q + static_cast<size_t>(bh) * Sq * ld;
  const bf16* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * ld;
  const bf16* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * ld;
  bf16* ob = out + static_cast<size_t>(bh) * Sq * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  // 16-wide column slices in use: compiled in for the served head dims
  const int d16 = kD16 ? kD16 : (D + 15) / 16;
  const int nchunk = 2 * d16;         // 16-byte chunks a padded row

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = max(0, min(k_end, q_last + 1));
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  // this lane's rows: 16 warp + g and + 8
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (t_begin < t_end) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s)
        tile_ring::mbar_init(bar + s, kThreads);
      tile_ring::mbar_init_fence();
    }
    __syncthreads();
    load_rows<kLd>(qs, qb, Sq, ld, q0, kBQ, nchunk);
    for (int s = 0; s < kStages && t_begin + s < t_end; ++s) {
      bf16* ks = kv + 2 * s * kBK * kLd;
      load_rows<kLd>(ks, kb, Sk, ld, (t_begin + s) * kBK, kBK, nchunk);
      load_rows<kLd>(ks + kBK * kLd, vb, Sk, ld, (t_begin + s) * kBK, kBK,
                     nchunk);
      tile_ring::cp_async_arrive(bar + s);  // the first also covers Q
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int u = t - t_begin, st = u % kStages;
    hopper::mbar_wait_or_trap(bar + st, (u / kStages) & 1);
    const bf16* ks = kv + 2 * st * kBK * kLd;
    const bf16* vs = ks + kBK * kLd;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kDMax / 16; ++kd) {
      if (kd >= d16) break;
      uint32_t a[4];
      hopper::ldmatrix_x4(a, qs + (16 * warp + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                 16 * kd + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bk[4];
        hopper::ldmatrix_x4(bk, ks + (16 * j + (lane & 7) + (lane >> 4) * 8) *
                                         kLd +
                                     16 * kd + ((lane >> 3) & 1) * 8);
        hopper::mma_16816(s[2 * j], a, bk[0], bk[1]);
        hopper::mma_16816(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // scores in log2 units, masked where the tile is not all in range
    const int k0 = t * kBK;
    const bool full = k0 + kBK <= Sk &&
                      (!causal || k0 + kBK - 1 <= q_first) &&
                      (!has_window || k0 > q_last - window);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
          const int qpos = q_offset + row[e >> 1];
          bool valid = kpos < Sk;
          if (causal) valid = valid && kpos <= qpos;
          if (has_window) valid = valid && kpos > qpos - window;
          x = valid ? x : kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax on the fragments; a row whose keys so far are all
    // masked keeps p = 0, so it ends at 0 if no key is ever in range
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const bool dead = m_new <= kNegInf;
      const float corr = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = dead ? 0.f : exp2f(s[j][e] - m_new);
          s[j][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        if (j >= 2 * d16) break;
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // O += P V, P packed into A fragments in registers
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {hopper::pack_bf16x2(s[2 * j][0], s[2 * j][1]),
                             hopper::pack_bf16x2(s[2 * j][2], s[2 * j][3]),
                             hopper::pack_bf16x2(s[2 * j + 1][0],
                                                 s[2 * j + 1][1]),
                             hopper::pack_bf16x2(s[2 * j + 1][2],
                                                 s[2 * j + 1][3])};
#pragma unroll
      for (int dd = 0; dd < kDMax / 16; ++dd) {
        if (dd >= d16) break;
        uint32_t bv[4];
        hopper::ldmatrix_x4_trans(
            bv, vs + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                    16 * dd + (lane >> 4) * 8);
        hopper::mma_16816(o[2 * dd], a, bv[0], bv[1]);
        hopper::mma_16816(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (t + kStages < t_end) {
      bf16* kn = kv + 2 * st * kBK * kLd;
      load_rows<kLd>(kn, kb, Sk, ld, (t + kStages) * kBK, kBK, nchunk);
      load_rows<kLd>(kn + kBK * kLd, vb, Sk, ld, (t + kStages) * kBK, kBK,
                     nchunk);
      tile_ring::cp_async_arrive(bar + st);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    // m is in log2 units; the log-sum-exp is stored in natural ones
    if (lse != nullptr && tq == 0)
      lse[static_cast<size_t>(bh) * Sq + row[r]] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : INFINITY;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = ob + static_cast<size_t>(row[r]) * ld;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < D)  // D is even here: c + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

template <int kDMax, int kD16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int ld, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  const size_t smem = Geom<kDMax>::kSmem;
  auto kern = flash_attention_tc<kDMax, kD16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  // 1/sqrt(D) and the change to base 2 in one factor
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Hq, Hkv,
      Sq, Sk, D, ld, causal, has_window, window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
// ld is the row length of q, k, v and out in memory: D for fp32, D rounded
// up to a multiple of 8 for bf16.  lse, (B, Hq, Sq) fp32, may be null.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Hq, int Hkv,
                           int Sq, int Sk,
                           int D, int ld, int causal, int has_window,
                           int window, int q_offset, int dtype,
                           void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || B * Hq > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ld != D) return cudaErrorInvalidValue;
    auto run = D > 128 ? f32::launch<256>
                       : (D > 64 ? f32::launch<128> : f32::launch<64>);
    return run(q, k, v, out, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk, D,
               causal, has_window, window, q_offset, s);
  }
  if (dtype == 1) {
    if (ld % 8 != 0 || ld < D || ld > (D + 7) / 8 * 8)
      return cudaErrorInvalidValue;
    // head dims of 5, 6, 8 and 16 slices (80, 96, 128, 256: the served
    // models' and the card tests') have their own code, with the slice
    // count compiled in; every other head dim takes its width class's code,
    // which reads the count at run time and runs slower
    auto run = D > 128 ? tc::launch<256, 0>
                       : (D > 64 ? tc::launch<128, 0> : tc::launch<64, 0>);
    switch ((D + 15) / 16) {
      case 5: run = tc::launch<128, 5>; break;
      case 6: run = tc::launch<128, 6>; break;
      case 8: run = tc::launch<128, 8>; break;
      case 16: run = tc::launch<256, 16>; break;
      default: break;
    }
    return run(q, k, v, out, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk,
               D, ld, causal, has_window, window, q_offset, s);
  }
  return cudaErrorInvalidValue;
}

// Shared memory one block of the kernel for head dim D takes (ops.py's
// fp32_geometry and the bf16 Geom give the same numbers).
long long flash_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0) return static_cast<long long>(f32::smem_bytes(D));
  return static_cast<long long>(
      D > 128 ? tc::Geom<256>::kSmem
              : (D > 64 ? tc::Geom<128>::kSmem : tc::Geom<64>::kSmem));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
