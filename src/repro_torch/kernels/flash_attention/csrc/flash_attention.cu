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
// fp32 (flash_attention_kernel below): Q, K and V as fp32 in shared memory,
// scores and P V on FMAs (the fp32 tolerance, 2e-4, rules out TF32).  Lane j
// scores key j of a 32-key tile; each warp owns 8 query rows; lane j keeps
// output columns j, j + 32, ... in registers (4 for D <= 128, 8 above);
// shared memory is (64 D + 32 (D + 1) + 32 D) floats, 129 KB at D = 256.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D);
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse,
                           int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                           int has_window, int window, int q_offset,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kBQ][D]
  float* ks = qs + kBQ * D;            // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);      // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + (static_cast<size_t>(bh) * Sq) * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  T* ob = out + (static_cast<size_t>(bh) * Sq) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = (q0 + r < Sq) ? to_float(qb[static_cast<size_t>(q0 + r) * D + i % D])
                          : 0.f;
  }

  // k tiles that hold a key some row of this block may attend to
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = max(0, min(k_end, q_last + 1));
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile (and, first time, Q) is consumed/ready
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      ks[r * (D + 1) + d] = in ? to_float(kb[g]) : 0.f;
      vs[r * D + d] = in ? to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (q0 + r >= Sq) continue;  // warp-uniform
      const int qpos = q_offset + q0 + r;
      float s = 0.f;
      const float* qr = qs + r * D;
      const float* kr = ks + lane * (D + 1);
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      bool valid = kpos < Sk;
      if (causal) valid = valid && kpos <= qpos;
      if (has_window) valid = valid && kpos > qpos - window;
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      // every key so far masked: p = 0, so the row ends at 0 if none is
      // in range (a later key in range scales what came before by 0)
      const float p = m_new <= kNegInf ? 0.f : expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffff, p, j);
        const float* vr = vs + j * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(pj, vr[d], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        from_float(ob + static_cast<size_t>(q0 + r) * D + d, acc[i][c] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * Sq + q0 + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int causal, int has_window, int window, int q_offset,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, kCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk,
      D, causal, has_window, window, q_offset,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}


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
    const bool wide = D > 128;  // 8 output columns a lane, else 4
    return (wide ? launch<float, 8> : launch<float, 4>)(
        q, k, v, out, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk, D,
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

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
