// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// with respect to q, k and v.
//
// The JAX package has no backward kernel: its train path differentiates the
// plain blocked attention (src/repro/models/attention.py,
// flash_attention_ref) with XLA's autodiff, which keeps the (Sq, Sk)
// probabilities of every head.  This file recomputes them instead, tile by
// tile, from the log-sum-exp the forward kernel writes (FlashAttention-2's
// backward), so nothing of size S^2 reaches device memory:
//
//   P  = exp(S * scale - lse)        S = Q K^T, masked entries 0
//   dV = P^T dO                      dP = dO V^T
//   dS = P * (dP - delta)            delta_i = sum_d dO_i,d O_i,d
//   dQ = scale dS K                  dK = scale dS^T Q
//
// Three launches on the current stream, no atomics, so two calls give the
// same bits:
//  * delta: one warp a row, fp32;
//  * dK and dV: one block a (batch, KV head, 64-key tile).  It walks the
//    group's query heads and their query tiles in a fixed order, from the
//    causal diagonal to the window's end, and sums GQA's heads in its
//    registers; dK and dV are written once;
//  * dQ: one block a (batch, query head, 64-row query tile), walking the key
//    tiles the forward walks.
// A row with no key in range (lse = +inf) has P = 0, so it gives zero
// gradients, never NaN.  Semantics are the forward's with q_offset = 0:
// scale 1/sqrt(D), causal keeps k <= q, a window keeps k > q - window.
//
// What bounds it on an H100: five products of 2 Sq Sk D operations a head
// (S, dP, dV, dK, dQ; half of that under a causal mask) against about
// 10 S D elements moved, so at S of a few hundred it is bound by
// operations, as the forward is.  The kernels recompute S and dP in both
// the dK/dV and the dQ pass (seven products in all), which costs less than
// moving the (S, S) probabilities through device memory.
//
// bf16 (namespace tc) runs on the tensor cores, mma.sync m16n8k16 with
// fp32 accumulators, as the forward does: four warps, each owning 16 rows
// of the block's tile (16 keys in the dK/dV kernel, 16 queries in the dQ
// kernel).  Every product's A operand is either a row-major tile read with
// ldmatrix or an accumulator fragment packed to bf16 in registers (P^T and
// dS^T for dV and dK, dS for dQ); the B operands are tiles read with
// ldmatrix or ldmatrix.trans.  Rows are padded by 16 bytes (bank groups).
// A lane keeps 16 x D / 32 fp32 sums per gradient: at D <= 128 dK and dV
// are both kept in one pass; at D > 128 the dK/dV kernel runs twice (dV,
// then dK, each recomputing P), with 32-query tiles, to stay in registers.
// Tiles are loaded with cp.async into one buffer each, then waited for.
//
// fp32 runs on FMAs (the fp32 tolerance, 2e-4, rules out TF32), laid out as
// the forward's fp32 kernel: 8 warps, a lane scores one key (dQ) or one
// query (dK/dV) of a 32-wide tile, and keeps output columns lane, lane + 32,
// ... of its warp's 8 rows.
//
// C interface: flash_attention_bwd_launch(...) returns the first CUDA error.
// q, dq (B, Hq, Sq, ld); k, v, dk, dv (B, Hkv, Sk, ld); o, dout
// (B, Hq, Sq, ld); lse, delta (B, Hq, Sq) fp32 (delta is scratch the
// launch fills); all contiguous, head dim D <= ld as in the forward (v, o
// and dout zero-padded to D by the caller when v's head dim is narrower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

__device__ __forceinline__ bool in_range(int key, int qi, int Sk, int Sq,
                                         int causal, int has_window,
                                         int window) {
  bool ok = key < Sk && qi < Sq;
  if (causal) ok = ok && key <= qi;
  if (has_window) ok = ok && key > qi - window;
  return ok;
}

// delta[row] = sum_d dout[row, d] o[row, d]; one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_delta(const T* __restrict__ o,
                              const T* __restrict__ dout,
                              float* __restrict__ delta, int rows, int D,
                              int ld) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * ld;
  const T* drow = dout + static_cast<size_t>(row) * ld;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(orow[d]), to_f(drow[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// The query rows [i_begin, i_end) that see some key of [k0, k0 + nk).
__device__ __forceinline__ void query_range(int k0, int nk, int Sq,
                                            int causal, int has_window,
                                            int window, int* i_begin,
                                            int* i_end) {
  *i_begin = causal ? k0 : 0;
  *i_end = has_window ? min(Sq, k0 + nk - 1 + window) : Sq;
}

// The key tiles [t_begin, t_end) of width bk that some row of
// [q0, q0 + rows) sees (the forward's walk, q_offset = 0).
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sq, int Sk,
                                          int bk, int causal, int has_window,
                                          int window, int* t_begin,
                                          int* t_end) {
  const int q_last = min(q0 + rows, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = max(0, min(k_end, q_last + 1));
  const int k_begin = has_window ? max(0, q0 - window + 1) : 0;
  *t_begin = k_begin / bk;
  *t_end = (k_end + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// fp32 on FMAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kRows = 64;     // rows of the block's own tile
constexpr int kTile = 32;     // rows of the tile it walks: one a lane
constexpr int kRowsPerWarp = kRows / kWarps;

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kRows) * D +
                          2 * static_cast<size_t>(kTile) * (D + 1) +
                          2 * kTile);
}

// dQ: one block a (q tile, batch x query head)
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int Hq, int Hkv, int Sq,
                           int Sk, int D, int causal, int has_window,
                           int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kRows][D]
  float* dos = qs + kRows * D;         // [kRows][D]
  float* ks = dos + kRows * D;         // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);    // [kTile][D + 1]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kRows;
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* dob = dout + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const float* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const bool in = q0 + r < Sq;
    const size_t g = static_cast<size_t>(q0 + r) * D + i % D;
    qs[i] = in ? qb[g] : 0.f;
    dos[i] = in ? dob[g] : 0.f;
  }
  float lse_r[kRowsPerWarp], dl_r[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp + kWarps * i;
    lse_r[i] = row < Sq ? lse[static_cast<size_t>(bh) * Sq + row] : INFINITY;
    dl_r[i] = row < Sq ? delta[static_cast<size_t>(bh) * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  int t_begin, t_end;
  key_tiles(q0, kRows, Sq, Sk, kTile, causal, has_window, window, &t_begin,
            &t_end);

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      ks[r * (D + 1) + d] = in ? kb[g] : 0.f;
      vs[r * (D + 1) + d] = in ? vb[g] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (q0 + r >= Sq) continue;  // warp-uniform
      const float* qr = qs + r * D;
      const float* dr = dos + r * D;
      const float* kr = ks + lane * (D + 1);
      const float* vr = vs + lane * (D + 1);
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dr[d], vr[d], dp);
      }
      const float p = in_range(key, q0 + r, Sk, Sq, causal, has_window, window)
                          ? expf(s * scale - lse_r[i])
                          : 0.f;
      const float ds = p * (dp - dl_r[i]);
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(0xffffffff, ds, j);
        const float* kj = ks + j * (D + 1);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(dsj, kj[d], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (q0 + r >= Sq) continue;
    float* out = dq + (static_cast<size_t>(bh) * Sq + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[d] = acc[i][c] * scale;
    }
  }
}

// dK and dV: one block a (key tile, batch x KV head)
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int Hq, int Hkv, int Sq, int Sk, int D,
                             int causal, int has_window, int window,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kRows][D]
  float* vs = ks + kRows * D;          // [kRows][D]
  float* qs = vs + kRows * D;          // [kTile][D + 1]
  float* dos = qs + kTile * (D + 1);   // [kTile][D + 1]
  float* lse_s = dos + kTile * (D + 1);
  float* dl_s = lse_s + kTile;

  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.x * kRows;
  const float* kb = k + static_cast<size_t>(bhk) * Sk * D;
  const float* vb = v + static_cast<size_t>(bhk) * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const bool in = k0 + r < Sk;
    const size_t g = static_cast<size_t>(k0 + r) * D + i % D;
    ks[i] = in ? kb[g] : 0.f;
    vs[i] = in ? vb[g] : 0.f;
  }
  float acc_k[kRowsPerWarp][kCols], acc_v[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  int i_begin, i_end;
  query_range(k0, kRows, Sq, causal, has_window, window, &i_begin, &i_end);

  for (int gh = 0; gh < G; ++gh) {
    const size_t bh = static_cast<size_t>(b) * Hq + hk * G + gh;
    const float* qb = q + bh * Sq * D;
    const float* dob = dout + bh * Sq * D;
    for (int i0 = i_begin / kTile * kTile; i0 < i_end; i0 += kTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool in = i0 + r < Sq;
        const size_t g = static_cast<size_t>(i0 + r) * D + d;
        qs[r * (D + 1) + d] = in ? qb[g] : 0.f;
        dos[r * (D + 1) + d] = in ? dob[g] : 0.f;
      }
      if (threadIdx.x < kTile) {
        const int r = i0 + threadIdx.x;
        lse_s[threadIdx.x] = r < Sq ? lse[bh * Sq + r] : INFINITY;
        dl_s[threadIdx.x] = r < Sq ? delta[bh * Sq + r] : 0.f;
      }
      __syncthreads();
      const int qi = i0 + lane;
      const float lse_l = lse_s[lane], dl_l = dl_s[lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (k0 + r >= Sk) continue;  // warp-uniform
        const float* kr = ks + r * D;
        const float* vr = vs + r * D;
        const float* ql = qs + lane * (D + 1);
        const float* dl = dos + lane * (D + 1);
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(kr[d], ql[d], s);
          dp = fmaf(vr[d], dl[d], dp);
        }
        const float p = in_range(k0 + r, qi, Sk, Sq, causal, has_window,
                                 window)
                            ? expf(s * scale - lse_l)
                            : 0.f;
        const float ds = p * (dp - dl_l);
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) {
          const float pj = __shfl_sync(0xffffffff, p, j);
          const float dsj = __shfl_sync(0xffffffff, ds, j);
          const float* qj = qs + j * (D + 1);
          const float* dj = dos + j * (D + 1);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int d = lane + 32 * c;
            if (d < D) {
              acc_v[i][c] = fmaf(pj, dj[d], acc_v[i][c]);
              acc_k[i][c] = fmaf(dsj, qj[d], acc_k[i][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (k0 + r >= Sk) continue;
    const size_t off = (static_cast<size_t>(bhk) * Sk + k0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[off + d] = acc_k[i][c] * scale;
        dv[off + d] = acc_v[i][c];
      }
    }
  }
}

template <int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, int causal, int has_window,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaError_t err = hopper::allow_smem<flash_attention_bwd_dkdv<kCols>>(smem);
  if (err != cudaSuccess) return err;
  err = hopper::allow_smem<flash_attention_bwd_dq<kCols>>(smem);
  if (err != cudaSuccess) return err;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fd = static_cast<const float*>(dout);
  flash_attention_bwd_dkdv<kCols><<<dim3((Sk + kRows - 1) / kRows, B * Hkv),
                                    kThreads, smem, stream>>>(
      fq, fk, fv, fd, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hkv, Sq, Sk, D, causal, has_window,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq<kCols><<<dim3((Sq + kRows - 1) / kRows, B * Hq),
                                  kThreads, smem, stream>>>(
      fq, fk, fv, fd, lse, delta, static_cast<float*>(dq), Hq, Hkv, Sq, Sk,
      D, causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kRows = 64;      // rows of the block's own tile

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// A fragment (16 x 16) of rows [row0, row0 + 16), cols [k0, k0 + 16) of a
// row-major tile
template <int kLd>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* t,
                                       int row0, int k0) {
  const int lane = threadIdx.x % 32;
  hopper::ldmatrix_x4(a, t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd +
                             k0 + (lane >> 4) * 8);
}

// B fragments of two 16 x 8 column tiles, columns [n0, n0 + 16), depth
// [k0, k0 + 16), from a tile stored n-major (row n holds B's column n)
template <int kLd>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const bf16* t,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32;
  hopper::ldmatrix_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * kLd + k0 +
                             ((lane >> 3) & 1) * 8);
}

// the same from a tile stored k-major (row k holds B's row k)
template <int kLd>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const bf16* t,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32;
  hopper::ldmatrix_x4_trans(
      b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + n0 +
             (lane >> 4) * 8);
}

// the A fragment of columns [16 j, 16 j + 16) of a 16-row accumulator
// block held as 8-column fragments c[2 j], c[2 j + 1]
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = hopper::pack_bf16x2(c0[0], c0[1]);
  a[1] = hopper::pack_bf16x2(c0[2], c0[3]);
  a[2] = hopper::pack_bf16x2(c1[0], c1[1]);
  a[3] = hopper::pack_bf16x2(c1[2], c1[3]);
}

template <int kDMax>
struct DkdvGeom {
  static constexpr int kLd = kDMax + 8;
  static constexpr int kBQ = kDMax > 128 ? 32 : 64;  // queries a tile
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * static_cast<size_t>(kRows) + 2 * kBQ) * kLd +
      2 * sizeof(float) * kBQ;
};

template <int kDMax>
struct DqGeom {
  static constexpr int kLd = kDMax + 8;
  static constexpr int kBK = kDMax > 128 ? 32 : 64;  // keys a tile
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * static_cast<size_t>(kRows) + 2 * kBK) * kLd;
};

// dK and/or dV (kWhat: 1 = dV, 2 = dK, 3 = both) of one (key tile, batch x
// KV head): warp w owns keys k0 + 16 w ... + 15.
template <int kDMax, int kD16, int kWhat>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_tc(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int Hq, int Hkv, int Sq, int Sk, int D,
                                int ld, int causal, int has_window,
                                int window, float scale_log2, float scale) {
  using Gm = DkdvGeom<kDMax>;
  constexpr int kLd = Gm::kLd, kBQ = Gm::kBQ, kDT = kDMax / 8;
  constexpr int kNT = kBQ / 8;
  constexpr bool kDoV = kWhat & 1, kDoK = kWhat & 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kRows][kLd]
  bf16* vs = ks + kRows * kLd;               // [kRows][kLd]
  bf16* qs = vs + kRows * kLd;               // [kBQ][kLd]
  bf16* dos = qs + kBQ * kLd;                // [kBQ][kLd]
  float* lse2 = reinterpret_cast<float*>(dos + kBQ * kLd);  // [kBQ]
  float* dl = lse2 + kBQ;                                   // [kBQ]

  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int d16 = kD16 ? kD16 : (D + 15) / 16;
  const int nchunk = 2 * d16;
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};

  load_rows<kLd>(ks, k + static_cast<size_t>(bhk) * Sk * ld, Sk, ld, k0,
                 kRows, nchunk);
  if (kDoK)
    load_rows<kLd>(vs, v + static_cast<size_t>(bhk) * Sk * ld, Sk, ld, k0,
                   kRows, nchunk);

  float acc_v[kDT][4], acc_k[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[j][e] = acc_k[j][e] = 0.f;

  int i_begin, i_end;
  query_range(k0, kRows, Sq, causal, has_window, window, &i_begin, &i_end);

  for (int gh = 0; gh < G; ++gh) {
    const size_t bh = static_cast<size_t>(b) * Hq + hk * G + gh;
    const bf16* qb = q + bh * Sq * ld;
    const bf16* dob = dout + bh * Sq * ld;
    for (int i0 = i_begin / kBQ * kBQ; i0 < i_end; i0 += kBQ) {
      __syncthreads();  // the previous tile is consumed
      load_rows<kLd>(qs, qb, Sq, ld, i0, kBQ, nchunk);
      load_rows<kLd>(dos, dob, Sq, ld, i0, kBQ, nchunk);
      if (threadIdx.x < kBQ) {
        const int r = i0 + threadIdx.x;
        lse2[threadIdx.x] = r < Sq ? lse[bh * Sq + r] * kLog2e : INFINITY;
        dl[threadIdx.x] = r < Sq ? delta[bh * Sq + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T: this warp's 16 keys x kBQ queries
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kDMax / 16; ++kd) {
        if (kd >= d16) break;
        uint32_t a[4];
        ldsm_a<kLd>(a, ks, 16 * warp, 16 * kd);
#pragma unroll
        for (int j = 0; j < kBQ / 16; ++j) {
          uint32_t bq[4];
          ldsm_b_nk<kLd>(bq, qs, 16 * j, 16 * kd);
          hopper::mma_16816(s[2 * j], a, bq[0], bq[1]);
          hopper::mma_16816(s[2 * j + 1], a, bq[2], bq[3]);
        }
      }
      // P^T, masked entries 0 (and rows past Sq: lse2 = +inf)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1);
          s[j][e] = in_range(key[e >> 1], i0 + col, Sk, Sq, causal,
                             has_window, window)
                        ? exp2f(s[j][e] * scale_log2 - lse2[col])
                        : 0.f;
        }
      if (kDoV) {
        // dV += P^T dO
#pragma unroll
        for (int jq = 0; jq < kBQ / 16; ++jq) {
          uint32_t a[4];
          pack_a(a, s[2 * jq], s[2 * jq + 1]);
#pragma unroll
          for (int dd = 0; dd < kDMax / 16; ++dd) {
            if (dd >= d16) break;
            uint32_t bo[4];
            ldsm_b_kn<kLd>(bo, dos, 16 * dd, 16 * jq);
            hopper::mma_16816(acc_v[2 * dd], a, bo[0], bo[1]);
            hopper::mma_16816(acc_v[2 * dd + 1], a, bo[2], bo[3]);
          }
        }
      }
      if (kDoK) {
        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place of P^T
        float dp[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < kDMax / 16; ++kd) {
          if (kd >= d16) break;
          uint32_t a[4];
          ldsm_a<kLd>(a, vs, 16 * warp, 16 * kd);
#pragma unroll
          for (int j = 0; j < kBQ / 16; ++j) {
            uint32_t bo[4];
            ldsm_b_nk<kLd>(bo, dos, 16 * j, 16 * kd);
            hopper::mma_16816(dp[2 * j], a, bo[0], bo[1]);
            hopper::mma_16816(dp[2 * j + 1], a, bo[2], bo[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] *= dp[j][e] - dl[8 * j + 2 * tq + (e & 1)];
        // dK += dS^T Q (scaled at the end)
#pragma unroll
        for (int jq = 0; jq < kBQ / 16; ++jq) {
          uint32_t a[4];
          pack_a(a, s[2 * jq], s[2 * jq + 1]);
#pragma unroll
          for (int dd = 0; dd < kDMax / 16; ++dd) {
            if (dd >= d16) break;
            uint32_t bq[4];
            ldsm_b_kn<kLd>(bq, qs, 16 * dd, 16 * jq);
            hopper::mma_16816(acc_k[2 * dd], a, bq[0], bq[1]);
            hopper::mma_16816(acc_k[2 * dd + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // K and V of a block with no query to walk

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const size_t off = (static_cast<size_t>(bhk) * Sk + key[r]) * ld;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < D) {  // c + 1 < ld: ld is a multiple of 8
        if (kDoV)
          *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
              __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
        if (kDoK)
          *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
              __floats2bfloat162_rn(acc_k[j][2 * r] * scale,
                                    acc_k[j][2 * r + 1] * scale);
      }
    }
  }
}

// dQ of one (query tile, batch x query head): warp w owns rows
// q0 + 16 w ... + 15.
template <int kDMax, int kD16>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_tc(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int Hq, int Hkv, int Sq,
                              int Sk, int D, int ld, int causal,
                              int has_window, int window, float scale_log2,
                              float scale) {
  using Gm = DqGeom<kDMax>;
  constexpr int kLd = Gm::kLd, kBK = Gm::kBK, kDT = kDMax / 8;
  constexpr int kNT = kBK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kRows][kLd]
  bf16* dos = qs + kRows * kLd;              // [kRows][kLd]
  bf16* ks = dos + kRows * kLd;              // [kBK][kLd]
  bf16* vs = ks + kBK * kLd;                 // [kBK][kLd]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  // the q tiles with the most keys first, as in the forward
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const bf16* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * ld;
  const bf16* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int d16 = kD16 ? kD16 : (D + 15) / 16;
  const int nchunk = 2 * d16;
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < Sq;
    lse2[r] = in ? lse[static_cast<size_t>(bh) * Sq + row[r]] * kLog2e
                 : INFINITY;
    dl[r] = in ? delta[static_cast<size_t>(bh) * Sq + row[r]] : 0.f;
  }
  load_rows<kLd>(qs, q + static_cast<size_t>(bh) * Sq * ld, Sq, ld, q0,
                 kRows, nchunk);
  load_rows<kLd>(dos, dout + static_cast<size_t>(bh) * Sq * ld, Sq, ld, q0,
                 kRows, nchunk);

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int t_begin, t_end;
  key_tiles(q0, kRows, Sq, Sk, kBK, causal, has_window, window, &t_begin,
            &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed
    load_rows<kLd>(ks, kb, Sk, ld, k0, kBK, nchunk);
    load_rows<kLd>(vs, vb, Sk, ld, k0, kBK, nchunk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x kBK keys a warp
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kDMax / 16; ++kd) {
      if (kd >= d16) break;
      uint32_t aq[4], ao[4];
      ldsm_a<kLd>(aq, qs, 16 * warp, 16 * kd);
      ldsm_a<kLd>(ao, dos, 16 * warp, 16 * kd);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_b_nk<kLd>(bk, ks, 16 * j, 16 * kd);
        ldsm_b_nk<kLd>(bv, vs, 16 * j, 16 * kd);
        hopper::mma_16816(s[2 * j], aq, bk[0], bk[1]);
        hopper::mma_16816(s[2 * j + 1], aq, bk[2], bk[3]);
        hopper::mma_16816(dp[2 * j], ao, bv[0], bv[1]);
        hopper::mma_16816(dp[2 * j + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta), P masked to 0
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
        const float p = in_range(kpos, row[r], Sk, Sq, causal, has_window,
                                 window)
                            ? exp2f(s[j][e] * scale_log2 - lse2[r])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);
      }
    // dQ += dS K (scaled at the end)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      pack_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < kDMax / 16; ++dd) {
        if (dd >= d16) break;
        uint32_t bk[4];
        ldsm_b_kn<kLd>(bk, ks, 16 * dd, 16 * j);
        hopper::mma_16816(acc[2 * dd], a, bk[0], bk[1]);
        hopper::mma_16816(acc[2 * dd + 1], a, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();  // Q and dO of a block with no key to walk

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    bf16* out = dq + (static_cast<size_t>(bh) * Sq + row[r]) * ld;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

template <int kDMax, int kD16, int kWhat>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, bf16* dk, bf16* dv, int B,
                        int Hq, int Hkv, int Sq, int Sk, int D, int ld,
                        int causal, int has_window, int window,
                        float scale_log2, float scale, cudaStream_t stream) {
  constexpr size_t smem = DkdvGeom<kDMax>::kSmem;
  auto kern = flash_attention_bwd_dkdv_tc<kDMax, kD16, kWhat>;
  cudaError_t err = hopper::allow_smem<
      flash_attention_bwd_dkdv_tc<kDMax, kD16, kWhat>>(smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Sk + kRows - 1) / kRows, B * Hkv), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Hq, Hkv, Sq, Sk, D, ld, causal,
      has_window, window, scale_log2, scale);
  return cudaGetLastError();
}

template <int kDMax, int kD16>
cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const void* dout_, const float* lse, const float* delta,
                   void* dq_, void* dk_, void* dv_, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, int ld, int causal, int has_window,
                   int window, cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  bf16* dk = static_cast<bf16*>(dk_);
  bf16* dv = static_cast<bf16*>(dv_);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  cudaError_t err;
  if constexpr (kDMax > 128) {  // dV, then dK: one gradient's sums a pass
    err = launch_dkdv<kDMax, kD16, 1>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Hq, Hkv, Sq, Sk, D, ld, causal,
                                      has_window, window, scale_log2, scale,
                                      stream);
    if (err != cudaSuccess) return err;
    err = launch_dkdv<kDMax, kD16, 2>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Hq, Hkv, Sq, Sk, D, ld, causal,
                                      has_window, window, scale_log2, scale,
                                      stream);
  } else {
    err = launch_dkdv<kDMax, kD16, 3>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Hq, Hkv, Sq, Sk, D, ld, causal,
                                      has_window, window, scale_log2, scale,
                                      stream);
  }
  if (err != cudaSuccess) return err;
  constexpr size_t smem = DqGeom<kDMax>::kSmem;
  err = hopper::allow_smem<flash_attention_bwd_dq_tc<kDMax, kD16>>(smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_tc<kDMax, kD16><<<
      dim3((Sq + kRows - 1) / kRows, B * Hq), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(dq_), Hq, Hkv, Sq, Sk, D,
      ld, causal, has_window, window, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int B, int Hq, int Hkv,
                               int Sq, int Sk, int D, int ld, int causal,
                               int has_window, int window, int dtype,
                               void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || B * Hq > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int rows = B * Hq * Sq;
  if (dtype == 0) {
    if (ld != D) return cudaErrorInvalidValue;
    flash_attention_bwd_delta<float><<<(rows + 7) / 8, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        delta_f, rows, D, ld);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return (D > 128 ? f32::launch<8> : f32::launch<4>)(
        q, k, v, dout, lse_f, delta_f, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D,
        causal, has_window, window, s);
  }
  if (dtype == 1) {
    if (ld % 8 != 0 || ld < D || ld > (D + 7) / 8 * 8)
      return cudaErrorInvalidValue;
    flash_attention_bwd_delta<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta_f, rows, D, ld);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the forward's dispatch: the served head dims' slice counts compiled
    // in, every other head dim by its width class
    auto run = D > 128 ? tc::launch<256, 0>
                       : (D > 64 ? tc::launch<128, 0> : tc::launch<64, 0>);
    switch ((D + 15) / 16) {
      case 5: run = tc::launch<128, 5>; break;
      case 6: run = tc::launch<128, 6>; break;
      case 8: run = tc::launch<128, 8>; break;
      case 16: run = tc::launch<256, 16>; break;
      default: break;
    }
    return run(q, k, v, dout, lse_f, delta_f, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
               D, ld, causal, has_window, window, s);
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
