// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// with respect to q, k and v.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// its train path differentiates the plain blocked attention
// (src/repro/models/attention.py, flash_attention_ref) with XLA's autodiff,
// which keeps the (Sq, Sk) probabilities of every head.  This file
// recomputes them instead, tile by tile, from the log-sum-exp the forward
// kernel writes (FlashAttention-2's backward), so nothing of size S^2
// reaches device memory:
//
//   P  = exp(S * scale - lse)        S = Q K^T, masked entries 0
//   dV = P^T dO                      dP = dO V^T
//   dS = P * (dP - delta)            delta_i = sum_d dO_i,d O_i,d
//   dQ = scale dS K                  dK = scale dS^T Q
//
// What bounds it on an H100: five products of 2 Sq Sk D operations a head
// (half of that under a causal mask) against about 10 S D elements moved.
// At the training shapes (S = 512, D = 64..128) the two bounds are within
// 2x of each other and both are a few microseconds; what the kernels have
// to avoid is idle SMs and loads that stall the products.
//
// The design:
//  * a prologue launch computes delta (one warp a row), zeroes the
//    counters, and in fp32 writes dQ = 0 for the rows of query tiles that
//    no key tile sees (no item reaches them);
//  * dK and dV: a work item is one (key tile of 64 keys, batch, query
//    head); items run in the order (key tile, batch, head), claimed from a
//    counter where one may wait on another (GQA, fp32's dQ), so the
//    heaviest key tiles of a causal mask start first,
//    and every training shape launches at least 256 blocks: GQA's heads
//    are items of their own, not a serial walk inside one block.  An item
//    walks the query tiles that see its keys, from the last to the first.
//    S^T = K Q^T is computed key-major, so P^T and dS^T come out as
//    accumulator fragments that feed dV += P^T dO and dK += dS^T Q from
//    registers.  A GQA group's heads add their dK and dV in head order
//    through fp32 sums and a counter per (batch, KV head, key tile): a head
//    waits until the count equals its rank, adds, and bumps it; the last
//    writes dK and dV.  With one head a group the item writes them itself;
//  * dQ, fp32 (namespace f32): in the same pass.  Each (query tile, key
//    tile) pair adds its share into dQ in a fixed order, key tile
//    ascending, through a counter per query tile in the same way; every
//    key tile of a head walks the query tiles in one order, so the shares
//    of a query tile arrive nearly together.  Five products;
//  * dQ, bf16 (namespace tc): a pass of its own, one block a (query tile of
//    64 rows, batch, head) walking the key tiles its rows see, S and dP
//    recomputed (seven products in all).  The ordered sum of the fp32 path
//    measured slower in bf16 at eight of the nine shapes of chip_smoke.py
//    phase 5 (a): a bf16 tile pair's products take about as long as the
//    round trip to L2 that each share adds to the chain of its query tile;
//  * integer atomics schedule, no floating-point atomics: every sum has a
//    fixed order, and two calls give the same bits;
//  * the dK/dV pass streams Q, dO and the rows' lse and delta through a
//    ring of two stages (cp.async, one mbarrier a stage, as the forward
//    streams K and V), so the next tile loads while this one is
//    multiplied; the bf16 dQ pass keeps one buffer, three blocks an SM;
//  * a block only ever waits on an item claimed before its own, and a
//    claimed item is held by a running block, so the waits always end.
// A row with no key in range (lse = +inf) has P = 0, so it gives zero
// gradients, never NaN.  Semantics are the forward's with q_offset = 0:
// scale 1/sqrt(D), causal keeps k <= q, a window keeps k > q - window.
//
// bf16 runs on the tensor cores, mma.sync m16n8k16 with fp32 accumulators,
// four warps, each owning 16 keys (dK/dV) or 16 query rows (dQ); query
// tiles of 64 rows (32 in the dK/dV pass at D > 128).  The A operands of
// dV and dK are P^T and dS^T packed to bf16 in registers; wgmma would take
// A from registers only in its own 64-row layout over a warpgroup, which
// the key-major S^T of four 16-key warps does not give, so mma.sync stays.
// A lane keeps 16 x D / 32 fp32 sums per gradient: at D <= 128 dK and dV
// are both kept in the one pass; at D > 128 the dK/dV pass runs twice (dV,
// then dK), each recomputing P, to stay in registers.
//
// fp32 runs on FMAs (the fp32 tolerance, 2e-4, rules out TF32): 256
// threads as a 16 x 16 grid, each owning a 4 x (tile / 16) micro-tile of
// S^T and dP^T, a 4 x (D / 16) micro-tile of dK and dV and a (tile / 16) x
// (D / 16) one of the dQ share, read from shared memory rows padded to an
// odd length; P^T and dS^T go through shared memory; query tiles of 64, 32
// or 16 rows as D grows to 64, 128 or 256.
//
// C interface: flash_attention_bwd_launch(...) returns the first CUDA error.
// q, dq (B, Hq, Sq, ld); k, v, dk, dv (B, Hkv, Sk, ld); o, dout
// (B, Hq, Sq, ld); lse, delta (B, Hq, Sq) fp32 (delta is scratch the
// launch fills); all contiguous, head dim D <= ld as in the forward (v, o
// and dout zero-padded to D by the caller when v's head dim is narrower).
// counters (int32) and scratch (fp32) are the caller's, of at least the
// sizes kernels/flash_attention/plan.py gives; the launch checks them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr int kBK = 64;       // keys a work item
constexpr int kBQRows = 64;   // query rows a block of the bf16 dQ pass
constexpr float kLog2e = 1.4426950408889634f;

// The shape of a call and its tiling: nk key tiles of kBK; nq query tiles
// of the height whose dQ counters the call keeps (fp32's one pass).
struct Shape {
  int B, Hq, Hkv, Sq, Sk, D, ld, causal, has_window, window, nq, nk;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

__device__ __forceinline__ bool in_range(int key, int qi, const Shape& p) {
  bool ok = key < p.Sk && qi < p.Sq;
  if (p.causal) ok = ok && key <= qi;
  if (p.has_window) ok = ok && key > qi - p.window;
  return ok;
}

// The keys [kb, ke) that some row of query tile i (bq rows) sees (a
// contiguous range: row r sees (r - window, r] or (r - window, Sk)), or an
// empty range (0, 0) when no row of it sees a key.
__device__ __forceinline__ void key_bounds(int i, int bq, const Shape& p,
                                           int* kb, int* ke) {
  const int q0 = i * bq;
  const int q_last = min(q0 + bq, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.has_window ? max(0, q0 - p.window + 1) : 0;
  const bool none = q0 >= p.Sq || k_begin >= k_end;
  *kb = none ? 0 : k_begin;
  *ke = none ? 0 : k_end;
}

// The key tiles [tb, te) of kBK keys that some row of query tile i sees.
__device__ __forceinline__ void key_tiles(int i, int bq, const Shape& p,
                                          int* tb, int* te) {
  int kb, ke;
  key_bounds(i, bq, p, &kb, &ke);
  *tb = kb / kBK;
  *te = (ke + kBK - 1) / kBK;
}

// The query tiles [ia, ib) (of bq rows) whose key tiles include kt: a
// contiguous range, since both ends of key_tiles grow with i and the tiles
// that see no key come last.
__device__ __forceinline__ void walk_range(int kt, int bq, const Shape& p,
                                           int* ia, int* ib) {
  const int nq = (p.Sq + bq - 1) / bq;
  int a = nq, b = 0;
  for (int i = 0; i < nq; ++i) {
    int tb, te;
    key_tiles(i, bq, p, &tb, &te);
    if (tb <= kt && kt < te) {
      a = min(a, i);
      b = i + 1;
    }
  }
  *ia = a;
  *ib = max(a, b);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Block-wide: wait until *sem == v.  Thread 0 polls; after about 10 s (a
// share that will never come) it traps, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void sem_wait(const int* sem, int v) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(sem) != v) {
      __nanosleep(32);
      if (clock64() - start > (1ll << 34)) __trap();
    }
  }
  __syncthreads();
}

// Block-wide: every thread's stores so far are visible, then *sem = v.
__device__ __forceinline__ void sem_post(int* sem, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    st_release(sem, v);
  }
}

using tile_ring::cp_async4;  // 4-byte copy, zero-filled past src_bytes

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// lse and delta of rows [r0, r0 + rows) of one head into ls and ds; rows
// past R arrive as 0 (they are masked)
template <int kThreads>
__device__ __forceinline__ void load_row_floats(float* ls, float* ds,
                                                const float* lse,
                                                const float* delta, int R,
                                                int r0, int rows) {
  for (int r = threadIdx.x; r < 2 * rows; r += kThreads) {
    const int rr = r < rows ? r : r - rows;
    const bool in = r0 + rr < R;
    const float* src = (r < rows ? lse : delta) + (in ? r0 + rr : 0);
    cp_async4((r < rows ? ls : ds) + rr, src, in ? 4 : 0);
  }
}

// The item a block works on: its key tile, batch row and query head.  When
// items wait on each other (`waits`), a block claims the next one from a
// counter, so that every item it may wait on was claimed before, by a
// running block; otherwise its launch index is its item.
struct Item {
  int kt, bh, G, gh;  // key tile, batch x head, group size, head in group
  size_t bhk;         // batch x KV head
};

__device__ __forceinline__ Item claim(int* work, int* slot, const Shape& p,
                                      bool waits) {
  int item = blockIdx.x;
  if (waits) {
    if (threadIdx.x == 0) *slot = atomicAdd(work, 1);
    __syncthreads();
    item = *slot;
  }
  Item it;
  const int BH = p.B * p.Hq;
  it.kt = item / BH;
  it.bh = item % BH;
  const int b = it.bh / p.Hq, h = it.bh % p.Hq;
  it.G = p.Hq / p.Hkv;
  it.gh = h % it.G;
  it.bhk = static_cast<size_t>(b) * p.Hkv + h / it.G;
  return it;
}

// delta[row] = sum_d dout[row, d] o[row, d] (one warp a row); the counters
// zeroed; with (fp32) dq given, its rows of query tiles (bq rows) that no
// key tile sees set to 0.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_prep(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, float* __restrict__ dq,
                             int* __restrict__ counters, int n_counters,
                             Shape p, int bq) {
  const int gid = blockIdx.x * 256 + threadIdx.x;
  if (gid < n_counters) counters[gid] = 0;
  const int rows = p.B * p.Hq * p.Sq;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * p.ld;
  const T* drow = dout + static_cast<size_t>(row) * p.ld;
  float s = 0.f;
  for (int d = lane; d < p.D; d += 32)
    s = fmaf(to_f(orow[d]), to_f(drow[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
  if (dq == nullptr) return;
  int kb, ke;
  key_bounds((row % p.Sq) / bq, bq, p, &kb, &ke);
  if (kb >= ke)
    for (int d = lane; d < p.ld; d += 32)
      dq[static_cast<size_t>(row) * p.ld + d] = 0.f;
}

// ---------------------------------------------------------------------------
// fp32 on FMAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kStages = 2;

template <int kCols>  // columns a thread keeps: D <= 16 kCols
struct Geom {
  static constexpr int kLd = 16 * kCols + 1;  // odd: no bank conflicts
  static constexpr int kBQ = kCols == 4 ? 64 : (kCols == 8 ? 32 : 16);
  static constexpr int kLdP = kBQ + 1;
  static constexpr size_t kOffK = 128;  // mbarriers and the item first
  static constexpr size_t kOffV = kOffK + sizeof(float) * kBK * kLd;
  static constexpr size_t kOffQ = kOffV + sizeof(float) * kBK * kLd;
  static constexpr size_t kStage = 2 * sizeof(float) * kBQ * kLd;  // Q, dO
  static constexpr size_t kOffF = kOffQ + kStages * kStage;  // lse, delta
  static constexpr size_t kOffP = kOffF + kStages * 2 * sizeof(float) * kBQ;
  static constexpr size_t kOffS = kOffP + sizeof(float) * kBK * kLdP;
  static constexpr size_t kSmem = kOffS + sizeof(float) * kBK * kLdP;
};

// rows [r0, r0 + rows) of a (R, D) matrix into rows of kLd; rows past R
// arrive as zeros
template <int kLd>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int R,
                                          int D, int r0, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const bool in = r0 + r < R;
    cp_async4(dst + r * kLd + c,
              in ? src + static_cast<size_t>(r0 + r) * D + c : src,
              in ? 4 : 0);
  }
}

template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_f32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int* __restrict__ work,
                            int* __restrict__ cnt_q, int* __restrict__ cnt_kv,
                            Shape p, float scale_log2, float scale) {
  using Gm = Geom<kCols>;
  constexpr int kLd = Gm::kLd, kBQ = Gm::kBQ, kLdP = Gm::kLdP;
  constexpr int kQR = kBQ / 16;  // query rows (columns of S^T) a thread
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ks = reinterpret_cast<float*>(smem + Gm::kOffK);  // [kBK][kLd]
  float* vs = reinterpret_cast<float*>(smem + Gm::kOffV);  // [kBK][kLd]
  float* ps = reinterpret_cast<float*>(smem + Gm::kOffP);  // P^T [kBK][kLdP]
  float* dss = reinterpret_cast<float*>(smem + Gm::kOffS); // dS^T
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int D = p.D;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) tile_ring::mbar_init(bar + s, kThreads);
    tile_ring::mbar_init_fence();
  }
  const Item it = claim(work, reinterpret_cast<int*>(smem + 64), p, true);
  const int k0 = it.kt * kBK;
  const float* qb = q + static_cast<size_t>(it.bh) * p.Sq * D;
  const float* dob = dout + static_cast<size_t>(it.bh) * p.Sq * D;
  const float* lseb = lse + static_cast<size_t>(it.bh) * p.Sq;
  const float* dlb = delta + static_cast<size_t>(it.bh) * p.Sq;

  int ia, ib;
  walk_range(it.kt, kBQ, p, &ia, &ib);
  const int n = ib - ia;
  auto stage = [&](int s) {
    return reinterpret_cast<float*>(smem + Gm::kOffQ + s * Gm::kStage);
  };
  auto rowf = [&](int s) {
    return reinterpret_cast<float*>(smem + Gm::kOffF +
                                    s * 2 * sizeof(float) * kBQ);
  };
  auto fill = [&](int s, int i) {
    float* qs = stage(s);
    load_rows<kLd>(qs, qb, p.Sq, D, i * kBQ, kBQ);
    load_rows<kLd>(qs + kBQ * kLd, dob, p.Sq, D, i * kBQ, kBQ);
    load_row_floats<kThreads>(rowf(s), rowf(s) + kBQ, lseb, dlb, p.Sq,
                              i * kBQ, kBQ);
    tile_ring::cp_async_arrive(bar + s);
  };
  if (n > 0) {
    load_rows<kLd>(ks, k + it.bhk * p.Sk * D, p.Sk, D, k0, kBK);
    load_rows<kLd>(vs, v + it.bhk * p.Sk * D, p.Sk, D, k0, kBK);
    for (int s = 0; s < kStages && s < n; ++s) fill(s, ib - 1 - s);
  }

  float acc_v[4][kCols], acc_k[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_v[a][c] = acc_k[a][c] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int i = ib - 1 - u, q0 = i * kBQ, st = u % kStages;
    hopper::mbar_wait_or_trap(bar + st, (u / kStages) & 1);
    const float* qs = stage(st);
    const float* dos = qs + kBQ * kLd;
    const float* ls = rowf(st);
    const float* dls = ls + kBQ;

    // S^T = K Q^T and dP^T = V dO^T: keys ty + 16 a, queries tx + 16 c
    float s[4][kQR], dp[4][kQR];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kQR; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kr[4], vr[4], qr[kQR], dr[kQR];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kr[a] = ks[(ty + 16 * a) * kLd + d];
        vr[a] = vs[(ty + 16 * a) * kLd + d];
      }
#pragma unroll
      for (int c = 0; c < kQR; ++c) {
        qr[c] = qs[(tx + 16 * c) * kLd + d];
        dr[c] = dos[(tx + 16 * c) * kLd + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kQR; ++c) {
          s[a][c] = fmaf(kr[a], qr[c], s[a][c]);
          dp[a][c] = fmaf(vr[a], dr[c], dp[a][c]);
        }
    }
    // P^T and dS^T = P^T (dP^T - delta) to shared memory
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kQR; ++c) {
        const int col = tx + 16 * c;
        const float pv =
            in_range(k0 + ty + 16 * a, q0 + col, p)
                ? exp2f(fmaf(s[a][c], scale_log2, -ls[col] * kLog2e))
                : 0.f;
        ps[(ty + 16 * a) * kLdP + col] = pv;
        dss[(ty + 16 * a) * kLdP + col] = pv * (dp[a][c] - dls[col]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 16 a, columns tx + 16 c
    for (int r = 0; r < kBQ; ++r) {
      float pa[4], da[4], ob[kCols], qv[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[(ty + 16 * a) * kLdP + r];
        da[a] = dss[(ty + 16 * a) * kLdP + r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ob[c] = dos[r * kLd + tx + 16 * c];
        qv[c] = qs[r * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[a][c] = fmaf(pa[a], ob[c], acc_v[a][c]);
          acc_k[a][c] = fmaf(da[a], qv[c], acc_k[a][c]);
        }
    }
    // this key tile's share of dQ = dS K: rows ty + 16 a, columns tx + 16 c
    float sh[kQR][kCols];
#pragma unroll
    for (int a = 0; a < kQR; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sh[a][c] = 0.f;
    for (int key = 0; key < kBK; ++key) {
      float da[kQR], kv[kCols];
#pragma unroll
      for (int a = 0; a < kQR; ++a) da[a] = dss[key * kLdP + ty + 16 * a];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[key * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sh[a][c] = fmaf(da[a], kv[c], sh[a][c]);
    }
    // added in key-tile order; the last share scales and leaves dQ final
    int tb, te;
    key_tiles(i, kBQ, p, &tb, &te);
    const int rank = it.kt - tb;
    const bool last = it.kt == te - 1;
    int* sem = cnt_q + static_cast<size_t>(it.bh) * p.nq + i;
    if (rank > 0) {
      sem_wait(sem, rank);
      // every earlier share's sum first, in one round trip
#pragma unroll
      for (int a = 0; a < kQR; ++a) {
        const int row = q0 + ty + 16 * a;
        const float* in = dq + (static_cast<size_t>(it.bh) * p.Sq + row) * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (row < p.Sq && tx + 16 * c < D) sh[a][c] += __ldcg(in + tx + 16 * c);
      }
    }
#pragma unroll
    for (int a = 0; a < kQR; ++a) {
      const int row = q0 + ty + 16 * a;
      if (row >= p.Sq) continue;
      float* out = dq + (static_cast<size_t>(it.bh) * p.Sq + row) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) __stcg(out + col, last ? sh[a][c] * scale : sh[a][c]);
      }
    }
    sem_post(sem, rank + 1);  // also: every thread is done with stage st
    if (u + kStages < n) fill(st, ib - 1 - (u + kStages));
  }
  cp_async_wait_all();

  // dK and dV: the group's heads add their shares in head order
  int* sem = cnt_kv + it.bhk * p.nk + it.kt;
  const bool last = it.gh == it.G - 1;
  if (it.gh > 0) {
    sem_wait(sem, it.gh);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t off = (it.bhk * p.Sk + k0 + ty + 16 * a) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (k0 + ty + 16 * a < p.Sk && tx + 16 * c < D) {
          acc_v[a][c] += __ldcg(dv + off + tx + 16 * c);
          acc_k[a][c] += __ldcg(dk + off + tx + 16 * c);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= p.Sk) continue;
    const size_t off = (it.bhk * p.Sk + key) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= D) continue;
      __stcg(dv + off + col, acc_v[a][c]);
      __stcg(dk + off + col, last ? acc_k[a][c] * scale : acc_k[a][c]);
    }
  }
  if (it.G > 1) sem_post(sem, it.gh + 1);
}

template <int kCols>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, float* dk, float* dv, int* counters,
                   const Shape& p, cudaStream_t stream) {
  constexpr size_t smem = Geom<kCols>::kSmem;
  cudaError_t err = hopper::allow_smem<flash_attention_bwd_f32<kCols>>(smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(p.D));
  // counters: the work counter, the dK/dV counters, the dQ counters
  int* cnt_kv = counters + 2;
  int* cnt_q = cnt_kv + 2 * static_cast<size_t>(p.B) * p.Hkv * p.nk;
  flash_attention_bwd_f32<kCols>
      <<<p.nk * p.B * p.Hq, kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, dq, dk, dv, counters, cnt_q, cnt_kv, p,
          kLog2e * scale, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kStages = 2;

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

// Stores a 16-row accumulator block held as 8-column fragments c[j] (rows
// row0 + g and + 8, columns 8 j + 2 tq and + 1), j < jmax, into an fp32
// tile with row stride kLdF.
template <int kLdF, int kJ>
__device__ __forceinline__ void put_frags(float* t, int row0,
                                          const float (&c)[kJ][4], int jmax) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j >= jmax) break;
    float* p = t + (row0 + g) * kLdF + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(p) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(p + 8 * kLdF) = make_float2(c[j][2], c[j][3]);
  }
}

// Adds rows [0, rows) x columns [0, ld) of the fp32 tile t (row stride
// kLdF) to the running sum at sum + base (row stride ld, a multiple of 8)
// unless this is the first share, and stores the result there or, for the
// last share, writes it times `scale` as bf16 to out + base.  The whole
// block takes part, 16 bytes a thread at a time, each batch's loads issued
// together, so a share costs about one round trip to L2.
template <int kLdF>
__device__ __forceinline__ void add_tile(const float* t, float* sum, bf16* out,
                                         size_t base, int rows, int ld,
                                         float scale, bool first, bool last) {
  constexpr int kBatch = 8;
  const int n4 = ld / 4, total = rows * n4;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kBatch) {
    float4 prev[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      prev[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!first && e < total)
        prev[u] = __ldcg(reinterpret_cast<const float4*>(
            sum + base + static_cast<size_t>(e / n4) * ld + 4 * (e % n4)));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int r = e / n4, c = 4 * (e % n4);
      const float4 s4 = *reinterpret_cast<const float4*>(t + r * kLdF + c);
      const float4 x = make_float4(s4.x + prev[u].x, s4.y + prev[u].y,
                                   s4.z + prev[u].z, s4.w + prev[u].w);
      const size_t i = base + static_cast<size_t>(r) * ld + c;
      if (last)
        *reinterpret_cast<uint2*>(out + i) =
            make_uint2(hopper::pack_bf16x2(x.x * scale, x.y * scale),
                       hopper::pack_bf16x2(x.z * scale, x.w * scale));
      else
        __stcg(reinterpret_cast<float4*>(sum + i), x);
    }
  }
}

template <int kDMax, int kD16>
struct Geom {
  static constexpr int kDPad = kD16 ? 16 * kD16 : kDMax;  // columns kept
  static constexpr int kLd = kDPad + 8;  // 16 bytes of padding a row
  static constexpr int kLdF = kDPad + 4;  // fp32 dK/dV tiles (in the ring)
  // the dK/dV pass: a tile of kBQ queries a stage (Q, dO, lse, delta)
  static constexpr int kBQ = kDMax > 128 ? 32 : 64;
  static constexpr size_t kOffK = 128;  // mbarriers and the item first
  static constexpr size_t kOffV = kOffK + sizeof(bf16) * kBK * kLd;
  static constexpr size_t kOffQ = kOffV + sizeof(bf16) * kBK * kLd;
  static constexpr size_t kStage = 2 * sizeof(bf16) * kBQ * kLd;
  static constexpr size_t kOffF = kOffQ + kStages * kStage;
  static constexpr size_t kSmem = kOffF + kStages * 2 * sizeof(float) * kBQ;
  // the dQ pass: 64 query rows a block (Q, dO), a tile of kBKq keys (K, V)
  static constexpr int kBKq = kDMax > 128 ? 32 : 64;
  static constexpr size_t kSmemQ =
      2 * sizeof(bf16) * (kBQRows + kBKq) * static_cast<size_t>(kLd);
};

// dK and/or dV (kWhat: 3 = both, 1 = dV, 2 = dK) of one work item; warp w
// owns keys k0 + 16 w ... + 15 of it.
template <int kDMax, int kD16, int kWhat>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_tc(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                float* __restrict__ sum_k,
                                float* __restrict__ sum_v,
                                int* __restrict__ work,
                                int* __restrict__ cnt_kv, Shape p,
                                float scale_log2, float scale) {
  using Gm = Geom<kDMax, kD16>;
  constexpr int kLd = Gm::kLd, kBQ = Gm::kBQ;
  constexpr int kDT = Gm::kDPad / 8, kNT = kBQ / 8;
  constexpr bool kDoV = kWhat & 1, kDoK = kWhat & 2;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + Gm::kOffK);  // [kBK][kLd]
  bf16* vs = reinterpret_cast<bf16*>(smem + Gm::kOffV);  // [kBK][kLd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) tile_ring::mbar_init(bar + s, kThreads);
    tile_ring::mbar_init_fence();
  }
  // with one head a group no item waits on another: launch order will do
  const Item it =
      claim(work, reinterpret_cast<int*>(smem + 64), p, p.Hq > p.Hkv);
  __syncthreads();  // the mbarriers are initialised
  const int k0 = it.kt * kBK;
  const bf16* qb = q + static_cast<size_t>(it.bh) * p.Sq * p.ld;
  const bf16* dob = dout + static_cast<size_t>(it.bh) * p.Sq * p.ld;
  const float* lseb = lse + static_cast<size_t>(it.bh) * p.Sq;
  const float* dlb = delta + static_cast<size_t>(it.bh) * p.Sq;
  // 16-wide column slices in use: compiled in for the common head dims
  const int d16 = kD16 ? kD16 : (p.D + 15) / 16;
  const int nchunk = 2 * d16;  // 16-byte chunks a row
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};

  int ia, ib;
  walk_range(it.kt, kBQ, p, &ia, &ib);
  const int n = ib - ia;
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + Gm::kOffQ + s * Gm::kStage);
  };
  auto rowf = [&](int s) {
    return reinterpret_cast<float*>(smem + Gm::kOffF +
                                    s * 2 * sizeof(float) * kBQ);
  };
  auto fill = [&](int s, int i) {
    bf16* qs = stage(s);
    load_rows<kLd>(qs, qb, p.Sq, p.ld, i * kBQ, kBQ, nchunk);
    load_rows<kLd>(qs + kBQ * kLd, dob, p.Sq, p.ld, i * kBQ, kBQ, nchunk);
    load_row_floats<kThreads>(rowf(s), rowf(s) + kBQ, lseb, dlb, p.Sq,
                              i * kBQ, kBQ);
    tile_ring::cp_async_arrive(bar + s);  // the first also covers K and V
  };
  if (n > 0) {
    load_rows<kLd>(ks, k + it.bhk * p.Sk * p.ld, p.Sk, p.ld, k0, kBK,
                   nchunk);
    if (kDoK)
      load_rows<kLd>(vs, v + it.bhk * p.Sk * p.ld, p.Sk, p.ld, k0, kBK,
                     nchunk);
    for (int s = 0; s < kStages && s < n; ++s) fill(s, ib - 1 - s);
  }

  float acc_v[kDT][4], acc_k[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[j][e] = acc_k[j][e] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int i = ib - 1 - u, q0 = i * kBQ, st = u % kStages;
    hopper::mbar_wait_or_trap(bar + st, (u / kStages) & 1);
    const bf16* qs = stage(st);
    const bf16* dos = qs + kBQ * kLd;
    const float* ls = rowf(st);
    const float* dls = ls + kBQ;

    // S^T = K Q^T: this warp's 16 keys x kBQ queries
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < Gm::kDPad / 16; ++kd) {
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
    // P^T, masked entries 0 (rows past Sq are masked too)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        s[j][e] = in_range(key[e >> 1], q0 + col, p)
                      ? exp2f(fmaf(s[j][e], scale_log2, -ls[col] * kLog2e))
                      : 0.f;
      }
    if (kDoV) {
      // dV += P^T dO
#pragma unroll
      for (int jq = 0; jq < kBQ / 16; ++jq) {
        uint32_t a[4];
        pack_a(a, s[2 * jq], s[2 * jq + 1]);
#pragma unroll
        for (int dd = 0; dd < Gm::kDPad / 16; ++dd) {
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
      for (int kd = 0; kd < Gm::kDPad / 16; ++kd) {
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
          s[j][e] *= dp[j][e] - dls[8 * j + 2 * tq + (e & 1)];
      // dK += dS^T Q (scaled at the end)
#pragma unroll
      for (int jq = 0; jq < kBQ / 16; ++jq) {
        uint32_t a[4];
        pack_a(a, s[2 * jq], s[2 * jq + 1]);
#pragma unroll
        for (int dd = 0; dd < Gm::kDPad / 16; ++dd) {
          if (dd >= d16) break;
          uint32_t bq[4];
          ldsm_b_kn<kLd>(bq, qs, 16 * dd, 16 * jq);
          hopper::mma_16816(acc_k[2 * dd], a, bq[0], bq[1]);
          hopper::mma_16816(acc_k[2 * dd + 1], a, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (u + kStages < n) fill(st, ib - 1 - (u + kStages));
  }
  cp_async_wait_all();

  // dK and dV: written directly with one head a group; else the group's
  // heads add their shares in head order, through fp32 tiles in the ring
  if (it.G == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= p.Sk) continue;
      const size_t off = (it.bhk * p.Sk + key[r]) * p.ld;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const int c = 8 * j + 2 * tq;
        if (j >= 2 * d16 || c >= p.ld) continue;  // ld is a multiple of 8
        if (kDoV)
          *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
              __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
        if (kDoK)
          *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
              __floats2bfloat162_rn(acc_k[j][2 * r] * scale,
                                    acc_k[j][2 * r + 1] * scale);
      }
    }
    return;
  }
  static_assert((kDoV + kDoK) * sizeof(float) * kBK * Gm::kLdF <=
                    kStages * Gm::kStage,
                "the dK and dV tiles fit in the ring");
  __syncthreads();  // every warp is done with the ring
  float* shv = reinterpret_cast<float*>(smem + Gm::kOffQ);
  float* shk = shv + (kDoV ? kBK * Gm::kLdF : 0);
  if (kDoV) put_frags<Gm::kLdF>(shv, 16 * warp, acc_v, 2 * d16);
  if (kDoK) put_frags<Gm::kLdF>(shk, 16 * warp, acc_k, 2 * d16);
  int* sem = cnt_kv + it.bhk * p.nk + it.kt;
  if (it.gh > 0)
    sem_wait(sem, it.gh);  // and the heads before this one have added
  else
    __syncthreads();
  const size_t base = (it.bhk * p.Sk + k0) * p.ld;
  const int rows = min(kBK, p.Sk - k0);
  const bool first = it.gh == 0, last = it.gh == it.G - 1;
  if (kDoV)
    add_tile<Gm::kLdF>(shv, sum_v, dv, base, rows, p.ld, 1.f, first, last);
  if (kDoK)
    add_tile<Gm::kLdF>(shk, sum_k, dk, base, rows, p.ld, scale, first, last);
  sem_post(sem, it.gh + 1);
}

// dQ of one (query tile of 64 rows, batch x query head), walking the key
// tiles its rows see; warp w owns rows q0 + 16 w ... + 15.  Three products
// a pair (S, dP, dQ).  One buffer a tile: three blocks fit an SM and hide
// each other's loads (a two-stage ring left room for two and measured
// slower).
template <int kDMax, int kD16>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_tc(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, Shape p,
                              float scale_log2, float scale) {
  using Gm = Geom<kDMax, kD16>;
  constexpr int kLd = Gm::kLd, kBKq = Gm::kBKq;
  constexpr int kNT = kBKq / 8, kDT = Gm::kDPad / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kBQRows][kLd]
  bf16* dos = qs + kBQRows * kLd;            // [kBQRows][kLd]
  bf16* ks = dos + kBQRows * kLd;            // [kBKq][kLd]
  bf16* vs = ks + kBKq * kLd;                // [kBKq][kLd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / (p.Hq / p.Hkv);
  // the query tiles with the most keys first, as in the forward
  const int i = gridDim.x - 1 - blockIdx.x, q0 = i * kBQRows;
  int kb0, ke0;
  key_bounds(i, kBQRows, p, &kb0, &ke0);
  // none for a tile no key reaches: its dQ is written as zeros
  const int t_begin = kb0 / kBKq, t_end = (ke0 + kBKq - 1) / kBKq;
  const bf16* kb = k + (static_cast<size_t>(b) * p.Hkv + hk) * p.Sk * p.ld;
  const bf16* vb = v + (static_cast<size_t>(b) * p.Hkv + hk) * p.Sk * p.ld;
  const int d16 = kD16 ? kD16 : (p.D + 15) / 16;
  const int nchunk = 2 * d16;
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Sq;
    lse2[r] = in ? lse[static_cast<size_t>(bh) * p.Sq + row[r]] * kLog2e
                 : INFINITY;
    dl[r] = in ? delta[static_cast<size_t>(bh) * p.Sq + row[r]] : 0.f;
  }
  if (t_begin < t_end) {
    load_rows<kLd>(qs, q + static_cast<size_t>(bh) * p.Sq * p.ld, p.Sq,
                   p.ld, q0, kBQRows, nchunk);
    load_rows<kLd>(dos, dout + static_cast<size_t>(bh) * p.Sq * p.ld, p.Sq,
                   p.ld, q0, kBQRows, nchunk);
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBKq;
    __syncthreads();  // the previous tile is consumed
    load_rows<kLd>(ks, kb, p.Sk, p.ld, k0, kBKq, nchunk);
    load_rows<kLd>(vs, vb, p.Sk, p.ld, k0, kBKq, nchunk);
    cp_async_wait_all();
    __syncthreads();
    // S = Q K^T and dP = dO V^T: 16 rows x kBKq keys a warp
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < Gm::kDPad / 16; ++kd) {
      if (kd >= d16) break;
      uint32_t aq[4], ao[4];
      ldsm_a<kLd>(aq, qs, 16 * warp, 16 * kd);
      ldsm_a<kLd>(ao, dos, 16 * warp, 16 * kd);
#pragma unroll
      for (int j = 0; j < kBKq / 16; ++j) {
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
        const float pv =
            in_range(k0 + 8 * j + 2 * tq + (e & 1), row[r], p)
                ? exp2f(fmaf(s[j][e], scale_log2, -lse2[r]))
                : 0.f;
        s[j][e] = pv * (dp[j][e] - dl[r]);
      }
    // dQ += dS K (scaled at the end)
#pragma unroll
    for (int j = 0; j < kBKq / 16; ++j) {
      uint32_t a[4];
      pack_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < Gm::kDPad / 16; ++dd) {
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
    if (row[r] >= p.Sq) continue;
    bf16* out = dq + (static_cast<size_t>(bh) * p.Sq + row[r]) * p.ld;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int c = 8 * j + 2 * tq;
      if (j < 2 * d16 && c < p.ld)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

template <int kDMax, int kD16, int kWhat>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, bf16* dk, bf16* dv, float* sum_k,
                        float* sum_v, int* work, int* cnt_kv, const Shape& p,
                        float scale_log2, float scale, cudaStream_t stream) {
  constexpr size_t smem = Geom<kDMax, kD16>::kSmem;
  cudaError_t err = hopper::allow_smem<
      flash_attention_bwd_dkdv_tc<kDMax, kD16, kWhat>>(smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_tc<kDMax, kD16, kWhat>
      <<<p.nk * p.B * p.Hq, kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, sum_k, sum_v, work, cnt_kv, p,
          scale_log2, scale);
  return cudaGetLastError();
}

// counters: [0, 2) the dK/dV passes' work counters, then each pass's dK/dV
// counters (2 x B Hkv nk).  scratch: with GQA, the fp32 dK and dV sums
// (B Hkv Sk ld each).
template <int kDMax, int kD16>
cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const void* dout_, const float* lse, const float* delta,
                   void* dq_, void* dk_, void* dv_, int* counters,
                   float* scratch, const Shape& p, cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  bf16* dk = static_cast<bf16*>(dk_);
  bf16* dv = static_cast<bf16*>(dv_);
  int* cnt_kv = counters + 2;
  const size_t kv_n = static_cast<size_t>(p.B) * p.Hkv * p.nk;
  float* sum_k = scratch;
  float* sum_v = sum_k + static_cast<size_t>(p.B) * p.Hkv * p.Sk * p.ld;
  const float scale = 1.f / sqrtf(static_cast<float>(p.D));
  const float scale_log2 = kLog2e * scale;
  cudaError_t err;
  if constexpr (kDMax > 128) {  // dV, then dK: one gradient's sums a pass
    err = launch_dkdv<kDMax, kD16, 1>(q, k, v, dout, lse, delta, dk, dv,
                                      sum_k, sum_v, counters, cnt_kv, p,
                                      scale_log2, scale, stream);
    if (err != cudaSuccess) return err;
    err = launch_dkdv<kDMax, kD16, 2>(q, k, v, dout, lse, delta, dk, dv,
                                      sum_k, sum_v, counters + 1,
                                      cnt_kv + kv_n, p, scale_log2, scale,
                                      stream);
  } else {
    err = launch_dkdv<kDMax, kD16, 3>(q, k, v, dout, lse, delta, dk, dv,
                                      sum_k, sum_v, counters, cnt_kv, p,
                                      scale_log2, scale, stream);
  }
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Geom<kDMax, kD16>::kSmemQ;
  err = hopper::allow_smem<flash_attention_bwd_dq_tc<kDMax, kD16>>(smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_tc<kDMax, kD16>
      <<<dim3((p.Sq + kBQRows - 1) / kBQRows, p.B * p.Hq), kThreads, smem,
          stream>>>(q, k, v, dout, lse, delta, static_cast<bf16*>(dq_), p,
                    scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace tc

// Query rows a tile of the pass that writes dQ: bf16 64 (its dQ pass);
// fp32 64, 32 or 16 as D grows to 64, 128 or 256 (its one pass keeps K, V
// and two stages of Q and dO in shared memory).  plan.py mirrors it.
int query_tile(int D, int dtype) {
  if (dtype == 1) return kBQRows;
  return D <= 64 ? 64 : (D <= 128 ? 32 : 16);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, void* counters,
                               void* scratch, long long n_counters,
                               long long n_scratch, int B, int Hq, int Hkv,
                               int Sq, int Sk, int D, int ld, int causal,
                               int has_window, int window, int dtype,
                               void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int bq = query_tile(D, dtype);
  const Shape p{B, Hq, Hkv, Sq, Sk, D, ld, causal, has_window, window,
                (Sq + bq - 1) / bq, (Sk + kBK - 1) / kBK};
  const long long need_counters =
      2 + 2ll * B * Hkv * p.nk +
      (dtype == 0 ? static_cast<long long>(B) * Hq * p.nq : 0);
  const long long need_scratch =
      dtype == 1 && Hq > Hkv ? 2ll * B * Hkv * Sk * ld : 0;
  if (n_counters < need_counters || n_scratch < need_scratch ||
      static_cast<long long>(p.nk) * B * Hq > 0x7fffffffll)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  int* cnt = static_cast<int*>(counters);
  float* scr = static_cast<float*>(scratch);
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  const unsigned prep_blocks = static_cast<unsigned>(
      (rows + 7) / 8 > (need_counters + 255) / 256 ? (rows + 7) / 8
                                                    : (need_counters + 255) / 256);
  if (dtype == 0) {
    if (ld != D) return cudaErrorInvalidValue;
    flash_attention_bwd_prep<float><<<prep_blocks, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        delta_f, static_cast<float*>(dq), cnt,
        static_cast<int>(need_counters), p, bq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const float* fq = static_cast<const float*>(q);
    const float* fk = static_cast<const float*>(k);
    const float* fv = static_cast<const float*>(v);
    const float* fd = static_cast<const float*>(dout);
    float* gq = static_cast<float*>(dq);
    float* gk = static_cast<float*>(dk);
    float* gv = static_cast<float*>(dv);
    if (D <= 64)
      return f32::launch<4>(fq, fk, fv, fd, lse_f, delta_f, gq, gk, gv, cnt,
                            p, s);
    if (D <= 128)
      return f32::launch<8>(fq, fk, fv, fd, lse_f, delta_f, gq, gk, gv, cnt,
                            p, s);
    return f32::launch<16>(fq, fk, fv, fd, lse_f, delta_f, gq, gk, gv, cnt,
                           p, s);
  }
  if (ld % 8 != 0 || ld < D || ld > (D + 7) / 8 * 8)
    return cudaErrorInvalidValue;
  flash_attention_bwd_prep<__nv_bfloat16><<<prep_blocks, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta_f, nullptr, cnt,
      static_cast<int>(need_counters), p, bq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the forward's dispatch: the served head dims' slice counts compiled
  // in, every other head dim by its width class
  auto run = D > 128 ? tc::launch<256, 0>
                     : (D > 64 ? tc::launch<128, 0> : tc::launch<64, 0>);
  switch ((D + 15) / 16) {
    case 4: run = tc::launch<64, 4>; break;
    case 5: run = tc::launch<128, 5>; break;
    case 6: run = tc::launch<128, 6>; break;
    case 8: run = tc::launch<128, 8>; break;
    case 16: run = tc::launch<256, 16>; break;
    default: break;
  }
  return run(q, k, v, dout, lse_f, delta_f, dq, dk, dv, cnt, scr, p, s);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
