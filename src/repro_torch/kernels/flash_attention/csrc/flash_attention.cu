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
// head h reads KV head h / (Hq / Hkv), with no copy of K or V.
//
// What bounds it on an H100: at the serve path's shapes (S of a few hundred
// to a few thousand, D = 96 to 256) attention does 4 S^2 D operations per
// head against 4 S D elements moved, so it is bound by operations.  This first
// version computes in fp32 with FMAs (scores and the P V product), not on
// the tensor cores, so it runs far from the bf16 bound; making it fast
// (mma for both products, K/V tiles streamed with cp.async) is later work.
//
// What the design does:
//  * Q for the block's 64 rows is read once into shared memory as fp32; K
//    and V tiles of 32 keys follow, K padded to D + 1 floats a row so the 32
//    lanes of a warp, one key each, read it without bank conflicts;
//  * each warp owns 8 query rows: lane j scores key j of the tile, the row
//    max and sum are warp shuffles, and lane j keeps output columns
//    j, j + 32, ..., j + 32 (kCols - 1) in registers.  The kernel is a
//    template on kCols, chosen at launch: 4 for D <= 128 and 8 for
//    D <= 256 (recurrentgemma's 256), so the smaller head dims keep the
//    registers, and the bits, of the 4-column instantiation;
//  * shared memory is (64 D + 32 (D + 1) + 32 D) floats, 129 KB at
//    D = 256, so one block fits an SM there, above the 48 KB that needs
//    the opt-in attribute, and below the 227 KB a block may use;
//  * k tiles that the causal or window mask covers entirely for every row of
//    the block are skipped; for every row that has a key in range this
//    leaves the output unchanged.
//
// C interface: flash_attention_launch(...) returns cudaGetLastError().
// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), out (B, Hq, Sq, D), contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
      const float p = expf(s - m_new);
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
  }
}

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                   int has_window, int window, int q_offset,
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
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, D,
      causal, has_window, window, q_offset, 1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                           int D, int causal, int has_window, int window,
                           int q_offset, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || B * Hq > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > 128;  // 8 output columns a lane, else 4
  if (dtype == 0)
    return (wide ? launch<float, 8> : launch<float, 4>)(
        q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, has_window, window,
        q_offset, s);
  if (dtype == 1)
    return (wide ? launch<__nv_bfloat16, 8> : launch<__nv_bfloat16, 4>)(
        q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, has_window, window,
        q_offset, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
