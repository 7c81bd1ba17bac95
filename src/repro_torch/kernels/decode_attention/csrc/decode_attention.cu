// decode_attention: each query row against the first `valid` rows of its
// slot's K/V cache, the attention of the serve path's decode and chunk
// bodies (GQA: a query head reads K/V head hq / G).
//
// Replaces no Pallas kernel: the JAX package computes decode attention in
// jnp (src/repro/models/attention.py:81, decode_attention_ref) and XLA
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
// One warp a query row, four rows of one (slot, K/V head) a block, so the
// block loads each 32-position tile of K and V once (as fp32, rows padded
// to D + 1 words, so 32 lanes reading 32 rows fall on 32 banks) for all
// four.  A warp walks the tiles below its row's valid length in order:
// lane j scores position t0 + j (a chain of fmaf over d in order), the
// tile's max and sum come from a butterfly of shuffles (every lane ends
// with the same value), and the online softmax rescales the running sum;
// lane l keeps output dims l, l + 32, ..., summing the tile's positions in
// order.  So every query row gets one fixed sequence of operations, in
// whichever block, warp or launch it runs.  Bound by the bytes of the
// visible K/V rows (each read once a block; the four rows share it).
//
// C interface: decode_attention_launch(...) returns a cudaError_t.  dtype
// 0 = float32, 1 = bfloat16 for q, the caches and out.  D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps, kTile = 32;
constexpr int kMaxD = 256, kDims = kMaxD / 32;  // output dims a lane
constexpr float kNegInf = -1e30f;               // the plain version's mask

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * kTile * (D + 1) + kWarps * D);
}

// grid: (ceil(G * C / 4), Hkv, B) with C = R / B query rows a slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ valid, T* __restrict__ out,
                            int B, int R, int Hq, int Hkv, int T_len, int D,
                            float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  const int G = Hq / Hkv, C = R / B;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * kWarps + warp;  // (column, group member)
  const bool live = qi < G * C;
  const int c = live ? qi / G : 0, hq = hkv * G + (live ? qi % G : 0);
  const int r = c * B + b;
  // this row's visible positions, and how far it walks (all T when none)
  const int vis = live ? min(valid[r], T_len) : 0;
  const int walk = live ? (vis > 0 ? vis : T_len) : 0;
  __shared__ int walks[kWarps];
  if (lane == 0) walks[warp] = walk;
  float* qw = qs + warp * D;
  const T* qrow = q + (static_cast<size_t>(r) * Hq + hq) * D;
  for (int d = lane; d < D; d += 32) qw[d] = live ? load(qrow + d) : 0.f;
  __syncthreads();
  int n_block = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_block = max(n_block, walks[w]);

  const size_t head = (static_cast<size_t>(b) * Hkv + hkv) * T_len;
  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < n_block; t0 += kTile) {
    const int rows = min(kTile, n_block - t0);
    __syncthreads();  // the last tile is consumed
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const size_t at = (head + t0 + j) * D + d;
      ks[j * ld + d] = load(k + at);
      vs[j * ld + d] = load(v + at);
    }
    __syncthreads();
    if (t0 >= walk) continue;
    // lane j scores position t0 + j
    const int t = t0 + lane;
    float s = kNegInf;
    if (lane < rows) {
      const float* kr = ks + lane * ld;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qw[d], kr[d], dot);
      if (t < vis) s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = lane < rows ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= corr;
    for (int j = 0; j < rows; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vr = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
  }
  if (!live) return;
  T* orow = out + (static_cast<size_t>(r) * Hq + hq) * D;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store(orow + d, acc[i] * inv);
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* valid, void* out, int B, int R, int Hq,
                     int Hkv, int T_len, int D, float scale,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  static size_t allowed = 0;
  if (smem > 48 * 1024 && smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int G = Hq / Hkv, C = R / B;
  const dim3 grid((G * C + kWarps - 1) / kWarps, Hkv, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), B, R, Hq, Hkv,
      T_len, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, int B, int R,
                            int Hq, int Hkv, int T_len, int D, int dtype,
                            float scale, void* stream) {
  if (B < 1 || R < B || R % B || Hkv < 1 || Hq % Hkv || T_len < 1 || D < 1 ||
      D > kMaxD)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vp = static_cast<const int*>(valid);
  if (dtype == 0)
    return launch_t<float>(q, k, v, vp, out, B, R, Hq, Hkv, T_len, D, scale,
                           s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, vp, out, B, R, Hq, Hkv, T_len, D,
                                   scale, s);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
