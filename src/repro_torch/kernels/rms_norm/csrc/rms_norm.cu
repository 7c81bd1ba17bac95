// rms_norm: out = x * rsqrt(mean(x^2) + eps) * (1 + gamma), row by row, the
// norm of the serve path's decode and chunk bodies.
//
// Replaces no Pallas kernel: the JAX package computes the norm in jnp
// (src/repro/models/layers.py:67, rms_norm) and XLA fuses it.  The port
// adds it because PyTorch's reduction picks its launch shape, and so its
// sum order, from the number of rows: on an H100 an fp32 row normed among
// 32 rows came out 9.5e-7 from the same row normed among 4
// (repro_torch.benchmarks.row_bits).  A chunk's batched body norms B x C
// rows where token prefill norms B, so it needs a norm whose row bits do
// not depend on the rows around it.
//
// Bound by bytes (the row read once and written once; at decode's few
// rows, by the latency of one launch and one trip to memory, and by how
// many SMs share the loads).  A row is read once, in 16-byte vectors (one
// element where d is not a multiple of them), by t threads, t a function
// of (d, dtype) alone (kernels/rms_norm/plan.py mirrors it): the least
// power of two from 32 to 1024 that gives a thread at most kTargetVecs
// vectors (at most kMaxVecs at 1024 threads), so a decode body's few rows
// spread their loads over many warps.  Each thread keeps its vectors in
// registers from the load to the store and sums x^2 over them in order
// (fp32); each warp adds its lanes by a butterfly of shuffles (every lane
// ends with the same value); every thread adds its row's warp sums from
// shared memory in warp order (one barrier, no second round through one
// thread).  So every row's sum is one fixed sequence of operations
// whatever the number of rows.  Where a thread holds at most kTargetVecs
// vectors (every served width but nemotron's 18432), gamma's vectors are
// loaded beside x's, so the scale waits on no second trip to memory.  A
// block holds 256 / t rows where t < 256.
//
// C interface: rms_norm_launch(...) returns a cudaError_t.  x and out are
// (rows, d) row-major in one dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; gamma is (d,) in its own dtype code, 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// plan.py mirrors these.
constexpr int kTargetVecs = 2;       // vectors a thread, where it can
constexpr int kMaxVecs = 8;          // vectors a thread at most
constexpr int kLoadBytes = 16;       // bytes a load
constexpr int kBlockThreads = 256;   // a block's threads when rows are short
constexpr int kMinRowThreads = 32, kMaxRowThreads = 1024;

// plan.vec: elements a load.
int vec_of(int d, int esize) {
  const int n = kLoadBytes / esize;
  return d % n == 0 ? n : 1;
}

// plan.threads_a_row: 0 when the row does not fit.
int threads_a_row(int d, int esize) {
  const int nv = d / vec_of(d, esize);
  int t = kMinRowThreads;
  while (t < kMaxRowThreads && (nv + t - 1) / t > kTargetVecs) t *= 2;
  return (nv + t - 1) / t <= kMaxVecs ? t : 0;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// kVec elements of T held as loaded: one 16-byte vector, or one element.
template <typename T, int kVec>
struct Raw {
  uint4 u;
  __device__ void get(const T* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ void unpack(float* f) const;
};
template <typename T>
struct Raw<T, 1> {
  T e;
  __device__ void get(const T* p) { e = *p; }
  __device__ void unpack(float* f) const { f[0] = load(&e); }
};
template <>
__device__ void Raw<float, 4>::unpack(float* f) const {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ void Raw<__nv_bfloat16, 8>::unpack(float* f) const {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf_lo(w[i]);
    f[2 * i + 1] = bf_hi(w[i]);
  }
}

// gamma's kVec elements from p, as fp32, in loads of at most 16 bytes.
template <int kVec>
__device__ __forceinline__ void load_gamma(const float* p, float* f) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int c = 0; c < kVec / 4; ++c) {
      const float4 g = reinterpret_cast<const float4*>(p)[c];
      f[4 * c] = g.x;
      f[4 * c + 1] = g.y;
      f[4 * c + 2] = g.z;
      f[4 * c + 3] = g.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = p[e];
  }
}
template <int kVec>
__device__ __forceinline__ void load_gamma(const __nv_bfloat16* p,
                                           float* f) {
  if constexpr (kVec == 8) {
    const uint4 g = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf_lo(w[i]);
      f[2 * i + 1] = bf_hi(w[i]);
    }
  } else if constexpr (kVec == 4) {
    const uint2 g = *reinterpret_cast<const uint2*>(p);
    f[0] = bf_lo(g.x);
    f[1] = bf_hi(g.x);
    f[2] = bf_lo(g.y);
    f[3] = bf_hi(g.y);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = load(p + e);
  }
}

// kVec fp32 values stored to p in T, rounded to nearest even.
template <int kVec>
__device__ __forceinline__ void store(float* p, const float* f) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = f[e];
  }
}
template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
  if constexpr (kVec == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = __float2bfloat16(f[e]);
  }
}

// Block: rows_a_block rows of `tpr` threads; thread i of a row holds its
// vectors i, i + tpr, ..., at most kVecs of them.  Where that is
// kTargetVecs, gamma's matching vectors are loaded beside them, so the
// scale waits on no second trip to memory.
template <typename T, typename G, int kVec, int kVecs>
__global__ void __launch_bounds__(kMaxRowThreads)
    rms_norm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                    T* __restrict__ out, int rows, int d, int tpr,
                    float eps) {
  constexpr bool kEarly = kVecs <= kTargetVecs;  // gamma loaded with x
  __shared__ float warp_sum[kMaxRowThreads / 32];
  const int row_in = threadIdx.x / tpr, i = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + row_in;
  const bool live = row < rows;
  const int n = d / kVec;  // the row's vectors
  const T* xr = x + static_cast<size_t>(row) * d;
  Raw<T, kVec> raw[kVecs];
  float g[kEarly ? kVecs : 1][kVec];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int j = i + u * tpr;
    if (live && j < n) {
      raw[u].get(xr + j * kVec);
      if constexpr (kEarly) load_gamma<kVec>(gamma + j * kVec, g[u]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    if (live && i + u * tpr < n) {
      float f[kVec];
      raw[u].unpack(f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s = fmaf(f[e], f[e], s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  if (!live) return;
  const int warps = tpr / 32, w0 = row_in * warps;
  float t = warp_sum[w0];
  for (int w = 1; w < warps; ++w) t += warp_sum[w0 + w];
  const float r = rsqrtf(t / static_cast<float>(d) + eps);
  T* yr = out + static_cast<size_t>(row) * d;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int j = i + u * tpr;
    if (j < n) {
      float f[kVec];
      raw[u].unpack(f);
      const float* gu = g[kEarly ? u : 0];
      if constexpr (!kEarly) load_gamma<kVec>(gamma + j * kVec, g[0]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = f[e] * r * (1.f + gu[e]);
      store<kVec>(yr + j * kVec, f);
    }
  }
}

template <typename T, typename G, int kVec>
cudaError_t launch_v(const T* x, const G* gamma, T* out, int rows, int d,
                     int tpr, float eps, cudaStream_t stream) {
  const int per_block = tpr >= kBlockThreads ? 1 : kBlockThreads / tpr;
  const dim3 grid((rows + per_block - 1) / per_block);
  if ((d / kVec + tpr - 1) / tpr <= kTargetVecs)
    rms_norm_kernel<T, G, kVec, kTargetVecs>
        <<<grid, per_block * tpr, 0, stream>>>(x, gamma, out, rows, d, tpr,
                                               eps);
  else
    rms_norm_kernel<T, G, kVec, kMaxVecs>
        <<<grid, per_block * tpr, 0, stream>>>(x, gamma, out, rows, d, tpr,
                                               eps);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_g(const T* x, const G* gamma, T* out, int rows, int d,
                     float eps, cudaStream_t stream) {
  const int tpr = threads_a_row(d, sizeof(T));
  if (tpr == 0) return cudaErrorInvalidValue;
  if (vec_of(d, sizeof(T)) == 1)
    return launch_v<T, G, 1>(x, gamma, out, rows, d, tpr, eps, stream);
  return launch_v<T, G, kLoadBytes / sizeof(T)>(x, gamma, out, rows, d, tpr,
                                                 eps, stream);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* gamma, int gamma_dtype,
                     void* out, int rows, int d, float eps,
                     cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (gamma_dtype == 0)
    return launch_g(xp, static_cast<const float*>(gamma), op, rows, d, eps,
                    stream);
  if (gamma_dtype == 1)
    return launch_g(xp, static_cast<const __nv_bfloat16*>(gamma), op, rows,
                    d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int rms_norm_launch(const void* x, const void* gamma, void* out, int rows,
                    int d, int dtype, int gamma_dtype, float eps,
                    void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % kLoadBytes ||
      reinterpret_cast<uintptr_t>(gamma) % kLoadBytes ||
      reinterpret_cast<uintptr_t>(out) % kLoadBytes)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, gamma, gamma_dtype, out, rows, d, eps, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, gamma, gamma_dtype, out, rows, d, eps,
                                   s);
  return cudaErrorInvalidValue;
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
