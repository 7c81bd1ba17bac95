// rms_norm: out = x * rsqrt(mean(x^2) + eps) * (1 + gamma), row by row, the
// norm of the serve path's decode and chunk bodies.
//
// Replaces no Pallas kernel: the JAX package computes the norm in jnp
// (src/repro/models/layers.py:96, rms_norm) and XLA fuses it.  The port
// adds it because PyTorch's reduction picks its launch shape, and so its
// sum order, from the number of rows: on an H100 an fp32 row normed among
// 32 rows came out 9.5e-7 from the same row normed among 4
// (repro_torch.benchmarks.row_bits).  A chunk's batched body norms B x C
// rows where token prefill norms B, so it needs a norm whose row bits do
// not depend on the rows around it.
//
// One block of 256 threads a row, whatever the number of rows: thread i
// sums x^2 over the row's elements i, i + 256, ... in that order (fp32),
// each warp adds its lanes by a butterfly of shuffles (every lane ends with
// the same value), and thread 0 adds the 8 warps' sums in warp order.  So
// every row's sum is one fixed sequence of operations.  Bound by bytes
// (the row read once and written once; at decode's few rows, by latency).
//
// C interface: rms_norm_launch(...) returns a cudaError_t.  x and out are
// (rows, d) row-major in one dtype (0 = float32, 1 = bfloat16); gamma is
// (d,) in its own dtype code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sum[kWarps];
  __shared__ float scale;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = out + static_cast<size_t>(blockIdx.x) * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = load(xr + i);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sum[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += warp_sum[w];
    scale = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    store(yr + i, load(xr + i) * r * (1.f + load(gamma + i)));
}

template <typename T>
cudaError_t launch_t(const void* x, const void* gamma, int gamma_dtype,
                     void* out, int rows, int d, float eps,
                     cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (gamma_dtype == 0)
    rms_norm_kernel<T, float><<<rows, kThreads, 0, stream>>>(
        xp, static_cast<const float*>(gamma), op, d, eps);
  else if (gamma_dtype == 1)
    rms_norm_kernel<T, __nv_bfloat16><<<rows, kThreads, 0, stream>>>(
        xp, static_cast<const __nv_bfloat16*>(gamma), op, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rms_norm_launch(const void* x, const void* gamma, void* out, int rows,
                    int d, int dtype, int gamma_dtype, float eps,
                    void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
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
