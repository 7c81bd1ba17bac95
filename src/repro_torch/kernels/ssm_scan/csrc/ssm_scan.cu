// ssm_scan: the Mamba-1 selective scan, from a zero state,
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t^T,   y_t = h_t C_t,
// with x, dt (B, T, d), A (d, N), B and C (B, T, N), and y (B, T, d) fp32.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan/kernel.py
// (ssm_scan_kernel, body _kernel), whose grid walks (batch, channel tile,
// time block) with the (bd, N) state kept in VMEM scratch from one time
// block to the next, so that the state and the (B, T, d, N) decay and input
// tensors never reach HBM.  On the card blocks run in parallel and in no
// order, so the sequential time axis becomes a loop inside the block, and
// the state lives in registers for the whole sequence.
//
// What bounds it on an H100: it reads x, dt, B and C once and writes y once
// (34 MB for falcon-mamba's d = 8192 at T = 512 with bf16 inputs), 0.010 ms
// at 3.35 TB/s; it does a handful of fp32 operations and one exp per
// (t, channel, n).  The recurrence is sequential over T, so in practice the
// latency of one step (exp, two FMAs, a 16-lane shuffle reduction) times T
// bounds it, and the design spreads the channels over as many threads as
// possible to hide that latency.
//
// What the design does:
//  * one thread per (batch, channel, state n): a channel's N states sit on
//    `lanes` neighbouring lanes of a warp (N rounded up to a power of two,
//    at most 32; 16 for falcon-mamba), each with its h in a register;
//  * the block takes 256 / lanes channels and walks T in blocks of kTB
//    steps: each time block's B and C rows (shared by all the block's
//    channels) and x and dt columns are staged in shared memory as fp32,
//    read with neighbouring threads on neighbouring addresses;
//  * each step computes exp(dt A), the state update and h C on every lane,
//    reduces h C across the channel's lanes with __shfl_xor_sync, and lane
//    0 writes y to shared memory; each time block's y goes out in one
//    coalesced pass;
//  * everything is fp32 inside (inputs are cast as they are staged), as in
//    the Pallas kernel.
//
// C interface: ssm_scan_launch(...) returns cudaGetLastError().
// All operands contiguous; x, dt, B, C of one dtype; A fp32; y fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTB = 64;           // time steps staged per pass
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may use

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

inline size_t smem_bytes(int N, int channels) {
  return sizeof(float) * static_cast<size_t>(kTB) * (2 * N + 3 * channels);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, float* __restrict__ y, int T_len,
                    int D, int N, int lanes) {
  extern __shared__ float smem[];
  const int channels = kThreads / lanes;
  float* sB = smem;                     // [kTB][N]
  float* sC = sB + kTB * N;             // [kTB][N]
  float* sx = sC + kTB * N;             // [kTB][channels]
  float* sdt = sx + kTB * channels;     // [kTB][channels]
  float* sy = sdt + kTB * channels;     // [kTB][channels]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * channels;
  const int lc = threadIdx.x / lanes;   // the thread's channel in the block
  const int n = threadIdx.x % lanes;    // its state index
  const bool live = n < N && c0 + lc < D;
  const float a = live ? A[static_cast<size_t>(c0 + lc) * N + n] : 0.f;
  float h = 0.f;

  const size_t base_d = static_cast<size_t>(b) * T_len * D;  // x, dt, y
  const size_t base_n = static_cast<size_t>(b) * T_len * N;  // B, C
  for (int t0 = 0; t0 < T_len; t0 += kTB) {
    const int nt = min(kTB, T_len - t0);
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const size_t off = base_n + static_cast<size_t>(t0) * N + i;
      sB[i] = to_float(Bm[off]);
      sC[i] = to_float(Cm[off]);
    }
    for (int i = threadIdx.x; i < nt * channels; i += kThreads) {
      const int tt = i / channels, cc = i % channels;
      const bool in = c0 + cc < D;
      const size_t off = base_d + static_cast<size_t>(t0 + tt) * D + c0 + cc;
      sx[i] = in ? to_float(x[off]) : 0.f;
      sdt[i] = in ? to_float(dt[off]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float d_t = sdt[tt * channels + lc];
      const float x_t = sx[tt * channels + lc];
      float p = 0.f;
      if (live) {
        h = expf(d_t * a) * h + (d_t * x_t) * sB[tt * N + n];
        p = h * sC[tt * N + n];
      }
      for (int off = lanes / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) sy[tt * channels + lc] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * channels; i += kThreads) {
      const int tt = i / channels, cc = i % channels;
      if (c0 + cc < D)
        y[base_d + static_cast<size_t>(t0 + tt) * D + c0 + cc] = sy[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, int B, int T_len,
                   int D, int N, cudaStream_t stream) {
  int lanes = 1;
  while (lanes < N) lanes *= 2;
  const int channels = kThreads / lanes;
  const size_t smem = smem_bytes(N, channels);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = ssm_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((D + channels - 1) / channels, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y), T_len, D, N, lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, dt, B, C: 0 = float32, 1 = bfloat16.  A and y are float32.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int B, int T_len,
                    int D, int N, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || D < 1 || N < 1 || N > 32)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, B, T_len, D, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, T_len, D, N, s);
  return cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
