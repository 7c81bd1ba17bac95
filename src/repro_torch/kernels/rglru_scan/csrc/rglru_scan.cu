// rglru_scan: the RG-LRU's diagonal linear recurrence, from a zero state,
//   h_t = a_t * h_{t-1} + bx_t,
// with a and bx (B, T, w) and h (B, T, w) fp32.
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_kernel, body _kernel), whose grid walks (batch, channel tile,
// time block) with the (bw,) state kept in VMEM scratch from one time block
// to the next.  On the card blocks run in parallel and in no order, so the
// sequential time axis becomes a loop inside the thread, and the state lives
// in a register for the whole sequence.
//
// The step is a separate multiply and add, each rounded (__fmul_rn,
// __fadd_rn, which the compiler never contracts into an FMA): the form of
// the plain version, h = a * h + bx as two PyTorch operations, so the two
// agree bit for bit on the card.
//
// What bounds it on an H100: it reads a and bx once and writes h once, 12 B
// an element with fp32 inputs (15.7 MB for recurrentgemma's w = 2560 at
// T = 512), 0.0047 ms at 3.35 TB/s, and does 2 fp32 operations an element.
// The recurrence is sequential over T, and B * w threads (2560 at B = 1)
// fill only part of the card, so in practice the latency of the loads that
// feed the chain bounds it.
//
// What the design does:
//  * one thread per (batch, channel), h in a register; the 32 lanes of a
//    warp take 32 neighbouring channels, so every load of a[b, t, c:c+32]
//    and bx[b, t, c:c+32] and every store of h is coalesced;
//  * one warp a block, so the w / 32 blocks of a batch row spread over as
//    many SMs;
//  * each thread holds the next kU steps of a and bx in registers, loaded
//    while it runs the current kU steps, so the dependent chain is a
//    multiply and an add a step, with one load latency per kU steps;
//  * no padding: the channel and the time index are guarded, so any T >= 1
//    and any w work; inputs are cast to fp32 as they are loaded.
//
// C interface: rglru_scan_launch(...) returns cudaGetLastError().
// a, bx and h contiguous; a and bx of one dtype; h fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // channels a block
constexpr int kU = 32;        // time steps a thread loads ahead

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                      float* __restrict__ h_out, int T_len, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;
  const size_t stride = static_cast<size_t>(W);
  const size_t base = static_cast<size_t>(blockIdx.y) * T_len * stride + c;
  const T* pa = a + base;
  const T* pb = bx + base;
  float* ph = h_out + base;

  // Loads past the last step read the last step again (a valid address,
  // and no predicate to keep them from being issued together); the chain
  // below never uses them.
  const int last = T_len - 1;
  float ra[kU], rb[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const size_t off = min(u, last) * stride;
    ra[u] = to_float(pa[off]);
    rb[u] = to_float(pb[off]);
  }
  float h = 0.f;
  for (int t0 = 0; t0 < T_len; t0 += kU) {
    float na[kU], nb[kU];  // the next kU steps, in flight during these
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const size_t off = min(t0 + kU + u, last) * stride;
      na[u] = to_float(pa[off]);
      nb[u] = to_float(pb[off]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t < T_len) {
        h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
        ph[t * stride] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* bx, void* h, int B, int T_len,
                   int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<float*>(h), T_len, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and bx: 0 = float32, 1 = bfloat16.  h is float32.
int rglru_scan_launch(const void* a, const void* bx, void* h, int B,
                      int T_len, int W, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, bx, h, B, T_len, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, bx, h, B, T_len, W, s);
  return cudaErrorInvalidValue;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
