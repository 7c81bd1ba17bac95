// ssm_scan: the Mamba-1 selective scan, from a zero state,
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t^T,   y_t = h_t C_t,
// with x, dt (B, T, d), A (d, N), B and C (B, T, N), and y (B, T, d) fp32.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan/kernel.py
// (ssm_scan_kernel, body _kernel), whose grid walks (batch, channel tile,
// time block) with the (bd, N) state kept in VMEM scratch from one time
// block to the next, so that the state and the (B, T, d, N) decay and input
// tensors never reach HBM.  On the card blocks run in parallel and in no
// order, so the sequential time axis is cut into chunks that run at once,
// and the state is carried across them inside the block.
//
// What bounds it on an H100: it reads x, dt, B and C once and writes y once
// (34 MB for falcon-mamba's d = 8192 at T = 512 with bf16 inputs), 0.010 ms
// at 3.35 TB/s; it does a handful of fp32 operations and one exp per
// (t, channel, n).  Walked in sequence, the latency of one step times T
// bounds it; cut into chunks, the exps (one special-function unit op each,
// and each chunk but the first and last walked twice) and the issue slots
// of the other operations do.
//
// What the design does (a chunked scan, one launch a call):
//  * T is cut into `nch` chunks of L steps (L at least 32, nch at most 8:
//    T = 512 gives 8 chunks of 64, T = 128 four of 32); a block holds 32
//    neighbouring channels of one batch row, one warp per chunk, one
//    thread per (channel, chunk);
//  * a thread keeps all N states of its channel in registers (N rounded up
//    to 4, 8, 16 or 32 at compile time, the padding states inert), so the
//    N recurrences are independent chains that hide each other's latency,
//    and y_t = sum_n h_n C_n is an FMA chain in the thread;
//  * pass 1: each chunk but the last runs from h = 0 and records its end
//    state and the sum of its dt (its decay is exp(A sum dt), one exp a
//    state); the first chunk starts from the true state, so it writes y
//    here and is done;
//  * pass 2: the first warp carries the start states across the chunks in
//    order (nch - 1 steps) through shared memory;
//  * pass 3: every other chunk runs again from its start state and writes
//    y;
//  * each warp loads 8 steps at a time into registers while it computes
//    the 8 before them: x and dt with neighbouring lanes on neighbouring
//    channels, and B and C spread over the lanes and then staged in shared
//    memory (read by every lane at one address);
//  * the decay is 2^(dt A log2 e) on the special-function unit
//    (ex2.approx, 2 ulp), one instruction where expf takes eight, which
//    the exps' issue slots made worth it; everything is fp32 inside
//    (inputs are cast as they are loaded), as in the Pallas kernel.
// Rounding differs from the sequential walk in a chunk's start state,
// which composes the decays of the chunks before it, and in the exp.
//
// For the backward (ssm_scan_bwd.cu), pass 2 also writes every chunk's
// start state to `hs` ((B, nch, N, D) fp32, chunk 0's zeros) when the
// caller gives it one: stores beside the carry, so y keeps its bits.
//
// C interface: ssm_scan_launch(...) returns cudaGetLastError(); hs may be
// null.  ssm_scan_chunks(T) is the number of chunks a call cuts T into.
// All operands contiguous; x, dt, B, C of one dtype; A fp32; y fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // channels a block (one per lane)
constexpr int kMaxChunks = 8;     // chunks a block (one warp each)
constexpr int kMinChunk = 32;     // the shortest chunk when T is cut
constexpr int kSub = 8;           // steps loaded at a time
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T load_or_zero(const T* p, bool in);
template <>
__device__ __forceinline__ float load_or_zero(const float* p, bool in) {
  return in ? __ldg(p) : 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 load_or_zero(const __nv_bfloat16* p,
                                                      bool in) {
  return in ? __ldg(p) : __ushort_as_bfloat16(0);
}

// 2^x on the special-function unit (2 ulp); exp(v) = ex2(v log2 e), with
// log2 e folded into A once.  Results below 2^-126 flush to zero, as a
// decay that small no longer moves h.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of a block of `nch` chunks at NS states: each warp's B and
// C stage, then a (chunk, lane) slot of NS states and a dt sum.
inline size_t smem_bytes(int NS, int nch) {
  return sizeof(float) * static_cast<size_t>(nch) *
         (2 * kSub * NS + kLanes * (NS + 1));
}

// Walk steps [t0, t1) of channel c from the state in h (updated in place);
// with kY, write y_t for each.  Returns the sum of dt over the steps.
// a2 is A log2 e.  x, dt, y point at the batch row; Bm and Cm too.  Lanes
// past D (dead) run on zeros and store nothing.  The next kSub steps'
// inputs are loaded into registers while the current ones are computed.
template <typename T, int NS, bool kY>
__device__ __forceinline__ float walk(float (&h)[NS], const float (&a2)[NS],
                                      const T* __restrict__ x,
                                      const T* __restrict__ dt,
                                      const T* __restrict__ Bm,
                                      const T* __restrict__ Cm,
                                      float* __restrict__ y, float* sB,
                                      float* sC, int t0, int t1, int D,
                                      int N, int c, bool live) {
  constexpr int kPer = kSub * NS / kLanes;  // B (and C) values a lane stages
  static_assert(kPer * kLanes == kSub * NS, "kSub * NS must fill the warp");
  const int lane = threadIdx.x % kLanes;
  float dsum = 0.f;
  T xn[kSub], dn[kSub], bn[kPer], cn[kPer];
  auto fetch = [&](int s0) {
    const int ns = min(kSub, t1 - s0);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const size_t off = static_cast<size_t>(s0 + i) * D + c;
      xn[i] = load_or_zero(x + off, live && i < ns);
      dn[i] = load_or_zero(dt + off, live && i < ns);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int tt = (lane + kLanes * j) / NS, n = (lane + kLanes * j) % NS;
      const bool in = tt < ns && n < N;
      const size_t off = static_cast<size_t>(s0 + tt) * N + n;
      bn[j] = load_or_zero(Bm + off, in);
      if (kY) cn[j] = load_or_zero(Cm + off, in);
    }
  };
  if (t0 < t1) fetch(t0);
  for (int s0 = t0; s0 < t1; s0 += kSub) {
    const int ns = min(kSub, t1 - s0);
    // steps past the chunk run on dt = 0, x = 0, B = 0: h stays as it is
    float xr[kSub], dr[kSub];
    __syncwarp();  // every lane is done with the previous stage
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      sB[lane + kLanes * j] = to_float(bn[j]);
      if (kY) sC[lane + kLanes * j] = to_float(cn[j]);
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      xr[i] = to_float(xn[i]);
      dr[i] = to_float(dn[i]);
    }
    __syncwarp();
    if (s0 + kSub < t1) fetch(s0 + kSub);
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      const float d_t = dr[tt], dx = d_t * xr[tt];
      dsum += d_t;
      float p = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = ex2(d_t * a2[n]) * h[n] + dx * sB[tt * NS + n];
        if (kY) p = fmaf(h[n], sC[tt * NS + n], p);
      }
      if (kY && live && tt < ns) y[static_cast<size_t>(s0 + tt) * D + c] = p;
    }
  }
  return dsum;
}

// Up to 16 states, two blocks fit an SM (at most 128 registers a thread),
// so the 256 blocks of falcon-mamba's d = 8192 run in one wave.
template <typename T, int NS>
__global__ void __launch_bounds__(kLanes * kMaxChunks, NS <= 16 ? 2 : 1)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ hs, int T_len, int D, int N, int L) {
  extern __shared__ float smem[];
  const int nch = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* sB = smem + warp * 2 * kSub * NS;   // this warp's stage
  float* sC = sB + kSub * NS;
  float* slots = smem + nch * 2 * kSub * NS;  // [nch][kLanes][NS + 1]
  float* mine = slots + (warp * kLanes + lane) * (NS + 1);

  const int b = blockIdx.y, c = blockIdx.x * kLanes + lane;
  const bool live = c < D;
  float a2[NS];  // A log2 e
#pragma unroll
  for (int n = 0; n < NS; ++n)
    a2[n] = live && n < N ? A[static_cast<size_t>(c) * N + n] * kLog2e : 0.f;

  const size_t row_d = static_cast<size_t>(b) * T_len * D;
  const size_t row_n = static_cast<size_t>(b) * T_len * N;
  const T* xb = x + row_d;
  const T* dtb = dt + row_d;
  const T* Bb = Bm + row_n;
  const T* Cb = Cm + row_n;
  float* yb = y + row_d;
  const int t0 = min(T_len, warp * L), t1 = min(T_len, t0 + L);
  const int last = nch - 1;

  float h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) h[n] = 0.f;

  // pass 1: the first chunk from its true start state (zero), writing y;
  // every other chunk but the last from h = 0, to record its end state
  if (warp == 0 || warp < last) {
    const float s =
        warp == 0
            ? walk<T, NS, true>(h, a2, xb, dtb, Bb, Cb, yb, sB, sC, t0, t1, D,
                                N, c, live)
            : walk<T, NS, false>(h, a2, xb, dtb, Bb, Cb, yb, sB, sC, t0, t1,
                                 D, N, c, live);
    if (warp < last) {
#pragma unroll
      for (int n = 0; n < NS; ++n) mine[n] = h[n];
      mine[NS] = s;
    }
  }
  __syncthreads();

  // pass 2: start states, carried across the chunks in order; slot k then
  // holds the start state of chunk k (k >= 1), also written to hs if given
  float* hsb = hs == nullptr ? nullptr
                             : hs + static_cast<size_t>(b) * nch * N * D + c;
  auto keep = [&](int k, const float(&st)[NS]) {
    if (hsb == nullptr || !live) return;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      if (n < N) hsb[(static_cast<size_t>(k) * N + n) * D] = st[n];
  };
  if (warp == 0) {
    float zero[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) zero[n] = 0.f;
    keep(0, zero);
  }
  if (warp == 0 && last > 0) {
    float st[NS];  // the start state of chunk 1: chunk 0's end
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n] = mine[n];
    for (int k = 1; k <= last; ++k) {
      float* slot = slots + (k * kLanes + lane) * (NS + 1);
      keep(k, st);
      if (k == last) {
#pragma unroll
        for (int n = 0; n < NS; ++n) slot[n] = st[n];
        break;
      }
      const float s = slot[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float end = slot[n];
        slot[n] = st[n];
        st[n] = ex2(s * a2[n]) * st[n] + end;
      }
    }
  }
  __syncthreads();

  // pass 3: every chunk but the first from its start state, writing y
  if (warp > 0) {
#pragma unroll
    for (int n = 0; n < NS; ++n) h[n] = mine[n];
    walk<T, NS, true>(h, a2, xb, dtb, Bb, Cb, yb, sB, sC, t0, t1, D, N, c,
                      live);
  }
}

int chunks(int T_len) {
  const int nch = (T_len + kMinChunk - 1) / kMinChunk;
  return nch > kMaxChunks ? kMaxChunks : nch;
}

template <typename T, int NS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* hs, int B,
                   int T_len, int D, int N, cudaStream_t stream) {
  const int nch = chunks(T_len);
  const int L = (T_len + nch - 1) / nch;
  const size_t smem = smem_bytes(NS, nch);
  auto kernel = ssm_scan_kernel<T, NS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((D + kLanes - 1) / kLanes, B);
  kernel<<<grid, kLanes * nch, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(hs), T_len, D, N, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* hs, int B,
                     int T_len, int D, int N, cudaStream_t stream) {
  if (N <= 4)
    return launch<T, 4>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N, stream);
  if (N <= 8)
    return launch<T, 8>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N, stream);
  if (N <= 16)
    return launch<T, 16>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N, stream);
  return launch<T, 32>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N, stream);
}

}  // namespace

extern "C" {

// dtype of x, dt, B, C: 0 = float32, 1 = bfloat16.  A, y and hs are
// float32; hs ((B, ssm_scan_chunks(T), N, D)) may be null.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* hs, int B,
                    int T_len, int D, int N, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || D < 1 || N < 1 || N > 32)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hs, B, T_len, D, N,
                                   s);
  return cudaErrorInvalidValue;
}

int ssm_scan_chunks(int T_len) { return T_len < 1 ? 0 : chunks(T_len); }

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
