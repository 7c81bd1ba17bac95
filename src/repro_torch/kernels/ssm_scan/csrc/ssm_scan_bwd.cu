// ssm_scan_bwd: the gradient of the Mamba-1 selective scan (ssm_scan.cu),
//   h_t = exp(dt_t A) . h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t,
// from the gradient dy (B, T, d) fp32 on y:
//   dh_t    = C_t dy_t + exp(dt_{t+1} A) . dh_{t+1}        (the reverse scan)
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]
//   dB_t[n] = sum_d dh_t[d, n] dt_t[d] x_t[d]
//   dx_t[d] = dt_t[d] sum_n dh_t[d, n] B_t[n]
//   ddt_t[d] = x_t[d] sum_n dh_t B_t + sum_n dh_t A exp(dt_t A) h_{t-1}
//   dA[d, n] = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1}
// with x, dt, B, C fp32 or bf16 (cast as loaded), A fp32, every gradient
// fp32.
//
// Replaces no Pallas kernel: the JAX package's train path differentiates
// the plain associative scan of src/repro/models/ssm.py (XLA's autodiff,
// which keeps the (B, T, d, N) states).  This is the backward of the
// forward that replaces src/repro/kernels/ssm_scan/kernel.py.
//
// What bounds it on an H100: it reads x, dt, B, C, dy and the forward's
// chunk start states once and writes dx, ddt, dA, dB and dC once (about 76
// MB for falcon-mamba's d = 8192 at 2 x 512 tokens with bf16 inputs, 0.023
// ms at 3.35 TB/s); it does about 20 fp32 operations and, as written here,
// four exps per (b, t, channel, n), which at 67 TFLOP/s outside the tensor
// cores take longer (operations).
//
// What the design does (a plain kernel that is right; making it fast comes
// later).  A block holds 32 neighbouring channels of one batch row, one
// warp per chunk of the forward's chunking (nch chunks of L steps, the
// forward's own cut), one thread per (channel, chunk), all N states of the
// channel in its registers; the (B, T, d, N) states are never built:
//  * pass 0: each chunk walks forward from the start state the forward
//    wrote (hs) and stores its state every kWin = 16 steps to a scratch of
//    (B, nch, windows, NS, d) fp32, a sixteenth of the states;
//  * pass 1: every chunk but the first runs the reverse scan from a zero
//    dh over its steps, and records what it hands the chunk before it and
//    its sum of dt (its decay is exp(A sum dt));
//  * pass 2: the first warp carries dh across the chunks from the last one
//    back, through shared memory, so every chunk knows the dh coming in
//    from its right;
//  * pass 3: every chunk walks its windows from the last back; a window
//    walks its sub-blocks of kSub = 64 / NS steps from the last back, each
//    recomputed from the window's stored state into registers (h_{t-1} for
//    each of its steps), then walked in reverse to make every gradient
//    term of its steps.  dx and ddt are the thread's own; dC_t and dB_t sum
//    over the warp's 32 channels by a butterfly of shuffles in a fixed
//    pattern and are written as the block's partial; dA sums in the thread
//    over its steps, then over the chunks in order through shared memory,
//    and is written as the batch row's partial;
//  * reduce: dB and dC sum their (channel block) partials and dA its (batch
//    row) partials in order, one thread an element (ssm_scan_bwd_reduce).
// No atomics anywhere, so two calls give the same bits.  The decay is
// 2^(dt A log2 e) on the special-function unit, as in the forward.
//
// C interface: ssm_scan_bwd_launch(...) returns cudaGetLastError() after
// the main kernel and the three reductions; the caller allocates the
// scratch (ssm_scan_bwd_scratch_floats), the partials and the outputs.
// Every operand contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // channels a block (one per lane)
constexpr int kMaxChunks = 8;     // chunks a block (one warp each)
constexpr int kWin = 16;          // steps between stored states
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ float load(const T* p, bool in) {
  return in ? to_float(__ldg(p)) : 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The operands of one batch row, as the kernel walks them.
template <typename T>
struct Row {
  const T* x;
  const T* dt;
  const T* Bm;
  const T* Cm;
  const float* dy;
  int T_len, D, N, c;
  bool live;
};

// One forward step of channel c at time t: h = exp(dt A) h + dt x B.
template <typename T, int NS>
__device__ __forceinline__ void step_fwd(float (&h)[NS], const float (&a2)[NS],
                                         const Row<T>& r, int t) {
  const size_t off = static_cast<size_t>(t) * r.D + r.c;
  const float d_t = load(r.dt + off, r.live);
  const float dx = d_t * load(r.x + off, r.live);
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float b = load(r.Bm + static_cast<size_t>(t) * r.N + n, n < r.N);
    h[n] = ex2(d_t * a2[n]) * h[n] + dx * b;
  }
}

// Sum v over the warp's 32 lanes in a fixed pattern: afterwards lane l
// holds the sums of entries l * (V / 32) + j, j < V / 32, in v[j].
template <int V>
__device__ __forceinline__ void butterfly(float (&v)[V], int lane) {
  static_assert(V % 32 == 0, "V must fill the warp");
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int bit = 16 >> s;
    const int half = V >> (s + 1);
    const bool up = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(kLanes * kMaxChunks, 1)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ dy,
                        const float* __restrict__ hs, float* __restrict__ ckpt,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dAp, float* __restrict__ dBp,
                        float* __restrict__ dCp, int B, int T_len, int D,
                        int N, int L, int nwin) {
  // steps in a sub-block: its h_{t-1} stay in 64 registers
  constexpr int kS = 64 / NS < kWin ? 64 / NS : kWin;
  constexpr int V = 2 * NS < 32 ? 32 : 2 * NS;  // dC then dB, padded
  extern __shared__ float slots[];              // [nch][kLanes][NS + 1]
  const int nch = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* mine = slots + (warp * kLanes + lane) * (NS + 1);

  const int b = blockIdx.y, c = blockIdx.x * kLanes + lane;
  const bool live = c < D;
  float a2[NS];  // A log2 e
#pragma unroll
  for (int n = 0; n < NS; ++n)
    a2[n] = live && n < N ? A[static_cast<size_t>(c) * N + n] * kLog2e : 0.f;

  const size_t row_d = static_cast<size_t>(b) * T_len * D;
  const size_t row_n = static_cast<size_t>(b) * T_len * N;
  const Row<T> r{x + row_d, dt + row_d, Bm + row_n, Cm + row_n, dy + row_d,
                 T_len, D, N, c, live};
  const int t0 = min(T_len, warp * L), t1 = min(T_len, t0 + L);
  const int last = nch - 1;
  // this chunk's stored states: [nwin][NS][D] of this batch row
  float* ck = ckpt + (static_cast<size_t>(b) * nch + warp) * nwin * NS * D + c;

  // pass 0: the state every kWin steps, from the forward's start state
  {
    float h[NS];
    const float* st = hs + (static_cast<size_t>(b) * nch + warp) * N * D + c;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      h[n] = live && n < N ? st[static_cast<size_t>(n) * D] : 0.f;
    for (int w = 0, tw = t0; tw < t1; ++w, tw += kWin) {
      if (live) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
          ck[(static_cast<size_t>(w) * NS + n) * D] = h[n];
      }
      if (tw + kWin < t1)
        for (int t = tw; t < tw + kWin; ++t) step_fwd<T, NS>(h, a2, r, t);
    }
  }

  // pass 1: every chunk but the first, the reverse scan from dh = 0
  if (warp > 0) {
    float g[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) g[n] = 0.f;
    float dsum = 0.f;
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t off = static_cast<size_t>(t) * D + c;
      const float d_t = load(r.dt + off, live);
      const float gy = live ? r.dy[off] : 0.f;
      dsum += d_t;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float cn = load(r.Cm + static_cast<size_t>(t) * N + n, n < N);
        g[n] = ex2(d_t * a2[n]) * fmaf(cn, gy, g[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) mine[n] = g[n];
    mine[NS] = dsum;
  }
  __syncthreads();

  // pass 2: the dh coming in from the right of each chunk, carried from
  // the last chunk back; slot k then holds chunk k's
  if (warp == 0) {
    float R[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) R[n] = 0.f;
    for (int k = last; k >= 0; --k) {
      float* slot = slots + (k * kLanes + lane) * (NS + 1);
      const float s = k > 0 ? slot[NS] : 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float out = k > 0 ? slot[n] : 0.f;
        slot[n] = R[n];
        R[n] = fmaf(ex2(s * a2[n]), R[n], out);
      }
    }
  }
  __syncthreads();

  // pass 3: the gradients, windows and sub-blocks from the last back
  float g[NS], dA[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    g[n] = mine[n];
    dA[n] = 0.f;
  }
  const int blk = blockIdx.x;
  float* dCb = dCp + (static_cast<size_t>(blk) * B + b) * T_len * N;
  float* dBb = dBp + (static_cast<size_t>(blk) * B + b) * T_len * N;
  const int nw = (t1 - t0 + kWin - 1) / kWin;
  for (int w = nw - 1; w >= 0; --w) {
    const int tw = t0 + w * kWin, tw1 = min(t1, tw + kWin);
    const int nsub = (tw1 - tw + kS - 1) / kS;
    for (int j = nsub - 1; j >= 0; --j) {
      const int s0 = tw + j * kS, s1 = min(tw1, s0 + kS);
      // h_{t-1} of the sub-block's steps, recomputed from the window's
      float h[NS], hp[kS][NS];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        h[n] = live ? ck[(static_cast<size_t>(w) * NS + n) * D] : 0.f;
      for (int t = tw; t < s0; ++t) step_fwd<T, NS>(h, a2, r, t);
#pragma unroll
      for (int i = 0; i < kS; ++i) {
#pragma unroll
        for (int n = 0; n < NS; ++n) hp[i][n] = h[n];
        if (s0 + i + 1 < s1) step_fwd<T, NS>(h, a2, r, s0 + i);
      }
#pragma unroll
      for (int i = kS - 1; i >= 0; --i) {
        const int t = s0 + i;
        if (t >= s1) continue;
        const size_t off = static_cast<size_t>(t) * D + c;
        const float d_t = load(r.dt + off, live);
        const float xv = load(r.x + off, live);
        const float gy = live ? r.dy[off] : 0.f;
        const float dtx = d_t * xv;
        float v[V];
        float sdb = 0.f, sa = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const size_t on = static_cast<size_t>(t) * N + n;
          const float bn = load(r.Bm + on, n < N);
          const float cn = load(r.Cm + on, n < N);
          const float dec = ex2(d_t * a2[n]);
          const float ht = fmaf(dec, hp[i][n], dtx * bn);
          const float dh = fmaf(cn, gy, g[n]);
          v[n] = gy * ht;
          v[NS + n] = dh * dtx;
          sdb = fmaf(dh, bn, sdb);
          const float q = dh * dec * hp[i][n];
          sa = fmaf(q, a2[n] * kLn2, sa);
          dA[n] = fmaf(q, d_t, dA[n]);
          g[n] = dec * dh;
        }
#pragma unroll
        for (int k = 2 * NS; k < V; ++k) v[k] = 0.f;
        if (live) {
          dx[row_d + off] = d_t * sdb;
          ddt[row_d + off] = fmaf(xv, sdb, sa);
        }
        butterfly<V>(v, lane);
#pragma unroll
        for (int k = 0; k < V / 32; ++k) {
          const int e = lane * (V / 32) + k;
          if (e < NS) {
            if (e < N) dCb[static_cast<size_t>(t) * N + e] = v[k];
          } else if (e - NS < N && e < 2 * NS) {
            dBb[static_cast<size_t>(t) * N + e - NS] = v[k];
          }
        }
      }
    }
  }

  // dA: this thread's sum over its chunk, then the chunks' in order
#pragma unroll
  for (int n = 0; n < NS; ++n) mine[n] = dA[n];
  __syncthreads();
  if (warp == 0 && live) {
    for (int n = 0; n < N && n < NS; ++n) {
      float s = 0.f;
      for (int k = 0; k < nch; ++k)
        s += slots[(k * kLanes + lane) * (NS + 1) + n];
      dAp[(static_cast<size_t>(b) * D + c) * N + n] = s;
    }
  }
}

// out[m] = sum over p < P of in[p M + m], in order of p.
__global__ void ssm_scan_bwd_reduce(const float* __restrict__ in,
                                    float* __restrict__ out, int P,
                                    long long M) {
  const long long m = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += in[p * M + m];
  out[m] = s;
}

int chunk_len(int T_len, int nch) { return (T_len + nch - 1) / nch; }

int windows(int T_len, int nch) {
  return (chunk_len(T_len, nch) + kWin - 1) / kWin;
}

int padded_states(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32; }

cudaError_t reduce(const float* in, float* out, int P, long long M,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (M + threads - 1) / threads;
  ssm_scan_bwd_reduce<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      in, out, P, M);
  return cudaGetLastError();
}

template <typename T, int NS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const void* hs, void* ckpt, void* dx, void* ddt, void* dAp,
                   void* dBp, void* dCp, int B, int T_len, int D, int N,
                   int nch, cudaStream_t stream) {
  const int L = chunk_len(T_len, nch);
  const int nwin = windows(T_len, nch);
  const size_t smem = sizeof(float) * nch * kLanes * (NS + 1);
  const dim3 grid((D + kLanes - 1) / kLanes, B);
  ssm_scan_bwd_kernel<T, NS><<<grid, kLanes * nch, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(hs), static_cast<float*>(ckpt),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dAp), static_cast<float*>(dBp),
      static_cast<float*>(dCp), B, T_len, D, N, L, nwin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* dy,
                     const void* hs, void* ckpt, void* dx, void* ddt,
                     void* dAp, void* dBp, void* dCp, int B, int T_len, int D,
                     int N, int nch, cudaStream_t s) {
  switch (padded_states(N)) {
    case 4:
      return launch<T, 4>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt, dAp, dBp,
                          dCp, B, T_len, D, N, nch, s);
    case 8:
      return launch<T, 8>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt, dAp, dBp,
                          dCp, B, T_len, D, N, nch, s);
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt, dAp, dBp,
                           dCp, B, T_len, D, N, nch, s);
    default:
      return launch<T, 32>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt, dAp, dBp,
                           dCp, B, T_len, D, N, nch, s);
  }
}

}  // namespace

extern "C" {

// Floats of the scratch of stored states for a call: (B, nch, windows,
// NS, D).
long long ssm_scan_bwd_scratch_floats(int B, int T_len, int D, int N,
                                      int nch) {
  return static_cast<long long>(B) * nch * windows(T_len, nch) *
         padded_states(N) * D;
}

// dtype of x, dt, B, C: 0 = float32, 1 = bfloat16.  A, dy, hs ((B, nch, N,
// D), from ssm_scan_launch with the same T) and every output are float32:
// dx, ddt (B, T, D); dA (D, N) from its partials dAp (B, D, N); dB, dC
// (B, T, N) from their partials dBp, dCp (ceil(D / 32), B, T, N).
int ssm_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy,
                        const void* hs, void* ckpt, void* dx, void* ddt,
                        void* dAp, void* dBp, void* dCp, void* dA, void* dB,
                        void* dC, int B, int T_len, int D, int N, int nch,
                        int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || D < 1 || N < 1 || N > 32 ||
      nch < 1 || nch > kMaxChunks)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_n<float>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt, dAp, dBp,
                          dCp, B, T_len, D, N, nch, s);
  else if (dtype == 1)
    err = launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, hs, ckpt, dx, ddt,
                                  dAp, dBp, dCp, B, T_len, D, N, nch, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int nblk = (D + kLanes - 1) / kLanes;
  const long long btn = static_cast<long long>(B) * T_len * N;
  if ((err = reduce(static_cast<const float*>(dBp), static_cast<float*>(dB),
                    nblk, btn, s)) != cudaSuccess)
    return err;
  if ((err = reduce(static_cast<const float*>(dCp), static_cast<float*>(dC),
                    nblk, btn, s)) != cudaSuccess)
    return err;
  return reduce(static_cast<const float*>(dAp), static_cast<float*>(dA), B,
                static_cast<long long>(D) * N, s);
}

const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
