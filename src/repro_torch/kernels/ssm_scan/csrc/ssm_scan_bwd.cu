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
// chunk start states once and writes dx, ddt, dA, dB and dC once (about
// 144 MB for falcon-mamba's d = 8192 at 2 x 512 tokens with bf16 inputs,
// 0.043 ms at 3.35 TB/s); its some 20 fp32 operations per (b, t, channel,
// n) take less (operations, 67 TFLOP/s outside the tensor cores).  What
// takes the time is everything around those operations: the exps (on the
// special-function unit, a sixteenth of the FMA rate), the shared-memory
// and shuffle traffic of the sums over n and over channels, and the state
// at each step, which the reverse walk needs in forward order.
//
// What the design does:
//  * a thread owns one (channel, state n) pair of one batch row and walks
//    the whole sequence, so the carry dh_{t+1} stays in its registers and
//    nothing is carried between threads; a block holds 256 / NS channels x
//    NS states (NS = N rounded up to 4, 8, 16 or 32, the padding states
//    inert), 8 warps, at most 128 registers a thread, two blocks an SM (16
//    warps; one block of 512 threads measured slower: with two, one block
//    computes while the other stages a segment);
//  * the sequence is walked from the last of the forward's chunks back;
//    each chunk starts from the state the forward wrote (hs), and is cut
//    into segments of 64 steps (a chunk of more than 64 steps first walks
//    forward once to store its segment start states in a scratch);
//  * a segment's dt, x, dy (64 steps x the block's channels) and B, C
//    (64 x NS) are staged in shared memory once, cast to fp32, channel- or
//    state-major, so a thread reads four steps of one with one 16-byte load
//    (lanes of one channel, or of one state, read one address);
//  * the segment is walked forward once, keeping the state at the start of
//    each 16-step window; then each window, from the last, is walked
//    forward again into registers (h_{t-1} of each of its 16 steps) and
//    walked in reverse: three exps per (b, t, channel, n) in all (keeping
//    a window's decays as well would take 16 more registers a thread, past
//    128: ptxas spilled);
//  * the sums over n (dx, ddt) run once a window: a butterfly of shuffles
//    over the channel's NS lanes that leaves each lane the sums of its
//    steps; the sums over channels (dB, dC) add the warp's channels by
//    shuffles each step and the block's warps through shared memory once a
//    window, and are written as the block's partial; dA sums in the thread
//    over its steps;
//  * reduce: dB and dC sum their (channel block) partials and dA its (batch
//    row) partials in order, one thread an element (ssm_scan_bwd_reduce).
// No atomics anywhere, so two calls give the same bits.  The decay is
// 2^(dt A log2 e) on the special-function unit, as in the forward.
//
// C interface: ssm_scan_bwd_launch(...) returns cudaGetLastError() after
// the main kernel and the three reductions; the caller allocates the
// scratch (ssm_scan_bwd_scratch_floats), the partials (of
// ssm_scan_bwd_blocks channel blocks) and the outputs.  Every operand
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../_csrc/hopper.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps a block, two blocks an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;     // the forward's chunks
constexpr int kSeg = 64;          // steps staged at a time
constexpr int kWin = 16;          // steps kept in registers
constexpr int kLdT = kSeg + 4;    // a staged row: 16-byte aligned
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// Sum V values over the P lanes of each group of P consecutive lanes (P a
// power of two) in a fixed pattern: afterwards, for V >= P, group lane l
// holds the sums of entries l (V / P) + j in v[j], j < V / P; for V < P it
// holds the sum of entry l / (P / V) in v[0].
template <int V, int P>
__device__ __forceinline__ void group_sums(float (&v)[V], int lane) {
  int m = V;
#pragma unroll
  for (int bit = P / 2; bit >= 1; bit >>= 1) {
    if (m > 1) {
      const int half = m / 2;
      const bool up = (lane & bit) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i >= half) break;
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
      m = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], bit);
    }
  }
}

template <int NS>
struct Geom {
  static constexpr int kCh = kThreads / NS;  // channels a block
  // floats: dt, x, dy [kCh][kLdT]; B, C [NS][kLdT]; window states
  // [kSeg / kWin][kThreads]; the warps' dC, dB sums [kWarps][kWin][NS][2];
  // dx, ddt [kWin][kCh]; the chunk start states [NS][kCh]
  static constexpr int kOffX = kCh * kLdT;
  static constexpr int kOffDy = 2 * kCh * kLdT;
  static constexpr int kOffB = 3 * kCh * kLdT;
  static constexpr int kOffC = kOffB + NS * kLdT;
  static constexpr int kOffWs = kOffC + NS * kLdT;
  static constexpr int kOffRed = kOffWs + (kSeg / kWin) * kThreads;
  static constexpr int kOffDx = kOffRed + kWarps * kWin * NS * 2;
  static constexpr int kOffDdt = kOffDx + kWin * kCh;
  static constexpr int kOffH = kOffDdt + kWin * kCh;
  static constexpr size_t kSmem = sizeof(float) * (kOffH + NS * kCh);
};

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 2)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ dy,
                        const float* __restrict__ hs,
                        float* __restrict__ seg_states,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dAp, float* __restrict__ dBp,
                        float* __restrict__ dCp, int B, int T_len, int D,
                        int N, int nch, int L, int nseg_max) {
  using Gm = Geom<NS>;
  constexpr int kCh = Gm::kCh;
  extern __shared__ __align__(16) float smem[];
  float* s_dt = smem;
  float* s_x = smem + Gm::kOffX;
  float* s_dy = smem + Gm::kOffDy;
  float* s_B = smem + Gm::kOffB;
  float* s_C = smem + Gm::kOffC;
  float* s_ws = smem + Gm::kOffWs;
  float* s_red = smem + Gm::kOffRed;
  float* s_dx = smem + Gm::kOffDx;
  float* s_ddt = smem + Gm::kOffDdt;
  float* s_h = smem + Gm::kOffH;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = tid % NS, cl = tid / NS;  // state, channel in the block
  const int blk = blockIdx.x, b = blockIdx.y;
  const int c0 = blk * kCh, c = c0 + cl;
  const bool live = c < D && n < N;
  const float a = live ? A[static_cast<size_t>(c) * N + n] : 0.f;
  const float a2 = a * kLog2e;
  const size_t row_d = static_cast<size_t>(b) * T_len * D;
  const size_t row_n = static_cast<size_t>(b) * T_len * N;
  float* segs = seg_states +
                (static_cast<size_t>(b) * gridDim.x + blk) * nseg_max *
                    kThreads;
  const float* rdt = s_dt + cl * kLdT;
  const float* rx = s_x + cl * kLdT;
  const float* rdy = s_dy + cl * kLdT;
  const float* rB = s_B + n * kLdT;
  const float* rC = s_C + n * kLdT;

  // steps [s0, s0 + len) of the batch row into shared memory, fp32,
  // channel- and state-major; steps past len arrive as zeros (dt = 0 keeps
  // the state, B = C = dy = 0 add nothing)
  auto stage = [&](int s0, int len) {
    __syncthreads();  // the previous segment is consumed
    for (int e = tid; e < kSeg * kCh; e += kThreads) {
      const int i = e / kCh, cc = e % kCh;
      const bool in = i < len && c0 + cc < D;
      const size_t off = row_d + static_cast<size_t>(s0 + i) * D + c0 + cc;
      s_dt[cc * kLdT + i] = in ? to_float(dt[off]) : 0.f;
      s_x[cc * kLdT + i] = in ? to_float(x[off]) : 0.f;
      s_dy[cc * kLdT + i] = in ? dy[off] : 0.f;
    }
    for (int e = tid; e < kSeg * NS; e += kThreads) {
      const int i = e / NS, nn = e % NS;
      const bool in = i < len && nn < N;
      const size_t off = row_n + static_cast<size_t>(s0 + i) * N + nn;
      s_B[nn * kLdT + i] = in ? to_float(Bm[off]) : 0.f;
      s_C[nn * kLdT + i] = in ? to_float(Cm[off]) : 0.f;
    }
    __syncthreads();
  };
  // kWin steps forward from step i0 of the staged segment
  auto walk = [&](float h, int i0) {
#pragma unroll
    for (int i4 = 0; i4 < kWin; i4 += 4) {
      const float4 d4 = ld4(rdt + i0 + i4), x4 = ld4(rx + i0 + i4);
      const float4 b4 = ld4(rB + i0 + i4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = at(d4, j);
        h = fmaf(ex2(d * a2), h, d * at(x4, j) * at(b4, j));
      }
    }
    return h;
  };

  float g = 0.f, dA = 0.f;  // the carry dh_{t+1} exp(dt_{t+1} A); dA's sum
  for (int k = nch - 1; k >= 0; --k) {
    const int t0 = min(T_len, k * L), t1 = min(T_len, t0 + L);
    const int nseg = (t1 - t0 + kSeg - 1) / kSeg;
    // the chunk's start state, from the forward, through shared memory
    __syncthreads();
    for (int e = tid; e < NS * kCh; e += kThreads) {
      const int nn = e / kCh, cc = e % kCh;
      s_h[e] = nn < N && c0 + cc < D
                   ? hs[((static_cast<size_t>(b) * nch + k) * N + nn) * D +
                        c0 + cc]
                   : 0.f;
    }
    __syncthreads();
    const float h0 = s_h[n * kCh + cl];
    // a long chunk: the state at each later segment's start, to scratch
    if (nseg > 1) {
      float h = h0;
      for (int s = 0; s + 1 < nseg; ++s) {
        stage(t0 + s * kSeg, kSeg);
        for (int i0 = 0; i0 < kSeg; i0 += kWin) h = walk(h, i0);
        segs[s * kThreads + tid] = h;
      }
    }
    for (int s = nseg - 1; s >= 0; --s) {
      const int s0 = t0 + s * kSeg, len = min(kSeg, t1 - s0);
      stage(s0, len);
      const int nw = (len + kWin - 1) / kWin;
      // the state at each window's start
      float h = s == 0 ? h0 : segs[(s - 1) * kThreads + tid];
      for (int w = 0; w < nw; ++w) {
        s_ws[w * kThreads + tid] = h;
        if (w + 1 < nw) h = walk(h, w * kWin);
      }
      for (int w = nw - 1; w >= 0; --w) {
        const int i0 = w * kWin, wl = min(kWin, len - i0);
        // the window forward: h_{t-1} of each step
        float hp[kWin];
        float hc = s_ws[w * kThreads + tid];
#pragma unroll
        for (int i4 = 0; i4 < kWin; i4 += 4) {
          const float4 d4 = ld4(rdt + i0 + i4), x4 = ld4(rx + i0 + i4);
          const float4 b4 = ld4(rB + i0 + i4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = at(d4, j);
            hp[i4 + j] = hc;
            hc = fmaf(ex2(d * a2), hc, d * at(x4, j) * at(b4, j));
          }
        }
        // ... and in reverse: every gradient term of its steps
        float v1[kWin], v2[kWin];  // dh B and dh A e h_{t-1}, per step
#pragma unroll
        for (int i4 = kWin - 4; i4 >= 0; i4 -= 4) {
          const float4 d4 = ld4(rdt + i0 + i4), x4 = ld4(rx + i0 + i4);
          const float4 y4 = ld4(rdy + i0 + i4), b4 = ld4(rB + i0 + i4);
          const float4 c4 = ld4(rC + i0 + i4);
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            const int i = i4 + j;
            const float d = at(d4, j), xv = at(x4, j), gy = at(y4, j);
            const float ht = i + 1 < kWin ? hp[(i + 1) % kWin] : hc;
            const float e = ex2(d * a2);
            const float dh = fmaf(at(c4, j), gy, g);
            float u1 = gy * ht, u2 = dh * (d * xv);
            v1[i] = dh * at(b4, j);
            const float qv = dh * e * hp[i];
            v2[i] = qv * a;
            dA = fmaf(qv, d, dA);
            g = e * dh;
            // dC, dB: the warp's channels, then its warp's slot
#pragma unroll
            for (int o = NS; o < 32; o <<= 1) {
              u1 += __shfl_xor_sync(0xffffffffu, u1, o);
              u2 += __shfl_xor_sync(0xffffffffu, u2, o);
            }
            if (lane < NS)
              *reinterpret_cast<float2*>(
                  s_red + ((warp * kWin + i) * NS + n) * 2) =
                  make_float2(u1, u2);
          }
        }
        // dx, ddt: the sums over the channel's states
        group_sums<kWin, NS>(v1, lane);
        group_sums<kWin, NS>(v2, lane);
        if constexpr (kWin >= NS) {
#pragma unroll
          for (int j = 0; j < kWin / NS; ++j) {
            const int i = n * (kWin / NS) + j;
            s_dx[i * kCh + cl] = rdt[i0 + i] * v1[j];
            s_ddt[i * kCh + cl] = fmaf(rx[i0 + i], v1[j], v2[j]);
          }
        } else if (n % (NS / kWin) == 0) {
          const int i = n / (NS / kWin);
          s_dx[i * kCh + cl] = rdt[i0 + i] * v1[0];
          s_ddt[i * kCh + cl] = fmaf(rx[i0 + i], v1[0], v2[0]);
        }
        __syncthreads();
        for (int o = tid; o < wl * kCh; o += kThreads) {
          const int i = o / kCh, cc = o % kCh;
          if (c0 + cc < D) {
            const size_t off =
                row_d + static_cast<size_t>(s0 + i0 + i) * D + c0 + cc;
            dx[off] = s_dx[o];
            ddt[off] = s_ddt[o];
          }
        }
        // dC (which 0) and dB (1): the block's warps in order
        for (int o = tid; o < 2 * kWin * NS; o += kThreads) {
          const int which = o / (kWin * NS), i = (o / NS) % kWin,
                    nn = o % NS;
          if (i < wl && nn < N) {
            float sum = 0.f;
            for (int ww = 0; ww < kWarps; ++ww)
              sum += s_red[((ww * kWin + i) * NS + nn) * 2 + which];
            float* out = which ? dBp : dCp;
            out[((static_cast<size_t>(blk) * B + b) * T_len + s0 + i0 + i) *
                    N +
                nn] = sum;
          }
        }
        __syncthreads();  // s_red, s_dx, s_ddt are free again
      }
    }
  }
  if (live) dAp[(static_cast<size_t>(b) * D + c) * N + n] = dA;
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

int padded_states(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32; }

int channel_blocks(int D, int N) {
  const int ch = kThreads / padded_states(N);
  return (D + ch - 1) / ch;
}

// segment start states kept a block: every segment of a chunk but its first
int scratch_segments(int T_len, int nch) {
  const int nseg = (chunk_len(T_len, nch) + kSeg - 1) / kSeg;
  return nseg > 1 ? nseg - 1 : 0;
}

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
                   const void* hs, void* scratch, void* dx, void* ddt,
                   void* dAp, void* dBp, void* dCp, int B, int T_len, int D,
                   int N, int nch, cudaStream_t stream) {
  constexpr size_t smem = Geom<NS>::kSmem;
  auto kernel = ssm_scan_bwd_kernel<T, NS>;
  const cudaError_t err = hopper::allow_smem<ssm_scan_bwd_kernel<T, NS>>(smem);
  if (err != cudaSuccess) return err;
  const int L = chunk_len(T_len, nch);
  const dim3 grid(channel_blocks(D, N), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(hs), static_cast<float*>(scratch),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dAp), static_cast<float*>(dBp),
      static_cast<float*>(dCp), B, T_len, D, N, nch, L,
      scratch_segments(T_len, nch));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* dy,
                     const void* hs, void* scratch, void* dx, void* ddt,
                     void* dAp, void* dBp, void* dCp, int B, int T_len, int D,
                     int N, int nch, cudaStream_t s) {
  switch (padded_states(N)) {
    case 4:
      return launch<T, 4>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt, dAp,
                          dBp, dCp, B, T_len, D, N, nch, s);
    case 8:
      return launch<T, 8>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt, dAp,
                          dBp, dCp, B, T_len, D, N, nch, s);
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt, dAp,
                           dBp, dCp, B, T_len, D, N, nch, s);
    default:
      return launch<T, 32>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt, dAp,
                           dBp, dCp, B, T_len, D, N, nch, s);
  }
}

}  // namespace

extern "C" {

// Floats of the scratch of a call: the segment start states of chunks
// longer than one segment, (B, channel blocks, segments - 1, 256); 0 when
// every chunk is one segment (T <= 512).
long long ssm_scan_bwd_scratch_floats(int B, int T_len, int D, int N,
                                      int nch) {
  return static_cast<long long>(B) * channel_blocks(D, N) *
         scratch_segments(T_len, nch) * kThreads;
}

// Channel blocks of a call: the partials of dB and dC have this many rows.
int ssm_scan_bwd_blocks(int D, int N) { return channel_blocks(D, N); }

// dtype of x, dt, B, C: 0 = float32, 1 = bfloat16.  A, dy, hs ((B, nch, N,
// D), from ssm_scan_launch with the same T) and every output are float32:
// dx, ddt (B, T, D); dA (D, N) from its partials dAp (B, D, N); dB, dC
// (B, T, N) from their partials dBp, dCp (ssm_scan_bwd_blocks, B, T, N).
int ssm_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy,
                        const void* hs, void* scratch, void* dx, void* ddt,
                        void* dAp, void* dBp, void* dCp, void* dA, void* dB,
                        void* dC, int B, int T_len, int D, int N, int nch,
                        int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || D < 1 || N < 1 || N > 32 ||
      nch < 1 || nch > kMaxChunks)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_n<float>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt, dAp,
                          dBp, dCp, B, T_len, D, N, nch, s);
  else if (dtype == 1)
    err = launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, hs, scratch, dx, ddt,
                                  dAp, dBp, dCp, B, T_len, D, N, nch, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int nblk = channel_blocks(D, N);
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
