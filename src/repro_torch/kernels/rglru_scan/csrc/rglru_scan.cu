// rglru_scan: the RG-LRU's diagonal linear recurrence, from a zero state,
//   h_t = a_t * h_{t-1} + bx_t,
// with a and bx (B, T, w) and h (B, T, w) fp32.
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_kernel, body _kernel), whose grid walks (batch, channel tile,
// time block) with the (bw,) state kept in VMEM scratch from one time block
// to the next.  On the card blocks run in parallel and in no order, so the
// sequential time axis is cut into chunks that run at once, and the state
// is carried across them inside the block.
//
// What bounds it on an H100: it reads a and bx once and writes h once, 12 B
// an element with fp32 inputs (15.7 MB for recurrentgemma's w = 2560 at
// T = 512), 0.0047 ms at 3.35 TB/s, and does 2 fp32 operations an element.
// Walked in sequence with one thread a channel, B * w threads (2560 at
// B = 1) keep too few bytes in flight, and the latency of the loads sets
// the time; cut into chunks, every element's load is issued at once, and
// the bytes can set it.
//
// What the design does (a single-pass chunked scan, one launch a call):
//  * a block holds kTile = 16 neighbouring channels of one batch row, so
//    recurrentgemma's w = 2560 gives 160 blocks at B = 1 (the card has 132
//    SMs, and two blocks fit on one); a thread holds one channel of one
//    chunk of kL = 16 steps, two chunks a warp, so each warp-wide load is
//    two 64-byte (fp32) or 32-byte (bf16) runs of whole sectors;
//  * T is walked in segments of up to kMaxChunks = 16 chunks (256 steps),
//    one chunk a thread; every thread loads its whole chunk into registers
//    up front, and the next segment's loads are issued before the current
//    one is scanned, so at T <= 512 every input byte is in flight at once,
//    and at longer T one segment's loads hide behind the last one's work;
//  * bf16 inputs stay bf16 in registers until the scan casts them: cast as
//    they were loaded, the casts made the loads wait on each other (0.0645
//    against 0.0503 ms at 1 x 4096 x 2560 on an H100 80GB HBM3 at 700 W);
//  * local scan: each thread runs its chunk from zero, keeping the local
//    h_t and the running decay P_t = a_1 ... a_t (fp32 inputs: in the
//    registers the inputs came in, which measured faster than separate
//    ones), and puts the chunk's summary (P_L, h_L) in shared memory;
//  * carry: the first kTile threads compose the summaries in chunk order,
//    (A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2), from the state the last
//    segment ended in, which gives every chunk its start state (and keep
//    the segment's end state in a register for the next segment);
//  * finish: each thread stores h_t = h_loc,t + P_t h_start, so a and bx
//    are read once and h written once;
//  * no padding: channels and steps are guarded, so any T >= 1 and any w
//    work.
// Rounding differs from the sequential walk (the plain version): a chunk's
// start state composes the decays of the chunks before it, and each step
// is one FMA.
//
// C interface: rglru_scan_launch(...) returns cudaGetLastError().
// a, bx and h contiguous; a and bx of one dtype; h fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 16;       // channels a block
constexpr int kL = 16;          // steps a chunk (a thread)
constexpr int kMaxChunks = 16;  // chunks a segment (kTile each)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Chunk `j`'s kL steps of segment `t0` for channel `c` of the batch row at
// `a` and `bx`, as stored (zeros past T or past w, never used).
template <typename T>
__device__ __forceinline__ void fetch(T (&ra)[kL], T (&rb)[kL],
                                      const T* __restrict__ a,
                                      const T* __restrict__ bx, int t0,
                                      int j, int c, bool live, int T_len,
                                      int W) {
#pragma unroll
  for (int u = 0; u < kL; ++u) {
    const int t = t0 + j * kL + u;
    const bool in = live && t < T_len;
    const size_t off = static_cast<size_t>(t) * W + c;
    ra[u] = in ? __ldg(a + off) : T(0.f);
    rb[u] = in ? __ldg(bx + off) : T(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kMaxChunks, 2)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                      float* __restrict__ h_out, int T_len, int W, int nch) {
  __shared__ float sP[kMaxChunks][kTile];  // a chunk's decay P_L
  __shared__ float sH[kMaxChunks][kTile];  // its end state, then its start
  const int lane = threadIdx.x % kTile;
  const int j = threadIdx.x / kTile;       // chunk in the segment
  const int c = blockIdx.x * kTile + lane;
  const bool live = c < W;
  const size_t row = static_cast<size_t>(blockIdx.y) * T_len * W;
  a += row;
  bx += row;
  h_out += row;
  const int seg = nch * kL;
  // fp32 keeps P_t and h_t in the input registers, bf16 in fP and fH
  constexpr bool kInPlace = std::is_same<T, float>::value;

  T ra[kL], rb[kL], na[kL], nb[kL];
  float fP[kL], fH[kL];
  fetch(ra, rb, a, bx, 0, j, c, live, T_len, W);
  float carry = 0.f;  // the state the last segment ended in (tid < kTile)
  for (int t0 = 0; t0 < T_len; t0 += seg) {
    const bool more = t0 + seg < T_len;
    if (more) fetch(na, nb, a, bx, t0 + seg, j, c, live, T_len, W);
    float hl = 0.f, P = 1.f;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const float av = to_float(ra[u]);
      hl = fmaf(av, hl, to_float(rb[u]));
      P *= av;
      if constexpr (kInPlace) {
        ra[u] = P;
        rb[u] = hl;
      } else {
        fP[u] = P;
        fH[u] = hl;
      }
    }
    sP[j][lane] = P;
    sH[j][lane] = hl;
    __syncthreads();
    if (threadIdx.x < kTile) {
      float hs = carry;
      for (int k = 0; k < nch; ++k) {
        const float p = sP[k][lane], e = sH[k][lane];
        sH[k][lane] = hs;
        hs = fmaf(p, hs, e);
      }
      carry = hs;
    }
    __syncthreads();
    const float h0 = sH[j][lane];
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const int t = t0 + j * kL + u;
      const float pu = kInPlace ? to_float(ra[u]) : fP[u];
      const float hu = kInPlace ? to_float(rb[u]) : fH[u];
      if (live && t < T_len)
        h_out[static_cast<size_t>(t) * W + c] = fmaf(pu, h0, hu);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kL; ++u) {
        ra[u] = na[u];
        rb[u] = nb[u];
      }
    }
    // A thread rewrites only its own slot of sP and sH before the next
    // barrier, and the carry reads them after it: no third barrier.
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* bx, void* h, int B, int T_len,
                   int W, cudaStream_t stream) {
  int nch = (T_len + kL - 1) / kL;
  if (nch > kMaxChunks) nch = kMaxChunks;
  const dim3 grid((W + kTile - 1) / kTile, B);
  rglru_scan_kernel<T><<<grid, kTile * nch, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<float*>(h), T_len, W, nch);
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
