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
// The backward (rglru_scan_bwd_launch) is the same recurrence run in
// reverse: with g the gradient on h,
//   dh_t = g_t + a_{t+1} dh_{t+1} (from dh_T = 0),  dbx_t = dh_t,
//   da_t = dh_t h_{t-1} (h_{-1} = 0).
// The kernel's kRev instantiation walks the logical step s = T-1-t, reading
// a shifted by one step (a_{t+1}, 0 at s = 0) and g in place of bx, and its
// finish also reads h_{t-1} and writes da beside dh.  It reads a, g and h
// once and writes dh and da once.  The forward instantiation is the code it
// was, operation for operation, so its bits do not change.
//
// C interface: rglru_scan_launch(...) and rglru_scan_bwd_launch(...) return
// cudaGetLastError().  Every operand contiguous; a and bx of one dtype; h
// fp32; in the backward g, h, dh and da fp32 and a fp32 or bf16.

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
// `a` and `bx`, as stored (zeros past T or past w, never used).  kRev: step
// s is time T-1-s, and its a is the next time's (zero at s = 0).
template <bool kRev, typename Ta, typename Tb>
__device__ __forceinline__ void fetch(Ta (&ra)[kL], Tb (&rb)[kL],
                                      const Ta* __restrict__ a,
                                      const Tb* __restrict__ bx, int t0,
                                      int j, int c, bool live, int T_len,
                                      int W) {
#pragma unroll
  for (int u = 0; u < kL; ++u) {
    const int t = t0 + j * kL + u;
    const bool in = live && t < T_len;
    if constexpr (kRev) {
      const size_t off = static_cast<size_t>(T_len - 1 - t) * W + c;
      ra[u] = in && t > 0 ? __ldg(a + off + W) : Ta(0.f);
      rb[u] = in ? __ldg(bx + off) : Tb(0.f);
    } else {
      const size_t off = static_cast<size_t>(t) * W + c;
      ra[u] = in ? __ldg(a + off) : Ta(0.f);
      rb[u] = in ? __ldg(bx + off) : Tb(0.f);
    }
  }
}

// kRev: bx is g, h_out receives dh, and h_in (h) and da are used.
template <typename Ta, typename Tb, bool kRev>
__global__ void __launch_bounds__(kTile * kMaxChunks, 2)
    rglru_scan_kernel(const Ta* __restrict__ a, const Tb* __restrict__ bx,
                      float* __restrict__ h_out,
                      const float* __restrict__ h_in, float* __restrict__ da,
                      int T_len, int W, int nch) {
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
  if constexpr (kRev) {
    h_in += row;
    da += row;
  }
  const int seg = nch * kL;
  // fp32 keeps P_t and h_t in the input registers, bf16 in fP and fH
  constexpr bool kInPlace =
      std::is_same<Ta, float>::value && std::is_same<Tb, float>::value;

  Ta ra[kL], na[kL];
  Tb rb[kL], nb[kL];
  float fP[kL], fH[kL];
  fetch<kRev>(ra, rb, a, bx, 0, j, c, live, T_len, W);
  float carry = 0.f;  // the state the last segment ended in (tid < kTile)
  for (int t0 = 0; t0 < T_len; t0 += seg) {
    const bool more = t0 + seg < T_len;
    if (more) fetch<kRev>(na, nb, a, bx, t0 + seg, j, c, live, T_len, W);
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
      if (live && t < T_len) {
        const float v = fmaf(pu, h0, hu);
        if constexpr (kRev) {
          const int tt = T_len - 1 - t;  // the time of logical step t
          const size_t off = static_cast<size_t>(tt) * W + c;
          h_out[off] = v;
          da[off] = tt > 0 ? v * h_in[off - W] : 0.f;
        } else {
          h_out[static_cast<size_t>(t) * W + c] = v;
        }
      }
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

template <typename Ta, typename Tb, bool kRev>
cudaError_t launch(const void* a, const void* bx, void* h, const void* h_in,
                   void* da, int B, int T_len, int W, cudaStream_t stream) {
  int nch = (T_len + kL - 1) / kL;
  if (nch > kMaxChunks) nch = kMaxChunks;
  const dim3 grid((W + kTile - 1) / kTile, B);
  rglru_scan_kernel<Ta, Tb, kRev><<<grid, kTile * nch, 0, stream>>>(
      static_cast<const Ta*>(a), static_cast<const Tb*>(bx),
      static_cast<float*>(h), static_cast<const float*>(h_in),
      static_cast<float*>(da), T_len, W, nch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and bx: 0 = float32, 1 = bfloat16.  h is float32.
int rglru_scan_launch(const void* a, const void* bx, void* h, int B,
                      int T_len, int W, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(a, bx, h, nullptr, nullptr, B, T_len,
                                       W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(a, bx, h, nullptr,
                                                       nullptr, B, T_len, W,
                                                       s);
  return cudaErrorInvalidValue;
}

// The backward: dh and da (B, T, w) fp32 from a (dtype: 0 = float32,
// 1 = bfloat16), g and h (B, T, w) fp32.
int rglru_scan_bwd_launch(const void* a, const void* g, const void* h,
                          void* dh, void* da, int B, int T_len, int W,
                          int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, true>(a, g, dh, h, da, B, T_len, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float, true>(a, g, dh, h, da, B, T_len, W,
                                              s);
  return cudaErrorInvalidValue;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
