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
// The backward, the reverse walk (rglru_scan_bwd_kernel), is a kernel of
// its own.  With g the gradient on h it computes
//   dh_t = g_t + a_{t+1} dh_{t+1} (from dh_T = 0),  dbx_t = dh_t,
//   da_t = dh_t h_{t-1} (h_{-1} = 0),
// walking the logical step s = T-1-t: the same recurrence with a shifted by
// one step (a_{t+1}, 0 at s = 0) and g in place of bx.  It reads a, g and h
// once and writes dh and da once: 20 B an element with fp32 a (52.4 MB at
// recurrentgemma's training shape, B, T, w = 2, 512, 2560: 0.0157 ms at
// 3.35 TB/s), 18 B with bf16 a.  What its design does:
//  * one wave: the launch is sized from B w, T and the residency the
//    compiled kernel gets (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//    as kernels/rglru_scan/plan.py computes it on the host.  A block holds
//    `ct` neighbouring channels of one batch row (32, else 16 or 8 when
//    32-channel tiles would leave SMs without a block), one a lane, and
//    `nch` chunks of kBwdL steps, one a thread; `nch` is halved, down to a
//    64-step segment, while the grid needs more than one wave;
//  * every input byte of a segment in flight before its scan: each thread
//    loads a_{t+1}, g_t and h_{t-1} of its chunk together, and the next
//    segment's three before the current one is scanned, so h is never
//    fetched after the scan;
//  * local scan as the forward's (in the input registers with fp32 a);
//  * carry: a channel's nch chunk summaries lie in neighbouring lanes of one
//    warp, and every warp composes its channels at once with a shuffle scan
//    (log2 nch steps, a fixed tree, so two calls give equal bits), from the
//    state the last segment ended in; no thread walks the chunks in turn;
//  * finish: dh_t = dh_loc,t + P_t dh_start and da_t = dh_t h_{t-1}, both
//    stored at once.
// The forward kernel is the code it was before the reverse walk got its
// own, operation for operation, so its bits do not change.
//
// C interface: rglru_scan_launch(...) and rglru_scan_bwd_launch(...) return
// cudaGetLastError().  Every operand contiguous; a and bx of one dtype; h
// fp32; in the backward g, h, dh and da fp32 and a fp32 or bf16.
// rglru_scan_bwd_geometry(...) reports the launch the backward would make.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
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
template <typename Ta, typename Tb>
__device__ __forceinline__ void fetch(Ta (&ra)[kL], Tb (&rb)[kL],
                                      const Ta* __restrict__ a,
                                      const Tb* __restrict__ bx, int t0,
                                      int j, int c, bool live, int T_len,
                                      int W) {
#pragma unroll
  for (int u = 0; u < kL; ++u) {
    const int t = t0 + j * kL + u;
    const bool in = live && t < T_len;
    const size_t off = static_cast<size_t>(t) * W + c;
    ra[u] = in ? __ldg(a + off) : Ta(0.f);
    rb[u] = in ? __ldg(bx + off) : Tb(0.f);
  }
}

template <typename Ta, typename Tb>
__global__ void __launch_bounds__(kTile * kMaxChunks, 2)
    rglru_scan_kernel(const Ta* __restrict__ a, const Tb* __restrict__ bx,
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
  constexpr bool kInPlace =
      std::is_same<Ta, float>::value && std::is_same<Tb, float>::value;

  Ta ra[kL], na[kL];
  Tb rb[kL], nb[kL];
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
      if (live && t < T_len) {
        const float v = fmaf(pu, h0, hu);
        h_out[static_cast<size_t>(t) * W + c] = v;
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

template <typename Ta, typename Tb>
cudaError_t launch(const void* a, const void* bx, void* h, int B, int T_len,
                   int W, cudaStream_t stream) {
  int nch = (T_len + kL - 1) / kL;
  if (nch > kMaxChunks) nch = kMaxChunks;
  const dim3 grid((W + kTile - 1) / kTile, B);
  rglru_scan_kernel<Ta, Tb><<<grid, kTile * nch, 0, stream>>>(
      static_cast<const Ta*>(a), static_cast<const Tb*>(bx),
      static_cast<float*>(h), T_len, W, nch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The reverse walk.  Its geometry is kernels/rglru_scan/plan.py's: keep the
// constants and bwd_geometry in step with it.
// ---------------------------------------------------------------------------

constexpr int kBwdL = 8;             // steps a chunk (a thread)
constexpr int kBwdMaxThreads = 512;  // threads a block
constexpr int kBwdMaxChunks = 32;    // chunks a segment: a warp's lanes
constexpr int kBwdMinSegment = 64;   // steps: the least `nch` is halved to

// Chunk `j`'s kBwdL steps from logical step `s0` for channel `c`: a_{t+1},
// g_t and h_{t-1} at t = T-1-s, zeros where the step lies past T, the
// channel past w, or the time outside [0, T).
template <typename Ta>
__device__ __forceinline__ void fetch_bwd(Ta (&ra)[kBwdL], float (&rg)[kBwdL],
                                          float (&rh)[kBwdL],
                                          const Ta* __restrict__ a,
                                          const float* __restrict__ g,
                                          const float* __restrict__ h, int s0,
                                          int j, int c, bool live, int T_len,
                                          int W) {
#pragma unroll
  for (int u = 0; u < kBwdL; ++u) {
    const int s = s0 + j * kBwdL + u;
    const bool in = live && s < T_len;
    const int t = T_len - 1 - s;
    const size_t off = static_cast<size_t>(t) * W + c;
    ra[u] = in && s > 0 ? __ldg(a + off + W) : Ta(0.f);
    rg[u] = in ? __ldg(g + off) : 0.f;
    rh[u] = in && t > 0 ? __ldg(h + off - W) : 0.f;
  }
}

// Block (tile, batch row) of `1 << ct_log2` channels by `1 << nch_log2`
// chunks; thread tid holds channel tid % ct of chunk tid / ct, and in the
// carry chunk tid % nch of channel tid / nch.
template <typename Ta>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rglru_scan_bwd_kernel(const Ta* __restrict__ a, const float* __restrict__ g,
                          const float* __restrict__ h, float* __restrict__ dh,
                          float* __restrict__ da, int T_len, int W,
                          int ct_log2, int nch_log2) {
  // chunk summaries (P_L, dh_L) at [chunk * (ct + 1) + channel], the pad
  // keeping the carry's reads off one bank; sH then holds the start states
  __shared__ float sP[kBwdMaxThreads + kBwdMaxChunks];
  __shared__ float sH[kBwdMaxThreads + kBwdMaxChunks];
  const int ct = 1 << ct_log2, nch = 1 << nch_log2;
  const int pad = ct + 1;
  const int tid = threadIdx.x;
  const int lane_c = tid & (ct - 1);
  const int j = tid >> ct_log2;        // chunk in the segment
  const int sj = tid & (nch - 1);      // the carry's chunk ...
  const int sc = tid >> nch_log2;      // ... and channel
  const int c = blockIdx.x * ct + lane_c;
  const bool live = c < W;
  const size_t row = static_cast<size_t>(blockIdx.y) * T_len * W;
  a += row;
  g += row;
  h += row;
  dh += row;
  da += row;
  const int seg = nch * kBwdL;
  // fp32 a keeps P_s in the registers a came in, bf16 a in fP; dh_loc,s
  // goes into g's
  constexpr bool kInPlace = std::is_same<Ta, float>::value;

  Ta ra[kBwdL], na[kBwdL];
  float rg[kBwdL], ng[kBwdL], rh[kBwdL], nh[kBwdL], fP[kBwdL];
  fetch_bwd(ra, rg, rh, a, g, h, 0, j, c, live, T_len, W);
  float carry = 0.f;  // dh where the last segment ended, channel sc
  for (int s0 = 0; s0 < T_len; s0 += seg) {
    const bool more = s0 + seg < T_len;
    if (more) fetch_bwd(na, ng, nh, a, g, h, s0 + seg, j, c, live, T_len, W);
    float hl = 0.f, P = 1.f;
#pragma unroll
    for (int u = 0; u < kBwdL; ++u) {
      const float av = to_float(ra[u]);
      hl = fmaf(av, hl, rg[u]);
      P *= av;
      if constexpr (kInPlace) {
        ra[u] = P;
      } else {
        fP[u] = P;
      }
      rg[u] = hl;
    }
    sP[j * pad + lane_c] = P;
    sH[j * pad + lane_c] = hl;
    __syncthreads();
    // inclusive shuffle scan of the affine maps x -> p x + e over the
    // channel's chunks: the later map after the earlier, (p, e) o (pu, eu)
    // = (p pu, p eu + e)
    float p = sP[sj * pad + sc], e = sH[sj * pad + sc];
    for (int d = 1; d < nch; d <<= 1) {
      const float pu = __shfl_up_sync(0xffffffffu, p, d, nch);
      const float eu = __shfl_up_sync(0xffffffffu, e, d, nch);
      if (sj >= d) {
        e = fmaf(p, eu, e);
        p *= pu;
      }
    }
    const float pe = __shfl_up_sync(0xffffffffu, p, 1, nch);
    const float ee = __shfl_up_sync(0xffffffffu, e, 1, nch);
    const float pl = __shfl_sync(0xffffffffu, p, nch - 1, nch);
    const float el = __shfl_sync(0xffffffffu, e, nch - 1, nch);
    sH[sj * pad + sc] = sj == 0 ? carry : fmaf(pe, carry, ee);
    carry = fmaf(pl, carry, el);
    __syncthreads();
    const float h0 = sH[j * pad + lane_c];
#pragma unroll
    for (int u = 0; u < kBwdL; ++u) {
      const int s = s0 + j * kBwdL + u;
      const float pu = kInPlace ? to_float(ra[u]) : fP[u];
      if (live && s < T_len) {
        const int t = T_len - 1 - s;
        const size_t off = static_cast<size_t>(t) * W + c;
        const float v = fmaf(pu, h0, rg[u]);
        dh[off] = v;
        da[off] = t > 0 ? v * rh[u] : 0.f;
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kBwdL; ++u) {
        ra[u] = na[u];
        rg[u] = ng[u];
        rh[u] = nh[u];
      }
    }
    // Other threads read a thread's slot of sP and sH, and write its start
    // state there, only between a segment's two barriers: two suffice.
  }
}

struct BwdGeometry {
  int ct_log2, nch_log2, tiles, resident, sms;
};

// Blocks of `threads` (a power of two up to kBwdMaxThreads, the only sizes
// bwd_geometry launches) of the dtype's kernel that fit one SM, and the SMs
// of the current device, queried once a device, dtype and size.  A cache
// entry holds both, (sms << 8) | resident, in one atomic: a thread that
// finds it set reads a pair another thread wrote whole.
cudaError_t bwd_residency(int dtype, int threads, int* resident, int* sms) {
  if (threads < 1 || threads > kBwdMaxThreads || (threads & (threads - 1)))
    return cudaErrorInvalidValue;
  constexpr int kDevices = 16, kSizes = 10;  // 2^9 = kBwdMaxThreads
  static std::atomic<int> cache[kDevices][2][kSizes];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int lg = 0;
  while ((1 << lg) < threads) ++lg;
  std::atomic<int>* entry = dev < kDevices ? &cache[dev][dtype][lg] : nullptr;
  const int hit = entry ? entry->load(std::memory_order_relaxed) : 0;
  if (hit > 0) {
    *resident = hit & 0xff;
    *sms = hit >> 8;
    return cudaSuccess;
  }
  err = dtype == 0
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  resident, rglru_scan_bwd_kernel<float>, threads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  resident, rglru_scan_bwd_kernel<__nv_bfloat16>, threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (entry && *resident > 0)
    entry->store((*sms << 8) | *resident, std::memory_order_relaxed);
  return cudaSuccess;
}

// plan.py's geometry(): the widest channel tile (32, 16, 8) that gives every
// SM a block, as many chunks a segment as T needs (a power of two, up to a
// warp and kBwdMaxThreads), halved down to a kBwdMinSegment-step segment
// while the grid needs more than one wave.
cudaError_t bwd_geometry(int B, int T_len, int W, int dtype, BwdGeometry* out) {
  int resident = 0, sms = 0;
  cudaError_t err = bwd_residency(dtype, 32, &resident, &sms);
  if (err != cudaSuccess) return err;
  int ct_log2 = 5;
  while (ct_log2 > 3 &&
         static_cast<long long>(B) * ((W + (1 << ct_log2) - 1) >> ct_log2) <
             sms)
    --ct_log2;
  const int ct = 1 << ct_log2;
  const long long tiles = (W + ct - 1) / ct;
  const long long blocks = tiles * B;
  const int need = (T_len + kBwdL - 1) / kBwdL;
  int nch = 1;
  while (nch < need && nch < kBwdMaxChunks && ct * nch < kBwdMaxThreads)
    nch <<= 1;
  while (ct * nch < 32) nch <<= 1;
  int least = kBwdMinSegment / kBwdL;
  if (least > nch) least = nch;
  if (least < 32 / ct) least = 32 / ct;
  for (;;) {
    err = bwd_residency(dtype, ct * nch, &resident, &sms);
    if (err != cudaSuccess) return err;
    if (nch <= least || blocks <= static_cast<long long>(sms) * resident)
      break;
    nch >>= 1;
  }
  int nch_log2 = 0;
  while ((1 << nch_log2) < nch) ++nch_log2;
  *out = {ct_log2, nch_log2, static_cast<int>(tiles), resident, sms};
  return cudaSuccess;
}

template <typename Ta>
cudaError_t launch_bwd(const void* a, const void* g, const void* h, void* dh,
                       void* da, int B, int T_len, int W,
                       cudaStream_t stream) {
  BwdGeometry geo;
  const cudaError_t err = bwd_geometry(
      B, T_len, W, std::is_same<Ta, float>::value ? 0 : 1, &geo);
  if (err != cudaSuccess) return err;
  const dim3 grid(geo.tiles, B);
  rglru_scan_bwd_kernel<Ta><<<grid, 1 << (geo.ct_log2 + geo.nch_log2), 0,
                              stream>>>(
      static_cast<const Ta*>(a), static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<float*>(dh),
      static_cast<float*>(da), T_len, W, geo.ct_log2, geo.nch_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and bx: 0 = float32, 1 = bfloat16.  h is float32.
int rglru_scan_launch(const void* a, const void* bx, void* h, int B,
                      int T_len, int W, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(a, bx, h, B, T_len, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, bx, h, B, T_len, W, s);
  return cudaErrorInvalidValue;
}

// The backward: dh and da (B, T, w) fp32 from a (dtype: 0 = float32,
// 1 = bfloat16), g and h (B, T, w) fp32.
int rglru_scan_bwd_launch(const void* a, const void* g, const void* h,
                          void* dh, void* da, int B, int T_len, int W,
                          int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, g, h, dh, da, B, T_len, W, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, g, h, dh, da, B, T_len, W, s);
  return cudaErrorInvalidValue;
}

// The backward's launch for (B, T, w, dtype) on the current device, as
// rglru_scan_bwd_launch makes it: out = {channels a block, chunks a
// segment, channel tiles a batch row, blocks of that size an SM, SMs}.
int rglru_scan_bwd_geometry(int B, int T_len, int W, int dtype, int* out) {
  if (B < 1 || T_len < 1 || W < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  BwdGeometry geo;
  const cudaError_t err = bwd_geometry(B, T_len, W, dtype, &geo);
  if (err != cudaSuccess) return err;
  out[0] = 1 << geo.ct_log2;
  out[1] = 1 << geo.nch_log2;
  out[2] = geo.tiles;
  out[3] = geo.resident;
  out[4] = geo.sms;
  return cudaSuccess;
}

// Blocks of `threads` threads (a power of two up to 512) of the backward
// kernel (dtype of a) that fit one SM of the current device; -1 for any
// other count.
int rglru_scan_bwd_residency(int dtype, int threads) {
  if (dtype != 0 && dtype != 1) return -1;
  int resident = 0, sms = 0;
  return bwd_residency(dtype, threads, &resident, &sms) == cudaSuccess
             ? resident
             : -1;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
