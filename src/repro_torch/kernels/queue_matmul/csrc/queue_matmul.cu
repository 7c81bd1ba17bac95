// queue_matmul: y = x @ w through two shared-memory operand rings.
//
// Replaces the Pallas kernel src/repro/kernels/queue_matmul/kernel.py
// (queue_matmul_kernel, body _kernel): COPIFTv2's hardware FIFO queues as a
// GEMM, with one ring of `depth_x` slots for activation tiles and one of
// `depth_w` slots for weight tiles.  Step t reads slot t % depth and, once
// every thread is done with it, refills that slot with tile t + depth.
// Depth 1 is COPIFT: copy, wait, compute.
//
// What bounds it on an H100: on the serve path M is the number of decode
// slots (4) or a chunk of them, so every weight byte is used by a handful of
// rows and the kernel is bound by the bytes of w it streams from device
// memory (3.35 TB/s), far below the tensor cores' rate.  Large-M calls
// (forward over a sequence) are bound by operations instead.
//
// What the design does about it:
//  * tiles are copied with 16-byte cp.async straight into shared memory, so
//    the copies of the next `depth - 1` tiles of each operand are in flight
//    while the current tile is multiplied;
//  * the two rings have their own depths, so a single cp.async.wait_group
//    count cannot track them: each slot has its own mbarrier, and every
//    thread's cp.async.mbarrier.arrive.noinc makes the barrier's phase
//    complete only when all copies into that slot have landed.  The wait on
//    the slot's barrier is the queue pop;
//  * the block's M is 16 when M <= 16 (decode) and 64 otherwise, so decode
//    does not pay for 128 rows of padding;
//  * bf16 multiplies on the tensor cores with mma.sync m16n8k16 and an fp32
//    accumulator; fp32 multiplies with plain FMAs (no TF32), in K order.
// The order of the sums over K never depends on the ring depths, so every
// depth gives bit-identical output.  No wgmma, TMA or warp specialisation
// yet: this is the simple, right version.
//
// C interface: queue_matmul_launch(...) returns cudaGetLastError().
// Operands are row-major and contiguous: x (M, K), w (K, N), out (M, N),
// with K and N multiples of 16 bytes' worth of elements (the wrapper pads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 16-byte copy; bytes past `src_bytes` are zero-filled (ragged edges).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major (R, C) matrix
// into a dense ROWS x COLS tile; out-of-range elements become zero.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int R, int C,
                                          int r0, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = COLS / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c % kChunksPerRow) * kVec;
    const int gr = r0 + r, gc = c0 + cc;
    uint32_t bytes = 0;
    const T* p = src;
    if (gr < R && gc < C) {
      bytes = static_cast<uint32_t>(min(kVec, C - gc) * sizeof(T));
      p = src + static_cast<size_t>(gr) * C + gc;
    }
    cp_async16(dst + r * COLS + cc, p, bytes);
  }
}

// fp32: a 16 x 16 thread grid, each thread owns (BM/16) x (BN/16) outputs
// strided by 16 so shared-memory reads of w are conflict-free.
template <int BM>
struct FmaTile {
  static constexpr int TM = BM / 16, TN = kBN / 16;
  float acc[TM][TN];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  __device__ void mma(const float* xs, const float* ws) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + 16 * i) * kBK + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* out, int M, int N, int m0, int n0) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < N) out[static_cast<size_t>(r) * N + c] = acc[i][j];
      }
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// bf16: eight warps, (BM/16) along M and the rest along N; each warp owns a
// 16-row strip of n8 tiles and runs mma.sync m16n8k16 with fp32 accumulators.
template <int BM>
struct MmaTile {
  static constexpr int WM = BM / 16, WN = 8 / WM;
  static constexpr int WARP_N = kBN / WN, NT = WARP_N / 8;
  float acc[NT][4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  __device__ void mma(const __nv_bfloat16* xs, const __nv_bfloat16* ws) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = (warp / WN) * 16 + g;
    const int ncol = (warp % WN) * WARP_N + g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const int col = kk + 2 * t;
      const uint32_t a0 =
          *reinterpret_cast<const uint32_t*>(xs + row0 * kBK + col);
      const uint32_t a1 =
          *reinterpret_cast<const uint32_t*>(xs + (row0 + 8) * kBK + col);
      const uint32_t a2 =
          *reinterpret_cast<const uint32_t*>(xs + row0 * kBK + col + 8);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(xs + (row0 + 8) * kBK + col + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = ncol + 8 * j;
        const uint32_t b0 = pack_bf16(ws[col * kBN + n], ws[(col + 1) * kBN + n]);
        const uint32_t b1 =
            pack_bf16(ws[(col + 8) * kBN + n], ws[(col + 9) * kBN + n]);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  __device__ void store(__nv_bfloat16* out, int M, int N, int m0,
                        int n0) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = m0 + (warp / WN) * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c0 = n0 + (warp % WN) * WARP_N + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >= 2 ? 8 : 0), c = c0 + (e & 1);
        if (r < M && c < N)
          out[static_cast<size_t>(r) * N + c] = __float2bfloat16(acc[j][e]);
      }
    }
  }
};

template <typename T, int BM>
struct TileFor;
template <int BM>
struct TileFor<float, BM> {
  using type = FmaTile<BM>;
};
template <int BM>
struct TileFor<__nv_bfloat16, BM> {
  using type = MmaTile<BM>;
};

__host__ __device__ inline size_t tiles_offset(int depth_x, int depth_w) {
  // barriers first (8 bytes each), tiles from the next 128-byte boundary
  return (static_cast<size_t>(depth_x + depth_w) * 8 + 127) / 128 * 128;
}

template <typename T, int BM>
size_t smem_bytes(int depth_x, int depth_w) {
  return tiles_offset(depth_x, depth_w) +
         sizeof(T) * (static_cast<size_t>(depth_x) * BM * kBK +
                      static_cast<size_t>(depth_w) * kBK * kBN);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    queue_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int M, int N, int K, int depth_x,
                        int depth_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_w = bar_x + depth_x;
  T* xs = reinterpret_cast<T*>(smem + tiles_offset(depth_x, depth_w));
  T* ws = xs + static_cast<size_t>(depth_x) * BM * kBK;
  constexpr int kXTile = BM * kBK, kWTile = kBK * kBN;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth_x; ++s) mbar_init(bar_x + s, kThreads);
    for (int s = 0; s < depth_w; ++s) mbar_init(bar_w + s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // prologue: fill each ring to its own depth
  for (int t = 0; t < depth_x && t < nk; ++t) {
    load_tile<T, BM, kBK>(xs + t * kXTile, x, M, K, m0, t * kBK);
    cp_async_arrive(bar_x + t);
  }
  for (int t = 0; t < depth_w && t < nk; ++t) {
    load_tile<T, kBK, kBN>(ws + t * kWTile, w, K, N, t * kBK, n0);
    cp_async_arrive(bar_w + t);
  }

  typename TileFor<T, BM>::type tile;
  tile.zero();
  for (int t = 0; t < nk; ++t) {
    const int sx = t % depth_x, sw = t % depth_w;
    // queue pop: wait until this slot's copies have landed
    mbar_wait(bar_x + sx, (t / depth_x) & 1);
    mbar_wait(bar_w + sw, (t / depth_w) & 1);
    tile.mma(xs + sx * kXTile, ws + sw * kWTile);
    __syncthreads();  // every thread is done with both slots
    if (t + depth_x < nk) {
      load_tile<T, BM, kBK>(xs + sx * kXTile, x, M, K, m0, (t + depth_x) * kBK);
      cp_async_arrive(bar_x + sx);
    }
    if (t + depth_w < nk) {
      load_tile<T, kBK, kBN>(ws + sw * kWTile, w, K, N, (t + depth_w) * kBK, n0);
      cp_async_arrive(bar_w + sw);
    }
  }
  tile.store(out, M, N, m0, n0);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int depth_x, int depth_w, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BM>(depth_x, depth_w);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = queue_matmul_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, K, depth_x, depth_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int queue_matmul_launch(const void* x, const void* w, void* out, int M, int N,
                        int K, int depth_x, int depth_w, int dtype,
                        void* stream) {
  if (M < 1 || N < 1 || K < 1 || depth_x < 1 || depth_w < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, out, M, N, K, depth_x, depth_w, s)
                 : launch<float, 64>(x, w, out, M, N, K, depth_x, depth_w, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, out, M, N, K, depth_x,
                                             depth_w, s)
                 : launch<__nv_bfloat16, 64>(x, w, out, M, N, K, depth_x,
                                             depth_w, s);
  return cudaErrorInvalidValue;
}

const char* queue_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
