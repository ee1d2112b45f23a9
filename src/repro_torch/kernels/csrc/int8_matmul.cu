// int8 x int8 matmul with per-row / per-column scales: (m, n) float32.
//
// Replaces: src/repro/kernels/int8_matmul.py `_matmul_kernel`
//           (pallas_call in `int8_matmul_pallas`), behind the public op
//           `kernels/ops.py:int8_matmul` (the iMARS crossbar MVM analogue).
// Bound on the H100: the int8 tensor-core rate, 2 m n k operations at
//           1,979 TOP/s, for large shapes; the bytes (m k + k n int8, the
//           scales, 4 m n of output) for thin ones. This kernel runs on the
//           int8 tensor cores through `mma.sync` m16n8k32 (s8 in, s32
//           accumulators), the warp-level instruction; `wgmma` with TMA is
//           the next step towards the peak.
// Design:   one block of 8 warps per 128 x 128 output tile, each warp a
//           64 x 32 sub-tile (4 x 4 m16n8 accumulators); at most 128
//           registers a thread and 37 KB of static shared memory, so two
//           blocks share an SM. Blocks take their tiles in groups of 16
//           m-tiles, down a group's m-tiles first, so the ~264 blocks in
//           flight share a few tiles of X and W in L2. k advances 64 bytes
//           a stage, double-buffered: stage s + 1 loads while stage s
//           computes. X (m, k) row-major is K-major, as the A operand
//           wants: its tile goes to shared memory by `cp.async` (16 bytes a
//           thread, rows padded to 80 bytes so an `ldmatrix` reads 8
//           different 16-byte bank groups) and into A fragments by
//           `ldmatrix.x4`. W (k, n) row-major is N-major, and the B operand
//           of an 8-bit `mma` must be K-major (`ldmatrix.trans` moves only
//           16-bit elements): each thread loads 4 x 4 byte blocks (four
//           32-bit words from four consecutive k rows) into registers
//           before the stage computes, transposes each with `__byte_perm`s
//           into four words of four k-consecutive bytes, one per column,
//           and stores them as one 16-byte word into a [k / 4][n] word
//           array (stride 136 words, so a B fragment's 32-bit loads hit 32
//           different banks). Edge tiles of m, n and k zero-fill through
//           the same copies; when k is not a multiple of 16 or n of 4, the
//           same kernel is instantiated with guarded byte loads instead.
//           The s32 accumulator wraps as the Pallas kernel's int32 does (no
//           .satfinite); the wrapper refuses k > 131071, where k * 128^2
//           could reach 2^31. The epilogue is
//           `(float(acc) * x_scale) * w_scale`, two rounded multiplies with
//           no fused multiply-add, which is the plain version's arithmetic
//           to the bit.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kNJ = kBN / 32;    // n-tiles of 8 per warp
constexpr int kBK = 64;          // k bytes per stage
constexpr int kGroup = 16;       // m-tiles per group of the block order
constexpr int kThreads = 256;    // 8 warps: 2 along m x 4 along n
constexpr int kXLD = kBK + 16;   // bytes per X row in shared memory
constexpr int kKW = kBK / 4;     // k words per stage
constexpr int kWLD = kBN + 8;    // words per W k-word row in shared memory
constexpr int kWBlocks = kKW * kBN / 4 / kThreads;  // 4 x 4 W blocks/thread

struct Stage {
  int8_t x[kBM * kXLD];     // [m][k bytes]
  uint32_t w[kKW * kWLD];   // [k / 4][n]: 4 k-consecutive bytes of column n
};

// X's (kBM, kBK) tile at (m0, k0) into `s.x`; rows and k past the end are
// zero. kVec: k % 16 == 0 and x is 16-byte aligned, so every 16-byte chunk
// is wholly in or out of range and goes by `cp.async`.
template <bool kVec>
__device__ __forceinline__ void load_x(Stage& s, const int8_t* x, int m,
                                       int k, int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 16 / kThreads; ++i) {
    const int c = (tid + i * kThreads) % (kBK / 16);  // 16-byte chunk
    const int r = (tid + i * kThreads) / (kBK / 16);
    const int row = m0 + r, kb = k0 + 16 * c;
    int8_t* dst = s.x + r * kXLD + 16 * c;
    if constexpr (kVec) {
      const bool ok = row < m && kb < k;
      repro::cp_async16(repro::smem_u32(dst),
                        ok ? x + static_cast<size_t>(row) * k + kb : x,
                        ok ? 16 : 0);
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if (row < m) {
        const int8_t* p = x + static_cast<size_t>(row) * k;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (kb + e < k)
            wd[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[kb + e]))
                         << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

// W's (kBK, kBN) tile at (k0, n0) into registers: block i of this thread
// is k rows k0 + 4 kg .. + 3, columns n0 + 4 ng .. + 3, word e = row e.
// kVec: n % 4 == 0 and w is 4-byte aligned, so each word is wholly in or
// out of range.
template <bool kVec>
__device__ __forceinline__ void load_w(uint32_t (&r)[kWBlocks][4],
                                       const int8_t* w, int n, int k, int n0,
                                       int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kWBlocks; ++i) {
    const int ng = (tid + i * kThreads) % (kBN / 4);
    const int kg = (tid + i * kThreads) / (kBN / 4);
    const int col = n0 + 4 * ng;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = k0 + 4 * kg + e;
      const int8_t* p = w + static_cast<size_t>(kr) * n + col;
      if constexpr (kVec) {
        r[i][e] = kr < k && col < n
                      ? __ldg(reinterpret_cast<const unsigned int*>(p))
                      : 0u;
      } else {
        uint32_t v = 0;
        if (kr < k) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < n)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(p[c]))
                   << (8 * c);
        }
        r[i][e] = v;
      }
    }
  }
}

// The registers of `load_w`, transposed 4 x 4 bytes at a time, into `s.w`.
__device__ __forceinline__ void store_w(Stage& s,
                                        const uint32_t (&r)[kWBlocks][4],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kWBlocks; ++i) {
    const int ng = (tid + i * kThreads) % (kBN / 4);
    const int kg = (tid + i * kThreads) / (kBN / 4);
    // t0 = [r0.b0 r1.b0 r0.b1 r1.b1], t1 the same of rows 2 and 3;
    // t2, t3 the same of bytes 2 and 3
    const uint32_t t0 = __byte_perm(r[i][0], r[i][1], 0x5140);
    const uint32_t t1 = __byte_perm(r[i][2], r[i][3], 0x5140);
    const uint32_t t2 = __byte_perm(r[i][0], r[i][1], 0x7362);
    const uint32_t t3 = __byte_perm(r[i][2], r[i][3], 0x7362);
    *reinterpret_cast<uint4*>(&s.w[kg * kWLD + 4 * ng]) =
        make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) Stage st[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 64;   // the warp's rows in the tile
  const int wn = (warp >> 1) * (kBN / 4);  // the warp's columns
  // this block's output tile, in the grouped order
  const int per_group = kGroup * gridDim.x;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int first = bid / per_group * kGroup;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroup);
  const int m0 = (first + bid % per_group % rows) * kBM;
  const int n0 = (bid % per_group / rows) * kBN;
  // the lane's ldmatrix row and byte offset within a 16 x 32-byte A block
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;

  int acc[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (k + kBK - 1) / kBK;
  uint32_t wr[kWBlocks][4];
  load_x<kVec>(st[0], x, m, k, m0, 0, tid);
  repro::cp_async_commit();
  load_w<kVec>(wr, w, n, k, n0, 0, tid);
  store_w(st[0], wr, tid);

  // one stage: kt computes from `cur` while kt + 1 loads into `nxt`
  auto stage = [&](Stage& cur, Stage& nxt, int kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // stage kt + 1: X in flight, W in registers
      load_x<kVec>(nxt, x, m, k, m0, (kt + 1) * kBK, tid);
      repro::cp_async_commit();
      load_w<kVec>(wr, w, n, k, n0, (kt + 1) * kBK, tid);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        repro::ldmatrix_x4(
            a[i], repro::smem_u32(cur.x + (wm + 16 * i + a_row) * kXLD +
                                  32 * ks + a_col));
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const uint32_t* col = cur.w + wn + 8 * j + g;
        const uint32_t b0 = col[(8 * ks + t) * kWLD];
        const uint32_t b1 = col[(8 * ks + 4 + t) * kWLD];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          repro::mma_s8_16832(acc[i][j], a[i], b0, b1);
      }
    }

    if (more) store_w(nxt, wr, tid);
    __syncthreads();  // stage kt's buffers are free for stage kt + 2
  };
  // two stages an iteration, so each names its buffers at compile time
  for (int kt = 0; kt < nk; kt += 2) {
    stage(st[0], st[1], kt);
    if (kt + 1 < nk) stage(st[1], st[0], kt + 1);
  }

  // element e of accumulator (i, j): row wm + 16 i + g + 8 (e / 2),
  // column wn + 8 j + 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + g + 8 * h;
      if (row >= m) continue;
      const float xscale = sx[row];
      float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = col + e < n
                     ? __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]),
                                           xscale),
                                 sw[col + e])
                     : 0.f;
        if (kVec && col < n) {  // n % 4 == 0: both columns, 8-byte aligned
          *reinterpret_cast<float2*>(orow + col) = make_float2(y[0], y[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < n) orow[col + e] = y[e];
        }
      }
    }
}

template <bool kVec>
int launch(const void* x, const void* w, const void* x_scale,
            const void* w_scale, void* out, int m, int n, int k,
            cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_matmul_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int int8_matmul(const void* x, const void* w, const void* x_scale,
                          const void* w_scale, void* out, int m, int n, int k,
                          void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % 16 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 4 == 0)
    return launch<true>(x, w, x_scale, w_scale, out, m, n, k, s);
  return launch<false>(x, w, x_scale, w_scale, out, m, n, k, s);
}
