// int8 x int8 matmul with per-row / per-column scales: (m, n) float32.
//
// Replaces: src/repro/kernels/int8_matmul.py `_matmul_kernel`
//           (pallas_call in `int8_matmul_pallas`), behind the public op
//           `kernels/ops.py:int8_matmul` (the iMARS crossbar MVM analogue).
// Bound on the H100: the int8 tensor-core rate, 2 m n k operations at
//           1,979 TOP/s, for large shapes; the bytes (m k + k n int8, the
//           scales, 4 m n of output) for thin ones. This kernel issues
//           `__dp4a` on the CUDA cores (four int8 products a lane per
//           instruction), far under the tensor cores; `mma.sync` s8 or
//           `wgmma` is later work.
// Design:   one block per 64 x 64 output tile, 256 threads of 4 x 4
//           outputs each (rows ty * 4 + i, columns tx + 16 j). k advances
//           64 bytes a stage: X's tile is packed as 4-byte words along k,
//           W's tile is transposed on the way into shared memory so that a
//           column's four k-consecutive bytes form one word; both strides
//           are padded to 17 words (no bank conflicts). Out-of-range rows,
//           columns and k load as 0, so no shape needs a multiple of 16.
//           The int32 accumulator is exact; the epilogue is
//           `(float(acc) * x_scale) * w_scale`, two rounded multiplies with
//           no fused multiply-add, which is the plain version's arithmetic
//           to the bit.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 16;  // k words (4 bytes each) per stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int m, int n, int k) {
  __shared__ int xs[kBM][kBKW + 1];
  __shared__ int ws[kBN][kBKW + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += 4 * kBKW) {
    for (int i = tid; i < kBM * kBKW; i += kThreads) {
      const int r = i / kBKW, wd = i % kBKW;
      const int row = m0 + r, kb = k0 + 4 * wd;
      uint32_t packed = 0;
      if (row < m) {
        const int8_t* p = x + static_cast<size_t>(row) * k + kb;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kb + e < k)
            packed |= static_cast<uint32_t>(static_cast<uint8_t>(p[e]))
                      << (8 * e);
      }
      xs[r][wd] = static_cast<int>(packed);
    }
    for (int i = tid; i < kBN * kBKW; i += kThreads) {
      const int c = i % kBN, wd = i / kBN;
      const int col = n0 + c, kb = k0 + 4 * wd;
      uint32_t packed = 0;
      if (col < n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kb + e < k)
            packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                          w[static_cast<size_t>(kb + e) * n + col]))
                      << (8 * e);
      }
      ws[c][wd] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int wd = 0; wd < kBKW; ++wd) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][wd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][wd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
    const float xscale = sx[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      out[static_cast<size_t>(row) * n + col] = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[i][j]), xscale), sw[col]);
    }
  }
}

}  // namespace

REPRO_API int int8_matmul(const void* x, const void* w, const void* x_scale,
                          const void* w_scale, void* out, int m, int n, int k,
                          void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
