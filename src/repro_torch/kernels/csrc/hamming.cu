// Dense Hamming distances between packed LSH signatures: (q, n) int32.
//
// Replaces: src/repro/kernels/hamming_nns.py `_hamming_kernel`
//           (pallas_call in `hamming_distances_pallas`), the kernel of the
//           dense fixed-radius NNS plan (src/repro/core/nns.py).
// Bound on the H100: writing the (q, n) int32 output. It reads 32 bytes per
//           DB row and 32 per query but writes 4 bytes per (query, row);
//           XOR + popcount is ~3 integer ops per word, far under the
//           CUDA cores' rate.
// Design:   one thread per DB row, looping over a tile of QT queries held
//           in shared memory (a broadcast read). The row's 8 words come in
//           as two 16-byte loads and stay in registers for the tile;
//           neighbouring threads write neighbouring columns, so every
//           output store is coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQueryTile = 8;

template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
               int32_t* __restrict__ out, int nq, int n) {
  __shared__ uint32_t qs[kQueryTile][W];
  const int q0 = blockIdx.y * kQueryTile;
  for (int i = threadIdx.x; i < kQueryTile * W; i += kThreads) {
    const int qi = q0 + i / W;
    qs[i / W][i % W] = qi < nq ? q[static_cast<size_t>(qi) * W + i % W] : 0u;
  }
  __syncthreads();
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  uint32_t r[W];
  repro::load_sig<W>(db + static_cast<size_t>(row) * W, r);
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    const int qi = q0 + j;
    if (qi >= nq) break;
    int d = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) d += __popc(qs[j][w] ^ r[w]);
    out[static_cast<size_t>(qi) * n + row] = d;
  }
}

}  // namespace

REPRO_API int hamming_distances(const void* q, const void* db, void* out,
                                int nq, int n, int words, void* stream) {
  if (nq == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads,
                  (nq + kQueryTile - 1) / kQueryTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_WORDS(words,
      hamming_kernel<W><<<grid, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
          static_cast<int32_t*>(out), nq, n));
  return static_cast<int>(cudaGetLastError());
}
