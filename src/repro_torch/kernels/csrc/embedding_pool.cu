// Fused int8 dequant-gather-pool (embedding bag): (B, d) float32.
//
// Replaces: src/repro/kernels/embedding_pool.py `_pool_kernel`
//           (pallas_call in `embedding_pool_pallas`), behind
//           `core/embedding.py:embedding_bag` (the rank stage's genre bag).
// Bound on the H100: the gathered bytes, B * L * (d + 4) (an int8 row and
//           its f32 scale per slot), plus the ids, weights and the f32
//           output. There is no reuse to exploit: each slot's row is read
//           once.
// Design:   one warp per bag; lanes run over d (looping when d > 32), so a
//           row of 32 int8 values is one 32-byte coalesced read. The bag's
//           L slots loop in order with the partial sum in a register; ids
//           < 0 (padding) are skipped, ids past the table clamp to its
//           last row (the reference's gather). Each term is
//           (value * scale) * w, summed in slot order with no fused
//           multiply-add, which is the plain version's arithmetic.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
pool_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
            const int32_t* __restrict__ ids, const float* __restrict__ weights,
            float* __restrict__ out, int n_rows, int d, int B, int L) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* bag = ids + static_cast<size_t>(b) * L;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      int id = __ldg(bag + l);
      if (id < 0) continue;      // padding
      id = min(id, n_rows - 1);  // clamped, as the reference's gather
      const float w = weights ? __ldg(weights + static_cast<size_t>(b) * L + l)
                              : 1.f;
      const float v = static_cast<float>(
          __ldg(values + static_cast<size_t>(id) * d + c));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v, __ldg(scales + id)), w));
    }
    out[static_cast<size_t>(b) * d + c] = acc;
  }
}

}  // namespace

REPRO_API int embedding_pool(const void* values, const void* scales,
                             const void* ids, const void* weights, void* out,
                             int n_rows, int d, int B, int L, void* stream) {
  if (B == 0 || d == 0) return 0;
  const int grid = (B + kWarps - 1) / kWarps;
  pool_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<const int32_t*>(ids), static_cast<const float*>(weights),
      static_cast<float*>(out), n_rows, d, B, L);
  return static_cast<int>(cudaGetLastError());
}
