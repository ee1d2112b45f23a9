// Flash attention forward: (bh, sq, d) x (bh, sk, d) -> (bh, sq, d).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel`
//           (pallas_call in `flash_attention_pallas`), reached from
//           `models/attention.py:attention(..., attn_impl="flash")` in an
//           LM prefill.
// Bound on the H100: the tensor-core rate on the causal pairs, 4 * d
//           flops per (row, key) pair a row may see (two products), at
//           989 TFLOP/s for bf16; the bytes (q, k, v read once, out written
//           once) are ~2x smaller in time at d = 128, s = 2048. This kernel
//           runs on the CUDA cores in float32 (67 TFLOP/s at most), so it
//           sits well above that bound; tensor cores (mma.sync / wgmma) are
//           later work.
// Design:   one block per (bh, tile of 64 q rows); the block walks 64-key
//           tiles of K and V up to the causal diagonal of its last row
//           (`q_offset + last row`), keeping the running max m, the sum l
//           and the (64, d) accumulator in registers. The tiles live in
//           dynamic shared memory as float32 with a padded row stride (no
//           bank conflicts on the column reads): at d = 128 Q, K, V and the
//           64 x 64 probability tile take 113 KB, above the 48 KB of static
//           shared memory, hence `cudaFuncSetAttribute`. 256 threads: each
//           owns 4 rows and, of the scores, 4 columns (tx + 16 j) and, of
//           the accumulator, d / 16 columns; a row's max and sum reduce over
//           the 16 lanes of a half-warp by shuffles. The arithmetic is the
//           TPU kernel's: s = (q . k) * scale, masked scores -1e30 and
//           masked probabilities 0, out = acc / max(l, 1e-30) in q's type,
//           so a row with no valid key gives 0.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             float scale, int causal, int q_offset) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;    // padded row stride of the Q, K, V tiles
  constexpr int LP = kBK + 1;  // padded row stride of the probability tile
  constexpr int DC = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [kBQ][LD]
  float* ks = qs + kBQ * LD;   // [kBK][LD]
  float* vs = ks + kBK * LD;   // [kBK][LD]
  float* ps = vs + kBK * LD;   // [kBQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] =
        q0 + r < sq ? to_f32(qb[static_cast<size_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys past the last row's causal diagonal are never seen by this tile
  const int kv_end = causal ? min(sk, q_offset + q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < sk;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      ks[r * LD + c] = ok ? to_f32(kb[g]) : 0.f;
      vs[r * LD + c] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < sk && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(repro::kFullMask, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(ob + static_cast<size_t>(r) * D + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, scale, causal,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, int d, float scale, int causal, int q_offset,
               cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, bh, sq, sk, scale, causal, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, out, bh, sq, sk, scale, causal, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, out, bh, sq, sk, scale, causal, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, out, bh, sq, sk, scale, causal, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
REPRO_API int flash_attention(const void* q, const void* k, const void* v,
                              void* out, int bh, int sq, int sk, int d,
                              int dtype, float scale, int causal, int q_offset,
                              void* stream) {
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, bh, sq, sk, d, scale, causal,
                             q_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, scale,
                                     causal, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
