// Flash attention forward: (bh, sq, d) x (bh, sk, d) -> (bh, sq, d).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel`
//           (pallas_call in `flash_attention_pallas`), reached from
//           `models/attention.py:attention(..., attn_impl="flash")` in an
//           LM prefill.
// Bound on the H100: the tensor-core rate on the causal pairs, 4 * d
//           flops per (row, key) pair a row may see (two products), at
//           989 TFLOP/s for bf16; the bytes (q, k, v read once, out written
//           once) are ~2x smaller in time at d = 128, s = 2048. The bf16
//           path runs on the tensor cores (`mma.sync` m16n8k16, bf16 in,
//           f32 accumulators); the f32 path stays on the CUDA cores in
//           float32 (67 TFLOP/s at most), since bf16 or TF32 operands (TF32
//           keeps ~3 decimal digits) cannot meet its 2e-5 tolerance and no
//           model path runs attention in f32.
// Design:   bf16 (FlashAttention-2 on `mma.sync`): one block of 4 warps per
//           (bh, tile of 64 q rows), each warp owning 16 rows. The grid's y
//           runs the q tiles last to first under `causal`, so the heaviest
//           tiles (most keys) start first and the light ones fill the tail.
//           Q's tile is copied once with `cp.async` and held in registers
//           as A fragments (`ldmatrix.x4`). 64-key tiles of K and V are
//           double-buffered in dynamic shared memory with `cp.async.cg`:
//           tile j + 1 loads while tile j computes. Rows are padded by 8
//           bf16 (272-byte stride at d = 128), so the 8 rows an `ldmatrix`
//           reads fall in 8 different 16-byte bank groups. S = Q K^T takes
//           K as the B operand by plain `ldmatrix` (K row-major is K-major
//           for B); the online softmax runs on the accumulator fragments,
//           its row max and sum reduced over the 4 lanes of a quad, with
//           scale * log2(e) folded in and 2^x straight on the special-
//           function unit (`ex2.approx`). P is rounded to bf16 and
//           reused in registers as the A fragment of O += P V (two m16n8
//           C fragments form one m16k16 A fragment), V entering by
//           `ldmatrix.trans`. Only tiles that cross the causal diagonal or
//           the ragged end of sk compare indices and select. Shared
//           memory at d = 128: Q 17 KB + two stages of K and V 68 KB; with
//           at most 255 registers a thread, two blocks fit an SM.
//           f32: one block per (bh, 64 q rows) of 256 threads on the CUDA
//           cores, float32 tiles with padded strides in shared memory (113
//           KB at d = 128), each thread 4 rows x 4 score columns.
//           Both keep the TPU kernel's arithmetic: s = (q . k) * scale,
//           masked scores -1e30 and masked probabilities exactly 0, out =
//           acc / max(l, 1e-30) in q's type, so a row with no valid key
//           gives 0; `q_offset` places q[0] in the kv sequence. The bf16
//           path differs only in rounding P to bf16 before P V, as every
//           tensor-core flash kernel does. The wrapper guarantees 16-byte
//           aligned q, k, v and out, which `cp.async` needs.
#include "common.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int sq,
             int sk, float scale, int causal, int q_offset) {
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
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] =
        q0 + r < sq ? qb[static_cast<size_t>(q0 + r) * D + c] : 0.f;
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
      ks[r * LD + c] = ok ? kb[g] : 0.f;
      vs[r * LD + c] = ok ? vb[g] : 0.f;
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

  float* ob = out + bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[static_cast<size_t>(r) * D + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, scale,
      causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;      // q rows per block, 16 per warp
constexpr int kBK = 64;      // keys per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;      // bf16 of padding per shared-memory row
constexpr int kNS = kBK / 8; // n-tiles of S per warp

template <int D>
constexpr int smem_bytes() {
  return (kBQ + 4 * kBK) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

// 2^x on the special-function unit (2^-1e30 is +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, rows) of a (rows, D) tile into shared memory at `dst` (stride
// D + kPad); rows at or past `valid` are zero-filled, not read.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int rows, int valid, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    repro::cp_async16(dst + ((r * (D + kPad) + c * 8) * sizeof(bf16)),
                      ok ? src + static_cast<size_t>(r) * D + c * 8 : src,
                      ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
             int sk, float scale_log2, int causal, int q_offset) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;  // k-steps of Q K^T: Q's A fragments
  constexpr int ND = D / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [kBQ][LD]
  bf16* ks = qs + kBQ * LD;                   // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;               // [2][kBK][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  // causal: the last q tiles see the most keys, so they go first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBQ;
  const bf16* qb = q + (bh * sq + q0) * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;

  // keys past the last row's causal diagonal are never seen by this tile
  const int kv_end = causal ? min(sk, q_offset + q0 + kBQ) : sk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  const uint32_t qs_u = repro::smem_u32(qs);
  const uint32_t ks_u = repro::smem_u32(ks);
  const uint32_t vs_u = repro::smem_u32(vs);
  constexpr uint32_t kStage = kBK * LD * sizeof(bf16);
  load_tile<D>(qs_u, qb, kBQ, sq - q0, tid);
  if (n_tiles > 0) {
    load_tile<D>(ks_u, kb, kBK, sk, tid);
    load_tile<D>(vs_u, vb, kBK, sk, tid);
  }
  repro::cp_async_commit();

  // the lane's ldmatrix row offsets (in elements) within a 16 x 16 block
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // Q; V (keys)
  const int a_col = (lane >> 4) * 8;                     // Q; V (d)
  const int k_row = (lane & 7) + (lane >> 4) * 8;        // K (keys)
  const int k_col = ((lane >> 3) & 1) * 8;               // K (d)

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of s * scale * log2(e)
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  const int warp_row = q_offset + q0 + warp * 16;  // first row, kv coords
  const int row_g = warp_row + g;                  // rows g and g + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int k1 = (j + 1) * kBK;
      load_tile<D>(ks_u + (buf ^ 1) * kStage, kb + static_cast<size_t>(k1) * D,
                   kBK, sk - k1, tid);
      load_tile<D>(vs_u + (buf ^ 1) * kStage, vb + static_cast<size_t>(k1) * D,
                   kBK, sk - k1, tid);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KD; ++kc)
        repro::ldmatrix_x4(
            qf[kc], qs_u + ((warp * 16 + a_row) * LD + kc * 16 + a_col) *
                               sizeof(bf16));
    }

    // S = Q K^T on this warp's 16 rows x 64 keys
    const uint32_t kt = ks_u + buf * kStage;
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
      for (int np = 0; np < kNS / 2; ++np) {
        uint32_t b[4];
        repro::ldmatrix_x4(
            b, kt + ((np * 16 + k_row) * LD + kc * 16 + k_col) * sizeof(bf16));
        repro::mma_bf16_16816(s[2 * np], qf[kc], b[0], b[1]);
        repro::mma_bf16_16816(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // online softmax on the fragments: element e of n-tile n is row
    // row_g + 8 (e / 2), key k0 + 8 n + 2 t + e % 2
    const int k0 = j * kBK;
    const bool full = k0 + kBK <= sk && (!causal || k0 + kBK - 1 <= warp_row);
    uint32_t valid = 0;  // bit 4 n + e, set only where !full
    float mx[2] = {m[0], m[1]};
    if (full) {
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row_g + 8 * (e >> 1);
          const bool ok = col < sk && (!causal || col <= row);
          valid |= static_cast<uint32_t>(ok) << (4 * n + e);
          s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked probability is 0 outright: ex2(-1e30 - -1e30) is 1
        const float p = full || (valid >> (4 * n + e)) & 1u
                            ? ex2(s[n][e] - mx[e >> 1]) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P in bf16 straight from the S fragments
    const uint32_t vt = vs_u + buf * kStage;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        repro::ldmatrix_x4_trans(
            b, vt + ((kc * 16 + a_row) * LD + np * 16 + a_col) * sizeof(bf16));
        repro::mma_bf16_16816(o[2 * np], pa, b[0], b[1]);
        repro::mma_bf16_16816(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // tile j's buffer is free for tile j + 2
  }
  repro::cp_async_wait<0>();  // no copy outlives the block

  bf16* ob = out + (bh * sq + q0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
    if (q0 + row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * D + 8 * n +
                                   2 * t) =
          pack_bf16(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk,
      scale * 1.4426950408889634f, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// return LAUNCH<D>(...) for the head dims the port supports
#define REPRO_DISPATCH_D(LAUNCH, ...)                        \
  switch (d) {                                               \
    case 16: return LAUNCH<16>(__VA_ARGS__);                 \
    case 32: return LAUNCH<32>(__VA_ARGS__);                 \
    case 64: return LAUNCH<64>(__VA_ARGS__);                 \
    case 128: return LAUNCH<128>(__VA_ARGS__);               \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
REPRO_API int flash_attention(const void* q, const void* k, const void* v,
                              void* out, int bh, int sq, int sk, int d,
                              int dtype, float scale, int causal, int q_offset,
                              void* stream) {
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_DISPATCH_D(simt::launch, q, k, v, out, bh, sq, sk, scale, causal,
                     q_offset, s)
  }
  if (dtype == 1) {
    REPRO_DISPATCH_D(tc::launch, q, k, v, out, bh, sq, sk, scale, causal,
                     q_offset, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
