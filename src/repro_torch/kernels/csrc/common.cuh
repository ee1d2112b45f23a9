// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Packed LSH signatures are `words` uint32 lanes per row (8 at the paper's
// 256 bits), stored by PyTorch as int32 tensors holding the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Every library exports this, so the Python side can name an error code.
REPRO_API const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// One row of W packed words into registers: two 16-byte loads at W = 8.
// The caller guarantees 16-byte alignment of the table when W % 4 == 0.
template <int W>
__device__ __forceinline__ void load_sig(const uint32_t* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      uint4 x = __ldg(v + i);
      w[4 * i + 0] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldg(p + i);
  }
}

template <int W>
__device__ __forceinline__ int hamming(const uint32_t (&a)[W],
                                       const uint32_t (&b)[W]) {
  int d = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) d += __popc(a[i] ^ b[i]);
  return d;
}

}  // namespace repro

// Instantiate BODY with a compile-time word count W in 1..8; any other
// count returns cudaErrorInvalidValue from the enclosing C function.
#define REPRO_DISPATCH_WORDS(words, ...)               \
  switch (words) {                                     \
    case 1: { constexpr int W = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int W = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int W = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int W = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int W = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int W = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int W = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int W = 8; __VA_ARGS__; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
