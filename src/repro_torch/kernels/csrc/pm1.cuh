// Packed signature bits as int8 +-1 operands of the s8 tensor-core product,
// shared by the dense Hamming kernel and the streaming NNS kernel (sm_90a).
//
// The identity: a bit b maps to the int8 1 - 2b (0 -> +1, 1 -> -1). For two
// signatures of 32W bits, dot(a+-, b+-) = 32W - 2 ham(a, b), an exact
// integer product, so ham = (32W - dot) / 2. The bit order of the expansion
// is free as long as queries and rows share it: byte b of expanded word j
// of a 32-bit word w is bit j + 8b of w (`pm1`), and each packed word is
// one k32 step of `mma.sync.m16n8k32.s8`, so any W in 1..8 needs no padding
// of K.
//
// A fragments (queries) come straight from the packed words: lane (g, t)
// holds pm1(word, t) in the first half of K and pm1(word, t + 4) in the
// second. B fragments (DB rows) come by `ldmatrix` from a K-major tile in
// shared memory, one row of 32W expanded bytes per DB row, padded by 16
// bytes so that the 8 rows `ldmatrix` reads at once hit 32 distinct banks
// (the row stride in words, 8W + 4, times any 8 consecutive rows covers
// every residue mod 32 in 4-word steps). K-major is already the "col" B
// layout, so no transpose is needed.
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace repro {

// Four +-1 bytes of `w`: byte b is -1 (0xff) where bit j + 8b is set, +1
// where it is clear. The shift brings bit j + 8b to the top of byte b,
// `prmt` replicates each byte's top bit over the byte (selector nibbles
// with bit 3 set), and the OR turns 0x00 into +1.
__device__ __forceinline__ uint32_t pm1(uint32_t w, int j) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(r) : "r"(w << (7 - j)), "r"(0u));
  return r | 0x01010101u;
}

// Bytes per expanded row of W words.
template <int W>
__host__ __device__ constexpr int pm1_row_bytes() {
  return 32 * W + 16;
}

// A tile of kRows rows, loaded as (kRows W) contiguous words with word e
// held by thread e % kThreads in r[e / kThreads] (0 past the tile's end),
// expanded into the K-major +-1 tile at `x`.
template <int W, int kRows, int kThreads, int L>
__device__ __forceinline__ void expand_tile(uint8_t* x,
                                            const uint32_t (&r)[L], int tid) {
  constexpr int kLd = pm1_row_bytes<W>();
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int e = tid + kThreads * m;
    if (e < kRows * W) {
      uint4* dst = reinterpret_cast<uint4*>(x + (e / W) * kLd + 32 * (e % W));
      const uint32_t v = r[m];
      dst[0] = make_uint4(pm1(v, 0), pm1(v, 1), pm1(v, 2), pm1(v, 3));
      dst[1] = make_uint4(pm1(v, 4), pm1(v, 5), pm1(v, 6), pm1(v, 7));
    }
  }
}

// B fragments of k steps s and s + 1 (only s when s + 1 == W) for two n8
// tiles of 8 rows each, rows 0-7 and 8-15 from the address of the lane
// (`xs` already holds the lane's offset: row lane % 8, byte 16 (lane / 8)).
// b[j][0..1] is step s of n8 tile j, b[j][2..3] step s + 1.
template <int W>
__device__ __forceinline__ void load_b(uint32_t (&b)[2][4], uint32_t xs,
                                       int s) {
  constexpr int kLd = pm1_row_bytes<W>();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t addr = xs + 8 * j * kLd + 32 * s;
    if (s + 1 < W) {
      ldmatrix_x4(b[j], addr);
    } else {
      uint32_t b2[2];
      ldmatrix_x2(b2, addr);
      b[j][0] = b2[0];
      b[j][1] = b2[1];
    }
  }
}

// The lane's offset into an expanded tile for `load_b`: lane l of
// `ldmatrix` gives row l % 8 of matrix l / 8, 16 K bytes each.
template <int W>
__device__ __forceinline__ uint32_t ldmatrix_lane_offset(int lane) {
  return (lane & 7) * pm1_row_bytes<W>() + 16 * (lane >> 3);
}

}  // namespace repro
