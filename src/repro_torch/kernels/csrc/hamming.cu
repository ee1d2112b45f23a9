// Dense Hamming distances between packed LSH signatures: (q, n) int32.
//
// Replaces: src/repro/kernels/hamming_nns.py `_hamming_kernel`
//           (pallas_call in `hamming_distances_pallas`), the kernel of the
//           dense fixed-radius NNS plan (src/repro/core/nns.py).
// Bound on the H100: writing the (q, n) int32 output, 4 q n bytes at
//           3.35 TB/s: 0.95 us at q = 256, n = 3000 and 0.083 ms at
//           n = 262,143 (the largest dense catalog). Its inputs are 4W
//           bytes a row. The distance work does not bound it only if it
//           runs on the tensor cores: on the CUDA cores it is q n W
//           popcounts, and `POPC` issues at 16 a clock per SM (132 SMs at
//           1.98 GHz), 1.47 us and 0.128 ms at 8 words, above the bytes; as
//           the +-1 product (csrc/pm1.cuh) it is 2 q n 32W int8 operations,
//           0.20 us and 0.017 ms at 1,979 TOP/s.
// Design:   the distances come from the +-1 product on the int8 tensor
//           cores, d = (32W - acc) / 2, and the rest of the kernel is about
//           writing them.
//   Block:  4 warps hold 64 queries (16 a warp, one m16 tile), whose A
//           fragments come straight from the packed query words and stay in
//           registers (4W a thread) while the block walks DB tiles of 64
//           rows (tile blockIdx.x, then + gridDim.x, ...): each DB row is
//           read and expanded once per 64 queries. The grid is one wave of
//           resident blocks (about 100 registers a thread, 19 KB of shared
//           memory: four blocks an SM), so the A fragments are set up once
//           a block.
//   Tile:   the tile's words, loaded into registers during the previous
//           tile's epilogue, are expanded into a K-major +-1 tile in shared
//           memory; B fragments come by `ldmatrix`; a warp runs 8 m16n8k32
//           accumulators over W k steps, 8 independent products a step.
//   Output: each warp stages its 16 x 64 distances in shared memory (the
//           expanded tile's bytes, after a barrier; 8-byte stores free of
//           bank conflicts), and a half-warp writes one output row as 16
//           aligned 16-byte streaming stores (evict-first: the output is
//           written once). Rows are aligned because the output's row
//           stride is n rounded up to a multiple of 4 (the wrapper returns
//           the (q, n) view): with an odd n, rows that start mid-sector
//           would need masked 4-byte stores at both ends of every tile
//           row, and partial sectors, which cost as much as the rest of the
//           write. Queries >= q are never stored; rows >= n only into the
//           row padding.
#include <limits.h>

#include "common.cuh"
#include "mma.cuh"
#include "pm1.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = kWarps * 16;  // queries per block, 16 a warp
constexpr int kNTile = 64;           // DB rows per tile
// staged words per query row: 64 distances, padded to 72 so that the
// fragments' 8-byte stores hit 32 distinct banks and rows stay 16-byte
// aligned
constexpr int kStLd = kNTile + 8;
constexpr int kStageBytes = kQTile * kStLd * 4;

template <int W>
struct Layout {
  static constexpr int kTileBytes = kNTile * repro::pm1_row_bytes<W>();
  static constexpr int kLoads = (kNTile * W + kThreads - 1) / kThreads;
  static constexpr int kSmem =
      kTileBytes > kStageBytes ? kTileBytes : kStageBytes;
};

// This thread's packed words of the tile at row0: (min(64, n - row0) W)
// contiguous words, word e to thread e % 128, 0 past the end.
template <int W, int L>
__device__ __forceinline__ void load_tile(uint32_t (&r)[L],
                                          const uint32_t* __restrict__ db,
                                          int row0, int n, int tid) {
  const uint32_t* base = db + static_cast<size_t>(row0) * W;
  const int n_words = min(kNTile, n - row0) * W;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int e = tid + kThreads * m;
    r[m] = e < n_words ? __ldg(base + e) : 0u;
  }
}

// ld: the output's row stride in int32, a multiple of 4 (>= n), so that
// every output row starts 16-byte aligned.
template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
               int32_t* __restrict__ out, int nq, int n, int ld,
               int n_tiles) {
  using Lay = Layout<W>;
  constexpr int kLd = repro::pm1_row_bytes<W>();
  __shared__ __align__(16) uint8_t smem[Lay::kSmem];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw = blockIdx.y * kQTile + warp * 16;  // the warp's first query

  // +-1 A fragments of the warp's 16 queries (past nq: +1s, never stored)
  uint32_t a[W][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + 8 * h + g;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t v =
          row < nq ? __ldg(q + static_cast<size_t>(row) * W + s) : 0u;
      a[s][h] = repro::pm1(v, t4);
      a[s][2 + h] = repro::pm1(v, t4 + 4);
    }
  }

  const uint32_t xs =
      repro::smem_u32(smem) + repro::ldmatrix_lane_offset<W>(lane);
  int32_t* st = reinterpret_cast<int32_t*>(smem) + warp * 16 * kStLd;
  uint32_t r[Lay::kLoads];
  int tile = blockIdx.x;
  if (tile < n_tiles) load_tile<W>(r, db, tile * kNTile, n, tid);
  for (; tile < n_tiles; tile += gridDim.x) {
    repro::expand_tile<W, kNTile, kThreads>(smem, r, tid);
    __syncthreads();  // the expanded tile is complete

    // acc[j] for query rows {g, g + 8} and DB rows 8 j + 2 t4 + {0, 1}:
    // two k steps at a time, B fragments of 4 n8 tiles loaded before
    // their 8 independent products of a step
    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
    for (int s = 0; s < W; s += 2) {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        uint32_t b[2][2][4];  // [n8 pair][n8 tile][fragment]
#pragma unroll
        for (int p = 0; p < 2; ++p)
          repro::load_b<W>(b[p], xs + 16 * (2 * jh + p) * kLd, s);
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          if (s + step < W) {
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
                repro::mma_s8_16832(acc[4 * jh + 2 * p + jj], a[s + step],
                                    b[p][jj][2 * step],
                                    b[p][jj][2 * step + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the tile: its bytes stage
    const int next = tile + gridDim.x;
    if (next < n_tiles)  // in flight during the epilogue
      load_tile<W>(r, db, next * kNTile, n, tid);

    // distances into the warp's 16 staging rows, 8 bytes a lane
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<int2*>(st + (8 * h + g) * kStLd + 8 * j + 2 * t4) =
            make_int2((32 * W - acc[j][2 * h]) >> 1,
                      (32 * W - acc[j][2 * h + 1]) >> 1);
    __syncwarp();
    // a half-warp per output row, one aligned 16-byte store a lane; the
    // columns past n up to ld are the row's padding
    const int c0 = tile * kNTile;
    const int c = c0 + 4 * (lane & 15);
#pragma unroll
    for (int rr = lane >> 4; rr < 16; rr += 2) {
      if (qw + rr < nq && c < ld)  // evict-first: the output streams
        __stcs(reinterpret_cast<int4*>(out + static_cast<size_t>(qw + rr) * ld
                                       + c),
               *reinterpret_cast<const int4*>(st + rr * kStLd +
                                              4 * (lane & 15)));
    }
    __syncthreads();  // the staging is read out before the next expansion
  }
}

// One wave of resident blocks, spread over the query tiles.
template <int W>
int launch(const void* q, const void* db, void* out, int nq, int n, int ld,
           cudaStream_t s) {
  static int resident = 0;  // blocks of this kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hamming_kernel<W>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = max(1, sms * per_sm);
  }
  const int n_tiles = (n + kNTile - 1) / kNTile;
  const int q_tiles = (nq + kQTile - 1) / kQTile;
  const int gx = min(n_tiles, max(1, (resident + q_tiles - 1) / q_tiles));
  hamming_kernel<W><<<dim3(gx, q_tiles), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
      static_cast<int32_t*>(out), nq, n, ld, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (nq, words), db: (n, words) packed signatures; out: (nq, ld) int32,
// 16-byte aligned, with ld >= n a multiple of 4 (columns n..ld-1 of each
// row are padding, overwritten). nq is at most 65535 * 64 (the grid's y
// extent), and n at most INT_MAX - 64.
REPRO_API int hamming_distances(const void* q, const void* db, void* out,
                                int nq, int n, int ld, int words,
                                void* stream) {
  if (nq < 0 || n < 0 || (nq - 1) / kQTile >= 65535 || n > INT_MAX - kNTile ||
      ld < n || ld % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_WORDS(words, return launch<W>(q, db, out, nq, n, ld, s));
  return 0;
}
