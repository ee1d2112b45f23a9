// Streaming fixed-radius Hamming NNS: the best K matches per query, sorted
// by (distance, row), plus the count of all matches within the radius.
//
// Replaces: src/repro/kernels/streaming_nns.py `_streaming_nns_kernel` and
//           its `_masked_`, `_pruned_` and `_masked_pruned_` variants
//           (pallas_call in `streaming_nns_pallas`), the kernel of the
//           streaming plan of `core/nns.py:fixed_radius_nns`.
// Bound on the H100: the distance work, the least of two engines. On the
//           int8 tensor cores it is 2 q n 32W operations (the +-1 product
//           below) at 1,979 TOP/s: 0.069 ms at 256 queries x 1,048,576
//           rows of 8 words. On the CUDA cores it is q n W popcounts, and
//           `POPC` issues at 16 a clock per SM (132 SMs at 1.98 GHz: 4.18
//           T/s): 0.51 ms, so no CUDA-core design comes near the tensor
//           cores. The bytes (each row of 4W bytes read once) are far below
//           either, and the candidate buffers are tiny.
// The +-1 identity (csrc/pm1.cuh): a bit b maps to the int8 1 - 2b, and
//           for two signatures of 32W bits dot(a+-, b+-) = 32W - 2 ham(a,
//           b), an exact integer product. So a row matches iff
//           dot >= 32W - 2 radius, with no division, and its distance is
//           (32W - dot) / 2. Each packed word is one k32 step of
//           `mma.sync.m16n8k32.s8` (`pm1` expands it), so any W in 1..8
//           needs no padding of K.
// Design:   the TPU walks the DB in order with one resident buffer; here
//           blocks run in parallel: pass 0, pass 1, then a merge.
//   Pass 1: block (split, query tile) holds 128 queries, 4 warps of 32
//           (two m16 tiles each); each warp keeps its queries' +-1 A
//           fragments in registers (8W a thread) for the whole split. The
//           DB streams in tiles of 64 rows: each thread loads its packed
//           words of tile i + 2 into registers while tile i computes, and
//           expands them into a K-major +-1 tile in shared memory (rows
//           padded by 16 bytes, so `ldmatrix` is free of bank conflicts).
//           K-major is already the "col" B layout: B fragments come by plain
//           `ldmatrix`, and each feeds both m16 tiles of a warp. One
//           barrier a tile; the expanded tiles are double-buffered.
//           The tile is 4 groups of 16 rows (2 m16n8 accumulators per m16
//           tile), software-pipelined: group g + 1's product is in flight
//           while group g's epilogue runs. The first k step takes its
//           accumulator from registers holding -threshold, and a row that
//           must not match (past the tile's end: ragged tail, rows >=
//           n_valid; or mask byte 0) gets a large penalty subtracted, only
//           in the groups that have one. So a match is acc >= 0, and:
//           the AND of a lane's accumulators is negative iff none matches,
//           and `__any_sync` skips such a group; the count of a query row
//           is 4 + the sum of acc >> 31 over its 4 entries (integer adds in
//           registers, summed over the quad by shuffles at the end, so the
//           count is deterministic); the AND of acc - cand says whether the
//           lane holds a candidate (below). Phase B matches ~3% of its
//           pairs, so nearly every group has matches but few candidates: a
//           lane with one spills its 16 dot products to shared memory and
//           walks them by a bit mask, appending each candidate under its
//           query's current K-th best key to the query's stage in shared
//           memory with a shared atomic. The 32-bit key
//           `dist << 23 | local_row` is unique within a split, so the order
//           of appends cannot change the result.
//           Top-K: each lane owns one of its warp's 32 queries and keeps its
//           best K keys as a max-heap in shared memory (rows of an odd
//           number of words, so the 32 lanes hit 32 banks); after each tile
//           it drains its query's stage into the heap (an insert while it
//           holds fewer than K keys, a root replacement after), and the
//           root of a full heap is the exact threshold of the next tile. A
//           staged key costs O(log K) on one lane, not a warp-wide sort,
//           and O(1) on average while the heap fills. At the end each lane
//           heapsorts its keys and appends the valid ones, widened to 64
//           bits `dist << 32 | global_row`, to its query's candidate list
//           at an offset taken with one global atomic (the merge's result
//           does not depend on the order); the counts go to scratch per
//           (query, split).
//   Pass 0: the same scan over every 16th tile adds each match to a
//           per-query histogram of distances (global atomics), and a small
//           kernel finds D0, the least distance at which the sample holds K
//           matches. The whole DB then holds at least K matches within D0,
//           so no key beyond D0 can be in the top K: pass 1 counts every
//           match but takes as candidates only those with d <= D0. Without
//           that bound each split warms up its own K keys (phase B has 128
//           splits), and the appends, not the product, set the pace.
//   Pruning: a block scans a summary block unless every query of its tile
//           prunes it (the Pallas kernel's own rule). The outputs equal the
//           plain version's because the block-summary bound is sound: a
//           pruned (query, block) holds no match, so scanning it adds no
//           candidate and no count. The plain version agrees with the kernel
//           on sound prune masks only, as the Pallas kernel does.
//   Merge:  one warp per query takes the best K of its candidate list: a
//           histogram of their distances gives the K-th smallest, only keys
//           at or below it are staged, and a bitonic sort over the least
//           power of two that holds them keeps the best K. It decodes keys
//           to (row, dist) with (-1, BIG_DIST) padding and sums the counts.
//   The 64-bit key orders exactly by (distance, global row), so the output
//   equals the dense threshold + stable top-K for any split layout
//   (superblocks need no special case).
#include <limits.h>

#include "common.cuh"
#include "mma.cuh"
#include "pm1.cuh"

namespace {

constexpr int kMaxK = 128;                // largest max_candidates
constexpr int kBigDist = 1 << 30;         // BIG_DIST of the Python side
constexpr unsigned long long kSentinel = ~0ull;

// pass 1
constexpr int kScanWarps = 4;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kQTile = kScanWarps * 32;   // queries per block
constexpr int kNTile = 64;                // DB rows per pipeline step
constexpr int kLocalBits = 23;            // split-local row bits of a key
constexpr unsigned kLocalMask = (1u << kLocalBits) - 1u;
constexpr unsigned kSentinel32 = ~0u;

// pass 0 and the merge
constexpr int kMergeWarps = 4;            // queries per block
constexpr int kMergeUnroll = 4;           // 32-key chunks loaded together
constexpr int kSample = 16;               // pass 0 scans every 16th tile
// per query in the histogram scratch: 257 distance bins (0..256), then the
// length of its candidate list, then its bound D0
constexpr int kHistBins = 257;
constexpr int kFilled = kHistBins;
constexpr int kBound = kHistBins + 1;
constexpr int kHistCols = kHistBins + 2;
constexpr int kSortN = 512;               // per-warp keys: best K + staging

// Ascending bitonic sort of N keys in shared memory by one warp (N a power
// of two).
template <typename T>
__device__ __forceinline__ void warp_sort(T* s, int N, int lane) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < N; i += 32) {
        const int j = i ^ stride;
        if (j > i) {
          const T a = s[i], b = s[j];
          if ((a > b) == ((i & size) == 0)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int W>
struct ScanLayout {
  static constexpr int kLd = repro::pm1_row_bytes<W>();
  static constexpr int kTile = kNTile * kLd;
  static constexpr int kLoads = (kNTile * W + kScanThreads - 1) / kScanThreads;
};

// Words of shared memory per query: a heap of k keys, a stage of one
// tile's worth, padded to an odd count so that lanes that each walk their
// own query hit different banks.
__host__ __device__ constexpr int query_stride(int k) {
  return (k + kNTile) | 1;
}

// Words a thread spills its 16 dot products of a group to when one of
// them is a candidate (odd, so the lanes hit different banks).
constexpr int kSpill = 17;
// far below any dot - thr of a valid row: keeps a row out of every test
constexpr int kPenalty = 1 << 20;
// threshold of a query row past nq: no dot reaches it
constexpr int kNoQuery = 1 << 24;

// two expanded tiles, then per query its keys, a stage count and a key
// threshold, then the threads' spill rows
template <int W>
constexpr int scan_smem_bytes(int k) {
  return 2 * ScanLayout<W>::kTile + kQTile * query_stride(k) * 4 +
         2 * kQTile * 4 + kScanThreads * kSpill * 4;
}

// The rows a block scans, in tiles of at most kNTile rows: its split
// [lo, hi) cut into segments (summary blocks when pruning), a segment
// skipped when every query of the block prunes it; with sample > 1, only
// every sample-th tile. Every thread of the block calls `next` together
// (it may hold a barrier).
struct Tiles {
  const uint8_t* prune;
  int nq, nb, prune_rows, seg, hi, qi;  // qi: this thread's query
  int lo, sample;
  int s1, t;  // end of the current segment, start of the next tile

  __device__ int2 next() {
    for (;;) {
      while (t >= s1) {
        if (s1 >= hi) return make_int2(-1, -1);
        const int s0 = s1;
        s1 = min(s0 + seg, hi);
        t = s0;
        if (prune) {
          const int b = s0 / prune_rows;
          const bool need =
              b >= nb ||
              (qi < nq && !prune[static_cast<size_t>(qi) * nb + b]);
          if (!__syncthreads_or(need)) t = s1;
        }
      }
      const int t0 = t;
      t = min(t + kNTile, s1);
      if (sample == 1 || (t0 - lo) / kNTile % sample == 0)
        return make_int2(t0, t);
    }
  }
};

// This thread's packed words of tile [t.x, t.y) (0 past its end): the
// tile is (t.y - t.x) W contiguous words, word e to thread e % 128.
template <int W, int L>
__device__ __forceinline__ void load_tile(uint32_t (&r)[L],
                                          const uint32_t* __restrict__ db,
                                          int2 t, int tid) {
  const uint32_t* base = db + static_cast<size_t>(max(t.x, 0)) * W;
  const int n_words = t.x >= 0 ? (t.y - t.x) * W : 0;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    const int e = tid + kScanThreads * m;
    r[m] = e < n_words ? __ldg(base + e) : 0u;
  }
}

// Put `key` at the root of the max-heap h[0, n) and sift it down.
__device__ __forceinline__ void sift_down(uint32_t* h, int n, uint32_t key) {
  int i = 0;
  for (;;) {
    int c = 2 * i + 1;
    if (c >= n) break;
    if (c + 1 < n && h[c + 1] > h[c]) ++c;
    if (h[c] <= key) break;
    h[i] = h[c];
    i = c;
  }
  h[i] = key;
}

// Insert `key` into the max-heap h[0, n) as its element n.
__device__ __forceinline__ void sift_up(uint32_t* h, int n, uint32_t key) {
  int i = n;
  while (i > 0) {
    const int p = (i - 1) >> 1;
    const uint32_t pv = h[p];
    if (pv >= key) break;
    h[i] = pv;
    i = p;
  }
  h[i] = key;
}

// The lane's own query: its staged keys go into its max-heap of the best
// k keys seen (`filled` of them so far: an insert until it is full, then a
// key below the root replaces it). The threshold of the next tile is then
// exact: the root once the heap is full, no limit before.
__device__ __forceinline__ void drain_stage(uint32_t* h, int* staged,
                                            uint32_t* thr_key, int k,
                                            int& filled) {
  const int n = *staged;
  if (n == 0) return;
  for (int i = 0; i < n; ++i) {
    const uint32_t key = h[k + i];
    if (filled < k) {
      sift_up(h, filled, key);
      ++filled;
    } else if (key < h[0]) {
      sift_down(h, k, key);
    }
  }
  *staged = 0;
  *thr_key = filled < k ? kSentinel32 : h[0];
}

// pen[j][col] for the lane's DB rows row0 + 8 j + 2 t4 + col: kPenalty
// past the tile's end (ragged tail, rows >= n_valid) or where the mask
// byte is 0, else 0; false (and pen untouched) when the group is whole and
// unmasked.
__device__ __forceinline__ bool row_penalty(int (&pen)[2][2], int2 tile,
                                            int row0, int t4,
                                            const uint8_t* mask) {
  if (mask == nullptr && row0 + 16 <= tile.y) return false;  // the common case
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const int row = row0 + 8 * j + 2 * t4 + col;
      const bool ok = row < tile.y && (mask == nullptr || mask[row] != 0);
      pen[j][col] = ok ? 0 : kPenalty;
    }
  return true;
}

// One 16-row group of DB rows against the warp's 32 queries: 2 n8 tiles
// x 2 m16 tiles. acc[j][i][e] ends at dot - thr - pen for query row
// 16 i + 8 (e / 2) + g of the warp and DB row 8 j + 2 t4 + e % 2 of the
// group: the first k step takes its accumulator from c0[i] (= -thr of the
// fragment's rows), and pen, kPenalty for a row that must not match (past
// the tile, or masked out), is subtracted only when `any_pen`. B fragments
// come from the expanded tile at `xs`.
template <int W>
__device__ __forceinline__ void group_mma(int (&acc)[2][2][4],
                                          const uint32_t (&a)[2][W][4],
                                          const int (&c0)[2][4],
                                          const int (&pen)[2][2],
                                          bool any_pen, uint32_t xs) {
  // two k steps at a time: the B fragments of both n8 tiles for the next
  // pair are loaded before this pair's products, and the 4 independent
  // accumulators of one step go before any of the next, so that an `mma`
  // waits neither on an `ldmatrix` nor on the `mma` just issued (the asm
  // statements keep their order)
  uint32_t b[2][2][4];  // [pair parity][j][fragment]
  repro::load_b<W>(b[0], xs, 0);
#pragma unroll
  for (int s = 0; s < W; s += 2) {
    if (s + 2 < W) repro::load_b<W>(b[((s >> 1) + 1) & 1], xs, s + 2);
    const uint32_t(&bb)[2][4] = b[(s >> 1) & 1];
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      if (s + step < W) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (s + step == 0)
              repro::mma_s8_16832(acc[j][i], a[i][0], bb[j][0], bb[j][1],
                                  c0[i]);
            else
              repro::mma_s8_16832(acc[j][i], a[i][s + step],
                                  bb[j][2 * step], bb[j][2 * step + 1]);
          }
      }
    }
  }
  if (any_pen) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][e] -= pen[j][e & 1];
  }
}

// W: signature words. Pass 0 (hist_mode) adds every match of the sampled
// tiles to hist[q][dist]; pass 1 counts every match, keeps the best K
// candidates of its split per query and appends them to the query's
// candidate list in keys_out.
template <int W>
__global__ void __launch_bounds__(kScanThreads, 2)
scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
            const uint8_t* __restrict__ mask, const uint8_t* __restrict__ prune,
            int nq, int limit, int radius, int k, int split_rows, int n_splits,
            int prune_rows, int nb, bool hist_mode, int* __restrict__ hist,
            unsigned long long* __restrict__ keys_out,
            int32_t* __restrict__ counts_out) {
  using Lay = ScanLayout<W>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int stride = query_stride(k);
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem + 2 * Lay::kTile);
  int* staged = reinterpret_cast<int*>(buf + kQTile * stride);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t* thr_key = reinterpret_cast<uint32_t*>(staged + kQTile);
  int* spill = staged + 2 * kQTile + tid * kSpill;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.y * kQTile;
  const int split = blockIdx.x;
  const int lo = split * split_rows;
  const int hi = min(lo + split_rows, limit);

  for (int i = tid; i < kQTile * stride; i += kScanThreads)
    buf[i] = kSentinel32;
  if (tid < kQTile) {
    staged[tid] = 0;
    thr_key[tid] = kSentinel32;
  }

  // the +-1 A fragments of this warp's 32 queries (rows past nq: +1s,
  // which never match: their threshold is kNoQuery). A match is
  // dot >= thr; in pass 1 a candidate also has distance <= the query's
  // bound D0, i.e. dot - thr >= cand.
  const int thr_dot = 32 * W - 2 * radius;  // radius clamped by the host
  uint32_t a[2][W][4];
  int thr[2][2], cand[2][2], cnt[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 32 + 16 * i + 8 * h + g;
      thr[i][h] = row < nq ? thr_dot : kNoQuery;
      const int b = !hist_mode && row < nq
                        ? hist[static_cast<size_t>(row) * kHistCols + kBound]
                        : INT_MAX;
      cand[i][h] = 2 * max(0, radius - min(b, radius));
      cnt[i][h] = 0;
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const uint32_t v =
            row < nq ? __ldg(q + static_cast<size_t>(row) * W + s) : 0u;
        a[i][s][h] = repro::pm1(v, t4);
        a[i][s][2 + h] = repro::pm1(v, t4 + 4);
      }
    }
  }

  int c0[2][4];  // -thr of each accumulator register's query row
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c0[i][e] = -thr[i][e >> 1];

  Tiles tiles{prune, nq, nb, prune_rows, prune ? prune_rows : split_rows,
              hi, q0 + tid, lo, hist_mode ? kSample : 1, lo, lo};
  uint32_t r[Lay::kLoads];
  int2 cur = tiles.next();
  load_tile<W>(r, db, cur, tid);
  repro::expand_tile<W, kNTile, kScanThreads>(smem, r, tid);
  int2 nxt = tiles.next();
  load_tile<W>(r, db, nxt, tid);
  int filled = 0;  // valid keys in the heap of this lane's query

  // lane l of ldmatrix gives row l % 8 of matrix l / 8: 16 k bytes each
  const uint32_t lm_off = repro::ldmatrix_lane_offset<W>(lane);
  for (int it = 0; cur.x >= 0; ++it) {
    __syncthreads();  // tile `cur` expanded; the other buffer free
    if (nxt.x >= 0)
      repro::expand_tile<W, kNTile, kScanThreads>(
          smem + ((it + 1) & 1) * Lay::kTile, r, tid);
    const int2 after = tiles.next();
    load_tile<W>(r, db, after, tid);  // in flight while `cur` computes

    const uint32_t xs =
        repro::smem_u32(smem + (it & 1) * Lay::kTile) + lm_off;
    // 16-row groups, software-pipelined: the product of group grp + 1 is
    // in flight while the epilogue of group grp runs
    int acc[2][2][2][4];
    int pen[2][2][2];  // [buffer][j][col]
    bool any_pen = row_penalty(pen[0], cur, cur.x, t4, mask);
    group_mma<W>(acc[0], a, c0, pen[0], any_pen, xs);
#pragma unroll
    for (int grp = 0; grp < kNTile / 16; ++grp) {
      if (grp + 1 < kNTile / 16) {
        any_pen = row_penalty(pen[(grp + 1) & 1], cur, cur.x + 16 * (grp + 1),
                              t4, mask);
        group_mma<W>(acc[(grp + 1) & 1], a, c0, pen[(grp + 1) & 1], any_pen,
                     xs + 16 * (grp + 1) * Lay::kLd);
      }
      const int(&c)[2][2][4] = acc[grp & 1];
      // a match is c >= 0, so the AND of all is negative iff none matches
      int all = -1;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) all &= c[j][i][e];
      if (!__any_sync(repro::kFullMask, all >= 0)) continue;
      // counts: 4 rows a query row, less one for each negative c; and
      // whether any c reaches its query's candidate margin
      int any_cand = -1;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int n = 4;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int col = 0; col < 2; ++col) {
              const int v = c[j][i][2 * h + col];
              n += v >> 31;
              any_cand &= v - cand[i][h];
            }
          cnt[i][h] += n;
        }
      if (any_cand < 0) continue;
      // rare: this lane spills its dot products and walks its candidates
      // (bit 8 j + 4 i + e of `cm`)
      const int row0 = cur.x + 16 * grp;
      unsigned cm = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            spill[8 * j + 4 * i + e] = c[j][i][e] + thr[i][e >> 1];
            cm |= static_cast<unsigned>(c[j][i][e] >= cand[i][e >> 1])
                  << (8 * j + 4 * i + e);
          }
      while (cm) {
        const int idx = __ffs(cm) - 1;
        cm &= cm - 1;
        const int dot = spill[idx];
        const int j = idx >> 3, i = (idx >> 2) & 1, e = idx & 3;
        const int row = row0 + 8 * j + 2 * t4 + (e & 1);
        const int slot = warp * 32 + 16 * i + 8 * (e >> 1) + g;
        const uint32_t dist = (32 * W - dot) >> 1;
        if (hist_mode) {
          atomicAdd(hist + static_cast<size_t>(q0 + slot) * kHistCols + dist,
                    1);
          continue;
        }
        const uint32_t key =
            (dist << kLocalBits) | static_cast<uint32_t>(row - lo);
        uint32_t* h = buf + slot * stride;
        if (key < thr_key[slot]) h[k + atomicAdd(&staged[slot], 1)] = key;
      }
    }
    // each lane drains its own query's stage (at most one tile of keys)
    __syncwarp();
    drain_stage(buf + (warp * 32 + lane) * stride, staged + warp * 32 + lane,
                thr_key + warp * 32 + lane, k, filled);
    __syncwarp();
    cur = nxt;
    nxt = after;
  }
  if (hist_mode) return;

  // heapsort: the lane's max-heap of `filled` keys becomes its ascending
  // best keys, which go to the query's candidate list
  uint32_t* mine = buf + (warp * 32 + lane) * stride;
  for (int end = filled - 1; end > 0; --end) {
    const uint32_t last = mine[end];
    mine[end] = mine[0];
    sift_down(mine, end, last);
  }
  const int my_q = q0 + warp * 32 + lane;
  int pos = 0;
  if (my_q < nq && filled > 0)
    pos = atomicAdd(hist + static_cast<size_t>(my_q) * kHistCols + kFilled,
                    filled);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int c = cnt[i][h];
      c += __shfl_xor_sync(repro::kFullMask, c, 1);
      c += __shfl_xor_sync(repro::kFullMask, c, 2);
      const int row = q0 + warp * 32 + 16 * i + 8 * h + g;
      if (t4 == 0 && row < nq)
        counts_out[static_cast<size_t>(row) * n_splits + split] = c;
    }
  }
  for (int l = 0; l < 32; ++l) {
    const int n_l = __shfl_sync(repro::kFullMask, filled, l);
    const int p_l = __shfl_sync(repro::kFullMask, pos, l);
    const int qi = q0 + warp * 32 + l;
    if (qi >= nq) break;
    const uint32_t* src = buf + (warp * 32 + l) * stride;
    unsigned long long* dst =
        keys_out + static_cast<size_t>(qi) * n_splits * k + p_l;
    for (int i = lane; i < n_l; i += 32) {
      const uint32_t u = src[i];
      dst[i] = (static_cast<unsigned long long>(u >> kLocalBits) << 32) |
               static_cast<uint32_t>(lo + (u & kLocalMask));
    }
  }
}

template <int W>
int launch_scan(const void* q, const void* db, const void* mask,
                const void* prune, int nq, int limit, int radius, int k,
                int split_rows, int n_splits, int prune_rows, int nb,
                bool hist_mode, int* hist, unsigned long long* keys,
                int32_t* counts, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        scan_smem_bytes<W>(kMaxK));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(n_splits, (nq + kQTile - 1) / kQTile);
  scan_kernel<W><<<grid, kScanThreads, scan_smem_bytes<W>(k), s>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(prune),
      nq, limit, radius, k, split_rows, n_splits, prune_rows, nb, hist_mode,
      hist, keys, counts);
  return static_cast<int>(cudaGetLastError());
}

// The least d in [0, n) with h[0] + ... + h[d] >= k, or -1; one warp,
// every lane gets the answer.
__device__ __forceinline__ int first_cum_at_least(const int* h, int n, int k,
                                                  int lane) {
  int run = 0;
  for (int base = 0; base < n; base += 32) {
    const int d = base + lane;
    int c = d < n ? h[d] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(repro::kFullMask, c, o);
      if (lane >= o) c += t;
    }
    c += run;
    const unsigned hit = __ballot_sync(repro::kFullMask, d < n && c >= k);
    if (hit) return base + __ffs(hit) - 1;
    run = __shfl_sync(repro::kFullMask, c, 31);
  }
  return -1;
}

// D0 of each query (one warp each): the least distance d at which pass 0's
// histogram holds k matches at distances <= d, or INT_MAX if it never does.
__global__ void __launch_bounds__(kMergeWarps * 32)
bound_kernel(int* __restrict__ hist, int nq, int k, int radius) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= nq) return;
  int* h = hist + static_cast<size_t>(qi) * kHistCols;
  const int d0 = first_cum_at_least(h, radius + 1, k, lane);
  if (lane == 0) h[kBound] = d0 < 0 ? INT_MAX : d0;
}

// The best k keys seen so far by one warp: s[0, k) sorted, then staging
// from s[k]; everything past the stage holds sentinels.
struct WarpTopK {
  unsigned long long* s;
  int k, lane, staged;           // `staged` is the same in every lane
  unsigned long long threshold;  // s[k - 1]: a key must beat it to enter

  __device__ void init(unsigned long long* smem, int k_, int lane_) {
    s = smem;
    k = k_;
    lane = lane_;
    staged = 0;
    threshold = kSentinel;
    for (int i = lane; i < kSortN; i += 32) s[i] = kSentinel;
    __syncwarp();
  }

  // Sort the best k and the staged keys over the least power of two that
  // holds them.
  __device__ void flush() {
    __syncwarp();
    int n = 64;
    while (n < k + staged) n <<= 1;
    warp_sort(s, n, lane);
    for (int i = k + lane; i < n; i += 32) s[i] = kSentinel;
    __syncwarp();
    threshold = s[k - 1];
    staged = 0;
  }

  // Every lane calls this together; `ok` marks a real match.
  __device__ void offer(unsigned long long key, bool ok) {
    const bool take = ok && key < threshold;
    const unsigned m = __ballot_sync(repro::kFullMask, take);
    if (take) s[k + staged + __popc(m & ((1u << lane) - 1u))] = key;
    staged += __popc(m);
    if (k + staged > kSortN - 32) flush();
  }
};

// One warp per query: the best k of its candidate list (hist[q][kFilled]
// keys), decoded to (row, dist) with (-1, BIG_DIST) padding, and the sum of
// the splits' counts. A histogram of the candidates' distances gives the
// K-th smallest distance first, and only keys at or below it are staged,
// so the staged top-K rarely sorts more than once.
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const unsigned long long* __restrict__ keys,
             const int32_t* __restrict__ counts, const int* __restrict__ hist,
             int nq, int n_splits, int k, int32_t* __restrict__ out_idx,
             int32_t* __restrict__ out_dist, int32_t* __restrict__ out_counts) {
  __shared__ unsigned long long smem[kMergeWarps][kSortN];
  __shared__ int shist[kMergeWarps][kHistBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= nq) return;

  WarpTopK top;
  top.init(smem[warp], k, lane);
  const unsigned long long* src = keys + static_cast<size_t>(qi) * n_splits * k;
  const int total = hist[static_cast<size_t>(qi) * kHistCols + kFilled];
  int* sh = shist[warp];
  for (int d = lane; d < kHistBins; d += 32) sh[d] = 0;
  __syncwarp();
  for (int i = lane; i < total; i += 32)
    atomicAdd(&sh[static_cast<int>(src[i] >> 32)], 1);
  __syncwarp();
  const int cut = first_cum_at_least(sh, kHistBins, k, lane);
  if (cut >= 0)
    top.threshold = static_cast<unsigned long long>(cut + 1) << 32;
  for (int base = 0; base < total; base += 32 * kMergeUnroll) {
    unsigned long long key[kMergeUnroll];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const int i = base + 32 * u + lane;
      key[u] = i < total ? src[i] : kSentinel;
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u)
      top.offer(key[u], key[u] != kSentinel);
  }
  if (top.staged) top.flush();

  int c = 0;
  for (int s = lane; s < n_splits; s += 32)
    c += counts[static_cast<size_t>(qi) * n_splits + s];
  c = __reduce_add_sync(repro::kFullMask, c);
  for (int i = lane; i < k; i += 32) {
    const unsigned long long key = top.s[i];
    const bool valid = key != kSentinel;
    out_idx[static_cast<size_t>(qi) * k + i] =
        valid ? static_cast<int32_t>(key & 0xffffffffull) : -1;
    out_dist[static_cast<size_t>(qi) * k + i] =
        valid ? static_cast<int32_t>(key >> 32) : kBigDist;
  }
  if (lane == 0) out_counts[qi] = c;
}

}  // namespace

// mask: (n,) uint8 or null; prune: (nq, nb) uint8 (1 = skip) or null.
// keys_scratch: (nq, n_splits, k) uint64; counts_scratch: (nq, n_splits)
// int32; hist_scratch: (nq, 259) int32. split_rows must be at most 2^23,
// and a multiple of prune_rows when prune is given.
REPRO_API int streaming_nns(const void* q, const void* db, const void* mask,
                            const void* prune, int nq, int n, int words,
                            int limit, int radius, int k, int split_rows,
                            int n_splits, int prune_rows, int nb,
                            void* keys_scratch, void* counts_scratch,
                            void* hist_scratch, void* out_idx, void* out_dist,
                            void* out_counts, void* stream) {
  if (k < 1 || k > kMaxK || split_rows < 1 || n_splits < 1 ||
      split_rows > (1 << kLocalBits) ||
      (nq + kQTile - 1) / kQTile > 65535 ||
      (prune && (prune_rows < 1 || split_rows % prune_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  limit = max(0, min(limit, n));
  // below -1 nothing matches and above 32 words everything does, as at
  // the ends of that range; the clamp keeps 32W - 2 radius in range
  radius = max(-1, min(radius, 32 * words));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(keys_scratch);
  auto* counts = static_cast<int32_t*>(counts_scratch);
  auto* hist = static_cast<int*>(hist_scratch);
  const int merge_blocks = (nq + kMergeWarps - 1) / kMergeWarps;
  cudaError_t e = cudaMemsetAsync(
      hist, 0, sizeof(int) * static_cast<size_t>(nq) * kHistCols, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = 0;
  REPRO_DISPATCH_WORDS(words,
      err = launch_scan<W>(q, db, mask, prune, nq, limit, radius, k,
                           split_rows, n_splits, prune_rows, nb, true, hist,
                           keys, counts, s);
      if (err == 0) {
        bound_kernel<<<merge_blocks, kMergeWarps * 32, 0, s>>>(hist, nq, k,
                                                               radius);
        err = static_cast<int>(cudaGetLastError());
      }
      if (err == 0)
        err = launch_scan<W>(q, db, mask, prune, nq, limit, radius, k,
                             split_rows, n_splits, prune_rows, nb, false,
                             hist, keys, counts, s));
  if (err != 0) return err;
  merge_kernel<<<merge_blocks, kMergeWarps * 32, 0, s>>>(
      keys, counts, hist, nq, n_splits, k, static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_dist), static_cast<int32_t*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}
