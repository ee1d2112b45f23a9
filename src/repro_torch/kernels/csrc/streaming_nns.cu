// Streaming fixed-radius Hamming NNS: the best K matches per query, sorted
// by (distance, row), plus the count of all matches within the radius.
//
// Replaces: src/repro/kernels/streaming_nns.py `_streaming_nns_kernel` and
//           its `_masked_`, `_pruned_` and `_masked_pruned_` variants
//           (pallas_call in `streaming_nns_pallas`), the kernel of the
//           streaming plan of `core/nns.py:fixed_radius_nns`.
// Bound on the H100: the distance work. Each (query, admitted row) pair
//           costs 8 XOR + 8 popcount + 8 adds, against 32 bytes per row
//           read once: at 256 queries that is ~6000 integer operations per
//           row byte, far above the card's operations-per-byte balance.
//           The candidate buffers are tiny (K keys a query).
// Design:   the TPU walks the DB in order with one resident buffer; here
//           blocks run in parallel, so two passes.
//   Pass 1: the DB is cut into splits; block (split, query tile) holds one
//           warp per query. The warp scans its split 32 rows at a time
//           (two 16-byte loads a row; the tile's 8 warps read the same
//           rows, which L1 serves) and keeps its best K keys
//           `dist << 32 | row` in shared memory: matches below the current
//           K-th best key are staged with a ballot, and a full stage is
//           bitonic-sorted together with the buffer. The count of matches
//           per (query, split) goes to a scratch array (no atomics, so the
//           count is deterministic). A pruned (query, summary block) is
//           skipped whole: splits are multiples of the summary block.
//   Pass 2: one warp per query merges the splits' sorted buffers with the
//           same staged top-K, decodes keys to (row, dist) with (-1,
//           BIG_DIST) padding, and sums the counts.
//   The 64-bit key orders exactly by (distance, global row), so the output
//   equals the dense threshold + stable top-K for any split layout
//   (superblocks need no special case). Rows >= n_valid and rows whose
//   mask byte is 0 never match and never count.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // queries per block (one warp each)
constexpr int kMaxK = 128;                // largest max_candidates
constexpr int kSortN = 512;               // per-warp keys: best K + staging
constexpr int kStageCap = kSortN - kMaxK;  // staged keys before a sort
constexpr int kBigDist = 1 << 30;         // BIG_DIST of the Python side
constexpr unsigned long long kSentinel = ~0ull;

// Ascending bitonic sort of kSortN keys in shared memory by one warp.
__device__ __forceinline__ void warp_sort(unsigned long long* s, int lane) {
  for (int size = 2; size <= kSortN; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < kSortN; i += 32) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = s[i], b = s[j];
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

// The best k keys seen so far by one warp: s[0, k) sorted, then staging.
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

  __device__ void flush() {
    __syncwarp();
    warp_sort(s, lane);
    for (int i = k + lane; i < kSortN; i += 32) s[i] = kSentinel;
    __syncwarp();
    threshold = s[k - 1];
    staged = 0;
  }

  // Every lane calls this together; `ok` marks a real match.
  __device__ void offer(unsigned long long key, bool ok) {
    const bool take = ok && key < threshold;
    const unsigned m = __ballot_sync(repro::kFullMask, take);
    if (take) s[kMaxK + staged + __popc(m & ((1u << lane) - 1u))] = key;
    staged += __popc(m);
    if (staged > kStageCap - 32) flush();
  }
};

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
            const uint8_t* __restrict__ mask, const uint8_t* __restrict__ prune,
            int nq, int limit, int radius, int k, int split_rows, int n_splits,
            int prune_rows, int nb, unsigned long long* __restrict__ keys_out,
            int32_t* __restrict__ counts_out) {
  __shared__ unsigned long long smem[kWarps][kSortN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.y * kWarps + warp;
  const int split = blockIdx.x;
  if (qi >= nq) return;

  uint32_t qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = __ldg(q + static_cast<size_t>(qi) * W + w);
  WarpTopK top;
  top.init(smem[warp], k, lane);

  const int lo = split * split_rows;
  const int hi = min(lo + split_rows, limit);
  const int seg = prune ? prune_rows : split_rows;
  int count = 0;
  for (int s0 = lo; s0 < hi; s0 += seg) {
    if (prune) {
      const int b = s0 / prune_rows;
      if (b < nb && prune[static_cast<size_t>(qi) * nb + b]) continue;
    }
    const int s1 = min(s0 + seg, hi);
    for (int base = s0; base < s1; base += 32) {
      const int row = base + lane;
      bool ok = false;
      unsigned long long key = kSentinel;
      if (row < s1) {
        uint32_t r[W];
        repro::load_sig<W>(db + static_cast<size_t>(row) * W, r);
        const int d = repro::hamming<W>(qw, r);
        ok = d <= radius && (mask == nullptr || mask[row] != 0);
        key = (static_cast<unsigned long long>(d) << 32) |
              static_cast<unsigned>(row);
      }
      count += ok;
      top.offer(key, ok);
    }
  }
  if (top.staged) top.flush();

  unsigned long long* dst =
      keys_out + (static_cast<size_t>(qi) * n_splits + split) * k;
  for (int i = lane; i < k; i += 32) dst[i] = top.s[i];
  count = __reduce_add_sync(repro::kFullMask, count);
  if (lane == 0) counts_out[static_cast<size_t>(qi) * n_splits + split] = count;
}

__global__ void __launch_bounds__(kWarps * 32)
merge_kernel(const unsigned long long* __restrict__ keys,
             const int32_t* __restrict__ counts, int nq, int n_splits, int k,
             int32_t* __restrict__ out_idx, int32_t* __restrict__ out_dist,
             int32_t* __restrict__ out_counts) {
  __shared__ unsigned long long smem[kWarps][kSortN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= nq) return;

  WarpTopK top;
  top.init(smem[warp], k, lane);
  const unsigned long long* src = keys + static_cast<size_t>(qi) * n_splits * k;
  const int total = n_splits * k;
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < total ? src[i] : kSentinel;
    top.offer(key, key != kSentinel);
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
// int32. split_rows must be a multiple of prune_rows when prune is given.
REPRO_API int streaming_nns(const void* q, const void* db, const void* mask,
                            const void* prune, int nq, int n, int words,
                            int limit, int radius, int k, int split_rows,
                            int n_splits, int prune_rows, int nb,
                            void* keys_scratch, void* counts_scratch,
                            void* out_idx, void* out_dist, void* out_counts,
                            void* stream) {
  if (k < 1 || k > kMaxK || split_rows < 1 || n_splits < 1 ||
      (prune && (prune_rows < 1 || split_rows % prune_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  limit = max(0, min(limit, n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(n_splits, (nq + kWarps - 1) / kWarps);
  auto* keys = static_cast<unsigned long long*>(keys_scratch);
  auto* counts = static_cast<int32_t*>(counts_scratch);
  REPRO_DISPATCH_WORDS(words,
      scan_kernel<W><<<grid1, kWarps * 32, 0, s>>>(
          static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
          static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(prune),
          nq, limit, radius, k, split_rows, n_splits, prune_rows, nb, keys,
          counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(nq + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      keys, counts, nq, n_splits, k, static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_dist), static_cast<int32_t*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}
