// Grouped int8 dequant-gather-pool: every embedding bag and row gather of a
// serve stage in one launch, with the hot-cache counters.
//
// Replaces: src/repro/kernels/embedding_pool.py `_pool_kernel`
//           (pallas_call in `embedding_pool_pallas`), and with it the
//           eager gathers of the hot-cache paths it sits among
//           (src/repro/serving/hot_cache.py `cached_rows`,
//           `cached_embedding_bag`): the lookup stage's five user-feature
//           bags and mean-pooled history, and the rank stage's candidate
//           rows and genre bag.
// Bound on the H100: the bytes: d + 4 for each distinct live row of a
//           table (an int8 row and its f32 scale, read once however many
//           slots name it), the ids, and the f32 output, 4d a row: ~1.8 MB
//           at the rank stage's 256 x 50 candidate rows of 32 (mostly the
//           output), 0.53 us at 3.35 TB/s. A stage is a few thousand rows,
//           so what a launch costs (~2 us on the card, more on the host)
//           weighs more: one launch a stage is the design unit, not one
//           table.
// Design:   a stage is a list of up to 8 segments. A segment is one table
//           (int8 values, f32 scales, optionally its sorted hot ids and
//           pinned f32 rows) and one (B, L) id array (-1 = padding, ids past
//           the table clamp to its last row, as the reference's gather),
//           with optional (B, L) weights, a mode (sum or mean over each
//           bag's L slots, or rows: one output row per id) and an output
//           pointer with a row stride and a column offset, so that each
//           segment writes straight into its consumer's buffer (the filter
//           MLP's input, the rank MLP's input). The batch's `valid` mask is
//           honoured here: a padding row counts no lookup and reads zeros.
//   Blocks: each segment gets its own run of blocks (a prefix over the
//           segments, computed on the host per call), 8 warps each. A
//           block stages its segment's hot ids in shared memory (up to
//           2048) while its first ids are in flight.
//   Probe:  a lane probes its slot as `_probe` does: the lower bound of
//           the id in the hot ids, clamped to [0, capacity - 1], a hit iff
//           hot_ids[pos] == id and id >= 0. The ballots of `id >= 0` and of
//           a hit give the lookups and hits, summed in shared memory and
//           added to the stage's two int32 counters by one atomic a block.
//   Rows:   one-slot rows (the candidate rows, the one-id feature bags):
//           a lane a row, its slot's int8 row and scale in two 16-byte and
//           one 4-byte load, its pooled row out in four 16-byte stores. A
//           warp takes up to 32 rows, but a small segment gets fewer a warp
//           so that its blocks spread over the SMs: a 256-row bag runs as
//           32 blocks, not one.
//   Bags:   L > 1 (the history): a warp a row. For each 32 columns, lane l
//           writes slot l's 32 terms to row l of the warp's tile in shared
//           memory, and lane c sums column c down the tile in slot order.
//   Sums:   each term is (value * scale) * w, summed in slot order from 0
//           with `__fmul_rn` / `__fadd_rn` (no FMA; a padding slot adds 0):
//           the plain version's arithmetic, bit for bit. `mean` divides by
//           max(count, 1).
//   Hits:   a hit reads the pinned f32 row, which is what the reference
//           serves. For a real id it is bit-identical to the dequantized
//           int8 row (the hot cache's contract), so the value is the same
//           either way; the pinned row is also right where the two differ
//           (an `INVALID_ID` sentinel slot holds a zero row), and the probe
//           is needed for the counters anyway.
//   Side:   a segment may carry a side table for this call: ascending
//           ids (`EMPTY_ID` padding), int8 rows and f32 scales. The live
//           catalog's delta shard (`src/repro/serving/catalog.py`
//           `delta_cached_rows`) and the tiered catalog's per-batch overlay
//           (`src/repro/serving/tiered.py` `_overlay_rows`) are both one.
//           A slot resolves in this order: a side-table hit (the same lower
//           bound search, on the side ids) reads value * scale of that slot;
//           else an id at or past the base table's rows reads zeros (a
//           segment with a side table and no base rows reads zeros for
//           every id the side table lacks); else the hot probe and the cold
//           row as above. The hot probe runs for every live slot, so the
//           hits stay hot-set hits (a side-table hit is no cache hit); the
//           live catalog keeps its delta and hot set disjoint. Up to 2048
//           side ids are staged in shared memory beside the hot ids; the
//           side table adds one search a slot and, in the bound, its rows'
//           d + 4 bytes and its ids.
//   Counters: zeroed by a `cudaMemsetAsync` in the same call, only when a
//           segment is counted.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSegs = 8;
// hot sets and side tables up to this size are searched in shared memory
constexpr int kSmemHot = 2048;
// floats per row of a warp's transposition tile (16-byte aligned rows)
constexpr int kTileLd = 36;
// int64 fields per segment, as the Python side packs them
constexpr int kStaticFields = 11;
constexpr int kCallFields = 11;

struct Seg {
  const int8_t* values;
  const float* scales;
  const int32_t* hot_ids;  // null: no hot set
  const float* hot_rows;
  const int32_t* ids;
  const int32_t* side_ids;  // null: no side table
  const int8_t* side_values;
  const float* side_scales;
  const float* weights;  // null: every weight is 1
  const uint8_t* valid;  // null: every batch row is real
  float* out;
  long long out_stride;  // floats between output rows
  int n_rows, d, hot_cap, side_n, mean, counted, column;
  int L;      // slots per output row
  int rows;   // output rows
  int group;  // output rows per batch row (N for candidate rows, else 1)
  int vec;    // rows, hot rows and output rows allow 16-byte accesses
  int rows_per_warp, block0;
};

struct Params {
  Seg seg[kMaxSegs];
  int* counters;  // [hits, lookups] of the counted segments
  int n_segs;
  int smem_hot;   // hot ids a block stages in shared memory
  int smem_side;  // side ids a block stages in shared memory
};

// One slot as its lane holds it: the id (-1: padding, or a padding row of
// the batch), its weight, and once probed its hot row (-1: not hot), its
// source (a side-table slot, kCold, or kZero) and the scale of that row.
constexpr int kCold = -1;
constexpr int kZero = -2;
struct Slot {
  int id;
  float w;
  int pos;
  int src;
  float sc;
};

__device__ __forceinline__ Slot load_slot(const Seg& g, int j, bool live) {
  Slot t{-1, 1.f, -1, kCold, 0.f};
  if (live) {  // the id, the row's valid byte and the weight together
    const int id = __ldg(g.ids + j);
    const bool ok = g.valid == nullptr || g.valid[j / g.L / g.group];
    if (g.weights) t.w = __ldg(g.weights + j);
    t.id = ok ? id : -1;
  }
  return t;
}

// The lower bound of id in n ascending ids, clamped to [0, n - 1] (the
// `searchsorted` of `_probe` and of `delta_rows`).
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < id)
      lo = mid + 1;
    else
      hi = mid;
  }
  return min(lo, n - 1);
}

// Resolve a live slot: the side table first, then ids past the base table
// (zeros when a side table is present), then the cold row; the hot probe
// (`_probe`: a hit iff the id is at its lower bound) runs for every live
// slot. The scale's load goes out first and flies during the hot search.
__device__ __forceinline__ void probe(const Seg& g, const int32_t* hot,
                                      const int32_t* side, Slot& t) {
  if (t.id < 0) return;
  if (g.side_n) {
    const int sp = lower_bound(side, g.side_n, t.id);
    if (side[sp] == t.id) {
      t.src = sp;
      t.sc = __ldg(g.side_scales + sp);
    } else if (t.id >= g.n_rows) {
      t.src = kZero;
    }
  }
  if (t.src == kCold) t.sc = __ldg(g.scales + min(t.id, g.n_rows - 1));
  if (g.hot_cap == 0) return;
  const int hp = lower_bound(hot, g.hot_cap, t.id);
  if (hot[hp] == t.id) t.pos = hp;
}

// x[k] = the slot's term for column c + k, (value * scale) * w, where the
// value * scale of a hot hit is its pinned row and of a zero slot 0; 0 for
// a padding slot or past d.
__device__ __forceinline__ void terms16(const Seg& g, const Slot& t, int c,
                                        float (&x)[16]) {
  if (t.id < 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = 0.f;
    return;
  }
  if (t.src == kZero) {  // (0 * w), as the plain version multiplies it
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = __fmul_rn(0.f, t.w);
    return;
  }
  // the int8 row a cold or side-table slot reads
  const int8_t* row =
      t.src >= 0 ? g.side_values + static_cast<size_t>(t.src) * g.d
                 : g.values + static_cast<size_t>(min(t.id, g.n_rows - 1)) *
                                  g.d;
  const bool pinned = t.src == kCold && t.pos >= 0;
  if (g.vec) {
    if (pinned) {
      const float4* h = reinterpret_cast<const float4*>(
          g.hot_rows + static_cast<size_t>(t.pos) * g.d + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 f = __ldg(h + k);
        x[4 * k] = f.x;
        x[4 * k + 1] = f.y;
        x[4 * k + 2] = f.z;
        x[4 * k + 3] = f.w;
      }
    } else {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + c));
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        x[k] = __fmul_rn(static_cast<float>(static_cast<int8_t>(
                             w[k >> 2] >> (8 * (k & 3)))),
                         t.sc);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = c + k;
      x[k] = col >= g.d ? 0.f
             : pinned
                 ? __ldg(g.hot_rows + static_cast<size_t>(t.pos) * g.d + col)
                 : __fmul_rn(static_cast<float>(__ldg(row + col)), t.sc);
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = __fmul_rn(x[k], t.w);
}

// One-slot rows (L = 1: candidate rows, one-id bags): a lane a row; the
// pooled row is 0 + the slot's term (a mean divides by 1).
__device__ __forceinline__ void one_slot_row(const Seg& g, int row,
                                             const Slot& t) {
  float* o = g.out + row * g.out_stride + g.column;
  for (int c = 0; c < g.d; c += 16) {
    float x[16];
    terms16(g, t, c, x);
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = __fadd_rn(0.f, x[k]);
    if (g.vec) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<float4*>(o + c)[k] =
            make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (c + k < g.d) o[c + k] = x[k];
    }
  }
}

// A bag of L > 1 slots: a warp a row. For each 32 columns, each lane
// writes its slot's 32 terms to a row of the warp's tile, and lane c sums
// column c down the tile in slot order.
__device__ __forceinline__ void bag_row(const Seg& g, const int32_t* hot,
                                        const int32_t* side, int row,
                                        int lane, Slot first,
                                        float* tile, int& hits,
                                        int& lookups) {
  for (int c0 = 0; c0 < g.d; c0 += 32) {
    float acc = 0.f;
    int count = 0;
    for (int base = 0; base < g.L; base += 32) {
      Slot t = first;
      if (c0 || base) {
        t = load_slot(g, row * g.L + base + lane, base + lane < g.L);
        probe(g, hot, side, t);
      }
      const int live = __popc(__ballot_sync(repro::kFullMask, t.id >= 0));
      count += live;
      if (c0 == 0) {
        lookups += live;
        hits += __popc(__ballot_sync(repro::kFullMask, t.pos >= 0));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[16];
        if (c0 + 16 * h < g.d)
          terms16(g, t, c0 + 16 * h, x);
        else
#pragma unroll
          for (int k = 0; k < 16; ++k) x[k] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          reinterpret_cast<float4*>(tile + lane * kTileLd + 16 * h)[k] =
              make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
      }
      __syncwarp();
      const int n = min(32, g.L - base);
      for (int k = 0; k < n; ++k)
        acc = __fadd_rn(acc, tile[k * kTileLd + lane]);
      __syncwarp();
    }
    if (c0 + lane < g.d)
      g.out[row * g.out_stride + g.column + c0 + lane] =
          g.mean ? __fdiv_rn(acc, static_cast<float>(max(count, 1))) : acc;
  }
}

__global__ void __launch_bounds__(kThreads, 2) pool_kernel(const Params p) {
  extern __shared__ int32_t hot_s[];
  __shared__ __align__(16) float tiles[kWarps][32 * kTileLd];
  __shared__ int block_counts[2];
  // the block's segment, copied to registers with constant indices only:
  // a dynamic index into the parameters would read them through memory
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i)
    if (i < p.n_segs && static_cast<int>(blockIdx.x) >= p.seg[i].block0) s = i;
  Seg g = p.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i)
    if (i == s) g = p.seg[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = ((blockIdx.x - g.block0) * kWarps + warp) * g.rows_per_warp;
  const int r1 = min(r0 + g.rows_per_warp, g.rows);
  // the warp's first slots fly while the block stages the hot ids: a
  // lane's row (L = 1) or slot `lane` of the warp's row
  const bool one = g.L == 1;
  Slot t = load_slot(g, one ? r0 + lane : r0 * g.L + lane,
                     one ? r0 + lane < r1 : r0 < r1 && lane < g.L);
  const bool staged = g.hot_cap > 0 && g.hot_cap <= p.smem_hot;
  if (staged)
    for (int i = threadIdx.x; i < g.hot_cap; i += kThreads)
      hot_s[i] = __ldg(g.hot_ids + i);
  int32_t* side_s = hot_s + p.smem_hot;
  const bool side_staged = g.side_n > 0 && g.side_n <= p.smem_side;
  if (side_staged)
    for (int i = threadIdx.x; i < g.side_n; i += kThreads)
      side_s[i] = __ldg(g.side_ids + i);
  if (threadIdx.x < 2) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* hot = staged ? hot_s : g.hot_ids;
  const int32_t* side = side_staged ? side_s : g.side_ids;
  probe(g, hot, side, t);
  int hits = 0, lookups = 0;
  if (r0 < r1) {
    if (g.L == 0) {  // empty bags pool to zero rows
      for (int row = r0; row < r1; ++row)
        for (int col = lane; col < g.d; col += 32)
          g.out[row * g.out_stride + g.column + col] = 0.f;
    } else if (one) {
      lookups = __popc(__ballot_sync(repro::kFullMask, t.id >= 0));
      hits = __popc(__ballot_sync(repro::kFullMask, t.pos >= 0));
      if (r0 + lane < r1) one_slot_row(g, r0 + lane, t);
    } else {
      bag_row(g, hot, side, r0, lane, t, tiles[warp], hits, lookups);
    }
  }
  if (g.counted) {  // the same for the whole block
    if (lane == 0 && (hits | lookups)) {
      atomicAdd(&block_counts[0], hits);
      atomicAdd(&block_counts[1], lookups);
    }
    __syncthreads();
    if (threadIdx.x == 0 && (block_counts[0] | block_counts[1])) {
      atomicAdd(p.counters, block_counts[0]);
      atomicAdd(p.counters + 1, block_counts[1]);
    }
  }
}

}  // namespace

// stat: per segment 11 int64 fields, fixed for a stage (values, scales,
// hot_ids, hot_rows, n_rows, d, hot_cap, mean, column, counted, masked);
// n_rows may be 0 (no base rows) only with a side table. call: per segment
// 11 int64 fields of this call (ids, weights, out, L, rows, group,
// out_stride, side_ids, side_values, side_scales, side_n; side_ids null or
// side_n 0: no side table). valid: (B,) bool of the batch rows, for the
// masked segments, or null. counters: 2 int32 (hits, lookups), zeroed
// here, then summed over the counted segments; may be null if no segment
// is counted.
REPRO_API int embedding_pool(const int64_t* stat, const int64_t* call,
                             int n_segs, const void* valid, void* counters,
                             void* stream) {
  if (n_segs < 1 || n_segs > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  // the card's SM count, read once (it only shapes the grid), and the
  // kernel's dynamic shared memory opted in past the 48 KB default: the
  // staged hot and side ids beside the static tiles
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pool_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * kSmemHot * sizeof(int32_t));
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = max(sms, 1);
  }
  Params p{};
  p.n_segs = n_segs;
  p.counters = static_cast<int*>(counters);
  bool counted = false;
  long long blocks = 0;
  for (int s = 0; s < n_segs; ++s) {
    const int64_t* a = stat + kStaticFields * s;
    const int64_t* c = call + kCallFields * s;
    Seg& g = p.seg[s];
    g.values = reinterpret_cast<const int8_t*>(a[0]);
    g.scales = reinterpret_cast<const float*>(a[1]);
    g.hot_ids = reinterpret_cast<const int32_t*>(a[2]);
    g.hot_rows = reinterpret_cast<const float*>(a[3]);
    g.n_rows = static_cast<int>(a[4]);
    g.d = static_cast<int>(a[5]);
    g.hot_cap = g.hot_ids ? static_cast<int>(a[6]) : 0;
    g.mean = a[7] != 0;
    g.column = static_cast<int>(a[8]);
    g.counted = a[9] != 0;
    g.valid = a[10] ? static_cast<const uint8_t*>(valid) : nullptr;
    g.ids = reinterpret_cast<const int32_t*>(c[0]);
    g.weights = reinterpret_cast<const float*>(c[1]);
    g.out = reinterpret_cast<float*>(c[2]);
    g.L = static_cast<int>(c[3]);
    g.rows = static_cast<int>(c[4]);
    g.group = static_cast<int>(c[5]);
    g.out_stride = c[6];
    g.side_ids = reinterpret_cast<const int32_t*>(c[7]);
    g.side_values = reinterpret_cast<const int8_t*>(c[8]);
    g.side_scales = reinterpret_cast<const float*>(c[9]);
    g.side_n = g.side_ids ? static_cast<int>(c[10]) : 0;
    if (g.side_n == 0) g.side_ids = nullptr;
    if (g.n_rows < (g.side_n ? 0 : 1) || g.d < 1 || g.L < 0 || g.rows < 0 ||
        g.group < 1 || g.side_n < 0 ||
        (g.side_n && (!g.side_values || !g.side_scales)) ||
        (g.hot_ids && (g.hot_cap < 1 || !g.hot_rows)) ||
        static_cast<long long>(g.rows) * g.L >= INT_MAX ||
        g.out_stride < g.column + g.d)
      return static_cast<int>(cudaErrorInvalidValue);
    // a lane a row for one-slot rows, up to 32 rows a warp but fewer in a
    // small segment, so that its blocks spread over the SMs; else a warp a
    // row
    g.rows_per_warp =
        g.L == 1 ? min(32, max(1, (g.rows + kWarps * sms - 1) / (kWarps * sms)))
                 : 1;
    const auto aligned = [](const void* ptr) {
      return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    };
    g.vec = g.d % 16 == 0 && (g.n_rows == 0 || aligned(g.values)) &&
            (!g.side_n || aligned(g.side_values)) &&
            (!g.hot_ids || aligned(g.hot_rows)) && aligned(g.out) &&
            g.out_stride % 4 == 0 && g.column % 4 == 0;
    g.block0 = static_cast<int>(blocks);
    const int per_block = kWarps * g.rows_per_warp;
    blocks += (g.rows + per_block - 1) / per_block;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    counted |= g.counted != 0;
    if (g.hot_cap <= kSmemHot) p.smem_hot = max(p.smem_hot, g.hot_cap);
    if (g.side_n <= kSmemHot) p.smem_side = max(p.smem_side, g.side_n);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counted) {
    if (counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (blocks == 0) return 0;
  const size_t smem = sizeof(int32_t) * (p.smem_hot + p.smem_side);
  pool_kernel<<<static_cast<int>(blocks), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
