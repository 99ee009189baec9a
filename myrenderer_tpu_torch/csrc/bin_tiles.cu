// K5: CSR binning of a raster pass's records to 16x16 tiles (wrapper:
// myrenderer_tpu_torch/ops/binning.py; plain version: bin_tiles_reference
// there).
//
// What it replaces. The JAX package bins inside its compiled frame
// (myrenderer_tpu/ops/raster_pallas.py bin_packed), where XLA sorts the
// (tile, record) pairs; it is no Pallas kernel. The plain version enumerates
// every one of the C static pair slots (searchsorted over the records'
// cumulative spans, int64 tile keys), sorts them stably by tile and finds
// each tile's segment with a second searchsorted: about 60 torch launches and
// a radix sort over C int64 keys a pass.
//
// What it computes, bit for bit with the plain version. A record's rect is
// the plain code's: cull against the band [y0, y0 + ph) and the frame's
// columns (NaN compares false), f32 floor / ceil, clamp, division by 16 and
// truncation; span = sx * sy tiles, 0 when culled. Pair k of record r lies
// at slot first(r) + k, first(r) the exclusive prefix of the spans (64 bits,
// saturated at 2^40, which decides every test against C < 2^31 as the exact
// sum does); slots below C are kept, so on overflow the pairs past the C-th
// in record order are dropped. Tile t's segment of index [starts[t],
// starts[t] + counts[t]) holds the rows of its kept pairs in ascending row
// order, the segments follow each other in tile order from 0, and the slots
// past the live pairs hold R - 1; overflow is total > C. A box whose tile
// rect is empty on an axis (min past max, which viewport boxes never are)
// gets span 0, as in the plain version.
//
// Three launches, nothing read back to the host:
//   1. bin_tiles_count_kernel: a block a chunk of records (256 a block
//      below kFewRecords records, 256 kManyItems above) in ticket order
//      computes their rects and spans, scans them, publishes its sum and
//      finds its first slot by a decoupled look-back (as K4 ranks its
//      chunks, csrc/straddlers.cu). Its threads then walk its kept pairs,
//      each pair finding its record by a binary search of the chunk's kept
//      prefix in shared memory, and count them into cnt[t]: a warp holds 32
//      consecutive pairs, groups them by tile (__match_any_sync) and adds
//      each group with one atomicAdd. The last scan_blocks blocks to finish
//      (an atomic done counter) wait for the rest, so they must fit on the
//      card beside the blocks still counting (the wrapper refuses a band
//      of more scan chunks than bin_tiles_resident_blocks), then scan cnt
//      in chunks of kScanChunk tiles, again by a look-back, into starts and
//      counts, listing the tiles of more than kWarpRows rows; the first
//      also writes overflow;
//   2. bin_tiles_place_kernel: the same chunks again (the first slot from
//      the count's status words), each warp's group of a tile claiming a
//      run of its tile's segment with one atomicSub on cnt[t] (which
//      returns cnt to 0) and writing its rows there in ascending order, the
//      first marked with kRunHead; the blocks fill the dead slots with R - 1,
//      and the last to finish zeroes the counters and status words;
//   3. bin_tiles_order_kernel: each segment put in ascending row order. The
//      runs of a segment came in any order, but each run ascends and the
//      runs of different warps hold disjoint ranges of rows, so sorting the
//      runs by their first rows sorts the segment: a run moves by the rows
//      of the runs whose first row is smaller. The long tiles go first, a
//      block each as it takes them from the list; then each warp merges
//      the runs of its share of the other tiles; one routine, order_runs,
//      does both at the two scopes. A segment of more runs than the merge
//      takes is sorted by a bitonic network whose comparators all point
//      one way, so a ragged segment needs no padding (a warp's in
//      registers, up to kWarpRows rows; the block's in shared memory up to
//      kOrderCap, else in place in device memory). The last block clears
//      the list.
// Every scratch word the chain uses is zero when it starts and when it
// ends, so a scratch serves the next call and every replay of a CUDA graph
// that holds the chain.
//
// Bound: bytes. Each record's box (16 bytes) and flag are read, each of the
// C slots written (4 bytes) and each tile's start and count (8 bytes). At
// 4K that is 0.0076 ms of traffic; what the chain costs beyond it is
// latency: three launches, the look-back chains, the atomics, the waits of
// the scan, and the merging of the tiles' runs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// records a thread: 1 below kFewRecords records (more blocks for the few
// records of a small pass), else kManyItems
constexpr int kFewRecords = 1 << 17;
constexpr int kManyItems = 2;
constexpr int kTile = 16;                      // raster_cuda.TILE_H, TILE_W
constexpr int kScanItems = 4;                  // tiles a thread of a scan
constexpr int kScanChunk = kThreads * kScanItems;
constexpr int kExpand = 4;                     // pairs a thread has in flight
constexpr int kWarpRows = 512;                 // rows a warp orders
constexpr int kOrderCap = 4096;                // rows ordered in shared memory
constexpr int kOrderTiles = 32;                // tiles an order block visits
static_assert(kOrderTiles % kWarps == 0 && kOrderTiles / kWarps <= 32,
              "an order warp loads its tiles' counts a lane each");
// a status word: 0 until published, then a flag and a value (kValue bits):
// kPrefix, the sum over every chunk up to this one; kAggregate, its own sum
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;
constexpr long long kSaturate = 1ll << 40;
// the place kernel marks the first row of each warp's run in a segment
constexpr int kRunHead = INT_MIN;
constexpr int kMaxRuns = 64;                   // runs a warp merges
constexpr int kMaxBlockRuns = 1024;            // runs a block merges

struct Args {
  const float* box[4];  long long box_stride[4];   // min u, max u, min v, max v
  const uint8_t* valid;  long long valid_stride;
  int R, W, y0, ph, ntx, NT;
  long long C;
  int blocks, scan_blocks;           // record chunks, tile-scan chunks
  // count ticket, count done, place done, long tiles, long tiles taken,
  // order done
  unsigned int* counters;
  unsigned long long* status;        // a word a record chunk
  unsigned long long* scan_status;   // a word a tile-scan chunk
  int* cnt;                          // kept pairs a tile (zero at rest)
  int* heavy;                        // the tiles of more than kWarpRows
  int* index;  int* starts;  int* counts;  uint8_t* overflow;
};

__device__ __forceinline__ long long saturate(long long v) {
  return v < kSaturate ? v : kSaturate;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The rects of a chunk of kThreads * kItems records in shared memory.
template <int kItemsOf>
struct Chunk {
  static constexpr int kItems = kItemsOf;
  static constexpr int kSize = kThreads * kItems;
  int tx0[kSize], ty0[kSize], sx[kSize], span[kSize];
  int kept[kSize];                   // exclusive prefix of the kept pairs
};

// Record r's rect into slot l of the chunk: the plain code's _bin_spans.
template <class Ch>
__device__ void record_rect(const Args& g, long long r, int l, Ch& c) {
  int tx0 = 0, ty0 = 0, sx = 1, span = 0;
  if (r < g.R) {
    const float x0 = __ldg(g.box[0] + r * g.box_stride[0]);
    const float x1 = __ldg(g.box[1] + r * g.box_stride[1]);
    const float v0 = __ldg(g.box[2] + r * g.box_stride[2]);
    const float v1 = __ldg(g.box[3] + r * g.box_stride[3]);
    const bool live = __ldg(g.valid + r * g.valid_stride) != 0 &&
                      v1 >= (float)g.y0 && v0 < (float)(g.y0 + g.ph) &&
                      x1 >= 0.f && x0 < (float)g.W;
    if (live) {
      const float wmax = (float)(g.W - 1), hmax = (float)(g.ph - 1);
      const float minx = clampf(floorf(x0), 0.f, wmax);
      const float maxx = clampf(ceilf(x1), 0.f, wmax);
      const float miny = clampf(__fsub_rn(floorf(v0), (float)g.y0), 0.f, hmax);
      const float maxy = clampf(__fsub_rn(ceilf(v1), (float)g.y0), 0.f, hmax);
      tx0 = __float2int_rz(__fdiv_rn(minx, (float)kTile));
      ty0 = __float2int_rz(__fdiv_rn(miny, (float)kTile));
      const int tx1 = __float2int_rz(__fdiv_rn(maxx, (float)kTile));
      const int ty1 = __float2int_rz(__fdiv_rn(maxy, (float)kTile));
      sx = tx1 - tx0 + 1;
      const int sy = ty1 - ty0 + 1;
      span = sx > 0 && sy > 0 ? sx * sy : 0;
      if (sx <= 0) sx = 1;
    }
  }
  c.tx0[l] = tx0;
  c.ty0[l] = ty0;
  c.sx[l] = sx;
  c.span[l] = span;
}

// Exclusive scan over the block (every thread calls it); *total gets the
// block's sum.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T s_warp[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  T before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    sum += s_warp[w];
  }
  __syncthreads();                       // s_warp is reused
  *total = sum;
  return before + inc - v;
}

// The chunk's records [base, base + Ch::kSize) into c; returns the sum of
// their spans (exact: at most Ch::kSize * NT) and leaves in first[i] the
// exclusive prefix of this thread's kItems records (blocked: records
// kItems * threadIdx.x + i of the chunk).
template <class Ch>
__device__ long long load_chunk(const Args& g, long long base, Ch& c,
                                long long* first) {
  constexpr int kItems = Ch::kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int l = i * kThreads + threadIdx.x;
    record_rect(g, base + l, l, c);
  }
  __syncthreads();
  long long mine = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    first[i] = mine;
    mine += c.span[kItems * threadIdx.x + i];
  }
  long long total;
  const long long before = block_exclusive_scan<long long>(mine, &total);
#pragma unroll
  for (int i = 0; i < kItems; ++i) first[i] += before;
  return total;
}

// Each record's kept pairs (slots below C, from its first slot prefix +
// first[i]) into c.kept as an exclusive prefix; returns the chunk's kept
// pairs (at most C).
template <class Ch>
__device__ int keep_chunk(const Args& g, long long prefix,
                          const long long* first, Ch& c) {
  constexpr int kItems = Ch::kItems;
  int kept[kItems];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long f = prefix + first[i];
    const int span = c.span[kItems * threadIdx.x + i];
    kept[i] = f >= g.C ? 0 : (int)(g.C - f < span ? g.C - f : span);
    mine += kept[i];
  }
  int total;
  int at = block_exclusive_scan<int>(mine, &total);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    c.kept[kItems * threadIdx.x + i] = at;
    at += kept[i];
  }
  __syncthreads();
  return total;
}

// Pair j of the chunk's kept pairs: (its record in the chunk, its tile),
// the record by a binary search of the kept prefix (a fixed count of
// steps, so that a thread's kExpand searches interleave).
template <class Ch>
__device__ __forceinline__ int2 pair_at(const Args& g, const Ch& c, int j) {
  int lo = 0;
#pragma unroll
  for (int step = Ch::kSize / 2; step > 0; step >>= 1)
    if (c.kept[lo + step] <= j) lo += step;
  const int k = j - c.kept[lo];
  const int sx = c.sx[lo];
  const int ey = k / sx, ex = k - ey * sx;
  return make_int2(lo, (c.ty0[lo] + ey) * g.ntx + c.tx0[lo] + ex);
}

// The chunk's kept pairs j0 + q kThreads + threadIdx.x, q < kExpand (x < 0
// past ``kept``): every thread of the block runs the same iterations, so
// that its warps can group their pairs.
template <class Ch>
__device__ __forceinline__ void pairs_at(const Args& g, const Ch& c, int j0,
                                         int kept, int2 p[kExpand]) {
#pragma unroll
  for (int q = 0; q < kExpand; ++q) {
    const int j = j0 + q * kThreads + (int)threadIdx.x;
    p[q] = j < kept ? pair_at(g, c, j) : make_int2(-1, 0);
  }
}

// A warp's pairs of one tile (its 32 lanes hold consecutive pairs, so the
// records of a group ascend with the lane): the group's size, its first
// lane, this lane's rank in it, and whether this lane leads it. With
// ``sparse``, the lanes are grouped only where two neighbours share a tile
// (small triangles), else every pair is a group of its own: an atomic a
// pair, but no __match_any_sync. The count takes that; the place always
// groups, since its groups are the runs the order kernel merges.
struct Claim {
  int size, first, rank;
  bool leader;
};

template <bool sparse>
__device__ __forceinline__ Claim claim_group(int2 p) {
  const int lane = threadIdx.x % 32;
  const int key = p.x >= 0 ? p.y : -1 - lane;
  unsigned group;
  if (sparse) {
    // every lane shuffles (a lane that skipped it would hang the warp)
    const int before = __shfl_up_sync(0xffffffffu, key, 1);
    const bool repeat = lane > 0 && before == key;
    group = __any_sync(0xffffffffu, repeat)
                ? __match_any_sync(0xffffffffu, key) : 1u << lane;
  } else {
    group = __match_any_sync(0xffffffffu, key);
  }
  Claim w;
  w.size = __popc(group);
  w.first = __ffs(group) - 1;
  w.rank = __popc(group & ((1u << lane) - 1u));
  w.leader = p.x >= 0 && w.rank == 0;
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* status, int k,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(status + k) = word;
}

// The sum of chunks [0, pos), pos > 0, from their status words: kThreads
// words a round from pos - 1 back to the nearest prefix, each thread
// spinning on its word until it is published. Called by the whole block.
__device__ long long look_back(const unsigned long long* status, int pos) {
  __shared__ int s_near;
  __shared__ long long s_sum[kWarps];
  long long acc = 0;
  for (int end = pos; end > 0; end -= kThreads) {
    const int k = end - 1 - (int)threadIdx.x;
    unsigned long long word = 0;
    if (k >= 0) {
      const volatile unsigned long long* p = status + k;
      do { word = *p; } while (word == 0);
    }
    if (threadIdx.x == 0) s_near = kThreads;
    __syncthreads();
    if (word & kPrefix) atomicMin(&s_near, (int)threadIdx.x);
    __syncthreads();
    const int near = s_near;
    long long v = (int)threadIdx.x <= near ? (long long)(word & kValue) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x % 32 == 0) s_sum[threadIdx.x / 32] = v;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) acc += s_sum[w];
    acc = saturate(acc);
    __syncthreads();                     // s_near and s_sum are reused
    if (near < kThreads) break;
  }
  return acc;
}

// Chunk ``chunk`` of the scan of cnt into starts and counts (the whole
// block, after every count block is done).
__device__ void scan_tiles(const Args& g, int chunk) {
  const int t0 = chunk * kScanChunk + threadIdx.x * kScanItems;
  int v[kScanItems];
  if (t0 + kScanItems <= g.NT) {
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 w = __ldcg(reinterpret_cast<const int4*>(g.cnt + t0) + q);
      v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z; v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      v[i] = t0 + i < g.NT ? __ldcg(g.cnt + t0 + i) : 0;
  }
  int mine = 0, longs = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    mine += v[i];
    longs += v[i] > kWarpRows;
  }
  // the long tiles onto the list, one atomic a warp that has any
  const int lane = threadIdx.x % 32;
  int upto = longs;                      // the warp's long tiles to here
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += n;
  }
  int base = 0;
  if (lane == 31 && upto) base = (int)atomicAdd(g.counters + 3, (unsigned)upto);
  base = __shfl_sync(0xffffffffu, base, 31) + upto - longs;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (v[i] > kWarpRows) g.heavy[base++] = t0 + i;
  int total;
  const int before = block_exclusive_scan<int>(mine, &total);
  long long prefix = 0;
  if (chunk == 0) {
    if (threadIdx.x == 0) publish(g.scan_status, 0, kPrefix | total);
  } else {
    if (threadIdx.x == 0) publish(g.scan_status, chunk, kAggregate | total);
    prefix = look_back(g.scan_status, chunk);
    if (threadIdx.x == 0)
      publish(g.scan_status, chunk, kPrefix | (unsigned long long)(prefix + total));
  }
  int at = (int)prefix + before;
  int s[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    s[i] = at;
    at += v[i];
  }
  if (t0 + kScanItems <= g.NT) {
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      reinterpret_cast<int4*>(g.starts + t0)[q] =
          make_int4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      reinterpret_cast<int4*>(g.counts + t0)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
    for (int i = 0; i < kScanItems && t0 + i < g.NT; ++i) {
      g.starts[t0 + i] = s[i];
      g.counts[t0 + i] = v[i];
    }
  }
}

template <int kItems>
__global__ void __launch_bounds__(kThreads) bin_tiles_count_kernel(
    const Args g) {
  __shared__ Chunk<kItems> c;
  __shared__ int s_ticket;
  __shared__ unsigned int s_done;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(g.counters, 1u);
  __syncthreads();
  const int ticket = s_ticket;
  if (ticket < g.blocks) {
    long long first[kItems];
    const long long base = (long long)ticket * c.kSize;
    const long long sum = saturate(load_chunk(g, base, c, first));
    long long prefix = 0;
    if (ticket == 0) {
      if (threadIdx.x == 0) publish(g.status, 0, kPrefix | sum);
    } else {
      if (threadIdx.x == 0) publish(g.status, ticket, kAggregate | sum);
      prefix = look_back(g.status, ticket);
      if (threadIdx.x == 0)
        publish(g.status, ticket, kPrefix | saturate(prefix + sum));
    }
    const int kept = keep_chunk(g, prefix, first, c);
    for (int j0 = 0; j0 < kept; j0 += kExpand * kThreads) {
      int2 p[kExpand];
      pairs_at(g, c, j0, kept, p);
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        const Claim w = claim_group<true>(p[q]);
        if (w.leader) atomicAdd(g.cnt + p[q].y, w.size);
      }
    }
  }
  // the last scan_blocks blocks to finish scan the tiles once all are done
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_done = atomicAdd(g.counters + 1, 1u);
  }
  __syncthreads();
  const unsigned grid = gridDim.x;
  if (s_done < grid - (unsigned)g.scan_blocks) return;
  if (threadIdx.x == 0) {
    const volatile unsigned int* done = g.counters + 1;
    while (*done < grid) {
    }
    __threadfence();
  }
  __syncthreads();
  const int chunk = (int)(s_done - (grid - (unsigned)g.scan_blocks));
  scan_tiles(g, chunk);
  if (chunk == 0 && threadIdx.x == 0) {
    const long long total =
        (long long)(__ldcg(g.status + g.blocks - 1) & kValue);
    *g.overflow = total > g.C;
  }
}

template <int kItems>
__global__ void __launch_bounds__(kThreads) bin_tiles_place_kernel(
    const Args g) {
  __shared__ Chunk<kItems> c;
  __shared__ int s_last;
  const int b = blockIdx.x;
  long long first[kItems];
  const long long base = (long long)b * c.kSize;
  load_chunk(g, base, c, first);
  const long long prefix = b == 0 ? 0 : (long long)(g.status[b - 1] & kValue);
  const int kept = keep_chunk(g, prefix, first, c);
  for (int j0 = 0; j0 < kept; j0 += kExpand * kThreads) {
    int2 p[kExpand];
    Claim w[kExpand];
    int at[kExpand];
    pairs_at(g, c, j0, kept, p);
#pragma unroll
    for (int q = 0; q < kExpand; ++q) {
      w[q] = claim_group<false>(p[q]);
      if (w[q].leader)
        at[q] = __ldg(g.starts + p[q].y) +
                atomicSub(g.cnt + p[q].y, w[q].size) - w[q].size;
    }
#pragma unroll
    for (int q = 0; q < kExpand; ++q) {
      at[q] = __shfl_sync(0xffffffffu, at[q], w[q].first);
      if (p[q].x >= 0)
        g.index[at[q] + w[q].rank] =
            (int)(base + p[q].x) | (w[q].rank == 0 ? kRunHead : 0);
    }
  }
  // the dead slots [live, C)
  const long long total = (long long)(g.status[g.blocks - 1] & kValue);
  const long long live = total < g.C ? total : g.C;
  for (long long s = live + (long long)b * kThreads + threadIdx.x; s < g.C;
       s += (long long)gridDim.x * kThreads)
    g.index[s] = g.R - 1;
  // the last block to finish zeroes the counters and status words
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(g.counters + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < g.blocks; k += kThreads) g.status[k] = 0;
  for (int k = threadIdx.x; k < g.scan_blocks; k += kThreads)
    g.scan_status[k] = 0;
  if (threadIdx.x == 0) g.counters[0] = g.counters[1] = g.counters[2] = 0;
}

__device__ __forceinline__ void order_pair(int* p, unsigned lo, unsigned hi) {
  const int a = p[lo], b = p[hi];
  if (b < a) {
    p[lo] = b;
    p[hi] = a;
  }
}

template <int kLanes>
__device__ __forceinline__ void scope_sync() {
  if constexpr (kLanes == 32) __syncwarp();
  else __syncthreads();
}

// p[0, n) in ascending order by a scope's kLanes threads (a warp or the
// block; p in shared or device memory): a bitonic network whose
// comparators put the smaller value at the lower place, so the places past
// n (conceptually +inf) never move and every comparator that reaches one is
// skipped.
template <int kLanes>
__device__ void order_network(int* p, unsigned n) {
  // unsigned: a segment may hold up to 2^31 - 1 rows
  const unsigned me = threadIdx.x % kLanes;
  if (n < 2) return;
  int log_p = 0;
  while ((1ull << log_p) < n) ++log_p;
  const unsigned pairs = 1u << (log_p - 1);
  for (int log_k = 1; log_k <= log_p; ++log_k) {
    const unsigned half = 1u << (log_k - 1);
    for (unsigned i = me; i < pairs; i += kLanes) {
      const unsigned block = (i >> (log_k - 1)) << log_k, off = i & (half - 1);
      const unsigned hi = block + 2 * half - 1 - off;
      if (hi < n) order_pair(p, block + off, hi);
    }
    scope_sync<kLanes>();
    for (int log_d = log_k - 2; log_d >= 0; --log_d) {
      const unsigned d = 1u << log_d;
      for (unsigned i = me; i < pairs; i += kLanes) {
        const unsigned lo = ((i >> log_d) << (log_d + 1)) | (i & (d - 1));
        if (lo + d < n) order_pair(p, lo, lo + d);
      }
      scope_sync<kLanes>();
    }
  }
}

// p[0, n), n <= 32 E, in ascending order by one warp: the same network in
// registers, place e * 32 + lane in v[e] of that lane (+inf past n).
template <int E>
__device__ void order_warp(int* p, int n) {
  const int lane = threadIdx.x % 32;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    v[e] = e * 32 + lane < n ? p[e * 32 + lane] : INT_MAX;
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
    // the flip: place i against i ^ (k - 1), the smaller to the lower half
    if (k <= 32) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int o = __shfl_xor_sync(0xffffffffu, v[e], k - 1);
        v[e] = (lane & (k >> 1)) ? max(v[e], o) : min(v[e], o);
      }
    } else {
      const int flip = (k - 1) >> 5;     // the partner's register: e ^ flip
      int o[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = __shfl_xor_sync(0xffffffffu, v[e ^ flip], 31);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = (e & (k >> 6)) ? max(v[e], o[e]) : min(v[e], o[e]);
    }
    // the half-cleaners: place i against i + d
#pragma unroll
    for (int d = k >> 2; d >= 1; d >>= 1) {
      if (d >= 32) {
        const int r = d >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & r) continue;
          const int a = v[e], b = v[e | r];
          v[e] = min(a, b);
          v[e | r] = max(a, b);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int o = __shfl_xor_sync(0xffffffffu, v[e], d);
          v[e] = (lane & d) ? max(v[e], o) : min(v[e], o);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < n) p[e * 32 + lane] = v[e];
}

// p[0, n) in ascending order by a scope's kLanes threads: a warp sorts in
// registers (n <= kWarpRows), the block with its network in memory.
template <int kLanes>
__device__ __forceinline__ void sort_rows(int* p, int n) {
  if constexpr (kLanes != 32) order_network<kLanes>(p, n);
  else order_warp<kWarpRows / 32>(p, n);
}

// A scope's shared memory in the order kernel (kLanes threads: a warp or
// the block): a segment's rows (up to kRows) and, for each of its runs (up
// to kRuns), the place it starts, its first row and its shift.
template <int kLanes, int kRows, int kRuns>
struct Runs {
  int rows[kRows];
  int start[kRuns + 1], head[kRuns], shift[kRuns];
  int warp_heads[kLanes / 32];
};
using WarpRuns = Runs<32, kWarpRows, kMaxRuns>;
using BlockRuns = Runs<kThreads, kOrderCap, kMaxBlockRuns>;

// seg[0, n), 1 <= n <= kRows, in ascending row order by the scope's
// kLanes threads. The place kernel wrote the segment as runs, each a
// warp's ascending rows of this tile, its first row marked with kRunHead;
// runs of different warps hold disjoint ranges of rows, so ordering the
// runs by their first rows orders the segment. With more than kRuns runs
// the scope sorts the rows instead.
template <int kLanes, int kRows, int kRuns>
__device__ void order_runs(int* seg, int n, Runs<kLanes, kRows, kRuns>& s) {
  const int me = threadIdx.x % kLanes, lane = threadIdx.x % 32;
  const int warp = me / 32;
  int k = 0;
  for (int c = 0; c < n; c += kLanes) {
    const int i = c + me;
    const int v = i < n ? seg[i] : 0;
    const bool head = v < 0;
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    if (lane == 0) s.warp_heads[warp] = __popc(heads);
    if (i < n) s.rows[i] = v & ~kRunHead;
    scope_sync<kLanes>();
    int q = k + __popc(heads & ((1u << lane) - 1u));
    for (int w = 0; w < kLanes / 32; ++w) {
      q += w < warp ? s.warp_heads[w] : 0;
      k += s.warp_heads[w];
    }
    if (head && q < kRuns) {
      s.start[q] = i;
      s.head[q] = v & ~kRunHead;
    }
    scope_sync<kLanes>();                // warp_heads is reused
  }
  if (k > kRuns) {
    sort_rows<kLanes>(s.rows, n);
    for (int i = me; i < n; i += kLanes) seg[i] = s.rows[i];
    scope_sync<kLanes>();
    return;
  }
  if (me == 0) s.start[k] = n;
  scope_sync<kLanes>();
  // run q moves by the rows of the runs whose first row is smaller, less
  // its own start
  for (int q = me; q < k; q += kLanes) {
    int before = 0;
    for (int r = 0; r < k; ++r)
      if (s.head[r] < s.head[q]) before += s.start[r + 1] - s.start[r];
    s.shift[q] = before - s.start[q];
  }
  scope_sync<kLanes>();
  for (int i = me; i < n; i += kLanes) {
    int q = 0;
    for (int step = kRuns / 2; step > 0; step >>= 1)
      if (q + step < k && s.start[q + step] <= i) q += step;
    seg[i + s.shift[q]] = s.rows[i];
  }
  scope_sync<kLanes>();
}

// First the long tiles (more than kWarpRows rows, listed by the count's
// scan), each taken by a block as it comes, its run marks cleared and its
// rows ordered by the whole block; then the tiles of block b, b + G,
// b + 2G, ... (G blocks, at most kOrderTiles each), each warp ordering its
// tiles' runs. The last block to finish zeroes the list's counters.
__global__ void __launch_bounds__(kThreads) bin_tiles_order_kernel(
    const Args g) {
  __shared__ union {
    BlockRuns block;
    WarpRuns warp[kWarps];
  } s_mem;
  __shared__ int s_tile, s_last;
  const int longs = (int)g.counters[3];
  for (;;) {
    if (threadIdx.x == 0) {
      // a tile taken from the list, its entry zeroed behind it
      const int w = (int)atomicAdd(g.counters + 4, 1u);
      s_tile = w < longs ? g.heavy[w] : -1;
      if (w < longs) g.heavy[w] = 0;
    }
    __syncthreads();
    const int t = s_tile;
    __syncthreads();                     // s_tile is reused
    if (t < 0) break;
    int* seg = g.index + g.starts[t];
    const int n = g.counts[t];
    if (n > kOrderCap) {
      for (int i = threadIdx.x; i < n; i += kThreads) seg[i] &= ~kRunHead;
      __syncthreads();
      order_network<kThreads>(seg, n);
      continue;
    }
    order_runs(seg, n, s_mem.block);
  }
  // the warp's tiles, their counts and starts loaded at once (lane q holds
  // its q-th tile's)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kTilesAWarp = kOrderTiles / kWarps;
  const int mine = blockIdx.x + (warp + kWarps * lane) * gridDim.x;
  const bool have = lane < kTilesAWarp && mine < g.NT;
  const int my_n = have ? g.counts[mine] : 0;
  const int my_start = have ? g.starts[mine] : 0;
  for (int q = 0; q < kTilesAWarp; ++q) {
    const int n = __shfl_sync(0xffffffffu, my_n, q);
    const int start = __shfl_sync(0xffffffffu, my_start, q);
    if (n >= 1 && n <= kWarpRows)
      order_runs(g.index + start, n, s_mem.warp[warp]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(g.counters + 5, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0)
    g.counters[3] = g.counters[4] = g.counters[5] = 0;
}

int record_items(int R) { return R < kFewRecords ? 1 : kManyItems; }
int record_blocks(int R) {
  const int chunk = kThreads * record_items(R);
  return (R + chunk - 1) / chunk;
}
int scan_blocks(int NT) { return (NT + kScanChunk - 1) / kScanChunk; }

}  // namespace

// 8-byte scratch words a launch over R records and NT tiles uses: the
// counters, a status word a record chunk and a tile-scan chunk, then cnt
// (16-byte aligned) and the list of long tiles. All must be zero when a
// chain starts, and it leaves them zeroed: a scratch serves later chains
// of other shapes, whose words lie elsewhere in it.
extern "C" long long bin_tiles_scratch_words(int R, int NT) {
  const long long head = 3 + record_blocks(R) + scan_blocks(NT);
  return head + (head & 1) + NT;
}

// Once, before the first launch: the kernels prefer shared memory to L1, so
// that enough blocks of the count and place kernels fit on an SM.
extern "C" int bin_tiles_setup() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(bin_tiles_count_kernel<1>),
      reinterpret_cast<const void*>(bin_tiles_count_kernel<kManyItems>),
      reinterpret_cast<const void*>(bin_tiles_place_kernel<1>),
      reinterpret_cast<const void*>(bin_tiles_place_kernel<kManyItems>),
      reinterpret_cast<const void*>(bin_tiles_order_kernel)};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The blocks of the count kernel (the fewer of its two forms) that the
// current device holds at once. The last scan_blocks(NT) blocks of a count
// launch wait for all others, so a launch is safe only while scan_blocks(NT)
// is at most this. Returns the CUDA error, 0 on success.
extern "C" int bin_tiles_resident_blocks(int* blocks) {
  int dev = 0, sms = 0, one = 0, many = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &one, bin_tiles_count_kernel<1>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &many, bin_tiles_count_kernel<kManyItems>, kThreads, 0);
  *blocks = (one < many ? one : many) * sms;
  return (int)err;
}

extern "C" int bin_tiles_scan_blocks(int NT) { return scan_blocks(NT); }

// The chain over R > 0 records into index[C], starts[NT], counts[NT] and
// overflow on ``stream``. Returns the first CUDA error of its launches (0
// when all were accepted).
extern "C" int bin_tiles_launch(
    const float* b0, const float* b1, const float* b2, const float* b3,
    long long s0, long long s1, long long s2, long long s3,
    const uint8_t* valid, long long valid_stride, int R, int W, int y0,
    int ph, int ntx, int NT, long long C, unsigned long long* scratch,
    int* index, int* starts, int* counts, uint8_t* overflow, void* stream) {
  Args g{{b0, b1, b2, b3}, {s0, s1, s2, s3}, valid, valid_stride,
         R, W, y0, ph, ntx, NT, C, record_blocks(R), scan_blocks(NT),
         reinterpret_cast<unsigned int*>(scratch), nullptr, nullptr, nullptr,
         nullptr, index, starts, counts, overflow};
  const long long head = 3 + g.blocks + g.scan_blocks;
  g.status = scratch + 3;
  g.scan_status = g.status + g.blocks;
  g.cnt = reinterpret_cast<int*>(scratch + head + (head & 1));
  g.heavy = g.cnt + NT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = g.blocks > g.scan_blocks ? g.blocks : g.scan_blocks;
  if (record_items(R) == 1) {
    bin_tiles_count_kernel<1><<<grid, kThreads, 0, s>>>(g);
  } else {
    bin_tiles_count_kernel<kManyItems><<<grid, kThreads, 0, s>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (record_items(R) == 1) {
    bin_tiles_place_kernel<1><<<g.blocks, kThreads, 0, s>>>(g);
  } else {
    bin_tiles_place_kernel<kManyItems><<<g.blocks, kThreads, 0, s>>>(g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_tiles_order_kernel<<<(NT + kOrderTiles - 1) / kOrderTiles, kThreads, 0,
                           s>>>(g);
  return (int)cudaGetLastError();
}
