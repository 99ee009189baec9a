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
// exact: R < 2^31 records of at most 2^20 tiles); slots below C are kept, so
// on overflow the pairs past the C-th in record order are dropped. Tile t's
// segment of index [starts[t], starts[t] + counts[t]) holds the rows of its
// kept pairs in ascending row order, the segments follow each other in tile
// order from 0, and the slots past the live pairs hold R - 1; overflow is
// total > C. A box whose tile rect is empty on an axis (min past max, which
// viewport boxes never are) gets span 0, as in the plain version.
//
// Bound: bytes. Each record's box (16 bytes) and flag are read, each of the
// C slots written (4 bytes) and each tile's start and count (8 bytes). At
// 4K that is 25.6 MB, 0.0076 ms at 3.35 TB/s; at 1080p 0.00075 ms. What a
// pass costs beyond that is latency: steps that wait on each other, chains
// of loads, atomics, and blocks or warps left with more work than the rest.
//
// One launch a pass, nothing read back to the host. The grid is persistent:
// a block for each kRecordsABlock records, at least one an SM and at most
// kBlocksAnSM, all resident at once (the launch is cooperative, so the
// runtime refuses a grid the card cannot hold). It walks seven phases, with
// a grid-wide barrier (a word in the scratch) between each and the next
// where the three kernels of the first design had their boundaries and
// waits:
//   1. records: block b takes records [b R / G, (b + 1) R / G), computes
//      their rects, keeps them in shared memory (up to kCache records) and
//      sums their spans and live records (span > 0);
//   2. compaction: from every block's sums, its prefix and the totals (K =
//      min(total, C) kept pairs, the flag); it writes each of its live
//      records, in record order, as (row, first slot clamped to C, first
//      tile, sx) to the list of live records, from the rects it kept, and
//      the dead slots [K, C) get R - 1 while the other blocks arrive;
//   3. count: the blocks take equal ranges of the K kept pairs, not of the
//      records, so a triangle over most of the frame is shared out like any
//      other work. A block finds the live record of its first pair by a
//      256-way search of the list, then walks its pairs kChunk at a time:
//      the chunk's records (at most kChunk + 1, since every live record has
//      a pair) in shared memory, each record after the first marking its
//      first pair, each pair's record a running maximum of the marks; a
//      warp's 32 consecutive pairs are grouped by tile (__match_any_sync)
//      and each group counted with one atomicAdd into cnt[t];
//   4. tile sums: block b writes the counts of its tiles [b NT / G,
//      (b + 1) NT / G), sums them and lists those of more than kWarpRows
//      rows (long tiles);
//   5. tile scan: its tiles' starts from the sums of the blocks before it,
//      and each tile's counter set to its segment's end;
//   6. place: the same pairs again, each warp's group of a tile claiming a
//      run of its tile's segment with one atomicSub on cnt[t] (its place
//      with no other load; the claims leave cnt at the segment's start,
//      and phase 7 zeroes it) and writing its rows there in ascending
//      order, the first marked with kRunHead;
//   7. order: each segment put in ascending row order. The runs of a
//      segment came in any order, but each run ascends and the runs of
//      different warps hold disjoint ranges of rows, so ordering the runs
//      by their first rows orders the segment: each run moves by the
//      lengths of the runs whose first rows are smaller, less its start.
//      The long tiles go first, a block each (the runs' shifts counted by a
//      few threads a run, or, past kThreads runs, from the runs sorted by
//      their first rows and a scan of their lengths); then each warp takes
//      its share of the other tiles, the next tile's first rows loading
//      while it orders one: a tile of up to 32 rows is sorted in registers
//      (one of one run only loses its mark), a longer one merges its runs
//      in shared memory (a lane counting the shifts of two runs). A segment
//      of more runs than a scope merges is sorted whole by a bitonic
//      network whose comparators all point one way, so a ragged segment
//      needs no padding (a warp's in registers; the block's in shared
//      memory up to kOrderCap rows, else in place in device memory).
// Every scratch word is zero when a launch starts and when it ends (the six
// barriers leave their word as they found it, each block zeroes its own sums
// once no block reads them, the order zeroes the tile counters and the list
// of long tiles, block 0 the list's count), so a scratch
// serves the next launch and every replay of a CUDA graph that holds one;
// nothing waits for a last block. Data that another block wrote in this
// launch is read with __ldcg (from L2). With a times buffer, block 0 stamps
// the globaltimer at the start and after each barrier, and each block at its
// end: the seven phases' times of one launch (the last from the latest end).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the most blocks an SM the grid takes, and the fewest records a block takes
// (a small pass runs on fewer blocks, fewer arrivals at each barrier), down
// to one block an SM
constexpr int kBlocksAnSM = 4;
constexpr int kRecordsABlock = 512;
constexpr int kTile = 16;                      // raster_cuda.TILE_H, TILE_W
constexpr int kRecItems = 4;                   // records a thread a round
constexpr int kRecRound = kThreads * kRecItems;
// records whose rects a block keeps in shared memory from phase 1 to 2
constexpr int kCache = 2 * kRecRound;
constexpr int kExpand = 4;                     // pairs a thread has in flight
constexpr int kChunk = kThreads * kExpand;     // pairs a block walks at once
constexpr int kWindowLoads = (kChunk + kThreads) / kThreads;  // kChunk + 1
constexpr int kWarpRows = 512;                 // rows a warp orders
constexpr int kOrderCap = 4096;                // rows ordered in shared memory
constexpr int kRunHead = INT_MIN;              // the first row of a run
constexpr int kMaxRuns = 64;                   // runs a warp merges
constexpr int kMaxBlockRuns = 1024;            // runs a block merges
constexpr int kHeadWords = 1;                  // the two 32-bit counters
// globaltimer stamps a launch: block 0's start and six barriers, then each
// block's end
constexpr int kStamps = 7;

struct Args {
  const float* box[4];  long long box_stride[4];   // min u, max u, min v, max v
  const uint8_t* valid;  long long valid_stride;
  int R, W, y0, ph, ntx, NT;
  long long C;
  // the grid barrier's word, the long tiles
  unsigned int* counters;
  unsigned long long* rec_sum;       // a block's span sum
  unsigned long long* rec_live;      // a block's live records
  unsigned long long* tile_sum;      // a block's tiles' pairs
  int* cnt;                          // kept pairs a tile (zero at rest)
  int* heavy;                        // the tiles of more than kWarpRows
  int4* live;                        // the live records, in record order
  int* index;  int* starts;  int* counts;  uint8_t* overflow;
  unsigned long long* times;         // kStamps + G globaltimer stamps, or null
};

__device__ __forceinline__ unsigned long long global_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// A record's tile rect: its first tile, its width in tiles and its span
// (0 when culled or empty on an axis).
struct Rect {
  int t0, sx, span;
};

// Record r's rect (r < R): the plain code's _bin_spans.
__device__ __forceinline__ Rect record_rect(const Args& g, long long r) {
  Rect q{0, 1, 0};
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
    const int tx0 = __float2int_rz(__fdiv_rn(minx, (float)kTile));
    const int ty0 = __float2int_rz(__fdiv_rn(miny, (float)kTile));
    const int tx1 = __float2int_rz(__fdiv_rn(maxx, (float)kTile));
    const int ty1 = __float2int_rz(__fdiv_rn(maxy, (float)kTile));
    const int sx = tx1 - tx0 + 1, sy = ty1 - ty0 + 1;
    if (sx > 0 && sy > 0) {
      q.t0 = ty0 * g.ntx + tx0;
      q.sx = sx;
      q.span = sx * sy;
    }
  }
  return q;
}

// The sum over the block (every thread calls it and gets it).
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T s_warp[kWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  T sum = 0;
  for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
  __syncthreads();                       // s_warp is reused
  return sum;
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

// Every block of the grid reaches grid_wait after every other has called
// grid_arrive. Block 0 adds 2^31 - (G - 1) to the barrier word and every
// other block 1, so the word's top bit flips when the last block arrives,
// and an even number of barriers leaves the word as it found it (zero).
// Arrival releases and the wait acquires at the device's scope (what each
// block wrote before it arrived is seen by every block after its wait).
// The launch is cooperative, so every block is resident and the wait ends.
// Between the two a block may do work that needs nothing of the others'.
// Block 0 stamps the time it left barrier ``stamp``.
__device__ unsigned grid_arrive(const Args& g) {
  __syncthreads();
  unsigned old = 0;
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(g.counters), "r"(add) : "memory");
  }
  return old;
}

__device__ void grid_wait(const Args& g, unsigned old, int stamp) {
  if (threadIdx.x == 0) {
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(g.counters) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
    if (g.times != nullptr && blockIdx.x == 0)
      g.times[stamp] = global_time();
  }
  __syncthreads();
}

__device__ void grid_sync(const Args& g, int stamp) {
  grid_wait(g, grid_arrive(g), stamp);
}

// Phases 1 and 2's shared memory: the rects of a block's records, when it
// has at most kCache (else of a round of kRecRound at a time), and a
// round's first slots and places in the list.
struct RecordCache {
  int t0[kCache], sx[kCache], span[kCache];
  long long first[kRecRound];
  int pos[kRecRound];
};

// Phase 1: the span sum and live count of records [r0, r1), their rects
// kept in c when they fit.
__device__ void sum_records(const Args& g, long long r0, long long r1,
                            RecordCache& c, long long* sum, int* live) {
  const bool cached = r1 - r0 <= kCache;
  long long span = 0;
  int count = 0;
  for (long long base = r0; base < r1; base += kCache) {
#pragma unroll
    for (int i = 0; i < kCache / kThreads; ++i) {
      const int l = i * kThreads + (int)threadIdx.x;
      if (base + l < r1) {
        const Rect q = record_rect(g, base + l);
        span += q.span;
        count += q.span > 0;
        if (cached) {
          const long long at = base - r0 + l;
          c.t0[at] = q.t0;
          c.sx[at] = q.sx;
          c.span[at] = q.span;
        }
      }
    }
  }
  *sum = block_sum(span);
  *live = block_sum(count);
}

// Phase 2: the live records of [r0, r1) into g.live from place ``pos``,
// their first slots from ``first``; their rects from c where phase 1 kept
// them, else from the boxes again, a round at a time.
__device__ void compact(const Args& g, long long r0, long long r1,
                        long long first, int pos, RecordCache& c) {
  const int t = threadIdx.x;
  const bool cached = r1 - r0 <= kCache;
  for (long long base = r0; base < r1; base += kRecRound) {
    const int off = cached ? (int)(base - r0) : 0;
    if (!cached) {
#pragma unroll
      for (int i = 0; i < kRecItems; ++i) {
        const int l = i * kThreads + t;
        const Rect q = base + l < r1 ? record_rect(g, base + l)
                                     : Rect{0, 1, 0};
        c.t0[l] = q.t0;
        c.sx[l] = q.sx;
        c.span[l] = q.span;
      }
      __syncthreads();
    }
    // the exclusive prefixes of thread t's records kRecItems t + i
    long long span = 0;
    int live = 0, v[kRecItems];
#pragma unroll
    for (int i = 0; i < kRecItems; ++i) {
      const int l = kRecItems * t + i;
      v[i] = base + l < r1 ? c.span[off + l] : 0;
      span += v[i];
      live += v[i] > 0;
    }
    // one scan of both: (span << 16) + live, each under 2^31 a round
    unsigned long long round;
    const unsigned long long ex = block_exclusive_scan<unsigned long long>(
        (unsigned long long)span << 16 | (unsigned)live, &round);
    long long f = first + (long long)(ex >> 16);
    int p = pos + (int)(ex & 0xffffu);
    const long long span_round = (long long)(round >> 16);
    const int live_round = (int)(round & 0xffffu);
#pragma unroll
    for (int i = 0; i < kRecItems; ++i) {
      const int l = kRecItems * t + i;
      c.first[l] = f;
      c.pos[l] = p;
      f += v[i];
      p += v[i] > 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRecItems; ++i) {
      const int l = i * kThreads + t;
      if (base + l < r1 && c.span[off + l] > 0)
        g.live[c.pos[l]] = make_int4(
            (int)(base + l), (int)(c.first[l] < g.C ? c.first[l] : g.C),
            c.t0[off + l], c.sx[off + l]);
    }
    first += span_round;
    pos += live_round;
    __syncthreads();                     // c is reused
  }
}

// The live record of pair slot s (the last of the L live records whose
// first slot is at most s; the first live record's is 0): a 256-way search
// of the list by the whole block, a round of loads per 8 bits of L.
__device__ int find_live(const Args& g, int L, long long s) {
  int lo = 0, n = L;                     // the record lies in [lo, lo + n)
  while (n > 1) {
    const int step = (n + kThreads - 1) / kThreads;
    const int j = lo + (int)threadIdx.x * step;
    const bool at_most = j < lo + n && __ldcg(&g.live[j].y) <= s;
    const int c = __syncthreads_count(at_most);
    lo += (c - 1) * step;
    n = min(step, n - (c - 1) * step);
  }
  return lo;
}

// Phases 3 and 6's shared memory: the live records of a chunk of pairs,
// and each pair's record in the window.
struct Window {
  int row[kChunk + 1], first[kChunk + 1], t0[kChunk + 1], sx[kChunk + 1];
  int rec_of[kChunk];
  int next;
};

// The largest value of the block's threads before this one (every thread
// calls it; 0 for thread 0).
__device__ int block_exclusive_max(int v) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = max(inc, n);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = 0;
  for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
  __syncthreads();                       // s_warp is reused
  return before;
}

// Pair slot c0 + o: (its record's place in the window, its tile).
__device__ __forceinline__ int2 pair_at(const Args& g, const Window& w,
                                        long long c0, int o) {
  const int i = w.rec_of[o];
  const int k = (int)(c0 + o - w.first[i]);
  const int sx = w.sx[i];
  const int ey = k / sx, ex = k - ey * sx;
  return make_int2(i, w.t0[i] + ey * g.ntx + ex);
}

// A warp's pairs of one tile (its 32 lanes hold consecutive pairs, so the
// records of a group ascend with the lane; __match_any_sync): the group's
// size, its first lane, this lane's rank in it, and whether this lane
// leads it. The count adds a group with one atomic; the place claims a run
// for it, the runs the order phase merges.
struct Claim {
  int size, first, rank;
  bool leader;
};

__device__ __forceinline__ Claim claim_group(int2 p) {
  const int lane = threadIdx.x % 32;
  const unsigned group =
      __match_any_sync(0xffffffffu, p.x >= 0 ? p.y : -1 - lane);
  Claim w;
  w.size = __popc(group);
  w.first = __ffs(group) - 1;
  w.rank = __popc(group & ((1u << lane) - 1u));
  w.leader = p.x >= 0 && w.rank == 0;
  return w;
}

// The block's kept pairs [lo, hi), the first in live record j0, kChunk at a
// time: counted into cnt (phase 3) or placed into the index (phase 6).
template <bool kPlace>
__device__ void walk_pairs(const Args& g, long long lo, long long hi, int j0,
                           int L, Window& w) {
  for (long long c0 = lo; c0 < hi; c0 += kChunk) {
    // the chunk's pairs lie in records j0 .. j0 + min(kChunk, pairs) - 1,
    // and the next chunk's first one in the record after them at most
    const int need = (int)(hi - c0 < kChunk ? hi - c0 : kChunk);
    int4 e[kWindowLoads];                // every load in flight at once
#pragma unroll
    for (int u = 0; u < kWindowLoads; ++u) {
      const int i = u * kThreads + (int)threadIdx.x;
      e[u] = make_int4(0, INT_MAX, 0, 1);
      if (i <= need && j0 + i < L) e[u] = __ldcg(g.live + j0 + i);
    }
#pragma unroll
    for (int u = 0; u < kWindowLoads; ++u) {
      const int i = u * kThreads + (int)threadIdx.x;
      if (i <= kChunk) {
        w.row[i] = e[u].x;
        w.first[i] = e[u].y;
        w.t0[i] = e[u].z;
        w.sx[i] = e[u].w;
      }
      if (i < kChunk) w.rec_of[i] = 0;
    }
    __syncthreads();
    // each pair's record: every record after the first marks the pair it
    // starts with, and a running maximum carries the marks over the pairs
#pragma unroll
    for (int u = 0; u < kWindowLoads; ++u) {
      const int i = u * kThreads + (int)threadIdx.x;
      const long long o = (long long)e[u].y - c0;
      if (i >= 1 && i <= need && o < need) w.rec_of[o] = i;
    }
    __syncthreads();
    {
      int r[kExpand], top = 0;
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        r[q] = w.rec_of[kExpand * threadIdx.x + q];
        top = max(top, r[q]);
      }
      int run = block_exclusive_max(top);
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        run = max(run, r[q]);
        w.rec_of[kExpand * threadIdx.x + q] = run;
      }
    }
    __syncthreads();
    // pair c0 + q kThreads + threadIdx.x (x < 0 past hi): every thread of
    // the block runs the same iterations, so that its warps can group
    int2 p[kExpand];
#pragma unroll
    for (int q = 0; q < kExpand; ++q) {
      const int o = q * kThreads + (int)threadIdx.x;
      p[q] = o < need ? pair_at(g, w, c0, o) : make_int2(-1, 0);
    }
    // a warp whose pairs of round q all lie past the chunk's skips it
    const int warp0 = (int)(threadIdx.x & ~31u);
    if (kPlace) {
      Claim c[kExpand];
      int at[kExpand];
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        if (q * kThreads + warp0 >= need) break;
        c[q] = claim_group(p[q]);
        at[q] = 0;
        if (c[q].leader)
          at[q] = atomicSub(g.cnt + p[q].y, c[q].size) - c[q].size;
      }
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        if (q * kThreads + warp0 >= need) break;
        at[q] = __shfl_sync(0xffffffffu, at[q], c[q].first);
        if (p[q].x >= 0)
          g.index[at[q] + c[q].rank] =
              w.row[p[q].x] | (c[q].rank == 0 ? kRunHead : 0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kExpand; ++q) {
        if (q * kThreads + warp0 >= need) break;
        const Claim c = claim_group(p[q]);
        if (c.leader) atomicAdd(g.cnt + p[q].y, c.size);
      }
    }
    // the next chunk's first pair: in the last pair's record, or the next
    if (threadIdx.x == 0 && need == kChunk) {
      int i = w.rec_of[kChunk - 1];
      if (w.first[i + 1] <= c0 + kChunk) ++i;
      w.next = j0 + i;
    }
    __syncthreads();
    j0 = w.next;
  }
}

template <typename T>
__device__ __forceinline__ void order_pair(T* p, unsigned lo, unsigned hi) {
  const T a = p[lo], b = p[hi];
  if (b < a) {
    p[lo] = b;
    p[hi] = a;
  }
}

// p[0, n) in ascending order by the block (p in shared or device memory,
// the block's own): a bitonic network whose comparators put the smaller
// value at the lower place, so the places past n (conceptually +inf) never
// move and every comparator that reaches one is skipped.
template <typename T>
__device__ void order_network(T* p, unsigned n) {
  // unsigned: a segment may hold up to 2^31 - 1 rows
  const unsigned me = threadIdx.x;
  if (n < 2) return;
  int log_p = 0;
  while ((1ull << log_p) < n) ++log_p;
  const unsigned pairs = 1u << (log_p - 1);
  for (int log_k = 1; log_k <= log_p; ++log_k) {
    const unsigned half = 1u << (log_k - 1);
    for (unsigned i = me; i < pairs; i += kThreads) {
      const unsigned block = (i >> (log_k - 1)) << log_k, off = i & (half - 1);
      const unsigned hi = block + 2 * half - 1 - off;
      if (hi < n) order_pair(p, block + off, hi);
    }
    __syncthreads();
    for (int log_d = log_k - 2; log_d >= 0; --log_d) {
      const unsigned d = 1u << log_d;
      for (unsigned i = me; i < pairs; i += kThreads) {
        const unsigned lo = ((i >> log_d) << (log_d + 1)) | (i & (d - 1));
        if (lo + d < n) order_pair(p, lo, lo + d);
      }
      __syncthreads();
    }
  }
}

// A warp's 32 E values in ascending order, place e * 32 + lane in v[e] of
// that lane: the same network in registers.
template <int E>
__device__ void warp_sort(int (&v)[E]) {
  const int lane = threadIdx.x % 32;
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
}

// seg[0, n), n <= 32 E, in ascending row order by one warp: the rows
// (rows[i], marks cleared) sorted in registers (+inf past n).
template <int E>
__device__ void sort_warp_rows(int* seg, const int* rows, int n) {
  const int lane = threadIdx.x % 32;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < n ? rows[i] & ~kRunHead : INT_MAX;
  }
  warp_sort<E>(v);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < n) seg[e * 32 + lane] = v[e];
}

// A warp's shared memory in the order phase: a segment's rows (up to
// kWarpRows), the head bits of each 32 of them, and for each of its runs
// (up to kMaxRuns) the place it starts, its first row, its length and its
// shift.
struct WarpRuns {
  int rows[kWarpRows];
  unsigned heads[kWarpRows / 32];
  int start[kMaxRuns], head[kMaxRuns], len[kMaxRuns], shift[kMaxRuns];
};

// seg[0, n), 1 <= n <= kWarpRows, in ascending row order by one warp, its
// first 32 rows loaded already (``first``: row ``lane``). A segment of up to
// 32 rows is sorted in registers (a segment of one run is
// in order already: only its head's mark is cleared). A longer one is
// loaded into shared memory, 128 rows at a time, and its runs merged: each
// run's shift is the lengths of the runs whose first rows are smaller, less
// its start (lane q counts them for runs q and q + 32), and each row moves
// by its run's shift; with more than kMaxRuns runs the rows are sorted in
// registers by the smallest of three networks that holds them (one
// network of kWarpRows rows for all is tools/k5_lab.py's one_sort_size).
__device__ void order_warp_tile(int* seg, int n, int first, WarpRuns& s) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  if (n <= 32) {
    const int v = first;
    if (__popc(__ballot_sync(0xffffffffu, v < 0)) == 1) {
      if (lane == 0) seg[0] = v & ~kRunHead;
      return;
    }
    int r[1] = {v & ~kRunHead};
    warp_sort<1>(r);
    if (lane < n) seg[lane] = r[0];
    return;
  }
  for (int c = 0; c < n; c += 128) {
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c + u * 32 + lane;
      x[u] = i < n ? (i < 32 ? first : __ldcg(seg + i)) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u * 32 + lane < n) s.rows[c + u * 32 + lane] = x[u];
  }
  __syncwarp();
  int k = 0;
  for (int c = 0; c * 32 < n; ++c) {
    const int i = c * 32 + lane;
    const int v = i < n ? s.rows[i] : 0;
    const bool head = v < 0;
    const unsigned hb = __ballot_sync(0xffffffffu, head);
    const int q = k + __popc(hb & below);
    if (lane == 0) s.heads[c] = hb;
    if (head && q < kMaxRuns) {
      s.start[q] = i;
      s.head[q] = v & ~kRunHead;
    }
    if (i < n) s.rows[i] = v & ~kRunHead;
    k += __popc(hb);
  }
  __syncwarp();
  if (k > kMaxRuns) {
    if (n <= 128) sort_warp_rows<4>(seg, s.rows, n);
    else if (n <= 256) sort_warp_rows<8>(seg, s.rows, n);
    else sort_warp_rows<kWarpRows / 32>(seg, s.rows, n);
    __syncwarp();
    return;
  }
  for (int q = lane; q < k; q += 32)
    s.len[q] = (q + 1 < k ? s.start[q + 1] : n) - s.start[q];
  __syncwarp();
  for (int q = lane; q < k; q += 32) {
    const int h = s.head[q];
    int before = 0;
    for (int r = 0; r < k; ++r) before += s.head[r] < h ? s.len[r] : 0;
    s.shift[q] = before - s.start[q];
  }
  __syncwarp();
  int seen = 0;
  for (int c = 0; c * 32 < n; ++c) {
    const int i = c * 32 + lane;
    const unsigned hb = s.heads[c];
    const int run = seen + __popc(hb & (below | 1u << lane)) - 1;
    if (i < n) seg[i + s.shift[run]] = s.rows[i];
    seen += __popc(hb);
  }
  __syncwarp();
}

// The block's shared memory in the order phase: a segment's rows (up to
// kOrderCap; first the run of each row) and, for each of its runs (up to
// kMaxBlockRuns), the place it starts, its first row, its shift and its key
// (first row, run).
struct BlockRuns {
  int rows[kOrderCap];
  int start[kMaxBlockRuns + 1], head[kMaxBlockRuns], shift[kMaxBlockRuns];
  int warp_heads[kWarps];
  unsigned long long key[kMaxBlockRuns];
};
static_assert(kMaxBlockRuns % kThreads == 0, "a block scans its runs evenly");

// seg[0, n), kWarpRows < n <= kOrderCap, in ascending row order by the
// block, every row loaded at once. The place phase wrote the segment as
// runs, each a warp's ascending rows of this tile, its first row marked
// with kRunHead; runs of different warps hold disjoint ranges of rows, so
// ordering the runs by their first rows orders the segment: each run's
// shift is the lengths of the runs whose first rows are smaller, less its
// start (thread q counts them for run q when the runs are at most the
// block's threads; else the block sorts the runs' keys (first row, run) and
// scans their lengths in that order), and each row moves by its run's
// shift. With more than kMaxBlockRuns runs the block sorts the rows.
__device__ void order_runs(int* seg, int n, BlockRuns& s) {
  constexpr int E = kOrderCap / kThreads;
  const int me = threadIdx.x, lane = me % 32, warp = me / 32;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * kThreads + me;
    v[e] = i < n ? __ldcg(seg + i) : 0;
  }
  int k = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e * kThreads >= n) break;
    const int i = e * kThreads + me;
    const bool head = v[e] < 0;
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    if (lane == 0) s.warp_heads[warp] = __popc(heads);
    __syncthreads();
    int q = k + __popc(heads & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      q += w < warp ? s.warp_heads[w] : 0;
      k += s.warp_heads[w];
    }
    if (head && q < kMaxBlockRuns) {
      s.start[q] = i;
      s.head[q] = v[e] & ~kRunHead;
    }
    if (i < n) s.rows[i] = q + head - 1;   // the row's run
    __syncthreads();                     // warp_heads is reused
  }
  if (k > kMaxBlockRuns) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e * kThreads + me < n) s.rows[e * kThreads + me] = v[e] & ~kRunHead;
    __syncthreads();
    order_network(s.rows, n);
    for (int i = me; i < n; i += kThreads) seg[i] = s.rows[i];
    __syncthreads();
    return;
  }
  if (me == 0) s.start[k] = n;
  __syncthreads();
  if (k <= kThreads) {
    // each run's (first row, length), then its shift counted by ``per``
    // threads (a power of two, at most 32), each over a share of the runs
    int2* runs = reinterpret_cast<int2*>(s.key);
    for (int q = me; q < k; q += kThreads)
      runs[q] = make_int2(s.head[q], s.start[q + 1] - s.start[q]);
    __syncthreads();
    int per = 1;
    while (per < 32 && 2 * per * k <= kThreads) per *= 2;
    const int q = me / per;
    const int h = q < k ? runs[q].x : 0;
    int before = 0;
    if (q < k)
      for (int r = me % per; r < k; r += per) {
        const int2 x = runs[r];
        before += x.x < h ? x.y : 0;
      }
    for (int o = per / 2; o > 0; o >>= 1)
      before += __shfl_xor_sync(0xffffffffu, before, o);
    if (q < k && me % per == 0) s.shift[q] = before - s.start[q];
  } else {
    for (int q = me; q < k; q += kThreads)
      s.key[q] = (unsigned long long)s.head[q] << 32 | (unsigned)q;
    __syncthreads();
    order_network(s.key, k);
    constexpr int kEach = kMaxBlockRuns / kThreads;  // sorted runs a thread
    int len[kEach], mine = 0;
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int i = me * kEach + e;
      const int q = i < k ? (int)(s.key[i] & 0xffffffffu) : 0;
      len[e] = i < k ? s.start[q + 1] - s.start[q] : 0;
      mine += len[e];
    }
    int total;
    int at = block_exclusive_scan<int>(mine, &total);
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int i = me * kEach + e;
      if (i < k) {
        const int q = (int)(s.key[i] & 0xffffffffu);
        s.shift[q] = at - s.start[q];
      }
      at += len[e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * kThreads + me;
    if (i < n) seg[i + s.shift[s.rows[i]]] = v[e] & ~kRunHead;
  }
  __syncthreads();
}

// The kernel's shared memory, one phase's at a time.
union Shared {
  RecordCache rec;
  Window win;
  BlockRuns block;
  WarpRuns warp[kWarps];
};

// Phase 7: first the ``longs`` long tiles (more than kWarpRows rows,
// listed by phase 4), block b taking the list's entries b, b + G, ..., each
// entry zeroed behind it, and ordering each with the whole block; then
// block b's tiles b, b + G, b + 2G, ..., warp w taking the (w + kWarps m)-th
// of them, 32 at a time (lane q loads the count and start of the q-th, and
// zeroes the counter), each tile's first 32 rows loading while the tile
// before it is ordered.
__device__ void order_tiles(const Args& g, int longs, Shared& sm) {
  for (int w = blockIdx.x; w < longs; w += gridDim.x) {
    const int t = __ldcg(g.heavy + w);
    int* seg = g.index + __ldcg(g.starts + t);
    const int n = __ldcg(g.counts + t);
    __syncthreads();                     // every thread has read the entry
    if (threadIdx.x == 0) g.heavy[w] = 0;
    if (n > kOrderCap) {
      for (int i = threadIdx.x; i < n; i += kThreads)
        seg[i] = __ldcg(seg + i) & ~kRunHead;
      __syncthreads();
      order_network(seg, n);
      continue;
    }
    order_runs(seg, n, sm.block);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long m0 = 0;; m0 += 32) {
    const long long tile =
        blockIdx.x + (warp + kWarps * (m0 + lane)) * (long long)gridDim.x;
    const bool have = tile < g.NT;
    if (!__any_sync(0xffffffffu, have)) break;
    const int my_n = have ? __ldcg(g.counts + tile) : 0;
    const int my_start = have ? __ldcg(g.starts + tile) : 0;
    if (my_n > 0) g.cnt[tile] = 0;       // left at the segment's start
    // the tiles a warp orders, one after another; the first 32 rows of the
    // next load while one is ordered
    unsigned todo = __ballot_sync(0xffffffffu, my_n >= 1 && my_n <= kWarpRows);
    int q = __ffs(todo) - 1;
    int rows = 0;
    if (todo) {
      const int n = __shfl_sync(0xffffffffu, my_n, q);
      const int start = __shfl_sync(0xffffffffu, my_start, q);
      rows = lane < n ? __ldcg(g.index + start + lane) : INT_MAX;
    }
    while (todo) {
      todo &= todo - 1;
      const int next = __ffs(todo) - 1;
      const int n = __shfl_sync(0xffffffffu, my_n, q);
      const int start = __shfl_sync(0xffffffffu, my_start, q);
      const int next_n = __shfl_sync(0xffffffffu, my_n, next & 31);
      const int next_start = __shfl_sync(0xffffffffu, my_start, next & 31);
      const int next_rows = todo && lane < next_n
                                ? __ldcg(g.index + next_start + lane)
                                : INT_MAX;
      order_warp_tile(g.index + start, n, rows, sm.warp[warp]);
      q = next;
      rows = next_rows;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksAnSM) bin_tiles_kernel(
    const Args g) {
  __shared__ Shared sm;
  const int b = blockIdx.x, G = gridDim.x, t = threadIdx.x;
  if (g.times != nullptr && b == 0 && t == 0) g.times[0] = global_time();

  // 1. the block's records: their span sum and live count
  const long long r0 = (long long)b * g.R / G;
  const long long r1 = (long long)(b + 1) * g.R / G;
  {
    long long span;
    int live;
    sum_records(g, r0, r1, sm.rec, &span, &live);
    if (t == 0) {
      g.rec_sum[b] = (unsigned long long)span;
      g.rec_live[b] = (unsigned long long)live;
    }
  }
  grid_sync(g, 1);

  // 2. the blocks before this one and all: the kept pairs K, the live
  // records L, the flag, and this block's live records; then the dead
  // slots [K, C) while the other blocks compact
  long long before = 0, total = 0;
  int live_before = 0, L = 0;
  for (int k = t; k < G; k += kThreads) {
    const long long s = (long long)__ldcg(g.rec_sum + k);
    const int l = (int)__ldcg(g.rec_live + k);
    total += s;
    L += l;
    if (k < b) {
      before += s;
      live_before += l;
    }
  }
  before = block_sum(before);
  total = block_sum(total);
  live_before = block_sum(live_before);
  L = block_sum(L);
  const long long K = total < g.C ? total : g.C;
  if (b == 0 && t == 0) *g.overflow = total > g.C;
  compact(g, r0, r1, before, live_before, sm.rec);
  {
    const unsigned old = grid_arrive(g);
    for (long long s = K + (long long)b * kThreads + t; s < g.C;
         s += (long long)G * kThreads)
      g.index[s] = g.R - 1;
    grid_wait(g, old, 2);
  }
  if (t == 0) g.rec_sum[b] = g.rec_live[b] = 0;

  // 3. the count over the block's equal range of the kept pairs
  const long long lo = (long long)b * K / G;
  const long long hi = (long long)(b + 1) * K / G;
  const int j0 = lo < hi ? find_live(g, L, lo) : 0;
  walk_pairs<false>(g, lo, hi, j0, L, sm.win);
  grid_sync(g, 3);

  // 4. the block's tiles' counts and their sum, and the long tiles onto
  // the list
  const int t0 = (int)((long long)b * g.NT / G);
  const int t1 = (int)((long long)(b + 1) * g.NT / G);
  {
    int sum = 0;
    for (int k = t0 + t; k < t1; k += kThreads) {
      const int v = __ldcg(g.cnt + k);
      g.counts[k] = v;
      sum += v;
      if (v > kWarpRows) g.heavy[atomicAdd(g.counters + 1, 1u)] = k;
    }
    sum = block_sum(sum);
    if (t == 0) g.tile_sum[b] = (unsigned long long)sum;
  }
  grid_sync(g, 4);

  // 5. the block's tiles' starts from the sums of the blocks before it
  // (each thread's tiles are the ones it counted in phase 4), and each
  // tile's counter set to its segment's end; the count of long tiles
  const int longs = (int)__ldcg(g.counters + 1);
  {
    int at = 0;
    for (int k = t; k < b; k += kThreads) at += (int)__ldcg(g.tile_sum + k);
    at = block_sum(at);
    for (int base = t0; base < t1; base += kThreads) {
      const int k = base + t;
      const int v = k < t1 ? g.counts[k] : 0;
      int round;
      const int ex = block_exclusive_scan<int>(v, &round);
      if (k < t1) {
        g.starts[k] = at + ex;
        // the segment's end, for the claims (an empty tile's stays 0)
        if (v > 0) g.cnt[k] = at + ex + v;
      }
      at += round;
    }
  }
  grid_sync(g, 5);
  if (t == 0) g.tile_sum[b] = 0;
  if (b == 0 && t == 0) g.counters[1] = 0;

  // 6. the place over the same pairs
  walk_pairs<true>(g, lo, hi, j0, L, sm.win);
  grid_sync(g, 6);

  // 7. the order (with a times buffer, each block's end stamped)
  order_tiles(g, longs, sm);
  if (g.times != nullptr) {
    __syncthreads();
    if (t == 0) g.times[kStamps + b] = global_time();
  }
}

}  // namespace

// 8-byte scratch words a launch of ``blocks`` blocks over NT tiles uses:
// the two counters, three words a block (its span sum, live records and
// tiles' pairs), then cnt (16-byte aligned) and the list of long tiles (NT
// int32 each). All must be zero when a launch starts, and it leaves them
// zeroed: a scratch serves later launches of other shapes, whose words lie
// elsewhere in it.
extern "C" long long bin_tiles_scratch_words(int blocks, int NT) {
  const long long head = kHeadWords + 3ll * blocks;
  return head + (head & 1) + NT;
}

// Once, before the first launch: the kernel prefers shared memory to L1.
extern "C" int bin_tiles_setup() {
  return (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(bin_tiles_kernel),
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// The kernel's blocks that an SM of the current device holds at once and
// the device's SMs. Returns the CUDA error, 0 on success.
extern "C" int bin_tiles_occupancy(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, bin_tiles_kernel, kThreads, 0);
  return (int)err;
}

// The grid of a launch over R records on a device of ``sms`` SMs that hold
// ``per_sm`` blocks each (bin_tiles_occupancy): a block for each
// kRecordsABlock records, at least one an SM and at most the fewer of
// per_sm and kBlocksAnSM an SM, so every block is resident.
extern "C" int bin_tiles_grid(long long R, int per_sm, int sms) {
  const long long most =
      (long long)sms * (per_sm < kBlocksAnSM ? per_sm : kBlocksAnSM);
  const long long want = (R + kRecordsABlock - 1) / kRecordsABlock;
  return (int)(want < sms ? sms : want < most ? want : most);
}

// One launch over R > 0 records into index[C], starts[NT], counts[NT] and
// overflow on ``stream``, ``blocks`` blocks, ``live`` R int4 of workspace,
// ``times`` 7 + blocks words or null. A cooperative launch: the runtime
// refuses a grid the card cannot hold at once. Returns the launch's CUDA
// error (0 when it was accepted), clearing it.
extern "C" int bin_tiles_launch(
    const float* b0, const float* b1, const float* b2, const float* b3,
    long long s0, long long s1, long long s2, long long s3,
    const uint8_t* valid, long long valid_stride, int R, int W, int y0,
    int ph, int ntx, int NT, long long C, int blocks,
    unsigned long long* scratch, int4* live, int* index, int* starts,
    int* counts, uint8_t* overflow, unsigned long long* times, void* stream) {
  Args g{{b0, b1, b2, b3}, {s0, s1, s2, s3}, valid, valid_stride,
         R, W, y0, ph, ntx, NT, C,
         reinterpret_cast<unsigned int*>(scratch), nullptr, nullptr, nullptr,
         nullptr, nullptr, live, index, starts, counts, overflow, times};
  g.rec_sum = scratch + kHeadWords;
  g.rec_live = g.rec_sum + blocks;
  g.tile_sum = g.rec_live + blocks;
  const long long head = kHeadWords + 3ll * blocks;
  g.cnt = reinterpret_cast<int*>(scratch + head + (head & 1));
  g.heavy = g.cnt + NT;
  void* args[] = {&g};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bin_tiles_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
