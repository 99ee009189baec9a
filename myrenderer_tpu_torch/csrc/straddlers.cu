// K4: a batch's eye-plane straddlers, selected in array order and clipped
// into its appendee block (wrapper: myrenderer_tpu_torch/ops/straddlers.py;
// plain version: ops/raster_common.py select_straddlers_reference).
//
// What it replaces. The JAX package selects and clips each batch's
// straddlers inside its compiled frame (myrenderer_tpu/ops/raster_common.py
// select_straddlers and _clip_straddlers), where XLA fuses them; they are no
// Pallas kernel. The plain version sorts where(straddle, arange(T), T) over
// all T triangles to keep the first cap, then clips the cap rows in about 50
// torch launches.
//
// What it computes, with no sort. A triangle straddles when it is valid and
// one of its w lanes is > W_EPS while another is <= W_EPS (NaN compares
// false). sel[j] for j < min(count, cap) is the j-th straddler in array
// order; the slots past them hold row T - 1 (the plain code's index T,
// clamped), clipped as any row is, with app_valid false. Slot j's clipped
// triangles go to rows j (the first) and cap + j (the second) of app_clip
// [2cap, 3, 4], app_vary [2cap, 3, C] and app_valid [2cap]; overflow is
// count > cap.
//
// One launch, straddle_select_kernel, of one block a chunk of kChunk
// triangles plus a few helper blocks; nothing is read back to the host:
//   1. a block takes a ticket (an atomic counter): tickets below the chunk
//      count are chunks, in order, the rest helpers; a block waits only on
//      blocks of lower tickets, which have started;
//   2. a chunk's block loads its w lanes (every lane to shared memory, each
//      warp instruction over consecutive 16-byte clip rows where the rows
//      are contiguous) and valid flags, every load in flight, keeps its
//      straddle bits as ballot masks, and publishes its count in its status
//      word (an aggregate; chunk 0 publishes an inclusive prefix);
//   3. a chunk with straddlers finds its first rank by a decoupled
//      look-back over the status words of the chunks before it (kThreads
//      words a round, back to the nearest inclusive prefix, spinning on a
//      word not yet published: its block publishes without waiting on any
//      other), publishes its inclusive prefix, and while its ranks are
//      below cap clips each straddler into its slot; a chunk with none is
//      done;
//   4. each helper clips row T - 1 into shared memory, sums the total from
//      every chunk's status word (all loads in flight, no look-back chain)
//      and writes its share of the dead slots
//      [min(total, cap), cap); the first writes overflow;
//   5. the last block to finish (an atomic done counter) zeroes the ticket,
//      the counter and the status words, so the scratch is clean for the
//      next call and for every replay of a CUDA graph that holds the launch.
//
// Rounding. The clip (_clip_straddlers) is one operation at a time in the
// plain code's order: the rotation r is the first inside vertex when one is
// inside, else the first outside one (0 when there is none, as torch's
// argmax of a bool row gives); t = (W_CLIP - wi) / (wj - wi), clamped to
// [0, 1] with NaN kept as torch's clamp keeps it; each lane
// fma(t, v_j - v_i, v_i). Built with -fmad=false and without flushing
// subnormals.
//
// Bound: bytes. Each triangle's three w lanes lie 16 bytes apart, so every
// 32-byte sector of the clip rows is fetched: with the valid flag about 49
// bytes a triangle. The selected rows and the appendee block are a few
// hundred kilobytes at most. The w lanes are read once, with no L1 line
// (load_w); what a call costs beyond its bytes is latency: the ticket, the
// last chunk's publish, the helpers' look-back and writes, and the done
// counter, a few microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// triangles a thread: chunks of 512 triangles, four waves of blocks at 4K
// (tools/k4_lab.py times 256, 1,024 and 2,048)
constexpr int kItems = 2;
constexpr int kChunk = kThreads * kItems;      // triangles a block
constexpr float kWEps = 1e-6f;                 // raster_common.W_EPS
constexpr float kWClip = 8e-6f;                // raster_common.W_CLIP
constexpr int kDeadSlots = 512;                // cap slots a helper block
constexpr int kMaxHelpers = 64;                // (more slots each past it)
constexpr int kTotalLoads = 4;                 // status words in flight
// a status word: 0 until published, then a flag, the count of chunks
// [0, k] when the flag is kPrefix, and the chunk's own count (kCountBits)
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr int kCountBits = 16;
constexpr unsigned long long kCount = (1ull << kCountBits) - 1;

struct Args {
  const float* clip;  long long cs0, cs1, cs2;   // [T, 3, 4]
  const float* vary;  long long vs0, vs1, vs2;   // [T, 3, C]
  const uint8_t* valid;  long long valid_stride;
  int T, C, cap, blocks, helpers;               // chunks, helper blocks
  unsigned int* counters;                        // ticket, done
  unsigned long long* status;                    // a word a chunk
  float* app_clip;  float* app_vary;             // [2cap, 3, 4], [2cap, 3, C]
  uint8_t* app_valid;  int* sel;  uint8_t* overflow;
};

// a w lane of the count, read once: it takes no L1 line, which is faster
// than __ldg on a cold input and inside the frame's graph replay, slower
// when the same input is read again warm (tools/k4_lab.py, variant "ldg")
__device__ __forceinline__ float load_w(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
               : "=f"(v) : "l"(p));
  return v;
}

// torch's clamp(t, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float t) {
  return isnan(t) ? t : fminf(fmaxf(t, 0.f), 1.f);
}

// v_i + t (v_j - v_i) as fma(t, v_j - v_i, v_i)
__device__ __forceinline__ float lerp(float t, float vi, float vj) {
  return __fmaf_rn(t, __fsub_rn(vj, vi), vi);
}

// _clip_straddlers of row ``t``: its first triangle to c1 (12 floats, 16-byte
// aligned) and v1 (3 C), its second to c2 and v2; returns its vertices
// inside the eye plane
__device__ int clip_rows(const Args& g, int t, float* c1, float* c2,
                         float* v1, float* v2) {
  float w[3];
  for (int k = 0; k < 3; ++k) w[k] = __ldg(g.clip + t * g.cs0 + k * g.cs1 +
                                           3 * g.cs2);
  const bool in0 = w[0] > kWEps, in1 = w[1] > kWEps, in2 = w[2] > kWEps;
  const int n_in = in0 + in1 + in2;
  int r;
  if (n_in == 1) r = in0 ? 0 : in1 ? 1 : in2 ? 2 : 0;
  else r = !in0 ? 0 : !in1 ? 1 : !in2 ? 2 : 0;
  const int i0 = r, i1 = (r + 1) % 3, i2 = (r + 2) % 3;
  const float w0 = w[i0], w1 = w[i1], w2 = w[i2];
  const float t01 = clamp01(__fdiv_rn(__fsub_rn(kWClip, w0), __fsub_rn(w1, w0)));
  const float t20 = clamp01(__fdiv_rn(__fsub_rn(kWClip, w2), __fsub_rn(w0, w2)));
  const bool one_in = n_in == 1;
  float r1[12], r2[12];
  for (int ch = 0; ch < 4; ++ch) {
    const float* p = g.clip + t * g.cs0 + ch * g.cs2;
    const float a0 = __ldg(p + i0 * g.cs1), a1 = __ldg(p + i1 * g.cs1),
                a2 = __ldg(p + i2 * g.cs1);
    const float x01 = lerp(t01, a0, a1), x20 = lerp(t20, a2, a0);
    r1[ch] = one_in ? a0 : x01;
    r1[4 + ch] = one_in ? x01 : a1;
    r1[8 + ch] = one_in ? x20 : a2;
    r2[ch] = x01;
    r2[4 + ch] = a2;
    r2[8 + ch] = x20;
  }
  for (int k = 0; k < 3; ++k) {
    reinterpret_cast<float4*>(c1)[k] =
        make_float4(r1[4 * k], r1[4 * k + 1], r1[4 * k + 2], r1[4 * k + 3]);
    reinterpret_cast<float4*>(c2)[k] =
        make_float4(r2[4 * k], r2[4 * k + 1], r2[4 * k + 2], r2[4 * k + 3]);
  }
  for (int ch = 0; ch < g.C; ++ch) {
    const float* p = g.vary + t * g.vs0 + ch * g.vs2;
    const float a0 = __ldg(p + i0 * g.vs1), a1 = __ldg(p + i1 * g.vs1),
                a2 = __ldg(p + i2 * g.vs1);
    const float x01 = lerp(t01, a0, a1), x20 = lerp(t20, a2, a0);
    v1[ch] = one_in ? a0 : x01;
    v1[g.C + ch] = one_in ? x01 : a1;
    v1[2 * g.C + ch] = one_in ? x20 : a2;
    v2[ch] = x01;
    v2[g.C + ch] = a2;
    v2[2 * g.C + ch] = x20;
  }
  return n_in;
}

// row ``t`` clipped into appendee slot ``slot`` (a live one)
__device__ void clip_into(const Args& g, int t, int slot) {
  const long long s1 = slot, s2 = (long long)g.cap + slot;
  const int n_in = clip_rows(g, t, g.app_clip + s1 * 12, g.app_clip + s2 * 12,
                             g.app_vary + s1 * 3 * g.C,
                             g.app_vary + s2 * 3 * g.C);
  g.app_valid[s1] = n_in == 1 || n_in == 2;
  g.app_valid[s2] = n_in == 2;
  g.sel[slot] = t;
}

// an inclusive prefix (the straddlers of chunks [0, k]) and the chunk's own
__device__ __forceinline__ unsigned long long prefix_word(long long prefix,
                                                          int count) {
  return kPrefix | (unsigned long long)prefix << kCountBits | count;
}

// what a word adds to a look-back: the prefix it holds, else its count
__device__ __forceinline__ long long look_back_value(unsigned long long word) {
  return (word & kPrefix) ? (long long)((word & (kAggregate - 1)) >> kCountBits)
                          : (long long)(word & kCount);
}

__device__ __forceinline__ void publish(const Args& g, int chunk,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(g.status + chunk) = word;
}

// The straddlers of chunks [0, pos), pos > 0, from their status words:
// kThreads words a round from pos - 1 back to the nearest inclusive prefix,
// each thread spinning on its word until it is published. Called by the
// whole block; every thread gets the sum.
__device__ long long count_before(const Args& g, int pos) {
  __shared__ int s_near;                 // the nearest prefix word's thread
  __shared__ long long s_sum[kWarps];
  long long acc = 0;
  for (int end = pos; end > 0; end -= kThreads) {
    const int k = end - 1 - (int)threadIdx.x;
    unsigned long long word = 0;
    if (k >= 0) {
      const volatile unsigned long long* p = g.status + k;
      do { word = *p; } while (word == 0);
    }
    if (threadIdx.x == 0) s_near = kThreads;
    __syncthreads();
    if (word & kPrefix) atomicMin(&s_near, (int)threadIdx.x);
    __syncthreads();
    const int near = s_near;
    long long v = 0;
    if ((int)threadIdx.x <= near) v = look_back_value(word);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x % 32 == 0) s_sum[threadIdx.x / 32] = v;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) acc += s_sum[w];
    __syncthreads();                     // s_near and s_sum are reused
    if (near < kThreads) break;
  }
  return acc;
}

// The straddlers of every chunk: the own counts of all status words, each
// thread loading kThreads-strided words kTotalLoads at a time before it
// spins on one not yet published. Called by the whole block.
__device__ long long total_count(const Args& g) {
  __shared__ long long s_sum[kWarps];
  long long v = 0;
  for (int k0 = threadIdx.x; k0 < g.blocks; k0 += kTotalLoads * kThreads) {
    const volatile unsigned long long* p = g.status + k0;
    unsigned long long word[kTotalLoads];
#pragma unroll
    for (int i = 0; i < kTotalLoads; ++i)
      word[i] = k0 + i * kThreads < g.blocks ? p[i * kThreads] : kAggregate;
#pragma unroll
    for (int i = 0; i < kTotalLoads; ++i) {
      while (word[i] == 0) word[i] = p[i * kThreads];
      v += word[i] & kCount;
    }
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) s_sum[threadIdx.x / 32] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += s_sum[w];
  return total;
}

// dst[f] = src[f % period] for f in [0, len), over the block's threads
__device__ void repeat_row(float* dst, const float* src, int period,
                           long long len) {
  const int step = kThreads % period;
  int col = threadIdx.x % period;
  for (long long f = threadIdx.x; f < len; f += kThreads) {
    dst[f] = src[col];
    col += step;
    if (col >= period) col -= period;
  }
}

// Helper ``h``: its share of the dead slots [live, cap), from row T - 1
// clipped once into ``rows`` (shared memory: 24 + 6 C floats); helper 0
// writes overflow.
__device__ void write_dead(const Args& g, int h, float* rows) {
  float* c1 = rows;
  float* c2 = rows + 12;
  float* v1 = rows + 24;
  float* v2 = v1 + 3 * g.C;
  if (threadIdx.x == 0) clip_rows(g, g.T - 1, c1, c2, v1, v2);
  // (total_count's barrier makes the rows visible to the block)
  const long long total = total_count(g);
  const int live = (int)(total < g.cap ? total : g.cap);
  if (h == 0 && threadIdx.x == 0) *g.overflow = total > g.cap;
  const int per = (g.cap - live + g.helpers - 1) / g.helpers;
  const int lo = live + h * per, hi = min(g.cap, lo + per);
  if (lo >= hi) return;
  for (int half = 0; half < 2; ++half) {
    const long long first = (long long)half * g.cap + lo;
    repeat_row(g.app_clip + first * 12, half ? c2 : c1, 12, 12LL * (hi - lo));
    repeat_row(g.app_vary + first * 3 * g.C, half ? v2 : v1, 3 * g.C,
               3LL * g.C * (hi - lo));
  }
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    g.app_valid[j] = 0;
    g.app_valid[g.cap + j] = 0;
    g.sel[j] = g.T - 1;
  }
}

// Chunk ``chunk``: its straddlers counted, published, ranked and clipped
// (``s_w``: shared memory for its 3 kChunk w lanes).
__device__ void select_chunk(const Args& g, int chunk, float* s_w) {
  __shared__ int s_warp_n[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long base = (long long)chunk * kChunk;
  // w lane s of the chunk is lane 3 of vertex s % 3 of row base + s / 3;
  // the valid flags of this warp's 32 kItems triangles, 32 a step
  float w[3 * kItems];
  bool valid[kItems];
#pragma unroll
  for (int r = 0; r < 3 * kItems; ++r) {
    const int s = r * kThreads + threadIdx.x;
    const long long t = base + s / 3;
    w[r] = t < g.T
               ? load_w(g.clip + t * g.cs0 + (s % 3) * g.cs1 + 3 * g.cs2)
               : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long t = base + warp * (kItems * 32) + it * 32 + lane;
    valid[it] = t < g.T && __ldg(g.valid + t * g.valid_stride) != 0;
  }
#pragma unroll
  for (int r = 0; r < 3 * kItems; ++r) s_w[r * kThreads + threadIdx.x] = w[r];
  __syncthreads();
  // straddle bits: warp w holds triangles [n w, n (w + 1)) of the chunk
  // (n = 32 kItems), step ``it`` the 32 from n w + 32 it
  unsigned masks[kItems];
  int n = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const float* wl = s_w + 3 * (warp * (kItems * 32) + it * 32 + lane);
    const float w0 = wl[0], w1 = wl[1], w2 = wl[2];
    const bool some_in = w0 > kWEps || w1 > kWEps || w2 > kWEps;
    const bool some_out = w0 <= kWEps || w1 <= kWEps || w2 <= kWEps;
    masks[it] = __ballot_sync(0xffffffffu, valid[it] && some_in && some_out);
    n += __popc(masks[it]);
  }
  if (lane == 0) s_warp_n[warp] = n;
  __syncthreads();
  int count = 0, warp_first = 0;
  for (int k = 0; k < kWarps; ++k) {
    count += s_warp_n[k];
    warp_first += k < warp ? s_warp_n[k] : 0;
  }
  if (threadIdx.x == 0)
    publish(g, chunk, chunk == 0 ? prefix_word(count, count)
                                 : kAggregate | count);
  if (count == 0) return;                // uniform over the block
  long long first = 0;
  if (chunk > 0) {
    first = count_before(g, chunk);
    if (threadIdx.x == 0)
      publish(g, chunk, prefix_word(first + count, count));
  }
  if (first >= g.cap) return;
  long long rank = first + warp_first;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long mine = rank + __popc(masks[it] & below);
    if ((masks[it] >> lane & 1u) && mine < g.cap)
      clip_into(g, (int)(base + warp * (kItems * 32) + it * 32 + lane),
                (int)mine);
    rank += __popc(masks[it]);
  }
}

__global__ void __launch_bounds__(kThreads) straddle_select_kernel(
    const Args g) {
  __shared__ __align__(16) float s_w[3 * kChunk];
  __shared__ int s_ticket, s_last;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(g.counters, 1u);
  __syncthreads();
  const int ticket = s_ticket;
  if (ticket < g.blocks) select_chunk(g, ticket, s_w);
  else write_dead(g, ticket - g.blocks, s_w);
  // the last block to finish zeroes the scratch: every other block is done
  // with it
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(g.counters + 1, 1u) ==
             (unsigned)(g.blocks + g.helpers - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < g.blocks; k += kThreads) g.status[k] = 0;
  if (threadIdx.x == 0) g.counters[0] = g.counters[1] = 0;
}

}  // namespace

// Chunks over T triangles (the status words a launch uses).
extern "C" int straddlers_blocks(int T) { return (T + kChunk - 1) / kChunk; }

// The most varying channels a launch takes (the helpers' rows in s_w).
extern "C" int straddlers_max_channels() { return (3 * kChunk - 24) / 6; }

// The launch over T > 0 triangles on ``stream``. ``scratch`` holds
// 2 + straddlers_blocks(T) zeroed 8-byte words (two counters, then a status
// word a chunk); the launch leaves them zeroed. Returns the launch's CUDA
// error (0 when it was accepted).
extern "C" int straddlers_launch(
    const float* clip, long long cs0, long long cs1, long long cs2,
    const float* vary, long long vs0, long long vs1, long long vs2,
    const uint8_t* valid, long long valid_stride, int T, int C, int cap,
    unsigned long long* scratch, float* app_clip, float* app_vary,
    uint8_t* app_valid, int* sel, uint8_t* overflow, void* stream) {
  const int blocks = straddlers_blocks(T);
  const int helpers = min(kMaxHelpers, (cap + kDeadSlots - 1) / kDeadSlots);
  const Args g{clip, cs0, cs1, cs2, vary, vs0, vs1, vs2, valid, valid_stride,
               T, C, cap, blocks, helpers,
               reinterpret_cast<unsigned int*>(scratch), scratch + 2,
               app_clip, app_vary, app_valid, sel, overflow};
  straddle_select_kernel<<<blocks + helpers, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
