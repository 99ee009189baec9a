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
// count > cap. Two launches:
//   straddle_count_kernel: block b counts the straddlers of its kChunk
//     triangles into counts[b];
//   straddle_select_kernel: block b sums counts[0, b) (its first rank) and
//     all of counts (the total); a block with straddlers and a first rank
//     below cap ranks its triangles again (a ballot a warp, the warps' counts
//     in shared memory) and clips each straddler whose rank is below cap into
//     that slot; the slots from min(total, cap) to cap are shared over all
//     blocks. Nothing is read back to the host.
//
// Rounding. The clip (_clip_straddlers) is one operation at a time in the
// plain code's order: the rotation r is the first inside vertex when one is
// inside, else the first outside one (0 when there is none, as torch's
// argmax of a bool row gives); t = (W_CLIP - wi) / (wj - wi), clamped to
// [0, 1] with NaN kept as torch's clamp keeps it; each lane
// fma(t, v_j - v_i, v_i). Built with -fmad=false and without flushing
// subnormals.
//
// Bound: bytes. The count reads each triangle's three w lanes and its valid
// flag; the w lanes lie 16 bytes apart, so every 32-byte sector of the clip
// rows is fetched: about 49 bytes a triangle. The select pass of a block
// without straddlers reads only the counts; the cap selected rows and the
// appendee block are a few hundred kilobytes at most.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // triangles a thread a pass
constexpr int kChunk = kThreads * kItems;      // triangles a block
constexpr float kWEps = 1e-6f;                 // raster_common.W_EPS
constexpr float kWClip = 8e-6f;                // raster_common.W_CLIP

struct Args {
  const float* clip;  long long cs0, cs1, cs2;   // [T, 3, 4]
  const float* vary;  long long vs0, vs1, vs2;   // [T, 3, C]
  const uint8_t* valid;  long long valid_stride;
  int T, C, cap;
  const int* counts;  int blocks;                // straddlers a block
  float* app_clip;  float* app_vary;             // [2cap, 3, 4], [2cap, 3, C]
  uint8_t* app_valid;  int* sel;  uint8_t* overflow;
};

__device__ __forceinline__ bool straddles(const Args& g, int t) {
  const float* w = g.clip + t * g.cs0 + 3 * g.cs2;
  const float w0 = __ldg(w), w1 = __ldg(w + g.cs1), w2 = __ldg(w + 2 * g.cs1);
  const bool some_in = w0 > kWEps || w1 > kWEps || w2 > kWEps;
  const bool some_out = w0 <= kWEps || w1 <= kWEps || w2 <= kWEps;
  return __ldg(g.valid + t * g.valid_stride) != 0 && some_in && some_out;
}

// torch's clamp(t, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float t) {
  return isnan(t) ? t : fminf(fmaxf(t, 0.f), 1.f);
}

// v_i + t (v_j - v_i) as fma(t, v_j - v_i, v_i)
__device__ __forceinline__ float lerp(float t, float vi, float vj) {
  return __fmaf_rn(t, __fsub_rn(vj, vi), vi);
}

// _clip_straddlers of row ``t`` into appendee slot ``slot``
__device__ void clip_into(const Args& g, int t, int slot, bool live) {
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
  float* c1 = g.app_clip + (long long)slot * 12;
  float* c2 = g.app_clip + (long long)(g.cap + slot) * 12;
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
  float* v1 = g.app_vary + (long long)slot * 3 * g.C;
  float* v2 = g.app_vary + (long long)(g.cap + slot) * 3 * g.C;
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
  g.app_valid[slot] = live && (n_in == 1 || n_in == 2);
  g.app_valid[g.cap + slot] = live && n_in == 2;
  g.sel[slot] = t;
}

__global__ void __launch_bounds__(kThreads) straddle_count_kernel(
    const Args g, int* counts) {
  __shared__ int warp_n[kWarps];
  const int base = blockIdx.x * kChunk;
  int n = 0;
  for (int it = 0; it < kItems; ++it) {
    const int t = base + it * kThreads + threadIdx.x;
    n += t < g.T && straddles(g, t);
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (threadIdx.x % 32 == 0) warp_n[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_n[w];
    counts[blockIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) straddle_select_kernel(
    const Args g) {
  __shared__ int warp_n[2][kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // this block's first rank and the batch's straddler count
  int before = 0, total = 0;
  for (int k = threadIdx.x; k < g.blocks; k += kThreads) {
    const int c = g.counts[k];
    total += c;
    before += k < blockIdx.x ? c : 0;
  }
  before = __reduce_add_sync(0xffffffffu, before);
  total = __reduce_add_sync(0xffffffffu, total);
  if (lane == 0) {
    warp_n[0][warp] = before;
    warp_n[1][warp] = total;
  }
  __syncthreads();
  int first = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    first += warp_n[0][w];
    total += warp_n[1][w];
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *g.overflow = total > g.cap;
  // this block's straddlers, ranked in array order (uniform over the block)
  if (g.counts[blockIdx.x] > 0 && first < g.cap) {
    const int base = blockIdx.x * kChunk;
    int running = first;
    for (int it = 0; it < kItems && running < g.cap; ++it) {
      const int t = base + it * kThreads + threadIdx.x;
      const bool f = t < g.T && straddles(g, t);
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      if (lane == 0) warp_n[0][warp] = __popc(ballot);
      __syncthreads();
      int rank = running + __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < kWarps; ++w) {
        rank += w < warp ? warp_n[0][w] : 0;
        running += warp_n[0][w];
      }
      if (f && rank < g.cap) clip_into(g, t, rank, true);
      __syncthreads();
    }
  }
  // the dead slots: row T - 1, not valid
  const int live = min(total, g.cap);
  for (int j = live + blockIdx.x * kThreads + threadIdx.x; j < g.cap;
       j += gridDim.x * kThreads)
    clip_into(g, g.T - 1, j, false);
}

}  // namespace

// Blocks of the two launches over T triangles (the size of ``counts``).
extern "C" int straddlers_blocks(int T) { return (T + kChunk - 1) / kChunk; }

// The two launches over T > 0 triangles on ``stream``; ``counts`` holds
// straddlers_blocks(T) ints of scratch. Returns the first launch error (0
// when both were accepted).
extern "C" int straddlers_launch(
    const float* clip, long long cs0, long long cs1, long long cs2,
    const float* vary, long long vs0, long long vs1, long long vs2,
    const uint8_t* valid, long long valid_stride, int T, int C, int cap,
    int* counts, float* app_clip, float* app_vary, uint8_t* app_valid,
    int* sel, uint8_t* overflow, void* stream) {
  const int blocks = straddlers_blocks(T);
  const Args g{clip, cs0, cs1, cs2, vary, vs0, vs1, vs2, valid, valid_stride,
               T, C, cap, counts, blocks, app_clip, app_vary, app_valid, sel,
               overflow};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  straddle_count_kernel<<<blocks, kThreads, 0, s>>>(g, counts);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  straddle_select_kernel<<<blocks, kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}
