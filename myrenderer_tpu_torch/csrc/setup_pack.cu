// K2: clip + setup + pack of a raster pass's batches, written into rows of
// the pass's record tables in one launch (wrapper and plain version:
// myrenderer_tpu_torch/ops/setup_pack.py).
//
// What it replaces. The JAX package sets each batch up inside its
// compiled frame (myrenderer_tpu/renderer/draw.py _setup_batch, which runs
// myrenderer_tpu/ops/raster_common.py triangle_setup and pack_coeffs_full
// and myrenderer_tpu/ops/raster_pallas.py viewport_bbox); XLA fuses that
// code, it is no Pallas kernel. The port's plain version spells every
// rounding form as its own torch op: about 250 launches a batch, then
// stacks and concatenations of the 32 lanes, of the batch and its
// appendee block, and of the batches of a pass.
//
// What it computes. A launch takes up to kMaxSegments segments by value in
// its parameter block (no descriptor in device memory, so a CUDA graph
// captures it as it is). Segment s is one batch or one appendee block: for
// its triangle t of [0, T), the 32 lanes of its record (edges a_k, b_k,
// c_k; the depth numerator and denominator planes; zhi; the id; the
// varying denominator plane; four varying numerator planes), its valid flag
// and its viewport box (min u, max u, min v, max v), into row row0 + t of
// the segment's packed f32[R, 32], valid u8[R] and box f32[4, R] (rows
// box_stride apart). Segments may write to different tables.
//
// Rounding. Every lane equals the plain version's bits: each operation is
// one __fmul_rn, __fadd_rn, __fsub_rn or __fdiv_rn in the plain code's
// order, and __fmaf_rn exactly where it calls rc.fma; the file is built
// with -fmad=false (nvcc contracts nothing itself) and without flushing
// subnormals (the coverage rule's TL_EPS is the smallest normal float).
// torch.amin / amax and clamp propagate NaN, so the box's do too.
//
// Bound: bytes. A triangle reads 96 bytes of clip positions and varyings
// plus its valid flag (and id) and writes a 128-byte record, a 16-byte box
// and a flag; about 200 flops against ~245 bytes, far under the card's
// ratio of flops to bytes. So the design is about moving the bytes:
// - The pass's segments are cut into chunks of kBlock triangles, one
//   thread a triangle; a block finds its chunk's segment from the
//   segments' first chunks. One launch a pass, however many batches.
// - Loads: where a segment's clip positions (or varyings) are contiguous
//   [T, 3, 4] rows, 16-byte aligned, the block copies the chunk's rows into
//   shared memory with cp.async, 16 bytes a thread beside its neighbour's
//   (512 contiguous bytes a warp instruction), and each thread reads its
//   48-byte row back as three float4s (conflict-free: 8 threads of a phase
//   hit 8 distinct groups of 4 banks). Other strides are read per thread.
// - Stores: the records of a chunk are staged in the same shared memory
//   (rows padded to 33 floats: no bank conflicts) and stored as whole rows
//   by consecutive threads, 16 bytes a thread; flags and boxes are
//   coalesced as they are.
// - The grid: a block a chunk. Persistent blocks walking chunks with the
//   next chunk's rows in flight measured slower at 4K (PERF.md, K2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;           // triangles a chunk, one a thread
constexpr int kLanes = 32;
constexpr int kPad = kLanes + 1;
constexpr int kRow = 12;             // floats of one triangle's [3, 4] input
constexpr int kMaxSegments = 24;     // segments a launch takes
// floats of the block's stage: a chunk's records (kBlock rows of kPad),
// which also holds its clip rows and varying rows before them
constexpr int kStage = kBlock * kPad;
static_assert(2 * kBlock * kRow <= kStage, "a stage holds both inputs");
constexpr float kWEps = 1e-6f;       // raster_common.W_EPS

// mode bits
constexpr int kCullMask = 3;         // 0 back, 1 front, 2 none
constexpr int kFormsShift = 2;       // bit 3 * plane + column: that column's
                                     // form (0 or 1); planes 0 depth
                                     // numerator, 1 depth denominator, 2
                                     // varyings
constexpr int kBiased = 1 << 11;
constexpr int kStageClip = 1 << 12;  // clip rows contiguous and aligned
constexpr int kStageVary = 1 << 13;  // varying rows likewise

// One segment; the wrapper's ctypes structure has this layout
// (setup_pack_segment_bytes).
struct Segment {
  const float* clip;                 // [T, 3, 4], element strides cs
  const float* vary;                 // [T, 3, 4], element strides vs
  const uint8_t* valid;
  const int* ids;                    // null: the array rank
  float* packed;
  uint8_t* out_valid;
  float* box;
  int cs[3], vs[3];
  int valid_stride, ids_stride;
  int T, base, row0, box_stride;
  int first_chunk;                   // set by setup_pack_launch
  int mode;
  float W, H, bias;
};

struct Pass {
  Segment seg[kMaxSegments];
  int count, chunks;
};
static_assert(sizeof(Pass) <= 4096, "a launch's parameters fit in 4 KB");

// raster_common._plane's dot3: form 0 fma(x2, v2, fma(x0, v0, x1*v1)),
// form 1 fma(x2, v2, fma(x1, v1, x0*v0))
__device__ __forceinline__ float dot3(const float x[3], const float v[3],
                                      int form) {
  const float inner = form ? __fmaf_rn(x[1], v[1], __fmul_rn(x[0], v[0]))
                           : __fmaf_rn(x[0], v[0], __fmul_rn(x[1], v[1]));
  return __fmaf_rn(x[2], v[2], inner);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the segment of `chunk` (the segments' first chunks rise)
__device__ __forceinline__ int segment_of(const Pass& p, int chunk) {
  int s = 0;
  while (s + 1 < p.count && p.seg[s + 1].first_chunk <= chunk) ++s;
  return s;
}

// start copying the contiguous inputs of the chunk's `rows` triangles from
// t0 into `stage`: clip rows at 0, varying rows at kBlock * kRow
__device__ __forceinline__ void stage_inputs(const Segment& g, int t0,
                                             int rows, float* stage) {
  const int n = rows * (kRow / 4);
  if (g.mode & kStageClip) {
    const float* src = g.clip + (long long)t0 * kRow;
    for (int i = threadIdx.x; i < n; i += kBlock)
      cp_async16(stage + 4 * i, src + 4 * i);
  }
  if (g.mode & kStageVary) {
    const float* src = g.vary + (long long)t0 * kRow;
    for (int i = threadIdx.x; i < n; i += kBlock)
      cp_async16(stage + kBlock * kRow + 4 * i, src + 4 * i);
  }
}

// One triangle set up into its record row r (kLanes floats), its flag and
// its box. x..w: clip positions of the 3 vertices, col: varying channels.
__device__ __forceinline__ void setup_one(const Segment& g, int t, float x[3],
                                          float y[3], float z[3],
                                          const float w[3],
                                          float col[4][3], float* r) {
  const int cull = g.mode & kCullMask;
  const int forms = g.mode >> kFormsShift;
  // u = (0.5*x + 0.5*w) * W, v = (0.5*w - 0.5*y) * H
  float u[3], v[3];
  for (int k = 0; k < 3; ++k) {
    u[k] = __fmul_rn(__fadd_rn(__fmul_rn(0.5f, x[k]), __fmul_rn(0.5f, w[k])),
                     g.W);
    v[k] = __fmul_rn(__fsub_rn(__fmul_rn(0.5f, w[k]), __fmul_rn(0.5f, y[k])),
                     g.H);
  }
  // edge k spans vertices (k+1, k+2) mod 3: p*q - r*s = fma(p, q, -(r*s))
  float a[3], b[3], c[3];
  for (int k = 0; k < 3; ++k) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    a[k] = __fmaf_rn(v[i], w[j], -__fmul_rn(v[j], w[i]));
    b[k] = __fmaf_rn(u[j], w[i], -__fmul_rn(u[i], w[j]));
    c[k] = __fmaf_rn(u[i], v[j], -__fmul_rn(u[j], v[i]));
  }
  const float det = __fmaf_rn(c[0], w[0],
                              __fmaf_rn(a[0], u[0], __fmul_rn(b[0], v[0])));
  bool facing;
  if (cull == 0) {
    facing = det > 0.f;
  } else {
    // front: times -1; none: times torch.sign(det), (0 < d) - (d < 0)
    float sign;
    if (cull == 1) {
      facing = det < 0.f;
      sign = -1.f;
    } else {
      facing = det != 0.f;
      sign = (float)((0.f < det) - (det < 0.f));
    }
    for (int k = 0; k < 3; ++k) {
      a[k] = __fmul_rn(a[k], sign);
      b[k] = __fmul_rn(b[k], sign);
      c[k] = __fmul_rn(c[k], sign);
    }
  }
  const bool ok = __ldg(g.valid + (long long)t * g.valid_stride) != 0 &&
                  facing && w[0] > kWEps && w[1] > kWEps && w[2] > kWEps;
  float zhi = ok ? 1.f : 0.f;
  if (g.mode & kBiased) {
    for (int k = 0; k < 3; ++k) z[k] = __fmaf_rn(g.bias, w[k], z[k]);
    zhi = ok ? __fadd_rn(g.bias, 1.f) : 0.f;
  }
  for (int k = 0; k < 3; ++k) {
    r[3 * k] = a[k];
    r[3 * k + 1] = b[k];
    r[3 * k + 2] = c[k];
  }
  r[9] = dot3(a, z, forms & 1);
  r[10] = dot3(b, z, (forms >> 1) & 1);
  r[11] = dot3(c, z, (forms >> 2) & 1);
  r[12] = dot3(a, w, (forms >> 3) & 1);
  r[13] = dot3(b, w, (forms >> 4) & 1);
  r[14] = dot3(c, w, (forms >> 5) & 1);
  r[15] = zhi;
  const int rank = g.ids ? __ldg(g.ids + (long long)t * g.ids_stride) : t;
  r[16] = __fadd_rn(__int2float_rn(rank), __int2float_rn(g.base));
  // the varying denominator plane: sum of the edges, left to right
  r[17] = __fadd_rn(__fadd_rn(a[0], a[1]), a[2]);
  r[18] = __fadd_rn(__fadd_rn(b[0], b[1]), b[2]);
  r[19] = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
  for (int ch = 0; ch < 4; ++ch) {
    r[20 + 3 * ch] = dot3(a, col[ch], (forms >> 6) & 1);
    r[21 + 3 * ch] = dot3(b, col[ch], (forms >> 7) & 1);
    r[22 + 3 * ch] = dot3(c, col[ch], (forms >> 8) & 1);
  }
  const long long row = (long long)g.row0 + t;
  g.out_valid[row] = ok ? 1 : 0;
  // raster.viewport_bbox: w' = clamp(w, min=W_EPS),
  // u = (0.5*x / w' + 0.5) * W, v = (0.5 - 0.5*y / w') * H
  float bu[3], bv[3];
  for (int k = 0; k < 3; ++k) {
    const float wc = isnan(w[k]) ? w[k] : fmaxf(w[k], kWEps);
    bu[k] = __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(0.5f, x[k]), wc), 0.5f),
                      g.W);
    bv[k] = __fmul_rn(__fsub_rn(0.5f, __fdiv_rn(__fmul_rn(0.5f, y[k]), wc)),
                      g.H);
  }
  float* bx = g.box + row;
  const long long bs = g.box_stride;
  bx[0] = min_nan(min_nan(bu[0], bu[1]), bu[2]);
  bx[bs] = max_nan(max_nan(bu[0], bu[1]), bu[2]);
  bx[2 * bs] = min_nan(min_nan(bv[0], bv[1]), bv[2]);
  bx[3 * bs] = max_nan(max_nan(bv[0], bv[1]), bv[2]);
}

__global__ void __launch_bounds__(kBlock)
setup_pack_kernel(const __grid_constant__ Pass p) {
  // the chunk's inputs, then its records
  __shared__ __align__(16) float stage[kStage];
  const int chunk = blockIdx.x;
  const Segment& g = p.seg[segment_of(p, chunk)];
  const int t0 = (chunk - g.first_chunk) * kBlock;
  const int rows = min(kBlock, g.T - t0);
  stage_inputs(g, t0, rows, stage);
  const int t = t0 + threadIdx.x;
  float x[3], y[3], z[3], w[3], col[4][3];
  if (threadIdx.x < rows) {
    if (!(g.mode & kStageClip)) {
      for (int k = 0; k < 3; ++k) {
        const float* q = g.clip + (long long)t * g.cs[0] +
                         (long long)k * g.cs[1];
        x[k] = __ldg(q);
        y[k] = __ldg(q + g.cs[2]);
        z[k] = __ldg(q + 2ll * g.cs[2]);
        w[k] = __ldg(q + 3ll * g.cs[2]);
      }
    }
    if (!(g.mode & kStageVary)) {
      for (int k = 0; k < 3; ++k) {
        const float* q = g.vary + (long long)t * g.vs[0] +
                         (long long)k * g.vs[1];
        for (int ch = 0; ch < 4; ++ch)
          col[ch][k] = __ldg(q + (long long)ch * g.vs[2]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();              // the chunk's staged rows have landed
  if (threadIdx.x < rows) {
    if (g.mode & kStageClip) {
      const float4* q = reinterpret_cast<const float4*>(stage) +
                        threadIdx.x * 3;
      for (int k = 0; k < 3; ++k) {
        const float4 e = q[k];
        x[k] = e.x;
        y[k] = e.y;
        z[k] = e.z;
        w[k] = e.w;
      }
    }
    if (g.mode & kStageVary) {
      const float4* q = reinterpret_cast<const float4*>(
                            stage + kBlock * kRow) + threadIdx.x * 3;
      for (int k = 0; k < 3; ++k) {
        const float4 e = q[k];
        col[0][k] = e.x;
        col[1][k] = e.y;
        col[2][k] = e.z;
        col[3][k] = e.w;
      }
    }
  }
  __syncthreads();              // inputs read: the records may overwrite them
  if (threadIdx.x < rows)
    setup_one(g, t, x, y, z, w, col, stage + threadIdx.x * kPad);
  __syncthreads();
  // the chunk's rows, 16 bytes a thread: consecutive threads store
  // consecutive bytes of the table
  float4* dst = reinterpret_cast<float4*>(
      g.packed + ((long long)g.row0 + t0) * kLanes);
  for (int i = threadIdx.x; i < rows * (kLanes / 4); i += kBlock) {
    const float* e = stage + (i / (kLanes / 4)) * kPad +
                     (i % (kLanes / 4)) * 4;
    dst[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

}  // namespace

extern "C" int setup_pack_segment_bytes() { return (int)sizeof(Segment); }

extern "C" int setup_pack_max_segments() { return kMaxSegments; }

// One launch over `count` segments (`segments`: Segment[count], 1 to
// kMaxSegments, at least one with T > 0) on `stream`, a block a chunk.
// Returns the launch's CUDA error (0 when it was accepted).
extern "C" int setup_pack_launch(const void* segments, int count,
                                 void* stream) {
  if (count < 1 || count > kMaxSegments) return (int)cudaErrorInvalidValue;
  const Segment* segs = static_cast<const Segment*>(segments);
  Pass p{};
  int chunks = 0;
  for (int i = 0; i < count; ++i) {
    p.seg[i] = segs[i];
    p.seg[i].first_chunk = chunks;
    chunks += (segs[i].T + kBlock - 1) / kBlock;
  }
  p.count = count;
  p.chunks = chunks;
  if (chunks == 0) return (int)cudaErrorInvalidValue;
  setup_pack_kernel<<<chunks, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
