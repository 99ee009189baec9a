// K2: clip + setup + pack of one batch of triangles, written into rows of
// the frame's record table (wrapper and plain version:
// myrenderer_tpu_torch/ops/setup_pack.py).
//
// What it replaces. The JAX package sets each batch up inside its
// compiled frame (myrenderer_tpu/renderer/draw.py _setup_batch, which runs
// myrenderer_tpu/ops/raster_common.py triangle_setup and pack_coeffs_full
// and myrenderer_tpu/ops/raster_pallas.py viewport_bbox); XLA fuses that
// code, it is no Pallas kernel. The port's plain version spells every
// rounding form as its own torch op: about 250 launches a call, then
// stacks and concatenations of the 32 lanes, of the batch and its
// appendee block, and of the batches of a pass.
//
// What it computes. For triangle t of [0, T): the 32 lanes of its record
// (edges a_k, b_k, c_k; the depth numerator and denominator planes; zhi;
// the id; the varying denominator plane; four varying numerator planes),
// its valid flag and its viewport box (min u, max u, min v, max v), into
// row row0 + t of packed f32[R, 32], valid u8[R] and box f32[4, R] (rows
// box_stride apart). Inputs are read through the strides given.
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
// ratio of flops to bytes. One thread a triangle. The records of a block
// are staged in shared memory (rows padded to 33 floats: no bank
// conflicts) and stored as whole rows by consecutive threads, 16 bytes a
// thread, so the 128-byte rows go out coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kLanes = 32;
constexpr int kPad = kLanes + 1;
constexpr float kWEps = 1e-6f;   // raster_common.W_EPS

struct Args {
  const float* clip;  long long cs0, cs1, cs2;   // [T, 3, 4]
  const float* vary;  long long vs0, vs1, vs2;   // [T, 3, 4]
  const uint8_t* valid;  long long valid_stride;
  const int* ids;  long long ids_stride;          // null: array rank
  int T, base;
  float W, H;
  int cull;     // 0 back, 1 front, 2 none
  int forms;    // bit 3 * plane + column: that column's form (0 or 1);
                // planes 0 depth numerator, 1 depth denominator, 2 varyings
  int biased;
  float bias;
  float* packed;  uint8_t* out_valid;  float* box;
  long long box_stride, row0;
};

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

__global__ void __launch_bounds__(kBlock) setup_pack_kernel(const Args g) {
  __shared__ float rec[kBlock * kPad];
  const int t0 = blockIdx.x * kBlock;
  const int t = t0 + threadIdx.x;
  if (t < g.T) {
    float x[3], y[3], z[3], w[3], col[4][3];
    for (int k = 0; k < 3; ++k) {
      const float* p = g.clip + t * g.cs0 + k * g.cs1;
      x[k] = __ldg(p);
      y[k] = __ldg(p + g.cs2);
      z[k] = __ldg(p + 2 * g.cs2);
      w[k] = __ldg(p + 3 * g.cs2);
      const float* q = g.vary + t * g.vs0 + k * g.vs1;
      for (int ch = 0; ch < 4; ++ch) col[ch][k] = __ldg(q + ch * g.vs2);
    }
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
    if (g.cull == 0) {
      facing = det > 0.f;
    } else {
      // front: times -1; none: times torch.sign(det), (0 < d) - (d < 0)
      float sign;
      if (g.cull == 1) {
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
    const bool ok = __ldg(g.valid + t * g.valid_stride) != 0 && facing &&
                    w[0] > kWEps && w[1] > kWEps && w[2] > kWEps;
    float zhi = ok ? 1.f : 0.f;
    if (g.biased) {
      for (int k = 0; k < 3; ++k) z[k] = __fmaf_rn(g.bias, w[k], z[k]);
      zhi = ok ? __fadd_rn(g.bias, 1.f) : 0.f;
    }
    float* r = rec + threadIdx.x * kPad;
    for (int k = 0; k < 3; ++k) {
      r[3 * k] = a[k];
      r[3 * k + 1] = b[k];
      r[3 * k + 2] = c[k];
    }
    r[9] = dot3(a, z, g.forms & 1);
    r[10] = dot3(b, z, (g.forms >> 1) & 1);
    r[11] = dot3(c, z, (g.forms >> 2) & 1);
    r[12] = dot3(a, w, (g.forms >> 3) & 1);
    r[13] = dot3(b, w, (g.forms >> 4) & 1);
    r[14] = dot3(c, w, (g.forms >> 5) & 1);
    r[15] = zhi;
    const int rank = g.ids ? __ldg(g.ids + t * g.ids_stride) : t;
    r[16] = __fadd_rn(__int2float_rn(rank), __int2float_rn(g.base));
    // the varying denominator plane: sum of the edges, left to right
    r[17] = __fadd_rn(__fadd_rn(a[0], a[1]), a[2]);
    r[18] = __fadd_rn(__fadd_rn(b[0], b[1]), b[2]);
    r[19] = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
    for (int ch = 0; ch < 4; ++ch) {
      r[20 + 3 * ch] = dot3(a, col[ch], (g.forms >> 6) & 1);
      r[21 + 3 * ch] = dot3(b, col[ch], (g.forms >> 7) & 1);
      r[22 + 3 * ch] = dot3(c, col[ch], (g.forms >> 8) & 1);
    }
    g.out_valid[g.row0 + t] = ok ? 1 : 0;
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
    float* bx = g.box + g.row0 + t;
    bx[0] = min_nan(min_nan(bu[0], bu[1]), bu[2]);
    bx[g.box_stride] = max_nan(max_nan(bu[0], bu[1]), bu[2]);
    bx[2 * g.box_stride] = min_nan(min_nan(bv[0], bv[1]), bv[2]);
    bx[3 * g.box_stride] = max_nan(max_nan(bv[0], bv[1]), bv[2]);
  }
  __syncthreads();
  // the block's rows, 16 bytes a thread: consecutive threads store
  // consecutive bytes of the table
  const int rows = min(kBlock, g.T - t0);
  float4* dst = reinterpret_cast<float4*>(g.packed + (g.row0 + t0) * kLanes);
  for (int i = threadIdx.x; i < rows * (kLanes / 4); i += kBlock) {
    const float* s = rec + (i / (kLanes / 4)) * kPad + (i % (kLanes / 4)) * 4;
    dst[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
}

}  // namespace

// One launch over T > 0 triangles on ``stream``; returns the launch's CUDA
// error (0 when it was accepted).
extern "C" int setup_pack_launch(
    const float* clip, long long cs0, long long cs1, long long cs2,
    const float* vary, long long vs0, long long vs1, long long vs2,
    const uint8_t* valid, long long valid_stride, const int* ids,
    long long ids_stride, int T, int base, int width, int height, int cull,
    int forms, int biased, float bias, float* packed, uint8_t* out_valid,
    float* box, long long box_stride, long long row0, void* stream) {
  const Args g{clip, cs0, cs1, cs2, vary, vs0, vs1, vs2, valid, valid_stride,
               ids, ids_stride, T, base, (float)width, (float)height, cull,
               forms, biased, bias, packed, out_valid, box, box_stride, row0};
  setup_pack_kernel<<<(T + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
