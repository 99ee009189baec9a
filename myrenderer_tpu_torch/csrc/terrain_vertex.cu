// K3: the terrain's whole-stream vertex shader, every triangle of a terrain
// batch in one launch (wrapper and plain version:
// myrenderer_tpu_torch/ops/terrain_vertex.py).
//
// What it replaces. The JAX package runs the terrain's whole-stream vertex
// function (myrenderer_tpu/content/terrain.py _make_vertex_batch_fn) inside
// its compiled frame, where XLA fuses it; it is no Pallas kernel. It is the
// reference's own vertex shader (Terrain/Terrain.zig:21-78). The port's
// plain version spells it as about 185 torch launches an instance over
// [size^2] vectors, then stacks and concatenates the slots three times.
//
// What it computes. Instance i (blockIdx.y) of I, triangle t of its 2 s2
// (s2 = size^2): half = t / s2 (the first or the second triangle of quad
// q = t % s2), slots s = 3 half + k for its corners k = 0, 1, 2. Slot s has
// the corner (x, z) offsets QUAD_VALS[s] and reads the height at
// q + size * LOOKUP_ROW[s] + LOOKUP_COL[s], clamped to s2 - 1 (the
// reference's robust buffer access); here LOOKUP_ROW equals the x offset and
// LOOKUP_COL the z offset. Row i 2 s2 + t of clip and vary f32[2 I s2, 3, 4]
// and of ids i32[2 I s2] (id 2q + half + 2 s2 i).
//
// Rounding. Every value equals the plain version's bits. The composed matrix
// m = world @ data_xform is matmul4's FMA chain over k, made once a block in
// shared memory. Then, each one operation in the plain code's order:
//   x = fma(0.2, cx + float(q / size), -(0.1 * size)), z likewise with q % size
//   clip[ch] = fma(m[ch][2], z, fma(m[ch][0], x, (m[ch][1] * 5) * h)) + m[ch][3]
//   vary = (5 h, 5 h, 5 h, 1)
// The file is built with -fmad=false and without flushing subnormals.
//
// Bound: bytes. A triangle reads three heights (each height is read by about
// six triangles, so about 2 bytes a triangle from memory) and writes 48 bytes
// of clip positions, 48 of varyings and a 4-byte id; about 100 flops against
// ~102 bytes. One thread a triangle, each of its three rows of clip and of
// vary one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct Args {
  const float* heights;  long long hs0, hs1;    // [I, s2]
  const float* uniforms; long long us0, us1;    // [I, >= 16]
  const float* worlds;   long long ws0, ws1, ws2;  // [I, 4, 4]
  int size, s2;
  float4* clip;  float4* vary;  int* ids;
};

__global__ void __launch_bounds__(kBlock) terrain_vertex_kernel(const Args g) {
  // m = matmul4(world, data_xform): acc = a[r][0] * b[0][c], then
  // fma(a[r][k], b[k][c], acc) for k = 1, 2, 3; m1x5[r] = m[r][1] * 5
  __shared__ float m[16];
  __shared__ float m1x5[4];
  const int inst = blockIdx.y;
  if (threadIdx.x < 16) {
    const int r = threadIdx.x / 4, c = threadIdx.x % 4;
    const float* a = g.worlds + inst * g.ws0 + r * g.ws1;
    const float* b = g.uniforms + inst * g.us0 + c * g.us1;
    float acc = __fmul_rn(__ldg(a), __ldg(b));
    for (int k = 1; k < 4; ++k)
      acc = __fmaf_rn(__ldg(a + k * g.ws2), __ldg(b + 4 * k * g.us1), acc);
    m[threadIdx.x] = acc;
    if (c == 1) m1x5[r] = __fmul_rn(acc, 5.0f);
  }
  __syncthreads();
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= 2 * g.s2) return;
  const int half = t >= g.s2;
  const int q = t - half * g.s2;
  const float qx = (float)(q / g.size), qz = (float)(q % g.size);
  const float noff = -__fmul_rn(0.1f, (float)g.size);
  const float* hm = g.heights + inst * g.hs0;
  const long long row = (long long)inst * 2 * g.s2 + t;
  float4* clip = g.clip + 3 * row;
  float4* vary = g.vary + 3 * row;
  for (int k = 0; k < 3; ++k) {
    // slots 0..5: (cx, cz) = (1,0) (0,0) (1,1) | (1,1) (0,0) (0,1)
    const int s = 3 * half + k;
    const int cx = (s == 0 || s == 2 || s == 3) ? 1 : 0;
    const int cz = (s == 2 || s == 3 || s == 5) ? 1 : 0;
    const float x = __fmaf_rn(0.2f, __fadd_rn((float)cx, qx), noff);
    const float z = __fmaf_rn(0.2f, __fadd_rn((float)cz, qz), noff);
    const int idx = min(q + g.size * cx + cz, g.s2 - 1);
    const float h = __ldg(hm + idx * g.hs1);
    float out[4];
    for (int ch = 0; ch < 4; ++ch)
      out[ch] = __fadd_rn(
          __fmaf_rn(m[4 * ch + 2], z,
                    __fmaf_rn(m[4 * ch], x, __fmul_rn(m1x5[ch], h))),
          m[4 * ch + 3]);
    const float y = __fmul_rn(5.0f, h);
    clip[k] = make_float4(out[0], out[1], out[2], out[3]);
    vary[k] = make_float4(y, y, y, 1.0f);
  }
  g.ids[row] = 2 * q + half + 2 * g.s2 * inst;
}

}  // namespace

// One launch over the 2 * n_inst * size^2 triangles on ``stream``; returns
// the launch's CUDA error (0 when it was accepted).
extern "C" int terrain_vertex_launch(
    const float* heights, long long hs0, long long hs1, const float* uniforms,
    long long us0, long long us1, const float* worlds, long long ws0,
    long long ws1, long long ws2, int n_inst, int size, float* clip,
    float* vary, int* ids, void* stream) {
  const int s2 = size * size;
  const Args g{heights, hs0, hs1, uniforms, us0, us1, worlds, ws0, ws1, ws2,
               size, s2, reinterpret_cast<float4*>(clip),
               reinterpret_cast<float4*>(vary), ids};
  const dim3 grid((2 * s2 + kBlock - 1) / kBlock, n_inst);
  terrain_vertex_kernel<<<grid, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
