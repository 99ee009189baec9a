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
// What it computes. Instance i of I, triangle t of its 2 s2 (s2 = size^2):
// half = t / s2 (the first or the second triangle of quad q = t % s2), slots
// s = 3 half + k for its corners k = 0, 1, 2. Slot s has the corner (x, z)
// offsets QUAD_VALS[s] and reads the height at
// q + size * LOOKUP_ROW[s] + LOOKUP_COL[s], clamped to s2 - 1 (the
// reference's robust buffer access); here LOOKUP_ROW equals the x offset and
// LOOKUP_COL the z offset. Row i 2 s2 + t of clip and vary f32[2 I s2, 3, 4]
// and of ids i32[2 I s2] (id 2q + half + 2 s2 i).
//
// Rounding. Every value equals the plain version's bits. A height is read
// as the JAX package reads it: a subnormal one as a zero of its sign (XLA's
// CPU runtime flushes subnormal inputs, and a TPU has none). The composed
// matrix m = world @ data_xform is matmul4's FMA chain over k, made once a
// block in shared memory. Then, each one operation in the plain code's
// order:
//   x = fma(0.2, cx + float(q / size), -(0.1 * size)), z likewise with q % size
//   clip[ch] = fma(m[ch][2], z, fma(m[ch][0], x, (m[ch][1] * 5) * h)) + m[ch][3]
//   vary = (5 h, 5 h, 5 h, 1)
// The file is built with -fmad=false and without flushing subnormals.
//
// Bound: bytes. A triangle reads three heights (each height is read by about
// six triangles, so about 2 bytes a triangle from memory) and writes 48 bytes
// of clip positions, 48 of varyings and a 4-byte id; about 100 flops against
// ~102 bytes. So the design is about the stores. The rows are 48 bytes, and
// one thread storing its own rows as 16-byte pieces writes 16 of every 48
// bytes across a warp's span in each store instruction. Here a block walks
// chunks of kChunk triangles of one instance (persistent blocks, a few an
// SM, so m is made once a block): each thread computes one triangle into
// shared memory (the clip rows, and each vertex's 5 h), then the block
// stores the chunk's clip rows and varying rows as two contiguous spans,
// each lane a 16-byte piece beside its neighbour's (512 contiguous bytes a
// warp instruction); the ids, 4 bytes a triangle, are contiguous already.
// The staging is double-buffered: one barrier a chunk, and a chunk's stores
// are in flight while the next chunk's heights are read.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;   // triangles a chunk, one a thread

struct Args {
  const float* heights;  long long hs0, hs1;    // [I, s2]
  const float* uniforms; long long us0, us1;    // [I, >= 16]
  const float* worlds;   long long ws0, ws1, ws2;  // [I, 4, 4]
  int size, s2, chunks;                         // chunks an instance
  float4* clip;  float4* vary;  int* ids;
};

// a height as the JAX package reads it: a subnormal one is a signed zero
__device__ __forceinline__ float flush_subnormal(float h) {
  return fabsf(h) < FLT_MIN ? copysignf(0.0f, h) : h;
}

__global__ void __launch_bounds__(kChunk) terrain_vertex_kernel(const Args g) {
  // m = matmul4(world, data_xform): acc = a[r][0] * b[0][c], then
  // fma(a[r][k], b[k][c], acc) for k = 1, 2, 3; m1x5[r] = m[r][1] * 5
  __shared__ float m[16];
  __shared__ float m1x5[4];
  // two staging buffers: each vertex's clip row, and its 5 h
  __shared__ float4 s_clip[2][3 * kChunk];
  __shared__ float s_y[2][3 * kChunk];
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
  const int n_tri = 2 * g.s2;
  const float noff = -__fmul_rn(0.1f, (float)g.size);
  const float* hm = g.heights + inst * g.hs0;
  const long long row0 = (long long)inst * n_tri;
  int buf = 0;
  for (int chunk = blockIdx.x; chunk < g.chunks;
       chunk += gridDim.x, buf ^= 1) {
    const int t0 = chunk * kChunk;
    const int n = min(kChunk, n_tri - t0);
    float4* sc = s_clip[buf];
    float* sy = s_y[buf];
    if (threadIdx.x < n) {
      const int t = t0 + threadIdx.x;
      const int half = t >= g.s2;
      const int q = t - half * g.s2;
      const float qx = (float)(q / g.size), qz = (float)(q % g.size);
      for (int k = 0; k < 3; ++k) {
        // slots 0..5: (cx, cz) = (1,0) (0,0) (1,1) | (1,1) (0,0) (0,1)
        const int s = 3 * half + k;
        const int cx = (s == 0 || s == 2 || s == 3) ? 1 : 0;
        const int cz = (s == 2 || s == 3 || s == 5) ? 1 : 0;
        const float x = __fmaf_rn(0.2f, __fadd_rn((float)cx, qx), noff);
        const float z = __fmaf_rn(0.2f, __fadd_rn((float)cz, qz), noff);
        const int idx = min(q + g.size * cx + cz, g.s2 - 1);
        const float h = flush_subnormal(__ldg(hm + idx * g.hs1));
        float out[4];
        for (int ch = 0; ch < 4; ++ch)
          out[ch] = __fadd_rn(
              __fmaf_rn(m[4 * ch + 2], z,
                        __fmaf_rn(m[4 * ch], x, __fmul_rn(m1x5[ch], h))),
              m[4 * ch + 3]);
        sc[3 * threadIdx.x + k] = make_float4(out[0], out[1], out[2], out[3]);
        sy[3 * threadIdx.x + k] = __fmul_rn(5.0f, h);
      }
      g.ids[row0 + t] = 2 * q + half + n_tri * inst;
    }
    // the other buffer's reads (two chunks back) ended before the barrier
    // of the chunk between, so one barrier a chunk suffices
    __syncthreads();
    float4* clip = g.clip + 3 * (row0 + t0);
    float4* vary = g.vary + 3 * (row0 + t0);
    for (int j = threadIdx.x; j < 3 * n; j += kChunk) {
      clip[j] = sc[j];
      const float y = sy[j];
      vary[j] = make_float4(y, y, y, 1.0f);
    }
  }
}

}  // namespace

// One launch over the 2 * n_inst * size^2 triangles on ``stream``: a grid of
// (blocks an instance, n_inst), as many blocks as fit on the card at once
// shared over the instances, each walking its instance's chunks. Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int terrain_vertex_launch(
    const float* heights, long long hs0, long long hs1, const float* uniforms,
    long long us0, long long us1, const float* worlds, long long ws0,
    long long ws1, long long ws2, int n_inst, int size, float* clip,
    float* vary, int* ids, void* stream) {
  const int s2 = size * size;
  const int chunks = (2 * s2 + kChunk - 1) / kChunk;
  // blocks resident on the card at once, found at a device's first launch
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, terrain_vertex_kernel, kChunk, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * max(per_sm, 1);
  }
  const int per_inst =
      min(chunks, max(1, (resident[dev] + n_inst - 1) / n_inst));
  const Args g{heights, hs0, hs1, uniforms, us0, us1, worlds, ws0, ws1, ws2,
               size, s2, chunks, reinterpret_cast<float4*>(clip),
               reinterpret_cast<float4*>(vary), ids};
  terrain_vertex_kernel<<<dim3(per_inst, n_inst), kChunk, 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
