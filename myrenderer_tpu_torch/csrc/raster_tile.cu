// K1: the tile rasterizer, CUDA C++ for Hopper (sm_90a).
//
// Replaces myrenderer_tpu/ops/raster_pallas.py::_raster_kernel, the
// Pallas kernel of the JAX package. Contract (same as the Pallas
// kernel's): for every pixel of a TILE_H x TILE_W framebuffer tile, find
// the front-most record among the records that binning gave the tile
// (a CSR segment of `index`, rows of `packed`, 32-float records laid out
// as in ops/raster_common.py), and write
//   fused[0] = depth, fused[1] = den plane, fused[2..5] = 4 num planes,
//   winner   = the record's id lane (-1 where nothing covers).
// The tiles may cover a band of a taller frame: pixel row y of the band
// is row y0 + y of the frame, and every coverage and depth test runs at
// the frame's pixel centres, so a band equals the same rows of the
// whole frame rendered at once. Outputs stay band-local.
// Coverage: three edge values against top-left thresholds, then
// z = zn / wn inside [zhi - 1, zhi]. Resolve: lexicographic min of
// (z, id) starting from (depth_in, -1), so equal depth goes to the
// lowest id whatever order the records arrive in.
//
// What bounds it on the card. Bytes: each referenced record once, the
// index, depth in, seven planes out (at the 4K stress frame about 400 MB,
// 0.12 ms at 3.35 TB/s). Operations: the (record, pixel) tests. The
// stress terrain's triangles cover a few pixels each, so nearly every
// test of a record against its whole tile is a rejection: a kernel that
// makes them all is bound by instruction issue, and one that skips them
// is bound by the latency of its per-record steps (loads, barriers,
// dependent arithmetic) at the occupancy its registers allow.
//
// Design, against that:
// - Records are fetched through `index` (binning writes 4 bytes per
//   (tile, record) pair, not a 128-byte copy of the record). Only lanes
//   0..15 (edges, depth planes, zhi: 64 bytes) are copied. The id (lane
//   16) is read from `packed` only at an exact depth tie and, with the
//   winner's varying planes, once in the epilogue.
// - One CTA of 4 warps per tile, in raster order. The tile is cut into
//   4 x 4 sub-blocks; warp w owns sub-block row w, and each lane 2
//   pixels of one row of one sub-block (b*py is paid once per lane and
//   record). The tiles' record counts are uneven (4K stress frame: mean
//   44, p99 679, max 1,135), but persistent CTAs taking tiles from a
//   counter, and other tile orders, measured slower on the H100.
// - Chunks of 128 records, one per thread, with one CTA barrier each.
//   Before it, each thread tests the record it copied against the 16
//   sub-blocks (the reject below) into a 16-bit mask; this overlaps the
//   slower warps' walk of the previous chunk. After it, every warp builds
//   the lists of its own 4 sub-blocks from the masks (a ballot and a
//   prefix count, in record order) and walks them without waiting for
//   the others. Per-chunk barriers make a tile cost the sum over chunks
//   of its slowest warp, and in the heavy tiles of the 4K stress frame
//   the warps' loads differ from chunk to chunk, so the fewer barriers,
//   the closer each warp runs to its own list length. Each lane walks
//   its sub-block's list two entries at a time (two independent test
//   chains), reading a record as 16-byte shared-memory loads.
// - Per-record constants once per record, not per pixel: the thread that
//   keeps a record for some sub-block writes its three top-left
//   thresholds and zhi - 1 after the copied lanes of its ring slot, and
//   the walk reads them as one more 16-byte load. With the registers
//   capped at 56, 9 CTAs stay resident on an SM.
// - The reject test. An edge's computed value at any pixel of a
//   sub-block is at most its value at the sub-block's centre plus
//   (|a| + |b|) * 1.5 (the exact function is linear) plus twice the
//   rounding error of one evaluation (at most
//   3 * 2^-24 * (|a|*X + |b|*Y + |c|), X the padded frame width and Y
//   the largest frame row the band evaluates, `ymax` = y0 plus the
//   band's padded height: a bound on every pixel and sub-block centre).
//   A sub-block is rejected when some edge's centre value is below minus
//   that extent and a margin of 2^-18 * (|a|*X + |b|*Y + |c|) + 2^-125,
//   so a rejected sub-block holds no pixel whose exact test passes: the
//   reject never changes a pixel. (Rejecting by the record's pixel
//   bounding box would not be safe: the tip of a thin triangle bounded
//   by rounded edge lines can cover a pixel centre outside its
//   vertices' box, and the reference tests every pixel of the tile.)
//   Records with zhi <= 0 are never listed.
// - A two-slot ring of chunks in shared memory: chunk c + 1 is copied
//   with cp.async while chunk c is walked. cp.async (16 bytes a thread,
//   commit_group / wait_group) rather than cp.async.bulk: the records
//   are scattered 64-byte pieces gathered through the index, which TMA's
//   tiled copies do not do; thread t loads record t's index and issues
//   its four copies, and one group per chunk needs no mbarrier phase.
// - Epilogue: the winner's id, den and four num planes from its record,
//   read through its row; the six planes and the winner written as
//   8-byte stores where the frame width allows.
//
// Numerics: the reference's numbers are XLA CPU's, which contracts
// a*x + b*y into fma(a, x, b*y). Every expression of the per-pixel test
// and of the planes spells that form with __fmaf_rn and is otherwise
// rounded per operation: the file is built with -fmad=false (no implicit
// contraction), never with --use_fast_math, and without flush-to-zero
// (the top-left threshold is the smallest normal float). The divide is
// the IEEE-rounded __fdiv_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;              // floats per packed record
constexpr int TILE_H = 16;
constexpr int TILE_W = 16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 4;                 // sub-blocks are SUB x SUB pixels
constexpr int PX = 2;                  // pixels per lane, in one row
constexpr int SUBS_X = TILE_W / SUB;
constexpr int SUBS = SUBS_X * (TILE_H / SUB);
constexpr int LANES_ROW = SUB / PX;    // lanes per sub-block row
constexpr int LANES_SUB = SUB * LANES_ROW;
constexpr int WARP_SUBS = 32 / LANES_SUB;
constexpr int CHUNK = THREADS;         // records per ring slot, one a thread
constexpr int SLOTS = 2;
constexpr int RAW = 16;                // lanes 0..15 copied
// a ring slot: the copied lanes, then the three thresholds and zhi - 1
constexpr int SLOT_W = RAW + 4;
constexpr float TL_EPS = 1.17549435e-38f;
// half extent of a sub-block's pixel centres
constexpr float HALF = 0.5f * (SUB - 1);
static_assert(SUBS * LANES_SUB == THREADS && WARP_SUBS * WARPS == SUBS,
              "each lane holds PX pixels of one row of one sub-block");
static_assert(WARP_SUBS == 4, "a warp counts the lists of 4 sub-blocks");
static_assert(SUBS <= 16, "a record's kept sub-blocks fit 16 bits");
static_assert(CHUNK <= 256, "lists hold byte indices");
static_assert(PX == 2, "load_run and store_run move float2");

// a*px + b*py + c in the reference's form fma(a, px, b*py) + c, with
// b*py given
__device__ __forceinline__ float plane_by(float a, float c, float px,
                                          float by) {
  return __fadd_rn(__fmaf_rn(a, px, by), c);
}

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return plane_by(a, c, px, __fmul_rn(b, py));
}

// a lane's PX = 2 pixels at p (8-byte aligned) in one load or store
__device__ __forceinline__ void load_run(const float* p, float (&v)[PX]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}

__device__ __forceinline__ void store_run(float* p, const float (&v)[PX]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ float threshold(float a, float b) {
  const bool top_left = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
  return top_left ? -TL_EPS : -0.0f;
}

// Below this value at a block's centre, the edge fails at every pixel
// of the block (see the header). Not part of the result's arithmetic.
__device__ __forceinline__ float reject_limit(float a, float b, float c,
                                              float xmax, float ymax) {
  const float aa = fabsf(a), ab = fabsf(b);
  const float ext = __fmul_rn(__fadd_rn(aa, ab), HALF);
  const float size = __fadd_rn(
      __fadd_rn(__fmul_rn(aa, xmax), __fmul_rn(ab, ymax)), fabsf(c));
  const float margin = __fmaf_rn(size, 0x1p-18f, 0x1p-125f);
  return -__fadd_rn(ext, margin);
}

// The record at `row` has a lower id than the one at `best` (-1: the
// incoming depth, id -1). Read only at exact depth ties.
__device__ __forceinline__ bool lower_id(const float* __restrict__ packed,
                                         int row, int best) {
  const int id = __float2int_rz(__ldg(packed + (int64_t)row * LANES + 16));
  const int best_id = best < 0
      ? -1 : __float2int_rz(__ldg(packed + (int64_t)best * LANES + 16));
  return id < best_id;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 9)
raster_tile_kernel(const float* __restrict__ packed,
                   const int* __restrict__ index,
                   const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const float* __restrict__ depth_in,
                   float* __restrict__ fused,
                   int* __restrict__ winner,
                   int height, int width, int y0, float xmax,
                   float ymax, int ntx, int nty, int vec) {
  __shared__ __align__(16) float raw[SLOTS][CHUNK][SLOT_W];
  __shared__ int srow[SLOTS][CHUNK];             // each record's packed row
  __shared__ unsigned char todo[SUBS][CHUNK];    // per sub-block, in order
  __shared__ unsigned short keeps[SLOTS][CHUNK];  // sub-blocks kept, per record

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tile = blockIdx.y * ntx + blockIdx.x;
  // this lane: PX pixels of one row of sub-block `sub`
  const int sub = tid / LANES_SUB;
  const int x0 = blockIdx.x * TILE_W + (sub % SUBS_X) * SUB +
                 (tid % LANES_ROW) * PX;
  const int y = blockIdx.y * TILE_H + (sub / SUBS_X) * SUB +
                (tid % LANES_SUB) / LANES_ROW;
  const bool row_in = y < height;
  const float py = __fadd_rn(__int2float_rn(y0 + y), 0.5f);
  float px[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) px[k] = __fadd_rn(__int2float_rn(x0 + k), 0.5f);

  const int64_t pix = (int64_t)y * width + x0;
  // the run is whole and aligned: vector loads and stores
  const bool vec_run = vec && row_in && (x0 + PX <= width);
  float best_z[PX];
  int best_row[PX];
  if (vec_run) {
    load_run(depth_in + pix, best_z);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k)
      best_z[k] = (row_in && x0 + k < width) ? depth_in[pix + k] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) best_row[k] = -1;

  const int start = starts[tile];
  const int n = counts[tile];
  const int nchunks = (n + CHUNK - 1) / CHUNK;

  // copy chunk c into its ring slot: thread t copies record t
  auto issue = [&](int c) {
    const int r = c * CHUNK + tid;
    if (r < n) {
      const int row = __ldg(index + start + r);
      srow[c % SLOTS][tid] = row;
      const float* src = packed + (int64_t)row * LANES;
      float* dst = raw[c % SLOTS][tid];
#pragma unroll
      for (int q = 0; q < RAW / 4; ++q) cp_async16(dst + 4 * q, src + 4 * q);
    }
    cp_async_commit();
  };

  const unsigned below = (1u << lane) - 1u;
  const int mine = lane / LANES_SUB;     // this lane's sub-block in the warp

  if (nchunks > 0) issue(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();        // this thread's copies of chunk c
    // thread t tests record t, its own copy, against the 16 sub-blocks
    // and stages its constants, while other warps may still walk c - 1
    {
      unsigned keep = 0;
      if (c * CHUNK + tid < n) {
        const float* q = raw[c % SLOTS][tid];
        if (q[15] > 0.0f) keep = (1u << SUBS) - 1u;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float a = q[3 * e], b = q[3 * e + 1], cc = q[3 * e + 2];
          const float lim = reject_limit(a, b, cc, xmax, ymax);
#pragma unroll
          for (int sb = 0; sb < SUBS; ++sb) {
            const float xc = __int2float_rn(blockIdx.x * TILE_W +
                                            (sb % SUBS_X) * SUB) + 0.5f * SUB;
            const float yc = __int2float_rn(y0 + blockIdx.y * TILE_H +
                                            (sb / SUBS_X) * SUB) + 0.5f * SUB;
            if (plane(a, b, cc, xc, yc) < lim) keep &= ~(1u << sb);
          }
        }
        if (keep) {
          *reinterpret_cast<float4*>(raw[c % SLOTS][tid] + RAW) = make_float4(
              threshold(q[0], q[1]), threshold(q[3], q[4]),
              threshold(q[6], q[7]), __fsub_rn(q[15], 1.0f));
        }
      }
      keeps[c % SLOTS][tid] = static_cast<unsigned short>(keep);
    }
    __syncthreads();            // everyone's; chunk c - 1's slot is free
    if (c + 1 < nchunks) issue(c + 1);
    const int m = min(CHUNK, n - c * CHUNK);
    const float (*slot)[SLOT_W] = raw[c % SLOTS];
    const int* rows = srow[c % SLOTS];
    // this warp's lists, from the kept sub-blocks of each record
    int cnt[WARP_SUBS] = {0, 0, 0, 0};
    for (int g = 0; g * 32 < m; ++g) {
      const int r = g * 32 + lane;
      const unsigned keep =
          r < m ? (keeps[c % SLOTS][r] >> (warp * WARP_SUBS)) & 0xfu : 0u;
#pragma unroll
      for (int j = 0; j < WARP_SUBS; ++j) {
        const bool k = (keep >> j) & 1u;
        const unsigned kept = __ballot_sync(0xffffffffu, k);
        if (k) todo[warp * WARP_SUBS + j][cnt[j] + __popc(kept & below)] = r;
        cnt[j] += __popc(kept);
      }
    }
    __syncwarp();
    const int nt = mine == 0 ? cnt[0] : mine == 1 ? cnt[1]
                 : mine == 2 ? cnt[2] : cnt[3];
    const int nmax = max(max(cnt[0], cnt[1]), max(cnt[2], cnt[3]));

    // the pixels of this lane that record r covers, as bits
    auto test = [&](int r) {
      const float4* q = reinterpret_cast<const float4*>(slot[r]);
      const float4 q0 = q[0], q1 = q[1], q2 = q[2], t = q[4];
      const float by0 = __fmul_rn(q0.y, py);
      const float by1 = __fmul_rn(q1.x, py);
      const float by2 = __fmul_rn(q1.w, py);
      unsigned cov = 0;
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const bool hit = (plane_by(q0.x, q0.z, px[k], by0) > t.x) &
                         (plane_by(q0.w, q1.y, px[k], by1) > t.y) &
                         (plane_by(q1.z, q2.x, px[k], by2) > t.z);
        cov |= static_cast<unsigned>(hit) << k;
      }
      return cov;
    };
    // depth test of record r at the covered pixels: lanes 9..11 (zn),
    // 12..14 (wn), 15 (zhi) and the staged zhi - 1
    auto resolve = [&](int r, unsigned cov) {
      const float4* q = reinterpret_cast<const float4*>(slot[r]);
      const float4 q2 = q[2], q3 = q[3];
      const float lo = q[4].w;
      const float bz = __fmul_rn(q2.z, py);
      const float bw = __fmul_rn(q3.y, py);
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        if (!((cov >> k) & 1u)) continue;
        const float z = __fdiv_rn(plane_by(q2.y, q2.w, px[k], bz),
                                  plane_by(q3.x, q3.z, px[k], bw));
        if (!((z >= lo) && (z <= q3.w))) continue;
        const int row = rows[r];
        if (z < best_z[k]) {
          best_z[k] = z;
          best_row[k] = row;
        } else if ((z == best_z[k]) && lower_id(packed, row, best_row[k])) {
          best_row[k] = row;
        }
      }
    };
    // two list entries an iteration; the warp runs as long as the
    // longest list of its sub-blocks
    const unsigned char* list = todo[sub];
    for (int i = 0; i < nmax; i += 2) {
      if (i >= nt) continue;
      const int r0 = list[i];
      const int r1 = list[min(i + 1, nt - 1)];
      const unsigned c0 = test(r0);
      const unsigned c1 = test(r1) & (i + 1 < nt ? ~0u : 0u);
      if (c0) resolve(r0, c0);
      if (c1) resolve(r1, c1);
    }
  }
  if (!row_in) return;

  int best_id[PX];
  float den[PX];
  float num[4][PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    best_id[k] = -1;
    den[k] = 1.0f;
    num[0][k] = num[1][k] = num[2][k] = num[3][k] = 0.0f;
    if (best_row[k] >= 0) {
      // lanes 16..31 of the winner, 16-byte aligned
      const float4* q = reinterpret_cast<const float4*>(
          packed + (int64_t)best_row[k] * LANES + 16);
      const float4 q4 = __ldg(q), q5 = __ldg(q + 1), q6 = __ldg(q + 2),
                   q7 = __ldg(q + 3);
      best_id[k] = __float2int_rz(q4.x);
      den[k] = plane(q4.y, q4.z, q4.w, px[k], py);
      num[0][k] = plane(q5.x, q5.y, q5.z, px[k], py);
      num[1][k] = plane(q5.w, q6.x, q6.y, px[k], py);
      num[2][k] = plane(q6.z, q6.w, q7.x, px[k], py);
      num[3][k] = plane(q7.y, q7.z, q7.w, px[k], py);
    }
  }
  const int64_t hw = (int64_t)height * width;
  if (vec_run) {
    float ids[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) ids[k] = __int_as_float(best_id[k]);
    store_run(fused + pix, best_z);
    store_run(fused + hw + pix, den);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) store_run(fused + (2 + ch) * hw + pix, num[ch]);
    store_run(reinterpret_cast<float*>(winner) + pix, ids);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      if (x0 + k >= width) continue;
      fused[pix + k] = best_z[k];
      fused[hw + pix + k] = den[k];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) fused[(2 + ch) * hw + pix + k] = num[ch][k];
      winner[pix + k] = best_id[k];
    }
  }
}

}  // namespace

extern "C" int raster_tile_tile_h() { return TILE_H; }
extern "C" int raster_tile_tile_w() { return TILE_W; }

// Launches K1 on `stream_handle` (a cudaStream_t) over a band of
// `height` rows whose first row is row `y0` of the frame; `ymax` bounds
// the frame rows the band evaluates (y0 plus its padded height).
// Allocates nothing and does not synchronise. Returns cudaGetLastError()
// after the launch.
extern "C" int raster_tile_launch(const float* packed, const int* index,
                                  const int* starts, const int* counts,
                                  const float* depth_in, float* fused,
                                  int* winner, int height, int width,
                                  int y0, int ymax, void* stream_handle) {
  const int ntx = (width + TILE_W - 1) / TILE_W;
  const int nty = (height + TILE_H - 1) / TILE_H;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(depth_in) |
                         reinterpret_cast<uintptr_t>(fused) |
                         reinterpret_cast<uintptr_t>(winner);
  const int vec = (width % PX == 0) && (ptrs % (4 * PX) == 0);
  if (ntx > 0 && nty > 0) {
    // the reject's bounds as float parameters (exact below 2^24): read
    // from the parameter bank, they take no register (converted in the
    // kernel, they cost a spill at the 56-register cap)
    raster_tile_kernel<<<dim3(ntx, nty), THREADS, 0,
                         static_cast<cudaStream_t>(stream_handle)>>>(
        packed, index, starts, counts, depth_in, fused, winner, height,
        width, y0, static_cast<float>(ntx * TILE_W),
        static_cast<float>(ymax), ntx, nty, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
