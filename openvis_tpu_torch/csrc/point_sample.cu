// Shared-point bilinear sampler of the criterion for Hopper (sm_90a):
//   K5 (point_sample_fwd): samples of R maps at P points shared by the rows of
//       one batch item;
//   K6 (point_sample_dvalue): the gradient of K5 with respect to the maps.
//
// Replaces: openvis_tpu/ops/point_sample_pallas.py::_ps_fwd (body _fwd_kernel)
// and _ps_bwd (body _dvalue_kernel). On the TPU gathers serialize, so those
// kernels sort the points by y, build bilinear tent weights for a window of
// map rows and contract them with the rows on the MXU (a 3-pass split f32
// dot); the dValue kernel is output-stationary, walking the point blocks that
// touch one block of map rows. A GPU gathers natively, so K5 is the plain
// 4-corner gather and K6 its transpose, a 4-corner scatter.
//
// What bounds them on this card: memory traffic. A sample reads 4 map values
// (or adds into 4) and spends about 10 flops, far below the H100's flop/byte
// ridge; the maps of one criterion call (at most ~21 MB in f32) fit in the
// 50 MB L2, and K5's f32 output (10-12 MB per call on the train path) is
// most of the bytes it must move. K5's design:
//   * maps stay in their (B, R, H, W) layout, as the model produces them and
//     as their gradient is wanted, so neither kernel needs a transpose;
//   * a 3-D grid (point tiles, row chunks, b) of kFwdThreads-thread blocks:
//     no integer division in the kernel, and each grid dimension within its
//     limit (the plan, ops/point_sample_cuda.py::fwd_plan, picks the chunk;
//     this side refuses a plan that would overrun the grid);
//   * a thread takes V consecutive points (V = 2 where P allows 8-byte
//     stores) and computes each point's four corner offsets and weights once,
//     as the plain version's _corners does: coordinates p * size - 0.5
//     rounded as two operations, a corner outside the map gets weight 0 and a
//     clamped offset, so every corner is a load and no branch depends on the
//     point;
//   * then it walks its chunk's rows, kFwdRowUnroll at a time: all their
//     gathers are issued before the first sum, so a thread has up to
//     kFwdRowUnroll x V x 4 loads in flight (more rows or points per thread
//     measured slower: the registers they take cost more occupancy than their
//     loads in flight gain); per row and point the four products are summed in the
//     plain version's order (0,0), (0,1), (1,0), (1,1) without fused
//     multiply-adds, so the result is the plain version's bit for bit; each
//     row's V samples are one coalesced store;
//   * bf16 maps are read and widened exactly, sums are f32: the JAX package's
//     f32 sampling policy (f32_tents).
// K6 as one f32 atomic per (b, r, p, corner) into L2 is paced by L2 atomic
// throughput, with the 32 lanes of a warp on ~32 scattered addresses, and
// every row recomputes the coordinates of the same points. K6's design is a
// scatter privatised in shared memory, the GPU's counterpart of the TPU's
// output-stationary walk:
//   * one block per tile: (b, tile_points consecutive points, row_chunk
//     rows); each point's corner offsets and four weights are computed once,
//     into shared memory, and serve all the tile's rows, whose gradients are
//     staged in shared memory with coalesced loads;
//   * the band: from the tile's least and greatest corner row (a block
//     reduction) the tile touches map rows [lo, hi]. If those rows' pixels
//     fit the plan's band_pixels, the tile's corner adds are binned by band
//     pixel in shared memory (scatter_common.cuh: int atomics, which sm_90
//     has natively, unlike shared f32 atomics), once for all its rows; then
//     a thread takes 4 consecutive band pixels, walks each pixel's binned
//     adds once, summing all the chunk's rows in registers, and adds each
//     row's 4 sums to the f32 scratch as one 16-byte reduction
//     (red.global.add.v4.f32), one value at a time at a row's unaligned
//     ends. Otherwise it adds straight to the scratch, one f32 atomic per
//     corner;
//   * the criterion draws its points sorted by y (sorted_uniform_points), so
//     a tile of ~P/H points spans ~1 row, a band of ~3, and takes the bins. Nothing
//     depends on the order: unsorted points make a band as tall as the map,
//     which does not fit, and take the direct adds;
//   * the plan (tile_points, row_chunk, band_pixels) is made by
//     ops/point_sample_cuda.py::dvalue_plan; this side refuses a plan that
//     would overrun shared memory or the grid.
// K6 adds into an f32 scratch that the caller zeroed, in an order that changes
// from run to run; the caller casts to the maps' dtype.
//
// Semantics: grid_sample(align_corners=False, padding_mode="zeros"), output
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "opt_in.cuh"
#include "scatter_common.cuh"

namespace {

using scatter::kThreads;
// K5's plan limits, as in ops/point_sample_cuda.py
constexpr int kFwdThreads = 128;
constexpr int kFwdRowUnroll = 2;   // rows whose gathers are in flight together
constexpr int kMaxGridYZ = 65535;
// K6's plan limits, as in ops/point_sample_cuda.py
constexpr int kMaxTilePoints = 1024;
constexpr int kTableBytes = 32;    // per point: four corner offsets, four weights
constexpr int kListBytes = 16;     // per point: four binned-list entries
constexpr int kMaxRowChunk = 8;    // rows a block takes, summed in registers
// dynamic shared memory a block may use on sm_90 (227 KB), less 1 KB for the
// kernel's static shared variables
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the point's four corners (0,0), (0,1), (1,0), (1,1): offsets in the map,
// clamped into it, and bilinear weights, 0 for a corner outside
__device__ __forceinline__ void corners(float cx, float cy, int H, int W, int (&off)[4],
                                        float (&wt)[4]) {
  const float x = __fsub_rn(__fmul_rn(cx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(cy, (float)H), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f);
  const float fy = __fsub_rn(y, y0f);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  // the floors clamped to [-2, size] before the conversion: every corner of
  // such a point is outside, as it is of the true floor, and the +1 below
  // cannot overflow for a coordinate beyond 2^31 pixels or an infinite one
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const bool in_x0 = x0 >= 0 && x0 < W, in_x1 = x0 >= -1 && x0 < W - 1;
  const bool in_y0 = y0 >= 0 && y0 < H, in_y1 = y0 >= -1 && y0 < H - 1;
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x0, -1) + 1, W - 1);
  const int ry0 = min(max(y0, 0), H - 1) * W, ry1 = min(max(y0, -1) + 1, H - 1) * W;
  off[0] = ry0 + cx0;
  off[1] = ry0 + cx1;
  off[2] = ry1 + cx0;
  off[3] = ry1 + cx1;
  wt[0] = in_y0 && in_x0 ? __fmul_rn(gy, gx) : 0.f;
  wt[1] = in_y0 && in_x1 ? __fmul_rn(gy, fx) : 0.f;
  wt[2] = in_y1 && in_x0 ? __fmul_rn(fy, gx) : 0.f;
  wt[3] = in_y1 && in_x1 ? __fmul_rn(fy, fx) : 0.f;
}

// K5: block (point tile, row chunk, b); thread: V consecutive points of the
// tile, for the chunk's rows.
template <typename M, int V>
__global__ void __launch_bounds__(kFwdThreads) point_sample_fwd_kernel(
    const M* __restrict__ maps,        // (B, R, H, W)
    const float* __restrict__ coords,  // (B, P, 2) normalized (x, y)
    float* __restrict__ out,           // (B, R, P)
    int rows, int H, int W, int P, int row_chunk) {
  const int p0 = (blockIdx.x * kFwdThreads + threadIdx.x) * V;
  if (p0 >= P) return;  // P is a multiple of V
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * row_chunk;
  const int nr = min(row_chunk, rows - r0);

  int off[V][4];
  float wt[V][4];
  const float* cp = coords + ((int64_t)b * P + p0) * 2;
  float xy[2 * V];
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const float4 t = reinterpret_cast<const float4*>(cp)[q];
      xy[4 * q] = t.x;
      xy[4 * q + 1] = t.y;
      xy[4 * q + 2] = t.z;
      xy[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2 * V; ++q) xy[q] = cp[q];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) corners(xy[2 * v], xy[2 * v + 1], H, W, off[v], wt[v]);

  const int64_t hw = (int64_t)H * W;
  const M* m = maps + ((int64_t)b * rows + r0) * hw;
  float* o = out + ((int64_t)b * rows + r0) * P + p0;
  for (int r = 0; r < nr; r += kFwdRowUnroll) {
    float val[kFwdRowUnroll][V][4];
#pragma unroll
    for (int u = 0; u < kFwdRowUnroll; ++u) {
      if (r + u < nr) {
        const M* mr = m + u * hw;
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int c = 0; c < 4; ++c) val[u][v][c] = to_f32(mr[off[v][c]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdRowUnroll; ++u) {
      if (r + u < nr) {
        float s[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s[v] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(val[u][v][0], wt[v][0]),
                                               __fmul_rn(val[u][v][1], wt[v][1])),
                                     __fmul_rn(val[u][v][2], wt[v][2])),
                           __fmul_rn(val[u][v][3], wt[v][3]));
        }
        float* ou = o + (int64_t)u * P;
        if constexpr (V == 2) {
          *reinterpret_cast<float2*>(ou) = make_float2(s[0], s[1]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) ou[v] = s[v];
        }
      }
    }
    m += kFwdRowUnroll * hw;
    o += (int64_t)kFwdRowUnroll * P;
  }
}

// K6: one block per (point tile, row chunk, b). Dynamic shared memory: the
// tile's table (int4 corner offsets, then float4 weights), the binned list
// (4 ints per point), the chunk's gradient rows (row_chunk x tile_points
// floats), then the band's bins (band_pixels + 1 list offsets and
// band_pixels cursors).
__global__ void __launch_bounds__(kThreads) point_sample_dvalue_kernel(
    const float* __restrict__ coords,  // (B, P, 2)
    const float* __restrict__ grad,    // (B, R, P)
    float* __restrict__ dmaps,         // (B, R, H, W), zeroed
    int rows, int H, int W, int P, int tile_points, int row_chunk, int band_pixels) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_off = reinterpret_cast<int4*>(smem);
  float4* s_w = reinterpret_cast<float4*>(smem + (size_t)tile_points * 16);
  int* s_list = reinterpret_cast<int*>(smem + (size_t)tile_points * kTableBytes);
  float* s_g = reinterpret_cast<float*>(s_list + 4 * tile_points);
  int* s_beg = reinterpret_cast<int*>(s_g + row_chunk * tile_points);
  int* s_cur = s_beg + band_pixels + 1;
  __shared__ int s_lo, s_hi, s_warp[kThreads / 32];

  const int b = blockIdx.z;
  const int p0 = blockIdx.x * tile_points;
  const int np = min(tile_points, P - p0);
  const int r0 = blockIdx.y * row_chunk;
  const int nr = min(row_chunk, rows - r0);
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();

  // each point of the tile once: its corners (offset in the map, -1 for a
  // corner outside) and weights, and the rows its corners touch
  int lo = INT_MAX, hi = -1;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const float* cp = coords + ((int64_t)b * P + p0 + i) * 2;
    const float x = __fsub_rn(__fmul_rn(cp[0], (float)W), 0.5f);
    const float y = __fsub_rn(__fmul_rn(cp[1], (float)H), 0.5f);
    int4 off = make_int4(-1, -1, -1, -1);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (x > -1.f && y > -1.f && x < (float)W && y < (float)H) {
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float fx = x - x0f;
      const float fy = y - y0f;
      const float gx = 1.f - fx;
      const float gy = 1.f - fy;
      const int base = y0 * W + x0;
      if (y0 >= 0) {
        if (x0 >= 0) off.x = base;
        if (x0 + 1 < W) off.y = base + 1;
      }
      if (y0 + 1 < H) {
        if (x0 >= 0) off.z = base + W;
        if (x0 + 1 < W) off.w = base + W + 1;
      }
      w = make_float4(gy * gx, gy * fx, fy * gx, fy * fx);
      lo = min(lo, max(y0, 0));
      hi = max(hi, min(y0 + 1, H - 1));
    }
    s_off[i] = off;
    s_w[i] = w;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;
  hi = s_hi;
  if (hi < lo) return;  // no point of the tile has a corner inside

  const int64_t map = (int64_t)H * W;
  const float* gb = grad + ((int64_t)b * rows + r0) * P + p0;
  float* db = dmaps + ((int64_t)b * rows + r0) * map;
  const int shift = lo * W;
  const int n_pix = (hi - lo + 1) * W;  // the band: map rows lo .. hi
  if (n_pix <= band_pixels) {
    for (int r = 0; r < nr; ++r)  // the chunk's gradient rows, coalesced
      for (int i = threadIdx.x; i < np; i += kThreads) s_g[r * tile_points + i] = gb[(int64_t)r * P + i];
    // entry e = 4 * point + corner; its pixel in the band
    const int* off = reinterpret_cast<const int*>(s_off);
    const float* wt = reinterpret_cast<const float*>(s_w);
    scatter::bin_entries(
        4 * np, n_pix, [&](int e) { return off[e] >= 0 ? off[e] - shift : -1; },
        [](int e) { return e; }, s_beg, s_cur, s_list, s_warp);
    // A thread takes 4 consecutive band pixels (a quad aligned to 16 bytes
    // in row 0 of the chunk; the first one is the run up to that alignment),
    // walks each pixel's adds once for all the chunk's rows, and adds each
    // row's quad as one 16-byte reduction where it is aligned (the rows of
    // maps whose H x W is a multiple of 4 all are), one value at a time
    // elsewhere.
    const int head = (4 - (int)((reinterpret_cast<uintptr_t>(db + shift) >> 2) & 3)) & 3;
    const int n_quads = 1 + (n_pix - head + 3) / 4;
    for (int q = threadIdx.x; q < n_quads; q += kThreads) {
      const int a = q == 0 ? 0 : head + 4 * (q - 1);
      const int z = q == 0 ? min(head, n_pix) : min(a + 4, n_pix);
      if (a >= z || s_beg[a] == s_beg[z]) continue;  // no adds land here
      float v[4][kMaxRowChunk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < kMaxRowChunk; ++r) v[j][r] = 0.f;
        if (a + j < z) {
          for (int t = s_beg[a + j]; t < s_beg[a + j + 1]; ++t) {
            const int e = s_list[t];
            const float w = wt[e];
            const float* g = s_g + (e >> 2);
#pragma unroll
            for (int r = 0; r < kMaxRowChunk; ++r)
              if (r < nr) v[j][r] += g[r * tile_points] * w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRowChunk; ++r) {
        if (r >= nr) break;
        float* out = db + r * map + shift + a;
        if (q > 0 && z - a == 4 && ((r * map) & 3) == 0) {
          scatter::red_add_v4(out, make_float4(v[0][r], v[1][r], v[2][r], v[3][r]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (a + j < z && s_beg[a + j] != s_beg[a + j + 1]) atomicAdd(out + j, v[j][r]);
        }
      }
    }
  } else {
    for (int r = 0; r < nr; ++r) {
      float* m = db + r * map;
      for (int i = threadIdx.x; i < np; i += kThreads) {
        const float g = gb[(int64_t)r * P + i];
        const int4 o = s_off[i];
        const float4 w = s_w[i];
        if (o.x >= 0) atomicAdd(m + o.x, g * w.x);
        if (o.y >= 0) atomicAdd(m + o.y, g * w.y);
        if (o.z >= 0) atomicAdd(m + o.z, g * w.z);
        if (o.w >= 0) atomicAdd(m + o.w, g * w.w);
      }
    }
  }
}

template <typename M, int V>
void launch_fwd(const void* maps, const void* coords, void* out, int batch, int rows,
                int height, int width, int n_points, int row_chunk, cudaStream_t s) {
  const dim3 grid((unsigned)((n_points + kFwdThreads * V - 1) / (kFwdThreads * V)),
                  (unsigned)((rows + row_chunk - 1) / row_chunk), (unsigned)batch);
  point_sample_fwd_kernel<M, V><<<grid, kFwdThreads, 0, s>>>(
      static_cast<const M*>(maps), static_cast<const float*>(coords), static_cast<float*>(out),
      rows, height, width, n_points, row_chunk);
}

}  // namespace

// map_dtype: 0 = float32, 1 = bfloat16.  vec (points per thread, 1 or 2) and
// row_chunk come from fwd_plan (ops/point_sample_cuda.py).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// that would overrun the grid, int32 offsets within a map, or the alignment
// of 16-byte point loads and 8-byte stores.
extern "C" int point_sample_fwd(const void* maps, const void* coords, void* out,
                                int map_dtype, int batch, int rows, int height,
                                int width, int n_points, int vec, int row_chunk,
                                void* stream) {
  if ((int64_t)batch * rows * n_points == 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(coords) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if ((vec != 1 && vec != 2) || (vec == 2 && (n_points % 2 != 0 || !aligned)) ||
      row_chunk < 1 || ((int64_t)rows + row_chunk - 1) / row_chunk > kMaxGridYZ ||
      batch > kMaxGridYZ || height < 1 || width < 1 || (int64_t)height * width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_dtype == 0 && vec == 2) {
    launch_fwd<float, 2>(maps, coords, out, batch, rows, height, width, n_points, row_chunk, s);
  } else if (map_dtype == 0) {
    launch_fwd<float, 1>(maps, coords, out, batch, rows, height, width, n_points, row_chunk, s);
  } else if (map_dtype == 1 && vec == 2) {
    launch_fwd<__nv_bfloat16, 2>(maps, coords, out, batch, rows, height, width, n_points,
                                 row_chunk, s);
  } else if (map_dtype == 1) {
    launch_fwd<__nv_bfloat16, 1>(maps, coords, out, batch, rows, height, width, n_points,
                                 row_chunk, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dmaps is an f32 (B, R, H, W) buffer the caller zeroed, 16-byte aligned.
// tile_points, row_chunk and band_pixels come from dvalue_plan
// (ops/point_sample_cuda.py).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a plan that would overrun shared memory, the
// grid or int32 offsets within a map.
extern "C" int point_sample_dvalue(const void* coords, const void* grad,
                                   void* dmaps, int batch, int rows, int height,
                                   int width, int n_points, int tile_points,
                                   int row_chunk, int band_pixels, void* stream) {
  if ((int64_t)batch * rows * n_points == 0) return 0;
  const int64_t smem = (int64_t)tile_points * (kTableBytes + kListBytes + 4 * row_chunk) +
                       4 * (2 * (int64_t)band_pixels + 1);
  const int64_t tiles = ((int64_t)n_points + tile_points - 1) / tile_points;
  const int64_t chunks = ((int64_t)rows + row_chunk - 1) / row_chunk;
  if (tile_points < 1 || tile_points > kMaxTilePoints || row_chunk < 1 ||
      row_chunk > kMaxRowChunk || band_pixels < 0 ||
      smem > kMaxSmem || chunks > 65535 || batch > 65535 ||
      (int64_t)height * width + width > INT_MAX ||
      (reinterpret_cast<uintptr_t>(dmaps) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  static bool opted_in[kMaxOptInDevices] = {};
  const cudaError_t err = opt_in_shared_memory(point_sample_dvalue_kernel, kMaxSmem, opted_in);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)batch);
  point_sample_dvalue_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(grad),
      static_cast<float*>(dmaps), rows, height, width, n_points, tile_points, row_chunk,
      band_pixels);
  return (int)cudaGetLastError();
}
