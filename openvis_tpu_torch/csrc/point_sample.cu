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
// 50 MB L2. K5's design:
//   * maps stay in their (B, R, H, W) layout, as the model produces them and
//     as their gradient is wanted, so neither kernel needs a transpose;
//   * one thread per (b, r, p) with the point fastest: the point reads and
//     the output writes are coalesced, and the y-sorted points of a warp fall
//     in a narrow band of rows;
//   * coordinates (p * size - 0.5, rounded as two operations like the plain
//     version), weights and sums are f32, whatever the maps' dtype: bf16 maps
//     are read and widened exactly, which is the JAX package's f32 sampling
//     policy (f32_tents).
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

#include "scatter_common.cuh"

namespace {

using scatter::kThreads;
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

template <typename M>
__global__ void __launch_bounds__(kThreads) point_sample_fwd_kernel(
    const M* __restrict__ maps,        // (B, R, H, W)
    const float* __restrict__ coords,  // (B, P, 2) normalized (x, y)
    float* __restrict__ out,           // (B, R, P)
    int64_t total, int rows, int H, int W, int P) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int p = (int)(idx % P);
  const int64_t br = idx / P;  // b * rows + r
  const int64_t b = br / rows;
  const float* cp = coords + (b * P + p) * 2;
  const float x = __fsub_rn(__fmul_rn(cp[0], (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(cp[1], (float)H), 0.5f);
  float s = 0.f;
  if (x > -1.f && y > -1.f && x < (float)W && y < (float)H) {
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const float fx = x - x0f;
    const float fy = y - y0f;
    const float gx = 1.f - fx;
    const float gy = 1.f - fy;
    const M* m = maps + br * H * W;
    if (y0 >= 0) {
      const M* r = m + (int64_t)y0 * W;
      if (x0 >= 0) s += to_f32(r[x0]) * (gy * gx);
      if (x0 + 1 < W) s += to_f32(r[x0 + 1]) * (gy * fx);
    }
    if (y0 + 1 < H) {
      const M* r = m + (int64_t)(y0 + 1) * W;
      if (x0 >= 0) s += to_f32(r[x0]) * (fy * gx);
      if (x0 + 1 < W) s += to_f32(r[x0 + 1]) * (fy * fx);
    }
  }
  out[idx] = s;
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

unsigned blocks_for(int64_t total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace

// map_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int point_sample_fwd(const void* maps, const void* coords, void* out,
                                int map_dtype, int batch, int rows, int height,
                                int width, int n_points, void* stream) {
  const int64_t total = (int64_t)batch * rows * n_points;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (map_dtype == 0) {
    point_sample_fwd_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(maps), c, o, total, rows, height, width, n_points);
  } else if (map_dtype == 1) {
    point_sample_fwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(maps), c, o, total, rows, height, width, n_points);
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
  // above 48 KB of shared memory, static and dynamic together, a kernel
  // must opt in: once, to the most a plan may ask
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        point_sample_dvalue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)batch);
  point_sample_dvalue_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(grad),
      static_cast<float*>(dmaps), rows, height, width, n_points, tile_points, row_chunk,
      band_pixels);
  return (int)cudaGetLastError();
}
