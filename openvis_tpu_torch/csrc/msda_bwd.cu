// Multi-scale deformable attention backward for Hopper (sm_90a):
//   K2 (msda_bwd_dcoord): gradients of the sampling locations and of the
//       attention weights;
//   K3 (msda_bwd_dvalue): gradient of the value maps.
//
// Replaces: openvis_tpu/ops/msda_pallas.py::_msda_bwd_fused, whose two
// pallas_calls are the fused all-level dCoord kernel (_fused_dcoord_rr_kernel)
// and the per-level dValue kernel (_dvalue_kernel_v2). On the TPU both are
// implicit matmuls over bilinear "tent" tables, with y-striped queries and
// packed rows, because gathers and scatters serialize there. A GPU gathers
// natively and has atomics, so these are the gather/scatter form of the
// reference CUDA op (ms_deformable_col2im), split in two kernels so that each
// has one job and its own launch count.
//
// What bounds them on this card: memory traffic and, for K3, atomic
// throughput. Per sample each kernel reads 4 value corners (K2) or adds into 4
// (K3) and spends a handful of flops on each, far below the H100's flop/byte
// ridge. Design against that:
//   * the K1 layout: channels fastest, so the lanes of a warp touch one
//     contiguous row of `channels` values per corner (coalesced reads in K2,
//     coalesced f32 atomic adds in K3);
//   * K2: one warp per (b, q, head), lanes striding the channels; the three
//     per-sample sums (dattn, dx, dy) are warp shuffle reductions, and lane 0
//     writes them; every branch on a sampling point is warp-uniform;
//   * K3: one thread per (b, q, head, channel); the gradient adds go into an
//     f32 scratch (zeroed by the caller) with atomicAdd, so the summation
//     order changes from run to run; the caller casts to the value's dtype;
//   * coordinates, bilinear weights and every sum are f32; the pixel
//     coordinate loc * size - 0.5 is rounded as two operations (no fused
//     multiply-add), as in the plain version, so a point exactly on a pixel
//     centre (where the encoder's ring-bias init puts every sample) takes the
//     same one-sided slope as there.
//
// Semantics: the gradient of the 4-corner gather form of
// grid_sample(align_corners=False, padding_mode="zeros"): a corner outside
// the map contributes nothing, and d(pixel)/d(loc) is the level's width (x) or
// height (y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K2: grid of warps, one per (b, q, head).
template <typename V, typename A>
__global__ void __launch_bounds__(kThreads) msda_dcoord_kernel(
    const V* __restrict__ value,    // (B, len_in, n_heads, channels)
    const float* __restrict__ loc,  // (B, len_q, n_heads, n_levels, n_points, 2)
    const A* __restrict__ attn,     // (B, len_q, n_heads, n_levels, n_points)
    const V* __restrict__ grad,     // (B, len_q, n_heads * channels)
    float* __restrict__ dloc,       // like loc
    A* __restrict__ dattn,          // like attn
    int64_t n_warps, int len_in, int len_q, int n_heads, int channels,
    int n_points, Levels lv) {
  const int64_t bqh = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bqh >= n_warps) return;  // whole warps leave together
  const int head = (int)(bqh % n_heads);
  const int64_t b = bqh / n_heads / len_q;

  const int n_samples = lv.n * n_points;
  const float* lp = loc + bqh * n_samples * 2;
  const A* ap = attn + bqh * n_samples;
  const V* gp = grad + bqh * channels;
  const int64_t pix = (int64_t)n_heads * channels;  // stride of one pixel
  const V* vb = value + b * len_in * pix + (int64_t)head * channels;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const V* vl = vb + (int64_t)lv.start[l] * pix;
    for (int pt = 0; pt < n_points; ++pt) {
      const int k = l * n_points + pt;
      const float x = __fsub_rn(__fmul_rn(lp[2 * k], (float)W), 0.5f);
      const float y = __fsub_rn(__fmul_rn(lp[2 * k + 1], (float)H), 0.5f);
      float s = 0.f, sx = 0.f, sy = 0.f;  // sums over this lane's channels
      // some corner inside the map (x = -1 still has a slope); NaN fails
      if (x >= -1.f && y >= -1.f && x < (float)W && y < (float)H) {
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float fx = x - x0f;
        const float fy = y - y0f;
        const float gx = 1.f - fx;
        const float gy = 1.f - fy;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < H;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < W;
        const V* r0 = vl + (int64_t)y0 * W * pix;
        const V* r1 = r0 + (int64_t)W * pix;
        for (int c = lane; c < channels; c += 32) {
          const float v00 = (in_y0 && in_x0) ? to_f32(r0[(int64_t)x0 * pix + c]) : 0.f;
          const float v01 = (in_y0 && in_x1) ? to_f32(r0[(int64_t)(x0 + 1) * pix + c]) : 0.f;
          const float v10 = (in_y1 && in_x0) ? to_f32(r1[(int64_t)x0 * pix + c]) : 0.f;
          const float v11 = (in_y1 && in_x1) ? to_f32(r1[(int64_t)(x0 + 1) * pix + c]) : 0.f;
          const float g = to_f32(gp[c]);
          s += g * (gy * gx * v00 + gy * fx * v01 + fy * gx * v10 + fy * fx * v11);
          sx += g * (gy * (v01 - v00) + fy * (v11 - v10));
          sy += g * (gx * (v10 - v00) + fx * (v11 - v01));
        }
      }
      s = warp_sum(s);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const float a = to_f32(ap[k]);
        store(dattn + bqh * n_samples + k, s);
        dloc[(bqh * n_samples + k) * 2] = a * sx * (float)W;
        dloc[(bqh * n_samples + k) * 2 + 1] = a * sy * (float)H;
      }
    }
  }
}

// K3: one thread per (b, q, head, channel), scattering into dvalue (f32).
template <typename V, typename A>
__global__ void __launch_bounds__(kThreads) msda_dvalue_kernel(
    const float* __restrict__ loc, const A* __restrict__ attn,
    const V* __restrict__ grad, float* __restrict__ dvalue,
    int64_t total, int len_in, int len_q, int n_heads, int channels,
    int n_points, Levels lv) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % channels);
  const int64_t bqh = idx / channels;
  const int head = (int)(bqh % n_heads);
  const int64_t b = bqh / n_heads / len_q;

  const int n_samples = lv.n * n_points;
  const float* lp = loc + bqh * n_samples * 2;
  const A* ap = attn + bqh * n_samples;
  const float g = to_f32(grad[idx]);
  const int64_t pix = (int64_t)n_heads * channels;
  float* db = dvalue + b * len_in * pix + (int64_t)head * channels + c;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    float* dl = db + (int64_t)lv.start[l] * pix;
    for (int pt = 0; pt < n_points; ++pt) {
      const int k = l * n_points + pt;
      const float x = __fsub_rn(__fmul_rn(lp[2 * k], (float)W), 0.5f);
      const float y = __fsub_rn(__fmul_rn(lp[2 * k + 1], (float)H), 0.5f);
      if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) continue;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float fx = x - x0f;
      const float fy = y - y0f;
      const float gx = 1.f - fx;
      const float gy = 1.f - fy;
      const float ag = to_f32(ap[k]) * g;
      if (y0 >= 0) {
        float* r = dl + (int64_t)y0 * W * pix;
        if (x0 >= 0) atomicAdd(r + (int64_t)x0 * pix, gy * gx * ag);
        if (x0 + 1 < W) atomicAdd(r + (int64_t)(x0 + 1) * pix, gy * fx * ag);
      }
      if (y0 + 1 < H) {
        float* r = dl + (int64_t)(y0 + 1) * W * pix;
        if (x0 >= 0) atomicAdd(r + (int64_t)x0 * pix, fy * gx * ag);
        if (x0 + 1 < W) atomicAdd(r + (int64_t)(x0 + 1) * pix, fy * fx * ag);
      }
    }
  }
}

bool fill_levels(Levels* lv, int n_levels, const int* level_hws) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  lv->n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = level_hws[3 * l];
    lv->w[l] = level_hws[3 * l + 1];
    lv->start[l] = level_hws[3 * l + 2];
  }
  return true;
}

template <typename V, typename A>
void launch_dcoord(const void* value, const float* loc, const void* attn,
                   const void* grad, float* dloc, void* dattn, int64_t n_warps,
                   int len_in, int len_q, int n_heads, int channels,
                   int n_points, const Levels& lv, cudaStream_t stream) {
  const int warps_per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((n_warps + warps_per_block - 1) / warps_per_block);
  msda_dcoord_kernel<V, A><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), loc, static_cast<const A*>(attn),
      static_cast<const V*>(grad), dloc, static_cast<A*>(dattn), n_warps,
      len_in, len_q, n_heads, channels, n_points, lv);
}

template <typename V, typename A>
void launch_dvalue(const float* loc, const void* attn, const void* grad,
                   float* dvalue, int64_t total, int len_in, int len_q,
                   int n_heads, int channels, int n_points, const Levels& lv,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  msda_dvalue_kernel<V, A><<<blocks, kThreads, 0, stream>>>(
      loc, static_cast<const A*>(attn), static_cast<const V*>(grad), dvalue,
      total, len_in, len_q, n_heads, channels, n_points, lv);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (grad has the value's dtype).
// level_hws is a HOST array of n_levels (height, width, start) triples.
// Each returns cudaGetLastError() after its launch.
extern "C" int msda_bwd_dcoord(const void* value, const void* loc,
                               const void* attn, const void* grad, void* dloc,
                               void* dattn, int value_dtype, int attn_dtype,
                               int batch, int len_in, int len_q, int n_heads,
                               int channels, int n_levels, int n_points,
                               const int* level_hws, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_levels, level_hws)) return (int)cudaErrorInvalidValue;
  const int64_t n_warps = (int64_t)batch * len_q * n_heads;
  if (n_warps == 0) return 0;
  const float* l = static_cast<const float*>(loc);
  float* dl = static_cast<float*>(dloc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    launch_dcoord<float, float>(value, l, attn, grad, dl, dattn, n_warps, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    launch_dcoord<float, __nv_bfloat16>(value, l, attn, grad, dl, dattn, n_warps, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    launch_dcoord<__nv_bfloat16, float>(value, l, attn, grad, dl, dattn, n_warps, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    launch_dcoord<__nv_bfloat16, __nv_bfloat16>(value, l, attn, grad, dl, dattn, n_warps, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dvalue is an f32 (B, len_in, n_heads, channels) buffer the caller zeroed.
extern "C" int msda_bwd_dvalue(const void* loc, const void* attn,
                               const void* grad, void* dvalue, int value_dtype,
                               int attn_dtype, int batch, int len_in, int len_q,
                               int n_heads, int channels, int n_levels,
                               int n_points, const int* level_hws,
                               void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_levels, level_hws)) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)batch * len_q * n_heads * channels;
  if (total == 0) return 0;
  const float* l = static_cast<const float*>(loc);
  float* dv = static_cast<float*>(dvalue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    launch_dvalue<float, float>(l, attn, grad, dv, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    launch_dvalue<float, __nv_bfloat16>(l, attn, grad, dv, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    launch_dvalue<__nv_bfloat16, float>(l, attn, grad, dv, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    launch_dvalue<__nv_bfloat16, __nv_bfloat16>(l, attn, grad, dv, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
