// Multi-scale deformable attention backward for Hopper (sm_90a):
//   K2 (msda_bwd_dcoord): gradients of the sampling locations and of the
//       attention weights;
//   K3 (msda_bwd_dvalue): gradient of the value maps.
//
// Replaces: openvis_tpu/ops/msda_pallas.py::_msda_bwd_fused, whose two
// pallas_calls are the fused all-level dCoord kernel (_fused_dcoord_rr_kernel)
// and the per-level dValue kernel (_dvalue_kernel_v2); they also serve the
// per-level TPU tilings of the same functions (_sample_level_pallas_bwd_v2 and
// _sample_level_pallas_bwd). On the TPU these are implicit matmuls over
// bilinear "tent" tables, because gathers and scatters serialize there. A GPU
// gathers natively and has atomics, so these are the gather/scatter form of the
// reference CUDA op (ms_deformable_col2im), split in two kernels so that each
// has one job and its own launch count.
//
// What bounds them on this card. K2 moves few bytes (value, locations,
// weights, the output gradient, dloc and dattn); its pace is set by
// instruction issue and load latency. With one warp per (b, q, head) and one
// channel per lane, all 32 lanes would repeat each sample's coordinate math,
// reload the output gradient for every sample, end each sample in three
// dependent 5-step shuffle reductions and store from one lane. K2's design:
//   * a group of `lanes` threads per (b, q, head), each owning VEC
//     consecutive channels (8 bf16 or 4 f32: 16-byte loads), so 32 channels
//     are 4 (bf16) or 8 (f32) lanes;
//   * per sample, each lane forms the four corner dot products
//     S_c = sum over its channels of g * v_c, and from them its parts of
//     dattn = sum_c w_c S_c and of the x and y slopes; the three parts are
//     summed across the group in log2(lanes) shuffle steps (2 in bf16);
//   * lane (k mod lanes) writes sample k's dattn and its dloc pair (one
//     8-byte store), so every lane stores and a group's stores are contiguous;
//   * one sample body, as in K1: the main path (3 levels, 4 points, 32
//     channels) is a template specialisation with every loop unrolled,
//     vector loads of a level's locations and weights, and int32 offsets;
//     the generic instantiation, at scalar width with int64 offsets, takes
//     every other shape and the main shape where a pointer is not 16-byte
//     aligned.
// K3 scatters: one thread per (b, q, head, channel) adds into an f32 scratch
// (zeroed by the caller) with atomicAdd, so its summation order changes from
// run to run; the caller casts to the value's dtype. Its bound is atomic
// throughput as much as bytes.
// Both: coordinates, bilinear weights and every sum are f32, and the pixel
// coordinate is msda::pixel's (two roundings), so a point on a pixel centre
// takes the plain version's one-sided slope; at x = -1 (or y = -1) the slope
// is still taken.
//
// Semantics: the gradient of the 4-corner gather form of
// grid_sample(align_corners=False, padding_mode="zeros"): a corner outside
// the map contributes nothing, and d(pixel)/d(loc) is the level's width (x) or
// height (y).

#include "msda_common.cuh"

namespace {

using namespace msda;

// One sample's bilinear fractions and its corners (y0,x0), (y0,x0+1),
// (y0+1,x0), (y0+1,x0+1): inside the map or not, and the pixel offset from
// the level's first pixel.  A sample with no corner inside gets fx = fy = 0,
// so its (zero) sums give exact zeros, NaN coordinates included.
template <typename Off>
struct Corners {
  float fx, fy;
  bool in[4];
  Off off[4];
};

template <typename Off>
__device__ __forceinline__ Corners<Off> corners(float lx, float ly, int H, int W) {
  const float x = pixel(lx, W);
  const float y = pixel(ly, H);
  // some corner inside the map (x = -1 still has a slope); NaN fails
  const bool inside = x >= -1.f && y >= -1.f && x < (float)W && y < (float)H;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = inside ? (int)x0f : 0;
  const int y0 = inside ? (int)y0f : 0;
  Corners<Off> c;
  c.fx = inside ? x - x0f : 0.f;
  c.fy = inside ? y - y0f : 0.f;
  c.in[0] = inside && y0 >= 0 && x0 >= 0;
  c.in[1] = inside && y0 >= 0 && x0 + 1 < W;
  c.in[2] = inside && y0 + 1 < H && x0 >= 0;
  c.in[3] = inside && y0 + 1 < H && x0 + 1 < W;
  c.off[0] = (Off)y0 * W + x0;
  c.off[1] = c.off[0] + 1;
  c.off[2] = c.off[0] + W;
  c.off[3] = c.off[2] + 1;
  return c;
}

// K2.  NL > 0: the main path's (NL, NP, CH), loops unrolled, int32 offsets
// (Off).  NL == 0: the generic kernel; levels, points and channels at run time.
// A group's lanes are consecutive threads of one warp (lanes is a power of two
// up to 32), and a group leaves or stays whole.
template <typename V, typename A, int VEC, int NL, int NP, int CH, typename Off>
__global__ void __launch_bounds__(kThreads) msda_dcoord_kernel(
    const V* __restrict__ value,    // (B, len_in, n_heads, channels)
    const float* __restrict__ loc,  // (B, len_q, n_heads, n_levels, n_points, 2)
    const A* __restrict__ attn,     // (B, len_q, n_heads, n_levels, n_points)
    const V* __restrict__ grad,     // (B, len_q, n_heads * channels)
    float* __restrict__ dloc,       // like loc
    A* __restrict__ dattn,          // like attn
    Off groups, int lanes_log2, int len_in, int len_q, int n_heads,
    int channels_rt, int n_points_rt, const __grid_constant__ Levels lv) {
  constexpr bool kSpecial = NL > 0;
  const int n_levels = kSpecial ? NL : lv.n;
  const int n_points = kSpecial ? NP : n_points_rt;
  const int channels = kSpecial ? CH : channels_rt;
  const int log2l = kSpecial ? ilog2(CH / VEC) : lanes_log2;
  const int lanes = 1 << log2l;

  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if ((t >> log2l) >= (int64_t)groups) return;
  const Off bqh = (Off)(t >> log2l);  // ((b * len_q + q) * n_heads + head)
  const int lane = (int)t & (lanes - 1);
  const unsigned mask = lanes == 32 ? 0xffffffffu
                                    : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int head = (int)(bqh % n_heads);
  const Off b = bqh / n_heads / len_q;

  const int n_samples = n_levels * n_points;
  const float* lp = loc + (int64_t)bqh * n_samples * 2;
  const A* ap = attn + (int64_t)bqh * n_samples;
  const V* gp = grad + (int64_t)bqh * channels;
  const Off pix = (Off)n_heads * channels;  // stride of one pixel
  const V* vb = value + (int64_t)b * len_in * pix + head * channels;
  float2* dl = reinterpret_cast<float2*>(dloc) + (int64_t)bqh * n_samples;
  A* da = dattn + (int64_t)bqh * n_samples;

  // On the main path a lane's channels are one run (CH = lanes * VEC), so its
  // output gradient is loaded and widened once per (q, head), not per sample.
  static_assert(!kSpecial || (NP == 4 && CH == (1 << ilog2(CH / VEC)) * VEC),
                "the main path: 4 points per level (vector loads), one run per lane");
  float g_main[VEC];
  if constexpr (kSpecial) Vec<V, VEC>::load(gp + lane * VEC, g_main);

#pragma unroll
  for (int l = 0; l < n_levels; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const V* vl = vb + (Off)lv.start[l] * pix;
    float pxy[8], a4[4];  // main path: the level's locations and weights
    if constexpr (kSpecial) {
      const float4 p01 = __ldg(reinterpret_cast<const float4*>(lp + 8 * l));
      const float4 p23 = __ldg(reinterpret_cast<const float4*>(lp + 8 * l + 4));
      pxy[0] = p01.x; pxy[1] = p01.y; pxy[2] = p01.z; pxy[3] = p01.w;
      pxy[4] = p23.x; pxy[5] = p23.y; pxy[6] = p23.z; pxy[7] = p23.w;
      load4(ap + 4 * l, a4);
    }
#pragma unroll
    for (int pt = 0; pt < n_points; ++pt) {
      const int k = l * n_points + pt;
      float lx, ly, a;
      if constexpr (kSpecial) {
        lx = pxy[2 * pt]; ly = pxy[2 * pt + 1]; a = a4[pt];
      } else {
        lx = __ldg(lp + 2 * k); ly = __ldg(lp + 2 * k + 1); a = to_f32(ap[k]);
      }
      const Corners<Off> c = corners<Off>(lx, ly, H, W);
      float S[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = lane * VEC; c0 < channels; c0 += lanes * VEC) {
        float g[VEC];
        if constexpr (kSpecial) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) g[i] = g_main[i];
        } else {
          Vec<V, VEC>::load(gp + c0, g);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[VEC];
          if (c.in[q]) {
            Vec<V, VEC>::load(vl + c.off[q] * pix + c0, v);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) S[q] += g[i] * v[i];
        }
      }
      // sample k's sums over the group, from this lane's corner dot products
      const float fx = c.fx, fy = c.fy, gx = 1.f - fx, gy = 1.f - fy;
      float s = gy * gx * S[0] + gy * fx * S[1] + fy * gx * S[2] + fy * fx * S[3];
      float sx = gy * (S[1] - S[0]) + fy * (S[3] - S[2]);
      float sy = gx * (S[2] - S[0]) + fx * (S[3] - S[1]);
#pragma unroll
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(mask, s, off, lanes);
        sx += __shfl_xor_sync(mask, sx, off, lanes);
        sy += __shfl_xor_sync(mask, sy, off, lanes);
      }
      if ((k & (lanes - 1)) == lane) {
        store1(da + k, s);
        dl[k] = make_float2(a * sx * (float)W, a * sy * (float)H);
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
      const float x = pixel(lp[2 * k], W);
      const float y = pixel(lp[2 * k + 1], H);
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

template <typename V, typename A>
int launch_dcoord(const void* value, const float* loc, const void* attn,
                  const void* grad, float* dloc, void* dattn, int variant,
                  int lanes_log2, int64_t blocks, int64_t groups, int len_in,
                  int len_q, int n_heads, int channels, int n_points,
                  const Levels& lv, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(V);
  const V* v = static_cast<const V*>(value);
  const A* a = static_cast<const A*>(attn);
  const V* g = static_cast<const V*>(grad);
  A* da = static_cast<A*>(dattn);
  const dim3 grid((unsigned)blocks);
  if (variant == kMain) {
    if (lv.n != kMainLevels || n_points != kMainPoints || channels != kMainChannels ||
        lanes_log2 != ilog2(kMainChannels / kVec) || groups * (1 << lanes_log2) > INT32_MAX ||
        (int64_t)len_in * n_heads * channels > INT32_MAX ||
        !(aligned16(value) && aligned16(loc) && aligned16(attn) && aligned16(grad) &&
          aligned16(dloc)))
      return (int)cudaErrorInvalidValue;
    msda_dcoord_kernel<V, A, kVec, kMainLevels, kMainPoints, kMainChannels, int>
        <<<grid, kThreads, 0, stream>>>(v, loc, a, g, dloc, da, (int)groups, lanes_log2,
                                         len_in, len_q, n_heads, channels, n_points, lv);
  } else if (variant == kGeneric) {
    if ((reinterpret_cast<uintptr_t>(dloc) & 7u) != 0) return (int)cudaErrorInvalidValue;
    msda_dcoord_kernel<V, A, 1, 0, 0, 0, int64_t><<<grid, kThreads, 0, stream>>>(
        v, loc, a, g, dloc, da, groups, lanes_log2, len_in, len_q, n_heads, channels,
        n_points, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
// variant, lanes_log2 and blocks come from launch_plan (ops/msda_cuda.py);
// kThreads threads per block.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a plan whose kernel would read or write out
// of bounds or misaligned.
extern "C" int msda_bwd_dcoord(const void* value, const void* loc,
                               const void* attn, const void* grad, void* dloc,
                               void* dattn, int value_dtype, int attn_dtype,
                               int batch, int len_in, int len_q, int n_heads,
                               int channels, int n_levels, int n_points,
                               const int* level_hws, int variant, int lanes_log2,
                               long long blocks, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_levels, level_hws) || lanes_log2 < 0 || lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  const int64_t groups = (int64_t)batch * len_q * n_heads;
  if (groups == 0) return 0;
  if (blocks != (groups * (1 << lanes_log2) + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(loc);
  float* dl = static_cast<float*>(dloc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    return launch_dcoord<float, float>(value, l, attn, grad, dl, dattn, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    return launch_dcoord<float, __nv_bfloat16>(value, l, attn, grad, dl, dattn, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    return launch_dcoord<__nv_bfloat16, float>(value, l, attn, grad, dl, dattn, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    return launch_dcoord<__nv_bfloat16, __nv_bfloat16>(value, l, attn, grad, dl, dattn, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  }
  return (int)cudaErrorInvalidValue;
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
