// Multi-scale deformable attention forward (K1) for Hopper (sm_90a).
//
// Replaces: openvis_tpu/ops/msda_pallas.py::_fused_levels_kernel, launched by
// _msda_fused (and serves _level_kernel_v2 / _level_kernel, the per-level TPU
// tilings of the same function). On the TPU the gathers serialize, so those
// kernels recast the bilinear sampling as an implicit matmul over per-level
// "tent" tables in VMEM. A GPU gathers rows natively, so this is the gather form
// of the reference CUDA op (ms_deformable_im2col), with the same output.
//
// What bounds it on this card: instruction issue and load latency, not bytes.
// The bytes it must move (value once, locations, weights, output) take a few
// hundredths of a millisecond; per (query, head) it does 12 samples'
// coordinate math and gathers 48 corner rows of 32 channels, mostly from
// L1/L2. A thread per output channel would repeat that math in 32 lanes, read
// 2 bytes per lane per load and begin with 64-bit divisions, and a level table
// indexed at run time would sit in local memory. Design against that:
//   * a group of `lanes` threads per (b, q, head); each lane owns VEC
//     consecutive channels and reads a corner as one 16-byte load (8 bf16 or
//     4 f32), so 32 channels are 4 (bf16) or 8 (f32) lanes and a warp covers
//     8 or 4 (q, head) rows;
//   * each lane computes the coordinates of its row's samples itself (4 or 8
//     times, not 32); on the main path a level's 4 locations and 4 weights
//     arrive as 16-byte (8-byte) vector loads;
//   * int32 offsets inside a batch item on the main path (the wrapper checks
//     that they fit); the level table is a __grid_constant__ parameter, read
//     from the constant bank and never copied to local memory;
//   * templates specialise the main path (3 levels, 4 points, 32 channels)
//     with every loop unrolled; one generic instantiation of the same kernel,
//     at scalar width (one channel per lane and load) with int64 offsets,
//     takes every other shape, and the main shape where a pointer is not
//     16-byte aligned: 1..8 levels, any point count, any channel count (the
//     wrapper's launch_plan picks the variant);
//   * coordinates, bilinear weights, the attention weight and the accumulator
//     are f32; the pixel coordinate loc * size - 0.5 is rounded as two
//     operations (no fused multiply-add), as in K2, K3, K5 and K6, so forward
//     and backward pick the same corner at a pixel centre.
//
// Semantics: grid_sample(align_corners=False, padding_mode="zeros"), i.e. each
// of the four corners outside the map contributes zero.

#include "msda_common.cuh"

namespace {

using namespace msda;

// One sample's four corners (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1): the
// bilinear weight times the attention weight (0 for a corner outside the map,
// whose value is not read) and the pixel offset from the level's first pixel.
template <typename Off>
struct Corners {
  float w[4];
  bool in[4];
  Off off[4];
};

template <typename Off>
__device__ __forceinline__ Corners<Off> corners(float lx, float ly, float a, int H, int W) {
  const float x = pixel(lx, W);
  const float y = pixel(ly, H);
  // some corner inside the map; a NaN fails every test
  const bool inside = x > -1.f && y > -1.f && x < (float)W && y < (float)H;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = inside ? (int)x0f : 0;
  const int y0 = inside ? (int)y0f : 0;
  const float fx = x - x0f, fy = y - y0f;
  const float gx = 1.f - fx, gy = 1.f - fy;
  Corners<Off> c;
  c.in[0] = inside && y0 >= 0 && x0 >= 0;
  c.in[1] = inside && y0 >= 0 && x0 + 1 < W;
  c.in[2] = inside && y0 + 1 < H && x0 >= 0;
  c.in[3] = inside && y0 + 1 < H && x0 + 1 < W;
  c.w[0] = c.in[0] ? gy * gx * a : 0.f;
  c.w[1] = c.in[1] ? gy * fx * a : 0.f;
  c.w[2] = c.in[2] ? fy * gx * a : 0.f;
  c.w[3] = c.in[3] ? fy * fx * a : 0.f;
  c.off[0] = (Off)y0 * W + x0;
  c.off[1] = c.off[0] + 1;
  c.off[2] = c.off[0] + W;
  c.off[3] = c.off[2] + 1;
  return c;
}

// NL > 0: the main path's (NL, NP, CH), loops unrolled, int32 offsets (Off).
// NL == 0: the generic kernel; levels, points and channels at run time.
template <typename V, typename A, int VEC, int NL, int NP, int CH, typename Off>
__global__ void __launch_bounds__(kThreads) msda_fwd_kernel(
    const V* __restrict__ value,   // (B, len_in, n_heads, channels)
    const float* __restrict__ loc, // (B, len_q, n_heads, n_levels, n_points, 2)
    const A* __restrict__ attn,    // (B, len_q, n_heads, n_levels, n_points)
    V* __restrict__ out,           // (B, len_q, n_heads * channels)
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
  const int head = (int)(bqh % n_heads);
  const Off b = bqh / n_heads / len_q;

  const int n_samples = n_levels * n_points;
  const float* lp = loc + (int64_t)bqh * n_samples * 2;
  const A* ap = attn + (int64_t)bqh * n_samples;
  const Off pix = (Off)n_heads * channels;  // stride of one pixel
  const V* vb = value + (int64_t)b * len_in * pix + head * channels;
  V* op = out + (int64_t)bqh * channels;

  for (int c0 = lane * VEC; c0 < channels; c0 += lanes * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int l = 0; l < n_levels; ++l) {
      const int H = lv.h[l];
      const int W = lv.w[l];
      const V* vl = vb + (Off)lv.start[l] * pix + c0;
      auto sample = [&](float lx, float ly, float a) {
        const Corners<Off> c = corners<Off>(lx, ly, a, H, W);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[VEC];
          if (c.in[q]) {
            Vec<V, VEC>::load(vl + c.off[q] * pix, v);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += c.w[q] * v[i];
        }
      };
      if constexpr (kSpecial) {
        static_assert(NP == 4, "the main path's vector loads take 4 points per level");
        const float4 p01 = __ldg(reinterpret_cast<const float4*>(lp + 8 * l));
        const float4 p23 = __ldg(reinterpret_cast<const float4*>(lp + 8 * l + 4));
        float a4[4];
        load4(ap + 4 * l, a4);
        sample(p01.x, p01.y, a4[0]);
        sample(p01.z, p01.w, a4[1]);
        sample(p23.x, p23.y, a4[2]);
        sample(p23.z, p23.w, a4[3]);
      } else {
        for (int pt = 0; pt < n_points; ++pt) {
          const int k = l * n_points + pt;
          sample(__ldg(lp + 2 * k), __ldg(lp + 2 * k + 1), to_f32(ap[k]));
        }
      }
    }
    Vec<V, VEC>::store(op + c0, acc);
  }
}

template <typename V, typename A>
int launch(const void* value, const float* loc, const void* attn, void* out,
           int variant, int lanes_log2, int64_t blocks, int64_t groups, int len_in,
           int len_q, int n_heads, int channels, int n_points, const Levels& lv,
           cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(V);
  const V* v = static_cast<const V*>(value);
  const A* a = static_cast<const A*>(attn);
  V* o = static_cast<V*>(out);
  const dim3 grid((unsigned)blocks);
  if (variant == kMain) {
    if (lv.n != kMainLevels || n_points != kMainPoints || channels != kMainChannels ||
        lanes_log2 != ilog2(kMainChannels / kVec) || groups * (1 << lanes_log2) > INT32_MAX ||
        (int64_t)len_in * n_heads * channels > INT32_MAX ||
        !(aligned16(value) && aligned16(loc) && aligned16(attn) && aligned16(out)))
      return (int)cudaErrorInvalidValue;
    msda_fwd_kernel<V, A, kVec, kMainLevels, kMainPoints, kMainChannels, int>
        <<<grid, kThreads, 0, stream>>>(v, loc, a, o, (int)groups, lanes_log2, len_in,
                                         len_q, n_heads, channels, n_points, lv);
  } else if (variant == kGeneric) {
    msda_fwd_kernel<V, A, 1, 0, 0, 0, int64_t><<<grid, kThreads, 0, stream>>>(
        v, loc, a, o, groups, lanes_log2, len_in, len_q, n_heads, channels, n_points, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  level_hws is a HOST array of
// n_levels (height, width, start) triples.  variant, lanes_log2 and blocks
// come from launch_plan (ops/msda_cuda.py); kThreads threads per block.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan whose
// kernel would read out of bounds or misaligned.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int value_dtype, int attn_dtype, int batch,
                        int len_in, int len_q, int n_heads, int channels,
                        int n_levels, int n_points, const int* level_hws,
                        int variant, int lanes_log2, long long blocks, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_levels, level_hws) || lanes_log2 < 0 || lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  const int64_t groups = (int64_t)batch * len_q * n_heads;
  if (groups == 0 || channels == 0) return 0;
  if (blocks != (groups * (1 << lanes_log2) + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(loc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    return launch<float, float>(value, l, attn, out, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    return launch<float, __nv_bfloat16>(value, l, attn, out, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    return launch<__nv_bfloat16, float>(value, l, attn, out, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(value, l, attn, out, variant, lanes_log2, blocks, groups, len_in, len_q, n_heads, channels, n_points, lv, s);
  }
  return (int)cudaErrorInvalidValue;
}
