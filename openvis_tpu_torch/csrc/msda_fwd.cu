// Multi-scale deformable attention forward (K1) for Hopper (sm_90a).
//
// Replaces: openvis_tpu/ops/msda_pallas.py::_fused_levels_kernel, launched by
// _msda_fused. On the TPU the gathers serialize, so that kernel recasts the
// bilinear sampling as an implicit matmul over per-level "tent" tables in VMEM
// and permutes the queries into y-stripes. Neither trick helps here: a GPU
// gathers rows natively, so this is the gather form of the reference CUDA op
// (ms_deformable_im2col), with the same output.
//
// What bounds it on this card: memory traffic. Each output element reads
// 4 corners x n_points x n_levels value elements and spends about two flops on
// each, far below the flop/byte ratio at which the H100 becomes compute bound.
// Design against that:
//   * one thread per output (b, q, head, channel), channel fastest, so the
//     32 channels of one (b, q, head) are one warp and each corner read is one
//     contiguous row of `channels` values (64 B in bf16, 128 B in f32);
//   * the warp shares its sampling location and attention weight, so those
//     loads are broadcasts and every branch on them is warp-uniform;
//   * levels and points loop inside the thread; level shapes and start
//     offsets arrive by value (like the reference's level_start_index);
//   * coordinates (loc * size - 0.5), bilinear weights, the attention weight
//     and the accumulator are f32; the output is written in the value's dtype.
//
// Semantics: grid_sample(align_corners=False, padding_mode="zeros"), i.e. each
// of the four corners outside the map contributes zero.

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

template <typename V, typename A>
__global__ void __launch_bounds__(kThreads) msda_fwd_kernel(
    const V* __restrict__ value,   // (B, len_in, n_heads, channels)
    const float* __restrict__ loc, // (B, len_q, n_heads, n_levels, n_points, 2)
    const A* __restrict__ attn,    // (B, len_q, n_heads, n_levels, n_points)
    V* __restrict__ out,           // (B, len_q, n_heads * channels)
    int64_t total, int len_in, int len_q, int n_heads, int channels,
    int n_points, Levels lv) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % channels);
  const int64_t bqh = idx / channels;  // ((b * len_q + q) * n_heads + head)
  const int head = (int)(bqh % n_heads);
  const int64_t b = bqh / n_heads / len_q;

  const int n_samples = lv.n * n_points;
  const float* lp = loc + bqh * n_samples * 2;
  const A* ap = attn + bqh * n_samples;
  const int64_t pix = (int64_t)n_heads * channels;  // stride of one pixel
  const V* vb = value + b * len_in * pix + (int64_t)head * channels + c;

  float acc = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const V* vl = vb + (int64_t)lv.start[l] * pix;
    for (int pt = 0; pt < n_points; ++pt) {
      const int k = l * n_points + pt;
      const float x = lp[2 * k] * (float)W - 0.5f;
      const float y = lp[2 * k + 1] * (float)H - 0.5f;
      // all four corners outside the map (or a NaN coordinate): contributes 0
      if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) continue;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float fx = x - x0f;
      const float fy = y - y0f;
      const float gx = 1.f - fx;
      const float gy = 1.f - fy;
      float s = 0.f;
      if (y0 >= 0) {
        const V* r = vl + (int64_t)y0 * W * pix;
        if (x0 >= 0) s += gy * gx * to_f32(r[(int64_t)x0 * pix]);
        if (x0 + 1 < W) s += gy * fx * to_f32(r[(int64_t)(x0 + 1) * pix]);
      }
      if (y0 + 1 < H) {
        const V* r = vl + (int64_t)(y0 + 1) * W * pix;
        if (x0 >= 0) s += fy * gx * to_f32(r[(int64_t)x0 * pix]);
        if (x0 + 1 < W) s += fy * fx * to_f32(r[(int64_t)(x0 + 1) * pix]);
      }
      acc += to_f32(ap[k]) * s;
    }
  }
  store(out + idx, acc);
}

template <typename V, typename A>
void launch(const void* value, const float* loc, const void* attn, void* out,
            int64_t total, int len_in, int len_q, int n_heads, int channels,
            int n_points, const Levels& lv, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  msda_fwd_kernel<V, A><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), loc, static_cast<const A*>(attn),
      static_cast<V*>(out), total, len_in, len_q, n_heads, channels, n_points, lv);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  level_hws is a HOST array of
// n_levels (height, width, start) triples.  Returns cudaGetLastError().
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int value_dtype, int attn_dtype, int batch,
                        int len_in, int len_q, int n_heads, int channels,
                        int n_levels, int n_points, const int* level_hws,
                        void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hws[3 * l];
    lv.w[l] = level_hws[3 * l + 1];
    lv.start[l] = level_hws[3 * l + 2];
  }
  const int64_t total = (int64_t)batch * len_q * n_heads * channels;
  if (total == 0) return 0;
  const float* l = static_cast<const float*>(loc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    launch<float, float>(value, l, attn, out, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    launch<float, __nv_bfloat16>(value, l, attn, out, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    launch<__nv_bfloat16, float>(value, l, attn, out, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(value, l, attn, out, total, len_in, len_q, n_heads, channels, n_points, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
