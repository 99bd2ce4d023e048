// Shared-point bilinear sampler of the criterion for Hopper (sm_90a):
//   K5 (point_sample_fwd): samples of R maps at P points shared by the rows of
//       one batch item;
//   K6 (point_sample_dvalue): the gradient of K5 with respect to the maps.
//
// Replaces: openvis_tpu/ops/point_sample_pallas.py::_ps_fwd (body _fwd_kernel)
// and _ps_bwd (body _dvalue_kernel). On the TPU gathers serialize, so those
// kernels sort the points by y, build bilinear tent weights for a window of
// map rows and contract them with the rows on the MXU (a 3-pass split f32
// dot). A GPU gathers natively, so this is the plain 4-corner gather (K5) and
// its transpose, a 4-corner scatter with f32 atomics (K6). The points may come
// sorted by y, as the criterion draws them; nothing here depends on it.
//
// What bounds them on this card: memory traffic. A sample reads 4 map values
// (or adds into 4) and spends about 10 flops, far below the H100's flop/byte
// ridge; the maps of one criterion call (at most ~21 MB in f32) fit in the
// 50 MB L2, so the corner reads mostly hit L2. Design against that:
//   * maps stay in their (B, R, H, W) layout, as the model produces them and
//     as their gradient is wanted, so neither kernel needs a transpose;
//   * one thread per (b, r, p) with the point fastest: the point reads and
//     the output writes (K5) or gradient reads (K6) are coalesced, and the
//     y-sorted points of a warp fall in a narrow band of rows;
//   * coordinates (p * size - 0.5, rounded as two operations like the plain
//     version), weights and sums are f32, whatever the maps' dtype: bf16 maps are read and widened exactly, which is the
//     JAX package's f32 sampling policy (f32_tents);
//   * K6 adds into an f32 scratch that the caller zeroed, in an order that
//     changes from run to run; the caller casts to the maps' dtype.
//
// Semantics: grid_sample(align_corners=False, padding_mode="zeros"), output
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads) point_sample_dvalue_kernel(
    const float* __restrict__ coords,  // (B, P, 2)
    const float* __restrict__ grad,    // (B, R, P)
    float* __restrict__ dmaps,         // (B, R, H, W), zeroed
    int64_t total, int rows, int H, int W, int P) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int p = (int)(idx % P);
  const int64_t br = idx / P;
  const int64_t b = br / rows;
  const float* cp = coords + (b * P + p) * 2;
  const float x = __fsub_rn(__fmul_rn(cp[0], (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(cp[1], (float)H), 0.5f);
  if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) return;
  const float g = grad[idx];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const float fx = x - x0f;
  const float fy = y - y0f;
  const float gx = 1.f - fx;
  const float gy = 1.f - fy;
  float* m = dmaps + br * H * W;
  if (y0 >= 0) {
    float* r = m + (int64_t)y0 * W;
    if (x0 >= 0) atomicAdd(r + x0, g * (gy * gx));
    if (x0 + 1 < W) atomicAdd(r + x0 + 1, g * (gy * fx));
  }
  if (y0 + 1 < H) {
    float* r = m + (int64_t)(y0 + 1) * W;
    if (x0 >= 0) atomicAdd(r + x0, g * (fy * gx));
    if (x0 + 1 < W) atomicAdd(r + x0 + 1, g * (fy * fx));
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

// dmaps is an f32 (B, R, H, W) buffer the caller zeroed.
extern "C" int point_sample_dvalue(const void* coords, const void* grad,
                                   void* dmaps, int batch, int rows, int height,
                                   int width, int n_points, void* stream) {
  const int64_t total = (int64_t)batch * rows * n_points;
  if (total == 0) return 0;
  point_sample_dvalue_kernel<<<blocks_for(total), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(grad),
      static_cast<float*>(dmaps), total, rows, height, width, n_points);
  return (int)cudaGetLastError();
}
