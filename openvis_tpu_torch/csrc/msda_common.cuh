// What the MSDA kernels K1 (msda_fwd.cu) and K2/K3 (msda_bwd.cu) share: the
// level table, the variants that launch_plan (ops/msda_cuda.py) picks, and the
// vector loads and stores of value rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
// K1 and K2 variants, as launch_plan numbers them
constexpr int kMain = 0, kGeneric = 1;
// the main path's shape, fixed at compile time in the kMain variant
constexpr int kMainLevels = 3, kMainPoints = 4, kMainChannels = 32;

// Per level: height, width and the offset of its first pixel in the value.
struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// level_hws: a HOST array of n_levels (height, width, start) triples
inline bool fill_levels(Levels* lv, int n_levels, const int* level_hws) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  lv->n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = level_hws[3 * l];
    lv->w[l] = level_hws[3 * l + 1];
    lv->start[l] = level_hws[3 * l + 2];
  }
  return true;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// VEC consecutive values <-> f32 registers: one 16-byte access, or one value.
template <typename V, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address is the low half
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&o)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <typename V>
struct Vec<V, 1> {
  static __device__ __forceinline__ void load(const V* p, float (&o)[1]) { o[0] = to_f32(*p); }
  static __device__ __forceinline__ void store(V* p, const float (&o)[1]) { store1(p, o[0]); }
};

// four attention weights (one main-path level) as one 16- or 8-byte load
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}

// The pixel coordinate loc * size - 0.5, rounded as two operations (no fused
// multiply-add), as in the plain version: a point exactly on a pixel centre
// (where the encoder's ring-bias init puts its samples) picks the same corner
// and the same one-sided slope in K1, K2, K3 and there.
__device__ __forceinline__ float pixel(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

}  // namespace msda
