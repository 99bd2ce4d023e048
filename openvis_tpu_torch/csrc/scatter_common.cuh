// What the scatter kernels K3 (msda_bwd.cu) and K6 (point_sample.cu) share:
// binning a tile's corner adds by the output pixel they land on, in shared
// memory, and 16-byte reductions into global memory.
//
// Why bins and not a band of f32 sums in shared memory: sm_90 has no native
// shared-memory f32 atomic add (atomicAdd on a shared float compiles to an
// ATOMS.CAST.SPIN compare-and-swap loop), while shared int atomics are
// native. So a tile counts its adds per band pixel with int atomics, turns
// the counts into list offsets (a block scan), lists each add under its
// pixel, and then each pixel's sum is formed in registers by one thread or
// one group of lanes, with no atomics, and added to the output once.
#pragma once

#include <cuda_runtime.h>

namespace scatter {

constexpr int kThreads = 256;

// a 16-byte reduction into global memory (sm_90); p is 16-byte aligned
__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// Exclusive prefix sums of a[0, n) in place, and a[n] = the total; the whole
// block calls it, s_warp holds kThreads / 32 ints. Ends synchronised.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n, int* s_warp) {
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = min(n, (int)threadIdx.x * per);
  const int b1 = min(n, b0 + per);
  int sum = 0;
  for (int i = b0; i < b1; ++i) sum += a[i];
  const int lane = threadIdx.x & 31;
  int x = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int v = s_warp[w];
      s_warp[w] = total;
      total += v;
    }
  }
  __syncthreads();
  int run = s_warp[threadIdx.x >> 5] + x - sum;
  for (int i = b0; i < b1; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (threadIdx.x == kThreads - 1) a[n] = run;
  __syncthreads();
}

// Bins entries 0 .. n_entries - 1 by band pixel: pixel_of(e) is e's pixel in
// [0, n_pix), or -1 for none. Afterwards pixel p's entries are
// s_list[s_beg[p] .. s_beg[p + 1]), as payload_of(e). s_beg holds n_pix + 1
// ints, s_cur n_pix. The whole block calls it; ends synchronised.
template <typename PixelOf, typename PayloadOf>
__device__ __forceinline__ void bin_entries(int n_entries, int n_pix, PixelOf pixel_of,
                                            PayloadOf payload_of, int* s_beg, int* s_cur,
                                            int* s_list, int* s_warp) {
  for (int p = threadIdx.x; p <= n_pix; p += kThreads) s_beg[p] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < n_entries; e += kThreads) {
    const int p = pixel_of(e);
    if (p >= 0) atomicAdd(&s_beg[p], 1);
  }
  __syncthreads();
  block_exclusive_scan(s_beg, n_pix, s_warp);
  for (int p = threadIdx.x; p < n_pix; p += kThreads) s_cur[p] = s_beg[p];
  __syncthreads();
  for (int e = threadIdx.x; e < n_entries; e += kThreads) {
    const int p = pixel_of(e);
    if (p >= 0) s_list[atomicAdd(&s_cur[p], 1)] = payload_of(e);
  }
  __syncthreads();
}

}  // namespace scatter
