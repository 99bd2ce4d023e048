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
// K3 scatters into an f32 scratch that the caller zeroed (and casts to the
// value's dtype), so its summation order changes from run to run. One f32
// atomic per (b, q, head, channel, sample, corner) into L2 is paced by L2
// atomic throughput (~0.7 GB of reduction payload per train-shape call for
// 34 MB of compulsory bytes), not by HBM. The TPU's dValue kernel is
// output-stationary (it walks the query blocks that touch one block of value
// rows); the GPU's counterpart is privatisation. K3's design:
//   * a block is (b, head, a run of tile_queries consecutive queries). The
//     encoder's queries are its pixels, level by level, so a run is a strip
//     of one level, and its samples (reference point plus a few pixels of
//     offset) land in a strip of rows of each level;
//   * the tile's output gradient (its queries' channels of the block's head)
//     is staged in shared memory in f32, once;
//   * per level, each sample of the tile is worked out once, by one thread,
//     into a shared table (corner offset, a mask of the corners inside, four
//     bilinear weights times the attention weight), and a block min/max
//     gives the rows its corners touch (the band);
//   * a level whose band's pixels fit the plan's band_pixels is privatised:
//     the tile's corner adds are binned by band pixel in shared memory
//     (scatter_common.cuh: native int atomics, since sm_90's shared f32
//     atomic add is a compare-and-swap loop), then K2's lane groups take the
//     band's pixels, `lanes` lanes of VEC = 4 channels per pixel, each lane
//     summing its channels over the pixel's adds in registers and adding
//     them to the scratch with one 16-byte reduction (red.global.add.v4.f32):
//     one add per touched pixel and channel, 8 lanes covering a pixel's 128
//     contiguous bytes. A level that does not fit adds straight to the
//     scratch, a group per (query, head) and one 16-byte reduction per lane
//     and corner;
//   * the level table is a __grid_constant__ parameter, as in K1 and K2: no
//     stack;
//   * right for any locations: random ones make bands as tall as the level,
//     which take the direct adds. The plan (vec, lanes, tile_queries,
//     band_pixels) is made by ops/msda_cuda.py::dvalue_plan; this side
//     refuses one that would overrun shared memory or the grid.
// Both: coordinates, bilinear weights and every sum are f32, and the pixel
// coordinate is msda::pixel's (two roundings), so a point on a pixel centre
// takes the plain version's one-sided slope; at x = -1 (or y = -1) the slope
// is still taken.
//
// Semantics: the gradient of the 4-corner gather form of
// grid_sample(align_corners=False, padding_mode="zeros"): a corner outside
// the map contributes nothing, and d(pixel)/d(loc) is the level's width (x) or
// height (y).

#include <limits.h>

#include "msda_common.cuh"
#include "scatter_common.cuh"

namespace {

using namespace msda;

// K3's plan limits, as in ops/msda_cuda.py
constexpr int kDvTableBytes = 24;  // per sample: four weights, corner offset, corner mask
constexpr int kDvListBytes = 16;   // per sample: four binned-list entries
constexpr int kDvMaxEntries = 1 << 16;  // a list entry's low 16 bits: 4 x sample + corner
// dynamic shared memory a block may use on sm_90 (227 KB), less 1 KB for the
// kernel's static shared variables
constexpr int kMaxSmem = 232448 - 1024;

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

// K3's dynamic shared memory, in this order: the sample table (float4
// weights, then int2 corner offset and mask) padded to 16 bytes, the tile's
// output gradient in f32 (padded to 4 floats), the binned list (4 ints per
// sample), then the band's bins (band_pixels + 1 list offsets, band_pixels
// cursors).
__host__ __device__ inline int64_t dv_table_bytes(int64_t n_tab) {
  return (n_tab * kDvTableBytes + 15) & ~(int64_t)15;
}
__host__ __device__ inline int64_t dv_grad_floats(int64_t tile_queries, int64_t channels) {
  return (tile_queries * channels + 3) & ~(int64_t)3;
}
inline int64_t dv_smem_bytes(int64_t tile_queries, int64_t n_points, int64_t channels,
                             int64_t band_pixels) {
  const int64_t n_tab = tile_queries * n_points;
  return dv_table_bytes(n_tab) + 4 * dv_grad_floats(tile_queries, channels) +
         kDvListBytes * n_tab + 4 * (2 * band_pixels + 1);
}

// K3: one block per (query tile, head, b).  The tile's output gradient is
// staged in shared memory once.  Per level: the table pass puts each sample
// of the tile in shared memory once (four bilinear weights times the
// attention weight, the corner offset and a mask of the corners inside) and
// finds the rows its corners touch.  If the band of those rows fits
// band_pixels, the corner adds are binned by band pixel (scatter_common.cuh)
// and a group of `lanes` lanes per band pixel sums its adds, VEC channels a
// lane, and adds them to dvalue with one 16-byte reduction a lane; otherwise
// a group per (query, head) adds each corner straight to dvalue, one 16-byte
// reduction a lane.  An entry of the binned list is (query << 16) | (4 x
// sample + corner).
template <typename V, typename A, int VEC>
__global__ void __launch_bounds__(kThreads) msda_dvalue_kernel(
    const float* __restrict__ loc,  // (B, len_q, n_heads, n_levels, n_points, 2)
    const A* __restrict__ attn,     // (B, len_q, n_heads, n_levels, n_points)
    const V* __restrict__ grad,     // (B, len_q, n_heads * channels)
    float* __restrict__ dvalue,     // (B, len_in, n_heads, channels), zeroed
    int len_in, int len_q, int n_heads, int channels, int n_points, int lanes_log2,
    int tile_queries, int band_pixels, const __grid_constant__ Levels lv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tab = tile_queries * n_points;
  float4* s_w = reinterpret_cast<float4*>(smem);
  int2* s_oc = reinterpret_cast<int2*>(s_w + n_tab);
  float* s_g = reinterpret_cast<float*>(smem + dv_table_bytes(n_tab));
  int* s_list = reinterpret_cast<int*>(s_g + dv_grad_floats(tile_queries, channels));
  int* s_beg = s_list + 4 * n_tab;
  int* s_cur = s_beg + band_pixels + 1;
  __shared__ int s_lo[2], s_hi[2], s_warp[kThreads / 32];  // bounds by level parity

  const int q0 = blockIdx.x * tile_queries;
  const int nq = min(tile_queries, len_q - q0);
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int lanes = 1 << lanes_log2;
  const int group = threadIdx.x >> lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> lanes_log2;
  const int pix = n_heads * channels;  // stride of one pixel in dvalue
  const int n_samples = lv.n * n_points;
  const int64_t bq0 = (int64_t)b * len_q + q0;
  float* dv_b = dvalue + (int64_t)b * len_in * pix + head * channels;
  for (int e = threadIdx.x; e < nq * channels; e += kThreads) {
    const int qi = e / channels;
    s_g[e] = to_f32(grad[((bq0 + qi) * n_heads + head) * channels + (e - qi * channels)]);
  }
  if (threadIdx.x == 0) {
    s_lo[0] = INT_MAX;
    s_hi[0] = -1;
  }

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    __syncthreads();  // the last level is done with the table and the bins
    int lo = INT_MAX, hi = -1;
    for (int s = threadIdx.x; s < nq * n_points; s += kThreads) {
      const int qi = s / n_points;
      const int k = l * n_points + (s - qi * n_points);
      const int64_t bqh = (bq0 + qi) * n_heads + head;
      const float x = pixel(__ldg(loc + (bqh * n_samples + k) * 2), W);
      const float y = pixel(__ldg(loc + (bqh * n_samples + k) * 2 + 1), H);
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      int2 oc = make_int2(0, 0);
      if (x > -1.f && y > -1.f && x < (float)W && y < (float)H) {
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float fx = x - x0f;
        const float fy = y - y0f;
        const float gx = 1.f - fx;
        const float gy = 1.f - fy;
        const float a = to_f32(attn[bqh * n_samples + k]);
        w = make_float4(gy * gx * a, gy * fx * a, fy * gx * a, fy * fx * a);
        oc.x = y0 * W + x0;
        oc.y = (y0 >= 0 && x0 >= 0 ? 1 : 0) | (y0 >= 0 && x0 + 1 < W ? 2 : 0) |
               (y0 + 1 < H && x0 >= 0 ? 4 : 0) | (y0 + 1 < H && x0 + 1 < W ? 8 : 0);
        lo = min(lo, max(y0, 0));
        hi = max(hi, min(y0 + 1, H - 1));
      }
      s_w[s] = w;
      s_oc[s] = oc;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_lo[l & 1], lo);
      atomicMax(&s_hi[l & 1], hi);
    }
    __syncthreads();
    lo = s_lo[l & 1];
    hi = s_hi[l & 1];
    if (threadIdx.x == 0) {
      s_lo[(l + 1) & 1] = INT_MAX;
      s_hi[(l + 1) & 1] = -1;
    }
    if (hi < lo) continue;  // no sample of the tile has a corner in this level

    const int shift = lo * W;
    const int n_pix = (hi - lo + 1) * W;  // the band: rows lo .. hi of the level
    float* dv_l = dv_b + (int64_t)lv.start[l] * pix;
    if (n_pix <= band_pixels) {
      scatter::bin_entries(
          4 * nq * n_points, n_pix,
          [&](int e) {
            const int2 oc = s_oc[e >> 2];
            const int k = e & 3;
            return (oc.y >> k) & 1 ? oc.x + (k & 1) + (k >> 1) * W - shift : -1;
          },
          [&](int e) { return ((e >> 2) / n_points) << 16 | e; }, s_beg, s_cur, s_list, s_warp);
      const float* wt = reinterpret_cast<const float*>(s_w);
      for (int p = group; p < n_pix; p += groups) {
        const int t0 = s_beg[p];
        const int t1 = s_beg[p + 1];
        if (t0 == t1) continue;  // no add lands on this pixel
        float* out = dv_l + (int64_t)(shift + p) * pix;
        for (int c0 = lane * VEC; c0 < channels; c0 += lanes * VEC) {
          float acc[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
          for (int t = t0; t < t1; ++t) {
            const int code = s_list[t];
            const float w = wt[code & 0xffff];
            const float* gq = s_g + (code >> 16) * channels + c0;
            if constexpr (VEC == 4) {
              const float4 gv = *reinterpret_cast<const float4*>(gq);
              acc[0] += w * gv.x;
              acc[1] += w * gv.y;
              acc[2] += w * gv.z;
              acc[3] += w * gv.w;
            } else {
              acc[0] += w * gq[0];
            }
          }
          if constexpr (VEC == 4) {
            scatter::red_add_v4(out + c0, make_float4(acc[0], acc[1], acc[2], acc[3]));
          } else {
            atomicAdd(out + c0, acc[0]);
          }
        }
      }
    } else {
      for (int qi = group; qi < nq; qi += groups) {
        for (int c0 = lane * VEC; c0 < channels; c0 += lanes * VEC) {
          const float* gq = s_g + qi * channels + c0;
          float g[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) g[i] = gq[i];
          for (int pt = 0; pt < n_points; ++pt) {
            const float4 w4 = s_w[qi * n_points + pt];
            const int2 oc = s_oc[qi * n_points + pt];
            const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (!((oc.y >> k) & 1)) continue;
              float* d = dv_l + (int64_t)(oc.x + (k & 1) + (k >> 1) * W) * pix + c0;
              if constexpr (VEC == 4) {
                scatter::red_add_v4(d, make_float4(wk[k] * g[0], wk[k] * g[1], wk[k] * g[2],
                                                   wk[k] * g[3]));
              } else {
                atomicAdd(d, wk[k] * g[0]);
              }
            }
          }
        }
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

template <typename V, typename A, int VEC>
int launch_dvalue(const float* loc, const void* attn, const void* grad, float* dvalue,
                  const dim3& grid, int smem, int len_in, int len_q, int n_heads,
                  int channels, int n_points, int lanes_log2, int tile_queries,
                  int band_pixels, const Levels& lv, cudaStream_t stream) {
  // above 48 KB of shared memory, static and dynamic together, a kernel
  // must opt in: once, to the most a plan may ask
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        msda_dvalue_kernel<V, A, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  msda_dvalue_kernel<V, A, VEC><<<grid, kThreads, (size_t)smem, stream>>>(
      loc, static_cast<const A*>(attn), static_cast<const V*>(grad), dvalue, len_in, len_q,
      n_heads, channels, n_points, lanes_log2, tile_queries, band_pixels, lv);
  return (int)cudaGetLastError();
}

template <typename V, typename A>
int launch_dvalue(const float* loc, const void* attn, const void* grad, float* dvalue,
                  int vec, const dim3& grid, int smem, int len_in, int len_q, int n_heads,
                  int channels, int n_points, int lanes_log2, int tile_queries,
                  int band_pixels, const Levels& lv, cudaStream_t stream) {
  if (vec == 4 && channels % 4 == 0 && aligned16(dvalue))
    return launch_dvalue<V, A, 4>(loc, attn, grad, dvalue, grid, smem, len_in, len_q, n_heads,
                                  channels, n_points, lanes_log2, tile_queries, band_pixels, lv,
                                  stream);
  if (vec == 1)
    return launch_dvalue<V, A, 1>(loc, attn, grad, dvalue, grid, smem, len_in, len_q, n_heads,
                                  channels, n_points, lanes_log2, tile_queries, band_pixels, lv,
                                  stream);
  return (int)cudaErrorInvalidValue;
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
// vec (4 or 1), lanes_log2, tile_queries and band_pixels come from
// dvalue_plan (ops/msda_cuda.py).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan that would overrun shared
// memory, the grid or the binned list's 16-bit fields, or write misaligned.
extern "C" int msda_bwd_dvalue(const void* loc, const void* attn,
                               const void* grad, void* dvalue, int value_dtype,
                               int attn_dtype, int batch, int len_in, int len_q,
                               int n_heads, int channels, int n_levels,
                               int n_points, const int* level_hws, int vec,
                               int lanes_log2, int tile_queries, int band_pixels,
                               void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_levels, level_hws)) return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * len_q * n_heads * channels == 0) return 0;
  const int64_t smem = dv_smem_bytes(tile_queries, n_points, channels, band_pixels);
  if (lanes_log2 < 0 || lanes_log2 > 5 || tile_queries < 1 || n_points < 1 ||
      band_pixels < 0 || smem > kMaxSmem || 4 * (int64_t)tile_queries * n_points > kDvMaxEntries ||
      n_heads > 65535 || batch > 65535 || (int64_t)len_in * n_heads * channels > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((int64_t)len_q + tile_queries - 1) / tile_queries),
                  (unsigned)n_heads, (unsigned)batch);
  const float* l = static_cast<const float*>(loc);
  float* dv = static_cast<float*>(dvalue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    return launch_dvalue<float, float>(l, attn, grad, dv, vec, grid, (int)smem, len_in, len_q, n_heads, channels, n_points, lanes_log2, tile_queries, band_pixels, lv, s);
  } else if (value_dtype == 0 && attn_dtype == 1) {
    return launch_dvalue<float, __nv_bfloat16>(l, attn, grad, dv, vec, grid, (int)smem, len_in, len_q, n_heads, channels, n_points, lanes_log2, tile_queries, band_pixels, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    return launch_dvalue<__nv_bfloat16, float>(l, attn, grad, dv, vec, grid, (int)smem, len_in, len_q, n_heads, channels, n_points, lanes_log2, tile_queries, band_pixels, lv, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    return launch_dvalue<__nv_bfloat16, __nv_bfloat16>(l, attn, grad, dv, vec, grid, (int)smem, len_in, len_q, n_heads, channels, n_points, lanes_log2, tile_queries, band_pixels, lv, s);
  }
  return (int)cudaErrorInvalidValue;
}
