// Batched exact min-cost assignment (K4) for Hopper (sm_90a).
//
// Replaces: openvis_tpu/ops/hungarian_pallas.py::_kernel (via _entry and
// batched_hungarian_pallas), the e-maxx / Jonker-Volgenant shortest augmenting
// path solver, one program per batch item.  Same semantics: rows are targets,
// N <= M, every row gets a distinct column, the result is the column of each
// row (written here as int64), and the Dijkstra argmin breaks ties toward the
// lowest column, as jnp.argmin does.  The step sequence and its f32
// arithmetic are those of ops/hungarian.py::hungarian_plain, so the assignment
// is element for element the plain version's.
//
// What bounds it on this card: latency, not bytes or flops.  A 100 x 100
// problem is 40 KB of cost and ~10^3 sequential Dijkstra steps, each an O(M)
// column update followed by an argmin; nothing is reused across problems, so
// the time of a batch is the chain of steps of its longest problem.  The
// design shortens that chain:
//   * warp solver (hungarian_warp_kernel, M + 1 <= 32 * K): one warp owns a
//     problem and is its block (the main path sends 9 or 20 problems, far
//     fewer than the 132 SMs, so each gets an SM of its own).  Lane l owns
//     the columns j = l + 32k (k < K, the virtual column M included) and keeps
//     their minv, way, v, p and used bit in registers, and u of the row each
//     column holds, so u[p[j]] += delta is a register add.  A row's u moves
//     with the row in the augmenting-path walk (owner shuffles along way);
//     the new row starts on the virtual column with u = 0.  The register
//     arrays are indexed only by unrolled constants (a warp-uniform k is a
//     select), so they stay out of local memory;
//   * the argmin is two redux.sync (__reduce_min_sync): the least order-
//     preserving uint32 key of the candidates (-0.0 made +0.0 first, so equal
//     values tie and the lowest column wins), then the least of
//     column << 8 | row + 1 among the lanes holding that key, so the next
//     step's column and row arrive together; delta is decoded from the key.
//     The winner's u, picked by its lane during its own argmin, comes with one
//     shuffle that overlaps the next row's cost loads.  No barrier in the step
//     loop, and no branch: a branch per column serialised the step's loads
//     behind convergence barriers (measured 1.8x slower);
//   * the cost rows go to shared memory with 16-byte cp.async copies, the
//     shared copy starting at the source's 16-byte phase;
//   * block solver (hungarian_block_kernel, any M whose state fits shared
//     memory): one block per problem, one column per thread, the solver state
//     in shared memory, a two-level shuffle argmin with __syncthreads between
//     the step's phases.  It is the generic instantiation: the plan
//     (ops/hungarian_cuda.py::launch_plan) sends it only problems with
//     M + 1 > 32 * K.
// Both loops of a row are bounded by M + 1 steps, so a non-finite cost gives an
// unspecified assignment instead of a kernel that never ends.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "opt_in.cuh"

namespace {

constexpr float kInf = 1e15f;  // openvis_tpu/ops/hungarian_pallas.py _INF
constexpr unsigned kFull = 0xffffffffu;
// the plan's limits, as in ops/hungarian_cuda.py
constexpr int kWarpCols = 4;                     // columns per lane
constexpr int kWarpMaxCols = 32 * kWarpCols;     // M + 1 the warp solver takes
constexpr int kBlockMaxThreads = 256;
// dynamic shared memory a block may use on sm_90 (227 KB), less 1 KB for the
// kernels' static shared variables
constexpr int kMaxSmem = 232448 - 1024;

constexpr int kWarpSolver = 0;
constexpr int kBlockSolver = 1;

// floats of one problem in the warp solver: the cost rows, shifted by up to 3
// floats to the source's 16-byte phase, rounded to 16 bytes
int64_t warp_problem_floats(int n, int m) { return ((int64_t)n * m + 3 + 3) / 4 * 4; }

int64_t block_smem_bytes(int n, int m) {
  // floats: cost n*m, u n, v m+1, minv m; ints: p m+1, way m, used m+1
  return 4 * ((int64_t)n * m + n + (m + 1) + m + (m + 1) + m + (m + 1));
}

// ---------------------------------------------------------------- warp solver

// An order-preserving key: a < b as floats iff key(a) < key(b) as unsigned,
// for all non-NaN values, with -0.0 and +0.0 equal.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x + 0.0f);  // -0.0 + 0.0 = +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a[k] for a warp-uniform k, as a chain of selects over unrolled constants
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&a)[K], int k) {
  T x = a[0];
#pragma unroll
  for (int i = 1; i < K; ++i)
    if (k == i) x = a[i];
  return x;
}

template <int K, typename T>
__device__ __forceinline__ void put(T (&a)[K], int k, T x) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (k == i) a[i] = x;
}

__device__ __forceinline__ void copy_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp, one block, one problem; dynamic shared memory: the problem's
// cost rows (warp_problem_floats floats).
template <int K>
__global__ void __launch_bounds__(32) hungarian_warp_kernel(
    const float* __restrict__ cost,     // (B, n, m)
    int64_t* __restrict__ col_of_row,   // (B, n)
    int n, int m) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int prob = blockIdx.x;

  const int nm = n * m;
  const float* src = cost + (int64_t)prob * nm;
  const int phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* c = smem + phase;  // c + head is 16-byte aligned
  const int head = min((4 - phase) & 3, nm);
  const int body = (nm - head) >> 2;
  for (int e = lane; e < head; e += 32) c[e] = src[e];
  for (int q = lane; q < body; q += 32) copy_async_16(c + head + 4 * q, src + head + 4 * q);
  for (int e = head + 4 * body + lane; e < nm; e += 32) c[e] = src[e];
  copy_async_wait();
  __syncwarp();

  const unsigned used_key = order_key(kInf);
  // the lane's columns lane + 32k: in the matrix (bit k of real), and their
  // index into a cost row, clamped into it so that every load is in bounds
  unsigned real = 0;
  int col[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    real |= (lane + 32 * k < m ? 1u : 0u) << k;
    col[k] = min(lane + 32 * k, m - 1);
  }
  float minv[K], v[K], pu[K];  // pu[k]: u of the row that column k holds
  int way[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    pu[k] = 0.f;
    p[k] = -1;
  }
  const int mk = m >> 5, ml = m & 31;  // the virtual column's register and lane

  for (int i = 0; i < n; ++i) {
    unsigned used = 0;  // bit k: column lane + 32k is used
#pragma unroll
    for (int k = 0; k < K; ++k) {
      minv[k] = kInf;
      way[k] = 0;
    }
    if (lane == ml) {
      put(p, mk, i);
      put(pu, mk, 0.f);
    }

    // the step's column j0, its row i0 = p[j0] and u[i0]; the new row starts
    // on the virtual column with u = 0
    int j0 = m, i0 = i;
    float ui0 = 0.f;
    for (int step = 0; step <= m; ++step) {
      used |= (lane == (j0 & 31) ? 1u : 0u) << (j0 >> 5);
      float cv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cv[k] = c[i0 * m + col[k]];
      // relax the free columns and take the least key, lowest column on
      // ties, with its column and row packed as sel = j << 8 | p[j] + 1 and
      // its row's u; selects only: a branch per column serialises the step
      unsigned best = kFull, sel = kFull;
      float bu = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool is_real = (real >> k) & 1u;
        const bool is_free = is_real && !((used >> k) & 1u);
        const float cur = cv[k] - ui0 - v[k];
        const bool better = is_free && cur < minv[k];
        minv[k] = better ? cur : minv[k];
        way[k] = better ? j0 : way[k];
        const unsigned key = is_free ? order_key(minv[k]) : (is_real ? used_key : kFull);
        const bool take = key < best;  // k ascends: keeps the lane's lowest column
        best = take ? key : best;
        sel = take ? ((unsigned)(lane + 32 * k) << 8 | (unsigned)(p[k] + 1)) : sel;
        bu = take ? pu[k] : bu;
      }
      const unsigned kmin = __reduce_min_sync(kFull, best);
      const unsigned s1 = __reduce_min_sync(kFull, best == kmin ? sel : kFull);
      const float delta = key_value(kmin);
      const int j1 = (int)(s1 >> 8);
      const int i1 = (int)(s1 & 0xff) - 1;  // -1: j1 is free, the path is found
      // u of j1's row, from the lane whose least column j1 is; the step's
      // update below leaves it alone (j1 is not used)
      const float ui1 = __shfl_sync(kFull, bu, j1 & 31);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool is_used = (used >> k) & 1u;  // used columns hold distinct rows
        pu[k] = is_used ? pu[k] + delta : pu[k];
        v[k] = is_used ? v[k] - delta : v[k];
        minv[k] = !is_used && ((real >> k) & 1u) ? minv[k] - delta : minv[k];
      }
      j0 = j1;
      i0 = i1;
      ui0 = ui1;
      if (i1 < 0) break;
    }

    // the augmenting path: each column takes the row (and its u) of the
    // column it was reached from
    for (int step = 0; step <= m && j0 != m; ++step) {
      const int k0 = j0 >> 5, l0 = j0 & 31;
      const int j1 = __shfl_sync(kFull, pick(way, k0), l0);
      const int k1 = j1 >> 5, l1 = j1 & 31;
      const int row = __shfl_sync(kFull, pick(p, k1), l1);
      const float urow = __shfl_sync(kFull, pick(pu, k1), l1);
      if (lane == l0) {
        put(p, k0, row);
        put(pu, k0, urow);
      }
      j0 = j1;
    }
  }

  int64_t* out = col_of_row + (int64_t)prob * n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < m && p[k] >= 0) out[p[k]] = j;
  }
}

// --------------------------------------------------------------- block solver

__device__ __forceinline__ void keep_min(float& v, int& j, float ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__global__ void __launch_bounds__(kBlockMaxThreads) hungarian_block_kernel(
    const float* __restrict__ cost,    // (B, n, m)
    int64_t* __restrict__ col_of_row,  // (B, n)
    int n, int m) {
  extern __shared__ float smem[];
  float* c = smem;                    // n * m cost rows
  float* u = c + (size_t)n * m;       // n row potentials
  float* v = u + n;                   // m + 1 column potentials
  float* minv = v + m + 1;            // m
  int* p = reinterpret_cast<int*>(minv + m);  // m + 1: row of each column, -1 free
  int* way = p + m + 1;               // m
  int* used = way + m;                // m + 1
  __shared__ float red_v[32];
  __shared__ int red_j[32];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // a multiple of 32
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;

  const float* cb = cost + (size_t)blockIdx.x * n * m;
  for (int k = tid; k < n * m; k += nt) c[k] = cb[k];
  for (int k = tid; k < n; k += nt) u[k] = 0.f;
  for (int j = tid; j <= m; j += nt) {
    v[j] = 0.f;
    p[j] = -1;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    for (int j = tid; j <= m; j += nt) {
      used[j] = 0;
      if (j < m) {
        minv[j] = kInf;
        way[j] = 0;
      }
    }
    if (tid == 0) p[m] = i;
    __syncthreads();

    int j0 = m;
    for (int step = 0; step <= m; ++step) {
      const int i0 = p[j0];
      if (i0 < 0) break;  // j0 is a free column: augmenting path found
      const float ui0 = u[i0];
      const float* crow = c + (size_t)i0 * m;
      float best = INFINITY;
      int bj = INT_MAX;
      for (int j = tid; j < m; j += nt) {
        float cand = kInf;
        if (!used[j] && j != j0) {
          const float cur = crow[j] - ui0 - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
          cand = minv[j];
        }
        if (cand < best) {  // j ascends within a thread: keeps the first
          best = cand;
          bj = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(kFull, best, off);
        const int oj = __shfl_down_sync(kFull, bj, off);
        keep_min(best, bj, ov, oj);
      }
      if (lane == 0) {
        red_v[warp] = best;
        red_j[warp] = bj;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < n_warps ? red_v[lane] : INFINITY;
        bj = lane < n_warps ? red_j[lane] : INT_MAX;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(kFull, best, off);
          const int oj = __shfl_down_sync(kFull, bj, off);
          keep_min(best, bj, ov, oj);
        }
        if (lane == 0) {
          red_v[0] = best;
          red_j[0] = bj;
        }
      }
      __syncthreads();
      const float delta = red_v[0];
      const int j1 = red_j[0];
      for (int j = tid; j <= m; j += nt) {
        if (used[j] || j == j0) {
          used[j] = 1;
          u[p[j]] += delta;  // used columns own distinct rows: no race
          v[j] -= delta;
        } else if (j < m) {
          minv[j] -= delta;
        }
      }
      __syncthreads();
      j0 = j1;
    }
    // every thread has read p[j0] before thread 0 rewrites p
    __syncthreads();

    if (tid == 0) {
      for (int step = 0; step <= m && j0 != m; ++step) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  int64_t* out = col_of_row + (size_t)blockIdx.x * n;
  for (int j = tid; j < m; j += nt) {
    const int r = p[j];
    if (r >= 0) out[r] = j;
  }
}

}  // namespace

// cost: device (batch, n, m) float32, n <= m; col_of_row: device (batch, n)
// int64.  variant (0 warp solver, 1 block solver) and smem_bytes come from
// launch_plan (ops/hungarian_cuda.py).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// beyond this side's limits or one that does not fit the problem.
extern "C" int hungarian_solve(const float* cost, int64_t* col_of_row, int batch, int n,
                               int m, int variant, int smem_bytes, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > m) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWarpSolver) {
    if (m + 1 > kWarpMaxCols || (int64_t)smem_bytes != 4 * warp_problem_floats(n, m) ||
        smem_bytes > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    static bool opted[kMaxOptInDevices] = {};
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e =
          opt_in_shared_memory(hungarian_warp_kernel<kWarpCols>, kMaxSmem, opted);
      if (e != cudaSuccess) return (int)e;
    }
    hungarian_warp_kernel<kWarpCols><<<batch, 32, smem_bytes, s>>>(cost, col_of_row, n, m);
  } else if (variant == kBlockSolver) {
    if ((int64_t)smem_bytes != block_smem_bytes(n, m) || smem_bytes > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    static bool opted[kMaxOptInDevices] = {};
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = opt_in_shared_memory(hungarian_block_kernel, kMaxSmem, opted);
      if (e != cudaSuccess) return (int)e;
    }
    int threads = ((m + 1 + 31) / 32) * 32;
    if (threads > kBlockMaxThreads) threads = kBlockMaxThreads;
    hungarian_block_kernel<<<batch, threads, smem_bytes, s>>>(cost, col_of_row, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
