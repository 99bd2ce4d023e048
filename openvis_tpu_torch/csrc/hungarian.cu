// Batched exact min-cost assignment (K4) for Hopper (sm_90a).
//
// Replaces: openvis_tpu/ops/hungarian_pallas.py::_kernel (via _entry and
// batched_hungarian_pallas), the e-maxx / Jonker-Volgenant shortest augmenting
// path solver, one program per batch item.  Same semantics: rows are targets,
// N <= M, every row gets a distinct column, the result is int32 col_of_row,
// and the Dijkstra argmin breaks ties toward the lowest column, as jnp.argmin
// does.
//
// What bounds it on this card: latency, not bytes or flops.  A 100 x 100
// problem is 40 KB of cost and a few hundred sequential Dijkstra steps, each an
// O(M) update followed by an argmin; nothing is reused across problems.
// Design against that:
//   * one thread block per problem, so all problems of a batch run at once;
//   * the cost rows and the whole solver state (u, v, p, minv, way, used) live
//     in shared memory, so a step touches no device memory;
//   * the O(M) column update of a step is spread over the block's threads,
//     each thread owning the columns j = tid + k * blockDim (so a column's
//     minv, way, v and used are only ever touched by its owner), and the
//     argmin is a warp-shuffle plus cross-warp reduction that keeps the lowest
//     index on ties;
//   * the augmenting-path walk and the row loop are sequential, separated by
//     __syncthreads();
//   * both inner loops are bounded by M + 1 steps, so a non-finite cost gives
//     an unspecified assignment instead of a kernel that never ends.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kInf = 1e15f;  // openvis_tpu/ops/hungarian_pallas.py _INF
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use on sm_90

size_t smem_bytes(int n, int m) {
  // floats: cost n*m, u n, v m+1, minv m; ints: p m+1, way m, used m+1
  return 4 * ((size_t)n * m + n + (size_t)(m + 1) + m + (m + 1) + m + (m + 1));
}

__device__ __forceinline__ void keep_min(float& v, int& j, float ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__global__ void __launch_bounds__(kMaxThreads) hungarian_kernel(
    const float* __restrict__ cost,  // (B, n, m)
    int* __restrict__ col_of_row,    // (B, n)
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
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
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
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oj = __shfl_down_sync(0xffffffffu, bj, off);
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

    if (tid == 0) {
      for (int step = 0; step <= m && j0 != m; ++step) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  int* out = col_of_row + (size_t)blockIdx.x * n;
  for (int j = tid; j < m; j += nt) {
    const int r = p[j];
    if (r >= 0) out[r] = j;
  }
}

}  // namespace

// cost: device (batch, n, m) float32, n <= m; col_of_row: device (batch, n)
// int32.  Returns cudaGetLastError() (or the error that refused the launch).
extern "C" int hungarian_solve(const float* cost, int* col_of_row, int batch,
                               int n, int m, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > m) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, m);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((m + 1 + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  hungarian_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, col_of_row, n, m);
  return (int)cudaGetLastError();
}
