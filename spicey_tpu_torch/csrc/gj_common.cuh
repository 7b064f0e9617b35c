// The one-hot-pivot Gauss-Jordan elimination shared by kernels K1-K4, K8
// and K9 (K5, K7 and the panel tier of gj_panel.cuh, K10a/K10b's too,
// take its pivot ranking, better()), templated on the element type: P = 1
// real plane, P = 2 complex (re, im) planes.
//
// Semantics are those of the plain versions in
// spicey_tpu_torch/ops/linsolve.py: the pivot of column k is the unused
// row with the largest score (|a| real, |a|^2 complex), ties to the lowest
// row, NaN ranked highest; the pivot is accepted when score >= thr (thr =
// eps real, eps^2 complex), and elimination continues through a rejected
// pivot with a unit divisor, so control flow never depends on the data.
// block_gj and thread_gj update every row, the pivot row included, over
// all w columns, as the plain versions update them; warp_gj,
// reg_gj_real and reg_gj_inv_real only the columns right of the pivot,
// the only ones read later.
//
// Five layouts here, and a sixth in gj_panel.cuh:
//   block_gj   one block per system, the (n, w) planes row-major in shared
//              memory or a global workspace, thread-strided updates with a
//              barrier per step (K1-K4 when their block tier is forced);
//   warp_gj    one warp per system, n <= 32, row i in lane i, the planes in
//              the warp's own slice of shared memory; the pivot search is a
//              shuffle argmax and the only barrier is __syncwarp (the warp
//              tier of K1-K4, on [A | b] or [A | I]: warp_solve_kernel,
//              warp_inverse_kernel);
//   thread_gj  one thread per system, element q of plane c at
//              a[c][q * stride] (the system index fastest, so a warp's
//              accesses are consecutive words), no barriers (K2/K3 up to
//              THREAD_MAX_N, the shared forms of K8 and K9);
//   reg_gj_real one thread per real system in its registers, N a template
//              constant (the register forms of K8 and K9; K5's complex
//              reg_gj is its counterpart), and reg_gj_inv_real, the
//              inverse in place (K3's register form);
//   multi_solve_kernel one warp per system of [A | B] with r right-hand
//              sides: warp_gj factors A, then each lane streams its
//              columns of B through the recorded steps (K1's and K2's
//              "multi" entry, the Schur tier's block solves);
//   gj_panel.cuh: one block per system in panels of 16 (or 32) columns,
//              the trailing columns updated by one product per panel (the
//              panel tier of K1, K2 and K4; K10a/K10b with their own step).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gj {

constexpr size_t SMEM_MAX = 232448;  // opt-in shared memory of one block
constexpr int THREAD_MAX_N = 16;     // 4-bit pivot rows packed in 64 bits

// (s, r) beats (best_s, best_r): larger score, ties to the lower row, and
// NaN above everything, as torch.argmax and jnp.argmax rank it (a NaN
// pivot then fails the score >= thr test and flags the system).
template <typename T>
__device__ __forceinline__ bool better(T s, int r, T best_s, int best_r) {
  bool s_nan = s != s, b_nan = best_s != best_s;
  if (s_nan || b_nan) return s_nan && (!b_nan || r < best_r);
  return s > best_s || (s == best_s && r < best_r);
}

template <typename T, int P>
__device__ __forceinline__ T score(T* const (&a)[P], size_t q) {
  if constexpr (P == 1) {
    return fabs(a[0][q]);
  } else {
    T r = a[0][q], i = a[1][q];
    return r * r + i * i;
  }
}

// ---- one block per system ------------------------------------------------

// The pivot search of column k by a whole block (blockDim.x a multiple of
// 32): each thread's best over its rows (ascending, so a strict > keeps
// the lowest row on ties), then a warp reduction whose lane 0 leaves the
// warp's best in red_s/red_r[warp]. After a barrier one thread takes
// block_best (block_gj's).
template <typename T, int P>
__device__ __forceinline__ void warp_best(T* const (&a)[P], int n, int w,
                                          int k, const int* used, T* red_s,
                                          int* red_r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T best_s = T(-2);
  int best_r = n;
  for (int i = tid; i < n; i += nt) {
    T sc = used[i] ? T(-1) : score<T, P>(a, (size_t)i * w + k);
    if (better(sc, i, best_s, best_r)) { best_s = sc; best_r = i; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    T os = __shfl_down_sync(0xffffffffu, best_s, off);
    int orow = __shfl_down_sync(0xffffffffu, best_r, off);
    if (better(os, orow, best_s, best_r)) { best_s = os; best_r = orow; }
  }
  if ((tid & 31) == 0) { red_s[tid >> 5] = best_s; red_r[tid >> 5] = best_r; }
}

// The block's pivot row from the warps' bests.
template <typename T>
__device__ __forceinline__ int block_best(const T* red_s, const int* red_r,
                                          int nwarps) {
  T bs = red_s[0];
  int br = red_r[0];
  for (int q = 1; q < nwarps; ++q)
    if (better(red_s[q], red_r[q], bs, br)) {
      bs = red_s[q];
      br = red_r[q];
    }
  return br;
}

// Shared-memory bytes of block_gj's scratch for an (n, w) system, plus
// the planes themselves when they live in shared memory.
template <typename T, int P>
__host__ __device__ inline size_t block_smem_bytes(int n, int w,
                                                   bool planes_in_smem) {
  size_t t_count = (size_t)P * w + (size_t)P * n + 32 + 4;
  if (planes_in_smem) t_count += (size_t)P * n * w;
  return t_count * sizeof(T) + (32 + 2 * (size_t)n + 2) * sizeof(int);
}

template <typename T, int P>
struct BlockScratch {
  T* prow[P];
  T* f[P];
  T* red_s;
  T* piv;  // pivot value(s) and divisor
  int* red_r;
  int* perm;  // perm[k] = pivot row of column k
  int* used;
  int* pivot_row;
  int* ok_all;
};

// Carve the scratch from ``base`` (shared memory after the planes).
template <typename T, int P>
__device__ inline BlockScratch<T, P> carve(T* base, int n, int w) {
  BlockScratch<T, P> s;
  for (int c = 0; c < P; ++c) s.prow[c] = base + c * w;
  base += P * w;
  for (int c = 0; c < P; ++c) s.f[c] = base + c * n;
  base += P * n;
  s.red_s = base;
  s.piv = base + 32;
  s.red_r = reinterpret_cast<int*>(s.piv + 4);
  s.perm = s.red_r + 32;
  s.used = s.perm + n;
  s.pivot_row = s.used + n;
  s.ok_all = s.pivot_row + 1;
  return s;
}

// Eliminate the (n, w) system in ``a`` with every thread of the block.
// Leaves the reduced planes in ``a``, the pivot rows in s.perm and the
// validity in *s.ok_all (all visible to every thread on return).
template <typename T, int P>
__device__ void block_gj(T* const (&a)[P], int n, int w, T thr,
                         const BlockScratch<T, P>& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = (nt + 31) >> 5;
  const int nw = n * w;
  for (int i = tid; i < n; i += nt) s.used[i] = 0;
  if (tid == 0) *s.ok_all = 1;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    warp_best<T, P>(a, n, w, k, s.used, s.red_s, s.red_r);
    __syncthreads();
    if (tid == 0) {
      const int br = block_best(s.red_s, s.red_r, nwarps);
      const size_t pq = (size_t)br * w + k;
      if constexpr (P == 1) {
        T pv = a[0][pq];
        bool ok = fabs(pv) >= thr;
        if (!ok) *s.ok_all = 0;
        s.piv[0] = ok ? pv : T(1);  // the divisor
      } else {
        T pvr = a[0][pq], pvi = a[1][pq];
        T d = pvr * pvr + pvi * pvi;
        bool ok = d >= thr;
        if (!ok) *s.ok_all = 0;
        s.piv[0] = pvr;
        s.piv[1] = pvi;
        s.piv[2] = T(1) / (ok ? d : T(1));
      }
      *s.pivot_row = br;
      s.used[br] = 1;
      s.perm[k] = br;
    }
    __syncthreads();
    const int p = *s.pivot_row;
    for (int j = tid; j < w; j += nt) {
      const size_t pq = (size_t)p * w + j;
      if constexpr (P == 1) {
        s.prow[0][j] = a[0][pq] / s.piv[0];
      } else {
        T prr = a[0][pq], pri = a[1][pq];
        T pvr = s.piv[0], pvi = s.piv[1], inv_d = s.piv[2];
        s.prow[0][j] = (prr * pvr + pri * pvi) * inv_d;
        s.prow[1][j] = (pri * pvr - prr * pvi) * inv_d;
      }
    }
    for (int i = tid; i < n; i += nt)
      for (int c = 0; c < P; ++c)
        s.f[c][i] = i == p ? T(0) : a[c][(size_t)i * w + k];
    __syncthreads();
    for (int idx = tid; idx < nw; idx += nt) {
      int i = idx / w, j = idx - i * w;
      if (i == p) {
        for (int c = 0; c < P; ++c) a[c][idx] = s.prow[c][j];
      } else if constexpr (P == 1) {
        a[0][idx] = a[0][idx] - s.f[0][i] * s.prow[0][j];
      } else {
        T fr = s.f[0][i], fi = s.f[1][i];
        a[0][idx] = a[0][idx] - (fr * s.prow[0][j] - fi * s.prow[1][j]);
        a[1][idx] = a[1][idx] - (fr * s.prow[1][j] + fi * s.prow[0][j]);
      }
    }
    __syncthreads();
  }
}

// ---- one warp per system ---------------------------------------------------

constexpr int WARP_MAX_N = 32;

// Eliminate one (n, w) system, n <= WARP_MAX_N, by the calling warp (all
// 32 lanes call it; every shuffle names the full mask). Row i lives in
// lane i at a[c][i * ld + j] in the warp's own shared memory (ld odd, so
// the lanes' rows fall in distinct banks). Each step: a butterfly argmax
// by __shfl_xor_sync ranks the lanes' column entries with better(), so
// every lane ends with the same pivot row; the pivot value comes from its
// lane by a shuffle; the lanes divide the pivot row's later columns among
// themselves (lane l takes l, l + 32), then each other row subtracts its
// factor times that row. Columns <= k are left as they are: no later step
// and no answer reads them (the solve reads column n). Returns validity;
// lane k's ``perm_k`` is the pivot row of column k.
template <typename T, int P>
__device__ bool warp_gj(T* const (&a)[P], int n, int w, int ld, T thr,
                        int& perm_k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool has_row = lane < n;
  bool used = false, ok_all = true;
  perm_k = 0;
  for (int k = 0; k < n; ++k) {
    T e[P];
    for (int c = 0; c < P; ++c)
      e[c] = has_row ? a[c][lane * ld + k] : T(0);
    T best_s;
    if (!has_row) {
      best_s = T(-2);
    } else if (used) {
      best_s = T(-1);
    } else if constexpr (P == 1) {
      best_s = fabs(e[0]);
    } else {
      best_s = e[0] * e[0] + e[1] * e[1];
    }
    int best_r = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const T os = __shfl_xor_sync(full, best_s, off);
      const int orow = __shfl_xor_sync(full, best_r, off);
      if (better(os, orow, best_s, best_r)) { best_s = os; best_r = orow; }
    }
    const int p = best_r;
    T pv[P];
    for (int c = 0; c < P; ++c) pv[c] = __shfl_sync(full, e[c], p);
    if (lane == p) used = true;
    if (lane == k) perm_k = p;
    T* prow[P];
    for (int c = 0; c < P; ++c) prow[c] = a[c] + p * ld;
    if constexpr (P == 1) {
      const bool ok = fabs(pv[0]) >= thr;
      ok_all = ok_all && ok;
      const T d = ok ? pv[0] : T(1);
      for (int j = k + 1 + lane; j < w; j += 32) prow[0][j] = prow[0][j] / d;
    } else {
      const T d = pv[0] * pv[0] + pv[1] * pv[1];
      const bool ok = d >= thr;
      ok_all = ok_all && ok;
      const T inv_d = T(1) / (ok ? d : T(1));
      for (int j = k + 1 + lane; j < w; j += 32) {
        const T prr = prow[0][j], pri = prow[1][j];
        prow[0][j] = (prr * pv[0] + pri * pv[1]) * inv_d;
        prow[1][j] = (pri * pv[0] - prr * pv[1]) * inv_d;
      }
    }
    __syncwarp();
    if (has_row && lane != p) {
      T* row[P];
      for (int c = 0; c < P; ++c) row[c] = a[c] + lane * ld;
      if constexpr (P == 1) {
        const T f = e[0];
        for (int j = k + 1; j < w; ++j) row[0][j] = row[0][j] - f * prow[0][j];
      } else {
        const T fr = e[0], fi = e[1];
        for (int j = k + 1; j < w; ++j) {
          const T qr = prow[0][j], qi = prow[1][j];
          row[0][j] = row[0][j] - (fr * qr - fi * qi);
          row[1][j] = row[1][j] - (fr * qi + fi * qr);
        }
      }
    }
    __syncwarp();
  }
  return ok_all;
}

constexpr int WARPS_PER_BLOCK = 4;

// Shared-memory bytes of a warp-tier block solving (n, n) systems: per
// warp, P planes of n rows at the odd stride (n + 1) | 1.
template <typename T, int P>
__host__ __device__ inline size_t warp_smem_bytes(int n) {
  return (size_t)WARPS_PER_BLOCK * P * n * ((n + 1) | 1) * sizeof(T);
}

// The warp tier's solve: warp q of block b solves system
// b * WARPS_PER_BLOCK + q of A (B, n, n) and b (B, n) per plane, loading it
// with the warp's own coalesced reads; no block barrier anywhere.
template <typename T, int P>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    warp_solve_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                      const T* __restrict__ b0, const T* __restrict__ b1,
                      T* __restrict__ x0, T* __restrict__ x1,
                      uint8_t* __restrict__ valid_out, int batch, int n,
                      T thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (sys >= batch) return;  // the whole warp: no barrier follows
  const int ld = (n + 1) | 1, nn = n * n;
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * P * n * ld;
  T* a[P];
  for (int c = 0; c < P; ++c) a[c] = base + (size_t)c * n * ld;
  const T* A[2] = {A0 + sys * nn, P == 2 ? A1 + sys * nn : nullptr};
  const T* b[2] = {b0 + sys * n, P == 2 ? b1 + sys * n : nullptr};
  for (int idx = lane; idx < nn; idx += 32) {
    const int i = idx / n, j = idx - i * n;
    for (int c = 0; c < P; ++c) a[c][i * ld + j] = A[c][idx];
  }
  for (int i = lane; i < n; i += 32)
    for (int c = 0; c < P; ++c) a[c][i * ld + n] = b[c][i];
  __syncwarp();
  int perm_k;
  const bool ok = warp_gj<T, P>(a, n, n + 1, ld, thr, perm_k);
  // pivot row perm[k] (held by lane k) carries x[k] in column n
  T* x[2] = {x0, x1};
  if (lane < n)
    for (int c = 0; c < P; ++c) x[c][sys * n + lane] = a[c][perm_k * ld + n];
  if (lane == 0) valid_out[sys] = ok ? 1 : 0;
}

// Shared-memory bytes of a warp-tier inverse block: per warp, P planes of
// n rows of [A | I] at the odd stride 2n + 1.
template <typename T, int P>
__host__ __device__ inline size_t warp_inverse_smem_bytes(int n) {
  return (size_t)WARPS_PER_BLOCK * P * n * ((2 * n) | 1) * sizeof(T);
}

// The warp tier's inverse (K3 real, P = 1; K4 complex, P = 2): warp q of
// block b inverts system b * WARPS_PER_BLOCK + q of A (B, n, n) per plane
// by warp_gj on [A | I] in its own slice of shared memory, and writes the
// true inverse M (B, n, n) per plane: row k is the right block of pivot
// row perm[k] (lane k holds perm[k]), consecutive lanes storing
// consecutive elements. No block barrier anywhere.
template <typename T, int P>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    warp_inverse_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                        T* __restrict__ M0, T* __restrict__ M1,
                        uint8_t* __restrict__ valid_out, int batch, int n,
                        T thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (sys >= batch) return;  // the whole warp: no barrier follows
  const int w = 2 * n, ld = w | 1, nn = n * n;
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * P * n * ld;
  T* a[P];
  for (int c = 0; c < P; ++c) a[c] = base + (size_t)c * n * ld;
  const T* A[2] = {A0 + sys * nn, P == 2 ? A1 + sys * nn : nullptr};
  for (int idx = lane; idx < nn; idx += 32) {
    const int i = idx / n, j = idx - i * n;
    for (int c = 0; c < P; ++c) a[c][i * ld + j] = A[c][idx];
  }
  if (lane < n)
    for (int j = 0; j < n; ++j)
      for (int c = 0; c < P; ++c)
        a[c][lane * ld + n + j] = c == 0 && j == lane ? T(1) : T(0);
  __syncwarp();
  int perm_k;
  const bool ok = warp_gj<T, P>(a, n, w, ld, thr, perm_k);
  T* M[2] = {M0 + sys * nn, P == 2 ? M1 + sys * nn : nullptr};
  for (int i0 = 0; i0 < nn; i0 += 32) {
    const int idx = i0 + lane, k = min(idx / n, n - 1);
    const int pk = __shfl_sync(0xffffffffu, perm_k, k);
    if (idx < nn)
      for (int c = 0; c < P; ++c)
        M[c][idx] = a[c][pk * ld + n + idx - k * n];
  }
  if (lane == 0) valid_out[sys] = ok ? 1 : 0;
}

// Launch the warp tier's inverse on ``stream``.
template <typename T, int P>
int warp_inverse_launch(const void* A0, const void* A1, void* M0, void* M1,
                        void* valid, int batch, int n, T thr, void* stream) {
  if (n < 1 || n > WARP_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = warp_inverse_smem_bytes<T, P>(n);
  cudaError_t err = cudaFuncSetAttribute(
      warp_inverse_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int blocks = (int)(((long long)batch + WARPS_PER_BLOCK - 1) /
                             WARPS_PER_BLOCK);
    warp_inverse_kernel<T, P><<<blocks, 32 * WARPS_PER_BLOCK, smem,
                                (cudaStream_t)stream>>>(
        (const T*)A0, (const T*)A1, (T*)M0, (T*)M1, (uint8_t*)valid, batch,
        n, thr);
  }
  return (int)cudaGetLastError();
}

// Launch the warp tier on ``stream``.
template <typename T, int P>
int warp_launch(const void* A0, const void* A1, const void* b0,
                const void* b1, void* x0, void* x1, void* valid, int batch,
                int n, T thr, void* stream) {
  if (n < 1 || n > WARP_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = warp_smem_bytes<T, P>(n);
  cudaError_t err = cudaFuncSetAttribute(
      warp_solve_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int blocks = (int)(((long long)batch + WARPS_PER_BLOCK - 1) /
                             WARPS_PER_BLOCK);
    warp_solve_kernel<T, P><<<blocks, 32 * WARPS_PER_BLOCK, smem,
                              (cudaStream_t)stream>>>(
        (const T*)A0, (const T*)A1, (const T*)b0, (const T*)b1, (T*)x0,
        (T*)x1, (uint8_t*)valid, batch, n, thr);
  }
  return (int)cudaGetLastError();
}

// ---- many right-hand sides: one warp per system, factor then stream ------

// K1's and K2's "multi" entry, [A | B] for a right block B of r columns
// (the Schur tier's block solves, ops/schur.py: n = 3-4 unknowns, r = 1 +
// N_I = 69-515 columns, K x F of them). Neither the warp tier (a row per
// lane: 4 of 32 lanes would sweep all r columns) nor the panel tier (a
// block per system, n >= 33) fits that shape. So the work is split where
// its arithmetic splits: the pivot order and the multipliers depend on A
// alone, and each column of B then takes the same n steps on its own.
//   1. Factor: the warp reduces A (n x n, n <= WARP_MAX_N) with warp_gj at
//      width n. warp_gj never touches a column at or left of its step, so
//      afterwards a[i][k] holds row i's multiplier of step k (i != p_k)
//      and a[p_k][k] the undivided pivot; lane k leaves p_k in piv[k] and
//      the step's divisor (real: pv, or 1 for a rejected pivot; complex:
//      pv and 1 / |pv|^2, or 1) in stp.
//   2. Stream: lane l takes columns l, l + 32, ... of B. A column's n
//      entries go to the lane's own slot of shared memory (entry i at
//      i * 32 + l: the warp's slots fall in distinct banks), take the n
//      steps there (pivot row entry / pivot, every other row minus its
//      multiplier times that; the plain versions' arithmetic, column by
//      column), and leave un-permuted, row k of X from pivot row p_k,
//      consecutive lanes writing consecutive columns.
// No barrier but the __syncwarp after each phase's writes. Bound: the
// bytes of B in and X out (16 n r bytes per complex f64 system against
// ~8 n^2 r flops), once r is past a few columns.

constexpr int MULTI_WARPS = 4;  // systems (warps) per block

// Shared-memory bytes of one warp of multi_solve_kernel: the (n, n) planes
// at the odd stride n | 1, one n-entry column slot per lane and plane,
// three step values per column, then the n pivot rows; padded to 16 so
// the next warp's doubles stay aligned.
template <typename T, int P>
__host__ __device__ inline size_t multi_warp_bytes(int n) {
  const size_t vals = (size_t)P * n * (n | 1) + (size_t)P * n * 32 + 3 * n;
  const size_t bytes = vals * sizeof(T) + (size_t)n * sizeof(int);
  return (bytes + 15) & ~(size_t)15;
}

// Warp q of block b solves system b * MULTI_WARPS + q of A (B, n, n) and
// B (B, n, r) per plane into X (B, n, r) per plane; valid as bytes.
template <typename T, int P>
__global__ void __launch_bounds__(32 * MULTI_WARPS)
    multi_solve_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                       const T* __restrict__ B0, const T* __restrict__ B1,
                       T* __restrict__ X0, T* __restrict__ X1,
                       uint8_t* __restrict__ valid_out, int batch, int n,
                       int r, T thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * MULTI_WARPS + warp;
  if (sys >= batch) return;  // the whole warp: no barrier follows
  const int ld = n | 1, nn = n * n;
  T* base = reinterpret_cast<T*>(smem_raw + (size_t)warp *
                                                multi_warp_bytes<T, P>(n));
  T* a[P];
  T* col[P];
  for (int c = 0; c < P; ++c) a[c] = base + (size_t)c * n * ld;
  base += (size_t)P * n * ld;
  for (int c = 0; c < P; ++c) col[c] = base + (size_t)c * n * 32 + lane;
  base += (size_t)P * n * 32;
  T* stp = base;
  int* piv = reinterpret_cast<int*>(base + 3 * n);

  // ---- 1. factor A ----------------------------------------------------
  const T* A[2] = {A0 + sys * nn, P == 2 ? A1 + sys * nn : nullptr};
  for (int idx = lane; idx < nn; idx += 32) {
    const int i = idx / n, j = idx - i * n;
    for (int c = 0; c < P; ++c) a[c][i * ld + j] = A[c][idx];
  }
  __syncwarp();
  int perm_k;
  const bool ok = warp_gj<T, P>(a, n, n, ld, thr, perm_k);
  if (lane < n) {
    piv[lane] = perm_k;
    const int q = perm_k * ld + lane;
    if constexpr (P == 1) {
      const T pv = a[0][q];
      stp[lane] = fabs(pv) >= thr ? pv : T(1);
    } else {
      const T pvr = a[0][q], pvi = a[1][q];
      const T d = pvr * pvr + pvi * pvi;
      stp[3 * lane] = pvr;
      stp[3 * lane + 1] = pvi;
      stp[3 * lane + 2] = T(1) / (d >= thr ? d : T(1));
    }
  }
  __syncwarp();

  // ---- 2. stream the columns of B ---------------------------------------
  const size_t off = (size_t)sys * n * r;
  const T* Bp[2] = {B0 + off, P == 2 ? B1 + off : nullptr};
  T* Xp[2] = {X0 + off, P == 2 ? X1 + off : nullptr};
  for (int j = lane; j < r; j += 32) {
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < P; ++c) col[c][i * 32] = Bp[c][(size_t)i * r + j];
    for (int k = 0; k < n; ++k) {
      const int p = piv[k];
      if constexpr (P == 1) {
        const T xp = col[0][p * 32] / stp[k];
        col[0][p * 32] = xp;
        for (int i = 0; i < n; ++i)
          if (i != p) col[0][i * 32] = col[0][i * 32] - a[0][i * ld + k] * xp;
      } else {
        const T pvr = stp[3 * k], pvi = stp[3 * k + 1];
        const T inv_d = stp[3 * k + 2];
        const T xr = col[0][p * 32], xi = col[1][p * 32];
        const T qr = (xr * pvr + xi * pvi) * inv_d;
        const T qi = (xi * pvr - xr * pvi) * inv_d;
        col[0][p * 32] = qr;
        col[1][p * 32] = qi;
        for (int i = 0; i < n; ++i) {
          if (i == p) continue;
          const T fr = a[0][i * ld + k], fi = a[1][i * ld + k];
          col[0][i * 32] = col[0][i * 32] - (fr * qr - fi * qi);
          col[1][i * 32] = col[1][i * 32] - (fr * qi + fi * qr);
        }
      }
    }
    for (int k = 0; k < n; ++k)
      for (int c = 0; c < P; ++c)
        Xp[c][(size_t)k * r + j] = col[c][piv[k] * 32];
  }
  if (lane == 0) valid_out[sys] = ok ? 1 : 0;
}

// Launch the multi entry on ``stream`` (n <= WARP_MAX_N, r >= 1).
template <typename T, int P>
int multi_launch(const void* A0, const void* A1, const void* B0,
                 const void* B1, void* X0, void* X1, void* valid, int batch,
                 int n, int r, T thr, void* stream) {
  if (n < 1 || n > WARP_MAX_N || r < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = MULTI_WARPS * multi_warp_bytes<T, P>(n);
  cudaError_t err = cudaFuncSetAttribute(
      multi_solve_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int blocks =
        (int)(((long long)batch + MULTI_WARPS - 1) / MULTI_WARPS);
    multi_solve_kernel<T, P><<<blocks, 32 * MULTI_WARPS, smem,
                               (cudaStream_t)stream>>>(
        (const T*)A0, (const T*)A1, (const T*)B0, (const T*)B1, (T*)X0,
        (T*)X1, (uint8_t*)valid, batch, n, r, thr);
  }
  return (int)cudaGetLastError();
}

// ---- one thread per system -------------------------------------------------

// Pivot row of column k from the packed permutation.
__device__ __forceinline__ int perm_at(uint64_t perm, int k) {
  return (int)((perm >> (4 * k)) & 15u);
}

// Eliminate one (n, w) system, n <= THREAD_MAX_N, by the calling thread
// alone; element q of plane c is a[c][q * stride]. Returns validity and
// the pivot rows packed 4 bits each in ``perm``.
template <typename T, int P>
__device__ bool thread_gj(T* const (&a)[P], int stride, int n, int w, T thr,
                          uint64_t& perm) {
  uint32_t used = 0;
  bool ok_all = true;
  perm = 0;
  for (int k = 0; k < n; ++k) {
    T best_s = T(-2);
    int p = 0;
    for (int i = 0; i < n; ++i) {
      const T sc = (used >> i) & 1u
                       ? T(-1)
                       : score<T, P>(a, (size_t)(i * w + k) * stride);
      if (better(sc, i, best_s, p)) { best_s = sc; p = i; }
    }
    used |= 1u << p;
    perm |= (uint64_t)p << (4 * k);
    const size_t pk = (size_t)(p * w + k) * stride;
    // normalize the pivot row in place, then eliminate column k from
    // every other row with it (the values the plain version forms)
    if constexpr (P == 1) {
      const T pv = a[0][pk];
      const bool ok = fabs(pv) >= thr;
      ok_all = ok_all && ok;
      const T d = ok ? pv : T(1);
      for (int j = 0; j < w; ++j) {
        T* e = a[0] + (size_t)(p * w + j) * stride;
        *e = *e / d;
      }
      for (int i = 0; i < n; ++i) {
        if (i == p) continue;
        const T f = a[0][(size_t)(i * w + k) * stride];
        for (int j = 0; j < w; ++j) {
          const T q = a[0][(size_t)(p * w + j) * stride];
          T* e = a[0] + (size_t)(i * w + j) * stride;
          *e = *e - f * q;
        }
      }
    } else {
      const T pvr = a[0][pk], pvi = a[1][pk];
      const T d = pvr * pvr + pvi * pvi;
      const bool ok = d >= thr;
      ok_all = ok_all && ok;
      const T inv_d = T(1) / (ok ? d : T(1));
      for (int j = 0; j < w; ++j) {
        const size_t q = (size_t)(p * w + j) * stride;
        const T prr = a[0][q], pri = a[1][q];
        a[0][q] = (prr * pvr + pri * pvi) * inv_d;
        a[1][q] = (pri * pvr - prr * pvi) * inv_d;
      }
      for (int i = 0; i < n; ++i) {
        if (i == p) continue;
        const size_t ik = (size_t)(i * w + k) * stride;
        const T fr = a[0][ik], fi = a[1][ik];
        for (int j = 0; j < w; ++j) {
          const size_t q = (size_t)(p * w + j) * stride;
          const size_t e = (size_t)(i * w + j) * stride;
          const T qr = a[0][q], qi = a[1][q];
          a[0][e] = a[0][e] - (fr * qr - fi * qi);
          a[1][e] = a[1][e] - (fr * qi + fi * qr);
        }
      }
    }
  }
  return ok_all;
}

// ---- one thread per system, in registers -----------------------------------

// |v| as an ordered integer key: the bits of |v| with every NaN folded
// onto one key above +inf. A larger key is a larger |v|, a strict > over
// the rows in ascending order keeps the lower row on ties, and NaN ranks
// highest: better()'s ranking in one integer compare.
__device__ __forceinline__ int abs_key(float v) {
  return min(__float_as_int(v) & 0x7fffffff, 0x7f800001);
}
__device__ __forceinline__ long long abs_key(double v) {
  return min(__double_as_longlong(v) & 0x7fffffffffffffffLL,
             0x7ff0000000000001LL);
}

// The single-precision quotient x / d of IEEE division (round to
// nearest), its divisions sharing one double reciprocal of d: r = 1/d to
// within 2^-52 relative (a single-precision estimate and two Newton steps
// in double), q = (double)x * r within 2^-51 of x / d, rounded once to
// float. With 24-bit significands x / d is never a midpoint between two
// floats and lies at least 2^-49 relative from every such midpoint, so q
// rounds to the float that x / d rounds to, for any x and any d with
// 2^-120 <= |d| <= 2^120, unless the quotient is subnormal (the
// argument needs 24 bits of it). There, and for d out of that range, the
// division is the compiler's: bitwise the same quotient, without a call
// to its slow path on every one.
struct Divisor {
  float d;
  double r;
  bool fast;
};

__device__ __forceinline__ Divisor divisor(float d) {
  const float ad = fabsf(d);
  const bool fast = ad >= 0x1p-120f && ad <= 0x1p120f;
  const double dd = fast ? (double)d : 1.0;
  double r = (double)__fdividef(1.0f, (float)dd);
  r = fma(r, fma(-dd, r, 1.0), r);
  r = fma(r, fma(-dd, r, 1.0), r);
  return {d, r, fast};
}

__device__ __forceinline__ float divide(float x, const Divisor& v) {
  if (v.fast) {
    const double q = (double)x * v.r;
    if (!(fabs(q) < 0x1p-126) || q == 0.0) return (float)q;
  }
  return x / v.d;
}

// Eliminate one (N, W) real system, W > N, in the calling thread's
// registers: thread_gj's arithmetic with every index a constant (N and W
// template constants, every loop unrolled, so nothing is indexed at run
// time and nothing spills). The pivot of column k is the unused row with
// the largest |a| (better()'s ranking by abs_key: ties to the lower row,
// NaN highest), gathered by a select per row; it is valid when |pv| >=
// thr, and a rejected pivot divides by 1 so that elimination goes on.
// Each pivot-row entry right of k is divided by the pivot (IEEE's
// quotient, in float by divide(): a division's result, never a product
// with a rounded reciprocal), and every other row subtracts its factor
// times that row, columns right of k only: no later step and no answer
// reads the others.
// Returns validity; x[k][c] = column N + c of the row that pivoted column
// k, read out in pivot order by a select per row (the solution of
// [A | b], or row k of the inverse of [A | I]; reg_gj_inv_real below
// inverts in half the registers).
template <typename T, int N, int W>
__device__ __forceinline__ bool reg_gj_real(T (&a)[N][W], T thr,
                                            T (&x)[N][W - N]) {
  static_assert(W > N, "reg_gj_real takes [A | right-hand sides]");
  bool used[N];
  int piv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) used[i] = false;
  bool ok_all = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    decltype(abs_key(T(0))) best = -2;
    int p = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const auto key = used[i] ? -1 : abs_key(a[i][k]);
      if (key > best) {
        best = key;
        p = i;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) used[i] = used[i] || i == p;
    piv[k] = p;
    // the pivot row, columns k..W-1, by selects
    T q[W];
#pragma unroll
    for (int j = k; j < W; ++j) {
      q[j] = a[0][j];
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (p == i) q[j] = a[i][j];
    }
    const T pv = q[k];
    const bool ok = fabs(pv) >= thr;
    ok_all = ok_all && ok;
    const T d = ok ? pv : T(1);
    if constexpr (sizeof(T) == 4) {
      const Divisor dv = divisor(d);
#pragma unroll
      for (int j = k + 1; j < W; ++j) q[j] = divide(q[j], dv);
    } else {
#pragma unroll
      for (int j = k + 1; j < W; ++j) q[j] = q[j] / d;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T f = a[i][k];
#pragma unroll
      for (int j = k + 1; j < W; ++j)
        a[i][j] = i == p ? q[j] : a[i][j] - f * q[j];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int c = 0; c < W - N; ++c) {
      x[k][c] = a[0][N + c];
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (piv[k] == i) x[k][c] = a[i][N + c];
    }
  return ok_all;
}

// Invert one (N, N) real system in the calling thread's registers, in
// place (K3's register form): the reduction of [A | I] that reg_gj_real
// runs at W = 2N, in N^2 registers instead of 2N^2 (f64 at N = 8: 64
// doubles, not 128). Before step k the identity column N + p of the
// step's pivot row p is still e_p (no earlier pivot row has an entry
// there), and after it column k of A is e_p, so step k keeps the new
// column N + p in column k: the pivot row's entry 1 / pv, every other
// row's 0 - f / pv, the values [A | I]'s column takes. Every column is
// live (columns < k hold the right block's columns of the earlier
// pivots, columns > k what is left of A), so a step updates all N of them:
// the columns right of the pivot that reg_gj_real updates, less the ones
// that are still zero. The same pivots (better()'s ranking by abs_key),
// flags and quotients (divide() in float) as reg_gj_real. On return
// a[i][m] is entry (step[i], piv[m]) of the true inverse: row step[i] of
// the inverse is the right block of row i, the row that pivoted column
// step[i], and column m holds the identity column of row piv[m].
template <typename T, int N>
__device__ __forceinline__ bool reg_gj_inv_real(T (&a)[N][N], T thr,
                                                int (&piv)[N],
                                                int (&step)[N]) {
  bool used[N];
#pragma unroll
  for (int i = 0; i < N; ++i) used[i] = false;
  bool ok_all = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    decltype(abs_key(T(0))) best = -2;
    int p = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const auto key = used[i] ? -1 : abs_key(a[i][k]);
      if (key > best) {
        best = key;
        p = i;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      used[i] = used[i] || i == p;
      if (i == p) step[i] = k;
    }
    piv[k] = p;
    // the pivot row by selects; its column k becomes the identity's 1
    T q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      q[j] = a[0][j];
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (p == i) q[j] = a[i][j];
    }
    const T pv = q[k];
    const bool ok = fabs(pv) >= thr;
    ok_all = ok_all && ok;
    const T d = ok ? pv : T(1);
    q[k] = T(1);
    if constexpr (sizeof(T) == 4) {
      const Divisor dv = divisor(d);
#pragma unroll
      for (int j = 0; j < N; ++j) q[j] = divide(q[j], dv);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) q[j] = q[j] / d;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T f = a[i][k];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T e = j == k ? T(0) : a[i][j];
        a[i][j] = i == p ? q[j] : e - f * q[j];
      }
    }
  }
  return ok_all;
}

}  // namespace gj
