// The panel tier of K1, K2 and K4: one-hot-pivot Gauss-Jordan for large N
// in panels of PW = 16 columns, one block per system, the trailing
// columns updated by one product per panel, in f64 on the tensor cores.
// K10a/K10b (mxu_gj.cu) run the same kernel with their own pivot step
// (a step policy, below): what follows describes K1/K2/K4's, DivideStep.
//
// It replaces, with block_gj and warp_gj, the TPU kernels
// spicey_tpu/ops/pallas_gj.py:_gj_complex_kernel (pallas_call :651, K1),
// _gj_real_kernel (pallas_call :430, K2) and _gj_inv_complex_kernel
// (pallas_call :514, K4), which the JAX package runs at every N. A system
// is [A | R right-hand sides], w = n + R columns: the solves take R = 1
// (b), the inverse R = n (the identity, written as the planes are staged;
// the answer is then the un-permuted right block of the pivot rows, the
// true inverse). The semantics are those of the plain versions
// (ops/linsolve.py:gj_solve_planes, gj_solve, gj_inverse_planes): the
// pivot of column k is
// the unused row with the largest |a| (|a|^2 complex), ties to the lowest
// row, NaN highest (gj_common.cuh:better); accepted when >= thr (eps, or
// eps^2 complex); a rejected pivot continues with a unit divisor and
// flags the system. Only the order of the sums differs.
//
// The algorithm. For each panel of pw <= PW columns starting at k0:
//  1. Stage the panel's columns M[:, k0:k0+pw] and a zero n x PW block C
//     in [panel | C] (one row per system row, shared memory where it fits).
//  2. pw pivot steps on [panel | C] alone, ONE block barrier each. Warp q
//     owns the step's columns q, q + 8, ... for every row (lane i holds
//     rows i, i + 32, ...): it divides its entries of the pivot row by the
//     pivot (row / pv, never row + (1/pv - 1) row, which cancels in f32
//     as K10's step does; the pivot row's own share C[p, l] enters as 1),
//     then, after a __syncwarp (the reads of the pivot row and its rewrite
//     are the same warp's), every other row subtracts its factor times
//     that row. A step touches pw columns: the panel's l+1..pw-1 and C's
//     0..l. Warp 0 owns the next pivot column and ranks it as it writes
//     it (a shuffle argmax by gj_common.cuh:better, the ranking of
//     warp_best/block_best; those two are not called, because one warp
//     owns the column and a block reduction would add a barrier per
//     step), so the next step starts right after the barrier. So each row
//     of C holds the row's combination of the panel's ORIGINAL pivot rows:
//     after the panel, row i of M is delta_i M[i, :] + C[i, :] G, with G
//     the pivot rows p_0..p_pw-1 of M as they were when the panel began,
//     and delta_i = 0 for those pivot rows (their C row carries their own,
//     scaled, share) and 1 for all others.
//  3. The trailing update: for every column right of the panel, the
//     right-hand sides included, M[:, c0:] = delta * M[:, c0:] + C G. G is
//     staged through shared memory in chunks of CW columns (the pivot rows
//     are rewritten by the same product, so they are copied first); the
//     rows of M go from where they live straight into the product's
//     accumulators and back, so the trailing window is read once and
//     written once per panel, not once per pivot step as block_gj does.
//     The window is not staged through shared memory with cp.async or TMA:
//     each of its elements is read by one accumulator and written back by
//     the same thread, so a staged copy would add a pass with no reuse;
//     the operands that are reused, C and G, are the ones on chip.
//     f64: mma.sync.m8n8k4 f64 (DMMA, exact f64 products and sums), each
//     warp an 8 x 32 tile of M in registers; complex as four real
//     products, Mr += Cr Gr - Ci Gi, Mi += Cr Gi + Ci Gr (never the
//     3-multiply form, which cancels). f32: the CUDA cores in true f32 (no
//     TF32: the f32 tiers hold the JAX tier's Precision.HIGHEST), each
//     thread a 4 x 4 tile (2 x 4 complex), operands from shared memory.
// The panel's own columns are not written back: no later step reads
// them, and the answer is the right-hand side columns of the pivot rows.
//
// Where the data lives (Place, chosen by plan() from N): the planes and
// [panel | C] in shared memory; or the planes in a global workspace slot
// of the block and [panel | C] in shared memory; or, where even [panel | C]
// (n x 33 per plane) overflows the 227 KB a block may hold (complex f64
// from N = 402, real f64 and complex f32 from N = 823, real f32 from
// N = 1630), both in the workspace, with only G and the pivot bookkeeping
// on chip. Then the pivot steps read and write [panel | C] through L1/L2,
// column-major (PcLayout) so that a warp's 32 rows of a column are one
// coalesced run; __syncthreads and __syncwarp order global accesses as
// they order shared ones. So N has no upper limit short of the ints' 8 N bytes of shared
// memory beside G (N = 26,877 in complex f64).
//
// What bounds it on the H100. A Jordan elimination does ~3x LU's
// operations (n^3 multiply-adds against n^3/3), so about a third of the
// operations bound is its ceiling. The n pivot steps are bound by the
// latency of their barrier and shared-memory round trips, so the
// plan (Plan, below) takes the place of the planes that gives the most
// resident blocks per SM, and the blocks are persistent:
// where the planes live in global memory, the workspace is one slot per
// resident block (at N = 64 in complex f64, 528 slots of 66 KB, held in
// L2), read and written once per panel. The product, about (1 - PW/n) of
// the operations, runs on the tensor cores (f64) or register-tiled CUDA
// cores (f32). At flat-256 (816 systems, 1 block per SM) that is about 6
// waves over 132 SMs. Several blocks per system (a cluster sharing the
// panel through distributed shared memory, or the trailing columns split
// across blocks) would fill the last wave but add a cluster barrier per
// pivot step; it is not tried here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace gj {
namespace panel {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// The panel width of K1/K2/K4. 16 measured faster than 32 at every N and
// dtype tried (N = 64, 128, complex and real, f32 and f64; the steps are
// most of the time and a wider panel makes each step touch more columns).
constexpr int PW = 16;
// Resident blocks the register budget is cut for: real 4 (64 registers),
// complex 3 (85): measured faster than the uncapped kernels, whose 104 to
// 153 registers held one or two blocks per SM.
template <int P>
constexpr int min_blocks() { return P == 1 ? 4 : 3; }
constexpr int CW = 64;        // trailing columns per staged chunk of G
constexpr int G_LD = CW + 4;  // = 4 (mod 16): conflict-free B fragments

// ---- the pivot step, a policy of solve_kernel ----------------------------
// A step policy S gives the panel width S::W; the S::COLS columns of
// [panel | C]: panel column l at S::panel_col(l), column s staged from
// panel column S::panel_of(s), C's column c at S::c_col(c); whether the
// trailing update drops the panel's pivot rows (S::DELTA: row i of M
// becomes delta_i M[i, :] + C[i, :] G, else M[i, :] + C[i, :] G); and the
// step's arithmetic: scalar() of the pivot, entry() of the pivot row in a
// column a warp updates, factor() of a row from its entry of the pivot
// column, update() of one entry. DivideStep is K1/K2/K4's;
// mxu_gj.cu:ElementaryStep is K10's.

// K1/K2/K4: the pivot row divided by the pivot (row / pv, never row +
// (1/pv - 1) row, which cancels in f32), every other row minus its factor
// times that row; C's column l enters the pivot row as 1, so C holds each
// row's combination of the panel's original pivot rows, and delta_i = 0
// for those rows.
struct DivideStep {
  static constexpr int W = PW;
  static constexpr int COLS = 2 * W;
  static constexpr bool DELTA = true;
  __host__ __device__ static constexpr int panel_col(int l) { return l; }
  __host__ __device__ static constexpr int c_col(int c) { return W + c; }
  // the panel column staged at column s (none where it is >= pw)
  __host__ __device__ static constexpr int panel_of(int s) { return s; }
  // the divisor (real) or 1 / |pv|^2 (complex); a rejected pivot divides
  // by 1
  template <typename T, int P>
  __device__ __forceinline__ static T scalar(const T (&pv)[P], T thr,
                                             bool& ok) {
    if constexpr (P == 1) {
      ok = fabs(pv[0]) >= thr;
      return ok ? pv[0] : T(1);
    } else {
      const T dd = pv[0] * pv[0] + pv[1] * pv[1];
      ok = dd >= thr;
      return T(1) / (ok ? dd : T(1));
    }
  }
  // the pivot row's entry at q divided by the pivot (its own C column 1)
  template <typename T, int P>
  __device__ __forceinline__ static void entry(T* const (&pc)[P], int q,
                                               bool own, const T (&pv)[P],
                                               T s, T (&pr)[P]) {
    if constexpr (P == 1) {
      pr[0] = (own ? T(1) : pc[0][q]) / s;
    } else {
      const T prr = own ? T(1) : pc[0][q];
      const T pri = own ? T(0) : pc[1][q];
      pr[0] = (prr * pv[0] + pri * pv[1]) * s;
      pr[1] = (pri * pv[0] - prr * pv[1]) * s;
    }
  }
  // the row's factor: its entry of the pivot column
  template <typename T, int P>
  __device__ __forceinline__ static void factor(const T (&f)[P], bool,
                                                const T (&)[P], T,
                                                T (&u)[P]) {
    for (int c = 0; c < P; ++c) u[c] = f[c];
  }
  // row - factor * (pivot row / pv); the pivot row becomes the latter
  template <typename T, int P>
  __device__ __forceinline__ static void update(T* const (&pc)[P], int q,
                                                const T (&f)[P],
                                                const T (&pr)[P], bool,
                                                bool is_p, T (&v)[P]) {
    if (is_p) {
      for (int c = 0; c < P; ++c) v[c] = pr[c];
    } else if constexpr (P == 1) {
      v[0] = pc[0][q] - f[0] * pr[0];
    } else {
      v[0] = pc[0][q] - (f[0] * pr[0] - f[1] * pr[1]);
      v[1] = pc[1][q] - (f[0] * pr[1] + f[1] * pr[0]);
    }
  }
};

// [panel | C] row stride, odd: a warp reading one column of 32 rows (the
// pivot steps' access) hits distinct banks
template <class S = DivideStep>
__host__ __device__ constexpr int pc_ld() { return S::COLS | 1; }

// Element (i, l) of [panel | C] at i * rs + l * cs: row-major with the odd
// stride pc_ld() in shared memory (a warp's 32 rows of one column fall in
// distinct banks), column-major in the workspace (the same access is one
// coalesced run of 32 elements).
struct PcLayout {
  int rs, cs;
  __device__ __forceinline__ int at(int i, int l) const {
    return i * rs + l * cs;
  }
};

// regions are rounded to 4 elements, so each starts 16-byte aligned
__host__ __device__ inline size_t al4(size_t x) {
  return (x + 3) & ~size_t(3);
}

// Where a block keeps an (n, n) system: everything in shared memory; the
// planes in its workspace slot; the planes and [panel | C] there.
enum Place { ALL_SMEM = 0, PLANES_GLOBAL = 1, PANEL_GLOBAL = 2 };

// Shared-memory bytes of one block for (n, n + r) systems: the planes
// (ALL_SMEM), then per plane [panel | C] (not PANEL_GLOBAL) and G; the
// ints (two next-pivot slots, perm, used, ok_all).
template <typename T, int P, class S = DivideStep>
__host__ __device__ inline size_t smem_bytes(int n, int r, int place) {
  size_t t = 0;
  if (place == ALL_SMEM) t += P * al4((size_t)n * (n + r));
  if (place != PANEL_GLOBAL) t += P * al4((size_t)n * pc_ld<S>());
  t += P * al4((size_t)S::W * G_LD);
  return t * sizeof(T) + (4 + 2 * (size_t)n + 1) * sizeof(int);
}

// Workspace systems of (P, n, n + r) elements a grid of ``grid`` blocks
// needs at ``place``: a slot of the planes per block, then (PANEL_GLOBAL)
// the blocks' [panel | C], n x pc_ld() per plane each, in as many more.
template <class S = DivideStep>
inline int workspace_units(int n, int r, int place, int grid) {
  if (place == ALL_SMEM) return 0;
  const long long nw = (long long)n * (n + r);
  const long long pcs = (long long)grid * n * pc_ld<S>();
  return grid + (place == PANEL_GLOBAL ? (int)((pcs + nw - 1) / nw) : 0);
}

// D = A B + C on one 8 x 8 x 4 f64 tile (DMMA). Lane (g = lane / 4,
// t = lane % 4) holds A[g][t], B[t][g] and C, D[g][2t], [g][2t + 1].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Row i's delta: 0 for a pivot row of the panel [k0, k0 + pw) (used[i]
// holds the pivoted column + 1) under a DELTA step, 1 for every other row.
template <class S>
__device__ __forceinline__ bool keeps_row(const int* used, int i, int k0,
                                          int pw) {
  if constexpr (!S::DELTA) return true;
  const int u = used[i] - 1;
  return !(u >= k0 && u < k0 + pw);
}

// M[:, jb:jb+cw] = delta * M + C G in f64 on DMMA: warp tasks of 8 rows x
// NT 8-column tiles, A fragments from C, B fragments from the staged G.
template <int P, class S>
__device__ void trail_update(double* const (&m)[P], double* const (&pc)[P],
                             double* const (&g)[P], const int* used, int n,
                             int w, PcLayout L, int k0, int pw, int jb,
                             int cw) {
  constexpr int NT = 4;  // 8-column tiles per warp task
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int nrt = (n + 7) >> 3;
  const int nct = (cw + 8 * NT - 1) / (8 * NT);
  for (int task = warp; task < nrt * nct; task += NWARPS) {
    const int rt = task / nct, ct = task - rt * nct;
    const int i = rt * 8 + gr;
    const bool row_ok = i < n;
    const bool keep = row_ok && keeps_row<S>(used, i, k0, pw);
    double acc[P][NT][2];
    for (int t = 0; t < NT; ++t)
      for (int e = 0; e < 2; ++e) {
        const int j = ct * 8 * NT + t * 8 + 2 * tg + e;
        for (int c = 0; c < P; ++c)
          acc[c][t][e] = keep && j < cw ? m[c][(size_t)i * w + jb + j]
                                        : 0.0;
      }
    for (int ks = 0; ks < pw; ks += 4) {
      double a[P];
      for (int c = 0; c < P; ++c)
        a[c] = row_ok ? pc[c][L.at(i, S::c_col(ks + tg))] : 0.0;
      for (int t = 0; t < NT; ++t) {
        const int q = (ks + tg) * G_LD + ct * 8 * NT + t * 8 + gr;
        if constexpr (P == 1) {
          dmma(acc[0][t], a[0], g[0][q]);
        } else {
          const double br = g[0][q], bi = g[1][q];
          dmma(acc[0][t], a[0], br);
          dmma(acc[0][t], -a[1], bi);
          dmma(acc[1][t], a[0], bi);
          dmma(acc[1][t], a[1], br);
        }
      }
    }
    if (row_ok)
      for (int t = 0; t < NT; ++t)
        for (int e = 0; e < 2; ++e) {
          const int j = ct * 8 * NT + t * 8 + 2 * tg + e;
          if (j < cw)
            for (int c = 0; c < P; ++c)
              m[c][(size_t)i * w + jb + j] = acc[c][t][e];
        }
  }
}

// The same product in true f32 on the CUDA cores: each thread a 4 x 4
// tile (2 x 4 complex), C's rows broadcast within the warp, G's four
// columns one 16-byte load.
template <int P, class S>
__device__ void trail_update(float* const (&m)[P], float* const (&pc)[P],
                             float* const (&g)[P], const int* used, int n,
                             int w, PcLayout L, int k0, int pw, int jb,
                             int cw) {
  constexpr int NCG = CW / 4;
  constexpr int TR = 4 / P;  // tile rows: 4 x 4 real, 2 x 4 complex
  const int nrg = (n + TR - 1) / TR;
  for (int task = threadIdx.x; task < nrg * NCG; task += THREADS) {
    const int rg = task / NCG, cg = task - rg * NCG;
    const int i0 = rg * TR, j0 = cg * 4;
    if (j0 >= cw) continue;
    float acc[P][TR][4];
    for (int r = 0; r < TR; ++r) {
      const int i = i0 + r;
      const bool keep = i < n && keeps_row<S>(used, i, k0, pw);
      for (int e = 0; e < 4; ++e)
        for (int c = 0; c < P; ++c)
          acc[c][r][e] = keep && j0 + e < cw
                             ? m[c][(size_t)i * w + jb + j0 + e] : 0.f;
    }
#pragma unroll 4
    for (int l = 0; l < pw; ++l) {
      float cv[P][TR];
      for (int r = 0; r < TR; ++r)
        for (int c = 0; c < P; ++c)
          cv[c][r] = i0 + r < n ? pc[c][L.at(i0 + r, S::c_col(l))] : 0.f;
      float4 gv[P];
      for (int c = 0; c < P; ++c)
        gv[c] = *reinterpret_cast<const float4*>(g[c] + l * G_LD + j0);
      for (int r = 0; r < TR; ++r) {
        const float gr_[4] = {gv[0].x, gv[0].y, gv[0].z, gv[0].w};
        if constexpr (P == 1) {
          for (int e = 0; e < 4; ++e) acc[0][r][e] += cv[0][r] * gr_[e];
        } else {
          const float gi_[4] = {gv[1].x, gv[1].y, gv[1].z, gv[1].w};
          for (int e = 0; e < 4; ++e) {
            acc[0][r][e] += cv[0][r] * gr_[e];
            acc[0][r][e] -= cv[1][r] * gi_[e];
            acc[1][r][e] += cv[0][r] * gi_[e];
            acc[1][r][e] += cv[1][r] * gr_[e];
          }
        }
      }
    }
    for (int r = 0; r < TR; ++r) {
      const int i = i0 + r;
      if (i >= n) break;
      for (int e = 0; e < 4; ++e)
        if (j0 + e < cw)
          for (int c = 0; c < P; ++c)
            m[c][(size_t)i * w + jb + j0 + e] = acc[c][r][e];
    }
  }
}

// The warp's best (score, row) by a butterfly of better(): every lane
// ends with the same winner; lane 0 stores its row.
template <typename T>
__device__ __forceinline__ void warp_pick(T best_s, int best_r,
                                          int* next_p) {
  for (int off = 16; off > 0; off >>= 1) {
    const T os = __shfl_xor_sync(0xffffffffu, best_s, off);
    const int orow = __shfl_xor_sync(0xffffffffu, best_r, off);
    if (better(os, orow, best_s, best_r)) {
      best_s = os;
      best_r = orow;
    }
  }
  if ((threadIdx.x & 31) == 0) *next_p = best_r;
}

// The score of an entry: |a| real, |a|^2 complex.
template <typename T, int P>
__device__ __forceinline__ T score_of(const T (&v)[P]) {
  if constexpr (P == 1) {
    return fabs(v[0]);
  } else {
    return v[0] * v[0] + v[1] * v[1];
  }
}

// The pivot of the column at [panel | C] column ``col`` by one warp: the
// unused row with the largest |a| (|a|^2 complex), ties to the lowest
// row, NaN highest (gj_common.cuh:better, the ranking of
// warp_best/block_best).
template <typename T, int P>
__device__ void search(T* const (&pc)[P], const int* used, int n, PcLayout L,
                       int col, int* next_p) {
  T best_s = T(-2);
  int best_r = n;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    T v[P];
    for (int c = 0; c < P; ++c) v[c] = pc[c][L.at(i, col)];
    const T sc = used[i] ? T(-1) : score_of<T, P>(v);
    if (better(sc, i, best_s, best_r)) {
      best_s = sc;
      best_r = i;
    }
  }
  warp_pick<T>(best_s, best_r, next_p);
}

// Reduce (n, n + r) systems [A | B], one block at a time per system: A
// (n, n) and B (n, r) per plane batch-first, or, with b0 == nullptr, B the
// identity (r = n: the inverse); x (n, r) per plane, row k the right block
// of pivot row perm[k]; valid as bytes. The blocks are persistent: block
// q solves systems q, q + gridDim.x, ... ``workspace``:
// workspace_units(n, r, place, gridDim.x) systems of (P, n, n + r) where
// the plan's place puts data in global memory (one slot per resident
// block, so the workspace stays small), else nullptr (ALL_SMEM). PG: the
// PANEL_GLOBAL instance, [panel | C] in the workspace too (a template
// flag, so the shared-memory instance keeps its constant strides). S: the
// pivot step (DivideStep: K1/K2/K4; mxu_gj.cu:ElementaryStep: K10).
template <typename T, int P, bool PG, class S = DivideStep>
__global__ void __launch_bounds__(THREADS, min_blocks<P>())
    solve_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                 const T* __restrict__ b0, const T* __restrict__ b1,
                 T* __restrict__ x0, T* __restrict__ x1,
                 uint8_t* __restrict__ valid_out, T* __restrict__ workspace,
                 int batch, int n, int r, T thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NCOL = S::W / NWARPS;  // columns of a step per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = n + r, nw = n * w, ldp = pc_ld<S>();
  const PcLayout L = PG ? PcLayout{1, n} : PcLayout{ldp, 1};

  T* base = reinterpret_cast<T*>(smem_raw);
  T *m[P], *pc[P], *g[P];
  for (int c = 0; c < P; ++c) {
    if (workspace == nullptr) {
      m[c] = base;
      base += al4(nw);
    } else {
      m[c] = workspace + ((size_t)blockIdx.x * P + c) * nw;
    }
  }
  for (int c = 0; c < P; ++c) {
    if constexpr (PG) {
      pc[c] = workspace + (size_t)gridDim.x * P * nw +
              ((size_t)blockIdx.x * P + c) * n * ldp;
    } else {
      pc[c] = base;
      base += al4((size_t)n * ldp);
    }
    g[c] = base;
    base += al4((size_t)S::W * G_LD);
  }
  // the next pivot's row, two slots: step l reads slot l % 2 while warp 0
  // already writes slot (l + 1) % 2
  int* next_p = reinterpret_cast<int*>(base);
  int* perm = next_p + 4;
  int* used = perm + n;  // pivoted column + 1, 0 while unused
  int* ok_all = used + n;

  for (long long sys = blockIdx.x; sys < batch; sys += gridDim.x) {
    const T* A[2] = {A0 + sys * n * n, P == 2 ? A1 + sys * n * n : nullptr};
    const T* b[2] = {b0 == nullptr ? nullptr : b0 + sys * n * r,
                     P == 2 && b1 != nullptr ? b1 + sys * n * r : nullptr};
    for (int idx = tid; idx < nw; idx += THREADS) {
      const int i = idx / w, j = idx - i * w;
      for (int c = 0; c < P; ++c)
        m[c][idx] = j < n          ? A[c][i * n + j]
                    : b0 != nullptr ? b[c][i * r + j - n]
                                    : T(c == 0 && j - n == i ? 1 : 0);
    }
    for (int i = tid; i < n; i += THREADS) used[i] = 0;
    if (tid == 0) *ok_all = 1;
    __syncthreads();

    for (int k0 = 0; k0 < n; k0 += S::W) {
      const int pw = min(S::W, n - k0);
      // ---- 1. stage [panel | C = 0] --------------------------------------
      for (int idx = tid; idx < n * S::COLS; idx += THREADS) {
        const int i = idx / S::COLS, s = idx - i * S::COLS;
        const int l = S::panel_of(s);  // < 0 or >= pw: a zero column
        for (int c = 0; c < P; ++c)
          pc[c][L.at(i, s)] = (unsigned)l < (unsigned)pw
                                  ? m[c][(size_t)i * w + k0 + l] : T(0);
      }
      __syncthreads();
      // ---- 2. the panel's pivot steps, one block barrier each -----------
      // step l touches pw columns: jj < np the panel's l+1+jj, the rest
      // C's 0..l. Warp q owns columns jj = q, q + 8, ... for every row
      // (lane i holds rows i, i + 32, ...), so the reads of the pivot row
      // and its rewrite happen in one warp, ordered by __syncwarp; warp 0
      // owns jj = 0, the next pivot column, and searches it as soon as it
      // has updated it.
      if (warp == 0) search<T, P>(pc, used, n, L, S::panel_col(0), next_p);
      __syncthreads();
      for (int l = 0; l < pw; ++l) {
        const int kk = k0 + l, np = pw - l - 1, slot = l & 1;
        const int p = next_p[slot];
        const int kc = S::panel_col(l);
        T pv[P];
        for (int c = 0; c < P; ++c) pv[c] = pc[c][L.at(p, kc)];
        if (tid == 0) {
          used[p] = kk + 1;
          perm[kk] = p;
        }
        // this warp's columns of the pivot row, as the step reads them
        bool ok;
        const T s = S::template scalar<T, P>(pv, thr, ok);
        if (tid == 0 && !ok) *ok_all = 0;
        T pr[NCOL][P];
        int cols[NCOL];
        bool own[NCOL];
        for (int m = 0; m < NCOL; ++m) {
          const int jj = warp + NWARPS * m;
          cols[m] = jj < np ? S::panel_col(l + 1 + jj) : S::c_col(jj - np);
          own[m] = jj - np == l;
          if (jj >= pw) continue;
          S::template entry<T, P>(pc, L.at(p, cols[m]), own[m], pv, s,
                                  pr[m]);
        }
        __syncwarp();  // the warp's reads of row p are done
        // warp 0 ranks column l + 1 as it updates it
        T best_s = T(-2);
        int best_r = n;
        for (int i = lane; i < n; i += 32) {
          T f[P], u[P];
          for (int c = 0; c < P; ++c) f[c] = pc[c][L.at(i, kc)];
          S::template factor<T, P>(f, i == p, pv, s, u);
          for (int m = 0; m < NCOL; ++m) {
            const int jj = warp + NWARPS * m;
            if (jj >= pw) break;
            const int q = L.at(i, cols[m]);
            T v[P];
            S::template update<T, P>(pc, q, u, pr[m], own[m], i == p, v);
            for (int c = 0; c < P; ++c) pc[c][q] = v[c];
            if (jj == 0 && np > 0) {  // warp 0, lane's row of column l + 1
              const T sc = used[i] || i == p ? T(-1) : score_of<T, P>(v);
              if (better(sc, i, best_s, best_r)) {
                best_s = sc;
                best_r = i;
              }
            }
          }
        }
        if (warp == 0 && np > 0)
          warp_pick<T>(best_s, best_r, next_p + (slot ^ 1));
        __syncthreads();
      }
      // the f64 product reads C in groups of 4 columns, so C's columns
      // pw..W-1 must be zero: where C's column pw is the column that held
      // panel column pw - 1 (ElementaryStep), it is cleared (the G
      // staging's barrier orders this before the product)
      if (pw < S::W && S::c_col(pw) == S::panel_col(pw - 1))
        for (int i = tid; i < n; i += THREADS)
          for (int c = 0; c < P; ++c) pc[c][L.at(i, S::c_col(pw))] = T(0);
      // ---- 3. the trailing update, a chunk of CW columns at a time -------
      for (int jb = k0 + pw; jb < w; jb += CW) {
        const int cw = min(CW, w - jb);
        for (int idx = tid; idx < S::W * CW; idx += THREADS) {
          const int l = idx / CW, j = idx - l * CW;
          for (int c = 0; c < P; ++c)
            g[c][l * G_LD + j] =
                l < pw && j < cw ? m[c][(size_t)perm[k0 + l] * w + jb + j]
                                 : T(0);
        }
        __syncthreads();
        trail_update<P, S>(m, pc, g, used, n, w, L, k0, pw, jb, cw);
        __syncthreads();
      }
    }
    // pivot row perm[k] carries x[k] (row k of the answer) in its
    // right-hand side columns
    T* x[2] = {x0, x1};
    for (int idx = tid; idx < n * r; idx += THREADS) {
      const int k = idx / r, j = idx - k * r;
      for (int c = 0; c < P; ++c)
        x[c][sys * n * r + idx] = m[c][(size_t)perm[k] * w + n + j];
    }
    if (tid == 0) valid_out[sys] = (uint8_t)(*ok_all);
    __syncthreads();  // before the next system overwrites the planes
  }
}

// How a panel launch runs an (n, n) system: where its data lives, and the
// resident blocks per SM.
struct Plan {
  int place = ALL_SMEM;
  int blocks_per_sm = 0;
  int sms = 0;
  int grid(int batch) const {
    const long long slots = (long long)blocks_per_sm * sms;
    return (int)(batch < slots ? batch : slots);
  }
};

// The steps are bound by barrier and shared-memory latency, so the plan
// is, of ALL_SMEM and PLANES_GLOBAL, the one with more resident blocks per
// SM (the occupancy API, so registers count too); on a tie, the planes in
// shared memory (no workspace traffic). PANEL_GLOBAL only where neither
// fits. blocks_per_sm == 0 when nothing fits.
template <typename T, int P, class S>
inline const void* kernel_of(int place) {
  return place == PANEL_GLOBAL
             ? reinterpret_cast<const void*>(&solve_kernel<T, P, true, S>)
             : reinterpret_cast<const void*>(&solve_kernel<T, P, false, S>);
}

template <typename T, int P, class S = DivideStep>
inline Plan plan(int n, int r) {
  Plan best;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&best.sms, cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return best;
  for (int place : {ALL_SMEM, PLANES_GLOBAL, PANEL_GLOBAL}) {
    if (place == PANEL_GLOBAL && best.blocks_per_sm > 0) break;
    const void* fn = kernel_of<T, P, S>(place);
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX) != cudaSuccess)
      return Plan{};
    const size_t bytes = smem_bytes<T, P, S>(n, r, place);
    int blocks = 0;
    if (bytes > SMEM_MAX ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      bytes) != cudaSuccess)
      continue;
    if (blocks > best.blocks_per_sm) {
      best.place = place;
      best.blocks_per_sm = blocks;
    }
  }
  return best;
}

// Systems of (P, n, n + r) the global workspace must hold for a batch
// (workspace_units of the plan's place and grid), 0 where the plan keeps
// everything in shared memory.
template <typename T, int P, class S = DivideStep>
inline int workspace_systems(int n, int r, int batch) {
  const Plan pl = plan<T, P, S>(n, r);
  return pl.blocks_per_sm == 0
             ? 0
             : workspace_units<S>(n, r, pl.place, pl.grid(batch));
}

// Launch on ``stream``: r right-hand sides b0/b1 (n, r) per system, or the
// identity (b0 == nullptr, r = n); ``workspace`` holds
// workspace_systems(n, r, batch) systems of (P, n, n + r) when that is
// nonzero.
template <typename T, int P, class S = DivideStep>
int launch(const void* A0, const void* A1, const void* b0, const void* b1,
           void* x0, void* x1, void* valid, void* workspace, int batch,
           int n, int r, T thr, void* stream) {
  if (n < 1 || r < 1 || (b0 == nullptr && r != n))
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan<T, P, S>(n, r);
  if (pl.blocks_per_sm == 0) return (int)cudaErrorInvalidValue;
  if ((pl.place == ALL_SMEM) != (workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, P, S>(n, r, pl.place);
  if (batch > 0) {
    auto* kernel = pl.place == PANEL_GLOBAL ? solve_kernel<T, P, true, S>
                                            : solve_kernel<T, P, false, S>;
    kernel<<<pl.grid(batch), THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)A0, (const T*)A1, (const T*)b0, (const T*)b1, (T*)x0,
        (T*)x1, (uint8_t*)valid, (T*)workspace, batch, n, r, thr);
  }
  return (int)cudaGetLastError();
}

}  // namespace panel
}  // namespace gj
