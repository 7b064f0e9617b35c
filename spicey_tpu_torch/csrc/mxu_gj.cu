// K10a and K10b: the panel-blocked Gauss-Jordan solve for mid-size systems,
// real (K10a) and complex on (re, im) planes (K10b), N in [40, 128].
//
// K10a replaces the TPU kernel spicey_tpu/ops/pallas_mxu.py:
// _mxu_gj_real_kernel (pallas_call in mxu_solve_real) and K10b
// _mxu_gj_complex_kernel (pallas_call in mxu_solve_complex). The plain
// versions are spicey_tpu_torch/ops/mxu.py:mxu_solve_real_plain and
// mxu_solve_complex_plain, which repeat this arithmetic step for step.
//
// The algorithm is the TPU tier's panel form of the one-hot-pivot Jordan
// elimination. For each panel of P columns (P from ops/mxu.py:blocked_plan,
// 16 or 32; the last panel is ragged where the TPU pads with identity
// columns, whose steps are exact no-ops), P pivot steps: the pivot of the
// column is the unused row with the largest |a| (|a|^2 complex, ties to
// the lowest row, NaN highest: gj_common.cuh:better), accepted when
// >= eps (eps^2), a rejected one continuing with a unit divisor and
// flagging the system. Each step is the elementary matrix E = I + u e_p^T
// (u_i = -a_ik / pv, u_p = 1/pv - 1): it updates the panel's columns and
// accumulates the composite transform I + C S in C (n x P), C <- C + u (x)
// C[p, :], C[:, j] += u. Then every column right of the panel, the
// right-hand side included, takes one product:
//   M[:, c0:] += C @ G,   G = the panel's pivot rows of M[:, c0:]
// (complex: Mr += Cr Gr - Ci Gi, Mi += Cr Gi + Ci Gr). x[k] is the final
// right-hand side of the row that pivoted column k.
//
// The kernel is gj_panel.cuh:solve_kernel, the panel tier of K1/K2/K4,
// with K10's step as its policy (ElementaryStep below); the plan, the
// persistent blocks, the staging, the pivot search and the product are
// that kernel's. What differs is the step and where [panel | C] keeps C:
//  - Step j reads panel column j (the factors u) and writes the panel's
//    columns j+1..P-1 and C's columns 0..j; the panel's columns <= j are
//    never read again and C's columns > j are still zero, so neither is
//    touched (0 + 0 u = 0 for finite u). Each step thus touches P columns,
//    as K1's does, and one warp owns each column for every row, so the
//    pivot row's entries are read before they change by the same warp
//    (__syncwarp), with ONE block barrier per step: warp 0 updates the
//    next pivot column and ranks it in the same pass (a shuffle argmax
//    by better()).
//  - C's column j takes the place of panel column j - 1, dead since step
//    j - 1: [panel | C] is n x (P + 1) (panel column l at l + 1, C's
//    column c at c), half of K1's n x 2P, so at P = 32 it is as large as
//    K1's at P = 16. The slot of C's column j holds stale panel data when
//    step j starts, so the step writes u there without reading it: C[:, j]
//    = 0 + C[p, j] u + u = u, C[p, j] being 0 (the plain version forms the
//    same value; only a zero's sign can differ).
//  - The trailing update keeps every row (no delta), and reads C in
//    groups of 4 columns, so in a ragged last panel the stale column at
//    C's column pw is cleared first.
// Where the planes live is plan()'s choice, the place with the most
// resident blocks; a workspace holds one slot per resident block, so it
// does not grow with the batch (complex f64 at the sweep's 52,224 x 128:
// 264 slots, 70 MB).
//
// Layout: batch-first A (B, N, N) and b (B, N) per plane -> x (B, N) per
// plane, valid (B,) as bytes (a torch.bool tensor).
//
// What bounds it on the H100: the products, 2 N P (N + 1 - c0) multiply-
// adds per panel (x4 complex), are most of the elimination's operations;
// in f64 they run on the tensor cores (DMMA m8n8k4, exact f64 products
// and sums; complex as four real products, never the 3-multiply form), in
// f32 register-tiled on the CUDA cores in true f32 (no TF32: the JAX
// tier's Precision.HIGHEST). The N pivot steps are latency-bound (one
// barrier and a warp argmax each). At the sweep's sizes (1e4-1e5 systems)
// device memory is not the bound: the system is read once and x written
// once, and a workspace slot stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_panel.cuh"

namespace {

// K10's step, E = I + u e_p^T, as ops/mxu.py:_mxu_eliminate forms it:
// u_i = -a_ik / pv off the pivot (complex: -(a conj(pv)) / |pv|^2), u_p =
// 1/pv - 1; every row, the pivot row too, takes row + (pivot row) u_i, and
// C's column j of a row takes u_i. W: the panel width, 16 or 32.
template <int W_>
struct ElementaryStep {
  static constexpr int W = W_;
  static constexpr int COLS = W + 1;
  static constexpr bool DELTA = false;
  __host__ __device__ static constexpr int panel_col(int l) { return l + 1; }
  __host__ __device__ static constexpr int c_col(int c) { return c; }
  __host__ __device__ static constexpr int panel_of(int s) { return s - 1; }
  // 1 / pv (real) or 1 / |pv|^2 (complex); a rejected pivot divides by 1
  template <typename T, int P>
  __device__ __forceinline__ static T scalar(const T (&pv)[P], T thr,
                                             bool& ok) {
    if constexpr (P == 1) {
      ok = fabs(pv[0]) >= thr;
      return T(1) / (ok ? pv[0] : T(1));
    } else {
      const T d = pv[0] * pv[0] + pv[1] * pv[1];
      ok = d >= thr;
      return T(1) / (ok ? d : T(1));
    }
  }
  // the pivot row's entry at q as it is (C's own column j: 0, not read)
  template <typename T, int P>
  __device__ __forceinline__ static void entry(T* const (&pc)[P], int q,
                                               bool own, const T (&)[P], T,
                                               T (&pr)[P]) {
    for (int c = 0; c < P; ++c) pr[c] = own ? T(0) : pc[c][q];
  }
  // u_i from the row's entry f of the pivot column
  template <typename T, int P>
  __device__ __forceinline__ static void factor(const T (&f)[P], bool is_p,
                                                const T (&pv)[P], T s,
                                                T (&u)[P]) {
    if constexpr (P == 1) {
      u[0] = is_p ? s - T(1) : -f[0] * s;
    } else {
      const T pvr = pv[0], pvi = pv[1];
      u[0] = is_p ? pvr * s - T(1) : -(f[0] * pvr + f[1] * pvi) * s;
      u[1] = is_p ? -pvi * s : -(f[1] * pvr - f[0] * pvi) * s;
    }
  }
  // entry + (pivot row's entry) u_i; C's own column j: u_i
  template <typename T, int P>
  __device__ __forceinline__ static void update(T* const (&pc)[P], int q,
                                                const T (&u)[P],
                                                const T (&pr)[P], bool own,
                                                bool, T (&v)[P]) {
    if (own) {
      for (int c = 0; c < P; ++c) v[c] = u[c];
    } else if constexpr (P == 1) {
      v[0] = pc[0][q] + pr[0] * u[0];
    } else {
      v[0] = pc[0][q] + pr[0] * u[0] - pr[1] * u[1];
      v[1] = pc[1][q] + pr[0] * u[1] + pr[1] * u[0];
    }
  }
};

// fn(ElementaryStep<pmax>{}) for the panel widths blocked_plan gives, 16
// and 32; ``bad`` for any other width
template <typename F>
long long by_width(int pmax, long long bad, F fn) {
  return pmax == 16   ? fn(ElementaryStep<16>{})
         : pmax == 32 ? fn(ElementaryStep<32>{})
                      : bad;
}

template <typename T, int P>
int launch(const void* A0, const void* A1, const void* b0, const void* b1,
           void* x0, void* x1, void* valid, void* workspace, int batch, int n,
           int pmax, double eps, void* stream) {
  if (n < 1 || pmax > n) return (int)cudaErrorInvalidValue;
  const T thr = (T)(P == 1 ? eps : eps * eps);
  return (int)by_width(pmax, cudaErrorInvalidValue, [&](auto step) {
    return gj::panel::launch<T, P, decltype(step)>(
        A0, A1, b0, b1, x0, x1, valid, workspace, batch, n, 1, thr, stream);
  });
}

template <typename T, int P>
int workspace_systems(int n, int batch, int pmax) {
  return (int)by_width(pmax, cudaErrorInvalidValue, [&](auto step) {
    return gj::panel::workspace_systems<T, P, decltype(step)>(n, 1, batch);
  });
}

template <typename T, int P>
long long smem_bytes(int n, int pmax, int place) {
  return by_width(pmax, -1, [&](auto step) {
    return (long long)gj::panel::smem_bytes<T, P, decltype(step)>(n, 1,
                                                                   place);
  });
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at ``place`` (gj_panel.cuh:Place) for
// panel width ``pmax``, -1 for another width; ops/mxu.py:smem_bytes is its
// copy for the CPU tests.
long long mxu_gj_smem_bytes(int n, int pmax, int planes, int is_double,
                            int place) {
  if (planes == 1)
    return is_double ? smem_bytes<double, 1>(n, pmax, place)
                     : smem_bytes<float, 1>(n, pmax, place);
  return is_double ? smem_bytes<double, 2>(n, pmax, place)
                   : smem_bytes<float, 2>(n, pmax, place);
}

// Systems of (planes, n, n + 1) the workspace must hold for a batch: one
// slot per resident block where the plan keeps the planes in global
// memory, else 0.
int mxu_gj_workspace_systems(int n, int batch, int planes, int is_double,
                             int pmax) {
  if (planes == 1)
    return is_double ? workspace_systems<double, 1>(n, batch, pmax)
                     : workspace_systems<float, 1>(n, batch, pmax);
  return is_double ? workspace_systems<double, 2>(n, batch, pmax)
                   : workspace_systems<float, 2>(n, batch, pmax);
}

int mxu_gj_real_f32(const void* A, const void* b, void* x, void* valid,
                    void* workspace, int batch, int n, int pmax, double eps,
                    void* stream) {
  return launch<float, 1>(A, nullptr, b, nullptr, x, nullptr, valid,
                          workspace, batch, n, pmax, eps, stream);
}

int mxu_gj_real_f64(const void* A, const void* b, void* x, void* valid,
                    void* workspace, int batch, int n, int pmax, double eps,
                    void* stream) {
  return launch<double, 1>(A, nullptr, b, nullptr, x, nullptr, valid,
                           workspace, batch, n, pmax, eps, stream);
}

int mxu_gj_complex_f32(const void* Ar, const void* Ai, const void* br,
                       const void* bi, void* xr, void* xi, void* valid,
                       void* workspace, int batch, int n, int pmax,
                       double eps, void* stream) {
  return launch<float, 2>(Ar, Ai, br, bi, xr, xi, valid, workspace, batch, n,
                          pmax, eps, stream);
}

int mxu_gj_complex_f64(const void* Ar, const void* Ai, const void* br,
                       const void* bi, void* xr, void* xi, void* valid,
                       void* workspace, int batch, int n, int pmax,
                       double eps, void* stream) {
  return launch<double, 2>(Ar, Ai, br, bi, xr, xi, valid, workspace, batch,
                           n, pmax, eps, stream);
}

}  // extern "C"
