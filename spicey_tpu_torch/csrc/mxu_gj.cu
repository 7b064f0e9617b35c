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
// columns, whose steps are exact no-ops), P pivot steps run by the whole
// block: the pivot of the column is the unused row with the largest |a|
// (|a|^2 complex, ties to the lowest row, NaN highest: gj_common.cuh's
// warp_best/block_best, shared with block_gj), accepted when >= eps
// (eps^2), a rejected one continuing with a unit divisor and flagging the
// system. Each step is the elementary matrix E = I + u e_p^T (u_i =
// -a_ik / pv, u_p = 1/pv - 1): it updates only the panel's columns and
// accumulates the composite transform I + C S in C (n x P, shared memory),
// C <- C + u (x) C[p, :], C[:, j] += u. Then every column right of the
// panel, the right-hand side included, takes one product:
//   M[:, c0:] += C @ G,   G = the panel's pivot rows of M[:, c0:]
// (complex: Mr += Cr Gr - Ci Gi, Mi += Cr Gi + Ci Gr). x[k] is the final
// right-hand side of the row that pivoted column k.
//
// Layout: batch-first A (B, N, N) and b (B, N) per plane -> x (B, N) per
// plane, valid (B,) as bytes (a torch.bool tensor). One block per system;
// the augmented system [A | b] row-major in shared memory (real f32/f64 and
// complex f32 fit up to N = 128: real f64 at N = 128 takes 132 KB of
// planes, 32 KB of C, 25 KB of G, 193 KB in all). Complex f64 does not fit
// past N ~ 105 (its planes alone are 264 KB at N = 128): there the planes
// live in a global workspace the wrapper allocates, as K1's do, and C, G
// and the step scratch stay in shared memory.
//
// What bounds it on the H100: the products, 2 N P (N + 1 - c0) multiply-
// adds per panel (x4 complex), are most of the elimination's operations;
// every operand comes from shared memory, so at the sweep's sizes
// (1e4-1e5 systems) the work is bound by operations and by the P barriers
// of each panel, not by device memory (the system is read once and x
// written once). The products here run on the CUDA cores, one output
// element per thread in turn: the f32 instance uses no TF32 (the JAX
// tier's Precision.HIGHEST is true f32), and a tensor-core trailing update
// (DMMA m8n8k4 for f64, 3xTF32 for f32) is the K10 redesign of ROADMAP §2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PMAX = 32;

// Shared-memory bytes of one block: the planes (when they stay on chip),
// then per plane C (n x pmax), G (pmax x (n + 1 - pmax)), u (n), the
// pivot row's panel and C entries (pmax each); then the reduction and
// pivot scalars and the ints.
template <typename T, int P>
__host__ __device__ inline size_t smem_bytes(int n, int pmax,
                                             bool planes_in_smem) {
  const size_t w = (size_t)n + 1;
  size_t t = (size_t)P * ((size_t)n * pmax + pmax * (w - pmax) + n +
                          2 * (size_t)pmax) + 36;
  if (planes_in_smem) t += (size_t)P * n * w;
  return t * sizeof(T) + (34 + 2 * (size_t)n) * sizeof(int);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
    mxu_gj_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                  const T* __restrict__ b0, const T* __restrict__ b1,
                  T* __restrict__ x0, T* __restrict__ x1,
                  uint8_t* __restrict__ valid_out, T* __restrict__ workspace,
                  int n, int pmax, T thr) {
  extern __shared__ unsigned char smem_raw[];
  const long long sys = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, nwarps = nt >> 5;
  const int w = n + 1, nw = n * w;

  T* base = reinterpret_cast<T*>(smem_raw);
  T* m[P];
  for (int c = 0; c < P; ++c) {
    if (workspace == nullptr) {
      m[c] = base;
      base += nw;
    } else {
      m[c] = workspace + (sys * P + c) * nw;
    }
  }
  T *cm[P], *g[P], *u[P], *prow[P], *cpiv[P];
  for (int c = 0; c < P; ++c) {
    cm[c] = base;
    base += n * pmax;
  }
  for (int c = 0; c < P; ++c) {
    g[c] = base;
    base += pmax * (w - pmax);
  }
  for (int c = 0; c < P; ++c) {
    u[c] = base;
    base += n;
  }
  for (int c = 0; c < P; ++c) {
    prow[c] = base;
    cpiv[c] = base + pmax;
    base += 2 * pmax;
  }
  T* red_s = base;
  T* piv = base + 32;
  int* red_r = reinterpret_cast<int*>(piv + 4);
  int* perm = red_r + 32;
  int* used = perm + n;
  int* pivot_row = used + n;
  int* ok_all = pivot_row + 1;

  const T* A[2] = {A0 + sys * n * n, P == 2 ? A1 + sys * n * n : nullptr};
  const T* b[2] = {b0 + sys * n, P == 2 ? b1 + sys * n : nullptr};
  for (int idx = tid; idx < nw; idx += nt) {
    const int i = idx / w, j = idx - i * w;
    for (int c = 0; c < P; ++c) m[c][idx] = j < n ? A[c][i * n + j] : b[c][i];
  }
  for (int i = tid; i < n; i += nt) used[i] = 0;
  if (tid == 0) *ok_all = 1;
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += pmax) {
    const int pw = min(pmax, n - k0);
    for (int idx = tid; idx < n * pw; idx += nt)
      for (int c = 0; c < P; ++c) cm[c][idx] = T(0);
    // ---- the panel: pw pivot steps on its columns and on C -------------
    for (int j = 0; j < pw; ++j) {
      const int kk = k0 + j;
      gj::warp_best<T, P>(m, n, w, kk, used, red_s, red_r);
      __syncthreads();
      if (tid == 0) {
        const int p = gj::block_best(red_s, red_r, nwarps);
        const size_t pq = (size_t)p * w + kk;
        if constexpr (P == 1) {
          const T pv = m[0][pq];
          const bool ok = fabs(pv) >= thr;
          if (!ok) *ok_all = 0;
          piv[0] = T(1) / (ok ? pv : T(1));
        } else {
          const T pvr = m[0][pq], pvi = m[1][pq];
          const T d = pvr * pvr + pvi * pvi;
          const bool ok = d >= thr;
          if (!ok) *ok_all = 0;
          piv[0] = pvr;
          piv[1] = pvi;
          piv[2] = T(1) / (ok ? d : T(1));
        }
        *pivot_row = p;
        used[p] = 1;
        perm[kk] = p;
      }
      __syncthreads();
      const int p = *pivot_row;
      // u from column kk, and the pivot row's panel and C entries, read
      // before any of them changes
      for (int i = tid; i < n; i += nt) {
        const size_t q = (size_t)i * w + kk;
        if constexpr (P == 1) {
          const T ipv = piv[0];
          u[0][i] = i == p ? ipv - T(1) : -m[0][q] * ipv;
        } else {
          const T pvr = piv[0], pvi = piv[1], ipd = piv[2];
          const T cr = m[0][q], ci = m[1][q];
          u[0][i] = i == p ? pvr * ipd - T(1) : -(cr * pvr + ci * pvi) * ipd;
          u[1][i] = i == p ? -pvi * ipd : -(ci * pvr - cr * pvi) * ipd;
        }
      }
      for (int l = tid; l < pw; l += nt)
        for (int c = 0; c < P; ++c) {
          prow[c][l] = m[c][(size_t)p * w + k0 + l];
          cpiv[c][l] = cm[c][p * pw + l];
        }
      __syncthreads();
      for (int idx = tid; idx < n * pw; idx += nt) {
        const int i = idx / pw, l = idx - i * pw;
        const size_t q = (size_t)i * w + k0 + l;
        if constexpr (P == 1) {
          const T ui = u[0][i];
          m[0][q] = m[0][q] + prow[0][l] * ui;
          T cv = cm[0][idx] + cpiv[0][l] * ui;
          if (l == j) cv = cv + ui;
          cm[0][idx] = cv;
        } else {
          const T ur = u[0][i], ui = u[1][i];
          const T pr = prow[0][l], pi = prow[1][l];
          const T mr = m[0][q], mi = m[1][q];
          m[0][q] = mr + pr * ur - pi * ui;
          m[1][q] = mi + pr * ui + pi * ur;
          const T cpr = cpiv[0][l], cpi = cpiv[1][l];
          T cr = cm[0][idx] + cpr * ur - cpi * ui;
          T ci = cm[1][idx] + cpr * ui + cpi * ur;
          if (l == j) {
            cr = cr + ur;
            ci = ci + ui;
          }
          cm[0][idx] = cr;
          cm[1][idx] = ci;
        }
      }
      __syncthreads();
    }
    // ---- the trailing update: M[:, c0:] += C @ G -------------------------
    const int c0 = k0 + pw, wt = w - c0;
    for (int idx = tid; idx < pw * wt; idx += nt) {
      const int l = idx / wt, cc = idx - l * wt;
      const size_t q = (size_t)perm[k0 + l] * w + c0 + cc;
      for (int c = 0; c < P; ++c) g[c][idx] = m[c][q];
    }
    __syncthreads();
    for (int idx = tid; idx < n * wt; idx += nt) {
      const int i = idx / wt, cc = idx - i * wt;
      const size_t q = (size_t)i * w + c0 + cc;
      if constexpr (P == 1) {
        T acc = T(0);
        for (int l = 0; l < pw; ++l) acc += cm[0][i * pw + l] * g[0][l * wt + cc];
        m[0][q] = m[0][q] + acc;
      } else {
        T rr = T(0), ii = T(0), ri = T(0), ir = T(0);
        for (int l = 0; l < pw; ++l) {
          const T cr = cm[0][i * pw + l], ci = cm[1][i * pw + l];
          const T gr = g[0][l * wt + cc], gi = g[1][l * wt + cc];
          rr += cr * gr;
          ii += ci * gi;
          ri += cr * gi;
          ir += ci * gr;
        }
        m[0][q] = m[0][q] + rr - ii;
        m[1][q] = m[1][q] + ri + ir;
      }
    }
    __syncthreads();
  }
  // pivot row perm[k] carries x[k] in its right-hand side
  T* x[2] = {x0, x1};
  for (int k = tid; k < n; k += nt)
    for (int c = 0; c < P; ++c) x[c][sys * n + k] = m[c][(size_t)perm[k] * w + n];
  if (tid == 0) valid_out[sys] = (uint8_t)(*ok_all);
}

template <typename T, int P>
int launch(const void* A0, const void* A1, const void* b0, const void* b1,
           void* x0, void* x1, void* valid, void* workspace, int batch, int n,
           int pmax, double eps, void* stream) {
  if (n < 1 || pmax < 1 || pmax > PMAX || pmax > n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, P>(n, pmax, workspace == nullptr);
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_gj_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T thr = (T)(P == 1 ? eps : eps * eps);
  if (batch > 0) {
    mxu_gj_kernel<T, P><<<batch, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)A0, (const T*)A1, (const T*)b0, (const T*)b1, (T*)x0,
        (T*)x1, (uint8_t*)valid, (T*)workspace, n, pmax, thr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of a block whose planes stay on chip; the wrapper
// allocates a global workspace of (B, planes, N, N + 1) when this exceeds
// what a block may hold.
size_t mxu_gj_smem_bytes(int n, int pmax, int planes, int is_double) {
  if (planes == 1)
    return is_double ? smem_bytes<double, 1>(n, pmax, true)
                     : smem_bytes<float, 1>(n, pmax, true);
  return is_double ? smem_bytes<double, 2>(n, pmax, true)
                   : smem_bytes<float, 2>(n, pmax, true);
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
