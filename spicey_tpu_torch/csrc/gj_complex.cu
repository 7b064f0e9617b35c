// K1: batched complex Gauss-Jordan on (re, im) planes in three tiers (a warp,
// a block or a panel-blocked block per system), and K4, the batched complex
// inverse, in the same three tiers.
//
// Replaces the TPU kernel spicey_tpu/ops/pallas_gj.py:_gj_complex_kernel
// (pallas_call in _solve_complex_f32_batchlast, loop body
// _complex_gj_scratch). Semantics are those of the plain version,
// spicey_tpu_torch/ops/linsolve.py:gj_solve_planes: the pivot of column k
// is the unused row with the largest |a|^2, ties to the lowest row; a
// system is invalid when |pivot|^2 < eps^2, and elimination continues
// through an invalid pivot with a unit divisor. The eliminations are
// gj_common.cuh's warp_gj and block_gj and gj_panel.cuh's, with complex
// elements, shared with K2 and K3.
//
// Layout: batch-first A_re, A_im (B, N, N), b_re, b_im (B, N) ->
// x_re, x_im (B, N), valid (B,) as bytes (a torch.bool tensor).
//
// K4 replaces spicey_tpu/ops/pallas_gj.py:_gj_inv_complex_kernel
// (pallas_call in _inverse_complex_f32): it reduces [A | I] (width 2N) on
// the same planes with the same pivot rule, as
// spicey_tpu_torch/ops/linsolve.py:gj_inverse_planes does, and writes the
// TRUE inverse M_re, M_im (B, N, N): the TPU kernel returns the
// row-permuted M and its pivot map (colidx); this kernel un-permutes
// before it writes, as K3 does (csrc/gj_real.cu). The .noise analysis
// applies one inverse per frequency to the forward and the adjoint
// right-hand sides.
//
// Three tiers of the solve, chosen by the wrapper (ops/gj.py:tier_for)
// from N and the dtype, each one elimination with the plain version's
// pivots and flags:
//   warp   (N <= 32) gj_common.cuh:warp_gj, one warp per system, four
//          systems per block. At these sizes a block per system waits
//          through ~4N block barriers while each step updates a few
//          elements per thread; a warp needs no block barrier (shuffles and
//          __syncwarp), and with 4 systems per block many warps per SM
//          hide the shuffle and shared-memory latency. Bound: latency of
//          the N dependent steps, then shared-memory bandwidth.
//   block  gj_common.cuh:block_gj, one block per system, the whole
//          augmented system rewritten from shared memory (or a global
//          workspace) at every pivot step.
//   panel  (N >= 33) gj_panel.cuh: pivot steps on [panel | C] only (n x
//          2 PW, PW = 16 columns), then one product per panel for the
//          trailing columns, on DMMA in f64 and register-tiled true f32 on
//          the CUDA cores; where the planes overflow shared memory the
//          workspace is read and written once per panel, not once per
//          step, and past N = 401 (f64) / 822 (f32) [panel | C] lives
//          there too. Bound: the panel's barriers at mid N, the product at
//          large N.
//
// K4 runs the same three tiers on [A | I] (width 2N), chosen by
// ops/gj.py:tier_for(n, dtype, inverse=True): warp for N <= 32, panel
// from N = 33, block only when forced (the comparisons). Its first form was
// block_gj at every N: at the ladder's noise shape (901 systems, N = 64,
// f64) its planes took 131 KB of shared memory, so one block per SM and
// 6.8 waves over 132 SMs, each of the 64 pivot steps rewriting the whole
// 64 x 128 complex block between block barriers: 2.911 ms, 1.5x
// torch.linalg.inv. The bounds: the inverse reads 2 N^2 and writes 2 N^2
// values per system (0.035 ms at the ladder's shape at 3.35 TB/s) and
// does ~8 N^3 real flops by a direct method;
//   warp   (N <= 32) gj_common.cuh:warp_inverse_kernel (K3's warp tier
//          too): warp_gj on [A | I], w = 2N, in the warp's slice of
//          shared memory at the odd stride 2N + 1; each lane writes its
//          own row of I; lane k's pivot row perm[k] holds row k of the
//          inverse in its right block, written back by coalesced stores.
//          Four systems per block, no block barrier; bound by the latency
//          of the N dependent steps (the amp's 901 x 11 shape takes ~20 us,
//          less than the wrapper's host time).
//   panel  (N >= 33) gj_panel.cuh with R = N right-hand sides, the
//          identity written as the planes are staged: the pivot steps touch
//          only [panel | C], and the trailing DMMA (f64) / register-tiled
//          (f32) product spans the identity block too, so the 2N columns
//          are read and written once per panel, not once per step; the
//          planes (N (2N) per plane) sit where gj_panel.cuh's plan puts
//          them (at N = 64 in f64: one workspace slot per resident block, 3
//          blocks per SM). Bound: the panel's pivot steps (barriers), then
//          the product.
//
// K1's multi entry (gj_complex_multi_*) reduces [A | B] on the planes for
// a right block B of r columns: the Schur tier's complex block solves
// (ops/schur.py: n = 3-4, r = 1 + N_I = 69-515, K x F of them), in
// gj_common.cuh:multi_solve_kernel up to n = 32 (a warp per system, A
// factored by warp_gj, each lane streaming its columns of B through the
// recorded steps; bound by the bytes of B and X) and the panel tier at
// R = r from 33.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"
#include "gj_panel.cuh"

namespace {

template <typename T>
__global__ void gj_complex_kernel(const T* __restrict__ A_re,
                                  const T* __restrict__ A_im,
                                  const T* __restrict__ b_re,
                                  const T* __restrict__ b_im,
                                  T* __restrict__ x_re, T* __restrict__ x_im,
                                  uint8_t* __restrict__ valid_out,
                                  T* __restrict__ workspace, int n, T eps2) {
  extern __shared__ unsigned char smem_raw[];
  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w = n + 1;
  const int nw = n * w;

  // shared layout: [planes (smem route only)] then block_gj's scratch
  T* base = reinterpret_cast<T*>(smem_raw);
  T *ar, *ai;
  if (workspace == nullptr) {
    ar = base;
    ai = base + nw;
    base += 2 * nw;
  } else {
    ar = workspace + (size_t)sys * 2 * nw;
    ai = ar + nw;
  }
  const gj::BlockScratch<T, 2> s = gj::carve<T, 2>(base, n, w);

  const T* Ar0 = A_re + (size_t)sys * n * n;
  const T* Ai0 = A_im + (size_t)sys * n * n;
  for (int idx = tid; idx < nw; idx += nt) {
    int i = idx / w, j = idx - i * w;
    ar[idx] = j < n ? Ar0[i * n + j] : b_re[(size_t)sys * n + i];
    ai[idx] = j < n ? Ai0[i * n + j] : b_im[(size_t)sys * n + i];
  }
  T* const planes[2] = {ar, ai};
  gj::block_gj<T, 2>(planes, n, w, eps2, s);
  // pivot row perm[k] carries x[k] in its RHS entry
  for (int k = tid; k < n; k += nt) {
    x_re[(size_t)sys * n + k] = ar[s.perm[k] * w + n];
    x_im[(size_t)sys * n + k] = ai[s.perm[k] * w + n];
  }
  if (tid == 0) valid_out[sys] = (uint8_t)(*s.ok_all);
}

// K4: one block reduces [A | I] of one system and writes its inverse.
template <typename T>
__global__ void gj_complex_inv_kernel(const T* __restrict__ A_re,
                                      const T* __restrict__ A_im,
                                      T* __restrict__ M_re,
                                      T* __restrict__ M_im,
                                      uint8_t* __restrict__ valid_out,
                                      T* __restrict__ workspace, int n,
                                      T eps2) {
  extern __shared__ unsigned char smem_raw[];
  const long long sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w = 2 * n;
  const int nw = n * w;
  const int nn = n * n;

  T* base = reinterpret_cast<T*>(smem_raw);
  T *ar, *ai;
  if (workspace == nullptr) {
    ar = base;
    ai = base + nw;
    base += 2 * nw;
  } else {
    ar = workspace + sys * 2 * nw;
    ai = ar + nw;
  }
  const gj::BlockScratch<T, 2> s = gj::carve<T, 2>(base, n, w);

  const T* Ar0 = A_re + sys * nn;
  const T* Ai0 = A_im + sys * nn;
  for (int idx = tid; idx < nw; idx += nt) {
    int i = idx / w, j = idx - i * w;
    if (j < n) {
      ar[idx] = Ar0[i * n + j];
      ai[idx] = Ai0[i * n + j];
    } else {
      ar[idx] = j - n == i ? T(1) : T(0);
      ai[idx] = T(0);
    }
  }
  T* const planes[2] = {ar, ai};
  gj::block_gj<T, 2>(planes, n, w, eps2, s);
  // pivot row perm[k] carries row k of the inverse in its right block
  for (int idx = tid; idx < nn; idx += nt) {
    const int k = idx / n, j = idx - k * n;
    const size_t q = (size_t)s.perm[k] * w + n + j;
    M_re[sys * nn + idx] = ar[q];
    M_im[sys * nn + idx] = ai[q];
  }
  if (tid == 0) valid_out[sys] = (uint8_t)(*s.ok_all);
}

template <typename T>
size_t smem_bytes(int n, bool planes_in_smem) {
  return gj::block_smem_bytes<T, 2>(n, n + 1, planes_in_smem);
}

template <typename T>
size_t inv_smem_bytes(int n, bool planes_in_smem) {
  return gj::block_smem_bytes<T, 2>(n, 2 * n, planes_in_smem);
}

enum Tier { WARP = 0, BLOCK = 1, PANEL = 2, MULTI = 3 };

template <typename T>
int launch_inv(const void* A_re, const void* A_im, void* M_re, void* M_im,
               void* valid, void* workspace, int batch, int n, double eps,
               int tier, void* stream) {
  const T eps2 = (T)(eps * eps);
  if (tier == WARP) {
    if (workspace != nullptr) return (int)cudaErrorInvalidValue;
    return gj::warp_inverse_launch<T, 2>(A_re, A_im, M_re, M_im, valid,
                                         batch, n, eps2, stream);
  }
  if (tier == PANEL)
    return gj::panel::launch<T, 2>(A_re, A_im, nullptr, nullptr, M_re, M_im,
                                   valid, workspace, batch, n, n, eps2,
                                   stream);
  if (tier != BLOCK) return (int)cudaErrorInvalidValue;
  int threads = n <= 8 ? 32 : (n <= 24 ? 128 : 256);
  size_t smem = inv_smem_bytes<T>(n, workspace == nullptr);
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gj_complex_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    gj_complex_inv_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
        (const T*)A_re, (const T*)A_im, (T*)M_re, (T*)M_im, (uint8_t*)valid,
        (T*)workspace, n, eps2);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A_re, const void* A_im, const void* b_re,
           const void* b_im, void* x_re, void* x_im, void* valid,
           void* workspace, int batch, int n, double eps, int tier,
           void* stream) {
  const T eps2 = (T)(eps * eps);
  if (tier == WARP) {
    if (workspace != nullptr) return (int)cudaErrorInvalidValue;
    return gj::warp_launch<T, 2>(A_re, A_im, b_re, b_im, x_re, x_im, valid,
                                 batch, n, eps2, stream);
  }
  if (tier == PANEL)
    return gj::panel::launch<T, 2>(A_re, A_im, b_re, b_im, x_re, x_im,
                                   valid, workspace, batch, n, 1, eps2,
                                   stream);
  if (tier != BLOCK) return (int)cudaErrorInvalidValue;
  int threads = n <= 8 ? 32 : (n <= 24 ? 128 : 256);
  size_t smem = smem_bytes<T>(n, workspace == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      gj_complex_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    gj_complex_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
        (const T*)A_re, (const T*)A_im, (const T*)b_re, (const T*)b_im,
        (T*)x_re, (T*)x_im, (uint8_t*)valid, (T*)workspace, n, eps2);
  }
  return (int)cudaGetLastError();
}

// K1's multi entry on planes, [A | B] with r right-hand sides (the Schur
// tier's complex block solves): gj_common.cuh:multi_solve_kernel for
// n <= 32, the panel tier at R = r from 33.
template <typename T>
int launch_multi(const void* A_re, const void* A_im, const void* B_re,
                 const void* B_im, void* X_re, void* X_im, void* valid,
                 void* workspace, int batch, int n, int r, double eps,
                 int tier, void* stream) {
  const T eps2 = (T)(eps * eps);
  if (tier == MULTI) {
    if (workspace != nullptr) return (int)cudaErrorInvalidValue;
    return gj::multi_launch<T, 2>(A_re, A_im, B_re, B_im, X_re, X_im, valid,
                                  batch, n, r, eps2, stream);
  }
  if (tier == PANEL)
    return gj::panel::launch<T, 2>(A_re, A_im, B_re, B_im, X_re, X_im,
                                   valid, workspace, batch, n, r, eps2,
                                   stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Systems of (2, N, N + 1) elements the tier's global workspace must hold
// for a batch of B, 0 when its planes stay in shared memory: B for the
// block tier past shared memory, one per resident block for the panel
// tier's plan (gj_panel.cuh), never for the warp tier.
int gj_complex_workspace_systems(int n, int batch, int is_double, int tier) {
  if (tier == WARP) return 0;
  if (tier == PANEL)
    return is_double ? gj::panel::workspace_systems<double, 2>(n, 1, batch)
                     : gj::panel::workspace_systems<float, 2>(n, 1, batch);
  const size_t bytes =
      is_double ? smem_bytes<double>(n, true) : smem_bytes<float>(n, true);
  return bytes > gj::SMEM_MAX ? batch : 0;
}

int gj_complex_f32(const void* A_re, const void* A_im, const void* b_re,
                   const void* b_im, void* x_re, void* x_im, void* valid,
                   void* workspace, int batch, int n, double eps, int tier,
                   void* stream) {
  return launch<float>(A_re, A_im, b_re, b_im, x_re, x_im, valid, workspace,
                       batch, n, eps, tier, stream);
}

int gj_complex_f64(const void* A_re, const void* A_im, const void* b_re,
                   const void* b_im, void* x_re, void* x_im, void* valid,
                   void* workspace, int batch, int n, double eps, int tier,
                   void* stream) {
  return launch<double>(A_re, A_im, b_re, b_im, x_re, x_im, valid, workspace,
                        batch, n, eps, tier, stream);
}

// The multi entry's workspace: systems of (2, N, N + r) for a batch of
// B, nonzero only where the panel tier's plan puts data in global memory.
int gj_complex_multi_workspace_systems(int n, int r, int batch,
                                       int is_double, int tier) {
  if (tier != PANEL) return 0;
  return is_double ? gj::panel::workspace_systems<double, 2>(n, r, batch)
                   : gj::panel::workspace_systems<float, 2>(n, r, batch);
}

int gj_complex_multi_f32(const void* A_re, const void* A_im,
                         const void* B_re, const void* B_im, void* X_re,
                         void* X_im, void* valid, void* workspace, int batch,
                         int n, int r, double eps, int tier, void* stream) {
  return launch_multi<float>(A_re, A_im, B_re, B_im, X_re, X_im, valid,
                             workspace, batch, n, r, eps, tier, stream);
}

int gj_complex_multi_f64(const void* A_re, const void* A_im,
                         const void* B_re, const void* B_im, void* X_re,
                         void* X_im, void* valid, void* workspace, int batch,
                         int n, int r, double eps, int tier, void* stream) {
  return launch_multi<double>(A_re, A_im, B_re, B_im, X_re, X_im, valid,
                              workspace, batch, n, r, eps, tier, stream);
}

// K4: systems of (2, N, 2N) elements the tier's global workspace must
// hold for a batch of B, 0 when its planes stay in shared memory: B for the
// block tier past shared memory, one per resident block for the panel
// tier's plan at R = N, never for the warp tier.
int gj_complex_inv_workspace_systems(int n, int batch, int is_double,
                                     int tier) {
  if (tier == WARP) return 0;
  if (tier == PANEL)
    return is_double ? gj::panel::workspace_systems<double, 2>(n, n, batch)
                     : gj::panel::workspace_systems<float, 2>(n, n, batch);
  const size_t bytes = is_double ? inv_smem_bytes<double>(n, true)
                                 : inv_smem_bytes<float>(n, true);
  return bytes > gj::SMEM_MAX ? batch : 0;
}

int gj_complex_inverse_f32(const void* A_re, const void* A_im, void* M_re,
                           void* M_im, void* valid, void* workspace,
                           int batch, int n, double eps, int tier,
                           void* stream) {
  return launch_inv<float>(A_re, A_im, M_re, M_im, valid, workspace, batch,
                           n, eps, tier, stream);
}

int gj_complex_inverse_f64(const void* A_re, const void* A_im, void* M_re,
                           void* M_im, void* valid, void* workspace,
                           int batch, int n, double eps, int tier,
                           void* stream) {
  return launch_inv<double>(A_re, A_im, M_re, M_im, valid, workspace, batch,
                            n, eps, tier, stream);
}

}  // extern "C"
