// K2 and K3: batched real Gauss-Jordan solve and inverse.
//
// K2 replaces the TPU kernel spicey_tpu/ops/pallas_gj.py:_gj_real_kernel
// (pallas_call in _solve_real_f32): A x = b for a batch of (N, N) systems.
// K3 replaces _gj_inv_real_kernel (pallas_call in _inverse_real_f32,
// loop _real_inv_scratch): the reduction of [A | I], here written out as
// the TRUE inverse (the TPU kernel returns the row-permuted M and the
// pivot map; this kernel un-permutes before it writes). The plain
// versions are spicey_tpu_torch/ops/linsolve.py:gj_solve and gj_inverse:
// pivot = the unused row with the largest |a|, ties to the lowest row,
// NaN highest; invalid when |pivot| < eps, eliminating on through an
// invalid pivot with a unit divisor. Both run in float and double: Hopper
// has native f64, so the f64 instance replaces the TPU's f32 kernel plus
// refinement outside it.
//
// Layout: batch-first A (B, N, N), b (B, N) -> x (B, N) [K2] or
// Ainv (B, N, N) [K3], valid (B,) as bytes (a torch.bool tensor).
//
// What bounds it on the H100: the systems are read once and the answers
// written once (a few bytes per flop at N = 3..6, where the transient
// main path runs it), while the elimination is 2N^2(N+1) [K2] or 4N^3
// [K3] flops from on-chip memory. The solve (K2) has four tiers, chosen
// by the wrapper (ops/gj_real.py:tier_for) from N and the dtype:
//   - thread (N <= 16, gj::THREAD_MAX_N): one THREAD per system, the
//     augmented system in shared memory with the system index fastest
//     (conflict-free warp accesses, no barriers in the elimination), as
//     kernel K5 does. The block's systems are contiguous in A, so they are
//     loaded with coalesced reads and scattered into that layout. This is
//     the shape of the Newton passes (B = 1..1e5, N = 3..7); the
//     factor-once inverse (B up to 1e6, N = 3) takes K3's register form.
//   - warp (N <= 32): one WARP per system (gj_common.cuh:warp_gj), four
//     systems per block, no block barrier: a shuffle argmax for the pivot
//     and __syncwarp between the steps.
//   - block: one BLOCK per system (gj::block_gj, the elimination of K1 on
//     real elements), planes in dynamic shared memory up to the 227 KB a
//     block may hold and in a global workspace the wrapper allocates above
//     that (K3 at N = 128 in f64: [A | I] is 256 KB).
//   - panel (N >= 33): gj_panel.cuh, pivot steps on [panel | C] (n x 2 PW,
//     PW = 16 columns) and one DMMA (f64) or register-tiled f32 product
//     per panel for the trailing columns; past N = 822 (f64) / 1629 (f32)
//     [panel | C] lives in the workspace beside the planes.
// The inverse (K3) runs in four tiers, chosen by the same function
// (tier_for(n, dtype, inverse=True)), each the plain gj_inverse's pivots,
// flags and true inverse: register (N <= 8, [A | I] in registers without
// spilling: gj_real_inv_reg_kernel below), warp (to N = 32,
// gj_common.cuh:warp_inverse_kernel, K4's warp tier on one plane), panel
// (from N = 33, gj_panel.cuh at R = N, as K4 runs it) and block (block_gj,
// only when forced, for the comparisons). Its main path is the factor-once inverse of every linear
// transient: 1M x N = 3 for the tran-1M loop, 2048 x 64 for a ladder's
// Monte-Carlo transient, one N = 129 matrix for a flat deck's simulate().
// There it reads N^2 and writes N^2 values per system, against 2 N^3
// flops: the bytes bound it up to N = 160 in f64 (80 in f32) at the
// H100's 3.35 TB/s and 67 TFLOP/s, the operations beyond.
//
// K2's multi entry (gj_real_solve_multi_*) reduces [A | B] for a right
// block B of r columns: the Schur tier's block solves (ops/schur.py), tiny
// blocks (n = 3-4) with wide borders (r = 1 + N_I, 69-515), K x B of them.
// Up to n = 32 it runs gj_common.cuh:multi_solve_kernel (one warp per
// system: warp_gj factors A, each lane streams its columns of B through
// the recorded steps), bound by the bytes of B and X; from 33 the panel
// tier at R = r (gj_panel.cuh reads B per system).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"
#include "gj_panel.cuh"

namespace {

constexpr size_t SMEM_TARGET = 112 * 1024;  // two blocks share an SM

// augmented width: [A | b] or [A | I]
__host__ __device__ inline int width(int n, bool inv) {
  return inv ? 2 * n : n + 1;
}

template <typename T>
__global__ void gj_real_thread_kernel(const T* __restrict__ A,
                                      const T* __restrict__ b,
                                      T* __restrict__ out,
                                      uint8_t* __restrict__ valid, int B,
                                      int n, T eps) {
  extern __shared__ unsigned char smem_raw[];
  const int tpb = blockDim.x, t = threadIdx.x;
  const long long first = (long long)blockIdx.x * tpb;
  const int nsys = (int)min((long long)tpb, (long long)B - first);
  const int w = width(n, false);
  const int nn = n * n;
  T* S = reinterpret_cast<T*>(smem_raw);  // element q of system s: S[q*tpb+s]

  // coalesced loads of the block's contiguous systems
  const T* A0 = A + first * nn;
  for (int idx = t; idx < nsys * nn; idx += tpb) {
    const int s = idx / nn, q = idx - s * nn;
    const int i = q / n, j = q - i * n;
    S[(size_t)(i * w + j) * tpb + s] = A0[idx];
  }
  const T* b0 = b + first * n;
  for (int idx = t; idx < nsys * n; idx += tpb) {
    const int s = idx / n, i = idx - s * n;
    S[(size_t)(i * w + n) * tpb + s] = b0[idx];
  }
  __syncthreads();
  if (t >= nsys) return;  // no barrier below

  T* const a[1] = {S + t};
  uint64_t perm;
  const bool ok = gj::thread_gj<T, 1>(a, tpb, n, w, eps, perm);
  const long long sys = first + t;
  // pivot row perm[k] carries x[k] in its last column
  for (int k = 0; k < n; ++k)
    out[sys * n + k] = a[0][(size_t)(gj::perm_at(perm, k) * w + n) * tpb];
  valid[sys] = ok ? 1 : 0;
}

// K3's register form: one thread per system, [A | I] reduced in place in
// its registers (gj_common.cuh:reg_gj_inv_real), N a template constant.
// Warp q of the block owns 32 consecutive systems and a tile of shared
// memory (system s at s * LD, LD = N^2 | 1 odd, so the lanes' rows fall in
// distinct banks): the warp copies its systems' contiguous N^2 elements
// into the tile with coalesced reads, each lane takes its system from the
// tile into registers, eliminates, and writes its inverse back into its
// own slot, entry (step[i], piv[m]) from a[i][m] (the un-permuting costs
// a shared-memory address, not a select); the warp then stores the tile
// with coalesced writes. No block barrier: __syncwarp orders the tile.
constexpr int REG_MAX_N = 8;    // instances N = 1..REG_MAX_N
constexpr int REG_WARPS = 4;    // warps (of 32 systems each) per block

template <int N>
__host__ __device__ constexpr int reg_ld() { return (N * N) | 1; }

template <typename T, int N>
__global__ void __launch_bounds__(32 * REG_WARPS)
    gj_real_inv_reg_kernel(const T* __restrict__ A, T* __restrict__ out,
                           uint8_t* __restrict__ valid, long long batch,
                           T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NN = N * N, LD = reg_ld<N>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = ((long long)blockIdx.x * REG_WARPS + warp) * 32;
  if (first >= batch) return;  // the whole warp: no barrier follows
  const int count = (int)min(32LL, batch - first);
  T* tile = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 32 * LD;
  const T* src = A + first * NN;
  for (int idx = lane; idx < count * NN; idx += 32) {
    const int s = idx / NN;
    tile[s * LD + idx - s * NN] = src[idx];
  }
  __syncwarp();
  if (lane < count) {
    T* own = tile + lane * LD;
    T a[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] = own[i * N + j];
    int piv[N], step[N];
    const bool ok = gj::reg_gj_inv_real<T, N>(a, eps, piv, step);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int m = 0; m < N; ++m) own[step[i] * N + piv[m]] = a[i][m];
    valid[first + lane] = ok ? 1 : 0;
  }
  __syncwarp();
  T* dst = out + first * NN;
  for (int idx = lane; idx < count * NN; idx += 32) {
    const int s = idx / NN;
    dst[idx] = tile[s * LD + idx - s * NN];
  }
}

template <typename T, bool INV>
__global__ void gj_real_block_kernel(const T* __restrict__ A,
                                     const T* __restrict__ b,
                                     T* __restrict__ out,
                                     uint8_t* __restrict__ valid,
                                     T* __restrict__ workspace, int n, T eps) {
  extern __shared__ unsigned char smem_raw[];
  const long long sys = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w = width(n, INV);
  const int nw = n * w;
  const int nn = n * n;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* a0;
  if (workspace == nullptr) {
    a0 = base;
    base += nw;
  } else {
    a0 = workspace + sys * nw;
  }
  const gj::BlockScratch<T, 1> s = gj::carve<T, 1>(base, n, w);
  const T* As = A + sys * nn;
  for (int idx = tid; idx < nw; idx += nt) {
    const int i = idx / w, j = idx - i * w;
    if (j < n)
      a0[idx] = As[i * n + j];
    else if (INV)
      a0[idx] = j - n == i ? T(1) : T(0);
    else
      a0[idx] = b[sys * n + i];
  }
  T* const planes[1] = {a0};
  gj::block_gj<T, 1>(planes, n, w, eps, s);
  if (INV) {
    for (int idx = tid; idx < nn; idx += nt) {
      const int k = idx / n, j = idx - k * n;
      out[sys * nn + idx] = a0[s.perm[k] * w + n + j];
    }
  } else {
    for (int k = tid; k < n; k += nt) out[sys * n + k] = a0[s.perm[k] * w + n];
  }
  if (tid == 0) valid[sys] = (uint8_t)(*s.ok_all);
}

template <typename T>
size_t block_smem(int n, bool inv, bool planes_in_smem) {
  return gj::block_smem_bytes<T, 1>(n, width(n, inv), planes_in_smem);
}

template <typename T>
int launch_thread(const void* A, const void* b, void* out, void* valid,
                  int batch, int n, double eps, void* stream) {
  if (n < 1 || n > gj::THREAD_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t per_sys = (size_t)n * width(n, false) * sizeof(T);
  int tpb = 256;
  while (tpb > 32 && tpb * per_sys > SMEM_TARGET) tpb >>= 1;
  const size_t smem = tpb * per_sys;
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gj_real_thread_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int blocks = (int)(((long long)batch + tpb - 1) / tpb);
    gj_real_thread_kernel<T><<<blocks, tpb, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const T*)b, (T*)out, (uint8_t*)valid, batch, n,
        (T)eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_reg_n(const void* A, void* out, void* valid, int batch, T eps,
                 void* stream) {
  const size_t smem = (size_t)REG_WARPS * 32 * reg_ld<N>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gj_real_inv_reg_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int per_block = 32 * REG_WARPS;
    const int blocks = (int)(((long long)batch + per_block - 1) / per_block);
    gj_real_inv_reg_kernel<T, N><<<blocks, per_block, smem,
                                   (cudaStream_t)stream>>>(
        (const T*)A, (T*)out, (uint8_t*)valid, (long long)batch, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reg(const void* A, void* out, void* valid, int batch, int n,
               double eps, void* stream) {
  static_assert(REG_MAX_N == 8, "one case below per instance");
  const T e = (T)eps;
  switch (n) {
    case 1: return launch_reg_n<T, 1>(A, out, valid, batch, e, stream);
    case 2: return launch_reg_n<T, 2>(A, out, valid, batch, e, stream);
    case 3: return launch_reg_n<T, 3>(A, out, valid, batch, e, stream);
    case 4: return launch_reg_n<T, 4>(A, out, valid, batch, e, stream);
    case 5: return launch_reg_n<T, 5>(A, out, valid, batch, e, stream);
    case 6: return launch_reg_n<T, 6>(A, out, valid, batch, e, stream);
    case 7: return launch_reg_n<T, 7>(A, out, valid, batch, e, stream);
    case 8: return launch_reg_n<T, 8>(A, out, valid, batch, e, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool INV>
int launch_block(const void* A, const void* b, void* out, void* valid,
                 void* workspace, int batch, int n, double eps,
                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = n <= 24 ? 128 : 256;
  const size_t smem = block_smem<T>(n, INV, workspace == nullptr);
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gj_real_block_kernel<T, INV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    gj_real_block_kernel<T, INV><<<batch, threads, smem,
                                   (cudaStream_t)stream>>>(
        (const T*)A, (const T*)b, (T*)out, (uint8_t*)valid, (T*)workspace,
        n, (T)eps);
  }
  return (int)cudaGetLastError();
}

// the wrappers' tier codes (ops/gj_real.py:CODES); THREAD is K2's only,
// REGISTER K3's only, MULTI the multi-RHS entry's
enum Tier { WARP = 0, BLOCK = 1, PANEL = 2, THREAD = 3, REGISTER = 4,
            MULTI = 5 };

template <typename T>
int launch_solve(const void* A, const void* b, void* x, void* valid,
                 void* workspace, int batch, int n, double eps, int tier,
                 void* stream) {
  switch (tier) {
    case THREAD:
      if (workspace != nullptr) return (int)cudaErrorInvalidValue;
      return launch_thread<T>(A, b, x, valid, batch, n, eps, stream);
    case WARP:
      if (workspace != nullptr) return (int)cudaErrorInvalidValue;
      return gj::warp_launch<T, 1>(A, nullptr, b, nullptr, x, nullptr, valid,
                                   batch, n, (T)eps, stream);
    case BLOCK:
      return launch_block<T, false>(A, b, x, valid, workspace, batch, n, eps,
                                    stream);
    case PANEL:
      return gj::panel::launch<T, 1>(A, nullptr, b, nullptr, x, nullptr,
                                     valid, workspace, batch, n, 1, (T)eps,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3 in the tier the wrapper names (ops/gj_real.py:tier_for(inverse=True)):
// the panel tier at R = N right-hand sides, the identity written as the
// planes are staged, as K4 runs it.
template <typename T>
int launch_inverse(const void* A, void* out, void* valid, void* workspace,
                   int batch, int n, double eps, int tier, void* stream) {
  switch (tier) {
    case REGISTER:
      if (workspace != nullptr) return (int)cudaErrorInvalidValue;
      return launch_reg<T>(A, out, valid, batch, n, eps, stream);
    case WARP:
      if (workspace != nullptr) return (int)cudaErrorInvalidValue;
      return gj::warp_inverse_launch<T, 1>(A, nullptr, out, nullptr, valid,
                                           batch, n, (T)eps, stream);
    case BLOCK:
      return launch_block<T, true>(A, nullptr, out, valid, workspace, batch,
                                   n, eps, stream);
    case PANEL:
      return gj::panel::launch<T, 1>(A, nullptr, nullptr, nullptr, out,
                                     nullptr, valid, workspace, batch, n, n,
                                     (T)eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2's multi entry, [A | B] with r right-hand sides (the Schur tier's
// block solves and its interface solve with several columns): the warp
// kernel of gj_common.cuh:multi_solve_kernel for n <= 32, the panel tier
// at R = r from 33 (gj_panel.cuh reads B (n, r) per system).
template <typename T>
int launch_multi(const void* A, const void* B, void* X, void* valid,
                 void* workspace, int batch, int n, int r, double eps,
                 int tier, void* stream) {
  switch (tier) {
    case MULTI:
      if (workspace != nullptr) return (int)cudaErrorInvalidValue;
      return gj::multi_launch<T, 1>(A, nullptr, B, nullptr, X, nullptr,
                                    valid, batch, n, r, (T)eps, stream);
    case PANEL:
      return gj::panel::launch<T, 1>(A, nullptr, B, nullptr, X, nullptr,
                                     valid, workspace, batch, n, r, (T)eps,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Systems of (N, width) elements the tier's global workspace must hold
// for a batch of B, 0 when its planes stay in shared memory (or
// registers): B for the block tier past shared memory, one per resident
// block for the panel tier's plan (gj_panel.cuh; R = 1 for the solve, N
// for the inverse), never for the register, thread and warp tiers.
int gj_real_workspace_systems(int n, int batch, int inv, int is_double,
                              int tier) {
  if (tier == THREAD || tier == WARP || tier == REGISTER) return 0;
  if (tier == PANEL) {
    const int r = inv ? n : 1;
    return is_double ? gj::panel::workspace_systems<double, 1>(n, r, batch)
                     : gj::panel::workspace_systems<float, 1>(n, r, batch);
  }
  const size_t bytes = is_double ? block_smem<double>(n, inv, true)
                                 : block_smem<float>(n, inv, true);
  return bytes > gj::SMEM_MAX ? batch : 0;
}

// The multi entry's workspace: systems of (N, N + r) for a batch of B,
// nonzero only where the panel tier's plan puts data in global memory.
int gj_real_multi_workspace_systems(int n, int r, int batch, int is_double,
                                    int tier) {
  if (tier != PANEL) return 0;
  return is_double ? gj::panel::workspace_systems<double, 1>(n, r, batch)
                   : gj::panel::workspace_systems<float, 1>(n, r, batch);
}

int gj_real_solve_multi_f32(const void* A, const void* B, void* X,
                            void* valid, void* workspace, int batch, int n,
                            int r, double eps, int tier, void* stream) {
  return launch_multi<float>(A, B, X, valid, workspace, batch, n, r, eps,
                             tier, stream);
}

int gj_real_solve_multi_f64(const void* A, const void* B, void* X,
                            void* valid, void* workspace, int batch, int n,
                            int r, double eps, int tier, void* stream) {
  return launch_multi<double>(A, B, X, valid, workspace, batch, n, r, eps,
                              tier, stream);
}

int gj_real_solve_f32(const void* A, const void* b, void* x, void* valid,
                      void* workspace, int batch, int n, double eps,
                      int tier, void* stream) {
  return launch_solve<float>(A, b, x, valid, workspace, batch, n, eps, tier,
                             stream);
}

int gj_real_solve_f64(const void* A, const void* b, void* x, void* valid,
                      void* workspace, int batch, int n, double eps,
                      int tier, void* stream) {
  return launch_solve<double>(A, b, x, valid, workspace, batch, n, eps, tier,
                              stream);
}

int gj_real_inverse_f32(const void* A, void* inv, void* valid,
                        void* workspace, int batch, int n, double eps,
                        int tier, void* stream) {
  return launch_inverse<float>(A, inv, valid, workspace, batch, n, eps, tier,
                               stream);
}

int gj_real_inverse_f64(const void* A, void* inv, void* valid,
                        void* workspace, int batch, int n, double eps,
                        int tier, void* stream) {
  return launch_inverse<double>(A, inv, valid, workspace, batch, n, eps,
                                tier, stream);
}

}  // extern "C"
