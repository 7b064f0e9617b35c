// K5 and K7: fused Monte-Carlo AC assemble-and-solve, one thread per system.
//
// K5 replaces the TPU kernel spicey_tpu/ops/pallas_mc_ac.py:_fused_kernel
// (pallas_call in mc_ac_fused_f32) and, by role, its f64-fidelity twin
// _fused_dd_kernel: the double instance of this kernel is the fidelity
// tier, with no df32 refinement. K7 replaces _fused_x_kernel (pallas_call
// in mc_ac_fused_x_f32). The plain versions are
// spicey_tpu_torch/ops/mc_ac_fused.py:mc_ac_fused_plain and
// mc_ac_fused_x_plain.
//
// For variant b and frequency f, the thread builds the augmented (N, N+1)
// complex planes from the stamp pattern (flat tables, read at run time so
// one build serves every deck) and the values column values[:, b], runs
// the complex one-hot-pivot Gauss-Jordan (gj_common.cuh:thread_gj: largest
// |a|^2 among unused rows, ties to the lowest row; invalid when |pivot|^2
// < eps^2). K5 writes only |x[node]| and valid to mag[f, b], valid[f, b].
// K7 writes the whole solution to xr[f, i, b], xi[f, i, b] (the TPU
// kernel's (F, N, B) layout: consecutive threads store consecutive b, so
// every store of a warp is coalesced) and valid[f, b]; with external RHS
// planes rr, ri (F, N, B) they replace the pattern's RHS column, and the
// tables are then packed without it (ops/mc_ac_fused.py:pack_pattern), so
// the zeroing never touches column N.
//
// What bounds them on the H100: the inputs are the (n_rows, B) values and
// K5's outputs two (F, B) planes, a few bytes per system, while the
// elimination is ~8 N^3/3 flops per system from on-chip memory, so K5 is
// bound by shared-memory bandwidth and latency, not device memory; K7
// adds 2N values per system written (4N read and written with external
// RHS), still below its flops at N = 16. The planes of a thread's system
// live in shared memory with the system index fastest, [(plane * N*(N+1)
// + i*(N+1) + j) * TPB + t], the layout the TPU kernel gets from its
// lanes: every access of a warp is 32 consecutive words, free of bank
// conflicts. (In registers, an N = 16 system would spill past 255
// registers a thread.) TPB is the largest of 256..32 systems a block
// whose planes fit in 112 KB, so two blocks share an SM where the planes
// allow it (at N = 16 in f64 one 32-thread block of 136 KB fills an SM).
// Blocks run over (variant tiles, frequencies); reads of values and
// writes of the outputs are coalesced along the variant axis.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2, KIND_W = 3,
              KIND_WINV = 4;
constexpr size_t SMEM_TARGET = 112 * 1024;

template <typename T>
__device__ __forceinline__ T term_value(int kind, T sign, T v, T w, T eps) {
  switch (kind) {
    case KIND_ONE: return sign;
    case KIND_INV: return sign / v;
    case KIND_LIN: return sign * v;
    case KIND_W: return sign * w * v;
    case KIND_WINV:
    default: {  // open circuit below eps (simulateAC.ts:47-52)
      T wl = w * v;
      return fabs(wl) < eps ? T(0) : -sign / wl;
    }
  }
}

// Build system (f, b)'s augmented planes at P (element q at P[q * tpb])
// from the tables: zero the positions no entry writes, then write each
// entry as the sum of its terms in table order.
template <typename T>
__device__ __forceinline__ void assemble(
    T* P, int tpb, const T* __restrict__ values, int B, int b, T w,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero, T eps) {
  for (int z = 0; z < n_zero; ++z) P[(size_t)zeros[z] * tpb] = T(0);
  for (int e = 0; e < n_ent; ++e) {
    const int pos = ent[3 * e], t0 = ent[3 * e + 1], t1 = ent[3 * e + 2];
    T acc = T(0);
    for (int q = t0; q < t1; ++q) {
      const int kind = terms[3 * q], row = terms[3 * q + 1];
      const T v = values[(size_t)row * B + b];
      const T tv = term_value<T>(kind, T(terms[3 * q + 2]), v, w, eps);
      acc = q == t0 ? tv : acc + tv;
    }
    P[(size_t)pos * tpb] = acc;
  }
}

template <typename T>
__global__ void mc_ac_fused_kernel(
    const T* __restrict__ freqs, const T* __restrict__ values, int B,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero, int n, int node_idx, T eps,
    T eps2, T* __restrict__ mag, uint8_t* __restrict__ valid) {
  extern __shared__ unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * tpb + t;
  const int f = blockIdx.y;
  if (b >= B) return;  // no barrier below: each thread owns its system
  T* P = reinterpret_cast<T*>(smem_raw) + t;  // element q at P[q * tpb]
  const int w1 = n + 1;
  const int nw = n * w1;
  assemble<T>(P, tpb, values, B, b, T(6.283185307179586) * freqs[f], ent,
              n_ent, terms, zeros, n_zero, eps);

  T* const planes[2] = {P, P + (size_t)nw * tpb};  // real, imaginary
  uint64_t perm;
  const bool ok = gj::thread_gj<T, 2>(planes, tpb, n, w1, eps2, perm);
  // pivot row perm[node] carries x[node] in its RHS entry
  const size_t q = (size_t)(gj::perm_at(perm, node_idx) * w1 + n) * tpb;
  const T xr = planes[0][q], xi = planes[1][q];
  mag[(size_t)f * B + b] = sqrt(xr * xr + xi * xi);
  valid[(size_t)f * B + b] = ok ? 1 : 0;
}

// K7: the whole solution; EXT_RHS takes column N from rr, ri.
template <typename T, bool EXT_RHS>
__global__ void mc_ac_fused_x_kernel(
    const T* __restrict__ freqs, const T* __restrict__ values, int B,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero, int n, T eps, T eps2,
    const T* __restrict__ rr, const T* __restrict__ ri, T* __restrict__ xr,
    T* __restrict__ xi, uint8_t* __restrict__ valid) {
  extern __shared__ unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * tpb + t;
  const int f = blockIdx.y;
  if (b >= B) return;  // no barrier below: each thread owns its system
  T* P = reinterpret_cast<T*>(smem_raw) + t;
  const int w1 = n + 1;
  const int nw = n * w1;
  assemble<T>(P, tpb, values, B, b, T(6.283185307179586) * freqs[f], ent,
              n_ent, terms, zeros, n_zero, eps);
  const size_t base = (size_t)f * n * B + b;  // (f, 0, b) of (F, N, B)
  if constexpr (EXT_RHS) {
    for (int i = 0; i < n; ++i) {
      P[(size_t)(i * w1 + n) * tpb] = rr[base + (size_t)i * B];
      P[(size_t)(nw + i * w1 + n) * tpb] = ri[base + (size_t)i * B];
    }
  }

  T* const planes[2] = {P, P + (size_t)nw * tpb};  // real, imaginary
  uint64_t perm;
  const bool ok = gj::thread_gj<T, 2>(planes, tpb, n, w1, eps2, perm);
  // pivot row perm[i] carries x[i] in its RHS entry
  for (int i = 0; i < n; ++i) {
    const size_t q = (size_t)(gj::perm_at(perm, i) * w1 + n) * tpb;
    xr[base + (size_t)i * B] = planes[0][q];
    xi[base + (size_t)i * B] = planes[1][q];
  }
  valid[(size_t)f * B + b] = ok ? 1 : 0;
}

// Threads per block for systems of n unknowns: the largest of 256..32
// whose planes fit in SMEM_TARGET; 0 when n is out of range or even 32
// systems' planes exceed one block's shared memory.
template <typename T>
int threads_per_block(int n, size_t* smem) {
  if (n < 1 || n > gj::THREAD_MAX_N) return 0;
  const size_t per_sys = 2 * (size_t)n * (n + 1) * sizeof(T);
  int tpb = 256;
  while (tpb > 32 && tpb * per_sys > SMEM_TARGET) tpb >>= 1;
  *smem = tpb * per_sys;
  return *smem > gj::SMEM_MAX ? 0 : tpb;
}

template <typename T>
int launch(const void* freqs, const void* values, int F, int B,
           const void* ent, int n_ent, const void* terms, const void* zeros,
           int n_zero, int n, int node_idx, double eps, void* mag,
           void* valid, void* stream) {
  size_t smem = 0;
  const int tpb = threads_per_block<T>(n, &smem);
  if (tpb == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_ac_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && F > 0) {
    dim3 grid((B + tpb - 1) / tpb, F);
    mc_ac_fused_kernel<T><<<grid, tpb, smem, (cudaStream_t)stream>>>(
        (const T*)freqs, (const T*)values, B, (const int*)ent, n_ent,
        (const int*)terms, (const int*)zeros, n_zero, n, node_idx, (T)eps,
        (T)(eps * eps), (T*)mag, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool EXT_RHS>
int launch_x(const void* freqs, const void* values, int F, int B,
             const void* ent, int n_ent, const void* terms,
             const void* zeros, int n_zero, int n, double eps,
             const void* rr, const void* ri, void* xr, void* xi,
             void* valid, void* stream) {
  size_t smem = 0;
  const int tpb = threads_per_block<T>(n, &smem);
  if (tpb == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_ac_fused_x_kernel<T, EXT_RHS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && F > 0) {
    dim3 grid((B + tpb - 1) / tpb, F);
    mc_ac_fused_x_kernel<T, EXT_RHS>
        <<<grid, tpb, smem, (cudaStream_t)stream>>>(
            (const T*)freqs, (const T*)values, B, (const int*)ent, n_ent,
            (const int*)terms, (const int*)zeros, n_zero, n, (T)eps,
            (T)(eps * eps), (const T*)rr, (const T*)ri, (T*)xr, (T*)xi,
            (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

// rr == nullptr: the pattern's RHS; otherwise the external RHS planes.
template <typename T>
int launch_x_mode(const void* freqs, const void* values, int F, int B,
                  const void* ent, int n_ent, const void* terms,
                  const void* zeros, int n_zero, int n, double eps,
                  const void* rr, const void* ri, void* xr, void* xi,
                  void* valid, void* stream) {
  if (rr == nullptr)
    return launch_x<T, false>(freqs, values, F, B, ent, n_ent, terms, zeros,
                              n_zero, n, eps, rr, ri, xr, xi, valid, stream);
  return launch_x<T, true>(freqs, values, F, B, ent, n_ent, terms, zeros,
                           n_zero, n, eps, rr, ri, xr, xi, valid, stream);
}

}  // namespace

extern "C" {

int mc_ac_fused_f32(const void* freqs, const void* values, int F, int B,
                    const void* ent, int n_ent,
                    const void* terms, const void* zeros, int n_zero, int n,
                    int node_idx, double eps, void* mag, void* valid,
                    void* stream) {
  return launch<float>(freqs, values, F, B, ent, n_ent, terms, zeros,
                       n_zero, n, node_idx, eps, mag, valid, stream);
}

int mc_ac_fused_f64(const void* freqs, const void* values, int F, int B,
                    const void* ent, int n_ent,
                    const void* terms, const void* zeros, int n_zero, int n,
                    int node_idx, double eps, void* mag, void* valid,
                    void* stream) {
  return launch<double>(freqs, values, F, B, ent, n_ent, terms,
                        zeros, n_zero, n, node_idx, eps, mag, valid, stream);
}

int mc_ac_fused_x_f32(const void* freqs, const void* values, int F, int B,
                      const void* ent, int n_ent, const void* terms,
                      const void* zeros, int n_zero, int n, double eps,
                      const void* rr, const void* ri, void* xr, void* xi,
                      void* valid, void* stream) {
  return launch_x_mode<float>(freqs, values, F, B, ent, n_ent, terms, zeros,
                              n_zero, n, eps, rr, ri, xr, xi, valid, stream);
}

int mc_ac_fused_x_f64(const void* freqs, const void* values, int F, int B,
                      const void* ent, int n_ent, const void* terms,
                      const void* zeros, int n_zero, int n, double eps,
                      const void* rr, const void* ri, void* xr, void* xi,
                      void* valid, void* stream) {
  return launch_x_mode<double>(freqs, values, F, B, ent, n_ent, terms,
                               zeros, n_zero, n, eps, rr, ri, xr, xi, valid,
                               stream);
}

}  // extern "C"
