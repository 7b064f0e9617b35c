// K8: fused Monte-Carlo LINEAR transient, one thread per variant, f32.
//
// Replaces the TPU kernel spicey_tpu/ops/pallas_mc_tran.py:
// _fused_tran_kernel (pallas_call in mc_tran_fused_f32, linear branch).
// The plain version is spicey_tpu_torch/ops/mc_tran_fused.py:
// mc_tran_fused_plain.
//
// Under backward-Euler companions a linear circuit's MNA matrix is the
// same at every step; only the RHS moves, through the source grid and the
// companion state. Per variant b the thread
//   1. builds A from the stamp pattern (flat int32 tables read at run
//      time, so one build serves every deck) and the value slab column
//      values[:, b], rows [R | gc = C/dt | gl = dt/L | g | e | f | h]
//      (the caller folds dt in, so dt never enters the kernel);
//   2. reduces [A | I] once (gj_common.cuh:thread_gj, shared with K2/K3);
//   3. runs the S+1 steps: RHS = sources (row-broadcast reads of the
//      (S+1, nSrc) grid in device memory), then the C terms gc*v_prev,
//      then the L terms i_prev, each row summed in that order as the TPU
//      kernel sums it; x = A^-1 b over the rows that carry RHS terms in
//      ascending order; record V(node); commit v_prev = v(C), i_prev +=
//      gl * v(L) (simulateTRAN.ts:221-231). Step 0 is the quasi-DC
//      bootstrap from zero state (simulateTRAN.ts:147-149).
//
// What bounds it on the H100: a variant reads its n_rows values once and
// writes S+1 floats of trajectory; everything per step stays on chip. At
// the main path's N = 3, S+1 = 201 the trajectory write (4 bytes per
// variant per step, 0.8 GB at 1M variants) dominates the bytes and the
// work is ~40 flops per step, so the kernel is bound by device-memory
// writes. The design writes out[s * B + b]: for each step the warp's 32
// variants store 128 contiguous bytes. The [A | I] planes, RHS, solution
// and companion state live in shared memory with the variant index
// fastest (conflict-free), the source grid is read through L1 by every
// thread at the same address (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2;
constexpr size_t SMEM_TARGET = 112 * 1024;

__device__ __forceinline__ float term_value(int kind, float sign, float v) {
  switch (kind) {
    case KIND_ONE: return sign;
    case KIND_INV: return sign / v;
    case KIND_LIN:
    default: return sign * v;
  }
}

__global__ void mc_tran_fused_kernel(
    const float* __restrict__ vs, int n_src, int n_steps,
    const float* __restrict__ values, int B,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero,
    const int* __restrict__ bsrc, int n_bsrc,
    const int* __restrict__ cst, int n_c,
    const int* __restrict__ lst, int n_l, unsigned b_rows, int n,
    int node_idx, float eps, float* __restrict__ out,
    uint8_t* __restrict__ valid) {
  extern __shared__ unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int t = threadIdx.x;
  const long long b = (long long)blockIdx.x * tpb + t;
  if (b >= B) return;  // no barrier below: each thread owns its variant
  const int w = 2 * n;
  // per-thread region, element q at P[q * tpb]: [A | I] (n*w), rhs (n),
  // x (n), v_prev (n_c), i_prev (n_l)
  float* P = reinterpret_cast<float*>(smem_raw) + t;
  float* rhs = P + (size_t)n * w * tpb;
  float* x = rhs + (size_t)n * tpb;
  float* vp = x + (size_t)n * tpb;
  float* ip = vp + (size_t)n_c * tpb;

  // 1. A from the pattern; the right block becomes I
  for (int z = 0; z < n_zero; ++z) P[(size_t)zeros[z] * tpb] = 0.0f;
  for (int e = 0; e < n_ent; ++e) {
    const int pos = ent[3 * e], t0 = ent[3 * e + 1], t1 = ent[3 * e + 2];
    float acc = 0.0f;
    for (int q = t0; q < t1; ++q) {
      const float v = values[(size_t)terms[3 * q + 1] * B + b];
      const float tv = term_value(terms[3 * q], (float)terms[3 * q + 2], v);
      acc = q == t0 ? tv : acc + tv;
    }
    P[(size_t)pos * tpb] = acc;
  }
  for (int i = 0; i < n; ++i) P[(size_t)(i * w + n + i) * tpb] = 1.0f;

  // 2. factor once
  float* const a[1] = {P};
  uint64_t perm;
  valid[b] = gj::thread_gj<float, 1>(a, tpb, n, w, eps, perm) ? 1 : 0;

  // 3. the time loop
  for (int k = 0; k < n_c; ++k) vp[(size_t)k * tpb] = 0.0f;
  for (int k = 0; k < n_l; ++k) ip[(size_t)k * tpb] = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    for (int i = 0; i < n; ++i) rhs[(size_t)i * tpb] = 0.0f;
    const float* vs_s = vs + (size_t)s * n_src;
    for (int q = 0; q < n_bsrc; ++q) {
      float* r = rhs + (size_t)bsrc[3 * q] * tpb;
      *r = *r + vs_s[bsrc[3 * q + 1]] * (float)bsrc[3 * q + 2];
    }
    for (int k = 0; k < n_c; ++k) {
      // stamp_current with I = -gc * v_prev: b[i1] += gc*v, b[i2] -= gc*v
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float tv = values[(size_t)cst[3 * k + 2] * B + b] *
                       vp[(size_t)k * tpb];
      if (i1 < n) rhs[(size_t)i1 * tpb] = rhs[(size_t)i1 * tpb] + tv;
      if (i2 < n) rhs[(size_t)i2 * tpb] = rhs[(size_t)i2 * tpb] - tv;
    }
    for (int k = 0; k < n_l; ++k) {
      // stamp_current with I = +i_prev: b[i1] -= i, b[i2] += i
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float il = ip[(size_t)k * tpb];
      if (i1 < n) rhs[(size_t)i1 * tpb] = rhs[(size_t)i1 * tpb] - il;
      if (i2 < n) rhs[(size_t)i2 * tpb] = rhs[(size_t)i2 * tpb] + il;
    }
    for (int i = 0; i < n; ++i) {
      // row i of A^-1 is the right block of pivot row perm[i]
      const float* inv_i = P + (size_t)(gj::perm_at(perm, i) * w + n) * tpb;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j)
        if ((b_rows >> j) & 1u)
          acc = acc + inv_i[(size_t)j * tpb] * rhs[(size_t)j * tpb];
      x[(size_t)i * tpb] = acc;
    }
    out[(size_t)s * B + b] = x[(size_t)node_idx * tpb];
    for (int k = 0; k < n_c; ++k) {
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float v1 = i1 < n ? x[(size_t)i1 * tpb] : 0.0f;
      const float v2 = i2 < n ? x[(size_t)i2 * tpb] : 0.0f;
      vp[(size_t)k * tpb] = v1 - v2;
    }
    for (int k = 0; k < n_l; ++k) {
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float v1 = i1 < n ? x[(size_t)i1 * tpb] : 0.0f;
      const float v2 = i2 < n ? x[(size_t)i2 * tpb] : 0.0f;
      const float gl = values[(size_t)lst[3 * k + 2] * B + b];
      ip[(size_t)k * tpb] = ip[(size_t)k * tpb] + gl * (v1 - v2);
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes per variant; the wrapper refuses a deck whose 32
// variants would not fit in one block.
size_t mc_tran_fused_bytes_per_variant(int n, int n_c, int n_l) {
  return ((size_t)n * 2 * n + 2 * (size_t)n + n_c + n_l) * sizeof(float);
}

int mc_tran_fused_f32(const void* vs, int n_src, int n_steps,
                      const void* values, int B, const void* ent, int n_ent,
                      const void* terms, const void* zeros, int n_zero,
                      const void* bsrc, int n_bsrc, const void* cst, int n_c,
                      const void* lst, int n_l, unsigned b_rows, int n,
                      int node_idx, double eps, void* out, void* valid,
                      void* stream) {
  if (n < 1 || n > gj::THREAD_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t per = mc_tran_fused_bytes_per_variant(n, n_c, n_l);
  int tpb = 256;
  while (tpb > 32 && tpb * per > SMEM_TARGET) tpb >>= 1;
  const size_t smem = tpb * per;
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_tran_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && n_steps > 0) {
    const int blocks = (int)(((long long)B + tpb - 1) / tpb);
    mc_tran_fused_kernel<<<blocks, tpb, smem, (cudaStream_t)stream>>>(
        (const float*)vs, n_src, n_steps, (const float*)values, B,
        (const int*)ent, n_ent, (const int*)terms, (const int*)zeros, n_zero,
        (const int*)bsrc, n_bsrc, (const int*)cst, n_c, (const int*)lst, n_l,
        b_rows, n, node_idx, (float)eps, (float*)out, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
