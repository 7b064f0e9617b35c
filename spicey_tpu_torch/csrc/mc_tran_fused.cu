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
//   2. reduces [A | I] once;
//   3. runs the S+1 steps: RHS = sources (row-broadcast reads of the
//      (S+1, nSrc) grid in device memory), then the C terms gc*v_prev,
//      then the L terms i_prev, each row summed in that order as the TPU
//      kernel sums it; x = A^-1 b over the rows that carry RHS terms in
//      ascending order; record V(node); commit v_prev = v(C), i_prev +=
//      gl * v(L) (simulateTRAN.ts:221-231). Step 0 is the quasi-DC
//      bootstrap from zero state (simulateTRAN.ts:147-149).
//
// Two forms, chosen by N (ops/mc_tran_fused.py:k8_form_for):
//  - the register form (N <= K8_REG_MAX_N, an instance per N up to
//    REG_MAX_N): A is built in the thread's shared-memory region at the
//    table's positions, loaded into registers beside the identity and
//    reduced there (gj_common.cuh:reg_gj_real on width 2N); A^-1 stays in
//    N^2 registers for the whole loop (row i the right block of the row
//    that pivoted column i, picked by selects), gc and gl are read once
//    per variant into the thread's region, and each step's RHS is built
//    at its run-time rows in shared memory and loaded into registers for
//    the product;
//  - the shared form (N above the cap, up to FUSED_MAX_N = 16): [A | I],
//    the RHS and x in shared memory, reduced in place by
//    gj_common.cuh:thread_gj, gc and gl read from the value slab every
//    step.
//
// What bounds it on the H100: a variant reads its n_rows values once and
// writes S+1 floats of trajectory; everything per step stays on chip. At
// the main path's N = 3, S+1 = 201 the trajectory write (4 bytes per
// variant per step, 0.8 GB at 1M variants) dominates the bytes and the
// work is ~40 flops per step, so the kernel's bound is the device-memory
// writes; what it is held to is the instruction stream of its per-step
// table walks. The design writes out[s * B + b]: for each step the
// warp's 32 variants store 128 contiguous bytes. The per-variant arrays
// live in shared memory with the variant index fastest (conflict-free),
// the source grid is read through L1 by every thread at the same address
// (a broadcast). The block size comes from the caller's launch plan
// (ops/mc_tran_fused.py:launch_plan), made from the occupancy this file
// reports (mc_tran_fused_resident).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2;
// the forms (ops/mc_tran_fused.py:FORMS, in order)
constexpr int FORM_REGISTER = 0, FORM_SHARED = 1;
// The largest N with a register instance (ops/mc_tran_fused.py:
// K8_REG_MAX_N chooses up to where it is used).
constexpr int REG_MAX_N = 8;
// A warp's 32 variants interleave in the warp's slice of shared memory:
// element q of lane l at [q * LANES + l], a constant stride whatever the
// block size.
constexpr int LANES = 32;

__device__ __forceinline__ float term_value(int kind, float sign, float v) {
  switch (kind) {
    case KIND_ONE: return sign;
    case KIND_INV: return sign / v;
    case KIND_LIN:
    default: return sign * v;
  }
}

// Floats of a variant's shared-memory region in ``form``: [A | I]
// (n*2n); the shared form's rhs and x (n each), v_prev (n_c) and i_prev
// (n_l); the register form's rhs (n), gc, v_prev (n_c) and gl, i_prev
// (n_l), its x taking A's place once A^-1 is in registers.
__host__ __device__ inline size_t region_floats(int form, int n, int n_c,
                                                int n_l) {
  return (size_t)n * 2 * n + (form == FORM_REGISTER
                                  ? (size_t)n + 2 * ((size_t)n_c + n_l)
                                  : 2 * (size_t)n + n_c + n_l);
}

// Variant regions of a block of ``tpb`` threads: its warps' slices.
__host__ __device__ inline int warp_slots(int tpb) {
  return (tpb + LANES - 1) / LANES * LANES;
}

// The variant's region in its warp's slice of shared memory.
__device__ __forceinline__ float* region_of(int form, int n, int n_c,
                                            int n_l) {
  extern __shared__ unsigned char smem_raw[];
  const int t = threadIdx.x;
  return reinterpret_cast<float*>(smem_raw) +
         (t / LANES) * LANES * (int)region_floats(form, n, n_c, n_l) +
         t % LANES;
}

// A from the pattern into ``P`` (element q at P[q * LANES]) at the
// table's positions in the [A | I] layout (i * 2n + j): zero the positions
// no entry writes, then each entry the sum of its terms in table order.
__device__ __forceinline__ void assemble_a(
    float* P, const float* __restrict__ values, int B, long long b,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero) {
  for (int z = 0; z < n_zero; ++z) P[zeros[z] * LANES] = 0.0f;
  for (int e = 0; e < n_ent; ++e) {
    const int pos = ent[3 * e], t0 = ent[3 * e + 1], t1 = ent[3 * e + 2];
    float acc = 0.0f;
    for (int q = t0; q < t1; ++q) {
      const float v = __ldg(values + (size_t)terms[3 * q + 1] * B + b);
      const float tv = term_value(terms[3 * q], (float)terms[3 * q + 2], v);
      acc = q == t0 ? tv : acc + tv;
    }
    P[pos * LANES] = acc;
  }
}

// The shared form.
__global__ void mc_tran_fused_shared_kernel(
    const float* __restrict__ vs, int n_src, int n_steps,
    const float* __restrict__ values, int B,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero,
    const int* __restrict__ bsrc, int n_bsrc,
    const int* __restrict__ cst, int n_c,
    const int* __restrict__ lst, int n_l, unsigned b_rows, int n,
    int node_idx, float eps, float* __restrict__ out,
    uint8_t* __restrict__ valid) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // no barrier below: each thread owns its variant
  const int w = 2 * n;
  // the variant's region, element q at P[q * LANES]: [A | I] (n*w), rhs
  // (n), x (n), v_prev (n_c), i_prev (n_l)
  float* P = region_of(FORM_SHARED, n, n_c, n_l);
  float* rhs = P + n * w * LANES;
  float* x = rhs + n * LANES;
  float* vp = x + n * LANES;
  float* ip = vp + n_c * LANES;

  // 1. A from the pattern; the right block becomes I
  assemble_a(P, values, B, b, ent, n_ent, terms, zeros, n_zero);
  for (int i = 0; i < n; ++i) P[(i * w + n + i) * LANES] = 1.0f;

  // 2. factor once
  float* const a[1] = {P};
  uint64_t perm;
  valid[b] = gj::thread_gj<float, 1>(a, LANES, n, w, eps, perm) ? 1 : 0;

  // 3. the time loop
  for (int k = 0; k < n_c; ++k) vp[k * LANES] = 0.0f;
  for (int k = 0; k < n_l; ++k) ip[k * LANES] = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    for (int i = 0; i < n; ++i) rhs[i * LANES] = 0.0f;
    const float* vs_s = vs + (size_t)s * n_src;
    for (int q = 0; q < n_bsrc; ++q) {
      float* r = rhs + bsrc[3 * q] * LANES;
      *r = *r + vs_s[bsrc[3 * q + 1]] * (float)bsrc[3 * q + 2];
    }
    for (int k = 0; k < n_c; ++k) {
      // stamp_current with I = -gc * v_prev: b[i1] += gc*v, b[i2] -= gc*v
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float tv = values[(size_t)cst[3 * k + 2] * B + b] *
                       vp[k * LANES];
      if (i1 < n) rhs[i1 * LANES] = rhs[i1 * LANES] + tv;
      if (i2 < n) rhs[i2 * LANES] = rhs[i2 * LANES] - tv;
    }
    for (int k = 0; k < n_l; ++k) {
      // stamp_current with I = +i_prev: b[i1] -= i, b[i2] += i
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float il = ip[k * LANES];
      if (i1 < n) rhs[i1 * LANES] = rhs[i1 * LANES] - il;
      if (i2 < n) rhs[i2 * LANES] = rhs[i2 * LANES] + il;
    }
    for (int i = 0; i < n; ++i) {
      // row i of A^-1 is the right block of pivot row perm[i]
      const float* inv_i = P + (gj::perm_at(perm, i) * w + n) * LANES;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j)
        if ((b_rows >> j) & 1u)
          acc = acc + inv_i[j * LANES] * rhs[j * LANES];
      x[i * LANES] = acc;
    }
    out[(size_t)s * B + b] = x[node_idx * LANES];
    for (int k = 0; k < n_c; ++k) {
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float v1 = i1 < n ? x[i1 * LANES] : 0.0f;
      const float v2 = i2 < n ? x[i2 * LANES] : 0.0f;
      vp[k * LANES] = v1 - v2;
    }
    for (int k = 0; k < n_l; ++k) {
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float v1 = i1 < n ? x[i1 * LANES] : 0.0f;
      const float v2 = i2 < n ? x[i2 * LANES] : 0.0f;
      const float gl = values[(size_t)lst[3 * k + 2] * B + b];
      ip[k * LANES] = ip[k * LANES] + gl * (v1 - v2);
    }
  }
}

// The register form at n = N (the same arguments as the shared form).
template <int N>
__global__ void mc_tran_fused_reg_kernel(
    const float* __restrict__ vs, int n_src, int n_steps,
    const float* __restrict__ values, int B,
    const int* __restrict__ ent, int n_ent, const int* __restrict__ terms,
    const int* __restrict__ zeros, int n_zero,
    const int* __restrict__ bsrc, int n_bsrc,
    const int* __restrict__ cst, int n_c,
    const int* __restrict__ lst, int n_l, unsigned b_rows, int /*n == N*/,
    int node_idx, float eps, float* __restrict__ out,
    uint8_t* __restrict__ valid) {
  constexpr int W = 2 * N;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // no barrier below: each thread owns its variant
  // the variant's region, element q at P[q * LANES] (region_floats'
  // order): A's planes (N * 2N, read once, then x), rhs (N), gc, v_prev
  // (n_c), gl, i_prev (n_l)
  float* P = region_of(FORM_REGISTER, N, n_c, n_l);
  float* rhs = P + N * W * LANES;
  float* gc = rhs + N * LANES;
  float* vp = gc + n_c * LANES;
  float* gl = vp + n_c * LANES;
  float* ip = gl + n_l * LANES;

  // 1. A from the pattern, then [A | I] into registers
  assemble_a(P, values, B, b, ent, n_ent, terms, zeros, n_zero);
  float a[N][W];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = P[(i * W + j) * LANES];
      a[i][N + j] = i == j ? 1.0f : 0.0f;
    }

  // 2. factor once: row i of A^-1 is the right block of the row that
  // pivoted column i
  float inv[N][N];
  valid[b] = gj::reg_gj_real<float, N, W>(a, eps, inv) ? 1 : 0;
  float* x = P;  // A's planes are free from here

  // 3. the time loop; gc and gl read once
  for (int k = 0; k < n_c; ++k) {
    gc[k * LANES] = __ldg(values + (size_t)cst[3 * k + 2] * B + b);
    vp[k * LANES] = 0.0f;
  }
  for (int k = 0; k < n_l; ++k) {
    gl[k * LANES] = __ldg(values + (size_t)lst[3 * k + 2] * B + b);
    ip[k * LANES] = 0.0f;
  }
  for (int s = 0; s < n_steps; ++s) {
    // the RHS at its run-time rows: sources, then C terms, then L terms
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i * LANES] = 0.0f;
    const float* vs_s = vs + (size_t)s * n_src;
    for (int q = 0; q < n_bsrc; ++q) {
      float* r = rhs + bsrc[3 * q] * LANES;
      *r = *r + vs_s[bsrc[3 * q + 1]] * (float)bsrc[3 * q + 2];
    }
    for (int k = 0; k < n_c; ++k) {
      // stamp_current with I = -gc * v_prev: b[i1] += gc*v, b[i2] -= gc*v
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float tv = gc[k * LANES] * vp[k * LANES];
      if (i1 < N) rhs[i1 * LANES] = rhs[i1 * LANES] + tv;
      if (i2 < N) rhs[i2 * LANES] = rhs[i2 * LANES] - tv;
    }
    for (int k = 0; k < n_l; ++k) {
      // stamp_current with I = +i_prev: b[i1] -= i, b[i2] += i
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float il = ip[k * LANES];
      if (i1 < N) rhs[i1 * LANES] = rhs[i1 * LANES] - il;
      if (i2 < N) rhs[i2 * LANES] = rhs[i2 * LANES] + il;
    }
    // x = A^-1 rhs over the rows that carry RHS terms, j ascending
    float r[N];
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = rhs[j * LANES];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if ((b_rows >> j) & 1u) acc = acc + inv[i][j] * r[j];
      x[i * LANES] = acc;
    }
    out[(size_t)s * B + b] = x[node_idx * LANES];
    for (int k = 0; k < n_c; ++k) {
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float v1 = i1 < N ? x[i1 * LANES] : 0.0f;
      const float v2 = i2 < N ? x[i2 * LANES] : 0.0f;
      vp[k * LANES] = v1 - v2;
    }
    for (int k = 0; k < n_l; ++k) {
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float v1 = i1 < N ? x[i1 * LANES] : 0.0f;
      const float v2 = i2 < N ? x[i2 * LANES] : 0.0f;
      ip[k * LANES] = ip[k * LANES] + gl[k * LANES] * (v1 - v2);
    }
  }
}

using KernelFn = decltype(&mc_tran_fused_shared_kernel);

// The kernel of ``form`` at N = n, or nullptr.
KernelFn kernel_of(int form, int n) {
  if (n < 1 || n > gj::THREAD_MAX_N) return nullptr;
  if (form == FORM_SHARED) return mc_tran_fused_shared_kernel;
  if (form != FORM_REGISTER) return nullptr;
  switch (n) {
    case 1: return mc_tran_fused_reg_kernel<1>;
    case 2: return mc_tran_fused_reg_kernel<2>;
    case 3: return mc_tran_fused_reg_kernel<3>;
    case 4: return mc_tran_fused_reg_kernel<4>;
    case 5: return mc_tran_fused_reg_kernel<5>;
    case 6: return mc_tran_fused_reg_kernel<6>;
    case 7: return mc_tran_fused_reg_kernel<7>;
    case 8: return mc_tran_fused_reg_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes per variant of ``form`` (0 register, 1 shared);
// ops/mc_tran_fused.py:k8_bytes_per_variant is the copy the wrapper
// checks before it builds anything.
size_t mc_tran_fused_bytes_per_variant(int form, int n, int n_c, int n_l) {
  return region_floats(form, n, n_c, n_l) * sizeof(float);
}

// Resident blocks per SM of ``form`` at N = n with ``tpb`` threads and
// ``smem`` bytes of dynamic shared memory a block (the occupancy API), or
// minus the CUDA error; the launch plan's input. A block of ``tpb``
// threads takes the regions of whole warps: warp_slots(tpb) x
// mc_tran_fused_bytes_per_variant.
int mc_tran_fused_resident(int form, int n, int tpb, size_t smem) {
  const KernelFn fn = kernel_of(form, n);
  if (fn == nullptr || smem > gj::SMEM_MAX)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)fn, tpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int mc_tran_fused_f32(const void* vs, int n_src, int n_steps,
                      const void* values, int B, const void* ent, int n_ent,
                      const void* terms, const void* zeros, int n_zero,
                      const void* bsrc, int n_bsrc, const void* cst, int n_c,
                      const void* lst, int n_l, unsigned b_rows, int n,
                      int node_idx, double eps, int form, int tpb, void* out,
                      void* valid, void* stream) {
  const KernelFn fn = kernel_of(form, n);
  if (fn == nullptr || tpb < 1 || tpb > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warp_slots(tpb) *
                      mc_tran_fused_bytes_per_variant(form, n, n_c, n_l);
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && n_steps > 0) {
    const int blocks = (int)(((long long)B + tpb - 1) / tpb);
    float eps_f = (float)eps;
    void* args[] = {(void*)&vs,    (void*)&n_src,  (void*)&n_steps,
                    (void*)&values, (void*)&B,     (void*)&ent,
                    (void*)&n_ent, (void*)&terms,  (void*)&zeros,
                    (void*)&n_zero, (void*)&bsrc,  (void*)&n_bsrc,
                    (void*)&cst,   (void*)&n_c,    (void*)&lst,
                    (void*)&n_l,   (void*)&b_rows, (void*)&n,
                    (void*)&node_idx, (void*)&eps_f, (void*)&out,
                    (void*)&valid};
    err = cudaLaunchKernel((const void*)fn, dim3(blocks), dim3(tpb), args,
                           smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
