// K1: batched complex Gauss-Jordan on (re, im) planes, one block per system.
//
// Replaces the TPU kernel spicey_tpu/ops/pallas_gj.py:_gj_complex_kernel
// (pallas_call in _solve_complex_f32_batchlast, loop body
// _complex_gj_scratch). Semantics are those of the plain version,
// spicey_tpu_torch/ops/linsolve.py:gj_solve_planes: the pivot of column k
// is the unused row with the largest |a|^2, ties to the lowest row; a
// system is invalid when |pivot|^2 < eps^2, and elimination continues
// through an invalid pivot with a unit divisor.
//
// Layout: batch-first A_re, A_im (B, N, N), b_re, b_im (B, N) ->
// x_re, x_im (B, N), valid (B,) as bytes (a torch.bool tensor).
//
// What bounds it on the H100: at the slice's sizes (N = 3..128, 1e3..1e5
// systems) the elimination is N steps of an O(N^2) update, each ending in
// a block barrier, so it is latency-bound on shared memory and barriers,
// not on device-memory bandwidth: the system is read once and x written
// once. The design keeps the whole augmented system in shared memory
// (dynamic, up to the 227 KB a block may hold) so the N^3 traffic never
// leaves the SM, and gives one block to each system so thousands of
// independent blocks fill the 132 SMs. Where the f64 planes do not fit
// (N >= ~119), the planes live in a global workspace the caller
// allocates; they stay hot in L2. A warp-level pivot search, several
// systems per block at small N and register tiling are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (s, r) beats (best_s, best_r): larger score, ties to the lower row, and
// NaN above everything, as torch.argmax and jnp.argmax rank it (a NaN
// pivot then fails the |pivot|^2 >= eps^2 test and flags the system).
template <typename T>
__device__ __forceinline__ bool better(T s, int r, T best_s, int best_r) {
  bool s_nan = s != s, b_nan = best_s != best_s;
  if (s_nan || b_nan) return s_nan && (!b_nan || r < best_r);
  return s > best_s || (s == best_s && r < best_r);
}

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

  // shared layout: [planes (smem route only)] prow_r, prow_i (w each),
  // f_r, f_i (n each), red_s (32), piv (4), then ints: red_r (32),
  // perm (n), used (n), pivot_row, ok_all
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
  T* prow_r = base;
  T* prow_i = prow_r + w;
  T* f_r = prow_i + w;
  T* f_i = f_r + n;
  T* red_s = f_i + n;
  T* piv = red_s + 32;  // pvr, pvi, inv_d
  int* red_r = reinterpret_cast<int*>(piv + 4);
  int* perm = red_r + 32;
  int* used = perm + n;
  int* pivot_row = used + n;
  int* ok_all = pivot_row + 1;

  const T* Ar0 = A_re + (size_t)sys * n * n;
  const T* Ai0 = A_im + (size_t)sys * n * n;
  for (int idx = tid; idx < nw; idx += nt) {
    int i = idx / w, j = idx - i * w;
    ar[idx] = j < n ? Ar0[i * n + j] : b_re[(size_t)sys * n + i];
    ai[idx] = j < n ? Ai0[i * n + j] : b_im[(size_t)sys * n + i];
  }
  for (int i = tid; i < n; i += nt) used[i] = 0;
  if (tid == 0) *ok_all = 1;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  for (int k = 0; k < n; ++k) {
    // pivot search: per-thread best over its rows (ascending, so a strict
    // > keeps the lowest row on ties), then warp and block reductions
    T best_s = T(-2);
    int best_r = n;
    for (int i = tid; i < n; i += nt) {
      T cr = ar[i * w + k], ci = ai[i * w + k];
      T s = used[i] ? T(-1) : cr * cr + ci * ci;
      if (better(s, i, best_s, best_r)) { best_s = s; best_r = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      T os = __shfl_down_sync(0xffffffffu, best_s, off);
      int orow = __shfl_down_sync(0xffffffffu, best_r, off);
      if (better(os, orow, best_s, best_r)) { best_s = os; best_r = orow; }
    }
    if (lane == 0) { red_s[warp] = best_s; red_r[warp] = best_r; }
    __syncthreads();
    if (tid == 0) {
      T bs = red_s[0];
      int br = red_r[0];
      for (int q = 1; q < nwarps; ++q)
        if (better(red_s[q], red_r[q], bs, br)) { bs = red_s[q]; br = red_r[q]; }
      T pvr = ar[br * w + k], pvi = ai[br * w + k];
      T d = pvr * pvr + pvi * pvi;
      bool ok = d >= eps2;
      if (!ok) *ok_all = 0;
      piv[0] = pvr;
      piv[1] = pvi;
      piv[2] = T(1) / (ok ? d : T(1));
      *pivot_row = br;
      used[br] = 1;
      perm[k] = br;
    }
    __syncthreads();
    const int p = *pivot_row;
    const T pvr = piv[0], pvi = piv[1], inv_d = piv[2];
    for (int j = tid; j < w; j += nt) {
      T prr = ar[p * w + j], pri = ai[p * w + j];
      prow_r[j] = (prr * pvr + pri * pvi) * inv_d;
      prow_i[j] = (pri * pvr - prr * pvi) * inv_d;
    }
    for (int i = tid; i < n; i += nt) {
      f_r[i] = i == p ? T(0) : ar[i * w + k];
      f_i[i] = i == p ? T(0) : ai[i * w + k];
    }
    __syncthreads();
    for (int idx = tid; idx < nw; idx += nt) {
      int i = idx / w, j = idx - i * w;
      if (i == p) {
        ar[idx] = prow_r[j];
        ai[idx] = prow_i[j];
      } else {
        T fr = f_r[i], fi = f_i[i];
        ar[idx] = ar[idx] - (fr * prow_r[j] - fi * prow_i[j]);
        ai[idx] = ai[idx] - (fr * prow_i[j] + fi * prow_r[j]);
      }
    }
    __syncthreads();
  }
  // pivot row perm[k] carries x[k] in its RHS entry
  for (int k = tid; k < n; k += nt) {
    x_re[(size_t)sys * n + k] = ar[perm[k] * w + n];
    x_im[(size_t)sys * n + k] = ai[perm[k] * w + n];
  }
  if (tid == 0) valid_out[sys] = (uint8_t)(*ok_all);
}

template <typename T>
size_t smem_bytes(int n, bool planes_in_smem) {
  size_t w = n + 1;
  size_t t_count = 2 * w + 2 * n + 32 + 4;
  if (planes_in_smem) t_count += 2 * (size_t)n * w;
  return t_count * sizeof(T) + (32 + 2 * (size_t)n + 2) * sizeof(int);
}

template <typename T>
int launch(const void* A_re, const void* A_im, const void* b_re,
           const void* b_im, void* x_re, void* x_im, void* valid,
           void* workspace, int batch, int n, double eps, void* stream) {
  int threads = n <= 8 ? 32 : (n <= 24 ? 128 : 256);
  size_t smem = smem_bytes<T>(n, workspace == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      gj_complex_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    gj_complex_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
        (const T*)A_re, (const T*)A_im, (const T*)b_re, (const T*)b_im,
        (T*)x_re, (T*)x_im, (uint8_t*)valid, (T*)workspace, n,
        (T)(eps * eps));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs when the planes stay on chip; the
// wrapper allocates a global workspace when this exceeds its budget.
size_t gj_complex_smem_bytes(int n, int is_double) {
  return is_double ? smem_bytes<double>(n, true) : smem_bytes<float>(n, true);
}

int gj_complex_f32(const void* A_re, const void* A_im, const void* b_re,
                   const void* b_im, void* x_re, void* x_im, void* valid,
                   void* workspace, int batch, int n, double eps,
                   void* stream) {
  return launch<float>(A_re, A_im, b_re, b_im, x_re, x_im, valid, workspace,
                       batch, n, eps, stream);
}

int gj_complex_f64(const void* A_re, const void* A_im, const void* b_re,
                   const void* b_im, void* x_re, void* x_im, void* valid,
                   void* workspace, int batch, int n, double eps,
                   void* stream) {
  return launch<double>(A_re, A_im, b_re, b_im, x_re, x_im, valid, workspace,
                        batch, n, eps, stream);
}

}  // extern "C"
