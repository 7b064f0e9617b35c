// K5 and K7: fused Monte-Carlo AC assemble-and-solve.
//
// K5 replaces the TPU kernel spicey_tpu/ops/pallas_mc_ac.py:_fused_kernel
// (pallas_call in mc_ac_fused_f32) and, by role, its f64-fidelity twin
// _fused_dd_kernel: the double instance of this kernel is the fidelity
// tier, with no df32 refinement. K7 replaces _fused_x_kernel (pallas_call
// in mc_ac_fused_x_f32). The plain versions are
// spicey_tpu_torch/ops/mc_ac_fused.py:mc_ac_fused_plain and
// mc_ac_fused_x_plain.
//
// For variant b and frequency f, each kernel builds the augmented (N, N+1)
// complex system from the stamp pattern (flat tables, read at run time so
// one build serves every deck) and the values column values[:, b], and
// runs the complex one-hot-pivot Gauss-Jordan: largest |a|^2 among unused
// rows, ties to the lowest row, NaN highest (gj_common.cuh:better);
// invalid when |pivot|^2 < eps^2, and elimination goes on through a
// rejected pivot with a unit divisor. Only the order of sums may differ
// from the plain versions.
//
// K5: |x[node]| and valid to mag[f, b], valid[f, b], in one of two forms
// chosen by N (ops/mc_ac_fused.py:k5_form_for):
//  - the register form (N <= K5_REG_MAX_N): one thread per variant and
//    NF frequencies, N a template constant. The thread assembles its
//    systems into its columns of shared memory with the thread index
//    fastest, element q of system k at [(k * 2 N (N + 1) + q) * REG_TPB +
//    t] (a warp's accesses 32 consecutive words, free of bank conflicts),
//    then takes each into registers at constant offsets and eliminates
//    there: steps and columns unrolled, the pivot
//    by an unrolled better() over the rows, the pivot row gathered by a
//    select per row, the division in thread_gj's form (prr pvr + pri pvi)
//    / |pv|^2, columns left of the pivot column skipped, x[node] picked by
//    selects over the pivot order.
//  - the group form (larger N): K7's kernel body, G lanes per system with
//    a row each in registers (below), the pattern's RHS, and lane node
//    writing |x[node]| and valid in place of the (F, N, B) store.
// Its inputs are the (n_rows, B) values and its outputs two (F, B)
// planes, a few bytes per system: at yield-1M (N = 3, 201 M systems) ~1 GB
// written, ~0.3 ms at 3.35 TB/s, and ~0.49 ms of f32 operations at 67
// TFLOP/s. What bounds it is the instruction stream: the table-driven
// assembly (at N = 3 ten terms, each a table load, a value load and a
// branch on the term's kind) and the unrolled elimination. One walk of
// the table assembles a thread's variant at NF frequencies (reg_nf: 2 at
// N = 3 in f64, 4 in f32), so the loads and the terms that do not depend
// on the frequency are shared. At yield-1M the register form takes 4.95
// ms in f32 and 9.16 ms in f64; one frequency per thread 6.30 / 10.12 ms,
// the assembly walking the entry table (three dependent loads per entry)
// 5.74 / 10.40 ms (tools/profile_torch_k5.py's variants, NVIDIA H100 80GB
// HBM3, 700 W).
//
// K7: the whole solution, xr[f, i, b], xi[f, i, b] (the TPU kernel's
// (F, N, B) layout) and valid[f, b]; with external RHS planes rr, ri
// (F, N, B) they replace the pattern's RHS column, and the tables are then
// packed without it (ops/mc_ac_fused.py:pack_pattern). Its first form was
// K5's thread per system with the planes in shared memory: at N = 16 in
// f64 a system's planes are 4,352 bytes, so a block of 32 threads took
// 139 KB and an SM held one warp, whose threads each ran 16 dependent
// steps through shared memory with nothing to hide the latency: 232.5 ms
// at batch-ac-16k (16,384 variants x 201 frequencies), 3.8x
// torch.linalg.solve on the same systems assembled beforehand.
//
// What bounds K7 on the H100 at N = 16 in f64: the elimination is ~16 x 16
// x 17 complex multiply-adds per system, ~1.15e11 flops at batch-ac-16k:
// ~3.4 ms at the CUDA cores' f64 rate (the kernel cannot use the tensor
// cores' 0.645 ms operations bound: each step is a rank-1 update of one
// small system). The (F, N, B) output is 843 MB written, ~0.25 ms at
// 3.35 TB/s. So the aim is the CUDA cores' rate, which needs many warps in
// flight and no round trip through shared memory inside a step.
//
// The design: a group of G lanes (G = the smallest of 4, 8, 16 that is >=
// N, chosen by the wrapper, ops/mc_ac_fused.py:fused_group_for) solves one
// (f, b) system; lane i of the group owns row i of [A | b] in registers,
// 2 (G + 1) values (column N's right-hand side in slot G), and lanes i >= N
// hold no row, as in gj_common.cuh:warp_gj. The loops over the N <= G
// pivot steps and over the columns are unrolled, so no register is
// indexed at run time and nothing spills: the register report
// (``cuobjdump --dump-resource-usage`` on the built library, printed by
// chip_smoke.py phase 1, which fails on any local memory in a K7
// instance) gives the G = 16 pattern-RHS instances 128 registers a thread
// in f64 and 69 in f32, no stack, no local memory: 16 resident warps per
// SM in f64, more in f32. Each lane
// assembles its own row from a row-ordered copy of the entry table
// (row_ent / row_ptr: the same entries with the same terms in the same
// order as K5's table, so every element is the same sum, bitwise equal to
// it), walking the row's entries and putting each in its slot by a select
// per slot; a row starts at zero, so no zeroing table is read. (The first
// form tested every slot against the next entry, with the term loop
// unrolled into each of the 2 (G + 1) slots: thousands of instructions
// beside the unrolled elimination, 2.4x slower at batch-ac-16k;
// tools/profile_torch_k7.py builds it as a variant.)
// Step k: an argmax over the group by __shfl_xor_sync within the G lanes
// (better(), as warp_gj ranks 32 lanes); the pivot row reaches the group
// through a per-group slot in shared memory: the pivot lane writes its
// raw row, __syncwarp, lane j divides column j once (lane 0 the
// right-hand side), __syncwarp, every lane reads the scaled row as a
// broadcast. (Shuffles of the pivot lane's registers, every lane dividing
// every column, measured slower in f64 and f32: PERF.md, and a variant of
// that tool.) The division is row / pv in thread_gj's form
// (prr pvr + pri pvi) / |pv|^2.
// Every other lane subtracts its factor times that row from its own
// registers; only columns right of k are touched, since no later step
// and no answer reads the others. Where N < G the zero columns N..G-1 are
// updated too (they stay zero, and nothing reads them): testing each
// column against N cost a compare and a branch per column, 12% of the
// kernel's time at N = 16 in f64. No step has a block barrier. At the end
// lane k takes x[k] from lane perm[k] by a shuffle, the block stages its
// systems' solutions for consecutive b at one f in shared memory, and
// consecutive threads store consecutive b (external RHS planes come in
// the same way). Blocks run over (variant tiles, frequencies); the block
// size is the one of 256 and 128 threads with more resident warps per SM
// by the occupancy API.
//
// What still bounds it: the instruction rate. A warp (two N = 16 systems)
// executes ~5,500 instructions (tools/profile_torch_k7.py counts them),
// most of them the ~136 column updates per system (a broadcast read, six
// f64 multiply-adds and four selects each) and ~100 per step for the
// argmax, the pivot row and the division: ~9e9 warp instructions at
// batch-ac-16k, ~10 ms at one instruction per clock on each of the 528
// schedulers, against the measured ~12 ms in f64 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2, KIND_W = 3,
              KIND_WINV = 4;

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

// ---- K5, the register form: one thread per system, N a constant -------

// Systems of a block of the register form: their planes take
// 2 N (N + 1) x REG_TPB values of shared memory at each frequency while
// they are assembled.
constexpr int REG_TPB = 128;
// The largest N with a register instance (ops/mc_ac_fused.py:
// K5_REG_MAX_N chooses up to where it is used).
constexpr int REG_MAX_N = 6;
// Frequencies per thread of the register form: one walk of the flat table
// (its loads, the value loads and every term that does not depend on the
// frequency) assembles the thread's variant at NF frequencies. NF is the
// most, up to 4, whose systems keep within REG_SMEM_PER_THREAD bytes of
// shared memory a thread, so that the planes leave room for enough
// resident warps.
constexpr int REG_SMEM_PER_THREAD = 384;
template <typename T, int N>
__host__ __device__ constexpr int reg_nf() {
  constexpr int nf = REG_SMEM_PER_THREAD / (2 * N * (N + 1) * (int)sizeof(T));
  return nf < 1 ? 1 : nf > 4 ? 4 : nf;
}

// term_value at NF frequencies; a term that does not depend on w is
// formed once for all of them.
template <typename T, int NF>
__device__ __forceinline__ void term_values(int kind, T sign, T v,
                                            const T (&w)[NF], T eps,
                                            T (&tv)[NF]) {
  if (kind == KIND_W || kind == KIND_WINV) {
#pragma unroll
    for (int k = 0; k < NF; ++k) tv[k] = term_value<T>(kind, sign, v, w[k], eps);
  } else {
    const T x = term_value<T>(kind, sign, v, w[0], eps);
#pragma unroll
    for (int k = 0; k < NF; ++k) tv[k] = x;
  }
}

// Build variant b's augmented planes at NF frequencies (w[k]; system k's
// element q at P[k * sys + q * REG_TPB]) from K5's flat term table: zero
// the positions no entry writes, then walk the terms in table order, each
// term [position, kind | 8 (the entry's first term) | 16 (its last),
// value row, sign]; an entry is the sum of its terms in table order, the
// first opening the sum and the last storing it. One 16-byte load per
// term, independent of the others, where a walk of the entry table took
// three dependent loads per entry.
template <typename T, int NF>
__device__ __forceinline__ void assemble(
    T* P, int sys, const T* __restrict__ values, int B, int b,
    const T (&w)[NF], const int4* __restrict__ flat, int n_flat,
    const int* __restrict__ zeros, int n_zero, T eps) {
#pragma unroll 4
  for (int z = 0; z < n_zero; ++z) {
    const size_t q = (size_t)__ldg(zeros + z) * REG_TPB;
#pragma unroll
    for (int k = 0; k < NF; ++k) P[k * sys + q] = T(0);
  }
  T acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = T(0);
#pragma unroll 4
  for (int q = 0; q < n_flat; ++q) {
    const int4 e = __ldg(flat + q);
    const T v = __ldg(values + (size_t)e.z * B + b);
    T tv[NF];
    term_values<T, NF>(e.y & 7, T(e.w), v, w, eps, tv);
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      acc[k] = e.y & 8 ? tv[k] : acc[k] + tv[k];
      if (e.y & 16) P[k * sys + (size_t)e.x * REG_TPB] = acc[k];
    }
  }
}

// The complex Gauss-Jordan of one (N, N + 1) system in the thread's
// registers, thread_gj's arithmetic with every index a constant: the
// pivot of column k is the unused row with the largest |a|^2 (better():
// ties to the lower row, NaN highest), gathered by a select per row; the
// pivot row's columns right of k divided by the pivot as
// (prr pvr + pri pvi) / |pv|^2; every other row minus its factor times
// that row, columns right of k only (no later step reads the others).
// Returns validity; (xr, xi) = x[node], the right-hand side of the row
// that pivoted column ``node``.
template <typename T, int N>
__device__ __forceinline__ bool reg_gj(T (&ar)[N][N + 1], T (&ai)[N][N + 1],
                                       int node, T eps2, T& xr, T& xi) {
  bool used[N];
#pragma unroll
  for (int i = 0; i < N; ++i) used[i] = false;
  bool ok_all = true;
  int pnode = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T best_s = T(-2);
    int p = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T sc = used[i] ? T(-1) : ar[i][k] * ar[i][k] + ai[i][k] * ai[i][k];
      if (gj::better(sc, i, best_s, p)) {
        best_s = sc;
        p = i;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) used[i] = used[i] || i == p;
    if (k == node) pnode = p;
    // the pivot row, columns k..N, by selects
    T qr[N + 1], qi[N + 1];
#pragma unroll
    for (int j = k; j <= N; ++j) {
      qr[j] = ar[0][j];
      qi[j] = ai[0][j];
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (p == i) {
          qr[j] = ar[i][j];
          qi[j] = ai[i][j];
        }
    }
    const T pvr = qr[k], pvi = qi[k];
    const T d = pvr * pvr + pvi * pvi;
    const bool ok = d >= eps2;
    ok_all = ok_all && ok;
    const T inv_d = T(1) / (ok ? d : T(1));
#pragma unroll
    for (int j = k + 1; j <= N; ++j) {
      const T prr = qr[j], pri = qi[j];
      qr[j] = (prr * pvr + pri * pvi) * inv_d;
      qi[j] = (pri * pvr - prr * pvi) * inv_d;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T fr = ar[i][k], fi = ai[i][k];
#pragma unroll
      for (int j = k + 1; j <= N; ++j) {
        const T nr = ar[i][j] - (fr * qr[j] - fi * qi[j]);
        const T ni = ai[i][j] - (fr * qi[j] + fi * qr[j]);
        ar[i][j] = i == p ? qr[j] : nr;
        ai[i][j] = i == p ? qi[j] : ni;
      }
    }
  }
  xr = ar[0][N];
  xi = ai[0][N];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (pnode == i) {
      xr = ar[i][N];
      xi = ai[i][N];
    }
  return ok_all;
}

// K5's register form: thread t of the block assembles variant b's systems
// at frequencies f0..f0+NF-1 into its columns of shared memory (element q
// of system k at [(k * 2 N (N + 1) + q) * REG_TPB + t], a warp's accesses
// 32 consecutive words), each element the same sum as the plain version's;
// then takes each system into registers (constant offsets) and runs
// reg_gj.
template <typename T, int N>
__global__ void __launch_bounds__(REG_TPB) mc_ac_fused_reg_kernel(
    const T* __restrict__ freqs, const T* __restrict__ values, int F, int B,
    const int4* __restrict__ flat, int n_flat,
    const int* __restrict__ zeros, int n_zero, int node_idx, T eps, T eps2,
    T* __restrict__ mag, uint8_t* __restrict__ valid) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int W = N + 1, NF = reg_nf<T, N>(), SYS = 2 * N * W * REG_TPB;
  const int t = threadIdx.x;
  const int b = blockIdx.x * REG_TPB + t;
  const int f0 = blockIdx.y * NF;
  if (b >= B) return;  // no barrier below: each thread owns its systems
  T* P = reinterpret_cast<T*>(smem_raw) + t;
  T w[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k)
    w[k] = T(6.283185307179586) * freqs[min(f0 + k, F - 1)];
  assemble<T, NF>(P, SYS, values, B, b, w, flat, n_flat, zeros, n_zero, eps);
#pragma unroll 1
  for (int k = 0; k < NF && f0 + k < F; ++k) {
    const T* S = P + k * SYS;
    T ar[N][W], ai[N][W];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        ar[i][j] = S[(i * W + j) * REG_TPB];
        ai[i][j] = S[(N * W + i * W + j) * REG_TPB];
      }
    T xr, xi;
    const bool ok = reg_gj<T, N>(ar, ai, node_idx, eps2, xr, xi);
    mag[(size_t)(f0 + k) * B + b] = sqrt(xr * xr + xi * xi);
    valid[(size_t)(f0 + k) * B + b] = ok ? 1 : 0;
  }
}

// ---- K7, and K5's group form: G lanes per system, a row per lane ---------

// Row i of plane c (0 real, 1 imaginary) of system (f, b) into a[0..G]:
// column j < n at slot j, column n (the right-hand side) at slot G, every
// other slot zero. row_ent (n_ent, 3) = [column, first term, end term],
// sorted by (plane, row, column); row_ptr[c * (n + 1) + i] is the first
// entry of row i of plane c. Each entry is the sum of its terms in table
// order, as assemble() forms it, and lands in its slot by a select per
// slot, so no register is indexed at run time.
template <typename T, int G>
__device__ __forceinline__ void assemble_row(
    T (&a)[G + 1], int c, int i, int n, const T* __restrict__ values,
    int B, int b, T w, const int* __restrict__ row_ent,
    const int* __restrict__ row_ptr, const int* __restrict__ terms, T eps) {
#pragma unroll
  for (int j = 0; j <= G; ++j) a[j] = T(0);
  const int e1 = row_ptr[c * (n + 1) + i + 1];
  for (int e = row_ptr[c * (n + 1) + i]; e < e1; ++e) {
    const int col = row_ent[3 * e], t0 = row_ent[3 * e + 1],
              t1 = row_ent[3 * e + 2];
    T acc = T(0);
    for (int q = t0; q < t1; ++q) {
      const int kind = terms[3 * q], row = terms[3 * q + 1];
      const T v = __ldg(values + (size_t)row * B + b);
      const T tv = term_value<T>(kind, T(terms[3 * q + 2]), v, w, eps);
      acc = q == t0 ? tv : acc + tv;
    }
    const int slot = col == n ? G : col;
#pragma unroll
    for (int j = 0; j <= G; ++j)
      if (slot == j) a[j] = acc;
  }
}

// The group's pivot row: the lane with the largest score, ties to the
// lowest row, NaN highest (gj::better); a butterfly of shuffles within
// the G lanes, so every lane of the group ends with the same row.
template <typename T, int G>
__device__ __forceinline__ int group_pivot(T best_s, int best_r) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T os = __shfl_xor_sync(0xffffffffu, best_s, off, G);
    const int orow = __shfl_xor_sync(0xffffffffu, best_r, off, G);
    if (gj::better(os, orow, best_s, best_r)) {
      best_s = os;
      best_r = orow;
    }
  }
  return best_r;
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The group's Gauss-Jordan on its rows in registers (lane i, row i; the
// right-hand side in slot G), the pivot row handed to the group through
// its shared-memory ``slot`` (G + 1 pairs). Returns validity (the same on
// every lane of the group); ``perm_k``: lane k's pivot row of column k.
template <typename T, int G>
__device__ __forceinline__ bool group_gj(T (&ar)[G + 1], T (&ai)[G + 1],
                                         int i, int n, bool has_row,
                                         typename Pair<T>::type* slot,
                                         T eps2, int& perm_k) {
  using P2 = typename Pair<T>::type;
  bool used = false, ok_all = true;
  perm_k = 0;  // lane k: the pivot row of column k
  // the column of the pivot row this lane divides: lane 0 the right-hand
  // side, which no step reaches as its pivot column
  const int own = i == 0 ? G : i;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;  // n is the same for every lane of the launch
    const T er = ar[k], ei = ai[k];
    const int p = group_pivot<T, G>(
        !has_row ? T(-2) : used ? T(-1) : er * er + ei * ei, i);
    const bool piv = i == p;
    if (piv) used = true;
    if (i == k) perm_k = p;
    if (piv) {  // the raw pivot row into the group's slot
#pragma unroll
      for (int j = k; j <= G; ++j)
        slot[j] = P2{ar[j], ai[j]};
    }
    __syncwarp();
    const P2 pv = slot[k];
    const T pvr = pv.x, pvi = pv.y;
    const T d = pvr * pvr + pvi * pvi;
    const bool ok = d >= eps2;
    ok_all = ok_all && ok;
    const T inv_d = T(1) / (ok ? d : T(1));
    // each column of the pivot row divided by the pivot once, by its lane
    if (own > k) {
      const P2 q = slot[own];
      slot[own] = P2{(q.x * pvr + q.y * pvi) * inv_d,
                     (q.y * pvr - q.x * pvi) * inv_d};
    }
    __syncwarp();
#pragma unroll
    for (int j = k + 1; j <= G; ++j) {
      // row - factor * (pivot row / pv); the pivot row becomes the latter
      const P2 q = slot[j];
      const T nr = ar[j] - (er * q.x - ei * q.y);
      const T ni = ai[j] - (er * q.y + ei * q.x);
      ar[j] = piv ? q.x : nr;
      ai[j] = piv ? q.y : ni;
    }
    __syncwarp();  // the slot is read before the next step writes it
  }
  return ok_all;
}

// Shared-memory bytes of a K7 block of ``tpb`` threads: the staged
// solutions (and external RHS planes), 2 x G rows of tpb / G + 1 values
// each; the per-group pivot-row slots; the validity bytes.
template <typename T, int G, bool EXT_RHS>
size_t x_smem_bytes(int tpb) {
  const size_t spb = tpb / G, ld = spb + 1;
  return ((EXT_RHS ? 2 : 1) * 2 * G * ld + spb * (G + 1) * 2) * sizeof(T) +
         spb;
}

constexpr int K7_MAX_THREADS = 256;

template <typename T, int G, bool EXT_RHS>
__global__ void __launch_bounds__(K7_MAX_THREADS) mc_ac_fused_x_kernel(
    const T* __restrict__ freqs, const T* __restrict__ values, int B,
    const int* __restrict__ row_ent, const int* __restrict__ row_ptr,
    const int* __restrict__ terms, int n, T eps, T eps2,
    const T* __restrict__ rr, const T* __restrict__ ri, T* __restrict__ xr,
    T* __restrict__ xi, uint8_t* __restrict__ valid) {
  using P2 = typename Pair<T>::type;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int spb = blockDim.x / G, ld = spb + 1;  // systems of the block
  const int t = threadIdx.x, i = t % G, g = t / G;
  const int b0 = blockIdx.x * spb, b = b0 + g, f = blockIdx.y;
  const bool live = b < B, has_row = i < n;
  // [2][G][ld] solutions, then (EXT_RHS) the right-hand sides, then
  // [spb][G + 1] pivot-row slots, then spb validity bytes
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* rs = xs + 2 * G * ld;
  P2* const slots = reinterpret_cast<P2*>(rs + (EXT_RHS ? 2 * G * ld : 0));
  P2* slot = slots + (size_t)g * (G + 1);
  uint8_t* vs = reinterpret_cast<uint8_t*>(slots + (size_t)spb * (G + 1));

  if constexpr (EXT_RHS) {  // rr, ri (F, N, B): consecutive threads, b
    for (int idx = t; idx < n * spb; idx += blockDim.x) {
      const int k = idx / spb, s = idx - k * spb;
      if (b0 + s < B) {
        const size_t q = ((size_t)f * n + k) * B + b0 + s;
        rs[k * ld + s] = rr[q];
        rs[(G + k) * ld + s] = ri[q];
      }
    }
    __syncthreads();
  }

  T ar[G + 1], ai[G + 1];
  if (live && has_row) {
    const T w = T(6.283185307179586) * freqs[f];
    assemble_row<T, G>(ar, 0, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
    assemble_row<T, G>(ai, 1, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
    if constexpr (EXT_RHS) {
      ar[G] = rs[i * ld + g];
      ai[G] = rs[(G + i) * ld + g];
    }
  } else {
#pragma unroll
    for (int j = 0; j <= G; ++j) ar[j] = ai[j] = T(0);
  }

  int perm_k;
  const bool ok_all =
      group_gj<T, G>(ar, ai, i, n, has_row, slot, eps2, perm_k);

  // pivot row perm[k] (lane perm[k]) carries x[k] in slot G
  const T x_r = __shfl_sync(FULL, ar[G], perm_k, G);
  const T x_i = __shfl_sync(FULL, ai[G], perm_k, G);
  if (has_row) {
    xs[i * ld + g] = x_r;
    xs[(G + i) * ld + g] = x_i;
  }
  if (i == 0) vs[g] = ok_all ? 1 : 0;
  __syncthreads();
  for (int idx = t; idx < n * spb; idx += blockDim.x) {
    const int k = idx / spb, s = idx - k * spb;
    if (b0 + s < B) {
      const size_t q = ((size_t)f * n + k) * B + b0 + s;
      xr[q] = xs[k * ld + s];
      xi[q] = xs[(G + k) * ld + s];
    }
  }
  if (t < spb && b0 + t < B) valid[(size_t)f * B + b0 + t] = vs[t];
}

// K5's group form, past the register form's N: K7's rows and elimination
// (the pattern's RHS), and in place of the (F, N, B) store, lane
// ``node_idx`` writes |x[node]| and valid.
template <typename T, int G>
__global__ void __launch_bounds__(K7_MAX_THREADS) mc_ac_fused_group_kernel(
    const T* __restrict__ freqs, const T* __restrict__ values, int B,
    const int* __restrict__ row_ent, const int* __restrict__ row_ptr,
    const int* __restrict__ terms, int n, int node_idx, T eps, T eps2,
    T* __restrict__ mag, uint8_t* __restrict__ valid) {
  using P2 = typename Pair<T>::type;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int spb = blockDim.x / G;
  const int t = threadIdx.x, i = t % G, g = t / G;
  const int b = blockIdx.x * spb + g, f = blockIdx.y;
  const bool live = b < B, has_row = i < n;
  P2* slot = reinterpret_cast<P2*>(smem_raw) + (size_t)g * (G + 1);
  T ar[G + 1], ai[G + 1];
  if (live && has_row) {
    const T w = T(6.283185307179586) * freqs[f];
    assemble_row<T, G>(ar, 0, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
    assemble_row<T, G>(ai, 1, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
  } else {
#pragma unroll
    for (int j = 0; j <= G; ++j) ar[j] = ai[j] = T(0);
  }
  int perm_k;
  const bool ok_all =
      group_gj<T, G>(ar, ai, i, n, has_row, slot, eps2, perm_k);
  const T x_r = __shfl_sync(FULL, ar[G], perm_k, G);
  const T x_i = __shfl_sync(FULL, ai[G], perm_k, G);
  if (live && i == node_idx) {
    mag[(size_t)f * B + b] = sqrt(x_r * x_r + x_i * x_i);
    valid[(size_t)f * B + b] = ok_all ? 1 : 0;
  }
}

// The block size (256 or 128 threads) of a group kernel with more resident
// warps per SM by the occupancy API, ties to 256; 0 if neither fits.
template <typename K, typename SmemOf>
int group_tpb(K* kernel, SmemOf smem_of) {
  int tpb = 0, best = 0;
  for (int cand : {K7_MAX_THREADS, K7_MAX_THREADS / 2}) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, cand, smem_of(cand)) != cudaSuccess)
      return 0;
    if (blocks * cand > best) {
      best = blocks * cand;
      tpb = cand;
    }
  }
  return tpb;
}

// Launch K7 with group width G.
template <typename T, int G, bool EXT_RHS>
int launch_x(const void* freqs, const void* values, int F, int B,
             const void* row_ent, const void* row_ptr, const void* terms,
             int n, double eps, const void* rr, const void* ri, void* xr,
             void* xi, void* valid, void* stream) {
  if (n < 1 || n > G) return (int)cudaErrorInvalidValue;
  auto* kernel = mc_ac_fused_x_kernel<T, G, EXT_RHS>;
  const int tpb = group_tpb(kernel, x_smem_bytes<T, G, EXT_RHS>);
  if (tpb == 0) return (int)cudaErrorInvalidConfiguration;
  if (B > 0 && F > 0) {
    const int spb = tpb / G;
    dim3 grid((B + spb - 1) / spb, F);
    kernel<<<grid, tpb, x_smem_bytes<T, G, EXT_RHS>(tpb),
             (cudaStream_t)stream>>>(
        (const T*)freqs, (const T*)values, B, (const int*)row_ent,
        (const int*)row_ptr, (const int*)terms, n, (T)eps, (T)(eps * eps),
        (const T*)rr, (const T*)ri, (T*)xr, (T*)xi, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

// rr == nullptr: the pattern's RHS; otherwise the external RHS planes.
// ``group``: 4, 8 or 16 lanes per system.
template <typename T>
int launch_x_mode(const void* freqs, const void* values, int F, int B,
                  const void* row_ent, const void* row_ptr,
                  const void* terms, int n, int group, double eps,
                  const void* rr, const void* ri, void* xr, void* xi,
                  void* valid, void* stream) {
#define K7_LAUNCH(G)                                                        \
  (rr == nullptr                                                            \
       ? launch_x<T, G, false>(freqs, values, F, B, row_ent, row_ptr,      \
                               terms, n, eps, rr, ri, xr, xi, valid,       \
                               stream)                                     \
       : launch_x<T, G, true>(freqs, values, F, B, row_ent, row_ptr, terms, \
                              n, eps, rr, ri, xr, xi, valid, stream))
  switch (group) {
    case 4: return K7_LAUNCH(4);
    case 8: return K7_LAUNCH(8);
    case 16: return K7_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K7_LAUNCH
}

// ---- K5's launches ---------------------------------------------------------

// The tables and outputs every K5 form takes.
struct K5Args {
  const void *freqs, *values, *flat, *terms, *zeros, *row_ent, *row_ptr;
  int F, B, n_flat, n_zero, n, node_idx;
  double eps;
  void *mag, *valid, *stream;
};

template <typename T, int N>
int launch_reg(const K5Args& a) {
  constexpr int NF = reg_nf<T, N>();
  const size_t smem = (size_t)NF * 2 * N * (N + 1) * REG_TPB * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      mc_ac_fused_reg_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.B > 0 && a.F > 0) {
    dim3 grid((a.B + REG_TPB - 1) / REG_TPB, (a.F + NF - 1) / NF);
    mc_ac_fused_reg_kernel<T, N><<<grid, REG_TPB, smem,
                                   (cudaStream_t)a.stream>>>(
        (const T*)a.freqs, (const T*)a.values, a.F, a.B, (const int4*)a.flat,
        a.n_flat, (const int*)a.zeros, a.n_zero, a.node_idx, (T)a.eps,
        (T)(a.eps * a.eps), (T*)a.mag, (uint8_t*)a.valid);
  }
  return (int)cudaGetLastError();
}

template <typename T, int G>
size_t group_smem_bytes(int tpb) {
  return (size_t)(tpb / G) * (G + 1) * sizeof(typename Pair<T>::type);
}

template <typename T, int G>
int launch_group(const K5Args& a) {
  if (a.n < 1 || a.n > G) return (int)cudaErrorInvalidValue;
  auto* kernel = mc_ac_fused_group_kernel<T, G>;
  const int tpb = group_tpb(kernel, group_smem_bytes<T, G>);
  if (tpb == 0) return (int)cudaErrorInvalidConfiguration;
  if (a.B > 0 && a.F > 0) {
    const int spb = tpb / G;
    dim3 grid((a.B + spb - 1) / spb, a.F);
    kernel<<<grid, tpb, group_smem_bytes<T, G>(tpb),
             (cudaStream_t)a.stream>>>(
        (const T*)a.freqs, (const T*)a.values, a.B, (const int*)a.row_ent,
        (const int*)a.row_ptr, (const int*)a.terms, a.n, a.node_idx,
        (T)a.eps, (T)(a.eps * a.eps), (T*)a.mag, (uint8_t*)a.valid);
  }
  return (int)cudaGetLastError();
}

// K5's forms (ops/mc_ac_fused.py:K5_FORMS): 0 the register form at N <=
// REG_MAX_N, 1 the group form with ``group`` lanes (4, 8 or 16) per system.
template <typename T>
int launch(const K5Args& a, int form, int group) {
  if (a.n < 1 || a.n > gj::THREAD_MAX_N || a.node_idx < 0 ||
      a.node_idx >= a.n)
    return (int)cudaErrorInvalidValue;
  if (form == 0) {
    if (a.n > REG_MAX_N) return (int)cudaErrorInvalidValue;
    switch (a.n) {
      case 1: return launch_reg<T, 1>(a);
      case 2: return launch_reg<T, 2>(a);
      case 3: return launch_reg<T, 3>(a);
      case 4: return launch_reg<T, 4>(a);
      case 5: return launch_reg<T, 5>(a);
      case 6: return launch_reg<T, 6>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (form == 1) {
    switch (group) {
      case 4: return launch_group<T, 4>(a);
      case 8: return launch_group<T, 8>(a);
      case 16: return launch_group<T, 16>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int mc_ac_fused_f32(const void* freqs, const void* values, int F, int B,
                    const void* flat, int n_flat, const void* terms,
                    const void* zeros, int n_zero, const void* row_ent,
                    const void* row_ptr, int n, int node_idx, double eps,
                    int form, int group, void* mag, void* valid,
                    void* stream) {
  return launch<float>(K5Args{freqs, values, flat, terms, zeros, row_ent,
                              row_ptr, F, B, n_flat, n_zero, n, node_idx, eps,
                              mag, valid, stream},
                       form, group);
}

int mc_ac_fused_f64(const void* freqs, const void* values, int F, int B,
                    const void* flat, int n_flat, const void* terms,
                    const void* zeros, int n_zero, const void* row_ent,
                    const void* row_ptr, int n, int node_idx, double eps,
                    int form, int group, void* mag, void* valid,
                    void* stream) {
  return launch<double>(K5Args{freqs, values, flat, terms, zeros, row_ent,
                               row_ptr, F, B, n_flat, n_zero, n, node_idx,
                               eps, mag, valid, stream},
                        form, group);
}

int mc_ac_fused_x_f32(const void* freqs, const void* values, int F, int B,
                      const void* row_ent, const void* row_ptr,
                      const void* terms, int n, int group, double eps,
                      const void* rr, const void* ri, void* xr, void* xi,
                      void* valid, void* stream) {
  return launch_x_mode<float>(freqs, values, F, B, row_ent, row_ptr, terms,
                              n, group, eps, rr, ri, xr, xi, valid, stream);
}

int mc_ac_fused_x_f64(const void* freqs, const void* values, int F, int B,
                      const void* row_ent, const void* row_ptr,
                      const void* terms, int n, int group, double eps,
                      const void* rr, const void* ri, void* xr, void* xi,
                      void* valid, void* stream) {
  return launch_x_mode<double>(freqs, values, F, B, row_ent, row_ptr, terms,
                               n, group, eps, rr, ri, xr, xi, valid, stream);
}

}  // extern "C"
