// K9: fused Monte-Carlo NONLINEAR transient, one thread per variant, f32.
//
// Replaces the TPU kernel spicey_tpu/ops/pallas_mc_tran.py:
// _fused_tran_nr_kernel (pallas_call in mc_tran_fused_f32, has_nl branch).
// The plain version is spicey_tpu_torch/ops/mc_tran_fused.py:
// mc_tran_fused_nr_plain.
//
// A deck with switches (S/W), diodes (with TT/CJO charge), MOSFETs (JFETs
// lower to them) or BJTs (with TF/TR/CJE/CJC charge) has a state-dependent
// MNA matrix, so each backward-Euler step runs the engine's inner loop.
// Per variant b the thread
//   1. builds the state-independent part of A from the stamp pattern
//      (flat int32 tables read at run time, so one build serves every deck)
//      and the value slab column values[:, b], once;
//   2. per step builds the linear RHS (sources, then C terms gc*v_prev,
//      then L terms i_prev, simulateTRAN.ts:147-149), zeroes x (:149), and
//      runs up to max_nr passes: copy the linear part into [A | b], stamp
//      the switches by their hysteresis state, the diodes (Shockley
//      companion, clamp window x vd_scale, + the charge companion with the
//      split anchor), the MOSFETs (level 1) and the BJTs (Ebers-Moll, + the
//      junction-charge companions at the current iterate), write RHS row i
//      as b_lin[i] + the device terms of row i, eliminate, commit x, the
//      switch states and the validity, and test for the exit;
//   3. records V(node) and commits the companion state, the next step's
//      pass-0 junction seeds and the junction charges.
//
// Two forms, chosen by N (ops/mc_tran_fused.py:k9_form_for):
//  - the register form (N <= K9_REG_MAX_N, an instance per N up to
//    REG_MAX_N): the state-independent part lives in registers, built once
//    in the thread's [A | b] region at the table's positions and loaded at
//    constant offsets. Each pass writes it into the region, the device
//    stamps add into it at their run-time positions (in the shared form's
//    order), column N is formed as b_lin + device terms, and [A | b] is
//    loaded into registers and eliminated there
//    (gj_common.cuh:reg_gj_real: steps and columns unrolled, columns left
//    of the pivot skipped, the answer read out in pivot order); x, delta
//    and scale are committed in registers and x written back to the N
//    shared floats the device evaluations index at run time;
//  - the shared form (N above the cap, up to FUSED_MAX_N = 16): [A | b] in
//    shared memory, eliminated in place by gj_common.cuh:thread_gj, every
//    element indexed at run time.
//
// Per-thread exit equals the TPU kernel's per-lane mask. There a lane
// marked done keeps its x, switch states and validity unchanged
// (pallas_mc_tran.py:636-653) while the tile runs on until every lane is
// done; its pass index starts at 0 for every lane, so "pass 0" (the seed
// from the previous step) is the same pass for every lane. A thread that
// breaks out of its loop when its lane is done therefore computes the
// same values; the tile-wide ``go`` flag (:668) only decides how many
// passes a frozen lane idles through. The exit: nr="spicey" when no
// switch toggled; nr="converged" also max|dx| <= tol * (1 + max|x|),
// tol floored at 16 float32 ulps by the caller (:462-464, 655-666).
// Validity accumulates over the passes run (a done lane's is frozen) and
// over the steps as a product (:639-640, 728).
//
// Every value is formed in the TPU kernel's order, including its blends:
// a switch conductance is g_off + on * (g_on - g_off), a live lane's
// solution x0 + (x_new - x0). Math is IEEE single precision without
// --use_fast_math (expf and powf, never __expf); nvcc contracts
// multiply-adds into FMAs where the plain version rounds twice, the only
// expected difference between the two.
//
// What bounds it on the H100: the work is Newton passes x (the
// elimination, ~N^3/2 multiply-adds and N^2/2 divisions + the stamps and
// device evaluations), all on chip; a variant reads its value column and
// writes S+1 floats. At the main path's shapes (N = 5-6, one to a few
// passes per step) it is bound by the instruction stream, and by
// divergence: lanes of a warp that need more passes keep the others
// waiting. The shared form's elimination costs two shared loads, a store
// and index arithmetic per multiply-add; the register form's one FMA and
// a select. Per-variant arrays live in shared memory with the variant
// index fastest (conflict-free), the value rows are read through the
// read-only cache (__ldg), the source grid as a broadcast, and out[s * B
// + b] is written 128 contiguous bytes per warp and step. The 32 variants
// of a warp interleave at a constant stride of 32 words (LANES), so an
// element at a constant index is a constant offset and the register
// form's loads and stores of [A | b] need no address arithmetic. The
// block size comes from the caller's launch plan
// (ops/mc_tran_fused.py:launch_plan), made from the occupancy this file
// reports (mc_tran_nr_resident).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2;
constexpr float GMIN_F = 1e-12f;
// the forms (ops/mc_tran_fused.py:FORMS, in order)
constexpr int FORM_REGISTER = 0, FORM_SHARED = 1;
// The largest N with a register instance (ops/mc_tran_fused.py:
// K9_REG_MAX_N chooses up to where it is used).
constexpr int REG_MAX_N = 8;
// A warp's 32 variants interleave in the warp's slice of shared memory:
// element q of lane l at [q * LANES + l], a constant stride whatever the
// block size, so that an element at a constant q is a constant offset.
constexpr int LANES = 32;

struct Deck {
  const float* vs;
  int n_src, n_steps;
  const float* values;
  int n_rows, B;
  const int *ent, *terms, *zeros;
  int n_ent, n_zero;
  const int *bsrc, *cst, *lst, *sl, *dl, *ml, *ql;
  int n_bsrc, n_c, n_l, n_s, n_d, n_m, n_q;
  const float* pol;  // n_m MOSFET polarities, then n_q BJT polarities
  const int *dchg, *qchg;
  int has_dchg, has_qchg, row_invdt;
  int n, node_idx;
  float eps, vd_lo, vd_hi, vt_q, q_lo, q_hi, tol;
  int converged, max_nr;
  float* out;
  uint8_t* valid;
};

__device__ __forceinline__ float term_value(int kind, float sign, float v) {
  switch (kind) {
    case KIND_ONE: return sign;
    case KIND_INV: return sign / v;
    case KIND_LIN:
    default: return sign * v;
  }
}

// jnp.maximum / jnp.max semantics: NaN wins.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// jnp.clip semantics: NaN passes through.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// models/devices.diode_charge_cap: charge q and capacitance c at the true
// voltage vd, with the Shockley current/conductance i_d/g_d given.
__device__ __forceinline__ void charge_cap(float vd, float i_d, float g_d,
                                           float tt, float cjo, float vj,
                                           float m, float fc, float& q,
                                           float& c) {
  const float fcv = fc * vj;
  float q_dep, c_dep;
  if (vd < fcv) {
    const float arg = nanmax(1.0f - vd / vj, 1e-12f);
    q_dep = cjo * vj / (1.0f - m) * (1.0f - powf(arg, 1.0f - m));
    c_dep = cjo * powf(arg, -m);
  } else {
    const float f1 = cjo * vj / (1.0f - m) *
                     (1.0f - powf(1.0f - fc, 1.0f - m));
    const float c0 = cjo * powf(1.0f - fc, -(1.0f + m));
    q_dep = f1 + c0 * ((1.0f - fc * (1.0f + m)) * (vd - fcv) +
                       m / (2.0f * vj) * (vd * vd - fcv * fcv));
    c_dep = c0 * (1.0f - fc * (1.0f + m) + m * vd / vj);
  }
  q = tt * i_d + q_dep;
  c = tt * g_d + c_dep;
}

// One thread's view of its variant: shared-memory arrays with the variant
// index fastest, value rows in device memory.
struct Lane {
  const Deck& d;
  long long b;
  float *ab, *x, *blin, *dterm;
  __device__ float val(int row) const {
    return __ldg(d.values + (size_t)row * d.B + b);
  }
  // element q of a per-variant array
  __device__ float& at(float* base, int q) const { return base[q * LANES]; }
  __device__ float xv(int i) const { return i < d.n ? x[i * LANES] : 0.0f; }
  __device__ void add_a(int i, int j, float g) const {
    if (i < d.n && j < d.n) {
      float& e = at(ab, i * (d.n + 1) + j);
      e = e + g;
    }
  }
  // stamp_admittance: +g on (i1,i1), (i2,i2), -g on (i1,i2), (i2,i1)
  __device__ void adm4(int i1, int i2, float g) const {
    add_a(i1, i1, g);
    add_a(i2, i2, g);
    add_a(i1, i2, -g);
    add_a(i2, i1, -g);
  }
  // stamp_vccs: current rows (i1, i2) x control columns (icp, icn)
  __device__ void vccs4(int i1, int i2, int icp, int icn, float g) const {
    add_a(i1, icp, g);
    add_a(i1, icn, -g);
    add_a(i2, icp, -g);
    add_a(i2, icn, g);
  }
  __device__ void dadd(int i, float t) const {
    if (i < d.n) {
      float& e = at(dterm, i);
      e = e + t;
    }
  }
  // one BJT junction's (q, c, cv) in the stamped frame
  // (pallas_mc_tran.py:466-485): reflected voltage, diffusion at the
  // clamped voltage, depletion at the true one, cv the split anchor
  __device__ __forceinline__ void bjt_chg(float v, float i_s,
                                          const int* rows, int junction,
                                          float pol, float& q, float& c,
                                          float& cv) const {
    const float u = pol * v;
    const float u_lim = clip(u, d.vd_lo, d.vd_hi);
    const float ev = expf(u_lim / d.vt_q);
    const float g_diff = nanmax(i_s / d.vt_q * ev, GMIN_F);
    const int off = junction == 0 ? 0 : 4;
    const float tt = val(rows[off]);
    float q_r;
    charge_cap(u, i_s * (ev - 1.0f), g_diff, tt, val(rows[off + 1]),
               val(rows[off + 2]), val(rows[off + 3]), val(rows[8]), q_r, c);
    cv = tt * g_diff * (pol * u_lim) + (c - tt * g_diff) * (pol * u);
    q = pol * q_r;
  }
};

// The state a variant carries from step to step, in shared memory.
struct State {
  float *vp, *ip;       // C voltages (n_c), L currents (n_l)
  float *vdp;           // diode vd seeds (n_d)
  float *vmgs, *vmds;   // MOSFET vgs, vds seeds (n_m each)
  float *vqbe, *vqbc;   // BJT vbe, vbc seeds (n_q each)
  float *qd;            // diode charges (n_d with TT/CJO, else none)
  float *qqbe, *qqbc;   // BJT junction charges (n_q each with charge)
  float *sw;            // switch states 0/1 (n_s)
  int floats;           // their total
};

__device__ __forceinline__ State carve_state(const Deck& d, float* base) {
  State S;
  S.vp = base;
  S.ip = S.vp + d.n_c * LANES;
  S.vdp = S.ip + d.n_l * LANES;
  S.vmgs = S.vdp + d.n_d * LANES;
  S.vmds = S.vmgs + d.n_m * LANES;
  S.vqbe = S.vmds + d.n_m * LANES;
  S.vqbc = S.vqbe + d.n_q * LANES;
  S.qd = S.vqbc + d.n_q * LANES;
  S.qqbe = S.qd + (d.has_dchg ? d.n_d : 0) * LANES;
  S.qqbc = S.qqbe + (d.has_qchg ? d.n_q : 0) * LANES;
  S.sw = S.qqbc + (d.has_qchg ? d.n_q : 0) * LANES;
  S.floats = d.n_c + d.n_l + d.n_d + 2 * d.n_m + 2 * d.n_q +
             (d.has_dchg ? d.n_d : 0) + (d.has_qchg ? 2 * d.n_q : 0) + d.n_s;
  return S;
}

// The state-independent part of A into ``lin`` at the table's positions
// (i * n + j): zero the positions no entry writes, then each entry the
// sum of its terms in table order.
__device__ __forceinline__ void assemble_lin(const Lane& L, float* lin) {
  const Deck& d = L.d;
  for (int z = 0; z < d.n_zero; ++z) L.at(lin, d.zeros[z]) = 0.0f;
  for (int e = 0; e < d.n_ent; ++e) {
    const int pos = d.ent[3 * e], t0 = d.ent[3 * e + 1], t1 = d.ent[3 * e + 2];
    float acc = 0.0f;
    for (int q = t0; q < t1; ++q) {
      const float tv = term_value(d.terms[3 * q], (float)d.terms[3 * q + 2],
                                  L.val(d.terms[3 * q + 1]));
      acc = q == t0 ? tv : acc + tv;
    }
    L.at(lin, pos) = acc;
  }
}

// Step s's linear RHS into L.blin: sources, C terms, L terms.
__device__ __forceinline__ void linear_rhs(const Lane& L, const State& S,
                                           int s) {
  const Deck& d = L.d;
  const int n = d.n;
  for (int i = 0; i < n; ++i) L.at(L.blin, i) = 0.0f;
  const float* vs_s = d.vs + (size_t)s * d.n_src;
  for (int q = 0; q < d.n_bsrc; ++q) {
    float& r = L.at(L.blin, d.bsrc[3 * q]);
    r = r + vs_s[d.bsrc[3 * q + 1]] * (float)d.bsrc[3 * q + 2];
  }
  for (int k = 0; k < d.n_c; ++k) {
    const int i1 = d.cst[3 * k], i2 = d.cst[3 * k + 1];
    const float tv = L.val(d.cst[3 * k + 2]) * L.at(S.vp, k);
    if (i1 < n) L.at(L.blin, i1) = L.at(L.blin, i1) + tv;
    if (i2 < n) L.at(L.blin, i2) = L.at(L.blin, i2) - tv;
  }
  for (int k = 0; k < d.n_l; ++k) {
    const int i1 = d.lst[3 * k], i2 = d.lst[3 * k + 1];
    const float il = L.at(S.ip, k);
    if (i1 < n) L.at(L.blin, i1) = L.at(L.blin, i1) - il;
    if (i2 < n) L.at(L.blin, i2) = L.at(L.blin, i2) + il;
  }
}

// Pass ``it``'s device stamps onto [A | b] (L.ab, holding the
// state-independent part) and the RHS device terms (L.dterm, zeroed):
// switches, diodes (+ charge), MOSFETs, BJTs (+ charge), in that order.
__device__ __forceinline__ void stamp_devices(const Lane& L, const State& S,
                                              int it, float inv_dt) {
  const Deck& d = L.d;
  for (int k = 0; k < d.n_s; ++k) {
    const int* r = d.sl + 8 * k;
    const float g0 = L.val(r[5]);
    L.adm4(r[0], r[1], g0 + L.at(S.sw, k) * (L.val(r[4]) - g0));
  }
  for (int k = 0; k < d.n_d; ++k) {
    const int* r = d.dl + 4 * k;
    const int pp = r[0], pm = r[1];
    const float vd = it == 0 ? L.at(S.vdp, k) : L.xv(pp) - L.xv(pm);
    const float vd_l = clip(vd, d.vd_lo, d.vd_hi);
    const float i_s = L.val(r[2]), vth = L.val(r[3]);
    const float ev = expf(vd_l / vth);
    const float idd = i_s * (ev - 1.0f);
    const float gd = nanmax(i_s / vth * ev, GMIN_F);
    L.adm4(pp, pm, gd);
    const float cur = idd - gd * vd_l;
    L.dadd(pp, -cur);
    L.dadd(pm, cur);
    if (d.has_dchg) {
      const int* c = d.dchg + 5 * k;
      const float tt = L.val(c[0]);
      float q_d, c_d;
      charge_cap(vd, idd, gd, tt, L.val(c[1]), L.val(c[2]), L.val(c[3]),
                 L.val(c[4]), q_d, c_d);
      L.adm4(pp, pm, c_d * inv_dt);
      const float tt_gd = tt * gd;
      const float cur_q =
          (q_d - L.at(S.qd, k) - tt_gd * vd_l - (c_d - tt_gd) * vd) * inv_dt;
      L.dadd(pp, -cur_q);
      L.dadd(pm, cur_q);
    }
  }
  for (int k = 0; k < d.n_m; ++k) {
    // level-1 MOSFET (models/devices.mos_level1): gds across (d, s),
    // gm as a VCCS (d, s) x (g, s), i_eq into the drain row
    const int* r = d.ml + 6 * k;
    const int dd = r[0], gg = r[1], ss = r[2];
    const float s_ = d.pol[k];
    const float vgs = it == 0 ? L.at(S.vmgs, k) : L.xv(gg) - L.xv(ss);
    const float vds = it == 0 ? L.at(S.vmds, k) : L.xv(dd) - L.xv(ss);
    const float beta = L.val(r[3]), vto = L.val(r[4]), lam = L.val(r[5]);
    const float vgs_r = s_ * vgs, vds_r = s_ * vds;
    const bool swap = vds_r < 0.0f;
    const float vgs_e = swap ? vgs_r - vds_r : vgs_r;
    const float vds_e = fabsf(vds_r);
    const float vov = vgs_e - s_ * vto;
    const bool cutoff = vov <= 0.0f;
    const bool sat = vds_e >= vov;
    const float one_lam = 1.0f + lam * vds_e;
    float i_fwd = 0.0f, gm_e = 0.0f, gds_e = 0.0f;
    if (!cutoff) {
      if (sat) {
        i_fwd = 0.5f * beta * vov * vov * one_lam;
        gm_e = beta * vov * one_lam;
        gds_e = 0.5f * beta * vov * vov * lam;
      } else {
        i_fwd = beta * (vov - 0.5f * vds_e) * vds_e * one_lam;
        gm_e = beta * vds_e * one_lam;
        gds_e = beta * (vov - vds_e) * one_lam +
                beta * (vov - 0.5f * vds_e) * vds_e * lam;
      }
    }
    const float i_r = swap ? -i_fwd : i_fwd;
    const float gm = swap ? -gm_e : gm_e;
    const float gds = nanmax(swap ? gm_e + gds_e : gds_e, GMIN_F);
    const float i_eq = s_ * i_r - gm * vgs - gds * vds;
    L.adm4(dd, ss, gds);
    L.vccs4(dd, ss, gg, ss, gm);
    L.dadd(dd, -i_eq);
    L.dadd(ss, i_eq);
  }
  for (int k = 0; k < d.n_q; ++k) {
    // Ebers-Moll transport companion (models/devices.bjt_ebers_moll)
    const int* r = d.ql + 6 * k;
    const int cc = r[0], bb = r[1], ee = r[2];
    const float s_ = d.pol[d.n_m + k];
    const float vbe_it = L.xv(bb) - L.xv(ee);
    const float vbc_it = L.xv(bb) - L.xv(cc);
    const float vbe = it == 0 ? L.at(S.vqbe, k) : vbe_it;
    const float vbc = it == 0 ? L.at(S.vqbc, k) : vbc_it;
    const float i_s = L.val(r[3]), bf = L.val(r[4]), br = L.val(r[5]);
    const float vbe_l = clip(s_ * vbe, d.q_lo, d.q_hi);
    const float vbc_l = clip(s_ * vbc, d.q_lo, d.q_hi);
    const float ebe = expf(vbe_l / d.vt_q), ebc = expf(vbc_l / d.vt_q);
    const float ibe = (i_s / bf) * (ebe - 1.0f);
    const float ibc = (i_s / br) * (ebc - 1.0f);
    const float ict = i_s * (ebe - ebc);
    const float gbe = nanmax((i_s / bf) / d.vt_q * ebe, GMIN_F);
    const float gbc = nanmax((i_s / br) / d.vt_q * ebc, GMIN_F);
    const float gmf = nanmax(i_s / d.vt_q * ebe, GMIN_F);
    const float gmr = nanmax(i_s / d.vt_q * ebc, GMIN_F);
    const float ibe_eq = s_ * (ibe - gbe * vbe_l);
    const float ibc_eq = s_ * (ibc - gbc * vbc_l);
    const float ict_eq = s_ * (ict - gmf * vbe_l + gmr * vbc_l);
    L.adm4(bb, ee, gbe);
    L.adm4(bb, cc, gbc);
    L.vccs4(cc, ee, bb, ee, gmf);
    L.vccs4(cc, ee, bb, cc, -gmr);
    L.dadd(bb, -ibe_eq);
    L.dadd(ee, ibe_eq);
    L.dadd(bb, -ibc_eq);
    L.dadd(cc, ibc_eq);
    L.dadd(cc, -ict_eq);
    L.dadd(ee, ict_eq);
    if (d.has_qchg) {
      // junction charge at the current iterate, never the pass-0 seed
      const int* c = d.qchg + 9 * k;
      float q_be, c_be, cv_be, q_bc, c_bc, cv_bc;
      L.bjt_chg(vbe_it, i_s, c, 0, s_, q_be, c_be, cv_be);
      L.bjt_chg(vbc_it, i_s, c, 1, s_, q_bc, c_bc, cv_bc);
      L.adm4(bb, ee, c_be * inv_dt);
      const float cur_be = (q_be - L.at(S.qqbe, k) - cv_be) * inv_dt;
      L.dadd(bb, -cur_be);
      L.dadd(ee, cur_be);
      L.adm4(bb, cc, c_bc * inv_dt);
      const float cur_bc = (q_bc - L.at(S.qqbc, k) - cv_bc) * inv_dt;
      L.dadd(bb, -cur_bc);
      L.dadd(cc, cur_bc);
    }
  }
}

// Switch hysteresis (simulateTRAN.ts:108-128) at the committed x; returns
// whether a switch toggled.
__device__ __forceinline__ bool update_switches(const Lane& L,
                                                const State& S) {
  const Deck& d = L.d;
  bool toggled = false;
  for (int k = 0; k < d.n_s; ++k) {
    const int* r = d.sl + 8 * k;
    const float vctrl = L.xv(r[2]) - L.xv(r[3]);
    const bool on = L.at(S.sw, k) > 0.5f;
    const bool nxt = on ? !(vctrl < L.val(r[7])) : vctrl > L.val(r[6]);
    toggled = toggled || nxt != on;
    L.at(S.sw, k) = nxt ? 1.0f : 0.0f;
  }
  return toggled;
}

// Record V(node) of step s and commit the step's state.
__device__ __forceinline__ void commit_step(const Lane& L, const State& S,
                                            int s) {
  const Deck& d = L.d;
  d.out[(size_t)s * d.B + L.b] = L.xv(d.node_idx);
  for (int k = 0; k < d.n_c; ++k)
    L.at(S.vp, k) = L.xv(d.cst[3 * k]) - L.xv(d.cst[3 * k + 1]);
  for (int k = 0; k < d.n_l; ++k) {
    const float dv = L.xv(d.lst[3 * k]) - L.xv(d.lst[3 * k + 1]);
    L.at(S.ip, k) = L.at(S.ip, k) + L.val(d.lst[3 * k + 2]) * dv;
  }
  for (int k = 0; k < d.n_d; ++k) {
    const int* r = d.dl + 4 * k;
    const float vd = L.xv(r[0]) - L.xv(r[1]);
    L.at(S.vdp, k) = vd;
    if (d.has_dchg) {
      // diffusion at the clamped voltage, depletion at the true one
      const int* c = d.dchg + 5 * k;
      const float i_s = L.val(r[2]), vth = L.val(r[3]);
      const float ev_c = expf(clip(vd, d.vd_lo, d.vd_hi) / vth);
      float q, cap;
      charge_cap(vd, i_s * (ev_c - 1.0f), nanmax(i_s / vth * ev_c, GMIN_F),
                 L.val(c[0]), L.val(c[1]), L.val(c[2]), L.val(c[3]),
                 L.val(c[4]), q, cap);
      L.at(S.qd, k) = q;
    }
  }
  for (int k = 0; k < d.n_m; ++k) {
    const int* r = d.ml + 6 * k;
    L.at(S.vmgs, k) = L.xv(r[1]) - L.xv(r[2]);
    L.at(S.vmds, k) = L.xv(r[0]) - L.xv(r[2]);
  }
  for (int k = 0; k < d.n_q; ++k) {
    const int* r = d.ql + 6 * k;
    const float vbe = L.xv(r[1]) - L.xv(r[2]);
    const float vbc = L.xv(r[1]) - L.xv(r[0]);
    L.at(S.vqbe, k) = vbe;
    L.at(S.vqbc, k) = vbc;
    if (d.has_qchg) {
      const int* c = d.qchg + 9 * k;
      const float i_s = L.val(r[3]), s_ = d.pol[d.n_m + k];
      float q, cap, cv;
      L.bjt_chg(vbe, i_s, c, 0, s_, q, cap, cv);
      L.at(S.qqbe, k) = q;
      L.bjt_chg(vbc, i_s, c, 1, s_, q, cap, cv);
      L.at(S.qqbc, k) = q;
    }
  }
}

// Floats of a variant's shared-memory region in ``form``: the shared
// form's state-independent part (n*n), [A | b] (n*(n+1)), x, b_lin and
// the device terms (n each), then the carried state.
__host__ __device__ inline size_t region_floats(int form, int n, int n_c,
                                                int n_l, int n_s, int n_d,
                                                int n_m, int n_q,
                                                int has_dchg, int has_qchg) {
  return (form == FORM_SHARED ? (size_t)n * n : 0) + (size_t)n * (n + 1) +
         3 * (size_t)n + n_c + n_l + n_d + 2 * (size_t)n_m + 2 * (size_t)n_q +
         (has_dchg ? n_d : 0) + (has_qchg ? 2 * n_q : 0) + n_s;
}

// N == 0: the shared form (n = d.n at run time, thread_gj on [A | b] in
// shared memory); N > 0: the register form at n = N.
template <int N>
__global__ void mc_tran_nr_kernel(const Deck d) {
  extern __shared__ unsigned char smem_raw[];
  const int t = threadIdx.x;
  const long long b = (long long)blockIdx.x * blockDim.x + t;
  if (b >= d.B) return;  // no barrier below: each thread owns its variant
  const int n = N > 0 ? N : d.n, w = n + 1;
  // the variant's region (region_floats' order), element q at P[q * LANES]
  // in its warp's slice
  const int floats = (int)region_floats(
      N > 0 ? FORM_REGISTER : FORM_SHARED, n, d.n_c, d.n_l, d.n_s, d.n_d,
      d.n_m, d.n_q, d.has_dchg, d.has_qchg);
  float* P = reinterpret_cast<float*>(smem_raw) +
             (t / LANES) * LANES * floats + t % LANES;
  float* lin_s = P;  // the shared form's state-independent part
  Lane L{d, b};
  L.ab = P + (N > 0 ? 0 : n * n) * LANES;
  L.x = L.ab + n * w * LANES;
  L.blin = L.x + n * LANES;
  L.dterm = L.blin + n * LANES;
  const State S = carve_state(d, L.dterm + n * LANES);
  for (int q = 0; q < S.floats; ++q) S.vp[q * LANES] = 0.0f;
  const float inv_dt = d.row_invdt >= 0 ? L.val(d.row_invdt) : 0.0f;

  // 1. the state-independent part of A, once; the register form builds
  // it in the [A | b] region and keeps it in registers
  constexpr int R = N > 0 ? N : 1;
  float lin[R][R];
  float xr[R];
  if constexpr (N > 0) {
    assemble_lin(L, L.ab);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) lin[i][j] = L.at(L.ab, i * N + j);
  } else {
    assemble_lin(L, lin_s);
  }

  bool valid_acc = true;
  for (int s = 0; s < d.n_steps; ++s) {
    // 2a. the linear RHS: sources, C terms, L terms
    linear_rhs(L, S, s);
    for (int i = 0; i < n; ++i) L.at(L.x, i) = 0.0f;
    if constexpr (N > 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) xr[i] = 0.0f;
    }
    bool vnr = true;
    // 2b. the Newton/switch passes
    for (int it = 0; it < d.max_nr; ++it) {
      if constexpr (N > 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = 0; j < N; ++j) L.at(L.ab, i * w + j) = lin[i][j];
          L.at(L.dterm, i) = 0.0f;
        }
      } else {
        for (int i = 0; i < n; ++i) {
          for (int j = 0; j < n; ++j)
            L.at(L.ab, i * w + j) = L.at(lin_s, i * n + j);
          L.at(L.dterm, i) = 0.0f;
        }
      }
      stamp_devices(L, S, it, inv_dt);
      bool ok;
      float delta = 0.0f, scale = 0.0f;
      if constexpr (N > 0) {
        float a[N][N + 1];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = 0; j < N; ++j) a[i][j] = L.at(L.ab, i * w + j);
          a[i][N] = L.at(L.blin, i) + L.at(L.dterm, i);
        }
        float xn[N][1];
        ok = gj::reg_gj_real<float, N, N + 1>(a, d.eps, xn);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          delta = nanmax(fabsf(xn[i][0] - xr[i]), delta);
          scale = nanmax(fabsf(xn[i][0]), scale);
          xr[i] = xr[i] + (xn[i][0] - xr[i]);
          L.at(L.x, i) = xr[i];
        }
      } else {
        for (int i = 0; i < n; ++i)
          L.at(L.ab, i * w + n) = L.at(L.blin, i) + L.at(L.dterm, i);
        float* const a[1] = {L.ab};
        uint64_t perm;
        ok = gj::thread_gj<float, 1>(a, LANES, n, w, d.eps, perm);
        // commit x (row k of the answer is the RHS of pivot row perm[k])
        for (int i = 0; i < n; ++i) {
          const float xn = L.at(L.ab, gj::perm_at(perm, i) * w + n);
          float& xi = L.at(L.x, i);
          delta = nanmax(fabsf(xn - xi), delta);
          scale = nanmax(fabsf(xn), scale);
          xi = xi + (xn - xi);
        }
      }
      vnr = vnr && ok;
      bool settled = !update_switches(L, S);
      if (d.converged) settled = settled && delta <= d.tol * (1.0f + scale);
      if (settled) break;
    }

    // 3. record V(node) and commit the step's state
    commit_step(L, S, s);
    valid_acc = valid_acc && vnr;
  }
  d.valid[b] = valid_acc ? 1 : 0;
}

// Variant regions of a block of ``tpb`` threads: its warps' slices.
__host__ __device__ inline int warp_slots(int tpb) {
  return (tpb + LANES - 1) / LANES * LANES;
}

using KernelFn = void (*)(const Deck);

// The kernel of ``form`` at N = n, or nullptr.
KernelFn kernel_of(int form, int n) {
  if (n < 1 || n > gj::THREAD_MAX_N) return nullptr;
  if (form == FORM_SHARED) return mc_tran_nr_kernel<0>;
  if (form != FORM_REGISTER) return nullptr;
  switch (n) {
    case 1: return mc_tran_nr_kernel<1>;
    case 2: return mc_tran_nr_kernel<2>;
    case 3: return mc_tran_nr_kernel<3>;
    case 4: return mc_tran_nr_kernel<4>;
    case 5: return mc_tran_nr_kernel<5>;
    case 6: return mc_tran_nr_kernel<6>;
    case 7: return mc_tran_nr_kernel<7>;
    case 8: return mc_tran_nr_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes per variant of ``form`` (0 register, 1 shared);
// ops/mc_tran_fused.py:k9_bytes_per_variant is the copy the wrapper
// checks before it builds anything.
size_t mc_tran_nr_bytes_per_variant(int form, int n, int n_c, int n_l,
                                    int n_s, int n_d, int n_m, int n_q,
                                    int has_dchg, int has_qchg) {
  return region_floats(form, n, n_c, n_l, n_s, n_d, n_m, n_q, has_dchg,
                       has_qchg) *
         sizeof(float);
}

// Resident blocks per SM of ``form`` at N = n with ``tpb`` threads and
// ``smem`` bytes of dynamic shared memory a block (the occupancy API), or
// minus the CUDA error; the launch plan's input. A block of ``tpb``
// threads takes the regions of whole warps: warp_slots(tpb) x
// mc_tran_nr_bytes_per_variant.
int mc_tran_nr_resident(int form, int n, int tpb, size_t smem) {
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

int mc_tran_nr_f32(const void* vs, int n_src, int n_steps, const void* values,
                   int n_rows, int B, const void* ent, int n_ent,
                   const void* terms, const void* zeros, int n_zero,
                   const void* bsrc, int n_bsrc, const void* cst, int n_c,
                   const void* lst, int n_l, const void* sl, int n_s,
                   const void* dl, int n_d, const void* ml, int n_m,
                   const void* ql, int n_q, const void* pol, const void* dchg,
                   int has_dchg, const void* qchg, int has_qchg,
                   int row_invdt, int n, int node_idx, double eps,
                   double vd_lo, double vd_hi, double vt_q, double q_lo,
                   double q_hi, double tol, int converged, int max_nr,
                   int form, int tpb, void* out, void* valid, void* stream) {
  const KernelFn fn = kernel_of(form, n);
  if (fn == nullptr || tpb < 1 || tpb > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warp_slots(tpb) *
                      mc_tran_nr_bytes_per_variant(form, n, n_c, n_l, n_s,
                                                   n_d, n_m, n_q, has_dchg,
                                                   has_qchg);
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Deck d;
  d.vs = (const float*)vs;
  d.n_src = n_src;
  d.n_steps = n_steps;
  d.values = (const float*)values;
  d.n_rows = n_rows;
  d.B = B;
  d.ent = (const int*)ent;
  d.terms = (const int*)terms;
  d.zeros = (const int*)zeros;
  d.n_ent = n_ent;
  d.n_zero = n_zero;
  d.bsrc = (const int*)bsrc;
  d.cst = (const int*)cst;
  d.lst = (const int*)lst;
  d.sl = (const int*)sl;
  d.dl = (const int*)dl;
  d.ml = (const int*)ml;
  d.ql = (const int*)ql;
  d.n_bsrc = n_bsrc;
  d.n_c = n_c;
  d.n_l = n_l;
  d.n_s = n_s;
  d.n_d = n_d;
  d.n_m = n_m;
  d.n_q = n_q;
  d.pol = (const float*)pol;
  d.dchg = (const int*)dchg;
  d.qchg = (const int*)qchg;
  d.has_dchg = has_dchg;
  d.has_qchg = has_qchg;
  d.row_invdt = row_invdt;
  d.n = n;
  d.node_idx = node_idx;
  d.eps = (float)eps;
  d.vd_lo = (float)vd_lo;
  d.vd_hi = (float)vd_hi;
  d.vt_q = (float)vt_q;
  d.q_lo = (float)q_lo;
  d.q_hi = (float)q_hi;
  d.tol = (float)tol;
  d.converged = converged;
  d.max_nr = max_nr;
  d.out = (float*)out;
  d.valid = (uint8_t*)valid;
  if (B > 0 && n_steps > 0) {
    const int blocks = (int)(((long long)B + tpb - 1) / tpb);
    void* args[] = {(void*)&d};
    err = cudaLaunchKernel((const void*)fn, dim3(blocks), dim3(tpb), args,
                           smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
