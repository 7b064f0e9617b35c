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
//      as b_lin[i] + the device terms of row i, eliminate
//      (gj_common.cuh:thread_gj, shared with K1/K2/K3/K5/K8), commit x,
//      the switch states and the validity, and test for the exit;
//   3. records V(node) and commits the companion state, the next step's
//      pass-0 junction seeds and the junction charges.
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
// What bounds it on the H100: the work is Newton passes x (2N^3/3
// elimination + the stamps), all on chip; a variant reads its value
// column once and writes S+1 floats. At the main path's shapes (N = 5-6,
// a few passes per step) it is bound by operations, and by divergence:
// lanes of a warp that need more passes keep the others waiting. The
// design keeps every per-variant array in shared memory with the variant
// index fastest (conflict-free, as K8), reads the source grid as a
// broadcast, and writes out[s * B + b] (128 contiguous bytes per warp and
// step). Making it fast (fewer divergent lanes per warp, registers in
// place of shared memory) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gj_common.cuh"

namespace {

constexpr int KIND_ONE = 0, KIND_INV = 1, KIND_LIN = 2;
constexpr size_t SMEM_TARGET = 112 * 1024;
constexpr float GMIN_F = 1e-12f;

struct Deck {
  const float* vs;
  int n_src, n_steps;
  const float* values;
  int B;
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
__device__ void charge_cap(float vd, float i_d, float g_d, float tt,
                           float cjo, float vj, float m, float fc, float& q,
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
  int tpb;
  float *lin, *ab, *x, *blin, *dterm;
  __device__ float val(int row) const {
    return d.values[(size_t)row * d.B + b];
  }
  __device__ float& at(float* base, int q) const {
    return base[(size_t)q * tpb];
  }
  __device__ float xv(int i) const {
    return i < d.n ? x[(size_t)i * tpb] : 0.0f;
  }
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
  __device__ void bjt_chg(float v, float i_s, const int* rows, int junction,
                          float pol, float& q, float& c, float& cv) const {
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

__global__ void mc_tran_nr_kernel(const Deck d) {
  extern __shared__ unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int t = threadIdx.x;
  const long long b = (long long)blockIdx.x * tpb + t;
  if (b >= d.B) return;  // no barrier below: each thread owns its variant
  const int n = d.n, w = n + 1;
  // per-thread region, element q at P[q * tpb]: lin (n*n), [A | b]
  // (n*w), x, b_lin, device terms (n each), then the carried state
  float* P = reinterpret_cast<float*>(smem_raw) + t;
  Lane L{d, b, tpb};
  L.lin = P;
  L.ab = L.lin + (size_t)n * n * tpb;
  L.x = L.ab + (size_t)n * w * tpb;
  L.blin = L.x + (size_t)n * tpb;
  L.dterm = L.blin + (size_t)n * tpb;
  float* vp = L.dterm + (size_t)n * tpb;      // v_prev (n_c)
  float* ip = vp + (size_t)d.n_c * tpb;       // i_prev (n_l)
  float* vdp = ip + (size_t)d.n_l * tpb;      // diode vd seeds (n_d)
  float* vmgs = vdp + (size_t)d.n_d * tpb;    // MOSFET vgs seeds (n_m)
  float* vmds = vmgs + (size_t)d.n_m * tpb;   // MOSFET vds seeds (n_m)
  float* vqbe = vmds + (size_t)d.n_m * tpb;   // BJT vbe seeds (n_q)
  float* vqbc = vqbe + (size_t)d.n_q * tpb;   // BJT vbc seeds (n_q)
  float* qd = vqbc + (size_t)d.n_q * tpb;     // diode charges (n_d | 0)
  float* qqbe = qd + (size_t)(d.has_dchg ? d.n_d : 0) * tpb;
  float* qqbc = qqbe + (size_t)(d.has_qchg ? d.n_q : 0) * tpb;
  float* sw = qqbc + (size_t)(d.has_qchg ? d.n_q : 0) * tpb;  // 0/1 (n_s)
  const int n_state = d.n_c + d.n_l + d.n_d + 2 * d.n_m + 2 * d.n_q +
                      (d.has_dchg ? d.n_d : 0) +
                      (d.has_qchg ? 2 * d.n_q : 0) + d.n_s;
  for (int q = 0; q < n_state; ++q) vp[(size_t)q * tpb] = 0.0f;
  const float inv_dt = d.row_invdt >= 0 ? L.val(d.row_invdt) : 0.0f;

  // 1. the state-independent part of A, once
  for (int z = 0; z < d.n_zero; ++z) L.at(L.lin, d.zeros[z]) = 0.0f;
  for (int e = 0; e < d.n_ent; ++e) {
    const int pos = d.ent[3 * e], t0 = d.ent[3 * e + 1], t1 = d.ent[3 * e + 2];
    float acc = 0.0f;
    for (int q = t0; q < t1; ++q) {
      const float tv = term_value(d.terms[3 * q], (float)d.terms[3 * q + 2],
                                  L.val(d.terms[3 * q + 1]));
      acc = q == t0 ? tv : acc + tv;
    }
    L.at(L.lin, pos) = acc;
  }

  bool valid_acc = true;
  for (int s = 0; s < d.n_steps; ++s) {
    // 2a. the linear RHS: sources, C terms, L terms
    for (int i = 0; i < n; ++i) L.at(L.blin, i) = 0.0f;
    const float* vs_s = d.vs + (size_t)s * d.n_src;
    for (int q = 0; q < d.n_bsrc; ++q) {
      float& r = L.at(L.blin, d.bsrc[3 * q]);
      r = r + vs_s[d.bsrc[3 * q + 1]] * (float)d.bsrc[3 * q + 2];
    }
    for (int k = 0; k < d.n_c; ++k) {
      const int i1 = d.cst[3 * k], i2 = d.cst[3 * k + 1];
      const float tv = L.val(d.cst[3 * k + 2]) * L.at(vp, k);
      if (i1 < n) L.at(L.blin, i1) = L.at(L.blin, i1) + tv;
      if (i2 < n) L.at(L.blin, i2) = L.at(L.blin, i2) - tv;
    }
    for (int k = 0; k < d.n_l; ++k) {
      const int i1 = d.lst[3 * k], i2 = d.lst[3 * k + 1];
      const float il = L.at(ip, k);
      if (i1 < n) L.at(L.blin, i1) = L.at(L.blin, i1) - il;
      if (i2 < n) L.at(L.blin, i2) = L.at(L.blin, i2) + il;
    }
    for (int i = 0; i < n; ++i) L.at(L.x, i) = 0.0f;
    bool vnr = true;
    // 2b. the Newton/switch passes
    for (int it = 0; it < d.max_nr; ++it) {
      for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j)
          L.at(L.ab, i * w + j) = L.at(L.lin, i * n + j);
        L.at(L.dterm, i) = 0.0f;
      }
      for (int k = 0; k < d.n_s; ++k) {
        const int* r = d.sl + 8 * k;
        const float g0 = L.val(r[5]);
        L.adm4(r[0], r[1], g0 + L.at(sw, k) * (L.val(r[4]) - g0));
      }
      for (int k = 0; k < d.n_d; ++k) {
        const int* r = d.dl + 4 * k;
        const int pp = r[0], pm = r[1];
        const float vd = it == 0 ? L.at(vdp, k) : L.xv(pp) - L.xv(pm);
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
              (q_d - L.at(qd, k) - tt_gd * vd_l - (c_d - tt_gd) * vd) * inv_dt;
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
        const float vgs = it == 0 ? L.at(vmgs, k) : L.xv(gg) - L.xv(ss);
        const float vds = it == 0 ? L.at(vmds, k) : L.xv(dd) - L.xv(ss);
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
        const float vbe = it == 0 ? L.at(vqbe, k) : vbe_it;
        const float vbc = it == 0 ? L.at(vqbc, k) : vbc_it;
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
          const float cur_be = (q_be - L.at(qqbe, k) - cv_be) * inv_dt;
          L.dadd(bb, -cur_be);
          L.dadd(ee, cur_be);
          L.adm4(bb, cc, c_bc * inv_dt);
          const float cur_bc = (q_bc - L.at(qqbc, k) - cv_bc) * inv_dt;
          L.dadd(bb, -cur_bc);
          L.dadd(cc, cur_bc);
        }
      }
      for (int i = 0; i < n; ++i)
        L.at(L.ab, i * w + n) = L.at(L.blin, i) + L.at(L.dterm, i);

      float* const a[1] = {L.ab};
      uint64_t perm;
      const bool ok = gj::thread_gj<float, 1>(a, tpb, n, w, d.eps, perm);
      // commit x (row k of the answer is the RHS of pivot row perm[k])
      float delta = 0.0f, scale = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float xn = L.at(L.ab, gj::perm_at(perm, i) * w + n);
        float& xi = L.at(L.x, i);
        delta = nanmax(fabsf(xn - xi), delta);
        scale = nanmax(fabsf(xn), scale);
        xi = xi + (xn - xi);
      }
      vnr = vnr && ok;
      // switch hysteresis (simulateTRAN.ts:108-128) at the committed x
      bool toggled = false;
      for (int k = 0; k < d.n_s; ++k) {
        const int* r = d.sl + 8 * k;
        const float vctrl = L.xv(r[2]) - L.xv(r[3]);
        const bool on = L.at(sw, k) > 0.5f;
        const bool nxt = on ? !(vctrl < L.val(r[7])) : vctrl > L.val(r[6]);
        toggled = toggled || nxt != on;
        L.at(sw, k) = nxt ? 1.0f : 0.0f;
      }
      bool settled = !toggled;
      if (d.converged) settled = settled && delta <= d.tol * (1.0f + scale);
      if (settled) break;
    }

    // 3. record V(node) and commit the step's state
    d.out[(size_t)s * d.B + b] = L.xv(d.node_idx);
    for (int k = 0; k < d.n_c; ++k)
      L.at(vp, k) = L.xv(d.cst[3 * k]) - L.xv(d.cst[3 * k + 1]);
    for (int k = 0; k < d.n_l; ++k) {
      const float dv = L.xv(d.lst[3 * k]) - L.xv(d.lst[3 * k + 1]);
      L.at(ip, k) = L.at(ip, k) + L.val(d.lst[3 * k + 2]) * dv;
    }
    for (int k = 0; k < d.n_d; ++k) {
      const int* r = d.dl + 4 * k;
      const float vd = L.xv(r[0]) - L.xv(r[1]);
      L.at(vdp, k) = vd;
      if (d.has_dchg) {
        // diffusion at the clamped voltage, depletion at the true one
        const int* c = d.dchg + 5 * k;
        const float i_s = L.val(r[2]), vth = L.val(r[3]);
        const float ev_c = expf(clip(vd, d.vd_lo, d.vd_hi) / vth);
        float q, cap;
        charge_cap(vd, i_s * (ev_c - 1.0f), nanmax(i_s / vth * ev_c, GMIN_F),
                   L.val(c[0]), L.val(c[1]), L.val(c[2]), L.val(c[3]),
                   L.val(c[4]), q, cap);
        L.at(qd, k) = q;
      }
    }
    for (int k = 0; k < d.n_m; ++k) {
      const int* r = d.ml + 6 * k;
      L.at(vmgs, k) = L.xv(r[1]) - L.xv(r[2]);
      L.at(vmds, k) = L.xv(r[0]) - L.xv(r[2]);
    }
    for (int k = 0; k < d.n_q; ++k) {
      const int* r = d.ql + 6 * k;
      const float vbe = L.xv(r[1]) - L.xv(r[2]);
      const float vbc = L.xv(r[1]) - L.xv(r[0]);
      L.at(vqbe, k) = vbe;
      L.at(vqbc, k) = vbc;
      if (d.has_qchg) {
        const int* c = d.qchg + 9 * k;
        const float i_s = L.val(r[3]), s_ = d.pol[d.n_m + k];
        float q, cap, cv;
        L.bjt_chg(vbe, i_s, c, 0, s_, q, cap, cv);
        L.at(qqbe, k) = q;
        L.bjt_chg(vbc, i_s, c, 1, s_, q, cap, cv);
        L.at(qqbc, k) = q;
      }
    }
    valid_acc = valid_acc && vnr;
  }
  d.valid[b] = valid_acc ? 1 : 0;
}

}  // namespace

extern "C" {

// Shared-memory bytes per variant; the wrapper refuses a deck whose 32
// variants would not fit in one block.
size_t mc_tran_nr_bytes_per_variant(int n, int n_c, int n_l, int n_s, int n_d,
                                    int n_m, int n_q, int has_dchg,
                                    int has_qchg) {
  const size_t floats = (size_t)n * n + (size_t)n * (n + 1) + 3 * (size_t)n +
                        n_c + n_l + n_d + 2 * (size_t)n_m + 2 * (size_t)n_q +
                        (has_dchg ? n_d : 0) + (has_qchg ? 2 * n_q : 0) + n_s;
  return floats * sizeof(float);
}

int mc_tran_nr_f32(const void* vs, int n_src, int n_steps, const void* values,
                   int B, const void* ent, int n_ent, const void* terms,
                   const void* zeros, int n_zero, const void* bsrc, int n_bsrc,
                   const void* cst, int n_c, const void* lst, int n_l,
                   const void* sl, int n_s, const void* dl, int n_d,
                   const void* ml, int n_m, const void* ql, int n_q,
                   const void* pol, const void* dchg, int has_dchg,
                   const void* qchg, int has_qchg, int row_invdt, int n,
                   int node_idx, double eps, double vd_lo, double vd_hi,
                   double vt_q, double q_lo, double q_hi, double tol,
                   int converged, int max_nr, void* out, void* valid,
                   void* stream) {
  if (n < 1 || n > gj::THREAD_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t per = mc_tran_nr_bytes_per_variant(n, n_c, n_l, n_s, n_d, n_m,
                                                  n_q, has_dchg, has_qchg);
  int tpb = 256;
  while (tpb > 32 && tpb * per > SMEM_TARGET) tpb >>= 1;
  const size_t smem = tpb * per;
  if (smem > gj::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_tran_nr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Deck d;
  d.vs = (const float*)vs;
  d.n_src = n_src;
  d.n_steps = n_steps;
  d.values = (const float*)values;
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
    mc_tran_nr_kernel<<<blocks, tpb, smem, (cudaStream_t)stream>>>(d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
