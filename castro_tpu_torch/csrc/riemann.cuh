// The pointwise Riemann solve and flux assembly of one face, shared by the
// cmpflx and trans_cmpflx kernels, the fused trace kernel (trace_ppm.cu)
// and the CTU face kernel (ctu_face.cu).
// Same arithmetic, in the same order, as castro_tpu_torch/ops/riemann.py:
// riemannus (CGF two-shock, riemann_solvers.H:599), riemann_hllc (:993)
// and compute_flux (compute_flux_q, :16-120), in any coordinate system.
// Replaces castro_tpu/ops/pallas_kernels.py:_riemann_block (:64-82).
#pragma once

#include "common.cuh"

namespace ctt {

template <typename T>
struct RiemannIn {
  T rho_l, un_l, ut_l, utt_l, p_l, rhoe_l, gamc_l;
  T rho_r, un_r, ut_r, utt_r, p_r, rhoe_r, gamc_r;
  T csmall, cavg;
};

template <typename T>
struct Godunov {
  T rho, un, ut, utt, p, rhoe;
};

// normal direction d: the transverse axes in Castro order (t1 < t2)
__host__ __device__ constexpr int trans1(int d) { return d == 0 ? 1 : 0; }
__host__ __device__ constexpr int trans2(int d) { return d == 2 ? 1 : 2; }

// The normal direction `d` of riemann_inputs and riemann_flux is an int
// (cmpflx, trans_cmpflx) or Axis<D> (the face kernels, whose direction is
// a template parameter): one body, the same arithmetic.
template <typename T, typename Dir>
__device__ __forceinline__ RiemannIn<T> riemann_inputs(
    const T* qm, const T* qp, T gl, T gr, T cl, T cr, Dir d, T small_dens) {
  const T SMALL = T(1.0e-8);
  int t1 = trans1(d), t2 = trans2(d);
  RiemannIn<T> ri;
  ri.rho_l = vmax(qm[QRHO], small_dens);
  ri.un_l = qm[QU + d];
  ri.ut_l = qm[QU + t1];
  ri.utt_l = qm[QU + t2];
  ri.p_l = qm[QPRES];
  ri.rhoe_l = qm[QREINT];
  ri.gamc_l = gl;
  ri.rho_r = vmax(qp[QRHO], small_dens);
  ri.un_r = qp[QU + d];
  ri.ut_r = qp[QU + t1];
  ri.utt_r = qp[QU + t2];
  ri.p_r = qp[QPRES];
  ri.rhoe_r = qp[QREINT];
  ri.gamc_r = gr;
  ri.csmall = vmax(SMALL, SMALL * vmax(cr, cl));
  ri.cavg = T(0.5) * (cr + cl);
  return ri;
}

template <typename T>
__device__ Godunov<T> riemannus(const RiemannIn<T>& ri, T small_dens, T small_pres) {
  const T SMALL = T(1.0e-8), SMALLU = T(1.0e-12);
  T wsmall = small_dens * ri.csmall;
  T wl = vmax(wsmall, vsqrt(vabs(ri.gamc_l * ri.p_l * ri.rho_l)));
  T wr = vmax(wsmall, vsqrt(vabs(ri.gamc_r * ri.p_r * ri.rho_r)));

  T wwinv = T(1) / (wl + wr);
  T pstar = ((wr * ri.p_l + wl * ri.p_r) + wl * wr * (ri.un_l - ri.un_r)) * wwinv;
  T ustar = ((wl * ri.un_l + wr * ri.un_r) + (ri.p_l - ri.p_r)) * wwinv;
  pstar = vmax(pstar, small_pres);
  if (vabs(ustar) < SMALLU * T(0.5) * (vabs(ri.un_l) + vabs(ri.un_r))) ustar = T(0);

  T sgnm = sgn(ustar);
  T fp = T(0.5) * (T(1) + sgnm);
  T fm = T(0.5) * (T(1) - sgnm);

  T ro = vmax(small_dens, fp * ri.rho_l + fm * ri.rho_r);
  T uo = fp * ri.un_l + fm * ri.un_r;
  T po = fp * ri.p_l + fm * ri.p_r;
  T reo = fp * ri.rhoe_l + fm * ri.rhoe_r;
  T gamco = fp * ri.gamc_l + fm * ri.gamc_r;

  T roinv = T(1) / ro;
  T co = vmax(ri.csmall, vsqrt(vabs(gamco * po * roinv)));
  T co2inv = T(1) / (co * co);

  Godunov<T> g;
  g.ut = fp * ri.ut_l + fm * ri.ut_r;
  g.utt = fp * ri.utt_l + fm * ri.utt_r;

  T drho = (pstar - po) * co2inv;
  T rstar = vmax(small_dens, ro + drho);
  T entho = (reo + po) * roinv * co2inv;
  T estar = reo + (pstar - po) * entho;
  T cstar = vmax(ri.csmall, vsqrt(vabs(gamco * pstar / rstar)));

  T spout = co - sgnm * uo;
  T spin = cstar - sgnm * ustar;
  T ushock = T(0.5) * (spin + spout);
  if (pstar - po > T(0)) {
    spin = ushock;
    spout = ushock;
  }
  T scr = (spout - spin == T(0)) ? SMALL * ri.cavg : spout - spin;
  T frac = clip(T(0.5) * (T(1) + (spout + spin) / scr), T(0), T(1));

  T rho_g = frac * rstar + (T(1) - frac) * ro;
  T un_g = frac * ustar + (T(1) - frac) * uo;
  T p_g = frac * pstar + (T(1) - frac) * po;
  T re_g = frac * estar + (T(1) - frac) * reo;
  if (spout < T(0)) {  // outer state on the interface
    rho_g = ro; un_g = uo; p_g = po; re_g = reo;
  }
  if (spin >= T(0)) {  // star state on the interface
    rho_g = rstar; un_g = ustar; p_g = pstar; re_g = estar;
  }
  g.rho = rho_g;
  g.un = un_g;
  g.p = vmax(p_g, small_pres);
  g.rhoe = re_g;
  return g;
}

template <typename T>
__device__ Godunov<T> riemann_hllc(const RiemannIn<T>& ri, T small_dens, T small_pres) {
  T cl = vmax(ri.csmall, vsqrt(vabs(ri.gamc_l * ri.p_l / ri.rho_l)));
  T cr = vmax(ri.csmall, vsqrt(vabs(ri.gamc_r * ri.p_r / ri.rho_r)));
  T wl = vmax(small_dens * ri.csmall, vsqrt(vabs(ri.gamc_l * ri.p_l * ri.rho_l)));
  T wr = vmax(small_dens * ri.csmall, vsqrt(vabs(ri.gamc_r * ri.p_r * ri.rho_r)));
  T wwinv = T(1) / (wl + wr);
  T pstar = vmax(small_pres,
                 ((wr * ri.p_l + wl * ri.p_r) + wl * wr * (ri.un_l - ri.un_r)) * wwinv);

  T rl = pstar / ri.p_l;
  T ql = rl > T(1) ? vsqrt(T(1) + (ri.gamc_l + T(1)) / (T(2) * ri.gamc_l) * (rl - T(1))) : T(1);
  T rr = pstar / ri.p_r;
  T qr = rr > T(1) ? vsqrt(T(1) + (ri.gamc_r + T(1)) / (T(2) * ri.gamc_r) * (rr - T(1))) : T(1);
  T sl = ri.un_l - cl * ql;
  T sr = ri.un_r + cr * qr;
  T sm = (ri.p_r - ri.p_l + ri.rho_l * ri.un_l * (sl - ri.un_l)
          - ri.rho_r * ri.un_r * (sr - ri.un_r)) /
         (ri.rho_l * (sl - ri.un_l) - ri.rho_r * (sr - ri.un_r));

  T f_l = ri.rho_l * (sl - ri.un_l) / (sl - sm);
  T p_ls = ri.p_l + ri.rho_l * (ri.un_l - sl) * (ri.un_l - sm);
  T re_ls = (ri.rhoe_l / ri.rho_l + (sm - ri.un_l) * (sm + ri.p_l / (ri.rho_l * (sl - ri.un_l)))) * f_l;
  T f_r = ri.rho_r * (sr - ri.un_r) / (sr - sm);
  T p_rs = ri.p_r + ri.rho_r * (ri.un_r - sr) * (ri.un_r - sm);
  T re_rs = (ri.rhoe_r / ri.rho_r + (sm - ri.un_r) * (sm + ri.p_r / (ri.rho_r * (sr - ri.un_r)))) * f_r;

  bool use_l = sl >= T(0);
  bool use_ls = (sl < T(0)) && (sm >= T(0));
  bool use_rs = (sm < T(0)) && (sr > T(0));
  Godunov<T> g;
  T rho_g, un_g, p_g, re_g;
  if (use_l) {
    rho_g = ri.rho_l; un_g = ri.un_l; p_g = ri.p_l; re_g = ri.rhoe_l;
  } else if (use_ls) {
    rho_g = f_l; un_g = sm; p_g = p_ls; re_g = re_ls;
  } else if (use_rs) {
    rho_g = f_r; un_g = sm; p_g = p_rs; re_g = re_rs;
  } else {
    rho_g = ri.rho_r; un_g = ri.un_r; p_g = ri.p_r; re_g = ri.rhoe_r;
  }
  g.rho = vmax(small_dens, rho_g);
  g.un = un_g;
  g.p = vmax(small_pres, p_g);
  g.rhoe = re_g;
  g.ut = sm >= T(0) ? ri.ut_l : ri.ut_r;
  g.utt = sm >= T(0) ? ri.utt_l : ri.utt_r;
  return g;
}

// What the passives of a face need from its solve: the mass flux and the
// upwind weights of the interface velocity's sign (half each at 0).
template <typename T>
struct Upwind {
  T frho, fp, fm;
};

// A passive's flux from its two interface values (riemann.cpp:106-135).
template <typename T>
__device__ __forceinline__ T upwind(const Upwind<T>& w, T qm_s, T qp_s) {
  return w.frho * (w.fp * qm_s + w.fm * qp_s);
}

// Riemann solve (riemann_solver 0 = CGF, 2 = HLLC) and flux assembly of one
// face: the hydro flux[NUH] and qe[NGDNV], and the upwind data of the
// passives, whose fluxes the callers form one at a time. `mask` is 0 on a
// wall face (bnd_fac, riemann.cpp:55-61) and 1 elsewhere. `mom_p` is false
// for the radial direction of a curvilinear grid, whose momentum flux
// carries no pressure (mom_flux_has_p; the update adds the pressure
// gradient instead).
template <typename T, typename Dir>
__device__ Upwind<T> riemann_hydro(const T* qm, const T* qp, T gl, T gr, T cl, T cr,
                                   Dir d, int solver, T mask, T small_dens, T small_pres,
                                   T* flux, T* qe, bool mom_p = true) {
  RiemannIn<T> ri = riemann_inputs(qm, qp, gl, gr, cl, cr, d, small_dens);
  Godunov<T> gd = solver == 2 ? riemann_hllc(ri, small_dens, small_pres)
                              : riemannus(ri, small_dens, small_pres);
  int t1 = trans1(d), t2 = trans2(d);
  T un = gd.un * mask;
  T frho = gd.rho * un;
  flux[URHO] = frho;
  flux[UMX + d] = mom_p ? frho * un + gd.p : frho * un;
  flux[UMX + t1] = frho * gd.ut;
  flux[UMX + t2] = frho * gd.utt;
  T rhoetot = gd.rhoe + T(0.5) * gd.rho * (un * un + gd.ut * gd.ut + gd.utt * gd.utt);
  flux[UEDEN] = un * (rhoetot + gd.p);
  flux[UEINT] = un * gd.rhoe;
  flux[UTEMP] = T(0);
  T sg = sgn(un);
  qe[GDRHO] = gd.rho;
  qe[GDU + d] = un;
  qe[GDU + t1] = gd.ut;
  qe[GDU + t2] = gd.utt;
  qe[GDPRES] = gd.p;
  qe[GDGAME] = gd.p / vmax(gd.rhoe, tiny<T>()) + T(1);
  return Upwind<T>{frho, T(0.5) * (T(1) + sg), T(0.5) * (T(1) - sg)};
}

// The flux of the pure-hydro layout with NPASS passives held in the
// arrays, flux[UFS_HYDRO + NPASS]: the profiling probes' fixed layout.
template <typename T, int NPASS, typename Dir>
__device__ void riemann_flux(const T* qm, const T* qp, T gl, T gr, T cl, T cr,
                             Dir d, int solver, T mask, T small_dens, T small_pres,
                             T* flux, T* qe, bool mom_p = true) {
  Upwind<T> w = riemann_hydro(qm, qp, gl, gr, cl, cr, d, solver, mask, small_dens,
                              small_pres, flux, qe, mom_p);
#pragma unroll
  for (int k = 0; k < NPASS; ++k) flux[UFS_HYDRO + k] = upwind(w, qm[QFS + k], qp[QFS + k]);
}

// The components of a pointwise face's flux past the hydro ones, at t:
// zero for the extras, the upwinded passives from the face states qm, qp,
// whose passives start at qfs (component stride S).
template <typename T>
__device__ __forceinline__ void store_passive_fluxes(const Layout& L, int qfs,
                                                     const Upwind<T>& w, const T* qm,
                                                     const T* qp, T* flux, long long S,
                                                     long long t) {
  for (int c = NUH; c < L.ufs; ++c) flux[c * S + t] = T(0);
  for (int k = 0; k < L.npass; ++k)
    flux[(L.ufs + k) * S + t] = upwind(w, qm[(qfs + k) * S + t], qp[(qfs + k) * S + t]);
}

}  // namespace ctt
