// The transverse bundle and the trans-apply reset ladder of one interface
// state (reference trans.cpp:67,442 actual_trans_single/final), shared by
// the CTU face kernel (ctu_face.cu) and the standalone trans_apply and
// trans_cmpflx kernels. Same arithmetic as
// castro_tpu_torch/ops/trans.py:term_bundle + trans_apply_bundle.
// Replaces castro_tpu/ops/pallas_kernels.py:_trans_apply_block (:85-142)
// and the in-kernel bundle of ctu_face_pallas (:606-648).
#pragma once

#include "common.cuh"

namespace ctt {

// One transverse term: the face-registered flux F[NVAR] and Godunov state
// (pressure pg and the t-velocity ug) of the stage that solved along t.
// Its direction t is the caller's template parameter.
template <typename T>
struct Term {
  const T* F;
  const T* pg;
  const T* ug;
  T cdtdx;
};

// Summed transverse bundle registered at cell x: the hydro df[NUH] (only
// the components the apply reads), dre, dp, and (term_bundle) df0, the
// share of the first passive. Any other passive's share is formed on its
// own (term_df), one at a time.
template <typename T>
struct Bundle {
  T df[NUH];
  T dre, dp, df0;
};

// One term's share of the bundle at cell x (linear index ix): differences
// between x and its edge-clamped neighbour x + 1 along the axis t (an int,
// or Axis<A>); c0 is the first passive's component.
template <typename T, typename Dir>
__device__ __forceinline__ void add_term(Bundle<T>& b, const Term<T>& tm, Dir t, T gamc,
                                         const Grid& g, const Cell& x, long long ix, int c0) {
  long long ih = x.shift(g, t, 1).at(g);
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    if (c == UTEMP) continue;
    b.df[c] = b.df[c] + tm.cdtdx * (tm.F[c * g.S + ih] - tm.F[c * g.S + ix]);
  }
  b.df0 = b.df0 + tm.cdtdx * (tm.F[c0 * g.S + ih] - tm.F[c0 * g.S + ix]);
  T pgm = tm.pg[ix], pgp = tm.pg[ih];
  T ugm = tm.ug[ix], ugp = tm.ug[ih];
  T du = ugp - ugm;
  T dup = pgp * ugp - pgm * ugm;
  T pav = T(0.5) * (pgp + pgm);
  b.dre = b.dre + tm.cdtdx * pav * du;
  b.dp = b.dp + tm.cdtdx * (dup + pav * du * (gamc - T(1)));
}

// The bundle of NT (0-2) terms at cell x, the first along TA and the
// second along TB, summed in that order; c0 is the first passive's
// component.
template <typename T, int NT, int TA, int TB>
__device__ __forceinline__ Bundle<T> term_bundle(const Term<T>* terms, const T* qaux,
                                                 const Grid& g, const Cell& x, int c0) {
  Bundle<T> b;
#pragma unroll
  for (int c = 0; c < NUH; ++c) b.df[c] = T(0);
  b.dre = T(0);
  b.dp = T(0);
  b.df0 = T(0);
  long long ix = x.at(g);
  T gamc = qaux[QGAMC * g.S + ix];
  if (NT > 0) add_term(b, terms[0], Axis<TA>(), gamc, g, x, ix, c0);
  if (NT > 1) add_term(b, terms[1], Axis<TB>(), gamc, g, x, ix, c0);
  return b;
}

// Component c's share of the bundle of NT terms at cell x, as term_bundle
// sums it (the same operations as its df0).
template <typename T, int NT, int TA, int TB>
__device__ __forceinline__ T term_df(const Term<T>* terms, const Grid& g, const Cell& x,
                                     long long ix, int c) {
  T df = T(0);
  if (NT > 0) {
    long long ih = x.shift(g, Axis<TA>(), 1).at(g);
    df = df + terms[0].cdtdx * (terms[0].F[c * g.S + ih] - terms[0].F[c * g.S + ix]);
  }
  if (NT > 1) {
    long long ih = x.shift(g, Axis<TB>(), 1).at(g);
    df = df + terms[1].cdtdx * (terms[1].F[c * g.S + ih] - terms[1].F[c * g.S + ix]);
  }
  return df;
}

// The density of a corrected state, which its passives need: the old and
// new rho and whether the density reset restored the old state.
template <typename T>
struct Dens {
  T rr, rrnew;
  bool bad;
};

// Corrected hydro state out[QFS] from q[QFS] and a bundle.
template <typename T>
__device__ __forceinline__ Dens<T> trans_apply(const T* q, const Bundle<T>& b, T small_pres,
                                               bool reset_density, bool reset_rhoe, T* out) {
  T rho = q[QRHO], uu = q[QU], vv = q[QV], ww = q[QW];
  T reint = q[QREINT], p = q[QPRES];
  T rr = rho;
  T ru = rho * uu, rv = rho * vv, rw = rho * ww;
  T ekin = T(0.5) * rho * (uu * uu + vv * vv + ww * ww);
  T re = reint + ekin;

  T rrnew = rr - b.df[URHO];
  T runew = ru - b.df[UMX];
  T rvnew = rv - b.df[UMY];
  T rwnew = rw - b.df[UMZ];
  T renew = re - b.df[UEDEN];
  T dreint = b.df[UEINT] + b.dre;

  bool bad = reset_density && (rrnew < T(0));
  if (bad) {
    rrnew = rr; runew = ru; rvnew = rv; rwnew = rw; renew = re;
  }
  T rhoinv = T(1) / rrnew;
  T rhoeken = T(0.5) * (runew * runew + rvnew * rvnew + rwnew * rwnew) * rhoinv;
  T reint_new = renew - rhoeken;
  if (reset_rhoe && reint_new <= T(0)) reint_new = reint - dreint;
  if (reint_new <= T(0)) reint_new = reint;
  if (bad) reint_new = reint;
  T pnew = bad ? p : vmax(p - b.dp, small_pres);

#pragma unroll
  for (int c = 0; c < QFS; ++c) out[c] = q[c];
  out[QRHO] = rrnew;
  out[QU] = runew * rhoinv;
  out[QV] = rvnew * rhoinv;
  out[QW] = rwnew * rhoinv;
  out[QREINT] = reint_new;
  out[QPRES] = pnew;
  return Dens<T>{rr, rrnew, bad};
}

// A corrected passive from its value q_s and its bundle share df_s.
template <typename T>
__device__ __forceinline__ T trans_passive(const Dens<T>& n, T q_s, T df_s) {
  return n.bad ? q_s : (n.rr * q_s - df_s) / n.rrnew;
}

}  // namespace ctt
