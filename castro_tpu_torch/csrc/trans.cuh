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

// Summed transverse bundle registered at cell x: df[NVAR] (only the
// components the apply reads), dre, dp.
template <typename T, int NPASS>
struct Bundle {
  T df[UFS + NPASS];
  T dre, dp;
};

// One term's share of the bundle at cell x (linear index ix): differences
// between x and its edge-clamped neighbour x + 1 along the axis t (an int,
// or Axis<A>).
template <typename T, int NPASS, typename Dir>
__device__ __forceinline__ void add_term(Bundle<T, NPASS>& b, const Term<T>& tm, Dir t,
                                         T gamc, const Grid& g, const Cell& x,
                                         long long ix) {
  long long ih = x.shift(g, t, 1).at(g);
#pragma unroll
  for (int c = 0; c < UFS + NPASS; ++c) {
    if (c == UTEMP) continue;
    b.df[c] = b.df[c] + tm.cdtdx * (tm.F[c * g.S + ih] - tm.F[c * g.S + ix]);
  }
  T pgm = tm.pg[ix], pgp = tm.pg[ih];
  T ugm = tm.ug[ix], ugp = tm.ug[ih];
  T du = ugp - ugm;
  T dup = pgp * ugp - pgm * ugm;
  T pav = T(0.5) * (pgp + pgm);
  b.dre = b.dre + tm.cdtdx * pav * du;
  b.dp = b.dp + tm.cdtdx * (dup + pav * du * (gamc - T(1)));
}

// The bundle of NT (0-2) terms at cell x, the first along TA and the
// second along TB, summed in that order.
template <typename T, int NPASS, int NT, int TA, int TB>
__device__ __forceinline__ Bundle<T, NPASS> term_bundle(
    const Term<T>* terms, const T* qaux, const Grid& g, const Cell& x) {
  Bundle<T, NPASS> b;
#pragma unroll
  for (int c = 0; c < UFS + NPASS; ++c) b.df[c] = T(0);
  b.dre = T(0);
  b.dp = T(0);
  long long ix = x.at(g);
  T gamc = qaux[QGAMC * g.S + ix];
  if (NT > 0) add_term(b, terms[0], Axis<TA>(), gamc, g, x, ix);
  if (NT > 1) add_term(b, terms[1], Axis<TB>(), gamc, g, x, ix);
  return b;
}

// Corrected interface state out[NQ] from q[NQ] and a bundle.
template <typename T, int NPASS>
__device__ __forceinline__ void trans_apply(const T* q, const Bundle<T, NPASS>& b,
                                            T small_pres, bool reset_density,
                                            bool reset_rhoe, T* out) {
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
  for (int c = 0; c < QFS + NPASS; ++c) out[c] = q[c];
  out[QRHO] = rrnew;
  out[QU] = runew * rhoinv;
  out[QV] = rvnew * rhoinv;
  out[QW] = rwnew * rhoinv;
  out[QREINT] = reint_new;
  out[QPRES] = pnew;
#pragma unroll
  for (int k = 0; k < NPASS; ++k)
    out[QFS + k] = bad ? q[QFS + k] : (rr * q[QFS + k] - b.df[UFS + k]) / rrnew;
}

}  // namespace ctt
