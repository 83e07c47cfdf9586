// ctu_face: one CTU face stage of the 3D corner-transport-upwind update:
// the transverse bundle, the trans-apply reset ladder of both interface
// states, and the Riemann solve and flux (reference trans.cpp:15/442 +
// cmpflx_plus_godunov, riemann.cpp:16, as Castro_ctu_hydro.cpp orders them).
//
// Replaces castro_tpu/ops/pallas_kernels.py:ctu_face_pallas (:395, call at
// :752) in all its variants:
//   terms=[]         plain Riemann on the traced states (NT1=0);
//   terms=[t]        one corner stage, cdtdx = dt/3dx (NT1=1);
//   terms2=[t2]      the two corner stages of one normal paired, sharing
//                    the reads of qm/qp/qaux (NT1=1, NT2=1);
//   terms=[t1, t2]   the final stage, cdtdx = dt/2dx (NT1=2), optionally
//                    with consup folded in (CONSUP): artificial viscosity,
//                    species-flux normalization, flux divergence and
//                    p div u accumulated onto hsrc, and u + dt*hsrc on the
//                    last normal.
// Same arithmetic as castro_tpu_torch/ops/kernels.py:ctu_face_plain.
//
// Bound: bytes. The corner pair reads qm, qp [NQ], qaux[2] and two terms'
// flux [NVAR] + pg + ug and writes two flux [NVAR] + qe [6]: 68 components
// a cell at NPASS=1; the final stage with consup 79.
// Design: one thread a cell, the normal D and the terms' directions
// template parameters (the terms run along the other two axes in Castro
// order; one corner term along either). The m-state bundle of face x+1 is
// the p-state bundle of face x (:640-642): both are the bundle at cell x.
// So a thread computes the bundle of its cell once and applies it twice,
// to qp[x] (qp' of face x) and to qm[x+1] (qm' of face x+1), and hands
// qm' to the thread above in shared memory, where each face is solved
// once. A block is a FaceTile (face_tile.cuh): cells along D with one halo
// cell below; with consup also one above, whose face is solved for the
// cell below it: the cleaned flux, pg and u_D of every face are staged in
// shared memory, and cell x reads faces x and x+1 from there (the top
// cell of the grid reads its own face twice, the clamp of consup.cu). The
// TPU's neighbour-tile BlockSpecs (:494-505, :550-577) and VMEM sizing
// (:356-383) have no counterpart.
#include "common.cuh"
#include "consup.cuh"
#include "face_tile.cuh"
#include "riemann.cuh"
#include "trans.cuh"

namespace ctt {

template <typename T>
struct FaceParams {
  const T* qm;
  const T* qp;
  const T* qaux;
  Term<T> terms[3];  // stage-1 terms, then the stage-2 term
  T* flux1;
  T* qe1;
  T* flux2;
  T* qe2;
  ConsupParams<T> cs;  // consup fold
  int solver, mask_lo, mask_hi, reset_density, reset_rhoe;
  T small_dens, small_pres;
};

template <typename T>
struct FaceOut {
  T flux[NUH];
  T qe[NGDNV];
  Upwind<T> w;
  T q0m, q0p;  // the face's corrected states of the first passive
};

// The densities of a stage's corrected states, for the passives: of the
// cell's own two edges (qm' of face p+1, qp' of face p) and of qm' of face
// p from the cell below.
template <typename T>
struct StageDens {
  Dens<T> m_own, p_own, m_below;
};

// Rows of the shared exchange of one stage: the corrected hydro qm', the
// m side's reset flag and old density, and the first passive's qm'.
constexpr int XQ = QFS + 3;

// One stage of NT terms (along TA, then TB) over the tile: every thread in
// the grid corrects its cell's two edge states, qmv (of face p+1) and qpv
// (of face p), hydro and the first passive (at QFS), with its cell's
// bundle and hands qm' up through xq; each thread that solves
// (tl.solves()) then solves face p into o. Without terms, qmv is face p's
// own traced qm. Every thread of the block calls it: it holds a barrier.
template <typename T, int D, int NT, int TA, int TB, typename Tile>
__device__ __forceinline__ void stage(const FaceParams<T>& p, const Term<T>* terms,
                                      const Grid& g, const Tile& tl, const Layout& L,
                                      const T* qmv, const T* qpv, T (*xq)[Tile::THREADS],
                                      FaceOut<T>& o, StageDens<T>& dn) {
  const long long S = g.S;
  T qml[QFS], qpc[QFS];
  if constexpr (NT > 0) {
    if (tl.in) {
      Bundle<T> b = term_bundle<T, NT, TA, TB>(terms, p.qaux, g, tl.x, L.ufs);
      T qmc[QFS];
      dn.m_own = trans_apply(qmv, b, p.small_pres, p.reset_density, p.reset_rhoe, qmc);
      dn.p_own = trans_apply(qpv, b, p.small_pres, p.reset_density, p.reset_rhoe, qpc);
#pragma unroll
      for (int c = 0; c < QFS; ++c) xq[c][tl.slot] = qmc[c];
      xq[QFS][tl.slot] = dn.m_own.bad ? T(1) : T(0);
      xq[QFS + 1][tl.slot] = dn.m_own.rr;
      xq[QFS + 2][tl.slot] = trans_passive(dn.m_own, qmv[QFS], b.df0);
      o.q0p = trans_passive(dn.p_own, qpv[QFS], b.df0);
    }
    __syncthreads();
    if (!tl.solves()) return;
    const int b = tl.slot - Tile::STEP;  // the cell below
#pragma unroll
    for (int c = 0; c < QFS; ++c) qml[c] = xq[c][b];
    dn.m_below = Dens<T>{xq[QFS + 1][b], qml[QRHO], xq[QFS][b] != T(0)};
    o.q0m = xq[QFS + 2][b];
  } else {
    if (!tl.solves()) return;
#pragma unroll
    for (int c = 0; c < QFS; ++c) {
      qml[c] = qmv[c];
      qpc[c] = qpv[c];
    }
    o.q0m = qmv[QFS];
    o.q0p = qpv[QFS];
  }
  const long long ix = tl.ix(), im = tl.at(g, tl.p - 1);
  T mask = (tl.p == p.mask_lo || tl.p == p.mask_hi) ? T(0) : T(1);
  o.w = riemann_hydro(qml, qpc, p.qaux[QGAMC * S + im], p.qaux[QGAMC * S + ix],
                      p.qaux[QC * S + im], p.qaux[QC * S + ix], Axis<D>(), p.solver, mask,
                      p.small_dens, p.small_pres, o.flux, o.qe);
}

// Passive k of face p of a stage of NT terms: its qm from the cell below,
// corrected by that cell's bundle, and its qp from the thread's cell,
// corrected by its own (the first passive's both are in o); then the
// upwinded raw flux.
template <typename T, int D, int NT, int TA, int TB, typename Tile>
__device__ __forceinline__ T face_passive(const FaceParams<T>& p, const Term<T>* terms,
                                          const Grid& g, const Tile& tl, const Layout& L,
                                          const FaceOut<T>& o, const StageDens<T>& dn,
                                          int k) {
  if (k == 0) return upwind(o.w, o.q0m, o.q0p);
  const long long S = g.S, ix = tl.ix();
  const int c = L.ufs + k;
  // face p's qm lies at p (with terms the thread's own qmv is at p+1)
  T qm_s = p.qm[(QFS + k) * S + (NT > 0 ? tl.at(g, tl.p) : ix)];
  T qp_s = p.qp[(QFS + k) * S + ix];
  if constexpr (NT > 0) {
    const Cell xb = tl.x.shift(g, Axis<D>(), -1);
    qm_s = trans_passive(dn.m_below, qm_s, term_df<T, NT, TA, TB>(terms, g, xb, xb.at(g), c));
    qp_s = trans_passive(dn.p_own, qp_s, term_df<T, NT, TA, TB>(terms, g, tl.x, ix, c));
  }
  return upwind(o.w, qm_s, qp_s);
}

// The stored flux of an owned face: hydro from o, zero extras, the
// passives formed one at a time; and qe.
template <typename T, int D, int NT, int TA, int TB, typename Tile>
__device__ __forceinline__ void store(const FaceParams<T>& p, const Term<T>* terms,
                                      const Grid& g, const Tile& tl, const Layout& L,
                                      const FaceOut<T>& o, const StageDens<T>& dn, T* flux,
                                      T* qe) {
  const long long S = g.S, ix = tl.ix();
#pragma unroll
  for (int c = 0; c < NUH; ++c) flux[c * S + ix] = o.flux[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) qe[c * S + ix] = o.qe[c];
  for (int c = NUH; c < L.ufs; ++c) flux[c * S + ix] = T(0);
  for (int k = 0; k < L.npass; ++k)
    flux[(L.ufs + k) * S + ix] = face_passive<T, D, NT, TA, TB>(p, terms, g, tl, L, o, dn, k);
}

// The block: 16 z columns of 16 cells along D = 0, 1; 64 cells along z
// by 2 rows of y for D = 2. With consup the tile has a high halo too.
template <int D, bool CONSUP>
using FaceTileOf = FaceTile<D, CONSUP ? 1 : 0, D == 2 ? 64 : 16, D == 2 ? 2 : 16>;

// Rows of the consup exchange: a face's cleaned hydro flux, pg, u_D, and
// what the cell below needs to form the face's passives again: the
// viscosity coefficient, the species factor, the upwind data, and the
// density of the face's corrected qp; and the first passive's cleaned
// flux.
enum { XF_PG = NUH, XF_UG, XF_COEFF, XF_FAC, XF_FRHO, XF_FP, XF_FM, XF_RR, XF_RRNEW,
       XF_BAD, XF_P0, XF = XF_P0 + 1 };

// The final stage's consup fold for cell p (an owner): its lo face p
// (the thread's own solve) and hi face p+1 (the thread above's, from xf;
// the grid's top cell takes its own face again, the clamp of consup.cu).
// Extras and passives are formed one at a time; the first passive's
// cleaned fluxes are f0 and the exchanged one, and any other passive of
// the hi face is formed again here from the exchanged data, with the
// operations its owner uses.
template <typename T, int D, typename Tile>
__device__ __forceinline__ void consup_cell(const FaceParams<T>& p, const Grid& g,
                                            const Tile& tl, const Layout& L,
                                            const FaceOut<T>& o, const StageDens<T>& dn,
                                            T coeff, T fac, T f0,
                                            const T (*xf)[Tile::THREADS]) {
  constexpr int T1 = trans1(D), T2 = trans2(D);
  const ConsupParams<T>& cs = p.cs;
  const long long S = g.S, ix = tl.ix();
  const long long il = tl.at(g, tl.p - 1);
  const bool top = tl.p + 1 >= g.n[D];
  const int a = top ? tl.slot : tl.slot + Tile::STEP;
  const long long iu = tl.at(g, tl.p + 1);
  const Cell xu = tl.x.shift(g, Axis<D>(), 1);
  T fhi[NUH];
#pragma unroll
  for (int c = 0; c < NUH; ++c) fhi[c] = xf[c][a];
  consup_hydro(cs, S, ix, o.flux, fhi, o.qe[GDPRES], xf[XF_PG][a], o.qe[GDU + D],
               xf[XF_UG][a]);
  T* flux = p.flux1;
#pragma unroll
  for (int c = 0; c < NUH; ++c) flux[c * S + ix] = o.flux[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) p.qe1[c * S + ix] = o.qe[c];
  const T coeff_u = xf[XF_COEFF][a], fac_u = xf[XF_FAC][a];
  for (int c = NUH; c < L.ufs; ++c) {
    T fl = av_extra(cs, L, S, c, coeff, ix, il);
    T fh = top ? fl : av_extra(cs, L, S, c, coeff_u, iu, ix);
    consup_row(cs, S, ix, c, fl, fh, T(0));
    flux[c * S + ix] = fl;
  }
  consup_row(cs, S, ix, L.ufs, f0, top ? f0 : xf[XF_P0][a], T(0));
  flux[L.ufs * S + ix] = f0;
  const Upwind<T> wu{xf[XF_FRHO][a], xf[XF_FP][a], xf[XF_FM][a]};
  const Dens<T> pu{xf[XF_RR][a], xf[XF_RRNEW][a], xf[XF_BAD][a] != T(0)};
  for (int k = 1; k < L.npass; ++k) {
    const int c = L.ufs + k;
    T fl = av_comp(cs, S, c, face_passive<T, D, 2, T1, T2>(p, p.terms, g, tl, L, o, dn, k),
                   coeff, ix, il);
    if (k < L.nspec) fl = fl * fac;
    T fh = fl;
    if (!top) {
      // face p+1: qm' is this cell's own corrected right edge, qp' the
      // cell above's corrected left edge
      T qm_s = trans_passive(dn.m_own, p.qm[(QFS + k) * S + iu],
                             term_df<T, 2, T1, T2>(p.terms, g, tl.x, ix, c));
      T qp_s = trans_passive(pu, p.qp[(QFS + k) * S + iu],
                             term_df<T, 2, T1, T2>(p.terms, g, xu, iu, c));
      fh = av_comp(cs, S, c, upwind(wu, qm_s, qp_s), coeff_u, iu, ix);
      if (k < L.nspec) fh = fh * fac_u;
    }
    consup_row(cs, S, ix, c, fl, fh, T(0));
    flux[c * S + ix] = fl;
  }
}

// TA is the direction of the first stage-1 term; the second stage-1 term
// and the stage-2 term run along trans2(D).
template <typename T, int D, int NT1, int NT2, bool CONSUP, int TA, bool HYDRO>
__global__ void __launch_bounds__(FaceTileOf<D, CONSUP>::THREADS) ctu_face_kernel(
    const __grid_constant__ FaceParams<T> p, Grid g, Layout lay) {
  constexpr int T2 = trans2(D);
  const Layout L = kernel_layout<HYDRO>(lay);
  using Tile = FaceTileOf<D, CONSUP>;
  // qm' of the face above each cell, one block of XQ rows a stage; with
  // consup, the same memory then holds the XF rows of each face's exchange
  constexpr int NXQ = NT1 > 0 ? (NT2 > 0 ? 2 * XQ : XQ) : 1;
  constexpr int NX = CONSUP && XF > NXQ ? XF : NXQ;
  __shared__ T xs[NX][Tile::THREADS];
  const Tile tl(g);
  const long long S = g.S, ix = tl.ix();
  // the cell's two edges: qm of face p+1 (p without terms), qp of p; the
  // hydro components and the first passive
  T qmv[QFS + 1], qpv[QFS + 1];
  if (tl.in) {
    const long long iq = NT1 > 0 ? tl.at(g, tl.p + 1) : ix;
#pragma unroll
    for (int c = 0; c <= QFS; ++c) {
      qmv[c] = p.qm[c * S + iq];
      qpv[c] = p.qp[c * S + ix];
    }
  }
  FaceOut<T> o;
  StageDens<T> dn;
  stage<T, D, NT1, TA, T2>(p, p.terms, g, tl, L, qmv, qpv, xs, o, dn);
  if (!CONSUP && tl.owns()) store<T, D, NT1, TA, T2>(p, p.terms, g, tl, L, o, dn, p.flux1, p.qe1);
  if constexpr (NT2 > 0) {
    FaceOut<T> o2;
    StageDens<T> dn2;
    stage<T, D, NT2, T2, T2>(p, p.terms + NT1, g, tl, L, qmv, qpv, xs + XQ, o2, dn2);
    if (tl.owns()) store<T, D, NT2, T2, T2>(p, p.terms + NT1, g, tl, L, o2, dn2, p.flux2, p.qe2);
  }
  if constexpr (CONSUP) {
    constexpr int T1 = trans1(D);
    T coeff = T(0), fac = T(1), f0 = T(0);
    if (tl.solves()) {
      coeff = av_coeff(p.cs, g, tl.x, Axis<D>());
      av_hydro(p.cs, S, o.flux, coeff, ix, tl.at(g, tl.p - 1));
      // the species factor, from the species fluxes summed in order
      T sumn = T(0);
      for (int k = 0; k < L.nspec; ++k) {
        T f = av_comp(p.cs, S, L.ufs + k,
                      face_passive<T, D, 2, T1, T2>(p, p.terms, g, tl, L, o, dn, k), coeff, ix,
                      tl.at(g, tl.p - 1));
        if (k == 0) f0 = f;
        sumn = k == 0 ? f : sumn + f;
      }
      fac = species_fac(o.flux[URHO], sumn);
      f0 = f0 * fac;  // the first passive is a species (nspec >= 1)
    }
    __syncthreads();  // the stage's reads of xs are done
    if (tl.solves()) {
#pragma unroll
      for (int c = 0; c < NUH; ++c) xs[c][tl.slot] = o.flux[c];
      xs[XF_PG][tl.slot] = o.qe[GDPRES];
      xs[XF_UG][tl.slot] = o.qe[GDU + D];
      xs[XF_P0][tl.slot] = f0;
      if (L.npass > 1 || L.ufs > NUH) {  // the extras, and the passives formed again
        xs[XF_COEFF][tl.slot] = coeff;
        xs[XF_FAC][tl.slot] = fac;
        xs[XF_FRHO][tl.slot] = o.w.frho;
        xs[XF_FP][tl.slot] = o.w.fp;
        xs[XF_FM][tl.slot] = o.w.fm;
        xs[XF_RR][tl.slot] = dn.p_own.rr;
        xs[XF_RRNEW][tl.slot] = dn.p_own.rrnew;
        xs[XF_BAD][tl.slot] = dn.p_own.bad ? T(1) : T(0);
      }
    }
    __syncthreads();
    if (tl.owns()) consup_cell<T, D>(p, g, tl, L, o, dn, coeff, fac, f0, xs);
  }
}

template <typename T, int D, int NT1, int NT2, bool CONSUP, int TA>
int launch_variant(const FaceParams<T>& p, const Grid& g, const Layout& L,
                   cudaStream_t stream) {
  using Tile = FaceTileOf<D, CONSUP>;
  auto kernel = is_hydro(L) ? ctu_face_kernel<T, D, NT1, NT2, CONSUP, TA, true>
                            : ctu_face_kernel<T, D, NT1, NT2, CONSUP, TA, false>;
  kernel<<<Tile::blocks(g), Tile::threads(), 0, stream>>>(p, g, L);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dir(const FaceParams<T>& p, const Grid& g, const Layout& L, int nt1, int nt2,
               bool consup, const int* tdir, cudaStream_t stream) {
  constexpr int T1 = trans1(D), T2 = trans2(D);
  const bool castro = tdir[0] == T1 && (nt1 + nt2 < 2 || tdir[1] == T2);
  if (consup)
    return nt1 == 2 && nt2 == 0 && castro
               ? launch_variant<T, D, 2, 0, true, T1>(p, g, L, stream)
               : (int)cudaErrorInvalidValue;
  if (nt1 == 0 && nt2 == 0) return launch_variant<T, D, 0, 0, false, T1>(p, g, L, stream);
  if (nt1 == 1 && nt2 == 0 && tdir[0] == T2)
    return launch_variant<T, D, 1, 0, false, T2>(p, g, L, stream);
  if (!castro) return (int)cudaErrorInvalidValue;
  if (nt1 == 1 && nt2 == 0) return launch_variant<T, D, 1, 0, false, T1>(p, g, L, stream);
  if (nt1 == 1 && nt2 == 1) return launch_variant<T, D, 1, 1, false, T1>(p, g, L, stream);
  if (nt1 == 2 && nt2 == 0) return launch_variant<T, D, 2, 0, false, T1>(p, g, L, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_ctu_face(const void* qm, const void* qp, const void* qaux, const int* n,
                    const int* lay, int d, int nt1, int nt2, const void* const* F,
                    const void* const* pg, const void* const* ug, const double* cdtdx,
                    const int* tdir, void* flux1, void* qe1, void* flux2, void* qe2,
                    const void* hsrc, const void* div, const void* u, void* hout,
                    const double* cons, int with_fin, int solver, int mask_lo,
                    int mask_hi, int reset_density, int reset_rhoe, double small_dens,
                    double small_pres, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  if (!layout_ok(L) || nt1 + nt2 > 3) return (int)cudaErrorInvalidValue;
  FaceParams<T> p;
  p.qm = (const T*)qm;
  p.qp = (const T*)qp;
  p.qaux = (const T*)qaux;
  for (int k = 0; k < 3; ++k) {
    bool on = k < nt1 + nt2;
    p.terms[k] = Term<T>{on ? (const T*)F[k] : nullptr, on ? (const T*)pg[k] : nullptr,
                         on ? (const T*)ug[k] : nullptr, on ? T(cdtdx[k]) : T(0)};
  }
  p.flux1 = (T*)flux1;
  p.qe1 = (T*)qe1;
  p.flux2 = (T*)flux2;
  p.qe2 = (T*)qe2;
  p.cs = make_consup<T>(hsrc, div, u, hout, cons, with_fin, d);
  p.solver = solver;
  p.mask_lo = mask_lo;
  p.mask_hi = mask_hi;
  p.reset_density = reset_density;
  p.reset_rhoe = reset_rhoe;
  p.small_dens = T(small_dens);
  p.small_pres = T(small_pres);
  bool consup = hout != nullptr;
  if (d == 0) return launch_dir<T, 0>(p, g, L, nt1, nt2, consup, tdir, stream);
  if (d == 1) return launch_dir<T, 1>(p, g, L, nt1, nt2, consup, tdir, stream);
  if (d == 2) return launch_dir<T, 2>(p, g, L, nt1, nt2, consup, tdir, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ctt

#define FACE_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* qm, const void* qp, const void* qaux, const int* n,   \
                      const int* lay, int d, int nt1, int nt2, const void* const* F,    \
                      const void* const* pg, const void* const* ug,                     \
                      const double* cdtdx, const int* tdir, void* flux1, void* qe1,     \
                      void* flux2, void* qe2, const void* hsrc, const void* div,        \
                      const void* u, void* hout, const double* cons, int with_fin,      \
                      int solver, int mask_lo, int mask_hi, int reset_density,          \
                      int reset_rhoe, double small_dens, double small_pres,             \
                      void* stream) {                                                   \
    return ctt::launch_ctu_face<T>(qm, qp, qaux, n, lay, d, nt1, nt2, F, pg, ug,        \
                                   cdtdx, tdir, flux1, qe1, flux2, qe2, hsrc, div, u,   \
                                   hout, cons, with_fin, solver, mask_lo, mask_hi,      \
                                   reset_density, reset_rhoe, small_dens, small_pres,   \
                                   (cudaStream_t)stream);                               \
  }
FACE_ENTRY(ctt_ctu_face_f32, float)
FACE_ENTRY(ctt_ctu_face_f64, double)
