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

template <typename T, int NPASS>
struct FaceOut {
  T flux[UFS + NPASS];
  T qe[NGDNV];
};

// One stage of NT terms (along TA, then TB) over the tile: every thread in
// the grid corrects its cell's two edge states, qmv (of face p+1) and qpv
// (of face p), with its cell's bundle and hands qm' up through xq; each
// thread that solves (tl.solves()) then solves face p into o. Without
// terms, qmv is face p's own traced qm. Every thread of the block calls
// it: it holds a barrier.
template <typename T, int NPASS, int D, int NT, int TA, int TB, typename Tile>
__device__ __forceinline__ void stage(const FaceParams<T>& p, const Term<T>* terms,
                                      const Grid& g, const Tile& tl, const T* qmv,
                                      const T* qpv, T (*xq)[Tile::THREADS],
                                      FaceOut<T, NPASS>& o) {
  constexpr int NQ = QFS + NPASS;
  const long long S = g.S;
  T qml[NQ], qpc[NQ];
  if constexpr (NT > 0) {
    if (tl.in) {
      Bundle<T, NPASS> b = term_bundle<T, NPASS, NT, TA, TB>(terms, p.qaux, g, tl.x);
      T qmc[NQ];
      trans_apply<T, NPASS>(qmv, b, p.small_pres, p.reset_density, p.reset_rhoe, qmc);
      trans_apply<T, NPASS>(qpv, b, p.small_pres, p.reset_density, p.reset_rhoe, qpc);
#pragma unroll
      for (int c = 0; c < NQ; ++c) xq[c][tl.slot] = qmc[c];
    }
    __syncthreads();
    if (!tl.solves()) return;
    const int b = tl.slot - Tile::STEP;  // the cell below
#pragma unroll
    for (int c = 0; c < NQ; ++c) qml[c] = xq[c][b];
  } else {
    if (!tl.solves()) return;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      qml[c] = qmv[c];
      qpc[c] = qpv[c];
    }
  }
  const long long ix = tl.ix(), im = tl.at(g, tl.p - 1);
  T mask = (tl.p == p.mask_lo || tl.p == p.mask_hi) ? T(0) : T(1);
  riemann_flux<T, NPASS>(qml, qpc, p.qaux[QGAMC * S + im], p.qaux[QGAMC * S + ix],
                         p.qaux[QC * S + im], p.qaux[QC * S + ix], Axis<D>(), p.solver, mask,
                         p.small_dens, p.small_pres, o.flux, o.qe);
}

template <typename T, int NPASS>
__device__ __forceinline__ void store(const FaceOut<T, NPASS>& o, T* flux, T* qe,
                                      long long S, long long ix) {
#pragma unroll
  for (int c = 0; c < UFS + NPASS; ++c) flux[c * S + ix] = o.flux[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) qe[c * S + ix] = o.qe[c];
}

// The block: 16 z columns of 16 cells along D = 0, 1; 64 cells along z
// by 2 rows of y for D = 2. With consup the tile has a high halo too.
template <int D, bool CONSUP>
using FaceTileOf = FaceTile<D, CONSUP ? 1 : 0, D == 2 ? 64 : 16, D == 2 ? 2 : 16>;

// TA is the direction of the first stage-1 term; the second stage-1 term
// and the stage-2 term run along trans2(D).
template <typename T, int NPASS, int D, int NT1, int NT2, bool CONSUP, int TA>
__global__ void __launch_bounds__(FaceTileOf<D, CONSUP>::THREADS) ctu_face_kernel(
    const __grid_constant__ FaceParams<T> p, Grid g) {
  constexpr int NQ = QFS + NPASS, NVAR = UFS + NPASS;
  constexpr int T2 = trans2(D);
  using Tile = FaceTileOf<D, CONSUP>;
  // qm' of the face above each cell, one array a stage
  __shared__ T xq[NT2 > 0 ? 2 : 1][NT1 > 0 ? NQ : 1][Tile::THREADS];
  // the cleaned flux, pg and u_D of each face, for the cell below it
  __shared__ T xf[CONSUP ? NVAR + 2 : 1][Tile::THREADS];
  const Tile tl(g);
  const long long S = g.S, ix = tl.ix();
  T qmv[NQ], qpv[NQ];  // the cell's two edges: qm of face p+1 (p without terms), qp of p
  if (tl.in) {
    const long long iq = NT1 > 0 ? tl.at(g, tl.p + 1) : ix;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      qmv[c] = p.qm[c * S + iq];
      qpv[c] = p.qp[c * S + ix];
    }
  }
  FaceOut<T, NPASS> o;
  stage<T, NPASS, D, NT1, TA, T2>(p, p.terms, g, tl, qmv, qpv, xq[0], o);
  if (!CONSUP && tl.owns()) store(o, p.flux1, p.qe1, S, ix);
  if constexpr (NT2 > 0) {
    FaceOut<T, NPASS> o2;
    stage<T, NPASS, D, NT2, T2, T2>(p, p.terms + NT1, g, tl, qmv, qpv, xq[1], o2);
    if (tl.owns()) store(o2, p.flux2, p.qe2, S, ix);
  }
  if constexpr (CONSUP) {
    if (tl.solves()) {
      consup_flux<T, NPASS>(p.cs, g, tl.x, o.flux, Axis<D>());
#pragma unroll
      for (int c = 0; c < NVAR; ++c) xf[c][tl.slot] = o.flux[c];
      xf[NVAR][tl.slot] = o.qe[GDPRES];
      xf[NVAR + 1][tl.slot] = o.qe[GDU + D];
    }
    __syncthreads();
    if (tl.owns()) {
      // the face above; the grid's top cell takes its own face again
      const int a = tl.p + 1 < g.n[D] ? tl.slot + Tile::STEP : tl.slot;
      T fhi[NVAR];
#pragma unroll
      for (int c = 0; c < NVAR; ++c) fhi[c] = xf[c][a];
      consup_update<T, NPASS>(p.cs, g, ix, o.flux, fhi, o.qe[GDPRES], xf[NVAR][a],
                              o.qe[GDU + D], xf[NVAR + 1][a]);
      store(o, p.flux1, p.qe1, S, ix);
    }
  }
}

template <typename T, int D, int NT1, int NT2, bool CONSUP, int TA>
int launch_variant(const FaceParams<T>& p, const Grid& g, cudaStream_t stream) {
  using Tile = FaceTileOf<D, CONSUP>;
  ctu_face_kernel<T, 1, D, NT1, NT2, CONSUP, TA>
      <<<Tile::blocks(g), Tile::threads(), 0, stream>>>(p, g);
  return (int)cudaGetLastError();
}

// The variant of (nt1, nt2, consup) with normal D. The terms' directions
// `tdir` must be the other two axes in Castro order (trans1, trans2); a
// lone corner term may take either.
template <typename T, int D>
int launch_dir(const FaceParams<T>& p, const Grid& g, int nt1, int nt2, bool consup,
               const int* tdir, cudaStream_t stream) {
  constexpr int T1 = trans1(D), T2 = trans2(D);
  const bool castro = tdir[0] == T1 && (nt1 + nt2 < 2 || tdir[1] == T2);
  if (consup)
    return nt1 == 2 && nt2 == 0 && castro ? launch_variant<T, D, 2, 0, true, T1>(p, g, stream)
                                          : (int)cudaErrorInvalidValue;
  if (nt1 == 0 && nt2 == 0) return launch_variant<T, D, 0, 0, false, T1>(p, g, stream);
  if (nt1 == 1 && nt2 == 0 && tdir[0] == T2)
    return launch_variant<T, D, 1, 0, false, T2>(p, g, stream);
  if (!castro) return (int)cudaErrorInvalidValue;
  if (nt1 == 1 && nt2 == 0) return launch_variant<T, D, 1, 0, false, T1>(p, g, stream);
  if (nt1 == 1 && nt2 == 1) return launch_variant<T, D, 1, 1, false, T1>(p, g, stream);
  if (nt1 == 2 && nt2 == 0) return launch_variant<T, D, 2, 0, false, T1>(p, g, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_ctu_face(const void* qm, const void* qp, const void* qaux, const int* n,
                    int npass, int d, int nt1, int nt2, const void* const* F,
                    const void* const* pg, const void* const* ug, const double* cdtdx,
                    const int* tdir, void* flux1, void* qe1, void* flux2, void* qe2,
                    const void* hsrc, const void* div, const void* u, void* hout,
                    const double* cons, int with_fin, int solver, int mask_lo,
                    int mask_hi, int reset_density, int reset_rhoe, double small_dens,
                    double small_pres, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  if (npass != 1 || nt1 + nt2 > 3) return (int)cudaErrorInvalidValue;
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
  if (d == 0) return launch_dir<T, 0>(p, g, nt1, nt2, consup, tdir, stream);
  if (d == 1) return launch_dir<T, 1>(p, g, nt1, nt2, consup, tdir, stream);
  if (d == 2) return launch_dir<T, 2>(p, g, nt1, nt2, consup, tdir, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ctt

#define FACE_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* qm, const void* qp, const void* qaux, const int* n,   \
                      int npass, int d, int nt1, int nt2, const void* const* F,         \
                      const void* const* pg, const void* const* ug,                     \
                      const double* cdtdx, const int* tdir, void* flux1, void* qe1,     \
                      void* flux2, void* qe2, const void* hsrc, const void* div,        \
                      const void* u, void* hout, const double* cons, int with_fin,      \
                      int solver, int mask_lo, int mask_hi, int reset_density,          \
                      int reset_rhoe, double small_dens, double small_pres,             \
                      void* stream) {                                                   \
    return ctt::launch_ctu_face<T>(qm, qp, qaux, n, npass, d, nt1, nt2, F, pg, ug,      \
                                   cdtdx, tdir, flux1, qe1, flux2, qe2, hsrc, div, u,   \
                                   hout, cons, with_fin, solver, mask_lo, mask_hi,      \
                                   reset_density, reset_rhoe, small_dens, small_pres,   \
                                   (cudaStream_t)stream);                               \
  }
FACE_ENTRY(ctt_ctu_face_f32, float)
FACE_ENTRY(ctt_ctu_face_f64, double)
