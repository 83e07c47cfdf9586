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
// Bound: bytes. The corner pair reads qm, qp [NQ], qaux and two terms'
// flux [NVAR] + pg + ug and writes two flux [NVAR] + qe [6]: 68 components
// a cell at NPASS=1; the final stage with consup 79.
// Design: one thread per face. The m-state bundle is the p-state bundle of
// the cell below along the normal (:640-642), so a thread evaluates the
// bundle at both cells from clamped neighbour reads. With consup the flux
// divergence needs the face above as well, so the thread also solves face
// i+1 (twice the stage's arithmetic) instead of staging faces in shared
// memory. The TPU's neighbour-tile BlockSpecs (:494-505, :550-577) and
// VMEM sizing (:356-383) have no counterpart: a thread computes its own
// clamped indices.
#include "common.cuh"
#include "consup.cuh"
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
  int d, solver, mask_lo, mask_hi, reset_density, reset_rhoe;
  T small_dens, small_pres;
};

template <typename T, int NPASS>
struct FaceOut {
  T flux[UFS + NPASS];
  T qe[NGDNV];
};

// Stage solve at face x from the interface states qm/qp of that face.
template <typename T, int NPASS, int NT>
__device__ __forceinline__ void stage(const FaceParams<T>& p, const Term<T>* terms,
                                      const Grid& g, const Cell& x, const T* qmv,
                                      const T* qpv, FaceOut<T, NPASS>& o) {
  constexpr int NQ = QFS + NPASS;
  const long long S = g.S;
  Cell xm = x.shift(g, p.d, -1);
  long long ix = x.at(g), im = xm.at(g);
  T qmc[NQ], qpc[NQ];
  if (NT > 0) {
    Bundle<T, NPASS> bp = term_bundle<T, NPASS, NT>(terms, p.qaux, g, x);
    Bundle<T, NPASS> bm = term_bundle<T, NPASS, NT>(terms, p.qaux, g, xm);
    trans_apply<T, NPASS>(qmv, bm, p.small_pres, p.reset_density, p.reset_rhoe, qmc);
    trans_apply<T, NPASS>(qpv, bp, p.small_pres, p.reset_density, p.reset_rhoe, qpc);
  } else {
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      qmc[c] = qmv[c];
      qpc[c] = qpv[c];
    }
  }
  int pos = x.c[p.d];
  T mask = (pos == p.mask_lo || pos == p.mask_hi) ? T(0) : T(1);
  riemann_flux<T, NPASS>(qmc, qpc, p.qaux[QGAMC * S + im], p.qaux[QGAMC * S + ix],
                         p.qaux[QC * S + im], p.qaux[QC * S + ix], p.d, p.solver, mask,
                         p.small_dens, p.small_pres, o.flux, o.qe);
}

template <typename T, int NPASS>
__device__ __forceinline__ void load_states(const FaceParams<T>& p, const Grid& g,
                                            long long ix, T* qmv, T* qpv) {
#pragma unroll
  for (int c = 0; c < QFS + NPASS; ++c) {
    qmv[c] = p.qm[c * g.S + ix];
    qpv[c] = p.qp[c * g.S + ix];
  }
}

template <typename T, int NPASS, int NT1, int NT2, bool CONSUP>
__global__ void __launch_bounds__(128) ctu_face_kernel(const __grid_constant__ FaceParams<T> p,
                                                       Grid g) {
  constexpr int NQ = QFS + NPASS, NVAR = UFS + NPASS;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  const long long S = g.S;
  Cell x = cell_of(g, t);
  T qmv[NQ], qpv[NQ];
  load_states<T, NPASS>(p, g, t, qmv, qpv);
  FaceOut<T, NPASS> o;
  stage<T, NPASS, NT1>(p, p.terms, g, x, qmv, qpv, o);
  if (NT2 > 0) {
    FaceOut<T, NPASS> o2;
    stage<T, NPASS, NT2>(p, p.terms + NT1, g, x, qmv, qpv, o2);
#pragma unroll
    for (int c = 0; c < NVAR; ++c) p.flux2[c * S + t] = o2.flux[c];
#pragma unroll
    for (int c = 0; c < NGDNV; ++c) p.qe2[c * S + t] = o2.qe[c];
  }
  if (CONSUP) {
    consup_flux<T, NPASS>(p.cs, g, x, o.flux);
    Cell xp = x.shift(g, p.d, 1);
    FaceOut<T, NPASS> op;
    if (xp.c[p.d] != x.c[p.d]) {
      T qmp[NQ], qpp[NQ];
      load_states<T, NPASS>(p, g, xp.at(g), qmp, qpp);
      stage<T, NPASS, NT1>(p, p.terms, g, xp, qmp, qpp, op);
      consup_flux<T, NPASS>(p.cs, g, xp, op.flux);
    } else {
      op = o;
    }
    consup_update<T, NPASS>(p.cs, g, t, o.flux, op.flux, o.qe[GDPRES], op.qe[GDPRES],
                            o.qe[GDU + p.d], op.qe[GDU + p.d]);
  }
#pragma unroll
  for (int c = 0; c < NVAR; ++c) p.flux1[c * S + t] = o.flux[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) p.qe1[c * S + t] = o.qe[c];
}

template <typename T, int NT1, int NT2, bool CONSUP>
int launch_variant(const FaceParams<T>& p, const Grid& g, cudaStream_t stream) {
  const int threads = 128;
  ctu_face_kernel<T, 1, NT1, NT2, CONSUP><<<blocks_for(g.S, threads), threads, 0, stream>>>(p, g);
  return (int)cudaGetLastError();
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
                         on ? (const T*)ug[k] : nullptr, on ? T(cdtdx[k]) : T(0),
                         on ? tdir[k] : 0};
  }
  p.flux1 = (T*)flux1;
  p.qe1 = (T*)qe1;
  p.flux2 = (T*)flux2;
  p.qe2 = (T*)qe2;
  p.cs = make_consup<T>(hsrc, div, u, hout, cons, with_fin, d);
  p.d = d;
  p.solver = solver;
  p.mask_lo = mask_lo;
  p.mask_hi = mask_hi;
  p.reset_density = reset_density;
  p.reset_rhoe = reset_rhoe;
  p.small_dens = T(small_dens);
  p.small_pres = T(small_pres);
  bool consup = hout != nullptr;
  if (nt1 == 0 && nt2 == 0 && !consup) return launch_variant<T, 0, 0, false>(p, g, stream);
  if (nt1 == 1 && nt2 == 0 && !consup) return launch_variant<T, 1, 0, false>(p, g, stream);
  if (nt1 == 1 && nt2 == 1 && !consup) return launch_variant<T, 1, 1, false>(p, g, stream);
  if (nt1 == 2 && nt2 == 0 && !consup) return launch_variant<T, 2, 0, false>(p, g, stream);
  if (nt1 == 2 && nt2 == 0 && consup) return launch_variant<T, 2, 0, true>(p, g, stream);
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
