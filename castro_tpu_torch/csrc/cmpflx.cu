// cmpflx: the pointwise Riemann solve (riemannus or HLLC), flux and Godunov
// state of every face of a 1D, 2D or 3D grid, from the face states qm/qp
// and the gamc and c of the cells on both sides (reference
// cmpflx_plus_godunov, riemann.cpp:16).
//
// Replaces castro_tpu/ops/pallas_kernels.py:cmpflx_pallas (:210, call at
// :235). Same arithmetic as castro_tpu_torch/ops/kernels.py:cmpflx_plain.
//
// Bound: bytes. A face reads qm, qp [NQ] and four scalars and writes flux
// [NVAR] and qe [6]: 36 components at NPASS=1, against ~150 operations.
// Design: one thread per face, every access coalesced along the last axis;
// no neighbours are read (the caller gathers the left cell's gamc and c).
// The wall mask is the face's position along d, so symmetry and wall runs
// stay on the kernel. `coord` (0 Cartesian, 1 cylindrical, 2 spherical)
// drops the pressure from the radial momentum flux of a curvilinear grid,
// so RZ and spherical runs solve every face here. Built twice (RAD): on
// the radiation layout the passives start at Q.qfs and a face has Q.ngdnv
// Godunov components, so the operator-split radiation step (whose q
// carries QPTOT, QREITOT and each group's Er before the passives) solves
// here too, its flux limiters and Er written as zeros. The TPU's tiling (_tiling, _block_spec) has no
// counterpart. A grid of fewer than three axes arrives padded with
// trailing extents of 1.
#include "common.cuh"
#include "riemann.cuh"

namespace ctt {

template <typename T, bool RAD>
__global__ void __launch_bounds__(256) cmpflx_kernel(
    const T* __restrict__ qm, const T* __restrict__ qp, const T* __restrict__ gl,
    const T* __restrict__ gr, const T* __restrict__ cl, const T* __restrict__ cr,
    T* __restrict__ flux, T* __restrict__ qe, Grid g, Layout L, QLayout Q, int d, int coord,
    int solver, int mask_lo, int mask_hi, T small_dens, T small_pres) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  const long long S = g.S;
  T qmv[QFS], qpv[QFS];
#pragma unroll
  for (int c = 0; c < QFS; ++c) {
    qmv[c] = qm[c * S + t];
    qpv[c] = qp[c * S + t];
  }
  int pos = cell_of(g, t).c[d];
  T mask = (pos == mask_lo || pos == mask_hi) ? T(0) : T(1);
  T fl[NUH], qg[NGDNV];
  Upwind<T> w = riemann_hydro(qmv, qpv, gl[t], gr[t], cl[t], cr[t], d, solver, mask,
                              small_dens, small_pres, fl, qg, coord == 0 || d != 0);
#pragma unroll
  for (int c = 0; c < NUH; ++c) flux[c * S + t] = fl[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) qe[c * S + t] = qg[c];
  store_passive_fluxes(L, q_passives<RAD>(Q), w, qm, qp, flux, S, t);
  zero_godunov_extras<RAD>(Q, qe, S, t);
}

template <typename T>
int launch_cmpflx(const void* qm, const void* qp, const void* gl, const void* gr,
                  const void* cl, const void* cr, void* flux, void* qe, const int* n,
                  const int* lay, int d, int coord, int solver, int mask_lo, int mask_hi,
                  double small_dens, double small_pres, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  QLayout Q = q_layout_of(lay);
  if (!layout_ok(L) || !q_layout_ok(Q) || d < 0 || d > 2 || coord < 0 || coord > 2)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto kernel = q_layout_rad(Q) ? cmpflx_kernel<T, true> : cmpflx_kernel<T, false>;
  kernel<<<blocks_for(g.S, threads), threads, 0, stream>>>(
      (const T*)qm, (const T*)qp, (const T*)gl, (const T*)gr, (const T*)cl, (const T*)cr,
      (T*)flux, (T*)qe, g, L, Q, d, coord, solver, mask_lo, mask_hi, T(small_dens),
      T(small_pres));
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define CMPFLX_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const void* qm, const void* qp, const void* gl, const void* gr,      \
                      const void* cl, const void* cr, void* flux, void* qe, const int* n,  \
                      const int* lay, int d, int coord, int solver, int mask_lo,           \
                      int mask_hi, double small_dens, double small_pres, void* stream) {   \
    return ctt::launch_cmpflx<T>(qm, qp, gl, gr, cl, cr, flux, qe, n, lay, d, coord,       \
                                 solver, mask_lo, mask_hi, small_dens, small_pres,         \
                                 (cudaStream_t)stream);                                    \
  }
CMPFLX_ENTRY(ctt_cmpflx_f32, float)
CMPFLX_ENTRY(ctt_cmpflx_f64, double)
