// One direction's conservative update on a face and on a cell (reference
// apply_av, advection_util.cpp:483; normalize_species_fluxes, :578;
// consup_hydro, Castro_ctu.cpp:12), 3D Cartesian, shared by the CTU face
// kernel's consup fold (ctu_face.cu) and the standalone consup kernel
// (consup.cu). Same arithmetic, in the same order, as
// castro_tpu_torch/ops/kernels.py:consup_plain.
// Replaces the body of castro_tpu/ops/pallas_kernels.py:consup_pallas
// (:1288-1333) and the fold of ctu_face_pallas.
#pragma once

#include "common.cuh"
#include "riemann.cuh"

namespace ctt {

template <typename T>
struct ConsupParams {
  const T* hsrc;
  const T* div;  // node-centred div u
  const T* u;
  T* hout;
  T difmag, dxd, inv_dx, fin_dt;
  int with_fin;
  int d;
};

// Artificial viscosity and species normalization applied to flux[NVAR] of
// face y (apply_av + normalize_species_fluxes) along d: p.d (consup.cu),
// or Axis<D> (the face kernel, whose direction is a template parameter).
template <typename T, int NPASS, typename Dir>
__device__ __forceinline__ void consup_flux(const ConsupParams<T>& p, const Grid& g,
                                            const Cell& y, T* flux, Dir d) {
  const long long S = g.S;
  int o1 = trans1(d), o2 = trans2(d);
  // node divergence averaged over the face's nodes: {0,+1} along o1, then o2
  Cell y1 = y.shift(g, o1, 1), y2 = y.shift(g, o2, 1), y12 = y1.shift(g, o2, 1);
  T a1 = T(0.5) * (p.div[y.at(g)] + p.div[y1.at(g)]);
  T a2 = T(0.5) * (p.div[y2.at(g)] + p.div[y12.at(g)]);
  T div1 = T(0.5) * (a1 + a2);
  T coeff = p.difmag * vmin(div1, T(0)) * p.dxd;
  long long iy = y.at(g), il = y.shift(g, d, -1).at(g);
#pragma unroll
  for (int c = 0; c < UFS + NPASS; ++c) {
    if (c == UTEMP) continue;
    flux[c] = flux[c] + coeff * (p.u[c * S + iy] - p.u[c * S + il]);
  }
  // species: nspec == NPASS on the kernel path (no aux components)
  T sumn = flux[UFS];
#pragma unroll
  for (int k = 1; k < NPASS; ++k) sumn = sumn + flux[UFS + k];
  T fac = sumn != T(0) ? flux[URHO] / sumn : T(1);
#pragma unroll
  for (int k = 0; k < NPASS; ++k) flux[UFS + k] = flux[UFS + k] * fac;
}

// hsrc of cell t plus direction d's flux divergence and p div u from the
// cleaned fluxes and Godunov (p, u_d) of the cell's lo and hi faces; with
// `with_fin`, u + dt * that.
template <typename T, int NPASS>
__device__ __forceinline__ void consup_update(const ConsupParams<T>& p, const Grid& g,
                                              long long t, const T* flo, const T* fhi,
                                              T pg_lo, T pg_hi, T ug_lo, T ug_hi) {
  const long long S = g.S;
  T pdivu = T(0.5) * (pg_hi + pg_lo) * (ug_hi - ug_lo) * p.inv_dx;
#pragma unroll
  for (int c = 0; c < UFS + NPASS; ++c) {
    T row = -(fhi[c] - flo[c]) * p.inv_dx;
    if (c == UEINT) row = row - pdivu;
    T h = p.hsrc[c * S + t] + row;
    if (p.with_fin) h = p.u[c * S + t] + p.fin_dt * h;
    p.hout[c * S + t] = h;
  }
}

template <typename T>
ConsupParams<T> make_consup(const void* hsrc, const void* div, const void* u, void* hout,
                            const double* cons, int with_fin, int d) {
  ConsupParams<T> c;
  c.hsrc = (const T*)hsrc;
  c.div = (const T*)div;
  c.u = (const T*)u;
  c.hout = (T*)hout;
  c.difmag = T(cons[0]);
  c.dxd = T(cons[1]);
  c.inv_dx = T(cons[2]);
  c.fin_dt = T(cons[3]);
  c.with_fin = with_fin;
  c.d = d;
  return c;
}

}  // namespace ctt
