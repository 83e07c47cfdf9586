// One direction's conservative update on a face and on a cell (reference
// apply_av, advection_util.cpp:483; normalize_species_fluxes, :578;
// consup_hydro, Castro_ctu.cpp:12), 3D Cartesian, shared by the CTU face
// kernel's consup fold (ctu_face.cu) and the standalone consup kernel
// (consup.cu). Same arithmetic, in the same order, as
// castro_tpu_torch/ops/kernels.py:consup_plain.
// Replaces the body of castro_tpu/ops/pallas_kernels.py:consup_pallas
// (:1288-1333) and the fold of ctu_face_pallas. The hydro components are
// held in arrays; the extras and passives are formed one at a time.
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

// The artificial-viscosity coefficient of face y along d: p.d
// (consup.cu), or Axis<D> (the face kernel, whose direction is a template
// parameter).
template <typename T, typename Dir>
__device__ __forceinline__ T av_coeff(const ConsupParams<T>& p, const Grid& g, const Cell& y,
                                      Dir d) {
  int o1 = trans1(d), o2 = trans2(d);
  // node divergence averaged over the face's nodes: {0,+1} along o1, then o2
  Cell y1 = y.shift(g, o1, 1), y2 = y.shift(g, o2, 1), y12 = y1.shift(g, o2, 1);
  T a1 = T(0.5) * (p.div[y.at(g)] + p.div[y1.at(g)]);
  T a2 = T(0.5) * (p.div[y2.at(g)] + p.div[y12.at(g)]);
  T div1 = T(0.5) * (a1 + a2);
  return p.difmag * vmin(div1, T(0)) * p.dxd;
}

// Component c of face y with artificial viscosity (apply_av), given the
// face's coefficient and the linear indices of the cells on both sides.
template <typename T>
__device__ __forceinline__ T av_comp(const ConsupParams<T>& p, long long S, int c, T f, T coeff,
                                     long long iy, long long il) {
  return f + coeff * (p.u[c * S + iy] - p.u[c * S + il]);
}

// Artificial viscosity on the hydro flux[NUH] of a face (not temperature).
template <typename T>
__device__ __forceinline__ void av_hydro(const ConsupParams<T>& p, long long S, T* flux,
                                         T coeff, long long iy, long long il) {
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    if (c == UTEMP) continue;
    flux[c] = av_comp(p, S, c, flux[c], coeff, iy, il);
  }
}

// An extra component's flux with viscosity: zero from the solve, and the
// shock flag is neither fluxed nor viscous (pallas_kernels.py:684).
template <typename T>
__device__ __forceinline__ T av_extra(const ConsupParams<T>& p, const Layout& L, long long S,
                                      int c, T coeff, long long iy, long long il) {
  return c == L.ushk ? T(0) : av_comp(p, S, c, T(0), coeff, iy, il);
}

// The species-normalization factor of a face (normalize_species_fluxes:
// the species fluxes scaled to sum to the density flux), from its density
// flux and the sum of its species fluxes taken in species order.
template <typename T>
__device__ __forceinline__ T species_fac(T frho, T sumn) {
  return sumn != T(0) ? frho / sumn : T(1);
}

// One row of cell t's update: hsrc plus direction d's flux divergence
// (and p div u on UEINT), or with `with_fin` u + dt * that.
template <typename T>
__device__ __forceinline__ void consup_row(const ConsupParams<T>& p, long long S, long long t,
                                           int c, T flo, T fhi, T pdivu) {
  T row = -(fhi - flo) * p.inv_dx;
  if (c == UEINT) row = row - pdivu;
  T h = p.hsrc[c * S + t] + row;
  if (p.with_fin) h = p.u[c * S + t] + p.fin_dt * h;
  p.hout[c * S + t] = h;
}

// The hydro rows of cell t from the cleaned fluxes and Godunov (p, u_d)
// of its lo and hi faces; returns p div u.
template <typename T>
__device__ __forceinline__ void consup_hydro(const ConsupParams<T>& p, long long S, long long t,
                                             const T* flo, const T* fhi, T pg_lo, T pg_hi,
                                             T ug_lo, T ug_hi) {
  T pdivu = T(0.5) * (pg_hi + pg_lo) * (ug_hi - ug_lo) * p.inv_dx;
#pragma unroll
  for (int c = 0; c < NUH; ++c) consup_row(p, S, t, c, flo[c], fhi[c], pdivu);
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
