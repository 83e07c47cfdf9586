// consup: one direction's conservative update of a 3D Cartesian grid:
// artificial viscosity from the node-averaged div u, species-flux
// normalization, hsrc += -(F[i+1] - F[i]) / dx_d, hsrc[UEINT] -= p div u
// from the Godunov pressure and normal velocity, and with `with_fin` the
// update u + dt * hsrc; it also returns the cleaned flux (reference
// apply_av, advection_util.cpp:483; normalize_species_fluxes, :578;
// consup_hydro, Castro_ctu.cpp:12).
//
// Replaces castro_tpu/ops/pallas_kernels.py:consup_pallas (:1243, calls at
// :1346, :1355). Same arithmetic as castro_tpu_torch/ops/kernels.py:
// consup_plain; the body is consup.cuh, shared with ctu_face.cu.
//
// Bound: bytes. A cell reads hsrc, flux, u [NVAR], pg, ug and div and
// writes hsrc' and flux' [NVAR]: 43 components at NPASS=1, against ~80
// operations.
// Design: one thread per cell, one pass. The cell's update needs the
// cleaned flux of its lo face and of its hi face, so the thread cleans
// both (the viscosity and the normalization twice) instead of a second
// pass over a stored cleaned flux or faces staged in shared memory; the
// neighbour reads come through L1/L2 with clamped indices. The node
// average of div u is taken along the lower transverse axis first, as
// apply_av rounds it. The TPU's tile axis, its pre-shifted copy of div,
// the scalar prefetch of dt and the aliased hsrc have no counterpart:
// hsrc' is a new array.
#include "common.cuh"
#include "consup.cuh"

namespace ctt {

template <typename T>
__global__ void __launch_bounds__(256) consup_kernel(
    const __grid_constant__ ConsupParams<T> p, const T* __restrict__ flux,
    const T* __restrict__ pg, const T* __restrict__ ug, T* __restrict__ fout, Grid g,
    Layout L) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  const long long S = g.S;
  Cell x = cell_of(g, t);
  Cell xp = x.shift(g, p.d, 1);
  long long ip = xp.at(g);
  // the cells below the lo face (x) and the hi face (xp)
  long long il = x.shift(g, p.d, -1).at(g), ilp = xp.shift(g, p.d, -1).at(g);
  T clo = av_coeff(p, g, x, p.d), chi = av_coeff(p, g, xp, p.d);
  T flo[NUH], fhi[NUH];
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    flo[c] = flux[c * S + t];
    fhi[c] = flux[c * S + ip];
  }
  av_hydro(p, S, flo, clo, t, il);
  av_hydro(p, S, fhi, chi, ip, ilp);
  consup_hydro(p, S, t, flo, fhi, pg[t], pg[ip], ug[t], ug[ip]);
#pragma unroll
  for (int c = 0; c < NUH; ++c) fout[c * S + t] = flo[c];
  for (int c = NUH; c < L.ufs; ++c) {
    T fl = av_extra(p, L, S, c, clo, t, il);
    T fh = av_extra(p, L, S, c, chi, ip, ilp);
    consup_row(p, S, t, c, fl, fh, T(0));
    fout[c * S + t] = fl;
  }
  // the species sums of both faces, in species order, then each passive
  T slo = T(0), shi = T(0);
  for (int k = 0; k < L.nspec; ++k) {
    const int c = L.ufs + k;
    T fl = av_comp(p, S, c, flux[c * S + t], clo, t, il);
    T fh = av_comp(p, S, c, flux[c * S + ip], chi, ip, ilp);
    slo = k == 0 ? fl : slo + fl;
    shi = k == 0 ? fh : shi + fh;
  }
  T fac_lo = species_fac(flo[URHO], slo), fac_hi = species_fac(fhi[URHO], shi);
  for (int k = 0; k < L.npass; ++k) {
    const int c = L.ufs + k;
    T fl = av_comp(p, S, c, flux[c * S + t], clo, t, il);
    T fh = av_comp(p, S, c, flux[c * S + ip], chi, ip, ilp);
    if (k < L.nspec) {
      fl = fl * fac_lo;
      fh = fh * fac_hi;
    }
    consup_row(p, S, t, c, fl, fh, T(0));
    fout[c * S + t] = fl;
  }
}

template <typename T>
int launch_consup(const void* hsrc, const void* flux, const void* pg, const void* ug,
                  const void* div, const void* u, void* hout, void* fout, const int* n,
                  const int* lay, int d, const double* cons, int with_fin,
                  cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  if (!layout_ok(L) || d < 0 || d > 2) return (int)cudaErrorInvalidValue;
  ConsupParams<T> p = make_consup<T>(hsrc, div, u, hout, cons, with_fin, d);
  const int threads = 256;
  consup_kernel<T><<<blocks_for(g.S, threads), threads, 0, stream>>>(
      p, (const T*)flux, (const T*)pg, (const T*)ug, (T*)fout, g, L);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define CONSUP_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* hsrc, const void* flux, const void* pg, const void* ug, \
                      const void* div, const void* u, void* hout, void* fout,             \
                      const int* n, const int* lay, int d, const double* cons,            \
                      int with_fin, void* stream) {                                       \
    return ctt::launch_consup<T>(hsrc, flux, pg, ug, div, u, hout, fout, n, lay, d,       \
                                 cons, with_fin, (cudaStream_t)stream);                   \
  }
CONSUP_ENTRY(ctt_consup_f32, float)
CONSUP_ENTRY(ctt_consup_f64, double)
