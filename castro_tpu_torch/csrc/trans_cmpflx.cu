// trans_cmpflx: transverse-correct both interface states of a face with
// their summed bundles, then the Riemann solve, flux and Godunov state, in
// one pass (reference trans.cpp:67,442 then cmpflx_plus_godunov,
// riemann.cpp:16). It is the final stage of the 2D CTU update.
//
// Replaces castro_tpu/ops/pallas_kernels.py:trans_cmpflx_pallas (:145,
// call at :198). Same arithmetic as castro_tpu_torch/ops/kernels.py:
// trans_cmpflx_plain (trans.cuh, then riemann.cuh).
//
// Bound: bytes. A face reads qm, qp [NQ], two dflux [NVAR] and eight
// scalars and writes flux [NVAR] and qe [6]: 56 components at NPASS=1,
// against ~240 operations.
// Design: one thread per face, every access coalesced; the corrected
// states live in registers only, which is the whole point of the fusion
// (two [NQ] writes and reads saved against trans_apply x2 + cmpflx). The
// wall mask is the face's position along d; `coord` drops the pressure from
// the radial momentum flux of a curvilinear grid, and the RAD build takes
// the radiation layout, as in cmpflx.cu. A grid of fewer than three axes arrives padded with trailing
// extents of 1.
#include "common.cuh"
#include "riemann.cuh"
#include "trans.cuh"

namespace ctt {

template <typename T>
struct TransCmpflxParams {
  const T* qm;
  const T* qp;
  const T* df_m;
  const T* df_p;
  const T* dre_m;
  const T* dre_p;
  const T* dp_m;
  const T* dp_p;
  const T* gl;
  const T* gr;
  const T* cl;
  const T* cr;
  T* flux;
  T* qe;
  int d, coord, solver, mask_lo, mask_hi, reset_density, reset_rhoe;
  T small_dens, small_pres;
};

// A corrected hydro state out[QFS] of point t, and its density.
template <typename T>
__device__ __forceinline__ Dens<T> corrected(const T* q, const T* df, const T* dre,
                                             const T* dp, long long S, long long t,
                                             const TransCmpflxParams<T>& p, T* out) {
  T qv[QFS];
  Bundle<T> b;
#pragma unroll
  for (int c = 0; c < QFS; ++c) qv[c] = q[c * S + t];
#pragma unroll
  for (int c = 0; c < NUH; ++c) b.df[c] = df[c * S + t];
  b.dre = dre[t];
  b.dp = dp[t];
  return trans_apply(qv, b, p.small_pres, p.reset_density != 0, p.reset_rhoe != 0, out);
}

template <typename T, bool RAD>
__global__ void __launch_bounds__(256) trans_cmpflx_kernel(
    const __grid_constant__ TransCmpflxParams<T> p, Grid g, Layout L, QLayout Q) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  const long long S = g.S;
  T qmc[QFS], qpc[QFS];
  Dens<T> nm = corrected(p.qm, p.df_m, p.dre_m, p.dp_m, S, t, p, qmc);
  Dens<T> np = corrected(p.qp, p.df_p, p.dre_p, p.dp_p, S, t, p, qpc);
  int pos = cell_of(g, t).c[p.d];
  T mask = (pos == p.mask_lo || pos == p.mask_hi) ? T(0) : T(1);
  T fl[NUH], qg[NGDNV];
  Upwind<T> w = riemann_hydro(qmc, qpc, p.gl[t], p.gr[t], p.cl[t], p.cr[t], p.d, p.solver,
                              mask, p.small_dens, p.small_pres, fl, qg,
                              p.coord == 0 || p.d != 0);
#pragma unroll
  for (int c = 0; c < NUH; ++c) p.flux[c * S + t] = fl[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) p.qe[c * S + t] = qg[c];
  for (int c = NUH; c < L.ufs; ++c) p.flux[c * S + t] = T(0);
  for (int k = 0; k < L.npass; ++k) {
    const long long iq = (q_passives<RAD>(Q) + k) * S + t, iu = (L.ufs + k) * S + t;
    T qm_s = trans_passive(nm, p.qm[iq], p.df_m[iu]);
    T qp_s = trans_passive(np, p.qp[iq], p.df_p[iu]);
    p.flux[iu] = upwind(w, qm_s, qp_s);
  }
  zero_godunov_extras<RAD>(Q, p.qe, S, t);
}

template <typename T>
int launch_trans_cmpflx(const void* const* in, void* flux, void* qe, const int* n,
                        const int* lay, int d, int coord, int solver, int mask_lo, int mask_hi,
                        int reset_density, int reset_rhoe, double small_dens,
                        double small_pres, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  QLayout Q = q_layout_of(lay);
  if (!layout_ok(L) || !q_layout_ok(Q) || d < 0 || d > 2 || coord < 0 || coord > 2)
    return (int)cudaErrorInvalidValue;
  TransCmpflxParams<T> p;
  p.qm = (const T*)in[0];
  p.qp = (const T*)in[1];
  p.df_m = (const T*)in[2];
  p.df_p = (const T*)in[3];
  p.dre_m = (const T*)in[4];
  p.dre_p = (const T*)in[5];
  p.dp_m = (const T*)in[6];
  p.dp_p = (const T*)in[7];
  p.gl = (const T*)in[8];
  p.gr = (const T*)in[9];
  p.cl = (const T*)in[10];
  p.cr = (const T*)in[11];
  p.flux = (T*)flux;
  p.qe = (T*)qe;
  p.d = d;
  p.coord = coord;
  p.solver = solver;
  p.mask_lo = mask_lo;
  p.mask_hi = mask_hi;
  p.reset_density = reset_density;
  p.reset_rhoe = reset_rhoe;
  p.small_dens = T(small_dens);
  p.small_pres = T(small_pres);
  const int threads = 256;
  auto kernel = q_layout_rad(Q) ? trans_cmpflx_kernel<T, true> : trans_cmpflx_kernel<T, false>;
  kernel<<<blocks_for(g.S, threads), threads, 0, stream>>>(p, g, L, Q);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define TRANS_CMPFLX_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* qm, const void* qp, const void* df_m, const void* df_p,  \
                      const void* dre_m, const void* dre_p, const void* dp_m,              \
                      const void* dp_p, const void* gl, const void* gr, const void* cl,    \
                      const void* cr, void* flux, void* qe, const int* n, const int* lay,  \
                      int d, int coord, int solver, int mask_lo, int mask_hi,              \
                      int reset_density, int reset_rhoe, double small_dens,                \
                      double small_pres, void* stream) {                                   \
    const void* in[12] = {qm, qp, df_m, df_p, dre_m, dre_p, dp_m, dp_p, gl, gr, cl, cr};   \
    return ctt::launch_trans_cmpflx<T>(in, flux, qe, n, lay, d, coord, solver, mask_lo,    \
                                       mask_hi, reset_density, reset_rhoe, small_dens,     \
                                       small_pres, (cudaStream_t)stream);                  \
  }
TRANS_CMPFLX_ENTRY(ctt_trans_cmpflx_f32, float)
TRANS_CMPFLX_ENTRY(ctt_trans_cmpflx_f64, double)
