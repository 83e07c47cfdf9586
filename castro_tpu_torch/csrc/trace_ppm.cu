// trace_ppm: PPM reconstruction, integration under the parabola and
// characteristic tracing of one direction (reference trace_ppm.cpp:16-596),
// optionally chained with the 1D Riemann solve and flux of the same faces.
//
// Replaces castro_tpu/ops/pallas_kernels.py:trace_ppm_pallas (:1415, call at
// :1502) with fuse_riemann. Same arithmetic as castro_tpu_torch/ops/
// trace_ppm.py:trace_ppm followed by ops/riemann.py:cmpflx.
//
// Bound: bytes. It reads q[NQ], qaux[4], flatn [and srcQ[NQ]] and writes
// qm[NQ], qp[NQ], flux[NVAR] and qe[6]: 44 components a cell at NPASS=1
// without srcQ.
// Design: one thread per face i (interface i-1/2 along d). qp at face i is
// cell i's left-edge state and qm is cell i-1's right-edge state
// (trace_ppm.py face registration), so the thread traces both cells from
// their own clamped +-2 stencils: about twice the arithmetic of a
// per-cell trace, no shared memory and no pencil blocking (the TPU's
// _pencil_spec, :1368-1412, was a VMEM budget). The Riemann solve then
// reads gamc and c of cells i-1 and i.
#include "common.cuh"
#include "riemann.cuh"

namespace ctt {

template <typename T>
struct TraceConst {
  T dtdx, hdt, small_dens, small_pres, small_rhoe;
};

template <typename T>
__device__ __forceinline__ T vanleer(T sm1, T s0, T sp1) {
  T dsl = T(2) * (s0 - sm1);
  T dsr = T(2) * (sp1 - s0);
  T dsc = T(0.5) * (sp1 - sm1);
  T mag = vmin(vabs(dsc), vmin(vabs(dsl), vabs(dsr)));
  return dsl * dsr > T(0) ? sgn(dsc) * mag : T(0);
}

// PPM edge values (sm, sp) of component array `a` at cell x along d
// (ppm.py:ppm_reconstruct); returns s itself.
template <typename T>
__device__ __forceinline__ T ppm_reconstruct(const T* a, const Grid& g, const Cell& x,
                                             int d, T fl, T& sm_out, T& sp_out) {
  T sm2 = a[x.shift(g, d, -2).at(g)], sm1 = a[x.shift(g, d, -1).at(g)];
  T s = a[x.at(g)];
  T sp1 = a[x.shift(g, d, 1).at(g)], sp2 = a[x.shift(g, d, 2).at(g)];
  const T SIXTH = T(1.0 / 6.0);

  T dsvl_l = vanleer(sm2, sm1, s);
  T dsvl_r = vanleer(sm1, s, sp1);
  T sm = T(0.5) * (s + sm1) - SIXTH * (dsvl_r - dsvl_l);
  sm = clip(sm, vmin(s, sm1), vmax(s, sm1));
  T dsvl_r2 = vanleer(s, sp1, sp2);
  T sp = T(0.5) * (sp1 + s) - SIXTH * (dsvl_r2 - dsvl_r);
  sp = clip(sp, vmin(sp1, s), vmax(sp1, s));

  sm = fl * sm + (T(1) - fl) * s;
  sp = fl * sp + (T(1) - fl) * s;

  bool extremum = (sp - s) * (s - sm) <= T(0);
  bool big_p = vabs(sp - s) >= T(2) * vabs(sm - s);
  bool big_m = vabs(sm - s) >= T(2) * vabs(sp - s);
  sp_out = extremum ? s : (big_p ? T(3) * s - T(2) * sm : sp);
  sm_out = extremum ? s : ((!big_p && big_m) ? T(3) * s - T(2) * sp : sm);
  return s;
}

// Integral under the parabola toward the traced edge for one wave speed
// (ppm.py:_integrate): the left edge (Im) for the plus state, the right
// edge (Ip) for the minus state.
template <typename T, bool PLUS>
__device__ __forceinline__ T integrate(T sm, T sp, T s6, T speed, T dtdx) {
  T sigma = vabs(speed) * dtdx;
  bool go_left = speed <= T(0);
  T x = T(1) - T(2.0 / 3.0) * sigma;
  if (PLUS) return go_left ? sm + T(0.5) * sigma * (sp - sm + x * s6) : sm;
  return go_left ? sp : sp - T(0.5) * sigma * (sp - sm - x * s6);
}

template <typename T, bool PLUS>
__device__ __forceinline__ void ppm3(const T* a, const Grid& g, const Cell& x, int d,
                                     T fl, T un, T cc, T dtdx, T I[3]) {
  T sm, sp;
  T s = ppm_reconstruct(a, g, x, d, fl, sm, sp);
  T s6 = T(6) * s - T(3) * (sm + sp);
  I[0] = integrate<T, PLUS>(sm, sp, s6, un - cc, dtdx);
  I[1] = integrate<T, PLUS>(sm, sp, s6, un, dtdx);
  I[2] = integrate<T, PLUS>(sm, sp, s6, un + cc, dtdx);
}

template <typename T, bool PLUS>
__device__ __forceinline__ T ppm1(const T* a, const Grid& g, const Cell& x, int d,
                                  T fl, T un, T dtdx) {
  T sm, sp;
  T s = ppm_reconstruct(a, g, x, d, fl, sm, sp);
  T s6 = T(6) * s - T(3) * (sm + sp);
  return integrate<T, PLUS>(sm, sp, s6, un, dtdx);
}

// Wave-side weight: a stationary wave gets half weight on each side.
template <typename T, bool PLUS>
__device__ __forceinline__ T wside(T speed) {
  T w_minus = T(0.5) * (T(1) - sgn(speed));
  return PLUS ? w_minus : T(1) - w_minus;
}

// The traced state of cell x toward its left edge (PLUS) or right edge.
template <typename T, int NPASS, bool PLUS>
__device__ void trace_side(const T* q, const T* qaux, const T* flatn, const T* src,
                           const Grid& g, const Cell& x, int d,
                           const TraceConst<T>& k, T* out) {
  const long long S = g.S;
  long long ix = x.at(g);
  int qun = QU + d, qut = QU + (d + 1) % 3, qutt = QU + (d + 2) % 3;
  T fl = flatn[ix];
  T un = q[qun * S + ix];
  T cc = qaux[QC * S + ix];
  T dtdx = k.dtdx, hdt = k.hdt;

  T I_rho[3], I_un[3], I_p[3], I_re[3], I_gc[3];
  ppm3<T, PLUS>(q + QRHO * S, g, x, d, fl, un, cc, dtdx, I_rho);
  ppm3<T, PLUS>(q + qun * S, g, x, d, fl, un, cc, dtdx, I_un);
  ppm3<T, PLUS>(q + QPRES * S, g, x, d, fl, un, cc, dtdx, I_p);
  ppm3<T, PLUS>(q + QREINT * S, g, x, d, fl, un, cc, dtdx, I_re);
  ppm3<T, PLUS>(qaux + QGAMC * S, g, x, d, fl, un, cc, dtdx, I_gc);
  T I_ut = ppm1<T, PLUS>(q + qut * S, g, x, d, fl, un, dtdx);
  T I_utt = ppm1<T, PLUS>(q + qutt * S, g, x, d, fl, un, dtdx);

  T S_rho[3] = {T(0), T(0), T(0)}, S_un[3] = {T(0), T(0), T(0)};
  T S_p[3] = {T(0), T(0), T(0)}, S_re[3] = {T(0), T(0), T(0)};
  T S_ut = T(0), S_utt = T(0);
  if (src != nullptr) {
    ppm3<T, PLUS>(src + QRHO * S, g, x, d, fl, un, cc, dtdx, S_rho);
    ppm3<T, PLUS>(src + qun * S, g, x, d, fl, un, cc, dtdx, S_un);
    ppm3<T, PLUS>(src + QPRES * S, g, x, d, fl, un, cc, dtdx, S_p);
    ppm3<T, PLUS>(src + QREINT * S, g, x, d, fl, un, cc, dtdx, S_re);
    S_ut = ppm1<T, PLUS>(src + qut * S, g, x, d, fl, un, dtdx);
    S_utt = ppm1<T, PLUS>(src + qutt * S, g, x, d, fl, un, dtdx);
  }

  const int r = PLUS ? 0 : 2;
  T rho_ref = vmax(I_rho[r] + hdt * S_rho[r], k.small_dens);
  T un_ref = I_un[r] + hdt * S_un[r];
  T p_ref = vmax(I_p[r] + hdt * S_p[r], k.small_pres);
  T rhoe_ref = I_re[r] + hdt * S_re[r];
  T gam_ref = I_gc[r];

  T rho_ref_inv = T(1) / rho_ref;
  T csq_ref = gam_ref * p_ref * rho_ref_inv;
  T cc_ref = vsqrt(csq_ref);
  T cc_ref_inv = T(1) / cc_ref;
  T h_ref = (p_ref + rhoe_ref) * rho_ref_inv;

  T dum = un_ref - I_un[0] - hdt * S_un[0];
  T dptotm = p_ref - I_p[0] - hdt * S_p[0];
  T drho = rho_ref - I_rho[1] - hdt * S_rho[1];
  T dptot = p_ref - I_p[1] - hdt * S_p[1];
  T drhoe = rhoe_ref - I_re[1] - hdt * S_re[1];
  T dup = un_ref - I_un[2] - hdt * S_un[2];
  T dptotp = p_ref - I_p[2] - hdt * S_p[2];

  T alpham = T(0.5) * (dptotm * rho_ref_inv * cc_ref_inv - dum) * rho_ref * cc_ref_inv;
  T alphap = T(0.5) * (dptotp * rho_ref_inv * cc_ref_inv + dup) * rho_ref * cc_ref_inv;
  T alpha0r = drho - dptot / csq_ref;
  T alpha0e = drhoe - dptot * h_ref / csq_ref;

  alpham = -alpham * wside<T, PLUS>(un - cc);
  alphap = -alphap * wside<T, PLUS>(un + cc);
  T w0 = wside<T, PLUS>(un);
  alpha0r = -alpha0r * w0;
  alpha0e = -alpha0e * w0;

#pragma unroll
  for (int c = 0; c < QFS + NPASS; ++c) out[c] = q[c * S + ix];
  out[QRHO] = vmax(k.small_dens, rho_ref + alphap + alpham + alpha0r);
  out[qun] = un_ref + (alphap - alpham) * cc_ref * rho_ref_inv;
  out[QREINT] = vmax(k.small_rhoe, rhoe_ref + (alphap + alpham) * h_ref + alpha0e);
  out[QPRES] = vmax(k.small_pres, p_ref + (alphap + alpham) * csq_ref);
  out[qut] = I_ut + hdt * S_ut;
  out[qutt] = I_utt + hdt * S_utt;
  // passives ride the contact only
#pragma unroll
  for (int j = 0; j < NPASS; ++j)
    out[QFS + j] = ppm1<T, PLUS>(q + (QFS + j) * S, g, x, d, fl, un, dtdx);
}

template <typename T, int NPASS>
__global__ void __launch_bounds__(128) trace_ppm_kernel(
    const T* __restrict__ q, const T* __restrict__ qaux, const T* __restrict__ flatn,
    const T* __restrict__ src, T* __restrict__ qm_out, T* __restrict__ qp_out,
    T* __restrict__ flux, T* __restrict__ qe, Grid g, int d, TraceConst<T> k,
    int solver, int mask_lo, int mask_hi) {
  constexpr int NQ = QFS + NPASS, NVAR = UFS + NPASS;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  const long long S = g.S;
  Cell x = cell_of(g, t);
  Cell xm = x.shift(g, d, -1);
  T qp[NQ], qm[NQ];
  trace_side<T, NPASS, true>(q, qaux, flatn, src, g, x, d, k, qp);
  trace_side<T, NPASS, false>(q, qaux, flatn, src, g, xm, d, k, qm);
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    qm_out[c * S + t] = qm[c];
    qp_out[c * S + t] = qp[c];
  }
  if (flux == nullptr) return;
  long long im = xm.at(g);
  int pos = x.c[d];
  T mask = (pos == mask_lo || pos == mask_hi) ? T(0) : T(1);
  T f[NVAR], e[NGDNV];
  riemann_flux<T, NPASS>(qm, qp, qaux[QGAMC * S + im], qaux[QGAMC * S + t],
                         qaux[QC * S + im], qaux[QC * S + t], d, solver, mask,
                         k.small_dens, k.small_pres, f, e);
#pragma unroll
  for (int c = 0; c < NVAR; ++c) flux[c * S + t] = f[c];
#pragma unroll
  for (int c = 0; c < NGDNV; ++c) qe[c * S + t] = e[c];
}

template <typename T>
int launch_trace_ppm(const void* q, const void* qaux, const void* flatn, const void* src,
                     void* qm, void* qp, void* flux, void* qe, const int* n, int npass,
                     int d, const double* consts, int solver, int mask_lo, int mask_hi,
                     cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  TraceConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3]), T(consts[4])};
  if (npass != 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  trace_ppm_kernel<T, 1><<<blocks_for(g.S, threads), threads, 0, stream>>>(
      (const T*)q, (const T*)qaux, (const T*)flatn, (const T*)src, (T*)qm, (T*)qp,
      (T*)flux, (T*)qe, g, d, k, solver, mask_lo, mask_hi);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define TRACE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* q, const void* qaux, const void* flatn,             \
                      const void* src, void* qm, void* qp, void* flux, void* qe,      \
                      const int* n, int npass, int d, const double* consts,           \
                      int solver, int mask_lo, int mask_hi, void* stream) {           \
    return ctt::launch_trace_ppm<T>(q, qaux, flatn, src, qm, qp, flux, qe, n, npass,  \
                                    d, consts, solver, mask_lo, mask_hi,              \
                                    (cudaStream_t)stream);                            \
  }
TRACE_ENTRY(ctt_trace_ppm_f32, float)
TRACE_ENTRY(ctt_trace_ppm_f64, double)
