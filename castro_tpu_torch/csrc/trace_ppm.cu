// trace_ppm: PPM reconstruction, integration under the parabola and
// characteristic tracing of one direction (reference trace_ppm.cpp:16-596),
// optionally chained with the 1D Riemann solve and flux of the same faces.
//
// Replaces castro_tpu/ops/pallas_kernels.py:trace_ppm_pallas (:1415, call at
// :1502) with fuse_riemann. Same arithmetic as castro_tpu_torch/ops/
// trace_ppm.py:trace_ppm followed by ops/riemann.py:cmpflx.
//
// Bound: bytes. It reads q[NQ], qaux[2], flatn [and srcQ[NQ]] and writes
// qm[NQ], qp[NQ], flux[NVAR] and qe[6]: 44 components a cell at NPASS=1
// without srcQ.
// Design: one thread a cell, the direction D a template parameter (every
// index into a thread's arrays is then a constant, and they stay in
// registers). A thread reconstructs each component of its cell once and
// integrates that parabola toward both edges: the left-edge state is qp of
// face i, the right-edge state qm of face i + 1 (trace_ppm.py face
// registration). A block is a FaceTile (face_tile.cuh): cells along D with
// one halo cell below, the right-edge states handed to the thread above in
// shared memory, where face i solves with cell i-1's qm, gamc and c and
// its own qp. qm is written by the thread that traced it, so the variant
// without the solve needs no barrier. The TPU's pencil blocking
// (_pencil_spec, :1368-1412) was a VMEM budget and has no counterpart.
#include "common.cuh"
#include "face_tile.cuh"
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

// The parabola of a component at the cell `a` points to, whose clamped
// stencil along D lies at the offsets o5 (ppm.py:ppm_reconstruct): its
// edge values sm, sp and s6.
template <typename T>
__device__ __forceinline__ void parabola(const T* a, const int (&o5)[5], T fl, T& sm, T& sp,
                                         T& s6) {
  T sm2 = a[o5[0]], sm1 = a[o5[1]], s = a[o5[2]], sp1 = a[o5[3]], sp2 = a[o5[4]];
  const T SIXTH = T(1.0 / 6.0);

  T dsvl_l = vanleer(sm2, sm1, s);
  T dsvl_r = vanleer(sm1, s, sp1);
  T m = T(0.5) * (s + sm1) - SIXTH * (dsvl_r - dsvl_l);
  m = clip(m, vmin(s, sm1), vmax(s, sm1));
  T dsvl_r2 = vanleer(s, sp1, sp2);
  T p = T(0.5) * (sp1 + s) - SIXTH * (dsvl_r2 - dsvl_r);
  p = clip(p, vmin(sp1, s), vmax(sp1, s));

  m = fl * m + (T(1) - fl) * s;
  p = fl * p + (T(1) - fl) * s;

  bool extremum = (p - s) * (s - m) <= T(0);
  bool big_p = vabs(p - s) >= T(2) * vabs(m - s);
  bool big_m = vabs(m - s) >= T(2) * vabs(p - s);
  sp = extremum ? s : (big_p ? T(3) * s - T(2) * m : p);
  sm = extremum ? s : ((!big_p && big_m) ? T(3) * s - T(2) * p : m);
  s6 = T(6) * s - T(3) * (sm + sp);
}

// Integrals under the parabola for one wave speed (ppm.py:_integrate):
// toward the left edge (im, the plus state's) and the right edge (ip).
template <typename T>
__device__ __forceinline__ void integrate(T sm, T sp, T s6, T speed, T dtdx, T& im, T& ip) {
  T sigma = vabs(speed) * dtdx;
  bool go_left = speed <= T(0);
  T x = T(1) - T(2.0 / 3.0) * sigma;
  im = go_left ? sm + T(0.5) * sigma * (sp - sm + x * s6) : sm;
  ip = go_left ? sp : sp - T(0.5) * sigma * (sp - sm - x * s6);
}

// A component's integrals for the waves u-c, u, u+c, toward each edge.
template <typename T>
struct Waves {
  T im[3], ip[3];
};
// A component's integrals for the contact u alone.
template <typename T>
struct Wave1 {
  T im, ip;
};

template <typename T>
__device__ __forceinline__ Waves<T> waves(const T* a, const int (&o5)[5], T fl, T un, T cc,
                                          T dtdx) {
  T sm, sp, s6;
  parabola(a, o5, fl, sm, sp, s6);
  Waves<T> w;
  integrate(sm, sp, s6, un - cc, dtdx, w.im[0], w.ip[0]);
  integrate(sm, sp, s6, un, dtdx, w.im[1], w.ip[1]);
  integrate(sm, sp, s6, un + cc, dtdx, w.im[2], w.ip[2]);
  return w;
}

template <typename T>
__device__ __forceinline__ Wave1<T> wave1(const T* a, const int (&o5)[5], T fl, T un,
                                          T dtdx) {
  T sm, sp, s6;
  parabola(a, o5, fl, sm, sp, s6);
  Wave1<T> w;
  integrate(sm, sp, s6, un, dtdx, w.im, w.ip);
  return w;
}

// Every integral a cell's two traced states read: of q (rho, u_n, p, rho e),
// gamc and the transverse velocities, and of srcQ (zero without it).
template <typename T>
struct CellWaves {
  Waves<T> rho, un, p, re, gc, s_rho, s_un, s_p, s_re;
  Wave1<T> ut, utt, s_ut, s_utt;
};

// Wave-side weight: a stationary wave gets half weight on each side.
template <typename T, bool PLUS>
__device__ __forceinline__ T wside(T speed) {
  T w_minus = T(0.5) * (T(1) - sgn(speed));
  return PLUS ? w_minus : T(1) - w_minus;
}

template <bool PLUS, typename T>
__device__ __forceinline__ const T (&edge(const Waves<T>& w))[3] {
  if constexpr (PLUS) return w.im;
  else return w.ip;
}
template <bool PLUS, typename T>
__device__ __forceinline__ T edge(const Wave1<T>& w) {
  if constexpr (PLUS) return w.im;
  else return w.ip;
}

// The traced hydro state of the cell toward its left edge (PLUS) or right
// edge; `q` is the cell's own state.
template <typename T, int D, bool PLUS>
__device__ __forceinline__ void edge_state(const CellWaves<T>& w, const T* q, T un, T cc,
                                           const TraceConst<T>& k, T* out) {
  constexpr int QUN = QU + D, QUT = QU + (D + 1) % 3, QUTT = QU + (D + 2) % 3;
  const T hdt = k.hdt;
  const T(&I_rho)[3] = edge<PLUS>(w.rho);
  const T(&I_un)[3] = edge<PLUS>(w.un);
  const T(&I_p)[3] = edge<PLUS>(w.p);
  const T(&I_re)[3] = edge<PLUS>(w.re);
  const T(&I_gc)[3] = edge<PLUS>(w.gc);
  const T(&S_rho)[3] = edge<PLUS>(w.s_rho);
  const T(&S_un)[3] = edge<PLUS>(w.s_un);
  const T(&S_p)[3] = edge<PLUS>(w.s_p);
  const T(&S_re)[3] = edge<PLUS>(w.s_re);

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
  for (int c = 0; c < QFS; ++c) out[c] = q[c];
  out[QRHO] = vmax(k.small_dens, rho_ref + alphap + alpham + alpha0r);
  out[QUN] = un_ref + (alphap - alpham) * cc_ref * rho_ref_inv;
  out[QREINT] = vmax(k.small_rhoe, rhoe_ref + (alphap + alpham) * h_ref + alpha0e);
  out[QPRES] = vmax(k.small_pres, p_ref + (alphap + alpham) * csq_ref);
  out[QUT] = edge<PLUS>(w.ut) + hdt * edge<PLUS>(w.s_ut);
  out[QUTT] = edge<PLUS>(w.utt) + hdt * edge<PLUS>(w.s_utt);
}

// Both traced hydro states of one cell: toward its left edge (qp) and its
// right edge (qm), from one reconstruction of each component. q, qaux,
// flatn and src point to the cell; o5 are its stencil's offsets along D.
// The passives ride the contact only: passive_waves traces them one by one.
template <typename T, int D, bool SRC>
__device__ __forceinline__ void trace_cell(const T* q, const T* qaux, const T* flatn,
                                           const T* src, long long S, const int (&o5)[5],
                                           const TraceConst<T>& k, T* qp, T* qm) {
  constexpr int QUN = QU + D, QUT = QU + (D + 1) % 3, QUTT = QU + (D + 2) % 3;
  T fl = *flatn;
  T un = q[QUN * S];
  T cc = qaux[QC * S];
  T dtdx = k.dtdx;

  CellWaves<T> w;
  w.rho = waves(q + QRHO * S, o5, fl, un, cc, dtdx);
  w.un = waves(q + QUN * S, o5, fl, un, cc, dtdx);
  w.p = waves(q + QPRES * S, o5, fl, un, cc, dtdx);
  w.re = waves(q + QREINT * S, o5, fl, un, cc, dtdx);
  w.gc = waves(qaux + QGAMC * S, o5, fl, un, cc, dtdx);
  w.ut = wave1(q + QUT * S, o5, fl, un, dtdx);
  w.utt = wave1(q + QUTT * S, o5, fl, un, dtdx);
  if constexpr (SRC) {
    w.s_rho = waves(src + QRHO * S, o5, fl, un, cc, dtdx);
    w.s_un = waves(src + QUN * S, o5, fl, un, cc, dtdx);
    w.s_p = waves(src + QPRES * S, o5, fl, un, cc, dtdx);
    w.s_re = waves(src + QREINT * S, o5, fl, un, cc, dtdx);
    w.s_ut = wave1(src + QUT * S, o5, fl, un, dtdx);
    w.s_utt = wave1(src + QUTT * S, o5, fl, un, dtdx);
  } else {
    Waves<T> z3 = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
    Wave1<T> z1 = {T(0), T(0)};
    w.s_rho = w.s_un = w.s_p = w.s_re = z3;
    w.s_ut = w.s_utt = z1;
  }
  T qc[QFS];
#pragma unroll
  for (int c = 0; c < QFS; ++c) qc[c] = q[c * S];
  edge_state<T, D, true>(w, qc, un, cc, k, qp);
  edge_state<T, D, false>(w, qc, un, cc, k, qm);
}

// Passive j of the cell at linear index i (stencil offsets o5 along D):
// its integrals toward the left edge (im, qp of face i) and the right edge
// (ip, qm of face i + 1), with the cell's flattening and normal velocity.
template <typename T, int D>
__device__ __forceinline__ Wave1<T> passive_wave(const T* q, const T* flatn, long long S,
                                                 long long i, const int (&o5)[5], int j,
                                                 T dtdx) {
  return wave1(q + (QFS + j) * S + i, o5, flatn[i], q[(QU + D) * S + i], dtdx);
}

// the stencil offsets along D of the cell at position c0 (stride sd)
__device__ __forceinline__ void stencil5(int c0, int n, int sd, int (&o5)[5]) {
#pragma unroll
  for (int j = 0; j < 5; ++j) o5[j] = (clampi(c0 + j - 2, n) - c0) * sd;
}

// The block: 8 z columns of 32 cells along D = 0, 1; 32 cells along z
// by 8 rows of y for D = 2.
template <int D>
using TraceTile = FaceTile<D, 0, D == 2 ? 32 : 8, D == 2 ? 8 : 32>;

template <typename T, int D, bool SRC, bool FUSE, bool HYDRO>
__global__ void __launch_bounds__(TraceTile<D>::THREADS) trace_ppm_kernel(
    const T* __restrict__ q, const T* __restrict__ qaux, const T* __restrict__ flatn,
    const T* __restrict__ src, T* __restrict__ qm_out, T* __restrict__ qp_out,
    T* __restrict__ flux, T* __restrict__ qe, Grid g, Layout lay, TraceConst<T> k, int solver,
    int mask_lo, int mask_hi) {
  using Tile = TraceTile<D>;
  // the right-edge hydro state, gamc and c of each cell, and in the
  // pure-hydro build its passive, for the face above it (any other build
  // traces each passive after the solve: the passive held across it
  // spills)
  __shared__ T xs[FUSE ? QFS + 2 + HYDRO : 1][Tile::THREADS];
  const Layout L = kernel_layout<HYDRO>(lay);
  const Tile tl(g);
  const long long S = g.S;
  const long long ix = tl.ix();
  const int n = g.n[D], sd = (int)tl.sd;
  // whether this thread writes qm of face p + 1 (this tile's)
  const bool up = tl.in && tl.r < Tile::OWN && tl.p + 1 < n;
  const long long iu = tl.at(g, tl.p + 1);
  int o5[5];
  stencil5(tl.x.c[D], n, sd, o5);
  T qp[QFS], qm[QFS];
  Wave1<T> w0{T(0), T(0)};  // the pure-hydro build's passive: its two integrals
  if (tl.in) {
    trace_cell<T, D, SRC>(q + ix, qaux + ix, flatn + ix, SRC ? src + ix : src, S, o5, k, qp,
                          qm);
    if (HYDRO) w0 = passive_wave<T, D>(q, flatn, S, ix, o5, 0, k.dtdx);
    if (tl.owns()) {
#pragma unroll
      for (int c = 0; c < QFS; ++c) qp_out[c * S + ix] = qp[c];
    }
    if (up) {
#pragma unroll
      for (int c = 0; c < QFS; ++c) qm_out[c * S + iu] = qm[c];
    }
  }
  Upwind<T> w{T(0), T(0), T(0)};
  if constexpr (FUSE) {
    if (tl.in) {
#pragma unroll
      for (int c = 0; c < QFS; ++c) xs[c][tl.slot] = qm[c];
      xs[QFS][tl.slot] = qaux[QGAMC * S + ix];
      xs[QFS + 1][tl.slot] = qaux[QC * S + ix];
      if (HYDRO) xs[QFS + 2][tl.slot] = w0.ip;
    }
    __syncthreads();
    if (tl.owns()) {
      const int b = tl.slot - Tile::STEP;  // the cell below
      T ql[QFS];
#pragma unroll
      for (int c = 0; c < QFS; ++c) ql[c] = xs[c][b];
      T mask = (tl.p == mask_lo || tl.p == mask_hi) ? T(0) : T(1);
      T f[NUH], e[NGDNV];
      w = riemann_hydro(ql, qp, xs[QFS][b], qaux[QGAMC * S + ix], xs[QFS + 1][b],
                        qaux[QC * S + ix], Axis<D>(), solver, mask, k.small_dens,
                        k.small_pres, f, e);
#pragma unroll
      for (int c = 0; c < NUH; ++c) flux[c * S + ix] = f[c];
#pragma unroll
      for (int c = 0; c < NGDNV; ++c) qe[c * S + ix] = e[c];
      for (int c = NUH; c < L.ufs; ++c) flux[c * S + ix] = T(0);
    }
  }
  if (!tl.in) return;
  // the passives, one at a time; a face's left state is the cell below's
  // right-edge integral: the pure-hydro build's from shared memory, any
  // other traced again here (the same operations as the cell's owner)
  const long long ib = tl.at(g, tl.p - 1);
  int o5b[5];
  stencil5(clampi(tl.p - 1, n), n, sd, o5b);
  for (int j = 0; j < L.npass; ++j) {
    Wave1<T> wo = HYDRO ? w0 : passive_wave<T, D>(q, flatn, S, ix, o5, j, k.dtdx);
    if (tl.owns()) qp_out[(QFS + j) * S + ix] = wo.im;
    if (up) qm_out[(QFS + j) * S + iu] = wo.ip;
    if (FUSE && tl.owns()) {
      T left = HYDRO ? xs[QFS + 2][tl.slot - Tile::STEP]
                     : passive_wave<T, D>(q, flatn, S, ib, o5b, j, k.dtdx).ip;
      flux[(L.ufs + j) * S + ix] = upwind(w, left, wo.im);
    }
  }
}

// The kernel's arrays, as the launcher receives them.
template <typename T>
struct TraceArrays {
  const T* q;
  const T* qaux;
  const T* flatn;
  const T* src;
  T* qm;
  T* qp;
  T* flux;
  T* qe;
};

template <typename T, int D, bool SRC, bool FUSE>
int launch_variant(const TraceArrays<T>& a, const Grid& g, const Layout& L,
                   const TraceConst<T>& k, int solver, int mask_lo, int mask_hi,
                   cudaStream_t stream) {
  using Tile = TraceTile<D>;
  auto kernel = is_hydro(L) ? trace_ppm_kernel<T, D, SRC, FUSE, true>
                            : trace_ppm_kernel<T, D, SRC, FUSE, false>;
  kernel<<<Tile::blocks(g), Tile::threads(), 0, stream>>>(
      a.q, a.qaux, a.flatn, a.src, a.qm, a.qp, a.flux, a.qe, g, L, k, solver, mask_lo,
      mask_hi);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dir(const TraceArrays<T>& a, const Grid& g, const Layout& L,
               const TraceConst<T>& k, int solver, int mask_lo, int mask_hi,
               cudaStream_t stream) {
  if (a.src != nullptr)
    return a.flux != nullptr
               ? launch_variant<T, D, true, true>(a, g, L, k, solver, mask_lo, mask_hi, stream)
               : launch_variant<T, D, true, false>(a, g, L, k, solver, mask_lo, mask_hi,
                                                   stream);
  return a.flux != nullptr
             ? launch_variant<T, D, false, true>(a, g, L, k, solver, mask_lo, mask_hi, stream)
             : launch_variant<T, D, false, false>(a, g, L, k, solver, mask_lo, mask_hi,
                                                  stream);
}

template <typename T>
int launch_trace_ppm(const void* q, const void* qaux, const void* flatn, const void* src,
                     void* qm, void* qp, void* flux, void* qe, const int* n, const int* lay,
                     int d, const double* consts, int solver, int mask_lo, int mask_hi,
                     cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  TraceConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3]), T(consts[4])};
  TraceArrays<T> a{(const T*)q, (const T*)qaux, (const T*)flatn, (const T*)src,
                   (T*)qm,      (T*)qp,         (T*)flux,        (T*)qe};
  Layout L = layout_of(lay);
  if (!layout_ok(L)) return (int)cudaErrorInvalidValue;
  if (d == 0) return launch_dir<T, 0>(a, g, L, k, solver, mask_lo, mask_hi, stream);
  if (d == 1) return launch_dir<T, 1>(a, g, L, k, solver, mask_lo, mask_hi, stream);
  if (d == 2) return launch_dir<T, 2>(a, g, L, k, solver, mask_lo, mask_hi, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ctt

#define TRACE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* q, const void* qaux, const void* flatn,             \
                      const void* src, void* qm, void* qp, void* flux, void* qe,      \
                      const int* n, const int* lay, int d, const double* consts,      \
                      int solver, int mask_lo, int mask_hi, void* stream) {           \
    return ctt::launch_trace_ppm<T>(q, qaux, flatn, src, qm, qp, flux, qe, n, lay,    \
                                    d, consts, solver, mask_lo, mask_hi,              \
                                    (cudaStream_t)stream);                            \
  }
TRACE_ENTRY(ctt_trace_ppm_f32, float)
TRACE_ENTRY(ctt_trace_ppm_f64, double)
