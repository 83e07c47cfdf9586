// Shared helpers of the castro_tpu_torch CUDA kernels: the state layout
// of the kernel path, grid indexing with the edge clamp of
// ops/stencil.py:shifted, sign(), block reductions, and the gamma-law EOS.
//
// Every kernel is templated on the working type T (float or double). The
// hydro components are compile-time constants; the passively advected
// components (species + aux) and the extra conserved components (the
// shock flag, the hybrid momenta) come from a Layout, and every kernel
// handles the passives one at a time in a loop, so that one build serves
// any number of them and no register array grows with them. The kernels
// whose loops cost time at one passive are built twice: for the
// pure-hydro layout of every hydro-only problem (HYDRO, its offsets and
// counts compile-time constants, so the loops unroll to one iteration),
// and for any layout read at run time.
// Constants are converted to T where they are written (T(0.5)), so float
// code never does double arithmetic; the small_* floors arrive from the
// host already rounded to T, as the JAX package's weakly typed constants
// are.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace ctt {

// Conserved, primitive, auxiliary and Godunov-state indices of the kernel
// path (castro_tpu_torch/state.py without MHD or radiation; the wrappers
// check the layout, and the pointwise kernels take a radiation layout's
// QFS and NGDNV from a QLayout, below). The NUH hydro components of the
// conserved state come first in every layout; the primitive layout does
// not change with the shock flag or hybrid momenta, so without radiation
// its passives always start at QFS.
enum { URHO = 0, UMX = 1, UMY = 2, UMZ = 3, UEDEN = 4, UEINT = 5, UTEMP = 6, NUH = 7 };
enum { QRHO = 0, QU = 1, QV = 2, QW = 3, QGAME = 4, QPRES = 5, QREINT = 6, QTEMP = 7, QFS = 8 };
enum { QGAMC = 0, QC = 1, QDPDR = 2, QDPDE = 3, NQAUX = 4 };
enum { GDRHO = 0, GDU = 1, GDV = 2, GDW = 3, GDPRES = 4, GDGAME = 5, NGDNV = 6 };
// the first passive of the pure-hydro layout, to which the profiling
// probes (prof_cmpflx.cu) stay fixed
enum { UFS_HYDRO = 7 };

// The conserved layout past the hydro components (state.py): the extras
// [NUH, ufs) are the shock flag (at ushk, or none when ushk < 0) and the
// hybrid momenta; they carry no Riemann flux. The passives [ufs, ufs +
// npass) are nspec species, then the aux components.
struct Layout {
  int ufs, nspec, npass, ushk;
  __host__ __device__ int nvar() const { return ufs + npass; }
};

inline Layout layout_of(const int* lay) { return Layout{lay[0], lay[1], lay[2], lay[3]}; }
// the pure-hydro layout: one species, no extras
inline bool is_hydro(const Layout& L) {
  return L.ufs == NUH && L.nspec == 1 && L.npass == 1 && L.ushk < 0;
}
// the layout a kernel built for HYDRO (or not) works with
template <bool HYDRO>
__device__ __forceinline__ Layout kernel_layout(const Layout& L) {
  if constexpr (HYDRO) return Layout{NUH, 1, 1, -1};
  return L;
}
inline bool layout_ok(const Layout& L) {
  return L.ufs >= NUH && L.ufs <= NUH + 4 && L.nspec >= 1 && L.npass >= L.nspec &&
         (L.ushk < 0 || (L.ushk >= NUH && L.ushk < L.ufs));
}

// The primitive and Godunov layouts of the pointwise kernels (cmpflx,
// trans_apply, trans_cmpflx), the two entries past the Layout's in the
// layout array: the first passive of q (QFS, or past the radiation
// components QPTOT, QREITOT and each group's Er on a radiation layout),
// and the Godunov components of a face (NGDNV, or 6 + 2 ngroups with
// each group's flux limiter and Er, which these kernels write as zeros,
// as the operator-split step's plain version does). The other kernels
// take the hydro layout's QFS and NGDNV, and the wrappers keep radiation
// layouts from them.
struct QLayout {
  int qfs, ngdnv;
};
inline QLayout q_layout_of(const int* lay) { return QLayout{lay[4], lay[5]}; }
inline bool q_layout_ok(const QLayout& Q) { return Q.qfs >= QFS && Q.ngdnv >= NGDNV; }
// Whether a layout carries radiation components. The pointwise kernels are
// built twice, RAD false for the other layouts (QFS and NGDNV the
// compile-time constants, the build of the layouts without radiation as it
// was) and RAD true for the radiation layout.
inline bool q_layout_rad(const QLayout& Q) { return Q.qfs != QFS || Q.ngdnv != NGDNV; }
// The first passive of q: QFS, or a radiation layout's (RAD).
template <bool RAD>
__device__ __forceinline__ int q_passives(const QLayout& Q) {
  if constexpr (RAD) return Q.qfs;
  return QFS;
}
// The Godunov components past the hydro ones (a radiation layout's flux
// limiters and Er), zero at t; none without RAD.
template <bool RAD, typename T>
__device__ __forceinline__ void zero_godunov_extras(const QLayout& Q, T* qe, long long S,
                                                    long long t) {
  if constexpr (RAD)
    for (int c = NGDNV; c < Q.ngdnv; ++c) qe[c * S + t] = T(0);
}

// BC codes (AMReX phys_bc)
enum { BC_INTERIOR = 0, BC_INFLOW = 1, BC_OUTFLOW = 2, BC_SYMMETRY = 3,
       BC_SLIPWALL = 4, BC_NOSLIPWALL = 5 };

// Grown grid extents; arrays are component-major [NC, n0, n1, n2] with the
// last axis contiguous, and S = n0*n1*n2 is the component stride.
struct Grid {
  int n[3];
  long long S;
  __device__ __forceinline__ long long stride(int a) const {
    return a == 0 ? (long long)n[1] * n[2] : (a == 1 ? (long long)n[2] : 1LL);
  }
  __device__ __forceinline__ long long idx(int i, int j, int k) const {
    return ((long long)i * n[1] + j) * n[2] + k;
  }
};

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// An axis fixed at compile time. It converts to its int, so one device
// function takes either a runtime axis (an int) or a fixed one (Axis<A>);
// with Axis<A> every index it forms into a thread's arrays is a constant,
// and the arrays stay in registers.
template <int A>
struct Axis {
  static constexpr int value = A;
  __host__ __device__ constexpr operator int() const { return A; }
};

// A cell's position and its edge-clamped neighbours along one axis (an
// int, or Axis<A>).
struct Cell {
  int c[3];
  template <typename Dir>
  __device__ __forceinline__ Cell shift(const Grid& g, Dir a, int off) const {
    Cell o = *this;
    o.c[a] = clampi(c[a] + off, g.n[a]);
    return o;
  }
  __device__ __forceinline__ long long at(const Grid& g) const {
    return g.idx(c[0], c[1], c[2]);
  }
};

__device__ __forceinline__ Cell cell_of(const Grid& g, long long t) {
  Cell c;
  c.c[2] = (int)(t % g.n[2]);
  long long r = t / g.n[2];
  c.c[1] = (int)(r % g.n[1]);
  c.c[0] = (int)(r / g.n[1]);
  return c;
}

// Component c of the cell that `a` points at, where components lie S
// elements apart (S < 2^31; the product is taken in 64 bits).
template <typename P>
__device__ __forceinline__ P& comp(P* a, int c, int S) {
  return a[(long long)c * S];
}

// Element `off` of a, for an offset known to be non-negative: as unsigned
// it is zero-extended to 64 bits, in fewer instructions than a signed
// int's sign extension.
template <typename P>
__device__ __forceinline__ P& at(P* a, int off) {
  return a[(unsigned)off];
}

// jnp.sign: 0 at 0, so a stationary wave gets half weight on each side
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}
// max/min that propagate NaN from either side, as torch.maximum/clamp and
// jnp.maximum do (fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) { return vmin(vmax(x, lo), hi); }
// IEEE sqrt and |x| of the working type; tiny() is finfo(T).tiny
__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ double vabs(double x) { return fabs(x); }
template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

// Gamma-law EOS constants (castro_tpu_torch/eos/gamma_law.py): 1/mu =
// sum_s xn_s * num_s / A_s; cv = k_B/m_u / (mu (gamma-1)). The per-species
// numbers lie in device memory as num_s/A_s (nspec values) and 1/A_s
// (nspec values), read at a run-time index, so that nothing goes to a
// stack and the species loop holds no division (whose slow path is a
// call); each term is one rounding from the plain version's x num / A.
template <typename T>
struct EosGL {
  T gamma, gm1, kb_over_mu;
  int neutral;
  const T* num_over_a;
  const T* inv_a;

  // cv from the nspec mass fractions xn(s), summed in species order
  template <typename F>
  __device__ __forceinline__ T cv(int nspec, const F& xn) const {
    const T* w = neutral ? inv_a : num_over_a;
    T inv_mu = xn(0) * w[0];
    for (int s = 1; s < nspec; ++s) inv_mu = inv_mu + xn(s) * w[s];
    T mu = T(1) / inv_mu;
    return kb_over_mu / (mu * gm1);
  }
};

template <typename T>
EosGL<T> make_eos(double gamma, double kb_over_mu, int nspec, int neutral, const void* coef) {
  EosGL<T> e;
  e.gamma = T(gamma);
  e.gm1 = T(gamma - 1.0);
  e.kb_over_mu = T(kb_over_mu);
  e.neutral = neutral;
  e.num_over_a = (const T*)coef;
  e.inv_a = (const T*)coef + nspec;
  return e;
}

// Block-wide reductions over a block of at most 1024 threads in one or two
// dimensions (blockDim.x * blockDim.y a multiple of 32, every thread
// taking part); the result is valid in thread (0, 0).
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op) {
  __shared__ T part[32];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  int t = threadIdx.y * blockDim.x + threadIdx.x;  // warps are cut in this order
  int lane = t & 31, w = t >> 5;
  __syncthreads();  // part[] may still be read by a previous reduction
  if (lane == 0) part[w] = v;
  __syncthreads();
  int nw = (blockDim.x * blockDim.y + 31) >> 5;
  if (w == 0) {
    v = lane < nw ? part[lane] : part[0];
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

struct MaxOp { template <typename T> __device__ T operator()(T a, T b) const { return vmax(a, b); } };
struct MinOp { template <typename T> __device__ T operator()(T a, T b) const { return vmin(a, b); } };
struct SumOp { template <typename T> __device__ T operator()(T a, T b) const { return a + b; } };

// Order-preserving atomics on the bit pattern of a float or double.
__device__ __forceinline__ void atomic_max_nonneg(float* a, float v) {
  atomicMax((int*)a, __float_as_int(v));
}
__device__ __forceinline__ void atomic_max_nonneg(double* a, double v) {
  atomicMax((long long*)a, __double_as_longlong(v));
}
__device__ __forceinline__ void atomic_min(float* a, float v) {
  if (v >= 0.0f) atomicMin((int*)a, __float_as_int(v));
  else atomicMax((unsigned int*)a, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min(double* a, double v) {
  if (v >= 0.0) atomicMin((long long*)a, __double_as_longlong(v));
  else atomicMax((unsigned long long*)a, (unsigned long long)__double_as_longlong(v));
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace ctt
