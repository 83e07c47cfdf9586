// clean_fill: the clean_state ladder (reference Castro.cpp:4238) and the
// physical ghost fill in x, y, z order (Castro_bc_fill_nd.cpp: periodic
// wrap, outflow clamp, wall mirror with momentum sign flips), with the
// optional status of the pre-clean state: interior min rho and the
// finiteness of the interior sum.
//
// Replaces castro_tpu/ops/pallas_kernels.py:clean_fill_pallas (:1019, calls
// at :1220 and :1231). Same arithmetic as castro_tpu_torch/ops/kernels.py:
// clean_fill_plain (driver/clean.py:clean_state + ops/fill.py:fill_ghosts).
//
// Bound: bytes. It reads u[NVAR] and writes u[NVAR], 16 components a cell
// at NPASS=1. Design: one thread per output cell, the species read one at a
// time (again for each sum that needs them: cv, the normalization, cv of
// the normalized fractions) from the source cell, through L1. The fill composed axis by
// axis maps every cell to one source cell (its own for the interior) and a
// sign per momentum, so the thread cleans its source cell's raw state and
// applies the signs; no wrap slabs or first/last-block cases (:1047-1051,
// :1153-1203). The status reductions are a block reduction plus one atomic
// min and one atomic add each; only the sum's finiteness is read.
#include "common.cuh"

namespace ctt {

template <typename T>
struct CleanConst {
  T small_dens, small_temp, eta2, tiny300, small_x, inv_nspec;
  int normalize;
};

struct Bcs {
  int lo[3], hi[3], ng;
};

// source index along one axis and the wall side it mirrors (-1 none, 0 lo,
// 1 hi), matching ops/fill.py:axis_fill_index
__device__ __forceinline__ int fill_source(int i, int N, int ng, int lo, int hi,
                                           int* wall_side) {
  int n = N - 2 * ng;
  *wall_side = -1;
  if (i < ng) {
    if (lo == BC_INTERIOR) return i + n;
    if (lo == BC_OUTFLOW || lo == BC_INFLOW) return ng;
    *wall_side = 0;
    return 2 * ng - 1 - i;
  }
  if (i >= n + ng) {
    if (hi == BC_INTERIOR) return i - n;
    if (hi == BC_OUTFLOW || hi == BC_INFLOW) return n + ng - 1;
    *wall_side = 1;
    return 2 * (n + ng) - 1 - i;
  }
  return i;
}

// The species of a cell's clean, read one at a time from its source cell
// (xs[s * S]): the mass fractions after the density floor, and their
// clipped partial densities. The divisions by the cell's density are
// multiplications by its reciprocal, so that the species loops hold no
// division (one rounding from the plain version).
template <typename T>
struct Species {
  const T* xs;
  long long S;
  T inv_den, rho, inv_nspec, small_x;
  bool bad;
  __device__ __forceinline__ T xn(int s) const { return bad ? inv_nspec : xs[s * S] * inv_den; }
  __device__ __forceinline__ T rx(int s) const {
    return vmin(vmax(xn(s) * rho, small_x * rho), rho);
  }
};

// The mass fractions as EosGL::cv reads them.
template <typename T>
struct SpeciesXn {
  Species<T> sp;
  __device__ __forceinline__ T operator()(int s) const { return sp.xn(s); }
};

// The normalized partial densities (scaled by rho / their sum) and mass
// fractions, or the unnormalized ones.
template <typename T>
struct Normalized {
  Species<T> sp;
  T scale, inv_rho;
  bool on;
  __device__ __forceinline__ T rxn(int s) const {
    return on ? sp.rx(s) * scale : sp.xn(s) * sp.rho;
  }
  __device__ __forceinline__ T operator()(int s) const { return on ? rxn(s) * inv_rho : sp.xn(s); }
};

template <typename T, bool HYDRO>
__global__ void __launch_bounds__(256) clean_fill_kernel(
    const T* __restrict__ u, T* __restrict__ out, T* __restrict__ min_rho,
    T* __restrict__ total, Grid g, Layout lay, Bcs bc, EosGL<T> eos, CleanConst<T> k) {
  const Layout L = kernel_layout<HYDRO>(lay);
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = t < g.S;
  T mrho = T(INFINITY), tot = T(0);
  if (live) {
    const long long S = g.S;
    Cell x = cell_of(g, t);
    int src[3];
    T sign[3] = {T(1), T(1), T(1)};  // per momentum component UMX+m
    for (int a = 0; a < 3; ++a) {
      int side;
      src[a] = fill_source(x.c[a], g.n[a], bc.ng, bc.lo[a], bc.hi[a], &side);
      if (side >= 0) {
        int code = side == 0 ? bc.lo[a] : bc.hi[a];
        for (int m = 0; m < 3; ++m)
          if (m == a || code == BC_NOSLIPWALL) sign[m] = -sign[m];
      }
    }
    const long long is = g.idx(src[0], src[1], src[2]);
    const T* us = u + is;  // the source cell; its component c at us[c * S]
    T r[NUH];
#pragma unroll
    for (int c = 0; c < NUH; ++c) r[c] = us[c * S];

    bool interior = true;
    for (int a = 0; a < 3; ++a)
      interior = interior && x.c[a] >= bc.ng && x.c[a] < g.n[a] - bc.ng;
    if (min_rho != nullptr && interior) {  // interior cells are their own source
      mrho = r[URHO];
      tot = r[0];
#pragma unroll
      for (int c = 1; c < NUH; ++c) tot = tot + r[c];
      for (int c = NUH; c < L.nvar(); ++c) tot = tot + us[c * S];
    }

    // clean_state (driver/clean.py), pointwise; the species one at a time
    T rho0 = r[URHO];
    bool bad = rho0 < k.small_dens;
    T rho = bad ? k.small_dens : rho0;
    T mom[3];
    for (int m = 0; m < 3; ++m) mom[m] = bad ? T(0) : r[UMX + m];
    const Species<T> sp{us + (long long)L.ufs * S, S, T(1) / (bad ? rho0 : rho), rho,
                        k.inv_nspec, k.small_x, bad};
    T e_floor = eos.cv(L.nspec, SpeciesXn<T>{sp}) * k.small_temp;
    T ueint = bad ? rho * e_floor : r[UEINT];
    T ueden = bad ? rho * e_floor : r[UEDEN];
    T ssum = T(0);
    if (k.normalize) {
      for (int s = 0; s < L.nspec; ++s) ssum = s == 0 ? sp.rx(s) : ssum + sp.rx(s);
    }
    const Normalized<T> nz{sp, rho / ssum, T(1) / rho, k.normalize != 0};
    T ke = T(0.5) * (mom[0] * mom[0] + mom[1] * mom[1] + mom[2] * mom[2]) / rho;
    T rho_eint = ueden - ke;
    T eint = (rho_eint > T(0) && rho_eint / vmax(ueden, k.tiny300) > k.eta2) ? rho_eint : ueint;
    T cv2 = eos.cv(L.nspec, nz);
    if (eint <= T(0)) {
      eint = rho * (cv2 * k.small_temp);
      ueden = eint + ke;
    }
    T temp = vmax(eint / rho / cv2, k.small_temp);

    T o[NUH];
    o[URHO] = rho;
    for (int m = 0; m < 3; ++m) o[UMX + m] = mom[m] * sign[m];
    o[UEDEN] = ueden;
    o[UEINT] = eint;
    o[UTEMP] = temp;
#pragma unroll
    for (int c = 0; c < NUH; ++c) out[c * S + t] = o[c];
    for (int c = NUH; c < L.ufs; ++c) out[c * S + t] = us[c * S];
    for (int s = 0; s < L.npass; ++s)
      out[(L.ufs + s) * S + t] = s < L.nspec ? nz.rxn(s) : sp.xs[s * S];
  }
  if (min_rho != nullptr) {
    T m = block_reduce(mrho, MinOp());
    T s = block_reduce(tot, SumOp());
    if (threadIdx.x == 0) {
      atomic_min(min_rho, m);
      atomicAdd(total, s);
    }
  }
}

template <typename T>
int launch_clean_fill(const void* u, void* out, void* min_rho, void* total, const int* n,
                      const int* lay, const int* lo, const int* hi, int ng, const double* eos_d,
                      int neutral, const void* coef, const double* consts, int normalize,
                      cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  if (!layout_ok(L)) return (int)cudaErrorInvalidValue;
  Bcs bc{{lo[0], lo[1], lo[2]}, {hi[0], hi[1], hi[2]}, ng};
  EosGL<T> eos = make_eos<T>(eos_d[0], eos_d[1], L.nspec, neutral, coef);
  CleanConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3]), T(consts[4]),
                  T(consts[5]), normalize};
  const int threads = 256;
  auto kernel = is_hydro(L) ? clean_fill_kernel<T, true> : clean_fill_kernel<T, false>;
  kernel<<<blocks_for(g.S, threads), threads, 0, stream>>>(
      (const T*)u, (T*)out, (T*)min_rho, (T*)total, g, L, bc, eos, k);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define CLEAN_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* u, void* out, void* min_rho, void* total,            \
                      const int* n, const int* lay, const int* lo, const int* hi,       \
                      int ng, const double* eos, int neutral, const void* coef,         \
                      const double* consts, int normalize, void* stream) {              \
    return ctt::launch_clean_fill<T>(u, out, min_rho, total, n, lay, lo, hi, ng, eos,   \
                                     neutral, coef, consts, normalize,                  \
                                     (cudaStream_t)stream);                             \
  }
CLEAN_ENTRY(ctt_clean_fill_f32, float)
CLEAN_ENTRY(ctt_clean_fill_f64, double)
