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
// at NPASS=1. Design: one thread per output cell. The fill composed axis by
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

template <typename T, int NPASS>
__global__ void __launch_bounds__(256) clean_fill_kernel(
    const T* __restrict__ u, T* __restrict__ out, T* __restrict__ min_rho,
    T* __restrict__ total, Grid g, Bcs bc, EosGL<T> eos, CleanConst<T> k) {
  constexpr int NVAR = UFS + NPASS;
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
    long long is = g.idx(src[0], src[1], src[2]);
    T r[NVAR];
#pragma unroll
    for (int c = 0; c < NVAR; ++c) r[c] = u[c * S + is];

    bool interior = true;
    for (int a = 0; a < 3; ++a)
      interior = interior && x.c[a] >= bc.ng && x.c[a] < g.n[a] - bc.ng;
    if (min_rho != nullptr && interior) {  // interior cells are their own source
      mrho = r[URHO];
      tot = r[0];
#pragma unroll
      for (int c = 1; c < NVAR; ++c) tot = tot + r[c];
    }

    // clean_state (driver/clean.py), pointwise
    T rho0 = r[URHO];
    bool bad = rho0 < k.small_dens;
    T rho = bad ? k.small_dens : rho0;
    T mom[3];
    for (int m = 0; m < 3; ++m) mom[m] = bad ? T(0) : r[UMX + m];
    const int nspec = eos.nspec;
    T xn[NPASS], rx[NPASS], xn2[NPASS];
#pragma unroll
    for (int s = 0; s < NPASS; ++s) xn[s] = bad ? k.inv_nspec : r[UFS + s] / (bad ? rho0 : rho);
    T e_floor = eos.cv(xn) * k.small_temp;
    T ueint = bad ? rho * e_floor : r[UEINT];
    T ueden = bad ? rho * e_floor : r[UEDEN];
    if (k.normalize) {
      T ssum = T(0);
#pragma unroll
      for (int s = 0; s < NPASS; ++s) {
        rx[s] = vmin(vmax(xn[s] * rho, k.small_x * rho), rho);
        ssum = s == 0 ? rx[s] : ssum + rx[s];
      }
#pragma unroll
      for (int s = 0; s < NPASS; ++s) {
        rx[s] = rx[s] * (rho / ssum);
        xn2[s] = rx[s] / rho;
      }
    } else {
#pragma unroll
      for (int s = 0; s < NPASS; ++s) {
        rx[s] = xn[s] * rho;
        xn2[s] = xn[s];
      }
    }
    T ke = T(0.5) * (mom[0] * mom[0] + mom[1] * mom[1] + mom[2] * mom[2]) / rho;
    T rho_eint = ueden - ke;
    T eint = (rho_eint > T(0) && rho_eint / vmax(ueden, k.tiny300) > k.eta2) ? rho_eint : ueint;
    T cv2 = eos.cv(xn2);
    if (eint <= T(0)) {
      eint = rho * (cv2 * k.small_temp);
      ueden = eint + ke;
    }
    T temp = vmax(eint / rho / cv2, k.small_temp);

    T o[NVAR];
    o[URHO] = rho;
    for (int m = 0; m < 3; ++m) o[UMX + m] = mom[m] * sign[m];
    o[UEDEN] = ueden;
    o[UEINT] = eint;
    o[UTEMP] = temp;
#pragma unroll
    for (int s = 0; s < NPASS; ++s) o[UFS + s] = s < nspec ? rx[s] : r[UFS + s];
#pragma unroll
    for (int c = 0; c < NVAR; ++c) out[c * S + t] = o[c];
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
                      int npass, const int* lo, const int* hi, int ng, const double* eos_d,
                      int nspec, int neutral, const double* num, const double* aion,
                      const double* consts, int normalize, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  if (npass != 1 || nspec != npass) return (int)cudaErrorInvalidValue;
  Bcs bc{{lo[0], lo[1], lo[2]}, {hi[0], hi[1], hi[2]}, ng};
  EosGL<T> eos = make_eos<T>(eos_d[0], eos_d[1], nspec, neutral, num, aion);
  CleanConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3]), T(consts[4]),
                  T(consts[5]), normalize};
  const int threads = 256;
  clean_fill_kernel<T, 1><<<blocks_for(g.S, threads), threads, 0, stream>>>(
      (const T*)u, (T*)out, (T*)min_rho, (T*)total, g, bc, eos, k);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define CLEAN_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* u, void* out, void* min_rho, void* total,            \
                      const int* n, int npass, const int* lo, const int* hi, int ng,    \
                      const double* eos, int nspec, int neutral, const double* num,     \
                      const double* aion, const double* consts, int normalize,          \
                      void* stream) {                                                   \
    return ctt::launch_clean_fill<T>(u, out, min_rho, total, n, npass, lo, hi, ng, eos, \
                                     nspec, neutral, num, aion, consts, normalize,      \
                                     (cudaStream_t)stream);                             \
  }
CLEAN_ENTRY(ctt_clean_fill_f32, float)
CLEAN_ENTRY(ctt_clean_fill_f64, double)
