// prim_aux: conserved -> primitive with the gamma-law EOS in-kernel, the
// node-centred velocity divergence, and the whole-grid Courant maximum.
//
// Replaces castro_tpu/ops/pallas_kernels.py:prim_aux_pallas (:770, calls
// at :926 and :933). Same arithmetic as castro_tpu_torch/ops/kernels.py:
// prim_aux_plain (ctoprim + divu_node + max_courant).
//
// Bound: bytes. It reads u[NVAR] once and writes q[NQ], qaux[4] and div,
// 22 components a cell at NPASS=1, against some 60 flops a cell.
// Design: one thread per cell. div u needs the velocities of the 2x2x2
// cube of cells below the node; a thread recomputes them from u through
// L1/L2 instead of the TPU's pre-shifted y copy (:806-807). The Courant
// maximum, which the TPU carried across sequential grid steps (:873-879),
// is a block reduction plus one atomicMax on the float's bit pattern (the
// Courant number is non-negative).
#include "common.cuh"

namespace ctt {

template <typename T, int NPASS>
__global__ void __launch_bounds__(256) prim_aux_kernel(
    const T* __restrict__ u, T* __restrict__ q, T* __restrict__ qaux,
    T* __restrict__ div, T* __restrict__ courant, Grid g, EosGL<T> eos,
    T small_dens, T e_floor, T dx0, T dx1, T dx2, T dtdx0, T dtdx1, T dtdx2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = t < g.S;
  T cou = T(0);
  if (live) {
    const long long S = g.S;
    T rho = vmax(u[URHO * S + t], small_dens);
    T rhoinv = T(1) / rho;
    T vel[3];
    for (int d = 0; d < 3; ++d) vel[d] = u[(UMX + d) * S + t] * rhoinv;
    T e = vmax(u[UEINT * S + t], e_floor * rho) * rhoinv;
    T xn[NPASS];
#pragma unroll
    for (int k = 0; k < NPASS; ++k) xn[k] = u[(UFS + k) * S + t] * rhoinv;
    // gamma-law re(): T = e/cv, then the state is filled from (rho, T)
    T cv = eos.cv(xn);
    T temp = e / cv;
    T e2 = cv * temp;
    T p = rho * e2 * eos.gm1;
    T cs = vsqrt(eos.gamma * p / rho);

    q[QRHO * S + t] = rho;
    for (int d = 0; d < 3; ++d) q[(QU + d) * S + t] = vel[d];
    q[QGAME * S + t] = p / (rho * e) + T(1);
    q[QPRES * S + t] = p;
    q[QREINT * S + t] = rho * e;
    q[QTEMP * S + t] = temp;
#pragma unroll
    for (int k = 0; k < NPASS; ++k) q[(QFS + k) * S + t] = xn[k];
    qaux[QGAMC * S + t] = eos.gamma;
    qaux[QC * S + t] = cs;
    qaux[QDPDR * S + t] = e2 * eos.gm1;
    qaux[QDPDE * S + t] = rho * eos.gm1;

    if (div != nullptr) {
      // velocities on the cube {i-1,i} x {j-1,j} x {k-1,k} (edge-clamped);
      // index [a][b][c] = offset (-a, -b, -c)
      Cell here = cell_of(g, t);
      T v[3][2][2][2];
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          for (int cc = 0; cc < 2; ++cc) {
            long long ic = g.idx(clampi(here.c[0] - a, g.n[0]), clampi(here.c[1] - b, g.n[1]),
                                 clampi(here.c[2] - cc, g.n[2]));
            T ri = T(1) / vmax(u[URHO * S + ic], small_dens);
            for (int d = 0; d < 3; ++d) v[d][a][b][cc] = u[(UMX + d) * S + ic] * ri;
          }
      // per direction: the difference along d, then the average over the
      // {0,-1} shifts of the other two axes in ascending order
      T A0[2][2], A1[2][2], A2[2][2];
      for (int x = 0; x < 2; ++x)
        for (int y = 0; y < 2; ++y) {
          A0[x][y] = (v[0][0][x][y] - v[0][1][x][y]) / dx0;  // [b][c]
          A1[x][y] = (v[1][x][0][y] - v[1][x][1][y]) / dx1;  // [a][c]
          A2[x][y] = (v[2][x][y][0] - v[2][x][y][1]) / dx2;  // [a][b]
        }
      T c0 = T(0.5) * (T(0.5) * (A0[0][0] + A0[1][0]) + T(0.5) * (A0[0][1] + A0[1][1]));
      T c1 = T(0.5) * (T(0.5) * (A1[0][0] + A1[1][0]) + T(0.5) * (A1[0][1] + A1[1][1]));
      T c2 = T(0.5) * (T(0.5) * (A2[0][0] + A2[1][0]) + T(0.5) * (A2[0][1] + A2[1][1]));
      div[t] = c0 + c1 + c2;
    }
    if (courant != nullptr) {
      T dtdx[3] = {dtdx0, dtdx1, dtdx2};
      for (int d = 0; d < 3; ++d) cou = vmax(cou, (vabs(vel[d]) + cs) * dtdx[d]);
    }
  }
  if (courant != nullptr) {
    T m = block_reduce(cou, MaxOp());
    if (threadIdx.x == 0) atomic_max_nonneg(courant, m);
  }
}

template <typename T>
int launch_prim_aux(const void* u, void* q, void* qaux, void* div, void* courant,
           const int* n, int npass, const double* eos_d, int nspec, int neutral,
           const double* num, const double* aion, double small_dens,
           double e_floor, const double* dx, const double* dtdx,
           cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  EosGL<T> eos = make_eos<T>(eos_d[0], eos_d[1], nspec, neutral, num, aion);
  const int threads = 256;
  int blocks = blocks_for(g.S, threads);
  if (npass != 1) return (int)cudaErrorInvalidValue;
  prim_aux_kernel<T, 1><<<blocks, threads, 0, stream>>>(
      (const T*)u, (T*)q, (T*)qaux, (T*)div, (T*)courant, g, eos, T(small_dens),
      T(e_floor), T(dx[0]), T(dx[1]), T(dx[2]), T(dtdx[0]), T(dtdx[1]), T(dtdx[2]));
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define PRIM_AUX_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* u, void* q, void* qaux, void* div, void* courant,  \
                      const int* n, int npass, const double* eos, int nspec,         \
                      int neutral, const double* num, const double* aion,            \
                      double small_dens, double e_floor, const double* dx,           \
                      const double* dtdx, void* stream) {                            \
    return ctt::launch_prim_aux<T>(u, q, qaux, div, courant, n, npass, eos, nspec, neutral,   \
                          num, aion, small_dens, e_floor, dx, dtdx,                  \
                          (cudaStream_t)stream);                                     \
  }
PRIM_AUX_ENTRY(ctt_prim_aux_f32, float)
PRIM_AUX_ENTRY(ctt_prim_aux_f64, double)
