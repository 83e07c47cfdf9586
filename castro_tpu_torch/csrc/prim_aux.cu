// prim_aux: conserved -> primitive with the gamma-law EOS in-kernel, the
// node-centred velocity divergence, and the whole-grid Courant maximum.
//
// Replaces castro_tpu/ops/pallas_kernels.py:prim_aux_pallas (:770, calls
// at :926 and :933). Same arithmetic as castro_tpu_torch/ops/kernels.py:
// prim_aux_plain (ctoprim + divu_node + max_courant).
//
// Bound: bytes. It reads six of u's NVAR components once (density,
// momenta, internal energy, species) and writes q[NQ], qaux[4] and div:
// 20 components a cell at NPASS=1, against some 60 flops a cell.
// Design: a 2.5D tile. A block of BZ x BY threads owns a (y, z) tile of
// (BY-1) x BZ columns and marches along x over CH planes, the loads of the
// next plane in flight while it works on the current one. Its first row is
// the halo at j-1, which converts velocities only; lane 0 of every row
// also converts the velocity of the cell at k0-1. Each warp's row starts
// where a 32-cell row of the grid starts, so its stores fill whole 32-byte
// sectors: with a halo lane inside the row, they were cut at both ends,
// and the kernel ran as slowly as the one-thread-a-cell version it
// replaced. Each cell is converted once (the expressions of that version,
// in the same order), and div u takes one velocity and three differences
// a cell: the difference along x from the velocity the thread kept from
// the plane below, those along y and z from the plane's velocities in
// shared memory, each shared by the four nodes around its face. The node
// averages read the y and z differences of planes i and i-1 from two
// shared buffers. Positions come from blockIdx and threadIdx in 32-bit
// arithmetic; clamped neighbours replicate the grid's edge cell
// (ops/stencil.py:shifted), so a difference across the low edge is 0.
// The Courant maximum, which the TPU carried across sequential grid steps
// (:873-879), is a running maximum over the thread's column, one block
// reduction and one atomicMax on the float's bit pattern (the Courant
// number is non-negative).
#include <limits.h>

#include "common.cuh"

namespace ctt {

constexpr int PA_BZ = 32;  // threadIdx.x, along z
constexpr int PA_BY = 8;   // threadIdx.y, along y: row 0 is the j-1 halo
constexpr int PA_CH = 16;  // planes along x a block marches over

template <typename T, bool HYDRO>
__global__ void __launch_bounds__(PA_BZ * PA_BY) prim_aux_kernel(
    const T* __restrict__ u, T* __restrict__ q, T* __restrict__ qaux,
    T* __restrict__ div, T* __restrict__ courant, Grid g, Layout lay, EosGL<T> eos,
    T small_dens, T e_floor, T dx0, T dx1, T dx2, T dtdx0, T dtdx1, T dtdx2) {
  // velocities of the plane, and the differences along x (d0), y (d1) and
  // z (d2) of planes i and i-1 (buffer i & 1); column tz + 1 is lane tz's
  // cell, column 0 the cell at k0-1, which lane 0 converts as well
  __shared__ T sv1[PA_BY][PA_BZ + 1], sv2[PA_BY][PA_BZ + 1];
  __shared__ T sd0[2][PA_BY][PA_BZ + 1], sd1[2][PA_BY][PA_BZ + 1], sd2[2][PA_BY][PA_BZ + 1];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
  const int k0 = blockIdx.x * PA_BZ;
  const int k = k0 + tz;
  const int j = blockIdx.y * (PA_BY - 1) + ty - 1;  // -1: the halo below the grid
  const int i0 = blockIdx.z * PA_CH;
  const int i1 = min(i0 + PA_CH, n0);
  const bool owner = ty > 0 && k < n2 && j < n1;
  const bool left = tz == 0 && div != nullptr;
  const int S = (int)g.S;  // the launcher checks S < 2^31
  const int plane = n1 * n2;
  const int col = clampi(j, n1) * n2 + clampi(k, n2);
  const int colh = clampi(j, n1) * n2 + clampi(k0 - 1, n2);
  T cou = T(0), v0prev = T(0), h0prev = T(0);
  // the loads of the next plane are issued before the current plane's
  // work, so that their latency hides behind it: density, momenta,
  // internal energy and, in the pure-hydro build, the passive for an
  // owner; density and momenta for the halo row, the first plane (which
  // only need velocities) and lane 0's cell at k0-1 (total energy and
  // temperature are not read). Any other build reads the passives one at
  // a time where they are converted (a register more spills its float
  // build).
  const Layout L = kernel_layout<HYDRO>(lay);
  const int first = div != nullptr ? i0 - 1 : i0;  // with div u, one plane below (clamped)
  T nx[NUH + 1] = {}, nh[4] = {};  // nx[NUH]: the passive of the pure-hydro build
  auto fetch = [&](int i) {
    const int oi = (i < 0 ? 0 : i) * plane;
    const T* a = &at(u, oi + col);
#pragma unroll
    for (int c = URHO; c <= UMZ; ++c) nx[c] = comp(a, c, S);
    if (owner && i >= i0) {
      nx[UEINT] = comp(a, UEINT, S);
      if (HYDRO) nx[NUH] = comp(a, L.ufs, S);
    }
    if (left) {
#pragma unroll
      for (int c = URHO; c <= UMZ; ++c) nh[c] = comp(&at(u, oi + colh), c, S);
    }
  };
  fetch(first);
  for (int i = first; i < i1; ++i) {
    const int o = (i < 0 ? 0 : i) * plane + col;
    const bool out = owner && i >= i0;
    T r[NUH + 1], rh[4];
#pragma unroll
    for (int c = 0; c <= NUH; ++c) r[c] = nx[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) rh[c] = nh[c];
    if (i + 1 < i1) fetch(i + 1);
    T rho = vmax(r[URHO], small_dens);
    T rhoinv = T(1) / rho;
    T vel[3];
    for (int d = 0; d < 3; ++d) vel[d] = r[UMX + d] * rhoinv;
    if (out) {
      T e = vmax(r[UEINT], e_floor * rho) * rhoinv;
      const T* a = &at(u, o);
      auto xn = [&](int s) {
        return (HYDRO && s == 0 ? r[NUH] : comp(a, L.ufs + s, S)) * rhoinv;
      };
      // gamma-law re(): T = e/cv, then the state is filled from (rho, T)
      T cv = eos.cv(L.nspec, xn);
      T temp = e / cv;
      T e2 = cv * temp;
      T p = rho * e2 * eos.gm1;
      T cs = vsqrt(eos.gamma * p / rho);

      T* w = &at(q, o);
      comp(w, QRHO, S) = rho;
      for (int d = 0; d < 3; ++d) comp(w, QU + d, S) = vel[d];
      comp(w, QGAME, S) = p / (rho * e) + T(1);
      comp(w, QPRES, S) = p;
      comp(w, QREINT, S) = rho * e;
      comp(w, QTEMP, S) = temp;
      for (int s = 0; s < L.npass; ++s) comp(w, QFS + s, S) = xn(s);
      w = &at(qaux, o);
      comp(w, QGAMC, S) = eos.gamma;
      comp(w, QC, S) = cs;
      comp(w, QDPDR, S) = e2 * eos.gm1;
      comp(w, QDPDE, S) = rho * eos.gm1;
      if (courant != nullptr) {
        T dtdx[3] = {dtdx0, dtdx1, dtdx2};
        for (int d = 0; d < 3; ++d) cou = vmax(cou, (vabs(vel[d]) + cs) * dtdx[d]);
      }
    }
    if (div != nullptr) {  // uniform across the block: every thread reaches the barriers
      const int b = i & 1, c = b ^ 1;
      // the difference along x, from the velocity kept from the plane below
      // (in the first plane, unused)
      T d0 = (vel[0] - (i < i0 ? vel[0] : v0prev)) / dx0;
      v0prev = vel[0];
      sv1[ty][tz + 1] = vel[1];
      sv2[ty][tz + 1] = vel[2];
      sd0[b][ty][tz + 1] = d0;
      if (left) {  // the same for the cell at k0-1
        T ri = T(1) / vmax(rh[URHO], small_dens);
        T vh[3];
        for (int d = 0; d < 3; ++d) vh[d] = rh[UMX + d] * ri;
        sd0[b][ty][0] = (vh[0] - (i < i0 ? vh[0] : h0prev)) / dx0;
        h0prev = vh[0];
        sv1[ty][0] = vh[1];
        sv2[ty][0] = vh[2];
      }
      __syncthreads();
      if (ty > 0) {
        sd1[b][ty][tz + 1] = (vel[1] - sv1[ty - 1][tz + 1]) / dx1;
        if (left) sd1[b][ty][0] = (sv1[ty][0] - sv1[ty - 1][0]) / dx1;
      }
      sd2[b][ty][tz + 1] = (vel[2] - sv2[ty][tz]) / dx2;
      __syncthreads();
      if (out) {
        // per direction, the difference averaged over the {0,-1} shifts of
        // the other two axes in ascending order (ops/advection_util.py:
        // divu_node)
        T c0 = T(0.5) * (T(0.5) * (sd0[b][ty][tz + 1] + sd0[b][ty - 1][tz + 1]) +
                         T(0.5) * (sd0[b][ty][tz] + sd0[b][ty - 1][tz]));
        T c1 = T(0.5) * (T(0.5) * (sd1[b][ty][tz + 1] + sd1[c][ty][tz + 1]) +
                         T(0.5) * (sd1[b][ty][tz] + sd1[c][ty][tz]));
        T c2 = T(0.5) * (T(0.5) * (sd2[b][ty][tz + 1] + sd2[c][ty][tz + 1]) +
                         T(0.5) * (sd2[b][ty - 1][tz + 1] + sd2[c][ty - 1][tz + 1]));
        at(div, o) = c0 + c1 + c2;
      }
    }
  }
  if (courant != nullptr) {
    T m = block_reduce(cou, MaxOp());
    if (tz == 0 && ty == 0) atomic_max_nonneg(courant, m);
  }
}

template <typename T>
int launch_prim_aux(const void* u, void* q, void* qaux, void* div, void* courant,
           const int* n, const int* lay, const double* eos_d, int neutral,
           const void* coef, double small_dens,
           double e_floor, const double* dx, const double* dtdx,
           cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  if (!layout_ok(L) || g.S > INT_MAX) return (int)cudaErrorInvalidValue;
  EosGL<T> eos = make_eos<T>(eos_d[0], eos_d[1], L.nspec, neutral, coef);
  auto up = [](int a, int b) { return (unsigned)((a + b - 1) / b); };
  dim3 blocks(up(n[2], PA_BZ), up(n[1], PA_BY - 1), up(n[0], PA_CH));
  auto kernel = is_hydro(L) ? prim_aux_kernel<T, true> : prim_aux_kernel<T, false>;
  kernel<<<blocks, dim3(PA_BZ, PA_BY), 0, stream>>>(
      (const T*)u, (T*)q, (T*)qaux, (T*)div, (T*)courant, g, L, eos, T(small_dens),
      T(e_floor), T(dx[0]), T(dx[1]), T(dx[2]), T(dtdx[0]), T(dtdx[1]), T(dtdx[2]));
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define PRIM_AUX_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* u, void* q, void* qaux, void* div, void* courant,  \
                      const int* n, const int* lay, const double* eos, int neutral,  \
                      const void* coef, double small_dens, double e_floor,           \
                      const double* dx, const double* dtdx, void* stream) {          \
    return ctt::launch_prim_aux<T>(u, q, qaux, div, courant, n, lay, eos, neutral, coef,      \
                                   small_dens, e_floor, dx, dtdx, (cudaStream_t)stream);     \
  }
PRIM_AUX_ENTRY(ctt_prim_aux_f32, float)
PRIM_AUX_ENTRY(ctt_prim_aux_f64, double)
