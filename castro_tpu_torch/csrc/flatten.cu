// flatten: Miller-Colella flattening coefficient (reference flatten.cpp:
// 13-167), all three directions and their minimum in one launch.
//
// Replaces castro_tpu/ops/pallas_kernels.py:flatten_pallas (:953, call at
// :999). Same arithmetic as castro_tpu_torch/ops/flatten.py:uflatten.
//
// Bound: bytes. It reads p, u, v, w and writes flatn, 5 components a cell;
// they fit in L2 at 136^3, so what a thread issues counts. Design: a 2.5D
// tile. A block of BZ x BY threads owns a (y, z) tile, one thread a
// column, and marches along x over CH planes. Each cell's zeta-chi is
// computed once a direction: along x from a register queue of the column's
// p (planes i-1 .. i+3) and u (i .. i+2), keeping the zeta-chi of planes
// i-1, i and i+1; along y and z from the plane's p (halo 3), v (halo 2
// along y) and w (halo 2 along z) in shared memory, for the tile and one
// halo cell on each side, which the upwind neighbour needs. The loads of
// the next plane are in flight while a block works on the current one.
// The TPU's split into three pencil kernels plus an XLA min was a VMEM
// artifact. What the kernel issues sets its pace: where p is uniform
// (most of a Sedov grid) zeta's denominator is the floor, whose IEEE
// division takes the slow path, so zchi() returns its +0 there without
// dividing (0.063 -> 0.037 ms at 136^3 on an H100). Chunks of 8 planes
// ran faster than 16 or 32 at 136^3, and one barrier a plane (a
// pipelined march) or more blocks an SM no faster
// (castro_tpu_torch/scripts/prof_cells.py).
//
// Edges (ops/stencil.py:shifted clamps positions): the shared frames and
// the queue hold p and velocities at clamped positions, and a zeta-chi is
// always evaluated at a clamped position, so the upwind neighbour beyond
// the grid's edge is the edge cell's own zeta-chi (sh(zchi, +-1)), never
// one computed from replicated values. Threads past the grid's edge load
// their clamped slots but compute nothing; every thread reaches every
// barrier. Positions are 32-bit, from blockIdx and threadIdx.
#include <limits.h>

#include "common.cuh"

namespace ctt {

constexpr int FL_BZ = 32;  // threadIdx.x, along z
constexpr int FL_BY = 8;   // threadIdx.y, along y
constexpr int FL_CH = 8;   // planes along x a block marches over
static_assert(FL_BY >= 6 && 2 * FL_BY <= FL_BZ, "the halo loads and zeta-chi need these");

template <typename T>
struct FlatConst {
  T small, shktst, zcut1, dzcut;
};

// zeta-chi of one direction from the cell's edge-clamped stencil along it:
// p at -2, -1, +1, +2 and the velocity at -1, +1; dp = p(+1) - p(-1)
template <typename T>
__device__ __forceinline__ T zchi(T pm2, T pm1, T pp1, T pp2, T vm1, T vp1,
                                  const FlatConst<T>& k, T& dp) {
  dp = pp1 - pm1;
  T denom = vmax(k.small, vabs(pp2 - pm2));
  // where p is uniform (dp = 0, denom the floor) zeta is +0, so z and the
  // result are +0 whatever chi is: the branch skips the IEEE division's
  // slow path, which a denominator as small as the floor takes
  if (dp == T(0) && denom == k.small) return T(0);
  T zeta = vabs(dp) / denom;
  T z = clip(k.dzcut * (zeta - k.zcut1), T(0), T(1));
  T tst = (vm1 - vp1 >= T(0)) ? T(1) : T(0);
  T tmp = vmin(pp1, pm1);
  T chi = (vabs(dp) > k.shktst * tmp) ? tst : T(0);
  return chi * z;
}

template <typename T>
__global__ void __launch_bounds__(FL_BZ * FL_BY) flatten_kernel(
    const T* __restrict__ q, T* __restrict__ flatn, Grid g, int qpres, int qu,
    FlatConst<T> k) {
  // the plane's p (halo 3 along y and z; the corners are not read), v
  // (halo 2 along y) and w (halo 2 along z); zeta-chi along y and z with
  // one halo cell on each side
  __shared__ T sp[FL_BY + 6][FL_BZ + 6];
  __shared__ T sv[FL_BY + 4][FL_BZ];
  __shared__ T sw[FL_BY][FL_BZ + 4];
  __shared__ T szy[FL_BY + 2][FL_BZ];
  __shared__ T szz[FL_BY][FL_BZ + 2];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
  const int k0 = blockIdx.x * FL_BZ, j0 = blockIdx.y * FL_BY;
  const int kk = k0 + tz, jj = j0 + ty;
  const bool live = kk < n2 && jj < n1;
  const int i0 = blockIdx.z * FL_CH, i1 = min(i0 + FL_CH, n0);
  const int S = (int)g.S;  // the launcher checks S < 2^31
  const int plane = n1 * n2;
  const T* p = &comp(q, qpres, S);
  const T* vx = &comp(q, qu, S);
  const T* vy = &comp(q, qu + 1, S);
  const T* vz = &comp(q, qu + 2, S);
  // offsets in the plane of the thread's column and of the halo cells it
  // loads: p's rows (ty < 6) and columns (tz < 6), v's rows (ty < 4), w's
  // columns (tz < 4)
  const int col = clampi(jj, n1) * n2 + clampi(kk, n2);
  const int hpr = ty < 3 ? ty : FL_BY + ty, hpc = tz < 3 ? tz : FL_BZ + tz;
  const int hvr = ty < 2 ? ty : FL_BY + ty, hwc = tz < 2 ? tz : FL_BZ + tz;
  const int opr = clampi(j0 - 3 + hpr, n1) * n2 + clampi(kk, n2);
  const int opc = clampi(jj, n1) * n2 + clampi(k0 - 3 + hpc, n2);
  const int ovr = clampi(j0 - 2 + hvr, n1) * n2 + clampi(kk, n2);
  const int owc = clampi(jj, n1) * n2 + clampi(k0 - 2 + hwc, n2);
  // the frame row (ty < 2) or column (ty == 2) of p of the halo zeta-chi
  // this thread computes, its position clamped: rows j0-1 and j0+BY,
  // columns k0-1 and k0+BZ (v's and w's frames start one cell later)
  const int hr = ty < 2 ? clampi(ty == 0 ? j0 - 1 : j0 + FL_BY, n1) - j0 + 3
                        : clampi(tz < FL_BY ? k0 - 1 : k0 + FL_BZ, n2) - k0 + 3;

  // the queue along x: p at planes i0-2 .. i0+2 and u at i0-1 .. i0+1, the
  // zeta-chi of planes i0-1 (clamped) and i0
  T pw[5], uw[3];
#pragma unroll
  for (int m = 0; m < 5; ++m) pw[m] = at(p, clampi(i0 - 2 + m, n0) * plane + col);
#pragma unroll
  for (int m = 0; m < 3; ++m) uw[m] = at(vx, clampi(i0 - 1 + m, n0) * plane + col);
  T dpx, dpx_next, zx_prev, zx_cur, zx_next;
  zx_next = zchi(pw[0], pw[1], pw[3], pw[4], uw[0], uw[2], k, dpx_next);
  if (i0 == 0) {
    zx_cur = zx_next;
  } else {
    T pm3 = at(p, clampi(i0 - 3, n0) * plane + col), um2 = at(vx, clampi(i0 - 2, n0) * plane + col);
    zx_cur = zchi(pm3, pw[0], pw[2], pw[3], um2, uw[1], k, dpx);
  }

  // the loads of the next plane, issued before the current plane's work so
  // that their latency hides behind it: p at i+3 and u at i+2 for the
  // queue, v and w at i, and the halo cells at i this thread loads
  T np, nu, nv, nw, nhpr = T(0), nhpc = T(0), nhvr = T(0), nhwc = T(0);
  auto fetch = [&](int i) {
    const int off = i * plane;
    np = at(p, clampi(i + 3, n0) * plane + col);
    nu = at(vx, clampi(i + 2, n0) * plane + col);
    nv = at(vy, off + col);
    nw = at(vz, off + col);
    if (ty < 6) nhpr = at(p, off + opr);
    if (tz < 6) nhpc = at(p, off + opc);
    if (ty < 4) nhvr = at(vy, off + ovr);
    if (tz < 4) nhwc = at(vz, off + owc);
  };
  fetch(i0);
  for (int i = i0; i < i1; ++i) {
    const int off = i * plane;
    zx_prev = zx_cur;
    zx_cur = zx_next;
    dpx = dpx_next;
#pragma unroll
    for (int m = 0; m < 4; ++m) pw[m] = pw[m + 1];
    pw[4] = np;
    uw[0] = uw[1];
    uw[1] = uw[2];
    uw[2] = nu;
    sp[ty + 3][tz + 3] = pw[1];
    sv[ty + 2][tz] = nv;
    sw[ty][tz + 2] = nw;
    if (ty < 6) sp[hpr][tz + 3] = nhpr;
    if (tz < 6) sp[ty + 3][hpc] = nhpc;
    if (ty < 4) sv[hvr][tz] = nhvr;
    if (tz < 4) sw[ty][hwc] = nhwc;
    if (i + 1 < i1) fetch(i + 1);
    // zeta-chi at plane i+1, or the edge plane's own beyond the grid
    if (live && i + 1 < n0)
      zx_next = zchi(pw[0], pw[1], pw[3], pw[4], uw[0], uw[2], k, dpx_next);
    else
      zx_next = zx_cur;
    __syncthreads();

    T dpy, dpz, zy, zz, dump;
    if (live) {
      zy = zchi(sp[ty + 1][tz + 3], sp[ty + 2][tz + 3], sp[ty + 4][tz + 3], sp[ty + 5][tz + 3],
                sv[ty + 1][tz], sv[ty + 3][tz], k, dpy);
      zz = zchi(sp[ty + 3][tz + 1], sp[ty + 3][tz + 2], sp[ty + 3][tz + 4], sp[ty + 3][tz + 5],
                sw[ty][tz + 1], sw[ty][tz + 3], k, dpz);
      szy[ty + 1][tz] = zy;
      szz[ty][tz + 1] = zz;
    }
    if (ty < 2) {  // the halo rows j0-1 and j0+BY
      szy[ty == 0 ? 0 : FL_BY + 1][tz] =
          zchi(sp[hr - 2][tz + 3], sp[hr - 1][tz + 3], sp[hr + 1][tz + 3], sp[hr + 2][tz + 3],
               sv[hr - 2][tz], sv[hr][tz], k, dump);
    } else if (ty == 2 && tz < 2 * FL_BY) {  // the halo columns k0-1 and k0+BZ
      const int r = tz < FL_BY ? tz : tz - FL_BY;
      szz[r][tz < FL_BY ? 0 : FL_BZ + 1] =
          zchi(sp[r + 3][hr - 2], sp[r + 3][hr - 1], sp[r + 3][hr + 1], sp[r + 3][hr + 2],
               sw[r][hr - 2], sw[r][hr], k, dump);
    }
    __syncthreads();

    if (live) {
      // the minimum over directions 0, 1, 2 of 1 - max(zeta-chi, its upwind
      // neighbour's), the neighbour's position clamped
      T f = T(1);
      f = vmin(f, T(1) - vmax(zx_cur, dpx > T(0) ? zx_prev : zx_next));
      const int jn = dpy > T(0) ? max(jj - 1, 0) : min(jj + 1, n1 - 1);
      f = vmin(f, T(1) - vmax(zy, szy[jn - j0 + 1][tz]));
      const int kn = dpz > T(0) ? max(kk - 1, 0) : min(kk + 1, n2 - 1);
      f = vmin(f, T(1) - vmax(zz, szz[ty][kn - k0 + 1]));
      at(flatn, off + col) = f;
    }
  }
}

template <typename T>
int launch_flatten(const void* q, void* flatn, const int* n, int qpres, int qu,
                   const double* consts, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  if (g.S > INT_MAX) return (int)cudaErrorInvalidValue;
  FlatConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3])};
  auto up = [](int a, int b) { return (unsigned)((a + b - 1) / b); };
  dim3 blocks(up(n[2], FL_BZ), up(n[1], FL_BY), up(n[0], FL_CH));
  flatten_kernel<T><<<blocks, dim3(FL_BZ, FL_BY), 0, stream>>>(
      (const T*)q, (T*)flatn, g, qpres, qu, k);
  return (int)cudaGetLastError();
}

}  // namespace ctt

extern "C" int ctt_flatten_f32(const void* q, void* flatn, const int* n, int qpres,
                               int qu, const double* consts, void* stream) {
  return ctt::launch_flatten<float>(q, flatn, n, qpres, qu, consts, (cudaStream_t)stream);
}
extern "C" int ctt_flatten_f64(const void* q, void* flatn, const int* n, int qpres,
                               int qu, const double* consts, void* stream) {
  return ctt::launch_flatten<double>(q, flatn, n, qpres, qu, consts, (cudaStream_t)stream);
}
