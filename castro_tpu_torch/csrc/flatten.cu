// flatten: Miller-Colella flattening coefficient (reference flatten.cpp:
// 13-167), all three directions and their minimum in one launch.
//
// Replaces castro_tpu/ops/pallas_kernels.py:flatten_pallas (:953, call at
// :999). Same arithmetic as castro_tpu_torch/ops/flatten.py:uflatten.
//
// Bound: bytes. It reads p, u, v, w and writes flatn, 5 components a
// cell. Design: one thread per cell; the +-2 stencil of each direction is
// read straight from global memory through L1/L2, and the coefficient of
// the upwind neighbour is recomputed from its own clamped stencil. The
// TPU's split into three pencil kernels plus an XLA min was a VMEM
// artifact.
#include "common.cuh"

namespace ctt {

template <typename T>
struct FlatConst {
  T small, shktst, zcut1, dzcut;
};

// zeta-chi of direction d at cell x (edge-clamped stencil)
template <typename T>
__device__ __forceinline__ T zchi_at(const T* p, const T* vel, const Grid& g,
                                     const Cell& x, int d, const FlatConst<T>& k,
                                     T* dp_out) {
  T pp1 = p[x.shift(g, d, 1).at(g)], pm1 = p[x.shift(g, d, -1).at(g)];
  T pp2 = p[x.shift(g, d, 2).at(g)], pm2 = p[x.shift(g, d, -2).at(g)];
  T vp1 = vel[x.shift(g, d, 1).at(g)], vm1 = vel[x.shift(g, d, -1).at(g)];
  T dp = pp1 - pm1;
  T denom = vmax(k.small, vabs(pp2 - pm2));
  T zeta = vabs(dp) / denom;
  T z = clip(k.dzcut * (zeta - k.zcut1), T(0), T(1));
  T tst = (vm1 - vp1 >= T(0)) ? T(1) : T(0);
  T tmp = vmin(pp1, pm1);
  T chi = (vabs(dp) > k.shktst * tmp) ? tst : T(0);
  if (dp_out) *dp_out = dp;
  return chi * z;
}

template <typename T>
__global__ void __launch_bounds__(256) flatten_kernel(
    const T* __restrict__ q, T* __restrict__ flatn, Grid g, int qpres, int qu,
    FlatConst<T> k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.S) return;
  Cell x = cell_of(g, t);
  const T* p = q + (long long)qpres * g.S;
  T f = T(1);
  for (int d = 0; d < 3; ++d) {
    const T* vel = q + (long long)(qu + d) * g.S;
    T dp;
    T zc = zchi_at(p, vel, g, x, d, k, &dp);
    T z2 = dp > T(0) ? zchi_at(p, vel, g, x.shift(g, d, -1), d, k, (T*)nullptr)
                     : zchi_at(p, vel, g, x.shift(g, d, 1), d, k, (T*)nullptr);
    f = vmin(f, T(1) - vmax(zc, z2));
  }
  flatn[t] = f;
}

template <typename T>
int launch_flatten(const void* q, void* flatn, const int* n, int qpres, int qu,
                   const double* consts, cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  FlatConst<T> k{T(consts[0]), T(consts[1]), T(consts[2]), T(consts[3])};
  const int threads = 256;
  flatten_kernel<T><<<blocks_for(g.S, threads), threads, 0, stream>>>(
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
