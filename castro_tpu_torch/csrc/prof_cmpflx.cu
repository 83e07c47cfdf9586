// The two probes of the Riemann-block profile: probe_cmpflx, the pointwise
// Riemann solve and flux of direction 0 (riemannus, the face states of a
// 3D grid, no wall faces) with the cells of a block given as a tile, and
// probe_copy, the roofline probe with the same inputs and outputs,
// flux = qm[:NVAR] + qp[:NVAR] and qe = 2 qm[:NGDNV].
//
// Replace scripts/prof_cmpflx.py:make_cmpflx (pallas_call at :47), which
// times _riemann_block (castro_tpu/ops/pallas_kernels.py:64) at six VMEM
// tilings, and make_copy (pallas_call at :70). Same arithmetic as
// castro_tpu_torch/ops/probes.py:probe_cmpflx_plain (riemann.cuh, the body
// of cmpflx.cu) and probe_copy_plain.
//
// Bound: bytes. probe_cmpflx reads qm, qp [NQ] and four scalars and writes
// flux [NVAR] and qe [6] a face (36 components at NPASS=1) against ~170
// operations; probe_copy moves 30 components (it reads 8 of qm's and 8 of
// qp's 9) and does 22 operations.
// Design: the TPU tile (tx, ty) over (x, y), whole along z, becomes the
// cells of one thread block: a block takes the tile (tx, ty, n2) and deals
// its cells, numbered x-major, to its threads in turn, so that neighbouring
// threads take neighbouring z and every access is coalesced. ty = n1 gives
// the TPU's row tilings. The tile and the thread count are arguments, so
// one build times every tiling; one thread a cell is tile (1, T/n2).
#include "common.cuh"
#include "riemann.cuh"

namespace ctt {

struct Tile {
  int tx, ty;
  __device__ __forceinline__ bool cell(const Grid& g, long long c, long long* t) const {
    int tiles_y = (g.n[1] + ty - 1) / ty;
    int bi = blockIdx.x / tiles_y, bj = blockIdx.x % tiles_y;
    int k = (int)(c % g.n[2]);
    long long r = c / g.n[2];
    int j = bj * ty + (int)(r % ty);
    int i = bi * tx + (int)(r / ty);
    if (i >= g.n[0] || j >= g.n[1]) return false;
    *t = g.idx(i, j, k);
    return true;
  }
  __device__ __forceinline__ long long cells(const Grid& g) const {
    return (long long)tx * ty * g.n[2];
  }
};

template <typename T, int NPASS>
__global__ void probe_cmpflx_kernel(const T* __restrict__ qm, const T* __restrict__ qp,
                                    const T* __restrict__ gl, const T* __restrict__ gr,
                                    const T* __restrict__ cl, const T* __restrict__ cr,
                                    T* __restrict__ flux, T* __restrict__ qe, Grid g, Tile tile,
                                    int coord, T small_dens, T small_pres) {
  constexpr int NQ = QFS + NPASS, NVAR = UFS_HYDRO + NPASS;
  const long long S = g.S;
  for (long long c = threadIdx.x; c < tile.cells(g); c += blockDim.x) {
    long long t;
    if (!tile.cell(g, c, &t)) continue;
    T qmv[NQ], qpv[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      qmv[q] = qm[q * S + t];
      qpv[q] = qp[q * S + t];
    }
    T fl[NVAR], qg[NGDNV];
    riemann_flux<T, NPASS>(qmv, qpv, gl[t], gr[t], cl[t], cr[t], 0, 0, T(1), small_dens,
                           small_pres, fl, qg, coord == 0);
#pragma unroll
    for (int q = 0; q < NVAR; ++q) flux[q * S + t] = fl[q];
#pragma unroll
    for (int q = 0; q < NGDNV; ++q) qe[q * S + t] = qg[q];
  }
}

template <typename T, int NPASS>
__global__ void probe_copy_kernel(const T* __restrict__ qm, const T* __restrict__ qp,
                                  T* __restrict__ flux, T* __restrict__ qe, Grid g, Tile tile) {
  constexpr int NVAR = UFS_HYDRO + NPASS;
  const long long S = g.S;
  for (long long c = threadIdx.x; c < tile.cells(g); c += blockDim.x) {
    long long t;
    if (!tile.cell(g, c, &t)) continue;
#pragma unroll
    for (int q = 0; q < NVAR; ++q) {
      T a = qm[q * S + t];
      flux[q * S + t] = a + qp[q * S + t];
      if (q < NGDNV) qe[q * S + t] = a * T(2);
    }
  }
}

inline bool launch_shape(const int* n, int npass, int tx, int ty, int threads, Grid* g,
                         Tile* tile, int* blocks) {
  *g = Grid{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  if (npass != 1 || tx < 1 || ty < 1 || threads < 32 || threads > 1024 || threads % 32)
    return false;
  *tile = Tile{tx, ty};
  *blocks = ((n[0] + tx - 1) / tx) * ((n[1] + ty - 1) / ty);
  return true;
}

template <typename T>
int launch_probe_cmpflx(const void* qm, const void* qp, const void* gl, const void* gr,
                        const void* cl, const void* cr, void* flux, void* qe, const int* n,
                        int npass, int tx, int ty, int threads, int coord, double small_dens,
                        double small_pres, cudaStream_t stream) {
  Grid g;
  Tile tile;
  int blocks;
  if (!launch_shape(n, npass, tx, ty, threads, &g, &tile, &blocks) || coord < 0 || coord > 2)
    return (int)cudaErrorInvalidValue;
  probe_cmpflx_kernel<T, 1><<<blocks, threads, 0, stream>>>(
      (const T*)qm, (const T*)qp, (const T*)gl, (const T*)gr, (const T*)cl, (const T*)cr,
      (T*)flux, (T*)qe, g, tile, coord, T(small_dens), T(small_pres));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_probe_copy(const void* qm, const void* qp, void* flux, void* qe, const int* n,
                      int npass, int tx, int ty, int threads, cudaStream_t stream) {
  Grid g;
  Tile tile;
  int blocks;
  if (!launch_shape(n, npass, tx, ty, threads, &g, &tile, &blocks))
    return (int)cudaErrorInvalidValue;
  probe_copy_kernel<T, 1><<<blocks, threads, 0, stream>>>((const T*)qm, (const T*)qp,
                                                          (T*)flux, (T*)qe, g, tile);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define PROBE_CMPFLX_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* qm, const void* qp, const void* gl, const void* gr,       \
                      const void* cl, const void* cr, void* flux, void* qe, const int* n,   \
                      int npass, int tx, int ty, int threads, int coord, double small_dens, \
                      double small_pres, void* stream) {                                    \
    return ctt::launch_probe_cmpflx<T>(qm, qp, gl, gr, cl, cr, flux, qe, n, npass, tx, ty,  \
                                       threads, coord, small_dens, small_pres,              \
                                       (cudaStream_t)stream);                               \
  }
PROBE_CMPFLX_ENTRY(ctt_probe_cmpflx_f32, float)
PROBE_CMPFLX_ENTRY(ctt_probe_cmpflx_f64, double)

#define PROBE_COPY_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* qm, const void* qp, void* flux, void* qe, const int* n,  \
                      int npass, int tx, int ty, int threads, void* stream) {              \
    return ctt::launch_probe_copy<T>(qm, qp, flux, qe, n, npass, tx, ty, threads,          \
                                     (cudaStream_t)stream);                                \
  }
PROBE_COPY_ENTRY(ctt_probe_copy_f32, float)
PROBE_COPY_ENTRY(ctt_probe_copy_f64, double)
