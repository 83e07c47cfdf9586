// consup: one direction's conservative update of a 3D Cartesian grid:
// artificial viscosity from the node-averaged div u, species-flux
// normalization, hsrc += -(F[i+1] - F[i]) / dx_d, hsrc[UEINT] -= p div u
// from the Godunov pressure and normal velocity, and with `with_fin` the
// update u + dt * hsrc; it also returns the cleaned flux (reference
// apply_av, advection_util.cpp:483; normalize_species_fluxes, :578;
// consup_hydro, Castro_ctu.cpp:12).
//
// Replaces castro_tpu/ops/pallas_kernels.py:consup_pallas (:1243, calls at
// :1346, :1355). Same arithmetic, in the same order, as
// castro_tpu_torch/ops/kernels.py:consup_plain and as the helpers of
// consup.cuh that ctu_face.cu's consup fold uses (that fold is not built
// from this file). As consup_plain, an extra component's flux comes in
// with the others and takes the viscosity, the shock flag's passes
// through unchanged.
//
// Bound: bytes. A cell reads hsrc, flux, u [NVAR], pg, ug and div and
// writes hsrc' and flux' [NVAR]: 5 NVAR + 3 components, 43 at NPASS = 1,
// against ~80 operations.
// Design: each face is cleaned (viscosity, normalization) once, and each
// input element is loaded once from device memory; a cell's update takes
// its lo face from the step that cleaned it.
// - d = 0, 1 (consup_march_kernel): a thread owns one column of the
//   transverse plane and marches along d over a segment of `seg` cells. At
//   each cell it loads the hi face's flux, u, pg, ug and div nodes, cleans
//   that face, writes the cell's hsrc' and flux' (its lo face), and keeps
//   the hi face and the u it loaded as the next cell's lo face and cell
//   state: the hydro components in registers, the extras and passives
//   (a run-time count) in the thread's own slots of shared memory. A warp
//   covers 32 neighbouring columns, so every load and store is coalesced
//   along the contiguous axis 2; a segment re-cleans its first face (one
//   face in `seg`).
// - d = 2, the contiguous axis (consup_rows_kernel): a warp owns 32
//   consecutive faces of the flattened grid and updates the 31 cells whose
//   lo faces they are; each lane cleans its face, takes u of the cell below
//   from the lane below (__shfl_up) and its cell's hi face from the lane
//   above (__shfl_down). Warps overlap by one face, cleaned twice (one in
//   32); a row's first and last cell clamp as consup_plain does.
// Loads in flight: the hydro components (fixed in number) are loaded into
// registers, every load of a step issued before its first store (every
// array is a __restrict__ argument). The extras and passives, a run-time
// count looped over, are copied with cp.async into the thread's slots of
// shared memory at the start of the step, and land while the hydro part
// runs: a step waits for memory once, whatever NPASS is, where loads in the
// loop would wait once for every few components. Staging whole steps a
// step ahead with cp.async, two stages a thread (also along d = 2, and
// along d = 1 a tile of 8 rows by 32 whose faces pass through shared
// memory), and four cells a step were built, held bit for bit, and ran no
// faster (PERF.md section 6).
// Stores are 4 bytes a thread: a warp's 32 stores to neighbouring
// addresses fill whole 128-byte lines, the transactions 16-byte stores
// would make.
// Offsets into a component are 32-bit (S < 2^31, checked), a component's
// start c * S 64-bit; the column and row coordinates take one 32-bit
// division each, outside the loops. The species sums of a face are taken
// in species order; a species' flux and u are read twice from the slots,
// for the sum and for the scaled pass.
#include <limits.h>

#include "common.cuh"
#include "consup.cuh"

namespace ctt {

// a[c * S + off] through the read-only path
template <typename T>
__device__ __forceinline__ T ldc(const T* a, int c, int S, int off) {
  return __ldg(a + ((long long)c * S + off));
}

// One element from device memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}
// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the extras' and passives' inputs of one cell into the thread's
// slots (component c at [(c - NUH) * nt]): flux and u of face `of` into
// fs and us (when `face`), hsrc of cell `oc` into hs (when `cell`).
template <typename T>
__device__ __forceinline__ void copy_passives(T* fs, T* us, T* hs, int nt, int nvar, int S,
                                              bool face, bool cell, const T* flux,
                                              const T* u, const T* hsrc, int of, int oc) {
#pragma unroll 4
  for (int c = NUH; c < nvar; ++c) {
    const int j = (c - NUH) * nt;
    const long long cs = (long long)c * S;
    if (face) {
      cp_async(fs + j, flux + (cs + of));
      cp_async(us + j, u + (cs + of));
    }
    if (cell) cp_async(hs + j, hsrc + (cs + oc));
  }
}

// The artificial-viscosity coefficient of a face from div u at its four
// nodes: d00 at the face's cell, d10 one along the lower transverse axis,
// d01 one along the upper, d11 along both (av_coeff's rounding order).
template <typename T>
__device__ __forceinline__ T face_coeff(const ConsupParams<T>& p, T d00, T d10, T d01, T d11) {
  T a1 = T(0.5) * (d00 + d10);
  T a2 = T(0.5) * (d01 + d11);
  T div1 = T(0.5) * (a1 + a2);
  return p.difmag * vmin(div1, T(0)) * p.dxd;
}

// One component of a cell's update from its hsrc (h), its u (for the
// finalize), its cleaned lo and hi face fluxes, and p div u on UEINT
// (consup_row's arithmetic).
template <typename T>
__device__ __forceinline__ T consup_update(const ConsupParams<T>& p, T h, T ucell, T flo,
                                           T fhi, bool eint, T pdivu) {
  T row = -(fhi - flo) * p.inv_dx;
  if (eint) row = row - pdivu;
  T v = h + row;
  if (p.with_fin) v = ucell + p.fin_dt * v;
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(256) consup_march_kernel(
    const __grid_constant__ ConsupParams<T> p, const T* __restrict__ hsrc,
    const T* __restrict__ flux, const T* __restrict__ pg, const T* __restrict__ ug,
    const T* __restrict__ div, const T* __restrict__ u, T* __restrict__ hout,
    T* __restrict__ fout, Grid g, Layout L, int seg) {
  static_assert(D == 0 || D == 1, "the march runs along a non-contiguous axis");
  constexpr int A = trans1(D);  // the lower transverse axis; the upper is 2
  extern __shared__ __align__(16) unsigned char consup_smem[];
  const int nt = blockDim.x;
  const int na = g.n[A], nb = g.n[2], nd = g.n[D];
  const int q = blockIdx.x * nt + threadIdx.x;
  if (q >= na * nb) return;
  const int a = q / nb, b = q - a * nb;
  const int S = (int)g.S, plane = g.n[1] * g.n[2];
  const int sd = D == 0 ? plane : nb;  // strides along d and along A
  const int sa = D == 0 ? nb : plane;
  const int oa = a + 1 < na ? sa : 0, ob = b + 1 < nb ? 1 : 0;
  const int m0 = blockIdx.y * seg, m1 = min(m0 + seg, nd);
  // this thread's slots for the extras and passives, component c at
  // [(c - NUH) * nt]: the cleaned lo face (sf) and u of the cell (su);
  // the step's hi-face flux (xf) and u (xu) and the cell's hsrc (xh)
  const int nvar = L.nvar(), nx = nvar - NUH;
  T* sf = reinterpret_cast<T*>(consup_smem) + threadIdx.x;
  T* su = sf + nx * nt;
  T* xf = su + nx * nt;
  T* xu = xf + nx * nt;
  T* xh = xu + nx * nt;

  // the segment's first face, m0, against the cell below it
  int off = (D == 0 ? q : a * plane + b) + m0 * sd;
  const int offl = m0 > 0 ? off - sd : off;
  T coef = face_coeff(p, __ldg(div + off), __ldg(div + off + oa), __ldg(div + off + ob),
                      __ldg(div + off + oa + ob));
  T flo[NUH], uc[NUH];
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    flo[c] = ldc(flux, c, S, off);
    if (c == UTEMP) {  // no viscosity; its u only for the finalize
      uc[c] = p.with_fin ? ldc(u, c, S, off) : T(0);
      continue;
    }
    uc[c] = ldc(u, c, S, off);
    flo[c] = flo[c] + coef * (uc[c] - ldc(u, c, S, offl));
  }
  T pgl = __ldg(pg + off), ugl = __ldg(ug + off);
#pragma unroll 4
  for (int c = NUH; c < L.ufs; ++c) {
    const T uv = ldc(u, c, S, off), fv = ldc(flux, c, S, off);
    su[(c - NUH) * nt] = uv;
    sf[(c - NUH) * nt] = c == L.ushk ? fv : fv + coef * (uv - ldc(u, c, S, offl));
  }
  T s = T(0);
#pragma unroll 4
  for (int k = 0; k < L.nspec; ++k) {
    const int c = L.ufs + k;
    T fl = ldc(flux, c, S, off) + coef * (ldc(u, c, S, off) - ldc(u, c, S, offl));
    s = k == 0 ? fl : s + fl;
  }
  T fac = species_fac(flo[URHO], s);
#pragma unroll 4
  for (int k = 0; k < L.npass; ++k) {
    const int c = L.ufs + k;
    T uv = ldc(u, c, S, off);
    T fl = ldc(flux, c, S, off) + coef * (uv - ldc(u, c, S, offl));
    if (k < L.nspec) fl = fl * fac;
    su[(c - NUH) * nt] = uv;
    sf[(c - NUH) * nt] = fl;
  }

  for (int m = m0; m < m1; ++m, off += sd) {
    // the hi face m + 1, cleaned here; the grid's top cell takes its own
    // lo face again (the clamp of consup_plain). The step's loads are
    // issued before its first store.
    const bool top = m + 1 >= nd;
    const int offh = top ? off : off + sd;
    // the extras and passives land in the slots while the hydro part runs
    copy_passives(xf, xu, xh, nt, nvar, S, !top, true, flux, u, hsrc, offh, off);
    T fh[NUH], un[NUH], hs[NUH];
#pragma unroll
    for (int c = 0; c < NUH; ++c) hs[c] = ldc(hsrc, c, S, off);
    T chi = T(0), pgh = pgl, ugh = ugl;
    if (!top) {
      chi = face_coeff(p, __ldg(div + offh), __ldg(div + offh + oa), __ldg(div + offh + ob),
                       __ldg(div + offh + oa + ob));
      pgh = __ldg(pg + offh);
      ugh = __ldg(ug + offh);
#pragma unroll
      for (int c = 0; c < NUH; ++c) {
        fh[c] = ldc(flux, c, S, offh);
        un[c] = c != UTEMP || p.with_fin ? ldc(u, c, S, offh) : T(0);
      }
#pragma unroll
      for (int c = 0; c < NUH; ++c)
        if (c != UTEMP) fh[c] = fh[c] + chi * (un[c] - uc[c]);
    } else {
#pragma unroll
      for (int c = 0; c < NUH; ++c) {
        fh[c] = flo[c];
        un[c] = uc[c];
      }
    }
    const T pdivu = T(0.5) * (pgh + pgl) * (ugh - ugl) * p.inv_dx;
#pragma unroll
    for (int c = 0; c < NUH; ++c) {
      const long long i = (long long)c * S + off;
      hout[i] = consup_update(p, hs[c], uc[c], flo[c], fh[c], c == UEINT, pdivu);
      fout[i] = flo[c];
      flo[c] = fh[c];
      uc[c] = un[c];
    }
    pgl = pgh;
    ugl = ugh;
    cp_async_wait_all();
#pragma unroll 4
    for (int c = NUH; c < L.ufs; ++c) {
      const int j = (c - NUH) * nt;
      const long long i = (long long)c * S + off;
      const T fl = sf[j], ul = su[j];
      T fhv = fl, uh = ul;
      if (!top) {
        uh = xu[j];
        fhv = c == L.ushk ? xf[j] : xf[j] + chi * (uh - ul);
      }
      hout[i] = consup_update(p, xh[j], ul, fl, fhv, false, T(0));
      fout[i] = fl;
      sf[j] = fhv;
      su[j] = uh;
    }
    T fac_hi = T(1);
    if (!top) {
      T sh = T(0);
#pragma unroll 4
      for (int k = 0; k < L.nspec; ++k) {
        const int j = (L.ufs + k - NUH) * nt;
        T fv = xf[j] + chi * (xu[j] - su[j]);
        sh = k == 0 ? fv : sh + fv;
      }
      fac_hi = species_fac(flo[URHO], sh);  // flo: the hi face, now kept
    }
#pragma unroll 4
    for (int k = 0; k < L.npass; ++k) {
      const int c = L.ufs + k, j = (c - NUH) * nt;
      const long long i = (long long)c * S + off;
      const T fl = sf[j], ul = su[j];
      T fhv = fl, uh = ul;
      if (!top) {
        uh = xu[j];
        fhv = xf[j] + chi * (uh - ul);
        if (k < L.nspec) fhv = fhv * fac_hi;
      }
      hout[i] = consup_update(p, xh[j], ul, fl, fhv, false, T(0));
      fout[i] = fl;
      sf[j] = fhv;
      su[j] = uh;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1) consup_rows_kernel(
    const __grid_constant__ ConsupParams<T> p, const T* __restrict__ hsrc,
    const T* __restrict__ flux, const T* __restrict__ pg, const T* __restrict__ ug,
    const T* __restrict__ div, const T* __restrict__ u, T* __restrict__ hout,
    T* __restrict__ fout, Grid g, Layout L) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char consup_smem[];
  const int nt = blockDim.x, lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int S = (int)g.S;
  if (w * 31 >= S) return;  // whole warps only: every lane takes part in the shuffles
  // lane l cleans the lo face of cell t; lanes 0-30 update their cells
  const int t = (int)(w * 31) + lane;
  const int tc = t < S ? t : S - 1;
  const int n1 = g.n[1], n2 = g.n[2], plane = n1 * n2;
  const int r = tc / n2, k = tc - r * n2, j = r - (r / n1) * n1;
  const int il = k > 0 ? tc - 1 : tc;  // the cell below the face
  const bool from_next = k < n2 - 1;   // the cell's hi face is the next lane's
  const bool cell = lane < 31 && t < S;
  const int oa = tc + plane < S ? plane : 0, ob = j + 1 < n1 ? n2 : 0;
  // the extras' and passives' flux, u and hsrc land in this thread's
  // slots (component c at [(c - NUH) * nt]) while the hydro part runs,
  // and lane 0's u of the cell below the warp's first face
  const int nvar = L.nvar(), nx = nvar - NUH;
  T* xf = reinterpret_cast<T*>(consup_smem) + threadIdx.x;
  T* xu = xf + nx * nt;
  T* xh = xu + nx * nt;
  T* xl = xh + nx * nt;
  copy_passives(xf, xu, xh, nt, nvar, S, true, cell, flux, u, hsrc, tc, t);
  if (lane == 0)
    for (int c = NUH; c < nvar; ++c) cp_async(xl + (c - NUH) * nt, u + ((long long)c * S + il));
  const T coef = face_coeff(p, __ldg(div + tc), __ldg(div + tc + oa), __ldg(div + tc + ob),
                            __ldg(div + tc + oa + ob));
  // u at the cell below the face: the lane below's uv, lane 0's own ul0
  auto below = [&](T uv, T ul0) {
    T ul = __shfl_up_sync(FULL, uv, 1);
    if (lane == 0) ul = ul0;
    return k > 0 ? ul : uv;
  };
  auto above = [&](T v) {
    T h = __shfl_down_sync(FULL, v, 1);
    return from_next ? h : v;
  };

  T f[NUH], uc[NUH], hs[NUH], u0[NUH];
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    f[c] = ldc(flux, c, S, tc);
    uc[c] = c != UTEMP || p.with_fin ? ldc(u, c, S, tc) : T(0);
    hs[c] = cell ? ldc(hsrc, c, S, t) : T(0);
    u0[c] = lane == 0 && c != UTEMP ? ldc(u, c, S, il) : T(0);
  }
  const T pgl = __ldg(pg + tc), ugl = __ldg(ug + tc);
#pragma unroll
  for (int c = 0; c < NUH; ++c)
    if (c != UTEMP) f[c] = f[c] + coef * (uc[c] - below(uc[c], u0[c]));
  const T pgh = above(pgl), ugh = above(ugl);
  const T pdivu = T(0.5) * (pgh + pgl) * (ugh - ugl) * p.inv_dx;
#pragma unroll
  for (int c = 0; c < NUH; ++c) {
    const T fh = above(f[c]);
    if (cell) {
      const long long i = (long long)c * S + t;
      hout[i] = consup_update(p, hs[c], uc[c], f[c], fh, c == UEINT, pdivu);
      fout[i] = f[c];
    }
  }
  cp_async_wait_all();
#pragma unroll 4
  for (int c = NUH; c < L.ufs; ++c) {
    const int jx = (c - NUH) * nt;
    const T uv = xu[jx];
    const T ul = below(uv, xl[jx]), fr = xf[jx];
    const T fv = c == L.ushk ? fr : fr + coef * (uv - ul);
    const T fh = above(fv);
    if (cell) {
      const long long i = (long long)c * S + t;
      hout[i] = consup_update(p, xh[jx], uv, fv, fh, false, T(0));
      fout[i] = fv;
    }
  }
  T s = T(0);
#pragma unroll 4
  for (int kk = 0; kk < L.nspec; ++kk) {
    const int jx = (L.ufs + kk - NUH) * nt;
    const T uv = xu[jx];
    const T fv = xf[jx] + coef * (uv - below(uv, xl[jx]));
    s = kk == 0 ? fv : s + fv;
  }
  const T fac = species_fac(f[URHO], s);
#pragma unroll 4
  for (int kk = 0; kk < L.npass; ++kk) {
    const int c = L.ufs + kk, jx = (c - NUH) * nt;
    const T uv = xu[jx];
    T fv = xf[jx] + coef * (uv - below(uv, xl[jx]));
    if (kk < L.nspec) fv = fv * fac;
    const T fh = above(fv);
    if (cell) {
      const long long i = (long long)c * S + t;
      hout[i] = consup_update(p, xh[jx], uv, fv, fh, false, T(0));
      fout[i] = fv;
    }
  }
}

// The march's segment length: enough segments that the grid holds about
// two resident waves of columns (132 SMs x 768 threads), each at least 8
// cells long.
inline int march_segment(int nd, long long ncol) {
  const long long want = 2LL * 132 * 768;
  long long nseg = (want + ncol - 1) / ncol;
  long long most = nd / 8 > 1 ? nd / 8 : 1;
  nseg = nseg < 1 ? 1 : (nseg > most ? most : nseg);
  return (int)((nd + nseg - 1) / nseg);
}

template <typename T, int D>
int launch_march(const ConsupParams<T>& p, const T* hsrc, const T* flux, const T* pg,
                 const T* ug, const T* div, const T* u, T* hout, T* fout, const Grid& g,
                 const Layout& L, cudaStream_t stream) {
  const int na = g.n[trans1(D)], nb = g.n[2], nd = g.n[D];
  const long long ncol = (long long)na * nb;
  const int seg = march_segment(nd, ncol);
  // the extras' and passives' slots: five a component a thread
  int threads = 256;
  const size_t per_thread = 5 * (size_t)(L.nvar() - NUH) * sizeof(T);
  while (threads > 32 && per_thread * threads > 100 * 1024) threads /= 2;
  const size_t smem = per_thread * threads;
  auto kernel = consup_march_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(blocks_for(ncol, threads), (nd + seg - 1) / seg);
  kernel<<<grid, threads, smem, stream>>>(p, hsrc, flux, pg, ug, div, u, hout, fout, g, L, seg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_consup(const void* hsrc, const void* flux, const void* pg, const void* ug,
                  const void* div, const void* u, void* hout, void* fout, const int* n,
                  const int* lay, int d, const double* cons, int with_fin,
                  cudaStream_t stream) {
  Grid g{{n[0], n[1], n[2]}, (long long)n[0] * n[1] * n[2]};
  Layout L = layout_of(lay);
  if (!layout_ok(L) || d < 0 || d > 2 || g.S > INT_MAX) return (int)cudaErrorInvalidValue;
  ConsupParams<T> p = make_consup<T>(hsrc, div, u, hout, cons, with_fin, d);
  const T *hs = (const T*)hsrc, *f = (const T*)flux, *pgp = (const T*)pg, *ugp = (const T*)ug;
  const T *dv = (const T*)div, *uu = (const T*)u;
  T *ho = (T*)hout, *fo = (T*)fout;
  if (d == 0) return launch_march<T, 0>(p, hs, f, pgp, ugp, dv, uu, ho, fo, g, L, stream);
  if (d == 1) return launch_march<T, 1>(p, hs, f, pgp, ugp, dv, uu, ho, fo, g, L, stream);
  // the extras' and passives' slots: four a component a thread
  int threads = 256;
  const size_t per_thread = 4 * (size_t)(L.nvar() - NUH) * sizeof(T);
  while (threads > 32 && per_thread * threads > 100 * 1024) threads /= 2;
  const size_t smem = per_thread * threads;
  auto kernel = consup_rows_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long warps = (g.S + 30) / 31;
  kernel<<<blocks_for(warps * 32, threads), threads, smem, stream>>>(p, hs, f, pgp, ugp, dv, uu,
                                                                      ho, fo, g, L);
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define CONSUP_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* hsrc, const void* flux, const void* pg, const void* ug, \
                      const void* div, const void* u, void* hout, void* fout,             \
                      const int* n, const int* lay, int d, const double* cons,            \
                      int with_fin, void* stream) {                                       \
    return ctt::launch_consup<T>(hsrc, flux, pg, ug, div, u, hout, fout, n, lay, d, cons, \
                                 with_fin, (cudaStream_t)stream);                         \
  }
CONSUP_ENTRY(ctt_consup_f32, float)
CONSUP_ENTRY(ctt_consup_f64, double)
