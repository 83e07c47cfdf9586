// trans_apply: the transverse correction of one interface state given its
// summed transverse bundle: the conserved update, the negative-density and
// (rho e) reset ladder, and the way back to primitive (reference
// actual_trans_single/final, trans.cpp:67,442). Components the correction
// does not touch are copied through: in the RAD build (the radiation
// layout) QPTOT, QREITOT and each group's Er between the hydro components
// and the passives, which start at Q.qfs.
//
// Replaces castro_tpu/ops/pallas_kernels.py:trans_apply_pallas (:255, call
// at :332). Same arithmetic as castro_tpu_torch/ops/trans.py:
// trans_apply_bundle; the body is trans.cuh, shared with ctu_face.cu.
//
// Bound: bytes. A point reads q [NQ], dflux [NVAR], dre and dp and writes
// q' [NQ]: 28 components at NPASS=1, against ~45 operations.
// Design: one thread per point, every access coalesced; pointwise, so the
// grid's dimension does not matter and the TPU's tiling has no counterpart.
#include "common.cuh"
#include "trans.cuh"

namespace ctt {

template <typename T, bool RAD>
__global__ void __launch_bounds__(256) trans_apply_kernel(
    const T* __restrict__ q, const T* __restrict__ df, const T* __restrict__ dre,
    const T* __restrict__ dp, T* __restrict__ out, long long S, Layout L, QLayout Q,
    int reset_density, int reset_rhoe, T small_pres) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S) return;
  T qv[QFS], ov[QFS];
  Bundle<T> b;
#pragma unroll
  for (int c = 0; c < QFS; ++c) qv[c] = q[c * S + t];
#pragma unroll
  for (int c = 0; c < NUH; ++c) b.df[c] = df[c * S + t];
  b.dre = dre[t];
  b.dp = dp[t];
  Dens<T> n = trans_apply(qv, b, small_pres, reset_density != 0, reset_rhoe != 0, ov);
#pragma unroll
  for (int c = 0; c < QFS; ++c) out[c * S + t] = ov[c];
  const int qfs = q_passives<RAD>(Q);
  for (int k = 0; k < L.npass; ++k)
    out[(qfs + k) * S + t] = trans_passive(n, q[(qfs + k) * S + t], df[(L.ufs + k) * S + t]);
  if constexpr (RAD)
    for (int c = QFS; c < qfs; ++c) out[c * S + t] = q[c * S + t];
}

template <typename T>
int launch_trans_apply(const void* q, const void* df, const void* dre, const void* dp,
                       void* out, const int* n, const int* lay, int reset_density,
                       int reset_rhoe, double small_pres, cudaStream_t stream) {
  long long S = (long long)n[0] * n[1] * n[2];
  Layout L = layout_of(lay);
  QLayout Q = q_layout_of(lay);
  if (!layout_ok(L) || !q_layout_ok(Q)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto kernel = q_layout_rad(Q) ? trans_apply_kernel<T, true> : trans_apply_kernel<T, false>;
  kernel<<<blocks_for(S, threads), threads, 0, stream>>>(
      (const T*)q, (const T*)df, (const T*)dre, (const T*)dp, (T*)out, S, L, Q, reset_density,
      reset_rhoe, T(small_pres));
  return (int)cudaGetLastError();
}

}  // namespace ctt

#define TRANS_APPLY_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* q, const void* df, const void* dre, const void* dp,     \
                      void* out, const int* n, const int* lay, int reset_density,         \
                      int reset_rhoe, double small_pres, void* stream) {                  \
    return ctt::launch_trans_apply<T>(q, df, dre, dp, out, n, lay, reset_density,         \
                                      reset_rhoe, small_pres, (cudaStream_t)stream);      \
  }
TRANS_APPLY_ENTRY(ctt_trans_apply_f32, float)
TRANS_APPLY_ENTRY(ctt_trans_apply_f64, double)
