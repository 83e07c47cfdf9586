// probe_vpu: the vector-unit throughput probe. One thread per element of a
// float32 array; each thread applies one body `iters` times to its element
// and writes the result. The body is a template parameter:
//   0 fma           x * c1 + c2, a multiply and an add: the library builds
//                   with --fmad=false, so this rounds twice, as the plain
//                   version does
//   1 fma_rn        __fmaf_rn(x, c1, c2), one fused multiply-add
//   2 div           1 / (x + c2), IEEE division
//   3 rsqrt         rsqrtf(x) + 1
//   4 recip_approx  rcp.approx.f32(x) + c2, the approximate reciprocal
//   5 exp           expf(x * c2)
// with c1 = 1.0000001 and c2 = 1e-9 rounded to float on the host.
//
// Replaces scripts/prof_vpu.py:make (pallas_call at :12), whose kernel runs
// jax.lax.fori_loop over the same five bodies on a [512, 512] block in VMEM
// (fma_rn has no counterpart there; it shows the fused rate beside the
// two-rounding one). Same arithmetic as castro_tpu_torch/ops/probes.py:
// probe_vpu_plain, bit for bit for fma and div; rsqrtf, expf and the
// approximate reciprocal are not correctly rounded.
//
// Bound: operations. Per element and iteration fma does 2 FP32
// instructions (128 a clock on an SM of compute capability 9.0), fma_rn 1,
// div 1 and one MUFU reciprocal at least (16 a clock), rsqrt, recip_approx
// and exp 1 FP32 and 1 MUFU; loads and stores are one a thread.
// Design: the loop carries one value in a register, so the only memory
// traffic is one read and one write a thread; a launch of 262,144 threads
// (8 warps a scheduler on 132 SMs) hides the latency of the dependent chain.
#include <cuda_runtime.h>

namespace ctt {

enum { VPU_FMA = 0, VPU_FMA_RN = 1, VPU_DIV = 2, VPU_RSQRT = 3, VPU_RCP_APPROX = 4, VPU_EXP = 5 };

template <int OP>
__device__ __forceinline__ float vpu_body(float x, float c1, float c2) {
  if constexpr (OP == VPU_FMA) {
    return x * c1 + c2;
  } else if constexpr (OP == VPU_FMA_RN) {
    return __fmaf_rn(x, c1, c2);
  } else if constexpr (OP == VPU_DIV) {
    return 1.0f / (x + c2);
  } else if constexpr (OP == VPU_RSQRT) {
    return rsqrtf(x) + 1.0f;
  } else if constexpr (OP == VPU_RCP_APPROX) {
    float r;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r + c2;
  } else {
    return expf(x * c2);
  }
}

template <int OP>
__global__ void __launch_bounds__(256) probe_vpu_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, long long n,
                                                        int iters, float c1, float c2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float v = x[t];
  for (int i = 0; i < iters; ++i) v = vpu_body<OP>(v, c1, c2);
  out[t] = v;
}

template <int OP>
int launch_vpu(const float* x, float* out, long long n, int iters, float c1, float c2,
               cudaStream_t stream) {
  const int threads = 256;
  probe_vpu_kernel<OP><<<(int)((n + threads - 1) / threads), threads, 0, stream>>>(
      x, out, n, iters, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace ctt

extern "C" int ctt_probe_vpu_f32(const void* x, void* out, long long n, int op, int iters,
                                 double c1, double c2, void* stream) {
  const float* xi = (const float*)x;
  float* o = (float*)out;
  float a = (float)c1, b = (float)c2;
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case ctt::VPU_FMA: return ctt::launch_vpu<ctt::VPU_FMA>(xi, o, n, iters, a, b, s);
    case ctt::VPU_FMA_RN: return ctt::launch_vpu<ctt::VPU_FMA_RN>(xi, o, n, iters, a, b, s);
    case ctt::VPU_DIV: return ctt::launch_vpu<ctt::VPU_DIV>(xi, o, n, iters, a, b, s);
    case ctt::VPU_RSQRT: return ctt::launch_vpu<ctt::VPU_RSQRT>(xi, o, n, iters, a, b, s);
    case ctt::VPU_RCP_APPROX:
      return ctt::launch_vpu<ctt::VPU_RCP_APPROX>(xi, o, n, iters, a, b, s);
    case ctt::VPU_EXP: return ctt::launch_vpu<ctt::VPU_EXP>(xi, o, n, iters, a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
