// probe_vpu: the vector-unit throughput probe. Each element of a float32
// array gets one body applied `iters` times, and the result is written.
// The body is a template parameter:
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
// Bound: operations. Per element and iteration fma does 2 dependent FP32
// instructions (FMUL, FADD), fma_rn 1 (FFMA): the FP32 pipe, 128 lanes a
// clock on an SM of compute capability 9.0. div, rsqrt, recip_approx and
// exp do 1 MUFU instruction (16 lanes a clock) and 1 FP32 at least: the
// MUFU pipe bounds them. Loads and stores are one a thread and element.
// Design: the grid is whole waves, a whole number of blocks of 512 threads
// a streaming multiprocessor, and each block owns a contiguous range of
// at most VPU_ELEMS x 512 elements, so the 132 SMs get equal shares; each
// thread carries VPU_ELEMS independent chains (the elements tid + e x 512
// of its block's range; a chain past the range runs on a copy of the
// first and is not stored), so an SM's four schedulers hold 16
// independent FP32 instructions each at every step. The iteration loop is
// unrolled by a fixed factor (vpu_unroll: 50 for the FP32 bodies, 10 for
// rsqrt, recip_approx and exp, each dividing the probes' iteration counts;
// none for div, whose every division carries a branch to its slow path
// and which ran slower unrolled ten times), so the counter,
// compare and branch take 3 issue slots in 400 for fma, with a remainder
// loop for other counts. At 512^2 elements a thread's chains cover whole
// warps but for the block's last warp, so the FP32 pipe can be at most
// 262144 / (132 x 4 x 32 x 16) = 97.0% busy: 15.5 warps of work on each
// scheduler, issued as 16.
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

// independent elements a thread carries, and threads a block
enum { VPU_ELEMS = 4, VPU_THREADS = 512 };

template <int OP>
__host__ __device__ constexpr int vpu_unroll() {
  return OP == VPU_FMA || OP == VPU_FMA_RN ? 50 : (OP == VPU_DIV ? 1 : 10);
}

template <int OP>
__global__ void __launch_bounds__(VPU_THREADS) probe_vpu_kernel(const float* __restrict__ x,
                                                                float* __restrict__ out,
                                                                long long n, long long per_block,
                                                                int iters, float c1, float c2) {
  const long long lo = (long long)blockIdx.x * per_block;
  if (lo >= n) return;  // a small n leaves the last blocks empty
  const long long hi = lo + per_block < n ? lo + per_block : n;
  float v[VPU_ELEMS];
#pragma unroll
  for (int e = 0; e < VPU_ELEMS; ++e) {
    const long long i = lo + threadIdx.x + (long long)e * VPU_THREADS;
    v[e] = x[i < hi ? i : lo];
  }
  constexpr int U = vpu_unroll<OP>();
  int it = 0;
  for (; it + U <= iters; it += U) {
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int e = 0; e < VPU_ELEMS; ++e) v[e] = vpu_body<OP>(v[e], c1, c2);
  }
  for (; it < iters; ++it)
#pragma unroll
    for (int e = 0; e < VPU_ELEMS; ++e) v[e] = vpu_body<OP>(v[e], c1, c2);
#pragma unroll
  for (int e = 0; e < VPU_ELEMS; ++e) {
    const long long i = lo + threadIdx.x + (long long)e * VPU_THREADS;
    if (i < hi) out[i] = v[e];
  }
}

template <int OP>
int launch_vpu(const float* x, float* out, long long n, int iters, float c1, float c2,
               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // whole waves: sms x k blocks, k the fewest that hold n elements
  const long long per_wave = (long long)sms * VPU_THREADS * VPU_ELEMS;
  const long long blocks = sms * ((n + per_wave - 1) / per_wave);
  const long long per_block = (n + blocks - 1) / blocks;
  probe_vpu_kernel<OP>
      <<<(int)blocks, VPU_THREADS, 0, stream>>>(x, out, n, per_block, iters, c1, c2);
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
