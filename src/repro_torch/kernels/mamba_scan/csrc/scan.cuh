// What the selective scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) kernels share: the type conversions, the exponential
// and the state update.  The backward recomputes the forward's states with
// scan_step, so the two kernels' states are equal bit for bit.  kBf16
// selects the step of the bf16-scan function (mamba_scan_bf16.cu): the
// decay and dt u B rounded to bf16, the decay by expf of dt A.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

constexpr int kChunk = 64;      // time steps the forward stages at once
// Time steps between the states the forward saves for the backward
// (ref.py's STATE_CHUNK, ops.py mirrors it).
constexpr int kStateEvery = 16;
static_assert(kChunk % kStateEvery == 0, "kStateEvery must divide kChunk");
constexpr int kMaxState = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 2^x on the special-function unit: one MUFU.EX2, relative error about
// 2^-22, subnormal results flushed to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The decay a = exp(dt A) of a step: with A2 = A log2(e), one ex2.approx;
// under kBf16, with A2 = A itself, bf16(expf(dt A)) as the reference
// rounds it (fp32 product, exponential, then the rounding).
template <bool kBf16 = false>
__device__ __forceinline__ float decay(float dt, float A2) {
  if constexpr (kBf16) return round_bf16(expf(__fmul_rn(dt, A2)));
  else return exp2_approx(dt * A2);
}

// One step of a state: h <- exp(dt A) h + (dt u) B, with a = exp(dt A)
// given; written with explicit roundings so that both kernels compute it
// alike whatever the compiler would contract.  Under kBf16, (dt u) B is
// rounded to bf16 first.
template <bool kBf16 = false>
__device__ __forceinline__ float scan_step(float a, float h, float dtu,
                                           float b) {
  if constexpr (kBf16) return __fmaf_rn(a, h, round_bf16(__fmul_rn(dtu, b)));
  else return __fmaf_rn(a, h, __fmul_rn(dtu, b));
}

}  // namespace scan
