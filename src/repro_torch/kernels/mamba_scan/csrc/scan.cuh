// What the selective scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) kernels share: the type conversions, the exponential
// and the state update.  The backward recomputes the forward's states with
// scan_step, so the two kernels' states are equal bit for bit.
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

// One step of a state: h <- exp(dt A) h + (dt u) B, with a = exp(dt A)
// given; written with explicit roundings so that both kernels compute it
// alike whatever the compiler would contract.
__device__ __forceinline__ float scan_step(float a, float h, float dtu,
                                           float b) {
  return __fmaf_rn(a, h, __fmul_rn(dtu, b));
}

}  // namespace scan
