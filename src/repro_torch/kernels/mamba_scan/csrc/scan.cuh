// What the selective scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) kernels share: the type conversions, the exponential
// and the state update.  The backward recomputes the forward's states with
// scan_step, so the two kernels' states are equal bit for bit.  The bf16
// scan (mamba_scan_bf16.cu, and the backward's kBf16 variant) rounds the
// decay and dt u B to bf16, two values a conversion (pack_bf16x2), and
// its decay is bf16(expf(dt A)), decay2 below: expf, not ex2.approx,
// because the reference rounds expf's value and ex2.approx's differs from
// it in the last bits, which move a bf16 rounding near a midpoint.
#pragma once

#include <cstdint>

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

// Two floats rounded to bf16 (ties to even) and packed, lo in the low half:
// one conversion for two.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_f(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// bf16(expf(xa)) and bf16(expf(xb)) packed, lo in the low half: the bf16
// scan's decays of two states.
__device__ __forceinline__ uint32_t decay2(float xa, float xb) {
  return pack_bf16x2(expf(xa), expf(xb));
}

// The decay a = exp(dt A) of a step: with A2 = A log2(e), one ex2.approx.
__device__ __forceinline__ float decay(float dt, float A2) {
  return exp2_approx(dt * A2);
}

// One step of a state: h <- exp(dt A) h + (dt u) B, with a = exp(dt A)
// given; written with explicit roundings so that both kernels compute it
// alike whatever the compiler would contract.
__device__ __forceinline__ float scan_step(float a, float h, float dtu,
                                           float b) {
  return __fmaf_rn(a, h, __fmul_rn(dtu, b));
}

}  // namespace scan
