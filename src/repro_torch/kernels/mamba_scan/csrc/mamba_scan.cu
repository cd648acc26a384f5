// Mamba1 selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py:23
// (_kernel, launched by mamba_scan_raw at :53, pallas_call at :63).  With
// A = -exp(A_log), every channel (b, d) runs h <- exp(dt A) h + (dt u) B over
// its N states and emits y = sum_N h C at each step, from h = 0; there is no
// D skip term and no gate (the model adds both).  It takes the layout of the
// reference wrapper: u/dt (B, S, din), B/C (B, S, N), A_log (din, N) fp32,
// any batch and time strides with the last axis contiguous; y comes out in
// u's type.  Unlike the TPU kernel, which keeps h in VMEM scratch and drops
// it, this one also writes the final state h_last (B, din, N) in fp32: the
// model's decode starts from it, and writing it here spares a second pass.
// There is no padding: the time loop stops at S, which leaves the same state
// as the reference's ragged tail masked with dt = 0.
//
// Design: one thread per channel, with its N states and its N values of A
// (computed once, not per step) in fp32 registers; a block holds 128
// neighbouring channels of one sequence, and the grid is (din / 128, B).
// Blocks carry nothing between them: the TPU grid's sequential chunk axis
// becomes the time loop inside the block.  The loop walks the sequence in
// chunks of 64 steps.  For each chunk every thread first stages its own
// column of u and dt in shared memory (for each step the warp reads 32
// neighbouring channels, so the loads coalesce; they go through registers
// 16 steps at a time, so a chunk costs four round trips to device memory
// and not one per step), and the block stages the chunk's B and C rows,
// which all its channels share.  Then the serial recurrence runs from
// shared memory; y is stored at once, the warp's 32 stores coalesced, and
// h_last once at the end.  The sum over N is split four ways to shorten its
// dependent chain.  exp is expf (no fast math), so the fp32 result holds to
// the plain version at 1e-4.
//
// What bounds it on this card: at falcon-mamba-7b's prefill shape (B 4,
// S 2048, din 8192, N 16) the function reads and writes about 0.54 GB (u
// and y in bf16, dt in fp32, B, C, h_last), 0.16 ms at 3.35 TB/s, and takes
// B S din N = 1.07e9 exponentials, 0.26 ms at the special-function units'
// 16 a clock per SM: operations, narrowly.  256 blocks of 128 threads fill
// the 132 SMs thinly, so latency is the risk; this first version hides it
// with the staged chunks and the independent states of each thread, and
// does not overlap a chunk's loads with the previous chunk's arithmetic.
// Splitting a channel's states over 4 lanes (a shuffle sum for y) was
// slower at N = 16 and faster at N = 64 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 64;      // time steps staged per pass
constexpr int kBatch = 16;      // loads in flight per thread while staging
constexpr int kMaxState = 64;

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

struct Strides {  // element strides of (batch, time); the last axis is 1
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

size_t smem_bytes(int NP) {
  return sizeof(float) *
         (2 * (size_t)kChunk * kThreads + 2 * (size_t)kChunk * NP);
}

// NP: N rounded up to the power of two the states are unrolled to, so that
// h[] and A[] stay in registers; states n >= N are skipped.  kFull: N == NP
// (falcon-mamba's 16), compiled without that test in the step loop, which
// the compiler otherwise keeps as a branch per state: it more than halves
// the time.
template <typename T, typename TD, int NP, bool kFull>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ u, const TD* __restrict__ dt,
    const T* __restrict__ Bc, const T* __restrict__ Cc,
    const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_last, Strides st, int S, int din, int N) {
  extern __shared__ float smem[];
  float* su = smem;                        // [kChunk][kThreads]
  float* sdt = su + kChunk * kThreads;     // [kChunk][kThreads]
  float* sb = sdt + kChunk * kThreads;     // [kChunk][NP], 16-byte rows
  float* sc = sb + kChunk * NP;            // [kChunk][NP]

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < din;

  float A[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    A[n] = (live && n < N) ? -expf(A_log[(long long)d * N + n]) : 0.f;
    h[n] = 0.f;
  }
  const T* ub = u + b * st.u_b + d;
  const TD* db = dt + b * st.dt_b + d;
  const T* bb = Bc + b * st.b_b;
  const T* cb = Cc + b * st.c_b;
  T* yb = y + b * (long long)S * din + d;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    // Loads go to registers kBatch at a time, all issued before the first
    // store, so a batch costs one round trip to device memory and not one
    // per step.  Indices past the chunk are clamped to its last step (a
    // valid address); those values are never stored.
    if (live) {  // this thread's column; read back only by this thread
      for (int t = 0; t < steps; t += kBatch) {
        float uv[kBatch], dv[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const long long tt = t0 + min(t + j, steps - 1);
          uv[j] = to_f(ub[tt * st.u_s]);
          dv[j] = to_f(db[tt * st.dt_s]);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (t + j < steps) {
            su[(t + j) * kThreads + tid] = uv[j];
            sdt[(t + j) * kThreads + tid] = dv[j];
          }
        }
      }
    }
    const int nbc = steps * N;  // B and C rows, shared by the block
    for (int i0 = 0; i0 < nbc; i0 += kBatch * kThreads) {
      float bv[kBatch], cv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = min(i0 + j * kThreads + tid, nbc - 1);
        const int t = i / N, n = i - t * N;
        bv[j] = to_f(bb[(long long)(t0 + t) * st.b_s + n]);
        cv[j] = to_f(cb[(long long)(t0 + t) * st.c_s + n]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < nbc) {
          const int t = i / N, n = i - t * N;
          sb[t * NP + n] = bv[j];
          sc[t * NP + n] = cv[j];
        }
      }
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < steps; ++t) {
        const float dtv = sdt[t * kThreads + tid];
        const float dtu = dtv * su[t * kThreads + tid];
        // B and C of this step, four states a load (16-byte shared loads)
        const float4* bt = reinterpret_cast<const float4*>(sb + t * NP);
        const float4* ct = reinterpret_cast<const float4*>(sc + t * NP);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NP / 4; ++q) {
          const float4 b4 = bt[q], c4 = ct[q];
          const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = 4 * q + k;
            if (kFull || n < N) {
              h[n] = expf(dtv * A[n]) * h[n] + dtu * bq[k];
              acc[k] += h[n] * cq[k];
            }
          }
        }
        yb[(long long)(t0 + t) * din] =
            from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
    __syncthreads();  // the next chunk overwrites B and C
  }
  if (live) {
    float* hb = h_last + (b * din + d) * (long long)N;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) hb[n] = h[n];
  }
}

template <typename T, typename TD, int NP>
int launch_n(const void* u, const void* dt, const void* Bc, const void* Cc,
             const void* A_log, void* y, void* h_last, const Strides& st,
             int B, int S, int din, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP);
  auto kern = N == NP ? mamba_scan_kernel<T, TD, NP, true>
                      : mamba_scan_kernel<T, TD, NP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((din + kThreads - 1) / kThreads, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const TD*>(dt),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(A_log), static_cast<T*>(y),
      static_cast<float*>(h_last), st, S, din, N);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int launch(const void* u, const void* dt, const void* Bc, const void* Cc,
           const void* A_log, void* y, void* h_last, const Strides& st, int B,
           int S, int din, int N, cudaStream_t s) {
  if (N <= 4)
    return launch_n<T, TD, 4>(u, dt, Bc, Cc, A_log, y, h_last, st, B, S, din,
                              N, s);
  if (N <= 8)
    return launch_n<T, TD, 8>(u, dt, Bc, Cc, A_log, y, h_last, st, B, S, din,
                              N, s);
  if (N <= 16)
    return launch_n<T, TD, 16>(u, dt, Bc, Cc, A_log, y, h_last, st, B, S,
                               din, N, s);
  if (N <= 32)
    return launch_n<T, TD, 32>(u, dt, Bc, Cc, A_log, y, h_last, st, B, S,
                               din, N, s);
  return launch_n<T, TD, kMaxState>(u, dt, Bc, Cc, A_log, y, h_last, st, B,
                                    S, din, N, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 8 element
// strides: (batch, time) of u, dt, Bc and Cc in that order; y (B, S, din)
// and h_last (B, din, N) are contiguous.  dtype is that of u, Bc, Cc and y,
// dt_dtype that of dt: 0 for float32, 1 for bfloat16 (dt is float32 or u's
// type).  Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 = cudaSuccess).
extern "C" int mamba_scan_launch(const void* u, const void* dt,
                                 const void* Bc, const void* Cc,
                                 const void* A_log, void* y, void* h_last,
                                 const long long* strides, int B, int S,
                                 int din, int N, int dtype, int dt_dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0)
    return launch<float, float>(u, dt, Bc, Cc, A_log, y, h_last, st, B, S,
                                din, N, s);
  if (dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float>(u, dt, Bc, Cc, A_log, y, h_last, st,
                                        B, S, din, N, s);
  if (dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, dt, Bc, Cc, A_log, y,
                                                h_last, st, B, S, din, N, s);
  return (int)cudaErrorInvalidValue;
}
