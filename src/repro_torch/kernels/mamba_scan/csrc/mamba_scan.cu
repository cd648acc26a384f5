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
// For training it also writes, when given a `states` buffer, the state
// before every kStateEvery steps (scan.cuh: 16, a quarter of the staged
// chunk): the backward (mamba_scan_bwd.cu) recomputes the steps between
// two of them with the same scan_step (scan.cuh), so its states equal
// these bit for bit.  Without the buffer (inference) the kernel has no
// trace of that output: it runs a chunk's steps as one loop.
// There is no padding: the time loop stops at S, which leaves the same state
// as the reference's ragged tail masked with dt = 0.
//
// Design: a channel's N states and their N values of A log2(e) (computed
// once, not per step) live in fp32 registers, split over a pair of
// neighbouring threads (NP / 2 states each; one thread a channel where
// N <= 4), so twice the warps are in flight for the same exponentials; one
// __shfl_xor_sync a step adds the pair's halves of y.  A block of 128
// threads holds 64 neighbouring channels of one sequence, and the grid is
// (din / 64, B).  Blocks carry nothing between them: the TPU grid's
// sequential chunk axis becomes the time loop inside the block.  The loop
// walks the sequence in chunks of 64 steps: the block stages the chunk's u
// and dt for its channels (consecutive threads on consecutive channels, so
// the loads coalesce; 16 loads in flight a thread) and its B and C rows in
// shared memory, then runs the serial recurrence from there; y is stored at
// once through a running pointer, h_last once at the end.  exp(dt A) is one
// ex2.approx.ftz of dt * (A log2(e)) (a single MUFU.EX2, relative error
// about 2^-22), where expf was a range reduction and fix-ups around one.
//
// What bounds it on this card: at falcon-mamba-7b's prefill shape (B 4,
// S 2048, din 8192, N 16) the function reads and writes about 0.54 GB (u
// and y in bf16, dt in fp32, B, C, h_last), 0.16 ms at 3.35 TB/s, and takes
// B S din N = 1.07e9 exponentials, 0.26 ms at the special-function units'
// 16 a clock per SM: operations, narrowly.  The launch is 512 blocks of 128
// threads and 40 KB of shared memory; registers promise 4 blocks an SM
// (__launch_bounds__) and shared memory 5, so 4 x 132 = 528 >= 512 and the
// grid is resident in one wave (ops.scan_plan).  Each state-step is an
// FMUL (dt A'), the MUFU.EX2, an FMUL (dt u B) and two FFMAs (h, y): the
// state loop's SASS is 118 instructions for 2 steps x 8 states, 7.4 a
// state-step with the steps' shared-memory loads, shuffle and store
// (tools/sass_loop_count.py; the expf version: 14.3), so the issue slots
// (about 0.24 ms at this shape) and the special-function units (0.26 ms)
// bind together.  Evaluating a quarter of the exponentials as a
// polynomial on the FMA pipe was slower, and so were 4 threads a channel
// and 1 (PERF.md).

#include "scan.cuh"

namespace {

using scan::exp2_approx;
using scan::from_f;
using scan::kChunk;
using scan::kLog2e;
using scan::kMaxState;
using scan::kStateEvery;
using scan::to_f;

constexpr int kThreads = 128;   // threads per block
constexpr int kBatch = 16;      // loads in flight per thread while staging

struct Strides {  // element strides of (batch, time); the last axis is 1
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

// Shared memory of a block: u and dt of kChunk steps for its channels,
// and B and C of kChunk steps (rows of NP floats).  ops.scan_plan mirrors it.
size_t smem_bytes(int NP, int split) {
  return sizeof(float) * (2 * (size_t)kChunk * (kThreads / split) +
                          2 * (size_t)kChunk * NP);
}

// NP: N rounded up to the power of two the states are unrolled to, so that
// h[] and A[] stay in registers; states n >= N are skipped.  kFull: N == NP
// (falcon-mamba's 16), compiled without that test in the step loop.
// kSplit: threads a channel (1 or 2); each of kSplit neighbouring threads
// runs NP / kSplit of the channel's states, and __shfl_xor_sync adds their
// parts of y.  kStates: the state before every kStateEvery steps is
// written (training); the inference kernel, without it, has no trace of
// that output.  The second argument of __launch_bounds__ is the blocks an SM is promised by
// the register budget (ops.scan_plan mirrors it).
template <int NT>
constexpr int min_blocks() { return NT <= 16 ? 4 : 2; }

template <typename T, typename TD, int NP, bool kFull, int kSplit,
          bool kStates>
__global__ void __launch_bounds__(kThreads, min_blocks<NP / kSplit>())
mamba_scan_kernel(
    const T* __restrict__ u, const TD* __restrict__ dt,
    const T* __restrict__ Bc, const T* __restrict__ Cc,
    const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_last, float* __restrict__ states, Strides st,
    int S, int din, int N) {
  constexpr int kCh = kThreads / kSplit;   // channels per block
  constexpr int NT = NP / kSplit;          // states per thread
  extern __shared__ float smem[];
  float* su = smem;                        // [kChunk][kCh]
  float* sdt = su + kChunk * kCh;          // [kChunk][kCh]
  float* sb = sdt + kChunk * kCh;          // [kChunk][NP], 16-byte rows
  float* sc = sb + kChunk * NP;            // [kChunk][NP]

  const int tid = threadIdx.x;
  const int cl = tid / kSplit;             // the block's channel
  const int n0 = (tid % kSplit) * NT;      // this thread's first state
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + cl;
  const bool live = d < din;

  // A * log2(e), once per (channel, state): the step's exp(dt A) is then
  // one ex2 of dt * A2.
  float A2[NT], h[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int n = n0 + i;
    A2[i] = (live && n < N) ? -expf(A_log[(long long)d * N + n]) * kLog2e
                            : 0.f;
    h[i] = 0.f;
  }
  const T* ub = u + b * st.u_b + d0;
  const TD* db = dt + b * st.dt_b + d0;
  const T* bb = Bc + b * st.b_b;
  const T* cb = Cc + b * st.c_b;
  T* yp = y + b * (long long)S * din + d;  // y of (b, step, d)

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    // Stage u and dt of the block's channels: consecutive threads take
    // consecutive channels of one step, so the loads coalesce.  Loads go
    // to registers kBatch at a time, all issued before the first store, so
    // a batch costs one round trip to device memory.  Indices past the
    // chunk or the channels are clamped to a valid address; those values
    // are stored as 0 or not at all.
    const int nud = steps * kCh;
    for (int i0 = 0; i0 < nud; i0 += kBatch * kThreads) {
      float uv[kBatch], dv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = min(i0 + j * kThreads + tid, nud - 1);
        const int t = i / kCh, c = min(i % kCh, din - 1 - d0);
        const long long tt = t0 + t;
        uv[j] = to_f(ub[tt * st.u_s + c]);
        dv[j] = to_f(db[tt * st.dt_s + c]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < nud) {
          const bool in = d0 + i % kCh < din;
          su[i] = in ? uv[j] : 0.f;
          sdt[i] = in ? dv[j] : 0.f;
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
    // Every thread runs the recurrence (a thread past din on zeros), so
    // both threads of a pair reach the shuffle; only live ones store.
    // With states, the steps run in segments of kStateEvery, each after
    // the state before it is written; without, the chunk is one segment.
    constexpr int kSeg = kStates ? kStateEvery : kChunk;
    for (int t1 = 0; t1 < steps; t1 += kSeg) {
      if (kStates && live) {
        float* sp = states + ((b * ((S + kStateEvery - 1) / kStateEvery) +
                               (t0 + t1) / kStateEvery) * din + d) *
                                 (long long)N + n0;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          if (n0 + i < N) sp[i] = h[i];
      }
      const int t2 = min(steps, t1 + kSeg);
      for (int t = t1; t < t2; ++t) {
        const float dtv = sdt[t * kCh + cl];
        const float dtu = dtv * su[t * kCh + cl];
        // B and C of this thread's states, four a load (16-byte shared loads)
        const float4* bt = reinterpret_cast<const float4*>(sb + t * NP + n0);
        const float4* ct = reinterpret_cast<const float4*>(sc + t * NP + n0);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NT / 4; ++q) {
          const float4 b4 = bt[q], c4 = ct[q];
          const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = 4 * q + k;
            if (kFull || n0 + i < N) {
              h[i] = scan::scan_step(exp2_approx(dtv * A2[i]), h[i], dtu,
                                     bq[k]);
              acc[k] += h[i] * cq[k];
            }
          }
        }
        float yv = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
        for (int m = 1; m < kSplit; m *= 2)
          yv += __shfl_xor_sync(0xffffffffu, yv, m);
        if (live && n0 == 0) *yp = from_f<T>(yv);
        yp += din;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
  if (live) {
    float* hb = h_last + (b * din + d) * (long long)N + n0;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (n0 + i < N) hb[i] = h[i];
  }
}

template <typename T, typename TD, int NP, int kSplit>
int launch_n(const void* u, const void* dt, const void* Bc, const void* Cc,
             const void* A_log, void* y, void* h_last, void* states,
             const Strides& st, int B, int S, int din, int N,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(NP, kSplit);
  auto kern = N == NP
      ? (states ? mamba_scan_kernel<T, TD, NP, true, kSplit, true>
                : mamba_scan_kernel<T, TD, NP, true, kSplit, false>)
      : (states ? mamba_scan_kernel<T, TD, NP, false, kSplit, true>
                : mamba_scan_kernel<T, TD, NP, false, kSplit, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kCh = kThreads / kSplit;
  dim3 grid((din + kCh - 1) / kCh, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const TD*>(dt),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(A_log), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(states), st, S, din,
      N);
  return (int)cudaGetLastError();
}

// Two threads a channel where NP >= 8, one at NP = 4 (ops.scan_plan).
template <typename T, typename TD, int NP>
int launch_np(const void* u, const void* dt, const void* Bc, const void* Cc,
              const void* A_log, void* y, void* h_last, void* states,
              const Strides& st, int B, int S, int din, int N,
              cudaStream_t s) {
  return launch_n<T, TD, NP, (NP >= 8 ? 2 : 1)>(
      u, dt, Bc, Cc, A_log, y, h_last, states, st, B, S, din, N, s);
}

template <typename T, typename TD>
int launch(const void* u, const void* dt, const void* Bc, const void* Cc,
           const void* A_log, void* y, void* h_last, void* states,
           const Strides& st, int B, int S, int din, int N, cudaStream_t s) {
  auto np = N <= 4    ? launch_np<T, TD, 4>
            : N <= 8  ? launch_np<T, TD, 8>
            : N <= 16 ? launch_np<T, TD, 16>
            : N <= 32 ? launch_np<T, TD, 32>
                      : launch_np<T, TD, kMaxState>;
  return np(u, dt, Bc, Cc, A_log, y, h_last, states, st, B, S, din, N, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 8 element
// strides: (batch, time) of u, dt, Bc and Cc in that order; y (B, S, din)
// and h_last (B, din, N) are contiguous.  `states`, if not null, receives
// the state before every kStateEvery steps, (B, ceil(S / kStateEvery),
// din, N) fp32 contiguous, the first zeros: the backward starts from them.
// dtype is that of u, Bc, Cc and y, dt_dtype that of dt: 0 for float32, 1
// for bfloat16 (dt is float32 or u's type).  Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int mamba_scan_launch(const void* u, const void* dt,
                                 const void* Bc, const void* Cc,
                                 const void* A_log, void* y, void* h_last,
                                 void* states, const long long* strides,
                                 int B, int S, int din, int N, int dtype,
                                 int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0)
    return launch<float, float>(u, dt, Bc, Cc, A_log, y, h_last, states, st,
                                B, S, din, N, s);
  if (dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float>(u, dt, Bc, Cc, A_log, y, h_last,
                                        states, st, B, S, din, N, s);
  if (dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, dt, Bc, Cc, A_log, y,
                                                h_last, states, st, B, S,
                                                din, N, s);
  return (int)cudaErrorInvalidValue;
}
