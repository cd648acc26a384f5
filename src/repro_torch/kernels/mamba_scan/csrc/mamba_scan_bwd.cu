// Backward of the Mamba1 selective scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains falcon-mamba by XLA's
// autodiff of its chunked associative scan (src/repro/models/mamba.py:128-
// 144), and the TPU kernel (src/repro/kernels/mamba_scan/mamba_scan.py:23)
// has no backward.  The port's forward runs on mamba_scan.cu, which autograd
// cannot see through, so this kernel is the gradient of that function.
// With A = -exp(A_log), a_t = exp(dt_t A) and g_t the gradient reaching the
// state h_t, it walks the sequence backwards:
//
//   g_t = dy_t C_t + a_{t+1} g_{t+1}      (the last g gets dh_last too)
//   du_t = dt_t sum_n g_t B_t
//   ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1})
//   dB_t = sum_d g_t dt_t u_t             dC_t = sum_d dy_t h_t
//   dA_log = A sum_{b,t} g_t dt_t a_t h_{t-1}
//
// (ref.py's mamba_scan_bwd_plain computes the same in fp32 and is its
// oracle).  Inputs are the forward's: u/dt (B, S, din), B/C (B, S, N) with
// any batch and time strides and the last axis contiguous, A_log (din, N)
// fp32; and the forward's states (B, ceil(S / 64), din, N) fp32, h before
// each chunk of 64 steps; dy (B, S, din) in u's type and dh_last (B, din,
// N) fp32 or null, contiguous.  du comes out in u's type, ddt in dt's; dB
// and dC as per-block partials (B, S, blocks, N) fp32 and dA_log as
// per-sequence partials (B, din, N) fp32, which the wrapper sums with torch.
// No float atomics: every sum runs in a fixed order, so two calls on the
// same inputs give the same bits.
//
// Design: the grid and the channels of a block are the forward's where
// N <= 16 (falcon-mamba's 16: 128 threads, 64 channels a block, two
// threads a channel, 8 states each; grid (din / 64, B)); above 16 states a
// channel takes NP / 8 threads, so that a thread always holds at most 8
// states and the shared buffers below stay the same size.  g, the carry
// a_{t+1} g_{t+1} and the dA_log sums stay in registers for the whole
// sequence.  The block walks the chunks from the last to the first.  Each
// step needs h_t and h_{t-1}, so a chunk is recomputed from its saved state
// with the forward's own operations (scan.cuh's scan_step, one ex2.approx
// of dt A log2 e): all 64 steps x 64 channels x 16 states in fp32 would be
// 256 KB, past a block's 227 KB, so the chunk is cut into sub-chunks of
// kSub = 8 steps.  A first pass over the chunk keeps the state before each
// sub-chunk (8 x 4 KB); then, from the last sub-chunk to the first, its 8
// states are recomputed into shared memory (8 x 4 KB, each thread's own
// slots, laid out so a warp's stores hit 32 banks) and walked in reverse.
// Per block that is 75 KB of shared memory, so 3 blocks an SM, where
// 16-step sub-chunks would take 16 KB + 64 KB (two an SM); the price is
// the first pass, about 7/8 of a chunk's steps again.  Each sub-chunk's u, dt,
// dy and B, C rows are staged in shared memory.  du_t and ddt_t are summed
// over a channel's threads with __shfl_xor_sync; dB_t and dC_t over the
// block's channels in a fixed order: a halving butterfly of shuffles over
// the lanes of a warp (each lane ends with the sum of a state of dB or dC),
// then the 4 warps' sums in order from shared memory.
//
// What bounds it on this card: at falcon-mamba-7b's training shape (B 4,
// S 4096, din 8192, N 16; u, dy, du in bf16, dt and ddt in fp32) the
// function reads u, dt, dy, B, C, A_log and the states and writes du, ddt,
// dB, dC and dA_log, about 2.0 GB, 0.60 ms at 3.35 TB/s; it needs
// B S din N = 2.15e9 exponentials, 0.51 ms at the special-function units'
// 16 a clock per SM: bytes, narrowly.  This design is far from that: it
// evaluates about 2.9 exponentials a state-step (the first pass, the
// recompute, the walk), and its SASS is 26 instructions a state-step in
// the walk (the dB/dC butterfly's shuffles and selects among them) and 6.1
// in each forward pass (tools/sass_loop_count.py), about 2.4 ms of the
// warp schedulers at this shape; 512 blocks at 3 an SM take two rounds.
// Each stage of a sub-chunk is loaded with every load in flight at once,
// while the stage before it computes.  PERF.md has the measured time.

#include "scan.cuh"

namespace {

using scan::exp2_approx;
using scan::from_f;
using scan::kChunk;
using scan::kLog2e;
using scan::kMaxState;
using scan::to_f;

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;         // steps recomputed into shared memory at once
constexpr int kNSub = kChunk / kSub;

struct Strides {  // element strides of (batch, time); the last axis is 1
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

// Threads a channel: one at NP = 4, two at 8 and 16 (the forward's), NP / 8
// above, so that a thread holds at most 8 states.  ops.bwd_plan mirrors it.
__host__ __device__ constexpr int split_of(int NP) {
  return NP <= 4 ? 1 : NP <= 16 ? 2 : NP / 8;
}

// Shared memory of a block (floats): u, dt, dy of a sub-chunk for its
// channels; B and C rows of a sub-chunk; the sub-chunk start states; the
// sub-chunk's recomputed states; the warps' dB/dC sums of a sub-chunk.
// ops.bwd_plan mirrors it.
__host__ __device__ constexpr size_t smem_floats(int NP) {
  return 3 * (size_t)kSub * (kThreads / split_of(NP)) + 2 * (size_t)kSub * NP +
         (size_t)(kNSub + kSub) * kThreads * (NP / split_of(NP)) +
         (size_t)kSub * kWarps * 2 * NP;
}

// The blocks an SM is promised by the register budget: 168 registers a
// thread (at 4, the 128 left one-thread-a-channel variants spilling).
constexpr int kMinBlocks = 3;

// Sums, over the lanes of a warp that differ in the bits M, 2M, ... 16,
// the K values v[] each lane holds: a halving butterfly, each level
// sending half the values to the partner lane and adding the half it
// receives, so that after log2(K) levels each lane holds the sum of
// K >> levels values, those from index `base` on.  Levels left over when
// one value is left add it across the lanes (every lane of such a pair
// holds the same sum).  The order of every sum is fixed.
template <int K, int M>
__device__ __forceinline__ void fold(float* v, int lane, int& base) {
  if constexpr (M < 32) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) base += H;
      fold<H, 2 * M>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      fold<1, 2 * M>(v, lane, base);
    }
  }
}

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x / 2);
}

// One forward step of a thread's NT states from the staged row j: the
// forward kernel's operations exactly.
template <int NP, int NT, bool kFull>
__device__ __forceinline__ void forward_step(
    float (&h)[NT], const float (&A2)[NT], const float* su, const float* sdt,
    const float* sb, int kCh, int cl, int n0, int j, int N) {
  const float dtv = sdt[j * kCh + cl];
  const float dtu = dtv * su[j * kCh + cl];
  const float4* bt = reinterpret_cast<const float4*>(sb + j * NP + n0);
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
    const float4 b4 = bt[q];
    const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * q + k;
      if (kFull || n0 + i < N)
        h[i] = scan::scan_step(exp2_approx(dtv * A2[i]), h[i], dtu, bq[k]);
    }
  }
}

template <typename T, typename TD, int NP, bool kFull, int kSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_bwd_kernel(
    const T* __restrict__ u, const TD* __restrict__ dt,
    const T* __restrict__ Bc, const T* __restrict__ Cc,
    const float* __restrict__ A_log, const float* __restrict__ states,
    const T* __restrict__ dy, const float* __restrict__ dh_last,
    T* __restrict__ du, TD* __restrict__ ddt, float* __restrict__ dBp,
    float* __restrict__ dCp, float* __restrict__ dAp, Strides st, int S,
    int din, int N) {
  constexpr int kCh = kThreads / kSplit;   // channels per block
  constexpr int NT = NP / kSplit;          // states per thread
  constexpr int K = 2 * NT;                // dB and dC terms a step
  // the lane bits that tell a warp's channels apart: kSplit ... 16
  constexpr int kHalve = log2_of(32 / kSplit) < log2_of(K)
                             ? log2_of(32 / kSplit) : log2_of(K);
  constexpr int kKeep = K >> kHalve;       // sums a lane keeps
  constexpr unsigned kDup = 31u & ~((unsigned)(kSplit << kHalve) - 1u);
  extern __shared__ float smem[];
  float* su = smem;                        // [kSub][kCh]
  float* sdt = su + kSub * kCh;            // [kSub][kCh]
  float* sdy = sdt + kSub * kCh;           // [kSub][kCh]
  float* sb = sdy + kSub * kCh;            // [kSub][NP], 16-byte rows
  float* sc = sb + kSub * NP;              // [kSub][NP]
  float* ckpt = sc + kSub * NP;            // [kNSub][NT][kThreads]
  float* hbuf = ckpt + kNSub * NT * kThreads;  // [kSub][NT][kThreads]
  float* red = hbuf + kSub * NT * kThreads;    // [kSub][kWarps][2][NP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kSplit;             // the block's channel
  const int n0 = (tid % kSplit) * NT;      // this thread's first state
  const long long b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * kCh;
  const int d = d0 + cl;
  const bool live = d < din;
  const int nch = (S + kChunk - 1) / kChunk;

  // A log2(e) (the forward's value, bit for bit); A itself is A2 ln 2
  float A2[NT], carry[NT], dA[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int n = n0 + i;
    const bool ok = live && n < N;
    A2[i] = ok ? -expf(A_log[(long long)d * N + n]) * kLog2e : 0.f;
    carry[i] = (ok && dh_last != nullptr)
                   ? dh_last[(b * din + d) * (long long)N + n] : 0.f;
    dA[i] = 0.f;
  }
  const T* ub = u + b * st.u_b + d0;
  const TD* db = dt + b * st.dt_b + d0;
  const T* yb = dy + b * (long long)S * din + d0;
  const T* bb = Bc + b * st.b_b;
  const T* cb = Cc + b * st.c_b;

  // A stage: `steps` steps from ts of u, dt (and dy) of the block's
  // channels and of the B (and C) rows, channels past din and states past
  // N as zeros.  fetch loads a thread's share into registers, every load
  // in flight at once, in the inputs' own types; commit converts it and
  // stores it to shared memory.  Each stage is fetched while the one
  // before it computes, so its loads' round trip to device memory hides
  // behind that work (nothing reads a loaded register before commit).
  constexpr int kPer = kSub * kCh / kThreads;                  // u, dt, dy
  constexpr int kPerBC = (kSub * NP + kThreads - 1) / kThreads;   // B, C
  T fu[kPer], fdy[kPer], fb[kPerBC], fc[kPerBC];
  TD fdt[kPer];
  const T zero = from_f<T>(0.f);
  const TD zero_d = from_f<TD>(0.f);
  auto fetch = [&](int ts, int steps, bool reverse) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int t = i / kCh, c = i - t * kCh;
      const long long tt = ts + t;
      const bool in = t < steps && d0 + c < din;
      fu[k] = in ? ub[tt * st.u_s + c] : zero;
      fdt[k] = in ? db[tt * st.dt_s + c] : zero_d;
      fdy[k] = in && reverse ? yb[tt * din + c] : zero;
    }
#pragma unroll
    for (int k = 0; k < kPerBC; ++k) {
      const int i = tid + k * kThreads;
      const int t = i / NP, n = i - t * NP;
      const long long tt = ts + t;
      const bool in = t < steps && n < N;
      fb[k] = in ? bb[tt * st.b_s + n] : zero;
      fc[k] = in && reverse ? cb[tt * st.c_s + n] : zero;
    }
  };
  auto commit = [&]() {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      su[i] = to_f(fu[k]);
      sdt[i] = to_f(fdt[k]);
      sdy[i] = to_f(fdy[k]);
    }
#pragma unroll
    for (int k = 0; k < kPerBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < kSub * NP) {
        sb[i] = to_f(fb[k]);
        sc[i] = to_f(fc[k]);
      }
    }
  };
  // A chunk of n sub-chunks takes 2n - 1 stages: k < n - 1 forward (the
  // first pass, sub-chunk k), then the sub-chunks n - 1 ... 0 in reverse.
  auto nsub_of = [&](int c) {
    return (min(kChunk, S - c * kChunk) + kSub - 1) / kSub;
  };
  auto fetch_stage = [&](int c, int k) {
    const int n = nsub_of(c), steps = min(kChunk, S - c * kChunk);
    const bool reverse = k >= n - 1;
    const int sub = reverse ? 2 * n - 2 - k : k;
    fetch(c * kChunk + sub * kSub, min(kSub, steps - sub * kSub), reverse);
  };

  fetch_stage(nch - 1, 0);
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, S - t0);
    const int nsub = nsub_of(c);
    // The state before each sub-chunk, from the chunk's saved one.
    float h[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      h[i] = (live && n0 + i < N)
                 ? states[((b * nch + c) * din + d) * (long long)N + n0 + i]
                 : 0.f;
    for (int k = 0; k < 2 * nsub - 1; ++k) {
      const bool reverse = k >= nsub - 1;
      const int s = reverse ? 2 * nsub - 2 - k : k;
      if (k < nsub) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
          ckpt[(k * NT + i) * kThreads + tid] = h[i];
      }
      __syncthreads();  // the staged rows' and red's last readers are done
      commit();
      __syncthreads();
      if (k + 1 < 2 * nsub - 1)
        fetch_stage(c, k + 1);
      else if (c > 0)
        fetch_stage(c - 1, 0);
      if (!reverse) {
        for (int j = 0; j < kSub; ++j)
          forward_step<NP, NT, kFull>(h, A2, su, sdt, sb, kCh, cl, n0, j, N);
        continue;
      }
      // The sub-chunk s from the last: recompute, then walk back.
      const int ts = t0 + s * kSub;
      const int ss = min(kSub, steps - s * kSub);
#pragma unroll
      for (int i = 0; i < NT; ++i) h[i] = ckpt[(s * NT + i) * kThreads + tid];
      for (int j = 0; j < ss; ++j) {
        forward_step<NP, NT, kFull>(h, A2, su, sdt, sb, kCh, cl, n0, j, N);
#pragma unroll
        for (int i = 0; i < NT; ++i) hbuf[(j * NT + i) * kThreads + tid] = h[i];
      }
      // h holds h_t of the walk's step; hp gets h_{t-1}
      for (int j = ss - 1; j >= 0; --j) {
        const long long t = ts + j;
        const float dtv = sdt[j * kCh + cl], uv = su[j * kCh + cl];
        const float dyv = sdy[j * kCh + cl];
        const float dtu = dtv * uv;
        const float* src = j > 0 ? hbuf + (j - 1) * NT * kThreads
                                 : ckpt + s * NT * kThreads;
        float hp[NT], v[K];
#pragma unroll
        for (int i = 0; i < NT; ++i) hp[i] = src[i * kThreads + tid];
        float gb = 0.f, gah_a = 0.f;   // sum_n g B, sum_n g a h_{t-1} A2
        const float4* bt = reinterpret_cast<const float4*>(sb + j * NP + n0);
        const float4* ct = reinterpret_cast<const float4*>(sc + j * NP + n0);
#pragma unroll
        for (int q = 0; q < NT / 4; ++q) {
          const float4 b4 = bt[q], c4 = ct[q];
          const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = 4 * q + k;
            if (kFull || n0 + i < N) {
              const float a = exp2_approx(dtv * A2[i]);
              const float g = dyv * cq[k] + carry[i];
              v[i] = g * dtu;              // dB
              v[NT + i] = dyv * h[i];      // dC
              gb += g * bq[k];
              const float gah = g * a * hp[i];
              gah_a += gah * A2[i];
              dA[i] += gah * dtv;
              carry[i] = a * g;
            } else {
              v[i] = v[NT + i] = 0.f;
            }
          }
        }
#pragma unroll
        for (int m = 1; m < kSplit; m *= 2) {
          gb += __shfl_xor_sync(0xffffffffu, gb, m);
          gah_a += __shfl_xor_sync(0xffffffffu, gah_a, m);
        }
        if (live && n0 == 0) {
          du[(b * S + t) * din + d] = from_f<T>(dtv * gb);
          ddt[(b * S + t) * din + d] = from_f<TD>(uv * gb + gah_a * kLn2);
        }
        // dB and dC over the warp's channels, then into red by warp
        int base = 0;
        fold<K, kSplit>(v, lane, base);
        if ((lane & kDup) == 0) {
#pragma unroll
          for (int i = 0; i < kKeep; ++i) {
            const int idx = base + i, q = idx / NT;
            red[((j * kWarps + warp) * 2 + q) * NP + n0 + idx % NT] = v[i];
          }
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) h[i] = hp[i];
      }
      __syncthreads();
      // the block's dB and dC of the sub-chunk: the warps' sums in order
      for (int i = tid; i < ss * 2 * N; i += kThreads) {
        const int j = i / (2 * N), r = i - j * 2 * N;
        const int q = r / N, n = r - q * N;
        const float* rp = red + (j * kWarps * 2 + q) * NP + n;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += rp[w * 2 * NP];
        (q ? dCp : dBp)[((b * S + ts + j) * nblk + blk) * (long long)N + n] =
            acc;
      }
    }
  }
  if (live) {
    float* ap = dAp + (b * din + d) * (long long)N + n0;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (n0 + i < N) ap[i] = A2[i] * kLn2 * dA[i];
  }
}

struct Args {
  const void *u, *dt, *Bc, *Cc, *A_log, *states, *dy, *dh_last;
  void *du, *ddt, *dBp, *dCp, *dAp;
};

template <typename T, typename TD, int NP>
int launch_np(const Args& a, const Strides& st, int B, int S, int din, int N,
              cudaStream_t stream) {
  constexpr int kSplit = split_of(NP);
  const size_t smem = sizeof(float) * smem_floats(NP);
  auto kern = N == NP ? mamba_scan_bwd_kernel<T, TD, NP, true, kSplit>
                      : mamba_scan_bwd_kernel<T, TD, NP, false, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kCh = kThreads / kSplit;
  dim3 grid((din + kCh - 1) / kCh, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.u), static_cast<const TD*>(a.dt),
      static_cast<const T*>(a.Bc), static_cast<const T*>(a.Cc),
      static_cast<const float*>(a.A_log), static_cast<const float*>(a.states),
      static_cast<const T*>(a.dy), static_cast<const float*>(a.dh_last),
      static_cast<T*>(a.du), static_cast<TD*>(a.ddt),
      static_cast<float*>(a.dBp), static_cast<float*>(a.dCp),
      static_cast<float*>(a.dAp), st, S, din, N);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int launch(const Args& a, const Strides& st, int B, int S, int din, int N,
           cudaStream_t s) {
  auto np = N <= 4    ? launch_np<T, TD, 4>
            : N <= 8  ? launch_np<T, TD, 8>
            : N <= 16 ? launch_np<T, TD, 16>
            : N <= 32 ? launch_np<T, TD, 32>
                      : launch_np<T, TD, kMaxState>;
  return np(a, st, B, S, din, N, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 8 element
// strides: (batch, time) of u, dt, Bc and Cc in that order.  states (B,
// ceil(S / 64), din, N) fp32 (mamba_scan_launch's), dy (B, S, din) in u's
// type and dh_last (B, din, N) fp32 (or null) are contiguous, as are the
// outputs du (B, S, din) in u's type, ddt (B, S, din) in dt's, dBp and dCp
// (B, S, blocks, N) fp32 (blocks: the grid's x extent, ops.bwd_plan) and
// dAp (B, din, N) fp32.  dtype is that of u, Bc, Cc, dy and du, dt_dtype
// that of dt and ddt: 0 for float32, 1 for bfloat16.  Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t
// (0 = cudaSuccess).
extern "C" int mamba_scan_bwd_launch(
    const void* u, const void* dt, const void* Bc, const void* Cc,
    const void* A_log, const void* states, const void* dy,
    const void* dh_last, void* du, void* ddt, void* dBp, void* dCp,
    void* dAp, const long long* strides, int B, int S, int din, int N,
    int dtype, int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 ||
      N > kMaxState || states == nullptr)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Args a{u, dt, Bc, Cc, A_log, states, dy, dh_last,
               du, ddt, dBp, dCp, dAp};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0)
    return launch<float, float>(a, st, B, S, din, N, s);
  if (dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float>(a, st, B, S, din, N, s);
  if (dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, st, B, S, din, N, s);
  return (int)cudaErrorInvalidValue;
}
