// Mamba1 selective scan under the reference's mamba_bf16_scan flag, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: under that flag the reference's mamba1_full
// (src/repro/models/mamba.py:128-142, chunk) runs its chunked associative
// scan in bf16 through XLA, where the Pallas kernel
// (src/repro/kernels/mamba_scan/mamba_scan.py:23) computes the fp32
// recurrence.  It is another function, and this kernel computes it.  For
// each chunk of `chunk` steps (C; the time axis from 0), with A = -exp(A_log):
//
//   dA_t = bf16(exp(dt_t A))         dBu_t = bf16((dt_t u_t) B_t)
//   (a_cum, b_cum)_t = the prefix of (dA, dBu) under
//       comb((a1, b1), (a2, b2)) = (a1 a2, b1 a2 + b2), each product and
//       sum rounded to bf16, in the order of jax.lax.associative_scan
//   hs_t = b_cum_t + a_cum_t bf16(h)   (product and sum rounded to bf16)
//   y_t = sum_N hs_t bf16(C_t)         (an fp32 sum of exact products, cast
//                                       once to u's type)
//
// and the carry h is hs at the chunk's last step.  A ragged last chunk is
// walked on to C with identity steps (a = 1, b = 0), as the reference pads
// it with dt = 0; they change only the order in which its carry, h_last, is
// combined.  y comes out in u's type: the reference's einsum rounds to
// bf16 and casts to u's type, and for fp32 u XLA drops that round trip
// and keeps the fp32 sum, as this does.  h_last (B, din, N) is fp32 (a bf16
// value).  With a `states` buffer the kernel also writes hs
// before every kStateEvery = 16 steps (scan.cuh), from which the backward
// (mamba_scan_bwd.cu with kBf16) recomputes the segments between them.
// ref.py's mamba_scan_bf16_plain computes the same with the recursion of
// jax.lax.associative_scan, and is its oracle.
//
// The order: jax's recursion (combine neighbouring pairs, scan those,
// combine the results with the even elements, interleave) gives the prefix
// at step t as the left fold of balanced blocks, the sizes the binary
// digits of t + 1, largest first.  The kernel walks it as a binary counter
// (ref.py's scan_walk_bf16, bit-equal to the recursion): each step is pushed
// as a block of size 1; while the two top blocks have one size they merge,
// comb(lower, upper); level k of the stack holds a block of 2^k steps where
// bit k of the count is set, and beside it the fold of the levels above it
// when it was set, so the prefix of a push that stops at level j is
// comb(that fold, the new block): one comb for the fold and, on average,
// one for the merges a step.  The count is the same for every thread, so
// the level a push stops at is uniform.  The levels live in shared memory
// (4 words a level a thread, log2(C) + 1 levels), reached by index.
//
// Design: one thread walks two neighbouring states of a channel as packed
// bf16 pairs; mul.rn.bf16x2 and add.rn.bf16x2 round each product and each
// sum once (the product of two bf16 values is exact in fp32, and the fp32
// sum of two rounds to the same bf16 as the exact sum, so these equal
// torch's bf16 operations bit for bit; the explicit .rn keeps ptxas from
// fusing them).  A channel takes NP / 2 threads (NP: N rounded up to a
// power of two, at least 2; 8 threads at falcon-mamba's N 16), so a block
// of 128 threads holds 128 / (NP / 2) channels, and the grid is
// (din / channels, B).  y's sum over N is each thread's two exact products
// added in fp32, then the channel's threads' sums by __shfl_xor_sync.  The
// steps go in groups of 8: their exponentials and packing first (no
// dependence on the walk), then the walk, then the 8 sums' shuffles
// together, so that the latencies overlap.  A group that starts with
// levels 0-2 empty (every group where C is a multiple of 8) knows the
// levels its first 7 pushes stop at (0 1 0 2 0 1 0): it keeps their blocks
// and prefixes in registers and touches shared memory once, when its 8th
// push merges its block of 8 into levels 3 and up; any other step takes
// the general push.  (A stack in registers, indexed by constants, cost
// more: the general push then moves every level at every branch, 250
// instructions an exponential, PERF.md.)  The staging is mamba_scan.cu's:
// u, dt, B and C of 64 steps in shared memory (C rounded to bf16 there),
// loads coalesced.  exp is expf, not ex2.approx, so that dA rounds as the
// reference's does.
//
// What bounds it on this card: the bytes are the fp32 scan's (about 0.54
// GB at falcon-mamba-7b's prefill, B 4, S 2048, din 8192, N 16: 0.16 ms at
// 3.35 TB/s) and so are the exponentials (1.07e9, 0.26 ms at the
// special-function units' rate): operations.  This kernel spends more
// issue slots a state-step than the fp32 kernel (the accurate expf, the
// conversions, two combs of three bf16x2 instructions a step for two
// states, the shuffles of y): a simple kernel, right first (PERF.md has
// its time).

#include <cstdint>

#include "scan.cuh"

namespace {

using scan::from_f;
using scan::kMaxState;
using scan::kStateEvery;
using scan::round_bf16;
using scan::to_f;

constexpr int kThreads = 128;       // threads per block
constexpr int kStage = scan::kChunk;  // time steps staged at once (64)
constexpr int kBatch = 16;          // loads in flight per thread while staging
constexpr int kGroup = 8;           // steps whose inputs are made at once
static_assert(kStateEvery % kGroup == 0 && kStage % kGroup == 0,
              "a state's step must start a group");
constexpr uint32_t kOne = 0x3F803F80u;  // the pair (1, 1) in bf16

struct Strides {  // element strides of (batch, time); the last axis is 1
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

// Threads a channel: NP / 2, NP = N rounded up to a power of two, at least
// 2 (ops.bf16_split mirrors it).
int split_of(int N) {
  int np = 2;
  while (np < N) np *= 2;
  return np / 2;
}

// The walk's levels for chunks of `chunk` steps: a push at count c < chunk
// stops at level (the trailing ones of c) <= log2(chunk).
int levels_of(int chunk) {
  int l = 0;
  while ((1 << l) <= chunk) ++l;
  return l;
}

// Shared memory of a block: u and dt of kStage steps for its channels, B
// and C of kStage steps (rows of NP floats), and each thread's walk (4
// words a level).
size_t smem_bytes(int split, int chunk) {
  return sizeof(float) * (2 * (size_t)kStage * (kThreads / split) +
                          2 * (size_t)kStage * 2 * split) +
         sizeof(uint32_t) * 4 * (size_t)levels_of(chunk) * kThreads;
}

// Packed bf16 pairs (the first state in the low half).
__device__ __forceinline__ uint32_t bmul(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t badd(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
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

// comb((a1, b1), (a2, b2)) = (a1 a2, b1 a2 + b2) on packed pairs; (a2, b2)
// becomes the result.
__device__ __forceinline__ void comb(uint32_t a1, uint32_t b1, uint32_t& a2,
                                     uint32_t& b2) {
  b2 = badd(bmul(b1, a2), b2);
  a2 = bmul(a1, a2);
}

// The binary-counter walk of one scan chunk for a thread's pair of states.
// Level k of the stack (its block's (a, b) and the fold of the levels above
// it when it was set, (ga, gb)) lives in shared memory, [level][4][thread]
// words, so any level is reached by its index; the count of steps pushed
// and the prefix (pa, pb) through the last one live in registers.
struct Walk {
  uint32_t* lv;  // this thread's word of field 0 of level 0
  uint32_t pa, pb;
  int cnt;

  __device__ __forceinline__ uint32_t& at(int k, int f) {
    return lv[(4 * k + f) * kThreads];
  }

  // Merge the block (ea, eb), which stands where level k0 would be, into
  // levels k0 ... j - 1 (comb(level, block): the level holds the earlier
  // steps), store it at level j with the fold of the levels above j, and
  // make (pa, pb) the prefix through it.  (fa, fb) is the fold of the
  // levels above k0 - 1, which only j = k0 stores.
  __device__ __forceinline__ void push_from(int k0, int j, uint32_t ea,
                                            uint32_t eb, uint32_t fa,
                                            uint32_t fb) {
    for (int k = k0; k < j; ++k) {
      comb(at(k, 0), at(k, 1), ea, eb);
      fa = at(k, 2);
      fb = at(k, 3);
    }
    at(j, 0) = ea; at(j, 1) = eb; at(j, 2) = fa; at(j, 3) = fb;
    ++cnt;
    if ((cnt >> (j + 1)) != 0) {  // levels above j: the fold comes first
      comb(fa, fb, ea, eb);
    }
    pa = ea; pb = eb;
  }

  // Push one step; the level it stops at, j (the trailing ones of cnt), is
  // the same in every thread.  The fold above level 0 is the prefix.
  __device__ __forceinline__ void push(uint32_t ea, uint32_t eb) {
    push_from(0, __ffs(~cnt) - 1, ea, eb, pa, pb);
  }
};

// kStates: the state before every kStateEvery steps is written (training).
template <typename T, typename TD, bool kStates>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bf16_kernel(
    const T* __restrict__ u, const TD* __restrict__ dt,
    const T* __restrict__ Bc, const T* __restrict__ Cc,
    const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_last, float* __restrict__ states, Strides st,
    int S, int din, int N, int chunk, int split) {
  const int kCh = kThreads / split;        // channels per block
  const int NP = 2 * split;                // states a channel, padded
  extern __shared__ float smem[];
  float* su = smem;                        // [kStage][kCh]
  float* sdt = su + kStage * kCh;          // [kStage][kCh]
  float* sb = sdt + kStage * kCh;          // [kStage][NP]
  float* sc = sb + kStage * NP;            // [kStage][NP], rounded to bf16
  // the walk's levels, [level][4][kThreads] words
  uint32_t* swalk = reinterpret_cast<uint32_t*>(sc + kStage * NP);

  const int tid = threadIdx.x;
  const int cl = tid / split;              // the block's channel
  const int n0 = 2 * (tid % split);        // this thread's first state
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + cl;
  const bool live = d < din;
  // A of the two states (0 past N or din: a = 1, and B and C are 0 there)
  const float A0 = (live && n0 < N) ? -expf(A_log[(long long)d * N + n0])
                                    : 0.f;
  const float A1 = (live && n0 + 1 < N)
                       ? -expf(A_log[(long long)d * N + n0 + 1]) : 0.f;

  const T* ub = u + b * st.u_b + d0;
  const TD* db = dt + b * st.dt_b + d0;
  const T* bb = Bc + b * st.b_b;
  const T* cb = Cc + b * st.c_b;
  T* yp = y + b * (long long)S * din + d;  // y of (b, step, d)
  const int nst = (S + kStateEvery - 1) / kStateEvery;

  Walk w;
  w.lv = swalk + tid;
  w.cnt = 0;
  w.pa = kOne; w.pb = 0u;
  uint32_t h0 = 0u;    // bf16(h) carried into the chunk
  uint32_t hs = 0u;    // the last step's hs

  for (int t0 = 0; t0 < S; t0 += kStage) {
    const int steps = min(kStage, S - t0);
    // Stage u and dt (consecutive threads on consecutive channels of one
    // step, kBatch loads in flight; clamped indices, zeros past din).
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
    // B and C rows of NP states, zeros past N.
    const int nbc = steps * NP;
    for (int i0 = 0; i0 < nbc; i0 += kBatch * kThreads) {
      float bv[kBatch], cv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = min(i0 + j * kThreads + tid, nbc - 1);
        const int t = i / NP, n = min(i - t * NP, N - 1);
        bv[j] = to_f(bb[(long long)(t0 + t) * st.b_s + n]);
        cv[j] = to_f(cb[(long long)(t0 + t) * st.c_s + n]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < nbc) {
          const bool in = i % NP < N;
          sb[i] = in ? bv[j] : 0.f;
          sc[i] = in ? round_bf16(cv[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    // The steps in groups of kGroup: first each step's pair (a, b) and C
    // values (independent of the walk: the exponentials overlap), then the
    // walk, step by step, then y's sums over the channel's threads
    // (kGroup independent shuffle chains).  A group starts on a multiple
    // of kGroup, so the states' steps (every kStateEvery) start groups.
    for (int g0 = 0; g0 < steps; g0 += kGroup) {
      const int gn = min(kGroup, steps - g0);
      if (kStates && live && (t0 + g0) % kStateEvery == 0) {
        float* sp = states + ((b * nst + (t0 + g0) / kStateEvery) * din + d) *
                                 (long long)N + n0;
        if (n0 < N) sp[0] = lo_f(hs);
        if (n0 + 1 < N) sp[1] = hi_f(hs);
      }
      uint32_t ea[kGroup], eb[kGroup];
      float2 cg[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int t = min(g0 + u, steps - 1);  // past gn: read, not used
        const float dtv = sdt[t * kCh + cl];
        const float dtu = __fmul_rn(dtv, su[t * kCh + cl]);
        const float2 b2 = *reinterpret_cast<const float2*>(sb + t * NP + n0);
        cg[u] = *reinterpret_cast<const float2*>(sc + t * NP + n0);
        ea[u] = pack(expf(__fmul_rn(dtv, A0)), expf(__fmul_rn(dtv, A1)));
        eb[u] = pack(__fmul_rn(dtu, b2.x), __fmul_rn(dtu, b2.y));
      }
      float yv[kGroup];
      auto out = [&](int u, uint32_t a, uint32_t b) {
        // hs and this thread's part of y at step u, from its prefix (a, b)
        hs = badd(b, bmul(a, h0));
        yv[u] = __fmaf_rn(lo_f(hs), cg[u].x, __fmul_rn(hi_f(hs), cg[u].y));
      };
      if (gn == kGroup && (w.cnt & (kGroup - 1)) == 0 &&
          w.cnt + kGroup <= chunk) {
        // A whole group from empty levels 0-2: its first 7 pushes stop at
        // levels 0 1 0 2 0 1 0, so their blocks and prefixes stay in
        // registers; the 8th merges the group's block of 8 into levels 3
        // and up.  (Pa, Pb): the fold of the levels above 2, the prefix
        // so far, which comes first where any is set.
        const uint32_t Pa = w.pa, Pb = w.pb;
        const bool up = w.cnt != 0;
        uint32_t pa = ea[0], pb = eb[0];
        if (up) comb(Pa, Pb, pa, pb);
        out(0, pa, pb);
        uint32_t a01 = ea[1], b01 = eb[1];            // steps 0-1
        comb(ea[0], eb[0], a01, b01);
        pa = a01; pb = b01;
        if (up) comb(Pa, Pb, pa, pb);
        out(1, pa, pb);
        uint32_t qa = pa, qb = pb;                    // the prefix through 1
        pa = ea[2]; pb = eb[2];
        comb(qa, qb, pa, pb);
        out(2, pa, pb);
        uint32_t a03 = ea[3], b03 = eb[3];            // steps 0-3
        comb(ea[2], eb[2], a03, b03);
        comb(a01, b01, a03, b03);
        pa = a03; pb = b03;
        if (up) comb(Pa, Pb, pa, pb);
        out(3, pa, pb);
        qa = pa; qb = pb;                             // the prefix through 3
        pa = ea[4]; pb = eb[4];
        comb(qa, qb, pa, pb);
        out(4, pa, pb);
        uint32_t a45 = ea[5], b45 = eb[5];            // steps 4-5
        comb(ea[4], eb[4], a45, b45);
        pa = a45; pb = b45;
        comb(qa, qb, pa, pb);
        out(5, pa, pb);
        qa = pa; qb = pb;                             // the prefix through 5
        pa = ea[6]; pb = eb[6];
        comb(qa, qb, pa, pb);
        out(6, pa, pb);
        uint32_t xa = ea[7], xb = eb[7];              // steps 0-7
        comb(ea[6], eb[6], xa, xb);
        comb(a45, b45, xa, xb);
        comb(a03, b03, xa, xb);
        w.cnt += kGroup - 1;
        w.push_from(3, __ffs(~w.cnt) - 1, xa, xb, Pa, Pb);
        out(7, w.pa, w.pb);
        if (w.cnt == chunk) {  // the chunk's carry
          h0 = hs;
          w.cnt = 0;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          yv[u] = 0.f;
          if (u < gn) {
            w.push(ea[u], eb[u]);
            out(u, w.pa, w.pb);
            if (w.cnt == chunk) {  // the chunk's carry
              h0 = hs;
              w.cnt = 0;
            }
          }
        }
      }
      for (int m = 1; m < split; m *= 2) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          yv[u] += __shfl_xor_sync(0xffffffffu, yv[u], m);
      }
      if (live && n0 == 0) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (u < gn) yp[(long long)u * din] = from_f<T>(yv[u]);
      }
      yp += (long long)gn * din;
    }
    __syncthreads();  // the next stage overwrites the staged rows
  }
  if (w.cnt != 0) {  // a ragged last chunk: identity steps to its end
    while (w.cnt < chunk) w.push(kOne, 0u);
    hs = badd(w.pb, bmul(w.pa, h0));
  }
  if (live) {
    float* hb = h_last + (b * din + d) * (long long)N + n0;
    if (n0 < N) hb[0] = lo_f(hs);
    if (n0 + 1 < N) hb[1] = hi_f(hs);
  }
}

template <typename T, typename TD>
int launch(const void* u, const void* dt, const void* Bc, const void* Cc,
           const void* A_log, void* y, void* h_last, void* states,
           const Strides& st, int B, int S, int din, int N, int chunk,
           cudaStream_t stream) {
  const int split = split_of(N);
  const size_t smem = smem_bytes(split, chunk);
  auto kern = states ? mamba_scan_bf16_kernel<T, TD, true>
                     : mamba_scan_bf16_kernel<T, TD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int kCh = kThreads / split;
  dim3 grid((din + kCh - 1) / kCh, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const TD*>(dt),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(A_log), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(states), st, S, din,
      N, chunk, split);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes), mamba_scan_launch's arguments
// and layouts with the chunk length `chunk` (1 to 65,536) before the
// dtypes: `strides` holds 8 element strides, (batch, time) of u, dt, Bc
// and Cc; y (B, S, din) in u's type and h_last (B, din, N) fp32 are
// contiguous; `states`, if not null, receives hs before every kStateEvery
// steps, (B, ceil(S / kStateEvery), din, N) fp32 contiguous, the first
// zeros.  dtype is that of u, Bc, Cc and y, dt_dtype that of dt: 0 for
// float32, 1 for bfloat16.  Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int mamba_scan_bf16_launch(const void* u, const void* dt,
                                      const void* Bc, const void* Cc,
                                      const void* A_log, void* y,
                                      void* h_last, void* states,
                                      const long long* strides, int B, int S,
                                      int din, int N, int chunk, int dtype,
                                      int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 ||
      N > kMaxState || chunk <= 0 || chunk > 65536)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0)
    return launch<float, float>(u, dt, Bc, Cc, A_log, y, h_last, states, st,
                                B, S, din, N, chunk, s);
  if (dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float>(u, dt, Bc, Cc, A_log, y, h_last,
                                        states, st, B, S, din, N, chunk, s);
  if (dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, dt, Bc, Cc, A_log, y,
                                                h_last, states, st, B, S,
                                                din, N, chunk, s);
  return (int)cudaErrorInvalidValue;
}
