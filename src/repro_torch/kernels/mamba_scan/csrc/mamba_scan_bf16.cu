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
// the level a push stops at is uniform.  The levels live in shared memory,
// reached by index (below).
//
// Design (an earlier one walked one pair a thread): one thread walks
// kPairs = 4 packed bf16 pairs of neighbouring states, 8 states of a
// channel; mul.rn.bf16x2 and add.rn.bf16x2 round each product and each sum
// once (the product of two bf16 values is exact in fp32, and the fp32 sum
// of two rounds to the same bf16 as the exact sum, so these equal torch's
// bf16 operations bit for bit; the explicit .rn keeps ptxas from fusing
// them).  A channel takes NP / 8 threads where NP >= 16 (NP: N rounded up
// to a power of two; two at falcon-mamba's N 16, as in the fp32 scan), one
// below, so a block of 128 threads holds 64 channels at N 16 and the grid
// is (din / 64, B).  What does not depend on the state is paid once for 8
// states: (dt, dt u) from shared memory (dt u formed once, while
// staging), the loop and store bookkeeping, and y's shuffles (one
// __shfl_xor_sync at N 16); and a thread has four independent chains of
// combs to hide their latency with.  y's sum over N: each pair's two exact
// products added in fp32, fma(lo, C_lo, hi C_hi), the thread's pairs in
// the tree (p0 + p1) + (p2 + p3) that the shuffles formed when a thread
// had one pair, then the channel's threads' sums by __shfl_xor_sync; fp32
// addition is commutative, so every output (y, h_last, the states) equals
// the one-pair kernel's bit for bit.  The decays are bf16(expf(dt A)),
// two a conversion (scan.cuh's decay2).  The steps go in groups of 8:
// their decays first (no dependence on the walk, so the exponentials
// overlap), then the walk,
// each step's dt u B made where the walk reaches it, then the 8 sums'
// shuffles together.  A group that starts with levels 0-2 empty (every
// group where C is a multiple of 8) knows the levels its first 7 pushes
// stop at (0 1 0 2 0 1 0): it keeps their blocks and prefixes in registers
// and touches shared memory once, when its 8th push merges its block of 8
// into levels 3 and up; any other step takes the general push.  Where C is
// a multiple of 8 every group is whole: a ragged last group, and the
// chunk's end after it, are padded with identity steps (a = 1, b = 0) as
// the reference pads, so levels 0-2 never reach shared memory and get
// none.  The top level, log2(C), is set once a chunk and never read (a
// push reads only the levels below the one it stops at): it is not
// stored either.  The levels in shared memory: a uint4 (a, b, ga, gb) a
// level, pair and thread, [level][pair][thread], 16 bytes apart, reached
// by index.  (A stack in registers, indexed by constants, cost more: the
// general push then moves every level at every branch, 250 instructions
// an exponential, PERF.md.)  The staging is mamba_scan.cu's over 16 steps:
// (dt, dt u) and rows of split x 8 B and C values (C rounded to bf16
// there) in shared memory, loads coalesced, two B and C loads a thread
// (8, clamped duplicates past the rows, cost a tenth of the time) and the
// rows' indices by shifts (a division by a width known only at run time
// cost another).  Shared memory at falcon-mamba's prefill (N 16, C 256):
// 5 levels x 4 pairs x 128 threads x 16 bytes + 8 KB of (dt, dt u) + 2 KB
// of rows = 50 KB, so 4 blocks an SM, with registers held to 128
// (__launch_bounds__; ptxas uses 127-128, no spills): the 512 blocks are
// resident at once on 132 SMs (ops.bf16_plan).  With 64-step stages
// (88 KB) only 2 fitted: 1.94 waves, 5 % slower.
//
// What bounds it on this card: the bf16 function's own bytes are the fp32
// scan's (about 0.54 GB at falcon-mamba-7b's prefill, B 4, S 2048, din
// 8192, N 16: 0.16 ms at 3.35 TB/s) and so are its exponentials (1.07e9,
// 0.26 ms at the special-function units' rate): operations, 0.2568 ms.
// On "NVIDIA H100 80GB HBM3, 700.00 W" this kernel takes 1.229-1.239 ms
// there (0.21 of the bound; the one-pair kernel 2.097-2.166 in the same
// run, PERF.md): 25.7 SASS a state-step against the one-pair kernel's
// 45.5 (MUFU 1.0, conversions 1.1, bf16x2 5.7, fp32 9.6, integer 5.8,
// shared memory 1.3; tools/scan_bf16_probe.py --sass).  The staging still
// costs about a sixth (staged once and reused, with wrong results, it took
// 1.00 ms; loads fetched a stage ahead into registers gained 2 % and
// spilled): the walk's bf16x2 chains, the conversions and the issue slots
// bind it, not the exponentials (ex2.approx in the place of expf, wrong
// bits, took 13 % less before the staging's repair; an ex2.approx behind
// a guard that kept expf's bits took 3 % less here and 4 % more in the
// backward, and was dropped, PERF.md).

#include <cstdint>

#include "scan.cuh"

namespace {

using scan::from_f;
using scan::hi_f;
using scan::kMaxState;
using scan::kStateEvery;
using scan::lo_f;
using scan::pack_bf16x2;
using scan::round_bf16;
using scan::to_f;

constexpr int kThreads = 128;       // threads per block
constexpr int kStage = 16;          // time steps staged at once
constexpr int kBatch = 8;           // (u, dt) loads in flight a thread, staging
constexpr int kBatchBC = 2;         // B and C loads in flight a thread
constexpr int kGroup = 8;           // steps whose inputs are made at once
constexpr int kLow = 3;             // the whole-group path's levels: log2(kGroup)
constexpr int kPairs = 4;           // packed pairs of states a thread walks
// The blocks an SM the register budget promises (ops.BF16_MIN_BLOCKS).
constexpr int kMinBlocks = 4;
static_assert(kStateEvery % kGroup == 0 && kStage % kGroup == 0,
              "a state's step must start a group");
static_assert(kGroup == 1 << kLow, "kLow is log2(kGroup)");
constexpr uint32_t kOne = 0x3F803F80u;  // the pair (1, 1) in bf16

struct Strides {  // element strides of (batch, time); the last axis is 1
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

// NP: N rounded up to a power of two, at least 2.  Threads a channel:
// NP / 8 where NP >= 16 (each walks kPairs pairs, 8 states), else 1, which
// walks the NP / 2 pairs there are (the rest of its kPairs run on zeros).
// ops.bf16_plan mirrors these.
__host__ __device__ int np_of(int N) {
  int np = 2;
  while (np < N) np *= 2;
  return np;
}
__host__ __device__ int split_of(int N) {
  return np_of(N) <= 2 * kPairs ? 1 : np_of(N) / 8;
}
__host__ __device__ int pairs_of(int N) {
  return np_of(N) / 2 < kPairs ? np_of(N) / 2 : kPairs;
}

// The walk's levels for chunks of `chunk` steps: a push at count c < chunk
// stops at level (the trailing ones of c) <= log2(chunk), the top level;
// a push reads only levels below the one it stops at, so the top level,
// set once a chunk, is never read and never stored.  Shared memory holds
// the levels from lvl0 up to the top one: kLow where chunk is a multiple
// of kGroup (every group then takes the whole-group path, whose levels
// below kLow stay in registers), else 0.
__host__ __device__ int top_of(int chunk) {
  int l = 0;
  while ((2 << l) <= chunk) ++l;
  return l;
}
__host__ __device__ int lvl0_of(int chunk) {
  return chunk % kGroup == 0 ? kLow : 0;
}
__host__ __device__ int stored_of(int chunk) {
  return top_of(chunk) > lvl0_of(chunk) ? top_of(chunk) - lvl0_of(chunk) : 0;
}

// Shared memory of a block (ops.bf16_plan mirrors it): the walk's levels
// (a uint4 a level, pair and thread), (dt, dt u) of kStage steps for its
// channels, and B and C of kStage steps (rows of split x 8 floats).
size_t smem_bytes(int N, int chunk) {
  const int split = split_of(N);
  return sizeof(uint4) * (size_t)stored_of(chunk) * kPairs * kThreads +
         sizeof(float2) * (size_t)kStage * (kThreads / split) +
         2 * sizeof(float) * (size_t)kStage * (split * 2 * kPairs);
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

// comb((a1, b1), (a2, b2)) = (a1 a2, b1 a2 + b2) on packed pairs; (a2, b2)
// becomes the result.
__device__ __forceinline__ void comb(uint32_t a1, uint32_t b1, uint32_t& a2,
                                     uint32_t& b2) {
  b2 = badd(bmul(b1, a2), b2);
  a2 = bmul(a1, a2);
}

using Pairs = uint32_t[kPairs];

// The binary-counter walk of one scan chunk for a thread's kPairs pairs
// (the count, and so the level a push stops at, is the same for all of
// them and in every thread).  Level k of the stack (its block's (a, b)
// and the fold of the levels above it when it was set, (ga, gb), one uint4
// a pair) lives in shared memory from level lvl0 up, [level][pair][thread],
// so any level is reached by its index and a quarter warp's 16-byte words
// fall in distinct banks; the count and the prefix (pa, pb) through the
// last step live in registers.
struct Walk {
  uint4* lv;  // this thread's word of pair 0 at level lvl0
  int lvl0, top;
  Pairs pa, pb;
  int cnt;

  __device__ __forceinline__ uint4& at(int k, int p) {
    return lv[((k - lvl0) * kPairs + p) * kThreads];
  }

  // Merge the block (ea, eb), which stands where level k0 would be, into
  // levels k0 ... j - 1 (comb(level, block): the level holds the earlier
  // steps), store it at level j with the fold of the levels above j, and
  // make (pa, pb) the prefix through it.  (fa, fb) is the fold of the
  // levels above k0 - 1, which only j = k0 stores.
  __device__ __forceinline__ void push_from(int k0, int j, Pairs& ea,
                                            Pairs& eb, const Pairs& fa0,
                                            const Pairs& fb0) {
    Pairs fa, fb;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) { fa[p] = fa0[p]; fb[p] = fb0[p]; }
    for (int k = k0; k < j; ++k) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const uint4 v = at(k, p);
        comb(v.x, v.y, ea[p], eb[p]);
        fa[p] = v.z;
        fb[p] = v.w;
      }
    }
    if (j != top) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
        at(j, p) = make_uint4(ea[p], eb[p], fa[p], fb[p]);
    }
    ++cnt;
    const bool above = (cnt >> (j + 1)) != 0;  // levels above j: fold first
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (above) comb(fa[p], fb[p], ea[p], eb[p]);
      pa[p] = ea[p];
      pb[p] = eb[p];
    }
  }

  // Push one step; the level it stops at, j (the trailing ones of cnt), is
  // the same in every thread.  The fold above level 0 is the prefix.
  __device__ __forceinline__ void push(Pairs& ea, Pairs& eb) {
    push_from(0, __ffs(~cnt) - 1, ea, eb, pa, pb);
  }
};

// kStates: the state before every kStateEvery steps is written (training).
template <typename T, typename TD, bool kStates>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_bf16_kernel(
    const T* __restrict__ u, const TD* __restrict__ dt,
    const T* __restrict__ Bc, const T* __restrict__ Cc,
    const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_last, float* __restrict__ states, Strides st,
    int S, int din, int N, int chunk, int split, int npt) {
  const int kCh = kThreads / split;        // channels per block
  const int W = 2 * kPairs * split;        // a staged B or C row, floats
  const int lg_ch = __ffs(kCh) - 1, lg_w = __ffs(W) - 1;  // log2 of each
  const int lvl0 = lvl0_of(chunk);
  const bool aligned = lvl0 != 0;          // every group whole (kGroup | C)
  extern __shared__ __align__(16) unsigned char smem[];
  // the walk's levels, [level - lvl0][pair][kThreads] uint4
  uint4* swalk = reinterpret_cast<uint4*>(smem);
  float2* sdu = reinterpret_cast<float2*>(
      swalk + stored_of(chunk) * kPairs * kThreads);  // [kStage][kCh]
  float* sb = reinterpret_cast<float*>(sdu + kStage * kCh);  // [kStage][W]
  float* sc = sb + kStage * W;             // [kStage][W], rounded to bf16

  const int tid = threadIdx.x;
  const int cl = tid / split;              // the block's channel
  const int n0 = 2 * kPairs * (tid % split);  // this thread's first state
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + cl;
  const bool live = d < din;
  // A of the thread's states (0 past N or din: a = 1, and B and C are 0
  // there)
  float A[2 * kPairs];
#pragma unroll
  for (int i = 0; i < 2 * kPairs; ++i)
    A[i] = (live && n0 + i < N) ? -expf(A_log[(long long)d * N + n0 + i])
                                : 0.f;

  const T* ub = u + b * st.u_b + d0;
  const TD* db = dt + b * st.dt_b + d0;
  const T* bb = Bc + b * st.b_b;
  const T* cb = Cc + b * st.c_b;
  T* yp = y + b * (long long)S * din + d;  // y of (b, step, d)
  const int nst = (S + kStateEvery - 1) / kStateEvery;
  // the states' row of this channel before step 0, and the stride to the
  // next saved state
  float* sp = kStates ? states + (b * nst * din + d) * (long long)N
                      : nullptr;
  const long long sp_step = (long long)din * N;

  Walk w;
  w.lv = swalk + tid;
  w.lvl0 = lvl0;
  w.top = top_of(chunk);
  w.cnt = 0;
  Pairs h0, hs;  // bf16(h) carried into the chunk; the last step's hs
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    w.pa[p] = kOne; w.pb[p] = 0u;
    h0[p] = 0u; hs[p] = 0u;
  }

  // A step's packed decays a = bf16(expf(dt A)) for every pair, from
  // staged row t.
  auto decays = [&](int t, Pairs& ea) {
    const float dtv = sdu[t * kCh + cl].x;
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      ea[p] = scan::decay2(__fmul_rn(dtv, A[2 * p]),
                           __fmul_rn(dtv, A[2 * p + 1]));
  };
  // A step's packed b = bf16(dt u B) for every pair, from staged row t.
  auto dbu = [&](int t, Pairs& eb) {
    const float dtu = sdu[t * kCh + cl].y;
    const float4* bt = reinterpret_cast<const float4*>(sb + t * W + n0);
    float bv[2 * kPairs];
#pragma unroll
    for (int q = 0; q < kPairs / 2; ++q) {
      const float4 v = bt[q];
      bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z;
      bv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      eb[p] = pack_bf16x2(__fmul_rn(dtu, bv[2 * p]),
                          __fmul_rn(dtu, bv[2 * p + 1]));
  };
  // hs at a step from its prefix (a, b), and the thread's part of y: each
  // pair's two exact products added in fp32, the pairs in the tree the
  // shuffles formed when a thread had one pair, (p0 + p1) + (p2 + p3).
  auto out = [&](int t, const Pairs& a, const Pairs& bq) -> float {
    const float4* ct = reinterpret_cast<const float4*>(sc + t * W + n0);
    float cv[2 * kPairs];
#pragma unroll
    for (int q = 0; q < kPairs / 2; ++q) {
      const float4 v = ct[q];
      cv[4 * q] = v.x; cv[4 * q + 1] = v.y; cv[4 * q + 2] = v.z;
      cv[4 * q + 3] = v.w;
    }
    float part[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      hs[p] = badd(bq[p], bmul(a[p], h0[p]));
      part[p] = __fmaf_rn(lo_f(hs[p]), cv[2 * p],
                          __fmul_rn(hi_f(hs[p]), cv[2 * p + 1]));
    }
    const float y01 = part[0] + part[1];
    return npt == 1 ? part[0] : npt == 2 ? y01 : y01 + (part[2] + part[3]);
  };
  auto carry = [&]() {  // the chunk's end: its last hs is the carry
    if (w.cnt == chunk) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) h0[p] = hs[p];
      w.cnt = 0;
    }
  };
  // A whole group from empty levels 0-2, staged from row t, its decays
  // ea made first (the exponentials overlap), each step's b made where
  // the walk reaches it (identity steps, a = 1 and b = 0, from step gn on):
  // its first 7 pushes stop at levels 0 1 0 2 0 1 0, so their blocks and
  // prefixes stay in registers; the 8th merges the group's block of 8 into
  // levels 3 and up.  (Pa, Pb): the fold of the levels above 2, the prefix
  // so far, which comes first where any is set.
  auto whole = [&](Pairs (&ea)[kGroup], int t, int gn, float (&yv)[kGroup]) {
    auto ebu = [&](int u, Pairs& eb) {
      if (u < gn) {
        dbu(t + u, eb);
      } else {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) eb[p] = 0u;
      }
    };
    const bool up = w.cnt != 0;
    Pairs Pa, Pb, pa, pb, qa, qb, a01, b01, a03, b03, a45, b45, e0, e1;
    ebu(0, e0);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      Pa[p] = w.pa[p]; Pb[p] = w.pb[p];
      pa[p] = ea[0][p]; pb[p] = e0[p];
      if (up) comb(Pa[p], Pb[p], pa[p], pb[p]);
    }
    yv[0] = out(t, pa, pb);
    ebu(1, e1);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      a01[p] = ea[1][p]; b01[p] = e1[p];             // steps 0-1
      comb(ea[0][p], e0[p], a01[p], b01[p]);
      pa[p] = a01[p]; pb[p] = b01[p];
      if (up) comb(Pa[p], Pb[p], pa[p], pb[p]);
    }
    yv[1] = out(t + 1, pa, pb);
    ebu(2, e0);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      qa[p] = pa[p]; qb[p] = pb[p];                  // the prefix through 1
      pa[p] = ea[2][p]; pb[p] = e0[p];
      comb(qa[p], qb[p], pa[p], pb[p]);
    }
    yv[2] = out(t + 2, pa, pb);
    ebu(3, e1);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      a03[p] = ea[3][p]; b03[p] = e1[p];             // steps 0-3
      comb(ea[2][p], e0[p], a03[p], b03[p]);
      comb(a01[p], b01[p], a03[p], b03[p]);
      pa[p] = a03[p]; pb[p] = b03[p];
      if (up) comb(Pa[p], Pb[p], pa[p], pb[p]);
    }
    yv[3] = out(t + 3, pa, pb);
    ebu(4, e0);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      qa[p] = pa[p]; qb[p] = pb[p];                  // the prefix through 3
      pa[p] = ea[4][p]; pb[p] = e0[p];
      comb(qa[p], qb[p], pa[p], pb[p]);
    }
    yv[4] = out(t + 4, pa, pb);
    ebu(5, e1);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      a45[p] = ea[5][p]; b45[p] = e1[p];             // steps 4-5
      comb(ea[4][p], e0[p], a45[p], b45[p]);
      pa[p] = a45[p]; pb[p] = b45[p];
      comb(qa[p], qb[p], pa[p], pb[p]);
    }
    yv[5] = out(t + 5, pa, pb);
    ebu(6, e0);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      qa[p] = pa[p]; qb[p] = pb[p];                  // the prefix through 5
      pa[p] = ea[6][p]; pb[p] = e0[p];
      comb(qa[p], qb[p], pa[p], pb[p]);
    }
    yv[6] = out(t + 6, pa, pb);
    ebu(7, e1);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {               // steps 0-7
      comb(ea[6][p], e0[p], ea[7][p], e1[p]);
      comb(a45[p], b45[p], ea[7][p], e1[p]);
      comb(a03[p], b03[p], ea[7][p], e1[p]);
    }
    w.cnt += kGroup - 1;
    w.push_from(kLow, __ffs(~w.cnt) - 1, ea[7], e1, Pa, Pb);
    yv[7] = out(t + 7, w.pa, w.pb);
    carry();
  };

  for (int t0 = 0; t0 < S; t0 += kStage) {
    const int steps = min(kStage, S - t0);
    // Stage (dt, dt u) (consecutive threads on consecutive channels of one
    // step, kBatch loads in flight; clamped indices, zeros past din).  The
    // rows' widths are powers of two: rows and columns by shifts and masks
    // (a division by a width known only at run time cost the forward a
    // tenth of its time).
    const int nud = steps * kCh;
    for (int i0 = 0; i0 < nud; i0 += kBatch * kThreads) {
      float uv[kBatch], dv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = min(i0 + j * kThreads + tid, nud - 1);
        const int t = i >> lg_ch, c = min(i & (kCh - 1), din - 1 - d0);
        const long long tt = t0 + t;
        uv[j] = to_f(ub[tt * st.u_s + c]);
        dv[j] = to_f(db[tt * st.dt_s + c]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < nud) {
          const bool in = d0 + (i & (kCh - 1)) < din;
          sdu[i] = in ? make_float2(dv[j], __fmul_rn(dv[j], uv[j]))
                      : make_float2(0.f, 0.f);
        }
      }
    }
    // B and C rows of W states, zeros past N (kBatchBC loads a batch: a
    // stage's rows at N 16 are two a thread, and clamped duplicates past
    // them cost a tenth of the forward's time).
    const int nbc = steps * W;
    for (int i0 = 0; i0 < nbc; i0 += kBatchBC * kThreads) {
      float bv[kBatchBC], cv[kBatchBC];
#pragma unroll
      for (int j = 0; j < kBatchBC; ++j) {
        const int i = min(i0 + j * kThreads + tid, nbc - 1);
        const int t = i >> lg_w, n = min(i & (W - 1), N - 1);
        bv[j] = to_f(bb[(long long)(t0 + t) * st.b_s + n]);
        cv[j] = to_f(cb[(long long)(t0 + t) * st.c_s + n]);
      }
#pragma unroll
      for (int j = 0; j < kBatchBC; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < nbc) {
          const bool in = (i & (W - 1)) < N;
          sb[i] = in ? bv[j] : 0.f;
          sc[i] = in ? round_bf16(cv[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    // The steps in groups of kGroup: each step's pairs (a, b) first
    // (independent of the walk: the exponentials overlap), then the walk,
    // then y's sums over the channel's threads (kGroup independent shuffle
    // chains).  A group starts on a multiple of kGroup, so the states'
    // steps (every kStateEvery) start groups.
    for (int g0 = 0; g0 < steps; g0 += kGroup) {
      const int gn = min(kGroup, steps - g0);
      if (kStates && (t0 + g0) % kStateEvery == 0) {
        if (live) {
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const int n = n0 + 2 * p;
            if (n < N) sp[n] = lo_f(hs[p]);
            if (n + 1 < N) sp[n + 1] = hi_f(hs[p]);
          }
        }
        sp += sp_step;
      }
      float yv[kGroup];
      if ((w.cnt & (kGroup - 1)) == 0 && w.cnt + kGroup <= chunk &&
          (gn == kGroup || aligned)) {
        // A whole group; where C is a multiple of kGroup a ragged last one
        // too, padded with identity steps (a = 1, b = 0), as the chunk's
        // end is padded below.
        Pairs ea[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (u < gn) {
            decays(g0 + u, ea[u]);
          } else {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) ea[u][p] = kOne;
          }
        }
        whole(ea, g0, gn, yv);
      } else {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          yv[u] = 0.f;
          if (u < gn) {
            Pairs ea, eb;
            decays(g0 + u, ea);
            dbu(g0 + u, eb);
            w.push(ea, eb);
            yv[u] = out(g0 + u, w.pa, w.pb);
            carry();
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
  // A ragged last chunk: identity steps to its end (whole groups where C
  // is a multiple of kGroup: the count is then one too), its carry h_last.
  if (aligned) {
    while (w.cnt != 0) {
      Pairs ea[kGroup];
      float yv[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) ea[u][p] = kOne;
      whole(ea, 0, 0, yv);
    }
  } else if (w.cnt != 0) {
    while (w.cnt < chunk) {
      Pairs ea, eb;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) { ea[p] = kOne; eb[p] = 0u; }
      w.push(ea, eb);
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) hs[p] = badd(w.pb[p], bmul(w.pa[p], h0[p]));
  }
  if (live) {
    float* hb = h_last + (b * din + d) * (long long)N;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int n = n0 + 2 * p;
      if (n < N) hb[n] = lo_f(hs[p]);
      if (n + 1 < N) hb[n + 1] = hi_f(hs[p]);
    }
  }
}

template <typename T, typename TD>
int launch(const void* u, const void* dt, const void* Bc, const void* Cc,
           const void* A_log, void* y, void* h_last, void* states,
           const Strides& st, int B, int S, int din, int N, int chunk,
           cudaStream_t stream) {
  const int split = split_of(N);
  const size_t smem = smem_bytes(N, chunk);
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
      N, chunk, split, pairs_of(N));
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
