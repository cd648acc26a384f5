// Backward of the Mamba1 selective scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains falcon-mamba by XLA's
// autodiff of its chunked associative scan (src/repro/models/mamba.py:128-
// 144), and the TPU kernel (src/repro/kernels/mamba_scan/mamba_scan.py:23)
// has no backward.  The port's forward runs on mamba_scan.cu, which autograd
// cannot see through, so this kernel is the gradient of that function.
// kBf16 (the entry point mamba_scan_bwd_bf16_launch, with the chunk length
// C) makes it the gradient of mamba_scan_bf16.cu's function straight
// through its roundings: the same recurrence on a_t = bf16(expf(dt_t A))
// and bf16(dt_t u_t B_t), C_t rounded to bf16, and h_{t-1} rounded to bf16
// where t starts a chunk (the forward's carry); the states it starts from
// are that kernel's.  Under kBf16 the decays of a sub-chunk's 4 steps are
// made at its start (scan.cuh's decay2, bf16(expf(dt A))) as bf16 pairs
// in registers: the recompute's are kept for the walk, so a state-step
// takes 1.75 decays (the first pass's and the recompute's), not 2.75; dt
// u B is rounded two values a conversion.
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
// oracle).  Inputs are the forward's: u/dt (B, S, din), B/C (B, S, N),
// A_log (din, N) fp32; the forward's states (B, ceil(S / kStateEvery), din,
// N) fp32, h before every kStateEvery = 16 steps (scan.cuh); dy (B, S, din)
// in u's type and dh_last (B, din, N) fp32 or null.  du comes out in u's
// type, ddt in dt's; dB and dC as per-block partials (B, S, blocks, N) fp32
// and dA_log as per-sequence partials (B, din, N) fp32, which the wrapper
// sums with torch.  No float atomics: every sum runs in a fixed order, so
// two calls on the same inputs give the same bits.
//
// Design: the grid and the channels of a block are the forward's where
// N <= 16 (falcon-mamba's 16: 128 threads, 64 channels a block, two
// threads a channel, 8 states each; grid (din / 64, B)); above 16 states a
// channel takes NP / 8 threads, so that a thread always holds at most 8
// states.  g's carry a_{t+1} g_{t+1} and the dA_log sums stay in registers
// for the whole sequence.  The block walks the segments between two saved
// states (kStateEvery = 16 steps) from the last to the first, each in
// sub-chunks of kSub = 4 steps: a first pass from the segment's saved
// state keeps the state before sub-chunks 1-3 (3 x 4 KB, each thread its
// own 32 bytes); then, from the last sub-chunk to the first, its 4 steps
// are recomputed with the forward's own operations (scan.cuh's scan_step,
// one ex2.approx of dt A log2 e) into a buffer of h_t (4 steps x 8 states x
// 128 threads, rows padded to 132 floats) and walked in reverse.  The
// walk reads h_{t-1} there, evaluates a_t again (cheaper than keeping it,
// PERF.md; under kBf16 it reuses the recompute's, 16 registers of bf16
// pairs), writes g_t into a second such buffer, and sums du_t and ddt_t
// over a channel's two threads with one __shfl_xor_sync each, nothing
// across channels.  After the walk the block
// sums dC_t[n] = sum_d dy_t[d] h_t[d, n] and dB_t[n] = sum_d (dt u)_t[d]
// g_t[d, n] column by column from the two buffers: warps 0-1 take dC, 2-3
// dB, a lane one row (one step, one state of each of the split's threads)
// over half the channels in four chains, 16-byte reads, the two halves
// added by one shuffle; the 8 lanes of a quarter warp read 8 rows whose
// starts differ by 4 banks, so no read conflicts.  Each stage's u, dt,
// dy, B and C rows arrive by TMA (one thread, one mbarrier; zeros past S,
// din and N) into a ring of two while the stage before computes, and are
// read as they came (bf16 widened in registers: half the shared-memory
// traffic of fp32 rows, and no conversion pass or barrier); the walk
// leaves dy and dt u in fp32 for the column sums; the saved state comes
// into ckpt slot 0.  Two block barriers a sub-chunk of the walk, one a
// sub-chunk of the first pass.  Shared memory: 54 KB a block at N 16, so
// 4 blocks of 128 threads an SM, with registers held to 128
// (__launch_bounds__): falcon-mamba's 512 blocks are resident at once on
// 132 SMs (ops.bwd_plan).
//
// What bounds it on this card: at falcon-mamba-7b's training shape (B 4,
// S 4096, din 8192, N 16; u, dy, du in bf16, dt and ddt in fp32) the
// function reads u, dt, dy, B, C, A_log and the states and writes du, ddt,
// dB, dC and dA_log, about 2.0 GB counting states every 64 steps (this
// design reads them every 16: 0.40 GB more), 0.60 ms at 3.35 TB/s; it
// needs B S din N = 2.15e9 exponentials, 0.51 ms at the special-function
// units' 16 a clock per SM: bytes, narrowly.  This design evaluates 2.75
// exponentials a state-step (the first pass over 12 of each 16 steps, the
// recompute, the walk; 1.75 under kBf16, above) and no cross-channel
// shuffle in the walk, whose steps the compiler unrolls.  What binds it is the SM: shared-memory
// traffic (h stored, read back by the walk and the sums; g stored and
// read by the sums; each thread's B and C values each step) and the issue
// slots, with 4 warps a scheduler to hide latency.  The partials are 268
// MB written and read at this shape.  PERF.md has the measured time, the
// SASS counts and the rejected designs.  Under kBf16 (the same bytes and
// exponentials) it takes 5.45-5.82 ms on "NVIDIA H100 80GB HBM3, 700.00
// W" (the 2.75-decay design 7.37-7.57 in the same run): 69.5 SASS a
// state-step against 81.6 (the first pass 23.0 over 12 of each 16 steps,
// the walk's sub-chunk 52.3; tools/scan_bf16_probe.py --sass).  The
// decays' exponentials are not what binds it: with ex2.approx in the
// place of expf (wrong bits) it took 4.6-4.9 ms.

#include <cstdint>

#include "../../flash_attention/csrc/sm90.cuh"
#include "scan.cuh"

namespace {

using scan::exp2_approx;
using scan::from_f;
using scan::kLog2e;
using scan::kMaxState;
using scan::kStateEvery;
using scan::to_f;

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;   // threads per block
constexpr int kSub = 4;  // steps recomputed at once (ops.SUB)
static_assert(kStateEvery % kSub == 0, "kSub must divide kStateEvery");
constexpr int kNSub = kStateEvery / kSub;  // sub-chunks between two states
// ckpt slots: the first pass's states before sub-chunks 1 ... kNSub - 1;
// slot 0 first holds the saved state the segment starts from.
constexpr int kSlots = kNSub > 1 ? kNSub - 1 : 1;
constexpr int kPitch = kThreads + 4;  // floats a row of the h and g buffers
// The blocks an SM is promised by the register budget: 4, so 128
// registers a thread.  ops.bwd_plan mirrors it.
constexpr int kMinBlocks = 4;

// Element strides: (batch, time) of u, dt, Bc, Cc and dy; the states'
// between channels (N, or more where the wrapper padded them).
struct Strides {
  long long u_b, u_s, dt_b, dt_s, b_b, b_s, c_b, c_s, dy_b, dy_s, st_d;
};

// Threads a channel: one at NP = 4, two at 8 and 16 (the forward's), NP / 8
// above, so that a thread holds at most 8 states.  ops.bwd_plan mirrors it.
__host__ __device__ constexpr int split_of(int NP) {
  return NP <= 4 ? 1 : NP <= 16 ? 2 : NP / 8;
}

// The raw B and C rows of NP states: at least 16 bytes (a TMA box's
// least width), so 8 bf16 at NP = 4.
__host__ __device__ constexpr int brow_of(int NP) { return NP < 8 ? 8 : NP; }

// Shared memory of a block, in bytes, for kCh channels and rows of NP
// states (ops.bwd_plan mirrors it): the stages as copied, in a ring of two
// (u, dt and dy of kSub steps for the block's channels, sized for fp32;
// the B and C rows), which each stage reads as they came; dy and dt u in
// fp32 for the column sums; the ckpt slots; the h and g buffers; the
// copies' mbarrier.
__host__ __device__ constexpr size_t raw_bytes(int kCh, int NP) {
  return 8 * (3 * (size_t)kSub * kCh + 2 * (size_t)kSub * brow_of(NP));
}
__host__ __device__ constexpr size_t smem_bytes(int NP) {
  return raw_bytes(kThreads / split_of(NP), NP) +
         4 * (2 * (size_t)kSub * (kThreads / split_of(NP)) +
              (size_t)kSlots * (NP / split_of(NP)) * kThreads +
              2 * (size_t)kSub * (NP / split_of(NP)) * kPitch) +
         16;
}

// This thread's NT (4 or 8) values of a B or C row as copied (fp32, or
// bf16 widened: a shift or a mask a value), one 8-, 16- or 32-byte load.
template <typename T, int NT>
__device__ __forceinline__ void row_f(const T* p, float (&v)[NT]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < NT / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
    uint32_t w[NT / 2];
    if constexpr (NT == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    }
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

// Four floats from / to 16-byte aligned shared memory.
__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Under kBf16, a step's terms of this thread's NT states from its decays
// `ap` (bf16 pairs, sub_decays in the kernel): a = bf16(expf(dt A)) and dt
// u B rounded to bf16, two a conversion.
template <int NT>
__device__ __forceinline__ void bf16_terms(const uint32_t (&ap)[NT / 2],
                                           float dtu, const float (&bv)[NT],
                                           float (&a)[NT], float (&e)[NT]) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    const uint32_t ep = scan::pack_bf16x2(__fmul_rn(dtu, bv[2 * p]),
                                          __fmul_rn(dtu, bv[2 * p + 1]));
    a[2 * p] = scan::lo_f(ap[p]);
    a[2 * p + 1] = scan::hi_f(ap[p]);
    e[2 * p] = scan::lo_f(ep);
    e[2 * p + 1] = scan::hi_f(ep);
  }
}

// One TMA box of a 3-d tensor map (coordinates innermost first) into
// shared memory at `dst`, completing on `bar` with its bytes (zeros where
// the box passes an edge of the tensor).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

template <typename T, typename TD, int NP, bool kFull, int kSplit,
          bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_bwd_kernel(
    const float* __restrict__ A_log, const float* __restrict__ dh_last,
    T* __restrict__ du, TD* __restrict__ ddt, float* __restrict__ dBp,
    float* __restrict__ dCp, float* __restrict__ dAp, int S, int din, int N,
    int chunk,
    const __grid_constant__ CUtensorMap tu,
    const __grid_constant__ CUtensorMap tdt,
    const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tst) {
  constexpr int kCh = kThreads / kSplit;   // channels per block
  constexpr int NT = NP / kSplit;          // states per thread
  constexpr int kRows = kSub * NT;         // rows of the h and g buffers
  // The column sums: a warp sums kR2 rows, kParts lanes a row, each over
  // kQuads 16-byte groups of the row (4 threads' columns each).
  constexpr int kR2 = kRows / 2;
  constexpr int kParts = 32 / kR2;
  constexpr int kQuads = kThreads / 4 / kParts;
  static_assert(kR2 <= 32 && 32 % kR2 == 0, "rows a warp must divide 32");
  constexpr int kBR = brow_of(NP);
  // TMA's destinations start on 128-byte boundaries
  static_assert((4 * kSub * kCh) % 128 == 0 && (4 * kSub * kBR) % 128 == 0 &&
                    (raw_bytes(kCh, NP) + 4 * 2 * kSub * kCh) % 128 == 0,
                "a TMA destination off 128 bytes");
  static_assert(NT == 4 || NT == 8, "row_f loads 4 or 8 states");
  extern __shared__ __align__(128) unsigned char smem[];
  // the ring: slot s of each array at s times its slot's bytes (fp32 size)
  constexpr int kRowSlot = 4 * kSub * kCh, kBSlot = 4 * kSub * kBR;
  unsigned char* ru = smem;                 // [2][kSub][kCh] of T
  unsigned char* rdt = ru + 2 * kRowSlot;   // [2][kSub][kCh] of TD
  unsigned char* rdy = rdt + 2 * kRowSlot;  // [2][kSub][kCh] of T
  unsigned char* rb = rdy + 2 * kRowSlot;   // [2][kSub][kBR] of T
  unsigned char* rc = rb + 2 * kBSlot;      // [2][kSub][kBR] of T
  float* fdy = reinterpret_cast<float*>(smem + raw_bytes(kCh, NP));
  float* fdtu = fdy + kSub * kCh;          // [kSub][kCh]: dt u
  float* ckpt = fdtu + kSub * kCh;         // [kSlots][kThreads][NT]
  float* hbuf = ckpt + kSlots * NT * kThreads;  // [kSub][NT][kPitch]
  float* gbuf = hbuf + kRows * kPitch;     // [kSub][NT][kPitch]
  const uint32_t bar = sm90::smem_u32(gbuf + kRows * kPitch);  // 16 bytes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kSplit;             // the block's channel
  const int n0 = (tid % kSplit) * NT;      // this thread's first state
  const long long b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * kCh;
  const int d = d0 + cl;
  const bool live = d < din;
  const int nch = (S + kStateEvery - 1) / kStateEvery;

  // A log2(e) (the forward's value, bit for bit); A itself is A2 ln 2.
  // Under kBf16, A itself (kScale 1).  States past N and channels past din
  // run on zeros (A2 0, B and C rows zero, states 0), which keeps their h,
  // g and sums 0.
  constexpr float kScale = kBf16 ? 1.f : kLog2e, kUnscale = kBf16 ? 1.f : kLn2;
  float A2[NT], carry[NT], dA[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int n = n0 + i;
    const bool ok = live && (kFull || n < N);
    A2[i] = ok ? -expf(A_log[(long long)d * N + n]) * kScale : 0.f;
    carry[i] = (ok && dh_last != nullptr)
                   ? dh_last[(b * din + d) * (long long)N + n] : 0.f;
    dA[i] = 0.f;
  }

  // A segment of n sub-chunks takes 2n - 1 stages: k < n - 1 forward (the
  // first pass, sub-chunk k), then the sub-chunks n - 1 ... 0 in reverse.
  // issue(c, k, slot) starts the copies of stage k of segment c into ring
  // slot `slot`, one thread's TMA boxes completing on `bar`: u, dt and B
  // (and dy and C for a reverse stage).  A stage that
  // starts from a saved state (the first pass's first, the reverse walk's
  // last) also brings it into ckpt slot 0 ([channel][NP]: each thread's NT
  // states side by side), free then (its last reader, the stage before,
  // read it at its start).
  auto nsub_of = [&](int c) {
    return (min(kStateEvery, S - c * kStateEvery) + kSub - 1) / kSub;
  };
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int c, int k, int slot) {
    if (tid != 0) return;
    const int n = nsub_of(c);
    const bool reverse = k >= n - 1;
    const int sub = reverse ? 2 * n - 2 - k : k;
    const int ts = c * kStateEvery + sub * kSub, bi = (int)b;
    constexpr uint32_t kRow = kSub * kCh, kB = kSub * kBR * sizeof(T);
    const uint32_t bytes =
        kRow * (sizeof(T) + sizeof(TD)) + kB +
        (reverse ? kRow * sizeof(T) + kB : 0) +
        (sub == 0 ? (uint32_t)(kCh * NP * sizeof(float)) : 0);
    // the generic proxy's last reads and writes of these bytes (the stage
    // before last, the first pass's slot 0) come before the copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    sm90::mbar_expect_tx(bar, bytes);
    tma_load_3d(sm90::smem_u32(ru + slot * kRowSlot), &tu, bar, d0, ts, bi);
    tma_load_3d(sm90::smem_u32(rdt + slot * kRowSlot), &tdt, bar, d0, ts, bi);
    tma_load_3d(sm90::smem_u32(rb + slot * kBSlot), &tb, bar, 0, ts, bi);
    if (reverse) {
      tma_load_3d(sm90::smem_u32(rdy + slot * kRowSlot), &tdy, bar, d0, ts,
                  bi);
      tma_load_3d(sm90::smem_u32(rc + slot * kBSlot), &tc, bar, 0, ts, bi);
    }
    if (sub == 0)
      tma_load_3d(sm90::smem_u32(ckpt), &tst, bar, 0, d0, bi * nch + c);
  };
  // The stages consumed so far, mod 2: the phase of `bar` the next one
  // completes, and its ring slot.
  int phase = 0;
  auto arrive = [&]() {
    sm90::mbar_wait(bar, phase);
    phase ^= 1;
  };
  // This thread's channel's dt and dt u (the forward's product) at step j
  // of the stage in ring slot `slot`.
  auto dt_dtu = [&](int slot, int j, float& dtv, float& dtu) {
    const int i = j * kCh + cl;
    dtv = to_f(reinterpret_cast<const TD*>(rdt + slot * kRowSlot)[i]);
    dtu = dtv * to_f(reinterpret_cast<const T*>(ru + slot * kRowSlot)[i]);
  };
  // Under kBf16, the decays of the kSub steps of the stage in ring slot
  // `slot` (zeros past S: a decay of 1), as bf16 pairs, bf16(expf(dt A)).
  // The recompute's are kept for the walk.
  auto sub_decays = [&](int slot, uint32_t (&ap)[kSub][NT / 2]) {
    const TD* sdt = reinterpret_cast<const TD*>(rdt + slot * kRowSlot) + cl;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float dtv = to_f(sdt[j * kCh]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p)
        ap[j][p] = scan::decay2(__fmul_rn(dtv, A2[2 * p]),
                                __fmul_rn(dtv, A2[2 * p + 1]));
    }
  };
  // Under kBf16, the steps of the sub-chunk from step ts that start a
  // chunk, as bits (one division a sub-chunk; ts is the same in every
  // thread); and h_{t-1} as its step j reads it: rounded to bf16 where bit
  // j is set.
  auto starts_of = [&](int ts) -> unsigned {
    unsigned m = 0u;
    if constexpr (kBf16) {
      const int r = ts % chunk;
      for (int x = r == 0 ? 0 : chunk - r; x < kSub; x += chunk) m |= 1u << x;
    }
    return m;
  };
  auto carry_in = [&](unsigned starts, int j, float (&h)[NT]) {
    if constexpr (kBf16) {
      if ((starts >> j) & 1u) {
#pragma unroll
        for (int i = 0; i < NT; ++i) h[i] = scan::round_bf16(h[i]);
      }
    }
  };

  // The column sums' share of this thread: dC (q 0, h rows weighted by
  // dy) or dB (q 1, g rows weighted by dt u), one row (step jr, state ir
  // of each of a channel's threads), the channels of part `part`; the
  // weights of a 16-byte group of columns in one load where they fit.
  auto column_sums = [&](long long ts, int ss) {
    const int q = warp >> 1;
    const int row = lane % kR2 + kR2 * (warp & 1);
    const int part = lane / kR2;
    const int jr = row / NT, ir = row % NT;
    const float* src = (q ? gbuf : hbuf) + row * kPitch + part * kQuads * 4;
    const float* w = (q ? fdtu : fdy) + jr * kCh + part * (kQuads * 4 / kSplit);
    // four chains a state, column groups k = 0, 1, 2, 3 mod 4, added in
    // that order at the end: a fixed order, a quarter of the latency
    constexpr int kChains = 4;
    float acc4[kChains][kSplit];
#pragma unroll
    for (int l = 0; l < kChains; ++l)
#pragma unroll
      for (int p = 0; p < kSplit; ++p) acc4[l][p] = 0.f;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const float4 v4 = *reinterpret_cast<const float4*>(src + 4 * k);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      float wk[4];   // the weight of column 4k + e
      if constexpr (kSplit == 1) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + 4 * k);
        wk[0] = w4.x; wk[1] = w4.y; wk[2] = w4.z; wk[3] = w4.w;
      } else if constexpr (kSplit == 2) {
        const float2 w2 = *reinterpret_cast<const float2*>(w + 2 * k);
        wk[0] = wk[1] = w2.x;
        wk[2] = wk[3] = w2.y;
      } else {
        wk[0] = wk[1] = wk[2] = wk[3] = w[4 * k / kSplit];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = acc4[k % kChains][(4 * k + e) % kSplit];  // column's part
        a = fmaf(wk[e], v[e], a);
      }
    }
    float acc[kSplit];
#pragma unroll
    for (int p = 0; p < kSplit; ++p)
      acc[p] = (acc4[0][p] + acc4[1][p]) + (acc4[2][p] + acc4[3][p]);
#pragma unroll
    for (int m = kR2; m < 32; m *= 2) {
#pragma unroll
      for (int p = 0; p < kSplit; ++p)
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], m);
    }
    if (part == 0 && jr < ss) {
      float* out = (q ? dBp : dCp) +
                   ((b * S + ts + jr) * nblk + blk) * (long long)N;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) {
        const int n = p * NT + ir;
        if (kFull || n < N) out[n] = acc[p];
      }
    }
  };

  issue(nch - 1, 0, 0);
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * kStateEvery;
    const int steps = min(kStateEvery, S - t0);
    const int nsub = nsub_of(c);
    // The first pass: the whole sub-chunks 0 ... nsub - 2 (only the last
    // can be ragged) from the saved state in slot 0, keeping the state
    // before each next one in slot s.
    if (nsub > 1) {
      float h[NT];
      for (int s = 0; s < nsub - 1; ++s) {
        arrive();
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < NT; i += 4)
            ld4(h + i, ckpt + tid * NT + i);
        }
        // every stage's rows are in; the stage before last is done with
        // its ring slot, and the last sums with the buffers
        __syncthreads();
        issue(c, s + 1, phase);
        const int cur = phase ^ 1;
        const T* sb = reinterpret_cast<const T*>(rb + cur * kBSlot) + n0;
        const unsigned starts = starts_of(t0 + s * kSub);
        uint32_t ap[kSub][NT / 2];
        if constexpr (kBf16) sub_decays(cur, ap);
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          float dtv, dtu;
          dt_dtu(cur, j, dtv, dtu);
          float bv[NT];
          row_f<T, NT>(sb + j * kBR, bv);
          carry_in(starts, j, h);
          if constexpr (kBf16) {
            float a[NT], e[NT];
            bf16_terms(ap[j], dtu, bv, a, e);
#pragma unroll
            for (int i = 0; i < NT; ++i) h[i] = __fmaf_rn(a[i], h[i], e[i]);
          } else {
#pragma unroll
            for (int i = 0; i < NT; ++i)
              h[i] = scan::scan_step(scan::decay(dtv, A2[i]), h[i], dtu,
                                     bv[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < NT; i += 4)
          st4(ckpt + (s * kThreads + tid) * NT + i, h + i);
      }
    }
    // The sub-chunks from the last to the first: recompute, walk back, sum.
    for (int s = nsub - 1; s >= 0; --s) {
      arrive();
      // the state before the sub-chunk: the saved one in slot 0 (copied
      // with the stage's rows) at s = 0, else the first pass's in s - 1;
      // read before the next stage's copies can refill slot 0
      float hs[NT];
#pragma unroll
      for (int i = 0; i < NT; i += 4)
        ld4(hs + i, ckpt + (max(s - 1, 0) * kThreads + tid) * NT + i);
      // every stage's rows are in; the stage before last is done with its
      // ring slot, and the last sums with the buffers
      __syncthreads();
      if (s > 0)
        issue(c, 2 * nsub - 1 - s, phase);
      else if (c > 0)
        issue(c - 1, 0, phase);
      const int cur = phase ^ 1;
      const T* sb = reinterpret_cast<const T*>(rb + cur * kBSlot) + n0;
      const T* sc = reinterpret_cast<const T*>(rc + cur * kBSlot) + n0;
      const long long ts = t0 + s * kSub;
      const int ss = min(kSub, steps - s * kSub);
      const unsigned starts = starts_of((int)ts);
      uint32_t ap[kSub][NT / 2];   // under kBf16 the decays, for the walk too
      if constexpr (kBf16) sub_decays(cur, ap);
      // Recompute h_t of the sub-chunk into this thread's columns.
      {
        float hr[NT];
#pragma unroll
        for (int i = 0; i < NT; ++i) hr[i] = hs[i];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          if (j < ss) {
            float dtv, dtu;
            dt_dtu(cur, j, dtv, dtu);
            float bv[NT];
            row_f<T, NT>(sb + j * kBR, bv);
            carry_in(starts, j, hr);
            if constexpr (kBf16) {
              float a[NT], e[NT];
              bf16_terms(ap[j], dtu, bv, a, e);
#pragma unroll
              for (int i = 0; i < NT; ++i) {
                hr[i] = __fmaf_rn(a[i], hr[i], e[i]);
                hbuf[(j * NT + i) * kPitch + tid] = hr[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < NT; ++i) {
                hr[i] = scan::scan_step(scan::decay(dtv, A2[i]), hr[i], dtu,
                                        bv[i]);
                hbuf[(j * NT + i) * kPitch + tid] = hr[i];
              }
            }
          }
        }
      }
      // Walk back: g_t (into this thread's column), du_t, ddt_t, the dA
      // sums and the carry, a_t evaluated again (cheaper than a round trip
      // through shared memory; under kBf16 the recompute's, ap); the
      // channel's dy and dt u for the column sums.  Step j reads h_{t-1}
      // from row j - 1 (hp: hs at j = 0, the step peeled off the loop,
      // which the compiler unrolls).
      const T* su = reinterpret_cast<const T*>(ru + cur * kRowSlot) + cl;
      const TD* sdt = reinterpret_cast<const TD*>(rdt + cur * kRowSlot) + cl;
      const T* sdy = reinterpret_cast<const T*>(rdy + cur * kRowSlot) + cl;
      auto walk = [&](int j, float (&hp)[NT]) {
        const float dtv = to_f(sdt[j * kCh]), uv = to_f(su[j * kCh]);
        const float dyv = to_f(sdy[j * kCh]);
        // sum_n g B and sum_n g a h_{t-1} A2, even and odd states apart
        float gb2[2] = {0.f, 0.f}, gah2[2] = {0.f, 0.f};
        float bv[NT], cv[NT];
        row_f<T, NT>(sb + j * kBR, bv);
        row_f<T, NT>(sc + j * kBR, cv);
        carry_in(starts, j, hp);
        float* gp = gbuf + j * NT * kPitch + tid;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if constexpr (kBf16 && sizeof(T) == 4) cv[i] = scan::round_bf16(cv[i]);
          const float a = !kBf16 ? scan::decay(dtv, A2[i])
                          : i & 1 ? scan::hi_f(ap[j][i / 2])
                                  : scan::lo_f(ap[j][i / 2]);
          const float g = dyv * cv[i] + carry[i];
          gp[i * kPitch] = g;
          gb2[i & 1] += g * bv[i];
          const float ga = a * g;
          const float gah = ga * hp[i];
          gah2[i & 1] += gah * A2[i];
          dA[i] += gah * dtv;
          carry[i] = ga;
        }
        float gb = gb2[0] + gb2[1], gah_a = gah2[0] + gah2[1];
#pragma unroll
        for (int m = 1; m < kSplit; m *= 2) {
          gb += __shfl_xor_sync(0xffffffffu, gb, m);
          gah_a += __shfl_xor_sync(0xffffffffu, gah_a, m);
        }
        if (n0 == 0) {
          fdy[j * kCh + cl] = dyv;
          fdtu[j * kCh + cl] = dtv * uv;
          if (live) {
            const long long o = (b * S + ts + j) * din + d;
            du[o] = from_f<T>(dtv * gb);
            ddt[o] = from_f<TD>(uv * gb + gah_a * kUnscale);
          }
        }
      };
#pragma unroll
      for (int j = kSub - 1; j > 0; --j) {
        if (j >= ss) continue;
        float hp[NT];
#pragma unroll
        for (int i = 0; i < NT; ++i)
          hp[i] = hbuf[((j - 1) * NT + i) * kPitch + tid];
        walk(j, hp);
      }
      walk(0, hs);   // hs is not read again
      __syncthreads();  // every column of h and g is in, and dy and dt u
      column_sums(ts, ss);
    }
  }
  if (live) {
    float* ap = dAp + (b * din + d) * (long long)N + n0;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (kFull || n0 + i < N) ap[i] = A2[i] * kUnscale * dA[i];
  }
}

struct Args {
  const void *u, *dt, *Bc, *Cc, *A_log, *states, *dy, *dh_last;
  void *du, *ddt, *dBp, *dCp, *dAp;
};

// Whether TMA can read every staged row: each tensor's start and its
// strides in bytes multiples of 16 (the wrapper pads a layout that is
// not: ops.tma_ready).
bool tma_ok(const Args& a, const Strides& st, size_t es, size_t esd) {
  auto ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  auto okb = [](long long s, size_t e) { return (s * (long long)e) % 16 == 0; };
  return ok(a.u) && ok(a.dt) && ok(a.Bc) && ok(a.Cc) && ok(a.dy) &&
         ok(a.states) && okb(st.u_b, es) && okb(st.u_s, es) &&
         okb(st.dt_b, esd) && okb(st.dt_s, esd) && okb(st.b_b, es) &&
         okb(st.b_s, es) && okb(st.c_b, es) && okb(st.c_s, es) &&
         okb(st.dy_b, es) && okb(st.dy_s, es) && okb(st.st_d, 4);
}

template <typename X> constexpr CUtensorMapDataType tma_type() {
  return sizeof(X) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Tensor map of a 3-d tensor of X (extents innermost first, the element
// strides of the outer two), boxes of box0 x box1 x 1, no swizzle, zeros
// past every edge.
template <typename X>
bool encode3(CUtensorMap* map, const void* ptr, long long e0, long long e1,
             long long e2, long long s1, long long s2, int box0, int box1) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)e0, (cuuint64_t)e1, (cuuint64_t)e2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * sizeof(X),
                                 (cuuint64_t)s2 * sizeof(X)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, tma_type<X>(), 3, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel for N states and its shared memory, its attributes set;
// with `occupancy`, also the blocks an SM the runtime fits at once.
template <typename T, typename TD, int NP, bool kBf16, typename K>
cudaError_t prepare(int N, K* kern, size_t* smem, int* occupancy) {
  constexpr int kSplit = split_of(NP);
  // the bf16 variant is built once, with the test of N (half the build)
  if constexpr (kBf16)
    *kern = mamba_scan_bwd_kernel<T, TD, NP, false, kSplit, true>;
  else
    *kern = N == NP ? mamba_scan_bwd_kernel<T, TD, NP, true, kSplit, false>
                    : mamba_scan_bwd_kernel<T, TD, NP, false, kSplit, false>;
  *smem = smem_bytes(NP);
  cudaError_t err = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && occupancy != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, *kern,
                                                        kThreads, *smem);
  return err;
}

template <typename T, typename TD, int NP, bool kBf16 = false>
using KernelOf = decltype(&mamba_scan_bwd_kernel<T, TD, NP, false,
                                                 split_of(NP), kBf16>);

template <typename T, typename TD, int NP, bool kBf16>
int launch_np(const Args& a, const Strides& st, int B, int S, int din, int N,
              int chunk, cudaStream_t stream) {
  constexpr int kCh = kThreads / split_of(NP);
  KernelOf<T, TD, NP, kBf16> kern;
  size_t smem;
  const cudaError_t err = prepare<T, TD, NP, kBf16>(N, &kern, &smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  // the staged rows' tensor maps: u, dt, dy (din, S, B); B, C (N, S, B);
  // the states (N, din, B x ceil(S / kStateEvery))
  CUtensorMap m[6];
  const int nst = (S + kStateEvery - 1) / kStateEvery;
  if (!(encode3<T>(&m[0], a.u, din, S, B, st.u_s, st.u_b, kCh, kSub) &&
        encode3<TD>(&m[1], a.dt, din, S, B, st.dt_s, st.dt_b, kCh, kSub) &&
        encode3<T>(&m[2], a.dy, din, S, B, st.dy_s, st.dy_b, kCh, kSub) &&
        encode3<T>(&m[3], a.Bc, N, S, B, st.b_s, st.b_b, brow_of(NP),
                   kSub) &&
        encode3<T>(&m[4], a.Cc, N, S, B, st.c_s, st.c_b, brow_of(NP),
                   kSub) &&
        encode3<float>(&m[5], a.states, N, din, (long long)B * nst, st.st_d,
                       din * st.st_d, NP, kCh)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((din + kCh - 1) / kCh, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.A_log), static_cast<const float*>(a.dh_last),
      static_cast<T*>(a.du), static_cast<TD*>(a.ddt),
      static_cast<float*>(a.dBp), static_cast<float*>(a.dCp),
      static_cast<float*>(a.dAp), S, din, N, chunk, m[0], m[1], m[2], m[3],
      m[4], m[5]);
  return (int)cudaGetLastError();
}

template <typename T, typename TD, bool kBf16>
int launch(const Args& a, const Strides& st, int B, int S, int din, int N,
           int chunk, cudaStream_t s) {
  if (!tma_ok(a, st, sizeof(T), sizeof(TD))) return (int)cudaErrorInvalidValue;
  auto np = N <= 4    ? launch_np<T, TD, 4, kBf16>
            : N <= 8  ? launch_np<T, TD, 8, kBf16>
            : N <= 16 ? launch_np<T, TD, 16, kBf16>
            : N <= 32 ? launch_np<T, TD, 32, kBf16>
                      : launch_np<T, TD, kMaxState, kBf16>;
  return np(a, st, B, S, din, N, chunk, s);
}

// Both entry points: chunk 0 is the fp32 function, chunk > 0 the bf16
// scan's at that chunk.
int launch_any(const Args& a, const Strides& st, int B, int S, int din,
               int N, int dtype, int dt_dtype, int chunk, cudaStream_t s) {
  if (chunk > 0) {
    if (dtype == 0 && dt_dtype == 0)
      return launch<float, float, true>(a, st, B, S, din, N, chunk, s);
    if (dtype == 1 && dt_dtype == 0)
      return launch<__nv_bfloat16, float, true>(a, st, B, S, din, N, chunk,
                                                s);
    if (dtype == 1 && dt_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16, true>(a, st, B, S, din, N,
                                                        chunk, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && dt_dtype == 0)
    return launch<float, float, false>(a, st, B, S, din, N, 0, s);
  if (dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float, false>(a, st, B, S, din, N, 0, s);
  if (dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(a, st, B, S, din, N,
                                                       0, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TD, int NP>
int occupancy_np(int N, int* out) {
  KernelOf<T, TD, NP> kern;
  size_t smem;
  return (int)prepare<T, TD, NP, false>(N, &kern, &smem, out);
}

template <typename T, typename TD>
int occupancy(int N, int* out) {
  auto np = N <= 4    ? occupancy_np<T, TD, 4>
            : N <= 8  ? occupancy_np<T, TD, 8>
            : N <= 16 ? occupancy_np<T, TD, 16>
            : N <= 32 ? occupancy_np<T, TD, 32>
                      : occupancy_np<T, TD, kMaxState>;
  return np(N, out);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 11 element
// strides: (batch, time) of u, dt, Bc, Cc and dy in that order, and the
// states' between channels (N, or more: the states are (B, ceil(S /
// kStateEvery), din) rows of that stride, mamba_scan_launch's at N).  Every
// start and every stride in bytes must be a multiple of 16 (TMA reads
// them; ops.tma_ready pads a layout that is not).  dh_last (B, din, N) fp32
// (or null) is contiguous, as are the outputs du (B, S, din) in u's type,
// ddt (B, S, din) in dt's, dBp and dCp (B, S, blocks, N) fp32 (blocks: the
// grid's x extent, ops.bwd_plan) and dAp (B, din, N) fp32.  dtype is that
// of u, Bc, Cc, dy and du, dt_dtype that of dt and ddt: 0 for float32, 1
// for bfloat16.  Launches on `stream`, does not synchronise, and returns
// the launch's cudaError_t (0 = cudaSuccess).
extern "C" int mamba_scan_bwd_launch(
    const void* u, const void* dt, const void* Bc, const void* Cc,
    const void* A_log, const void* states, const void* dy,
    const void* dh_last, void* du, void* ddt, void* dBp, void* dCp,
    void* dAp, const long long* strides, int B, int S, int din, int N,
    int dtype, int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 ||
      N > kMaxState || states == nullptr || strides[10] < N)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10]};
  const Args a{u, dt, Bc, Cc, A_log, states, dy, dh_last,
               du, ddt, dBp, dCp, dAp};
  return launch_any(a, st, B, S, din, N, dtype, dt_dtype, 0,
                    static_cast<cudaStream_t>(stream));
}

// mamba_scan_bwd_launch's arguments with the chunk length `chunk` (at
// least 1) before the dtypes: the gradient of mamba_scan_bf16.cu's function
// at that chunk, from that kernel's states.
extern "C" int mamba_scan_bwd_bf16_launch(
    const void* u, const void* dt, const void* Bc, const void* Cc,
    const void* A_log, const void* states, const void* dy,
    const void* dh_last, void* du, void* ddt, void* dBp, void* dCp,
    void* dAp, const long long* strides, int B, int S, int din, int N,
    int chunk, int dtype, int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || din <= 0 || B > 65535 || N <= 0 ||
      N > kMaxState || states == nullptr || strides[10] < N || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10]};
  const Args a{u, dt, Bc, Cc, A_log, states, dy, dh_last,
               du, ddt, dBp, dCp, dAp};
  return launch_any(a, st, B, S, din, N, dtype, dt_dtype, chunk,
                    static_cast<cudaStream_t>(stream));
}

// The blocks of the kernel for N states (dtype and dt_dtype as above)
// that the runtime fits on an SM at once, with its shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out; returns the
// cudaError_t.  ops.bwd_plan promises the same number.
extern "C" int mamba_scan_bwd_occupancy(int N, int dtype, int dt_dtype,
                                        int* out) {
  if (N <= 0 || N > kMaxState || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && dt_dtype == 0) return occupancy<float, float>(N, out);
  if (dtype == 1 && dt_dtype == 0)
    return occupancy<__nv_bfloat16, float>(N, out);
  if (dtype == 1 && dt_dtype == 1)
    return occupancy<__nv_bfloat16, __nv_bfloat16>(N, out);
  return (int)cudaErrorInvalidValue;
}
