// Lane-parallel Clock2Q+ trace replay for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_sim/cache_sim.py:46
// (_kernel, launched by cache_sim_raw).  It computes the function of the
// engine step, src/repro_torch/core/engine/clock2qplus.py::step (itself the
// port of src/repro/core/engine/clock2qplus.py:75), which is a superset of
// the TPU kernel: per-lane logical scap/mcap/gcap, window and skip_limit,
// the closed-form clock victim, and key < 0 as a no-op sentinel.  It reads
// and writes the plain version's state layout, so a state can pass between
// kernel and plain version at any chunk boundary.
//
// What bounds it on this card: each lane is a chain of T dependent steps.
// The bytes the function must move (state read and written once, the trace
// read once) take a fraction of a millisecond at 3.35 TB/s; the time is the
// latency of the steps' dependent round trips to memory, and lanes only run
// side by side.  So the figure of merit is ns per step.  The design keeps
// the lane's state out of device memory, as the TPU kernel kept it in
// VMEM, and takes the hits, the most of most traces, off the serial chain:
//
// * One warp a lane, one lane a block, and no block barrier.  A hit only
//   sets a ref bit (Small: if the correlation window allows), and hits
//   commute: thread i owns step t0 + i of a window of 32, a __ballot_sync
//   finds the first step of the window that is neither a hit nor padding,
//   and every hit before it runs at once, one a thread.  That step (a
//   Ghost hit or a miss) then runs on all 32 threads redundantly: every
//   decision is uniform, so nothing diverges and each thread holds the
//   state's cursors in registers.  The clock victim is found by the warp
//   together: each thread reads 4 slots a pass (128 a warp load),
//   __ballot_sync / __ffs take the first non-skippable one within the skip
//   limit, and the refs the hand passed are cleared in the same pass.
// * A tier per lane, chosen on the host by ops.plan_lane from the lane's
//   logical sizes and K (1 + the largest key of the trace and the rings;
//   a launch touches only loc_*[0, K)):
//     0  the whole lane in shared memory: loc_*[0, K) and the logical part
//        of every ring are copied in, all T steps run there, and everything
//        is copied back (every metadata lane, small data lanes);
//     1  the rings in shared memory, the location table in device memory;
//     2  the Small and Ghost rings in shared memory (every miss reads
//        them), the Main ring and the table in device memory;
//     3  all in device memory.
//   One launch serves a grid of mixed tiers.  Tiers 1 and 2 each beat tier
//   3 on the lanes the planner gives them (chip_smoke.py's tier_time:
//   1.32-1.33x and 1.10-1.14x at the w01-skewed and w04-scans sweeps).
// * A lookahead takes the table off the chain: thread i holds the table
//   entry of key t0 + i (the current window) and has the loads of key
//   t0 + 32 + i in flight (the next window).  Every table write of a
//   Ghost hit or a miss is applied to the entries of both windows that
//   hold the written key (a compare and a select a thread), so an entry
//   is never stale.
// * The trace is staged in shared memory through a ring of 16 windows of
//   32 keys, by 4-byte cp.async 14 windows ahead of use; hits are gathered
//   one a thread and stored 32 at a time.
// * The window loop (staging, lookahead, the rounds of hits and the step
//   between them) is lanes.cuh's drive(), shared with s3fifo_sim.cu and
//   simple_sim.cu; this file gives it the Clock2Q+ step (Clock2QPlus).
//
// What bounds it now (the chip runs in PERF.md): a window of hits costs a
// few hundred cycles of dependent warp instructions (ballot, the hits'
// shared-memory round trip, the window's advance); a Ghost hit or a miss
// a few hundred more.  Data traces, at miss ratios of 0.25-0.75, are bound
// by the serial misses; metadata traces, at 0.01-0.03, by the windows.
//
// Cursors are assumed inside their logical rings (spos < scap, hand <
// mcap, gpos < gcap), as every state the port makes or accepts is.
//
// Layout in device memory (all row-major, one row per lane): skey/sseq
// (L,pS) int32, sref (L,pS) bool, mkey (L,pM) int32, mref (L,pM) bool, gkey
// (L,pG) int32, loc_w (L,U) int8, loc_s (L,U) int32; spos/seqctr/hand/gpos
// and the logical sizes scap/mcap/gcap/window/skip_limit (L,) int32.

#include "../../lanes.cuh"

namespace {

constexpr int kNone = 0, kSmall = 1, kMain = 2, kGhost = 3;
constexpr int kScan = 4;  // slots each thread reads a pass of the clock scan

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* skey; unsigned char* sref; int* sseq; int* spos; int* seqctr;
  int* mkey; unsigned char* mref; int* hand; int* gkey; int* gpos;
  signed char* loc_w; int* loc_s;
  const int *scap, *mcap, *gcap, *window, *skip, *tier;
  int pS, pM, pG; long long U; int K;
};

// A table entry: where a key lives (kNone..kGhost) and its slot there.
struct Where {
  int w, s;
};

// The Clock2Q+ step for drive(); kMainShared: the Main ring in shared
// memory (else the clock scan's first pass is loaded beside a step's
// other loads; in shared memory it is loaded when needed).
template <bool kMainShared>
struct Clock2QPlus {
  using Entry = Where;
  int *skey, *sseq, *gkey, *mkey, *loc_s;
  unsigned char *sref, *mref;
  signed char* loc_w;
  int scap, mcap, gcap, window, skip, lane;
  int spos, seqctr, hand, gpos;

  __device__ __forceinline__ Where load(int k) const {
    return Where{loc_w[k], loc_s[k]};
  }
  __device__ __forceinline__ bool is_hit(Where e) const {
    return e.w == kSmall || e.w == kMain;
  }
  __device__ __forceinline__ void window_start(unsigned) {}
  __device__ __forceinline__ void window_end(unsigned) {}

  // A hit sets its slot's ref bit (in Small, only past the correlation
  // window); setting a bit is idempotent, so the hits of a round commute.
  __device__ __forceinline__ void hits(Look<Where>& lk, bool mine, unsigned,
                                       unsigned) {
    if (!mine) return;
    if (lk.ec.w == kMain) {
      mref[lk.ec.s] = 1;
    } else if (seqctr - sseq[lk.ec.s] >= window) {
      sref[lk.ec.s] = 1;
    }
  }

  // Thread lane's kScan slots of the clock scan's pass at distance `base`
  // from the hand: their slots, keys and refs.
  __device__ __forceinline__ void scan_load(int base, int (&ps)[kScan],
                                            int (&pk)[kScan],
                                            int (&pr)[kScan]) const {
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int d = base + q * kWarp + lane;
      int s = d < mcap ? hand + d : hand;
      if (s >= mcap) s -= mcap;
      ps[q] = s; pk[q] = mkey[s]; pr[q] = mref[s];
    }
  }

  // Inserts `ins` into the Main ring at the closed-form clock victim: the
  // first slot from the hand that is empty or not ref'd, within the skip
  // limit, else the slot at the limit; the refs the hand passed are
  // cleared.  ps/pk/pr hold the first pass where Main lives in device
  // memory.
  __device__ __forceinline__ void main_insert(Look<Where>& lk, int ins,
                                              int (&ps)[kScan],
                                              int (&pk)[kScan],
                                              int (&pr)[kScan]) {
    const int lim = (skip > 0 && skip < mcap) ? skip : mcap;
    int vd = lim, victim = 0;
    bool found = false;
    for (int base = 0;; base += kScan * kWarp) {
      if (kMainShared || base > 0) scan_load(base, ps, pk, pr);
      int first = -1, kfirst = pk[0];
#pragma unroll
      for (int q = kScan - 1; q >= 0; --q) {
        const int d = base + q * kWarp + lane;
        const unsigned stop =
            __ballot_sync(kAll, d < lim && (pk[q] < 0 || !pr[q]));
        if (stop) {
          first = q * kWarp + __ffs(stop) - 1;
          kfirst = pk[q];
        }
      }
      if (first >= 0) {
        found = true;
        vd = base + first;
        victim = __shfl_sync(kAll, kfirst, first & (kWarp - 1));
      }
#pragma unroll
      for (int q = 0; q < kScan; ++q) {  // refs the hand passed
        const int d = base + q * kWarp + lane;
        if (d < vd) mref[ps[q]] = 0;
      }
      if (found || base + kScan * kWarp >= lim) break;
    }
    __syncwarp();  // the cleared refs, before any thread reads them
    int ms = hand + vd;
    if (ms >= mcap) ms -= mcap;
    if (!found) victim = mkey[ms];
    if (victim >= 0) {
      loc_w[victim] = kNone;
      lk.fix(victim, Where{kNone, 0});
    }
    loc_w[ins] = kMain;
    loc_s[ins] = ms;
    lk.fix(ins, Where{kMain, ms});
    mkey[ms] = ins;
    mref[ms] = 0;
    hand = ms + 1 == mcap ? 0 : ms + 1;
  }

  // A Ghost hit or a miss.  The key that leaves the Ghost ring or the
  // Small FIFO is written to the table only where it lands (Main or
  // Ghost): the plain step first marks it kNone, a write every path
  // overwrites.
  __device__ __forceinline__ void miss(Look<Where>& lk, int f, unsigned) {
    const int key = __shfl_sync(kAll, lk.kc, f);
    const int where = __shfl_sync(kAll, lk.ec.w, f);
    const int slot = __shfl_sync(kAll, lk.ec.s, f);
    // loads that do not depend on the key
    const int disp = skey[spos];
    const int disp_ref = sref[spos];
    const int gold = gkey[gpos];
    int ps[kScan], pk[kScan], pr[kScan];
    if constexpr (!kMainShared) scan_load(0, ps, pk, pr);
    if (where == kGhost) {
      gkey[slot] = kEmpty;
      main_insert(lk, key, ps, pk, pr);
      return;
    }
    if (disp >= 0) {  // displace the Small-FIFO cursor slot
      if (disp_ref) {  // promote to Main
        main_insert(lk, disp, ps, pk, pr);
      } else {  // demote: push onto the Ghost ring
        if (gold >= 0) {
          loc_w[gold] = kNone;
          lk.fix(gold, Where{kNone, 0});
        }
        gkey[gpos] = disp;
        loc_w[disp] = kGhost;
        loc_s[disp] = gpos;
        lk.fix(disp, Where{kGhost, gpos});
        gpos = gpos + 1 == gcap ? 0 : gpos + 1;
      }
    }
    // the new key enters the Small FIFO
    skey[spos] = key;
    sref[spos] = 0;
    sseq[spos] = seqctr;
    loc_w[key] = kSmall;
    loc_s[key] = spos;
    lk.fix(key, Where{kSmall, spos});
    spos = spos + 1 == scap ? 0 : spos + 1;
    seqctr += 1;
  }
};

template <int kTier>
__device__ __forceinline__ void run_lane(const Args& a, int l, char* smem) {
  constexpr bool kLocShared = kTier == 0;
  constexpr bool kMainShared = kTier <= 1;
  constexpr bool kSmallShared = kTier <= 2;  // the Small and Ghost rings
  const int lane = threadIdx.x;
  const int scap = a.scap[l], mcap = a.mcap[l], gcap = a.gcap[l];
  const int K = a.K;

  int* const g_skey = a.skey + (long long)l * a.pS;
  int* const g_sseq = a.sseq + (long long)l * a.pS;
  unsigned char* const g_sref = a.sref + (long long)l * a.pS;
  int* const g_mkey = a.mkey + (long long)l * a.pM;
  unsigned char* const g_mref = a.mref + (long long)l * a.pM;
  int* const g_gkey = a.gkey + (long long)l * a.pG;
  signed char* const g_loc_w = a.loc_w + (long long)l * a.U;
  int* const g_loc_s = a.loc_s + (long long)l * a.U;

  // The trace ring first, then the working copies, in shared memory where
  // the tier keeps them there (the 32-bit arrays first, so each is 4-byte
  // aligned), else in device memory.  ops.plan_lane counts the same bytes.
  int* const ring = reinterpret_cast<int*>(smem);
  int* wcur = ring + kRing * kWarp;
  Clock2QPlus<kMainShared> p;
  p.loc_s = place<kLocShared>(wcur, g_loc_s, K, lane);
  p.skey = place<kSmallShared>(wcur, g_skey, scap, lane);
  p.sseq = place<kSmallShared>(wcur, g_sseq, scap, lane);
  p.gkey = place<kSmallShared>(wcur, g_gkey, gcap, lane);
  p.mkey = place<kMainShared>(wcur, g_mkey, mcap, lane);
  signed char* bcur = reinterpret_cast<signed char*>(wcur);
  p.loc_w = place<kLocShared>(bcur, g_loc_w, K, lane);
  unsigned char* ucur = reinterpret_cast<unsigned char*>(bcur);
  p.sref = place<kSmallShared>(ucur, g_sref, scap, lane);
  p.mref = place<kMainShared>(ucur, g_mref, mcap, lane);
  __syncwarp();
  p.scap = scap; p.mcap = mcap; p.gcap = gcap;
  p.window = a.window[l]; p.skip = a.skip[l]; p.lane = lane;
  p.spos = a.spos[l]; p.seqctr = a.seqctr[l];
  p.hand = a.hand[l]; p.gpos = a.gpos[l];
  const long long n = drive(p, ring, a.trace + (long long)l * a.trace_stride,
                            a.T, a.hits ? a.hits + (long long)l * a.T
                                        : nullptr, lane);
  if (lane == 0) {
    a.spos[l] = p.spos; a.seqctr[l] = p.seqctr;
    a.hand[l] = p.hand; a.gpos[l] = p.gpos;
    if (a.counts) a.counts[l] = n;
  }
  __syncwarp();  // copy the lane back, in the plain layout
  write_back<kLocShared>(g_loc_s, p.loc_s, K, lane);
  write_back<kLocShared>(g_loc_w, p.loc_w, K, lane);
  write_back<kSmallShared>(g_skey, p.skey, scap, lane);
  write_back<kSmallShared>(g_sseq, p.sseq, scap, lane);
  write_back<kSmallShared>(g_sref, p.sref, scap, lane);
  write_back<kSmallShared>(g_gkey, p.gkey, gcap, lane);
  write_back<kMainShared>(g_mkey, p.mkey, mcap, lane);
  write_back<kMainShared>(g_mref, p.mref, mcap, lane);
}

__global__ void __launch_bounds__(kWarp) cache_sim_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int l = blockIdx.x;
  switch (a.tier[l]) {
    case 0: run_lane<0>(a, l, smem); break;
    case 1: run_lane<1>(a, l, smem); break;
    case 2: run_lane<2>(a, l, smem); break;
    default: run_lane<3>(a, l, smem); break;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `tier` (L,) int32 on the card
// holds each lane's tier (0-3, ops.plan_lane), `K` the key range and
// `smem` the shared-memory bytes of every block (the largest a lane of the
// launch needs).  Launches on `stream`, does not synchronise, and returns
// the launch's cudaError_t (0 = cudaSuccess).
extern "C" int cache_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts,
    int* skey, unsigned char* sref, int* sseq, int* spos, int* seqctr,
    int* mkey, unsigned char* mref, int* hand, int* gkey, int* gpos,
    signed char* loc_w, int* loc_s,
    const int* scap, const int* mcap, const int* gcap,
    const int* window, const int* skip_limit, const int* tier,
    int L, int pS, int pM, int pG, long long U, int K, int smem,
    void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      cache_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a{trace, trace_stride, T, hits, counts, skey, sref, sseq, spos,
         seqctr, mkey, mref, hand, gkey, gpos, loc_w, loc_s, scap, mcap,
         gcap, window, skip_limit, tier, pS, pM, pG, U, K};
  cache_sim_kernel<<<L, kWarp, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
