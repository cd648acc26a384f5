// Lane-parallel S3-FIFO trace replay for Hopper (sm_90a).
//
// Replaces the reference's XLA step src/repro/core/engine/s3fifo.py:64
// (`step`, run as jit(lax.scan) vmapped over lanes); the reference has no
// Pallas kernel for this family.  It computes the function of the port's
// plain step, src/repro_torch/core/engine/s3fifo.py::step, over a whole
// trace: per-lane logical scap/mcap/gcap, freq_cap/promote_at (the `bits`
// knob) and skip_limit, and key < 0 as a no-op sentinel.  It reads and
// writes the plain version's state layout, so a state can pass between
// kernel and plain version at any chunk boundary.
//
// What bounds it on this card: each lane is a chain of T dependent steps.
// The bytes the function must move take a fraction of a millisecond at
// 3.35 TB/s; the time is the latency of the steps' dependent round trips,
// and lanes only run side by side.  The design is cache_sim.cu's:
//
// * One warp a lane, one lane a block, and no block barrier.  A hit only
//   bumps a saturating freq, and n hits to one slot give min(freq_cap,
//   f + n) in any order: thread i owns step t0 + i of a window of 32, a
//   __ballot_sync finds the first step of the window that is neither a hit
//   nor padding, and every hit before it runs at once.  Where two hits or
//   more run, each adds 1 by atomicAdd and every hit that found the freq
//   at freq_cap or above writes freq_cap back, so repeated keys add up
//   exactly; a lone hit adds without an atomic, and a round without hits
//   runs no collective.  (Grouping keys by __match_any_sync instead
//   was slower on the card: PERF.md section 6.)  That
//   step (a Ghost hit or a miss) then runs on all 32 threads
//   redundantly, the cursors in registers.
// * The Main ring's eviction is the FIFO-with-reinsertion walk, done by
//   the warp 32 positions a pass.  From mhead, position p visits slot
//   (mhead + p) mod mcap; a slot of freq f first presents 0 at distance d
//   + f * mcap, and every visit before the stop takes one freq.  Thread i
//   reads its slot's freq at the pass's start and subtracts the visits of
//   that slot earlier in the pass ((p - b) / mcap: rings shorter than a
//   warp are visited several times a pass); __ballot_sync / __ffs take
//   the first position that presents 0 or reaches skip_limit (0 =
//   unlimited), and each slot's last visit before it writes the slot's
//   freq, so the decrements are the serial walk's.  Each reinsertion
//   spends a freq a hit gave: amortised O(1) a request.
// * A tier per lane, chosen on the host by ops.plan_lane from the lane's
//   logical sizes and K (1 + the largest key of the trace and the rings):
//     0  the whole lane in shared memory: loc_*[0, K) and every ring
//        (every metadata lane);
//     1  the rings there, the location table in device memory;
//     2  the Small and Ghost rings there (every miss reads them), the Main
//        ring and the table in device memory;
//     3  all in device memory.
//   One launch serves a grid of mixed tiers.
// * A lookahead takes the table off the chain: thread i holds the table
//   entry of key t0 + i and has the loads of key t0 + 32 + i in flight;
//   every table write of a Ghost hit or a miss (the new key, the displaced
//   Small key, the old Ghost key, the Main victim) is applied to the
//   entries of both windows that hold the written key.
// * The trace is staged in shared memory through a ring of 16 windows of
//   32 keys, by 4-byte cp.async 14 windows ahead of use.
//
// Cursors are assumed inside their logical rings (spos < scap, mhead <
// mcap, mcount <= mcap, gpos < gcap), as ops.check_values holds at every
// launch.
//
// Layout in device memory (row-major, one row per lane): skey/sfreq
// (L,pS), mkey/mfreq (L,pM), gkey (L,pG) int32; loc_w (L,U) int8, loc_s
// (L,U) int32; spos/mhead/mcount/gpos and freq_cap/promote_at/scap/mcap/
// gcap/skip_limit (L,) int32.

#include "../../lanes.cuh"

namespace {

constexpr int kNone = 0, kSmall = 1, kMain = 2, kGhost = 3;

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* skey; int* sfreq; int* spos;
  int* mkey; int* mfreq; int* mhead; int* mcount;
  int* gkey; int* gpos;
  signed char* loc_w; int* loc_s;
  const int *freq_cap, *promote_at, *scap, *mcap, *gcap, *skip, *tier;
  int pS, pM, pG; long long U; int K;
};

// A table entry: where a key lives (kNone..kGhost) and its slot there.
struct Where {
  int w, s;
};

// The S3-FIFO step for drive(); kMainShared: the Main ring in shared
// memory (else its first walk pass is loaded beside a step's other loads).
template <bool kMainShared>
struct S3Fifo {
  using Entry = Where;
  int *skey, *sfreq, *gkey, *mkey, *mfreq, *loc_s;
  signed char* loc_w;
  int scap, mcap, gcap, fcap, promote_at, skip, lane;
  int spos, mhead, mcount, gpos;

  __device__ __forceinline__ Where load(int k) const {
    return Where{loc_w[k], loc_s[k]};
  }
  __device__ __forceinline__ bool is_hit(Where e) const {
    return e.w == kSmall || e.w == kMain;
  }
  __device__ __forceinline__ void window_start(unsigned) {}
  __device__ __forceinline__ void window_end(unsigned) {}

  __device__ __forceinline__ void hits(Look<Where>& lk, bool mine,
                                       unsigned hm, unsigned) {
    int* const fr = lk.ec.w == kSmall ? sfreq : mfreq;
    const int s = lk.ec.s;
    if (hm & (hm - 1u)) {
      // repeated keys add up by atomics; the hit that took its slot past
      // freq_cap (the last of them) clamps it
      const int old = mine ? atomicAdd(&fr[s], 1) : 0;
      __syncwarp();
      if (mine && old >= fcap) fr[s] = fcap;
    } else if (mine) {
      fr[s] = min(fcap, fr[s] + 1);
    }
  }

  // Inserts `ins` into the Main ring: at the tail while it fills, else in
  // the slot of the victim of the reinsertion walk.  `pre` is thread
  // lane's freq of the walk's first pass where Main lives in device memory.
  __device__ __forceinline__ void main_insert(Look<Where>& lk, int ins,
                                              int pre) {
    int ms;
    if (mcount < mcap) {
      ms = mhead + mcount;
      if (ms >= mcap) ms -= mcap;
      ++mcount;
    } else {
      int stop_at = 0;
      for (int b = 0;; b += kWarp) {
        const int p = b + lane;
        const int s = (mhead + p) % mcap;
        const int f0 = (kMainShared || b > 0) ? mfreq[s] : pre;
        const int cur = f0 - (p - b) / mcap;  // less this pass's visits
        const unsigned stop =
            __ballot_sync(kAll, cur < 1 || (skip > 0 && p >= skip));
        const int end = stop ? b + __ffs(stop) - 1 : b + kWarp;
        // each slot's last visit before the stop writes its freq
        if (p < end && p + mcap >= end) mfreq[s] = cur - 1;
        __syncwarp();
        if (stop) {
          stop_at = end;
          break;
        }
      }
      ms = (mhead + stop_at) % mcap;
      const int victim = mkey[ms];
      if (victim >= 0) {
        loc_w[victim] = kNone;
        lk.fix(victim, Where{kNone, 0});
      }
      mhead = ms + 1 == mcap ? 0 : ms + 1;
    }
    loc_w[ins] = kMain;
    loc_s[ins] = ms;
    lk.fix(ins, Where{kMain, ms});
    mkey[ms] = ins;
    mfreq[ms] = 0;
  }

  // A Ghost hit or a miss.  The key that leaves the Small FIFO or the
  // Ghost ring is written to the table only where it lands (Main or
  // Ghost): the plain step first marks it kNone, a write every path
  // overwrites.
  __device__ __forceinline__ void miss(Look<Where>& lk, int f, unsigned) {
    const int key = __shfl_sync(kAll, lk.kc, f);
    const int where = __shfl_sync(kAll, lk.ec.w, f);
    const int slot = __shfl_sync(kAll, lk.ec.s, f);
    // loads that do not depend on the key
    const int disp = skey[spos];
    const int dfreq = sfreq[spos];
    const int gold = gkey[gpos];
    int pre = 0;
    if constexpr (!kMainShared) pre = mfreq[(mhead + lane) % mcap];
    if (where == kGhost) {
      gkey[slot] = kEmpty;
      main_insert(lk, key, pre);
      return;
    }
    if (disp >= 0) {  // displace the Small-FIFO cursor slot
      if (dfreq >= promote_at) {  // promote to Main
        main_insert(lk, disp, pre);
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
    sfreq[spos] = 0;
    loc_w[key] = kSmall;
    loc_s[key] = spos;
    lk.fix(key, Where{kSmall, spos});
    spos = spos + 1 == scap ? 0 : spos + 1;
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
  int* const g_sfreq = a.sfreq + (long long)l * a.pS;
  int* const g_mkey = a.mkey + (long long)l * a.pM;
  int* const g_mfreq = a.mfreq + (long long)l * a.pM;
  int* const g_gkey = a.gkey + (long long)l * a.pG;
  signed char* const g_loc_w = a.loc_w + (long long)l * a.U;
  int* const g_loc_s = a.loc_s + (long long)l * a.U;

  // The trace ring first, then the working copies, in shared memory where
  // the tier keeps them there (the 32-bit arrays first), else in device
  // memory.  ops.plan_lane counts the same bytes.
  int* const ring = reinterpret_cast<int*>(smem);
  int* wcur = ring + kRing * kWarp;
  S3Fifo<kMainShared> p;
  p.loc_s = place<kLocShared>(wcur, g_loc_s, K, lane);
  p.skey = place<kSmallShared>(wcur, g_skey, scap, lane);
  p.sfreq = place<kSmallShared>(wcur, g_sfreq, scap, lane);
  p.gkey = place<kSmallShared>(wcur, g_gkey, gcap, lane);
  p.mkey = place<kMainShared>(wcur, g_mkey, mcap, lane);
  p.mfreq = place<kMainShared>(wcur, g_mfreq, mcap, lane);
  signed char* bcur = reinterpret_cast<signed char*>(wcur);
  p.loc_w = place<kLocShared>(bcur, g_loc_w, K, lane);
  __syncwarp();
  p.scap = scap; p.mcap = mcap; p.gcap = gcap;
  p.fcap = a.freq_cap[l]; p.promote_at = a.promote_at[l];
  p.skip = a.skip[l]; p.lane = lane;
  p.spos = a.spos[l]; p.mhead = a.mhead[l];
  p.mcount = a.mcount[l]; p.gpos = a.gpos[l];
  const long long n = drive(p, ring, a.trace + (long long)l * a.trace_stride,
                            a.T, a.hits ? a.hits + (long long)l * a.T
                                        : nullptr, lane);
  if (lane == 0) {
    a.spos[l] = p.spos; a.mhead[l] = p.mhead;
    a.mcount[l] = p.mcount; a.gpos[l] = p.gpos;
    if (a.counts) a.counts[l] = n;
  }
  __syncwarp();  // copy the lane back, in the plain layout
  write_back<kLocShared>(g_loc_s, p.loc_s, K, lane);
  write_back<kLocShared>(g_loc_w, p.loc_w, K, lane);
  write_back<kSmallShared>(g_skey, p.skey, scap, lane);
  write_back<kSmallShared>(g_sfreq, p.sfreq, scap, lane);
  write_back<kSmallShared>(g_gkey, p.gkey, gcap, lane);
  write_back<kMainShared>(g_mkey, p.mkey, mcap, lane);
  write_back<kMainShared>(g_mfreq, p.mfreq, mcap, lane);
}

__global__ void __launch_bounds__(kWarp) s3fifo_sim_kernel(Args a) {
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

// Plain C entry point (bound with ctypes).  `trace` is (T,) shared by the
// lanes (trace_stride 0) or (L, T) (trace_stride T); exactly one of `hits`
// (L, T) bool and `counts` (L,) int64 is non-null.  `tier` (L,) int32 on
// the card holds each lane's tier (0-3, ops.plan_lane), `K` the key range
// and `smem` the shared-memory bytes of every block (the largest a lane of
// the launch needs).  Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int s3fifo_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts,
    int* skey, int* sfreq, int* spos, int* mkey, int* mfreq, int* mhead,
    int* mcount, int* gkey, int* gpos, signed char* loc_w, int* loc_s,
    const int* freq_cap, const int* promote_at, const int* scap,
    const int* mcap, const int* gcap, const int* skip_limit,
    const int* tier, int L, int pS, int pM, int pG, long long U, int K,
    int smem, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      s3fifo_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a{trace, trace_stride, T, hits, counts, skey, sfreq, spos, mkey,
         mfreq, mhead, mcount, gkey, gpos, loc_w, loc_s, freq_cap,
         promote_at, scap, mcap, gcap, skip_limit, tier, pS, pM, pG, U, K};
  s3fifo_sim_kernel<<<L, kWarp, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
