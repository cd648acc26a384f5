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

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kEmpty = -1;
constexpr int kNone = 0, kSmall = 1, kMain = 2, kGhost = 3;
constexpr int kScan = 4;  // slots each thread reads a pass of the clock scan
// Windows of the trace staged in shared memory: kRing * kWarp * 4 bytes at
// the start of every block's shared memory (ops.TRACE_BYTES).
constexpr int kRing = 16;

// Thread `lane` stages key t of the trace row (or -1 past T) in `slot` of
// the shared ring, asynchronously (4-byte cp.async, no register waits on
// it); the caller commits the window's group.
__device__ __forceinline__ void stage_key(int* slot, const int* tr,
                                          long long t, long long T) {
  if (t < T) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(slot);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                 "l"(tr + t)
                 : "memory");
  } else {
    *slot = -1;
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* skey; unsigned char* sref; int* sseq; int* spos; int* seqctr;
  int* mkey; unsigned char* mref; int* hand; int* gkey; int* gpos;
  signed char* loc_w; int* loc_s;
  const int *scap, *mcap, *gcap, *window, *skip, *tier;
  int pS, pM, pG; long long U; int K;
};

template <typename E>
__device__ __forceinline__ void copy_row(E* dst, const E* src, int n,
                                         int lane) {
#pragma unroll 4
  for (int i = lane; i < n; i += kWarp) dst[i] = src[i];
}

// The working copy of one array of n elements: in shared memory at
// `cursor` (advanced past it, the array copied in) where kShared, else the
// array in device memory itself.
template <bool kShared, typename E>
__device__ __forceinline__ E* place(E*& cursor, E* g, int n, int lane) {
  if constexpr (kShared) {
    E* p = cursor;
    cursor += n;
    copy_row(p, g, n, lane);
    return p;
  } else {
    return g;
  }
}

template <bool kShared, typename E>
__device__ __forceinline__ void write_back(E* g, const E* p, int n,
                                           int lane) {
  if constexpr (kShared) copy_row(g, p, n, lane);
}

template <int kTier>
__device__ __forceinline__ void run_lane(const Args& a, int l, char* smem) {
  constexpr bool kLocShared = kTier == 0;
  constexpr bool kMainShared = kTier <= 1;
  constexpr bool kSmallShared = kTier <= 2;  // the Small and Ghost rings
  const int lane = threadIdx.x;
  const int scap = a.scap[l], mcap = a.mcap[l], gcap = a.gcap[l];
  const int window = a.window[l], skip = a.skip[l];
  const int K = a.K;
  const long long T = a.T;

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
  const int words = (kLocShared ? K : 0) + (kMainShared ? mcap : 0) +
                    (kSmallShared ? 2 * scap + gcap : 0);
  int* wcur = ring + kRing * kWarp;
  signed char* bcur = reinterpret_cast<signed char*>(wcur + words);
  int* const loc_s = place<kLocShared>(wcur, g_loc_s, K, lane);
  int* const skey = place<kSmallShared>(wcur, g_skey, scap, lane);
  int* const sseq = place<kSmallShared>(wcur, g_sseq, scap, lane);
  int* const gkey = place<kSmallShared>(wcur, g_gkey, gcap, lane);
  int* const mkey = place<kMainShared>(wcur, g_mkey, mcap, lane);
  signed char* const loc_w = place<kLocShared>(bcur, g_loc_w, K, lane);
  unsigned char* ucur = reinterpret_cast<unsigned char*>(bcur);
  unsigned char* const sref = place<kSmallShared>(ucur, g_sref, scap, lane);
  unsigned char* const mref = place<kMainShared>(ucur, g_mref, mcap, lane);
  __syncwarp();

  int spos = a.spos[l], seqctr = a.seqctr[l], hand = a.hand[l];
  int gpos = a.gpos[l];
  long long count = 0;
  const int* tr = a.trace + (long long)l * a.trace_stride;
  unsigned char* hrow = a.hits ? a.hits + (long long)l * T : nullptr;

  // The trace goes through a ring of kRing windows in shared memory: a
  // window's keys are staged kRing - 2 windows before their first use, so
  // the trace's latency never reaches the step.  Thread i holds the key
  // of step t0 + i of the current window (kc) and of the next (kn).
  for (int w = 0; w + 1 < kRing; ++w) {
    stage_key(ring + w * kWarp + lane, tr, (long long)w * kWarp + lane, T);
    commit_group();
  }
  wait_group<kRing - 3>();  // windows 0 and 1
  int kc = ring[lane], kn = ring[kWarp + lane];
  // The table entries of kc (current) and kn (loads in flight), and the
  // writes to kn's key made since its loads were issued.
  int wc = 0, sc = 0, wn = 0, sn = 0, ow = 0, os = 0;
  bool ovw = false, ovs = false;
  if (kc >= 0) { wc = loc_w[kc]; sc = loc_s[kc]; }
  if (kn >= 0) { wn = loc_w[kn]; sn = loc_s[kn]; }
  // A write of the table, (k, w) and the slot s where has_s, applied to
  // the entries of both windows that hold k.
  auto fix = [&](int k, int w, int s, bool has_s) {
    if (kc == k) { wc = w; if (has_s) sc = s; }
    if (kn == k) {
      ow = w; ovw = true;
      if (has_s) { os = s; ovs = true; }
    }
  };

  for (long long t0 = 0; t0 < T; t0 += kWarp) {
    if (t0 > 0) {  // advance the windows
      const long long w = t0 / kWarp;
      stage_key(ring + ((w + kRing - 2) & (kRing - 1)) * kWarp + lane, tr,
                t0 + (long long)(kRing - 2) * kWarp + lane, T);
      commit_group();
      wait_group<kRing - 3>();  // window w + 1
      kc = kn;
      kn = ring[((w + 1) & (kRing - 1)) * kWarp + lane];
      wc = ovw ? ow : wn;
      sc = ovs ? os : sn;
      ovw = ovs = false;
      wn = sn = 0;
      if (kn >= 0) { wn = loc_w[kn]; sn = loc_s[kn]; }
    }
    // Thread i owns step t0 + i (past T a padding key, -1).  A hit only
    // sets a ref bit, and hits commute: each run of them, up to the next
    // step that is neither a hit nor padding, runs at once, a step a
    // thread; that step (a Ghost hit or a miss) then runs on the whole
    // warp, and its table writes reach the later entries of the window.
    int hbit = 0;
    for (int pos = 0;;) {
      const bool easy = kc < 0 || wc == kSmall || wc == kMain;
      const unsigned stop = __ballot_sync(kAll, !easy) & (kAll << pos);
      const int f = stop ? __ffs(stop) - 1 : kWarp;
      if (lane >= pos && lane < f && kc >= 0) {  // a hit
        hbit = 1;
        if (wc == kMain) {
          mref[sc] = 1;
        } else if (seqctr - sseq[sc] >= window) {  // the correlation window
          sref[sc] = 1;
        }
      }
      if (f == kWarp) break;
      __syncwarp();  // the refs set, before any thread reads them
      const int key = __shfl_sync(kAll, kc, f);
      const int where = __shfl_sync(kAll, wc, f);
      const int slot = __shfl_sync(kAll, sc, f);
      pos = f + 1;
      {  // a Ghost hit or a miss
        // Loads that do not depend on the key.  The clock scan's first
        // pass is loaded here, beside them, only where the Main ring lives
        // in device memory; in shared memory it is loaded when needed.
        const int disp = skey[spos];
        const int disp_ref = sref[spos];
        const int gold = gkey[gpos];
        int pk[kScan], pr[kScan], ps[kScan];
        auto scan_load = [&](int base) {
#pragma unroll
          for (int q = 0; q < kScan; ++q) {
            const int d = base + q * kWarp + lane;
            int s = d < mcap ? hand + d : hand;
            if (s >= mcap) s -= mcap;
            ps[q] = s; pk[q] = mkey[s]; pr[q] = mref[s];
          }
        };
        if constexpr (!kMainShared) scan_load(0);
        // The key that leaves the Ghost ring or the Small FIFO is written
        // to the table only where it lands (Main or Ghost): the plain step
        // first marks it kNone, a write every path overwrites.
        int do_ins = 0, ins_key = 0, is_none = 0;
        if (where == kGhost) {
          gkey[slot] = kEmpty;
          do_ins = 1;
          ins_key = key;
        } else {  // miss: displace the Small-FIFO cursor slot
          is_none = 1;
          if (disp >= 0) {
            if (disp_ref) {  // promote to Main
              do_ins = 1;
              ins_key = disp;
            } else {  // demote: push onto the Ghost ring
              if (gold >= 0) {
                loc_w[gold] = kNone; fix(gold, kNone, 0, false);
              }
              gkey[gpos] = disp;
              loc_w[disp] = kGhost;
              loc_s[disp] = gpos;
              fix(disp, kGhost, gpos, true);
              gpos = gpos + 1 == gcap ? 0 : gpos + 1;
            }
          }
        }

        if (do_ins) {  // Main insert: the closed-form clock victim
          const int lim = (skip > 0 && skip < mcap) ? skip : mcap;
          int vd = lim, victim = 0;
          bool found = false;
          for (int base = 0;; base += kScan * kWarp) {
            if (kMainShared || base > 0) scan_load(base);
            int first = -1, kfirst = pk[0];
#pragma unroll
            for (int q = kScan - 1; q >= 0; --q) {
              const int d = base + q * kWarp + lane;
              const unsigned stop = __ballot_sync(
                  kAll, d < lim && (pk[q] < 0 || !pr[q]));
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
            loc_w[victim] = kNone; fix(victim, kNone, 0, false);
          }
          loc_w[ins_key] = kMain;
          loc_s[ins_key] = ms;
          fix(ins_key, kMain, ms, true);
          mkey[ms] = ins_key;
          mref[ms] = 0;
          hand = ms + 1 == mcap ? 0 : ms + 1;
        }

        if (is_none) {  // the new key enters the Small FIFO
          skey[spos] = key;
          sref[spos] = 0;
          sseq[spos] = seqctr;
          loc_w[key] = kSmall;
          loc_s[key] = spos;
          fix(key, kSmall, spos, true);
          spos = spos + 1 == scap ? 0 : spos + 1;
          seqctr += 1;
        }
      }
      if (pos == kWarp) break;
    }
    count += __popc(__ballot_sync(kAll, hbit));
    if (hrow && t0 + lane < T) hrow[t0 + lane] = (unsigned char)hbit;
  }

  if (lane == 0) {
    a.spos[l] = spos; a.seqctr[l] = seqctr;
    a.hand[l] = hand; a.gpos[l] = gpos;
    if (a.counts) a.counts[l] = count;
  }
  __syncwarp();  // copy the lane back, in the plain layout
  write_back<kLocShared>(g_loc_s, loc_s, K, lane);
  write_back<kLocShared>(g_loc_w, loc_w, K, lane);
  write_back<kSmallShared>(g_skey, skey, scap, lane);
  write_back<kSmallShared>(g_sseq, sseq, scap, lane);
  write_back<kSmallShared>(g_sref, sref, scap, lane);
  write_back<kSmallShared>(g_gkey, gkey, gcap, lane);
  write_back<kMainShared>(g_mkey, mkey, mcap, lane);
  write_back<kMainShared>(g_mref, mref, mcap, lane);
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
