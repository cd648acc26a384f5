// Lane-parallel Clock2Q+ trace replay for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_sim/cache_sim.py:46
// (_kernel, launched by cache_sim_raw).  It computes the function of the
// engine step, src/repro_torch/core/engine/clock2qplus.py::step (itself the
// port of src/repro/core/engine/clock2qplus.py:75), which is a superset of
// the TPU kernel: per-lane logical scap/mcap/gcap, window and skip_limit,
// the closed-form clock victim, and key < 0 as a no-op sentinel.  It reads
// and writes the plain version's state layout in place, so a state can pass
// between kernel and plain version at any chunk boundary.
//
// Design: one thread block per lane; the loop over the T requests runs
// inside the block (it replaces the TPU's sequential fori_loop).  Thread 0
// runs the scalar part of each step: the location-table lookup, the
// ref-bit updates, the Small-FIFO displacement and the Ghost push.  On a
// Main insert the whole block finds the clock victim: it walks the ring
// from the hand in chunks of blockDim slots, stops at the first chunk that
// holds a non-skippable slot (empty, or ref bit clear) or at the skip
// limit, takes the least such distance with a shared-memory atomicMin, and
// clears the refs of the slots the hand passed over.  The location tables
// and rings stay in device memory (L2 holds the hot ones).
//
// What bounds it on this card: each lane is a chain of T dependent steps,
// and each step is a few dependent loads (key -> loc_w/loc_s -> ring slot)
// at L2/HBM latency.  The bytes the function must move (state read and
// written once, the trace read once) would take a fraction of a
// millisecond at 3.35 TB/s, far below its time; the time is latency x T,
// and lanes only run side by side, one per SM.  So the figure of merit is
// ns per step, and the next steps are keeping the rings in shared memory,
// a warp-level lookup, and more lanes per SM.
//
// Layout (all row-major, one row per lane): skey/sseq (L,pS) int32,
// sref (L,pS) bool, mkey (L,pM) int32, mref (L,pM) bool, gkey (L,pG) int32,
// loc_w (L,U) int8, loc_s (L,U) int32; spos/seqctr/hand/gpos and the
// logical sizes scap/mcap/gcap/window/skip_limit (L,) int32.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEmpty = -1;
constexpr signed char kNone = 0, kSmall = 1, kMain = 2, kGhost = 3;

struct Lane {
  int* skey; unsigned char* sref; int* sseq;
  int* mkey; unsigned char* mref; int* gkey;
  signed char* loc_w; int* loc_s;
};

__global__ void __launch_bounds__(kThreads) cache_sim_kernel(
    const int* __restrict__ trace, long long trace_stride, long long T,
    unsigned char* __restrict__ hits, long long* __restrict__ counts,
    int* skey_all, unsigned char* sref_all, int* sseq_all,
    int* spos_all, int* seqctr_all,
    int* mkey_all, unsigned char* mref_all, int* hand_all,
    int* gkey_all, int* gpos_all,
    signed char* loc_w_all, int* loc_s_all,
    const int* scap_all, const int* mcap_all, const int* gcap_all,
    const int* window_all, const int* skip_all,
    int pS, int pM, int pG, long long U) {
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  Lane ln;
  ln.skey = skey_all + (long long)l * pS;
  ln.sref = sref_all + (long long)l * pS;
  ln.sseq = sseq_all + (long long)l * pS;
  ln.mkey = mkey_all + (long long)l * pM;
  ln.mref = mref_all + (long long)l * pM;
  ln.gkey = gkey_all + (long long)l * pG;
  ln.loc_w = loc_w_all + (long long)l * U;
  ln.loc_s = loc_s_all + (long long)l * U;
  const int* tr = trace + (long long)l * trace_stride;
  unsigned char* hrow = hits ? hits + (long long)l * T : nullptr;

  // Broadcast of thread 0's decision to the block.
  __shared__ int s_do_ins, s_hand, s_mcap, s_lim, s_k;

  // Thread 0's registers: the lane's cursors and logical sizes.
  int spos = 0, seqctr = 0, hand = 0, gpos = 0;
  int scap = 1, mcap = 1, gcap = 1, window = 0, skip = 0;
  long long count = 0;
  if (tid == 0) {
    spos = spos_all[l]; seqctr = seqctr_all[l];
    hand = hand_all[l]; gpos = gpos_all[l];
    scap = scap_all[l]; mcap = mcap_all[l]; gcap = gcap_all[l];
    window = window_all[l]; skip = skip_all[l];
  }

  int key = 0, ins_key = 0, is_none = 0;
  int next_key = (tid == 0 && T > 0) ? tr[0] : 0;
  for (long long t = 0; t < T; ++t) {
    // ---- phase A (thread 0): lookup, hits, ghost hit, displacement ----
    if (tid == 0) {
      key = next_key;
      if (t + 1 < T) next_key = tr[t + 1];
      int do_ins = 0, hit = 0;
      is_none = 0;
      if (key >= 0) {  // key < 0: padding, a no-op that never hits
        const signed char where = ln.loc_w[key];
        const int slot = ln.loc_s[key];
        if (where == kSmall) {
          hit = 1;
          if (seqctr - ln.sseq[slot] >= window) ln.sref[slot] = 1;
        } else if (where == kMain) {
          hit = 1;
          ln.mref[slot] = 1;
        } else if (where == kGhost) {
          ln.gkey[slot] = kEmpty;
          ln.loc_w[key] = kNone;
          do_ins = 1;
          ins_key = key;
        } else {  // miss: displace the Small-FIFO cursor slot
          is_none = 1;
          const int displaced = ln.skey[spos];
          if (displaced >= 0) {
            ln.loc_w[displaced] = kNone;
            if (ln.sref[spos]) {  // promote to Main
              do_ins = 1;
              ins_key = displaced;
            } else {  // demote: push onto the Ghost ring
              const int gold = ln.gkey[gpos];
              if (gold >= 0) ln.loc_w[gold] = kNone;
              ln.gkey[gpos] = displaced;
              ln.loc_w[displaced] = kGhost;
              ln.loc_s[displaced] = gpos;
              gpos = (gpos + 1) % gcap;
            }
          }
        }
      }
      if (hrow) hrow[t] = (unsigned char)hit;
      count += hit;
      s_do_ins = do_ins;
      s_hand = hand;
      s_mcap = mcap;
      s_lim = (skip > 0 && skip < mcap) ? skip : mcap;
      s_k = INT_MAX;
    }
    __syncthreads();

    // ---- Main insert (whole block): the closed-form clock victim ----
    if (s_do_ins) {
      const int h = s_hand, mc = s_mcap, lim = s_lim;
      int vd = lim;  // no non-skippable slot before the limit
      for (int base = 0; base < lim; base += kThreads) {
        const int d = base + tid;
        bool stop = false;
        if (d < lim) {
          int s = h + d;
          if (s >= mc) s -= mc;
          stop = ln.mkey[s] < 0 || !ln.mref[s];
        }
        if (__syncthreads_or(stop)) {  // uniform across the block
          if (stop) atomicMin(&s_k, d);
          __syncthreads();
          vd = s_k;
          break;
        }
      }
      for (int d = tid; d < vd; d += kThreads) {  // refs the hand passed
        int s = h + d;
        if (s >= mc) s -= mc;
        ln.mref[s] = 0;
      }
      __syncthreads();
      if (tid == 0) {
        int ms = h + vd;
        if (ms >= mc) ms -= mc;
        const int victim = ln.mkey[ms];
        if (victim >= 0) ln.loc_w[victim] = kNone;
        ln.loc_w[ins_key] = kMain;
        ln.loc_s[ins_key] = ms;
        ln.mkey[ms] = ins_key;
        ln.mref[ms] = 0;
        hand = ms + 1 == mc ? 0 : ms + 1;
      }
    }

    // ---- phase B (thread 0): the new key enters the Small FIFO ----
    if (tid == 0 && is_none) {
      ln.skey[spos] = key;
      ln.sref[spos] = 0;
      ln.sseq[spos] = seqctr;
      ln.loc_w[key] = kSmall;
      ln.loc_s[key] = spos;
      spos = (spos + 1) % scap;
      seqctr += 1;
    }
    // The next step's thread 0 rewrites the shared decision: wait until
    // every thread has read this one.
    __syncthreads();
  }

  if (tid == 0) {
    spos_all[l] = spos; seqctr_all[l] = seqctr;
    hand_all[l] = hand; gpos_all[l] = gpos;
    if (counts) counts[l] = count;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int cache_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts,
    int* skey, unsigned char* sref, int* sseq, int* spos, int* seqctr,
    int* mkey, unsigned char* mref, int* hand, int* gkey, int* gpos,
    signed char* loc_w, int* loc_s,
    const int* scap, const int* mcap, const int* gcap,
    const int* window, const int* skip_limit,
    int L, int pS, int pM, int pG, long long U, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  cache_sim_kernel<<<L, kThreads, 0, (cudaStream_t)stream>>>(
      trace, trace_stride, T, hits, counts, skey, sref, sseq, spos, seqctr,
      mkey, mref, hand, gkey, gpos, loc_w, loc_s, scap, mcap, gcap, window,
      skip_limit, pS, pM, pG, U);
  return (int)cudaGetLastError();
}
