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
// The Main ring's eviction is the FIFO-with-reinsertion walk itself, not
// the reference's closed form: from mhead, a slot with freq >= 1 loses one
// freq and the walk moves on, until a slot presents freq 0 or skip_limit
// reinsertions were made (0 = unlimited); that slot is the victim and the
// head moves past it.  The first position at which slot i presents freq 0
// is d(i) + f(i) * mcap, so the walk stops at the reference's p =
// min_i(d(i) + f(i) * mcap) capped at skip_limit, with the same freq
// decrements; each reinsertion spends one unit of freq that a hit gave, so
// the walk costs amortised O(1) a request.
//
// What bounds it: each lane is a chain of T dependent steps; the bytes the
// function must move take a fraction of a millisecond, the time is the
// latency of each step's dependent round trips to memory (the location
// table entry of the key, then the ring slots it names).  This first
// version is one thread a lane, one lane a block, the whole state in
// device memory (the tables of a sweep's lanes fit the 50 MB L2); the trace
// key of the next step is loaded while the present step runs.
//
// Cursors are assumed inside their logical rings (spos < scap, mhead <
// mcap, mcount <= mcap, gpos < gcap), as every state the port makes or
// accepts is (ops.check_values holds them at every launch).
//
// Layout in device memory (row-major, one row per lane): skey/sfreq
// (L,pS), mkey/mfreq (L,pM), gkey (L,pG) int32; loc_w (L,U) int8, loc_s
// (L,U) int32; spos/mhead/mcount/gpos and freq_cap/promote_at/scap/mcap/
// gcap/skip_limit (L,) int32.

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kNone = 0, kSmall = 1, kMain = 2, kGhost = 3;

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* skey; int* sfreq; int* spos;
  int* mkey; int* mfreq; int* mhead; int* mcount;
  int* gkey; int* gpos;
  signed char* loc_w; int* loc_s;
  const int *freq_cap, *promote_at, *scap, *mcap, *gcap, *skip;
  int pS, pM, pG; long long U;
};

__device__ __forceinline__ int wrap(int i, int n) { return i + 1 == n ? 0 : i + 1; }

__global__ void __launch_bounds__(1) s3fifo_sim_kernel(Args a) {
  const int l = blockIdx.x;
  const long long T = a.T;
  const int* __restrict__ tr = a.trace + l * a.trace_stride;
  int* skey = a.skey + (long long)l * a.pS;
  int* sfreq = a.sfreq + (long long)l * a.pS;
  int* mkey = a.mkey + (long long)l * a.pM;
  int* mfreq = a.mfreq + (long long)l * a.pM;
  int* gkey = a.gkey + (long long)l * a.pG;
  signed char* loc_w = a.loc_w + l * a.U;
  int* loc_s = a.loc_s + l * a.U;
  const int freq_cap = a.freq_cap[l], promote_at = a.promote_at[l];
  const int scap = a.scap[l], mcap = a.mcap[l], gcap = a.gcap[l];
  const int skip = a.skip[l];
  int spos = a.spos[l], mhead = a.mhead[l], mcount = a.mcount[l];
  int gpos = a.gpos[l];
  unsigned char* hits = a.hits ? a.hits + l * T : nullptr;

  // Insert `ins` into the Main ring: at the tail while it fills, else in
  // the slot of the victim of the reinsertion walk.
  auto main_insert = [&](int ins) {
    int ms;
    if (mcount >= mcap) {
      ms = mhead;
      for (int p = 0;; ++p) {
        const int f = mfreq[ms];
        if (f < 1 || (skip > 0 && p >= skip)) break;
        mfreq[ms] = f - 1;
        ms = wrap(ms, mcap);
      }
      const int victim = mkey[ms];
      if (victim >= 0) loc_w[victim] = kNone;
      mhead = wrap(ms, mcap);
    } else {
      ms = mhead + mcount;
      if (ms >= mcap) ms -= mcap;
      ++mcount;
    }
    loc_w[ins] = kMain;
    loc_s[ins] = ms;
    mkey[ms] = ins;
    mfreq[ms] = 0;
  };

  long long n_hits = 0;
  int key = T > 0 ? tr[0] : kEmpty;
  for (long long t = 0; t < T; ++t) {
    const int next = t + 1 < T ? tr[t + 1] : kEmpty;  // off the chain
    bool hit = false;
    if (key >= 0) {
      const int where = loc_w[key];
      const int slot = loc_s[key];
      if (where == kSmall) {
        sfreq[slot] = min(freq_cap, sfreq[slot] + 1);
        hit = true;
      } else if (where == kMain) {
        mfreq[slot] = min(freq_cap, mfreq[slot] + 1);
        hit = true;
      } else if (where == kGhost) {
        gkey[slot] = kEmpty;
        loc_w[key] = kNone;
        main_insert(key);
      } else {
        // miss: displace the Small FIFO's cursor slot
        const int displaced = skey[spos];
        if (displaced >= 0) {
          const bool promote = sfreq[spos] >= promote_at;
          loc_w[displaced] = kNone;
          if (promote) {
            main_insert(displaced);
          } else {  // demote: ghost-push the displaced key
            const int gold = gkey[gpos];
            if (gold >= 0) loc_w[gold] = kNone;
            gkey[gpos] = displaced;
            loc_w[displaced] = kGhost;
            loc_s[displaced] = gpos;
            gpos = wrap(gpos, gcap);
          }
        }
        skey[spos] = key;
        sfreq[spos] = 0;
        loc_w[key] = kSmall;
        loc_s[key] = spos;
        spos = wrap(spos, scap);
      }
    }
    if (hits) hits[t] = hit;
    n_hits += hit;
    key = next;
  }
  a.spos[l] = spos;
  a.mhead[l] = mhead;
  a.mcount[l] = mcount;
  a.gpos[l] = gpos;
  if (a.counts) a.counts[l] = n_hits;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `trace` is (T,) shared by the
// lanes (trace_stride 0) or (L, T) (trace_stride T); exactly one of `hits`
// (L, T) bool and `counts` (L,) int64 is non-null.  Launches on `stream`,
// does not synchronise, and returns the launch's cudaError_t (0 =
// cudaSuccess).
extern "C" int s3fifo_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts,
    int* skey, int* sfreq, int* spos, int* mkey, int* mfreq, int* mhead,
    int* mcount, int* gkey, int* gpos, signed char* loc_w, int* loc_s,
    const int* freq_cap, const int* promote_at, const int* scap,
    const int* mcap, const int* gcap, const int* skip_limit,
    int L, int pS, int pM, int pG, long long U, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  Args a{trace, trace_stride, T, hits, counts, skey, sfreq, spos, mkey,
         mfreq, mhead, mcount, gkey, gpos, loc_w, loc_s, freq_cap,
         promote_at, scap, mcap, gcap, skip_limit, pS, pM, pG, U};
  s3fifo_sim_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
