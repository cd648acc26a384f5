// Lane-parallel FIFO, Clock and LRU trace replay for Hopper (sm_90a).
//
// Replaces the reference's XLA steps src/repro/core/engine/simple.py:43
// (`fifo_step`), :70 (`clock_step`) and :113 (`lru_step`), each run as
// jit(lax.scan) vmapped over lanes; the reference has no Pallas kernel for
// these families.  Each entry point computes the function of the port's
// plain step (src/repro_torch/core/engine/simple.py) over a whole trace:
// per-lane logical capacity `cap` (rings padded to the grid's widest), and
// key < 0 as a no-op sentinel.  They read and write the plain version's
// state layout, so a state can pass between kernel and plain version at
// any chunk boundary.
//
// What bounds it on this card: each lane is a chain of T dependent steps.
// The bytes the function must move take a fraction of a millisecond at
// 3.35 TB/s; the time is the latency of the steps' dependent round trips,
// and lanes only run side by side.  The design is cache_sim.cu's:
//
// * One warp a lane, one lane a block, and no block barrier.  Hits
//   commute within a family (FIFO: a hit changes nothing; Clock: it sets
//   a ref bit; LRU: see below), so thread i owns step t0 + i of a window
//   of 32, a __ballot_sync finds the first miss of the window, every hit
//   before it runs at once, one a thread, and the miss then runs on all 32
//   threads redundantly, with the cursors in registers.  No warp
//   collective runs for a round without hits, and none groups keys:
//   LRU's repeated hits to one slot are resolved by atomics (grouping
//   them by __match_any_sync instead was slower on the card: PERF.md
//   section 6).
// * Victim searches by the warp: Clock's hand reads 32 slots a pass,
//   __ballot_sync / __ffs take the first slot that is not occupied and
//   ref'd (at most one lap, after which the hand slot is taken) and the
//   refs the hand passed are cleared in the same pass.  FIFO holds the
//   next 32 slots of its ring in registers, so a miss loads nothing.
// * LRU's victim is the argmin of `last` over the logical slots, the
//   first index on ties, found in amortised O(1) instead of O(cap):
//   - at the launch's start the slots are sorted by (last, index) (a
//     one-warp LSD radix sort, skipped when `last` is already in index
//     order, as in a fresh state), giving the start run S;
//   - every access (hit or miss) appends its slot to a log L; its
//     timestamp is t plus the active steps before it, so a window's hits
//     append in parallel (the last of repeated hits to one slot only,
//     found by an atomicMax on the slot's qpos), and L is sorted by
//     timestamp, all distinct;
//   - qpos[slot] is the position of the slot's one live entry in the
//     buffer that holds S then L; an entry at p is live iff qpos of its
//     slot is p;
//   - the victim is the smaller (last, index) of the first live entries
//     of S and L (found 32 entries a pass): the argmin for any `last` the
//     state carries in, values >= t and ties included;
//   - when L reaches the end of the buffer (2 cap + 64 entries) the live
//     entries of S and then of L are stream-compacted to its front (their
//     order kept, so no sort): cap live entries, so each compaction frees
//     cap + 64 and costs O(cap) -- amortised O(1) a request.
//   `last` and `t` hold exactly the plain version's values after every
//   launch; the buffer and qpos are the launch's own workspace.
// * A tier per lane, chosen on the host by ops.plan_lane from the lane's
//   capacity and K (1 + the largest key of the trace and the ring):
//     0  the whole lane in shared memory (ring, LRU workspace, and the
//        location table loc[0, K) / resident[0, K)): every metadata lane;
//     1  the ring (and LRU's workspace) there, the table in device memory;
//     3  all in device memory (LRU's workspace in `ws_qpos` / `ws_q`).
//   One launch serves a grid of mixed tiers.
// * A lookahead takes the table off the chain: thread i holds the table
//   entry of key t0 + i and has the loads of key t0 + 32 + i in flight;
//   every table write of a miss (the key and the victim) is applied to
//   the entries of both windows that hold the written key.
// * The trace is staged in shared memory through a ring of 16 windows of
//   32 keys, by 4-byte cp.async 14 windows ahead of use.
//
// Cursors are assumed inside their logical rings (pos, hand < cap), and
// LRU's t + T below 2^31, as ops.check_values holds at every launch.
//
// Layout in device memory (row-major, one row per lane): keys (L,pC)
// int32; FIFO resident (L,U) bool, pos (L,); Clock ref (L,pC) bool, hand
// (L,), loc (L,U) int32; LRU last (L,pC) int32, t (L,), loc (L,U) int32;
// cap (L,) int32.

#include <climits>

#include "../../lanes.cuh"

namespace {

// LRU's log buffer holds 2 cap + kLogSlack entries (ops.log_entries).
constexpr int kLogSlack = 64;

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* keys;
  unsigned char* flags;  // FIFO: resident (L,U); Clock: ref (L,pC)
  int* cursor;           // FIFO: pos; Clock: hand; LRU: t
  int* loc;              // Clock, LRU: (L,U)
  int* last;             // LRU: (L,pC)
  const int* cap; const int* tier;
  int* ws_qpos; int* ws_q;  // LRU's tier-3 workspace: (L,pC), (L,ws_stride)
  int pC; long long U; int K; long long ws_stride;
};

struct NoWindowHooks {
  using Entry = int;
  __device__ __forceinline__ void window_start(unsigned) {}
  __device__ __forceinline__ void window_end(unsigned) {}
};

// -- FIFO ----------------------------------------------------------------------

struct Fifo : NoWindowHooks {
  int* keys; unsigned char* res;
  int cap, pos, lane;
  int rb, used;  // keys[(pos0 + lane) % cap] at the last refill; taken since
  __device__ __forceinline__ int load(int k) const { return res[k]; }
  __device__ __forceinline__ bool is_hit(int e) const { return e != 0; }
  __device__ __forceinline__ void refill() {
    rb = keys[(pos + lane) % cap];
    used = 0;
  }
  __device__ __forceinline__ void hits(Look<int>&, bool, unsigned, unsigned) {}
  __device__ __forceinline__ void miss(Look<int>& lk, int f, unsigned) {
    const int key = __shfl_sync(kAll, lk.kc, f);
    const int old = __shfl_sync(kAll, rb, used);
    if (old >= 0) {
      res[old] = 0;
      lk.fix(old, 0);
    }
    res[key] = 1;
    lk.fix(key, 1);
    keys[pos] = key;
    pos = pos + 1 == cap ? 0 : pos + 1;
    // rb's slots stay unwritten until min(32, cap) of them are taken
    if (++used == min(kWarp, cap)) {
      __syncwarp();
      refill();
    }
  }
};

template <int kTier>
__device__ __forceinline__ void fifo_lane(const Args& a, int l, char* smem) {
  constexpr bool kTable = kTier == 0, kRingS = kTier <= 1;
  const int lane = threadIdx.x, cap = a.cap[l], K = a.K;
  int* const g_keys = a.keys + (long long)l * a.pC;
  unsigned char* const g_res = a.flags + (long long)l * a.U;
  int* const ring = reinterpret_cast<int*>(smem);
  int* wcur = ring + kRing * kWarp;
  Fifo p;
  p.keys = place<kRingS>(wcur, g_keys, cap, lane);
  unsigned char* bcur = reinterpret_cast<unsigned char*>(wcur);
  p.res = place<kTable>(bcur, g_res, K, lane);
  __syncwarp();
  p.cap = cap;
  p.pos = a.cursor[l];
  p.lane = lane;
  p.refill();
  const long long n = drive(p, ring, a.trace + l * a.trace_stride, a.T,
                            a.hits ? a.hits + l * a.T : nullptr, lane);
  if (lane == 0) {
    a.cursor[l] = p.pos;
    if (a.counts) a.counts[l] = n;
  }
  __syncwarp();
  write_back<kRingS>(g_keys, p.keys, cap, lane);
  write_back<kTable>(g_res, p.res, K, lane);
}

// -- Clock ---------------------------------------------------------------------

struct Clock : NoWindowHooks {
  int* keys; unsigned char* ref; int* loc;
  int cap, hand, lane;
  __device__ __forceinline__ int load(int k) const { return loc[k]; }
  __device__ __forceinline__ bool is_hit(int e) const { return e >= 0; }
  __device__ __forceinline__ void hits(Look<int>& lk, bool mine, unsigned,
                                       unsigned) {
    if (mine) ref[lk.ec] = 1;  // idempotent: repeated slots may race
  }
  __device__ __forceinline__ void miss(Look<int>& lk, int f, unsigned) {
    const int key = __shfl_sync(kAll, lk.kc, f);
    // the sweep: skip (and clear) occupied ref'd slots, at most one lap
    int vd = cap, victim = kEmpty;
    bool found = false;
    for (int b = 0; b < cap; b += kWarp) {
      const int d = b + lane;
      int s = hand + d;
      if (s >= cap) s -= cap;
      int k = kEmpty, r = 0;
      if (d < cap) { k = keys[s]; r = ref[s]; }
      const unsigned stop = __ballot_sync(kAll, d < cap && !(k >= 0 && r));
      const int lim = stop ? b + __ffs(stop) - 1 : b + kWarp;
      if (d < cap && d < lim) ref[s] = 0;
      if (stop) {
        found = true;
        vd = lim;
        victim = __shfl_sync(kAll, k, __ffs(stop) - 1);
        break;
      }
    }
    __syncwarp();  // the cleared refs
    int ms = found ? hand + vd : hand;  // a fruitless lap takes the hand
    if (ms >= cap) ms -= cap;
    if (!found) victim = keys[ms];
    if (victim >= 0) {
      loc[victim] = kEmpty;
      lk.fix(victim, kEmpty);
    }
    loc[key] = ms;
    lk.fix(key, ms);
    keys[ms] = key;
    ref[ms] = 0;
    hand = ms + 1 == cap ? 0 : ms + 1;
  }
};

template <int kTier>
__device__ __forceinline__ void clock_lane(const Args& a, int l,
                                           char* smem) {
  constexpr bool kTable = kTier == 0, kRingS = kTier <= 1;
  const int lane = threadIdx.x, cap = a.cap[l], K = a.K;
  int* const g_keys = a.keys + (long long)l * a.pC;
  unsigned char* const g_ref = a.flags + (long long)l * a.pC;
  int* const g_loc = a.loc + (long long)l * a.U;
  int* const ring = reinterpret_cast<int*>(smem);
  int* wcur = ring + kRing * kWarp;
  Clock p;
  p.loc = place<kTable>(wcur, g_loc, K, lane);
  p.keys = place<kRingS>(wcur, g_keys, cap, lane);
  unsigned char* bcur = reinterpret_cast<unsigned char*>(wcur);
  p.ref = place<kRingS>(bcur, g_ref, cap, lane);
  __syncwarp();
  p.cap = cap;
  p.hand = a.cursor[l];
  p.lane = lane;
  const long long n = drive(p, ring, a.trace + l * a.trace_stride, a.T,
                            a.hits ? a.hits + l * a.T : nullptr, lane);
  if (lane == 0) {
    a.cursor[l] = p.hand;
    if (a.counts) a.counts[l] = n;
  }
  __syncwarp();
  write_back<kTable>(g_loc, p.loc, K, lane);
  write_back<kRingS>(g_keys, p.keys, cap, lane);
  write_back<kRingS>(g_ref, p.ref, cap, lane);
}

// -- LRU -----------------------------------------------------------------------

struct Lru {
  using Entry = int;
  int* keys; int* last; int* loc;
  int* qpos;  // (cap) position of each slot's live entry in q
  int* q;     // (n) the start run S = [sh, se), then the log L = [lh, le)
  int cap, n, lane;
  int tb;     // timestamp of the window's first active step
  int sh, se, lh, le;

  __device__ __forceinline__ int load(int k) const { return loc[k]; }
  __device__ __forceinline__ bool is_hit(int e) const { return e >= 0; }

  // S: slots [0, cap) sorted by (last, index), stably from index order.
  // `hist` is 256 words of scratch in shared memory.
  __device__ void start(unsigned* hist) {
    int mn = INT_MAX, mx = INT_MIN;
    bool unsorted = false;
    for (int i = lane; i < cap; i += kWarp) {
      const int v = last[i];
      mn = min(mn, v);
      mx = max(mx, v);
      if (i + 1 < cap && v > last[i + 1]) unsorted = true;
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      mn = min(mn, __shfl_xor_sync(kAll, mn, o));
      mx = max(mx, __shfl_xor_sync(kAll, mx, o));
    }
    int* src = q;
    for (int i = lane; i < cap; i += kWarp) src[i] = i;
    __syncwarp();
    if (__any_sync(kAll, unsorted)) {
      // LSD radix sort of the slots by last - mn, 8 bits a pass, stable
      int* dst = qpos;
      const unsigned range = (unsigned)mx - (unsigned)mn;
      const int bits = 32 - __clz((int)range);
      for (int shift = 0; shift < bits; shift += 8) {
        for (int j = lane; j < 256; j += kWarp) hist[j] = 0;
        __syncwarp();
        for (int i = lane; i < cap; i += kWarp)
          atomicAdd(&hist[(((unsigned)last[src[i]] - (unsigned)mn) >> shift)
                          & 255u], 1u);
        __syncwarp();
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[8 * lane + j];
          sum += c[j];
        }
        unsigned inc = sum;
#pragma unroll
        for (int o = 1; o < kWarp; o *= 2) {
          const unsigned v = __shfl_up_sync(kAll, inc, o);
          if (lane >= o) inc += v;
        }
        unsigned run = inc - sum;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          hist[8 * lane + j] = run;
          run += c[j];
        }
        __syncwarp();
        for (int b = 0; b < cap; b += kWarp) {  // a stable scatter
          const int i = b + lane;
          const bool valid = i < cap;
          const int e = valid ? src[i] : 0;
          const int d = valid ? (int)((((unsigned)last[e] - (unsigned)mn)
                                       >> shift) & 255u)
                              : 256 + lane;
          const unsigned m = __match_any_sync(kAll, d);
          const int leader = __ffs(m) - 1;
          unsigned off = 0;
          if (valid && lane == leader) {
            off = hist[d];
            hist[d] = off + __popc(m);
          }
          off = __shfl_sync(kAll, off, leader);
          if (valid) dst[off + __popc(m & lanes_below(lane))] = e;
          __syncwarp();
        }
        int* t = src; src = dst; dst = t;
      }
      if (src != q) {
        for (int i = lane; i < cap; i += kWarp) q[i] = src[i];
        __syncwarp();
      }
    }
    for (int i = lane; i < cap; i += kWarp) qpos[q[i]] = i;
    __syncwarp();
    sh = 0; se = cap; lh = cap; le = cap;
  }

  // Moves the live entries of [h, e) to q[out...], in order.
  __device__ __forceinline__ void compact_run(int h, int e, int& out) {
    for (int b = h; b < e; b += kWarp) {
      const int p = b + lane;
      int s = 0;
      bool live = false;
      if (p < e) {
        s = q[p];
        live = qpos[s] == p;
      }
      const unsigned m = __ballot_sync(kAll, live);
      if (live) {
        const int o = out + __popc(m & lanes_below(lane));
        q[o] = s;
        qpos[s] = o;
      }
      out += __popc(m);
      __syncwarp();
    }
  }

  __device__ __forceinline__ void window_start(unsigned) {
    if (le + kWarp > n) {  // a window appends at most 32 entries
      int out = 0;
      compact_run(sh, se, out);
      const int ns = out;
      compact_run(lh, le, out);
      sh = 0; se = ns; lh = ns; le = out;
      __syncwarp();
    }
  }
  __device__ __forceinline__ void window_end(unsigned active) {
    tb += __popc(active);
  }

  // The hits `hm` (this thread's if `mine`): each sets its slot's age to
  // its timestamp and appends the slot to the log.  Of repeated hits to
  // one slot only the last (the highest lane) does: each claims the slot
  // with a position past every live one (le + lane) by atomicMax on its
  // qpos, and the claim that stands wins.
  __device__ __forceinline__ void hits(Look<int>& lk, bool mine, unsigned hm,
                                       unsigned active) {
    const int s = lk.ec;
    const int ts = tb + __popc(active & lanes_below(lane));
    bool w = mine;
    if (hm & (hm - 1u)) {  // two hits or more
      if (mine) atomicMax(&qpos[s], le + lane);
      __syncwarp();
      w = mine && qpos[s] == le + lane;
    }
    const unsigned W = __ballot_sync(kAll, w);
    __syncwarp();  // every claim read before a winner moves its qpos
    if (w) {
      const int p = le + __popc(W & lanes_below(lane));
      last[s] = ts;
      q[p] = s;
      qpos[s] = p;
    }
    le += __popc(W);
  }

  // The first live entry of [h, e) from h (h advanced to it; e if none),
  // its slot in `slot` (-1 if none).
  __device__ __forceinline__ void front(int& h, int e, int& slot) {
    slot = -1;
    while (h < e) {
      const int p = h + lane;
      int s = 0;
      bool live = false;
      if (p < e) {
        s = q[p];
        live = qpos[s] == p;
      }
      const unsigned m = __ballot_sync(kAll, live);
      if (m) {
        h += __ffs(m) - 1;
        slot = __shfl_sync(kAll, s, __ffs(m) - 1);
        return;
      }
      h += kWarp;
    }
    h = e;
  }

  __device__ __forceinline__ void miss(Look<int>& lk, int f, unsigned active) {
    const int key = __shfl_sync(kAll, lk.kc, f);
    const int ts = tb + __popc(active & lanes_below(f));
    int sv, lv;
    front(sh, se, sv);
    front(lh, le, lv);
    bool take_s;
    if (sv < 0) {
      take_s = false;
    } else if (lv < 0) {
      take_s = true;
    } else {
      const int a = last[sv], b = last[lv];
      take_s = a < b || (a == b && sv < lv);
    }
    const int v = take_s ? sv : lv;
    if (take_s) ++sh; else ++lh;
    const int victim = keys[v];
    if (victim >= 0) {
      loc[victim] = kEmpty;
      lk.fix(victim, kEmpty);
    }
    keys[v] = key;
    last[v] = ts;
    loc[key] = v;
    lk.fix(key, v);
    q[le] = v;
    qpos[v] = le;
    ++le;
  }
};

template <int kTier>
__device__ __forceinline__ void lru_lane(const Args& a, int l, char* smem) {
  constexpr bool kTable = kTier == 0, kRingS = kTier <= 1;
  const int lane = threadIdx.x, cap = a.cap[l], K = a.K;
  const int n = 2 * cap + kLogSlack;
  int* const g_keys = a.keys + (long long)l * a.pC;
  int* const g_last = a.last + (long long)l * a.pC;
  int* const g_loc = a.loc + (long long)l * a.U;
  int* const ring = reinterpret_cast<int*>(smem);
  int* wcur = ring + kRing * kWarp;
  Lru p;
  p.loc = place<kTable>(wcur, g_loc, K, lane);
  p.keys = place<kRingS>(wcur, g_keys, cap, lane);
  p.last = place<kRingS>(wcur, g_last, cap, lane);
  p.qpos = place<kRingS>(wcur, a.ws_qpos + (long long)l * a.pC, cap, lane,
                         false);
  p.q = place<kRingS>(wcur, a.ws_q + (long long)l * a.ws_stride, n, lane,
                      false);
  __syncwarp();
  p.cap = cap;
  p.n = n;
  p.lane = lane;
  p.tb = a.cursor[l];
  // the trace ring is free until the trace is staged: the sort's scratch
  p.start(reinterpret_cast<unsigned*>(ring));
  const long long cnt = drive(p, ring, a.trace + l * a.trace_stride, a.T,
                              a.hits ? a.hits + l * a.T : nullptr, lane);
  if (lane == 0) {
    a.cursor[l] = p.tb;
    if (a.counts) a.counts[l] = cnt;
  }
  __syncwarp();
  write_back<kTable>(g_loc, p.loc, K, lane);
  write_back<kRingS>(g_keys, p.keys, cap, lane);
  write_back<kRingS>(g_last, p.last, cap, lane);
}

__global__ void __launch_bounds__(kWarp) fifo_sim_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int l = blockIdx.x;
  switch (a.tier[l]) {
    case 0: fifo_lane<0>(a, l, smem); break;
    case 1: fifo_lane<1>(a, l, smem); break;
    default: fifo_lane<3>(a, l, smem); break;
  }
}

__global__ void __launch_bounds__(kWarp) clock_sim_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int l = blockIdx.x;
  switch (a.tier[l]) {
    case 0: clock_lane<0>(a, l, smem); break;
    case 1: clock_lane<1>(a, l, smem); break;
    default: clock_lane<3>(a, l, smem); break;
  }
}

__global__ void __launch_bounds__(kWarp) lru_sim_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int l = blockIdx.x;
  switch (a.tier[l]) {
    case 0: lru_lane<0>(a, l, smem); break;
    case 1: lru_lane<1>(a, l, smem); break;
    default: lru_lane<3>(a, l, smem); break;
  }
}

int launch(void (*kernel)(Args), const Args& a, int L, int smem,
           void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<L, kWarp, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes), one a family.  `trace` is (T,)
// shared by the lanes (trace_stride 0) or (L, T) (trace_stride T); exactly
// one of `hits` (L, T) bool and `counts` (L,) int64 is non-null.  `tier`
// (L,) int32 on the card holds each lane's tier (0, 1 or 3,
// ops.plan_lane), `K` the key range and `smem` the shared-memory bytes of
// every block (the largest a lane of the launch needs).  LRU's `ws_qpos`
// (L, pC) and `ws_q` (L, ws_stride) int32 are its workspace in device
// memory, used by tier-3 lanes (null when the launch has none).  Each
// launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = cudaSuccess).
extern "C" int fifo_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys,
    unsigned char* resident, int* pos, const int* cap, const int* tier,
    int L, int pC, long long U, int K, int smem, void* stream) {
  Args a{trace, trace_stride, T, hits, counts, keys, resident, pos,
         nullptr, nullptr, cap, tier, nullptr, nullptr, pC, U, K, 0};
  return launch(fifo_sim_kernel, a, L, smem, stream);
}

extern "C" int clock_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys, unsigned char* ref,
    int* hand, int* loc, const int* cap, const int* tier, int L, int pC,
    long long U, int K, int smem, void* stream) {
  Args a{trace, trace_stride, T, hits, counts, keys, ref, hand, loc,
         nullptr, cap, tier, nullptr, nullptr, pC, U, K, 0};
  return launch(clock_sim_kernel, a, L, smem, stream);
}

extern "C" int lru_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys, int* last, int* t,
    int* loc, const int* cap, const int* tier, int* ws_qpos, int* ws_q,
    int L, int pC, long long U, int K, long long ws_stride, int smem,
    void* stream) {
  Args a{trace, trace_stride, T, hits, counts, keys, nullptr, t, loc, last,
         cap, tier, ws_qpos, ws_q, pC, U, K, ws_stride};
  return launch(lru_sim_kernel, a, L, smem, stream);
}
