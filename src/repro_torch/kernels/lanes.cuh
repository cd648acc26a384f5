// What the lane-replay kernels (cache_sim.cu, s3fifo_sim.cu,
// simple_sim.cu) share on the card: a lane is one warp of one block, its
// trace row staged through a ring of kRing windows of kWarp keys at the
// start of the block's shared memory (lanes.TRACE_BYTES), and each array
// of the lane kept in shared memory or in device memory as its tier says
// (lanes.plan_tiers chooses on the host).  drive() is the window loop of
// all three.  Each kernel source includes this header once;
// kernels/build.py hashes it into the library's name.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kEmpty = -1;
// Windows of the trace staged in shared memory: kRing * kWarp * 4 bytes at
// the start of every block's shared memory (lanes.TRACE_BYTES).
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

template <typename E>
__device__ __forceinline__ void copy_row(E* dst, const E* src, int n,
                                         int lane) {
#pragma unroll 4
  for (int i = lane; i < n; i += kWarp) dst[i] = src[i];
}

// The working copy of one array of n elements: in shared memory at
// `cursor` (advanced past it, the array copied in when `load`) where
// kShared, else the array in device memory itself.
template <bool kShared, typename E>
__device__ __forceinline__ E* place(E*& cursor, E* g, int n, int lane,
                                    bool load = true) {
  if constexpr (kShared) {
    E* p = cursor;
    cursor += n;
    if (load) copy_row(p, g, n, lane);
    return p;
  } else {
    return g;
  }
}

// Copies a working copy in shared memory back to its array in device
// memory (nothing where the array is its own working copy).
template <bool kShared, typename E>
__device__ __forceinline__ void write_back(E* g, const E* p, int n,
                                           int lane) {
  if constexpr (kShared) copy_row(g, p, n, lane);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The table entries of the two windows in flight: thread i's key of the
// current window (kc) and of the next (kn), the entry of kc (ec), the
// loaded entry of kn (en) and a write to kn's key made since that load
// (on, where ovn).  E is a family's table entry.
template <typename E>
struct Look {
  int kc, kn;
  E ec, en, on;
  bool ovn;
  // A write of the table, entry e of key k, applied to both windows.
  __device__ __forceinline__ void fix(int k, E e) {
    if (kc == k) ec = e;
    if (kn == k) { on = e; ovn = true; }
  }
};

// Replays the trace row `tr` through the family policy `P` and returns the
// lane's hit count; `hrow`, when non-null, gets the hits.  P names its
// table entry (Entry, value-initialised for padding keys) and provides
// load(key) -> Entry, is_hit(Entry), hits(look, mine, hit mask, active
// mask) for the hits of a round (not called where the mask is empty),
// miss(look, f, active) for the step at lane f that is neither a hit nor
// padding, and window_start / window_end(active).  The trace goes through
// a ring of kRing windows in shared memory, each staged kRing - 2 windows
// before its first use.  In every window the runs of easy steps (hits
// and padding) run at once, a step a thread; each other step runs on the
// whole warp, and its table writes reach the later entries (Look::fix).
template <class P>
__device__ __forceinline__ long long drive(P& pol, int* ring, const int* tr,
                                           long long T,
                                           unsigned char* hrow, int lane) {
  for (int w = 0; w + 1 < kRing; ++w) {
    stage_key(ring + w * kWarp + lane, tr, (long long)w * kWarp + lane, T);
    commit_group();
  }
  wait_group<kRing - 3>();  // windows 0 and 1
  using E = typename P::Entry;
  Look<E> lk;
  lk.kc = ring[lane];
  lk.kn = ring[kWarp + lane];
  lk.ec = lk.kc >= 0 ? pol.load(lk.kc) : E{};
  lk.en = lk.kn >= 0 ? pol.load(lk.kn) : E{};
  lk.on = E{};
  lk.ovn = false;
  long long count = 0;
  for (long long t0 = 0; t0 < T; t0 += kWarp) {
    if (t0 > 0) {  // advance the windows
      const long long w = t0 / kWarp;
      stage_key(ring + ((w + kRing - 2) & (kRing - 1)) * kWarp + lane, tr,
                t0 + (long long)(kRing - 2) * kWarp + lane, T);
      commit_group();
      wait_group<kRing - 3>();  // window w + 1
      lk.kc = lk.kn;
      lk.ec = lk.ovn ? lk.on : lk.en;
      lk.ovn = false;
      lk.kn = ring[((w + 1) & (kRing - 1)) * kWarp + lane];
      lk.en = lk.kn >= 0 ? pol.load(lk.kn) : E{};
    }
    const unsigned active = __ballot_sync(kAll, lk.kc >= 0);
    pol.window_start(active);
    int hbit = 0;
    for (int pos = 0;;) {
      const bool easy = lk.kc < 0 || pol.is_hit(lk.ec);
      const unsigned stop = __ballot_sync(kAll, !easy) & (kAll << pos);
      const int f = stop ? __ffs(stop) - 1 : kWarp;
      // the hits before f, each on its thread
      const unsigned hm = active & (kAll << pos)
                          & (f == kWarp ? kAll : (1u << f) - 1u);
      const bool mine = (hm >> lane) & 1u;
      hbit |= mine;
      if (hm) pol.hits(lk, mine, hm, active);
      if (f == kWarp) break;
      __syncwarp();  // the hits' writes, before any thread reads them
      pol.miss(lk, f, active);
      __syncwarp();  // the miss's writes, before the later hits read them
      pos = f + 1;
      if (pos == kWarp) break;
    }
    pol.window_end(active);
    count += __popc(__ballot_sync(kAll, hbit));
    if (hrow && t0 + lane < T) hrow[t0 + lane] = (unsigned char)hbit;
  }
  return count;
}

}  // namespace
