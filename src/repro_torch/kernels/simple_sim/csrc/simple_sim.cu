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
// * FIFO: a hit reads `resident`; a miss overwrites the cursor slot.
// * Clock: the reference finds, in closed form, the first slot from the
//   hand that is not occupied-and-ref'd, clears the refs before it, and on
//   a fruitless full lap takes the hand slot with every ref cleared.  Here
//   the hand sweeps, one slot at a time and only on a miss: the same
//   victim and the same refs cleared.  Each skipped slot spends the ref a
//   hit set, so the sweep is amortised O(1) a request.
// * LRU: the victim is the argmin of `last` over the logical slots, the
//   first index on ties (empty slots hold -1 and fill in index order; once
//   the ring is full every `last` is distinct).  A block of kLruThreads
//   threads finds it together on each miss, O(cap / kLruThreads) loads a
//   thread and a block reduction; hits run on one thread and cost the
//   block nothing.
//
// What bounds it: each lane is a chain of T dependent steps, and the time
// is the latency of each step's dependent round trips to memory, not the
// bytes (a fraction of a millisecond); LRU's misses add the argmin's
// O(cap) reads.  This first version keeps the whole state in device memory
// (the tables of a sweep's lanes fit the 50 MB L2), one lane a block,
// FIFO and Clock on one thread; the next trace key is loaded while the
// present step runs.
//
// Cursors are assumed inside their logical rings (pos, hand < cap), as
// every state the port makes or accepts is (ops.check_values holds them
// at every launch).
//
// Layout in device memory (row-major, one row per lane): keys (L,pC)
// int32; FIFO resident (L,U) bool, pos (L,); Clock ref (L,pC) bool, hand
// (L,), loc (L,U) int32; LRU last (L,pC) int32, t (L,), loc (L,U) int32;
// cap (L,) int32.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kEmpty = -1;
constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLruThreads = 1024;

struct Args {
  const int* trace; long long trace_stride, T;
  unsigned char* hits; long long* counts;
  int* keys;
  unsigned char* flags;  // FIFO: resident (L,U); Clock: ref (L,pC)
  int* cursor;           // FIFO: pos; Clock: hand; LRU: t
  int* loc;              // Clock, LRU: (L,U)
  int* last;             // LRU: (L,pC)
  const int* cap;
  int pC; long long U;
};

__device__ __forceinline__ int wrap(int i, int n) { return i + 1 == n ? 0 : i + 1; }

__global__ void __launch_bounds__(1) fifo_sim_kernel(Args a) {
  const int l = blockIdx.x;
  const long long T = a.T;
  const int* __restrict__ tr = a.trace + l * a.trace_stride;
  int* keys = a.keys + (long long)l * a.pC;
  unsigned char* resident = a.flags + l * a.U;
  const int cap = a.cap[l];
  int pos = a.cursor[l];
  unsigned char* hits = a.hits ? a.hits + l * T : nullptr;
  long long n_hits = 0;
  int key = T > 0 ? tr[0] : kEmpty;
  for (long long t = 0; t < T; ++t) {
    const int next = t + 1 < T ? tr[t + 1] : kEmpty;
    bool hit = false;
    if (key >= 0) {
      hit = resident[key] != 0;
      if (!hit) {
        const int old = keys[pos];
        if (old >= 0) resident[old] = 0;
        resident[key] = 1;
        keys[pos] = key;
        pos = wrap(pos, cap);
      }
    }
    if (hits) hits[t] = hit;
    n_hits += hit;
    key = next;
  }
  a.cursor[l] = pos;
  if (a.counts) a.counts[l] = n_hits;
}

__global__ void __launch_bounds__(1) clock_sim_kernel(Args a) {
  const int l = blockIdx.x;
  const long long T = a.T;
  const int* __restrict__ tr = a.trace + l * a.trace_stride;
  int* keys = a.keys + (long long)l * a.pC;
  unsigned char* ref = a.flags + (long long)l * a.pC;
  int* loc = a.loc + l * a.U;
  const int cap = a.cap[l];
  int hand = a.cursor[l];
  unsigned char* hits = a.hits ? a.hits + l * T : nullptr;
  long long n_hits = 0;
  int key = T > 0 ? tr[0] : kEmpty;
  for (long long t = 0; t < T; ++t) {
    const int next = t + 1 < T ? tr[t + 1] : kEmpty;
    bool hit = false;
    if (key >= 0) {
      const int slot = loc[key];
      hit = slot >= 0;
      if (hit) {
        ref[slot] = 1;
      } else {
        // sweep: skip (and clear) occupied ref'd slots, at most one lap
        int ms = hand;
        for (int n = 0; n < cap && keys[ms] >= 0 && ref[ms]; ++n) {
          ref[ms] = 0;
          ms = wrap(ms, cap);
        }
        const int victim = keys[ms];
        if (victim >= 0) loc[victim] = kEmpty;
        loc[key] = ms;
        keys[ms] = key;
        ref[ms] = 0;
        hand = wrap(ms, cap);
      }
    }
    if (hits) hits[t] = hit;
    n_hits += hit;
    key = next;
  }
  a.cursor[l] = hand;
  if (a.counts) a.counts[l] = n_hits;
}

// (value, index) of the smaller `last`, the lower index on ties.
__device__ __forceinline__ void take_min(int& v, int& i, int ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kLruThreads) lru_sim_kernel(Args a) {
  __shared__ int warp_v[kLruThreads / kWarp], warp_i[kLruThreads / kWarp];
  __shared__ int miss_key;   // the key of the miss the block serves, or -1
  __shared__ long long miss_t;
  const int l = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const long long T = a.T;
  const int* __restrict__ tr = a.trace + l * a.trace_stride;
  int* keys = a.keys + (long long)l * a.pC;
  int* last = a.last + (long long)l * a.pC;
  int* loc = a.loc + l * a.U;
  const int cap = a.cap[l];
  unsigned char* hits = a.hits ? a.hits + l * T : nullptr;
  // thread 0's registers: the state's request counter, the hits so far
  int now = a.cursor[l];
  long long n_hits = 0, t = 0;
  while (true) {
    if (tid == 0) {
      // serve hits and padding until the next miss (or the trace's end)
      int key = kEmpty;
      for (; t < T; ++t) {
        key = tr[t];
        if (key < 0) {
          if (hits) hits[t] = 0;
          continue;
        }
        const int slot = loc[key];
        if (slot < 0) break;
        last[slot] = now++;
        if (hits) hits[t] = 1;
        ++n_hits;
      }
      miss_key = t < T ? key : kEmpty;
      miss_t = t;
    }
    __syncthreads();
    const int key = miss_key;
    if (key < 0) break;
    // the victim: argmin of `last` over [0, cap), the first index on ties
    int v = INT_MAX, vi = INT_MAX;
#pragma unroll 4
    for (int i = tid; i < cap; i += kLruThreads) take_min(v, vi, last[i], i);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      take_min(v, vi, __shfl_down_sync(kAll, v, off),
               __shfl_down_sync(kAll, vi, off));
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = vi;
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      vi = warp_i[lane];
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        take_min(v, vi, __shfl_down_sync(kAll, v, off),
                 __shfl_down_sync(kAll, vi, off));
      if (lane == 0) {
        const int s = vi;
        const int victim = keys[s];
        if (victim >= 0) loc[victim] = kEmpty;
        keys[s] = key;
        last[s] = now++;
        loc[key] = s;
        if (hits) hits[miss_t] = 0;
        t = miss_t + 1;
      }
    }
    __syncthreads();  // the miss's writes before the next scan reads them
  }
  if (tid == 0) {
    a.cursor[l] = now;
    if (a.counts) a.counts[l] = n_hits;
  }
}

Args make_args(const int* trace, long long trace_stride, long long T,
               unsigned char* hits, long long* counts, int* keys,
               unsigned char* flags, int* cursor, int* loc, int* last,
               const int* cap, int pC, long long U) {
  return Args{trace, trace_stride, T, hits, counts, keys, flags, cursor,
              loc, last, cap, pC, U};
}

}  // namespace

// Plain C entry points (bound with ctypes), one a family.  `trace` is (T,)
// shared by the lanes (trace_stride 0) or (L, T) (trace_stride T); exactly
// one of `hits` (L, T) bool and `counts` (L,) int64 is non-null.  Each
// launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = cudaSuccess).
extern "C" int fifo_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys,
    unsigned char* resident, int* pos, const int* cap, int L, int pC,
    long long U, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  fifo_sim_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(make_args(
      trace, trace_stride, T, hits, counts, keys, resident, pos, nullptr,
      nullptr, cap, pC, U));
  return (int)cudaGetLastError();
}

extern "C" int clock_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys, unsigned char* ref,
    int* hand, int* loc, const int* cap, int L, int pC, long long U,
    void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  clock_sim_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(make_args(
      trace, trace_stride, T, hits, counts, keys, ref, hand, loc, nullptr,
      cap, pC, U));
  return (int)cudaGetLastError();
}

extern "C" int lru_sim_launch(
    const int* trace, long long trace_stride, long long T,
    unsigned char* hits, long long* counts, int* keys, int* last, int* t,
    int* loc, const int* cap, int L, int pC, long long U, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  lru_sim_kernel<<<L, kLruThreads, 0, (cudaStream_t)stream>>>(make_args(
      trace, trace_stride, T, hits, counts, keys, nullptr, t, loc, last,
      cap, pC, U));
  return (int)cudaGetLastError();
}
