// Paged-attention decode for Hopper (sm_90a): one query token per
// sequence over a KV pool addressed through block tables.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py:30 (_kernel,
// launched by paged_attention_raw at :85, pallas_call at :113).  Shapes:
// q (B, H, d); kpool/vpool (N, bs, Hkv, d), any strides with d
// contiguous (the model passes the per-layer view kpool[l]);
// block_tables (B, nb) int32; lengths (B,) int32 -> out (B, H, d).  Query
// head h reads KV head h / G with G = H / Hkv, as the reference's GQA
// grouping (q reshaped to (Hkv, G, d)) has it.  d <= 128, G <= 16.
//
// What bounds it on this card: memory.  The least work is reading each
// sequence's lengths[b] x Hkv x d x 2 (K and V) elements once, at
// 3.35 TB/s; the flops (4 per element and query head of the group) are
// far below the ridge.  A decode batch has few sequences, so one block
// per (sequence, KV head) would leave most of the 132 SMs idle and keep
// too few loads in flight.
//
// Design (split-KV, two launches):
//   1. paged_attention_split: one block of 128 threads per (KV head,
//      sequence, split of kSplit = 128 positions).  The TPU kernel walked
//      the blocks of a sequence as a sequential grid axis with the table
//      in scalar prefetch; here each block reads its own table entries
//      and covers only positions < lengths[b] (the zero padding of a
//      block table is never read), and blocks whose split lies past the
//      sequence exit at once.  The G query heads of the group share every
//      K/V row the block loads.  Scores: each warp takes a position,
//      its lanes split d, a shuffle reduction per head; K is read once.
//      Softmax statistics per head (max, exp, sum) in shared memory.
//      P.V: thread d accumulates the G heads' outputs at dim d in
//      registers while the block walks the split's V rows, read once
//      and coalesced.  Everything is fp32.  With one split the block
//      writes acc / max(l, 1e-30) in the input type; otherwise it writes
//      its unnormalised partial (acc, max, sum).  The pool slot of each
//      position is looked up once, into shared memory.
//   2. paged_attention_merge: one block per (head, sequence) rescales the
//      partials of the splits the sequence covers by exp(m_s - M) and
//      writes sum(acc_s w_s) / max(sum(l_s w_s), 1e-30).
// Positions at or past lengths[b] are never computed, which is the same
// function as the reference's -1e30 mask (their weight is exactly 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 128;   // positions per split
constexpr int kMaxD = 128;
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Args {
  long long q_b, q_h;            // q strides (batch, head); d is 1
  long long k_n, k_t, k_h;       // kpool strides (slot, offset, head)
  long long v_n, v_t, v_h;       // vpool strides
  long long bt_b;                // block-table row stride
  long long o_b, o_h;            // out strides (batch, head)
  int H, Hkv, d, bs, nb, n_splits;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Partials: acc (B, Hkv, n_splits, G, d), m and l (B, Hkv, n_splits, G).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_split(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, Args a) {
  __shared__ float qs[kMaxG * kMaxD];   // [G][d], scaled
  __shared__ float ps[kMaxG * kSplit];  // [G][kSplit]: scores, then p
  __shared__ float ms[kMaxG], ls[kMaxG];
  __shared__ long long slots[kSplit];   // pool slot of each position

  const int G = a.H / a.Hkv, d = a.d;
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int len = lengths[b];
  const int t0 = split * kSplit;
  if (t0 >= len) return;  // past this sequence: the merge skips it
  const int n = min(kSplit, len - t0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* bt = block_tables + b * a.bt_b;

  for (int e = tid; e < G * d; e += kThreads) {
    const int g = e / d, dd = e % d;
    qs[e] = to_f(q[b * a.q_b + (long long)(kh * G + g) * a.q_h + dd]) * a.scale;
  }
  for (int t = tid; t < n; t += kThreads) slots[t] = bt[(t0 + t) / a.bs];
  __syncthreads();

  // scores: one position per warp at a time, lanes over d
  for (int t = warp; t < n; t += kWarps) {
    const T* krow =
        kpool + slots[t] * a.k_n + ((t0 + t) % a.bs) * a.k_t + kh * a.k_h;
    float kv[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int dd = lane + 32 * i;
      kv[i] = dd < d ? to_f(krow[dd]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int dd = lane + 32 * i;
        if (dd < d) s = fmaf(qs[g * d + dd], kv[i], s);
      }
      s = warp_sum(s);
      if (lane == 0) ps[g * kSplit + t] = s;
    }
  }
  __syncthreads();

  // softmax statistics of this split, one warp per head
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, ps[g * kSplit + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(ps[g * kSplit + t] - mx);
      ps[g * kSplit + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = sum;
    }
  }
  __syncthreads();

  // P.V: thread dd owns dim dd of every head of the group
  const int dd = tid;
  if (dd >= d) return;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float v = to_f(vpool[slots[t] * a.v_n + ((t0 + t) % a.bs) * a.v_t +
                               kh * a.v_h + dd]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = fmaf(ps[g * kSplit + t], v, acc[g]);
  }
  if (a.n_splits == 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        out[b * a.o_b + (long long)(kh * G + g) * a.o_h + dd] =
            from_f<T>(acc[g] / fmaxf(ls[g], 1e-30f));
    return;
  }
  const long long base = ((long long)(b * a.Hkv + kh) * a.n_splits + split) * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    part_acc[(base + g) * d + dd] = acc[g];
    if (dd == 0) {
      part_m[base + g] = ms[g];
      part_l[base + g] = ls[g];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_merge(
    const int* __restrict__ lengths, const float* __restrict__ part_acc,
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    T* __restrict__ out, Args a) {
  const int G = a.H / a.Hkv, h = blockIdx.x, b = blockIdx.y, dd = threadIdx.x;
  if (dd >= a.d) return;
  const int kh = h / G, g = h % G;
  const int used = (lengths[b] + kSplit - 1) / kSplit;
  const long long row = (long long)(b * a.Hkv + kh) * a.n_splits;
  float M = kNegInf;
  for (int s = 0; s < used; ++s) M = fmaxf(M, part_m[(row + s) * G + g]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < used; ++s) {
    const long long i = (row + s) * G + g;
    const float w = expf(part_m[i] - M);
    num = fmaf(part_acc[i * a.d + dd], w, num);
    den = fmaf(part_l[i], w, den);
  }
  out[b * a.o_b + (long long)h * a.o_h + dd] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const int* block_tables, const int* lengths, void* out,
           float* part_acc, float* part_m, float* part_l, const Args& a,
           int B, cudaStream_t stream) {
  paged_attention_split<T><<<dim3(a.Hkv, B, a.n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), block_tables, lengths,
      static_cast<T*>(out), part_acc, part_m, part_l, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return (int)err;
  paged_attention_merge<T><<<dim3(a.H, B), kThreads, 0, stream>>>(
      lengths, part_acc, part_m, part_l, static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits the grid uses for block tables of nb blocks of bs positions
// (the wrapper sizes the partial buffers with it).
extern "C" int paged_attention_splits(int nb, int bs) {
  return (int)(((long long)nb * bs + kSplit - 1) / kSplit);
}

// Plain C entry point (bound with ctypes).  `strides` holds 11 element
// strides: q (batch, head), kpool (slot, offset, head), vpool (slot,
// offset, head), block_tables (row), out (batch, head).  part_acc,
// part_m and part_l are fp32 scratch of B * Hkv * splits * G * d and
// B * Hkv * splits * G elements (unused with one split).  dtype is 0 for
// float32 and 1 for bfloat16.  Launches on `stream`, does not
// synchronise, and returns the first launch error (0 = cudaSuccess).
extern "C" int paged_attention_launch(
    const void* q, const void* kpool, const void* vpool,
    const int* block_tables, const int* lengths, void* out, float* part_acc,
    float* part_m, float* part_l, const long long* strides, int B, int H,
    int Hkv, int d, int bs, int nb, int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || d <= 0 ||
      d > kMaxD || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
               s[10], H, Hkv, d, bs, nb, paged_attention_splits(nb, bs),
               1.0f / sqrtf((float)d)};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kpool, vpool, block_tables, lengths, out,
                         part_acc, part_m, part_l, a, B, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kpool, vpool, block_tables, lengths, out,
                                 part_acc, part_m, part_l, a, B, st);
  return (int)cudaErrorInvalidValue;
}
