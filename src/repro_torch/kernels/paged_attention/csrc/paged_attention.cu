// Paged-attention decode for Hopper (sm_90a): one query token per
// sequence over a KV pool addressed through block tables.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py:30 (_kernel,
// launched by paged_attention_raw at :85, pallas_call at :113).  Shapes:
// q (B, H, d), any strides with d contiguous; kpool/vpool (N, bs, Hkv, d)
// (the model passes the contiguous per-layer view kpool[l]); block_tables
// (B, nb) int32; lengths (B,) int32 -> out (B, H, d).  Query head h reads
// KV head h / G with G = H / Hkv, as the reference's GQA grouping (q
// reshaped to (Hkv, G, d)) has it.  d is a multiple of 8 up to 128, G at
// most 16; bf16 or fp32 inputs, fp32 statistics.
//
// What bounds it on this card: memory.  The least work is reading each
// sequence's lengths[b] x Hkv x d x 2 (K and V) elements once, at
// 3.35 TB/s; the flops (4 per element and query head of the group, about
// 2 per byte at G = 4) are far below the CUDA cores' ridge, so the design
// is about keeping enough 16-byte loads in flight on every SM.
//
// Design: one launch of 128-thread blocks, one per (split, KV head,
// sequence).  Each sequence's positions are cut into chunks of kChunk = 16
// and its chunks dealt out evenly over n_splits splits (ops.py's planner
// picks n_splits from B and Hkv so that the grid fits on the SMs in one
// wave; the kernel and ops.split_range make the same cut).  Chunks stream
// through rings in shared memory with 16-byte cp.async copies (K and V
// rows of the chunk's positions, each row looked up through the block
// table), so the copies of the next chunks are in flight while one is
// computed.  Positions at or past lengths[b] are never read, which is the
// same function as the reference's -1e30 mask (their weight is exactly 0).
// Every block keeps, per query head of the group, a running max, sum and
// accumulator (an online softmax in the log2 domain), so a K/V row loaded
// once serves the whole group and no score goes to shared memory.  At the
// end the block merges its partial states in shared memory; with one split
// it writes acc / max(l, 1e-30), otherwise it writes its partial (max, sum,
// acc) and the last block of the (sequence, KV head) to arrive (an atomic
// counter, reset by that block) merges the splits in the same launch.
//
// The arithmetic is chosen by the input type (ops.py states the rule):
// * bf16: paged_attention_kernel_mma.  Each warp streams every fourth chunk
//   through its own ring of 3 stages (no block barrier until the end) and
//   computes on the tensor cores: the group's heads are the rows of an
//   m16n8k16 mma.sync (rows past G are zero), S = Q K^T and P V are 16 and
//   up to 32 mma a chunk, with K and V read by ldmatrix.  Q K^T multiplies
//   the bf16 inputs exactly into fp32.  The softmax weights P are fp32,
//   and an mma takes bf16, so P goes in as two bf16 parts, hi = bf16(P)
//   and lo = bf16(P - hi), and P V is two mma into one fp32 accumulator.
//   That carries P to about 2^-17 of itself, as the reference's fp32 P V
//   does to well below the bf16 output's rounding; bf16(P) alone would be
//   off by up to 2^-9, as much as that rounding.  On the CUDA cores, this
//   arithmetic took longer than the loads (per-position 16-lane dot
//   products with 4-shuffle reductions; PERF.md).
// * fp32: paged_attention_kernel, on the CUDA cores, whose fp32 products
//   hold the 2e-5 checks.  A row is held by 16 lanes (a half-warp), 8
//   floats a lane; the 8 half-warps take a chunk's rows in turn (one ring
//   of 4 stages for the block) and q.k reduces over the 16 lanes of a row
//   in 4 shuffles.  With G > 8 the half-warps split into two head groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps, 8 half-warps
constexpr int kChunk = 16;              // positions per ring stage
constexpr int kStages = 4;              // ring depth of the fp32 kernel
constexpr int kVec = 8;                 // fp32 elements of a row per lane
constexpr int kMaxD = 16 * kVec;
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Dimension of element e (< kVec) of lane l's share of an fp32 row: two
// runs of 4, 64 dims apart, so each 16-byte shared-memory load of a
// half-warp is free of bank conflicts.
__device__ __forceinline__ int dim_of(int l, int e) {
  return (e / 4) * 64 + 4 * l + (e % 4);
}

// Lane l's share of row `row` (d floats in shared memory); zeros past d.
__device__ __forceinline__ void load_share(const float* row, int l, int d,
                                           float (&x)[kVec]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int dim = 64 * h + 4 * l;
    const float4 f = dim < d ? *reinterpret_cast<const float4*>(row + dim)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * h] = f.x;
    x[4 * h + 1] = f.y;
    x[4 * h + 2] = f.z;
    x[4 * h + 3] = f.w;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float half_sum(float x) {  // over 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  long long q_b, q_h;            // q strides (batch, head); d is 1
  long long k_n, k_t, k_h;       // kpool strides (slot, offset, head)
  long long v_n, v_t, v_h;       // vpool strides
  long long bt_b;                // block-table row stride
  long long o_b, o_h;            // out strides (batch, head)
  int H, Hkv, d, bs, n_splits;
  float scale_log2;              // log2(e) / sqrt(d)
  float* lse;                    // (B, H) natural-log lse, or null
};

// Chunks [lo, hi) of split s when a sequence's n_chunks chunks are dealt
// out evenly over n_splits splits (ops.split_range is the same cut).
__device__ __forceinline__ void split_chunks(int s, int n_chunks,
                                             int n_splits, int& lo, int& hi) {
  lo = (int)((long long)s * n_chunks / n_splits);
  hi = (int)((long long)(s + 1) * n_chunks / n_splits);
}

// The end of a block: merge its PL partial states (sm_m, sm_l [PL][G] and
// sm_acc [PL][G][d] in shared memory, in the log2 domain) and, with one
// split, write acc / max(l, 1e-30); otherwise write this split's partial,
// and let the last block of the (sequence, KV head) to arrive (an atomic
// counter, which that block resets) merge the splits, with 2 n_splits G
// floats of shared memory past sm_acc.  Where a.lse is set, the block that
// writes a head's output also writes its lse, ln 2 (max + log2 sum).
template <typename T, int PL>
__device__ __forceinline__ void finish(
    const float* sm_m, const float* sm_l, const float* sm_acc, int b, int kh,
    int split, T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, const Args& a, int* is_last) {
  const int G = a.H / a.Hkv, d = a.d, tid = threadIdx.x;
  const int bk = b * a.Hkv + kh;
  const long long row = (long long)bk * a.n_splits + split;
  for (int it = tid; it < G * d; it += kThreads) {
    const int g = it / d, dim = it % d;
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < PL; ++j) M = fmaxf(M, sm_m[j * G + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const float w = exp2f(sm_m[j * G + g] - M);
      num = fmaf(sm_acc[(j * G + g) * d + dim], w, num);
      den = fmaf(sm_l[j * G + g], w, den);
    }
    if (a.n_splits == 1) {
      out[b * a.o_b + (long long)(kh * G + g) * a.o_h + dim] =
          from_f<T>(num / fmaxf(den, 1e-30f));
      if (a.lse != nullptr && dim == 0)
        a.lse[(long long)b * a.H + kh * G + g] =
            (M + log2f(fmaxf(den, 1e-30f))) * kLn2;
    } else {
      part_acc[(row * G + g) * d + dim] = num;
      if (dim == 0) {
        part_m[row * G + g] = M;
        part_l[row * G + g] = den;
      }
    }
  }
  if (a.n_splits == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) *is_last = atomicAdd(&counters[bk], 1) == a.n_splits - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  // every split's max and sum at once into shared memory (after the
  // block's own states), then each split's normalised weight per head,
  // then out = sum over splits of acc x weight, four loads in flight
  const long long row0 = (long long)bk * a.n_splits;
  const int ns = a.n_splits;
  float* wm = const_cast<float*>(sm_acc) + PL * G * d;   // [ns][G]
  float* wl = wm + ns * G;                               // [ns][G]
  for (int i = tid; i < ns * G; i += kThreads) {
    wm[i] = __ldcg(&part_m[row0 * G + i]);
    wl[i] = __ldcg(&part_l[row0 * G + i]);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf, den = 0.f;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, wm[s * G + g]);
    for (int s = 0; s < ns; ++s) {
      wm[s * G + g] = exp2f(wm[s * G + g] - M);
      den = fmaf(wl[s * G + g], wm[s * G + g], den);
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int s = 0; s < ns; ++s) wm[s * G + g] *= inv;
    if (a.lse != nullptr)
      a.lse[(long long)b * a.H + kh * G + g] =
          (M + log2f(fmaxf(den, 1e-30f))) * kLn2;
  }
  __syncthreads();
  for (int it = tid; it < G * d; it += kThreads) {
    const int g = it / d, dim = it % d;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s)
      num = fmaf(__ldcg(&part_acc[((row0 + s) * G + g) * d + dim]),
                 wm[s * G + g], num);
    out[b * a.o_b + (long long)(kh * G + g) * a.o_h + dim] = from_f<T>(num);
  }
  if (tid == 0) counters[bk] = 0;  // ready for the next launch
}

// GH: heads of the group a half-warp serves; PL: half-warps that share a
// head group (kHalves / PL head groups of GH heads cover G).
// Partials: acc (B, Hkv, n_splits, G, d), m and l (B, Hkv, n_splits, G);
// counters (B, Hkv), zero between launches.
template <int GH, int PL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, Args a) {
  constexpr int RPC = kChunk / PL;       // rows of a chunk per half-warp
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  __shared__ int is_last;

  const int G = a.H / a.Hkv, d = a.d;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, l = tid % 16, hw = tid / 16;
  const int hg = hw / PL, pl = hw % PL;
  const int len = lengths[b];
  int c_lo, c_hi;
  split_chunks(split, (len + kChunk - 1) / kChunk, a.n_splits, c_lo, c_hi);
  const int p_lo = c_lo * kChunk, p_hi = min(c_hi * kChunk, len);
  const int nc = c_hi - c_lo;
  const int* bt = block_tables + b * a.bt_b;

  // q of this half-warp's heads, scaled into the log2 domain
  float qv[GH][kVec];
#pragma unroll
  for (int i = 0; i < GH; ++i) {
    const int g = hg * GH + i;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int dim = dim_of(l, e);
      qv[i][e] = g < G && dim < d
                     ? q[b * a.q_b + (long long)(kh * G + g) * a.q_h + dim] *
                           a.scale_log2
                     : 0.f;
    }
  }

  // the ring: stage st holds K rows [kChunk][d], then V rows [kChunk][d].
  // A chunk is 2 kChunk rows of `segs` 16-byte pieces; thread tid copies
  // pieces tid, tid + kThreads, ...  Which row, pool and piece each of its
  // copies is stays fixed from chunk to chunk, so it is worked out once;
  // each copy's page and offset in the page advance by kChunk a chunk.
  constexpr int kElems = 4;                        // floats a copy
  constexpr int kCopies = 2 * kChunk * (kMaxD / kElems) / kThreads;
  const int segs = d / kElems, per = kChunk * segs;
  int cp_row[kCopies], cp_dst[kCopies], cp_page[kCopies], cp_off[kCopies];
  const float* cp_src[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int i = tid + j * kThreads;
    const int kv = i >= per, rem = i - kv * per, r = rem / segs;
    const int sg = rem - r * segs;
    cp_row[j] = i < 2 * per ? r : kChunk;        // kChunk: no copy
    cp_dst[j] = (kv * kChunk + r) * d + sg * kElems;
    cp_src[j] = (kv ? vpool + kh * a.v_h : kpool + kh * a.k_h) + sg * kElems;
    cp_page[j] = (p_lo + r) / a.bs;
    cp_off[j] = (p_lo + r) % a.bs;
  }
  auto issue = [&](int c) {  // chunk c (issued in order) into its stage
    float* dst = ring + (c % kStages) * 2 * kChunk * d;
    const int p0 = p_lo + c * kChunk;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      if (cp_row[j] < kChunk && p0 + cp_row[j] < p_hi) {
        const long long slot = bt[cp_page[j]];
        // the pools share one shape and are contiguous: K's strides are V's
        cp_async16(dst + cp_dst[j],
                   cp_src[j] + slot * a.k_n + cp_off[j] * a.k_t);
      }
      cp_off[j] += kChunk;
      while (cp_off[j] >= a.bs) {
        cp_off[j] -= a.bs;
        ++cp_page[j];
      }
    }
  };

  float m[GH], lsum[GH], acc[GH][kVec];
#pragma unroll
  for (int i = 0; i < GH; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nc) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();               // ... every thread's; chunk c - 1 is done
    if (c + kStages - 1 < nc) issue(c + kStages - 1);
    cp_async_commit();

    const float* Ks = ring + (c % kStages) * 2 * kChunk * d;
    const float* Vs = Ks + kChunk * d;
    const int p0 = p_lo + c * kChunk;
    float s[RPC][GH];
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) {
      const int r = pl + rr * PL;
      float kx[kVec];
      load_share(Ks + r * d, l, d, kx);
#pragma unroll
      for (int i = 0; i < GH; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qv[i][e], kx[e], dot);
        dot = half_sum(dot);
        s[rr][i] = p0 + r < p_hi ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < GH; ++i) {
      float mx = s[0][i];
#pragma unroll
      for (int rr = 1; rr < RPC; ++rr) mx = fmaxf(mx, s[rr][i]);
      const float mn = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - mn);
      m[i] = mn;
      lsum[i] *= corr;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int rr = 0; rr < RPC; ++rr) {
      const int r = pl + rr * PL;
      if (p0 + r >= p_hi) continue;  // a row past the split: never loaded
      float vx[kVec];
      load_share(Vs + r * d, l, d, vx);
#pragma unroll
      for (int i = 0; i < GH; ++i) {
        const float p = exp2f(s[rr][i] - m[i]);
        lsum[i] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(p, vx[e], acc[i][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the block's merge

  // the half-warps' states: sm_m, sm_l [PL][G], sm_acc [PL][G][d]
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + PL * G;
  float* sm_acc = sm_l + PL * G;
#pragma unroll
  for (int i = 0; i < GH; ++i) {
    const int g = hg * GH + i;
    if (g >= G) break;
    if (l == 0) {
      sm_m[pl * G + g] = m[i];
      sm_l[pl * G + g] = lsum[i];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int dim = dim_of(l, e);
      if (dim < d) sm_acc[(pl * G + g) * d + dim] = acc[i][e];
    }
  }
  __syncthreads();
  finish<float, PL>(sm_m, sm_l, sm_acc, b, kh, split, out, part_acc, part_m,
                part_l, counters, a, &is_last);
}

// -- bf16: q.k and p.v on the tensor cores (mma.sync m16n8k16) -----------

constexpr int kWarps = kThreads / 32;
constexpr int kMmaStages = 3;          // chunks a warp has in its ring
constexpr int kPad = 8;                // bf16 padding a shared row
constexpr int kMaxKs = kMaxD / 16;     // k-steps of q.k
constexpr int kMaxNt = kMaxD / 8;      // n-tiles of p.v

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
      : "memory");
}
// d (16x8 fp32) += a (16x16 bf16, row-major fragment) b (16x8 bf16, "col")
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// fp32 pair (x, y) as two bf16 pairs whose sum is (x, y) to about 2^-17
// of each: hi = bf16(x, y), lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// One block per (split, KV head, sequence), four warps.  The split's
// chunks are dealt to the warps in turn (warp w takes chunks w, w + 4,
// ...), and each warp streams its own chunks through its own ring of
// kMmaStages in shared memory with 16-byte cp.async copies, so warps never
// wait for each other until the end.  The group's G <= 16 query heads are
// the 16 rows of an m16n8k16 A operand (rows past G are zero); a chunk's
// scores S (heads x 16 positions) are 2 x 8 products over head_dim, taken
// from shared memory by ldmatrix, the online softmax runs on S's fragment
// registers (a head's 16 scores sit in one quad of lanes), P's two bf16
// parts go from those registers straight into the A operands of P V, and V
// comes through ldmatrix.trans.  Shared rows are padded by 16 bytes, so every ldmatrix
// is free of bank conflicts, and the padding is zeroed once, so the
// k-step or n-tile that reaches past an odd head_dim / 8 multiplies zeros.
__global__ void __launch_bounds__(kThreads) paged_attention_kernel_mma(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  const int G = a.H / a.Hkv, d = a.d, ds = d + kPad;  // shared row stride
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int len = lengths[b];
  int c_lo, c_hi;
  split_chunks(split, (len + kChunk - 1) / kChunk, a.n_splits, c_lo, c_hi);
  const int p_lo = c_lo * kChunk, p_hi = min(c_hi * kChunk, len);
  const int nk = (c_hi - c_lo - warp + kWarps - 1) / kWarps;  // my chunks
  const int* bt = block_tables + b * a.bt_b;
  const int n_ks = (d + 15) / 16, n_nt = d / 8;

  // this warp's ring: stage st holds K rows [kChunk][ds], V rows [kChunk][ds]
  const int stage = 2 * kChunk * ds;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                        warp * kMmaStages * stage;
  for (int r = lane; r < kMmaStages * 2 * kChunk; r += 32)
    *reinterpret_cast<uint4*>(ring + r * ds + d) = make_uint4(0, 0, 0, 0);

  // copies: lane copies 16-byte piece lane % 16 of rows lane / 16 + 2 i
  const int piece = lane % 16, r0 = lane / 16;
  auto issue = [&](int k) {  // this warp's k-th chunk into stage k % ring
    __nv_bfloat16* dst = ring + (k % kMmaStages) * stage;
    const int p0 = p_lo + (warp + k * kWarps) * kChunk;
    if (piece * 8 >= d) return;
    long long slot = 0;
    int off0 = 0;
    const bool one_page = a.bs % kChunk == 0;   // the chunk lies in a page
    if (one_page) {
      slot = bt[p0 / a.bs];
      off0 = p0 % a.bs;
    }
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int r = r0 + 2 * i, pos = p0 + r;
      if (pos >= p_hi) {  // past the split: zeros, which P (0 there) may meet
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dst + r * ds + piece * 8) = z;
        *reinterpret_cast<uint4*>(dst + (kChunk + r) * ds + piece * 8) = z;
        continue;
      }
      long long sl = slot;
      int off = off0 + r;
      if (!one_page) {
        sl = bt[pos / a.bs];
        off = pos % a.bs;
      }
      // the pools share one shape and are contiguous: K's strides are V's
      const long long src = sl * a.k_n + off * a.k_t + kh * a.k_h + piece * 8;
      cp_async16(dst + r * ds + piece * 8, kpool + src);
      cp_async16(dst + (kChunk + r) * ds + piece * 8, vpool + src);
    }
  };

  float o[kMaxNt][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads g, g + 8

#pragma unroll
  for (int k = 0; k < kMmaStages - 1; ++k) {
    if (k < nk) issue(k);
    cp_async_commit();
  }
  // q of heads g and g + 8 as A fragments, one per k-step (loaded while
  // the first chunks are in flight)
  uint32_t qa[kMaxKs][4];
  const __nv_bfloat16* qb = q + b * a.q_b + (long long)kh * G * a.q_h;
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int head = g + 8 * (i % 2), dim = 16 * ks + 2 * t + 8 * (i / 2);
      const __nv_bfloat16* x = qb + head * a.q_h + dim;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (head < G && dim < d) v = __halves2bfloat162(x[0], x[1]);
      qa[ks][i] = *reinterpret_cast<uint32_t*>(&v);
    }

  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kMmaStages - 2>();  // chunk k has landed (my copies)
    __syncwarp();                     // ... the warp's; chunk k - 1 is read
    if (k + kMmaStages - 1 < nk) issue(k + kMmaStages - 1);
    cp_async_commit();

    const __nv_bfloat16* Ks = ring + (k % kMmaStages) * stage;
    const __nv_bfloat16* Vs = Ks + kChunk * ds;
    const int p0 = p_lo + (warp + k * kWarps) * kChunk;

    // S = Q K^T: two n-tiles of 8 positions
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks >= n_ks) break;
      uint32_t kb[4];
      ldsm_x4(Ks + ((mi / 2) * 8 + mr) * ds + 16 * ks + (mi % 2) * 8, kb);
      mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
      mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
    }

    // online softmax (log2 domain) on the fragments: sc[n][e] is head
    // g + 8 (e / 2), position p0 + 8 n + 2 t + e % 2
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p0 + 8 * n + 2 * t + (e & 1) < p_hi;
        sc[n][e] = ok ? sc[n][e] * a.scale_log2 : kNegInf;
        if (e < 2)
          mx0 = fmaxf(mx0, sc[n][e]);
        else
          mx1 = fmaxf(mx1, sc[n][e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pr[n][e] = exp2f(sc[n][e] - (e < 2 ? mn0 : mn1));
    l0 = l0 * c0 + (pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]);
    l1 = l1 * c1 + (pr[0][2] + pr[0][3]) + (pr[1][2] + pr[1][3]);
    uint32_t pa[4], pb[4];  // A fragments of P's hi and lo parts
    split_bf16(pr[0][0], pr[0][1], pa[0], pb[0]);
    split_bf16(pr[0][2], pr[0][3], pa[1], pb[1]);
    split_bf16(pr[1][0], pr[1][1], pa[2], pb[2]);
    split_bf16(pr[1][2], pr[1][3], pa[3], pb[3]);

    // O = O * c + P V (hi, then lo): n-tiles of 8 dims, two per
    // ldmatrix.trans
#pragma unroll
    for (int np = 0; np < kMaxNt / 2; ++np) {
      if (2 * np >= n_nt) break;
      uint32_t vb[4];
      ldsm_x4_trans(Vs + ((mi % 2) * 8 + mr) * ds + 8 * (2 * np + mi / 2),
                    vb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&acc)[4] = o[2 * np + h];
        acc[0] *= c0;
        acc[1] *= c0;
        acc[2] *= c1;
        acc[3] *= c1;
        mma_bf16(acc, pa, vb[2 * h], vb[2 * h + 1]);
        mma_bf16(acc, pb, vb[2 * h], vb[2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is free: reuse them for the block's merge

  // the warps' states: sm_m, sm_l [kWarps][G], sm_acc [kWarps][G][d]
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int head = g + 8 * hh;
    if (head >= G) break;
    if (t == 0) {
      sm_m[warp * G + head] = hh ? m1 : m0;
      sm_l[warp * G + head] = hh ? l1 : l0;
    }
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) {
      const int dim = 8 * nt + 2 * t;
      if (dim >= d) break;
      sm_acc[(warp * G + head) * d + dim] = o[nt][2 * hh];
      sm_acc[(warp * G + head) * d + dim + 1] = o[nt][2 * hh + 1];
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, kWarps>(sm_m, sm_l, sm_acc, b, kh, split, out,
                                part_acc, part_m, part_l, counters, a,
                                &is_last);
}

// Splits the partials' scratch `part` (B * H * n_splits * (d + 2) floats)
// into acc, m and l.
struct Parts {
  float *acc, *m, *l;
};
Parts parts(float* part, const Args& a, int B) {
  const long long n = (long long)B * a.H * a.n_splits;
  return Parts{part, part + n * a.d, part + n * (a.d + 1)};
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int GH, int PL>
int launch_fp32(const float* q, const float* kpool, const float* vpool,
                const int* block_tables, const int* lengths, float* out,
                float* part, int* counters, const Args& a, int B,
                cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t ring = (size_t)kStages * 2 * kChunk * a.d * sizeof(float);
  const size_t merge = sizeof(float) * ((size_t)PL * G * (a.d + 2) +
                                        2 * (size_t)a.n_splits * G);
  const size_t smem = ring > merge ? ring : merge;
  const auto kernel = paged_attention_kernel<GH, PL>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Parts p = parts(part, a, B);
  kernel<<<dim3(a.n_splits, a.Hkv, B), kThreads, smem, stream>>>(
      q, kpool, vpool, block_tables, lengths, out, p.acc, p.m, p.l, counters,
      a);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kpool,
                const __nv_bfloat16* vpool, const int* block_tables,
                const int* lengths, __nv_bfloat16* out, float* part,
                int* counters, const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t ring = (size_t)kWarps * kMmaStages * 2 * kChunk *
                      (a.d + kPad) * sizeof(__nv_bfloat16);
  const size_t merge = sizeof(float) * ((size_t)kWarps * G * (a.d + 2) +
                                        2 * (size_t)a.n_splits * G);
  const size_t smem = ring > merge ? ring : merge;
  cudaError_t err = set_smem(paged_attention_kernel_mma, smem);
  if (err != cudaSuccess) return (int)err;
  const Parts p = parts(part, a, B);
  const dim3 grid(a.n_splits, a.Hkv, B);
  paged_attention_kernel_mma<<<grid, kThreads, smem, stream>>>(
      q, kpool, vpool, block_tables, lengths, out, p.acc, p.m, p.l, counters,
      a);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* kpool, const void* vpool,
           const int* block_tables, const int* lengths, void* out,
           float* part, int* counters, const Args& a, int B, int dtype,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(kpool),
                       static_cast<const __nv_bfloat16*>(vpool), block_tables,
                       lengths, static_cast<__nv_bfloat16*>(out), part,
                       counters, a, B, stream);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(kpool),
              *vf = static_cast<const float*>(vpool);
  float* of = static_cast<float*>(out);
  const int G = a.H / a.Hkv;
  if (G <= 4)
    return launch_fp32<4, 8>(qf, kf, vf, block_tables, lengths, of, part,
                             counters, a, B, stream);
  if (G <= 8)
    return launch_fp32<8, 8>(qf, kf, vf, block_tables, lengths, of, part,
                             counters, a, B, stream);
  return launch_fp32<8, 4>(qf, kf, vf, block_tables, lengths, of, part,
                           counters, a, B, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 11 element
// strides: q (batch, head), kpool (slot, offset, head), vpool (slot,
// offset, head), block_tables (row), out (batch, head).  `lse`, where not
// null, is a contiguous (B, H) fp32 output: each head's natural-log
// log-sum-exp of its scaled scores.  With n_splits >
// 1, `part` is fp32 scratch of B * H * n_splits * (d + 2) elements and
// `counters` B * Hkv int32 zeros (left zero by the launch); both are unused
// with one split.  The pools' rows must start on 16-byte boundaries.
// dtype is 0 for float32 and 1 for bfloat16.  Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int paged_attention_launch(
    const void* q, const void* kpool, const void* vpool,
    const int* block_tables, const int* lengths, void* out, float* lse,
    float* part, int* counters, const long long* strides, int B, int H,
    int Hkv, int d, int bs, int n_splits, int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || d <= 0 ||
      d > kMaxD || d % 8 != 0 || bs <= 0 || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
               s[10], H, Hkv, d, bs, n_splits,
               1.4426950408889634f / sqrtf((float)d), lse};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return launch(q, kpool, vpool, block_tables, lengths, out, part, counters,
                a, B, dtype, static_cast<cudaStream_t>(stream));
}
