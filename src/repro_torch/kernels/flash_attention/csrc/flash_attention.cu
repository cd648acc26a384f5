// Causal / full attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:25 (_kernel,
// launched by flash_attention_bh at :77, pallas_call at :90).  It takes
// the public layout of that kernel's wrapper (ops.py): q (B, Sq, H, hd),
// k/v (B, Skv, Hkv, hd), any strides with the last dimension contiguous,
// and does grouped-query attention by head index (query head h reads KV
// head h / (H / Hkv)); the K/V heads are never repeated in memory, and
// head_dim is any multiple of 8 up to 128.  Causal masking is top-left
// aligned (kpos <= qpos) with masked scores at -1e30, as the reference has
// it; the softmax is fp32 and the output acc / max(l, 1e-30) in the input
// type.
//
// What bounds it on this card: operations.  Prefill at S = 2048 does
// 4 * H * hd * S^2 / 2 flops per sequence and layer on 2 * S * (H + 2 Hkv)
// * hd inputs, far above the 295 flop/byte ridge of the bf16 tensor cores.
//
// Two kernels, chosen by the input type (ops.py states the rule):
//
// * bf16: flash_attention_kernel_sm90, on the tensor cores.  One block of
//   three warpgroups per (128 query rows, head, batch): two consumer
//   warpgroups of 64 rows each and one producer warpgroup, of which one
//   thread issues TMA copies (cp.async.bulk.tensor) and the rest only give
//   their registers to the consumers (setmaxnreg 24 / 240; ptxas fits the
//   consumer path in the 168 registers a thread has at launch, so this is
//   headroom).  The producer loads the Q tile once and streams K and V
//   tiles of 128 rows through a ring of two stages in shared memory, each
//   signalled by an mbarrier with the transaction's bytes; the consumers
//   release a stage through a second mbarrier.  Every tile is a box of 64 columns (128 bytes, the span of the
//   128-byte swizzle) by 128 rows; head_dim is covered by one or two boxes,
//   and the columns past head_dim (hd 80: 80..127; hd 32: 32..63) are filled
//   with zeros by TMA, as are rows past Sq or Skv.  S = Q K^T is
//   wgmma.mma_async m64n128k16 with both operands in shared memory (K is
//   K-major as stored), bf16 in and fp32 accumulate, one k-step per 16
//   columns of head_dim actually present; the online softmax runs on the
//   accumulator registers (a row's 128 scores are spread over the 4 lanes
//   of a quad, so a row reduction is two shuffles); P, rounded to bf16,
//   goes straight from those registers into the A operand of P V (the
//   accumulator and A-fragment layouts coincide), and V is read from shared
//   memory as an MN-major operand through the descriptor's transpose bit,
//   as wide as head_dim needs (m64n64k16, m64n80k16 at hd 80, m64n128k16).
//   Under the causal mask a block stops at the tile holding its last row's
//   diagonal and masks only the tiles that cross the diagonal or the end of
//   K/V.  Blocks of the heaviest query tiles are scheduled first.  Shared
//   memory: Q 32 KB + 2 x (K + V) 64 KB at head_dim 128 (half at <= 64).
// * fp32: flash_attention_kernel, on the fp32 CUDA cores (67 TFLOP/s
//   peak): one block of 256 threads per (64 query rows, head, batch), Q
//   (pre-scaled) and each K/V tile of 64 rows staged in shared memory, 4
//   rows x 4 score columns and 4 rows x up to 8 output columns a thread in
//   registers.  It is what the fp32 checks (2e-5) hold the model to; TF32
//   tensor cores would not meet them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// mbarriers, TMA loads, wgmma products and tensor maps, shared with the
// backward (flash_attention_bwd.cu)
#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // KV rows per tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kRows = kBQ / 16;       // query rows per thread
constexpr int kCols = kBK / 16;       // score columns per thread
constexpr int kMaxHd = 128;
constexpr int kOut = kMaxHd / 16;     // output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

struct Strides {  // element strides of (batch, sequence, head); dim is 1
  long long b, s, h;
};

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)hd * kBQ + (size_t)hd * (kBK + 1) +
                          (size_t)kBK * hd + (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, Strides so, int Sq, int Skv, int H,
    int Hkv, int hd, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qt = smem;                       // [hd][kBQ], scaled
  float* Kt = Qt + hd * kBQ;              // [hd][kBK + 1]
  float* Vs = Kt + hd * (kBK + 1);        // [kBK][hd]
  float* Ps = Vs + kBK * hd;              // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    Qt[d * kBQ + r] =
        q0 + r < Sq ? to_f(qb[(long long)(q0 + r) * sq.s + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {  // stop at the tile holding the last real row's diagonal
    const int last = min(q0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q stored; the last tile's K, V and P reads done
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int c = e / hd, d = e % hd;
      const bool ok = k0 + c < Skv;
      Kt[d * (kBK + 1) + c] =
          ok ? to_f(kb[(long long)(k0 + c) * sk.s + d]) : 0.f;
      Vs[c * hd + d] = ok ? to_f(vb[(long long)(k0 + c) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kBQ + ty * kRows]);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
      float kc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = Kt[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Skv || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the same 16 lanes

    for (int c2 = 0; c2 < kBK; ++c2) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty * kRows + i) * (kBK + 1) + c2];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) {
          const float vv = Vs[c2 * hd + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp of the scaled scores (Q is pre-scaled)
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + r] = m[i] + logf(den);
    T* ob = o + b * so.b + (long long)r * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[d] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int Sq, int Skv, int H, int Hkv,
           int hd, int causal, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv, so, Sq,
      Skv, H, Hkv, hd, 1.0f / sqrtf((float)hd), causal);
  return (int)cudaGetLastError();
}

}  // namespace

namespace sm90 {

constexpr int kBM = 128;              // query rows per block
constexpr int kBN = 128;              // KV rows per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;

// Shared memory of one block, in bytes from a 1024-aligned base: Q, the K
// ring, the V ring (each tile one span of kSpan columns after another,
// rows of 128 bytes, swizzled), then the mbarriers.
template <int HDP>
struct Layout {
  static constexpr uint32_t kSpans = HDP / kSpan;
  static constexpr uint32_t kQSpan = kBM * 128;
  static constexpr uint32_t kKVSpan = kBN * 128;
  static constexpr uint32_t kQBytes = kSpans * kQSpan;
  static constexpr uint32_t kKVBytes = kSpans * kKVSpan;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  // barriers: Q full, K full[kStages], V full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

// HDP: head_dim padded to whole spans (64 or 128); KS: k-steps of 16
// columns in S = Q K^T and NO: output columns of P V (ceil(hd / 16) and
// hd rounded up to a supported count; past hd, TMA's zeros).
template <int HDP, int KS, int NO>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, long long so_b, long long so_s, long long so_h,
    int Sq, int Skv, int H, int Hkv, int hd, float scale_log2, int causal) {
  using Lay = Layout<HDP>;
  static_assert(KS * 16 <= HDP && NO <= HDP, "past the padded head_dim");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + Lay::kK, sV = base + Lay::kV;
  const uint32_t bar_q = base + Lay::kBar;
  const uint32_t bar_k = bar_q + 8;                 // [kStages]
  const uint32_t bar_v = bar_k + 8 * kStages;       // [kStages]
  const uint32_t bar_e = bar_v + 8 * kStages;       // [kStages]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest tiles first
  const int kh = h / (H / Hkv);
  int n_tiles = (Skv + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, Sq) - 1) / kBN + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // -- producer warpgroup: one thread issues every copy ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, Lay::kQBytes);
#pragma unroll
      for (int c = 0; c < (int)Lay::kSpans; ++c)
        tma_load_4d(sQ + c * Lay::kQSpan, &tq, bar_q, c * kSpan, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_e + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t kd = sK + s * Lay::kKVBytes, vd = sV + s * Lay::kKVBytes;
        mbar_expect_tx(bar_k + 8 * s, Lay::kKVBytes);
#pragma unroll
        for (int c = 0; c < (int)Lay::kSpans; ++c)
          tma_load_4d(kd + c * Lay::kKVSpan, &tk, bar_k + 8 * s, c * kSpan, kh,
                      t * kBN, b);
        mbar_expect_tx(bar_v + 8 * s, Lay::kKVBytes);
#pragma unroll
        for (int c = 0; c < (int)Lay::kSpans; ++c)
          tma_load_4d(vd + c * Lay::kKVSpan, &tv, bar_v + 8 * s, c * kSpan, kh,
                      t * kBN, b);
      }
    }
  } else {
    // -- consumer warpgroups: 64 query rows each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int qw0 = q0 + wg * 64;                  // this warpgroup's first row
    const int row0 = qw0 + warp * 16 + lane / 4;   // this thread's rows: row0
    const int row1 = row0 + 8;                     // and row0 + 8
    const int cq = 2 * (lane % 4);                 // column pair in 8 columns
    float acc[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBN;

      // S = Q K^T over the k-steps of head_dim
      float S[kBN / 2];
      mbar_wait(bar_k + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t a = sQ + (ks / 4) * Lay::kQSpan + wg * 64 * 128 +
                           (ks % 4) * 32;
        const uint32_t bk = sK + s * Lay::kKVBytes + (ks / 4) * Lay::kKVSpan +
                            (ks % 4) * 32;
        wgmma_ss_m64n128(S, desc_sw128(a, 16, 1024), desc_sw128(bk, 16, 1024),
                         ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(S);

      // mask the tiles that cross the diagonal or the end of K/V
      if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > qw0)) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + cq + (e & 1);
            const int qpos = e < 2 ? row0 : row1;
            if (kpos >= Skv || (causal && kpos > qpos)) S[4 * j + e] = kNegInf;
          }
      }

      // online softmax on the accumulator registers (a row: one quad)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(S[4 * j], S[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(S[4 * j + 2], S[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f((m0 - mn0) * scale_log2);
      const float alpha1 = exp2f((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float c0 = mn0 * scale_log2, c1 = mn1 * scale_log2;
      uint32_t P[kBN / 4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = exp2f(fmaf(S[8 * kk + e], scale_log2, (e & 2) ? -c1 : -c0));
        ps0 += (p[0] + p[1]) + (p[4] + p[5]);
        ps1 += (p[2] + p[3]) + (p[6] + p[7]);
        // A fragment of k-step kk: rows (row0, row1) x columns
        // (16 kk + cq, 16 kk + 8 + cq), two values each
        P[4 * kk + 0] = pack_bf16(p[0], p[1]);
        P[4 * kk + 1] = pack_bf16(p[2], p[3]);
        P[4 * kk + 2] = pack_bf16(p[4], p[5]);
        P[4 * kk + 3] = pack_bf16(p[6], p[7]);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // acc += P V, V MN-major: spans of 64 columns kKVSpan bytes apart
      // (leading offset), groups of 8 rows 1024 bytes apart (stride offset)
      mbar_wait(bar_v + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2],
                               P[4 * kk + 3]};
        const uint32_t bv = sV + s * Lay::kKVBytes + kk * 16 * 128;
        wgmma_pv<NO>(acc, a, desc_sw128(bv, Lay::kKVSpan, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(P);
      if (lane == 0) mbar_arrive(bar_e + 8 * s);   // this warp is done with s
    }

    // epilogue: the quad's partial row sums, acc / max(l, 1e-30)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (lse != nullptr && lane % 4 == 0) {
      // natural-log log-sum-exp of the scaled scores: m is a raw score and
      // l a sum of exp2((s - m) scale_log2) = exp((s - m) / sqrt(hd))
      const float scale = scale_log2 * 0.6931471805599453f;
      float* lb = lse + ((long long)b * H + h) * Sq;
      if (row0 < Sq) lb[row0] = m0 * scale + logf(d0);
      if (row1 < Sq) lb[row1] = m1 * scale + logf(d1);
    }
    __nv_bfloat16* o0 = o + b * so_b + (long long)row0 * so_s + h * so_h;
    __nv_bfloat16* o1 = o0 + 8 * so_s;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= hd) break;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

template <int HDP, int KS, int NO>
int launch_hd(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, void* o, float* lse, const long long* so,
              int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
              cudaStream_t stream) {
  const auto kernel = flash_attention_kernel_sm90<HDP, KS, NO>;
  const int smem = (int)Layout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, so[0], so[1], so[2],
      Sq, Skv, H, Hkv, hd, 1.4426950408889634f / sqrtf((float)hd), causal);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int Sq, int Skv, int H, int Hkv,
           int hd, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, st, B, Sq, H, hd, kBM) ||
      !encode(&tk, k, st + 3, B, Skv, Hkv, hd, kBN) ||
      !encode(&tv, v, st + 6, B, Skv, Hkv, hd, kBN))
    return (int)cudaErrorInvalidValue;
  auto* run = hd <= 64   ? launch_hd<64, 4, 64>
              : hd <= 80 ? launch_hd<128, 5, 80>
                         : launch_hd<128, 8, 128>;
  return run(tq, tk, tv, o, lse, st + 9, B, Sq, Skv, H, Hkv, hd, causal,
             stream);
}

}  // namespace sm90

// Plain C entry point (bound with ctypes).  `strides` holds 12 element
// strides: (batch, sequence, head) of q, k, v and o in that order.  `lse`
// is null, or fp32 (B, H, Sq), contiguous: each row's natural-log
// log-sum-exp of its scaled, masked scores, m + log(l), which the backward
// (flash_attention_bwd.cu) recomputes P from.  Null costs nothing: the
// kernels only skip the store.
// `kernel` is ops.route's choice: 0 launches the CUDA-core kernel on
// float32 inputs, 1 the tensor-core kernel on bfloat16 inputs (which also
// needs 16-byte aligned bases and strides that are multiples of 8
// elements; ops.py checks them).  Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t
// (0 = cudaSuccess).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int Sq, int Skv, int H, int Hkv, int hd,
    int causal, int kernel, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (hd <= 0 || hd > kMaxHd || hd % 8 != 0 || Skv <= 0 || Hkv <= 0 ||
      H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch<float>(q, k, v, o, lse, strides, B, Sq, Skv, H, Hkv, hd,
                         causal, s);
  if (kernel == 1)
    return sm90::launch(q, k, v, o, lse, strides, B, Sq, Skv, H, Hkv, hd,
                        causal, s);
  return (int)cudaErrorInvalidValue;
}
