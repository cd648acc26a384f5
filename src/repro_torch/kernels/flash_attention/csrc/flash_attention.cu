// Causal / full attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:25 (_kernel,
// launched by flash_attention_bh at :77, pallas_call at :90).  It takes
// the public layout of that kernel's wrapper (ops.py): q (B, Sq, H, hd),
// k/v (B, Skv, Hkv, hd), any strides with the last dimension contiguous,
// and does grouped-query attention by head index (query head h reads KV
// head h / (H / Hkv)); the K/V heads are never repeated in memory, and
// head_dim is not padded (any multiple of 8 up to 128).  Causal masking is
// top-left aligned (kpos <= qpos), as the reference has it.
//
// Design: one block of 256 threads per (64 query rows, head, batch).  The
// block keeps its Q tile (pre-scaled, fp32) in shared memory and walks
// the KV tiles of 64 rows; under the causal mask it stops at the tile
// that holds its last row's diagonal, so fully masked tiles are never
// loaded (the TPU kernel's skip test never fires, see ROADMAP.md).  Each
// thread owns 4 query rows x 4 score columns of a tile (S = Q K^T in fp32
// on the CUDA cores) and the same 4 rows x up to 8 output columns of the
// accumulator, in registers.  Row max and row sum reduce over the 16
// lanes that share a row with shuffles; masked scores are -1e30 (the
// reference's constant); the output is acc / max(l, 1e-30) stored in the
// input type.  Shared memory: Q^T [hd][64], K^T [hd][65] (padded so the
// transposing store is free of bank conflicts), V [64][hd] and P [64][65],
// 115 KB at hd = 128, set with cudaFuncSetAttribute.
//
// What bounds it on this card: operations.  Prefill at S = 2048 does
// 4 * H * hd * S^2 / 2 flops per sequence and layer on 2 * S * (H + 2 Hkv)
// * hd inputs, far above the 295 flop/byte ridge of the bf16 tensor cores.
// This first version computes on the fp32 CUDA cores (67 TFLOP/s peak),
// so it can reach at most 1/15 of the bf16 tensor-core bound; wgmma
// tiles fed by TMA, with warp specialisation, are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
    Strides sv, Strides so, int Sq, int Skv, int H, int Hkv, int hd,
    float scale, int causal) {
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
    T* ob = o + b * so.b + (long long)r * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[d] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
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
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, Sq, Skv,
      H, Hkv, hd, 1.0f / sqrtf((float)hd), causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  `strides` holds 12 element
// strides: (batch, sequence, head) of q, k, v and o in that order.  dtype
// is 0 for float32 and 1 for bfloat16.  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int Sq, int Skv, int H, int Hkv, int hd,
    int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (hd <= 0 || hd > kMaxHd || hd % 8 != 0 || Skv <= 0 || Hkv <= 0 ||
      H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, strides, B, Sq, Skv, H, Hkv, hd, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, strides, B, Sq, Skv, H, Hkv, hd,
                                 causal, s);
  return (int)cudaErrorInvalidValue;
}
