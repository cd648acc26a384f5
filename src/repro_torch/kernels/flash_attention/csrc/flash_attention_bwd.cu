// The gradient of causal / full attention, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference has no backward kernel and no
// custom_vjp, and its attention gradient is XLA's autodiff of the plain
// src/repro/models/layers.py:128 attention.  The port's forward is the
// hand-written flash_attention.cu, whose output carries no autograd graph,
// so its training path needs this kernel (ops.py's autograd Function
// launches it).  It computes what that autodiff computes, from q, k, v, the
// forward's output o, its per-row natural-log log-sum-exp lse (B, H, Sq)
// and the output's gradient do:
//
//   P  = exp(scale * Q K^T - lse)      (masked entries 0; scale = 1/sqrt(hd))
//   dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o O),  dS = P o (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
//
// with grouped-query attention by head index (query head h reads KV head
// h / (H / Hkv)), so dK and dV sum over each KV head's query group.  The
// domain is the forward's: head_dim any multiple of 8 up to 128, causal
// (top-left, kpos <= qpos) or full, Sq != Skv, any lengths; q, k, v, o
// and do contiguous (B, S, heads, hd), fp32 or bf16 (all one type), lse
// and D fp32; the gradients are written in the input type.
//
// What bounds it on this card: operations.  At olmo-1b's training shape
// (B 4, S 4,096, 16 heads of 128, causal) it does 7 products of a
// 64 x 64 tile by head_dim per tile pair (the dK/dV kernel S, dP, dV, dK;
// the dQ kernel S, dP, dQ) on inputs of a few MB.  This first version runs
// them on the fp32 CUDA cores for both types (67 TFLOP/s peak, against the
// 989 of the bf16 tensor cores): simple and deterministic, with no float
// atomics.  Three kernels, one launch of the C entry point:
//
// * delta_kernel: D = rowsum(dO o O), a warp a (batch, row, head).
// * dkdv_kernel: one block of 256 threads per (64 KV rows, KV head, batch)
//   loops over the query heads of its group and over the query tiles of 64
//   rows that reach its keys (under the causal mask, from its own tile
//   on), holding dK and dV (64 x hd each) in registers: 4 KV rows x 8
//   columns a thread.  K and V stay in shared memory, transposed; each
//   query tile's Q and dO come in transposed too, P and dS go through
//   shared memory transposed, so the products read 16-byte vectors.
// * dq_kernel: one block of 256 threads per (64 query rows, head, batch)
//   loops over the KV tiles up to its diagonal, holding dQ (64 x hd) in
//   registers; the heaviest query tiles are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A named namespace, so a profiler's kernel names say whose kernels these
// are (flash_bwd::dkdv_kernel, flash_bwd::dq_kernel, flash_bwd::delta_kernel).
namespace flash_bwd {

constexpr int kB = 64;                // rows of a query tile and a KV tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kR = kB / 16;           // rows a thread
constexpr int kMaxHd = 128;
constexpr int kC = kMaxHd / 16;       // head_dim columns a thread
constexpr int kLdT = kB + 4;          // transposed [hd][rows] tiles: 16-byte rows
constexpr int kLdK = kB + 1;          // transposed K, V in the dQ kernel's reads

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
  return __float2bfloat16_rn(x);
}

struct Shape {
  int B, Sq, Skv, H, Hkv, hd, causal;
  float scale;
};

// Rows [r0, r0 + kB) of head h of a contiguous (B, S, heads, hd) tensor,
// transposed into dst[d * ld + r] as fp32; zeros past S and past hd.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* src,
                                       int b, int r0, int h, int S, int heads,
                                       int hd, int tid) {
  const T* base = src + ((long long)b * S * heads + h) * hd;
  for (int e = tid; e < kB * kMaxHd; e += kThreads) {
    const int r = e / kMaxHd, d = e % kMaxHd;
    float x = 0.f;
    if (d < hd && r0 + r < S)
      x = to_f(base[(long long)(r0 + r) * heads * hd + d]);
    if (d < hd) dst[d * ld + r] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int B, int Sq, int H, int hd) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Sq * H) return;
  const int h = warp % H, i = (warp / H) % Sq, b = warp / (H * Sq);
  const long long off = (((long long)b * Sq + i) * H + h) * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += to_f(o[off + d]) * to_f(dout[off + d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[((long long)b * H + h) * Sq + i] = s;
}

// P and dS of one (query tile, KV tile) pair from the transposed tiles in
// shared memory: thread (ty, tx) owns query rows ty * kR + i and KV columns
// tx + 16 j.  p[i][j] and ds[i][j] come back masked (0 outside the mask).
__device__ __forceinline__ void tile_p_ds(
    const float* Qt, const float* dOt, const float* Kt, const float* Vt,
    int ldkv, const float* lse_s, const float* d_s, int q0, int k0,
    const Shape& sh, int ty, int tx, float (&p)[kR][kR], float (&ds)[kR][kR]) {
  float s[kR][kR], dp[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < sh.hd; ++d) {
    const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kLdT + ty * kR]);
    const float4 ov = *reinterpret_cast<const float4*>(&dOt[d * kLdT + ty * kR]);
    const float qr[kR] = {qv.x, qv.y, qv.z, qv.w};
    const float orr[kR] = {ov.x, ov.y, ov.z, ov.w};
    float kc[kR], vc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      kc[j] = Kt[d * ldkv + tx + 16 * j];
      vc[j] = Vt[d * ldkv + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
        dp[i][j] = fmaf(orr[i], vc[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < sh.Sq && kpos < sh.Skv &&
                      !(sh.causal && kpos > qpos);
      p[i][j] = ok ? expf(s[i][j] * sh.scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - d_s[r]);
    }
  }
}

// Shared memory of the dK/dV kernel (floats): Qt, dOt [hd][kLdT]; Kt, Vt
// [hd][kLdT]; PT, dST [kB][kLdT]; lse and D of the query tile [kB] each.
size_t dkdv_smem(int hd) {
  return sizeof(float) *
         (4 * (size_t)hd * kLdT + 2 * (size_t)kB * kLdT + 2 * (size_t)kB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int hd = sh.hd;
  float* Qt = smem;
  float* dOt = Qt + hd * kLdT;
  float* Kt = dOt + hd * kLdT;
  float* Vt = Kt + hd * kLdT;
  float* PT = Vt + hd * kLdT;          // [kv j][query i]
  float* dST = PT + kB * kLdT;
  float* lse_s = dST + kB * kLdT;
  float* d_s = lse_s + kB;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kB, kh = blockIdx.y, b = blockIdx.z;
  const int G = sh.H / sh.Hkv;
  load_t(Kt, kLdT, k, b, k0, kh, sh.Skv, sh.Hkv, hd, tid);
  load_t(Vt, kLdT, v, b, k0, kh, sh.Skv, sh.Hkv, hd, tid);

  float adk[kR][kC], adv[kR][kC];
#pragma unroll
  for (int j = 0; j < kR; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) adk[j][c] = adv[j][c] = 0.f;

  // under the causal mask only queries at or after this tile's first key
  const int t0 = sh.causal ? k0 / kB : 0;
  const int n_q = (sh.Sq + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* lse_h = lse + ((long long)b * sh.H + h) * sh.Sq;
    const float* d_h = delta + ((long long)b * sh.H + h) * sh.Sq;
    for (int t = t0; t < n_q; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the last tile's reads of Qt, dOt, PT, dST are done
      load_t(Qt, kLdT, q, b, q0, h, sh.Sq, sh.H, hd, tid);
      load_t(dOt, kLdT, dout, b, q0, h, sh.Sq, sh.H, hd, tid);
      if (tid < kB) {
        const bool in = q0 + tid < sh.Sq;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        d_s[tid] = in ? d_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float p[kR][kR], ds[kR][kR];
      tile_p_ds(Qt, dOt, Kt, Vt, kLdT, lse_s, d_s, q0, k0, sh, ty, tx, p, ds);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        *reinterpret_cast<float4*>(&PT[c * kLdT + ty * kR]) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
        *reinterpret_cast<float4*>(&dST[c * kLdT + ty * kR]) =
            make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: KV rows ty * kR + j, columns tx + 16 c
      for (int i = 0; i < kB; i += 4) {
        float4 pv[kR], sv[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          pv[j] = *reinterpret_cast<const float4*>(&PT[(ty * kR + j) * kLdT + i]);
          sv[j] = *reinterpret_cast<const float4*>(&dST[(ty * kR + j) * kLdT + i]);
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = tx + 16 * c;
          if (d < hd) {
            const float4 o4 = *reinterpret_cast<const float4*>(&dOt[d * kLdT + i]);
            const float4 q4 = *reinterpret_cast<const float4*>(&Qt[d * kLdT + i]);
#pragma unroll
            for (int j = 0; j < kR; ++j) {
              adv[j][c] += pv[j].x * o4.x + pv[j].y * o4.y + pv[j].z * o4.z +
                           pv[j].w * o4.w;
              adk[j][c] += sv[j].x * q4.x + sv[j].y * q4.y + sv[j].z * q4.z +
                           sv[j].w * q4.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int r = k0 + ty * kR + j;
    if (r >= sh.Skv) continue;
    const long long off = (((long long)b * sh.Skv + r) * sh.Hkv + kh) * hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        dk[off + d] = from_f<T>(adk[j][c] * sh.scale);
        dv[off + d] = from_f<T>(adv[j][c]);
      }
    }
  }
}

// Shared memory of the dQ kernel (floats): Qt, dOt [hd][kLdT]; Kt, Vt
// [hd][kLdK]; dST [kB][kLdT]; lse and D [kB] each.
size_t dq_smem(int hd) {
  return sizeof(float) * (2 * (size_t)hd * kLdT + 2 * (size_t)hd * kLdK +
                          (size_t)kB * kLdT + 2 * (size_t)kB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int hd = sh.hd;
  float* Qt = smem;
  float* dOt = Qt + hd * kLdT;
  float* dST = dOt + hd * kLdT;        // [kv j][query i]
  float* lse_s = dST + kB * kLdT;
  float* d_s = lse_s + kB;
  float* Kt = d_s + kB;                // [hd][kLdK]
  float* Vt = Kt + hd * kLdK;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (sh.H / sh.Hkv);
  load_t(Qt, kLdT, q, b, q0, h, sh.Sq, sh.H, hd, tid);
  load_t(dOt, kLdT, dout, b, q0, h, sh.Sq, sh.H, hd, tid);
  if (tid < kB) {
    const bool in = q0 + tid < sh.Sq;
    const long long row = ((long long)b * sh.H + h) * sh.Sq + q0 + tid;
    lse_s[tid] = in ? lse[row] : 0.f;
    d_s[tid] = in ? delta[row] : 0.f;
  }

  float adq[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) adq[i][c] = 0.f;

  int n_k = (sh.Skv + kB - 1) / kB;
  if (sh.causal) n_k = min(n_k, (min(q0 + kB, sh.Sq) - 1) / kB + 1);
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // Q, dO, lse, D stored; the last tile's reads done
    load_t(Kt, kLdK, k, b, k0, kh, sh.Skv, sh.Hkv, hd, tid);
    load_t(Vt, kLdK, v, b, k0, kh, sh.Skv, sh.Hkv, hd, tid);
    __syncthreads();

    float p[kR][kR], ds[kR][kR];
    tile_p_ds(Qt, dOt, Kt, Vt, kLdK, lse_s, d_s, q0, k0, sh, ty, tx, p, ds);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      *reinterpret_cast<float4*>(&dST[(tx + 16 * j) * kLdT + ty * kR]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

    // dQ += dS K: query rows ty * kR + i, columns tx + 16 c
    for (int j = 0; j < kB; ++j) {
      const float4 s4 = *reinterpret_cast<const float4*>(&dST[j * kLdT + ty * kR]);
      const float sr[kR] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) {
          const float kv = Kt[d * kLdK + j];
#pragma unroll
          for (int i = 0; i < kR; ++i) adq[i][c] = fmaf(sr[i], kv, adq[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty * kR + i;
    if (r >= sh.Sq) continue;
    const long long off = (((long long)b * sh.Sq + r) * sh.H + h) * hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) dq[off + d] = from_f<T>(adq[i][c] * sh.scale);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  const int rows = sh.B * sh.Sq * sh.H;
  delta_kernel<T><<<(rows * 32 + kThreads - 1) / kThreads, kThreads, 0,
                    stream>>>(static_cast<const T*>(o),
                              static_cast<const T*>(dout), delta, sh.B, sh.Sq,
                              sh.H, sh.hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t s1 = dkdv_smem(sh.hd), s2 = dq_smem(sh.hd);
  err = cudaFuncSetAttribute(dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dot = static_cast<const T*>(dout);
  dkdv_kernel<T><<<dim3((sh.Skv + kB - 1) / kB, sh.Hkv, sh.B), kThreads, s1,
                   stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                             static_cast<T*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T><<<dim3((sh.Sq + kB - 1) / kB, sh.H, sh.B), kThreads, s2,
                 stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq),
                           sh);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// Plain C entry point (bound with ctypes).  q, o, do and dq are contiguous
// (B, Sq, H, hd); k, v, dk and dv contiguous (B, Skv, Hkv, hd); lse (the
// forward's) and `delta` (scratch, written here) fp32 (B, H, Sq).  `dtype`
// is 0 for float32 and 1 for bfloat16.  Launches the three kernels on
// `stream` in order, does not synchronise, and returns the first failed
// launch's cudaError_t (0 = cudaSuccess).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (hd <= 0 || hd > flash_bwd::kMaxHd || hd % 8 != 0 || Skv <= 0 ||
      Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const flash_bwd::Shape sh{B, Sq, Skv, H, Hkv, hd, causal,
                            1.0f / sqrtf((float)hd)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_bwd::launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    sh, s);
  if (dtype == 1)
    return flash_bwd::launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, sh, s);
  return (int)cudaErrorInvalidValue;
}
