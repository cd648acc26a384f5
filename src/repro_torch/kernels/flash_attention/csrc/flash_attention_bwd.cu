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
// and D fp32; the gradients are written in the input type.  Nothing is
// summed with atomics, so a call's result does not depend on the order in
// which blocks run (a resumed training run repeats its steps bit for bit).
//
// What bounds it on this card: operations.  At olmo-1b's training shape
// (B 4, S 4,096, 16 heads of 128, causal) the products do about 9.6e11
// flops on inputs of about 0.3 GB, far above the 295 flop/byte ridge of
// the bf16 tensor cores.  The split below recomputes S and dP in the dQ
// kernel, so it does 7 tile products where a fused kernel does 5: 3.5 x
// the forward's flops, against the 2.5 x that chip_smoke.py's bound counts,
// so its time can reach at most 2.5 / 3.5 = 0.71 of that bound.
//
// Two routes, chosen by the input type (ops.py's BWD_ROUTES):
//
// * bf16 ("wgmma"), on the tensor cores: delta_kernel, then
//   dkdv_kernel_sm90 and dq_kernel_sm90.  Each block is two warpgroups of
//   64 rows with no producer warp, so a thread may hold the 192 values a
//   dK/dV thread keeps live (see kTcThreads).  A block keeps a resident
//   tile of 128 rows (K and V in dkdv, Q and dO in dq) and streams 64-row
//   tiles of the other pair (Q and dO, or K and V) by TMA through a ring
//   of two stages, signalled by mbarriers: once every warp has released a
//   stage, warp 0 fills it with the tile after next.  Tiles are the
//   forward's 128-byte-swizzled boxes of 64 columns (sm90.cuh), zeros past
//   head_dim and past the sequence.
//   - dkdv_kernel_sm90: a block per (128 KV rows, KV head, batch), the
//     blocks of the first KV rows (the most query tiles under the causal
//     mask) first.  It streams every (query head of the group, query tile)
//     pair from the causal diagonal on; warp 0's lanes put the tile's lse
//     and D in shared memory beside it.  S^T = K Q^T and dP^T = V dO^T are
//     wgmma m64n64k16 with both operands in shared memory, K-major as
//     stored; P^T and dS^T are formed on the accumulator registers, rounded
//     to bf16, and are the A operand, from registers, of dV += P^T dO and
//     dK += dS^T Q, whose B (dO, Q) is read MN-major through the
//     descriptor's transpose bit.  dK and dV (64 x head_dim fp32 each)
//     stay in registers over the whole loop.
//   - dq_kernel_sm90: a block per (128 query rows, head, batch), heaviest
//     first; Q, dO, lse and D loaded once; it streams the KV tiles up to
//     its diagonal.  S = Q K^T and dP = dO V^T as above, P and dS per row,
//     dS rounded to bf16, dQ += dS K with K read MN-major.
//   Both mask only the tiles that cross the diagonal or the end, and a
//   warpgroup skips the products of a tile it cannot see.  Against the
//   fp32 plain backward the route's one departure is the bf16 rounding of
//   P before P^T dO and of dS before dS K and dS^T Q (ref.py's
//   round_to=torch.bfloat16 repeats it); the reference's own bf16 gradient
//   rounds P as well, and its dP, to bf16.
// * fp32 ("cuda_cores"), on the fp32 CUDA cores (67 TFLOP/s peak): it is
//   what the fp32 checks (2e-5) and the bit-equal resumes hold the model
//   to.  Three kernels, one launch of the C entry point:
//   - delta_kernel: D = rowsum(dO o O), a warp a (batch, row, head).
//   - dkdv_kernel: one block of 256 threads per (64 KV rows, KV head,
//     batch) loops over the query heads of its group and over the query
//     tiles of 64 rows that reach its keys (under the causal mask, from its
//     own tile on), holding dK and dV (64 x hd each) in registers: 4 KV
//     rows x 8 columns a thread.  K and V stay in shared memory,
//     transposed; each query tile's Q and dO come in transposed too, P and
//     dS go through shared memory transposed, so the products read 16-byte
//     vectors.
//   - dq_kernel: one block of 256 threads per (64 query rows, head, batch)
//     loops over the KV tiles up to its diagonal, holding dQ (64 x hd) in
//     registers; the heaviest query tiles are scheduled first.

#include "sm90.cuh"

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


// -- the bf16 route: tensor cores ---------------------------------------------

using namespace ::sm90;

constexpr int kTile = 64;             // rows of a streamed tile, of a warpgroup
constexpr int kResident = 128;        // rows of a block's resident tile
constexpr int kRing = 2;              // streamed tiles in flight
constexpr int kWgs = 2;               // warpgroups
// No producer warp: a dK/dV thread holds 128 accumulators and a 64 x 64
// score tile (S, dP: 64 more) in registers, which 256 threads a block
// allow (255 each).  With a producer warpgroup and setmaxnreg 24 / 240
// ptxas kept the kernel to the 168 registers of its 384-thread bound,
// spilled 436 bytes and serialized the wgmmas; with a producer warp (288
// threads) three warps share a quarter of the SM's registers, and 224 a
// thread did not launch.
constexpr int kTcThreads = 128 * kWgs;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes from a 1024-aligned base: the two
// resident tiles (128 rows each), the two streamed tiles of each ring
// stage (64 rows each), each tile one span of kSpan columns after another
// (rows of 128 bytes, swizzled); the ring's lse and D (dkdv), then the
// mbarriers.
template <int HDP>
struct TcLayout {
  static constexpr uint32_t kSpans = HDP / kSpan;
  static constexpr uint32_t kResSpan = kResident * 128;
  static constexpr uint32_t kTileSpan = kTile * 128;
  static constexpr uint32_t kResBytes = kSpans * kResSpan;
  static constexpr uint32_t kTileBytes = kSpans * kTileSpan;
  static constexpr uint32_t kRes1 = kResBytes;             // resident A1
  static constexpr uint32_t kRing0 = 2 * kResBytes;        // [kRing] B0 tiles
  static constexpr uint32_t kRing1 = kRing0 + kRing * kTileBytes;
  // lse and D of each stage: [kRing][2][kTile] floats
  static constexpr uint32_t kVec = kRing1 + kRing * kTileBytes;
  static constexpr uint32_t kBar = kVec + kRing * 2 * kTile * 4;
  // barriers: resident full, full[kRing], empty[kRing]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kRing) + 1024;
};

// `rows` rows (64 or 128, as 64-row boxes) from row r0 of head h of batch
// b into shared memory at dst, every span of head_dim, completing on bar.
template <int HDP>
__device__ __forceinline__ void load_rows(uint32_t dst, int rows,
                                          const CUtensorMap* map,
                                          uint32_t bar, int h, int r0,
                                          int b) {
  const uint32_t span = rows * 128;
#pragma unroll
  for (int c = 0; c < HDP / kSpan; ++c)
    for (int r = 0; r < rows; r += kTile)
      tma_load_4d(dst + c * span + r * 128, map, bar, c * kSpan, h, r0 + r, b);
}

// S = A0 B0^T and dP = A1 B1^T of this warpgroup's 64 resident rows (a0,
// a1: the rows' first byte) against a streamed tile (b0, b1): m64n64, both
// operands K-major, KS k-steps of 16 columns of head_dim.  A step's
// descriptor is its operand's first one plus the step's byte offset >> 4
// (the descriptor's address field).
template <int HDP, int KS>
__device__ __forceinline__ void scores(float (&S)[32], float (&dP)[32],
                                       uint32_t a0, uint32_t a1, uint32_t b0,
                                       uint32_t b1) {
  using Lay = TcLayout<HDP>;
  const uint64_t da0 = desc_sw128(a0, 16, 1024), da1 = desc_sw128(a1, 16, 1024);
  const uint64_t db0 = desc_sw128(b0, 16, 1024), db1 = desc_sw128(b1, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_m64n64(S, da0 + (((ks / 4) * Lay::kResSpan + (ks % 4) * 32) >> 4),
                    db0 + (((ks / 4) * Lay::kTileSpan + (ks % 4) * 32) >> 4),
                    ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_m64n64(dP, da1 + (((ks / 4) * Lay::kResSpan + (ks % 4) * 32) >> 4),
                    db1 + (((ks / 4) * Lay::kTileSpan + (ks % 4) * 32) >> 4),
                    ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(S);
  fence_regs(dP);
}

// acc (64 x NO) += A B: A (64 x 64 bf16) the packed registers of a score
// tile (the accumulator and A-fragment layouts coincide), B the streamed
// tile at b (64 rows x head_dim) read MN-major: spans of 64 columns
// kTileSpan bytes apart, groups of 8 rows 1024 bytes apart.
template <int HDP, int NO>
__device__ __forceinline__ void accumulate(float (&acc)[NO / 2],
                                           const uint32_t (&A)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {A[4 * kk], A[4 * kk + 1], A[4 * kk + 2],
                           A[4 * kk + 3]};
    wgmma_pv<NO>(acc, a, desc_sw128(b + kk * 16 * 128,
                                    TcLayout<HDP>::kTileSpan, 1024));
  }
}

// Rows row0, row0 + 8 of a 64 x NO accumulator, times `scale`, into the
// contiguous (B, S, heads, hd) gradient g at (b, row, head), columns < hd.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g,
                                           const float (&acc)[NO / 2],
                                           float scale, int b, int row0,
                                           int S, int heads, int head, int hd,
                                           int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* dst = g + (((long long)b * S + row) * heads + head) * hd;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
    }
  }
}

// Launch-invariant inputs of the two tensor-core kernels.
struct TcArgs {
  const float* lse;
  const float* delta;
  __nv_bfloat16* out0;   // dkdv: dK; dq: dQ
  __nv_bfloat16* out1;   // dkdv: dV
  float scale_log2;      // log2(e) / sqrt(hd)
};

// HDP: head_dim padded to whole spans (64 or 128); KS: k-steps of 16
// columns in the scores; NO: columns of the gradients (hd rounded up to a
// supported count; past hd, TMA's zeros).
template <int HDP, int KS, int NO>
__global__ void __launch_bounds__(kTcThreads, 1) dkdv_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, TcArgs a, Shape sh) {
  using Lay = TcLayout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + Lay::kRes1;
  const uint32_t sQ = base + Lay::kRing0, sdO = base + Lay::kRing1;
  const uint32_t bar_kv = base + Lay::kBar;
  const uint32_t bar_f = bar_kv + 8;                 // [kRing]
  const uint32_t bar_e = bar_f + 8 * kRing;          // [kRing]
  float* vec = reinterpret_cast<float*>(smem_raw + (base + Lay::kVec -
                                                     smem_u32(smem_raw)));

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kResident;   // the most query tiles first
  const int G = sh.H / sh.Hkv;
  const int n_q = (sh.Sq + kTile - 1) / kTile;
  const int t0 = sh.causal ? min(k0 / kTile, n_q) : 0;
  const int n_t = n_q - t0;                // query tiles per query head
  const int n_iter = G * n_t;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_f + 8 * s, 32);          // the loading warp's lanes
      mbar_init(bar_e + 8 * s, kWgs * 4);    // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp 0 fills ring stage i % kRing with iteration i's (query head,
  // query tile): every lane writes its share of the tile's lse (base 2)
  // and D, lane 0 issues the TMA copies of Q and dO, and all arrive.
  const int lane = tid % 32;
  auto fill = [&](int i) {
    const int s = i % kRing, h = kh * G + i / n_t;
    const int q0 = (t0 + i % n_t) * kTile;
    const long long row = ((long long)b * sh.H + h) * sh.Sq + q0;
    float* ls = vec + s * 2 * kTile;
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      const bool in = q0 + r < sh.Sq;
      ls[r] = in ? a.lse[row + r] * kLog2e : 0.f;
      ls[kTile + r] = in ? a.delta[row + r] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(bar_f + 8 * s, 2 * Lay::kTileBytes);
      load_rows<HDP>(sQ + s * Lay::kTileBytes, kTile, &tq, bar_f + 8 * s, h,
                     q0, b);
      load_rows<HDP>(sdO + s * Lay::kTileBytes, kTile, &tdo, bar_f + 8 * s, h,
                     q0, b);
    } else {
      mbar_arrive(bar_f + 8 * s);
    }
  };
  if (tid < 32) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * Lay::kResBytes);
      load_rows<HDP>(sK, kResident, &tk, bar_kv, kh, k0, b);
      load_rows<HDP>(sV, kResident, &tv, bar_kv, kh, k0, b);
    }
    for (int i = 0; i < min(kRing, n_iter); ++i) fill(i);
  }

  // Two warpgroups of 64 KV rows each.
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int kw0 = k0 + wg * kTile;             // this warpgroup's first row
  const int row0 = kw0 + warp * 16 + lane / 4; // this thread's rows: row0
  const int row1 = row0 + 8;                   // and row0 + 8
  const int cq = 2 * (lane % 4);               // column pair in 8 columns
  float dK[NO / 2], dV[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dK[i] = dV[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kRing;
    const int q0 = (t0 + i % n_t) * kTile;
    mbar_wait(bar_f + 8 * s, (i / kRing) & 1);
    // a tile whose queries all precede this warpgroup's keys adds nothing
    if (!(sh.causal && kw0 > q0 + kTile - 1)) {
      float S[32], dP[32];
      scores<HDP, KS>(S, dP, sK + wg * kTile * 128, sV + wg * kTile * 128,
                      sQ + s * Lay::kTileBytes, sdO + s * Lay::kTileBytes);
      const bool edge = q0 + kTile > sh.Sq ||
                        (sh.causal && kw0 + kTile - 1 > q0);
      const float* ls = vec + s * 2 * kTile;
      uint32_t P[16], dS[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {   // S^T[2x], [2x + 1]: row, col pair
        const int col = 8 * (x / 2) + cq;
        const int kpos = (x & 1) ? row1 : row0, qpos = q0 + col;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + kTile + col);
        float p0 = exp2f(fmaf(S[2 * x], a.scale_log2, -l2.x));
        float p1 = exp2f(fmaf(S[2 * x + 1], a.scale_log2, -l2.y));
        if (edge) {
          if (qpos >= sh.Sq || (sh.causal && kpos > qpos)) p0 = 0.f;
          if (qpos + 1 >= sh.Sq || (sh.causal && kpos > qpos + 1)) p1 = 0.f;
        }
        P[x] = pack_bf16(p0, p1);
        dS[x] = pack_bf16(p0 * (dP[2 * x] - d2.x), p1 * (dP[2 * x + 1] - d2.y));
      }
      wgmma_fence();
      accumulate<HDP, NO>(dV, P, sdO + s * Lay::kTileBytes);
      accumulate<HDP, NO>(dK, dS, sQ + s * Lay::kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dV);
      fence_regs(dK);
      fence_regs(P);
      fence_regs(dS);
    }
    if (lane == 0) mbar_arrive(bar_e + 8 * s);   // this warp is done with s
    if (tid < 32 && i + kRing < n_iter) {         // refill s when all are
      mbar_wait(bar_e + 8 * s, (i / kRing) & 1);
      fill(i + kRing);
    }
  }
  const float scale = a.scale_log2 / kLog2e;
  store_rows<NO>(a.out0, dK, scale, b, row0, sh.Skv, sh.Hkv, kh, sh.hd, cq);
  store_rows<NO>(a.out1, dV, 1.f, b, row0, sh.Skv, sh.Hkv, kh, sh.hd, cq);
}

template <int HDP, int KS, int NO>
__global__ void __launch_bounds__(kTcThreads, 1) dq_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, TcArgs a, Shape sh) {
  using Lay = TcLayout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + Lay::kRes1;
  const uint32_t sK = base + Lay::kRing0, sV = base + Lay::kRing1;
  const uint32_t bar_q = base + Lay::kBar;
  const uint32_t bar_f = bar_q + 8;                  // [kRing]
  const uint32_t bar_e = bar_f + 8 * kRing;          // [kRing]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kResident;  // heaviest first
  const int kh = h / (sh.H / sh.Hkv);
  int n_k = (sh.Skv + kTile - 1) / kTile;
  if (sh.causal)
    n_k = min(n_k, (min(q0 + kResident, sh.Sq) - 1) / kTile + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kWgs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 fills ring stage t % kRing with KV tile t.
  auto fill = [&](int t) {
    const int s = t % kRing;
    mbar_expect_tx(bar_f + 8 * s, 2 * Lay::kTileBytes);
    load_rows<HDP>(sK + s * Lay::kTileBytes, kTile, &tk, bar_f + 8 * s, kh,
                   t * kTile, b);
    load_rows<HDP>(sV + s * Lay::kTileBytes, kTile, &tv, bar_f + 8 * s, kh,
                   t * kTile, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * Lay::kResBytes);
    load_rows<HDP>(sQ, kResident, &tq, bar_q, h, q0, b);
    load_rows<HDP>(sdO, kResident, &tdo, bar_q, h, q0, b);
    for (int t = 0; t < min(kRing, n_k); ++t) fill(t);
  }

  // Two warpgroups of 64 query rows each.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qw0 = q0 + wg * kTile;
  const int row0 = qw0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  const long long bh = ((long long)b * sh.H + h) * sh.Sq;
  const float l0 = row0 < sh.Sq ? a.lse[bh + row0] * kLog2e : 0.f;
  const float l1 = row1 < sh.Sq ? a.lse[bh + row1] * kLog2e : 0.f;
  const float d0 = row0 < sh.Sq ? a.delta[bh + row0] : 0.f;
  const float d1 = row1 < sh.Sq ? a.delta[bh + row1] : 0.f;
  float dQ[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dQ[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kRing, k0 = t * kTile;
    mbar_wait(bar_f + 8 * s, (t / kRing) & 1);
    // a tile whose keys all follow this warpgroup's queries adds nothing
    if (!(sh.causal && k0 > qw0 + kTile - 1)) {
      float S[32], dP[32];
      scores<HDP, KS>(S, dP, sQ + wg * kTile * 128, sdO + wg * kTile * 128,
                      sK + s * Lay::kTileBytes, sV + s * Lay::kTileBytes);
      const bool edge = k0 + kTile > sh.Skv ||
                        (sh.causal && k0 + kTile - 1 > qw0);
      uint32_t dS[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {   // S[2x], [2x + 1]: row, col pair
        const int kpos = k0 + 8 * (x / 2) + cq;
        const int qpos = (x & 1) ? row1 : row0;
        const float l = (x & 1) ? l1 : l0, d = (x & 1) ? d1 : d0;
        float p0 = exp2f(fmaf(S[2 * x], a.scale_log2, -l));
        float p1 = exp2f(fmaf(S[2 * x + 1], a.scale_log2, -l));
        if (edge) {
          if (kpos >= sh.Skv || (sh.causal && kpos > qpos)) p0 = 0.f;
          if (kpos + 1 >= sh.Skv || (sh.causal && kpos + 1 > qpos)) p1 = 0.f;
        }
        dS[x] = pack_bf16(p0 * (dP[2 * x] - d), p1 * (dP[2 * x + 1] - d));
      }
      wgmma_fence();
      accumulate<HDP, NO>(dQ, dS, sK + s * Lay::kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dQ);
      fence_regs(dS);
    }
    if (lane == 0) mbar_arrive(bar_e + 8 * s);
    if (tid == 0 && t + kRing < n_k) {          // refill s when all are done
      mbar_wait(bar_e + 8 * s, (t / kRing) & 1);
      fill(t + kRing);
    }
  }
  store_rows<NO>(a.out0, dQ, a.scale_log2 / kLog2e, b, row0, sh.Sq, sh.H, h,
                 sh.hd, cq);
}

template <int HDP, int KS, int NO>
int launch_tc_hd(const CUtensorMap (&maps)[4], const TcArgs& dkdv,
                 const TcArgs& dq, const Shape& sh, cudaStream_t stream) {
  const auto k1 = dkdv_kernel_sm90<HDP, KS, NO>;
  const auto k2 = dq_kernel_sm90<HDP, KS, NO>;
  const int smem = (int)TcLayout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3(sh.Hkv, sh.B, (sh.Skv + kResident - 1) / kResident), kTcThreads,
       smem, stream>>>(maps[0], maps[1], maps[2], maps[3], dkdv, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(sh.H, sh.B, (sh.Sq + kResident - 1) / kResident), kTcThreads,
       smem, stream>>>(maps[0], maps[1], maps[2], maps[3], dq, sh);
  return (int)cudaGetLastError();
}

// D, then dK and dV, then dQ on the tensor cores; q, k, v, o, do bf16.
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  const int rows = sh.B * sh.Sq * sh.H;
  delta_kernel<__nv_bfloat16><<<(rows * 32 + kThreads - 1) / kThreads,
                                kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, sh.B, sh.Sq, sh.H,
      sh.hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // contiguous (B, S, heads, hd): element strides (batch, sequence, head)
  const long long sq[3] = {(long long)sh.Sq * sh.H * sh.hd,
                           (long long)sh.H * sh.hd, sh.hd};
  const long long skv[3] = {(long long)sh.Skv * sh.Hkv * sh.hd,
                            (long long)sh.Hkv * sh.hd, sh.hd};
  CUtensorMap maps[4];   // q, k, v, do: boxes of 64 columns x 64 rows
  if (!encode(&maps[0], q, sq, sh.B, sh.Sq, sh.H, sh.hd, kTile) ||
      !encode(&maps[1], k, skv, sh.B, sh.Skv, sh.Hkv, sh.hd, kTile) ||
      !encode(&maps[2], v, skv, sh.B, sh.Skv, sh.Hkv, sh.hd, kTile) ||
      !encode(&maps[3], dout, sq, sh.B, sh.Sq, sh.H, sh.hd, kTile))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf((float)sh.hd);
  const TcArgs a_dkdv{lse, delta, static_cast<__nv_bfloat16*>(dk),
                      static_cast<__nv_bfloat16*>(dv), scale_log2};
  const TcArgs a_dq{lse, delta, static_cast<__nv_bfloat16*>(dq), nullptr,
                    scale_log2};
  auto* run = sh.hd <= 64   ? launch_tc_hd<64, 4, 64>
              : sh.hd <= 80 ? launch_tc_hd<128, 5, 80>
                            : launch_tc_hd<128, 8, 128>;
  return run(maps, a_dkdv, a_dq, sh, stream);
}

}  // namespace flash_bwd

// Plain C entry point (bound with ctypes).  q, o, do and dq are contiguous
// (B, Sq, H, hd); k, v, dk and dv contiguous (B, Skv, Hkv, hd); lse (the
// forward's) and `delta` (scratch, written here) fp32 (B, H, Sq).
// `kernel` is ops.bwd_route's choice: 0 launches the CUDA-core kernels on
// float32 inputs, 1 the tensor-core kernels on bfloat16 inputs (which also
// need 16-byte aligned bases; ops.py checks them).  Launches the three
// kernels on `stream` in order, does not synchronise, and returns the first
// failed launch's cudaError_t (0 = cudaSuccess).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
    int kernel, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (hd <= 0 || hd > flash_bwd::kMaxHd || hd % 8 != 0 || Skv <= 0 ||
      Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const flash_bwd::Shape sh{B, Sq, Skv, H, Hkv, hd, causal,
                            1.0f / sqrtf((float)hd)};
  auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return flash_bwd::launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    sh, s);
  if (kernel == 1)
    return flash_bwd::launch_tc(q, k, v, o, dout, lse, delta, dq, dk, dv, sh,
                                s);
  return (int)cudaErrorInvalidValue;
}
