"""The ``flash_attention`` wrapper: causal / full attention.

``flash_attention(q, k, v, causal)`` takes q (B, Sq, H, hd) and k/v
(B, Skv, Hkv, hd), the public layout of the reference wrapper, and
returns (B, Sq, H, hd).  On CUDA tensors it launches a Hopper kernel of
``csrc/flash_attention.cu`` on the current stream or raises; on CPU
tensors, and only there, it runs the plain version (``ref.py``).

Which kernel runs is fixed by the input type, not by whether a launch
succeeds.  ``route`` is the one place that choice is made; its result
is what the C entry point is told to launch:

* bfloat16 -> ``"wgmma"``: the tensor-core kernel, its tiles loaded by
  TMA.  TMA needs each of q, k, v (and so their views) to start on a
  16-byte boundary with batch, sequence and head strides that are
  multiples of 16 bytes (``tma_compatible``); a bf16 call whose inputs
  fail that raises, it does not fall back.
* float32 -> ``"cuda_cores"``: the fp32 kernel on the CUDA cores, which
  holds the fp32 checks' 2e-5 (TF32 tensor cores would not).

Training: when grad is enabled and any input requires grad, a CUDA call
goes through ``FlashAttention``, a ``torch.autograd.Function``: its
forward launches the kernel with the per-row log-sum-exp (``lse``) and
saves q, k, v, the output and lse; its backward launches the
hand-written ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``).
Otherwise the call is the plain launch with no lse and nothing saved.
On the CPU the plain version is differentiated by torch itself.

The backward is routed by type too (``bwd_route``, ``BWD_ROUTES``):
bf16 -> ``"wgmma"``, the tensor-core kernels, which need q, k, v, o and
dO TMA-loadable after they are made contiguous and raise otherwise;
fp32 -> ``"cuda_cores"``.  The bf16 kernels round P and dS to bf16
before their products; ``flash_attention_bwd``'s CPU path, the plain
version, rounds where they do (``BWD_ROUNDING``).

The launches are PyTorch operators, ``torch.ops.repro_torch``'s
``flash_attention``, ``flash_attention_lse`` and ``flash_attention_bwd``:
their CUDA implementations launch the kernels, and their fake
implementations give the outputs' shapes, so a ``FakeTensorMode`` trace
(the dry-run) runs each as one op on tensors of any device.

``launch_count`` counts forward launches and ``bwd_launch_count``
backward launches (plain integers; reset them by assigning 0), so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import runs_plain
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.sharding import dtensor

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"flash_attention_launch": [_p] * 6 + [_i32] * 8 + [_p]}
BWD_SYMBOLS = {"flash_attention_bwd_launch": [_p] * 10 + [_i32] * 8 + [_p]}
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
BWD_ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
KERNELS = {"cuda_cores": 0, "wgmma": 1}   # csrc: both entries' `kernel`
# the type the backward rounds P and dS to before their products, by input
# type (None: no rounding); the plain version is told the same
BWD_ROUNDING = {torch.float32: None, torch.bfloat16: torch.bfloat16}
MAX_HEAD_DIM = 128
TMA_ALIGN = 16    # bytes: TMA's base-address and stride granule

# Number of kernel launches in this process: forward, backward.
launch_count = 0
bwd_launch_count = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Hold the inputs to what the kernel takes; raise otherwise."""
    dtensor.refuse("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d (B, S, heads, head_dim)")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} "
                         f"KV heads")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v are {q.dtype}/{k.dtype}/{v.dtype}; the "
                        f"kernel takes one of {list(ROUTES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v are on different devices")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim axis is not contiguous")


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call with inputs of ``dtype`` launches."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention takes one of {list(ROUTES)}, not "
                        f"{dtype}")
    return ROUTES[dtype]


def bwd_route(dtype: torch.dtype) -> str:
    """The backward kernels a CUDA call with inputs of ``dtype`` launches."""
    if dtype not in BWD_ROUTES:
        raise TypeError(f"flash_attention_bwd takes one of "
                        f"{list(BWD_ROUTES)}, not {dtype}")
    return BWD_ROUTES[dtype]


def kernel_strides(t: torch.Tensor) -> tuple:
    """Element strides of (batch, sequence, head) of a (B, S, heads, hd)
    tensor as the kernel gets them: an axis of size 1 is never stepped
    along, so it takes the stride a contiguous tensor would have."""
    B, S, heads, hd = t.shape
    dense = (S * heads * hd, heads * hd, hd)
    return tuple(t.stride(i) if t.shape[i] > 1 else dense[i]
                 for i in range(3))


def tma_compatible(t: torch.Tensor) -> bool:
    """Whether TMA can load (B, S, heads, hd) tensor ``t``: head_dim
    contiguous, a 16-byte aligned start and (batch, sequence, head)
    strides that are whole multiples of 16 bytes."""
    es = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % TMA_ALIGN == 0 and
            all(s * es % TMA_ALIGN == 0 for s in kernel_strides(t)))


def check_tma(*tensors: torch.Tensor) -> None:
    """Raise unless TMA can load each of the tensors, named q, k, v, o
    and do in that order (``tma_compatible``); a caller whose views fail
    makes them contiguous first."""
    for name, t in zip(("q", "k", "v", "o", "do"), tensors):
        if not tma_compatible(t):
            raise ValueError(
                f"{name} (strides {t.stride()}) is not TMA-loadable: bf16 "
                f"attention needs a {TMA_ALIGN}-byte aligned start and "
                f"strides that are multiples of {TMA_ALIGN} bytes")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, lse: bool):
    """One forward launch on CUDA tensors -> (out, lse (B, H, Sq) fp32 or
    None)."""
    global launch_count
    from repro_torch.kernels import build

    kernel = route(q.dtype)
    if kernel == "wgmma":
        check_tma(q, k, v)
    lib = build.load("flash_attention", SOURCE, SYMBOLS)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse_t = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
             if lse else None)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in kernel_strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, Sq, Skv, H, Hkv, hd,
            int(bool(causal)), KERNELS[kernel], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launch_count += 1
    return out, lse_t


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """The forward kernel, no lse: the CUDA implementation launches it."""
    return _launch(q, k, v, causal, lse=False)[0]


@_fwd_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cuda")
def _fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with each row's lse."""
    return _launch(q, k, v, causal, lse=True)


@_fwd_lse_op.register_fake
def _(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels of ``bwd_route``, every input made contiguous
    first."""
    global bwd_launch_count
    from repro_torch.kernels import build

    kernel = bwd_route(q.dtype)
    lib = build.load("flash_attention_bwd", BWD_SOURCE, BWD_SYMBOLS)
    q, k, v, lse = (t.contiguous() for t in (q, k, v, lse))
    o, do = o.to(q.dtype).contiguous(), do.to(q.dtype).contiguous()
    if kernel == "wgmma":
        check_tma(q, k, v, o, do)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, Hkv, hd,
            int(bool(causal)), KERNELS[kernel], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    bwd_launch_count += 1
    return dq, dk, dv


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """``flash_attention`` that also returns each row's natural-log
    log-sum-exp of its scaled, masked scores: (out (B, Sq, H, hd), lse
    (B, H, Sq) fp32).  No autograd graph is recorded on CUDA."""
    _check(q, k, v)
    if runs_plain("flash_attention", q):
        return (flash_attention_plain(q, k, v, causal),
                flash_attention_lse_plain(q, k, v, causal))
    return _fwd_lse_op(q, k, v, bool(causal))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal)``
    given its output ``o``, its ``lse`` (``flash_attention_fwd``) and the
    output's gradient ``do``, in the inputs' dtype.  On CUDA tensors it
    launches ``csrc/flash_attention_bwd.cu``'s kernels of ``bwd_route``
    (every tensor made contiguous first) or raises; on CPU tensors it
    runs the plain version, with P and dS rounded as those kernels round
    them (``BWD_ROUNDING``)."""
    _check(q, k, v)
    bwd_route(q.dtype)
    B, Sq, H, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must "
                         f"be q's {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, Sq)}, not {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if runs_plain("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         round_to=BWD_ROUNDING[q.dtype])
    return _bwd_op(q, k, v, o, lse, do, bool(causal))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel with lse,
    the backward kernel.  CUDA tensors, or shape-only ones (the CPU path
    is the plain version, which autograd differentiates itself)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _fwd_lse_op(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd), fp32
    online softmax; causal masking is top-left aligned.  Differentiable:
    on CUDA through ``FlashAttention`` when grad is enabled and an input
    requires grad."""
    _check(q, k, v)
    if runs_plain("flash_attention", q):
        return flash_attention_plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal))
    return _fwd_op(q, k, v, bool(causal))
