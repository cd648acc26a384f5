"""The ``flash_attention`` wrapper: causal / full attention.

``flash_attention(q, k, v, causal)`` takes q (B, Sq, H, hd) and k/v
(B, Skv, Hkv, hd), the public layout of the reference wrapper, and
returns (B, Sq, H, hd).  On CUDA tensors it launches the Hopper kernel
(``csrc/flash_attention.cu``) on the current stream or raises; on CPU
tensors, and only there, it runs the plain version (``ref.py``).

``launch_count`` counts kernel launches (a plain integer; reset it by
assigning 0), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_plain

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"flash_attention_launch": [_p] * 5 + [_i32] * 8 + [_p]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

# Number of kernel launches in this process.
launch_count = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Hold the inputs to what the kernel takes; raise otherwise."""
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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v are {q.dtype}/{k.dtype}/{v.dtype}; the "
                        f"kernel takes one of {list(DTYPES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v are on different devices")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim axis is not contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd), fp32
    online softmax; causal masking is top-left aligned."""
    global launch_count
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    from repro_torch.kernels import build

    lib = build.load("flash_attention", SOURCE, SYMBOLS)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, Sq, Skv, H, Hkv, hd,
            int(bool(causal)), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launch_count += 1
    return out
