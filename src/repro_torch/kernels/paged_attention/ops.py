"""The ``paged_attention`` wrapper: one decode token per sequence over a
paged KV pool.

``paged_attention(q, kpool, vpool, block_tables, lengths)`` takes q
(B, H, d), kpool/vpool (N, bs, Hkv, d) (a per-layer view of the pool),
block_tables (B, nb) int32 and lengths (B,) int32, and returns (B, H, d).
On CUDA tensors it launches the Hopper kernel (``csrc/paged_attention.cu``)
on the current stream or raises; on CPU tensors, and only there, it runs
the plain version (``ref.py``).

``launch_count`` counts the calls that launch the kernel (its split-KV
pass and, where a sequence spans more than one split, the merge); a
plain integer, reset by assigning 0, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_plain

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"paged_attention_launch": [_p] * 10 + [_i32] * 7 + [_p],
           "paged_attention_splits": [_i32, _i32]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM, MAX_GROUP = 128, 16

# Number of kernel launches in this process.
launch_count = 0


def _check(q, kpool, vpool, block_tables, lengths) -> None:
    """Hold shapes, dtypes, devices and layout to what the kernel takes."""
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"q must be (B, H, d) and the pools (N, bs, Hkv, "
                         f"d); got {tuple(q.shape)} and {tuple(kpool.shape)}")
    B, H, d = q.shape
    N, bs, Hkv, dk = kpool.shape
    if vpool.shape != kpool.shape or dk != d:
        raise ValueError(f"kpool {tuple(kpool.shape)} / vpool "
                         f"{tuple(vpool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} "
                         f"KV heads")
    if d > MAX_HEAD_DIM or H // Hkv > MAX_GROUP:
        raise ValueError(f"head_dim {d} (at most {MAX_HEAD_DIM}) or group "
                         f"{H // Hkv} (at most {MAX_GROUP}) out of range")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or lengths.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"lengths {tuple(lengths.shape)} must be (B, nb) "
                         f"and (B,) with B = {B}")
    if q.dtype not in DTYPES or kpool.dtype != q.dtype \
            or vpool.dtype != q.dtype:
        raise TypeError(f"q/kpool/vpool are {q.dtype}/{kpool.dtype}/"
                        f"{vpool.dtype}; the kernel takes one of "
                        f"{list(DTYPES)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if any(t.device != q.device
           for t in (kpool, vpool, block_tables, lengths)):
        raise ValueError("q, the pools, block_tables and lengths are on "
                         "different devices")
    if not (kpool.is_contiguous() and vpool.is_contiguous()):
        raise ValueError("kpool and vpool must be contiguous (a per-layer "
                         "view pool[l] of an (L, N, bs, Hkv, d) pool is)")
    if q.stride(2) != 1 or block_tables.stride(1) != 1 \
            or not lengths.is_contiguous():
        raise ValueError("q's last axis, block_tables' rows and lengths "
                         "must be contiguous")


def check_values(block_tables: torch.Tensor, lengths: torch.Tensor,
                 n_slots: int, block_size: int) -> None:
    """Hold the indices the kernel follows to the pool: every length in
    [1, nb * bs] and every table entry in [0, n_slots).  One host read;
    the model calls it once per decode step, not once per layer."""
    nb = block_tables.shape[1]
    bad = ((lengths < 1) | (lengths > nb * block_size)).any() \
        | ((block_tables < 0) | (block_tables >= n_slots)).any()
    if bool(bad):
        raise ValueError(f"lengths outside [1, {nb * block_size}] or block "
                         f"table entries outside [0, {n_slots})")


def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    validate: bool = True) -> torch.Tensor:
    """q: (B, H, d); kpool/vpool: (N, bs, Hkv, d); block_tables: (B, nb)
    int32; lengths: (B,) int32 -> (B, H, d).  ``validate=False`` skips
    ``check_values`` (the caller has run it for these tables)."""
    global launch_count
    _check(q, kpool, vpool, block_tables, lengths)
    if validate:
        check_values(block_tables, lengths, kpool.shape[0], kpool.shape[1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, kpool, vpool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    from repro_torch.kernels import build

    lib = build.load("paged_attention", SOURCE, SYMBOLS)
    B, H, d = q.shape
    _, bs, Hkv, _ = kpool.shape
    nb = block_tables.shape[1]
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    # fp32 partials of the split-KV pass: (B, Hkv, splits, G, d) and two
    # (B, Hkv, splits, G); one split needs none
    splits = lib.paged_attention_splits(nb, bs)
    n_part = B * H * splits if splits > 1 else 0
    part = torch.empty(n_part * (d + 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(1), *kpool.stride()[:3], *vpool.stride()[:3],
        block_tables.stride(0), out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * n_part * d,
            part.data_ptr() + 4 * n_part * (d + 1),
            ctypes.cast(strides, ctypes.c_void_p), B, H, Hkv, d, bs, nb,
            DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    launch_count += 1
    return out
