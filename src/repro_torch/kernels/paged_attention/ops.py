"""The ``paged_attention`` wrapper: one decode token per sequence over a
paged KV pool.

``paged_attention(q, kpool, vpool, block_tables, lengths)`` takes q
(B, H, d), kpool/vpool (N, bs, Hkv, d) (a per-layer view of the pool),
block_tables (B, nb) int32 and lengths (B,) int32, and returns (B, H, d).
On CUDA tensors it launches the Hopper kernel (``csrc/paged_attention.cu``)
on the current stream or raises; on CPU tensors, and only there, it runs
the plain version (``ref.py``).

The arithmetic follows the input type, by rule and not by whether a
launch succeeds: bfloat16 computes on the tensor cores (``mma.sync``;
the softmax weights enter P V as two bf16 parts, so they keep about
fp32's precision), float32 on the CUDA cores (its fp32 products hold
the 2e-5 checks).  Both load K/V with 16-byte ``cp.async`` copies, so
the pools must start on 16-byte boundaries, and head_dim must be a
multiple of 8.

The kernel splits each sequence's positions over ``n_splits`` blocks
per KV head and merges the splits in the same launch.  ``plan_splits``
chooses ``n_splits`` from the batch, the KV heads and the table's
capacity (nothing here reads the device's lengths), and
``split_range`` is the cut the kernel makes of one sequence; both are
plain functions, so the CPU tests reach them.  The partials' scratch
and the merge's arrival counters are allocated once per shape, device
and stream and reused by every call of that stream (the counters are
left zero by each launch); calls on two streams never share them.

A CUDA call raises ``RuntimeError`` when grad is enabled and an input
requires grad (``kernels.refuse_grad``): the kernel serves decode and
has no backward, and its output would carry no gradient.

``paged_attention_lse`` also returns each (sequence, head)'s
log-sum-exp (B, H) fp32, written by the same launch.  The launches are
PyTorch operators, ``torch.ops.repro_torch``'s ``paged_attention`` and
``paged_attention_lse``: their CUDA implementations launch the kernel,
and their fake implementations give the outputs' shapes, so a
``FakeTensorMode`` trace (the dry-run) runs each as one op on tensors
of any device.

``launch_count`` counts kernel launches (one a call); a plain integer,
reset by assigning 0, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Dict, Tuple

import torch

from repro_torch.kernels import runs_plain
from repro_torch.kernels.paged_attention.ref import paged_attention_plain
from repro_torch.sharding import dtensor

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"paged_attention_launch": [_p] * 10 + [_i32] * 7 + [_p]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM, MAX_GROUP = 128, 16
CHUNK = 16        # positions a ring stage holds (csrc: kChunk)
SMS = 132         # H100 SXM streaming multiprocessors
WAVES = 2         # blocks an SM holds at once (bf16: 102 KB of rings each)
ALIGN = 16        # bytes: cp.async's granule; pool rows start on it

# (device, stream, B, Hkv, n_splits, G, d) -> (fp32 partials, int32 counters)
_scratch: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

# Number of kernel launches in this process.
launch_count = 0


def _check(q, kpool, vpool, block_tables, lengths) -> None:
    """Hold shapes, dtypes, devices and layout to what the kernel takes."""
    dtensor.refuse("paged_attention", q, kpool, vpool, block_tables, lengths)
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
    if d > MAX_HEAD_DIM or d % 8 or H // Hkv > MAX_GROUP:
        raise ValueError(f"head_dim {d} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}) or group {H // Hkv} (at most "
                         f"{MAX_GROUP}) out of range")
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


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def plan_splits(B: int, Hkv: int, max_len: int, sms: int = SMS) -> int:
    """Splits per (sequence, KV head): as many as keep the grid of
    ``n_splits x Hkv x B`` blocks within ``WAVES`` blocks on each of
    ``sms`` SMs (the blocks the bf16 kernel's shared memory lets an SM
    hold at once, so the grid runs as one wave), at least one, and no
    more than a ``max_len``-position sequence has chunks (so a sequence
    of that length leaves no split empty)."""
    want = WAVES * sms // (B * Hkv)
    return max(1, min(want, -(-max_len // CHUNK)))


def split_range(split: int, length: int, n_splits: int) -> Tuple[int, int]:
    """Positions [lo, hi) of ``split`` when a sequence of ``length``
    positions is cut into chunks of ``CHUNK`` and its chunks are dealt
    out evenly over ``n_splits`` splits: the kernel's cut."""
    n_chunks = -(-length // CHUNK)
    lo = split * n_chunks // n_splits
    hi = (split + 1) * n_chunks // n_splits
    return lo * CHUNK, min(hi * CHUNK, length)


def _scratch_for(device, stream: int, B: int, Hkv: int, n_splits: int,
                 G: int, d: int):
    """The partials and counters of calls of this shape on ``stream`` (a
    ``cudaStream_t`` handle): made at the first such call, then reused."""
    key = (device, stream, B, Hkv, n_splits, G, d)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty(B * Hkv * n_splits * G * (d + 2), dtype=torch.float32,
                        device=device),
            torch.zeros(B * Hkv, dtype=torch.int32, device=device))
    return _scratch[key]


def _launch(q, kpool, vpool, block_tables, lengths, lse: bool):
    """One launch on CUDA tensors -> (out, lse (B, H) fp32 or None)."""
    global launch_count
    from repro_torch.kernels import build

    if kpool.data_ptr() % ALIGN or vpool.data_ptr() % ALIGN:
        raise ValueError(f"kpool and vpool must start on {ALIGN}-byte "
                         f"boundaries (16-byte cp.async copies)")
    lib = build.load("paged_attention", SOURCE, SYMBOLS)
    B, H, d = q.shape
    _, bs, Hkv, _ = kpool.shape
    n_splits = plan_splits(B, Hkv, block_tables.shape[1] * bs,
                           sms=_sm_count(q.device))
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, H), dtype=torch.float32, device=q.device)
             if lse else None)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(1), *kpool.stride()[:3], *vpool.stride()[:3],
        block_tables.stride(0), out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, counters = _scratch_for(q.device, stream, B, Hkv, n_splits,
                                      H // Hkv, d)
        err = lib.paged_attention_launch(
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(),
            part.data_ptr(), counters.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, H, Hkv, d, bs,
            n_splits, DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    launch_count += 1
    return out, lse_t


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=(),
                         device_types="cuda")
def _op(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
        block_tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The kernel, no lse: the CUDA implementation launches it."""
    return _launch(q, kpool, vpool, block_tables, lengths, lse=False)[0]


@_op.register_fake
def _(q, kpool, vpool, block_tables, lengths):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@torch.library.custom_op("repro_torch::paged_attention_lse", mutates_args=(),
                         device_types="cuda")
def _lse_op(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
            block_tables: torch.Tensor, lengths: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel with each (sequence, head)'s lse."""
    return _launch(q, kpool, vpool, block_tables, lengths, lse=True)


@_lse_op.register_fake
def _(q, kpool, vpool, block_tables, lengths):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


def _run(q, kpool, vpool, block_tables, lengths, validate: bool, lse: bool):
    _check(q, kpool, vpool, block_tables, lengths)
    if validate:
        check_values(block_tables, lengths, kpool.shape[0], kpool.shape[1])
    args = (q, kpool, vpool, block_tables, lengths)
    if runs_plain("paged_attention", q):
        return paged_attention_plain(*args, return_lse=lse)
    from repro_torch.kernels import refuse_grad

    refuse_grad("paged_attention", (q, kpool, vpool),
                "it serves decode, and training attends with "
                "flash_attention")
    return _lse_op(*args) if lse else _op(*args)


def paged_attention(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    validate: bool = True) -> torch.Tensor:
    """q: (B, H, d); kpool/vpool: (N, bs, Hkv, d); block_tables: (B, nb)
    int32; lengths: (B,) int32 -> (B, H, d).  ``validate=False`` skips
    ``check_values`` (the caller has run it for these tables)."""
    return _run(q, kpool, vpool, block_tables, lengths, validate, lse=False)


def paged_attention_lse(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *, validate: bool = True):
    """``paged_attention`` that also returns each (sequence, head)'s
    natural-log log-sum-exp of its scaled scores over its ``lengths[b]``
    positions: (out (B, H, d), lse (B, H) fp32), so that outputs over
    disjoint parts of a sequence merge exactly (the sharded decode)."""
    return _run(q, kpool, vpool, block_tables, lengths, validate, lse=True)
