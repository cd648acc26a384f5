"""The ``mamba_scan`` wrapper: the Mamba1 selective scan.

``mamba_scan(u, dt, Bc, Cc, A_log)`` takes u/dt (B, S, din), Bc/Cc
(B, S, N) and A_log (din, N), the layout of the reference wrapper, and
returns (y (B, S, din) in u's type, h_last (B, din, N) fp32): with
A = -exp(A_log), h <- exp(dt A) h + (dt u) B, y = sum_N h C, from
h = 0.  There is no D skip term and no gate; the model adds both.  On
CUDA tensors it launches the Hopper kernel (``csrc/mamba_scan.cu``) on
the current stream or raises; on CPU tensors, and only there, it runs
the plain version (``ref.py``).

A CUDA call raises ``RuntimeError`` when grad is enabled and an input
requires grad (``kernels.refuse_grad``): the kernel has no backward yet
(ROADMAP.md queue 1, item 19), and its output would carry no gradient.

``launch_count`` counts kernel launches (a plain integer; reset it by
assigning 0), so a run can show that its path went through the kernel.
``scan_plan`` (plain Python) gives a launch's shape: threads a channel,
blocks, shared memory and whether the grid is resident in one wave.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"mamba_scan_launch": [_p] * 8 + [_i32] * 6 + [_p]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE, MAX_BATCH = 64, 65535   # N; B is the grid's y extent
# The kernel's block (csrc/mamba_scan.cu): threads, time steps staged a
# pass; the card's SMs (H100 SXM) and shared memory (an SM's whole, and
# the system's share of each block).
THREADS, CHUNK = 128, 64
SMS, SMEM_SM, SMEM_RESERVED = 132, 233_472, 1_024


class ScanPlan(NamedTuple):
    """A launch: threads a channel (``split``), channels a block, the
    grid's blocks, each block's shared memory, the blocks an SM holds at
    once (the smaller of what its shared memory and the register budget
    the kernel is compiled to allow), and whether every block is resident
    at once on the card's SMs."""
    split: int
    channels: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    one_wave: bool


def scan_plan(B: int, S: int, din: int, N: int) -> ScanPlan:
    """The launch of a scan of (B, S, din, N): two threads a channel
    where N > 4 (each runs half its states, so twice the warps are in
    flight for the same exponentials), else one."""
    NP = max(4, 1 << (N - 1).bit_length())
    split = 2 if NP >= 8 else 1
    channels = THREADS // split
    smem = 4 * (2 * CHUNK * channels + 2 * CHUNK * NP)
    blocks = -(-din // channels) * B
    # csrc/mamba_scan.cu's min_blocks: the blocks an SM the register budget
    # promises, by states a thread
    nt = NP // split
    by_regs = 4 if nt <= 16 else 2
    per_sm = min(by_regs, SMEM_SM // (smem + SMEM_RESERVED))
    return ScanPlan(split, channels, blocks, smem, per_sm,
                    blocks <= SMS * per_sm)


# Number of kernel launches in this process.
launch_count = 0


def _check(u, dt, Bc, Cc, A_log) -> None:
    """Hold shapes, dtypes, devices and layout to what the kernel takes."""
    if u.dim() != 3 or dt.dim() != 3 or Bc.dim() != 3 or Cc.dim() != 3 \
            or A_log.dim() != 2:
        raise ValueError("u, dt, Bc and Cc must be 3-d and A_log 2-d")
    B, S, din = u.shape
    N = A_log.shape[1]
    if dt.shape != u.shape or Bc.shape != (B, S, N) or Cc.shape != (B, S, N) \
            or A_log.shape != (din, N):
        raise ValueError(
            f"shapes do not match: u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
            f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, A_log "
            f"{tuple(A_log.shape)}")
    if not (1 <= B <= MAX_BATCH and S >= 1 and din >= 1
            and 1 <= N <= MAX_STATE):
        raise ValueError(f"(B, S, din, N) = {(B, S, din, N)}: each must be "
                         f"at least 1, B at most {MAX_BATCH} and N at most "
                         f"{MAX_STATE}")
    if u.dtype not in DTYPES or Bc.dtype != u.dtype or Cc.dtype != u.dtype:
        raise TypeError(f"u/Bc/Cc are {u.dtype}/{Bc.dtype}/{Cc.dtype}; the "
                        f"kernel takes them in one of {list(DTYPES)}")
    if dt.dtype not in (torch.float32, u.dtype) or A_log.dtype != torch.float32:
        raise TypeError(f"dt is {dt.dtype} (fp32 or u's type) and A_log "
                        f"{A_log.dtype} (fp32)")
    if any(t.device != u.device for t in (dt, Bc, Cc, A_log)):
        raise ValueError("u, dt, Bc, Cc and A_log are on different devices")
    for name, t in (("u", u), ("dt", dt), ("Bc", Bc), ("Cc", Cc)):
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last axis is not contiguous")
    if not A_log.is_contiguous():
        raise ValueError("A_log is not contiguous")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A_log: torch.Tensor):
    """u/dt: (B, S, din); Bc/Cc: (B, S, N); A_log: (din, N) ->
    (y (B, S, din) in u's type, h_last (B, din, N) fp32)."""
    global launch_count
    _check(u, dt, Bc, Cc, A_log)
    if u.device.type == "cpu":
        return mamba_scan_plain(u, dt, Bc, Cc, A_log)
    if u.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {u.device}")
    from repro_torch.kernels import build, refuse_grad

    refuse_grad("mamba_scan", (u, dt, Bc, Cc, A_log),
                "its backward kernel, and with it falcon-mamba training on "
                "the card, is ROADMAP.md queue 1, item 19")

    lib = build.load("mamba_scan", SOURCE, SYMBOLS)
    B, S, din = u.shape
    N = A_log.shape[1]
    y = torch.empty((B, S, din), dtype=u.dtype, device=u.device)
    h_last = torch.empty((B, din, N), dtype=torch.float32, device=u.device)
    strides = (ctypes.c_longlong * 8)(
        *(t.stride(i) for t in (u, dt, Bc, Cc) for i in range(2)))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mamba_scan_launch(
            u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A_log.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, S, din, N,
            DTYPES[u.dtype], DTYPES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launch_count += 1
    return y, h_last
