"""The ``mamba_scan`` wrapper: the Mamba1 selective scan.

``mamba_scan(u, dt, Bc, Cc, A_log)`` takes u/dt (B, S, din), Bc/Cc
(B, S, N) and A_log (din, N), the layout of the reference wrapper, and
returns (y (B, S, din) in u's type, h_last (B, din, N) fp32): with
A = -exp(A_log), h <- exp(dt A) h + (dt u) B, y = sum_N h C, from
h = 0.  There is no D skip term and no gate; the model adds both.  On
CUDA tensors it launches the Hopper kernel (``csrc/mamba_scan.cu``) on
the current stream or raises; on CPU tensors, and only there, it runs
the plain version (``ref.py``).

Training: when grad is enabled and an input requires grad, the call goes
through ``MambaScan``, a ``torch.autograd.Function``.  Its forward
launches the kernel with the state before every ``STATE_CHUNK`` (16)
steps (``states``) and saves the inputs and those states; its backward
launches the hand-written ``csrc/mamba_scan_bwd.cu`` (``mamba_scan_bwd``)
and sums its per-block partials.  On CPU tensors the Function runs the
plain forward with ``chunk_states`` and the plain backward,
``mamba_scan_bwd_plain``.
Otherwise the call is the plain launch, with no states and nothing saved.

The launches are PyTorch operators, ``torch.ops.repro_torch``'s
``mamba_scan``, ``mamba_scan_states`` and ``mamba_scan_bwd``: their
CUDA implementations launch the kernels, and their fake implementations
give the outputs' shapes, so a ``FakeTensorMode`` trace (the dry-run)
runs each as one op on tensors of any device.

``bf16_chunk`` (every entry point; 0, the default, is the function
above) selects the function of the reference's ``mamba_bf16_scan`` flag
at chunks of that many steps: dA and dt u B rounded to bf16 and
combined in bf16 in the order of ``jax.lax.associative_scan``
(``ref.mamba_scan_bf16_plain``).  On CUDA tensors it launches
``csrc/mamba_scan_bf16.cu`` (operators ``mamba_scan_bf16`` and
``mamba_scan_bf16_states``) and, for the gradient, the backward kernel
with its kBf16 flag (``mamba_scan_bf16_bwd``), a straight-through
gradient of the roundings; on CPU tensors their plain versions.

``launch_count`` counts forward launches and ``bwd_launch_count``
backward launches, ``bf16_launch_count`` and ``bf16_bwd_launch_count``
those of the bf16 scan (plain integers; reset them by assigning 0), so a
run can show that its path went through the kernels.  ``scan_plan``,
``bwd_plan`` and ``bf16_plan`` (plain Python) give a launch's shape:
threads a channel, blocks, shared memory, the blocks an SM holds at once
and whether the grid is resident in one wave (the bf16 scan's also its
waves).
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import runs_plain
from repro_torch.kernels.mamba_scan.ref import (
    STATE_CHUNK, mamba_scan_bf16_plain, mamba_scan_bwd_plain,
    mamba_scan_plain,
)
from repro_torch.sharding import dtensor

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")
BF16_SOURCE = SOURCE.with_name("mamba_scan_bf16.cu")
_p, _i32 = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"mamba_scan_launch": [_p] * 9 + [_i32] * 6 + [_p]}
BWD_SYMBOLS = {"mamba_scan_bwd_launch": [_p] * 14 + [_i32] * 6 + [_p],
               "mamba_scan_bwd_bf16_launch": [_p] * 14 + [_i32] * 7 + [_p],
               "mamba_scan_bwd_occupancy": [_i32] * 3 + [_p]}
BF16_SYMBOLS = {"mamba_scan_bf16_launch": [_p] * 9 + [_i32] * 7 + [_p]}
MAX_BF16_CHUNK = 65_536   # csrc/mamba_scan_bf16.cu refuses longer chunks
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE, MAX_BATCH = 64, 65535   # N; B is the grid's y extent
# The kernel's block (csrc/mamba_scan.cu): threads, time steps staged a
# pass; the card's SMs (H100 SXM) and shared memory (an SM's whole, and
# the system's share of each block).  The states the forward saves for
# the backward come every STATE_CHUNK steps (csrc/scan.cuh's kStateEvery).
THREADS, CHUNK = 128, 64
# csrc/mamba_scan_bwd.cu: steps recomputed into shared memory at once
# (kSub), floats a row of its h and g buffers (kPitch), and the blocks an
# SM its register budget promises (kMinBlocks: 128 registers a thread)
SUB, PITCH, BWD_MIN_BLOCKS = 4, THREADS + 4, 4
SMS, SMEM_SM, SMEM_RESERVED = 132, 233_472, 1_024
SMEM_BLOCK = 232_448     # the most shared memory a block may use
# csrc/mamba_scan_bf16.cu: packed pairs of states a thread walks
# (kPairs), steps of a whole group (kGroup) and the levels it keeps in
# registers (kLow), time steps staged at once (kStage), and the blocks an
# SM its register budget promises (kMinBlocks)
BF16_PAIRS, BF16_GROUP, BF16_LOW, BF16_STAGE, BF16_MIN_BLOCKS = 4, 8, 3, 16, 4


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


class BwdPlan(NamedTuple):
    """A backward launch: threads a channel (``split``), channels a
    block, the grid's blocks along the channels (``channel_blocks``, the
    partials' third axis) and in all, each block's shared memory, the
    blocks an SM holds at once (shared memory and the register budget the
    kernel is compiled to allow), and whether every block is resident at
    once on the card's SMs."""
    split: int
    channels: int
    channel_blocks: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    one_wave: bool


def bwd_plan(B: int, S: int, din: int, N: int) -> BwdPlan:
    """The backward launch of a scan of (B, S, din, N): the forward's
    split up to 16 states, NP / 8 threads a channel above, so that a
    thread holds at most 8 states; shared memory as
    csrc/mamba_scan_bwd.cu's ``smem_bytes``: a ring of two stages as copied
    (u, dt and dy of ``SUB`` steps sized for fp32, the B and C rows at
    least 16 bytes wide), dy and dt u in fp32, the first pass's states
    before each sub-chunk but the first, the h and g buffers (``SUB``
    steps x the thread's states x ``PITCH``) and an mbarrier."""
    NP = max(4, 1 << (N - 1).bit_length())
    split = 1 if NP <= 4 else 2 if NP <= 16 else NP // 8
    channels, nt = THREADS // split, NP // split
    smem = (8 * (3 * SUB * channels + 2 * SUB * max(NP, 8))
            + 4 * (2 * SUB * channels
                   + (STATE_CHUNK // SUB - 1) * nt * THREADS
                   + 2 * SUB * nt * PITCH) + 16)
    cb = -(-din // channels)
    per_sm = min(BWD_MIN_BLOCKS, SMEM_SM // (smem + SMEM_RESERVED))
    return BwdPlan(split, channels, cb, cb * B, smem, per_sm,
                   cb * B <= SMS * per_sm)


class Bf16Plan(NamedTuple):
    """A launch of the bf16 scan's forward: threads a channel
    (``split``), the packed pairs of states a thread walks (the rest of
    its ``BF16_PAIRS`` run on zeros), channels a block, the grid's
    blocks, the walk's levels in shared memory, each block's shared
    memory, the blocks an SM holds at once (shared memory and the
    register budget), the waves the grid takes (blocks over the card's
    resident blocks) and whether it is resident in one."""
    split: int
    pairs: int
    channels: int
    blocks: int
    levels: int
    smem_bytes: int
    blocks_per_sm: int
    waves: float
    one_wave: bool


def bf16_plan(B: int, S: int, din: int, N: int, chunk: int) -> Bf16Plan:
    """The bf16 scan's launch at (B, S, din, N) and chunk C, as
    csrc/mamba_scan_bf16.cu makes it: NP = N rounded up to a power of
    two (at least 2); NP / 8 threads a channel where NP >= 16, each
    walking ``BF16_PAIRS`` pairs (8 states), else one, walking the NP / 2
    pairs there are; in shared memory the walk's levels below the top
    one, floor(log2 C) (set once a chunk, never read), but the
    ``BF16_LOW`` a whole group keeps in registers where ``BF16_GROUP``
    divides C, a uint4 a level, pair and thread; (dt, dt u) of
    ``BF16_STAGE`` steps a channel and the B and C rows of split x 8
    floats."""
    NP = max(2, 1 << (N - 1).bit_length())
    split = 1 if NP <= 2 * BF16_PAIRS else NP // 8
    channels = THREADS // split
    levels = max(0, chunk.bit_length() - 1
                 - (BF16_LOW if chunk % BF16_GROUP == 0 else 0))
    smem = (16 * levels * BF16_PAIRS * THREADS + 8 * BF16_STAGE * channels
            + 2 * 4 * BF16_STAGE * split * 2 * BF16_PAIRS)
    blocks = -(-din // channels) * B
    per_sm = min(BF16_MIN_BLOCKS, SMEM_SM // (smem + SMEM_RESERVED))
    return Bf16Plan(split, min(NP // 2, BF16_PAIRS), channels, blocks,
                    levels, smem, per_sm, blocks / (SMS * per_sm),
                    blocks <= SMS * per_sm)


def bwd_occupancy(N: int, dtype: torch.dtype, dt_dtype: torch.dtype) -> int:
    """The backward kernel's blocks an SM for N states, as the CUDA runtime
    counts them on the current card (``bwd_plan``'s ``blocks_per_sm`` is
    the same promise, worked out on the host)."""
    from repro_torch.kernels import build

    lib = build.load("mamba_scan_bwd", BWD_SOURCE, BWD_SYMBOLS)
    out = ctypes.c_int(0)
    err = lib.mamba_scan_bwd_occupancy(N, DTYPES[dtype], DTYPES[dt_dtype],
                                       ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd occupancy failed: CUDA error "
                           f"{err}")
    return out.value


# Number of kernel launches in this process: forward, backward, and the
# bf16 scan's forward and backward.
launch_count = 0
bwd_launch_count = 0
bf16_launch_count = 0
bf16_bwd_launch_count = 0


def _check(u, dt, Bc, Cc, A_log, bf16_chunk: int = 0) -> None:
    """Hold shapes, dtypes, devices and layout to what the kernel takes."""
    dtensor.refuse("mamba_scan", u, dt, Bc, Cc, A_log)
    if not 0 <= bf16_chunk <= MAX_BF16_CHUNK:
        raise ValueError(f"bf16_chunk {bf16_chunk}: 0 (the fp32 scan) or a "
                         f"chunk of 1 to {MAX_BF16_CHUNK} steps")
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


def _strides(*ts):
    return (ctypes.c_longlong * (2 * len(ts)))(
        *(t.stride(i) for t in ts for i in range(2)))


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` (its last axis contiguous) as the backward kernel's TMA copies
    read it: ``t`` itself where its start and its other strides are
    multiples of 16 bytes, else a copy into a zeroed buffer whose rows are
    padded to a multiple of 16 bytes, as a view of the first columns (an
    odd din or N, a B or C view at an odd offset)."""
    es = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * es % 16 == 0
                                      for s in t.stride()[:-1]):
        return t
    x = t.shape[-1]
    out = torch.zeros((*t.shape[:-1], -(-x * es // 16) * 16 // es),
                      dtype=t.dtype, device=t.device)
    out[..., :x] = t
    return out[..., :x]


def bwd_strides(u, dt, Bc, Cc, dy, states):
    """The backward launch's 11 element strides: (batch, time) of u, dt,
    Bc, Cc and dy, and the states' between channels."""
    return (ctypes.c_longlong * 11)(
        *(t.stride(i) for t in (u, dt, Bc, Cc, dy) for i in range(2)),
        states.stride(2))


def _launch(u, dt, Bc, Cc, A_log, states: bool, chunk: int = 0):
    """One forward launch on CUDA tensors -> (y, h_last, the states
    before every ``STATE_CHUNK`` steps (B, ceil(S / STATE_CHUNK), din, N)
    fp32 or None); ``chunk`` > 0: the bf16 scan's kernel at that
    chunk."""
    global launch_count, bf16_launch_count
    from repro_torch.kernels import build

    if chunk:
        lib = build.load("mamba_scan_bf16", BF16_SOURCE, BF16_SYMBOLS)
        entry = lambda *a: lib.mamba_scan_bf16_launch(*a[:13], chunk, *a[13:])
    else:
        lib = build.load("mamba_scan", SOURCE, SYMBOLS)
        entry = lib.mamba_scan_launch
    B, S, din = u.shape
    N = A_log.shape[1]
    y = torch.empty((B, S, din), dtype=u.dtype, device=u.device)
    h_last = torch.empty((B, din, N), dtype=torch.float32, device=u.device)
    st = (torch.empty((B, -(-S // STATE_CHUNK), din, N), dtype=torch.float32,
                      device=u.device) if states else None)
    strides = _strides(u, dt, Bc, Cc)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = entry(
            u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A_log.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            None if st is None else st.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, S, din, N,
            DTYPES[u.dtype], DTYPES[dt.dtype], stream)
    name = "mamba_scan_bf16" if chunk else "mamba_scan"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if chunk:
        bf16_launch_count += 1
    else:
        launch_count += 1
    return y, h_last, st


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(),
                         device_types="cuda")
def _scan_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, A_log: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel, no states: the CUDA implementation launches
    it."""
    return _launch(u, dt, Bc, Cc, A_log, states=False)[:2]


def _scan_outs(u, A_log):
    B, S, din = u.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    return (torch.empty((B, S, din), dtype=u.dtype, device=u.device),
            torch.empty((B, din, A_log.shape[1]), **f32))


@_scan_op.register_fake
def _(u, dt, Bc, Cc, A_log):
    return _scan_outs(u, A_log)


@torch.library.custom_op("repro_torch::mamba_scan_states", mutates_args=(),
                         device_types="cuda")
def _states_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A_log: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel with the states the backward starts from."""
    return _launch(u, dt, Bc, Cc, A_log, states=True)


def _states_outs(u, A_log):
    B, S, din = u.shape
    return _scan_outs(u, A_log) + (torch.empty(
        (B, -(-S // STATE_CHUNK), din, A_log.shape[1]), dtype=torch.float32,
        device=u.device),)


@_states_op.register_fake
def _(u, dt, Bc, Cc, A_log):
    return _states_outs(u, A_log)


@torch.library.custom_op("repro_torch::mamba_scan_bf16", mutates_args=(),
                         device_types="cuda")
def _bf16_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, A_log: torch.Tensor, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 scan's kernel, no states."""
    return _launch(u, dt, Bc, Cc, A_log, False, chunk)[:2]


@_bf16_op.register_fake
def _(u, dt, Bc, Cc, A_log, chunk):
    return _scan_outs(u, A_log)


@torch.library.custom_op("repro_torch::mamba_scan_bf16_states",
                         mutates_args=(), device_types="cuda")
def _bf16_states_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, A_log: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 scan's kernel with the states its backward starts from."""
    return _launch(u, dt, Bc, Cc, A_log, True, chunk)


@_bf16_states_op.register_fake
def _(u, dt, Bc, Cc, A_log, chunk):
    return _states_outs(u, A_log)


def _bwd_launch(u, dt, Bc, Cc, A_log, states, dy, dh_last, chunk: int):
    """One backward launch on CUDA tensors (``chunk`` > 0: the bf16
    scan's gradient at that chunk), its per-block partials summed."""
    global bwd_launch_count, bf16_bwd_launch_count
    from repro_torch.kernels import build

    lib = build.load("mamba_scan_bwd", BWD_SOURCE, BWD_SYMBOLS)
    if chunk:
        entry = lambda *a: lib.mamba_scan_bwd_bf16_launch(*a[:18], chunk,
                                                          *a[18:])
    else:
        entry = lib.mamba_scan_bwd_launch
    B, S, din = u.shape
    N = A_log.shape[1]
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    cb = bwd_plan(B, S, din, N).channel_blocks
    du = torch.empty((B, S, din), dtype=u.dtype, device=u.device)
    ddt = torch.empty((B, S, din), dtype=dt.dtype, device=u.device)
    dBp, dCp = (torch.empty((B, S, cb, N), dtype=torch.float32,
                            device=u.device) for _ in range(2))
    dAp = torch.empty((B, din, N), dtype=torch.float32, device=u.device)
    u, dt, Bc, Cc, dy, states = (tma_ready(t) for t in (
        u, dt, Bc, Cc, dy.contiguous(), states.contiguous()))
    strides = bwd_strides(u, dt, Bc, Cc, dy, states)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = entry(
            u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A_log.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), du.data_ptr(),
            ddt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, S, din, N,
            DTYPES[u.dtype], DTYPES[dt.dtype], stream)
    name = "mamba_scan_bf16_bwd" if chunk else "mamba_scan_bwd"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if chunk:
        bf16_bwd_launch_count += 1
    else:
        bwd_launch_count += 1
    return (du, ddt, dBp.sum(2).to(Bc.dtype), dCp.sum(2).to(Cc.dtype),
            dAp.sum(0))


def _grads_like(u, dt, Bc, Cc, A_log):
    return (torch.empty_like(u), torch.empty_like(dt), torch.empty_like(Bc),
            torch.empty_like(Cc), torch.empty_like(A_log))


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
            Cc: torch.Tensor, A_log: torch.Tensor, states: torch.Tensor,
            dy: torch.Tensor, dh_last: Optional[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """The backward kernel, its per-block partials summed."""
    return _bwd_launch(u, dt, Bc, Cc, A_log, states, dy, dh_last, 0)


@_bwd_op.register_fake
def _(u, dt, Bc, Cc, A_log, states, dy, dh_last):
    return _grads_like(u, dt, Bc, Cc, A_log)


@torch.library.custom_op("repro_torch::mamba_scan_bf16_bwd", mutates_args=(),
                         device_types="cuda")
def _bf16_bwd_op(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, A_log: torch.Tensor, states: torch.Tensor,
                 dy: torch.Tensor, dh_last: Optional[torch.Tensor], chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """The backward kernel under its kBf16 flag: the bf16 scan's
    gradient at ``chunk``."""
    return _bwd_launch(u, dt, Bc, Cc, A_log, states, dy, dh_last, chunk)


@_bf16_bwd_op.register_fake
def _(u, dt, Bc, Cc, A_log, states, dy, dh_last, chunk):
    return _grads_like(u, dt, Bc, Cc, A_log)


def mamba_scan_fwd(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A_log: torch.Tensor,
                   bf16_chunk: int = 0):
    """``mamba_scan`` that also returns the states the backward starts
    from: (y, h_last, states (B, ceil(S / STATE_CHUNK), din, N) fp32, h
    before every ``STATE_CHUNK`` steps).  No autograd graph is
    recorded."""
    _check(u, dt, Bc, Cc, A_log, bf16_chunk)
    if bf16_chunk:
        if runs_plain("mamba_scan_bf16", u):
            return mamba_scan_bf16_plain(u, dt, Bc, Cc, A_log, bf16_chunk,
                                         chunk_states=True)
        return _bf16_states_op(u, dt, Bc, Cc, A_log, bf16_chunk)
    if runs_plain("mamba_scan", u):
        return mamba_scan_plain(u, dt, Bc, Cc, A_log, chunk_states=True)
    return _states_op(u, dt, Bc, Cc, A_log)


def mamba_scan_bwd(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A_log: torch.Tensor,
                   states: torch.Tensor, dy: torch.Tensor,
                   dh_last: torch.Tensor | None = None,
                   bf16_chunk: int = 0):
    """The gradients (du, ddt, dB, dC, dA_log) of ``mamba_scan(u, dt, Bc,
    Cc, A_log, bf16_chunk)`` given its ``states`` (``mamba_scan_fwd``), y's
    gradient ``dy`` and h_last's ``dh_last`` (or None), each in its
    input's type (dA_log fp32).  On CUDA tensors it launches
    ``csrc/mamba_scan_bwd.cu`` and sums its per-block partials, or raises;
    on CPU tensors it runs ``mamba_scan_bwd_plain``."""
    _check(u, dt, Bc, Cc, A_log, bf16_chunk)
    B, S, din = u.shape
    N = A_log.shape[1]
    nst = -(-S // STATE_CHUNK)
    if states.shape != (B, nst, din, N) or states.dtype != torch.float32:
        raise ValueError(f"states must be fp32 {(B, nst, din, N)}, not "
                         f"{states.dtype} {tuple(states.shape)}")
    if dy.shape != u.shape or dy.dtype != u.dtype:
        raise ValueError(f"dy must be u's {u.dtype} {tuple(u.shape)}, not "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if dh_last is not None and (dh_last.shape != (B, din, N)
                                or dh_last.dtype != torch.float32):
        raise ValueError(f"dh_last must be fp32 {(B, din, N)}, not "
                         f"{dh_last.dtype} {tuple(dh_last.shape)}")
    if any(t.device != u.device for t in (states, dy, dh_last)
           if t is not None):
        raise ValueError("states, dy or dh_last is not on u's device")
    if runs_plain("mamba_scan_bwd", u):
        return mamba_scan_bwd_plain(u, dt, Bc, Cc, A_log, states, dy, dh_last,
                                    bf16_chunk)
    if bf16_chunk:
        return _bf16_bwd_op(u, dt, Bc, Cc, A_log, states, dy, dh_last,
                            bf16_chunk)
    return _bwd_op(u, dt, Bc, Cc, A_log, states, dy, dh_last)


class MambaScan(torch.autograd.Function):
    """The scan with its gradient: on CUDA the forward kernel with its
    states and the backward kernel, on the CPU their plain versions
    (``bf16_chunk`` as ``mamba_scan``'s)."""

    @staticmethod
    def forward(ctx, u, dt, Bc, Cc, A_log, bf16_chunk=0):
        y, h_last, states = mamba_scan_fwd(u, dt, Bc, Cc, A_log, bf16_chunk)
        ctx.save_for_backward(u, dt, Bc, Cc, A_log, states)
        ctx.bf16_chunk = bf16_chunk
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, Bc, Cc, A_log, states = ctx.saved_tensors
        if dy is None:   # only h_last reached the loss
            dy = torch.zeros_like(u)
        grads = mamba_scan_bwd(u, dt, Bc, Cc, A_log, states, dy, dh_last,
                               ctx.bf16_chunk)
        return tuple(g if need else None for g, need in
                     zip(grads + (None,), ctx.needs_input_grad))


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A_log: torch.Tensor, bf16_chunk: int = 0):
    """u/dt: (B, S, din); Bc/Cc: (B, S, N); A_log: (din, N) ->
    (y (B, S, din) in u's type, h_last (B, din, N) fp32).  ``bf16_chunk``
    > 0: the bf16 scan at chunks of that many steps (the module's
    docstring).  Differentiable through ``MambaScan`` when grad is enabled
    and an input requires grad."""
    _check(u, dt, Bc, Cc, A_log, bf16_chunk)
    ins = (u, dt, Bc, Cc, A_log)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        # the fp32 scan's Function keeps its five inputs (and gradients)
        return MambaScan.apply(*ins, *((bf16_chunk,) if bf16_chunk else ()))
    if bf16_chunk:
        if runs_plain("mamba_scan_bf16", u):
            return mamba_scan_bf16_plain(*ins, bf16_chunk)
        return _bf16_op(*ins, bf16_chunk)
    if runs_plain("mamba_scan", u):
        return mamba_scan_plain(*ins)
    return _scan_op(*ins)
