"""The selective scan's gradient in the port, on the CPU, against the
reference.

``mamba_scan_bwd_plain`` (the oracle of ``csrc/mamba_scan_bwd.cu`` and
the CPU path of ``ops.MambaScan``) is held to ``jax.vjp`` of the
reference's oracle ``repro.kernels.mamba_scan.ref.mamba_scan_ref``, which
returns y alone: a gradient on the final state enters it as N appended
steps with dt = 0 (the state stays h_last) and C the n-th unit vector,
whose outputs are h_last's columns.  The same numpy inputs go to both
packages.  Tolerances: each of the five gradients within 1e-5 of its
largest magnitude (fp32; the two differ by the order of their sums);
bf16 outputs through ``MambaScan`` at ``chip_smoke.py``'s limit
(``scan_grad_limit_use``: 1e-4 of the largest magnitude plus half a bf16
step of each element).  ``chip_smoke.py``'s check of the kernel, run
here on the plain version, fails each planted fault by 10x or more, and
its bf16 gradient gate (``ssm_grad_check``) holds a reduced bf16
falcon-mamba within 5 % of fp32 and fails a planted scan fault.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.kernels.mamba_scan.ref import (
    STATE_CHUNK, mamba_scan_bwd_plain, mamba_scan_plain,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _inputs(B, S, din, N, seed):
    """u, dt (|randn| 0.1), B, C, A_log (randn 0.5) as tests/test_kernels.py
    makes them, dy and dh_last: float32 numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return (r(B, S, din), np.abs(r(B, S, din)) * 0.1, r(B, S, N), r(B, S, N),
            r(din, N) * 0.5, r(B, S, din), r(B, din, N))


def _jax_grads(u, dt, Bc, Cc, A_log, dy, dh_last=None):
    """``jax.vjp`` of ``mamba_scan_ref`` -> (du, ddt, dB, dC, dA_log).
    With ``dh_last``, N steps follow the sequence with dt = u = B = 0 and
    C = e_n, so their y is h_last[..., n] and their dy dh_last[..., n]."""
    B, S, din = u.shape
    N = A_log.shape[1]
    if dh_last is not None:
        z = lambda *s: np.zeros(s, np.float32)
        eye = np.broadcast_to(np.eye(N, dtype=np.float32), (B, N, N))
        u, dt = np.concatenate([u, z(B, N, din)], 1), \
            np.concatenate([dt, z(B, N, din)], 1)
        Bc, Cc = np.concatenate([Bc, z(B, N, N)], 1), \
            np.concatenate([Cc, eye], 1)
        dy = np.concatenate([dy, dh_last.transpose(0, 2, 1)], 1)
    _, vjp = jax.vjp(mamba_scan_ref,
                     *(jnp.asarray(a) for a in (u, dt, Bc, Cc, A_log)))
    du, ddt, dB, dC, dA = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    return du[:, :S], ddt[:, :S], dB[:, :S], dC[:, :S], dA


def _close(got, want, tol=GRAD_TOL):
    """Each gradient within ``tol`` of its largest magnitude."""
    for name, g, w in zip(CS.SCAN_GRADS, got, want):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (name, err)


# B, S, din, N, dh_last given: N 1, 4, 16 and 64, S 1, 65, 100 and 300
CASES = [(2, 100, 32, 16, False), (2, 100, 32, 16, True),
         (1, 65, 48, 64, False), (1, 65, 40, 64, True),
         (2, 1, 16, 4, False), (1, 1, 8, 1, True), (1, 100, 24, 1, False),
         (2, 65, 64, 4, True), (1, 300, 64, 4, False),
         (1, 130, 128, 16, True)]


@pytest.mark.parametrize("B,S,din,N,with_dh", CASES)
def test_plain_backward_equals_jax_vjp(B, S, din, N, with_dh):
    u, dt, Bc, Cc, Al, dy, dh = _inputs(B, S, din, N, seed=S + N)
    dh = dh if with_dh else None
    t = torch.from_numpy
    _, _, states = mamba_scan_plain(t(u), t(dt), t(Bc), t(Cc), t(Al),
                                    chunk_states=True)
    got = mamba_scan_bwd_plain(t(u), t(dt), t(Bc), t(Cc), t(Al), states,
                               t(dy), None if dh is None else t(dh))
    _close(got, _jax_grads(u, dt, Bc, Cc, Al, dy, dh))


@pytest.mark.parametrize("B,S,din,N,with_dh", [
    (2, 100, 32, 16, True), (1, 65, 40, 64, False), (1, 1, 8, 1, True),
    (2, 130, 24, 4, False)])
def test_mamba_scan_grad_through_the_function_fp32(B, S, din, N, with_dh):
    """``mamba_scan`` on CPU tensors that require grad goes through
    ``MambaScan`` (its saved states, its backward) to the reference's
    gradient, y's and h_last's gradients both given (or y's alone)."""
    u, dt, Bc, Cc, Al, dy, dh = _inputs(B, S, din, N, seed=S)
    ins = [torch.from_numpy(a).requires_grad_() for a in (u, dt, Bc, Cc, Al)]
    y, h = sops.mamba_scan(*ins)
    assert type(y.grad_fn).__name__ == "MambaScanBackward"
    outs, grads = ((y, h), (torch.from_numpy(dy), torch.from_numpy(dh))) \
        if with_dh else ((y,), (torch.from_numpy(dy),))
    got = torch.autograd.grad(outs, ins, grads)
    _close(got, _jax_grads(u, dt, Bc, Cc, Al, dy, dh if with_dh else None))


@pytest.mark.parametrize("dt_bf16", [False, True])
def test_mamba_scan_grad_through_the_function_bf16(dt_bf16):
    """bf16 u, B, C and dy (dt fp32 or bf16): the gradients come back in
    the inputs' types, each within ``chip_smoke.py``'s bf16 limit of the
    reference's on fp32 copies of the same values."""
    B, S, din, N = 2, 100, 48, 16
    u, dt, Bc, Cc, Al, dy, dh = _inputs(B, S, din, N, seed=7)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    ins = [bf(u), bf(dt) if dt_bf16 else torch.from_numpy(dt), bf(Bc),
           bf(Cc), torch.from_numpy(Al)]
    ins = [x.requires_grad_() for x in ins]
    dy_t = bf(dy)
    y, h = sops.mamba_scan(*ins)
    got = torch.autograd.grad((y, h), ins, (dy_t, torch.from_numpy(dh)))
    assert [g.dtype for g in got] == [x.dtype for x in ins]
    f = lambda x: x.detach().float().numpy()
    want = _jax_grads(*(f(x) for x in ins), f(dy_t), dh)
    use = CS.scan_grad_limit_use(got, [torch.tensor(w) for w in want])
    assert max(use.values()) <= 1.0, use


def _prefix_state(ins, t):
    """The plain recurrence's final state after the first ``t`` steps."""
    u, dt, Bc, Cc, Al = ins
    return mamba_scan_plain(u[:, :t], dt[:, :t], Bc[:, :t], Cc[:, :t], Al)[1]


def test_chunk_states_are_the_recurrence_every_state_chunk_steps():
    """``chunk_states``' chunk c is the plain recurrence's state after
    ``STATE_CHUNK`` (16) c steps: the final state of the scan of that
    prefix (zeros at 0)."""
    assert STATE_CHUNK == 16 == sops.STATE_CHUNK
    ins = [torch.from_numpy(a) for a in _inputs(2, 200, 16, 4, seed=3)[:5]]
    y, h, states = mamba_scan_plain(*ins, chunk_states=True)
    assert states.shape == (2, 13, 16, 4) and states.dtype == torch.float32
    assert not states[:, 0].any()
    for c in range(1, 13):
        assert torch.equal(states[:, c], _prefix_state(ins, c * STATE_CHUNK))
    y2, h2 = mamba_scan_plain(*ins)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_chunk_states_are_the_recurrence_every_64_steps():
    """At the forward kernel's staged chunks of 64 steps (every fourth
    saved state) ``chunk_states`` holds the recurrence's state after 64 c
    steps, a ragged last chunk included."""
    ins = [torch.from_numpy(a) for a in _inputs(1, 150, 8, 16, seed=4)[:5]]
    _, _, states = mamba_scan_plain(*ins, chunk_states=True)
    assert states.shape[1] == 10 and 64 // STATE_CHUNK == 4
    for c in (1, 2):
        assert torch.equal(states[:, 4 * c], _prefix_state(ins, 64 * c))


def test_no_grad_call_saves_nothing():
    """Without grad the call is the plain version's, with no graph."""
    ins = [torch.from_numpy(a) for a in _inputs(1, 10, 8, 4, seed=0)[:5]]
    y, h = sops.mamba_scan(*ins)
    assert y.grad_fn is None
    with torch.no_grad():
        y2, _ = sops.mamba_scan(*(x.requires_grad_() for x in ins))
    assert y2.grad_fn is None and torch.equal(y, y2)


# chip_smoke.py's cases cut to the CPU: a bf16 training-like case with B/C
# strided views, the edges, dt in u's type, a final-state gradient
CHECK_CASES = [(2, 130, 96, 16, "bfloat16", "float32", 8, False),
               (1, 1, 64, 16, "float32", "float32", 0, False),
               (1, 65, 100, 4, "float32", "float32", 0, False),
               (2, 70, 40, 64, "float32", "float32", 0, False),
               (1, 64, 64, 1, "float32", "float32", 0, False),
               (2, 70, 96, 8, "bfloat16", "bfloat16", 0, False),
               (2, 100, 70, 16, "bfloat16", "float32", 0, True),
               (2, 17, 72, 16, "bfloat16", "float32", 0, False),
               (1, 22, 100, 8, "bfloat16", "bfloat16", 0, True),
               (1, 37, 40, 32, "float32", "float32", 0, False)]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_scan_bwd_check_passes_plain_and_fails_every_fault(case):
    """``chip_smoke.scan_bwd_case`` on the CPU, where the "kernel" is the
    plain version: its gradients within the limit, the states exact, and
    every planted fault that changes the gradients (the carry's cannot
    at S = 1) at ``FAULT_MARGIN`` x the limit or more."""
    with torch.no_grad():
        rec = CS.scan_bwd_case("cpu", case, np.random.default_rng(0))
    assert rec["max_limit_use"] <= 1.0
    assert rec["states_max_abs_err"] == 0.0 and rec["fwd_states_bit_equal"]
    assert rec["bit_equal_calls"]
    faults = rec["fault_limit_use"]
    assert set(faults) == set(CS.SCAN_FAULTS)
    assert (faults["no_carry_decay"] is None) == (case[1] == 1)
    assert min(v for v in faults.values() if v is not None) \
        >= CS.FAULT_MARGIN


def test_grad_limit_allows_half_a_bf16_step():
    """The bf16 allowance is half a step of each element: at 1.0 that is
    2^-8, at 1.5 also 2^-8, at 2^-20 2^-28, at 0 nothing."""
    w = torch.tensor([1.0, 1.5, 2.0 ** -20, 0.0, -3.0])
    assert CS.bf16_half_step(w).tolist() == [2.0 ** -8, 2.0 ** -8,
                                             2.0 ** -28, 0.0, 2.0 ** -7]
    r = torch.bfloat16
    # every fp32 value rounds to bf16 within the allowance
    x = torch.linspace(-4, 4, 10_001)
    assert bool(((x.to(r).float() - x).abs()
                 <= CS.bf16_half_step(x)).all())


def test_bwd_plan_at_falcon_mamba_training_shape():
    """(4, 4096, 8192, 16): the forward's split, 64 channels a block, 128
    channel blocks (the partials' third axis), 512 blocks of 54 KB (a ring
    of two 4-step stages as copied, dy and dt u, 3 ckpt slots, the h and g
    buffers, the mbarrier), four an SM: one resident wave on 132 SMs."""
    p = sops.bwd_plan(4, 4096, 8192, 16)
    assert (p.split, p.channels, p.channel_blocks, p.blocks) == (2, 64, 128,
                                                                 512)
    assert (sops.SUB, sops.STATE_CHUNK, sops.PITCH) == (4, 16, 132)
    assert p.smem_bytes == (8 * (3 * 4 * 64 + 2 * 4 * 16)
                            + 4 * (2 * 4 * 64 + 3 * 8 * 128 + 2 * 4 * 8 * 132)
                            + 16) == 55_312
    assert p.blocks_per_sm == 4 and p.one_wave
    assert p.blocks <= sops.SMS * p.blocks_per_sm
    assert p.blocks_per_sm * (p.smem_bytes + sops.SMEM_RESERVED) \
        <= sops.SMEM_SM


@pytest.mark.parametrize("N,split,channels", [(1, 1, 128), (4, 1, 128),
                                              (5, 2, 64), (16, 2, 64),
                                              (17, 4, 32), (64, 8, 16)])
def test_bwd_plan_keeps_8_states_a_thread_at_most(N, split, channels):
    """Every state count keeps 4 blocks an SM (the register budget's
    promise), its shared memory within an SM's share."""
    p = sops.bwd_plan(2, 100, 300, N)
    assert (p.split, p.channels) == (split, channels)
    assert p.channel_blocks == -(-300 // channels)
    assert p.blocks_per_sm == sops.BWD_MIN_BLOCKS == 4 and p.one_wave
    assert 4 * (p.smem_bytes + sops.SMEM_RESERVED) <= sops.SMEM_SM


@pytest.mark.parametrize("B,din,one_wave", [(1, 8192, True),
                                             (4, 8192, True),
                                             (5, 8192, False),
                                             (4, 8448, True),
                                             (4, 8449, False)])
def test_bwd_plan_one_wave_up_to_four_blocks_an_sm(B, din, one_wave):
    """``one_wave`` holds while the grid fits 4 blocks on each of the 132
    SMs (528): falcon-mamba's 128 channel blocks a sequence fit 4
    sequences, not 5; 132 channel blocks fit 4, 133 (the last partial)
    do not."""
    p = sops.bwd_plan(B, 4096, din, 16)
    assert p.blocks == B * -(-din // 64)
    assert p.one_wave == one_wave == (p.blocks <= 528)


@pytest.mark.parametrize("shape,cut,ok", [
    ((2, 5, 16), None, True),       # 32-byte rows, aligned
    ((2, 5, 7), None, False),       # 28-byte rows
    ((2, 5, 40), (8, 24), True),    # an aligned view at 32 bytes
    ((2, 5, 40), (1, 17), False)])  # a view at 4 bytes
def test_tma_ready_pads_only_what_tma_cannot_read(shape, cut, ok):
    """``ops.tma_ready`` returns a tensor TMA can read (start and outer
    strides multiples of 16 bytes) with the same values: the tensor itself
    where it already is one, else a zero-padded copy."""
    t = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    if cut is not None:
        t = t[..., cut[0]:cut[1]]
    r = sops.tma_ready(t)
    assert (r is t) == ok and torch.equal(r, t)
    assert r.data_ptr() % 16 == 0 and r.stride(-1) == 1
    assert all(s * 4 % 16 == 0 for s in r.stride()[:-1])


@pytest.mark.parametrize("bad", ["states_shape", "states_dtype", "dy_dtype",
                                 "dh_shape"])
def test_bwd_wrapper_rejects(bad):
    u, dt, Bc, Cc, Al, dy, dh = (torch.from_numpy(a)
                                 for a in _inputs(1, 70, 8, 4, seed=0))
    states = torch.zeros((1, -(-70 // STATE_CHUNK), 8, 4))
    if bad == "states_shape":
        states = states[:, :1]
    elif bad == "states_dtype":
        states = states.double()
    elif bad == "dy_dtype":
        dy = dy.bfloat16()
    else:
        dh = dh[:, :4]
    with pytest.raises(ValueError):
        sops.mamba_scan_bwd(u, dt, Bc, Cc, Al, states, dy, dh)


@pytest.mark.parametrize("seq", [64, 128])
def test_ssm_bf16_grad_check_passes_clean_and_fails_the_planted_fault(seq):
    """``chip_smoke.ssm_grad_check`` (the gate of ``ssm_bf16_grad``) on a
    reduced falcon-mamba in bf16, on the CPU with the plain scan: every
    gradient leaf within ``BF16_GRAD_TOL`` of fp32, and the scan's
    backward without the carry's decay, swapped in for one loss, beyond
    it; the swap is undone."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.config import ShapeCell

    c16 = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              dtype="bfloat16", param_dtype="bfloat16")
    batch = make_batch(c16, ShapeCell("t", seq, 2, "train"), seed=6,
                       device="cpu")
    backward = sops.MambaScan.__dict__["backward"]
    l16, l32, _, rel, fault = CS.ssm_grad_check("cpu", c16, batch)
    assert sops.MambaScan.__dict__["backward"] is backward
    assert abs(l16 - l32) < 0.01 * abs(l32)
    assert max(rel.values()) <= CS.BF16_GRAD_TOL
    assert max(fault.values()) > 10 * CS.BF16_GRAD_TOL
