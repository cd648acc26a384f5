"""Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2 hybrid) blocks.

The port of ``repro.models.mamba``, with the same signatures and param
layouts.  Mamba1's selective scan is the ``mamba_scan`` kernel (its
plain version on CPU tensors), which also returns the final state that
decode starts from; the D skip, the gate and the projections stay torch
glue, as in the reference.  Training differentiates ``mamba1_full``
through the scan wrapper's autograd Function: its backward is the
``mamba_scan_bwd`` kernel, where the reference lets XLA differentiate
its chunked associative scan.  Mamba2's chunked SSD form is plain torch
einsums, as the reference computes it outside any Pallas kernel.  Decode
is the O(1) recurrence in plain torch for both.

Params: blocks are stacked on a leading layer axis by the caller
(``init_params`` of ``models/model.py`` and ``models/hybrid.py``); the
functions here take one layer's params.  As in the reference, Mamba1's
``A_log`` and Mamba2's ``A_log`` and ``dt_bias`` are fp32 whatever the
parameter dtype (``FP32_LEAVES``).

The opt flags of ``mamba1_full`` (``models/opt_flags.py``):
``mamba_seq_scan`` takes precedence, as in the reference, and with
``mamba_chunk_override`` alone only reorders the reference's fp32
recurrence, which the ``mamba_scan`` kernel computes whatever they say.
``mamba_bf16_scan`` (without ``mamba_seq_scan``) is another function:
dA and dBu rounded to bf16 and combined in bf16 by an associative scan
over chunks of ``mamba_chunk_override or ssm_chunk`` steps, so there the
chunk changes the result.  The port runs it on the ``mamba_scan_bf16``
kernel and its gradient on ``mamba_scan_bwd`` under its bf16 flag.
Decode stays the fp32 recurrence under every flag, as the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers as L
from repro_torch.models import opt_flags
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt_lib

# The leaves that stay fp32 under any parameter dtype, by name.
FP32_LEAVES = {"mamba1": ("A_log",), "mamba2": ("A_log", "dt_bias")}


class SSMCache(NamedTuple):
    """Decode state of a Mamba stack."""

    conv: torch.Tensor   # (L, B, K-1, d_inner)
    ssm: torch.Tensor    # (L, B, d_inner, N) | (L, B, nh, N, P)


# =============================================================================
# Mamba1
# =============================================================================

def mamba1_params(cfg: ModelConfig, gen: torch.Generator,
                  lead=()) -> Dict[str, torch.Tensor]:
    """One Mamba1 block's params (with leading axes ``lead``, e.g. the
    layers), on the generator's device."""
    D, din, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.dt_rank_, cfg.ssm_conv)
    pd, dev = L.pdtype_of(cfg), gen.device
    lead = tuple(lead)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev)).expand(lead + (din, N))
    return {
        "ln": L.norm_params(cfg, lead, device=dev),
        "in_proj": L.dense_init(gen, lead + (D, 2 * din), pd),
        "conv_w": L.dense_init(gen, lead + (K, din), pd, scale=1.0),
        "conv_b": torch.zeros(lead + (din,), dtype=pd, device=dev),
        "x_proj": L.dense_init(gen, lead + (din, R + 2 * N), pd),
        "dt_proj": L.dense_init(gen, lead + (R, din), pd),
        "dt_bias": torch.full(lead + (din,), -4.6, dtype=pd, device=dev),
        "A_log": A_log.contiguous(),
        "Dskip": torch.ones(lead + (din,), dtype=pd, device=dev),
        "out_proj": L.dense_init(gen, lead + (din, D), pd),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv; x: (B, S, C), w: (K, C).  ``state``:
    (B, K-1, C) left context (decode), else zero-padded."""
    K = w.shape[0]
    left = state if state is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([left, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _conv_state(xin: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 conv inputs (B, K-1, C), zero-padded on the left
    where the sequence is shorter.  A copy: a view would keep the whole
    (B, S, 2 d_inner) projection it slices alive in the cache, for every
    layer."""
    S = xin.shape[1]
    if S >= K - 1:
        return xin[:, S - (K - 1):S].clone()
    return F.pad(xin, (0, 0, K - 1 - S, 0))


def _norm(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(x, p["ln"]["w"]) if cfg.norm == "rmsnorm" else x


def _silu_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _mamba1_inputs(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                   conv_state: torch.Tensor | None):
    """The projections shared by full and decode: (xin, z, u, dt, Bc, Cc)
    with dt = softplus(dt_proj(dt_r) + dt_bias) in fp32; Bc and Cc are
    views into the x_proj output."""
    N, R = cfg.ssm_state, cfg.dt_rank_
    xz = dt_lib.reduce_grad(_norm(cfg, p, x)) @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    u = _silu_as(_causal_conv(xin, p["conv_w"], p["conv_b"], conv_state),
                 x.dtype)
    dbc = u @ p["x_proj"]
    dt_r, Bc, Cc = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"].float())
    return xin, z, u, dt, Bc, Cc


def _mamba1_out(p: Dict, x, y, u, z) -> torch.Tensor:
    y = y + u * p["Dskip"].to(x.dtype)
    y = y * _silu_as(z, x.dtype)
    return x + L.settle(y @ p["out_proj"])


def selective_scan(u, dt, Bc, Cc, A_log, bf16_chunk: int = 0):
    """The ``mamba_scan`` kernel's wrapper (``bf16_chunk`` as its), called
    on local shards where
    u is a DTensor (the sharded step): the scan is local over the batch
    and over ``d_inner``.  A mesh dim that splits u or dt over d_inner
    splits u, dt, A_log, y and the state there, and each rank's
    gradients for Bc and Cc (which every d_inner channel reads) are a
    ``Partial`` sum over it; a mesh dim that splits the batch splits u,
    dt, Bc, Cc, y and the state, and A_log's gradient is a ``Partial``
    sum over it."""
    if not dt_lib.is_dtensor(u):
        return scan_ops.mamba_scan(u, dt, Bc, Cc, A_log, bf16_chunk)
    from torch.distributed.tensor import Partial, Replicate, Shard
    u, dt, Bc, Cc = (dt_lib.settle(t) for t in (u, dt, Bc, Cc))
    upl, bpl, bgrad, apl, agrad, hpl = [], [], [], [], [], []
    for i in range(u.device_mesh.ndim):
        sh = {p.dim % 3 for p in (u.placements[i], dt.placements[i],
                                  Bc.placements[i]) if p.is_shard()}
        if 0 in sh:                               # batch
            upl.append(Shard(0)), bpl.append(Shard(0))
            bgrad.append(Shard(0)), apl.append(Replicate())
            agrad.append(Partial()), hpl.append(Shard(0))
        elif 2 in sh:                             # d_inner
            upl.append(Shard(2)), bpl.append(Replicate())
            bgrad.append(Partial()), apl.append(Shard(0))
            agrad.append(Shard(0)), hpl.append(Shard(1))
        else:
            for lst in (upl, bpl, bgrad, apl, agrad, hpl):
                lst.append(Replicate())
    y, h = scan_ops.mamba_scan(
        dt_lib.local_in(u, upl), dt_lib.local_in(dt, upl),
        dt_lib.local_in(Bc, bpl, bgrad), dt_lib.local_in(Cc, bpl, bgrad),
        dt_lib.local_in(A_log, apl, agrad), bf16_chunk)
    return dt_lib.local_out(y, u, upl), dt_lib.local_out(h, u, hpl)


def mamba1_full(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                return_state: bool = False):
    """x: (B, S, D) -> (B, S, D).  The selective scan is the
    ``mamba_scan`` kernel, or under ``mamba_bf16_scan`` (and not
    ``mamba_seq_scan``) the bf16 scan at chunks of ``mamba_chunk_override
    or ssm_chunk`` steps.  ``return_state``: also return (conv_state
    (B, K-1, din), ssm_state (B, din, N) fp32) for decode."""
    f = opt_flags.FLAGS
    chunk = ((f.mamba_chunk_override or cfg.ssm_chunk)
             if f.mamba_bf16_scan and not f.mamba_seq_scan else 0)
    xin, z, u, dt, Bc, Cc = _mamba1_inputs(cfg, p, x, None)
    y, h_last = selective_scan(u, dt, Bc, Cc, p["A_log"], chunk)
    out = _mamba1_out(p, x, y, u, z)
    if return_state:
        return out, (_conv_state(xin, cfg.ssm_conv), h_last)
    return out


def mamba1_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x: (B, 1, D); conv_state: (B, K-1, din); ssm_state: (B, din, N)
    -> (out, conv_state, ssm_state), new tensors."""
    xin, z, u, dt, Bc, Cc = _mamba1_inputs(cfg, p, x, conv_state)
    conv_state = torch.cat([conv_state[:, 1:], xin], dim=1)
    dt = dt[:, 0]                                            # (B, din)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * A)                        # (B, din, N)
    dBu = (dt * u[:, 0].float())[..., None] * Bc[:, 0].float()[:, None, :]
    h = dA * ssm_state + dBu
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0].float())
    return _mamba1_out(p, x, y.to(x.dtype)[:, None, :], u, z), conv_state, h


# =============================================================================
# Mamba2 (SSD)
# =============================================================================

def mamba2_params(cfg: ModelConfig, gen: torch.Generator,
                  lead=()) -> Dict[str, torch.Tensor]:
    """One Mamba2 block's params (with leading axes ``lead``): the
    reference's decomposed in_proj (zx, B/C and dt projections)."""
    D, din, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = din // cfg.ssm_head_dim
    pd, dev = L.pdtype_of(cfg), gen.device
    lead = tuple(lead)
    return {
        "ln": L.norm_params(cfg, lead, device=dev),
        "zx_proj": L.dense_init(gen, lead + (D, 2 * din), pd),
        "bc_proj": L.dense_init(gen, lead + (D, 2 * N), pd),
        "dtp": L.dense_init(gen, lead + (D, nh), pd),
        "conv_w": L.dense_init(gen, lead + (K, din), pd),
        "conv_b": torch.zeros(lead + (din,), dtype=pd, device=dev),
        "A_log": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full(lead + (nh,), -4.6, dtype=torch.float32,
                              device=dev),
        "Dskip": torch.ones(lead + (nh,), dtype=pd, device=dev),
        "out_proj": L.dense_init(gen, lead + (din, D), pd),
    }


def _mamba2_proj(p: Dict, res: torch.Tensor):
    res = dt_lib.reduce_grad(res)
    z, xin = torch.chunk(res @ p["zx_proj"], 2, dim=-1)
    Bc, Cc = torch.chunk(res @ p["bc_proj"], 2, dim=-1)
    dt_r = res @ p["dtp"]
    return z, xin, Bc, Cc, dt_r


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., C) -> (..., C, C) lower-tri cumulative sums: out[i,j] =
    sum_{k=j+1..i} x[k] for i >= j, -inf above the diagonal."""
    C = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones((C, C), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~lower, float("-inf"))


def _ssd_chunks(dt, dA, uh, bf, cf, C: int, dtype):
    """The SSD recurrence over chunks of ``C`` steps: dt, dA (B, S, nh)
    fp32, uh (B, S, nh, P), bf, cf (B, S, N) fp32 -> (y (B, S, nh, P) in
    ``dtype``, the final state (B, nh, N, P) fp32).  On DTensors it runs
    on each rank's batch shard (every input split along the batch as a
    mesh dim splits it, replicated on the others): DTensor's rules for
    its grouped einsums fail on a head-split shard."""
    if dt_lib.is_dtensor(dt):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Shard(0) if p == Shard(0) else Replicate()
              for p in uh.placements]
        y, h = _ssd_chunks(*(dt_lib.local_in(dt_lib.settle(t), pl)
                             for t in (dt, dA, uh, bf, cf)), C, dtype)
        return dt_lib.local_out(y, uh, pl), dt_lib.local_out(h, uh, pl)
    B, S, nh, P = uh.shape
    h = torch.zeros((B, nh, bf.shape[-1], P), dtype=torch.float32,
                    device=uh.device)
    ys = []
    for c0 in range(0, S, C):
        sl = slice(c0, min(c0 + C, S))
        dac, bc, cc = dA[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(dac, dim=1)                            # (B,C,nh)
        Lmat = torch.exp(_segsum(dac.transpose(1, 2)))            # (B,nh,C,C)
        cb = torch.einsum("bin,bjn->bij", cc, bc)                 # (B,C,C)
        du = dt[:, sl, :, None] * uh[:, sl].float()               # (B,C,nh,P)
        y_diag = torch.einsum("bhij,bij,bjhp->bihp", Lmat, cb, du)
        # contribution of the carried-in state
        y_off = torch.einsum("bin,bhnp,bih->bihp", cc, h, torch.exp(cum))
        # new carry
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)            # (B,C,nh)
        h = torch.exp(cum[:, -1])[..., None, None] * h + torch.einsum(
            "bjn,bjh,bjhp->bhnp", bc, decay_to_end, du)
        ys.append((y_diag + y_off).to(dtype))
    return torch.cat(ys, dim=1), h


def mamba2_full(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), the SSD chunked form: quadratic within
    a chunk of ``ssm_chunk`` steps, the state (B, nh, N, P) fp32 carried
    across chunks.  The last chunk is simply shorter where the
    reference pads it with identity steps (dt = 0), which gives the same
    outputs and state.  ``return_state``: also return (conv_state,
    ssm_state) for decode."""
    B, S, _ = x.shape
    din, N, C = cfg.d_inner, cfg.ssm_state, cfg.ssm_chunk
    P = cfg.ssm_head_dim
    nh = din // P

    z, xin, Bc, Cc, dt_r = _mamba2_proj(p, _norm(cfg, p, x))
    u = _silu_as(_causal_conv(xin, p["conv_w"], p["conv_b"]), x.dtype)
    dt = F.softplus(dt_r.float() + p["dt_bias"])                  # (B,S,nh)
    A = -torch.exp(p["A_log"])                                    # (nh,)
    dA = dt * A                                                   # (B,S,nh)
    uh = u.reshape(B, S, nh, P)
    yh, h = _ssd_chunks(dt, dA, uh, Bc.float(), Cc.float(), C, x.dtype)
    y = yh.reshape(B, S, din)
    y = y + (uh * p["Dskip"].to(x.dtype)[None, None, :, None]).reshape(
        B, S, din)
    y = y * _silu_as(z, x.dtype)
    out = x + L.settle(y @ p["out_proj"])
    if return_state:
        return out, (_conv_state(xin, cfg.ssm_conv), h)
    return out


def mamba2_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x: (B,1,D); conv_state: (B,K-1,din); ssm_state: (B,nh,N,P) ->
    (out, conv_state, ssm_state), new tensors."""
    B = x.shape[0]
    din, P = cfg.d_inner, cfg.ssm_head_dim
    nh = din // P
    z, xin, Bc, Cc, dt_r = _mamba2_proj(p, _norm(cfg, p, x))
    u = _silu_as(_causal_conv(xin, p["conv_w"], p["conv_b"], conv_state),
                 x.dtype)
    conv_state = torch.cat([conv_state[:, 1:], xin], dim=1)
    dt = F.softplus(dt_r.float() + p["dt_bias"])[:, 0]            # (B,nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                        # (B,nh)
    uh = u[:, 0].reshape(B, nh, P).float()
    h = dA[..., None, None] * ssm_state + torch.einsum(
        "bn,bh,bhp->bhnp", Bc[:, 0].float(), dt, uh)
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), h)
    y = y + uh * p["Dskip"].float()[None, :, None]
    y = y.reshape(B, 1, din).to(x.dtype)
    y = y * _silu_as(z, x.dtype)
    return x + L.settle(y @ p["out_proj"]), conv_state, h
