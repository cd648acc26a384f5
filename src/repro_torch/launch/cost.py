"""Per-device cost counts of a traced step, and the roofline terms.

The counterpart of the reference's ``launch/hlo_cost.py`` (a loop-aware
cost model over optimized HLO text) and ``launch/hlo_analysis.py`` (the
collective bytes and the roofline terms).  PyTorch has no HLO: the
counts come from the ops themselves as they run, through a
``TorchDispatchMode`` (``CostMode``) that sees every aten op on each
rank's **local** tensors.  Where an op's inputs are DTensors the mode
steps aside (returns ``NotImplemented``), DTensor runs it as local ops
and collectives, and the mode counts those: a mode entered above
DTensor would count the global op (``torch.utils.flop_counter``'s
``FlopCounterMode`` does), not one device's share.  A loop in Python
runs its body each trip, so every trip is counted, which the
reference's HLO model has to multiply in.

Counted per device:

* ``flops``: the matmul family (mm, bmm, addmm, baddbmm, convolution,
  the scaled-dot-product attentions), by ``torch.utils.flop_counter``'s
  formulas;
* ``hbm_bytes``: for every op that materialises an output (not a view,
  not a collective), the bytes of its tensor operands plus its outputs:
  each op read from and written to memory once, no fusion;
* ``collectives``: by kind (all-reduce, all-gather, reduce-scatter,
  all-to-all), the count, the bytes of the results and the ring wire
  bytes (2x the buffer for an all-reduce, 1x for the rest), as
  ``hlo_analysis.collective_bytes`` counts them;
* ``peak_bytes``: the most bytes of tensors that ops made and that were
  alive at once, on top of what was alive before.

A hand-written kernel is one op, its wrapper's operator in the
``repro_torch`` namespace (a shape-only trace runs its registered fake):
it is charged its inputs read once and its outputs written once, and
the flops of ``KERNEL_FLOPS``, a table by the operator's name.

``roofline_terms`` turns the counts into seconds at one NVIDIA H100 SXM5
80GB's spec-sheet rates (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW`` x
``LINKS``), not the TPU v5e's of the reference: the card the port runs
on ("NVIDIA H100 80GB HBM3, 700.00 W").  They are the spec sheet's
numbers, not measured.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB spec sheet ("NVIDIA H100 80GB HBM3, 700.00 W"):
# not measured
PEAK_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # HBM3 bytes/s
LINK_BW = 25e9          # one NVLink-4 link, bytes/s each way
LINKS = 18              # NVLink-4 links per GPU

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# bytes on the wire per result byte (ring algorithms)
WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0}
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


# ops that move no bytes: aliases, and allocations left uninitialised
_NO_TRAFFIC = ("detach", "alias", "lift_fresh", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _attn_flops(q, k, causal: bool) -> float:
    """QK^T and PV of q (B, Sq, H, hd) against k (B, Skv, Hkv, hd), 2
    flops a multiply-add; half of them where causal with Sq == Skv."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    return 4.0 * B * H * Sq * Skv * hd * (0.5 if causal and Sq == Skv
                                          else 1.0)


def _paged_flops(q, kpool, vpool, block_tables, lengths) -> float:
    # QK^T and PV over the tables' capacity: the lengths are data, which
    # a shape-only trace cannot read
    B, H, d = q.shape
    return 4.0 * B * H * block_tables.shape[1] * kpool.shape[1] * d


# the flops of each hand-written kernel's operator (``torch.ops.repro_torch``)
# from its arguments: the products it does (the backward of attention makes
# five of the forward's two, 2.5x); the scan makes none, and the reference's
# cost model counts only products
KERNEL_FLOPS = {
    "flash_attention": lambda q, k, v, causal: _attn_flops(q, k, causal),
    "flash_attention_lse": lambda q, k, v, causal: _attn_flops(q, k,
                                                               causal),
    "flash_attention_bwd": lambda q, k, v, o, lse, do, causal:
        2.5 * _attn_flops(q, k, causal),
    "mamba_scan": lambda *args: 0.0,
    "mamba_scan_states": lambda *args: 0.0,
    "mamba_scan_bwd": lambda *args: 0.0,
    "mamba_scan_bf16": lambda *args: 0.0,
    "mamba_scan_bf16_states": lambda *args: 0.0,
    "mamba_scan_bf16_bwd": lambda *args: 0.0,
    "paged_attention": _paged_flops,
    "paged_attention_lse": _paged_flops,
}


class CostMode(TorchDispatchMode):
    """Counts the flops, bytes, collectives and live bytes of the local
    ops run while it is active (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.byte_categories: Dict[str, float] = {}
        self.collectives = {k: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0}
                            for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        # DTensor infers an op's global output shape by running it on
        # global-shaped fake tensors it makes with empty_strided: no
        # device runs that, so an op whose every tensor argument is such
        # a tensor, or was made from one, is not counted
        self._shape_only = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count DTensor's local ops instead
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "repro_torch":      # a hand-written kernel
            self.flops += float(KERNEL_FLOPS[name](*args, **kwargs))
            self._traffic(name, args, out)
            return out
        if ns not in ("aten", "_c10d_functional", "c10d_functional"):
            return out
        args_t = list(_tensors(args))
        if name == "empty_strided" or (args_t and all(
                id(t) in self._shape_only for t in args_t)):
            for t in _tensors(out):   # and what is made from them
                self._shape_only.add(id(t))
                weakref.finalize(t, self._shape_only.discard, id(t))
            return out
        if ns == "_c10d_functional" or ns == "c10d_functional":
            kind = _KIND.get(name)
            if kind is not None:
                b = sum(nbytes(t) for t in _tensors(out))
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += b
                c["wire_bytes"] += b * WIRE_MULT[kind]
            return out
        packet = func._overloadpacket
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](*args, **kwargs,
                                                       out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            self._traffic(name, args, out)
        return out

    def _traffic(self, name: str, args, out) -> None:
        """Charge an op that materialises ``out``: its tensor arguments
        read once and its outputs written once."""
        outs = list(_tensors(out))
        b = sum(nbytes(t) for t in _tensors(args)) + \
            sum(nbytes(t) for t in outs)
        self.hbm_bytes += b
        self.byte_categories[name] = self.byte_categories.get(name, 0.0) + b
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        n = nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    @property
    def wire_bytes(self) -> float:
        return sum(c["wire_bytes"] for c in self.collectives.values())

    def totals(self) -> Dict:
        """The counts as a record: ``flops``, ``hbm_bytes``,
        ``collective_wire_bytes``, ``collectives``, ``byte_categories``
        and ``peak_bytes``."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_wire_bytes": self.wire_bytes,
                "collectives": self.collectives,
                "byte_categories": dict(sorted(
                    self.byte_categories.items(), key=lambda kv: -kv[1])[:12]),
                "peak_bytes": self.peak}


def roofline_terms(flops: float, hbm_bytes: float, coll_wire_bytes: float,
                   n_chips: int, links_per_chip: int = LINKS,
                   per_device: bool = True) -> Dict[str, float]:
    """The three roofline terms in seconds and the dominant one, at the
    H100's spec-sheet rates; the inputs are per device when
    ``per_device``, else totals over ``n_chips``.  One link term, as in
    the reference: all collective bytes over ``links_per_chip`` NVLink
    links."""
    div = 1 if per_device else n_chips
    t_compute = (flops / div) / PEAK_FLOPS
    t_memory = (hbm_bytes / div) / HBM_BW
    t_coll = (coll_wire_bytes / div) / (LINK_BW * links_per_chip)
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dom[1],
            "bound_s": dom[0]}
