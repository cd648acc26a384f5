"""Beyond-baseline optimization flags, the port's own copy of
``repro.models.opt_flags``: the same fields, defaults and ``use_flags``.

The paper-faithful lowering is flags-all-off.  Module-level, so model
code reads ``opt_flags.FLAGS`` at call time without threading knobs
through every signature.  What each flag does in the port:

* ``mamba_seq_scan`` and, alone, ``mamba_chunk_override`` choose only
  how the reference orders the same fp32 recurrence (a sequential time
  scan, or the chunk of its associative scan).  That recurrence is what
  the ``mamba_scan`` kernel computes, so they change nothing on the
  port's path (``models/mamba.py::mamba1_full``).
* ``mamba_bf16_scan`` rounds dA and dBu to bf16 and runs the associative
  scan in bf16 over chunks of ``mamba_chunk_override or ssm_chunk``
  steps: a different function, which ``mamba1_full`` computes on the
  ``mamba_scan_bf16`` kernel.  Under it ``mamba_chunk_override`` changes
  the result; ``mamba_seq_scan`` overrides it, as in the reference, and
  decode stays fp32.
* ``decode_shard_scores`` and ``decode_seq_axis`` drive
  ``models/layers.py::_maybe_shard_scores``, and ``moe_local_dispatch``
  ``models/moe.py::_constrain``: sharding hints that redistribute the
  sharded step's DTensors as the reference's pin its shardings, and the
  identity on plain tensors.
* ``decode_buffered`` and ``decode_buffer_len`` are read only by the
  dry-run (``launch/dryrun.py``), as in the reference;
  ``models/transformer.py``'s buffered decode takes its ring length as
  an argument.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class OptFlags:
    """The flags and their defaults (all off)."""

    # decode: attention scores against an S-sharded KV cache computed
    # locally (partial softmax + small all-reduces)
    decode_shard_scores: bool = False
    decode_seq_axis: str = "model"
    # decode: new tokens into a small ring, base and ring merged by
    # online softmax, the ring committed to the base every R steps
    decode_buffered: bool = False
    decode_buffer_len: int = 256
    # mamba: the chunked selective scan in bf16, and its chunk size
    mamba_bf16_scan: bool = False
    mamba_chunk_override: int = 0
    # mamba: a sequential time scan instead of the associative one
    mamba_seq_scan: bool = False
    # moe: dispatch and combine kept token-sharded
    moe_local_dispatch: bool = False


FLAGS = OptFlags()


@contextlib.contextmanager
def use_flags(**kw):
    """Set flags for the ``with`` block (nesting allowed); restores the
    previous flags on exit."""
    global FLAGS
    old = FLAGS
    FLAGS = dataclasses.replace(FLAGS, **kw)
    try:
        yield FLAGS
    finally:
        FLAGS = old
