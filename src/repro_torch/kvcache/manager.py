"""Sequence-level paged-KV manager: block tables, prefix sharing, and the
Clock2Q+-backed block pool.

Block keys:
  * full, immutable blocks -> content hash of the token prefix up to the
    block's end: identical prompt prefixes map to the SAME physical block
    (prefix cache).  These are clean once flushed and freely evictable.
  * the mutable tail block of a live sequence -> a unique (seq, idx)
    handle, pinned while the sequence is active and dirty until complete.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kvcache.pool import BlockPool
from repro_torch.models.config import ModelConfig

_HASH_SPACE = 1 << 48


def _prefix_key(tokens: Sequence[int]) -> int:
    h = 1469598103934665603
    for t in tokens:
        h = ((h ^ (int(t) + 1)) * 1099511628211) % (1 << 64)
    return h % _HASH_SPACE


@dataclasses.dataclass
class SeqState:
    """One live sequence: prompt, block keys and payload slots, generated tokens."""
    seq_id: int
    tokens: List[int]
    block_keys: List[int]
    slots: List[int]
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    tenant: Optional[str] = None  # serving tenant (pool lookup labels)

    @property
    def length(self) -> int:
        """Tokens so far: prompt plus generated."""
        return len(self.tokens) + len(self.out_tokens)


class PagedKVManager:
    """Block tables of the live sequences over a ``BlockPool``, with prefix sharing."""
    def __init__(self, cfg: ModelConfig, pool: BlockPool):
        self.cfg = cfg
        self.pool = pool
        self.bs = pool.bs
        self.seqs: Dict[int, SeqState] = {}
        self._next_handle = _HASH_SPACE  # tail-block handles above hashes

    # -- admission -----------------------------------------------------------
    def admit(self, seq_id: int, tokens: List[int],
              tenant: Optional[str] = None) -> Tuple[SeqState, List[int]]:
        """Allocate blocks for a prompt.  Returns (state, fill_list): the
        indices of blocks whose contents must be computed by prefill
        (prefix-cache hits need no recompute).  ``tenant`` attributes
        every block lookup of this sequence — admission and decode-tail
        — to the owning serving tenant."""
        n_blocks = -(-len(tokens) // self.bs)
        keys, slots, fill = [], [], []
        for b in range(n_blocks):
            end = min((b + 1) * self.bs, len(tokens))
            full = end == (b + 1) * self.bs
            if full:
                key = _prefix_key(tokens[:end])
            else:
                key = self._next_handle
                self._next_handle += 1
            slot, needs_fill = self.pool.lookup(key, pin=True,
                                                tenant=tenant)
            keys.append(key)
            slots.append(slot)
            if needs_fill or not full:
                fill.append(b)
        st = SeqState(seq_id, list(tokens), keys, slots, tenant=tenant)
        self.seqs[seq_id] = st
        return st, fill

    # -- decode append ------------------------------------------------------------
    def slot_for_pos(self, seq_id: int, pos: int) -> Tuple[int, int]:
        """(slot, offset) where the KV of the token at ``pos`` goes;
        allocates a new tail block on a block boundary, and tells the
        pool that the block is written in place (``note_write``: a host
        copy taken before is now older than the block)."""
        st = self.seqs[seq_id]
        while pos // self.bs >= len(st.slots):
            key = self._next_handle
            self._next_handle += 1
            slot, _ = self.pool.lookup(key, pin=True, tenant=st.tenant)
            # contents arrive via write_token in the same step: the block
            # is immediately usable (leaving it DOING-IO would wedge the
            # live-resize drain, §4.2)
            self.pool.policy.io_done(key)
            self.pool.policy.set_dirty(key)
            st.block_keys.append(key)
            st.slots.append(slot)
        self.pool.note_write(st.block_keys[pos // self.bs])
        return st.slots[pos // self.bs], pos % self.bs

    def block_table(self, seq_id: int, max_blocks: int) -> np.ndarray:
        """The sequence's payload slots, zero-padded to ``max_blocks``."""
        st = self.seqs[seq_id]
        bt = np.zeros((max_blocks,), np.int32)
        bt[:len(st.slots)] = st.slots
        return bt

    # -- release -------------------------------------------------------------------
    def release(self, seq_id: int) -> None:
        """Sequence finished: unpin all blocks (they stay cached — a
        follow-up request with the same prefix will hit)."""
        st = self.seqs.pop(seq_id)
        for k in st.block_keys:
            self.pool.unpin(k)

    def maintenance(self) -> None:
        """Per-step housekeeping: one pass of the pool's dirty-block flusher."""
        self.pool.run_flusher()
