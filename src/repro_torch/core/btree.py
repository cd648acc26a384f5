"""Insert-order B+tree used to validate the divide-by-fanout metadata

The port's own copy of ``repro/core/btree.py``.
derivation (paper §5.2 / Fig. 7).

Keys are inserted on first access (as a write-anywhere storage B-tree would
allocate mappings on first write) and leaves split at ``fanout`` keys.  The
replay records the *leaf block id* touched by every request; comparing miss
ratios on this trace vs the ``LBN // fanout`` derivation reproduces the
paper's fidelity experiment.
"""

from __future__ import annotations

import bisect

import numpy as np


class LeafBTree:
    def __init__(self, fanout: int = 200):
        self.fanout = fanout
        self.lower = [0]        # sorted lower bounds per leaf position
        self.leaf_ids = [0]     # stable block id per leaf position
        self.leaf_keys = [[]]   # sorted keys per leaf position
        self.next_id = 1
        self.known = set()

    def _leaf_pos(self, key: int) -> int:
        return max(0, bisect.bisect_right(self.lower, key) - 1)

    def lookup_or_insert(self, key: int) -> int:
        pos = self._leaf_pos(key)
        if key not in self.known:
            self.known.add(key)
            keys = self.leaf_keys[pos]
            bisect.insort(keys, key)
            if len(keys) > self.fanout:
                if pos == len(self.leaf_keys) - 1 and keys[-1] == key:
                    # sequential tail insert: split at the end so the left
                    # leaf stays FULL (the classic bulk-load behaviour of
                    # B+trees under in-order insertion, incl. TLX)
                    mid = self.fanout
                else:
                    mid = len(keys) // 2
                right = keys[mid:]
                self.leaf_keys[pos] = keys[:mid]
                rpos = pos + 1
                self.lower.insert(rpos, right[0])
                self.leaf_ids.insert(rpos, self.next_id)
                self.leaf_keys.insert(rpos, right)
                self.next_id += 1
                if key >= right[0]:
                    pos = rpos
        return self.leaf_ids[pos]

    def prepopulate(self, universe: int) -> None:
        """Insert the whole LBN space in order (the volume's map exists
        before the trace runs — matching the paper's TLX experiment)."""
        for k in range(universe):
            self.lookup_or_insert(k)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_ids)


def btree_metadata_trace(data_trace: np.ndarray, fanout: int = 200,
                         universe: int = 0) -> np.ndarray:
    tree = LeafBTree(fanout)
    if universe:
        tree.prepopulate(universe)
    return np.asarray([tree.lookup_or_insert(int(k)) for k in data_trace],
                      dtype=np.int64)
