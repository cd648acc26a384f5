"""Cache-policy API of the pure-Python oracle: the port's own copy of
what ``repro/core/policy.py`` gives the Clock2Q+ reference policy.

Keys are opaque hashable block ids (ints in practice).  ``access``
returns True on a hit.
"""

from __future__ import annotations


class CachePolicy:
    """Base class.  Subclasses implement ``access``."""

    name: str = "base"

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)

    def access(self, key) -> bool:
        """Serve one request; True on a hit."""
        raise NotImplementedError

    def __contains__(self, key) -> bool:
        """Whether ``key`` is resident (data present, not a ghost)."""
        raise NotImplementedError

    def __len__(self) -> int:
        """Number of resident blocks."""
        raise NotImplementedError


def seg_size(capacity: int, frac: float, minimum: int = 1) -> int:
    """Segment sizing helper: ``round(frac * capacity)``, at least
    ``minimum``."""
    return max(minimum, int(round(capacity * frac)))
