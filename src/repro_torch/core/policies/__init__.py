"""The pure-Python reference policies of the port (the correctness
oracles of its lane engines); importing the package registers each
with ``repro_torch.core.policy``.  The port's own copy of
``repro/core/policies/__init__.py``."""

from repro_torch.core.policies.simple import FIFO, LRU, Clock, SLRU, LFU, SIEVE  # noqa: F401
from repro_torch.core.policies.two_q import TwoQ, Clock2Q  # noqa: F401
from repro_torch.core.policies.s3fifo import S3FIFO  # noqa: F401
from repro_torch.core.policies.clock2qplus import Clock2QPlus  # noqa: F401
from repro_torch.core.policies.arc import ARC  # noqa: F401
from repro_torch.core.policies.tinylfu import WTinyLFU  # noqa: F401
from repro_torch.core.policies.belady import Belady  # noqa: F401
from repro_torch.core.policies.lirs import LIRS  # noqa: F401
