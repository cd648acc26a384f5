"""Clock2Q+ cache substrate of the port: the lane-batched policy engines
(``core.engine``) and their replay drivers (``core.torch_engine``), trace
generation (``core.traces``), the pure-Python policy zoo that holds the
engines to account (``core.policies``, registered on import) and the
simulation drivers over it (``core.stats``)."""

from repro_torch.core.policy import (  # noqa: F401
    CachePolicy, SimResult, make_policy, policy_names, register,
)
import repro_torch.core.policies  # noqa: F401  (registers the zoo)
from repro_torch.core import stats, traces  # noqa: F401
