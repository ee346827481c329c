"""Self-healing collectives: derived deadlines, rank-death detection and
certified reconfiguration.

Counterpart of accl_tpu/resilience/. Three pieces, each built on a proof
or measurement the port already has:

  - ``deadline``: per-call deadlines derived from ``timing.predict`` under
    a calibrated link, widened by the drift sentinel's residual band. A
    miss is a structured :class:`DeadlineMissed` verdict with the flight
    recorder's post-mortem attached; :class:`NativeDeadlineGuard` applies
    the policy to the native emulator's ranks.

  - ``manager``: :class:`ResilienceManager` runs detect -> exclude ->
    re-plan -> re-certify -> install. A retry budget separates a
    straggler from a dead peer; the recovery schedule over the survivors
    (a synthesized library entry, else the ring) is proven through the
    port's semantics and model-checking stack before it is installed, and
    an unproven one raises :class:`UncertifiedRecoveryError`. Wire-health
    deltas tell a lossy link (:class:`IntegrityFault`, no
    reconfiguration) from a dark one.

  - the certified degraded mode on the facade:
    ``ACCL.allreduce(mode="live_subset", live_ranks=...)`` masks every
    non-survivor to exact zeros at the source of the torch-op ring, and
    the certifier proves exactly whose data is in the answer.
"""

from .deadline import (  # noqa: F401
    DEFAULT_DEADLINE_FLOOR_S,
    DEFAULT_UNARMED_REFERENCE,
    DeadlineMissed,
    DeadlineMissedError,
    DeadlinePolicy,
    NativeDeadlineGuard,
)
from .manager import (  # noqa: F401
    IntegrityFault,
    RecoveryPlan,
    ResilienceManager,
    RetryBudget,
    UncertifiedRecoveryError,
)

__all__ = [
    "DEFAULT_DEADLINE_FLOOR_S",
    "DEFAULT_UNARMED_REFERENCE",
    "DeadlineMissed",
    "DeadlineMissedError",
    "DeadlinePolicy",
    "IntegrityFault",
    "NativeDeadlineGuard",
    "RecoveryPlan",
    "ResilienceManager",
    "RetryBudget",
    "UncertifiedRecoveryError",
]
