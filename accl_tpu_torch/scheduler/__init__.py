"""Multi-tenant scheduler: certified concurrent programs, QoS and admission
control over SequenceProgram dispatches.

Counterpart of accl_tpu/scheduler/. Tenants register with a priority class
and a fair-queue weight; each program is priced (the device's
predict_sequence_cost) and certified against everything admitted
(analysis.interference) at submit; a pair the certifier cannot prove
clean is serialized, never dropped; every dispatch carries the
certificate id of the set it overlapped; per-tenant latencies, SLO
residuals and noisy-neighbour attribution go to the metrics registry.

    sched = accl.scheduler(capacity_s=10.0)
    sched.register_tenant("interactive", priority=0, weight=4.0)
    sched.register_tenant("bulk", priority=1, weight=1.0)
    sched.submit("interactive", small_program, repeats=100)
    sched.submit("bulk", big_program, repeats=8)
    sched.drain(workers=2)
    sched.report()
"""

from .errors import (
    DuplicateTenantError,
    SchedulerError,
    SchedulerSaturatedError,
    UnknownTenantError,
)
from .qos import FairQueue, QueueEntry
from .scheduler import MultiTenantScheduler
from .tenant import Tenant, TenantRegistry

__all__ = [
    "MultiTenantScheduler",
    "Tenant",
    "TenantRegistry",
    "FairQueue",
    "QueueEntry",
    "SchedulerError",
    "SchedulerSaturatedError",
    "UnknownTenantError",
    "DuplicateTenantError",
]
