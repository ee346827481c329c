"""Typed scheduler errors: the admission contract's failure surface.

Counterpart of accl_tpu/scheduler/errors.py. Every admission failure is a
typed raise: saturation is never a silent drop (the queue takes the work
or refuses it with the numbers that show why), and tenant bookkeeping
mistakes fail at the registry, before anything is priced or certified.
"""

from __future__ import annotations


class SchedulerError(RuntimeError):
    """Base class for multi-tenant scheduler failures."""


class SchedulerSaturatedError(SchedulerError):
    """Backpressure: admitting the work would push the queued predicted
    cost past the scheduler's capacity. Carries the accounting, so the
    caller can retry, shed or re-weight."""

    def __init__(self, tenant: str, requested_s: float, queued_s: float,
                 capacity_s: float):
        self.tenant = tenant
        self.requested_s = float(requested_s)
        self.queued_s = float(queued_s)
        self.capacity_s = float(capacity_s)
        super().__init__(
            f"scheduler saturated: tenant {tenant!r} asked for "
            f"{self.requested_s * 1e3:.2f} ms of predicted work with "
            f"{self.queued_s * 1e3:.2f} ms already queued against a "
            f"{self.capacity_s * 1e3:.2f} ms capacity")


class UnknownTenantError(SchedulerError, KeyError):
    """A submit or lookup named a tenant the registry never admitted."""

    def __init__(self, name: str):
        self.tenant = name
        # KeyError would render its argument with repr()
        RuntimeError.__init__(self, f"unknown tenant {name!r} "
                                    "(register_tenant first)")

    def __str__(self) -> str:
        return self.args[0] if self.args else ""


class DuplicateTenantError(SchedulerError, ValueError):
    """A tenant name was registered twice."""

    def __init__(self, name: str):
        self.tenant = name
        super().__init__(f"tenant {name!r} already registered")
