"""Tenant registry: who is admitted, at what priority and weight, and over
which resources.

Counterpart of accl_tpu/scheduler/tenant.py. A tenant is a named traffic
source with a strict priority class, a fair-queue weight inside its class
and, optionally, an explicit per-dispatch SLO budget (without one the
scheduler derives the budget from the timing model, as
resilience/deadline.py derives per-call deadlines).

Every program a tenant submits adds its interference footprint's
resources (buffer addresses, stream endpoints, ring slots,
communicators) to the tenant's namespace record, so
`disjointness_report()` shows what each tenant binds and names any
sharing across tenants: the facts the certifier proves over, as
bookkeeping a person can read. A compiled program's hop tags are private
to it by construction, so tag namespaces need no record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from .errors import DuplicateTenantError, UnknownTenantError


@dataclasses.dataclass
class Tenant:
    """One admitted traffic source and its live accounting."""

    name: str
    priority: int = 1  # 0 is the highest class; strict across classes
    weight: float = 1.0  # fair-queue share within the class
    slo_budget_s: float | None = None  # explicit per-dispatch deadline
    comm: Any = None  # the tenant's communicator (optional)
    # the finish tag of this tenant's last queued entry (fair queueing)
    finish_tag: float = 0.0
    submitted: int = 0
    dispatched: int = 0
    serialized: int = 0  # dispatches admitted in serial-fallback mode
    dispatched_cost_s: float = 0.0
    measured_s: float = 0.0
    slo_misses: int = 0
    # resource class -> bound ids, merged from every submitted footprint
    namespaces: dict[str, set] = dataclasses.field(
        default_factory=lambda: {"addrs": set(), "streams": set(),
                                 "ring_slots": set(), "comms": set()})

    def record_footprint(self, fp) -> None:
        ns = self.namespaces
        ns["addrs"].update(a for a, _ in fp.reads)
        ns["addrs"].update(a for a, _ in fp.writes)
        ns["streams"].update(fp.streams)
        ns["ring_slots"].update(fp.ring_slots)
        ns["comms"].update(fp.comms)

    def account(self) -> dict[str, Any]:
        return {
            "priority": self.priority,
            "weight": self.weight,
            "submitted": self.submitted,
            "dispatched": self.dispatched,
            "serialized": self.serialized,
            "dispatched_cost_s": self.dispatched_cost_s,
            "measured_s": self.measured_s,
            "slo_misses": self.slo_misses,
        }


class TenantRegistry:
    """Name -> Tenant; duplicate names and nonsensical QoS parameters fail
    here, before anything queues."""

    def __init__(self) -> None:
        self._tenants: dict[str, Tenant] = {}

    def register(self, name: str, *, priority: int = 1,
                 weight: float = 1.0, slo_budget_s: float | None = None,
                 comm: Any = None) -> Tenant:
        if not name or not isinstance(name, str):
            raise ValueError(f"tenant name must be a non-empty string, "
                             f"got {name!r}")
        if name in self._tenants:
            raise DuplicateTenantError(name)
        if int(priority) < 0:
            raise ValueError(f"priority must be >= 0 (0 is the highest "
                             f"class), got {priority}")
        if not float(weight) > 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if slo_budget_s is not None and not float(slo_budget_s) > 0:
            raise ValueError(f"slo_budget_s must be > 0, "
                             f"got {slo_budget_s}")
        t = Tenant(name=name, priority=int(priority),
                   weight=float(weight),
                   slo_budget_s=(None if slo_budget_s is None
                                 else float(slo_budget_s)),
                   comm=comm)
        self._tenants[name] = t
        return t

    def get(self, name: str) -> Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise UnknownTenantError(name)
        return t

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def names(self) -> list[str]:
        return sorted(self._tenants)

    def tenants(self) -> Iterable[Tenant]:
        return [self._tenants[n] for n in sorted(self._tenants)]

    def disjointness_report(self) -> dict[str, Any]:
        """Per-tenant namespace sizes and every resource two tenants share:
        an empty `shared` is the disjointness claim, stated over what the
        tenants actually bound."""
        names = self.names()
        per_tenant = {
            n: {k: len(v) for k, v in self._tenants[n].namespaces.items()}
            for n in names}
        shared: list[dict[str, Any]] = []
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                na, nb = (self._tenants[a].namespaces,
                          self._tenants[b].namespaces)
                for res in ("addrs", "streams", "ring_slots"):
                    inter = na[res] & nb[res]
                    if inter:
                        shared.append({
                            "tenants": [a, b], "resource": res,
                            "n_shared": len(inter),
                            "sample": sorted(inter)[:4]})
        return {"tenants": per_tenant, "shared": shared}
