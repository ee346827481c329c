"""The multi-tenant scheduler: certified concurrent programs, QoS and
admission control over SequenceProgram dispatches.

Counterpart of accl_tpu/scheduler/scheduler.py. It multiplexes named
tenants over one ACCL facade:

* Admission. A program enters the queues after it is priced (the
  device's ``predict_sequence_cost``, ``timing.predict_prepared`` under
  the shipped link; else a bytes proxy, so nothing is admitted for free)
  and certified against every program queued or in flight by the
  facade's long-lived ``InterferenceCertifier`` (the verdict cache
  ``ACCL.certify_concurrent`` uses). A pair the certifier cannot prove
  clean (ACCL6xx) is admitted in serial-fallback mode: it never overlaps
  its conflicts, and it is counted (``serialized`` per tenant).

* QoS. Strict priority classes, start-time weighted fair queueing over
  predicted cost within a class (qos.py), and preemption at program
  boundaries. Saturation is a typed ``SchedulerSaturatedError`` at
  submit.

* Certificates at dispatch. Every dispatch is stamped with the
  ``certificate_id`` of the set in flight at its pick, itself included;
  the id rides the program's dispatch span and request
  (``interference_cert``), and ``uncertified_concurrent`` counts any
  overlap without a clean group certificate (it stays 0).

* Accounting. Per-tenant series in the metrics registry (dispatch
  seconds, queue wait, dispatched predicted cost), SLO residuals against
  model-derived budgets (resilience/deadline.py's formula, or the
  tenant's explicit budget) and a noisy-neighbour report naming the
  co-running tenant whose cost overlapped each SLO miss.

On one card the dispatches of `drain(workers=N)` come from N host
threads, and a prepared program's replay holds the device's launch lock
and runs on the one stream, so overlapping dispatches run one after the
other there: each result equals the serial composition's. The rule that
one program is never in flight twice (its static buffers would be shared)
is kept as in the reference.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from ..constants import dtype_nbytes
from ..resilience.deadline import (
    DEFAULT_DEADLINE_FLOOR_S,
    DEFAULT_UNARMED_REFERENCE,
)
from ..telemetry import metrics
from ..telemetry.metrics import (
    DEFAULT_SENTINEL_BAND_FACTOR,
    DEFAULT_SENTINEL_BAND_FLOOR,
)
from .errors import SchedulerSaturatedError
from .qos import FairQueue, QueueEntry
from .tenant import Tenant, TenantRegistry

# pricing without a shipped calibration: a per-step floor plus a ~1 GB/s
# bytes proxy, monotone in payload and never zero (free admission would
# let one tenant starve the fair queue unseen)
_FALLBACK_STEP_S = 1e-5
_FALLBACK_S_PER_BYTE = 1e-9

_DEFAULT_CAPACITY_S = 30.0
_DEFAULT_HISTORY = 4096


class MultiTenantScheduler:
    """Admission control, QoS and accounting over one ACCL facade (module
    docstring). Thread-safe: submits and `drain(workers=N)` loops may run
    at once; the certifier, queues and in-flight set are guarded by one
    lock, and programs overlap only under clean pairwise verdicts."""

    def __init__(self, accl, *, capacity_s: float = _DEFAULT_CAPACITY_S,
                 registry=None,
                 slo_reference: float = DEFAULT_UNARMED_REFERENCE,
                 band_factor: float = DEFAULT_SENTINEL_BAND_FACTOR,
                 band_floor: float = DEFAULT_SENTINEL_BAND_FLOOR,
                 slo_floor_s: float = DEFAULT_DEADLINE_FLOOR_S,
                 history: int = _DEFAULT_HISTORY,
                 time_fn=time.perf_counter):
        from ..analysis.interference import InterferenceCertifier

        self._accl = accl
        # the facade's long-lived certifier: verdicts cached by
        # certify_concurrent serve admission here and back
        if getattr(accl, "_interference", None) is None:
            accl._interference = InterferenceCertifier()
        self._certifier = accl._interference
        self.tenants = TenantRegistry()
        self.capacity_s = float(capacity_s)
        self._slo_reference = float(slo_reference)
        self._band_factor = float(band_factor)
        self._band_floor = float(band_floor)
        self._slo_floor_s = float(slo_floor_s)
        self._time = time_fn
        self._reg = registry if registry is not None \
            else metrics.get_registry()
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._classes: dict[int, FairQueue] = {}
        self._inflight: dict[int, QueueEntry] = {}
        self._next_seq = 0
        self._cost_cache: dict[str, float] = {}
        self._history: deque = deque(maxlen=max(int(history), 16))
        self.stats = {
            "dispatches": 0,
            "concurrent_dispatches": 0,  # picked with >= 1 in flight
            "certified_concurrent": 0,   # ... under a clean group cert
            "uncertified_concurrent": 0,  # stays 0
            "serialized_admissions": 0,
            "rejected_saturated": 0,
            "max_inflight": 0,
        }

    # -- tenants -----------------------------------------------------------

    def register_tenant(self, name: str, *, priority: int = 1,
                        weight: float = 1.0,
                        slo_budget_s: float | None = None,
                        comm: Any = None) -> Tenant:
        """Admit a tenant (DuplicateTenantError on a reused name). `comm`
        may carry its own communicator (`accl.split`)."""
        return self.tenants.register(name, priority=priority,
                                     weight=weight,
                                     slo_budget_s=slo_budget_s, comm=comm)

    # -- pricing -----------------------------------------------------------

    def predict_cost_s(self, program) -> float:
        """The admission price of one dispatch: the device's
        predict_sequence_cost where it has a calibration, the bytes proxy
        otherwise. Cached per program signature."""
        sig = getattr(program, "signature", None)
        if sig is not None:
            hit = self._cost_cache.get(sig)
            if hit is not None:
                return hit
        cost = None
        prepared = getattr(program, "_prepared", None)
        cclo = getattr(self._accl, "cclo", None)
        if prepared is not None and cclo is not None \
                and hasattr(cclo, "predict_sequence_cost"):
            cost = cclo.predict_sequence_cost(prepared)
        if cost is None and prepared is not None:
            cost = 0.0
            for o in prepared.desc.steps:
                cost += (_FALLBACK_STEP_S
                         + o.count * dtype_nbytes(o.data_type)
                         * _FALLBACK_S_PER_BYTE)
        if cost is None or cost <= 0:
            cost = _FALLBACK_STEP_S
        if sig is not None:
            self._cost_cache[sig] = cost
        return cost

    def slo_deadline_s(self, tenant: Tenant, cost_s: float) -> float:
        """The tenant's per-dispatch budget: its explicit slo_budget_s,
        else predicted * (1 + max(ref*band_factor, ref+band_floor)) +
        floor_s, with the loose unarmed reference until
        `arm_slo_reference` pins a measured one."""
        if tenant.slo_budget_s is not None:
            return tenant.slo_budget_s
        tol = max(self._slo_reference * self._band_factor,
                  self._slo_reference + self._band_floor)
        return cost_s * (1.0 + tol) + self._slo_floor_s

    def arm_slo_reference(self, median_rel_err: float) -> None:
        """Tighten the derived SLO band from a measured residual."""
        self._slo_reference = float(median_rel_err)

    # -- admission ---------------------------------------------------------

    def queued_cost_s(self) -> float:
        with self._mu:
            return self._queued_cost_locked()

    def _queued_cost_locked(self) -> float:
        q = sum(fq.queued_cost() for fq in self._classes.values())
        return q + sum(e.cost_s for e in self._inflight.values())

    def _reject_locked(self, t: Tenant, requested_s: float,
                       queued_s: float) -> SchedulerSaturatedError:
        self.stats["rejected_saturated"] += 1
        self._reg.counter("accl_tenant_rejected_total", tenant=t.name).inc()
        return SchedulerSaturatedError(t.name, requested_s, queued_s,
                                       self.capacity_s)

    def admit_request(self, tenant_name: str,
                      cost_s: float = _FALLBACK_STEP_S) -> None:
        """The serving layer's admission check (DecodeServer.submit):
        SchedulerSaturatedError when `cost_s` more predicted work would
        exceed the capacity. Nothing is queued; the caller owns its
        request queue."""
        t = self.tenants.get(tenant_name)
        with self._mu:
            queued = self._queued_cost_locked()
            if queued + cost_s > self.capacity_s:
                raise self._reject_locked(t, cost_s, queued)

    def submit(self, tenant_name: str, program, *, repeats: int = 1,
               cost_s: float | None = None, **run_kwargs) -> int:
        """Queue `repeats` dispatches of a compiled program for a tenant:
        the backpressure check, then certification against everything
        admitted; an uncertifiable pair queues in serial-fallback mode.
        Returns the number queued. `cost_s` overrides the price."""
        t = self.tenants.get(tenant_name)
        fp = getattr(program, "footprint", None)
        cost = float(cost_s) if cost_s is not None \
            else self.predict_cost_s(program)
        with self._cv:
            queued = self._queued_cost_locked()
            if queued + cost * repeats > self.capacity_s:
                raise self._reject_locked(t, cost * repeats, queued)
            conflicts = set()
            if fp is not None:
                t.record_footprint(fp)
                for other in self._admitted_footprints_locked():
                    if other.signature == fp.signature:
                        continue
                    if self._certifier.check_pair(fp, other):
                        conflicts.add(other.signature)
            serial = fp is None or bool(conflicts)
            if serial:
                self.stats["serialized_admissions"] += repeats
                t.serialized += repeats
                self._reg.counter("accl_tenant_serialized_total",
                                  tenant=t.name).inc(repeats)
            fq = self._classes.setdefault(t.priority, FairQueue())
            now = self._time()
            for _ in range(repeats):
                e = QueueEntry(tenant=t.name, priority=t.priority,
                               program=program, footprint=fp,
                               cost_s=cost, seq=self._next_seq,
                               run_kwargs=dict(run_kwargs),
                               conflicts=frozenset(conflicts),
                               submitted_t=now)
                self._next_seq += 1
                fq.push(t, e)
            t.submitted += repeats
            self._reg.gauge("accl_scheduler_queue_depth").set(
                sum(len(fq) for fq in self._classes.values()))
            self._cv.notify_all()
        return repeats

    def _admitted_footprints_locked(self):
        seen: dict[str, Any] = {}
        for e in self._inflight.values():
            if e.footprint is not None:
                seen.setdefault(e.footprint.signature, e.footprint)
        for fq in self._classes.values():
            for e in fq.entries():
                if e.footprint is not None:
                    seen.setdefault(e.footprint.signature, e.footprint)
        return list(seen.values())

    # -- the concurrency rule ----------------------------------------------

    def _eligible_locked(self, e: QueueEntry) -> bool:
        """May `e` start now, beside the programs in flight? A program
        without a footprint runs alone; a program never overlaps itself;
        otherwise every pair with the in-flight set needs a clean
        verdict."""
        if not self._inflight:
            return True
        if e.footprint is None:
            return False
        for f in self._inflight.values():
            if f.footprint is None:
                return False
            if f.footprint.signature == e.footprint.signature:
                return False
            if (f.footprint.signature in e.conflicts
                    or e.footprint.signature in f.conflicts):
                return False
            if self._certifier.check_pair(e.footprint, f.footprint):
                return False
        return True

    def _take_next_locked(self) -> QueueEntry | None:
        for prio in sorted(self._classes):
            e = self._classes[prio].pop_best(self._eligible_locked)
            if e is not None:
                return e
            if len(self._classes[prio]):
                # strict priority: a blocked higher class does not yield
                # to a lower one (which could otherwise starve it through
                # a conflict)
                return None
        return None

    def _admit_inflight_locked(self, e: QueueEntry) -> str | None:
        """Move a picked entry into the in-flight set and stamp the group
        certificate naming everything it may overlap, itself included.
        Returns the id (None for a program without a footprint)."""
        from ..analysis.interference import certificate_id

        self._inflight[e.seq] = e
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         len(self._inflight))
        if e.footprint is None:
            return None
        fps = {f.footprint.signature: f.footprint
               for f in self._inflight.values() if f.footprint is not None}
        cert = certificate_id(list(fps.values()))
        if len(self._inflight) > 1:
            self.stats["concurrent_dispatches"] += 1
            group = list(fps.values())
            clean = all(not self._certifier.check_pair(a, b)
                        for i, a in enumerate(group) for b in group[i + 1:])
            if clean and len(fps) == len(self._inflight):
                self.stats["certified_concurrent"] += 1
            else:
                # _eligible_locked makes this unreachable; the counter
                # makes a future scheduling fault loud
                self.stats["uncertified_concurrent"] += 1
                self._reg.counter(
                    "accl_scheduler_uncertified_concurrent_total").inc()
        prepared = getattr(e.program, "_prepared", None)
        if prepared is not None:
            prepared.cert = cert
        return cert

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, e: QueueEntry) -> float:
        t0 = self._time()
        try:
            e.program.run(**e.run_kwargs)
        finally:
            t1 = self._time()
            self._account(e, t0, t1)
        return t1 - t0

    def _account(self, e: QueueEntry, t0: float, t1: float) -> None:
        dt = t1 - t0
        tenant = self.tenants.get(e.tenant)
        deadline = self.slo_deadline_s(tenant, e.cost_s)
        missed = dt > deadline
        with self._cv:
            self._inflight.pop(e.seq, None)
            self.stats["dispatches"] += 1
            tenant.dispatched += 1
            tenant.dispatched_cost_s += e.cost_s
            tenant.measured_s += dt
            if missed:
                tenant.slo_misses += 1
            self._history.append((e.tenant, t0, t1, e.cost_s, missed))
            self._reg.gauge("accl_scheduler_queue_depth").set(
                sum(len(fq) for fq in self._classes.values()))
            self._cv.notify_all()
        lbl = dict(tenant=e.tenant, priority=e.priority)
        self._reg.histogram("accl_tenant_dispatch_seconds",
                            **lbl).observe(dt)
        self._reg.histogram("accl_tenant_queue_wait_seconds",
                            tenant=e.tenant).observe(
                                max(t0 - e.submitted_t, 0.0))
        self._reg.counter("accl_tenant_dispatches_total",
                          tenant=e.tenant).inc()
        self._reg.counter("accl_tenant_cost_seconds_total",
                          tenant=e.tenant).inc(e.cost_s)
        # positive: headroom inside the budget; negative: a miss
        self._reg.histogram("accl_tenant_slo_residual_seconds",
                            tenant=e.tenant).observe(deadline - dt)
        if missed:
            self._reg.counter("accl_tenant_slo_miss_total",
                              tenant=e.tenant).inc()

    def step(self) -> bool:
        """Dispatch at most one queued program: the preemption point,
        where class and fair-queue selection run again. False when nothing
        was eligible."""
        with self._cv:
            e = self._take_next_locked()
            if e is None:
                return False
            self._admit_inflight_locked(e)
        self._dispatch(e)
        return True

    def drain(self, workers: int = 1) -> int:
        """Dispatch until the queues are empty; `workers > 1` runs that
        many dispatch loops at once (certified-clean programs overlap,
        serial-fallback entries wait for their conflicts to leave).
        Returns the number of dispatches."""
        n = [0]
        n_mu = threading.Lock()

        def loop() -> None:
            while True:
                with self._cv:
                    e = self._take_next_locked()
                    while e is None:
                        if not any(len(fq)
                                   for fq in self._classes.values()):
                            return
                        # queued work conflicts with the in-flight set:
                        # wait for a completion
                        self._cv.wait(timeout=0.05)
                        e = self._take_next_locked()
                    self._admit_inflight_locked(e)
                self._dispatch(e)
                with n_mu:
                    n[0] += 1

        k = max(int(workers), 1)
        if k == 1:
            loop()
            return n[0]
        errors: list[BaseException] = []

        def worker() -> None:
            try:
                loop()
            except BaseException as exc:  # read after the join
                errors.append(exc)

        threads = [threading.Thread(target=worker, name=f"accl-sched-{i}")
                   for i in range(k)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return n[0]

    def dispatch_now(self, tenant_name: str, program,
                     **run_kwargs) -> float:
        """Metered immediate dispatch for a latency-critical caller (the
        DecodeServer step): it skips the queues but keeps the concurrency
        rule (waits until eligible beside the in-flight set, joins it
        under the group certificate) and is accounted like a queued
        dispatch. Returns the measured seconds."""
        t = self.tenants.get(tenant_name)
        fp = getattr(program, "footprint", None)
        cost = self.predict_cost_s(program)
        e = QueueEntry(tenant=t.name, priority=t.priority,
                       program=program, footprint=fp, cost_s=cost,
                       seq=-1, run_kwargs=dict(run_kwargs),
                       submitted_t=self._time())
        with self._cv:
            e.seq = self._next_seq
            self._next_seq += 1
            t.submitted += 1
            while not self._eligible_locked(e):
                self._cv.wait(timeout=0.05)
            self._admit_inflight_locked(e)
        return self._dispatch(e)

    # -- accounting --------------------------------------------------------

    def noisy_neighbor_report(self, *, lookback_s: float = 0.25
                              ) -> list[dict[str, Any]]:
        """For each tenant with SLO misses, which other tenant's
        dispatched cost overlapped the missed windows most (each window
        starts `lookback_s` before its miss). The drift sentinel's
        straggler attribution rides along when it has data."""
        with self._mu:
            hist = list(self._history)
        out: list[dict[str, Any]] = []
        by_tenant: dict[str, list[tuple[float, float]]] = {}
        for tn, t0, t1, _, missed in hist:
            if missed:
                by_tenant.setdefault(tn, []).append((t0 - lookback_s, t1))
        for tn in sorted(by_tenant):
            windows = by_tenant[tn]
            blame: dict[str, float] = {}
            for other, o0, o1, cost, _ in hist:
                if other == tn:
                    continue
                for w0, w1 in windows:
                    if o0 < w1 and o1 > w0:  # wall-clock overlap
                        blame[other] = blame.get(other, 0.0) + cost
                        break
            row: dict[str, Any] = {
                "tenant": tn,
                "slo_misses": len(windows),
                "neighbor_cost_s": dict(sorted(blame.items())),
            }
            if blame:
                suspect = max(blame, key=lambda k: blame[k])
                row["noisy_neighbor"] = suspect
                row["neighbor_share"] = (blame[suspect]
                                         / sum(blame.values()))
            out.append(row)
        stragglers = metrics.get_sentinel().straggler_report()
        if stragglers:
            for row in out:
                row["stragglers"] = stragglers
        return out

    def report(self) -> dict[str, Any]:
        """Scheduler stats, per-tenant accounting, namespace disjointness
        and the noisy-neighbour attribution, as one JSON-ready block."""
        with self._mu:
            stats = dict(self.stats)
            queued = sum(len(fq) for fq in self._classes.values())
        return {
            "capacity_s": self.capacity_s,
            "queued": queued,
            "stats": stats,
            "tenants": {t.name: t.account()
                        for t in self.tenants.tenants()},
            "namespaces": self.tenants.disjointness_report(),
            "noisy_neighbors": self.noisy_neighbor_report(),
        }
