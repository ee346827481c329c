"""QoS: weighted fair queueing over predicted cost, strict priority
classes, preemption at program boundaries.

Counterpart of accl_tpu/scheduler/qos.py. The unit the scheduler
arbitrates is one SequenceProgram dispatch, the unit the interference
certifier proves order-equivalent, so reordering dispatches for fairness
never changes a result. Within a priority class the queue is start-time
fair queueing (SFQ) over predicted seconds:

    S(e) = max(V, F_prev(tenant))     # start tag at enqueue
    F(e) = S(e) + cost_s / weight     # finish tag; F_prev := F(e)

dispatch takes the eligible head with the smallest finish tag and moves
the class's virtual time V to its start tag, so each backlogged tenant's
dispatched cost tracks its weight. Across classes priority is strict, and
selection runs again before every dispatch: a newly arrived class-0 entry
wins the next boundary, and nothing interrupts a program in flight.

Eligibility is the caller's predicate: the scheduler passes its
concurrency rule (an entry that conflicts with a program in flight waits,
while clean entries overtake it).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Iterable

from .tenant import Tenant


@dataclasses.dataclass
class QueueEntry:
    """One queued program dispatch."""

    tenant: str
    priority: int
    program: Any  # SequenceProgram (or any handle with .run(**kwargs))
    footprint: Any  # the program's ProgramFootprint
    cost_s: float  # predicted seconds (the fair queue's currency)
    seq: int  # global FIFO tiebreak
    run_kwargs: dict = dataclasses.field(default_factory=dict)
    start_tag: float = 0.0
    finish_tag: float = 0.0
    # signatures this entry may not overlap (unclean pairwise verdicts at
    # admission: serial fallback)
    conflicts: frozenset = frozenset()
    submitted_t: float = 0.0


class FairQueue:
    """One priority class's SFQ state: per-tenant FIFOs and the virtual
    time. Not thread-safe: the scheduler holds its lock around it."""

    def __init__(self) -> None:
        self.virtual_time = 0.0
        self._fifos: dict[str, deque[QueueEntry]] = {}

    def push(self, tenant: Tenant, entry: QueueEntry) -> None:
        entry.start_tag = max(self.virtual_time, tenant.finish_tag)
        entry.finish_tag = (entry.start_tag
                            + entry.cost_s / tenant.weight)
        tenant.finish_tag = entry.finish_tag
        self._fifos.setdefault(entry.tenant, deque()).append(entry)

    def pop_best(self, eligible: Callable[[QueueEntry], bool]
                 ) -> QueueEntry | None:
        """Remove and return the eligible head with the smallest (finish
        tag, seq); None when no head is eligible. Heads only: a tenant's
        FIFO order is part of its programs' semantics."""
        best: QueueEntry | None = None
        for fifo in self._fifos.values():
            if not fifo:
                continue
            head = fifo[0]
            if not eligible(head):
                continue
            if (best is None
                    or (head.finish_tag, head.seq)
                    < (best.finish_tag, best.seq)):
                best = head
        if best is None:
            return None
        self._fifos[best.tenant].popleft()
        self.virtual_time = max(self.virtual_time, best.start_tag)
        return best

    def __len__(self) -> int:
        return sum(len(f) for f in self._fifos.values())

    def queued_cost(self) -> float:
        return sum(e.cost_s for f in self._fifos.values() for e in f)

    def entries(self) -> Iterable[QueueEntry]:
        for fifo in self._fifos.values():
            yield from fifo
