"""Overlap-slot analysis: collective_id liveness over a slot timeline.

Counterpart of accl_tpu/analysis/slots.py. The reference's segmented
Pallas ring owns a few independent semaphore/comm-buffer sets keyed by
collective_id; the lowering double-buffers segments across those slots
and orders only slot REUSE. Two kernel instances that share a
collective_id while both live would cross-talk on the shared
semaphores. `check_slots` checks a timeline of such instances and the
ordering edges between them from scratch:

  ACCL301 slot-collision   two instances share a slot with no ordering
                           path between them
  ACCL302 slot-overcommit  the overlap window claims more concurrent
                           instances than the kernel has slot resources
                           (or a slot id outside the kernel's range)

The port's ring kernel holds no slots: a segment is one launch that
owns no semaphores beyond its own, and launches on one CUDA stream run
in issue order. So `ring_slot_timeline` gives the port's batches a
timeline with no instances, which `check_slots` passes; the check stays
for hand-built timelines (the lint corpus's `slots` fixtures).
"""

from __future__ import annotations

import dataclasses

from .diagnostics import Diagnostic, make

__all__ = [
    "SlotInstance",
    "SlotTimeline",
    "check_slots",
    "ring_slot_timeline",
]

# the reference's cap on a built timeline's instances (a periodic slot
# pattern adds nothing past one period); the port's timelines are empty
MAX_INSTANCES = 256


@dataclasses.dataclass(frozen=True)
class SlotInstance:
    """One kernel launch: (step, segment) holding slot `slot`."""

    step: int
    segment: int
    slot: int


@dataclasses.dataclass
class SlotTimeline:
    """A batch's kernel launches in issue order plus the ordering edges
    (indices into `instances`) the program graph enforces."""

    num_slots: int
    instances: list[SlotInstance]
    deps: set[tuple[int, int]]
    truncated: bool = False


def ring_slot_timeline(
    steps,
    world: int,
    *,
    overlap: bool = True,
    num_slots: int | None = None,
    max_seg_bytes: int | None = None,
) -> SlotTimeline:
    """The slot timeline a descriptor batch executes on the port: no
    instances, since its ring kernel holds no slots (module docstring).
    `num_slots` defaults to 1 so the timeline is well formed."""
    return SlotTimeline(1 if num_slots is None else num_slots, [], set())


def check_slots(timeline: SlotTimeline) -> list[Diagnostic]:
    """Verify no two unordered instances share a collective_id slot and
    every slot id fits the kernel's resources."""
    diags: list[Diagnostic] = []
    n = len(timeline.instances)
    if timeline.num_slots < 1:
        diags.append(make("ACCL302",
                          f"kernel exposes {timeline.num_slots} slots"))
        return diags
    for i, inst in enumerate(timeline.instances):
        if not 0 <= inst.slot < timeline.num_slots:
            diags.append(make(
                "ACCL302",
                f"instance (step {inst.step}, segment {inst.segment}) "
                f"claims slot {inst.slot} of a {timeline.num_slots}-slot "
                "kernel", step=inst.step))
    if any(d.code == "ACCL302" for d in diags):
        return diags

    # transitive closure over ordering edges (instance count is capped)
    succ: list[set[int]] = [set() for _ in range(n)]
    for a, b in timeline.deps:
        if 0 <= a < n and 0 <= b < n:
            succ[a].add(b)
    reach: list[set[int]] = [set() for _ in range(n)]
    order = _topo_order(n, succ)
    if order is None:
        # an ordering cycle means the timeline itself is malformed;
        # report instead of looping
        diags.append(make("ACCL301",
                          "ordering edges form a cycle: timeline invalid"))
        return diags
    for i in reversed(order):
        for j in succ[i]:
            reach[i].add(j)
            reach[i] |= reach[j]

    by_slot: dict[int, list[int]] = {}
    for i, inst in enumerate(timeline.instances):
        by_slot.setdefault(inst.slot, []).append(i)
    for slot, idxs in sorted(by_slot.items()):
        for x in range(len(idxs)):
            for y in range(x + 1, len(idxs)):
                a, b = idxs[x], idxs[y]
                if b not in reach[a] and a not in reach[b]:
                    ia, ib = timeline.instances[a], timeline.instances[b]
                    diags.append(make(
                        "ACCL301",
                        f"(step {ia.step}, segment {ia.segment}) and "
                        f"(step {ib.step}, segment {ib.segment}) both "
                        f"hold collective_id slot {slot} with no "
                        "ordering between them: concurrent instances "
                        "would cross-talk on the slot's semaphores",
                        step=ib.step))
    return diags


def _topo_order(n: int, succ) -> list[int] | None:
    indeg = [0] * n
    for i in range(n):
        for j in succ[i]:
            indeg[j] += 1
    queue = [i for i in range(n) if indeg[i] == 0]
    order: list[int] = []
    while queue:
        i = queue.pop()
        order.append(i)
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                queue.append(j)
    return order if len(order) == n else None
