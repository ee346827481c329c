"""Cross-program interference certifier: compositional non-interference
proofs for CONCURRENT SequencePrograms.

Counterpart of accl_tpu/analysis/interference.py. Every other certifier
in this package reasons about ONE descriptor batch at a time; admitting
N tenants' pre-certified programs for concurrent dispatch needs more,
and a whole-product model check over N programs is exponentially
infeasible. This module proves statically that ANY interleaving of a
set of certified programs is equivalent to their serial composition,
so a scheduler admits tenants by checking certificates (O(N^2) over
small summaries), not by re-model-checking the product.

Two tiers:

* Summary tier. At `SequenceRecorder.compile()` time each program gets
  a `ProgramFootprint`: exact read/write address prefixes through the
  canonical access model (`sequencer.sequence.step_accesses`), the
  persistent-buffer set, communicator ids, coarse per-communicator tag
  ranges (incl. wildcard flags), collective-id ring slots from the
  slot-liveness pass, and stream endpoints. Pairwise checks over
  footprints are EXACT for the resource classes:

    ACCL601  write/write or read/write region overlap (arena addresses
             are unique, every access is a prefix at offset 0, so a
             shared address with a writer IS an overlap); shared
             stream endpoints report here too (a stream is a stateful
             FIFO with no cross-program ordering)
    ACCL603  collective-id ring-slot intersection (the slots are a
             global kernel resource; nothing orders two programs'
             launches). The port's ring kernel holds no slots, so its
             own programs' footprints carry none; hand-built or shipped
             footprints with `ring_slots` are still checked.
    ACCL604  a footprint that could not be lifted or composed: loud,
             never a silent pass

* Escalation tier. Tag summaries are deliberately COARSE (ranges +
  wildcard flags), so a tag-range overlap on a shared communicator is
  only a MAY-interfere verdict: exactly those pairs escalate to a
  bounded cross-program product model check that reuses the
  ACCL205-207 explorer (modelcheck.py) over the per-rank concatenation
  of both programs, in BOTH orders. The exact cross-matching relation
  (a send of one program `_compatible` with a recv of the other,
  wildcards included) either refutes the summary overlap (the pair
  certifies clean) or confirms it as ACCL602 with the offending match
  pair rendered. Budget truncation surfaces as ACCL207, loud.

Tag namespaces: hop-derived programs (a prepared sequence, one
composed program on the card) carry SYNTHETIC tags: their hops match
inside one program and no matching engine is shared between two
separately prepared programs, so synthetic traffic is program-private
(`synthetic_tags=True`). Real descriptor-chain tags (a native
executor's shared matching engine) DO share the wire; only pairs where
both sides carry real tags can cross-match, and in a composed product
any synthetic tags are namespaced per program (`_PROGRAM_TAG_STRIDE`)
while TAG_ANY keeps piercing every namespace.

Verdicts are cached per pair, keyed by the two footprint signatures
(order-normalized), so an admission loop re-checking a stable tenant
set pays dict lookups. The cache is LRU-BOUNDED
(``ACCL_INTERFERENCE_CACHE_CAP``, default 4096 pairs): evicting a
verdict only costs the recheck, since verdicts are pure functions of
the two footprints. `InterferenceCertifier.escalations` counts pairs
that needed the product model check; the summary-only fast path is
provable by asserting it stayed at zero.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import Callable, Iterable, Sequence

from ..constants import TAG_ANY
from .diagnostics import Diagnostic, make
from .modelcheck import Budget, check_interleavings
from .protocol import ANY_SRC, Event, _src_matches, _tags_match

__all__ = [
    "TrafficSummary",
    "ProgramFootprint",
    "InterferenceCertifier",
    "footprint_from_steps",
    "footprint_from_rank_programs",
    "product_programs",
    "certify_concurrent",
    "certificate_id",
]

# Tag offset separating one program's SYNTHETIC hop tags from another's
# in a composed product: hop tags are step * _STEP_TAG_STRIDE + hop
# (protocol.py), far below this, and real tags never get offset.
_PROGRAM_TAG_STRIDE = 1 << 24

# Default bound on the per-pair verdict cache: 4096 pairs covers a
# ~90-program stable working set (N*(N-1)/2) while keeping a churning
# multi-tenant admission loop O(1) in memory.
DEFAULT_VERDICT_CACHE_CAP = 4096


def _verdict_cache_cap() -> int:
    """The env-tunable cache bound (ACCL_INTERFERENCE_CACHE_CAP);
    clamped to >= 1 so the live pair can always be cached."""
    raw = os.environ.get("ACCL_INTERFERENCE_CACHE_CAP", "")
    try:
        cap = int(raw) if raw else DEFAULT_VERDICT_CACHE_CAP
    except ValueError:
        cap = DEFAULT_VERDICT_CACHE_CAP
    return max(cap, 1)


@dataclasses.dataclass(frozen=True)
class TrafficSummary:
    """Coarse per-communicator endpoint-traffic summary of one program:
    inclusive tag ranges over the exact-tag sends/recvs plus wildcard
    flags. Deliberately lossy — refining a range overlap into an exact
    cross-match verdict is the escalation tier's job."""

    comm: int
    send_tags: tuple[int, int] | None  # (lo, hi) over exact-tag sends
    recv_tags: tuple[int, int] | None
    send_any: bool  # a TAG_ANY send exists
    recv_any: bool  # a TAG_ANY recv exists
    any_src: bool  # an any-source recv exists
    n_sends: int
    n_recvs: int

    def sends_match_recvs(self, other: "TrafficSummary") -> bool:
        """Can SOME send of self match SOME recv of `other`? Coarse:
        range intersection or either-side wildcard."""
        if self.n_sends == 0 or other.n_recvs == 0:
            return False
        if self.send_any or other.recv_any:
            return True
        if self.send_tags is None or other.recv_tags is None:
            return False
        return (self.send_tags[0] <= other.recv_tags[1]
                and other.recv_tags[0] <= self.send_tags[1])


@dataclasses.dataclass(frozen=True)
class ProgramFootprint:
    """One program's interference summary (see module docstring).
    `reads`/`writes` are (arena address, prefix element count) pairs;
    `rank_events` is a lazy thunk producing the program's exact
    per-rank event programs: only the escalation tier forces it, so
    footprint extraction never pays for recording a schedule body."""

    label: str
    world: int
    signature: str  # composite-signature digest: the cache key half
    comms: frozenset[int]
    reads: tuple[tuple[int, int], ...]
    writes: tuple[tuple[int, int], ...]
    persistent: frozenset[int]
    ring_slots: frozenset[int]
    streams: frozenset[int]
    traffic: tuple[TrafficSummary, ...]
    colls: frozenset[tuple[str, int, int]]  # (op, count, comm)
    synthetic_tags: bool
    unliftable: str | None = None
    rank_events: Callable[[], list[list[Event]]] | None = \
        dataclasses.field(default=None, compare=False, repr=False)

    def traffic_on(self, comm: int) -> TrafficSummary | None:
        for t in self.traffic:
            if t.comm == comm:
                return t
        return None

    def events(self) -> list[list[Event]]:
        """Force the exact per-rank event programs (escalation only)."""
        if self.rank_events is None:
            raise RuntimeError(
                f"footprint {self.label!r} carries no per-rank event "
                "programs (extracted without plans)")
        return self.rank_events()


def _digest(payload: object) -> str:
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]


def _merge_prefixes(
        acc: dict[int, int], pairs: Iterable[tuple[int, int]]) -> None:
    for addr, elems in pairs:
        acc[addr] = max(acc.get(addr, 0), elems)


def footprint_from_steps(
    steps: Sequence[object],
    world: int,
    *,
    persistent: frozenset[int] = frozenset(),
    use_pallas_ring: bool = False,
    pallas_ring_overlap: bool = True,
    plans: tuple[object, ...] | None = None,
    axis_name: str = "ccl",
    label: str = "",
    signature: str | None = None,
) -> ProgramFootprint:
    """Lift a recorded descriptor batch into its footprint: pure
    Python over the descriptors plus (under a slot-keyed ring) the slot
    timeline mirror; never records a schedule body. Any extraction
    failure returns
    an `unliftable` footprint that rejects loudly (ACCL604) instead of
    raising — inability must never read as certified. `plans` (one per
    step) arms the lazy exact-event thunk the escalation tier uses.

    `signature` is the program's COMPOSITE signature (the canonically
    renamed batch digest, the compile-cache key). It cannot serve as
    the interference-cache key alone: the canonical renaming erases
    WHICH buffers the program binds, and two same-shape programs over
    different buffers must never alias an interference verdict — so the
    footprint's own `signature` extends it with a digest over the
    concrete resources (addresses, streams, slots, communicators).

    `use_pallas_ring`/`pallas_ring_overlap` are the reference's slot
    switches: the port's ring slot timeline is empty (slots.py), so its
    footprints carry no ring slots either way."""
    if signature is not None:
        base = signature
    else:
        try:
            base = _digest(
                (world, tuple(getattr(o, "signature")() for o in steps)))
        except Exception:
            # even the identity digest can fail on alien step objects;
            # such a footprint is unliftable below, and all unliftable
            # pairs reject identically (ACCL604), so a label-keyed
            # fallback cannot alias a VERDICT, only a rejection
            base = _digest((world, label, "unsigned"))
    try:
        reads: dict[int, int] = {}
        writes: dict[int, int] = {}
        comms: set[int] = set()
        streams: set[int] = set()
        from ..sequencer.sequence import step_accesses

        for opts in steps:
            r, w = step_accesses(opts, world)
            _merge_prefixes(reads, r)
            _merge_prefixes(writes, w)
            comms.add(int(getattr(opts, "comm_addr")))
            for sid in (getattr(opts, "op0_stream_id", 0),
                        getattr(opts, "res_stream_id", 0)):
                if sid:
                    streams.add(int(sid))
        ring_slots: frozenset[int] = frozenset()
        if use_pallas_ring:
            from .slots import ring_slot_timeline

            timeline = ring_slot_timeline(steps, world,
                                          overlap=pallas_ring_overlap)
            ring_slots = frozenset(i.slot for i in timeline.instances)
        thunk: Callable[[], list[list[Event]]] | None = None
        if plans is not None:
            steps_t = tuple(steps)
            plans_t = tuple(plans)
            cache: list[list[list[Event]]] = []

            def thunk() -> list[list[Event]]:
                if not cache:
                    from .protocol import batch_rank_programs

                    cache.append(batch_rank_programs(
                        list(steps_t), list(plans_t), world, axis_name))
                return cache[0]

        reads_t = tuple(sorted(reads.items()))
        writes_t = tuple(sorted(writes.items()))
        sig = _digest((base, world, reads_t, writes_t,
                       tuple(sorted(ring_slots)),
                       tuple(sorted(streams)), tuple(sorted(comms)),
                       tuple(sorted(persistent))))
        return ProgramFootprint(
            label=label or sig[:8], world=world, signature=sig,
            comms=frozenset(comms),
            reads=reads_t,
            writes=writes_t,
            persistent=frozenset(persistent),
            ring_slots=ring_slots,
            streams=frozenset(streams),
            # a prepared sequence's wire matching is internal to its one
            # composed program: no tags or collectives share a matching
            # engine with another program
            traffic=(), colls=frozenset(), synthetic_tags=True,
            rank_events=thunk,
        )
    except Exception as e:  # loud, never silent (ACCL604)
        return ProgramFootprint(
            label=label or base[:8], world=world,
            signature=_digest((base, "unliftable")),
            comms=frozenset(), reads=(), writes=(),
            persistent=frozenset(), ring_slots=frozenset(),
            streams=frozenset(), traffic=(), colls=frozenset(),
            synthetic_tags=True,
            unliftable=f"{type(e).__name__}: {e}")


def footprint_from_rank_programs(
    programs: Sequence[Sequence[Event]],
    world: int,
    *,
    label: str = "",
    signature: str | None = None,
) -> ProgramFootprint:
    """Lift per-rank event programs (the native executor's descriptor
    chains) into a footprint. These carry REAL tags on the shared
    matching engine — `synthetic_tags=False` — so the traffic checks
    apply; they carry no address information (the native chains bind
    per-rank buffers the event model does not see), so the memory tier
    is vacuous for them by construction."""
    progs = [list(p) for p in programs]
    sig = signature if signature is not None else _digest((world, progs))
    name = label or sig[:8]
    per_comm: dict[int, dict[str, object]] = {}
    colls: set[tuple[str, int, int]] = set()
    for prog in progs:
        for ev in prog:
            if ev.kind == "coll":
                colls.add((ev.op, ev.count, ev.comm))
                continue
            if ev.kind not in ("send", "recv"):
                continue
            t = per_comm.setdefault(ev.comm, {
                "s_lo": None, "s_hi": None, "r_lo": None, "r_hi": None,
                "s_any": False, "r_any": False, "any_src": False,
                "ns": 0, "nr": 0})
            if ev.kind == "send":
                t["ns"] = int(t["ns"]) + 1  # type: ignore[call-overload]
                if ev.tag == TAG_ANY:
                    t["s_any"] = True
                else:
                    lo, hi = t["s_lo"], t["s_hi"]
                    t["s_lo"] = ev.tag if lo is None \
                        else min(int(lo), ev.tag)  # type: ignore[arg-type]
                    t["s_hi"] = ev.tag if hi is None \
                        else max(int(hi), ev.tag)  # type: ignore[arg-type]
            else:
                t["nr"] = int(t["nr"]) + 1  # type: ignore[call-overload]
                if ev.peer == ANY_SRC:
                    t["any_src"] = True
                if ev.tag == TAG_ANY:
                    t["r_any"] = True
                else:
                    lo, hi = t["r_lo"], t["r_hi"]
                    t["r_lo"] = ev.tag if lo is None \
                        else min(int(lo), ev.tag)  # type: ignore[arg-type]
                    t["r_hi"] = ev.tag if hi is None \
                        else max(int(hi), ev.tag)  # type: ignore[arg-type]
    traffic = tuple(
        TrafficSummary(
            comm=comm,
            send_tags=(None if t["s_lo"] is None
                       else (int(t["s_lo"]), int(t["s_hi"]))),  # type: ignore[arg-type]
            recv_tags=(None if t["r_lo"] is None
                       else (int(t["r_lo"]), int(t["r_hi"]))),  # type: ignore[arg-type]
            send_any=bool(t["s_any"]), recv_any=bool(t["r_any"]),
            any_src=bool(t["any_src"]),
            n_sends=int(t["ns"]), n_recvs=int(t["nr"]))  # type: ignore[arg-type]
        for comm, t in sorted(per_comm.items()))
    return ProgramFootprint(
        label=name, world=world, signature=sig,
        comms=frozenset(per_comm) | {c for _, _, c in colls},
        reads=(), writes=(), persistent=frozenset(),
        ring_slots=frozenset(), streams=frozenset(),
        traffic=traffic, colls=frozenset(colls), synthetic_tags=False,
        rank_events=lambda: [list(p) for p in progs],
    )


def certificate_id(footprints: Sequence[ProgramFootprint]) -> str:
    """The certificate naming a pairwise-clean SET: a digest over the
    member signatures, order-independent — what the dispatch spans
    carry so the flight recorder can name the admitted tenant set."""
    return _digest(tuple(sorted(f.signature for f in footprints)))


def _fmt_end(prog: str, r: int, i: int, ev: Event) -> str:
    tag = "ANY" if ev.tag == TAG_ANY else str(ev.tag)
    peer = "ANY" if ev.peer == ANY_SRC else str(ev.peer)
    role = "->" if ev.kind == "send" else "<-"
    return (f"{prog} r{r}:{ev.kind}#{i}({role}r{peer}, tag {tag}, "
            f"comm {ev.comm:#x})")


def product_programs(
    a: list[list[Event]], b: list[list[Event]],
    *, a_synthetic: bool, b_synthetic: bool,
) -> list[list[Event]]:
    """The per-rank concatenation a_r + b_r the product model check
    explores, with SYNTHETIC tags namespaced per program (TAG_ANY stays
    wild: a wildcard pierces any namespace). Real tags are left alone —
    the shared wire is exactly what the product must model."""

    def shift(ev: Event, base: int) -> Event:
        if base == 0 or ev.kind == "coll" or ev.tag == TAG_ANY:
            return ev
        return dataclasses.replace(ev, tag=ev.tag + base)

    base_a = _PROGRAM_TAG_STRIDE if a_synthetic else 0
    base_b = 2 * _PROGRAM_TAG_STRIDE if b_synthetic else 0
    return [
        [shift(ev, base_a) for ev in ra] + [shift(ev, base_b) for ev in rb]
        for ra, rb in zip(a, b)
    ]


def _cross_matches(
    a: list[list[Event]], b: list[list[Event]],
    la: str, lb: str,
) -> list[str]:
    """The exact cross-program matching relation: every send occurrence
    of one program `_compatible` with a recv occurrence of the OTHER
    (same peer/comm, tags match incl. wildcards — protocol.py's own
    predicates, so the two layers cannot drift), plus cross-joinable
    collectives (equal (op, count, comm) signatures across programs).
    Returns rendered pairs; empty = the programs provably cannot
    exchange a single message, and any interleaving is equivalent to
    their serial composition."""
    pairs: list[str] = []

    def one_way(src: list[list[Event]], dst: list[list[Event]],
                ls: str, ld: str) -> None:
        for r, prog in enumerate(src):
            for i, sev in enumerate(prog):
                if sev.kind != "send":
                    continue
                d = sev.peer
                if not 0 <= d < len(dst):
                    continue
                for j, rev in enumerate(dst[d]):
                    if (rev.kind == "recv" and _src_matches(r, rev)
                            and rev.comm == sev.comm
                            and _tags_match(sev.tag, rev.tag)):
                        pairs.append(
                            f"{_fmt_end(ls, r, i, sev)} matchable by "
                            f"{_fmt_end(ld, d, j, rev)}")

    one_way(a, b, la, lb)
    one_way(b, a, lb, la)
    sigs_a = {(ev.op, ev.count, ev.comm)
              for prog in a for ev in prog if ev.kind == "coll"}
    sigs_b = {(ev.op, ev.count, ev.comm)
              for prog in b for ev in prog if ev.kind == "coll"}
    for op, count, comm in sorted(sigs_a & sigs_b):
        pairs.append(
            f"{la} and {lb} both join coll {op}(count {count}, comm "
            f"{comm:#x}): a barrier release can mix the two programs' "
            "arrivals")
    return pairs


class InterferenceCertifier:
    """Pairwise non-interference over footprints, with a per-pair
    verdict cache keyed by the two composite signatures
    (order-normalized: check(A, B) and check(B, A) share one entry).
    `escalations` counts cache-miss pairs that needed the product model
    check; `pairs_checked` counts cache misses total — a summary-only
    run is `escalations == 0`.

    The cache is LRU-bounded at `cache_cap` pairs (default from
    ``ACCL_INTERFERENCE_CACHE_CAP``, else 4096): an admission-control
    certifier outlives any one tenant set, and under churn the pair
    universe grows without limit. A hit refreshes the entry's recency;
    storing past the cap evicts the least-recently-used verdict
    (`cache_evictions` counts them). Eviction only ever costs a
    recompute — verdicts are pure functions of the two footprints, so
    a re-checked evicted pair gets the identical verdict back."""

    def __init__(self, budget: Budget | None = None,
                 cache_cap: int | None = None):
        self.budget = budget or Budget()
        self.cache_cap = (max(int(cache_cap), 1)
                          if cache_cap is not None
                          else _verdict_cache_cap())
        self._cache: OrderedDict[tuple[str, str],
                                 tuple[Diagnostic, ...]] = OrderedDict()
        self.escalations = 0
        self.pairs_checked = 0
        self.cache_evictions = 0

    # -- summary tier -------------------------------------------------

    def _memory_diags(self, a: ProgramFootprint,
                      b: ProgramFootprint) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        pair = f"[{a.label} x {b.label}]"
        reads_a, writes_a = dict(a.reads), dict(a.writes)
        reads_b, writes_b = dict(b.reads), dict(b.writes)
        seen: set[int] = set()
        for addr in sorted(writes_a.keys() | writes_b.keys()):
            wa, wb = addr in writes_a, addr in writes_b
            ra, rb = addr in reads_a, addr in reads_b
            if not ((wa and (wb or rb)) or (wb and (wa or ra))):
                continue
            if addr in seen:
                continue
            seen.add(addr)
            kind = "write/write" if wa and wb else "write/read"
            persist = (" (declared persistent — cross-program sharing "
                       "is still unordered)"
                       if addr in a.persistent | b.persistent else "")
            ea = max(writes_a.get(addr, 0), reads_a.get(addr, 0))
            eb = max(writes_b.get(addr, 0), reads_b.get(addr, 0))
            diags.append(make(
                "ACCL601",
                f"{pair} {kind} overlap on buffer {addr:#x}: "
                f"{a.label} touches [0, {ea}) and {b.label} touches "
                f"[0, {eb}) with no cross-program ordering{persist}"))
        for sid in sorted(a.streams & b.streams):
            diags.append(make(
                "ACCL601",
                f"{pair} both programs ride stream endpoint {sid}: a "
                "stream is a stateful FIFO, and concurrent dispatch "
                "interleaves the two programs' traffic through it"))
        return diags

    def _slot_diags(self, a: ProgramFootprint,
                    b: ProgramFootprint) -> list[Diagnostic]:
        shared = sorted(a.ring_slots & b.ring_slots)
        if not shared:
            return []
        return [make(
            "ACCL603",
            f"[{a.label} x {b.label}] both programs launch ring kernels "
            f"holding collective_id slot(s) {shared}: the slots are a "
            "global kernel resource and nothing orders the two "
            "programs' instances")]

    def _traffic_may_interfere(self, a: ProgramFootprint,
                               b: ProgramFootprint) -> bool:
        """Does the COARSE summary admit a cross-program message?
        Synthetic (hop-derived) traffic is program-private — only
        real-tag programs share the native matching engine."""
        if a.synthetic_tags or b.synthetic_tags:
            return False
        if a.colls & b.colls:
            return True
        for comm in sorted(a.comms & b.comms):
            ta, tb = a.traffic_on(comm), b.traffic_on(comm)
            if ta is None or tb is None:
                continue
            if ta.sends_match_recvs(tb) or tb.sends_match_recvs(ta):
                return True
        return False

    # -- escalation tier ----------------------------------------------

    def _escalate(self, a: ProgramFootprint,
                  b: ProgramFootprint) -> list[Diagnostic]:
        pair = f"[{a.label} x {b.label}]"
        if a.world != b.world:
            return [make(
                "ACCL604",
                f"{pair} traffic summaries overlap but the programs "
                f"span different worlds ({a.world} vs {b.world}): the "
                "product cannot be composed — UNVERIFIED")]
        try:
            ev_a, ev_b = a.events(), b.events()
        except Exception as e:
            return [make(
                "ACCL604",
                f"{pair} traffic summaries overlap and the pair needs "
                f"the product model check, but exact event programs "
                f"are unavailable ({e}) — UNVERIFIED")]
        cross = _cross_matches(ev_a, ev_b, a.label, b.label)
        if cross:
            shown = "\n    ".join(cross[:3])
            more = (f"\n    ... and {len(cross) - 3} more"
                    if len(cross) > 3 else "")
            return [make(
                "ACCL602",
                f"{pair} cross-program match on a shared communicator "
                f"— one program's traffic can steal the other's:\n    "
                f"{shown}{more}")]
        # no cross-compatible endpoint pair exists: certify the product
        # over every match order anyway (bounded, both concatenation
        # orders), so the refutation is a model-checked verdict, not
        # just a static argument. Truncation stays loud.
        diags: list[Diagnostic] = []
        for first, second, order in ((ev_a, ev_b, f"{a.label};{b.label}"),
                                     (ev_b, ev_a, f"{b.label};{a.label}")):
            prod = product_programs(
                first, second,
                a_synthetic=a.synthetic_tags if first is ev_a
                else b.synthetic_tags,
                b_synthetic=b.synthetic_tags if second is ev_b
                else a.synthetic_tags)
            for sem in ("rendezvous", "buffered"):
                res = check_interleavings(prod, semantics=sem,
                                          budget=self.budget)
                if res.truncated:
                    diags.append(make(
                        "ACCL207",
                        f"{pair} product exploration ({order}, {sem}) "
                        f"truncated after {res.states} states: "
                        "interleavings beyond the explored prefix are "
                        "UNVERIFIED"))
                if res.stuck_trace is not None:
                    steps = "\n    ".join(res.stuck_trace) \
                        or "(no matches)"
                    diags.append(make(
                        "ACCL602",
                        f"{pair} the {order} product reaches a stuck "
                        f"state under {sem} semantics although both "
                        f"programs certify alone:\n    {steps}\n  "
                        f"stuck at [{res.stuck_state}]"))
        return diags

    # -- the pairwise verdict -----------------------------------------

    def check_pair(self, a: ProgramFootprint,
                   b: ProgramFootprint) -> tuple[Diagnostic, ...]:
        """Certify one pair; cached by the order-normalized signature
        pair (messages render the labels the pair was FIRST checked
        under)."""
        lo, hi = sorted((a.signature, b.signature))
        key = (lo, hi)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)  # LRU refresh
            return hit
        self.pairs_checked += 1
        diags: list[Diagnostic]
        if a.unliftable is not None or b.unliftable is not None:
            bad = a if a.unliftable is not None else b
            diags = [make(
                "ACCL604",
                f"[{a.label} x {b.label}] footprint of {bad.label} "
                f"could not be lifted ({bad.unliftable}): the pair is "
                "UNVERIFIED")]
        else:
            diags = self._memory_diags(a, b)
            diags += self._slot_diags(a, b)
            if self._traffic_may_interfere(a, b):
                self.escalations += 1
                diags += self._escalate(a, b)
        verdict = tuple(diags)
        self._cache[key] = verdict
        while len(self._cache) > self.cache_cap:
            self._cache.popitem(last=False)
            self.cache_evictions += 1
        return verdict

    def certify(self, footprints: Sequence[ProgramFootprint]
                ) -> list[Diagnostic]:
        """The O(N^2) admission check: every unordered pair of the set,
        summaries first, escalating only on a summary overlap. A clean
        return means ANY concurrent interleaving of the set is
        equivalent to its serial composition."""
        out: list[Diagnostic] = []
        fps = list(footprints)
        for i in range(len(fps)):
            for j in range(i + 1, len(fps)):
                out.extend(self.check_pair(fps[i], fps[j]))
        return out


def certify_concurrent(
    footprints: Sequence[ProgramFootprint],
    *,
    budget: Budget | None = None,
    certifier: InterferenceCertifier | None = None,
) -> list[Diagnostic]:
    """One-shot module-level convenience over `InterferenceCertifier`
    (the facade's `ACCL.certify_concurrent` holds a long-lived
    certifier instead, so its per-pair cache spans admissions)."""
    c = certifier if certifier is not None \
        else InterferenceCertifier(budget)
    return c.certify(footprints)
