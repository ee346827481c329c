"""Exhaustive-interleaving model checking for per-rank event programs.

Counterpart of accl_tpu/analysis/modelcheck.py, whole.

`protocol.simulate` explores exactly ONE interleaving of a batch's
per-rank programs — the canonical schedule (rank-index order, FIFO
buffer drain, first-posted TAG_ANY match). That is the right cheap
gate, but the real executors' match order is timing-dependent: a batch
that completes canonically can still deadlock or deliver different
data under another legal match order (the post-dispatch failure class
ACCL+, arxiv 2312.11742, reports — now reachable BEFORE dispatch, in
the spirit of schedule synthesis that proves schedules rather than
testing one run, arxiv 2008.08708).

This module certifies a batch over ALL match orders:

* `check_interleavings` — a match-set-based stateless explorer. The
  only nondeterminism in the event model is WHICH eligible send a recv
  consumes (buffered semantics) or WHICH sender head an any-source
  recv pairs with (rendezvous semantics); everything else commutes.
  The explorer exploits that with a dynamic partial-order reduction:
  statically pinned matches (a send and recv that can never pair with
  anything else) and barrier releases execute eagerly without
  branching — a singleton persistent set — and contended wildcard
  matches branch exhaustively over their match set. Reached states are
  hashed and memoized ((program counters, unconsumed posted sends)
  fully determine the future), which both collapses commuting
  interleavings like a sleep set and makes the search a DAG walk.
  `reduce=False` disables the reductions for a bounded brute-force
  enumeration of every individual action interleaving — the oracle the
  fuzz suite compares the reduced search against, and the fallback for
  tiny programs.

* `diagnose_programs` — runs the checker under BOTH rendezvous and
  buffered semantics and converts the verdict into stable diagnostics:
  ACCL205 wildcard-race (a recv whose alternative matchings in
  completing executions deliver different data), ACCL206
  schedule-dependent-deadlock (a reachable stuck state although the
  canonical run completes — with the witness interleaving rendered in
  the message), and ACCL207 modelcheck-truncated (the exploration
  budget ran out: the verdict is partial, never a silent pass).

Exploration is budgeted by explored-state count and wall clock
(`Budget`); both caps surface as ACCL207.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from ..constants import TAG_ANY
from .diagnostics import Diagnostic, make
from .protocol import ANY_SRC, Event, _src_matches, _tags_match

__all__ = [
    "Budget",
    "CheckResult",
    "Race",
    "check_interleavings",
    "diagnose_programs",
    "canonical_completes",
    "statically_deterministic",
]


@dataclasses.dataclass(frozen=True)
class Budget:
    """Exploration caps. Exhausting either truncates the search and is
    REPORTED (ACCL207) — a partial exploration never passes silently."""

    max_states: int = 20_000
    max_seconds: float = 10.0


@dataclasses.dataclass(frozen=True)
class Race:
    """A recv that matches observably different sends across completing
    executions. `identities` are the distinct (sender, tag, count)
    classes seen; two sends of the same class are interchangeable at
    the batch level (same source rank, same wire signature), so a
    permutation among them is not reported."""

    rank: int
    pc: int
    identities: tuple[str, ...]


@dataclasses.dataclass
class CheckResult:
    semantics: str  # "buffered" | "rendezvous"
    canonical_complete: bool
    complete_reachable: bool  # some explored interleaving finishes
    stuck_trace: list[str] | None  # match steps reaching a stuck state
    stuck_state: str | None  # rendering of the stuck heads
    races: list[Race]
    truncated: bool
    states: int


class _BudgetExhausted(Exception):
    pass


def _fmt_ev(r: int, pc: int, ev: Event) -> str:
    if ev.kind == "coll":
        return f"r{r}:{ev.op}#{pc}"
    tag = "ANY" if ev.tag == TAG_ANY else str(ev.tag)
    peer = "ANY" if ev.peer == ANY_SRC else str(ev.peer)
    role = "->" if ev.kind == "send" else "<-"
    return f"r{r}:{ev.kind}#{pc}({role}r{peer}, tag {tag})"


def _send_identity(r: int, ev: Event) -> str:
    tag = "ANY" if ev.tag == TAG_ANY else str(ev.tag)
    return f"r{r}:send(tag {tag}, count {ev.count})"


@dataclasses.dataclass(frozen=True)
class _MatchStructure:
    """The static matching relation of one batch: which send occurrence
    can ever pair with which recv occurrence, and the PINNED subset — a
    send whose only compatible recv is R where R's only compatible send
    is that send. Matching a pinned pair is the only thing either side
    can ever do, commutes with every other transition, and can never be
    disabled — a singleton persistent set, executed eagerly without
    branching. Computed once per batch and shared across the checker's
    two semantic regimes."""

    n_sends: int
    n_recvs: int
    pinned_send: frozenset
    pinned_recv: frozenset
    pin_of_recv: dict

    @property
    def all_pinned(self) -> bool:
        return (len(self.pinned_send) == self.n_sends
                and len(self.pinned_recv) == self.n_recvs)


def _match_structure(programs: list[list[Event]]) -> _MatchStructure:
    """Build the static matching relation by bucketed indexing — recvs
    keyed by (rank, comm, source constraint, tag) — so candidate
    pairing is proportional to the number of COMPATIBLE pairs, not to
    sends x recvs (a 64-step ring batch has ~14k endpoint events whose
    all-pairs scan took tens of seconds; its namespaced hop tags make
    the buckets near-singleton)."""
    sends = [(r, i, ev) for r, prog in enumerate(programs)
             for i, ev in enumerate(prog) if ev.kind == "send"]
    recvs = [(r, i, ev) for r, prog in enumerate(programs)
             for i, ev in enumerate(prog) if ev.kind == "recv"]
    # (recv rank, comm, peer key) -> recv ids; peer key is the recv's
    # source constraint (exact rank or ANY_SRC)
    by_peer: dict[tuple, list] = {}
    by_peer_tag: dict[tuple, list] = {}
    for d, di, rev in recvs:
        by_peer.setdefault((d, rev.comm, rev.peer), []).append((d, di))
        by_peer_tag.setdefault((d, rev.comm, rev.peer, rev.tag),
                               []).append((d, di))
    cand_r: dict[tuple[int, int], list] = {}
    cand_s: dict[tuple[int, int], list] = {}
    for s, si, sev in sends:
        d = sev.peer
        cands: list = []
        for pk in (s, ANY_SRC):
            if sev.tag == TAG_ANY:  # a wildcard send matches every tag
                cands += by_peer.get((d, sev.comm, pk), [])
            else:  # exact or recv-side wildcard (disjoint buckets)
                cands += by_peer_tag.get((d, sev.comm, pk, sev.tag), [])
                cands += by_peer_tag.get((d, sev.comm, pk, TAG_ANY), [])
        for rid in cands:
            cand_s.setdefault((s, si), []).append(rid)
            cand_r.setdefault(rid, []).append((s, si))
    pinned_send = set()
    pinned_recv = set()
    pin_of_recv = {}
    for sid, rlist in cand_s.items():
        if len(rlist) == 1 and len(cand_r.get(rlist[0], ())) == 1:
            pinned_send.add(sid)
            pinned_recv.add(rlist[0])
            pin_of_recv[rlist[0]] = sid
    return _MatchStructure(len(sends), len(recvs),
                           frozenset(pinned_send), frozenset(pinned_recv),
                           pin_of_recv)


class _Checker:
    """One exploration of one (programs, semantics) pair."""

    def __init__(self, programs: list[list[Event]], semantics: str,
                 budget: Budget, reduce: bool,
                 structure: _MatchStructure | None = None):
        self.programs = [list(p) for p in programs]
        self.world = len(programs)
        self.buffered = semantics == "buffered"
        self.budget = budget
        self.reduce = reduce
        self.deadline = time.monotonic() + budget.max_seconds
        self.states = 0
        self.truncated = False
        # memo: state key -> (can_complete, saw_stuck)
        self.memo: dict = {}
        self.stuck_trace: list[str] | None = None
        self.stuck_state: str | None = None
        # (recv rank, recv pc) -> set of send identities on
        # completion-viable edges
        self.matches: dict[tuple[int, int], set[str]] = {}
        st = structure or _match_structure(programs)
        self.pinned_recv = st.pinned_recv
        self.pin_of_recv = st.pin_of_recv

    # -- static match structure -------------------------------------------

    def _compatible(self, s: int, sev: Event, d: int, rev: Event) -> bool:
        return (sev.peer == d and _src_matches(s, rev)
                and sev.comm == rev.comm and _tags_match(sev.tag, rev.tag))

    # -- shared state helpers ---------------------------------------------

    def _head(self, pcs, r: int) -> Event | None:
        return (self.programs[r][pcs[r]]
                if pcs[r] < len(self.programs[r]) else None)

    def _bad_peer(self, r: int, ev: Event) -> bool:
        if ev.kind == "recv" and ev.peer == ANY_SRC:
            return False
        return not 0 <= ev.peer < self.world

    def _barrier_ready(self, pcs) -> bool:
        """All `world` ranks parked on the same collective signature
        (mirrors simulate: a finished rank breaks the barrier)."""
        sigs = set()
        for r in range(self.world):
            ev = self._head(pcs, r)
            if ev is None or ev.kind != "coll":
                return False
            sigs.add((ev.op, ev.count, ev.comm))
        return len(sigs) == 1

    def _tick(self) -> None:
        self.states += 1
        if (self.states > self.budget.max_states
                or time.monotonic() > self.deadline):
            raise _BudgetExhausted

    # -- deterministic closure (the partial-order reduction) ----------------

    def _closure(self, pcs, posted):
        """Deterministic advance under the reduction: post head sends /
        skip bad-peer events (buffered — sends never block, posting is
        unobservable and monotone), fire statically pinned matches and
        barrier releases. Each is a singleton persistent set: always
        enabled once enabled, commutes with every other transition, and
        has no alternative — executing it eagerly cannot hide an
        outcome. With `reduce=False` the closure is the identity and
        every action interleaves individually (the brute-force
        oracle)."""
        if not self.reduce:
            return pcs, posted
        pcs = list(pcs)
        posted = set(posted)
        while True:
            moved = False
            for r in range(self.world):
                while (ev := self._head(pcs, r)) is not None:
                    if ev.kind == "send" and self.buffered:
                        if not self._bad_peer(r, ev):
                            posted.add((r, pcs[r]))
                        pcs[r] += 1
                        moved = True
                    elif ev.kind != "coll" and self._bad_peer(r, ev):
                        pcs[r] += 1
                        moved = True
                    else:
                        break
            if self.buffered:
                for r in range(self.world):
                    ev = self._head(pcs, r)
                    if (ev is None or ev.kind != "recv"
                            or (r, pcs[r]) not in self.pinned_recv):
                        continue
                    sid = self.pin_of_recv[(r, pcs[r])]
                    if sid in posted:
                        posted.discard(sid)
                        pcs[r] += 1
                        moved = True
            else:
                for r in range(self.world):
                    ev = self._head(pcs, r)
                    if ev is None or ev.kind != "send" \
                            or self._bad_peer(r, ev):
                        continue
                    d = ev.peer
                    rev = self._head(pcs, d)
                    if (d != r and rev is not None and rev.kind == "recv"
                            and rev.peer == r  # exact source: pinned pair
                            and rev.comm == ev.comm
                            and _tags_match(ev.tag, rev.tag)):
                        pcs[r] += 1
                        pcs[d] += 1
                        moved = True
            if self._barrier_ready(pcs):
                for r in range(self.world):
                    pcs[r] += 1
                moved = True
            if not moved:
                return tuple(pcs), frozenset(posted)

    # -- branching transitions ---------------------------------------------

    def _transitions(self, pcs, posted):
        """The branch set at a state. Under the reduction only contended
        matches remain (everything deterministic was closed); brute
        force enumerates every individual action: ("post", r),
        ("skip", r), ("barrier",), and ("match", recv rank, recv pc,
        send id)."""
        out = []
        for r in range(self.world):
            ev = self._head(pcs, r)
            if ev is None:
                continue
            if ev.kind == "send":
                if self.buffered:
                    if not self.reduce:
                        out.append(("skip", r) if self._bad_peer(r, ev)
                                   else ("post", r))
                    continue
                # rendezvous: head-to-head pair (keyed at the sender so
                # each pair appears once)
                if self._bad_peer(r, ev):
                    if not self.reduce:
                        out.append(("skip", r))
                    continue
                d = ev.peer
                rev = self._head(pcs, d)
                if (d != r and rev is not None and rev.kind == "recv"
                        and _src_matches(r, rev) and rev.comm == ev.comm
                        and _tags_match(ev.tag, rev.tag)):
                    out.append(("match", d, pcs[d], (r, pcs[r])))
            elif ev.kind == "recv":
                if self._bad_peer(r, ev):
                    if not self.reduce:
                        out.append(("skip", r))
                    continue
                if self.buffered:
                    for (s, si) in sorted(posted):
                        if self._compatible(s, self.programs[s][si], r, ev):
                            out.append(("match", r, pcs[r], (s, si)))
        if not self.reduce and self._barrier_ready(pcs):
            out.append(("barrier",))
        return out

    def _apply(self, pcs, posted, tr):
        pcs = list(pcs)
        if tr[0] == "post":
            posted = frozenset(posted | {(tr[1], pcs[tr[1]])})
            pcs[tr[1]] += 1
        elif tr[0] == "skip":
            pcs[tr[1]] += 1
        elif tr[0] == "barrier":
            for r in range(self.world):
                pcs[r] += 1
        else:  # ("match", recv rank, recv pc, send id)
            _, d, _, (s, _) = tr
            if self.buffered:
                posted = frozenset(posted - {tr[3]})
                pcs[d] += 1
            else:
                pcs[s] += 1
                pcs[d] += 1
        return tuple(pcs), posted

    # -- exploration --------------------------------------------------------

    def run(self) -> tuple[bool, bool]:
        """Explore from the initial state; returns (complete_reachable,
        stuck_reachable)."""

        def dfs(pcs, posted, trace) -> tuple[bool, bool]:
            pcs, posted = self._closure(pcs, posted)
            key = (pcs, posted)
            hit = self.memo.get(key)
            if hit is not None:
                return hit
            self._tick()
            # mark in-progress defensively; pcs are monotone so the
            # graph is a DAG and this is never read back
            self.memo[key] = (False, False)
            if all(pcs[r] >= len(self.programs[r])
                   for r in range(self.world)):
                if not posted:
                    res = (True, False)
                else:
                    # every pc ran out but buffered sends were never
                    # received: terminal, and a defect (simulate's
                    # leftover-posted ACCL201) — NOT a completion
                    if self.stuck_trace is None:
                        self.stuck_trace = list(trace)
                        self.stuck_state = ", ".join(
                            _send_identity(s, self.programs[s][si])
                            + " never received"
                            for s, si in sorted(posted))
                    res = (False, True)
                self.memo[key] = res
                return res
            todo = self._transitions(pcs, posted)
            if not todo:
                if self.stuck_trace is None:
                    self.stuck_trace = list(trace)
                    self.stuck_state = self._fmt_stuck(pcs)
                res = (False, True)
                self.memo[key] = res
                return res
            complete = stuck = False
            for tr in todo:
                is_match = tr[0] == "match"
                if is_match:
                    _, r, rpc, (s, si) = tr
                    trace.append(
                        f"{_fmt_ev(r, rpc, self.programs[r][rpc])} "
                        f"matched {_send_identity(s, self.programs[s][si])}")
                c, k = dfs(*self._apply(pcs, posted, tr), trace)
                if is_match:
                    trace.pop()
                    if c:
                        self.matches.setdefault((r, rpc), set()).add(
                            _send_identity(s, self.programs[s][si]))
                complete |= c
                stuck |= k
            res = (complete, stuck)
            self.memo[key] = res
            return res

        init = (tuple([0] * self.world), frozenset())
        # DFS depth is bounded by the total event count (every recursion
        # level consumes at least one event): raise the interpreter
        # recursion limit to cover it, scoped and restored. A long
        # program can legally exceed the default 1000 well inside the
        # state budget — escaping as a raw RecursionError would bypass
        # the loud-truncation contract.
        depth = sum(len(p) for p in self.programs)
        old_limit = sys.getrecursionlimit()
        need = 4 * depth + 1000
        try:
            if need > old_limit:
                sys.setrecursionlimit(need)
            return dfs(*init, [])
        except (_BudgetExhausted, RecursionError):
            # RecursionError: pathological depth beyond the raised
            # limit — report as truncation, never crash the linter
            self.truncated = True
            return (False, self.stuck_trace is not None)
        finally:
            sys.setrecursionlimit(old_limit)

    def _fmt_stuck(self, pcs) -> str:
        parts = []
        for r in range(self.world):
            ev = self._head(pcs, r)
            parts.append("r%d:done" % r if ev is None
                         else _fmt_ev(r, pcs[r], ev))
        return " | ".join(parts)


def canonical_completes(programs: list[list[Event]],
                        *, blocking_sends: bool) -> bool:
    """Does the canonical `simulate` schedule consume every event? THE
    gate for ACCL206: a schedule-dependent deadlock is only interesting
    when the one schedule the single-run linter tried looks fine
    (test_modelcheck pins checker/simulate agreement by fuzz). Keys on
    simulate's structural `outcome` signal, not its diagnostics —
    count-mismatched pairs still MATCH (and complete), and prose must
    never carry semantics."""
    from .protocol import simulate

    outcome: list[bool] = []
    simulate(programs, blocking_sends=blocking_sends, outcome=outcome)
    return outcome[0]


def statically_deterministic(programs: list[list[Event]]) -> bool:
    """True when every send and recv occurrence is statically pinned to
    a unique partner — the matching relation then admits exactly ONE
    assignment, every interleaving commutes to the same outcome, and
    exhaustive exploration can be skipped soundly. This is the deep
    tier's router (it subsumes `simulate`'s MatchNote signal: a
    multi-eligible recv is never uniquely pinned): a batch with any
    unpinned endpoint goes to the checker; a statically deterministic
    one is already certified by the canonical run. Hop-derived schedule
    programs (exact per-hop tags) land here, which is what keeps the
    deep tier affordable over the full schedule sweep."""
    return _match_structure(programs).all_pinned


def check_interleavings(programs: list[list[Event]], *,
                        semantics: str = "buffered",
                        budget: Budget | None = None,
                        reduce: bool = True,
                        _structure: _MatchStructure | None = None
                        ) -> CheckResult:
    """Model-check one batch of per-rank programs under one matching
    regime. `reduce=False` disables the persistent-set closure for the
    brute-force enumeration (fuzz oracle / tiny-program fallback)."""
    if semantics not in ("buffered", "rendezvous"):
        raise ValueError(f"semantics must be 'buffered'|'rendezvous', "
                         f"got {semantics!r}")
    budget = budget or Budget()
    chk = _Checker(programs, semantics, budget, reduce,
                   structure=_structure)
    complete, stuck = chk.run()
    races = [
        Race(r, pc, tuple(sorted(ids)))
        for (r, pc), ids in sorted(chk.matches.items())
        if len(ids) > 1
    ]
    return CheckResult(
        semantics=semantics,
        canonical_complete=canonical_completes(
            programs, blocking_sends=semantics == "rendezvous"),
        complete_reachable=complete,
        stuck_trace=chk.stuck_trace,
        stuck_state=chk.stuck_state,
        races=races,
        truncated=chk.truncated,
        states=chk.states,
    )


def diagnose_programs(programs: list[list[Event]], *,
                      semantics: tuple[str, ...] = ("rendezvous",
                                                    "buffered"),
                      budget: Budget | None = None,
                      step: int | None = None) -> list[Diagnostic]:
    """The deep-tier verdict for one batch: explore every match order
    under each regime and emit stable diagnostics.

    ACCL206 fires only when the canonical schedule completes under that
    regime — a canonically-stuck batch is already rejected by the
    single-run linter (ACCL201/202/203), and re-reporting it as
    schedule-dependent would be wrong: EVERY schedule loses. ACCL205
    likewise only considers completing executions; the data a doomed
    interleaving would have delivered is not a result."""
    budget = budget or Budget()
    diags: list[Diagnostic] = []
    seen: set[tuple[str, int, int]] = set()
    structure = _match_structure(programs)  # shared across regimes
    for sem in semantics:
        res = check_interleavings(programs, semantics=sem, budget=budget,
                                  _structure=structure)
        if res.truncated:
            diags.append(make(
                "ACCL207",
                f"{sem} exploration truncated after {res.states} states "
                f"(budget: {budget.max_states} states / "
                f"{budget.max_seconds:g}s): interleavings beyond the "
                "explored prefix are UNVERIFIED", step=step))
        if not res.canonical_complete:
            continue
        if res.stuck_trace is not None:
            key = ("ACCL206", -1, -1)
            if key not in seen:
                seen.add(key)
                steps = "\n    ".join(res.stuck_trace) or "(no matches)"
                diags.append(make(
                    "ACCL206",
                    "the canonical schedule completes, but under "
                    f"{sem} semantics the interleaving\n    {steps}\n"
                    f"  reaches the stuck state [{res.stuck_state}] — "
                    "no eligible match can ever fire", step=step))
        for race in res.races:
            key = ("ACCL205", race.rank, race.pc)
            if key in seen:
                continue
            seen.add(key)
            ev = programs[race.rank][race.pc]
            diags.append(make(
                "ACCL205",
                f"{_fmt_ev(race.rank, race.pc, ev)} matches "
                f"{' or '.join(race.identities)} depending on the "
                f"{sem} match order: the delivered data is "
                "schedule-dependent", step=step, rank=race.rank))
    return diags
