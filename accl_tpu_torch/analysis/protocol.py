"""Protocol analysis: the per-rank event model and its matching game.

Counterpart of accl_tpu/analysis/protocol.py, the half that reads given
programs. Per-rank programs are lists of blocking events (`send`,
`recv`, `coll`); they come from per-rank descriptor chains
(`rank_programs_from_options`: send/recv descriptors become endpoint
events, every other collective a synchronizing group event), from hop
lists (`rank_programs_from_hops`, `batch_programs_from_hops`: hop h's
pair (s, d) is a send at s and a recv at d on channel h) or from a
hop-DAG (`hopdag.rank_programs`).

`simulate` runs the classic rendezvous matching game: each rank
executes its event list in order; a send blocks until its recv is
posted and vice versa; collectives block until every rank arrives at
the same one. This is the conservative model: eager-protocol sends can
buffer and complete early, so a batch clean under rendezvous semantics
is clean under both. Stuck states decompose into ACCL202 deadlock-cycle
(circular wait), ACCL203 tag-mismatch, ACCL403 comm-mismatch, and
ACCL201 unmatched-sendrecv (waiting on a rank that already finished, or
events left over at exit).

A schedule body's hops come from recording it (`trace_schedule_jaxpr`,
the seam the semantic certifier shares; `trace_schedule_hops`,
`iter_ppermute_eqns`), per call (`interpret_schedule`) or per batch
(`batch_rank_programs`).
"""

from __future__ import annotations

import dataclasses

from ..constants import Operation, TAG_ANY
from .diagnostics import Diagnostic, make

__all__ = [
    "ANY_SRC",
    "Event",
    "MatchNote",
    "send",
    "recv",
    "coll",
    "simulate",
    "rank_programs_from_options",
    "trace_schedule_jaxpr",
    "trace_schedule_hops",
    "rank_programs_from_hops",
    "batch_programs_from_hops",
    "batch_rank_programs",
    "check_hops",
    "interpret_schedule",
]

# Wildcard source for recv events: matches a send from ANY rank (the
# native executor's recvs are source-exact, but descriptor chains built
# for single-controller or RDMA executors can be any-source; the model
# checker explores every eligible sender).
ANY_SRC = -2


@dataclasses.dataclass(frozen=True)
class Event:
    """One blocking step of a rank's program."""

    kind: str  # "send" | "recv" | "coll"
    peer: int = -1  # partner rank for send/recv
    tag: int = TAG_ANY
    count: int = 0
    comm: int = 0
    op: str = ""  # collective name for kind == "coll"


def send(peer: int, tag: int = TAG_ANY, count: int = 0,
         comm: int = 0) -> Event:
    return Event("send", peer, tag, count, comm)


def recv(peer: int, tag: int = TAG_ANY, count: int = 0,
         comm: int = 0) -> Event:
    return Event("recv", peer, tag, count, comm)


def coll(op: str, count: int = 0, comm: int = 0) -> Event:
    return Event("coll", -1, TAG_ANY, count, comm, op)


def _tags_match(a: int, b: int) -> bool:
    return a == b or TAG_ANY in (a, b)


def _src_matches(sender: int, ev: Event) -> bool:
    """A recv's source constraint: exact peer, or the ANY_SRC wildcard."""
    return ev.peer == ANY_SRC or sender == ev.peer


@dataclasses.dataclass(frozen=True)
class MatchNote:
    """One ambiguous match observed during the canonical `simulate` run:
    a recv for which MULTIPLE posted sends (or sender heads) were
    eligible. The canonical run commits to the first-posted candidate;
    the note records that the real executor had a choice — the cheap
    single-run precursor that routes a batch into the deep
    interleaving checker (modelcheck.py)."""

    rank: int  # receiving rank
    pc: int  # recv's index in its rank's program
    candidates: tuple[str, ...]  # human-readable eligible sends


def simulate(programs: list[list[Event]],
             *, blocking_sends: bool = True,
             notes: list[MatchNote] | None = None,
             outcome: list[bool] | None = None) -> list[Diagnostic]:
    """Run the blocking-match game over per-rank event lists and report
    every protocol defect found.

    `blocking_sends=True` is the rendezvous model (a send blocks until
    its recv is posted) — the conservative contract for per-rank
    descriptor chains. `blocking_sends=False` buffers sends (a send
    completes immediately, recvs drain the buffer in arrival order) —
    the semantics of hop-derived programs, where every ppermute hop's
    sends are posted collectively before any recv completes.

    This explores exactly ONE interleaving — the canonical schedule:
    ranks advance in index order, the posted buffer drains FIFO, and a
    TAG_ANY recv takes the FIRST-POSTED eligible send. `notes`, when a
    list is passed, collects a `MatchNote` per recv that had more than
    one eligible candidate: the signal that other interleavings exist
    and the batch needs the deep checker. `outcome`, when a list is
    passed, receives one bool: did the canonical run CONSUME everything
    (no stuck rank, no leftover posted send)? This is the structural
    completion signal the deep tier's ACCL206 gate keys on — never
    inferred from diagnostic text.

    Termination: each iteration of the outer loop advances at least one
    program counter or exits."""
    diags: list[Diagnostic] = []
    world = len(programs)
    pc = [0] * world
    posted: list[tuple[int, Event]] = []  # buffered (sender, send) FIFO
    noted: set[tuple[int, int]] = set()  # (rank, pc) already noted

    def head(r: int) -> Event | None:
        return programs[r][pc[r]] if pc[r] < len(programs[r]) else None

    def bad_peer(r: int, ev: Event) -> bool:
        if 0 <= ev.peer < world or (ev.kind == "recv"
                                    and ev.peer == ANY_SRC):
            return False
        diags.append(make(
            "ACCL402",
            f"{ev.kind} addresses rank {ev.peer} outside world {world}",
            rank=r))
        pc[r] += 1
        return True

    def note(r: int, cands: list[str]) -> None:
        if notes is not None and len(cands) > 1 and (r, pc[r]) not in noted:
            noted.add((r, pc[r]))
            notes.append(MatchNote(r, pc[r], tuple(cands)))

    while True:
        progressed = False
        if not blocking_sends:
            # sends complete immediately into the posted buffer
            for r in range(world):
                while (ev := head(r)) is not None and ev.kind == "send":
                    if not bad_peer(r, ev):
                        posted.append((r, ev))
                        pc[r] += 1
                    progressed = True
            # recvs drain the buffer in arrival order (first-posted
            # eligible send wins — the FIFO contract the native
            # executor's seqn-ordered links implement)
            for r in range(world):
                ev = head(r)
                if ev is None or ev.kind != "recv" or bad_peer(r, ev):
                    continue
                eligible = [
                    i for i, (s, sev) in enumerate(posted)
                    if (_src_matches(s, ev) and sev.peer == r
                        and sev.comm == ev.comm
                        and _tags_match(sev.tag, ev.tag))]
                note(r, [f"r{posted[i][0]}:send(tag {posted[i][1].tag})"
                         for i in eligible])
                if eligible:
                    i = eligible[0]
                    s, sev = posted[i]
                    if sev.count != ev.count:
                        diags.append(make(
                            "ACCL201",
                            f"rank {s} sends {sev.count} elements "
                            f"to rank {r}, which posted a recv for "
                            f"{ev.count}", rank=r))
                    posted.pop(i)
                    pc[r] += 1
                    progressed = True
        else:
            # point-to-point rendezvous: a send whose partner's CURRENT
            # event is the matching recv completes both. An ANY_SRC recv
            # head with several sender heads targeting it is ambiguous —
            # note it, then commit to the lowest-ranked sender (the
            # canonical order).
            for d in range(world):
                rv = head(d)
                if rv is None or rv.kind != "recv" or rv.peer != ANY_SRC:
                    continue
                cands = [
                    s for s in range(world)
                    if (sv := head(s)) is not None and sv.kind == "send"
                    and sv.peer == d and sv.comm == rv.comm
                    and _tags_match(sv.tag, rv.tag)]
                note(d, [f"r{s}:send(tag {head(s).tag})"  # type: ignore[union-attr]
                         for s in cands])
            for r in range(world):
                ev = head(r)
                if ev is None or ev.kind != "send" or bad_peer(r, ev):
                    continue
                pev = head(ev.peer)
                if (pev is not None and pev.kind == "recv"
                        and _src_matches(r, pev) and pev.comm == ev.comm
                        and _tags_match(ev.tag, pev.tag)):
                    if ev.count != pev.count:
                        diags.append(make(
                            "ACCL201",
                            f"rank {r} sends {ev.count} elements to rank "
                            f"{ev.peer}, which posted a recv for "
                            f"{pev.count}", rank=r))
                    pc[r] += 1
                    pc[ev.peer] += 1
                    progressed = True
        if progressed:
            continue
        # collective barrier: every unfinished rank parked on the same
        # group event releases together
        waiting = [(r, ev) for r in range(world)
                   if (ev := head(r)) is not None]
        if waiting and all(ev.kind == "coll" for _, ev in waiting):
            sigs = {(ev.op, ev.count, ev.comm) for _, ev in waiting}
            if len(sigs) == 1 and len(waiting) == world:
                for r, _ in waiting:
                    pc[r] += 1
                continue
        break

    if outcome is not None:
        outcome.append(not posted and all(
            pc[r] >= len(programs[r]) for r in range(world)))

    # stuck-state decomposition
    for s, sev in posted:
        diags.append(make(
            "ACCL201",
            f"rank {s}'s send to rank {sev.peer} (tag {sev.tag}) is "
            "never received", rank=s))
    stuck = [r for r in range(world) if head(r) is not None]
    if not stuck:
        return diags
    blames: set[int] = set()

    def cur(r: int) -> Event:
        ev = head(r)
        assert ev is not None  # r is in stuck
        return ev

    def waits_on(r: int) -> list[int]:
        ev = cur(r)
        if ev.kind == "coll" or (ev.kind == "recv" and ev.peer == ANY_SRC):
            return [p for p in range(world) if p != r and p in stuck]
        return [ev.peer] if 0 <= ev.peer < len(programs) else []

    # precise pairwise mismatches first: both ranks parked on each
    # other with incompatible tag/comm
    for r in stuck:
        ev = cur(r)
        if ev.kind != "send" or ev.peer not in stuck:
            continue
        pev = cur(ev.peer)
        if pev.kind == "recv" and _src_matches(r, pev):
            if ev.comm != pev.comm:
                diags.append(make(
                    "ACCL403",
                    f"rank {r} sends on communicator {ev.comm:#x} but "
                    f"rank {ev.peer}'s recv addresses {pev.comm:#x}",
                    rank=r))
                blames.update((r, ev.peer))
            elif not _tags_match(ev.tag, pev.tag):
                diags.append(make(
                    "ACCL203",
                    f"rank {r} sends tag {ev.tag} to rank {ev.peer}, "
                    f"whose recv expects tag {pev.tag}: the pair can "
                    "never match", rank=r))
                blames.update((r, ev.peer))

    # circular waits: DFS over the wait-for graph
    cycle = _find_cycle(stuck, waits_on)
    if cycle and not blames.intersection(cycle):
        names = " -> ".join(
            f"r{r}:{cur(r).kind}"
            + (f"(peer {cur(r).peer})" if cur(r).kind != "coll"
               else f"({cur(r).op})")
            for r in cycle)
        diags.append(make(
            "ACCL202",
            f"circular wait among ranks {cycle}: {names} -> r{cycle[0]}",
            rank=cycle[0]))
        blames.update(cycle)

    # everything else stuck: waiting on a rank that finished, or a
    # never-posted partner event
    for r in stuck:
        if r in blames:
            continue
        ev = cur(r)
        leftover = len(programs[r]) - pc[r]
        diags.append(make(
            "ACCL201",
            f"rank {r} blocks forever on {ev.kind}"
            + (f" to/from rank {ev.peer}" if ev.kind != "coll"
               else f" {ev.op}")
            + f" tag {ev.tag} ({leftover} event(s) unconsumed)",
            rank=r))
    return diags


def _find_cycle(stuck, waits_on) -> list[int] | None:
    state = {r: 0 for r in stuck}  # 0 unvisited, 1 on stack, 2 done
    parent: dict[int, int] = {}
    for start in stuck:
        if state[start]:
            continue
        stack = [start]
        while stack:
            r = stack[-1]
            if state[r] == 0:
                state[r] = 1
            advanced = False
            for p in waits_on(r):
                if p not in state:
                    continue  # waiting on a finished rank: not a cycle
                if state[p] == 1:
                    cyc = [p]
                    q = r
                    while q != p:
                        cyc.append(q)
                        q = parent[q]
                    cyc.reverse()
                    return cyc
                if state[p] == 0:
                    parent[p] = r
                    stack.append(p)
                    advanced = True
                    break
            if not advanced:
                state[r] = 2
                stack.pop()
    return None


# ---------------------------------------------------------------------------
# Per-rank descriptor chains (the native executor's world)
# ---------------------------------------------------------------------------


def rank_programs_from_options(per_rank) -> list[list[Event]]:
    """Model per-rank CallOptions chains as blocking event programs:
    send/recv descriptors become endpoint events (peer from the
    root_src_dst src|dst<<16 packing), data-plane collectives become
    group events, local ops (copy/combine/config/nop) are elided."""
    local = (Operation.copy, Operation.combine, Operation.config,
             Operation.nop)
    programs: list[list[Event]] = []
    for me, chain in enumerate(per_rank):
        events: list[Event] = []
        for opts in chain:
            scen = opts.scenario
            if scen in local:
                continue
            src = opts.root_src_dst & 0xFFFF
            dst = (opts.root_src_dst >> 16) & 0xFFFF
            if scen == Operation.send:
                events.append(send(dst, opts.tag, opts.count,
                                   opts.comm_addr))
            elif scen == Operation.recv:
                events.append(recv(src, opts.tag, opts.count,
                                   opts.comm_addr))
            else:
                events.append(coll(scen.name, opts.count, opts.comm_addr))
        programs.append(events)
    return programs


# ---------------------------------------------------------------------------
# Schedule interpretation (the one-call path)
# ---------------------------------------------------------------------------


def trace_schedule_jaxpr(options, plan, world: int,
                         axis_name: str = "ccl", *,
                         arith_table: dict | None = None,
                         semantic_marks: bool = False):
    """Record ONE call's schedule body, the real lowering-built callable,
    and return `(trace, n_in, in_elems)`. THE seam every body-level pass
    shares, named as the reference's: the protocol pass reads hop perms
    from it and the semantic certifier its hop-DAG, so there is exactly
    one model of what the compiler builds. Where the reference returns a
    closed jaxpr, `trace` is the port's recorded body
    (semantics.ScheduleTrace: the DAG the lifter records by evaluating
    the body over symbolic operands, and its hops). Where the reference's
    `semantic_marks` turns on the compression lanes' named boundaries for
    the certifier's lift, the port's lifter always stops at them, and the
    switch selects what the trace is for: True records the whole DAG;
    False records the hops, evaluating a mapped body once as the
    reference traces it (the trace's DAG is then partial). Needs no
    device."""
    import torch

    from ..constants import DataType, to_torch_dtype
    from ..sequencer.lowering import analysis_body
    from ..sequencer.sequence import step_in_elems
    from .semantics import _Lifter

    body, n_in = analysis_body(options, plan, world, axis_name,
                               arith_table=arith_table)
    if options.scenario == Operation.barrier:
        elems, dtype = 1, torch.float32
    else:
        elems = step_in_elems(options, world)
        dtype = (to_torch_dtype(options.data_type)
                 if options.data_type != DataType.none else torch.float32)
    trace = _Lifter(world, semantic_marks).run(body, n_in, elems, dtype)
    return trace, n_in, elems


def trace_schedule_hops(options, plan, world: int,
                        axis_name: str = "ccl") -> list[tuple]:
    """Record ONE call's schedule body and return its cross-rank hops in
    program order: each hop is the perm tuple ((src, dst), ...). The ring
    kernel is off: the torch-op ring expresses the same wire pattern hop
    by hop. Hops inside a segmented body the reference maps (lax.map)
    appear once."""
    trace, _, _ = trace_schedule_jaxpr(options, plan, world, axis_name)
    hops: list[tuple] = []
    _collect_ppermutes(trace, hops)
    return hops


def iter_ppermute_eqns(trace):
    """Yield every hop record of a recorded body (trace_schedule_jaxpr's
    `trace`) in program order, a mapped body's hops once. THE walker for
    the 'every cross-rank hop is a permute' invariant: each record's
    `params["perm"]` is the hop's perm, as a ppermute equation's."""
    for hop in trace.hops:
        if not hop.repeat:
            yield hop


def _collect_ppermutes(trace, hops: list) -> None:
    """Perm tuples of every hop, in program order."""
    for eqn in iter_ppermute_eqns(trace):
        hops.append(tuple(tuple(p) for p in eqn.params["perm"]))


def check_hops(hops, world: int, step: int | None = None):
    """Validate hop well-formedness: every (src, dst) in range, no rank
    sending or receiving twice within one hop (ACCL204 — the jax
    runtime would reject the perm too, but post-dispatch)."""
    diags: list[Diagnostic] = []
    for h, perm in enumerate(hops):
        srcs: set[int] = set()
        dsts: set[int] = set()
        for s, d in perm:
            if not (0 <= s < world and 0 <= d < world):
                diags.append(make(
                    "ACCL204",
                    f"hop {h}: pair ({s}, {d}) outside world {world}",
                    step=step))
                continue
            if s in srcs:
                diags.append(make(
                    "ACCL204",
                    f"hop {h}: rank {s} sends twice in one permute",
                    step=step))
            if d in dsts:
                diags.append(make(
                    "ACCL204",
                    f"hop {h}: rank {d} receives twice in one permute",
                    step=step))
            srcs.add(s)
            dsts.add(d)
    return diags


def rank_programs_from_hops(hops, world: int,
                            tag_base: int = 0) -> list[list[Event]]:
    """Expand hop perms into per-rank blocking programs: hop h's pair
    (s, d) is a send at s and a recv at d, both on channel
    `tag_base + h` (the hop index as tag), so matching is exact per
    hop. `tag_base` namespaces hops when several calls' programs are
    concatenated into one batch — without it, step k's hop 0 and step
    k+1's hop 0 would alias one channel and fabricate match choices."""
    programs: list[list[Event]] = [[] for _ in range(world)]
    for h, perm in enumerate(hops):
        for s, d in perm:
            if 0 <= s < world and 0 <= d < world:
                programs[s].append(send(d, tag=tag_base + h))
                programs[d].append(recv(s, tag=tag_base + h))
    return programs


# Hop-tag stride between steps of one batch: no shipping schedule moves
# anywhere near 2**12 hops per call, and the namespaced tag stays far
# below TAG_ANY (0xFFFFFFFF).
_STEP_TAG_STRIDE = 1 << 12


def batch_programs_from_hops(hops_per_step, world: int) -> list[list[Event]]:
    """Concatenate per-step hop lists into whole-batch per-rank
    programs, tag-namespaced per step. This is the input the deep
    tier's interleaving checker explores — the cross-step view that
    per-step `interpret_schedule` cannot see. Takes ALREADY-TRACED hops
    so callers that interpreted each step (the linter's deep tier) pay
    for jax abstract tracing once, not twice."""
    programs: list[list[Event]] = [[] for _ in range(world)]
    for k, hops in enumerate(hops_per_step):
        for r, prog in enumerate(
                rank_programs_from_hops(hops, world,
                                        tag_base=k * _STEP_TAG_STRIDE)):
            programs[r].extend(prog)
    return programs


def batch_rank_programs(steps, plans, world: int,
                        axis_name: str = "ccl") -> list[list[Event]]:
    """Per-rank event programs for a WHOLE descriptor batch: each step's
    schedule body is recorded (trace_schedule_hops) and its hops appended
    in step order via `batch_programs_from_hops`."""
    return batch_programs_from_hops(
        [trace_schedule_hops(opts, plan, world, axis_name)
         for opts, plan in zip(steps, plans)], world)


def interpret_schedule(options, plan, world: int,
                       axis_name: str = "ccl") -> list[Diagnostic]:
    """The deep protocol pass for one call: record the schedule body,
    validate its hops, and run the per-rank matching game over them."""
    hops = trace_schedule_hops(options, plan, world, axis_name)
    diags = check_hops(hops, world)
    if not diags:  # malformed perms would confuse the matcher
        diags = simulate(rank_programs_from_hops(hops, world),
                         blocking_sends=False)
    return diags
