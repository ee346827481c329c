"""Semantic certifier: prove a hop-DAG computes its collective.

Counterpart of accl_tpu/analysis/semantics.py, the half that reads a
given DAG. The linter and model checker prove SAFETY (no hazards, no
protocol mismatches, no races or deadlocks), but a schedule can pass
all of that and still leave rank 3 without rank 5's addend. `certify`
closes that gap with contribution-set abstract interpretation: it
interprets a `hopdag.HopDag` over the contribution-set domain, where
each element of each buffer region carries the multiset of source atoms
it holds (atom (r, slot, j) is rank r's element j of operand `slot`)
plus the reduction the atoms were folded under (SUM / MAX / pure data).
Slices, concatenations and hops move contribution intervals around;
combines merge them; encode and decode keep their payload's provenance
(codes carry it, scales are block metadata). The final per-rank map is
compared against the declared collective (`collective_spec`):
allreduce means EVERY rank's element j holds {SUM over all ranks of
atom j}, and so on for each family.

Verdicts get stable codes:

  ACCL501  wrong-result: the final contribution set differs from the
           spec in a way that is neither purely missing nor purely
           duplicated (foreign atoms, wrong reduction, misrouted
           regions)
  ACCL502  partial-contribution: some rank's input never reaches an
           output region that the spec says must include it
  ACCL503  double-count: a contribution folded into the same
           non-idempotent reduction twice
  ACCL504  stale-read: a hop forwards a region before its producer
           wrote it (program-order violation in the DAG)

The reference also lifts a schedule body's DAG by tracing it
(`lift_call`) and certifies calls and batches from their plans
(`certify_call`, `check_batch_semantics`). The port has no lifting seam
yet: those raise NotImplementedError naming the analysis slice.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..constants import Operation, ReduceFunction
from ..errors import not_ported
from .diagnostics import Diagnostic, make
from .hopdag import (
    CONST,
    DATA,
    SCALES,
    HopDag,
    Value,
    validate_order,
)

__all__ = [
    "UnsupportedSchedule",
    "lift_call",
    "collective_spec",
    "certify",
    "certify_call",
    "check_batch_semantics",
    "clear_cache",
]


class UnsupportedSchedule(Exception):
    """The lifter met a construct outside the schedule vocabulary, or
    the certifier met a node kind it does not know: no claim is made
    about such a DAG (the certifier never guesses)."""


# ---------------------------------------------------------------------------
# Contribution-set interpretation
# ---------------------------------------------------------------------------

# A Term names one source of data: ("a", rank, slot, base) is the affine
# atom family "operand `slot` of rank `rank`, element base+j at local
# offset j"; ("s", node) is block-scale metadata of an encode node;
# ("stale", node) marks content read before node `node` produced it.
Term = tuple
Terms = dict[Term, int]
# A segment is (length, op, terms): `op` is the reduction the terms were
# folded under — None (pure data), "sum", "max", or "mixed".
Seg = tuple[int, Any, Terms]
IMap = list[Seg]


def _shift_terms(terms: Terms, off: int) -> Terms:
    if off == 0:
        return terms
    return {(t[0], t[1], t[2], t[3] + off) if t[0] == "a" else t: c
            for t, c in terms.items()}


def _imap_slice(imap: IMap, start: int, length: int) -> IMap:
    out: IMap = []
    pos = 0
    end = start + length
    for seg_len, op, terms in imap:
        lo, hi = max(start, pos), min(end, pos + seg_len)
        if lo < hi:
            out.append((hi - lo, op, _shift_terms(terms, lo - pos)))
        pos += seg_len
        if pos >= end:
            break
    got = sum(s[0] for s in out)
    if got < length:
        out.append((length - got, None, {}))
    return out


def _join_op(func: str, a: Any, b: Any) -> Any:
    for side in (a, b):
        if side not in (None, func):
            return "mixed"
    return func


def _merge_terms(a: Terms, b: Terms) -> Terms:
    out = dict(a)
    for t, c in b.items():
        out[t] = out.get(t, 0) + c
    return out


def _imap_join(func: str, a: IMap, b: IMap) -> IMap:
    out: IMap = []
    ai = bi = 0
    a_off = b_off = 0
    while ai < len(a) and bi < len(b):
        alen, aop, at = a[ai]
        blen, bop, bt = b[bi]
        take = min(alen - a_off, blen - b_off)
        out.append((take, _join_op(func, aop, bop),
                    _merge_terms(_shift_terms(at, a_off),
                                 _shift_terms(bt, b_off))))
        a_off += take
        b_off += take
        if a_off == alen:
            ai += 1
            a_off = 0
        if b_off == blen:
            bi += 1
            b_off = 0
    return _imap_norm(out)


def _imap_norm(imap: IMap) -> IMap:
    out: IMap = []
    for seg in imap:
        if seg[0] == 0:
            continue
        if out and out[-1][1] == seg[1] and out[-1][2] == _shift_terms(
                seg[2], -out[-1][0]):
            prev = out.pop()
            out.append((prev[0] + seg[0], prev[1], prev[2]))
        else:
            out.append(seg)
    return out


class _ContribEval:
    """Evaluate every node's contribution interval map in program
    order; reads of not-yet-produced nodes yield stale terms."""

    def __init__(self, dag: HopDag):
        self.dag = dag
        self.sends = dag.sends_by_channel()
        self.memo: dict[tuple[int, str], IMap] = {}

    def value_imap(self, value: Value, consumer: int) -> IMap:
        segs: IMap = []
        for p in value:
            if p.node == CONST:
                segs.append((p.length, None, {}))
            elif p.node >= consumer:
                segs.append((p.length, None, {("stale", p.node): 1}))
            else:
                segs.extend(_imap_slice(self.memo[(p.node, p.part)],
                                        p.offset, p.length))
        return _imap_norm(segs)

    def run(self) -> None:
        for n in self.dag.nodes:
            imap: IMap
            if n.kind == "arg":
                imap = [(n.length, None, {("a", n.rank, max(n.arg, 0), 0): 1})]
            elif n.kind in ("send", "cast"):
                imap = self.value_imap(n.value, n.id)
            elif n.kind == "recv":
                s = self.sends.get((n.hop, n.rank))
                if s is None:
                    imap = [(n.length, None, {("stale", n.id): 1})]
                elif s.id >= n.id:
                    imap = [(n.length, None, {("stale", s.id): 1})]
                else:
                    imap = _imap_slice(self.memo[(s.id, DATA)], 0, n.length)
            elif n.kind == "combine":
                imap = _imap_join(n.func or "sum",
                                  self.value_imap(n.value, n.id),
                                  self.value_imap(n.value2, n.id))
            elif n.kind == "encode":
                imap = self.value_imap(n.value, n.id)
                self.memo[(n.id, SCALES)] = [
                    (n.scales_len, None, {("s", n.id): 1})]
            elif n.kind == "decode":
                imap = _imap_slice(self.value_imap(n.value, n.id),
                                   0, n.length)
            else:
                raise UnsupportedSchedule(f"unknown node kind {n.kind!r}")
            self.memo[(n.id, DATA)] = imap

    def output_imap(self, rank: int) -> IMap:
        return self.value_imap(self.dag.outputs[rank],
                               len(self.dag.nodes))


# ---------------------------------------------------------------------------
# Collective specs
# ---------------------------------------------------------------------------


def _func_name(function: int) -> str:
    return "max" if ReduceFunction(function) == ReduceFunction.MAX \
        else "sum"


def collective_spec(options: Any, world: int) -> list[IMap | None] | None:
    """The declared meaning of one call as per-rank contribution maps:
    spec[r] is the interval map rank r's output MUST equal, or None for
    ranks whose output the collective leaves unspecified (non-root
    ranks of reduce/gather). Returns None when the scenario carries no
    payload contract (barrier/config/nop)."""
    op = options.scenario
    count = int(options.count)
    func = _func_name(options.function)

    def atom(r: int, base: int = 0, slot: int = 0) -> Terms:
        return {("a", r, slot, base): 1}

    def data(terms: Terms, length: int = count) -> Seg:
        return (length, None, terms)

    def red(terms: Terms, length: int = count) -> Seg:
        o = func if sum(terms.values()) > 1 else None
        return (length, o, terms)

    if op in (Operation.barrier, Operation.config, Operation.nop):
        return None
    if op == Operation.copy:
        return [[data(atom(r))] for r in range(world)]
    if op == Operation.combine:
        return [[red(_merge_terms(atom(r, 0, 0), atom(r, 0, 1)))]
                for r in range(world)]
    if op in (Operation.send, Operation.recv):
        src = options.root_src_dst & 0xFFFF
        dst = (options.root_src_dst >> 16) & 0xFFFF
        return [[data(atom(src if r == dst else r))] for r in range(world)]
    root = int(options.root_src_dst)
    if op == Operation.bcast:
        return [[data(atom(root))] for r in range(world)]
    if op == Operation.scatter:
        return [[data(atom(root, r * count))] for r in range(world)]
    if op == Operation.gather:
        rooted = [data(atom(c)) for c in range(world)]
        return [rooted if r == root else None for r in range(world)]
    if op == Operation.allgather:
        return [[data(atom(c)) for c in range(world)]
                for _ in range(world)]
    if op == Operation.reduce:
        full = _merge_all(atom(rr) for rr in range(world))
        return [[red(full)] if r == root else None for r in range(world)]
    if op == Operation.allreduce:
        # degraded live-subset mode (allreduce(mode="live_subset")): the
        # descriptor DECLARES the surviving-contributor set, and the
        # spec demands exactly those ranks' atoms — no more (a dead
        # rank's stale partial folded in is a foreign atom, ACCL501),
        # no fewer (a dropped survivor is ACCL502). Every rank's output
        # still carries the (survivor) sum: dead ranks relay the ring
        # but contribute masked zeros. Empty live_ranks = every rank
        # contributes, the ordinary collective.
        live = tuple(getattr(options, "live_ranks", ()) or ())
        contributors = live if live else tuple(range(world))
        full = _merge_all(atom(rr) for rr in contributors)
        return [[red(full)] for _ in range(world)]
    if op == Operation.reduce_scatter:
        return [[red(_merge_all(atom(rr, r * count)
                                for rr in range(world)))]
                for r in range(world)]
    if op == Operation.alltoall:
        pc = tuple(getattr(options, "peer_counts", ()) or ())
        if pc and any(c != count for c in pc):
            # alltoallv: rank r's slot for source c holds the first
            # peer_counts[r] elements of c's slot r — the capacity
            # prefix — and the overflow tail is DROPPED: the spec
            # declares it empty (zero-fill), so a schedule leaking
            # stale or misrouted data into the dropped region fails
            # certification instead of hiding behind the drop.
            def v_slot(r: int, c: int) -> IMap:
                v = int(pc[r])
                segs: IMap = [data(atom(c, r * count), v)]
                if v < count:
                    segs.append((count - v, None, {}))
                return segs

            return [[seg for c in range(world) for seg in v_slot(r, c)]
                    for r in range(world)]
        return [[data(atom(c, r * count)) for c in range(world)]
                for r in range(world)]
    return None


def _merge_all(terms_iter: Any) -> Terms:
    out: Terms = {}
    for t in terms_iter:
        out = _merge_terms(out, t)
    return out


# ---------------------------------------------------------------------------
# Certification
# ---------------------------------------------------------------------------

_MAX_DIAGS = 8


def _render_terms(terms: Terms, limit: int = 4) -> str:
    """Compact `{SUM-ready}` rendering: atom families grouped by
    (slot, base) over their rank sets."""
    fams: dict[tuple[int, int], list[tuple[int, int]]] = {}
    other: list[str] = []
    for t, c in sorted(terms.items(), key=repr):
        if t[0] == "a":
            fams.setdefault((t[2], t[3]), []).append((t[1], c))
        elif t[0] == "s":
            other.append(f"scales(node {t[1]})")
        else:
            other.append(f"stale(node {t[1]})")
    parts = []
    for (slot, base), ranks in sorted(fams.items()):
        rs = ",".join(f"r{r}" + (f"x{c}" if c != 1 else "")
                      for r, c in ranks)
        loc = f"@{base}+j" if base else "@j"
        sl = f" arg{slot}" if slot else ""
        parts.append("{" + rs + "}" + sl + loc)
    parts.extend(other)
    if not parts:
        return "(nothing: no source data reaches this region)"
    if len(parts) > limit:
        parts = parts[:limit] + [f"...+{len(parts) - limit} more"]
    return " + ".join(parts)


def _classify(got_op: Any, got: Terms, want_op: Any,
              want: Terms) -> tuple[str, str] | None:
    """Compare one aligned region's contribution set against the spec;
    returns (code, detail) or None when it matches."""
    idem = want_op == "max"
    g = {t: (1 if idem else c) for t, c in got.items()}
    w = {t: (1 if idem else c) for t, c in want.items()}
    stale = [t for t in g if t[0] == "stale"]
    if stale:
        return ("ACCL501",
                "region holds stale data (read before written)")
    op_ok = (sum(g.values()) <= 1 or got_op == want_op
             or (got_op is None and sum(g.values()) <= 1))
    if g == w and op_ok:
        return None
    foreign = {t: c for t, c in g.items() if t not in w}
    missing = {t: w[t] - g.get(t, 0) for t in w if g.get(t, 0) < w[t]}
    excess = {t: g[t] - w[t] for t in w if g.get(t, 0) > w[t]}
    if not foreign and not excess and missing:
        return ("ACCL502",
                f"missing contribution {_render_terms(missing)}")
    if not foreign and not missing and excess and not idem:
        return ("ACCL503",
                f"contribution {_render_terms(excess)} folded into the "
                f"same {want_op or 'sum'} twice")
    if g == w and not op_ok:
        return ("ACCL501",
                f"region reduced with {got_op or 'no fold'} where the "
                f"collective declares {want_op}")
    return ("ACCL501",
            f"expected {_render_terms(want)}, got {_render_terms(got)}")


def certify(dag: HopDag, spec: list[IMap | None] | None,
            scenario_name: str = "collective") -> list[Diagnostic]:
    """Prove the DAG's outputs carry exactly the contribution sets the
    collective spec declares. Emits ACCL501-504."""
    if spec is None:
        return []
    diags = validate_order(dag)
    ev = _ContribEval(dag)
    ev.run()
    have_stale = bool(diags)
    for r in range(dag.world):
        want = spec[r] if r < len(spec) else None
        if want is None:
            continue
        got = ev.output_imap(r)
        want_total = sum(s[0] for s in want)
        got_total = sum(s[0] for s in got)
        if got_total < want_total:
            got = got + [(want_total - got_total, None, {})]
        pos = 0
        gi = wi = 0
        g_off = w_off = 0
        while wi < len(want) and len(diags) < _MAX_DIAGS:
            wl, wop, wt = want[wi]
            if gi >= len(got):
                break
            gl, gop, gt = got[gi]
            take = min(wl - w_off, gl - g_off)
            verdict = _classify(gop, _shift_terms(gt, g_off),
                                wop, _shift_terms(wt, w_off))
            if verdict is not None:
                code, detail = verdict
                if not (code == "ACCL501" and "stale" in detail
                        and have_stale):
                    diags.append(make(
                        code,
                        f"{scenario_name}: rank {r} output elements "
                        f"[{pos}, {pos + take}): {detail}", rank=r))
            pos += take
            w_off += take
            g_off += take
            if w_off == wl:
                wi += 1
                w_off = 0
            if g_off == gl:
                gi += 1
                g_off = 0
    return diags[:_MAX_DIAGS]


# ---------------------------------------------------------------------------
# The lifting half (not ported yet)
# ---------------------------------------------------------------------------


def _lifting(name: str) -> NotImplementedError:
    return not_ported(f"semantics.{name} (it lifts a schedule body into a "
                      "hop-DAG)", "analysis")


def lift_call(options: Any, plan: Any, world: int,
              axis_name: str = "ccl",
              arith_table: dict | None = None) -> HopDag:
    raise _lifting("lift_call")


def certify_call(options: Any, plan: Any, world: int,
                 axis_name: str = "ccl",
                 arith_table: dict | None = None) -> list[Diagnostic]:
    raise _lifting("certify_call")


def check_batch_semantics(steps: Sequence[Any], plans: Sequence[Any],
                          world: int, axis_name: str = "ccl",
                          arith_table: dict | None = None,
                          strict: bool = False) -> list[Diagnostic]:
    raise _lifting("check_batch_semantics")


def clear_cache() -> None:
    """The reference clears its per-call verdict cache here; the port
    caches no verdict until certify_call lands, so there is nothing to
    clear."""
