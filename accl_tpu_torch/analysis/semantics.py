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

`lift_call` gives a call's DAG by evaluating the port's own schedule
body (the one `ScheduleCompiler._body` builds, through
`lowering.analysis_body`) over symbolic stacked operands (`_Lifter`, the
counterpart of the reference's jaxpr interpreter): every cross-rank
move, fold, cast and int8 encode/decode becomes a node, with exact
region intervals. `certify_call` certifies one call, its verdict cached
by static signature, and `check_batch_semantics` a batch (the default
lint tier's semantic pass, inside the reference's in-band budget unless
strict).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..constants import QUANT_BLOCK_ELEMS, Operation, ReduceFunction
from .diagnostics import Diagnostic, make
from .hopdag import (
    CONST,
    DATA,
    SCALES,
    HopDag,
    Node,
    Piece,
    Value,
    concat_values,
    slice_value,
    validate_order,
    value_length,
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
    if getattr(options, "row_layout", None) is not None:
        # a slot-driven alltoallv: where each row goes is written on the
        # card at run time, so no contract is static
        return None
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
# Lifter: the port's schedule body -> HopDag
# ---------------------------------------------------------------------------

# An element of a symbolic tensor is one int64 "address":
#   >= 0            addr * world + rank: element `addr` of the lifter's
#                   address space (each node output part owns a range),
#                   held by `rank`
#   _PENDING | ...  the same form over the in-flight space: a
#                   Wire.transfer row not yet delivered, held by its sender
#   < 0             a constant fill (-1 - index into the fill table), or
#                   _UNINIT (memory no schedule wrote)
_PENDING = 1 << 61
_MASK = _PENDING - 1
_UNINIT = -(1 << 40)
# the reference's segmented_apply unroll limit: past it, its bulk
# segments run as one lax.map body, whose hops its trace shows once
_UNROLL_LIMIT = 8


class _Grow:
    """An append-only int64 column with amortized growth, so the sorted
    address bases can be searched without copying them at every read."""

    __slots__ = ("a", "n")

    def __init__(self) -> None:
        self.a = np.empty(1024, np.int64)
        self.n = 0

    def append(self, v: int) -> None:
        if self.n == len(self.a):
            self.a = np.concatenate([self.a, np.empty_like(self.a)])
        self.a[self.n] = v
        self.n += 1

    def view(self) -> np.ndarray:
        return self.a[:self.n]


@dataclasses.dataclass(frozen=True)
class HopRecord:
    """One cross-rank hop of a recorded schedule body: its (src, dst)
    pairs in program order, the elements each pair moves, and whether it
    repeats a mapped segment's hops (the reference's trace shows the body
    of its lax.map once). `params` mirrors a ppermute equation's."""

    perm: tuple[tuple[int, int], ...]
    elems: tuple[int, ...]
    repeat: bool = False

    @property
    def params(self) -> dict:
        return {"perm": self.perm}


@dataclasses.dataclass(frozen=True)
class ScheduleTrace:
    """The port's recorded schedule body, the counterpart of the
    reference's closed jaxpr: the hop-DAG the body computes, lifted by
    evaluating it over symbolic operands, and its hops in program order
    (protocol.iter_ppermute_eqns walks them). A trace recorded for its
    hops alone skips the repeats of a mapped body (`complete` False):
    its DAG then covers the segments it evaluated only."""

    dag: HopDag
    hops: tuple[HopRecord, ...]
    complete: bool = True


class _Hop:
    __slots__ = ("channel", "perm", "elems", "repeat", "srcs", "dsts")

    def __init__(self, channel: int, repeat: bool):
        self.channel = channel
        self.repeat = repeat
        self.perm: list[tuple[int, int]] = []
        self.elems: list[int] = []
        self.srcs: set[int] = set()
        self.dsts: set[int] = set()

    def add(self, src: int, dst: int, elems: int) -> None:
        if src in self.srcs or dst in self.dsts:
            raise UnsupportedSchedule(
                f"hop {self.channel}: rank {src} -> {dst} would send or "
                "receive twice in one permute")
        self.srcs.add(src)
        self.dsts.add(dst)
        self.perm.append((src, dst))
        self.elems.append(elems)


class _Transfer:
    """One Wire.transfer call: one hop, whatever rows it delivers."""

    __slots__ = ("hop",)

    def __init__(self) -> None:
        self.hop: _Hop | None = None


@dataclasses.dataclass
class _Pending:
    """One in-flight transfer row: its sender, its message as the sender
    holds it (`msg`, `msg_len` elements), how the receiver reads the
    message back (`kind`: exact, cast or quant) and the row it carries."""

    transfer: _Transfer
    src: int
    base: int
    n: int
    kind: str
    msg: Value
    msg_len: int
    row_ids: Any
    out_dtype: Any


class _Sym:
    """A symbolic stacked tensor: what a schedule body holds while the
    lifter evaluates it. `ids` has one address per element (see above),
    `dtype` is the dtype the body believes the tensor has, and `ranked`
    says dim 0 is the rank axis (row r lives on rank r); other tensors are
    rows taken off it, each held by the rank its data came from. `clean`
    records that no element is in flight and, if ranked, that every row
    holds only its own rank's data, so ops that keep rows in place skip
    the placement check.

    Data movement (indexing, views, roll, cat, pad, where) runs on the
    addresses themselves. Folds, casts, quantization, Wire.transfer and
    Wire.exchange reach the lifter through the torch-function protocol
    and become DAG nodes; any other torch function over a symbolic
    operand raises UnsupportedSchedule naming it.

    An operand (and its clones and column slices) keeps its addresses in
    closed form, row r's column j at `bases[r] + j`, until an op needs
    them element by element (`lazy`), so a body that only slices a large
    operand into segments never builds its address array."""

    __slots__ = ("lifter", "_ids", "dtype", "ranked", "detached", "clean",
                 "lazy", "_shape")

    def __init__(self, lifter: "_Lifter", ids: Any, dtype: Any,
                 ranked: bool, detached: bool = False, clean: bool = True,
                 lazy: Any = None, shape: Any = None):
        self.lifter = lifter
        self._ids = ids
        self.dtype = dtype
        self.ranked = ranked
        self.detached = detached
        self.clean = clean
        self.lazy = lazy
        self._shape = torch.Size(shape) if shape is not None else None

    @property
    def ids(self):
        if self._ids is None:
            w = self.lifter.world
            cols = np.arange(self._shape[-1], dtype=np.int64)
            self._ids = torch.from_numpy(
                (self.lazy[:, None] + cols[None, :]) * w
                + np.arange(w, dtype=np.int64)[:, None])
        return self._ids

    def _lazy_copy(self, lazy=None, width=None, dtype=None) -> "_Sym":
        return _Sym(self.lifter, None, dtype or self.dtype, True,
                    lazy=self.lazy if lazy is None else lazy,
                    shape=(self._shape[0],
                           self._shape[-1] if width is None else width))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        lifter = next(a.lifter for a in _flat_args(args, kwargs)
                      if isinstance(a, _Sym))
        return lifter.torch_function(func, args, kwargs or {})

    def __repr__(self) -> str:
        return (f"_Sym(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"ranked={self.ranked})")

    @property
    def shape(self):
        return self._shape if self._ids is None else self._ids.shape

    @property
    def device(self):
        return torch.device("cpu")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def size(self, d: int | None = None):
        return self.shape if d is None else self.shape[d]

    def numel(self) -> int:
        return self.shape.numel()

    def __len__(self) -> int:
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx):
        if self._ids is None and isinstance(idx, tuple) and len(idx) == 2 \
                and idx[0] in (Ellipsis, slice(None)) \
                and isinstance(idx[1], slice) and idx[1].step in (None, 1):
            lo, hi, _ = idx[1].indices(self._shape[-1])
            return self._lazy_copy(self.lazy + lo, max(hi - lo, 0))
        return self.lifter.getitem(self, idx)

    def __setitem__(self, idx, value) -> None:
        self.lifter.setitem(self, idx, value)

    def untyped_storage(self):
        return self.ids.untyped_storage()

    def _view(self, ids, keeps_rows: bool | None = None) -> "_Sym":
        """A view or reshape; `keeps_rows` says dim 0 stays the same axis
        (default: when its size does)."""
        if keeps_rows is None:
            keeps_rows = ids.dim() >= 1 and ids.shape[0] == self.ids.shape[0]
        out = self.lifter.moved(ids, self.dtype, self.ranked,
                                self.clean and (keeps_rows
                                                or not self.ranked))
        out.detached = out.detached or self.detached
        return out

    def _axes_op(self, name: str, *args) -> "_Sym":
        """movedim / transpose: dim 0 stays iff a probe of distinct sizes
        keeps its first size."""
        probe = torch.empty(tuple(range(2, self.ids.dim() + 2)))
        keeps = getattr(probe, name)(*args).shape[0] == 2
        return self._view(getattr(self.ids, name)(*args), keeps)

    def clone(self, *args, **kwargs) -> "_Sym":
        if self._ids is None:
            return self._lazy_copy()
        return self.lifter.moved(self.ids.clone(), self.dtype, self.ranked,
                                 self.clean)

    def contiguous(self, *args, **kwargs) -> "_Sym":
        if self._ids is None:
            return self._lazy_copy()
        # a view whose rows moved is copied by contiguous() in the body
        # (a transpose is never contiguous), so the copy is writable
        return self.lifter.moved(self.ids.contiguous(), self.dtype,
                                 self.ranked, self.clean)

    def reshape(self, *shape) -> "_Sym":
        return self._view(self.ids.reshape(*shape))

    def view(self, *shape) -> "_Sym":
        if len(shape) == 1 and isinstance(shape[0], torch.dtype):
            raise UnsupportedSchedule("a bitcast view of payload")
        return self._view(self.ids.view(*shape))

    def flatten(self, *args) -> "_Sym":
        return self._view(self.ids.flatten(*args))

    def unflatten(self, *args) -> "_Sym":
        return self._view(self.ids.unflatten(*args))

    def movedim(self, *args) -> "_Sym":
        return self._axes_op("movedim", *args)

    def transpose(self, *args) -> "_Sym":
        return self._axes_op("transpose", *args)


    def _new(self, size, fill_id: int, dtype) -> "_Sym":
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        ids = torch.full(tuple(size), fill_id, dtype=torch.int64)
        return self.lifter.moved(ids, dtype or self.dtype,
                                 self.ranked and len(size) > 0
                                 and size[0] == self.lifter.world, True)

    def new_zeros(self, *size, dtype=None, **kwargs) -> "_Sym":
        return self._new(size, self.lifter.fill_id(0.0), dtype)

    def new_empty(self, *size, dtype=None, **kwargs) -> "_Sym":
        return self._new(size, _UNINIT, dtype)

    def __getattr__(self, name: str):
        if name.startswith("__"):  # protocol probes (hasattr) stay quiet
            raise AttributeError(name)
        # a tensor method the lifter does not model: no claim is made
        raise UnsupportedSchedule(f"Tensor.{name} over abstract payload")


def _flat_args(args, kwargs):
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _np(ids: Any) -> np.ndarray:
    """The numpy view of an address array (torch or numpy)."""
    return ids if isinstance(ids, np.ndarray) else ids.numpy()


def _dtype_name(dtype: Any) -> str:
    return str(dtype).removeprefix("torch.")


def _rank_axis_index(idx: Any, world: int) -> tuple[bool, bool]:
    """How indexing a ranked tensor with `idx` treats dim 0: (it stays
    the rank axis, its rows stay in place). It stays for dim 0 untouched,
    a full slice, or an index of W rows; the rows stay in place unless
    that index permutes them (they then move)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if not idx or idx[0] is Ellipsis:
        return True, True
    first = idx[0]
    if isinstance(first, slice):
        full = first.indices(world) == (0, world, 1)
        return full, full
    if isinstance(first, (list, tuple)):
        first = torch.tensor(first)
    if (isinstance(first, torch.Tensor) and first.dtype != torch.bool
            and first.dim() == 1 and first.shape[0] == world):
        return True, bool(torch.equal(first.to(torch.int64),
                                      torch.arange(world)))
    return False, False


class _Lifter:
    """Evaluates one schedule body over symbolic stacked operands and
    records the hop-DAG it computes (module docstring of this section).

    Placement: a ranked tensor's row r is rank r's; a row taken off it
    (a slice, a gather of some rows) stays with the rank its data came
    from. Data lands on another rank only where the body puts it into
    another rank's row: a roll or gather of the rank axis, a transpose
    that brings another axis of W to dim 0, a write into another rank's
    row. Each such op's moves become send/recv nodes: one hop when its
    (src, dst) pairs form a permutation, else one hop per shift
    (dst - src) mod W in increasing order, as the reference's pairwise
    rotation. A Wire.transfer call is one hop wherever its rows land: its
    rows stay in flight (encoded or cast at the sender) until a write or
    a fold places them, and the receiver decodes or casts back."""

    def __init__(self, world: int, complete: bool = True):
        self.world = world
        self.complete = complete
        self.nodes: list[Node] = []
        self.hop_log: list[_Hop] = []
        self.repeat = False
        self._next = 0
        # the address ranges' starts (increasing) and their (node, part)
        self._seg_base: list[int] = []
        self._seg_node: list[int] = []
        self._seg_part: list[str] = []
        self._fills: dict[Any, int] = {}
        self._fill_vals: list[float] = []
        self._pend: list[_Pending] = []
        self._pend_base = _Grow()
        self._pnext = 0
        self._handlers = self._handler_table()

    # -- addresses and values ----------------------------------------------

    def fill_id(self, value: float) -> int:
        key = "nan" if value != value else value
        k = self._fills.get(key)
        if k is None:
            k = self._fills[key] = len(self._fill_vals)
            self._fill_vals.append(value)
        return -1 - k

    def emit(self, kind: str, rank: int, length: int, **kw: Any) -> int:
        """Append a node; returns the address base of its data output
        (an encode's scales follow at the next range)."""
        nid = len(self.nodes)
        self.nodes.append(Node(id=nid, kind=kind, rank=int(rank),
                               length=int(length), **kw))
        base = self._alloc(nid, DATA, length)
        if kind == "encode":
            self._alloc(nid, SCALES, int(kw["scales_len"]))
        return base

    def _alloc(self, nid: int, part: str, length: int) -> int:
        base = self._next
        self._next += length + 1  # a gap: a run never spans two ranges
        self._seg_base.append(base)
        self._seg_node.append(nid)
        self._seg_part.append(part)
        return base

    def node_ids(self, base: int, length: int, rank: int) -> np.ndarray:
        return (base + np.arange(length, dtype=np.int64)) * self.world + rank

    def value(self, ids: Any, rank: int) -> Value:
        """The piece list of a 1-D run of addresses, all held by `rank`
        (or constant): maximal runs of consecutive addresses become one
        piece each."""
        a = (ids if isinstance(ids, np.ndarray) else ids.numpy()).reshape(-1)
        if a.size == 0:
            return ()
        w = self.world
        first = int(a[0])
        if 0 <= first < _PENDING and first % w == rank and (
                a.size == 1 or (a[1:] - a[:-1] == w).all()):
            # one run of consecutive addresses (the common case): a range
            # gap separates node outputs, so it lies in one range
            addr = first // w
            k = bisect.bisect_right(self._seg_base, addr) - 1
            return (Piece(a.size, self._seg_node[k],
                          addr - self._seg_base[k], self._seg_part[k]),)
        neg = a < 0
        if (a >= _PENDING).any():
            raise UnsupportedSchedule(
                "data in flight reaches a node before it lands")
        if (a == _UNINIT).any():
            raise UnsupportedSchedule(
                "memory no schedule step wrote reaches the payload")
        if (a[~neg] % w != rank).any():
            raise UnsupportedSchedule(
                f"a rank-{rank} node reads another rank's data")
        addr = np.where(neg, a, a // w)
        cont = np.zeros(a.size, bool)
        cont[1:] = np.where(neg[1:], neg[:-1] & (a[1:] == a[:-1]),
                            ~neg[:-1] & (addr[1:] == addr[:-1] + 1))
        starts = np.flatnonzero(~cont).tolist()
        ends = starts[1:] + [a.size]
        out = []
        for lo, hi in zip(starts, ends):
            v = int(a[lo])
            if v < 0:
                out.append(Piece(hi - lo, CONST, 0, DATA,
                                 self._fill_vals[-1 - v]))
            else:
                ad = int(addr[lo])
                k = bisect.bisect_right(self._seg_base, ad) - 1
                out.append(Piece(hi - lo, self._seg_node[k],
                                 ad - self._seg_base[k], self._seg_part[k]))
        return tuple(out)

    def ids_of(self, v: Any) -> Any:
        """Addresses of a body value: a symbolic tensor's own, a concrete
        tensor or number as constant fill (only a uniform one: concrete
        data is never payload)."""
        if isinstance(v, _Sym):
            return v.ids
        if isinstance(v, torch.Tensor):
            flat = v.reshape(-1)
            if flat.numel() == 0:
                return torch.empty(v.shape, dtype=torch.int64)
            first = flat[0]
            same = (flat == first) | (torch.isnan(flat) & torch.isnan(first))
            if not bool(same.all()):
                raise UnsupportedSchedule(
                    "non-uniform concrete data flows into the payload path")
            return torch.full(v.shape, self.fill_id(float(first)),
                              dtype=torch.int64)
        if isinstance(v, (bool, int, float)):
            return torch.tensor(self.fill_id(float(v)), dtype=torch.int64)
        raise UnsupportedSchedule(f"{type(v).__name__} in the payload path")

    def rows_grid(self, shape) -> Any:
        w = self.world
        return torch.arange(w, dtype=torch.int64).view(
            w, *([1] * (len(shape) - 1))).expand(shape)

    def row_locs(self, sym: _Sym) -> Any:
        """The rank holding each dim-0 row of `sym`: row r of a ranked
        tensor; for rows taken off the rank axis, the one rank all their
        data comes from, else each row's own."""
        ids = sym.ids
        if ids.dim() == 0:
            raise UnsupportedSchedule("a scalar payload")
        k = ids.shape[0]
        if sym.ranked:
            return np.arange(k, dtype=np.int64)
        flat = _np(ids).reshape(k, -1)
        data = flat >= 0
        own = np.where(data, (flat & _MASK) % self.world, -1)
        held = np.unique(own[data])
        if held.size == 1:
            return np.full(k, held[0], dtype=np.int64)
        lo = np.where(data, own, self.world).min(axis=1)
        hi = own.max(axis=1)
        if (hi < 0).any():
            raise UnsupportedSchedule("a row of constants held by no rank")
        if (lo != hi).any():
            raise UnsupportedSchedule("a row holds more than one rank's data")
        return lo

    def elem_locs(self, sym: _Sym) -> np.ndarray:
        locs = self.row_locs(sym)
        return np.broadcast_to(
            locs.reshape(-1, *([1] * (sym.ids.dim() - 1))), sym.ids.shape)

    # -- placement ---------------------------------------------------------

    def moved(self, ids: Any, dtype: Any, ranked: bool,
              clean: bool = False) -> _Sym:
        """Wrap an op's result; a ranked result whose row r holds data of
        another rank (or data in flight) has it delivered to r. `clean`
        vouches that the op kept every row in place over clean inputs."""
        w = self.world
        ranked = bool(ranked and ids.dim() >= 1 and ids.shape[0] == w)
        if not ranked:
            return _Sym(self, ids, dtype, False, clean=clean)
        if not clean and ids.numel():
            a = ids.numpy()
            rows = np.arange(w).reshape(w, *([1] * (a.ndim - 1)))
            bad = (a >= 0) & ((a >= _PENDING) | ((a & _MASK) % w != rows))
            if bad.any():
                (ids,) = self.pin([(ids, rows)])
                return _Sym(self, ids, dtype, True, detached=True)
        return _Sym(self, ids, dtype, ranked)

    def new_hop(self) -> _Hop:
        h = _Hop(len(self.hop_log), self.repeat)
        self.hop_log.append(h)
        return h

    def pin(self, items: list) -> list:
        """Deliver each (addresses, destination ranks) item: data in
        flight lands through its transfer's hop, data held by another rank
        moves. Moves of one call share their hops, and a (src, dst) pair's
        elements over all items travel as one message (the codes and
        scales of an encoded pair: the reference's packed message).
        Returns the new addresses."""
        w = self.world
        flats, dests = [], []
        for ids, dest in items:
            flats.append(np.array(_np(ids)).reshape(-1))
            dests.append(np.broadcast_to(np.asarray(dest), ids.shape)
                         .reshape(-1))
        # 1. in-flight rows land where they are read
        hits: list = []
        reqs: set[tuple[int, int]] = set()
        pbase = self._pend_base.view()
        for f, d in zip(flats, dests):
            pos = np.flatnonzero(f >= _PENDING)
            if not pos.size:
                hits.append(None)
                continue
            paddr = (f[pos] & _MASK) // w
            rec = np.searchsorted(pbase, paddr, "right") - 1
            key = rec * w + d[pos]
            hits.append((pos, paddr, key))
            for k in np.unique(key).tolist():
                reqs.add((k // w, k % w))
        if reqs:
            got = self._deliver(sorted(reqs))
            for f, h in zip(flats, hits):
                if h is None:
                    continue
                pos, paddr, key = h
                order = np.argsort(key, kind="stable")
                keys, starts = np.unique(key[order], return_index=True)
                ends = np.append(starts[1:], order.size)
                for k, lo, hi in zip(keys.tolist(), starts.tolist(),
                                     ends.tolist()):
                    r, dst = k // w, k % w
                    sel = order[lo:hi]
                    off = paddr[sel] - self._pend[r].base
                    res = got[(r, dst)]
                    if isinstance(res, np.ndarray):
                        f[pos[sel]] = res[off]
                    else:
                        f[pos[sel]] = (res + off) * w + dst
        # 2. data held by another rank moves
        groups: dict[tuple[int, int], list] = {}
        for i, (f, d) in enumerate(zip(flats, dests)):
            pos = np.flatnonzero((f >= 0) & (f % w != d))
            if not pos.size:
                continue
            key = (f[pos] % w) * w + d[pos]
            order = np.argsort(key, kind="stable")
            keys, starts = np.unique(key[order], return_index=True)
            ends = np.append(starts[1:], order.size)
            for k, lo, hi in zip(keys.tolist(), starts.tolist(),
                                 ends.tolist()):
                groups.setdefault((k // w, k % w), []).append(
                    (i, pos[order[lo:hi]]))
        for pairs in _hop_plan(sorted(groups), w):
            hop = self.new_hop()
            lens = []
            for s, d in pairs:
                msg = concat_values(*(self.value(flats[i][p], s)
                                      for i, p in groups[(s, d)]))
                lens.append(value_length(msg))
                hop.add(s, d, lens[-1])
                self.emit("send", s, lens[-1], value=msg, hop=hop.channel,
                          peer=d)
            for (s, d), n in zip(pairs, lens):
                base = self.emit("recv", d, n, hop=hop.channel, peer=s)
                off = 0
                for i, p in groups[(s, d)]:
                    flats[i][p] = self.node_ids(base + off, p.size, d)
                    off += p.size
        return [torch.from_numpy(f).reshape(tuple(ids.shape))
                for f, (ids, _) in zip(flats, items)]

    def _deliver(self, reqs: list) -> dict:
        """Land in-flight rows: (row record, destination) -> the landed
        row's addresses (a tensor) or address base (an int). A row read
        on its own rank crosses no wire but still takes the receiver's
        transform (decode or cast back)."""
        cross = []
        for r, d in reqs:
            rec = self._pend[r]
            if d == rec.src:
                continue
            t = rec.transfer
            if t.hop is None:
                t.hop = self.new_hop()
            t.hop.add(rec.src, d, rec.msg_len)
            cross.append((r, d))
        for r, d in cross:
            rec = self._pend[r]
            self.emit("send", rec.src, rec.msg_len, value=rec.msg,
                      hop=rec.transfer.hop.channel, peer=d)
        landed = {}
        for r, d in cross:
            rec = self._pend[r]
            base = self.emit("recv", d, rec.msg_len,
                             hop=rec.transfer.hop.channel, peer=rec.src)
            landed[(r, d)] = ((Piece(rec.msg_len, len(self.nodes) - 1),),
                              base)
        out: dict = {}
        for r, d in reqs:
            rec = self._pend[r]
            msg, base = landed.get((r, d), (rec.msg, None))
            if rec.kind == "exact":
                out[(r, d)] = rec.row_ids if base is None else base
            elif rec.kind == "cast":
                out[(r, d)] = self.emit("cast", d, rec.n, value=msg,
                                        dtype=_dtype_name(rec.out_dtype))
            else:
                nb = rec.msg_len - rec.n
                base = self.emit("decode", d, rec.n,
                                 value=slice_value(msg, 0, rec.n),
                                 value2=slice_value(msg, rec.n, nb))
                if rec.out_dtype != torch.float32:
                    base = self.emit("cast", d, rec.n,
                                     value=(Piece(rec.n, len(self.nodes) - 1),),
                                     dtype=_dtype_name(rec.out_dtype))
                out[(r, d)] = base
        return out

    # -- the op handlers -----------------------------------------------------

    def _handler_table(self) -> dict:
        import torch.nn.functional as F

        from ..ops import compression, lane_kernels
        from ..sequencer import schedules

        return {
            torch.roll: self._roll,
            torch.cat: self._cat,
            torch.where: self._where,
            torch.zeros_like: self._zeros_like,
            F.pad: self._pad,
            lane_kernels.cast: self._cast,
            lane_kernels.combine: self._combine,
            lane_kernels.combine_cast: self._combine_cast,
            compression.quantize_blockwise: self._quantize,
            compression.dequantize_blockwise: self._dequantize,
            compression.dequant_combine: self._dequant_combine,
            compression.dequant_combine_requant: self._dequant_requant,
            schedules.Wire.transfer: self._transfer,
            schedules.Wire.exchange: self._exchange,
            schedules.segmented_apply: self._segmented,
        }

    def torch_function(self, func, args, kwargs) -> Any:
        handler = self._handlers.get(func)
        if handler is None:
            name = getattr(func, "__qualname__", None) or repr(func)
            raise UnsupportedSchedule(f"{name!r} over abstract payload")
        return handler(*args, **kwargs)

    def getitem(self, sym: _Sym, idx: Any) -> _Sym:
        ids = sym.ids[idx]
        if not sym.ranked:
            return self.moved(ids, sym.dtype, False, sym.clean)
        ranked, in_place = _rank_axis_index(idx, self.world)
        return self.moved(ids, sym.dtype, ranked, sym.clean and in_place)

    def setitem(self, sym: _Sym, idx: Any, value: Any) -> None:
        if sym.detached:
            raise UnsupportedSchedule(
                "a write through a view whose rows moved")
        target = sym.ids
        vals = self.ids_of(value)
        if sym.ranked:
            dest = self.rows_grid(target.shape)[idx]
            (vals,) = self.pin([(torch.broadcast_to(vals, dest.shape), dest)])
        elif bool((vals >= _PENDING).any()):
            raise UnsupportedSchedule("data in flight written off the rank "
                                      "axis")
        target[idx] = vals

    def _roll(self, x: _Sym, shifts, dims=None) -> _Sym:
        dims_t = dims if isinstance(dims, (tuple, list)) else (dims,)
        in_place = dims is not None and all(
            d % x.ids.dim() != 0 for d in dims_t)
        return self.moved(torch.roll(x.ids, shifts, dims), x.dtype, x.ranked,
                          x.clean and in_place)

    def _cat(self, tensors, dim: int = 0) -> _Sym:
        syms = [t for t in tensors if isinstance(t, _Sym)]
        ids = torch.cat([self.ids_of(t) for t in tensors], dim)
        return self.moved(ids, syms[0].dtype, all(s.ranked for s in syms),
                          all(s.clean for s in syms)
                          and dim % ids.dim() != 0)

    def _where(self, cond, a, b) -> _Sym:
        if isinstance(cond, _Sym):
            raise UnsupportedSchedule("a data-dependent select")
        syms = [v for v in (a, b) if isinstance(v, _Sym)]
        ids = torch.where(cond, self.ids_of(a), self.ids_of(b))
        return self.moved(ids, syms[0].dtype, any(s.ranked for s in syms),
                          all(s.clean and s.shape == ids.shape
                              for s in syms))

    def _zeros_like(self, x: _Sym, *, dtype=None, **kwargs) -> _Sym:
        return self.moved(torch.full(x.shape, self.fill_id(0.0),
                                     dtype=torch.int64),
                          dtype or x.dtype, x.ranked, True)

    def _pad(self, x: _Sym, pad, mode: str = "constant", value=None) -> _Sym:
        if mode != "constant":
            raise UnsupportedSchedule(f"{mode} padding of payload")
        fill = self.fill_id(0.0 if value is None else float(value))
        return self.moved(torch.nn.functional.pad(x.ids, pad, value=fill),
                          x.dtype, x.ranked,
                          x.clean and len(pad) < 2 * x.ids.dim())

    def _nodes_by_rank(self, locs: Any, build) -> Any:
        """One node per rank over the elements it holds (flat order):
        `build(rank, positions)` emits it and returns its address base.
        Returns the result's addresses, shaped like `locs`."""
        flat = np.asarray(locs).reshape(-1)
        out = np.empty(flat.shape, dtype=np.int64)
        order = np.argsort(flat, kind="stable")
        ranks, starts = np.unique(flat[order], return_index=True)
        ends = np.append(starts[1:], flat.size)
        for r, lo, hi in zip(ranks.tolist(), starts.tolist(), ends.tolist()):
            pos = order[lo:hi]
            out[pos] = self.node_ids(build(r, pos), hi - lo, r)
        return torch.from_numpy(out.reshape(np.shape(locs)))

    def _cast_at(self, ids: Any, dest: Any, dtype) -> Any:
        flat = _np(ids).reshape(-1)

        def build(r, pos):
            return self.emit("cast", r, pos.size,
                             value=self.value(flat[pos], r),
                             dtype=_dtype_name(dtype))

        return self._nodes_by_rank(dest, build)

    def _local(self, *operands) -> bool:
        """Whether a lift for hops alone can skip a local op: every
        operand still in closed form (held in place, nothing in flight),
        so the result's placement is its operand's and no hop can come of
        it."""
        return not self.complete and all(
            isinstance(v, _Sym) and v._ids is None for v in operands)

    def _cast(self, x: _Sym, dtype) -> _Sym:
        if dtype == x.dtype:
            return x
        if self._local(x):
            return x._lazy_copy(dtype=dtype)
        if (_np(x.ids) >= _PENDING).any():
            raise UnsupportedSchedule("a cast of data in flight")
        return _Sym(self, self._cast_at(x.ids, self.elem_locs(x), dtype),
                    dtype, x.ranked)

    def _place_pair(self, a: Any, b: Any):
        """A fold's two operands on the ranks holding the one not in
        flight (the other lands there): (that operand, both operands'
        flat addresses, the destination ranks)."""
        ia, ib = np.broadcast_arrays(_np(self.ids_of(a)),
                                     _np(self.ids_of(b)))
        pa, pb = (ia >= _PENDING).any(), (ib >= _PENDING).any()
        if pa and pb:
            raise UnsupportedSchedule("a fold of two operands in flight")
        local = b if pa or not isinstance(a, _Sym) else a
        if not isinstance(local, _Sym):
            raise UnsupportedSchedule("a fold of constants")
        dest = np.broadcast_to(self.elem_locs(local), ia.shape)
        if pa:
            (ia,) = self.pin([(ia, dest)])
        elif pb:
            (ib,) = self.pin([(ib, dest)])
        ia, ib = _np(ia).reshape(-1), _np(ib).reshape(-1)
        flat_dest = dest.reshape(-1)
        for ids in (ia, ib):
            if ((ids >= 0) & (ids % self.world != flat_dest)).any():
                raise UnsupportedSchedule(
                    "a fold's operands live on different ranks")
        return local, ia, ib, dest

    def _fold(self, ia: Any, ib: Any, dest: Any, op: str) -> Any:
        def build(r, pos):
            return self.emit("combine", r, pos.size, func=op,
                             value=self.value(ia[pos], r),
                             value2=self.value(ib[pos], r))

        return self._nodes_by_rank(dest, build)

    def _combine(self, a, b, op: str) -> _Sym:
        if self._local(a, b):
            return a._lazy_copy()
        local, ia, ib, dest = self._place_pair(a, b)
        return _Sym(self, self._fold(ia, ib, dest, op), local.dtype,
                    local.ranked)

    def _combine_cast(self, a, b, op: str, acc=torch.float32,
                      out=None) -> _Sym:
        """Widen, fold, round once: casts to the accumulator dtype around
        one combine node per rank."""
        if self._local(a, b):
            return a._lazy_copy(dtype=out or a.dtype)
        local, ia, ib, dest = self._place_pair(a, b)
        out = out or local.dtype
        if local.dtype != acc:
            ia = _np(self._cast_at(ia, dest, acc)).reshape(-1)
            ib = _np(self._cast_at(ib, dest, acc)).reshape(-1)
        ids = self._fold(ia, ib, dest, op)
        if out != acc:
            ids = self._cast_at(ids, dest, out)
        return _Sym(self, ids, out, local.ranked)

    def _rows2(self, sym: _Sym, what: str):
        if sym.ids.dim() != 2:
            raise UnsupportedSchedule(f"{what} of a {sym.ids.dim()}-d payload")
        return sym.ids

    def _quantize(self, x: _Sym):
        if self._local(x):
            nb = -(-x.shape[-1] // QUANT_BLOCK_ELEMS)
            return (x._lazy_copy(dtype=torch.int8),
                    x._lazy_copy(width=nb, dtype=torch.float32))
        ids = self._rows2(x, "an encode")
        if (_np(ids) >= _PENDING).any():
            raise UnsupportedSchedule("an encode of data in flight")
        k, n = ids.shape
        nb = -(-n // QUANT_BLOCK_ELEMS)
        locs = self.row_locs(x).tolist()
        q = np.empty((k, n), dtype=np.int64)
        s = np.empty((k, nb), dtype=np.int64)
        for i, r in enumerate(locs):
            base = self.emit("encode", r, n, scales_len=nb,
                             value=self.value(ids[i], r), dtype="int8")
            q[i] = self.node_ids(base, n, r)
            s[i] = self.node_ids(base + n + 1, nb, r)
        return (_Sym(self, torch.from_numpy(q), torch.int8, x.ranked),
                _Sym(self, torch.from_numpy(s), torch.float32, x.ranked))

    def _landed_pair(self, q: _Sym, s: _Sym, locs, n: int):
        qi = self._rows2(q, "a decode")[:, :n]
        si = self._rows2(s, "a decode")
        col = locs.reshape(-1, 1)
        return self.pin([(qi, col), (si, col)])

    def _dequantize(self, q: _Sym, scales: _Sym, n: int,
                    out_dtype=torch.float32) -> _Sym:
        if self._local(q, scales):
            return q._lazy_copy(width=n, dtype=out_dtype)
        locs = self.row_locs(q)
        qi, si = self._landed_pair(q, scales, locs, n)
        out = np.empty((qi.shape[0], n), dtype=np.int64)
        for i, r in enumerate(locs.tolist()):
            base = self.emit("decode", r, n, value=self.value(qi[i], r),
                             value2=self.value(si[i], r))
            out[i] = self.node_ids(base, n, r)
        res = _Sym(self, torch.from_numpy(out), torch.float32, q.ranked)
        return self._cast(res, out_dtype)

    def _dequant_fold(self, q: _Sym, scales: _Sym, local: _Sym, op: str,
                      requant: bool):
        """The fused ring steps, as the reference's markers lift them:
        decode, combine with the local operand (and re-encode) on the
        rank holding the local operand."""
        if self._local(q, scales, local):
            if not requant:
                return local._lazy_copy()
            nb = -(-local.shape[-1] // QUANT_BLOCK_ELEMS)
            return (local._lazy_copy(dtype=torch.int8),
                    local._lazy_copy(width=nb, dtype=torch.float32))
        li = self._rows2(local, "a fused decode")
        k, n = li.shape
        locs = self.row_locs(local)
        qi, si = self._landed_pair(q, scales, locs, n)
        nb = -(-n // QUANT_BLOCK_ELEMS)
        out = np.empty((k, n), dtype=np.int64)
        scl = np.empty((k, nb), dtype=np.int64)
        for i, r in enumerate(locs.tolist()):
            self.emit("decode", r, n, value=self.value(qi[i], r),
                      value2=self.value(si[i], r))
            dec = len(self.nodes) - 1
            base = self.emit("combine", r, n, func=op,
                             value=(Piece(n, dec),),
                             value2=self.value(li[i], r))
            if requant:
                cmb = len(self.nodes) - 1
                base = self.emit("encode", r, n, scales_len=nb,
                                 value=(Piece(n, cmb),), dtype="int8")
                scl[i] = self.node_ids(base + n + 1, nb, r)
            out[i] = self.node_ids(base, n, r)
        if requant:
            return (_Sym(self, torch.from_numpy(out), torch.int8,
                         local.ranked),
                    _Sym(self, torch.from_numpy(scl), torch.float32,
                         local.ranked))
        return _Sym(self, torch.from_numpy(out), local.dtype, local.ranked)

    def _dequant_combine(self, q, scales, local, func_op: str):
        return self._dequant_fold(q, scales, local, func_op, False)

    def _dequant_requant(self, q, scales, local, func_op: str):
        return self._dequant_fold(q, scales, local, func_op, True)

    def _transfer(self, wire: Any, rows: _Sym) -> _Sym:
        """One wire crossing: each dim-0 row leaves its rank as a message
        (as is, cast to the wire dtype, or encoded), in flight until read."""
        from ..ops.compression import wire_dtype

        ids = rows.ids
        k = ids.shape[0]
        flat = _np(ids).reshape(k, -1)
        if (flat >= _PENDING).any():
            raise UnsupportedSchedule("a transfer of data already in flight")
        n = flat.shape[1]
        locs = self.row_locs(rows).tolist()
        t = _Transfer()
        out = np.empty((k, n), dtype=np.int64)
        wd = wire_dtype(wire.cfg) if wire.cfg is not None else None
        for i, src in enumerate(locs):
            row = flat[i].copy()
            value = self.value(row, src)
            if wire.quantized:
                if ids.dim() != 2:
                    raise UnsupportedSchedule(
                        f"an encoded transfer of {ids.dim()}-d rows")
                nb = -(-n // QUANT_BLOCK_ELEMS)
                self.emit("encode", src, n, scales_len=nb, value=value,
                          dtype="int8")
                enc = len(self.nodes) - 1
                kind, msg = "quant", (Piece(n, enc),
                                      Piece(nb, enc, 0, SCALES))
            elif wd is not None and wd != rows.dtype:
                self.emit("cast", src, n, value=value,
                          dtype=_dtype_name(wd))
                kind, msg = "cast", (Piece(n, len(self.nodes) - 1),)
            else:
                kind, msg = "exact", value
            base = self._pnext
            self._pnext += n + 1
            self._pend_base.append(base)
            self._pend.append(_Pending(t, src, base, n, kind, msg,
                                       value_length(msg), row, rows.dtype))
            out[i] = _PENDING | ((base + np.arange(n, dtype=np.int64))
                                 * self.world + src)
        return _Sym(self, torch.from_numpy(out).reshape(ids.shape),
                    rows.dtype, rows.ranked, clean=False)

    def _exchange(self, wire: Any, enc, world: int):
        """The block-aligned exchange: the body's own transposes of codes
        and scales, each (src, dst) pair's codes and scales one message."""
        from ..sequencer.schedules import _exchange_slots

        q, s = enc
        qi, si = (_exchange_slots(t.ids, world) for t in (q, s))
        qi, si = self.pin([(qi, self.rows_grid(qi.shape)),
                           (si, self.rows_grid(si.shape))])
        return (_Sym(self, qi, q.dtype, True),
                _Sym(self, si, s.dtype, True))

    def _segmented(self, one_segment, x: _Sym, seg_count: int,
                   overlap_slots: int = 0) -> _Sym:
        """The port's eager segment loop, marking the hops of every bulk
        segment after the first as repeats where the reference maps its
        bulk segments with one body (more than _UNROLL_LIMIT of them). A
        lift for hops alone does not evaluate the repeats (their operand
        stands in for their result), as the reference traces its mapped
        body once."""
        from ..sequencer.schedules import _segmented_apply

        count = x.shape[-1]
        num_bulk = count // seg_count
        mapped = count > seg_count and num_bulk > _UNROLL_LIMIT
        if mapped and not self.complete:
            # the mapped body once, then the tail; the operand stands in
            # for the result (a hop record needs no output)
            for lo in sorted({0, num_bulk * seg_count} - {count}):
                seg = x[..., lo:lo + seg_count]
                one_segment(seg, 0) if overlap_slots else one_segment(seg)
            return x
        calls = [0]

        def segment(*args):
            i = calls[0]
            calls[0] += 1
            outer = self.repeat
            self.repeat = outer or (mapped and 0 < i < num_bulk)
            try:
                return one_segment(*args)
            finally:
                self.repeat = outer

        return _segmented_apply(segment, x, seg_count, overlap_slots)

    # -- running a body ----------------------------------------------------

    def run(self, body, n_in: int, in_elems: int, dtype) -> ScheduleTrace:
        w = self.world
        args = []
        for slot in range(n_in):
            bases = np.array([self.emit("arg", r, in_elems, arg=slot,
                                        dtype=_dtype_name(dtype))
                              for r in range(w)], dtype=np.int64)
            args.append(_Sym(self, None, dtype, True, lazy=bases,
                             shape=(w, in_elems)))
        out = body(*args)
        if not isinstance(out, _Sym):
            raise UnsupportedSchedule("a schedule body whose result is not "
                                      "its operands' data")
        if not out.ranked:
            raise UnsupportedSchedule("a schedule result off the rank axis")
        outputs: tuple = ()
        if self.complete:
            ids = self.moved(out.ids, out.dtype, True).ids
            outputs = tuple(self.value(ids[r], r) for r in range(w))
        dag = HopDag(world=w, n_in=n_in, in_elems=in_elems,
                     out_elems=max((value_length(v) for v in outputs),
                                   default=0),
                     nodes=tuple(self.nodes), outputs=outputs)
        hops = tuple(HopRecord(tuple(h.perm), tuple(h.elems), h.repeat)
                     for h in self.hop_log if h.perm)
        return ScheduleTrace(dag, hops, self.complete)


def _hop_plan(pairs: list[tuple[int, int]], world: int) -> list[list]:
    """One op's moves as hops: a single hop when no rank sends or
    receives twice, else one hop per shift (dst - src) mod W in increasing
    order; pairs in source order."""
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts):
        return [sorted(pairs)] if pairs else []
    by_shift: dict[int, list] = {}
    for s, d in pairs:
        by_shift.setdefault((d - s) % world, []).append((s, d))
    return [sorted(by_shift[k]) for k in sorted(by_shift)]


def lift_call(options: Any, plan: Any, world: int,
              axis_name: str = "ccl",
              arith_table: dict | None = None) -> HopDag:
    """Lift ONE call's schedule body into the hop-DAG IR (the shared
    seam: `protocol.trace_schedule_jaxpr`). Needs no device."""
    from .protocol import trace_schedule_jaxpr

    trace, _, _ = trace_schedule_jaxpr(options, plan, world, axis_name,
                                       arith_table=arith_table,
                                       semantic_marks=True)
    return trace.dag


# ---------------------------------------------------------------------------
# Cached entry points (the lint-tier surface)
# ---------------------------------------------------------------------------

# key -> (arith_table ref, verdict tuple); the table reference pins the
# id() component of the key against reuse after GC
_CERT_CACHE: dict[tuple, tuple[Any, tuple[Diagnostic, ...]]] = {}
_CERT_CACHE_CAP = 4096

# In-band budget, the reference's: a heavily segmented schedule (hundreds
# of eager segments x world ranks) costs whole seconds to lift, too slow
# for the lint stage in front of every first-time compile. Batches past
# these bounds skip the in-band certification (the step still gets every
# other pass); the strict sweep (analysis/corpus.py) has no budget.
_INBAND_MAX_SEGMENTS = 64
_INBAND_MAX_ELEMS = 1 << 19


def _within_inband_budget(options: Any, plan: Any, world: int) -> bool:
    # only the allreduce ring segments its own body (segmented_apply);
    # other plans' num_segments describe the transport, not the body
    if (options.scenario == Operation.allreduce
            and int(getattr(plan, "num_segments", 1)) > _INBAND_MAX_SEGMENTS):
        return False
    return int(options.count) * world <= _INBAND_MAX_ELEMS


def clear_cache() -> None:
    """Drop every cached verdict."""
    _CERT_CACHE.clear()


def certify_call(options: Any, plan: Any, world: int,
                 axis_name: str = "ccl",
                 arith_table: dict | None = None) -> list[Diagnostic]:
    """Certify ONE call: lift its schedule body and check the final
    contribution sets against `collective_spec`. Verdicts are cached by
    the call's static signature (the key class the compile cache uses),
    so re-linting a recorded shape costs a dict hit."""
    spec = collective_spec(options, world)
    if spec is None or world < 2:
        return []
    # custom tables key by identity; the table object rides the cache
    # value so its id can never be reused for a different table
    key = (options.signature(), plan, world, axis_name,
           0 if arith_table is None else id(arith_table))
    cached = _CERT_CACHE.get(key)
    if cached is not None:
        return list(cached[1])
    dag = lift_call(options, plan, world, axis_name,
                    arith_table=arith_table)
    diags = certify(dag, spec, options.scenario.name)
    if len(_CERT_CACHE) >= _CERT_CACHE_CAP:
        _CERT_CACHE.clear()
    _CERT_CACHE[key] = (arith_table, tuple(diags))
    return diags


def check_batch_semantics(steps: Sequence[Any], plans: Sequence[Any],
                          world: int, axis_name: str = "ccl",
                          arith_table: dict | None = None,
                          strict: bool = False) -> list[Diagnostic]:
    """The batch-level pass the linter's default tier runs: certify each
    step's schedule against its declared collective, one lift per step.
    A step the lifter cannot analyze is SKIPPED unless `strict`, which
    re-raises UnsupportedSchedule: inability is never a wrong-result
    claim."""
    diags: list[Diagnostic] = []
    for k, (opts, plan) in enumerate(zip(steps, plans)):
        if not strict and not _within_inband_budget(opts, plan, world):
            continue
        try:
            step_diags = certify_call(opts, plan, world, axis_name,
                                      arith_table=arith_table)
        except UnsupportedSchedule:
            if strict:
                raise
            continue
        except Exception as e:  # analysis must never break dispatch
            if strict:
                raise UnsupportedSchedule(
                    f"step {k} ({opts.scenario.name}): lifter error "
                    f"{e!r}") from e
            continue
        for d in step_diags:
            diags.append(Diagnostic(d.code, d.message, step=k,
                                    rank=d.rank))
    return diags
