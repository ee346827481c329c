"""Hop-DAG IR: one call's schedule as data.

Counterpart of accl_tpu/analysis/hopdag.py. A `HopDag` is a
rank-tagged, program-ordered list of nodes describing every cross-rank
move and every arithmetic fold of ONE call's schedule, plus the per-rank
output composition. The synthesized schedule library
(sequencer/synthesis.py) ships its entries in this form, the lowering
compiles them into schedule bodies, the semantic certifier
(semantics.py) interprets them, and `rank_programs` lowers their hops to
the Event programs protocol.simulate and the model checker explore.

Node kinds (each output is a flat run of `length` elements):

  arg      rank r's view of operand slot `arg` (the schedule input)
  send     rank r posts `value` on channel `hop` toward rank `peer`
  recv     rank r receives channel `hop` from rank `peer`; its content
           is the matching send's value (pairing is (hop, peer, rank))
  combine  elementwise reduction `func` of `value` with `value2`
  encode   blockwise quantization of `value`: the node has TWO outputs,
           `data` (int8 codes, `length` elements) and `scales`
           (`scales_len` fp32 per-block scales); pieces select a part
  decode   dequantize codes `value` against scales `value2`
  cast     dtype conversion of `value`; dtype == "" is an identity

Values are piece lists: each `Piece` is a contiguous slice of some
node's output (or a constant fill), so slicing, concatenation and
splicing stay exact.

The IR is executable: `execute` evaluates a DAG with numpy (encode and
decode through the port's blockwise int8 lanes on the CPU), the
reference the lowered program is held against. A node reading a node
that has not run yet (`validate_order` -> ACCL504) reads zeros.

The mutations (`mutate`, `MUTATIONS`) are the fault injector the
certifier is held against: each seeds one wrong-result class into a
DAG, drawing from the caller's `random.Random` exactly as the
reference does, so one seed gives the reference's mutant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np

from .diagnostics import Diagnostic, make

__all__ = [
    "CONST",
    "DATA",
    "SCALES",
    "Piece",
    "Value",
    "Node",
    "HopDag",
    "const_value",
    "value_length",
    "slice_value",
    "splice_value",
    "concat_values",
    "validate_order",
    "rank_programs",
    "execute",
    "to_json",
    "from_json",
    "mutate",
    "MUTATIONS",
]

DATA = "data"
SCALES = "scales"
CONST = -1  # Piece.node for constant fill (no producing node)


@dataclasses.dataclass(frozen=True)
class Piece:
    """A contiguous run of elements: a slice of node `node`'s output
    part (`offset` .. `offset+length`), or `length` elements of the
    constant `fill` when node == CONST."""

    length: int
    node: int = CONST
    offset: int = 0
    part: str = DATA
    fill: float = 0.0


Value = tuple[Piece, ...]


def const_value(length: int, fill: float = 0.0) -> Value:
    return (Piece(length, CONST, 0, DATA, fill),) if length else ()


def value_length(value: Value) -> int:
    return sum(p.length for p in value)


def slice_value(value: Value, start: int, length: int) -> Value:
    """The sub-value covering elements [start, start+length)."""
    if length == 0:
        return ()
    out: list[Piece] = []
    pos = 0
    end = start + length
    for p in value:
        lo = max(start, pos)
        hi = min(end, pos + p.length)
        if lo < hi:
            out.append(dataclasses.replace(
                p, length=hi - lo, offset=p.offset + (lo - pos)))
        pos += p.length
        if pos >= end:
            break
    got = sum(p.length for p in out)
    if got < length:  # slice past the end: stale/undefined tail
        out.append(Piece(length - got, CONST, 0, DATA, 0.0))
    return tuple(out)


def splice_value(base: Value, update: Value, start: int) -> Value:
    """`base` with `update` written at element offset `start`."""
    n = value_length(base)
    u = value_length(update)
    return (slice_value(base, 0, start) + update
            + slice_value(base, start + u, n - start - u))


def concat_values(*values: Value) -> Value:
    out: list[Piece] = []
    for v in values:
        out.extend(v)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR node; `id` is its position in HopDag.nodes (program
    order — the order the device would execute the hops in)."""

    id: int
    kind: str  # arg | send | recv | combine | encode | decode | cast
    rank: int
    length: int  # elements of the node's data output
    value: Value = ()  # primary input (send payload, combine lhs, ...)
    value2: Value = ()  # combine rhs / decode scales
    func: str = ""  # combine: "sum" | "max"
    hop: int = -1  # send/recv channel id
    peer: int = -1  # send: destination rank; recv: source rank
    arg: int = -1  # arg nodes: operand slot
    dtype: str = ""  # cast target / arg & encode element dtype
    scales_len: int = 0  # encode: number of per-block scales

    def refs(self) -> Iterator[Piece]:
        for p in self.value:
            if p.node != CONST:
                yield p
        for p in self.value2:
            if p.node != CONST:
                yield p


@dataclasses.dataclass
class HopDag:
    """One call's schedule as data: nodes in program order plus the
    per-rank output composition."""

    world: int
    n_in: int
    in_elems: int
    out_elems: int
    nodes: tuple[Node, ...]
    outputs: tuple[Value, ...]  # one Value per rank

    def sends_by_channel(self) -> dict[tuple[int, int], Node]:
        """(hop, dst_rank) -> send node. A rank receives at most one
        payload per channel (check_hops' ACCL204 guards the perm side)."""
        idx: dict[tuple[int, int], Node] = {}
        for n in self.nodes:
            if n.kind == "send":
                idx.setdefault((n.hop, n.peer), n)
        return idx


# ---------------------------------------------------------------------------
# Order validation (ACCL504)
# ---------------------------------------------------------------------------


def validate_order(dag: HopDag) -> list[Diagnostic]:
    """Prove every node's inputs are produced before the node runs: a
    send/combine reading a node with a LARGER program index forwards a
    region before its producer wrote it (the device would ship stale
    memory). This is the IR-level form of the stale-read class — the
    hazard pass's ACCL101 covers the BATCH level (a step reading past
    what an earlier step wrote); ACCL504 covers hop order within one
    schedule, which descriptors alone cannot express."""
    diags: list[Diagnostic] = []
    sends = {}
    for n in dag.nodes:
        if n.kind == "send":
            sends[(n.hop, n.peer)] = n
    for n in dag.nodes:
        for p in n.refs():
            if p.node >= n.id:
                src = dag.nodes[p.node]
                diags.append(make(
                    "ACCL504",
                    f"{n.kind} node {n.id} (rank {n.rank}"
                    + (f", hop {n.hop}" if n.hop >= 0 else "")
                    + f") reads {p.length} elements of {src.kind} node "
                    f"{src.id} before it is produced: the device would "
                    "forward stale memory", rank=n.rank))
        if n.kind == "recv":
            s = sends.get((n.hop, n.rank))
            if s is not None and s.id >= n.id:
                diags.append(make(
                    "ACCL504",
                    f"recv node {n.id} (rank {n.rank}, hop {n.hop}) "
                    f"consumes send node {s.id} posted later in program "
                    "order", rank=n.rank))
    return diags


# ---------------------------------------------------------------------------
# Protocol view: lower the hops to per-rank Event programs
# ---------------------------------------------------------------------------


def rank_programs(dag: HopDag) -> list[list[Any]]:
    """Per-rank blocking Event programs over the DAG's hops (tag = hop
    channel), the input `protocol.simulate` and the interleaving model
    checker consume."""
    from .protocol import recv as _recv
    from .protocol import send as _send

    programs: list[list[Any]] = [[] for _ in range(dag.world)]
    for n in dag.nodes:
        if n.kind == "send":
            programs[n.rank].append(_send(n.peer, tag=n.hop))
        elif n.kind == "recv":
            programs[n.rank].append(_recv(n.peer, tag=n.hop))
    return programs


# ---------------------------------------------------------------------------
# Numeric execution
# ---------------------------------------------------------------------------


def execute(dag: HopDag, operands: list[list[np.ndarray]]) -> list[np.ndarray]:
    """Evaluate the DAG numerically: `operands[rank][slot]` are the
    per-rank input buffers; returns one output array per rank.

    Combines are numpy adds and maxes; encode and decode run the port's
    blockwise int8 lanes on the CPU (their plain versions), unfused, as
    the reference evaluates them eagerly. A bfloat16 cast's output is
    carried as the float32 values it rounds to (`_cast`). Reads of not-yet-produced
    nodes (the ACCL504 class) evaluate as zeros — stale memory."""

    done: dict[tuple[int, str], np.ndarray] = {}
    sends = dag.sends_by_channel()

    def materialize(value: Value, dtype: Any = np.float32) -> np.ndarray:
        parts: list[np.ndarray] = []
        for p in value:
            if p.node == CONST:
                parts.append(np.full(p.length, p.fill, dtype=dtype))
                continue
            src = done.get((p.node, p.part))
            if src is None:  # stale read: producer hasn't run
                parts.append(np.zeros(p.length, dtype=dtype))
            else:
                parts.append(src[p.offset:p.offset + p.length])
        if not parts:
            return np.zeros(0, dtype=dtype)
        widest = max(parts, key=lambda a: a.dtype.itemsize)
        return np.concatenate([a.astype(widest.dtype) for a in parts])

    for n in dag.nodes:
        if n.kind == "arg":
            out = np.asarray(operands[n.rank][max(n.arg, 0)])[: n.length]
        elif n.kind == "send":
            out = materialize(n.value)
        elif n.kind == "recv":
            s = sends.get((n.hop, n.rank))
            if s is None or (s.id, DATA) not in done:
                out = np.zeros(n.length, dtype=np.float32)
            else:
                out = done[(s.id, DATA)][: n.length]
        elif n.kind == "combine":
            a = materialize(n.value)
            b = materialize(n.value2, dtype=a.dtype)
            out = np.maximum(a, b) if n.func == "max" else a + b
        elif n.kind == "encode":
            x = materialize(n.value)
            q, s = _quantize(np.asarray(x, np.float32))
            done[(n.id, SCALES)] = s
            out = q
        elif n.kind == "decode":
            q = materialize(n.value, dtype=np.int8)
            s = materialize(n.value2, dtype=np.float32)
            out = _dequantize(q, s, n.length)
        elif n.kind == "cast":
            x = materialize(n.value)
            out = _cast(x, n.dtype) if n.dtype else x
        else:  # pragma: no cover - guarded by from_json/lift
            raise ValueError(f"unknown node kind {n.kind!r}")
        done[(n.id, DATA)] = np.asarray(out)

    return [materialize(dag.outputs[r]) for r in range(dag.world)]


def _cast(x: np.ndarray, dtype: str) -> np.ndarray:
    """A cast node's output. numpy has no bfloat16: a bfloat16 value is
    carried as the float32 it rounds to (round to nearest even, through
    torch), which every later cast or fold reads exactly."""
    if dtype != "bfloat16":
        return x.astype(np.dtype(dtype))
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _quantize(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    import torch

    from ..ops.compression import quantize_blockwise

    q, s = quantize_blockwise(torch.from_numpy(x.copy()).reshape(1, -1))
    return q.reshape(-1).numpy(), s.reshape(-1).numpy()


def _dequantize(q: np.ndarray, s: np.ndarray, n: int) -> np.ndarray:
    import torch

    from ..ops.compression import dequantize_blockwise

    out = dequantize_blockwise(
        torch.from_numpy(np.asarray(q, np.int8).copy()).reshape(1, -1),
        torch.from_numpy(np.asarray(s, np.float32).copy()).reshape(1, -1),
        n)
    return out.reshape(-1).numpy()


# ---------------------------------------------------------------------------
# JSON (the library's form)
# ---------------------------------------------------------------------------


def _piece_json(p: Piece) -> list:
    out: list = [p.length, p.node, p.offset]
    if p.part != DATA or p.fill:
        out.append(p.part)
    if p.fill:
        out.append(p.fill)
    return out


def _piece_from(v: list) -> Piece:
    part = v[3] if len(v) > 3 else DATA
    fill = float(v[4]) if len(v) > 4 else 0.0
    return Piece(int(v[0]), int(v[1]), int(v[2]), part, fill)


def to_json(dag: HopDag) -> dict:
    nodes = []
    for n in dag.nodes:
        d: dict[str, Any] = {"kind": n.kind, "rank": n.rank,
                             "length": n.length}
        if n.value:
            d["value"] = [_piece_json(p) for p in n.value]
        if n.value2:
            d["value2"] = [_piece_json(p) for p in n.value2]
        for field in ("func", "dtype"):
            if getattr(n, field):
                d[field] = getattr(n, field)
        for field in ("hop", "peer", "arg"):
            if getattr(n, field) >= 0:
                d[field] = getattr(n, field)
        if n.scales_len:
            d["scales_len"] = n.scales_len
        nodes.append(d)
    return {
        "world": dag.world, "n_in": dag.n_in,
        "in_elems": dag.in_elems, "out_elems": dag.out_elems,
        "nodes": nodes,
        "outputs": [[_piece_json(p) for p in v] for v in dag.outputs],
    }


def from_json(d: dict) -> HopDag:
    nodes = []
    for i, nd in enumerate(d["nodes"]):
        nodes.append(Node(
            id=i, kind=nd["kind"], rank=int(nd["rank"]),
            length=int(nd["length"]),
            value=tuple(_piece_from(p) for p in nd.get("value", [])),
            value2=tuple(_piece_from(p) for p in nd.get("value2", [])),
            func=nd.get("func", ""), hop=int(nd.get("hop", -1)),
            peer=int(nd.get("peer", -1)), arg=int(nd.get("arg", -1)),
            dtype=nd.get("dtype", ""),
            scales_len=int(nd.get("scales_len", 0))))
    return HopDag(
        world=int(d["world"]), n_in=int(d.get("n_in", 1)),
        in_elems=int(d["in_elems"]), out_elems=int(d["out_elems"]),
        nodes=tuple(nodes),
        outputs=tuple(tuple(_piece_from(p) for p in v)
                      for v in d["outputs"]))


# ---------------------------------------------------------------------------
# Mutations (the fuzz harness's fault injector)
# ---------------------------------------------------------------------------


def _remap_value(value: Value, remap: dict[int, int]) -> Value:
    return tuple(p if p.node == CONST
                 else dataclasses.replace(p, node=remap[p.node])
                 for p in value)


def _rebuild(dag: HopDag, nodes: list[Node],
             remap: dict[int, int]) -> HopDag:
    """Renumber `nodes` (listed in their NEW program order, carrying
    their old ids) under old-id -> new-id `remap`. Under an identity
    remap a node already at its position is kept as it is."""
    identity = all(k == v for k, v in remap.items())
    new_nodes = tuple(
        n if identity and n.id == i else
        dataclasses.replace(n, id=i,
                            value=_remap_value(n.value, remap),
                            value2=_remap_value(n.value2, remap))
        for i, n in enumerate(nodes))
    outputs = (dag.outputs if identity else
               tuple(_remap_value(v, remap) for v in dag.outputs))
    return HopDag(dag.world, dag.n_in, dag.in_elems, dag.out_elems,
                  new_nodes, outputs)


def _combines(dag: HopDag, func: str | None = None) -> list[Node]:
    return [n for n in dag.nodes if n.kind == "combine"
            and (func is None or n.func == func)]


def mutate_drop_combine(dag: HopDag, rng: Any) -> HopDag | None:
    """Drop one reduction fold: the combine becomes an identity pass of
    its first operand, so the second operand's contribution never
    reaches the output (the ACCL502 class)."""
    cands = _combines(dag)
    if not cands:
        return None
    c = cands[rng.randrange(len(cands))]
    nodes = list(dag.nodes)
    nodes[c.id] = dataclasses.replace(c, kind="cast", value2=(), func="",
                                      dtype="")
    ident = {n.id: n.id for n in dag.nodes}
    return _rebuild(dag, nodes, ident)


def mutate_duplicate_combine(dag: HopDag, rng: Any) -> HopDag | None:
    """Fold one combine's second operand in twice (the ACCL503 class:
    a contribution double-counted into a non-idempotent reduction)."""
    cands = _combines(dag, "sum")
    if not cands:
        return None
    c = cands[rng.randrange(len(cands))]
    dup = Node(id=-1, kind="combine", rank=c.rank, length=c.length,
               value=(Piece(c.length, c.id),), value2=c.value2,
               func=c.func)
    order = list(dag.nodes[: c.id + 1]) + [dup] + list(dag.nodes[c.id + 1:])
    remap = {}
    for i, n in enumerate(order):
        if n.id >= 0:
            remap[n.id] = i
    # consumers of c now read the duplicated fold
    dup_new = remap[c.id] + 1

    def redirect(value: Value, skip_dup: bool = False) -> Value:
        return tuple(
            p if p.node == CONST else dataclasses.replace(
                p, node=(dup_new if p.node == c.id and not skip_dup
                         else remap[p.node]))
            for p in value)

    new_nodes = []
    for i, n in enumerate(order):
        if n is dup:
            new_nodes.append(dataclasses.replace(
                dup, id=i, value=(Piece(c.length, remap[c.id]),),
                value2=_remap_value(c.value2, remap)))
        else:
            skip = n.id <= c.id  # nodes at/before c keep their wiring
            new_nodes.append(dataclasses.replace(
                n, id=i, value=redirect(n.value, skip_dup=skip),
                value2=redirect(n.value2, skip_dup=skip)))
    outputs = tuple(redirect(v) for v in dag.outputs)
    return HopDag(dag.world, dag.n_in, dag.in_elems, dag.out_elems,
                  tuple(new_nodes), outputs)


def mutate_reorder_combine(dag: HopDag, rng: Any) -> HopDag | None:
    """Hoist a combine above the recv it folds: the fold now reads the
    arrival before the wire delivers it (the ACCL504 class)."""
    cands = [c for c in _combines(dag)
             if any(dag.nodes[p.node].kind == "recv" for p in c.refs())]
    if not cands:
        return None
    c = cands[rng.randrange(len(cands))]
    first_recv = min(p.node for p in c.refs()
                     if dag.nodes[p.node].kind == "recv")
    order = list(dag.nodes)
    order.remove(c)
    order.insert(first_recv, c)
    remap = {n.id: i for i, n in enumerate(order)}
    return _rebuild(dag, order, remap)


def mutate_swap_send_values(dag: HopDag, rng: Any) -> HopDag | None:
    """Swap the payloads of two sends in one hop: every endpoint still
    matches (the protocol passes stay clean) but two destinations get
    each other's region (the ACCL501 class)."""
    by_hop: dict[int, list[Node]] = {}
    for n in dag.nodes:
        if n.kind == "send":
            by_hop.setdefault(n.hop, []).append(n)
    hops = [ns for ns in by_hop.values()
            if len(ns) >= 2 and ns[0].length == ns[1].length
            and ns[0].value != ns[1].value]
    if not hops:
        return None
    ns = hops[rng.randrange(len(hops))]
    a, b = ns[0], ns[1]
    nodes = list(dag.nodes)
    nodes[a.id] = dataclasses.replace(a, value=b.value)
    nodes[b.id] = dataclasses.replace(b, value=a.value)
    ident = {n.id: n.id for n in dag.nodes}
    return _rebuild(dag, nodes, ident)


MUTATIONS: dict[str, Callable[[HopDag, Any], HopDag | None]] = {
    "drop_combine": mutate_drop_combine,  # expect ACCL502
    "duplicate_combine": mutate_duplicate_combine,  # expect ACCL503
    "reorder_combine": mutate_reorder_combine,  # expect ACCL504
    "swap_send_values": mutate_swap_send_values,  # expect ACCL501
}


def mutate(dag: HopDag, kind: str, rng: Any) -> HopDag | None:
    return MUTATIONS[kind](dag, rng)
