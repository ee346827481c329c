"""Schedule synthesis: the committed library of search-produced
schedules, their cost model, and their lowering.

Counterpart of accl_tpu/sequencer/synthesis.py. The reference searches
the hop-DAG space (rotationally symmetric k-step schedules: the
`exchange`, `doubling`, `halving` and `rs_ag` families on one ring, and
the tiered `t_<inner>_<outer>` families on a factored inner x outer
world), certifies every winner and ships it as a JSON hop-DAG under
`synthesized/`. The port carries that library's metadata
(accl_tpu_torch/sequencer/synthesized/: each entry's spec, window and
canonical count, and the digest of the DAG body in its place, which
`instantiate` regenerates at the call's count) and everything the call path needs from it:

  - the generators behind `instantiate`, which regenerate an entry's
    DAG at any count (the lowering's source; `canonical_count`,
    `hop_layout` for the tiered entries);
  - the scoring: `cost_shape`, `predict_spec(_tiered)`,
    `tiered_phase_costs`, `hand_written_best(_tiered)`, which
    timing.tuning_crossovers and the hierarchical arbitration use;
  - the library: `library`, `select_entry`, `entry_for_key`;
  - the lowering: `lower_plan` / `lower_dag` (`round_launches` reads
    the kernel launches of one lowered run off its round plan).

It also searches and certifies as the reference does:
`enumerate_candidates`, `enumerate_tiered_candidates`,
`score_window(_tiered)`,
`search` (score, beam-prune, then certify every survivor),
`certify_dag` / `certify_spec` (semantics.certify against
collective_spec, the canonical protocol simulation and the interleaving
model checker), `export_entry`, and `verify_library`, the gate that
keeps a stale or uncertified entry from shipping.

Drift check. The reference's library entries commit the canonical DAG
and `verify_library` compares the regenerated DAG with it byte for
byte. The port's copies carry `dag_sha256` in its place: the SHA-256 of
`json.dumps(to_json(dag), sort_keys=True)` of that committed DAG
(`dag_digest`), which `verify_library` compares with the regenerated
DAG's digest.

Lowering. The reference compiles a DAG into one per-rank chain under
shard_map: a rank-symmetric DAG as one rank-relative chain, any other
one as every rank's chain evaluated on every rank and selected by
axis_index. Over the port's stacked (world, n) rows neither is needed:
every generator emits rank-major rounds (one node per rank of one kind,
`_Builder.emit_round`), so the port runs each round as one operation
over all rows: a fold round is one launch of the lane kernel, an encode
round one of the quantize kernel, a hop one permutation of the rank axis
(a roll for a rotation, a gather for a tier ring). A value whose pieces
sit at the same offset on every rank is a view; where the offset
depends on the rank (the chunked families) it is one gather of each
row's block. A decode round feeding a fold directly runs as the fused
dequantize-combine kernel: the jitted reference contracts q*s + local
into one fused multiply-add.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import pathlib
from typing import Any, Callable, Iterator, Sequence

from ..constants import (
    QUANT_BLOCK_ELEMS,
    QUANT_SCALE_BYTES,
    STREAM_SEG_BYTES,
    Operation,
    ReduceFunction,
)
from ..analysis.diagnostics import Diagnostic
from ..analysis.hopdag import (
    CONST,
    DATA,
    SCALES,
    HopDag,
    Node,
    Piece,
    Value,
    concat_values,
    slice_value,
    to_json,
)

# the ops a synthesized schedule can implement today
SYNTH_OPS = (Operation.allreduce, Operation.allgather,
             Operation.reduce_scatter)

# predicted-score grid: payload bytes per (world, size) cell
SIZE_GRID = tuple(1 << k for k in range(10, 25, 2))  # 1 KB .. 16 MB

# the latency grid: every power of two across the 1-64 KiB decode
# regime, where the alpha term — not bytes — is the product. Entries
# searched on this grid carry grid="lat" and a "_lat" key suffix; they
# live behind SYNTH_LATENCY_MAX_COUNT, never the std synth registers,
# so a minimum-step schedule that only wins the small-payload floor
# cannot widen the bandwidth-calibrated windows.
SIZE_GRID_LAT = tuple(1 << k for k in range(10, 17))  # 1 KB .. 64 KB


def grid_for(spec: "SynthSpec") -> tuple[int, ...]:
    """The scoring grid a spec's window is defined over — the ONE
    resolution rule shared by search/--export, verify_library, and
    timing.tuning_crossovers."""
    return SIZE_GRID_LAT if spec.grid == "lat" else SIZE_GRID


class SynthesisError(Exception):
    """A candidate the generator/lowering cannot handle (never converted
    into a silent pass: callers fail loudly or discard the candidate)."""


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """One synthesized schedule family member: enough to regenerate its
    hop-DAG deterministically at any payload size. `key` names the
    library entry (and rides Plan.synth_key into the compiler's cache key).

    `tiers=(inner_world, outer_world)` marks a FACTORED-topology member
    (family `t_<inner>_<outer>`): `distances` are then the inner-axis
    tuple and `outer_distances` the outer-axis one, and every hop is
    tier-annotated (`hop_layout`) — charged to its `TierLinks` entry
    and compiled to its RankMap ring permutation. `tiers=()` is the
    flat single-ring space."""

    key: str
    op: str  # "allreduce" | "allgather" | "reduce_scatter"
    world: int
    family: str  # exchange | doubling | halving | rs_ag | t_<ik>_<ok>
    distances: tuple[int, ...]
    wire: str = ""  # "" = payload dtype on the wire, "int8" = quantized
    tiers: tuple[int, ...] = ()  # (inner_world, outer_world) | () flat
    outer_distances: tuple[int, ...] = ()
    grid: str = "std"  # "std" = SIZE_GRID window, "lat" = SIZE_GRID_LAT

    @property
    def scenario(self) -> Operation:
        return Operation[self.op]

    def to_json(self) -> dict:
        d: dict[str, Any] = {
            "key": self.key, "op": self.op, "world": self.world,
            "family": self.family, "distances": list(self.distances),
        }
        if self.wire:
            d["wire"] = self.wire
        if self.tiers:
            d["tiers"] = list(self.tiers)
            d["outer_distances"] = list(self.outer_distances)
        if self.grid != "std":
            d["grid"] = self.grid
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SynthSpec":
        return cls(key=str(d["key"]), op=str(d["op"]),
                   world=int(d["world"]), family=str(d["family"]),
                   distances=tuple(int(x) for x in d["distances"]),
                   wire=str(d.get("wire", "")),
                   tiers=tuple(int(x) for x in d.get("tiers", ())),
                   outer_distances=tuple(
                       int(x) for x in d.get("outer_distances", ())),
                   grid=str(d.get("grid", "std")))


def _spec_key(op: str, world: int, family: str,
              distances: tuple[int, ...], wire: str) -> str:
    d = "_".join(str(x) for x in distances)
    w = f"_{wire}" if wire else ""
    return f"{op}_w{world}_{family}_d{d}{w}"


def _tiered_key(world: int, tiers: tuple[int, int], family: str,
                di: tuple[int, ...], do: tuple[int, ...]) -> str:
    L, P = tiers
    return (f"allreduce_w{world}_t{L}x{P}_{family[2:]}"
            f"_d{'_'.join(map(str, di))}_o{'_'.join(map(str, do))}")


def _tier_kinds(family: str) -> tuple[str, str]:
    """('lg'|'ring', 'exchange'|'rs_ag'|'ring') of a tiered family."""
    if not family.startswith("t_"):
        raise SynthesisError(f"not a tiered family: {family!r}")
    ik, ok = family[2:].split("_", 1)
    if ik not in ("lg", "ring") or ok not in ("exchange", "rs_ag",
                                              "ring"):
        raise SynthesisError(f"unknown tiered family {family!r}")
    return ik, ok


# ---------------------------------------------------------------------------
# Validity: the exact-cover condition shared by every family
# ---------------------------------------------------------------------------


def _subset_sums_distinct(world: int, distances: tuple[int, ...]) -> bool:
    """True iff the 2^k subset sums of `distances` are pairwise distinct
    mod `world` (and therefore, with 2^k == world, cover Z_world exactly
    once). This is the generator-side pruning of the wrong-result
    classes: a collision is a double-count (ACCL503) and a shortfall a
    missing contribution (ACCL502) — the certifier re-proves the same
    property on the emitted DAG, so the pruning can never silently
    diverge from the proof."""
    sums = {0}
    for d in distances:
        shifted = {(s + d) % world for s in sums}
        if sums & shifted:
            return False
        sums |= shifted
    return len(sums) == world


def coverage_sets(world: int,
                  distances: tuple[int, ...]) -> list[set[int]]:
    """S_0 .. S_k with S_i the relative offsets reachable after step i
    (S_0 = {0}, S_i = S_{i-1} u (S_{i-1} + d_i))."""
    sets = [{0}]
    for d in distances:
        cur = sets[-1]
        sets.append(cur | {(s + d) % world for s in cur})
    return sets


def _valid_distance_tuples(world: int, k: int) -> Iterator[tuple[int, ...]]:
    """Strictly-increasing k-tuples whose 2^k subset sums are pairwise
    distinct mod `world`, in lexicographic order — enumerated by
    branch-and-bound DFS: a prefix dies the moment its sums collide, so
    the first valid tuple at w256 costs ~k*world set extensions instead
    of the millions of complete tuples a combinations scan would build
    and re-check (the scaling lever for w16-w256 enumeration)."""

    def rec(start: int, sums: frozenset, prefix: tuple[int, ...],
            ) -> Iterator[tuple[int, ...]]:
        if len(prefix) == k:
            yield prefix
            return
        for d in range(start, world):
            shifted = {(s + d) % world for s in sums}
            if sums & shifted:
                continue  # collision: every extension collides too
            yield from rec(d + 1, frozenset(sums | shifted),
                           prefix + (d,))

    yield from rec(1, frozenset({0}), ())


def _first_valid_tuple(world: int) -> tuple[int, ...] | None:
    """The lexicographically first valid k=log2(world) tuple (the
    dominance representative: valid tuples within a family share the
    per-step byte profile, so they are cost-identical)."""
    if world < 2 or world & (world - 1):
        return None
    k = world.bit_length() - 1
    return next(_valid_distance_tuples(world, k), None)


# ---------------------------------------------------------------------------
# DAG generation (rank-symmetric by construction)
# ---------------------------------------------------------------------------


class _Builder:
    """Emit nodes in a strict per-step, rank-major order so position
    p*world + r is rank r's p-th node — the layout `lower_dag`'s
    rotational-symmetry extraction relies on."""

    def __init__(self, world: int):
        self.world = world
        self.nodes: list[Node] = []

    def emit_round(self, make: Callable[[int, int], Node]) -> list[int]:
        """One rank-major round: `make(rank, id)` for every rank;
        returns the new node ids (index by rank)."""
        ids = []
        for r in range(self.world):
            nid = len(self.nodes)
            self.nodes.append(make(r, nid))
            ids.append(nid)
        return ids


class _FlatAxis:
    """The single-ring geometry: positions ARE global ranks, a hop at
    distance d is the full-ring rotation g -> g + d."""

    tier = ""

    def __init__(self, world: int):
        self.world = world
        self.nranks = world

    def pos(self, g: int) -> int:
        return g

    def peer(self, g: int, d: int) -> int:
        return (g + d) % self.world


class _InnerAxis:
    """The fast tier of an outer-major (g = outer*L + inner) factored
    world: a hop rotates every slice's inner ring in lockstep — the
    global pairs are exactly `hierarchical.RankMap.inner_perm(d)`."""

    tier = "inner"

    def __init__(self, L: int, P: int):
        self.world = L
        self.nranks = L * P
        self._L = L

    def pos(self, g: int) -> int:
        return g % self._L

    def peer(self, g: int, d: int) -> int:
        return g - g % self._L + (g % self._L + d) % self._L


class _OuterAxis:
    """The slow tier: a hop rotates every inner row's outer ring in
    lockstep — the global pairs of `RankMap.outer_perm(d)`."""

    tier = "outer"

    def __init__(self, L: int, P: int):
        self.world = P
        self.nranks = L * P
        self._L = L

    def pos(self, g: int) -> int:
        return g // self._L

    def peer(self, g: int, d: int) -> int:
        return ((g // self._L + d) % self.world) * self._L + g % self._L


def _scales_len(n: int) -> int:
    return max(1, math.ceil(n / QUANT_BLOCK_ELEMS))


def _exchange_core(b: _Builder, axis, distances: tuple[int, ...],
                   count: int, func: str, acc: list[Value],
                   hop_base: int, wire: str) -> tuple[list[Value], int]:
    """allreduce exchange along one axis: every rank sends its running
    partial `acc[g]` distance d down the axis and folds the arrival
    from distance -d. Returns (final partials, next free hop). The flat
    family and the tiered outer-`exchange` phase share this emitter —
    only the axis geometry differs."""
    w = axis.world
    hop = hop_base
    for d in distances:
        if wire == "int8":
            enc = b.emit_round(lambda g, i: Node(
                id=i, kind="encode", rank=g, length=count,
                value=acc[g],
                scales_len=_scales_len(count), dtype="int8"))
            b.emit_round(lambda g, i: Node(
                id=i, kind="send", rank=g, length=count,
                value=(Piece(count, enc[g]),), hop=hop,
                peer=axis.peer(g, d)))
            b.emit_round(lambda g, i: Node(
                id=i, kind="send", rank=g, length=_scales_len(count),
                value=(Piece(_scales_len(count), enc[g], 0, SCALES),),
                hop=hop + 1, peer=axis.peer(g, d)))
            rq = b.emit_round(lambda g, i: Node(
                id=i, kind="recv", rank=g, length=count, hop=hop,
                peer=axis.peer(g, -d)))
            rs = b.emit_round(lambda g, i: Node(
                id=i, kind="recv", rank=g, length=_scales_len(count),
                hop=hop + 1, peer=axis.peer(g, -d)))
            dec = b.emit_round(lambda g, i: Node(
                id=i, kind="decode", rank=g, length=count,
                value=(Piece(count, rq[g]),),
                value2=(Piece(_scales_len(count), rs[g]),)))
            ids = b.emit_round(lambda g, i: Node(
                id=i, kind="combine", rank=g, length=count,
                value=acc[g],
                value2=(Piece(count, dec[g]),), func=func))
            acc = [(Piece(count, ids[g]),) for g in range(axis.nranks)]
            hop += 2
        else:
            b.emit_round(lambda g, i: Node(
                id=i, kind="send", rank=g, length=count,
                value=acc[g], hop=hop, peer=axis.peer(g, d)))
            rv = b.emit_round(lambda g, i: Node(
                id=i, kind="recv", rank=g, length=count, hop=hop,
                peer=axis.peer(g, -d)))
            ids = b.emit_round(lambda g, i: Node(
                id=i, kind="combine", rank=g, length=count,
                value=acc[g],
                value2=(Piece(count, rv[g]),), func=func))
            acc = [(Piece(count, ids[g]),) for g in range(axis.nranks)]
            hop += 1
    return acc, hop


def _exchange_dag(spec: SynthSpec, count: int, func: str) -> HopDag:
    """allreduce: acc[r] folds the arrival from r - d_i each step."""
    w = spec.world
    b = _Builder(w)
    args = b.emit_round(lambda r, i: Node(
        id=i, kind="arg", rank=r, length=count, arg=0, dtype="float32"))
    acc: list[Value] = [(Piece(count, args[r]),) for r in range(w)]
    acc, _hop = _exchange_core(b, _FlatAxis(w), spec.distances, count,
                               func, acc, 0, spec.wire)
    outputs: tuple[Value, ...] = tuple(acc[r] for r in range(w))
    return HopDag(world=w, n_in=1, in_elems=count, out_elems=count,
                  nodes=tuple(b.nodes), outputs=outputs)


def _doubling_core(b: _Builder, axis, distances: tuple[int, ...],
                   count: int, held: list[dict[int, Value]],
                   hop_base: int) -> tuple[list[dict[int, Value]], int]:
    """allgather doubling along one axis: each rank relays EVERY chunk
    held so far; `held[g]` maps origin axis POSITION -> that origin's
    chunk Value on rank g. Returns (full held maps, next free hop)."""
    w = axis.world
    sets = coverage_sets(w, distances)
    for step, d in enumerate(distances):
        rel = sorted(sets[step])  # canonical message layout
        msg_len = len(rel) * count

        def payload(g: int) -> Value:
            out: tuple[Piece, ...] = ()
            for s in rel:
                out = out + held[g][(axis.pos(g) - s) % w]
            return out

        b.emit_round(lambda g, i: Node(
            id=i, kind="send", rank=g, length=msg_len,
            value=payload(g), hop=hop_base + step, peer=axis.peer(g, d)))
        rv = b.emit_round(lambda g, i: Node(
            id=i, kind="recv", rank=g, length=msg_len,
            hop=hop_base + step, peer=axis.peer(g, -d)))
        for g in range(axis.nranks):
            for j, s in enumerate(rel):
                origin = (axis.pos(g) - d - s) % w
                held[g][origin] = (
                    Piece(count, rv[g], j * count),)
    return held, hop_base + len(distances)


def _doubling_dag(spec: SynthSpec, count: int) -> HopDag:
    """allgather: each rank relays every chunk held so far; held sets
    are `coverage_sets` in relative offsets (held chunk = rank - s)."""
    w = spec.world
    b = _Builder(w)
    args = b.emit_round(lambda r, i: Node(
        id=i, kind="arg", rank=r, length=count, arg=0, dtype="float32"))
    # held[r][origin] = Value holding origin's chunk on rank r
    held: list[dict[int, Value]] = [
        {r: (Piece(count, args[r]),)} for r in range(w)]
    held, _hop = _doubling_core(b, _FlatAxis(w), spec.distances, count,
                                held, 0)
    outputs = []
    for r in range(w):
        v: tuple[Piece, ...] = ()
        for origin in range(w):
            v = v + held[r][origin]
        outputs.append(v)
    return HopDag(world=w, n_in=1, in_elems=count,
                  out_elems=w * count, nodes=tuple(b.nodes),
                  outputs=tuple(outputs))


def _halving_core(b: _Builder, axis, distances: tuple[int, ...],
                  count: int, func: str,
                  part: list[dict[int, Value]],
                  hop_base: int) -> tuple[list[dict[int, Value]], int]:
    """reduce_scatter halving along one axis: position p hands off
    partials for chunks p + d + A_i to position p + d each step;
    responsibility sets A_i halve (A_i = S_{k-i} of the reversed
    distance sequence). `part[g]` maps ABSOLUTE axis chunk -> partial
    Value; on return only position g's kept chunks remain. Returns
    (part, next free hop)."""
    w = axis.world
    k = len(distances)
    # A_i chain: A_k = {0}; A_{i-1} = A_i u (A_i + d_i)
    A: list[set[int]] = [set() for _ in range(k + 1)]
    A[k] = {0}
    for i in range(k, 0, -1):
        d = distances[i - 1]
        A[i - 1] = A[i] | {(a + d) % w for a in A[i]}
    for i in range(1, k + 1):
        d = distances[i - 1]
        send_rel = sorted((a + d) % w for a in A[i])
        msg_len = len(send_rel) * count

        def payload(g: int) -> Value:
            out: tuple[Piece, ...] = ()
            for a in send_rel:
                out = out + part[g][(axis.pos(g) + a) % w]
            return out

        b.emit_round(lambda g, i_: Node(
            id=i_, kind="send", rank=g, length=msg_len,
            value=payload(g), hop=hop_base + i - 1,
            peer=axis.peer(g, d)))
        rv = b.emit_round(lambda g, i_: Node(
            id=i_, kind="recv", rank=g, length=msg_len,
            hop=hop_base + i - 1, peer=axis.peer(g, -d)))
        # arrival from pos-d carries chunks (pos-d) + send_rel, i.e.
        # pos + a for a = send_rel - d (mod w) — all kept chunks; fold
        # each slice into the kept partial, rank-major per arrival slot
        # so symmetry holds
        arr_rel = [(a - d) % w for a in send_rel]
        for j, a in enumerate(arr_rel):
            ids = b.emit_round(lambda g, i_: Node(
                id=i_, kind="combine", rank=g, length=count,
                value=part[g][(axis.pos(g) + a) % w],
                value2=(Piece(count, rv[g], j * count),), func=func))
            for g in range(axis.nranks):
                part[g][(axis.pos(g) + a) % w] = (Piece(count, ids[g]),)
        # drop handed-off chunks (no longer this position's duty)
        for g in range(axis.nranks):
            part[g] = {c: v for c, v in part[g].items()
                       if (c - axis.pos(g)) % w in A[i]}
    return part, hop_base + k


def _ring_rs_core(b: _Builder, axis, d: int, count: int, func: str,
                  part: list[dict[int, Value]],
                  hop_base: int) -> tuple[list[dict[int, Value]], int]:
    """Bandwidth-optimal ring reduce-scatter along one axis — the
    hand-written ring's structure as a searchable point: w-1 steps each
    moving exactly ONE chunk partial distance d down the axis. At step
    s position p sends its partial of chunk p - s*d and folds the
    arrival into chunk p - (s+1)*d; after w-1 steps position p owns
    chunk p fully reduced (gcd(d, w) = 1 walks the whole ring)."""
    w = axis.world
    hop = hop_base
    for s in range(1, w):
        b.emit_round(lambda g, i: Node(
            id=i, kind="send", rank=g, length=count,
            value=part[g][(axis.pos(g) - s * d) % w], hop=hop,
            peer=axis.peer(g, d)))
        rv = b.emit_round(lambda g, i: Node(
            id=i, kind="recv", rank=g, length=count, hop=hop,
            peer=axis.peer(g, -d)))
        ids = b.emit_round(lambda g, i: Node(
            id=i, kind="combine", rank=g, length=count,
            value=part[g][(axis.pos(g) - (s + 1) * d) % w],
            value2=(Piece(count, rv[g]),), func=func))
        for g in range(axis.nranks):
            part[g][(axis.pos(g) - (s + 1) * d) % w] = (
                Piece(count, ids[g]),)
        hop += 1
    return part, hop


def _ring_ag_core(b: _Builder, axis, d: int, count: int,
                  held: list[dict[int, Value]],
                  hop_base: int) -> tuple[list[dict[int, Value]], int]:
    """Ring allgather along one axis: w-1 steps each relaying the chunk
    received the previous step (at step 1 the own chunk), so every
    position holds every origin after the walk."""
    w = axis.world
    hop = hop_base
    for s in range(1, w):
        b.emit_round(lambda g, i: Node(
            id=i, kind="send", rank=g, length=count,
            value=held[g][(axis.pos(g) - (s - 1) * d) % w], hop=hop,
            peer=axis.peer(g, d)))
        rv = b.emit_round(lambda g, i: Node(
            id=i, kind="recv", rank=g, length=count, hop=hop,
            peer=axis.peer(g, -d)))
        for g in range(axis.nranks):
            held[g][(axis.pos(g) - s * d) % w] = (Piece(count, rv[g]),)
        hop += 1
    return held, hop


def _halving_dag(spec: SynthSpec, count: int, func: str,
                 b: _Builder | None = None,
                 part_in: list[dict[int, Value]] | None = None,
                 hop_base: int = 0) -> tuple[
                     "_Builder", list[dict[int, Value]]]:
    """reduce_scatter wrapper over `_halving_core` on the flat axis;
    returns the builder and per-rank {abs_chunk: partial Value} so
    `rs_ag` can continue the same DAG."""
    w = spec.world
    if b is None:
        b = _Builder(w)
        args = b.emit_round(lambda r, i: Node(
            id=i, kind="arg", rank=r, length=w * count, arg=0,
            dtype="float32"))
        part_in = [
            {c: (Piece(count, args[r], c * count),) for c in range(w)}
            for r in range(w)]
    assert b is not None and part_in is not None
    part, _hop = _halving_core(b, _FlatAxis(w), spec.distances, count,
                               func, part_in, hop_base)
    return b, part


def _reduce_scatter_dag(spec: SynthSpec, count: int, func: str) -> HopDag:
    b, part = _halving_dag(spec, count, func)
    w = spec.world
    outputs = tuple(part[r][r] for r in range(w))
    return HopDag(world=w, n_in=1, in_elems=w * count, out_elems=count,
                  nodes=tuple(b.nodes), outputs=outputs)


def _rs_ag_dag(spec: SynthSpec, count: int, func: str) -> HopDag:
    """allreduce = halving reduce_scatter + doubling allgather over the
    same distance set (payload padded to a world multiple upstream by
    the chunking rule in `instantiate`)."""
    w = spec.world
    if count % w:
        raise SynthesisError(
            f"rs_ag payload must chunk by world ({count} % {w})")
    chunk = count // w
    k = len(spec.distances)
    b, part = _halving_dag(spec, chunk, func, hop_base=0)
    # allgather phase: start from the reduced chunk, doubling relays
    held: list[dict[int, Value]] = [
        {r: part[r][r]} for r in range(w)]
    held, _hop = _doubling_core(b, _FlatAxis(w), spec.distances, chunk,
                                held, k)
    outputs = []
    for r in range(w):
        v: tuple[Piece, ...] = ()
        for origin in range(w):
            v = v + held[r][origin]
        outputs.append(v)
    return HopDag(world=w, n_in=1, in_elems=count, out_elems=count,
                  nodes=tuple(b.nodes), outputs=tuple(outputs))


def _tiered_dag(spec: SynthSpec, count: int, func: str) -> HopDag:
    """Factored-topology allreduce over outer-major global ranks
    (g = outer*L + inner): inner reduce-scatter -> outer allreduce of
    the 1/L shard (the ONLY bytes that ever cross the slow tier) ->
    inner allgather, each phase built from the per-tier family the spec
    names. Every hop moves along exactly one axis of the (L, P) torus —
    the tier annotation `hop_layout` records and the per-tier cost
    accounting charges."""
    L, P = spec.tiers
    w = L * P
    if count % (L * P):
        raise SynthesisError(
            f"{spec.key}: tiered payload must chunk by inner*outer "
            f"({count} % {L * P})")
    cpk = count // L  # one inner chunk == the outer shard
    ik, ok = _tier_kinds(spec.family)
    inner = _InnerAxis(L, P)
    outer = _OuterAxis(L, P)
    b = _Builder(w)
    args = b.emit_round(lambda g, i: Node(
        id=i, kind="arg", rank=g, length=count, arg=0, dtype="float32"))
    part: list[dict[int, Value]] = [
        {c: (Piece(cpk, args[g], c * cpk),) for c in range(L)}
        for g in range(w)]
    hop = 0
    if ik == "ring":
        part, hop = _ring_rs_core(b, inner, spec.distances[0], cpk,
                                  func, part, hop)
    else:
        part, hop = _halving_core(b, inner, spec.distances, cpk, func,
                                  part, hop)
    shard: list[Value] = [part[g][inner.pos(g)] for g in range(w)]
    if ok == "exchange":
        shard, hop = _exchange_core(b, outer, spec.outer_distances,
                                    cpk, func, shard, hop, "")
    else:
        ocpk = cpk // P
        opart: list[dict[int, Value]] = [
            {c: slice_value(shard[g], c * ocpk, ocpk) for c in range(P)}
            for g in range(w)]
        if ok == "ring":
            od = spec.outer_distances[0]
            opart, hop = _ring_rs_core(b, outer, od, ocpk, func,
                                       opart, hop)
            held_o: list[dict[int, Value]] = [
                {outer.pos(g): opart[g][outer.pos(g)]} for g in range(w)]
            held_o, hop = _ring_ag_core(b, outer, od, ocpk, held_o, hop)
        else:  # rs_ag
            opart, hop = _halving_core(b, outer, spec.outer_distances,
                                       ocpk, func, opart, hop)
            held_o = [
                {outer.pos(g): opart[g][outer.pos(g)]} for g in range(w)]
            held_o, hop = _doubling_core(b, outer, spec.outer_distances,
                                         ocpk, held_o, hop)
        shard = [concat_values(*(held_o[g][c] for c in range(P)))
                 for g in range(w)]
    held: list[dict[int, Value]] = [
        {inner.pos(g): shard[g]} for g in range(w)]
    if ik == "ring":
        held, hop = _ring_ag_core(b, inner, spec.distances[0], cpk,
                                  held, hop)
    else:
        held, hop = _doubling_core(b, inner, spec.distances, cpk,
                                   held, hop)
    outputs = tuple(concat_values(*(held[g][c] for c in range(L)))
                    for g in range(w))
    return HopDag(world=w, n_in=1, in_elems=count, out_elems=count,
                  nodes=tuple(b.nodes), outputs=outputs)


def _check_axis_family(spec: SynthSpec, kind: str, axis_world: int,
                       distances: tuple[int, ...], what: str) -> None:
    """Per-tier validity: the log-step families need the exact-cover
    subset-sum condition over THEIR axis; a ring needs one distance
    coprime to the axis extent (the walk must visit every position)."""
    if kind in ("lg", "exchange", "rs_ag"):
        if not _subset_sums_distinct(axis_world, distances):
            raise SynthesisError(
                f"{spec.key}: {what} distances {distances} do not "
                f"cover Z_{axis_world} exactly once — not a valid "
                "schedule")
    else:  # ring
        if len(distances) != 1 or math.gcd(distances[0],
                                           axis_world) != 1:
            raise SynthesisError(
                f"{spec.key}: {what} ring distance {distances} must be "
                f"a single generator of Z_{axis_world}")


def instantiate(spec: SynthSpec, count: int,
                func: str = "sum") -> HopDag:
    """Deterministically regenerate `spec`'s hop-DAG for a concrete
    per-rank element count. The same generator builds the committed
    canonical instance, the fuzz instances and the lowered program's
    source DAG — there is exactly one structure to certify."""
    if count <= 0:
        raise SynthesisError(f"count must be positive, got {count}")
    if spec.tiers:
        L, P = spec.tiers
        if L * P != spec.world or L < 2 or P < 2:
            raise SynthesisError(
                f"{spec.key}: tiers {spec.tiers} do not factor world "
                f"{spec.world}")
        ik, ok = _tier_kinds(spec.family)
        _check_axis_family(spec, ik, L, spec.distances, "inner")
        _check_axis_family(spec, ok, P, spec.outer_distances, "outer")
        return _tiered_dag(spec, count, func)
    if not _subset_sums_distinct(spec.world, spec.distances):
        raise SynthesisError(
            f"{spec.key}: distances {spec.distances} do not cover "
            f"Z_{spec.world} exactly once — not a valid schedule")
    if spec.family == "exchange":
        return _exchange_dag(spec, count, func)
    if spec.family == "doubling":
        return _doubling_dag(spec, count)
    if spec.family == "halving":
        return _reduce_scatter_dag(spec, count, func)
    if spec.family == "rs_ag":
        return _rs_ag_dag(spec, count, func)
    raise SynthesisError(f"unknown family {spec.family!r}")


# canonical counts for the committed/certified instances: big enough to
# exercise multi-chunk layouts, small enough to keep fixtures readable
CANONICAL_COUNT = {"exchange": 64, "doubling": 16, "halving": 16,
                   "rs_ag": 64}


def canonical_count(spec: SynthSpec) -> int:
    if spec.tiers:
        # must chunk by inner*outer (the 2-D torus chunking rule)
        L, P = spec.tiers
        return 8 * L * P
    base = CANONICAL_COUNT[spec.family]
    if spec.family == "rs_ag":
        return max(base, spec.world)  # must chunk by world
    return base


# ---------------------------------------------------------------------------
# Certification: the existing prove stack, candidate by candidate
# ---------------------------------------------------------------------------


def _call_options(spec: SynthSpec, count: int,
                  func: ReduceFunction = ReduceFunction.SUM) -> Any:
    from ..constants import DataType
    from ..descriptor import CallOptions

    return CallOptions(scenario=spec.scenario, count=count,
                       function=int(func), data_type=DataType.float32)


def certify_dag(dag: HopDag, spec: SynthSpec, count: int,
                func: ReduceFunction = ReduceFunction.SUM,
                ) -> list[Diagnostic]:
    """Run one candidate instance through the full prove stack:
    semantic certification (ACCL501-504) against the declared
    collective, the canonical protocol simulation, and the exhaustive-
    interleaving model checker (ACCL205-207). Returns every diagnostic;
    an empty list is the only shippable verdict."""
    from ..analysis import semantics
    from ..analysis.hopdag import rank_programs, validate_order
    from ..analysis.linter import SequenceLinter
    from ..analysis.protocol import simulate

    opts = _call_options(spec, count, func)
    spec_map = semantics.collective_spec(opts, dag.world)
    diags = list(validate_order(dag))
    diags += semantics.certify(dag, spec_map, spec.op)
    programs = rank_programs(dag)
    diags += simulate(programs, blocking_sends=False)
    if not diags:
        diags += SequenceLinter(dag.world).check_interleavings(programs)
    return diags


def certify_spec(spec: SynthSpec,
                 counts: tuple[int, ...] = (),
                 ) -> tuple[bool, list[Diagnostic]]:
    """Certify a spec at its canonical count (and any extra counts).
    False means DISCARD: the caller must not ship the candidate."""
    all_diags: list[Diagnostic] = []
    for count in (canonical_count(spec),) + tuple(counts):
        try:
            dag = instantiate(spec, count)
        except SynthesisError:
            return False, all_diags
        all_diags += certify_dag(dag, spec, count)
        if spec.op == "allreduce" and spec.wire != "int8":
            # MAX folds certify too (idempotent reduction class)
            dag_max = instantiate(spec, count, func="max")
            all_diags += certify_dag(dag_max, spec, count,
                                     ReduceFunction.MAX)
    return not all_diags, all_diags


# ---------------------------------------------------------------------------
# Scoring: alpha-beta prediction of a spec, same posture as timing.py
# ---------------------------------------------------------------------------


def _wire_bytes_per_elem(spec: SynthSpec, elem_bytes: int) -> float:
    if spec.wire == "int8":
        return 1.0 + QUANT_SCALE_BYTES / QUANT_BLOCK_ELEMS
    return float(elem_bytes)


def hop_layout(spec: SynthSpec) -> list[tuple[str, int]]:
    """(tier, axis_distance) per hop channel of a tiered spec, in hop
    order — THE tier annotation of the factored search space: each hop
    is charged against its `TierLinks` entry (`tiered_phase_costs`) and
    compiles to its tier's ring permutation (`lower_plan` cross-checks
    the emitted DAG's send pairs against `RankMap.inner_perm` /
    `outer_perm` at exactly these distances)."""
    if not spec.tiers:
        raise SynthesisError(f"{spec.key} is not a tiered spec")
    L, P = spec.tiers
    ik, ok = _tier_kinds(spec.family)
    inner_hops = ([("inner", spec.distances[0])] * (L - 1)
                  if ik == "ring"
                  else [("inner", d) for d in spec.distances])
    if ok == "exchange":
        outer_hops = [("outer", d) for d in spec.outer_distances]
    elif ok == "rs_ag":
        outer_hops = [("outer", d) for d in spec.outer_distances] * 2
    else:  # ring RS + ring AG
        outer_hops = [("outer", spec.outer_distances[0])] * (2 * (P - 1))
    # the inner allgather mirrors the inner reduce-scatter's hop count
    return inner_hops + outer_hops + inner_hops


def _tiered_step_elems(spec: SynthSpec,
                       count: int) -> list[tuple[str, int]]:
    """(tier, elements-sent-per-rank) per hop of a tiered spec, in hop
    order (count padded up to the inner*outer chunking the DAG
    requires — the same rule `lower_plan` applies)."""
    L, P = spec.tiers
    padded = count + (-count) % (L * P)
    cpk = padded // L
    ik, ok = _tier_kinds(spec.family)
    k_i = len(spec.distances)
    if ik == "ring":
        inner_rs = [cpk] * (L - 1)
        inner_ag = [cpk] * (L - 1)
    else:
        inner_rs = [cpk * (1 << (k_i - i)) // 2 for i in range(k_i)]
        inner_ag = [cpk * (1 << i) for i in range(k_i)]
    if ok == "exchange":
        outer = [cpk] * len(spec.outer_distances)
    else:
        ocpk = cpk // P
        if ok == "ring":
            outer = [ocpk] * (2 * (P - 1))
        else:
            k_o = len(spec.outer_distances)
            outer = ([ocpk * (1 << (k_o - i)) // 2 for i in range(k_o)]
                     + [ocpk * (1 << i) for i in range(k_o)])
    return ([("inner", e) for e in inner_rs]
            + [("outer", e) for e in outer]
            + [("inner", e) for e in inner_ag])


def _step_elems(spec: SynthSpec, count: int) -> list[int]:
    """Per-step elements each rank sends (every rank sends the same —
    rank symmetry). `count` follows the descriptor convention of the
    op: allgather = chunk elems, reduce_scatter = output chunk elems,
    allreduce = payload elems. Tiered specs flatten their per-tier hop
    profile (the single-link fallback `cost_shape` documents)."""
    if spec.tiers:
        return [e for _t, e in _tiered_step_elems(spec, count)]
    w = spec.world
    k = len(spec.distances)
    if spec.family == "exchange":
        return [count] * k
    if spec.family == "doubling":
        return [count * (1 << i) for i in range(k)]
    if spec.family == "halving":
        return [count * (1 << (k - i)) // 2 for i in range(k)]
    if spec.family == "rs_ag":
        chunk = max(count // w, 1)
        rs = [chunk * (1 << (k - i)) // 2 for i in range(k)]
        ag = [chunk * (1 << i) for i in range(k)]
        return rs + ag
    raise SynthesisError(f"unknown family {spec.family!r}")


def cost_shape(spec: SynthSpec, count: int, elem_bytes: int,
               *, aggregate: bool = False) -> tuple[float, float]:
    """(messages, bytes) for one call of the synthesized schedule —
    critical path by default (every step is one full-ring permutation:
    all ranks move concurrently, so the critical path is the per-rank
    chain), aggregate = summed over ranks (the serialized-host shape
    timing.coefficients_aggregate documents). Bytes are WIRE bytes;
    jumbo-segment streaming charges one message per STREAM_SEG_BYTES
    like the hand-written eager shapes."""
    wb = _wire_bytes_per_elem(spec, elem_bytes)
    msgs = 0.0
    nbytes = 0.0
    for elems in _step_elems(spec, count):
        step_bytes = elems * wb
        msgs += max(1, math.ceil(step_bytes / STREAM_SEG_BYTES))
        nbytes += step_bytes
    if aggregate:
        return msgs * spec.world, nbytes * spec.world
    return msgs, nbytes


def predict_spec(link: Any, spec: SynthSpec, count: int,
                 elem_bytes: int, *, aggregate: bool = False) -> float:
    """Expected seconds under LinkParams `link` (timing.predict's synth
    counterpart; timing.coefficients routes SYNTHESIZED plans here).
    For a tiered spec this is the single-link FALLBACK (both tiers
    charged to one link); the calibrated per-tier prediction is
    `predict_spec_tiered`."""
    m, b = cost_shape(spec, count, elem_bytes, aggregate=aggregate)
    return float(link.seconds(m, b))


def tiered_phase_costs(spec: SynthSpec, count: int, elem_bytes: int,
                       *, aggregate: bool = False,
                       ) -> list[tuple[str, float, float]]:
    """(tier, messages, bytes) of a tiered spec's hops, summed per tier
    — the `timing.hier_phase_costs` accounting generalized to arbitrary
    tier-annotated hop sequences: every hop's wire bytes are charged to
    exactly the link it crosses. aggregate=True sums over all ranks
    (the serialized-host regime); default is the per-link critical
    path (every hop is a full-torus permutation — all ranks move
    concurrently)."""
    wb = _wire_bytes_per_elem(spec, elem_bytes)
    per: dict[str, list[float]] = {"inner": [0.0, 0.0],
                                   "outer": [0.0, 0.0]}
    for tier, elems in _tiered_step_elems(spec, count):
        step_bytes = elems * wb
        per[tier][0] += max(1, math.ceil(step_bytes / STREAM_SEG_BYTES))
        per[tier][1] += step_bytes
    scale = spec.world if aggregate else 1
    return [("inner", per["inner"][0] * scale, per["inner"][1] * scale),
            ("outer", per["outer"][0] * scale, per["outer"][1] * scale)]


def predict_spec_tiered(links: Any, spec: SynthSpec, count: int,
                        elem_bytes: int, *,
                        aggregate: bool = False) -> float:
    """Expected seconds for a tiered spec under a `timing.TierLinks`
    calibration: the phases serialize (the emitted DAG never overlaps
    tiers), so the prediction is the exact per-tier alpha-beta sum —
    which is also why it is an ADMISSIBLE pruning bound for the search:
    it is the model's exact cost of the candidate, not a relaxation,
    and certification can only reject candidates, never improve this
    score."""
    return float(sum(
        links.of(tier).seconds(m, b)
        for tier, m, b in tiered_phase_costs(spec, count, elem_bytes,
                                             aggregate=aggregate)))


def hand_written_best(link: Any, op: Operation, count: int,
                      elem_bytes: int, world: int, *,
                      rx_buf_bytes: int = 4096,
                      aggregate: bool = False,
                      wire: str = "") -> float:
    """The best PREDICTED hand-written time for this cell: the default
    selection plus every tuning-reachable alternative (the rendezvous
    compositions/trees the registers can force), so 'beats every
    hand-written algorithm' is checked against the whole zoo, not just
    the default pick. `wire="int8"` scores against the hand-written
    quantized ring (the baseline an int8 synthesized entry must
    beat)."""
    from ..constants import (
        DEFAULT_EAGER_RX_BUF_SIZE,
        DEFAULT_MAX_EAGER_SIZE,
        DEFAULT_MAX_RENDEZVOUS_SIZE,
        CompressionFlags,
        DataType,
        TuningParams,
    )
    from .plan import select_algorithm
    from .timing import predict

    comp = (CompressionFlags.ETH_COMPRESSED if wire
            else CompressionFlags.NO_COMPRESSION)
    cdt = DataType.int8 if wire == "int8" else DataType.none
    tunings = (
        TuningParams.default(DEFAULT_MAX_RENDEZVOUS_SIZE),
        # force the composition / tree branches so they compete
        TuningParams(allreduce_composition_max_count=1 << 62),
        TuningParams(bcast_flat_tree_max_ranks=2,
                     reduce_flat_tree_max_ranks=2,
                     reduce_flat_tree_max_count=64),
    )
    best = math.inf
    for tuning in tunings:
        plan = select_algorithm(
            op, count, elem_bytes, world, comp,
            max_eager_size=DEFAULT_MAX_EAGER_SIZE,
            eager_rx_buf_size=DEFAULT_EAGER_RX_BUF_SIZE,
            tuning=tuning, compress_dtype=cdt)
        t = predict(link, op, plan, count, elem_bytes, world,
                    rx_buf_bytes=rx_buf_bytes, aggregate=aggregate)
        best = min(best, t)
    return best


def hand_written_tiered_best(tier_links: Any, count: int,
                             elem_bytes: int,
                             tiers: tuple[int, int], *,
                             rx_buf_bytes: int = 4096,
                             aggregate: bool = False) -> float:
    """The best PREDICTED two-tier-aware hand-written time for this
    cell: the striped hierarchical composition at the cost model's own
    stripe count (timing.best_stripes' argmin — the strongest
    hand-written two-tier opponent, pipelining included) and the flat
    zoo charged to the OUTER link (every flat ring step crosses the
    slow tier — the same accounting the hier crossover scan uses). A
    tiered synthesized entry ships only when it beats BOTH."""
    from .plan import Algorithm, Plan, Protocol
    from .timing import best_stripes, predict_tiered

    L, P = tiers
    s = best_stripes(tier_links, count, elem_bytes, L, P,
                     aggregate=aggregate)
    hplan = Plan(Protocol.EAGER, Algorithm.HIER_RS_AR_AG, count, 1,
                 inner_world=L, outer_world=P, stripes=s)
    t_hier = predict_tiered(tier_links, hplan, count, elem_bytes,
                            aggregate=aggregate)
    t_flat = hand_written_best(tier_links.outer, Operation.allreduce,
                               count, elem_bytes, L * P,
                               rx_buf_bytes=rx_buf_bytes,
                               aggregate=aggregate)
    return min(t_hier, t_flat)


# ---------------------------------------------------------------------------
# Search: enumerate -> prune -> certify -> score
# ---------------------------------------------------------------------------


def enumerate_candidates(op: Operation, world: int,
                         include_wire: bool = True,
                         ) -> Iterator[SynthSpec]:
    """All valid FLAT candidates for (op, world) in deterministic
    lexicographic order. Distances are strictly increasing (two equal
    distances always collide in the subset-sum check) and k is pinned
    to log2(world) by the exact-cover condition; candidates with the
    same per-step byte profile are cost-equivalent, so dominance
    pruning keeps only the lexicographically first of each family —
    found by the branch-and-bound DFS (`_valid_distance_tuples`), which
    is what keeps enumeration O(k*world) at w64-w256 instead of the
    combinations scan's millions of dead tuples."""
    if world < 2 or world & (world - 1):
        return  # the symmetric families need 2^k == world
    op_name = op.name
    families = {"allreduce": ("exchange", "rs_ag"),
                "allgather": ("doubling",),
                "reduce_scatter": ("halving",)}[op_name]
    distances = _first_valid_tuple(world)
    if distances is None:
        return
    for family in families:
        yield SynthSpec(
            key=_spec_key(op_name, world, family, distances, ""),
            op=op_name, world=world, family=family,
            distances=distances)
        if include_wire and family == "exchange":
            yield SynthSpec(
                key=_spec_key(op_name, world, family, distances,
                              "int8"),
                op=op_name, world=world, family=family,
                distances=distances, wire="int8")


def enumerate_tiered_candidates(world: int, tiers: tuple[int, int],
                                ) -> Iterator[SynthSpec]:
    """All tiered allreduce candidates for one (inner, outer) factoring
    of `world`, deterministic order: the per-tier family product
    {lg, ring} x {exchange, rs_ag, ring}, each at its dominance-
    representative distance tuple. The log-step kinds need a
    power-of-two axis; the ring kinds serve ANY axis extent (d = 1),
    which is what keeps non-power-of-two pod slices searchable.
    Degenerate duplicates are skipped (at an axis extent of 2 the ring
    and the log-step member emit the same hops; ring == rs_ag on the
    outer shard at P = 2)."""
    L, P = tiers
    if L < 2 or P < 2 or L * P != world:
        return
    inner_kinds: list[tuple[str, tuple[int, ...]]] = []
    i_tuple = _first_valid_tuple(L)
    if i_tuple is not None:
        inner_kinds.append(("lg", i_tuple))
    if L > 2 or i_tuple is None:
        inner_kinds.append(("ring", (1,)))
    outer_kinds: list[tuple[str, tuple[int, ...]]] = []
    o_tuple = _first_valid_tuple(P)
    if o_tuple is not None:
        outer_kinds.append(("exchange", o_tuple))
        outer_kinds.append(("rs_ag", o_tuple))
    if P > 2 or o_tuple is None:
        outer_kinds.append(("ring", (1,)))
    for ik, di in inner_kinds:
        for ok, do in outer_kinds:
            family = f"t_{ik}_{ok}"
            yield SynthSpec(
                key=_tiered_key(world, (L, P), family, di, do),
                op="allreduce", world=world, family=family,
                distances=di, tiers=(L, P), outer_distances=do)


@dataclasses.dataclass
class SearchResult:
    """One library-ready winner: its spec, certified canonical DAG, and
    the predicted winning byte window under the scoring link."""

    spec: SynthSpec
    dag: HopDag
    win_bytes: tuple[int, int]
    predicted: dict[int, tuple[float, float]]  # bytes -> (synth, hand)


def _narrow_contiguous(wins: list[int], size_grid: tuple[int, ...],
                       key: str, say: Callable[[str], None],
                       ) -> tuple[int, int]:
    """Longest contiguous grid run of a win set: select_entry treats
    every payload inside [lo, hi] as a predicted win, so a win set with
    a losing cell in the middle must not overclaim the whole span."""
    runs: list[list[int]] = [[wins[0]]]
    for prev, nbytes in zip(wins, wins[1:]):
        if size_grid.index(nbytes) - size_grid.index(prev) == 1:
            runs[-1].append(nbytes)
        else:
            runs.append([nbytes])
    run = max(runs, key=len)
    if len(run) < len(wins):
        say(f"narrow {key}: win cells non-contiguous across "
            f"the grid; keeping [{run[0]}, {run[-1]}]")
    return run[0], run[-1]


def score_window(link: Any, spec: SynthSpec, *,
                 elem_bytes: int = 4,
                 size_grid: tuple[int, ...] | None = None,
                 aggregate: bool = False,
                 log: Callable[[str], None] | None = None,
                 ) -> tuple[tuple[int, int] | None,
                            dict[int, tuple[float, float]]]:
    """Score one FLAT spec per size-grid cell against the best
    hand-written prediction (strict inequality wins) and narrow the win
    set to its longest CONTIGUOUS grid run. The ONE window rule shared
    by search/--export and verify_library — a scoring change lands here
    or nowhere. `size_grid` defaults to the spec's OWN grid
    (`grid_for`: SIZE_GRID_LAT for grid="lat" entries), so a lat
    entry's window re-scores on the cells it was searched over.
    Returns (window or None, per-cell predictions)."""
    say = log or (lambda m: None)
    if size_grid is None:
        size_grid = grid_for(spec)
    wins: list[int] = []
    predicted: dict[int, tuple[float, float]] = {}
    op = Operation[spec.op]
    for nbytes in size_grid:
        count = max(nbytes // elem_bytes, 1)
        t_synth = predict_spec(link, spec, count, elem_bytes,
                               aggregate=aggregate)
        # an int8 candidate competes against the hand-written
        # QUANTIZED ring — never against the exact fp32 zoo (a
        # lossy schedule must not displace an exact one)
        t_hand = hand_written_best(link, op, count, elem_bytes,
                                   spec.world, aggregate=aggregate,
                                   wire=spec.wire)
        predicted[nbytes] = (t_synth, t_hand)
        if t_synth < t_hand:
            wins.append(nbytes)
    if not wins:
        return None, predicted
    return _narrow_contiguous(wins, size_grid, spec.key, say), predicted


def score_window_tiered(tier_links: Any, spec: SynthSpec, *,
                        elem_bytes: int = 4,
                        size_grid: tuple[int, ...] = SIZE_GRID,
                        aggregate: bool = False,
                        log: Callable[[str], None] | None = None,
                        ) -> tuple[tuple[int, int] | None,
                                   dict[int, tuple[float, float]]]:
    """The tiered-entry window rule: per size-grid cell, the spec's
    per-tier prediction (every hop charged to ITS link) must strictly
    beat `hand_written_tiered_best` — the striped hierarchical
    composition at the model's own stripe count AND the flat zoo on the
    outer link. Shared by search/--export and verify_library's tiered
    leg exactly like `score_window` is for flat entries.

    A win needs a (tiny) relative MARGIN, not one ULP: the composition
    re-discovered (the ring x ring member) predicts EXACTLY the striped
    composition's serial form, differing only in summation order — a
    tie is a keep-out, never a shippable entry, and a summation-order
    artifact must not flip windows between hosts."""
    say = log or (lambda m: None)
    wins: list[int] = []
    predicted: dict[int, tuple[float, float]] = {}
    L, P = spec.tiers
    for nbytes in size_grid:
        count = max(nbytes // elem_bytes, 1)
        t_synth = predict_spec_tiered(tier_links, spec, count,
                                      elem_bytes, aggregate=aggregate)
        t_hand = hand_written_tiered_best(tier_links, count, elem_bytes,
                                          (L, P), aggregate=aggregate)
        predicted[nbytes] = (t_synth, t_hand)
        if t_synth < t_hand * (1.0 - 1e-9):
            wins.append(nbytes)
    if not wins:
        return None, predicted
    return _narrow_contiguous(wins, size_grid, spec.key, say), predicted


def search(op: Operation, world: int, link: Any, *,
           elem_bytes: int = 4,
           size_grid: tuple[int, ...] | None = None,
           aggregate: bool = False,
           log: Callable[[str], None] | None = None,
           beam: int | None = None,
           tiers: tuple[int, int] | None = None,
           tier_links: Any = None,
           grid: str = "std",
           ) -> list[SearchResult]:
    """The full synthesize -> score -> prune -> certify loop for one
    (op, world) — flat by default, or the factored space for one
    (inner, outer) factoring when `tiers` is given (then `tier_links`
    supplies the per-tier scoring calibration).

    Candidates are SCORED FIRST with the alpha-beta model (per-tier
    charged for tiered candidates) — the model's exact serial cost of
    the emitted DAG, so pruning on it is admissible (see module
    docstring) — and only the survivors pay certification: losers are
    reported as keep-outs without ever instantiating a DAG, and
    `beam` keeps only the beam best predicted advantages (ranked by
    best hand/synth ratio over the window; ties break to key order so
    the prune is deterministic). Every survivor is then CERTIFIED with
    the existing stack; a candidate with any diagnostic is discarded
    LOUDLY (reported through `log`) and can never reach the library.
    Winners are returned in enumeration order with their contiguous
    winning windows."""
    say = log or (lambda m: None)
    if grid not in ("std", "lat"):
        raise SynthesisError(f"unknown scoring grid {grid!r}")
    if grid == "lat" and tiers is not None:
        raise SynthesisError(
            "the latency grid scores FLAT candidates only: tiered "
            "windows are per-tier predictions selected through the "
            "hier register, not the latency window")
    if size_grid is None:
        size_grid = SIZE_GRID_LAT if grid == "lat" else SIZE_GRID
    if tiers is not None and op != Operation.allreduce:
        raise SynthesisError(
            f"the tiered families implement allreduce only; a tiered "
            f"{op.name} search has no candidates to return (and must "
            "not silently hand back allreduce schedules)")
    if tiers is not None and tier_links is None:
        raise SynthesisError(
            "tiered search needs tier_links (per-tier scoring "
            "calibration): pass timing.TierLinks, e.g. "
            "shipped_tier_links()")
    scored: list[tuple[SynthSpec, tuple[int, int],
                       dict[int, tuple[float, float]], float]] = []
    cands = (enumerate_tiered_candidates(world, tiers)
             if tiers is not None else enumerate_candidates(op, world))
    if grid == "lat":
        # the same candidate space re-scored on the latency grid: keys
        # get a "_lat" suffix so a member can ship BOTH a bandwidth
        # window and a latency window without colliding in the library
        cands = (dataclasses.replace(s, key=s.key + "_lat", grid="lat")
                 for s in cands)
    for spec in cands:
        if spec.tiers:
            window, predicted = score_window_tiered(
                tier_links, spec, elem_bytes=elem_bytes,
                size_grid=size_grid, aggregate=aggregate, log=say)
        else:
            window, predicted = score_window(
                link, spec, elem_bytes=elem_bytes, size_grid=size_grid,
                aggregate=aggregate, log=say)
        if window is None:
            say(f"keep-out {spec.key}: never beats the hand-written "
                "baselines on this link (pruned before certification)")
            continue
        advantage = max(
            hand / synth
            for nb, (synth, hand) in predicted.items()
            if window[0] <= nb <= window[1] and synth > 0)
        scored.append((spec, window, predicted, advantage))
    if beam is not None and len(scored) > beam:
        ranked = sorted(scored, key=lambda s: (-s[3], s[0].key))
        kept = {id(s) for s in ranked[:beam]}
        for spec, _w, _p, adv in ranked[beam:]:
            say(f"PRUNE {spec.key}: outside the beam of {beam} "
                f"(predicted advantage {adv:.2f}x) — never certified")
        scored = [s for s in scored if id(s) in kept]
    results: list[SearchResult] = []
    for spec, window, predicted, _adv in scored:
        ok, diags = certify_spec(spec)
        if not ok:
            say(f"DISCARD {spec.key}: candidate failed certification: "
                + "; ".join(str(d) for d in diags[:4]))
            continue
        dag = instantiate(spec, canonical_count(spec))
        results.append(SearchResult(
            spec=spec, dag=dag, win_bytes=window, predicted=predicted))
        n_cells = (size_grid.index(window[1])
                   - size_grid.index(window[0]) + 1)
        say(f"WINNER {spec.key}: beats hand-written on "
            f"[{window[0]}, {window[1]}] bytes "
            f"({n_cells}/{len(size_grid)} cells)")
    return results


# ---------------------------------------------------------------------------
# Library: the committed synthesized/ directory
# ---------------------------------------------------------------------------


def library_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "synthesized"


@dataclasses.dataclass(frozen=True)
class LibraryEntry:
    spec: SynthSpec
    win_bytes: tuple[int, int]
    canonical_count: int
    path: pathlib.Path
    dag_sha256: str = ""  # dag_digest of the canonical DAG


def dag_digest(dag: HopDag) -> str:
    """The library's drift digest of a DAG: SHA-256 of its JSON form with
    sorted keys (the module docstring's drift check)."""
    return hashlib.sha256(json.dumps(to_json(dag), sort_keys=True)
                          .encode()).hexdigest()


_LIBRARY: dict[str, LibraryEntry] | None = None


def clear_library_cache() -> None:
    global _LIBRARY
    _LIBRARY = None


def library() -> dict[str, LibraryEntry]:
    """key -> entry for every committed synthesized schedule. Cached;
    `clear_library_cache()` rescans (tests, regeneration)."""
    global _LIBRARY
    if _LIBRARY is None:
        entries: dict[str, LibraryEntry] = {}
        d = library_dir()
        if d.is_dir():
            for p in sorted(d.glob("*.json")):
                try:
                    doc = json.loads(p.read_text())
                    spec = SynthSpec.from_json(doc)
                    lo, hi = doc.get("win_bytes", [0, 0])
                    entries[spec.key] = LibraryEntry(
                        spec=spec, win_bytes=(int(lo), int(hi)),
                        canonical_count=int(doc.get(
                            "canonical_count", canonical_count(spec))),
                        path=p, dag_sha256=str(doc.get("dag_sha256", "")))
                except (OSError, ValueError, KeyError) as e:
                    raise SynthesisError(
                        f"unreadable synthesized library entry {p}: "
                        f"{e!r}") from e
        _LIBRARY = entries
    return _LIBRARY


def select_entry(op: Operation, world: int, payload_bytes: int,
                 wire: str = "",
                 tiers: tuple[int, ...] = (),
                 grid: str = "std") -> str | None:
    """The library entry `plan.select_algorithm` should use for this
    cell, or None. `tiers=()` (the default) matches only FLAT entries —
    the synth registers' uniform-link windows; `tiers=(inner, outer)`
    matches only the tiered entries of that exact factoring (the
    HIER_ALLREDUCE_MIN_COUNT window's predicted-time arbitration).
    `grid="std"` (the default) matches only SIZE_GRID entries;
    `grid="lat"` matches only the latency-grid entries behind
    SYNTH_LATENCY_MAX_COUNT — the two windows never cross-select.
    Among matching entries the one whose predicted winning window
    contains the payload wins; ties break to the narrower window (the
    more specialized schedule), then key order — all deterministic."""
    best: LibraryEntry | None = None
    for entry in library().values():
        s = entry.spec
        if (s.op != op.name or s.world != world or s.wire != wire
                or s.tiers != tuple(tiers) or s.grid != grid):
            continue
        lo, hi = entry.win_bytes
        if not (lo <= payload_bytes <= hi):
            continue
        if best is None:
            best = entry
            continue
        bw = best.win_bytes[1] - best.win_bytes[0]
        ew = hi - lo
        if ew < bw or (ew == bw and entry.spec.key < best.spec.key):
            best = entry
    return best.spec.key if best else None


def entry_for_key(key: str) -> LibraryEntry:
    entry = library().get(key)
    if entry is None:
        raise SynthesisError(
            f"no synthesized library entry {key!r} "
            f"(library at {library_dir()})")
    return entry


def export_entry(result: SearchResult,
                 out_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Write one winner to the library in the port's form: the spec, its
    window and canonical count, and the canonical DAG's digest in place
    of its body."""
    out = out_dir or library_dir()
    out.mkdir(parents=True, exist_ok=True)
    doc = result.spec.to_json()
    doc["schema"] = 1
    doc["canonical_count"] = canonical_count(result.spec)
    doc["win_bytes"] = list(result.win_bytes)
    doc["cert"] = {"semantic": "clean", "modelcheck": "clean"}
    doc["dag_sha256"] = dag_digest(result.dag)
    path = out / f"{result.spec.key}.json"
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return path


def shipped_link() -> Any:
    """LinkParams of the port's copy of the shipped timing model
    (timing.emulator_link, the reference's one resolution rule)."""
    from ..telemetry.feedback import MODEL_PATH
    from .timing import emulator_link

    try:
        return emulator_link(json.loads(MODEL_PATH.read_text()))
    except (OSError, ValueError) as e:
        raise SynthesisError(
            f"cannot load the shipped timing model {MODEL_PATH}: "
            f"{e!r}") from e


def shipped_tier_links() -> Any:
    """TierLinks of the shipped timing model's `link_tiers` section, the
    calibration the tiered entries were scored under; raises when the
    model has none."""
    from ..telemetry.feedback import default_tier_links

    tiers = default_tier_links()
    if tiers is None:
        raise SynthesisError(
            "the shipped timing model carries no link_tiers (the "
            "calibration tiered library windows are scored under)")
    return tiers


def verify_library(log: Callable[[str], None] | None = None,
                   link: Any = None, tier_links: Any = None) -> bool:
    """Re-certify every committed entry from scratch: the spec must
    regenerate the committed DAG (its digest equal to the entry's
    `dag_sha256`: the generator drift check), the DAG must pass
    semantics + deep modelcheck clean, and the committed win_bytes
    window must equal a fresh `score_window` under `link` (default: the
    shipped calibrated model), so a timing-model or cost-model change
    that leaves stale selection windows fails here instead of silently
    steering `select_entry`. TIERED entries re-score under `tier_links`
    (default: the shipped `link_tiers` calibration). The gate that keeps
    a stale library or a checker change from shipping an uncertified
    schedule."""
    say = log or print
    ok = True
    entries = library()
    if not entries:
        say("synthesized library is EMPTY")
        return False
    if link is None:
        link = shipped_link()
    for key, entry in sorted(entries.items()):
        regen = instantiate(entry.spec, entry.canonical_count)
        if dag_digest(regen) != entry.dag_sha256:
            say(f" FAIL {key}: regenerated DAG's digest != committed "
                "dag_sha256 (generator drift — re-export the library)")
            ok = False
            continue
        diags = certify_dag(regen, entry.spec, entry.canonical_count)
        if diags:
            say(f" FAIL {key}: committed DAG no longer certifies: "
                + "; ".join(str(d) for d in diags[:4]))
            ok = False
            continue
        if entry.spec.tiers:
            if tier_links is None:
                tier_links = shipped_tier_links()
            window, _ = score_window_tiered(tier_links, entry.spec)
        else:
            window, _ = score_window(link, entry.spec)
        if window != entry.win_bytes:
            say(f" FAIL {key}: committed win_bytes "
                f"{list(entry.win_bytes)} != fresh scoring "
                f"{list(window) if window else None} under the scoring "
                "link (stale selection window — re-export the library)")
            ok = False
            continue
        tier_note = (f", tiers {entry.spec.tiers[0]}x"
                     f"{entry.spec.tiers[1]}" if entry.spec.tiers else "")
        say(f"  ok  {key}: regenerates + certifies clean, win window "
            f"current ({len(regen.nodes)} nodes, "
            f"world {entry.spec.world}{tier_note})")
    return ok


# ---------------------------------------------------------------------------
# Lowering: a library hop-DAG -> a schedule body over stacked rank rows
# ---------------------------------------------------------------------------


def _check_same_rank_dataflow(dag: HopDag) -> None:
    """The lowering's structural precondition: ranks in range, every
    piece reference resolves to a node of the SAME rank (cross-rank data
    flows only through send/recv hops: row r of a round reads row r of
    its sources), at most one send per (hop, rank), and every recv hop
    has a send. Raises SynthesisError: no lowering compiles such a DAG
    correctly."""
    rank_of: dict[int, int] = {}
    for n in dag.nodes:
        if not 0 <= n.rank < dag.world:
            raise SynthesisError(f"node {n.id} rank {n.rank} out of range")
        rank_of[n.id] = n.rank

    def check_refs(value: Value, rank: int, what: str) -> None:
        for pc in value:
            if pc.node == CONST:
                continue
            src = rank_of.get(pc.node)
            if src is None:
                raise SynthesisError(
                    f"{what} references unknown node {pc.node}")
            if src != rank:
                raise SynthesisError(
                    f"{what} is a cross-rank piece reference (data must "
                    f"flow through send/recv hops)")

    send_ranks: dict[int, set[int]] = {}
    for n in dag.nodes:
        check_refs(n.value, n.rank, f"node {n.id}")
        check_refs(n.value2, n.rank, f"node {n.id}")
        if n.kind == "send":
            ranks = send_ranks.setdefault(n.hop, set())
            if n.rank in ranks:
                raise SynthesisError(
                    f"hop {n.hop} has multiple sends from rank {n.rank}")
            ranks.add(n.rank)
    for n in dag.nodes:
        if n.kind == "recv" and n.hop not in send_ranks:
            raise SynthesisError(
                f"recv node {n.id} has no matching send on hop {n.hop}")
    for r, out in enumerate(dag.outputs):
        check_refs(out, r, f"rank {r} output")


def _check_tier_layout(dag: HopDag, spec: SynthSpec) -> None:
    """Cross-check the spec's tier annotation against the emitted DAG:
    every hop's (rank -> peer) send pairs must be EXACTLY the RankMap
    ring permutation of its annotated (tier, distance) — the
    `ring=(pos, perm)` embedding the compiled ppermute uses and the
    per-tier cost accounting charges. A mismatch means the annotation
    would charge (or compile) the hop on the wrong tier: FATAL, never
    a fallback — a mis-annotated hop would silently bill DCN traffic
    to ICI."""
    from .hierarchical import RankMap

    L, P = spec.tiers
    rm = RankMap(L, P, "outer_major")
    layout = hop_layout(spec)
    pairs: dict[int, set[tuple[int, int]]] = {}
    for n in dag.nodes:
        if n.kind == "send":
            pairs.setdefault(n.hop, set()).add((n.rank, n.peer))
    if sorted(pairs) != list(range(len(layout))):
        raise SynthesisError(
            f"{spec.key}: DAG hops {sorted(pairs)} do not match the "
            f"tier annotation's {len(layout)} channels")
    for h, (tier, d) in enumerate(layout):
        want = set(rm.inner_perm(d) if tier == "inner"
                   else rm.outer_perm(d))
        if pairs[h] != want:
            raise SynthesisError(
                f"{spec.key}: hop {h} send pairs are not the {tier} "
                f"ring permutation at distance {d} — the tier "
                "annotation disagrees with the emitted DAG")


def _rounds(dag: HopDag) -> list[tuple[Node, ...]]:
    """The DAG's rank-major rounds: node r of a round is rank r's, and
    the round's nodes agree in everything but their peers and piece
    offsets. Every generator emits its DAG so (`_Builder.emit_round`);
    the port lowers no other shape, and says so rather than guess."""
    w = dag.world
    if len(dag.nodes) % w:
        raise SynthesisError(
            f"{len(dag.nodes)} nodes do not split into rounds of world "
            f"{w}: the port lowers rank-major round-structured DAGs only")
    rounds = []
    for start in range(0, len(dag.nodes), w):
        r = dag.nodes[start:start + w]
        b = r[0]
        for g, n in enumerate(r):
            if (n.rank != g or n.kind != b.kind or n.length != b.length
                    or n.func != b.func or n.dtype != b.dtype
                    or n.hop != b.hop or n.arg != b.arg
                    or n.scales_len != b.scales_len):
                raise SynthesisError(
                    f"node {n.id} breaks the rank-major round of node "
                    f"{start}: the port lowers round-structured DAGs only")
        rounds.append(r)
    return rounds


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Piece j of every rank's value: `length` elements of round
    `round`'s output part `part`, at offset `offsets[r]` on rank r's row
    (round -1: a constant `fill`)."""

    length: int
    round: int = -1
    part: str = DATA
    offsets: tuple[int, ...] = ()
    fill: float = 0.0


@dataclasses.dataclass(frozen=True)
class _Blocks:
    """A value whose piece j comes from different rounds on different
    ranks (the allgather families' rank-absolute layouts): rows of
    `width` blocks of `block` elements, each source round's blocks moved
    by one gather: (round, part, rows, source blocks, destination
    blocks), row r's blocks coming from row r of the source."""

    block: int
    width: int
    moves: tuple[tuple[int, str, tuple[int, ...], tuple[int, ...],
                       tuple[int, ...]], ...]


def _plan_value(values: Sequence[Value], round_of: dict[int, int],
                widths: dict[tuple[int, str], int], what: str):
    """How to build one Value per rank: its slots, where _slots finds
    them, else its blocks."""
    slots = _slots(values, round_of, widths)
    return slots if slots is not None else _blocks(values, round_of,
                                                   widths, what)


def _slots(values: Sequence[Value], round_of: dict[int, int],
           widths: dict[tuple[int, str], int]) -> tuple[_Slot, ...] | None:
    """The slots of one Value per rank when piece j of every rank agrees
    in length, part and producing round and its offsets are equal or
    whole blocks of its length; None otherwise."""
    n = len(values[0])
    if any(len(v) != n for v in values):
        return None
    slots = []
    for ps in zip(*values):
        p0 = ps[0]
        if p0.node == CONST:
            if any(p.node != CONST or p.length != p0.length
                   or p.fill != p0.fill for p in ps):
                return None
            slots.append(_Slot(p0.length, fill=p0.fill))
            continue
        if any(p.node == CONST or p.length != p0.length
               or p.part != p0.part
               or round_of[p.node] != round_of[p0.node] for p in ps):
            return None
        offs = tuple(p.offset for p in ps)
        width = widths[(round_of[p0.node], p0.part)]
        if len(set(offs)) > 1 and (width % p0.length or any(
                o % p0.length for o in offs)):
            return None
        slots.append(_Slot(p0.length, round_of[p0.node], p0.part, offs))
    return tuple(slots)


def _blocks(values: Sequence[Value], round_of: dict[int, int],
            widths: dict[tuple[int, str], int], what: str) -> _Blocks:
    """One Value per rank as blocks of the greatest common length of
    every piece, offset and source width."""
    if any(p.node == CONST for v in values for p in v):
        raise SynthesisError(f"{what}: a constant piece differs by rank")
    block = 0
    for v in values:
        for p in v:
            block = math.gcd(block, p.length, p.offset,
                             widths[(round_of[p.node], p.part)])
    moves: dict[tuple[int, str], tuple[list[int], list[int], list[int]]] = {}
    width = -1
    for g, v in enumerate(values):
        pos = 0
        for p in v:
            rows, src, dst = moves.setdefault(
                (round_of[p.node], p.part), ([], [], []))
            for k in range(p.length // block):
                rows.append(g)
                src.append(p.offset // block + k)
                dst.append(pos + k)
            pos += p.length // block
        if width not in (-1, pos):
            raise SynthesisError(f"{what}: the ranks' values differ in "
                                 "length")
        width = pos
    return _Blocks(block, width, tuple(
        (r, part, tuple(rows), tuple(src), tuple(dst))
        for (r, part), (rows, src, dst) in moves.items()))


def _take(env: dict, slot: _Slot, like: Any, ranks: range) -> Any:
    """Slot `slot` of every row (row i rank ranks[i]'s): a view where the
    offset is the same on every such rank, else one gather of each row's
    block (every offset is then a whole number of blocks: _plan_value)."""
    import torch

    from .schedules import _row_tensor

    w = like.shape[0]
    if slot.round < 0:
        return torch.full((w, slot.length), slot.fill, dtype=like.dtype,
                          device=like.device)
    src = env[(slot.round, slot.part)]
    offs, n = slot.offsets[ranks.start:ranks.stop], slot.length
    if all(o == offs[0] for o in offs):
        return src[:, offs[0]:offs[0] + n]
    rows = _row_tensor(tuple(range(w)), src.device)
    blocks = _row_tensor(tuple(o // n for o in offs), src.device)
    return src.unflatten(1, (-1, n))[rows, blocks]


def _value(env: dict, plan, like: Any, ranks: range) -> Any:
    """Build a value planned by _plan_value over the rows of `like`, row i
    rank ranks[i]'s."""
    import torch

    from .schedules import _row_tensor

    if isinstance(plan, _Blocks):
        out = None
        for r, part, rows, src_blk, dst_blk in plan.moves:
            src = env[(r, part)].unflatten(1, (-1, plan.block))
            if out is None:
                out = src.new_empty((like.shape[0], plan.width,
                                     plan.block))
            held = [(g - ranks.start, sb, db)
                    for g, sb, db in zip(rows, src_blk, dst_blk)
                    if g in ranks]
            if not held:
                continue
            if len(held) < len(rows) or ranks.start:
                rows, src_blk, dst_blk = (tuple(c) for c in zip(*held))
            rows_t = _row_tensor(rows, src.device)
            out[rows_t, _row_tensor(dst_blk, src.device)] = \
                src[rows_t, _row_tensor(src_blk, src.device)]
        return out.flatten(1)
    parts = [_take(env, s, like, ranks) for s in plan]
    if not parts:
        return like.new_zeros((like.shape[0], 0))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _rounds_read(plan) -> set[int]:
    if isinstance(plan, _Blocks):
        return {m[0] for m in plan.moves}
    return {s.round for s in plan if s.round >= 0}


@dataclasses.dataclass(frozen=True)
class _RoundPlan:
    """What lower_dag runs: per round (index, its rank-0 node, the plans
    of its two values, a recv's (send round, pairs)), the fold rounds
    fused with the decode round they read, the rounds read unfused, and
    the plan of the outputs."""

    steps: tuple
    fused: dict[int, int]
    read_unfused: frozenset[int]
    out_plan: Any


def _round_plan(dag: HopDag) -> _RoundPlan:
    _check_same_rank_dataflow(dag)
    rounds = _rounds(dag)
    round_of = {n.id: i for i, r in enumerate(rounds) for n in r}
    send_round: dict[int, int] = {}
    for i, r in enumerate(rounds):
        if r[0].kind == "send":
            if r[0].hop in send_round:
                raise SynthesisError(f"hop {r[0].hop} has two send rounds")
            send_round[r[0].hop] = i
    widths = {}
    for i, r in enumerate(rounds):
        widths[(i, DATA)] = r[0].length
        widths[(i, SCALES)] = r[0].scales_len
    steps = []
    for i, r in enumerate(rounds):
        n0 = r[0]
        what = f"the round of node {n0.id}"
        val = _plan_value([n.value for n in r], round_of, widths, what)
        val2 = _plan_value([n.value2 for n in r], round_of, widths, what)
        extra: Any = None
        if n0.kind == "recv":
            s = send_round[n0.hop]
            extra = (s, tuple((m.rank, m.peer) for m in rounds[s]))
        steps.append((i, n0, val, val2, extra))
    # a fold whose second operand is a whole decode round's output runs
    # as the fused dequantize-combine; that decode round then runs only
    # if something else reads it
    fused: dict[int, int] = {}
    for i, n0, val, val2, _ in steps:
        if (n0.kind == "combine" and isinstance(val2, tuple)
                and len(val2) == 1 and val2[0].round >= 0
                and rounds[val2[0].round][0].kind == "decode"
                and val2[0].part == DATA
                and val2[0].length == rounds[val2[0].round][0].length
                and not any(val2[0].offsets)):
            fused[i] = val2[0].round
    out_plan = _plan_value(list(dag.outputs), round_of, widths,
                           "the outputs")
    read_unfused = _rounds_read(out_plan)
    for i, _, val, val2, _ in steps:
        read_unfused |= _rounds_read(val)
        if i not in fused:
            read_unfused |= _rounds_read(val2)
    return _RoundPlan(tuple(steps), fused, frozenset(read_unfused),
                      out_plan)


def round_launches(dag: HopDag) -> dict[str, int]:
    """The kernel launches one run of lower_dag(dag)'s body makes on the
    card, read off its round plan: an unfused fold round launches the
    combine lane kernel, a fused decode+fold round dequant_combine, an
    encode round quantize, a decode round read unfused dequantize, a cast
    round with a dtype the cast lane kernel. Raises SynthesisError where
    lower_dag does."""
    plan = _round_plan(dag)
    out = dict.fromkeys(("combine", "dequant_combine", "quantize",
                         "dequantize", "cast"), 0)
    for i, n0, *_ in plan.steps:
        if n0.kind == "combine":
            out["dequant_combine" if i in plan.fused else "combine"] += 1
        elif n0.kind == "encode":
            out["quantize"] += 1
        elif n0.kind == "decode" and i in plan.read_unfused:
            out["dequantize"] += 1
        elif n0.kind == "cast" and n0.dtype:
            out["cast"] += 1
    return out


def lower_dag(dag: HopDag, permute: Callable | None = None,
              ranks: range | None = None) -> Callable[[Any], Any]:
    """Compile a library hop-DAG into a schedule body: (world, in_elems)
    rank rows -> (world, out_elems), one operation per round (the
    module docstring has the design). Hops go through
    schedules._permute (a roll for a rotation, a gather for a tier
    ring), folds through reduce_ops.combine_op (the lane kernel),
    encode and decode through the blockwise int8 lanes, casts through
    the cast lane.

    `ranks` are the ranks whose rows the body is given (default: every
    rank) and `permute` its hop over them (default schedules._permute):
    the multi-process DCN form gives one process's consecutive share of
    the ranks and its ProcessWire's hop."""
    if ranks is None:
        ranks = range(dag.world)
    plan = _round_plan(dag)
    steps, fused, read_unfused = plan.steps, plan.fused, plan.read_unfused
    out_plan = plan.out_plan

    def body(x: Any) -> Any:
        import torch

        from ..ops.compression import (
            dequant_combine,
            dequantize_blockwise,
            quantize_blockwise,
        )
        from ..ops.lane_kernels import cast
        from ..ops.reduce_ops import combine_op
        from .schedules import _permute

        hop = permute or _permute
        value = functools.partial(_value, ranks=ranks)
        env: dict[tuple[int, str], Any] = {}
        for i, n0, val, val2, extra in steps:
            kind = n0.kind
            if kind == "arg":
                out = x[:, :n0.length]
            elif kind == "send":
                out = value(env, val, x)
            elif kind == "recv":
                s, pairs = extra
                out = hop(env[(s, DATA)], pairs)[:, :n0.length]
            elif kind == "combine":
                func = (ReduceFunction.MAX if n0.func == "max"
                        else ReduceFunction.SUM)
                if i in fused:
                    _, _, dval, dval2, _ = steps[fused[i]]
                    out = dequant_combine(
                        value(env, dval, x), value(env, dval2, x),
                        value(env, val, x), n0.func or "sum")
                else:
                    out = combine_op(func, value(env, val, x),
                                     value(env, val2, x))
            elif kind == "encode":
                q, sc = quantize_blockwise(value(env, val, x))
                env[(i, SCALES)] = sc
                out = q
            elif kind == "decode":
                if i not in read_unfused:
                    continue
                out = dequantize_blockwise(value(env, val, x),
                                           value(env, val2, x),
                                           n0.length, x.dtype)
            elif kind == "cast":
                v = value(env, val, x)
                out = cast(v, getattr(torch, n0.dtype)) if n0.dtype else v
            else:
                raise SynthesisError(f"cannot lower node kind {kind!r}")
            env[(i, DATA)] = out
        result = value(env, out_plan, x).contiguous()
        if result.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr():
            result = result.clone()  # a result never aliases its operand
        return result

    return body


def lower_plan(plan: Any, options: Any, world: int,
               permute: Callable | None = None,
               ranks: range | None = None) -> Callable[[Any], Any]:
    """The ScheduleCompiler seam for Algorithm.SYNTHESIZED plans: resolve
    the plan's library entry, regenerate its DAG at the call's count
    (padded to the chunking multiple of the chunked families, the
    result trimmed back), and lower it (`permute` and `ranks` as in
    lower_dag). Tiered entries first check their hop annotation against
    the RankMap ring permutations. Raises when the key is missing or the
    entry's world or collective disagrees: a synthesized plan never falls
    back to another schedule."""
    import torch

    entry = entry_for_key(plan.synth_key)
    spec = entry.spec
    if spec.world != world:
        raise SynthesisError(
            f"synthesized entry {spec.key} is for world {spec.world}, "
            f"called with world {world}")
    if spec.scenario != options.scenario:
        raise SynthesisError(
            f"synthesized entry {spec.key} implements {spec.op}, "
            f"called as {options.scenario.name}")
    func = ("max" if ReduceFunction(options.function)
            == ReduceFunction.MAX else "sum")
    count = int(options.count)
    chunk_by = 0
    if spec.tiers:
        chunk_by = spec.tiers[0] * spec.tiers[1]
    elif spec.family == "rs_ag":
        chunk_by = world
    padded = count + (-count) % chunk_by if chunk_by else count
    dag = instantiate(spec, padded, func)
    if spec.tiers:
        _check_tier_layout(dag, spec)
    inner = lower_dag(dag, permute, ranks)
    if padded == count:
        return inner

    def body(x: Any) -> Any:
        # chunked families pad to a chunking multiple and trim, the
        # same rule allreduce_ring_schedule applies per segment
        y = torch.nn.functional.pad(x, (0, padded - count))
        return inner(y)[:, :count].contiguous()

    return body
