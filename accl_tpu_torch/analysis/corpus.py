"""Replay the lint corpus's program-level fixtures through the port.

Counterpart of tools/accl_lint.py's `lint_fixture` and its expectation
rule (`run_fixture_file`) for the fixture kinds that read given programs
(tools/lint_corpus/, the schema in tools/accl_lint.py's docstring):

  rank_programs  per-rank event lists: `protocol.simulate` with the
                 fixture's `blocking_sends`, then, deep, the interleaving
                 checker when the canonical run is clean
  slots          a hand-built slot timeline: `slots.check_slots`
  hopdag         a hop-DAG and its declared collective: the protocol
                 passes over the DAG's hops, then `semantics.certify`

"sequence" fixtures lint through `SequenceLinter` (the default tier);
"concurrent" fixtures wait for the interference certifier; any other
kind is a ValueError here.
"""

from __future__ import annotations

import pathlib

from ..constants import (
    TAG_ANY,
    CompressionFlags,
    DataType,
    Operation,
    ReduceFunction,
)
from ..descriptor import CallOptions
from . import hopdag, semantics
from .diagnostics import Diagnostic
from .linter import SequenceLinter
from .modelcheck import Budget
from .protocol import ANY_SRC, Event, simulate
from .slots import SlotInstance, SlotTimeline, check_slots

__all__ = ["CORPUS_DIR", "PROGRAM_KINDS", "fixture_ok", "lint_fixture",
           "step_from_dict"]

# the corpus of a checkout (tools/ beside the package)
CORPUS_DIR = pathlib.Path(__file__).resolve().parents[2] / "tools" / \
    "lint_corpus"
PROGRAM_KINDS = ("rank_programs", "slots", "hopdag")


def step_from_dict(d: dict) -> CallOptions:
    """A fixture's descriptor dict as CallOptions, by the corpus tool's
    field rules."""
    fn = d.get("function", 0)
    if isinstance(fn, str):
        fn = int(ReduceFunction[fn])
    dt = d.get("dtype", "float32")
    data_type = DataType[dt] if isinstance(dt, str) else DataType(dt)
    cp = d.get("compress")
    compress = (DataType[cp] if isinstance(cp, str) else DataType(cp)
                ) if cp is not None else DataType.none
    flags = (CompressionFlags.ETH_COMPRESSED
             if compress not in (DataType.none, data_type)
             else CompressionFlags.NO_COMPRESSION)
    return CallOptions(
        scenario=Operation[d["op"]],
        count=int(d.get("count", 0)),
        comm_addr=int(d.get("comm", 0)),
        root_src_dst=int(d.get("root", d.get("root_src_dst", 0))),
        function=int(fn),
        tag=int(d.get("tag", TAG_ANY)),
        addr_0=int(d.get("addr_0", 0)),
        addr_1=int(d.get("addr_1", 0)),
        addr_2=int(d.get("addr_2", 0)),
        data_type=data_type,
        compress_dtype=compress,
        compression_flags=flags,
        live_ranks=tuple(int(r) for r in d.get("live_ranks", ())),
    )


def _budget(fx: dict) -> Budget:
    if "budget_states" in fx:
        return Budget(max_states=int(fx["budget_states"]))
    return Budget()


def _programs(fx: dict) -> list[list[Event]]:
    def peer_of(e: dict) -> int:
        p = e.get("peer", -1)
        return ANY_SRC if p in ("any", "ANY") else int(p)

    return [[Event(e["kind"], peer_of(e), int(e.get("tag", TAG_ANY)),
                   int(e.get("count", 0)), int(e.get("comm", 0)),
                   e.get("op", ""))
             for e in prog]
            for prog in fx["programs"]]


def lint_fixture(fx: dict, deep: bool = False) -> list[Diagnostic]:
    """Run one program-level fixture through the port's passes. `deep`
    forces the interleaving tier even where the fixture does not opt in
    with "deep": true."""
    kind = fx.get("kind", "sequence")
    deep = deep or bool(fx.get("deep", False))
    if kind == "rank_programs":
        programs = _programs(fx)
        diags = simulate(programs,
                         blocking_sends=bool(fx.get("blocking_sends", True)))
        if deep and not diags:
            diags = SequenceLinter(
                int(fx.get("world", 4)),
                budget=_budget(fx)).check_interleavings(programs)
        return diags
    if kind == "slots":
        return check_slots(SlotTimeline(
            int(fx["num_slots"]),
            [SlotInstance(*map(int, i)) for i in fx["instances"]],
            {(int(a), int(b)) for a, b in fx.get("deps", [])}))
    if kind == "hopdag":
        dag = hopdag.from_json(fx["dag"])
        programs = hopdag.rank_programs(dag)
        diags = simulate(programs, blocking_sends=False)
        if deep and not diags:
            diags = SequenceLinter(
                dag.world, budget=_budget(fx)).check_interleavings(programs)
        coll = fx.get("collective")
        if coll is not None:
            opts = step_from_dict(coll)
            diags = list(diags) + semantics.certify(
                dag, semantics.collective_spec(opts, dag.world),
                opts.scenario.name)
        return diags
    raise ValueError(f"not a program-level fixture kind: {kind!r} (one "
                     f"of {PROGRAM_KINDS})")


def fixture_ok(fx: dict, diags: list[Diagnostic]) -> bool:
    """The corpus tool's expectation rule: "expect_semantic" codes
    exactly, the other passes then satisfying "expect"; else every
    "expect" code surfaces, and [] means clean."""
    got = [d.code for d in diags]
    expect = fx.get("expect", [])
    expect_sem = fx.get("expect_semantic")
    if expect_sem is not None:
        got5 = sorted({c for c in got if c.startswith("ACCL5")})
        rest = [c for c in got if not c.startswith("ACCL5")]
        rest_ok = (not [c for c in expect if c not in rest] if expect
                   else not rest)
        return got5 == sorted(set(expect_sem)) and rest_ok
    if expect:
        return all(c in got for c in expect)
    return not diags
