"""Replay the lint corpus through the port.

Counterpart of tools/accl_lint.py's `lint_fixture`, its expectation rule
(`run_fixture_file`) and its strict schedules sweep (`--semantic
--schedules`), over the fixture kinds of tools/lint_corpus/ (the schema
in tools/accl_lint.py's docstring):

  sequence       a descriptor batch: `SequenceLinter` with the default
                 plans (`default_plan`), so the semantic pass runs; deep,
                 the interleaving tier too
  rank_programs  per-rank event lists: `protocol.simulate` with the
                 fixture's `blocking_sends`, then, deep, the interleaving
                 checker when the canonical run is clean
  slots          a hand-built slot timeline: `slots.check_slots`
  hopdag         a hop-DAG and its declared collective: the protocol
                 passes over the DAG's hops, then `semantics.certify`
  concurrent     tenants (sequences or rank programs), each linted alone
                 first, then `InterferenceCertifier` over their
                 footprints, with the fixture's expected escalation count

`schedules_sweep` certifies every call of the reference's family grid
(`FAMILY_GRID`) strictly: a call the lifter cannot analyze fails it.
"""

from __future__ import annotations

import pathlib

from ..constants import (
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_MAX_EAGER_SIZE,
    DEFAULT_MAX_RENDEZVOUS_SIZE,
    TAG_ANY,
    CompressionFlags,
    DataType,
    Operation,
    ReduceFunction,
    TuningParams,
    dtype_nbytes,
)
from ..descriptor import CallOptions, SequenceDescriptor
from . import hopdag, semantics
from .diagnostics import Diagnostic
from .linter import SequenceLinter
from .modelcheck import Budget
from .protocol import ANY_SRC, Event, simulate
from .slots import SlotInstance, SlotTimeline, check_slots

__all__ = ["CORPUS_DIR", "FAMILY_GRID", "PROGRAM_KINDS", "default_plan",
           "family_call", "fixture_ok", "lint_fixture", "port_expect",
           "schedules_sweep", "step_from_dict"]

# the corpus of a checkout (tools/ beside the package)
CORPUS_DIR = pathlib.Path(__file__).resolve().parents[2] / "tools" / \
    "lint_corpus"
PROGRAM_KINDS = ("rank_programs", "slots", "hopdag")

# the tuning that forces the binary-tree and capped-fan-in branches
_TREES = dict(
    gather_flat_tree_max_fanin=2,
    gather_flat_tree_max_count=64,
    bcast_flat_tree_max_ranks=2,
    reduce_flat_tree_max_ranks=2,
    reduce_flat_tree_max_count=64,
    allreduce_composition_max_count=1 << 30,
)

# The reference's family grid of shipping schedules (its
# tests/test_semantics.py): (scenario, count, world, options), each
# option one of root, func, wire, trees (the tree tuning), peer_counts.
FAMILY_GRID = (
    (Operation.bcast, 12, 4, {}),
    (Operation.bcast, 12, 5, {"root": 3}),
    (Operation.bcast, 8, 4, {"trees": True}),
    (Operation.scatter, 6, 4, {"root": 2}),
    (Operation.gather, 6, 4, {"root": 1}),
    (Operation.gather, 6, 5, {"trees": True}),
    (Operation.reduce, 16, 4, {"root": 2}),
    (Operation.reduce, 16, 4, {"root": 1, "func": ReduceFunction.MAX}),
    (Operation.reduce, 16, 6, {"trees": True}),
    (Operation.allgather, 8, 4, {}),
    (Operation.allreduce, 16, 4, {}),
    (Operation.allreduce, 16, 3, {"func": ReduceFunction.MAX}),
    (Operation.allreduce, 600, 4, {}),
    (Operation.allreduce, 16, 4, {"trees": True}),
    (Operation.reduce_scatter, 8, 4, {}),
    (Operation.alltoall, 6, 4, {}),
    (Operation.alltoall, 6, 4, {"wire": DataType.int8}),
    (Operation.alltoall, 256, 4, {"wire": DataType.int8}),
    (Operation.alltoall, 10, 4, {"peer_counts": (10, 3, 7, 1)}),
    (Operation.alltoall, 300, 4, {"peer_counts": (128, 300, 9, 64),
                                  "wire": DataType.int8}),
    (Operation.send, 16, 4, {"root": 1 | (3 << 16)}),
    (Operation.allreduce, 300, 4, {"wire": DataType.int8}),
    (Operation.reduce_scatter, 16, 4, {"wire": DataType.int8}),
    (Operation.allgather, 16, 4, {"wire": DataType.int8}),
    (Operation.allreduce, 32, 4, {"wire": DataType.float16}),
    (Operation.allgather, 8, 4, {"wire": DataType.bfloat16}),
)


def family_call(scen: Operation, count: int, world: int, *, root: int = 0,
                func: ReduceFunction = ReduceFunction.SUM,
                wire: DataType = DataType.none, trees: bool = False,
                peer_counts=()):
    """One float32 call and its plan under the default registers (or the
    tree tuning), the reference test grid's `_opts_plan`."""
    from ..sequencer.plan import select_algorithm

    comp = (CompressionFlags.ETH_COMPRESSED if wire != DataType.none
            else CompressionFlags.NO_COMPRESSION)
    opts = CallOptions(scenario=scen, count=count, root_src_dst=root,
                       function=int(func), data_type=DataType.float32,
                       compress_dtype=wire, compression_flags=comp,
                       peer_counts=tuple(peer_counts))
    tuning = (TuningParams(**_TREES) if trees
              else TuningParams.default(DEFAULT_MAX_RENDEZVOUS_SIZE))
    plan = select_algorithm(
        scen, count, 4, world, comp, max_eager_size=DEFAULT_MAX_EAGER_SIZE,
        eager_rx_buf_size=DEFAULT_EAGER_RX_BUF_SIZE, tuning=tuning,
        compress_dtype=wire, peer_counts=tuple(peer_counts))
    return opts, plan


def schedules_sweep(grid=FAMILY_GRID) -> list[tuple]:
    """Certify every call of `grid` strictly (no in-band budget; an
    unliftable call raises UnsupportedSchedule): returns
    [(scenario, count, world, options, diagnostics)]."""
    out = []
    for scen, count, world, kw in grid:
        opts, plan = family_call(scen, count, world, **kw)
        diags = semantics.check_batch_semantics([opts], [plan], world,
                                                strict=True)
        out.append((scen, count, world, kw, diags))
    return out


def default_plan(opts: CallOptions, world: int):
    """The plan the corpus tool gives a fixture step: select_algorithm
    under the default registers."""
    from ..sequencer.plan import select_algorithm

    return select_algorithm(
        opts.scenario, opts.count, dtype_nbytes(opts.data_type), world,
        opts.compression_flags, opts.stream_flags,
        max_eager_size=DEFAULT_MAX_EAGER_SIZE,
        eager_rx_buf_size=DEFAULT_EAGER_RX_BUF_SIZE,
        tuning=TuningParams.default(DEFAULT_MAX_RENDEZVOUS_SIZE),
        compress_dtype=opts.compress_dtype,
        live_ranks=opts.live_ranks,
    )


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


def _tenant_footprint(t: dict, i: int, default_world: int):
    """One "concurrent" tenant's footprint, through the extractors the
    device attaches at prepare time."""
    from .interference import (
        footprint_from_rank_programs,
        footprint_from_steps,
    )

    kind = t.get("kind", "sequence")
    world = int(t.get("world", default_world))
    label = t.get("title", f"tenant{i}")
    if kind == "sequence":
        steps = [step_from_dict(d) for d in t["steps"]]
        return footprint_from_steps(
            steps, world,
            persistent=frozenset(int(a) for a in t.get("persistent", ())),
            use_pallas_ring=bool(t.get("use_pallas_ring", False)),
            pallas_ring_overlap=bool(t.get("overlap", True)),
            plans=tuple(default_plan(o, world) for o in steps), label=label)
    if kind == "rank_programs":
        return footprint_from_rank_programs(_programs(t), world, label=label)
    raise ValueError(f"unknown tenant kind {kind!r}")


def lint_fixture(fx: dict, deep: bool = False,
                 certifier=None) -> list[Diagnostic]:
    """Run one fixture through the port's passes. `deep` forces the
    interleaving tier even where the fixture does not opt in with "deep":
    true. A "concurrent" fixture runs through `certifier` (a fresh
    InterferenceCertifier with the fixture's budget by default) and
    raises AssertionError when its escalation count differs from the
    fixture's "expect_escalations"."""
    kind = fx.get("kind", "sequence")
    world = int(fx.get("world", 4))
    deep = deep or bool(fx.get("deep", False))
    if kind == "sequence":
        if "words" in fx:
            steps = list(SequenceDescriptor.from_words(
                list(fx["words"])).steps)
        else:
            steps = [step_from_dict(d) for d in fx["steps"]]
        widths = None
        if "buffer_widths" in fx:
            widths = {int(k, 0) if isinstance(k, str) else int(k): int(v)
                      for k, v in fx["buffer_widths"].items()}
        linter = SequenceLinter(world, deep=deep, budget=_budget(fx))
        plans = [default_plan(o, world) for o in steps]
        return linter.lint(steps, plans, buffer_widths=widths)
    if kind == "concurrent":
        from .interference import InterferenceCertifier

        # every tenant must certify alone first: a tenant failing its own
        # passes is a broken fixture, not an interference finding
        solo: list[Diagnostic] = []
        for t in fx["tenants"]:
            solo += lint_fixture({"world": world, **t}, deep=deep)
        if solo:
            return solo
        if certifier is None:
            certifier = InterferenceCertifier(budget=_budget(fx))
        before = certifier.escalations
        diags = certifier.certify([_tenant_footprint(t, i, world)
                                   for i, t in enumerate(fx["tenants"])])
        want = fx.get("expect_escalations")
        took = certifier.escalations - before
        if want is not None and took != int(want):
            raise AssertionError(
                f"expected {want} product-modelcheck escalations, the "
                f"certifier took {took}")
        return diags
    if kind == "rank_programs":
        programs = _programs(fx)
        diags = simulate(programs,
                         blocking_sends=bool(fx.get("blocking_sends", True)))
        if deep and not diags:
            diags = SequenceLinter(
                world, budget=_budget(fx)).check_interleavings(programs)
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
    raise ValueError(f"unknown fixture kind {kind!r}")


def port_expect(fx: dict) -> list[str]:
    """A fixture's "expect" codes on the port. ACCL603 is a collision on
    the reference's Pallas ring slots, and the port's ring kernel holds
    none (slots.py): a "concurrent" fixture whose tenants run on that
    ring (`use_pallas_ring`) expects no ACCL603 of the port."""
    expect = list(fx.get("expect", []))
    if fx.get("kind") == "concurrent" and any(
            t.get("use_pallas_ring") for t in fx["tenants"]):
        expect = [c for c in expect if c != "ACCL603"]
    return expect


def fixture_ok(fx: dict, diags: list[Diagnostic]) -> bool:
    """The corpus tool's expectation rule over `port_expect`:
    "expect_semantic" codes exactly, the other passes then satisfying
    "expect"; a "concurrent" fixture's codes exactly (set equality);
    else every expected code surfaces, and [] means clean."""
    got = [d.code for d in diags]
    expect = port_expect(fx)
    expect_sem = fx.get("expect_semantic")
    if expect_sem is not None:
        got5 = sorted({c for c in got if c.startswith("ACCL5")})
        rest = [c for c in got if not c.startswith("ACCL5")]
        rest_ok = (not [c for c in expect if c not in rest] if expect
                   else not rest)
        return got5 == sorted(set(expect_sem)) and rest_ok
    if fx.get("kind") == "concurrent":
        return set(got) == set(expect)
    if expect:
        return all(c in got for c in expect)
    return not diags
