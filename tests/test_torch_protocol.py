"""The port's protocol pass (analysis/protocol.py) against the JAX
package's, and the lint corpus's program-level fixtures through both.

The 27 fixtures of kinds rank_programs, slots and hopdag give the
reference's diagnostics (code, message, step, rank), by the corpus
tool's own runner on the reference side and analysis/corpus.py on the
port's, with the deep tier off and on. A seeded fuzz of small programs
(W <= 4, <= 6 events a rank: wildcard tags and sources, collectives,
count and communicator mismatches, peers out of range) gives the
reference's `simulate` diagnostics, MatchNotes and outcome under both
regimes; `check_hops`, `rank_programs_from_hops`,
`batch_programs_from_hops` and `rank_programs_from_options` agree on a
few hop lists and descriptor chains; the lifting entry points
(`trace_schedule_jaxpr` and the four that read its hops) give the
reference's hops and diagnostics (tests/test_torch_lift.py holds the
lift itself).
"""

import dataclasses
import json

import numpy as np
import pytest

import accl_tpu.constants as ref_c
import accl_tpu_torch.constants as port_c
from accl_tpu.analysis import protocol as ref
from accl_tpu.descriptor import CallOptions as RefOpts
from accl_tpu_torch.analysis import corpus, protocol
from accl_tpu_torch.descriptor import CallOptions

FIXTURES = sorted(
    p for p in corpus.CORPUS_DIR.glob("*.json")
    if json.loads(p.read_text()).get("kind", "sequence")
    in corpus.PROGRAM_KINDS)
ANY = port_c.TAG_ANY


def _diags(ds):
    return [(d.code, d.message, d.step, d.rank, d.severity) for d in ds]


def _events(progs):
    return [[dataclasses.astuple(e) for e in p] for p in progs]


def test_corpus_has_the_program_fixtures():
    kinds = [json.loads(p.read_text())["kind"] for p in FIXTURES]
    assert (kinds.count("rank_programs"), kinds.count("slots"),
            kinds.count("hopdag")) == (11, 2, 14)


@pytest.mark.parametrize("deep", [False, True], ids=["default", "deep"])
@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_fixture_diagnostics_match_reference(path, deep):
    from tools.accl_lint import lint_fixture as ref_lint_fixture

    fx = json.loads(path.read_text())
    got = corpus.lint_fixture(fx, deep=deep)
    assert _diags(got) == _diags(ref_lint_fixture(fx, deep=deep))
    assert corpus.fixture_ok(fx, got)


def _random_program_spec(rng):
    """Per-rank event tuples (kind, peer, tag, count, comm, op) at a
    random world of 1 to 4."""
    world = int(rng.integers(1, 5))
    progs = []
    for _ in range(world):
        prog = []
        for _ in range(int(rng.integers(0, 7))):
            kind = str(rng.choice(["send", "recv", "coll"],
                                  p=[0.45, 0.45, 0.1]))
            peer = int(rng.integers(world))
            if rng.random() < 0.05:
                peer = world  # out of range: ACCL402
            if kind == "recv" and rng.random() < 0.2:
                peer = protocol.ANY_SRC
            tag = int(rng.choice([1, 2, ANY], p=[0.4, 0.3, 0.3]))
            count = int(rng.choice([4, 4, 4, 8]))
            comm = int(rng.random() < 0.08)
            if kind == "coll":
                prog.append(("coll", -1, ANY, count, comm,
                             str(rng.choice(["allreduce", "bcast"]))))
            else:
                prog.append((kind, peer, tag, count, comm, ""))
        progs.append(prog)
    return progs


@pytest.mark.parametrize("seed", range(40))
def test_simulate_fuzz_matches_reference(seed):
    spec = _random_program_spec(np.random.default_rng(9100 + seed))
    mine = [[protocol.Event(*e) for e in p] for p in spec]
    theirs = [[ref.Event(*e) for e in p] for p in spec]
    for blocking in (True, False):
        notes, ref_notes, outcome, ref_outcome = [], [], [], []
        got = protocol.simulate(mine, blocking_sends=blocking, notes=notes,
                                outcome=outcome)
        want = ref.simulate(theirs, blocking_sends=blocking,
                            notes=ref_notes, outcome=ref_outcome)
        assert _diags(got) == _diags(want), (seed, blocking, spec)
        assert [dataclasses.astuple(n) for n in notes] == \
            [dataclasses.astuple(n) for n in ref_notes]
        assert outcome == ref_outcome


HOPS = [
    [((0, 1), (1, 2), (2, 3), (3, 0))],
    [((0, 2), (2, 0)), ((1, 3), (3, 1)), ((0, 1), (1, 0), (2, 3), (3, 2))],
    [((0, 1), (0, 2))],  # rank 0 sends twice
    [((0, 3), (1, 3))],  # rank 3 receives twice
    [((0, 4), (5, 1))],  # outside world 4
    [],
]


@pytest.mark.parametrize("hops", HOPS, ids=range(len(HOPS)))
def test_hop_programs_match_reference(hops):
    assert _diags(protocol.check_hops(hops, 4, step=2)) == \
        _diags(ref.check_hops(hops, 4, step=2))
    assert _events(protocol.rank_programs_from_hops(hops, 4, tag_base=7)) \
        == _events(ref.rank_programs_from_hops(hops, 4, tag_base=7))
    steps = [hops, HOPS[1], hops]
    assert _events(protocol.batch_programs_from_hops(steps, 4)) == \
        _events(ref.batch_programs_from_hops(steps, 4))
    assert protocol._STEP_TAG_STRIDE == ref._STEP_TAG_STRIDE


def _chains(c, cls):
    """Per-rank descriptor chains at world 3: a send/recv ring with a
    tag, a collective on another communicator, and local ops that the
    program model elides."""
    O = c.Operation

    def opt(op, count=16, root=0, tag=c.TAG_ANY, comm=0):
        return cls(scenario=op, count=count, root_src_dst=root, tag=tag,
                   comm_addr=comm, function=0, data_type=c.DataType.float32)

    return [
        [opt(O.send, root=0 | (1 << 16), tag=5), opt(O.copy),
         opt(O.recv, root=2, tag=5), opt(O.allreduce, comm=0x40)],
        [opt(O.recv, root=0, tag=5), opt(O.combine),
         opt(O.send, root=1 | (2 << 16), tag=5, count=8),
         opt(O.allreduce, comm=0x40)],
        [opt(O.recv, root=1, tag=5, count=8), opt(O.nop),
         opt(O.send, root=2 | (0 << 16), tag=5),
         opt(O.bcast, count=4, root=1)],
    ]


def test_rank_programs_from_options_matches_reference():
    mine = protocol.rank_programs_from_options(_chains(port_c, CallOptions))
    theirs = ref.rank_programs_from_options(_chains(ref_c, RefOpts))
    assert _events(mine) == _events(theirs)
    assert _diags(protocol.simulate(mine)) == _diags(ref.simulate(theirs))


@pytest.mark.parametrize("name", ["trace_schedule_jaxpr",
                                  "trace_schedule_hops",
                                  "iter_ppermute_eqns",
                                  "batch_rank_programs",
                                  "interpret_schedule"])
def test_lifting_entry_points_raise(name):
    """The lifting entry points run now (they raised until the lifting
    slice): each gives the reference's result on a two-step batch, a
    segmented ring allreduce and a tree reduce at W 5."""
    calls = [corpus.family_call(port_c.Operation.allreduce, 600, 5),
             corpus.family_call(port_c.Operation.reduce, 16, 5, root=3,
                                trees=True)]
    ref_calls = []
    for (o, plan) in calls:
        ro = RefOpts(scenario=ref_c.Operation(int(o.scenario)),
                     count=o.count, root_src_dst=o.root_src_dst,
                     function=o.function, data_type=ref_c.DataType.float32)
        from accl_tpu.sequencer.plan import select_algorithm

        tun = (ref_c.TuningParams(**corpus._TREES) if o.scenario ==
               port_c.Operation.reduce else
               ref_c.TuningParams.default(ref_c.DEFAULT_MAX_RENDEZVOUS_SIZE))
        rp = select_algorithm(
            ro.scenario, ro.count, 4, 5, ro.compression_flags,
            max_eager_size=ref_c.DEFAULT_MAX_EAGER_SIZE,
            eager_rx_buf_size=ref_c.DEFAULT_EAGER_RX_BUF_SIZE, tuning=tun)
        assert rp.algorithm.name == plan.algorithm.name
        ref_calls.append((ro, rp))
    fn, ref_fn = getattr(protocol, name), getattr(ref, name)
    if name == "batch_rank_programs":
        got = fn([c[0] for c in calls], [c[1] for c in calls], 5)
        want = ref_fn([c[0] for c in ref_calls], [c[1] for c in ref_calls],
                      5)
        assert _events(got) == _events(want)
        return
    for (o, plan), (ro, rp) in zip(calls, ref_calls):
        if name == "interpret_schedule":
            assert _diags(fn(o, plan, 5)) == _diags(ref_fn(ro, rp, 5)) == []
        elif name == "trace_schedule_hops":
            assert fn(o, plan, 5) == ref_fn(ro, rp, 5)
        else:
            trace, n_in, elems = protocol.trace_schedule_jaxpr(o, plan, 5)
            closed, r_in, r_elems = ref.trace_schedule_jaxpr(ro, rp, 5)
            assert (n_in, elems) == (r_in, r_elems)
            if name == "iter_ppermute_eqns":
                assert [tuple(e.params["perm"]) for e in fn(trace)] == [
                    tuple(tuple(p) for p in e.params["perm"])
                    for e in ref_fn(closed)]
            else:
                assert trace.dag.world == 5 and trace.dag.n_in == n_in
