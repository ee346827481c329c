"""The port's interleaving model checker (analysis/modelcheck.py)
against the JAX package's.

The reference's tests/test_modelcheck.py cases that need neither a
lifted schedule, the facade's deep tier nor the native emulator, run on
the port, each also held field for field against the reference's
CheckResult (canonical_complete, complete_reachable, stuck_trace,
stuck_state, races, truncated, states) and diagnostics; the reduced
search agrees with brute force and with the reference on seeded random
programs; a budget cut by max_states reports ACCL207. Every budget has
a wall clock far beyond what a run takes, so no verdict depends on it.
"""

import dataclasses

import numpy as np
import pytest

from accl_tpu.analysis import modelcheck as ref_mc
from accl_tpu.analysis import protocol as ref_proto
from accl_tpu_torch.analysis import modelcheck as mc
from accl_tpu_torch.analysis import protocol as proto
from accl_tpu_torch.analysis.linter import SequenceLinter
from accl_tpu_torch.constants import TAG_ANY

ANY = TAG_ANY
ANY_SRC = proto.ANY_SRC
SEMANTICS = ("buffered", "rendezvous")


def _budget(pkg, states=20_000):
    return pkg.Budget(max_states=states, max_seconds=1e6)


def _build(spec, pkg):
    """spec: per-rank lists of ("send"|"recv", peer, tag, count) or
    ("coll", op, count) tuples, as events of `pkg`'s protocol."""
    out = []
    for prog in spec:
        evs = []
        for e in prog:
            if e[0] == "coll":
                evs.append(pkg.coll(e[1], e[2]))
            else:
                make = pkg.send if e[0] == "send" else pkg.recv
                evs.append(make(e[1], tag=e[2], count=e[3]))
        out.append(evs)
    return out


def _result(res):
    return (res.semantics, res.canonical_complete, res.complete_reachable,
            res.stuck_trace, res.stuck_state,
            [dataclasses.astuple(r) for r in res.races], res.truncated,
            res.states)


def _diags(ds):
    return [(d.code, d.message, d.step, d.rank, d.severity) for d in ds]


def _check(spec, sem, states=20_000, reduce=True):
    """The port's CheckResult, held against the reference's."""
    got = mc.check_interleavings(_build(spec, proto), semantics=sem,
                                 budget=_budget(mc, states), reduce=reduce)
    want = ref_mc.check_interleavings(_build(spec, ref_proto), semantics=sem,
                                      budget=_budget(ref_mc, states),
                                      reduce=reduce)
    assert _result(got) == _result(want)
    return got


def _diagnose(spec, states=20_000):
    got = mc.diagnose_programs(_build(spec, proto),
                               budget=_budget(mc, states))
    want = ref_mc.diagnose_programs(_build(spec, ref_proto),
                                    budget=_budget(ref_mc, states))
    assert _diags(got) == _diags(want)
    return got


DEADLOCK = [[("recv", 1, ANY, 8), ("recv", 1, 2, 8)],
            [("send", 0, 1, 8), ("send", 0, 2, 8)]]


def test_schedule_dependent_deadlock_found_with_witness():
    progs = _build(DEADLOCK, proto)
    assert proto.simulate(progs, blocking_sends=False) == []
    assert mc.canonical_completes(progs, blocking_sends=False)
    res = _check(DEADLOCK, "buffered")
    assert res.canonical_complete and res.complete_reachable
    assert res.stuck_trace is not None
    diags = _diagnose(DEADLOCK)
    assert [d.code for d in diags] == ["ACCL206"]
    msg = diags[0].message
    assert "canonical schedule completes" in msg
    assert "tag ANY) matched r1:send(tag 2" in msg
    assert "stuck state" in msg and "r0:recv#1" in msg


def test_wildcard_race_found_only_across_completing_runs():
    race = [[("recv", 1, ANY, 8), ("recv", 1, ANY, 8)],
            [("send", 0, 1, 8), ("send", 0, 2, 8)]]
    assert [d.code for d in _diagnose(race)] == ["ACCL205", "ACCL205"]
    assert [d.code for d in _diagnose(DEADLOCK)] == ["ACCL206"]


def test_source_pinned_wildcard_fanin_is_clean_and_skips_exploration():
    fanin = [[("recv", 1, ANY, 8), ("recv", 2, ANY, 8), ("recv", 3, ANY, 8)],
             [("send", 0, 7, 8)], [("send", 0, 7, 8)], [("send", 0, 7, 8)]]
    assert _diagnose(fanin) == []
    assert mc.statically_deterministic(_build(fanin, proto))
    assert not mc.statically_deterministic(_build(DEADLOCK, proto))
    # the linter's deep check routes the pinned batch past exploration
    assert SequenceLinter(4).check_interleavings(_build(fanin, proto)) == []
    assert [d.code for d in SequenceLinter(2, budget=_budget(mc))
            .check_interleavings(_build(DEADLOCK, proto))] == ["ACCL206"]


def test_any_source_recv_explores_every_sender():
    progs = [[("recv", ANY_SRC, 5, 4), ("recv", 1, 5, 4)],
             [("send", 0, 5, 4)], [("send", 0, 5, 4)]]
    res = _check(progs, "buffered")
    assert res.stuck_trace is not None
    assert not res.canonical_complete
    assert "ACCL206" not in [d.code for d in _diagnose(progs)]


def test_rendezvous_any_source_contention():
    progs = [[("recv", ANY_SRC, ANY, 4), ("recv", 2, ANY, 4)],
             [("send", 0, 1, 4)], [("send", 0, 2, 4)]]
    res = _check(progs, "rendezvous")
    assert res.canonical_complete
    assert res.stuck_trace is not None
    assert "ACCL206" in [d.code for d in _diagnose(progs)]


def test_collectives_and_barriers_modelchecked():
    good = [[("coll", "allreduce", 16)], [("coll", "allreduce", 16)]]
    res = _check(good, "buffered")
    assert res.complete_reachable and res.stuck_trace is None
    bad = [[("coll", "allreduce", 16)], []]
    res = _check(bad, "buffered")
    assert res.stuck_trace is not None and not res.canonical_complete


def test_budget_truncation_is_loud_never_silent():
    progs = [[("recv", 1, ANY, 1)] * 4,
             [("send", 0, t, 1) for t in range(4)]]
    assert _check(progs, "buffered", states=3).truncated
    # under rendezvous the exact-source heads pair with no branch at all
    assert not _check(progs, "rendezvous", states=3).truncated
    diags = _diagnose(progs, states=3)
    truncated = [d for d in diags if d.code == "ACCL207"]
    assert truncated and all(d.severity == "warning" for d in truncated)
    assert "UNVERIFIED" in truncated[0].message
    with pytest.raises(ValueError, match="semantics"):
        mc.check_interleavings(_build(progs, proto), semantics="eager")


def _random_spec(rng):
    """The reference's fuzz generator: <= 3 ranks, <= 6 events, small
    tag alphabets with TAG_ANY, occasional ANY_SRC and collectives."""
    world = int(rng.integers(2, 4))
    progs = [[] for _ in range(world)]
    for _ in range(int(rng.integers(2, 7))):
        r = int(rng.integers(world))
        kind = rng.choice(["send", "recv", "recv", "coll"],
                          p=[0.45, 0.225, 0.225, 0.1])
        tag = int(rng.choice([1, 2, ANY], p=[0.4, 0.3, 0.3]))
        peer = int(rng.integers(world))
        if kind == "send":
            progs[r].append(("send", peer, tag, 4))
        elif kind == "recv":
            if rng.random() < 0.2:
                peer = ANY_SRC
            progs[r].append(("recv", peer, tag, 4))
        else:
            progs[r].append(("coll", "allreduce", 4))
    return progs


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_reduced_agrees_with_brute_force(seed):
    spec = _random_spec(np.random.default_rng(4200 + seed))
    for sem in SEMANTICS:
        fast = _check(spec, sem, reduce=True)
        slow = _check(spec, sem, reduce=False)
        ctx = f"seed {seed} {sem} {spec}"
        assert not fast.truncated and not slow.truncated, ctx
        assert fast.complete_reachable == slow.complete_reachable, ctx
        assert (fast.stuck_trace is None) == (slow.stuck_trace is None), ctx
        assert fast.races == slow.races, ctx
        assert fast.states <= slow.states, ctx
        # the canonical schedule is one of the explored ones
        if fast.canonical_complete:
            assert fast.complete_reachable, ctx
        else:
            assert fast.stuck_trace is not None, ctx
    _diagnose(spec)
