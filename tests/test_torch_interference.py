"""The port's cross-program interference certifier against the reference.

The cases of the reference's tests/test_interference.py, run on the
port's facade (virtual ranks on the CPU), in three layers:

  1. unit: each ACCL6xx verdict fires on its defect class and only
     there (summary tier exact for memory and streams, escalation tier
     refuting coarse tag overlaps or confirming them with the offending
     cross-program match pair);
  2. facade: footprints ride every compiled SequenceProgram, verdicts
     cache per signature pair, certificates stamp the admitted set and
     ride the dispatch spans;
  3. dynamics: a two-thread fuzz (10 seeds, 8 virtual ranks) against the
     serial-composition oracle; a rejected ACCL601 pair is provably
     order-dependent.

Then the lint corpus's "concurrent" fixtures give the reference tool's
diagnostics and escalation counts, but for one recorded departure: the
port's ring kernel holds no slots, so the two `use_pallas_ring` tenants
of bad_concurrent_slot_collision certify clean on the port (ACCL603 is
held on hand-built footprints that do carry ring slots). The reference's
native local-world leg runs on the port's native emulator
(device/emu_device.py), its static half at 2 and 8 ranks.
"""

import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from accl_tpu_torch import ACCL, ReduceFunction
from accl_tpu_torch.analysis import corpus
from accl_tpu_torch.analysis.interference import (
    DEFAULT_VERDICT_CACHE_CAP,
    InterferenceCertifier,
    ProgramFootprint,
    certificate_id,
    footprint_from_rank_programs,
    footprint_from_steps,
)
from accl_tpu_torch.analysis.protocol import coll, recv, send
from accl_tpu_torch.constants import TAG_ANY
from accl_tpu_torch.errors import LintError

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "lint_corpus"
CONCURRENT = sorted(
    p for p in CORPUS.glob("*.json")
    if json.loads(p.read_text()).get("kind") == "concurrent")

N_SEEDS = 10
COUNT = 64


def _mk_steps(accl, n, in_buf, out_buf, count=None):
    """One recorded allreduce in_buf -> out_buf as a compiled program."""
    seq = accl.sequence()
    seq.allreduce(in_buf, out_buf, count or n, ReduceFunction.SUM)
    return seq.compile()


def _ring(n_ranks, tag, count=4):
    """A clean tag-`tag` ring exchange as per-rank event programs."""
    return [[send((r + 1) % n_ranks, tag, count),
             recv((r - 1) % n_ranks, tag, count)] for r in range(n_ranks)]


def _steps_fp(accl, bufs_steps, label, **kw):
    """Footprint of a recorded (never compiled) descriptor batch."""
    seq = accl.sequence()
    for op, args in bufs_steps:
        getattr(seq, op)(*args)
    fp = footprint_from_steps(seq.calls, accl.cclo.world, label=label, **kw)
    seq._ran = True  # consume: this recorder never runs
    return fp


@pytest.fixture(scope="module")
def accl8():
    return ACCL(world=8, torch_device="cpu")


def _bufs(accl, k, n=64):
    return [accl.create_buffer(n) for _ in range(k)]


# ---------------------------------------------------------------------------
# unit: summary tier
# ---------------------------------------------------------------------------


def test_disjoint_pair_summary_clean(accl8):
    a_in, a_out, b_in, b_out = _bufs(accl8, 4)
    fa = _steps_fp(accl8, [("allreduce",
                            (a_in, a_out, 16, ReduceFunction.SUM))], "A")
    fb = _steps_fp(accl8, [("allreduce",
                            (b_in, b_out, 16, ReduceFunction.SUM))], "B")
    c = InterferenceCertifier()
    assert c.certify([fa, fb]) == []
    assert c.escalations == 0  # summaries alone decided the pair


def test_write_write_overlap_rejects_601(accl8):
    a_in, shared, b_in = _bufs(accl8, 3)
    fa = _steps_fp(accl8, [("allreduce",
                            (a_in, shared, 16, ReduceFunction.SUM))], "A")
    fb = _steps_fp(accl8, [("allreduce",
                            (b_in, shared, 16, ReduceFunction.SUM))], "B")
    c = InterferenceCertifier()
    diags = c.certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL601"]
    assert "write/write" in diags[0].message
    assert c.escalations == 0


def test_read_write_overlap_rejects_601(accl8):
    a_in, a_out, b_out = _bufs(accl8, 3)
    fa = _steps_fp(accl8, [("allreduce",
                            (a_in, a_out, 16, ReduceFunction.SUM))], "A")
    # B reads A's output buffer: write/read across the boundary
    fb = _steps_fp(accl8, [("allreduce",
                            (a_out, b_out, 16, ReduceFunction.SUM))], "B")
    diags = InterferenceCertifier().certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL601"]
    assert "write/read" in diags[0].message


def test_shared_stream_endpoint_rejects_601(accl8):
    from accl_tpu_torch.models.moe import MOE_EXPERT_STREAM

    bufs = _bufs(accl8, 4, 256)
    fa = _steps_fp(accl8, [("copy", (bufs[0], bufs[1], 16))], "A")
    fb = _steps_fp(accl8, [("copy", (bufs[2], bufs[3], 16))], "B")
    assert InterferenceCertifier().certify([fa, fb]) == []
    # the same two tenants, now both riding the expert stream
    sa, sb = accl8.sequence(), accl8.sequence()
    sa.copy(bufs[0], bufs[1], 16, res_stream=MOE_EXPERT_STREAM)
    sb.copy(bufs[2], bufs[3], 16, res_stream=MOE_EXPERT_STREAM)
    fa = footprint_from_steps(sa.calls, 8, label="A")
    fb = footprint_from_steps(sb.calls, 8, label="B")
    sa._ran = sb._ran = True
    diags = InterferenceCertifier().certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL601"]
    assert "stream endpoint" in diags[0].message


def test_ring_slot_collision_rejects_603(accl8):
    """The departure: two `use_pallas_ring` allreduce tenants share ring
    slot 0 in the reference (ACCL603); the port's ring kernel holds no
    slots, so their footprints carry none and the pair is clean.
    Footprints that do carry a shared slot still reject ACCL603."""
    import dataclasses

    a_in, a_out, b_in, b_out = _bufs(accl8, 4)

    def mk(i, o, label):
        return _steps_fp(accl8, [("allreduce",
                                  (i, o, 16, ReduceFunction.SUM))], label,
                         use_pallas_ring=True)

    fa, fb = mk(a_in, a_out, "A"), mk(b_in, b_out, "B")
    assert fa.ring_slots == fb.ring_slots == frozenset()
    assert InterferenceCertifier().certify([fa, fb]) == []
    sa = dataclasses.replace(fa, ring_slots=frozenset({0, 1}),
                             signature=fa.signature + "s")
    sb = dataclasses.replace(fb, ring_slots=frozenset({0}),
                             signature=fb.signature + "s")
    diags = InterferenceCertifier().certify([sa, sb])
    assert [d.code for d in diags] == ["ACCL603"]
    assert "slot(s) [0]" in diags[0].message


def test_unliftable_rejects_604_loudly():
    broken = footprint_from_steps([object()], 4, label="broken")
    assert broken.unliftable is not None
    good = footprint_from_rank_programs(_ring(4, 3), 4, label="good")
    diags = InterferenceCertifier().certify([good, broken])
    assert [d.code for d in diags] == ["ACCL604"]
    assert "UNVERIFIED" in diags[0].message


def test_world_mismatch_escalation_rejects_604():
    # a coarse tag overlap across different worlds: the product cannot
    # be composed, and that must reject, never silently pass
    fa = footprint_from_rank_programs(_ring(2, 5), 2, label="A")
    fb = footprint_from_rank_programs(_ring(4, 5), 4, label="B")
    diags = InterferenceCertifier().certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL604"]


# ---------------------------------------------------------------------------
# unit: escalation tier
# ---------------------------------------------------------------------------


def test_wildcard_steal_escalates_to_602_with_match_pair():
    fa = footprint_from_rank_programs(
        [[recv(1, TAG_ANY, 4)], [send(0, 3, 4)]], 2, label="A")
    fb = footprint_from_rank_programs(
        [[recv(1, 9, 4)], [send(0, 9, 4)]], 2, label="B")
    c = InterferenceCertifier()
    diags = c.certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL602"]
    assert c.escalations == 1
    assert "matchable by" in diags[0].message
    assert "tag ANY" in diags[0].message


def test_escalation_refutes_coarse_overlap():
    # A's wildcard recv makes the summaries overlap, but B's traffic
    # points away from it: the product model check refutes the pair,
    # with exactly one escalation paid
    fa = footprint_from_rank_programs(
        [[recv(1, TAG_ANY, 4)], [send(0, 3, 4)]], 2, label="A")
    fb = footprint_from_rank_programs(
        [[send(1, 9, 4)], [recv(0, 9, 4)]], 2, label="B")
    c = InterferenceCertifier()
    assert c.certify([fa, fb]) == []
    assert c.escalations == 1


def test_disjoint_exact_tags_stay_summary_only():
    fa = footprint_from_rank_programs(_ring(4, 3), 4, label="A")
    fb = footprint_from_rank_programs(_ring(4, 9), 4, label="B")
    c = InterferenceCertifier()
    assert c.certify([fa, fb]) == []
    assert c.escalations == 0


def test_shared_collective_signature_rejects_602():
    fa = footprint_from_rank_programs(
        [[coll("allreduce", 16, 0)] for _ in range(4)], 4, label="A")
    fb = footprint_from_rank_programs(
        [[coll("allreduce", 16, 0)] for _ in range(4)], 4, label="B")
    diags = InterferenceCertifier().certify([fa, fb])
    assert [d.code for d in diags] == ["ACCL602"]
    assert "coll" in diags[0].message


def test_verdict_cache_hits_by_signature_pair():
    fa = footprint_from_rank_programs(_ring(4, 3), 4, label="A")
    fb = footprint_from_rank_programs(_ring(4, 9), 4, label="B")
    c = InterferenceCertifier()
    c.certify([fa, fb])
    assert c.pairs_checked == 1
    c.certify([fb, fa])  # the same pair, either order: cache hits
    c.check_pair(fa, fb)
    assert c.pairs_checked == 1


def test_verdict_cache_lru_evicts_and_reverdicts():
    """A hit refreshes recency, storing past the cap evicts the least
    recently used pair, and a re-checked evicted pair recomputes to the
    identical verdict."""
    fa = footprint_from_rank_programs(_ring(4, 3), 4, label="A")
    fb = footprint_from_rank_programs(_ring(4, 9), 4, label="B")
    fc = footprint_from_rank_programs(_ring(4, 17), 4, label="C")
    c = InterferenceCertifier(cache_cap=2)
    vab = c.check_pair(fa, fb)
    c.check_pair(fa, fc)
    assert c.pairs_checked == 2 and c.cache_evictions == 0
    assert c.check_pair(fb, fa) is vab  # a hit, either order
    assert c.pairs_checked == 2
    c.check_pair(fb, fc)  # evicts (A, C), not (A, B)
    assert c.cache_evictions == 1
    assert c.check_pair(fa, fb) is vab
    assert c.pairs_checked == 3
    c.check_pair(fa, fc)  # evicted: recomputed...
    assert c.pairs_checked == 4 and c.cache_evictions == 2
    assert c.check_pair(fc, fa) == ()  # ...to the identical verdict
    assert len(c._cache) <= 2


def test_verdict_cache_cap_env_tunable(monkeypatch):
    assert InterferenceCertifier().cache_cap == DEFAULT_VERDICT_CACHE_CAP
    monkeypatch.setenv("ACCL_INTERFERENCE_CACHE_CAP", "7")
    assert InterferenceCertifier().cache_cap == 7
    monkeypatch.setenv("ACCL_INTERFERENCE_CACHE_CAP", "0")
    assert InterferenceCertifier().cache_cap == 1  # clamped: the live pair
    monkeypatch.setenv("ACCL_INTERFERENCE_CACHE_CAP", "bogus")
    assert InterferenceCertifier().cache_cap == DEFAULT_VERDICT_CACHE_CAP
    assert InterferenceCertifier(cache_cap=3).cache_cap == 3


def test_certificate_id_is_order_independent():
    fa = footprint_from_rank_programs(_ring(4, 3), 4, label="A")
    fb = footprint_from_rank_programs(_ring(4, 9), 4, label="B")
    assert certificate_id([fa, fb]) == certificate_id([fb, fa])
    assert certificate_id([fa, fb]) != certificate_id([fa, fa])


def test_footprints_match_the_reference(accl8, mesh8):
    """The same recorded batches give the reference's footprint fields
    (addresses aside, which each package's arena assigns) and the same
    pair verdicts."""
    from accl_tpu import ACCL as RefACCL
    from accl_tpu import ReduceFunction as RefF
    from accl_tpu.analysis import interference as ref

    def prog(accl, F, shared_out):
        a_in, a_out, b_in = (accl.create_buffer(64) for _ in range(3))
        fps = []
        for i, (src, dst) in enumerate(((a_in, a_out),
                                        (b_in, a_out if shared_out
                                         else b_in))):
            seq = accl.sequence()
            seq.allreduce(src, dst, 16, F.SUM).copy(src, dst, 8)
            fps.append(ref.footprint_from_steps(seq.calls, 8, label=str(i))
                       if F is RefF else
                       footprint_from_steps(seq.calls, 8, label=str(i)))
            seq._ran = True
        return fps

    refa = RefACCL(mesh8)
    for shared in (False, True):
        mine, theirs = prog(accl8, ReduceFunction, shared), \
            prog(refa, RefF, shared)
        for m, t in zip(mine, theirs):
            assert (m.world, m.comms, m.persistent, m.ring_slots,
                    m.streams, m.traffic, m.colls, m.synthetic_tags) == (
                t.world, t.comms, t.persistent, t.ring_slots, t.streams,
                t.traffic, t.colls, t.synthetic_tags)
            assert [n for _, n in m.reads] == [n for _, n in t.reads]
            assert [n for _, n in m.writes] == [n for _, n in t.writes]
        got = [(d.code, d.message.split("]")[0])
               for d in InterferenceCertifier().certify(mine)]
        want = [(d.code, d.message.split("]")[0])
                for d in ref.InterferenceCertifier().certify(theirs)]
        assert got == want


# ---------------------------------------------------------------------------
# facade: footprints, certificates, telemetry
# ---------------------------------------------------------------------------


def test_program_signature_exposed_without_tracing():
    from accl_tpu_torch import telemetry

    assert not telemetry.get_tracer().enabled
    accl = ACCL(world=8, torch_device="cpu")
    a, b = _bufs(accl, 2)
    prog = _mk_steps(accl, 16, a, b)
    assert prog.signature is not None
    assert isinstance(prog.footprint, ProgramFootprint)
    assert prog.footprint.signature is not None
    assert prog.certificate is None  # not yet admitted
    # the escalation thunk records the batch's hops on demand
    events = prog.footprint.events()
    assert len(events) == 8 and all(events)


def test_certify_concurrent_stamps_certificates():
    accl = ACCL(world=8, torch_device="cpu")
    a_in, a_out, b_in, b_out = _bufs(accl, 4)
    pa = _mk_steps(accl, 16, a_in, a_out)
    pb = _mk_steps(accl, 16, b_in, b_out)
    assert accl.certify_concurrent([pa, pb]) == []
    assert pa.certificate is not None
    assert pa.certificate == pb.certificate
    assert pa.certificate == certificate_id([pa.footprint, pb.footprint])
    assert accl._interference.escalations == 0


def test_certify_concurrent_rejects_overlap_and_leaves_unstamped():
    accl = ACCL(world=8, torch_device="cpu")
    a_in, shared, b_in = _bufs(accl, 3)
    pa = _mk_steps(accl, 16, a_in, shared)
    pb = _mk_steps(accl, 16, b_in, shared)
    with pytest.raises(LintError) as ei:
        accl.certify_concurrent([pa, pb])
    assert {d.code for d in ei.value.diagnostics} == {"ACCL601"}
    assert pa.certificate is None and pb.certificate is None
    diags = accl.certify_concurrent([pa, pb], mode="warn")
    assert {d.code for d in diags} == {"ACCL601"}


def test_dispatch_spans_carry_signature_and_certificate():
    from accl_tpu_torch import telemetry

    accl = ACCL(world=8, torch_device="cpu")
    a_in, a_out, b_in, b_out = _bufs(accl, 4)
    pa = _mk_steps(accl, 16, a_in, a_out)
    pb = _mk_steps(accl, 16, b_in, b_out)
    accl.certify_concurrent([pa, pb])
    tr = telemetry.get_tracer()
    tr.clear()
    tr.enable()
    try:
        pa.run()
        spans = tr.snapshot()
    finally:
        tr.clear()
        tr.disable()
    disp = next(s for s in spans
                if s["cat"] == "phase" and s["name"] == "dispatch")
    assert disp["args"]["signature"] == pa.signature
    assert disp["args"]["interference_cert"] == pa.certificate
    seq = next(s for s in spans if s["cat"] == "sequence")
    assert seq["args"]["signature"] == pa.signature
    assert seq["args"]["interference_cert"] == pa.certificate


def test_mixed_program_and_raw_footprint_inputs():
    accl = ACCL(world=8, torch_device="cpu")
    a_in, a_out = _bufs(accl, 2)
    pa = _mk_steps(accl, 16, a_in, a_out)
    remote = footprint_from_rank_programs(_ring(8, 3), 8, label="remote")
    assert accl.certify_concurrent([pa, remote]) == []
    assert pa.certificate is not None  # handles get stamped
    with pytest.raises(ValueError, match="no interference footprint"):
        accl.certify_concurrent([pa, object()])


# ---------------------------------------------------------------------------
# dynamics: the two-thread fuzz against the serial-composition oracle
# ---------------------------------------------------------------------------


def _write(buf, x):
    buf.host = torch.from_numpy(x.copy())


def test_two_thread_fuzz_matches_serial_oracle_mesh():
    """10 seeds: a summary-certified disjoint pair dispatched from two
    threads agrees bitwise with its serial composition, every seed."""
    accl = ACCL(world=8, torch_device="cpu")
    a_in, a_out, b_in, b_out = _bufs(accl, 4, COUNT)
    pa = _mk_steps(accl, COUNT, a_in, a_out)
    pb = _mk_steps(accl, COUNT, b_in, b_out)
    assert accl.certify_concurrent([pa, pb]) == []
    assert accl._interference.escalations == 0
    for seed in range(N_SEEDS):
        rng = np.random.default_rng(seed)
        xa = rng.standard_normal((8, COUNT)).astype(np.float32)
        xb = rng.standard_normal((8, COUNT)).astype(np.float32)
        _write(a_in, xa)
        _write(b_in, xb)
        pa.run()
        pb.run()
        oracle_a, oracle_b = a_out.host.clone(), b_out.host.clone()
        _write(a_in, xa)
        _write(b_in, xb)
        _write(a_out, np.zeros((8, COUNT), np.float32))
        _write(b_out, np.zeros((8, COUNT), np.float32))
        errs = []

        def drive(prog):
            try:
                prog.run()
            except Exception as e:  # pragma: no cover - diagnostic aid
                errs.append(e)

        ts = [threading.Thread(target=drive, args=(p,)) for p in (pa, pb)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        assert torch.equal(a_out.host, oracle_a)
        assert torch.equal(b_out.host, oracle_b)


def test_seeded_601_mutation_provably_diverges():
    """A pair the certifier rejects (ACCL601) is order-dependent: its
    two serial compositions disagree bitwise on the shared buffer."""
    accl = ACCL(world=8, torch_device="cpu")
    a_in, b_in, shared = _bufs(accl, 3, COUNT)
    pa = _mk_steps(accl, COUNT, a_in, shared)
    pb = _mk_steps(accl, COUNT, b_in, shared)
    with pytest.raises(LintError) as ei:
        accl.certify_concurrent([pa, pb])
    assert {d.code for d in ei.value.diagnostics} == {"ACCL601"}
    for seed in range(N_SEEDS):
        rng = np.random.default_rng(1000 + seed)
        xa = rng.standard_normal((8, COUNT)).astype(np.float32)
        xb = rng.standard_normal((8, COUNT)).astype(np.float32)
        _write(a_in, xa)
        _write(b_in, xb)
        pa.run()
        pb.run()
        ab = shared.host.clone()  # A;B leaves sum(xb)
        _write(a_in, xa)
        _write(b_in, xb)
        pb.run()
        pa.run()
        assert not torch.equal(ab, shared.host), seed  # B;A: sum(xa)


def test_two_thread_fuzz_matches_serial_oracle_local_world():
    """The reference's native-transport leg: two tag-disjoint ring
    exchanges certify clean from their summaries alone, at 2 and 8 ranks;
    then, on the port's native emulator (2 ranks, the in-process
    transport), the two exchanges driven from two threads a rank equal
    their serial composition bitwise, seed for seed."""
    from accl_tpu_torch.device.emu_device import EmuWorld

    for n in (2, 8):
        fa = footprint_from_rank_programs(_ring(n, 3, COUNT), n, label="A")
        fb = footprint_from_rank_programs(_ring(n, 9, COUNT), n, label="B")
        c = InterferenceCertifier()
        assert c.certify([fa, fb]) == []
        assert c.escalations == 0

    n = 2
    w = EmuWorld(n, transport="local")
    try:
        for seed in range(N_SEEDS):
            rng = np.random.default_rng(seed)
            xa = torch.from_numpy(
                rng.standard_normal((n, COUNT)).astype(np.float32))
            xb = torch.from_numpy(
                rng.standard_normal((n, COUNT)).astype(np.float32))

            def exchange(rank, i, x, tag):
                out = torch.zeros(COUNT)
                rank.send(x[i].clone(), COUNT, (i + 1) % n, tag=tag)
                rank.recv(out, COUNT, (i - 1) % n, tag=tag)
                return out

            def serial(rank, i):
                return exchange(rank, i, xa, 3), exchange(rank, i, xb, 9)

            def concurrent(rank, i):
                res = [None, None]

                def drive(slot, x, tag):
                    res[slot] = exchange(rank, i, x, tag)

                ts = [threading.Thread(target=drive, args=(0, xa, 3)),
                      threading.Thread(target=drive, args=(1, xb, 9))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(60)
                assert not any(t.is_alive() for t in ts)
                return tuple(res)

            oracle = w.run(serial, timeout_s=60)
            got = w.run(concurrent, timeout_s=60)
            for r in range(n):
                assert torch.equal(got[r][0], oracle[r][0]), (seed, r)
                assert torch.equal(got[r][1], oracle[r][1]), (seed, r)
    finally:
        w.close()


# ---------------------------------------------------------------------------
# the corpus's concurrent fixtures
# ---------------------------------------------------------------------------


def test_corpus_has_the_concurrent_fixtures():
    assert [p.stem for p in CONCURRENT] == [
        "bad_concurrent_slot_collision", "bad_concurrent_wildcard_steal",
        "bad_tenant_bulk_tramples_interactive",
        "good_concurrent_disjoint_tenants", "good_tenant_mixed_priority"]


@pytest.mark.parametrize("path", CONCURRENT, ids=lambda p: p.stem)
@pytest.mark.parametrize("deep", [False, True], ids=["default", "deep"])
def test_concurrent_fixture_matches_reference(path, deep):
    from tools.accl_lint import lint_fixture as ref_lint_fixture

    fx = json.loads(path.read_text())
    certifier = InterferenceCertifier(budget=corpus._budget(fx))
    got = corpus.lint_fixture(fx, deep=deep, certifier=certifier)
    if path.stem == "bad_concurrent_slot_collision":
        # the recorded departure: no slots on the port's ring kernel
        assert got == [] and certifier.escalations == 0
        assert [d.code for d in ref_lint_fixture(fx, deep=deep)] == \
            ["ACCL603"]
        return
    want = ref_lint_fixture(fx, deep=deep)
    assert [(d.code, d.message) for d in got] == [
        (d.code, d.message) for d in want]
    assert corpus.fixture_ok(fx, got)
    assert certifier.escalations == int(fx.get("expect_escalations", 0))
