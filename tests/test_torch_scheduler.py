"""The port's multi-tenant scheduler (accl_tpu_torch/scheduler/) against the
JAX package's, function for function of tests/test_scheduler.py.

The pure control-plane cases (registry, fair-queue math, priority,
backpressure, the concurrency rule, accounting) drive the port's
scheduler with the reference tests' fake programs; where they give a
dispatch order or a report, the reference's scheduler is driven the same
way and must give the same one. The facade cases run real prepared
sequences on the port's CPU facade, and the DecodeServer seam holds the
scheduled server's tokens bitwise to the server without a scheduler at a
small width. One stress case drains many fake programs through more
worker threads than cores with a short switch interval.
"""

import dataclasses
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from accl_tpu import scheduler as ref_sched
from accl_tpu.analysis import interference as ref_interference
from accl_tpu.analysis import protocol as ref_protocol
from accl_tpu_torch import ACCL, ReduceFunction
from accl_tpu_torch.analysis.interference import (
    certificate_id,
    footprint_from_rank_programs,
)
from accl_tpu_torch.analysis.protocol import recv, send
from accl_tpu_torch.constants import TAG_ANY
from accl_tpu_torch.scheduler import (
    DuplicateTenantError,
    FairQueue,
    MultiTenantScheduler,
    QueueEntry,
    SchedulerSaturatedError,
    UnknownTenantError,
)
from accl_tpu_torch.telemetry.metrics import MetricsRegistry

JOIN_S = 10  # the bound on every thread join


def _ring(n_ranks, tag, count=4, proto=None):
    s, r = (send, recv) if proto is None else (proto.send, proto.recv)
    return [[s((k + 1) % n_ranks, tag, count), r((k - 1) % n_ranks, tag,
                                                 count)]
            for k in range(n_ranks)]


def _fake_accl():
    """The facade surface the scheduler touches: the shared certifier
    slot and the (absent) device pricing seam."""
    return types.SimpleNamespace(_interference=None, cclo=None)


class _FakeProgram:
    """A dispatchable handle: .run, .footprint/.signature and a _prepared
    with the certificate slot, all the scheduler reads off a real
    SequenceProgram."""

    def __init__(self, fp=None, run_fn=None):
        self.footprint = fp
        self.signature = fp.signature if fp is not None else None
        self._prepared = types.SimpleNamespace(
            cert=None, desc=types.SimpleNamespace(steps=[]))
        self._run_fn = run_fn

    @property
    def certificate(self):
        return self._prepared.cert

    def run(self, **kwargs):
        if self._run_fn is not None:
            self._run_fn(**kwargs)


class _Clock:
    """A deterministic time_fn, advanced inside run()."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _sched(**kw):
    kw.setdefault("registry", MetricsRegistry())
    return MultiTenantScheduler(_fake_accl(), **kw)


def _ref_sched(**kw):
    from accl_tpu.telemetry.metrics import MetricsRegistry as RefRegistry

    kw.setdefault("registry", RefRegistry())
    return ref_sched.MultiTenantScheduler(_fake_accl(), **kw)


# ---------------------------------------------------------------------------
# tenant registry
# ---------------------------------------------------------------------------


def test_registry_register_duplicate_unknown():
    s = _sched()
    t = s.register_tenant("alpha", priority=0, weight=4.0,
                          slo_budget_s=0.5)
    assert t.priority == 0 and t.weight == 4.0 and t.slo_budget_s == 0.5
    assert "alpha" in s.tenants and len(s.tenants) == 1
    with pytest.raises(DuplicateTenantError) as dup:
        s.register_tenant("alpha")
    with pytest.raises(UnknownTenantError) as ei:
        s.tenants.get("ghost")
    assert "ghost" in str(ei.value)
    with pytest.raises(UnknownTenantError):
        s.submit("ghost", _FakeProgram(), cost_s=1.0)
    r = _ref_sched()
    r.register_tenant("alpha")
    with pytest.raises(ref_sched.DuplicateTenantError) as rdup:
        r.register_tenant("alpha")
    with pytest.raises(ref_sched.UnknownTenantError) as rei:
        r.tenants.get("ghost")
    assert (str(dup.value), str(ei.value)) == (str(rdup.value),
                                               str(rei.value))
    assert dataclasses.asdict(t).keys() == dataclasses.asdict(
        r.tenants.get("alpha")).keys()


@pytest.mark.parametrize("kw", [dict(priority=-1), dict(weight=0.0),
                                dict(weight=-2.0),
                                dict(slo_budget_s=0.0)])
def test_registry_rejects_nonsense_qos(kw):
    with pytest.raises(ValueError) as got:
        _sched().register_tenant("t", **kw)
    with pytest.raises(ValueError) as want:
        _ref_sched().register_tenant("t", **kw)
    assert str(got.value) == str(want.value)


def test_registry_rejects_non_string_names():
    s = _sched()
    for bad in ("", None, 7):
        with pytest.raises(ValueError):
            s.register_tenant(bad)


# ---------------------------------------------------------------------------
# WFQ + priority (deterministic: pinned costs, one worker)
# ---------------------------------------------------------------------------


def test_wfq_dispatch_tracks_weights_not_fifo():
    """Weight 4 against 1, unit costs, the light tenant submitted first:
    fair queueing interleaves by finish tag, as the reference does."""
    orders = []
    for mk in (_sched, _ref_sched):
        s = mk(capacity_s=1e9)
        s.register_tenant("a", priority=1, weight=4.0)
        s.register_tenant("b", priority=1, weight=1.0)
        order = []
        s.submit("b", _FakeProgram(run_fn=lambda **kw: order.append("b")),
                 repeats=4, cost_s=1.0)
        s.submit("a", _FakeProgram(run_fn=lambda **kw: order.append("a")),
                 repeats=4, cost_s=1.0)
        assert s.drain() == 8
        orders.append(order)
        acc = s.tenants.get("a").account()
        assert acc["submitted"] == acc["dispatched"] == 4
        assert acc["dispatched_cost_s"] == pytest.approx(4.0)
    assert orders[0] == orders[1] == ["a", "a", "a", "b", "a", "b", "b",
                                      "b"]


def test_fair_queue_virtual_time_math():
    for fq_cls, qe in ((FairQueue, QueueEntry),
                       (ref_sched.FairQueue, ref_sched.QueueEntry)):
        fq = fq_cls()
        ta = types.SimpleNamespace(finish_tag=0.0, weight=2.0)
        e1 = qe(tenant="a", priority=1, program=None, footprint=None,
                cost_s=1.0, seq=0)
        fq.push(ta, e1)
        assert (e1.start_tag, e1.finish_tag) == (0.0, 0.5)
        e2 = qe(tenant="a", priority=1, program=None, footprint=None,
                cost_s=1.0, seq=1)
        fq.push(ta, e2)
        assert (e2.start_tag, e2.finish_tag) == (0.5, 1.0)
        assert fq.queued_cost() == 2.0 and list(fq.entries()) == [e1, e2]
        assert fq.pop_best(lambda e: True) is e1
        assert fq.virtual_time == 0.0
        assert fq.pop_best(lambda e: True) is e2
        assert fq.virtual_time == 0.5
        assert fq.pop_best(lambda e: True) is None and len(fq) == 0


def test_strict_priority_and_boundary_preemption():
    orders = []
    for mk in (_sched, _ref_sched):
        s = mk(capacity_s=1e9)
        s.register_tenant("hi", priority=0)
        s.register_tenant("lo", priority=1)
        order = []
        s.submit("lo", _FakeProgram(run_fn=lambda **kw: order.append("lo")),
                 repeats=2, cost_s=1.0)
        assert s.step()
        s.submit("hi", _FakeProgram(run_fn=lambda **kw: order.append("hi")),
                 repeats=2, cost_s=1.0)
        s.drain()
        orders.append(order)
    assert orders[0] == orders[1] == ["lo", "hi", "hi", "lo"]


def test_blocked_higher_class_does_not_yield_the_link():
    """While the class-0 head conflicts with the program in flight, class
    1 does not overtake it: step() is False until the conflict drains,
    then hi runs first."""
    s = _sched(capacity_s=1e9)
    s.register_tenant("blk", priority=1)
    s.register_tenant("hi", priority=0)
    s.register_tenant("lo", priority=1)
    r3 = footprint_from_rank_programs(_ring(4, 3), 4, label="R3")
    r9 = footprint_from_rank_programs(_ring(4, 9), 4, label="R9")
    gate = threading.Event()
    order = []
    blocker = _FakeProgram(r3, run_fn=lambda **kw: gate.wait(JOIN_S))
    th = threading.Thread(target=lambda: s.dispatch_now("blk", blocker))
    th.start()
    deadline = time.monotonic() + JOIN_S
    while s.stats["max_inflight"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    s.submit("hi", _FakeProgram(r3, run_fn=lambda **kw:
                                order.append("hi")), cost_s=1.0)
    s.submit("lo", _FakeProgram(r9, run_fn=lambda **kw:
                                order.append("lo")), cost_s=1.0)
    assert s.step() is False
    assert order == []
    gate.set()
    th.join(JOIN_S)
    assert not th.is_alive()
    assert s.step() and s.step()
    assert order == ["hi", "lo"]


# ---------------------------------------------------------------------------
# admission: backpressure + pricing
# ---------------------------------------------------------------------------


def test_saturation_is_typed_backpressure():
    s = _sched(capacity_s=1.0)
    s.register_tenant("t")
    s.submit("t", _FakeProgram(), cost_s=0.6)
    with pytest.raises(SchedulerSaturatedError) as ei:
        s.submit("t", _FakeProgram(), cost_s=0.6)
    err = ei.value
    assert err.tenant == "t"
    assert err.requested_s == pytest.approx(0.6)
    assert err.queued_s == pytest.approx(0.6)
    assert err.capacity_s == pytest.approx(1.0)
    assert str(err) == str(ref_sched.SchedulerSaturatedError(
        "t", 0.6, 0.6, 1.0))
    assert s.stats["rejected_saturated"] == 1
    with pytest.raises(SchedulerSaturatedError):
        s.admit_request("t", cost_s=0.6)
    assert s.stats["rejected_saturated"] == 2
    assert s.queued_cost_s() == pytest.approx(0.6)
    s.admit_request("t", cost_s=0.1)


@pytest.fixture(scope="module")
def accl8():
    return ACCL(world=8, torch_device="cpu")


def test_predict_cost_never_free_and_cached(accl8):
    sched = accl8.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    a, b = (accl8.create_buffer(4096, torch.float32) for _ in range(2))
    seq = accl8.sequence()
    seq.allreduce(a, b, 4096, ReduceFunction.SUM)
    prog = seq.compile()
    cost = sched.predict_cost_s(prog)
    assert cost > 0
    assert cost == accl8.cclo.predict_sequence_cost(prog._prepared)
    assert sched._cost_cache[prog.signature] == cost
    assert sched.predict_cost_s(prog) == cost
    assert _sched().predict_cost_s(_FakeProgram()) > 0
    for buf in (a, b):
        accl8.free_buffer(buf)


def test_slo_deadline_model_derived_and_armed():
    s, r = _sched(), _ref_sched()
    t, rt = s.register_tenant("t"), r.register_tenant("t")
    assert s.slo_deadline_s(t, 0.1) == pytest.approx(0.1 * 4.0 + 0.05)
    assert s.slo_deadline_s(t, 0.1) == r.slo_deadline_s(rt, 0.1)
    s.arm_slo_reference(0.1)
    r.arm_slo_reference(0.1)
    assert s.slo_deadline_s(t, 0.1) == pytest.approx(0.1 * 1.35 + 0.05)
    assert s.slo_deadline_s(t, 0.1) == r.slo_deadline_s(rt, 0.1)
    b = s.register_tenant("budgeted", slo_budget_s=0.2)
    assert s.slo_deadline_s(b, 123.0) == 0.2


# ---------------------------------------------------------------------------
# the concurrency rule
# ---------------------------------------------------------------------------


def test_two_workers_overlap_only_under_certificate():
    """A certified-clean pair overlaps under drain(workers=2) (each side
    waits at a barrier only both in flight together release) and the
    dispatch carries the pair certificate, whose id is the reference's
    for the same footprints."""
    s = _sched(capacity_s=1e9)
    s.register_tenant("a")
    s.register_tenant("b")
    fa = footprint_from_rank_programs(_ring(4, 3), 4, label="A")
    fb = footprint_from_rank_programs(_ring(4, 9), 4, label="B")
    bar = threading.Barrier(2, timeout=JOIN_S)
    pa = _FakeProgram(fa, run_fn=lambda **kw: bar.wait())
    pb = _FakeProgram(fb, run_fn=lambda **kw: bar.wait())
    s.submit("a", pa, cost_s=1.0)
    s.submit("b", pb, cost_s=1.0)
    assert s.drain(workers=2) == 2
    assert s.stats["serialized_admissions"] == 0
    assert s.stats["concurrent_dispatches"] == 1
    assert s.stats["certified_concurrent"] == 1
    assert s.stats["uncertified_concurrent"] == 0
    assert s.stats["max_inflight"] == 2
    pair = certificate_id([fa, fb])
    singles = {certificate_id([fa]), certificate_id([fb])}
    assert {pa.certificate, pb.certificate} <= singles | {pair}
    assert pair in {pa.certificate, pb.certificate}
    rfa = ref_interference.footprint_from_rank_programs(
        _ring(4, 3, proto=ref_protocol), 4, label="A")
    rfb = ref_interference.footprint_from_rank_programs(
        _ring(4, 9, proto=ref_protocol), 4, label="B")
    assert pair == ref_interference.certificate_id([rfa, rfb])


def test_uncertifiable_pair_serializes_never_drops():
    """An ACCL602 pair (a TAG_ANY recv matchable by the other's send)
    under two workers: both run, never overlapping, and the serial
    fallback is counted."""
    s = _sched(capacity_s=1e9)
    s.register_tenant("a")
    s.register_tenant("b")
    fa = footprint_from_rank_programs(
        [[recv(1, TAG_ANY, 4)], [send(0, 3, 4)]], 2, label="A")
    fb = footprint_from_rank_programs(
        [[recv(1, 9, 4)], [send(0, 9, 4)]], 2, label="B")
    assert s._certifier.check_pair(fa, fb)
    mu = threading.Lock()
    intervals = {}

    def mk(name):
        def run(**kw):
            t0 = time.perf_counter()
            time.sleep(0.05)
            with mu:
                intervals[name] = (t0, time.perf_counter())
        return run

    s.submit("a", _FakeProgram(fa, run_fn=mk("a")), cost_s=1.0)
    s.submit("b", _FakeProgram(fb, run_fn=mk("b")), cost_s=1.0)
    assert s.stats["serialized_admissions"] == 1
    assert s.tenants.get("b").serialized == 1
    assert s.drain(workers=2) == 2
    (a0, a1), (b0, b1) = intervals["a"], intervals["b"]
    assert a1 <= b0 or b1 <= a0, "conflicting pair overlapped"
    assert s.stats["concurrent_dispatches"] == 0
    assert s.stats["uncertified_concurrent"] == 0


def test_footprintless_program_runs_exclusively():
    s = _sched(capacity_s=1e9)
    s.register_tenant("a")
    s.submit("a", _FakeProgram(), cost_s=1.0)
    assert s.stats["serialized_admissions"] == 1
    assert s.drain(workers=2) == 1
    assert s.stats["concurrent_dispatches"] == 0


def test_end_to_end_two_tenants_on_the_mesh(accl8):
    """Real prepared programs: two tenants' disjoint allreduces drain
    under two workers, exact, nothing uncertified, the namespaces
    disjoint, and each result equals its serial composition's."""
    sched = accl8.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    assert sched._certifier is accl8._interference  # the shared cache
    sched.register_tenant("a", priority=0, weight=2.0)
    sched.register_tenant("b", priority=1)
    world, n = accl8.world, 256
    a_in, a_out, b_in, b_out = (accl8.create_buffer(n, torch.float32)
                                for _ in range(4))
    sa = accl8.sequence()
    sa.allreduce(a_in, a_out, n, ReduceFunction.SUM)
    pa = sa.compile()
    sb = accl8.sequence()
    sb.allreduce(b_in, b_out, n, ReduceFunction.SUM)
    pb = sb.compile()
    xa = torch.arange(world * n, dtype=torch.float32).reshape(world, n)
    xb = torch.ones((world, n))
    a_in.host.copy_(xa)
    b_in.host.copy_(xb)
    sched.submit("a", pa, repeats=2)
    sched.submit("b", pb, repeats=2)
    assert sched.drain(workers=2) == 4
    assert torch.equal(a_out.host, xa.sum(0).expand(world, n))
    assert torch.equal(b_out.host, xb.sum(0).expand(world, n))
    assert sched.stats["dispatches"] == 4
    assert sched.stats["uncertified_concurrent"] == 0
    assert pa.certificate is not None and pb.certificate is not None
    rep = sched.report()
    assert rep["stats"]["dispatches"] == 4
    assert rep["namespaces"]["shared"] == []
    for buf in (a_in, a_out, b_in, b_out):
        accl8.free_buffer(buf)


# ---------------------------------------------------------------------------
# accounting: metrics, SLO residuals, noisy neighbours
# ---------------------------------------------------------------------------


def test_per_tenant_series_ride_the_registry():
    reg = MetricsRegistry()
    s = MultiTenantScheduler(_fake_accl(), capacity_s=1e9, registry=reg)
    s.register_tenant("alpha")
    s.submit("alpha", _FakeProgram(), repeats=3, cost_s=0.5)
    s.drain()
    snap = reg.snapshot()
    disp = {tuple(sorted(r["labels"].items())): r["value"]
            for r in snap["counters"]["accl_tenant_dispatches_total"]}
    assert disp[(("tenant", "alpha"),)] == 3.0
    (h,) = [r for r in snap["histograms"]["accl_tenant_dispatch_seconds"]
            if r["labels"]["tenant"] == "alpha"]
    assert h["count"] == 3
    (res,) = snap["histograms"]["accl_tenant_slo_residual_seconds"]
    assert res["count"] == 3
    cost = {r["labels"]["tenant"]: r["value"]
            for r in snap["counters"]["accl_tenant_cost_seconds_total"]}
    assert cost["alpha"] == pytest.approx(1.5)


def test_noisy_neighbor_attribution_names_the_bulk_tenant():
    """Deterministic clocks: bulk holds [0, 5], small misses its 10 ms
    budget at [5, 5.1]; the report names bulk, as the reference's does."""
    reports = []
    for mk in (_sched, _ref_sched):
        clock = _Clock()
        s = mk(capacity_s=1e9, time_fn=clock)
        s.register_tenant("bulk", priority=1)
        s.register_tenant("small", priority=0, slo_budget_s=0.01)
        s.submit("bulk", _FakeProgram(
            run_fn=lambda c=clock, **kw: c.advance(5.0)), cost_s=4.0)
        assert s.step()
        s.submit("small", _FakeProgram(
            run_fn=lambda c=clock, **kw: c.advance(0.1)), cost_s=0.001)
        assert s.step()
        assert s.tenants.get("small").slo_misses == 1
        assert s.tenants.get("bulk").slo_misses == 0
        reports.append(s.report())
    got, want = reports
    (row,) = got["noisy_neighbors"]
    assert row["tenant"] == "small" and row["slo_misses"] == 1
    assert row["noisy_neighbor"] == "bulk"
    assert row["neighbor_share"] == pytest.approx(1.0)
    assert row["neighbor_cost_s"]["bulk"] == pytest.approx(4.0)
    assert got == want


def test_namespace_ledger_flags_cross_tenant_sharing(accl8):
    sched = accl8.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    sched.register_tenant("a")
    sched.register_tenant("b")
    n = 64
    a_in, b_in, shared = (accl8.create_buffer(n, torch.float32)
                          for _ in range(3))
    sa = accl8.sequence()
    sa.allreduce(a_in, shared, n, ReduceFunction.SUM)
    pa = sa.compile()
    sb = accl8.sequence()
    sb.allreduce(b_in, shared, n, ReduceFunction.SUM)
    pb = sb.compile()
    sched.submit("a", pa)
    sched.submit("b", pb)  # conflicting: serial fallback
    assert sched.stats["serialized_admissions"] == 1
    sched.drain(workers=2)
    ledger = sched.tenants.disjointness_report()
    assert any(row["tenants"] == ["a", "b"] and row["resource"] == "addrs"
               for row in ledger["shared"])
    assert sched.stats["uncertified_concurrent"] == 0
    for buf in (a_in, b_in, shared):
        accl8.free_buffer(buf)


def test_drain_stress_more_workers_than_cores():
    """Many clean and conflicting fake programs through 16 workers with a
    short switch interval: every dispatch happens once, the counter the
    programs share loses no update, nothing overlaps uncertified."""
    s = _sched(capacity_s=1e9)
    for name in "abcd":
        s.register_tenant(name)
    count = [0]
    mu = threading.Lock()

    def bump(**kw):
        with mu:
            count[0] += 1

    progs = [_FakeProgram(footprint_from_rank_programs(
        _ring(4, tag), 4, label=f"T{tag}"), run_fn=bump)
        for tag in range(1, 7)]
    progs.append(_FakeProgram(run_fn=bump))  # footprint-less: alone
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i, p in enumerate(progs):
            s.submit("abcd"[i % 4], p, repeats=8, cost_s=0.01)
        done = []
        th = threading.Thread(target=lambda: done.append(s.drain(16)))
        th.start()
        th.join(JOIN_S * 3)
        assert not th.is_alive(), "drain did not finish"
    finally:
        sys.setswitchinterval(old)
    assert done == [8 * len(progs)] == [count[0]]
    assert s.stats["dispatches"] == 8 * len(progs)
    assert s.stats["uncertified_concurrent"] == 0


# ---------------------------------------------------------------------------
# the DecodeServer seam
# ---------------------------------------------------------------------------


def _serve_setup():
    from accl_tpu_torch.models import serve
    from accl_tpu_torch.models import transformer as trf

    cfg = trf.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=64)
    params = trf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return serve, cfg, params


def test_decode_server_scheduler_seam_keeps_bitwise_parity():
    serve, cfg, params = _serve_setup()
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, cfg.vocab,
                                          int(rng.integers(1, 5)))))
               for _ in range(5)]
    plain = serve.DecodeServer(ACCL(world=2, torch_device="cpu"), cfg,
                               params, batch=3, max_len=12,
                               registry=MetricsRegistry())
    out_plain = serve.generate(plain, prompts, 4)
    accl = ACCL(world=2, torch_device="cpu")
    sched = accl.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    srv = serve.DecodeServer(accl, cfg, params, batch=3, max_len=12,
                             registry=MetricsRegistry(), scheduler=sched)
    assert serve.generate(srv, prompts, 4) == out_plain
    t = sched.tenants.get("serve")
    assert t.priority == 0
    assert t.dispatched == srv.n_steps > 0
    assert sched.stats["uncertified_concurrent"] == 0
    assert srv._program.certificate is not None


def test_decode_server_saturation_rejects_before_queueing():
    serve, cfg, params = _serve_setup()
    accl = ACCL(world=2, torch_device="cpu")
    sched = accl.scheduler(capacity_s=1e-12, registry=MetricsRegistry())
    srv = serve.DecodeServer(accl, cfg, params, batch=3, max_len=12,
                             registry=MetricsRegistry(), scheduler=sched,
                             tenant="chat")
    with pytest.raises(SchedulerSaturatedError) as e:
        srv.submit([1, 2, 3], 4)
    assert e.value.tenant == "chat"
    assert not srv.active
    assert sched.stats["rejected_saturated"] == 1
