"""The port's self-healing collectives (accl_tpu_torch/resilience/) against
the JAX package's, scenario for scenario of tests/test_resilience.py.

Where the reference's own code runs here, the port is compared with it:
the deadline policy's numbers, the retry budget's actions,
classify_wire_delta and assess_miss, the synthesized replan's entry and
certificate, and the facade's live-subset allreduce. Six of the
reference's scenarios (64 cases) fail in this environment inside the
reference's lift (UnsupportedSchedule: primitive 'jit' over abstract
payload): the 30-seed kill fuzz, the 30-seed live-subset fuzz, the ghost
contribution, the ring replan on a survivor world that is not a power of
two, the sabotaged replan and the install checks. The port lifts its own
bodies, so it runs each of them, held against numpy survivor oracles and
`hopdag.execute` of its lifted DAGs in place of the reference; each such
test says so.

The native worlds are the port's own build of native/src
(device/emu_device.py), driven with CPU torch tensors; every run is
bounded (EmuWorld.run(timeout_s=)) and every stalled call ends at its
derived deadline or the runtime's receive timeout.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from accl_tpu import ACCL as RefACCL
from accl_tpu import resilience as ref_res
from accl_tpu.constants import DataType as RefDataType
from accl_tpu.constants import Operation as RefOperation
from accl_tpu.constants import TuningParams as RefTuning
from accl_tpu.sequencer.timing import LinkParams as RefLink
from accl_tpu_torch import ACCL, ACCLError, ReduceFunction
from accl_tpu_torch.analysis import hopdag, semantics
from accl_tpu_torch.communicator import Communicator, Rank
from accl_tpu_torch.constants import (
    CfgFunc,
    CompressionFlags,
    DataType,
    Operation,
    TuningParams,
)
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device.base import CCLOAddr
from accl_tpu_torch.device.emu_device import EmuWorld, load_native
from accl_tpu_torch.resilience import (
    DeadlineMissed,
    DeadlineMissedError,
    DeadlinePolicy,
    NativeDeadlineGuard,
    RecoveryPlan,
    ResilienceManager,
    RetryBudget,
    UncertifiedRecoveryError,
)
from accl_tpu_torch.sequencer.plan import select_algorithm
from accl_tpu_torch.sequencer.timing import LinkParams
from accl_tpu_torch.telemetry import recorder as flight

LINK = dict(alpha=100e-6, beta=0.5e9)
F32 = DataType.float32
SEL_KW = dict(max_eager_size=1024, eager_rx_buf_size=1024,
              tuning=TuningParams.default())
RUN_S = 60  # the bound on every native world's run


def _policy(world=4, **kw):
    kw.setdefault("floor_s", 0.05)
    return DeadlinePolicy(LinkParams(**LINK), world=world, **kw)


def _ref_policy(world=4, **kw):
    kw.setdefault("floor_s", 0.05)
    return ref_res.DeadlinePolicy(RefLink(**LINK), world=world, **kw)


@pytest.fixture(autouse=True)
def _clean_flight_recorder():
    flight.get_recorder().clear()
    yield
    flight.get_recorder().clear()


@pytest.fixture(scope="module")
def lib():
    return load_native()


# ---------------------------------------------------------------------------
# deadline policy
# ---------------------------------------------------------------------------


OPS = ("allreduce", "bcast", "reduce", "allgather", "reduce_scatter",
       "alltoall", "gather", "scatter")


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_policy_numbers_equal_the_reference(world):
    """predict_s, deadline_s, deadline_ms and tolerance over ops x counts
    x element widths, unarmed and armed, against the reference's policy."""
    pol, ref = _policy(world), _ref_policy(world)
    for armed in (False, True):
        if armed:
            assert pol.arm_from_residuals("allreduce", [0.1, 0.3, 0.2]) == \
                ref.arm_from_residuals("allreduce", [0.1, 0.3, 0.2])
            pol.arm_reference("bcast", 0.05)
            ref.arm_reference("bcast", 0.05)
        for op in OPS:
            assert pol.tolerance(op) == ref.tolerance(op)
            for count in (1, 64, 1000, 16384, 1 << 20):
                for eb in (2, 4, 8):
                    assert pol.predict_and_deadline(op, count, eb) == \
                        ref.predict_and_deadline(op, count, eb), (op, count)
                    assert pol.deadline_ms(op, count, eb) == \
                        ref.deadline_ms(op, count, eb)


def test_deadline_exceeds_prediction_and_floor():
    from accl_tpu_torch.telemetry.metrics import DriftSentinel

    pol = _policy()
    pred = pol.predict_s("allreduce", 16384)
    dl = pol.deadline_s("allreduce", 16384)
    assert dl > pred
    assert dl >= pol.floor_s
    sent = DriftSentinel(band_factor=pol.band_factor,
                         band_floor=pol.band_floor)
    pol.arm_reference("allreduce", 0.4)
    assert pol.tolerance("allreduce") == pytest.approx(sent.band_hi(0.4))


def test_armed_reference_tightens_unarmed_band():
    pol = _policy()
    loose = pol.deadline_s("allreduce", 16384)
    pol.arm_reference("allreduce", 0.05)
    assert pol.deadline_s("allreduce", 16384) < loose


def test_arm_from_residuals_uses_median():
    pol = _policy()
    ref = pol.arm_from_residuals("bcast", [0.1, 0.3, 0.2])
    assert ref == pytest.approx(0.2)
    assert pol.tolerance("bcast") == pytest.approx(
        max(0.2 * pol.band_factor, 0.2 + pol.band_floor))


def test_deadline_monotonic_in_count():
    pol = _policy()
    assert pol.deadline_s("allreduce", 1 << 20) > \
        pol.deadline_s("allreduce", 1024)


def test_policy_requires_calibrated_link():
    with pytest.raises(ValueError, match="calibrated"):
        DeadlinePolicy(None, world=4)


def test_check_in_deadline_is_none_and_miss_is_verdict():
    pol, ref = _policy(), _ref_policy()
    dl = pol.deadline_s("allreduce", 4096)
    assert pol.check("allreduce", 4096, 4, elapsed_s=dl * 0.5) is None
    miss = pol.check("allreduce", 4096, 4, elapsed_s=dl * 10, rank=1,
                     suspect_rank=2, attribution="silent")
    want = ref.check("allreduce", 4096, 4, elapsed_s=dl * 10, rank=1,
                     suspect_rank=2, attribution="silent")
    assert isinstance(miss, DeadlineMissed)
    v = miss.verdict()
    assert v["kind"] == "deadline_missed"
    assert v["suspect_rank"] == 2 and v["rank"] == 1
    assert "allreduce" in str(miss) and "suspect r2" in str(miss)
    assert str(miss) == str(want)
    wv = want.verdict()
    assert {k: x for k, x in v.items() if k != "post_mortem_spans"} == \
        {k: x for k, x in wv.items() if k != "post_mortem_spans"}


def test_sticky_retcode_is_a_miss_even_inside_deadline():
    miss = _policy().check("allreduce", 4096, 4, elapsed_s=1e-6,
                           retcode=0x800)
    assert miss is not None and miss.retcode == 0x800
    assert "RECEIVE_TIMEOUT" in str(miss)
    assert miss.verdict()["retcode_str"] == \
        _ref_policy().check("allreduce", 4096, 4, elapsed_s=1e-6,
                            retcode=0x800).verdict()["retcode_str"]


# ---------------------------------------------------------------------------
# flight recorder: the host-side dump on a deadline miss
# ---------------------------------------------------------------------------


def test_deadline_miss_freezes_post_mortem_without_tracing():
    from accl_tpu_torch import telemetry

    tr = telemetry.get_tracer()
    assert not tr.enabled  # the ring is off: the recorder alone fires
    assert flight.armed()
    tr.emit("allreduce", "call", "facade", ts_ns=1, dur_ns=10,
            args={"op": "allreduce", "count": 64})
    miss = _policy().check("allreduce", 4096, 4, elapsed_s=100.0, rank=3)
    doc = miss.post_mortem
    assert doc is not None
    assert doc["meta"]["flight_recorder"] is True
    assert "deadline missed" in doc["meta"]["reason"]
    markers = [s for s in doc["spans"] if s.get("cat") == "error"]
    assert markers and markers[-1]["args"]["deadline_missed"] is True
    assert markers[-1]["args"]["measured_s"] == pytest.approx(100.0)
    assert markers[-1]["track"] == "emu/r3"
    assert flight.last_error_trace()["meta"]["reason"] == \
        doc["meta"]["reason"]
    telemetry.validate_trace(doc)


def test_error_marker_spans_never_poison_residual_tables():
    from accl_tpu_torch.telemetry import residual_rows

    trace = {"spans": [
        {"name": "allreduce", "cat": "native", "track": "emu/r0",
         "ts_ns": 0, "dur_ns": 0,
         "args": {"predicted_s": 1e-3, "measured_s": 1.1e-3}},
        {"name": "allreduce", "cat": "error", "track": "emu/r1",
         "ts_ns": 1, "dur_ns": 0,
         "args": {"deadline_missed": True, "retcode": 0x800,
                  "predicted_s": 2e-3, "measured_s": 5.2e-2}},
    ]}
    rows = residual_rows(trace)
    assert len(rows) == 1 and rows[0]["track"] == "emu/r0"


def test_on_deadline_miss_noop_when_disarmed():
    from accl_tpu_torch import telemetry

    telemetry.disable_observability()
    try:
        assert flight.on_deadline_miss("allreduce", count=4) is None
    finally:
        telemetry.enable_observability()


# ---------------------------------------------------------------------------
# manager: budget, attribution, exclusion
# ---------------------------------------------------------------------------


def _mk_miss(cls=DeadlineMissed, suspect=None, rank=0, count=64,
             elapsed=1.0):
    return cls(op="allreduce", count=count, predicted_s=1e-3,
               deadline_s=5e-3, elapsed_s=elapsed, rank=rank,
               suspect_rank=suspect)


def test_retry_budget_transitions_and_backoff():
    """The action sequence and the backoff delays equal the reference's."""
    budget = dict(max_retries=2, backoff_base_s=0.01, backoff_factor=2.0)
    mgr = ResilienceManager(4, budget=RetryBudget(**budget))
    ref = ref_res.ResilienceManager(4, budget=ref_res.RetryBudget(**budget))
    got, want = [], []
    for _ in range(4):
        got.append((mgr.record_miss(_mk_miss(suspect=2)),
                    mgr.retry_delay_s(2)))
        want.append((ref.record_miss(_mk_miss(ref_res.DeadlineMissed,
                                              suspect=2)),
                     ref.retry_delay_s(2)))
    assert got == want
    assert [a for a, _ in got] == ["retry", "retry", "exclude", "exclude"]
    assert got[1][1] == pytest.approx(got[0][1] * 2.0)
    assert len(mgr.misses) == 4
    for attempt in range(5):
        assert RetryBudget(**budget).delay_s(attempt) == \
            ref_res.RetryBudget(**budget).delay_s(attempt)


def test_note_recovery_resets_the_budget():
    mgr = ResilienceManager(4, budget=RetryBudget(max_retries=1))
    m = _mk_miss(suspect=1)
    assert mgr.record_miss(m) == "retry"
    mgr.note_recovery(1)
    assert mgr.record_miss(m) == "retry"


def test_attribute_silent_names_the_non_reporter():
    mgr = ResilienceManager(4)
    assert mgr.attribute_silent([0, 1, 3]) == 2
    assert mgr.attribute_silent([0, 1, 2, 3]) is None
    assert mgr.attribute_silent([0]) is None


def test_exclude_validations():
    mgr = ResilienceManager(4)
    assert mgr.exclude(2) == (0, 1, 3)
    assert mgr.live_ranks == (0, 1, 3) == mgr.degraded_live_ranks()
    with pytest.raises(ValueError, match="not live"):
        mgr.exclude(2)
    with pytest.raises(ValueError, match="2-rank floor"):
        ResilienceManager(2).exclude(1)


# ---------------------------------------------------------------------------
# manager: certified replan + install
# ---------------------------------------------------------------------------


def _execute_equals_sum(dag, world, count, seed):
    """hopdag.execute of a certified allreduce DAG on random integer rows
    equals the numpy sum on every rank."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-32, 32, size=(world, count)).astype(np.float32)
    outs = hopdag.execute(dag, [[x] for x in xs])
    return all(np.array_equal(o, xs.sum(0)) for o in outs)


@pytest.mark.parametrize("victim,count", [(1, 256), (0, 64), (3, 1024),
                                          (2, 7)])
def test_replan_ring_on_non_pow2_survivor_world(victim, count):
    """The reference fails here inside its lift; the port lifts its own
    ring body over the 3 survivors, certifies it with 0 diagnostics, and
    hopdag.execute of that DAG sums the survivors' rows (numpy oracle)."""
    mgr = ResilienceManager(4)
    mgr.exclude(victim)
    rp = mgr.replan(Operation.allreduce, count=count)
    assert rp.world == 3 and rp.survivors == tuple(
        r for r in range(4) if r != victim)
    assert rp.source == "ring" and rp.generation == 1
    assert rp.certificate["diagnostics"] == 0
    assert "semantics(ACCL501-504)" in rp.certificate["checks"]
    assert "modelcheck(ACCL205-207)" in rp.certificate["checks"]
    assert rp.plan == select_algorithm(
        Operation.allreduce, count, 4, 3, max_eager_size=4096,
        eager_rx_buf_size=4096, tuning=TuningParams.default())
    opts = CallOptions(scenario=Operation.allreduce, count=count,
                       function=0, data_type=F32)
    dag = semantics.lift_call(opts, rp.plan, 3)
    assert _execute_equals_sum(dag, 3, count, victim)


def test_replan_synthesized_on_pow2_survivor_world():
    """Runs in the reference too: the same library entry and the same
    certificate."""
    mgr = ResilienceManager(5)
    mgr.exclude(4)
    rp = mgr.replan(Operation.allreduce, count=1024)
    ref = ref_res.ResilienceManager(5)
    ref.exclude(4)
    want = ref.replan(RefOperation.allreduce, count=1024)
    assert rp.world == 4 and rp.source == "synthesized"
    assert rp.synth_key.startswith("allreduce_w4")
    assert (rp.synth_key, rp.certificate, rp.survivors) == \
        (want.synth_key, want.certificate, want.survivors)
    assert rp.certificate["diagnostics"] == 0


def test_uncertified_replan_raises_and_installs_nothing(monkeypatch):
    """The reference fails here inside its lift. The port's lift runs; a
    sabotaged certifier makes the replan raise and nothing is
    installed."""
    from accl_tpu_torch.analysis.diagnostics import make

    mgr = ResilienceManager(4)
    mgr.exclude(3)

    def sabotaged(dag, spec, name):
        return [make("ACCL501", "sabotaged certifier")]

    monkeypatch.setattr(semantics, "certify", sabotaged)
    with pytest.raises(UncertifiedRecoveryError, match="NOT installed") as e:
        mgr.replan(Operation.allreduce, count=64)
    assert [d.code for d in e.value.diagnostics] == ["ACCL501"]
    assert mgr.current_plan is None and mgr.generation == 0


def test_install_requires_clean_certificate_and_matching_membership():
    """The reference fails here inside its lift (its replan); the port
    replans and holds install's checks."""
    mgr = ResilienceManager(4)
    mgr.exclude(0)
    rp = mgr.replan(Operation.allreduce, count=64)
    bad = RecoveryPlan(op="allreduce", survivors=rp.survivors, world=3,
                       count=64, source="ring", plan=None, certificate={})
    with pytest.raises(UncertifiedRecoveryError):
        mgr.install(bad)
    gen = mgr.install(rp)
    assert gen == mgr.generation == 1
    assert mgr.current_plan is rp
    mgr.exclude(1)
    with pytest.raises(ValueError, match="membership"):
        mgr.install(rp)


# ---------------------------------------------------------------------------
# the degraded live-subset allreduce on the facade
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def accl4():
    return ACCL(world=4, torch_device="cpu")


def _run_live(accl, data, live):
    n = data.shape[1]
    a = accl.create_buffer(n, torch.float32, torch.from_numpy(data))
    b = accl.create_buffer(n, torch.float32)
    req = accl.allreduce(a, b, n, ReduceFunction.SUM, mode="live_subset",
                         live_ranks=live)
    out = b.host.numpy().copy()
    accl.free_buffer(a)
    accl.free_buffer(b)
    return out, req


@pytest.mark.parametrize("live", [(0, 1, 3), (1, 2), (0,)])
def test_live_subset_matches_survivor_oracle_bitwise(accl4, mesh4, live):
    """Bitwise against the numpy survivor oracle and against the
    reference facade's answer on the same rows."""
    n = 96
    rng = np.random.default_rng(sum(live) + 10 * len(live))
    data = rng.integers(-64, 64, size=(4, n)).astype(np.float32)
    got, req = _run_live(accl4, data, live)
    assert np.array_equal(got, np.tile(data[list(live)].sum(0), (4, 1)))
    assert req.plan.live_ranks == live
    ref = RefACCL(mesh4)
    a = ref.create_buffer(n, np.float32, data)
    b = ref.create_buffer(n, np.float32)
    ref.allreduce(a, b, n, ReduceFunction.SUM, mode="live_subset",
                  live_ranks=live)
    assert np.array_equal(got, np.asarray(b.host))


@pytest.mark.parametrize("seed", range(30))
def test_live_subset_fuzz_vs_survivor_oracle(accl4, seed):
    """The reference fails here inside its lift (certify_call). 30 seeds
    of a random survivor set and payload: the facade's answer equals the
    numpy oracle over exactly the survivors, bitwise; the lifted body
    certifies clean against the survivor spec, and hopdag.execute of it
    gives the same oracle."""
    rng = np.random.default_rng(4200 + seed)
    n = int(rng.choice([16, 100]))
    k = int(rng.integers(1, 4))
    live = tuple(sorted(rng.choice(4, size=k, replace=False).tolist()))
    data = rng.integers(-32, 32, size=(4, n)).astype(np.float32)
    got, _ = _run_live(accl4, data, live)
    want = data[list(live)].sum(0)
    assert np.array_equal(got, np.tile(want, (4, 1))), \
        f"seed {seed} live {live}"
    opts = CallOptions(scenario=Operation.allreduce, count=n,
                       function=int(ReduceFunction.SUM), data_type=F32,
                       live_ranks=live)
    plan = select_algorithm(Operation.allreduce, n, 4, 4, live_ranks=live,
                            **SEL_KW)
    assert not semantics.certify_call(opts, plan, 4)
    outs = hopdag.execute(semantics.lift_call(opts, plan, 4),
                          [[x] for x in data])
    assert all(np.array_equal(o, want) for o in outs)


def test_live_subset_full_set_is_the_ordinary_allreduce(accl4):
    n = 32
    data = np.arange(4 * n, dtype=np.float32).reshape(4, n)
    got, req = _run_live(accl4, data, (0, 1, 2, 3))
    assert np.array_equal(got, np.tile(data.sum(0), (4, 1)))
    assert req.plan.live_ranks == ()


def test_live_subset_validations(accl4, mesh4, monkeypatch):
    """The port's errors, type and message, are the reference's (but the
    last, which names the port's ring)."""
    n = 16
    ref = RefACCL(mesh4)
    bufs = (accl4.create_buffer(n, torch.float32),
            accl4.create_buffer(n, torch.float32))
    rbufs = (ref.create_buffer(n, np.float32),
             ref.create_buffer(n, np.float32))
    cases = [dict(mode="degraded"), dict(live_ranks=(0, 1)),
             dict(mode="live_subset", live_ranks=()),
             dict(mode="live_subset", live_ranks=(1, 1)),
             dict(mode="live_subset", live_ranks=(0, 7)),
             dict(mode="live_subset", live_ranks=(0, 1), func="MAX"),
             dict(mode="live_subset", live_ranks=(0, 1),
                  compress_dtype="float16")]
    for kw in cases:
        kw = dict(kw)
        func = ReduceFunction[kw.pop("func", "SUM")]
        cdt = kw.pop("compress_dtype", None)
        with pytest.raises((ValueError, NotImplementedError)) as got:
            accl4.allreduce(*bufs, n, func, compress_dtype=(
                DataType[cdt] if cdt else None), **kw)
        with pytest.raises((ValueError, NotImplementedError)) as want:
            ref.allreduce(*rbufs, n, func, compress_dtype=(
                RefDataType[cdt] if cdt else None), **kw)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
    monkeypatch.setattr(type(accl4.cclo), "supports_live_subset", False)
    with pytest.raises(NotImplementedError, match="masked live-subset"):
        accl4.allreduce(*bufs, n, ReduceFunction.SUM, mode="live_subset",
                        live_ranks=(0, 1))
    for b in bufs:
        accl4.free_buffer(b)


def test_live_subset_rides_a_recorded_sequence(accl4):
    """The degraded form records into a batch; the default lint tier (its
    semantic pass included) passes it and the batch's answer is the
    survivor oracle, bitwise."""
    n = 64
    live = (0, 2, 3)
    data = np.arange(4 * n, dtype=np.float32).reshape(4, n)
    a = accl4.create_buffer(n, torch.float32, torch.from_numpy(data))
    b = accl4.create_buffer(n, torch.float32)
    c = accl4.create_buffer(n, torch.float32)
    with accl4.sequence() as seq:
        seq.allreduce(a, b, n, ReduceFunction.SUM, mode="live_subset",
                      live_ranks=live)
        seq.copy(b, c, n)
    want = np.tile(data[list(live)].sum(0), (4, 1))
    assert np.array_equal(b.host.numpy(), want)
    assert np.array_equal(c.host.numpy(), want)
    for buf in (a, b, c):
        accl4.free_buffer(buf)


def test_live_subset_runs_the_masked_torch_op_ring(accl4, monkeypatch):
    """The degraded mode lowers to the torch-op ring (its folds are the
    lane kernel's), never the ring kernel, even where the ring kernel is
    on."""
    from accl_tpu_torch.ops import ring_allreduce as ra

    compiler = accl4.cclo.compiler
    monkeypatch.setattr(compiler, "use_ring_kernel", True)
    opts = CallOptions(scenario=Operation.allreduce, count=64, function=0,
                       data_type=F32, live_ranks=(1, 3))
    plan = select_algorithm(Operation.allreduce, 64, 4, 4,
                            live_ranks=(1, 3), **SEL_KW)
    body = compiler._allreduce_body(opts, plan, None, ReduceFunction.SUM,
                                    None, False)
    assert body.keywords["live_ranks"] == (1, 3)
    before = ra.ring_allreduce_bidir.launches
    x = torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64)
    from accl_tpu_torch.sequencer.schedules import Wire

    out = body.func(x, **{**body.keywords, "wire": Wire(None)})
    assert torch.equal(out, (x[1] + x[3]).expand(4, 64))
    assert ra.ring_allreduce_bidir.launches == before


def test_ghost_contribution_rejects_exactly_ACCL501():
    """The reference fails here inside its lift. From the port's lifted
    DAGs: a plain full-world allreduce judged against a declared survivor
    set is a ghost contribution, ACCL501 and nothing else, while the
    masked schedule certifies clean; hopdag.execute of the masked DAG is
    the survivor sum."""
    world, n, live = 4, 8, (0, 1, 3)
    opts_live = CallOptions(scenario=Operation.allreduce, count=n,
                            function=int(ReduceFunction.SUM),
                            data_type=F32, live_ranks=live)
    spec = semantics.collective_spec(opts_live, world)
    plan_live = select_algorithm(Operation.allreduce, n, 4, world,
                                 live_ranks=live, **SEL_KW)
    dag_live = semantics.lift_call(opts_live, plan_live, world)
    assert not semantics.certify(dag_live, spec, "allreduce")
    opts_plain = CallOptions(scenario=Operation.allreduce, count=n,
                             function=int(ReduceFunction.SUM),
                             data_type=F32)
    plan_plain = select_algorithm(Operation.allreduce, n, 4, world,
                                  **SEL_KW)
    dag_plain = semantics.lift_call(opts_plain, plan_plain, world)
    codes = sorted({d.code for d in semantics.certify(dag_plain, spec,
                                                      "allreduce")})
    assert codes == ["ACCL501"]
    xs = np.random.default_rng(5).integers(-9, 9, (world, n)).astype(
        np.float32)
    outs = hopdag.execute(dag_live, [[x] for x in xs])
    assert all(np.array_equal(o, xs[list(live)].sum(0)) for o in outs)


def test_live_sets_are_cache_keyed():
    p1 = select_algorithm(Operation.allreduce, 64, 4, 4,
                          live_ranks=(0, 1), **SEL_KW)
    p2 = select_algorithm(Operation.allreduce, 64, 4, 4,
                          live_ranks=(0, 2), **SEL_KW)
    assert p1 != p2
    o1 = CallOptions(scenario=Operation.allreduce, count=64,
                     data_type=F32, live_ranks=(0, 1))
    o2 = CallOptions(scenario=Operation.allreduce, count=64,
                     data_type=F32, live_ranks=(0, 2))
    assert o1.signature() != o2.signature()


def test_live_subset_validation_in_select_algorithm():
    from accl_tpu.sequencer.plan import select_algorithm as ref_select

    cases = [dict(live_ranks=(0, 9)), dict(live_ranks=(1, 1)),
             dict(live_ranks=(0, 1), compressed=True)]
    for kw in cases:
        comp = kw.pop("compressed", False)
        with pytest.raises(ValueError) as got:
            select_algorithm(
                Operation.allreduce, 64, 4, 4,
                CompressionFlags.ETH_COMPRESSED if comp else
                CompressionFlags.NO_COMPRESSION,
                compress_dtype=DataType.float16 if comp else DataType.none,
                **SEL_KW, **kw)
        with pytest.raises(ValueError) as want:
            ref_select(
                RefOperation.allreduce, 64, 4, 4, 8 if comp else 0,
                compress_dtype=RefDataType.float16 if comp
                else RefDataType.none,
                max_eager_size=1024, eager_rx_buf_size=1024,
                tuning=RefTuning.default(), **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the facade seam: armed deadlines on synchronous calls
# ---------------------------------------------------------------------------


def _tight_policy():
    pol = DeadlinePolicy(LinkParams(alpha=1e-12, beta=1e15), world=4,
                         floor_s=0.0)
    pol.arm_reference("allreduce", 0.0)
    pol.band_floor = 0.0
    return pol


def test_facade_armed_seam_control_is_bitwise_unaffected(accl4):
    n = 128
    data = torch.arange(4 * n, dtype=torch.float32).reshape(4, n)
    a = accl4.create_buffer(n, torch.float32, data)
    b = accl4.create_buffer(n, torch.float32)
    accl4.allreduce(a, b, n, ReduceFunction.SUM)
    plain = b.host.clone()
    pol = DeadlinePolicy(LinkParams(alpha=1.0, beta=1e9), world=4)
    mgr = ResilienceManager(4, policy=pol)
    accl4.arm_resilience(mgr)
    try:
        for _ in range(3):
            accl4.allreduce(a, b, n, ReduceFunction.SUM)
            assert torch.equal(b.host, plain)
        assert not mgr.misses
    finally:
        accl4.arm_resilience(None)
    accl4.free_buffer(a)
    accl4.free_buffer(b)


def test_facade_armed_seam_records_a_miss_after_warmup(accl4):
    n = 128
    a = accl4.create_buffer(n, torch.float32)
    b = accl4.create_buffer(n, torch.float32)
    mgr = ResilienceManager(4, policy=_tight_policy())
    accl4.arm_resilience(mgr)
    try:
        accl4.allreduce(a, b, n, ReduceFunction.SUM)  # the warm-up
        assert not mgr.misses
        accl4.allreduce(a, b, n, ReduceFunction.SUM, run_async=True)
        assert not mgr.misses  # an async call is not timed
        accl4.allreduce(a, b, n, ReduceFunction.SUM)
    finally:
        accl4.arm_resilience(None)
    assert mgr.misses, "tight deadline did not produce a verdict"
    assert mgr.misses[0].post_mortem is not None
    assert mgr.misses[0].op == "allreduce" and mgr.misses[0].count == n
    accl4.free_buffer(a)
    accl4.free_buffer(b)


def test_soft_reset_re_exempts_warmed_shapes():
    accl = ACCL(world=4, torch_device="cpu")
    n = 48
    a = accl.create_buffer(n, torch.float32)
    b = accl.create_buffer(n, torch.float32)
    mgr = ResilienceManager(4, policy=_tight_policy())
    accl.arm_resilience(mgr)
    try:
        accl.allreduce(a, b, n, ReduceFunction.SUM)  # warm-up: exempt
        assert not mgr.misses
        accl.soft_reset()  # the built schedules are gone
        accl.allreduce(a, b, n, ReduceFunction.SUM)  # rebuilt: exempt
        assert not mgr.misses, \
            "the call after soft_reset was flagged as a deadline miss"
        accl.allreduce(a, b, n, ReduceFunction.SUM)  # steady: checked
        assert mgr.misses
    finally:
        accl.arm_resilience(None)


# ---------------------------------------------------------------------------
# native rank death: the env lever, the sticky span, the guard
# ---------------------------------------------------------------------------


def _set_timeout(rank, ms):
    rank.call(CallOptions(scenario=Operation.config,
                          function=int(CfgFunc.set_timeout), count=ms))


def test_kill_env_auto_wedges_after_n_calls(lib, monkeypatch):
    monkeypatch.setenv("ACCL_RT_FAULT_KILL_RANK", "1")
    monkeypatch.setenv("ACCL_RT_FAULT_KILL_AFTER", "2")
    n = 64
    w = EmuWorld(2, transport="local")
    try:
        xs = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)

        def body(rank, i):
            _set_timeout(rank, 300)
            outs = []
            for _k in range(2):  # inside the budget: both complete
                out = torch.zeros(n)
                rank.allreduce(xs[i].clone(), out, n, ReduceFunction.SUM)
                outs.append(out)
            try:  # call 3 is past the budget: rank 1 is dead
                rank.allreduce(xs[i].clone(), torch.zeros(n), n,
                               ReduceFunction.SUM)
                return outs, "completed"
            except ACCLError as e:
                return outs, e.retcode

        res = w.run(body, timeout_s=RUN_S)
    finally:
        w.close()
    for outs, verdict in res:
        for out in outs:
            assert torch.equal(out, xs.sum(0))
        assert verdict != "completed" and verdict & 0x800


def test_killed_rank_emits_final_sticky_span(lib, monkeypatch):
    monkeypatch.setenv("ACCL_RT_TRACE", "1")
    n = 32
    w = EmuWorld(2, transport="local")
    try:
        w.ranks[1].kill()

        def body(rank, i):
            if i == 0:
                _set_timeout(rank, 200)
            try:
                rank.allreduce(torch.ones(n), torch.zeros(n), n,
                               ReduceFunction.SUM)
            except ACCLError:
                pass

        w.run(body, timeout_s=RUN_S)
        spans1, _ = w.ranks[1].trace_read()
        assert spans1, "killed rank left no trace span"
        assert spans1[-1]["retcode"] & 0x800
        spans0, _ = w.ranks[0].trace_read()
        assert spans0 and spans0[-1]["retcode"] & 0x800
    finally:
        w.close()


# ---------------------------------------------------------------------------
# the 30-seed kill fuzz: detect -> exclude -> re-certify -> reconfigure
# ---------------------------------------------------------------------------


def _fuzz_world_policy():
    pol = DeadlinePolicy(LinkParams(**LINK), world=4, floor_s=0.05)
    pol.arm_reference("allreduce", 0.3)
    return pol


def _allreduce_opts(n, comm_addr=0):
    return CallOptions(scenario=Operation.allreduce, count=n,
                       function=int(ReduceFunction.SUM), data_type=F32,
                       comm_addr=comm_addr)


@pytest.mark.parametrize("seed", range(30))
def test_kill_fuzz_recovery_certified_and_bitwise(lib, seed):
    """The reference fails here inside its lift (the replan). A random
    rank dies at a random point of the stream on a native world; the
    survivors (1) run a control that the armed guard leaves bitwise
    unchanged, (2) every survivor misses its derived deadline and
    attribute_silent names the victim within the retry budget, (3) the
    replan over the 3 survivors certifies with 0 diagnostics and installs
    generation 1, and (4) after flush_rx the recovery communicator's
    answers equal the numpy oracle over the survivors, bitwise."""
    rng = np.random.default_rng(7000 + seed)
    world = 4
    n = int(rng.choice([64, 256, 1024]))
    victim = int(rng.integers(world))
    kill_at = int(rng.integers(0, 3))  # healthy dispatches before death
    xs = torch.from_numpy(
        rng.integers(-32, 32, size=(world, n)).astype(np.float32))
    pol = _fuzz_world_policy()
    budget = RetryBudget(max_retries=1, backoff_base_s=0.01)
    mgr = ResilienceManager(world, policy=pol, budget=budget)
    guard = NativeDeadlineGuard(pol)
    full_oracle = xs.sum(0)

    w = EmuWorld(world, transport="local")
    try:
        def control(rank, i):
            guard.arm(rank, "allreduce", n)
            pairs = []
            for _k in range(kill_at):
                out = torch.zeros(n)
                h = rank.start(_allreduce_opts(n), op0=xs[i].clone(),
                               res=out)
                assert guard.wait(rank, h, "allreduce", n) is None
                plain = torch.zeros(n)
                rank.allreduce(xs[i].clone(), plain, n, ReduceFunction.SUM)
                pairs.append((out, plain))
            return pairs

        for pairs in w.run(control, timeout_s=RUN_S):
            for guarded, plain in pairs:
                assert torch.equal(guarded, full_oracle)
                assert torch.equal(guarded, plain)

        # death, and detection within the retry budget: one run per
        # attempt, threads joined between attempts, so the survivors stay
        # in lockstep and their frames land inside each other's calls
        w.ranks[victim].kill()
        action = None
        for attempt in range(budget.max_retries + 1):
            def one_attempt(rank, i):
                if i == victim:
                    return None
                guard.arm(rank, "allreduce", n)
                h = rank.start(_allreduce_opts(n), op0=xs[i].clone(),
                               res=torch.zeros(n))
                try:
                    guard.wait(rank, h, "allreduce", n)
                    return None
                except DeadlineMissedError as e:
                    return e.miss

            verdicts = w.run(one_attempt, timeout_s=RUN_S)
            reporters = [i for i, v in enumerate(verdicts) if v is not None]
            assert reporters == [r for r in range(world) if r != victim], \
                f"seed {seed} attempt {attempt}: {reporters}"
            assert all(verdicts[i].retcode & 0x800 for i in reporters)
            suspect = mgr.attribute_silent(reporters)
            assert suspect == victim
            rep = dataclasses.replace(verdicts[reporters[0]],
                                      suspect_rank=suspect,
                                      attribution="silent")
            action = mgr.record_miss(rep)
            if action == "exclude":
                break
        assert action == "exclude", f"seed {seed}: never excluded"
        survivors = mgr.exclude(victim)
        # the reconfiguration fence, on every survivor at once (each is
        # quiescent: the threads joined above)
        w.run(lambda rank, i: rank.flush_rx() if i != victim else None,
              timeout_s=RUN_S)

        rp = mgr.replan(Operation.allreduce, count=n)
        assert rp.certificate["diagnostics"] == 0
        assert rp.world == world - 1 and rp.source == "ring"
        mgr.install(rp)
        assert mgr.generation == 1

        addr = int(CCLOAddr.DYNAMIC_BASE)
        comm = Communicator(
            [Rank(device_index=g, session_id=g) for g in survivors], 0, addr)
        want = xs[list(survivors)].sum(0)

        def recover(rank, i):
            if i == victim:
                return None
            rank.write_communicator(comm)
            guard.arm(rank, "allreduce", n)
            outs = []
            for _k in range(2):
                out = torch.zeros(n)
                h = rank.start(_allreduce_opts(n, addr), op0=xs[i].clone(),
                               res=out)
                assert guard.wait(rank, h, "allreduce", n) is None
                outs.append(out)
            return outs

        for i, outs in enumerate(w.run(recover, timeout_s=RUN_S)):
            if i == victim:
                continue
            for out in outs:
                assert torch.equal(out, want), \
                    f"seed {seed}: post-recovery answer wrong on r{i}"
    finally:
        w.close()


def test_kill_levers_do_not_leak():
    assert not os.environ.get("ACCL_RT_FAULT_KILL_RANK")
    assert not os.environ.get("ACCL_RT_FAULT_KILL_AFTER")


# ---------------------------------------------------------------------------
# escalation: lossy link against dead rank (IntegrityFault)
# ---------------------------------------------------------------------------


DELTAS = [None, {}, {"nack_sent": 40, "nack_rx": 12, "ack_sent": 3},
          {"crc_drops": 1}, {"retx_sent": 2, "nack_sent": 9},
          {"dup_drops": 1}, {"retx_miss": 1},
          {"tx_frames": 500, "rx_frames": 480}, {"inj_loss": 3},
          {"rndzv_drops": 1}, {"rely_ns": 9000, "tx_batched": 4}]


def test_classify_wire_delta_lossy_vs_dark():
    """Against the reference's classifier on every delta shape."""
    cls = ResilienceManager.classify_wire_delta
    ref = ref_res.ResilienceManager.classify_wire_delta
    assert [cls(d) for d in DELTAS] == [ref(d) for d in DELTAS]
    assert cls(None) == cls({}) == "dark"
    assert cls({"nack_sent": 40, "nack_rx": 12, "ack_sent": 3}) == "dark"
    assert cls({"crc_drops": 1}) == "lossy"
    assert cls({"retx_sent": 2, "nack_sent": 9}) == "lossy"
    assert cls({"dup_drops": 1}) == cls({"retx_miss": 1}) == "lossy"
    assert cls({"tx_frames": 500, "rx_frames": 480}) == "dark"


def _miss(cls=DeadlineMissed, suspect=2):
    return cls(op="allreduce", count=1024, predicted_s=0.01,
               deadline_s=0.05, elapsed_s=0.2, suspect_rank=suspect)


def test_assess_miss_lossy_raises_integrity_not_budget():
    """The action sequence and the faults' verdicts equal the
    reference's."""
    lossy = {"crc_drops": 3, "dup_drops": 1, "retx_sent": 5,
             "retx_miss": 0, "nack_rx": 7, "nack_sent": 9}
    seq = [lossy, lossy, None, {"nack_sent": 3}]
    mgr = ResilienceManager(4, budget=RetryBudget(max_retries=1))
    ref = ref_res.ResilienceManager(4, budget=ref_res.RetryBudget(
        max_retries=1))
    got = [mgr.assess_miss(_miss(), d) for d in seq]
    want = [ref.assess_miss(_miss(ref_res.DeadlineMissed), d) for d in seq]
    assert got == want == ["integrity", "integrity", "retry", "exclude"]
    faults = mgr.integrity_faults
    assert len(faults) == 2
    f = faults[0]
    assert (f.op, f.count, f.suspect_rank) == ("allreduce", 1024, 2)
    assert f.crc_drops == 3 and f.retransmits == 5
    assert f.nack_round_trips == 7 and f.dup_drops == 1
    assert f.verdict() == ref.integrity_faults[0].verdict()
    assert str(f) == str(ref.integrity_faults[0])
    assert "no reconfiguration" in str(f)
    assert len(mgr.misses) == 4


def test_assess_miss_dark_delegates_to_record_miss():
    mgr = ResilienceManager(4, budget=RetryBudget(max_retries=2))
    dark = {"nack_sent": 12, "ack_rx": 4}
    assert [mgr.assess_miss(_miss(), dark) for _ in range(3)] == \
        ["retry", "retry", "exclude"]
    assert not mgr.integrity_faults


def test_observe_wire_health_returns_deltas_per_observer():
    mgr = ResilienceManager(4)
    ref = ref_res.ResilienceManager(4)
    feed = [(0, {"crc_drops": 5, "retx_sent": 2}),
            (0, {"crc_drops": 5, "retx_sent": 6}), (1, {"crc_drops": 1}),
            (0, {"crc_drops": 5, "retx_sent": 6})]
    got = [mgr.observe_wire_health(r, s) for r, s in feed]
    assert got == [ref.observe_wire_health(r, s) for r, s in feed]
    assert got[0] == {"crc_drops": 5, "retx_sent": 2}
    assert got[1] == {"crc_drops": 0, "retx_sent": 4}
    assert got[2] == {"crc_drops": 1}
    assert ResilienceManager.classify_wire_delta(got[1]) == "lossy"
    assert ResilienceManager.classify_wire_delta(got[3]) == "dark"


def test_integrity_fault_against_live_chaos_world(lib, monkeypatch):
    """A native world under seeded corruption: a fabricated miss assessed
    against the world's true wire deltas reads LOSSY, and the answers
    stay exact."""
    monkeypatch.setenv("ACCL_RT_FAULT_CORRUPT_PCT", "30")
    monkeypatch.setenv("ACCL_RT_FAULT_SEED", "3")
    w = EmuWorld(2, max_eager=1 << 20, rx_buf_bytes=256, transport="local")
    monkeypatch.delenv("ACCL_RT_FAULT_CORRUPT_PCT")
    monkeypatch.delenv("ACCL_RT_FAULT_SEED")
    try:
        mgr = ResilienceManager(2)
        for r in w.ranks:
            mgr.observe_wire_health(r.rank, r.wire_stats())

        def body(rank, i):
            out = torch.zeros(4096)
            rank.allreduce(torch.full((4096,), i + 1.0), out, 4096,
                           ReduceFunction.SUM)
            return out

        res = w.run(body, timeout_s=RUN_S)
        deltas = [mgr.observe_wire_health(r.rank, r.wire_stats())
                  for r in w.ranks]
    finally:
        w.close()
    for out in res:
        assert torch.equal(out, torch.full((4096,), 3.0))
    total = {k: sum(d.get(k, 0) for d in deltas) for k in deltas[0]}
    assert total["crc_drops"] > 0  # the chaos fired
    assert mgr.assess_miss(_miss(suspect=1), total) == "integrity"
    assert mgr.integrity_faults[0].crc_drops == total["crc_drops"]


def test_integrity_budget_bounds_the_lossy_credit():
    lossy = {"crc_drops": 1}
    mgr = ResilienceManager(4, budget=RetryBudget(max_retries=1),
                            integrity_budget=2)
    ref = ref_res.ResilienceManager(4, budget=ref_res.RetryBudget(
        max_retries=1), integrity_budget=2)
    got = [mgr.assess_miss(_miss(), lossy) for _ in range(4)]
    assert got == [ref.assess_miss(_miss(ref_res.DeadlineMissed), lossy)
                   for _ in range(4)]
    assert got == ["integrity", "integrity", "retry", "exclude"]
    assert len(mgr.integrity_faults) == 2
    mgr2 = ResilienceManager(4, integrity_budget=1)
    assert mgr2.assess_miss(_miss(), lossy) == "integrity"
    mgr2.note_recovery(2)
    assert mgr2.assess_miss(_miss(), lossy) == "integrity"
