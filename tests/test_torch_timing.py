"""The port's timing model against the JAX package's, float for float:
the cost shapes, the tiered and overlapped pipelines and their stripe
counts, the crossovers behind ACCL.autotune and the registers
TuningParams.from_crossovers makes of them, under the shipped model (the
port's copy of accl_log/timing_model.json) and a second link."""

import dataclasses

import pytest

import accl_tpu.constants as ref_c
import accl_tpu.sequencer.plan as ref_plan
import accl_tpu.sequencer.timing as ref_t
import accl_tpu.telemetry.feedback as ref_fb
import accl_tpu_torch.constants as port_c
import accl_tpu_torch.sequencer.plan as port_plan
import accl_tpu_torch.sequencer.timing as port_t
import accl_tpu_torch.telemetry.feedback as port_fb

WORLDS = [2, 4, 8, 16]
KW = dict(max_eager_size=1024, eager_rx_buf_size=1024)


def _links():
    """(reference, port) LinkParams pairs: the shipped emulator link and a
    fast one, where the latency terms dominate."""
    return [(ref_fb.default_link(), port_fb.default_link()),
            (ref_t.LinkParams(2e-6, 4e11), port_t.LinkParams(2e-6, 4e11))]


def test_shipped_model_loads_like_the_reference():
    assert dataclasses.astuple(port_fb.default_link()) == \
        dataclasses.astuple(ref_fb.default_link())
    rt, pt = ref_fb.default_tier_links(), port_fb.default_tier_links()
    assert dataclasses.astuple(pt.inner) == dataclasses.astuple(rt.inner)
    assert dataclasses.astuple(pt.outer) == dataclasses.astuple(rt.outer)
    assert dataclasses.astuple(port_fb.default_compute_fit()) == \
        dataclasses.astuple(ref_fb.default_compute_fit())
    assert port_fb.default_link(port_fb.MODEL_PATH.parent / "none.json") \
        is None


def _plans(world, count):
    """Same-rule plans of every family the cost model shapes, as
    (op, reference plan, port plan)."""
    out = []
    for op in ("allreduce", "allgather", "reduce_scatter", "bcast",
               "reduce", "gather", "scatter", "alltoall", "barrier"):
        for regs in ({}, dict(allreduce_composition_max_count=1 << 30),
                     dict(synth_allreduce_max_count=1 << 22,
                          synth_allgather_max_count=1 << 22,
                          synth_reduce_scatter_max_count=1 << 22)):
            rp = ref_plan.select_algorithm(
                ref_c.Operation[op], count, 4, world,
                tuning=ref_c.TuningParams(**regs), **KW)
            pp = port_plan.select_algorithm(
                port_c.Operation[op], count, 4, world,
                tuning=port_c.TuningParams(**regs), **KW)
            out.append((op, rp, pp))
    for s in (1, 2, 3):
        out.append(("allreduce",
                    ref_plan.Plan(ref_plan.Protocol.EAGER,
                                  ref_plan.Algorithm.HIER_RS_AR_AG, count,
                                  1, inner_world=2,
                                  outer_world=world // 2, stripes=s,
                                  outer_wire_dtype=ref_c.DataType.int8),
                    port_plan.Plan(port_plan.Protocol.EAGER,
                                   port_plan.Algorithm.HIER_RS_AR_AG, count,
                                   1, inner_world=2,
                                   outer_world=world // 2, stripes=s,
                                   outer_wire_dtype=port_c.DataType.int8)))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_cost_shapes_and_predictions(world):
    for count in (1, 256, 4099, 1 << 18, 1 << 22):
        for op, rp, pp in _plans(world, count):
            for agg in (False, True):
                rfn = ref_t.coefficients_aggregate if agg \
                    else ref_t.coefficients
                pfn = port_t.coefficients_aggregate if agg \
                    else port_t.coefficients
                assert pfn(port_c.Operation[op], pp, count, 4, world,
                           rx_buf_bytes=1024) == \
                    rfn(ref_c.Operation[op], rp, count, 4, world,
                        rx_buf_bytes=1024), (op, rp)
            for rl, pl in _links():
                assert port_t.predict(
                    pl, port_c.Operation[op], pp, count, 4, world,
                    rx_buf_bytes=1024) == ref_t.predict(
                        rl, ref_c.Operation[op], rp, count, 4, world,
                        rx_buf_bytes=1024)


@pytest.mark.parametrize("world", WORLDS)
def test_stripe_counts_and_pipelines(world):
    rtl, ptl = ref_fb.default_tier_links(), port_fb.default_tier_links()
    rfit, pfit = ref_fb.default_compute_fit(), port_fb.default_compute_fit()
    for count in (100, 4099, 1 << 16, 1 << 20, 6553600):
        for wires in ((0, 0), (1, 1), (0, 1), (3, 3)):
            rw = [ref_c.DataType(w) for w in wires]
            pw = [port_c.DataType(w) for w in wires]
            L, P = 2, world // 2
            if P > 1:
                assert port_t.best_stripes(
                    ptl, count, 4, L, P, inner_wire=pw[0],
                    outer_wire=pw[1]) == ref_t.best_stripes(
                        rtl, count, 4, L, P, inner_wire=rw[0],
                        outer_wire=rw[1])
        for (rl, pl) in _links():
            cs = rfit.seconds(count * 4)
            assert cs == pfit.seconds(count * 4)
            assert port_t.best_overlap_stripes(
                pl, count, 4, world, compute_s=cs, rx_buf_bytes=1024) == \
                ref_t.best_overlap_stripes(rl, count, 4, world,
                                           compute_s=cs, rx_buf_bytes=1024)
            for s in (1, 2, 8):
                rp = ref_plan.Plan(ref_plan.Protocol.EAGER,
                                   ref_plan.Algorithm.EAGER_RING_RS_AG,
                                   count, 1, stripes=s)
                pp = port_plan.Plan(port_plan.Protocol.EAGER,
                                    port_plan.Algorithm.EAGER_RING_RS_AG,
                                    count, 1, stripes=s)
                for serial in (False, True):
                    assert port_t.predict_overlapped(
                        pl, pp, count, 4, world, compute_s=cs,
                        rx_buf_bytes=1024, serial=serial) == \
                        ref_t.predict_overlapped(
                            rl, rp, count, 4, world, compute_s=cs,
                            rx_buf_bytes=1024, serial=serial)
    for _, rp, pp in _plans(world, 4099)[-3:]:
        assert port_t.hier_phase_costs(pp, 4099, 4) == \
            ref_t.hier_phase_costs(rp, 4099, 4)
        assert port_t.predict_tiered(ptl, pp, 4099, 4) == \
            ref_t.predict_tiered(rtl, rp, 4099, 4)


@pytest.mark.parametrize("world", WORLDS)
def test_tuning_crossovers_and_registers(world):
    """The crossovers and the registers made of them, exactly: flat, on
    the int8 wire, and with a declared two-tier topology."""
    rtl, ptl = ref_fb.default_tier_links(), port_fb.default_tier_links()
    rfit, pfit = ref_fb.default_compute_fit(), port_fb.default_compute_fit()
    topo = (2, world // 2) if world >= 4 else None
    for (rl, pl) in _links()[:1]:
        for wire in (0, 1):
            want = ref_t.tuning_crossovers(
                rl, world=world, wire_dtype=ref_c.DataType(wire),
                tier_links=rtl, topology=topo, compute_fit=rfit)
            got = port_t.tuning_crossovers(
                pl, world=world, wire_dtype=port_c.DataType(wire),
                tier_links=ptl, topology=topo, compute_fit=pfit)
            assert got == want
            assert vars(port_c.TuningParams.from_crossovers(got)) == \
                vars(ref_c.TuningParams.from_crossovers(want))


def test_from_crossovers_edges():
    """The clamps field for field: infinite and NaN thresholds cap, a
    zero composition stays off, over-cap MIN registers turn off."""
    base = ref_t.tuning_crossovers(ref_fb.default_link(), world=8)
    for extra in ({"gather_flat_tree_max_count_bytes": float("inf")},
                  {"reduce_flat_tree_max_count_bytes": float("nan")},
                  {"allreduce_composition_max_bytes": float("inf")},
                  {"allreduce_composition_max_bytes": 0},
                  {"hier_allreduce_min_bytes": 1 << 30,
                   "overlap_min_bytes": 1 << 23,
                   "alltoall_compress_min_bytes": 1 << 23},
                  {"synth_allreduce_max_bytes": 1 << 30}):
        cross = {**base, **extra}
        assert vars(port_c.TuningParams.from_crossovers(cross)) == \
            vars(ref_c.TuningParams.from_crossovers(cross))


def test_sequence_predictions_and_calibration():
    rl, pl = _links()[0]
    rfit, pfit = ref_fb.default_compute_fit(), port_fb.default_compute_fit()
    calls_r, calls_p = [], []
    for op, rp, pp in _plans(8, 4099)[:9]:
        calls_r.append((ref_c.Operation[op], rp, 4099, 4))
        calls_p.append((port_c.Operation[op], pp, 4099, 4))
    for kw in (dict(), dict(fused=False, dispatch_alpha=3e-5),
               dict(compute_s=rfit.seconds(16396)), dict(aggregate=True)):
        assert port_t.predict_sequence(pl, calls_p, 8, rx_buf_bytes=1024,
                                       **kw) == \
            ref_t.predict_sequence(rl, calls_r, 8, rx_buf_bytes=1024, **kw)
    samples = [(1.0, 1e3, 2e-6), (4.0, 1e6, 1e-3), (9.0, 3e7, 2e-2)]
    assert dataclasses.astuple(port_t.calibrate(samples)) == \
        dataclasses.astuple(ref_t.calibrate(samples))
    cs = [(1e3, 1e-3), (1e6, 4e-3), (1e8, 0.3)]
    assert dataclasses.astuple(port_t.calibrate_compute(cs)) == \
        dataclasses.astuple(ref_t.calibrate_compute(cs))
    assert dataclasses.astuple(pfit) == dataclasses.astuple(rfit)
