"""Plan selection of the PyTorch port against the JAX package: identical
Plans under the default registers, in the register-opened windows and
for the degraded live-subset allreduce."""

import dataclasses

import pytest

import accl_tpu.constants as ref_c
import accl_tpu.sequencer.plan as ref_plan
import accl_tpu_torch.constants as port_c
import accl_tpu_torch.sequencer.plan as port_plan

COUNTS = [1, 255, 256, 329, 4096, 1 << 20]
WORLDS = [1, 2, 3, 5, 8]
DTYPES = ["float32", "float64", "int32", "int64", "float16", "bfloat16"]
KW = dict(max_eager_size=1024, eager_rx_buf_size=1024)


def _plain(plan):
    """A Plan as nested plain values (enums as ints) for comparison."""
    out = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "stages":
            v = tuple(_plain(s) for s in v)
        elif isinstance(v, int):
            v = int(v)
        out[f.name] = v
    return out


def _both(op, count, dtype, world, compressed=None, tuning=None, **extra):
    nbytes = port_c.dtype_nbytes(port_c.DataType[dtype])
    comp = 8 if compressed else 0
    cdt = int(port_c.DataType[compressed]) if compressed else 0
    ref = ref_plan.select_algorithm(
        ref_c.Operation[op], count, nbytes, world,
        ref_c.CompressionFlags(comp), compress_dtype=ref_c.DataType(cdt),
        tuning=tuning[0] if tuning else ref_c.TuningParams.default(),
        **KW, **extra)
    port = port_plan.select_algorithm(
        port_c.Operation[op], count, nbytes, world,
        port_c.CompressionFlags(comp), compress_dtype=port_c.DataType(cdt),
        tuning=tuning[1] if tuning else port_c.TuningParams.default(),
        **KW, **extra)
    return ref, port


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_plan_sweep(world, dtype):
    for count in COUNTS:
        ref, port = _both("allreduce", count, dtype, world)
        assert _plain(port) == _plain(ref), (count, world, dtype)
        assert port.algorithm.name in ("EAGER_RING_RS_AG", "NONE")


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
@pytest.mark.parametrize("world", WORLDS)
def test_compressed_allreduce_plan_sweep(world, wire):
    for count in COUNTS:
        ref, port = _both("allreduce", count, "float32", world, compressed=wire)
        assert _plain(port) == _plain(ref)
        assert int(port.wire_dtype) == int(port_c.DataType[wire]) or world == 1


@pytest.mark.parametrize("op", ["bcast", "scatter", "gather", "allgather",
                                "reduce", "reduce_scatter", "alltoall",
                                "send", "recv", "barrier", "copy", "combine"])
def test_other_collectives_plan_sweep(op):
    for world in WORLDS:
        for count in COUNTS:
            for dtype in ("float32", "int64", "bfloat16"):
                ref, port = _both(op, count, dtype, world)
                assert _plain(port) == _plain(ref), (op, count, world, dtype)


def test_alltoallv_capacity_plan():
    for counts in [(5, 7, 3, 8), (8, 8, 8, 8)]:
        ref, port = _both("alltoall", 8, "float32", 4, peer_counts=counts)
        assert _plain(port) == _plain(ref)


def _tuning(**regs):
    return ref_c.TuningParams(**regs), port_c.TuningParams(**regs)


@pytest.mark.parametrize("regs,extra,slice_name", [
    (dict(hier_allreduce_min_count=1024), dict(topology=(2, 4)),
     "hierarchical"),
    (dict(synth_allreduce_max_count=1 << 20), {}, "synthesized"),
    (dict(synth_latency_max_count=1 << 20), {}, "synthesized"),
    (dict(overlap_min_count=1024), {}, "overlapped"),
    ({}, dict(live_ranks=(0, 1, 2)), "resilience"),
])
def test_later_slice_branches_raise(regs, extra, slice_name):
    """The branches of the later slices, each ported: the degraded
    live-subset ring (resilience), the two-tier, synthesized (standard
    and latency grid) and overlapped branches give the reference's Plan
    field for field on the same registers."""
    if slice_name == "resilience":
        for count in (1, 255, 65536, 1 << 20):
            for world, live in ((8, (0, 1, 2)), (5, (4,)), (3, (0, 2))):
                ref, port = _both("allreduce", count, "float32", world,
                                  live_ranks=live)
                assert _plain(port) == _plain(ref), (count, world, live)
                assert port.live_ranks == live
        # a full survivor set is the ordinary allreduce
        ref, port = _both("allreduce", 4096, "float32", 4,
                          live_ranks=(0, 1, 2, 3))
        assert _plain(port) == _plain(ref) and not port.live_ranks
        return
    seen = set()
    for count in (256, 4096, 16384, 65536, 1 << 20, 6553600):
        ref, port = _both("allreduce", count, "float32", 8,
                          tuning=_tuning(**regs), **extra)
        assert _plain(port) == _plain(ref), (count, slice_name)
        seen.add((port.algorithm.name, port.stripes))
    want = {"hierarchical": "HIER_RS_AR_AG", "synthesized": "SYNTHESIZED",
            "overlapped": "EAGER_RING_RS_AG"}[slice_name]
    assert any(name == want and (s > 1 or slice_name != "overlapped")
               for name, s in seen)


@pytest.mark.parametrize("world", [2, 3, 5, 8])
@pytest.mark.parametrize("count", [300, 4096, 1 << 20])
def test_reduce_bcast_allreduce_plan(world, count):
    """The register-opened rendezvous reduce+bcast allreduce, field for
    field with the reference, stages included (flat or binomial reduce and
    bcast, re-selected with the live registers)."""
    for regs in (dict(allreduce_composition_max_count=1 << 30),
                 dict(allreduce_composition_max_count=1 << 30,
                      bcast_flat_tree_max_ranks=8,
                      reduce_flat_tree_max_ranks=1,
                      reduce_flat_tree_max_count=1)):
        ref, port = _both("allreduce", count, "float32", world,
                          tuning=_tuning(**regs))
        assert _plain(port) == _plain(ref)
        assert port.algorithm == port_plan.Algorithm.RNDZV_REDUCE_BCAST
        assert [s.algorithm.name for s in port.stages] == [
            s.algorithm.name for s in ref.stages]


def test_registers_outside_their_window_keep_the_ring():
    # a window that does not cover the payload selects exactly what the
    # reference selects (no raise): hier needs a topology, MIN registers
    # above the payload, MAX registers below it
    for regs, extra in [
        (dict(hier_allreduce_min_count=1024), {}),
        (dict(hier_allreduce_min_count=1 << 30), dict(topology=(2, 4))),
        (dict(overlap_min_count=1 << 30), {}),
        (dict(synth_allreduce_max_count=16), {}),
        (dict(allreduce_composition_max_count=16), {}),
    ]:
        ref, port = _both("allreduce", 65536, "float32", 8,
                          tuning=_tuning(**regs), **extra)
        assert _plain(port) == _plain(ref)
        assert port.algorithm == port_plan.Algorithm.EAGER_RING_RS_AG


def test_enums_match():
    for name in ("Protocol", "Algorithm"):
        ref = {m.name: int(m) for m in getattr(ref_plan, name)}
        port = {m.name: int(m) for m in getattr(port_plan, name)}
        assert port == ref
    assert ([f.name for f in dataclasses.fields(port_plan.Plan)]
            == [f.name for f in dataclasses.fields(ref_plan.Plan)])


def test_step_widths_match_reference():
    """The operand-width rules the device's launch uses (count * world
    for the stacked-chunk inputs and the gathered outputs)."""
    from accl_tpu.descriptor import CallOptions as RefOpts
    from accl_tpu.sequencer import sequence as ref_seq
    from accl_tpu_torch.descriptor import CallOptions
    from accl_tpu_torch.sequencer import sequence as port_seq

    for op in port_c.Operation:
        for world in (1, 5, 8):
            ref = RefOpts(scenario=ref_c.Operation[op.name], count=17)
            port = CallOptions(scenario=op, count=17)
            assert (port_seq.step_in_elems(port, world),
                    port_seq.step_out_elems(port, world)) == (
                ref_seq.step_in_elems(ref, world),
                ref_seq.step_out_elems(ref, world)), (op, world)


@pytest.mark.parametrize("world,topo", [(2, None), (4, None), (5, None),
                                        (8, None), (16, None), (8, (4, 2)),
                                        (8, (2, 4)), (16, (4, 4))])
def test_tuned_register_windows_plan_sweep(world, topo):
    """The registers ACCL.autotune writes from the shipped model open
    every window at once: Plans field for field with the reference's, per
    op, count and dtype, with the int8 tier wires on a two-tier world."""
    import accl_tpu.sequencer.timing as ref_t
    import accl_tpu.telemetry.feedback as ref_fb

    cross = ref_t.tuning_crossovers(
        ref_fb.default_link(), world=world,
        tier_links=ref_fb.default_tier_links(), topology=topo,
        compute_fit=ref_fb.default_compute_fit())
    tuning = (ref_c.TuningParams.from_crossovers(cross),
              port_c.TuningParams.from_crossovers(cross))
    wires = {}
    if topo is not None:
        wires = dict(tier_wires=(1, 1))
    for op in ("allreduce", "allgather", "reduce_scatter"):
        for count in (1, 200, 1000, 4096, 1 << 14, 65536, 300001, 1 << 20,
                      6553600):
            for dtype in ("float32", "float64", "int32"):
                ref, port = _both(op, count, dtype, world, tuning=tuning,
                                  topology=topo, **wires)
                assert _plain(port) == _plain(ref), (op, count, dtype)


def test_overlap_stripes_are_the_chains_the_lowering_runs():
    """count 100 at W = 8 under a compute-bound calibration: the argmin is
    8 stripes, world-aligning the stripe segment to 16 merges the tail
    into 7 chains, and the frozen Plan says 7, as the reference's; the
    ring-kernel body then runs exactly 7 kernel calls (its plain version
    on the CPU), one chain per stripe on the one stream."""
    import accl_tpu.sequencer.timing as ref_t
    import accl_tpu_torch.sequencer.timing as port_t
    from accl_tpu_torch.ops import ring_allreduce as port_ring
    from accl_tpu_torch.sequencer.lowering import ScheduleCompiler
    from accl_tpu_torch.descriptor import CallOptions
    import torch

    cal = [dict(overlap_link=t.LinkParams(1e-7, 1e9),
                overlap_compute=t.ComputeFit(1e-3, 1e5))
           for t in (ref_t, port_t)]
    tuning = _tuning(overlap_min_count=4)
    ref = ref_plan.select_algorithm(
        ref_c.Operation.allreduce, 100, 4, 8, tuning=tuning[0], **KW,
        **cal[0])
    port = port_plan.select_algorithm(
        port_c.Operation.allreduce, 100, 4, 8, tuning=tuning[1], **KW,
        **cal[1])
    assert _plain(port) == _plain(ref)
    assert (port.stripes, port.seg_count, port.num_segments) == (7, 16, 7)
    comp = ScheduleCompiler(8, torch.device("cpu"), use_ring_kernel=True)
    opts = CallOptions(scenario=port_c.Operation.allreduce, count=100,
                       function=0, data_type=port_c.DataType.float32)
    calls = []
    real = port_ring.ring_allreduce_bidir

    def spy(y, world, func, slot=0, out=None):
        calls.append((y.shape[1], slot))
        return real(y, world, func, slot=slot, out=out)

    port_ring.ring_allreduce_bidir = spy
    try:
        x = torch.randn(8, 100)
        out = comp.lower(opts, port)(x)
    finally:
        port_ring.ring_allreduce_bidir = real
    assert calls == [(16, i % 2) for i in range(6)] + [(4, 0)]
    torch.testing.assert_close(out, x.sum(0).expand(8, 100), rtol=1e-5,
                               atol=1e-5)


def test_wire_arbitration_is_the_references():
    """select_wire and select_tier_wires pick the reference's wires under
    the shipped calibration, across sizes, worlds and topologies."""
    import accl_tpu.telemetry.feedback as ref_fb
    import accl_tpu_torch.telemetry.feedback as port_fb

    for world in (2, 4, 8):
        for count in (256, 65536, 1 << 20, 1 << 23):
            for quant in (True, False):
                want = ref_plan.select_wire(
                    ref_c.Operation.allreduce, count,
                    ref_c.DataType.float32, world, ref_fb.default_link(),
                    rx_buf_bytes=1024, tuning=ref_c.TuningParams(),
                    quantized_ok=quant, **KW)
                got = port_plan.select_wire(
                    port_c.Operation.allreduce, count,
                    port_c.DataType.float32, world, port_fb.default_link(),
                    rx_buf_bytes=1024, tuning=port_c.TuningParams(),
                    quantized_ok=quant, **KW)
                assert int(got) == int(want)
    for topo in ((4, 2), (2, 4), (2, 2)):
        for count in (256, 1 << 18, 1 << 22):
            for quant in (True, False):
                want = ref_plan.select_tier_wires(
                    count, ref_c.DataType.float32, topo,
                    ref_fb.default_tier_links(), quantized_ok=quant)
                got = port_plan.select_tier_wires(
                    count, port_c.DataType.float32, topo,
                    port_fb.default_tier_links(), quantized_ok=quant)
                assert [int(w) for w in got] == [int(w) for w in want]


@pytest.mark.parametrize("count", [8192, 65536])
def test_tiered_synth_ok_pins_the_composition(count):
    """The lint sweep's hier rows: at W 8 on (2, 4) under a WAN-class
    outer link the in-window arbitration picks the tiered library entry;
    `tiered_synth_ok=False` pins the striped composition, in both
    packages."""
    import accl_tpu.sequencer.timing as ref_t
    import accl_tpu_torch.sequencer.timing as port_t

    tuning = (ref_c.TuningParams(hier_allreduce_min_count=1),
              port_c.TuningParams(hier_allreduce_min_count=1))
    links = {"ref": ref_t.TierLinks(inner=ref_t.LinkParams(2e-6, 2e9),
                                    outer=ref_t.LinkParams(300e-6, 0.25e9)),
             "port": port_t.TierLinks(
                 inner=port_t.LinkParams(2e-6, 2e9),
                 outer=port_t.LinkParams(300e-6, 0.25e9))}
    for ok, algo in ((True, "SYNTHESIZED"), (False, "HIER_RS_AR_AG")):
        ref = ref_plan.select_algorithm(
            ref_c.Operation.allreduce, count, 4, 8, tuning=tuning[0],
            topology=(2, 4), tier_links=links["ref"], tiered_synth_ok=ok,
            **KW)
        port = port_plan.select_algorithm(
            port_c.Operation.allreduce, count, 4, 8, tuning=tuning[1],
            topology=(2, 4), tier_links=links["port"], tiered_synth_ok=ok,
            **KW)
        assert _plain(port) == _plain(ref), (count, ok)
        assert port.algorithm.name == algo, (count, ok)
        if ok:
            assert port.synth_key == "allreduce_w8_t2x4_lg_exchange_d1_o1_2"
