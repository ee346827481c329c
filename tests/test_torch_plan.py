"""Plan selection of the PyTorch port against the JAX package: identical
Plans under the default registers, and NotImplementedError (never a
silent substitute) wherever the reference would enter a branch whose
slice is not ported yet."""

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
    tuning = _tuning(**regs)[1] if regs else port_c.TuningParams.default()
    with pytest.raises(NotImplementedError, match=slice_name):
        port_plan.select_algorithm(
            port_c.Operation.allreduce, 65536, 4, 8, tuning=tuning,
            **KW, **extra)


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
