"""The port's synthesized-schedule library against the JAX package's:
entry selection over every cell, the cost shapes and hand-written
baselines, and every lowered entry bitwise with the reference's compiled
program on the same numpy inputs (W <= 8: the reference's
ScheduleCompiler on the CPU mesh, the JAX facade's compiler; W = 16,
beyond the mesh's 8 devices: the reference's lowered body jitted under
vmap, and its hopdag.execute for the exact entries)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import accl_tpu.constants as ref_c
import accl_tpu.telemetry.feedback as ref_fb
from accl_tpu.analysis import hopdag as ref_hopdag
from accl_tpu.sequencer import plan as ref_plan
from accl_tpu.sequencer import synthesis as ref_synth
from accl_tpu.sequencer.lowering import ScheduleCompiler as RefCompiler
import accl_tpu_torch.constants as port_c
import accl_tpu_torch.telemetry.feedback as port_fb
from accl_tpu_torch.analysis import hopdag
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.sequencer import plan as port_plan
from accl_tpu_torch.sequencer import synthesis
from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

KEYS = sorted(ref_synth.library())
SMALL = [k for k in KEYS if synthesis.entry_for_key(k).spec.world <= 8]
W16 = [k for k in KEYS if synthesis.entry_for_key(k).spec.world == 16]


def _count(spec) -> int:
    """A per-rank count that is no multiple of the chunking (the padded
    path of the chunked families) and spans several int8 blocks."""
    return 77 if spec.op == "reduce_scatter" else 1021


def _inputs(spec, count, seed):
    rng = np.random.default_rng(seed)
    width = count * (spec.world if spec.op == "reduce_scatter" else 1)
    return (rng.standard_normal((spec.world, width)) * 3).astype(np.float32)


def _port_body(key, spec, count, func):
    plan = port_plan.Plan(port_plan.Protocol.EAGER,
                          port_plan.Algorithm.SYNTHESIZED, count, 1,
                          synth_key=key)
    opts = CallOptions(scenario=port_c.Operation[spec.op], count=count,
                       function=func, data_type=port_c.DataType.float32)
    return ScheduleCompiler(spec.world, torch.device("cpu")).lower(opts,
                                                                   plan)


def _ref_plan_opts(key, spec, count, func):
    plan = ref_plan.Plan(ref_plan.Protocol.EAGER,
                         ref_plan.Algorithm.SYNTHESIZED, count, 1,
                         synth_key=key)
    from accl_tpu.descriptor import CallOptions as RefOptions

    opts = RefOptions(scenario=ref_c.Operation[spec.op], count=count,
                      function=func, data_type=ref_c.DataType.float32)
    return plan, opts


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(
        got.numpy().view(np.int32), want.view(np.int32))


def test_select_entry_over_every_cell():
    sizes = sorted(set(synthesis.SIZE_GRID + synthesis.SIZE_GRID_LAT
                       + (1, 1000, 3 << 20, 1 << 25)))
    assert synthesis.SIZE_GRID == ref_synth.SIZE_GRID
    assert synthesis.SIZE_GRID_LAT == ref_synth.SIZE_GRID_LAT
    for op in ("allreduce", "allgather", "reduce_scatter", "bcast"):
        for world in (2, 3, 4, 5, 8, 16):
            for tiers in ((), (2, 4), (4, 2), (4, 4), (2, 8)):
                for wire in ("", "int8"):
                    for grid in ("std", "lat"):
                        for b in sizes:
                            assert synthesis.select_entry(
                                port_c.Operation[op], world, b, wire=wire,
                                tiers=tiers, grid=grid) == \
                                ref_synth.select_entry(
                                    ref_c.Operation[op], world, b,
                                    wire=wire, tiers=tiers, grid=grid)


@pytest.mark.parametrize("key", KEYS)
def test_entry_costs_and_baselines(key):
    spec = synthesis.entry_for_key(key).spec
    ref_spec = ref_synth.entry_for_key(key).spec
    assert spec.to_json() == ref_spec.to_json()
    assert synthesis.canonical_count(spec) == \
        ref_synth.canonical_count(ref_spec)
    assert synthesis.grid_for(spec) == ref_synth.grid_for(ref_spec)
    link, ref_link = port_fb.default_link(), ref_fb.default_link()
    tl, ref_tl = port_fb.default_tier_links(), ref_fb.default_tier_links()
    for count in (1, 256, 1021, 1 << 18, 1 << 22):
        for agg in (False, True):
            assert synthesis.cost_shape(spec, count, 4, aggregate=agg) == \
                ref_synth.cost_shape(ref_spec, count, 4, aggregate=agg)
            assert synthesis.predict_spec(link, spec, count, 4,
                                          aggregate=agg) == \
                ref_synth.predict_spec(ref_link, ref_spec, count, 4,
                                       aggregate=agg)
        if spec.tiers:
            assert synthesis.hop_layout(spec) == ref_synth.hop_layout(ref_spec)
            assert synthesis.tiered_phase_costs(spec, count, 4) == \
                ref_synth.tiered_phase_costs(ref_spec, count, 4)
            assert synthesis.predict_spec_tiered(tl, spec, count, 4) == \
                ref_synth.predict_spec_tiered(ref_tl, ref_spec, count, 4)
            assert synthesis.hand_written_tiered_best(
                tl, count, 4, spec.tiers) == \
                ref_synth.hand_written_tiered_best(ref_tl, count, 4,
                                                   ref_spec.tiers)
    assert synthesis.hand_written_best(
        link, spec.scenario, 1021, 4, spec.world, wire=spec.wire) == \
        ref_synth.hand_written_best(ref_link, ref_spec.scenario, 1021, 4,
                                    spec.world, wire=spec.wire)


@pytest.mark.parametrize("key", SMALL)
def test_lowered_entry_bitwise_with_the_jax_facade(key):
    """Every W <= 8 entry at a count off its chunking, SUM; the exchange
    and ring-tiered families under MAX too; int8 entries through their
    own encode/decode nodes (the decode -> fold pairs fused like the
    jitted reference)."""
    spec = synthesis.entry_for_key(key).spec
    count = _count(spec)
    mesh = Mesh(np.array(jax.devices()[:spec.world]), ("ccl",))
    funcs = (0, 1) if spec.family in ("exchange",) and not spec.wire \
        else (0,)
    for func in funcs:
        x = _inputs(spec, count, seed=len(key) + func)
        plan, opts = _ref_plan_opts(key, spec, count, func)
        want = RefCompiler(mesh).lower(opts, plan)(x)
        got = _port_body(key, spec, count, func)(torch.from_numpy(x))
        assert _same(got, want), (key, func)


@pytest.mark.parametrize("key", W16)
def test_lowered_w16_entry_bitwise_with_the_reference_body(key):
    spec = synthesis.entry_for_key(key).spec
    count = _count(spec)
    x = _inputs(spec, count, seed=16)
    plan, opts = _ref_plan_opts(key, spec, count, 0)
    body, _ = ref_synth.lower_plan(plan, opts, 16, "ccl")
    want = jax.jit(jax.vmap(body, axis_name="ccl"))(x)
    got = _port_body(key, spec, count, 0)(torch.from_numpy(x))
    assert _same(got, want)
    if not spec.wire and not spec.tiers and spec.family != "rs_ag":
        dag = ref_synth.instantiate(ref_synth.entry_for_key(key).spec,
                                    count)
        oracle = np.stack(ref_hopdag.execute(dag, [[x[r]]
                                                   for r in range(16)]))
        assert _same(got, oracle)


def test_lowering_guards():
    """A plan naming an entry of another world or collective raises, and
    a DAG with a cross-rank piece reference neither lowers nor yields a
    launch plan (the reference's test_lower_dag_rejects_cross_rank_
    reference); the search and certification run (test_torch_certify.py
    holds them against the reference)."""
    spec = synthesis.entry_for_key("allreduce_w4_exchange_d1_2").spec
    plan = port_plan.Plan(port_plan.Protocol.EAGER,
                          port_plan.Algorithm.SYNTHESIZED, 64, 1,
                          synth_key=spec.key)
    opts = CallOptions(scenario=port_c.Operation.allreduce, count=64,
                       function=0, data_type=port_c.DataType.float32)
    with pytest.raises(synthesis.SynthesisError, match="world"):
        synthesis.lower_plan(plan, opts, 8)
    opts_ag = CallOptions(scenario=port_c.Operation.allgather, count=64,
                          function=0, data_type=port_c.DataType.float32)
    with pytest.raises(synthesis.SynthesisError, match="implements"):
        synthesis.lower_plan(plan, opts_ag, 4)
    with pytest.raises(synthesis.SynthesisError, match="no synthesized"):
        synthesis.entry_for_key("allreduce_w3_nothing")
    dag = synthesis.instantiate(spec, 64)
    victim = next(n for n in dag.nodes
                  if any(pc.node != hopdag.CONST for pc in n.value))
    other = next(n for n in dag.nodes if n.rank != victim.rank)
    value = tuple(pc if pc.node == hopdag.CONST
                  else dataclasses.replace(pc, node=other.id)
                  for pc in victim.value)
    bad = dataclasses.replace(dag, nodes=tuple(
        dataclasses.replace(n, value=value) if n.id == victim.id else n
        for n in dag.nodes))
    for fn in (synthesis.lower_dag, synthesis.round_launches):
        with pytest.raises(synthesis.SynthesisError, match="cross-rank"):
            fn(bad)
