"""The port's lifting half against the reference's: the lifter over the
port's own schedule bodies, the recorded hops, and the cached entry
points of the default lint tier.

- The family grid of the reference's tests/test_semantics.py (26 calls;
  the port keeps its copy as `corpus.FAMILY_GRID`, held equal here):
  each call's lifted DAG certifies clean; `hopdag.execute` of it equals
  the port's own lowering of the call (the compiler the CPU facade
  dispatches) and the reference's lifted DAG (exact wires bitwise, int8
  and cast wires within the reference's bound); where the reference's
  own lift fails here (`UnsupportedSchedule: primitive 'jit' over
  abstract payload`), the port's DAG is held against a numpy oracle
  instead. `trace_schedule_hops` equals the reference's hop for hop,
  pair order included. Mutants (seeds 3-8, the reference's kind rule)
  never disagree with execution.
- The probe set (allreduce, allgather, reduce_scatter, bcast, scatter,
  gather, reduce, alltoall at W 2/4/5/8, counts 7 and 1000): hop lists
  equal the reference's, and each DAG certifies clean and computes the
  numpy oracle; where the reference's certify_call fails, the port's
  verdict and DAG stand on execution and the oracle alone. No call needs
  a hop-order departure.
- Segments: the reference maps more than 8 bulk segments with one
  lax.map body, whose hops its trace shows once; the port's full trace
  marks the others as repeats, and its DAG holds every segment; a trace
  for the hops alone evaluates the mapped body once.
- certify_call caches by signature, an UnsupportedSchedule is a skip
  (strict: a raise), the in-band budget defers a huge segmented call, an
  unmodelled op raises naming it, and the lift touches no CUDA device.
- Plans that lower through `_permute`: a synthesized entry and the
  striped two-tier allreduce lift, certify and execute like their
  lowering.
"""

import importlib.util
import pathlib
import random

import numpy as np
import pytest
import torch

import accl_tpu.constants as ref_c
import accl_tpu_torch.constants as port_c
from accl_tpu.analysis import hopdag as ref_hopdag
from accl_tpu.analysis import protocol as ref_protocol
from accl_tpu.analysis import semantics as ref_sem
from accl_tpu_torch.analysis import corpus, hopdag, protocol, semantics
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device.gpu_device import GPUDevice

_REF_TESTS = pathlib.Path(__file__).resolve().parent / "test_semantics.py"


def _ref_module():
    spec = importlib.util.spec_from_file_location("_ref_semantics_tests",
                                                  _REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _ref_module()
GRID = list(corpus.FAMILY_GRID)
MUTATION_CODE = {"drop_combine": "ACCL502", "duplicate_combine": "ACCL503",
                 "reorder_combine": "ACCL504", "swap_send_values": "ACCL501"}
PROBE_OPS = ("allreduce", "allgather", "reduce_scatter", "bcast",
             "scatter", "gather", "reduce", "alltoall")


def _grid_id(cfg):
    scen, count, world, kw = cfg
    tags = "-".join(f"{k}{getattr(v, 'name', v)}" for k, v in kw.items())
    return f"{scen.name}-{count}-w{world}" + (f"-{tags}" if tags else "")


def _ref_call(scen, count, world, **kw):
    """The same call through the reference test grid's `_opts_plan`."""
    trees = kw.pop("trees", False)
    conv = {}
    for k, v in kw.items():
        if k == "func":
            v = ref_c.ReduceFunction(int(v))
        elif k == "wire":
            v = ref_c.DataType(int(v))
        conv[k] = v
    if trees:
        conv["tuning"] = REF._TREES
    return REF._opts_plan(ref_c.Operation(int(scen)), count, world, **conv)


def _quantized(kw) -> bool:
    return kw.get("wire") == port_c.DataType.int8


def _oracle(opts, xs, world):
    """Numpy reference of the declared collective; None where the
    collective leaves a rank's output unspecified."""
    scen, count = opts.scenario, opts.count
    root = opts.root_src_dst
    red = (np.max if opts.function == int(port_c.ReduceFunction.MAX)
           else np.sum)
    op = port_c.Operation
    if scen == op.alltoall and opts.peer_counts:
        out = []
        for r in range(world):
            v = opts.peer_counts[r]
            row = np.zeros(world * count, np.float32)
            for c in range(world):
                row[c * count:c * count + v] = \
                    xs[c][r * count:r * count + v]
            out.append(row)
        return out
    if scen == op.combine:
        return [red(np.stack([xs[r], xs[r]]), axis=0) for r in range(world)]
    return REF._oracle(ref_c.Operation(int(scen)), [[x] for x in xs],
                       world, count, root,
                       ref_c.ReduceFunction(int(opts.function)))


def _payloads(rng, world, elems, quantized):
    return [ops[0] for ops in REF._payloads(rng, world, 1, elems, quantized)]


def _bound(xs, world):
    return (world + 1) * world * max(float(np.abs(x).max()) for x in xs) \
        / 254.0 + 1e-5


def _close(got, want, quantized, bound):
    if quantized:
        return np.allclose(got, want, rtol=0, atol=bound)
    return np.array_equal(got, want)


def _lowered(opts, plan, world, xs):
    """The call through the port's own lowering, as the CPU facade runs
    it (the torch-op bodies)."""
    comp = GPUDevice(world, "cpu").compiler
    x = torch.from_numpy(np.stack(xs))
    return comp.lower(opts, plan)(x).numpy()


def _execute(dag, xs):
    return hopdag.execute(dag, [[x] for x in xs])


def _check_against_oracle(opts, dag, xs, world, quantized):
    want = _oracle(opts, xs, world)
    bound = _bound(xs, world)
    outs = _execute(dag, xs)
    for r in range(world):
        if want[r] is not None:
            assert _close(outs[r][:len(want[r])], want[r], quantized,
                          bound), r
    return outs


# ---------------------------------------------------------------------------
# the family grid
# ---------------------------------------------------------------------------


def test_family_grid_is_the_references():
    assert len(GRID) == len(REF._FAMILY_GRID) == 26
    for (scen, count, world, kw), (rs, rc, rw, rkw) in zip(
            GRID, REF._FAMILY_GRID):
        assert (scen.name, count, world) == (rs.name, rc, rw)
        trees = kw.get("trees", False)
        assert trees == ("tuning" in rkw)
        if trees:
            assert vars(port_c.TuningParams(**corpus._TREES)) == \
                vars(rkw["tuning"])
        rest = {k: getattr(v, "name", v) for k, v in kw.items()
                if k != "trees"}
        assert rest == {k: getattr(v, "name", v) for k, v in rkw.items()
                        if k != "tuning"}


@pytest.mark.parametrize("cfg", GRID, ids=_grid_id)
def test_family_lift_certifies_clean(cfg):
    scen, count, world, kw = cfg
    opts, plan = corpus.family_call(scen, count, world, **kw)
    dag = semantics.lift_call(opts, plan, world)
    assert hopdag.validate_order(dag) == []
    assert semantics.certify(dag, semantics.collective_spec(opts, world),
                             scen.name) == []


@pytest.mark.parametrize("cfg", GRID, ids=_grid_id)
def test_family_lift_executes_faithfully(cfg):
    """execute(port DAG) == the port's lowering (bitwise on exact and
    cast wires, within the bound on int8, whose lowering fuses the
    decode into the fold) and == execute(reference DAG) (bitwise), or
    the oracle where the reference's lift fails."""
    scen, count, world, kw = cfg
    quantized = _quantized(kw)
    opts, plan = corpus.family_call(scen, count, world, **kw)
    dag = semantics.lift_call(opts, plan, world)
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(dag.in_elems).astype(np.float32)
          for _ in range(world)]
    outs = np.stack(_execute(dag, xs))
    low = _lowered(opts, plan, world, xs)
    assert _close(outs[:, :low.shape[-1]], low, quantized, _bound(xs, world))
    if not quantized:
        assert np.array_equal(outs[:, :low.shape[-1]], low)
    ro, rp = _ref_call(scen, count, world, **dict(kw))
    try:
        rdag = ref_sem.lift_call(ro, rp, world)
    except ref_sem.UnsupportedSchedule:
        # the reference's lift fails here: the oracle stands in
        ints = _payloads(rng, world, dag.in_elems, quantized)
        _check_against_oracle(opts, dag, ints, world, quantized)
        return
    routs = ref_hopdag.execute(rdag, [[x] for x in xs])
    for r in range(world):
        assert np.array_equal(outs[r], routs[r]), r


@pytest.mark.parametrize("cfg", GRID, ids=_grid_id)
def test_family_hops_match_reference(cfg):
    scen, count, world, kw = cfg
    opts, plan = corpus.family_call(scen, count, world, **kw)
    ro, rp = _ref_call(scen, count, world, **dict(kw))
    assert protocol.trace_schedule_hops(opts, plan, world) == \
        ref_protocol.trace_schedule_hops(ro, rp, world)


@pytest.mark.parametrize("cfg", GRID, ids=_grid_id)
def test_family_mutants_agree_with_execution(cfg):
    """Seeds 3-8, the reference's fuzz rule: a mutant the certifier
    passes computes the oracle's values; a flagged one carries its class
    code, and a flagged drop/duplicate/swap under SUM computes wrong
    values."""
    scen, count, world, kw = cfg
    quantized = _quantized(kw)
    opts, plan = corpus.family_call(scen, count, world, **kw)
    dag = semantics.lift_call(opts, plan, world)
    spec = semantics.collective_spec(opts, world)
    xs = _payloads(np.random.default_rng(3), world, dag.in_elems, quantized)
    want = _oracle(opts, xs, world)
    bound = _bound(xs, world)
    kinds = REF._applicable_mutations(dag, quantized)
    for seed in range(3, 9):
        if not kinds:
            break
        kind = kinds[seed % len(kinds)]
        mut = hopdag.mutate(dag, kind, random.Random(seed))
        if mut is None:
            continue
        codes = {d.code for d in semantics.certify(mut, spec, scen.name)}
        outs = _execute(mut, xs)
        broken = any(not _close(outs[r][:len(want[r])], want[r], quantized,
                                bound)
                     for r in range(world) if want[r] is not None)
        if not codes:
            assert not broken, (seed, kind)
            continue
        assert MUTATION_CODE[kind] in codes, (seed, kind, codes)
        if (opts.function == int(port_c.ReduceFunction.SUM)
                and kind in ("drop_combine", "duplicate_combine",
                             "swap_send_values")):
            assert broken, (seed, kind)


def test_strict_schedules_sweep_is_clean():
    assert [d for *_, d in corpus.schedules_sweep()] == [[]] * len(GRID)


# ---------------------------------------------------------------------------
# the probe set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", PROBE_OPS)
@pytest.mark.parametrize("world", [2, 4, 5, 8])
def test_probe_hops_and_verdicts(op, world):
    """Counts 7 and 1000: the hop lists are the reference's; the DAG
    certifies clean and computes the oracle (exact: bitwise, with unique
    integer payloads), whether or not the reference's certify_call runs
    on the call."""
    for count in (7, 1000):
        scen = port_c.Operation[op]
        opts, plan = corpus.family_call(scen, count, world)
        ro, rp = _ref_call(scen, count, world)
        trace, _, _ = protocol.trace_schedule_jaxpr(opts, plan, world,
                                                    semantic_marks=True)
        assert trace.complete
        hops = [h.perm for h in protocol.iter_ppermute_eqns(trace)]
        assert hops == ref_protocol.trace_schedule_hops(ro, rp, world), count
        assert semantics.certify(trace.dag,
                                 semantics.collective_spec(opts, world)) == []
        xs = _payloads(np.random.default_rng(count + world), world,
                       trace.dag.in_elems, False)
        _check_against_oracle(opts, trace.dag, xs, world, False)


def test_no_hop_order_departure_needs_a_record():
    """Where two hop lists differ only in order, simulate and the
    interleaving checker must agree over both (the rule a departure
    would be held to); over the probe set the lists are equal, which
    this checks on the ring allreduce at W 5 with its pairs reversed."""
    from accl_tpu_torch.analysis.linter import SequenceLinter
    from accl_tpu_torch.analysis.protocol import (
        rank_programs_from_hops,
        simulate,
    )

    opts, plan = corpus.family_call(port_c.Operation.allreduce, 1000, 5)
    hops = protocol.trace_schedule_hops(opts, plan, 5)
    flipped = [tuple(reversed(h)) for h in hops]
    for hl in (hops, flipped):
        progs = rank_programs_from_hops(hl, 5)
        assert simulate(progs, blocking_sends=False) == []
        assert SequenceLinter(5).check_interleavings(progs) == []


# ---------------------------------------------------------------------------
# segments, caching, budget, refusals
# ---------------------------------------------------------------------------


def test_mapped_segments_appear_once_in_the_trace():
    """10 bulk segments and a ragged tail at W 4: the reference maps the
    bulk with one body, so its trace shows the first segment's hops and
    the tail's; the port's DAG still folds every segment."""
    count = 256 * 10 + 5
    opts, plan = corpus.family_call(port_c.Operation.allreduce, count, 4)
    assert plan.seg_count == 256
    trace, _, _ = protocol.trace_schedule_jaxpr(opts, plan, 4,
                                                semantic_marks=True)
    assert len(trace.hops) == 11 * 6
    assert sum(h.repeat for h in trace.hops) == 9 * 6
    # recorded for its hops alone, the mapped body is evaluated once
    hops_only, _, _ = protocol.trace_schedule_jaxpr(opts, plan, 4)
    assert not hops_only.complete and len(hops_only.hops) == 2 * 6
    assert [h.perm for h in hops_only.hops] == [
        h.perm for h in protocol.iter_ppermute_eqns(trace)]
    ro, rp = _ref_call(port_c.Operation.allreduce, count, 4)
    assert protocol.trace_schedule_hops(opts, plan, 4) == \
        ref_protocol.trace_schedule_hops(ro, rp, 4)
    sends = sum(n.kind == "send" for n in trace.dag.nodes)
    assert sends == 11 * 6 * 4
    xs = _payloads(np.random.default_rng(0), 4, count, False)
    _check_against_oracle(opts, trace.dag, xs, 4, False)


def test_certify_call_caches_by_signature():
    semantics.clear_cache()
    opts, plan = corpus.family_call(port_c.Operation.allgather, 8, 4)
    assert semantics.certify_call(opts, plan, 4) == []
    before = len(semantics._CERT_CACHE)
    assert semantics.certify_call(opts, plan, 4) == []
    assert len(semantics._CERT_CACHE) == before == 1
    semantics.clear_cache()
    assert semantics._CERT_CACHE == {}


def test_unsupported_is_skip_not_claim(monkeypatch):
    def boom(*a, **kw):
        raise semantics.UnsupportedSchedule("planted")

    opts, plan = corpus.family_call(port_c.Operation.allreduce, 16, 4)
    monkeypatch.setattr(semantics, "certify_call", boom)
    assert semantics.check_batch_semantics([opts], [plan], 4) == []
    with pytest.raises(semantics.UnsupportedSchedule):
        semantics.check_batch_semantics([opts], [plan], 4, strict=True)


def test_inband_budget_defers_huge_segmented():
    opts, plan = corpus.family_call(port_c.Operation.allreduce, 1_000_000, 8)
    assert not semantics._within_inband_budget(opts, plan, 8)
    small_o, small_p = corpus.family_call(port_c.Operation.allreduce, 1024, 8)
    assert semantics._within_inband_budget(small_o, small_p, 8)
    # the reference draws the same line
    ro, rp = _ref_call(port_c.Operation.allreduce, 1_000_000, 8)
    assert not ref_sem._within_inband_budget(ro, rp, 8)


def test_an_unmodelled_op_raises_naming_it():
    def body(x):
        return torch.abs(x)

    with pytest.raises(semantics.UnsupportedSchedule, match="abs"):
        semantics._Lifter(4).run(body, 1, 8, torch.float32)


def test_lift_touches_no_cuda(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the lift reached CUDA")

    for name in ("current_stream", "synchronize", "Stream", "Event",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for scen, count, world, kw in GRID[-6:]:
        opts, plan = corpus.family_call(scen, count, world, **kw)
        assert semantics.certify(semantics.lift_call(opts, plan, world),
                                 semantics.collective_spec(opts, world)) == []


def test_alltoallv_dropped_tail_must_be_empty():
    """The dense exchange certified against the alltoallv spec leaks data
    into the dropped tails: ACCL501, as the reference's."""
    opts_v, _ = corpus.family_call(port_c.Operation.alltoall, 10, 4,
                                   peer_counts=(10, 3, 7, 1))
    opts, plan = corpus.family_call(port_c.Operation.alltoall, 10, 4)
    dense = semantics.lift_call(opts, plan, 4)
    codes = {d.code for d in semantics.certify(
        dense, semantics.collective_spec(opts_v, 4), "alltoall")}
    assert codes == {"ACCL501"}


def test_lifted_quantized_alltoallv_executes_faithfully():
    """The reference's test of the same name fails on its own lift here;
    the port's DAG meets it: routed prefixes within the per-block bound,
    dropped tails exactly zero, the local slot exact."""
    world, count, pc = 4, 300, (128, 300, 9, 64)
    opts, plan = corpus.family_call(port_c.Operation.alltoall, count, world,
                                    peer_counts=pc,
                                    wire=port_c.DataType.int8)
    dag = semantics.lift_call(opts, plan, world)
    rng = np.random.default_rng(19)
    xs = [rng.standard_normal(world * count).astype(np.float32)
          for _ in range(world)]
    outs = _execute(dag, xs)
    bound = max(np.abs(x).max() for x in xs) / 254 * 1.01
    for r in range(world):
        for src in range(world):
            got = outs[r][src * count:(src + 1) * count]
            want = np.zeros(count, np.float32)
            want[:pc[r]] = xs[src][r * count:r * count + pc[r]]
            if src == r:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= bound
                np.testing.assert_array_equal(
                    got[pc[r]:], np.zeros(count - pc[r], np.float32))


# ---------------------------------------------------------------------------
# plans that lower through _permute
# ---------------------------------------------------------------------------


def _tuned_plan(device, count):
    from accl_tpu_torch import ACCL, ReduceFunction

    accl = ACCL(device=device)
    accl.autotune()
    a, b = accl.create_buffer(count), accl.create_buffer(count)
    return accl, accl.allreduce(a, b, count, ReduceFunction.SUM).plan


@pytest.mark.parametrize("kind", ["SYNTHESIZED", "HIER_RS_AR_AG"])
def test_permute_plans_lift_and_execute(kind):
    if kind == "SYNTHESIZED":
        device, count = GPUDevice(4, "cpu"), 1024
    else:
        device, count = GPUDevice(8, "cpu", hier_topology=(4, 2)), 4096
    accl, plan = _tuned_plan(device, count)
    assert plan.algorithm.name == kind
    world = device.world
    opts = CallOptions(scenario=port_c.Operation.allreduce, count=count,
                       function=0, data_type=port_c.DataType.float32)
    dag = semantics.lift_call(opts, plan, world)
    assert semantics.certify(dag, semantics.collective_spec(opts, world)) \
        == []
    rng = np.random.default_rng(23)
    xs = [rng.standard_normal(count).astype(np.float32)
          for _ in range(world)]
    outs = np.stack(_execute(dag, xs))
    low = device.compiler.lower(opts, plan)(
        torch.from_numpy(np.stack(xs))).numpy()
    # the tuned two-tier plan runs int8 tier wires, whose lowering fuses
    # each decode into its fold: within the bound there, else bitwise
    quantized = port_c.DataType.int8 in (
        getattr(plan, "inner_wire_dtype", None),
        getattr(plan, "outer_wire_dtype", None))
    assert _close(outs, low, quantized, _bound(xs, world))
    assert quantized == (kind == "HIER_RS_AR_AG")


def test_hops_of_the_flagship_train_allreduce():
    """The flagship train step's 155 205 632-element allreduce (606 272
    eager segments) records its hops without building its address array:
    the mapped body once, equal to the reference's trace, while a full
    lift of it would hold billions of addresses."""
    import resource

    count = 155_205_632
    opts, plan = corpus.family_call(port_c.Operation.allreduce, count, 4)
    ro, rp = _ref_call(port_c.Operation.allreduce, count, 4)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    trace, _, _ = protocol.trace_schedule_jaxpr(opts, plan, 4)
    grew_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert not trace.complete
    assert [h.perm for h in protocol.iter_ppermute_eqns(trace)] == \
        ref_protocol.trace_schedule_hops(ro, rp, 4)
    assert grew_kib < 64 * 1024  # nothing near the 5 GB address array


def test_an_unmodelled_tensor_method_raises_naming_it():
    def body(x):
        return x.cumsum(1)

    with pytest.raises(semantics.UnsupportedSchedule, match="cumsum"):
        semantics._Lifter(4).run(body, 1, 8, torch.float32)
