"""The port's two-tier schedules against the JAX package's on the same
numpy inputs: the striped HIER_RS_AR_AG allreduce (explicit plans over
(2, 4) and (4, 2), one to three stripes, exact, fp16 and int8 tier
wires, through each side's ScheduleCompiler, and the register-opened
facade path of a device that declares its topology); RankMap's
reorder_chunks; and the nine per-axis compositions, each run by the
reference under shard_map on the 2D CPU mesh (its own row stacking) and
by the port in both of its forms: stacked tiers over every rank's rows,
and the multi-process form's per-rank outer tier (one thread a host over
a LoopbackHub), bitwise on the exact, fp16 and int8 wires, with the
outer tier's byte tallies against the reference's CountingWire."""

import numpy as np
import pytest
import torch

import accl_tpu.constants as ref_c
from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.descriptor import CallOptions as RefOptions
from accl_tpu.device.tpu_device import TPUDevice
from accl_tpu.sequencer import hierarchical as ref_hier
from accl_tpu.sequencer import plan as ref_plan
from accl_tpu.sequencer.lowering import ScheduleCompiler as RefCompiler
import accl_tpu_torch.constants as port_c
from accl_tpu_torch import ACCL, ReduceFunction
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device.gpu_device import GPUDevice
from accl_tpu_torch.sequencer import hierarchical
from accl_tpu_torch.sequencer import plan as port_plan
from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

NONE, F16, I8 = "none", "float16", "int8"
CASES = [(topo, s, wires)
         for topo in ((2, 4), (4, 2))
         for wires, stripes in (((NONE, NONE), (1, 2, 3)),
                                ((I8, I8), (1, 2, 3)),
                                ((F16, F16), (2,)),
                                ((NONE, I8), (2,)))
         for s in stripes]


def test_rankmap_is_the_references():
    for L, P in ((2, 4), (4, 2), (4, 4)):
        for order in ("outer_major", "inner_major"):
            mine = hierarchical.RankMap(L, P, order)
            theirs = ref_hier.RankMap(L, P, order)
            for d in (1, 2, 3):
                assert mine.inner_perm(d) == theirs.inner_perm(d)
                assert mine.outer_perm(d) == theirs.outer_perm(d)
            for g in range(L * P):
                assert (mine.inner_pos(g), mine.outer_pos(g)) == \
                    (theirs.inner_pos(g), theirs.outer_pos(g))


@pytest.mark.parametrize("topo,stripes,wires", CASES)
def test_striped_hier_allreduce_bitwise(mesh8, topo, stripes, wires):
    count = 3001  # ragged stripes, chunks off the L padding and int8 blocks
    L, P = topo
    rng = np.random.default_rng(stripes * 10 + L)
    x = (rng.standard_normal((8, count)) * 2).astype(np.float32)
    rplan = ref_plan.Plan(ref_plan.Protocol.EAGER,
                          ref_plan.Algorithm.HIER_RS_AR_AG, count, 1,
                          inner_world=L, outer_world=P, stripes=stripes,
                          inner_wire_dtype=ref_c.DataType[wires[0]],
                          outer_wire_dtype=ref_c.DataType[wires[1]])
    pplan = port_plan.Plan(port_plan.Protocol.EAGER,
                           port_plan.Algorithm.HIER_RS_AR_AG, count, 1,
                           inner_world=L, outer_world=P, stripes=stripes,
                           inner_wire_dtype=port_c.DataType[wires[0]],
                           outer_wire_dtype=port_c.DataType[wires[1]])
    for func in (0, 1) if wires == (NONE, NONE) else (0,):
        ropts = RefOptions(scenario=ref_c.Operation.allreduce, count=count,
                           function=func, data_type=ref_c.DataType.float32)
        popts = CallOptions(scenario=port_c.Operation.allreduce,
                            count=count, function=func,
                            data_type=port_c.DataType.float32)
        want = np.asarray(RefCompiler(mesh8).lower(ropts, rplan)(x))
        got = ScheduleCompiler(8, torch.device("cpu")).lower(
            popts, pplan)(torch.from_numpy(x))
        assert got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), (func, wires)


@pytest.mark.parametrize("topo", [(4, 2), (2, 4)])
def test_hier_window_through_the_facade(mesh8, topo):
    """A device that declares its topology, the hier register open and
    the tier wires set: the facade selects HIER_RS_AR_AG with the cost
    model's stripes on both sides, bitwise; a sub-communicator ignores
    the topology (its world is flat)."""
    from accl_tpu.constants import ReduceFunction as RefF

    regs = dict(hier_allreduce_min_count=1 << 16)
    ref = RefACCL(device=TPUDevice(mesh8, hier_topology=topo))
    ref.configure_tuning_parameters(ref_c.TuningParams(**regs))
    ref.cclo.hier_wires = (ref_c.DataType.none, ref_c.DataType.int8)
    port = ACCL(device=GPUDevice(8, "cpu", hier_topology=topo))
    port.configure_tuning_parameters(port_c.TuningParams(**regs))
    port.cclo.hier_wires = (port_c.DataType.none, port_c.DataType.int8)
    count = 1 << 20
    x = np.random.default_rng(7).standard_normal((8, count)).astype(
        np.float32)
    rsb = ref.create_buffer(count, np.float32, data=x)
    rrb = ref.create_buffer(count, np.float32)
    ref.allreduce(rsb, rrb, count, RefF.SUM)
    psb = port.create_buffer(count, torch.float32, data=x)
    prb = port.create_buffer(count, torch.float32)
    req = port.allreduce(psb, prb, count, ReduceFunction.SUM)
    assert req.plan.algorithm == port_plan.Algorithm.HIER_RS_AR_AG
    assert req.plan.outer_wire_dtype == port_c.DataType.int8
    assert np.array_equal(prb.host.numpy().view(np.int32),
                          np.asarray(rrb.host).view(np.int32))
    group = port.split([0, 2, 4, 6])
    sb, rb = port.create_buffer(count), port.create_buffer(count)
    req = port.allreduce(sb, rb, count, ReduceFunction.SUM, comm=group)
    assert req.plan.algorithm == port_plan.Algorithm.EAGER_RING_RS_AG


# ---------------------------------------------------------------------------
# RankMap.reorder_chunks and the nine per-axis compositions
# ---------------------------------------------------------------------------

import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as RefMesh  # noqa: E402
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from accl_tpu.arithconfig import DEFAULT_ARITH_CONFIG as REF_TABLE  # noqa: E402
from accl_tpu.sequencer import schedules as ref_sched  # noqa: E402
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG as PORT_TABLE  # noqa: E402,E501
from accl_tpu_torch.device.dcn_transport import LoopbackHub, ProcessTier  # noqa: E402,E501
from accl_tpu_torch.sequencer import schedules as port_sched  # noqa: E402


@pytest.mark.parametrize("L,P", [(2, 4), (4, 2), (3, 2)])
def test_reorder_chunks_is_the_references(L, P):
    rng = np.random.default_rng(L * 10 + P)
    mine, theirs = hierarchical.RankMap(L, P), ref_hier.RankMap(L, P)
    for chunk in (1, 3):
        x = rng.standard_normal(L * P * chunk).astype(np.float32)
        for frm, to in (("inner_major", "outer_major"),
                        ("outer_major", "inner_major"),
                        ("outer_major", "outer_major")):
            want = np.asarray(theirs.reorder_chunks(jnp.asarray(x), chunk,
                                                    frm, to))
            got = mine.reorder_chunks(torch.from_numpy(x), chunk, frm, to)
            assert np.array_equal(got.numpy(), want)
            # stacked rows ride along: each row relabelled on its own
            rows = np.stack([x, -x])
            got = mine.reorder_chunks(torch.from_numpy(rows), chunk, frm, to)
            assert np.array_equal(got.numpy(), np.stack([want, -want]))


COMPOSITIONS = {
    # name: (width factor: world for world*count inputs, reduction, rooted,
    #        the reference test's row stacking)
    "allreduce": (False, True, False, "inner_major"),
    "reduce_scatter": (True, True, False, "inner_major"),
    "allgather": (False, False, False, "inner_major"),
    "bcast": (False, False, True, "inner_major"),
    "alltoall": (True, False, False, "outer_major"),
    "scatter": (True, False, True, "outer_major"),
    "gather": (False, False, True, "outer_major"),
    "reduce": (False, True, True, "outer_major"),
    "barrier": (False, False, False, "outer_major"),
}
WIRES = {"exact": None, "float16": ref_c.DataType.float16,
         "int8": ref_c.DataType.int8}
COMP_CASES = [(name, topo) for name in COMPOSITIONS
              for topo in ((2, 4), (2, 2), (4, 2))]


def _ref_wire(name):
    dt = WIRES[name]
    return ref_sched.Wire(None if dt is None
                          else REF_TABLE[(ref_c.DataType.float32, dt)])


def _port_wire(name):
    dt = WIRES[name]
    return port_sched.Wire(None if dt is None else PORT_TABLE[(
        port_c.DataType.float32, port_c.DataType[dt.name])])


def _variants(name, topo):
    """(count, func, global root, wire) for one composition's case: counts
    64 and 257; on the exact wire SUM and MAX, roots 0, 5 and 6 (mod the
    world); on the fp16 and int8 wires SUM and the last root."""
    _, reduction, rooted, _ = COMPOSITIONS[name]
    world = topo[0] * topo[1]
    counts = (1,) if name == "barrier" else (64, 257)
    funcs = (ref_c.ReduceFunction.SUM, ref_c.ReduceFunction.MAX) \
        if reduction else (None,)
    roots = sorted({r % world for r in (0, 5, 6)}) if rooted else [None]
    exact = [(c, f, r, "exact") for c in counts for f in funcs
             for r in roots]
    return exact + [(c, funcs[0], roots[-1], w) for c in counts
                    for w in ("float16", "int8")]


def _kwargs(name, rm, func, root):
    kw = {}
    if func is not None:
        kw["func"] = func
    if root is not None:
        kw.update(root_inner=rm.inner_pos(root), root_outer=rm.outer_pos(root))
    return kw


def _inputs(name, topo, count):
    world = topo[0] * topo[1]
    rng = np.random.default_rng(count * 7 + world)
    if name == "barrier":
        return np.ones((world, 1), np.float32)
    width = count * (world if COMPOSITIONS[name][0] else 1)
    x = (rng.standard_normal((world, width)) * 3).astype(np.float32)
    x[:, ::17] = 0.0  # zero runs beside the blocks' maxima
    return x


def _reference(name, topo, variants):
    """The reference composition of every variant under one shard_map
    over ("outer", "inner"), rows stacked as its own test stacks them."""
    P, L = topo
    order = COMPOSITIONS[name][3]
    devs = np.array(jax.devices()[:P * L]).reshape(P, L)
    mesh = RefMesh(devs, ("outer", "inner"))
    spec = RefP(("inner", "outer") if order == "inner_major"
                else ("outer", "inner"))
    rm = ref_hier.RankMap(L, P, order)
    counts = sorted({v[0] for v in variants})
    fn = getattr(ref_hier, f"hierarchical_{name}_schedule")

    def body(*xs):
        outs = []
        for count, func, root, wire in variants:
            xl = xs[counts.index(count)].reshape(-1)
            outs.append(fn(xl, inner_axis="inner", outer_axis="outer",
                           inner_world=L, outer_world=P,
                           wire=_ref_wire(wire),
                           **_kwargs(name, rm, func, root)))
        return jnp.concatenate(outs).reshape(1, -1)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(spec,) * len(counts),
                              out_specs=spec, check_vma=False))
    return np.asarray(f(*(_inputs(name, topo, c) for c in counts)))


def _port_call(name, x, tiers, rm, func, root, wire):
    fn = getattr(hierarchical, f"hierarchical_{name}_schedule")
    port_func = None if func is None else port_c.ReduceFunction(int(func))
    inner, outer = tiers
    return fn(x, inner=inner, outer=outer, wire=_port_wire(wire),
              **_kwargs(name, rm, port_func, root))


def _run_processes(P, fn):
    """fn(p, transport) on P threads, one host each, over a LoopbackHub."""
    hub = LoopbackHub(P)
    results, errors = [None] * P, []

    def run(p):
        try:
            results[p] = fn(p, hub.transport(p))
        except Exception as e:  # re-raised below
            errors.append(e)
            raise

    threads = [threading.Thread(target=run, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert all(not t.is_alive() for t in threads)
    return results


def _defined_rows(name, rm, root):
    """The rows whose output the collective defines: only the root's for
    gather and reduce."""
    return [root] if name in ("gather", "reduce") else list(range(rm.world))


@pytest.mark.parametrize("name,topo", COMP_CASES)
def test_composition_bitwise_in_both_forms(name, topo):
    """Each per-axis composition: the reference under shard_map, the
    port's stacked form (both tiers stacked schedules along one axis of
    the rows) and its multi-process form (the process's rows, the outer
    tier across LoopbackHub threads), bitwise on every variant's defined
    rows."""
    P, L = topo
    order = COMPOSITIONS[name][3]
    rm = hierarchical.RankMap(L, P, order)
    variants = _variants(name, topo)
    want = _reference(name, topo, variants)
    stacked = hierarchical.stacked_tiers(rm, torch.device("cpu"))
    got, off = [], 0
    for count, func, root, wire in variants:
        x = torch.from_numpy(_inputs(name, topo, count))
        out = _port_call(name, x, stacked, rm, func, root, wire)
        ref = want[:, off:off + out.shape[-1]]
        off += out.shape[-1]
        rows = _defined_rows(name, rm, root)
        assert np.array_equal(out.numpy()[rows].view(np.int32),
                              ref[rows].view(np.int32)), \
            (name, count, func, root, wire)
        got.append((out, rows))
    assert off == want.shape[-1]

    # the multi-process form: host p holds the rows at outer position p,
    # in inner order, and runs the same composition body
    host_rows = [[rm.global_rank(i, p) for i in range(L)] for p in range(P)]

    def host(p, transport):
        tiers = (hierarchical.StackedTier(L),
                 ProcessTier(transport, range(P)))
        return [_port_call(name, torch.from_numpy(
                    _inputs(name, topo, count))[host_rows[p]],
                    tiers, rm, func, root, wire)
                for count, func, root, wire in variants]

    per_host = _run_processes(P, host)
    for i, (out, rows) in enumerate(got):
        for p in range(P):
            mine = per_host[p][i].numpy()
            for k, g in enumerate(host_rows[p]):
                if g in rows:
                    assert np.array_equal(mine[k].view(np.int32),
                                          out.numpy()[g].view(np.int32)), \
                        (name, variants[i], p, g)


class CountingWire(ref_sched.Wire):
    """The reference test's tally: per-device ppermute payload bytes by
    axis, at trace time."""

    def __init__(self):
        super().__init__(None)
        self.bytes_by_axis = {}

    def ppermute(self, x, axis, perm):
        key = axis if isinstance(axis, str) else tuple(axis)
        self.bytes_by_axis[key] = (self.bytes_by_axis.get(key, 0)
                                   + int(x.size) * x.dtype.itemsize)
        return super().ppermute(x, axis, perm)


@pytest.mark.parametrize("name", ["bcast", "reduce", "allreduce"])
def test_outer_byte_tally_is_the_counting_wires(name):
    """The transport's tally of the bytes a line carries in the outer
    hops equals the reference's CountingWire count of outer-axis ppermute
    bytes (test_hier_dcn_byte_counts), and each host sent that many bytes
    a line in every hop it sent."""
    P, L, n = 2, 4, 4096
    devs = np.array(jax.devices()[:P * L]).reshape(P, L)
    mesh = RefMesh(devs, ("outer", "inner"))
    w = CountingWire()
    kw = {} if name == "allreduce" else dict(root_inner=0, root_outer=0)
    if name != "bcast":
        kw["func"] = ref_c.ReduceFunction.SUM
    fn = getattr(ref_hier, f"hierarchical_{name}_schedule")

    def body(xl):
        return fn(xl.reshape(-1), inner_axis="inner", outer_axis="outer",
                  inner_world=L, outer_world=P, wire=w, **kw).reshape(1, -1)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(RefP(("outer", "inner")),),
                              out_specs=RefP(("outer", "inner")),
                              check_vma=False))
    jax.eval_shape(f, jax.ShapeDtypeStruct((P * L, n), np.float32))
    want = w.bytes_by_axis["outer"]
    rm = hierarchical.RankMap(L, P)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (P * L, n)).astype(np.float32))
    port_kw = {} if name == "allreduce" else dict(root_inner=0, root_outer=0)
    if name != "bcast":
        port_kw["func"] = port_c.ReduceFunction.SUM
    port_fn = getattr(hierarchical, f"hierarchical_{name}_schedule")

    def host(p, transport):
        tiers = (hierarchical.StackedTier(L), ProcessTier(transport, range(P)))
        port_fn(x[p * L:(p + 1) * L], inner=tiers[0], outer=tiers[1],
                wire=port_sched.Wire(None), **port_kw)
        return transport.tally()

    tallies = _run_processes(P, host)
    for p, tally in enumerate(tallies):
        assert tally["hops"]["outer"] == want, (p, tally, want)
    # what crossed: bcast and reduce, one sender a hop (its L lines); the
    # allreduce ring, every host in every hop
    sent = sum(t["sent"].get("outer", 0) for t in tallies)
    assert sent == L * want * (P if name == "allreduce" else 1), tallies
