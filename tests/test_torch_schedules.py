"""The port's torch-op allreduce ring against the reference's lax ring
under shard_map: bitwise equal, ragged counts and odd worlds included."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import accl_tpu.sequencer.schedules as ref_sched
import accl_tpu_torch.sequencer.schedules as port_sched
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu.sequencer.plan import eager_seg_count
from accl_tpu_torch.constants import ReduceFunction as PortF

# arith lanes of the default table: SUM / MAX per dtype
LANES = {"float32": (0, 5), "int32": (2, 7)}


def _data(world, count, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal((world, count)).astype(np.float32)
    return rng.integers(-(1 << 30), 1 << 30, (world, count), dtype=np.int32)


def _ref_allreduce(x, world, func, lane, seg):
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    body = functools.partial(
        ref_sched.allreduce_ring_schedule, func=RefF(func), axis="ccl",
        world=world, wire=ref_sched.Wire(None, lane), seg_count=seg)
    fn = jax.jit(jax.shard_map(
        lambda a: body(a.reshape(-1)).reshape(1, -1), mesh=mesh,
        in_specs=PartitionSpec("ccl"), out_specs=PartitionSpec("ccl"),
        check_vma=False))
    return np.array(fn(x))


@pytest.mark.parametrize("func", [0, 1], ids=["sum", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("count", [329, 1000, 4096])
@pytest.mark.parametrize("world", [2, 3, 5, 8])
def test_allreduce_ring_schedule_bitwise(world, count, dtype, func):
    x = _data(world, count, dtype, seed=world * 10_000 + count)
    lane = LANES[dtype][func]
    seg = eager_seg_count(count, 4, 1024, 0, world_align=world)
    ref = _ref_allreduce(x, world, func, lane, seg)
    got = port_sched.allreduce_ring_schedule(
        torch.from_numpy(x), func=PortF(func), world=world,
        wire=port_sched.Wire(None, lane), seg_count=seg)
    assert torch.equal(got, torch.from_numpy(ref))
    if dtype == "float32" and func == 0:
        # the ring's fold order is not numpy's: equality above is the
        # contract, closeness here is a sanity check of the data path
        np.testing.assert_allclose(got.numpy()[0], x.sum(0), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("world", [3, 5])
def test_ring_primitives_bitwise(world):
    """reduce-scatter and allgather alone, one segment, plus a partial
    permutation (unaddressed ranks receive zeros)."""
    count = 64 * world
    x = _data(world, count, "float32", seed=world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))

    def run(body):
        return np.array(jax.jit(jax.shard_map(
            lambda a: body(a.reshape(-1)).reshape(1, -1), mesh=mesh,
            in_specs=PartitionSpec("ccl"), out_specs=PartitionSpec("ccl"),
            check_vma=False))(x))

    rs_ref = run(functools.partial(
        ref_sched.reduce_scatter_ring_schedule, func=RefF.SUM, axis="ccl",
        world=world, wire=ref_sched.Wire()))
    ag_ref = run(functools.partial(
        ref_sched.allgather_ring_schedule, axis="ccl", world=world,
        wire=ref_sched.Wire()))
    perm = [(0, 2), (1, 0)]
    pp_ref = run(lambda a: ref_sched.Wire().ppermute(a, "ccl", perm))
    xt = torch.from_numpy(x)
    wire = port_sched.Wire()
    assert torch.equal(port_sched.reduce_scatter_ring_schedule(
        xt, func=PortF.SUM, world=world, wire=wire), torch.from_numpy(rs_ref))
    assert torch.equal(port_sched.allgather_ring_schedule(
        xt, world=world, wire=wire), torch.from_numpy(ag_ref))
    assert torch.equal(wire.ppermute(xt, perm), torch.from_numpy(pp_ref))


def test_segmented_apply_slots_and_tail():
    x = torch.arange(2 * 10).reshape(2, 10)
    seen = []

    def body(seg, slot):
        seen.append((seg.shape[-1], slot))
        return seg * 2

    out = port_sched.segmented_apply(body, x, 4, overlap_slots=2)
    assert torch.equal(out, x * 2)
    assert seen == [(4, 0), (4, 1), (2, 0)]
    assert torch.equal(port_sched.segmented_apply(lambda s: s + 1, x, 16), x + 1)


@pytest.mark.parametrize("world,count,func", [(8, 8 * 40, 0), (5, 5 * 300, 1),
                                              (2, 2 * 257, 0)])
def test_quantized_ring_primitives_bitwise(world, count, func):
    """The int8-wire reduce-scatter (fused dequantize-combine-requantize
    per interior hop, dequantize-combine at the terminal hop) and
    allgather (encode once, relay the codes, decode every chunk) against
    the reference's quantized lax rings under shard_map, and the packed
    one-message ppermute with an unaddressed rank."""
    from accl_tpu.arithconfig import DEFAULT_ARITH_CONFIG as REF_TABLE
    from accl_tpu.constants import DataType as RefDT
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType

    x = _data(world, count, "float32", seed=world + count)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref_wire = ref_sched.Wire(REF_TABLE[(RefDT.float32, RefDT.int8)])
    wire = port_sched.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                 DataType.int8)])
    assert ref_wire.quantized and wire.quantized

    def run(body, a):
        return np.array(jax.jit(jax.shard_map(
            lambda v: body(v.reshape(-1)).reshape(1, -1), mesh=mesh,
            in_specs=PartitionSpec("ccl"), out_specs=PartitionSpec("ccl"),
            check_vma=False))(a))

    rs_ref = run(functools.partial(
        ref_sched.reduce_scatter_ring_schedule, func=RefF(func), axis="ccl",
        world=world, wire=ref_wire), x)
    rs = port_sched.reduce_scatter_ring_schedule(
        torch.from_numpy(x), func=PortF(func), world=world, wire=wire)
    assert torch.equal(rs, torch.from_numpy(rs_ref))
    chunk = x[:, : count // world].copy()
    ag_ref = run(functools.partial(
        ref_sched.allgather_ring_schedule, axis="ccl", world=world,
        wire=ref_wire), chunk)
    ag = port_sched.allgather_ring_schedule(torch.from_numpy(chunk),
                                            world=world, wire=wire)
    assert torch.equal(ag, torch.from_numpy(ag_ref))
    perm = [(0, world - 1), (world - 1, 0)] if world > 2 else [(0, 1)]
    pp_ref = run(lambda a: ref_wire.ppermute(a, "ccl", perm), chunk)
    assert torch.equal(wire.ppermute(torch.from_numpy(chunk), perm),
                       torch.from_numpy(pp_ref))


def _wires(name, func):
    """(reference, port) Wire pair with the fp32 lane: the exact wire, the
    bf16 cast wire or the blockwise-int8 wire. (The facade reduces on the
    cast rows in the compressed domain, which tests/test_torch_collectives
    covers; a bf16 lane over fp32 operands lets XLA keep the folds it
    fuses in fp32, which no eager executor reproduces.)"""
    from accl_tpu.arithconfig import DEFAULT_ARITH_CONFIG as REF_TABLE
    from accl_tpu.constants import DataType as RefDT
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType

    lane = LANES["float32"][func]
    if name == "exact":
        return ref_sched.Wire(None, lane), port_sched.Wire(None, lane)
    rcfg = REF_TABLE[(RefDT.float32, RefDT[name])]
    pcfg = DEFAULT_ARITH_CONFIG[(DataType.float32, DataType[name])]
    return ref_sched.Wire(rcfg, lane), port_sched.Wire(pcfg, lane)


# (schedule, world, root, extra keyword arguments): every one-call family
SCHEDULES = [
    ("copy_schedule", 5, None, {}),
    ("sendrecv_schedule", 5, None, dict(src=3, dst=1)),
    ("bcast_flat_schedule", 5, 3, {}),
    ("bcast_bin_tree_schedule", 8, 5, {}),
    ("bcast_bin_tree_schedule", 5, 2, {}),
    ("scatter_schedule", 5, 4, {}),
    ("gather_ring_schedule", 8, 3, {}),
    ("gather_flat_schedule", 5, 1, dict(fanin=4)),
    ("gather_flat_schedule", 8, 6, dict(fanin=2)),
    ("gather_flat_schedule", 5, 3, dict(fanin=2)),
    ("reduce_ring_schedule", 5, 2, {}),
    ("reduce_flat_schedule", 8, 7, {}),
    ("reduce_bin_tree_schedule", 8, 3, {}),
    ("reduce_bin_tree_schedule", 5, 4, {}),
    ("barrier_schedule", 5, None, {}),
]
REDUCING = ("reduce_ring_schedule", "reduce_flat_schedule",
            "reduce_bin_tree_schedule")


@pytest.mark.parametrize("wire", ["exact", "bfloat16", "int8"])
@pytest.mark.parametrize("name,world,root,extra", SCHEDULES,
                         ids=[f"{s[0]}-w{s[1]}" for s in SCHEDULES])
def test_one_call_schedules_bitwise(name, world, root, extra, wire):
    """Each ported schedule against the reference's under shard_map on
    the same numpy input, on the exact, bf16-cast and int8 wires: the
    row selections of the port against the reference's where-masks,
    unaddressed ranks included."""
    count = 37 if wire != "int8" else 300
    func = (world + len(name)) % 2 if name in REDUCING else 0
    ref_wire, wire_p = _wires(wire, func)
    kw = dict(extra)
    if root is not None:
        kw["root"] = root
    if name in REDUCING:
        kw["func"] = func
    n = count * world if name == "scatter_schedule" else count
    x = _data(world, n, "float32", seed=world * 7 + len(name))
    if name == "barrier_schedule":
        x = np.ones((world, 1), np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref_kw = {k: (RefF(v) if k == "func" else v) for k, v in kw.items()}
    body = functools.partial(getattr(ref_sched, name), axis="ccl",
                             world=world, wire=ref_wire, **ref_kw)
    want = np.array(jax.jit(jax.shard_map(
        lambda a: body(a.reshape(-1)).reshape(1, -1), mesh=mesh,
        in_specs=PartitionSpec("ccl"), out_specs=PartitionSpec("ccl"),
        check_vma=False))(x))
    port_kw = {k: (PortF(v) if k == "func" else v) for k, v in kw.items()}
    got = getattr(port_sched, name)(torch.from_numpy(x), world=world,
                                    wire=wire_p, **port_kw)
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("func", [0, 1], ids=["sum", "max"])
def test_combine_schedule_bitwise(func):
    x = _data(4, 333, "float32", seed=11)
    y = _data(4, 333, "float32", seed=12)
    x[0, :4] = [1e-39, -0.0, 0.0, np.nan]
    y[0, :4] = [0.0, 0.0, -0.0, 1.0]
    lane = LANES["float32"][func]
    mesh = Mesh(np.array(jax.devices()[:4]), ("ccl",))
    body = functools.partial(ref_sched.combine_schedule, func=RefF(func),
                             axis="ccl", world=4, wire=ref_sched.Wire(None, lane))
    want = np.array(jax.jit(jax.shard_map(
        lambda a, b: body(a.reshape(-1), b.reshape(-1)).reshape(1, -1),
        mesh=mesh, in_specs=(PartitionSpec("ccl"),) * 2,
        out_specs=PartitionSpec("ccl"), check_vma=False))(x, y))
    got = port_sched.combine_schedule(
        torch.from_numpy(x), torch.from_numpy(y), func=PortF(func), world=4,
        wire=port_sched.Wire(None, lane))
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.from_numpy(np.isnan(want)))
    assert torch.equal(got[~nan].view(torch.int32),
                       torch.from_numpy(want)[~nan].view(torch.int32))
