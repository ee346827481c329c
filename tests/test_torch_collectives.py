"""The port's one-call collectives end to end against the JAX facade on
the same numpy inputs, bitwise: copy, combine, bcast, scatter, gather,
allgather, reduce, reduce_scatter, barrier and the register-opened
reduce+bcast allreduce, at W = 8, 5 and 2 with non-zero roots, counts
17 (eager) and 329 (rendezvous), flat and tree shapes chosen by the
tuning registers, and the fp16, bf16 and int8 wires. The cases are a
pairwise cover of those dimensions, not their full product. A second
set runs W = 1, 3, 4, 6 and 7 on operands with special-valued columns
(subnormals, signed zeros in both orders, NaN, +-Inf, values past fp16's
range), bitwise with NaN matched as NaN."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu.constants import TuningParams as RefTuning
from accl_tpu_torch import (
    ACCL,
    DataType,
    Operation,
    ReduceFunction,
    TuningParams,
)
from accl_tpu_torch.interop import tensor_from_numpy
from accl_tpu_torch.sequencer.plan import Algorithm

# register sets that steer the rendezvous families; None = the defaults
TUNINGS = {
    "tree": dict(bcast_flat_tree_max_ranks=1, reduce_flat_tree_max_ranks=1,
                 reduce_flat_tree_max_count=1, gather_flat_tree_max_count=1),
    "flat": dict(bcast_flat_tree_max_ranks=8, reduce_flat_tree_max_ranks=8,
                 gather_flat_tree_max_count=1 << 30),
    "compose": dict(allreduce_composition_max_count=1 << 20),
}
WIDE_IN = ("scatter", "reduce_scatter")
WIDE_OUT = ("gather", "allgather")


@pytest.fixture(scope="module")
def facades(mesh8):
    """(reference, port) facade pairs per world, shared by the module."""
    out = {}
    for world in (8, 5, 2):
        mesh = mesh8 if world == 8 else Mesh(
            np.array(jax.devices()[:world]), ("ccl",))
        out[world] = (RefACCL(mesh), ACCL(world=world, torch_device="cpu"))
    return out


def _data(world, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-(1 << 30), 1 << 30, (world, n)).astype(dtype)
    return rng.standard_normal((world, n)).astype(dtype)


def _call(accl, ref: bool, op, x, y, count, root, func, wire):
    """One facade call; returns the result buffer's host image and the
    request."""
    world = x.shape[0]
    F = RefF if ref else ReduceFunction
    cd = None if wire is None else (RefDT[wire] if ref else DataType[wire])
    dtype = x.dtype if ref else tensor_from_numpy(x).dtype

    def buf(n, data=None):
        return accl.create_buffer(n, dtype, data=data)

    n_in = count * world if op in WIDE_IN else count
    n_out = count * world if op in WIDE_OUT else count
    src = buf(n_in, x)
    res = buf(n_out)
    if op == "copy":
        req = accl.copy(src, res, count)
    elif op == "combine":
        req = accl.combine(count, F(func), src, buf(count, y), res)
    elif op == "bcast":
        req, res = accl.bcast(src, count, root, compress_dtype=cd), src
    elif op == "scatter":
        req = accl.scatter(src, res, count, root, compress_dtype=cd)
    elif op == "gather":
        req = accl.gather(src, res, count, root, compress_dtype=cd)
    elif op == "allgather":
        req = accl.allgather(src, res, count, compress_dtype=cd)
    elif op == "reduce":
        req = accl.reduce(src, res, count, root, F(func), compress_dtype=cd)
    elif op == "reduce_scatter":
        req = accl.reduce_scatter(src, res, count, F(func), compress_dtype=cd)
    else:
        req = accl.allreduce(src, res, count, F(func), compress_dtype=cd)
    return res.host, req


CASES = [  # (op, world, count, root, func, wire, tuning, dtype)
    ("copy", 8, 329, 0, 0, None, None, np.float32),
    ("copy", 5, 17, 0, 0, None, None, np.int64),
    ("combine", 8, 329, 0, 1, None, None, np.float32),
    ("combine", 5, 17, 0, 0, None, None, np.float64),
    ("combine", 2, 329, 0, 0, None, None, np.int32),
    ("bcast", 8, 329, 3, 0, None, None, np.float32),
    ("bcast", 8, 17, 5, 0, "float16", None, np.float32),
    ("bcast", 5, 329, 4, 0, None, "flat", np.float32),
    ("bcast", 5, 17, 2, 0, "int8", None, np.float32),
    ("bcast", 2, 329, 1, 0, None, "tree", np.float32),
    ("bcast", 8, 329, 6, 0, "bfloat16", None, np.float32),
    ("scatter", 8, 17, 2, 0, "bfloat16", None, np.float32),
    ("scatter", 5, 329, 3, 0, None, None, np.float32),
    ("scatter", 2, 17, 1, 0, "int8", None, np.float32),
    ("scatter", 8, 329, 6, 0, "float16", None, np.float32),
    ("gather", 8, 17, 5, 0, None, None, np.float32),
    ("gather", 8, 329, 1, 0, None, "tree", np.float32),
    ("gather", 5, 329, 2, 0, None, "flat", np.float32),
    ("gather", 5, 17, 4, 0, "int8", None, np.float32),
    ("gather", 2, 17, 1, 0, "float16", None, np.float32),
    ("allgather", 8, 329, 0, 0, None, None, np.float32),
    ("allgather", 8, 17, 0, 0, "bfloat16", None, np.float32),
    ("allgather", 5, 17, 0, 0, "int8", None, np.float32),
    ("allgather", 2, 329, 0, 0, "float16", None, np.float32),
    ("reduce", 8, 329, 3, 0, None, None, np.float32),
    ("reduce", 8, 329, 6, 1, None, "tree", np.float32),
    ("reduce", 8, 17, 5, 0, "bfloat16", None, np.float32),
    ("reduce", 5, 329, 2, 1, None, "tree", np.float32),
    ("reduce", 5, 17, 4, 0, "float16", None, np.float32),
    ("reduce", 5, 17, 3, 0, "int8", None, np.float32),
    ("reduce", 2, 329, 1, 0, None, "flat", np.float32),
    ("reduce", 8, 17, 7, 0, None, None, "bfloat16"),
    ("reduce_scatter", 8, 17, 0, 0, None, None, np.float32),
    ("reduce_scatter", 8, 329, 0, 0, None, "tree", np.float32),
    ("reduce_scatter", 8, 17, 0, 0, "bfloat16", None, np.float32),
    ("reduce_scatter", 5, 329, 0, 1, None, "flat", np.float32),
    ("reduce_scatter", 5, 17, 0, 0, "float16", None, np.float32),
    ("reduce_scatter", 2, 17, 0, 1, "int8", None, np.float32),
    ("reduce_scatter", 2, 329, 0, 0, None, None, "bfloat16"),
    ("allreduce", 8, 329, 0, 0, None, "compose", np.float32),
    ("allreduce", 5, 329, 0, 1, None, "compose", np.float32),
    ("allreduce", 2, 329, 0, 0, None, "compose", np.float64),
]


def _case_id(case):
    op, world, count, root, func, wire, tuning, dtype = case
    dt = np.dtype(dtype).name if dtype != "bfloat16" else "bf16"
    parts = [op, f"w{world}", f"n{count}", f"r{root}", ("sum", "max")[func],
             wire or "exact", tuning or "default", dt]
    return "-".join(parts)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_collective_bitwise_with_reference_facade(facades, case):
    op, world, count, root, func, wire, tuning, dtype = case
    if dtype == "bfloat16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16
    ref, port = facades[world]
    n_in = count * world if op in WIDE_IN else count
    x = _data(world, n_in, dtype, seed=CASES.index(case))
    y = _data(world, count, dtype, seed=1000 + CASES.index(case))
    regs = TUNINGS.get(tuning)
    if regs:
        ref.configure_tuning_parameters(RefTuning(**regs))
        port.configure_tuning_parameters(TuningParams(**regs))
    try:
        want, _ = _call(ref, True, op, x, y, count, root, func, wire)
        got, req = _call(port, False, op, x, y, count, root, func, wire)
    finally:
        if regs:
            ref.configure_tuning_parameters(RefTuning.default())
            port.configure_tuning_parameters(TuningParams.default())
    want = tensor_from_numpy(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    if tuning == "compose":
        assert req.plan.algorithm == Algorithm.RNDZV_REDUCE_BCAST
    if tuning == "tree":  # the registers did move the plan onto a tree
        plan = req.plan.stages[0] if op == "reduce_scatter" else req.plan
        assert plan.use_bin_tree or 0 < plan.tree_fanin < world - 1


def test_barrier_and_unported_entry_points(facades):
    """barrier completes on both facades. The entry points that used to
    raise NotImplementedError run now: stream_put on an unregistered
    producer is a KeyError, as in the reference (so is a streamed
    operand's), a raw send descriptor parks until its recv, and a raw
    alltoall descriptor runs the pairwise exchange."""
    ref, port = facades[5]
    ref.barrier()
    req = port.barrier()
    assert req.plan.algorithm == Algorithm.BARRIER_GATHER_SCATTER
    b = port.create_buffer(17)
    with pytest.raises(KeyError, match="no producer registered on stream 3"):
        port.bcast(b, 17, 0, op0_stream=3)
    with pytest.raises(KeyError, match="no producer registered on stream 3"):
        port.stream_put(17, 3, 0, 1, b)
    req = port.cclo.start(port._prepare(Operation.send, b, None, None, 17,
                                        root_src_dst=1 << 16))
    assert req.test() and req.retcode == 0
    assert "parked send: comm 0x200 src 0 dst 1" in \
        port.dump_eager_rx_buffers()
    port.soft_reset()
    x = _data(5, 17 * 5, np.float32, seed=77)
    wide = port.create_buffer(17 * 5, data=x)
    out = port.create_buffer(17 * 5)
    req = port.cclo.start(port._prepare(Operation.alltoall, wide, None, out,
                                        17))
    req.wait()
    assert req.plan.algorithm == Algorithm.FLAT_ALLTOALL
    assert torch.equal(out.device, torch.from_numpy(
        x.reshape(5, 5, 17).transpose(1, 0, 2).reshape(5, 85)))


@pytest.fixture(scope="module")
def odd_facades():
    """(reference, port) facade pairs for the worlds of SPECIAL_CASES."""
    return {world: (RefACCL(Mesh(np.array(jax.devices()[:world]),
                                 ("ccl",))),
                    ACCL(world=world, torch_device="cpu"))
            for world in (1, 3, 4, 6, 7)}


def _special_data(world, n, seed):
    """float32 rank rows with special-valued columns 0-9: a subnormal on
    rank 0 only and on every rank, -0 on all ranks but the last (+0),
    +0 on rank 0 and -0 on the rest, a negative subnormal everywhere, a
    NaN on one rank, +Inf against -Inf, +Inf everywhere, and values past
    fp16's largest finite on every rank and (negated) on rank 0."""
    x = _data(world, n, np.float32, seed)
    x[:, :10] = 1.0
    x[0, 0] = 1e-39
    x[:, 1] = 1e-39
    x[:, 2] = -0.0
    x[-1, 2] = 0.0
    x[:, 3] = -0.0
    x[0, 3] = 0.0
    x[:, 4] = -1e-39
    x[(world - 1) // 2, 5] = np.nan
    x[0, 6] = np.inf
    x[-1, 6] = -np.inf
    x[:, 7] = np.inf
    x[:, 8] = 7e4
    x[0, 9] = -7e4
    return x


SPECIAL_CASES = [  # (op, world, count, root, func, wire, tuning)
    ("allreduce", 1, 17, 0, 0, "int8", None),
    ("allreduce", 3, 329, 0, 0, None, None),
    ("allreduce", 4, 17, 0, 1, "int8", None),
    ("allreduce", 6, 329, 0, 0, "float16", None),
    ("allreduce", 7, 17, 0, 0, "bfloat16", None),
    ("allreduce", 7, 329, 0, 1, None, "compose"),
    ("reduce", 1, 329, 0, 0, None, None),
    ("reduce", 3, 17, 2, 0, "float16", None),
    ("reduce", 4, 329, 1, 1, None, "tree"),
    ("reduce", 6, 17, 5, 0, "int8", None),
    ("reduce", 7, 329, 3, 0, "bfloat16", None),
    ("reduce_scatter", 3, 17, 0, 0, "int8", None),
    ("reduce_scatter", 4, 17, 0, 0, "bfloat16", None),
    ("reduce_scatter", 6, 329, 0, 1, None, "flat"),
    ("reduce_scatter", 7, 17, 0, 0, "float16", None),
    ("bcast", 3, 329, 1, 0, "bfloat16", None),
    ("bcast", 4, 17, 3, 0, "int8", None),
    ("bcast", 6, 329, 0, 0, "float16", "tree"),
    ("bcast", 7, 17, 6, 0, None, None),
    ("allgather", 3, 17, 0, 0, "float16", None),
    ("allgather", 4, 329, 0, 0, None, None),
    ("allgather", 6, 17, 0, 0, "int8", None),
    ("allgather", 7, 17, 0, 0, "bfloat16", None),
    ("gather", 3, 329, 2, 0, "int8", None),
    ("gather", 6, 17, 4, 0, "bfloat16", None),
    ("gather", 7, 329, 0, 0, None, "tree"),
    ("scatter", 4, 17, 2, 0, "float16", None),
    ("scatter", 6, 17, 1, 0, None, None),
    ("scatter", 7, 329, 5, 0, "int8", None),
    ("combine", 3, 329, 0, 1, None, None),
    ("combine", 7, 17, 0, 0, None, None),
]


def _bits_equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of float32 tensors; a NaN matches any NaN (the
    contract leaves NaN payloads open)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.parametrize(
    "case", SPECIAL_CASES,
    ids=[_case_id((*c, np.float32)) for c in SPECIAL_CASES])
def test_collective_special_values_bitwise_with_reference_facade(
        odd_facades, case):
    op, world, count, root, func, wire, tuning = case
    ref, port = odd_facades[world]
    n_in = count * world if op in WIDE_IN else count
    seed = SPECIAL_CASES.index(case)
    x = _special_data(world, n_in, seed)
    y = _special_data(world, count, 1000 + seed)[:, ::-1].copy()
    regs = TUNINGS.get(tuning)
    if regs:
        ref.configure_tuning_parameters(RefTuning(**regs))
        port.configure_tuning_parameters(TuningParams(**regs))
    try:
        want, _ = _call(ref, True, op, x, y, count, root, func, wire)
        got, req = _call(port, False, op, x, y, count, root, func, wire)
    finally:
        if regs:
            ref.configure_tuning_parameters(RefTuning.default())
            port.configure_tuning_parameters(TuningParams.default())
    want = tensor_from_numpy(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _bits_equal_nan(got, want)
