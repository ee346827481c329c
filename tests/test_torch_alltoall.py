"""The port's alltoall and alltoallv against the JAX facade's, bitwise on
every row.

alltoall and alltoallv (the capacity-bounded MoE dispatch) on the exact,
fp16, bf16 and int8 wires, with a slot that is a whole number of
quantization blocks (512: the int8 wire's aligned exchange, one encode
and one decode of the whole buffer) and one that is not (1000: an encode
and a decode of every rank's slot a hop), at W = 3, 5 and 8, in a
pairwise cover; the ALLTOALL_COMPRESS_MIN_COUNT register
(tests/test_plan_selection.py's cases, and end to end); a full capacity
vector sharing the dense program; alltoall steps inside a call sequence
(fused == eager == the JAX facade's sequence).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import TuningParams as RefTuning
from accl_tpu_torch import (
    ACCL,
    CallOptions,
    CompressionFlags,
    DataType,
    Operation,
    TuningParams,
)
from accl_tpu_torch.interop import tensor_from_numpy
from accl_tpu_torch.ops import quant_kernels
from accl_tpu_torch.sequencer.plan import Algorithm

SENTINEL = -3.0


@pytest.fixture(scope="module")
def facades(mesh8):
    out = {}
    for world in (8, 5, 3):
        mesh = mesh8 if world == 8 else Mesh(
            np.array(jax.devices()[:world]), ("ccl",))
        out[world] = (RefACCL(mesh), ACCL(world=world, torch_device="cpu"))
    return out


def same(got: torch.Tensor, want) -> bool:
    """Bitwise equal."""
    want = tensor_from_numpy(np.asarray(want))
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(torch.int32), want.view(torch.int32)))


def _capacities(world: int, count: int) -> tuple[int, ...]:
    """The MoE expert-capacity pattern: 1, 3/4, 1/2, 1/4 of the slot."""
    return tuple(max(count * (4 - r % 4) // 4, 1) for r in range(world))


def _run(accl, ref, x, count, wire, peer_counts):
    world = x.shape[0]
    sb = accl.create_buffer(world * count, data=x)
    rb = accl.create_buffer(world * count, data=np.full(
        (world, world * count), SENTINEL, np.float32))
    kw = {}
    if wire is not None:
        kw["compress_dtype"] = (RefDT if ref else DataType)[wire]
    if peer_counts is None:
        req = accl.alltoall(sb, rb, count, **kw)
    else:
        req = accl.alltoallv(sb, rb, count, peer_counts, **kw)
    return rb.host, req


def _oracle(x, count, peer_counts=None):
    """numpy's transpose of the [rank, slot] grid, slots cut to the
    receiver's capacity."""
    world = x.shape[0]
    out = x.reshape(world, world, count).transpose(1, 0, 2).copy()
    if peer_counts is not None:
        for r, c in enumerate(peer_counts):
            out[r, :, c:] = 0
    return out.reshape(world, world * count)


CASES = [  # (world, count, wire, v)
    (8, 512, None, False), (8, 1000, None, True), (8, 512, "int8", True),
    (8, 1000, "int8", False), (5, 512, "int8", False),
    (5, 1000, "int8", True), (5, 512, None, True), (5, 1000, "bfloat16",
                                                    False),
    (3, 512, "int8", False), (3, 1000, "int8", False), (3, 512, "int8", True),
    (3, 1000, None, False), (3, 1000, "float16", True), (8, 1000, "float16",
                                                         False),
]


@pytest.mark.parametrize("world,count,wire,v", CASES, ids=lambda c: str(c))
def test_alltoall_bitwise_with_reference_facade(facades, world, count, wire,
                                                v):
    x = np.random.default_rng(world * 7 + count).standard_normal(
        (world, world * count)).astype(np.float32)
    x[0, :4] = (1e-39, -0.0, 7e4, -2e-40)  # subnormals, -0, past fp16
    pc = _capacities(world, count) if v else None
    ref, port = facades[world]
    want, _ = _run(ref, True, x, count, wire, pc)
    got, req = _run(port, False, x, count, wire, pc)
    assert same(got, want)
    if wire is None:
        assert same(got, _oracle(x, count, pc))
    me = np.arange(world)
    grid = got.reshape(world, world, count)
    own = x.reshape(world, world, count)[me, me]
    if pc is not None:
        own = own.copy()
        for r, c in enumerate(pc):
            own[r, c:] = 0
    assert same(grid[me, me], own)  # the local slot never crosses a wire
    assert req.plan.algorithm == (Algorithm.FLAT_ALLTOALLV if v
                                  else Algorithm.FLAT_ALLTOALL)


class _Counter:
    """Counts calls of a quant_kernels entry (the CPU has no launches)."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(quant_kernels, name)

        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(quant_kernels, name, counted)


@pytest.mark.parametrize("count,v,encodes", [
    (512, False, {"quantize": 1, "dequantize": 1,
                  "quantize_packed": 0, "dequantize_packed": 0}),
    (1000, False, {"quantize": 0, "dequantize": 0,
                   "quantize_packed": 4, "dequantize_packed": 4}),
    (512, True, {"quantize": 0, "dequantize": 0,
                 "quantize_packed": 4, "dequantize_packed": 4}),
])
def test_int8_exchange_encodes(monkeypatch, count, v, encodes):
    """The aligned int8 alltoall encodes and decodes the whole buffer once
    (kernel 5 and kernel 6 once each on the card); the unaligned one and
    alltoallv once a hop each (W-1 of each, as wire messages)."""
    counters = {n: _Counter(monkeypatch, n) for n in encodes}
    world = 5
    port = ACCL(world=world, torch_device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (world, world * count)).astype(np.float32)
    _run(port, False, x, count, "int8", _capacities(world, count) if v
         else None)
    assert {n: c.calls for n, c in counters.items()} == encodes


def test_full_vector_shares_the_dense_program(facades):
    """An all-full capacity vector normalizes at the descriptor: the same
    built body as the dense alltoall, and its bits."""
    ref, port = facades[8]
    count = 64
    x = np.arange(8 * 8 * count, dtype=np.float32).reshape(8, 8 * count)
    a = port.create_buffer(8 * count, data=x)
    b, c = port.create_buffer(8 * count), port.create_buffer(8 * count)
    port.alltoall(a, b, count)
    n_before = len(port.cclo.compiler._cache)
    req = port.alltoallv(a, c, count, (count,) * 8)
    assert len(port.cclo.compiler._cache) == n_before
    assert req.plan.peer_counts == ()
    assert same(c.host, np.asarray(b.host))
    with pytest.raises(ValueError, match="one send count per rank"):
        port.alltoallv(a, c, count, (count,) * 7)
    with pytest.raises(ValueError, match="exceed"):
        port.alltoallv(a, c, count, (count + 1,) + (count,) * 7)


def test_compress_register_zero_leaves_the_descriptor():
    dev = ACCL(world=8, torch_device="cpu").cclo
    opts = CallOptions(scenario=Operation.alltoall, count=4096,
                       data_type=DataType.float32)
    assert dev._apply_alltoall_wire(opts, dev.tuning()) is opts


def test_compress_register_rewrites_eligible_calls_only():
    """At or above the register an uncompressed fp32 alltoall gains the
    int8 wire; below it, other dtypes, explicit wires and other
    collectives pass untouched; alltoallv keeps its vector and is gated
    on max(peer_counts), what crosses a hop."""
    world = 8
    dev = ACCL(world=world, torch_device="cpu").cclo
    tuning = TuningParams(alltoall_compress_min_count=4096)

    def a2a(count=1024, dtype=DataType.float32, **kw):
        return CallOptions(scenario=Operation.alltoall, count=count,
                           data_type=dtype, **kw)

    got = dev._apply_alltoall_wire(a2a(), tuning)  # 4096 B == min
    assert got.compress_dtype == DataType.int8
    assert got.compression_flags & CompressionFlags.ETH_COMPRESSED
    for opts in (a2a(count=1023), a2a(dtype=DataType.float64),
                 a2a(compress_dtype=DataType.float16,
                     compression_flags=CompressionFlags.ETH_COMPRESSED),
                 CallOptions(scenario=Operation.allreduce, count=4096,
                             data_type=DataType.float32)):
        assert dev._apply_alltoall_wire(opts, tuning) is opts
    v = a2a(peer_counts=(512,) * (world - 1) + (1024,))
    got_v = dev._apply_alltoall_wire(v, tuning)
    assert got_v.peer_counts == v.peer_counts
    assert got_v.compress_dtype == DataType.int8
    capped = a2a(count=4096, peer_counts=(512,) * world)  # hop 2 KiB
    assert dev._apply_alltoall_wire(capped, tuning) is capped
    open_v = a2a(count=4096, peer_counts=(1024,) * (world - 1) + (4096,))
    assert dev._apply_alltoall_wire(open_v, tuning).compress_dtype == \
        DataType.int8


@pytest.mark.parametrize("count,v", [(512, False), (1000, True)])
def test_compress_register_end_to_end(facades, count, v):
    """With the register set both facades run an fp32 alltoall(v) on the
    int8 wire, bitwise the same as the explicit compress_dtype call;
    register 0 gives the exact wire's bits."""
    ref, port = facades[5]
    x = np.random.default_rng(count).standard_normal(
        (5, 5 * count)).astype(np.float32)
    pc = _capacities(5, count) if v else None
    exact, _ = _run(port, False, x, count, None, pc)
    explicit, _ = _run(port, False, x, count, "int8", pc)
    regs = dict(alltoall_compress_min_count=1024)
    ref.configure_tuning_parameters(RefTuning(**regs))
    port.configure_tuning_parameters(TuningParams(**regs))
    try:
        want, _ = _run(ref, True, x, count, None, pc)
        got, req = _run(port, False, x, count, None, pc)
    finally:
        ref.configure_tuning_parameters(RefTuning.default())
        port.configure_tuning_parameters(TuningParams.default())
    assert same(got, want) and same(got, explicit)
    assert not same(got, exact)
    assert req.plan.wire_dtype == DataType.int8
    again, _ = _run(port, False, x, count, None, pc)
    assert same(again, exact)


def test_alltoall_steps_in_a_sequence(facades):
    """alltoall and alltoallv steps (the int8 wire on one) inside a
    recorded batch: the fused dispatch is bitwise the same calls issued
    eagerly and the JAX facade's sequence, on two input sets."""
    ref, port = facades[5]
    w, count = 5, 512
    pc = _capacities(w, count)
    rng = np.random.default_rng(55)

    def bufs(accl, x):
        return [accl.create_buffer(w * count, data=x)] + [
            accl.create_buffer(w * count) for _ in range(2)]

    def record(ops, is_ref, a, b, c):
        dt = (RefDT if is_ref else DataType).int8
        ops.alltoall(a, b, count, compress_dtype=dt)
        ops.alltoallv(b, c, count, pc)

    x = rng.standard_normal((w, w * count)).astype(np.float32)
    rb, fb, eb = bufs(ref, x), bufs(port, x), bufs(port, x)
    seq = ref.sequence()
    record(seq, True, *rb)
    seq.run()
    rec = port.sequence()
    record(rec, False, *fb)
    prog = rec.compile()
    prog.run()
    record(port, False, *eb)
    for k in (1, 2):
        assert same(fb[k].host, np.asarray(rb[k].host)), k
        assert same(eb[k].host, np.asarray(rb[k].host)), k
    x2 = rng.standard_normal((w, w * count)).astype(np.float32)
    fb[0].host = torch.from_numpy(x2)
    eb[0].host = torch.from_numpy(x2)
    prog.run()
    record(port, False, *eb)
    assert same(fb[2].host, eb[2].host.numpy())
    assert [p.algorithm for p in prog.plans] == [Algorithm.FLAT_ALLTOALL,
                                                 Algorithm.FLAT_ALLTOALLV]
