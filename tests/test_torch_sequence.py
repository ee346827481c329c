"""The port's call sequences against its own eager calls and the JAX
facade's `accl.sequence()`, bitwise (NaN matched as NaN).

A seeded fuzz records batches of 2-4 steps drawn from SEQUENCE_OPS
without alltoall, at W in {3, 4, 8} and counts 1-4099, on the exact,
bf16 and int8 wires, over three (W, W*count) fp32 buffers (narrow steps
write a prefix and keep the tail), and two pinned int8-wire chains: each
batch runs through the port's
sequence, the port's eager calls back to back and the JAX facade's
sequence, and all three agree bitwise. Then ports of
tests/test_sequence.py (the one-dispatch chain, the cache hit,
combine/copy, run_async, the guards, descriptor renaming, host-paired
ops refused), `persistent`, SequenceProgram re-dispatch with fresh
inputs, the survival of dispatch k's results across dispatch k+1, the
lint gate through the facade, and the entry points that wait for a later
slice.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu_torch import (
    ACCL,
    CallOptions,
    DataType,
    LintError,
    Operation,
    ReduceFunction,
    SequenceDescriptor,
    SequenceReuseError,
)
from accl_tpu_torch.sequencer.plan import Algorithm, Plan, Protocol
from accl_tpu_torch.sequencer.sequence import SEQUENCE_OPS, SequencePlan

RNG = np.random.default_rng(8077)
# the fuzz's step kinds: SEQUENCE_OPS without alltoall (its slice is later)
FUZZ_OPS = tuple(op.name for op in SEQUENCE_OPS if op != Operation.alltoall)
WIRES = (None, "bfloat16", "int8")
# (world, count) per fuzz case: every world, counts from 1 to 4099 (the
# int8 wire cuts a call into 256-element segments, so its widest counts
# cost the most on both sides)
FUZZ_SHAPES = ((3, 1), (4, 4099), (8, 33), (3, 700), (4, 256), (8, 1),
               (3, 4099), (8, 257), (4, 17), (3, 64), (8, 1000), (4, 2))


# pinned int8-wire chains, (world, count, steps): the reference's
# quantized fused == eager batch (allreduce, then reduce_scatter MAX and
# allgather over its result), and bcast, reduce MAX and allgather at W = 8
PINNED = (
    (4, 256, (("allreduce", 0, 0, 1, 0, 0, "int8", 1024),
              ("reduce_scatter", 1, 0, 0, 0, 1, "int8", 256),
              ("allgather", 0, 0, 1, 0, 0, "int8", 256))),
    (8, 300, (("bcast", 0, 0, 0, 5, 0, "int8", 300),
              ("reduce", 0, 0, 1, 3, 1, "int8", 300),
              ("allgather", 1, 0, 2, 0, 0, "int8", 300))),
)


def _fuzz_case(i: int):
    """Fuzz case i: (world, count, steps), each step (op, src, src2, dst,
    root, func, wire, count); the seeded cases first, then PINNED."""
    if i >= len(FUZZ_SHAPES):
        return PINNED[i - len(FUZZ_SHAPES)]
    rng = np.random.default_rng(9100 + i)
    world, count = FUZZ_SHAPES[i]
    steps = []
    for _ in range(int(rng.integers(2, 5))):
        op = str(rng.choice(FUZZ_OPS))
        src, src2, dst = (int(v) for v in rng.integers(0, 3, 3))
        root = int(rng.integers(world))
        func = int(rng.integers(2))
        wire = (None if op in ("copy", "combine")
                else WIRES[int(rng.integers(len(WIRES)))])
        steps.append((op, src, src2, dst, root, func, wire, count))
    return world, count, steps


def _issue(ops, ref: bool, bufs, steps):
    """Issue `steps` on a facade or a recorder (the two share a method
    surface) over the three buffers."""
    F = RefF if ref else ReduceFunction
    for op, src, src2, dst, root, func, wire, count in steps:
        kw = {}
        if wire is not None:
            kw["compress_dtype"] = RefDT[wire] if ref else DataType[wire]
        a, b, c = bufs[src], bufs[src2], bufs[dst]
        if op == "copy":
            ops.copy(a, c, count)
        elif op == "combine":
            ops.combine(count, F(func), a, b, c)
        elif op == "bcast":
            ops.bcast(c, count, root, **kw)
        elif op in ("scatter", "gather"):
            getattr(ops, op)(a, c, count, root, **kw)
        elif op == "allgather":
            ops.allgather(a, c, count, **kw)
        elif op == "reduce":
            ops.reduce(a, c, count, root, F(func), **kw)
        else:  # allreduce, reduce_scatter
            getattr(ops, op)(a, c, count, F(func), **kw)


@pytest.fixture(scope="module")
def ref_facades():
    return {world: RefACCL(Mesh(np.array(jax.devices()[:world]), ("ccl",)))
            for world in (3, 4, 8)}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality with NaN matched as NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.itemsize]
    return torch.equal(a[~nan].view(ints), b[~nan].view(ints))


@pytest.mark.parametrize("i", range(len(FUZZ_SHAPES) + len(PINNED)))
def test_sequence_fuzz_bitwise_with_eager_and_reference(ref_facades, i):
    world, count, steps = _fuzz_case(i)
    width = world * count
    rng = np.random.default_rng(9200 + i)
    init = [rng.standard_normal((world, width)).astype(np.float32)
            for _ in range(3)]

    port = ACCL(world=world, torch_device="cpu")
    eager = [port.create_buffer(width, data=x) for x in init]
    _issue(port, False, eager, steps)
    fused = [port.create_buffer(width, data=x) for x in init]
    rec = port.sequence(lint="off")
    _issue(rec, False, fused, steps)
    req = rec.run()
    assert req.num_dispatches == 1 and req.num_steps == len(steps)

    ref = ref_facades[world]
    rbufs = [ref.create_buffer(width, data=x) for x in init]
    rrec = ref.sequence(lint="off")
    _issue(rrec, True, rbufs, steps)
    rrec.run()
    for k in range(3):
        want = torch.from_numpy(np.array(rbufs[k].host))
        assert same_bits(fused[k].host, eager[k].host), (steps, k)
        assert same_bits(fused[k].host, want), (steps, k)


# ---------------------------------------------------------------------------
# ports of tests/test_sequence.py
# ---------------------------------------------------------------------------


@pytest.fixture()
def port4():
    return ACCL(world=4, torch_device="cpu")


def _mk(accl, n, data=None):
    return accl.create_buffer(n, data=data)


def test_sequence_matches_eager_bitwise(port4, mesh4):
    """reduce_scatter -> allgather -> bcast recorded as one batch is
    bitwise the same calls issued back to back, and the reference's."""
    world, n = 4, 64
    chunk = n // world
    x = RNG.standard_normal((world, n)).astype(np.float32)
    a1, b1, c1 = _mk(port4, n, x), _mk(port4, chunk), _mk(port4, n)
    a2, b2, c2 = _mk(port4, n, x), _mk(port4, chunk), _mk(port4, n)
    port4.reduce_scatter(a1, b1, chunk, ReduceFunction.SUM)
    port4.allgather(b1, c1, chunk)
    port4.bcast(c1, n, 2)
    with port4.sequence() as seq:
        seq.reduce_scatter(a2, b2, chunk, ReduceFunction.SUM)
        seq.allgather(b2, c2, chunk)
        seq.bcast(c2, n, 2)
    ref = RefACCL(mesh4)
    ra, rb, rc = _mk(ref, n, x), _mk(ref, chunk), _mk(ref, n)
    with ref.sequence() as seq:
        seq.reduce_scatter(ra, rb, chunk, RefF.SUM)
        seq.allgather(rb, rc, chunk)
        seq.bcast(rc, n, 2)
    assert torch.equal(b1.host, b2.host) and torch.equal(c1.host, c2.host)
    assert torch.equal(c2.host, torch.from_numpy(np.array(rc.host)))
    np.testing.assert_allclose(c2.host.numpy(), np.tile(x.sum(0), (4, 1)),
                               rtol=1e-4, atol=1e-4)


def test_sequence_one_dispatch_and_chaining(port4):
    """The request reports one dispatch covering every step; recorder
    methods chain."""
    n = 32
    a = _mk(port4, n, RNG.standard_normal((4, n)).astype(np.float32))
    b = _mk(port4, n)
    req = (port4.sequence()
           .allreduce(a, b, n, ReduceFunction.SUM)
           .bcast(b, n, 0)
           .run())
    assert req.num_dispatches == 1
    assert req.num_steps == 2
    assert len(req.plans) == 2
    assert port4.get_duration_ns() >= 0


def test_sequence_cache_hit_builds_nothing(port4, monkeypatch):
    """A second identical batch (same shapes and dataflow, any buffers)
    hits the composite-signature cache: no new cache entry, no rebuild,
    and one lint verdict."""
    n = 48
    x = RNG.standard_normal((4, n)).astype(np.float32)
    a, b = _mk(port4, n, x), _mk(port4, n)
    with port4.sequence() as s:
        s.allreduce(a, b, n, ReduceFunction.SUM)
        s.bcast(b, n, 1)
    compiler = port4.cclo.compiler
    n_entries = len(compiler._cache)
    n_lint = len(port4.cclo._lint_cache)
    builds = []
    monkeypatch.setattr(type(compiler), "_finalize_sequence",
                        lambda self, *a, **k: builds.append(1))
    with port4.sequence() as s:  # same buffers
        s.allreduce(a, b, n, ReduceFunction.SUM)
        s.bcast(b, n, 1)
    a3, b3 = _mk(port4, n, x), _mk(port4, n)
    with port4.sequence() as s:  # other buffers, same shapes and wiring
        s.allreduce(a3, b3, n, ReduceFunction.SUM)
        s.bcast(b3, n, 1)
    assert builds == []
    assert len(compiler._cache) == n_entries
    assert len(port4.cclo._lint_cache) == n_lint
    assert torch.equal(b3.host, b.host)


def test_sequence_combine_and_copy_ride_along(port4):
    """Local primitives (copy/combine) run in the same program, bitwise
    with the eager calls."""
    n = 24
    x = RNG.standard_normal((4, n)).astype(np.float32)
    y = RNG.standard_normal((4, n)).astype(np.float32)
    bufs = [[_mk(port4, n, x), _mk(port4, n, y), _mk(port4, n),
             _mk(port4, n)] for _ in range(2)]

    def issue(ops, a, b, c, d):
        ops.combine(n, ReduceFunction.SUM, a, b, c)
        ops.allreduce(c, d, n, ReduceFunction.SUM)
        ops.copy(d, c, n)

    issue(port4, *bufs[0])
    with port4.sequence() as s:
        issue(s, *bufs[1])
    for e, f in zip(bufs[0], bufs[1]):
        assert torch.equal(e.host, f.host)
    np.testing.assert_allclose(bufs[1][2].host.numpy(),
                               np.tile((x + y).sum(0), (4, 1)),
                               rtol=1e-4, atol=1e-4)


def test_sequence_run_async(port4):
    n = 16
    x = RNG.standard_normal((4, n)).astype(np.float32)
    a, b = _mk(port4, n, x), _mk(port4, n)
    seq = port4.sequence()
    seq.allreduce(a, b, n, ReduceFunction.SUM)
    req = seq.run(run_async=True)
    assert torch.count_nonzero(b.host) == 0  # nothing placed before wait
    port4.wait(req)
    np.testing.assert_allclose(b.host.numpy(), np.tile(x.sum(0), (4, 1)),
                               rtol=1e-4, atol=1e-4)


def test_sequence_guards(port4):
    n = 8
    a, b = _mk(port4, n), _mk(port4, n)
    seq = port4.sequence()
    with pytest.raises(ValueError, match="empty sequence"):
        seq.run()
    seq.allreduce(a, b, n, ReduceFunction.SUM)
    seq.run()
    with pytest.raises(SequenceReuseError, match="already executed"):
        seq.allreduce(a, b, n, ReduceFunction.SUM)
    with pytest.raises(RuntimeError, match="already executed"):
        seq.run()
    with pytest.raises(RuntimeError, match="already executed"):
        seq.compile()
    # a failing body inside the context manager must not shadow the error
    with pytest.raises(ZeroDivisionError):
        with port4.sequence() as s:
            s.allreduce(a, b, n, ReduceFunction.SUM)
            raise ZeroDivisionError
    with pytest.raises(ValueError, match="lint must be"):
        port4.sequence(lint="strict")


def test_sequence_descriptor_roundtrip_and_renaming():
    """The batched word stream round-trips; the composite signature
    renames addresses canonically (same wiring over other buffers: same
    signature; other wiring: another)."""
    def opts(addr0, addr2):
        return CallOptions(scenario=Operation.allreduce, count=8,
                           data_type=DataType.float32,
                           addr_0=addr0, addr_2=addr2)

    d1 = SequenceDescriptor((opts(0x100, 0x200), opts(0x200, 0x300)))
    d2 = SequenceDescriptor((opts(0x111, 0x222), opts(0x222, 0x333)))
    d3 = SequenceDescriptor((opts(0x111, 0x222), opts(0x111, 0x333)))
    assert d1.signature() == d2.signature()
    assert d1.signature() != d3.signature()
    rt = SequenceDescriptor.from_words(d1.to_words())
    assert rt.to_words() == d1.to_words()
    assert len(rt.steps) == 2 and rt.steps[0].addr_0 == 0x100
    with pytest.raises(ValueError, match="one communicator"):
        SequenceDescriptor((
            CallOptions(scenario=Operation.allreduce, count=8, comm_addr=0),
            CallOptions(scenario=Operation.allreduce, count=8,
                        comm_addr=0x1000),
        ))
    with pytest.raises(ValueError, match="empty call sequence"):
        SequenceDescriptor(())


def test_sequence_descriptor_signature_matches_reference():
    """The composite signature (the compile and lint cache key) renames
    exactly as the reference's does."""
    from accl_tpu.constants import Operation as RefOp
    from accl_tpu.descriptor import CallOptions as RefOpts
    from accl_tpu.descriptor import SequenceDescriptor as RefDesc

    addrs = [(0x10, 0, 0x20), (0x20, 0x30, 0x10), (0x40, 0, 0x40)]
    ops = (Operation.allreduce, Operation.combine, Operation.bcast)
    port = SequenceDescriptor(tuple(
        CallOptions(scenario=op, count=5, addr_0=a0, addr_1=a1, addr_2=a2)
        for op, (a0, a1, a2) in zip(ops, addrs)))
    ref = RefDesc(tuple(
        RefOpts(scenario=RefOp[op.name], count=5, addr_0=a0, addr_1=a1,
                addr_2=a2)
        for op, (a0, a1, a2) in zip(ops, addrs)))
    assert port.signature()[2] == ref.signature()[2]
    assert port.to_words() == ref.to_words()


def test_sequence_rejects_host_paired_ops():
    """send/recv/barrier cannot ride a batch (a forged descriptor: the
    recorder has no method for them)."""
    opts = CallOptions(scenario=Operation.send, count=8,
                       data_type=DataType.float32, addr_0=1, addr_2=2)
    plan = Plan(Protocol.EAGER, Algorithm.EAGER_SENDRECV, 8, 1)
    with pytest.raises(ValueError, match="cannot ride"):
        SequencePlan(SequenceDescriptor((opts,)), [plan], 4)


def test_sequence_persistent_waives_the_stale_tail(port4):
    """A batch that refreshes a prefix of a buffer and reads it whole is
    ACCL101 unless the buffer is declared persistent; declared, it runs,
    bitwise with the eager calls."""
    n, part = 64, 16
    x = RNG.standard_normal((4, n)).astype(np.float32)

    def bufs():
        return _mk(port4, n, x), _mk(port4, n, x), _mk(port4, n)

    def issue(ops, a, state, out):
        ops.allreduce(a, state, part, ReduceFunction.SUM)
        ops.allreduce(state, out, n, ReduceFunction.MAX)

    a, state, out = bufs()
    rec = port4.sequence()
    issue(rec, a, state, out)
    with pytest.raises(LintError) as e:
        rec.run()
    assert "ACCL101" in e.value.codes
    a2, s2, o2 = bufs()
    issue(port4, a2, s2, o2)
    a, state, out = bufs()
    rec = port4.sequence(persistent=[state])
    issue(rec, a, state, out)
    rec.run()
    assert torch.equal(state.host, s2.host) and torch.equal(out.host, o2.host)


def test_sequence_lint_warn_and_off_run_the_batch(port4):
    """lint="warn" logs and runs a batch the default gate rejects (a read
    past its producer's prefix, ACCL101), "off" skips the gate; both
    results are the eager calls'. A static width underflow is ACCL405."""
    n, part = 16, 4
    x = RNG.standard_normal((4, n)).astype(np.float32)

    def issue(ops, a, b, c):
        ops.allreduce(a, b, part, ReduceFunction.SUM)
        ops.copy(b, c, n)

    e = [_mk(port4, n, x), _mk(port4, n, x), _mk(port4, n)]
    issue(port4, *e)
    for mode in ("error", "warn", "off"):
        f = [_mk(port4, n, x), _mk(port4, n, x), _mk(port4, n)]
        rec = port4.sequence(lint=mode)
        issue(rec, *f)
        if mode == "error":
            with pytest.raises(LintError) as err:
                rec.run()
            assert err.value.codes == ("ACCL101",)
            continue
        rec.run()
        assert torch.equal(f[2].host, e[2].host)
    a, b, c = _mk(port4, n, x), _mk(port4, n), _mk(port4, n)
    rec = port4.sequence()
    rec.copy(a, b, 2 * n)  # wider than the buffers: ACCL405
    with pytest.raises(LintError) as e:
        rec.run()
    assert e.value.codes == ("ACCL405", "ACCL405")  # a and b


def test_program_redispatch_with_fresh_inputs(port4):
    """A compiled SequenceProgram re-runs over the bound buffers' current
    contents: each dispatch equals the eager chain on that dispatch's
    inputs, and the program is prepared once."""
    n = 40
    a, b, c = _mk(port4, n), _mk(port4, n), _mk(port4, 4 * n)
    rec = port4.sequence()
    rec.allreduce(a, b, n, ReduceFunction.SUM)
    rec.allgather(b, c, n, compress_dtype=DataType.bfloat16)
    prog = rec.compile()
    assert len(prog.plans) == 2 and prog.n_steps == 2
    graph = prog.graph
    assert graph.graph is None  # the CPU runs the body, no CUDA graph
    assert graph.load_bytes == 2 * 4 * 4 * (n + n + 4 * n)
    for k in range(3):
        x = RNG.standard_normal((4, n)).astype(np.float32)
        a.host = torch.from_numpy(x)
        prog.run()
        ea, eb, ec = _mk(port4, n, x), _mk(port4, n), _mk(port4, 4 * n)
        port4.allreduce(ea, eb, n, ReduceFunction.SUM)
        port4.allgather(eb, ec, n, compress_dtype=DataType.bfloat16)
        assert torch.equal(b.host, eb.host) and torch.equal(c.host, ec.host)
        assert prog.graph is graph


def test_dispatch_results_survive_the_next_dispatch(port4):
    """The result tensors placed by dispatch k stay unchanged, bitwise,
    after dispatch k+1 runs on other inputs (results leave the prepared
    graph's memory before they are placed)."""
    n = 32
    a, b, c = _mk(port4, n), _mk(port4, n), _mk(port4, n)
    rec = port4.sequence()
    rec.copy(a, c, n)  # an output that is its input's value
    rec.allreduce(a, b, n, ReduceFunction.SUM)
    prog = rec.compile()
    kept = []
    for k in range(3):
        a.host = torch.from_numpy(
            RNG.standard_normal((4, n)).astype(np.float32))
        prog.run(to_device=True)
        kept.append([(t, t.clone()) for t in (b.device, c.device)])
    for tensors in kept[:-1]:
        for t, saved in tensors:
            assert torch.equal(t, saved)
    assert not torch.equal(kept[0][0][1], kept[1][0][1])
    # no result aliases the graph's static inputs or outputs
    graph = prog.graph
    pool = [t.data_ptr() for t in (*graph.inputs, *graph.outputs)]
    assert b.device.data_ptr() not in pool
    assert c.device.data_ptr() not in pool


def test_unported_steps_and_tiers_raise(port4):
    """What used to raise here runs now: the deep lint tier records and
    prepares (an empty batch is refused as the reference refuses it),
    alltoall(v) steps record, stream_put on an unregistered producer is a
    KeyError as in the reference, and a batch addressing a two-rank
    communicator table runs over rows 0 and 2 only."""
    from accl_tpu_torch.communicator import Communicator, Rank

    n = 8
    a, b = _mk(port4, 4 * n), _mk(port4, 4 * n)
    assert len(port4.sequence().alltoall(a, b, n)) == 1
    assert len(port4.sequence().alltoallv(a, b, n, [n, 1, 2, 3])) == 1
    deep = port4.sequence(lint="deep")
    deep.reduce_scatter(a, b, n, ReduceFunction.SUM).allgather(b, a, n)
    prog = deep.compile()
    assert prog.footprint is not None and prog.certificate is None
    prog.run()
    with pytest.raises(ValueError, match="empty call sequence"):
        port4.cclo.prepare_sequence([], lint="deep")
    with pytest.raises(KeyError, match="no producer registered on stream 5"):
        port4.stream_put(n, 5, 0, 1, a)
    # a descriptor addressing a two-rank communicator table
    sub = Communicator([Rank(device_index=i, session_id=i) for i in (0, 2)],
                       0, 0x1800)
    port4._write_communicator(sub)
    opts = port4._prepare(Operation.allreduce, a, None, b, n)
    opts.comm_addr = sub.exchmem_addr
    before = b.device.clone()
    port4.cclo.start_sequence([opts]).wait()
    assert torch.equal(b.device[[1, 3]], before[[1, 3]])
    want = a.device[0, :n] + a.device[2, :n]
    assert torch.equal(b.device[[0, 2], :n], torch.stack([want, want]))
    assert torch.equal(b.device[[0, 2], n:], before[[0, 2], n:])


def test_step_accesses_match_reference():
    """The (address, prefix) access model of a step, for every sequence
    op, with and without a second operand, at W = 1 and 5."""
    from accl_tpu.constants import Operation as RefOp
    from accl_tpu.descriptor import CallOptions as RefOpts
    from accl_tpu.sequencer.sequence import step_accesses as ref_accesses
    from accl_tpu_torch.sequencer.sequence import step_accesses

    for op in SEQUENCE_OPS:
        for world in (1, 5):
            for a1 in (0, 0x30):
                kw = dict(count=7, addr_0=0x10, addr_1=a1, addr_2=0x20)
                assert step_accesses(CallOptions(scenario=op, **kw),
                                     world) == ref_accesses(
                    RefOpts(scenario=RefOp[op.name], **kw), world)
