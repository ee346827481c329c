"""The port's streamed collectives against the JAX facade's, bitwise.

The streamed-collective cases of tests/test_streams.py without send/recv
and stream_put (tests/test_torch_p2p.py has those), at W = 8: OP0_STREAM / RES_STREAM on
allreduce, bcast, scatter, gather, reduce, reduce_scatter and allgather,
copy_from_stream, copy_to_stream, copy_from_to_stream, the stream id
rules and re-registration, and streams spliced into a call sequence.
Each runs the reference's producer on the JAX facade and the same
producer in the port's calling convention (ops/streams.py: called with
the (world, 1) rank indices, returning the stacked (world, n) operand)
on the port's, on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu_torch import (
    ACCL,
    CallOptions,
    DataType,
    Operation,
    ReduceFunction,
    StreamFlags,
)

WORLD = 8
RNG = np.random.default_rng(3317)


@pytest.fixture(scope="module")
def pair(mesh8):
    return RefACCL(mesh8), ACCL(world=WORLD, torch_device="cpu")


def _rows(buf):
    """A reference producer's view of its own rank's row of `buf`."""
    me = lax.axis_index("ccl")
    return lax.dynamic_index_in_dim(buf.device, me, 0, keepdims=False)


def _same(port_buf, ref_buf) -> bool:
    want = torch.from_numpy(np.array(ref_buf.host))
    return torch.equal(port_buf.host.view(torch.int32), want.view(torch.int32))


def _bufs(pair, n, data=None):
    ref, port = pair
    return ref.create_buffer(n, data=data), port.create_buffer(n, data=data)


@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_streamed_allreduce_op0_and_res(pair, scale):
    """Every rank's contribution comes from a producer, the reduced
    result passes through a consumer. The reference's producer (x * 3)
    feeds its ring's first fold, and XLA contracts that multiply and add
    into one fused multiply-add under jit, which the port's producer (a
    tensor of its own) cannot: with 3 the port is bitwise with its own
    eager twin (the allreduce of the produced buffer, then the consumer)
    and within the ring's rounding bound of the reference; with 2 (an
    exact multiply, which the contraction cannot change) bitwise with
    the reference too."""
    ref, port = pair
    n = 64
    base = RNG.standard_normal((WORLD, n)).astype(np.float32)
    (rs, ps), (ro, po) = _bufs(pair, n, base), _bufs(pair, n)
    ref.register_stream_producer(21, lambda: _rows(rs) * scale)
    port.register_stream_producer(21, lambda ranks: ps.device[ranks[:, 0]]
                                  * scale)
    for accl in pair:
        accl.register_stream_consumer(22, lambda x: x + 1.0)
    ref.allreduce(rs, ro, n, RefF.SUM, op0_stream=21, res_stream=22)
    port.allreduce(ps, po, n, ReduceFunction.SUM, op0_stream=21,
                   res_stream=22)
    scaled = base * np.float32(scale)
    es, eo = port.create_buffer(n, data=scaled), port.create_buffer(n)
    port.allreduce(es, eo, n, ReduceFunction.SUM)
    assert torch.equal(po.host, eo.host + 1.0)
    if scale == 2.0:
        assert _same(po, ro)
    # both rings fold W-1 times (one rounding each, the contraction
    # saves one of the products'), then the consumer's add rounds once
    u = 2.0 ** -24
    bound = ((WORLD - 1) * u * np.abs(scaled).sum(0)
             + 2 * u * (np.abs(scaled.sum(0)) + 1.0))
    err = np.abs(po.host.numpy() - np.array(ro.host))
    assert (err <= bound).all(), err.max()


def test_streamed_bcast_res_stream(pair):
    """The broadcast value lands through each rank's consumer."""
    ref, port = pair
    n = 32
    x = RNG.standard_normal((WORLD, n)).astype(np.float32)
    rb, pb = _bufs(pair, n, x)
    for accl in pair:
        accl.register_stream_consumer(23, lambda v: v * v)
    ref.bcast(rb, n, root=4, res_stream=23)
    port.bcast(pb, n, root=4, res_stream=23)
    assert _same(pb, rb)
    assert torch.equal(pb.host, torch.from_numpy(np.tile(x[4] * x[4],
                                                         (WORLD, 1))))


def test_streams_through_every_collective(pair):
    """OP0/RES_STREAM through scatter, gather, reduce, reduce_scatter and
    allgather (the reference's alltoall case waits for its slice)."""
    ref, port = pair
    n = 16
    x = RNG.standard_normal((WORLD, n * WORLD)).astype(np.float32)
    (rbig, pbig), (rsmall, psmall) = _bufs(pair, n * WORLD, x), _bufs(pair, n)
    rsmall2, psmall2 = _bufs(pair, n, x[:, :n].copy())
    for accl in pair:
        accl.register_stream_consumer(31, lambda v: v + 10.0)
        accl.register_stream_consumer(33, lambda v: v - 1.0)
    ref.register_stream_producer(32, lambda: _rows(rsmall2) * 2.0)
    port.register_stream_producer(
        32, lambda ranks: psmall2.device[ranks[:, 0]] * 2.0)
    ref.register_stream_producer(34, lambda: _rows(rbig))
    port.register_stream_producer(34, lambda ranks: pbig.device[ranks[:, 0]])

    ref.scatter(rbig, rsmall, n, root=3, res_stream=31)
    port.scatter(pbig, psmall, n, root=3, res_stream=31)
    assert _same(psmall, rsmall)
    (rg, pg), (rr, pr), (rrs, prs), (rag, pag) = (
        _bufs(pair, n * WORLD), _bufs(pair, n), _bufs(pair, n),
        _bufs(pair, n * WORLD))
    ref.gather(rsmall2, rg, n, root=5, op0_stream=32)
    port.gather(psmall2, pg, n, root=5, op0_stream=32)
    ref.reduce(rsmall2, rr, n, 2, RefF.SUM, op0_stream=32, res_stream=33)
    port.reduce(psmall2, pr, n, 2, ReduceFunction.SUM, op0_stream=32,
                res_stream=33)
    ref.reduce_scatter(rbig, rrs, n, RefF.SUM, op0_stream=34, res_stream=31)
    port.reduce_scatter(pbig, prs, n, ReduceFunction.SUM, op0_stream=34,
                        res_stream=31)
    ref.allgather(rsmall2, rag, n, res_stream=31)
    port.allgather(psmall2, pag, n, res_stream=31)
    for p, r in ((pg, rg), (pr, rr), (prs, rrs), (pag, rag)):
        assert _same(p, r)
    np.testing.assert_allclose(pg.host.numpy()[5],
                               (x[:, :n] * 2.0).reshape(-1), rtol=1e-6)


def test_stream_ids_do_not_ride_the_tag(pair):
    """Stream ids live in their own descriptor bytes: arming streams
    leaves the tag alone and survives the 15-word round trip."""
    _, port = pair
    opts = CallOptions(scenario=Operation.allreduce, count=8, tag=42)
    port._stream_opts(opts, 21, 22)
    assert opts.tag == 42
    assert opts.op0_stream_id == 21 and opts.res_stream_id == 22
    rt = CallOptions.from_words(opts.to_words())
    assert rt.tag == 42
    assert rt.op0_stream_id == 21 and rt.res_stream_id == 22
    assert rt.stream_flags == (StreamFlags.OP0_STREAM
                               | StreamFlags.RES_STREAM)


def test_streamed_bcast_op0_from_root(pair):
    """OP0_STREAM on bcast: only the root's produced value propagates."""
    ref, port = pair
    n = 16
    rb, pb = _bufs(pair, n)

    def ref_producer():
        me = lax.axis_index("ccl")
        return (me.astype(jnp.float32) + 1.0) * jnp.ones(n, jnp.float32)

    ref.register_stream_producer(24, ref_producer)
    port.register_stream_producer(
        24, lambda ranks: (ranks.to(torch.float32) + 1.0)
        * torch.ones((WORLD, n), dtype=torch.float32))
    ref.bcast(rb, n, root=6, op0_stream=24)
    port.bcast(pb, n, root=6, op0_stream=24)
    assert _same(pb, rb)
    assert torch.equal(pb.host, torch.full((WORLD, n), 7.0))


def test_stream_id_validation_and_stream_put(pair):
    _, port = pair
    with pytest.raises(ValueError):
        port.register_stream_producer(0, lambda ranks: None)
    with pytest.raises(ValueError):
        port.register_stream_consumer(247, lambda v: v)
    out = port.create_buffer(8)
    with pytest.raises(KeyError, match="no consumer registered"):
        port.copy_to_stream(out, 8, res_stream=77)
    # stream_put is ported: an unregistered producer is a KeyError, as in
    # the reference, and a registered one's row 0 lands in row 1
    with pytest.raises(KeyError, match="no producer registered on stream 13"):
        port.stream_put(8, stream_id=13, src=0, dst=1, recvbuf=out)
    made = torch.arange(WORLD * 8, dtype=torch.float32).reshape(WORLD, 8)
    port.register_stream_producer(13, lambda ranks: made)
    port.stream_put(8, stream_id=13, src=0, dst=1, recvbuf=out)
    want = made.clone()
    want[1] = made[0]
    assert torch.equal(out.host, want)
    port.register_stream_producer(12, lambda ranks: torch.ones(WORLD))
    with pytest.raises(ValueError, match="stacked"):
        port.copy_from_stream(out, 8, op0_stream=12)


def test_stream_reregistration_takes_effect(pair):
    """Re-registering a stream endpoint never meets a stale body."""
    _, port = pair
    out = port.create_buffer(8)
    port.register_stream_producer(11, lambda r: torch.ones((WORLD, 8)))
    port.copy_from_stream(out, 8, op0_stream=11)
    assert torch.equal(out.host, torch.ones((WORLD, 8)))
    port.register_stream_producer(11, lambda r: 2 * torch.ones((WORLD, 8)))
    port.copy_from_stream(out, 8, op0_stream=11)
    assert torch.equal(out.host, 2 * torch.ones((WORLD, 8)))


def test_copy_from_stream(pair):
    ref, port = pair
    n = 24
    rd, pd = _bufs(pair, n)
    ref.register_stream_producer(
        43, lambda: jnp.arange(24, dtype=jnp.float32))
    port.register_stream_producer(
        43, lambda ranks: torch.arange(24, dtype=torch.float32).expand(
            WORLD, 24))
    ref.copy_from_stream(rd, n, op0_stream=43)
    port.copy_from_stream(pd, n, op0_stream=43)
    assert _same(pd, rd)


def test_copy_to_stream(pair):
    """The buffer routes through the consumer; dstbuf captures its
    result; the buffer-less form runs too, also asynchronously (its
    private placeholder is released at wait)."""
    ref, port = pair
    n = 24
    x = RNG.standard_normal((WORLD, n)).astype(np.float32)
    (rs, ps), (rc, pc) = _bufs(pair, n, x), _bufs(pair, n)
    for accl in pair:
        accl.register_stream_consumer(44, lambda v: v * 4.0)
    ref.copy_to_stream(rs, n, res_stream=44, dstbuf=rc)
    port.copy_to_stream(ps, n, res_stream=44, dstbuf=pc)
    assert _same(pc, rc)
    port.copy_to_stream(ps, n, res_stream=44).check()
    n_bufs = len(port.cclo.buffers)
    req = port.copy_to_stream(ps, n, res_stream=44, run_async=True)
    assert len(port.cclo.buffers) == n_bufs + 1
    port.wait(req)
    assert len(port.cclo.buffers) == n_bufs


def test_copy_from_to_stream(pair):
    ref, port = pair
    n = 16
    rc, pc = _bufs(pair, n)
    ref.register_stream_producer(45, lambda: jnp.full(16, 3.0, jnp.float32))
    port.register_stream_producer(
        45, lambda ranks: torch.full((WORLD, 16), 3.0))
    for accl in pair:
        accl.register_stream_consumer(46, lambda v: v + 0.5)
    ref.copy_from_to_stream(RefDT.float32, n, op0_stream=45, res_stream=46,
                            dstbuf=rc)
    port.copy_from_to_stream(DataType.float32, n, op0_stream=45,
                             res_stream=46, dstbuf=pc)
    assert _same(pc, rc)
    assert torch.equal(pc.host, torch.full((WORLD, n), 3.5))


def test_sequence_streams_spliced(pair):
    """Producer and consumer endpoints ride sequence steps as they ride
    the eager streamed calls, bitwise with the reference's sequence and
    the port's eager calls."""
    ref, port = pair
    n = 16
    payload = RNG.standard_normal(n).astype(np.float32)
    ref.register_stream_producer(5, lambda: jnp.asarray(payload))
    port.register_stream_producer(
        5, lambda ranks: torch.from_numpy(payload).expand(WORLD, n))
    for accl in pair:
        accl.register_stream_consumer(6, lambda x: x * 2.0)
    (ra, pa), (rb, pb) = _bufs(pair, n), _bufs(pair, n)
    with ref.sequence() as s:
        s.bcast(ra, n, 0, op0_stream=5)
        s.allreduce(ra, rb, n, RefF.SUM, res_stream=6)
    with port.sequence() as s:
        s.bcast(pa, n, 0, op0_stream=5)
        s.allreduce(pa, pb, n, ReduceFunction.SUM, res_stream=6)
    assert _same(pa, ra) and _same(pb, rb)
    ea, eb = port.create_buffer(n), port.create_buffer(n)
    port.bcast(ea, n, 0, op0_stream=5)
    port.allreduce(ea, eb, n, ReduceFunction.SUM, res_stream=6)
    assert torch.equal(eb.host, pb.host)
    # a producer on a combine step is refused, as in the reference
    with pytest.raises(ValueError, match="OP0_STREAM unsupported"):
        with port.sequence() as s:
            s._record(s._prep(Operation.combine, pa, pb, pa, n, 5,
                              function=0), [pa, pb], [pa])
