"""The port's point-to-point calls against the JAX facade's, bitwise on
every row of every result.

A recv writes its whole result buffer: row dst gets row src of the send
buffer (through the wire), every other row that rank's own send-buffer
row. So each case compares all rows, not only dst's. Covered: the
pairing cases of tests/test_accl_facade.py (send first, recv first, FIFO
per signature, TAG_ANY in arrival order, distinct tags out of order, the
timeout, soft_reset and the rx dump), the parked-send cap, the async
stress from two threads (port only, payloads checked against the
sender's row), the `_sample_p2p()` families of
tests/test_cross_executor_fuzz.py against the JAX facade, send/recv on
the fp16, bf16 and int8 wires, and `stream_put` and the streamed
send/recv pair of tests/test_streams.py.

On a compressed wire the reference's pair keeps only the compression
flag, so its lowering runs the first compressed row of the dtype's table
(fp16 for fp32) whatever wire the recv named; the port runs the named
wire. So the fp16 wire is held against the JAX facade and the bf16 and
int8 wires against the JAX package's own wire functions on row src.
"""

import importlib.util
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import TAG_ANY as REF_TAG_ANY
from accl_tpu.ops.compression import dequantize_blockwise, quantize_blockwise
from accl_tpu_torch import ACCL, ACCLError, DataType, ErrorCode, TAG_ANY
from accl_tpu_torch.interop import tensor_from_numpy

WORLD = 8
SHORT_TIMEOUT_US = 50_000  # a recv's wait where a test expects a timeout


@pytest.fixture(scope="module")
def pair(mesh8):
    return RefACCL(mesh8), ACCL(world=WORLD, torch_device="cpu")


def same(got: torch.Tensor, want) -> bool:
    """Bitwise equal, NaN matched as NaN."""
    want = tensor_from_numpy(np.asarray(want))
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = ints[got.element_size()]
    eq = got.view(bits) == want.view(bits)
    if got.is_floating_point():
        eq |= torch.isnan(got) & torch.isnan(want)
    return bool(eq.all())


def _both(pair, fn):
    """fn(accl, is_ref) on the reference, then on the port."""
    ref, port = pair
    return fn(ref, True), fn(port, False)


def _filled(accl, n, value=-1.0):
    return accl.create_buffer(
        n, data=np.full((accl.world, n), value, np.float32))


def test_send_then_recv_every_row(pair):
    x = np.random.default_rng(101).standard_normal(
        (WORLD, 64)).astype(np.float32)

    def run(accl, ref):
        sb, rb = accl.create_buffer(64, data=x), _filled(accl, 64)
        accl.send(sb, 64, src=1, dst=6, tag=5)
        accl.recv(rb, 64, src=1, dst=6, tag=5)
        return rb.host

    want, got = _both(pair, run)
    assert same(got, want)
    assert same(got[6], x[1])
    assert same(got[:6], x[:6]) and same(got[7:], x[7:])


def test_recv_before_send_pairs(pair):
    x = np.random.default_rng(102).standard_normal(
        (WORLD, 48)).astype(np.float32)

    def run(accl, ref):
        sb, rb = accl.create_buffer(48, data=x), _filled(accl, 48)
        req = accl.recv(rb, 48, src=2, dst=5, tag=11, run_async=True)
        assert not req.test()  # parked, not failed
        accl.send(sb, 48, src=2, dst=5, tag=11)
        accl.wait(req)
        return rb.host

    want, got = _both(pair, run)
    assert same(got, want) and same(got[5], x[2])


@pytest.mark.parametrize("recv_first", [True, False])
def test_same_signature_pairs_fifo(pair, recv_first):
    """Two recvs (or two sends) parked under one (src, dst, tag) pair
    with the other side's two later arrivals in order."""
    rng = np.random.default_rng(103 + recv_first)
    xs = [rng.standard_normal((WORLD, 20)).astype(np.float32)
          for _ in range(2)]

    def run(accl, ref):
        sbs = [accl.create_buffer(20, data=x) for x in xs]
        rbs = [_filled(accl, 20) for _ in xs]
        if recv_first:
            reqs = [accl.recv(rb, 20, src=0, dst=1, tag=42, run_async=True)
                    for rb in rbs]
            for sb in sbs:
                accl.send(sb, 20, src=0, dst=1, tag=42)
            for r in reqs:
                accl.wait(r)
        else:
            for sb in sbs:
                accl.send(sb, 20, src=0, dst=1, tag=42)
            for rb in rbs:
                accl.recv(rb, 20, src=0, dst=1, tag=42)
        return [rb.host for rb in rbs]

    want, got = _both(pair, run)
    for g, w, x in zip(got, want, xs):
        assert same(g, w) and same(g[1], x[0])


def test_tag_any_drains_sends_in_arrival_order(pair):
    """Three sends on one channel under tags 2, 1, 2; TAG_ANY recvs take
    them in arrival order, across tag keys."""

    def run(accl, ref):
        for i, tag in enumerate((2, 1, 2)):
            sb = accl.create_buffer(
                8, data=np.full((WORLD, 8), float(i), np.float32))
            accl.send(sb, 8, src=0, dst=3, tag=tag)
        outs = []
        for _ in range(3):
            rb = _filled(accl, 8)
            accl.recv(rb, 8, src=0, dst=3)  # TAG_ANY
            outs.append(rb.host)
        return outs

    want, got = _both(pair, run)
    for i, (g, w) in enumerate(zip(got, want)):
        assert same(g, w) and bool((g[3] == float(i)).all())


def test_distinct_tags_received_in_reverse_order(pair):
    rng = np.random.default_rng(105)
    xs = [rng.standard_normal((WORLD, 33)).astype(np.float32)
          for _ in range(3)]

    def run(accl, ref):
        for k, x in enumerate(xs):
            accl.send(accl.create_buffer(33, data=x), 33, src=4, dst=2,
                      tag=700 + k)
        outs = {}
        for k in reversed(range(3)):
            rb = _filled(accl, 33)
            accl.recv(rb, 33, src=4, dst=2, tag=700 + k)
            outs[k] = rb.host
        return outs

    want, got = _both(pair, run)
    for k, x in enumerate(xs):
        assert same(got[k], want[k]) and same(got[k][2], x[4])


def test_exact_tag_filters_and_recv_times_out(pair):
    """A recv with a non-matching tag waits the configured timeout, then
    fails with RECEIVE_TIMEOUT; a TAG_ANY recv then drains the send."""
    x = np.random.default_rng(106).standard_normal(
        (WORLD, 32)).astype(np.float32)

    def run(accl, ref):
        accl.set_timeout(SHORT_TIMEOUT_US)
        try:
            sb, rb = accl.create_buffer(32, data=x), _filled(accl, 32)
            accl.send(sb, 32, src=0, dst=4, tag=123)
            t0 = time.monotonic()
            with pytest.raises(Exception, match="RECEIVE_TIMEOUT"):
                accl.recv(rb, 32, src=0, dst=4, tag=999)
            assert time.monotonic() - t0 >= 0.8 * SHORT_TIMEOUT_US / 1e6
            accl.recv(rb, 32, src=0, dst=4)
            return rb.host
        finally:
            accl.set_timeout(1_000_000)

    want, got = _both(pair, run)
    assert same(got, want) and same(got[4], x[0])


def test_parked_send_cap(pair):
    """Beyond MAX_PARKED_SENDS parked sends a send fails with the
    spare-buffer status error instead of growing the backlog; soft_reset
    drains the backlog."""
    _, port = pair
    port.cclo.MAX_PARKED_SENDS = 3
    try:
        sb = port.create_buffer(4)
        for tag in range(3):
            port.send(sb, 4, src=1, dst=2, tag=tag)
        with pytest.raises(ACCLError, match="SPARE_BUFFER_STATUS") as e:
            port.send(sb, 4, src=1, dst=2, tag=3)
        assert e.value.retcode == int(
            ErrorCode.DEQUEUE_BUFFER_SPARE_BUFFER_STATUS_ERROR)
        assert "parked sends 3/3" in port.dump_eager_rx_buffers()
    finally:
        port.soft_reset()
        del port.cclo.MAX_PARKED_SENDS
    assert "parked sends 0/512" in port.dump_eager_rx_buffers()


def test_dump_eager_rx_buffers_and_soft_reset(pair):
    """An unmatched send parks and shows in the rx dump; soft_reset drains
    it (and times out a parked recv) without deconfiguring the device,
    which stays usable."""
    x = np.random.default_rng(107).standard_normal(
        (WORLD, 16)).astype(np.float32)

    def run(accl, ref):
        sb = accl.create_buffer(16, data=x)
        accl.send(sb, 16, src=3, dst=4, tag=321)
        dump = accl.dump_eager_rx_buffers()
        assert "parked send:" in dump and "tag 321" in dump
        accl.soft_reset()
        assert "parked send:" not in accl.dump_eager_rx_buffers()
        assert accl.cclo.read(0x1FF4) == 1  # CFGRDY
        rb = _filled(accl, 16)
        accl.send(sb, 16, src=3, dst=4, tag=322)
        accl.recv(rb, 16, src=3, dst=4, tag=322)
        return rb.host

    want, got = _both(pair, run)
    assert same(got, want) and same(got[4], x[3])
    _, port = pair
    parked = port.recv(port.create_buffer(16), 16, src=5, dst=6, tag=9,
                       run_async=True)
    assert "parked recv: comm 0x200 src 5 dst 6 tag 9" in \
        port.dump_eager_rx_buffers()
    port.soft_reset()
    with pytest.raises(ACCLError, match="RECEIVE_TIMEOUT"):
        port.wait(parked)


def test_async_sendrecv_stress():
    """Many recv-before-send and send-before-recv pairs with per-pair
    tags, from a receiving and a sending thread at once, with a short
    switch interval; every payload lands in its buffer's dst row."""
    import sys

    port = ACCL(world=4, torch_device="cpu")
    n, iters = 16, 60
    x = np.random.default_rng(108).standard_normal((4, n)).astype(np.float32)
    sb = port.create_buffer(n, data=x)
    bufs = [port.create_buffer(n) for _ in range(iters)]
    reqs = [None] * iters
    errs = []

    def receiver():
        try:
            for t in range(iters):
                reqs[t] = port.recv(bufs[t], n, src=1, dst=2, tag=1000 + t,
                                    run_async=True)
        except Exception as e:  # reported by the assertion below
            errs.append(e)

    def sender():
        try:
            for t in range(iters):
                port.send(sb, n, src=1, dst=2, tag=1000 + t)
        except Exception as e:  # reported by the assertion below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=receiver),
                   threading.Thread(target=sender)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads), "worker thread hung"
    assert not errs, errs
    for t in range(iters):
        port.wait(reqs[t])
        assert same(bufs[t].host[2], x[1]), f"iteration {t}"
    assert "parked recv" not in port.dump_eager_rx_buffers()
    assert "parked sends 0/512" in port.dump_eager_rx_buffers()


def _reference_module(name: str):
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


P2P_FAMILIES = _reference_module("test_cross_executor_fuzz")._sample_p2p()


@pytest.mark.parametrize("cfg", P2P_FAMILIES, ids=lambda c: f"p2p{c[0]}w{c[1]}")
def test_p2p_fuzz_families(cfg):
    """The reference fuzz's traffic patterns (per (src, dst) channel, a
    group of messages all TAG_ANY in FIFO order or each with its own tag
    received in a shuffled order), every send issued async first, then
    the recvs in the family's order, through both facades; every row of
    every result bitwise."""
    i, world, groups, max_eager, _transport = cfg
    rng = np.random.default_rng(4321 + 100 + i)
    payloads = {}
    for g, (_, _, _, counts, _) in enumerate(groups):
        for k, cnt in enumerate(counts):
            payloads[g, k] = np.tile(
                rng.standard_normal(cnt).astype(np.float32), (world, 1))
            payloads[g, k][0] += 1.0  # rows differ, so a wrong row shows
    kw = dict(max_eager_size=max_eager, egr_rx_buf_size=max(max_eager, 1024))

    def run(accl, tag_any):
        reqs, outs = [], {}
        for g, (src, dst, mode, counts, _) in enumerate(groups):
            for k, cnt in enumerate(counts):
                sb = accl.create_buffer(cnt, data=payloads[g, k])
                tag = (g << 8) | k if mode == "distinct" else tag_any
                reqs.append(accl.send(sb, cnt, src, dst, tag=tag,
                                      run_async=True))
        for g, (src, dst, mode, counts, order) in enumerate(groups):
            for k in order:
                ob = _filled(accl, counts[k])
                tag = (g << 8) | k if mode == "distinct" else tag_any
                accl.recv(ob, counts[k], src, dst, tag=tag)
                outs[g, k] = ob.host
        for r in reqs:
            accl.wait(r)
        return outs

    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    want = run(RefACCL(mesh, **kw), REF_TAG_ANY)
    got = run(ACCL(world=world, torch_device="cpu", **kw), TAG_ANY)
    for (g, k), out in got.items():
        src, dst = groups[g][:2]
        assert same(out, want[g, k]), (g, k)
        assert same(out[dst], payloads[g, k][src]), (g, k)


def _ref_wire(row: np.ndarray, wire: str) -> np.ndarray:
    """What the named wire makes of one fp32 row, by the JAX package's
    own functions (jitted, as its facade runs them)."""
    if wire == "bfloat16":
        return row.astype(ml_dtypes.bfloat16).astype(np.float32)
    if wire == "float16":
        return row.astype(np.float16).astype(np.float32)
    n = row.shape[-1]
    codec = jax.jit(lambda v: dequantize_blockwise(
        *quantize_blockwise(v), n, jnp.float32))
    return np.asarray(codec(jnp.asarray(row[None])))[0]


@pytest.mark.parametrize("wire,n", [("float16", 300), ("bfloat16", 300),
                                    ("int8", 300), ("int8", 1024)])
def test_send_recv_on_compressed_wires(pair, wire, n):
    """Row dst is row src through the named wire (one quantization pass
    on int8, a round trip through the half type on fp16/bf16); every
    other row is bitwise the JAX facade's, which keeps them too. On the
    fp16 wire the whole result is the JAX facade's."""
    x = np.random.default_rng(109).standard_normal(
        (WORLD, n)).astype(np.float32) * 5
    x[1, :3] = (1e-39, -0.0, 7e4)  # a subnormal, a signed zero, past fp16

    def run(accl, ref):
        cd = (RefDT if ref else DataType)[wire]
        sb, rb = accl.create_buffer(n, data=x), _filled(accl, n)
        accl.send(sb, n, src=1, dst=3, tag=8, compress_dtype=cd)
        accl.recv(rb, n, src=1, dst=3, tag=8, compress_dtype=cd)
        return rb.host

    want, got = _both(pair, run)
    want = np.array(want)
    if wire != "float16":
        want[3] = _ref_wire(x[1], wire)
    assert same(got, want)


def test_stream_put_vadd_flow(pair):
    """The producer computes a+b on the card, rank 2's result travels to
    rank 5, whose consumer doubles it; every row of the result buffer is
    the JAX facade's (dst's from src, the others their own)."""
    n = 96
    rng = np.random.default_rng(110)
    a = rng.standard_normal((WORLD, n)).astype(np.float32)
    b = rng.standard_normal((WORLD, n)).astype(np.float32)

    def run(accl, ref):
        ba, bb = accl.create_buffer(n, data=a), accl.create_buffer(n, data=b)
        out = _filled(accl, n)
        if ref:
            def producer():
                me = lax.axis_index("ccl")
                return (lax.dynamic_index_in_dim(ba.device, me, 0, False)
                        + lax.dynamic_index_in_dim(bb.device, me, 0, False))
        else:
            def producer(ranks):
                return ba.device + bb.device
        accl.register_stream_producer(9, producer)
        accl.register_stream_consumer(9, lambda v: v * 2.0)
        accl.stream_put(n, stream_id=9, src=2, dst=5, recvbuf=out)
        return out.host

    want, got = _both(pair, run)
    assert same(got, want)
    assert same(got[5], (a[2] + b[2]) * 2.0)


def test_stream_put_unregistered_producer_raises(pair):
    _, port = pair
    with pytest.raises(KeyError, match="no producer registered on stream 77"):
        port.stream_put(8, stream_id=77, src=0, dst=1,
                        recvbuf=port.create_buffer(8))


def test_streamed_send_recv_pair(pair):
    """The dataType-only stream send (its payload from a producer) pairs
    with a recv whose result passes a consumer: one sendrecv with the
    send's OP0 and the recv's RES endpoints. The scale is exact (a power
    of two), so XLA's contraction of the multiply into the consumer's
    subtract cannot change the reference's bits."""
    n = 48
    base = np.random.default_rng(111).standard_normal(
        (WORLD, n)).astype(np.float32)

    def run(accl, ref):
        feed, out = accl.create_buffer(n, data=base), _filled(accl, n)
        if ref:
            def producer():
                me = lax.axis_index("ccl")
                return lax.dynamic_index_in_dim(feed.device, me, 0,
                                                False) * 4.0
        else:
            def producer(ranks):
                return feed.device * 4.0
        accl.register_stream_producer(41, producer)
        accl.register_stream_consumer(42, lambda v: v - 1.0)
        dt = (RefDT if ref else DataType).float32
        s = accl.send(dt, n, 2, 6, tag=7, run_async=True, op0_stream=41)
        accl.recv(out, n, 2, 6, tag=7, res_stream=42)
        accl.wait(s)
        return out.host

    want, got = _both(pair, run)
    assert same(got, want)
    assert same(got[6], base[2] * 4.0 - 1.0)


def test_datatype_only_forms_need_a_stream(pair):
    _, port = pair
    with pytest.raises(ValueError):
        port.send(DataType.float32, 8, 0, 1)
    with pytest.raises(ValueError):
        port.recv(DataType.float32, 8, 0, 1)
