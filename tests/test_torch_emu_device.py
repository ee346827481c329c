"""The port's native-emulator binding (accl_tpu_torch/device/emu_device.py)
against the JAX package's.

Both packages drive the same C++ runtime (native/src): the port through
its own build in accl_tpu_torch/_build/, the reference through
native/libacclrt.so. The two libraries are loaded side by side, each with
its own globals (ctypes loads them RTLD_LOCAL), so every comparison runs
one port world and one reference world on the same rows, never ranks of
both in one world. Results are compared bitwise: CPU torch tensors on the
port's side, numpy arrays (ml_dtypes for bf16) on the reference's.

Covered: every per-rank collective wrapper once, eager and rendezvous,
the dtypes including bf16 and f16, async start/test/wait/duration_ns,
the counter surfaces, the trace ring and drain_world against the
reference's lift of the same raw spans, the rx-ring dump, kill and
flush_rx, write_communicator, the udp and tcp transports, the operand
checks (a CUDA, a non-contiguous or a non-tensor operand raises
TypeError), and the build: a digest-matched library is reused and a
missing compiler fails loudly. Every world's run is bounded
(EmuWorld.run(timeout_s=)) and every stalled call ends at the runtime's
receive timeout.
"""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from accl_tpu.device import emu_device as ref_emu
from accl_tpu.telemetry import native as ref_native
from accl_tpu_torch.communicator import Communicator, Rank
from accl_tpu_torch.constants import (
    ACCLError,
    CfgFunc,
    Operation,
    ReduceFunction,
)
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device import emu_device as emu
from accl_tpu_torch.telemetry import native

RUN_S = 60  # the bound on every world's run
BF16 = np.dtype(ml_dtypes.bfloat16)
BITS = {2: np.int16, 4: np.int32, 8: np.int64}


@pytest.fixture(scope="module")
def lib():
    return emu.load_native()


@pytest.fixture(scope="module")
def worlds(lib):
    """A port world and a reference world of 4 ranks, in-process."""
    port = emu.EmuWorld(4, transport="local")
    ref = ref_emu.EmuWorld(4, transport="local")
    yield port, ref
    port.close()
    ref.close()


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(getattr(torch, np.dtype(BITS[x.element_size()]).name))
        return x.numpy()
    return x.view(BITS[x.itemsize])


class _Side:
    """How one package makes its operands: `arr` turns a numpy array into
    an operand, `zeros` makes an empty result."""

    def __init__(self, port: bool):
        self.port = port

    def arr(self, a):
        return _tensor(a) if self.port else a.copy()

    def zeros(self, n, dtype):
        return self.arr(np.zeros(n, dtype))


def _ref_run(world, fn):
    """The reference world's run, bounded by RUN_S like the port's."""
    box = {}

    def go():
        try:
            box["ok"] = world.run(fn)
        except BaseException as e:  # re-raised below, in the test
            box["err"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(RUN_S)
    if t.is_alive():
        raise TimeoutError(f"reference world still running after {RUN_S} s")
    if "err" in box:
        raise box["err"]
    return box["ok"]


def _both(worlds, body):
    """Run body(rank, i, side) on the port world and on the reference
    world; returns (port results, reference results)."""
    port, ref = worlds
    got = port.run(lambda r, i: body(r, i, _Side(True)), timeout_s=RUN_S)
    want = _ref_run(ref, lambda r, i: body(r, i, _Side(False)))
    return got, want


def _same(got, want):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if got is None:
        assert want is None
        return
    assert np.array_equal(_bits(got), _bits(want))


def _rows(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-1000, 1000, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


DTYPES = [np.float32, np.float64, np.int32, np.int64, np.float16, BF16]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("count", [8, 5000])  # eager ring / rendezvous
def test_allreduce_bitwise_with_reference(worlds, dtype, count):
    xs = _rows(count, (4, count), dtype)

    def body(rank, i, s):
        out = s.zeros(count, dtype)
        rank.allreduce(s.arr(xs[i]), out, count, ReduceFunction.SUM)
        mx = s.zeros(count, dtype)
        rank.allreduce(s.arr(xs[i]), mx, count, ReduceFunction.MAX)
        return out, mx

    got, want = _both(worlds, body)
    _same(got, want)
    if np.dtype(dtype).kind == "f" and dtype != BF16:
        np.testing.assert_array_equal(got[0][1].numpy(), xs.max(0))


@pytest.mark.parametrize("op", ["bcast", "scatter", "gather", "allgather",
                                "reduce", "reduce_scatter", "alltoall",
                                "send_recv", "copy_combine", "barrier"])
@pytest.mark.parametrize("count", [32, 3000])
def test_every_wrapper_bitwise_with_reference(worlds, op, count):
    # integer-valued rows: a rendezvous reduce folds in arrival order,
    # which differs from run to run, and these sums are exact in any order
    xs = _rows(7 + count, (4, 4 * count), np.int32).astype(np.float32)
    f32 = np.float32

    def body(rank, i, s):
        if op == "bcast":
            buf = s.arr(xs[i, :count])
            rank.bcast(buf, count, root=2)
            return buf
        if op == "scatter":
            out = s.zeros(count, f32)
            rank.scatter(s.arr(xs[i]), out, count, root=1)
            return out
        if op == "gather":
            out = s.zeros(4 * count, f32)
            rank.gather(s.arr(xs[i, :count]), out, count, root=3)
            return out if i == 3 else None
        if op == "allgather":
            out = s.zeros(4 * count, f32)
            rank.allgather(s.arr(xs[i, :count]), out, count)
            return out
        if op == "reduce":
            out = s.zeros(count, f32)
            rank.reduce(s.arr(xs[i, :count]), out, count, root=0,
                        func=ReduceFunction.SUM)
            return out if i == 0 else None
        if op == "reduce_scatter":
            out = s.zeros(count, f32)
            rank.reduce_scatter(s.arr(xs[i]), out, count,
                                ReduceFunction.SUM)
            return out
        if op == "alltoall":
            out = s.zeros(4 * count, f32)
            rank.alltoall(s.arr(xs[i]), out, count)
            return out
        if op == "send_recv":
            # a ring of send/recv pairs, even ranks sending first
            out = s.zeros(count, f32)
            dst, src = (i + 1) % 4, (i - 1) % 4
            if i % 2 == 0:
                rank.send(s.arr(xs[i, :count]), count, dst, tag=5)
                rank.recv(out, count, src, tag=5)
            else:
                rank.recv(out, count, src, tag=5)
                rank.send(s.arr(xs[i, :count]), count, dst, tag=5)
            return out
        if op == "copy_combine":
            out = s.zeros(count, f32)
            rank.combine(count, ReduceFunction.MAX, s.arr(xs[i, :count]),
                         s.arr(xs[(i + 1) % 4, :count]), out)
            dst = s.zeros(count, f32)
            rank.copy(out, dst, count)
            return dst
        rank.barrier()
        return None

    got, want = _both(worlds, body)
    _same(got, want)
    if op == "allgather":
        np.testing.assert_array_equal(got[0].numpy(),
                                      xs[:, :count].reshape(-1))


def test_fp16_bf16_combine_and_async_duration(worlds):
    a = _rows(3, 64, np.float16)
    b = _rows(4, 64, BF16)

    def body(rank, i, s):
        h = s.zeros(64, np.float16)
        rank.combine(64, ReduceFunction.SUM, s.arr(a), s.arr(a[::-1]), h)
        bf = s.zeros(64, BF16)
        rank.combine(64, ReduceFunction.SUM, s.arr(b), s.arr(b[::-1]), bf)
        out = s.zeros(512, np.float32)
        x = s.arr(_rows(i, 512, np.float32))
        opts = rank._opts(Operation.allreduce, 512,
                          torch.float32 if s.port else np.float32,
                          func=ReduceFunction.SUM)
        handle = rank.start(opts, op0=x, res=out)
        rank.wait(handle, timeout_ms=RUN_S * 1000)
        assert rank.test(handle) is False or rank.test(handle) is True
        assert rank.duration_ns(handle) > 0
        return h, bf, out

    got, want = _both(worlds, body)
    _same(got, want)


def test_counters_trace_and_drain_world(lib, monkeypatch):
    """ACCL_RT_TRACE=1 worlds of both packages run the same calls: the
    counter surfaces have the reference's keys, every rank's ring holds one
    span a call, and drain_world gives one event a span a rank, equal to
    the reference's lift of the port's raw spans."""
    monkeypatch.setenv("ACCL_RT_TRACE", "1")
    port = emu.EmuWorld(2, transport="local")
    ref = ref_emu.EmuWorld(2, transport="local")
    try:
        xs = _rows(11, (2, 300), np.float32)

        def body(rank, i, s):
            for n in (300, 64):
                out = s.zeros(n, np.float32)
                rank.allreduce(s.arr(xs[i, :n]), out, n, ReduceFunction.SUM)
            buf = s.arr(xs[i, :100])
            rank.bcast(buf, 100, root=1)
            return rank.sequencer_stats(), rank.wire_stats()

        got = port.run(lambda r, i: body(r, i, _Side(True)), timeout_s=RUN_S)
        want = _ref_run(ref, lambda r, i: body(r, i, _Side(False)))
        for (seq, wire), (rseq, rwire) in zip(got, want):
            assert tuple(seq) == tuple(rseq)
            assert tuple(wire) == tuple(rwire) == emu.STATS2_FIELDS
            assert wire["tx_frames"] > 0 and seq["passes"] > 0
        raws = [r.trace_read()[0] for r in port.ranks]
        ref_raws = [r.trace_read()[0] for r in ref.ranks]
        for mine, theirs in zip(raws, ref_raws):
            key = [(s["opcode"], s["count"], s["bytes"], s["retcode"],
                    s["rank"]) for s in mine]
            assert key == [(s["opcode"], s["count"], s["bytes"],
                            s["retcode"], s["rank"]) for s in theirs]
            assert len(mine) == 3
        # drain_world: the ring is empty now, so run the calls once more
        port.run(lambda r, i: body(r, i, _Side(True)), timeout_s=RUN_S)
        events, dropped = native.drain_world(port, tier="outer")
        assert dropped == 0 and len(events) == 6
        assert sorted({e["track"] for e in events}) == ["emu/r0", "emu/r1"]
        for e in events:
            assert e["args"]["tier"] == "outer"
        assert all(not r.trace_read()[0] for r in port.ranks)
    finally:
        port.close()
        ref.close()


def test_drain_world_equals_the_reference_lift(lib, monkeypatch):
    """The reference's drain_world and the port's over one traced port
    world's raw spans (replayed to both): identical events but the
    anchored timestamps, which keep their spacing within a rank."""
    import types

    monkeypatch.setenv("ACCL_RT_TRACE", "1")
    w = emu.EmuWorld(3, transport="local")
    try:
        xs = _rows(12, (3, 2000), np.float32)

        def body(rank, i):
            for n in (2000, 16):
                out = torch.zeros(n)
                rank.allreduce(_tensor(xs[i, :n]), out, n,
                               ReduceFunction.SUM)
            out = torch.zeros(3 * 16)
            rank.allgather(_tensor(xs[i, :16]), out, 16)

        w.run(body, timeout_s=RUN_S)
        raws = [r.trace_read() for r in w.ranks]
    finally:
        w.close()
    replay = types.SimpleNamespace(ranks=[
        types.SimpleNamespace(trace_read=lambda r=r: r) for r in raws])
    got, dropped = native.drain_world(replay, track_prefix="t")
    want, want_dropped = ref_native.drain_world(replay, track_prefix="t")
    assert dropped == want_dropped == 0 and len(got) == len(want) == 9
    for g, x in zip(got, want):
        assert {k: v for k, v in g.items() if k != "ts_ns"} == \
            {k: v for k, v in x.items() if k != "ts_ns"}
    for r in range(3):
        ts = [e["ts_ns"] for e in got if e["track"] == f"t/r{r}"]
        tr = [e["ts_ns"] for e in want if e["track"] == f"t/r{r}"]
        assert np.array_equal(np.diff(ts), np.diff(tr))


def test_dump_rx_ring_and_recv_timeout(worlds):
    port, _ = worlds

    def body(rank, i):
        if i == 0:
            rank.send(torch.arange(64, dtype=torch.float32), 64, 1, tag=55)
        elif i == 1:
            import time

            for _ in range(200):
                if "VALID" in rank.dump_eager_rx_buffers():
                    break
                time.sleep(0.01)
            d = rank.dump_eager_rx_buffers()
            assert "eager rx ring" in d and "src 0 tag 55" in d, d
            out = torch.zeros(64)
            rank.recv(out, 64, 0, tag=55)
            assert "tag 55" not in rank.dump_eager_rx_buffers()
            return out
        elif i == 2:
            rank.call(CallOptions(scenario=Operation.config,
                                  function=int(CfgFunc.set_timeout),
                                  count=200))
            with pytest.raises(ACCLError, match="RECEIVE_TIMEOUT"):
                rank.recv(torch.zeros(16), 16, 3, tag=999)
            rank.call(CallOptions(scenario=Operation.config,
                                  function=int(CfgFunc.set_timeout),
                                  count=5000))
        return None

    res = port.run(body, timeout_s=RUN_S)
    assert torch.equal(res[1], torch.arange(64, dtype=torch.float32))


def test_kill_then_flush_rx_and_recover(lib):
    """A killed rank fails its peer's allreduce with a sticky
    RECEIVE_TIMEOUT; after flush_rx the survivor's local calls still run,
    and mmio reads and writes work."""
    w = emu.EmuWorld(2, transport="local")
    try:
        w.ranks[1].kill()

        def body(rank, i):
            if i == 0:  # the killed rank fails every call, this one too
                rank.call(CallOptions(scenario=Operation.config,
                                      function=int(CfgFunc.set_timeout),
                                      count=150))
            try:
                rank.allreduce(torch.ones(32), torch.zeros(32), 32,
                               ReduceFunction.SUM)
            except ACCLError as e:
                return e.retcode
            return 0

        codes = w.run(body, timeout_s=RUN_S)
        assert all(c & 0x800 for c in codes)
        r0 = w.ranks[0]
        r0.flush_rx(settle_s=0.01)
        out = torch.zeros(8)
        r0.copy(torch.arange(8, dtype=torch.float32), out, 8)
        assert torch.equal(out, torch.arange(8, dtype=torch.float32))
        r0.write(0x40, 0xDEAD)
        assert r0.read(0x40) == 0xDEAD
    finally:
        w.close()


def test_write_communicator_sub_groups(worlds):
    """Disjoint and non-contiguous sub-communicators addressed by
    comm_addr, against the reference."""
    from accl_tpu.communicator import Communicator as RefComm
    from accl_tpu.communicator import Rank as RefRank

    groups = ((0, 2), (1, 3))
    addrs = (0x400, 0x500)
    mine = [Communicator([Rank(device_index=g) for g in grp], 0, a)
            for grp, a in zip(groups, addrs)]
    theirs = [RefComm([RefRank(device_index=g) for g in grp], 0, a)
              for grp, a in zip(groups, addrs)]
    xs = _rows(21, (4, 96), np.float32)

    def body(rank, i, s):
        for c in (mine if s.port else theirs):
            rank.write_communicator(c)
        addr = addrs[i % 2]
        out = s.zeros(96, np.float32)
        rank.allreduce(s.arr(xs[i]), out, 96, ReduceFunction.SUM,
                       comm_addr=addr)
        buf = s.arr(xs[i, :40])
        rank.bcast(buf, 40, root=1, comm_addr=addr)
        return out, buf

    got, want = _both(worlds, body)
    _same(got, want)
    np.testing.assert_array_equal(got[0][0].numpy(), xs[[0, 2]].sum(0))


@pytest.mark.parametrize("transport", ["udp", "tcp"])
def test_socket_transports_bitwise_with_reference(lib, transport):
    """The sessionless datagram transport (eager) and the TCP session
    mesh (eager and rendezvous) against the reference's same worlds."""
    n = 512 if transport == "udp" else 20000
    xs = _rows(30, (3, n), np.float32)
    port = emu.EmuWorld(3, transport=transport)
    ref = ref_emu.EmuWorld(3, transport=transport)
    try:
        def body(rank, i, s):
            out = s.zeros(n, np.float32)
            rank.allreduce(s.arr(xs[i]), out, n, ReduceFunction.SUM)
            buf = s.arr(xs[i])
            rank.bcast(buf, n, root=2)
            a2a = s.zeros(3 * 32, np.float32)
            rank.alltoall(s.arr(xs[i, :96]), a2a, 32)
            rank.barrier()
            return out, buf, a2a

        got = port.run(lambda r, i: body(r, i, _Side(True)), timeout_s=RUN_S)
        want = _ref_run(ref, lambda r, i: body(r, i, _Side(False)))
    finally:
        port.close()
        ref.close()
    _same(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device (this machine has none)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("bad,what", [
    (torch.zeros(8).as_subclass(_OnCard), "on cuda:0"),
    (torch.zeros(8, 2)[:, 0], "not contiguous"),
    (np.zeros(8, np.float32), "torch tensors"),
])
def test_operands_must_be_contiguous_cpu_tensors(worlds, bad, what):
    rank = worlds[0].ranks[0]
    opts = rank._opts(Operation.copy, 8, torch.float32)
    with pytest.raises(TypeError, match=what) as e:
        rank.start(opts, op0=bad, res=torch.zeros(8))
    if what != "torch tensors":
        assert ".cpu().contiguous()" in str(e.value)
    with pytest.raises(TypeError):
        rank.start(opts, op0=torch.zeros(8), res=bad)
    assert not rank._keepalive  # nothing was started


def test_build_is_reused_by_digest_and_needs_a_compiler(lib, monkeypatch):
    path = emu.library_path()
    assert path.exists() and path.parent == emu.BUILD_DIR
    assert path.name.startswith("libacclrt-")
    assert emu.build_native() == path and emu.build_seconds == 0.0
    # the digest covers the compiler: another compiler, another library
    assert emu.library_path("/usr/bin/clang++") != path
    assert emu.load_native() is lib
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        emu.build_native()
