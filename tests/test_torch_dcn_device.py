"""The port's DCNDevice against the JAX package's.

The reference's in-process tests (tests/test_dcn_device.py) run here on
the port's in-process form, DCNDevice(mesh=make_mesh({"dcn": 2, "ici":
4}, device="cpu")), each held bitwise against the reference's
DCNDevice(mesh=(2, 4)) facade on the same rows; the multi-process form
runs as one thread a host over a LoopbackHub (every two-tier op on three
wires, bitwise with the in-process form; at one rank a host every call
flat across processes, against the reference's DCNDevice over a (P, 1)
mesh; call sequences, streamed operands and stream_put at 2 x 4) and as
real OS processes over gloo (accl_tpu_torch.tools.run_dcn --device cpu,
2 x 4 with its sequence stage, 3 x 2 with a cross-host sub-communicator,
and 2 x 1), whose outer byte tally must equal the reference's
CountingWire count of its allreduce and whose flat tally the flat ring's
count.
"""

import os
import pathlib
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as RefP

import accl_tpu.constants as ref_c
from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.device.dcn_device import DCNDevice as RefDCN
from accl_tpu.sequencer import hierarchical as ref_hier
from accl_tpu.sequencer import schedules as ref_sched
from accl_tpu_torch import ACCL, DataType, ReduceFunction
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from accl_tpu_torch.constants import Operation
from accl_tpu_torch.device.dcn_device import DCNCompiler, DCNDevice
from accl_tpu_torch.device.dcn_transport import LoopbackHub
from accl_tpu_torch.device.gpu_device import GPUDevice
from accl_tpu_torch.parallel import make_mesh
from accl_tpu_torch.tools.run_dcn import (
    flat_allreduce_bytes,
    outer_allreduce_bytes,
)

RNG = np.random.default_rng(23)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _bits(t):
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def same(ref_buf, port_buf, rows=slice(None)):
    return np.array_equal(_bits(np.asarray(ref_buf.host)[rows]),
                          _bits(port_buf.host.numpy()[rows]))


@pytest.fixture(scope="module")
def facades():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ici"))
    ref = RefACCL(device=RefDCN(mesh=mesh))
    port = ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": 2, "ici": 4}, world=8, device="cpu")))
    return ref, port


def both(facades, call, *shapes):
    """`call(facade, *buffers)` on both facades over buffers made from
    (count, data) pairs; returns the (reference, port) buffer lists."""
    out = []
    for f in facades:
        bufs = [f.create_buffer(c, data=d) for c, d in shapes]
        call(f, *bufs)
        out.append(bufs)
    return out


def test_dcn_hierarchical_allreduce_bcast(facades):
    x = RNG.standard_normal((8, 120)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.allreduce(
        s, d, 120, ReduceFunction.SUM), (120, x), (120, None))
    assert same(r, p)
    np.testing.assert_allclose(p.host.numpy(), np.tile(x.sum(0), (8, 1)),
                               rtol=1e-4, atol=1e-4)
    (r,), (p,) = both(facades, lambda f, b: f.bcast(b, 120, 6), (120, x))
    assert same(r, p)
    np.testing.assert_array_equal(p.host.numpy(), np.tile(x[6], (8, 1)))
    # the int8 wire through both facades
    (_, r), (_, p) = both(facades, lambda f, s, d: f.allreduce(
        s, d, 120, ReduceFunction.SUM, compress_dtype=DataType.int8),
        (120, x), (120, None))
    assert same(r, p)


def test_dcn_allgather_reduce_scatter_order(facades):
    """Chunk order follows process-major global ranks despite the
    compositions' inner-major internals."""
    x = RNG.standard_normal((8, 16)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.allgather(s, d, 16),
                          (16, x), (16 * 8, None))
    assert same(r, p)
    np.testing.assert_array_equal(p.host.numpy(),
                                  np.tile(x.reshape(-1), (8, 1)))
    xs = RNG.standard_normal((8, 8 * 24)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.reduce_scatter(
        s, d, 24, ReduceFunction.SUM), (8 * 24, xs), (24, None))
    assert same(r, p)
    full = xs.sum(0)
    for g in range(8):
        np.testing.assert_allclose(p.host.numpy()[g],
                                   full[g * 24:(g + 1) * 24],
                                   rtol=1e-4, atol=1e-4)


def test_dcn_hierarchical_alltoall(facades):
    x = RNG.standard_normal((8, 32)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.alltoall(s, d, 4),
                          (32, x), (32, None))
    assert same(r, p)
    exp = x.reshape(8, 8, 4).transpose(1, 0, 2).reshape(8, 32)
    np.testing.assert_array_equal(p.host.numpy(), exp)


def test_dcn_flat_fallback_and_p2p(facades):
    """gather (two-tier), a cross-host send/recv (flat) and a barrier."""
    x = RNG.standard_normal((8, 32)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.gather(s, d, 32, 3),
                          (32, x), (32 * 8, None))
    assert same(r, p, rows=[3])
    np.testing.assert_array_equal(p.host.numpy()[3], x.reshape(-1))

    def p2p(f, s, d):
        f.send(s, 32, src=2, dst=7, tag=4)
        f.recv(d, 32, src=2, dst=7, tag=4)

    (_, r), (_, p) = both(facades, p2p, (32, x), (32, None))
    assert same(r, p)
    np.testing.assert_array_equal(p.host.numpy()[7], x[2])
    for f in facades:
        f.barrier()


def test_dcn_sub_communicators_and_selection(facades):
    """A host-0 group runs the flat inner-only path over a (1, 4)
    sub-world; misaligned groups are refused at split() time."""
    x = RNG.standard_normal((8, 24)).astype(np.float32)
    (_, r), (_, p) = both(facades, lambda f, s, d: f.allreduce(
        s, d, 24, ReduceFunction.SUM, comm=f.split([0, 1, 2, 3])),
        (24, x), (24, None))
    assert same(r, p)
    np.testing.assert_allclose(p.host.numpy()[:4],
                               np.tile(x[:4].sum(0), (4, 1)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(p.host.numpy()[4:], 0.0)

    port = facades[1]
    host0 = port.split([0, 1, 2, 3])
    ctx = port.cclo._comm_ctx(host0.exchmem_addr)
    assert isinstance(ctx.compiler, DCNCompiler)
    assert ctx.compiler.mesh.shape == {"dcn": 1, "ici": 4}
    n_comms = len(port.communicators)
    with pytest.raises(NotImplementedError, match="whole-host"):
        port.split([0, 1])
    assert len(port.communicators) == n_comms
    for op in (Operation.allreduce, Operation.alltoall, Operation.gather,
               Operation.scatter, Operation.reduce, Operation.barrier,
               Operation.bcast, Operation.allgather,
               Operation.reduce_scatter):
        assert op in DCNCompiler.HIER_OPS
    assert Operation.send not in DCNCompiler.HIER_OPS
    assert {o.name for o in DCNCompiler.HIER_OPS} == \
        {o.name for o in facades[0].cclo.compiler.HIER_OPS}


def test_dcn_single_tier_degenerates_flat():
    """outer = 1: the flat inner path."""
    x = RNG.standard_normal((4, 40)).astype(np.float32)
    ref = RefACCL(device=RefDCN(mesh=Mesh(
        np.array(jax.devices()[:4]).reshape(1, 4), ("dcn", "ici"))))
    port = ACCL(device=DCNDevice(mesh=make_mesh({"dcn": 1, "ici": 4},
                                                device="cpu")))
    (_, r), (_, p) = both((ref, port), lambda f, s, d: f.allreduce(
        s, d, 40, ReduceFunction.SUM), (40, x), (40, None))
    assert same(r, p)
    np.testing.assert_allclose(p.host.numpy(), np.tile(x.sum(0), (4, 1)),
                               rtol=1e-5, atol=1e-5)


def test_dcn_recorded_batch_is_the_flat_devices(facades):
    """A recorded batch lowers each step to its flat body over the
    combined world, as the reference's does (its compile_sequence takes
    _body, not DCNCompiler._build): bitwise the flat device's call and
    the reference's batch, not the eager two-tier allreduce."""
    n = 1000
    x = RNG.standard_normal((8, n)).astype(np.float32)
    outs = []
    for f in facades:
        s, d = f.create_buffer(n, data=x), f.create_buffer(n)
        seq = f.sequence()
        seq.allreduce(s, d, n, ReduceFunction.SUM)
        seq.compile().run()
        outs.append(d)
    assert same(*outs)
    flat = ACCL(device=GPUDevice(8, "cpu"))
    s, d = flat.create_buffer(n, data=x), flat.create_buffer(n)
    flat.allreduce(s, d, n, ReduceFunction.SUM)
    assert torch.equal(outs[1].host, d.host)
    port = facades[1]
    s, e = port.create_buffer(n, data=x), port.create_buffer(n)
    port.allreduce(s, e, n, ReduceFunction.SUM)
    assert not torch.equal(outs[1].host, e.host)
    np.testing.assert_allclose(e.host.numpy(), outs[1].host.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_dcn_alltoallv_and_live_subset_refused(facades):
    ref, port = facades
    for f in facades:
        s, d = f.create_buffer(32), f.create_buffer(32)
        with pytest.raises(NotImplementedError):
            f.alltoallv(s, d, 4, [4, 3, 2, 1, 4, 3, 2, 1])
    s, d = port.create_buffer(32), port.create_buffer(32)
    with pytest.raises(NotImplementedError):
        port.allreduce(s, d, 32, ReduceFunction.SUM, mode="live_subset",
                       live_ranks=(0, 2))


def test_dcn_device_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DCNDevice(local_device_count=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        DCNDevice(num_processes=2, local_device_count=4,
                  coordinator_address="127.0.0.1:1")
    # one rank a host: every call runs flat across processes, and the
    # device is built on the CPU when asked
    dev = DCNDevice(local_device_count=1, torch_device="cpu",
                    transport=LoopbackHub(2).transport(1))
    assert dev.local_rows() == [1] and dev.world == 2
    assert dev.mesh.shape == {"dcn": 2, "ici": 1}
    assert dev.compiler.flat_world().first == 1


# -- the multi-process form, one thread a host ------------------------------

FP32_ARITH = dict(DEFAULT_ARITH_CONFIG)
FP32_ARITH[(DataType.float32, DataType.float16)] = ArithConfig(
    4, 2, 0, 0, 1, False, (0, 5))


def _roots(W):
    """The roots and ends _drive's calls take at world W (at 2 x 4: bcast
    and reduce to 6, scatter from 3, gather to 5, p2p 1 -> 7)."""
    return {"bcast": W - 2, "reduce": W - 2, "scatter": 3 % W,
            "gather": (W - 3) % W, "src": 1 % W, "dst": W - 1}


def _drive(a, wire):
    """Every two-tier op, p2p and the host-0 group on one facade; returns
    each result's host image."""
    a.cclo.compiler.arith_table = FP32_ARITH
    kw = {} if wire is None else dict(compress_dtype=wire)
    W, n = a.world, 1000
    L, at = a.cclo.mesh.shape["ici"], _roots(a.world)
    c = n // W
    x = np.random.default_rng(5).standard_normal((W, n)).astype(np.float32)
    sb = a.create_buffer(n, data=x)
    out = {}

    def call(name, count, fn):
        buf = a.create_buffer(count)
        fn(buf)
        out[name] = buf.host

    call("allreduce", n, lambda r: a.allreduce(sb, r, n, ReduceFunction.SUM,
                                               **kw))
    call("allreduce_max", n, lambda r: a.allreduce(
        sb, r, n, ReduceFunction.MAX, **kw))
    bb = a.create_buffer(n, data=x)
    a.bcast(bb, n, at["bcast"], **kw)
    out["bcast"] = bb.host
    call("allgather", c * W, lambda r: a.allgather(sb, r, c, **kw))
    call("reduce_scatter", c, lambda r: a.reduce_scatter(
        sb, r, c, ReduceFunction.SUM, **kw))
    call("alltoall", c * W, lambda r: a.alltoall(
        a.create_buffer(c * W, data=x[:, :c * W]), r, c, **kw))
    call("scatter", c, lambda r: a.scatter(sb, r, c, at["scatter"], **kw))
    call("gather", c * W, lambda r: a.gather(sb, r, c, at["gather"], **kw))
    call("reduce", n, lambda r: a.reduce(sb, r, n, at["reduce"],
                                         ReduceFunction.SUM, **kw))

    def p2p(r):
        a.send(sb, 16, src=at["src"], dst=at["dst"], tag=5, **kw)
        a.recv(r, 16, src=at["src"], dst=at["dst"], tag=5, **kw)

    call("p2p", 16, p2p)
    call("host0", 24, lambda r: a.allreduce(
        sb, r, 24, ReduceFunction.SUM, comm=a.split(list(range(L))), **kw))
    a.barrier()
    return out


def multi_process_form(P, L, wire, hub):
    """_drive and a recorded batch on P hosts of L ranks, one thread a
    host over `hub` (LoopbackHub or IpcHub), against the in-process
    device: every host's rows of every result bitwise the in-process
    device's, rows it does not own left as they were. Returns each host's
    transport tally after its last call."""
    twin = ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": L}, device="cpu")), arith_config=FP32_ARITH)
    want = _drive(twin, wire)
    xs = np.random.default_rng(6).standard_normal((P * L, 8)).astype(
        np.float32)

    def batch(a):
        s, d = a.create_buffer(8, data=xs), a.create_buffer(8)
        seq = a.sequence()
        seq.allreduce(s, d, 8, ReduceFunction.SUM, compress_dtype=wire)
        seq.compile().run()
        return d.host

    want["sequence"] = batch(twin)
    results, errors = [None] * P, []

    def host(p):
        try:
            transport = hub.transport(p)
            try:
                dev = DCNDevice(local_device_count=L, transport=transport,
                                torch_device="cpu")
                a = ACCL(device=dev, arith_config=FP32_ARITH)
                results[p] = (dev.local_rows(), _drive(a, wire))
                results[p][1]["sequence"] = batch(a)
                results[p] += (transport.tally(),)
            finally:
                transport.close()
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    at = _roots(P * L)
    for p, (rows, got, _) in enumerate(results):
        others = [r for r in range(P * L) if r not in rows]
        for name, t in got.items():
            defined = [r for r in rows if name not in ("gather", "reduce")
                       or r == at[name]]
            assert np.array_equal(_bits(t.numpy()[defined]),
                                  _bits(want[name].numpy()[defined])), \
                (p, name)
            if name != "bcast":  # results land in this host's rows only
                assert not t.numpy()[others].any(), (p, name)
    return [tally for _, _, tally in results]


@pytest.mark.parametrize("wire", [None, DataType.float16, DataType.int8],
                         ids=["exact", "float16", "int8"])
def test_multi_process_form_is_the_in_process_form(wire):
    """Two hosts of four ranks, one thread each over a LoopbackHub: every
    host's rows of every result bitwise the in-process device's; rows it
    does not own stay as they were; a recorded batch runs and is bitwise
    the in-process device's batch."""
    multi_process_form(2, 4, wire, LoopbackHub(2))


@pytest.mark.parametrize("wires,n,stripes",
                         [(("none", "none"), 1 << 20, 2),
                          (("none", "int8"), 1 << 17, 1)],
                         ids=["exact", "int8_outer"])
def test_striped_two_tier_plan_across_processes(wires, n, stripes):
    """The register-opened HIER_RS_AR_AG allreduce: on the multi-process
    form each stripe's inner steps run on the host's rows and its outer
    allreduce on the cross-process tier; bitwise the in-process form's,
    the same plan on both."""
    from accl_tpu_torch.constants import TuningParams
    from accl_tpu_torch.sequencer.plan import Algorithm

    P, L = 2, 4
    x = np.random.default_rng(9).standard_normal((P * L, n)).astype(
        np.float32)

    def drive(a):
        a.configure_tuning_parameters(TuningParams(
            hier_allreduce_min_count=1 << 16))
        a.cclo.hier_wires = tuple(DataType[w] for w in wires)
        s, d = a.create_buffer(n, data=x), a.create_buffer(n)
        req = a.allreduce(s, d, n, ReduceFunction.SUM)
        assert req.plan.algorithm == Algorithm.HIER_RS_AR_AG
        assert req.plan.stripes == stripes  # the cost model's choice
        return d.host, req.plan

    want, plan = drive(ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": L}, device="cpu"))))
    hub = LoopbackHub(P)
    results, errors = [None] * P, []

    def host(p):
        try:
            dev = DCNDevice(local_device_count=L, transport=hub.transport(p),
                            torch_device="cpu")
            results[p] = (dev.local_rows(), *drive(ACCL(device=dev)))
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for rows, got, got_plan in results:
        assert got_plan == plan
        assert np.array_equal(_bits(got.numpy()[rows]),
                              _bits(want.numpy()[rows]))


# -- the multi-process form, one OS process a host over gloo ----------------


def _reference_outer_bytes(P, L, count):
    """The reference's CountingWire count of outer-axis ppermute bytes in
    its two-tier allreduce of `count` elements a rank."""

    class CountingWire(ref_sched.Wire):
        def __init__(self):
            super().__init__(None)
            self.bytes_by_axis = {}

        def ppermute(self, x, axis, perm):
            self.bytes_by_axis[axis] = (self.bytes_by_axis.get(axis, 0)
                                        + int(x.size) * x.dtype.itemsize)
            return super().ppermute(x, axis, perm)

    w = CountingWire()
    mesh = Mesh(np.array(jax.devices()[:P * L]).reshape(P, L),
                ("outer", "inner"))

    def body(xl):
        return ref_hier.hierarchical_allreduce_schedule(
            xl.reshape(-1), func=ref_c.ReduceFunction.SUM,
            inner_axis="inner", outer_axis="outer", inner_world=L,
            outer_world=P, wire=w).reshape(1, -1)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(RefP(("outer", "inner")),),
                              out_specs=RefP(("outer", "inner")),
                              check_vma=False))
    jax.eval_shape(f, jax.ShapeDtypeStruct((P * L, count), np.float32))
    return w.bytes_by_axis["outer"]


def _run_dcn_procs(n_procs, tmp_path, extra_args=()):
    """Start n run_dcn processes on the CPU, wait (120 s each at most),
    kill any left on the way out; return (exit codes, outputs)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    procs, logs = [], []
    try:
        for pid in range(n_procs):
            log = open(tmp_path / f"p{pid}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "accl_tpu_torch.tools.run_dcn",
                 "--procs", str(n_procs), "--proc-id", str(pid),
                 "--port", str(port), "--device", "cpu", *extra_args],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=str(REPO)))
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=120))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    outs = [(tmp_path / f"p{i}.log").read_text() for i in range(n_procs)]
    return rcs, outs


def _json_line(out, key):
    import json

    return next(json.loads(line)[key] for line in out.splitlines()
                if line.startswith('{"' + key + '"'))


def _bytes_line(out):
    return _json_line(out, "dcn_bytes")


def test_dcn_two_process_end_to_end(tmp_path):
    """Two OS processes x 4 ranks over gloo: every stage's local rows
    bitwise the in-process device's (run_dcn checks), the int8 allreduce
    among them, and the sequence stage (recorded batches, a streamed
    allreduce, stream_put); the outer tier's bytes the reference's count,
    a recorded allreduce step's flat bytes the flat ring's."""
    rcs, outs = _run_dcn_procs(2, tmp_path, ("--sequence",))
    assert rcs == [0, 0], f"rc={rcs}\n--- p0:\n{outs[0]}\n--- p1:\n{outs[1]}"
    assert "RANKS [0, 1, 2, 3] proc 0/2 OK" in outs[0]
    assert "RANKS [4, 5, 6, 7] proc 1/2 OK" in outs[1]
    want = _reference_outer_bytes(2, 4, 96)
    assert want == outer_allreduce_bytes(96, 2, 4)
    for out in outs:
        line = _bytes_line(out)
        assert line["line_hop_bytes"] == want
        assert line["sent"] == 4 * want
        seq = _json_line(out, "dcn_sequence")
        # one 96-element segment: 2 * 7 hops of a 12-element chunk
        assert seq["flat_sent"] == flat_allreduce_bytes(96, 8, 96) == 672
        assert seq["flat_messages"] == 14


def test_dcn_two_process_one_rank_a_host(tmp_path):
    """Two OS processes x 1 rank over gloo: every stage flat across
    processes on the exact, fp16 and int8 wires and the sequence stage,
    each process's row bitwise the in-process device's; the flat ring's
    bytes and its one message a ring step."""
    rcs, outs = _run_dcn_procs(2, tmp_path, (
        "--local-devices", "1", "--wires", "exact,float16,int8",
        "--sequence"))
    assert rcs == [0, 0], f"rc={rcs}\n--- p0:\n{outs[0]}\n--- p1:\n{outs[1]}"
    for i in range(2):
        assert f"RANKS [{i}] proc {i}/2 OK" in outs[i]
        line = _bytes_line(outs[i])
        assert line["sent"] == line["line_hop_bytes"] == 0
        assert line["flat_sent"] == flat_allreduce_bytes(96, 2, 96) == 384
        assert line["flat_messages"] == 2


def test_dcn_three_process_cross_host_subgroup(tmp_path):
    """Three processes x 2 ranks: a sub-communicator of the first two
    hosts runs the two-tier allreduce on its (2, 2) sub-world, the third
    host no-ops the same call and keeps its rows."""
    rcs, outs = _run_dcn_procs(
        3, tmp_path, ("--local-devices", "2", "--subset-hosts", "2"))
    assert rcs == [0, 0, 0], f"rc={rcs}\n" + "\n---\n".join(outs)
    for i, rows in enumerate(("[0, 1]", "[2, 3]", "[4, 5]")):
        assert f"RANKS {rows} proc {i}/3 OK" in outs[i]
    want = _reference_outer_bytes(3, 2, 96)
    for out in outs:
        assert _bytes_line(out)["line_hop_bytes"] == want


# -- one rank a host: every call flat across processes -----------------------


def _drive_flat(a, x):
    """Every collective, p2p and a group of hosts 0 and 2 (a 2-host group
    on 3 x 1) on a facade of one rank a host; returns (result, defined
    rows) by name."""
    W, n = a.world, x.shape[-1]
    c = n // W
    group = [0, 2] if W > 2 else [0, 1]
    out = {}

    def call(name, count, fn, rows=None):
        buf = a.create_buffer(count)
        fn(buf)
        out[name] = (np.asarray(buf.host), rows)

    sb = a.create_buffer(n, data=x)
    call("allreduce", n, lambda r: a.allreduce(sb, r, n, ReduceFunction.SUM))
    call("allreduce_max", n, lambda r: a.allreduce(
        sb, r, n, ReduceFunction.MAX))
    bb = a.create_buffer(n, data=x)
    a.bcast(bb, n, W - 1)
    out["bcast"] = (np.asarray(bb.host), None)
    call("allgather", c * W, lambda r: a.allgather(sb, r, c))
    call("reduce_scatter", c, lambda r: a.reduce_scatter(
        a.create_buffer(c * W, data=x[:, :c * W]), r, c,
        ReduceFunction.SUM))
    call("alltoall", c * W, lambda r: a.alltoall(
        a.create_buffer(c * W, data=x[:, :c * W]), r, c))
    call("scatter", c, lambda r: a.scatter(
        a.create_buffer(c * W, data=x[:, :c * W]), r, c, 1))
    call("gather", c * W, lambda r: a.gather(sb, r, c, W - 1), [W - 1])
    call("reduce", n, lambda r: a.reduce(sb, r, n, 0, ReduceFunction.SUM),
         [0])

    def p2p(r):
        a.send(sb, 16, src=0, dst=W - 1, tag=3)
        a.recv(r, 16, src=0, dst=W - 1, tag=3)

    call("p2p", 16, p2p, [W - 1])
    comm = a.split(group)
    call("group_allreduce", 24, lambda r: a.allreduce(
        sb, r, 24, ReduceFunction.SUM, comm=comm))
    gb = a.create_buffer(n, data=x)
    a.bcast(gb, n, 1, comm=comm)
    out["group_bcast"] = (np.asarray(gb.host), None)
    a.barrier()
    return out


@pytest.mark.parametrize("P", [2, 3, 4])
def test_one_rank_a_host_is_the_references(P):
    """The facade at local_device_count == 1 over LoopbackHub threads:
    every collective, p2p and a 2-host group lower flat across processes,
    each host's row bitwise the reference DCNDevice's over a (P, 1)
    mesh (a group's non-member host keeps its row)."""
    x = np.random.default_rng(40 + P).standard_normal((P, 120)).astype(
        np.float32)
    ref = RefACCL(device=RefDCN(mesh=Mesh(
        np.array(jax.devices()[:P]).reshape(P, 1), ("dcn", "ici"))))
    want = _drive_flat(ref, x)
    hub = LoopbackHub(P)
    results, errors = [None] * P, []

    def host(p):
        try:
            dev = DCNDevice(local_device_count=1, transport=hub.transport(p),
                            torch_device="cpu")
            results[p] = _drive_flat(ACCL(device=dev), x)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for p, got in enumerate(results):
        for name, (t, rows) in got.items():
            if rows is not None and p not in rows:
                continue
            assert np.array_equal(_bits(t[p]), _bits(want[name][0][p])), \
                (P, p, name)


def test_multi_process_sequences_and_streams():
    """On the 2 x 4 multi-process form: recorded batches (allreduce ->
    allgather -> bcast, exact and int8), a streamed operand eagerly and in
    a batch, and stream_put. Each host's rows bitwise the in-process
    form's; the batches bitwise the reference DCNDevice's."""
    P, L = 2, 4
    W, n = P * L, 600  # two whole 256-element segments and a ragged one
    c = n // W
    x = np.random.default_rng(77).standard_normal((W, n)).astype(np.float32)
    base = torch.from_numpy(x)

    def batches(a):
        out = {}
        for wire in (None, DataType.int8):
            s, d = a.create_buffer(n, data=x), a.create_buffer(n)
            g = a.create_buffer(c * W)
            seq = a.sequence()
            seq.allreduce(s, d, n, ReduceFunction.SUM, compress_dtype=wire)
            seq.allgather(d, g, c, compress_dtype=wire)
            seq.bcast(g, c * W, 5, compress_dtype=wire)
            seq.compile().run()
            out[f"allreduce_{wire}"] = np.asarray(d.host)
            out[f"allgather_bcast_{wire}"] = np.asarray(g.host)
        return out

    def streams(a):
        out = {}
        a.register_stream_producer(
            7, lambda ranks: base[ranks[:, 0]] * ranks.to(torch.float32))
        e = a.create_buffer(n)
        a.allreduce(a.create_buffer(n), e, n, ReduceFunction.SUM,
                    op0_stream=7)
        out["streamed_allreduce"] = e.host.numpy()
        b, h = a.create_buffer(n), a.create_buffer(n)
        with a.sequence() as seq:
            seq.bcast(b, n, 6, op0_stream=7)
            seq.allreduce(b, h, n, ReduceFunction.SUM)
        out["streamed_batch"] = h.host.numpy()
        put = a.create_buffer(n)
        a.stream_put(n, stream_id=7, src=2, dst=5, recvbuf=put)
        out["stream_put"] = put.host.numpy()
        return out

    twin = ACCL(device=DCNDevice(mesh=make_mesh({"dcn": P, "ici": L},
                                                device="cpu")))
    want = {**batches(twin), **streams(twin)}
    ref = RefACCL(device=RefDCN(mesh=Mesh(
        np.array(jax.devices()[:W]).reshape(P, L), ("dcn", "ici"))))
    ref_want = batches(ref)
    for name, t in ref_want.items():
        assert np.array_equal(_bits(t), _bits(want[name])), name
    hub = LoopbackHub(P)
    results, errors = [None] * P, []

    def host(p):
        try:
            a = ACCL(device=DCNDevice(local_device_count=L,
                                      transport=hub.transport(p),
                                      torch_device="cpu"))
            results[p] = {**batches(a), **streams(a)}
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert set(results[0]) == set(want)
    for p, got in enumerate(results):
        rows = slice(p * L, (p + 1) * L)
        for name, t in got.items():
            assert np.array_equal(_bits(t[rows]), _bits(want[name][rows])), \
                (p, name)
    made = x * np.arange(W, dtype=np.float32)[:, None]
    np.testing.assert_allclose(want["streamed_allreduce"][0], made.sum(0),
                               rtol=1e-4, atol=1e-3)
    assert np.array_equal(want["stream_put"][5], made[2])
    assert np.array_equal(want["stream_put"][4], made[4])


@pytest.mark.parametrize("P,L", [(4, 1), (4, 2)], ids=["4x1", "4x2"])
def test_autotuned_synthesized_plans_across_processes(P, L):
    """After ACCL.autotune() the synthesized windows are open: at one rank
    a host an eager allreduce and reduce_scatter select SYNTHESIZED plans
    and lower their hop-DAGs flat across processes; at 4 x 2 a recorded
    allreduce step does (the eager call keeps its composition). Each
    host's rows bitwise the in-process device's, the same plans."""
    from accl_tpu_torch.sequencer.plan import Algorithm

    W, n = P * L, 1024
    x = np.random.default_rng(P * 10 + L).standard_normal((W, n)).astype(
        np.float32)

    def drive(a):
        a.autotune()
        out, plans = {}, []
        if L == 1:
            s, d = a.create_buffer(n, data=x), a.create_buffer(n)
            plans.append(a.allreduce(s, d, n, ReduceFunction.SUM).plan)
            out["allreduce"] = d.host.numpy()
            r = a.create_buffer(n // W)
            plans.append(a.reduce_scatter(s, r, n // W,
                                          ReduceFunction.SUM).plan)
            out["reduce_scatter"] = r.host.numpy()
        s, d = a.create_buffer(n, data=x), a.create_buffer(n)
        seq = a.sequence()
        seq.allreduce(s, d, n, ReduceFunction.SUM)
        prog = seq.compile()
        plans += list(prog.plans)
        prog.run()
        out["sequence"] = d.host.numpy()
        return out, plans

    want, plans = drive(ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": L}, device="cpu"))))
    assert {p.algorithm for p in plans} == {Algorithm.SYNTHESIZED}, plans
    hub = LoopbackHub(P)
    results, errors = [None] * P, []

    def host(p):
        try:
            results[p] = drive(ACCL(device=DCNDevice(
                local_device_count=L, transport=hub.transport(p),
                torch_device="cpu")))
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for p, (got, got_plans) in enumerate(results):
        assert got_plans == plans
        rows = slice(p * L, (p + 1) * L)
        for name, t in got.items():
            assert np.array_equal(_bits(t[rows]), _bits(want[name][rows])), \
                (p, name)
    np.testing.assert_allclose(want["sequence"], np.tile(x.sum(0), (W, 1)),
                               rtol=1e-4, atol=1e-4)
