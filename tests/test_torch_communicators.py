"""The port's sub-communicators against the JAX facade's, bitwise.

A sub-communicator call gathers its member rows, runs the collective at
the group's world and writes the result back into the member rows only:
every member row is compared bitwise with the JAX facade's, and every
non-member row must be bitwise what it was before the call. Covered: the
`_sample()` configurations of tests/test_fuzz_communicators.py through
both facades; the split tests and get_comm_group of
tests/test_accl_facade.py; groups of 3, 4 and 5 on the ring kernel's
plain version and the closed-form int8 ring's (the card's routes); and a
call sequence on a sub-communicator (tests/test_sequence.py), fused ==
eager == the JAX facade's sequence.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.communicator import Communicator as RefCommunicator
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu_torch import ACCL, Communicator, DataType, ReduceFunction
from accl_tpu_torch.interop import tensor_from_numpy

WORLD = 8
SENTINEL = -3.0  # the value a result buffer holds before the call


@pytest.fixture(scope="module")
def pair(mesh8):
    return RefACCL(mesh8), ACCL(world=WORLD, torch_device="cpu")


def same(got: torch.Tensor, want) -> bool:
    """Bitwise equal."""
    want = tensor_from_numpy(np.asarray(want))
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(torch.int32), want.view(torch.int32)))


def _reference_module(name: str):
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_FUZZ = _reference_module("test_fuzz_communicators")


def _call(accl, ref, op, sb, rb, count, root, func, comm, wire=None):
    F = RefF if ref else ReduceFunction
    kw = dict(comm=comm)
    if wire is not None:
        kw["compress_dtype"] = (RefDT if ref else DataType)[wire]
    f = F(int(func))
    return {
        "allreduce": lambda: accl.allreduce(sb, rb, count, f, **kw),
        "reduce": lambda: accl.reduce(sb, rb, count, root, f, **kw),
        "reduce_scatter": lambda: accl.reduce_scatter(sb, rb, count, f,
                                                      **kw),
        "allgather": lambda: accl.allgather(sb, rb, count, **kw),
        "gather": lambda: accl.gather(sb, rb, count, root, **kw),
        "scatter": lambda: accl.scatter(sb, rb, count, root, **kw),
        "alltoall": lambda: accl.alltoall(sb, rb, count, **kw),
        "bcast": lambda: accl.bcast(sb, count, root, **kw),
    }[op]()


def _run_case(accl, ref, op, members, count, func, root, x, send_slots,
              recv_slots, wire=None):
    """One sub-communicator call on facade `accl`; returns the result
    buffer's image (the send buffer for bcast)."""
    world = x.shape[0]
    comm = accl.split(list(members))
    sb = accl.create_buffer(send_slots * count, data=x)
    rb = accl.create_buffer(
        recv_slots * count,
        data=np.full((world, recv_slots * count), SENTINEL, np.float32))
    _call(accl, ref, op, sb, rb, count, root, func, comm, wire)
    return np.array(sb.host if op == "bcast" else rb.host)


def _check(got, want, before, members, what):
    world = before.shape[0]
    rows = list(members)
    others = [r for r in range(world) if r not in members]
    got = torch.as_tensor(got)
    assert same(got[rows], want[rows]), f"{what}: member rows"
    assert same(got[others], before[others]), f"{what}: non-member rows"


@pytest.mark.parametrize(
    "cfg", _FUZZ._sample(),
    ids=lambda c: f"{c[0]}-{c[1]}-w{c[2]}-g{len(c[3])}-n{c[4]}")
def test_communicator_fuzz_families(cfg):
    """The reference fuzz's sub-groups of random worlds through both
    facades: member rows bitwise, non-member rows untouched."""
    i, op, world, members, count, func, root = cfg
    g = len(members)
    send_spec, recv_spec = _FUZZ.SHAPES[op]
    send_slots = g if send_spec is None else send_spec
    recv_slots = g if recv_spec is None else max(recv_spec, 1)
    x = np.random.default_rng(_FUZZ.SEED + i).standard_normal(
        (world, send_slots * count)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    args = (op, members, count, func, root, x, send_slots, recv_slots)
    want = _run_case(RefACCL(mesh), True, *args)
    got = _run_case(ACCL(world=world, torch_device="cpu"), False, *args)
    before = x if op == "bcast" else np.full_like(want, SENTINEL)
    _check(got, want, before, members, f"cfg {cfg}")


@pytest.mark.parametrize("members,wire", [
    ((1, 4, 6), None), ((0, 2, 4, 6), None), ((0, 1, 3, 5, 7), None),
    ((1, 2, 5), "int8"), ((0, 2, 4, 6), "int8"), ((7, 3, 1, 0, 4), "int8"),
])
def test_subgroup_allreduce_on_the_card_routes(pair, members, wire):
    """A sub-group allreduce through the routes the card takes (the ring
    kernel, the closed-form int8 ring: their plain versions here) at
    groups of 3, 4 and 5, in member order and not, bitwise with the JAX
    facade on member rows; the rest untouched."""
    ref, _ = pair
    port = ACCL(world=WORLD, torch_device="cpu", egr_rx_buf_size=4096)
    port.cclo.compiler.use_ring_kernel = True  # inherited by the groups
    ref = RefACCL(ref.mesh, egr_rx_buf_size=4096)
    ref.cclo.compiler.use_pallas_ring = True  # interpret mode here
    count = 1031
    x = np.random.default_rng(sum(members)).standard_normal(
        (WORLD, count)).astype(np.float32)
    args = ("allreduce", members, count, 0, 0, x, 1, 1, wire)
    want = _run_case(ref, True, *args)
    got = _run_case(port, False, *args)
    _check(got, want, np.full_like(want, SENTINEL), members, str(members))
    ctx = port.cclo._comm_ctx(port.split(list(members)).exchmem_addr)
    assert ctx.world == len(members) and ctx.compiler.use_ring_kernel
    assert ctx.rows == tuple(members)


def test_split_communicator_disjoint_groups(pair):
    """One facade, one set of buffers, async collectives on two disjoint
    sub-groups; bad splits are refused."""
    x = np.random.default_rng(201).standard_normal(
        (WORLD, 32)).astype(np.float32)

    def run(accl, ref):
        lo, hi = accl.split([0, 1, 2, 3]), accl.split([4, 5, 6, 7])
        assert lo.exchmem_addr != 0 and hi.exchmem_addr != lo.exchmem_addr
        sb, rb = accl.create_buffer(32, data=x), accl.create_buffer(32)
        f = (RefF if ref else ReduceFunction).SUM
        r1 = accl.allreduce(sb, rb, 32, f, comm=lo, run_async=True)
        r2 = accl.allreduce(sb, rb, 32, f, comm=hi, run_async=True)
        accl.wait(r1)
        accl.wait(r2)
        with pytest.raises(ValueError):
            accl.split([0, 0, 1])
        with pytest.raises(ValueError):
            accl.split([99])
        return rb.host

    ref, port = pair
    assert same(run(port, False), run(ref, True))


def test_split_subgroup_rooted_and_p2p(pair):
    """Roots and src/dst are communicator-relative. A recv on a group
    writes its member rows (dst's from src, the others their own send
    rows) and leaves the rest as they were."""
    x = np.random.default_rng(202).standard_normal(
        (WORLD, 16)).astype(np.float32)

    def run(accl, ref):
        mid = accl.split([2, 5, 6])
        b = accl.create_buffer(16, data=x)
        accl.bcast(b, 16, root=1, comm=mid)  # comm rank 1 == global 5
        sb = accl.create_buffer(16, data=x)
        rb = accl.create_buffer(
            16, data=np.full((WORLD, 16), SENTINEL, np.float32))
        accl.send(sb, 16, src=0, dst=2, tag=9, comm=mid)
        accl.recv(rb, 16, src=0, dst=2, tag=9, comm=mid)
        return b.host, rb.host

    ref, port = pair
    (wb, wr), (gb, gr) = run(ref, True), run(port, False)
    assert same(gb, wb) and same(gr, wr)
    assert same(gr[6], x[2]) and same(gr[[2, 5]], x[[2, 5]])
    assert bool((gr[[0, 1, 3, 4, 7]] == SENTINEL).all())
    exp = x.copy()
    exp[[2, 6]] = x[5]
    assert same(gb, exp)


def test_split_gather_scales_with_group(pair):
    x = np.random.default_rng(203).standard_normal(
        (WORLD, 8)).astype(np.float32)

    def run(accl, ref):
        grp = accl.split([1, 3, 5, 7])
        sb, gb = accl.create_buffer(8, data=x), accl.create_buffer(8 * 4)
        accl.gather(sb, gb, 8, root=0, comm=grp)  # root 0 == global 1
        return gb.host

    ref, port = pair
    got = run(port, False)
    assert same(got, run(ref, True))
    assert same(got[1], np.concatenate([x[1], x[3], x[5], x[7]]))


def test_split_registers_and_persists(pair):
    """split() registers the handle on the same facade and writes its
    table to exchange memory, word for word the reference's; a foreign
    communicator is refused."""
    ref, port = pair
    subs = [accl.split([0, 1]) for accl in (ref, port)]
    assert subs[1] in port.communicators
    assert subs[1].exchmem_addr == subs[0].exchmem_addr
    assert "size=2" in port.dump_communicator(port.communicators.index(
        subs[1]))
    n = 2 + 2 * Communicator.WORDS_PER_RANK
    words = [[a.cclo.read(s.exchmem_addr + 4 * i) for i in range(n)]
             for a, s in zip((ref, port), subs)]
    assert words[0] == words[1]
    rt = Communicator.from_exchmem_words(words[1])
    assert [r.device_index for r in rt.ranks] == [0, 1]
    foreign = Communicator(subs[1].ranks, 0, subs[1].exchmem_addr)
    sb, rb = port.create_buffer(8), port.create_buffer(8)
    with pytest.raises(ValueError, match="does not belong"):
        port.allreduce(sb, rb, 8, ReduceFunction.SUM, comm=foreign)
    assert isinstance(subs[0], RefCommunicator)


def test_split_same_members_reuses_table(pair):
    _, port = pair
    a = port.split([2, 3])
    alloc_after = port._exchmem_alloc
    assert port.split([2, 3]) is a
    assert port._exchmem_alloc == alloc_after
    c = port.split([3, 2])  # another order maps roots otherwise
    assert c is not a
    dev = port.cclo
    assert dev._comm_ctx(a.exchmem_addr) is not dev._comm_ctx(c.exchmem_addr)
    # a table of the same members at another address shares the context
    twin = Communicator(a.ranks, 0, 0x1800)
    port._write_communicator(twin)
    assert dev._comm_ctx(twin.exchmem_addr) is dev._comm_ctx(a.exchmem_addr)


def test_communicator_table_write_drops_cached_context(pair):
    """A write into a cached table drops the cached context: the next
    call re-reads the table."""
    _, port = pair
    comm = port.split([4, 7])
    dev = port.cclo
    first = dev._comm_ctx(comm.exchmem_addr)
    assert dev._comm_ctx(comm.exchmem_addr) is first
    port._write_communicator(comm)
    assert comm.exchmem_addr not in dev._comm_cache
    assert dev._comm_ctx(comm.exchmem_addr) is first  # same group context


def test_get_comm_group_roundtrip(pair):
    """get_comm_group reads the rank table back from exchange memory."""
    ref, port = pair
    ranks = port.get_comm_group()
    assert len(ranks) == WORLD
    cached = port.communicators[0].ranks
    assert [r.device_index for r in ranks] == \
        [r.device_index for r in cached]
    assert [r.port for r in ranks] == [r.port for r in cached]
    sub = port.split([0, 3, 5])
    assert [r.device_index for r in port.get_comm_group(sub)] == [0, 3, 5]
    ref_sub = ref.split([0, 3, 5])
    assert [vars(r) for r in port.get_comm_group(sub)] == \
        [vars(r) for r in ref.get_comm_group(ref_sub)]


def test_subcommunicator_sequence_fused_eager_and_reference(pair):
    """A batch on a split() communicator (reduce_scatter -> allgather,
    then a bcast from a group-relative root) is bitwise the same calls
    issued eagerly and the JAX facade's sequence, on member rows; the
    rest keep their values. Dispatched twice (other inputs the second
    time) to exercise the prepared program."""
    ref, port = pair
    members, g, n = (0, 2, 5, 7), 4, 24
    rng = np.random.default_rng(204)

    def bufs(accl, x):
        return (accl.create_buffer(g * n, data=x),
                accl.create_buffer(n, data=np.full((WORLD, n), SENTINEL,
                                                   np.float32)),
                accl.create_buffer(g * n, data=np.full((WORLD, g * n),
                                                       SENTINEL, np.float32)))

    def record(ops, accl, ref_side, a, b, c):
        f = (RefF if ref_side else ReduceFunction).SUM
        ops.reduce_scatter(a, b, n, f)
        ops.allgather(b, c, n)
        ops.bcast(c, g * n, 2)

    rc, pc = ref.split(list(members)), port.split(list(members))
    x = rng.standard_normal((WORLD, g * n)).astype(np.float32)
    rbufs, fbufs, ebufs = bufs(ref, x), bufs(port, x), bufs(port, x)
    seq = ref.sequence(comm=rc)
    record(seq, ref, True, *rbufs)
    seq.run()
    rec = port.sequence(comm=pc)
    record(rec, port, False, *fbufs)
    prog = rec.compile()
    prog.run()

    class Eager:  # the facade's calls on the group
        def __getattr__(self, op):
            return lambda *a, **k: getattr(port, op)(*a, comm=pc, **k)

    record(Eager(), port, False, *ebufs)
    for k in (1, 2):
        want = np.array(rbufs[k].host)
        _check(fbufs[k].host, want, np.full_like(want, SENTINEL), members,
               f"fused buffer {k}")
        assert same(ebufs[k].host, want), f"eager buffer {k}"
    # a second dispatch on new inputs
    x2 = rng.standard_normal((WORLD, g * n)).astype(np.float32)
    fbufs[0].host = torch.from_numpy(x2)
    prog.run()
    seq2 = ref.sequence(comm=rc)
    r2 = bufs(ref, x2)
    record(seq2, ref, True, *r2)
    seq2.run()
    assert same(fbufs[2].host, np.array(r2[2].host))
    assert prog.graph.inputs[0].shape == (g, g * n)
