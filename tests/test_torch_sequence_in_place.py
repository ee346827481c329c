"""A recorded sequence's in-place path: which steps a captured graph runs
through kernel 1's indirect entry, reading bound operands where they lie
and writing fresh results (SequencePlan.placement, SequenceGraph).

The placement is pure Python and is tested here on the CPU, where no
graph is captured. The tests marked `card` run the kernel's indirect
entry and captured graphs; they skip without a CUDA device. This file
imports no JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_sequence_in_place.py
"""

from __future__ import annotations

import pytest
import torch

from accl_tpu_torch import ACCL, DataType, ReduceFunction

SUM, MAX = ReduceFunction.SUM, ReduceFunction.MAX
W = 4
N = 64


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- the placement, on the CPU ----------------------------------------------

def _exact(rec, b):
    rec.allreduce(b[0], b[1], N, SUM)


def _write_only(rec, b):
    rec.copy(b[0], b[1], N)  # a staged step: reads b0, only writes b1
    rec.allreduce(b[2], b[3], N, SUM)


def _chained(rec, b):
    rec.allreduce(b[0], b[1], N, SUM)
    rec.allreduce(b[1], b[2], N, SUM)


def _kept(rec, b):
    rec.allreduce(b[0], b[1], N, SUM)
    rec.copy(b[1], b[2], N)  # a staged step reads the result


def _in_place_call(rec, b):
    rec.allreduce(b[0], b[0], N, SUM)


def _partial_width(rec, b):
    rec.allreduce(b[0], b[4], N, SUM)  # b4 is twice as wide


def _bf16(rec, b):
    rec.allreduce(b[0], b[1], N, SUM, compress_dtype=DataType.bfloat16)


def _int8(rec, b):
    rec.allreduce(b[0], b[1], N, SUM, compress_dtype=DataType.int8)


def _alltoall(rec, b):
    rec.alltoall(b[5], b[6], N)


def _combine(rec, b):
    rec.combine(N, SUM, b[0], b[1], b[2])


def _after_staged(rec, b):
    rec.copy(b[0], b[1], N)
    rec.allreduce(b[1], b[2], N, SUM)  # its operand is a staged result


# (record, on a sub-communicator, in-place steps as (step, source, fresh),
# loaded buffers in first-appearance order)
PLACEMENTS = {
    "exact": (_exact, False, [(0, ("bound", 0), True)], [False, False]),
    "write_only": (_write_only, False, [(1, ("bound", 2), True)],
                   [True, False, False, False]),
    "chained": (_chained, False,
                [(0, ("bound", 0), True), (1, ("fresh", 0), True)],
                [False, False, False]),
    "kept": (_kept, False, [(0, ("bound", 0), False)],
             [False, False, False]),
    "in_place_call": (_in_place_call, False, [(0, ("bound", 0), True)],
                      [False]),
    "sub_communicator": (_exact, True, None, None),
    "partial_width": (_partial_width, False, [], [True, True]),
    "bf16": (_bf16, False, [], [True, False]),
    "int8": (_int8, False, [], [True, False]),
    "alltoall": (_alltoall, False, [], [True, False]),
    "combine": (_combine, False, [], [True, True, False]),
    "after_staged": (_after_staged, False, [], [True, False, False]),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_placement(case, monkeypatch):
    """Which steps run in place and which buffers are loaded: kernel 1 on
    the exact wire, full width, on the default world, reading a bound
    value or an in-place result, runs in place; a buffer is loaded only
    where a staged step reads its bound value."""
    from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

    record, sub, want_steps, want_loaded = PLACEMENTS[case]
    accl = ACCL(world=W, torch_device="cpu")
    accl.cclo.compiler.use_ring_kernel = True  # the card's bodies
    bufs = [accl.create_buffer(N) for _ in range(4)]
    bufs += [accl.create_buffer(2 * N), accl.create_buffer(W * N),
             accl.create_buffer(W * N)]
    asked = []
    graph_of = ScheduleCompiler.sequence_graph

    def spy(self, seq, body, inputs, in_place=False):
        asked.append(in_place)
        return graph_of(self, seq, body, inputs, in_place)

    monkeypatch.setattr(ScheduleCompiler, "sequence_graph", spy)
    rec = accl.sequence(comm=accl.split([0, 2]) if sub else None)
    record(rec, bufs)
    prog = rec.compile()
    assert prog.graph.placement is None  # the CPU stages every step
    # the device asks for the in-place path on the default world only
    assert asked == [not sub]
    if want_steps is None:
        return
    pre = prog._prepared
    placement = pre.seq.placement(
        pre.ctx.compiler, [(t.shape[-1], t.dtype) for t in
                           accl.cclo._bound_tensors(pre.seq, pre.bufs,
                                                    pre.ctx)])
    got = [(p.step, p.source, p.fresh) for p in placement.steps]
    assert got == want_steps
    assert list(placement.loaded) == want_loaded
    assert len(placement.finals) == len(pre.seq.out_idx)
    for p in placement.steps:
        assert p.n == N and p.dtype == torch.float32
        assert p.ring.launches(N) == [(0, N)]


# -- the card ----------------------------------------------------------------

def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


@pytest.mark.card
def test_indirect_entry_matches_direct(card):
    """Kernel 1's indirect entry writes what the direct entry writes, bit
    for bit: fp32, bf16 and int64, SUM and MAX, one and two directions,
    the vector and the scalar instantiation."""
    from accl_tpu_torch.ops import ring_allreduce as ring

    world = 8
    gen = torch.Generator(device=card).manual_seed(26)
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        for n in (3 * 2048 * world, 3 * 2048 * world + 3):  # vec, scalar
            if dtype.is_floating_point:
                x = torch.randn((world, n), generator=gen, device=card,
                                dtype=torch.float32).to(dtype)
            else:
                x = torch.randint(-2**40, 2**40, (world, n), generator=gen,
                                  device=card, dtype=dtype)
            for func in (SUM, MAX):
                for dirs, direct in ((1, ring.ring_allreduce),
                                     (2, ring.ring_allreduce_bidir)):
                    want = direct(x, world, func)
                    out = torch.full_like(x, 7)
                    vec = ring.vector_path(x, out)
                    assert vec == (n % 8 == 0)
                    table = torch.tensor([x.data_ptr(), out.data_ptr()],
                                         dtype=torch.int64, device=card)
                    before = direct.launches
                    ring.ring_allreduce_indirect(
                        table.data_ptr(), card, dtype, world, n, n, n, vec,
                        func, dirs)
                    assert direct.launches == before + 1
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(out), _bits(want)), (
                        dtype, n, func, dirs)


def _operands(world, counts, device, offset=0):
    """One flat seeded tensor cut into (world, n) views, as the
    benchmark's operands are (`offset` elements shifts every view)."""
    gen = torch.Generator(device=device).manual_seed(2026)
    flat = torch.randn(offset + world * sum(counts), generator=gen,
                       device=device)
    views, off = [], offset
    for n in counts:
        views.append(flat[off:off + world * n].view(world, n))
        off += world * n
    return flat, views


def _program(accl, counts, views, record=None):
    sends, recvs = [], []
    for n, view in zip(counts, views):
        s = accl.create_buffer(n, torch.float32)
        s.device = view
        sends.append(s)
        recvs.append(accl.create_buffer(n, torch.float32))
    rec = accl.sequence()
    if record is None:
        for s, r, n in zip(sends, recvs, counts):
            rec.allreduce(s, r, n, SUM)
    else:
        record(rec, sends, recvs)
    return rec.compile(), sends, recvs


def _eager(accl, view, n):
    s, r = accl.create_buffer(n, torch.float32), accl.create_buffer(
        n, torch.float32)
    s.device = view.clone()
    accl.allreduce(s, r, n, SUM, from_device=True, to_device=True)
    return r.device


def _run(prog):
    return prog.run(from_device=True, to_device=True)


@pytest.mark.card
def test_in_place_replay_matches_eager(card):
    """An in-place replay is bitwise the same calls issued eagerly: a
    decode-shaped batch at small width, a call of two 4 MiB segments, a
    chained batch with a staged reader, and operands off 16 bytes, which
    each dispatch stages."""
    world = 8
    accl = ACCL(world=world)
    # decode-shaped: many calls of one width, operands views of one tensor
    counts = [12288] * 16
    flat, views = _operands(world, counts, card)
    prog, sends, recvs = _program(accl, counts, views)
    assert len(prog.graph.placement.steps) == 16
    assert prog.graph.inputs == [] and prog.graph.outputs == ()
    for k in range(2):
        flat.add_(1.0)
        _run(prog)
        for view, n, r in zip(views, counts, recvs):
            assert torch.equal(r.device, _eager(accl, view, n))
    # two 4 MiB segments, and a third of 1.5 MiB (rows of 9.5 MiB)
    n = (9 * 1024 * 1024 + 512 * 1024) // 4
    flat, views = _operands(world, [n], card)
    prog, _, recvs = _program(accl, [n], views)
    assert prog.graph.placement.steps[0].ring.launches(n) == [
        (0, 1 << 20), (1 << 20, 2 << 20), (2 << 20, n)]
    _run(prog)
    assert torch.equal(recvs[0].device, _eager(accl, views[0], n))

    # chained: b = ar(a), c = ar(b), d = copy(b) (a staged reader: b kept)
    def chain(rec, sends, recvs):
        c, d = accl.create_buffer(n2), accl.create_buffer(n2)
        chain.out = (c, d)
        rec.allreduce(sends[0], recvs[0], n2, SUM)
        rec.allreduce(recvs[0], c, n2, SUM)
        rec.copy(recvs[0], d, n2)

    n2 = 40000
    flat, views = _operands(world, [n2], card)
    prog, _, recvs = _program(accl, [n2], views, chain)
    srcs = [(p.source, p.fresh) for p in prog.graph.placement.steps]
    assert srcs == [(("bound", 0), False), (("kept", 0), True)]
    _run(prog)
    b = _eager(accl, views[0], n2)
    c, d = chain.out
    assert torch.equal(recvs[0].device, b)
    assert torch.equal(c.device, _eager(accl, b, n2))
    assert torch.equal(d.device, b)
    # operands 4 bytes off a 16-byte base: staged at each dispatch
    flat, views = _operands(world, counts[:4], card, offset=1)
    prog, sends, recvs = _program(accl, counts[:4], views)
    pre = prog._prepared
    binding = prog.graph.bind(accl.cclo._bound_tensors(pre.seq, pre.bufs,
                                                       pre.ctx))
    assert binding.staged == 4 and binding.in_place == 4
    _run(prog)
    for view, n, r in zip(views, counts, recvs):
        assert torch.equal(r.device, _eager(accl, view, n))


@pytest.mark.card
def test_results_and_operands_across_dispatches(card):
    """Dispatch k's results stay as they were after dispatch k+1; a send
    buffer whose tensor is replaced between dispatches is read from the
    new tensor; two dispatches enqueued before either is waited on both
    complete with their own operands."""
    world = 8
    accl = ACCL(world=world)
    counts = [4096, 12288]
    flat, views = _operands(world, counts, card)
    prog, sends, recvs = _program(accl, counts, views)
    _run(prog)
    kept = [(r.device, r.device.clone()) for r in recvs]
    flat.add_(1.0)
    _run(prog)
    for (t, saved), r in zip(kept, recvs):
        assert torch.equal(t, saved) and not torch.equal(t, r.device)
    # a replaced send tensor
    fresh = torch.randn((world, counts[0]), device=card)
    sends[0].device = fresh
    _run(prog)
    assert torch.equal(recvs[0].device, _eager(accl, fresh, counts[0]))
    # two in flight: the first reads x1, the second x2
    x1 = torch.randn((world, counts[0]), device=card)
    x2 = torch.randn((world, counts[0]), device=card)
    sends[0].device = x1
    r1 = prog.run(from_device=True, run_async=True)
    sends[0].device = x2
    r2 = prog.run(from_device=True, run_async=True)
    accl.wait(r2)
    accl.wait(r1)
    assert torch.equal(r1.outputs[0], _eager(accl, x1, counts[0]))
    assert torch.equal(r2.outputs[0], _eager(accl, x2, counts[0]))
