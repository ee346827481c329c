"""The multi-process DCN backend's ipc link against its gloo and loopback
forms.

device/dcn_transport.IpcLink moves a hop device to device: each process
exports a receive region for every source peer, the sender writes its
message into its slot there, and the host sends only a token over the
control plane. On the CPU the same protocol maps files under /dev/shm
(device/ipc_arena.ShmArena); here it runs one thread a host over an
IpcHub, with slots far smaller than the messages, so that a pair's slots
grow inside hops all the time. Its rows must be bitwise those of the
LoopbackHub form and of the in-process DCNDevice on every flat stage
(test_torch_dcn_flat.run_cases) and every two-tier stage
(test_torch_dcn_device.multi_process_form), with the tally equal and
nothing staged through the host. Then the edge cases (growth, hops in one
direction, many hops, a message of zero bytes), two OS processes over
gloo's control plane (run_dcn --link ipc against --link gloo), and the
refusals: a peer on another host or device type, an unknown link, and
the gloo link's staged bytes.
"""

import os
import threading

import numpy as np
import pytest
import torch

import test_torch_dcn_device as dcn_device
import test_torch_dcn_flat as dcn_flat
from accl_tpu_torch import ACCL, DataType, ReduceFunction
from accl_tpu_torch.device.dcn_device import DCNDevice
from accl_tpu_torch.device.dcn_transport import (
    DCNTransport,
    GlooLink,
    IpcHub,
    IpcLink,
    LoopbackHub,
    link_name,
)
from accl_tpu_torch.parallel import make_mesh

TOPOS = [(2, 1), (3, 2), (2, 4)]
IDS = [f"{p}x{l}" for p, l in TOPOS]
SLOT = 64  # bytes: every stage's messages outgrow it, so slots grow


def _shm_left():
    return [f for f in os.listdir("/dev/shm") if f.startswith("accl-ipc-")] \
        if os.path.isdir("/dev/shm") else []


# -- (a) every flat and two-tier stage -------------------------------------


@pytest.mark.parametrize("wire", ["exact", "float16", "int8"])
@pytest.mark.parametrize("P,L", TOPOS, ids=IDS)
def test_flat_bodies_over_ipc_are_loopback_and_stacked(P, L, wire):
    """Every flat body (run_cases: each _body branch a DCNDevice's
    selection reaches) over the ipc link: each host's rows bitwise the
    stacked body's (run_cases checks), so bitwise the LoopbackHub form's;
    sent, messages and hops those of the LoopbackHub form, staged 0."""
    W = P * L
    case_list = dcn_flat.cases(W)
    seed = W * 11 + len(wire)
    ipc = dcn_flat.run_cases(P, L, wire, case_list, seed,
                             hub=IpcHub(P, slot_bytes=SLOT))
    loop = dcn_flat.run_cases(P, L, wire, case_list, seed)
    for p in range(P):
        for case, ti, tl in zip(case_list, ipc[p], loop[p]):
            assert {k: ti[k] for k in ("sent", "messages", "hops")} == \
                {k: tl[k] for k in ("sent", "messages", "hops")}, case[0]
            assert not any(ti["staged"].values()), (case[0], ti)
    assert sum(t["sent"].get("flat", 0) for t in ipc[0]) > 0


@pytest.mark.parametrize("wire", [None, DataType.float16, DataType.int8],
                         ids=["exact", "float16", "int8"])
@pytest.mark.parametrize("P,L", TOPOS, ids=IDS)
def test_two_tier_stages_over_ipc_are_the_in_process_form(P, L, wire):
    """_drive's stages (every two-tier op, p2p, the host-0 group, a
    barrier) and a recorded batch over the ipc link: bitwise the
    in-process DCNDevice (multi_process_form checks); the last call's
    tally that of the LoopbackHub form, staged 0."""
    ipc = dcn_device.multi_process_form(P, L, wire,
                                        IpcHub(P, slot_bytes=SLOT))
    loop = dcn_device.multi_process_form(P, L, wire, LoopbackHub(P))
    for ti, tl in zip(ipc, loop):
        assert {k: ti[k] for k in ("sent", "messages", "hops")} == \
            {k: tl[k] for k in ("sent", "messages", "hops")}
        assert not any(ti["staged"].values()), ti
    assert not _shm_left()


# -- (b) edge cases ------------------------------------------------------


def test_growth_inside_a_hop_and_zero_byte_messages():
    """A message larger than its slot: the receiver exports a larger
    region inside the hop (doubling past the size), the sender maps it,
    the bytes arrive whole; a zero-byte message sends nothing and
    arrives empty; a returned tensor is the receiver's own."""
    P, rng = 3, np.random.default_rng(31)
    payload = {(s, d): torch.from_numpy(rng.integers(
        0, 256, 5 * SLOT + 3 * s + d, dtype=np.uint8))
        for s in range(P) for d in range(P) if s != d}

    def host(p, transport):
        link = transport.link
        assert link.rx[(p + 1) % P].cap == SLOT
        sends = {q: payload[(p, q)] for q in range(P) if q != p}
        got = link.exchange(sends, {q: payload[(q, p)].numel()
                                    for q in range(P) if q != p})
        for q, t in got.items():
            assert torch.equal(t, payload[(q, p)]), (p, q)
        caps = {q: link.rx[q].cap for q in got}
        kept = {q: t.clone() for q, t in got.items()}
        # zero bytes to the previous peer, messages to the next one: the
        # third rewrites the slot the first hop came through
        nxt, prev = (p + 1) % P, (p - 1) % P
        for k in (1, 2):
            again = link.exchange(
                {nxt: payload[(p, nxt)][k:k + 7],
                 prev: payload[(p, prev)][:0]}, {prev: 7, nxt: 0})
            assert again[nxt].numel() == 0
            assert torch.equal(again[prev], payload[(prev, p)][k:k + 7])
        for q, t in got.items():  # no returned tensor aliases a slot
            assert torch.equal(t, kept[q])
        return caps, dict(link.sent_seq), dict(link.recv_seq)

    out = dcn_flat._threads(P, host, IpcHub(P, slot_bytes=SLOT))
    for p, (caps, sent, recv) in enumerate(out):
        assert all(c == 8 * SLOT for c in caps.values()), caps
        # the zero-byte messages took no hop of their pair
        assert sent == {(p + 1) % P: 3, (p - 1) % P: 1}, sent
        assert recv == {(p - 1) % P: 3, (p + 1) % P: 1}, recv
    assert not _shm_left()


def _facades(P, hub, fn):
    """fn(facade) on P one-rank hosts over `hub` and on the in-process
    device; returns (each host's (result, link hop counts), the twin's)."""
    twin = fn(ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": 1}, device="cpu"))))

    def host(p, transport):
        dev = DCNDevice(local_device_count=1, transport=transport,
                        torch_device="cpu")
        return fn(ACCL(device=dev)), dict(transport.link.sent_seq)

    return dcn_flat._threads(P, host, hub), twin


def test_one_directional_hops():
    """Flat bcast from rank W-1, p2p 1 -> W-1 and scatter from W-1 at
    3 x 1: each host's row bitwise the in-process device's; only the
    root's pairs advance (bcast and scatter), only 1 -> 2 for the p2p."""
    P = 3
    x = np.random.default_rng(32).standard_normal((P, 96)).astype(
        np.float32)

    def bcast(a):
        b = a.create_buffer(96, data=x)
        a.bcast(b, 96, P - 1)
        return b.host

    def p2p(a):
        s, r = a.create_buffer(96, data=x), a.create_buffer(16)
        a.send(s, 16, src=1, dst=P - 1, tag=2)
        a.recv(r, 16, src=1, dst=P - 1, tag=2)
        return r.host

    def scatter(a):
        s, r = a.create_buffer(96, data=x), a.create_buffer(32)
        a.scatter(s, r, 32, P - 1)
        return r.host

    for fn, movers in ((bcast, {P - 1}), (p2p, {1}), (scatter, {P - 1})):
        hosts, want = _facades(P, IpcHub(P, slot_bytes=SLOT), fn)
        for p, (got, sent) in enumerate(hosts):
            rows = [p] if fn is not p2p else ([p] if p == P - 1 else [])
            assert np.array_equal(got.numpy()[rows].view(np.int32),
                                  want.numpy()[rows].view(np.int32)), \
                (fn.__name__, p)
            if p not in movers:
                assert not any(sent.values()), (fn.__name__, p, sent)
        assert any(hosts[next(iter(movers))][1].values())


def test_many_hops_cycle_both_slots():
    """A recorded 3-step sequence (allreduce -> allgather -> bcast) at
    P = 3, run five times: every pair's slots alternate many times (the
    acknowledgement two hops back guards each rewrite), each run's rows
    bitwise the in-process device's."""
    P, n = 3, 300
    x = np.random.default_rng(33).standard_normal((P, n)).astype(np.float32)

    def runs(a):
        s, r, g = (a.create_buffer(n, data=x), a.create_buffer(n),
                   a.create_buffer(n * P))
        seq = a.sequence()
        seq.allreduce(s, r, n, ReduceFunction.SUM)
        seq.allgather(r, g, n)
        seq.bcast(g, n * P, P - 1)
        prog = seq.compile()
        outs = []
        for _ in range(5):
            prog.run()
            outs.append((r.host.clone(), g.host.clone()))
        return outs

    hosts, want = _facades(P, IpcHub(P, slot_bytes=SLOT), runs)
    for p, (got, sent) in enumerate(hosts):
        for (r, g), (wr, wg) in zip(got, want):
            assert np.array_equal(r.numpy()[p].view(np.int32),
                                  wr.numpy()[p].view(np.int32))
            assert np.array_equal(g.numpy()[p].view(np.int32),
                                  wg.numpy()[p].view(np.int32))
        assert sent[(p + 1) % P] >= 10, sent  # the rings' pair


# -- (c) two OS processes over gloo's control plane ---------------------------


def test_two_os_processes_on_the_ipc_link(tmp_path):
    """run_dcn --procs 2 --local-devices 1 --device cpu --sequence, on
    --link ipc and on --link gloo: both children exit 0 on each link
    (every stage's rows bitwise its in-process device's, run_dcn checks);
    the dcn_bytes and dcn_sequence lines equal gloo's but for the link
    and the staged bytes, 0 on ipc and every byte sent on gloo."""
    lines = {}
    for link in ("ipc", "gloo"):
        (tmp_path / link).mkdir()
        rcs, outs = dcn_device._run_dcn_procs(2, tmp_path / link, (
            "--local-devices", "1", "--link", link, "--sequence"))
        assert rcs == [0, 0], f"{link} rc={rcs}\n" + "\n---\n".join(outs)
        for i, out in enumerate(outs):
            assert f"RANKS [{i}] proc {i}/2 OK" in out
        lines[link] = [(dcn_device._json_line(o, "dcn_bytes"),
                        dcn_device._json_line(o, "dcn_sequence"))
                       for o in outs]
    staged = ("link", "staged", "flat_staged")
    for (bi, si), (bg, sg) in zip(lines["ipc"], lines["gloo"]):
        for a, b in ((bi, bg), (si, sg)):
            assert {k: v for k, v in a.items() if k not in staged} == \
                {k: v for k, v in b.items() if k not in staged}
            assert (a["link"], b["link"]) == ("ipc", "gloo")
        assert bi.get("staged", 0) == bi["flat_staged"] == 0
        assert si["flat_staged"] == 0
        assert bg["flat_staged"] == bg["flat_sent"] == 384
        assert sg["flat_staged"] == sg["flat_sent"]
    assert not _shm_left()


# -- (d) refusals -----------------------------------------------------------


class _Elsewhere:
    """A control plane on which one peer reports another identity."""

    def __init__(self, inner, peer, **field):
        self.inner, self.peer, self.field = inner, peer, field

    def all_gather(self, obj):
        out = self.inner.all_gather(obj)
        out[self.peer] = dict(out[self.peer], identity=dict(
            out[self.peer]["identity"], **self.field))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("field", [{"host": "another-host"},
                                   {"device": "cuda"}],
                         ids=["host", "device_type"])
def test_ipc_refuses_a_peer_on_another_host_or_device(field):
    """link='ipc' with a peer reporting another host or device type
    raises on every process, naming link='gloo'; it leaves no region."""
    P = 2
    hub = IpcHub(P, slot_bytes=SLOT)
    errors = [None] * P

    def host(p):
        try:
            IpcLink(_Elsewhere(hub.control(p), 1, **field), p, P, "cpu",
                    SLOT)
        except RuntimeError as e:
            errors[p] = str(e)

    threads = [threading.Thread(target=host, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(e and "link='gloo'" in e for e in errors), errors
    assert not _shm_left()


def test_unknown_link_and_misplaced_link_raise():
    """An unknown link name raises wherever it is given; the default is
    ipc on cuda and gloo on the CPU; link= is refused beside transport=
    or mesh=; ipc on another device type raises."""
    assert link_name(None, "cuda") == "ipc"
    assert link_name(None, "cpu") == "gloo"
    assert link_name("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="unknown link"):
        link_name("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown link"):
        DCNDevice(num_processes=2, local_device_count=1, torch_device="cpu",
                  coordinator_address="127.0.0.1:1", link="shm")
    with pytest.raises(ValueError, match="unknown link"):
        DCNTransport.connect(2, 0, "127.0.0.1:1", link="tcp")
    with pytest.raises(ValueError, match="link="):
        DCNDevice(local_device_count=1, torch_device="cpu",
                  transport=LoopbackHub(2).transport(0), link="ipc")
    with pytest.raises(ValueError, match="link="):
        DCNDevice(mesh=make_mesh({"dcn": 2, "ici": 1}, device="cpu"),
                  link="gloo")
    with pytest.raises(ValueError, match="link='gloo'"):
        IpcLink(None, 0, 2, "meta")


def test_staged_tally_follows_the_link():
    """A link through the host (the gloo form) tallies staged == sent and
    keeps a message's bytes its own; the loopback form stages none and
    owns its queued copy too (the real gloo form's staged bytes: the
    OS-process test above)."""
    assert GlooLink.through_host and not IpcLink.through_host

    class Sent:
        """GlooLink.exchange's host copies, without a process group."""

        through_host = True

        def exchange(self, sends, sizes):
            self.kept = {q: t.to("cpu", copy=True) for q, t in sends.items()}
            return {q: torch.zeros(n, dtype=torch.uint8)
                    for q, n in sizes.items()}

    t = DCNTransport(0, 2, Sent())
    x = torch.arange(6, dtype=torch.float32)
    t.exchange("flat", {1: [x, x[:2]]}, {1: [((3,), torch.float32)]}, "cpu")
    x.add_(1)  # the sender reuses its tensor: the link's copy stays
    assert torch.equal(t.link.kept[1][:24].view(torch.float32),
                       torch.arange(6, dtype=torch.float32))
    assert t.tally()["staged"] == t.tally()["sent"] == {"flat": 32}
    loop = LoopbackHub(2)
    a, b = loop.transport(0), loop.transport(1)
    a.exchange("outer", {1: [x]}, {}, "cpu")
    x.add_(1)
    got = b.exchange("outer", {}, {0: [((6,), torch.float32)]}, "cpu")
    assert torch.equal(got[0][0], torch.arange(6, dtype=torch.float32) + 1)
    assert a.tally()["staged"] == {} and a.tally()["sent"] == {"outer": 24}
