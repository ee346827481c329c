"""The cross-process tiers of the multi-process DCN backend.

Counterpart of what XLA does for accl_tpu/device/dcn_device.py when a
lax.ppermute of a program over the (dcn, ici) axes crosses processes. In
the port's multi-process form each OS process is one host: it owns L
virtual ranks (global rank p*L + l) on its device and reaches the other
hosts through this module:

  - `connect` joins the default torch.distributed group over gloo (the
    counterpart of jax.distributed.initialize); a process whose group is
    already up reuses it;
  - `DCNTransport` moves one hop's messages between processes and tallies
    the bytes each tier sends (the reference's CountingWire measure);
  - `ProcessTier` is the outer tier of the two-tier compositions
    (sequencer/hierarchical.py, whose inner tier runs on the process's
    own rows as a StackedTier): the reference's per-rank schedule bodies
    (schedules.py: the reduce-scatter, allreduce and allgather rings,
    flat bcast, scatter, ring gather, ring reduce, alltoall, barrier over
    the flat reduce), with this process as one position on every outer
    ring and its L rows as that ring's L lines. lax.ppermute becomes a
    point-to-point exchange addressed to global process ranks on the
    default group (a position no pair addresses receives zeros, as under
    ppermute) and lax.axis_index the process's position;
  - `ProcessWorld` is the flat combined world (every call without a
    composition, L == 1, call sequences, streamed operands, stream_put):
    its `ProcessWire` runs the stacked flat bodies of schedules.py
    themselves on the process's L consecutive ranks, carrying each hop's
    pairs that leave the process.

Every fold, cast and int8 step runs on the process's own rows through the
same kernels (schedules.Wire) as the stacked schedules, so a process's
rows equal those of the one-card form bitwise.

What crosses the process boundary is the wire's payload: the rows on an
exact wire, the compressed dtype on a cast wire (Wire.send before the
hop, Wire.recv after it), codes and scales on the int8 wire, one byte
message a peer a hop. A link moves those messages (`link=` of
DCNTransport.connect):

  - "ipc" (`IpcLink`, the default on cuda): device to device, as the
    reference's device runtime moves a hop. Each process exports a
    receive region on its own device for every source peer (CUDA IPC on
    the card, a /dev/shm mapping on the CPU: device/ipc_arena.py); the
    sender copies its message into its slot there and the host sends
    only an 8-byte token over gloo, the control plane;
  - "gloo" (`GlooLink`, the default on the CPU): gloo moves CPU tensors
    only, so a hop is staged through the host: device -> host -> gloo
    over TCP -> host -> device.

No subgroup is ever created (dist.new_group is collective over every
process, and a host outside a sub-communicator never reaches its calls):
every hop and every control message is addressed on the default group.

`LoopbackHub` links P transports inside one process (one thread each),
so the per-rank bodies can be held against the stacked ones without
starting processes; `IpcHub` does the same over the ipc link's CPU form.
"""

from __future__ import annotations

import collections
import datetime
import math
import os
import queue
import threading
from typing import Callable

import torch

from ..constants import QUANT_BLOCK_ELEMS, ReduceFunction
from ..ops.compression import (
    dequantize_wire,
    quant_num_blocks,
    quantize_wire,
    wire_dtype,
)
from ..ops.lane_kernels import cast
from ..sequencer import schedules

DEFAULT_TIMEOUT_S = 120.0


def distributed_active() -> bool:
    """True when this process has joined the default torch.distributed
    group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def connect(num_processes: int, process_id: int,
            coordinator_address: str | None) -> bool:
    """Join the default group over gloo, with `coordinator_address`
    (host:port) as its TCP store; reuse a group that is already up (its
    size and rank must match). True when this call started the group."""
    import torch.distributed as dist

    if distributed_active():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise ValueError(
                f"the process group already up is rank {dist.get_rank()} "
                f"of {dist.get_world_size()}, not {process_id} of "
                f"{num_processes}")
        return False
    if coordinator_address is None:
        raise ValueError(
            "multi-process DCNDevice needs a coordinator_address")
    host = coordinator_address.rsplit(":", 1)[0]
    if host in ("127.0.0.1", "localhost"):
        # every process on one host: gloo's pairs ride the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return True


LINKS = ("ipc", "gloo")


def link_name(link: str | None, device) -> str:
    """The link a multi-process transport on `device` takes: "ipc" on
    cuda and "gloo" on the CPU unless `link` names one."""
    if link is None:
        return "ipc" if torch.device(device).type == "cuda" else "gloo"
    if link not in LINKS:
        raise ValueError(f"unknown link {link!r}: one of {LINKS}")
    return link


class GlooLink:
    """Point-to-point byte messages on the default group (gloo), staged
    through the host: a message leaves `device` as a CPU copy of its own
    (the sender may reuse its tensor) and lands back on `device`."""

    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    through_host = True

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def exchange(self, sends: dict[int, torch.Tensor],
                 sizes: dict[int, int]) -> dict[int, torch.Tensor]:
        import torch.distributed as dist

        sends = {peer: t.to("cpu", copy=True) for peer, t in sends.items()}
        recvs = {peer: torch.empty(n, dtype=torch.uint8)
                 for peer, n in sizes.items()}
        ops = [dist.P2POp(dist.isend, t, peer) for peer, t in sends.items()
               if t.numel()]
        ops += [dist.P2POp(dist.irecv, t, peer) for peer, t in recvs.items()
                if t.numel()]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait(self.timeout)
        return {peer: t.to(self.device) for peer, t in recvs.items()}

    def close(self) -> None:
        pass


class LoopbackHub:
    """`size` transports in one process, one thread each: a message is a
    copy put on the (src, dst) queue."""

    def __init__(self, size: int):
        self.size = size
        self.queues = {(s, d): queue.Queue() for s in range(size)
                       for d in range(size)}

    def transport(self, rank: int) -> "DCNTransport":
        return DCNTransport(rank, self.size, _LoopbackLink(self, rank))


class _LoopbackLink:
    through_host = False

    def __init__(self, hub: LoopbackHub, rank: int):
        self.hub = hub
        self.rank = rank

    def exchange(self, sends, sizes):
        for peer, t in sends.items():
            # a queued message must own its bytes: the sender may reuse
            # its tensor
            self.hub.queues[(self.rank, peer)].put(t.clone())
        out = {}
        for peer, n in sizes.items():
            try:
                out[peer] = self.hub.queues[(peer, self.rank)].get(
                    timeout=DEFAULT_TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(
                    f"process {self.rank}: no message from {peer}") from None
            if out[peer].numel() != n:
                raise ValueError(f"process {self.rank}: {out[peer].numel()} "
                                 f"bytes from {peer}, expected {n}")
        return out

    def close(self) -> None:
        pass


# -- the ipc link: a hop device to device ------------------------------------

SLOT_BYTES = 1 << 20  # a slot's first capacity; a pair's grows by doubling
# the control plane's channels: a (source, destination, tag) channel keeps
# its order
TAG_TOKEN, TAG_ACK, TAG_HANDLE = 1, 2, 3


class GlooControl:
    """The ipc link's control plane across OS processes: small CPU tensors
    point to point on the default group (gloo), object all-gather and
    barrier."""

    def all_gather(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def isend(self, t: torch.Tensor, peer: int, tag: int):
        import torch.distributed as dist

        return dist.isend(t, peer, tag=tag)

    def irecv(self, t: torch.Tensor, peer: int, tag: int):
        import torch.distributed as dist

        return dist.irecv(t, peer, tag=tag)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()


class _ThreadPlane:
    """The control plane of `size` ranks that are threads of one process:
    a queue a channel, a barrier, a slot a rank for the all-gather."""

    def __init__(self, size: int):
        self.channels = {(s, d, tag): queue.Queue() for s in range(size)
                         for d in range(size)
                         for tag in (TAG_TOKEN, TAG_ACK, TAG_HANDLE)}
        self.gate = threading.Barrier(size, timeout=DEFAULT_TIMEOUT_S)
        self.slots = [None] * size


class _Posted:
    def wait(self) -> None:
        pass


class _Pending:
    """A receive on a thread channel: matched when it is waited on (the
    link waits a channel's receives in the order it posts them)."""

    def __init__(self, channel: queue.Queue, t: torch.Tensor):
        self.channel = channel
        self.t = t

    def wait(self) -> None:
        try:
            self.t.copy_(self.channel.get(timeout=DEFAULT_TIMEOUT_S))
        except queue.Empty:
            raise TimeoutError("link='ipc': no control message") from None


class ThreadControl:
    """GlooControl's counterpart for ranks that are threads of one
    process (IpcHub)."""

    def __init__(self, plane: _ThreadPlane, rank: int):
        self.plane = plane
        self.rank = rank

    def all_gather(self, obj) -> list:
        self.plane.slots[self.rank] = obj
        self.plane.gate.wait()
        out = list(self.plane.slots)
        self.plane.gate.wait()  # every rank has read before a next round
        return out

    def isend(self, t, peer, tag):
        self.plane.channels[(self.rank, peer, tag)].put(t.clone())
        return _Posted()

    def irecv(self, t, peer, tag):
        return _Pending(self.plane.channels[(peer, self.rank, tag)], t)

    def barrier(self) -> None:
        self.plane.gate.wait()


class _Mailbox:
    """A source peer's two slots of `cap` bytes in one region: a pair's
    hops take them alternately, by the pair's own hop count (the bodies
    are SPMD, so both ends count the same)."""

    def __init__(self, region, cap: int):
        self.region = region
        self.cap = cap

    def offset(self, seq: int) -> int:
        return (seq % 2) * self.cap


def _capacity(n: int, cap: int) -> int:
    while cap < n:
        cap *= 2
    return cap


class IpcLink:
    """Point-to-point byte messages written device to device: the sender
    copies a message into its slot of the receiver's region, which it has
    mapped (device/ipc_arena.py), and the host sends only control
    messages over `control` (GlooControl across OS processes): an 8-byte
    token a message, an acknowledgement, and a region's new handle when a
    pair's slots grow. A hop, each pair:

      1. the sender copies the message into slot seq % 2 of the peer's
         region, one device copy on its stream, and records its `filled`
         event;
      2. only then it sends the token (seq): an interprocess event waited
         on before its record is issued waits on nothing;
      3. the receiver waits for the token, makes its stream wait on the
         sender's event, copies the slot out into a tensor of its own (a
         returned tensor never aliases a mailbox), records its `drained`
         event and acknowledges;
      4. the sender rewrites that slot two hops later, only after that
         acknowledgement and a wait on the receiver's `drained` event
         (write-after-read).

    Both ends know every message's size from the specs, so a receiver
    whose slot is too small exports a region twice the size (or more) and
    sends its handle first, inside the same hop: never a collective, since
    a hop addresses only some processes. A message of zero bytes sends
    nothing. Two processes on one card time-slice without MPS, so nothing
    spins on the device for another process's flag: the host signals. A
    pair inside one process never reaches a link (ProcessWorld.route moves
    it as rows; cudaIpcOpenMemHandle cannot open a process's own
    handle)."""

    through_host = False

    def __init__(self, control, rank: int, size: int, device,
                 slot_bytes: int = SLOT_BYTES):
        from .ipc_arena import arena_for

        self.control = control
        self.rank = rank
        self.device = torch.device(device)
        self.arena = arena = arena_for(self.device)
        peers = [q for q in range(size) if q != rank]
        self.rx: dict[int, _Mailbox] = {}   # q's slots in this region
        self.tx: dict[int, _Mailbox] = {}   # this process's slots at q
        self.filled: dict[int, tuple] = {}  # (event, handle): wrote to q
        self.drained: dict[int, tuple] = {}  # read q's slot
        self.peer_filled: dict[int, int] = {}
        self.peer_drained: dict[int, int] = {}
        self.retired: list = []  # regions growth replaced; freed at close
        self.unsettled: dict[int, object] = {}  # grown, not yet mapped
        self.sent_seq = dict.fromkeys(peers, 0)
        self.recv_seq = dict.fromkeys(peers, 0)
        self.acks = {q: collections.deque() for q in peers}
        self.closed = False
        try:
            for q in peers:
                self.rx[q] = _Mailbox(arena.alloc(2 * slot_bytes),
                                      slot_bytes)
                self.filled[q] = arena.event()
                self.drained[q] = arena.event()
            everyone = control.all_gather({
                "identity": arena.identity(),
                "rx": {q: mb.region.handle for q, mb in self.rx.items()},
                "filled": {q: h for q, (_, h) in self.filled.items()},
                "drained": {q: h for q, (_, h) in self.drained.items()}})
            self._check([e["identity"] for e in everyone])
            for q in peers:
                theirs = everyone[q]
                self.tx[q] = _Mailbox(arena.open(theirs["rx"][rank],
                                                 2 * slot_bytes), slot_bytes)
                self.peer_filled[q] = arena.open_event(theirs["filled"][rank])
                self.peer_drained[q] = arena.open_event(
                    theirs["drained"][rank])
            control.barrier()  # every region is mapped by its peer
        except BaseException:
            self._release(barrier=False)
            raise
        for mb in self.rx.values():
            arena.settle(mb.region)

    def _check(self, identities: list[dict]) -> None:
        """Every process on this host, on this device type: else raise."""
        mine = identities[self.rank]
        for q, other in enumerate(identities):
            if (other["host"], other["device"]) != (mine["host"],
                                                    mine["device"]):
                raise RuntimeError(
                    f"link='ipc' maps device memory between processes of "
                    f"one host on one device type: process {self.rank} is "
                    f"{mine['device']} on {mine['host']}, process {q} "
                    f"{other['device']} on {other['host']}; use "
                    f"link='gloo'")

    def exchange(self, sends: dict[int, torch.Tensor],
                 sizes: dict[int, int]) -> dict[int, torch.Tensor]:
        arena, control = self.arena, self.control
        sends = {q: t for q, t in sends.items() if t.numel()}
        posted = []  # (tensor, work): sends waited at the end of the hop
        # growth: the receiver's new handle goes first
        for q, n in sizes.items():
            if n > self.rx[q].cap:
                cap = _capacity(n, self.rx[q].cap)
                self.retired.append(self.rx[q].region)
                self.rx[q] = _Mailbox(arena.alloc(2 * cap), cap)
                self.unsettled[q] = self.rx[q].region
                msg = torch.frombuffer(bytearray(self.rx[q].region.handle),
                                       dtype=torch.uint8)
                posted.append((msg, control.isend(msg, q, TAG_HANDLE)))
        handles = {}
        for q, msg in sends.items():
            if msg.numel() > self.tx[q].cap:
                buf = torch.empty(arena.handle_bytes, dtype=torch.uint8)
                handles[q] = (buf, control.irecv(buf, q, TAG_HANDLE))
        tokens = {}
        for q, n in sizes.items():
            if n:
                buf = torch.empty(1, dtype=torch.int64)
                tokens[q] = (buf, control.irecv(buf, q, TAG_TOKEN))
        # each message into its slot of the peer's region
        for q, msg in sends.items():
            if q in handles:
                buf, work = handles[q]
                work.wait()
                cap = _capacity(msg.numel(), self.tx[q].cap)
                self.retired.append(self.tx[q].region)
                self.tx[q] = _Mailbox(
                    arena.open(buf.numpy().tobytes(), 2 * cap), cap)
            seq = self.sent_seq[q]
            while self.acks[q] and self.acks[q][0][0] <= seq - 2:
                done, ack, work = self.acks[q].popleft()
                work.wait()
                if int(ack) != done:
                    raise RuntimeError(f"link='ipc': process {self.rank} "
                                       f"got ack {int(ack)} from {q}, "
                                       f"expected {done}")
            if seq >= 2:  # the peer's read of this slot is done
                arena.wait(self.peer_drained[q])
            mb = self.tx[q]
            arena.write(mb.region, mb.offset(seq), msg)
            arena.record(self.filled[q][0])
            token = torch.tensor([seq], dtype=torch.int64)  # after the record
            posted.append((token, control.isend(token, q, TAG_TOKEN)))
            ack = torch.empty(1, dtype=torch.int64)
            self.acks[q].append((seq, ack, control.irecv(ack, q, TAG_ACK)))
            self.sent_seq[q] = seq + 1
        # each source's message out of its slot
        out = {}
        for q, n in sizes.items():
            if not n:
                out[q] = torch.empty(0, dtype=torch.uint8, device=self.device)
                continue
            buf, work = tokens[q]
            work.wait()
            seq = self.recv_seq[q]
            if int(buf) != seq:
                raise RuntimeError(f"link='ipc': process {self.rank} got "
                                   f"token {int(buf)} from {q}, expected "
                                   f"{seq}")
            if q in self.unsettled:  # q wrote into it, so q has mapped it
                arena.settle(self.unsettled.pop(q))
            arena.wait(self.peer_filled[q])
            mb = self.rx[q]
            out[q] = arena.read(mb.region, mb.offset(seq), n)
            arena.record(self.drained[q][0])
            ack = torch.tensor([seq], dtype=torch.int64)
            posted.append((ack, control.isend(ack, q, TAG_ACK)))
            self.recv_seq[q] = seq + 1
        for _, work in posted:
            work.wait()
        return out

    def close(self) -> None:
        """A barrier first (every copy into a peer's region done), then
        unmap, then free."""
        if self.closed:
            return
        for acks in self.acks.values():
            while acks:
                acks.popleft()[2].wait()
        self.arena.synchronize()
        self.control.barrier()
        self._release(barrier=True)

    def _release(self, barrier: bool) -> None:
        self.closed = True
        arena = self.arena
        for region in [mb.region for mb in self.tx.values()] + [
                r for r in self.retired if not r.owned]:
            arena.release(region)
        for ev in (*self.peer_filled.values(), *self.peer_drained.values()):
            arena.drop_event(ev)
        if barrier:  # no peer maps this process's regions any more
            self.control.barrier()
        for region in [mb.region for mb in self.rx.values()] + [
                r for r in self.retired if r.owned]:
            arena.release(region)
        for ev, _ in (*self.filled.values(), *self.drained.values()):
            if ev is not None:
                arena.drop_event(ev)
        self.tx, self.rx, self.retired = {}, {}, []
        self.peer_filled, self.peer_drained = {}, {}
        self.filled, self.drained = {}, {}


class IpcHub:
    """`size` transports in one process, one thread each, over the ipc
    link's CPU form: regions are shared file mappings, the control plane
    a queue a channel (CUDA IPC cannot map a region of its own process).
    Each thread calls transport(rank) itself: the link's connect waits
    for every rank."""

    def __init__(self, size: int, slot_bytes: int = SLOT_BYTES):
        self.size = size
        self.slot_bytes = slot_bytes
        self.plane = _ThreadPlane(size)

    def control(self, rank: int) -> ThreadControl:
        return ThreadControl(self.plane, rank)

    def transport(self, rank: int) -> "DCNTransport":
        return DCNTransport(rank, self.size, IpcLink(
            self.control(rank), rank, self.size, "cpu", self.slot_bytes))


def _nbytes(spec) -> int:
    return sum(math.prod(shape) * dtype.itemsize for shape, dtype in spec)


class DCNTransport:
    """This process's end of the cross-process tier: rank `rank` of `size`
    processes over `link`. Tallies, per tier name and since the last
    `reset_tally`: `sent`, the bytes this process put on the wire;
    `messages`, how many messages it sent; `hops`, the payload bytes a
    line carries in each hop the tier's bodies issued, whether or not this
    process took part in it (what the reference's CountingWire counts on
    one rank of a line); `staged`, the bytes of `sent` its link moved
    through host memory (all of them under gloo, none under ipc). Control
    messages (the ipc link's tokens and acknowledgements) are not
    tallied."""

    def __init__(self, rank: int, size: int, link, owns_group: bool = False):
        self.rank = rank
        self.size = size
        self.link = link
        self.owns_group = owns_group  # close() ends the default group
        self.reset_tally()

    @classmethod
    def connect(cls, num_processes: int, process_id: int,
                coordinator_address: str | None, link: str | None = None,
                device="cpu") -> "DCNTransport":
        """Join (or reuse) the default group and bring `link` up on it:
        "ipc" on cuda and "gloo" on the CPU unless named. An ipc link
        that cannot run raises; it never falls back to gloo."""
        name = link_name(link, device)
        created = connect(num_processes, process_id, coordinator_address)
        try:
            if name == "ipc":
                made = IpcLink(GlooControl(), process_id, num_processes,
                               device)
            else:
                made = GlooLink(device)
        except BaseException:
            if created:
                import torch.distributed as dist

                dist.destroy_process_group()
            raise
        return cls(process_id, num_processes, made, owns_group=created)

    def reset_tally(self) -> None:
        self.sent: dict[str, int] = {}
        self.messages: dict[str, int] = {}
        self.hops: dict[str, int] = {}
        self.staged: dict[str, int] = {}

    def tally(self) -> dict:
        return {"sent": dict(self.sent), "messages": dict(self.messages),
                "hops": dict(self.hops), "staged": dict(self.staged)}

    def count_hop(self, tier: str, line_bytes: int) -> None:
        self.hops[tier] = self.hops.get(tier, 0) + line_bytes

    def exchange(self, tier: str, sends: dict[int, list[torch.Tensor]],
                 recvs: dict[int, list[tuple]], device) -> dict:
        """One hop: send each peer its tensors as one byte message on
        `device`, receive each source's message laid out as its spec
        [(shape, dtype), ...] and return its tensors on `device`. The
        link owns what it keeps of a message (the sender may reuse its
        tensors) and returns tensors of the receiver's own."""
        msgs = {}
        for peer, parts in sends.items():
            flat = [p.contiguous().reshape(-1).view(torch.uint8)
                    for p in parts]
            msgs[peer] = msg = flat[0] if len(flat) == 1 else torch.cat(flat)
            self.sent[tier] = self.sent.get(tier, 0) + msg.numel()
            self.messages[tier] = self.messages.get(tier, 0) + 1
            if self.link.through_host:
                self.staged[tier] = self.staged.get(tier, 0) + msg.numel()
        got = self.link.exchange(msgs, {peer: _nbytes(spec)
                                        for peer, spec in recvs.items()})
        out = {}
        for peer, spec in recvs.items():
            buf = got[peer]
            parts, off = [], 0
            for shape, dtype in spec:
                nb = math.prod(shape) * dtype.itemsize
                piece = buf[off:off + nb]
                if off % dtype.itemsize:
                    piece = piece.clone()
                parts.append(piece.view(dtype).reshape(shape))
                off += nb
            out[peer] = parts
        return out

    def close(self) -> None:
        self.link.close()
        if self.owns_group and distributed_active():
            import torch.distributed as dist

            dist.destroy_process_group()


# -- what a hop carries ------------------------------------------------------


def _moved(wire: schedules.Wire, x: torch.Tensor) -> list[torch.Tensor]:
    """The sender's half of Wire.transfer: the rows on the exact wire, the
    compressed rows on a cast wire, the int8 wire message."""
    if wire.quantized:
        return [quantize_wire(x)]
    return [wire.send(x)]


def _moved_spec(wire: schedules.Wire, x: torch.Tensor) -> list[tuple]:
    shape = tuple(x.shape)
    if wire.quantized:
        n = shape[-1]
        return [(shape[:-1] + (n + 4 * quant_num_blocks(n),), torch.int8)]
    wd = wire_dtype(wire.cfg) if wire.cfg is not None else None
    return [(shape, wd or x.dtype)]


def _arrived(wire: schedules.Wire, parts, like: torch.Tensor) -> torch.Tensor:
    """The receiver's half of Wire.transfer, to `like`'s shape and dtype."""
    if wire.quantized:
        return dequantize_wire(parts[0], like.shape[-1], like.dtype)
    return wire.recv(parts[0], like.dtype)


def _enc_spec(x: torch.Tensor) -> list[tuple]:
    """The (codes, scales) pair of x's rows."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    return [(lead + (n,), torch.int8),
            (lead + (quant_num_blocks(n),), torch.float32)]


class ProcessTier:
    """The outer tier of the multi-process form: this process is position
    `procs.index(transport.rank)` on every ring of `len(procs)` positions
    (procs: the global process rank at each position), and the rows a
    step is given (its L ranks) are that ring's L lines. The steps are the
    StackedTier's, with the reference's per-rank bodies."""

    name = "outer"  # the tier the transport tallies its hops under

    def __init__(self, transport: DCNTransport, procs):
        self.transport = transport
        self.procs = tuple(procs)
        self.world = len(self.procs)
        self.me = self.procs.index(transport.rank)

    # -- the hop -------------------------------------------------------------

    def _hop(self, perm, make: Callable, spec, device):
        """One ppermute of the position pairs `perm`: this process sends
        make()'s tensors to each position it addresses and returns what
        its source sent (None when no pair addresses it). make() runs only
        on a sender."""
        self.transport.count_hop(self.name, sum(
            math.prod(shape[1:]) * dtype.itemsize for shape, dtype in spec))
        dsts = [d for s, d in perm if s == self.me and d != self.me]
        srcs = [s for s, d in perm if d == self.me and s != self.me]
        if not dsts and not srcs:
            return None
        parts = make() if dsts else None
        got = self.transport.exchange(
            self.name, {self.procs[d]: parts for d in dsts},
            {self.procs[s]: spec for s in srcs}, device)
        return got[self.procs[srcs[0]]] if srcs else None

    def ppermute(self, x, perm, wire):
        """Wire.ppermute across processes."""
        got = self._hop(perm, lambda: _moved(wire, x), _moved_spec(wire, x),
                        x.device)
        return torch.zeros_like(x) if got is None else _arrived(wire, got, x)

    def hop(self, enc, perm):
        """Wire.hop across processes: codes and scales in one message."""
        q, s = enc
        got = self._hop(perm, lambda: [q, s],
                        [(tuple(q.shape), q.dtype), (tuple(s.shape), s.dtype)],
                        q.device)
        if got is None:
            return torch.zeros_like(q), torch.zeros_like(s)
        return got[0], got[1]

    def _hop_reduce(self, acc, sent, sender: int, receiver: int, func, wire):
        """schedules._hop_reduce: `sent` hops from sender to receiver and is
        folded into the receiver's accumulator (the int8 arrival decoded
        and folded in one step)."""
        if not wire.quantized:
            got = self._hop([(sender, receiver)], lambda: _moved(wire, sent),
                            _moved_spec(wire, sent), acc.device)
            if self.me == receiver:
                acc = cast(wire.combine(func, acc,
                                        _arrived(wire, got, sent)),
                           acc.dtype)
            return acc
        got = self._hop([(sender, receiver)], lambda: list(wire.encode(sent)),
                        _enc_spec(sent), acc.device)
        if self.me == receiver:
            acc = wire.combine_decoded(func, (got[0], got[1]), acc)
        return acc

    @staticmethod
    def _chunk(x, k: int, c: int) -> torch.Tensor:
        return x[:, k * c:(k + 1) * c].contiguous()

    # -- the steps -----------------------------------------------------------

    def reduce_scatter(self, x, *, func, wire):
        """reduce_scatter_ring_schedule (:412) and its int8 form (:433)."""
        P, me = self.world, self.me
        c = x.shape[-1] // P
        perm = schedules._ring_perm(P)
        if wire.quantized:
            out = self._chunk(x, (me - 1) % P, c)
            if P == 1:
                return out
            enc = wire.encode(out)
            for s in range(P - 1):
                enc = self.hop(enc, perm)
                local = self._chunk(x, (me - 2 - s) % P, c)
                if s < P - 2:
                    enc = wire.combine_requant(func, enc, local)
                else:
                    out = wire.combine_decoded(func, enc, local)
            return out
        v = self._chunk(x, (me - 1) % P, c)
        for s in range(P - 1):
            recv = self.ppermute(v, perm, wire)
            v = wire.combine(func, recv, self._chunk(x, (me - 2 - s) % P, c))
        return v

    def allgather(self, x, *, wire):
        """allgather_ring_schedule (:320) and its int8 form (:339)."""
        P, me = self.world, self.me
        c = x.shape[-1]
        perm = schedules._ring_perm(P)
        out = x.new_zeros((x.shape[0], P, c))
        if wire.quantized:
            enc = wire.encode(x)
            out[:, me] = wire.decode(enc, c, x.dtype)
            for s in range(P - 1):
                enc = self.hop(enc, perm)
                out[:, (me - 1 - s) % P] = wire.decode(enc, c, x.dtype)
        else:
            out[:, me] = x
            relay = x
            for s in range(P - 1):
                recv = self.ppermute(relay, perm, wire)
                out[:, (me - 1 - s) % P] = recv
                relay = recv
        return out.reshape(x.shape[0], P * c)

    def allreduce(self, x, *, func, wire, seg_count: int):
        """allreduce_ring_schedule (:457): per segment, the ring
        reduce-scatter then the ring allgather."""
        P = self.world

        def one_segment(seg):
            padded = schedules._pad_to_multiple(seg, P)
            red = self.reduce_scatter(padded, func=func, wire=wire)
            return self.allgather(red, wire=wire)[:, :seg.shape[-1]]

        return schedules._segmented_apply(one_segment, x, seg_count)

    def bcast(self, x, *, root: int, wire):
        """bcast_flat_schedule (:208): one hop per destination."""
        out = x.clone()
        for j in range(self.world):
            if j == root:
                continue
            got = self._hop([(root, j)], lambda: _moved(wire, x),
                            _moved_spec(wire, x), x.device)
            if self.me == j:
                out = _arrived(wire, got, x)
        return out

    def scatter(self, x, *, root: int, wire):
        """scatter_schedule (:250): chunk j to position j."""
        c = x.shape[-1] // self.world
        out = self._chunk(x, root, c)
        for j in range(self.world):
            if j == root:
                continue
            chunk = x[:, j * c:(j + 1) * c]
            got = self._hop([(root, j)],
                            lambda: _moved(wire, chunk.contiguous()),
                            _moved_spec(wire, chunk), x.device)
            if self.me == j:
                out = _arrived(wire, got, chunk)
        return out

    def gather(self, x, *, root: int, wire):
        """gather_ring_schedule (:265): the daisy chain to root."""
        P = self.world
        c = x.shape[-1]
        out = x.new_zeros((x.shape[0], P, c))
        out[:, root] = x
        relay = x
        for s in range(P - 1):
            recv = self.ppermute(relay, schedules._ring_perm(P), wire)
            if self.me == root:
                out[:, (root - 1 - s) % P] = recv
            relay = recv
        return out.reshape(x.shape[0], P * c)

    def reduce(self, x, *, root: int, func, wire):
        """reduce_ring_schedule (:366): the partial relays from root+1."""
        acc = x.clone()
        for s in range(self.world - 1):
            sender = (root + 1 + s) % self.world
            acc = self._hop_reduce(acc, acc, sender, (sender + 1) % self.world,
                                   func, wire)
        return acc

    def reduce_flat(self, x, *, root: int, func, wire):
        """reduce_flat_schedule (:379): every position straight to root."""
        acc = x.clone()
        for j in range(self.world):
            if j != root:
                acc = self._hop_reduce(acc, x, j, root, func, wire)
        return acc

    def barrier(self, token, *, wire):
        """barrier_schedule (:716): the flat reduce to 0 and the flat
        bcast back."""
        gathered = self.reduce_flat(token, root=0, func=ReduceFunction.SUM,
                                    wire=wire)
        return self.bcast(gathered, root=0, wire=wire)

    def alltoall(self, x, *, wire):
        """alltoall_schedule (:595) and the block-aligned int8 exchange
        (:627): slot me+k to position me+k at step k; the local slot
        crosses no wire and stays exact."""
        P, me = self.world, self.me
        rows, c = x.shape[0], x.shape[-1] // P
        if wire.quantized and c % QUANT_BLOCK_ELEMS == 0:
            q, s = wire.encode(x.contiguous())
            nb = c // QUANT_BLOCK_ELEMS
            q_recv, s_recv = torch.zeros_like(q), torch.zeros_like(s)
            for k in range(1, P):
                dst, src = (me + k) % P, (me - k) % P
                got = self._hop(
                    schedules._ring_perm(P, k),
                    lambda: [self._chunk(q, dst, c), self._chunk(s, dst, nb)],
                    [((rows, c), torch.int8), ((rows, nb), torch.float32)],
                    x.device)
                q_recv[:, src * c:(src + 1) * c] = got[0]
                s_recv[:, src * nb:(src + 1) * nb] = got[1]
            out = wire.decode((q_recv, s_recv), P * c, x.dtype)
            out[:, me * c:(me + 1) * c] = x[:, me * c:(me + 1) * c]
            return out
        out = torch.zeros_like(x)
        out[:, me * c:(me + 1) * c] = x[:, me * c:(me + 1) * c]
        like = x[:, :c]
        for k in range(1, P):
            dst, src = (me + k) % P, (me - k) % P
            got = self._hop(schedules._ring_perm(P, k),
                            lambda: _moved(wire, self._chunk(x, dst, c)),
                            _moved_spec(wire, like), x.device)
            out[:, src * c:(src + 1) * c] = _arrived(wire, got, like)
        return out


class ProcessWorld:
    """The flat world of the multi-process form: the W = len(procs) * L
    ranks of a (sub)world, process-major (rank g lives at row g % L of
    process procs[g // L], RankMap(L, P, "outer_major")). This process
    holds the L consecutive ranks [first, first + L), its rows of every
    buffer (DCNBuffer.local). ProcessTier is one position with L lines;
    this is L consecutive positions on one line, and with L == 1 every
    hop leaves the process.

    Its wires (`wire`) run the stacked flat bodies of sequencer/schedules
    on this process's rows with their global ranks: a hop's pairs inside
    the process move as rows on the device, the pairs that cross go
    through DCNTransport.exchange as one byte message a peer process a
    hop, tallied under the tier name "flat"."""

    name = "flat"

    def __init__(self, transport: DCNTransport, procs, local: int):
        self.transport = transport
        self.procs = tuple(procs)
        self.L = local
        self.world = len(self.procs) * local
        self.first = self.procs.index(transport.rank) * local

    def wire(self, cfg=None, arith_lane: int | None = None) -> "ProcessWire":
        return ProcessWire(self, cfg, arith_lane)

    def held(self, rank: int) -> bool:
        return self.first <= rank < self.first + self.L

    def route(self, parts, src, dst, k: int, send: Callable,
              spec: Callable, recv: Callable):
        """One hop of rank pairs (src[i], dst[i]) over `parts` (tensors of
        this process's ranks, k consecutive rows a rank): send(rows) is
        the sender's half of the wire (the tensors a message carries for
        those rows), spec(n) the layout of a message of n rows, recv(msg)
        the receiver's half. A pair inside the process takes both halves
        on the device. Returns (at, landed): the row index of the ranks of
        dst this process holds, in dst's order, and their rows (each
        part's), or (_NOWHERE, None) when none lands here."""
        L, first = self.L, self.first
        sends: dict[int, list[int]] = {}
        recvs: dict[int, list[int]] = {}
        local_src, local_at = [], []
        land: list[int] = []
        for s, d in zip(src, dst):
            if self.held(d):
                if self.held(s):
                    local_src.append(s - first)
                    local_at.append(len(land))
                else:
                    recvs.setdefault(self.procs[s // L], []).append(len(land))
                land.append(d - first)
            elif self.held(s):
                sends.setdefault(self.procs[d // L], []).append(s - first)
        device = parts[0].device
        got = {}
        if sends or recvs:
            got = self.transport.exchange(
                self.name,
                {peer: send([p[_rows(ss, k, device)] for p in parts])
                 for peer, ss in sends.items()},
                {peer: spec(len(ls) * k) for peer, ls in recvs.items()},
                device)
        if not land:
            return schedules._NOWHERE, None
        groups = [(local_at, recv(send([p[_rows(local_src, k, device)]
                                        for p in parts])))] \
            if local_src else []
        groups += [(recvs[peer], recv(msg)) for peer, msg in got.items()]
        at = _rows(land, k, device)
        if len(groups) == 1 and groups[0][0] == list(range(len(land))):
            return at, groups[0][1]
        landed = [t.new_empty((len(land) * k, *t.shape[1:]))
                  for t in groups[0][1]]
        for where, ts in groups:
            i = _rows(where, k, device)
            for out, t in zip(landed, ts):
                out[i] = t
        return at, landed

    def swap(self, parts) -> list:
        """The slot exchange: each (tensor, dim) of `parts` holds this
        process's L rows (dim 0) of W slots along `dim`; slot s of rank r
        goes to slot r of rank s. One message a peer for all parts."""
        L, first = self.L, self.first
        me = first // L
        out = [torch.empty_like(t) for t, _ in parts]
        for o, (t, dim) in zip(out, parts):
            o.narrow(dim, first, L).copy_(
                t.narrow(dim, first, L).transpose(0, dim))
        peers = [q for q in range(len(self.procs)) if q != me]
        got = self.transport.exchange(
            self.name,
            {self.procs[q]: [t.narrow(dim, q * L, L) for t, dim in parts]
             for q in peers},
            {self.procs[q]: [(tuple(t.narrow(dim, first, L).shape), t.dtype)
                             for t, dim in parts] for q in peers},
            parts[0][0].device)
        for q in peers:
            for o, (_, dim), r in zip(out, parts, got[self.procs[q]]):
                o.narrow(dim, q * L, L).copy_(r.transpose(0, dim))
        return out


def _rows(ranks: list[int], k: int, device):
    """The row index of local ranks with k rows each: a slice when they
    are consecutive, else an index tensor."""
    if ranks == list(range(ranks[0], ranks[0] + len(ranks))):
        return slice(ranks[0] * k, (ranks[0] + len(ranks)) * k)
    return schedules._index([r * k + j for r in ranks for j in range(k)],
                            device)


def _specs(like: list[tuple]) -> Callable:
    """spec(n) of a message carrying n rows of tensors whose rows are laid
    out as `like` [(row shape, dtype), ...]."""
    return lambda n: [((n, *shape), dtype) for shape, dtype in like]


def _same(parts):
    return list(parts)


class ProcessWire(schedules.Wire):
    """schedules.Wire on a process's rows of the flat world: the stacked
    bodies' hops (ppermute, hop, exchange, swap, permute, move,
    move_encoded) carried by the ProcessWorld, every transform (cast,
    encode, decode, fold) the base Wire's on the device, so this
    process's rows are bitwise those of the stacked body over every
    rank. `k` rows a rank: the lockstep ring's segments."""

    lockstep = True

    def __init__(self, world: ProcessWorld, cfg=None,
                 arith_lane: int | None = None, k: int = 1):
        super().__init__(cfg, arith_lane)
        self.world = world
        self.first = world.first
        self.k = k

    def per_rank(self, k: int) -> "ProcessWire":
        return ProcessWire(self.world, self.cfg, self.arith_lane, k)

    def row(self, rank: int) -> int | None:
        return rank - self.first if self.world.held(rank) else None

    def local(self, ranks, device):
        mine = [r - self.first for r in ranks if self.world.held(r)]
        return _rows(mine, 1, device) if mine else schedules._NOWHERE

    def _halves(self, rows: torch.Tensor):
        """(send, spec, recv) of this wire's payload of rows like `rows`."""
        row_spec = [(shape[1:], dtype) for shape, dtype
                    in _moved_spec(self, rows[:1])]
        return (lambda ps: _moved(self, ps[0]), _specs(row_spec),
                lambda msg: [_arrived(self, msg, rows)])

    def move(self, x, src, dst, cols=None):
        part = x if cols is None else x[:, cols]
        at, landed = self.world.route([part], src, dst, self.k,
                                      *self._halves(part))
        return at, (part[:0] if landed is None else landed[0])

    def move_encoded(self, x, src, dst):
        at, landed = self.world.route(
            [x], src, dst, self.k, lambda ps: list(self.encode(ps[0])),
            _specs([(shape[1:], dtype) for shape, dtype in _enc_spec(x[:1])]),
            _same)
        return at, (None if landed is None else tuple(landed))

    def _permuted(self, parts, perm, send, spec, recv):
        """Rows no pair addresses receive zeros, as under ppermute."""
        src, dst = zip(*perm) if perm else ((), ())
        at, landed = self.world.route(parts, src, dst, self.k, send, spec,
                                      recv)
        if landed is None:
            return [torch.zeros_like(p) for p in parts]
        if isinstance(at, slice) and at == slice(0, parts[0].shape[0]):
            return landed  # every row received
        outs = [torch.zeros_like(p) for p in parts]
        for out, t in zip(outs, landed):
            out[at] = t
        return outs

    def ppermute(self, x, perm):
        return self._permuted([x], perm, *self._halves(x))[0]

    def permute(self, x, perm):
        return self._permuted([x], perm, _same,
                              _specs([(tuple(x.shape[1:]), x.dtype)]),
                              _same)[0]

    def hop(self, enc, perm):
        q, s = enc
        return tuple(self._permuted(
            [q, s], perm, _same,
            _specs([(tuple(q.shape[1:]), q.dtype),
                    (tuple(s.shape[1:]), s.dtype)]), _same))

    def exchange(self, enc, world: int):
        """The block-aligned int8 exchange: each rank's W slots of codes
        and scales (x's layout), one message a peer for both."""
        views = [t.reshape(*t.shape[:-1], world, t.shape[-1] // world)
                 for t in enc]
        out = self.world.swap([(v, v.dim() - 2) for v in views])
        return tuple(o.reshape(t.shape) for o, t in zip(out, enc))

    def swap(self, grid):
        return self.world.swap([(grid, 1)])[0]
