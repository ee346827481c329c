"""Multi-process DCN runner: one OS process per "host".

Counterpart of tools/run_dcn.py. Each process joins the default
torch.distributed group over gloo, builds its DCNDevice (local_devices
virtual ranks, global rank = proc * local + l; one or more) and drives
facade collectives whose hops cross the process boundary; beside it, the
in-process DCNDevice over the same (procs, local) world on the same
seeded rows runs every call too, and the process's own rows must equal
its rows bitwise. With local_devices > 1 the collectives that have one
lower to the two-tier compositions; with one rank a host every call runs
the flat body over the combined world, every hop across processes.

The stages (--stages picks some, in this order; each runs on every wire
of --wires, exact, float16 with fp32 arithmetic, int8): the allreduce
(and, on the exact wire, the int8 allreduce as "allreduce-int8"), bcast
from rank world-1, allgather, reduce_scatter, alltoall, scatter, gather
and reduce to rank world-1 ("scatter-gather-reduce"), p2p 1 -> world-1,
host 0's sub-communicator ("subcomm"), optionally the first K hosts'
(--subset-hosts K), and a barrier. --sequence adds a recorded batch on
the world communicator (allreduce -> allgather -> bcast, on the exact and
the int8 wire), a streamed allreduce (a stream producer makes the
operand) and a stream_put, each held bitwise against the in-process
device.

A hop crosses processes on --link: "ipc" (the default with --device cuda)
writes it device to device into a region the peer mapped (CUDA IPC on
the card, a /dev/shm mapping on the CPU), "gloo" (the default with
--device cpu) stages it through the host.

Usage (2 processes x 4 virtual ranks on the CPU; --local-devices 1 for
one rank a host):
    python -m accl_tpu_torch.tools.run_dcn --procs 2 --proc-id 0 \\
        --port 9911 --device cpu &
    python -m accl_tpu_torch.tools.run_dcn --procs 2 --proc-id 1 \\
        --port 9911 --device cpu

Prints one "RANKS [...] proc i/N OK" line per process on success (exit
0); a "dcn_bytes" JSON line (the bytes and messages this process sent
across the process boundary in one exact allreduce, by tier: "outer" for
the two-tier composition, beside its count of the bytes a line carries,
"flat" for the flat ring at one rank a host, beside flat_allreduce_bytes;
each must equal its count; and the bytes the link staged through the
host); with --sequence a "dcn_sequence" JSON line (the flat bytes and
messages of a recorded one-step allreduce batch); with --time COUNTS a
"dcn_time" JSON line (host-clock median ms of the allreduce at each
count, from device to device with the device synchronised, and its
bytes; the last run's rows are held against the in-process device's;
with --time-links ipc,gloo the same operands on a device of each link in
alternating pairs, each link's median and range, their rows bitwise
equal); with --hop-time SIZES a "dcn_hop" JSON line (each link's µs a
hop between processes 0 and 1 at each size, from one device to the
other: half a round trip); last a "dcn_launches" line (each kernel
wrapper's launches over the multi-process facade's checked calls, by
stage).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


TIME_REPS = 5
HOP_REPS = 50
STAGES = ("allreduce", "bcast", "allgather", "reduce_scatter", "alltoall",
          "scatter-gather-reduce", "p2p", "subcomm")


def outer_allreduce_bytes(count: int, procs: int, local: int,
                          itemsize: int = 4) -> int:
    """Bytes a line carries in the outer hops of one exact two-tier
    allreduce: the ring reduce-scatter and allgather of the 1/L shard,
    2 * (P - 1) hops of ceil(ceil(count / L) / P) elements."""
    shard = -(-count // local)
    return 2 * (procs - 1) * -(-shard // procs) * itemsize


def flat_allreduce_bytes(count: int, world: int, seg_count: int,
                         itemsize: int = 4) -> int:
    """Bytes one process sends in one flat segmented ring allreduce over
    the combined world (P > 1): each ring hop crosses every process
    boundary once, so a process sends one chunk of every segment a step,
    sum over segments of 2 * (W - 1) * ceil(s / W) elements."""
    full, tail = divmod(count, seg_count)
    chunks = full * -(-seg_count // world) + -(-tail // world)
    return 2 * (world - 1) * chunks * itemsize


def flat_allreduce_messages(count: int, world: int, seg_count: int) -> int:
    """Messages one process sends in that allreduce: its whole segments
    move in lockstep, one message to the next host a ring step for all of
    them, and a ragged last segment takes its own."""
    return 2 * (world - 1) * ((count >= seg_count)
                              + (count % seg_count != 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--count", type=int, default=96)
    ap.add_argument("--wires", default="exact",
                    help="comma-separated wires every stage runs on: "
                         "exact, float16 (fp32 arithmetic), int8")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages to run (default: all)")
    ap.add_argument("--subset-hosts", type=int, default=0,
                    help="also run an allreduce on a sub-communicator of "
                         "the first K hosts (0 = skip)")
    ap.add_argument("--sequence", action="store_true",
                    help="also record call sequences and drive a stream "
                         "producer and stream_put")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--link", choices=("ipc", "gloo"), default=None,
                    help="the cross-process link (default: ipc on cuda, "
                         "gloo on the CPU)")
    ap.add_argument("--time", default="",
                    help="comma-separated per-rank counts whose allreduce "
                         "is timed (host clock, median of 5 after a "
                         "warm-up)")
    ap.add_argument("--time-links", default="",
                    help="comma-separated links the --time and --hop-time "
                         "stages run on in alternating pairs, e.g. "
                         "ipc,gloo (default: --link's)")
    ap.add_argument("--hop-time", default="",
                    help="comma-separated message sizes in bytes whose "
                         "round trip between processes 0 and 1 is timed on "
                         "each link alone, with no body (host clock, 50 "
                         "round trips after a warm-up one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, DataType, ReduceFunction
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
    from accl_tpu_torch.constants import StreamFlags
    from accl_tpu_torch.device.dcn_device import DCNDevice
    from accl_tpu_torch.device.dcn_transport import link_name
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.sequencer.plan import eager_seg_count

    P, L, me = args.procs, args.local_devices, args.proc_id
    wires = [w for w in args.wires.split(",") if w]
    stages = set(s for s in args.stages.split(",") if s)
    if args.device == "cpu":
        # the hosts share this machine's cores: one share each, not all
        # of them spinning in every process
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
    # fp32 arithmetic on the fp16 wire (a hop casts to fp16 and back,
    # every fold is fp32); the other rows are the default table's
    table = dict(DEFAULT_ARITH_CONFIG)
    table[(DataType.float32, DataType.float16)] = ArithConfig(
        4, 2, 0, 0, 1, False, (0, 5))
    link = link_name(args.link, args.device)
    time_links = [link_name(k, args.device) for k in
                  args.time_links.split(",") if k] or [link]
    if link not in time_links:
        raise SystemExit(f"--time-links {args.time_links} leaves out "
                         f"--link {link}")

    def device(on):
        return DCNDevice(num_processes=P, process_id=me,
                         coordinator_address=f"127.0.0.1:{args.port}",
                         local_device_count=L, torch_device=args.device,
                         link=on)

    dev = device(link)
    a = ACCL(device=dev, arith_config=table)
    # the other links the --time stage compares, each a device of its own
    # over the same process group (every process builds them in order)
    timed = {link: a}
    for other in time_links:
        if other not in timed:
            timed[other] = ACCL(device=device(other), arith_config=table)
    twin = ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": L}, world=P * L, device=args.device)),
        arith_config=table)
    for f in (*timed.values(), twin):
        f.cclo.compiler.arith_table = table  # the lowering reads its own
    world, n = a.world, args.count
    rows = dev.local_rows()
    rng = np.random.default_rng(17)  # same data on every process
    x = rng.standard_normal((world, n)).astype(np.float32)

    # every kernel wrapper's launch count, read around the multi-process
    # facade's calls only (the in-process twin's are not counted)
    from accl_tpu_torch.ops import lane_kernels, quant_kernels, ring_allreduce

    kernels = {name: getattr(mod, name) for mod, names in (
        (ring_allreduce, ("ring_allreduce_bidir", "ring_allreduce")),
        (quant_kernels, ("quantize", "dequantize", "dequant_combine",
                         "dequant_combine_requant", "quant_ring_allreduce")),
        (lane_kernels, ("combine", "combine_cast", "cast"))) for name in names}
    launches: dict[str, dict[str, int]] = {}
    current = ["start"]

    def stage(name):
        current[0] = name
        print(f"[p{me}] {name}", flush=True)

    def agree(mine, want):
        if not torch.equal(mine[rows].cpu().view(torch.int32),
                           want[rows].cpu().view(torch.int32)):
            raise AssertionError(f"[p{me}] rows {rows} differ from the "
                                 "in-process device's")

    def both(call, *shapes):
        """Run `call` on the multi-process facade and on its in-process
        twin over buffers made from `shapes` ((count, data) pairs); this
        process's rows of every buffer must agree bitwise."""
        outs = []
        for f in (a, twin):
            bufs = [f.create_buffer(c, data=d) for c, d in shapes]
            before = {k: w.launches for k, w in kernels.items()}
            call(f, *bufs)
            if f is a:
                moved = launches.setdefault(current[0], {})
                for k, w in kernels.items():
                    if w.launches != before[k]:
                        moved[k] = moved.get(k, 0) + w.launches - before[k]
            outs.append([b.host for b in bufs])
            for b in bufs:
                f.free_buffer(b)
        for mine, want in zip(*outs):
            agree(mine, want)
        return [t.numpy() for t in outs[0]]

    seg = eager_seg_count(n, 4, dev.eager_rx_buf_size,
                          StreamFlags.NO_STREAM, world_align=world)
    root = world - 1  # on the last process: every process issues the
    c = n // world    # same call, so the root is the same global rank
    for wire in wires:
        dt = {"exact": None, "float16": DataType.float16,
              "int8": DataType.int8}[wire]
        kw = {} if dt is None else dict(compress_dtype=dt)
        tag = "" if dt is None else f" ({wire})"

        def close(got, want):
            if dt is None:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:  # a lossy wire: within its bound
                bound = world * np.abs(x).sum(0).max() / (
                    127 if wire == "int8" else 1024)
                assert np.abs(got - want).max() <= bound

        if "allreduce" in stages:
            stage("allreduce" + tag)
            dev.transport.reset_tally()
            _, rb = both(lambda f, s, r: f.allreduce(
                s, r, n, ReduceFunction.SUM, **kw), (n, x), (n, None))
            tally = dev.transport.tally()
            for r in rows:
                close(rb[r], x.sum(0))
            if dt is None:
                # the composition's outer hops at L > 1, the flat ring's
                # hops at one rank a host
                want = outer_allreduce_bytes(n, P, L) if L > 1 else 0
                flat = (0, 0) if L > 1 else (
                    flat_allreduce_bytes(n, world, seg),
                    flat_allreduce_messages(n, world, seg))
                got = {"sent": tally["sent"].get("outer", 0),
                       "messages": tally["messages"].get("outer", 0),
                       "line_hop_bytes": tally["hops"].get("outer", 0),
                       "composition_line_bytes": want,
                       "flat_sent": tally["sent"].get("flat", 0),
                       "flat_messages": tally["messages"].get("flat", 0),
                       "flat_bytes": flat[0], "flat_want_messages": flat[1],
                       "staged": tally["staged"].get("outer", 0),
                       "flat_staged": tally["staged"].get("flat", 0)}
                print(json.dumps({"dcn_bytes": {
                    "proc": me, "procs": P, "local": L, "count": n,
                    "seg_count": seg, "link": link, **got}}), flush=True)
                if (got["line_hop_bytes"], got["sent"]) != (want, L * want) \
                        or (got["flat_sent"], got["flat_messages"]) != flat:
                    raise AssertionError(f"[p{me}] allreduce sent {tally}, "
                                         f"want {want} a line, flat {flat}")
                stage("allreduce-int8")
                _, qb = both(lambda f, s, r: f.allreduce(
                    s, r, n, ReduceFunction.SUM,
                    compress_dtype=DataType.int8), (n, x), (n, None))
                for r in rows:
                    bound = P * L * np.abs(x).sum(0).max() / 127
                    assert np.abs(qb[r] - x.sum(0)).max() <= bound

        if "bcast" in stages:
            stage("bcast" + tag)
            (bb,) = both(lambda f, b: f.bcast(b, n, root, **kw), (n, x))
            for r in rows:
                close(bb[r], x[root])

        if "allgather" in stages:
            stage("allgather" + tag)
            _, gb = both(lambda f, s, r: f.allgather(s, r, c, **kw),
                         (c, x[:, :c]), (c * world, None))
            for r in rows:
                close(gb[r], x[:, :c].reshape(-1))

        if "reduce_scatter" in stages:
            stage("reduce_scatter" + tag)
            _, sr = both(lambda f, s, r: f.reduce_scatter(
                s, r, c, ReduceFunction.SUM, **kw),
                (c * world, x[:, :c * world]), (c, None))
            full = x[:, :c * world].sum(0)
            for r in rows:
                close(sr[r], full[r * c:(r + 1) * c])

        if "alltoall" in stages:
            stage("alltoall" + tag)
            ts = x[:, :world * 8]
            _, tr = both(lambda f, s, r: f.alltoall(s, r, 8, **kw),
                         (world * 8, ts), (world * 8, None))
            exp = ts.reshape(world, world, 8).transpose(1, 0, 2)
            for r in rows:
                close(tr[r], exp[r].reshape(-1))

        if "scatter-gather-reduce" in stages:
            stage("scatter-gather-reduce" + tag)
            _, scb = both(lambda f, s, r: f.scatter(s, r, c, root, **kw),
                          (c * world, x[:, :c * world]), (c, None))
            for r in rows:
                close(scb[r], x[root, r * c:(r + 1) * c])
            _, gab = both(lambda f, s, r: f.gather(s, r, c, root, **kw),
                          (c, x[:, :c]), (c * world, None))
            _, rdb = both(lambda f, s, r: f.reduce(
                s, r, n, root, ReduceFunction.SUM, **kw), (n, x), (n, None))
            if root in rows:
                close(gab[root], x[:, :c].reshape(-1))
                close(rdb[root], x.sum(0))

        if "p2p" in stages:
            stage("p2p" + tag)
            src, dst = 1 % world, world - 1  # crosses the process boundary

            def p2p(f, s, r):
                f.send(s, 16, src=src, dst=dst, tag=5, **kw)
                f.recv(r, 16, src=src, dst=dst, tag=5, **kw)

            _, pv = both(p2p, (n, x), (16, None))
            if dst in rows:
                close(pv[dst], x[src, :16])

        # an outer-aligned sub-communicator: host 0's whole inner group.
        # Every process issues the same call; non-member hosts no-op it.
        if "subcomm" in stages:
            stage("subcomm" + tag)

            def host0(f, s, r):
                f.allreduce(s, r, 24, ReduceFunction.SUM,
                            comm=f.split(list(range(L))), **kw)

            _, cr = both(host0, (24, x[:, :24]), (24, None))
            for r in rows:
                if me == 0:
                    close(cr[r], x[:L, :24].sum(0))
                else:
                    assert not cr[r].any()

        if args.subset_hosts:
            # the first K whole hosts: member hosts run the allreduce on
            # the (K, L) sub-world, the rest no-op it
            k = args.subset_hosts
            stage(f"subset-{k}-hosts" + tag)

            def subset(f, s, r):
                f.allreduce(s, r, 16, ReduceFunction.SUM,
                            comm=f.split(list(range(k * L))), **kw)

            _, kr = both(subset, (16, x[:, :16]), (16, None))
            for r in rows:
                if me < k:
                    close(kr[r], x[:k * L, :16].sum(0))
                else:
                    assert not kr[r].any()

    if args.sequence:
        stage("sequence")
        # a one-step exact batch: its flat body's bytes and messages
        dev.transport.reset_tally()

        def one_step(f, s, r):
            seq = f.sequence()
            seq.allreduce(s, r, n, ReduceFunction.SUM)
            seq.compile().run()

        _, ob = both(one_step, (n, x), (n, None))
        tally = dev.transport.tally()
        got = {"sent": tally["sent"].get("flat", 0),
               "messages": tally["messages"].get("flat", 0)}
        want = {"sent": flat_allreduce_bytes(n, world, seg),
                "messages": flat_allreduce_messages(n, world, seg)}
        print(json.dumps({"dcn_sequence": {
            "proc": me, "procs": P, "local": L, "count": n,
            "seg_count": seg, "link": link, "flat_sent": got["sent"],
            "flat_messages": got["messages"], "flat_bytes": want["sent"],
            "flat_want_messages": want["messages"],
            "flat_staged": tally["staged"].get("flat", 0)}}), flush=True)
        if got != want:
            raise AssertionError(f"[p{me}] the batch sent {got}, want "
                                 f"{want}")
        for r in rows:
            np.testing.assert_allclose(ob[r], x.sum(0), rtol=1e-4,
                                       atol=1e-4)
        for dt in (None, DataType.int8):
            stage("sequence-" + ("exact" if dt is None else "int8"))

            def batch(f, s, r, g, dt=dt):
                seq = f.sequence()
                seq.allreduce(s, r, n, ReduceFunction.SUM, compress_dtype=dt)
                seq.allgather(r, g, c, compress_dtype=dt)
                seq.bcast(g, c * world, root, compress_dtype=dt)
                seq.compile().run()

            both(batch, (n, x), (n, None), (c * world, None))

        stage("stream")
        base = torch.from_numpy(x).to(args.device)
        for f in (a, twin):
            # each rank's operand is its row of `base`, doubled: the
            # producer reads the ranks it is handed, never a process rank
            f.register_stream_producer(
                9, lambda ranks: base[ranks[:, 0]] * 2.0)
        _, sb = both(lambda f, s, r: f.allreduce(
            s, r, n, ReduceFunction.SUM, op0_stream=9), (n, None), (n, None))
        for r in rows:
            np.testing.assert_allclose(sb[r], 2 * x.sum(0), rtol=1e-4,
                                       atol=1e-4)
        src, dst = 1 % world, world - 1
        (pb,) = both(lambda f, r: f.stream_put(n, stream_id=9, src=src,
                                               dst=dst, recvbuf=r),
                     (n, None))
        for r in rows:
            np.testing.assert_array_equal(pb[r], 2 * x[src if r == dst
                                                       else r])

    stage("barrier")
    a.barrier()
    if args.time:
        stage("time")
        times = {}
        for count in (int(t) for t in args.time.split(",")):
            data = torch.from_numpy(np.random.default_rng(count)
                                    .standard_normal((world, count))
                                    .astype(np.float32))
            bufs, outs = {}, {}
            for name, f in (*timed.items(), ("twin", twin)):
                bufs[name] = (f.create_buffer(count), f.create_buffer(count))
                bufs[name][0].device.copy_(data)
            # each link's last run's rows held against one run of the
            # in-process twin, and against each other's
            twin.allreduce(*bufs["twin"], count, ReduceFunction.SUM,
                           from_device=True, to_device=True)
            runs = {name: [] for name in timed}
            tallies = {}
            for i in range(TIME_REPS + 1):  # the first pair warms up
                for name in (time_links if i % 2 == 0
                             else time_links[::-1]):
                    f = timed[name]
                    f.barrier()
                    f.cclo.transport.reset_tally()
                    t0 = time.perf_counter()
                    f.allreduce(*bufs[name], count, ReduceFunction.SUM,
                                from_device=True, to_device=True)
                    if args.device == "cuda":
                        torch.cuda.synchronize()
                    if i:
                        runs[name].append((time.perf_counter() - t0) * 1e3)
                    tallies[name] = f.cclo.transport.tally()  # the last call's
            want = bufs["twin"][1].device.clone()
            for name in timed:
                outs[name] = bufs[name][1].device.clone()
                agree(outs[name], want)
                agree(outs[name], outs[link])
            for name, f in (*timed.items(), ("twin", twin)):
                for b in bufs[name]:
                    f.free_buffer(b)
            cseg = eager_seg_count(count, 4, dev.eager_rx_buf_size,
                                   StreamFlags.NO_STREAM, world_align=world)

            def row(name):
                tally = tallies[name]
                return {
                    "median_ms": statistics.median(runs[name]),
                    "min_ms": min(runs[name]), "max_ms": max(runs[name]),
                    "runs_ms": runs[name],
                    "sent": tally["sent"].get("outer", 0),
                    "line_hop_bytes": tally["hops"].get("outer", 0),
                    "flat_sent": tally["sent"].get("flat", 0),
                    "flat_messages": tally["messages"].get("flat", 0),
                    "staged": tally["staged"].get("outer", 0),
                    "flat_staged": tally["staged"].get("flat", 0)}

            mine = row(link)
            times[str(count)] = {
                "median_ms": mine["median_ms"], "runs_ms": mine["runs_ms"],
                "sent": mine["sent"],
                "line_hop_bytes": mine["line_hop_bytes"],
                "composition_line_bytes": (outer_allreduce_bytes(count, P, L)
                                           if L > 1 else 0),
                "flat_sent": mine["flat_sent"],
                "flat_messages": mine["flat_messages"],
                "flat_bytes": (flat_allreduce_bytes(count, world, cseg)
                               if L == 1 else 0),
                "flat_want_messages": (flat_allreduce_messages(
                    count, world, cseg) if L == 1 else 0),
                "bitwise_vs_in_process": True,
                "links": {name: row(name) for name in time_links},
                "links_bitwise": True}
        print(json.dumps({"dcn_time": {"proc": me, "procs": P, "local": L,
                                       "device": args.device, "link": link,
                                       "allreduce": times}}), flush=True)
    if args.hop_time:
        stage("hop-time")
        hop_us = {name: {} for name in time_links}

        def sync():
            if args.device == "cuda":
                torch.cuda.synchronize()

        for size in (int(b) for b in args.hop_time.split(",")):
            msg = torch.arange(size, dtype=torch.int64).to(
                torch.uint8).to(args.device)
            for i in range(2):  # the links in turns, twice
                for name in (time_links if i == 0 else time_links[::-1]):
                    timed[name].barrier()
                    if me > 1:
                        continue
                    link_of = timed[name].cclo.transport.link
                    peer = 1 - me

                    def trip():
                        """0 -> 1, and the arrival echoed back."""
                        if me == 0:
                            link_of.exchange({peer: msg}, {})
                            return link_of.exchange({}, {peer: size})[peer]
                        got = link_of.exchange({}, {peer: size})[peer]
                        link_of.exchange({peer: got}, {})
                        return got

                    if not torch.equal(trip().cpu(), msg.cpu()):
                        raise AssertionError(f"[p{me}] a {size}-byte hop "
                                             f"on {name} changed its bytes")
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(HOP_REPS):
                        trip()
                    sync()
                    hop_us[name].setdefault(str(size), []).append(
                        (time.perf_counter() - t0) * 1e6 / (2 * HOP_REPS))
        if me <= 1:
            print(json.dumps({"dcn_hop": {
                "proc": me, "procs": P, "device": args.device,
                "round_trips": HOP_REPS, "us_per_hop": hop_us}}), flush=True)
    print(json.dumps({"dcn_launches": {"proc": me, "procs": P, "local": L,
                                       "by_stage": launches}}), flush=True)
    for f in reversed(timed.values()):  # the group's owner last
        f.cclo.transport.close()
    print(f"RANKS {rows} proc {me}/{P} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
