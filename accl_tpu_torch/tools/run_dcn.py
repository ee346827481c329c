"""Multi-process DCN runner: one OS process per "host".

Counterpart of tools/run_dcn.py. Each process joins the default
torch.distributed group over gloo, builds its DCNDevice (local_devices
virtual ranks, global rank = proc * local + l) and drives facade
collectives whose outer hops cross the process boundary; beside it, the
in-process DCNDevice over the same (procs, local) world on the same
seeded rows runs every call too, and the process's own rows must equal
its rows bitwise. The stages: the two-tier allreduce (exact, then the
int8 wire), bcast from rank world-1, allgather, reduce_scatter, alltoall,
scatter, gather and reduce to rank world-1, p2p 1 -> world-1, host 0's
sub-communicator, optionally the first K hosts' (--subset-hosts K), and
a barrier.

Usage (2 processes x 4 virtual ranks on the CPU):
    python -m accl_tpu_torch.tools.run_dcn --procs 2 --proc-id 0 \\
        --port 9911 --device cpu &
    python -m accl_tpu_torch.tools.run_dcn --procs 2 --proc-id 1 \\
        --port 9911 --device cpu

Prints one "RANKS [...] proc i/N OK" line per process on success (exit
0); a "dcn_bytes" JSON line (the bytes this process sent across the
process boundary in one allreduce, and those a line carries in the
outer hops, beside the composition's count); with --time COUNTS a
"dcn_time" JSON line (host-clock median ms of the allreduce at each
count, from device to device).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


TIME_REPS = 5


def outer_allreduce_bytes(count: int, procs: int, local: int,
                          itemsize: int = 4) -> int:
    """Bytes a line carries in the outer hops of one exact two-tier
    allreduce: the ring reduce-scatter and allgather of the 1/L shard,
    2 * (P - 1) hops of ceil(ceil(count / L) / P) elements."""
    shard = -(-count // local)
    return 2 * (procs - 1) * -(-shard // procs) * itemsize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--count", type=int, default=96)
    ap.add_argument("--subset-hosts", type=int, default=0,
                    help="also run an allreduce on a sub-communicator of "
                         "the first K hosts (0 = skip)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--time", default="",
                    help="comma-separated per-rank counts whose allreduce "
                         "is timed (host clock, median of 5 after a "
                         "warm-up)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, DataType, ReduceFunction
    from accl_tpu_torch.device.dcn_device import DCNDevice
    from accl_tpu_torch.parallel import make_mesh

    P, L, me = args.procs, args.local_devices, args.proc_id
    if args.device == "cpu":
        # the hosts share this machine's cores: one share each, not all
        # of them spinning in every process
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
    dev = DCNDevice(num_processes=P, process_id=me,
                    coordinator_address=f"127.0.0.1:{args.port}",
                    local_device_count=L, torch_device=args.device)
    a = ACCL(device=dev)
    twin = ACCL(device=DCNDevice(mesh=make_mesh(
        {"dcn": P, "ici": L}, world=P * L, device=args.device)))
    world, n = a.world, args.count
    rows = dev.local_rows()
    rng = np.random.default_rng(17)  # same data on every process
    x = rng.standard_normal((world, n)).astype(np.float32)

    def stage(name):
        print(f"[p{me}] {name}", flush=True)

    def both(call, *shapes):
        """Run `call` on the multi-process facade and on its in-process
        twin over buffers made from `shapes` ((count, data) pairs); this
        process's rows of every buffer must agree bitwise."""
        outs = []
        for f in (a, twin):
            bufs = [f.create_buffer(c, data=d) for c, d in shapes]
            call(f, *bufs)
            outs.append([b.host for b in bufs])
        for mine, want in zip(*outs):
            if not torch.equal(mine[rows].view(torch.int32),
                               want[rows].view(torch.int32)):
                raise AssertionError(f"[p{me}] rows {rows} differ from the "
                                     "in-process device's")
        return [t.numpy() for t in outs[0]]

    # two-tier allreduce: the outer tier carries 1/L of the payload
    stage("allreduce")
    dev.transport.reset_tally()
    _, rb = both(lambda f, s, r: f.allreduce(s, r, n, ReduceFunction.SUM),
                 (n, x), (n, None))
    tally = dev.transport.tally()
    for r in rows:
        np.testing.assert_allclose(rb[r], x.sum(0), rtol=1e-4, atol=1e-4)
    want = outer_allreduce_bytes(n, P, L)
    print(json.dumps({"dcn_bytes": {
        "proc": me, "procs": P, "local": L, "count": n,
        "sent": tally["sent"].get("outer", 0),
        "messages": tally["messages"].get("outer", 0),
        "line_hop_bytes": tally["hops"].get("outer", 0),
        "composition_line_bytes": want}}), flush=True)
    if tally["hops"].get("outer", 0) != want or \
            tally["sent"].get("outer", 0) != L * want:
        raise AssertionError(f"[p{me}] outer bytes {tally}, want {want} "
                             f"a line")

    stage("allreduce-int8")
    _, qb = both(lambda f, s, r: f.allreduce(
        s, r, n, ReduceFunction.SUM, compress_dtype=DataType.int8),
        (n, x), (n, None))
    for r in rows:
        bound = P * L * np.abs(x).sum(0).max() / 127
        assert np.abs(qb[r] - x.sum(0)).max() <= bound

    # bcast from a rank on the last process: every process issues the
    # same call, so the root is the same global rank everywhere
    stage("bcast")
    root = world - 1
    (bb,) = both(lambda f, b: f.bcast(b, n, root), (n, x))
    for r in rows:
        np.testing.assert_array_equal(bb[r], x[root])

    stage("allgather")
    c = n // world
    _, gb = both(lambda f, s, r: f.allgather(s, r, c), (c, x[:, :c]),
                 (c * world, None))
    for r in rows:
        np.testing.assert_array_equal(gb[r], x[:, :c].reshape(-1))

    stage("reduce_scatter")
    _, sr = both(lambda f, s, r: f.reduce_scatter(s, r, c,
                                                  ReduceFunction.SUM),
                 (c * world, x[:, :c * world]), (c, None))
    full = x[:, :c * world].sum(0)
    for r in rows:
        np.testing.assert_allclose(sr[r], full[r * c:(r + 1) * c],
                                   rtol=1e-4, atol=1e-4)

    stage("alltoall")
    ts = x[:, :world * 8]
    _, tr = both(lambda f, s, r: f.alltoall(s, r, 8), (world * 8, ts),
                 (world * 8, None))
    exp = ts.reshape(world, world, 8).transpose(1, 0, 2)
    for r in rows:
        np.testing.assert_array_equal(tr[r], exp[r].reshape(-1))

    stage("scatter-gather-reduce")
    _, scb = both(lambda f, s, r: f.scatter(s, r, c, root),
                  (c * world, x[:, :c * world]), (c, None))
    for r in rows:
        np.testing.assert_array_equal(scb[r], x[root, r * c:(r + 1) * c])
    _, gab = both(lambda f, s, r: f.gather(s, r, c, root), (c, x[:, :c]),
                  (c * world, None))
    _, rdb = both(lambda f, s, r: f.reduce(s, r, n, root,
                                           ReduceFunction.SUM),
                  (n, x), (n, None))
    if root in rows:
        np.testing.assert_array_equal(gab[root], x[:, :c].reshape(-1))
        np.testing.assert_allclose(rdb[root], x.sum(0), rtol=1e-4,
                                   atol=1e-4)

    stage("p2p")
    src, dst = 1, world - 1  # crosses the process boundary

    def p2p(f, s, r):
        f.send(s, 16, src=src, dst=dst, tag=5)
        f.recv(r, 16, src=src, dst=dst, tag=5)

    _, pv = both(p2p, (n, x), (16, None))
    if dst in rows:
        np.testing.assert_array_equal(pv[dst], x[src, :16])

    # an outer-aligned sub-communicator: host 0's whole inner group. Every
    # process issues the same call; non-member hosts no-op it.
    stage("subcomm")

    def host0(f, s, r):
        f.allreduce(s, r, 24, ReduceFunction.SUM,
                    comm=f.split(list(range(L))))

    _, cr = both(host0, (24, x[:, :24]), (24, None))
    for r in rows:
        want = x[:L, :24].sum(0) if me == 0 else 0.0
        np.testing.assert_allclose(cr[r], want, rtol=1e-4, atol=1e-4)

    if args.subset_hosts:
        # the first K whole hosts: member hosts run the two-tier
        # allreduce on the (K, L) sub-world, the rest no-op it
        k = args.subset_hosts
        stage(f"subset-{k}-hosts")

        def subset(f, s, r):
            f.allreduce(s, r, 16, ReduceFunction.SUM,
                        comm=f.split(list(range(k * L))))

        _, kr = both(subset, (16, x[:, :16]), (16, None))
        for r in rows:
            want = x[:k * L, :16].sum(0) if me < k else 0.0
            np.testing.assert_allclose(kr[r], want, rtol=1e-4, atol=1e-4)

    stage("barrier")
    a.barrier()
    if args.time:
        stage("time")
        times = {}
        for count in (int(t) for t in args.time.split(",")):
            sb, rb = a.create_buffer(count), a.create_buffer(count)
            sb.device.copy_(torch.from_numpy(np.random.default_rng(
                count).standard_normal((world, count)).astype(np.float32)))
            runs = []
            for i in range(TIME_REPS + 1):
                a.barrier()
                dev.transport.reset_tally()
                t0 = time.perf_counter()
                a.allreduce(sb, rb, count, ReduceFunction.SUM,
                            from_device=True, to_device=True)
                runs.append((time.perf_counter() - t0) * 1e3)
            tally = dev.transport.tally()  # the last call's
            times[str(count)] = {
                "median_ms": statistics.median(runs[1:]),
                "runs_ms": runs[1:],
                "sent": tally["sent"].get("outer", 0),
                "line_hop_bytes": tally["hops"].get("outer", 0),
                "composition_line_bytes": outer_allreduce_bytes(count, P, L)}
            a.free_buffer(sb)
            a.free_buffer(rb)
        print(json.dumps({"dcn_time": {"proc": me, "procs": P, "local": L,
                                       "device": args.device,
                                       "allreduce": times}}), flush=True)
    dev.transport.close()
    print(f"RANKS {rows} proc {me}/{P} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
