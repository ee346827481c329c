"""Per-config sequencer-counter sweep over the native emulator, a thin
client of the telemetry package.

Counterpart of tools/rt_stats_sweep.py. Each (collective, bytes, world,
transport) config runs in a child process of its own with the runtime's
per-call trace ring armed (ACCL_RT_TRACE=1, and ACCL_RT_SHAPE when
--shape forces a hop shape: the runtime reads both when it is created,
so each config needs a fresh process, and the variables are set in the
child's environment only). The child drains every rank's counters
(EmuRank.sequencer_stats) and per-call spans (telemetry.native's
drain_world) and prints one JSON line: seconds a call, stats, spans,
span_dropped, retcodes. The parent writes one CSV row a config: the
seconds, the counter totals over ranks (park time in ms), and the
aggregate wire-bytes bandwidth (telemetry.native.aggregate_wire_gbps:
the bytes the planned schedule moves over all ranks, a forced shape
mirrored into the cost, over the measured seconds).

The emulator is host C++ over contiguous CPU torch tensors, so this tool
runs on the host only: it takes no --device and never touches a card.
The parent builds (or reuses) the port's libacclrt once before the
first child starts.

The CSV (Collective,Bytes,World,Transport,Iters,SecondsPerCall,Passes,
Parks,ParkMs,SeekHit,SeekMiss,AggWireGBps,Shape) goes to --out (a path,
default rt_stats.csv in the current directory). A config whose child
fails is said on stderr and left out of the CSV, and the tool then exits
1.

Usage:
    python -m accl_tpu_torch.tools.rt_stats_sweep
    python -m accl_tpu_torch.tools.rt_stats_sweep --worlds 4,8 \\
        --collectives allreduce --shape logp --out rt_logp.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pathlib
import subprocess
import sys

# the directory that holds the accl_tpu_torch package, put on the child's
# sys.path
ROOT = pathlib.Path(__file__).resolve().parents[2]
CHILD_TIMEOUT_S = 600
# the default sweep: W 8, three collectives at 64 KiB, 1 MiB and 4 MiB
WORLDS = "8"
COLLECTIVES = "allreduce,bcast,allgather"
SIZES = "65536,1048576,4194304"
ITERS = 5
HEADER = ["Collective", "Bytes", "World", "Transport", "Iters",
          "SecondsPerCall", "Passes", "Parks", "ParkMs", "SeekHit",
          "SeekMiss", "AggWireGBps", "Shape"]

# The child: one config a process. argv: root, collective, bytes, world,
# transport, iters. Prints ONE JSON line on stdout.
CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from accl_tpu_torch.constants import ReduceFunction
from accl_tpu_torch.device.emu_device import EmuWorld
from accl_tpu_torch.telemetry import native as tnative

name, transport = sys.argv[2], sys.argv[5]
nbytes, world, iters = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[6])
count = nbytes // 4
w = EmuWorld(world, max_eager=tnative.DEFAULT_MAX_EAGER,
             rx_buf_bytes=tnative.DEFAULT_RX_BUF, transport=transport)
try:
    def body(rank, i):
        x = torch.ones(count)
        out = torch.zeros(count * (world if name == "allgather" else 1))
        rank.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            if name == "allreduce":
                rank.allreduce(x, out, count, ReduceFunction.SUM)
            elif name == "bcast":
                rank.bcast(x, count, root=0)
            elif name == "reduce":
                rank.reduce(x, out, count, 0, ReduceFunction.SUM)
            elif name == "gather":
                gout = torch.zeros(count * world)
                rank.gather(x, gout, count, 0)
            elif name == "reduce_scatter":
                rsout = torch.zeros(max(count // world, 1))
                rank.reduce_scatter(x, rsout, max(count // world, 1),
                                    ReduceFunction.SUM)
            else:
                rank.allgather(x, out, count)
        return (time.perf_counter() - t0) / iters
    secs = max(w.run(body))
    stats = [r.sequencer_stats() for r in w.ranks]
    spans, dropped = tnative.drain_world(w)
    print(json.dumps({
        "seconds": secs,
        "stats": stats,
        "spans": len(spans),
        "span_dropped": dropped,
        "retcodes": sorted({s["args"]["retcode"] for s in spans}),
    }))
finally:
    w.close()
"""


def run_child(name, nbytes, world, transport, iters, shape=""):
    """One config's child process; returns its JSON report, or None
    (said on stderr) when it failed or printed none."""
    env = dict(os.environ)
    env["ACCL_RT_TRACE"] = "1"
    if shape:
        env["ACCL_RT_SHAPE"] = shape
    r = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), name,
                        str(nbytes), str(world), transport, str(iters)],
                       env=env, capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S)
    if r.returncode != 0:
        print(f"  {name} {nbytes}B w{world} {transport}: FAILED\n"
              f"{r.stderr[-2000:]}", file=sys.stderr)
        return None
    for line in r.stdout.splitlines():
        try:
            return json.loads(line)
        except ValueError:
            continue
    print(f"  {name} {nbytes}B w{world}: no JSON report parsed",
          file=sys.stderr)
    return None


def summarize(payload, name, nbytes, world, transport, iters, shape=""):
    """A child's report as one CSV row: the counter totals over ranks
    (parks and seek misses are the per-hop fixed costs, park_ms the
    latency paid) and the aggregate wire GB/s of the schedule that ran."""
    from ..telemetry.native import aggregate_wire_gbps

    secs = payload["seconds"]
    tot = [sum(st[k] for st in payload["stats"])
           for k in ("passes", "parks", "park_ns", "seek_hit",
                     "seek_miss")]
    tot[2] = tot[2] / 1e6  # park_ns -> park_ms (the CSV's historic unit)
    # a forced ACCL_RT_SHAPE is mirrored into the cost, so the bytes
    # describe the schedule that ran (the logp/ring pair moves equal
    # aggregate bytes, so this holds by construction, not coincidence)
    logp_shape = {"": None, "ring": False, "logp": True}[shape]
    agg_gbps = aggregate_wire_gbps(name, nbytes, world, secs,
                                   logp_shape=logp_shape)
    return (name, nbytes, world, transport, iters, secs, *tot, agg_gbps)


def run_config(name, nbytes, world, transport, iters, shape=""):
    """One config: its child's report summarized, or None."""
    payload = run_child(name, nbytes, world, transport, iters, shape)
    if payload is None:
        return None
    return summarize(payload, name, nbytes, world, transport, iters, shape)


def write_csv(rows, path, shape: str = "") -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows([(*r[:-1], f"{r[-1]:.4f}", shape or "auto")
                     for r in rows])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="rt_stats.csv",
                    help="path of the CSV (directories created)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--transport", default="tcp",
                    choices=("tcp", "udp", "local"))
    ap.add_argument("--worlds", default=WORLDS)
    ap.add_argument("--collectives", default=COLLECTIVES)
    ap.add_argument("--sizes", default=SIZES)
    ap.add_argument("--shape", default="", choices=("", "ring", "logp"),
                    help="force the allreduce/allgather hop shape via "
                         "ACCL_RT_SHAPE in the child (crossover "
                         "calibration)")
    args = ap.parse_args(argv)

    from ..device.emu_device import load_native

    load_native()  # build once here, never concurrently in the children
    rows, failed = [], 0
    for world in [int(w) for w in args.worlds.split(",")]:
        for name in args.collectives.split(","):
            for nbytes in [int(s) for s in args.sizes.split(",")]:
                row = run_config(name, nbytes, world, args.transport,
                                 args.iters, shape=args.shape)
                if row is None:
                    failed += 1
                else:
                    rows.append(row)
                    (n, b, w, t, it, s, passes, parks, park_ms, hit,
                     miss, agg) = row
                    print(f"  {n:13s} {b:>9d}B w{w} {s*1e3:9.2f} ms/call"
                          f"  passes={passes} parks={parks}"
                          f" park_ms={park_ms:.1f} seek_hit={hit}"
                          f" seek_miss={miss} aggwire={agg:.3f} GB/s",
                          file=sys.stderr)

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_csv(rows, out, args.shape)
    print(f"wrote {out} ({len(rows)} rows)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
