"""Per-collective latency/throughput sweep over the native emulator.

Counterpart of tools/bench_emulator.py (the Coyote benchmark app's
role: per-collective latency and throughput over the eager and
rendezvous protocols): every collective of COLLECTIVES at 1 KiB-4 MiB a
rank over N port emulator ranks (`EmuWorld`), one CSV
(Collective,Protocol,Bytes,Seconds,GBps,World) a transport.

The emulator is host C++ over contiguous CPU torch tensors, so this tool
runs on the host only: it takes no --device and never touches a card,
and its seconds are host time of the machine it runs on (the slowest
rank's mean over --iters calls).

The Protocol column is the regime the row exercised under the shared
selection rules (`select_algorithm` with TuningParams.default()), never a
size threshold; the datagram POE is eager only. The rendezvous
reduce_scatter composition moves the whole world x count payload in one
message, so past MAX_RNDZV it is skipped and said so on stderr.

The CSV goes under --out-dir (default: the current directory) as
emu_bench.csv (tcp), emu_bench_udp.csv or emu_bench_local.csv; a run at
one world refreshes only its own rows of an existing file (a file of
another header is regenerated). `timing_model` fits these files.

Usage:
    python -m accl_tpu_torch.tools.bench_emulator -n 4
    python -m accl_tpu_torch.tools.bench_emulator -n 8 --transport local \\
        --out-dir sweep/
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

# the sweep's eager/rx geometry, single-sourced in telemetry.native: the
# protocol labels, the EmuWorld bring-up, the timing-model calibration
# and the telemetry re-planning must agree, or rows near the
# eager/rendezvous boundary are mislabeled or misfitted silently
from ..telemetry.native import (
    DEFAULT_MAX_EAGER as MAX_EAGER,
    DEFAULT_RX_BUF as RX_BUF,
)

MAX_RNDZV = 64 * 1024 * 1024  # passed to EmuWorld AND the skip rule

# the timing model's calibration domain: larger worlds stay in the CSVs
# as scale evidence but out of the alpha/beta fits (32 threads on one
# core enter a superlinear scheduling regime no linear link model spans)
FIT_MAX_WORLD = 16

# the per-collective sweep of the reference's bench.cpp; `nbytes` is the
# per-rank payload of the collective's natural unit
COLLECTIVES = ("allreduce", "bcast", "allgather", "reduce", "scatter",
               "gather", "reduce_scatter", "alltoall")
SIZES = (1024, 4096, 65536, 1 << 20, 4 << 20)
HEADER = "Collective,Protocol,Bytes,Seconds,GBps,World"
CSV_NAMES = {"tcp": "emu_bench.csv", "udp": "emu_bench_udp.csv",
             "local": "emu_bench_local.csv"}
# the housekeeping (receive) timeout set before the sweep, ms: a slow 4 MB
# point at a large world is measured, not killed
SWEEP_TIMEOUT = 180_000


def protocol_label(name: str, count: int, world: int, transport: str) -> str:
    """The protocol regime a row exercises, from the shared selection
    rules: "eager" on the datagram POE, else the plan's protocol."""
    from ..constants import Operation, TuningParams
    from ..sequencer import Protocol, select_algorithm

    if transport == "udp":
        return "eager"
    plan = select_algorithm(
        Operation[name], count, 4, world, max_eager_size=MAX_EAGER,
        eager_rx_buf_size=RX_BUF, tuning=TuningParams.default())
    return "rndzv" if plan.protocol == Protocol.RENDEZVOUS else "eager"


def skipped(name: str, proto: str, nbytes: int, world: int) -> bool:
    """The rendezvous reduce_scatter composition's one message exceeds
    max_rndzv (the runtime refuses it with DMA_SIZE_ERROR)."""
    return (name == "reduce_scatter" and proto == "rndzv"
            and nbytes * world > MAX_RNDZV)


def operands(name: str, count: int, world: int, rank: int):
    """(x, out): float32 CPU tensors of ones and zeros, wide (world x
    count) only where the rank's role reads or writes that width (a 4 MB
    point at w16 would otherwise allocate ~136 MB a rank)."""
    import torch

    wide_in = (name in ("reduce_scatter", "alltoall")
               or (name == "scatter" and rank == 0))
    wide_out = (name in ("alltoall", "allgather")
                or (name == "gather" and rank == 0))
    return (torch.ones(count * (world if wide_in else 1)),
            torch.zeros(count * (world if wide_out else 1)))


def call(rank, name: str, count: int, x, out) -> None:
    """One call of the named collective on an EmuRank (root 0, SUM)."""
    from ..constants import ReduceFunction

    if name == "allreduce":
        rank.allreduce(x, out, count, ReduceFunction.SUM)
    elif name == "bcast":
        rank.bcast(x, count, root=0)
    elif name == "allgather":
        rank.allgather(x, out, count)
    elif name == "reduce":
        rank.reduce(x, out, count, 0, ReduceFunction.SUM)
    elif name == "scatter":
        rank.scatter(x, out, count, 0)
    elif name == "gather":
        rank.gather(x, out, count, 0)
    elif name == "reduce_scatter":
        rank.reduce_scatter(x, out, count, ReduceFunction.SUM)
    elif name == "alltoall":
        rank.alltoall(x, out, count)
    else:
        raise ValueError(f"unknown collective {name!r}")


def sweep(world: int, iters: int, transport: str) -> list:
    """Every collective at every size over one EmuWorld: rows of
    (collective, protocol, bytes, seconds, GB/s), seconds the slowest
    rank's mean over `iters` calls; one line a row on stderr."""
    from ..constants import CfgFunc, Operation
    from ..descriptor import CallOptions
    from ..device.emu_device import EmuWorld

    w = EmuWorld(world, max_eager=MAX_EAGER, rx_buf_bytes=RX_BUF,
                 max_rndzv=MAX_RNDZV, transport=transport)
    rows = []
    try:
        w.run(lambda rank, i: rank.call(CallOptions(
            scenario=Operation.config, function=int(CfgFunc.set_timeout),
            count=SWEEP_TIMEOUT)))
        for nbytes in SIZES:
            count = nbytes // 4
            for name in COLLECTIVES:
                proto = protocol_label(name, count, world, transport)
                if skipped(name, proto, nbytes, world):
                    print(f"{name:14s} {proto:6s} {nbytes:>9d} B "
                          f"SKIPPED (composition message "
                          f"{nbytes * world >> 20} MB > max_rndzv)",
                          file=sys.stderr)
                    continue

                def body(rank, i, _name=name, _n=count):
                    x, out = operands(_name, _n, world, i)
                    rank.barrier()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        call(rank, _name, _n, x, out)
                    return (time.perf_counter() - t0) / iters

                secs = max(w.run(body))
                gbps = nbytes / secs / 1e9
                rows.append((name, proto, nbytes, secs, gbps))
                print(f"{name:14s} {proto:6s} {nbytes:>9d} B "
                      f"{secs*1e6:10.1f} us  {gbps:7.3f} GB/s",
                      file=sys.stderr)
    finally:
        w.close()
    return rows


def write_csv(rows, path, world: int) -> int:
    """Write `rows` at `world` into the CSV at `path`, keeping an
    existing file's rows of other worlds (merge by world) when its header
    is the current 6-column one; a file of another header is regenerated
    (its rows would survive every world filter). Returns the rows kept."""
    path = pathlib.Path(path)
    kept = []
    if path.exists():
        with open(path) as f:
            if f.readline().strip() == HEADER:
                kept = [ln for ln in f
                        if ln.strip() and ln.rsplit(",", 1)[1].strip()
                        != str(world)]
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        f.writelines(kept)
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]},{r[3]:.6e},{r[4]:.3f},"
                    f"{world}\n")
    return len(kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--world", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--transport", choices=("tcp", "udp", "local"),
                    default="tcp",
                    help="session TCP mesh, sessionless datagram POE, or "
                         "the intra-process direct-call POE")
    ap.add_argument("--out-dir", default=".",
                    help="directory of the CSV (created if missing)")
    args = ap.parse_args(argv)

    rows = sweep(args.world, args.iters, args.transport)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv = out / CSV_NAMES[args.transport]
    kept = write_csv(rows, csv, args.world)
    print(f"wrote {csv} ({len(rows)} new rows, {kept} kept)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
