"""Launch N native-emulator ranks as separate OS processes.

Counterpart of tools/run_emulator.py. The parent builds (or reuses) the
port's libacclrt once (`emu_device.load_native`), then starts one
`multiprocessing` process per rank; each brings up one port `EmuRank`
and runs a demo allreduce of 4096 contiguous CPU float32 elements (or a
user script via --script module:function, called as fn(rank, rank_idx,
world)). The emulator is host C++ over CPU tensors, so the tool takes no
--device.

Prints "[rank i] ... OK" per rank and "all N ranks OK"; exits 1 when a
rank mismatches, fails or does not report. What a rank's function prints
is sent back with its result and printed by the launcher, in rank order
(the ranks run in processes forked from a server the first call starts).

Usage:
    python -m accl_tpu_torch.tools.run_emulator -n 4
    python -m accl_tpu_torch.tools.run_emulator -n 4 --transport udp
    python -m accl_tpu_torch.tools.run_emulator -n 4 --script mymod:fn
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import multiprocessing as mp
import queue
import sys

DEMO_COUNT = 4096


def _demo(rank, idx, world):
    import torch

    from ..constants import ReduceFunction

    n = DEMO_COUNT
    x = torch.full((n,), float(idx + 1), dtype=torch.float32)
    out = torch.zeros(n, dtype=torch.float32)
    rank.allreduce(x, out, n, ReduceFunction.SUM)
    expected = world * (world + 1) / 2
    ok = bool(torch.allclose(out, torch.full_like(out, expected)))
    print(f"[rank {idx}] allreduce({n}) -> {float(out[0]):.1f} "
          f"(expect {expected:.1f}) {'OK' if ok else 'MISMATCH'}")
    rank.barrier()
    return ok


def worker(world, idx, ports, script, q, transport="tcp"):
    from ..device.emu_device import EmuRank

    rank = EmuRank(world, idx, ports, transport=transport)
    printed = io.StringIO()
    try:
        if script:
            mod, fn = script.split(":")
            f = getattr(importlib.import_module(mod), fn)
        else:
            f = _demo
        with contextlib.redirect_stdout(printed):
            ok = bool(f(rank, idx, world))
        q.put((idx, ok, printed.getvalue()))
    except Exception as e:
        q.put((idx, f"error: {e}", printed.getvalue()))
    finally:
        rank.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--world", type=int, default=2)
    ap.add_argument("--script", default=None,
                    help="module:function run per rank as fn(rank, idx, "
                         "world)")
    ap.add_argument("--transport", choices=("tcp", "udp"), default="tcp",
                    help="session TCP mesh or sessionless datagram POE")
    args = ap.parse_args(argv)

    from ..device.emu_device import free_ports, load_native

    load_native()  # build once here, not once a rank
    ports = free_ports(args.world)
    # the ranks fork from a fresh server process that has loaded torch
    # and the binding once (forking this process is unsafe once it runs
    # threads); the server lives as long as this process
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["accl_tpu_torch.device.emu_device"])
    q = ctx.Queue()
    procs = [ctx.Process(target=worker,
                         args=(args.world, i, ports, args.script, q,
                               args.transport), daemon=True)
             for i in range(args.world)]
    results, printed = {}, {}
    try:
        for p in procs:
            p.start()
        for _ in range(args.world):
            try:
                k, v, text = q.get(timeout=120)
            except queue.Empty:
                break  # a rank died before reporting
            results[k], printed[k] = v, text
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    for k in sorted(printed):
        sys.stdout.write(printed[k])
    bad = {k: v for k, v in results.items() if v is not True}
    missing = set(range(args.world)) - set(results)
    if bad or missing:
        print(f"FAILED ranks: {bad} missing: {sorted(missing)}",
              file=sys.stderr)
        return 1
    print(f"all {args.world} ranks OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
