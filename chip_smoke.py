"""Drive the PyTorch/CUDA port of accl-tpu on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc for sm_90a):

    python3 chip_smoke.py

What it does, in order, printing one JSON object per line:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build time of the kernels, which are compiled
     from accl_tpu_torch/csrc/ into accl_tpu_torch/_build/ at first use;
  2. kernel phase: each fused ring kernel against its plain PyTorch
     version on the card, bitwise (NaN-aware for float MAX), over worlds
     {1, 2, 5, 8}, n {1, 1000, 4099, 1<<20}, six dtypes, SUM and MAX;
  3. facade phase (the main path): ACCL(world=8).allreduce on the card,
     from_device/to_device, fp32 SUM at 4 KiB, 1 MiB, 25 MiB and 256 MiB
     per rank, bf16 SUM at 25 MiB, fp32 MAX at 1 MiB, then world 5 with
     ragged counts; every result held against a float64 sum within the
     recursive-summation bound (W-1)*u*sum|x_i| (MAX exactly), the 1 MiB
     and 25 MiB results also bitwise against the port's plain kernel path
     on the CPU, and the bidirectional kernel's launch count against the
     expected segment count; one host-staged call timed on its own;
  4. timings: per facade size, medians of 20 runs timed with CUDA events
     of the whole call, the kernel alone over the same segments, the plain
     version, and the one PyTorch call computing the same function
     (a yardstick only, never called by the port), beside the bound; then
     a breakdown of a kernel launch into fixed device cost (launch and
     grid barriers), hop traffic and host-side wrapper cost;
  5. the kernels line; last, the device line.

Any failed check raises, and the script then exits non-zero without the
last line. It needs no network and one card.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
SEG_BYTES = 4 * MIB  # the compiler's per-launch cap of the ring kernel


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def same_bits(a, b) -> bool:
    """Bitwise equality; a NaN matches any NaN at the same place."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.itemsize]
    return bool(torch.equal(a[~nan].view(ints), b[~nan].view(ints)))


def max_abs_err(a, b) -> float:
    import torch

    d = (a.double() - b.double()).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run_ms(fn, count: int = 20, repeats: int = 5) -> float:
    """Device time per call in steady state: CUDA events around a run of
    `count` back-to-back calls, divided by the count; median of
    `repeats` runs. While the host enqueues faster than the card drains,
    host time hides behind device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(count):
            fn()
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1) / count)
    return statistics.median(runs)


def rank_data(world: int, count: int, dtype, gen):
    import torch

    if dtype.is_floating_point:
        return torch.randn((world, count), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min // 2, info.max // 2, (world, count),
                         generator=gen, device="cuda", dtype=dtype)


def kernel_phase(ring):
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    gen = torch.Generator(device="cuda").manual_seed(1234)
    pairs = (("ring_allreduce_bidir", ring.ring_allreduce_bidir,
              ring.ring_allreduce_bidir_ref),
             ("ring_allreduce", ring.ring_allreduce, ring.ring_allreduce_ref))
    errs = {}
    for name, kernel, plain in pairs:
        cases, err, nan_cases = 0, 0.0, 0
        for world in (1, 2, 5, 8):
            for n in (1, 1000, 4099, 1 << 20):
                for dtype in ring.SUPPORTED_DTYPES:
                    x = rank_data(world, n, dtype, gen)
                    for func in (ReduceFunction.SUM, ReduceFunction.MAX):
                        xi = x
                        if (func == ReduceFunction.MAX and dtype.is_floating_point
                                and n == 4099 and world > 1):
                            xi = x.clone()
                            xi[1, 7] = float("nan")
                            nan_cases += 1
                        got = kernel(xi, world, func)
                        want = plain(xi, world, func)
                        torch.cuda.synchronize()
                        if not same_bits(got, want):
                            raise AssertionError(
                                f"{name} differs from its plain version: "
                                f"world={world} n={n} {dtype} {func.name} "
                                f"max|diff|={max_abs_err(got, want)}")
                        err = max(err, max_abs_err(got, want))
                        cases += 1
        errs[name] = err
        emit({"phase": "kernel", "kernel": name, "cases": cases,
              "nan_cases": nan_cases, "bitwise_equal": True,
              "max_abs_err": err})
    return errs


def check_against_float64(out, x, func, unit: float) -> float:
    """|out - sum(x)| <= (W-1)*u*sum|x_i| elementwise (MAX: exact); works
    in column blocks to bound the float64 temporaries."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world, n = x.shape
    worst = 0.0
    for lo in range(0, n, 8 * MIB):
        xs = x[:, lo:lo + 8 * MIB].double()
        got = out[:, lo:lo + 8 * MIB].double()
        if func == ReduceFunction.MAX:
            ref = xs.amax(0, keepdim=True)
            bound = torch.zeros_like(ref)
        else:
            ref = xs.sum(0, keepdim=True)
            bound = (world - 1) * unit * xs.abs().sum(0, keepdim=True)
        excess = (got - ref).abs() - bound
        worst = max(worst, float(excess.max()))
        if worst > 0:
            raise AssertionError(
                f"allreduce result outside the bound by {worst}")
    return worst


def facade_phase(ring):
    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.constants import ReduceFunction

    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [  # (world, bytes per rank, dtype, func, bitwise vs CPU)
        (8, 4 * 1024, torch.float32, ReduceFunction.SUM, False),
        (8, MIB, torch.float32, ReduceFunction.SUM, True),
        (8, 25 * MIB, torch.float32, ReduceFunction.SUM, True),
        (8, 256 * MIB, torch.float32, ReduceFunction.SUM, False),
        (8, 25 * MIB, torch.bfloat16, ReduceFunction.SUM, True),
        (8, MIB, torch.float32, ReduceFunction.MAX, True),
        (5, 329 * 4, torch.float32, ReduceFunction.SUM, False),
        (5, 1_000_003 * 4, torch.float32, ReduceFunction.SUM, False),
    ]
    accls = {8: ACCL(world=8), 5: ACCL(world=5)}
    for a in accls.values():
        if not a.cclo.compiler.use_ring_kernel:
            raise AssertionError("ACCL on the card must take the ring kernel")
    cpu_accl = ACCL(world=8, torch_device="cpu")
    cpu_accl.cclo.compiler.use_ring_kernel = True  # the kernel's plain version

    ring.ring_allreduce_bidir.launches = 0
    ring.ring_allreduce.launches = 0
    expected = 0
    kept = {}
    for world, nbytes, dtype, func, vs_cpu in cases:
        accl = accls[world]
        count = nbytes // dtype.itemsize
        x = rank_data(world, count, dtype, gen)
        sb = accl.create_buffer(count, dtype)
        rb = accl.create_buffer(count, dtype)
        sb.device.copy_(x)  # rank data made on the card, seeded
        before = ring.ring_allreduce_bidir.launches
        accl.allreduce(sb, rb, count, func, from_device=True, to_device=True)
        torch.cuda.synchronize()
        segs = math.ceil(count * dtype.itemsize / SEG_BYTES)
        launched = ring.ring_allreduce_bidir.launches - before
        if launched != segs:
            raise AssertionError(
                f"bidir kernel launched {launched} times for {segs} segments")
        expected += segs
        out = rb.device
        unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
        check_against_float64(out, x, func, unit)
        row_equal = bool((out == out[:1]).all())
        bitwise = None
        if vs_cpu:
            csb = cpu_accl.create_buffer(count, dtype, data=x.cpu())
            crb = cpu_accl.create_buffer(count, dtype)
            cpu_accl.allreduce(csb, crb, count, func)
            bitwise = same_bits(out.cpu(), crb.host)
            if not bitwise:
                raise AssertionError("card result differs from the plain "
                                     "kernel path on the CPU")
            cpu_accl.free_buffer(csb)
            cpu_accl.free_buffer(crb)
        emit({"phase": "facade", "world": world, "bytes_per_rank": nbytes,
              "count": count, "dtype": str(dtype).split(".")[-1],
              "func": func.name, "segments": segs, "launches": launched,
              "within_bound": True, "ranks_identical": row_equal,
              "bitwise_vs_cpu_plain": bitwise,
              "finite": bool(torch.isfinite(out).all())})
        if world == 8 and func == ReduceFunction.SUM:
            kept[(nbytes, dtype)] = (sb, rb, count)
        else:
            accl.free_buffer(sb)
            accl.free_buffer(rb)
    launches = {"ring_allreduce_bidir": ring.ring_allreduce_bidir.launches,
                "ring_allreduce": ring.ring_allreduce.launches}
    if launches["ring_allreduce_bidir"] != expected or expected == 0:
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{expected} bidirectional launches")

    # one host-staged call: stage in from the host mirror, copy back out
    sb, rb, count = kept[(25 * MIB, torch.float32)]
    sb.sync_from_device()
    t0 = time.perf_counter()
    accls[8].allreduce(sb, rb, count, ReduceFunction.SUM)
    staged_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "facade", "host_staged": True, "bytes_per_rank": 25 * MIB,
          "host_clock_ms": staged_ms})
    return accls[8], kept, launches


def timing_phase(ring, accl, kept):
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world = accl.world
    for (nbytes, dtype), (sb, rb, count) in sorted(
            kept.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        x = sb.device
        seg = SEG_BYTES // dtype.itemsize
        bounds = [(lo, min(lo + seg, count)) for lo in range(0, count, seg)]

        def facade():
            accl.allreduce(sb, rb, count, ReduceFunction.SUM,
                           from_device=True, to_device=True)

        def kernel_alone():
            for lo, hi in bounds:
                ring.ring_allreduce_bidir(x[:, lo:hi], world)

        def plain():
            for lo, hi in bounds:
                ring.ring_allreduce_bidir_ref(x[:, lo:hi], world)

        def library():
            x.sum(0, keepdim=True).expand_as(x).contiguous()

        t = {"facade_ms": median_ms(facade), "kernel_ms": median_ms(kernel_alone),
             "plain_ms": median_ms(plain), "library_ms": median_ms(library)}
        bound_ms = 2 * world * count * dtype.itemsize / HBM_BYTES_PER_S * 1e3
        bus = 2 * (world - 1) / world * count * dtype.itemsize
        row = {"phase": "timing", "world": world, "bytes_per_rank": nbytes,
               "dtype": str(dtype).split(".")[-1], "segments": len(bounds),
               **t, "bound_ms": bound_ms,
               "facade_busbw_GBps": bus / (t["facade_ms"] * 1e-3) / 1e9,
               "kernel_busbw_GBps": bus / (t["kernel_ms"] * 1e-3) / 1e9}
        emit(row)


def breakdown_phase(ring):
    """Where a launch's time goes at W=8, fp32. Device side, in steady
    state: t(n) = fixed + hops * hop_bytes(n) / rate, with hops = 2(W-1)
    grid barriers and each hop moving 3*n*itemsize bytes (read the comm
    slot, read the local chunk, write the next slot); two sizes that both
    fill the resident grid give the rate and the fixed cost (launch plus
    barriers, so fixed/hops bounds one barrier). Host side: the wrapper's
    cost per launch on the host clock, over launches of a one-element
    world-1 kernel the card finishes at once."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    world, hops = 8, 2 * (8 - 1)
    sizes = (SEG_BYTES // 8, SEG_BYTES // 4)  # 512 Ki and 1 Mi fp32 elements
    xs = [rank_data(world, n, torch.float32, gen) for n in sizes]
    t = [run_ms(lambda x=x: ring.ring_allreduce_bidir(x, world)) for x in xs]
    hop_bytes = [3 * n * 4 for n in sizes]
    ms_per_byte = (t[1] - t[0]) / (hops * (hop_bytes[1] - hop_bytes[0]))
    fixed = t[0] - hops * hop_bytes[0] * ms_per_byte
    one = rank_data(1, 1, torch.float32, gen)
    ring.ring_allreduce_bidir(one, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ring.ring_allreduce_bidir(one, 1)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    emit({"phase": "breakdown", "world": world, "hops": hops,
          "device_ms": dict(zip(("2MiB", "4MiB"), t)),
          "hop_rate_TBps": 1e-9 / ms_per_byte,
          "fixed_device_ms": fixed,
          "barrier_ms_at_most": fixed / hops,
          "fixed_share_4MiB": fixed / t[1],
          "host_ms_per_launch": host_ms})


def kernel_line(ring, errs, launches):
    """Per kernel: device time per launch in steady state at the main
    path's segment shape (W=8, fp32, 4 MiB per rank), its plain version
    and the library yardstick, timed the same way."""
    import torch

    world, n = 8, SEG_BYTES // 4
    gen = torch.Generator(device="cuda").manual_seed(99)
    x = rank_data(world, n, torch.float32, gen)
    bound_ms = 2 * world * n * 4 / HBM_BYTES_PER_S * 1e3
    library_ms = run_ms(lambda: x.sum(0, keepdim=True).expand_as(x).contiguous())
    entries = []
    for name, kernel, plain, replaces, main_path in (
            ("ring_allreduce_bidir", ring.ring_allreduce_bidir,
             ring.ring_allreduce_bidir_ref,
             "accl_tpu/ops/ring_allreduce.py:303", True),
            ("ring_allreduce", ring.ring_allreduce, ring.ring_allreduce_ref,
             "accl_tpu/ops/ring_allreduce.py:151", False)):
        entries.append({
            "name": name, "route": "cuda",
            "source": "accl_tpu_torch/csrc/ring_allreduce.cu",
            "replaces": replaces, "on_main_path": main_path,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": run_ms(lambda: kernel(x, world)),
            "plain_ms": run_ms(lambda: plain(x, world)),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": {"world": world, "n": n, "dtype": "float32"}})
    emit({"kernels": entries})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from accl_tpu_torch.ops import _build
        from accl_tpu_torch.ops import ring_allreduce as ring
    except ImportError as e:
        print(f"chip_smoke: run from the root of an accl-tpu checkout ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library("ring_allreduce")
    ptxas = [line.split("info    : ")[-1]
             for line in _build.build_log.get("ring_allreduce", "").splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": _build.build_seconds["ring_allreduce"],
          "load_s": time.perf_counter() - t0,
          "ptxas": sorted(set(line.strip() for line in ptxas))})

    errs = kernel_phase(ring)
    accl, kept, launches = facade_phase(ring)
    timing_phase(ring, accl, kept)
    breakdown_phase(ring)
    kernel_line(ring, errs, launches)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
