"""A/B of a design choice of the port's lane kernels (lane_walk in
accl_tpu_torch/csrc/lanes.cu) on one NVIDIA card: the source as it
stands against a copy with one line changed, timed in alternating pairs.

    --ab index  kernels 8 and 9 (combine_cast, cast) with the walk's
                32-bit index, which the source takes at these shapes,
                against a copy that always takes the 64-bit one;
    --ab unit   kernel 7 (combine) with its one-access vector unit
                (16 bytes of each operand: 4 f32, 2 f64 elements)
                against a copy whose unit is 8 elements, as kernels 8
                and 9 take (two 16-byte accesses of f32, four of f64).

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 lane_ab.py [--ab index|unit] [--pairs 10]

It builds the source and the copy (into accl_tpu_torch/_build/) with the
port's nvcc flags, checks that both give the same bits at the kernels
line's shapes of chip_smoke.py (index: (1, 13 107 200) bf16 SUM and
(8, 6 553 600) f32 -> bf16, which the wrapper folds into one row; unit:
(1, 6 553 600) f32 and f64 SUM, the first a fold of the 25 MiB reduce),
then times each launch there with the host held off
(chip_smoke.device_ms) in alternating pairs, the first of each pair
swapping sides, both sides on the same operand and result tensors, with
the library call beside the unit A/B (torch.add on the same operands),
and prints one JSON line per kernel (every pair's times, the medians
and ranges of each side) after the card's name and power limit. It
exits non-zero without a CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

# per A/B: (line of csrc/lanes.cu, its replacement in the copy, the
# source's side, the copy's side)
VARIANTS = {
    "index": ("  return units + x * kThreads <= INT_MAX && "
              "n + kThreads <= INT_MAX;", "  return false;",
              "int32", "int64"),
    "unit": ("  static constexpr int kVec = 16 / sizeof(T);  "
             "// one 16-byte access",
             "  static constexpr int kVec = kUnit;",
             "16-byte unit", "8-element unit"),
}


def build_copy(ab: str):
    """The lanes library built from a copy of csrc/lanes.cu with the A/B's
    line replaced."""
    from accl_tpu_torch.ops import _build

    line, repl, _, _ = VARIANTS[ab]
    src = (_build.SRC_DIR / "lanes.cu").read_text()
    if src.count(line) != 1:
        raise RuntimeError(f"csrc/lanes.cu has no single {line!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"lanes_ab_{ab}.cu"
    cu.write_text(src.replace(line, repl))
    so = _build.BUILD_DIR / f"liblanes_ab_{ab}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so))


def launches(L, stream, ab: str):
    """Per kernel: a function that launches it from a given library at
    the kernels line's shape, on operands and a result made once, so
    that both sides read and write the same memory, the result, and the
    library call on the same operands (None for the index A/B)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2468)
    n32 = 25 * (1 << 20) // 4

    def lane(entry, codes, ops, out, **kw):
        def launch(lib):
            rows, n, lds, vec = L._launch_shape(*ops, out)
            args = [a for t, ld in zip(ops, lds) for a in (t.data_ptr(), ld)]
            return getattr(lib, entry)(*codes, *args, out.data_ptr(),
                                       lds[-1], rows, n, int(vec), stream)
        return launch

    if ab == "index":
        h, k = (torch.randn((1, 2 * n32), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        x = torch.randn((8, n32), generator=gen, device="cuda")
        h_out = torch.empty_like(h)
        x_out = torch.empty_like(x, dtype=torch.bfloat16)
        bf16, f32 = L._CODES[torch.bfloat16], L._CODES[torch.float32]
        return {
            "combine_cast": (lane("accl_lane_combine_cast",
                                  (bf16, bf16, L._op("sum")), (h, k), h_out),
                             h_out, None),
            "cast": (lane("accl_lane_cast", (f32, bf16), (x,), x_out), x_out,
                     None)}
    out = {}
    for dtype in (torch.float32, torch.float64):
        a, b = (torch.randn((1, n32), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        res = torch.empty_like(a)
        out[f"combine {str(dtype).split('.')[-1]}"] = (
            lane("accl_lane_combine", (L._CODES[dtype], L._op("sum")),
                 (a, b), res),
            res, lambda a=a, b=b: torch.add(a, b))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", choices=sorted(VARIANTS), default="index")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, same_bits
    from accl_tpu_torch.ops import lane_kernels as L

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    _, _, this, copy = VARIANTS[args.ab]
    libs = {this: L._library(), copy: L._bind(build_copy(args.ab))}
    for name, (launch, res, library) in launches(L, stream, args.ab).items():
        got = {}
        for side, lib in libs.items():
            if launch(lib):
                raise RuntimeError(f"{name} ({side}) launch failed")
            torch.cuda.synchronize()
            got[side] = res.clone()
        if not same_bits(got[this], got[copy]):
            raise AssertionError(f"{name}: the two sides differ")
        del got
        times = {side: [] for side in libs}
        for p in range(args.pairs):
            for side in ((copy, this) if p % 2 == 0 else (this, copy)):
                lib = libs[side]
                times[side].append(device_ms(lambda: launch(lib)))
        row = {"kernel": name, "pairs": args.pairs, "device_ms": times,
               "median_ms": {s: statistics.median(t)
                             for s, t in times.items()},
               "range_ms": {s: [min(t), max(t)] for s, t in times.items()}}
        if library is not None:
            row["library_ms"] = [device_ms(library)
                                 for _ in range(args.pairs)]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
