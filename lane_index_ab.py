"""Time kernels 8 and 9 of the port (combine_cast and cast, lane_walk in
accl_tpu_torch/csrc/lanes.cu) with the walk's 32-bit index, which the
source takes at these shapes, against a copy of the source that always
takes the 64-bit one, on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 lane_index_ab.py [--pairs 10]

It builds the source and the copy (`fits_int` false, into
accl_tpu_torch/_build/) with the port's nvcc flags, checks that both
give the same bits at the kernels line's shapes of chip_smoke.py
((1, 13 107 200) bf16 SUM; (8, 6 553 600) f32 -> bf16, which the wrapper
folds into one row), then times each launch there with the host held off
(chip_smoke.device_ms) in alternating pairs, the first of each pair
swapping sides, both sides on the same operand and result tensors, and prints one JSON line per kernel (every pair's times,
the medians and ranges of each side) after the card's name and power
limit. It exits non-zero without a CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

# the line of csrc/lanes.cu that lets a walk take 32-bit indices
INDEX_LINE = ("  return units + x * kThreads <= INT_MAX && "
              "n + kThreads <= INT_MAX;")


def build_64bit_copy():
    """The lanes library built from a copy of csrc/lanes.cu whose walk
    always takes 64-bit indices."""
    from accl_tpu_torch.ops import _build

    src = (_build.SRC_DIR / "lanes.cu").read_text()
    if src.count(INDEX_LINE) != 1:
        raise RuntimeError(f"csrc/lanes.cu has no single {INDEX_LINE!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "lanes_index64.cu"
    cu.write_text(src.replace(INDEX_LINE, "  return false;"))
    so = _build.BUILD_DIR / "liblanes_index64.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so))


def launches(L, stream):
    """Per kernel: a function that launches it from a given library at
    the kernels line's shape, on operands and a result made once, so
    that both sides read and write the same memory, and the result."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2468)
    n32 = 25 * (1 << 20) // 4
    h, k = (torch.randn((1, 2 * n32), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    x = torch.randn((8, n32), generator=gen, device="cuda")
    h_out = torch.empty_like(h)
    x_out = torch.empty_like(x, dtype=torch.bfloat16)
    bf16 = L._CODES[torch.bfloat16]

    def combine_cast(lib):
        rows, n, (lda, ldb, ldo), vec = L._launch_shape(h, k, h_out)
        return lib.accl_lane_combine_cast(
            bf16, bf16, L._op("sum"), h.data_ptr(), lda, k.data_ptr(), ldb,
            h_out.data_ptr(), ldo, rows, n, int(vec), stream)

    def cast(lib):
        rows, n, (ldx, ldo), vec = L._launch_shape(x, x_out)
        return lib.accl_lane_cast(
            L._CODES[torch.float32], bf16, x.data_ptr(), ldx,
            x_out.data_ptr(), ldo, rows, n, int(vec), stream)

    return {"combine_cast": (combine_cast, h_out), "cast": (cast, x_out)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_index_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, same_bits
    from accl_tpu_torch.ops import lane_kernels as L

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {"int32": L._library(), "int64": L._bind(build_64bit_copy())}
    for name, (launch, res) in launches(L, stream).items():
        got = {}
        for side, lib in libs.items():
            if launch(lib):
                raise RuntimeError(f"{name} ({side}) launch failed")
            torch.cuda.synchronize()
            got[side] = res.clone()
        if not same_bits(got["int32"], got["int64"]):
            raise AssertionError(f"{name}: the two index widths differ")
        del got
        times = {side: [] for side in libs}
        for p in range(args.pairs):
            for side in (("int64", "int32") if p % 2 == 0
                         else ("int32", "int64")):
                lib = libs[side]
                times[side].append(device_ms(lambda: launch(lib)))
        print(json.dumps({
            "kernel": name, "pairs": args.pairs, "device_ms": times,
            "median_ms": {s: statistics.median(t) for s, t in times.items()},
            "range_ms": {s: [min(t), max(t)] for s, t in times.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
