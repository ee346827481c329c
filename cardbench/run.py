"""Run one cell of the benchmark once and print its result line.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (loading, building the kernels on a
checkout's first run, the seeded operands, the warm steps) is timed from
process start to the first timed dispatch; the window then runs for
`--seconds`; the check compares what the window's calls wrote with the
plain reference. The last line of standard output is one JSON object;
the last lines of standard error give each compared number beside its
limit. Without a CUDA device, or with fewer than the cell asks for, or
when JAX or the JAX package was loaded, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".cardbench_cache"


def _environment() -> None:
    """The program runs as shipped: no ACCL_* setting from outside, and
    every build or kernel cache inside the checkout at a fixed path."""
    for key in [k for k in os.environ if k.startswith("ACCL_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's bfloat16 wire in place of the "
                         "exact one: the lower-precision control, which "
                         "the check has to fail (never a benchmark run)")
    args = ap.parse_args(argv)
    _environment()

    import torch

    from cardbench import harness

    spec = harness.load_spec()
    cell = harness.load_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print("loaded in the measured process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for c in result["check"].values():
        # a reading that is not finite prints as the largest float, so
        # the line stays JSON
        if not math.isfinite(c["value"]):
            c["value"] = sys.float_info.max
    for note in result["windows"]:
        print(note, file=sys.stderr)
    print("set-up and check, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["phases_s"].items()),
        file=sys.stderr)
    for key, c in result["check"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
