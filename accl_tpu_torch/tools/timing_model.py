"""Calibrate the per-hop timing model from measured sweeps and derive the
tuning registers' crossovers.

Counterpart of tools/timing_model.py (the cclo_sim role: a second target
answering "how long should this schedule take"): the alpha-beta model of
sequencer/timing.py fitted per collective on the AGGREGATE cost shape to
the emulator sweeps that `bench_emulator` writes (emu_bench.csv under
--sweep-dir; emu_bench_local.csv and emu_bench_udp.csv, where present,
as the per-POE tiers), each row's predicted against measured seconds, a
leave-one-world-out holdout, and the crossovers on the bcast link.

With --profile PATH it also fits the on-chip tier (`tpu_tier`, the key
ACCL.autotune(tier="tpu") reads) from a device profile of the columns
Test,Bytes,Seconds,GBps,Regime: the dispatch alpha from the world-1
`*_w1_dispatch_datapath*` rows, the HBM stream rate from the
`combine_sum_fp32` rows of Regime "stream". The port's profile is the
card's own (chip_smoke.py measures it with the port's kernels); no
profile is read unless named, and without one the section is null.

The emulator sweeps are host numbers of the machine that ran them. The
tool writes only --out (default ./timing_model.json) and never rewrites
the port's shipped copy (accl_tpu_torch/data/timing_model.json).

Usage:
    python -m accl_tpu_torch.tools.timing_model --sweep-dir sweep/
    python -m accl_tpu_torch.tools.timing_model --sweep-dir sweep/ \\
        --profile profile.csv --out model.json
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import sys

from ..constants import Operation, TuningParams
from ..sequencer.plan import select_algorithm
from ..sequencer.timing import (
    LinkParams,
    calibrate,
    coefficients_aggregate,
    predict,
    tuning_crossovers,
)
# the sweep's eager/rx geometry, single-sourced from the sweep tool so the
# calibration can never drift from what the sweep ran
from .bench_emulator import FIT_MAX_WORLD, MAX_EAGER, RX_BUF

OPS = {"allreduce": Operation.allreduce, "bcast": Operation.bcast,
       "allgather": Operation.allgather, "reduce": Operation.reduce,
       "gather": Operation.gather, "scatter": Operation.scatter,
       "alltoall": Operation.alltoall,
       "reduce_scatter": Operation.reduce_scatter}

TIER_NOTE = ("one card, no link: the world-1 rows time a facade "
             "allreduce's dispatch and datapath on the card (host clock "
             "with the sync), dispatch-bound, so the datapath beta clamps "
             "to inf when dispatch swamps it; the stream rows are the "
             "port's combine kernel over 3 HBM streams; ici unmeasured")


def load_rows(path: pathlib.Path, default_world: int):
    """Rows inside the calibration domain (worlds <= FIT_MAX_WORLD:
    larger worlds are scale evidence, not fit input), plus the count of
    rows the domain excluded."""
    rows = []
    beyond = 0
    with open(path) as f:
        for r in csv.DictReader(f):
            op = OPS.get(r["Collective"])
            if op is None:
                continue
            world = int(r.get("World") or default_world)
            if world > FIT_MAX_WORLD:
                beyond += 1
                continue
            rows.append((op, int(r["Bytes"]), float(r["Seconds"]), world))
    return rows, beyond


def tpu_tier(profile) -> dict | None:
    """The on-chip calibration tier of a device profile (a CSV of
    Test,Bytes,Seconds,GBps,Regime), or None when the file is missing or
    has no world-1 dispatch row. Measured quantities only:

      - dispatch alpha: an alpha-beta fit over the world-1 dispatch rows
        (on a dispatch-bound device the fit clamps beta to ~inf, which is
        itself the finding, and alpha is then the rows' median);
      - HBM stream rate: the median payload GB/s of the streaming-regime
        combine rows.

    A link beta needs more than one device and is reported unmeasured.
    Rows of Regime "noise" (the timer's resolution floor) are skipped."""
    profile = pathlib.Path(profile)
    if not profile.exists():
        return None
    disp, hbm = [], []
    with open(profile) as f:
        for r in csv.DictReader(f):
            if r.get("Regime") == "noise":
                continue
            if "_w1_dispatch_datapath" in r["Test"]:
                disp.append((1.0, float(r["Bytes"]), float(r["Seconds"])))
            elif r["Test"] == "combine_sum_fp32" and \
                    r.get("Regime") == "stream":
                hbm.append(float(r["GBps"]))
    if not disp:
        return None
    params = calibrate(disp)
    alpha = params.alpha
    if params.beta >= 1e11:
        # pure-latency fit (beta clamped at inf): the least-squares alpha
        # can overshoot every sample when the raw slope was negative; the
        # median dispatch time is the honest constant
        times = sorted(t for _, _, t in disp)
        alpha = times[len(times) // 2]
    tier = {
        "source": str(profile.name),
        "dispatch_alpha_us": alpha * 1e6,
        "dispatch_beta_gbps": (None if params.beta >= 1e11
                               else params.beta / 1e9),
        "hbm_stream_gbps": (sorted(hbm)[len(hbm) // 2] if hbm else None),
        "ici_beta_gbps": None,
        "note": TIER_NOTE,
    }
    # crossovers under the device's dispatch cost, a projection: the wire
    # beta is the HBM stream rate, an upper limit on any link tier
    if tier["hbm_stream_gbps"]:
        proj = LinkParams(alpha=alpha, beta=tier["hbm_stream_gbps"] * 1e9)
        tier["projected_crossovers"] = tuning_crossovers(proj, world=8)
    return tier


def _fit_per_collective(meta):
    """meta: (op, plan, count, nbytes, secs, world). One LinkParams per
    collective, fitted on the AGGREGATE (serialized-host) cost shape
    (timing.coefficients_aggregate): the emulator world timeshares the
    host's cores, so wall time tracks the total moved bytes and messages,
    and a fit per collective absorbs each algorithm family's own cost per
    message (a bcast tree hop is a light relay, an allgather hop a full
    chunk landing)."""
    groups = {}
    for op, plan, count, nbytes, secs, world in meta:
        m, b = coefficients_aggregate(op, plan, count, 4, world,
                                      rx_buf_bytes=RX_BUF)
        groups.setdefault(op.name, []).append((m, b, secs))
    return {name: calibrate(samples) for name, samples in groups.items()}


def _predict_row(fits, op, plan, count, nbytes, world):
    return predict(fits[op.name], op, plan, count, 4, world,
                   rx_buf_bytes=RX_BUF, aggregate=True)


def _plan_rows(rows, tuning):
    """Each (op, bytes, secs, world) row with its plan and count."""
    meta = []
    for op, nbytes, secs, world in rows:
        count = nbytes // 4
        plan = select_algorithm(op, count, 4, world,
                                max_eager_size=MAX_EAGER,
                                eager_rx_buf_size=RX_BUF, tuning=tuning)
        meta.append((op, plan, count, nbytes, secs, world))
    return meta


def _holdout_ratios(meta, worlds):
    """Leave-one-world-out: each world's rows predicted by a model fitted
    without them (generalization, not curve memorization)."""
    ratios = []
    if len(worlds) < 2:
        return ratios
    for held in worlds:
        train = [m for m in meta if m[5] != held]
        test = [m for m in meta if m[5] == held]
        try:
            hfits = _fit_per_collective(train)
        except ValueError:  # a degenerate fit (numpy's LinAlgError)
            continue
        for op, plan, count, nbytes, secs, world in test:
            if op.name not in hfits or not secs:
                continue
            ratios.append(_predict_row(hfits, op, plan, count, nbytes,
                                       world) / secs)
    return sorted(ratios)


def fit_tier(src: pathlib.Path, default_world: int, tuning) -> dict | None:
    """One POE's own link parameters (the datagram POE pays per-packet
    costs, the in-process POE no sockets at all), fitted on its sweep
    within the calibration domain; None when the sweep is missing."""
    if not src.exists():
        return None
    trows, skipped = load_rows(src, default_world)
    tmeta = _plan_rows(trows, tuning)
    if not tmeta:
        return None
    tfits = _fit_per_collective(tmeta)
    tratios = sorted(
        _predict_row(tfits, op, plan, count, nbytes, world) / secs
        for op, plan, count, nbytes, secs, world in tmeta if secs)
    return {
        "source": src.name,
        "link_per_collective": {
            name: {"alpha_us": p.alpha * 1e6, "beta_gbps": p.beta / 1e9}
            for name, p in sorted(tfits.items())
        },
        "fit": {"rows": len(tmeta),
                "rows_beyond_domain": skipped,
                "calibration_domain": f"worlds <= {FIT_MAX_WORLD}",
                "median_pred_over_meas":
                    (tratios[len(tratios) // 2] if tratios else None)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4,
                    help="world size of the sweep, used only for CSVs "
                         "written before the World column existed")
    ap.add_argument("--sweep-dir", default=".",
                    help="directory of bench_emulator's emu_bench*.csv")
    ap.add_argument("--profile", default=None,
                    help="a device profile (Test,Bytes,Seconds,GBps,Regime) "
                         "to fit the on-chip tier from; none by default")
    ap.add_argument("--out", default="timing_model.json")
    args = ap.parse_args(argv)

    sweep_dir = pathlib.Path(args.sweep_dir)
    src = sweep_dir / "emu_bench.csv"
    if not src.exists():
        print(f"no {src}; run python -m accl_tpu_torch.tools."
              "bench_emulator first", file=sys.stderr)
        return 1
    rows, main_beyond = load_rows(src, args.world)
    if not rows:
        print(f"{src} has no usable collective rows; re-run "
              "python -m accl_tpu_torch.tools.bench_emulator",
              file=sys.stderr)
        return 1
    tuning = TuningParams.default()
    meta = _plan_rows(rows, tuning)

    # per-collective aggregate-shape fits on the full sweep (the reported
    # model) and the leave-one-world-out holdout
    fits = _fit_per_collective(meta)
    report = []
    for op, plan, count, nbytes, secs, world in meta:
        pred = _predict_row(fits, op, plan, count, nbytes, world)
        report.append({
            "collective": op.name, "bytes": nbytes, "world": world,
            "algorithm": plan.algorithm.name,
            "measured_s": secs, "predicted_s": pred,
            "ratio": pred / secs if secs else None,
        })
    ratios = sorted(r["ratio"] for r in report if r["ratio"])
    med = ratios[len(ratios) // 2]
    worlds = sorted({m[5] for m in meta})
    holdout_ratios = _holdout_ratios(meta, worlds)
    med_holdout = (holdout_ratios[len(holdout_ratios) // 2]
                   if holdout_ratios else None)

    # crossovers reason over critical-path shapes; feed them the bcast
    # link, the root-serialized collective whose aggregate and critical
    # shapes coincide (its alpha/beta are genuine per-message and
    # per-byte costs of the host, not world-summed ones)
    cross_params = fits.get("bcast") or next(iter(fits.values()))
    cross = tuning_crossovers(cross_params, world=8)
    out = {
        "source": str(src),
        "cost_shape": "aggregate (serialized single-core host; see "
                      "timing.coefficients_aggregate)",
        "link_per_collective": {
            name: {"alpha_us": p.alpha * 1e6, "beta_gbps": p.beta / 1e9,
                   "rows": sum(1 for r in report
                               if r["collective"] == name)}
            for name, p in sorted(fits.items())
        },
        "fit": {"rows": len(report), "median_pred_over_meas": med,
                "median_holdout_pred_over_meas": med_holdout,
                "holdout": "leave-one-world-out",
                "worlds": worlds,
                "rows_beyond_domain": main_beyond,
                "calibration_domain": f"worlds <= {FIT_MAX_WORLD}"},
        "rows": report,
        "local_poe_tier": fit_tier(sweep_dir / "emu_bench_local.csv",
                                   args.world, tuning),
        "udp_poe_tier": fit_tier(sweep_dir / "emu_bench_udp.csv",
                                 args.world, tuning),
        "tuning_crossovers": cross,
        "tpu_tier": tpu_tier(args.profile) if args.profile else None,
        "reference_defaults": {
            "bcast_flat_tree_max_ranks": 3,
            "reduce_flat_tree_max_ranks": 4,
            "reduce_flat_tree_max_count_bytes": 32 * 1024,
            "gather_flat_tree_max_count_bytes": 32 * 1024,
        },
    }
    dst = pathlib.Path(args.out)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(json.dumps(out, indent=1) + "\n")
    for reg, p in sorted(fits.items()):
        print(f"{reg}: alpha={p.alpha*1e6:.1f}us "
              f"beta={p.beta/1e9:.3f}GB/s")
    print(f"median pred/meas={med:.2f} holdout="
          f"{med_holdout and round(med_holdout, 2)} -> {dst}")
    print(f"crossovers: {cross}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
