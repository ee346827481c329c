"""Trace exporter / validator CLI for the port's telemetry.

Counterpart of tools/accl_trace.py, with its modes, printed lines and exit
codes. A thin client of accl_tpu_torch.telemetry: it takes a SPAN v1
trace document (either package's tracer writes one) and

  --validate            check it against the event contract
                        (telemetry.export.EVENT_SCHEMA, through the
                        port's own validator)
  --chrome OUT          export Chrome trace-event JSON (Perfetto /
                        chrome://tracing loadable, one track per
                        rank/executor)
  --residuals           print the predicted-vs-measured residual table
                        and the default-vs-refit calibration summary
  --metrics             replay the trace through the streaming metrics
                        registry + drift sentinel (the live observer's
                        span -> metrics rule) and print the Prometheus
                        exposition, the sentinel verdict and the
                        straggler report; cross-checks the replayed call
                        counts against a metrics snapshot embedded in the
                        trace meta when one is present (--window sizes
                        the replay sentinel)
  --selftest            run the full contract against the port's copy of
                        the committed golden trace
                        (accl_tpu_torch/data/golden_trace.json): schema
                        validation, Chrome conversion structure, the
                        feedback-loop invariant, the per-tier refit and
                        the sentinel's verdict
  --make-golden         regenerate that copy from make_golden()
                        (deterministic synthetic spans). make_golden()
                        is the reference's, span for span; its meta
                        (metrics, drift_sentinel) is not the committed
                        file's, so regenerate only after an intentional
                        schema change

The tool computes nothing on tensors, so it takes no --device.
Exit code 0 = every requested check passed.

Usage:
    python -m accl_tpu_torch.tools.accl_trace --selftest
    python -m accl_tpu_torch.tools.accl_trace trace.json --validate \\
        --residuals --chrome trace.chrome.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "data" / \
    "golden_trace.json"

# sentinel window for the golden trace's drift segment (16 stable +
# 12 shifted alltoall spans): small enough that the shifted tail owns
# the rolling median, the regression the selftest pins
GOLDEN_SENTINEL_WINDOW = 16


def make_golden() -> dict:
    """Deterministic synthetic trace exercising every span category the
    emitters produce: facade calls, sequence + phases + steps, and
    native per-rank spans whose measurements follow a known link
    (alpha=120us, beta=0.8 GB/s) with deterministic multiplicative
    skew — so calibrate_from_trace provably recovers a better fit than
    the 'shipped default' embedded in meta."""
    from ..telemetry.tracer import SCHEMA_VERSION

    spans = []
    t = 1_000_000
    # facade call + sequence machinery spans
    spans.append({"name": "allreduce", "cat": "call", "track": "facade",
                  "ts_ns": t, "dur_ns": 2_000_000,
                  "args": {"op": "allreduce", "count": 4096,
                           "algorithm": "EAGER_RING_RS_AG",
                           "predicted_s": 0.0019, "retcode": 0}})
    sig = "deadbeefcafef00d"
    for name, dur in (("record", 50_000), ("lint", 400_000),
                      ("compile", 3_000_000), ("dispatch", 1_500_000)):
        t += 100_000
        spans.append({"name": name, "cat": "phase", "track": "device",
                      "ts_ns": t, "dur_ns": dur,
                      "args": {"signature": sig}})
    for i, op in enumerate(("reduce_scatter", "allgather")):
        spans.append({"name": f"step{i}:{op}", "cat": "step",
                      "track": "device", "ts_ns": t, "dur_ns": 0,
                      "args": {"op": op, "step": i, "signature": sig,
                               "predicted_s": 0.001 * (i + 1)}})
    spans.append({"name": "sequence", "cat": "sequence", "track": "facade",
                  "ts_ns": t, "dur_ns": 6_000_000,
                  "args": {"n_steps": 2, "signature": sig,
                           "predicted_s": 0.003}})
    # native spans: measured = true_link(m, b) * skew, skew cycling over
    # a fixed pattern; the golden default is deliberately off by 2x beta
    alpha, beta = 120e-6, 0.8e9
    default = {"alpha_us": 40.0, "beta_gbps": 2.4}
    skews = (0.9, 1.0, 1.1, 1.05, 0.95)
    k = 0
    for rank in range(4):
        t0 = 2_000_000
        for m, b in ((8.0, 65536.0), (16.0, 262144.0), (32.0, 2097152.0),
                     (64.0, 8388608.0)):
            true_s = alpha * m + b / beta
            meas = true_s * skews[k % len(skews)]
            k += 1
            dur = int(meas * 1e9)
            spans.append({
                "name": "allreduce", "cat": "native",
                "track": f"emu/r{rank}", "ts_ns": t0, "dur_ns": dur,
                "args": {"op": "allreduce", "count": int(b // 4),
                         "bytes": int(b), "world": 4, "rank": rank,
                         "retcode": 0, "detail": 0,
                         "measured_s": meas,
                         "coef_messages": m, "coef_bytes": b,
                         "predicted_s": default["alpha_us"] * 1e-6 * m
                         + b / (default["beta_gbps"] * 1e9),
                         "d_passes": 4, "d_parks": 3,
                         "d_seek_hit": 4, "d_seek_miss": 3}})
            t0 += dur + 50_000
    # tier-tagged native spans (args["tier"], SPAN v1-compatible detail
    # key): two tiers with DELIBERATELY different true links, so the
    # selftest can prove calibrate_tiers_from_trace recovers each from
    # exactly its own labeled samples (an unlabeled/pooled fit would
    # average them)
    tier_true = {"inner": (2e-6, 4.0e9), "outer": (200e-6, 0.1e9)}
    for tier, (ta, tb) in tier_true.items():
        t0 = 40_000_000
        for rank in range(2):
            for m, b in ((4.0, 131072.0), (8.0, 1048576.0),
                         (16.0, 4194304.0)):
                meas = (ta * m + b / tb) * skews[k % len(skews)]
                k += 1
                dur = int(meas * 1e9)
                spans.append({
                    "name": "reduce_scatter" if tier == "inner"
                    else "allreduce",
                    "cat": "native", "track": f"hier/{tier}/r{rank}",
                    "ts_ns": t0, "dur_ns": dur,
                    "args": {"op": "reduce_scatter" if tier == "inner"
                             else "allreduce",
                             "count": int(b // 4), "bytes": int(b),
                             "world": 4, "rank": rank, "tier": tier,
                             "retcode": 0, "detail": 0,
                             "measured_s": meas,
                             "coef_messages": m, "coef_bytes": b,
                             "d_passes": 2, "d_parks": 1,
                             "d_seek_hit": 2, "d_seek_miss": 1}})
                t0 += dur + 50_000
    # drift-sentinel segment (op "alltoall", used by no other golden
    # span): ACCURATE predictions in the stable regime — rank 3 runs a
    # deliberate 1.5x slow (the straggler the per-rank attribution must
    # name) — then a 4x regime shift under the SAME stale prediction.
    # No coef_* keys: these spans demo the band-leave verdict and must
    # not contaminate the calibration-invariant sample set above.
    at_true, at_count = 3e-3, 8192
    jit = (0.97, 1.0, 1.03)
    t0 = 80_000_000
    at_spans = []
    for wave in range(4):  # stable regime: 4 waves x 4 ranks
        for rank in range(4):
            meas = at_true * (1.5 if rank == 3 else 1.0) \
                * jit[(wave + rank) % len(jit)]
            at_spans.append((rank, meas, "stable"))
    for wave in range(3):  # regime shift: 3 waves x 4 ranks, 4x slower
        for rank in range(4):
            meas = at_true * 4.0 * jit[(wave + rank) % len(jit)]
            at_spans.append((rank, meas, "shifted"))
    for rank, meas, regime in at_spans:
        dur = int(meas * 1e9)
        spans.append({
            "name": "alltoall", "cat": "native",
            "track": f"emu/r{rank}", "ts_ns": t0, "dur_ns": dur,
            "args": {"op": "alltoall", "count": at_count,
                     "bytes": at_count * 4, "world": 4, "rank": rank,
                     "retcode": 0, "detail": 0, "measured_s": meas,
                     "predicted_s": at_true, "regime": regime,
                     "d_passes": 1, "d_parks": 0,
                     "d_seek_hit": 1, "d_seek_miss": 0}})
        t0 += dur + 25_000
    meta = {"golden": True, "drops": 0,
            "default_link": default,
            "sentinel_window": GOLDEN_SENTINEL_WINDOW,
            "tier_true_links": {
                t: {"alpha_us": a * 1e6, "beta_gbps": bb / 1e9}
                for t, (a, bb) in tier_true.items()}}
    # embed the metrics snapshot + sentinel report the always-on layer
    # would serve for exactly these spans (Tracer.to_trace's posture),
    # so --selftest covers the meta keys every exported trace now ships
    from ..telemetry.metrics import (
        DriftSentinel,
        MetricsObserver,
        MetricsRegistry,
        replay_trace,
    )

    obs = replay_trace({"spans": spans}, MetricsObserver(
        MetricsRegistry(), DriftSentinel(window=GOLDEN_SENTINEL_WINDOW)))
    meta.update(obs.trace_meta())
    return {"schema": SCHEMA_VERSION, "meta": meta, "spans": spans}


def cmd_validate(trace: dict) -> None:
    from ..telemetry import validate_trace

    validate_trace(trace)
    print(f"schema OK: {len(trace['spans'])} spans, "
          f"{len({s['track'] for s in trace['spans']})} tracks")


def cmd_chrome(trace: dict, out: str) -> None:
    from ..telemetry import to_chrome

    chrome = to_chrome(trace)
    pathlib.Path(out).write_text(json.dumps(chrome, indent=1))
    print(f"wrote {out} ({len(chrome['traceEvents'])} events)")


def cmd_metrics(trace: dict, window: int) -> int:
    """Replay a trace through the metrics registry + drift sentinel
    and print what the always-on layer would be serving live."""
    from ..telemetry.metrics import (
        DriftSentinel,
        MetricsObserver,
        MetricsRegistry,
        replay_trace,
    )

    obs = replay_trace(trace, MetricsObserver(
        MetricsRegistry(), DriftSentinel(window=window)))
    text = obs.registry.expose_text()
    print(text, end="")
    rep = obs.sentinel.report()
    flagged = rep["flagged"]
    print(f"drift sentinel (window {window}): "
          f"{len(rep['verdict'])} op(s), flagged={flagged or 'none'}")
    for op, row in rep["verdict"].items():
        band = (f" band<={row['band_hi']:.3f} "
                f"{'OUT-OF-BAND' if not row['in_band'] else 'in band'}"
                if row.get("armed") else " (unarmed)")
        print(f"  {op:20s} n={row['n']:<4d} median rel err "
              f"{row['median_rel_err']:.3f}{band}")
    for w in rep["stragglers"]:
        print(f"  straggler {w['op']}/{w['count']}: rank "
              f"{w['straggler_rank']} at {w['skew']:.2f}x the "
              f"median-of-ranks ({w['ranks']} ranks)")
    embedded = trace.get("meta", {}).get("metrics")
    if embedded is not None:
        # the snapshot embedded at export time and this offline replay
        # run the same rule: their call counts must agree, or the
        # emitters and the replay path have drifted apart
        def total(snap):
            return sum(r["value"] for r in
                       snap.get("counters", {}).get("accl_calls_total", []))

        got = total(obs.registry.snapshot())
        want = total(embedded)
        if got != want:
            print(f"FAIL: replayed call count {got:g} != embedded "
                  f"snapshot {want:g}", file=sys.stderr)
            return 1
        print(f"embedded snapshot cross-check OK ({got:g} calls)")
    return 0


def cmd_residuals(trace: dict) -> None:
    from ..telemetry import residual_report

    report = residual_report(trace)
    sr = report["span_residuals"]
    med = sr["median_rel_err"]
    print(f"spans with predictions: {sr['rows']}  "
          f"median |pred-meas|/meas: "
          f"{'n/a' if med is None else f'{med:.3f}'}")
    for op, err in sr["per_op_median_rel_err"].items():
        print(f"  {op:20s} {err:.3f}")
    cal = report["calibration"]
    if "error" in cal:
        print(f"calibration: {cal['error']}")
    else:
        print(f"calibration over {cal['samples']} samples: refit alpha "
              f"{cal['refit']['alpha_us']:.1f} us beta "
              f"{cal['refit']['beta_gbps']:.3f} GB/s -> median rel err "
              f"{cal['median_rel_err_refit']:.3f}"
              + (f" (default {cal['median_rel_err_default']:.3f}, "
                 f"improved={cal['improved']})"
                 if "median_rel_err_default" in cal else ""))


def cmd_selftest() -> int:
    """The committed-golden contract: schema, Chrome structure, residual
    machinery, and the feedback-loop invariant."""
    from ..sequencer.timing import LinkParams
    from ..telemetry import (calibrate_from_trace, residual_rows,
                                    to_chrome, validate_trace)
    from ..telemetry.export import median
    from ..telemetry.feedback import _rel_errs

    if not GOLDEN.exists():
        print(f"FAIL: no committed golden trace at {GOLDEN}",
              file=sys.stderr)
        return 1
    trace = json.loads(GOLDEN.read_text())
    validate_trace(trace)
    chrome = to_chrome(trace)
    names = [e for e in chrome["traceEvents"] if e["ph"] == "M"]
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert len(names) == len({s["track"] for s in trace["spans"]}), \
        "one thread_name metadata event per track"
    assert len(xs) == len(trace["spans"]), "one X event per span"
    assert all(e["dur"] > 0 for e in xs), "zero-duration spans stretched"
    rows = residual_rows(trace)
    assert rows, "golden trace must carry predicted-vs-measured rows"
    # feedback-loop invariant: refitting on the golden measurements beats
    # the deliberately-skewed default link embedded in its meta
    d = trace["meta"]["default_link"]
    default = LinkParams(alpha=d["alpha_us"] * 1e-6,
                         beta=d["beta_gbps"] * 1e9)
    refit = calibrate_from_trace(trace)
    e_ref = median(_rel_errs(trace, refit))
    e_def = median(_rel_errs(trace, default))
    assert e_ref < e_def, \
        f"refit {e_ref:.3f} must beat golden default {e_def:.3f}"
    # tier-tagged spans (args["tier"]): Chrome tracks split by tier and
    # the per-tier refit recovers each tier's DISTINCT true link from
    # exactly its own labeled samples — a pooled (unlabeled) fit would
    # average the fast and slow tiers together
    from ..telemetry import calibrate_tiers_from_trace

    tier_tracks = {s["track"] for s in trace["spans"]
                   if s["args"].get("tier")}
    assert any("inner" in t for t in tier_tracks) and \
        any("outer" in t for t in tier_tracks), \
        "golden trace must carry tier-tagged spans on split tracks"
    tiers = calibrate_tiers_from_trace(trace)
    true = trace["meta"]["tier_true_links"]
    for tier, fit in (("inner", tiers.inner), ("outer", tiers.outer)):
        want = true[tier]["beta_gbps"] * 1e9
        assert abs(fit.beta - want) / want < 0.25, \
            f"{tier} refit beta {fit.beta / 1e9:.2f} GB/s far from " \
            f"true {want / 1e9:.2f}"
    assert tiers.inner.beta > 10 * tiers.outer.beta, \
        "per-tier refit must keep the fast and slow links apart"
    # the always-on observability meta keys: the committed golden must
    # carry the metrics snapshot + sentinel report, the offline replay
    # must reproduce them (same rule, no drift), and the sentinel must
    # FLAG the embedded regime shift while attributing the deliberate
    # rank-3 straggler — the sensing contract, pinned on committed data
    from ..telemetry.metrics import (
        DriftSentinel,
        MetricsObserver,
        MetricsRegistry,
        replay_trace,
    )

    assert "metrics" in trace["meta"] and "drift_sentinel" in \
        trace["meta"], "golden meta must embed the observability keys"
    win = int(trace["meta"]["sentinel_window"])
    obs = replay_trace(trace, MetricsObserver(
        MetricsRegistry(), DriftSentinel(window=win)))
    def _calls(snap):
        return sum(r["value"] for r in
                   snap.get("counters", {}).get("accl_calls_total", []))
    assert _calls(obs.registry.snapshot()) == \
        _calls(trace["meta"]["metrics"]), \
        "offline metrics replay diverged from the embedded snapshot"
    flagged = obs.sentinel.flagged()
    assert flagged == ["alltoall"], \
        f"sentinel must flag exactly the shifted op, got {flagged}"
    v = obs.sentinel.verdict()["alltoall"]
    assert not v["in_band"] and v["median_rel_err"] > v["band_hi"]
    embedded_flags = trace["meta"]["drift_sentinel"]["flagged"]
    assert embedded_flags == ["alltoall"], \
        "embedded sentinel report must carry the same verdict"
    strag = [w for w in obs.sentinel.straggler_report()
             if w["op"] == "alltoall"]
    assert strag and strag[0]["straggler_rank"] == 3 and \
        strag[0]["skew"] > 1.2, \
        "per-rank attribution must name the deliberate rank-3 straggler"
    print(f"selftest OK: {len(trace['spans'])} golden spans, "
          f"{len(names)} tracks, refit median rel err {e_ref:.3f} < "
          f"default {e_def:.3f}; tier refit inner "
          f"{tiers.inner.beta / 1e9:.2f} GB/s / outer "
          f"{tiers.outer.beta / 1e9:.3f} GB/s; sentinel flagged "
          f"{flagged} (straggler r{strag[0]['straggler_rank']} at "
          f"{strag[0]['skew']:.2f}x)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="?",
                    default=str(REPO / "accl_log" / "trace.json"))
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--chrome", metavar="OUT")
    ap.add_argument("--residuals", action="store_true")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--window", type=int, default=GOLDEN_SENTINEL_WINDOW,
                    help="drift-sentinel rolling window for --metrics "
                         "replay (default %(default)s)")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--make-golden", action="store_true")
    args = ap.parse_args(argv)

    if args.make_golden:
        from ..telemetry import validate_trace

        trace = make_golden()
        validate_trace(trace)
        GOLDEN.write_text(json.dumps(trace, indent=1))
        print(f"wrote {GOLDEN} ({len(trace['spans'])} spans)")
        return 0
    if args.selftest:
        return cmd_selftest()

    trace = json.loads(pathlib.Path(args.trace).read_text())
    ran = False
    if args.validate or not (args.chrome or args.residuals
                             or args.metrics):
        cmd_validate(trace)
        ran = True
    if args.chrome:
        cmd_chrome(trace, args.chrome)
        ran = True
    if args.residuals:
        cmd_residuals(trace)
        ran = True
    if args.metrics:
        rc = cmd_metrics(trace, args.window)
        if rc:
            return rc
        ran = True
    return 0 if ran else 2


if __name__ == "__main__":
    sys.exit(main())
