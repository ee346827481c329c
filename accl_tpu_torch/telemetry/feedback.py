"""The measured-vs-predicted feedback loop, and the shipped timing
model's loaders.

Counterpart of accl_tpu/telemetry/feedback.py. timing.predict answers
"how long should this call take"; a trace answers "how long did it
take". This module closes the loop:

  - calibrate_from_trace(): spans that carry their aggregate cost
    coefficients (telemetry.native attaches coef_messages/coef_bytes)
    become timing.calibrate samples, yielding refit LinkParams (per tier
    with calibrate_tiers_from_trace; the overlap pipeline's compute term
    from compute-tagged spans with calibrate_compute_from_trace);
  - residual_improvement(): median |predicted - measured| / measured
    under the shipped default link against under the refit, over the
    same spans;
  - autotune_from_trace(): hands the refit link to ACCL.autotune, so the
    tuning registers the device consults move with the measurements.

`default_link`, `default_tier_links` and `default_compute_fit` read the
port's copy of the reference's timing model
(accl_tpu_torch/data/timing_model.json, without the reference's TPU
section), the calibration ACCL.autotune and plan selection use when the
caller passes none. Its fits come from the reference's native emulator
and a CPU mesh, not from an NVIDIA card. Results, misses included, are
cached per (path, section) and re-read when the file's mtime moves (at
most one stat() per path and _STAT_TTL_S), as in the reference: plan
selection calls these per call.
"""

from __future__ import annotations

import json
import pathlib
import time

from ..sequencer.timing import (
    ComputeFit,
    LinkParams,
    TierLinks,
    calibrate,
    calibrate_compute,
)
from .export import measured_seconds, median, residual_rows, residual_summary

MODEL_PATH = (pathlib.Path(__file__).resolve().parents[1] / "data"
              / "timing_model.json")


# (path, kind) -> (mtime_ns | None, last_stat_monotonic, value)
_default_link_cache: dict = {}
_MODEL_CACHE_MAX = 64
# how long a cache entry may serve without re-stat()ing the model file
_STAT_TTL_S = 0.5


def _mtime_ns(p: pathlib.Path) -> int | None:
    try:
        return p.stat().st_mtime_ns
    except OSError:
        return None


def _model_cache_get(p: pathlib.Path, kind: str, load):
    """Freshness-checked cache for loaded timing-model sections: a model
    file overwritten later in the process bumps its mtime and is re-read
    within _STAT_TTL_S; a missing file caches its negative result under
    mtime None."""
    key = (str(p), kind)
    now = time.monotonic()
    ent = _default_link_cache.get(key)
    if ent is not None and now - ent[1] < _STAT_TTL_S:
        return ent[2]
    mtime = _mtime_ns(p)
    if ent is not None and ent[0] == mtime:
        _default_link_cache[key] = (mtime, now, ent[2])
        return ent[2]
    value = load(p)
    if len(_default_link_cache) >= _MODEL_CACHE_MAX:
        _default_link_cache.clear()
    _default_link_cache[key] = (mtime, now, value)
    return value


def default_link(path=None) -> LinkParams | None:
    """The shipped emulator-tier LinkParams (the bcast per-collective
    fit, else the legacy single link); None when there is no model."""
    p = pathlib.Path(path) if path else MODEL_PATH
    return _model_cache_get(p, "link", _load_link)


def _load_link(p: pathlib.Path) -> LinkParams | None:
    # a malformed model degrades to "no default link", never to a
    # per-call crash on the selection path
    try:
        model = json.loads(p.read_text())
        lk = (model.get("link_per_collective", {}).get("bcast")
              or model.get("link"))
        if not lk:
            return None
        return LinkParams(alpha=lk["alpha_us"] * 1e-6,
                          beta=lk["beta_gbps"] * 1e9)
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def default_tier_links(path=None) -> TierLinks | None:
    """The shipped per-tier calibration (the model's `link_tiers`
    section); None when the model carries none, and then callers leave
    hierarchical selection off rather than invent a slow-tier model."""
    p = pathlib.Path(path) if path else MODEL_PATH
    return _model_cache_get(p, "tiers", _load_tier_links)


def _load_tier_links(p: pathlib.Path) -> TierLinks | None:
    try:
        model = json.loads(p.read_text())
        tiers = model.get("link_tiers")
        return TierLinks(
            inner=LinkParams(alpha=tiers["inner"]["alpha_us"] * 1e-6,
                             beta=tiers["inner"]["beta_gbps"] * 1e9),
            outer=LinkParams(alpha=tiers["outer"]["alpha_us"] * 1e-6,
                             beta=tiers["outer"]["beta_gbps"] * 1e9),
        )
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def default_compute_fit(path=None) -> ComputeFit | None:
    """The shipped compute-term calibration of the overlap pipeline (the
    model's `compute_fit` section); None when none is committed, and
    then the overlap register stays off."""
    p = pathlib.Path(path) if path else MODEL_PATH
    return _model_cache_get(p, "compute", _load_compute_fit)


def _load_compute_fit(p: pathlib.Path) -> ComputeFit | None:
    try:
        model = json.loads(p.read_text())
        cf = model["compute_fit"]
        return ComputeFit(
            alpha=cf["alpha_us"] * 1e-6, rate=cf["grad_gbps"] * 1e9)
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def hop_samples(trace: dict,
                tier: str | None = None) -> list[tuple[float, float, float]]:
    """(messages, bytes, measured_seconds) samples from every span that
    carries its aggregate cost coefficients and a positive measurement —
    the exact input shape timing.calibrate fits. `tier="inner"|"outer"`
    keeps only spans tagged with that tier (args["tier"], SPAN
    v1-compatible detail key), the labeled-sample source for the
    per-tier refit. `tier=None` — the flat fit — keeps only UNTAGGED
    spans: a tier-tagged span's measurement belongs to that tier's
    link, and pooling two links with different alpha/beta into one fit
    would average them into a model of neither (the exact failure the
    tier labels exist to prevent)."""
    samples = []
    for sp in trace.get("spans", []):
        if not isinstance(sp, dict):
            continue
        args = sp.get("args") or {}
        if "coef_messages" not in args or "coef_bytes" not in args:
            continue
        if args.get("tier") != tier:
            continue
        try:
            m = float(args["coef_messages"])
            b = float(args["coef_bytes"])
        except (TypeError, ValueError):
            continue  # partially-populated span: no calibratable cost
        if m <= 0 and b <= 0:
            continue  # cost-free spans (world==1 degenerate calls)
        t = measured_seconds(sp)
        if t <= 0:
            continue
        samples.append((m, b, t))
    return samples


def calibrate_from_trace(trace: dict, tier: str | None = None) -> LinkParams:
    """Refit LinkParams from a trace's measured hop spans (optionally
    only the spans tagged with one `tier`). Raises ValueError when the
    trace carries no calibratable spans (a trace from a run with
    tracing off, or pure host-phase spans)."""
    samples = hop_samples(trace, tier=tier)
    if len(samples) < 2:
        where = f" tagged tier={tier!r}" if tier else ""
        raise ValueError(
            f"trace has {len(samples)} calibratable span(s){where}; "
            "need >= 2 (spans with coef_messages/coef_bytes, as "
            "telemetry.native.native_event lifts them)")
    return calibrate(samples)


def calibrate_tiers_from_trace(trace: dict) -> TierLinks:
    """The per-tier form of calibrate_from_trace: each tier of a
    two-tier world refit INDEPENDENTLY from its own tier-tagged spans
    (args["tier"] == "inner" / "outer"), so the slow tier's alpha/beta
    are fit from its own measurements only, never averaged with the
    fast tier's."""
    return TierLinks(inner=calibrate_from_trace(trace, tier="inner"),
                     outer=calibrate_from_trace(trace, tier="outer"))


def compute_samples(trace: dict) -> list[tuple[float, float]]:
    """(operand_bytes, measured_seconds) samples from every span that
    carries a `compute_bytes` arg and a positive measurement — the
    busy-core term of the overlap pipeline (timing.ComputeFit), fitted
    from spans exactly like the link is fitted from hop spans: a compute
    stage timed at two or more sizes, each span tagged with the operand
    bytes it materializes."""
    samples = []
    for sp in trace.get("spans", []):
        if not isinstance(sp, dict):
            continue
        args = sp.get("args") or {}
        if "compute_bytes" not in args:
            continue
        try:
            b = float(args["compute_bytes"])
        except (TypeError, ValueError):
            continue
        t = measured_seconds(sp)
        if b <= 0 or t <= 0:
            continue
        samples.append((b, t))
    return samples


def calibrate_compute_from_trace(trace: dict) -> ComputeFit:
    """Refit the overlap pipeline's compute term from a trace's
    compute-tagged spans. Raises ValueError below two samples (a
    one-point fit cannot separate the fixed cost from the rate)."""
    samples = compute_samples(trace)
    if len(samples) < 2:
        raise ValueError(
            f"trace has {len(samples)} compute span(s); need >= 2 "
            "(spans with args.compute_bytes at distinct sizes)")
    return calibrate_compute(samples)


def _rel_errs(trace: dict, link: LinkParams) -> list[float]:
    errs = []
    for m, b, t in hop_samples(trace):
        pred = link.seconds(m, b)
        errs.append(abs(pred - t) / t)
    return errs


def residual_improvement(trace: dict,
                         default: LinkParams | None = None) -> dict:
    """Median relative residual under the shipped default link vs under
    the trace's own refit, over the same calibratable spans: if
    refitting on the very measurements cannot beat the shipped
    constants, the feedback loop is broken (or the cost shapes
    regressed)."""
    if default is None:
        default = default_link()
    refit = calibrate_from_trace(trace)
    out = {
        "samples": len(hop_samples(trace)),
        "refit": {"alpha_us": refit.alpha * 1e6,
                  "beta_gbps": refit.beta / 1e9},
        "median_rel_err_refit": median(_rel_errs(trace, refit)),
    }
    if default is not None:
        out["default"] = {"alpha_us": default.alpha * 1e6,
                          "beta_gbps": default.beta / 1e9}
        out["median_rel_err_default"] = median(_rel_errs(trace, default))
        out["improved"] = (out["median_rel_err_refit"]
                           <= out["median_rel_err_default"])
    return out


def autotune_from_trace(accl, trace: dict, **autotune_kw):
    """Close the loop into the tuning registers: refit LinkParams from
    the trace and apply ACCL.autotune with them. Returns the applied
    TuningParams (the registers the device now consults per call)."""
    link = calibrate_from_trace(trace)
    return accl.autotune(link=link, **autotune_kw)


def residual_report(trace: dict) -> dict:
    """The residual section of a traced run: the span-level residual
    summary (spans carrying predicted_s) plus the
    default-vs-refit improvement over the calibratable samples."""
    rows = residual_rows(trace)
    report = {"span_residuals": residual_summary(rows)}
    try:
        report["calibration"] = residual_improvement(trace)
    except ValueError as e:
        report["calibration"] = {"error": str(e)}
    return report
