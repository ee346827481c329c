"""The shipped timing model's loaders.

Counterpart of the loaders of accl_tpu/telemetry/feedback.py:
`default_link`, `default_tier_links` and `default_compute_fit` read the
port's copy of the reference's timing model
(accl_tpu_torch/data/timing_model.json, without the reference's TPU
section), the calibration ACCL.autotune and plan selection use when the
caller passes none. Its fits come from the reference's native emulator
and a CPU mesh, not from an NVIDIA card. Results, misses included, are
cached per (path, section) and re-read when the file's mtime moves (at
most one stat() per path and _STAT_TTL_S), as in the reference: plan
selection calls these per call.

The reference's trace calibration (calibrate_from_trace and its kin)
belongs to the port's telemetry slice and is not defined here.
"""

from __future__ import annotations

import json
import pathlib
import time

from ..sequencer.timing import ComputeFit, LinkParams, TierLinks

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
