"""Telemetry of the port: tracing, metrics, the flight recorder and the
calibration loop.

Counterpart of accl_tpu/telemetry/, with the same exports and the same
SPAN v1 event schema, so a trace made by either package reads in the
other:

  - the host tracer (telemetry.tracer) collects the facade's call spans
    and a call sequence's record -> lint -> compile -> dispatch phases
    and per-step markers, each carrying its timing.predict estimate
    where one exists;
  - telemetry.export renders Chrome trace-event JSON (one track per
    span track, Perfetto-loadable) and the predicted-vs-measured
    residual table, and validates a trace against EVENT_SCHEMA;
  - telemetry.feedback closes the loop: measured spans -> timing.
    calibrate samples -> refit LinkParams -> ACCL.autotune;
  - telemetry.native lifts raw per-call records (opcode, bytes, device
    duration) into spans with their plan and cost coefficients.

On top rides the always-on layer (metrics.py, recorder.py), fed at
span-emission time through the tracer's observer seam: the streaming
metrics registry with its Prometheus text exposition, the drift
sentinel, and the flight recorder, which freezes a post-mortem on any
sticky nonzero retcode (errors.notify_sticky_retcode) without tracing
ever having been enabled.

Host tracing is off by default (ACCL_TELEMETRY=1 or telemetry.enable());
the always-on layer is on by default (ACCL_OBS=0 opts out). On the card
neither touches a device tensor: a span's prediction is host arithmetic
and its duration the host clock around a call that already waits on its
CUDA event.
"""

import os as _os

from .tracer import (  # noqa: F401
    DEFAULT_CAPACITY,
    SCHEMA_VERSION,
    Tracer,
    disable,
    enable,
    get_tracer,
)
from .export import (  # noqa: F401
    EVENT_SCHEMA,
    WIRE_FAULT_KEYS,
    read_trace,
    residual_rows,
    residual_summary,
    to_chrome,
    validate_trace,
    wire_health_report,
    wire_health_rows,
    write_trace,
)
from .feedback import (  # noqa: F401
    autotune_from_trace,
    calibrate_compute_from_trace,
    calibrate_from_trace,
    calibrate_tiers_from_trace,
    default_compute_fit,
    default_link,
    default_tier_links,
    residual_improvement,
    residual_report,
)
from . import native  # noqa: F401
from . import metrics  # noqa: F401
from . import recorder  # noqa: F401
from .metrics import (  # noqa: F401
    DriftSentinel,
    MetricsRegistry,
    get_registry,
    get_sentinel,
    replay_trace,
)
from .recorder import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    last_error_trace,
)


def enable_observability() -> None:
    """Arm the always-on layer: install the process-wide metrics
    observer and flight recorder on the process tracer. Spans go live
    (the emission seam feeds them) but the trace ring still only
    collects under ACCL_TELEMETRY/enable()."""
    metrics.install(get_tracer())
    recorder.install(get_tracer())


def disable_observability() -> None:
    """Detach the metrics observer and the flight recorder."""
    metrics.uninstall(get_tracer())
    recorder.uninstall(get_tracer())


def observability_enabled() -> bool:
    return recorder.armed()


# always-on by default: the metrics registry and flight recorder are
# bounded and cost about a dict hit and a deque append per span
if _os.environ.get("ACCL_OBS", "1") not in ("", "0", "false", "off"):
    enable_observability()
