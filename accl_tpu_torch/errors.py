"""Typed host-side errors: the facade's validation contract.

Counterpart of accl_tpu/errors.py. Every host-side precondition failure
raises a typed error whose `lint_code` names the static-analysis
diagnostic for the same defect, so callers and tests can pin the failure
class.
"""

from __future__ import annotations


class ACCLValidationError(ValueError):
    """Base class for host-side call/descriptor validation failures."""

    lint_code: str | None = None


class InvalidRootError(ACCLValidationError):
    """Root / src / dst rank outside the addressed communicator."""

    lint_code = "ACCL402"


class ZeroLengthBufferError(ACCLValidationError):
    """A data-plane call with a non-positive element count."""

    lint_code = "ACCL401"


class DtypeMismatchError(ACCLValidationError, NotImplementedError):
    """Operand/result dtypes disagree within one call (use compress_dtype
    for wire compression instead)."""

    lint_code = "ACCL401"


class SequenceReuseError(RuntimeError):
    """A completed SequenceRecorder handle was reused: recording into or
    re-running an executed batch."""


class LintError(ACCLValidationError):
    """A recorded descriptor batch failed static analysis with
    `lint="error"` (accl_tpu_torch/analysis/). Carries the structured
    diagnostics so callers and tests can inspect codes individually."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        lines = [f"sequence rejected by lint ({len(self.diagnostics)} "
                 "diagnostic(s)):"]
        lines += [f"  {d}" for d in self.diagnostics]
        lines.append("  (suppress with lint='warn' or lint='off')")
        super().__init__("\n".join(lines))

    @property
    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)


def notify_sticky_retcode(function_name: str, retcode: int, *,
                          detail: int = 0, rank: int | None = None,
                          count: int | None = None):
    """The dump-on-error seam of the sticky-retcode contract: every path
    that materializes a nonzero sticky error word (request completion in
    request.py) reports it here before raising. The flight recorder,
    when armed, emits an error marker span (the failing call's op name,
    count, rank and sticky retcode) through the span stream and freezes
    its last-N-spans-per-track rings into a self-contained post-mortem
    trace (telemetry.recorder.on_sticky_retcode).

    Never raises and costs one armed() predicate when observability is
    off: error reporting must not mask or slow the error."""
    try:
        from .telemetry import recorder

        return recorder.on_sticky_retcode(function_name, int(retcode),
                                          detail=detail, rank=rank,
                                          count=count)
    except Exception:
        return None
