"""Diagnostic codes and records for the sequence linter.

Counterpart of accl_tpu/analysis/diagnostics.py, with the same stable
codes, so a batch the reference rejects names the same defect here:

  ACCL1xx  dataflow hazards over the canonical buffer renaming
  ACCL2xx  protocol defects (send/recv matching, deadlock)
  ACCL3xx  overlap-slot / collective_id resource defects
  ACCL4xx  descriptor validation (shape, dtype, root, communicator)
  ACCL5xx  semantic defects: the batch's final contribution sets differ
           from the declared collective
  ACCL6xx  cross-program interference

The port's default tier emits ACCL1xx and ACCL4xx (linter.py); the
table keeps every code so the codes stay the reference's.

Severity: an `error` is a batch the analyzer can prove wrong; a
`warning` is a batch whose sequential semantics are well defined but
that races on an executor free to overlap unordered steps.
`lint="error"` raises on errors and logs warnings; `lint="warn"` logs
both.
"""

from __future__ import annotations

import dataclasses

from ..errors import LintError
from ..utils.logging import Log

__all__ = ["CODES", "Diagnostic", "LintError", "make", "enforce"]

# code -> (kebab-case name, default severity, one-line description)
CODES: dict[str, tuple[str, str, str]] = {
    "ACCL101": ("raw-hazard", "error",
                "read extends past the region the producing step wrote "
                "(fresh prefix + stale tail)"),
    "ACCL102": ("war-hazard", "warning",
                "write to a buffer an earlier unordered step still reads"),
    "ACCL103": ("waw-hazard", "warning",
                "two unordered steps write the same buffer"),
    "ACCL201": ("unmatched-sendrecv", "error",
                "send or recv with no matching partner (or mismatched "
                "payload counts)"),
    "ACCL202": ("deadlock-cycle", "error",
                "circular wait among blocking sends/recvs/collectives"),
    "ACCL203": ("tag-mismatch", "error",
                "send/recv pair on one edge whose tags can never match"),
    "ACCL204": ("perm-conflict", "error",
                "malformed permute hop: duplicate or out-of-range "
                "source/destination"),
    "ACCL205": ("wildcard-race", "error",
                "a wildcard recv (TAG_ANY / any-source) matches different "
                "sends across legal match orders: the delivered data is "
                "schedule-dependent"),
    "ACCL206": ("schedule-dependent-deadlock", "error",
                "some legal match order reaches a stuck state although "
                "the canonical schedule completes"),
    "ACCL207": ("modelcheck-truncated", "warning",
                "exhaustive interleaving exploration hit its state or "
                "wall-clock budget: the deep verdict covers only the "
                "explored prefix"),
    "ACCL301": ("slot-collision", "error",
                "two live schedule instances share a collective_id slot "
                "with no ordering between them"),
    "ACCL302": ("slot-overcommit", "error",
                "overlap window larger than the kernel's independent "
                "slot resources"),
    "ACCL401": ("dtype-shape-mismatch", "error",
                "dtype or element-count inconsistency across the batch"),
    "ACCL402": ("root-out-of-range", "error",
                "root/src/dst rank outside the addressed communicator"),
    "ACCL403": ("comm-mismatch", "error",
                "steps address different communicators"),
    "ACCL404": ("not-sequenceable", "error",
                "descriptor kind cannot ride a fused call sequence"),
    "ACCL405": ("buffer-underflow", "error",
                "registered buffer narrower than the widths the batch "
                "needs"),
    "ACCL406": ("quantized-lane-mismatch", "error",
                "blockwise-quantized wire requested for a payload dtype "
                "with no quantized lane (or a wire dtype with no "
                "arithmetic-configuration row)"),
    "ACCL501": ("wrong-result", "error",
                "a rank's final contribution set differs from the "
                "declared collective (misrouted regions, foreign atoms, "
                "or the wrong reduction)"),
    "ACCL502": ("partial-contribution", "error",
                "some rank's input never reaches an output region the "
                "collective says must include it"),
    "ACCL503": ("double-count", "error",
                "a contribution folded into the same non-idempotent "
                "reduction twice"),
    "ACCL504": ("stale-read", "error",
                "a hop forwards a region before its producer wrote it "
                "(program-order violation in the hop DAG)"),
    "ACCL601": ("cross-program-overlap", "error",
                "two concurrent programs touch the same buffer region "
                "or stream endpoint with at least one writer: their "
                "interleaving is not equivalent to serial composition"),
    "ACCL602": ("cross-program-tag-collision", "error",
                "traffic of one program is matchable by another on a "
                "shared communicator (e.g. a wildcard recv in program A "
                "can steal a send posted by program B)"),
    "ACCL603": ("cross-program-slot-collision", "error",
                "two concurrent programs claim the same collective_id "
                "ring slot with no cross-program ordering"),
    "ACCL604": ("summary-unliftable", "error",
                "a program's interference footprint could not be "
                "extracted or composed: the pair is UNVERIFIED, which "
                "must never read as certified"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One linter finding, formatted `CODE name [step k] [rank r]: msg`."""

    code: str
    message: str
    step: int | None = None  # descriptor index within the batch
    rank: int | None = None  # communicator-relative rank, protocol passes

    @property
    def name(self) -> str:
        return CODES[self.code][0]

    @property
    def severity(self) -> str:
        return CODES[self.code][1]

    def __str__(self) -> str:
        where = ""
        if self.step is not None:
            where += f" [step {self.step}]"
        if self.rank is not None:
            where += f" [rank {self.rank}]"
        return f"{self.code} {self.name}{where}: {self.message}"


def make(code: str, message: str, step: int | None = None,
         rank: int | None = None) -> Diagnostic:
    if code not in CODES:
        raise KeyError(f"unknown diagnostic code {code!r}")
    return Diagnostic(code, message, step, rank)


def enforce(diagnostics, mode: str) -> None:
    """Apply a lint mode to a diagnostic list: `"error"` raises LintError
    on error-severity findings (warnings are logged), `"warn"` logs
    everything, `"off"` is a no-op. `"deep"` enforces like `"error"`: the
    mode names select which passes run (the deep tier adds the
    interleaving model checker). The full diagnostic list, warnings
    included, rides any raised LintError."""
    if mode not in ("error", "warn", "off", "deep"):
        raise ValueError(f"lint mode must be 'error'|'warn'|'off'|'deep', "
                         f"got {mode!r}")
    if mode == "off" or not diagnostics:
        return
    errors = [d for d in diagnostics if d.severity == "error"]
    if mode in ("error", "deep") and errors:
        raise LintError(diagnostics)
    for d in diagnostics:
        Log.warning("lint: %s", d)
