"""SequenceLinter: the static gate in front of compile_sequence.

Counterpart of accl_tpu/analysis/linter.py at its default tier: the
structural validation (validate.py), then the dataflow hazards over the
canonical renaming (hazards.py), combined into one diagnostic list, most
severe first. Both passes are pure Python over the descriptors.

What the reference's default tier also runs, and why the port does not:
  - the overlap-slot pass (slots.py, ACCL301-302) models the Pallas
    ring's slot-keyed collective_ids; the port's ring kernel holds no
    slots (a closed-form fold since its redesign), so there is nothing
    to check;
  - the semantic certifier (semantics.py, ACCL501-504) lifts the
    schedule bodies' hop DAG through JAX tracing; it waits for the
    port's own lifting seam (ROADMAP queue 1, item 15). On every batch
    whose schedules are correct, which is every batch this port runs,
    it adds no diagnostic, so the two default tiers give the same codes
    (tests/test_torch_lint.py pins this over the lint corpus).
The deep tier (protocol interpretation and the interleaving model
checker) waits for the same seam: `ACCL.sequence(lint="deep")` raises
not_ported.
"""

from __future__ import annotations

from .diagnostics import Diagnostic
from .hazards import analyze_dataflow
from .validate import validate_steps

__all__ = ["SequenceLinter"]

_SEV_ORDER = {"error": 0, "warning": 1}


class SequenceLinter:
    """The default tier for one world and arithmetic table
    (`arith_table`: the active configuration's lanes, for ACCL406; None
    is the shipping default table)."""

    def __init__(self, world: int, *, arith_table: dict | None = None):
        self.world = world
        self.arith_table = arith_table

    def lint(
        self,
        steps,
        *,
        buffer_widths: dict[int, int] | None = None,
        persistent_addrs: frozenset[int] | set[int] = frozenset(),
    ) -> list[Diagnostic]:
        """Run the default tier over a batch of CallOptions.
        `buffer_widths` (address -> registered element width) enables
        the static underflow check; `persistent_addrs` declares
        device-resident state buffers whose partial-width refresh
        pattern waives ACCL101 (see hazards.analyze_dataflow)."""
        steps = list(steps)
        diags = validate_steps(steps, self.world)
        if any(d.code in ("ACCL404", "ACCL403") for d in diags):
            # structurally not a sequence: the dataflow pass would
            # misread the batch
            return self._sorted(diags)
        diags += analyze_dataflow(
            steps, self.world,
            buffer_widths=buffer_widths,
            arith_table=self.arith_table,
            persistent_addrs=persistent_addrs,
        )
        return self._sorted(diags)

    @staticmethod
    def _sorted(diags: list[Diagnostic]) -> list[Diagnostic]:
        return sorted(diags,
                      key=lambda d: (_SEV_ORDER[d.severity], d.code,
                                     d.step if d.step is not None else -1))
