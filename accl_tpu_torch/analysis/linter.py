"""SequenceLinter: the static gate in front of compile_sequence.

Counterpart of accl_tpu/analysis/linter.py. The default tier: the
structural validation (validate.py), then the dataflow hazards over the
canonical renaming (hazards.py), combined into one diagnostic list, most
severe first. Both passes are pure Python over the descriptors.
`check_interleavings` is the deep tier's last pass over given per-rank
programs (modelcheck.py, ACCL205-207): the lint corpus's
`rank_programs` and `hopdag` fixtures and synthesis.certify_dag run it.

What the reference's default tier also runs, and why the port does not:
  - the overlap-slot pass (slots.py, ACCL301-302) models the Pallas
    ring's slot-keyed collective_ids; the port's ring kernel holds no
    slots (a closed-form fold since its redesign), so its batches have
    an empty timeline (slots.ring_slot_timeline) and nothing to check;
  - the semantic certifier over a batch (semantics.check_batch_semantics)
    lifts each step's schedule body into its hop DAG; the port has
    `certify` over a given DAG but no lifting seam yet (ROADMAP queue 1,
    item 15 part 2). On every batch whose schedules are correct, which
    is every batch this port runs, it adds no diagnostic, so the two
    default tiers give the same codes (tests/test_torch_lint.py pins
    this over the lint corpus).
The deep tier over a recorded batch needs each step's hops from the same
seam: `ACCL.sequence(lint="deep")` and `lint_sequence(mode="deep")`
raise not_ported.
"""

from __future__ import annotations

from ..errors import not_ported
from .diagnostics import Diagnostic, enforce
from .hazards import analyze_dataflow
from .validate import validate_steps

__all__ = ["SequenceLinter", "lint_sequence"]

_SEV_ORDER = {"error": 0, "warning": 1}


class SequenceLinter:
    """The default tier for one world and arithmetic table
    (`arith_table`: the active configuration's lanes, for ACCL406; None
    is the shipping default table); `budget` caps the interleaving
    checker (modelcheck.Budget; None is the shipping default)."""

    def __init__(self, world: int, *, arith_table: dict | None = None,
                 budget=None):
        self.world = world
        self.arith_table = arith_table
        self.budget = budget

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

    def check_interleavings(self, programs) -> list[Diagnostic]:
        """Model-check per-rank event programs over every legal match
        order. A batch where every endpoint has a provably unique
        partner admits exactly one matching and skips exploration."""
        from .modelcheck import (
            Budget,
            diagnose_programs,
            statically_deterministic,
        )

        if statically_deterministic(programs):
            return []
        return diagnose_programs(programs,
                                 budget=self.budget or Budget())

    @staticmethod
    def _sorted(diags: list[Diagnostic]) -> list[Diagnostic]:
        return sorted(diags,
                      key=lambda d: (_SEV_ORDER[d.severity], d.code,
                                     d.step if d.step is not None else -1))


def lint_sequence(steps, world: int, *, mode: str = "error",
                  buffer_widths=None, **kw) -> list[Diagnostic]:
    """One-shot convenience: lint a batch and apply `mode` ("error"
    raises LintError on error-severity findings, "warn" logs, "off"
    skips; "deep" raises not_ported). Returns the diagnostics."""
    if mode == "off":
        return []
    if mode == "deep":
        raise not_ported("the deep lint tier", "analysis")
    diags = SequenceLinter(world, **kw).lint(steps,
                                             buffer_widths=buffer_widths)
    enforce(diags, mode)
    return diags
