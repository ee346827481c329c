"""SequenceLinter: the static gate in front of compile_sequence.

Counterpart of accl_tpu/analysis/linter.py. It orchestrates the analysis
passes over a recorded descriptor batch and returns the combined
diagnostic list, most severe first:

  - the structural validation (validate.py) and the dataflow hazards
    over the canonical renaming (hazards.py), pure Python over the
    descriptors;
  - the semantic certifier (semantics.check_batch_semantics,
    ACCL501-504) when per-step plans are given and no error-severity
    finding came before (a warning does not skip it: the batch still
    dispatches, so its answer still needs certifying). It is per-batch
    linear, one lift of each step's schedule body with verdicts cached
    by static signature, so it rides the default tier; pathologically
    segmented shapes defer to the strict sweep (semantics' in-band
    budget);
  - the deep tier (`deep=True`, `lint="deep"`): each step's body is
    recorded once (protocol.trace_schedule_hops), its hops checked
    (check_hops) and matched (simulate), then the batch's per-rank hop
    programs are model-checked over every legal match order
    (check_interleavings, modelcheck.py: ACCL205-207).

The reference's overlap-slot pass (slots.py, ACCL301-302) models the
Pallas ring's slot-keyed collective_ids; the port's ring kernel holds no
slots (a closed-form fold since its redesign), so its batches have an
empty timeline (slots.ring_slot_timeline) and the pass stays out.
"""

from __future__ import annotations

from .diagnostics import Diagnostic, enforce
from .hazards import analyze_dataflow
from .validate import validate_steps

__all__ = ["SequenceLinter", "lint_sequence"]

_SEV_ORDER = {"error": 0, "warning": 1}


class SequenceLinter:
    """One linter per world and arithmetic table (`arith_table`: the
    active configuration's lanes, for ACCL406 and the certifier's lift;
    None is the shipping default table). `deep` turns on the
    interleaving tier; `budget` caps its checker (modelcheck.Budget;
    None is the shipping default); `axis_name` is the reference's mesh
    axis, kept for its signature."""

    def __init__(self, world: int, *, deep: bool = False,
                 axis_name: str = "ccl", arith_table: dict | None = None,
                 budget=None):
        self.world = world
        self.deep = deep
        self.axis_name = axis_name
        self.arith_table = arith_table
        self.budget = budget

    def lint(
        self,
        steps,
        plans=None,
        *,
        buffer_widths: dict[int, int] | None = None,
        persistent_addrs: frozenset[int] | set[int] = frozenset(),
    ) -> list[Diagnostic]:
        """Run the configured passes over a batch of CallOptions.
        `plans` (one Plan per step, from plan.select_algorithm) enables
        the semantic pass and the deep tier; `buffer_widths` (address ->
        registered element width) enables the static underflow check;
        `persistent_addrs` declares device-resident state buffers whose
        partial-width refresh pattern waives ACCL101 (see
        hazards.analyze_dataflow)."""
        steps = list(steps)
        diags = validate_steps(steps, self.world)
        if any(d.code in ("ACCL404", "ACCL403") for d in diags):
            # structurally not a sequence: the other passes would
            # misread the batch
            return self._sorted(diags)
        diags += analyze_dataflow(
            steps, self.world,
            buffer_widths=buffer_widths,
            arith_table=self.arith_table,
            persistent_addrs=persistent_addrs,
        )
        if plans is not None and not any(
                d.severity == "error" for d in diags):
            from .semantics import check_batch_semantics

            diags += check_batch_semantics(
                steps, plans, self.world, self.axis_name,
                arith_table=self.arith_table)
        if self.deep and plans is not None and not diags:
            from .protocol import (
                batch_programs_from_hops,
                check_hops,
                rank_programs_from_hops,
                simulate,
                trace_schedule_hops,
            )

            # each step's body is recorded once: the batch checker below
            # reuses the same hops
            hops_per_step = []
            for k, (opts, plan) in enumerate(zip(steps, plans)):
                hops = trace_schedule_hops(opts, plan, self.world,
                                           self.axis_name)
                hops_per_step.append(hops)
                step_diags = check_hops(hops, self.world)
                if not step_diags:  # malformed perms confuse the matcher
                    step_diags = simulate(
                        rank_programs_from_hops(hops, self.world),
                        blocking_sends=False)
                for d in step_diags:
                    diags.append(Diagnostic(d.code, d.message, step=k,
                                            rank=d.rank))
            if not diags:
                programs = batch_programs_from_hops(hops_per_step,
                                                    self.world)
                diags += self.check_interleavings(programs)
        return self._sorted(diags)

    def check_interleavings(self, programs) -> list[Diagnostic]:
        """Model-check per-rank event programs over every legal match
        order (the deep tier's last pass; also the entry point the lint
        corpus's program fixtures use). A batch where every endpoint has
        a provably unique partner admits exactly one matching and skips
        exploration."""
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
                  plans=None, buffer_widths=None, **kw) -> list[Diagnostic]:
    """One-shot convenience: lint a batch and apply `mode` ("error"
    raises LintError on error-severity findings, "warn" logs, "off"
    skips, "deep" adds the exhaustive-interleaving tier and enforces like
    "error"). Returns the diagnostics either way."""
    if mode == "off":
        return []
    if mode == "deep":
        kw.setdefault("deep", True)
    diags = SequenceLinter(world, **kw).lint(
        steps, plans, buffer_widths=buffer_widths)
    enforce(diags, mode)
    return diags
