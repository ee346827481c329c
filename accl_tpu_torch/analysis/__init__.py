"""Static analysis for descriptor batches, per-rank programs and hop-DAGs.

Counterpart of accl_tpu/analysis/. A mis-recorded batch would otherwise
fail after dispatch, as a hang or a silently wrong buffer; these passes
check it before anything is built or touches the card, with the
reference's stable diagnostic codes:

  validate.py    descriptor structure: roots, counts, dtypes,
                 communicators, sequenceable kinds   (ACCL401-404)
  hazards.py     RAW/WAR/WAW aliasing, dtype flow, buffer widths and
                 compression lanes over the canonical address renaming
                                                      (ACCL101-103, 401,
                                                       405, 406)
  protocol.py    per-rank send/recv matching and deadlock cycles over
                 given event programs                 (ACCL201-204)
  modelcheck.py  exhaustive-interleaving model checking: wildcard races
                 and schedule-dependent deadlocks over ALL legal match
                 orders, budgeted                     (ACCL205-207)
  slots.py       overlap-slot collective_id liveness  (ACCL301-302)
  hopdag.py      the hop-DAG IR: schedules as data, executable and
                 mutable
  semantics.py   the lifter (a schedule body evaluated over symbolic
                 operands into its hop-DAG) and contribution-set
                 abstract interpretation proving each batch computes
                 its DECLARED collective            (ACCL501-504)
  interference.py cross-program non-interference: footprint summaries
                 per program, O(N^2) pairwise certification with bounded
                 product-modelcheck escalation       (ACCL601-604)
  diagnostics.py the code table, `Diagnostic`, `make` and `enforce`
  linter.py      `SequenceLinter` (the default tier with its semantic
                 pass, and the deep tier) and `lint_sequence`

Wired in at the `lint=` stage of `ACCL.sequence()` (enforced in
GPUDevice.prepare_sequence, cached by composite signature; "deep" opts
into the interleaving tier), at `ACCL.certify_concurrent`, and in the
corpus replay (corpus.py).
"""

from ..errors import LintError  # noqa: F401  (canonical home: errors.py)
from .diagnostics import CODES, Diagnostic, enforce, make  # noqa: F401
from .hazards import analyze_dataflow  # noqa: F401
from .hopdag import HopDag  # noqa: F401
from .interference import (  # noqa: F401
    InterferenceCertifier,
    ProgramFootprint,
    TrafficSummary,
    certificate_id,
    certify_concurrent,
    footprint_from_rank_programs,
    footprint_from_steps,
)
from .linter import SequenceLinter, lint_sequence  # noqa: F401
from .modelcheck import (  # noqa: F401
    Budget,
    CheckResult,
    check_interleavings,
    diagnose_programs,
)
from .protocol import (  # noqa: F401
    ANY_SRC,
    Event,
    MatchNote,
    batch_rank_programs,
    interpret_schedule,
    rank_programs_from_options,
    simulate,
    trace_schedule_hops,
    trace_schedule_jaxpr,
)
from .semantics import (  # noqa: F401
    UnsupportedSchedule,
    certify,
    certify_call,
    check_batch_semantics,
    collective_spec,
    lift_call,
)
from .slots import (  # noqa: F401
    SlotInstance,
    SlotTimeline,
    check_slots,
    ring_slot_timeline,
)
from .validate import validate_steps  # noqa: F401
