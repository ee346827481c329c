"""Static analysis for descriptor batches: the lint gate in front of a
call sequence's compile.

Counterpart of accl_tpu/analysis/. A mis-recorded batch would otherwise
fail after dispatch, as a silently wrong buffer; these passes check a
recorded `SequenceDescriptor` batch before anything is built or touches
the card, with the reference's stable diagnostic codes:

  validate.py    descriptor structure: roots, counts, dtypes,
                 communicators, sequenceable kinds   (ACCL401-404)
  hazards.py     RAW/WAR/WAW aliasing, dtype flow, buffer widths and
                 compression lanes over the canonical address renaming
                                                      (ACCL101-103, 401,
                                                       405, 406)
  diagnostics.py the code table, `Diagnostic`, `make` and `enforce`
  linter.py      `SequenceLinter`, the default tier

The reference's protocol, slot, model-check, semantic and interference
passes are not here yet (see linter.py).
"""

from ..errors import LintError  # noqa: F401  (canonical home: errors.py)
from .diagnostics import CODES, Diagnostic, enforce, make  # noqa: F401
