"""The collective sequencer: algorithm selection + schedule building.

  - plan.py       algorithm selection (the reference's rules)
  - schedules.py  schedules over stacked (world, n) rank tensors
  - lowering.py   descriptor -> schedule body, cached per signature
  - sequence.py   call sequences: a recorded batch's dataflow and its
                  composed body (and the operand widths of a step)
"""

from .plan import (  # noqa: F401
    Algorithm,
    Plan,
    Protocol,
    select_algorithm,
    select_wire,
)
from .sequence import SequencePlan  # noqa: F401
