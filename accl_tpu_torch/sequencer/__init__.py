"""The collective sequencer: algorithm selection + schedule building.

  - plan.py       algorithm selection (the reference's rules)
  - schedules.py  schedules over stacked (world, n) rank tensors
  - lowering.py   descriptor -> schedule body, cached per signature
  - sequence.py   operand widths of a call's steps
"""

from .plan import Algorithm, Plan, Protocol, select_algorithm  # noqa: F401
