"""The 16-byte vector rule of the hand-written kernels.

A kernel with a vector instantiation (the ring kernels of
csrc/ring_allreduce.cu, the three lanes of csrc/lanes.cu, the closed-form
int8 ring of csrc/quant_wire.cu) moves 16 bytes of a row in one access. That needs every operand's base
pointer, and every row stride in bytes that the launch uses, to be a
multiple of 16; the wrapper checks it here and the kernel's entry point
refuses a vector request that breaks it.
"""

from __future__ import annotations

import torch

VECTOR_BYTES = 16


def vector_path(*tensors: torch.Tensor, one_row: bool = False) -> bool:
    """True when a kernel can take its 16-byte vector instantiation over
    these (rows, n) operands: every base pointer is a 16-byte multiple,
    and so is every row stride in bytes, unless the launch walks a single
    row (`one_row`), whose stride it never uses."""
    for t in tensors:  # a loop: this runs on every launch's host path
        if t.data_ptr() % VECTOR_BYTES or not (
                one_row or t.stride(0) * t.element_size() % VECTOR_BYTES == 0):
            return False
    return True
