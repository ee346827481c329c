"""Operands made from the seed, on the device, in one call.

The benchmark makes every operand itself and hands the same to the
program and to the reference: the program's send buffers are views into
one flat tensor filled by one seeded `normal_`, and the reference makes
the same tensor again after the window. Column 0 of every rank row is a
marker: it starts at the rank's index and gains exactly 1.0 before each
step, as a backward pass writes fresh gradients or a layer fresh
activations, so that a result left over from an earlier step, or one
served from a cache, reads wrong.

A configuration's weights (cardbench/weights/) come from a generator of
their own, seeded with `weight_seed(seed)`, so that they are not drawn
from the operands' stream. Imports torch only.
"""

from __future__ import annotations

import torch

# SplitMix64's increment and an odd multiplier: `weight_seed` is a fixed
# bijection of the 64-bit seeds, by arithmetic alone (`hash()` of a
# string varies between processes), with no fixed point: s == (s + A) * M
# mod 2**64 asks s * (M - 1) == -A * M, an even number against an odd one
_WEIGHT_MUL = 0xBF58476D1CE4E5B9
_WEIGHT_ADD = 0x9E3779B97F4A7C15


def weight_seed(seed: int) -> int:
    """The seed of a configuration's weights for the run of `--seed`: a
    fixed function of it that differs from it, so that the weights'
    generator and the operands' (seeded with `seed`) draw apart."""
    return ((seed + _WEIGHT_ADD) * _WEIGHT_MUL) % (1 << 64)


class Operands:
    """The step's operands: `views[i]` is call i's (world, n) operand,
    a view into `flat`; `marks` counts the steps marked so far."""

    def __init__(self, counts: list[int], world: int, seed: int,
                 device: str | torch.device):
        device = torch.device(device)
        total = world * sum(counts)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.flat = torch.empty(total, dtype=torch.float32, device=device)
        self.flat.normal_(generator=gen)
        self.views = []
        idx = []
        off = 0
        for n in counts:
            self.views.append(self.flat[off:off + world * n].view(world, n))
            idx += [off + r * n for r in range(world)]
            off += world * n
        self.world = world
        self._idx = torch.tensor(idx, dtype=torch.long, device=device)
        self._ranks = torch.arange(world, dtype=torch.float32,
                                   device=device).repeat(len(counts))
        self._ones = torch.ones(len(idx), dtype=torch.float32, device=device)
        self.marks = 0
        self.set_marks(0)

    def set_marks(self, k: int) -> None:
        """Column 0 of rank r's row of every operand := r + k (exact)."""
        self.flat.index_copy_(0, self._idx, self._ranks + float(k))
        self.marks = k

    def mark(self) -> None:
        """One step's fresh operands: column 0 gains 1.0 (one launch)."""
        self.flat.index_add_(0, self._idx, self._ones)
        self.marks += 1
