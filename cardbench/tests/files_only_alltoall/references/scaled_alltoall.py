"""Plain reference of the files-only alltoall test cell: rank i's
operand scaled by its weight, then slot j of rank i's row in slot i of
rank j's. Every result element is one float32 product, made alike here.

- `moved_gap`: the widest gap to the expected element, in units of
  2**-24 times its magnitude.
- `elems_wrong`: elements that differ from the expected, bit for bit.

A result of the wrong shape or type reads as infinitely far."""

import math

import torch


def compare(operands, results, *, config, seed, shrink, weights):
    world = config["deployment"]["world"]
    scale = weights["scale"]
    gap, wrong = 0.0, 0
    for x, out in zip(operands, results, strict=True):
        if (not isinstance(out, torch.Tensor) or out.shape != x.shape
                or out.dtype != torch.float32):
            return {"moved_gap": math.inf, "elems_wrong": math.inf}
        count = x.shape[1] // world
        want = (x * scale).reshape(world, world, count).transpose(0, 1)
        want = want.reshape(x.shape)
        got = out.to(x.device)
        diff = (got.double() - want.double()).abs()
        unit = want.double().abs() * 2.0 ** -24
        rel = torch.where(unit > 0, diff / unit,
                          torch.where(diff > 0, math.inf, 0.0))
        gap = max(gap, torch.nan_to_num(rel, nan=math.inf).max().item())
        wrong += int((got != want).sum().item())
    return {"moved_gap": gap, "elems_wrong": float(wrong)}
