"""Plain reference of an exact SUM allreduce over W ranks.

Every rank's result is the elementwise sum of all W operands. The
reference sums in float64, column block by column block so that it fits
beside the results, and compares every rank row of every result:

- `sum_err_u`: the widest gap between a result and the float64 sum, in
  units of u * sum(|x_i|) with u = 2**-24 (float32's unit roundoff).
  Any order of W - 1 float32 additions stays within about W - 1 of these
  units; a float32 result rounded through bfloat16 once lands near 2**16.
- `rank_mismatch`: elements at which some rank's result differs from
  rank 0's, bit for bit. Every rank receives the same result.

A result of the wrong shape or type, or one that is not finite where the
sum is, reads as infinitely far. Imports torch only.
"""

from __future__ import annotations

import math

import torch

UNIT = 2.0 ** -24
BLOCK = 1 << 22


def compare(operands: list[torch.Tensor], results: list[torch.Tensor], *,
            config: dict | None = None, seed: int | None = None,
            shrink: int = 1, weights: dict | None = None,
            block: int = BLOCK) -> dict[str, float]:
    """Compare each (world, n) float32 result with the float64 sum of
    its (world, n) operand's rows. An allreduce has no weights, and the
    configuration, seed and shrink are already in the operands: they are
    not read here."""
    err = 0.0
    mismatch = 0
    for x, out in zip(operands, results, strict=True):
        if (not isinstance(out, torch.Tensor) or out.shape != x.shape
                or out.dtype != torch.float32):
            return {"sum_err_u": math.inf, "rank_mismatch": math.inf}
        out = out.to(x.device)
        for lo in range(0, x.shape[1], block):
            xs = x[:, lo:lo + block].double()
            ref = xs.sum(0)
            scale = xs.abs().sum(0) * UNIT
            got = out[:, lo:lo + block]
            gap = (got.double() - ref).abs()
            gap = torch.where(torch.isfinite(gap), gap,
                              torch.full_like(gap, math.inf))
            rel = torch.where(scale > 0, gap / scale,
                              torch.where(gap > 0, math.inf, 0.0))
            err = max(err, rel.max().item())
            mismatch += int((got != got[:1]).any(0).sum().item())
    return {"sum_err_u": err, "rank_mismatch": float(mismatch)}
