"""Elementwise reduction lanes (the reduce_ops plugin analog).

Counterpart of accl_tpu/ops/reduce_ops.py. Lane numbering:
  0-4  SUM  fp32, fp64, i32, i64, fp16
  5-9  MAX  fp32, fp64, i32, i64, fp16
  10,11 SUM/MAX bf16

SUM on integer lanes wraps (two's complement), and MAX propagates NaN,
as jnp.add / jnp.maximum do: torch.add and torch.maximum have the same
semantics.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunction

_LANE_DTYPES = {
    0: (torch.float32, "sum"),
    1: (torch.float64, "sum"),
    2: (torch.int32, "sum"),
    3: (torch.int64, "sum"),
    4: (torch.float16, "sum"),
    5: (torch.float32, "max"),
    6: (torch.float64, "max"),
    7: (torch.int32, "max"),
    8: (torch.int64, "max"),
    9: (torch.float16, "max"),
    10: (torch.bfloat16, "sum"),
    11: (torch.bfloat16, "max"),
}


def reduce_lane(lane: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply the elementwise reduction selected by an arithconfig lane id."""
    dtype, op = _LANE_DTYPES[lane]
    a = a.to(dtype)
    b = b.to(dtype)
    return torch.add(a, b) if op == "sum" else torch.maximum(a, b)


def combine_op(func: ReduceFunction, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Elementwise combine by ReduceFunction in the operands' own dtype."""
    if func == ReduceFunction.SUM:
        return torch.add(a, b)
    if func == ReduceFunction.MAX:
        return torch.maximum(a, b)
    raise ValueError(f"unsupported reduce function {func}")
