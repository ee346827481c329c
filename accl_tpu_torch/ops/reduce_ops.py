"""Elementwise reduction lanes (the reduce_ops plugin analog).

Counterpart of accl_tpu/ops/reduce_ops.py. Lane numbering:
  0-4  SUM  fp32, fp64, i32, i64, fp16
  5-9  MAX  fp32, fp64, i32, i64, fp16
  10,11 SUM/MAX bf16

A lane runs on the lane kernels of ops/lane_kernels.py: the full-width
lanes on `combine`, the fp16/bf16 lanes on `combine_cast` (widened to
float32, combined, rounded once). On a CUDA tensor the kernel launches;
on a CPU tensor its plain version runs. The numerics are those of XLA,
which the JAX package's lanes run on: subnormal operands and results
flush to a zero of their own sign in fp32, fp64 and bf16 (fp16 lanes
never produce one), MAX is the IEEE maximum (NaN propagates, +0 above
-0), integer SUM wraps.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunction
from . import lane_kernels

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

_FUNC_OPS = {ReduceFunction.SUM: "sum", ReduceFunction.MAX: "max"}


def reduce_lane(lane: int, a: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Apply the elementwise reduction selected by an arithconfig lane id.
    Operands not in the lane's dtype are cast to it first (the cast lane),
    then combined. `out_dtype` lets a fp16/bf16 lane round its float32
    result once to another dtype (the fused combine+cast)."""
    dtype, op = _LANE_DTYPES[lane]
    a = lane_kernels.cast(a, dtype)
    b = lane_kernels.cast(b, dtype)
    if out_dtype is not None and out_dtype != dtype:
        if dtype not in lane_kernels.HALF_DTYPES:
            raise TypeError(f"lane {lane} ({dtype}) cannot emit {out_dtype}")
        return lane_kernels.combine_cast(a, b, op, torch.float32, out_dtype)
    return _combine(a, b, op)


def combine_op(func: ReduceFunction, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Elementwise combine by ReduceFunction in the operands' own dtype."""
    try:
        op = _FUNC_OPS[ReduceFunction(func)]
    except (KeyError, ValueError):
        raise ValueError(f"unsupported reduce function {func}") from None
    return _combine(a, b, op)


def _combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    if a.dtype in lane_kernels.HALF_DTYPES:
        return lane_kernels.combine_cast(a, b, op, torch.float32, a.dtype)
    return lane_kernels.combine(a, b, op)
