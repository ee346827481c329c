"""Arithmetic, compression and ring kernels (the plugin layer): the
reduce_ops lanes and the fp16/bf16 cast lanes as torch ops, the fused
ring allreduce and the blockwise-int8 wire steps as CUDA kernels, each
with its plain PyTorch version."""

from .reduce_ops import combine_op, reduce_lane  # noqa: F401
from .compression import compress, decompress, wire_dtype  # noqa: F401
