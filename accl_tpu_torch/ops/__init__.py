"""Arithmetic, compression and ring kernels (the plugin layer): the
reduce_ops lanes and the fp16/bf16 cast lanes, the fused ring allreduce
and the blockwise-int8 wire steps, each a CUDA kernel with its plain
PyTorch version."""

from .reduce_ops import combine_op, reduce_lane  # noqa: F401
from .compression import compress, decompress, wire_dtype  # noqa: F401
