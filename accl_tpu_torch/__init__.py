"""accl_tpu_torch: the PyTorch/CUDA port of accl-tpu.

A second package beside accl_tpu/ (the JAX reference, which it never
imports): the same facade, descriptors, exchange memory and selection
rules, with a world of virtual ranks on one NVIDIA card in place of a
mesh of TPU chips. Buffers are stacked (world, n) tensors; a hop between
ranks is a permutation along the rank axis or, in the fused ring kernel,
a store into the neighbour's comm slot in device memory. Kernels are CUDA
C++ for sm_90a under csrc/, built at first use (ops/_build.py). A
recorded call sequence (`ACCL.sequence()`) runs as one CUDA-graph replay
of those kernels.
"""

from .constants import (  # noqa: F401
    ACCLError,
    CfgFunc,
    CompressionFlags,
    DataType,
    ErrorCode,
    HostFlags,
    Operation,
    OperationStatus,
    ReduceFunction,
    StreamFlags,
    TAG_ANY,
    Transport,
    TuningParams,
    error_code_to_string,
)
from .errors import (  # noqa: F401
    ACCLValidationError,
    DtypeMismatchError,
    InvalidRootError,
    LintError,
    SequenceReuseError,
    ZeroLengthBufferError,
)
from .arithconfig import ArithConfig, DEFAULT_ARITH_CONFIG  # noqa: F401
from .communicator import Communicator, Rank, generate_ranks  # noqa: F401
from .descriptor import CallOptions, SequenceDescriptor  # noqa: F401
from .sequencer import (  # noqa: F401
    Algorithm,
    Plan,
    Protocol,
    SequencePlan,
    select_algorithm,
)
from .accl import ACCL, SequenceRecorder  # noqa: F401

__version__ = "0.1.0"
