"""The arith and cast lanes: the Hopper kernels, their plain versions and
the numeric rules they share.

Counterpart of the lane half of accl_tpu/ops/pallas_kernels.py:

  combine       replaces combine_pallas: SUM/MAX of two operands of one
                dtype (float32, float64, int32, int64)
  combine_cast  replaces fused_combine_cast_pallas: both operands widened
                to the float32 accumulator, combined, rounded once to the
                output dtype (the fp16/bf16 lanes)
  cast          replaces cast_pallas: the compression lanes' cast,
                float32 <-> float16 / bfloat16

All three are one CUDA source, csrc/lanes.cu, whose header states the
design and the bound (bytes). Each takes stacked (rows, n) operands, one
virtual rank per row (any leading shape is flattened into rows; rows may
be a column slice of a wider buffer: only unit stride within a row is
required), and makes one launch for every row. Each folds rows that
lie back to back into one long row and takes its 16-byte vector
instantiation when the operands' alignment allows it (`_launch_shape`),
else the scalar one. A wrapper launches the kernel
for a CUDA tensor and runs the plain version (`_*_impl` below, the
numeric contract) only for a CPU tensor. Each wrapper counts its
launches in a plain integer attribute, `launches`.

The numeric contract is what the JAX package's functions give on XLA
(the CPU and a TPU), jitted or eager:

  - FTZ/DAZ: in float32, float64 and bfloat16 arithmetic an operand or
    result smaller in magnitude than its type's smallest normal
    (FLT_MIN, DBL_MIN; bfloat16 checked as the float32 it widens to) is
    a zero of its own sign (`flush`). float16 lanes widen to normal
    float32 values and a sum of two float16 values is 0 or at least
    2**-24, so the rule never changes them. Integer lanes are exact.
  - MAX is the IEEE maximum (`max_ieee`): NaN propagates, +0 is above
    -0. torch.maximum leaves the zero tie to operand order.
  - Integer SUM wraps (two's complement).
  - A cast rounds to nearest even and does not flush: float32 1e-39
    becomes a bfloat16 subnormal. A NaN stays a NaN, but its payload may
    differ between the kernel, torch and XLA.

The three wrappers take part in the torch-function protocol
(`torch.overrides`), so the analysis lifter (analysis/semantics.py) can
evaluate a schedule body over symbolic operands: each fold and cast is
then one node of the body's hop-DAG.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.overrides import handle_torch_function, has_torch_function

from ..constants import from_torch_dtype
from ._vector import vector_path

_OPS = {"sum": 0, "max": 1}
COMBINE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
HALF_DTYPES = (torch.float16, torch.bfloat16)
# operand and result dtypes of the fused combine (accumulator float32)
COMBINE_CAST_DTYPES = (torch.float32, *HALF_DTYPES)
CAST_PAIRS = ((torch.float32, torch.float16), (torch.float16, torch.float32),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))
# DataType codes of the lanes' dtypes, as the C entry points take them
_CODES = {d: int(from_torch_dtype(d))
          for d in (*COMBINE_DTYPES, *HALF_DTYPES)}


# -- the numeric rules (also the int8 wire's: ops/compression.py) ----------


def flush(t: torch.Tensor) -> torch.Tensor:
    """FTZ/DAZ for a float32 or float64 tensor: a value smaller in
    magnitude than the type's smallest normal becomes a zero of its own
    sign; NaN, Inf and normal values pass."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, t * 0.0, t)


def max_ieee(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE maximum: NaN propagates and +0 is above -0 (jnp.maximum on
    XLA; torch.maximum leaves the zero tie to operand order)."""
    both_zero = (a == 0) & (b == 0)
    return torch.where(both_zero, a + b, torch.maximum(a, b))


# -- the plain versions: the numeric contract of the three kernels ---------


def _combine_impl(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """SUM/MAX in the operands' dtype with the contract's rules; fp16 and
    bf16 operands combine in float32 and round once, as XLA does."""
    _op(op)
    if a.dtype in HALF_DTYPES:
        return _combine_cast_impl(a, b, op, torch.float32, a.dtype)
    if not a.is_floating_point():
        return a + b if op == "sum" else torch.maximum(a, b)
    a, b = flush(a), flush(b)
    return flush(a + b) if op == "sum" else max_ieee(a, b)


def _combine_cast_impl(a: torch.Tensor, b: torch.Tensor, op: str,
                       acc: torch.dtype, out: torch.dtype) -> torch.Tensor:
    return _combine_impl(a.to(acc), b.to(acc), op).to(out)


def _cast_impl(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


# -- the kernels -------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lanes")
    if lib.accl_lane_combine.argtypes is None:
        _bind(lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/lanes.cu."""
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        # dtype, op, a, ld, b, ld, out, ld, rows, n, vec, stream
        "accl_lane_combine": [i, i, p, ll, p, ll, p, ll, ll, ll, i, p],
        # in dtype, out dtype, op, a, ld, b, ld, out, ld, rows, n, vec,
        # stream
        "accl_lane_combine_cast": [i, i, i, p, ll, p, ll, p, ll, ll, ll, i,
                                   p],
        # in dtype, out dtype, x, ld, out, ld, rows, n, vec, stream
        "accl_lane_cast": [i, i, p, ll, p, ll, ll, ll, i, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.accl_lane_error_string.restype = ctypes.c_char_p
    lib.accl_lane_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _entry(name: str):
    """The C entry point `name` of the lanes library, looked up once."""
    return getattr(_library(), name)


def _op(op: str) -> int:
    try:
        return _OPS[op]
    except KeyError:
        raise ValueError(f"unsupported lane combine {op!r}") from None


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on the CPU (the plain version runs),
    False on a CUDA device (the kernel launches); mixed or other devices
    raise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("lane operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lane kernels run on cuda or cpu, not {dev}")
    return dev.type == "cpu"


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as a (rows, n) view with unit stride within a row."""
    t2 = t.reshape(-1, t.shape[-1]) if t.dim() != 2 else t
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _pair(a: torch.Tensor, b: torch.Tensor, dtypes, what: str):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{what} operands differ: {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.dtype not in dtypes:
        raise TypeError(f"{what} kernel has no {a.dtype} lane")
    if not a.numel():
        raise ValueError(f"{what} of empty operands {tuple(a.shape)}")
    return _rows(a), _rows(b)


def _launch_shape(*tensors: torch.Tensor):
    """The launch of a lane kernel over (rows, n) operands with
    unit-stride rows (inputs and output): (rows, n, row strides, vector
    flag). When every operand's rows lie back to back (each row stride
    equal to n), the rows fold into one row of rows*n elements; column
    views of wider buffers keep their rows and strides. The flag says
    whether the 16-byte vector instantiation may run (`vector_path` over
    the launch's rows)."""
    rows, n = tensors[0].shape
    strides = [t.stride(0) for t in tensors]
    if rows == 1 or strides.count(n) == len(strides):
        rows, n = 1, rows * n
        strides = [n] * len(tensors)
    return rows, n, tuple(strides), vector_path(*tensors, one_row=rows == 1)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        msg = _library().accl_lane_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Elementwise SUM ("sum") or MAX ("max") of two operands of one shape
    and dtype (float32, float64, int32, int64)."""
    if has_torch_function((a, b)):
        return handle_torch_function(combine, (a, b), a, b, op)
    if _on_cpu(a, b):
        if a.dtype not in COMBINE_DTYPES:
            raise TypeError(f"combine kernel has no {a.dtype} lane")
        return _combine_impl(a, b, op)
    code = _op(op)
    a2, b2 = _pair(a, b, COMBINE_DTYPES, "combine")
    res = torch.empty(a2.shape, dtype=a.dtype, device=a.device)
    rows, n, (lda, ldb, ldo), vec = _launch_shape(a2, b2, res)
    with torch.cuda.device(a.device):
        _launch("combine", _entry("accl_lane_combine"), _CODES[a.dtype],
                code, a2.data_ptr(), lda, b2.data_ptr(), ldb, res.data_ptr(),
                ldo, rows, n, int(vec), _stream(a))
    combine.launches += 1  # type: ignore[attr-defined]
    return res.reshape(a.shape)


def combine_cast(a: torch.Tensor, b: torch.Tensor, op: str,
                 acc: torch.dtype = torch.float32,
                 out: torch.dtype | None = None) -> torch.Tensor:
    """Both operands widened to `acc` (float32), combined ("sum"/"max"),
    rounded once to `out` (default: the operands' dtype); operands and
    result in float32, float16 or bfloat16."""
    if has_torch_function((a, b)):
        return handle_torch_function(combine_cast, (a, b), a, b, op, acc,
                                     out)
    out = out or a.dtype
    if acc != torch.float32:
        raise TypeError(f"combine_cast accumulates in float32, not {acc}")
    if out not in COMBINE_CAST_DTYPES:
        raise TypeError(f"combine_cast kernel has no {out} output")
    if _on_cpu(a, b):
        if a.dtype not in COMBINE_CAST_DTYPES:
            raise TypeError(f"combine_cast kernel has no {a.dtype} lane")
        return _combine_cast_impl(a, b, op, acc, out)
    code = _op(op)
    a2, b2 = _pair(a, b, COMBINE_CAST_DTYPES, "combine_cast")
    res = torch.empty(a2.shape, dtype=out, device=a.device)
    rows, n, (lda, ldb, ldo), vec = _launch_shape(a2, b2, res)
    with torch.cuda.device(a.device):
        _launch("combine_cast", _entry("accl_lane_combine_cast"),
                _CODES[a.dtype], _CODES[out], code, a2.data_ptr(), lda,
                b2.data_ptr(), ldb, res.data_ptr(), ldo, rows, n, int(vec),
                _stream(a))
    combine_cast.launches += 1  # type: ignore[attr-defined]
    return res.reshape(a.shape)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round-to-nearest-even cast between float32 and float16/bfloat16. A
    cast to the tensor's own dtype returns it unchanged (no launch)."""
    if x.dtype == dtype:
        return x
    if has_torch_function((x,)):
        return handle_torch_function(cast, (x,), x, dtype)
    if (x.dtype, dtype) not in CAST_PAIRS:
        raise TypeError(f"cast kernel has no {x.dtype} -> {dtype} lane")
    if _on_cpu(x):
        return _cast_impl(x, dtype)
    if not x.numel():
        return torch.empty(x.shape, dtype=dtype, device=x.device)
    x2 = _rows(x)
    out = torch.empty(x2.shape, dtype=dtype, device=x.device)
    rows, n, (ldx, ldo), vec = _launch_shape(x2, out)
    with torch.cuda.device(x.device):
        _launch("cast", _entry("accl_lane_cast"), _CODES[x.dtype],
                _CODES[dtype], x2.data_ptr(), ldx, out.data_ptr(), ldo, rows,
                n, int(vec), _stream(x))
    cast.launches += 1  # type: ignore[attr-defined]
    return out.reshape(x.shape)


combine.launches = 0  # type: ignore[attr-defined]
combine_cast.launches = 0  # type: ignore[attr-defined]
cast.launches = 0  # type: ignore[attr-defined]
