"""Blockwise int8 wire kernels: the Hopper kernels and their dispatch.

Counterpart of the quantized half of accl_tpu/ops/pallas_kernels.py:

  quantize                 replaces quantize_pallas
  quantize_packed          the same kernel, writing the int8 wire message
                           (pack_wire's layout) as its own output
  dequantize               replaces dequantize_pallas
  dequantize_packed        the same kernel, reading the wire message
  dequant_combine          replaces fused_dequant_combine_pallas
  dequant_combine_requant  replaces fused_dequant_combine_quant_pallas
  quant_ring_allreduce     the int8-wire ring allreduce on one card: every
                           fused_dequant_combine_quant_pallas step of the
                           ring, with its quantize, terminal combine and
                           allgather dequantize, in closed form

All are one CUDA source, csrc/quant_wire.cu, whose header states the
design and the bound (bytes). The step kernels take a stacked (rows, n)
operand, one virtual rank per row (any leading shape is flattened into
rows; rows may be a column slice of a wider buffer: only unit stride
within a row is required), and compute per row; quantize and dequantize
fold rows that lie back to back, and quantize takes its 16-byte vector
instantiation where the operands allow it (`quant_launch`);
quant_ring_allreduce takes the (world, count) rank rows of one
allreduce. A wrapper launches the kernel for a CUDA tensor and runs the
plain version (`_*_impl` in ops/compression.py, the numeric contract)
only for a CPU tensor. Each
wrapper counts its launches in a plain integer attribute, `launches`, and
the (rows, n) of each launch in a plain dict attribute, `shapes` (launches
by shape).
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import QUANT_BLOCK_ELEMS
from ._vector import VECTOR_BYTES, vector_path
from .compression import (
    _dequant_combine_impl,
    _dequant_combine_requant_impl,
    _dequantize_impl,
    _quant_ring_impl,
    _quantize_impl,
    pack_wire,
    quant_num_blocks,
    unpack_wire,
)

_OPS = {"sum": 0, "max": 1}


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("quant_wire")
    if lib.accl_quantize.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            # x, ld, q, ld (bytes), s, ld (bytes), rows, n, vec, stream
            "accl_quantize": [p, ll, p, ll, p, ll, ll, ll, i, p],
            # q, ld (bytes), s, ld (bytes), out, ld, rows, n, stream
            "accl_dequantize": [p, ll, p, ll, p, ll, ll, ll, p],
            # op, q, ld, s, ld, local, ld, out, ld, rows, n, stream
            "accl_dequant_combine": [i, p, ll, p, ll, p, ll, p, ll, ll, ll,
                                     p],
            # op, q, ld, s, ld, local, ld, q_out, ld, s_out, ld, rows, n,
            # stream
            "accl_dequant_combine_requant": [i, p, ll, p, ll, p, ll, p, ll,
                                             p, ll, ll, ll, p],
            # op, x, ld, out, ld, world, segs, seg_len, vec, stream
            "accl_quant_ring": [i, p, ll, p, ll, i, ll, ll, i, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.accl_quant_error_string.restype = ctypes.c_char_p
        lib.accl_quant_error_string.argtypes = [ctypes.c_int]
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on the CPU (the plain version runs),
    False on a CUDA device (the kernel launches); mixed or other devices
    raise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("quantized wire operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"quantized wire kernels run on cuda or cpu, not {dev}")
    return dev.type == "cpu"


def _rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """t as a (rows, n) view with unit stride within a row."""
    if t.dtype != dtype:
        raise TypeError(f"quantized wire kernel takes {what} as {dtype}, "
                        f"got {t.dtype}")
    t2 = t.reshape(-1, t.shape[-1]) if t.dim() != 2 else t
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _check_scales(s: torch.Tensor, rows: int, n: int) -> None:
    if tuple(s.shape) != (rows, quant_num_blocks(n)):
        raise ValueError(f"scales of shape {tuple(s.shape)} for {rows} rows "
                         f"of {n} codes")


def _check(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err:
        msg = lib.accl_quant_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _op(func_op: str) -> int:
    try:
        return _OPS[func_op]
    except KeyError:
        raise ValueError(f"unsupported quantized combine {func_op!r}") from None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper, rows: int, n: int) -> None:
    """One launch of `wrapper`'s kernel over (rows, n)."""
    wrapper.launches += 1
    wrapper.shapes[rows, n] = wrapper.shapes.get((rows, n), 0) + 1


def quant_launch(f: torch.Tensor, q: torch.Tensor, s_ptr: int, ld_s: int):
    """The launch of kernel 5 or 6 over (rows, n) fp32 rows `f` (the
    payload of quantize, the result of dequantize), the code rows `q`
    (rows of n codes, or the wire message rows whose first n bytes are
    the codes) and the scale bytes at address s_ptr, ld_s bytes a row:
    (rows, n, fp32 row stride, code row stride, scale row stride in
    bytes, vector flag). Rows that lie back to back (fp32 and code row
    strides n, scale row stride 4*nb) fold into one row when n is a
    multiple of 256, since a row's blocking restarts at its start. The
    flag says whether quantize's 16-byte vector instantiation may run:
    n a multiple of 4, a 16-byte fp32 base and row stride and a 4-byte
    code base and row stride (the strides only when more than one row is
    launched). Dequantize always takes its scalar lanes (faster on the
    card) and reads only the fold."""
    rows, n = f.shape
    ld_f, ld_q = f.stride(0), q.stride(0)
    if rows > 1 and n % QUANT_BLOCK_ELEMS == 0 and ld_f == n == ld_q \
            and ld_s == 4 * (n // QUANT_BLOCK_ELEMS):
        rows, n = 1, rows * n
        ld_f = ld_q = n
        ld_s = 4 * (n // QUANT_BLOCK_ELEMS)
    vec = (n % 4 == 0 and f.data_ptr() % VECTOR_BYTES == 0
           and q.data_ptr() % 4 == 0
           and (rows == 1 or (ld_f * 4 % VECTOR_BYTES == 0 and ld_q % 4 == 0)))
    return rows, n, ld_f, ld_q, ld_s, vec


def _quantize_into(x2: torch.Tensor, q: torch.Tensor, s_ptr: int,
                   ld_s: int) -> None:
    """Kernel 5 over fp32 rows x2 into the code rows q and the scale
    bytes at s_ptr (ld_s bytes a row)."""
    rows, n, ld_x, ld_q, ld_s, vec = quant_launch(x2, q, s_ptr, ld_s)
    lib = _library()
    with torch.cuda.device(x2.device):
        err = lib.accl_quantize(x2.data_ptr(), ld_x, q.data_ptr(), ld_q,
                                s_ptr, ld_s, rows, n, int(vec), _stream(x2))
    _check(err, lib, "quantize")
    _count(quantize, *x2.shape)


def _dequantize_from(q: torch.Tensor, s_ptr: int, ld_s: int,
                     out: torch.Tensor) -> None:
    """Kernel 6 from the code rows q and the scale bytes at s_ptr (ld_s
    bytes a row) into the fp32 rows out."""
    rows, n, ld_out, ld_q, ld_s, _ = quant_launch(out, q, s_ptr, ld_s)
    lib = _library()
    with torch.cuda.device(out.device):
        err = lib.accl_dequantize(q.data_ptr(), ld_q, s_ptr, ld_s,
                                  out.data_ptr(), ld_out, rows, n,
                                  _stream(out))
    _check(err, lib, "dequantize")
    _count(dequantize, *out.shape)


def quantize(x: torch.Tensor):
    """fp32 (..., n) -> (int8 codes (..., n), fp32 scales (..., nb))."""
    if _on_cpu(x):
        return _quantize_impl(x)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = _rows(x, torch.float32, "the payload")
    rows, nb = x2.shape[0], quant_num_blocks(n)
    q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    _quantize_into(x2, q, s.data_ptr(), 4 * nb)
    return q.reshape(*lead, n), s.reshape(*lead, nb)


def quantize_packed(x: torch.Tensor) -> torch.Tensor:
    """fp32 (..., n) -> the int8 wire message (..., n + 4*nb): each row's
    codes, then its fp32 scales' raw bytes; bitwise
    pack_wire(*quantize(x)), written by the quantize kernel itself."""
    if _on_cpu(x):
        return pack_wire(*_quantize_impl(x))
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = _rows(x, torch.float32, "the payload")
    width = n + 4 * quant_num_blocks(n)
    msg = torch.empty((x2.shape[0], width), dtype=torch.int8, device=x.device)
    _quantize_into(x2, msg, msg.data_ptr() + n, width)
    return msg.reshape(*lead, width)


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(codes (..., n), scales (..., nb)) -> fp32 (..., n)."""
    if _on_cpu(q, scales):
        return _dequantize_impl(q, scales)
    lead, n = q.shape[:-1], q.shape[-1]
    q2 = _rows(q, torch.int8, "the codes")
    s2 = _rows(scales, torch.float32, "the scales")
    rows = q2.shape[0]
    _check_scales(s2, rows, n)
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    _dequantize_from(q2, s2.data_ptr(), 4 * s2.stride(0), out)
    return out.reshape(*lead, n)


def dequantize_packed(msg: torch.Tensor, n: int) -> torch.Tensor:
    """The int8 wire message (..., >= n + 4*nb) of n elements a row ->
    fp32 (..., n); bitwise dequantize(*unpack_wire(msg, n)), read by the
    dequantize kernel itself."""
    if _on_cpu(msg):
        return _dequantize_impl(*unpack_wire(msg, n))
    lead = msg.shape[:-1]
    m2 = _rows(msg, torch.int8, "the wire message")
    if n < 1 or m2.shape[-1] < n + 4 * quant_num_blocks(n):
        raise ValueError(f"a wire message of {m2.shape[-1]} bytes a row for "
                         f"{n} elements")
    out = torch.empty((m2.shape[0], n), dtype=torch.float32,
                      device=msg.device)
    _dequantize_from(m2, m2.data_ptr() + n, m2.stride(0), out)
    return out.reshape(*lead, n)


def _combine_operands(q, scales, local):
    lead, n = local.shape[:-1], local.shape[-1]
    if q.shape != local.shape:
        raise ValueError(f"codes {tuple(q.shape)} and local operand "
                         f"{tuple(local.shape)} differ in shape")
    q2 = _rows(q, torch.int8, "the codes")
    s2 = _rows(scales, torch.float32, "the scales")
    l2 = _rows(local, torch.float32, "the local operand")
    _check_scales(s2, q2.shape[0], n)
    return lead, n, q2, s2, l2


def dequant_combine(q: torch.Tensor, scales: torch.Tensor,
                    local: torch.Tensor, func_op: str) -> torch.Tensor:
    """Decode (codes, scales) and combine (func_op "sum"/"max") with the
    fp32 local operand -> fp32, the shape of local."""
    if _on_cpu(q, scales, local):
        return _dequant_combine_impl(q, scales, local, func_op)
    op = _op(func_op)
    lead, n, q2, s2, l2 = _combine_operands(q, scales, local)
    rows = q2.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.accl_dequant_combine(
            op, q2.data_ptr(), q2.stride(0), s2.data_ptr(), s2.stride(0),
            l2.data_ptr(), l2.stride(0), out.data_ptr(), out.stride(0), rows,
            n, _stream(q))
    _check(err, lib, "dequant_combine")
    _count(dequant_combine, rows, n)
    return out.reshape(*lead, n)


def dequant_combine_requant(q: torch.Tensor, scales: torch.Tensor,
                            local: torch.Tensor, func_op: str):
    """Decode, combine with the fp32 local operand, re-encode -> (codes,
    scales) of local's shape."""
    if _on_cpu(q, scales, local):
        return _dequant_combine_requant_impl(q, scales, local, func_op)
    op = _op(func_op)
    lead, n, q2, s2, l2 = _combine_operands(q, scales, local)
    rows, nb = q2.shape[0], quant_num_blocks(n)
    q_out = torch.empty((rows, n), dtype=torch.int8, device=q.device)
    s_out = torch.empty((rows, nb), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.accl_dequant_combine_requant(
            op, q2.data_ptr(), q2.stride(0), s2.data_ptr(), s2.stride(0),
            l2.data_ptr(), l2.stride(0), q_out.data_ptr(), q_out.stride(0),
            s_out.data_ptr(), s_out.stride(0), rows, n, _stream(q))
    _check(err, lib, "dequant_combine_requant")
    _count(dequant_combine_requant, rows, n)
    return q_out.reshape(*lead, n), s_out.reshape(*lead, nb)


def ring_launches(x: torch.Tensor, out: torch.Tensor, world: int,
                  seg_count: int):
    """The launches of quant_ring_allreduce over (world, count) rows x into
    out: (first column, segments, columns a segment, vector flag) for the
    full segments of seg_count columns and for the ragged last one (the
    plan's segmentation, which fixes the blocking). The 16-byte vector
    instantiation needs both operands' bases and row strides
    (`vector_path`), the segment length and its chunk length to be
    4-element multiples."""
    count = x.shape[-1]
    full, rest = divmod(count, seg_count)
    launches = []
    for lo, segs, n in ((0, full, seg_count), (full * seg_count, 1, rest)):
        if not (segs and n):
            continue
        m = -(-n // world)
        vec = (n % 4 == 0 and m % 4 == 0
               and vector_path(x[:, lo:], out[:, lo:], one_row=world == 1))
        launches.append((lo, segs, n, vec))
    return launches


def quant_ring_allreduce(x: torch.Tensor, world: int, func_op: str,
                         seg_count: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The int8-wire ring allreduce of (world, count) fp32 rank rows, per
    seg_count-column segment, in closed form (`_quant_ring_impl`): every
    row of the result is the same. At most two launches: the full
    segments, then the ragged last one, each writing its column view of
    one result (`out`, a (world, count) fp32 view with unit-stride rows,
    when given)."""
    if x.dim() != 2 or x.shape[0] != world:
        raise ValueError(f"rank rows of shape {tuple(x.shape)} for world "
                         f"{world}")
    if x.dtype != torch.float32:
        raise TypeError(f"the int8-wire ring takes float32, got {x.dtype}")
    if seg_count < 1 or not x.shape[-1]:
        raise ValueError(f"{x.shape[-1]} columns in segments of {seg_count}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.stride(-1) != 1):
        raise ValueError(f"out= {tuple(out.shape)} {out.dtype} stride "
                         f"{out.stride()} for {tuple(x.shape)} float32 rows")
    op = _op(func_op)
    if _on_cpu(x, *(() if out is None else (out,))):
        res = _quant_ring_impl(x, world, func_op, seg_count)
        return res if out is None else out.copy_(res)
    x2 = _rows(x, torch.float32, "the rank rows")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        for lo, segs, n, vec in ring_launches(x2, out, world, seg_count):
            xs, os_ = x2[:, lo:], out[:, lo:]
            err = lib.accl_quant_ring(op, xs.data_ptr(), xs.stride(0),
                                      os_.data_ptr(), os_.stride(0), world,
                                      segs, n, int(vec), _stream(x))
            _check(err, lib, "quant_ring_allreduce")
            quant_ring_allreduce.launches += 1  # type: ignore[attr-defined]
    return out


for _wrapper in (quantize, dequantize, dequant_combine,
                 dequant_combine_requant):
    _wrapper.launches = 0  # type: ignore[attr-defined]
    _wrapper.shapes = {}  # type: ignore[attr-defined]
quant_ring_allreduce.launches = 0  # type: ignore[attr-defined]
