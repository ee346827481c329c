"""The expert-parallel MoE layer's kernels: the grouped SwiGLU expert
product and the count-driven row exchange, and their plain versions.

Neither replaces a kernel of the JAX package, whose MoE computes every
capacity slot at a fixed shape; csrc/moe.cu's header states why they
exist, their bounds and their design. A wrapper launches the kernel for
a CUDA tensor and runs the plain version (`_*_impl`) only for a CPU
tensor; each counts its launches in `launches`.

  expert_swiglu   rows r of expert e (starts[e] .. starts[e] + rows[e],
                  device int32 counts) -> down_e(silu(gate_e(x)) * up_e(x))
  dispatch_rows   out[slot_row[s, t, k]] = x[s, t] for the slots whose row
                  is not negative
  combine_rows    out[s, t] = sum over k of gate * eo[slot_row[s, t, k]]
                  over the slots whose row is not negative

Rows that no count reaches are not written: their values are undefined
on the card (the plain versions leave zeros there). Every count and row
is clamped to the rows the buffers hold, so a wrong count gives wrong
rows and never an access past a buffer. Weights are in a
linear layer's (out, in) layout, stacked by expert: gate and up
(E, F, D), down (E, D, F).
"""

from __future__ import annotations

import ctypes
import functools

import torch


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("moe")
    if lib.accl_moe_expert_gemm.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            # dual, A, lda, B, B2, wstride, C, ldc, starts, rows, R,
            # experts, max_rows, N, K, stream
            "accl_moe_expert_gemm": [i, p, ll, p, p, ll, p, ll, p, p, ll,
                                     i, i, i, i, p],
            # x, ldx, out, out_rows, slot_row, slots, T, topk, D, stream
            "accl_moe_dispatch_rows": [p, ll, p, ll, p, ll, i, i, i, p],
            # eo, eo_rows, slot_row, gate, out, ldo, tokens, T, topk, D,
            # stream
            "accl_moe_combine_rows": [p, ll, p, p, p, ll, ll, i, i, i, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.accl_moe_error_string.restype = ctypes.c_char_p
        lib.accl_moe_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _entry(name: str):
    return getattr(_library(), name)


def _launch(name: str, *args) -> None:
    err = _entry(name)(*args)
    if err:
        msg = _library().accl_moe_error_string(err).decode()
        raise RuntimeError(f"{name} failed: {msg} (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: a contiguous {dtype} tensor, got "
                         f"{t.dtype} strides {t.stride()}")
    return t


# -- the plain versions -----------------------------------------------------


def _expert_swiglu_impl(x, starts, rows, w_gate, w_up, w_down, out):
    R = x.shape[0]
    for e, (lo, n) in enumerate(zip(starts.tolist(), rows.tolist())):
        n = min(n, R - lo) if 0 <= lo < R else 0
        if n <= 0:
            continue
        a = x[lo:lo + n]
        g = a @ w_gate[e].T
        h = g / (1.0 + torch.exp(-g)) * (a @ w_up[e].T)
        out[lo:lo + n] = h @ w_down[e].T
    return out


def _dispatch_rows_impl(x, slot_row, out):
    W, T, K = slot_row.shape
    D = out.shape[-1]
    src = x.reshape(W, T, 1, D).expand(W, T, K, D).reshape(-1, D)
    rows = slot_row.reshape(-1).long()
    keep = (rows >= 0) & (rows < out.shape[0])
    out[rows[keep]] = src[keep]
    return out


def _combine_rows_impl(eo, slot_row, gate, out):
    W, T, K = slot_row.shape
    rows = slot_row.long()
    rows = torch.where(rows < eo.shape[0], rows, -1)
    v = eo[rows.clamp(min=0)]  # (W, T, K, D)
    acc = torch.zeros_like(out)
    for k in range(K):
        acc = torch.where(rows[..., k, None] >= 0,
                          acc + gate[..., k, None] * v[:, :, k], acc)
    out.copy_(acc)
    return out


# -- the wrappers -----------------------------------------------------------


def expert_swiglu(x: torch.Tensor, starts: torch.Tensor, rows: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, max_rows: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The SwiGLU of each expert e over its rows of `x` (R, D):
    out[r] = down_e(silu(gate_e(x[r])) * up_e(x[r])) for r in
    starts[e] .. starts[e] + rows[e] (int32 device tensors of E entries,
    at most `max_rows` rows an expert). `out` may be `x` itself: the
    down projection runs after the gate and up projections have read
    every row. Two launches: gate and up into an (R, F) intermediate,
    then down."""
    R, D = x.shape
    E, Fd, _ = w_gate.shape
    if out is None:
        out = torch.zeros_like(x) if x.device.type == "cpu" else \
            torch.empty_like(x)
    if (w_up.shape != w_gate.shape or w_down.shape != (E, D, Fd)
            or starts.shape != (E,) or rows.shape != (E,)):
        raise ValueError(
            f"expert weights {tuple(w_gate.shape)} {tuple(w_up.shape)} "
            f"{tuple(w_down.shape)}, counts {tuple(starts.shape)} "
            f"{tuple(rows.shape)} for rows of {D}")
    if x.device.type == "cpu":
        return _expert_swiglu_impl(x, starts, rows, w_gate, w_up, w_down,
                                   out)
    for t, what in ((x, "rows"), (out, "out"), (w_gate, "w_gate"),
                    (w_up, "w_up"), (w_down, "w_down")):
        _check(t, torch.float32, what)
    _check(starts, torch.int32, "starts")
    _check(rows, torch.int32, "rows")
    h = torch.empty((R, Fd), dtype=torch.float32, device=x.device)
    stream = _stream(x)
    with torch.cuda.device(x.device):
        _launch("accl_moe_expert_gemm", 1, x.data_ptr(), D,
                w_gate.data_ptr(), w_up.data_ptr(), Fd * D, h.data_ptr(), Fd,
                starts.data_ptr(), rows.data_ptr(), R, E, max_rows, Fd, D,
                stream)
        _launch("accl_moe_expert_gemm", 0, h.data_ptr(), Fd,
                w_down.data_ptr(), w_down.data_ptr(), D * Fd, out.data_ptr(),
                D, starts.data_ptr(), rows.data_ptr(), R, E, max_rows, D, Fd,
                stream)
    expert_swiglu.launches += 2  # type: ignore[attr-defined]
    return out


def dispatch_rows(x: torch.Tensor, slot_row: torch.Tensor,
                  out_rows: int) -> torch.Tensor:
    """Each routing slot's token row to its destination row: x is the
    stacked (W, T * D) token buffer, slot_row the (W, T, K) int32 rows of
    the (W * out_rows, D) destination (-1: the slot moves nothing).
    Returns the stacked (W, out_rows * D) destination."""
    W, T, K = slot_row.shape
    D = x.shape[-1] // T
    out = (torch.zeros if x.device.type == "cpu" else torch.empty)(
        (W, out_rows * D), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        _dispatch_rows_impl(x, slot_row, out.view(-1, D))
        return out
    _check(slot_row, torch.int32, "slot_row")
    if x.dtype != torch.float32 or x.stride(-1) != 1:
        raise ValueError(f"dispatch rows: float32 rows, got {x.dtype} "
                         f"strides {x.stride()}")
    with torch.cuda.device(x.device):
        _launch("accl_moe_dispatch_rows", x.data_ptr(), x.stride(0),
                out.data_ptr(), W * out_rows, slot_row.data_ptr(), W * T * K,
                T, K, D, _stream(x))
    dispatch_rows.launches += 1  # type: ignore[attr-defined]
    return out


def combine_rows(eo: torch.Tensor, slot_row: torch.Tensor,
                 gate: torch.Tensor, width: int) -> torch.Tensor:
    """Each token's gate-weighted sum of its slots' rows: eo is the
    stacked (W, R * width) expert output, slot_row the (W, T, K) int32
    rows of its (W * R, width) form (-1: the slot adds nothing), gate
    (W, T, K) float32. Returns the stacked (W, T * width) sums."""
    W, T, K = slot_row.shape
    out = torch.empty((W, T * width), dtype=eo.dtype, device=eo.device)
    if eo.device.type == "cpu":
        _combine_rows_impl(eo.reshape(-1, width), slot_row, gate,
                           out.view(W, T, width))
        return out
    _check(slot_row, torch.int32, "slot_row")
    _check(gate, torch.float32, "gate")
    _check(eo, torch.float32, "eo")
    with torch.cuda.device(eo.device):
        _launch("accl_moe_combine_rows", eo.data_ptr(),
                eo.numel() // width, slot_row.data_ptr(), gate.data_ptr(),
                out.data_ptr(), out.stride(0), W * T, T, K, width,
                _stream(eo))
    combine_rows.launches += 1  # type: ignore[attr-defined]
    return out


expert_swiglu.launches = 0  # type: ignore[attr-defined]
dispatch_rows.launches = 0  # type: ignore[attr-defined]
combine_rows.launches = 0  # type: ignore[attr-defined]
