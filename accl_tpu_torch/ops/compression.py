"""Compression lanes: the fp16/bf16 cast lanes (hp_compression analog) and
the blockwise int8 quantized lanes (EQuARX-style).

Counterpart of accl_tpu/ops/compression.py. Cast lanes wrap a hop as a
dtype cast, the `cast` kernel of ops/lane_kernels.py (round to nearest
even, no flush). The quantized lanes carry a payload as int8 codes with
one fp32 scale per QUANT_BLOCK_ELEMS-element block (~3.94x fewer wire
bytes than fp32): scale = max|x_b| * fp32(1/127), q = clip(rint(x /
scale), -127, 127), a zero-scale block encodes as zeros.

Every quantized function works on the last dimension with one rank per
leading row, as the stacked (world, n) rank buffers need: blocks never
straddle rows, codes keep the row's own length and scales are
ceil(n/256) per row. The four transforms (quantize, dequantize, the
fused dequantize->combine and dequantize->combine->requantize ring
steps), and quantize_wire / dequantize_wire (the quantize and dequantize
kernels writing and reading pack_wire's message themselves), dispatch
through ops/quant_kernels.py: a CUDA tensor launches the
Hopper kernel of csrc/quant_wire.cu, a CPU tensor runs the plain
versions below (`_*_impl`), which are the numeric contract.

The contract is what the JAX package's jitted functions give, which is
what its facade runs (the ring is jitted under shard_map):

  - Subnormals flush (FTZ/DAZ): every fp32 input (payload, scales, local
    operand) and every fp32 result smaller in magnitude than FLT_MIN
    counts as a zero of the same sign, as XLA on the CPU and a TPU do
    (`flush`, the rule the exact lanes share: ops/lane_kernels.py).
    The CUDA kernels apply the same rule in code (a branch per value)
    rather than -ftz=true, so what the source says is what runs.
  - SUM decode+combine rounds once: XLA contracts q*scale + local into a
    fused multiply-add under jit, so the contract is fmaf(q, scale,
    local). The plain version computes it in float64: q*scale is exact
    there (8 x 24 bits), and the add rounds to odd (round to nearest,
    then one step to the odd neighbour when the TwoSum error is nonzero
    and the last bit is even) before the one rounding to float32. Round
    to odd at 53 bits makes that second rounding correct, so the rare
    double-rounding case (a float64 sum landing exactly on a float32
    midpoint) is handled, not just unlikely.
  - MAX decodes with one multiply and takes the IEEE maximum of the
    flushed operands (`max_ieee`): NaN propagates and +0 is above -0, as
    jnp.maximum.
  - A NaN block encodes as codes 0 with scale NaN, an Inf block as codes
    0 with scale Inf; both decode to NaN.

Compressor lane numbering (referenced from ArithConfig rows):
  0: fp32 -> fp16     1: fp16 -> fp32
  2: fp32 -> bf16     3: bf16 -> fp32
  4: fp32 -> int8 blockwise quantize   5: int8 -> fp32 blockwise dequantize

The four transforms take part in the torch-function protocol
(`torch.overrides`), so the analysis lifter (analysis/semantics.py) sees
each as an encode, decode or fused decode-combine node of a schedule's
hop-DAG.
"""

from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

from ..arithconfig import (
    QUANT_COMPRESSOR_LANE,
    QUANT_DECOMPRESSOR_LANE,
    ArithConfig,
)
from ..constants import QUANT_BLOCK_ELEMS, QUANT_INV_QMAX, QUANT_QMAX
from .lane_kernels import cast, flush, max_ieee

_COMPRESS_TARGET = {
    0: torch.float16,
    2: torch.bfloat16,
    QUANT_COMPRESSOR_LANE: torch.int8,
}
_DECOMPRESS_TARGET = {
    1: torch.float32,
    3: torch.float32,
    QUANT_DECOMPRESSOR_LANE: torch.float32,
}


def is_quantized(cfg: ArithConfig) -> bool:
    """True when cfg's wire is the blockwise int8 lane pair: payloads then
    travel as (int8 codes, per-block fp32 scales) instead of a plain
    cast, and hops ride Wire.encode/hop/decode."""
    return cfg.compressor_lane == QUANT_COMPRESSOR_LANE


def wire_dtype(cfg: ArithConfig) -> torch.dtype | None:
    """The dtype payloads travel in when ETH_COMPRESSED is set: the
    compressed domain of the active arithmetic configuration (None when
    the payload is already at wire width)."""
    if cfg.compressed_elem_bytes == cfg.uncompressed_elem_bytes:
        return None
    return _COMPRESS_TARGET.get(cfg.compressor_lane, torch.bfloat16)


def _refuse_pairs(cfg: ArithConfig, fn: str) -> None:
    if is_quantized(cfg):
        raise ValueError(
            "blockwise-quantized lanes carry (payload, scales) pairs; hops "
            f"must go through Wire.encode/hop/decode, not {fn}()")


def compress(x: torch.Tensor, cfg: ArithConfig) -> torch.Tensor:
    """Run the compressor lane of cfg over a payload."""
    _refuse_pairs(cfg, "compress")
    wd = wire_dtype(cfg)
    return x if wd is None else cast(x, wd)


def decompress(x: torch.Tensor, cfg: ArithConfig,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Run the decompressor lane of cfg; the lane's target must agree with
    the caller's uncompressed dtype."""
    _refuse_pairs(cfg, "decompress")
    target = _DECOMPRESS_TARGET.get(cfg.decompressor_lane)
    if target is not None and target != out_dtype:
        raise ValueError(
            f"decompressor lane {cfg.decompressor_lane} yields {target}, "
            f"caller expects {out_dtype}"
        )
    return cast(x, out_dtype)


# ---------------------------------------------------------------------------
# blockwise int8 quantization core (compressor lanes 4/5)
# ---------------------------------------------------------------------------


def quant_num_blocks(n: int, block: int = QUANT_BLOCK_ELEMS) -> int:
    return -(-n // block)


def quantize_blockwise(x: torch.Tensor):
    """Encode rows of fp32 as (int8 codes, per-block fp32 scales). The
    codes keep the row's own length: the tail block is zero-padded only
    for the scale reduction, never on the wire."""
    if has_torch_function((x,)):
        return handle_torch_function(quantize_blockwise, (x,), x)
    from .quant_kernels import quantize

    return quantize(x)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, n: int,
                         out_dtype: torch.dtype = torch.float32):
    """Decode (codes, scales) back to n elements per row of out_dtype."""
    if has_torch_function((q, scales)):
        return handle_torch_function(dequantize_blockwise, (q, scales), q,
                                     scales, n, out_dtype)
    from .quant_kernels import dequantize

    return dequantize(q[..., :n], scales).to(out_dtype)


def dequant_combine(q, scales, local, func_op: str):
    """Fused dequantize -> reduce: decode an arriving quantized partial and
    combine it with the local fp32 operand (the terminal ring hop). The
    element count is local's."""
    if has_torch_function((q, scales, local)):
        return handle_torch_function(dequant_combine, (q, scales, local), q,
                                     scales, local, func_op)
    from .quant_kernels import dequant_combine as kernel

    return kernel(q[..., :local.shape[-1]], scales, local, func_op)


def dequant_combine_requant(q, scales, local, func_op: str):
    """The fused ring step: dequantize -> reduce (fp32) -> requantize, so
    only (codes, scales) leave for the next hop while the accumulation
    never drops below fp32."""
    if has_torch_function((q, scales, local)):
        return handle_torch_function(dequant_combine_requant,
                                     (q, scales, local), q, scales, local,
                                     func_op)
    from .quant_kernels import dequant_combine_requant as kernel

    return kernel(q[..., :local.shape[-1]], scales, local, func_op)


def quantize_wire(x: torch.Tensor) -> torch.Tensor:
    """Encode rows of fp32 straight into the int8 wire message: bitwise
    pack_wire(*quantize_blockwise(x)), the quantize kernel writing it."""
    from .quant_kernels import quantize_packed

    return quantize_packed(x)


def dequantize_wire(msg: torch.Tensor, n: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode the int8 wire message of n elements a row: bitwise
    dequantize_blockwise(*unpack_wire(msg, n), n, out_dtype), the
    dequantize kernel reading it."""
    from .quant_kernels import dequantize_packed

    return dequantize_packed(msg, n).to(out_dtype)


def pack_wire(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(codes, scales) -> one int8 wire payload per row: the fp32 scales'
    raw bytes appended after the codes, so a hop is one message of
    n + 4*ceil(n/256) bytes. Exact: the bytes round-trip bitwise."""
    raw = scales.to(torch.float32).contiguous().view(torch.int8)
    return torch.cat([q, raw], dim=-1)


def unpack_wire(packed: torch.Tensor, n: int):
    """Split packed rows back into (codes, per-block fp32 scales) for n
    payload elements: the exact inverse of pack_wire."""
    nb = quant_num_blocks(n)
    raw = packed[..., n:n + 4 * nb].clone(memory_format=torch.contiguous_format)
    return packed[..., :n], raw.view(torch.float32)


# -- the plain versions: the numeric contract of the four kernels ----------


def _per_elem(scales: torch.Tensor, n: int) -> torch.Tensor:
    """Each block's scale repeated over its elements, cut to n."""
    nb = scales.shape[-1]
    wide = scales.unsqueeze(-1).expand(*scales.shape, QUANT_BLOCK_ELEMS)
    return wide.reshape(*scales.shape[:-1], nb * QUANT_BLOCK_ELEMS)[..., :n]


def _encode_rule(xf: torch.Tensor):
    """The wire format's encode rule over flushed fp32 rows -> (codes,
    scales): one definition for the quantize kernel's plain version and
    the fused ring step's requantize tail."""
    n = xf.shape[-1]
    nb = quant_num_blocks(n)
    pad = nb * QUANT_BLOCK_ELEMS - n
    xp = torch.nn.functional.pad(xf, (0, pad)) if pad else xf
    amax = xp.abs().reshape(*xp.shape[:-1], nb, QUANT_BLOCK_ELEMS).amax(-1)
    scales = flush(amax * QUANT_INV_QMAX)  # NaN-propagating amax
    live = scales > 0  # False for 0 and NaN
    safe = torch.where(live, scales, torch.ones_like(scales))
    q = torch.round(xf / _per_elem(safe, n)).clamp(-QUANT_QMAX, QUANT_QMAX)
    keep = _per_elem(live, n) & ~torch.isnan(q)
    return torch.where(keep, q, torch.zeros_like(q)).to(torch.int8), scales


def _quantize_impl(x: torch.Tensor):
    return _encode_rule(flush(x.to(torch.float32)))


def _dequantize_impl(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    s = _per_elem(flush(scales.to(torch.float32)), q.shape[-1])
    return q.to(torch.float32) * s


def _fma_f32(q: torch.Tensor, s: torch.Tensor,
             local: torch.Tensor) -> torch.Tensor:
    """fmaf(q, s, local), rounded once to float32: exact product in
    float64, the sum rounded to odd at 53 bits, then to float32."""
    a = q.to(torch.float64) * s.to(torch.float64)
    b = local.to(torch.float64)
    d = a + b
    bb = d - a
    err = (a - (d - bb)) + (b - bb)  # TwoSum: d + err == a + b exactly
    even = (d.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(d)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(d.dtype)
    return torch.where(fix, torch.nextafter(d, toward), d).to(torch.float32)


def _dequant_combine_impl(q, scales, local, func_op: str) -> torch.Tensor:
    n = local.shape[-1]
    s = _per_elem(flush(scales.to(torch.float32)), n)
    loc = flush(local.to(torch.float32))
    if func_op == "sum":
        out = flush(_fma_f32(q[..., :n], s, loc))
    elif func_op == "max":
        out = max_ieee(q[..., :n].to(torch.float32) * s, loc)
    else:
        raise ValueError(f"unsupported quantized combine {func_op!r}")
    return out.to(local.dtype)


def _dequant_combine_requant_impl(q, scales, local, func_op: str):
    return _encode_rule(
        _dequant_combine_impl(q, scales, local.to(torch.float32), func_op))


def _quant_ring_impl(x: torch.Tensor, world: int, func_op: str,
                     seg_count: int) -> torch.Tensor:
    """The int8-wire ring allreduce of (world, count) fp32 rows in closed
    form, per seg_count-column segment (the last one ragged): the
    segment is zero-padded to world chunks of m; chunk c is encoded from
    rank c+1's copy, combined and re-encoded at ranks c+2 .. c+W-1 (the
    fused interior step), combined to fp32 at rank c (the terminal step),
    and every rank receives decode(encode(.)) of that (the allgather).
    The same steps in the same order as the ring's hops, so bitwise equal
    to schedules.allreduce_ring_schedule on the int8 wire."""
    count = x.shape[-1]
    c = torch.arange(world, device=x.device)
    outs = []
    for lo in range(0, count, seg_count):
        seg = x[:, lo:lo + seg_count]
        n = seg.shape[-1]
        m = -(-n // world)
        xs = torch.nn.functional.pad(seg, (0, world * m - n)).reshape(
            world, world, m)  # [rank, chunk]
        red = xs[(c + 1) % world, c]  # chunk-major: row c is chunk c
        if world > 1:
            enc = _quantize_impl(red)
            for k in range(2, world):
                enc = _dequant_combine_requant_impl(
                    *enc, xs[(c + k) % world, c], func_op)
            red = _dequant_combine_impl(*enc, xs[c, c], func_op)
        res = _dequantize_impl(*_quantize_impl(red))
        outs.append(res.reshape(1, world * m)[:, :n].expand(world, n))
    return torch.cat(outs, dim=-1)
