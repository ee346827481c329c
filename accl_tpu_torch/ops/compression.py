"""Compression lanes: the fp16/bf16 cast lanes (hp_compression analog).

Counterpart of the cast half of accl_tpu/ops/compression.py. The
blockwise int8 lanes (compressor lanes 4/5) are a later slice of the
port: a quantized arithmetic row is recognized here so callers can
refuse it up front, but it is never executed.

Compressor lane numbering (referenced from ArithConfig rows):
  0: fp32 -> fp16     1: fp16 -> fp32
  2: fp32 -> bf16     3: bf16 -> fp32
  4: fp32 -> int8 blockwise quantize   5: int8 -> fp32 dequantize
"""

from __future__ import annotations

import torch

from ..arithconfig import QUANT_COMPRESSOR_LANE, ArithConfig
from ..errors import not_ported

_COMPRESS_TARGET = {
    0: torch.float16,
    2: torch.bfloat16,
    QUANT_COMPRESSOR_LANE: torch.int8,
}
_DECOMPRESS_TARGET = {
    1: torch.float32,
    3: torch.float32,
}


def is_quantized(cfg: ArithConfig) -> bool:
    """True when cfg's wire is the blockwise int8 lane pair."""
    return cfg.compressor_lane == QUANT_COMPRESSOR_LANE


def wire_dtype(cfg: ArithConfig) -> torch.dtype | None:
    """The dtype payloads travel in when ETH_COMPRESSED is set: the
    compressed domain of the active arithmetic configuration (None when
    the payload is already at wire width)."""
    if cfg.compressed_elem_bytes == cfg.uncompressed_elem_bytes:
        return None
    return _COMPRESS_TARGET.get(cfg.compressor_lane, torch.bfloat16)


def _refuse_quantized(cfg: ArithConfig) -> None:
    if is_quantized(cfg):
        raise not_ported("the blockwise-quantized int8 wire", "quantized wire")


def compress(x: torch.Tensor, cfg: ArithConfig) -> torch.Tensor:
    """Run the compressor lane of cfg over a payload."""
    _refuse_quantized(cfg)
    wd = wire_dtype(cfg)
    return x if wd is None else x.to(wd)


def decompress(x: torch.Tensor, cfg: ArithConfig,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Run the decompressor lane of cfg; the lane's target must agree with
    the caller's uncompressed dtype."""
    _refuse_quantized(cfg)
    target = _DECOMPRESS_TARGET.get(cfg.decompressor_lane)
    if target is not None and target != out_dtype:
        raise ValueError(
            f"decompressor lane {cfg.decompressor_lane} yields {target}, "
            f"caller expects {out_dtype}"
        )
    return x.to(out_dtype)
