"""Arithmetic / compression configuration.

Counterpart of accl_tpu/arithconfig.py: maps an (uncompressed dtype,
compressed dtype) operand pair to the lanes that implement elementwise
reduction and cast-compression. The table and its exchange-memory row
layout are the reference's, row for row, so both packages write the same
words at initialize time.
"""

from __future__ import annotations

import dataclasses

from .constants import DataType, dtype_nbytes


@dataclasses.dataclass(frozen=True)
class ArithConfig:
    """One row of the arithmetic configuration table: element sizes of the
    (un)compressed domains, log2 of the element-count ratio, compressor/
    decompressor lanes, whether reduction runs in the compressed domain,
    and the per-function arithmetic lanes (indexed by ReduceFunction)."""

    uncompressed_elem_bytes: int
    compressed_elem_bytes: int
    elem_ratio_log: int
    compressor_lane: int
    decompressor_lane: int
    arith_is_compressed: bool
    arith_lanes: tuple[int, ...]

    def addr(self) -> int:
        """Exchange-memory offset where this config was written."""
        if not hasattr(self, "_exchmem_addr"):
            raise RuntimeError("Arithmetic config address requested before set")
        return self._exchmem_addr  # type: ignore[attr-defined]

    def set_exchmem(self, address: int) -> None:
        object.__setattr__(self, "_exchmem_addr", address)

    # 8 words: [unc bytes, cmp bytes, ratio_log, compressor, decompressor,
    # is_compressed, lane_sum, lane_max]
    WORDS_PER_ROW = 8

    def exchmem_words(self) -> list[int]:
        return [
            self.uncompressed_elem_bytes,
            self.compressed_elem_bytes,
            self.elem_ratio_log,
            self.compressor_lane,
            self.decompressor_lane,
            int(self.arith_is_compressed),
            self.arith_lanes[0],
            self.arith_lanes[1],
        ]

    @classmethod
    def from_exchmem_words(cls, words: list[int]) -> "ArithConfig":
        return cls(
            uncompressed_elem_bytes=words[0],
            compressed_elem_bytes=words[1],
            elem_ratio_log=words[2],
            compressor_lane=words[3],
            decompressor_lane=words[4],
            arith_is_compressed=bool(words[5]),
            arith_lanes=(words[6], words[7]),
        )


# Lane numbering (see ops/reduce_ops.py and ops/compression.py):
#   arith lanes 0-4: SUM for fp32, fp64, i32, i64, fp16; 5-9: MAX for the
#     same dtypes; 10/11: SUM/MAX bf16
#   compressor lanes: 0 = fp32->fp16, 1 = fp16->fp32, 2 = fp32->bf16,
#     3 = bf16->fp32, 4 = fp32->int8 blockwise quantize, 5 = int8->fp32
#     blockwise dequantize
DEFAULT_ARITH_CONFIG: dict[tuple[DataType, DataType], ArithConfig] = {
    (DataType.float16, DataType.float16): ArithConfig(2, 2, 0, 0, 0, False, (4, 9)),
    (DataType.float32, DataType.float16): ArithConfig(4, 2, 0, 0, 1, True, (4, 9)),
    (DataType.float32, DataType.float32): ArithConfig(4, 4, 0, 0, 0, False, (0, 5)),
    (DataType.float64, DataType.float64): ArithConfig(8, 8, 0, 0, 0, False, (1, 6)),
    (DataType.int32, DataType.int32): ArithConfig(4, 4, 0, 0, 0, False, (2, 7)),
    (DataType.int64, DataType.int64): ArithConfig(8, 8, 0, 0, 0, False, (3, 8)),
    (DataType.bfloat16, DataType.bfloat16): ArithConfig(2, 2, 0, 2, 2, False, (10, 11)),
    (DataType.float32, DataType.bfloat16): ArithConfig(4, 2, 0, 2, 3, True, (10, 11)),
    (DataType.float32, DataType.int8): ArithConfig(4, 1, 0, 4, 5, False, (0, 5)),
}


# compressor/decompressor lane ids of the blockwise-quantized wire
QUANT_COMPRESSOR_LANE = 4
QUANT_DECOMPRESSOR_LANE = 5


def validate_arith_config(table: dict[tuple[DataType, DataType], ArithConfig]):
    """Sanity-check a user-provided table the way initialize() does before
    writing configs to exchange memory."""
    for (unc, cmp_), cfg in table.items():
        if cfg.uncompressed_elem_bytes != dtype_nbytes(unc):
            raise ValueError(f"{unc}: uncompressed_elem_bytes mismatch")
        if cfg.compressed_elem_bytes != dtype_nbytes(cmp_):
            raise ValueError(f"{cmp_}: compressed_elem_bytes mismatch")
        if len(cfg.arith_lanes) < 2:
            raise ValueError("arith_lanes must cover SUM and MAX")
    return table
