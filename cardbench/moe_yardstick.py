"""The frozen arithmetic of the DeepSeek-V3 MoE cell's per-layer metrics:
the work of the grouped expert kernel and the bytes of the row exchange,
from the program's routing counters of a step (`moe_counters` events).

Nothing here reads the program but those counters. A change to
accl_tpu_torch cannot move this arithmetic; only a benchmark change can.

- Peaks, one NVIDIA H100 SXM (the H100 SXM data sheet): 3.35 TB/s of
  HBM3 and 67 TFLOP/s of FP32 on the CUDA cores (no tensor cores: the
  expert kernel's products are FP32 FMAs, TF32 off).
- The grouped SwiGLU expert kernel, a step: it reads every held expert
  with rows' gate, up and down weights once (3 * D * F floats an
  expert) and each routed row in and out (2 * D floats a row); it does
  6 * D * F flops a row (three products of 2 * D * F). Its least time
  is the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s.
- The row exchange, a step: the dispatch reads each token row with a
  held slot once (a token's further slots read it again from L2) and
  writes each routed row; the combine reads each routed row and writes
  every token row (D floats a row each). Its share is of 3.35 TB/s.
"""

from __future__ import annotations

from cardbench.yardstick import HBM_BYTES_PER_S

FP32_FLOPS_PER_S = 67e12
COUNTERS = "moe_counters"


def per_step(spans) -> dict | None:
    """The mean of each routing counter over the window's steps, or None
    when the program emitted none."""
    evs = [e["args"] for e in spans if e.get("name") == COUNTERS
           and e.get("track") == "moe"]
    if not evs:
        return None
    return {k: sum(a[k] for a in evs) / len(evs) for k in evs[0]}


def widths(config: dict, shrink: int) -> tuple[int, int]:
    """(hidden, expert width) as the step ran them."""
    return (config["hidden_size"] // shrink,
            config["moe_intermediate_size"] // shrink)


def expert_bytes_flops(c: dict, hidden: int, width: int) -> tuple[float,
                                                                   float]:
    nbytes = 4.0 * (3 * c["moe_experts_live"] * hidden * width
                    + 2 * c["moe_rows"] * hidden)
    return nbytes, 6.0 * c["moe_rows"] * hidden * width


def expert_least_s(c: dict, hidden: int, width: int) -> float:
    nbytes, flops = expert_bytes_flops(c, hidden, width)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def exchange_bytes(c: dict, hidden: int, token_rows: int) -> float:
    """Bytes the dispatch and the combine move a step; `token_rows`,
    the step's token rows over every layer and rank."""
    return 4.0 * hidden * (c["moe_tokens_routed"] + 2 * c["moe_rows"]
                           + token_rows)
