"""Kernel streams: device-side producers and consumers spliced into a
collective.

Counterpart of accl_tpu/ops/streams.py. The reference lets a PL kernel
push data straight into the CCLO's kernel streams; its TPU form is a
registry of stream endpoints whose producer/consumer are traced
functions spliced into the collective's compiled program. Here they are
torch functions spliced into the schedule body, so they run where the
body runs: eagerly on the CPU, and on the card inside the body and, in a
call sequence, inside its captured CUDA graph.

The calling convention (the reference's producer runs per rank inside
shard_map and reads its rank from `lax.axis_index`; the port runs every
rank at once on stacked tensors):

  producer(ranks) -> operand   `ranks` is the (rows, 1) int64 tensor of
                               the ranks whose rows the body takes, on
                               its device (the counterpart of
                               lax.axis_index): 0..world-1 on one card,
                               a process's own ranks in the
                               multi-process DCN form; the result is the
                               stacked (rows, n) operand, row i rank
                               ranks[i]'s. It is read once and never
                               segmented (OP0_STREAM), and cut to the
                               step's operand width.
  consumer(result) -> result   maps the stacked (world, n) result to the
                               stacked result that lands in the result
                               buffer (RES_STREAM).

A producer's result of more than two dimensions is flattened per rank,
as the reference flattens its per-rank result.

Both must be capturable to ride a call sequence on the card: torch ops
on the card only, no host reads of device data (`.item()`, `.cpu()`,
`.tolist()`), no synchronization, no host-to-device copies from
pageable memory.
"""

from __future__ import annotations

from typing import Callable

import torch


def check_stream_id(stream_id: int) -> int:
    """Valid kernel-stream ids are 1..246 (247..255 reserved, 0 = no
    stream: the reference's strm-field convention)."""
    if not 0 < int(stream_id) < 247:
        raise ValueError(f"stream id {stream_id} outside 1..246")
    return int(stream_id)


class StreamRegistry:
    """Stream endpoints by id (the CCLO kernel-stream ports).

    producer: ranks -> stacked operand    (data_to_cclo stream)
    consumer: stacked result -> result    (data_from_cclo stream)
    """

    def __init__(self):
        self._producers: dict[int, Callable] = {}
        self._consumers: dict[int, Callable] = {}

    def register_producer(self, stream_id: int, fn: Callable):
        check_stream_id(stream_id)
        self._producers[stream_id] = fn

    def register_consumer(self, stream_id: int, fn: Callable):
        check_stream_id(stream_id)
        self._consumers[stream_id] = fn

    def producer(self, stream_id: int) -> Callable:
        try:
            return self._producers[stream_id]
        except KeyError:
            raise KeyError(
                f"no producer registered on stream {stream_id}") from None

    def consumer(self, stream_id: int, strict: bool = False) -> Callable:
        """strict=True (an explicitly requested RES_STREAM) raises on an
        unregistered id instead of passing data through; the non-strict
        fallback is one shared identity, so caches keyed on the endpoint
        object stay stable."""
        if strict and stream_id not in self._consumers:
            raise KeyError(f"no consumer registered on stream {stream_id}")
        return self._consumers.get(stream_id, _IDENTITY)


def _IDENTITY(x):
    return x


def splice_producer(body, producer, n_expected: int, ranks: range):
    """Wrap a 1-operand schedule body so its operand comes from the
    producer instead of a buffer (OP0_STREAM: streams are read once,
    never segmented); `ranks` are the ranks whose rows the body takes.
    The placeholder operand only names the device."""
    n = len(ranks)

    def wrapped(placeholder: torch.Tensor):
        idx = torch.arange(ranks.start, ranks.stop, dtype=torch.int64,
                           device=placeholder.device).reshape(n, 1)
        data = producer(idx)
        if data.dim() < 2 or data.shape[0] != n:
            raise ValueError(
                f"a stream producer returns the stacked ({n}, n) "
                f"operand, got shape {tuple(data.shape)}")
        return body(data.reshape(n, -1)[:, :n_expected])

    return wrapped


def splice_consumer(body, consumer):
    """RES_STREAM: route the schedule result through the consumer before
    it lands in the result buffer."""

    def wrapped(*args):
        return consumer(body(*args))

    return wrapped
