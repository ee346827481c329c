"""Collective schedules over stacked rank tensors: the allreduce ring,
on the exact, cast and blockwise-int8 wires.

Counterpart of the allreduce path of accl_tpu/sequencer/schedules.py. The
reference's schedules are shard_map bodies that see one rank's (n,)
buffer and move data with lax.ppermute. Here every schedule sees the
whole stacked (world, n) tensor — row r is rank r's buffer — and a hop
is a permutation along the rank axis (dim 0). The per-rank chunk
arithmetic is the reference's, evaluated for all ranks at once, so every
fold happens in the same order and the results are bitwise equal.

Conventions kept from the reference:
  - a rank not addressed by a hop's permutation receives zeros;
  - ring neighbour order follows the communicator (next = rank+1);
  - wire compression (ETH_COMPRESSED) casts payloads to the arithmetic
    configuration's compressed dtype around every cross-rank hop; on the
    blockwise-int8 wire a hop carries (codes, scales) instead, through
    Wire.encode/hop/decode and the fused ring steps, whose kernels
    (ops/quant_kernels.py) take every rank's row in one launch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..constants import ReduceFunction
from ..ops.compression import (
    compress,
    decompress,
    dequant_combine,
    dequant_combine_requant,
    dequantize_blockwise,
    is_quantized,
    pack_wire,
    quantize_blockwise,
    unpack_wire,
)
from ..ops.reduce_ops import combine_op, reduce_lane


def _ring_perm(world: int, distance: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + distance) % world) for i in range(world)]


def _ring_ctx(world: int, device: torch.device):
    """The ring a schedule runs on: every rank's position is its row index
    (the stacked tensor's form of lax.axis_index) and a hop is the
    distance-1 rotation."""
    return torch.arange(world, device=device), _ring_perm(world)


def _permute(y: torch.Tensor, perm) -> torch.Tensor:
    """Row dst of the result is row src of y for each (src, dst) pair of
    perm; rows no pair addresses receive zeros. A full rotation (the ring
    hop) is a roll of the rank axis."""
    world = y.shape[0]
    src = [-1] * world
    for s, d in perm:
        src[d] = s
    shift = (-src[0]) % world
    if all(src[d] == (d - shift) % world for d in range(world)):
        return torch.roll(y, shift, 0)
    moved = torch.zeros_like(y)
    dst = [d for d, s in enumerate(src) if s >= 0]
    moved[dst] = y[[src[d] for d in dst]]
    return moved


class Wire:
    """Per-call datapath: the wire transform around each cross-rank hop
    (cast lanes when ETH_COMPRESSED is active) and the arithmetic lane
    reductions run through.

    Cast lanes wrap each hop as compress -> permute -> decompress. The
    blockwise int8 lanes carry an encoded (codes, scales) pair instead,
    through `encode`/`hop`/`decode`, so the ring relays or fuses the
    encoded form without going through fp32 at every hop."""

    def __init__(self, cfg=None, arith_lane: int | None = None):
        self.cfg = cfg  # ArithConfig when wire compression is active
        self.arith_lane = arith_lane
        self.quantized = cfg is not None and is_quantized(cfg)

    def send(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cfg is None else compress(x, self.cfg)

    def recv(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return x if self.cfg is None else decompress(x, self.cfg, out_dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """One cross-rank hop of the stacked tensor: row dst of the result
        is row src of the (compressed) input for each (src, dst) pair of
        perm; rows no pair addresses receive zeros. On the quantized wire
        the hop is encode -> pack -> permute one message -> unpack ->
        decode; an unaddressed rank's all-zero message decodes to zeros."""
        if self.quantized:
            n = x.shape[-1]
            moved = _permute(pack_wire(*self.encode(x)), perm)
            return self.decode(unpack_wire(moved, n), n, x.dtype)
        return self.recv(_permute(self.send(x), perm), x.dtype)

    def combine(self, func: ReduceFunction, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
        """Elementwise reduction through the configured arith lane."""
        if self.arith_lane is not None:
            return reduce_lane(self.arith_lane, a, b)
        return combine_op(func, a, b)

    # -- quantized-wire datapath (compressor lanes 4/5) --------------------

    def encode(self, x: torch.Tensor):
        """fp32 rows -> (int8 codes, per-block fp32 scales)."""
        return quantize_blockwise(x)

    def hop(self, enc, perm):
        """Permute an encoded payload: codes and scales cross the same
        hop, len(codes) + 4 * n_blocks bytes per rank."""
        q, s = enc
        return _permute(q, perm), _permute(s, perm)

    def decode(self, enc, n: int, out_dtype: torch.dtype) -> torch.Tensor:
        q, s = enc
        return dequantize_blockwise(q, s, n, out_dtype)

    def combine_decoded(self, func: ReduceFunction, enc,
                        local: torch.Tensor) -> torch.Tensor:
        """Fused dequantize -> reduce (terminal ring hop): fp32
        accumulation of an encoded arrival against the local operand."""
        q, s = enc
        return dequant_combine(q, s, local, _quant_op(func))

    def combine_requant(self, func: ReduceFunction, enc, local: torch.Tensor):
        """Fused dequantize -> reduce -> requantize (interior ring step):
        only (codes, scales) travel to the next hop."""
        q, s = enc
        return dequant_combine_requant(q, s, local, _quant_op(func))


def _quant_op(func: ReduceFunction) -> str:
    return "sum" if func == ReduceFunction.SUM else "max"


def _chunks(x: torch.Tensor, world: int) -> torch.Tensor:
    """(world, world*count) -> (world, world, count): [rank, chunk]."""
    return x.reshape(world, world, x.shape[-1] // world)


def reduce_scatter_ring_schedule(x: torch.Tensor, *, func, world: int,
                                 wire: Wire) -> torch.Tensor:
    """Ring reduce-scatter: W-1 steps; at step s each rank combines the
    arriving partial with its local copy of chunk me-2-s and forwards;
    rank r ends holding reduced chunk r. x is (world, world*count), the
    result (world, count)."""
    if wire.quantized:
        return _reduce_scatter_ring_quant(x, func=func, world=world,
                                          wire=wire)
    me, perm = _ring_ctx(world, x.device)
    xs = _chunks(x, world)
    v = xs[me, (me - 1) % world]
    for s in range(world - 1):
        recv = wire.ppermute(v, perm)
        v = wire.combine(func, recv, xs[me, (me - 2 - s) % world])
    return v


def allgather_ring_schedule(x: torch.Tensor, *, world: int,
                            wire: Wire) -> torch.Tensor:
    """Ring allgather: W-1 relay steps; the step-s arrival originates from
    rank me-1-s. x is (world, count), the result (world, world*count)."""
    if wire.quantized:
        return _allgather_ring_quant(x, world=world, wire=wire)
    me, perm = _ring_ctx(world, x.device)
    count = x.shape[-1]
    out = x.new_zeros((world, world, count))
    out[me, me] = x
    relay = x
    for s in range(world - 1):
        recv = wire.ppermute(relay, perm)
        out[me, (me - 1 - s) % world] = recv
        relay = recv
    return out.reshape(world, world * count)


def _reduce_scatter_ring_quant(x: torch.Tensor, *, func, world: int,
                               wire: Wire) -> torch.Tensor:
    """Quantized ring reduce-scatter: the travelling partial stays encoded
    between hops while every interior combine runs the fused dequantize
    -> reduce (fp32) -> requantize step; the terminal hop lands the fp32
    partial (W-1 quantization passes on a partial's path)."""
    me, perm = _ring_ctx(world, x.device)
    xs = _chunks(x, world)
    out = xs[me, (me - 1) % world]
    if world == 1:  # no hop: the local chunk (the reference's encode is dead)
        return out
    enc = wire.encode(out)
    for s in range(world - 1):
        enc = wire.hop(enc, perm)
        local = xs[me, (me - 2 - s) % world]
        if s < world - 2:
            enc = wire.combine_requant(func, enc, local)
        else:
            out = wire.combine_decoded(func, enc, local)
    return out


def _allgather_ring_quant(x: torch.Tensor, *, world: int,
                          wire: Wire) -> torch.Tensor:
    """Quantized ring allgather: each rank encodes its chunk once and the
    (codes, scales) pair relays unchanged. The local chunk takes the same
    encode/decode round trip as the remote copies, which is what makes
    the quantized allreduce's result identical on every rank."""
    me, perm = _ring_ctx(world, x.device)
    count = x.shape[-1]
    out = x.new_zeros((world, world, count))
    enc = wire.encode(x)
    out[me, me] = wire.decode(enc, count, x.dtype)
    for s in range(world - 1):
        enc = wire.hop(enc, perm)
        out[me, (me - 1 - s) % world] = wire.decode(enc, count, x.dtype)
    return out.reshape(world, world * count)


def allreduce_ring_schedule(x: torch.Tensor, *, func, world: int, wire: Wire,
                            seg_count: int) -> torch.Tensor:
    """Segmented ring allreduce: per segment, a ring reduce-scatter over
    world-size chunks followed by a ring allgather."""

    def one_segment(seg: torch.Tensor) -> torch.Tensor:
        padded = _pad_to_multiple(seg, world)
        red = reduce_scatter_ring_schedule(padded, func=func, world=world,
                                           wire=wire)
        gathered = allgather_ring_schedule(red, world=world, wire=wire)
        return gathered[:, : seg.shape[-1]]

    return segmented_apply(one_segment, x, seg_count)


def segmented_apply(one_segment: Callable, x: torch.Tensor, seg_count: int,
                    overlap_slots: int = 0) -> torch.Tensor:
    """Apply a per-segment schedule over the rank buffers in
    seg_count-element column pieces (the eager segmentation substrate);
    the last piece takes the ragged tail.

    overlap_slots=k calls one_segment(seg, slot) with segment i in slot
    i%k, for bodies whose resources come in k slots (the slot-keyed ring
    kernel). The reference orders only slot reuse so k segments can be in
    flight; PyTorch issues the segments in order on one stream, which
    keeps that ordering."""
    count = x.shape[-1]
    if count <= seg_count:
        return one_segment(x, 0) if overlap_slots else one_segment(x)
    outs = []
    for i, lo in enumerate(range(0, count, seg_count)):
        seg = x[..., lo: lo + seg_count]
        outs.append(one_segment(seg, i % overlap_slots) if overlap_slots
                    else one_segment(seg))
    return torch.cat(outs, dim=-1)


def _pad_to_multiple(x: torch.Tensor, m: int) -> torch.Tensor:
    rem = (-x.shape[-1]) % m
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x
