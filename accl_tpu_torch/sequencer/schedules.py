"""Collective schedules over stacked rank tensors: the allreduce ring.

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
    configuration's compressed dtype around every cross-rank hop.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..constants import ReduceFunction
from ..ops.compression import compress, decompress
from ..ops.reduce_ops import combine_op, reduce_lane


def _ring_perm(world: int, distance: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + distance) % world) for i in range(world)]


def _ring_ctx(world: int, device: torch.device):
    """The ring a schedule runs on: every rank's position is its row index
    (the stacked tensor's form of lax.axis_index) and a hop is the
    distance-1 rotation."""
    return torch.arange(world, device=device), _ring_perm(world)


class Wire:
    """Per-call datapath: the wire transform around each cross-rank hop
    (cast lanes when ETH_COMPRESSED is active) and the arithmetic lane
    reductions run through. The blockwise int8 lanes are a later slice:
    compress/decompress refuse them."""

    def __init__(self, cfg=None, arith_lane: int | None = None):
        self.cfg = cfg  # ArithConfig when wire compression is active
        self.arith_lane = arith_lane

    def send(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cfg is None else compress(x, self.cfg)

    def recv(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return x if self.cfg is None else decompress(x, self.cfg, out_dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """One cross-rank hop of the stacked tensor: row dst of the result
        is row src of the (compressed) input for each (src, dst) pair of
        perm; rows no pair addresses receive zeros."""
        y = self.send(x)
        src = [-1] * x.shape[0]
        for s, d in perm:
            src[d] = s
        if all(s >= 0 for s in src):
            moved = y[torch.tensor(src, device=x.device)]
        else:
            moved = torch.zeros_like(y)
            dst = [d for d, s in enumerate(src) if s >= 0]
            moved[dst] = y[[src[d] for d in dst]]
        return self.recv(moved, x.dtype)

    def combine(self, func: ReduceFunction, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
        """Elementwise reduction through the configured arith lane."""
        if self.arith_lane is not None:
            return reduce_lane(self.arith_lane, a, b)
        return combine_op(func, a, b)


def _chunks(x: torch.Tensor, world: int) -> torch.Tensor:
    """(world, world*count) -> (world, world, count): [rank, chunk]."""
    return x.reshape(world, world, x.shape[-1] // world)


def reduce_scatter_ring_schedule(x: torch.Tensor, *, func, world: int,
                                 wire: Wire) -> torch.Tensor:
    """Ring reduce-scatter: W-1 steps; at step s each rank combines the
    arriving partial with its local copy of chunk me-2-s and forwards;
    rank r ends holding reduced chunk r. x is (world, world*count), the
    result (world, count)."""
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
