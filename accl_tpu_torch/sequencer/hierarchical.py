"""The two-tier (inner x outer) allreduce over stacked rank rows.

Counterpart of the parts of accl_tpu/sequencer/hierarchical.py that plan
selection reaches: `RankMap` (the one global-rank convention of a
two-tier world), `TierWire` (one wire per tier) and the striped
HIER_RS_AR_AG allreduce. The reference's per-axis compositions serve its
multi-process backend and are not ported.

The allreduce is RS(inner) -> AR(outer, on the 1/L shard) -> AG(inner),
the payload cut into `stripes` independent stripes. Every hop is a
permutation of the whole rank axis over the RankMap's global pairs
(inner hops stay within a slice, outer hops cross), built from the same
ring schedules the flat path runs through their `ring=(pos, perm)`
embedding, so its folds are the reference's, bitwise.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunction
from . import schedules


class RankMap:
    """The two-tier global-rank mapping:

      outer-major  g = outer_pos * inner_world + inner_pos
                   (each slice's ranks contiguous; the striped allreduce
                   and the tiered library entries use it)
      inner-major  g = inner_pos * outer_world + outer_pos

    `inner_pos`/`outer_pos`/`global_rank` take ints or integer tensors."""

    __slots__ = ("inner_world", "outer_world", "order")

    def __init__(self, inner_world: int, outer_world: int,
                 order: str = "outer_major"):
        if order not in ("outer_major", "inner_major"):
            raise ValueError(f"unknown rank order {order!r}")
        self.inner_world = int(inner_world)
        self.outer_world = int(outer_world)
        self.order = order

    @property
    def world(self) -> int:
        return self.inner_world * self.outer_world

    def global_rank(self, inner_pos, outer_pos):
        if self.order == "outer_major":
            return outer_pos * self.inner_world + inner_pos
        return inner_pos * self.outer_world + outer_pos

    def inner_pos(self, g):
        if self.order == "outer_major":
            return g % self.inner_world
        return g // self.outer_world

    def outer_pos(self, g):
        if self.order == "outer_major":
            return g // self.inner_world
        return g % self.outer_world

    def inner_perm(self, distance: int = 1) -> list[tuple[int, int]]:
        """Global (src, dst) pairs of one inner-ring hop: every slice's
        inner ring advances by `distance` in lockstep."""
        L = self.inner_world
        return [
            (self.global_rank(i, o), self.global_rank((i + distance) % L, o))
            for o in range(self.outer_world)
            for i in range(L)
        ]

    def outer_perm(self, distance: int = 1) -> list[tuple[int, int]]:
        """Global (src, dst) pairs of one outer-ring hop: every inner
        position's outer ring advances in lockstep."""
        P = self.outer_world
        return [
            (self.global_rank(i, o), self.global_rank(i, (o + distance) % P))
            for o in range(P)
            for i in range(self.inner_world)
        ]


class TierWire:
    """One wire per tier (the plan's inner_wire_dtype and
    outer_wire_dtype resolved to schedules.Wire), so each link's
    compression is chosen on its own."""

    __slots__ = ("inner", "outer")

    def __init__(self, inner: schedules.Wire | None = None,
                 outer: schedules.Wire | None = None):
        self.inner = inner if inner is not None else schedules.Wire(None)
        self.outer = outer if outer is not None else schedules.Wire(None)


def hierarchical_allreduce_striped_schedule(
    x: torch.Tensor, *, func: ReduceFunction, rankmap: RankMap,
    wire: TierWire | None = None, stripes: int = 1,
) -> torch.Tensor:
    """Striped two-tier allreduce of the (world, n) rows x: per stripe, an
    inner ring reduce-scatter (each inner position holds its slice's
    partial of one 1/L chunk), an outer ring allreduce of that shard
    (the only bytes that cross slices), and an inner ring allgather.
    `stripes` is the plan's, the cost model's choice
    (timing.best_stripes)."""
    if wire is None:
        wire = TierWire()
    L, P = rankmap.inner_world, rankmap.outer_world
    n = x.shape[-1]
    g = torch.arange(x.shape[0], device=x.device)
    inner_ring = (rankmap.inner_pos(g), rankmap.inner_perm())
    outer_ring = (rankmap.outer_pos(g), rankmap.outer_perm())
    S = max(int(stripes), 1)
    per = -(-n // S)  # ceil: stripe width before the L-padding
    outs = []
    for s in range(S):
        seg = x[:, s * per: min((s + 1) * per, n)]
        if seg.shape[-1] == 0:
            continue
        padded = schedules._pad_to_multiple(seg, L)
        shard = schedules.reduce_scatter_ring_schedule(
            padded, func=func, world=L, wire=wire.inner, ring=inner_ring)
        shard = schedules.allreduce_ring_schedule(
            shard, func=func, world=P, wire=wire.outer,
            seg_count=shard.shape[-1], ring=outer_ring)
        full = schedules.allgather_ring_schedule(
            shard, world=L, wire=wire.inner, ring=inner_ring)
        outs.append(full[:, :seg.shape[-1]])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
