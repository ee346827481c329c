"""Two-tier (inner x outer) collectives over stacked rank rows.

Counterpart of accl_tpu/sequencer/hierarchical.py: `RankMap` (the one
global-rank convention of a two-tier world), `TierWire` (one wire per
tier), the striped HIER_RS_AR_AG allreduce and the nine per-axis
compositions the multi-host backend (device/dcn_device.py) lowers to:

  allreduce      = reduce_scatter(inner) -> allreduce(outer on the 1/L
                   shard) -> allgather(inner)
  reduce_scatter = reduce_scatter(inner) -> reduce_scatter(outer)
  allgather      = allgather(outer) -> allgather(inner)
  bcast          = bcast(inner on root host) -> shard bcast(outer)
                   -> allgather(inner)
  scatter        = regroup -> scatter(inner on root host) -> scatter(outer)
  gather         = gather(outer per row) -> gather(inner) -> de-normalize
  reduce         = reduce_scatter(inner) -> reduce(outer) -> gather(inner)
  alltoall       = alltoall(inner) -> one aggregated alltoall(outer)
  barrier        = barrier(inner) -> barrier(outer)

The reference runs each inside one shard_map over both mesh axes, where
a tier's step is a per-rank schedule body along one axis. Here a
composition is written once over the rows it is given and the caller
supplies each tier's steps: a `StackedTier` runs the port's stacked ring
schedules along one tier of the rows through their `ring=(pos, perm)`
embedding (one launch a hop for every line of the tier), and the
multi-process backend's outer tier (device/dcn_transport.ProcessTier)
runs the reference's per-rank bodies across processes. The chunk
arithmetic between the steps is the reference's, so every fold happens in
its order and the results are bitwise its.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunction
from . import schedules


class RankMap:
    """The two-tier global-rank mapping:

      outer-major  g = outer_pos * inner_world + inner_pos
                   (the multi-host backend's process-major numbering:
                   each host's ranks contiguous; alltoall, scatter,
                   gather, the striped allreduce and the tiered library
                   entries use it)
      inner-major  g = inner_pos * outer_world + outer_pos
                   (the raw allgather composition's chunk order)

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

    def reorder_chunks(self, x, chunk: int, frm: str, to: str):
        """Relabel the last dimension, world * chunk elements whose chunk
        g holds data for or from global rank g under convention `frm`,
        into convention `to`: a local transpose, no data crosses ranks.
        Leading dimensions (the stacked rank rows) ride along."""
        if frm == to:
            return x
        L, P = self.inner_world, self.outer_world
        lead = x.shape[:-1]
        a, b = (L, P) if frm == "inner_major" else (P, L)
        return x.reshape(*lead, a, b, chunk).transpose(-3, -2).reshape(
            *lead, a * b * chunk)


class TierWire:
    """One wire per tier (the plan's inner_wire_dtype and
    outer_wire_dtype resolved to schedules.Wire), so each link's
    compression is chosen on its own."""

    __slots__ = ("inner", "outer")

    def __init__(self, inner: schedules.Wire | None = None,
                 outer: schedules.Wire | None = None):
        self.inner = inner if inner is not None else schedules.Wire(None)
        self.outer = outer if outer is not None else schedules.Wire(None)


class StackedTier:
    """One tier of a two-tier world as the stacked ring schedules along it:
    `world` positions, and `ring=(pos, perm)` embedding the tier's rings
    onto the rows (schedules._ring_ctx), or None when the rows are the
    tier's positions themselves (one line). Every step moves all lines
    of the tier in one operation a hop.

    The steps, with the reference's per-axis schedule for each:
    reduce_scatter, allreduce, allgather (the rings), bcast (flat), scatter,
    gather (ring), reduce (ring), alltoall and barrier."""

    __slots__ = ("world", "ring")

    def __init__(self, world: int, ring=None):
        self.world = int(world)
        self.ring = ring

    def position(self, x: torch.Tensor) -> torch.Tensor:
        """Each row's position on its ring (lax.axis_index's
        counterpart)."""
        return schedules._ring_ctx(x, self.world, self.ring)[1]

    def reduce_scatter(self, x, *, func, wire):
        return schedules.reduce_scatter_ring_schedule(
            x, func=func, world=self.world, wire=wire, ring=self.ring)

    def allreduce(self, x, *, func, wire, seg_count: int):
        return schedules.allreduce_ring_schedule(
            x, func=func, world=self.world, wire=wire, seg_count=seg_count,
            ring=self.ring)

    def allgather(self, x, *, wire):
        return schedules.allgather_ring_schedule(
            x, world=self.world, wire=wire, ring=self.ring)

    def bcast(self, x, *, root: int, wire):
        return schedules.bcast_flat_schedule(
            x, root=root, world=self.world, wire=wire, ring=self.ring)

    def scatter(self, x, *, root: int, wire):
        return schedules.scatter_schedule(
            x, root=root, world=self.world, wire=wire, ring=self.ring)

    def gather(self, x, *, root: int, wire):
        return schedules.gather_ring_schedule(
            x, root=root, world=self.world, wire=wire, ring=self.ring)

    def reduce(self, x, *, root: int, func, wire):
        return schedules.reduce_ring_schedule(
            x, root=root, func=func, world=self.world, wire=wire,
            ring=self.ring)

    def alltoall(self, x, *, wire):
        """The pairwise exchange along the tier: the rows brought to a
        (position, line, n) grid, the lines riding as a leading dimension
        of schedules.alltoall_schedule, and put back."""
        if self.ring is None:
            return schedules.alltoall_schedule(x, world=self.world,
                                               wire=wire)
        lines = schedules._ring_lines(self.world, self.ring)
        idx = schedules._row_tensor(tuple(r for k in lines for r in k),
                                    x.device)
        grid = x[idx].reshape(self.world, len(lines[0]), x.shape[-1])
        moved = schedules.alltoall_schedule(grid, world=self.world,
                                            wire=wire)
        out = torch.empty_like(x)
        out[idx] = moved.reshape(-1, x.shape[-1])
        return out

    def barrier(self, token, *, wire):
        return schedules.barrier_schedule(token, world=self.world, wire=wire,
                                          ring=self.ring)


def stacked_tiers(rankmap: RankMap, device) -> tuple[StackedTier,
                                                     StackedTier]:
    """(inner, outer) of `rankmap`'s world, all ranks' rows stacked."""
    g = torch.arange(rankmap.world, device=device)
    return (StackedTier(rankmap.inner_world,
                        (rankmap.inner_pos(g), rankmap.inner_perm())),
            StackedTier(rankmap.outer_world,
                        (rankmap.outer_pos(g), rankmap.outer_perm())))


def hierarchical_allreduce_striped_schedule(
    x: torch.Tensor, *, func: ReduceFunction, rankmap: RankMap | None = None,
    wire: TierWire | None = None, stripes: int = 1, tiers=None,
) -> torch.Tensor:
    """Striped two-tier allreduce of the rows x: per stripe, an inner ring
    reduce-scatter (each inner position holds its slice's partial of one
    1/L chunk), an outer ring allreduce of that shard (the only bytes
    that cross slices), and an inner ring allgather. `stripes` is the
    plan's, the cost model's choice (timing.best_stripes). The tiers are
    `rankmap`'s over all its ranks' rows (every hop a permutation of the
    whole rank axis over the RankMap's global pairs), or `tiers=(inner,
    outer)` as the multi-process backend supplies them."""
    if wire is None:
        wire = TierWire()
    inner, outer = tiers if tiers is not None else stacked_tiers(
        rankmap, x.device)
    n = x.shape[-1]
    S = max(int(stripes), 1)
    per = -(-n // S)  # ceil: stripe width before the L-padding
    outs = []
    for s in range(S):
        seg = x[:, s * per: min((s + 1) * per, n)]
        if seg.shape[-1] == 0:
            continue
        padded = schedules._pad_to_multiple(seg, inner.world)
        shard = inner.reduce_scatter(padded, func=func, wire=wire.inner)
        shard = outer.allreduce(shard, func=func, wire=wire.outer,
                                seg_count=shard.shape[-1])
        full = inner.allgather(shard, wire=wire.inner)
        outs.append(full[:, :seg.shape[-1]])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# the per-axis compositions: x is (rows, n), `inner` and `outer` the tiers
# ---------------------------------------------------------------------------


def hierarchical_allreduce_schedule(x, *, func: ReduceFunction, inner, outer,
                                    wire):
    """RS(inner) -> AR(outer) -> AG(inner): the outer (slow) tier moves
    1/inner_world of the payload per rank."""
    n = x.shape[-1]
    padded = schedules._pad_to_multiple(x, inner.world)
    shard = inner.reduce_scatter(padded, func=func, wire=wire)
    shard = outer.allreduce(shard, func=func, wire=wire,
                            seg_count=shard.shape[-1])
    return inner.allgather(shard, wire=wire)[:, :n]


def hierarchical_reduce_scatter_schedule(x, *, func, inner, outer, wire):
    """Input world*count per rank; output the rank's own chunk under the
    inner-major convention (g = inner_pos * outer_world + outer_pos)."""
    inner_rs = inner.reduce_scatter(x, func=func, wire=wire)
    return outer.reduce_scatter(inner_rs, func=func, wire=wire)


def hierarchical_allgather_schedule(x, *, inner, outer, wire):
    """AG(outer) then AG(inner): output ordered (inner, outer, count),
    i.e. global rank id = inner_pos * outer_world + outer_pos."""
    return inner.allgather(outer.allgather(x, wire=wire), wire=wire)


def hierarchical_alltoall_schedule(x, *, inner, outer, wire):
    """Two-tier alltoall under outer-major global ranks: the inner tier
    redistributes so each rank holds every local source's chunks for its
    own inner position, then the outer tier crosses once per remote host
    with an aggregated inner_world*c block. Input chunks are
    destination-ordered outer-major; output chunks source-ordered
    outer-major (the flat alltoall contract)."""
    L, P = inner.world, outer.world
    rows = x.shape[0]
    c = x.shape[-1] // (L * P)
    s1 = x.reshape(rows, P, L, c).transpose(1, 2).reshape(rows, -1)
    r1 = inner.alltoall(s1, wire=wire)
    s2 = r1.reshape(rows, L, P, c).transpose(1, 2).reshape(rows, -1)
    return outer.alltoall(s2, wire=wire)


def hierarchical_bcast_schedule(x, *, root_inner: int, root_outer: int,
                                inner, outer, wire):
    """Scatter-bcast-allgather: the root's host fans the payload out on
    the inner tier (the other hosts relay their own rows, which the outer
    hop replaces), each inner position carries one 1/L shard across the
    outer tier, and an inner allgather rebuilds the buffer."""
    n = x.shape[-1]
    L = inner.world
    padded = schedules._pad_to_multiple(x, L)
    c = padded.shape[-1] // L
    y = inner.bcast(padded, root=root_inner, wire=wire)
    me = inner.position(y)
    shard = y.reshape(y.shape[0], L, c)[
        torch.arange(y.shape[0], device=y.device), me]
    shard = outer.bcast(shard, root=root_outer, wire=wire)
    return inner.allgather(shard, wire=wire)[:, :n]


def hierarchical_scatter_schedule(x, *, root_inner: int, root_outer: int,
                                  inner, outer, wire):
    """Input world*c per rank (real on the root), process-major chunks.
    The root regroups to (l, p, c), inner-scatters so its host's rank l
    holds every host's chunk for inner position l, then each inner line
    outer-scatters its (P, c) block."""
    L, P = inner.world, outer.world
    rows = x.shape[0]
    c = x.shape[-1] // (L * P)
    xt = x.reshape(rows, P, L, c).transpose(1, 2).reshape(rows, -1)
    blk = inner.scatter(xt, root=root_inner, wire=wire)
    return outer.scatter(blk, root=root_outer, wire=wire)


def hierarchical_gather_schedule(x, *, root_inner: int, root_outer: int,
                                 inner, outer, wire):
    """Mirror of the scatter: each inner line ring-gathers across the
    outer tier to the root host, the root host gathers its rows on the
    inner tier, and the result is de-normalized to process-major chunk
    order. Only the root's output is defined."""
    L, P = inner.world, outer.world
    rows = x.shape[0]
    c = x.shape[-1]
    og = outer.gather(x, root=root_outer, wire=wire)
    ig = inner.gather(og, root=root_inner, wire=wire)
    return ig.reshape(rows, L, P, c).transpose(1, 2).reshape(rows, -1)


def hierarchical_reduce_schedule(x, *, func, root_inner: int,
                                 root_outer: int, inner, outer, wire):
    """RS(inner) -> reduce(outer) -> gather(inner to root): the outer
    tier carries one 1/L shard per inner line. Only the root's output is
    defined."""
    n = x.shape[-1]
    padded = schedules._pad_to_multiple(x, inner.world)
    shard = inner.reduce_scatter(padded, func=func, wire=wire)
    shard = outer.reduce(shard, root=root_outer, func=func, wire=wire)
    return inner.gather(shard, root=root_inner, wire=wire)[:, :n]


def hierarchical_barrier_schedule(token, *, inner, outer, wire):
    """Inner barrier then outer barrier: a rank passes the outer tier only
    after every rank of its host arrived."""
    return outer.barrier(inner.barrier(token, wire=wire), wire=wire)
