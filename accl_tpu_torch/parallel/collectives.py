"""Differentiable collectives along one axis of a mesh.

The reference has no such file: its model bodies call the sequencer's
schedules inside shard_map and differentiate through them, and JAX
transposes every ppermute, so the backward of a ring allreduce is itself
an allreduce, the backward of a ppermute the inverse ppermute, and the
backward of a tree bcast a sum onto its root. The port's folds are a
kernel launched through ctypes and its schedules write their own buffers
in place, which autograd cannot see. So each collective here is a
torch.autograd.Function whose forward runs the sequencer's schedule as
it is (on a CUDA tensor every fold a launch of kernel 7, csrc/lanes.cu;
every int8-wire pass kernels 5 and 6) under no-grad, and whose backward
is the reference's transpose, run on the same schedules:

  axis_allreduce   allreduce SUM along an axis (the ring embedded on the
                   rank axis, `Mesh.ring`); backward: the same allreduce
                   of the cotangent
  axis_ppermute    Wire.ppermute along an axis; backward: the inverse
                   permutation (a rank no pair addresses gets zero)
  axis_alltoall    the pairwise rotation exchange along an axis (the
                   axis moved to the front of the rank axis); backward:
                   the same exchange, its own transpose
  axis_bcast       the binary-tree bcast along an axis; backward: every
                   rank's cotangent summed onto the root by the tree's
                   transpose (kernel 7 folds), zero elsewhere

Tensors are stacked (R, ...), one row per virtual rank of the mesh. A
backward runs on the exact wire only, as the reference differentiates
only exact-wire programs (make_train_step and make_moe_train_step build
Wire(None)); on a compressed wire it raises.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunction
from ..sequencer import schedules

EXACT = schedules.Wire(None)


def _exact_backward(wire: schedules.Wire, what: str) -> None:
    if wire.cfg is not None:
        raise NotImplementedError(
            f"the backward of {what} runs on the exact wire only; the "
            "reference differentiates only exact-wire programs")


def allreduce(x: torch.Tensor, mesh, axis: str,
              wire: schedules.Wire = EXACT) -> torch.Tensor:
    """The ring allreduce SUM of the stacked x along `axis`, each rank's
    (n,) buffer one segment (the reference's seg_count = n), not
    differentiable: the schedule with the axis's ring embedding."""
    world = mesh.axis_size(axis)
    if world == 1:
        return x
    flat = x.reshape(x.shape[0], -1)
    out = schedules.allreduce_ring_schedule(
        flat, func=ReduceFunction.SUM, world=world, wire=wire,
        seg_count=flat.shape[-1], ring=mesh.ring(axis))
    return out.reshape(x.shape)


def alltoall(x: torch.Tensor, mesh, axis: str,
             wire: schedules.Wire = EXACT) -> torch.Tensor:
    """The alltoall along `axis` (of more than one rank) of the stacked
    (R, *lead, world*count) x, each (rank, lead) row exchanged as its own
    buffer."""
    out = schedules.alltoall_schedule(mesh.to_front(x, axis),
                                      world=mesh.axis_size(axis), wire=wire)
    return mesh.from_front(out, axis)


def bcast(x: torch.Tensor, mesh, axis: str, root: int,
          wire: schedules.Wire = EXACT) -> torch.Tensor:
    """The binary-tree bcast of the root's row along `axis` (of more
    than one rank)."""
    out = schedules.bcast_bin_tree_schedule(
        mesh.to_front(x, axis), root=root, world=mesh.axis_size(axis),
        wire=wire)
    return mesh.from_front(out, axis)


def _bcast_transpose(g: torch.Tensor, mesh, axis: str,
                     root: int) -> torch.Tensor:
    """The tree bcast's transpose: its rounds in reverse, each folding
    the receivers' cotangents into their senders' (kernel 7) and zeroing
    the receivers, so the root ends with the sum of every rank's."""
    world = mesh.axis_size(axis)
    g = mesh.to_front(g, axis).clone()
    rounds = []
    d = 1 << schedules._fast_log2(world - 1)
    while d > 0:
        rounds.append(schedules._tree_round(world, root, d, up=False))
        d >>= 1
    for pairs in reversed(rounds):
        src, dst = (list(t) for t in zip(*pairs))
        src_i = schedules._index(src, g.device)
        dst_i = schedules._index(dst, g.device)
        g[src_i] = EXACT.combine(ReduceFunction.SUM, g[src_i], g[dst_i])
        g[dst_i] = 0
    return mesh.from_front(g, axis)


class _AxisAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, wire):
        ctx.mesh, ctx.axis, ctx.wire = mesh, axis, wire
        return allreduce(x, mesh, axis, wire)

    @staticmethod
    def backward(ctx, g):
        _exact_backward(ctx.wire, "an allreduce")
        return allreduce(g, ctx.mesh, ctx.axis), None, None, None


class _AxisPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, wire):
        ctx.perm, ctx.wire = perm, wire
        return wire.ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        _exact_backward(ctx.wire, "a ppermute")
        return EXACT.ppermute(g, [(d, s) for s, d in ctx.perm]), None, None


class _AxisAlltoall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, wire):
        ctx.mesh, ctx.axis, ctx.wire = mesh, axis, wire
        return alltoall(x, mesh, axis, wire)

    @staticmethod
    def backward(ctx, g):
        _exact_backward(ctx.wire, "an alltoall")
        return alltoall(g, ctx.mesh, ctx.axis), None, None, None


class _AxisBcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, root, wire):
        ctx.mesh, ctx.axis, ctx.root, ctx.wire = mesh, axis, root, wire
        return bcast(x, mesh, axis, root, wire)

    @staticmethod
    def backward(ctx, g):
        _exact_backward(ctx.wire, "a bcast")
        return (_bcast_transpose(g, ctx.mesh, ctx.axis, ctx.root), None,
                None, None, None)


def axis_allreduce(x: torch.Tensor, mesh, axis: str,
                   wire: schedules.Wire = EXACT) -> torch.Tensor:
    """Differentiable allreduce SUM of the stacked x along `axis`."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AxisAllreduce.apply(x, mesh, axis, wire)


def axis_ppermute(x: torch.Tensor, mesh, axis: str, pairs,
                  wire: schedules.Wire = EXACT) -> torch.Tensor:
    """Differentiable Wire.ppermute of the stacked x along `axis`: the
    axis-local (src, dst) coordinate pairs on every line of the axis."""
    return _AxisPermute.apply(x, mesh.axis_perm(axis, pairs), wire)


def axis_alltoall(x: torch.Tensor, mesh, axis: str,
                  wire: schedules.Wire = EXACT) -> torch.Tensor:
    """Differentiable alltoall of the stacked (R, *lead, world*count) x
    along `axis`."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AxisAlltoall.apply(x, mesh, axis, wire)


def axis_bcast(x: torch.Tensor, mesh, axis: str, root: int,
               wire: schedules.Wire = EXACT) -> torch.Tensor:
    """Differentiable binary-tree bcast of the stacked x from coordinate
    `root` along `axis`."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AxisBcast.apply(x, mesh, axis, root, wire)
