"""Ulysses-style all-to-all sequence parallelism.

Counterpart of accl_tpu/parallel/ulysses.py. One all-to-all re-shards the
activations from sequence-sharded to head-sharded, attention runs with
the whole sequence in view for each head group, and a second all-to-all
restores the sequence sharding. Both re-shardings run the sequencer's
pairwise rotation exchange (sequencer/schedules.py `alltoall_schedule`)
along the mesh axis, through parallel/collectives.py, so each is
differentiable and, on the blockwise-int8 wire, one quantize and one
dequantize launch (kernels 5 and 6) when a slot is a whole number of
256-element blocks. The tensors are the mesh's stacked (R, B, T, H, D)
shards.

A departure: `serial=True` is accepted and changes nothing. In the
reference it puts an order barrier (schedules._ordered_after) between
head groups, so XLA cannot overlap one group's wire with the next one's
matmuls; on one CUDA stream the groups already run in order, so the
barrier would change neither a value nor the launch order (as with the
unported ScheduleCompiler(overlap_serialize=)).
"""

from __future__ import annotations

import math

import torch

from ..sequencer import schedules
from .collectives import axis_alltoall


def _seq_to_heads(x, mesh, axis_name: str, world: int, wire):
    """(R, B, T_local, H, D) -> (R, B, T_global, H/P, D).

    Peer block w of the alltoall = my sequence block's head group w; the
    arrival from rank j is rank j's sequence block restricted to my head
    group, concatenated in source-rank (= sequence-block) order."""
    R, B, T, H, D = x.shape
    Hl = H // world
    blocks = x.reshape(R, B, T, world, Hl, D).permute(0, 3, 1, 2, 4, 5)
    routed = axis_alltoall(blocks.reshape(R, -1), mesh, axis_name, wire)
    out = routed.reshape(R, world, B, T, Hl, D).transpose(1, 2)
    return out.reshape(R, B, T * world, Hl, D)


def _heads_to_seq(x, mesh, axis_name: str, world: int, wire):
    """(R, B, T_global, H/P, D) -> (R, B, T_local, H, D).

    Peer block w = sequence block w of my head group; the arrival from
    rank j is my sequence block under head group j, so source rank order
    restores h = j*Hl + hl."""
    R, B, TG, Hl, D = x.shape
    T = TG // world
    blocks = x.reshape(R, B, world, T, Hl, D).transpose(1, 2)
    routed = axis_alltoall(blocks.reshape(R, -1), mesh, axis_name, wire)
    out = routed.reshape(R, world, B, T, Hl, D).permute(0, 2, 3, 1, 4, 5)
    return out.reshape(R, B, T, world * Hl, D)


def _attend_group(q, k, v, *, mesh, axis_name: str, world: int,
                  causal: bool, sm_scale: float, wire):
    """One head group's full Ulysses round trip: re-shard to
    head-sharded, attend with full sequence visibility, re-shard back.
    Heads are independent in attention, so running the groups
    separately computes what one monolithic round trip computes."""
    qg, kg, vg = (_seq_to_heads(t, mesh, axis_name, world, wire)
                  for t in (q, k, v))
    s = torch.einsum("rbqhd,rbkhd->rbhqk", qg, kg).float() * sm_scale
    if causal:
        TG = qg.shape[2]
        mask = torch.ones((TG, TG), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, -math.inf)
    s = torch.where(torch.isfinite(s), s, -1e30)  # stable fully-masked rows
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("rbhqk,rbkhd->rbqhd", p.to(vg.dtype), vg)
    return _heads_to_seq(out, mesh, axis_name, world, wire)


def ulysses_attention(q, k, v, *, mesh, axis_name: str, causal: bool = True,
                      sm_scale: float | None = None,
                      wire: schedules.Wire | None = None,
                      stripes: int = 1, serial: bool = False):
    """Sequence-sharded stacked q/k/v of shape (R, B, T_local, H, D) with
    H divisible by the axis size.

    `wire` configures the re-shardings' datapath: a blockwise-quantized
    Wire (the (fp32, int8) arith row) carries every exchange as int8
    codes and per-block scales; None keeps the exact fp32 wire.

    `stripes` splits the heads into `stripes` groups (each still
    divisible by the axis size), every group running its own
    in-alltoall -> attention -> out-alltoall chain; attention is
    per-head, so the result is what stripes=1 computes (the reference
    overlaps one group's wire with the next one's matmuls; on one stream
    they run in turn). `serial` is accepted and changes nothing (see the
    module docstring)."""
    world = mesh.axis_size(axis_name)
    R, B, T, H, D = q.shape
    if H % world != 0:
        raise ValueError(f"heads {H} must divide by axis size {world}")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    if wire is None:
        wire = schedules.Wire(None)
    stripes = max(int(stripes), 1)
    kw = dict(mesh=mesh, axis_name=axis_name, world=world, causal=causal,
              sm_scale=sm_scale, wire=wire)
    if stripes == 1:
        return _attend_group(q, k, v, **kw)
    if H % (world * stripes) != 0:
        raise ValueError(
            f"heads {H} must divide by axis size x stripes "
            f"({world} x {stripes})")
    hs = H // stripes
    return torch.cat([
        _attend_group(*(t[:, :, :, g * hs:(g + 1) * hs] for t in (q, k, v)),
                      **kw)
        for g in range(stripes)], dim=3)
