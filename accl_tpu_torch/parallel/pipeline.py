"""Pipeline parallelism: the GPipe microbatch schedule over a `pp` mesh
axis.

Counterpart of accl_tpu/parallel/pipeline.py. Each rank owns one stage of
a depth-sharded model; microbatches flow rank -> rank+1 through the
wire's ppermute, M + P - 1 steps fill and drain the pipeline, and the
last stage's outputs are broadcast back through the binary-tree bcast.
The reference's lax.scan is a Python loop here over the mesh's stacked
(R, ...) tensors; the hop and the bcast are parallel/collectives.py's
differentiable forms, so autograd runs the pipelined backward (the
inverse hops run the bubble in reverse, the bcast's transpose sums onto
the last stage).
"""

from __future__ import annotations

import torch

from ..sequencer import schedules
from .collectives import axis_bcast, axis_ppermute


def _ranked(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (R,) mask shaped to broadcast against a stacked (R, ...)."""
    return mask.reshape(-1, *([1] * (like.dim() - 1)))


def gpipe_schedule(x_mb, stage_fn, *, mesh, axis: str, wire):
    """Run `stage_fn` as a P-stage pipeline over the named axis.

    x_mb: (R, M, ...) microbatches (replicated across the axis; the
    rank at coordinate 0 injects them). stage_fn: the rank-local stage
    body over stacked (R, ...) activations (closed over each rank's stage
    parameters), shape-preserving. Returns the (R, M, ...) pipeline
    outputs, the same on every rank of the axis."""
    world = mesh.axis_size(axis)
    M = x_mb.shape[1]
    if world == 1:  # single stage: no hops, no bubbles
        return torch.stack([stage_fn(x_mb[:, i]) for i in range(M)], 1)
    me = mesh.axis_index(axis)
    # no wrap edge: rank 0 always injects fresh microbatches, so the
    # (P-1 -> 0) hop would be a dead full-tensor transfer every step
    pairs = [(i, i + 1) for i in range(world - 1)]
    first = me == 0
    last = me == world - 1
    buf = torch.zeros_like(x_mb[:, 0])
    outs = [torch.zeros_like(buf) for _ in range(M)]
    for t in range(M + world - 1):
        # rank 0 injects microbatch t; downstream ranks consume the hop
        inject = x_mb[:, min(max(t, 0), M - 1)]
        x_in = torch.where(_ranked(first, buf), inject, buf)
        active = (t - me >= 0) & (t - me < M)
        y = stage_fn(x_in)
        y = torch.where(_ranked(active, y), y, torch.zeros_like(y))
        # the last stage retires microbatch t - (P-1)
        idx = min(max(t - (world - 1), 0), M - 1)
        retire = _ranked(active & last, y)
        outs[idx] = torch.where(retire, y, outs[idx])
        buf = axis_ppermute(y, mesh, axis, pairs, wire)
    outs = torch.stack(outs, 1)
    # replicate the last stage's outputs (the tree bcast). Its transpose
    # SUMS the per-rank cotangents, and every rank computes the same
    # loss, so the output carries an identity-forward / divide-by-P-
    # backward descale: P replicated cotangents sum to one contribution.
    flat = axis_bcast(outs.reshape(outs.shape[0], -1), mesh, axis,
                      root=world - 1, wire=wire)
    return _replica_grad_descale(flat.reshape(outs.shape), world)


def _replica_grad_descale(x, k: int):
    """Identity in the forward pass; scales the cotangent by 1/k (so k
    identical replicated cotangents account for one logical loss)."""
    if k == 1:
        return x
    inv = 1.0 / k
    return x * inv + (x * (1.0 - inv)).detach()


def make_gpipe_mlp_forward(mesh, *, n_microbatches: int,
                           pp_axis: str = "pp"):
    """Demo pipelined model: a stack of pp_world identical MLP blocks,
    block i living on pp rank i. Returns fn(stacked_params, x) -> y where
    stacked_params leaves are the mesh's (R, 1, ...) stage slices
    (`mesh.shard(leaf, P(pp_axis))` of the (pp_world, ...) leaves of
    init_gpipe_mlp) and x is the global (B, D) batch, replicated."""
    wire = schedules.Wire(None)

    def fn(params, x):
        # params leaves arrive as (R, 1, ...) local stage slices
        local = {k: p[:, 0] for k, p in params.items()}

        def stage(h):
            z = torch.tanh(h @ local["w1"] + local["b1"][:, None])
            return h + z @ local["w2"]

        x = mesh.shard(x)
        mb = x.reshape(x.shape[0], n_microbatches, -1, x.shape[-1])
        out = gpipe_schedule(mb, stage, mesh=mesh, axis=pp_axis, wire=wire)
        return mesh.unshard(out.reshape(x.shape))

    return fn


def init_gpipe_mlp(generator: torch.Generator, *, n_stages: int,
                   d_model: int, d_hidden: int, device="cuda"):
    """Stacked stage parameters: leading dim = pipeline stage, drawn from
    `generator` (not bitwise with jax.random: a test feeds both packages
    the same numpy weights)."""
    s = 0.1

    def normal(*shape):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * s).to(device)

    return {
        "w1": normal(n_stages, d_model, d_hidden),
        "b1": torch.zeros((n_stages, d_hidden), device=device),
        "w2": normal(n_stages, d_hidden, d_model),
    }

