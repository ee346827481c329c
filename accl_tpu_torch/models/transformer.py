"""The transformer of the port: the mesh forms, the axis-free forward, the
fused train step and the fused KV-cache decode step over the ACCL facade.

Counterpart of accl_tpu/models/transformer.py. The reference's model is
one shard_map program over a (dp, sp, tp[, pp]) mesh; here it runs over
the port's mesh of virtual ranks (parallel/mesh.py), every per-rank
tensor stacked (R, ...), with the same pieces:

  - the configuration, the parameter tree and the math helpers
    (`_rmsnorm`, `_rope`, `_rope_slots`, `_qkv`, `_local_attention`,
    `_mlp_half`, `_block`): with a mesh, ring attention over sp and the
    tp partial sums through parallel/collectives.py's differentiable
    allreduce (on the card every fold a launch of kernel 7); with none,
    the axis-free forms;
  - the mesh forms: the specs (`param_specs`, `pp_param_specs`,
    `shard_params`, `stack_layer_params`), `make_forward` (the GPipe
    pipeline over pp), `make_decode_step` with `init_kv_cache`, and
    `make_train_step` (autograd through the collectives; the leaf,
    striped and striped_serial gradient syncs; remat; pp);
  - `forward_local`, the axis-free full-context forward of
    `local_train_loss` up to the logits: the oracle the mesh forms and
    the decode step are held against;
  - the data-parallel train step over the facade: the flat
    backward-ordered parameter layout, `local_train_loss`, the fwd+bwd
    as a stream consumer through torch.autograd, and copy -> allreduce
    -> combine recorded as ONE call sequence (`make_train_step_program`:
    on the card one CUDA-graph replay) or issued eagerly
    (`run_train_step_eager`), bitwise the same;
  - the device-resident decode step over the facade: per layer an
    attention consumer, a tensor-parallel allreduce, the residual
    combine, an MLP consumer, a second allreduce and combine, then the
    logits head, recorded as ONE call sequence
    (`make_decode_step_program`) or issued eagerly
    (`run_decode_step_eager`), bitwise the same.

In the facade forms the facade world is the tensor-parallel world (the
data-parallel world for training). The reference's consumer runs per
rank and picks its head and d_ff slice with `lax.axis_index`; the port's
consumer gets the stacked (world, n) state (ops/streams.py) and
contracts it against weights stacked once, at registration, into
per-rank slices: wq (D, H, hd) becomes (W, D, H/W, hd), and so on.
Parameters are torch tensors; interop.transformer_params_from_numpy
converts the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..constants import ReduceFunction
from ..parallel import collectives
from ..parallel.mesh import P
from ..parallel.pipeline import gpipe_schedule
from ..parallel.ring_attention import ring_attention
from ..sequencer import schedules


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    dtype: str = "float32"
    # grouped-query attention: kv heads < query heads shrink the KV cache;
    # None = multi-head (kv_heads == n_heads)
    n_kv_heads: int | None = None
    rope: bool = True
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        assert self.n_heads % kv == 0, (self.n_heads, kv)
        return kv


def _torch_dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> dict:
    """The reference's global parameter tree (same keys and shapes, normal
    weights at scale 0.02, unit norms), drawn from `generator` on its own
    device and placed on `device`. Not bitwise with jax.random: to feed
    both packages the same weights, draw them with the JAX package and
    convert (interop.transformer_params_from_numpy)."""
    dt = _torch_dtype(cfg)

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * 0.02
        return w.to(device=device, dtype=dt)

    D, H, hd, KV = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads
    params = {"embed": dense(cfg.vocab, D), "unembed": dense(D, cfg.vocab),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(D, H, hd),
            "wkv": dense(D, 2, KV, hd),
            "wo": dense(H, hd, D),
            "w_up": dense(D, cfg.d_ff),
            "w_down": dense(cfg.d_ff, D),
            "ln1": torch.ones(D, dtype=dt, device=device),
            "ln2": torch.ones(D, dtype=dt, device=device),
        })
    return params


# ---------------------------------------------------------------------------
# the math helpers and the axis-free forward
# ---------------------------------------------------------------------------

def _rmsnorm(x, g):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * g


def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _rope(x, pos, theta: float):
    """Rotate (B, T, H, D) by absolute positions `pos` (T,): rotary
    embeddings in fp32, half-split form. On a mesh x is the stacked (R,
    B, T, H, D) and pos (R, T), each rank's global positions (under
    sequence parallelism a shard offsets by its sp coordinate)."""
    D = x.shape[-1]
    assert D % 2 == 0, "rope needs an even head_dim"
    ang = pos.float()[..., None] * _inv_freq(D // 2, theta, x.device)
    return _rotate(x, ang.cos()[..., None, :, None, :],
                   ang.sin()[..., None, :, None, :])


def _rope_slots(x, pos, theta: float):
    """Per-slot rotary: (..., B, H, D) rotated by per-slot positions
    `pos` (..., B): the batched-decode form of _rope (the same fp32
    half-split math), one position per batch row, so requests at
    different depths share one step. Leading dimensions (the port's rank
    axis) pass through."""
    D = x.shape[-1]
    assert D % 2 == 0, "rope needs an even head_dim"
    ang = pos.float()[..., None] * _inv_freq(D // 2, theta, x.device)
    return _rotate(x, ang.cos()[..., None, :], ang.sin()[..., None, :])


def _qkv(h, lyr, cfg: TransformerConfig, pos):
    """Project q / k / v (k and v at kv_heads: grouped-query layout) and
    rotate q, k by the positions `pos`. h is (B, T, D), or on a mesh the
    stacked (R, B, T, D) with each leaf stacked (R, ...) and its heads
    the rank's tp slice."""
    if h.dim() == 3:
        q = torch.einsum("btd,dhk->bthk", h, lyr["wq"])
        kv = torch.einsum("btd,dchk->btchk", h, lyr["wkv"])
    else:
        q = torch.einsum("rbtd,rdhk->rbthk", h, lyr["wq"])
        kv = torch.einsum("rbtd,rdchk->rbtchk", h, lyr["wkv"])
    k, v = kv[..., 0, :, :], kv[..., 1, :, :]
    if cfg.rope:
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
    return q, k, v


def _local_attention(q, k, v):
    """Plain causal attention over a fully-local sequence, grouped-query
    aware: scale, then mask with -inf in fp32, then softmax."""
    B, T, H, Dh = q.shape
    kv_heads = k.shape[2]
    qg = q.reshape(B, T, kv_heads, H // kv_heads, Dh)
    s = torch.einsum("bthgk,bshk->bhgts", qg, k).float() / math.sqrt(Dh)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhgts,bshk->bthgk", p.to(v.dtype), v)
    return ctx.reshape(B, T, H, Dh)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _ranked(g):
    """A stacked (R, D) norm gain shaped for (R, B, T, D) activations."""
    return g[:, None, None]


def _tp_allreduce(x, wire, axis: str | None = "tp", mesh=None):
    """Tensor-parallel partial-sum reduction through the sequencer's ring
    reduce-scatter + allgather schedule along `axis` of `mesh`
    (differentiable: its backward is the same allreduce, JAX's
    transpose). axis=None is the single-shard degenerate: identity."""
    if axis is None:
        return x
    return collectives.axis_allreduce(x, mesh, axis, wire)


def _grad_allreduce(g, axis: str, wire, mesh):
    """Mean over the replicas of `axis`: the ring allreduce SUM, / size."""
    world = mesh.axis_size(axis)
    if world == 1:
        return g
    return collectives.allreduce(g, mesh, axis, wire) / world


def _mlp_half(x, lyr, wire=None, tp_axis: str | None = None, mesh=None):
    """ln2 + gelu MLP + tp partial-sum residual, shared by the training
    block and the decode block so the two cannot silently diverge. With
    no mesh the axis-free form (identity partial sum)."""
    if mesh is None:
        h = _rmsnorm(x, lyr["ln2"])
        up = _gelu(torch.einsum("btd,df->btf", h, lyr["w_up"]))
        return x + torch.einsum("btf,fd->btd", up, lyr["w_down"])
    h = _rmsnorm(x, _ranked(lyr["ln2"]))
    up = _gelu(torch.einsum("rbtd,rdf->rbtf", h, lyr["w_up"]))
    down_partial = torch.einsum("rbtf,rfd->rbtd", up, lyr["w_down"])
    return x + _tp_allreduce(down_partial, wire, tp_axis, mesh)


def _block(x, lyr, cfg: TransformerConfig, wire=None,
           tp_axis: str | None = None, sp_axis: str | None = None,
           mesh=None):
    """One transformer block. With no mesh the axis-free form: local
    causal attention at positions 0..T-1, identity partial sums (the
    reference's _block with tp_axis=sp_axis=None). On a mesh, x is the
    stacked (R, B, T_local, D): ring attention over sp_axis at global
    positions (each shard offset by its sp coordinate) and the tp
    partial sums through the ring allreduce over tp_axis."""
    if mesh is None:
        h = _rmsnorm(x, lyr["ln1"])
        pos = torch.arange(h.shape[1], device=h.device)
        q, k, v = _qkv(h, lyr, cfg, pos)
        attn = _local_attention(q, k, v)
        x = x + torch.einsum("bthk,hkd->btd", attn, lyr["wo"])
        return _mlp_half(x, lyr)
    h = _rmsnorm(x, _ranked(lyr["ln1"]))
    T = h.shape[2]
    pos = (mesh.axis_index(sp_axis)[:, None] * T
           + torch.arange(T, device=h.device))
    q, k, v = _qkv(h, lyr, cfg, pos)
    attn = ring_attention(q, k, v, mesh=mesh, axis_name=sp_axis, causal=True)
    o_partial = torch.einsum("rbthk,rhkd->rbtd", attn, lyr["wo"])
    # heads are sharded over tp: partial sums reduce on the ring
    x = x + _tp_allreduce(o_partial, wire, tp_axis, mesh)
    return _mlp_half(x, lyr, wire, tp_axis, mesh)


def forward_local(params: dict, tokens, cfg: TransformerConfig):
    """The full-context forward: tokens (B, T) -> logits (B, T, V), the
    body of the reference's local_train_loss up to the logits. The
    decode step's oracle: decoding a sequence token by token must give
    these logits position by position."""
    x = params["embed"][tokens]
    for lyr in params["layers"]:
        x = _block(x, lyr, cfg)
    x = _rmsnorm(x, torch.ones(cfg.d_model, dtype=x.dtype, device=x.device))
    return torch.einsum("btd,dv->btv", x, params["unembed"])


# ---------------------------------------------------------------------------
# The mesh forms: one program over a (dp, sp, tp[, pp]) mesh of virtual
# ranks (parallel/mesh.py), every per-rank tensor stacked (R, ...)
# ---------------------------------------------------------------------------


def param_specs(cfg: TransformerConfig) -> dict:
    """PartitionSpecs: tp shards heads/ff, everything else replicated."""
    layer = {
        "wq": P(None, "tp", None),
        "wkv": P(None, None, "tp", None),
        "wo": P("tp", None, None),
        "w_up": P(None, "tp"),
        "w_down": P("tp", None),
        "ln1": P(),
        "ln2": P(),
    }
    return {"embed": P(), "unembed": P(), "layers": [layer] * cfg.n_layers}


def stack_layer_params(params) -> dict:
    """Convert the per-layer parameter list into stacked (n_layers, ...)
    leaves so the layer dim can shard over a `pp` mesh axis (stage i =
    layers [i*L/P, (i+1)*L/P))."""
    layers = params["layers"]
    return {"embed": params["embed"], "unembed": params["unembed"],
            "layers": {k: torch.stack([lyr[k] for lyr in layers])
                       for k in layers[0]}}


def unstack_layer_params(params, n_layers: int) -> dict:
    """Inverse of stack_layer_params: stacked (n_layers, ...) leaves back
    to the per-layer list form (checkpoint interop across mesh shapes)."""
    layers = [{k: v[i] for k, v in params["layers"].items()}
              for i in range(n_layers)]
    return {"embed": params["embed"], "unembed": params["unembed"],
            "layers": layers}


def pp_param_specs(cfg: TransformerConfig) -> dict:
    """PartitionSpecs for the stacked form: layer dim over pp, head/ff
    dims over tp as in param_specs, embeddings replicated."""
    layer = param_specs(cfg)["layers"][0]
    return {"embed": P(), "unembed": P(),
            "layers": {k: P("pp", *s) for k, s in layer.items()}}


def _tree_map(fn, tree, *rest):
    """fn over the leaves of a parameter tree (dicts and lists of
    tensors) and trees of the same structure (specs, gradients)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [_tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _pp_world(mesh) -> int:
    return mesh.shape.get("pp", 1)


def _spec_has_axis(spec, axis: str) -> bool:
    """True if a PartitionSpec shards any dimension over `axis`."""
    for part in spec:
        if part is None:
            continue
        parts = part if isinstance(part, tuple) else (part,)
        if axis in parts:
            return True
    return False


def shard_params(params, cfg: TransformerConfig, mesh) -> dict:
    """Place a global parameter tree according to param_specs: each leaf
    the mesh's stacked (R, *local) tensor on its device (a replicated
    leaf a copy per rank, each with its own gradient in the train step).
    On a mesh with a pp axis the layer list is first stacked
    (stack_layer_params) and the layer dim sharded over pp."""
    if _pp_world(mesh) > 1:
        if cfg.n_layers % _pp_world(mesh):
            raise ValueError(
                f"n_layers {cfg.n_layers} must divide over pp "
                f"{_pp_world(mesh)}")
        params = stack_layer_params(params)
        specs = pp_param_specs(cfg)
    else:
        specs = param_specs(cfg)
    return _tree_map(mesh.shard, params, specs)


def _embed(embed, tokens):
    """Each rank's rows of its stacked (R, V, D) embedding at its (R, B,
    T) tokens."""
    r = torch.arange(embed.shape[0], device=embed.device)
    return embed[r[:, None, None], tokens]


def _head(x, unembed, cfg: TransformerConfig):
    x = _rmsnorm(x, torch.ones(cfg.d_model, dtype=x.dtype, device=x.device))
    return torch.einsum("rbtd,rdv->rbtv", x, unembed)


def _block_fn(cfg: TransformerConfig, wire, remat: bool, mesh):
    """The per-layer body over the mesh, optionally rematerialized:
    torch.utils.checkpoint drops the block's activations (attention
    scores, MLP hidden) in the forward pass and recomputes them during
    the backward, the ring hops and the attention's tp allreduce
    included. The recompute stops at the block's last saved activation,
    so the MLP's allreduce, on whose result none depends, runs once: one
    allreduce more a block, as in the reference's rematerialized step."""
    def fn(x, lyr):
        return _block(x, lyr, cfg, wire, "tp", "sp", mesh)

    if not remat:
        return fn
    return lambda x, lyr: checkpoint(fn, x, lyr, use_reentrant=False)


def _forward_local(params, tokens, cfg: TransformerConfig, wire,
                   remat: bool = False, *, mesh):
    """The stacked per-rank forward: tokens (R, B_local, T_local) ->
    logits (R, B_local, T_local, V); heads are each rank's tp slice, the
    sequence its sp shard."""
    blk = _block_fn(cfg, wire, remat, mesh)
    x = _embed(params["embed"], tokens)  # (R, B, T, D)
    for lyr in params["layers"]:
        x = blk(x, lyr)
    return _head(x, params["unembed"], cfg)


def _forward_local_pp(params, tokens, cfg: TransformerConfig, wire,
                      n_microbatches: int, remat: bool = False, *, mesh):
    """The pipelined stacked forward: params["layers"] leaves are each
    rank's (R, L_local, ...) stage slice; microbatches flow through the
    GPipe schedule (parallel/pipeline.py), each stage running its local
    layers, and the last stage's activations come back on every rank for
    the (pp-replicated) unembedding."""
    x = _embed(params["embed"], tokens)  # (R, B, T, D)
    R, B = x.shape[:2]
    M = n_microbatches
    assert B % M == 0, (B, M)
    mb = x.reshape(R, M, B // M, *x.shape[2:])
    blk = _block_fn(cfg, wire, remat, mesh)
    stage_layers = params["layers"]
    n_local = stage_layers["wq"].shape[1]

    def stage(h):
        for i in range(n_local):
            h = blk(h, {k: v[:, i] for k, v in stage_layers.items()})
        return h

    out = gpipe_schedule(mb, stage, mesh=mesh, axis="pp", wire=wire)
    return _head(out.reshape(x.shape), params["unembed"], cfg)


def _tokens(mesh, tokens, spec):
    return mesh.shard(torch.as_tensor(tokens).long(), spec)


def make_forward(cfg: TransformerConfig, mesh,
                 n_microbatches: int | None = None):
    """The mesh forward: fn(params, tokens (B, T)) -> logits (B, T, V),
    batch over dp, sequence over sp, heads over tp; with a `pp` axis the
    layer stack pipelines over it. params are shard_params' stacked
    tree; the logits are read back from the tp (and pp) coordinate-0
    ranks, as the reference's out_specs P("dp", "sp") reads them."""
    wire = schedules.Wire(None)
    pp = _pp_world(mesh)
    M = n_microbatches or pp

    def fn(params, tokens):
        tok = _tokens(mesh, tokens, P("dp", "sp"))
        if pp > 1:
            logits = _forward_local_pp(params, tok, cfg, wire, M, mesh=mesh)
        else:
            logits = _forward_local(params, tok, cfg, wire, mesh=mesh)
        return mesh.unshard(logits, P("dp", "sp"))

    return fn


# KV-cache layout: (batch over dp, seq, heads over tp, head_dim): ONE
# constant shared by allocation and the decode step
_KV_SPEC = P("dp", None, "tp", None)


def init_kv_cache(cfg: TransformerConfig, mesh, batch: int, max_len: int):
    """Per-layer KV cache for incremental decode, the mesh's stacked
    (R, batch/dp, max_len, kv_heads/tp, head_dim) zeros: batch over dp,
    kv heads over tp (decode emits one token at a time, so sp must be 1
    on the decode mesh)."""
    shape = mesh.local_shape(_KV_SPEC, (batch, max_len, cfg.kv_heads,
                                        cfg.head_dim))
    dt = _torch_dtype(cfg)
    return [{"k": torch.zeros((mesh.size, *shape), dtype=dt,
                              device=mesh.device),
             "v": torch.zeros((mesh.size, *shape), dtype=dt,
                              device=mesh.device)}
            for _ in range(cfg.n_layers)]


def _decode_block(x, lyr, cfg: TransformerConfig, ck, cv, pos, wire, mesh):
    """One block for a single new token position over the stacked (R, B,
    1, D) x: write this position's (rotated, grouped) k/v into the cache
    at pos, in place (the counterpart of the donated cache; pos clamped
    into [0, max_len-1] as dynamic_update_slice clamps it), and attend
    over cache[:pos+1] (a masked full-length product, so every step has
    the same shapes). pos is a 0-d int64 tensor on the mesh's device:
    nothing here waits for the host."""
    h = _rmsnorm(x, _ranked(lyr["ln1"]))
    # pos[None]: the (1,) absolute position of this token
    q, k_new, v_new = _qkv(h, lyr, cfg, pos[None])
    T = ck.shape[2]
    at = pos.clamp(0, T - 1)[None]
    ck.index_copy_(2, at, k_new)
    cv.index_copy_(2, at, v_new)
    R, B = q.shape[:2]
    groups = cfg.n_heads // cfg.kv_heads
    # (R, B, 1, Hkv, G, hd) x (R, B, T, Hkv, hd) -> (R, B, Hkv, G, T)
    qg = q.reshape(R, B, 1, -1, groups, q.shape[-1])
    scores = torch.einsum("rbqhgk,rbthk->rbhgt", qg, ck) / math.sqrt(
        q.shape[-1])
    mask = torch.arange(T, device=ck.device) > pos
    scores = torch.where(mask, -math.inf, scores.float())
    attn = torch.softmax(scores, dim=-1).to(cv.dtype)
    ctx = torch.einsum("rbhgt,rbthk->rbhgk", attn, cv)
    ctx = ctx.reshape(R, B, 1, -1, ctx.shape[-1])  # (R, B, 1, H, hd)
    o_partial = torch.einsum("rbthk,rhkd->rbtd", ctx, lyr["wo"])
    x = x + _tp_allreduce(o_partial, wire, "tp", mesh)
    return _mlp_half(x, lyr, wire, "tp", mesh), ck, cv


def make_decode_step(cfg: TransformerConfig, mesh):
    """One incremental-decode step (the inference half of the model
    family): step(params, cache, tokens (B, 1), pos) -> (logits (B, 1,
    V), cache). Batch over dp, heads + ffn over tp, the same tp partial
    sums as training. sp/pp must be 1 on the decode mesh. The cache is
    updated in place (the reference donates it); `pos` may be a (1,)
    tensor on the mesh's device, and then no step waits for the host."""
    for ax in ("sp", "pp"):
        if mesh.shape.get(ax, 1) != 1:
            raise ValueError(f"decode mesh must have {ax}=1")
    wire = schedules.Wire(None)

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        tok = _tokens(mesh, tokens, P("dp", None))[:, :, :1]
        x = _embed(params["embed"], tok)
        p = torch.as_tensor(pos, device=mesh.device).reshape(-1)[0].long()
        for lyr, c in zip(params["layers"], cache):
            x, _, _ = _decode_block(x, lyr, cfg, c["k"], c["v"], p, wire,
                                    mesh)
        logits = _head(x, params["unembed"], cfg)
        return mesh.unshard(logits, P("dp", None)), cache

    return step


def _striped_grad_sync(grads: dict, pspecs: dict, wire, stripes: int,
                       mesh) -> dict:
    """Bucketed gradient sync, the stripe-overlapped form: per-leaf tp
    treatment first (the rescale-vs-allreduce logic is per spec), then
    ONE flat dp+sp mean-allreduce over the concatenated gradient rows in
    backward order, cut into `stripes` stripes, each its own allreduce
    chain. The reference's serial twin (order-barriered stripes) has no
    counterpart: on one CUDA stream the stripes already run in turn."""
    tp_world = mesh.axis_size("tp")

    def tp_fix(g, spec):
        if tp_world > 1:
            if _spec_has_axis(spec, "tp"):
                return g / tp_world
            return _grad_allreduce(g, "tp", wire, mesh)
        return g

    grads = _tree_map(tp_fix, grads, pspecs)
    leaves = _backward_ordered_leaves(grads)
    R = leaves[0].shape[0]
    flat = torch.cat([g.reshape(R, -1) for g in leaves], dim=1)
    n = flat.shape[-1]
    per = -(-n // max(stripes, 1))
    outs = []
    for lo in range(0, n, per):
        seg = flat[:, lo:lo + per]
        for ax in ("dp", "sp"):
            seg = _grad_allreduce(seg, ax, wire, mesh)
        outs.append(seg)
    flat = torch.cat(outs, dim=1)
    parts, off = [], 0
    for g in leaves:
        size = g[0].numel()
        parts.append(flat[:, off:off + size].reshape(g.shape))
        off += size
    it = iter(parts[1:-1])
    rev = [{k: next(it) for k in _LAYER_BWD_ORDER} for _ in grads["layers"]]
    # the parameter tree's own key order
    return {"embed": parts[-1], "unembed": parts[0],
            "layers": [{k: lyr[k] for k in grads["layers"][0]}
                       for lyr in rev[::-1]]}


def _default_grad_stripes(cfg: TransformerConfig, mesh) -> int:
    """The cost model's stripe count under the shipped calibration
    (timing.best_overlap_stripes with the shaped link and the measured
    compute term); no calibration gives 1, never a made-up depth."""
    from ..sequencer.timing import best_overlap_stripes
    from ..telemetry import feedback as _fb

    tl = _fb.default_tier_links()
    link = tl.outer if tl is not None else _fb.default_link()
    fit = _fb.default_compute_fit()
    if link is None or fit is None:
        return 1
    nbytes = train_param_count(cfg) * 4
    sync_world = max(mesh.shape.get("dp", 1), mesh.shape.get("sp", 1))
    return best_overlap_stripes(
        link, nbytes // 4, 4, max(sync_world, 2),
        compute_s=fit.seconds(nbytes), rx_buf_bytes=1024)


def make_train_step(cfg: TransformerConfig, mesh, lr: float = 1e-3,
                    n_microbatches: int | None = None, remat: bool = False,
                    grad_sync: str = "leaf",
                    grad_stripes: int | None = None):
    """One SGD step over the mesh: step(params, tokens (B, T), targets)
    -> (new_params, loss), params and new_params shard_params' stacked
    tree. Forward, backward (torch.autograd through the differentiable
    collectives: a tp allreduce's backward is an allreduce, as JAX
    transposes it), gradient sync and update all run on the mesh's
    device. The backward is seeded with the SUM of the ranks' losses, so
    each rank's cotangent is the one its own loss gives in the reference.
    With a `pp` axis the layers pipeline over it (GPipe microbatches)
    and params take the stacked form (stack_layer_params /
    pp_param_specs). remat=True recomputes each block in the backward.

    grad_sync picks the dp/sp gradient-sync shape: "leaf" (per-leaf
    allreduces), "striped" (one flat backward-ordered gradient vector
    allreduced as `grad_stripes` stripes, _striped_grad_sync) or
    "striped_serial" (the reference's order-barriered twin: on one CUDA
    stream the same values and the same launch order as "striped").
    grad_stripes=None takes the cost model's count
    (_default_grad_stripes). `step.grads(params, tokens, targets)` is the
    step before its update: (the synced gradient tree, the loss); the
    step returns p - lr * g of those."""
    if grad_sync not in ("leaf", "striped", "striped_serial"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    wire = schedules.Wire(None)
    pp = _pp_world(mesh)
    M = (n_microbatches or pp) if pp > 1 else 1
    pspecs = pp_param_specs(cfg) if pp > 1 else param_specs(cfg)
    if grad_sync != "leaf" and pp > 1:
        raise NotImplementedError(
            "striped grad sync covers the pp=1 layer-list form")
    if grad_sync != "leaf" and grad_stripes is None:
        grad_stripes = _default_grad_stripes(cfg, mesh)
    tp_world = mesh.axis_size("tp")

    def sync(g, spec):
        # every param saw only its dp batch shard and sp sequence shard:
        # mean-reduce over both axes
        g = _grad_allreduce(g, "dp", wire, mesh)
        g = _grad_allreduce(g, "sp", wire, mesh)
        if tp_world > 1:
            # the ring allreduce's transpose is itself an allreduce, so a
            # replicated cotangent entering a tp branch comes back tp x:
            # tp-sharded weight grads are rescaled, tp-replicated params
            # (which saw only their rank's head/ff slice) mean-allreduced
            if _spec_has_axis(spec, "tp"):
                g = g / tp_world
            else:
                g = _grad_allreduce(g, "tp", wire, mesh)
        return g

    def grads(params, tokens, targets):
        tok = _tokens(mesh, tokens, P("dp", "sp"))
        tgt = _tokens(mesh, targets, P("dp", "sp"))
        leaves = [p.detach().requires_grad_() for p in _tree_leaves(params)]
        it = iter(leaves)
        tree = _tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            if pp > 1:
                logits = _forward_local_pp(tree, tok, cfg, wire, M,
                                           remat=remat, mesh=mesh)
            else:
                logits = _forward_local(tree, tok, cfg, wire, remat=remat,
                                        mesh=mesh)
            logp = torch.log_softmax(logits.float(), -1)
            del logits
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
            loss = nll.mean(dim=(1, 2))  # (R,): each rank's own loss
            g = torch.autograd.grad(loss.sum(), leaves)
        del logp, nll
        it = iter(g)
        g = _tree_map(lambda _: next(it), params)
        if grad_sync == "leaf":
            g = _tree_map(sync, g, pspecs)
        else:
            g = _striped_grad_sync(g, pspecs, wire,
                                   stripes=int(grad_stripes or 1), mesh=mesh)
        if pp > 1:
            # microbatches enter on pp coordinate 0 only, so the embed
            # cotangent lands there (zeros elsewhere): SUM over pp
            # replicates it; unembed's is already the same on every pp
            # rank, stage leaves are stage-local
            g["embed"] = collectives.allreduce(g["embed"], mesh, "pp", wire)
        loss = loss.detach()[:, None]
        for ax in ("dp", "sp"):
            loss = collectives.allreduce(loss, mesh, ax, wire) \
                / mesh.axis_size(ax)
        return g, loss[0, 0]

    def step(params, tokens, targets):
        g, loss = grads(params, tokens, targets)
        return _tree_map(lambda p, gi: p - lr * gi.to(p.dtype), params,
                         g), loss

    step.grads = grads
    return step


def demo_batch(cfg: TransformerConfig, mesh, batch=4, seq=64, seed=0):
    """Tokens from a seed and the next-token targets (the tokens rolled
    by one), global (batch, seq) int64 tensors on the mesh's device."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq))
    targets = np.roll(tokens, -1, axis=1)
    return (torch.as_tensor(tokens, device=mesh.device),
            torch.as_tensor(targets, device=mesh.device))


# ---------------------------------------------------------------------------
# The device-resident train step: forward + backward + gradient allreduce +
# SGD update recorded as ONE descriptor batch
# ---------------------------------------------------------------------------

# kernel-stream id the train step's fwd+bwd consumer registers under
TRAIN_GRAD_STREAM = 21

# per-layer leaf order of the flat gradient/parameter vector, REVERSE
# backward-materialization order within a block: the backward produces
# the MLP's grads before the attention's, so the flat layout (unembed,
# layers N-1..0 each in this order, embed) puts the earliest-available
# gradients first, where stripe 0 of an overlapped allreduce reads them
_LAYER_BWD_ORDER = ("w_down", "w_up", "ln2", "wo", "wkv", "wq", "ln1")


def _backward_ordered_leaves(tree: dict) -> list:
    """The parameter/gradient leaves of the transformer tree in
    backward-materialization order (see _LAYER_BWD_ORDER)."""
    leaves = [tree["unembed"]]
    for lyr in reversed(tree["layers"]):
        leaves.extend(lyr[k] for k in _LAYER_BWD_ORDER)
    leaves.append(tree["embed"])
    return leaves


def _tree_from_leaves(leaves: list, cfg: TransformerConfig) -> dict:
    """Inverse of _backward_ordered_leaves."""
    it = iter(leaves[1:-1])
    rev_layers = [{k: next(it) for k in _LAYER_BWD_ORDER}
                  for _ in range(cfg.n_layers)]
    return {"unembed": leaves[0], "embed": leaves[-1],
            "layers": rev_layers[::-1]}


def _train_leaf_shapes(cfg: TransformerConfig) -> list:
    """Leaf shapes of the flat train-step parameter vector, in the order
    _backward_ordered_leaves uses."""
    d, ff = cfg.d_model, cfg.d_ff
    layer = {
        "w_down": (ff, d), "w_up": (d, ff), "ln2": (d,),
        "wo": (cfg.n_heads, cfg.head_dim, d),
        "wkv": (d, 2, cfg.kv_heads, cfg.head_dim),
        "wq": (d, cfg.n_heads, cfg.head_dim), "ln1": (d,),
    }
    shapes: list = [(d, cfg.vocab)]  # unembed
    for _ in range(cfg.n_layers):
        shapes.extend(layer[k] for k in _LAYER_BWD_ORDER)
    shapes.append((cfg.vocab, d))  # embed
    return shapes


def train_param_count(cfg: TransformerConfig) -> int:
    """Element count of the flat train-step parameter vector: the `count`
    of every descriptor in the fused train-step batch."""
    return sum(math.prod(s) for s in _train_leaf_shapes(cfg))


def _split_flat(flat, cfg: TransformerConfig) -> list:
    """A flat (n,) vector cut into its leaves, as views."""
    parts, off = [], 0
    for sh in _train_leaf_shapes(cfg):
        size = math.prod(sh)
        parts.append(flat[off:off + size].view(sh))
        off += size
    return parts


def flatten_train_params(params: dict) -> torch.Tensor:
    """Parameter/gradient tree -> flat vector in backward order, the
    layout of every train-step buffer (bitwise the reference's)."""
    return torch.cat([t.reshape(-1)
                      for t in _backward_ordered_leaves(params)])


def unflatten_train_params(flat, cfg: TransformerConfig) -> dict:
    """Inverse of flatten_train_params; the leaves are views of `flat`."""
    return _tree_from_leaves(_split_flat(flat, cfg), cfg)


def local_train_loss(params: dict, tokens, targets,
                     cfg: TransformerConfig):
    """Mean next-token NLL of the axis-free forward (forward_local), the
    log-softmax in fp32 and one gathered target a row."""
    logits = forward_local(params, tokens, cfg)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


def make_grad_consumer(cfg: TransformerConfig, tokens, targets,
                       scale: float = 1.0, device="cuda"):
    """The forward+backward as a RES_STREAM consumer over the stacked
    copy result (world, n): row r, rank r's flat parameters, runs the
    local fwd+bwd over its batch shard tokens[r] / targets[r] ((world, B,
    T) ints, placed on `device` once here: the card unless the caller
    names the CPU, so a captured step copies no index from the host) and
    lands its flat gradient (backward order) in row r of the result.

    `scale` (rounded to fp32, as the reference's np.float32) multiplies
    the loss BEFORE the backward, so the consumer emits grad(scale *
    loss). The train step passes -lr/world: the allreduce then sums
    per-rank update contributions and the final combine is a pure add
    (the reference's docstring says why: a multiply after the allreduce
    rounds differently in the fused program than in the eager twin).

    Ranks run one after another so a CUDA graph's pool reuses one rank's
    activations. Each leaf is a view of the row made a leaf of its own,
    so the gradients come back leaf by leaf and are concatenated once
    into the result row (a gradient taken through the views would
    materialize a full-width zero vector per leaf). The embedding
    gather's backward is index_put_ with accumulate=True, which on CUDA
    takes PyTorch's sorted, deterministic kernel, so two runs agree
    bitwise. The scale is a Python float (no host-to-device copy) and
    nothing syncs with the host: the consumer is capturable."""
    tok = torch.as_tensor(tokens).to(device=device, dtype=torch.int64)
    tgt = torch.as_tensor(targets).to(device=device, dtype=torch.int64)
    s = torch.tensor(scale, dtype=torch.float32).item()

    def consumer(params_flat):
        out = torch.empty_like(params_flat)
        rows = params_flat.to(torch.float32)
        with torch.enable_grad():
            for r in range(rows.shape[0]):
                leaves = [p.detach().requires_grad_()
                          for p in _split_flat(rows[r], cfg)]
                loss = local_train_loss(_tree_from_leaves(leaves, cfg),
                                        tok[r], tgt[r], cfg)
                grads = torch.autograd.grad(s * loss, leaves)
                torch.cat([g.reshape(-1) for g in grads], out=out[r])
        return out

    return consumer


def create_train_step_buffers(accl, cfg: TransformerConfig):
    """(params, grads, update, new_params) flat rank buffers for the
    fused train step, each (world, train_param_count) fp32."""
    n = train_param_count(cfg)
    return tuple(accl.create_buffer(n, torch.float32) for _ in range(4))


def _register_train_consumers(accl, cfg: TransformerConfig, tokens,
                              targets, lr: float):
    # the dp mean and the SGD learning rate fold into the backward's seed:
    # each rank emits its UPDATE contribution grad(-lr/world * loss_r)
    accl.register_stream_consumer(
        TRAIN_GRAD_STREAM,
        make_grad_consumer(cfg, tokens, targets, scale=-lr / accl.world,
                           device=accl.cclo.torch_device))


def record_train_step(accl, cfg: TransformerConfig, tokens, targets, *,
                      lr: float = 1e-3, lint: str = "error",
                      buffers=None):
    """Record the data-parallel train step as ONE descriptor batch over
    `accl`'s world:

      1. copy(params -> grads) with the fwd+bwd as its RES_STREAM
         consumer (the -lr/world scale rides the backward's seed);
      2. allreduce(grads -> update, SUM): inside the OVERLAP_MIN_COUNT
         window the plan stripes it into independent chains;
      3. combine(SUM, params, update -> new_params): the SGD step.

    Returns (recorder, buffers); `recorder.compile()` freezes it (on the
    card one CUDA graph), and the same three descriptors issued eagerly
    (`run_train_step_eager`) are its bitwise twin."""
    if buffers is None:
        buffers = create_train_step_buffers(accl, cfg)
    pbuf, gbuf, ubuf, obuf = buffers
    n = train_param_count(cfg)
    _register_train_consumers(accl, cfg, tokens, targets, lr)
    seq = accl.sequence(lint=lint)
    seq.copy(pbuf, gbuf, n, res_stream=TRAIN_GRAD_STREAM)
    seq.allreduce(gbuf, ubuf, n, ReduceFunction.SUM)
    seq.combine(n, ReduceFunction.SUM, pbuf, ubuf, obuf)
    return seq, buffers


def make_train_step_program(accl, cfg: TransformerConfig, tokens,
                            targets, *, lr: float = 1e-3,
                            lint: str = "error", buffers=None):
    """The steady-state fused train step: record once, compile once (on
    the card one CUDA-graph capture), dispatch ONE program per iteration.
    Returns (program, buffers); the caller's loop is `write params ->
    program.run() -> read new_params`."""
    seq, buffers = record_train_step(accl, cfg, tokens, targets, lr=lr,
                                     lint=lint, buffers=buffers)
    return seq.compile(), buffers


def run_train_step_eager(accl, cfg: TransformerConfig, buffers):
    """The dispatch-per-call twin: the SAME three descriptors the fused
    batch records, issued eagerly with the intermediates kept on the
    device. Bitwise-identical to the fused program; the consumer must be
    registered (`_register_train_consumers`, or a recorded step on the
    same facade)."""
    pbuf, gbuf, ubuf, obuf = buffers
    n = train_param_count(cfg)
    accl.copy_to_stream(pbuf, n, res_stream=TRAIN_GRAD_STREAM,
                        dstbuf=gbuf, from_device=True, to_device=True)
    accl.allreduce(gbuf, ubuf, n, ReduceFunction.SUM, from_device=True,
                   to_device=True)
    accl.combine(n, ReduceFunction.SUM, pbuf, ubuf, obuf,
                 from_device=True, to_device=True)
    return accl._last_request


# ---------------------------------------------------------------------------
# The device-resident decode step: N layers of KV-cached single-token
# attention + MLP, each closed by a TP partial-sum allreduce, recorded as
# ONE descriptor batch
# ---------------------------------------------------------------------------

# kernel-stream id base for the decode step's consumers: attention for
# layer l registers at base + 2l, its MLP at base + 2l + 1, and the final
# logits head at base + 2*n_layers
DECODE_STREAM_BASE = 40


def decode_attn_stream(layer: int) -> int:
    return DECODE_STREAM_BASE + 2 * layer


def decode_mlp_stream(layer: int) -> int:
    return DECODE_STREAM_BASE + 2 * layer + 1


def decode_logits_stream(cfg: TransformerConfig) -> int:
    return DECODE_STREAM_BASE + 2 * cfg.n_layers


@dataclasses.dataclass(frozen=True)
class DecodeDims:
    """Flat-buffer geometry of the fused decode step. The facade world
    is the TENSOR-PARALLEL world: each rank's state buffer carries its
    kv-head slice of the cache, and the two allreduces per layer are the
    tp partial-sum reductions of the sharded model."""

    batch: int
    max_len: int
    d_model: int
    vocab: int
    heads_local: int
    kv_heads_local: int
    ff_local: int
    # [x (B*D) | pos (B) | k-cache | v-cache], per rank
    n_state: int
    # [x (B*D) | pos (B)] on the way in, logits (B*V) on the way out:
    # one width serves both, so the x/pos prefix survives in the tail
    n_out: int


def decode_dims(cfg: TransformerConfig, world: int, batch: int,
                max_len: int) -> DecodeDims:
    for name, dim in (("n_heads", cfg.n_heads),
                      ("kv_heads", cfg.kv_heads), ("d_ff", cfg.d_ff)):
        if dim % world:
            raise ValueError(
                f"decode facade world {world} must divide {name}={dim}")
    if _torch_dtype(cfg) != torch.float32:
        raise ValueError("the fused decode step rides fp32 rank buffers")
    kvl = cfg.kv_heads // world
    b_d = batch * cfg.d_model
    return DecodeDims(
        batch=batch, max_len=max_len, d_model=cfg.d_model, vocab=cfg.vocab,
        heads_local=cfg.n_heads // world, kv_heads_local=kvl,
        ff_local=cfg.d_ff // world,
        n_state=b_d + batch + 2 * batch * max_len * kvl * cfg.head_dim,
        n_out=max(batch * cfg.vocab, b_d + batch),
    )


def _stack_ranks(w, axis: int, world: int, device):
    """Cut `w` along `axis` into `world` equal slices, stacked on a new
    leading rank axis (contiguous): rank r's slice is the reference's
    dynamic_slice_in_dim(w, r * n, n, axis)."""
    w = w.to(device=device, dtype=torch.float32)
    n = w.shape[axis] // world
    shape = (*w.shape[:axis], world, n, *w.shape[axis + 1:])
    return w.reshape(shape).movedim(axis, 0).contiguous()


def make_decode_attn_consumer(cfg: TransformerConfig, lyr: dict,
                              dims: DecodeDims, world: int, device=None):
    """Layer attention as a RES_STREAM consumer over the stacked state
    (world, n_state), each row a rank's [x, pos, kv-cache]: rmsnorm, the
    rank's q/kv head slice, per-slot RoPE, the per-slot cache append at
    pos, masked full-length grouped attention and the rank's wo partial
    product, landing [o_partial, pos, new kv-cache].

    The append clamps pos into [0, max_len-1] as lax.dynamic_update_slice
    does, and selects the row on the card (pos never leaves it), so the
    consumer is capturable into a CUDA graph."""
    B, T, D = dims.batch, dims.max_len, dims.d_model
    W, hd = world, cfg.head_dim
    hl, kvl = dims.heads_local, dims.kv_heads_local
    groups = cfg.n_heads // cfg.kv_heads
    device = lyr["wq"].device if device is None else device
    wq = _stack_ranks(lyr["wq"], 1, W, device)  # (W, D, hl, hd)
    wkv = _stack_ranks(lyr["wkv"], 2, W, device)  # (W, D, 2, kvl, hd)
    wo = _stack_ranks(lyr["wo"], 0, W, device)  # (W, hl, hd, D)
    ln1 = lyr["ln1"].to(device=device, dtype=torch.float32)
    b_d = B * D
    scale = math.sqrt(hd)

    def consumer(state):
        x = state[:, :b_d].reshape(W, B, D)
        pos = state[:, b_d:b_d + B].to(torch.int32)  # (W, B)
        kv = state[:, b_d + B:].reshape(W, 2, B, T, kvl, hd)
        h = _rmsnorm(x, ln1)
        q = torch.einsum("wbd,wdhk->wbhk", h, wq)
        kvp = torch.einsum("wbd,wdchk->wbchk", h, wkv)
        k_new, v_new = kvp[:, :, 0], kvp[:, :, 1]
        if cfg.rope:
            q = _rope_slots(q, pos, cfg.rope_theta)
            k_new = _rope_slots(k_new, pos, cfg.rope_theta)
        out = torch.empty_like(state)
        cache = out[:, b_d + B:].view(W, 2, B, T, kvl, hd)
        t = torch.arange(T, device=state.device)
        at = (t == pos.clamp(0, T - 1)[..., None])[..., None, None]
        torch.where(at, k_new[:, :, None], kv[:, 0], out=cache[:, 0])
        torch.where(at, v_new[:, :, None], kv[:, 1], out=cache[:, 1])
        ck, cv = cache[:, 0], cache[:, 1]
        qg = q.reshape(W, B, kvl, groups, hd)
        scores = torch.einsum("wbhgk,wbthk->wbhgt", qg, ck) / scale
        masked = (t > pos[..., None])[:, :, None, None, :]
        scores = torch.where(masked, -math.inf, scores.float())
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("wbhgt,wbthk->wbhgk", attn, cv)
        o_partial = torch.einsum("wbhk,whkd->wbd",
                                 ctx.reshape(W, B, hl, hd), wo)
        out[:, :b_d] = o_partial.reshape(W, b_d)
        out[:, b_d:b_d + B] = pos.to(state.dtype)
        return out

    return consumer


def make_decode_mlp_consumer(cfg: TransformerConfig, lyr: dict,
                             dims: DecodeDims, world: int, device=None):
    """Layer MLP as a RES_STREAM consumer over the stacked post-attention
    residual x2 (world, B*D): ln2 + each rank's gelu MLP d_ff slice,
    emitting the down-projection partial sum the next allreduce closes."""
    B, D, W = dims.batch, dims.d_model, world
    device = lyr["w_up"].device if device is None else device
    w_up = _stack_ranks(lyr["w_up"], 1, W, device)  # (W, D, ffl)
    w_down = _stack_ranks(lyr["w_down"], 0, W, device)  # (W, ffl, D)
    ln2 = lyr["ln2"].to(device=device, dtype=torch.float32)

    def consumer(x2):
        h = _rmsnorm(x2.reshape(W, B, D), ln2)
        up = _gelu(torch.einsum("wbd,wdf->wbf", h, w_up))
        down = torch.einsum("wbf,wfd->wbd", up, w_down)
        return down.reshape(W, B * D).to(x2.dtype)

    return consumer


def make_decode_logits_consumer(cfg: TransformerConfig, params: dict,
                                dims: DecodeDims, world: int, device=None):
    """Final rmsnorm + unembed projection over the last layer's residual
    prefix, zero-padded to the n_out row width (the replicated head:
    every rank computes identical logits, the host reads row 0). One
    product of all ranks' rows, (W*B, D) @ (D, V)."""
    B, D, V, W = dims.batch, dims.d_model, dims.vocab, world
    unembed = params["unembed"]
    device = unembed.device if device is None else device
    unembed = unembed.to(device=device, dtype=torch.float32)
    ones = torch.ones(D, dtype=torch.float32, device=device)
    pad = dims.n_out - B * V

    def consumer(xp):
        x = _rmsnorm(xp[:, :B * D].reshape(W * B, D), ones)
        logits = (x @ unembed).reshape(W, B * V).to(xp.dtype)
        return F.pad(logits, (0, pad)) if pad else logits

    return consumer


@dataclasses.dataclass
class DecodeBuffers:
    """The fused decode step's rank buffers (each (world, n) fp32).
    `state[l]` persists layer l's kv cache across dispatches in its tail
    (only its [x, pos] prefix is re-staged per step), so the cache never
    crosses the host boundary in the steady state."""

    dims: DecodeDims
    xp: object  # [x, pos] in / logits landing width (n_out)
    logits: object  # final logits (n_out)
    state: list  # per-layer [x, pos, kv] (n_state)
    attn_sum: object  # allreduced attention output (B*D)
    x2: object  # post-attention residual (B*D)
    mlp_partial: object  # MLP consumer output (B*D)
    mlp_sum: object  # allreduced MLP output (B*D)

    @property
    def persistent(self) -> tuple:
        """The buffers whose tails are device-resident dispatch-to-
        dispatch state: the per-layer [x, pos, kv] states and xp (pos
        rides behind each layer's B*D-wide residual write). Declared on
        the recorded sequence so the hazard pass holds every OTHER buffer
        to the full ACCL101 contract."""
        return (self.xp, *self.state)


def create_decode_buffers(accl, cfg: TransformerConfig, batch: int,
                          max_len: int) -> DecodeBuffers:
    dims = decode_dims(cfg, accl.world, batch, max_len)
    b_d = batch * cfg.d_model
    f32 = torch.float32
    return DecodeBuffers(
        dims=dims,
        xp=accl.create_buffer(dims.n_out, f32),
        logits=accl.create_buffer(dims.n_out, f32),
        state=[accl.create_buffer(dims.n_state, f32)
               for _ in range(cfg.n_layers)],
        attn_sum=accl.create_buffer(b_d, f32),
        x2=accl.create_buffer(b_d, f32),
        mlp_partial=accl.create_buffer(b_d, f32),
        mlp_sum=accl.create_buffer(b_d, f32),
    )


def register_decode_consumers(accl, cfg: TransformerConfig, params: dict,
                              dims: DecodeDims):
    """Register the step's 2*n_layers + 1 consumers on `accl`, their
    weights stacked per rank on the facade's device."""
    device = accl.cclo.torch_device
    for l, lyr in enumerate(params["layers"]):
        accl.register_stream_consumer(
            decode_attn_stream(l),
            make_decode_attn_consumer(cfg, lyr, dims, accl.world, device))
        accl.register_stream_consumer(
            decode_mlp_stream(l),
            make_decode_mlp_consumer(cfg, lyr, dims, accl.world, device))
    accl.register_stream_consumer(
        decode_logits_stream(cfg),
        make_decode_logits_consumer(cfg, params, dims, accl.world, device))


def _decode_layer_steps(seq_or_accl, cfg, buffers: DecodeBuffers,
                        layer: int, *, eager: bool):
    """The 7 descriptors of one decode layer: ONE list shared by the
    recorded and eager forms so the two cannot diverge:

      1. copy(xp -> state[l], B*D+B): stage [x, pos] into the state
         prefix (the kv tail survives: a partial-width prefix write);
      2. copy(state[l] -> state[l], n_state) through the ATTN consumer:
         [x, pos, kv] -> [o_partial, pos, new kv] in place;
      3. allreduce(state[l] -> attn_sum, B*D, SUM): the tp partial-sum
         reduction over the o projections (reads the state prefix);
      4. combine(SUM, xp, attn_sum -> x2, B*D): the residual add;
      5. copy(x2 -> mlp_partial, B*D) through the MLP consumer;
      6. allreduce(mlp_partial -> mlp_sum, B*D, SUM);
      7. combine(SUM, x2, mlp_sum -> xp, B*D): the layer output back into
         xp's PREFIX; pos rides untouched in the tail for layer l+1.
    """
    d = buffers.dims
    b_d = d.batch * d.d_model
    kw = (dict(from_device=True, to_device=True) if eager else {})
    s = seq_or_accl
    if eager:
        s.copy(buffers.xp, buffers.state[layer], b_d + d.batch,
               from_device=(layer > 0), to_device=True)
        s.copy_to_stream(buffers.state[layer], d.n_state,
                         res_stream=decode_attn_stream(layer),
                         dstbuf=buffers.state[layer], **kw)
    else:
        s.copy(buffers.xp, buffers.state[layer], b_d + d.batch)
        s.copy(buffers.state[layer], buffers.state[layer], d.n_state,
               res_stream=decode_attn_stream(layer))
    s.allreduce(buffers.state[layer], buffers.attn_sum, b_d,
                ReduceFunction.SUM, **kw)
    s.combine(b_d, ReduceFunction.SUM, buffers.xp, buffers.attn_sum,
              buffers.x2, **kw)
    if eager:
        s.copy_to_stream(buffers.x2, b_d,
                         res_stream=decode_mlp_stream(layer),
                         dstbuf=buffers.mlp_partial, **kw)
    else:
        s.copy(buffers.x2, buffers.mlp_partial, b_d,
               res_stream=decode_mlp_stream(layer))
    s.allreduce(buffers.mlp_partial, buffers.mlp_sum, b_d,
                ReduceFunction.SUM, **kw)
    s.combine(b_d, ReduceFunction.SUM, buffers.x2, buffers.mlp_sum,
              buffers.xp, **kw)


def record_decode_step(accl, cfg: TransformerConfig, params: dict, *,
                       batch: int, max_len: int, lint: str = "error",
                       buffers: DecodeBuffers | None = None):
    """Record the KV-cached single-token decode step as ONE descriptor
    batch over `accl`'s (tensor-parallel) world: n_layers x (attention
    consumer + tp allreduce + MLP consumer + tp allreduce) + the logits
    head, 7*n_layers + 1 descriptors. Returns (recorder, buffers);
    `recorder.compile()` freezes the steady-state SequenceProgram, and
    the same descriptors issued eagerly (`run_decode_step_eager`) are its
    bitwise twin."""
    if buffers is None:
        buffers = create_decode_buffers(accl, cfg, batch, max_len)
    d = buffers.dims
    register_decode_consumers(accl, cfg, params, d)
    seq = accl.sequence(lint=lint, persistent=buffers.persistent)
    for layer in range(cfg.n_layers):
        _decode_layer_steps(seq, cfg, buffers, layer, eager=False)
    seq.copy(buffers.xp, buffers.logits, d.n_out,
             res_stream=decode_logits_stream(cfg))
    return seq, buffers


def make_decode_step_program(accl, cfg: TransformerConfig, params: dict,
                             *, batch: int, max_len: int,
                             lint: str = "error",
                             buffers: DecodeBuffers | None = None):
    """The steady-state fused decode step: record once, compile once (on
    the card one CUDA-graph capture), dispatch ONE program per token. The
    caller's loop is `write_decode_inputs -> program.run(to_device=True)
    -> read_decode_logits(sync=True)`."""
    seq, buffers = record_decode_step(accl, cfg, params, batch=batch,
                                      max_len=max_len, lint=lint,
                                      buffers=buffers)
    return seq.compile(), buffers


def run_decode_step_eager(accl, cfg: TransformerConfig,
                          buffers: DecodeBuffers):
    """The dispatch-per-layer twin: the SAME 7*n_layers + 1 descriptors
    the fused batch records, issued eagerly (intermediates stay on the
    device). Bitwise-identical to the fused program."""
    for layer in range(len(buffers.state)):
        _decode_layer_steps(accl, cfg, buffers, layer, eager=True)
    d = buffers.dims
    accl.copy_to_stream(buffers.xp, d.n_out,
                        res_stream=decode_logits_stream(cfg),
                        dstbuf=buffers.logits, from_device=True)
    return accl._last_request


def write_decode_inputs(buffers: DecodeBuffers, params: dict, tokens,
                        pos):
    """Stage one step's inputs: embed `tokens` (B,) at per-slot positions
    `pos` (B,) into every rank row of the xp buffer's host image (the
    embedding is replicated, as in the sharded model); the rest of the
    row is zero."""
    d = buffers.dims
    b_d = d.batch * d.d_model
    embed = params["embed"]
    idx = torch.as_tensor(tokens, dtype=torch.int64, device=embed.device)
    row = torch.zeros(d.n_out, dtype=torch.float32)
    row[:b_d] = embed[idx].reshape(-1).to("cpu", torch.float32)
    row[b_d:b_d + d.batch] = torch.as_tensor(pos, dtype=torch.float32)
    buffers.xp.host[:] = row[None]


def read_decode_logits(buffers: DecodeBuffers, *,
                       sync: bool = False) -> torch.Tensor:
    """The step's logits (B, V), a CPU tensor, from rank row 0 (the
    replicated head). Pass sync=True after `program.run(to_device=True)`,
    which keeps every buffer on the device; the eager twin's final
    copy_to_stream already lands the logits host-side."""
    d = buffers.dims
    if sync:
        buffers.logits.sync_from_device()
    return buffers.logits.host[0, :d.batch * d.vocab].reshape(
        d.batch, d.vocab).clone()
