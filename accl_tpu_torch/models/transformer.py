"""The transformer of the port: the axis-free forward, the fused train
step and the fused KV-cache decode step over the ACCL facade.

Counterpart of accl_tpu/models/transformer.py, its facade half. The
reference's model is one shard_map program over a (dp, sp, tp) mesh; the
port has no mesh layer yet, so what lands here is what runs without
one:

  - the configuration, the parameter tree and the math helpers
    (`_rmsnorm`, `_rope`, `_rope_slots`, `_qkv`, `_local_attention`,
    `_mlp_half`, `_block` with no tp or sp axis);
  - `forward_local`, the full-context forward of `local_train_loss` up to
    the logits: the oracle the decode step is held against;
  - the data-parallel train step: the flat backward-ordered parameter
    layout, `local_train_loss`, the fwd+bwd as a stream consumer through
    torch.autograd, and copy -> allreduce -> combine recorded as ONE call
    sequence (`make_train_step_program`: on the card one CUDA-graph
    replay, forward and backward inside it) or issued eagerly
    (`run_train_step_eager`), bitwise the same;
  - the device-resident decode step: per layer an attention consumer, a
    tensor-parallel allreduce, the residual combine, an MLP consumer, a
    second allreduce and combine, then the logits head, recorded as ONE
    call sequence (`make_decode_step_program`: on the card one CUDA-graph
    replay) or issued eagerly (`run_decode_step_eager`), bitwise the same.

The facade world is the tensor-parallel world. The reference's consumer
runs per rank and picks its head and d_ff slice with `lax.axis_index`;
the port's consumer gets the stacked (world, n) state (ops/streams.py)
and contracts it against weights stacked once, at registration, into
per-rank slices: wq (D, H, hd) becomes (W, D, H/W, hd), and so on, so no
rank holds the full weights. Parameters are torch tensors; interop.
transformer_params_from_numpy converts the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..constants import ReduceFunction


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
    embeddings in fp32, half-split form."""
    D = x.shape[-1]
    assert D % 2 == 0, "rope needs an even head_dim"
    ang = pos.float()[:, None] * _inv_freq(D // 2, theta, x.device)[None, :]
    return _rotate(x, ang.cos()[None, :, None, :], ang.sin()[None, :, None, :])


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
    rotate q, k by the positions `pos`."""
    q = torch.einsum("btd,dhk->bthk", h, lyr["wq"])
    kv = torch.einsum("btd,dchk->btchk", h, lyr["wkv"])
    k, v = kv[:, :, 0], kv[:, :, 1]
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


def _mlp_half(x, lyr):
    """ln2 + gelu MLP + residual: the axis-free form (identity partial
    sum) of the reference's _mlp_half."""
    h = _rmsnorm(x, lyr["ln2"])
    up = _gelu(torch.einsum("btd,df->btf", h, lyr["w_up"]))
    return x + torch.einsum("btf,fd->btd", up, lyr["w_down"])


def _block(x, lyr, cfg: TransformerConfig):
    """One transformer block with no tp or sp axis: local causal
    attention at positions 0..T-1, identity partial sums (the
    reference's _block with tp_axis=sp_axis=None)."""
    h = _rmsnorm(x, lyr["ln1"])
    pos = torch.arange(h.shape[1], device=h.device)
    q, k, v = _qkv(h, lyr, cfg, pos)
    attn = _local_attention(q, k, v)
    x = x + torch.einsum("bthk,hkd->btd", attn, lyr["wo"])
    return _mlp_half(x, lyr)


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
