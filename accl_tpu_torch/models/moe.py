"""Expert-parallel Mixture-of-Experts on the facade's alltoall.

Counterpart of accl_tpu/models/moe.py, its facade half. The FFN is a
top-k routed MoE whose experts shard over the facade's ranks; the token
dispatch and the return combine move through the facade's alltoall (or
the capacity-bounded alltoallv), with the expert FFN spliced in as the
dispatch leg's RES_STREAM consumer, so one layer step is ONE recorded
call sequence (on the card one CUDA-graph replay).

Routing is capacity-based top-k (fixed shapes): each token routes to its
top_k experts (k=1 keeps the raw router probability as the gate; k>1
normalizes gates over the chosen k), each expert accepts at most C =
ceil(T * k / E * capacity_factor) pseudo-tokens per rank, and overflow
passes through on the residual stream.

The mesh forms (`moe_param_specs`, `place_moe_params`, `moe_ffn_local`,
`make_moe_forward`, `make_moe_train_step`) run over a (dp, ep) mesh of
virtual ranks (parallel/mesh.py): tokens shard over both axes, experts
over ep, and both legs are parallel/collectives.py's differentiable
alltoall along ep, vmapped over each rank's sequences as extra leading
dimensions of the exchange.

DeepSeek-V3's MoE layer (`V3MoEConfig`, `v3_route`, `V3Routing`,
`V3MoEStep`) is the port's own, with no counterpart in the reference:
the group-limited sigmoid router, SwiGLU experts and a shared expert,
and a dropless expert-parallel exchange whose row placement the router
writes on the card inside the step's one replay (schedules.SlotRows). models/deepseek_v3_reference.py is its plain
reference.

Departures from the reference, which routes inside jit(vmap) on the host
and hands numpy arrays across: routing and combining run as torch ops on
the facade's device over the stacked ranks, the dispatch is placed
straight into the dispatch buffer's device image, and
`moe_ffn_via_sequence` returns a tensor on that device. The expert
consumer holds each rank's expert slice, cut once at registration, where
the reference picks it with `lax.axis_index`.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel.mesh import P
from ..sequencer import schedules
from ..telemetry import get_tracer
from .transformer import _gelu, _grad_allreduce, _tree_map

# kernel-stream id the expert-FFN consumer registers under
MOE_EXPERT_STREAM = 11


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 4       # total experts == world x experts_per_rank
    experts_per_rank: int = 1
    capacity_factor: float = 1.25
    top_k: int = 1           # experts per token (k=1: raw-prob gate;
                             # k>1: gates normalized over the chosen k)
    vocab: int = 64
    seq: int = 32
    dtype: str = "float32"


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device: torch.device | str = "cuda") -> dict:
    """The reference's global parameter tree (router replicated, experts
    stacked on the leading axis; normal weights at scale 0.02), drawn from
    `generator` on its own device and placed on `device`. Not bitwise
    with jax.random: interop.moe_params_from_numpy carries the JAX
    package's weights across."""
    dt = getattr(torch, cfg.dtype)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * 0.02
        return w.to(device=device, dtype=dt)

    return {"router": dense(D, E), "w_up": dense(E, D, Fd),
            "w_down": dense(E, Fd, D), "embed": dense(cfg.vocab, D),
            "unembed": dense(D, cfg.vocab)}


def moe_param_specs(cfg: MoEConfig) -> dict:
    return {
        "embed": P(),
        "router": P(),
        "w_up": P("ep"),
        "w_down": P("ep"),
        "unembed": P(),
    }


def place_moe_params(params, cfg: MoEConfig, mesh) -> dict:
    """Place a global MoE parameter tree according to moe_param_specs:
    each leaf the mesh's stacked (R, *local) tensor."""
    return _tree_map(mesh.shard, params, moe_param_specs(cfg))


def _capacity(cfg: MoEConfig, tokens: int) -> int:
    return max(1, math.ceil(tokens / cfg.n_experts * cfg.capacity_factor))


def _route(x, params, cfg: MoEConfig, C: int):
    """Top-k routing + capacity assignment for (..., T, D) tokens, each
    leading index (a rank, a sequence) routed on its own. Returns
    (dispatch (..., E, C, D), safe_e, safe_c, keep, gate), the last four
    (..., T*k) in token-major pseudo-token order.

    The top k come from a stable descending sort, so equal probabilities
    rank the lower expert first, as lax.top_k does. Dropped pseudo-tokens
    add +0.0 into slot (0, 0), which leaves every value exact."""
    T, D = x.shape[-2:]
    lead = x.shape[:-2]
    E, k = cfg.n_experts, cfg.top_k
    logits = x @ params["router"].to(x.device)  # (..., T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
    assign = topi.reshape(*lead, T * k)
    gate = gates.reshape(*lead, T * k)
    x_rep = x.repeat_interleave(k, dim=-2)  # (..., T*k, D)

    # capacity assignment: position of each pseudo-token within its expert
    onehot = F.one_hot(assign, E)
    pos_in_e = ((onehot.cumsum(-2) - 1) * onehot).sum(-1)
    keep = pos_in_e < C

    # dispatch (..., E, C, D): slot [e, c] = the c-th token routed to e
    safe_e = torch.where(keep, assign, 0)
    safe_c = torch.where(keep, pos_in_e, 0)
    rows = x_rep.reshape(-1, T * k, D)
    disp = torch.zeros((rows.shape[0], E, C, D), dtype=x.dtype,
                       device=x.device)
    b = torch.arange(rows.shape[0], device=x.device)[:, None]
    disp.index_put_(
        (b, safe_e.reshape(-1, T * k), safe_c.reshape(-1, T * k)),
        torch.where(keep.reshape(-1, T * k, 1), rows, 0.0), accumulate=True)
    return disp.reshape(*lead, E, C, D), safe_e, safe_c, keep, gate


def _combine_tokens(back, safe_e, safe_c, keep, gate, T: int, k: int,
                    D: int, dtype):
    """The gather-and-gate half of the combine over (..., E, C, D) expert
    outputs: each pseudo-token reads its slot, weights it by its gate, and
    each token's k contributions sum. Returns (..., T, D)."""
    lead = back.shape[:-3]
    flat = back.reshape(-1, *back.shape[-3:])
    b = torch.arange(flat.shape[0], device=back.device)[:, None]
    token_out = flat[b, safe_e.reshape(-1, T * k), safe_c.reshape(-1, T * k)]
    contrib = torch.where(
        keep.reshape(-1, T * k, 1),
        token_out * gate.reshape(-1, T * k, 1).to(dtype), 0.0)
    return contrib.reshape(*lead, T, k, D).sum(-2)


def moe_expert_consumer(cfg: MoEConfig, capacity: int, w_up, w_down,
                        world: int, device=None):
    """The expert-FFN stage as a RES_STREAM consumer over the dispatch
    alltoall's stacked routed arrival (world, world * n_local * C * D):
    row r holds the source-major blocks (world, n_local, C, D) for rank
    r's experts, which run before the result lands. The stacked expert
    weights (E, ...) are cut once here into each rank's (n_local, ...)
    block; re-registering with new weights is a new endpoint (the
    compiled-program caches key on it)."""
    n_local, C, D = cfg.experts_per_rank, capacity, cfg.d_model
    device = w_up.device if device is None else device
    wu = w_up.to(device=device, dtype=torch.float32).reshape(
        world, n_local, D, cfg.d_ff)
    wd = w_down.to(device=device, dtype=torch.float32).reshape(
        world, n_local, cfg.d_ff, D)

    def consumer(flat):
        recv = flat.reshape(world, world, n_local, C, D)
        h = _gelu(torch.einsum("wslcd,wldf->wslcf", recv, wu))
        out = torch.einsum("wslcf,wlfd->wslcd", h, wd)
        return out.reshape(world, -1).to(flat.dtype)

    return consumer


def make_expert_program(accl, cfg: MoEConfig, capacity: int, w_up,
                        w_down):
    """The UNFUSED expert stage: the same body as the stream consumer, as
    a plain function over the stacked routed rows (the reference compiles
    it as its own jit(shard_map) program): the middle stage of the eager
    descriptor-per-stage baseline."""
    return moe_expert_consumer(cfg, capacity, w_up, w_down, accl.world,
                               accl.cclo.torch_device)


def _ensure_expert_consumer(accl, cfg: MoEConfig, capacity: int, w_up,
                            w_down, stream_id: int) -> None:
    """Register the expert-FFN consumer ONCE per (shape, weights): the
    endpoint's identity keys the compiled-program caches, so a fresh
    closure per call would rebuild (and on the card re-capture) the
    program every iteration. The memo, held on the accl with the weights
    kept alive (object ids cannot be reused), is keyed by stream id alone,
    so it mirrors what the endpoint currently holds: after another config
    overwrote the shared stream, the next call re-registers."""
    memo = getattr(accl, "_moe_consumer_memo", None)
    if memo is None:
        memo = accl._moe_consumer_memo = {}
    prev = memo.get(stream_id)
    if (prev is not None and prev[:2] == (cfg, capacity)
            and prev[2] is w_up and prev[3] is w_down):
        return
    memo[stream_id] = (cfg, capacity, w_up, w_down)
    accl.register_stream_consumer(
        stream_id, moe_expert_consumer(cfg, capacity, w_up, w_down,
                                       accl.world, accl.cclo.torch_device))


def run_moe_layer(accl, disp, mid, out, count: int, *,
                  stream_id: int = MOE_EXPERT_STREAM, fused: bool = True,
                  expert_fn=None, compress_dtype=None, peer_counts=(),
                  from_device: bool = False, to_device: bool = False,
                  lint: str = "error"):
    """One MoE layer step over registered facade buffers: the dispatch
    alltoall (expert FFN spliced as its RES_STREAM consumer) then the
    combine alltoall returning expert outputs to their source ranks.

    fused=True records BOTH legs as one call sequence (one dispatch; on
    the card one CUDA-graph replay). fused=False issues the SAME two
    descriptors eagerly, bitwise the same. fused=False with `expert_fn`
    (make_expert_program) runs the descriptor-per-stage form: dispatch
    alltoall, the expert function on mid's device image, combine
    alltoall. Intermediates stay on the device.

    `compress_dtype=DataType.int8` rides the blockwise-int8 wire on both
    legs; None defers to the ALLTOALL_COMPRESS_MIN_COUNT register.
    `peer_counts` routes both legs through the capacity-bounded alltoallv
    (per-peer valid prefixes, overflow dropped on the wire)."""
    def leg(tgt, a, b, **kw):
        if peer_counts:
            tgt.alltoallv(a, b, count, peer_counts,
                          compress_dtype=compress_dtype, **kw)
        else:
            tgt.alltoall(a, b, count, compress_dtype=compress_dtype, **kw)

    if fused:
        seq = accl.sequence(lint=lint)
        leg(seq, disp, mid, res_stream=stream_id)
        leg(seq, mid, out)
        return seq.run(from_device=from_device, to_device=to_device)
    if expert_fn is not None:
        leg(accl, disp, mid, from_device=from_device, to_device=True)
        mid.device = expert_fn(mid.device)
        leg(accl, mid, out, from_device=True, to_device=to_device)
        return accl._last_request
    leg(accl, disp, mid, res_stream=stream_id, from_device=from_device,
        to_device=True)
    leg(accl, mid, out, from_device=True, to_device=to_device)
    return accl._last_request


def make_moe_layer_program(accl, disp, mid, out, count: int, *,
                           stream_id: int = MOE_EXPERT_STREAM,
                           compress_dtype=None, peer_counts=(),
                           lint: str = "error"):
    """The steady-state fused layer step: the dispatch -> expert ->
    combine batch recorded ONCE and frozen into a SequenceProgram (plans,
    lint, the composed body and, on the card, its CUDA graph happen
    here); every `program.run()` is one dispatch."""
    seq = accl.sequence(lint=lint)
    if peer_counts:
        seq.alltoallv(disp, mid, count, peer_counts,
                      compress_dtype=compress_dtype, res_stream=stream_id)
        seq.alltoallv(mid, out, count, peer_counts,
                      compress_dtype=compress_dtype)
    else:
        seq.alltoall(disp, mid, count, compress_dtype=compress_dtype,
                     res_stream=stream_id)
        seq.alltoall(mid, out, count, compress_dtype=compress_dtype)
    return seq.compile()


def create_moe_layer_buffers(accl, cfg: MoEConfig, capacity: int):
    """(disp, mid, out) stacked rank buffers for `run_moe_layer`, each
    (world, E * C * D) fp32."""
    n = cfg.n_experts * capacity * cfg.d_model
    return tuple(accl.create_buffer(n, torch.float32) for _ in range(3))


def moe_ffn_via_sequence(accl, x, params, cfg: MoEConfig, *,
                         buffers=None, capacity: int | None = None,
                         fused: bool = True, compress_dtype=None,
                         wire_capacity: int | None = None,
                         stream_id: int = MOE_EXPERT_STREAM):
    """The facade MoE FFN: route the stacked (world, T, D) tokens `x` on
    the facade's device, run the dispatch -> expert -> combine round trip
    as recorded descriptors over `accl`'s ranks, and combine. Returns the
    stacked (world, T, D) FFN contributions, a tensor on the facade's
    device.

    `wire_capacity` (experts_per_rank == 1 only) applies the capacity
    bound ON THE WIRE via alltoallv: the dispatch keeps its full
    per-expert slots, but each peer accepts only the first wire_capacity
    token rows; tokens beyond it are dropped by the schedule itself (zero
    contribution after the gate)."""
    world = accl.world
    device = accl.cclo.torch_device
    x = torch.as_tensor(x).to(device)
    T, D = x.shape[-2:]
    k = cfg.top_k
    C = capacity if capacity is not None else _capacity(cfg, T * k)
    E = cfg.n_experts
    count = (E // world) * C * D  # per-peer chunk elements
    peer_counts: tuple[int, ...] = ()
    if wire_capacity is not None and wire_capacity < C:
        if cfg.experts_per_rank != 1:
            raise ValueError(
                "wire_capacity needs experts_per_rank == 1 (a flat slot "
                "prefix is a token prefix only for one expert per rank)")
        peer_counts = (wire_capacity * D,) * world

    _ensure_expert_consumer(accl, cfg, C, params["w_up"], params["w_down"],
                            stream_id)
    if buffers is None:
        buffers = create_moe_layer_buffers(accl, cfg, C)
    disp, mid, out = buffers
    dispatch, safe_e, safe_c, keep, gate = _route(x, params, cfg, C)
    disp.device = dispatch.reshape(world, -1).to(torch.float32)
    run_moe_layer(accl, disp, mid, out, count, stream_id=stream_id,
                  fused=fused, compress_dtype=compress_dtype,
                  peer_counts=peer_counts, from_device=True, to_device=True)
    back = out.device.reshape(world, E, C, D)
    return _combine_tokens(back, safe_e, safe_c, keep, gate, T, k, D,
                           back.dtype)


def moe_reference_forward(params, tokens, cfg: MoEConfig):
    """Single-device oracle: the same routing and capacity math with every
    expert applied densely (no alltoall), then the residual, the
    normalization and the unembedding. tokens (B, T) -> logits (B, T, V)."""
    x = params["embed"][tokens]
    T, D = x.shape[-2:]
    k = cfg.top_k
    C = _capacity(cfg, T * k)
    disp, safe_e, safe_c, keep, gate = _route(x, params, cfg, C)
    h = _gelu(torch.einsum("becd,edf->becf", disp, params["w_up"]))
    out = torch.einsum("becf,efd->becd", h, params["w_down"])
    x = x + _combine_tokens(out, safe_e, safe_c, keep, gate, T, k, D,
                            x.dtype)
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
    return torch.einsum("btd,dv->btv", x, params["unembed"])


# ---------------------------------------------------------------------------
# The mesh forms over a (dp, ep) mesh of virtual ranks
# ---------------------------------------------------------------------------


def moe_ffn_local(x, params, cfg: MoEConfig, *, mesh, ep_axis: str, wire):
    """The stacked per-rank MoE FFN: each rank routes its (R, S, T, D)
    tokens (S sequences, each routed on its own, as the reference vmaps
    the body) to the experts across the ep axis through the alltoall,
    applies its local experts, and alltoalls the results back. Returns
    (R, S, T, D) expert outputs weighted by router probability (zeros
    for capacity-dropped tokens). params are the stacked leaves of
    place_moe_params: the expert stacks each rank's (R, n_local, ...)
    block."""
    R, S, T, D = x.shape
    ep_world = mesh.axis_size(ep_axis)
    n_local = cfg.experts_per_rank
    E = ep_world * n_local
    assert E == cfg.n_experts, (E, cfg.n_experts)
    k = cfg.top_k
    C = _capacity(cfg, T * k)

    routed_params = {"router": params["router"][:, None]}  # (R, 1, D, E)
    dispatch, safe_e, safe_c, keep, gate = _route(x, routed_params, cfg, C)
    # dispatch alltoall: destination rank r gets experts [r*n_local, ...)
    routed = collectives.axis_alltoall(dispatch.reshape(R, S, -1), mesh,
                                       ep_axis, wire)
    # (R, S, ep_world, n_local, C, D): source-rank-major blocks for MY
    # experts
    recv = routed.reshape(R, S, ep_world, n_local, C, D)
    w_up, w_down = params["w_up"], params["w_down"]
    assert w_up.shape[1] == n_local, (w_up.shape, n_local)
    h = _gelu(torch.einsum("rsplcd,rldf->rsplcf", recv, w_up))
    out = torch.einsum("rsplcf,rlfd->rsplcd", h, w_down)
    # return alltoall: send block s back to source rank s
    back = collectives.axis_alltoall(out.reshape(R, S, -1), mesh, ep_axis,
                                     wire).reshape(R, S, E, C, D)
    return _combine_tokens(back, safe_e, safe_c, keep, gate, T, k, D,
                           x.dtype)


def _moe_logits(params, tok, cfg: MoEConfig, mesh, wire):
    r = torch.arange(mesh.size, device=tok.device)
    x = params["embed"][r[:, None, None], tok]  # (R, B_local, T, D)
    x = x + moe_ffn_local(x, params, cfg, mesh=mesh, ep_axis="ep",
                          wire=wire)
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
    return torch.einsum("rbtd,rdv->rbtv", x, params["unembed"])


_TOKEN_SPEC = P(("dp", "ep"))


def make_moe_forward(cfg: MoEConfig, mesh):
    """The mesh forward: fn(params, tokens (B, T)) -> logits (B, T, V);
    tokens shard over BOTH axes (every rank routes a distinct batch
    shard), experts over ep. params are place_moe_params' stacked
    tree."""
    wire = schedules.Wire(None)

    def fn(params, tokens):
        tok = mesh.shard(torch.as_tensor(tokens).long(), _TOKEN_SPEC)
        return mesh.unshard(_moe_logits(params, tok, cfg, mesh, wire),
                            _TOKEN_SPEC)

    return fn


def make_moe_train_step(cfg: MoEConfig, mesh, lr: float = 1e-2):
    """SGD step with the dp mean and the ep-aware gradient sync:
    step(params, tokens, targets) -> (new_params, loss). The backward is
    seeded with the SUM of the ranks' losses (each rank's cotangent its
    own loss's); expert-sharded grads stay on their ep shard, rescaled by
    1/ep (the alltoall's transpose gathers every shard's cotangent on the
    owning rank), replicated params (embed, router, unembed) are
    mean-allreduced over both axes through the ring.
    `step.grads(params, tokens, targets)` is the step before its update:
    (the synced gradients, the loss)."""
    wire = schedules.Wire(None)
    specs = moe_param_specs(cfg)
    ep_world = mesh.axis_size("ep")

    def sync(g, spec):
        g = _grad_allreduce(g, "dp", wire, mesh)
        if "ep" in tuple(spec):
            return g / ep_world
        return _grad_allreduce(g, "ep", wire, mesh)

    def grads(params, tokens, targets):
        tok = mesh.shard(torch.as_tensor(tokens).long(), _TOKEN_SPEC)
        tgt = mesh.shard(torch.as_tensor(targets).long(), _TOKEN_SPEC)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            logits = _moe_logits(leaves, tok, cfg, mesh, wire)
            logp = torch.log_softmax(logits.float(), -1)
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
            loss = nll.mean(dim=(1, 2))  # (R,): each rank's own loss
            g = torch.autograd.grad(loss.sum(), list(leaves.values()))
        g = _tree_map(sync, dict(zip(leaves, g)), specs)
        loss = loss.detach()[:, None]
        for ax in ("dp", "ep"):
            loss = collectives.allreduce(loss, mesh, ax, wire) \
                / mesh.axis_size(ax)
        return g, loss[0, 0]

    def step(params, tokens, targets):
        g, loss = grads(params, tokens, targets)
        return {k: params[k] - lr * g[k].to(params[k].dtype)
                for k in params}, loss

    step.grads = grads
    return step


# ---------------------------------------------------------------------------
# DeepSeek-V3's MoE layer: group-limited sigmoid routing, SwiGLU experts, a
# shared expert, and a dropless exchange whose counts are written on the card
# ---------------------------------------------------------------------------

# the first of the kernel-stream ids a V3 step registers: two a layer (the
# router and shared expert, then the held experts); a second step on the
# same facade re-registers them for itself
V3_STREAM_BASE = 100


@dataclasses.dataclass(frozen=True)
class V3MoEConfig:
    """DeepSeek-V3's MoE layer as its published configuration gives it
    (`from_hf` reads the keys), and the share of it one expert-parallel
    group computes: the `held` experts from `held_first` on, spread
    evenly over the facade's ranks, each rank routing `tokens` tokens a
    step over every router output. The weights carry the widths: the
    router (n_routed_experts, hidden), the held experts' gate and up
    (held, moe_intermediate_size, hidden) and down, the shared expert's
    (n_shared_experts * moe_intermediate_size, hidden) and down."""

    hidden: int = 7168               # hidden_size
    n_group: int = 8
    topk_group: int = 4
    top_k: int = 8                   # num_experts_per_tok
    routed_scaling: float = 2.5      # routed_scaling_factor
    norm_topk_prob: bool = True
    held_first: int = 0
    held: int = 32
    tokens: int = 128

    @classmethod
    def from_hf(cls, hf: dict, **kw) -> "V3MoEConfig":
        """The layer of a Hugging Face DeepSeek-V3 config.json; `kw` set
        the held share and the tokens. Only the sigmoid, noaux_tc router
        is modelled."""
        if hf.get("scoring_func", "sigmoid") != "sigmoid" or hf.get(
                "topk_method", "noaux_tc") != "noaux_tc":
            raise ValueError("V3MoEConfig models the sigmoid noaux_tc router")
        return cls(hidden=hf["hidden_size"], n_group=hf["n_group"],
                   topk_group=hf["topk_group"],
                   top_k=hf["num_experts_per_tok"],
                   routed_scaling=float(hf["routed_scaling_factor"]),
                   norm_topk_prob=bool(hf["norm_topk_prob"]), **kw)

    def rows_per_rank(self, world: int) -> int:
        """A rank's rows of the expert side, sized for the worst case:
        every token of every rank to each of its held experts."""
        return self.held // world * world * self.tokens


def v3_route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
             cfg: V3MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router over (N, D) float32 tokens: sigmoid scores of
    the (E, D) router; the bias (E,) added for selection only; the top
    `topk_group` of `n_group` groups by the sum of each group's two
    highest biased scores; the top `top_k` experts within them. Returns
    the experts (N, top_k) in descending biased score and their gates:
    the unbiased scores, normalised over the k, times the routed scaling
    factor. Capturable: no host reads."""
    n = x.shape[0]
    scores = torch.sigmoid(x @ router.T)
    biased = scores + bias
    grouped = biased.view(n, cfg.n_group, -1)
    group_score = grouped.topk(2, dim=-1).values.sum(-1)
    keep = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        1, group_score.topk(cfg.topk_group, dim=-1).indices, True)
    masked = grouped.masked_fill(~keep[..., None], float("-inf")).view(n, -1)
    idx = masked.topk(cfg.top_k, dim=-1).indices
    gate = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    return idx, gate * cfg.routed_scaling


class V3Routing:
    """One layer's dispatch layout, in device tensors allocated once and
    rewritten by `plan` at each dispatch: the rows the slot-driven
    exchange (schedules.SlotRows) and the grouped expert kernel read on
    the card, and the counts the step's counters read back.

    The expert side holds, on rank d, its held experts' rows one expert
    after the other, each expert's rows by source rank, then by token:
    `expert_starts[e]` is held expert e's first row (flat over the
    ranks) and `expert_rows[e]` its row count; `counts[s, d]` the rows
    rank s sends rank d; `slot_row`, `gate` the routing slots (-1: the
    expert is not held here); `dropped` the held slots that found no row
    (0 by construction: every side is sized for the worst case)."""

    def __init__(self, cfg: V3MoEConfig, world: int, device):
        if cfg.held % world:
            raise ValueError(f"{cfg.held} held experts over {world} ranks")
        W, T, K, H = world, cfg.tokens, cfg.top_k, cfg.held
        self.cfg, self.world = cfg, world
        self.rows_per_rank = cfg.rows_per_rank(world)
        i32 = dict(dtype=torch.int32, device=device)
        self.slot_row = torch.full((W, T, K), -1, **i32)
        self.gate = torch.zeros((W, T, K), dtype=torch.float32, device=device)
        self.counts = torch.zeros((W, W), **i32)
        self.expert_rows = torch.zeros((H,), **i32)
        self.expert_starts = torch.zeros((H,), **i32)
        self.dropped = torch.zeros((1,), **i32)
        self._held = torch.arange(H, device=device)
        self._rank_base = self._held // (H // W) * self.rows_per_rank
        common = dict(width=cfg.hidden, tokens=T,
                      rows_per_rank=self.rows_per_rank,
                      slot_row=self.slot_row)
        self.dispatch = schedules.SlotRows("scatter", **common)
        self.combine = schedules.SlotRows("gather", weight=self.gate,
                                          **common)

    def plan(self, idx: torch.Tensor, gate: torch.Tensor) -> None:
        """Write the layout of the routing `idx`, `gate` ((W, T, K) each)
        into the device tensors, with torch ops alone (capturable)."""
        W, H = self.world, self.cfg.held
        L = H // W
        rel = idx - self.cfg.held_first
        held = (rel >= 0) & (rel < H)
        local = rel.clamp(0, H - 1)
        # (W, T, H): whether token t of rank s chose held expert e
        chose = ((local[..., None] == self._held)
                 & held[..., None]).sum(2)
        cnt = chose.sum(1)                       # (W, H)
        before = chose.cumsum(1) - chose         # earlier tokens, per (s, e)
        total = cnt.sum(0)                       # (H,)
        per_rank = total.view(W, L)
        start_local = (per_rank.cumsum(1) - per_rank).view(H)
        first = self._rank_base + start_local    # (H,)
        row = (first + cnt.cumsum(0) - cnt)[:, None, :] + before
        slot = torch.gather(row, 2, local)
        self.slot_row.copy_(torch.where(held, slot, -1))
        self.gate.copy_(gate)
        self.counts.copy_(cnt.view(W, W, L).sum(2))
        self.expert_rows.copy_(total)
        self.expert_starts.copy_(first)
        # a held slot whose expert's rows would pass its rank's side
        over = (start_local + total > self.rows_per_rank)[local]
        self.dropped.copy_((held & over).sum().view(1))


def v3_shared_expert(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The shared expert's SwiGLU over (N, D) rows: plain matrix products
    (float32; TF32 follows torch.backends.cuda.matmul.allow_tf32)."""
    g = x @ w["shared_gate"].T
    return (F.silu(g) * (x @ w["shared_up"].T)) @ w["shared_down"].T


def _v3_router_consumer(routing: V3Routing, w: dict, layer: int):
    """The dispatch's first stage, a copy step's consumer over the stacked
    (W, T * D) tokens: route them and write the layout (the router), then
    return the shared expert's output, which the layer adds last."""
    cfg, W = routing.cfg, routing.world

    def consumer(flat):
        tracer = get_tracer()
        x = flat.reshape(W * cfg.tokens, cfg.hidden)
        with tracer.layer("moe_router", layer=layer):
            idx, gate = v3_route(x, w["router"], w["bias"], cfg)
            routing.plan(idx.view(W, cfg.tokens, -1),
                         gate.view(W, cfg.tokens, -1))
        with tracer.layer("moe_shared", layer=layer):
            return v3_shared_expert(x, w).reshape(flat.shape)

    return consumer


def _v3_expert_consumer(routing: V3Routing, w: dict, layer: int):
    """The dispatch exchange's consumer: the held experts' SwiGLU over the
    rows the counts place, written over the rows it read."""
    cfg, W = routing.cfg, routing.world

    def consumer(flat):
        from ..ops.moe_kernels import expert_swiglu

        with get_tracer().layer("moe_experts", layer=layer):
            rows = flat.view(-1, cfg.hidden)
            expert_swiglu(rows, routing.expert_starts, routing.expert_rows,
                          w["w_gate"], w["w_up"], w["w_down"],
                          max_rows=W * cfg.tokens, out=rows)
        return flat

    return consumer


class V3MoEStep:
    """A token step of DeepSeek-V3 MoE layers over the facade's ranks (one
    expert-parallel group), each layer's input `xs[l]` and result `ys[l]`
    a stacked (W, T * D) buffer. A layer is four facade calls: a copy
    whose consumer routes and runs the shared expert, the dispatch: a
    slot-driven scatter alltoallv whose consumer runs the held experts,
    the combine: a gate-weighted gather alltoallv, and the SUM combine
    of the two.
    Fused, all layers are one recorded sequence, compiled once: a step is
    one dispatch (on the card one graph replay). Unfused, the same
    descriptors are issued one by one, bitwise the same.

    `wait` completes a step; while the tracer collects it then reads the
    layouts back and emits one `moe_counters` event (cat "compute",
    track "moe"): `moe_rows` (rows the held experts computed),
    `moe_rows_max` (each layer's hottest held expert, summed),
    `moe_tokens_routed` (token rows with a held slot, the rows the
    dispatch reads), `moe_moved_rows` (rows that crossed ranks, both
    legs),
    `moe_dropped` (0), `moe_experts_live` (held experts with rows) and
    `layers`. An untraced step reads nothing back."""

    def __init__(self, accl, cfg: V3MoEConfig, layers: list[dict], xs, ys,
                 *, compress_dtype=None, fused: bool = True,
                 lint: str = "error"):
        from ..constants import ReduceFunction

        if len(xs) != len(layers) or len(ys) != len(layers):
            raise ValueError("one input and one result buffer a layer")
        W = accl.world
        device = accl.cclo.torch_device
        T, D = cfg.tokens, cfg.hidden
        self.accl, self.cfg = accl, cfg
        tracer = get_tracer()
        with tracer.span("moe_record", cat="phase", track="moe",
                         layers=len(layers), fused=fused):
            self.routings = [V3Routing(cfg, W, device) for _ in layers]
            rows = self.routings[0].rows_per_rank
            self.shared = accl.create_buffer(T * D, torch.float32)
            self.mid = accl.create_buffer(rows * D, torch.float32)
            self.gathered = accl.create_buffer(T * D, torch.float32)
            self.calls = []
            for l, (w, routing) in enumerate(zip(layers, self.routings)):
                rid = V3_STREAM_BASE + 2 * l
                eid = rid + 1
                accl.register_stream_consumer(
                    rid, _v3_router_consumer(routing, w, l))
                accl.register_stream_consumer(
                    eid, _v3_expert_consumer(routing, w, l))
                self.calls.append((xs[l], ys[l], routing, rid, eid))
            self.wire = compress_dtype
            self.sum = ReduceFunction.SUM
            self.program = None
            if fused:
                seq = accl.sequence(lint=lint)
                for x, y, routing, rid, eid in self.calls:
                    seq.copy(x, self.shared, T * D, res_stream=rid)
                    seq.alltoallv(x, self.mid, D, routing.dispatch,
                                  compress_dtype=compress_dtype,
                                  res_stream=eid)
                    seq.alltoallv(self.mid, self.gathered, D,
                                  routing.combine,
                                  compress_dtype=compress_dtype)
                    seq.combine(T * D, self.sum, self.shared, self.gathered,
                                y)
                self.program = seq.compile()

    def run(self):
        """Dispatch one step and return its request: fused, one dispatch
        left running; unfused, the calls one by one, each completed."""
        if self.program is not None:
            return self.program.run(from_device=True, to_device=True,
                                    run_async=True)
        accl, T, D = self.accl, self.cfg.tokens, self.cfg.hidden
        dev = dict(from_device=True, to_device=True)
        for x, y, routing, rid, eid in self.calls:
            accl.copy_to_stream(x, T * D, res_stream=rid, dstbuf=self.shared,
                                **dev)
            accl.alltoallv(x, self.mid, D, routing.dispatch,
                           compress_dtype=self.wire, res_stream=eid, **dev)
            accl.alltoallv(self.mid, self.gathered, D, routing.combine,
                           compress_dtype=self.wire, **dev)
            req = accl.combine(T * D, self.sum, self.shared, self.gathered,
                               y, **dev)
        return req

    def wait(self, req):
        """Complete a step; while the tracer collects, emit its counters."""
        self.accl.wait(req)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit("moe_counters", "compute", "moe",
                        ts_ns=time.perf_counter_ns(), dur_ns=0,
                        args=self.counters())
        return req

    def counters(self) -> dict:
        """The step's routing counters, read back from the layouts (a
        host synchronisation: call it after completion only)."""
        rows = torch.stack([r.expert_rows for r in self.routings])
        counts = torch.stack([r.counts for r in self.routings])
        dropped = torch.stack([r.dropped for r in self.routings])
        routed = torch.stack([(r.slot_row >= 0).any(-1).sum()
                              for r in self.routings])
        W = counts.shape[-1]
        off_rank = counts * (1 - torch.eye(W, dtype=counts.dtype,
                                           device=counts.device))
        packed = torch.stack([rows.sum(), rows.max(1).values.sum(),
                              routed.sum(), 2 * off_rank.sum(),
                              dropped.sum(), (rows > 0).sum()]).tolist()
        keys = ("moe_rows", "moe_rows_max", "moe_tokens_routed",
                "moe_moved_rows", "moe_dropped", "moe_experts_live")
        out = dict(zip(keys, (int(v) for v in packed)))
        out["layers"] = len(self.routings)
        return out
