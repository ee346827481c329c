"""Plain reference of DeepSeek-V3's MoE layer, with no exchange.

It imports torch alone (no kernel of this package, no JAX) and computes,
per rank, what the layer adds to each token: the gate-weighted outputs
of the token's routed experts that lie in a stated share of the experts
(`held_first` .. `held_first + held - 1`), plus the shared expert. Run
it in float64 for a check, or in float32 with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`).

The published description is DeepSeek-V3's config.json
(huggingface.co/deepseek-ai/DeepSeek-V3) and its modeling code, and the
technical report (arXiv:2412.19437, sections 2.1.2 and 3.2). Departures:

- The router's masked scores are -inf outside the chosen groups, as the
  report's inference code has them; the Hugging Face modeling file
  fills 0.0, which selects the same experts whenever a chosen group has
  `top_k` biased scores above 0.
- Activations are float32 (or float64 here); DeepSeek serves BF16
  activations and FP8 expert weights.
- Only a share of the routed experts is computed (one node of the
  expert-parallel layout holds 32 of 256): the other shares' outputs
  are left out, in the program and here alike. The shares of all the
  groups, with the shared expert counted once, add up to the whole
  layer (`layer_share` with held = every expert).
- The token's residual stream, the RMSNorm before the layer and the
  attention around it are not part of the layer here.
"""

from __future__ import annotations

import torch


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, *,
          n_group: int, topk_group: int, top_k: int, routed_scaling: float,
          norm_topk_prob: bool = True):
    """The sigmoid, noaux_tc router over (N, D) tokens in x's dtype.
    Returns (experts (N, top_k), gates (N, top_k), margin (N,)): the
    chosen experts in descending biased score, their gates (unbiased
    scores, normalised over the k when norm_topk_prob, times
    routed_scaling), and the token's selection margin: the smaller of
    the gap between the last chosen and the first unchosen group score
    and the gap between the last chosen and the first unchosen biased
    expert score within the chosen groups. A token whose margin is below
    the rounding of a lower precision may be routed otherwise there."""
    n = x.shape[0]
    scores = torch.sigmoid(x @ router.to(x.dtype).T)
    biased = scores + bias.to(x.dtype)
    grouped = biased.view(n, n_group, -1)
    group_score = grouped.topk(2, dim=-1).values.sum(-1)
    gs = group_score.sort(dim=-1, descending=True).values
    keep = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        1, group_score.topk(topk_group, dim=-1).indices, True)
    masked = grouped.masked_fill(~keep[..., None], float("-inf")).view(n, -1)
    top = masked.topk(top_k + 1, dim=-1)
    idx = top.indices[:, :top_k]
    margin = torch.minimum(gs[:, topk_group - 1] - gs[:, topk_group],
                           top.values[:, top_k - 1] - top.values[:, top_k])
    gate = scores.gather(1, idx)
    if norm_topk_prob:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    return idx, gate * routed_scaling, margin


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)) with (out, in) weights."""
    dt = x.dtype
    g = x @ w_gate.to(dt).T
    h = g * torch.sigmoid(g) * (x @ w_up.to(dt).T)
    return h @ w_down.to(dt).T


def layer_share(x: torch.Tensor, w: dict, *, held_first: int, held: int,
                shared: bool = True, route_kw: dict):
    """What the layer adds to each (N, D) token from the held experts
    (`w["w_gate"]` etc. stack the held experts' weights, held_first
    first) and, with `shared`, the shared expert. Returns (y, margin)."""
    idx, gate, margin = route(x, w["router"], w["bias"], **route_kw)
    y = torch.zeros_like(x)
    for e in range(held):
        tok, slot = (idx == held_first + e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w["w_gate"][e], w["w_up"][e],
                         w["w_down"][e])
            y.index_add_(0, tok, gate[tok, slot, None] * out)
    if shared:
        y = y + swiglu(x, w["shared_gate"], w["shared_up"],
                       w["shared_down"])
    return y, margin
