"""Plain reference of the DeepSeek-V3 MoE cell: each layer's result
against the layer computed in float64 on the same device, for the
node's share (its held experts plus the shared expert), with no
exchange. It imports torch alone: a copy of the router and SwiGLU of
accl_tpu_torch/models/deepseek_v3_reference.py, which states the
departures from the published description.

It compares in blocks: a layer at a time, and within a layer one held
expert's tokens at a time, so that no float64 copy of the 45 GB of
expert weights is made (one expert's, 0.35 GB, at a time).

- `moe_err_u`: the widest gap between a result row and the float64
  row, in units u_t = 2**-24 * (max|shared_t| + sum over the token's
  held slots of gate * max|expert_t|): a float32 half-ulp of the
  largest magnitudes the token's last sums add. The rounding of the
  float32 products inside each expert (7168- and 2048-long sums of
  products) grows like the square root of their length in these units;
  a bfloat16 wire (8 bits) or TF32 products (11 bits) add some
  2**13..2**15 units to every routed row. Tokens whose float64
  selection margin is under TAU are left out: float32 may route them
  otherwise, and their rows then differ by whole experts.
- `near_tie_share`: the share of tokens left out that way, over every
  layer and rank.

A result of the wrong shape or type reads as infinitely far.
"""

import math

import torch

# a selection margin below this may flip between float32 and float64:
# the router's float32 logits are 7168-long sums of products, off by a
# few 1e-7 at most, and a sigmoid's slope is at most 1/4
TAU = 2.0 ** -16
UNIT = 2.0 ** -24


def _route(x, router, bias, cfg):
    n = x.shape[0]
    scores = torch.sigmoid(x @ router.T)
    biased = scores + bias
    grouped = biased.view(n, cfg["n_group"], -1)
    group_score = grouped.topk(2, dim=-1).values.sum(-1)
    gs = group_score.sort(dim=-1, descending=True).values
    k_g, k = cfg["topk_group"], cfg["num_experts_per_tok"]
    keep = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        1, group_score.topk(k_g, dim=-1).indices, True)
    masked = grouped.masked_fill(~keep[..., None], float("-inf")).view(n, -1)
    top = masked.topk(k + 1, dim=-1)
    idx = top.indices[:, :k]
    margin = torch.minimum(gs[:, k_g - 1] - gs[:, k_g],
                           top.values[:, k - 1] - top.values[:, k])
    gate = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    return idx, gate * cfg["routed_scaling_factor"], margin


def _swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate.double().T
    return (g * torch.sigmoid(g) * (x @ w_up.double().T)) @ w_down.double().T


def compare(operands, results, *, config, seed, shrink, weights):
    dep = config["deployment"]
    world, first, held = dep["world"], dep["held_first"], dep["held_experts"]
    D = config["hidden_size"] // shrink
    err, tied, tokens = 0.0, 0, 0
    for layer, (x, out) in enumerate(zip(operands, results, strict=True)):
        if (not isinstance(out, torch.Tensor) or out.shape != x.shape
                or out.dtype != torch.float32):
            return {"moe_err_u": math.inf, "near_tie_share": math.inf}
        w = {k: v[layer] for k, v in weights.items()}
        x64 = x.reshape(-1, D).double()
        got = out.to(x.device).reshape(-1, D).double()
        idx, gate, margin = _route(x64, w["router"].double(),
                                   w["bias"].double(), config)
        shared = _swiglu(x64, w["shared_gate"], w["shared_up"],
                         w["shared_down"])
        want = shared.clone()
        scale = shared.abs().amax(1)
        for e in range(held):
            tok, slot = (idx == first + e).nonzero(as_tuple=True)
            if not tok.numel():
                continue
            y = _swiglu(x64[tok], w["w_gate"][e], w["w_up"][e],
                        w["w_down"][e])
            g = gate[tok, slot]
            want.index_add_(0, tok, g[:, None] * y)
            scale.index_add_(0, tok, g.abs() * y.abs().amax(1))
        sure = margin >= TAU
        gap = (got - want).abs().amax(1) / (UNIT * scale)
        gap = torch.nan_to_num(gap, nan=math.inf)
        if sure.any():
            err = max(err, gap[sure].max().item())
        tied += int((~sure).sum())
        tokens += x64.shape[0]
    assert tokens == world * sum(o.shape[1] for o in operands) // D
    return {"moe_err_u": err, "near_tie_share": tied / tokens}
