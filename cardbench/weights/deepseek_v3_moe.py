"""Seeded weights of DeepSeek-V3's MoE layers as one node of its EP64
layout holds them: for each layer, the router over all routed experts
and its e_score_correction_bias, the held experts' SwiGLU weights and
the shared expert's, in a linear layer's (out, in) layout, each kind
stacked over the layers and made in one call from the weights' own
generator on the device.

Normal with std 1/sqrt(fan_in), so that a layer keeps its activations
near unit scale. In each layer every group (a node of EP64) holds the
same biases, the n_routed_experts / n_group quantiles of a normal with
the configuration's `bias_std`, in a seeded order within the group: the
nodes are evenly loaded, as the report's balancing keeps them, and each
node's own experts unevenly. `shrink` divides the hidden and expert
widths (the tests' sizes); the router keeps its outputs and groups.
"""

import torch


def widths(config, shrink):
    """(hidden, expert width, shared width) at `shrink`."""
    hidden = config["hidden_size"] // shrink
    inter = config["moe_intermediate_size"] // shrink
    return hidden, inter, inter * config["n_shared_experts"]


def make(config, seed, device, shrink):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = config["num_hidden_layers"]
    held = config["deployment"]["held_experts"]
    D, F, S = widths(config, shrink)
    E = config["n_routed_experts"]

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=gen)

    n = E // config["n_group"]
    p = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    quantiles = (torch.special.ndtri(p)
                 * config["assumed"]["bias_std"]).float()
    order = torch.rand((layers, config["n_group"], n), generator=gen,
                       device=device).argsort(-1)
    bias = quantiles[order]

    return {
        "router": normal((layers, E, D), D ** -0.5),
        "bias": bias.reshape(layers, E),
        "w_gate": normal((layers, held, F, D), D ** -0.5),
        "w_up": normal((layers, held, F, D), D ** -0.5),
        "w_down": normal((layers, held, D, F), F ** -0.5),
        "shared_gate": normal((layers, S, D), D ** -0.5),
        "shared_up": normal((layers, S, D), D ** -0.5),
        "shared_down": normal((layers, D, S), S ** -0.5),
    }
