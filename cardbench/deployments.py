"""How a deployment's configuration fixes the messages of a step.

Two deployments of the library are modelled:

- Data-parallel gradient sync (PyTorch DDP). The gradient of every
  parameter of a dense decoder is reduced in buckets. DDP fills buckets
  in the order gradients become ready, the reverse of the parameters'
  registration order, and closes a bucket once it holds at least its cap:
  the first bucket's cap is 1 MiB (`dist._DEFAULT_FIRST_BUCKET_BYTES`),
  every later one `bucket_cap_mb` (25 MiB by default). This is the
  assignment DDP's reducer rebuilds after its first iteration
  (`compute_bucket_assignment_by_size` over the ready order).
- Tensor-parallel decode (Megatron-style). Each layer allreduces its
  attention output projection's and its MLP down projection's partial
  sums: two messages of batch x hidden a layer and token step.

`step_messages` turns a configuration file and a traffic file into the
list of per-rank element counts one step allreduces, in issue order.
"""

from __future__ import annotations

MIB = 1 << 20


def decoder_params(cfg: dict) -> list[tuple[str, int]]:
    """(name, elements) of a dense decoder's parameters in registration
    order, as a Llama-style module tree registers them: the embedding,
    then per layer q, k, v, o, gate, up, down and the layer's RMSNorm
    vectors, then the final norm and, when untied, the output head."""
    hidden = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    kv_heads = cfg["num_key_value_heads"]
    head_dim = cfg.get("head_dim") or hidden // heads
    inter = cfg["intermediate_size"]
    vocab = cfg["vocab_size"]
    norms = cfg["assumed"]["norms_per_layer"]
    out = [("embed_tokens", vocab * hidden)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "q_proj", hidden * heads * head_dim),
            (p + "k_proj", hidden * kv_heads * head_dim),
            (p + "v_proj", hidden * kv_heads * head_dim),
            (p + "o_proj", heads * head_dim * hidden),
            (p + "gate_proj", hidden * inter),
            (p + "up_proj", hidden * inter),
            (p + "down_proj", inter * hidden),
        ]
        out += [(p + f"norm{j}", hidden) for j in range(norms)]
    out.append(("norm", hidden))
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", vocab * hidden))
    return out


def ddp_buckets(params: list[tuple[str, int]], elem_bytes: int,
                first_cap_bytes: int, cap_bytes: int) -> list[list[str]]:
    """DDP's bucket assignment over the gradient-ready order (the
    reverse of `params`): each bucket closes once it holds at least its
    cap; the first cap applies to the first bucket only. A last partial
    bucket closes at the end."""
    buckets: list[list[str]] = []
    cur: list[str] = []
    size = 0
    cap = first_cap_bytes
    for name, numel in reversed(params):
        cur.append(name)
        size += numel * elem_bytes
        if size >= cap:
            buckets.append(cur)
            cur, size, cap = [], 0, cap_bytes
    if cur:
        buckets.append(cur)
    return buckets


def step_messages(cfg: dict, traffic: dict) -> list[int]:
    """Per-rank element counts of one step's allreduces, in issue order.
    A configuration lists them (`step_calls.elems`), or gives a count and
    a row width that the traffic's `rows` (the batch) multiplies."""
    calls = cfg["step_calls"]
    if "elems" in calls:
        return list(calls["elems"])
    return [traffic["rows"] * calls["elems_per_row"]] * calls["count"]
