"""Runnable demo: incremental (KV-cache) generation on a dp x tp mesh of
virtual ranks, the inference half of the model family.

Counterpart of examples/generate.py. Every tensor-parallel partial sum
of the decode step reduces through the port's ring schedule (on the card,
kernel 7 folds each hop), and one `make_decode_step` serves the prompt
and the generation token by token, each step on the same shapes.

Departures from the reference's demo:
  - `--world N` (default 4) counts the virtual ranks the mesh lays on one
    card, where the reference's `--cpu-devices N` counted devices;
  - `--device` is "cuda" unless "cpu" is asked; with no card the demo
    exits non-zero (it never falls back to the CPU);
  - the weights are drawn by the port's `init_params` from `--seed`, so
    the tokens differ from the reference's run (on the reference's
    weights, carried across with interop.transformer_params_from_numpy,
    the greedy tokens are the reference's);
  - `--temp > 0` samples from softmax(logits / temp) with a
    torch.Generator on the mesh's device seeded `seed + 1`: torch's
    stream, not jax.random.categorical's.

Usage:
    python -m accl_tpu_torch.examples.generate --steps 16
    python -m accl_tpu_torch.examples.generate --steps 16 --temp 0.8
    python -m accl_tpu_torch.examples.generate --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.transformer import (
    TransformerConfig,
    init_kv_cache,
    init_params,
    make_decode_step,
    shard_params,
)
from ..parallel import make_mesh

# the demo's model: vocab 256, d_model 64, 4 heads, 2 layers, d_ff 128
CONFIG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)


def example_mesh(world: int, device):
    """The demo's mesh over `world` ranks: tp 2 when the world is even,
    the rest dp (decode runs at sp 1)."""
    tp = 2 if world % 2 == 0 else 1
    return make_mesh({"dp": world // tp, "sp": 1, "tp": tp},
                     device=device)


def round_batch(batch: int, mesh) -> int:
    """The batch rounded up to a multiple of the mesh's dp."""
    dp = mesh.shape["dp"]
    return -(-max(batch, 1) // dp) * dp


def make_prompt(vocab: int, batch: int, prompt_len: int,
                seed: int) -> np.ndarray:
    """(batch, prompt_len) prompt tokens from np.random.default_rng."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)


def generate_tokens(cfg: TransformerConfig, mesh, params, prompt,
                    steps: int, *, temp: float = 0.0,
                    generator: torch.Generator | None = None,
                    logits: list | None = None) -> torch.Tensor:
    """The prompt (B, P) and `steps` generated tokens, (B, P + steps)
    int64 on the mesh's device. `params` is shard_params' stacked tree;
    the cache holds P + steps positions. Each step decodes one position;
    from the prompt's last one on, the next token is the argmax of the
    step's logits (temp 0) or a draw from softmax(logits / temp) by
    `generator`. Nothing waits for the host between steps. `logits`,
    when given, receives each step's (B, V) logits in position order."""
    prompt = torch.as_tensor(prompt, device=mesh.device).long()
    B, P = prompt.shape
    total = P + steps
    toks = torch.zeros((B, total), dtype=torch.int64, device=mesh.device)
    toks[:, :P] = prompt
    step = make_decode_step(cfg, mesh)
    cache = init_kv_cache(cfg, mesh, B, max_len=total)
    positions = torch.arange(total, device=mesh.device)
    for t in range(total - 1):
        lg, cache = step(params, cache, toks[:, t:t + 1],
                         positions[t:t + 1])
        lg = lg[:, 0]
        if logits is not None:
            logits.append(lg)
        if t >= P - 1:
            if temp > 0:
                nxt = torch.multinomial(torch.softmax(lg / temp, -1), 1,
                                        generator=generator)[:, 0]
            else:
                nxt = lg.argmax(-1)
            toks[:, t + 1] = nxt
    return toks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16,
                    help="tokens to generate after the prompt")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--temp", type=float, default=0.0,
                    help="0 = greedy, else softmax temperature")
    ap.add_argument("--world", type=int, default=4,
                    help="virtual ranks of the mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from ..utils.cli import require_device

    device = require_device(args.device)
    cfg = TransformerConfig(**CONFIG)
    mesh = example_mesh(args.world, device)
    params = shard_params(init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device),
        cfg, mesh)
    B = round_batch(args.batch, mesh)
    prompt = make_prompt(cfg.vocab, B, args.prompt_len, args.seed)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    toks = generate_tokens(cfg, mesh, params, prompt, args.steps,
                           temp=args.temp, generator=sampler).cpu()
    print(f"mesh={dict(mesh.shape)} prompt_len={args.prompt_len} "
          f"generated={toks.shape[1] - args.prompt_len}")
    for b in range(min(B, 2)):
        print(f"  seq[{b}]: {toks[b].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
