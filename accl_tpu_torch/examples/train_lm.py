"""Runnable demo: train a model whose parallelism runs entirely through the
port's schedules, with checkpoint and resume.

Counterpart of examples/train_lm.py. Two model families: the dense
dp x sp x tp transformer (default; `--pp` pipelines the layers over a pp
axis, `--remat` recomputes each block in the backward) and the
expert-parallel MoE (`--model moe`, dp x ep, `--top-k` experts a token).

Checkpoints (`--ckpt DIR`) hold the global, host-side parameter tree:
each leaf read back from the mesh's stacked (R, ...) tensor by
`mesh.unshard` under its spec, a pipelined run's layers in the per-layer
list form, so a run can resume on another pp width when the depth
matches. Each save goes into DIR/step_%06d/, written under a temporary
name and renamed; a run resumes from the newest finished step_<digits>
directory. SGD keeps no optimizer state, so N steps and M resumed steps
give the parameters of N + M straight steps bitwise.

Departures from the reference's demo:
  - `--world N` (default 8) counts the virtual ranks the mesh lays on one
    card, where the reference's `--cpu-devices N` counted devices;
  - `--device` is "cuda" unless "cpu" is asked; with no card the demo
    exits non-zero (it never falls back to the CPU);
  - checkpoints are torch.save files, not orbax's: neither package reads
    the other's;
  - the weights are drawn by the port's `init_params` / `init_moe_params`
    (seed 0), so the losses differ from the reference's run.

Usage:
    python -m accl_tpu_torch.examples.train_lm --steps 20 --ckpt DIR
    python -m accl_tpu_torch.examples.train_lm --steps 20 --ckpt DIR
    python -m accl_tpu_torch.examples.train_lm --model moe --top-k 2
    python -m accl_tpu_torch.examples.train_lm --pp 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import re
import shutil
import sys
import tempfile
from typing import Callable

import numpy as np
import torch

from ..models import moe
from ..models import transformer as trf
from ..parallel import factorize_devices, make_mesh

CKPT_FILE = "params.pt"
_STEP_DIR = re.compile(r"step_(\d+)")


@dataclasses.dataclass
class Run:
    """One model's training set-up: the mesh, the config, the step and
    the batch, and the specs that place the global parameter tree."""
    model: str
    axes: dict
    mesh: object
    cfg: object
    step: Callable
    tokens: torch.Tensor
    targets: torch.Tensor
    header: str

    @property
    def pp(self) -> int:
        return self.axes.get("pp", 1)

    def init_params(self, generator: torch.Generator) -> dict:
        """The global parameter tree from `generator`, on the mesh's
        device."""
        init = moe.init_moe_params if self.model == "moe" \
            else trf.init_params
        return init(self.cfg, generator, self.mesh.device)

    def specs(self) -> dict:
        if self.model == "moe":
            return moe.moe_param_specs(self.cfg)
        return (trf.pp_param_specs(self.cfg) if self.pp > 1
                else trf.param_specs(self.cfg))

    def place(self, params: dict) -> dict:
        """A global tree as the mesh's stacked tree."""
        if self.model == "moe":
            return moe.place_moe_params(params, self.cfg, self.mesh)
        return trf.shard_params(params, self.cfg, self.mesh)

    def global_params(self, placed: dict) -> dict:
        """The stacked tree read back as the global tree (each block from
        its first holder), the layers as a list."""
        tree = trf._tree_map(self.mesh.unshard, placed, self.specs())
        if self.pp > 1:
            tree = trf.unstack_layer_params(tree, self.cfg.n_layers)
        return tree


def check_flags(model: str, pp: int, remat: bool, top_k: int) -> None:
    """Model-specific flags fail on the wrong model, with the reference's
    messages."""
    if model == "moe" and (pp > 1 or remat):
        raise SystemExit("--pp/--remat apply to --model dense only")
    if model == "dense" and top_k != 1:
        raise SystemExit("--top-k applies to --model moe only")


def moe_run(world: int, *, top_k: int = 1, device="cuda", d_model: int = 64,
            d_ff: int = 128, vocab: int = 128, seq: int = 32) -> Run:
    """The MoE demo: ep 4 / 2 / 1 by divisibility, the rest dp, one
    expert a rank; 2 * world sequences from default_rng(0); lr 3e-2. The
    widths default to the demo's."""
    ep = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
    axes = {"dp": world // ep, "ep": ep}
    mesh = make_mesh(axes, device=device)
    cfg = moe.MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=ep,
                        experts_per_rank=1, vocab=vocab, seq=seq,
                        top_k=top_k)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * world, cfg.seq)).astype(np.int32)
    return Run("moe", axes, mesh, cfg,
               moe.make_moe_train_step(cfg, mesh, lr=3e-2),
               torch.as_tensor(tokens, device=mesh.device).long(),
               torch.as_tensor(np.roll(tokens, -1, 1),
                               device=mesh.device).long(),
               f"mesh {axes}; MoE with {cfg.n_experts} experts, "
               f"top-{cfg.top_k} routing")


def dense_run(world: int, *, pp: int = 1, remat: bool = False,
              device="cuda", cfg: trf.TransformerConfig | None = None,
              seq: int | None = None) -> Run:
    """The dense demo: with pp > 1 the mesh dp * sp1 * tp * pp (tp 2 when
    world / pp is even), else factorize_devices(world); heads max(4,
    2 tp), kv heads half of them when tp divides that, d_model 8 heads,
    max(2, pp) layers, d_ff 16 heads; the batch demo_batch(max(2, dp) *
    max(pp, 2), max(32, 16 sp)); lr 3e-2. `cfg` and `seq` replace the
    demo's widths and sequence length."""
    pp = max(1, pp)
    if pp > 1:
        if world % pp:
            raise SystemExit(f"--pp {pp} does not divide {world} devices")
        rest = world // pp
        tp = 2 if rest % 2 == 0 else 1
        axes = {"dp": rest // tp, "sp": 1, "tp": tp, "pp": pp}
    else:
        axes = factorize_devices(world)
    mesh = make_mesh(axes, device=device)
    if cfg is None:
        heads = max(4, axes["tp"] * 2)
        # grouped-query when it divides: half the kv heads, still a
        # multiple of tp
        kv = heads // 2 if (heads // 2) % axes["tp"] == 0 else heads
        cfg = trf.TransformerConfig(vocab=128, d_model=heads * 8,
                                    n_heads=heads, n_kv_heads=kv,
                                    n_layers=max(2, pp), d_ff=heads * 16)
    # a dp shard must divide into the pp microbatches
    tokens, targets = trf.demo_batch(
        cfg, mesh, batch=max(2, axes["dp"]) * max(pp, 2),
        seq=seq or max(32, axes["sp"] * 16))
    return Run("dense", axes, mesh, cfg,
               trf.make_train_step(cfg, mesh, lr=3e-2, remat=remat),
               tokens, targets,
               f"mesh {axes}; model d={cfg.d_model} heads={cfg.n_heads} "
               f"kv={cfg.kv_heads} layers={cfg.n_layers}"
               + (" remat" if remat else ""))


def train(run: Run, params: dict, start: int, steps: int,
          log: Callable[[str], None] | None = print):
    """`steps` SGD steps from step `start` over the run's batch; returns
    the stacked parameters and the last loss (a 0-d tensor on the mesh's
    device). Logs the loss at every fifth step and the last one (a host
    wait at each of those only)."""
    loss = None
    for s in range(start, start + steps):
        params, loss = run.step(params, run.tokens, run.targets)
        if log is not None and (s % 5 == 0 or s == start + steps - 1):
            log(f"step {s:4d}  loss {float(loss):.4f}")
    return params, loss


def latest_checkpoint(ckpt) -> pathlib.Path | None:
    """The newest finished step_<digits> directory under `ckpt`, or None;
    temporary directories of an unfinished save are skipped."""
    path = pathlib.Path(ckpt).absolute()
    done = [d for d in path.glob("step_*")
            if _STEP_DIR.fullmatch(d.name) and (d / CKPT_FILE).is_file()]
    return max(done, key=lambda d: int(d.name[5:])) if done else None


def save_checkpoint(run: Run, placed: dict, ckpt, step: int) -> pathlib.Path:
    """Write the global host-side tree of `placed` to
    ckpt/step_%06d/params.pt: into a temporary directory beside it,
    renamed once whole (an older directory of that step is replaced)."""
    root = pathlib.Path(ckpt).absolute()
    root.mkdir(parents=True, exist_ok=True)
    target = root / f"step_{step:06d}"
    host = trf._tree_map(lambda t: t.detach().cpu(),
                         run.global_params(placed))
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"{target.name}.tmp-",
                                        dir=root))
    torch.save(host, tmp / CKPT_FILE)
    if target.exists():
        shutil.rmtree(target)
    os.replace(tmp, target)
    return target


def restore(path) -> dict:
    """The global parameter tree of a checkpoint directory, on the CPU."""
    return torch.load(pathlib.Path(path) / CKPT_FILE, map_location="cpu",
                      weights_only=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--world", type=int, default=8,
                    help="virtual ranks of the mesh")
    ap.add_argument("--model", choices=("dense", "moe"), default="dense")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages for the dense model (layers "
                         "shard over a pp mesh axis, GPipe microbatching)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize each block in the backward pass "
                         "(torch.utils.checkpoint)")
    ap.add_argument("--top-k", type=int, default=1,
                    help="experts per token for --model moe")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    check_flags(args.model, args.pp, args.remat, args.top_k)
    from ..utils.cli import require_device

    device = require_device(args.device)
    if args.model == "moe":
        run = moe_run(args.world, top_k=args.top_k, device=device)
    else:
        run = dense_run(args.world, pp=args.pp, remat=args.remat,
                        device=device)
    print(run.header)
    params = run.init_params(torch.Generator(device=device).manual_seed(0))
    start = 0
    latest = latest_checkpoint(args.ckpt) if args.ckpt else None
    if latest is not None:
        start = int(latest.name[5:])
        params = restore(latest)
        print(f"resumed from {latest}")
    params, _ = train(run, run.place(params), start, args.steps)
    if args.ckpt:
        target = save_checkpoint(run, params, args.ckpt,
                                 start + args.steps)
        print(f"saved {target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
