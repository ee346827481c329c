"""What the port's command-line entry points share."""

from __future__ import annotations


def require_device(name: str) -> str:
    """The torch device an entry point's `--device` names. "cuda" with no
    card exits non-zero with a message: nothing falls back to the CPU
    unless the caller asks for it."""
    if name == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "no CUDA device is available; pass --device cpu to run "
                "on the CPU")
    return name
