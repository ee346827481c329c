"""State carried across from the JAX package to the port: rank data,
device state and model weights.

  tensor_from_numpy(a)        a numpy rank buffer as a port tensor; a
                              bf16 array (the JAX side's bfloat16 numpy
                              dtype) is read as its 16-bit patterns and
                              viewed as torch.bfloat16, bit for bit,
                              without importing a bf16 extension package
  load_exchange_memory(d, w)  load an exchange-memory image ({addr: word}
                              as plain ints, e.g. a reference device's
                              `_exchmem`) into a port device, so tuning(),
                              the communicator table and the arith rows
                              read back identically
  transformer_params_from_numpy(p, device)
                              a transformer parameter tree of the JAX
                              package as numpy arrays (`jax.tree.map(
                              np.asarray, params)`) as the port's tree of
                              tensors on `device`, the same keys and
                              shapes, bit for bit
  moe_params_from_numpy(p, device)
                              the MoE parameter tree {"embed", "router",
                              "w_up", "w_down", "unembed"} likewise
  stacked_train_params_from_numpy(flat, world, device)
                              a flat train-step parameter vector (n,) (the
                              JAX package's flatten_train_params) as the
                              stacked (world, n) tensor every rank row of
                              a train-step buffer starts from, bit for bit
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the same dtype and bits as `a` (a copy)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def load_exchange_memory(device, words: dict[int, int]) -> None:
    """Replace `device`'s exchange memory with the image `words`."""
    device._exchmem.clear()
    for addr, word in sorted(words.items()):
        device.write(int(addr), int(word))


def transformer_params_from_numpy(params_np: dict,
                                  device: torch.device | str = "cuda") -> dict:
    """The parameter tree {"embed", "unembed", "layers": [{...}, ...]} of
    numpy arrays as tensors on `device`, each a copy with the same dtype
    and bits (how both packages are fed the same weights)."""
    def conv(a):
        return tensor_from_numpy(np.asarray(a)).to(device)

    return {"embed": conv(params_np["embed"]),
            "unembed": conv(params_np["unembed"]),
            "layers": [{k: conv(v) for k, v in lyr.items()}
                       for lyr in params_np["layers"]]}


def moe_params_from_numpy(params_np: dict,
                          device: torch.device | str = "cuda") -> dict:
    """The MoE parameter tree of numpy arrays as tensors on `device`, each
    a copy with the same keys, dtype and bits."""
    return {k: tensor_from_numpy(np.asarray(v)).to(device)
            for k, v in params_np.items()}


def stacked_train_params_from_numpy(flat: np.ndarray, world: int,
                                    device: torch.device | str = "cuda"
                                    ) -> torch.Tensor:
    """A flat train-step vector (n,) as the (world, n) tensor on `device`
    with the same bits in every row."""
    t = tensor_from_numpy(np.asarray(flat))
    if t.dim() != 1:
        raise ValueError(f"a flat (n,) vector expected, got {tuple(t.shape)}")
    return t.to(device).expand(world, -1).contiguous()
