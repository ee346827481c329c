"""State carried across from the JAX package to the port.

This system runs no model, so what crosses over in place of weights is
rank data and device state:

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
