"""Buffer hierarchy: host-mirrored device buffers.

Counterpart of accl_tpu/buffers.py. The device image of a buffer is a
stacked (world, n) tensor on the card — row r is virtual rank r's buffer —
and its host mirror is a CPU tensor of the same dtype (bf16 included).
Addresses come from the port's own arena, so descriptors name buffers
the same way the reference's do.
"""

from __future__ import annotations

import itertools

import torch

from .constants import DataType, from_torch_dtype

_addr_arena = itertools.count(0x1000_0000, 0x100_0000)


class BaseBuffer:
    """Common buffer interface."""

    def __init__(self, shape, dtype: torch.dtype, address=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.address = next(_addr_arena) if address is None else address

    @property
    def count(self) -> int:
        """Elements per rank (the descriptor's count field)."""
        if len(self.shape) > 1:
            n = 1
            for d in self.shape[1:]:
                n *= d
            return n
        return self.shape[0]

    @property
    def data_type(self) -> DataType:
        return from_torch_dtype(self.dtype)

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.dtype.itemsize

    def sync_to_device(self):
        raise NotImplementedError

    def sync_from_device(self):
        raise NotImplementedError


class GPUBuffer(BaseBuffer):
    """A (world, n) stacked rank buffer. `host` is the CPU mirror,
    `device` the tensor on `torch_device`; sync_to_device/sync_from_device
    copy whole images, so collectives can chain on the device with
    from_device/to_device and no host round trip."""

    def __init__(self, host: torch.Tensor, torch_device: torch.device,
                 host_only: bool = False):
        super().__init__(host.shape, host.dtype)
        self.host = host
        self.torch_device = torch_device
        self.host_only = host_only
        self.device: torch.Tensor | None = None
        if not host_only:
            self.sync_to_device()

    def sync_to_device(self):
        # always a distinct tensor, on the CPU too: the device image and the
        # host mirror must not alias
        self.device = self.host.to(self.torch_device, copy=True)
        return self

    def sync_from_device(self):
        if self.device is not None:
            self.host = self.device.to("cpu", copy=True)
        return self


class DummyBuffer(BaseBuffer):
    """Placeholder for unused operands."""

    def __init__(self):
        super().__init__((0,), torch.float32, address=0)
        self.host = torch.zeros((0,), dtype=torch.float32)
        self.device = None

    def sync_to_device(self):
        return self

    def sync_from_device(self):
        return self
