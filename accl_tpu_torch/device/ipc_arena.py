"""The receive regions of the multi-process DCN link (dcn_transport.IpcLink).

A process exports a region of memory on its own device for each source
peer; the peer maps it and writes its hop's message straight into it.
Two forms, chosen by the device's type and never one for the other:

  - cuda (`CudaArena`): a region is its own cudaMalloc, exported with
    cudaIpcGetMemHandle and mapped by the peer with cudaIpcOpenMemHandle
    (csrc/ipc_link.cu, built into accl_tpu_torch/_build/ by ops/_build.py
    at first use). A hop's copies are device copies on PyTorch's current
    stream, ordered across the two processes by interprocess events;
  - cpu (`ShmArena`, the form the CPU tests run): a region is a file under
    /dev/shm that both ends map with torch.from_file(shared=True). Its
    copies are done when they return, so it has no events. The exporter
    unlinks the file as soon as every peer has mapped it.

A failure to map raises; nothing falls back to the other form or to the
host.
"""

from __future__ import annotations

import ctypes
import functools
import os
import socket
import tempfile
import uuid
from dataclasses import dataclass

import torch

SHM_DIR = "/dev/shm"


@dataclass
class Region:
    """A byte region of this process's device: `owned` when this process
    allocated and exported it, else a peer's region it mapped from
    `handle`. `ptr` (cuda) or `tensor` (cpu) addresses it."""

    handle: bytes
    nbytes: int
    owned: bool
    ptr: int = 0
    tensor: torch.Tensor | None = None
    path: str | None = None


def arena_for(device: torch.device):
    """The arena of `device`'s type; any other type raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return CudaArena(device)
    if device.type == "cpu":
        return ShmArena()
    raise ValueError(f"link='ipc' maps cuda or cpu memory, not {device}; "
                     "use link='gloo'")


# -- the CPU form: files under /dev/shm --------------------------------------


class ShmArena:
    """Regions as shared file mappings (the tests' form of the link)."""

    handle_bytes = 256  # a path, padded: a growth message has one size

    def __init__(self):
        self.dir = SHM_DIR if os.path.isdir(SHM_DIR) else \
            tempfile.gettempdir()

    def identity(self) -> dict:
        return {"host": socket.gethostname(), "device": "cpu",
                "id": "host memory"}

    def alloc(self, nbytes: int) -> Region:
        path = os.path.join(self.dir,
                            f"accl-ipc-{os.getpid()}-{uuid.uuid4().hex}")
        t = torch.from_file(path, shared=True, size=nbytes,
                            dtype=torch.uint8)
        handle = path.encode().ljust(self.handle_bytes, b"\0")
        return Region(handle, nbytes, True, tensor=t, path=path)

    def open(self, handle: bytes, nbytes: int) -> Region:
        path = handle.rstrip(b"\0").decode()
        # from_file would create a missing file: a peer's region that is
        # not there (another host, a stale name) must raise instead
        if not os.path.isfile(path) or os.path.getsize(path) != nbytes:
            raise RuntimeError(f"link='ipc': no region of {nbytes} bytes at "
                               f"{path} on this host")
        t = torch.from_file(path, shared=True, size=nbytes,
                            dtype=torch.uint8)
        return Region(handle, nbytes, False, tensor=t)

    def settle(self, region: Region) -> None:
        """Every peer has mapped `region`: its name can go."""
        if region.owned and region.path is not None:
            try:
                os.unlink(region.path)
            except FileNotFoundError:
                pass
            region.path = None

    def release(self, region: Region) -> None:
        self.settle(region)
        region.tensor = None  # the mapping goes with its last reference

    def event(self):
        return None, None

    def open_event(self, handle):
        return None

    def drop_event(self, event) -> None:
        pass

    def record(self, event) -> None:
        pass

    def wait(self, event) -> None:
        pass

    def write(self, region: Region, offset: int, msg: torch.Tensor) -> None:
        region.tensor[offset:offset + msg.numel()].copy_(msg)

    def read(self, region: Region, offset: int, n: int) -> torch.Tensor:
        return region.tensor[offset:offset + n].clone()

    def synchronize(self) -> None:
        pass


# -- the card's form: CUDA IPC -----------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    from ..ops._build import load_library

    lib = load_library("ipc_link")
    p, pp, ll, i = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_longlong, ctypes.c_int)
    sigs = {
        "accl_ipc_alloc": [i, ll, pp],           # device, bytes, out ptr
        "accl_ipc_free": [i, p],
        "accl_ipc_mem_handle": [i, p, p],        # device, ptr, out handle
        "accl_ipc_open_mem": [i, p, pp],         # device, handle, out ptr
        "accl_ipc_close_mem": [i, p],
        "accl_ipc_event_create": [i, pp],
        "accl_ipc_event_handle": [i, p, p],      # device, event, out handle
        "accl_ipc_open_event": [i, p, pp],       # device, handle, out event
        "accl_ipc_event_destroy": [i, p],
        "accl_ipc_record": [i, p, p],            # device, event, stream
        "accl_ipc_wait": [i, p, p],              # device, event, stream
        "accl_ipc_copy": [i, p, p, ll, p],       # device, dst, src, n, stream
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.accl_ipc_handle_bytes.restype = ctypes.c_int
    lib.accl_ipc_handle_bytes.argtypes = []
    lib.accl_ipc_error_string.restype = ctypes.c_char_p
    lib.accl_ipc_error_string.argtypes = [ctypes.c_int]
    return lib


def _buffer(handle: bytes):
    return ctypes.create_string_buffer(handle, len(handle))


class CudaArena:
    """Regions of this process's card, exported and mapped with CUDA IPC.
    Two processes' contexts on one card time-slice (no MPS), so nothing
    here spins on the device for a flag another process writes: a hop's
    ordering is an event the host makes a stream wait on, after the
    peer's host token says it was recorded."""

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.device = torch.device("cuda", self.index)
        self.lib = _library()
        self.handle_bytes = self.lib.accl_ipc_handle_bytes()

    def _call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(self.index, *args)
        if code:
            raise RuntimeError(
                f"link='ipc': {name} failed: "
                f"{self.lib.accl_ipc_error_string(code).decode()}")

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def identity(self) -> dict:
        props = torch.cuda.get_device_properties(self.index)
        return {"host": socket.gethostname(), "device": "cuda",
                "id": str(getattr(props, "uuid", self.index))}

    def alloc(self, nbytes: int) -> Region:
        ptr = ctypes.c_void_p()
        self._call("accl_ipc_alloc", nbytes, ctypes.byref(ptr))
        handle = ctypes.create_string_buffer(self.handle_bytes)
        try:
            self._call("accl_ipc_mem_handle", ptr, handle)
        except RuntimeError:
            self._call("accl_ipc_free", ptr)
            raise
        return Region(handle.raw, nbytes, True, ptr=ptr.value)

    def open(self, handle: bytes, nbytes: int) -> Region:
        ptr = ctypes.c_void_p()
        self._call("accl_ipc_open_mem", _buffer(handle), ctypes.byref(ptr))
        return Region(handle, nbytes, False, ptr=ptr.value)

    def settle(self, region: Region) -> None:
        pass

    def release(self, region: Region) -> None:
        if region.ptr:
            self._call("accl_ipc_free" if region.owned
                       else "accl_ipc_close_mem", ctypes.c_void_p(region.ptr))
            region.ptr = 0

    def event(self):
        """A new interprocess event and its handle."""
        ev = ctypes.c_void_p()
        self._call("accl_ipc_event_create", ctypes.byref(ev))
        handle = ctypes.create_string_buffer(self.handle_bytes)
        self._call("accl_ipc_event_handle", ev, handle)
        return ev.value, handle.raw

    def open_event(self, handle: bytes) -> int:
        ev = ctypes.c_void_p()
        self._call("accl_ipc_open_event", _buffer(handle), ctypes.byref(ev))
        return ev.value

    def drop_event(self, event: int) -> None:
        self._call("accl_ipc_event_destroy", ctypes.c_void_p(event))

    def record(self, event: int) -> None:
        self._call("accl_ipc_record", ctypes.c_void_p(event),
                   ctypes.c_void_p(self._stream()))

    def wait(self, event: int) -> None:
        self._call("accl_ipc_wait", ctypes.c_void_p(event),
                   ctypes.c_void_p(self._stream()))

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self.device or t.dtype != torch.uint8 or \
                not t.is_contiguous():
            raise ValueError(f"link='ipc' moves contiguous uint8 messages on "
                             f"{self.device}, got {t.dtype} on {t.device}")

    def write(self, region: Region, offset: int, msg: torch.Tensor) -> None:
        self._check(msg)
        self._call("accl_ipc_copy", ctypes.c_void_p(region.ptr + offset),
                   ctypes.c_void_p(msg.data_ptr()), msg.numel(),
                   ctypes.c_void_p(self._stream()))

    def read(self, region: Region, offset: int, n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.uint8, device=self.device)
        self._call("accl_ipc_copy", ctypes.c_void_p(out.data_ptr()),
                   ctypes.c_void_p(region.ptr + offset), n,
                   ctypes.c_void_p(self._stream()))
        return out

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.device)
