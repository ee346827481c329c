"""EmuRank / EmuWorld: ctypes binding to the native multi-rank emulator.

Counterpart of accl_tpu/device/emu_device.py. Each EmuRank owns one
instance of the native runtime in native/src/ (a rank with its own
sequencer thread, links, eager rx ring and rendezvous queues); N of them
run collectives against each other over sockets or, with
transport="local", by direct calls inside one process. This is the
host-memory emulator of the reference (its SimDevice role): it runs on
the CPU, beside the one-card GPUDevice, never on the card.

The port builds its own copy of the runtime: `load_native` compiles
native/src/{runtime,reliability,transport}.cpp with the flags of
native/Makefile into accl_tpu_torch/_build/libacclrt-<digest>.so, the
digest covering the sources, the headers, the compiler and the flags, so
an edited source is rebuilt and a build is reused across processes.
Nothing is written into native/. ACCL_NATIVE_LIB names another library
to load instead (a sanitizer build, say).

Operands are CPU torch tensors, C-contiguous; the binding hands the
runtime their data pointers and keeps every operand alive until the
call's wait returns. A CUDA tensor or a non-contiguous one raises
TypeError: the caller stages it with `.cpu().contiguous()` (and copies a
result back) itself, so nothing crosses from the card unseen.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import socket
import subprocess
import tempfile
import threading
import time
from typing import Literal, overload

import torch

from ..constants import (
    ACCLError,
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_MAX_EAGER_SIZE,
    DEFAULT_NUM_EAGER_RX_BUFS,
    Operation,
    TAG_ANY,
    from_torch_dtype,
)
from ..descriptor import CallOptions
from .base import STATS2_FIELDS

_PKG = pathlib.Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("src/runtime.cpp", "src/reliability.cpp", "src/transport.cpp")
HEADERS = ("include/acclrt.h", "src/wire.h", "src/reliability.h",
           "src/transport.h")
# native/Makefile's CXXFLAGS; each source is compiled on its own (all
# started together) and the objects linked with -shared
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-pthread")

_lib = None
_lib_lock = threading.Lock()
# seconds the last build in this process took (0.0: a digest-matched
# library was found on disk; None: nothing loaded yet or an override)
build_seconds: float | None = None


class NativeSpan(ctypes.Structure):
    """ctypes mirror of accl_rt_span_t (native/include/acclrt.h): one
    record of the runtime's trace ring per completed call."""

    _fields_ = [
        ("opcode", ctypes.c_uint32),
        ("retcode", ctypes.c_uint32),
        ("detail", ctypes.c_uint32),
        ("count", ctypes.c_uint32),
        ("bytes", ctypes.c_uint64),
        ("start_ns", ctypes.c_uint64),
        ("end_ns", ctypes.c_uint64),
        ("d_passes", ctypes.c_uint64),
        ("d_parks", ctypes.c_uint64),
        ("d_seek_hit", ctypes.c_uint64),
        ("d_seek_miss", ctypes.c_uint64),
    ]


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"no C++ compiler: {cxx!r} is not on PATH (set CXX); the native "
            "emulator is built from native/src at first use")
    return found


def library_path(cxx: str | None = None) -> pathlib.Path:
    """Where the build of the current sources under `cxx` lives."""
    h = hashlib.sha256()
    h.update(" ".join((cxx or _compiler(), *CXXFLAGS)).encode())
    for rel in (*SOURCES, *HEADERS):
        h.update(rel.encode() + b"\0" + (NATIVE_DIR / rel).read_bytes())
    return BUILD_DIR / f"libacclrt-{h.hexdigest()[:16]}.so"


def build_native() -> pathlib.Path:
    """Compile the runtime unless a digest-matched library exists; returns
    its path. A file lock keeps two processes from building at once; the
    library is written under a temporary name and renamed into place."""
    global build_seconds
    cxx = _compiler()
    path = library_path(cxx)
    if path.exists():
        build_seconds = 0.0
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libacclrt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while we waited
            build_seconds = 0.0
            return path
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs, procs = [], []
            for rel in SOURCES:
                obj = os.path.join(tmp, pathlib.Path(rel).stem + ".o")
                objs.append(obj)
                procs.append((rel, subprocess.Popen(
                    [cxx, *CXXFLAGS, "-c", "-o", obj, str(NATIVE_DIR / rel)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = [(rel, p, p.communicate()[0]) for rel, p in procs]
            failed = [(rel, log) for rel, p, log in logs if p.returncode]
            if failed:
                raise RuntimeError("building the native emulator failed:\n"
                                   + "\n".join(f"{r}:\n{log}"
                                               for r, log in failed))
            tmp_so = os.path.join(tmp, "libacclrt.so")
            link = subprocess.run(
                [cxx, *CXXFLAGS, "-shared", "-o", tmp_so, *objs],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError("linking the native emulator failed:\n"
                                   + link.stdout + link.stderr)
            os.replace(tmp_so, path)
        build_seconds = time.perf_counter() - t0
    return path


def load_native():
    """Load the native runtime library, building it first if needed
    (module docstring); ACCL_NATIVE_LIB overrides the path."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        override = os.environ.get("ACCL_NATIVE_LIB")
        lib_path = (pathlib.Path(override).resolve() if override
                    else build_native())
        lib = ctypes.CDLL(str(lib_path))
        lib.accl_rt_create.restype = ctypes.c_void_p
        lib.accl_rt_create.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint64,
        ]
        lib.accl_rt_create_ex.restype = ctypes.c_void_p
        lib.accl_rt_create_ex.argtypes = lib.accl_rt_create.argtypes + [
            ctypes.c_uint32,
        ]
        lib.accl_rt_destroy.argtypes = [ctypes.c_void_p]
        lib.accl_rt_start.restype = ctypes.c_int64
        lib.accl_rt_start.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.accl_rt_test.restype = ctypes.c_int
        lib.accl_rt_test.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.accl_rt_wait.restype = ctypes.c_int
        lib.accl_rt_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_uint64]
        lib.accl_rt_retcode.restype = ctypes.c_uint32
        lib.accl_rt_retcode.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.accl_rt_duration_ns.restype = ctypes.c_uint64
        lib.accl_rt_duration_ns.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.accl_rt_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.accl_rt_read.restype = ctypes.c_uint32
        lib.accl_rt_read.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.accl_rt_write.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                      ctypes.c_uint32]
        lib.accl_rt_get_stats.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_uint64)]
        lib.accl_rt_get_stats2.restype = ctypes.c_size_t
        lib.accl_rt_get_stats2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_size_t,
        ]
        lib.accl_rt_dump_rxbufs.restype = ctypes.c_size_t
        lib.accl_rt_dump_rxbufs.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_size_t]
        lib.accl_rt_trace_read.restype = ctypes.c_size_t
        lib.accl_rt_trace_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(NativeSpan), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.accl_rt_kill.argtypes = [ctypes.c_void_p]
        lib.accl_rt_flush_rx.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


@overload
def free_ports(n: int, hold: Literal[True]) -> tuple[list[int], list[socket.socket]]: ...
@overload
def free_ports(n: int, hold: Literal[False] = False) -> list[int]: ...
def free_ports(n, hold=False):
    """Reserve n free localhost ports for an emulated world.

    hold=True returns (ports, sockets) with the reserving sockets still
    bound: the "local" transport never binds its ports (they are keys of
    the runtime's in-process registry), so without a live reservation a
    second world alive at the same time could draw the same numbers and
    the registry would refuse it at bring-up. The caller keeps the
    sockets open for the world's lifetime."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    if hold:
        return ports, socks
    for s in socks:
        s.close()
    return ports


class EmuRank:
    """One rank of the native emulator (a per-rank endpoint)."""

    def __init__(
        self,
        world: int,
        rank: int,
        ports: list[int],
        n_rx_bufs: int = DEFAULT_NUM_EAGER_RX_BUFS,
        rx_buf_bytes: int = DEFAULT_EAGER_RX_BUF_SIZE,
        max_eager: int = DEFAULT_MAX_EAGER_SIZE,
        # a roomy rendezvous ceiling so tests run real sizes; the limit is
        # still enforced (DMA_SIZE_ERROR past it)
        max_rndzv: int = 64 * 1024 * 1024,
        # "tcp": a session full mesh; "udp": sessionless datagrams
        # (eager only); "local": in-process direct delivery, no sockets
        transport: str = "tcp",
    ):
        lib = load_native()
        self.world = world
        self.rank = rank
        self.transport = transport
        arr = (ctypes.c_uint16 * world)(*ports)
        tr = {"tcp": 0, "udp": 1, "local": 2}[transport]
        self._rt = lib.accl_rt_create_ex(
            world, rank, arr, n_rx_bufs, rx_buf_bytes, max_eager, max_rndzv,
            tr,
        )
        if not self._rt:
            raise RuntimeError(f"native runtime bring-up failed (rank {rank})")
        self._lib = lib
        # operands of each call in flight, alive until its wait
        self._keepalive: dict[int, tuple] = {}
        self._durations: dict[int, int] = {}
        # each handle's descriptor, so a failed wait can name the call in
        # the flight recorder's post-mortem
        self._call_opts: dict[int, CallOptions] = {}

    def close(self):
        if self._rt:
            self._lib.accl_rt_destroy(self._rt)
            self._rt = None

    def kill(self):
        """Wedge this rank for good (accl_rt_kill, the programmatic
        ACCL_RT_FAULT_KILL_RANK): calls in flight and later ones complete
        with a sticky RECEIVE_TIMEOUT retcode (and a last trace span when
        tracing is on), and the rank's wire goes dark both ways."""
        if self._rt:
            self._lib.accl_rt_kill(self._rt)

    def flush_rx(self, settle_s: float = 0.05):
        """Reconfiguration fence (accl_rt_flush_rx): drop the frames that
        aborted collectives of the old membership left landed, and advance
        the per-peer sequence numbers past them. Call it with the rank
        quiescent (no call in flight, the survivors' threads joined)
        between excluding a dead rank and the first call on the recovery
        communicator, which would otherwise take old frames as data.

        The fence runs twice around a `settle_s` pause: a last frame may
        still be on the receive path when the senders have stopped, and
        it lands past the first flush's advance; the second flush drops
        it."""
        if self._rt:
            self._lib.accl_rt_flush_rx(self._rt)
            if settle_s > 0:
                time.sleep(settle_s)
                self._lib.accl_rt_flush_rx(self._rt)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- MMIO --------------------------------------------------------------

    def read(self, addr: int) -> int:
        return self._lib.accl_rt_read(self._rt, addr)

    def write(self, addr: int, value: int):
        self._lib.accl_rt_write(self._rt, addr, value)

    def sequencer_stats(self) -> dict:
        """Cumulative sequencer counters of this rank's runtime: execute
        passes, event-counter parks, nanoseconds parked, rx-seek hits and
        misses. Diff two snapshots to profile one phase of a run."""
        buf = (ctypes.c_uint64 * 5)()
        self._lib.accl_rt_get_stats(self._rt, buf)
        return {"passes": buf[0], "parks": buf[1], "park_ns": buf[2],
                "seek_hit": buf[3], "seek_miss": buf[4]}

    def wire_stats(self) -> dict:
        """The versioned counter surface (accl_rt_get_stats2): the
        sequencer counters and the reliable wire's health counters, by
        STATS2_FIELDS name. Every known field is present (0 where the
        library predates it); unknown trailing counters are ignored. The
        resilience manager reads the delta of two snapshots to tell a
        lossy link from a dark one."""
        cap = len(STATS2_FIELDS)
        buf = (ctypes.c_uint64 * cap)()
        n = min(int(self._lib.accl_rt_get_stats2(self._rt, buf, cap)), cap)
        return {name: int(buf[i]) if i < n else 0
                for i, name in enumerate(STATS2_FIELDS)}

    def trace_read(self, chunk: int = 4096) -> tuple[list[dict], int]:
        """Drain this rank's trace ring (ACCL_RT_TRACE=1;
        accl_rt_trace_read): (spans, dropped), each span a dict in the
        shape telemetry.native lifts: opcode, count, payload bytes,
        start/end ns since the runtime's creation, the sticky retcode,
        the fault detail behind a RECEIVE_TIMEOUT, and the call's
        sequencer-counter deltas. Loops until the ring is empty;
        `dropped` counts the spans the ring overflowed. Empty when
        tracing is off."""
        spans: list[dict] = []
        dropped = ctypes.c_uint64(0)
        while True:
            buf = (NativeSpan * chunk)()
            n = self._lib.accl_rt_trace_read(self._rt, buf, chunk,
                                             ctypes.byref(dropped))
            spans.extend(
                {
                    "opcode": s.opcode,
                    "retcode": s.retcode,
                    "detail": s.detail,
                    "count": s.count,
                    "bytes": s.bytes,
                    "start_ns": s.start_ns,
                    "end_ns": s.end_ns,
                    "d_passes": s.d_passes,
                    "d_parks": s.d_parks,
                    "d_seek_hit": s.d_seek_hit,
                    "d_seek_miss": s.d_seek_miss,
                    "rank": self.rank,
                }
                for s in buf[:n]
            )
            if n < chunk:
                return spans, int(dropped.value)

    def dump_eager_rx_buffers(self) -> str:
        """Slot-by-slot snapshot of the rx ring (accl_rt_dump_rxbufs)."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            need = self._lib.accl_rt_dump_rxbufs(self._rt, buf, cap)
            if need < cap:  # loop again if the ring grew between calls
                return buf.value.decode()
            cap = need + 4096

    # -- calls -------------------------------------------------------------

    @staticmethod
    def _ptr(t, what: str):
        if t is None:
            return None
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: the emulator takes torch tensors, "
                            f"got {type(t).__name__}")
        if t.device.type != "cpu" or not t.is_contiguous():
            where = ("on " + str(t.device) if t.device.type != "cpu"
                     else "not contiguous")
            raise TypeError(
                f"{what} is {where}: the native emulator reads and writes "
                "host memory; pass t.cpu().contiguous() (and copy a result "
                "back yourself)")
        return ctypes.c_void_p(t.data_ptr())

    def start(self, opts: CallOptions, op0=None, op1=None, res=None) -> int:
        ptrs = (self._ptr(op0, "op0"), self._ptr(op1, "op1"),
                self._ptr(res, "res"))
        words = (ctypes.c_uint32 * 15)(*[w & 0xFFFFFFFF for w in opts.to_words()])
        h = self._lib.accl_rt_start(self._rt, words, int(opts.data_type),
                                    *ptrs)
        # the operands outlive the call: the caller's buffers belong to
        # the runtime until the request completes
        self._keepalive[h] = (op0, op1, res)
        self._call_opts[h] = opts
        return h

    def wait(self, handle: int, timeout_ms: int = 0) -> None:
        """Wait for a call (timeout_ms 0: no host bound; the runtime's own
        receive timeout still ends a stalled call)."""
        ok = self._lib.accl_rt_wait(self._rt, handle, timeout_ms)
        if not ok:
            raise TimeoutError(f"rank {self.rank}: call {handle} timed out")
        rc = self._lib.accl_rt_retcode(self._rt, handle)
        # keep the duration, then release the native completion record
        self._durations[handle] = self._lib.accl_rt_duration_ns(self._rt, handle)
        self._lib.accl_rt_release(self._rt, handle)
        self._keepalive.pop(handle, None)
        opts = self._call_opts.pop(handle, None)
        if rc:
            # report the failing call to the armed flight recorder before
            # the typed raise; the trace ring is left for an explicit
            # trace_read()/drain_world to drain
            from ..errors import notify_sticky_retcode

            notify_sticky_retcode(
                opts.scenario.name if opts is not None
                else f"emu rank {self.rank}", rc, rank=self.rank,
                count=opts.count if opts is not None else None)
            raise ACCLError(f"emu rank {self.rank}", rc)

    def test(self, handle: int) -> bool:
        return bool(self._lib.accl_rt_test(self._rt, handle))

    def duration_ns(self, handle: int) -> int:
        if handle in self._durations:
            return self._durations[handle]
        return self._lib.accl_rt_duration_ns(self._rt, handle)

    def call(self, opts: CallOptions, op0=None, op1=None, res=None) -> int:
        h = self.start(opts, op0, op1, res)
        self.wait(h)
        return h

    # -- communicators -----------------------------------------------------

    def write_communicator(self, comm) -> None:
        """Write a Communicator's rank table into this rank's exchange
        memory at comm.exchmem_addr; pass that address as comm_addr to a
        collective. Membership comes from each entry's device_index (the
        global transport rank)."""
        for i, w in enumerate(comm.exchmem_words()):
            self.write(comm.exchmem_addr + 4 * i, w)

    # -- per-rank collective wrappers --------------------------------------

    def _opts(self, scenario, count, dtype, root=0, func=0, tag=TAG_ANY,
              comm_addr=0):
        return CallOptions(
            scenario=scenario, count=count, root_src_dst=root,
            function=int(func), tag=tag, comm_addr=comm_addr,
            data_type=from_torch_dtype(dtype),
        )

    def send(self, buf, count, dst, tag=TAG_ANY, comm_addr=0):
        return self.call(self._opts(Operation.send, count, buf.dtype, dst,
                                    tag=tag, comm_addr=comm_addr), op0=buf)

    def recv(self, buf, count, src, tag=TAG_ANY, comm_addr=0):
        return self.call(self._opts(Operation.recv, count, buf.dtype, src,
                                    tag=tag, comm_addr=comm_addr), res=buf)

    def copy(self, src, dst, count):
        return self.call(self._opts(Operation.copy, count, src.dtype), op0=src, res=dst)

    def combine(self, count, func, op0, op1, res):
        return self.call(self._opts(Operation.combine, count, op0.dtype, func=func),
                         op0=op0, op1=op1, res=res)

    def bcast(self, buf, count, root, comm_addr=0):
        return self.call(self._opts(Operation.bcast, count, buf.dtype, root,
                                    comm_addr=comm_addr), op0=buf)

    def scatter(self, sendbuf, recvbuf, count, root, comm_addr=0):
        return self.call(self._opts(Operation.scatter, count, recvbuf.dtype,
                                    root, comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def gather(self, sendbuf, recvbuf, count, root, comm_addr=0):
        return self.call(self._opts(Operation.gather, count, sendbuf.dtype,
                                    root, comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def allgather(self, sendbuf, recvbuf, count, comm_addr=0):
        return self.call(self._opts(Operation.allgather, count, sendbuf.dtype,
                                    comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def reduce(self, sendbuf, recvbuf, count, root, func, comm_addr=0):
        return self.call(self._opts(Operation.reduce, count, sendbuf.dtype,
                                    root, func, comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def allreduce(self, sendbuf, recvbuf, count, func, comm_addr=0):
        return self.call(self._opts(Operation.allreduce, count, sendbuf.dtype,
                                    func=func, comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def reduce_scatter(self, sendbuf, recvbuf, count, func, comm_addr=0):
        return self.call(self._opts(Operation.reduce_scatter, count,
                                    sendbuf.dtype, func=func,
                                    comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def alltoall(self, sendbuf, recvbuf, count, comm_addr=0):
        return self.call(self._opts(Operation.alltoall, count, sendbuf.dtype,
                                    comm_addr=comm_addr),
                         op0=sendbuf, res=recvbuf)

    def barrier(self, comm_addr=0):
        return self.call(self._opts(Operation.barrier, 0, torch.float32,
                                    comm_addr=comm_addr))


class EmuWorld:
    """Bring up N emulator ranks in one process (rank bring-up is
    concurrent, because link establishment blocks on the peers)."""

    # a failed bring-up (a socket port lost to another process, a refused
    # link) is retried with fresh ports, a bounded number of times
    BRINGUP_ATTEMPTS = 3

    def __init__(self, world: int, **kw):
        self.ranks: list[EmuRank | None] = [None] * world
        self._port_holds: list = []
        last: Exception | None = None
        for _attempt in range(self.BRINGUP_ATTEMPTS):
            if kw.get("transport") == "local":
                # local ports are registry keys only: hold the reserving
                # sockets for the world's lifetime so no other live world
                # is given the same keys
                ports, self._port_holds = free_ports(world, hold=True)
            else:
                ports, self._port_holds = free_ports(world), []
            self.ports = list(ports)
            self.ranks = [None] * world
            errs: list[Exception] = []

            def mk(r):
                try:
                    self.ranks[r] = EmuRank(world, r, ports, **kw)
                except Exception as e:  # pragma: no cover
                    errs.append(e)

            threads = [threading.Thread(target=mk, args=(r,))
                       for r in range(world)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if not errs:
                return
            last = errs[0]
            self.close()  # tear the half-up world down before retrying
        assert last is not None
        raise last

    def close(self):
        for r in self.ranks:
            if r is not None:
                r.close()
        # release the local-mode reservations only after every rank has
        # left the native registry
        for s in self._port_holds:
            s.close()
        self._port_holds = []

    def run(self, fn, timeout_s: float | None = None):
        """Run fn(rank_obj, rank_idx) on every rank at once and return the
        results. `timeout_s` bounds the join: a rank still running then
        raises TimeoutError (its thread is left to its native timeout)."""
        results = [None] * len(self.ranks)
        errs = []

        def body(i):
            try:
                results[i] = fn(self.ranks[i], i)
            except Exception as e:
                errs.append(e)

        threads = [
            threading.Thread(target=body, args=(i,), daemon=True)
            for i in range(len(self.ranks))
        ]
        for t in threads:
            t.start()
        end = None if timeout_s is None else time.monotonic() + timeout_s
        for t in threads:
            t.join(None if end is None else max(end - time.monotonic(), 0))
        stuck = [i for i, t in enumerate(threads) if t.is_alive()]
        if stuck:
            raise TimeoutError(f"ranks {stuck} still running after "
                               f"{timeout_s} s")
        if errs:
            raise errs[0]
        return results
