"""Ring allreduce: the Hopper kernel and its plain PyTorch version.

Counterpart of accl_tpu/ops/ring_allreduce.py. The TPU kernels run one
rank per chip under shard_map and move chunks between chips with remote
DMAs; here the W ranks are virtual ranks on one card, the operand is the
stacked (W, n) tensor, and one launch computes every rank's result.

  ring_allreduce_bidir  replaces ring_allreduce_pallas_bidir
                        (_kernel_bidir): two ring directions, each over
                        half the payload — the default body of
                        ACCL.allreduce on the card
  ring_allreduce        replaces ring_allreduce_pallas (_kernel): the
                        unidirectional twin, kept as its A/B baseline

Both are one CUDA source, csrc/ring_allreduce.cu, templated over the
element type, SUM/MAX, the direction count and the vector width. On one
card a hop only moves data, so the kernel keeps the TPU ring's fold
order and nothing else: each element is read once from every rank row,
folded in registers in the order the ring would fold it, and written
once to every output row — exactly the bound's bytes (2*W*n*itemsize),
no comm buffer, no grid barrier. Its header states the closed form of
the fold order. The wrapper picks the 16-byte vector instantiation when
both operands' base pointers and row strides allow it (`vector_path`),
else the scalar one.

A wrapper launches the kernel for a CUDA tensor and runs the plain
version (`_ring_ref`, the TPU ring played hop by hop in torch ops on the
same padded chunk geometry) only for a CPU tensor. `out=` takes a
(W, n) view with unit-stride rows (a column slice of a wider result) to
write into. Each wrapper counts its launches in a plain integer
attribute, `launches`.

`ring_allreduce_indirect` is the same kernel's indirect entry, which
reads its two base pointers from a device table entry when it runs: a
recorded sequence's captured graph launches it (sequencer/lowering.py,
SequenceGraph), and nothing else does.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import ReduceFunction, from_torch_dtype
from . import _vector
from .lane_kernels import _combine_impl

# Per-call segment slots of the reference (two independent resource sets
# so consecutive segments double-buffer). Kernels on one CUDA stream are
# already ordered, so a slot here selects nothing; it is validated so the
# compiler's segmented body calls the kernel exactly as the reference's.
NUM_RING_SLOTS = 2

SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
                    torch.float16, torch.bfloat16)


def _sublane(dtype: torch.dtype) -> int:
    """Rows of the dtype's TPU VMEM tile (fp32 (8,128), bf16 (16,128)).
    Hopper has no such tile, but the rounding decides the chunk geometry
    and with it which rank starts each element's fold — part of the
    numeric contract with the TPU kernel."""
    return max(8, 32 // dtype.itemsize)


def chunk_elems(n: int, world: int, dtype: torch.dtype, dirs: int) -> int:
    """Elements per chunk: n split into dirs*world chunks of whole
    (sublane, 128) tiles."""
    tile = _sublane(dtype) * 128
    chunk = -(-n // (dirs * world))
    return -(-chunk // tile) * tile


def _check_slot(slot: int) -> None:
    if not 0 <= slot < NUM_RING_SLOTS:
        raise ValueError(f"ring slot {slot} outside 0..{NUM_RING_SLOTS - 1}")


def _ring_ref(x: torch.Tensor, world: int, func: ReduceFunction,
              dirs: int) -> torch.Tensor:
    """The TPU kernels' ring, rank by rank, in torch ops: rank r's buffer
    is padded to dirs*world chunks; per direction the accumulator travels
    W-1 hops (combine(arrival, local chunk)), then the reduced chunks
    relay W-1 hops. The combines are the lane's plain version (flush,
    IEEE max), so this stays plain on a CUDA tensor too."""
    op = "sum" if func == ReduceFunction.SUM else "max"
    n = x.shape[1]
    chunk = chunk_elems(n, world, x.dtype, dirs)
    padded = x.new_zeros((world, dirs * world * chunk))
    padded[:, :n] = x
    regions = padded.view(world, dirs, world, chunk)
    out = torch.empty_like(regions)
    me = torch.arange(world, device=x.device)
    for d in range(dirs):
        # forward sends to rank+1 (step 1), backward to rank-1 (step -1)
        step = 1 if d == 0 else -1
        local, dst = regions[:, d], out[:, d]
        v = local[me, (me - step) % world]
        for s in range(world - 1):
            arrival = torch.roll(v, step, 0)
            v = _combine_impl(arrival, local[me, (me - step * (2 + s)) % world],
                              op)
        dst[me, me] = v
        for s in range(world - 1):
            v = torch.roll(v, step, 0)
            dst[me, (me - step * (1 + s)) % world] = v
    return out.view(world, -1)[:, :n]


def ring_allreduce_bidir_ref(x: torch.Tensor, world: int,
                             func: ReduceFunction = ReduceFunction.SUM):
    """Plain version of the bidirectional kernel."""
    return _ring_ref(x, world, func, dirs=2)


def ring_allreduce_ref(x: torch.Tensor, world: int,
                       func: ReduceFunction = ReduceFunction.SUM):
    """Plain version of the unidirectional kernel."""
    return _ring_ref(x, world, func, dirs=1)


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("ring_allreduce")
    fn = lib.accl_ring_allreduce
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, op, dirs
            ctypes.c_int,  # vector instantiation
            ctypes.c_void_p, ctypes.c_void_p,  # x, out
            ctypes.c_longlong, ctypes.c_longlong,  # row strides in, out
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,  # n, W, chunk
            ctypes.c_void_p,  # stream
        ]
        lib.accl_ring_error_string.restype = ctypes.c_char_p
        lib.accl_ring_error_string.argtypes = [ctypes.c_int]
        ind = lib.accl_ring_allreduce_indirect
        ind.restype = ctypes.c_int
        ind.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, op, dirs
            ctypes.c_int,  # vector instantiation
            ctypes.c_void_p,  # the table entry {x, out}
            ctypes.c_longlong, ctypes.c_longlong,  # row strides in, out
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,  # n, W, chunk
            ctypes.c_void_p,  # stream
        ]
    return lib


def vector_path(x: torch.Tensor, out: torch.Tensor) -> bool:
    """True when the kernel takes its 16-byte vector instantiation: both
    base pointers and both row strides are 16-byte multiples. Otherwise
    the scalar instantiation runs."""
    return _vector.vector_path(x, out)


def _launch(x: torch.Tensor, world: int, func: ReduceFunction, dirs: int,
            out: torch.Tensor) -> torch.Tensor:
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"ring allreduce kernel has no {x.dtype} lane")
    if x.stride(1) != 1:
        raise ValueError("ring allreduce kernel needs unit-stride rows")
    n = x.shape[1]
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.accl_ring_allreduce(
            int(from_torch_dtype(x.dtype)), int(func), dirs,
            int(vector_path(x, out)), x.data_ptr(), out.data_ptr(),
            x.stride(0), out.stride(0), n, world,
            chunk_elems(n, world, x.dtype, dirs),
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, err)
    return out


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err:
        msg = lib.accl_ring_error_string(err).decode()
        raise RuntimeError(f"ring allreduce kernel launch failed: {msg} "
                           f"(cudaError {err})")


def ring_allreduce_indirect(entry: int, device: torch.device,
                            dtype: torch.dtype, world: int, n: int,
                            ld_in: int, ld_out: int, vec: bool,
                            func: ReduceFunction = ReduceFunction.SUM,
                            dirs: int = 2) -> None:
    """Kernel 1 through its indirect entry: the launch reads its operand's
    and result's base pointers from the table entry at device address
    `entry` (two 64-bit pointers, x then out) when it runs, so a launch
    captured into a CUDA graph follows whatever the host last wrote
    there. The rows (`world`, `ld_in` and `ld_out` elements apart), `n`,
    the chunk geometry and the fold are the direct entry's, and so is
    every result, bit for bit. The kernel cannot see the pointers: the
    caller vouches for unit-stride rows and, for `vec`, for 16-byte base
    pointers and row strides. n == 0 launches without touching x or out
    (it loads the kernel, as a warm-up before a capture must). CUDA only;
    counts on the direct wrapper of the same `dirs`."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"ring allreduce kernel has no {dtype} lane")
    if device.type != "cuda":
        raise ValueError("the indirect entry runs on cuda only")
    lib = _library()
    with torch.cuda.device(device):
        err = lib.accl_ring_allreduce_indirect(
            int(from_torch_dtype(dtype)), int(func), dirs, int(vec), entry,
            ld_in, ld_out, n, world, chunk_elems(n, world, dtype, dirs),
            torch.cuda.current_stream(device).cuda_stream)
    _check(lib, err)
    (ring_allreduce_bidir if dirs == 2 else ring_allreduce).launches += 1


def _plain_on_cpu(x: torch.Tensor, world: int, slot: int,
                  out: torch.Tensor | None) -> bool:
    """Check a wrapper's arguments; True when x lies on the CPU (the plain
    version runs), False for a CUDA tensor (the kernel launches)."""
    _check_slot(slot)
    if x.dim() != 2 or x.shape[0] != world:
        raise ValueError(
            f"ring allreduce takes a stacked ({world}, n) tensor, got "
            f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ring allreduce runs on cuda or cpu, not {x.device}")
    if out is not None:
        if out.device != x.device or out.dtype != x.dtype:
            raise ValueError(
                f"ring allreduce out= is {out.dtype} on {out.device}, the "
                f"operand {x.dtype} on {x.device}")
        if out.shape != x.shape or (out.shape[1] > 1 and out.stride(1) != 1):
            raise ValueError(
                "ring allreduce out= must be a (world, n) view with "
                f"unit-stride rows, got shape {tuple(out.shape)} strides "
                f"{out.stride()}")
    return x.device.type == "cpu"


def _run(x: torch.Tensor, world: int, func, slot: int,
         out: torch.Tensor | None, dirs: int, wrapper) -> torch.Tensor:
    func = ReduceFunction(func)
    if _plain_on_cpu(x, world, slot, out):
        res = _ring_ref(x, world, func, dirs)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((world, x.shape[1]), dtype=x.dtype, device=x.device)
    _launch(x, world, func, dirs, out)
    wrapper.launches += 1
    return out


def ring_allreduce_bidir(x: torch.Tensor, world: int,
                         func: ReduceFunction = ReduceFunction.SUM,
                         slot: int = 0,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional ring allreduce of a stacked (world, n) tensor (rows
    may be a column slice of a wider buffer: only unit stride within a
    row is required), into `out` when given. Launches the Hopper kernel
    for a CUDA tensor; a CPU tensor takes the plain version."""
    return _run(x, world, func, slot, out, 2, ring_allreduce_bidir)


def ring_allreduce(x: torch.Tensor, world: int,
                   func: ReduceFunction = ReduceFunction.SUM,
                   slot: int = 0,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Unidirectional ring allreduce (the A/B baseline of
    ring_allreduce_bidir); same contract."""
    return _run(x, world, func, slot, out, 1, ring_allreduce)


ring_allreduce_bidir.launches = 0  # type: ignore[attr-defined]
ring_allreduce.launches = 0  # type: ignore[attr-defined]
