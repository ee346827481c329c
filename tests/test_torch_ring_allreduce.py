"""The plain versions of the port's ring kernels against the Pallas TPU
kernels they replace, run in Pallas TPU interpret mode under shard_map
(as tests/test_pallas_kernels.py runs them): bitwise equal, chunk
geometry and fold order included. The closed form of the fold order
that the CUDA kernel computes (one fold per position, no hops) is held
bitwise against the plain version, which plays the ring hop by hop. The
CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py."""

import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec

from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu.ops.ring_allreduce import (
    ring_allreduce_pallas,
    ring_allreduce_pallas_bidir,
)
from accl_tpu_torch.constants import ReduceFunction as PortF
from accl_tpu_torch.interop import tensor_from_numpy
from accl_tpu_torch.ops.lane_kernels import _combine_impl
from accl_tpu_torch.ops.ring_allreduce import (
    SUPPORTED_DTYPES,
    _ring_ref,
    chunk_elems,
    ring_allreduce,
    ring_allreduce_bidir,
    ring_allreduce_bidir_ref,
    ring_allreduce_ref,
    vector_path,
)

KERNELS = {
    "bidir": (ring_allreduce_pallas_bidir, ring_allreduce_bidir_ref),
    "uni": (ring_allreduce_pallas, ring_allreduce_ref),
}


def _pallas(kernel, x, world, func):
    if not hasattr(pltpu, "InterpretParams"):
        pytest.skip("platform gap: jax.experimental.pallas.tpu.InterpretParams "
                    f"absent (jax {jax.__version__}); the CPU interpret path "
                    "of the fused ring kernels needs it")
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    body = functools.partial(kernel, axis_name="ccl", world=world,
                             func=RefF(func))
    fn = jax.jit(jax.shard_map(
        lambda a: body(a.reshape(-1)).reshape(1, -1), mesh=mesh,
        in_specs=PartitionSpec("ccl"), out_specs=PartitionSpec("ccl"),
        check_vma=False))
    return np.array(fn(x))


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.itemsize])


# Interpret mode costs seconds per case at world 8, so the matrix is
# pairwise: every world meets both sizes (tile-aligned 256 and ragged
# 4000) and both functions; world 2 runs the full product.
CASES = [(kind, 2, n, f) for kind in KERNELS for n in (256, 4000)
         for f in (0, 1)] + [
    ("bidir", 4, 4000, 0), ("bidir", 4, 256, 1),
    ("bidir", 8, 4000, 0), ("bidir", 8, 256, 1),
    ("uni", 4, 256, 1), ("uni", 8, 4000, 0),
    # non-power-of-two worlds: odd chunk counts, empty trailing chunks
    ("bidir", 3, 4000, 0), ("uni", 6, 1000, 1),
]


@pytest.mark.parametrize("kind,world,n,func", CASES,
                         ids=lambda v: {0: "sum", 1: "max"}.get(v, str(v))
                         if isinstance(v, int) and v < 2 else str(v))
def test_plain_version_equals_pallas_kernel(kind, world, n, func):
    x = np.random.default_rng(world * 100 + n).standard_normal(
        (world, n)).astype(np.float32)
    pallas, plain = KERNELS[kind]
    ref = _pallas(pallas, x, world, func)
    got = plain(torch.from_numpy(x), world, PortF(func))
    assert torch.equal(_bits(got), _bits(torch.from_numpy(ref)))


@pytest.mark.parametrize("kind", ["bidir", "uni"])
def test_plain_version_equals_pallas_kernel_bf16(kind):
    world, n = 4, 3000
    x = np.random.default_rng(42).standard_normal((world, n)).astype(
        ml_dtypes.bfloat16)
    pallas, plain = KERNELS[kind]
    ref = _pallas(pallas, x, world, 0)
    got = plain(tensor_from_numpy(x), world, PortF.SUM)
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(tensor_from_numpy(ref)))


def test_chunk_geometry_keeps_the_tpu_tile():
    # fp32 tiles are 8x128 elements, 16-bit types 16x128
    assert chunk_elems(4000, 8, torch.float32, 2) == 1024
    assert chunk_elems(4000, 8, torch.bfloat16, 2) == 2048
    assert chunk_elems(1, 5, torch.float64, 1) == 1024
    assert chunk_elems(1 << 20, 8, torch.float32, 2) == 65536


def _fold_order(x, world, func, dirs):
    """The closed form of the ring's fold order (the CUDA kernel's): a
    position of chunk c in direction d folds over the ranks c+s, c+2s,
    ..., c+Ws (mod W; s = +1 forward, -1 backward) as acc = x[c+s], then
    acc = combine(acc, x[c+ks]); every rank's output is that fold."""
    n = x.shape[1]
    chunk = chunk_elems(n, world, x.dtype, dirs)
    padded = x.new_zeros((world, dirs * world * chunk))
    padded[:, :n] = x
    regions = padded.view(world, dirs, world, chunk)
    out = torch.empty((dirs, world, chunk), dtype=x.dtype)
    op = "sum" if func == PortF.SUM else "max"
    for d in range(dirs):
        s = 1 if d == 0 else -1
        for c in range(world):
            acc = regions[(c + s) % world, d, c]
            for k in range(2, world + 1):
                acc = _combine_impl(acc, regions[(c + k * s) % world, d, c],
                                    op)
            out[d, c] = acc
    return out.reshape(1, -1)[:, :n].expand(world, n)


def _special_columns(world, dtype):
    """Rank columns where the fold's rules show: subnormals (flushed in
    f32/f64/bf16 arithmetic, kept by fp16), signed zeros in both orders,
    NaN, +-Inf, fp16 overflow; for integers, the SUM wrap."""
    def col(*head, fill):
        c = [fill] * world
        c[:len(head)] = head[:world]
        return c

    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return [col(fill=info.max), col(fill=info.min),
                col(info.max, fill=1), col(-1, fill=info.min)]
    tiny = {torch.float64: 1e-310, torch.float16: 6e-8}.get(dtype, 1e-39)
    return [col(tiny, fill=0.0), col(fill=tiny),
            col(fill=-0.0)[:-1] + [0.0], [0.0] + col(fill=-0.0)[1:],
            col(fill=-tiny)[:-1] + [0.0], col(0.5, np.nan, fill=1.0),
            col(np.inf, fill=2.0)[:-1] + [-np.inf], col(fill=65504.0),
            col(fill=-65504.0), col(fill=np.inf)]


def _ring_operand(world, n, dtype, seed, view):
    """A seeded (world, n) operand with the special columns first; with
    `view`, a column slice of a wider buffer (row stride n + 7)."""
    rng = np.random.default_rng(seed)
    width = n + 7 if view else n
    if dtype.is_floating_point:
        buf = torch.from_numpy(rng.standard_normal((world, width)) * 100)
    else:
        info = torch.iinfo(dtype)
        buf = torch.from_numpy(rng.integers(info.min, info.max,
                                            (world, width), dtype=np.int64))
    lo = 3 if view else 0
    for j, c in enumerate(_special_columns(world, dtype)[:n]):
        buf[:, lo + j] = torch.tensor(c, dtype=buf.dtype)
    return buf.to(dtype)[:, lo:lo + n]


@pytest.mark.parametrize("dtype", SUPPORTED_DTYPES, ids=str)
@pytest.mark.parametrize("world", [1, 2, 3, 5, 6, 7, 8])
@pytest.mark.parametrize("dirs", [2, 1], ids=["bidir", "uni"])
def test_fold_order_closed_form_equals_plain_version(dirs, world, dtype):
    tile = chunk_elems(1, 1, dtype, 1)
    edge = dirs * world * tile  # past it the chunk grows by a tile
    for n in (1, 127, 1000, 4099, edge - 1, edge + 1):
        for view in (False, True):
            x = _ring_operand(world, n, dtype, world * 1000 + n, view)
            assert x.is_contiguous() == (not view or world == 1)
            for func in (PortF.SUM, PortF.MAX):
                want = _ring_ref(x, world, func, dirs)
                got = _fold_order(x, world, func, dirs)
                assert got.dtype == want.dtype
                assert torch.equal(_bits(got), _bits(want)), (n, view, func)


@pytest.mark.parametrize("kind", ["bidir", "uni"])
def test_out_view_is_written_in_place(kind):
    wrapper = {"bidir": ring_allreduce_bidir, "uni": ring_allreduce}[kind]
    world, n = 5, 1000
    x = _ring_operand(world, n, torch.float32, seed=77, view=True)
    buf = torch.full((world, 3 * n), -7.0)
    view = buf[:, n:2 * n]
    got = wrapper(x, world, PortF.SUM, out=view)
    assert got.data_ptr() == view.data_ptr()
    assert torch.equal(_bits(view), _bits(wrapper(x, world, PortF.SUM)))
    assert bool((buf[:, :n] == -7.0).all() and (buf[:, 2 * n:] == -7.0).all())
    with pytest.raises(ValueError):
        wrapper(x, world, out=buf[:, :n - 1])
    with pytest.raises(ValueError):
        wrapper(x, world, out=buf[:, ::3])
    with pytest.raises(ValueError):
        wrapper(x, world, out=view.double())


def test_vector_path_needs_aligned_bases_and_strides():
    x = torch.zeros((8, 1024))
    assert vector_path(x, x)
    assert not vector_path(x[:, 1:], x[:, 1:])  # base off by 4 bytes
    odd = torch.zeros((5, 1001))[:, :1000]  # row stride 4004 bytes
    assert not vector_path(odd, x[:5, :1000])
    assert not vector_path(x[:5, :1000], odd)
    assert vector_path(torch.zeros((8, 4096))[:, 1024:2048], x)
