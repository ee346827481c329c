"""The plain versions of the port's ring kernels against the Pallas TPU
kernels they replace, run in Pallas TPU interpret mode under shard_map
(as tests/test_pallas_kernels.py runs them): bitwise equal, chunk
geometry and fold order included. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

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
from accl_tpu_torch.ops.ring_allreduce import (
    chunk_elems,
    ring_allreduce_bidir_ref,
    ring_allreduce_ref,
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
    return t.view(torch.int16) if t.itemsize == 2 else t.view(torch.int32)


# Interpret mode costs seconds per case at world 8, so the matrix is
# pairwise: every world meets both sizes (tile-aligned 256 and ragged
# 4000) and both functions; world 2 runs the full product.
CASES = [(kind, 2, n, f) for kind in KERNELS for n in (256, 4000)
         for f in (0, 1)] + [
    ("bidir", 4, 4000, 0), ("bidir", 4, 256, 1),
    ("bidir", 8, 4000, 0), ("bidir", 8, 256, 1),
    ("uni", 4, 256, 1), ("uni", 8, 4000, 0),
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
