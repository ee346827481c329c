"""The int8-wire ring allreduce in closed form (ops/quant_kernels.
quant_ring_allreduce, whose plain version is compression._quant_ring_impl)
against the JAX facade's int8 allreduce (its jitted lax ring) on the same
numpy inputs, and against the port's own torch-op quantized ring
(schedules.allreduce_ring_schedule on the int8 Wire) on special-valued
blocks; bitwise, NaN matched as NaN. Also the wrapper's launch plan
(`ring_launches`: segments, ragged tail, vector or scalar
instantiation), which the CPU can check. The CUDA kernel is held against
the plain version and the torch-op ring on the card by chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu_torch import ACCL, DataType, ReduceFunction
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
from accl_tpu_torch.ops import compression, quant_kernels
from accl_tpu_torch.sequencer import schedules

QROW = DEFAULT_ARITH_CONFIG[(DataType.float32, DataType.int8)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of float32 tensors; NaN matches NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _seg_count(world: int, buf: int) -> int:
    """The allreduce plan's segment: the eager buffer's fp32 elements,
    rounded down to a multiple of the world."""
    seg = buf // 4
    return max(seg - seg % world, world)


def _torch_op_ring(x: torch.Tensor, world: int, func: int, seg: int):
    return schedules.allreduce_ring_schedule(
        x, func=ReduceFunction(func), world=world,
        wire=schedules.Wire(QROW, None), seg_count=seg)


# (world, count, func, eager buffer bytes): the int8 cases of
# tests/test_torch_accl.py, an odd world with 255-element segments, and
# a 7-rank world whose 586-element chunks end in a ragged block
FACADE_CASES = [
    (8, 3000, 0, 4096),
    (8, 3000, 1, 4096),
    (8, 600, 0, 1024),
    (5, 329, 0, 1024),
    (2, 700, 1, 1024),
    (3, 1000, 0, 1024),
    (7, 4099, 0, 65536),
]


@pytest.mark.parametrize(
    "world,count,func,buf", FACADE_CASES,
    ids=[f"w{w}-n{n}-{('sum', 'max')[f]}-buf{b}"
         for w, n, f, b in FACADE_CASES])
def test_closed_form_matches_reference_facade(world, count, func, buf,
                                              monkeypatch):
    """The JAX facade's int8 allreduce against the closed form, called
    directly with the plan's segment and through the port's facade with
    the kernel body switched on (its plain version on the CPU)."""
    rng = np.random.default_rng(world * 1000 + count + func)
    x = rng.standard_normal((world, count)).astype(np.float32)
    x[0, 5] = np.float32(1e-39)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref = RefACCL(mesh, egr_rx_buf_size=buf)
    sb = ref.create_buffer(count, np.float32, data=x)
    rb = ref.create_buffer(count, np.float32)
    ref.allreduce(sb, rb, count, RefF(func), compress_dtype=RefDT.int8)
    want = torch.from_numpy(np.array(rb.host))

    seg = _seg_count(world, buf)
    op = ("sum", "max")[func]
    direct = quant_kernels.quant_ring_allreduce(torch.from_numpy(x), world,
                                                op, seg)
    assert _bits_equal(direct, want)

    calls = []
    real = quant_kernels._quant_ring_impl

    def spy(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(quant_kernels, "_quant_ring_impl", spy)
    port = ACCL(world=world, torch_device="cpu", egr_rx_buf_size=buf)
    port.cclo.compiler.use_ring_kernel = True
    psb = port.create_buffer(count, data=x)
    prb = port.create_buffer(count)
    req = port.allreduce(psb, prb, count, ReduceFunction(func),
                         compress_dtype=DataType.int8)
    assert req.plan.seg_count == min(seg, count)
    assert calls == [(world, op, req.plan.seg_count)]
    assert _bits_equal(prb.host, want)


def _special(world: int, count: int, case: str, seed: int) -> torch.Tensor:
    """(world, count) fp32 rank rows with one kind of special-valued
    blocks; every count below leaves a ragged last block in some chunk."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((world, count)) * 3).astype(np.float32)
    if case == "zero_blocks":
        x[:, :300] = 0.0
        x[:, count // 2:count // 2 + 260] = 0.0
    elif case == "signed_zeros":
        x[::2, ::5] = -0.0  # -0 on even ranks, +0 on odd ones
        x[1::2, ::5] = 0.0
        x[0, 1::5] = 0.0  # +0 on rank 0, -0 on the rest
        x[1:, 1::5] = -0.0
        x[:, 2::5] = -0.0  # -0 on every rank
    elif case == "subnormal":
        x[:, ::3] = np.float32(1e-39)
        x[-1, 1::3] = np.float32(-1e-39)
        x[:, :256] = np.float32(1e-39)  # a whole block of them
    elif case == "nan":
        x[world // 2, 7 % count] = np.nan
        x[0, count - 1] = np.nan
    elif case == "inf":
        x[0, 3 % count] = np.inf
        x[-1, count // 2] = -np.inf
        x[:, count - 1] = np.inf  # Inf on every rank: Inf/Inf quotients
    elif case == "rail":
        # blocks whose values sit on the +-127 codes of their scale
        k = min(count, 256)
        x[:, :k] = np.linspace(-127.0, 127.0, k, dtype=np.float32) / 64
        x[0, count - 1] = np.float32(-1270.0)
    return torch.from_numpy(x)


SPECIAL_CASES = [  # (world, count, buf, func, case)
    (1, 31, 1024, 0, "nan"),
    (1, 1000, 1024, 1, "rail"),
    (2, 257, 1024, 0, "zero_blocks"),
    (2, 700, 1024, 1, "inf"),
    (2, 4099, 65536, 0, "signed_zeros"),
    (3, 1, 1024, 0, "rail"),
    (3, 1000, 1024, 1, "signed_zeros"),
    (3, 4099, 4096, 0, "subnormal"),
    (4, 31, 1024, 1, "subnormal"),
    (4, 1000, 4096, 0, "nan"),
    (5, 257, 1024, 0, "inf"),
    (5, 329, 1024, 1, "zero_blocks"),
    (5, 4099, 65536, 1, "rail"),
    (6, 1000, 1024, 0, "rail"),
    (6, 4099, 4096, 1, "nan"),
    (7, 31, 1024, 1, "zero_blocks"),
    (7, 1000, 4096, 0, "signed_zeros"),
    (7, 4099, 65536, 0, "inf"),
    (8, 1, 1024, 1, "signed_zeros"),
    (8, 257, 1024, 0, "subnormal"),
    (8, 3000, 4096, 1, "subnormal"),
    (8, 4099, 65536, 0, "zero_blocks"),
    (8, 4099, 65536, 1, "inf"),
    (8, 4099, 4096, 0, "nan"),
]


@pytest.mark.parametrize(
    "world,count,buf,func,case", SPECIAL_CASES,
    ids=[f"w{w}-n{n}-buf{b}-{('sum', 'max')[f]}-{c}"
         for w, n, b, f, c in SPECIAL_CASES])
def test_closed_form_matches_torch_op_ring(world, count, buf, func, case):
    seg = _seg_count(world, buf)
    x = _special(world, count, case, seed=SPECIAL_CASES.index(
        (world, count, buf, func, case)))
    got = quant_kernels.quant_ring_allreduce(x, world, ("sum", "max")[func],
                                             seg)
    want = _torch_op_ring(x, world, func, seg)
    assert _bits_equal(got, want)
    assert _bits_equal(got, got[:1].expand_as(got))


def _launch_plan(x, out, world, seg):
    return [(lo, segs, n, bool(vec)) for lo, segs, n, vec in
            quant_kernels.ring_launches(x, out, world, seg)]


def test_ring_launches_cut_full_segments_and_a_ragged_tail():
    """One launch for every full segment, one for the ragged last one;
    a call within one segment is a single (ragged) launch."""
    x = torch.zeros(8, 6_553_600)
    assert _launch_plan(x, torch.empty_like(x), 8, 1 << 20) == [
        (0, 6, 1 << 20, True), (6 << 20, 1, 262_144, True)]
    x = torch.zeros(8, 1 << 20)
    assert _launch_plan(x, torch.empty_like(x), 8, 1 << 20) == [
        (0, 1, 1 << 20, True)]
    x = torch.zeros(5, 1_000_003)  # 4 MiB buffer at W = 5: one segment
    assert _launch_plan(x, torch.empty_like(x), 5, 1_048_575) == [
        (0, 1, 1_000_003, False)]
    x = torch.zeros(5, 600)  # 255-element segments: m = 51, scalar
    assert _launch_plan(x, torch.empty_like(x), 5, 255) == [
        (0, 2, 255, False), (510, 1, 90, False)]


@pytest.mark.parametrize("world,seg,vec", [
    (8, 1024, True),    # m = 128
    (8, 1000, False),   # m = 125: chunks off the 16-byte grid
    (8, 1032, False),   # m = 129
    (4, 1040, True),    # m = 260, a ragged block of 4 floats
    (1, 1028, True),    # one row: its stride is never used
])
def test_ring_launches_vector_needs_4_element_segments_and_chunks(world, seg,
                                                                  vec):
    x = torch.zeros(world, seg)
    assert _launch_plan(x, torch.empty_like(x), world, seg) == [
        (0, 1, seg, vec)]


def test_ring_launches_vector_needs_aligned_views():
    """Column views: 16 floats into rows 8 floats wider (aligned base and
    stride) take the vector instantiation; 3 floats into rows 7 wider
    (odd stride) and 1 float off an aligned base take the scalar one,
    as does an aligned input beside a misaligned output."""
    n = 4096
    aligned = torch.zeros(8, n + 32)[:, 16:16 + n]
    odd = torch.zeros(8, n + 7)[:, 3:3 + n]
    off = torch.zeros(8, n + 32)[:, 1:1 + n]
    out = torch.empty(8, n)
    assert _launch_plan(aligned, out, 8, n) == [(0, 1, n, True)]
    assert _launch_plan(odd, out, 8, n) == [(0, 1, n, False)]
    assert _launch_plan(off, out, 8, n) == [(0, 1, n, False)]
    assert _launch_plan(out, odd, 8, n) == [(0, 1, n, False)]
    # the ragged tail's own base: after 1023-column segments it is 16
    # bytes aligned only past a multiple of 4 of them
    x = torch.zeros(3, 1023 + 24)
    assert _launch_plan(x, torch.empty_like(x), 3, 1023) == [
        (0, 1, 1023, False), (1023, 1, 24, False)]
    x = torch.zeros(3, 4 * 1023 + 24)
    assert _launch_plan(x, torch.empty_like(x), 3, 1023) == [
        (0, 4, 1023, False), (4092, 1, 24, True)]


def test_wrapper_checks_out_view_and_counts_no_launch_on_cpu():
    x = _special(5, 329, "nan", seed=3)
    before = quant_kernels.quant_ring_allreduce.launches
    buf = torch.full((5, 340), -7.0)
    view = buf[:, 4:333]
    got = quant_kernels.quant_ring_allreduce(x, 5, "sum", 255, out=view)
    assert got.data_ptr() == view.data_ptr()
    assert _bits_equal(view, _torch_op_ring(x, 5, 0, 255))
    assert bool((buf[:, :4] == -7).all() and (buf[:, 333:] == -7).all())
    assert quant_kernels.quant_ring_allreduce.launches == before
    with pytest.raises(ValueError, match="world"):
        quant_kernels.quant_ring_allreduce(x, 4, "sum", 255)
    with pytest.raises(TypeError, match="float32"):
        quant_kernels.quant_ring_allreduce(x.double(), 5, "sum", 255)
    with pytest.raises(ValueError, match="unsupported"):
        quant_kernels.quant_ring_allreduce(x, 5, "min", 255)
    with pytest.raises(ValueError, match="out="):
        quant_kernels.quant_ring_allreduce(x, 5, "sum", 255,
                                           out=torch.empty(5, 330))
    with pytest.raises(ValueError, match="devices"):
        quant_kernels.quant_ring_allreduce(x, 5, "sum", 255,
                                           out=torch.empty(5, 329,
                                                           device="meta"))


def test_plain_version_is_the_ring_steps_in_ring_order():
    """Chunk c of a 2-chunk, 1-block segment by hand from the step
    functions: encode rank c+1's copy, then the terminal combine with
    rank c's, then the allgather's encode and decode."""
    x = _special(2, 8, "signed_zeros", seed=11)
    c = compression
    out = []
    for chunk in range(2):
        cols = slice(4 * chunk, 4 * chunk + 4)
        enc = c._quantize_impl(x[(chunk + 1) % 2, cols][None])
        red = c._dequant_combine_impl(*enc, x[chunk, cols][None], "sum")
        out.append(c._dequantize_impl(*c._quantize_impl(red)))
    want = torch.cat(out, dim=-1).expand(2, 8)
    assert _bits_equal(c._quant_ring_impl(x, 2, "sum", 8), want)
