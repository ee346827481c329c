"""The port's ACCL.allreduce end to end against the reference facade on
the same numpy inputs: the torch-op ring against the lax ring, the plain
ring-kernel body against the Pallas kernel body (segmented, both slots),
the compressed-domain bf16 row, and the blockwise-int8 wire."""

import jax
import numpy as np
import pytest
import torch

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu.device.tpu_device import TPUDevice
from accl_tpu_torch import ACCL, DataType, ReduceFunction
from accl_tpu_torch.interop import tensor_from_numpy
from accl_tpu_torch.ops import ring_allreduce as port_ring


def _data(world, count, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-(1 << 30), 1 << 30, (world, count), dtype=np.int32)
    return rng.standard_normal((world, count)).astype(dtype)


def _ref_allreduce(accl, x, func, **kw):
    count = x.shape[1]
    sb = accl.create_buffer(count, x.dtype, data=x)
    rb = accl.create_buffer(count, x.dtype)
    accl.allreduce(sb, rb, count, RefF(func), **kw)
    return np.array(rb.host)


def _port_allreduce(accl, x, func, **kw):
    count = x.shape[1]
    dtype = tensor_from_numpy(x).dtype
    sb = accl.create_buffer(count, dtype, data=x)
    rb = accl.create_buffer(count, dtype)
    req = accl.allreduce(sb, rb, count, ReduceFunction(func), **kw)
    assert req.plan.algorithm.name == "EAGER_RING_RS_AG"
    return rb.host


@pytest.mark.parametrize("dtype,func", [(np.float32, 0), (np.float32, 1),
                                        (np.int32, 0)],
                         ids=["f32-sum", "f32-max", "i32-sum"])
@pytest.mark.parametrize("count", [329, 3000])
def test_allreduce_torch_op_ring_bitwise(mesh8, count, dtype, func):
    x = _data(8, count, dtype, seed=count + func)
    ref = _ref_allreduce(RefACCL(mesh8), x, func)
    port = ACCL(world=8, torch_device="cpu")
    assert port.cclo.compiler.use_ring_kernel is False
    got = _port_allreduce(port, x, func)
    assert torch.equal(got, torch.from_numpy(ref))


def test_allreduce_ring_kernel_body_bitwise(mesh8):
    """The kernel branch: 1000 fp32 elements against a 2048-byte cap run
    two segments (slot 0, then a ragged tail in slot 1) through the
    Pallas kernel on the reference side and the kernel's plain version
    on the port side."""
    n = 1000
    x = _data(8, n, np.float32, seed=5)
    dev = TPUDevice(mesh8)
    dev.compiler.use_pallas_ring = True
    dev.compiler.PALLAS_RING_MAX_BYTES = 2048
    ref = _ref_allreduce(RefACCL(device=dev), x, 0)

    port = ACCL(world=8, torch_device="cpu")
    port.cclo.compiler.use_ring_kernel = True
    port.cclo.compiler.RING_KERNEL_MAX_BYTES = 2048
    slots = []
    real = port_ring.ring_allreduce_bidir

    def spy(y, world, func, slot=0, out=None):
        slots.append((y.shape[1], slot))
        return real(y, world, func, slot=slot, out=out)

    port_ring.ring_allreduce_bidir = spy
    try:
        got = _port_allreduce(port, x, 0)
    finally:
        port_ring.ring_allreduce_bidir = real
    assert slots == [(512, 0), (488, 1)]
    assert torch.equal(got, torch.from_numpy(ref))


def test_allreduce_compressed_domain_bf16_row(mesh8):
    """f32 payload on the bf16 row (arith in the compressed domain): the
    operand is cast to bf16 once, the ring runs in bf16, the result is
    cast back. Bitwise is expected; the stated bound is 1 bf16 ULP of
    the result magnitude, in case the two frameworks' casts round
    differently."""
    x = _data(8, 3000, np.float32, seed=9)
    ref = _ref_allreduce(RefACCL(mesh8), x, 0, compress_dtype=RefDT.bfloat16)
    port = ACCL(world=8, torch_device="cpu")
    got = _port_allreduce(port, x, 0, compress_dtype=DataType.bfloat16).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("world,count,func,buf", [
    (8, 3000, 0, 4096),  # 3 segments of 1024, chunks of 128
    (8, 3000, 1, 4096),
    (8, 600, 0, 1024),   # the default buffer: 256-element segments
    (5, 329, 0, 1024),   # odd world, ragged count and chunk
    (2, 700, 1, 1024),
], ids=["w8-sum", "w8-max", "w8-default-buf", "w5-ragged", "w2-max"])
def test_allreduce_int8_wire_bitwise(world, count, func, buf):
    """The blockwise-int8 wire through both facades: the port's quantized
    torch-op ring with the kernels' plain versions against the reference's
    jitted lax ring, bitwise (codes, scales and every fused step), and
    identical on every rank."""
    from jax.sharding import Mesh

    x = _data(world, count, np.float32, seed=world * 100 + count + func)
    x[0, 5] = np.float32(1e-39)  # a subnormal operand is flushed by both
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref = _ref_allreduce(RefACCL(mesh, egr_rx_buf_size=buf), x, func,
                         compress_dtype=RefDT.int8)
    port = ACCL(world=world, torch_device="cpu", egr_rx_buf_size=buf)
    got = _port_allreduce(port, x, func, compress_dtype=DataType.int8)
    assert torch.equal(got, torch.from_numpy(ref))
    assert torch.equal(got, got[:1].expand_as(got))


def test_async_chained_and_host_only_calls():
    port = ACCL(world=4, torch_device="cpu")
    x = _data(4, 700, np.float32, seed=3)
    sb = port.create_buffer(700, data=x)
    mid = port.create_buffer(700)
    rb = port.create_buffer(700, host_only=True)
    req = port.allreduce(sb, mid, 700, ReduceFunction.MAX, run_async=True,
                         to_device=True)
    port.wait(req)
    # chained on the device: mid is never synced to the host
    assert torch.count_nonzero(mid.host) == 0
    port.allreduce(mid, rb, 700, ReduceFunction.SUM, from_device=True)
    np.testing.assert_allclose(rb.host.numpy(), 4 * np.tile(x.max(0), (4, 1)),
                               rtol=1e-6)
    assert port.get_duration_ns() > 0


def test_world_one_and_zero_count():
    port = ACCL(world=1, torch_device="cpu")
    x = _data(1, 100, np.float64, seed=1)
    sb = port.create_buffer(100, torch.float64, data=x)
    rb = port.create_buffer(100, torch.float64)
    port.allreduce(sb, rb, 100, ReduceFunction.SUM)
    assert torch.equal(rb.host, torch.from_numpy(x))
    with pytest.raises(ValueError):
        port.allreduce(sb, rb, 0, ReduceFunction.SUM)


def test_register_window_of_a_later_slice_raises_through_the_facade(mesh8):
    """The OVERLAP_MIN_COUNT window, which raised through the facade
    before the stripe-overlapped allreduce was ported (hence the name),
    now runs the striped plan (its stripe count the shipped cost
    model's), bitwise with the reference facade under the same register,
    and register 0 restores the serial plan."""
    from accl_tpu.constants import TuningParams as RefTuning
    from accl_tpu_torch import TuningParams

    x = _data(8, 4096, np.float32, seed=11)
    ref = RefACCL(mesh8)
    ref.configure_tuning_parameters(RefTuning(overlap_min_count=1024))
    want = _ref_allreduce(ref, x, 0)
    port = ACCL(world=8, torch_device="cpu")
    port.configure_tuning_parameters(TuningParams(overlap_min_count=1024))
    sb = port.create_buffer(4096, torch.float32, data=x)
    rb = port.create_buffer(4096, torch.float32)
    req = port.allreduce(sb, rb, 4096, ReduceFunction.SUM)
    assert req.plan.stripes > 1
    assert torch.equal(rb.host, torch.from_numpy(want))
    port.configure_tuning_parameters(TuningParams.default())
    req = port.allreduce(sb, rb, 4096, ReduceFunction.SUM)
    assert req.plan.stripes == 1


@pytest.mark.parametrize("func", [0, 1], ids=["sum", "max"])
def test_allreduce_flushes_subnormals_and_orders_zeros(mesh4, func):
    """The columns where torch.add / torch.maximum alone diverge from the
    JAX facade (XLA flushes subnormals and puts +0 above -0), W = 4,
    n = 64: [1e-39, 0, 0, 0] and [1e-39] * 4 under SUM, [1e-39, 0, 0, 0]
    and [-0, -0, -0, +0] under MAX, through both of the port's bodies (the
    torch-op ring and the ring kernel's plain version) and both of the
    reference's (the lax ring and the Pallas kernel in interpret mode)."""
    x = _data(4, 64, np.float32, seed=40 + func)
    cols = ([[1e-39, 0, 0, 0], [1e-39] * 4] if func == 0
            else [[1e-39, 0, 0, 0], [-0.0, -0.0, -0.0, 0.0]])
    for j, col in enumerate(cols):
        x[:, 5 + j] = np.array(col, np.float32)
    dev = TPUDevice(mesh4)
    dev.compiler.use_pallas_ring = True
    # (port body, reference body): the torch-op ring against the lax ring,
    # the kernel's plain version against the Pallas kernel (their fold
    # orders differ from each other, so SUM differs between the pairs)
    pairs = ((False, RefACCL(mesh4)), (True, RefACCL(device=dev)))
    for kernel_body, ref in pairs:
        want = _ref_allreduce(ref, x, func)
        assert not np.signbit(want[:, 5:7]).any()
        assert (want[:, 5:7] == 0).all()
        port = ACCL(world=4, torch_device="cpu")
        port.cclo.compiler.use_ring_kernel = kernel_body
        got = _port_allreduce(port, x, func)
        assert torch.equal(got.view(torch.int32),
                           torch.from_numpy(want).view(torch.int32))
