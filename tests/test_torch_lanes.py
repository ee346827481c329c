"""The port's arith and cast lanes against the JAX package's, on the same
numpy inputs: the plain versions of the three lane kernels (combine,
combine_cast, cast) bitwise against combine_pallas,
fused_combine_cast_pallas and cast_pallas in interpret mode, and the
port's reduce_lane / combine_op / compress / decompress against the
jitted jnp functions, over random values and the special values XLA
treats in its own way: subnormals (flushed in float32, float64 and
bfloat16 arithmetic, kept by casts), signed zeros under MAX in both
orders, NaN, +-Inf, float16 overflow and int32 wrap. A NaN matches any
NaN: its payload may differ between XLA, torch and the CUDA kernels.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.arithconfig import DEFAULT_ARITH_CONFIG as REF_TABLE
from accl_tpu.constants import DataType as RefDT
from accl_tpu.constants import ReduceFunction as RefF
from accl_tpu.ops import compression as ref_comp
from accl_tpu.ops import reduce_ops as ref_reduce
from accl_tpu.ops.pallas_kernels import (
    cast_pallas,
    combine_pallas,
    fused_combine_cast_pallas,
)
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
from accl_tpu_torch.constants import DataType, ReduceFunction
from accl_tpu_torch.interop import tensor_from_numpy
from accl_tpu_torch.ops import compression as port_comp
from accl_tpu_torch.ops import lane_kernels
from accl_tpu_torch.ops import reduce_ops as port_reduce

BF16 = jnp.bfloat16

# (a, b) pairs every float lane sees, in float64 before the cast to the
# lane's dtype: signed zeros in both orders, subnormals of every width
# (f32 1e-39, f64 1e-310, bf16 1.01e-39, f16 6e-8), their sums and
# mixed signs, a value just above FLT_MIN, NaN, +-Inf, f16 overflow
SPECIAL = [
    (0.0, -0.0), (-0.0, 0.0), (-0.0, -0.0), (0.0, 0.0),
    (1e-39, 0.0), (0.0, 1e-39), (1e-39, 1e-39), (-1e-39, 0.0),
    (1e-39, -0.0), (-1e-39, -1e-39), (1e-39, -1e-39), (-1e-39, 1e-39),
    (2e-38, -1.5e-38), (-2e-38, 1.5e-38), (1.2e-38, 1e-40),
    (1e-310, 0.0), (1e-310, 1e-310), (-1e-310, 0.0), (1e-310, -1e-310),
    (6e-8, 0.0), (6e-8, -6e-8), (3e-8, 3e-8), (-6e-8, 1.2e-7),
    (np.nan, 0.0), (0.0, np.nan), (np.nan, np.inf), (np.inf, -np.inf),
    (-np.inf, -np.inf), (np.inf, 1.0), (65504.0, 65504.0),
    (-65504.0, -65504.0), (65520.0, 0.0), (3.4e38, 3.4e38),
]


def _operands(dtype, n=257, seed=0):
    """(a, b) numpy operands of a lane dtype: random values, then the
    special pairs (floats) or the int32/int64 wrap pairs (ints)."""
    dt = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, n, dtype=dt)
        b = rng.integers(info.min, info.max, n, dtype=dt)
        a[:4] = [info.max, info.min, info.max, -1]
        b[:4] = [1, -1, info.max, info.min]
        return a, b
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    sa, sb = np.array(SPECIAL).T
    a[:len(sa)], b[:len(sb)] = sa, sb
    with np.errstate(over="ignore"):
        return a.astype(dt), b.astype(dt)


def _t(a: np.ndarray) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def assert_same_bits(got: torch.Tensor, want: torch.Tensor):
    """Bitwise equality, with any NaN matching any NaN at the same place."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(want))
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.itemsize]
        bad = (got[~nan].view(ints) != want[~nan].view(ints)).nonzero()
        assert not len(bad), (got[~nan][bad[:4, 0]], want[~nan][bad[:4, 0]])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("lane", range(12))
def test_reduce_lane_matches_jitted_reference(lane):
    dtype, _ = ref_reduce._LANE_DTYPES[lane]
    a, b = _operands(dtype, seed=lane)
    want = jax.jit(lambda x, y: ref_reduce.reduce_lane(lane, x, y))(a, b)
    assert_same_bits(port_reduce.reduce_lane(lane, _t(a), _t(b)), _t(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.float16, BF16],
                         ids=["f32", "f64", "i32", "i64", "f16", "bf16"])
@pytest.mark.parametrize("func", [0, 1], ids=["sum", "max"])
def test_combine_op_matches_jitted_reference(dtype, func):
    a, b = _operands(dtype, seed=7 + func)
    want = jax.jit(lambda x, y: ref_reduce.combine_op(RefF(func), x, y))(a, b)
    got = port_reduce.combine_op(ReduceFunction(func), _t(a), _t(b))
    assert_same_bits(got, _t(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32],
                         ids=["f32", "f64", "i32"])
def test_combine_kernel_plain_matches_pallas(dtype):
    """Kernel 7's plain version against combine_pallas in interpret mode,
    at a size that spans two of its (512, 128) tiles."""
    a, b = _operands(dtype, n=512 * 128 + 77, seed=3)
    for op in ("sum", "max"):
        want = combine_pallas(jnp.asarray(a), jnp.asarray(b), op=op,
                              interpret=True)
        assert_same_bits(lane_kernels.combine(_t(a), _t(b), op), _t(want))


@pytest.mark.parametrize("src,out", [
    (BF16, BF16), (np.float16, np.float16), (np.float32, BF16),
    (BF16, np.float32), (np.float32, np.float32), (np.float32, np.float16),
    (np.float16, np.float32), (np.float16, BF16), (BF16, np.float16),
], ids=["bf16", "f16", "f32-to-bf16", "bf16-to-f32", "f32-to-f32",
        "f32-to-f16", "f16-to-f32", "f16-to-bf16", "bf16-to-f16"])
def test_combine_cast_kernel_plain_matches_pallas(src, out):
    """Kernel 8's plain version against fused_combine_cast_pallas in
    interpret mode, for every (in, out) pair the kernel takes: both
    operands widened to float32, combined, rounded once to the output
    dtype."""
    a, b = _operands(src, n=1000, seed=4)
    out_t = _t(np.zeros(1, out)).dtype
    for op in ("sum", "max"):
        want = fused_combine_cast_pallas(jnp.asarray(a), jnp.asarray(b),
                                         op=op, acc_dtype=jnp.float32,
                                         out_dtype=out, interpret=True)
        got = lane_kernels.combine_cast(_t(a), _t(b), op, torch.float32,
                                        out_t)
        assert_same_bits(got, _t(want))


@pytest.mark.parametrize("src,dst", [(np.float32, np.float16),
                                     (np.float16, np.float32),
                                     (np.float32, BF16), (BF16, np.float32)],
                         ids=["f32-f16", "f16-f32", "f32-bf16", "bf16-f32"])
def test_cast_kernel_plain_matches_pallas(src, dst):
    """Kernel 9's plain version against cast_pallas in interpret mode:
    round to nearest even, subnormals kept (f32 1e-39 -> bf16 1.01e-39,
    1e-40 -> 9.18e-41), f16 overflow to Inf."""
    a, _ = _operands(src, n=1000, seed=5)
    a[-4:] = np.array([1e-39, 1e-40, -1e-39, 7e-8]).astype(src)
    dst_t = _t(np.zeros(1, dst)).dtype
    want = cast_pallas(jnp.asarray(a), dst, interpret=True)
    assert_same_bits(lane_kernels.cast(_t(a), dst_t), _t(want))


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_compress_and_decompress_match_jitted_reference(wire):
    rcfg = REF_TABLE[(RefDT.float32, RefDT[wire])]
    pcfg = DEFAULT_ARITH_CONFIG[(DataType.float32, DataType[wire])]
    x, _ = _operands(np.float32, n=999, seed=6)
    want = jax.jit(lambda v: ref_comp.compress(v, rcfg))(x)
    got = port_comp.compress(_t(x), pcfg)
    assert_same_bits(got, _t(want))
    back = jax.jit(lambda v: ref_comp.decompress(v, rcfg, jnp.float32))(want)
    assert_same_bits(port_comp.decompress(got, pcfg, torch.float32), _t(back))


def test_fault_columns_flush_and_order_zeros():
    """The four columns where torch.add / torch.maximum alone differ from
    the JAX package: a subnormal operand flushes, a sum of subnormals
    flushes, and MAX puts +0 above -0."""
    z = torch.tensor([0.0])
    s = torch.tensor([1e-39])
    assert port_reduce.combine_op(ReduceFunction.SUM, s, z).item() == 0.0
    assert port_reduce.combine_op(ReduceFunction.SUM, s, s).item() == 0.0
    assert port_reduce.combine_op(ReduceFunction.MAX, s, z).item() == 0.0
    got = port_reduce.combine_op(ReduceFunction.MAX, -z, z)
    assert got.item() == 0.0 and not torch.signbit(got).item()
    got = port_reduce.reduce_lane(5, z, -z)
    assert not torch.signbit(got).item()


def test_wrappers_use_the_plain_version_only_on_cpu():
    """A CPU tensor never counts a launch; unsupported lanes and devices
    raise rather than fall back."""
    x = torch.linspace(-2, 2, 300)
    before = (lane_kernels.combine.launches,
              lane_kernels.combine_cast.launches, lane_kernels.cast.launches)
    lane_kernels.combine(x, x, "sum")
    lane_kernels.combine_cast(x.bfloat16(), x.bfloat16(), "max")
    lane_kernels.cast(x, torch.float16)
    assert (lane_kernels.combine.launches, lane_kernels.combine_cast.launches,
            lane_kernels.cast.launches) == before
    assert lane_kernels.cast(x, torch.float32) is x  # no-op, no launch
    with pytest.raises(TypeError):
        lane_kernels.combine(x.half(), x.half(), "sum")
    with pytest.raises(TypeError):
        lane_kernels.cast(x.double(), torch.float16)
    with pytest.raises(ValueError):
        lane_kernels.combine(x, x, "min")
    with pytest.raises(ValueError):
        lane_kernels.combine(x, x.to("meta"), "sum")


LANE_DTYPES = [torch.float32, torch.float16, torch.bfloat16]
LANE_IDS = ["f32", "f16", "bf16"]


@pytest.mark.parametrize("dtype", LANE_DTYPES, ids=LANE_IDS)
@pytest.mark.parametrize("n", [1000, 999, 1], ids=["even", "odd", "one"])
def test_launch_shape_folds_contiguous_rows(n, dtype):
    """Rows that lie back to back in every operand launch as one row of
    rows*n elements, in the vector instantiation (fresh tensors are
    16-byte aligned), whatever n."""
    a, b = torch.zeros((5, n), dtype=dtype), torch.ones((5, n), dtype=dtype)
    res = torch.empty((5, n), dtype=torch.float32)
    assert lane_kernels._launch_shape(a, b, res) == (1, 5 * n, (5 * n,) * 3,
                                                     True)
    assert lane_kernels._launch_shape(a, res) == (1, 5 * n, (5 * n,) * 2,
                                                  True)


@pytest.mark.parametrize("dtype", LANE_DTYPES, ids=LANE_IDS)
def test_launch_shape_keeps_column_views(dtype):
    """A column view of a wider buffer keeps its (rows, n) walk and its
    row strides; one contiguous operand does not fold the others."""
    buf = torch.zeros((4, 1040), dtype=dtype)
    view = buf[:, 16:1016]
    res = torch.empty((4, 1000), dtype=dtype)
    assert lane_kernels._launch_shape(view, view, res) == (
        4, 1000, (1040, 1040, 1000), True)
    odd = torch.zeros((4, 1003), dtype=dtype)[:, :1000]
    assert lane_kernels._launch_shape(odd, res) == (4, 1000, (1003, 1000),
                                                    False)


@pytest.mark.parametrize("dtype", LANE_DTYPES, ids=LANE_IDS)
def test_launch_shape_vector_needs_aligned_bases_and_strides(dtype):
    """The vector instantiation runs only when every base pointer is a
    16-byte multiple, and so is every row stride in bytes, unless the
    launch is one row."""
    item = torch.empty(0, dtype=dtype).element_size()
    buf = torch.zeros((4, 2048), dtype=dtype)
    res = torch.empty((4, 1024), dtype=dtype)
    assert lane_kernels._launch_shape(buf[:, 64:1088], res)[3]
    for off in (2, 4, 8):  # bytes; a float32 base is never off by 2
        if off % item:
            continue
        lo = 64 + off // item
        view = buf[:, lo:lo + 1024]
        assert not lane_kernels._launch_shape(view, res)[3], off
        assert not lane_kernels._launch_shape(res, view)[3], off
        assert not lane_kernels._launch_shape(buf[:1, lo:lo + 1024],
                                              res[:1])[3], off
    # a row stride of 1025 elements is no 16-byte multiple for any dtype
    odd = torch.zeros((4, 1025), dtype=dtype)[:, :1024]
    assert not lane_kernels._launch_shape(odd, res)[3]
    assert not lane_kernels._launch_shape(res, odd)[3]
    # one row: the stride is never used, and n need not be a multiple of 8
    for n in (8 * 7 + 3, 1, 8):
        one = odd[1:2, :n]  # base 1025 elements in: aligned for no dtype
        assert lane_kernels._launch_shape(one, res[:1, :n]) == (
            1, n, (n, n), False)
        row = buf[1:2, 64:64 + n]  # base 2112 elements in: aligned
        assert lane_kernels._launch_shape(row, res[:1, :n]) == (
            1, n, (n, n), True)


def test_ring_vector_path_is_the_shared_rule():
    """ring_allreduce.vector_path(x, out) gives the answer of its own
    former rule (both bases and both row strides 16-byte multiples, one
    row or many) over aligned, offset and odd-stride views."""
    from accl_tpu_torch.ops import ring_allreduce

    def former(x, out):
        b = x.element_size()
        return all(v % 16 == 0 for v in (x.data_ptr(), out.data_ptr(),
                                          x.stride(0) * b, out.stride(0) * b))

    for dtype in (torch.float32, torch.float64, torch.int32, torch.float16,
                  torch.bfloat16):
        buf = torch.zeros((8, 2049), dtype=dtype)
        views = [torch.zeros((8, 1024), dtype=dtype), buf[:, :1024],
                 buf[:, 1:1025], buf[:1, :1001],
                 torch.zeros((1, 1001), dtype=dtype),
                 torch.zeros((8, 2048), dtype=dtype)[:, 8:1032]]
        for x in views:
            for out in views:
                if x.shape == out.shape:
                    assert ring_allreduce.vector_path(x, out) == former(
                        x, out), (dtype, x.shape, x.stride(), out.stride())


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.float64, torch.int32, torch.int64],
    ids=["f32", "f64", "i32", "i64"])
def test_combine_launch_shape_over_its_dtypes(dtype):
    """Kernel 7's launches: contiguous rows fold into one row, vector;
    an aligned column view keeps its rows, vector; a base one element
    (4 or 8 bytes) off or an odd row stride takes the scalar walk."""
    a = torch.zeros((5, 999), dtype=dtype)
    res = torch.empty((5, 999), dtype=dtype)
    assert lane_kernels._launch_shape(a, a, res) == (1, 5 * 999,
                                                     (5 * 999,) * 3, True)
    buf = torch.zeros((4, 1040), dtype=dtype)
    out = torch.empty((4, 1000), dtype=dtype)
    assert lane_kernels._launch_shape(buf[:, 16:1016], buf[:, 16:1016],
                                      out) == (4, 1000, (1040, 1040, 1000),
                                               True)
    assert not lane_kernels._launch_shape(buf[:, 17:1017], buf[:, 16:1016],
                                          out)[3]
    odd = torch.zeros((4, 1001), dtype=dtype)[:, :1000]
    assert lane_kernels._launch_shape(odd, odd, out) == (
        4, 1000, (1001, 1001, 1000), False)
