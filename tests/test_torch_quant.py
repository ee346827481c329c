"""The port's blockwise int8 lanes against the JAX package's, on the same
numpy inputs: the plain versions of the four quantized kernels bitwise
against the jitted jnp functions (what the reference facade runs: its
ring is jitted under shard_map) and against the Pallas kernels in
interpret mode, the eager jnp functions within the reference's own
tolerance, the edge cases of tests/test_compression.py plus NaN, Inf and
subnormal blocks, and the packed wire bytes. The CUDA kernels are held
against these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.ops import compression as ref
from accl_tpu.ops.pallas_kernels import (
    dequantize_pallas,
    fused_dequant_combine_pallas,
    fused_dequant_combine_quant_pallas,
    quantize_pallas,
)
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
from accl_tpu_torch.constants import DataType
from accl_tpu_torch.ops import compression as port
from accl_tpu_torch.ops import quant_kernels

F32 = np.float32
QROW = DEFAULT_ARITH_CONFIG[(DataType.float32, DataType.int8)]


def _bits_equal(a, b) -> bool:
    """Bitwise equality; a NaN matches any NaN at the same place."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != np.float32:
        return bool(np.array_equal(a, b))
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan].view(np.uint32),
                                   b[~nan].view(np.uint32)))


def _payload(rows, n, seed, case="normal"):
    """Rows of fp32 with the edge blocks of tests/test_compression.py and
    the non-finite and subnormal ones this port adds."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 3).astype(F32)
    if case == "zero":
        x[:, :256] = 0.0
    elif case == "negative_rail":
        m = min(n, 256)
        x[:, :m] = np.linspace(-8.0, 3.0, 256, dtype=F32)[:m]
    elif case == "subnormal":
        x[:, :256] = F32(1e-39)
        x[-1, :256] = F32(1e-45)
    elif case == "subnormal_in_normal_block":
        # amax high enough that the scale is normal (1.5e-36/127 > FLT_MIN)
        # while the other elements are subnormal: DAZ decides their codes
        x[:, :256] = F32(1e-38)
        x[:, 1::3] = F32(-6e-39)
        x[:, 0] = F32(1.5e-36)
    elif case == "nan":
        x[:, min(n, 256) // 2] = np.nan
    elif case == "inf":
        x[0, 0] = np.inf
        x[-1, n - 1] = -np.inf
    return x


CASES = ["normal", "zero", "negative_rail", "subnormal",
         "subnormal_in_normal_block", "nan", "inf"]
SHAPES = [(1, 1), (3, 255), (2, 257), (1, 1000)]


def _per_row(fn, *arrays):
    """Run a 1-D reference function on each row and stack the results."""
    outs = [fn(*(jnp.asarray(a[r]) for a in arrays))
            for r in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def _encoded(rows, n, seed, case):
    """(codes, scales) as the reference encodes the payload, plus a local
    operand with subnormals, signed zeros and (for "nan") a NaN."""
    x = _payload(rows, n, seed, case)
    q, s = _per_row(jax.jit(ref._quantize_impl), x)
    local = _payload(rows, n, seed + 1, "normal")
    local[:, :: 7] = F32(-1e-39)
    local[:, 3:: 11] = F32(-0.0)
    if case == "nan":
        local[0, n // 2] = np.nan
    return q, s, local


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rows,n", SHAPES)
def test_quantize_and_dequantize_match_jitted_reference(rows, n, case):
    x = _payload(rows, n, seed=rows * 1000 + n, case=case)
    q, s = port.quantize_blockwise(torch.from_numpy(x))
    rq, rs = _per_row(jax.jit(ref._quantize_impl), x)
    assert _bits_equal(q.numpy(), rq) and _bits_equal(s.numpy(), rs)
    assert q.shape == (rows, n) and s.shape == (rows, -(-n // 256))
    dq = port.dequantize_blockwise(q, s, n)
    rdq = _per_row(jax.jit(lambda a, b: ref._dequantize_impl(a, b, n)), rq, rs)
    assert _bits_equal(dq.numpy(), rdq)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("case", ["normal", "subnormal", "nan", "inf"])
@pytest.mark.parametrize("rows,n", [(3, 255), (2, 1000)])
def test_fused_steps_match_jitted_reference(rows, n, case, op):
    """The SUM step is bitwise only against the jitted reference: XLA
    contracts its decode multiply and combine add into one fused
    multiply-add, which is the port's contract too."""
    q, s, local = _encoded(rows, n, seed=n + len(case), case=case)
    qt, st, lt = map(torch.from_numpy, (q, s, local))
    got = port.dequant_combine(qt, st, lt, op)
    want = _per_row(jax.jit(lambda a, b, c: ref._dequant_combine_impl(
        a, b, c, op)), q, s, local)
    assert _bits_equal(got.numpy(), want)
    gq, gs = port.dequant_combine_requant(qt, st, lt, op)
    wq, ws = _per_row(jax.jit(lambda a, b, c: ref.dequant_combine_requant(
        a, b, c, op)), q, s, local)
    assert _bits_equal(gq.numpy(), wq) and _bits_equal(gs.numpy(), ws)


def test_fma_is_rounded_once_where_float64_rounds_twice():
    """q*s + local with q*s = 64 + 2^-24 and local = 2^30: the exact sum
    lies just above the float32 midpoint 2^30 + 64, so one rounding gives
    2^30 + 128, while the float64 sum rounds to the midpoint first and
    ties to 2^30. The plain version rounds to odd at 53 bits and gets the
    single rounding, as the jitted reference's fused multiply-add does."""
    s = F32(16519105 * 2.0 ** -24)  # 65 * s == (2^30 + 1) * 2^-24
    q = np.zeros((1, 4), np.int8)
    q[0, :2] = (65, -65)
    local = np.array([[2.0 ** 30, -2.0 ** 30, 1.0, 0.0]], F32)
    scales = np.array([[s]], F32)
    got = port.dequant_combine(torch.from_numpy(q), torch.from_numpy(scales),
                               torch.from_numpy(local), "sum").numpy()
    assert got[0, 0] == F32(2.0 ** 30 + 128) and got[0, 1] == -got[0, 0]
    naive = (q.astype(np.float64) * np.float64(s) + local).astype(F32)
    assert naive[0, 0] == F32(2.0 ** 30)  # the double rounding it avoids
    want = jax.jit(lambda a, b, c: ref._dequant_combine_impl(a, b, c, "sum"))(
        jnp.asarray(q[0]), jnp.asarray(scales[0]), jnp.asarray(local[0]))
    assert _bits_equal(got[0], np.asarray(want))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_scales_and_operands(op):
    """Scales of 0, NaN, Inf and subnormal, signed-zero ties under MAX and
    a sum that lands in the subnormal range (flushed to signed zero)."""
    n = 8 * 256
    rng = np.random.default_rng(11)
    q = rng.integers(-127, 128, (1, n), dtype=np.int8)
    q[0, 256:512] = 0
    scales = np.array([[0.0, F32(1.0), np.nan, np.inf, F32(1e-40),
                        F32(1.2e-38), -1.0, F32(3e-3)]], F32)
    local = (rng.standard_normal((1, n))).astype(F32)
    local[0, 256:512:2] = F32(-0.0)
    local[0, 257:512:2] = F32(-1e-39)
    local[0, 5 * 256:6 * 256] = -(q[0, 5 * 256:6 * 256].astype(np.float64)
                                  * 1.2e-38 * 0.999).astype(F32)
    args = list(map(torch.from_numpy, (q, scales, local)))
    want = jax.jit(lambda a, b, c: ref._dequant_combine_impl(a, b, c, op))(
        *(jnp.asarray(a[0]) for a in (q, scales, local)))
    assert _bits_equal(port.dequant_combine(*args, op)[0].numpy(),
                       np.asarray(want))
    wq, ws = jax.jit(lambda a, b, c: ref.dequant_combine_requant(a, b, c, op))(
        *(jnp.asarray(a[0]) for a in (q, scales, local)))
    gq, gs = port.dequant_combine_requant(*args, op)
    assert _bits_equal(gq[0].numpy(), np.asarray(wq))
    assert _bits_equal(gs[0].numpy(), np.asarray(ws))


def test_non_finite_and_subnormal_blocks_encode_as_the_reference_states():
    x = np.ones((1, 768), F32)
    x[0, 3] = np.nan
    x[0, 300] = np.inf
    x[0, 512:] = F32(1e-39)
    q, s = port.quantize_blockwise(torch.from_numpy(x))
    assert (q[0] == 0).all()
    assert torch.isnan(s[0, 0]) and s[0, 1] == torch.inf and s[0, 2] == 0
    dq = port.dequantize_blockwise(q, s, 768)
    assert torch.isnan(dq[0, :512]).all() and (dq[0, 512:] == 0).all()


def test_against_pallas_kernels_in_interpret_mode():
    """The Pallas kernels (interpret mode, jitted) contract the SUM decode
    and combine into a fused multiply-add like the jitted jnp functions,
    so all four agree bitwise with the plain versions."""
    n = 256 * 5 + 31
    x = _payload(1, n, seed=21, case="nan")[0]
    x[:256] = np.linspace(-8.0, 3.0, 256, dtype=F32)
    local = _payload(1, n, seed=22)[0]
    pq, ps = quantize_pallas(jnp.asarray(x), interpret=True)
    q, s = port.quantize_blockwise(torch.from_numpy(x))
    assert _bits_equal(q.numpy(), pq) and _bits_equal(s.numpy(), ps)
    pdq = dequantize_pallas(pq, ps, n, interpret=True)
    assert _bits_equal(port.dequantize_blockwise(q, s, n).numpy(), pdq)
    lt = torch.from_numpy(local)
    for op in ("sum", "max"):
        pout = fused_dequant_combine_pallas(pq, ps, jnp.asarray(local), op=op,
                                            interpret=True)
        assert _bits_equal(port.dequant_combine(q, s, lt, op).numpy(), pout)
        rq, rs = fused_dequant_combine_quant_pallas(
            pq, ps, jnp.asarray(local), op=op, interpret=True)
        gq, gs = port.dequant_combine_requant(q, s, lt, op)
        assert _bits_equal(gq.numpy(), rq) and _bits_equal(gs.numpy(), rs)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_against_eager_reference_within_its_tolerance(op):
    """Eagerly the reference rounds the SUM decode and combine in two
    steps; the port's single rounding is held to the reference's own
    tolerance for that split (tests/test_compression.py): ULP-close
    values, codes at most one step apart. MAX and the encode rule are
    exact either way."""
    rng = np.random.default_rng(4)
    n = 256 * 7 + 31
    x = rng.standard_normal(n).astype(F32)
    local = rng.standard_normal(n).astype(F32)
    rq, rs = ref.quantize_blockwise(jnp.asarray(x))
    q, s = port.quantize_blockwise(torch.from_numpy(x))
    assert _bits_equal(q.numpy(), rq) and _bits_equal(s.numpy(), rs)
    want = np.asarray(ref.dequant_combine(rq, rs, jnp.asarray(local), op))
    got = port.dequant_combine(q, s, torch.from_numpy(local), op).numpy()
    if op == "max":
        assert _bits_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    wq, ws = ref.dequant_combine_requant(rq, rs, jnp.asarray(local), op)
    gq, gs = port.dequant_combine_requant(q, s, torch.from_numpy(local), op)
    assert np.abs(gq.numpy().astype(np.int32)
                  - np.asarray(wq).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 255, 256, 1000])
def test_pack_and_unpack_wire_bitwise(n):
    x = _payload(3, n, seed=n, case="nan")
    q, s = port.quantize_blockwise(torch.from_numpy(x))
    packed = port.pack_wire(q, s)
    want = _per_row(ref.pack_wire, q.numpy(), s.numpy())
    assert packed.dtype == torch.int8 and _bits_equal(packed.numpy(), want)
    assert packed.shape == (3, n + 4 * -(-n // 256))
    uq, us = port.unpack_wire(packed, n)
    assert torch.equal(uq, q) and _bits_equal(us.numpy(), s.numpy())
    rq, rs = ref.unpack_wire(jnp.asarray(want[1]), n)
    assert _bits_equal(uq[1].numpy(), rq) and _bits_equal(us[1].numpy(), rs)


def test_cast_entry_points_refuse_the_quantized_row():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="encode/hop/decode"):
        port.compress(x, QROW)
    with pytest.raises(ValueError, match="encode/hop/decode"):
        port.decompress(x, QROW, torch.float32)
    assert port.wire_dtype(QROW) == torch.int8 and port.is_quantized(QROW)


def test_wrappers_take_the_plain_version_only_on_cpu():
    x = torch.from_numpy(_payload(2, 300, seed=5))
    before = [f.launches for f in (quant_kernels.quantize,
                                   quant_kernels.dequantize,
                                   quant_kernels.dequant_combine,
                                   quant_kernels.dequant_combine_requant)]
    q, s = quant_kernels.quantize(x)
    quant_kernels.dequantize(q, s)
    quant_kernels.dequant_combine(q, s, x, "sum")
    quant_kernels.dequant_combine_requant(q, s, x, "max")
    after = [f.launches for f in (quant_kernels.quantize,
                                  quant_kernels.dequantize,
                                  quant_kernels.dequant_combine,
                                  quant_kernels.dequant_combine_requant)]
    assert after == before  # the plain version is no launch
    with pytest.raises(ValueError, match="unsupported"):
        quant_kernels.dequant_combine(q, s, x, "min")
    with pytest.raises(ValueError, match="devices"):
        quant_kernels.dequant_combine(q, s, x.to("meta"), "sum")
