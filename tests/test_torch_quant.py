"""The port's blockwise int8 lanes against the JAX package's, on the same
numpy inputs: the plain versions of the four quantized kernels bitwise
against the jitted jnp functions (what the reference facade runs: its
ring is jitted under shard_map) and against the Pallas kernels in
interpret mode, the eager jnp functions within the reference's own
tolerance, the edge cases of tests/test_compression.py plus NaN, Inf and
subnormal blocks, the packed wire bytes, the wire message entries of the
quantize and dequantize kernels, and their launch choice (fold, vector
or scalar instantiation). The CUDA kernels are held against these plain
versions on the card by chip_smoke.py."""

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
    wrappers = (quant_kernels.quantize, quant_kernels.dequantize,
                quant_kernels.dequant_combine,
                quant_kernels.dequant_combine_requant)
    before = [(f.launches, dict(f.shapes)) for f in wrappers]
    q, s = quant_kernels.quantize(x)
    quant_kernels.dequantize(q, s)
    quant_kernels.dequant_combine(q, s, x, "sum")
    quant_kernels.dequant_combine_requant(q, s, x, "max")
    quant_kernels.dequantize_packed(quant_kernels.quantize_packed(x), 300)
    after = [(f.launches, dict(f.shapes)) for f in wrappers]
    assert after == before  # the plain version is no launch
    with pytest.raises(ValueError, match="unsupported"):
        quant_kernels.dequant_combine(q, s, x, "min")
    with pytest.raises(ValueError, match="devices"):
        quant_kernels.dequant_combine(q, s, x.to("meta"), "sum")


# -- the wire message entries of kernels 5 and 6 ------------------------------

SPECIAL_BLOCKS = ("zero", "signed_zeros", "subnormal", "nan", "inf", "rail",
                  "normal")


def _special_payload(rows, n, seed):
    """fp32 rows whose 256-element blocks take the special kinds in turn
    (block b of row r: SPECIAL_BLOCKS[(r + b) % 7]), so that every kind
    appears even where a row has one block: all-zero, +-0 (a block of
    zeros alone, or -0 beside values), 1e-39 (flushed), NaN, +-Inf, the
    +-127 rail."""
    x = _payload(rows, n, seed)
    for r in range(rows):
        for b in range(-(-n // 256)):
            blk = x[r, 256 * b:256 * (b + 1)]
            kind = SPECIAL_BLOCKS[(r + b) % len(SPECIAL_BLOCKS)]
            if kind == "zero":
                blk[:] = 0.0
            elif kind == "signed_zeros":
                blk[::2] = F32(-0.0)
                if r % 2:
                    blk[1::2] = 0.0
            elif kind == "subnormal":
                blk[:] = F32(1e-39)
                blk[1::3] = F32(-1e-39)
            elif kind == "nan":
                blk[len(blk) // 2] = np.nan
            elif kind == "inf":
                blk[0] = np.inf if r % 2 else -np.inf
            elif kind == "rail":
                blk[:] = (np.linspace(-127.0, 127.0, 256) / 64)[:len(blk)]
    return x


def _messages_equal(a, b, n) -> bool:
    """Wire messages bitwise: the codes byte for byte, the scale bytes as
    fp32 with a NaN matching any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    nb = -(-n // 256)
    return (a.shape == b.shape and _bits_equal(a[:, :n], b[:, :n])
            and _bits_equal(a[:, n:n + 4 * nb].copy().view(F32),
                            b[:, n:n + 4 * nb].copy().view(F32)))


@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 1000, 4099])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_packed_entries_match_jitted_reference(rows, n):
    """quantize_packed is the reference's jitted pack_wire(*quantize_
    blockwise(x)) and dequantize_packed its dequantize_blockwise(*unpack_
    wire(msg, n), n), bitwise, on blocks of every special kind."""
    x = _special_payload(rows, n, seed=rows * 7919 + n)
    msg = quant_kernels.quantize_packed(torch.from_numpy(x))
    want = _per_row(jax.jit(lambda v: ref.pack_wire(
        *ref.quantize_blockwise(v))), x)
    assert msg.dtype == torch.int8 and msg.shape == (rows, n + 4 * -(-n // 256))
    assert _messages_equal(msg.numpy(), want, n)
    got = quant_kernels.dequantize_packed(msg, n)
    rdq = _per_row(jax.jit(lambda m: ref.dequantize_blockwise(
        *ref.unpack_wire(m, n), n)), want)
    assert got.dtype == torch.float32 and _bits_equal(got.numpy(), rdq)
    q, s = port.unpack_wire(msg, n)
    assert _bits_equal(got.numpy(), quant_kernels.dequantize(q, s).numpy())


def test_dequantize_packed_reads_a_wider_message_view():
    """A message row may be a view of a wider buffer: only its first
    n + 4*nb bytes are read."""
    n = 1000
    x = torch.from_numpy(_special_payload(3, n, seed=3))
    msg = quant_kernels.quantize_packed(x)
    wide = torch.full((3, msg.shape[1] + 9), 77, dtype=torch.int8)
    wide[:, 2:2 + msg.shape[1]] = msg
    got = quant_kernels.dequantize_packed(wide[:, 2:], n)
    assert _bits_equal(got.numpy(), quant_kernels.dequantize_packed(
        msg, n).numpy())


def _launch(f, q, s_off, ld_s):
    """quant_launch over views, the scale bytes s_off bytes into q."""
    return quant_kernels.quant_launch(f, q, q.data_ptr() + s_off, ld_s)


@pytest.mark.parametrize("layout,want", [
    # rows back to back, n a multiple of 256: one row, vector
    ("contiguous 8x1024", (1, 8192, 8192, 8192, 128, True)),
    # n not a multiple of 256: the blocking restarts each row, no fold
    ("contiguous 8x1000", (8, 1000, 1000, 1000, 16, True)),
    # the wire message: codes and scales interleave by row, no fold
    ("message 8x1024", (8, 1024, 1024, 1040, 1040, True)),
    # n % 4 != 0: a ragged block of no whole float4s, scalar
    ("contiguous 5x1003", (5, 1003, 1003, 1003, 16, False)),
    ("message 5x1003", (5, 1003, 1003, 1019, 1019, False)),
    # a column view at an odd offset: fp32 base 12 bytes off 16, scalar
    ("odd view 4x1000", (4, 1000, 1007, 1000, 16, False)),
    # an aligned column view whose rows are 16-byte multiples: vector
    ("aligned view 4x1000", (4, 1000, 1032, 1000, 16, True)),
    # a fp32 row stride off 16 bytes: scalar with rows, vector alone
    ("stride 4x1000", (4, 1000, 1001, 1000, 16, False)),
    ("stride 1x1000", (1, 1000, 1001, 1000, 16, True)),
    # a code base 1 byte off 4: scalar
    ("code view 4x1000", (4, 1000, 1000, 1001, 16, False)),
])
def test_quant_launch_choice(layout, want):
    """The Python-side choice of kernel 5's and 6's launch: fold or not,
    vector or scalar, from shapes, strides and base addresses alone (CPU
    allocations are 64-byte aligned)."""
    kind, shape = layout.rsplit(" ", 1)
    rows, n = map(int, shape.split("x"))
    nb = -(-n // 256)
    f = torch.zeros((rows, n), dtype=torch.float32)
    q = torch.zeros((rows, n), dtype=torch.int8)
    s_off, ld_s = None, 4 * nb
    if kind == "message":
        q = torch.zeros((rows, n + 4 * nb), dtype=torch.int8)
        s_off, ld_s = n, n + 4 * nb
    elif kind == "odd view":
        f = torch.zeros((rows, n + 7), dtype=torch.float32)[:, 3:3 + n]
    elif kind == "aligned view":
        f = torch.zeros((rows, n + 32), dtype=torch.float32)[:, 16:16 + n]
    elif kind == "stride":
        f = torch.zeros((rows, n + 1), dtype=torch.float32)[:, :n]
    elif kind == "code view":
        q = torch.zeros((rows, n + 1), dtype=torch.int8)[:, 1:]
    assert f.data_ptr() % 64 == 0 or kind in ("odd view", "aligned view")
    if s_off is None:
        scales = torch.zeros((rows, nb), dtype=torch.float32)
        got = quant_kernels.quant_launch(f, q, scales.data_ptr(), ld_s)
    else:
        got = _launch(f, q, s_off, ld_s)
    assert got == want
