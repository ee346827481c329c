"""Core types of the PyTorch port against the JAX package: enums, register
map, arithmetic table, error bits, descriptor words, exchange-memory
image and the reduce/cast lanes — all equal to the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.arithconfig as ref_arith
import accl_tpu.communicator as ref_comm
import accl_tpu.constants as ref_c
import accl_tpu.descriptor as ref_desc
import accl_tpu.device.base as ref_base
import accl_tpu.ops.compression as ref_comp
import accl_tpu.ops.reduce_ops as ref_reduce
import accl_tpu_torch.arithconfig as port_arith
import accl_tpu_torch.communicator as port_comm
import accl_tpu_torch.constants as port_c
import accl_tpu_torch.descriptor as port_desc
import accl_tpu_torch.device.base as port_base
import accl_tpu_torch.ops.compression as port_comp
import accl_tpu_torch.ops.reduce_ops as port_reduce
from accl_tpu_torch.interop import load_exchange_memory, tensor_from_numpy

ENUMS = ["Operation", "CfgFunc", "ReduceFunction", "OperationStatus",
         "DataType", "StreamFlags", "HostFlags", "CompressionFlags",
         "Transport", "ErrorCode"]

SCALARS = ["TAG_ANY", "DEFAULT_NUM_EAGER_RX_BUFS", "DEFAULT_EAGER_RX_BUF_SIZE",
           "DEFAULT_MAX_EAGER_SIZE", "DEFAULT_MAX_RENDEZVOUS_SIZE",
           "DMA_MAX_BTT", "MAX_SEG_SIZE", "LOGP_ALLREDUCE_HOP_BYTES",
           "LOGP_ALLGATHER_HOP_BYTES", "STREAM_SEG_BYTES",
           "QUANT_BLOCK_ELEMS", "QUANT_SCALE_BYTES", "QUANT_QMAX",
           "QUANT_INV_QMAX", "EXCHMEM_SIZE", "ERROR_CODE_BITS"]


def _members(enum_cls):
    return {m.name: int(m.value) for m in enum_cls.__members__.values()}


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_and_values(name):
    assert _members(getattr(port_c, name)) == _members(getattr(ref_c, name))


def test_scalar_constants_and_dtype_widths():
    for name in SCALARS:
        assert getattr(port_c, name) == getattr(ref_c, name), name
    assert ({int(k): v for k, v in port_c.DATATYPE_BITS.items()}
            == {int(k): v for k, v in ref_c.DATATYPE_BITS.items()})
    for w in range(1, 17):
        assert port_c.logp_allreduce_max_bytes(w) == ref_c.logp_allreduce_max_bytes(w)
        assert port_c.logp_allgather_max_bytes(w) == ref_c.logp_allgather_max_bytes(w)


def test_tuning_params_defaults():
    for rndzv in (32 * 1024, 4096, 1 << 20):
        assert (vars(port_c.TuningParams.default(rndzv))
                == vars(ref_c.TuningParams.default(rndzv)))
    assert vars(port_c.TuningParams()) == vars(ref_c.TuningParams())


def test_dtype_bridge_round_trips():
    for dt in port_c.DataType:
        if dt == port_c.DataType.none:
            continue
        tdt = port_c.to_torch_dtype(dt)
        assert port_c.from_torch_dtype(tdt) == dt
        assert tdt.itemsize == ref_c.to_numpy_dtype(ref_c.DataType(int(dt))).itemsize


def test_register_map():
    regs = {k: v for k, v in vars(ref_base.CCLOAddr).items() if k.isupper()}
    port_regs = {k: v for k, v in vars(port_base.CCLOAddr).items() if k.isupper()}
    assert port_regs == regs
    assert port_base.ACCL_TPU_IDCODE == ref_base.ACCL_TPU_IDCODE


def test_arith_table_rows():
    def rows(table):
        return {(int(u), int(c)): (r.exchmem_words(), r.arith_lanes)
                for (u, c), r in table.items()}

    assert rows(port_arith.DEFAULT_ARITH_CONFIG) == rows(ref_arith.DEFAULT_ARITH_CONFIG)
    assert port_arith.QUANT_COMPRESSOR_LANE == ref_arith.QUANT_COMPRESSOR_LANE
    assert port_arith.QUANT_DECOMPRESSOR_LANE == ref_arith.QUANT_DECOMPRESSOR_LANE
    assert port_arith.ArithConfig.WORDS_PER_ROW == ref_arith.ArithConfig.WORDS_PER_ROW


def test_error_code_bits_and_decoding():
    rng = np.random.default_rng(11)
    words = [0, 1 << 26, (1 << 27) - 1, 1 << 30] + [
        int(w) for w in rng.integers(0, 1 << 27, 20)]
    for w in words:
        assert port_c.error_code_to_string(w) == ref_c.error_code_to_string(w)
    assert str(port_c.ACCLError("allreduce", 5)) == str(ref_c.ACCLError("allreduce", 5))


def _descriptor_kwargs():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(12):
        out.append(dict(
            scenario=int(rng.choice([0, 1, 3, 5, 8, 10, 11, 13, 255])),
            count=int(rng.integers(0, 1 << 31)),
            comm_addr=int(rng.integers(0, 8192)),
            root_src_dst=int(rng.integers(0, 1 << 20)),
            function=int(rng.integers(0, 2)),
            tag=int(rng.integers(0, 1 << 32)),
            arithcfg_addr=int(rng.integers(0, 8192)),
            compression_flags=int(rng.integers(0, 16)),
            stream_flags=int(rng.integers(0, 4)),
            host_flags=int(rng.integers(0, 8)),
            op0_stream_id=int(rng.integers(0, 256)),
            res_stream_id=int(rng.integers(0, 256)),
            addr_0=int(rng.integers(0, 1 << 63)),
            addr_1=int(rng.integers(0, 1 << 40)),
            addr_2=int(rng.integers(0, 1 << 63)),
            data_type=int(rng.integers(0, 8)),
            compress_dtype=int(rng.integers(0, 8)),
        ))
    return out


def _build(mod_desc, mod_c, kw):
    kw = dict(kw)
    kw["scenario"] = mod_c.Operation(kw["scenario"])
    kw["compression_flags"] = mod_c.CompressionFlags(kw["compression_flags"])
    kw["stream_flags"] = mod_c.StreamFlags(kw["stream_flags"])
    kw["host_flags"] = mod_c.HostFlags(kw["host_flags"])
    kw["data_type"] = mod_c.DataType(kw["data_type"])
    kw["compress_dtype"] = mod_c.DataType(kw["compress_dtype"])
    return mod_desc.CallOptions(**kw)


@pytest.mark.parametrize("kw", _descriptor_kwargs())
def test_descriptor_words_and_signature(kw):
    port = _build(port_desc, port_c, kw)
    ref = _build(ref_desc, ref_c, kw)
    words = port.to_words()
    assert len(words) == port_desc.DESCRIPTOR_WORDS == ref_desc.DESCRIPTOR_WORDS
    assert words == ref.to_words()
    back = port_desc.CallOptions.from_words(words)
    assert back.to_words() == words
    assert ([int(v) if not isinstance(v, tuple) else v for v in port.signature()]
            == [int(v) if not isinstance(v, tuple) else v for v in ref.signature()])


def test_communicator_words():
    ranks_ref = ref_comm.generate_ranks(5)
    ranks_port = [port_comm.Rank(ip=r.ip, port=r.port, session_id=r.session_id,
                                 device_index=r.device_index) for r in ranks_ref]
    ref = ref_comm.Communicator(ranks_ref, 2, 0x200)
    port = port_comm.Communicator(ranks_port, 2, 0x200)
    assert port.exchmem_words() == ref.exchmem_words()
    back = port_comm.Communicator.from_exchmem_words(ref.exchmem_words(), 0x200)
    assert back.exchmem_words() == ref.exchmem_words()
    assert back.dump() == ref.dump()


def _image(dev):
    # PERFCNT holds the last config call's measured duration: not a
    # property of the image
    return {a: w for a, w in dev._exchmem.items()
            if a != ref_base.CCLOAddr.PERFCNT}


@pytest.mark.parametrize("world", [4, 8])
def test_exchange_memory_image_after_initialize(world, mesh8, mesh4):
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu_torch import ACCL

    ref = RefACCL(mesh8 if world == 8 else mesh4)
    port = ACCL(world=world, torch_device="cpu")
    assert _image(port.cclo) == _image(ref.cclo)
    assert len(_image(port.cclo)) > 50


def test_tuning_after_loading_the_reference_image(mesh8):
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu_torch import ACCL

    ref = RefACCL(mesh8)
    ref.configure_tuning_parameters(ref_c.TuningParams(
        gather_flat_tree_max_fanin=3, gather_flat_tree_max_count=12345,
        bcast_flat_tree_max_ranks=5, reduce_flat_tree_max_ranks=6,
        reduce_flat_tree_max_count=777, allreduce_composition_max_count=99,
        synth_allreduce_max_count=11, synth_allgather_max_count=12,
        synth_reduce_scatter_max_count=13, hier_allreduce_min_count=14,
        alltoall_compress_min_count=15, overlap_min_count=16,
        synth_latency_max_count=17))
    port = ACCL(world=8, torch_device="cpu")
    load_exchange_memory(port.cclo, dict(ref.cclo._exchmem))
    assert vars(port.cclo.tuning()) == vars(ref.cclo.tuning())
    assert port.cclo._exchmem == ref.cclo._exchmem
    # the communicator table and the arith rows read back identically
    w = 8
    words = [port.cclo.read(0x200 + 4 * i) for i in range(2 + 7 * w)]
    assert (port_comm.Communicator.from_exchmem_words(words).exchmem_words()
            == ref.communicators[0].exchmem_words())
    for key, row in ref.arith_config.items():
        addr = row.addr()
        got = [port.cclo.read(addr + 4 * i) for i in range(8)]
        assert got == row.exchmem_words()


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.itemsize])


def assert_same_bits(got: torch.Tensor, ref: torch.Tensor):
    """Bitwise equality, with any NaN matching any NaN at the same place."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.is_floating_point():
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(ref))
        assert torch.equal(_bits(got[~nan]), _bits(ref[~nan]))
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("lane", range(12))
def test_reduce_lanes_bitwise(lane):
    dtype, op = ref_reduce._LANE_DTYPES[lane]
    dt = np.dtype(dtype)
    rng = np.random.default_rng(100 + lane)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, 777, dtype=dt)
        b = rng.integers(info.min, info.max, 777, dtype=dt)
    else:
        a = rng.standard_normal(777).astype(dt)
        b = rng.standard_normal(777).astype(dt)
        a[5] = np.nan  # MAX must propagate NaN like jnp.maximum
    ref = np.asarray(ref_reduce.reduce_lane(lane, jnp.asarray(a), jnp.asarray(b)))
    got = port_reduce.reduce_lane(lane, tensor_from_numpy(a), tensor_from_numpy(b))
    assert_same_bits(got, tensor_from_numpy(ref))


@pytest.mark.parametrize("pair", [(3, 2), (3, 7)])
def test_cast_lanes_bitwise(pair):
    rcfg = ref_arith.DEFAULT_ARITH_CONFIG[tuple(ref_c.DataType(p) for p in pair)]
    pcfg = port_arith.DEFAULT_ARITH_CONFIG[tuple(port_c.DataType(p) for p in pair)]
    x = np.random.default_rng(5).standard_normal(1000).astype(np.float32) * 100
    ref = np.asarray(ref_comp.compress(jnp.asarray(x), rcfg))
    got = port_comp.compress(torch.from_numpy(x), pcfg)
    assert got.dtype == port_c.to_torch_dtype(port_c.DataType(pair[1]))
    assert torch.equal(got.view(torch.int16), tensor_from_numpy(ref).view(torch.int16))
    back = port_comp.decompress(got, pcfg, torch.float32)
    ref_back = np.asarray(ref_comp.decompress(jnp.asarray(ref), rcfg, jnp.float32))
    assert torch.equal(back, tensor_from_numpy(ref_back))


def test_quantized_row_is_recognized_and_refused():
    cfg = port_arith.DEFAULT_ARITH_CONFIG[(port_c.DataType.float32,
                                           port_c.DataType.int8)]
    assert port_comp.is_quantized(cfg)
    # the cast entry points refuse the (codes, scales) lanes, as the
    # reference's do: quantized hops go through Wire.encode/hop/decode
    with pytest.raises(ValueError, match="quantized"):
        port_comp.compress(torch.zeros(4), cfg)
    with pytest.raises(ValueError, match="quantized"):
        port_comp.decompress(torch.zeros(4), cfg, torch.float32)
