"""ACCL.autotune on the port against the JAX facade's: the same
registers and tier wires from the shipped timing model (flat worlds and
declared two-tier topologies, on the exact and int8 wires), then calls
across every window it opens bitwise on the same numpy inputs (the
latency-grid and standard synthesized entries, the stripe-overlapped
allreduce, the two-tier composition, a tiered entry), a recorded
sequence holding SYNTHESIZED and HIER steps fused == eager == the
reference's, and the predicted cost of a prepared batch."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import accl_tpu.constants as ref_c
from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.device.tpu_device import TPUDevice
from accl_tpu.sequencer.timing import LinkParams as RefLink
from accl_tpu_torch import ACCL, DataType, ReduceFunction
from accl_tpu_torch.device.gpu_device import GPUDevice
from accl_tpu_torch.sequencer.plan import Algorithm
from accl_tpu_torch.sequencer.timing import LinkParams


def _pair(world, topo):
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref = RefACCL(device=TPUDevice(mesh, hier_topology=topo))
    port = ACCL(device=GPUDevice(world, "cpu", hier_topology=topo))
    return ref, port


@pytest.fixture(scope="module")
def tuned():
    """Facades autotuned from the shipped model, by topology, W = 8."""
    out = {}
    for topo in (None, (4, 2), (2, 4)):
        ref, port = _pair(8, topo)
        ref.autotune()
        port.autotune()
        out[topo] = ref, port
    return out


@pytest.mark.parametrize("world,topo", [(4, None), (8, None), (8, (4, 2)),
                                        (8, (2, 4)), (4, (2, 2))])
def test_autotune_registers_and_tier_wires(world, topo):
    ref, port = _pair(world, topo)
    for kw, pkw in ((dict(), dict()),
                    (dict(wire_dtype=ref_c.DataType.int8),
                     dict(wire_dtype=DataType.int8)),
                    (dict(link=RefLink(2e-6, 4e11)),
                     dict(link=LinkParams(2e-6, 4e11)))):
        want = ref.autotune(**kw)
        got = port.autotune(**pkw)
        assert vars(got) == vars(want)
        assert vars(port.cclo.tuning()) == vars(ref.cclo.tuning())
        assert [int(w) for w in port.cclo.hier_wires] == \
            [int(w) for w in ref.cclo.hier_wires]
    if topo is not None and world == 8:
        assert port.cclo.hier_wires == (DataType.int8, DataType.int8)


def test_autotune_tiers():
    port = ACCL(world=4, torch_device="cpu")
    with pytest.raises(ValueError, match="tpu_tier"):
        port.autotune(tier="tpu")
    with pytest.raises(ValueError, match="unknown autotune tier"):
        port.autotune(tier="gpu")
    with pytest.raises(ValueError, match="not both"):
        port.autotune(link=LinkParams(1e-6, 1e9), tier="tpu")


# (topology, op, count, expected algorithm, expected entry key or "")
CALLS = [
    (None, "allreduce", 256, "SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat"),
    (None, "allreduce", 4000, "SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat"),
    (None, "allreduce", 16384, "EAGER_RING_RS_AG", ""),  # 4 overlap stripes
    (None, "allreduce", 262144, "SYNTHESIZED", "allreduce_w8_rs_ag_d1_2_4"),
    (None, "allreduce", 300001, "SYNTHESIZED", "allreduce_w8_rs_ag_d1_2_4"),
    (None, "allgather", 65536, "SYNTHESIZED", "allgather_w8_doubling_d1_2_4"),
    (None, "reduce_scatter", 1000, "SYNTHESIZED",
     "reduce_scatter_w8_halving_d1_2_4"),
    ((4, 2), "allreduce", 4000, "HIER_RS_AR_AG", ""),
    ((4, 2), "allreduce", 300001, "HIER_RS_AR_AG", ""),
    ((2, 4), "allreduce", 40000, "SYNTHESIZED",
     "allreduce_w8_t2x4_lg_exchange_d1_o1_2"),
    ((2, 4), "allreduce", 262144, "HIER_RS_AR_AG", ""),
]


@pytest.mark.parametrize("topo,op,count,alg,key", CALLS)
def test_tuned_calls_bitwise(tuned, topo, op, count, alg, key):
    ref, port = tuned[topo]
    rng = np.random.default_rng(count)
    width_in = count * (8 if op == "reduce_scatter" else 1)
    width_out = count * (8 if op == "allgather" else 1)
    x = rng.standard_normal((8, width_in)).astype(np.float32)
    rsb = ref.create_buffer(width_in, np.float32, data=x)
    rrb = ref.create_buffer(width_out, np.float32)
    psb = port.create_buffer(width_in, torch.float32, data=x)
    prb = port.create_buffer(width_out, torch.float32)
    if op == "allgather":
        ref.allgather(rsb, rrb, count)
        req = port.allgather(psb, prb, count)
    else:
        getattr(ref, op)(rsb, rrb, count, ref_c.ReduceFunction.SUM)
        req = getattr(port, op)(psb, prb, count, ReduceFunction.SUM)
    assert req.plan.algorithm.name == alg and req.plan.synth_key == key
    if alg == "EAGER_RING_RS_AG":
        assert req.plan.stripes > 1
    assert np.array_equal(prb.host.numpy().view(np.int32),
                          np.asarray(rrb.host).view(np.int32))


def test_tuned_sequence_fused_equals_eager_and_reference(tuned):
    """On the (4, 2) world: a HIER allreduce, a synthesized
    reduce_scatter and an allgather, recorded as one batch, bitwise the
    same calls issued eagerly and the reference's sequence; the batch's
    predicted cost is the reference's."""
    ref, port = tuned[(4, 2)]
    n, c = 4096, 512
    x = np.random.default_rng(42).standard_normal((8, n)).astype(np.float32)

    def bufs(accl, dtype):
        return (accl.create_buffer(n, dtype, data=x),
                accl.create_buffer(n, dtype), accl.create_buffer(c, dtype),
                accl.create_buffer(n, dtype))

    def issue(ops, a, b, cc, d, f):
        ops.allreduce(a, b, n, f.SUM)
        ops.reduce_scatter(b, cc, c, f.SUM)
        ops.allgather(cc, d, c)

    e = bufs(port, torch.float32)
    issue(port, *e, ReduceFunction)
    s = bufs(port, torch.float32)
    rec = port.sequence()
    issue(rec, *s, ReduceFunction)
    prog = rec.compile()
    req = prog.run()
    assert [p.algorithm for p in req.plans] == [
        Algorithm.HIER_RS_AR_AG, Algorithm.SYNTHESIZED,
        Algorithm.RNDZV_RING]
    r = bufs(ref, np.float32)
    rrec = ref.sequence()
    issue(rrec, *r, ref_c.ReduceFunction)
    rprog = rrec.compile()
    rprog.run()
    for got, eager, want in zip(s[1:], e[1:], r[1:]):
        assert torch.equal(got.host, eager.host)
        assert np.array_equal(got.host.numpy().view(np.int32),
                              np.asarray(want.host).view(np.int32))
    assert port.cclo.predict_sequence_cost(prog._prepared) == \
        ref.cclo.predict_sequence_cost(rprog._prepared)
