"""The port's striped two-tier HIER_RS_AR_AG allreduce against the JAX
package's on the same numpy inputs: explicit plans over (2, 4) and
(4, 2), one to three stripes, exact, fp16 and int8 tier wires, through
each side's ScheduleCompiler; and the register-opened facade path of a
device that declares its topology (TPUDevice / GPUDevice
hier_topology=)."""

import numpy as np
import pytest
import torch

import accl_tpu.constants as ref_c
from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.descriptor import CallOptions as RefOptions
from accl_tpu.device.tpu_device import TPUDevice
from accl_tpu.sequencer import hierarchical as ref_hier
from accl_tpu.sequencer import plan as ref_plan
from accl_tpu.sequencer.lowering import ScheduleCompiler as RefCompiler
import accl_tpu_torch.constants as port_c
from accl_tpu_torch import ACCL, ReduceFunction
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device.gpu_device import GPUDevice
from accl_tpu_torch.sequencer import hierarchical
from accl_tpu_torch.sequencer import plan as port_plan
from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

NONE, F16, I8 = "none", "float16", "int8"
CASES = [(topo, s, wires)
         for topo in ((2, 4), (4, 2))
         for wires, stripes in (((NONE, NONE), (1, 2, 3)),
                                ((I8, I8), (1, 2, 3)),
                                ((F16, F16), (2,)),
                                ((NONE, I8), (2,)))
         for s in stripes]


def test_rankmap_is_the_references():
    for L, P in ((2, 4), (4, 2), (4, 4)):
        for order in ("outer_major", "inner_major"):
            mine = hierarchical.RankMap(L, P, order)
            theirs = ref_hier.RankMap(L, P, order)
            for d in (1, 2, 3):
                assert mine.inner_perm(d) == theirs.inner_perm(d)
                assert mine.outer_perm(d) == theirs.outer_perm(d)
            for g in range(L * P):
                assert (mine.inner_pos(g), mine.outer_pos(g)) == \
                    (theirs.inner_pos(g), theirs.outer_pos(g))


@pytest.mark.parametrize("topo,stripes,wires", CASES)
def test_striped_hier_allreduce_bitwise(mesh8, topo, stripes, wires):
    count = 3001  # ragged stripes, chunks off the L padding and int8 blocks
    L, P = topo
    rng = np.random.default_rng(stripes * 10 + L)
    x = (rng.standard_normal((8, count)) * 2).astype(np.float32)
    rplan = ref_plan.Plan(ref_plan.Protocol.EAGER,
                          ref_plan.Algorithm.HIER_RS_AR_AG, count, 1,
                          inner_world=L, outer_world=P, stripes=stripes,
                          inner_wire_dtype=ref_c.DataType[wires[0]],
                          outer_wire_dtype=ref_c.DataType[wires[1]])
    pplan = port_plan.Plan(port_plan.Protocol.EAGER,
                           port_plan.Algorithm.HIER_RS_AR_AG, count, 1,
                           inner_world=L, outer_world=P, stripes=stripes,
                           inner_wire_dtype=port_c.DataType[wires[0]],
                           outer_wire_dtype=port_c.DataType[wires[1]])
    for func in (0, 1) if wires == (NONE, NONE) else (0,):
        ropts = RefOptions(scenario=ref_c.Operation.allreduce, count=count,
                           function=func, data_type=ref_c.DataType.float32)
        popts = CallOptions(scenario=port_c.Operation.allreduce,
                            count=count, function=func,
                            data_type=port_c.DataType.float32)
        want = np.asarray(RefCompiler(mesh8).lower(ropts, rplan)(x))
        got = ScheduleCompiler(8, torch.device("cpu")).lower(
            popts, pplan)(torch.from_numpy(x))
        assert got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), (func, wires)


@pytest.mark.parametrize("topo", [(4, 2), (2, 4)])
def test_hier_window_through_the_facade(mesh8, topo):
    """A device that declares its topology, the hier register open and
    the tier wires set: the facade selects HIER_RS_AR_AG with the cost
    model's stripes on both sides, bitwise; a sub-communicator ignores
    the topology (its world is flat)."""
    from accl_tpu.constants import ReduceFunction as RefF

    regs = dict(hier_allreduce_min_count=1 << 16)
    ref = RefACCL(device=TPUDevice(mesh8, hier_topology=topo))
    ref.configure_tuning_parameters(ref_c.TuningParams(**regs))
    ref.cclo.hier_wires = (ref_c.DataType.none, ref_c.DataType.int8)
    port = ACCL(device=GPUDevice(8, "cpu", hier_topology=topo))
    port.configure_tuning_parameters(port_c.TuningParams(**regs))
    port.cclo.hier_wires = (port_c.DataType.none, port_c.DataType.int8)
    count = 1 << 20
    x = np.random.default_rng(7).standard_normal((8, count)).astype(
        np.float32)
    rsb = ref.create_buffer(count, np.float32, data=x)
    rrb = ref.create_buffer(count, np.float32)
    ref.allreduce(rsb, rrb, count, RefF.SUM)
    psb = port.create_buffer(count, torch.float32, data=x)
    prb = port.create_buffer(count, torch.float32)
    req = port.allreduce(psb, prb, count, ReduceFunction.SUM)
    assert req.plan.algorithm == port_plan.Algorithm.HIER_RS_AR_AG
    assert req.plan.outer_wire_dtype == port_c.DataType.int8
    assert np.array_equal(prb.host.numpy().view(np.int32),
                          np.asarray(rrb.host).view(np.int32))
    group = port.split([0, 2, 4, 6])
    sb, rb = port.create_buffer(count), port.create_buffer(count)
    req = port.allreduce(sb, rb, count, ReduceFunction.SUM, comm=group)
    assert req.plan.algorithm == port_plan.Algorithm.EAGER_RING_RS_AG
