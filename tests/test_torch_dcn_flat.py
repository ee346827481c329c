"""The multi-process DCN form's flat combined world against the stacked
flat bodies.

device/dcn_transport.ProcessWorld runs the flat schedule bodies of
sequencer/schedules.py on one process's rows of a W = P * L world (its
ranks [p*L, p*L + L)), carrying each hop's pairs that leave the process
across LoopbackHub threads (one thread a host). Every branch of
ScheduleCompiler._body that selection reaches on a DCNDevice is built
twice from the same descriptor and plan: by the multi-process compiler
(DCNCompiler with a transport, lower_step) and by a one-card
ScheduleCompiler over all W rows. Each host's rows must equal the same
rows of the stacked body bitwise, on the exact, fp16 (fp32 arithmetic,
and the compressed-domain form of the default table) and int8 wires, at
P x L in {2x1, 3x1, 4x1, 2x2, 2x4}, at an odd count that pads and with a
ragged last segment. The segmented ring allreduce sends one message a
peer a ring step for all its whole segments (plus the ragged tail's) and
its "flat" bytes are sum over segments of 2*(W-1)*ceil(s/W)*4.
"""

import threading

import numpy as np
import pytest
import torch

from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from accl_tpu_torch.constants import CompressionFlags, DataType, Operation
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.device.dcn_device import DCNCompiler
from accl_tpu_torch.device.dcn_transport import LoopbackHub
from accl_tpu_torch.parallel.mesh import Mesh
from accl_tpu_torch.sequencer import synthesis
from accl_tpu_torch.sequencer.lowering import ScheduleCompiler
from accl_tpu_torch.sequencer.plan import Algorithm, Plan, Protocol
from accl_tpu_torch.tools.run_dcn import flat_allreduce_bytes

CPU = torch.device("cpu")
TOPOS = [(2, 1), (3, 1), (4, 1), (2, 2), (2, 4)]
FP32_ARITH = dict(DEFAULT_ARITH_CONFIG)
FP32_ARITH[(DataType.float32, DataType.float16)] = ArithConfig(
    4, 2, 0, 0, 1, False, (0, 5))
# wire name -> (compress dtype, arithmetic table)
WIRES = {"exact": (None, FP32_ARITH), "float16": (DataType.float16,
                                                  FP32_ARITH),
         "float16_domain": (DataType.float16, DEFAULT_ARITH_CONFIG),
         "int8": (DataType.int8, FP32_ARITH)}
N = 331  # odd: the ring pads its chunks, the trees split it unevenly
C = 37  # a rank's chunk of scatter, gather, allgather, reduce_scatter


def _plan(alg, count, proto=Protocol.EAGER, **kw):
    return Plan(proto, alg, count, 1, **kw)


def _ar_plan(count, seg, W):
    seg -= seg % W
    return Plan(Protocol.EAGER, Algorithm.EAGER_RING_RS_AG, seg,
                -(-count // seg))


def cases(W):
    """(name, scenario, count, root, function, plan) for every branch of
    _body a DCNDevice's selection reaches at world W."""
    R = Protocol.RENDEZVOUS
    root = W - 1
    red_flat = _plan(Algorithm.RNDZV_FLAT_TREE, N, R, tree_fanin=W - 1)
    out = [
        ("copy", Operation.copy, N, 0, 0, _plan(Algorithm.NONE, N)),
        ("combine", Operation.combine, N, 0, 0, _plan(Algorithm.NONE, N)),
        ("sendrecv", Operation.send, N, 0 | (root << 16), 0,
         _plan(Algorithm.EAGER_SENDRECV, N)),
        ("sendrecv_back", Operation.recv, N, root | (0 << 16), 0,
         _plan(Algorithm.EAGER_SENDRECV, N)),
        ("bcast_flat", Operation.bcast, N, root, 0,
         _plan(Algorithm.EAGER_FLAT, N)),
        ("bcast_bin_tree", Operation.bcast, N, 1 % W, 0,
         _plan(Algorithm.RNDZV_BIN_TREE, N, R, use_bin_tree=True)),
        ("scatter", Operation.scatter, C, 1 % W, 0,
         _plan(Algorithm.EAGER_FLAT, C)),
        ("gather_ring", Operation.gather, C, root, 0,
         _plan(Algorithm.EAGER_RING, C)),
        ("gather_flat", Operation.gather, C, 1 % W, 0,
         _plan(Algorithm.RNDZV_FLAT_TREE, C, R, tree_fanin=W - 1)),
        ("gather_fanin", Operation.gather, C, root, 0,
         _plan(Algorithm.RNDZV_FLAT_TREE, C, R, tree_fanin=1)),
        ("allgather", Operation.allgather, C, 0, 0,
         _plan(Algorithm.EAGER_RING, C)),
        ("reduce_flat", Operation.reduce, N, root, 0, red_flat),
        ("reduce_bin_tree", Operation.reduce, N, 1 % W, 0,
         _plan(Algorithm.RNDZV_BIN_TREE, N, R, use_bin_tree=True)),
        ("reduce_ring_max", Operation.reduce, N, 0, 1,
         _plan(Algorithm.EAGER_RING, N)),
        ("reduce_scatter", Operation.reduce_scatter, C, 0, 0,
         _plan(Algorithm.EAGER_RING, C)),
        ("reduce_scatter_composed", Operation.reduce_scatter, C, 0, 0,
         _plan(Algorithm.RNDZV_REDUCE_SCATTER, C, R, stages=(
             _plan(Algorithm.RNDZV_BIN_TREE, C * W, R, use_bin_tree=True),
             _plan(Algorithm.RNDZV_FLAT_TREE, C, R, tree_fanin=W - 1)))),
        ("allreduce_ragged", Operation.allreduce, N, 0, 0,
         _ar_plan(N, 64, W)),
        ("allreduce_blocks_max", Operation.allreduce, 2100, 0, 1,
         _ar_plan(2100, 600, W)),
        ("allreduce_composed", Operation.allreduce, N, 0, 0,
         _plan(Algorithm.RNDZV_REDUCE_BCAST, N, R, stages=(
             red_flat, _plan(Algorithm.RNDZV_BIN_TREE, N, R,
                             use_bin_tree=True)))),
        ("alltoall", Operation.alltoall, C, 0, 0,
         _plan(Algorithm.FLAT_ALLTOALL, C)),
        ("alltoall_aligned", Operation.alltoall, 256, 0, 0,
         _plan(Algorithm.FLAT_ALLTOALL, 256)),
        ("barrier", Operation.barrier, 1, 0, 0,
         _plan(Algorithm.BARRIER_GATHER_SCATTER, 1)),
    ]
    return out


def synth_cases(W, P, L):
    """Library entries a DCNDevice's registers can select at world W."""
    out = []
    for op, n in ((Operation.allreduce, 1000), (Operation.reduce_scatter,
                                                 96)):
        key = synthesis.select_entry(op, W, n * 4)
        if key is not None:
            out.append((f"synth_{op.name}", op, n, 0, 0,
                        _plan(Algorithm.SYNTHESIZED, n, synth_key=key)))
    key = synthesis.select_entry(Operation.allreduce, W, 4096,
                                 tiers=(L, P))
    if key is not None:
        out.append(("synth_tiered", Operation.allreduce, 1000, 0, 0,
                    _plan(Algorithm.SYNTHESIZED, 1000, synth_key=key,
                          inner_world=L, outer_world=P)))
    return out


def _options(scenario, count, root, function, wire):
    dt, _ = WIRES[wire]
    kw = {}
    if dt is not None and scenario not in (Operation.barrier,):
        kw = dict(compress_dtype=dt,
                  compression_flags=CompressionFlags.ETH_COMPRESSED)
    return CallOptions(scenario=scenario, count=count, function=function,
                       data_type=DataType.float32, root_src_dst=root, **kw)


def _inputs(scenario, count, W, seed):
    rng = np.random.default_rng(seed)
    if scenario == Operation.barrier:
        return [torch.ones((W, 1), dtype=torch.float32)]
    wide = scenario in (Operation.scatter, Operation.reduce_scatter,
                        Operation.alltoall)
    width = count * W if wide else count
    k = 2 if scenario == Operation.combine else 1
    return [torch.from_numpy((rng.standard_normal((W, width)) * 3).astype(
        np.float32)) for _ in range(k)]


def _threads(P, fn, hub=None):
    """fn(p, transport) on P threads, one host each, over `hub` (a
    LoopbackHub unless given; each thread brings its own transport up)."""
    hub = LoopbackHub(P) if hub is None else hub
    results, errors = [None] * P, []

    def run(p):
        try:
            transport = hub.transport(p)
            try:
                results[p] = fn(p, transport)
            finally:
                transport.close()
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return results


def _bits(t):
    return t.contiguous().view(torch.int32)


def run_cases(P, L, wire, case_list, seed=0, hub=None):
    """Every case's body on both forms, the multi-process one over `hub`
    (a LoopbackHub unless given); returns each host's tallies."""
    W = P * L
    _, table = WIRES[wire]
    stacked = ScheduleCompiler(W, CPU, arith_table=table,
                               use_ring_kernel=False)
    inputs, want, opts = [], [], []
    for i, (name, scen, count, root, func, plan) in enumerate(case_list):
        o = _options(scen, count, root, func, wire)
        xs = _inputs(scen, count, W, seed + i)
        opts.append(o)
        inputs.append(xs)
        want.append(stacked.lower_step(o, plan)(*xs))

    def host(p, transport):
        comp = DCNCompiler(Mesh({"dcn": P, "ici": L}, CPU),
                           arith_table=table, transport=transport)
        rows = slice(p * L, (p + 1) * L)
        got, tallies = [], []
        for (name, _, _, _, _, plan), o, xs in zip(case_list, opts, inputs):
            transport.reset_tally()
            got.append(comp.lower_step(o, plan)(*(x[rows] for x in xs)))
            tallies.append(transport.tally())
        return got, tallies

    per_host = _threads(P, host, hub)
    for p, (got, _) in enumerate(per_host):
        for case, w, g in zip(case_list, want, got):
            assert g.shape == w[p * L:(p + 1) * L].shape, (case[0], p)
            assert torch.equal(_bits(g), _bits(w[p * L:(p + 1) * L])), \
                (case[0], wire, P, L, p)
    return [t for _, t in per_host]


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("P,L", TOPOS, ids=[f"{p}x{l}" for p, l in TOPOS])
def test_process_form_bodies_are_the_stacked_bodies(P, L, wire):
    """Every _body branch, on each host's rows, bitwise the stacked flat
    body; the ring allreduce's messages and "flat" bytes."""
    W = P * L
    case_list = cases(W)
    if wire == "exact":
        case_list += synth_cases(W, P, L)
    tallies = run_cases(P, L, wire, case_list, seed=W * 7 + len(wire))
    names = [c[0] for c in case_list]
    for p in range(P):
        for name, count in (("allreduce_ragged", N),
                            ("allreduce_blocks_max", 2100)):
            t = tallies[p][names.index(name)]
            plan = case_list[names.index(name)][5]
            seg = plan.seg_count
            ragged = count % seg != 0
            # one message to the next host a ring step for every whole
            # segment, the same again for the ragged tail
            assert t["messages"]["flat"] == 2 * (W - 1) * (
                (count >= seg) + ragged), (name, t)
            if wire == "int8":  # codes and a scale a 256-element block
                full, tail = divmod(count, seg)
                want = 2 * (W - 1) * sum(
                    c + 4 * -(-c // 256) for c in
                    [-(-seg // W)] * full + ([-(-tail // W)] if tail
                                             else []))
            else:
                want = flat_allreduce_bytes(count, W, seg,
                                            4 if wire == "exact" else 2)
            assert t["sent"]["flat"] == want, (name, wire, t)


def test_flat_bytes_formula():
    """The bytes a process sends in one flat allreduce at 2 x 1, 4 x 1
    and as a 2 x 4 sequence step, at 4 and 25 MiB a rank in 256-element
    segments, and at a ragged count."""
    mib = 1 << 20
    assert [flat_allreduce_bytes(mib, w, 256) for w in (2, 4, 8)] == \
        [4_194_304, 6_291_456, 7_340_032]
    assert [flat_allreduce_bytes(25 * mib // 4, w, 256)
            for w in (2, 4, 8)] == [26_214_400, 39_321_600, 45_875_200]
    assert flat_allreduce_bytes(331, 3, 63) == \
        2 * 2 * (5 * 21 + 6) * 4
