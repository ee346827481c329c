"""The port's semantic certifier (analysis/semantics.py) and hop-DAG
mutations against the JAX package's, and the certifier against
execution on the CPU.

- `collective_spec` equals the reference's for every Operation at
  W in {1, 2, 4, 8}, a few counts, every root, SUM and MAX, the
  live-subset allreduce and the alltoallv capacity form.
- `certify` gives the reference's diagnostics on the 14 hopdag fixtures.
- `mutate(dag, kind, random.Random(s))` is to_json-equal to the
  reference's mutant for every library entry, kind and 3 seeds, and its
  certify diagnostics are the reference's.
- The reference's certifier-versus-execution rule
  (tests/test_semantics.py's fuzz) on every library entry at its
  canonical count and two larger ones: the DAG certifies clean and
  computes the numpy oracle's values through `hopdag.execute` and
  through the CPU `lower_dag` (exact wire: bitwise, and the lowering
  bitwise with execute; int8 wire: within (W+1)·W·max|x|/254 + 1e-5);
  every applicable mutant that certifies clean computes the oracle's
  values, a flagged one carries its class code, and a flagged
  drop/duplicate/swap under SUM computes wrong values (outside the
  bound, or on the int8 wire, where from W = 15 the bound exceeds one
  contribution, other values than the clean DAG on the same path). A
  mutant the lowering refuses (a dropped, added or moved node breaks
  the rank-major rounds) runs through `hopdag.execute`.
"""

import json
import random

import numpy as np
import pytest
import torch

import accl_tpu.constants as ref_c
import accl_tpu_torch.constants as port_c
from accl_tpu.analysis import hopdag as ref_hopdag
from accl_tpu.analysis import semantics as ref_sem
from accl_tpu.descriptor import CallOptions as RefOpts
from accl_tpu.sequencer import synthesis as ref_synth
from accl_tpu_torch.analysis import corpus, hopdag, semantics
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.sequencer import synthesis

KEYS = sorted(synthesis.library())
HOPDAG_FIXTURES = sorted(
    p for p in corpus.CORPUS_DIR.glob("*.json")
    if json.loads(p.read_text()).get("kind") == "hopdag")
MUTATION_CODE = {"drop_combine": "ACCL502", "duplicate_combine": "ACCL503",
                 "reorder_combine": "ACCL504", "swap_send_values": "ACCL501"}
SEEDS = (0, 1, 2)


def _diags(ds):
    return [(d.code, d.message, d.step, d.rank, d.severity) for d in ds]


def _roots(op, world):
    if op in ("bcast", "scatter", "gather", "reduce"):
        return range(world)
    if op in ("send", "recv"):
        return [s | (d << 16) for s in range(world) for d in range(world)]
    return [0]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_collective_spec_matches_reference(world):
    for op in port_c.Operation.__members__:
        for count in (1, 7, 64):
            for root in _roots(op, world):
                for func in (0, int(port_c.ReduceFunction.MAX)):
                    extra = [{}]
                    if op == "allreduce" and world > 2:
                        extra.append({"live_ranks": (0, world - 1)})
                    if op == "alltoall":
                        extra.append({"peer_counts": tuple(
                            (r * 3) % (count + 1) for r in range(world))})
                    for kw in extra:
                        got = semantics.collective_spec(CallOptions(
                            scenario=port_c.Operation[op], count=count,
                            root_src_dst=root, function=func, **kw), world)
                        want = ref_sem.collective_spec(RefOpts(
                            scenario=ref_c.Operation[op], count=count,
                            root_src_dst=root, function=func, **kw), world)
                        assert got == want, (op, count, root, func, kw)


@pytest.mark.parametrize("path", HOPDAG_FIXTURES, ids=lambda p: p.stem)
def test_certify_fixture_matches_reference(path):
    from tools.accl_lint import _step_from_dict

    fx = json.loads(path.read_text())
    opts, ref_opts = (corpus.step_from_dict(fx["collective"]),
                      _step_from_dict(fx["collective"]))
    dag, ref_dag = (hopdag.from_json(fx["dag"]),
                    ref_hopdag.from_json(fx["dag"]))
    got = semantics.certify(dag, semantics.collective_spec(opts, dag.world),
                            opts.scenario.name)
    want = ref_sem.certify(ref_dag,
                           ref_sem.collective_spec(ref_opts, dag.world),
                           ref_opts.scenario.name)
    assert _diags(got) == _diags(want)
    assert sorted({d.code for d in got}) == sorted(fx["expect_semantic"])


def _spec_of(entry, count, func):
    opts = synthesis._call_options(entry.spec, count, func)
    return semantics.collective_spec(opts, entry.spec.world)


@pytest.mark.parametrize("key", KEYS)
def test_mutations_match_reference(key):
    entry = synthesis.entry_for_key(key)
    count = entry.canonical_count
    dag = synthesis.instantiate(entry.spec, count)
    ref_dag = ref_synth.instantiate(ref_synth.entry_for_key(key).spec, count)
    spec = _spec_of(entry, count, port_c.ReduceFunction.SUM)
    ref_spec = ref_sem.collective_spec(ref_synth._call_options(
        ref_synth.entry_for_key(key).spec, count), dag.world)
    for kind in hopdag.MUTATIONS:
        for s in SEEDS:
            mut = hopdag.mutate(dag, kind, random.Random(s))
            ref_mut = ref_hopdag.mutate(ref_dag, kind, random.Random(s))
            assert (mut is None) == (ref_mut is None), (kind, s)
            if mut is None:
                continue
            assert hopdag.to_json(mut) == ref_hopdag.to_json(ref_mut)
            assert _diags(semantics.certify(mut, spec, entry.spec.op)) == \
                _diags(ref_sem.certify(ref_mut, ref_spec, entry.spec.op))


def _payloads(rng, dag, quantized):
    """The reference's _payloads as (world, in_elems) rows: unique
    integer-valued fp32 on the exact wire (sums stay exact, a misroute
    shows), small positive integers on the int8 wire."""
    w, n = dag.world, dag.in_elems
    if quantized:
        return rng.integers(1, 9, (w, n)).astype(np.float32)
    return (np.arange(w * n, dtype=np.float32).reshape(w, n) + 1.0)


def _oracle(op, x, count, func):
    red = np.max if func == "max" else np.sum
    w = x.shape[0]
    if op == "allreduce":
        return np.tile(red(x, axis=0), (w, 1))
    if op == "allgather":
        return np.tile(x.reshape(-1), (w, 1))
    full = red(x, axis=0)  # reduce_scatter
    return np.stack([full[r * count:(r + 1) * count] for r in range(w)])


def _applicable_mutations(dag, quantized):
    """The reference's _applicable_mutations."""
    kinds = []
    combines = [n for n in dag.nodes if n.kind == "combine"]
    if combines:
        kinds.append("drop_combine")
        if any(any(dag.nodes[p.node].kind == "recv" for p in n.refs())
               for n in combines):
            kinds.append("reorder_combine")
    if any(n.func == "sum" for n in combines):
        kinds.append("duplicate_combine")
    if not quantized:
        kinds.append("swap_send_values")
    return kinds


def _broken(out, want, quantized, bound):
    if quantized:
        return not np.allclose(out, want, rtol=0, atol=bound)
    return not np.array_equal(out, want)


@pytest.mark.parametrize("key", KEYS)
def test_certifier_against_execution(key):
    entry = synthesis.entry_for_key(key)
    spec = entry.spec
    quantized = spec.wire == "int8"
    c = entry.canonical_count
    funcs = ["sum"] + (["max"] if spec.op == "allreduce" and not quantized
                       else [])
    rng = np.random.default_rng(sum(map(ord, key)))
    for count in (c, 5 * c, 37 * c):
        for func in funcs:
            fn = (port_c.ReduceFunction.MAX if func == "max"
                  else port_c.ReduceFunction.SUM)
            dag = synthesis.instantiate(spec, count, func)
            assert synthesis.certify_dag(dag, spec, count, fn) == []
            x = _payloads(rng, dag, quantized)
            want = _oracle(spec.op, x, count, func)
            bound = (dag.world + 1) * dag.world * float(np.abs(x).max()) \
                / 254.0 + 1e-5
            ex = np.stack(hopdag.execute(dag, [[r] for r in x]))
            low = synthesis.lower_dag(dag)(torch.from_numpy(x)).numpy()
            for out in (ex, low):
                assert not _broken(out, want, quantized, bound), \
                    (count, func)
            if not quantized:
                assert np.array_equal(low, ex)
    # the mutants, at the canonical count under SUM
    dag = synthesis.instantiate(spec, c)
    sem_spec = _spec_of(entry, c, port_c.ReduceFunction.SUM)
    x = _payloads(rng, dag, quantized)
    want = _oracle(spec.op, x, c, "sum")
    bound = (dag.world + 1) * dag.world * float(np.abs(x).max()) / 254.0 \
        + 1e-5
    clean = np.stack(hopdag.execute(dag, [[r] for r in x]))
    for kind in _applicable_mutations(dag, quantized):
        for s in SEEDS:
            mut = hopdag.mutate(dag, kind, random.Random(s))
            if mut is None:
                continue
            codes = {d.code for d in semantics.certify(mut, sem_spec,
                                                       spec.op)}
            out = np.stack(hopdag.execute(mut, [[r] for r in x]))
            same_path = clean
            try:
                low = synthesis.lower_dag(mut)(torch.from_numpy(x)).numpy()
            except synthesis.SynthesisError:
                pass
            else:
                if not quantized:
                    assert np.array_equal(low, out), (kind, s)
                out = low
                same_path = synthesis.lower_dag(dag)(
                    torch.from_numpy(x)).numpy()
            broken = _broken(out, want, quantized, bound)
            ctx = (kind, s, codes)
            if not codes:
                assert not broken, ctx
                continue
            assert MUTATION_CODE[kind] in codes, ctx
            assert all(code.startswith("ACCL5") for code in codes), ctx
            if kind in ("drop_combine", "duplicate_combine",
                        "swap_send_values"):
                # from W = 15 the int8 bound exceeds max|x|, so one lost
                # or doubled contribution can sit inside it: there the
                # mutant must differ from the clean DAG's own run
                assert broken or (quantized
                                  and not np.array_equal(out, same_path)), \
                    ctx


def test_lifting_entry_points_raise():
    """The lifting entry points run now (they raised until the lifting
    slice): lift_call, certify_call and check_batch_semantics certify a
    ring allreduce at W 4 as the reference does, and clear_cache empties
    the verdict cache (tests/test_torch_lift.py holds the lift itself)."""
    semantics.clear_cache()
    opts, plan = corpus.family_call(port_c.Operation.allreduce, 16, 4)
    dag = semantics.lift_call(opts, plan, 4)
    assert semantics.certify(dag, semantics.collective_spec(opts, 4)) == []
    assert semantics.certify_call(opts, plan, 4) == []
    assert semantics.check_batch_semantics([opts], [plan], 4) == []
    assert semantics.check_batch_semantics([], [], 4) == []
    assert len(semantics._CERT_CACHE) == 1
    semantics.clear_cache()
    assert semantics._CERT_CACHE == {}
