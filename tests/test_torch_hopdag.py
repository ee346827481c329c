"""The port's hop-DAG IR against the JAX package's: every entry of the
synthesized library regenerates to the DAG the JAX package commits
for it (the port's copies carry the entries' metadata and that DAG's
digest), round-trips through JSON, orders and lowers to the same hop
programs (protocol Events, field for field), and evaluates (`execute`)
to the same bits on the same numpy inputs."""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from accl_tpu.analysis import hopdag as ref_hopdag
from accl_tpu.sequencer import synthesis as ref_synth
from accl_tpu_torch.analysis import hopdag
from accl_tpu_torch.sequencer import synthesis

KEYS = sorted(ref_synth.library())


def test_library_is_the_references():
    """The port's copy of the library holds the same 31 entries, each the
    reference's file with its DAG body replaced by the body's digest
    (SHA-256 of its JSON with sorted keys)."""
    assert sorted(synthesis.library()) == KEYS and len(KEYS) == 31
    for key in KEYS:
        mine = synthesis.entry_for_key(key)
        theirs = ref_synth.entry_for_key(key)
        doc = json.loads(theirs.path.read_text())
        body = doc.pop("dag")
        doc["dag_sha256"] = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()
        assert json.loads(mine.path.read_text()) == doc
        assert mine.dag_sha256 == doc["dag_sha256"]
        assert mine.win_bytes == theirs.win_bytes
        assert mine.canonical_count == theirs.canonical_count


@pytest.mark.parametrize("key", KEYS)
def test_entry_dag_executes_like_the_reference(key):
    entry = synthesis.entry_for_key(key)
    ref_entry = ref_synth.entry_for_key(key)
    dag = synthesis.instantiate(entry.spec, entry.canonical_count)
    ref_dag = ref_synth.instantiate(ref_entry.spec, ref_entry.canonical_count)
    doc = hopdag.to_json(dag)
    assert doc == ref_hopdag.to_json(ref_dag) == \
        json.loads(ref_entry.path.read_text())["dag"]
    assert hopdag.to_json(hopdag.from_json(doc)) == doc
    assert hopdag.validate_order(dag) == []
    assert [[dataclasses.astuple(e) for e in prog]
            for prog in hopdag.rank_programs(dag)] == \
        [[dataclasses.astuple(e) for e in prog]
         for prog in ref_hopdag.rank_programs(ref_dag)]
    assert synthesis.dag_digest(dag) == entry.dag_sha256
    rng = np.random.default_rng(sum(map(ord, key)))
    x = (rng.standard_normal((dag.world, dag.in_elems)) * 4).astype(
        np.float32)
    got = hopdag.execute(dag, [[x[r]] for r in range(dag.world)])
    want = ref_hopdag.execute(ref_dag, [[x[r]] for r in range(dag.world)])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.int32), np.asarray(w).view(np.int32))


def test_stale_read_reads_zeros_and_is_reported():
    """A recv ordered before its send: ACCL504 from validate_order, and
    zeros from execute, as in the reference."""
    P = hopdag.Piece
    nodes = (
        hopdag.Node(0, "arg", 0, 4, arg=0, dtype="float32"),
        hopdag.Node(1, "arg", 1, 4, arg=0, dtype="float32"),
        hopdag.Node(2, "recv", 1, 4, hop=0, peer=0),
        hopdag.Node(3, "send", 0, 4, value=(P(4, 0),), hop=0, peer=1),
    )
    dag = hopdag.HopDag(world=2, n_in=1, in_elems=4, out_elems=4,
                        nodes=nodes, outputs=((P(4, 0),), (P(4, 2),)))
    assert [d.code for d in hopdag.validate_order(dag)] == ["ACCL504"]
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    out = hopdag.execute(dag, [[x[0]], [x[1]]])
    assert np.array_equal(out[1], np.zeros(4, np.float32))
