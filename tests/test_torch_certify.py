"""The port's synthesis search and certification (sequencer/synthesis.py)
against the JAX package's.

`certify_spec` gives the reference's verdict and diagnostics on all 31
library specs and on uncertifiable ones; `enumerate_candidates` and
`enumerate_tiered_candidates` give the reference's specs up to W = 16;
`score_window(_tiered)` the reference's windows and predictions under
the shipped links; `search` the reference's winners (spec, canonical
DAG, window, predictions) flat at W = 4 and 8 and tiered at (2, 4), and
its beam-1 winner at W = 16 among the exhaustive winners (the
reference's test_beam_finds_exhaustive_winner_at_w16); a candidate that
fails certification is discarded loudly; `export_entry` writes the
library's own copy of a winner; `verify_library` passes, and fails on a
stale window and on a tampered digest.
"""

import dataclasses
import json
import random

import pytest

from accl_tpu.analysis import hopdag as ref_hopdag
from accl_tpu.constants import Operation as RefOperation
from accl_tpu.sequencer import synthesis as ref_synth
from accl_tpu_torch.analysis import hopdag
from accl_tpu_torch.constants import Operation
from accl_tpu_torch.sequencer import synthesis
from accl_tpu_torch.sequencer.timing import LinkParams

KEYS = sorted(synthesis.library())
OPS = [op.name for op in synthesis.SYNTH_OPS]


@pytest.fixture(scope="module")
def links():
    return synthesis.shipped_link(), synthesis.shipped_tier_links()


@pytest.fixture(scope="module")
def ref_links():
    return ref_synth.shipped_link(), ref_synth.shipped_tier_links()


def _diags(ds):
    return [(d.code, d.message, d.step, d.rank) for d in ds]


def _ref_spec(spec):
    return ref_synth.SynthSpec.from_json(spec.to_json())


def _result(r, pkg_hopdag):
    return (r.spec.to_json(), pkg_hopdag.to_json(r.dag), r.win_bytes,
            r.predicted)


UNCERTIFIABLE = [
    synthesis.SynthSpec("bad_cover", "allreduce", 8, "exchange", (1, 2, 5)),
    synthesis.SynthSpec("bad_rs_ag", "allreduce", 4, "rs_ag", (1, 3)),
    # an allgather schedule declared as an allreduce: ACCL50x diagnostics
    synthesis.SynthSpec("bad_op", "allreduce", 4, "doubling", (1, 2)),
    synthesis.SynthSpec("bad_tiers", "allreduce", 8, "t_lg_exchange", (1,),
                        tiers=(2, 2), outer_distances=(1,)),
]


@pytest.mark.parametrize("spec", [synthesis.entry_for_key(k).spec
                                  for k in KEYS] + UNCERTIFIABLE,
                         ids=lambda s: s.key)
def test_certify_spec_matches_reference(spec):
    ok, diags = synthesis.certify_spec(spec)
    ref_ok, ref_diags = ref_synth.certify_spec(_ref_spec(spec))
    assert (ok, _diags(diags)) == (ref_ok, _diags(ref_diags))
    assert ok == (spec.key in KEYS)


def test_certify_dag_flags_the_mutation_classes():
    """The reference's test_certify_gate_rejects_mutation_classes."""
    entry = synthesis.entry_for_key("allreduce_w8_exchange_d1_2_4")
    dag = synthesis.instantiate(entry.spec, entry.canonical_count)
    for kind, code in (("drop_combine", "ACCL502"),
                       ("duplicate_combine", "ACCL503")):
        mut = hopdag.mutate(dag, kind, random.Random(11))
        diags = synthesis.certify_dag(mut, entry.spec, entry.canonical_count)
        assert code in {d.code for d in diags}, kind


def test_enumeration_matches_reference_up_to_w16():
    for world in range(1, 17):
        for op in OPS:
            for wire in (True, False):
                got = synthesis.enumerate_candidates(Operation[op], world,
                                                     include_wire=wire)
                want = ref_synth.enumerate_candidates(RefOperation[op], world,
                                                      include_wire=wire)
                assert [s.to_json() for s in got] == \
                    [s.to_json() for s in want]
        for inner in range(1, world + 1):
            if world % inner:
                continue
            tiers = (inner, world // inner)
            assert [s.to_json() for s in
                    synthesis.enumerate_tiered_candidates(world, tiers)] == \
                [s.to_json() for s in
                 ref_synth.enumerate_tiered_candidates(world, tiers)]
    assert list(synthesis.enumerate_candidates(Operation.allreduce, 6)) == []


def test_score_windows_match_reference(links, ref_links):
    link, tiers = links
    ref_link, ref_tiers = ref_links
    for world in (2, 4, 8, 16):
        for op in OPS:
            for spec in synthesis.enumerate_candidates(Operation[op], world):
                for grid in (synthesis.SIZE_GRID, synthesis.SIZE_GRID_LAT):
                    assert synthesis.score_window(link, spec,
                                                  size_grid=grid) == \
                        ref_synth.score_window(ref_link, _ref_spec(spec),
                                               size_grid=grid)
        for inner in (2, 4):
            if world % inner or world // inner < 2:
                continue
            for spec in synthesis.enumerate_tiered_candidates(
                    world, (inner, world // inner)):
                assert synthesis.score_window_tiered(tiers, spec) == \
                    ref_synth.score_window_tiered(ref_tiers, _ref_spec(spec))


@pytest.mark.parametrize("cell", [("allreduce", 4, None),
                                  ("allreduce", 8, None),
                                  ("allgather", 8, None),
                                  ("reduce_scatter", 8, None),
                                  ("allreduce", 8, (2, 4))],
                         ids=lambda c: f"{c[0]}_w{c[1]}_{c[2]}")
def test_search_finds_the_references_winners(cell, links, ref_links):
    op, world, tiers = cell
    kw = {} if tiers is None else {"tiers": tiers}
    logs, ref_logs = [], []
    got = synthesis.search(Operation[op], world, links[0], log=logs.append,
                           tier_links=links[1], **kw)
    want = ref_synth.search(RefOperation[op], world, ref_links[0],
                            log=ref_logs.append, tier_links=ref_links[1],
                            **kw)
    assert [_result(r, hopdag) for r in got] == \
        [_result(r, ref_hopdag) for r in want]
    assert logs == ref_logs and got
    lib = synthesis.library()
    for r in got:
        assert lib[r.spec.key].win_bytes == r.win_bytes
    if tiers is None:
        lat = synthesis.search(Operation[op], world, links[0], grid="lat")
        assert [_result(r, hopdag) for r in lat] == \
            [_result(r, ref_hopdag) for r in ref_synth.search(
                RefOperation[op], world, ref_links[0], grid="lat")]


def test_beam_finds_exhaustive_winner_at_w16(links):
    link, tiers = links
    exhaustive = synthesis.search(Operation.allreduce, 16, link,
                                  tiers=(4, 4), tier_links=tiers)
    beam = synthesis.search(Operation.allreduce, 16, link, beam=1,
                            tiers=(4, 4), tier_links=tiers)
    assert len(beam) == 1
    ex_by_key = {r.spec.key: r for r in exhaustive}
    assert beam[0].spec.key in ex_by_key
    assert beam[0].win_bytes == ex_by_key[beam[0].spec.key].win_bytes
    flat_ex = synthesis.search(Operation.allreduce, 16, link)
    flat_beam = synthesis.search(Operation.allreduce, 16, link, beam=1)
    assert len(flat_beam) == 1
    assert flat_beam[0].spec.key in {r.spec.key for r in flat_ex}


def test_search_guards_and_discards(links, monkeypatch):
    link, tiers = links
    with pytest.raises(synthesis.SynthesisError, match="grid"):
        synthesis.search(Operation.allreduce, 8, link, grid="wide")
    with pytest.raises(synthesis.SynthesisError, match="allreduce only"):
        synthesis.search(Operation.allgather, 8, link, tiers=(2, 4),
                         tier_links=tiers)
    with pytest.raises(synthesis.SynthesisError, match="tier_links"):
        synthesis.search(Operation.allreduce, 8, link, tiers=(2, 4))
    real = synthesis.instantiate

    def broken(spec, count, func="sum"):
        dag = real(spec, count, func)
        return hopdag.mutate(dag, "drop_combine", random.Random(3)) or dag

    monkeypatch.setattr(synthesis, "instantiate", broken)
    msgs = []
    assert synthesis.search(Operation.allreduce, 4, link,
                            log=msgs.append) == []
    assert any("DISCARD" in m and "certification" in m for m in msgs)


def test_export_entry_writes_the_library_copy(links, tmp_path):
    for r in synthesis.search(Operation.allreduce, 8, links[0]):
        path = synthesis.export_entry(r, tmp_path)
        committed = synthesis.entry_for_key(r.spec.key).path
        assert path.read_text() == committed.read_text()
        doc = json.loads(path.read_text())
        assert synthesis.SynthSpec.from_json(doc) == r.spec
        assert doc["dag_sha256"] == synthesis.dag_digest(r.dag)


def test_verify_library(monkeypatch):
    msgs = []
    assert synthesis.verify_library(log=msgs.append), "\n".join(msgs)
    assert len(msgs) == 31 and all(m.startswith("  ok") for m in msgs)
    msgs = []
    assert not synthesis.verify_library(
        log=msgs.append, link=LinkParams(alpha=0.0, beta=1e9))
    assert any("stale selection window" in m for m in msgs), msgs
    lib = dict(synthesis.library())
    key = "allreduce_w8_exchange_d1_2_4"
    lib[key] = dataclasses.replace(lib[key], dag_sha256="0" * 64)
    monkeypatch.setattr(synthesis, "_LIBRARY", lib)
    msgs = []
    assert not synthesis.verify_library(log=msgs.append)
    assert [m for m in msgs if "FAIL" in m] == [
        f" FAIL {key}: regenerated DAG's digest != committed dag_sha256 "
        "(generator drift — re-export the library)"]
