"""The port's command-line tools (accl_tpu_torch/tools/) against the
reference's (tools/accl_lint.py, accl_synth.py, accl_trace.py,
run_emulator.py), on the CPU.

Each tool's `main` runs in process, with the output compared line for
line with the reference's functions where both compute the same thing:
every corpus fixture's verdict, the schedules sweep's 374 rows (their
selected plans) and a sampled sweep's summary in the default and deep
tiers, the synthesis search and score tables, the trace exports. Two
departures are held as such:
  - bad_concurrent_slot_collision: the reference rejects ACCL603 (two
    tenants on its Pallas ring's slots); the port's ring holds no slots,
    so the port's tool expects and finds it clean, and proves ACCL603
    on the slot row's hand-built footprints instead;
  - the `--semantic` tier: the reference's lifter cannot lift the
    sweep's jitted bodies here (a known reference caveat: it reports
    WITH DEFECTS), so there is nothing to compare, and the port is held
    to a strict clean certificate of every sampled configuration.
The full default sweep (374 configurations) takes about 30 s on a CPU and
belongs to chip_smoke and to a run by hand; Tier-1 runs a 16-config
sample in each tier and compares all 374 rows' plan selection.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import re
import sys

import pytest
import torch

from accl_tpu_torch.sequencer import synthesis
from accl_tpu_torch.tools import accl_lint, accl_synth, accl_trace
from accl_tpu_torch.tools import run_emulator

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = sorted((REPO / "tools" / "lint_corpus").glob("*.json"))
GOLDEN = REPO / "accl_log" / "golden_trace.json"
SLOT_DEPARTURE = "bad_concurrent_slot_collision.json"


def _ref_tool(name):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _out(fn, *args, **kw):
    """fn's return value and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


def _untimed(text: str) -> str:
    return re.sub(r" in [0-9.]+s$", "", text.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# accl_lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_lint_fixture_verdict_is_the_references(path):
    ref = _ref_tool("accl_lint")
    ok, line = accl_lint.run_fixture_file(path)
    rok, rline = ref.run_fixture_file(path)
    assert ok and rok
    if path.name == SLOT_DEPARTURE:
        assert rline.endswith("rejected with exactly ['ACCL603']")
        assert line.endswith("clean (the reference expects ['ACCL603']: "
                             "the port's ring holds no slots)")
    else:
        assert line == rline


def test_concurrent_expectations_are_exact():
    """A "concurrent" fixture's codes are held exactly, as the reference
    tool holds them: a stray code fails it. ACCL603 of a fixture whose
    tenants run on the reference's Pallas ring is not expected of the
    port."""
    from accl_tpu_torch.analysis import corpus
    from accl_tpu_torch.analysis.diagnostics import make

    fx = {"kind": "concurrent", "expect": ["ACCL601"],
          "tenants": [{"kind": "sequence"}] * 2}
    d601, d602 = make("ACCL601", "overlap"), make("ACCL602", "steal")
    assert corpus.fixture_ok(fx, [d601])
    assert not corpus.fixture_ok(fx, [d601, d602])
    assert not corpus.fixture_ok(fx, [])
    slots = {"kind": "concurrent", "expect": ["ACCL603"],
             "tenants": [{"kind": "sequence", "use_pallas_ring": True}] * 2}
    assert corpus.port_expect(slots) == []
    assert corpus.fixture_ok(slots, [])
    assert corpus.port_expect({**slots, "tenants": [{}] * 2}) == ["ACCL603"]


def test_lint_corpus_exits_zero():
    rc, out = _out(accl_lint.main, ["--corpus", "--device", "cpu"])
    assert rc == 0, out
    assert out.splitlines()[-1] == \
        "corpus: 50 fixtures (33 known-bad, 17 known-good)"
    assert " FAIL " not in out


def _plain(plan):
    """A Plan as nested plain values (enums as ints)."""
    out = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "stages":
            v = tuple(_plain(s) for s in v)
        elif isinstance(v, int):
            v = int(v)
        out[f.name] = v
    return out


def test_schedules_grid_is_the_references_row_for_row(monkeypatch):
    """All 374 rows: each row's call and selected plan equal the ones the
    reference's sweep selects (its tracing stubbed out: only the selection
    is compared here)."""
    ref = _ref_tool("accl_lint")
    rows = []

    def select(scen, count, nbytes, world, flags, **kw):
        plan = real(scen, count, nbytes, world, flags, **kw)
        rows.append((scen.name, count, world, int(flags),
                     kw["compress_dtype"].name, tuple(kw["peer_counts"]),
                     tuple(kw["live_ranks"]), kw.get("topology"),
                     _plain(plan)))
        return plan

    real = ref.select_algorithm
    monkeypatch.setattr(ref, "select_algorithm", select)
    monkeypatch.setattr(ref, "trace_schedule_hops", lambda *a: [])
    ref.run_schedules()
    want = rows[:]
    rows.clear()
    real = accl_lint.select_algorithm
    monkeypatch.setattr(accl_lint, "select_algorithm", select)
    configs = accl_lint.schedule_configs()
    for cfg in configs:
        accl_lint.config_call(cfg)
    assert len(configs) == len(want) == 374
    assert rows == want


@pytest.mark.parametrize("deep", [False, True], ids=["default", "deep"])
def test_sampled_schedules_match_the_reference(deep):
    ref = _ref_tool("accl_lint")
    flags = ["--deep"] if deep else []
    rc, out = _out(accl_lint.main, ["--schedules", "--sample", "16",
                                    "--device", "cpu", *flags])
    assert rc == 0, out
    rok, rout = _out(ref.run_schedules, deep=deep, sample=16)
    assert rok
    assert _untimed(out) == _untimed(rout)
    assert _untimed(out).startswith("schedules: 16 ")
    assert _untimed(out).endswith(" clean")


def test_sampled_schedules_certify_strictly_clean():
    """--semantic: every sampled configuration lifted and certified
    strictly (the reference cannot lift these here; see the docstring)."""
    rc, out = _out(accl_lint.main, ["--semantic", "--schedules",
                                    "--sample", "16", "--device", "cpu"])
    assert rc == 0, out
    assert _untimed(out) == (
        "schedules: 16 (scenario, world, root, size, tuning, wire) "
        "configurations interpreted + semantically certified clean")


def test_interference_sweep_exits_zero():
    rc, out = _out(accl_lint.main, ["--interference", "--device", "cpu"])
    assert rc == 0, out
    assert " FAIL " not in out
    pairs = [line.split() for line in out.splitlines()
             if re.match(r"  \S+ +x ", line)]
    assert [(p[0], p[2], " ".join(p[3:])) for p in pairs] == [
        ("moe", "moe2", "['ACCL601']"), ("moe", "decode", "clean"),
        ("moe", "train", "clean"), ("moe2", "decode", "clean"),
        ("moe2", "train", "clean"), ("decode", "train", "clean")]
    assert _untimed(out) == (
        "interference: 114 pairs certified across the family sweep, "
        "adversarial rows and recorded model programs, 5 concurrent "
        "corpus fixtures replayed clean")


def test_lint_without_a_mode_or_a_card(monkeypatch):
    with pytest.raises(SystemExit) as e:
        accl_lint.main([])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        accl_lint.main(["--corpus"])
    assert e.value.code not in (0, None)


# ---------------------------------------------------------------------------
# accl_synth
# ---------------------------------------------------------------------------


def test_synth_verify_library_exits_zero():
    rc, out = _out(accl_synth.main, ["--verify-library"])
    assert rc == 0, out
    assert out.count("  ok  ") == len(synthesis.library()) == 31


@pytest.mark.parametrize("argv", [
    ["--search", "--ops", "allreduce", "--worlds", "2", "4"],
    ["--score"]], ids=["search", "score"])
def test_synth_tables_are_the_references(argv):
    ref = _ref_tool("accl_synth")
    rc, out = _out(accl_synth.main, argv)
    rrc, rout = _out(ref.main, argv)
    assert rc == rrc == 0
    assert out == rout
    assert "WINNER" in out or "WINS" in out


def test_export_prunes_stale_in_scope_entries(tmp_path, monkeypatch):
    src = synthesis.library_dir()
    stale = tmp_path / "allreduce_w2_exchange_stale.json"
    stale.write_text((src / "allreduce_w2_exchange_d1.json").read_text())
    kept = tmp_path / "allreduce_w4_exchange_d1_2.json"
    kept.write_text((src / "allreduce_w4_exchange_d1_2.json").read_text())
    monkeypatch.setattr(synthesis, "library_dir", lambda: tmp_path)
    args = type("A", (), dict(
        worlds=[2], ops=["allreduce"], tiers=None, beam=None,
        timing_model=str(accl_synth.DEFAULT_MODEL), alpha_us=None,
        beta_gbps=None))()
    try:
        assert accl_synth.run_search(args, export=True)
        assert not stale.exists(), "in-scope stale entry not pruned"
        assert kept.exists(), "out-of-scope entry must be kept"
        fresh = tmp_path / "allreduce_w2_exchange_d1.json"
        assert json.loads(fresh.read_text()) == json.loads(
            (src / "allreduce_w2_exchange_d1.json").read_text())
    finally:
        synthesis.clear_library_cache()


# ---------------------------------------------------------------------------
# accl_trace
# ---------------------------------------------------------------------------


def test_make_golden_is_the_references():
    ref = _ref_tool("accl_trace")
    assert json.dumps(accl_trace.make_golden(), sort_keys=True) == \
        json.dumps(ref.make_golden(), sort_keys=True)


def test_golden_copy_is_byte_equal_and_selftests():
    assert accl_trace.GOLDEN.read_bytes() == GOLDEN.read_bytes()
    rc, out = _out(accl_trace.main, ["--selftest"])
    assert rc == 0
    assert out.startswith("selftest OK: 64 golden spans, 10 tracks")


def test_trace_exports_are_the_references(tmp_path):
    ref = _ref_tool("accl_trace")
    trace = json.loads(GOLDEN.read_text())
    rc, out = _out(accl_trace.main, [str(GOLDEN), "--validate",
                                     "--residuals", "--metrics",
                                     "--chrome", str(tmp_path / "a.json")])
    assert rc == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.cmd_validate(trace)
        ref.cmd_chrome(trace, str(tmp_path / "b.json"))
        ref.cmd_residuals(trace)
        assert ref.cmd_metrics(trace, accl_trace.GOLDEN_SENTINEL_WINDOW) \
            == 0
    assert out == buf.getvalue().replace(str(tmp_path / "b.json"),
                                         str(tmp_path / "a.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()


def test_validate_rejects_a_broken_span(tmp_path):
    trace = json.loads(GOLDEN.read_text())
    del trace["spans"][3]["ts_ns"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(trace))
    with pytest.raises(ValueError, match=r"spans\[3\].*ts_ns"):
        accl_trace.main([str(bad), "--validate"])


# ---------------------------------------------------------------------------
# run_emulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["tcp", "udp"])
def test_emulator_ranks_run_the_demo(transport, capfd):
    assert run_emulator.main(["-n", "2", "--transport", transport]) == 0
    out = capfd.readouterr().out
    assert "all 2 ranks OK" in out
    assert sorted(line[:8] for line in out.splitlines()
                  if line.endswith(" OK") and line.startswith("[rank")) \
        == ["[rank 0]", "[rank 1]"]


def test_emulator_script_returning_false_exits_one(tmp_path, monkeypatch,
                                                   capfd):
    (tmp_path / "emu_script_false.py").write_text(
        "def fail(rank, idx, world):\n    return idx != 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert run_emulator.main(["-n", "2", "--script",
                              "emu_script_false:fail"]) == 1
    assert "FAILED ranks: {1: False}" in capfd.readouterr().err
