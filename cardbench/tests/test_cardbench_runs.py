"""Whole runs of the harness at tiny sizes: every cell on the CPU, traced
and untraced; the lower-precision control and the faults that a cell can
have, each of which the check has to fail; cells made of files added and
nothing else, one of them an alltoall with seeded weights; and, on the
card, the control, the faults on the path the cells time, and a bare
checkout."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cardbench import harness, run
from cardbench.inputs import weight_seed

ROOT = Path(harness.__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 11  # beyond 32 signed bits, as the driver's seeds are


def _shrink(cell, root, device) -> int:
    """The cell's test size, from its traffic file."""
    key = "card_shrink" if torch.device(device).type == "cuda" else \
        "cpu_shrink"
    return harness.load_cell(harness.load_spec(root), cell, root).traffic[key]


def _run(cell, *, trace=False, seed=SEED, device="cpu", root=ROOT,
         control=False):
    return harness.run_cell(cell, seed, 0.05, trace,
                            t_start=time.perf_counter(), device=device,
                            shrink=_shrink(cell, root, device),
                            control=control, root=root)


def _config(cell):
    return harness.load_cell(SPEC, cell).config


def _reads_off_the_card(m) -> bool:
    """Whether a per-layer metric finds something to read in a CPU run:
    not where it reads the device trace (the profiler's timeline, the
    allocator's peak), nor where it reads a program span's device time
    (`device_ns`, a CUDA event pair the program records on the card)."""
    if m["source"] == "device_trace":
        return False
    reader = (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").read_text()
    return not (m["source"] == "program_span" and "device_ns" in reader)


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct_and_reports_its_end_to_end_metrics(cell):
    res = _run(cell)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert list(res)[-1] == "check"
    names = {m["name"] for m in SPEC["end_to_end"]
             if cell in m.get("workloads", [cell])}
    # peak memory is 0 off the card and left out
    assert set(res["metrics"]) == names - {"peak_mem_GiB"}
    # the reference returned exactly the numbers the configuration limits
    assert set(res["check"]) == set(_config(cell)["check_limits"])
    # no weights: no set-up phase for them
    assert "weights" not in _config(cell)
    assert "weights" not in res["phases_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_dry_run_reports_host_side_per_layer_metrics(cell):
    res = _run(cell, trace=True)
    assert res["correct"] is True
    per_layer = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
    assert set(res["metrics"]) == {m["name"] for m in per_layer
                                   if _reads_off_the_card(m)}
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_the_same_seed_gives_the_same_operands():
    from cardbench.inputs import Operands

    a = Operands([5, 7], 8, SEED, "cpu")
    b = Operands([5, 7], 8, SEED, "cpu")
    c = Operands([5, 7], 8, SEED + 1, "cpu")
    assert torch.equal(a.flat, b.flat) and not torch.equal(a.flat, c.flat)
    a.mark()
    a.mark()
    b.set_marks(2)
    assert torch.equal(a.flat, b.flat)
    assert a.views[1][:, 0].tolist() == [r + 2.0 for r in range(8)]


@pytest.mark.parametrize("seed", [0, 1, -3, SEED, 2**63 + 5])
def test_the_weights_seed_is_fixed_and_apart_from_the_operands(seed):
    ws = weight_seed(seed)
    assert ws == weight_seed(seed) and 0 <= ws < 2**64
    assert ws != seed and ws != weight_seed(seed + 1)
    ops = torch.Generator().manual_seed(seed)
    wts = torch.Generator().manual_seed(ws)
    assert not torch.equal(torch.rand(64, generator=ops),
                           torch.rand(64, generator=wts))


def _fails_by_far(res):
    """`correct` false, and some number far past its limit."""
    return res["correct"] is False and any(
        c["value"] > 100 * c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check(cell):
    assert _fails_by_far(_run(cell, control=True))


class _Fault:
    """A fault planted where every collective's body passes: `operand`
    is what the step's body reads in place of its operand, `answer` what
    it hands on in place of its result."""

    name = ""

    def operand(self, x):
        return x

    def answer(self, x, out):
        return out


class _ExchangeLeftOut(_Fault):
    name = "exchange_left_out"  # every rank keeps its own operand

    def answer(self, x, out):
        return x.clone()


class _HalfTheRanksScaled(_Fault):
    name = "half_the_ranks_scaled"  # half left out, the rest scaled up

    def operand(self, x):
        half = x.shape[0] // 2
        y = x * (x.shape[0] / half)
        y[half:] = 0
        return y


class _OneAnswerAltered(_Fault):
    name = "one_answer_altered"

    def answer(self, x, out):
        out = out.clone()
        out[out.shape[0] - 1, out.shape[-1] // 2] += 1.0
        return out


FAULTS = [_ExchangeLeftOut(), _HalfTheRanksScaled(), _OneAnswerAltered()]


def _plant(fault, monkeypatch) -> list[int]:
    """Break the timed path with `fault`. Every step's body is faulted
    (ScheduleCompiler._body) and keeps its marks, so that a captured
    sequence places its steps as a sound run does; a step that a captured
    graph runs in place launches kernel 1's indirect entry instead of its
    body, so there the operand it reads in place (SequenceGraph.bind) and
    the fresh result it hands on (SequenceGraph.results) are faulted.
    Returns a one-element count of the in-place results faulted."""
    from accl_tpu_torch.sequencer.lowering import (ScheduleCompiler,
                                                   SequenceGraph)

    body_of = ScheduleCompiler._body
    bind, results = SequenceGraph.bind, SequenceGraph.results
    in_place = [0]

    def broken_body(self, *args, **kwargs):
        body = body_of(self, *args, **kwargs)

        def faulted(x, *rest):
            return fault.answer(x, body(fault.operand(x), *rest))

        faulted.__dict__.update(getattr(body, "__dict__", {}))
        return faulted

    def broken_bind(self, tensors):
        reads = {i for i, _, _ in self._reads}
        return bind(self, [fault.operand(t) if i in reads else t
                           for i, t in enumerate(tensors)])

    def broken_results(self, b):
        outs = results(self, b)
        if self.placement is not None:
            steps = {p.step: p for p in self.placement.steps}
            for k, s in enumerate(self.placement.finals):
                p = steps.get(s)
                if p is not None and p.fresh and p.source[0] == "bound":
                    x = b.bound[p.source[1]][..., :p.n]
                    outs[k] = fault.answer(x, outs[k])
                    in_place[0] += 1
        return outs

    monkeypatch.setattr(ScheduleCompiler, "_body", broken_body)
    monkeypatch.setattr(SequenceGraph, "bind", broken_bind)
    monkeypatch.setattr(SequenceGraph, "results", broken_results)
    return in_place


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.name)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_fails_the_check(cell, fault, monkeypatch):
    _plant(fault, monkeypatch)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_its_results_unchanged_fails(cell, monkeypatch):
    from accl_tpu_torch.device.gpu_device import GPUDevice

    placed = [0]
    place = GPUDevice._place

    def stale(full, ctx, out):
        # the warm steps place their results; the window's never do
        placed[0] += 1
        return full if placed[0] > limit else place(full, ctx, out)

    parts = harness.load_cell(SPEC, cell)
    limit = parts.traffic["warm_steps"] * len(
        harness.step_messages(parts.config, parts.traffic))
    monkeypatch.setattr(GPUDevice, "_place", staticmethod(stale))
    assert _run(cell)["correct"] is False


def _copy_benchmark(tmp_path):
    """A checkout's benchmark files, without the tests."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return json.loads(json.dumps(SPEC))


def _added_cell(tmp_path):
    """A copy of the benchmark with one configuration, one traffic mix and
    one per-layer metric added as files, and entries for them."""
    spec = _copy_benchmark(tmp_path)
    spec["configs"].append({
        "name": "tiny.dp4", "source": "https://example.org/tiny",
        "file": "cardbench/configs/tiny.dp4.json", "reduced": [],
        "why": "a dummy"})
    spec["workloads"].append({
        "name": "tiny.burst", "config": "tiny.dp4", "traffic": "burst",
        "chips": 1, "why": "a dummy"})
    spec["per_layer"].append({
        "name": "calls_per_step", "unit": "calls", "better": "lower",
        "source": "program_span", "layer": "facade", "moves": "setup_s",
        "workloads": ["tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = {"deployment": {"world": 4}, "step_calls": {"elems": [300, 17, 64]},
           "reference": "sum_allreduce",
           "check_limits": {"sum_err_u": 16.0, "rank_mismatch": 0.0},
           "check_limits_why": {"sum_err_u": "a dummy",
                                "rank_mismatch": "a dummy"}}
    (tmp_path / "cardbench/configs/tiny.dp4.json").write_text(json.dumps(cfg))
    traffic = {"driver": "eager_async", "warm_steps": 1, "trace_seconds": 1,
               "cpu_shrink": 1, "card_shrink": 1}
    (tmp_path / "cardbench/traffic/burst.json").write_text(
        json.dumps(traffic))
    (tmp_path / "cardbench/metrics/calls_per_step.py").write_text(
        "def read(ctx):\n"
        "    calls = [e for e in ctx.spans if e['track'] == 'facade']\n"
        "    return len(calls) / ctx.steps\n")
    return tmp_path


def test_a_cell_added_as_files_only_runs(tmp_path):
    root = _added_cell(tmp_path)
    res = _run("tiny.burst", root=root)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s"}
    traced = _run("tiny.burst", root=root, trace=True)
    assert traced["metrics"]["calls_per_step"]["value"] == 3.0
    assert "facade_host_us" not in traced["metrics"]
    # the control fails the added cell too
    assert _run("tiny.burst", root=root, control=True)["correct"] is False


A2A = "tiny.a2a"


def _alltoall_cell(tmp_path):
    """A copy of the benchmark with a cell of another collective added as
    files only (cardbench/tests/files_only_alltoall/ copied into place):
    its configuration with seeded weights (a scale a rank), a generator
    that replays recorded `ACCL.alltoall` calls over the scaled operands,
    its own reference and check numbers, and a per-layer metric. Its
    entries: the configuration, the cell, the metric, and the cell's name
    on the bounded end-to-end metric it reports."""
    spec = _copy_benchmark(tmp_path)
    shutil.copytree(HERE / "files_only_alltoall", tmp_path / "cardbench",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec["configs"].append({
        "name": "tiny.a2a4", "source": "https://example.org/tiny-a2a",
        "file": "cardbench/configs/tiny.a2a4.json", "reduced": [],
        "why": "a test: an alltoall of scaled rows over 4 ranks"})
    spec["workloads"].append({
        "name": A2A, "config": "tiny.a2a4", "traffic": "a2a", "chips": 1,
        "why": "a test: three alltoalls a step replayed as one sequence"})
    for name, unit in (("replays_per_step", "replays"),
                       ("moved_elems_per_step", "elements")):
        spec["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_counter", "layer": "sequence",
            "moves": "step_p95_ms", "workloads": [A2A]})
    for m in spec["end_to_end"]:
        if m["name"] == "step_p95_ms":
            m["workloads"].append(A2A)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_an_alltoall_cell_added_as_files_only_runs(tmp_path, monkeypatch):
    root = _alltoall_cell(tmp_path)
    made = []
    module = harness._module

    def spy(root_, kind, name):
        mod = module(root_, kind, name)
        if kind == "weights":
            make = mod.make

            def recorded(*args):
                made.append(make(*args))
                return made[-1]

            mod.make = recorded
        return mod

    monkeypatch.setattr(harness, "_module", spy)
    res = _run(A2A, root=root)
    assert res["correct"] is True, res["check"]
    assert set(res["metrics"]) == {"setup_s", "step_p95_ms"}
    assert set(res["check"]) == {"moved_gap", "elems_wrong"}
    assert "weights" in res["phases_s"]
    # made twice from one seed, for the program and for the reference
    assert len(made) == 2 and torch.equal(made[0]["scale"],
                                          made[1]["scale"])
    again = _run(A2A, root=root)
    assert again["check"] == res["check"]
    assert torch.equal(made[2]["scale"], made[0]["scale"])
    other = _run(A2A, root=root, seed=SEED + 1)
    assert other["correct"] is True
    assert not torch.equal(made[4]["scale"], made[0]["scale"])
    traced = _run(A2A, root=root, trace=True)
    assert traced["correct"] is True
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    # 4 ranks, buffers of 64, 256 and 12: 3 of 4 slots leave each rank
    assert got == {"replays_per_step": 1.0, "moved_elems_per_step": 996}


def test_the_bfloat16_control_fails_the_alltoall_cell(tmp_path):
    root = _alltoall_cell(tmp_path)
    assert _fails_by_far(_run(A2A, root=root, control=True))


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.name)
def test_a_fault_fails_the_alltoall_cell(tmp_path, fault, monkeypatch):
    root = _alltoall_cell(tmp_path)
    _plant(fault, monkeypatch)
    assert _run(A2A, root=root)["correct"] is False


def test_without_a_card_run_exits_nonzero_and_prints_no_result(
        capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_passes_and_the_control_fails(cell, card):
    for seed in (SEED, SEED + 1, SEED + 2):
        assert _run(cell, seed=seed, device=card)["correct"]
        assert not _run(cell, seed=seed, device=card,
                        control=True)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.name)
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_fault_in_the_timed_path_fails_the_check(
        cell, fault, card, monkeypatch):
    in_place = _plant(fault, monkeypatch)
    assert _run(cell, device=card)["correct"] is False
    # a captured sequence's steps stay on the in-place path it times
    parts = harness.load_cell(SPEC, cell)
    assert (in_place[0] > 0) == (parts.traffic["driver"] == "sequence_replay")


@pytest.mark.card
def test_on_the_card_the_alltoall_cell_runs_and_its_control_fails(
        card, tmp_path):
    root = _alltoall_cell(tmp_path)
    assert _run(A2A, root=root, device=card)["correct"] is True
    assert _fails_by_far(_run(A2A, root=root, device=card, control=True))


@pytest.mark.card
def test_a_bare_checkout_exits_nonzero(card, tmp_path):
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload", CELLS[-1],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
