"""Whole runs of the harness at tiny sizes: every cell on the CPU, traced
and untraced; the lower-precision control and the faults that a cell can
have, each of which the check has to fail; cells made of files added and
nothing else; and, on the card, the control and a bare checkout."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cardbench import harness, run

ROOT = Path(harness.__file__).resolve().parents[1]
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 11  # beyond 32 signed bits, as the driver's seeds are
SHRINK = {"ddp_bucketed": 1 << 14, "decode_graph_b64": 1 << 10}


def _run(cell, *, trace=False, seed=SEED, device="cpu", root=ROOT,
         shrink=None, control=False):
    return harness.run_cell(cell, seed, 0.05, trace,
                            t_start=time.perf_counter(), device=device,
                            shrink=shrink or SHRINK.get(cell, 1),
                            control=control, root=root)


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
    assert res["check"]["rank_mismatch"]["value"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_dry_run_reports_host_side_per_layer_metrics(cell):
    res = _run(cell, trace=True)
    assert res["correct"] is True
    per_layer = {m["name"] for m in SPEC["per_layer"]
                 if cell in m["workloads"]}
    # off the card the device trace and the peak read nothing
    on_host = per_layer - {"ring_kernel_roofline", "device_idle_pct",
                           "peak_copies"}
    assert set(res["metrics"]) == on_host
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


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check(cell):
    res = _run(cell, control=True)
    assert res["correct"] is False
    assert res["check"]["sum_err_u"]["value"] > 100 * res["check"][
        "sum_err_u"]["limit"]


def _exchange_left_out(x, out):
    return x.clone()


def _half_the_ranks_scaled(x, out):
    half = x.shape[0] // 2
    return (x[:half].sum(0, keepdim=True) * 2).expand_as(x).contiguous()


def _one_answer_altered(x, out):
    out = out.clone()
    out[x.shape[0] - 1, out.shape[1] // 2] += 1.0
    return out


@pytest.mark.parametrize("fault", [_exchange_left_out, _half_the_ranks_scaled,
                                   _one_answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_fails_the_check(cell, fault, monkeypatch):
    from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

    body_of = ScheduleCompiler._allreduce_body

    def broken(self, *args, **kwargs):
        body = body_of(self, *args, **kwargs)
        return lambda x: fault(x, body(x))

    monkeypatch.setattr(ScheduleCompiler, "_allreduce_body", broken)
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


def _added_cell(tmp_path):
    """A copy of the benchmark with one configuration, one traffic mix and
    one per-layer metric added as files, and entries for them."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
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
           "check_limits": {"sum_err_u": 16.0, "rank_mismatch": 0.0}}
    (tmp_path / "cardbench/configs/tiny.dp4.json").write_text(json.dumps(cfg))
    traffic = {"driver": "eager_async", "warm_steps": 1, "trace_seconds": 1}
    (tmp_path / "cardbench/traffic/burst.json").write_text(
        json.dumps(traffic))
    (tmp_path / "cardbench/metrics/calls_per_step.py").write_text(
        "def read(ctx):\n"
        "    calls = [e for e in ctx.spans if e['track'] == 'facade']\n"
        "    return len(calls) / ctx.steps\n")
    return tmp_path


def test_a_cell_added_as_files_only_runs(tmp_path):
    root = _added_cell(tmp_path)
    res = _run("tiny.burst", root=root, shrink=1)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s"}
    traced = _run("tiny.burst", root=root, shrink=1, trace=True)
    assert traced["metrics"]["calls_per_step"]["value"] == 3.0
    assert "facade_host_us" not in traced["metrics"]
    # the control fails the added cell too
    assert _run("tiny.burst", root=root, shrink=1,
                control=True)["correct"] is False


def test_without_a_card_run_exits_nonzero_and_prints_no_result(
        capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_passes_and_the_control_fails(cell, card):
    shrink = {"ddp_bucketed": 64, "decode_graph_b64": 4}[cell]
    for seed in (SEED, SEED + 1, SEED + 2):
        assert _run(cell, seed=seed, device=card, shrink=shrink)["correct"]
        assert not _run(cell, seed=seed, device=card, shrink=shrink,
                        control=True)["correct"]


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
