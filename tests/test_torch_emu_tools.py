"""The port's emulator measuring tools (accl_tpu_torch/tools/
bench_emulator.py, rt_stats_sweep.py, timing_model.py) against the
reference's (tools/bench_emulator.py, rt_stats_sweep.py,
timing_model.py), on the CPU.

The reference tools write under accl_log/ by a fixed path, so each runs
here with its module global REPO pointed at a temporary directory and
sys.argv patched; the port's write where --out/--out-dir say. Nothing is
written under accl_log/, whose committed sweeps and profile are read
only. Seconds, counters and park times depend on thread timing and are
never compared: the Protocol column, the row sets, the span counts,
retcodes and counter keys are, and the timing model key for key on the
same input files (floats within 1e-12 relative). Two strings differ by
design: the model's top-level `source` (a path) and the on-chip tier's
`note`, which describes the card's profile, not a TPU's.
"""

import csv
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from accl_tpu_torch import ACCL
from accl_tpu_torch.constants import TuningParams
from accl_tpu_torch.device import emu_device
from accl_tpu_torch.device.emu_device import EmuWorld
from accl_tpu_torch.device.gpu_device import GPUDevice
from accl_tpu_torch.sequencer.timing import LinkParams, tuning_crossovers
from accl_tpu_torch.tools import bench_emulator, rt_stats_sweep, timing_model

REPO = pathlib.Path(__file__).resolve().parent.parent
LOG = REPO / "accl_log"
SWEEPS = {"tcp": "emu_bench.csv", "local": "emu_bench_local.csv",
          "udp": "emu_bench_udp.csv"}


def _ref_tool(name):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# bench_emulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport,rows,skips",
                         [("tcp", 120, 0), ("local", 159, 1),
                          ("udp", 80, 0)])
def test_protocol_column_is_the_committed_sweeps(transport, rows, skips):
    """Every committed row's Protocol is protocol_label's, and every
    (collective, size) a world lacks is exactly a skip."""
    got = {(r["Collective"], int(r["Bytes"]), int(r["World"])): r["Protocol"]
           for r in _read(LOG / SWEEPS[transport])}
    assert len(got) == rows
    n_skipped = 0
    for world in sorted({k[2] for k in got}):
        for nbytes in bench_emulator.SIZES:
            for name in bench_emulator.COLLECTIVES:
                proto = bench_emulator.protocol_label(name, nbytes // 4,
                                                      world, transport)
                key = (name, nbytes, world)
                if bench_emulator.skipped(name, proto, nbytes, world):
                    assert key not in got
                    n_skipped += 1
                else:
                    assert got[key] == proto, key
    assert n_skipped == skips
    if skips:  # the one: W 32 local reduce_scatter at 4 MiB (128 MB)
        assert bench_emulator.skipped("reduce_scatter", "rndzv", 4 << 20, 32)


OLD_HEADER = "Collective,Protocol,Bytes,Seconds,GBps\n"


@pytest.mark.parametrize("transport,world,seed",
                         [("tcp", 2, "merge"), ("udp", 2, "merge"),
                          ("local", 2, "merge"), ("local", 3, "old")])
def test_sweep_main_is_the_references(transport, world, seed, tmp_path,
                                      monkeypatch, capsys):
    """Both mains at --iters 1: the same header and the same (Collective,
    Protocol, Bytes, World) set, with an existing file's rows of another
    world kept ("merge", the committed W 4 rows) or an old 5-column file
    regenerated ("old")."""
    ref = _ref_tool("bench_emulator")
    name = SWEEPS[transport]
    ref_dir, port_dir = tmp_path / "ref" / "accl_log", tmp_path / "port"
    for d in (ref_dir, port_dir):
        d.mkdir(parents=True)
        if seed == "merge":
            lines = (LOG / name).read_text().splitlines(keepends=True)
            (d / name).write_text(lines[0] + "".join(
                ln for ln in lines[1:] if ln.rstrip().endswith(",4")))
        else:
            (d / name).write_text(OLD_HEADER + "allreduce,eager,1024,1e-4,"
                                  "0.01\n")
    monkeypatch.setattr(ref, "REPO", tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["bench_emulator.py", "-n", str(world),
                                      "--iters", "1", "--transport",
                                      transport])
    ref.main()
    assert bench_emulator.main(["-n", str(world), "--iters", "1",
                                "--transport", transport, "--out-dir",
                                str(port_dir)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith(f"({40} new rows, "
                           f"{40 if seed == 'merge' else 0} kept)")
    assert out[1] == f"wrote {port_dir / name} (40 new rows, " \
        f"{40 if seed == 'merge' else 0} kept)"
    files = [d / name for d in (ref_dir, port_dir)]
    heads = [f.read_text().splitlines()[0] for f in files]
    assert heads[0] == heads[1] == bench_emulator.HEADER
    keys = [{(r["Collective"], r["Protocol"], r["Bytes"], r["World"])
             for r in _read(f)} for f in files]
    assert keys[0] == keys[1]
    assert {k[3] for k in keys[1]} == ({str(world), "4"} if seed == "merge"
                                       else {str(world)})
    assert len(keys[1]) == (80 if seed == "merge" else 40)


def _ones_answer(name, count, world, rank):
    """What `call` leaves in the rank's result on the ones operands:
    W at a reduction's receivers, ones wherever a mover delivers; None
    where the rank receives nothing."""
    if name in ("allreduce", "reduce_scatter"):
        return np.full(count, world, np.float32)
    if name == "reduce":
        return np.full(count, world, np.float32) if rank == 0 else None
    if name == "gather":
        return np.ones(count * world, np.float32) if rank == 0 else None
    if name in ("allgather", "alltoall"):
        return np.ones(count * world, np.float32)
    return np.ones(count, np.float32)  # bcast (in place), scatter


@pytest.mark.parametrize("world", [2, 3])
def test_call_gives_the_ones_answer(world):
    w = EmuWorld(world, max_eager=bench_emulator.MAX_EAGER,
                 rx_buf_bytes=bench_emulator.RX_BUF,
                 max_rndzv=bench_emulator.MAX_RNDZV, transport="local")
    try:
        for nbytes in bench_emulator.SIZES[:2]:
            count = nbytes // 4
            for name in bench_emulator.COLLECTIVES:
                def body(rank, i, _name=name):
                    x, out = bench_emulator.operands(_name, count, world, i)
                    bench_emulator.call(rank, _name, count, x, out)
                    return (x if _name == "bcast" else out).numpy()

                outs = w.run(body, timeout_s=60)
                for i, got in enumerate(outs):
                    want = _ones_answer(name, count, world, i)
                    if want is not None:
                        assert np.array_equal(got, want), (name, nbytes, i)
    finally:
        w.close()


# ---------------------------------------------------------------------------
# rt_stats_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,nbytes,world,transport,iters,shape",
                         [("allreduce", 4096, 2, "local", 2, ""),
                          ("allgather", 65536, 4, "tcp", 5, "logp")])
def test_rt_stats_child_is_the_references(name, nbytes, world, transport,
                                          iters, shape):
    """One child of each package on the same config, side by side: equal
    span counts, drops, retcodes and counter keys."""
    ref = _ref_tool("rt_stats_sweep")
    emu_device.load_native()
    env = dict(os.environ, ACCL_RT_TRACE="1")
    if shape:
        env["ACCL_RT_SHAPE"] = shape
    args = [name, str(nbytes), str(world), transport, str(iters)]
    procs = [subprocess.Popen([sys.executable, "-c", child, str(root),
                               *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for child, root in ((ref.CHILD, REPO),
                                 (rt_stats_sweep.CHILD,
                                  rt_stats_sweep.ROOT))]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        reports.append(json.loads(out.strip().splitlines()[-1]))
    want, got = reports
    # one span a call a rank: the barrier and the timed calls
    assert got["spans"] == want["spans"] == world * (iters + 1)
    assert got["span_dropped"] == want["span_dropped"] == 0
    assert got["retcodes"] == want["retcodes"] == [0]
    assert [sorted(s) for s in got["stats"]] == \
        [sorted(s) for s in want["stats"]]
    assert len(got["stats"]) == world
    assert got["seconds"] > 0


FAKE_REPORT = {"seconds": 1.25e-3,
               "stats": [{"passes": 7, "parks": 3, "park_ns": 1_500_000,
                          "seek_hit": 5, "seek_miss": 2},
                         {"passes": 9, "parks": 1, "park_ns": 250_000,
                          "seek_hit": 4, "seek_miss": 0}],
               "spans": 4, "span_dropped": 0, "retcodes": [0]}


@pytest.mark.parametrize("shape", ["", "ring", "logp"])
def test_rt_stats_rows_and_csv_are_the_references(shape, tmp_path,
                                                  monkeypatch, capsys):
    """With subprocess.run returning one fixed report: equal run_config
    rows and byte-equal CSVs; the port's child environment carries the
    trace and shape levers, and ACCL_RT_SHAPE never reaches this
    process."""
    ref = _ref_tool("rt_stats_sweep")
    emu_device.load_native()  # the parent's build, before run is patched
    envs = []

    def fake_run(cmd, env=None, **kw):
        envs.append(env)
        return subprocess.CompletedProcess(
            cmd, 0, "noise\n" + json.dumps(FAKE_REPORT) + "\n", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.delenv("ACCL_RT_SHAPE", raising=False)
    configs = [(n, b, 4, "tcp", 3) for n in ("allreduce", "allgather")
               for b in (4096, 1 << 20)]
    for cfg in configs:
        assert rt_stats_sweep.run_config(*cfg, shape=shape) == \
            ref.run_config(*cfg, shape=shape)
    out = tmp_path / "port" / "rt.csv"
    assert rt_stats_sweep.main(
        ["--out", str(out), "--worlds", "4", "--iters", "3",
         "--collectives", "allreduce,allgather", "--sizes", "4096,1048576",
         *(["--shape", shape] if shape else [])]) == 0
    assert "ACCL_RT_SHAPE" not in os.environ
    port_envs = envs[-len(configs):]
    assert all(e["ACCL_RT_TRACE"] == "1" for e in port_envs)
    assert all(e.get("ACCL_RT_SHAPE") == (shape or None) for e in port_envs)
    # the reference's main sets ACCL_RT_SHAPE in its own environment:
    # monkeypatch restores it
    monkeypatch.setenv("ACCL_RT_SHAPE", "unset")
    monkeypatch.delenv("ACCL_RT_SHAPE")
    (tmp_path / "ref" / "accl_log").mkdir(parents=True)
    monkeypatch.setattr(ref, "REPO", tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", [
        "rt_stats_sweep.py", "--out", "rt.csv", "--worlds", "4", "--iters",
        "3", "--collectives", "allreduce,allgather", "--sizes",
        "4096,1048576", *(["--shape", shape] if shape else [])])
    ref.main()
    assert out.read_bytes() == \
        (tmp_path / "ref" / "accl_log" / "rt.csv").read_bytes()
    assert capsys.readouterr().out.splitlines()[0] == \
        f"wrote {out} ({len(configs)} rows)"
    header = out.read_text().splitlines()[0].split(",")
    assert header == rt_stats_sweep.HEADER and len(header) == 13


def test_rt_stats_failed_child_exits_one(tmp_path, monkeypatch):
    emu_device.load_native()
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "boom"))
    out = tmp_path / "rt.csv"
    assert rt_stats_sweep.main(["--out", str(out), "--worlds", "2",
                                "--collectives", "bcast", "--sizes",
                                "4096"]) == 1
    assert out.read_text().splitlines() == [",".join(rt_stats_sweep.HEADER)]


# ---------------------------------------------------------------------------
# timing_model
# ---------------------------------------------------------------------------


def _same(a, b, path=""):
    """Key-for-key equality, floats within 1e-12 relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), path
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _models(tmp_path, monkeypatch, profile=True):
    """The reference's and the port's model on tmp copies of the committed
    sweeps (and profile)."""
    ref = _ref_tool("timing_model")
    ref_log, port_dir = tmp_path / "ref" / "accl_log", tmp_path / "port"
    for d in (ref_log, port_dir):
        d.mkdir(parents=True)
        for name in (*SWEEPS.values(), "profile.csv"):
            shutil.copy(LOG / name, d / name)
    monkeypatch.setattr(ref, "REPO", tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["timing_model.py"])
    assert ref.main() == 0
    out = port_dir / "model.json"
    argv = ["--sweep-dir", str(port_dir), "--out", str(out)]
    if profile:
        argv += ["--profile", str(port_dir / "profile.csv")]
    assert timing_model.main(argv) == 0
    return (json.loads((ref_log / "timing_model.json").read_text()),
            json.loads(out.read_text()), out)


def test_timing_model_is_the_references(tmp_path, monkeypatch, capsys):
    want, got, out = _models(tmp_path, monkeypatch)
    assert want["source"] == "accl_log/emu_bench.csv"
    assert got["source"] == str(tmp_path / "port" / "emu_bench.csv")
    assert want["tpu_tier"]["note"] != got["tpu_tier"]["note"] == \
        timing_model.TIER_NOTE
    for m in (want, got):
        del m["source"], m["tpu_tier"]["note"]
    _same(got, want)
    lines = capsys.readouterr().out.splitlines()
    n = len(got["link_per_collective"])
    assert len(lines) == 2 * n + 4
    assert lines[:n] == lines[n + 2:2 * n + 2]  # the per-collective links
    assert lines[n + 1] == lines[2 * n + 3]  # the crossovers
    assert lines[2 * n + 2].endswith(f"-> {out}")


def test_timing_model_without_profile_has_no_tier(tmp_path, monkeypatch):
    want, got, _ = _models(tmp_path, monkeypatch, profile=False)
    assert want["tpu_tier"] is not None and got["tpu_tier"] is None
    for m in (want, got):
        del m["source"], m["tpu_tier"]
    _same(got, want)


def test_timing_model_needs_a_sweep(tmp_path, capsys):
    assert timing_model.main(["--sweep-dir", str(tmp_path)]) == 1
    assert "bench_emulator" in capsys.readouterr().err


SYNTHETIC_PROFILE = (
    "Test,Bytes,Seconds,GBps,Regime\n"
    "combine_sum_fp32,1024,1.0e-09,1024.0,noise\n"
    "combine_sum_fp32,1073741824,3.6e-03,298.3,stream\n"
    "allreduce_w1_dispatch_datapath_fp32,4096,2.0e-04,0.02,latency\n"
    "allreduce_w1_dispatch_datapath_fp32,262144,2.1e-04,1.2,latency\n"
    "allreduce_w1_dispatch_datapath_fp32,16777216,2.5e-04,67.0,latency\n")


@pytest.mark.parametrize("which", ["synthetic", "committed", "missing"])
def test_tpu_tier_is_the_references(which, tmp_path):
    ref = _ref_tool("timing_model")
    path = tmp_path / "profile.csv"
    if which == "synthetic":
        path.write_text(SYNTHETIC_PROFILE)
    elif which == "committed":
        shutil.copy(LOG / "profile.csv", path)
    want, got = ref.tpu_tier(path), timing_model.tpu_tier(path)
    if which == "missing":
        assert want is None and got is None
        return
    assert got["note"] == timing_model.TIER_NOTE
    del want["note"], got["note"]
    _same(got, want)
    assert got["projected_crossovers"]["world"] == 8


def test_autotune_applies_the_tiers_registers(tmp_path, monkeypatch):
    """ACCL.autotune(tier="tpu") on the tool's output applies the
    registers derived by hand from the tier's link."""
    _, model, out = _models(tmp_path, monkeypatch)
    t = model["tpu_tier"]
    link = LinkParams(alpha=t["dispatch_alpha_us"] * 1e-6,
                      beta=t["hbm_stream_gbps"] * 1e9)
    want = TuningParams.from_crossovers(tuning_crossovers(link, world=8))
    accl = ACCL(device=GPUDevice(8, "cpu"))
    got = accl.autotune(tier="tpu", timing_model_path=out)
    assert vars(got) == vars(want)
    assert vars(accl.cclo.tuning()) == vars(want)
    assert vars(want) != vars(TuningParams.default())
    bare = tmp_path / "bare.json"
    assert timing_model.main(["--sweep-dir", str(tmp_path / "port"),
                              "--out", str(bare)]) == 0
    with pytest.raises(ValueError, match="accl_tpu_torch.tools.timing_model"):
        ACCL(device=GPUDevice(8, "cpu")).autotune(tier="tpu",
                                                  timing_model_path=bare)
