"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell is made of is found by name from its entry in
BENCHMARK.json:

- its configuration file (the entry's `file`), whose `reference` names
  the plain reference under cardbench/references/, whose `check_limits`
  hold the limit of each number that reference returns, and whose
  `weights`, where it has them, name the maker of its seeded weights
  under cardbench/weights/;
- its traffic file, cardbench/traffic/<traffic>.json, whose `driver`
  names the generator under cardbench/drivers/ that issues a step;
- each per-layer metric's reader, cardbench/metrics/<metric>.py.

The generator and the reference both get the configuration, the seed,
the shrink and the weights, so a cell of any collective, with weights of
its own, is new files and entries; nothing here needs an edit for it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

import torch

from cardbench import yardstick
from cardbench.deployments import step_messages
from cardbench.inputs import Operands, weight_seed
from cardbench.trace import TraceView

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "accl_tpu")
MIN_STEPS = 2


def _module(root: Path, kind: str, name: str):
    """cardbench/<kind>/<name>.py under `root`, loaded by its path."""
    path = root / "cardbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(spec: dict, name: str, root: Path = ROOT) -> SimpleNamespace:
    """A cell's parts, found by name."""
    work = {w["name"]: w for w in spec["workloads"]}[name]
    entry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "cardbench" / "traffic" / f"{work['traffic']}.json")
        .read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"]
                                  in e2e_names else [])]
    return SimpleNamespace(name=name, chips=work["chips"], config=config,
                           traffic=traffic, end_to_end=e2e,
                           per_layer=per_layer)


def make_weights(root: Path, cfg: dict, seed: int, device: torch.device,
                 shrink: int) -> dict[str, torch.Tensor]:
    """The configuration's seeded weights: `make(config, seed, device,
    shrink)` of cardbench/weights/<weights>.py, given the weights' own
    seed (inputs.weight_seed of `seed`). A configuration without
    `weights` has none and allocates nothing."""
    if "weights" not in cfg:
        return {}
    return _module(root, "weights", cfg["weights"]).make(
        cfg, weight_seed(seed), device, shrink)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its relatives' or
    the JAX package's (compared whole: accl_tpu_torch is not accl_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _launch_counters() -> int:
    """Sum of every `launches` counter on the program's kernel wrappers
    (any function of an accl_tpu_torch.ops module that carries one)."""
    import pkgutil

    import accl_tpu_torch.ops as ops

    total = 0
    for mod in pkgutil.iter_modules(ops.__path__):
        m = importlib.import_module(f"accl_tpu_torch.ops.{mod.name}")
        for obj in vars(m).values():
            n = getattr(obj, "launches", None)
            if callable(obj) and isinstance(n, int):
                total += n
    return total


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Window:
    """A closed loop with one client: the next step starts when the last
    completes. Before each step the operands are marked fresh; a step's
    latency runs from its first dispatch to its completion."""

    def __init__(self, driver, ops, span, recvs, hold: bool):
        self.driver, self.ops, self.span = driver, ops, span
        self.recvs, self.hold = recvs, hold
        self.held = None  # (marks, results) of the first step, if asked
        self.failed = 0
        self.attempted = 0
        self.notes: list[str] = []  # one line a window, for standard error

    def run(self, seconds: float, device: torch.device):
        """Steps for `seconds` (and at least MIN_STEPS); returns the step
        latencies and the window's wall time, first dispatch to last
        completion."""
        calls = len(self.driver.calls)
        steps: list[float] = []
        pauses: list[float] = []
        started: list[float] = []

        def on_gc(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            elif started:
                pauses.append(time.perf_counter() - started.pop())

        gc.callbacks.append(on_gc)
        w0 = end = time.perf_counter()
        while not self.failed:
            self.ops.mark()
            t0 = time.perf_counter()
            if not steps:
                w0 = t0
            try:
                with self.span("step"):
                    self.driver.step()
            except Exception:
                traceback.print_exc()
                self.failed += calls
                self.attempted += calls
                break
            end = time.perf_counter()
            steps.append(end - t0)
            self.attempted += calls
            if self.hold and self.held is None:
                self.held = (self.ops.marks, [r.device for r in self.recvs])
            if end - w0 >= seconds and len(steps) >= MIN_STEPS:
                break
        gc.callbacks.remove(on_gc)
        _sync(device)
        if steps:
            slow = sorted(steps)[-3:]
            self.notes.append(
                f"window {end - w0:.3f} s: {len(steps)} steps, median "
                f"{1e3 * statistics.median(steps):.3f} ms, slowest "
                + " ".join(f"{1e3 * t:.3f}" for t in slow)
                + f" ms; {len(pauses)} gc passes, {1e3 * sum(pauses):.3f} ms")
        return steps, end - w0


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", shrink: int = 1,
             control: bool = False, root: Path = ROOT) -> dict:
    """Run cell `name` once and return its result line (a dict). `shrink`
    divides every message, and reaches the generator, the weights and
    the reference, where a configuration's own widths shrink (the tests'
    sizes: each traffic file's `cpu_shrink` and `card_shrink`); `control`
    runs the program's bfloat16 wire in place of the exact one (the
    lower-precision control that the check has to fail).

    Untraced, the window runs `seconds`. Traced, it runs in two phases of
    at most the traffic's `trace_seconds` each: first with the program's
    tracer on (its spans, its launch counters, the replays' events, the
    step's share of the roofline), then under the profiler (the device
    timeline), so that neither instrument's cost lands in the other's
    numbers."""
    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.telemetry import get_tracer

    phases = {"import": time.perf_counter() - t_start}
    spec = load_spec(root)
    cell = load_cell(spec, name, root)
    cfg, traffic = cell.config, cell.traffic
    world = cfg["deployment"]["world"]
    counts = [max(1, n // shrink) for n in step_messages(cfg, traffic)]
    elem_bytes = 4
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def phase(label):
        phases[label] = time.perf_counter() - t_start - sum(phases.values())

    # -- set-up: the program, its buffers, the seeded operands, warm steps
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    accl = ACCL(world=world, torch_device=dev)
    phase("context")
    ops = Operands(counts, world, seed, dev)
    phase("operands")
    weights = make_weights(root, cfg, seed, dev, shrink)
    if weights:
        # made as a deployment loads its weights: in set-up and the peak
        _sync(dev)
        phase("weights")
    sends, recvs = [], []
    for n, view in zip(counts, ops.views):
        s = accl.create_buffer(n, torch.float32)
        s.device = view  # the operand is written in place of its image
        sends.append(s)
        recvs.append(accl.create_buffer(n, torch.float32))
    phase("buffers")
    profiling = [False]

    def span(label):
        if profiling[0]:
            return torch.profiler.record_function(label)
        return contextlib.nullcontext()

    drv_mod = _module(root, "drivers", traffic["driver"])
    driver = drv_mod.Driver(accl, sends, recvs, counts, traffic,
                            DataType.bfloat16 if control else None, span,
                            config=cfg, seed=seed, shrink=shrink,
                            weights=weights)
    driver.prepare()
    phase("prepare")
    hold = bool(traffic.get("check_earlier"))
    held = None
    for _ in range(traffic.get("warm_steps", 2)):
        ops.mark()
        driver.step()
        if hold and held is None:
            # the window holds its first step's results for the check, so
            # three result sets live at once there (held, placed, new):
            # hold the first warm step's through the later ones, and the
            # allocator's pool grows before the window, not inside it
            held = [r.device for r in recvs]
    _sync(dev)
    del held
    driver.replay_ns()
    phase("warm")
    win = _Window(driver, ops, span, recvs, hold)
    tracer = get_tracer()
    if trace:
        seconds = min(seconds, traffic["trace_seconds"])
        tracer.clear()
        tracer.enable()
        launches0 = _launch_counters()
        replays0 = driver.replays
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window
    steps, window_s = win.run(seconds, dev)
    view = None
    if trace:
        tracer.disable()
        ctx = SimpleNamespace(
            steps=len(steps), window_s=window_s,
            step_bytes=yardstick.step_bytes(world, counts, elem_bytes),
            spans=tracer.drain(), launches=_launch_counters() - launches0,
            replays=driver.replays - replays0, replay_ns=driver.replay_ns())
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            # the profiler warns that it keeps one cycle's events: one is
            # all it runs
            warnings.simplefilter("ignore", UserWarning)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            profiling[0] = True
            win.run(seconds, dev)
            profiling[0] = False
            prof.__exit__(None, None, None)
        ctx.trace = view = TraceView.from_profiler(prof)
        del prof
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    if trace:
        ctx.config, ctx.counts, ctx.shrink = cfg, counts, shrink
        ctx.peak_bytes = peak
        ctx.operand_bytes = world * sum(counts) * elem_bytes
        ctx.phases = phases
        metrics = {}
        for m in cell.per_layer:
            value = _module(root, "metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        sbus = yardstick.step_bus_bytes(world, counts, elem_bytes)
        values = {
            "busbw_GBps": (len(steps) * sbus / window_s / 1e9
                           if steps else None),
            "step_p95_ms": 1e3 * yardstick.p95(steps) if steps else None,
            "peak_mem_GiB": peak / yardstick.GIB if on_card else None,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end
                   if values.get(m["name"]) is not None}

    # -- the check: the program's state freed, the reference after it
    checks = [(ops.marks, [r.device for r in recvs])]
    if win.held is not None:
        checks.insert(0, win.held)
    failed, attempted, notes = win.failed, win.attempted, win.notes
    win = None
    for b in sends + recvs:
        b.device = None
    del driver, accl, sends, recvs, ops, weights
    gc.collect()
    t_check = time.perf_counter()
    ref = _module(root, "references", cfg["reference"])
    readings: dict[str, float] = {}
    # the reference's own operands and weights, made again from the seed
    regen = Operands(counts, world, seed, dev)
    weights = make_weights(root, cfg, seed, dev, shrink)
    for marks, outs in checks:
        regen.set_marks(marks)
        for key, v in ref.compare(regen.views, outs, config=cfg, seed=seed,
                                  shrink=shrink, weights=weights).items():
            readings[key] = max(readings.get(key, -math.inf), v)
    del regen, checks, weights
    phases["check"] = time.perf_counter() - t_check
    limits = cfg["check_limits"]
    if set(readings) != set(limits):
        raise ValueError(
            f"references/{cfg['reference']}.py returns {sorted(readings)}, "
            f"the configuration's check_limits hold {sorted(limits)}")
    check = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = (failed == 0 and len(steps) >= MIN_STEPS
               and all(c["value"] <= c["limit"] for c in check.values()))

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {
                  "platform": "gpu" if on_card else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": peak}}
    if view is not None:
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["phases_s"] = phases
    result["windows"] = notes
    result["check"] = check
    return result
