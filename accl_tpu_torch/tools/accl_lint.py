"""accl_lint: replay recorded descriptor batches through the port's static
analyzer (accl_tpu_torch/analysis/).

Counterpart of tools/accl_lint.py, with its modes, printed lines and exit
rule. Modes, combinable:

  --corpus [DIR]   replay every *.json fixture under DIR (default
                   tools/lint_corpus/): known-bad batches must be
                   rejected with their expected diagnostic codes,
                   known-good batches must come back clean
  --schedules      trace every shipping schedule family (both protocol
                   regimes, worlds 2/4/8, every root, the tunings, the
                   int8, alltoallv, synthesized, overlap, live-subset,
                   two-tier and tiered-synthesized cells: 374
                   configurations) into its hops and require zero
                   diagnostics
  --deep           force the deep tier everywhere: fixtures run the
                   exhaustive-interleaving model checker (ACCL205-207)
                   even without "deep": true, and --schedules
                   model-checks every config's hop programs over all
                   match orders on one shared budget (a truncation,
                   ACCL207, fails the gate)
  --semantic       --schedules also proves every config's contribution
                   sets equal its declared collective, strictly: a
                   schedule the lifter cannot analyze fails the gate
  --sample N       deterministically subsample the --schedules sweep to
                   ~N configs (every ceil(total/N)-th)
  --interference   the cross-program pair sweep (ACCL601-604): the nine
                   disjoint-arena families at worlds 2/4/8 must certify
                   clean from summaries alone (zero escalations), the
                   overlap, slot, steal and unliftable rows must reject
                   with exactly ACCL601, 603, 602 and 604, the recorded
                   MoE / decode / train-step programs must never give
                   ACCL604, and the "concurrent" corpus fixtures replay
  FILE...          lint individual fixture files

Exit status is 0 only when every expectation holds; without a mode it is
2, as argparse gives.

Departures from the reference's tool:
  - the slot row's footprints carry their ring slots by hand: the port's
    ring kernel holds no slots, so a `use_pallas_ring` footprint has
    none (analysis/slots.py);
  - the recorded model programs are recorded (never compiled or run) on
    a 4-rank port facade on `--device`, which is "cuda" unless "cpu" is
    asked; with no card and no `--device cpu` the tool exits non-zero.

Usage:
    python -m accl_tpu_torch.tools.accl_lint --corpus --schedules
    python -m accl_tpu_torch.tools.accl_lint --interference --corpus
    python -m accl_tpu_torch.tools.accl_lint --deep --corpus \\
        --schedules --sample 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

from ..analysis import SequenceLinter, corpus, semantics, simulate
from ..analysis.modelcheck import Budget
from ..analysis.protocol import (
    check_hops,
    rank_programs_from_hops,
    trace_schedule_hops,
)
from ..constants import (
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_MAX_EAGER_SIZE,
    DEFAULT_MAX_RENDEZVOUS_SIZE,
    TAG_ANY,
    CompressionFlags,
    DataType,
    Operation,
    ReduceFunction,
    TuningParams,
)
from ..descriptor import CallOptions
from ..sequencer.plan import select_algorithm

DEFAULT_CORPUS = corpus.CORPUS_DIR


def run_fixture_file(path: pathlib.Path,
                     deep: bool = False) -> tuple[bool, str]:
    """One fixture's verdict and its printed line (the reference's)."""
    fx = json.loads(path.read_text())
    diags = corpus.lint_fixture(fx, deep=deep)
    ok = corpus.fixture_ok(fx, diags)
    got = [d.code for d in diags]
    expect = corpus.port_expect(fx)
    expect_sem = fx.get("expect_semantic")
    if expect_sem is not None:
        got5 = sorted({c for c in got if c.startswith("ACCL5")})
        rest = [c for c in got if not c.startswith("ACCL5")]
        verdict = (f"semantic {got5 or ['clean']}"
                   + (f" + {sorted(set(rest))}" if rest else "")
                   if ok else
                   f"EXPECTED semantic {sorted(set(expect_sem))} got "
                   f"{got5} (other codes: {sorted(set(rest))})")
    elif fx.get("kind") == "concurrent":
        verdict = ((f"rejected with exactly {sorted(set(got))}"
                    if expect else "clean") if ok else
                   f"EXPECTED exactly {sorted(set(expect))} got "
                   f"{sorted(set(got))}")
    elif expect:
        missing = [c for c in expect if c not in got]
        verdict = (f"rejected with {sorted(set(got))}" if ok else
                   f"MISSED {missing} (got {sorted(set(got))})")
    else:
        verdict = "clean" if ok else f"UNEXPECTED {sorted(set(got))}"
    if expect != fx.get("expect", []):
        verdict += (f" (the reference expects {fx['expect']}: the port's "
                    "ring holds no slots)")
    detail = "".join(f"\n      {d}" for d in diags) if not ok else ""
    return ok, f"{path.name:40s} {verdict}{detail}"


def _replay(path: pathlib.Path, deep: bool = False) -> tuple[bool, str]:
    """run_fixture_file, a crashing fixture counted as a failing one."""
    try:
        return run_fixture_file(path, deep=deep)
    except Exception as e:
        return False, f"{path.name:40s} ERROR {type(e).__name__}: {e}"


def run_corpus(corpus_dir: pathlib.Path, deep: bool = False) -> bool:
    files = sorted(corpus_dir.glob("*.json"))
    if not files:
        print(f"no fixtures under {corpus_dir}", file=sys.stderr)
        return False
    ok_all = True
    n_bad = n_good = 0
    for path in files:
        ok, line = _replay(path, deep=deep)
        ok_all &= ok
        fx = json.loads(path.read_text())
        is_bad = bool(fx.get("expect")) or bool(fx.get("expect_semantic"))
        n_bad += is_bad
        n_good += not is_bad
        print(("  ok  " if ok else " FAIL ") + line)
    print(f"corpus: {len(files)} fixtures "
          f"({n_bad} known-bad, {n_good} known-good)")
    return ok_all


_TREES = TuningParams(
    gather_flat_tree_max_fanin=2,
    gather_flat_tree_max_count=64,
    bcast_flat_tree_max_ranks=2,
    reduce_flat_tree_max_ranks=2,
    reduce_flat_tree_max_count=64,
    allreduce_composition_max_count=1 << 30,
)
_ROOTED = (Operation.bcast, Operation.scatter, Operation.gather,
           Operation.reduce)
_SCENARIOS = (Operation.bcast, Operation.scatter, Operation.gather,
              Operation.reduce, Operation.allgather, Operation.allreduce,
              Operation.reduce_scatter, Operation.alltoall,
              Operation.barrier, Operation.send)


def schedule_configs(sample: int = 0) -> list[tuple]:
    """The sweep's configurations, row for row the reference's:
    (world, scenario, root, count, tuning name, tuning, wire[, extra]),
    the extra one of ("a2av", peer_counts), ("olap", stripes),
    ("live", ranks), ("hier", topology, tier wires, stripes) and
    ("synth_tier", topology)."""
    default = TuningParams.default(DEFAULT_MAX_RENDEZVOUS_SIZE)
    tunings = {"default": default, "trees": _TREES}
    configs: list[tuple] = []
    for world in (2, 4, 8):
        for scen in _SCENARIOS:
            for root in (range(world) if scen in _ROOTED else (0,)):
                for count in (16, 100_000):
                    for tname, tuning in tunings.items():
                        if scen == Operation.barrier and count != 16:
                            continue
                        configs.append((world, scen, root, count, tname,
                                        tuning, DataType.none))
        # the quantized-wire cells: the int8 ring variants and the
        # pairwise exchange (encode-once at 8192, per hop at 16)
        for scen in (Operation.allreduce, Operation.reduce_scatter,
                     Operation.allgather, Operation.alltoall):
            for count in (16, 8192):
                configs.append((world, scen, 0, count, "default", default,
                                DataType.int8))
        # the capacity-bounded alltoallv, uniform and heterogeneous
        for count, pattern in ((300, "uniform"), (1024, "hetero")):
            if pattern == "uniform":
                pc = (max(count // 2, 1),) * world
            else:
                pc = tuple(max(count // (i + 1), 1) for i in range(world))
            for wire in (DataType.none, DataType.int8):
                configs.append((world, Operation.alltoall, 0, count,
                                "default", default, wire, ("a2av", pc)))
        # payloads inside the library entries' windows, the synth
        # registers maxed (cells no entry serves keep the hand-written
        # plan and stay valid rows)
        synth = TuningParams(synth_allreduce_max_count=1 << 22,
                             synth_allgather_max_count=1 << 22,
                             synth_reduce_scatter_max_count=1 << 22)
        for scen, count, wire in (
                (Operation.allreduce, 1024, DataType.none),
                (Operation.allreduce, 1024, DataType.int8),
                (Operation.reduce_scatter, 1024, DataType.none),
                (Operation.allgather, 65536, DataType.none)):
            configs.append((world, scen, 0, count, "synth", synth, wire))
        # the register-selected stripe-overlapped allreduce, its depth
        # pinned per cell
        olap = TuningParams(overlap_min_count=1)
        for count, stripes in ((64, 2), (4096, 4)):
            configs.append((world, Operation.allreduce, 0, count, "olap",
                            olap, DataType.none, ("olap", stripes)))
        # the degraded live-subset allreduce: all but one, and a half
        for count in (16, 8192):
            for lr in sorted({
                    tuple(r for r in range(world) if r != world - 1),
                    tuple(range(max(world // 2, 1)))}):
                configs.append((world, Operation.allreduce, 0, count,
                                 "live", default, DataType.none,
                                 ("live", lr)))
    # the striped two-tier composition on every factoring, two depths and
    # the three tier-wire pairs (the MIN register at 1 opens every size)
    hier = TuningParams(hier_allreduce_min_count=1)
    for world, factorings in ((4, ((2, 2),)), (8, ((2, 4), (4, 2)))):
        for L, P in factorings:
            for count, stripes in ((64, 1), (8192, 2)):
                for tw in ((DataType.none, DataType.none),
                           (DataType.none, DataType.int8),
                           (DataType.float16, DataType.none)):
                    configs.append((world, Operation.allreduce, 0, count,
                                    "hier", hier, DataType.none,
                                    ("hier", (L, P), tw, stripes)))
    # the tiered library entries, selected by the in-window arbitration
    for world, topo, count in ((8, (2, 4), 8192), (8, (2, 4), 65536)):
        configs.append((world, Operation.allreduce, 0, count, "synth_tier",
                        hier, DataType.none, ("synth_tier", topo)))
    if sample and sample < len(configs):
        # every ceil(total/sample)-th: stable across runs, every family
        stride = -(-len(configs) // sample)
        configs = configs[::stride]
    return configs


def config_call(cfg: tuple):
    """One sweep configuration's CallOptions and Plan, through the real
    selection path, with the reference's asserts on what it selects."""
    from ..sequencer.timing import ComputeFit, LinkParams, TierLinks

    world, scen, root, count, _, tuning, wire = cfg[:7]
    extra = cfg[7] if len(cfg) > 7 else (None,)
    kind, arg = extra[0], extra[1:]
    rsd = root if scen != Operation.send else 0 | ((world - 1) << 16)
    flags = (CompressionFlags.ETH_COMPRESSED if wire != DataType.none
             else CompressionFlags.NO_COMPRESSION)
    a2av = arg[0] if kind == "a2av" else ()
    live = arg[0] if kind == "live" else ()
    opts = CallOptions(scenario=scen, count=count, root_src_dst=rsd,
                       function=int(ReduceFunction.SUM),
                       data_type=DataType.float32, compress_dtype=wire,
                       compression_flags=flags, peer_counts=a2av,
                       live_ranks=live)
    kw: dict = {}
    if kind == "hier":
        # a fast-inner/slow-outer calibration (only the stripe count
        # reads it, pinned below); tiered_synth_ok=False pins the
        # composition, which the synth_tier rows' entries would displace
        kw = dict(topology=arg[0], tier_wires=arg[1], tiered_synth_ok=False,
                  tier_links=TierLinks(inner=LinkParams(2e-6, 2e9),
                                       outer=LinkParams(30e-6, 0.25e9)))
    elif kind == "synth_tier":
        # a WAN-class outer link, where the log-step tiered entries win
        kw = dict(topology=arg[0],
                  tier_links=TierLinks(inner=LinkParams(2e-6, 2e9),
                                       outer=LinkParams(300e-6, 0.25e9)))
    elif kind == "olap":
        kw = dict(overlap_link=LinkParams(600e-6, 0.3e9),
                  overlap_compute=ComputeFit(2e-3, 0.3e9))
    plan = select_algorithm(
        scen, count, 4, world, flags, max_eager_size=DEFAULT_MAX_EAGER_SIZE,
        eager_rx_buf_size=DEFAULT_EAGER_RX_BUF_SIZE, tuning=tuning,
        compress_dtype=wire, peer_counts=a2av, live_ranks=live, **kw)
    name = plan.algorithm.name
    if kind == "live":
        assert name == "EAGER_RING_RS_AG" and plan.live_ranks == live, \
            f"live-subset config did not select the masked ring: {plan}"
    elif kind == "olap":
        assert name == "EAGER_RING_RS_AG" and plan.stripes > 1, \
            f"overlap config did not stripe the ring: {plan}"
        seg = -(-count // arg[0])
        seg += (-seg) % world
        plan = dataclasses.replace(plan, stripes=arg[0], seg_count=seg,
                                   num_segments=max(-(-count // seg), 1))
    elif kind == "a2av":
        assert name == "FLAT_ALLTOALLV", \
            f"alltoallv config did not select the v-schedule: {plan}"
    elif kind == "hier":
        assert name == "HIER_RS_AR_AG", \
            f"hier config did not select the composition: {plan}"
        plan = dataclasses.replace(plan, stripes=arg[2])
    elif kind == "synth_tier":
        assert name == "SYNTHESIZED" and plan.synth_key, \
            f"synth_tier config did not arbitrate to a tiered entry: {plan}"
    return opts, plan


def run_schedules(deep: bool = False, sample: int = 0,
                  semantic: bool = False) -> bool:
    """Trace every configuration's hops once, check them
    (check_hops -> rank_programs_from_hops -> simulate), and under
    `deep` model-check them over every match order (any ACCL207 fails
    the gate: a partial sweep must never read as a clean one), under
    `semantic` certify the call strictly (UnsupportedSchedule fails
    the gate)."""
    t0 = time.monotonic()
    ok = True
    n = 0
    budget = Budget()
    for cfg in schedule_configs(sample):
        world, scen, root, count, tname, _, wire = cfg[:7]
        opts, plan = config_call(cfg)
        hops = trace_schedule_hops(opts, plan, world)
        diags = check_hops(hops, world)
        if not diags:
            programs = rank_programs_from_hops(hops, world)
            diags = simulate(programs, blocking_sends=False)
            if deep and not diags:
                diags = SequenceLinter(
                    world, budget=budget).check_interleavings(programs)
                if any(d.code == "ACCL207" for d in diags):
                    ok = False
            if semantic and not diags:
                try:
                    diags = semantics.check_batch_semantics(
                        [opts], [plan], world, strict=True)
                except semantics.UnsupportedSchedule as e:
                    ok = False
                    print(f" FAIL {scen.name} world={world} "
                          f"count={count}: certifier cannot lift: {e}")
        n += 1
        if diags:
            ok = False
            print(f" FAIL {scen.name} world={world} root={root} "
                  f"count={count} tuning={tname} wire={wire.name} "
                  f"{plan.algorithm.name}: {[str(d) for d in diags]}")
    dt = time.monotonic() - t0
    print(f"schedules: {n} (scenario, world, root, size, tuning, wire) "
          f"configurations interpreted"
          + (" + model-checked" if deep else "")
          + (" + semantically certified" if semantic else "") + " "
          + ("clean" if ok else "WITH DEFECTS") + f" in {dt:.1f}s")
    return ok


_FAMILIES = (
    ("allreduce", [dict(op="allreduce", count=4096)]),
    ("quantized", [dict(op="allreduce", count=8192, compress="int8")]),
    ("rs_ag", [dict(op="reduce_scatter", count=1024),
               dict(op="allgather", count=1024)]),
    ("alltoall", [dict(op="alltoall", count=512)]),
    ("alltoallv", [dict(op="alltoall", count=300)]),
    ("bcast_gather", [dict(op="bcast", count=256),
                      dict(op="gather", count=256)]),
    ("hier", [dict(op="allreduce", count=8192)]),
    ("decode_like", [dict(op="copy", count=64),
                     dict(op="allreduce", count=64),
                     dict(op="combine", count=64)]),
    ("train_like", [dict(op="copy", count=2048),
                    dict(op="allreduce", count=2048),
                    dict(op="combine", count=2048)]),
)


def _arena_steps(rows: list, base: int) -> list:
    """Descriptors of `rows` over fresh addresses from `base` up."""
    steps = []
    nxt = base
    for row in rows:
        d = dict(row)
        for key in ("addr_0", "addr_1", "addr_2"):
            if key != "addr_1" or d["op"] == "combine":
                nxt += 0x100000
                d[key] = nxt
        steps.append(corpus.step_from_dict(d))
    return steps


def model_footprints(device: str) -> list:
    """The recorded moe / moe2 / decode / train programs' footprints on a
    4-rank facade on `device`, at the reference tool's widths (recorded
    only: nothing compiles or runs)."""
    import numpy as np
    import torch

    from .. import ACCL
    from ..analysis.interference import footprint_from_steps
    from ..models import moe as moe_mod
    from ..models import transformer as trf

    accl = ACCL(world=4, torch_device=device)

    def footprint(rec, label: str):
        fp = footprint_from_steps(rec.calls, accl.world,
                                  persistent=rec._persistent, label=label)
        rec._ran = True  # recorded for its footprint, never run
        return fp

    fps = []
    for tag in ("moe", "moe2"):
        disp, mid, out = (accl.create_buffer(1024, torch.float32)
                          for _ in range(3))
        seq = accl.sequence()
        seq.alltoall(disp, mid, 128, res_stream=moe_mod.MOE_EXPERT_STREAM)
        seq.alltoall(mid, out, 128)
        fps.append(footprint(seq, tag))
    cfg = trf.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64)
    params = trf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    rec, _ = trf.record_decode_step(accl, cfg, params, batch=2, max_len=8)
    fps.append(footprint(rec, "decode"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (accl.world, 1, 8)).astype(np.int32)
    rec, _ = trf.record_train_step(accl, cfg, tokens,
                                   np.roll(tokens, -1, axis=2))
    fps.append(footprint(rec, "train"))
    return fps


def run_interference(device: str = "cuda") -> bool:
    """The cross-program pair sweep: (1) the disjoint-arena families
    certify clean from summaries alone, zero escalations; (2) the
    adversarial rows reject with their exact codes; (3) the recorded
    model programs never give ACCL604; (4) the "concurrent" corpus
    fixtures replay."""
    from ..analysis.interference import (
        InterferenceCertifier,
        footprint_from_rank_programs,
        footprint_from_steps,
    )
    from ..analysis.protocol import recv, send

    t0 = time.monotonic()
    ok = True

    # -- 1. disjoint arenas: summaries alone, no escalation
    n_pairs = 0
    for world in (2, 4, 8):
        certifier = InterferenceCertifier()
        fps = []
        for i, (name, rows) in enumerate(_FAMILIES):
            steps = _arena_steps(rows, 0x10000000 * (i + 1))
            plans = tuple(corpus.default_plan(o, world) for o in steps)
            fps.append(footprint_from_steps(steps, world, plans=plans,
                                            label=f"{name}@{world}"))
        for fp in fps:
            if fp.unliftable is not None:
                ok = False
                print(f" FAIL {fp.label}: unliftable footprint "
                      f"({fp.unliftable})")
        diags = certifier.certify(fps)
        n_pairs += certifier.pairs_checked
        for d in diags:
            ok = False
            print(f" FAIL disjoint sweep world={world}: {d}")
        if certifier.escalations:
            ok = False
            print(f" FAIL disjoint sweep world={world}: "
                  f"{certifier.escalations} escalations (summary-only "
                  "fast path violated)")

    # -- 2. adversarial rows: exact codes
    def expect_exact(title: str, fps, codes: set) -> None:
        nonlocal ok
        got = {d.code for d in InterferenceCertifier().certify(fps)}
        if got != codes:
            ok = False
            print(f" FAIL {title}: expected exactly {sorted(codes)}, "
                  f"got {sorted(got)}")

    world = 4

    def mk(steps, label):
        return footprint_from_steps(
            steps, world,
            plans=tuple(corpus.default_plan(o, world) for o in steps),
            label=label)

    a = mk(_arena_steps([dict(op="allreduce", count=256)], 0x10000000), "A")
    b = mk(_arena_steps([dict(op="allreduce", count=256)], 0x20000000), "B")
    shared = mk(_arena_steps([dict(op="allreduce", count=256)],
                             0x10000000), "B")
    expect_exact("overlap pair", [a, shared], {"ACCL601"})
    # the port's ring holds no slots: the pair's slots are given by hand
    expect_exact("slot pair", [
        dataclasses.replace(a, ring_slots=frozenset({0}),
                            signature=a.signature + "s"),
        dataclasses.replace(b, ring_slots=frozenset({0}),
                            signature=b.signature + "s")], {"ACCL603"})
    steal_a = footprint_from_rank_programs(
        [[recv(1, TAG_ANY, 4)], [send(0, 3, 4)]], 2, label="A")
    steal_b = footprint_from_rank_programs(
        [[recv(1, 9, 4)], [send(0, 9, 4)]], 2, label="B")
    expect_exact("steal pair", [steal_a, steal_b], {"ACCL602"})
    broken = footprint_from_steps([object()], world, label="broken")
    expect_exact("unliftable pair", [a, broken], {"ACCL604"})

    # -- 3. the recorded model programs
    model_fps = model_footprints(device)
    certifier = InterferenceCertifier()
    for i, fa in enumerate(model_fps):
        for fb in model_fps[i + 1:]:
            codes = sorted({d.code for d in certifier.check_pair(fa, fb)})
            n_pairs += 1
            if "ACCL604" in codes:
                ok = False
                print(f" FAIL {fa.label} x {fb.label}: ACCL604 — a "
                      "shipped program family must be liftable")
            print(f"  {fa.label:8s} x {fb.label:8s} "
                  + ("clean" if not codes else str(codes)))

    # -- 4. the "concurrent" corpus fixtures
    n_corpus = 0
    for path in sorted(DEFAULT_CORPUS.glob("*.json")):
        if json.loads(path.read_text()).get("kind") != "concurrent":
            continue
        fok, line = _replay(path)
        n_corpus += 1
        ok &= fok
        print(("  ok  " if fok else " FAIL ") + line)

    dt = time.monotonic() - t0
    print(f"interference: {n_pairs} pairs certified across the family "
          f"sweep, adversarial rows and recorded model programs, "
          f"{n_corpus} concurrent corpus fixtures replayed "
          + ("clean" if ok else "WITH DEFECTS") + f" in {dt:.1f}s")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", nargs="?", const=str(DEFAULT_CORPUS),
                    default=None, metavar="DIR",
                    help="replay the fixture corpus (default "
                         "tools/lint_corpus/)")
    ap.add_argument("--schedules", action="store_true",
                    help="interpret every shipping schedule and require "
                         "it clean")
    ap.add_argument("--deep", action="store_true",
                    help="force the exhaustive-interleaving tier on "
                         "fixtures and --schedules (ACCL205-207)")
    ap.add_argument("--semantic", action="store_true",
                    help="semantically certify every --schedules config "
                         "against its declared collective "
                         "(ACCL501-504, strict)")
    ap.add_argument("--sample", type=int, default=0, metavar="N",
                    help="deterministically subsample --schedules to "
                         "~N configurations")
    ap.add_argument("--interference", action="store_true",
                    help="cross-program pair sweep (ACCL601-604)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --interference records the model "
                         "programs' facade (default: the card)")
    ap.add_argument("files", nargs="*", help="individual fixture files")
    args = ap.parse_args(argv)
    if not (args.corpus or args.schedules or args.interference
            or args.files):
        ap.error("nothing to do: pass --corpus, --schedules, "
                 "--interference, or files")
    from ..utils.cli import require_device

    device = require_device(args.device)
    ok = True
    if args.corpus:
        ok &= run_corpus(pathlib.Path(args.corpus), deep=args.deep)
    if args.schedules:
        ok &= run_schedules(deep=args.deep, sample=args.sample,
                            semantic=args.semantic)
    if args.interference:
        ok &= run_interference(device)
    for f in args.files:
        fok, line = _replay(pathlib.Path(f), deep=args.deep)
        ok &= fok
        print(("  ok  " if fok else " FAIL ") + line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
