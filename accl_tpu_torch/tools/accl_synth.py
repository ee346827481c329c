"""accl_synth: search the hop-DAG schedule space, certify winners, and
manage the port's synthesized-schedule library
(accl_tpu_torch/sequencer/synthesized/).

Counterpart of tools/accl_synth.py, with its modes, printed lines and exit
rule. Modes:

  --search            run the synthesize -> score -> prune -> certify
                      loop for every (op, world) in --ops/--worlds
                      (plus every --tiers factoring) and print the
                      winner table (no files written)
  --export            like --search, but write every winner into the
                      library in the port's form (the spec, its window
                      and the canonical DAG's `dag_sha256`) and prune
                      in-scope entries that no longer win any cell
  --score             print the predicted synth-vs-hand-written time
                      per (world, size) cell for every committed entry
  --verify-library    re-certify every committed entry: the spec must
                      regenerate the committed DAG (its digest), the DAG
                      must pass the semantic certifier + deep model
                      checker clean, and the committed window must match
                      fresh scoring (tiered entries under the model's
                      link_tiers)

  --tiers LxP [...]   factored topologies to search (e.g. 2x4 4x4)
  --grid std|lat      the scoring grid of a flat search
  --beam N            certify only the N best predicted advantages per
                      (op, world) cell

The scoring link defaults to the port's copy of the calibrated timing
model (accl_tpu_torch/data/timing_model.json, the link ACCL.autotune
reads); --alpha-us/--beta-gbps override it. The tool computes nothing
on tensors, so it takes no --device.

Exit status is 0 only when every requested gate holds.

Usage:
    python -m accl_tpu_torch.tools.accl_synth --verify-library
    python -m accl_tpu_torch.tools.accl_synth --search --worlds 4 \\
        --ops allreduce
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..constants import Operation
from ..sequencer import synthesis
from ..sequencer.timing import LinkParams, emulator_link
from ..telemetry.feedback import MODEL_PATH, default_tier_links

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_MODEL = MODEL_PATH

OPS = {
    "allreduce": Operation.allreduce,
    "allgather": Operation.allgather,
    "reduce_scatter": Operation.reduce_scatter,
}


def _rel(path: pathlib.Path) -> pathlib.Path:
    """Repo-relative for display when possible."""
    try:
        return path.relative_to(REPO)
    except ValueError:
        return path


def load_link(args) -> LinkParams:
    if args.alpha_us is not None or args.beta_gbps is not None:
        if args.alpha_us is None or args.beta_gbps is None:
            raise SystemExit("pass both --alpha-us and --beta-gbps")
        return LinkParams(alpha=args.alpha_us * 1e-6,
                          beta=args.beta_gbps * 1e9)
    model = json.loads(pathlib.Path(args.timing_model).read_text())
    try:
        return emulator_link(model)
    except ValueError as e:
        raise SystemExit(f"{args.timing_model}: {e}") from e


def parse_tiers(specs: list[str]) -> list[tuple[int, int]]:
    out = []
    for s in specs:
        try:
            L, P = (int(x) for x in s.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--tiers wants LxP (e.g. 2x4), got {s!r}")
        out.append((L, P))
    return out


def load_tier_links(args):
    tiers = default_tier_links(args.timing_model)
    if tiers is None:
        raise SystemExit(
            f"{args.timing_model} carries no link_tiers (needed to "
            "score tiered candidates)")
    return tiers


def run_search(args, export: bool) -> bool:
    link = load_link(args)
    print(f"scoring link: alpha {link.alpha * 1e6:.2f} us, "
          f"beta {link.beta / 1e9:.3f} GB/s")
    n_winners = 0
    written: set[str] = set()
    grid = getattr(args, "grid", "std")
    if grid == "lat" and args.tiers:
        raise SystemExit("--grid lat scores flat candidates only "
                         "(tiered windows live behind the hier "
                         "register, not the latency window)")

    def keep(results) -> None:
        nonlocal n_winners
        for res in results:
            n_winners += 1
            if export:
                path = synthesis.export_entry(res)
                written.add(path.name)
                print(f"  wrote {_rel(path)}")

    for world in args.worlds:
        for op_name in args.ops:
            keep(synthesis.search(OPS[op_name], world, link, beam=args.beam,
                                  grid=grid, log=lambda m: print("  " + m)))
    tier_specs = parse_tiers(args.tiers or [])
    if tier_specs:
        tl = load_tier_links(args)
        print(f"tier links: inner alpha {tl.inner.alpha * 1e6:.1f} us "
              f"beta {tl.inner.beta / 1e9:.2f} GB/s / outer alpha "
              f"{tl.outer.alpha * 1e6:.1f} us beta "
              f"{tl.outer.beta / 1e9:.3f} GB/s")
        for L, P in tier_specs:
            keep(synthesis.search(Operation.allreduce, L * P, link,
                                  beam=args.beam, tiers=(L, P),
                                  tier_links=tl,
                                  log=lambda m: print("  " + m)))
    print(f"{n_winners} winner(s) across worlds {args.worlds} "
          f"x ops {args.ops} + tiers {args.tiers or []}")
    if export:
        # prune in-scope entries that stopped winning (verify_library
        # would otherwise fail them forever); out-of-scope entries
        # (other ops, worlds, factorings or grid) stay untouched
        op_names = {OPS[o].name for o in args.ops}
        searched_tiers = set(tier_specs)
        for p in sorted(synthesis.library_dir().glob("*.json")):
            if p.name in written:
                continue
            spec = synthesis.SynthSpec.from_json(json.loads(p.read_text()))
            in_scope = (
                (spec.tiers and tuple(spec.tiers) in searched_tiers)
                or (not spec.tiers and spec.op in op_names
                    and spec.world in args.worlds
                    and spec.grid == grid))
            if in_scope:
                p.unlink()
                print(f"  pruned {_rel(p)} "
                      "(no longer wins any cell under this link)")
        synthesis.clear_library_cache()
    return n_winners > 0


def run_score(args) -> bool:
    link = load_link(args)
    entries = synthesis.library()
    if not entries:
        print("synthesized library is empty", file=sys.stderr)
        return False
    tl = None
    if any(e.spec.tiers for e in entries.values()):
        tl = load_tier_links(args)
    print(f"{'entry':44s} {'bytes':>10s} {'synth_us':>10s} "
          f"{'hand_us':>10s}  verdict")
    for key, entry in sorted(entries.items()):
        s = entry.spec
        for nbytes in synthesis.grid_for(s):
            count = max(nbytes // 4, 1)
            if s.tiers:
                t_s = synthesis.predict_spec_tiered(tl, s, count, 4)
                t_h = synthesis.hand_written_tiered_best(
                    tl, count, 4, (s.tiers[0], s.tiers[1]))
            else:
                t_s = synthesis.predict_spec(link, s, count, 4)
                t_h = synthesis.hand_written_best(
                    link, s.scenario, count, 4, s.world, wire=s.wire)
            verdict = "WINS" if t_s < t_h else ("tie" if t_s == t_h
                                                else "loses")
            print(f"{key:44s} {nbytes:>10d} {t_s * 1e6:>10.1f} "
                  f"{t_h * 1e6:>10.1f}  {verdict}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--search", action="store_true",
                    help="run the search and print winners")
    ap.add_argument("--export", action="store_true",
                    help="run the search and (re)write the library")
    ap.add_argument("--score", action="store_true",
                    help="predicted synth-vs-hand-written per cell for "
                         "the committed library")
    ap.add_argument("--verify-library", action="store_true",
                    help="re-certify every committed entry (CI gate)")
    ap.add_argument("--worlds", type=int, nargs="+",
                    default=[2, 4, 8, 16])
    ap.add_argument("--ops", nargs="+", default=sorted(OPS),
                    choices=sorted(OPS))
    ap.add_argument("--tiers", nargs="+", default=None, metavar="LxP",
                    help="factored topologies to search, e.g. 2x4 4x4")
    ap.add_argument("--grid", default="std", choices=["std", "lat"],
                    help="scoring grid for flat searches: std = the "
                         "1 KiB-16 MiB bandwidth grid, lat = the "
                         "1-64 KiB latency grid")
    ap.add_argument("--beam", type=int, default=None,
                    help="certify only the N best predicted advantages")
    ap.add_argument("--timing-model", default=str(DEFAULT_MODEL))
    ap.add_argument("--alpha-us", type=float, default=None)
    ap.add_argument("--beta-gbps", type=float, default=None)
    args = ap.parse_args(argv)
    if not (args.search or args.export or args.score
            or args.verify_library):
        ap.error("nothing to do: pass --search, --export, --score, or "
                 "--verify-library")
    ok = True
    if args.search or args.export:
        ok &= run_search(args, export=args.export)
    if args.score:
        ok &= run_score(args)
    if args.verify_library:
        ok &= synthesis.verify_library(
            log=print, link=load_link(args),
            tier_links=default_tier_links(args.timing_model))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
