"""The port's lint gate against the reference's, over the lint corpus.

Every tools/lint_corpus/ fixture of kind "sequence" is linted by the
port's SequenceLinter and by the reference's at their default tiers
(validate, the dataflow hazards, then the semantic certifier over the
fixture's default plans; the reference with `use_pallas_ring=False`):
both give the same diagnostics, which include the fixture's expected
codes. Through each package's corpus runner, deep off and on, the
sequence fixtures give the same diagnostics too. Then the wiring the
reference's TestLinterWiring pins: the default tier runs the semantic
pass, warnings do not skip it, its ACCL50x codes are errors, and a
batch whose plan drops contributions is rejected with the reference's
code at the facade. Then the gate through the port's facade: the
diagnostics' fields match the reference's, with `lint="deep"` as with
the default tier.
"""

import json
import pathlib

import pytest

import accl_tpu.constants as ref_c
import accl_tpu_torch.constants as port_c
from accl_tpu.analysis.linter import SequenceLinter as RefLinter
from accl_tpu.descriptor import CallOptions as RefOpts
from accl_tpu.sequencer.plan import select_algorithm
from accl_tpu_torch import ACCL
from accl_tpu_torch.analysis import corpus, semantics
from accl_tpu_torch.analysis.diagnostics import CODES, enforce, make
from accl_tpu_torch.analysis.linter import SequenceLinter
from accl_tpu_torch.descriptor import CallOptions
from accl_tpu_torch.errors import LintError

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "lint_corpus"
FIXTURES = sorted(
    p for p in CORPUS.glob("*.json")
    if json.loads(p.read_text()).get("kind", "sequence") == "sequence")


def _step(c, cls, d: dict):
    """A fixture step as `cls` (either package's CallOptions), with the
    corpus tool's field rules (tools/accl_lint.py `_step_from_dict`)."""
    fn = d.get("function", 0)
    if isinstance(fn, str):
        fn = int(c.ReduceFunction[fn])
    dt = d.get("dtype", "float32")
    data_type = c.DataType[dt] if isinstance(dt, str) else c.DataType(dt)
    cp = d.get("compress")
    compress = (c.DataType[cp] if isinstance(cp, str) else c.DataType(cp)
                ) if cp is not None else c.DataType.none
    flags = (c.CompressionFlags.ETH_COMPRESSED
             if compress not in (c.DataType.none, data_type)
             else c.CompressionFlags.NO_COMPRESSION)
    return cls(
        scenario=c.Operation[d["op"]],
        count=int(d.get("count", 0)),
        comm_addr=int(d.get("comm", 0)),
        root_src_dst=int(d.get("root", d.get("root_src_dst", 0))),
        function=int(fn),
        tag=int(d.get("tag", c.TAG_ANY)),
        addr_0=int(d.get("addr_0", 0)),
        addr_1=int(d.get("addr_1", 0)),
        addr_2=int(d.get("addr_2", 0)),
        data_type=data_type,
        compress_dtype=compress,
        compression_flags=flags,
        live_ranks=tuple(int(r) for r in d.get("live_ranks", ())),
    )


def _ref_plan(opts, world):
    return select_algorithm(
        opts.scenario, opts.count, ref_c.dtype_nbytes(opts.data_type), world,
        opts.compression_flags, opts.stream_flags,
        max_eager_size=ref_c.DEFAULT_MAX_EAGER_SIZE,
        eager_rx_buf_size=ref_c.DEFAULT_EAGER_RX_BUF_SIZE,
        tuning=ref_c.TuningParams.default(ref_c.DEFAULT_MAX_RENDEZVOUS_SIZE),
        compress_dtype=opts.compress_dtype, live_ranks=opts.live_ranks)


def test_corpus_has_the_sequence_fixtures():
    assert len(FIXTURES) == 18


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_default_tier_codes_match_reference(path):
    fx = json.loads(path.read_text())
    world = int(fx.get("world", 4))
    widths = None
    if "buffer_widths" in fx:
        widths = {int(k, 0): int(v) for k, v in fx["buffer_widths"].items()}
    port_steps = [_step(port_c, CallOptions, d) for d in fx["steps"]]
    ref_steps = [_step(ref_c, RefOpts, d) for d in fx["steps"]]
    got = SequenceLinter(world).lint(
        port_steps, [corpus.default_plan(o, world) for o in port_steps],
        buffer_widths=widths)
    plans = [_ref_plan(o, world) for o in ref_steps]
    want = RefLinter(world, use_pallas_ring=False).lint(
        ref_steps, plans, buffer_widths=widths)
    assert [(d.code, d.step, d.message) for d in got] == [
        (d.code, d.step, d.message) for d in want]
    assert set(fx["expect"]) <= {d.code for d in got}
    if fx["expect"] == []:
        assert got == []


def test_codes_table_and_enforce_modes():
    """The code table is the reference's; enforce raises on errors only
    under "error", logs under "warn", and does nothing under "off"."""
    from accl_tpu.analysis.diagnostics import CODES as REF_CODES

    assert CODES == REF_CODES
    war = make("ACCL102", "an unordered overwrite", step=1)
    raw = make("ACCL101", "a stale tail", step=2)
    assert str(raw) == "ACCL101 raw-hazard [step 2]: a stale tail"
    enforce([war], "error")  # a warning alone never raises
    with pytest.raises(LintError) as e:
        enforce([war, raw], "error")
    assert e.value.codes == ("ACCL102", "ACCL101")
    enforce([war, raw], "warn")
    enforce([war, raw], "off")
    with pytest.raises(KeyError):
        make("ACCL999", "no such code")
    with pytest.raises(ValueError):
        enforce([], "strict")


@pytest.mark.parametrize("deep", [False, True], ids=["default", "deep"])
@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_corpus_runner_matches_reference(path, deep):
    from tools.accl_lint import lint_fixture as ref_lint_fixture

    fx = json.loads(path.read_text())
    got = corpus.lint_fixture(fx, deep=deep)
    want = ref_lint_fixture(fx, deep=deep)
    assert [(d.code, d.step, d.message) for d in got] == [
        (d.code, d.step, d.message) for d in want]
    assert corpus.fixture_ok(fx, got)


def _wiring_batch(world=4):
    steps = [CallOptions(scenario=port_c.Operation.allreduce, count=16,
                         root_src_dst=0,
                         function=int(port_c.ReduceFunction.SUM),
                         data_type=port_c.DataType.float32,
                         addr_0=0x10, addr_2=0x20)]
    return steps, [corpus.default_plan(o, world) for o in steps]


def _spy(monkeypatch):
    calls = []
    orig = semantics.check_batch_semantics

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(semantics, "check_batch_semantics", spy)
    return calls


def test_default_tier_runs_semantics(monkeypatch):
    calls = _spy(monkeypatch)
    steps, plans = _wiring_batch()
    assert SequenceLinter(4).lint(steps, plans) == []
    assert calls  # the pass ran without deep=True
    calls.clear()
    SequenceLinter(4).lint(steps)
    assert not calls  # no plans, no semantic pass


def test_warning_predecessors_do_not_skip_semantics(monkeypatch):
    """A WAR/WAW-warned batch still dispatches under lint="error", so it
    must still get its answer certified; only error-severity
    predecessors (whose batch never ships) skip the pass."""
    calls = _spy(monkeypatch)

    def opt(scen, count, a0, a2):
        return CallOptions(scenario=scen, count=count, function=0,
                           data_type=port_c.DataType.float32,
                           addr_0=a0, addr_2=a2)

    war = [opt(port_c.Operation.copy, 16, 1, 2),
           opt(port_c.Operation.copy, 16, 3, 1)]
    diags = SequenceLinter(4).lint(
        war, [corpus.default_plan(o, 4) for o in war])
    assert [d.severity for d in diags] == ["warning"]
    assert calls, "warning-only batch skipped semantic certification"
    calls.clear()
    raw = [opt(port_c.Operation.reduce_scatter, 8, 1, 2),
           opt(port_c.Operation.bcast, 32, 2, 2)]
    diags = SequenceLinter(4).lint(
        raw, [corpus.default_plan(o, 4) for o in raw])
    assert any(d.severity == "error" for d in diags)
    assert not calls, "error-poisoned batch still ran semantics"


def test_semantic_diag_enforced_as_error(monkeypatch):
    monkeypatch.setattr(
        semantics, "check_batch_semantics",
        lambda *a, **kw: [make("ACCL501", "planted", step=0)])
    steps, plans = _wiring_batch()
    diags = SequenceLinter(4).lint(steps, plans)
    assert [d.code for d in diags] == ["ACCL501"]
    assert diags[0].severity == "error"
    with pytest.raises(LintError):
        enforce(diags, "error")
    with pytest.raises(LintError):
        enforce(diags, "deep")
    for code in ("ACCL501", "ACCL502", "ACCL503", "ACCL504"):
        assert CODES[code][1] == "error"


def test_plan_that_drops_contributions_is_rejected(monkeypatch):
    """A dense alltoall recorded through the facade, its plan swapped for
    the capacity-bounded one: the body drops every slot's tail, so the
    default tier's semantic pass rejects the batch before it is built
    (ACCL502, a missing contribution). The reference's certifier, handed
    the port's lifted DAG, reports the same diagnostics (its own lift of
    this body fails here, so its facade would skip the step)."""
    from accl_tpu.analysis import hopdag as ref_hopdag
    from accl_tpu.analysis import semantics as ref_sem
    from accl_tpu_torch.analysis import hopdag
    from accl_tpu_torch.sequencer.plan import select_algorithm

    pc = (8, 3, 7, 1)
    accl = ACCL(world=4, torch_device="cpu")
    dev = accl.cclo
    orig = dev._resolve_step
    swapped = []

    def resolve(opts, ctx, tuning=None):
        plan, prod, cons = orig(opts, ctx, tuning)
        plan = select_algorithm(
            opts.scenario, opts.count, 4, 4, opts.compression_flags,
            max_eager_size=1 << 20, eager_rx_buf_size=1 << 20,
            tuning=dev.tuning(), peer_counts=pc)
        swapped.append((opts, plan))
        return plan, prod, cons

    monkeypatch.setattr(dev, "_resolve_step", resolve)
    a, b = accl.create_buffer(32), accl.create_buffer(32)
    rec = accl.sequence()
    rec.alltoall(a, b, 8)
    with pytest.raises(LintError) as e:
        rec.run()
    got = [(d.code, d.step, d.message) for d in e.value.diagnostics]
    assert {c for c, _, _ in got} == {"ACCL502"}
    opts, plan = swapped[0]
    dag = semantics.lift_call(opts, plan, 4)
    ref_dag = ref_hopdag.from_json(hopdag.to_json(dag))
    ref_opts = RefOpts(scenario=ref_c.Operation.alltoall, count=8,
                       function=0, data_type=ref_c.DataType.float32)
    want = ref_sem.certify(ref_dag, ref_sem.collective_spec(ref_opts, 4),
                           "alltoall")
    assert [(c, m) for c, _, m in got] == [(d.code, d.message)
                                           for d in want]


def test_facade_gate_reports_the_reference_diagnostic(mesh4):
    """A mis-recorded batch fails at run() with the diagnostics the
    reference's facade reports for the same calls, under lint="deep" as
    under the default tier; a clean batch runs under both tiers."""
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu.errors import LintError as RefLintError
    from accl_tpu_torch import ReduceFunction

    errors = []
    for accl, F, err in ((RefACCL(mesh4), ref_c.ReduceFunction, RefLintError),
                         (ACCL(world=4, torch_device="cpu"), ReduceFunction,
                          LintError)):
        for lint in ("error", "deep"):
            a, b, c = (accl.create_buffer(64), accl.create_buffer(16),
                       accl.create_buffer(64))
            rec = accl.sequence(lint=lint)
            rec.reduce_scatter(a, b, 4, F.SUM)  # writes 4 of b's 16
            rec.bcast(b, 16, 0)  # reads all 16
            rec.copy(c, a, 64)  # overwrites a, which step 0 reads
            with pytest.raises(err) as e:
                rec.run()
            errors.append([(d.code, d.step, d.message)
                           for d in e.value.diagnostics])
            ok = accl.sequence(lint=lint)
            ok.reduce_scatter(a, b, 4, F.SUM).allgather(b, c, 4)
            ok.run()
    assert errors[0] == errors[1] == errors[2] == errors[3]
    assert [(c, s) for c, s, _ in errors[0]] == [("ACCL101", 1),
                                                 ("ACCL102", 2)]
