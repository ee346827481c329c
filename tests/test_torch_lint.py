"""The port's lint gate against the reference's, over the lint corpus.

Every tools/lint_corpus/ fixture of kind "sequence" is linted by the
port's SequenceLinter (the default tier: validate, then the dataflow
hazards) and by the reference's SequenceLinter at its default tier
(`deep=False`, `use_pallas_ring=False`, with the fixture's default
plans, so its semantic certifier runs too); both give the same codes,
which include the fixture's expected ones. Then the gate through the
port's facade: the diagnostics' fields match the reference's, and
`lint="deep"` raises not_ported.
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
    got = SequenceLinter(world).lint(port_steps, buffer_widths=widths)
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


def test_facade_gate_reports_the_reference_diagnostic(mesh4):
    """A mis-recorded batch fails at run() with the diagnostics the
    reference's facade reports for the same calls, and lint="deep"
    raises not_ported on the port."""
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu.errors import LintError as RefLintError
    from accl_tpu_torch import ReduceFunction

    errors = []
    for accl, F, err in ((RefACCL(mesh4), ref_c.ReduceFunction, RefLintError),
                         (ACCL(world=4, torch_device="cpu"), ReduceFunction,
                          LintError)):
        a, b, c = (accl.create_buffer(64), accl.create_buffer(16),
                   accl.create_buffer(64))
        rec = accl.sequence()
        rec.reduce_scatter(a, b, 4, F.SUM)  # writes 4 of b's 16
        rec.bcast(b, 16, 0)  # reads all 16
        rec.copy(c, a, 64)  # overwrites a, which step 0 reads, unordered
        with pytest.raises(err) as e:
            rec.run()
        errors.append([(d.code, d.step) for d in e.value.diagnostics])
    assert errors[0] == errors[1] == [("ACCL101", 1), ("ACCL102", 2)]
    with pytest.raises(NotImplementedError, match="analysis"):
        ACCL(world=4, torch_device="cpu").sequence(lint="deep")
