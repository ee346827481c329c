"""The DeepSeek-V3 MoE cell (`moe_ep_decode_t128`): on the CPU at its
traffic's `cpu_shrink`, a sound run passes and reports its metrics; the
bfloat16-wire control, the plain reference computed from TF32 operands
in the program's place, and each planted fault of
test_cardbench_runs.py fail the check; the slot-driven exchange is
built through the body every collective passes
(ScheduleCompiler._body). On the card, at `card_shrink`, the cell is
sound and both controls fail."""

import time

import pytest
import torch

from cardbench import harness
from cardbench.tests.test_cardbench_runs import FAULTS, SEED, _Fault, \
    _fails_by_far, _plant

CELL = "moe_ep_decode_t128"
SPEC = harness.load_spec()


class _ExchangeLeftOutShaped(_Fault):
    """exchange_left_out in a form that keeps each result's shape (the
    two sides of a slot-driven exchange differ in width, and a wider
    result is refused before the check): every rank keeps its own
    operand, cut or padded with zeros to the result's width."""

    name = "exchange_left_out"

    def answer(self, x, out):
        kept = torch.zeros_like(out)
        n = min(x.shape[-1], out.shape[-1])
        kept[..., :n] = x[..., :n]
        return kept


CELL_FAULTS = [_ExchangeLeftOutShaped() if f.name == "exchange_left_out"
               else f for f in FAULTS]


def _tf32(t):
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as the card's tensor cores take their operands."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


def _reference_in_tf32(monkeypatch):
    """Put in the program's place the plain reference
    (accl_tpu_torch/models/deepseek_v3_reference.py) computed in float32
    from TF32 operands: the inputs and every product's weights rounded to
    TF32 (the router's bias, added, stays float32). The check then reads
    it against float64 as it reads the program."""
    from accl_tpu_torch.models import deepseek_v3_reference as plain

    load = harness._module

    def module(root, kind, name):
        mod = load(root, kind, name)
        if kind != "references":
            return mod
        compare = mod.compare

        def in_tf32(operands, results, *, config, shrink, weights, **kw):
            D = config["hidden_size"] // shrink
            dep = config["deployment"]
            route = dict(n_group=config["n_group"],
                         topk_group=config["topk_group"],
                         top_k=config["num_experts_per_tok"],
                         routed_scaling=config["routed_scaling_factor"])
            outs = []
            for layer, x in enumerate(operands):
                w = {k: v[layer] if k == "bias" else _tf32(v[layer])
                     for k, v in weights.items()}
                y, _ = plain.layer_share(
                    _tf32(x.reshape(-1, D)), w, held_first=dep["held_first"],
                    held=dep["held_experts"], route_kw=route)
                outs.append(y.reshape(x.shape))
            return compare(operands, outs, config=config, shrink=shrink,
                           weights=weights, **kw)

        mod.compare = in_tf32
        return mod

    monkeypatch.setattr(harness, "_module", module)


def _run(*, trace=False, seed=SEED, device="cpu", control=False):
    parts = harness.load_cell(SPEC, CELL)
    key = "card_shrink" if torch.device(device).type == "cuda" else \
        "cpu_shrink"
    return harness.run_cell(CELL, seed, 0.05, trace,
                            t_start=time.perf_counter(), device=device,
                            shrink=parts.traffic[key], control=control)


def test_a_sound_run_passes_and_reports_its_metrics():
    res = _run()
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and "weights" in res["phases_s"]
    assert set(res["metrics"]) == {"step_p95_ms", "setup_s"}
    assert set(res["check"]) == {"moe_err_u", "near_tie_share"}


def test_a_traced_run_reports_the_routing_counters():
    res = _run(trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    # the two kernel rooflines read the device timeline: not on the CPU
    assert set(got) == {"moe_moved_rows_per_step", "expert_load_skew"}
    assert got["moe_moved_rows_per_step"]["value"] > 0
    assert got["expert_load_skew"]["value"] >= 1.0


def test_the_bfloat16_control_fails_by_far():
    assert _fails_by_far(_run(control=True))


def test_the_tf32_products_control_fails(monkeypatch):
    _reference_in_tf32(monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["moe_err_u"]["value"] > 10 * \
        res["check"]["moe_err_u"]["limit"]


@pytest.mark.parametrize("fault", CELL_FAULTS, ids=lambda f: f.name)
def test_a_fault_in_the_timed_path_fails_the_cell(fault, monkeypatch):
    _plant(fault, monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["moe_err_u"]["value"] > \
        res["check"]["moe_err_u"]["limit"]


def test_the_counted_exchange_is_built_through_the_schedule_body(
        monkeypatch):
    from accl_tpu_torch.sequencer.lowering import ScheduleCompiler

    seen = []
    body_of = ScheduleCompiler._body

    def spy(self, options, plan, arithcfg):
        seen.append(options.row_layout)
        return body_of(self, options, plan, arithcfg)

    monkeypatch.setattr(ScheduleCompiler, "_body", spy)
    assert _run()["correct"] is True
    modes = [lay.mode for lay in seen if lay is not None]
    layers = harness.load_cell(SPEC, CELL).config["num_hidden_layers"]
    assert modes.count("scatter") == modes.count("gather") == layers


@pytest.mark.card
def test_on_the_card_the_cell_is_sound_and_its_control_fails(card,
                                                             monkeypatch):
    for seed in (SEED, SEED + 1):
        assert _run(seed=seed, device=card)["correct"]
        assert _fails_by_far(_run(seed=seed, device=card, control=True))
    _reference_in_tf32(monkeypatch)
    res = _run(device=card)
    assert res["correct"] is False
    assert res["check"]["moe_err_u"]["value"] > 10 * \
        res["check"]["moe_err_u"]["limit"]
