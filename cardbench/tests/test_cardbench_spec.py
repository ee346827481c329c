"""BENCHMARK.json against the benchmark's contract, and the configurations
against the deployments they state."""

import json
import re
from pathlib import Path

import pytest

from cardbench.deployments import MIB, ddp_buckets, decoder_params, step_messages

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def _config(name):
    entry = {c["name"]: c for c in SPEC["configs"]}[name]
    return json.loads((ROOT / entry["file"]).read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 24  # what later PRs may grow to
    runs = 2 + 14 * cells
    assert runs * (SPEC["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_entry_keys():
    seen = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_configs_and_cells():
    names = {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files)) and 1 <= len(names) <= 24
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(
                r"(_dim|_rank)$|^(hidden|intermediate)_size$|latent|state|"
                r"proj|head_|experts_per_tok|expansion", key), key
    pairs = set()
    used = set()
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    assert len({w["name"] for w in cells}) == len(cells)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = [m for m in SPEC["per_layer"]
                 if cell in m.get("workloads", [cell])]
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_part_of_a_cell_is_a_file_found_by_name(cell):
    work = {w["name"]: w for w in SPEC["workloads"]}[cell]
    traffic = json.loads(
        (ROOT / "cardbench/traffic" / f"{work['traffic']}.json").read_text())
    assert (ROOT / "cardbench/drivers" / f"{traffic['driver']}.py").is_file()
    cfg = _config(work["config"])
    assert (ROOT / "cardbench/references" / f"{cfg['reference']}.py").is_file()
    assert set(cfg["check_limits"]) == {"sum_err_u", "rank_mismatch"}
    for m in SPEC["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (ROOT / "cardbench/metrics" / f"{m['name']}.py").is_file()


# The catalog's numbers for ByteDance/Ouro-2.6B (config.json)
OURO = {"head_dim": 128, "hidden_size": 2048, "intermediate_size": 5632,
        "max_position_embeddings": 65536, "max_window_layers": 48,
        "num_attention_heads": 16, "num_hidden_layers": 48,
        "num_key_value_heads": 16, "rms_norm_eps": 1e-06,
        "rope_theta": 1000000, "total_ut_steps": 4,
        "early_exit_threshold": 1, "vocab_size": 49152}


def test_ouro_keeps_every_published_number_but_its_cuts():
    cfg = _config("ouro-2.6b.ddp8")
    reduced = {c["name"]: c for c in SPEC["configs"]}["ouro-2.6b.ddp8"][
        "reduced"]
    for key, value in OURO.items():
        if key in reduced:
            assert cfg["cuts"][key]["published"] == value
            assert cfg[key] == cfg["cuts"][key]["here"]
        else:
            assert cfg[key] == value, key
    assert len(cfg["layer_types"]) == cfg["num_hidden_layers"]
    assert cfg["tie_word_embeddings"] is False


def test_ouro_buckets_are_ddps_assignment():
    cfg = _config("ouro-2.6b.ddp8")
    dep = cfg["deployment"]
    params = decoder_params(cfg)
    sizes = dict(params)
    buckets = ddp_buckets(params, 4, dep["first_bucket_mb"] * MIB,
                          dep["bucket_cap_mb"] * MIB)
    assert [b["params"] for b in cfg["buckets"]] == buckets
    assert [b["elems"] for b in cfg["buckets"]] == [
        sum(sizes[p] for p in b) for b in buckets]
    assert step_messages(cfg, {}) == [b["elems"] for b in cfg["buckets"]]
    # 8 layers: 5 buckets a layer, the head and the embedding alone
    assert len(buckets) == 5 * cfg["num_hidden_layers"] + 2
    assert buckets[0] == ["lm_head"] and buckets[-1] == ["embed_tokens"]
    layer = (4 * 2048 * 2048 + 3 * 2048 * 5632 + 2 * 2048) * 4
    total = sum(sizes.values()) * 4
    assert total == 8 * layer + (2 * 49152 * 2048 + 2048) * 4


def test_ddp_first_bucket_closes_at_one_mib():
    params = [("a", 1 << 17), ("b", 10), ("c", 7 << 20), ("d", 1)]
    # ready order d, c, b, a: d + c (28 MiB) reach the first cap of 1 MiB;
    # b + a (512 KiB) stay under 25 MiB and close at the end
    assert ddp_buckets(params, 4, MIB, 25 * MIB) == [["d", "c"], ["b", "a"]]


def test_mistral_tp_messages():
    cfg = _config("mistral-large-2.tp8")
    calls = cfg["step_calls"]
    assert calls["count"] == (cfg["assumed"]["allreduces_per_layer"]
                              * cfg["num_hidden_layers"]) == 176
    assert calls["elems_per_row"] == cfg["hidden_size"] == 12288
    assert step_messages(cfg, {"rows": 64}) == [64 * 12288] * 176
