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


def check_cell_files(spec: dict, root: Path, cell: str) -> None:
    """Every part of `cell` is a file found by name under `root`: the
    traffic file with its generator and both test sizes (so that no cell
    runs at full size in the tests), the configuration with its reference,
    its weights' maker where it names one, and a limit and a reason for
    each number it compares (that they are the reference's own numbers,
    each cell's CPU run checks), and each per-layer metric's reader."""
    work = {w["name"]: w for w in spec["workloads"]}[cell]
    bench = root / "cardbench"
    traffic = json.loads(
        (bench / "traffic" / f"{work['traffic']}.json").read_text())
    assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
    for key in ("cpu_shrink", "card_shrink"):
        assert isinstance(traffic.get(key), int) and traffic[key] >= 1, key
    entry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    assert (bench / "references" / f"{cfg['reference']}.py").is_file()
    if "weights" in cfg:
        assert NAME.match(cfg["weights"])
        assert (bench / "weights" / f"{cfg['weights']}.py").is_file()
    limits, why = cfg["check_limits"], cfg["check_limits_why"]
    assert limits and set(why) == set(limits)
    for key, limit in limits.items():
        assert NAME.match(key)
        assert isinstance(why[key], str) and why[key].strip()
        assert isinstance(limit, (int, float)) and limit >= 0
    for m in spec["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (bench / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_part_of_a_cell_is_a_file_found_by_name(cell):
    check_cell_files(SPEC, ROOT, cell)


def test_a_cell_of_another_collective_with_weights_passes(tmp_path):
    from cardbench.tests.test_cardbench_runs import A2A, _alltoall_cell

    root = _alltoall_cell(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    check_cell_files(spec, root, A2A)


@pytest.mark.parametrize("key", ["cpu_shrink", "card_shrink"])
def test_a_traffic_file_without_a_test_size_is_refused(tmp_path, key):
    from cardbench.tests.test_cardbench_runs import A2A, _alltoall_cell

    root = _alltoall_cell(tmp_path)
    path = root / "cardbench/traffic/a2a.json"
    traffic = json.loads(path.read_text())
    del traffic[key]
    path.write_text(json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    with pytest.raises(AssertionError, match=key):
        check_cell_files(spec, root, A2A)


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
