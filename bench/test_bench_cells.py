"""The benchmark's files hold together: every cell of BENCHMARK.json
resolves to its configuration, traffic, runner, limits and metric
readers, and the file keeps to the contract's shape."""
import json
import re

import pytest

from bench import harness as H

BENCH = H.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((H.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (H.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = H.resolve(name)
    assert cell.chips == 1
    assert (H.BENCH / "runners" / f"{cell.traffic['runner']}.py").exists()
    assert cell.config["model"]["name"] == cell.workload["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for spec in cell.per_layer:
        assert callable(H.metric(spec["name"]).read)
    want = {"loss_gap", "grad_gap", "grad_med", "change_gap", "tel_miss"}
    if cell.traffic.get("exchange"):
        want.add("sample_miss")
    assert set(cell.limits) == want


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_benchmark_configs_name_their_files(cfg):
    data = json.loads((H.ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"bench/configs/{cfg['name']}.json"
    assert data["reduced"] == cfg["reduced"]
    assert data["source"].startswith(cfg["source"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("path", sorted((H.BENCH / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_files(path):
    data = json.loads(path.read_text())
    assert data["name"] == data["model"]["name"] == path.stem
    # every published width is run as published
    pub, model = data["published"], data["model"]
    assert pub["hidden_size"] == model["d_model"]
    assert pub["num_hidden_layers"] == model["num_layers"]
    assert pub["vocab_size"] == model["vocab_size"]
    assert pub["num_attention_heads"] == model["num_heads"]
    # every key changed from the source is named in "reduced", with the
    # value the port runs under "as_run"
    for key in data["reduced"]:
        assert data["as_run"][key] != pub[key], key
    assert set(data.get("as_run", {})) == set(data["reduced"])


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        H.resolve("no-such-cell")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro_torch_like" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro.fake" in H.forbidden_modules()
