"""The benchmark's files load and agree with ``BENCHMARK.json``: every
cell's configuration, traffic, driver and limits, every per-layer
metric's reader, the names' and units' characters, and the run length
against the full check's time."""

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_only_the_contract_keys(kind):
    for entry in BENCH[kind]:
        assert set(entry) <= KEYS[kind], entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        texts = {"configs": ("why", "source"), "workloads": ("why",),
                 "per_layer": ("layer",), "end_to_end": ()}[kind]
        for text in texts:
            assert 1 <= len(entry[text]) <= 200
            assert "\n" not in entry[text] and "\t" not in entry[text]


def test_names_are_unique():
    for kind in KEYS:
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metrics_units_bounds_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_load_and_agree(cell):
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    data = harness.load_json("workloads", cell)
    assert data["name"] == cell
    assert data["config"] == entry["config"]
    assert data["traffic"] == entry["traffic"]
    assert data["chips"] == entry["chips"] == 1
    assert data["why"] == entry["why"] and len(data["why"]) <= 200
    config = harness.load_json("configs", data["config"])
    harness.load_json("traffic", data["traffic"])
    harness.load_module("drivers", data["driver"])
    assert data["limits"] and all(v > 0 for v in data["limits"].values())
    harness.llama_config(config).validate_for(1)
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_source_cuts_and_shapes(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["source"] == entry["source"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    for key, cut in data["reduced"].items():
        assert data["published"][key] == cut["published"]
        assert data[key] == cut["here"]
    # every other key stated is the published one, or a value the port
    # fixes, which ``assumed`` names
    for key, value in data["published"].items():
        if key in data and key not in data["reduced"]:
            assert data[key] == value or key in data["assumed"], key
    model = data["model"]
    assert model["d_model"] == data["hidden_size"]
    assert model["n_layers"] == data["num_hidden_layers"]
    assert model["n_heads"] == data["num_attention_heads"]
    assert model["n_kv_heads"] == data["num_key_value_heads"]
    assert model["d_ff"] == data["intermediate_size"]
    assert model["vocab"] == data["vocab_size"]
    assert model["rope_theta"] == data["rope_theta"]
    # the port's fixed epsilon is the one the configuration states
    from tpu_operator_libs_torch.kernels.rms_norm import EPS
    assert data["rms_norm_eps"] == EPS


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_run_seconds_fit_the_full_check_with_24_cells():
    seconds = BENCH["run_seconds"]
    assert 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
