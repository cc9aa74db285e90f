"""Every cell, configuration, traffic mix and metric is a file the harness
finds by name, and BENCHMARK.json agrees with them."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import core
from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    spec, config, traffic = core.load_cell(cell)
    assert spec["name"] == cell and spec["config"] == entry["config"]
    assert spec["traffic"] == entry["traffic"] == traffic["name"]
    assert spec["chips"] == entry["chips"] and spec["why"] == entry["why"]
    assert config["name"] == entry["config"]
    core.load_py("feeds", traffic["feed"])
    e2e = {m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]])}
    per_layer = {m["name"] for m in SPEC["per_layer"]
                 if cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]])}
    assert set(spec["end_to_end"]) == e2e and set(spec["per_layer"]) == per_layer
    assert spec["limits"], "every cell holds some correctness number"


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    data = core.load_json("configs", config)
    assert entry["file"] == f"benchmark/configs/{config}.json"
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert (BENCH / "reference" / f"{data['reference']}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_readers(metric):
    entry = next(m for m in SPEC["end_to_end"] + SPEC["per_layer"] if m["name"] == metric)
    reader = core.load_py("metrics", metric)
    assert reader.UNIT == entry["unit"]
    assert callable(reader.read)
    if entry in SPEC["per_layer"]:
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
