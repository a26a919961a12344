"""Every entry of BENCHMARK.json resolves to its files by name, and keeps to
the file's shape rules (keys, names, units, one chip a cell)."""

import importlib
import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.load_cell(cell)
    assert spec["cell"]["chips"] == 1
    entry = harness.entry(spec["traffic"]["entry"])
    assert callable(entry.Run)
    assert spec["limits"] and set(spec["limits"]) <= set(entry.NUMBERS)
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "env_steps_per_s"} <= names
    assert spec["per_layer"], "every cell reports a per-layer metric"


@pytest.mark.parametrize("path", sorted((harness.PKG / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_names_an_entry(path):
    """A traffic file is data; the code it drives is the entry module it names."""
    traffic = json.loads(path.read_text())
    entry = harness.entry(traffic["entry"])
    assert callable(entry.Run) and entry.NUMBERS
    assert traffic["warmup_chunks"] >= 1 and traffic["chunk_steps"] >= 1


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert set(data["changed"]) == set(config["reduced"])
    assert (harness.ROOT / data["yaml"]).exists()


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(NAME.match(n) for n in metrics + CELLS)
