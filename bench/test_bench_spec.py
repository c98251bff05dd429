"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix, loop, limit and metric by name."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])


@pytest.mark.parametrize("group, entry", list(_names()),
                         ids=[e["name"] for _, e in _names()])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_pieces_found_by_name(cell):
    w = harness.workload(SPEC, cell)
    cfg = harness.config(SPEC, w["config"])
    mix = harness.mix(w["traffic"])
    assert cfg["name"] == w["config"]
    assert hasattr(harness.loop(mix["kind"]), "run")
    assert harness.load_limits(cell)
    e2e = {m["name"] for m in harness.end_to_end(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer(SPEC, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_config_is_used_and_layers_agree():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
