"""BENCHMARK.json against the shape its readers expect, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(ONE_LINE.match(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["benchmark"]
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert ONE_LINE.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(SPEC, cell)
    assert (harness.HERE / "jobs" / f"{c.traffic['job']}.py").is_file()
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for group in ("end_to_end", "per_layer"):
        names = {m["name"] for m in harness.metrics_of(SPEC, cell, group)}
        assert names, group
    e2e = {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in harness.metrics_of(SPEC, cell, "per_layer"):
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(harness.HERE / "metrics" / f"{metric['name']}.py")
    assert callable(mod.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_tiny_config_found_by_name(name):
    """The CPU tests' cut of each configuration: only keys the
    configuration has, and its sizes."""
    from benchmark.tests import tiny

    cut = harness.load_json(harness.ROOT / tiny.TINY / f"{name}.json")
    conf = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = harness.load_json(harness.ROOT / conf["file"])
    assert set(cut) <= set(cfg) and set(cut["sizes"]) == set(cfg["sizes"])


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_limits_found_by_name(cell):
    from benchmark.tests import tiny

    lims = harness.load_json(harness.ROOT / tiny.TINY / "limits" / f"{cell}.json")
    assert set(lims) == set(harness.load_cell(SPEC, cell).limits)


def test_configs_state_source_and_cuts():
    for c in SPEC["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["assumed"] and cfg["guarantees"] and cfg["sizes"]


@pytest.mark.parametrize("name", sorted({n for w in SPEC["workloads"]
                                         for n, _ in harness.load_cell(
                                             SPEC, w["name"]).traffic.get("passes", [])}))
def test_roofline_pass_found_by_name(name):
    assert (harness.HERE / "roofline" / f"{name}.py").is_file()
