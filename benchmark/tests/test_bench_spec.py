"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, limit and metric resolves to its file by name."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    text = (harness.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    assert json.loads(text) == SPEC


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(SPEC["command"]) <= 32
    assert all(line(w) for w in SPEC["command"])
    files = [w for w in SPEC["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in SPEC["paths"])
               for f in files)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_a_full_check_with_24_cells_fits():
    runs = 2 + 14 * 24
    assert (runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configurations():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        body = harness.config_of(SPEC, c["name"])
        assert body["reduced"] == c["reduced"]


def test_cells():
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"])
        mix = harness.traffic_of(w["traffic"])
        harness.runner(mix["runner"])
        limits = harness.limits_of(w["name"])
        assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    metrics = SPEC[group]
    assert 1 <= len(metrics) <= (16 if group == "end_to_end" else 128)
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in metrics:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert line(m["layer"])
        if m["name"] != "setup_s":
            assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
            assert callable(harness.reader(m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(SPEC, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(SPEC, w["name"], True)


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  harness.metrics_of(SPEC, cell, False)]


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    folded = {x.lower().replace(" ", "") for x in layers}
    assert len(folded) == len(layers)
